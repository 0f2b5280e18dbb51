"""Logging and metrics sinks of the port.

A copy of ``analytics_zoo_tpu/common/log.py`` with the package renamed:
the ``analytics_zoo_tpu_torch`` logger, and :class:`MetricLogger`, which
fans step records out to stderr logging, a JSONL file and a
TensorBoard writer where one is installed.  The two profiler toggles
of the reference drive ``jax.profiler``; here they drive
``torch.profiler`` and write a gzipped Chrome trace.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("analytics_zoo_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s %(name)s %(levelname)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("ZOO_TPU_LOGLEVEL", "INFO"))


class MetricLogger:
    """Fans out {step, **metrics} records; tracks throughput."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 log_every: int = 50):
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter  # cpu torch in image
                self._tb = SummaryWriter(tensorboard_dir)
            except Exception:
                logger.warning("tensorboard writer unavailable; skipping")
        self.log_every = max(1, log_every)
        self._t0 = time.perf_counter()
        self._samples_since = 0
        self._step_of_last_log = 0

    def log(self, step: int, metrics: Dict[str, Any],
            n_samples: int = 0) -> None:
        self._samples_since += n_samples
        rec = {"step": step}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)
        if step - self._step_of_last_log >= self.log_every:
            dt = time.perf_counter() - self._t0
            tput = self._samples_since / dt if dt > 0 else 0.0
            msg = " ".join(f"{k}={v:.5g}" for k, v in rec.items() if k != "step")
            logger.info("step %d %s samples/sec=%.1f", step, msg, tput)
            self._t0 = time.perf_counter()
            self._samples_since = 0
            self._step_of_last_log = step

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


def start_profiler_trace(logdir: str, cuda: Optional[bool] = None) -> None:
    """Start a ``torch.profiler`` trace that :func:`stop_profiler_trace`
    writes under ``logdir`` as a gzipped Chrome trace
    (``<worker>.<time>.pt.trace.json.gz``): host activity always, the
    card's kernels too when ``cuda`` (``None``: when a CUDA device is
    available).  A second start while a trace runs raises, as
    ``jax.profiler.start_trace`` does."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    if getattr(start_profiler_trace, "active", None) is not None:
        raise RuntimeError("a profiler trace is already running: only one "
                           "trace may run at a time")
    if cuda is None:
        import torch

        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(
                       logdir, use_gzip=True))
    prof.start()
    start_profiler_trace.active = prof


def stop_profiler_trace() -> None:
    """Stop the running trace and write it (see
    :func:`start_profiler_trace`); raises when none runs."""
    prof = getattr(start_profiler_trace, "active", None)
    if prof is None:
        raise RuntimeError("no profiler trace is running")
    start_profiler_trace.active = None
    prof.stop()
