"""Trial search engine: the port's copy.

A copy of ``analytics_zoo_tpu/automl/search.py``, pinned to it by
``tests/test_torch_serving_pins.py``: ``Trial``, ``MedianStopper`` and
``SearchEngine``, which runs trials one after another (or on a thread
pool) on this process's device.  Distributed trials are not ported:
``SearchEngine(distributed=True)`` raises ``NotImplementedError`` naming
ROADMAP Queue 1 item 6.3, ``_nprocs`` is 1, and the round-based exchange
over ``jax.process_count()`` processes (``_run_distributed``) raises.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.automl import hp as hp_mod
from analytics_zoo_tpu_torch.common.log import logger

@dataclasses.dataclass
class Trial:
    trial_id: int
    config: Dict
    metric: Optional[float] = None
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    status: str = "pending"   # pending | running | done | error | pruned
    error: Optional[str] = None
    duration_s: float = 0.0
    history: List[float] = dataclasses.field(default_factory=list)
    # (epoch, value) pairs as reported — epochs may be arbitrary keys
    # (step counts, non-contiguous); distributed mode exchanges THESE so
    # peer MedianStopper merges land in the right bucket
    reports: List[Any] = dataclasses.field(default_factory=list)


class MedianStopper:
    """Prune a trial whose intermediate metric is worse than the running
    median of completed metrics at the same epoch (Tune scheduler analog)."""

    def __init__(self, mode: str = "min", grace_epochs: int = 1):
        self.mode = mode
        self.grace = grace_epochs
        self._per_epoch: Dict[int, List[float]] = {}

    def record(self, epoch: int, value: float):
        self._per_epoch.setdefault(epoch, []).append(value)

    def should_stop(self, epoch: int, value: float) -> bool:
        if epoch < self.grace:
            return False
        seen = self._per_epoch.get(epoch, [])
        if len(seen) < 3:
            return False
        med = float(np.median(seen))
        return value > med if self.mode == "min" else value < med


class SearchEngine:
    """ref-parity: SearchEngine.run(trainable) -> best trial.

    Args:
      trainable: ``fn(config, report) -> float|dict`` — ``report(epoch,
        value)`` enables median-stopping (raise ``StopTrial`` is internal).
      search_space: dict of constants / hp samplers / hp.grid_search.
      metric: key to optimise when the trainable returns a dict.
      mode: "min" | "max".
      n_sampling: random samples drawn ON TOP of each grid combination.
    """

    def __init__(self, trainable: Callable, search_space: Dict,
                 metric: str = "loss", mode: str = "min",
                 n_sampling: int = 1, seed: int = 0,
                 max_concurrent: int = 1,
                 scheduler: Optional[MedianStopper] = None,
                 distributed: bool = False,
                 history_pad: int = 64):
        if distributed:
            raise NotImplementedError(
                "distributed trials (one per process, exchanged every "
                "round) are not ported: ROADMAP Queue 1 item 6.3")
        self.trainable = trainable
        self.space = search_space
        self.metric = metric
        self.mode = mode
        self.n_sampling = max(1, n_sampling)
        self.seed = seed
        self.max_concurrent = max(1, max_concurrent)
        self.scheduler = scheduler
        self.distributed = distributed
        self.history_pad = history_pad
        self.trials: List[Trial] = []

    class StopTrial(Exception):
        pass

    def _configs(self) -> List[Dict]:
        rng = np.random.default_rng(self.seed)
        out = []
        for grid_cfg in hp_mod.grid_configs(self.space):
            for _ in range(self.n_sampling):
                cfg = hp_mod.sample_config(self.space, rng)
                out.append(hp_mod._merge(cfg, grid_cfg))
        return out

    def _run_one(self, trial: Trial):
        trial.status = "running"
        t0 = time.perf_counter()

        def report(epoch: int, value: float):
            trial.history.append(float(value))
            trial.reports.append((float(epoch), float(value)))
            if self.scheduler is not None:
                self.scheduler.record(epoch, float(value))
                if self.scheduler.should_stop(epoch, float(value)):
                    raise SearchEngine.StopTrial()

        try:
            result = self.trainable(trial.config, report)
            if isinstance(result, dict):
                trial.metrics = result
                trial.metric = float(result[self.metric])
            else:
                trial.metric = float(result)
                trial.metrics = {self.metric: trial.metric}
            trial.status = "done"
        except SearchEngine.StopTrial:
            trial.status = "pruned"
            trial.metric = trial.history[-1] if trial.history else None
        except Exception:
            trial.status = "error"
            trial.error = traceback.format_exc()
            logger.warning("trial %d failed:\n%s", trial.trial_id,
                           trial.error)
        trial.duration_s = time.perf_counter() - t0

    def run(self) -> Trial:
        configs = self._configs()
        self.trials = [Trial(i, c) for i, c in enumerate(configs)]
        if self.distributed and self._nprocs() > 1:
            self._run_distributed()
            return self.best_trial()
        if self.max_concurrent == 1:
            for t in self.trials:
                self._run_one(t)
                logger.info("trial %d/%d %s %s=%s (%.1fs)", t.trial_id + 1,
                            len(self.trials), t.status, self.metric,
                            t.metric, t.duration_s)
        else:
            with ThreadPoolExecutor(self.max_concurrent) as pool:
                list(pool.map(self._run_one, self.trials))
        return self.best_trial()

    # -- cluster-distributed trials (ref: RayTuneSearchEngine ran trials
    # -- as Ray actors across the cluster, SURVEY §3.6) -----------------
    @staticmethod
    def _nprocs() -> int:
        return 1

    _ST_CODE = {"done": 0.0, "pruned": 1.0, "error": 2.0}
    _CODE_ST = {0: "done", 1: "pruned", 2: "error", 3: "noop"}

    def _run_distributed(self):
        raise NotImplementedError(
            "distributed trials (one per process, exchanged every "
            "round) are not ported: ROADMAP Queue 1 item 6.3")

    def best_trial(self) -> Trial:
        # a diverged trial may legitimately report metric=NaN ('done',
        # but incomparable) — exclude it or min()/max() returns NaN-
        # poisoned garbage depending on trial order
        done = [t for t in self.trials
                if t.status == "done" and t.metric is not None
                and not np.isnan(t.metric)]
        if not done:
            errs = [t.error for t in self.trials if t.error]
            raise RuntimeError(
                "no successful trials" + (f"; first error:\n{errs[0]}"
                                          if errs else ""))
        key = (min if self.mode == "min" else max)
        return key(done, key=lambda t: t.metric)
