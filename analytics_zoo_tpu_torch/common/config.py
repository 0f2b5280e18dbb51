"""Training configuration: the port's copy of ``TrainConfig``.

The same fields and defaults as ``TrainConfig`` in
``analytics_zoo_tpu/common/config.py``, so a config written for the
reference's Estimator reads the same here.  The port's Estimator
(``learn/estimator.py``) honours ``seed`` (the shuffle and the dropout
seeds), ``deterministic``, ``checkpoint_dir``, ``keep_checkpoints``,
``checkpoint_every_steps`` (with a ``checkpoint_dir``: also save every
that many steps, where 0 saves at epoch ends only), ``accum_steps``
(micro-batches a step), ``log_every_steps`` (the cadence of the metric
records ``metrics_jsonl`` and ``tensorboard_dir`` receive),
``profile``, ``fault_inject_step`` and ``debug_nans``, as the
reference's Estimator does.
The rest change nothing here, as in the reference's Estimator:
``pack_transfer`` and ``donate_state`` steer JAX host-to-device
transfers and buffer donation, which have no meaning in eager PyTorch;
``epochs``, ``dtype``, ``param_dtype`` and ``remat`` are not read by
the reference's Estimator either (the model carries its own dtype).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class TrainConfig:
    """Estimator training knobs."""

    epochs: int = 1
    log_every_steps: int = 50
    checkpoint_dir: Optional[str] = None
    checkpoint_every_steps: int = 0  # 0 = only at epoch end when dir set
    keep_checkpoints: int = 3
    seed: int = 0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = False
    # split each global batch into N microbatches with ONE averaged
    # update
    accum_steps: int = 1
    # JAX transfer knobs of the reference: no meaning in eager PyTorch
    pack_transfer: bool = True
    donate_state: bool = True
    # observability
    tensorboard_dir: Optional[str] = None
    metrics_jsonl: Optional[str] = None
    profile: Optional[tuple] = None
    fault_inject_step: int = 0
    debug_nans: bool = False
    # fixes the data order (no shuffling) so a run is reproducible
    deterministic: bool = False
