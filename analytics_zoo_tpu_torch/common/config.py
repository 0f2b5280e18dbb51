"""Training configuration: the port's copy of ``TrainConfig``.

The same fields and defaults as ``TrainConfig`` in
``analytics_zoo_tpu/common/config.py``, so a config written for the
reference's Estimator reads the same here.  The port's Estimator
(``learn/estimator.py``) honours ``seed`` and ``deterministic``; it
raises ``NotImplementedError`` for a non-default value of a field whose
feature is not ported yet and would change a result or an output
(``accum_steps``, ``checkpoint_dir``, ``tensorboard_dir``,
``metrics_jsonl``, ``profile``, ``fault_inject_step``, ``debug_nans``).
The rest change nothing here, as in the reference's Estimator:
``pack_transfer`` and ``donate_state`` steer JAX host-to-device
transfers and buffer donation, which have no meaning in eager PyTorch;
``epochs``, ``dtype``, ``param_dtype`` and ``remat`` are not read by
the reference's Estimator either (the model carries its own dtype);
``log_every_steps`` sets a logging cadence, ``checkpoint_every_steps``
and ``keep_checkpoints`` take effect only with a ``checkpoint_dir``.
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
    # update (not ported yet: a value above 1 raises)
    accum_steps: int = 1
    # JAX transfer knobs of the reference: no meaning in eager PyTorch
    pack_transfer: bool = True
    donate_state: bool = True
    # observability (not ported yet: setting one raises)
    tensorboard_dir: Optional[str] = None
    metrics_jsonl: Optional[str] = None
    profile: Optional[tuple] = None
    fault_inject_step: int = 0
    debug_nans: bool = False
    # fixes the data order (no shuffling) so a run is reproducible
    deterministic: bool = False
