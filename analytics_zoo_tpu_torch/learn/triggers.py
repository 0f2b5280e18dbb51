"""Triggers: checkpoint cadence and training control, the port's copy.

A copy of ``analytics_zoo_tpu/learn/triggers.py`` (standard library
only), pinned to it by ``tests/test_torch_serving_pins.py``:
``EveryEpoch``, ``SeveralIteration``, ``MaxIteration``, ``MaxEpoch``,
``MinLoss``, ``MaxScore``, the ``&``/``|`` combinators and the
``EarlyStopping`` callback.  The port's ``Estimator.fit`` calls a
trigger after every step with ``{"step", "epoch"}`` and at every epoch
end with ``{"step", "epoch", "epoch_end": True, "metrics"}``, as the
reference does, and saves a checkpoint when it fires.
"""

from __future__ import annotations

from typing import Dict


class Trigger:
    def __call__(self, state: Dict) -> bool:  # state: step/epoch/metrics
        raise NotImplementedError

    def __and__(self, other):
        return _And(self, other)

    def __or__(self, other):
        return _Or(self, other)


class EveryEpoch(Trigger):
    """Fires at each epoch boundary (state['epoch_end'] flag)."""

    def __call__(self, s):
        return bool(s.get("epoch_end"))


class SeveralIteration(Trigger):
    def __init__(self, interval: int):
        self.interval = max(1, interval)

    def __call__(self, s):
        step = s.get("step", 0)
        return step > 0 and step % self.interval == 0


class MaxIteration(Trigger):
    def __init__(self, n: int):
        self.n = n

    def __call__(self, s):
        return s.get("step", 0) >= self.n


class MaxEpoch(Trigger):
    def __init__(self, n: int):
        self.n = n

    def __call__(self, s):
        return s.get("epoch", 0) >= self.n


class MinLoss(Trigger):
    def __init__(self, min_loss: float):
        self.min_loss = min_loss

    def __call__(self, s):
        loss = s.get("metrics", {}).get("loss")
        return loss is not None and loss < self.min_loss


class MaxScore(Trigger):
    def __init__(self, metric: str, max_score: float):
        self.metric, self.max_score = metric, max_score

    def __call__(self, s):
        v = s.get("metrics", {}).get(self.metric)
        return v is not None and v > self.max_score


class _And(Trigger):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, s):
        return self.a(s) and self.b(s)


class _Or(Trigger):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, s):
        return self.a(s) or self.b(s)


class EarlyStopping:
    """Epoch-end callback: stop fit() when a monitored metric hasn't
    improved for `patience` epochs (keras-parity training control; the
    reference's closest analog is the MinLoss/MaxScore end triggers).

    Pass an instance in ``fit(callbacks=[EarlyStopping(...)])``; it
    returns True from its callback to request the stop.  ``best`` and
    ``stopped_epoch`` are inspectable afterwards.
    """

    # opt-in marker: fit() only honors stop-requesting return values from
    # callbacks that declare it (ordinary loggers can't truncate a run)
    requests_stop = True

    def __init__(self, monitor: str = "val_loss", patience: int = 3,
                 min_delta: float = 0.0, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.monitor = monitor
        self.patience = max(1, int(patience))
        self.min_delta = float(min_delta)
        self.mode = mode
        self.reset()

    def reset(self):
        """Fresh tracking state; fit() calls this at train start so an
        instance can be reused across fit() calls (keras on_train_begin
        semantics)."""
        self.best = None
        self.wait = 0
        self.stopped_epoch = None

    def _improved(self, v: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return v < self.best - self.min_delta
        return v > self.best + self.min_delta

    def __call__(self, stats: dict):
        v = stats.get(self.monitor)
        if v is None:
            import logging

            logging.getLogger("analytics_zoo_tpu_torch").warning(
                "EarlyStopping: metric %r not in epoch stats %s",
                self.monitor, sorted(stats))
            return False
        if self._improved(float(v)):
            self.best = float(v)
            self.wait = 0
            return False
        self.wait += 1
        if self.wait >= self.patience:
            self.stopped_epoch = stats.get("epoch")
            return True
        return False
