"""AutoEstimator — HPO-driven Estimator construction.

The port of ``analytics_zoo_tpu/automl/auto_estimator.py``: each trial
builds a fresh estimator with ``Estimator.from_torch`` from
``model_creator(config)`` (a torch module) and
``optimizer_creator(config)`` (a learning rate, or a callable ``params
-> torch.optim.Optimizer``; the default is ``config["lr"]``, 1e-3
without one, which the Estimator turns into Adam as the reference's
``optax.adam``), trains on the shared host data, evaluates on the
validation data and reports the metric; ``SearchEngine`` samples and
prunes, and the best estimator is kept, trained.  ``from_torch`` is the
entry point; ``from_flax`` and ``from_keras`` are the reference's names
for it.  ``device=None`` means CUDA or the running context's device,
raising without either, resolved when the AutoEstimator is made.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from analytics_zoo_tpu_torch.automl.search import MedianStopper, SearchEngine
from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.learn.estimator import (Estimator,
                                                     TorchEstimator)


def _default_optimizer_creator(config: Dict):
    return float(config.get("lr", 1e-3))


class AutoEstimator:
    def __init__(self, model_creator: Callable[[Dict], Any], *,
                 loss: Any = "mse",
                 optimizer_creator: Callable[[Dict], Any] = None,
                 feature_cols=("x",), label_cols=("y",),
                 metrics=(), name: str = "auto_estimator", device=None):
        self.model_creator = model_creator
        self.loss = loss
        self.optimizer_creator = optimizer_creator or \
            _default_optimizer_creator
        self.feature_cols = tuple(feature_cols)
        self.label_cols = tuple(label_cols)
        self.metrics = metrics
        self.name = name
        self.device = resolve_device(device)
        self.best_estimator: Optional[TorchEstimator] = None
        self.best_config: Optional[Dict] = None
        self.best_trial = None

    @staticmethod
    def from_torch(model_creator, **kw) -> "AutoEstimator":
        return AutoEstimator(model_creator, **kw)

    # the reference's entry-point names
    from_keras = from_torch
    from_flax = from_torch

    def _build(self, config: Dict) -> TorchEstimator:
        return Estimator.from_torch(
            model=self.model_creator(config), loss=self.loss,
            optimizer=self.optimizer_creator(config),
            feature_cols=self.feature_cols, label_cols=self.label_cols,
            metrics=self.metrics, device=self.device)

    def fit(self, data, validation_data=None, *, search_space: Dict,
            n_sampling: int = 4, epochs: int = 1, metric: str = "loss",
            mode: str = "min", batch_size: int = 32,
            early_stop: bool = True, seed: int = 0,
            distributed: bool = False) -> "AutoEstimator":
        """Search, then retain the best estimator (already trained).

        ``batch_size``/``epochs`` may also live in the search space under
        the same names; config values win.  ``distributed=True`` raises
        (ROADMAP Queue 1 item 6.3).
        """
        val = validation_data if validation_data is not None else data

        def trainable(config: Dict, report):
            est = self._build(config)
            bs = int(config.get("batch_size", batch_size))
            n_ep = int(config.get("epochs", epochs))
            for ep in range(n_ep):
                est.fit(data, epochs=1, batch_size=bs)
                stats = est.evaluate(val, batch_size=bs)
                report(ep, float(stats[metric]))
            stats = est.evaluate(val, batch_size=bs)
            # stash so the winning trial's estimator can be retained
            trainable._last = (est, config)
            return {k: float(v) for k, v in stats.items()}

        scheduler = MedianStopper(mode=mode) if early_stop else None
        engine = SearchEngine(trainable, search_space, metric=metric,
                              mode=mode, n_sampling=n_sampling, seed=seed,
                              scheduler=scheduler, distributed=distributed)
        best = engine.run()
        self.best_trial = best
        self.best_config = best.config
        # retrain the winner if its estimator isn't the last one stashed
        # (later trials overwrote the stash)
        est, cfg = getattr(trainable, "_last", (None, None))
        if cfg is not best.config:
            est = self._build(best.config)
            est.fit(data, epochs=int(best.config.get("epochs", epochs)),
                    batch_size=int(best.config.get("batch_size",
                                                   batch_size)))
        self.best_estimator = est
        return self

    def get_best_model(self):
        if self.best_estimator is None:
            raise RuntimeError("call fit first")
        return self.best_estimator

    def get_best_config(self) -> Dict:
        if self.best_config is None:
            raise RuntimeError("call fit first")
        return self.best_config
