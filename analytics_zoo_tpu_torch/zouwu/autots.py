"""AutoTS — automated time-series pipeline: the port's copy.

A copy of ``analytics_zoo_tpu/zouwu/autots.py``, pinned to it by
``tests/test_torch_serving_pins.py``: ``AutoTSTrainer.fit`` runs trials
of (feature transform + forecaster fit) through ``automl.SearchEngine``
and returns a ``TSPipeline`` (transformer + the winning forecaster) with
``fit``/``evaluate``/``predict``/``save``/``load``.  A pipeline is saved
as ``pipeline.json`` plus the forecaster's export (the port's
``model.pt``, not orbax).  Its forecasters take no ``device``: they run
on the running context's device (``init_orca_context("local",
device=...)``), else on CUDA, raising without it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.automl import hp
from analytics_zoo_tpu_torch.automl.search import MedianStopper, SearchEngine
from analytics_zoo_tpu_torch.common.log import logger
from analytics_zoo_tpu_torch.zouwu.forecaster import (
    LSTMForecaster, Seq2SeqForecaster, TCNForecaster, _metric_fns)
from analytics_zoo_tpu_torch.zouwu.preprocessing import (
    TimeSequenceFeatureTransformer)

_MODEL_BUILDERS = {
    "lstm": lambda cfg, horizon: LSTMForecaster(
        horizon=horizon,
        lstm_units=(int(cfg.get("units", 16)),) * int(cfg.get("layers", 2)),
        dropouts=(float(cfg.get("dropout", 0.2)),) * int(
            cfg.get("layers", 2)),
        lr=float(cfg.get("lr", 1e-3))),
    "tcn": lambda cfg, horizon: TCNForecaster(
        horizon=horizon,
        channels=(int(cfg.get("units", 32)),) * int(cfg.get("layers", 3)),
        kernel_size=int(cfg.get("kernel_size", 3)),
        dropout=float(cfg.get("dropout", 0.1)),
        lr=float(cfg.get("lr", 1e-3))),
    "seq2seq": lambda cfg, horizon: Seq2SeqForecaster(
        future_seq_len=horizon,
        lstm_hidden_dim=int(cfg.get("units", 32)),
        lstm_layer_num=int(cfg.get("layers", 1)),
        lr=float(cfg.get("lr", 1e-3))),
}

_DEFAULT_SPACE = {
    "model": hp.choice(["tcn", "lstm"]),
    "units": hp.choice([16, 32, 64]),
    "layers": hp.choice([1, 2, 3]),
    "lr": hp.loguniform(1e-4, 1e-2),
    "dropout": hp.uniform(0.0, 0.3),
    "batch_size": hp.choice([32, 64]),
}


class TSPipeline:
    """Deployable bundle: feature transformer + trained forecaster."""

    def __init__(self, transformer: TimeSequenceFeatureTransformer,
                 forecaster, config: Dict):
        self.transformer = transformer
        self.forecaster = forecaster
        self.config = dict(config)

    # ---- inference / continued training ------------------------------

    def predict(self, df, batch_size: int = 128) -> np.ndarray:
        """Forecasts in ORIGINAL units, one row per input window."""
        x = self.transformer.transform(df, with_y=False)
        preds = self.forecaster.predict(x, batch_size=batch_size)
        return self.transformer.inverse(preds[..., 0])

    def evaluate(self, df, metrics: Sequence[str] = ("mse",),
                 batch_size: int = 128) -> Dict[str, float]:
        x, y = self.transformer.transform(df, with_y=True)
        preds = self.forecaster.predict(x, batch_size=batch_size)
        y_true = self.transformer.inverse(y[..., 0])
        y_pred = self.transformer.inverse(preds[..., 0])
        fns = _metric_fns()
        return {m: fns[m](y_true, y_pred) for m in metrics}

    def fit(self, df, epochs: int = 1, batch_size: int = 32):
        """Incremental fit on new data (ref: TSPipeline.fit)."""
        x, y = self.transformer.transform(df, with_y=True)
        return self.forecaster.fit(x, y, epochs=epochs,
                                   batch_size=batch_size)

    # ---- persistence -------------------------------------------------

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "pipeline.json"), "w") as f:
            json.dump({"config": self.config,
                       "transformer": self.transformer.state()}, f)
        self.forecaster.save(os.path.join(path, "model"))

    @staticmethod
    def load(path: str) -> "TSPipeline":
        with open(os.path.join(path, "pipeline.json")) as f:
            meta = json.load(f)
        cfg = meta["config"]
        transformer = TimeSequenceFeatureTransformer.from_state(
            meta["transformer"])
        builder = _MODEL_BUILDERS[cfg.get("model", "tcn")]
        forecaster = builder(cfg, transformer.horizon)
        n_feat = 1 + len(transformer.extra) + (5 if transformer.with_dt
                                               else 0)
        sample = np.zeros((2, transformer.lookback, n_feat), np.float32)
        forecaster.restore(os.path.join(path, "model"), sample_x=sample)
        return TSPipeline(transformer, forecaster, cfg)


class AutoTSTrainer:
    """ref-parity ctor: dt_col, target_col, horizon, extra_features_col."""

    def __init__(self, dt_col: str = "datetime", target_col: str = "value",
                 horizon: int = 1, extra_features_col: Sequence[str] = (),
                 lookback: int = 24,
                 search_space: Optional[Dict] = None):
        self.dt_col = dt_col
        self.target_col = target_col
        self.horizon = horizon
        self.extra = tuple(extra_features_col)
        self.lookback = lookback
        self.space = search_space or dict(_DEFAULT_SPACE)

    def fit(self, train_df, validation_df=None, *, n_sampling: int = 6,
            epochs: int = 2, metric: str = "mse", seed: int = 0,
            distributed: bool = False) -> TSPipeline:
        transformer = TimeSequenceFeatureTransformer(
            dt_col=self.dt_col, target_col=self.target_col,
            extra_feature_cols=self.extra, lookback=self.lookback,
            horizon=self.horizon)
        x, y = transformer.fit_transform(train_df)
        if validation_df is not None:
            vx, vy = transformer.transform(validation_df)
        else:
            n_val = max(1, len(x) // 5)
            x, vx = x[:-n_val], x[-n_val:]
            y, vy = y[:-n_val], y[-n_val:]

        def trainable(config: Dict, report):
            model_name = config.get("model", "tcn")
            forecaster = _MODEL_BUILDERS[model_name](config, self.horizon)
            bs = int(config.get("batch_size", 32))
            last = {}
            for ep in range(epochs):
                forecaster.fit(x, y, epochs=1, batch_size=bs)
                last = forecaster.evaluate(vx, vy, metrics=(metric,))
                report(ep, last[metric])
            trainable._last = (forecaster, config)
            return last

        engine = SearchEngine(trainable, self.space, metric=metric,
                              mode="min", n_sampling=n_sampling, seed=seed,
                              scheduler=MedianStopper(),
                              distributed=distributed)
        best = engine.run()
        logger.info("AutoTS best config=%s %s=%.5f", best.config,
                    metric, best.metric)
        # reuse the winner's trained forecaster if it was the last trial
        # run; otherwise retrain it (later trials overwrote the stash).
        # Distributed mode never reuses the stash: only the winning
        # process holds it (local-mesh-trained), and every process must
        # enter the global-mesh retrain together or the reusing process
        # deadlocks its peers' collectives.
        forecaster, cfg = getattr(trainable, "_last", (None, None))
        if distributed and SearchEngine._nprocs() > 1:
            cfg = None
        if cfg is not best.config:
            forecaster = _MODEL_BUILDERS[best.config.get("model", "tcn")](
                best.config, self.horizon)
            forecaster.fit(x, y, epochs=epochs,
                           batch_size=int(best.config.get("batch_size",
                                                          32)))
        return TSPipeline(transformer, forecaster, best.config)
