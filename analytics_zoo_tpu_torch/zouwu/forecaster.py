"""Zouwu forecasters — user-facing time-series models.

The port of ``analytics_zoo_tpu/zouwu/forecaster.py``: ``Forecaster``
and ``LSTMForecaster``, ``TCNForecaster``, ``MTNetForecaster`` and
``Seq2SeqForecaster``, each a net of ``models/forecast.py`` in the
port's ``TorchEstimator`` with Adam at ``lr`` (the reference's
``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8).  x is ``[N, lookback,
F]``, y is ``[N, horizon, D]`` (a ``[N, D]`` or ``[N]`` y is expanded);
``evaluate`` reports the reference's metric set (mse, rmse, mae,
smape) on the host.  ``save`` writes the port's export (``model.pt``),
``restore`` loads one.

Every forecaster takes ``device=None``: CUDA, or the running context's
device (``init_orca_context("local", device=...)``), raising without
either; ``device="cpu"`` runs the plain path on the CPU.  ``feature_dim``
is accepted for the reference's signature, which ignores it too: a net
takes its input width from its first input.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.learn.estimator import TorchEstimator
from analytics_zoo_tpu_torch.models.forecast import (LSTMNet, MTNet,
                                                     Seq2SeqTS, TCN)


def _metric_fns():
    return {
        "mse": lambda y, p: float(np.mean((y - p) ** 2)),
        "rmse": lambda y, p: float(np.sqrt(np.mean((y - p) ** 2))),
        "mae": lambda y, p: float(np.mean(np.abs(y - p))),
        "smape": lambda y, p: float(100 * np.mean(
            2 * np.abs(p - y) / np.maximum(np.abs(y) + np.abs(p), 1e-8))),
    }


class Forecaster:
    """Base: subclasses build ``model`` (a net of ``models/forecast.py``)
    and pass it to ``super().__init__``.

    ref-parity methods: fit(x, y) / predict(x) / evaluate(x, y, metrics) /
    save(path) / restore(path).
    """

    def __init__(self, model, lr: float = 1e-3, loss: str = "mse",
                 metric: str = "mse", device=None):
        self.model = model
        self.metric = metric
        self.estimator = TorchEstimator(
            model, loss, float(lr), feature_cols=("x",), label_cols=("y",),
            device=device)

    @staticmethod
    def _shape_y(y: np.ndarray, horizon: int) -> np.ndarray:
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y[:, None]
        if y.ndim == 2:  # [N, D] -> [N, horizon(=1), D]
            y = y[:, None, :] if horizon == 1 else y[:, :, None]
        return y

    @property
    def _horizon(self) -> int:
        return int(getattr(self.model, "horizon", 1))

    def fit(self, x, y, validation_data=None, epochs: int = 1,
            batch_size: int = 32) -> Dict[str, float]:
        data = {"x": np.asarray(x, np.float32),
                "y": self._shape_y(y, self._horizon)}
        val = None
        if validation_data is not None:
            vx, vy = validation_data
            val = {"x": np.asarray(vx, np.float32),
                   "y": self._shape_y(vy, self._horizon)}
        hist = self.estimator.fit(data, epochs=epochs,
                                  batch_size=batch_size,
                                  validation_data=val)
        return hist[-1]

    def predict(self, x, batch_size: int = 128) -> np.ndarray:
        return self.estimator.predict({"x": np.asarray(x, np.float32)},
                                      batch_size=batch_size)

    def evaluate(self, x, y, metrics: Sequence[str] = ("mse",),
                 batch_size: int = 128) -> Dict[str, float]:
        preds = self.predict(x, batch_size)
        y = self._shape_y(y, self._horizon)
        fns = _metric_fns()
        return {m: fns[m](y, preds) for m in metrics}

    def save(self, path: str):
        self.estimator.save(path)

    def restore(self, path: str, sample_x: Optional[np.ndarray] = None):
        """Load a :meth:`save` export; ``sample_x`` is accepted for the
        reference's signature (a torch net takes its shapes from the
        export)."""
        self.estimator.load(path, sample_data=sample_x)

    load = restore


class LSTMForecaster(Forecaster):
    """ref-parity ctor: target_dim, feature_dim, lstm_units, dropouts,
    lr, loss."""

    def __init__(self, target_dim: int = 1, feature_dim: int = 1,
                 lstm_units: Sequence[int] = (16, 8),
                 dropouts: Sequence[float] = (0.2, 0.2),
                 horizon: int = 1, lr: float = 1e-3, loss: str = "mse",
                 device=None):
        self.feature_dim = feature_dim
        super().__init__(
            LSTMNet(output_dim=target_dim, horizon=horizon,
                    hidden_sizes=tuple(lstm_units),
                    dropouts=tuple(dropouts)), lr=lr, loss=loss,
            device=device)


class TCNForecaster(Forecaster):
    """ref-parity ctor: target_dim, feature_dim, channels, kernel_size."""

    def __init__(self, target_dim: int = 1, feature_dim: int = 1,
                 channels: Sequence[int] = (32, 32, 32),
                 kernel_size: int = 3, dropout: float = 0.1,
                 horizon: int = 1, lr: float = 1e-3, loss: str = "mse",
                 device=None):
        self.feature_dim = feature_dim
        super().__init__(
            TCN(output_dim=target_dim, horizon=horizon,
                channels=tuple(channels), kernel_size=kernel_size,
                dropout=dropout), lr=lr, loss=loss, device=device)


class MTNetForecaster(Forecaster):
    """ref-parity ctor: target_dim, feature_dim, long_series_num,
    series_length, ar_window_size, cnn_hid_size.

    Input x must be [N, (long_series_num+1)*series_length, F].
    """

    def __init__(self, target_dim: int = 1, feature_dim: int = 1,
                 long_series_num: int = 4, series_length: int = 8,
                 ar_window_size: int = 4, cnn_hid_size: int = 32,
                 rnn_hid_size: int = 32, horizon: int = 1,
                 lr: float = 1e-3, loss: str = "mse", device=None):
        self.feature_dim = feature_dim
        super().__init__(
            MTNet(output_dim=target_dim, horizon=horizon,
                  long_num=long_series_num, series_length=series_length,
                  ar_window=ar_window_size, cnn_filters=cnn_hid_size,
                  rnn_hidden=rnn_hid_size), lr=lr, loss=loss, device=device)


class Seq2SeqForecaster(Forecaster):
    """ref-parity ctor: target_dim, feature_dim, lstm_hidden_dim,
    lstm_layer_num, future_seq_len."""

    def __init__(self, target_dim: int = 1, feature_dim: int = 1,
                 lstm_hidden_dim: int = 64, lstm_layer_num: int = 1,
                 future_seq_len: int = 1, lr: float = 1e-3,
                 loss: str = "mse", device=None):
        self.feature_dim = feature_dim
        super().__init__(
            Seq2SeqTS(output_dim=target_dim, horizon=future_seq_len,
                      hidden_size=lstm_hidden_dim,
                      num_layers=lstm_layer_num), lr=lr, loss=loss,
            device=device)
