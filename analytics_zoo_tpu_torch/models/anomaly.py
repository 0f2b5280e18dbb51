"""Anomaly detection: the port of ``analytics_zoo_tpu/models/anomaly.py``.

- :class:`AnomalyDetector`: an LSTM
  :class:`~analytics_zoo_tpu_torch.models.rnn.RNNStack` (``hidden_layers``,
  dropout ``dropouts`` after each layer) over sliding windows ``[B, T,
  F]`` and an f32 ``Dense(1)`` head on the last step: the next value,
  ``[B]``.  The stack is ``lstm_stack.LSTMCell_<i>`` and the head
  ``head``, the reference's tree.  A training forward with dropout takes
  ``rng`` (the Estimator passes ``fold_in(seed, step)``; layer ``i``
  draws with ``fold_in(rng, i)``), as the forecasters' nets do.
- :func:`unroll`: windows of ``unroll_length`` and the first feature
  ``predict_step`` after each, through the port's
  ``zouwu.preprocessing.roll``.
- :func:`detect_anomalies`: the indices of the ``anomaly_size`` largest
  absolute errors, largest first (numpy, on the host).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.models.layers import Dense, dense
from analytics_zoo_tpu_torch.models.rnn import RNNStack


class AnomalyDetector(nn.Module):
    """ref-parity ctor: feature_shape=(unroll_length, n_features),
    hidden_layers, dropouts."""

    def __init__(self, feature_shape: Tuple[int, int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.feature_shape, self.dtype = tuple(feature_shape), dtype
        self.lstm_stack = RNNStack(hidden_layers, rnn_type="lstm",
                                   dropouts=dropouts, dtype=dtype,
                                   in_features=int(feature_shape[-1]))
        self.head = Dense(int(hidden_layers[-1]), 1)

    def forward(self, x, train: bool = False, rng: Optional[int] = None):
        h = self.lstm_stack(x.to(self.dtype), train, rng)
        return dense(self.head, h, torch.float32)[:, 0]


def unroll(data: np.ndarray, unroll_length: int, predict_step: int = 1):
    """Sliding windows (ref: AnomalyDetector.unroll): returns
    (x [N, unroll_length, F], y [N]) where y is the first feature
    ``predict_step`` after each window."""
    from analytics_zoo_tpu_torch.zouwu.preprocessing import roll

    x, y = roll(data, unroll_length, horizon=predict_step,
                target_cols=[0])
    return x, y[:, -1, 0]


def detect_anomalies(y_true: np.ndarray, y_pred: np.ndarray,
                     anomaly_size: int = 5) -> np.ndarray:
    """Indices of the ``anomaly_size`` largest |error| points
    (ref: AnomalyDetector.detect_anomalies)."""
    err = np.abs(np.asarray(y_true).ravel() - np.asarray(y_pred).ravel())
    return np.argsort(err)[::-1][:anomaly_size]


__all__ = ["AnomalyDetector", "unroll", "detect_anomalies"]
