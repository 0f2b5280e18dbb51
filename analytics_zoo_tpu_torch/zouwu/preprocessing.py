"""Time-series preprocessing: the port's copy.

A copy of ``analytics_zoo_tpu/zouwu/preprocessing.py`` (numpy only;
pandas is imported inside ``datetime_features``, for calendar features
only), pinned to it by ``tests/test_torch_serving_pins.py``: ``roll``
(sliding windows), ``train_val_test_split`` (chronological),
``StandardScaler`` and ``MinMaxScaler`` with their inverses,
``datetime_features`` and ``TimeSequenceFeatureTransformer``, which
reads any mapping of columns, so a dict ``{"value": series}`` with no
datetime column needs no pandas.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def roll(data: np.ndarray, lookback: int, horizon: int = 1,
         target_cols: Optional[Sequence[int]] = None
         ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Sliding windows over [T, F] (or [T]) series.

    Returns x [N, lookback, F], y [N, horizon, D] where D indexes
    ``target_cols`` (default: all features).  ``horizon=0`` means
    inference windows: x may extend to the very end of the series (the
    last window's forecast is the true future) and y is None.
    """
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    T, F = data.shape
    n = T - lookback - horizon + 1
    if n <= 0:
        raise ValueError(
            f"series length {T} < lookback {lookback} + horizon {horizon}")
    idx = np.arange(lookback)[None, :] + np.arange(n)[:, None]
    x = data[idx]
    if horizon == 0:
        return x, None
    yidx = np.arange(horizon)[None, :] + np.arange(n)[:, None] + lookback
    y = data[yidx]
    if target_cols is not None:
        y = y[:, :, list(target_cols)]
    return x, y


def train_val_test_split(data: np.ndarray, val_ratio: float = 0.1,
                         test_ratio: float = 0.1):
    """Chronological split (shuffling leaks the future into training)."""
    n = len(data)
    n_test = int(n * test_ratio)
    n_val = int(n * val_ratio)
    n_train = n - n_val - n_test
    return data[:n_train], data[n_train:n_train + n_val], \
        data[n_train + n_val:]


class StandardScaler:
    """fit/transform/inverse_transform over the feature axis."""

    def fit(self, data: np.ndarray) -> "StandardScaler":
        d = np.asarray(data, np.float64)
        self.mean_ = d.mean(axis=0)
        self.scale_ = np.maximum(d.std(axis=0), 1e-8)
        return self

    def transform(self, data):
        return ((np.asarray(data) - self.mean_) / self.scale_).astype(
            np.float32)

    def fit_transform(self, data):
        return self.fit(data).transform(data)

    def inverse_transform(self, data, target_cols=None):
        mean, scale = self.mean_, self.scale_
        if target_cols is not None:
            mean, scale = mean[list(target_cols)], scale[list(target_cols)]
        return np.asarray(data) * scale + mean


class MinMaxScaler:
    def fit(self, data) -> "MinMaxScaler":
        d = np.asarray(data, np.float64)
        self.min_ = d.min(axis=0)
        self.range_ = np.maximum(d.max(axis=0) - self.min_, 1e-8)
        return self

    def transform(self, data):
        return ((np.asarray(data) - self.min_) / self.range_).astype(
            np.float32)

    def fit_transform(self, data):
        return self.fit(data).transform(data)

    def inverse_transform(self, data, target_cols=None):
        mn, rg = self.min_, self.range_
        if target_cols is not None:
            mn, rg = mn[list(target_cols)], rg[list(target_cols)]
        return np.asarray(data) * rg + mn


_DT_FEATURES = ("hour", "dayofweek", "day", "month", "is_weekend")


def datetime_features(index, features: Sequence[str] = _DT_FEATURES
                      ) -> np.ndarray:
    """Calendar features from a pandas DatetimeIndex/Series → [T, len]."""
    import pandas as pd

    idx = pd.DatetimeIndex(index)
    cols: List[np.ndarray] = []
    for f in features:
        if f == "is_weekend":
            cols.append((idx.dayofweek >= 5).astype(np.float32))
        else:
            cols.append(getattr(idx, f).to_numpy().astype(np.float32))
    return np.stack(cols, axis=1)


class TimeSequenceFeatureTransformer:
    """ref-parity: fit_transform(df) -> (x, y) windows with scaling +
    calendar features; ``inverse`` un-scales predictions.

    Args:
      dt_col / target_col / extra_feature_cols: DataFrame columns.
      lookback / horizon: window sizes.
    """

    def __init__(self, dt_col: str = "datetime", target_col: str = "value",
                 extra_feature_cols: Sequence[str] = (),
                 lookback: int = 24, horizon: int = 1,
                 with_datetime_features: bool = True,
                 scaler: Optional[object] = None):
        self.dt_col = dt_col
        self.target_col = target_col
        self.extra = tuple(extra_feature_cols)
        self.lookback = lookback
        self.horizon = horizon
        self.with_dt = with_datetime_features
        self.scaler = scaler if scaler is not None else StandardScaler()
        self._fitted = False

    def _matrix(self, df) -> np.ndarray:
        cols = [np.asarray(df[self.target_col], np.float32)[:, None]]
        for c in self.extra:
            cols.append(np.asarray(df[c], np.float32)[:, None])
        if self.with_dt and self.dt_col in df:
            cols.append(datetime_features(df[self.dt_col]))
        return np.concatenate(cols, axis=1)

    def fit_transform(self, df) -> Tuple[np.ndarray, np.ndarray]:
        mat = self._matrix(df)
        mat = self.scaler.fit_transform(mat)
        self._fitted = True
        return roll(mat, self.lookback, self.horizon, target_cols=[0])

    def transform(self, df, with_y: bool = True):
        """with_y=True: training windows (x, y).  with_y=False: inference
        windows — x reaches the END of the series, so the last row's
        prediction is the true next-``horizon`` forecast."""
        if not self._fitted:
            raise RuntimeError("fit_transform first")
        mat = self.scaler.transform(self._matrix(df))
        if not with_y:
            x, _ = roll(mat, self.lookback, 0)
            return x
        return roll(mat, self.lookback, self.horizon, target_cols=[0])

    def inverse(self, y_scaled: np.ndarray) -> np.ndarray:
        """Un-scale model outputs back to target units."""
        return self.scaler.inverse_transform(y_scaled, target_cols=[0])

    def state(self) -> Dict:
        return {"dt_col": self.dt_col, "target_col": self.target_col,
                "extra": self.extra, "lookback": self.lookback,
                "horizon": self.horizon, "with_dt": self.with_dt,
                "scaler_cls": type(self.scaler).__name__,
                "scaler_state": {k: v.tolist() for k, v in
                                 vars(self.scaler).items()}}

    @staticmethod
    def from_state(s: Dict) -> "TimeSequenceFeatureTransformer":
        t = TimeSequenceFeatureTransformer(
            dt_col=s["dt_col"], target_col=s["target_col"],
            extra_feature_cols=s["extra"], lookback=s["lookback"],
            horizon=s["horizon"], with_datetime_features=s["with_dt"],
            scaler={"StandardScaler": StandardScaler,
                    "MinMaxScaler": MinMaxScaler}[s["scaler_cls"]]())
        for k, v in s["scaler_state"].items():
            setattr(t.scaler, k, np.asarray(v))
        t._fitted = True
        return t
