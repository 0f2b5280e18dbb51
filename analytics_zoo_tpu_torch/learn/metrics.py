"""Validation metrics: the port of ``analytics_zoo_tpu/learn/metrics.py``.

A metric is a function ``(preds, targets) -> scalar`` tensor plus a
name; epoch aggregation is a sample-weighted mean on the host
(:class:`EpochAccumulator`).  The reference's host-side ``auc`` is not
copied yet: nothing in the port calls it.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Union

import torch


def top1_accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, -1) == labels).float())


def top5_accuracy(logits, labels):
    top5 = torch.topk(logits, 5, dim=-1).indices
    hit = torch.any(top5 == labels[..., None], dim=-1)
    return torch.mean(hit.float())


def binary_accuracy(logits, targets):
    preds = (logits > 0).to(torch.int32)
    return torch.mean((preds == targets.to(torch.int32)).float())


def mae_metric(preds, targets):
    return torch.mean(torch.abs(preds - targets))


def mse_metric(preds, targets):
    return torch.mean(torch.square(preds - targets))


_METRICS: Dict[str, Callable] = {
    "accuracy": top1_accuracy,
    "top1accuracy": top1_accuracy,
    "top5accuracy": top5_accuracy,
    "binary_accuracy": binary_accuracy,
    "mae": mae_metric,
    "mse": mse_metric,
}


def get_metric(m: Union[str, Callable]):
    if callable(m):
        return getattr(m, "__name__", "metric"), m
    key = str(m).lower().replace(" ", "")
    if key not in _METRICS:
        raise ValueError(f"unknown metric {m!r}; known: {sorted(_METRICS)}")
    return key, _METRICS[key]


def resolve_metrics(ms: Sequence[Union[str, Callable]]):
    return [get_metric(m) for m in (ms or [])]


class EpochAccumulator:
    """Sample-weighted running means for a dict of per-batch scalars."""

    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._n = 0

    def add(self, scalars: Dict[str, float], n_samples: int):
        for k, v in scalars.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v) * n_samples
        self._n += n_samples

    def result(self) -> Dict[str, float]:
        if self._n == 0:
            return {}
        return {k: v / self._n for k, v in self._sums.items()}

