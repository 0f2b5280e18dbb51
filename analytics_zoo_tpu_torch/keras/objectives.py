"""Keras objective catalog: the port of ``analytics_zoo_tpu/keras/
objectives.py``.  Importing it adds the Keras losses to the shared
registry (``learn/objectives.py``), as the reference does, so the
names resolve wherever an Estimator resolves a loss."""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.learn import objectives as _base
from analytics_zoo_tpu_torch.learn.objectives import (  # noqa: F401
    LossFn, binary_crossentropy, categorical_crossentropy, huber,
    mean_absolute_error, mean_squared_error,
    sparse_categorical_crossentropy)

__all__ = [
    "get_loss", "kullback_leibler_divergence", "poisson",
    "cosine_proximity", "hinge", "squared_hinge",
    "mean_squared_logarithmic_error", "mean_absolute_percentage_error",
]

_EPS = 1e-7


def kullback_leibler_divergence(preds, targets):
    """Targets and preds are probability distributions over the last
    axis."""
    p = torch.clamp(targets, _EPS, 1.0)
    q = torch.clamp(preds, _EPS, 1.0)
    return torch.mean(torch.sum(p * torch.log(p / q), dim=-1))


def poisson(preds, targets):
    return torch.mean(preds - targets * torch.log(preds + _EPS))


def _unit(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _EPS)


def cosine_proximity(preds, targets):
    return -torch.mean(torch.sum(_unit(preds) * _unit(targets), dim=-1))


def hinge(preds, targets):
    """Targets in {-1, 1}."""
    return torch.mean(torch.relu(1.0 - targets * preds))


def squared_hinge(preds, targets):
    return torch.mean(torch.square(torch.relu(1.0 - targets * preds)))


def mean_squared_logarithmic_error(preds, targets):
    a = torch.log(torch.clamp(preds, min=_EPS) + 1.0)
    b = torch.log(torch.clamp(targets, min=_EPS) + 1.0)
    return torch.mean(torch.square(a - b))


def mean_absolute_percentage_error(preds, targets):
    return 100.0 * torch.mean(torch.abs(
        (targets - preds) / torch.clamp(torch.abs(targets), min=_EPS)))


_EXTRA = {
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "cosine": cosine_proximity,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
}

# one registry: keras names resolve everywhere Estimators resolve losses
_base._LOSSES.update(_EXTRA)
get_loss = _base.get_loss
