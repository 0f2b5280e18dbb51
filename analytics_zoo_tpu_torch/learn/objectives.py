"""Loss functions: the port of ``analytics_zoo_tpu/learn/objectives.py``.

All losses take ``(preds, targets)`` tensors and return a scalar mean
loss, with the reference's formulas.  String names accepted by the
Estimator resolve through :func:`get_loss`.
"""

from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

LossFn = Callable[..., torch.Tensor]


def mean_squared_error(preds, targets):
    return torch.mean(torch.square(preds - targets))


def mean_absolute_error(preds, targets):
    return torch.mean(torch.abs(preds - targets))


def binary_crossentropy(logits, targets):
    """Targets in {0,1}; preds are logits (pre-sigmoid).  The two
    broadcast against each other as optax's do: ``[B, 1]`` logits
    against ``[B]`` targets score every logit against every target."""
    logits, targets = torch.broadcast_tensors(logits,
                                              targets.to(logits.dtype))
    return F.binary_cross_entropy_with_logits(logits, targets)


def sparse_categorical_crossentropy(logits, labels):
    """Integer labels; logits pre-softmax, classes on the last axis."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def categorical_crossentropy(logits, onehot):
    return torch.mean(-(onehot * F.log_softmax(logits, dim=-1)).sum(-1))


def huber(preds, targets, delta: float = 1.0):
    return F.huber_loss(preds, targets, delta=delta)


_LOSSES = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "bce": binary_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "huber": huber,
}


def get_loss(loss: Union[str, LossFn]) -> LossFn:
    if callable(loss):
        return loss
    key = str(loss).lower()
    if key not in _LOSSES:
        raise ValueError(f"unknown loss {loss!r}; known: {sorted(_LOSSES)}")
    return _LOSSES[key]
