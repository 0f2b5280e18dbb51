"""Activation registry: the port of ``analytics_zoo_tpu/keras/
activations.py``.  Each name computes what the reference's ``jax.nn``
function computes (``gelu`` is jax's default tanh approximation,
``hard_sigmoid`` ``clip(0.2 x + 0.5, 0, 1)``, ``leaky_relu`` slope
0.01)."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F


def linear(x):
    return x


def hard_sigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


_ACTIVATIONS = {
    "linear": linear,
    "relu": torch.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "hard_sigmoid": hard_sigmoid,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
}


def get_activation(name: Optional[Union[str, Callable]]) -> Callable:
    if name is None:
        return linear
    if callable(name):
        return name
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; one of {sorted(_ACTIVATIONS)}")
