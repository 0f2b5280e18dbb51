"""Keras init strings: the port of ``analytics_zoo_tpu/keras/
initializers.py``.

An initializer is ``init(shape) -> f32 tensor`` drawn from torch's
global generator, with ``shape`` the REFERENCE's leaf shape (a Dense
kernel ``[in, out]``, a Conv kernel ``[*k, in, out]``); a layer moves
the draw into its own layout.  The distributions are jax's: variance
scaling with fans read from that shape (``fan_in = in * prod(k)``,
``fan_out = out * prod(k)``), the truncated normals cut at two standard
deviations and rescaled as jax rescales them, ``"uniform"`` on
``[0, 0.05)`` and ``"normal"`` with standard deviation 0.05 (the
reference's ``ji.uniform(scale=0.05)`` and ``ji.normal(0.05)``)."""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import torch

# jax's truncated normal (cut at 2 standard deviations) has this standard
# deviation for a unit scale
_TRUNC_STD = 0.87962566103423978


def _fans(shape: Sequence[int]):
    if len(shape) < 2:
        n = shape[0] if shape else 1
        return n, n
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def variance_scaling(scale: float, mode: str, distribution: str) -> Callable:
    def init(shape):
        fan_in, fan_out = _fans(tuple(shape))
        n = {"fan_in": fan_in, "fan_out": fan_out,
             "fan_avg": (fan_in + fan_out) / 2}[mode]
        var = scale / n
        w = torch.empty(tuple(shape))
        if distribution == "uniform":
            lim = math.sqrt(3 * var)
            return w.uniform_(-lim, lim)
        std = math.sqrt(var) / _TRUNC_STD
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)
    return init


def uniform(scale: float = 0.05) -> Callable:
    return lambda shape: torch.rand(tuple(shape)) * scale


def normal(stddev: float = 0.05) -> Callable:
    return lambda shape: torch.randn(tuple(shape)) * stddev


def zeros(shape):
    return torch.zeros(tuple(shape))


def ones(shape):
    return torch.ones(tuple(shape))


def orthogonal(shape):
    """jax's ``orthogonal()``: the leaf as ``[prod(shape[:-1]),
    shape[-1]]``, orthonormal along the shorter side."""
    rows = math.prod(shape[:-1])
    w = torch.empty(rows, shape[-1])
    torch.nn.init.orthogonal_(w)
    return w.reshape(tuple(shape))


_INITS = {
    "glorot_uniform": lambda: variance_scaling(1.0, "fan_avg", "uniform"),
    "glorot_normal": lambda: variance_scaling(1.0, "fan_avg", "normal"),
    "he_uniform": lambda: variance_scaling(2.0, "fan_in", "uniform"),
    "he_normal": lambda: variance_scaling(2.0, "fan_in", "normal"),
    "lecun_uniform": lambda: variance_scaling(1.0, "fan_in", "uniform"),
    "lecun_normal": lambda: variance_scaling(1.0, "fan_in", "normal"),
    "uniform": lambda: uniform(0.05),
    "normal": lambda: normal(0.05),
    "zero": lambda: zeros,
    "zeros": lambda: zeros,
    "one": lambda: ones,
    "ones": lambda: ones,
    "orthogonal": lambda: orthogonal,
}


def get_initializer(init: Union[str, Callable, None],
                    default="glorot_uniform") -> Callable:
    if init is None:
        init = default
    if callable(init):
        return init
    try:
        return _INITS[init.lower()]()
    except KeyError:
        raise ValueError(f"unknown initializer {init!r}; one of "
                         f"{sorted(_INITS)}")


def constant_init(value: float) -> Callable:
    return lambda shape: torch.full(tuple(shape), float(value))
