"""Recurrent building blocks shared by the recommenders and the
forecasting nets.

The port of ``analytics_zoo_tpu/models/rnn.py``: :func:`make_cell` and
:class:`RNNStack`, over the port's own :class:`LSTMCell`,
:class:`GRUCell` and :class:`SimpleCell`, which compute what flax's cells
compute, cast for cast:

- flax ``LSTMCell``: gates ``ii if ig io`` on the input (no bias) plus
  ``hi hf hg ho`` on the hidden state (with a bias); ``c' = f*c + i*g``,
  ``h' = o*tanh(c')``.  flax ``GRUCell``: ``ir iz in`` on the input (with
  a bias) plus ``hr hz`` on the hidden state (no bias), and ``hn`` with a
  bias that sits inside ``r * (W_hn h + b_hn)``; ``h' = (1-z)*n + z*h``.
  flax ``SimpleCell``: ``h' = tanh(W_i x + b_i + W_h h)``;
- the gates run in the cell's dtype (bf16 by default) and the carry
  starts as zeros in the parameter dtype (f32), as flax's
  ``initialize_carry`` makes it, so ``f*c + i*g`` and ``(1-z)*n + z*h``
  promote to f32: a stack returns f32 for bf16 inputs.  A ``SimpleCell``
  whose dtype is not f32 returns its carry in that dtype, which flax's
  scan refuses against the f32 carry it started from; it raises here
  too.  ``torch.nn.LSTM``/``GRU`` keep the carry in the weight dtype and
  put two biases on every gate, so they cannot hold these cast points;
- each cell keeps its gates side by side (``i.weight [G*H, in]``,
  ``h.weight [G*H, H]``; :func:`~analytics_zoo_tpu_torch.models.layers.
  params_from_flax` fuses flax's per-gate kernels).  The input half of
  every gate does not depend on the carry, so :func:`scan` computes it
  for all T steps in one GEMM a layer (the hidden-side bias of the LSTM
  folded in) and loops in Python over the recurrent half only.

A layer's input width comes from its first input when it is not given,
as in flax.  :class:`RNNStack` applies dropout after each layer whose
rate is nonzero (the reference's Keras semantics); a training forward
with dropout takes ``rng`` (see ``models.transformer.dropout``), and
layer ``i`` draws its mask with the seed ``fold_in(rng, i)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.models.layers import (compute_dtype,
                                                   make_dense, materialize)
from analytics_zoo_tpu_torch.models.transformer import dropout, fold_in


class _Cell(nn.Module):
    """A recurrent cell with ``gates`` gates of ``features`` units:
    ``i`` the input projection, ``h`` the recurrent one.  A subclass's
    ``step_weights(dtype)`` casts the recurrent parameters once a
    sequence, and ``step(carry, projected x, weights)`` is one step."""

    gates = 1

    def __init__(self, in_features: Optional[int], features: int,
                 dtype: Optional[torch.dtype], input_bias: bool,
                 hidden_bias: bool, gate_fn=None, activation_fn=None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        # flax's gate_fn / activation_fn; None: sigmoid / tanh
        self.gate_fn = gate_fn
        self.activation_fn = activation_fn
        self.i = make_dense(in_features, self.gates * features, input_bias)
        self.h = nn.Linear(features, self.gates * features, bias=hidden_bias)
        # flax: orthogonal recurrent kernels (one a gate), zero biases
        with torch.no_grad():
            for g in range(self.gates):
                nn.init.orthogonal_(
                    self.h.weight[g * features:(g + 1) * features])
            if self.h.bias is not None:
                self.h.bias.zero_()

    def initial_carry(self, batch: int, device):
        """flax's ``initialize_carry``: zeros in the parameter dtype."""
        return torch.zeros(batch, self.features, device=device)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The carry-free half of every gate, for any leading shape."""
        materialize(self.i, x)
        dt = compute_dtype(self.dtype, x)
        bias = None if self.i.bias is None else self.i.bias.to(dt)
        return F.linear(x.to(dt), self.i.weight.to(dt), bias)

    def forward(self, carry, x: torch.Tensor):
        """One step on ``x [B, F]``: ``(new_carry, output)``, as flax's
        ``cell(carry, x)``."""
        xp = self.project(x)
        return self.step(carry, xp, self.step_weights(xp.dtype))


class LSTMCell(_Cell):
    """flax ``nn.LSTMCell`` (and ``nn.OptimizedLSTMCell``, which has its
    parameters); the carry is ``(c, h)``."""

    gates = 4

    def __init__(self, in_features: Optional[int], features: int,
                 dtype: Optional[torch.dtype] = None, gate_fn=None,
                 activation_fn=None):
        super().__init__(in_features, features, dtype, input_bias=False,
                         hidden_bias=True, gate_fn=gate_fn,
                         activation_fn=activation_fn)

    def initial_carry(self, batch: int, device):
        z = super().initial_carry(batch, device)
        return z, z.clone()

    def project(self, x):
        # the hidden side's bias does not depend on the carry either
        xp = super().project(x)
        return xp + self.h.bias.to(xp.dtype)

    def step_weights(self, dt):
        return (self.h.weight.to(dt),)

    def step(self, carry, xp, weights):
        c, h = carry
        g = xp + F.linear(h.to(xp.dtype), weights[0])
        i, f, gg, o = g.chunk(4, dim=-1)
        gate = self.gate_fn or torch.sigmoid
        act = self.activation_fn or torch.tanh
        new_c = gate(f) * c + gate(i) * act(gg)
        new_h = gate(o) * act(new_c)
        return (new_c, new_h), new_h


class GRUCell(_Cell):
    """flax ``nn.GRUCell``; ``hn_bias`` is ``hn``'s bias, inside
    ``r * (W_hn h + b_hn)``."""

    gates = 3

    def __init__(self, in_features: Optional[int], features: int,
                 dtype: Optional[torch.dtype] = None, gate_fn=None,
                 activation_fn=None):
        super().__init__(in_features, features, dtype, input_bias=True,
                         hidden_bias=False, gate_fn=gate_fn,
                         activation_fn=activation_fn)
        self.hn_bias = nn.Parameter(torch.zeros(features))

    def step_weights(self, dt):
        return self.h.weight.to(dt), self.hn_bias.to(dt)

    def step(self, h, xp, weights):
        w, bn = weights
        hp = F.linear(h.to(xp.dtype), w)
        xr, xz, xn = xp.chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        gate = self.gate_fn or torch.sigmoid
        r = gate(xr + hr)
        z = gate(xz + hz)
        n = (self.activation_fn or torch.tanh)(xn + r * (hn + bn))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class SimpleCell(_Cell):
    """flax ``nn.SimpleCell`` (tanh unless ``activation_fn``, not
    residual)."""

    def __init__(self, in_features: Optional[int], features: int,
                 dtype: Optional[torch.dtype] = None, activation_fn=None):
        super().__init__(in_features, features, dtype, input_bias=True,
                         hidden_bias=False, activation_fn=activation_fn)

    def step_weights(self, dt):
        if dt != torch.float32:
            raise TypeError(
                f"SimpleCell in {dt}: its new carry is {dt} against the f32 "
                f"carry it starts from, which flax's scan (and so the "
                f"reference) refuses; use dtype=torch.float32")
        return (self.h.weight.to(dt),)

    def step(self, h, xp, weights):
        new_h = (self.activation_fn or torch.tanh)(
            xp + F.linear(h.to(xp.dtype), weights[0]))
        return new_h, new_h


def make_cell(rnn_type: str, in_features: Optional[int], features: int,
              dtype: Optional[torch.dtype] = None) -> _Cell:
    """The reference's ``make_cell(rnn_type, features, dtype)``, with the
    input width (None: from the first input)."""
    t = rnn_type.lower()
    if t == "lstm":
        return LSTMCell(in_features, features, dtype)
    if t == "gru":
        return GRUCell(in_features, features, dtype)
    if t in ("rnn", "simplernn"):
        return SimpleCell(in_features, features, dtype)
    raise ValueError(f"unknown rnn_type {rnn_type!r} (lstm|gru|simplernn)")


def scan(cell: _Cell, x: torch.Tensor, carry=None
         ) -> Tuple[object, torch.Tensor]:
    """flax ``nn.RNN(cell, return_carry=True)(x)`` over ``x [B, T, F]``:
    ``(final carry, outputs [B, T, H])``.  The input projections of all
    T steps are one GEMM; the loop runs the recurrent half."""
    xp = cell.project(x)
    if carry is None:
        carry = cell.initial_carry(x.shape[0], x.device)
    weights = cell.step_weights(xp.dtype)
    ys = []
    for t in range(x.shape[1]):
        carry, y = cell.step(carry, xp[:, t], weights)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


class RNNStack(nn.Module):
    """Stacked recurrent layers over ``[B, T, F]``: the full sequence
    ``[B, T, H]`` if ``return_sequences`` else the last step ``[B, H]``.
    Dropout after each layer with a nonzero rate.  The cells are
    ``<Cell>_<i>``, the names of the reference's tree."""

    def __init__(self, hidden_sizes: Sequence[int], rnn_type: str = "lstm",
                 dropouts: Sequence[float] = (),
                 return_sequences: bool = False,
                 dtype: Optional[torch.dtype] = torch.bfloat16,
                 in_features: Optional[int] = None):
        super().__init__()
        drops = list(dropouts) or [0.0] * len(hidden_sizes)
        if len(drops) != len(hidden_sizes):
            raise ValueError("dropouts must match hidden_sizes")
        self.dropouts = [float(d) for d in drops]
        self.return_sequences = return_sequences
        self.names = []
        width = in_features
        for i, h in enumerate(hidden_sizes):
            cell = make_cell(rnn_type, width, int(h), dtype)
            name = f"{type(cell).__name__}_{i}"
            self.add_module(name, cell)
            self.names.append(name)
            width = int(h)

    def forward(self, x, train: bool = False, rng: Optional[int] = None):
        for i, (name, d) in enumerate(zip(self.names, self.dropouts)):
            _, x = scan(getattr(self, name), x)
            if d:
                x = dropout(x, d, None if rng is None else fold_in(rng, i),
                            train)
        return x if self.return_sequences else x[:, -1]
