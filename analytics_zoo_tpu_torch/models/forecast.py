"""Forecasting networks backing the Zouwu toolkit (the north star's
config #4).

The port of ``analytics_zoo_tpu/models/forecast.py``: ``LSTMNet``,
``TCNBlock``, ``TCN``, ``MTNet`` and ``Seq2SeqTS``.  All take
``[B, T, F]`` windows and return ``[B, horizon, output_dim]`` in f32.
Each takes its input width ``F`` from its first input (``input_dim``
fixes it up front), as the flax nets do.

- ``LSTMNet``: an LSTM :class:`~analytics_zoo_tpu_torch.models.rnn.
  RNNStack` (dropout after each layer) and an f32 head on the last step.
- ``TCN``: blocks of two dilated causal convolutions (left-padded by
  ``(k - 1) * dilation``, then ``VALID``), ReLU and dropout after each,
  and a 1-wide ``proj`` convolution on the residual where the width
  changes; dilation ``2**i`` in block ``i``; the head reads the last
  step, so step t sees inputs up to t only.
- ``MTNet``: one ``encoder_conv`` (flax's ``padding="SAME"``) and one
  ``GRUCell_0``, each shared by the memory encoder and the current
  encoder (one parameter set, as in the reference's tree), dropout after
  the convolution, attention over the memory blocks scaled by the
  square root of the hidden size in the model dtype, an f32 head, and
  the autoregressive highway ``ar`` over the raw last ``ar_window``
  steps of the first ``output_dim`` features.
- ``Seq2SeqTS``: ``num_layers`` LSTM encoder cells, then as many decoder
  cells fed with their own projected output (zeros first), named
  ``LSTMCell_0 .. LSTMCell_{2L-1}`` in that order.

Cast points follow the reference: the nets run in the model dtype (bf16
by default), the recurrent carries in f32, the heads in f32.  Dropout
masks come from seeded generators: a training forward with dropout takes
``rng`` (the Estimator passes ``fold_in(seed, step)``), and each site
draws with ``fold_in(rng, site)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

# params_from_flax: the reference LSTMNet's, TCN's, MTNet's or Seq2SeqTS's
# variables["params"] as this module's state_dict
from analytics_zoo_tpu_torch.models.layers import (  # noqa: F401
    conv, dense, make_conv, make_dense, params_from_flax, same_padding)
from analytics_zoo_tpu_torch.models.rnn import RNNStack, make_cell, scan
from analytics_zoo_tpu_torch.models.transformer import dropout, fold_in


def _site(rng: Optional[int], site: int) -> Optional[int]:
    return None if rng is None else fold_in(rng, site)


class LSTMNet(nn.Module):
    """ref: automl/model/VanillaLSTM — LSTM stack -> dense head."""

    def __init__(self, output_dim: int = 1, horizon: int = 1,
                 hidden_sizes: Sequence[int] = (32, 32),
                 dropouts: Sequence[float] = (0.2, 0.2),
                 dtype: torch.dtype = torch.bfloat16,
                 input_dim: Optional[int] = None):
        super().__init__()
        self.output_dim, self.horizon, self.dtype = output_dim, horizon, dtype
        self.lstm = RNNStack(hidden_sizes, rnn_type="lstm", dropouts=dropouts,
                             dtype=dtype, in_features=input_dim)
        self.head = make_dense(int(hidden_sizes[-1]), horizon * output_dim)

    def forward(self, x, train: bool = False, rng: Optional[int] = None):
        h = self.lstm(x.to(self.dtype), train, rng)
        out = dense(self.head, h, torch.float32)
        return out.reshape(x.shape[0], self.horizon, self.output_dim)


class TCNBlock(nn.Module):
    """Two dilated causal convolutions and a residual, with ``proj`` (a
    1-wide convolution) on the residual where the width changes.  With
    the input width unknown, ``proj`` is made lazily and dropped at the
    first input, or at a load that has none, when the widths agree."""

    def __init__(self, channels: int, kernel_size: int, dilation: int,
                 dropout: float, dtype: torch.dtype,
                 in_channels: Optional[int] = None):
        super().__init__()
        self.channels, self.dropout, self.dtype = channels, dropout, dtype
        self.pad = (kernel_size - 1) * dilation
        self.conv0 = make_conv(in_channels, channels, kernel_size, dilation)
        self.conv1 = make_conv(channels, channels, kernel_size, dilation)
        self.proj = None if in_channels == channels \
            else make_conv(in_channels, channels, 1)

    def _load_from_state_dict(self, state_dict, prefix, *args):
        if self.proj is not None and prefix + "proj.weight" not in \
                state_dict and self.proj.has_uninitialized_params():
            self.proj = None
        super()._load_from_state_dict(state_dict, prefix, *args)

    def forward(self, x, train: bool = False, rng: Optional[int] = None):
        y = x
        for i, layer in enumerate((self.conv0, self.conv1)):
            y = torch.relu(conv(layer, y, self.dtype, (self.pad, 0)))
            y = dropout(y, self.dropout, _site(rng, i), train)
        if x.shape[-1] != self.channels:
            x = conv(self.proj, x, self.dtype)
        elif self.proj is not None:
            self.proj = None
        return torch.relu(x + y)


class TCN(nn.Module):
    """ref: zouwu TCNForecaster net — stacked dilated causal conv
    blocks."""

    def __init__(self, output_dim: int = 1, horizon: int = 1,
                 channels: Sequence[int] = (32, 32, 32),
                 kernel_size: int = 3, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 input_dim: Optional[int] = None):
        super().__init__()
        self.output_dim, self.horizon, self.dtype = output_dim, horizon, dtype
        self.n_blocks = len(channels)
        width = input_dim
        for i, c in enumerate(channels):
            setattr(self, f"block{i}", TCNBlock(int(c), kernel_size, 2 ** i,
                                                dropout, dtype, width))
            width = int(c)
        self.head = make_dense(width, horizon * output_dim)

    def forward(self, x, train: bool = False, rng: Optional[int] = None):
        y = x.to(self.dtype)
        for i in range(self.n_blocks):
            y = getattr(self, f"block{i}")(y, train, _site(rng, i))
        out = dense(self.head, y[:, -1], torch.float32)
        return out.reshape(x.shape[0], self.horizon, self.output_dim)


class MTNet(nn.Module):
    """ref: zouwu MTNetForecaster (MTNet, Chang et al.) — long-term
    memory blocks encoded by CNN+GRU, attention against the short-term
    encoding, plus an autoregressive highway on the last ``ar_window``
    steps.

    Input [B, (long_num+1)*series_length, F]: the first ``long_num``
    chunks are the memory; the last chunk is the current window.
    """

    def __init__(self, output_dim: int = 1, horizon: int = 1,
                 long_num: int = 4, series_length: int = 8,
                 ar_window: int = 4, cnn_filters: int = 32,
                 cnn_kernel: int = 3, rnn_hidden: int = 32,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 input_dim: Optional[int] = None):
        super().__init__()
        self.output_dim, self.horizon, self.dtype = output_dim, horizon, dtype
        self.long_num, self.series_length = long_num, series_length
        self.ar_window, self.rnn_hidden = ar_window, rnn_hidden
        self.dropout = dropout
        self.padding = same_padding(cnn_kernel)
        self.encoder_conv = make_conv(input_dim, cnn_filters, cnn_kernel)
        self.GRUCell_0 = make_cell("gru", cnn_filters, rnn_hidden, dtype)
        self.head = make_dense(2 * rnn_hidden, horizon * output_dim)
        self.ar = make_dense(ar_window, horizon)

    def _encode(self, seq, train, rng):
        h = torch.relu(conv(self.encoder_conv, seq, self.dtype,
                            self.padding))
        h = dropout(h, self.dropout, rng, train)
        return scan(self.GRUCell_0, h)[1][:, -1]

    def forward(self, x, train: bool = False, rng: Optional[int] = None):
        B, T, F = x.shape
        L, q = self.long_num, self.series_length
        if T != (L + 1) * q:
            raise ValueError(f"expected T={(L + 1) * q}, got {T}")
        xf = x.to(self.dtype)
        mem = xf[:, :L * q].reshape(B * L, q, F)
        m = self._encode(mem, train, _site(rng, 0)).reshape(
            B, L, self.rnn_hidden)
        u = self._encode(xf[:, L * q:], train, _site(rng, 1))
        # attention over the memory blocks; the scale is the model
        # dtype's square root of the hidden size, as in the reference
        scale = torch.sqrt(torch.tensor(float(self.rnn_hidden),
                                        dtype=self.dtype))
        att = torch.einsum("blh,bh->bl", m, u) / scale.to(m.dtype)
        w = torch.softmax(att.float(), dim=-1).to(self.dtype)
        ctx = torch.einsum("bl,blh->bh", w.to(m.dtype), m)
        h = torch.cat([u, ctx], -1)
        nn_out = dense(self.head, h, torch.float32).reshape(
            B, self.horizon, self.output_dim)
        # the AR highway over the raw last ar_window steps of the targets
        ar_in = x[:, -self.ar_window:, :self.output_dim]      # [B, w, D]
        ar = dense(self.ar, ar_in.transpose(1, 2), torch.float32)
        return nn_out + ar.transpose(1, 2)


class Seq2SeqTS(nn.Module):
    """ref: zouwu Seq2SeqForecaster net — LSTM encoder-decoder over
    continuous features; the decoder feeds its own output back."""

    def __init__(self, output_dim: int = 1, horizon: int = 1,
                 hidden_size: int = 64, num_layers: int = 1,
                 dtype: torch.dtype = torch.bfloat16,
                 input_dim: Optional[int] = None):
        super().__init__()
        self.output_dim, self.horizon, self.dtype = output_dim, horizon, dtype
        self.num_layers = num_layers
        widths = [input_dim] + [hidden_size] * (num_layers - 1) \
            + [output_dim] + [hidden_size] * (num_layers - 1)
        for i, w in enumerate(widths):
            setattr(self, f"LSTMCell_{i}",
                    make_cell("lstm", w, hidden_size, dtype))
        self.head = make_dense(hidden_size, output_dim)

    def forward(self, x, train: bool = False):
        L = self.num_layers
        h = x.to(self.dtype)
        carries = []
        for i in range(L):
            carry, h = scan(getattr(self, f"LSTMCell_{i}"), h)
            carries.append(carry)
        # decoder: horizon steps, each fed the previous projection
        prev = torch.zeros(x.shape[0], self.output_dim, dtype=self.dtype,
                           device=x.device)
        outs = []
        for _ in range(self.horizon):
            z = prev
            for i in range(L):
                carries[i], z = getattr(self, f"LSTMCell_{L + i}")(
                    carries[i], z)
            y = dense(self.head, z.float(), torch.float32)
            outs.append(y)
            prev = y.to(self.dtype)
        return torch.stack(outs, dim=1)
