"""flax's ``Dense``, ``Embed`` and ``Conv`` for the recommenders and the
forecasting nets, and the converter of their flax trees.

The reference's recommenders (``analytics_zoo_tpu/models/ncf.py``,
``models/recommendation.py``) and forecasting nets
(``models/forecast.py``) are built from flax layers; the port builds
them from these:

- :class:`Dense` and :class:`Embed`: ``nn.Linear`` and ``nn.Embedding``
  initialised as flax initialises them (a Dense kernel truncated-normal
  with variance 1 / fan_in and a zero bias; an embedding normal with
  variance 1 / features).  :class:`LazyDense` and :class:`LazyConv` take
  their input width from their first input, as a flax layer does, so a
  net needs no ``input_dim`` (a ``Forecaster`` never knows it: AutoTS
  adds calendar features to the series);
- :func:`dense` and :func:`conv`: a flax layer with ``dtype=dtype``,
  input, kernel and bias all promoted to the compute dtype; a ``None``
  dtype promotes the input with the f32 parameters, as flax's
  ``promote_dtype`` does;
- :class:`Conv2d` and :func:`conv2d`: flax's 2-D ``nn.Conv`` on NCHW
  tensors (the image models keep them in ``torch.channels_last``
  memory), with flax's ``padding="SAME"``, which pads a stride-2 conv
  of an even size one more at the end than at the start
  (:func:`same_pads`);
- :class:`BatchNorm`: flax's ``nn.BatchNorm(dtype=float32)`` over the
  channel axis, whose batch or running statistics follow the ``train``
  argument, not ``nn.Module.training``;
- :func:`params_from_flax`: a flax ``variables["params"]`` tree as the
  matching port module's ``state_dict``.  A Dense kernel ``[in, out]``
  transposes to ``[out, in]``, a Conv kernel ``[k, in, out]`` to torch's
  ``[out, in, k]`` and ``[kh, kw, in, out]`` to ``[out, in, kh, kw]``,
  an embedding table stays as it is, a BatchNorm's ``scale`` becomes
  ``weight``; the cells of ``models/rnn.py`` fuse their gates (see
  there).  :func:`batch_stats_from_flax` carries the reference's
  ``variables["batch_stats"]`` (running means and variances) into the
  BatchNorms' buffers.  The port's modules name their parameters as the
  reference's tree does, so one converter serves every tree;
- :func:`flax_leaf`: the other way, leaf by leaf: which reference leaf a
  port tensor holds and how its axes were laid out, attention
  projections folded along :data:`HEAD_FOLDS` included.  LoRA and
  weight-only quantization work in the reference's layout through it.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.parallel import data_parallel as dp

# flax's truncated normal (cut at 2 standard deviations) has this
# standard deviation for a unit scale
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal, variance 1 / fan_in."""
    std = math.sqrt(1.0 / max(1, fan_in)) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std)


class Dense(nn.Linear):
    """flax ``nn.Dense``'s parameters: ``weight [out, in]`` (the kernel
    transposed) and ``bias``."""

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight, self.weight.shape[1])
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LazyDense(nn.LazyLinear):
    """A :class:`Dense` whose input width comes from its first input."""

    cls_to_become = Dense

    def reset_parameters(self) -> None:
        if not self.has_uninitialized_params() and self.in_features != 0:
            Dense.reset_parameters(self)


def make_dense(in_features: Optional[int], out_features: int,
               bias: bool = True) -> nn.Linear:
    """A :class:`Dense`, or a :class:`LazyDense` when ``in_features`` is
    None."""
    if in_features is None:
        return LazyDense(out_features, bias=bias)
    return Dense(in_features, out_features, bias=bias)


class Embed(nn.Embedding):
    """flax ``nn.Embed``: a table initialised normal with variance
    1 / features (or with ``std``, or zeros when ``std == 0``)."""

    def __init__(self, num_embeddings: int, features: int,
                 std: Optional[float] = None):
        self._std = std
        super().__init__(num_embeddings, features)

    def reset_parameters(self) -> None:
        std = self._std if self._std is not None \
            else 1.0 / math.sqrt(self.embedding_dim)
        with torch.no_grad():
            if std == 0:
                self.weight.zero_()
            else:
                self.weight.normal_(0.0, std)


class Conv(nn.Conv1d):
    """flax ``nn.Conv`` over one spatial axis: ``weight [out, in, k]``
    (the kernel ``[k, in, out]`` transposed), lecun-normal, zero bias."""

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight, self.weight.shape[1] *
                      self.weight.shape[2])
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LazyConv(nn.LazyConv1d):
    """A :class:`Conv` whose input channels come from its first input."""

    cls_to_become = Conv

    def reset_parameters(self) -> None:
        if not self.has_uninitialized_params() and self.in_channels != 0:
            Conv.reset_parameters(self)


def make_conv(in_channels: Optional[int], out_channels: int,
              kernel_size: int, dilation: int = 1) -> nn.Conv1d:
    """A :class:`Conv`, or a :class:`LazyConv` when ``in_channels`` is
    None."""
    if in_channels is None:
        return LazyConv(out_channels, kernel_size, dilation=dilation)
    return Conv(in_channels, out_channels, kernel_size, dilation=dilation)


def materialize(layer: nn.Module, x: torch.Tensor) -> None:
    """Give a lazy layer its input width from ``x`` (its first input, in
    the layout its ``forward`` takes), as flax does at the first call."""
    if isinstance(layer, nn.modules.lazy.LazyModuleMixin) and \
            layer.has_uninitialized_params():
        layer._infer_parameters(layer, (x,))


def compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor
                  ) -> torch.dtype:
    """flax's ``promote_dtype`` against f32 parameters: ``dtype``, or
    the input's dtype promoted with f32 when ``dtype`` is None."""
    return dtype if dtype is not None else \
        torch.promote_types(x.dtype, torch.float32)


_INT8 = threading.local()


@contextlib.contextmanager
def int8_scope(sites: Dict[nn.Module, dict]):
    """For the length of the block, on this thread, each module of
    ``sites`` computes its product on the int8 path with its int8 kernel
    (``learn.quantize``'s dict), as the reference's ``int8_call``
    intercepts its Dense and Conv calls: :func:`dense`, :func:`conv`,
    :func:`conv2d`, ``models.transformer._dense`` and the LM's untied
    head consult :func:`int8_of`.  Everything else, training included,
    runs as it always does."""
    prev = getattr(_INT8, "sites", None)
    _INT8.sites = sites
    try:
        yield
    finally:
        _INT8.sites = prev


def int8_of(layer: nn.Module) -> Optional[dict]:
    """``layer``'s int8 kernel inside :func:`int8_scope`, else None."""
    sites = getattr(_INT8, "sites", None)
    return None if sites is None else sites.get(layer)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)(x)``: input, kernel and bias promoted
    to the compute dtype; inside :func:`int8_scope` the reference's
    int8 path on ``x`` as it comes."""
    q = int8_of(layer)
    if q is not None:
        from analytics_zoo_tpu_torch.learn.quantize import int8_dense

        return int8_dense(x, q, layer.bias)
    materialize(layer, x)
    dt = compute_dtype(dtype, x)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def conv(layer: nn.Conv1d, x: torch.Tensor, dtype: Optional[torch.dtype],
         padding=(0, 0)) -> torch.Tensor:
    """flax ``nn.Conv(dtype=dtype)`` on a channels-last ``x [B, T, C]``,
    padded ``(left, right)`` with zeros, then ``VALID``; the output is
    channels-last too (int8 inside :func:`int8_scope`)."""
    q = int8_of(layer)
    if q is not None:
        from analytics_zoo_tpu_torch.learn.quantize import int8_conv

        return int8_conv(x, q, layer.bias, layer.stride, [padding],
                         layer.dilation, layer.groups)
    xc = x.transpose(1, 2)
    materialize(layer, xc)
    dt = compute_dtype(dtype, x)
    if padding != (0, 0):
        xc = F.pad(xc, padding)
    bias = None if layer.bias is None else layer.bias.to(dt)
    y = F.conv1d(xc.to(dt), layer.weight.to(dt), bias,
                 dilation=layer.dilation)
    return y.transpose(1, 2)


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv`` over two spatial axes: ``weight [out, in, kh,
    kw]`` (the kernel ``[kh, kw, in, out]`` transposed), lecun-normal
    over ``kh * kw * in``, a zero bias where there is one (flax's
    ``use_bias``).  Applied through :func:`conv2d`."""

    def reset_parameters(self) -> None:
        w = self.weight
        lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3])
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LazyConv2d(nn.LazyConv2d):
    """A :class:`Conv2d` whose input channels come from its first
    input."""

    cls_to_become = Conv2d

    def reset_parameters(self) -> None:
        if not self.has_uninitialized_params() and self.in_channels != 0:
            Conv2d.reset_parameters(self)


def same_pads(size: int, kernel_size: int, stride: int):
    """flax's ``padding="SAME"`` along one axis: ``(low, high)`` with
    ``ceil(size / stride)`` outputs, the odd one out at the end (a
    stride-2 3x3 conv on 56 pads (0, 1), a 7x7 on 224 pads (2, 3))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel_size - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel_size, stride):
    """``x [N, C, H, W]`` padded with zeros at the end of H and W by what
    flax's SAME pads there beyond its start; returns it and the start
    pads ``(ph, pw)``, which the conv itself pads on both sides."""
    (lh, hh), (lw, hw) = (same_pads(x.shape[2 + i], kernel_size[i],
                                    stride[i]) for i in range(2))
    if (hh, hw) != (lh, lw):
        x = F.pad(x, (0, hw - lw, 0, hh - lh))
    return x, (lh, lw)


def conv2d(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """flax ``nn.Conv(dtype=dtype, padding="SAME")`` on ``x [N, C, H,
    W]``: input, kernel and bias cast to ``dtype``, padded as flax pads.

    On the CPU a strided 1x1 conv (SAME pads nothing there) runs as the
    1x1 conv of the input's every stride-th row and column, the same
    products: oneDNN's backward of a strided 1x1 conv over a
    ``channels_last`` input crashes with several threads at some shapes
    (torch 2.13, e.g. 4 x 8 x 16 x 16).  Inside :func:`int8_scope` the
    reference's int8 conv on ``x`` as it comes (channels last)."""
    q = int8_of(layer)
    if q is not None:
        from analytics_zoo_tpu_torch.learn.quantize import int8_conv

        pads = [same_pads(x.shape[2 + i], layer.kernel_size[i],
                          layer.stride[i]) for i in range(2)]
        y = int8_conv(x.permute(0, 2, 3, 1), q, layer.bias, layer.stride,
                      pads, layer.dilation, layer.groups)
        return y.permute(0, 3, 1, 2)
    materialize(layer, x)
    stride = layer.stride
    if x.device.type == "cpu" and layer.kernel_size == (1, 1) and \
            stride != (1, 1):
        x, stride = x[:, :, ::stride[0], ::stride[1]], (1, 1)
    x, pads = _pad_same(x, layer.kernel_size, stride)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias,
                    stride=stride, padding=pads)


def max_pool_same(x: torch.Tensor, window: int, stride: int
                  ) -> torch.Tensor:
    """flax ``nn.max_pool(x, (window,) * 2, (stride,) * 2,
    padding="SAME")`` on ``x [N, C, H, W]``: the padding is -inf."""
    (lh, hh), (lw, hw) = (same_pads(x.shape[2 + i], window, stride)
                          for i in range(2))
    x = F.pad(x, (lw, hw, lh, hh), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(dtype=float32)`` over the channel dim
    ``axis`` (1 by default: ``x [N, C, ...]``; Keras's
    ``BatchNormalization`` passes -1, channels-last), with flax's
    ``momentum`` (0.99) and ``epsilon`` (1e-5 here, the image models'):
    ``weight`` and ``bias`` (flax's ``scale`` and ``bias``), and the
    buffers ``running_mean`` and ``running_var`` (its ``batch_stats``).

    ``forward(x, train)``: with ``train`` the statistics of ``x`` in f32
    (f64 stays f64, as flax promotes), the variance the biased ``max(0,
    E[x^2] - E[x]^2)``, and the running buffers move ``momentum * old +
    (1 - momentum) * batch`` (the biased variance, not the unbiased one
    ``F.batch_norm`` would store); without ``train`` the running
    statistics, untouched.  The output is f32.  In a data-parallel step
    (``parallel.data_parallel.rows_of_global``) the statistics are the
    global batch's: every rank's f32 sums and sums of squares
    all-reduced, as flax's means over a dp mesh's global batch
    (``nn.SyncBatchNorm`` stores the unbiased variance, so it does not
    fit)."""

    MOMENTUM = 0.99
    EPS = 1e-5

    def __init__(self, features: int, momentum: float = MOMENTUM,
                 epsilon: float = EPS, axis: int = 1):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.axis = axis
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        axis = self.axis % x.ndim
        shape = [1] * x.ndim
        shape[axis] = -1
        if train:
            axes = tuple(i for i in range(x.ndim) if i != axis)
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            if dp.current() is None:
                mean = xf.mean(axes)
                sq = (xf * xf).mean(axes)
            else:
                # a data-parallel step: the global batch's statistics,
                # from every rank's sums (all-reduced with a gradient)
                n = dp.global_count(x.numel() // x.shape[axis])
                sums = dp.global_sums(torch.stack([xf.sum(axes),
                                                   (xf * xf).sum(axes)]))
                mean, sq = sums[0] / n, sums[1] / n
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + \
            self.bias.view(shape)


def same_padding(kernel_size: int, dilation: int = 1):
    """flax's ``padding="SAME"`` at stride 1: ``(left, right)``, the
    odd one out on the right."""
    total = (kernel_size - 1) * dilation
    return total // 2, total - total // 2


# ---------------------------------------------------------------------------
# the reference's flax trees
# ---------------------------------------------------------------------------

_LSTM = ("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho")
_GRU = ("ir", "iz", "in"), ("hr", "hz", "hn")
_AUGRU = ("r_x", "u_x", "c_x"), ("r_h", "u_h")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _kernels(p, names):
    """The kernels of ``names`` side by side, transposed: ``[sum out,
    in]``."""
    return _t(np.concatenate([np.asarray(p[n]["kernel"], np.float32)
                              for n in names], axis=1).T)


def _biases(p, names):
    return _t(np.concatenate([np.asarray(p[n]["bias"], np.float32)
                              for n in names]))


def params_from_flax(params: Mapping, prefix: str = ""
                     ) -> Dict[str, torch.Tensor]:
    """The reference's ``variables["params"]`` (leaves as numpy arrays or
    anything ``np.asarray`` takes) as the matching port module's
    ``state_dict``.

    - an ``Embed`` (``embedding``) -> ``weight``;
    - a ``Dense`` kernel ``[in, out]`` -> ``weight [out, in]``, a
      ``Conv`` kernel ``[k, in, out]`` -> ``weight [out, in, k]`` and
      ``[kh, kw, in, out]`` -> ``weight [out, in, kh, kw]``; ``bias`` as
      it is;
    - a ``BatchNorm`` (``scale``, ``bias``) -> ``weight``, ``bias``;
    - an ``LSTMCell`` (``ii if ig io`` without bias, ``hi hf hg ho`` with)
      -> ``i.weight [4H, in]``, ``h.weight [4H, H]``, ``h.bias [4H]``;
    - a ``GRUCell`` (``ir iz in`` with bias, ``hr hz`` without, ``hn``
      with) -> ``i.weight [3H, in]``, ``i.bias``, ``h.weight [3H, H]``,
      ``hn_bias [H]``;
    - an ``AUGRUCell`` (six biased Dense layers) -> ``x.weight [3H, in]``
      and ``x.bias`` (``r_x u_x c_x``), ``h.weight [2H, H]`` and
      ``h.bias`` (``r_h u_h``), and ``c_h``.
    """
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        key = prefix + name
        keys = set(sub)
        if keys == {"embedding"}:
            out[key + ".weight"] = _t(sub["embedding"])
        elif keys == set(_LSTM[0] + _LSTM[1]):
            out[key + ".i.weight"] = _kernels(sub, _LSTM[0])
            out[key + ".h.weight"] = _kernels(sub, _LSTM[1])
            out[key + ".h.bias"] = _biases(sub, _LSTM[1])
        elif keys == set(_GRU[0] + _GRU[1]):
            out[key + ".i.weight"] = _kernels(sub, _GRU[0])
            out[key + ".i.bias"] = _biases(sub, _GRU[0])
            out[key + ".h.weight"] = _kernels(sub, _GRU[1])
            out[key + ".hn_bias"] = _t(sub["hn"]["bias"])
        elif keys == set(_AUGRU[0] + _AUGRU[1] + ("c_h",)):
            out[key + ".x.weight"] = _kernels(sub, _AUGRU[0])
            out[key + ".x.bias"] = _biases(sub, _AUGRU[0])
            out[key + ".h.weight"] = _kernels(sub, _AUGRU[1])
            out[key + ".h.bias"] = _biases(sub, _AUGRU[1])
            out.update(params_from_flax({"c_h": sub["c_h"]}, key + "."))
        elif "kernel" in keys and keys <= {"kernel", "bias"}:
            k = np.asarray(sub["kernel"], np.float32)
            out[key + ".weight"] = _t(k.T if k.ndim == 2 else k.transpose(
                (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))))
            if "bias" in keys:
                out[key + ".bias"] = _t(sub["bias"])
        elif keys == {"scale", "bias"}:
            out[key + ".weight"] = _t(sub["scale"])
            out[key + ".bias"] = _t(sub["bias"])
        else:
            out.update(params_from_flax(sub, key + "."))
    return out


def batch_stats_from_flax(batch_stats: Mapping, prefix: str = ""
                          ) -> Dict[str, torch.Tensor]:
    """The reference's ``variables["batch_stats"]`` (each BatchNorm's
    ``mean`` and ``var``) as the port's :class:`BatchNorm` buffers
    ``running_mean`` and ``running_var``, keyed as in ``state_dict``:
    load them with :func:`params_from_flax`'s entries."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in batch_stats.items():
        key = prefix + name
        if set(sub) == {"mean", "var"}:
            out[key + ".running_mean"] = _t(sub["mean"])
            out[key + ".running_var"] = _t(sub["var"])
        else:
            out.update(batch_stats_from_flax(sub, key + "."))
    return out


# The reference's attention projections are ``DenseGeneral`` kernels with
# head axes, q/k/v ``[E, H, D]`` and ``attn_out`` ``[H, D, E]``; the port
# folds each into a 2-D ``nn.Linear`` weight after its first ``n`` (input)
# axes.  An attention module laid out so carries ``head_folds =
# HEAD_FOLDS`` and its head dim as ``_d``.
HEAD_FOLDS = {"query": 1, "key": 1, "value": 1, "attn_out": 2}


@dataclass(frozen=True)
class FlaxLeaf:
    """A port tensor as the reference's leaf: the port tensor is the leaf
    (of ``shape``) reshaped to ``folded`` and permuted by ``perm``."""
    shape: Tuple[int, ...]
    folded: Tuple[int, ...]
    perm: Tuple[int, ...]

    def to_port(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.folded).permute(self.perm)

    def from_port(self, t: torch.Tensor) -> torch.Tensor:
        inv = sorted(range(len(self.perm)), key=self.perm.__getitem__)
        return t.permute(inv).reshape(self.shape)

    @property
    def last_axis(self) -> int:
        """The port axis whose trailing part is the leaf's last axis."""
        return self.perm.index(len(self.folded) - 1)


def flax_leaf(model: nn.Module, name: str) -> FlaxLeaf:
    """The reference leaf behind ``model``'s tensor ``name`` (a
    ``state_dict`` key): an embedding table and a tensor of one dim as
    they are (and every tensor of a module whose ``flax_layout`` is true,
    which keeps the reference's leaves as they are), a Dense kernel
    ``[in, out]`` transposed, a Conv kernel
    ``[*k, in, out]`` as ``[out, in, *k]``, and an attention projection's
    head axes folded (:data:`HEAD_FOLDS`; a q/k/v bias is ``[H, D]``)."""
    owner_name, _, attr = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    s = tuple(getattr(owner, attr).shape)
    parent_name, _, proj = owner_name.rpartition(".")
    parent = model.get_submodule(parent_name)
    n_in = getattr(parent, "head_folds", {}).get(proj)
    if n_in is not None and attr == "weight":
        out, d = s[0], parent._d
        shape = (s[1], out // d, d) if n_in == 1 else (s[1] // d, d, out)
        return FlaxLeaf(shape, (s[1], out), (1, 0))
    if n_in == 1 and attr == "bias":
        return FlaxLeaf((s[0] // parent._d, parent._d), s, (0,))
    if isinstance(owner, nn.Embedding) or len(s) < 2 or \
            getattr(owner, "flax_layout", False):
        return FlaxLeaf(s, s, tuple(range(len(s))))
    k = len(s) - 2
    folded = tuple(s[2:]) + (s[1], s[0])
    return FlaxLeaf(folded, folded, (k + 1, k) + tuple(range(k)))
