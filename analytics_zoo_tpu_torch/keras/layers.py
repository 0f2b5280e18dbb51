"""Keras-1.2-compatible layer catalog: the port of
``analytics_zoo_tpu/keras/layers.py``.

Each layer is an ``nn.Module`` (:class:`~analytics_zoo_tpu_torch.keras.
engine.Layer`) with the reference's keras-style constructor arguments
and its numbers: layout channels-LAST (NHWC, as the reference), shapes
inferred from the first input, and the flax submodules' names, so the
reference's variables load into it (``engine.set_variables``).  What
each follows of flax:

- convolutions: flax ``nn.Conv`` (cross-correlation) with its ``SAME``
  padding, which pads a strided or even-sized window one more at the end
  than at the start (``models.layers.same_pads``); ``Deconvolution2D`` is
  ``nn.ConvTranspose`` with ``transpose_kernel=False`` (the kernel is
  used as it is, over an input dilated by the stride, with lax's
  ``_conv_transpose_padding``), computed as ``conv_transpose`` of the
  flipped kernel and cropped where lax pads one less at the end;
- pooling: ``nn.max_pool`` pads with -inf, ``nn.avg_pool`` with zeros
  that count in the mean (``count_include_pad``); windows come from
  ``pool_length``/``stride`` as well as ``pool_size``/``strides``;
- ``Flatten`` flattens NHWC in that order, so a following ``Dense``
  reads the reference's kernel as it is;
- recurrent layers run the port's cells (``models/rnn.py``: the
  reference's ``OptimizedLSTMCell``, ``GRUCell`` and ``SimpleCell``
  parameters, ``inner_activation`` as the gate function);
  ``go_backwards`` runs the reversed sequence and returns its outputs in
  the original order (flax's ``keep_order``); the LSTM's returned state
  is ``h``.  ``ConvLSTM2D`` is flax's ``ConvLSTMCell`` (gates ``i, g, f,
  o``, ``f`` through ``sigmoid(f + 1)``, both convs biased);
- ``BatchNormalization``: ``models.layers.BatchNorm`` on the last axis
  (epsilon 1e-3); ``LayerNormalization``: epsilon 1e-6 and flax's fast
  variance ``max(0, E[x^2] - E[x]^2)``;
- ``ResizeBilinear``: ``jax.image.resize(method="bilinear")``, half-pixel
  centres and a triangle filter widened by the scale when it shrinks
  (antialiasing), one weight matrix an axis;
- random layers (``Dropout``, ``GaussianNoise``, ``GaussianDropout``,
  ``SpatialDropout*``, the recurrent layers' input dropout) draw from a
  ``torch.Generator`` seeded with the forward's ``rng`` (the Estimator
  passes ``fold_in(seed, step)``, and each layer of a model takes
  ``fold_in`` of that with its index); their masks are not threefry's.

Weights a layer owns itself (``PReLU``'s ``alpha``,
``LocallyConnected*``'s ``kernel``, ``CAdd``/``CMul``/``Scale``,
``SReLU``) are kept in the reference's layout; the rest are
``nn.Linear``/``nn.ConvNd``/``nn.Embedding`` weights in PyTorch's.

Dense and convolution layers run int8 x int8 -> int32 products when
``InferenceModel.load_flax(quantize="int8_mxu")`` attached a quantized
kernel to them (``learn/quantize.py``), exactly where the reference's
interceptor would: plain ``nn.Dense`` and ``nn.Conv`` call sites,
recurrent gates included (one product a gate and a step).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.activations import get_activation
from analytics_zoo_tpu_torch.keras.engine import TreeLeaf, Layer
from analytics_zoo_tpu_torch.keras.initializers import (constant_init,
                                                        get_initializer)
from analytics_zoo_tpu_torch.keras.regularizers import Regularizer
from analytics_zoo_tpu_torch.learn import quantize as Q
from analytics_zoo_tpu_torch.models import rnn
from analytics_zoo_tpu_torch.models import layers as ml
from analytics_zoo_tpu_torch.models.transformer import fold_in
from analytics_zoo_tpu_torch.parallel.data_parallel import rand as dp_rand

__all__ = [
    # core
    "Dense", "Activation", "Dropout", "Flatten", "Reshape", "Permute",
    "RepeatVector", "Merge", "Highway", "MaxoutDense", "Masking", "Lambda",
    # advanced activations
    "LeakyReLU", "ELU", "PReLU", "ThresholdedReLU",
    # noise / regularization
    "GaussianNoise", "GaussianDropout", "SpatialDropout1D", "SpatialDropout2D",
    "SpatialDropout3D",
    # embeddings & norm
    "Embedding", "BatchNormalization", "LayerNormalization",
    # conv
    "Convolution1D", "Convolution2D", "Convolution3D", "AtrousConvolution1D",
    "AtrousConvolution2D", "SeparableConvolution2D", "Deconvolution2D",
    "Cropping1D", "Cropping2D", "Cropping3D", "UpSampling1D", "UpSampling2D",
    "UpSampling3D", "ZeroPadding1D", "ZeroPadding2D", "ZeroPadding3D",
    "LocallyConnected1D", "LocallyConnected2D",
    # pooling
    "MaxPooling1D", "MaxPooling2D", "MaxPooling3D", "AveragePooling1D",
    "AveragePooling2D", "AveragePooling3D", "GlobalMaxPooling1D",
    "GlobalMaxPooling2D", "GlobalMaxPooling3D", "GlobalAveragePooling1D",
    "GlobalAveragePooling2D", "GlobalAveragePooling3D",
    # recurrent
    "SimpleRNN", "LSTM", "GRU", "ConvLSTM2D", "Bidirectional",
    "TimeDistributed",
    # keras2 aliases
    "Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose", "SeparableConv2D",
    "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
    "AvgPool3D",
]


def _pair(v, n=2):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,) * n


def _check_tf_ordering(dim_ordering):
    if dim_ordering not in (None, "tf", "default", "channels_last"):
        raise ValueError(
            "only channels-last ('tf') layout is supported; got "
            f"dim_ordering={dim_ordering!r}")


def _conv_padding(border_mode: str) -> str:
    if border_mode in ("valid", "same"):
        return border_mode.upper()
    raise ValueError(f"border_mode must be valid|same, got {border_mode!r}")


def _init(tensor: torch.Tensor, init, shape, kind: str = "as_is",
          default: str = "glorot_uniform") -> None:
    """Draw ``init`` at the reference's leaf ``shape`` into ``tensor``
    (in the port's layout ``kind``, as :class:`TreeLeaf`)."""
    TreeLeaf("params", (), tensor, kind).set(
        get_initializer(init, default)(shape))


def _random(rng: Optional[int], what: str, device) -> torch.Generator:
    if rng is None:
        raise ValueError(f"a training forward through {what} needs rng (the "
                         f"Estimator passes it)")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng))
    return gen


def _dropout(x, p: float, rng, train: bool, broadcast_dims=(), what="Dropout"):
    """flax ``nn.Dropout(rate=p, broadcast_dims=...)``: keep with
    probability ``1 - p`` (one draw across ``broadcast_dims``), scale by
    ``1 / (1 - p)``."""
    if not train or p == 0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = [1 if d in broadcast_dims else s for d, s in enumerate(x.shape)]
    keep = 1.0 - p
    gen = _random(rng, what, x.device)
    mask = dp_rand(shape, gen, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense`` on ``x``; int8 products where ``load_flax``
    quantized the kernel for ``int8_mxu``."""
    if getattr(mod, "int8", None) is not None:
        return Q.int8_dense(x, mod.int8, mod.bias)
    return F.linear(x, mod.weight, mod.bias)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def conv_pads(sizes, kernel, strides, dilation, padding):
    """Per spatial dim ``(low, high)``: flax's ``SAME`` or ``VALID``."""
    if padding == "VALID":
        return [(0, 0)] * len(sizes)
    return [ml.same_pads(n, (k - 1) * d + 1, s)
            for n, k, s, d in zip(sizes, kernel, strides, dilation)]


def conv_nd(mod: nn.Module, x: torch.Tensor, strides, dilation, padding,
            groups: int = 1) -> torch.Tensor:
    """flax ``nn.Conv`` (1-3 spatial dims) on channels-last ``x``; int8
    products where ``load_flax`` quantized the kernel for ``int8_mxu``."""
    nsp = x.dim() - 2
    strides, dilation = tuple(strides), tuple(dilation)
    q = getattr(mod, "int8", None)
    # an int8 kernel is [*k, in, out]; its float weight is released
    kernel = tuple(q["q"].shape[:nsp] if q is not None
                   else mod.weight.shape[2:])
    pads = conv_pads(x.shape[1:-1], kernel, strides, dilation, padding)
    if q is not None:
        return Q.int8_conv(x, q, mod.bias, strides, pads, dilation, groups)
    xc = x.movedim(-1, 1)
    if x.device.type == "cpu" and all(k == 1 for k in kernel) and \
            any(s != 1 for s in strides) and all(p == (0, 0) for p in pads):
        # oneDNN's backward of a strided 1x1 conv over a channels-last
        # input crashes at some shapes (see models.layers.conv2d)
        xc = xc[(slice(None), slice(None)) + tuple(slice(None, None, s)
                                                   for s in strides)]
        strides = (1,) * nsp
    if all(lo == hi for lo, hi in pads):
        padding_arg = tuple(lo for lo, _ in pads)
    else:
        xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
        padding_arg = 0
    y = _CONV[nsp](xc, mod.weight, mod.bias, stride=strides,
                   padding=padding_arg, dilation=dilation, groups=groups)
    return y.movedim(1, -1)


def _make_conv(nsp: int, cin: int, cout: int, kernel, groups: int = 1,
               bias: bool = True) -> nn.Module:
    cls = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}[nsp]
    return cls(cin, cout, tuple(kernel), groups=groups, bias=bias)


def _new_conv(x, cout, kernel, init, bias=True, groups=1,
              default="lecun_normal"):
    """A conv for channels-last ``x``, initialised at the reference's
    kernel shape ``[*k, in / groups, out]`` with a zero bias."""
    cin = x.shape[-1]
    mod = _make_conv(len(kernel), cin, cout, kernel, groups, bias)
    _init(mod.weight, init, tuple(kernel) + (cin // groups, cout), "conv",
          default)
    if bias:
        nn.init.zeros_(mod.bias)
    return mod.to(x.device)


def _new_dense(x, out, init, bias=True, bias_init=None,
               default="lecun_normal"):
    mod = ml.Dense(x.shape[-1], out, bias=bias)
    _init(mod.weight, init, (x.shape[-1], out), "dense", default)
    if bias:
        _init(mod.bias, bias_init or "zeros", (out,))
    return mod.to(x.device)


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------


class Dense(Layer):
    """ref: keras layers/core Dense (zoo keras-API Dense)."""

    def __init__(self, output_dim: int, init: Any = "glorot_uniform",
                 activation: Any = None,
                 W_regularizer: Optional[Regularizer] = None,
                 b_regularizer: Optional[Regularizer] = None,
                 bias: bool = True,
                 input_shape: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.output_dim, self.init, self.activation = output_dim, init, \
            activation
        self.W_regularizer, self.b_regularizer = W_regularizer, b_regularizer
        self.bias, self.input_shape = bias, input_shape

    def build(self, x):
        self.Dense_0 = _new_dense(x, self.output_dim, self.init, self.bias,
                                  default="glorot_uniform")

    def call(self, x, train, rng):
        return get_activation(self.activation)(linear(self.Dense_0, x))


class Activation(Layer):
    def __init__(self, activation: Any = "linear"):
        super().__init__()
        self.activation = activation

    def call(self, x, train, rng):
        return get_activation(self.activation)(x)


class Dropout(Layer):
    """ref: keras Dropout. ``p`` is the DROP rate (keras-1.2 spelling)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def call(self, x, train, rng):
        return _dropout(x, self.p, rng, train)


class Flatten(Layer):
    def call(self, x, train, rng):
        return x.reshape(x.shape[0], -1)


class Reshape(Layer):
    def __init__(self, target_shape: Tuple[int, ...] = ()):
        super().__init__()
        self.target_shape = tuple(target_shape)

    def call(self, x, train, rng):
        return x.reshape((x.shape[0],) + self.target_shape)


class Permute(Layer):
    """dims are 1-indexed over non-batch axes (keras semantics)."""

    def __init__(self, dims: Tuple[int, ...] = ()):
        super().__init__()
        self.dims = tuple(dims)

    def call(self, x, train, rng):
        return x.permute((0,) + self.dims)


class RepeatVector(Layer):
    def __init__(self, n: int = 1):
        super().__init__()
        self.n = n

    def call(self, x, train, rng):
        return x[:, None, :].expand(-1, self.n, -1).contiguous()


class Masking(Layer):
    """Zeroes timesteps whose features all equal ``mask_value``."""

    def __init__(self, mask_value: float = 0.0):
        super().__init__()
        self.mask_value = mask_value

    def call(self, x, train, rng):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


class Lambda(Layer):
    """An arbitrary torch expression as a layer (ref: keras Lambda)."""

    def __init__(self, function: Callable = None):
        super().__init__()
        self.function = function

    def call(self, x, train, rng):
        return self.function(x)


class Merge(Layer):
    """ref: keras Merge (mode: sum/mul/concat/ave/max/min/dot/cos)."""
    _takes_list = True

    def __init__(self, mode: str = "sum", concat_axis: int = -1):
        super().__init__()
        self.mode, self.concat_axis = mode, concat_axis

    def call(self, xs, train, rng):
        if not isinstance(xs, (list, tuple)):
            raise ValueError("Merge expects a list of inputs")
        m = self.mode
        if m in ("sum", "mul", "max", "min"):
            op = {"sum": torch.add, "mul": torch.mul, "max": torch.maximum,
                  "min": torch.minimum}[m]
            out = xs[0]
            for x in xs[1:]:
                out = op(out, x)
            return out
        if m == "ave":
            return sum(xs) / len(xs)
        if m == "concat":
            return torch.cat(list(xs), dim=self.concat_axis)
        if m == "dot":
            a, b = xs
            return torch.sum(a * b, dim=-1, keepdim=True)
        if m == "cos":
            a, b = xs
            na = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
            nb = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
            return torch.sum(na * nb, dim=-1, keepdim=True)
        raise ValueError(f"unknown merge mode {m!r}")


class Highway(Layer):
    """ref: keras Highway — ``y = t*h(x) + (1-t)*x``; the gate's bias
    starts at -2."""

    def __init__(self, activation: Any = "tanh", init: Any = "glorot_uniform",
                 bias: bool = True):
        super().__init__()
        self.activation, self.init, self.bias = activation, init, bias

    def build(self, x):
        d = x.shape[-1]
        self.Dense_0 = _new_dense(x, d, self.init, self.bias)
        self.Dense_1 = _new_dense(x, d, None, self.bias,
                                  bias_init=constant_init(-2.0))

    def call(self, x, train, rng):
        h = get_activation(self.activation)(linear(self.Dense_0, x))
        t = torch.sigmoid(linear(self.Dense_1, x))
        return t * h + (1 - t) * x


class MaxoutDense(Layer):
    """ref: keras MaxoutDense — max over ``nb_feature`` linear maps."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 bias: bool = True):
        super().__init__()
        self.output_dim, self.nb_feature, self.bias = output_dim, \
            nb_feature, bias

    def build(self, x):
        self.Dense_0 = _new_dense(x, self.output_dim * self.nb_feature, None,
                                  self.bias)

    def call(self, x, train, rng):
        y = linear(self.Dense_0, x)
        y = y.reshape(y.shape[:-1] + (self.nb_feature, self.output_dim))
        return torch.amax(y, dim=-2)


# ---------------------------------------------------------------------------
# advanced activations
# ---------------------------------------------------------------------------


class LeakyReLU(Layer):
    def __init__(self, alpha: float = 0.3):
        super().__init__()
        self.alpha = alpha

    def call(self, x, train, rng):
        return torch.where(x >= 0, x, self.alpha * x)


class ELU(Layer):
    def __init__(self, alpha: float = 1.0):
        super().__init__()
        self.alpha = alpha

    def call(self, x, train, rng):
        return F.elu(x, self.alpha)


class PReLU(Layer):
    """Learnable per-channel negative slope ``alpha`` (from 0.25)."""

    def build(self, x):
        self.alpha = nn.Parameter(torch.full((x.shape[-1],), 0.25,
                                             device=x.device))

    def call(self, x, train, rng):
        return torch.where(x >= 0, x, self.alpha * x)


class ThresholdedReLU(Layer):
    def __init__(self, theta: float = 1.0):
        super().__init__()
        self.theta = theta

    def call(self, x, train, rng):
        return torch.where(x > self.theta, x, torch.zeros(
            (), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------


class GaussianNoise(Layer):
    def __init__(self, sigma: float = 0.1):
        super().__init__()
        self.sigma = sigma

    def call(self, x, train, rng):
        if not train:
            return x
        gen = _random(rng, "GaussianNoise", x.device)
        return x + self.sigma * torch.randn(x.shape, generator=gen,
                                            device=x.device, dtype=x.dtype)


class GaussianDropout(Layer):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def call(self, x, train, rng):
        if not train or self.p <= 0:
            return x
        gen = _random(rng, "GaussianDropout", x.device)
        std = math.sqrt(self.p / (1.0 - self.p))
        return x * (1 + std * torch.randn(x.shape, generator=gen,
                                          device=x.device, dtype=x.dtype))


class _SpatialDropout(Layer):
    broadcast_dims: Tuple[int, ...] = ()

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def call(self, x, train, rng):
        return _dropout(x, self.p, rng, train, self.broadcast_dims,
                        type(self).__name__)


class SpatialDropout1D(_SpatialDropout):
    """(B, T, C): drops whole channels."""
    broadcast_dims = (1,)


class SpatialDropout2D(_SpatialDropout):
    broadcast_dims = (1, 2)


class SpatialDropout3D(_SpatialDropout):
    broadcast_dims = (1, 2, 3)


# ---------------------------------------------------------------------------
# embeddings & normalization
# ---------------------------------------------------------------------------


class Embedding(Layer):
    """ref: keras Embedding; the table is ``Embed_0`` (``[input_dim,
    output_dim]``, as the reference's)."""

    def __init__(self, input_dim: int, output_dim: int, init: Any = "uniform",
                 W_regularizer: Optional[Regularizer] = None,
                 input_length: Optional[int] = None):
        super().__init__()
        self.input_dim, self.output_dim, self.init = input_dim, output_dim, \
            init
        self.W_regularizer, self.input_length = W_regularizer, input_length

    def build(self, x):
        emb = nn.Embedding(self.input_dim, self.output_dim)
        _init(emb.weight, self.init, (self.input_dim, self.output_dim))
        self.Embed_0 = emb.to(x.device)

    def call(self, x, train, rng):
        return F.embedding(x.long(), self.Embed_0.weight)


class BatchNormalization(Layer):
    """ref: keras BatchNormalization over the last axis (``axis``);
    the running statistics are ``BatchNorm_0``'s buffers (the
    reference's ``batch_stats``) and move in a training forward."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 axis: int = -1, beta_init: Any = "zero",
                 gamma_init: Any = "one"):
        super().__init__()
        self.epsilon, self.momentum, self.axis = epsilon, momentum, axis
        self.beta_init, self.gamma_init = beta_init, gamma_init

    def build(self, x):
        c = x.shape[self.axis]
        bn = ml.BatchNorm(c, momentum=self.momentum, epsilon=self.epsilon,
                          axis=self.axis)
        _init(bn.bias, self.beta_init, (c,), default="zeros")
        _init(bn.weight, self.gamma_init, (c,), default="ones")
        self.BatchNorm_0 = bn.to(x.device)

    def call(self, x, train, rng):
        return self.BatchNorm_0(x, train=train)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: ``weight``/``bias`` are
    its ``scale``/``bias``; fast variance ``max(0, E[x^2] - E[x]^2)``."""
    flax_kind = "norm"

    def __init__(self, features: int, epsilon: float):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return (x - mean) * mul + self.bias


class LayerNormalization(Layer):
    def __init__(self, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon

    def build(self, x):
        self.LayerNorm_0 = LayerNorm(x.shape[-1], self.epsilon).to(x.device)

    def call(self, x, train, rng):
        return self.LayerNorm_0(x)


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------


class _Conv(Layer):
    """A flax ``nn.Conv`` as ``Conv_0``: kernel, strides and dilation per
    spatial dim, ``SAME`` or ``VALID``."""

    def _setup(self, nb_filter, kernel, strides, dilation, border_mode,
               init, activation, bias, W_regularizer=None,
               b_regularizer=None, default="glorot_uniform"):
        self.nb_filter, self.kernel = nb_filter, tuple(kernel)
        self.strides, self.dilation = tuple(strides), tuple(dilation)
        self.border_mode, self.init, self.activation = border_mode, init, \
            activation
        self.bias = bias
        self.W_regularizer, self.b_regularizer = W_regularizer, b_regularizer
        self._default = default

    def build(self, x):
        self.Conv_0 = _new_conv(x, self.nb_filter, self.kernel, self.init,
                                self.bias, default=self._default)

    def call(self, x, train, rng):
        y = conv_nd(self.Conv_0, x, self.strides, self.dilation,
                    _conv_padding(self.border_mode))
        return get_activation(self.activation)(y)


class Convolution1D(_Conv):
    """ref: keras Convolution1D. Input (B, steps, C)."""

    def __init__(self, nb_filter: int, filter_length: int,
                 init: Any = "glorot_uniform", activation: Any = None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 dilation_rate: int = 1,
                 W_regularizer: Optional[Regularizer] = None,
                 b_regularizer: Optional[Regularizer] = None,
                 bias: bool = True,
                 input_shape: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self._setup(nb_filter, (filter_length,), (subsample_length,),
                    (dilation_rate,), border_mode, init, activation, bias,
                    W_regularizer, b_regularizer)
        self.input_shape = input_shape


class Convolution2D(_Conv):
    """ref: keras Convolution2D. Input (B, H, W, C) — channels-last."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 init: Any = "glorot_uniform", activation: Any = None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 dilation_rate: Tuple[int, int] = (1, 1),
                 W_regularizer: Optional[Regularizer] = None,
                 b_regularizer: Optional[Regularizer] = None,
                 bias: bool = True, dim_ordering: Optional[str] = None,
                 input_shape: Optional[Tuple[int, ...]] = None):
        super().__init__()
        _check_tf_ordering(dim_ordering)
        self._setup(nb_filter, (nb_row, nb_col), _pair(subsample),
                    _pair(dilation_rate), border_mode, init, activation, bias,
                    W_regularizer, b_regularizer)
        self.input_shape = input_shape


class Convolution3D(_Conv):
    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int,
                 kernel_dim3: int, activation: Any = None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int, int] = (1, 1, 1),
                 bias: bool = True):
        super().__init__()
        self._setup(nb_filter, (kernel_dim1, kernel_dim2, kernel_dim3),
                    _pair(subsample, 3), (1, 1, 1), border_mode, None,
                    activation, bias, default="lecun_normal")


def AtrousConvolution1D(nb_filter, filter_length, atrous_rate=1, **kw):
    """ref: keras AtrousConvolution1D → dilated Conv1D."""
    return Convolution1D(nb_filter, filter_length,
                         dilation_rate=atrous_rate, **kw)


def AtrousConvolution2D(nb_filter, nb_row, nb_col, atrous_rate=(1, 1), **kw):
    return Convolution2D(nb_filter, nb_row, nb_col,
                         dilation_rate=_pair(atrous_rate), **kw)


class SeparableConvolution2D(Layer):
    """Depthwise (``Conv_0``, ``groups = C``) then pointwise
    (``Conv_1``)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation: Any = None, border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 depth_multiplier: int = 1, bias: bool = True):
        super().__init__()
        self.nb_filter, self.kernel = nb_filter, (nb_row, nb_col)
        self.activation, self.border_mode = activation, border_mode
        self.subsample, self.depth_multiplier = _pair(subsample), \
            depth_multiplier
        self.bias = bias

    def build(self, x):
        c = x.shape[-1]
        self.Conv_0 = _new_conv(x, c * self.depth_multiplier, self.kernel,
                                None, bias=False, groups=c)
        mid = x.new_zeros(x.shape[:-1] + (c * self.depth_multiplier,))
        self.Conv_1 = _new_conv(mid, self.nb_filter, (1, 1), None, self.bias)

    def call(self, x, train, rng):
        y = conv_nd(self.Conv_0, x, self.subsample, (1, 1),
                    _conv_padding(self.border_mode), groups=x.shape[-1])
        y = conv_nd(self.Conv_1, y, (1, 1), (1, 1), "VALID")
        return get_activation(self.activation)(y)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose``'s parameters: ``weight [out, in, *k]``
    (its kernel ``[*k, in, out]``, used unflipped) and ``bias``."""
    flax_kind = "conv"

    def __init__(self, cin: int, cout: int, kernel, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + tuple(kernel)))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


def _transpose_pads(k: int, s: int, padding: str):
    """lax ``_conv_transpose_padding``: the (low, high) padding of the
    stride-dilated input."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


def conv_transpose_nd(mod: ConvTranspose, x: torch.Tensor, strides,
                      padding: str) -> torch.Tensor:
    """flax ``nn.ConvTranspose(transpose_kernel=False)`` on channels-last
    ``x``: lax correlates the kernel as it is with the input dilated by
    the strides and padded ``(a, b)``; ``conv_transpose`` pads ``k - 1 -
    p`` at both ends (plus ``output_padding`` at the end) and flips its
    weight, so it gets the flipped kernel, ``p = k - 1 - a`` and
    ``output_padding = b - a``, whose -1 (SAME) is one output cropped."""
    nsp = x.dim() - 2
    kernel = tuple(mod.weight.shape[2:])
    pa_pb = [_transpose_pads(k, s, padding) for k, s in zip(kernel, strides)]
    p = tuple(k - 1 - a for k, (a, _) in zip(kernel, pa_pb))
    op = tuple(b - a for a, b in pa_pb)
    w = mod.weight.flip(tuple(range(2, 2 + nsp))).transpose(0, 1)
    fn = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
          3: F.conv_transpose3d}[nsp]
    y = fn(x.movedim(-1, 1), w, mod.bias, stride=tuple(strides), padding=p,
           output_padding=tuple(max(o, 0) for o in op))
    crop = tuple(slice(None, y.shape[2 + i] + o if o < 0 else None)
                 for i, o in enumerate(op))
    return y[(slice(None), slice(None)) + crop].movedim(1, -1)


class Deconvolution2D(Layer):
    """Transposed conv (ref: keras Deconvolution2D): ``ConvTranspose_0``."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation: Any = None, border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1), bias: bool = True,
                 output_shape: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.nb_filter, self.kernel = nb_filter, (nb_row, nb_col)
        self.activation, self.border_mode = activation, border_mode
        self.subsample, self.bias = _pair(subsample), bias
        self.output_shape = output_shape

    def build(self, x):
        c = x.shape[-1]
        mod = ConvTranspose(c, self.nb_filter, self.kernel, self.bias)
        _init(mod.weight, None, self.kernel + (c, self.nb_filter), "conv",
              default="lecun_normal")
        self.ConvTranspose_0 = mod.to(x.device)

    def call(self, x, train, rng):
        y = conv_transpose_nd(self.ConvTranspose_0, x, self.subsample,
                              _conv_padding(self.border_mode))
        return get_activation(self.activation)(y)


def _patches(x: torch.Tensor, window, strides) -> torch.Tensor:
    """lax ``conv_general_dilated_patches(x, window, strides, "VALID")``
    on channels-last ``x``: ``[B, *out, C * prod(window)]``, channel-major
    (feature ``c * prod(window) + offset``)."""
    nsp = x.dim() - 2
    for d, (k, s) in enumerate(zip(window, strides)):
        x = x.unfold(1 + d, k, s)
    # [B, *out, C, *window]
    return x.reshape(x.shape[:1 + nsp] + (-1,))


class LocallyConnected1D(Layer):
    """Unshared conv (ref: keras LocallyConnected1D): ``kernel [L, C *
    k, F]`` and ``bias [L, F]``, one a position."""

    def __init__(self, nb_filter: int, filter_length: int,
                 activation: Any = None, subsample_length: int = 1,
                 bias: bool = True):
        super().__init__()
        self.nb_filter, self.window = nb_filter, (filter_length,)
        self.activation, self.strides = activation, (subsample_length,)
        self.use_bias = bias

    def build(self, x):
        p = _patches(x, self.window, self.strides)
        shape = tuple(p.shape[1:]) + (self.nb_filter,)
        self.kernel = nn.Parameter(torch.empty(shape, device=x.device))
        _init(self.kernel, None, shape, default="lecun_normal")
        if self.use_bias:
            self.bias = nn.Parameter(torch.zeros(
                shape[:-2] + (self.nb_filter,), device=x.device))

    def call(self, x, train, rng):
        p = _patches(x, self.window, self.strides)
        y = torch.einsum("b...p,...pf->b...f", p, self.kernel)
        if self.use_bias:
            y = y + self.bias
        return get_activation(self.activation)(y)


class LocallyConnected2D(LocallyConnected1D):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation: Any = None,
                 subsample: Tuple[int, int] = (1, 1), bias: bool = True):
        Layer.__init__(self)
        self.nb_filter, self.window = nb_filter, (nb_row, nb_col)
        self.activation, self.strides = activation, _pair(subsample)
        self.use_bias = bias


def _crop(x, crops):
    idx = [slice(None)]
    for d, (lo, hi) in enumerate(crops):
        idx.append(slice(lo, x.shape[1 + d] - hi))
    return x[tuple(idx)]


class Cropping1D(Layer):
    def __init__(self, cropping: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.cropping = tuple(cropping)

    def call(self, x, train, rng):
        return _crop(x, [self.cropping])


class Cropping2D(Layer):
    def __init__(self, cropping=((0, 0), (0, 0))):
        super().__init__()
        self.cropping = tuple(tuple(c) for c in cropping)

    def call(self, x, train, rng):
        return _crop(x, self.cropping)


class Cropping3D(Cropping2D):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1))):
        super().__init__(cropping)


class _UpSampling(Layer):
    def _repeat(self, x, sizes):
        for d, s in enumerate(sizes):
            x = torch.repeat_interleave(x, s, dim=1 + d)
        return x


class UpSampling1D(_UpSampling):
    def __init__(self, length: int = 2):
        super().__init__()
        self.length = length

    def call(self, x, train, rng):
        return self._repeat(x, (self.length,))


class UpSampling2D(_UpSampling):
    def __init__(self, size=(2, 2)):
        super().__init__()
        self.size = _pair(size)

    def call(self, x, train, rng):
        return self._repeat(x, self.size)


class UpSampling3D(_UpSampling):
    def __init__(self, size=(2, 2, 2)):
        super().__init__()
        self.size = _pair(size, 3)

    def call(self, x, train, rng):
        return self._repeat(x, self.size)


class _ZeroPadding(Layer):
    def _pad(self, x, pads):
        return F.pad(x, [0, 0] + [p for lo_hi in reversed(pads)
                                  for p in lo_hi])


class ZeroPadding1D(_ZeroPadding):
    def __init__(self, padding: Union[int, Tuple[int, int]] = 1):
        super().__init__()
        self.padding = _pair(padding)

    def call(self, x, train, rng):
        return self._pad(x, [self.padding])


class ZeroPadding2D(_ZeroPadding):
    def __init__(self, padding=(1, 1)):
        super().__init__()
        self.padding = _pair(padding)

    def call(self, x, train, rng):
        return self._pad(x, [(p, p) for p in self.padding])


class ZeroPadding3D(_ZeroPadding):
    def __init__(self, padding=(1, 1, 1)):
        super().__init__()
        self.padding = _pair(padding, 3)

    def call(self, x, train, rng):
        return self._pad(x, [(p, p) for p in self.padding])


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


class _Pool(Layer):
    ndim, reducer = 2, "max"

    def __init__(self, pool_size: Any = 2, strides: Any = None,
                 border_mode: str = "valid", pool_length: Any = None,
                 stride: Any = None):
        super().__init__()
        size = pool_length if pool_length is not None else pool_size
        self.window = _pair(size, self.ndim)
        st = stride if stride is not None else strides
        self.strides = _pair(st, self.ndim) if st is not None else \
            self.window
        self.border_mode = border_mode

    def call(self, x, train, rng):
        pads = conv_pads(x.shape[1:-1], self.window, self.strides,
                         (1,) * self.ndim, _conv_padding(self.border_mode))
        xc = x.movedim(-1, 1)
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        if self.reducer == "max":
            if any(flat):
                xc = F.pad(xc, flat, value=float("-inf"))
            y = _MAX_POOL[self.ndim](xc, self.window, self.strides)
        else:
            if any(flat):       # padded zeros count in the mean
                xc = F.pad(xc, flat)
            y = _AVG_POOL[self.ndim](xc, self.window, self.strides)
        return y.movedim(1, -1)


def _pool_layer(name, ndim, reducer):
    cls = type(name, (_Pool,), {"ndim": ndim, "reducer": reducer,
                                "__module__": __name__})
    cls.__qualname__ = name
    return cls


MaxPooling1D = _pool_layer("MaxPooling1D", 1, "max")
MaxPooling2D = _pool_layer("MaxPooling2D", 2, "max")
MaxPooling3D = _pool_layer("MaxPooling3D", 3, "max")
AveragePooling1D = _pool_layer("AveragePooling1D", 1, "avg")
AveragePooling2D = _pool_layer("AveragePooling2D", 2, "avg")
AveragePooling3D = _pool_layer("AveragePooling3D", 3, "avg")


class _GlobalPool(Layer):
    axes, reducer = (1,), "max"

    def call(self, x, train, rng):
        if self.reducer == "max":
            return torch.amax(x, dim=self.axes)
        return torch.mean(x, dim=self.axes)


def _global_pool(name, axes, reducer):
    cls = type(name, (_GlobalPool,), {"axes": axes, "reducer": reducer,
                                      "__module__": __name__})
    cls.__qualname__ = name
    return cls


GlobalMaxPooling1D = _global_pool("GlobalMaxPooling1D", (1,), "max")
GlobalMaxPooling2D = _global_pool("GlobalMaxPooling2D", (1, 2), "max")
GlobalMaxPooling3D = _global_pool("GlobalMaxPooling3D", (1, 2, 3), "max")
GlobalAveragePooling1D = _global_pool("GlobalAveragePooling1D", (1,), "avg")
GlobalAveragePooling2D = _global_pool("GlobalAveragePooling2D", (1, 2), "avg")
GlobalAveragePooling3D = _global_pool("GlobalAveragePooling3D", (1, 2, 3),
                                      "avg")


# ---------------------------------------------------------------------------
# recurrent
# ---------------------------------------------------------------------------


def _default_act(name, default):
    """The cells' own default (None) for the reference's default name, so
    a saved model pickles no function."""
    return None if name == default else get_activation(name)


def _gate(cell_lin: nn.Linear, g: int, n: int, x: torch.Tensor,
          bias="rows") -> torch.Tensor:
    """Gate ``g`` of ``n`` of a fused cell projection on ``x``: flax's
    own Dense for that gate (its rows of the fused bias, or ``bias``),
    int8 where ``load_flax`` quantized it."""
    q = (getattr(cell_lin, "int8_gates", None) or [None] * n)[g]
    H = cell_lin.weight.shape[0] // n
    if isinstance(bias, str):
        bias = None if cell_lin.bias is None else \
            cell_lin.bias[g * H:(g + 1) * H]
    if q is not None:
        return Q.int8_dense(x, q, bias)
    return F.linear(x, cell_lin.weight[g * H:(g + 1) * H], bias)


class _Recurrent(Layer):
    """Shared RNN scaffolding over ``[B, T, F]``; the cell is
    ``<flax cell name>_0``."""
    _cell_kind = "simple"
    _cell_name = "SimpleCell_0"

    def __init__(self, output_dim: int = 0, activation: Any = "tanh",
                 inner_activation: Any = "sigmoid",
                 return_sequences: bool = False, go_backwards: bool = False,
                 dropout: float = 0.0,
                 input_shape: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.output_dim, self.activation = output_dim, activation
        self.inner_activation = inner_activation
        self.return_sequences, self.go_backwards = return_sequences, \
            go_backwards
        self.dropout, self.input_shape = dropout, input_shape

    def build(self, x):
        act = _default_act(self.activation, "tanh")
        gate = _default_act(self.inner_activation, "sigmoid")
        H, fin = self.output_dim, x.shape[-1]
        if self._cell_kind == "lstm":
            cell = rnn.LSTMCell(fin, H, None, gate_fn=gate,
                                activation_fn=act)
            fused = (cell.i.weight, cell.h.weight, cell.h.bias)
        elif self._cell_kind == "gru":
            cell = rnn.GRUCell(fin, H, None, gate_fn=gate, activation_fn=act)
            fused = (cell.i.weight, cell.i.bias, cell.h.weight)
        else:
            cell = rnn.SimpleCell(fin, H, None, activation_fn=act)
            fused = ()
        for p in fused:         # one reference leaf a gate (optimizers.Lamb)
            p.flax_chunks = cell.gates
        self.add_module(self._cell_name, cell.to(x.device))

    @property
    def cell(self):
        return getattr(self, self._cell_name)

    def call(self, x, train, rng):
        if self.dropout:
            x = _dropout(x, self.dropout, rng, train, what=type(self).__name__)
        if self.go_backwards:
            x = x.flip(1)
        cell = self.cell
        if self._int8():
            carry, seq = self._int8_scan(cell, x)
        else:
            carry, seq = rnn.scan(cell, x)
        if self.go_backwards:
            seq = seq.flip(1)
        if self.return_sequences:
            return seq
        return carry[1] if self._cell_kind == "lstm" else carry

    def _int8(self) -> bool:
        return any(getattr(m, "int8_gates", None) for m in self.modules())

    def _int8_scan(self, cell, x):
        """The reference's cell step by step, each of flax's Dense gates
        its own product (int8 where quantized): its interceptor sees one
        Dense call a gate and a step."""
        h = cell.initial_carry(x.shape[0], x.device)
        gate = cell.gate_fn or torch.sigmoid
        act = cell.activation_fn or torch.tanh
        ys = []
        for t in range(x.shape[1]):
            xt = x[:, t]
            if self._cell_kind == "gru":
                r = gate(_gate(cell.i, 0, 3, xt) + _gate(cell.h, 0, 3, h))
                z = gate(_gate(cell.i, 1, 3, xt) + _gate(cell.h, 1, 3, h))
                xn = _gate(cell.i, 2, 3, xt)
                n = act(xn + r * _gate(cell.h, 2, 3, h, bias=cell.hn_bias))
                h = (1.0 - z) * n + z * h
            else:
                h = act(_gate(cell.i, 0, 1, xt) + _gate(cell.h, 0, 1, h))
            ys.append(h)
        return h, torch.stack(ys, dim=1)


class SimpleRNN(_Recurrent):
    """ref: keras SimpleRNN."""


class LSTM(_Recurrent):
    """ref: keras LSTM (flax ``OptimizedLSTMCell``)."""
    _cell_kind = "lstm"
    _cell_name = "OptimizedLSTMCell_0"


class GRU(_Recurrent):
    """ref: keras GRU."""
    _cell_kind = "gru"
    _cell_name = "GRUCell_0"


class ConvLSTMCell(nn.Module):
    """flax ``nn.ConvLSTMCell``: the input conv ``ih`` and the recurrent
    conv ``hh``, both biased, ``4 * features`` outputs split ``i, g, f,
    o``."""

    def __init__(self, ih: nn.Module, hh: nn.Module, features: int):
        super().__init__()
        self.ih, self.hh, self.features = ih, hh, features


class ConvLSTM2D(Layer):
    """ref: keras ConvLSTM2D. Input (B, T, H, W, C)."""

    def __init__(self, nb_filter: int, nb_row: int = 3, nb_col: int = 3,
                 border_mode: str = "same", return_sequences: bool = False):
        super().__init__()
        self.nb_filter, self.kernel = nb_filter, (nb_row, nb_col)
        self.border_mode, self.return_sequences = border_mode, \
            return_sequences

    def build(self, x):
        F4 = 4 * self.nb_filter
        xt = x[:, 0]
        ih = _new_conv(xt, F4, self.kernel, None)
        hh = _new_conv(xt.new_zeros(xt.shape[:-1] + (self.nb_filter,)), F4,
                       self.kernel, None)
        self.ConvLSTMCell_0 = ConvLSTMCell(ih, hh, self.nb_filter)

    def call(self, x, train, rng):
        cell = self.ConvLSTMCell_0
        pad = _conv_padding(self.border_mode)
        B, T = x.shape[:2]
        one = (1, 1)
        if getattr(cell.ih, "int8", None) is None:
            # the input half of every gate for all T steps in one conv
            xp = conv_nd(cell.ih, x.reshape((B * T,) + x.shape[2:]), one,
                         one, pad)
            xp = xp.reshape((B, T) + xp.shape[1:])
        c = h = None
        ys = []
        for t in range(T):
            xg = xp[:, t] if getattr(cell.ih, "int8", None) is None else \
                conv_nd(cell.ih, x[:, t], one, one, pad)
            if h is None:
                c = h = torch.zeros(xg.shape[:-1] + (cell.features,),
                                    dtype=torch.float32, device=x.device)
            gates = xg + conv_nd(cell.hh, h, one, one, pad)
            i, g, f, o = gates.chunk(4, dim=-1)
            f = torch.sigmoid(f + 1)
            c = f * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys, dim=1) if self.return_sequences else h


class Bidirectional(Layer):
    """ref: keras Bidirectional wrapper: two copies of a recurrent layer,
    ``forward`` and ``backward`` (``go_backwards``), parameters NOT
    shared."""

    def __init__(self, layer: nn.Module = None, merge_mode: str = "concat"):
        super().__init__()
        self.merge_mode = merge_mode
        fwd, bwd = copy.deepcopy(layer), copy.deepcopy(layer)
        fwd.go_backwards, bwd.go_backwards = False, True
        # "forward" is nn.Module's method name: add_module refuses it
        self._modules["forward"] = fwd
        self._modules["backward"] = bwd

    def call(self, x, train, rng):
        a = self._modules["forward"](x, train=train, rng=rng)
        b = self._modules["backward"](
            x, train=train, rng=None if rng is None else fold_in(rng, 1))
        if self.merge_mode == "concat":
            return torch.cat([a, b], dim=-1)
        if self.merge_mode == "sum":
            return a + b
        if self.merge_mode == "mul":
            return a * b
        if self.merge_mode == "ave":
            return (a + b) / 2
        raise ValueError(f"unknown merge_mode {self.merge_mode!r}")


class TimeDistributed(Layer):
    """Apply ``layer`` to every timestep of (B, T, ...) as one call on
    ``B * T`` rows; the child is ``layer``."""

    def __init__(self, layer: nn.Module = None):
        super().__init__()
        self.layer = layer

    def call(self, x, train, rng):
        from analytics_zoo_tpu_torch.keras.engine import _call_layer

        B, T = x.shape[0], x.shape[1]
        y = _call_layer(self.layer, x.reshape((B * T,) + x.shape[2:]),
                        train, rng)
        return y.reshape((B, T) + y.shape[1:])


# ---------------------------------------------------------------------------
# keras-2 aliases
# ---------------------------------------------------------------------------


def Conv1D(filters, kernel_size, strides=1, padding="valid", activation=None,
           dilation_rate=1, use_bias=True, **kw):
    return Convolution1D(filters, kernel_size, activation=activation,
                         border_mode=padding, subsample_length=strides,
                         dilation_rate=dilation_rate, bias=use_bias, **kw)


def Conv2D(filters, kernel_size, strides=(1, 1), padding="valid",
           activation=None, dilation_rate=(1, 1), use_bias=True, **kw):
    kh, kw_ = _pair(kernel_size)
    return Convolution2D(filters, kh, kw_, activation=activation,
                         border_mode=padding, subsample=_pair(strides),
                         dilation_rate=_pair(dilation_rate), bias=use_bias,
                         **kw)


def Conv3D(filters, kernel_size, strides=(1, 1, 1), padding="valid",
           activation=None, use_bias=True, **kw):
    k = _pair(kernel_size, 3)
    return Convolution3D(filters, k[0], k[1], k[2], activation=activation,
                         border_mode=padding, subsample=_pair(strides, 3),
                         bias=use_bias, **kw)


def Conv2DTranspose(filters, kernel_size, strides=(1, 1), padding="valid",
                    activation=None, use_bias=True, **kw):
    kh, kw_ = _pair(kernel_size)
    return Deconvolution2D(filters, kh, kw_, activation=activation,
                           border_mode=padding, subsample=_pair(strides),
                           bias=use_bias, **kw)


def SeparableConv2D(filters, kernel_size, strides=(1, 1), padding="valid",
                    activation=None, depth_multiplier=1, use_bias=True, **kw):
    kh, kw_ = _pair(kernel_size)
    return SeparableConvolution2D(filters, kh, kw_, activation=activation,
                                  border_mode=padding,
                                  subsample=_pair(strides),
                                  depth_multiplier=depth_multiplier,
                                  bias=use_bias, **kw)


MaxPool1D = MaxPooling1D
MaxPool2D = MaxPooling2D
MaxPool3D = MaxPooling3D
AvgPool1D = AveragePooling1D
AvgPool2D = AveragePooling2D
AvgPool3D = AveragePooling3D


# ---------------------------------------------------------------------------
# tensor-manipulation / elementwise layers (ref: zoo pipeline/api/keras
# layers Select/Narrow/Squeeze/Exp/.../SReLU/LRN2D/ResizeBilinear)
# ---------------------------------------------------------------------------


class Select(Layer):
    """ref: Select(dim, index) — one slice along ``dim`` (dim counts the
    batch axis; negative dims allowed)."""

    def __init__(self, dim: int, index: int):
        super().__init__()
        self.dim, self.index = dim, index

    def call(self, x, train, rng):
        d = x.shape[self.dim]
        if not -d <= self.index < d:
            raise ValueError(
                f"Select index {self.index} out of range for dim "
                f"{self.dim} of size {d}")
        return x.select(self.dim, self.index)


class Narrow(Layer):
    """ref: Narrow(dim, offset, length) — contiguous slice along ``dim``."""

    def __init__(self, dim: int, offset: int, length: int = 1):
        super().__init__()
        self.dim, self.offset, self.length = dim, offset, length

    def call(self, x, train, rng):
        return x.narrow(self.dim % x.dim(), self.offset, self.length)


class Squeeze(Layer):
    """ref: Squeeze(dim) — drop a size-1 axis (dim=None: every size-1
    axis EXCEPT the batch axis)."""

    def __init__(self, dim: Optional[int] = None):
        super().__init__()
        self.dim = dim

    def call(self, x, train, rng):
        if self.dim is None:
            axes = tuple(i for i in range(1, x.dim()) if x.shape[i] == 1)
            return torch.squeeze(x, dim=axes) if axes else x
        if self.dim % x.dim() == 0:
            raise ValueError("Squeeze cannot drop the batch axis")
        return torch.squeeze(x, dim=self.dim)


class ExpandDim(Layer):
    """ref: ExpandDim(dim) — insert a size-1 axis."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def call(self, x, train, rng):
        return torch.unsqueeze(x, self.dim)


class _Elementwise(Layer):
    fn = staticmethod(lambda x: x)

    def call(self, x, train, rng):
        return type(self).fn(x)


def _elementwise(name: str, fn):
    cls = type(name, (_Elementwise,), {
        "fn": staticmethod(fn), "__module__": __name__,
        "__doc__": f"ref: zoo keras layer {name} — elementwise "
                   f"{name.lower()}."})
    cls.__qualname__ = name
    return cls


Exp = _elementwise("Exp", torch.exp)
Log = _elementwise("Log", torch.log)
Sqrt = _elementwise("Sqrt", torch.sqrt)
Square = _elementwise("Square", torch.square)
Abs = _elementwise("Abs", torch.abs)
Negative = _elementwise("Negative", torch.negative)


class Power(Layer):
    """ref: Power(power, scale, shift) — ``(scale*x + shift) ** power``."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.power, self.scale, self.shift = power, scale, shift

    def call(self, x, train, rng):
        return torch.pow(self.scale * x + self.shift, self.power)


class _Sized(Layer):
    def __init__(self, size: Sequence[int]):
        super().__init__()
        self.size = tuple(size)

    def _param(self, name, value, x):
        self.register_parameter(name, nn.Parameter(torch.full(
            self.size, float(value), device=x.device)))


class CAdd(_Sized):
    """ref: CAdd(size) — learnable per-element bias (``bias``)."""

    def build(self, x):
        self._param("bias", 0.0, x)

    def call(self, x, train, rng):
        return x + self.bias


class CMul(_Sized):
    """ref: CMul(size) — learnable per-element scale (``weight``)."""

    def build(self, x):
        self._param("weight", 1.0, x)

    def call(self, x, train, rng):
        return x * self.weight


class Scale(_Sized):
    """ref: Scale(size) — learnable elementwise affine (CMul then CAdd)."""

    def build(self, x):
        self._param("weight", 1.0, x)
        self._param("bias", 0.0, x)

    def call(self, x, train, rng):
        return x * self.weight + self.bias


class SReLU(Layer):
    """ref: SReLU — per-channel ``t_left`` (0), ``a_left`` (0.2),
    ``t_right`` (1), ``a_right`` (0.2)."""

    def build(self, x):
        c = x.shape[-1]
        for name, v in (("t_left", 0.0), ("a_left", 0.2), ("t_right", 1.0),
                        ("a_right", 0.2)):
            self.register_parameter(name, nn.Parameter(torch.full(
                (c,), v, device=x.device)))

    def call(self, x, train, rng):
        y = torch.where(x >= self.t_right,
                        self.t_right + self.a_right * (x - self.t_right), x)
        return torch.where(x <= self.t_left,
                           self.t_left + self.a_left * (x - self.t_left), y)


class LRN2D(Layer):
    """ref: LRN2D — local response normalization across channels (NHWC):
    ``x / (k + alpha/n * sum_{channel window} x^2) ** beta``."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5):
        super().__init__()
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, n

    def call(self, x, train, rng):
        half = self.n // 2
        sq = F.pad(x * x, (half, self.n - 1 - half))
        ssum = sq.unfold(-1, self.n, 1).sum(-1)
        return x / torch.pow(self.k + self.alpha / self.n * ssum, self.beta)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """jax.image's ``compute_weight_mat`` for the triangle kernel with
    antialiasing: ``[n_in, n_out]``."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device)
                + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = torch.clamp(1 - torch.abs(x), min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


class ResizeBilinear(Layer):
    """ref: ResizeBilinear(output_height, output_width) — NHWC resize as
    ``jax.image.resize(method="bilinear")`` (antialiased when it
    shrinks); ``align_corners=True`` raises, as the reference does."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False):
        super().__init__()
        self.output_height, self.output_width = output_height, output_width
        self.align_corners = align_corners

    def call(self, x, train, rng):
        if self.align_corners:
            raise ValueError(
                "align_corners=True is not supported (jax.image.resize "
                "uses half-pixel centers); re-export the model with "
                "align_corners=False")
        for axis, n in ((1, self.output_height), (2, self.output_width)):
            if x.shape[axis] != n:
                w = _resize_weights(x.shape[axis], n, x.device).to(x.dtype)
                x = torch.tensordot(x, w, dims=([axis], [0])).movedim(
                    -1, axis)
        return x


__all__ += [
    "Select", "Narrow", "Squeeze", "ExpandDim",
    "Exp", "Log", "Sqrt", "Square", "Abs", "Negative", "Power",
    "CAdd", "CMul", "Scale", "SReLU", "LRN2D", "ResizeBilinear",
]
