"""Image models: the ResNet family, ``SimpleCNN`` and the
``ImageClassifier`` entry, the port of ``analytics_zoo_tpu/models/image.py``
(the north star's config #2 trains ``resnet50``).

Inputs are NHWC ``[N, H, W, C]``, as in the reference.  Inside, each net
runs NCHW tensors in ``torch.channels_last`` memory (the NHWC input
permuted, which moves no byte), so that cuDNN takes its NHWC kernels for
the bf16 convs.  Every module names its parameters as the reference's
flax tree does (``stem``, ``stem_bn``, ``stage{i}_block{j}`` with
``conv1``/``bn1``... and ``proj``/``bn_proj``, ``head``; ``SimpleCNN``'s
``Conv_0``, ``Conv_1``, ``Dense_0``, ``Dense_1``), so
``models.layers.params_from_flax(variables["params"])`` and
``batch_stats_from_flax(variables["batch_stats"])`` load the
reference's weights and running statistics.

Cast points follow the reference: the input and the convs in ``dtype``
(bf16 by default), every BatchNorm in f32 (statistics, buffers and
output) and its output cast back to ``dtype``, the global average pool a
mean over H and W summed in f32 and rounded to ``dtype``, and an f32
head.  Padding is flax's: convs are ``"SAME"`` (one more row and column
at the end than at the start for a stride-2 conv of an even size), the
stem's 3x3 max pool is ``"SAME"`` with -inf, ``SimpleCNN``'s 2x2 pools
``"VALID"``, and ``SimpleCNN`` flattens NHWC, so its first Dense reads
(h, w, c) rows as the reference's kernel holds them.

A forward takes ``train``: batch statistics and updated running buffers
with it, the running statistics without (``nn.Module.training`` plays
no part); ``SimpleCNN``'s dropout (0.5) draws from ``rng`` in a training
forward, as ``models.transformer.dropout`` does.  A net takes its
input channels (and ``SimpleCNN`` its first Dense's width) from its
first input or from a ``load_state_dict``, as flax does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from analytics_zoo_tpu_torch.models.layers import (BatchNorm, Conv2d,
                                                   LazyConv2d, conv2d, dense,
                                                   make_dense, max_pool_same)
from analytics_zoo_tpu_torch.models.transformer import dropout, site_seed


def _conv(in_channels: Optional[int], out_channels: int, kernel_size: int,
          stride: int = 1, bias: bool = False) -> nn.Conv2d:
    if in_channels is None:
        return LazyConv2d(out_channels, kernel_size, stride, bias=bias)
    return Conv2d(in_channels, out_channels, kernel_size, stride, bias=bias)


class ResNetBlock(nn.Module):
    """Two 3x3 convs (the first strided) with BatchNorms, and a 1x1
    ``proj`` + ``bn_proj`` on the residual where the width or the stride
    changes (ResNet-18/34's block)."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(in_channels, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters)
        self.proj = self.bn_proj = None
        if in_channels != filters or stride != 1:
            self.proj = _conv(in_channels, filters, 1, stride)
            self.bn_proj = BatchNorm(filters)

    def forward(self, x, train: bool = False):
        dt = self.dtype
        y = torch.relu(self.bn1(conv2d(self.conv1, x, dt), train).to(dt))
        y = self.bn2(conv2d(self.conv2, y, dt), train).to(dt)
        if self.proj is not None:
            x = self.bn_proj(conv2d(self.proj, x, dt), train).to(dt)
        return torch.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (x4) with BatchNorms, and the
    residual's ``proj`` as in :class:`ResNetBlock` (ResNet-50/101/152's
    block)."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        out = filters * 4
        self.conv1 = _conv(in_channels, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = BatchNorm(filters)
        self.conv3 = _conv(filters, out, 1)
        self.bn3 = BatchNorm(out)
        self.proj = self.bn_proj = None
        if in_channels != out or stride != 1:
            self.proj = _conv(in_channels, out, 1, stride)
            self.bn_proj = BatchNorm(out)

    def forward(self, x, train: bool = False):
        dt = self.dtype
        y = torch.relu(self.bn1(conv2d(self.conv1, x, dt), train).to(dt))
        y = torch.relu(self.bn2(conv2d(self.conv2, y, dt), train).to(dt))
        y = self.bn3(conv2d(self.conv3, y, dt), train).to(dt)
        if self.proj is not None:
            x = self.bn_proj(conv2d(self.proj, x, dt), train).to(dt)
        return torch.relu(x + y)


class ResNet(nn.Module):
    """ResNet for NHWC inputs: basic blocks (18/34) or, with
    ``bottleneck=True``, bottleneck blocks (50/101/152).

    ``small_inputs``: a 3x3 stride-1 stem and no max pool (CIFAR-size
    images) instead of the 7x7 stride-2 stem and the 3x3 stride-2 pool.
    ``return_features``: the output of each stage (NHWC), not logits
    (and no ``head``, as in the reference's tree).
    """

    def __init__(self, num_classes: int,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), width: int = 64,
                 small_inputs: bool = False, bottleneck: bool = False,
                 return_features: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.small_inputs = dtype, small_inputs
        self.return_features = return_features
        self.stage_sizes = tuple(stage_sizes)
        self.stem = _conv(None, width, 3 if small_inputs else 7,
                          1 if small_inputs else 2)
        self.stem_bn = BatchNorm(width)
        block_cls = BottleneckBlock if bottleneck else ResNetBlock
        ch = width
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                block = block_cls(ch, width * 2 ** i, stride, dtype)
                setattr(self, f"stage{i}_block{j}", block)
                ch = width * 2 ** i * (4 if bottleneck else 1)
        self.head = None if return_features else make_dense(ch, num_classes)

    def forward(self, x, train: bool = False):
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)       # NCHW in channels_last
        x = conv2d(self.stem, x, dt)
        if not self.small_inputs:
            x = max_pool_same(x, 3, 2)
        x = torch.relu(self.stem_bn(x, train).to(dt))
        features = []
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                x = getattr(self, f"stage{i}_block{j}")(x, train)
            features.append(x)
        if self.return_features:
            return tuple(f.permute(0, 2, 3, 1) for f in features)
        x = x.mean((2, 3), dtype=torch.promote_types(dt, torch.float32)
                   ).to(dt)
        return dense(self.head, x.float(), torch.float32)


def resnet18(num_classes: int, **kw) -> ResNet:
    return ResNet(num_classes, stage_sizes=(2, 2, 2, 2), **kw)


def resnet34(num_classes: int, **kw) -> ResNet:
    return ResNet(num_classes, stage_sizes=(3, 4, 6, 3), **kw)


def resnet50(num_classes: int, **kw) -> ResNet:
    return ResNet(num_classes, stage_sizes=(3, 4, 6, 3), bottleneck=True,
                  **kw)


class SimpleCNN(nn.Module):
    """Two 3x3 convs with biases, each followed by ReLU and a 2x2 max
    pool, then Dense(128) + ReLU, dropout 0.5 and an f32 Dense head."""

    def __init__(self, num_classes: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = _conv(None, 32, 3, bias=True)
        self.Conv_1 = _conv(32, 64, 3, bias=True)
        self.Dense_0 = make_dense(None, 128)
        self.Dense_1 = make_dense(128, num_classes)

    def forward(self, x, train: bool = False, rng: Optional[int] = None):
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        for layer in (self.Conv_0, self.Conv_1):
            x = torch.relu(conv2d(layer, x, dt))
            x = torch.nn.functional.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(dense(self.Dense_0, x, dt))
        x = dropout(x, 0.5, site_seed(rng, 0), train)
        return dense(self.Dense_1, x, torch.float32)


_BACKBONES = {
    "simple": lambda n, **kw: SimpleCNN(n, **kw),
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
}


def ImageClassifier(num_classes: int, backbone: str = "resnet18",
                    **kw) -> nn.Module:
    """The reference's entry: a named backbone (``"simple"``,
    ``"resnet18"``, ``"resnet34"``, ``"resnet50"``) as a module; weights
    load through ``Estimator.load``, ``InferenceModel`` or
    ``params_from_flax``."""
    if backbone not in _BACKBONES:
        raise ValueError(
            f"unknown backbone {backbone!r}; known: {sorted(_BACKBONES)}")
    return _BACKBONES[backbone](num_classes, **kw)
