"""Weight-only quantization for inference.

The port of the weight-only half of ``analytics_zoo_tpu/learn/
quantize.py``: ``"int8"`` stores each large weight as symmetric int8
with one f32 scale per output channel (4x smaller than f32) and
dequantizes it for use; ``"bf16"`` casts weights to bfloat16 (2x).
Compute stays in the model's dtype, so no calibration data is needed.

The reference quantizes the leaves of a flax params tree: a leaf of two
or more dims and at least ``min_size`` elements, with its scale over
every axis but the last (its amax over the others, over 127).  The
port's ``state_dict`` lays some of those leaves out otherwise, so each
weight is quantized as the reference's leaf
(:func:`~analytics_zoo_tpu_torch.models.layers.flax_leaf` of the model
it belongs to) and brought back.  So:

- an ``nn.Linear`` weight ``[out, in]`` (a flax ``[in, out]`` kernel)
  has one scale per row;
- an embedding or position table ``[V, E]``, stored as flax stores it,
  one scale per column;
- an attention ``query``/``key``/``value`` weight ``[H*D, E]`` (a flax
  ``[E, H, D]`` kernel) one scale per head-dim index ``d``, shared by
  every head, and so has its bias ``[H*D]`` (a flax ``[H, D]`` leaf,
  quantized when it is large enough); ``attn_out`` ``[E, H*D]`` (``[H,
  D, E]``) one scale per row.

A quantized weight's int8 values and scales are the reference's after
the same transposition as ``params_from_flax``, and ``stats`` counts the
reference's bytes.  An int8 weight is a dict ``{"q": int8 tensor in the
port's layout, "scale": f32 tensor, "view": shape}``: :func:`dequantize`
multiplies ``q`` viewed as ``view`` (the axis that holds the leaf's last
axis split in two) by ``scale``.

``InferenceModel.load_flax`` quantizes the reference's own leaves as
they are (``model=None``), and only it takes ``"int8_mxu"``, for a
Keras-API model and for any other port module (the reference's
``int8_call``: :func:`int8_sites` picks the layers its interceptor
takes, and ``models.layers.int8_scope`` runs them as int8 for the length
of a forward): activations quantized per tensor at run time
(:func:`dyn_quant`: ``max|x| / 127`` floored at 1e-12, rounded half to
even, clipped to +-127), then int8 x int8 -> int32 products
(:func:`int8_matmul`) rescaled in f32 by ``x_scale * w_scale`` and
biased (:func:`int8_dense`, :func:`int8_conv`: the reference's
``_dense_int8`` and ``_conv_int8``).  On the card the product is
``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM; the reference's
``lax.dot_general(preferred_element_type=int32)`` is no Pallas kernel
either), its operands padded with zeros to what it takes (more than 16
rows, widths a multiple of 8) and the result sliced; on the CPU the
same product in float64, exact for int8 operands below 2^53.  A conv
multiplies its int8 patches (a strided view of the zero-padded input,
channel-last, one group at a time) by the kernel ``[*k * in, out]``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.models.layers import FlaxLeaf, flax_leaf


def _quant(w: torch.Tensor, leaf: FlaxLeaf) -> dict:
    """Symmetric int8 with the reference's scales: its amax over every
    axis but the last of the flax leaf."""
    w = w.detach()
    f = leaf.from_port(w.float() if w.dtype != torch.float64 else w)
    amax = f.abs().amax(dim=tuple(range(f.dim() - 1)), keepdim=True)
    # a tensor divisor: CUDA divides by a Python number as a product
    # with its reciprocal, one rounding off the reference's quotient
    scale = (torch.clamp(amax, min=1e-12) / amax.new_tensor(127.0)).to(
        torch.float32)
    q = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    # the port axis that holds the leaf's last axis, split as [G, last]
    j, last = leaf.last_axis, leaf.shape[-1]
    view = (tuple(w.shape[:j]) + (w.shape[j] // last, last)
            + tuple(w.shape[j + 1:]))
    shape = [last if i == j + 1 else 1 for i in range(len(view))]
    return {"q": leaf.to_port(q).contiguous(), "scale": scale.reshape(shape),
            "view": view}


def _is_q(v) -> bool:
    return isinstance(v, dict) and "q" in v


def quantize_params(params: Dict[str, torch.Tensor], mode: str = "int8",
                    min_size: int = 1024, *, model: Optional[nn.Module]
                    ) -> Tuple[dict, Dict[str, float]]:
    """Quantize ``params``, a ``state_dict`` of ``model`` (which tells
    how each tensor lays out the reference's leaf), or with ``model=None``
    tensors that are the reference's leaves as they are (an OpenVINO
    IR's ``params``).  Returns ``(new, stats)``: ``new`` has an int8 dict (``"int8"``) or a bf16 tensor
    (``"bf16"``) where the reference's leaf has two or more dims (and,
    for int8, at least ``min_size`` elements) and is floating, the rest
    as they were; ``stats`` the reference's ``weight_bytes_f32``,
    ``weight_bytes_quant`` and ``compression``."""
    before = sum(t.numel() * t.element_size() for t in params.values())
    new, after = {}, 0
    for name, t in params.items():
        leaf = flax_leaf(model, name) if model is not None else FlaxLeaf(
            tuple(t.shape), tuple(t.shape), tuple(range(t.dim())))
        big = len(leaf.shape) >= 2 and t.dtype in (torch.float32,
                                                   torch.float64)
        if mode == "bf16":
            new[name] = t.to(torch.bfloat16) if big else t
        elif mode == "int8":
            new[name] = _quant(t, leaf) \
                if big and t.numel() >= min_size else t
        else:
            raise ValueError(f"unknown quantize mode {mode!r} (int8|bf16)")
        v = new[name]
        after += (v["q"].numel() + 4 * v["scale"].numel()) if _is_q(v) \
            else v.numel() * v.element_size()
    return new, {"weight_bytes_f32": before, "weight_bytes_quant": after,
                 "compression": round(before / max(after, 1), 2)}


def dequantize(params: dict) -> Dict[str, torch.Tensor]:
    """The inverse: each int8 weight as ``q * scale`` in f32 (the
    reference's ``q.astype(f32) * scale``), each bf16 one as f32, the rest
    as they are.  A plain ``state_dict`` the model loads."""
    out = {}
    for name, v in params.items():
        if _is_q(v):
            q = v["q"]
            out[name] = (q.reshape(v["view"]).float()
                         * v["scale"]).reshape(q.shape)
        elif isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            out[name] = v.float()
        else:
            out[name] = v
    return out


# ---------------------------------------------------------------------------
# the reference's tree (load_flax) and int8 x int8 -> int32 execution
# ---------------------------------------------------------------------------


def dyn_quant(x: torch.Tensor):
    """The reference's ``_dyn_quant``: per-tensor ``max|x| / 127``
    floored at 1e-12 (a tensor divisor: CUDA would take a Python number
    as a reciprocal product), ``x / scale`` rounded half to even and
    clipped to +-127.  Returns ``(int8 x, f32 scale)``."""
    amax = torch.amax(torch.abs(x))
    xs = torch.clamp(amax / amax.new_tensor(127.0), min=1e-12)
    xq = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
    return xq, xs.to(torch.float32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` for int8 operands, exact, in int32.  On a
    CUDA tensor ``torch._int_mm`` (the int8 tensor cores; counted in
    ``int8_matmul.launches``) on operands padded with zeros to more than
    16 rows and widths a multiple of 8; on the CPU its plain version in
    float64."""
    if not a.is_cuda:
        return (a.double() @ b.double()).to(torch.int32)
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b = F.pad(b, (0, Np - N, 0, Kp - K))
    _launch_count.launches += 1
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:M, :N]


int8_matmul.launches = 0
# the count stays on this function when a caller wraps the module name
_launch_count = int8_matmul


def _rescale(acc: torch.Tensor, xs: torch.Tensor, q: dict, bias,
             dtype) -> torch.Tensor:
    """The reference's ``acc.astype(f32) * (xs * ws)`` (+ bias)."""
    y = acc.to(torch.float32) * (xs * q["scale"].reshape(-1))
    if bias is not None:
        y = y + bias
    return y.to(dtype) if dtype != torch.float32 else y


def int8_dense(x: torch.Tensor, q: dict, bias=None) -> torch.Tensor:
    """flax ``nn.Dense`` on the int8 path: ``q["q"]`` is the kernel ``[in,
    out]`` in int8, ``q["scale"]`` its per-output scales."""
    xq, xs = dyn_quant(x)
    K, N = q["q"].shape
    acc = int8_matmul(xq.reshape(-1, K), q["q"]).reshape(x.shape[:-1] + (N,))
    return _rescale(acc, xs, q, bias, x.dtype)


# int8 patch elements copied for one product (128 MiB): bounds im2col's
# memory for a large batch
_PATCH_ELEMS = 1 << 27


def conv_int32(xq: torch.Tensor, wq: torch.Tensor, strides, pads, dilation,
               groups: int = 1) -> torch.Tensor:
    """lax ``conv_general_dilated`` of int8 ``xq [B, *sp, C]`` (channels
    last) by the int8 kernel ``wq [*k, C / groups, out]`` with
    ``preferred_element_type=int32``: the patches of the zero-padded
    input (a strided view), one product a group, whole images at a time
    up to ``_PATCH_ELEMS`` patch elements."""
    nsp = xq.dim() - 2
    B, C = xq.shape[0], xq.shape[-1]
    kernel = tuple(wq.shape[:nsp])
    if any(lo or hi for lo, hi in pads):
        full = xq.new_zeros((B,) + tuple(
            n + lo + hi for n, (lo, hi) in zip(xq.shape[1:-1], pads)) + (C,))
        full[(slice(None),) + tuple(slice(lo, lo + n) for n, (lo, _) in
                                    zip(xq.shape[1:-1], pads))] = xq
        xq = full
    p = xq
    for d, (k, s, r) in enumerate(zip(kernel, strides, dilation)):
        p = p.unfold(1 + d, (k - 1) * r + 1, s)
        if r > 1:
            p = p[..., ::r]
    # [B, *out, C, *k] -> [B, *out, *k, C]
    p = p.permute((0,) + tuple(range(1, 1 + nsp))
                  + tuple(range(2 + nsp, 2 + 2 * nsp)) + (1 + nsp,))
    out_sp = tuple(p.shape[1:1 + nsp])
    cg, og = C // groups, wq.shape[-1] // groups
    kk = math.prod(kernel)
    p = p.reshape(B, -1, kk, groups, cg)
    w = wq.reshape(kk, cg, groups, og)
    rows = p.shape[1]
    per = max(1, _PATCH_ELEMS // max(1, rows * kk * cg))
    outs = []
    for b0 in range(0, B, per):
        part = p[b0:b0 + per]
        accs = [int8_matmul(part[:, :, :, g].reshape(-1, kk * cg),
                            w[:, :, g].reshape(kk * cg, og))
                for g in range(groups)]
        acc = accs[0] if groups == 1 else torch.cat(accs, dim=-1)
        outs.append(acc.reshape((part.shape[0],) + out_sp + (-1,)))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def int8_conv(x: torch.Tensor, q: dict, bias, strides, pads, dilation,
              groups: int = 1) -> torch.Tensor:
    """flax ``nn.Conv`` on the int8 path (channels-last ``x``; ``pads``
    the (low, high) of each spatial dim): the reference's
    ``_conv_int8``."""
    xq, xs = dyn_quant(x)
    acc = conv_int32(xq, q["q"], strides, pads, dilation, groups)
    return _rescale(acc, xs, q, bias, x.dtype)


# ---------------------------------------------------------------------------
# the reference's interceptor on any port module
# ---------------------------------------------------------------------------

def flax_module(model: nn.Module, path: Tuple[str, ...]) -> nn.Module:
    """The port module that computes the reference's module at ``path``
    (scope names, ``params`` stripped): the same names, the reference's
    ``layer_<i>`` as the port's ``layers.<i>``."""
    name = ".".join(f"layers.{p[6:]}" if re.fullmatch(r"layer_\d+", p)
                    else p for p in path)
    try:
        return model.get_submodule(name)
    except AttributeError:
        raise ValueError(f"no module of {type(model).__name__} computes "
                         f"the reference's {'/'.join(path)}") from None


def int8_sites(model: nn.Module, quantized: dict) -> Dict[nn.Module, dict]:
    """The layers the reference's ``int8_call`` takes, keyed by flax path
    as its ``_qleaf_paths``: each quantized ``kernel`` (``quantized``
    maps a leaf's path, ``("params", *module path, "kernel")``, to its
    int8 dict) of a plain ``nn.Dense`` (a 2-D kernel, an ``nn.Linear``
    here) or an ``nn.Conv`` (1-3 spatial dims, a conv here).  A
    ``DenseGeneral`` (the attention projections: 3-D kernels), an
    ``Embed`` table (tied heads read it through ``attend``) and every
    other leaf stay on the dequantized float weights."""
    out = {}
    for path, q in quantized.items():
        if path[0] != "params" or path[-1] != "kernel":
            continue
        mod = flax_module(model, path[1:-1])
        nd = q["q"].dim()
        if (nd == 2 and isinstance(mod, nn.Linear)) or (
                nd - 2 in (1, 2, 3)
                and isinstance(mod, nn.modules.conv._ConvNd)
                and not mod.transposed and mod.padding_mode == "zeros"):
            out[mod] = q
    return out
