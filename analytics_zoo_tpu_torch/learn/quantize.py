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
axis split in two) by ``scale``.  ``"int8_mxu"`` (int8 matmuls) is not
ported: it waits for ``load_flax`` (ROADMAP Queue 1 item 8.4).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
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
