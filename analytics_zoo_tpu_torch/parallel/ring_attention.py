"""Single-device full attention: the plain branch of the attention
dispatch.

The port of ``full_attention`` from
``analytics_zoo_tpu/parallel/ring_attention.py`` (with the one
``_chunk_attn`` block it runs), in plain PyTorch as the reference
computes it with XLA.  The sequence-parallel ring and ulysses paths need
a mesh and are not ported yet (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def full_attention(q, k, v, kv_mask=None, *, causal: bool = False,
                   scale: Optional[float] = None):
    """Reference attention over ``[B, T, H, D]`` operands (q, k and v of
    one length T).  kv_mask: ``[B, T]`` bool, True = position may be
    attended to.  Scores in f32 (``q.k * scale``), masked with ``-inf``;
    a fully masked row takes max 0 and outputs 0.  The weights are
    rounded to v's dtype before ``p @ v``, which accumulates in f32; the
    result is cast to q's dtype."""
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    mask = None
    if causal:
        pos = torch.arange(T, device=q.device)
        mask = (pos[:, None] >= pos[None, :])[None]           # [1, T, T]
    if kv_mask is not None:
        kvm = kv_mask.to(torch.bool)[:, None, :]               # [B, 1, T]
        mask = kvm if mask is None else mask & kvm
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe)
    if mask is not None:
        p = p.masked_fill(~mask[:, None], 0.0)
    l = p.sum(dim=-1)                                          # [B, H, T]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    denom = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (o / denom).to(q.dtype)
