"""Full attention, and sequence-parallel attention over the ``sp`` axis:
the port of ``analytics_zoo_tpu/parallel/ring_attention.py``.

The reference runs its ring and ulysses paths inside ``shard_map`` on
global arrays; the port runs one process a rank, so each function here
takes this rank's operands as they are (q, k and v ``[B, T/sp, H, D]``:
its rows, its sequence chunk, its heads) and runs the exchanges itself
through ``parallel.collectives``, with gradients:

- :func:`ring_attention`: K/V and their key mask rotate sp-1 times
  around the ring (:func:`~analytics_zoo_tpu_torch.parallel.collectives.
  shift`, whose backward is the reverse shift), each chunk's block
  merged into an online-softmax accumulator; the causal mask compares
  global positions (``src * T + arange(T)``);
- :func:`ulysses_attention`: two all-to-alls exchange the sequence chunk
  for a head chunk (the heads must divide sp), full attention runs on
  the whole sequence, and the inverse exchange brings the chunk back;
- :func:`ring_self_attention`: picks the strategy, and is
  :func:`full_attention` on a mesh without an sp axis.

Each chunk is computed in plain PyTorch (``_chunk_attn``), as the
reference computes it with XLA (it wrote no Pallas kernel for it).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.parallel import collectives as cc


def _chunk_attn(q, k, v, *, scale, mask):
    """One Q-chunk x K-chunk block with f32 accumulators: q ``[B, Tq, H,
    D]``, k/v ``[B, Tk, H, D]``, mask bool broadcastable to ``[B, Tq,
    Tk]`` (or None).  Returns the row maxima ``[B, H, Tq]`` (0 for a
    fully masked row), the exp sums ``[B, H, Tq]`` and the unnormalised
    output ``[B, Tq, H, D]`` (f32)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        mask = torch.broadcast_to(mask, logits.shape[:1] + logits.shape[2:])
        logits = logits.masked_fill(~mask[:, None], float("-inf"))
    m = logits.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe[..., None])
    if mask is not None:
        p = p.masked_fill(~mask[:, None], 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m_safe, l, o


def _merge(m1, l1, o1, m2, l2, o2):
    """Two online-softmax partial results merged."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    o = o1 * a1.transpose(1, 2)[..., None] + o2 * a2.transpose(1, 2)[..., None]
    return m, l, o


def _finish(l, o, dtype):
    denom = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (o / denom).to(dtype)


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
    _, l, o = _chunk_attn(q, k, v, scale=scale, mask=mask)
    return _finish(l, o, q.dtype)


def ring_attention(q, k, v, kv_mask=None, *, line: cc.Line,
                   causal: bool = False, scale: Optional[float] = None):
    """Exact attention over a sequence split along ``line`` (the sp
    axis): this rank's q, k, v ``[B, T, H, D]`` (its chunk, T = the
    global length / sp) and key mask ``[B, T]`` bool.  K/V and the mask
    rotate sp-1 times; returns this rank's ``[B, T, H, D]``."""
    sp, my = line.size, line.index
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    q_pos = my * T + torch.arange(T, device=q.device)

    def attend(i, k_cur, v_cur, mask_cur, acc):
        src = (my - i) % sp                 # whose chunk this rank holds
        mask = None
        if causal:
            k_pos = src * T + torch.arange(T, device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :])[None]
        if mask_cur is not None:
            kvm = mask_cur[:, None, :]
            mask = kvm if mask is None else mask & kvm
        part = _chunk_attn(q, k_cur, v_cur, scale=scale, mask=mask)
        return part if acc is None else _merge(*acc, *part)

    mask_cur = None if kv_mask is None else kv_mask.to(torch.bool)
    k_cur, v_cur, acc = k, v, None
    for i in range(sp):
        acc = attend(i, k_cur, v_cur, mask_cur, acc)
        if i == sp - 1:
            break                   # the last chunk needs no rotation
        k_cur, v_cur = cc.shift(k_cur, line), cc.shift(v_cur, line)
        if mask_cur is not None:
            with torch.no_grad():
                mask_cur = cc.shift(mask_cur.to(torch.uint8),
                                    line).to(torch.bool)
    _, l, o = acc
    return _finish(l, o, q.dtype)


def ulysses_attention(q, k, v, kv_mask=None, *, line: cc.Line,
                      causal: bool = False):
    """All-to-all sequence parallelism over ``line``: this rank's
    ``[B, T/sp, H, D]`` chunk exchanged for the whole sequence of H/sp
    heads, full attention there, and the inverse exchange back.  The
    heads must divide sp (the reference's ``ValueError`` otherwise)."""
    sp = line.size
    if sp == 1:
        return full_attention(q, k, v, kv_mask, causal=causal)
    H = q.shape[2]
    if H % sp:
        raise ValueError(
            f"ulysses needs heads ({H}) divisible by the sp axis ({sp}); "
            "use the ring strategy for this mesh")
    qg, kg, vg = (cc.all_to_all(t, line, 2, 1) for t in (q, k, v))
    mask = None
    if kv_mask is not None:
        with torch.no_grad():
            mask = cc.gather_seq(kv_mask.to(torch.uint8), line,
                                 1).to(torch.bool)
    o = full_attention(qg, kg, vg, mask, causal=causal)
    return cc.all_to_all(o, line, 1, 2)


def ring_self_attention(q, k, v, mesh, kv_mask=None, *,
                        causal: bool = False, seq_axis: str = "sp",
                        strategy: str = "ring"):
    """Exact attention for this rank's q, k, v ``[B, T/sp, H, D]`` (its
    rows, sequence chunk and heads of the global arrays) on ``mesh``:
    ``strategy`` ``"ring"`` (K/V rotate; any head count) or
    ``"ulysses"`` (two all-to-alls; heads divisible by sp).  Without an
    sp axis above 1, full attention on the operands as they are.  An
    unknown strategy raises before anything else, so a typo fails on a
    mesh without sp too."""
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp strategy {strategy!r} "
                         "(expected 'ring' or 'ulysses')")
    line = cc.Line.of(mesh, seq_axis)
    if line.size == 1:
        return full_attention(q, k, v, kv_mask, causal=causal)
    fn = ulysses_attention if strategy == "ulysses" else ring_attention
    return fn(q, k, v, kv_mask, line=line, causal=causal)
