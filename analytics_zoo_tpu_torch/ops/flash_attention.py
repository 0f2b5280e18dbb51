"""Flash and paged attention, in PyTorch and CUDA.

The port of ``analytics_zoo_tpu/ops/flash_attention.py``.

Dense half:

- :func:`flash_attention` is fused attention over ``[B, T, H, D]``
  operands with an optional key-padding mask and causal masking.  On a
  CUDA tensor it launches the hand-written CUDA kernel
  (``csrc/flash_attention.cu``, :func:`flash_attention_fused`); on a CPU
  tensor it runs the plain version, :func:`flash_attention_ref`.
- Its gradient (:class:`_FlashAttention`, the reference's custom VJP)
  launches the two hand-written backward kernels
  (``csrc/flash_attention_bwd.cu``, :func:`flash_attention_bwd_fused`)
  on a CUDA tensor and runs their plain version,
  :func:`flash_attention_bwd_ref`, on a CPU tensor.

Paged half.  The pool layout is the reference's, HEAD-MAJOR
``[N, KH, bs, D]`` (physical block, kv head, position in block, head
dim), so the block tables the serving engine keeps mean the same thing
in both packages.

- :func:`paged_kv_update` scatters new K/V rows through the block
  tables, quantizing on write for int8 :class:`QuantKV` pools.  It
  updates the pools IN PLACE: this replaces the reference's pure scatter
  whose result the JAX engine donates back into the same buffers.
- :func:`paged_attention` reads them.  ``kernel="fused"`` launches the
  hand-written CUDA kernel (``csrc/paged_attention.cu``) on a CUDA
  tensor and runs the plain version on a CPU tensor;
  ``kernel="gather"`` always runs the plain version,
  :func:`paged_attention_ref`, the reference's ``"gather"`` path.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp/where NaN-free

KV_SCALE_DTYPE = torch.bfloat16   # per-(block, position, head) int8 scales


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _masked_scores(q, k, kv_mask, causal, scale):
    """f32 scores ``scale * q.k`` ``[B, H, Tq, Tk]``, ``NEG_INF`` where
    ``kv_mask`` is False or, ``causal``, where key t > query i."""
    Tq, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.bool)[:, None, None, :]
    if causal:
        tri = (torch.arange(Tq, device=q.device)[:, None]
               >= torch.arange(Tk, device=q.device)[None, :])
        mask = tri if mask is None else mask & tri
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_ref(q, k, v, kv_mask=None, *, causal: bool,
                        scale: Optional[float] = None):
    """The plain version of the dense flash forward: the function the
    reference's ``_fwd_kernel`` computes, in one pass.

    q: ``[B, Tq, H, D]``; k/v: ``[B, Tk, H, D]``; kv_mask: ``[B, Tk]``
    bool, True = the key attends.  ``causal`` masks key t for query i
    when ``t > i``.  Scores are f32 (``scale * q.k``), masked keys get
    ``NEG_INF``; a row with nothing live subtracts 0 instead of its max
    (the kernel's ``m_sub`` guard), so its ``exp`` underflows to 0.  p is
    rounded to v's dtype before ``p @ v``, which accumulates in f32.

    Returns ``(o, lse)``: o ``[B, Tq, H, D]`` in q's dtype, ``acc / l``,
    0 for a fully masked row; lse f32 ``[B*H, Tq]`` (row ``b*H + h``),
    ``m + log(l)``, or ``+1e30`` where ``l == 0``."""
    B, Tq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = _masked_scores(q, k, kv_mask, causal, scale)
    m = s.amax(dim=-1, keepdim=True)                    # [B, H, Tq, 1]
    m_sub = torch.where(m > NEG_INF * 0.5, m, torch.zeros_like(m))
    p = torch.exp(s - m_sub)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = (acc / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l_safe),
                      torch.full_like(l, -NEG_INF))
    return o, lse.reshape(B * H, Tq)


def _check_dense(name, q, k, v, kv_mask, like_q=()):
    """Raise on dense-attention operands the CUDA kernels do not take:
    q ``[B, Tq, H, D]`` and k, v ``[B, Tk, H, D]`` contiguous on one CUDA
    device in one dtype (f32 or bf16), D in (64, 128), kv_mask a
    contiguous bool ``[B, Tk]``; ``like_q`` tensors must match q."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be [B, T, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if tuple(k.shape) != (B, Tk, H, D) or tuple(v.shape) != (B, Tk, H, D):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for t in like_q:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: o and dO must match q "
                             f"{tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    operands = [q, k, v, *like_q] + ([] if kv_mask is None else [kv_mask])
    for t in operands:
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} needs every operand on one CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous operands")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype} not "
                         f"supported (one of f32, bf16 for q, k and v)")
    if D not in (64, 128):
        raise ValueError(f"head dim {D} not supported (64, 128)")
    if kv_mask is not None and (kv_mask.dtype != torch.bool
                                or tuple(kv_mask.shape) != (B, Tk)):
        raise ValueError(f"kv_mask must be bool [B, Tk] = {(B, Tk)}, got "
                         f"{kv_mask.dtype} {tuple(kv_mask.shape)}")


def flash_attention_fused(q, k, v, kv_mask=None, *, causal: bool,
                          scale: Optional[float] = None):
    """Launch the CUDA flash-attention forward kernel (CUDA tensors
    only).  Same contract as :func:`flash_attention_ref`.  Takes q, k
    and v contiguous in one dtype, f32 or bf16, head dims 64 and 128,
    kv_mask a contiguous bool ``[B, Tk]``; raises on anything else.
    ``flash_attention_fused.launches`` counts the launches."""
    from analytics_zoo_tpu_torch.ops import _build

    _check_dense("flash_attention_fused", q, k, v, kv_mask)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    rc = _build.load("flash_attention").flash_attention_fwd(
        _ptr(q), _ptr(k), _ptr(v),
        ctypes.c_void_p(0) if kv_mask is None else _ptr(kv_mask),
        _ptr(o), _ptr(lse), int(q.dtype == torch.bfloat16),
        B, Tq, Tk, H, D, int(bool(causal)), float(scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with "
                           f"CUDA error {rc}")
    flash_attention_fused.launches += 1
    return o, lse


flash_attention_fused.launches = 0


def flash_attention_bwd_ref(q, k, v, kv_mask, o, lse, do, *, causal: bool,
                            scale: Optional[float] = None):
    """The plain version of the flash backward: the function the
    reference's ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` compute
    together, in one pass.

    q, o, do: ``[B, Tq, H, D]``; k, v: ``[B, Tk, H, D]``; kv_mask and
    causal as in :func:`flash_attention_ref`; lse: the forward's f32
    ``[B*H, Tq]``.  Recomputes the masked f32 scores s and
    ``p = exp(s - lse)`` (0 for masked keys and for a fully masked row,
    whose lse is +1e30), ``delta = rowsum(do * o)`` in f32,
    ``dp = do.v`` and ``ds = p * (dp - delta)``, with the kernels' cast
    points: p rounded to do's dtype before ``p^T.do``, ds to k's dtype
    before ``ds.k`` and to q's dtype before ``ds^T.q``, every product
    accumulated in f32.  Returns ``(dq, dk, dv)`` in q's, k's and v's
    dtypes: ``dq = scale * ds.k``, ``dk = scale * ds^T.q``,
    ``dv = p^T.do``."""
    B, Tq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = _masked_scores(q, k, kv_mask, causal, scale)
    p = torch.exp(s - lse.reshape(B, H, Tq, 1))
    delta = flash_attention_bwd_delta(o, do).reshape(B, H, Tq, 1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(),
                      do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_launch(kernel, q, k, v, kv_mask, do, lse, delta,
                               outs, causal, scale):
    """Launch ONE backward kernel, ``kernel`` ("dq": outs ``(dq,)``;
    "dkv": outs ``(dk, dv)``), into preallocated outputs; raises on a
    refused launch.  :func:`flash_attention_bwd_fused` checks the
    operands and makes both launches; this is the same launch, for
    timing one kernel alone.  It does not check its operands and does
    not count."""
    from analytics_zoo_tpu_torch.ops import _build

    B, Tq, H, D = q.shape
    lib = _build.load("flash_attention_bwd")
    rc = getattr(lib, f"flash_attention_bwd_{kernel}")(
        _ptr(q), _ptr(k), _ptr(v),
        ctypes.c_void_p(0) if kv_mask is None else _ptr(kv_mask),
        _ptr(do), _ptr(lse), _ptr(delta), *map(_ptr, outs),
        int(q.dtype == torch.bfloat16), B, Tq, k.shape[1], H, D,
        int(bool(causal)), float(scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd {kernel} kernel launch "
                           f"failed with CUDA error {rc}")


def flash_attention_bwd_delta(o, do):
    """``delta = rowsum(do * o)`` in f32 as ``[B*H, Tq]`` (row b*H + h),
    the layout of lse: computed outside the kernels, as the reference
    does, and read by both of them."""
    B, Tq, H, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
        B * H, Tq).contiguous()


def flash_attention_bwd_fused(q, k, v, kv_mask, o, lse, do, *,
                              causal: bool, scale: Optional[float] = None):
    """Launch the CUDA flash backward, the dq kernel then the dk/dv
    kernel (CUDA tensors only).  Same contract as
    :func:`flash_attention_bwd_ref`.  Takes what
    :func:`flash_attention_fused` takes, with o and do of q's shape and
    dtype and lse a contiguous f32 ``[B*H, Tq]``; raises on anything
    else.  ``flash_attention_bwd_fused.launches`` counts the calls, one
    call being both kernels."""
    _check_dense("flash_attention_bwd_fused", q, k, v, kv_mask,
                 like_q=(o, do))
    B, Tq, H, D = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B * H, Tq) \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 [B*H, Tq] = "
                         f"{(B * H, Tq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = flash_attention_bwd_delta(o, do)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = (q, k, v, kv_mask, do, lse, delta)
    flash_attention_bwd_launch("dq", *args, (dq,), causal, scale)
    flash_attention_bwd_launch("dkv", *args, (dk, dv), causal, scale)
    flash_attention_bwd_fused.launches += 1
    return dq, dk, dv


flash_attention_bwd_fused.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the reference's ``_flash_fn``
    custom VJP.  The forward keeps q, k, v, the mask, o and lse; the
    backward recomputes p from lse.  A CUDA tensor runs the CUDA kernels
    both ways, a CPU tensor their plain versions; no gradient flows to
    the mask."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        fwd = flash_attention_ref if q.device.type == "cpu" \
            else flash_attention_fused
        o, lse = fwd(q, k, v, kv_mask, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        # autograd often hands over a strided dO; the kernels read the
        # model layout densely
        do = do.contiguous()
        bwd = flash_attention_bwd_ref if q.device.type == "cpu" \
            else flash_attention_bwd_fused
        dq, dk, dv = bwd(q, k, v, kv_mask, o, lse, do, causal=ctx.causal,
                         scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, kv_mask=None, *, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512):
    """Fused attention over ``[B, T, H, D]`` operands; returns o
    ``[B, Tq, H, D]`` in q's dtype.

    kv_mask: ``[B, Tk]`` bool, True = key position attends (padding
    mask); ``causal`` adds the autoregressive mask.  On a CUDA tensor
    this launches the CUDA kernel, on a CPU tensor it runs
    :func:`flash_attention_ref`.  ``block_q``/``block_k`` are accepted
    for signature parity with the reference, whose TPU tiles they set;
    the CUDA kernels pick their own tile (tiling does not change the
    function), so they are not read.

    With grad mode on and an input that requires grad the call goes
    through :class:`_FlashAttention`, whose backward launches the CUDA
    backward kernels on a CUDA tensor (their plain version on a CPU
    tensor); no gradient flows to ``kv_mask``."""
    del block_q, block_k
    if kv_mask is not None and q.device.type != "cpu":
        kv_mask = kv_mask.to(torch.bool).contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kv_mask, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_mask, causal=causal,
                                   scale=scale)[0]
    return flash_attention_fused(q, k, v, kv_mask, causal=causal,
                                 scale=scale)[0]


class QuantKV:
    """int8 KV block arena + per-(block, position, kv-head) scales.

    ``data``: int8 ``[..., N, KH, bs, D]`` (leading dims free — the
    engine stacks a layers axis in front); ``scale``: ``data.shape[:-1]``
    in :data:`KV_SCALE_DTYPE`.  One scale per stored K/V row (amax over
    D / 127) keeps the scatter in :func:`paged_kv_update` local — a
    write never has to re-read or re-scale the rest of its block.
    ``__getitem__`` returns views, so ``pools[i]`` of a stacked pool
    updates the stacked storage in place.
    """

    __slots__ = ("data", "scale")

    def __init__(self, data, scale):
        self.data, self.scale = data, scale

    def __getitem__(self, idx):
        return QuantKV(self.data[idx], self.scale[idx])


def quantize_kv(x, scale_dtype=KV_SCALE_DTYPE):
    """Symmetric per-row int8 quantization over the LAST axis.

    Returns ``(q int8 x.shape, scale scale_dtype x.shape[:-1])`` with
    ``x ~= q * scale``.  The scale is rounded to its STORAGE dtype
    before the divide, so :func:`dequantize_kv` reproduces exactly what
    any reader of the stored (data, scale) pair computes.  All-zero rows
    quantize to (0, scale 1).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does, so both packages store identical bytes."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(scale_dtype)
    sf = scale.float()[..., None]
    q = torch.clamp(torch.round(xf / sf), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_kv(data, scale):
    """Inverse of :func:`quantize_kv`: f32 ``data * scale[..., None]``."""
    return data.float() * scale.float()[..., None]


def _paged_scatter_index(tables, pos, S, bs, N, limit):
    """(physical block, offset) per written position, drop-encoded.

    Logical position p of row b maps to (``tables[b, p // bs]``,
    ``p % bs``); block indices past the table width clamp to the last
    column (the allocator keeps unallocated entries at the sink block),
    and positions ``>= limit[b]`` get the out-of-range block id N, which
    :func:`paged_kv_update` masks out before it writes."""
    M = tables.shape[1]
    p = pos[:, None].long() + torch.arange(S, device=pos.device)[None, :]
    blk = torch.clamp(p // bs, max=M - 1)
    phys = torch.gather(tables.long(), 1, blk)              # [B, S]
    if limit is not None:
        phys = torch.where(p < limit[:, None].long(), phys,
                           torch.full_like(phys, N))
    return phys, p % bs


def paged_kv_update(pool_k, pool_v, tables, pos, new_k, new_v,
                    limit=None) -> None:
    """Scatter S new K/V rows per batch row into a block-pool cache,
    IN PLACE.

    pool_k/pool_v: ``[N, KH, bs, D]`` or a :class:`QuantKV` pair of the
    same geometry, in which case the new rows are quantized on write and
    both the int8 data and the per-row scales scatter through the same
    index.  tables: ``[B, M]`` int32; pos: ``[B]`` int32 — row b's
    tokens land at logical positions ``pos[b] .. pos[b]+S-1``.
    new_k/new_v: ``[B, S, KH, D]``.

    Positions whose logical block index exceeds the table width clamp
    to the last table entry, which the allocator keeps pointed at the
    sink block for anything unallocated.  ``limit`` (``[B]`` int32,
    optional) DROPS row b's writes at positions ``>= limit[b]``.  The
    reference drops them with an out-of-range scatter index
    (``mode="drop"``); PyTorch has no such mode, and on CUDA an
    out-of-range index is a device assert, so the dropped writes are
    masked out here before the scatter.
    """
    quant = isinstance(pool_k, QuantKV)
    N, KH, bs, D = (pool_k.data if quant else pool_k).shape
    S = new_k.shape[1]
    phys, off = _paged_scatter_index(tables, pos, S, bs, N, limit)
    if limit is not None:
        keep = phys < N
        phys, off = phys[keep], off[keep]
        new_k, new_v = new_k[keep], new_v[keep]     # [n, KH, D]
    # advanced indices (phys, off) straddle the KH slice, so the
    # indexed dims lead: the target is [..., KH, D], new_k's own layout
    if quant:
        qk, sk = quantize_kv(new_k, pool_k.scale.dtype)
        qv, sv = quantize_kv(new_v, pool_v.scale.dtype)
        pool_k.data[phys, :, off] = qk
        pool_k.scale[phys, :, off] = sk
        pool_v.data[phys, :, off] = qv
        pool_v.scale[phys, :, off] = sv
        return
    pool_k[phys, :, off] = new_k.to(pool_k.dtype)
    pool_v[phys, :, off] = new_v.to(pool_v.dtype)


def paged_attention_ref(q, pool_k, pool_v, tables, pos):
    """The plain version of the paged read: the reference's ``"gather"``
    path.  One materialised ``[B, M*bs, KH, D]`` gather per pool (int8
    pools dequantize the gathered rows), then :func:`cache_attention`:
    the masked einsum-softmax with f32 accumulation, the attention
    weights rounded to the pool dtype before the ``p @ v`` product, as
    the reference does.

    q: ``[B, S, H, D]``; query s of row b attends logical positions
    ``<= pos[b] + s``.  Returns f32 ``[B, S, H, D]``."""
    B, S, H, D = q.shape
    quant = isinstance(pool_k, QuantKV)
    N, KH, bs, _ = (pool_k.data if quant else pool_k).shape
    M = tables.shape[1]
    L = M * bs
    idx = tables.long()

    def gathered(pool):
        # [B, M] tables -> [B, L, KH, D] rows: logical position l of
        # row b is pool[tables[b, l // bs], :, l % bs]
        if isinstance(pool, QuantKV):
            cache = dequantize_kv(pool.data[idx], pool.scale[idx])
        else:
            cache = pool[idx]                           # [B, M, KH, bs, D]
        return cache.movedim(2, 3).reshape(B, L, KH, D)

    p = pos[:, None].long() + torch.arange(S, device=q.device)[None, :]
    visible = (torch.arange(L, device=q.device)[None, None, :]
               <= p[:, :, None])[:, None, None, :, :]   # [B,1,1,S,L]
    return cache_attention(q, gathered(pool_k), gathered(pool_v), visible)


def cache_attention(q, cache_k, cache_v, visible):
    """Grouped attention of S query tokens per row against a whole
    ``[B, L, KH, D]`` cache, in plain PyTorch: the reference's cached
    decode math, shared by the slot-arena decode and the paged gather.
    q: ``[B, S, H, D]``; ``visible``: bool, broadcastable to
    ``[B, 1, 1, S, L]``.  Scores ``q.k / sqrt(D)`` in f32 (f32 operands =
    the reference's ``preferred_element_type=f32``: bf16 products are
    exact in f32), ``-inf`` where not visible, softmax; the weights are
    cast to the cache dtype before ``p @ v`` with f32 accumulation.
    Each kv head serves its G query heads without an expanded copy of
    the cache.  Returns f32 ``[B, S, H, D]``."""
    B, S, H, D = q.shape
    KH = cache_k.shape[2]
    if H % KH:
        raise ValueError(f"query heads {H} not a multiple of KV heads "
                         f"{KH}")
    qg = q.reshape(B, S, KH, H // KH, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          cache_k.float()) * (1.0 / math.sqrt(D))
    logits = logits.masked_fill(~visible, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.to(cache_v.dtype).float(),
                     cache_v.float())
    return o.reshape(B, S, H, D)


_KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_attention_fused(q, pool_k, pool_v, tables, pos):
    """Launch the CUDA paged-attention kernel (CUDA tensors only).

    Same contract as :func:`paged_attention_ref`.  Takes q in f32 or
    bf16, pools in f32, bf16 or int8 (:class:`QuantKV` with bf16
    scales), head dims 64 and 128, block sizes 1-64; raises on anything
    else.  ``paged_attention_fused.launches`` counts the launches."""
    from analytics_zoo_tpu_torch.ops import _build

    quant = isinstance(pool_k, QuantKV)
    kd = pool_k.data if quant else pool_k
    vd = pool_v.data if quant else pool_v
    if q.dim() != 4 or kd.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D] and pools [N, KH, bs, "
                         f"D], got {tuple(q.shape)} and "
                         f"{tuple(kd.shape)}")
    B, S, H, D = q.shape
    N, KH, bs, Dk = kd.shape
    M = tables.shape[-1]
    operands = [q, kd, vd, tables, pos]
    if quant:
        operands += [pool_k.scale, pool_v.scale]
    for t in operands:
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"paged_attention_fused needs every operand "
                             f"on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention_fused needs contiguous "
                             "operands")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} not supported (f32, bf16)")
    if kd.dtype not in _KV_KINDS or vd.dtype != kd.dtype \
            or quant != (kd.dtype == torch.int8):
        raise ValueError(f"pool dtypes {kd.dtype}/{vd.dtype} not "
                         f"supported (f32, bf16, or int8 QuantKV)")
    if quant and (pool_k.scale.dtype != KV_SCALE_DTYPE
                  or pool_v.scale.dtype != KV_SCALE_DTYPE
                  or tuple(pool_k.scale.shape) != (N, KH, bs)
                  or tuple(pool_v.scale.shape) != (N, KH, bs)):
        raise ValueError("int8 pool scales must be bf16 [N, KH, bs]")
    if tuple(vd.shape) != tuple(kd.shape) or Dk != D:
        raise ValueError(f"pool shapes {tuple(kd.shape)}/"
                         f"{tuple(vd.shape)} do not match q's head dim "
                         f"{D}")
    if D not in (64, 128) or not 1 <= bs <= 64:
        raise ValueError(f"head dim {D} / block size {bs} not supported "
                         f"(D in (64, 128), bs in [1, 64])")
    if H % KH:
        raise ValueError(f"query heads {H} not a multiple of KV heads "
                         f"{KH}")
    if tables.dtype != torch.int32 or tuple(tables.shape) != (B, M) \
            or pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError("tables must be int32 [B, M] and pos int32 [B]")
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    none = ctypes.c_void_p(0)
    rc = _build.load("paged_attention").paged_attention_fwd(
        _ptr(q), int(q.dtype == torch.bfloat16),
        _ptr(kd), _ptr(vd),
        _ptr(pool_k.scale) if quant else none,
        _ptr(pool_v.scale) if quant else none,
        _KV_KINDS[kd.dtype], _ptr(tables), _ptr(pos), _ptr(out),
        B, S, H, KH, D, bs, M, _stream(q))
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed with "
                           f"CUDA error {rc}")
    paged_attention_fused.launches += 1
    return out


paged_attention_fused.launches = 0


def paged_attention(q, pool_k, pool_v, tables, pos, *,
                    kernel: str = "fused"):
    """Block-causal attention of S query tokens per row against a PAGED
    KV cache.  q: ``[B, S, H, D]``; pools ``[N, KH, bs, D]`` (or
    :class:`QuantKV`); tables ``[B, M]`` int32; pos ``[B]`` int32 —
    query s of row b attends logical positions ``<= pos[b] + s``.
    ``KH <= H`` is grouped-query attention: kv head h serves query heads
    ``h*G .. h*G+G-1``.  The table may be SLICED to any width that
    covers ``pos[b] + S - 1``.  Output is f32 ``[B, S, H, D]``.

    ``kernel="fused"`` launches the CUDA kernel for a CUDA tensor and
    runs :func:`paged_attention_ref` for a CPU tensor;
    ``kernel="gather"`` always runs :func:`paged_attention_ref`."""
    if kernel not in ("gather", "fused"):
        raise ValueError(f"kernel must be 'gather' or 'fused', got "
                         f"{kernel!r}")
    if kernel == "gather" or q.device.type == "cpu":
        return paged_attention_ref(q, pool_k, pool_v, tables, pos)
    return paged_attention_fused(q, pool_k, pool_v, tables, pos)
