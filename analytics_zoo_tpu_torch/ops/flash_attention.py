"""Paged attention over a block-pool KV cache, in PyTorch and CUDA.

The port of the paged half of ``analytics_zoo_tpu/ops/flash_attention.py``.
The pool layout is the reference's, HEAD-MAJOR ``[N, KH, bs, D]``
(physical block, kv head, position in block, head dim), so the block
tables the serving engine keeps mean the same thing in both packages.

- :func:`paged_kv_update` scatters new K/V rows through the block
  tables, quantizing on write for int8 :class:`QuantKV` pools.  It
  updates the pools IN PLACE: this replaces the reference's pure scatter
  whose result the JAX engine donates back into the same buffers.
- :func:`paged_attention` reads them.  ``kernel="fused"`` launches the
  hand-written CUDA kernel (``csrc/paged_attention.cu``) on a CUDA
  tensor and runs the plain version on a CPU tensor;
  ``kernel="gather"`` always runs the plain version,
  :func:`paged_attention_ref`, the reference's ``"gather"`` path.

The dense flash kernels of the reference module (forward and backward)
are not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp/where NaN-free

KV_SCALE_DTYPE = torch.bfloat16   # per-(block, position, head) int8 scales


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
    pools dequantize the gathered rows), then the masked einsum-softmax
    with f32 accumulation.  The attention weights are rounded to the
    pool dtype before the ``p @ v`` product, as the reference does.

    q: ``[B, S, H, D]``; query s of row b attends logical positions
    ``<= pos[b] + s``.  Returns f32 ``[B, S, H, D]``."""
    B, S, H, D = q.shape
    quant = isinstance(pool_k, QuantKV)
    N, KH, bs, _ = (pool_k.data if quant else pool_k).shape
    if H % KH:
        raise ValueError(f"query heads {H} not a multiple of KV heads "
                         f"{KH}")
    G = H // KH
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

    cache_k = gathered(pool_k)
    cache_v = gathered(pool_v)
    p = pos[:, None].long() + torch.arange(S, device=q.device)[None, :]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            <= p[:, :, None])[:, None, None, :, :]      # [B,1,1,S,L]
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, KH, G, D)
    # f32 operands = the reference's preferred_element_type=f32: bf16
    # products are exact in f32, the sums accumulate in f32
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          cache_k.float()) * scale
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.to(cache_v.dtype).float(),
                     cache_v.float())
    return o.reshape(B, S, H, D)


_KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


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
        B, S, H, KH, D, bs, M,
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
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
