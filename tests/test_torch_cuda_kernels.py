"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device (a hand-written kernel has no CPU
mode) and skips without one.  The file imports no JAX, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest configures JAX.)  The kernels
build from ``analytics_zoo_tpu_torch/ops/csrc`` at their first launch.
``chip_smoke.py`` runs the full sweep at serving and training shapes.
"""

import pytest
import torch

from analytics_zoo_tpu_torch.ops import flash_attention as fa

# Paged attention.  f32 and int8 pools: the same f32 arithmetic up to
# summation order.
# bf16 pools: the kernel rounds the unnormalised online-softmax p to
# bf16 before p @ v, the plain version the normalised weights, so they
# differ by about one bf16 ulp (2**-8) of each weight times |v|.
_ATOL = {"f32": 1e-4, "int8": 1e-4, "bf16": 2e-2}
_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
# the head dims instantiated beside 64 and 128 (the multiples of 32 up
# to 128): a lane of the paged CUDA-core kernel holds D / 32 values, 1
# or 3 here, which at D = 96 (and at D = 32 in int8) no aligned word of a
# row holds
_NEW_HEAD_DIMS = [32, 96]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, kind, H, KH, S, B=3, bs=16, M=8, seed=0):
    """Ragged positions (row 0 at the frontier of a table SLICED to
    the blocks it attends), per-row private blocks, block 0 the sink."""
    g = torch.Generator().manual_seed(seed)
    D = 64 if H == KH else 128
    N = B * M + 1

    def pool():
        x = torch.randn((N, KH, bs, D), generator=g).to(dev)
        if kind == "int8":
            return fa.QuantKV(*fa.quantize_kv(x))
        return x.to(_DTYPE[kind])

    pk, pv = pool(), pool()
    q = torch.randn((B, S, H, D), generator=g).to(
        dev, torch.float32 if kind == "f32" else torch.bfloat16)
    hi = (M - 2) * bs - S
    pos = torch.randint(0, hi + 1, (B,), generator=g, dtype=torch.int32)
    pos[0] = hi
    tables = (1 + torch.randperm(B * M, generator=g)).to(torch.int32)
    tables = tables.reshape(B, M)[:, :(hi + S - 1) // bs + 1].contiguous()
    return q, pk, pv, tables.to(dev), pos.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("H,KH,S", [(12, 12, 1), (12, 12, 40),
                                    (32, 4, 1), (32, 4, 5)])
def test_paged_attention_kernel_matches_plain(cuda, kind, H, KH, S):
    args = _case(cuda, kind, H, KH, S, seed=S)
    before = fa.paged_attention_fused.launches
    out = fa.paged_attention(*args)          # kernel="fused" on CUDA
    torch.cuda.synchronize()
    assert fa.paged_attention_fused.launches == before + 1
    ref = fa.paged_attention(*args, kernel="gather")
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    assert (out - ref).abs().max().item() <= _ATOL[kind]


def _lengths(T):
    """(Tq, Tk) of a case's ``T``: one length for both, or a pair."""
    return T if isinstance(T, tuple) else (T, T)


def _flash_case(dev, kind, B, T, H, D, masked, seed=0):
    """q ``[B, Tq, H, D]``, k, v ``[B, Tk, H, D]`` (:func:`_lengths`) and
    (``masked``) a random key mask whose last batch row masks every
    key."""
    Tq, Tk = _lengths(T)
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((B, n, H, D), generator=g).to(dev, _DTYPE[kind])
               for n in (Tq, Tk, Tk))
    mask = None
    if masked:
        mask = torch.rand((B, Tk), generator=g) > 0.3
        mask[0, 0] = True
        mask[-1] = False
        mask = mask.to(dev)
    return q, k, v, mask


# O: f32 up to summation order; bf16 (tensor cores: the same exact
# products, summed in another order) rounds p before p @ v relative to
# the running tile max (kernel) or the row max (plain), and O itself to
# bf16.  lse: f32 arithmetic on exact products in both dtypes.
_FLASH_ATOL = {"f32": 1e-4, "bf16": 2e-2}


# Shapes the 128-row tiles of the bf16 wgmma kernels (D = 64 and 128) can
# get wrong: lengths at and across the tile edges (1, 65, 127, 129, 383),
# Tq != Tk both ways (causal diagonals that end inside or past a 128-row
# tile, keys no query reaches), and B*H = 300 (the grid over more than
# two waves of the card's SMs, one block an SM).
_WGMMA_SHAPES = [
    (127, 12, 64), (129, 12, 64), (383, 12, 64), ((65, 383), 12, 64),
    ((383, 129), 12, 64), ((1, 129), 8, 128), ((127, 65), 8, 128),
    (383, 8, 128), ((129, 383), 8, 128), (129, 150, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("T,H,D", [
    (1, 12, 64), (16, 12, 64), (17, 12, 64), (37, 12, 64), (65, 12, 64),
    ((37, 1000), 12, 64), (129, 8, 128), (130, 8, 128)] + _WGMMA_SHAPES)
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_flash_attention_kernel_matches_plain(cuda, kind, T, H, D, causal,
                                              masked):
    Tq, _ = _lengths(T)
    q, k, v, mask = _flash_case(cuda, kind, 2, T, H, D, masked, seed=Tq)
    before = fa.flash_attention_fused.launches
    o, lse = fa.flash_attention_fused(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fused.launches == before + 1
    ro, rlse = fa.flash_attention_ref(q, k, v, mask, causal=causal)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert lse.shape == (2 * H, Tq)
    assert (o.float() - ro.float()).abs().max().item() <= _FLASH_ATOL[kind]
    assert torch.allclose(lse, rlse, atol=1e-3, rtol=1e-5)
    if masked:
        assert (o[-1] == 0).all() and (lse[H:] == 1e30).all()
    # the dispatch launches the kernel for CUDA tensors
    with torch.no_grad():
        out = fa.flash_attention(q, k, v, mask, causal=causal)
    assert torch.equal(out, o)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("D", _NEW_HEAD_DIMS)
@pytest.mark.parametrize("T", [1, 17, 65, (37, 130), 130, 127, 383, (65, 383),
                               (383, 129)])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_flash_attention_kernel_head_dims(cuda, kind, D, T, causal, masked):
    Tq, _ = _lengths(T)
    q, k, v, mask = _flash_case(cuda, kind, 2, T, 4, D, masked, seed=Tq + D)
    o, lse = fa.flash_attention_fused(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_ref(q, k, v, mask, causal=causal)
    assert (o.float() - ro.float()).abs().max().item() <= _FLASH_ATOL[kind]
    assert torch.allclose(lse, rlse, atol=1e-3, rtol=1e-5)
    if masked:
        assert (o[-1] == 0).all() and (lse[4:] == 1e30).all()


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, _ = _flash_case(cuda, "f32", 1, 8, 2, 64, False)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fused(q[..., :16].contiguous(),
                                 k[..., :16].contiguous(),
                                 v[..., :16].contiguous(), causal=True)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)  # same shape
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fused(strided, k, v, causal=True)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention_fused(q, k.bfloat16(), v, causal=True)
    # contiguous but 2 bytes past a 16-byte boundary: cp.async cannot
    # copy its rows
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fused(_misaligned(qb), kb, vb, causal=True)


def _misaligned(x):
    """A contiguous copy of ``x`` whose storage starts one element past
    an aligned address."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def _regime_case(dev, kind, bs, S, G, table, seed=0, D=None):
    """Paged inputs for one regime: B=2 rows, (H, KH) = (12, 12) at D=64
    or (32, 4) at D=128 (G = 8), unless ``D`` is given; ``table`` "full"
    (row 0 two blocks short of the end), "sliced" (cut to the blocks row
    0 attends) or "long" (M >= 128 columns, positions 0-3: most split
    ranges hold nothing)."""
    g = torch.Generator().manual_seed(seed)
    H, KH, D0 = (12, 12, 64) if G == 1 else (32, 4, 128)
    D = D or D0
    B = 2
    if table == "long":
        hi = 3
        M = max(128, (hi + S - 1) // bs + 1 + 128)
    else:
        M = (40 + S - 1) // bs + 3
        hi = (M - 2) * bs - S
    pos = torch.randint(0, hi + 1, (B,), generator=g, dtype=torch.int32)
    pos[0] = hi
    N = B * M + 1

    def pool():
        x = torch.randn((N, KH, bs, D), generator=g).to(dev)
        if kind == "int8":
            return fa.QuantKV(*fa.quantize_kv(x))
        return x.to(_DTYPE[kind])

    pk, pv = pool(), pool()
    q = torch.randn((B, S, H, D), generator=g).to(
        dev, torch.float32 if kind == "f32" else torch.bfloat16)
    tables = (1 + torch.randperm(B * M, generator=g)).to(torch.int32)
    tables = tables.reshape(B, M)
    if table == "sliced":
        tables = tables[:, :(hi + S - 1) // bs + 1].contiguous()
    return q, pk, pv, tables.to(dev), pos.to(dev)


# (S, G): decode with one and eight query heads a kv head, the row count
# just below (15) and at (16) the bf16 tensor-core threshold, wide
# verify (40 rows) and a 512-token prefill chunk
_REGIMES = [(1, 1), (1, 8), (15, 1), (2, 8), (5, 8), (512, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bs", [1, 16, 64])
@pytest.mark.parametrize("S,G", _REGIMES)
@pytest.mark.parametrize("table", ["full", "sliced", "long"])
def test_paged_attention_kernel_regimes(cuda, kind, bs, S, G, table):
    args = _regime_case(cuda, kind, bs, S, G, table, seed=bs + S)
    before = fa.paged_attention_fused.launches
    out = fa.paged_attention(*args)
    torch.cuda.synchronize()
    assert fa.paged_attention_fused.launches == before + 1
    ref = fa.paged_attention_ref(*args)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= _ATOL[kind]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("D", _NEW_HEAD_DIMS)
@pytest.mark.parametrize("bs", [1, 16, 64])
@pytest.mark.parametrize("S,G", [(1, 1), (1, 8), (2, 8), (512, 1)])
@pytest.mark.parametrize("table", ["full", "long"])
def test_paged_attention_kernel_head_dims(cuda, kind, D, bs, S, G, table):
    args = _regime_case(cuda, kind, bs, S, G, table, seed=bs + S + D, D=D)
    before = fa.paged_attention_fused.launches
    out = fa.paged_attention(*args)
    torch.cuda.synchronize()
    assert fa.paged_attention_fused.launches == before + 1
    ref = fa.paged_attention_ref(*args)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= _ATOL[kind]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("S,G", [(1, 8), (512, 1)])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_paged_attention_kernel_any_split_count(cuda, kind, S, G, splits,
                                                monkeypatch):
    """Any split count computes the same function: the combine kernel
    merges what the split kernel writes (the count forced through
    ``paged_attention_splits``)."""
    args = _regime_case(cuda, kind, 16, S, G, "full", seed=splits)
    monkeypatch.setattr(fa, "paged_attention_splits",
                        lambda *shape: splits)
    out = fa.paged_attention_fused(*args)
    torch.cuda.synchronize()
    ref = fa.paged_attention_ref(*args)
    assert (out - ref).abs().max().item() <= _ATOL[kind]


def _wgmma_case(dev, S, G, D, bs, seed=0, poison=True):
    """bf16 paged inputs for the wgmma path's grid: B=3 rows of S query
    tokens, KH=2 kv heads of G query heads each, positions that start
    and end inside a page, rows 1 and 2 sharing their first blocks (a
    shared prefix), and (``poison``) every table entry past a row's last
    live page set to -1 or to an id past the pool.  Returns (args for
    the kernel, args for the plain version: the same with the poisoned
    entries set to the sink block 0)."""
    g = torch.Generator().manual_seed(seed)
    B, KH = 3, 2
    H = KH * G
    # the furthest row's queries start 2 positions into a page, the
    # others mid-page; row 2 is short (two whole blocks and a part)
    hi = 3 * bs + 2 + max(0, 80 - S)
    pos = torch.tensor([hi, hi - bs // 2 - 1, 2 * bs + bs // 2 + 1],
                       dtype=torch.int32)
    M = (hi + S - 1) // bs + 3
    N = B * M + 1
    kv = [torch.randn((N, KH, bs, D), generator=g).to(dev, torch.bfloat16)
          for _ in range(2)]
    q = torch.randn((B, S, H, D), generator=g).to(dev, torch.bfloat16)
    tables = (1 + torch.randperm(B * M, generator=g)).to(torch.int32)
    tables = tables.reshape(B, M)
    shared = (int(pos[2]) + 1) // bs          # row 2's whole blocks
    tables[1, :shared] = tables[2, :shared]
    clean = tables.clone()
    if poison:
        for b in range(B):
            live = (int(pos[b]) + S - 1) // bs + 1
            tables[b, live:] = torch.where(
                torch.arange(M - live) % 2 == 0, -1, N + 1000 * (b + 1))
            clean[b, live:] = 0
    pos = pos.to(dev)
    return ((q, kv[0], kv[1], tables.to(dev), pos),
            (q, kv[0], kv[1], clean.to(dev), pos))


# (S, G): rows a kv head 1 (MHA decode), 5 (MHA verify), 8 (GQA decode),
# 40 (GQA verify), 256 (a 32-token GQA chunk: two 128-row tiles) and
# 4096 (a 512-token GQA prefill group)
_WGMMA_ROWS = [(1, 1), (5, 1), (1, 8), (5, 8), (32, 8), (512, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,G", _WGMMA_ROWS)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [1, 8, 16, 64])
def test_paged_attention_wgmma_matches_plain(cuda, S, G, D, bs):
    """bf16 at D = 64/128 (the wgmma kernel at bs 8/16/64; bs 1 takes
    the earlier kernels, chosen up front): every row count, ragged and
    shared pages, poisoned table tails, against the plain version."""
    args, clean = _wgmma_case(cuda, S, G, D, bs, seed=S + G + D + bs)
    assert fa.paged_wgmma_takes(torch.bfloat16, torch.bfloat16, D, bs) \
        == (bs != 1)
    before = fa.paged_attention_fused.launches
    out = fa.paged_attention(*args)
    again = fa.paged_attention(*args)
    torch.cuda.synchronize()
    assert fa.paged_attention_fused.launches == before + 2
    ref = fa.paged_attention_ref(*clean)
    assert out.shape == args[0].shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= _ATOL["bf16"]
    assert torch.equal(out, again)      # no atomics: bitwise repeatable


@pytest.mark.cuda
@pytest.mark.parametrize("S,G", [(1, 8), (5, 8), (32, 8), (512, 1)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 6, 7, 8, 12])
def test_paged_attention_wgmma_any_split_count(cuda, S, G, D, splits,
                                               monkeypatch):
    """Any split count computes the same function on the wgmma path: up
    to 8 the blocks of one cluster, 12 a cluster of 8 whose blocks take
    one or two ranges each."""
    args, clean = _wgmma_case(cuda, S, G, D, 16, seed=splits)
    monkeypatch.setattr(fa, "paged_attention_splits",
                        lambda *shape: splits)
    out = fa.paged_attention_fused(*args)
    torch.cuda.synchronize()
    ref = fa.paged_attention_ref(*clean)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= _ATOL["bf16"]


@pytest.mark.cuda
def test_paged_attention_kernel_rejects_what_it_does_not_take(cuda):
    q, pk, pv, tables, pos = _case(cuda, "f32", 12, 12, 5)
    with pytest.raises(ValueError, match="head dim"):
        fa.paged_attention_fused(q[..., :16].contiguous(),
                                 pk[..., :16].contiguous(),
                                 pv[..., :16].contiguous(), tables, pos)
    with pytest.raises(ValueError, match="contiguous"):
        fa.paged_attention_fused(q.transpose(1, 2), pk, pv, tables, pos)
    with pytest.raises(ValueError, match="int32"):
        fa.paged_attention_fused(q, pk, pv, tables.long(), pos)
    # contiguous but 2 bytes past a 16-byte boundary: cp.async cannot
    # copy its rows
    qb, kb, vb = q.bfloat16(), pk.bfloat16(), pv.bfloat16()
    with pytest.raises(ValueError, match="aligned"):
        fa.paged_attention_fused(qb, _misaligned(kb), vb, tables, pos)
    with pytest.raises(ValueError, match="aligned"):
        fa.paged_attention_fused(_misaligned(qb), kb, vb, tables, pos)


# Backward, relative to max(1, max |reference|).  The f32 CUDA-core
# kernels (dq and dk/dv), several keys: exactly equal, as the H100 reads:
# they sum each product in the order of the plain version's cuBLAS GEMMs.
# One key: the exact dq and dk are 0 and both sides hold f32 rounding
# noise of dp - delta, so 1e-5.
# The bf16 kernels (dq, and dk/dv) sum on the tensor cores in another
# order, so p, ds and each gradient may land on a neighbouring bf16
# value: 2**-7, one to two bf16 ulps of the largest gradient, at every
# T; their p and ds rounding cannot be skipped, since the mma's A
# operand is the bf16 p or ds itself.
_BWD_ONE_KEY_TOL = 1e-5
_DQ_BF16_TOL = 2.0 ** -7


def _bwd_tols(kind, T):
    if kind == "bf16":
        return (_DQ_BF16_TOL,) * 3
    # one query row (Tq = 1, causal: it sees one key) counts as one key
    return ((_BWD_ONE_KEY_TOL if min(_lengths(T)) == 1 else 0.0),) * 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("T,H,D", [(1, 12, 64), (16, 12, 64), (17, 12, 64),
                                   (37, 12, 64), (65, 12, 64),
                                   (129, 8, 128), (130, 8, 128)]
                         + _WGMMA_SHAPES)
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_flash_backward_kernels_match_plain(cuda, kind, T, H, D, causal,
                                            masked):
    Tq, _ = _lengths(T)
    q, k, v, mask = _flash_case(cuda, kind, 2, T, H, D, masked, seed=Tq)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(
        Tq + 1)).to(cuda, q.dtype)
    o, lse = fa.flash_attention_fused(q, k, v, mask, causal=causal)
    before = fa.flash_attention_bwd_fused.launches
    got = fa.flash_attention_bwd_fused(q, k, v, mask, o, lse, do,
                                       causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_fused.launches == before + 1
    ref = fa.flash_attention_bwd_ref(q, k, v, mask, o, lse, do,
                                     causal=causal)
    for g, r, tol in zip(got, ref, _bwd_tols(kind, T)):
        assert g.dtype == r.dtype and g.shape == r.shape
        scale = max(1.0, r.float().abs().max().item())
        assert (g.float() - r.float()).abs().max().item() <= tol * scale
    if masked:
        # the last batch row masks every key: no gradient, and no NaN
        for g in got:
            assert (g[-1] == 0).all()
    # the autograd Function launches the same kernels for CUDA tensors
    # (no atomics: the same inputs give the same bits)
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*qkv, mask, causal=causal)
    assert torch.equal(out, o)
    assert fa.flash_attention_bwd_fused.launches == before + 1
    grads = torch.autograd.grad(out, qkv, do)
    assert fa.flash_attention_bwd_fused.launches == before + 2
    for g, r in zip(grads, got):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("D", _NEW_HEAD_DIMS)
@pytest.mark.parametrize("T", [1, 17, 33, 65, 130, 127, 383, (65, 383),
                               (383, 129)])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_flash_backward_kernels_head_dims(cuda, kind, D, T, causal, masked):
    """The dq and dk/dv kernels at the new head dims, across their tile
    edges (32-key dq and 32-query dk/dv tiles at D = 96, 64 at D = 32)."""
    Tq, _ = _lengths(T)
    q, k, v, mask = _flash_case(cuda, kind, 2, T, 4, D, masked, seed=Tq + D)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(
        Tq + D + 1)).to(cuda, q.dtype)
    o, lse = fa.flash_attention_fused(q, k, v, mask, causal=causal)
    got = fa.flash_attention_bwd_fused(q, k, v, mask, o, lse, do,
                                       causal=causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_ref(q, k, v, mask, o, lse, do,
                                     causal=causal)
    for g, r, tol in zip(got, ref, _bwd_tols(kind, T)):
        scale = max(1.0, r.float().abs().max().item())
        assert (g.float() - r.float()).abs().max().item() <= tol * scale
    if masked:
        for g in got:
            assert (g[-1] == 0).all()


@pytest.mark.cuda
def test_flash_backward_rejects_what_it_does_not_take(cuda):
    q, k, v, _ = _flash_case(cuda, "f32", 1, 8, 2, 64, False)
    o, lse = fa.flash_attention_fused(q, k, v, causal=True)
    do = torch.ones_like(q)
    bwd = fa.flash_attention_bwd_fused
    with pytest.raises(ValueError, match="dO must match"):
        bwd(q, k, v, None, o, lse, do.bfloat16(), causal=True)
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(q, k, v, None, o, lse, strided, causal=True)
    with pytest.raises(ValueError, match="lse"):
        bwd(q, k, v, None, o, lse[:, :4].contiguous(), do, causal=True)
    with pytest.raises(ValueError, match="aligned"):
        bwd(q, k, v, None, o, lse, _misaligned(do), causal=True)
    with pytest.raises(ValueError, match="CUDA device"):
        bwd(q.cpu(), k.cpu(), v.cpu(), None, o.cpu(), lse.cpu(), do.cpu(),
            causal=True)
    small = [x[..., :16].contiguous() for x in (q, k, v, o, do)]
    with pytest.raises(ValueError, match="head dim"):
        bwd(*small[:3], None, small[3], lse, small[4], causal=True)


# The wgmma dq kernel's edges (128-row query tiles; 128-key tiles at
# D = 64, 64-key tiles at D = 128): Tq not a multiple of 128 and Tq % 4
# != 0 (lse and delta read by plain loads), Tk != Tq both ways, a key
# mask whose last batch row masks every key, causal at D = 128, and a
# query tile whose second consumer holds no row (Tq = 3).
_DQ_EDGES = [
    (201, 201, 64, True, False), (201, 201, 128, False, True),
    (202, 75, 64, True, True), (75, 333, 128, True, False),
    (333, 201, 128, True, True), (3, 513, 64, False, True),
    (383, 383, 128, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,Tk,D,causal,masked", _DQ_EDGES)
def test_flash_backward_dq_wgmma_edges(cuda, Tq, Tk, D, causal, masked):
    q, k, v, mask = _flash_case(cuda, "bf16", 2, (Tq, Tk), 4, D, masked,
                                seed=Tq + Tk)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(
        Tq + 1)).to(cuda, q.dtype)
    o, lse = fa.flash_attention_fused(q, k, v, mask, causal=causal)
    got = fa.flash_attention_bwd_fused(q, k, v, mask, o, lse, do,
                                       causal=causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_ref(q, k, v, mask, o, lse, do,
                                     causal=causal)
    for g, r in zip(got, ref):
        scale = max(1.0, r.float().abs().max().item())
        assert (g.float() - r.float()).abs().max().item() \
            <= _DQ_BF16_TOL * scale
    if masked:
        for g in got:
            assert (g[-1] == 0).all()
    # two launches of the dq kernel alone give the same bits (no atomics)
    delta = fa.flash_attention_bwd_delta(o, do)
    outs = [torch.full_like(q, 7.0) for _ in range(2)]
    for out in outs:
        fa.flash_attention_bwd_launch("dq", q, k, v, mask, do, lse, delta,
                                      (out,), causal, 1.0 / D ** 0.5)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_bf16_dq_dispatches_by_head_dim(cuda, D):
    """bf16 dq runs the wgmma kernel at D = 64 and 128 and the mma.sync
    kernel at 32 and 96 (the profiler's kernel names)."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, _ = _flash_case(cuda, "bf16", 1, 130, 2, D, False)
    o, lse = fa.flash_attention_fused(q, k, v, causal=True)
    do = torch.ones_like(q)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fa.flash_attention_bwd_fused(q, k, v, None, o, lse, do, causal=True)
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    want = "flash_bwd_dq_wgmma_kernel" if D in (64, 128) \
        else "flash_bwd_dq_bf16_kernel"
    assert want in names
    assert "flash_bwd_delta_kernel" in names


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
@pytest.mark.parametrize("Tq,H", [(1, 3), (33, 12), (200, 9)])
def test_flash_backward_delta_kernel_matches_plain(cuda, kind, D, Tq, H):
    g = torch.Generator().manual_seed(Tq + D)
    o, do = (torch.randn((2, Tq, H, D), generator=g).to(cuda, _DTYPE[kind])
             for _ in range(2))
    before = fa.flash_attention_bwd_delta_fused.launches
    got = fa.flash_attention_bwd_delta_fused(o, do)
    again = fa.flash_attention_bwd_delta_fused(o, do)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_delta_fused.launches == before + 2
    ref = fa.flash_attention_bwd_delta(o, do)
    assert got.dtype == torch.float32 and got.shape == (2 * H, Tq)
    # the plain version rounds the same products and adds them in the
    # kernel's order (d by d): bitwise equal, in f32 as in bf16
    assert torch.equal(got, ref)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_flash_backward_delta_rejects_what_it_does_not_take(cuda):
    o = torch.randn((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="dO must match"):
        fa.flash_attention_bwd_delta_fused(o, o.bfloat16())
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_delta_fused(o.cpu(), o.cpu())
    with pytest.raises(ValueError, match="head dim"):
        small = o[..., :16].contiguous()
        fa.flash_attention_bwd_delta_fused(small, small)
