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


def _flash_case(dev, kind, B, T, H, D, masked, seed=0):
    """q, k, v ``[B, T, H, D]`` and (``masked``) a random key mask whose
    last batch row masks every key."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev, _DTYPE[kind])
               for _ in range(3))
    mask = None
    if masked:
        mask = torch.rand((B, T), generator=g) > 0.3
        mask[0, 0] = True
        mask[-1] = False
        mask = mask.to(dev)
    return q, k, v, mask


# O: f32 up to summation order; bf16 rounds p before p @ v relative to
# the running tile max (kernel) or the row max (plain), and O itself to
# bf16.  lse: f32 arithmetic on exact products in both dtypes.
_FLASH_ATOL = {"f32": 1e-4, "bf16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("T,H,D", [(1, 12, 64), (37, 12, 64),
                                   (130, 8, 128)])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_flash_attention_kernel_matches_plain(cuda, kind, T, H, D, causal,
                                              masked):
    q, k, v, mask = _flash_case(cuda, kind, 2, T, H, D, masked, seed=T)
    before = fa.flash_attention_fused.launches
    o, lse = fa.flash_attention_fused(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fused.launches == before + 1
    ro, rlse = fa.flash_attention_ref(q, k, v, mask, causal=causal)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert lse.shape == (2 * H, T)
    assert (o.float() - ro.float()).abs().max().item() <= _FLASH_ATOL[kind]
    assert torch.allclose(lse, rlse, atol=1e-3, rtol=1e-5)
    if masked:
        assert (o[-1] == 0).all() and (lse[H:] == 1e30).all()
    # the dispatch launches the kernel for CUDA tensors
    with torch.no_grad():
        out = fa.flash_attention(q, k, v, mask, causal=causal)
    assert torch.equal(out, o)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, _ = _flash_case(cuda, "f32", 1, 8, 2, 64, False)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fused(q[..., :32].contiguous(),
                                 k[..., :32].contiguous(),
                                 v[..., :32].contiguous(), causal=True)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)  # same shape
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fused(strided, k, v, causal=True)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention_fused(q, k.bfloat16(), v, causal=True)


@pytest.mark.cuda
def test_paged_attention_kernel_rejects_what_it_does_not_take(cuda):
    q, pk, pv, tables, pos = _case(cuda, "f32", 12, 12, 5)
    with pytest.raises(ValueError, match="head dim"):
        fa.paged_attention_fused(q[..., :32].contiguous(),
                                 pk[..., :32].contiguous(),
                                 pv[..., :32].contiguous(), tables, pos)
    with pytest.raises(ValueError, match="contiguous"):
        fa.paged_attention_fused(q.transpose(1, 2), pk, pv, tables, pos)
    with pytest.raises(ValueError, match="int32"):
        fa.paged_attention_fused(q, pk, pv, tables.long(), pos)


# Backward.  Several keys: exactly equal in f32 and bf16, as the H100
# reads: the kernels sum each product in the order of the plain
# version's cuBLAS GEMMs and round p and ds at the same points; a looser
# limit would let a skipped bf16 rounding of p or ds through, since the
# final bf16 rounding hides most of it.  One key: the exact dq and dk are
# 0 and both sides hold f32 rounding noise of dp - delta, so 1e-5 of
# max(1, max |reference|).
_BWD_ONE_KEY_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("T,H,D", [(1, 12, 64), (37, 12, 64),
                                   (130, 8, 128)])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_flash_backward_kernels_match_plain(cuda, kind, T, H, D, causal,
                                            masked):
    q, k, v, mask = _flash_case(cuda, kind, 2, T, H, D, masked, seed=T)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(
        T + 1)).to(cuda, q.dtype)
    o, lse = fa.flash_attention_fused(q, k, v, mask, causal=causal)
    before = fa.flash_attention_bwd_fused.launches
    got = fa.flash_attention_bwd_fused(q, k, v, mask, o, lse, do,
                                       causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_fused.launches == before + 1
    ref = fa.flash_attention_bwd_ref(q, k, v, mask, o, lse, do,
                                     causal=causal)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        scale = max(1.0, r.float().abs().max().item())
        tol = _BWD_ONE_KEY_TOL if T == 1 else 0.0
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
    with pytest.raises(ValueError, match="CUDA device"):
        bwd(q.cpu(), k.cpu(), v.cpu(), None, o.cpu(), lse.cpu(), do.cpu(),
            causal=True)
    small = [x[..., :32].contiguous() for x in (q, k, v, o, do)]
    with pytest.raises(ValueError, match="head dim"):
        bwd(*small[:3], None, small[3], lse, small[4], causal=True)
