"""The port's paged-attention ops held to the JAX reference.

``analytics_zoo_tpu_torch/ops/flash_attention.py`` against
``analytics_zoo_tpu/ops/flash_attention.py`` on the same numpy inputs:
int8 quantization (bitwise), the paged K/V scatter (bitwise, in place,
with sink clamping and dropped writes), and the plain paged read
``paged_attention_ref`` against both the reference's ``"gather"`` path
and its Pallas kernel in interpret mode.  On this CPU host the port's
``kernel="fused"`` runs the plain version; the CUDA kernel itself is
held to it on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda_kernels.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")

_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
_JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _t(x, dtype=None):
    """numpy -> torch, optionally cast (bf16 rounds to nearest even,
    as jnp.asarray(..., bfloat16) does)."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _np(x):
    """torch or jax array -> f32/int numpy copy for comparison."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.is_floating_point() else x
        return x.numpy().copy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or \
        x.dtype.name == "bfloat16" else x


def _pools(rng, kind, N, KH, bs, D):
    """The same initial pool in both packages: (torch, jax) pairs."""
    if kind == "int8":
        # a quantized standard-normal pool, like the reference's tests
        out = []
        for _ in range(2):
            x = rng.standard_normal((N, KH, bs, D)).astype(np.float32)
            data, scale = jfa.quantize_kv(jnp.asarray(x))
            data = np.asarray(data)
            scale = np.asarray(scale.astype(jnp.float32))
            out.append((tfa.QuantKV(_t(data), _t(scale, torch.bfloat16)),
                        jfa.QuantKV(jnp.asarray(data),
                                    jnp.asarray(scale, jnp.bfloat16))))
        return out
    out = []
    for _ in range(2):
        x = rng.standard_normal((N, KH, bs, D)).astype(np.float32)
        out.append((_t(x, _TORCH[kind]), jnp.asarray(x, _JAX[kind])))
    return out


def _leaves(pool):
    if isinstance(pool, (tfa.QuantKV, jfa.QuantKV)):
        return [_np(pool.data), _np(pool.scale)]
    return [_np(pool)]


@pytest.mark.parametrize("in_dtype", ["f32", "bf16"])
def test_quantize_kv_bitwise(in_dtype):
    """Data and scales are IDENTICAL: the scale rounds to bf16 before
    the divide in both, and torch.round / jnp.round both round half to
    even (exact halves are planted to pin that)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3.0
    x[0, 0] = 0.0                                   # all-zero row
    x[0, 1, :3] = [127.0, 0.5, -2.5]                # scale 1: exact halves
    x[0, 1, 3:] = 0.0
    xt = _t(x, _TORCH[in_dtype])
    xj = jnp.asarray(x, _JAX[in_dtype])
    qt, st = tfa.quantize_kv(xt)
    qj, sj = jfa.quantize_kv(xj)
    assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_np(st), _np(sj))
    assert _np(st)[0, 0] == 1.0 and not qt[0, 0].any()
    np.testing.assert_array_equal(_np(tfa.dequantize_kv(qt, st)),
                                  _np(jfa.dequantize_kv(qj, sj)))


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("with_limit", [False, True])
def test_paged_kv_update_bitwise(kind, S, with_limit):
    """The in-place scatter leaves the pools bitwise equal to the
    reference's scatter.  Row 0's table ends in the sink column and its
    positions run past the table width (M*bs = 16), so its overshoot
    writes clamp into the sink; row 1 writes its own blocks.  S <= bs
    keeps every write of a row on a distinct (block, offset), so the
    comparison is well defined.  ``limit`` drops writes outright."""
    rng = np.random.default_rng(S)
    N, KH, bs, D, M = 6, 2, 8, 8, 2
    (pk_t, pk_j), (pv_t, pv_j) = _pools(rng, kind, N, KH, bs, D)
    before = _leaves(pk_t)
    tables = np.array([[1, 0], [2, 3]], np.int32)
    pos = np.array([12, 3], np.int32)
    new_k = rng.standard_normal((2, S, KH, D)).astype(np.float32)
    new_v = rng.standard_normal((2, S, KH, D)).astype(np.float32)
    limit = np.array([13, 3 + S - 1], np.int32) if with_limit else None
    tfa.paged_kv_update(pk_t, pv_t, _t(tables), _t(pos), _t(new_k),
                        _t(new_v),
                        limit=None if limit is None else _t(limit))
    pk_j, pv_j = jfa.paged_kv_update(
        pk_j, pv_j, jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(new_k), jnp.asarray(new_v),
        limit=None if limit is None else jnp.asarray(limit))
    for a, b in zip(_leaves(pk_t) + _leaves(pv_t),
                    _leaves(pk_j) + _leaves(pv_j)):
        np.testing.assert_array_equal(a, b)
    after = _leaves(pk_t)
    # row 0's first write (position 12 -> sink block 0, offset 4)
    # happens in every case; with a limit of 13 its later writes do not
    changed = [o for o in range(bs) if not np.array_equal(
        after[0][0, :, o], before[0][0, :, o])]
    expect = [(12 + s) % bs for s in range(S)
              if not with_limit or 12 + s < 13]
    assert sorted(changed) == sorted(expect)
    if kind == "f32":
        np.testing.assert_array_equal(after[0][0, :, 4], new_k[0, 0])


def _attn_case(rng, kind, H, KH, S, sliced, B=3, bs=4, D=16, M=6):
    """A filled pool, ragged positions and per-row private blocks (ids
    1..B*M; block 0 is the sink).  A sliced table keeps only the
    columns that cover the furthest attended position, pos+S-1."""
    N = B * M + 1
    (pk_t, pk_j), (pv_t, pv_j) = _pools(rng, kind, N, KH, bs, D)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    qdt = "bf16" if kind == "bf16" else "f32"
    tables = (1 + rng.permutation(B * M)).reshape(B, M).astype(np.int32)
    pos = rng.integers(0, 11, B).astype(np.int32)
    pos[0] = 10
    if sliced:
        tables = tables[:, :(int(pos.max()) + S - 1) // bs + 1].copy()
        assert tables.shape[1] < M
    torch_args = (_t(q, _TORCH[qdt]), pk_t, pv_t, _t(tables), _t(pos))
    jax_args = (jnp.asarray(q, _JAX[qdt]), pk_j, pv_j, jnp.asarray(tables),
                jnp.asarray(pos))
    return torch_args, jax_args


# f32 and int8 pools: identical math in f32 up to summation order.
# bf16 pools: both sides round the attention weights to bf16 before
# p @ v, but at different points — the reference's gather path rounds
# the NORMALISED softmax weights, its fused kernel the unnormalised
# online-softmax p — so the two reference paths themselves differ by
# about one bf16 ulp of each weight (2**-8 relative) times |v| ~ 1.
_ATOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("H,KH", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("sliced", [False, True])
def test_paged_attention_ref_matches_jax(kind, H, KH, S, sliced):
    rng = np.random.default_rng(H * 100 + KH * 10 + S)
    targs, jargs = _attn_case(rng, kind, H, KH, S, sliced)
    out = tfa.paged_attention_ref(*targs)
    assert out.dtype == torch.float32 and out.shape == targs[0].shape
    ref = jfa.paged_attention(*jargs, kernel="gather")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=_ATOL[kind], rtol=0)
    # the port's default kernel runs the plain version on a CPU tensor
    np.testing.assert_array_equal(
        tfa.paged_attention(*targs).numpy(), out.numpy())


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("H,KH,S", [(4, 4, 1), (4, 2, 3), (4, 1, 8)])
def test_paged_attention_ref_matches_jax_fused_kernel(kind, H, KH, S):
    """Against the reference's Pallas kernel itself (interpret mode, as
    the reference's own tests run it on the CPU), sliced tables."""
    rng = np.random.default_rng(7 + S)
    targs, jargs = _attn_case(rng, kind, H, KH, S, sliced=True)
    ref = jfa.paged_attention(*jargs, kernel="fused", interpret=True)
    np.testing.assert_allclose(tfa.paged_attention_ref(*targs).numpy(),
                               np.asarray(ref), atol=_ATOL[kind], rtol=0)


def test_paged_attention_rejects_unknown_kernel():
    rng = np.random.default_rng(0)
    targs, _ = _attn_case(rng, "f32", 4, 4, 1, sliced=False)
    with pytest.raises(ValueError, match="kernel must be"):
        tfa.paged_attention(*targs, kernel="pallas")
