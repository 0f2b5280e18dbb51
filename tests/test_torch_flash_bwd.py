"""The port's flash-attention backward held to the JAX reference.

``flash_attention_bwd_ref`` (the plain version of the two CUDA backward
kernels) against ``jax.vjp`` through the reference's ``flash_attention``
with blocks of 8 in interpret mode, which runs ``_bwd_call``'s Pallas
kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) as
``tests/test_ops_flash.py`` drives them: T in {5, 16, 37} run the
padding and dead-block paths, a key mask has one batch row masked
everywhere.  Also against ``jax.vjp`` of the reference's XLA
``full_attention``, and the port's ``_FlashAttention`` Function on CPU
tensors against the plain version.  The CUDA kernels themselves are held
to the plain version on the card (``chip_smoke.py``,
``tests/test_torch_cuda_kernels.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.parallel.ring_attention import \
    full_attention as jax_full_attention
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.parallel.ring_attention import full_attention

jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")

_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
_JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_B, _H, _D = 2, 3, 16
# f32: the same arithmetic up to summation order (one pass here, block by
# block in the reference): a few f32 ulps of gradients of order 1.
_F32_ATOL = 1e-5
# bf16: both sides round p and ds to bf16 at the same points, but from
# f32 values that differ in their last bits (lse and o come from the
# blockwise kernel there, from one pass here), so a rounding can land on
# the other side of a bf16 tie (2**-8 relative), and every gradient is
# itself rounded to bf16.  Four bf16 ulps of the largest gradient.
_BF16_ULPS = 4 * 2.0 ** -8


def _case(T, masked, seed):
    """q, k, v, dO ``[B, T, H, D]`` and a key mask as numpy; with
    ``masked`` a random mask in which batch row 1 masks every key."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((_B, T, _H, _D)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        mask = rng.random((_B, T)) > 0.3
        mask[0, 0] = True
        mask[1] = False
    return q, k, v, do, mask


def _t(x, kind):
    return torch.from_numpy(x).to(_TORCH[kind])


def _j(x, kind):
    return jnp.asarray(x, _JAX[kind])


def _port_grads(q, k, v, do, mask, kind, causal):
    tq, tk, tv, tdo = (_t(x, kind) for x in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    o, lse = tfa.flash_attention_ref(tq, tk, tv, tm, causal=causal)
    return tfa.flash_attention_bwd_ref(tq, tk, tv, tm, o, lse, tdo,
                                       causal=causal)


def _close(got, ref, kind):
    ref = np.asarray(ref, np.float32)
    atol = _F32_ATOL if kind == "f32" \
        else _BF16_ULPS * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("T", [5, 16, 37])
@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_bwd_ref_matches_jax_kernels(kind, T, causal, masked):
    q, k, v, do, mask = _case(T, masked, seed=T)
    grads = _port_grads(q, k, v, do, mask, kind, causal)
    for g, x in zip(grads, (q, k, v)):
        assert g.dtype == _TORCH[kind] and g.shape == x.shape
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, jm, causal=causal,
                                            block_q=8, block_k=8,
                                            interpret=True),
        _j(q, kind), _j(k, kind), _j(v, kind))
    for got, ref in zip(grads, vjp(_j(do, kind))):
        _close(got, ref, kind)
    if masked:
        # batch row 1 masks every key: its dq, dk and dv are exactly 0
        for g in grads:
            assert torch.isfinite(g).all() and (g[1] == 0).all()


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_bwd_ref_matches_jax_full_attention_grad(causal, masked):
    q, k, v, do, mask = _case(16, masked, seed=3)
    grads = _port_grads(q, k, v, do, mask, "f32", causal)
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_full_attention(a, b, c, jm, causal=causal),
        *(jnp.asarray(x) for x in (q, k, v)))
    for got, ref in zip(grads, vjp(jnp.asarray(do))):
        _close(got, ref, "f32")


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_function_on_cpu_is_the_plain_backward(kind, causal, masked):
    """torch.autograd.grad through flash_attention (the _FlashAttention
    Function on CPU tensors) equals flash_attention_bwd_ref exactly,
    with a strided dO as autograd often hands over."""
    q, k, v, do, mask = _case(37, masked, seed=5)
    tq, tk, tv = (_t(x, kind).requires_grad_() for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    o = tfa.flash_attention(tq, tk, tv, tm, causal=causal)
    assert o.grad_fn is not None
    tdo = _t(do, kind).transpose(1, 2).contiguous().transpose(1, 2)
    assert not tdo.is_contiguous()
    got = torch.autograd.grad(o, (tq, tk, tv), tdo)
    with torch.no_grad():
        ro, rlse = tfa.flash_attention_ref(tq, tk, tv, tm, causal=causal)
        ref = tfa.flash_attention_bwd_ref(tq, tk, tv, tm, ro, rlse,
                                          tdo.contiguous(), causal=causal)
    assert torch.equal(o.detach(), ro)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_function_grad_matches_autograd_of_full_attention():
    """The Function's gradient against autograd through the port's plain
    full attention, GQA-style expanded K/V included: the sum over the
    query group flows back through repeat_interleave."""
    q, k, v, do, mask = _case(16, True, seed=6)
    grads = {}
    for name, attn in (("flash", tfa.flash_attention),
                       ("full", full_attention)):
        tq = torch.from_numpy(q).requires_grad_()
        tk = torch.from_numpy(k[:, :, :1]).requires_grad_()   # one kv head
        tv = torch.from_numpy(v[:, :, :1]).requires_grad_()
        ek = torch.repeat_interleave(tk, _H, dim=2)
        ev = torch.repeat_interleave(tv, _H, dim=2)
        o = attn(tq, ek, ev, torch.from_numpy(mask), causal=True)
        grads[name] = torch.autograd.grad(o, (tq, tk, tv),
                                          torch.from_numpy(do))
    assert grads["flash"][1].shape == (_B, 16, 1, _D)
    for g, r in zip(grads["flash"], grads["full"]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=_F32_ATOL,
                                   rtol=0)


def test_no_grad_path_is_unchanged():
    """Under torch.no_grad() (or on inputs that need no grad)
    flash_attention is the plain forward, with no graph."""
    q, k, v, _, mask = _case(16, True, seed=7)
    args = [torch.from_numpy(x) for x in (q, k, v, mask)]
    ref, _ = tfa.flash_attention_ref(*args, causal=True)
    for req in (False, True):
        a = [x.clone().requires_grad_(req) if x.is_floating_point() else x
             for x in args]
        with torch.no_grad():
            out = tfa.flash_attention(*a, causal=True)
        assert out.grad_fn is None and torch.equal(out, ref)
