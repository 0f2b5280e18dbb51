"""The port's dense flash forward and attention dispatch held to the JAX
reference.

``flash_attention_ref`` (the plain version of the CUDA kernel) against
the reference's Pallas forward in interpret mode, as
``tests/test_ops_flash.py`` drives it: O against ``flash_attention``,
lse against ``_fwd_call``, and O against the reference's XLA
``full_attention``.  Small blocks (8) make T in {5, 16, 37} run the
padding and dead-block paths of the reference kernel.  On this CPU host
the port's ``flash_attention`` runs the plain version; the CUDA kernel
itself is held to it on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda_kernels.py``.  The backward's parity is in
``tests/test_torch_flash_bwd.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.parallel.ring_attention import \
    full_attention as jax_full_attention
from analytics_zoo_tpu_torch.models import transformer as ttr
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.parallel.mesh import Mesh
from analytics_zoo_tpu_torch.parallel.ring_attention import full_attention

jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")

_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
_JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}
# f32: the same arithmetic up to summation order (one pass here, block
# by block in the reference).  bf16: both round p to bf16 before p @ v,
# the reference relative to its running block max and the plain version
# relative to the row's final max, and O itself is rounded to bf16
# (2**-8 relative), so they differ by a few bf16 ulps of |o| <= max|v|.
_ATOL = {"f32": 1e-5, "bf16": 2e-2}
_B, _H, _D = 2, 3, 16


def _case(T, dtype, masked, seed):
    """q, k, v ``[B, T, H, D]`` and a key mask as numpy; with
    ``masked`` a random mask in which batch row 1 masks every key."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((_B, T, _H, _D)).astype(np.float32)
               for _ in range(3))
    mask = None
    if masked:
        mask = rng.random((_B, T)) > 0.3
        mask[0, 0] = True
        mask[1] = False
    return q, k, v, mask


def _t(x, kind):
    return torch.from_numpy(x).to(_TORCH[kind])


def _j(x, kind):
    return jnp.asarray(x, _JAX[kind])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("T", [5, 16, 37])
@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_flash_ref_matches_jax_kernel(kind, T, causal, masked):
    q, k, v, mask = _case(T, kind, masked, seed=T)
    o, lse = tfa.flash_attention_ref(
        _t(q, kind), _t(k, kind), _t(v, kind),
        None if mask is None else torch.from_numpy(mask), causal=causal)
    assert o.dtype == _TORCH[kind] and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (_B * _H, T)

    jm = None if mask is None else jnp.asarray(mask)
    jo = jfa.flash_attention(_j(q, kind), _j(k, kind), _j(v, kind), jm,
                             causal=causal, block_q=8, block_k=8,
                             interpret=True)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo, np.float32),
                               atol=_ATOL[kind], rtol=0)

    # lse from the reference's forward call on its own flattened,
    # padded operands, as flash_attention builds them
    def flat(x):
        x = _j(x, kind).transpose(0, 2, 1, 3).reshape(_B * _H, T, _D)
        return jfa._pad_to(x, 8, axis=1)

    jmask = jnp.ones((_B, T), jnp.int32) if mask is None \
        else jnp.asarray(mask, jnp.int32)
    jmask = jfa._pad_to(jmask, 8, axis=1)[:, None, :]
    _, jlse = jfa._fwd_call(flat(q), flat(k), flat(v), jmask,
                            scale=1.0 / np.sqrt(_D), causal=causal, bq=8,
                            bk=8, interpret=True)
    # lse is f32 arithmetic on exact (bf16 x bf16) products in both
    # types: summation order is the only difference
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :T, 0],
                               atol=1e-4, rtol=1e-6)

    if masked:
        # batch row 1 masks every key: o = 0 and lse = +1e30 exactly
        assert (o[1] == 0).all()
        assert (lse[_H:] == np.float32(1e30)).all()

    # and O against the reference's XLA full attention
    jfull = jax_full_attention(_j(q, kind), _j(k, kind), _j(v, kind), jm,
                               causal=causal)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jfull, np.float32),
                               atol=_ATOL[kind], rtol=0)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("causal,masked", [(False, True), (True, False)])
def test_full_attention_matches_jax(kind, causal, masked):
    q, k, v, mask = _case(16, kind, masked, seed=1)
    got = full_attention(_t(q, kind), _t(k, kind), _t(v, kind),
                         None if mask is None else torch.from_numpy(mask),
                         causal=causal)
    ref = jax_full_attention(_j(q, kind), _j(k, kind), _j(v, kind),
                             None if mask is None else jnp.asarray(mask),
                             causal=causal)
    assert got.dtype == _TORCH[kind]
    # both compute in one pass with the same cast points: only the
    # summation order and, in bf16, the output rounding differ
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=1e-5 if kind == "f32" else 1e-2,
                               rtol=0)


def test_dispatch_picks_the_plain_branch_on_the_cpu(monkeypatch):
    """use_flash=None: full_attention for a CPU tensor (as the
    reference does off its TPU), the kernel for a CUDA tensor;
    True/False force either branch."""
    assert not ttr.flash_ok(None, "cpu", 64)
    assert ttr.flash_ok(None, "cuda", 64)
    assert ttr.flash_ok(True, "cpu", 64) \
        and not ttr.flash_ok(False, "cuda", 64)
    calls = []
    monkeypatch.setattr(ttr, "full_attention",
                        lambda *a, **kw: calls.append("full"))
    monkeypatch.setattr(ttr, "flash_attention",
                        lambda *a, **kw: calls.append("flash"))
    q = torch.zeros((1, 4, 2, 8))
    for use_flash in (None, True, False):
        ttr.attention_dispatch(q, q, q, None, causal=True,
                               use_flash=use_flash)
    assert calls == ["full", "flash", "full"]
    # a mesh that splits the sequence dispatches to the sp attention
    monkeypatch.setattr(ttr, "ring_self_attention",
                        lambda *a, **kw: calls.append(kw["strategy"]))
    ttr.attention_dispatch(q, q, q, None, causal=True,
                           mesh=Mesh({"sp": 2}, "cpu"),
                           sp_strategy="ulysses")
    assert calls[-1] == "ulysses"


@pytest.mark.parametrize("head_dim,takes", [
    (8, False), (16, False), (32, True), (64, True), (80, False),
    (96, True), (128, True), (256, False)])
def test_flash_ok_decides_by_head_dim(head_dim, takes):
    """use_flash=None on a CUDA device takes the kernel only for a head
    dim the kernels are instantiated for, decided before any launch;
    the CPU never takes it, and True/False still force either branch."""
    assert ttr.flash_ok(None, "cuda", head_dim) is takes
    assert tfa.flash_kernel_takes(head_dim) is takes
    assert not ttr.flash_ok(None, "cpu", head_dim)
    assert ttr.flash_ok(True, "cuda", head_dim)
    assert not ttr.flash_ok(False, "cuda", head_dim)


def test_flash_attention_on_cpu_is_the_plain_version():
    q, k, v, mask = _case(37, "f32", True, seed=4)
    args = [torch.from_numpy(x) for x in (q, k, v, mask)]
    got = tfa.flash_attention(*args, causal=True, block_q=8, block_k=8)
    ref, _ = tfa.flash_attention_ref(*args, causal=True)
    assert torch.equal(got, ref)


def test_flash_attention_gradient_flows():
    """With grad on, flash_attention is differentiable: the gradient
    reaches q, k and v (through the plain backward on the CPU), and
    under torch.no_grad() the same call builds no graph."""
    q, k, v, mask = _case(16, "f32", True, seed=2)
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*args, torch.from_numpy(mask), causal=True)
    out.sum().backward()
    for t in args:
        assert t.grad is not None and t.grad.shape == t.shape
        assert torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0
    with torch.no_grad():
        assert tfa.flash_attention(*args, causal=True).grad_fn is None
