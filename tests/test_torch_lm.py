"""The port's TransformerLM held to the JAX reference.

A GPT-2-shaped tiny config (learned positions, LayerNorm with
``ln_eps=1e-5``, tanh-GELU MLP, biases, tied head), MHA and GQA: the
reference initialises the weights, ``params_from_flax`` carries them
into the port, and the same inputs run through both packages:

- the dense forward and ``prefill`` (logits and K/V), with the flash
  branch forced (``use_flash=True``: the reference's Pallas kernel in
  interpret mode, the port's plain version of its CUDA kernel) and with
  the default dispatch (plain full attention on the CPU in both);
- the slot-arena methods: ``prefill_chunk`` (two ragged chunks),
  greedy ``decode_step`` at per-row positions and a ``verify_hidden``
  of three tokens per row, and the caches they wrote;
- the training forward and :func:`lm_loss`, and every parameter's
  gradient against ``jax.value_and_grad`` (flash forced and default);
- greedy :func:`generate` with ragged prompt lengths and an ``eos_id``;
- the paged methods: ``prefill_chunk_paged`` (two chunks, the second
  attending the first through the pool) and ``decode_step_paged``.

f32 logits must agree within 1e-4, the tolerance the reference's own
``hf_net`` parity uses; generated tokens must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.models.lm import generate as jax_generate
from analytics_zoo_tpu.models.lm import lm_loss as jax_lm_loss
from analytics_zoo_tpu_torch.models.lm import (TransformerLM, generate,
                                               lm_loss, params_from_flax)

_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64, ln_eps=1e-5)
_ATOL = 1e-4


def _models(num_kv_heads, use_flash=None):
    jm = JaxLM(dtype=jnp.float32, num_kv_heads=num_kv_heads,
               use_flash=use_flash, **_CFG)
    variables = jm.init(jax.random.key(3), np.zeros((1, 8), np.int32))
    tm = TransformerLM(dtype=torch.float32, num_kv_heads=num_kv_heads,
                       use_flash=use_flash, **_CFG)
    tm.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    return jm, variables, tm


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=_ATOL,
                               rtol=0)


@pytest.mark.parametrize("num_kv_heads", [None, 2])
@pytest.mark.parametrize("use_flash", [True, None])
def test_forward_and_prefill_match_jax(num_kv_heads, use_flash):
    jm, variables, tm = _models(num_kv_heads, use_flash)
    toks = np.random.default_rng(1).integers(1, 64, (2, 11)).astype(
        np.int32)
    with torch.no_grad():
        logits = tm(torch.from_numpy(toks))
        pl, pk, pv = tm.prefill(torch.from_numpy(toks))
    _close(logits, jm.apply(variables, toks))
    jl, jk, jv = jm.apply(variables, toks, method=JaxLM.prefill)
    kh = num_kv_heads or _CFG["num_heads"]
    assert pk.shape == (2, 2, 11, kh, 8)        # pre-expansion kv heads
    for got, ref in ((pl, jl), (pk, jk), (pv, jv)):
        _close(got, ref)
    with pytest.raises(ValueError, match="max_position"):
        tm.prefill(torch.zeros((1, 65), dtype=torch.int32))


# Gradients: f32 on both sides, summed in another order (and, with the
# flash branch, through the blockwise Pallas backward on the JAX side
# against the one-pass plain version here): a few f32 ulps of gradients
# of order 1e-2..1.
_GRAD_ATOL = 1e-5


@pytest.mark.parametrize("num_kv_heads", [None, 2])
@pytest.mark.parametrize("use_flash", [True, None])
def test_lm_loss_and_grads_match_jax(num_kv_heads, use_flash):
    """The training forward (``train=True``) and ``lm_loss``, and the
    gradient of every parameter, against ``jax.value_and_grad`` of the
    reference's ``lm_loss``; ``use_flash=True`` runs the reference's
    Pallas backward in interpret mode and the port's
    ``_FlashAttention`` with its plain versions."""
    jm, variables, tm = _models(num_kv_heads, use_flash)
    toks = np.random.default_rng(4).integers(0, 64, (2, 11)).astype(
        np.int32)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jax_lm_loss(jm.apply({"params": p}, toks, train=True),
                              toks))(variables["params"])
    loss = lm_loss(tm(torch.from_numpy(toks), train=True),
                   torch.from_numpy(toks))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, ref_grads))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   atol=_GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("num_kv_heads", [None, 2])
def test_arena_methods_match_jax(num_kv_heads):
    jm, variables, tm = _models(num_kv_heads)
    B, L = 2, 24
    shape = (2, B, L, tm.kv_heads, 8)
    ck_t, cv_t = torch.zeros(shape), torch.zeros(shape)
    ck_j, cv_j = jnp.zeros(shape), jnp.zeros(shape)
    rng = np.random.default_rng(2)

    def both(method, *args):
        nonlocal ck_j, cv_j
        with torch.no_grad():
            out_t = getattr(tm, method)(torch.from_numpy(args[0]), ck_t,
                                        cv_t, *map(torch.from_numpy,
                                                   args[1:]))
        out_j, ck_j, cv_j = jm.apply(variables, args[0], ck_j, cv_j,
                                     *args[1:],
                                     method=getattr(JaxLM, method))
        _close(out_t, out_j)
        return np.asarray(out_j)

    pos = np.zeros(B, np.int32)
    for lens in (np.array([8, 5], np.int32), np.array([3, 7], np.int32)):
        toks = rng.integers(1, 64, (B, 8)).astype(np.int32)
        lj = both("prefill_chunk", toks, pos, lens)
        pos = pos + lens
    tok = np.argmax(lj, -1).astype(np.int32)
    for _ in range(3):
        lj = both("decode_step", tok, pos)
        tok = np.argmax(lj, -1).astype(np.int32)
        pos = pos + 1
    both("verify_hidden", rng.integers(1, 64, (B, 3)).astype(np.int32),
         pos)
    _close(ck_t, ck_j)
    _close(cv_t, cv_j)


@pytest.mark.parametrize("num_kv_heads", [None, 2])
def test_generate_matches_jax(num_kv_heads):
    jm, variables, tm = _models(num_kv_heads)
    prompt = np.random.default_rng(3).integers(1, 64, (3, 9)).astype(
        np.int32)
    plen = np.array([9, 4, 1], np.int32)
    free = np.asarray(jax_generate(jm, variables, prompt, 8, plen))
    eos = int(free[0, 2])       # a token the greedy stream really emits
    ref = np.asarray(jax_generate(jm, variables, prompt, 8, plen,
                                  eos_id=eos))
    got = generate(tm, None, prompt, 8, plen, eos_id=eos, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[0, 3:] == eos).all()            # row 0 froze at eos
    with pytest.raises(NotImplementedError, match="not ported"):
        generate(tm, None, prompt, 8, temperature=0.7, device="cpu")


def _pools(model, N, bs):
    D = model.hidden_size // model.num_heads
    shape = (model.num_layers, N, model.kv_heads, bs, D)
    return torch.zeros(shape), torch.zeros(shape)


@pytest.mark.parametrize("num_kv_heads", [None, 2])
def test_paged_prefill_and_decode_match_jax(num_kv_heads):
    jm, variables, tm = _models(num_kv_heads)
    B, bs, M = 2, 4, 6
    pk_t, pv_t = _pools(tm, 1 + B * M, bs)
    pk_j, pv_j = jnp.asarray(pk_t.numpy()), jnp.asarray(pv_t.numpy())
    tables = (1 + np.arange(B * M)).reshape(B, M).astype(np.int32)
    rng = np.random.default_rng(0)

    def both(method, *args, **kw):
        """Run one paged method in both packages on the same numpy
        args; returns (torch out, jax out) and keeps both pools."""
        nonlocal pk_j, pv_j
        targs = [torch.from_numpy(a) for a in args]
        out_t = getattr(tm, method)(targs[0], pk_t, pv_t, *targs[1:], **kw)
        out_j, pk_j, pv_j = jm.apply(
            variables, args[0], pk_j, pv_j, *args[1:], kernel="gather",
            method=getattr(JaxLM, method))
        return out_t, np.asarray(out_j)

    pos = np.zeros(B, np.int32)
    for lens in (np.array([8, 5], np.int32), np.array([3, 7], np.int32)):
        toks = rng.integers(1, 64, (B, 8)).astype(np.int32)
        with torch.no_grad():
            lt, lj = both("prefill_chunk_paged", toks, tables, pos, lens)
        np.testing.assert_allclose(lt.numpy(), lj, atol=_ATOL, rtol=0)
        pos = pos + lens
    tok = np.argmax(lj, -1).astype(np.int32)
    for _ in range(3):
        with torch.no_grad():
            lt, lj = both("decode_step_paged", tok, tables, pos)
        assert lt.shape == (B, _CFG["vocab_size"])
        np.testing.assert_allclose(lt.numpy(), lj, atol=_ATOL, rtol=0)
        tok = np.argmax(lj, -1).astype(np.int32)
        pos = pos + 1
    np.testing.assert_allclose(pk_t.numpy(), np.asarray(pk_j), atol=_ATOL)
    np.testing.assert_allclose(pv_t.numpy(), np.asarray(pv_j), atol=_ATOL)


@pytest.mark.parametrize("kw", [dict(pos_encoding="rope"),
                                dict(norm="rmsnorm"), dict(mlp="swiglu"),
                                dict(tied_head=False),
                                dict(moe_experts=4)])
def test_later_slice_configs_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerLM(dtype=torch.float32, **_CFG, **kw)
