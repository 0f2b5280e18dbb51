"""The port's Llama-family TransformerLM held to the JAX reference.

The grid {MHA, GQA} x {learned positions, rope} x {LayerNorm + tanh-GELU,
RMSNorm + SwiGLU} x {tied, untied head} x {biases, ``use_bias=False``,
``use_bias=False`` + ``qkv_bias=True``} at a tiny width: the reference
initialises each config, every parameter is then moved off its
initial value by seeded noise (flax starts biases at 0 and norm scales
at 1, which would hide a bias or scale mapped to the wrong place), and
``params_from_flax`` carries the weights into the port.  On the same
inputs, the port must give, at f32:

- the dense forward's logits and ``prefill``'s logits and (rotated) K/V;
- ``lm_loss`` and every parameter's gradient;
- the slot-arena methods (two ragged ``prefill_chunk`` calls, greedy
  ``decode_step`` at per-row positions, ``verify_hidden``) and the
  caches they wrote;
- the paged trio (``prefill_chunk_paged`` twice, ``decode_step_paged``,
  ``verify_hidden_paged``) and the pools they wrote;
- greedy ``generate`` tokens, with ragged prompt lengths.

Logits and caches within 1e-4 (the tolerance of the reference's own
``hf_net`` parity), gradients within 1e-5, tokens identical.  One
Llama config also runs the flash branch forced on both sides (the
Pallas kernels in interpret mode, the port's plain versions).
"""

import itertools

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

_BASE = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=48, max_position=64, ln_eps=1e-5)
_BLOCKS = {"ln-gelu": dict(norm="layernorm", mlp="gelu"),
           "rms-swiglu": dict(norm="rmsnorm", mlp="swiglu")}
_BIASES = {"bias": {}, "nobias": dict(use_bias=False),
           "qkvbias": dict(use_bias=False, qkv_bias=True)}
_GRID = list(itertools.product((None, 2), ("learned", "rope"), _BLOCKS,
                               (True, False), _BIASES))
_IDS = [f"kv{kvh or 4}-{pos}-{block}-{'tied' if tied else 'untied'}-{b}"
        for kvh, pos, block, tied, b in _GRID]
_ATOL = 1e-4
_GRAD_ATOL = 1e-5


def _config(kvh, pos, block, tied, bias):
    cfg = dict(_BASE, num_kv_heads=kvh, pos_encoding=pos, tied_head=tied,
               **_BLOCKS[block], **_BIASES[bias])
    if pos == "rope":
        cfg["rope_base"] = 500.0
    return cfg


def _models(cfg, use_flash=None, seed=0):
    """(reference model, its perturbed variables, the port's model with
    the same weights)."""
    jm = JaxLM(dtype=jnp.float32, use_flash=use_flash, **cfg)
    params = jm.init(jax.random.key(seed),
                     np.zeros((1, 8), np.int32))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), params)
    tm = TransformerLM(dtype=torch.float32, use_flash=use_flash, **cfg)
    tm.load_state_dict(params_from_flax(params))
    return jm, {"params": params}, tm


def _close(got, ref, atol=_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=0)


def _forward_and_grads(cfg, use_flash=None):
    jm, variables, tm = _models(cfg, use_flash)
    toks = np.random.default_rng(1).integers(0, 64, (2, 11)).astype(
        np.int32)
    with torch.no_grad():
        logits = tm(torch.from_numpy(toks))
        pl, pk, pv = tm.prefill(torch.from_numpy(toks))
    _close(logits.numpy(), jm.apply(variables, toks))
    jl, jk, jv = jm.apply(variables, toks, method=JaxLM.prefill)
    for got, ref in ((pl, jl), (pk, jk), (pv, jv)):
        _close(got.numpy(), ref)
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
        _close(got[name].grad.numpy(), g.numpy(), _GRAD_ATOL)


@pytest.mark.parametrize("kvh,pos,block,tied,bias", _GRID, ids=_IDS)
def test_forward_loss_and_grads_match_jax(kvh, pos, block, tied, bias):
    _forward_and_grads(_config(kvh, pos, block, tied, bias))


def test_llama_flash_branch_matches_jax():
    """rope + RMSNorm + SwiGLU + GQA + untied head, bias-free, with the
    flash branch forced: the reference's Pallas forward and backward in
    interpret mode against the port's plain versions of its kernels."""
    _forward_and_grads(_config(2, "rope", "rms-swiglu", False, "nobias"),
                       use_flash=True)


def _arena(jm, variables, tm):
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
        _close(out_t.numpy(), out_j)
        return np.asarray(out_j)

    pos = np.zeros(B, np.int32)
    for lens in (np.array([8, 5], np.int32), np.array([3, 7], np.int32)):
        lj = both("prefill_chunk", rng.integers(1, 64, (B, 8)).astype(
            np.int32), pos, lens)
        pos = pos + lens
    tok = np.argmax(lj, -1).astype(np.int32)
    for _ in range(3):
        lj = both("decode_step", tok, pos)
        tok = np.argmax(lj, -1).astype(np.int32)
        pos = pos + 1
    both("verify_hidden", rng.integers(1, 64, (B, 3)).astype(np.int32),
         pos)
    _close(ck_t.numpy(), ck_j)
    _close(cv_t.numpy(), cv_j)


def _paged(jm, variables, tm):
    B, bs, M = 2, 4, 6
    shape = (2, 1 + B * M, tm.kv_heads, bs, 8)
    pk_t, pv_t = torch.zeros(shape), torch.zeros(shape)
    pk_j, pv_j = jnp.zeros(shape), jnp.zeros(shape)
    tables = (1 + np.arange(B * M)).reshape(B, M).astype(np.int32)
    rng = np.random.default_rng(0)

    def both(method, *args, **kw):
        nonlocal pk_j, pv_j
        targs = [torch.from_numpy(a) for a in args]
        with torch.no_grad():
            out_t = getattr(tm, method)(targs[0], pk_t, pv_t, *targs[1:],
                                        **kw)
        out_j, pk_j, pv_j = jm.apply(
            variables, args[0], pk_j, pv_j, *args[1:], kernel="gather",
            method=getattr(JaxLM, method))
        _close(out_t.numpy(), out_j)
        return np.asarray(out_j)

    pos = np.zeros(B, np.int32)
    for lens in (np.array([8, 5], np.int32), np.array([3, 7], np.int32)):
        lj = both("prefill_chunk_paged", rng.integers(1, 64, (B, 8)).astype(
            np.int32), tables, pos, lens)
        pos = pos + lens
    tok = np.argmax(lj, -1).astype(np.int32)
    for _ in range(3):
        lj = both("decode_step_paged", tok, tables, pos)
        tok = np.argmax(lj, -1).astype(np.int32)
        pos = pos + 1
    both("verify_hidden_paged", rng.integers(1, 64, (B, 3)).astype(
        np.int32), tables, pos)
    _close(pk_t.numpy(), pk_j)
    _close(pv_t.numpy(), pv_j)


@pytest.mark.parametrize("kvh,pos,block,tied,bias", _GRID, ids=_IDS)
def test_cached_paths_and_generate_match_jax(kvh, pos, block, tied, bias):
    jm, variables, tm = _models(_config(kvh, pos, block, tied, bias))
    _arena(jm, variables, tm)
    _paged(jm, variables, tm)
    prompt = np.random.default_rng(3).integers(1, 64, (3, 9)).astype(
        np.int32)
    plen = np.array([9, 4, 1], np.int32)
    ref = np.asarray(jax_generate(jm, variables, prompt, 8, plen))
    got = generate(tm, None, prompt, 8, plen, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_rope_rotates_at_absolute_positions():
    """The cached K of a rope model is the post-rotation K: the same
    token at two positions caches two different keys, and the dense
    forward's K equals what the arena caches at those positions."""
    cfg = _config(2, "rope", "rms-swiglu", False, "nobias")
    _, _, tm = _models(cfg)
    toks = torch.tensor([[5, 5, 5, 5]], dtype=torch.int32)
    with torch.no_grad():
        _, ks, _ = tm.prefill(toks)
        ck = torch.zeros((2, 1, 8, tm.kv_heads, 8))
        cv = torch.zeros_like(ck)
        tm.verify_hidden(toks, ck, cv, torch.zeros(1, dtype=torch.int32))
    assert not torch.allclose(ks[0, 0, 0], ks[0, 0, 1])
    torch.testing.assert_close(ck[:, :, :4], ks, rtol=0, atol=1e-6)


def test_odd_head_dim_raises_under_rope():
    tm = TransformerLM(dtype=torch.float32, **dict(
        _BASE, hidden_size=36, num_heads=4, pos_encoding="rope"))
    with pytest.raises(ValueError, match="even head dim"):
        tm(torch.zeros((1, 4), dtype=torch.int32))
