"""The port's TransformerLM paged methods held to the JAX reference.

A GPT-2-shaped tiny config (learned positions, LayerNorm with
``ln_eps=1e-5``, tanh-GELU MLP, biases, tied head), MHA and GQA: the
reference initialises the weights, ``params_from_flax`` carries them
into the port, and the same token/position/table inputs run through
``prefill_chunk_paged`` (two chunks, ragged lengths, the second chunk
attending the first through the pool) and then a few greedy
``decode_step_paged`` steps in both packages.  f32 logits must agree
within 1e-4, the tolerance the reference's own ``hf_net`` parity uses;
the K/V pools the two wrote must agree as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu_torch.models.lm import TransformerLM, params_from_flax

_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64, ln_eps=1e-5)
_ATOL = 1e-4


def _models(num_kv_heads):
    jm = JaxLM(dtype=jnp.float32, num_kv_heads=num_kv_heads, **_CFG)
    variables = jm.init(jax.random.key(3), np.zeros((1, 8), np.int32))
    tm = TransformerLM(dtype=torch.float32, num_kv_heads=num_kv_heads,
                       **_CFG)
    tm.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    return jm, variables, tm


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
