"""Sequence-parallel attention on the port: ``parallel.ring_attention``'s
ring and ulysses paths on gloo ranks (``_torch_dist_worker.py`` scenario
``ring``, eight ranks, one launch for the module) against the
reference's ``full_attention`` and ``ring_self_attention`` on the
8-device CPU mesh, outputs and (q, k, v) gradients (``jax.vjp``), at
sp=2 and sp=4, causal and not, with and without a padding mask; the
reference's ``ValueError`` for heads that sp does not divide; an unknown
strategy failing on a mesh without sp; BERT on a dp2 x sp2 x tp2 mesh
(``BERT_PARTITION_RULES``) against the reference's dp-only BERT at 2e-4
(``tests/test_transformer.py::test_bert_mesh_equivalence``); the LM's
causal ring on dp2 x sp4 against one device
(``tests/test_lm.py::test_sp_ring_causal_training_matches_single_device``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from analytics_zoo_tpu.models import BERT as JaxBERT
from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.parallel.mesh import make_mesh as jax_mesh
from analytics_zoo_tpu.parallel.ring_attention import (
    full_attention as jax_full, ring_self_attention as jax_ring)
from analytics_zoo_tpu_torch.models import lm as tlm
from analytics_zoo_tpu_torch.models import transformer as ttr
from analytics_zoo_tpu_torch.parallel.mesh import Mesh
from analytics_zoo_tpu_torch.parallel.ring_attention import \
    ring_self_attention

from _torch_dist import Ranks

_B, _T, _H, _D = 2, 16, 4, 8
_BERT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position=64)
_LM = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_position=64, dropout=0.0)
_TOL = 1e-5


def _seeded(model, sample, seed):
    """The reference's parameter tree for ``model`` (its shapes from
    ``jax.eval_shape``, no init compile) filled with seeded normals:
    0.05 x N(0, 1), norm scales around 1."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0),
                                               sample))["params"]
    rng = np.random.default_rng(seed)

    def one(path, a):
        x = 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return x + 1.0 if path[-1].key == "scale" else x
    return jax.tree_util.tree_map_with_path(one, shapes)


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("ring")
    g = np.random.default_rng(0)
    q, k, v, dout = (g.standard_normal((_B, _T, _H, _D)).astype(np.float32)
                     for _ in range(4))
    mask = g.random((_B, _T)) > 0.3
    mask[:, 0] = True
    ids = g.integers(0, 128, (4, 16)).astype(np.int32)
    amask = (np.random.default_rng(2).random((4, 16)) > 0.2).astype(
        np.int32)
    jb = JaxBERT(**_BERT, dtype=jnp.float32)
    bert_params = _seeded(jb, ids, 1)
    jl = JaxLM(**_LM, dtype=jnp.float32)
    toks = g.integers(0, 32, (4, 16)).astype(np.int32)
    lm_params = _seeded(jl, toks, 2)
    torch.save({"q": q, "k": k, "v": v, "g": dout, "mask": mask,
                "ids": ids, "amask": amask, "bert_cfg": _BERT,
                "bert_state": ttr.params_from_flax(bert_params),
                "lm_cfg": dict(_LM, dtype=torch.float32),
                "lm_state": tlm.params_from_flax(lm_params), "toks": toks},
               outdir / "ring_in.pt")
    ranks = Ranks("ring", outdir, 8)
    # the reference's side runs while the ranks do
    want = {}
    for causal in (False, True):
        for masked in (False, True):
            m = jnp.asarray(mask) if masked else None
            o, vjp = jax.vjp(lambda a, b, c: jax_full(a, b, c, m,
                                                      causal=causal),
                             jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            want[(causal, masked)] = [np.asarray(o)] + [
                np.asarray(t) for t in vjp(jnp.asarray(dout))]
    bert = jb.apply({"params": bert_params}, ids, attention_mask=amask)
    lm = jl.apply({"params": lm_params}, toks)
    port_lm = tlm.TransformerLM(**_LM, dtype=torch.float32)
    port_lm.load_state_dict(tlm.params_from_flax(lm_params))
    with torch.no_grad():
        one = port_lm(torch.from_numpy(toks)).numpy()
    got = ranks.wait()[0]
    return got, want, (q, k, v, mask), bert, (lm, one)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_outputs_and_grads_match_reference(ring, sp, strategy, causal,
                                           masked):
    got, want, _, _, _ = ring
    for name, a, b in zip(("out", "dq", "dk", "dv"),
                          got[(sp, strategy, causal, masked)],
                          want[(causal, masked)]):
        np.testing.assert_allclose(a.numpy(), b, atol=_TOL, rtol=_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("sp,strategy,causal,masked", [
    (4, "ring", True, True)])
def test_port_equals_reference_ring(ring, devices, sp, strategy, causal,
                                    masked):
    """The reference's own shard_map ring/ulysses on an sp mesh of its
    CPU devices, the global arrays sharded on the sequence, gives what
    the port's ranks gave."""
    got, _, (q, k, v, mask), _, _ = ring
    mesh = jax_mesh(axes={"sp": sp}, devices=devices[:sp])
    spec = NamedSharding(mesh, JP(None, "sp"))
    args = [jax.device_put(jnp.asarray(t), spec) for t in (q, k, v)]
    m = jax.device_put(jnp.asarray(mask), spec) if masked else None
    o = jax_ring(*args, mesh, m, causal=causal, strategy=strategy)
    np.testing.assert_allclose(got[(sp, strategy, causal, masked)][0],
                               np.asarray(o), atol=_TOL, rtol=_TOL)


def test_ulysses_heads_must_divide_sp(ring):
    got = ring[0]
    for sp in (2, 4):
        assert "ulysses needs heads (3) divisible by the sp axis" in \
            got[("ulysses_heads", sp)]


def test_unknown_strategy_fails_without_sp():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="unknown sp strategy 'rnig'"):
        ring_self_attention(q, q, q, Mesh({"dp": 1}, "cpu"), strategy="rnig")
    with pytest.raises(ValueError, match="unknown sp strategy"):
        ttr.BERT(**_BERT, sp_strategy="rnig")


def test_bert_dp_sp_tp_mesh_equals_reference(ring):
    """dp2 x sp2 x tp2 (ring attention, Megatron shards) = the
    reference's dp-only BERT on the same weights and inputs."""
    seq, pooled = ring[0]["bert"]
    want_seq, want_pooled = ring[3]
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               atol=2e-4, rtol=2e-4)


def test_lm_causal_ring_equals_one_device(ring):
    logits = ring[0]["lm"].numpy()
    want, one = ring[4]
    np.testing.assert_allclose(logits, one, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(logits, np.asarray(want), atol=2e-4,
                               rtol=2e-4)
