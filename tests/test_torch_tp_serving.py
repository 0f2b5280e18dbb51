"""Tensor-parallel serving on the port: ``ContinuousEngine(mesh=...)``
over two gloo processes (one a rank, ``_torch_dist_worker.py``) against
the port's one-rank engine and against the JAX engine on the 8-device
CPU mesh at tp=2, on the same flax weights (``params_from_flax``).

The bar is the reference's (``tests/test_mesh_paged.py``,
``test_continuous.py``'s mesh tests): greedy tokens identical at f32 in
every {arena, paged, chunked, speculative} combination, through
admission, chunked prefill, speculative verify, EOS and slot recycling;
one sampled row (not under speculation) equal between tp=2 and tp=1 on
the port (the port's draws are not threefry's, so sampled rows are not
compared with JAX).  The pool and the arena hold each rank's kv heads
(per-rank capacity = total / tp), both int8 leaves shard, and a model
whose kv heads do not divide tp is refused under the default rules and
replicates its cache under the hatch rules.  ``ClusterServing`` on rank
0 answers queue requests as one rank's engine does while rank 1
follows, with one replica and with two.  The port's tp=2 runs
every read through ``paged_attention_fused_tp`` (``kernel="fused"``, its
plain version on the CPU) or the gather.  The speculative combos are in
``test_torch_tp_spec.py``, the fused ones in ``test_torch_tp_fused.py``
and ``test_torch_tp_fused_spec.py`` (one two-rank worker launch a
module, the JAX engines run meanwhile: ``_torch_tp.py``).
"""

import numpy as np
import pytest

from _torch_tp import check_combo, run_module

COMBOS = ("arena", "paged", "chunked", "paged-chunked")


@pytest.fixture(scope="module")
def tp(tmp_path_factory, devices):
    return run_module(tmp_path_factory, COMBOS, True)


@pytest.mark.parametrize("combo", COMBOS)
def test_tp2_matches_tp1_and_jax_tp2(tp, combo):
    check_combo(tp, combo)


@pytest.mark.parametrize("name,key", [("cfg", "lm"),
                                      ("llama_cfg", "llama")])
def test_sharded_logits_match_jax(tp, name, key):
    """The tp=2 model's dense logits (vocab-split lookup and head,
    column/row-parallel projections with the f32 partials all-reduced)
    on both ranks = the reference's forward at 1e-5: the GPT-2 shape
    (tied head, learned positions) and a Llama shape (GQA, rope,
    RMSNorm, SwiGLU, untied head)."""
    inp, ranks, _, models = tp
    jm, jv = models[key]
    want = np.asarray(jm.apply(jv, inp["logit_tokens"]))
    for r in ranks:
        np.testing.assert_allclose(r[("logits", name)].numpy(), want,
                                   atol=1e-5, rtol=0)


def test_pool_sharded_over_tp_and_capacity(tp):
    """Each rank's pool holds its kv heads ([layers, N, KH/tp, bs, D])
    and the capacity report bills per-rank bytes = total / tp; the arena
    likewise ([layers, S, L, KH/tp, D])."""
    _, ranks, _, _ = tp
    for r in ranks:
        shapes, cap = r["shapes"], r["capacity"]
        assert shapes["paged"]["k"][2] == 1          # 2 kv heads / tp 2
        assert shapes["arena"]["k"][3] == 1
        for combo in ("paged", "arena"):
            assert cap[combo]["tp"] == 2
            assert cap[combo]["arena_bytes_per_chip"] * 2 == \
                cap[combo]["arena_bytes"]
            assert cap[combo]["kv_heads"] == 2


def test_mqa_refused_then_hatch_replicates(tp):
    """kv_heads=1 under tp=2: the default rules raise; with the key and
    value kernels replicated the pool (and arena) hold every kv head on
    every rank, per-rank bytes = total, and tokens = one rank's, on the
    gather, the fused read of the whole pool and the arena."""
    _, ranks, _, _ = tp
    for r in ranks:
        assert "kv_heads=1 must divide by tp=2" in r["mqa_error"]
        assert r["shapes"]["mqa-paged"]["k"][2] == 1
        assert r["shapes"]["mqa-arena"]["k"][3] == 1
        cap = r["capacity"]["mqa-paged"]
        assert cap["arena_bytes_per_chip"] == cap["arena_bytes"]
    got = ranks[0]["tokens"]
    for combo in ("mqa-paged", "mqa-fused", "mqa-arena"):
        assert got[(combo, "tp2")] == got[(combo, "tp1")], combo
    assert got[("mqa-paged", "tp1")] == got[("mqa-arena", "tp1")]


def test_cluster_serving_answers_through_a_follower(tp):
    """``ClusterServing(engine_mesh=mesh)``: rank 0's queue answers equal
    one rank's paged engine on the same requests (the engine's budget
    of 5 tokens), while rank 1 follows; the paged engine resolves the
    fused read."""
    ranks = tp[1]
    assert ranks[0]["served"] == ranks[0]["served_solo"]
    assert ranks[0]["served_kernel"] == "fused"


def test_cluster_serving_refuses_replicas_on_a_tp_mesh(tp):
    """``n_replicas=2`` with a tp=2 ``engine_mesh`` serves (it was
    refused before replicas took lanes of their own): two engines on
    each rank share the one sharded model, each with its own control
    and tp groups, and rank 0's queue answers equal one rank's paged
    engine."""
    r0 = tp[1][0]
    assert r0["served_replicas_engines"] == 2
    assert r0["served_replicas"] == r0["served_solo"]
    assert r0["served_replicas_kernel"] == "fused"
