"""The host KV tier and the prefix directory on a tensor-parallel mesh:
two gloo processes (``_torch_dist_worker.py`` scenario ``tier``) against
the port's one-rank engine and against the JAX engine on the conftest's
CPU mesh at tp=2, on the same flax weights.

The reference's host-tier pins (``tests/test_kv_store.py``: spill and
readmit with greedy parity, the dry-pool rollback, the directory's
publish and retract) run on tp ranks: each rank spills and readmits
its own kv-head shard, every rank's store counts whole blocks, so the
spill, readmit and saved-token counts and every tick's flight deltas
equal the one-rank engine's and the reference's, and only the leader
publishes to the directory.  Handoff and replicas under tp are in
``test_torch_tp_fleet.py``.
"""

import numpy as np
import pytest

from analytics_zoo_tpu.parallel.mesh import make_mesh
from analytics_zoo_tpu.serving.continuous import \
    ContinuousEngine as JaxEngine

from _torch_dist import Ranks
from _torch_tp import PA, PB, PC, tier_inputs

_SEQ = (("a0", PA), ("b", PB), ("c", PC), ("a1", PA))
_COUNTS = ("kv_spills", "kv_readmits", "kv_readmit_tokens_saved")
_TIERS = [(kv, extra) for kv in ("bf16", "int8")
          for extra in ("paged", "chunked")]


def _jax_tier(jm, jv, mesh, kv, extra):
    kw = dict(chunked=True, tick_token_budget=8) if extra == "chunked" \
        else {}
    eng = JaxEngine(jm, jv, mesh=mesh, max_new_tokens=4, max_slots=2,
                    prompt_buckets=(8, 16), paged=True, block_size=4,
                    n_blocks=8, kv_dtype=kv, kv_host_store_bytes=1 << 20,
                    **kw)
    got = {}
    for u, p in _SEQ:
        eng.submit(u, p, on_done=lambda uri, t: got.__setitem__(
            uri, np.asarray(t).tolist()))
        eng.drain()
    m = eng.cache_metrics()
    return got, {k: m[k] for k in _COUNTS}


@pytest.fixture(scope="module")
def tier(tmp_path_factory, devices):
    outdir = tmp_path_factory.mktemp("tier")
    inp, jm, jv = tier_inputs(outdir)
    workers = Ranks("tier", outdir, 2)
    mesh = make_mesh(axes={"dp": -1, "tp": 2})
    ref = {"tier": {t: _jax_tier(jm, jv, mesh, *t) for t in _TIERS}}
    return inp, workers.wait(), ref


@pytest.mark.parametrize("kv,extra", _TIERS)
def test_tp2_spill_readmit_matches_tp1_and_jax(tier, kv, extra):
    """``test_engine_spill_readmit_greedy_parity`` on tp ranks: a0's
    chain spills while b and c churn the 8-block pool and a1 readmits
    it.  Tokens equal tp=2 without a tier, the one-rank engine's and the
    reference's; every rank counts the reference's spills, readmits and
    saved tokens, the one-rank engine's spilled and stored bytes (whole
    blocks), and its flight deltas tick by tick."""
    _, ranks, ref = tier
    jtoks, jcounts = ref["tier"][(kv, extra)]
    one = ranks[0]["tier"][(kv, extra, "tp1")]
    bare = ranks[0]["tier"][(kv, extra, "tp2_bare")]
    assert bare["tokens"] == one["tokens"] == jtoks
    assert jtoks["a1"] == jtoks["a0"]
    assert jcounts["kv_spills"] >= 3 and jcounts["kv_readmits"] >= 1
    for r in ranks:
        got = r["tier"][(kv, extra, "tp2")]
        if r is ranks[0]:
            assert got["tokens"] == jtoks
        assert {k: got["metrics"][k] for k in _COUNTS} == jcounts
        assert got["metrics"] == one["metrics"]
        assert got["flight"] == one["flight"]
        assert all(got["stored"])


def test_tp2_dry_pool_readmit_rolls_back(tier):
    """A store hit that meets a dry pool adopts nothing and leaves every
    rank's store whole (the reference's rollback pin)."""
    for r in tier[1]:
        for t in _TIERS:
            assert r["tier"][t + ("tp2",)]["dry"] == ([], True)


def test_tp2_directory_leader_publishes_and_retracts(tier):
    """The leader mirrors both tiers into the directory as one rank does
    (HBM at insert, host after the spill, the host claim retracted when
    the store drops the block); the follower publishes nothing."""
    lead, follow = tier[1]
    for t in _TIERS:
        got = lead["tier"][t + ("tp2",)]
        one = lead["tier"][t + ("tp1",)]
        hbm = got["hbm_claim"]
        assert got["claims"][0] == {3: hbm}
        assert got["claims"][2] == {3: "host"}
        assert got["claims"] == one["claims"]
        assert got["after_pop"] == one["after_pop"]
        assert got["directory"] == one["directory"]
        fol = follow["tier"][t + ("tp2",)]
        assert fol["directory"]["publishes"] == 0
        assert fol["claims"] == []
