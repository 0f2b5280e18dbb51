"""The port's host KV tier, fleet prefix directory and elastic pool held
to the JAX engine.

Tiny f32 models, the same seeded weights in both packages
(``params_from_flax``), paged engines on the CPU.  The host tier: a
prompt runs cold, two disjoint prompts churn the small pool until the
first one's cached chain is evicted and spilled to the host store, and
the prompt runs again, readmitted host to device; tokens must equal the
cold run's and the reference's, and the spill, readmit and saved-token
counters and every tick's flight deltas must equal the reference's, in
bf16 and int8 pools, monolithic and chunked.  A dry pool's readmit
rolls back and leaves the store whole; the directory mirrors both tiers
and retracts host claims on store eviction.  The elastic pool: the same
floor, ceiling and step as the reference, resizes between steps with
residents on a dry pool (grow, shrink clamped at the eviction
boundary) give the reference's tokens, clamps and pool sizes, with
every table entry inside the pool, and ``maybe_autoresize`` walks the
reference's control loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.serving.continuous import \
    ContinuousEngine as JaxEngine
from analytics_zoo_tpu.serving.kv_store import \
    PrefixDirectory as JaxDirectory
from analytics_zoo_tpu_torch.models.lm import (TransformerLM, generate,
                                               params_from_flax)
from analytics_zoo_tpu_torch.ops.flash_attention import QuantKV
from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine
from analytics_zoo_tpu_torch.serving.kv_store import (PrefixDirectory,
                                                      TIER_HBM, TIER_HOST)
from analytics_zoo_tpu_torch.serving.telemetry import render_prometheus

_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64, ln_eps=1e-5)
_TIER = dict(max_new_tokens=4, max_slots=2, prompt_buckets=(8, 16),
             paged=True, block_size=4, n_blocks=8)
_PA = np.arange(1, 14, dtype=np.int32)          # 13 tokens, 3 full blocks
_PB = np.arange(15, 28, dtype=np.int32)         # disjoint head
_PC = np.array([2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26],
               np.int32)
_KV_FLIGHT = ("kind", "decode_uris", "prefill_uris", "preempted",
              "used_blocks", "n_blocks", "pool_resizes", "kv_spills",
              "kv_readmits", "alloc_failures")


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(dtype=jnp.float32, num_kv_heads=2, **_CFG)
    variables = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    state = params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    tm = TransformerLM(dtype=torch.float32, num_kv_heads=2, **_CFG)
    tm.load_state_dict(state)
    return jm, variables, tm, state


def _engines(models, jkw=None, tkw=None, **kw):
    jm, jv, tm, state = models
    return (JaxEngine(jm, jv, **kw, **(jkw or {})),
            ContinuousEngine(tm, state, device="cpu", **kw, **(tkw or {})))


def _collect(results):
    return lambda u, t: results.__setitem__(u, np.asarray(t))


def _flight(eng):
    return [tuple(r.get(k) for k in _KV_FLIGHT)
            for r in eng.flight.snapshot()]


def _pool_len(eng) -> int:
    """Blocks in the device pool of either package (an int8 pool's data
    and scales must both follow the resize)."""
    pk = eng._pk
    if type(pk).__name__ == "QuantKV":
        assert pk.scale.shape[1] == pk.data.shape[1]
        pk = pk.data
    return pk.shape[1]


def _tier_run(eng, uris=("a0", "b", "c", "a1")):
    results = {}
    prompts = {"a0": _PA, "b": _PB, "c": _PC, "a1": _PA}
    for uri in uris:
        eng.submit(uri, prompts[uri], on_done=_collect(results))
        eng.drain()
    return results


def test_store_knob_validation(models):
    """The reference's knob errors: the tier needs a paged engine, a
    non-negative size and no draft; the elastic pool needs paged."""
    tm, state = models[2], models[3]
    kw = dict(max_new_tokens=4, max_slots=2, prompt_buckets=(8,),
              device="cpu")
    with pytest.raises(ValueError, match="require"):
        ContinuousEngine(tm, state, kv_host_store_bytes=1 << 20, **kw)
    with pytest.raises(ValueError, match="require"):
        ContinuousEngine(tm, state, prefix_directory=PrefixDirectory(),
                         **kw)
    with pytest.raises(ValueError, match=">= 0"):
        ContinuousEngine(tm, state, paged=True, block_size=4,
                         kv_host_store_bytes=-1, **kw)
    with pytest.raises(ValueError, match="draft"):
        ContinuousEngine(tm, state, paged=True, block_size=4,
                         kv_host_store_bytes=1 << 20, draft_model=tm,
                         draft_variables=state, speculation_k=2, **kw)
    with pytest.raises(ValueError, match="elastic_pool"):
        ContinuousEngine(tm, state, elastic_pool=True, **kw)
    eng = ContinuousEngine(tm, state, paged=True, block_size=4, **kw)
    text = render_prometheus(eng.telemetry.metrics)
    for name in ("zoo_engine_kv_spill_chains_total",
                 "zoo_engine_kv_readmit_tokens_saved_total",
                 "zoo_engine_kv_store_bytes", "zoo_engine_handoffs_in_total",
                 "zoo_engine_pool_resize_total"):
        assert name in text, name
    m = eng.cache_metrics()
    assert m["kv_spills"] == m["kv_readmits"] == m["kv_store_bytes"] == 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("extra", [{}, {"chunked": True,
                                        "tick_token_budget": 8}],
                         ids=["paged", "chunked"])
def test_spill_readmit_matches_jax(models, kv_dtype, extra):
    """Cold run, churn until the chain spills, warm run readmitted from
    the host: warm = cold = the reference's tokens, the store keeps its
    copies, and the counters, gauges and per-tick flight deltas (which
    sum to the counters) equal the reference's.  int8 pools spill and
    readmit their scales with their data."""
    jeng, teng = _engines(models, kv_dtype=kv_dtype,
                          kv_host_store_bytes=1 << 20, **_TIER, **extra)
    ref, got = _tier_run(jeng), _tier_run(teng)
    for uri in ref:
        np.testing.assert_array_equal(got[uri], ref[uri], err_msg=uri)
    np.testing.assert_array_equal(got["a1"], got["a0"])
    assert teng._kv_spills >= 3 and teng._kv_readmits >= 1
    hs = teng._pool.block_hashes([int(t) for t in _PA])
    assert any(h in teng._kv_store for h in hs)
    payload = teng._kv_store.probe(hs[:1])[0][1]
    assert isinstance(payload["k"], QuantKV) == (kv_dtype == "int8")
    teng._pool.check()
    assert teng._pool.num_referenced() == 0
    jm_, tm_ = jeng.cache_metrics(), teng.cache_metrics()
    for key in ("kv_spills", "kv_spill_bytes", "kv_readmits",
                "kv_readmit_tokens_saved", "kv_store_bytes", "evictions",
                "prefix_hits"):
        assert tm_[key] == jm_[key], key
    assert _flight(teng) == _flight(jeng)
    ticks = [r for r in teng.flight.snapshot() if "used_blocks" in r]
    assert sum(r["kv_spills"] for r in ticks) == teng._kv_spills
    assert sum(r["kv_readmits"] for r in ticks) == teng._kv_readmits
    snap = teng.telemetry.metrics.snapshot()
    assert snap["zoo_engine_kv_readmit_chains_total"] == teng._kv_readmits
    if kv_dtype == "bf16" and not extra:
        plain = generate(models[2], None, _PA[None], 4, device="cpu")[0]
        np.testing.assert_array_equal(got["a0"], plain.numpy())


def test_dry_pool_readmit_rolls_back_and_store_survives(models):
    """A probe hit followed by a dry-pool adoption changes nothing:
    ``_store_readmit`` returns [] and the host copies stay."""
    _, eng = _engines(models, kv_host_store_bytes=1 << 20, **_TIER)
    _tier_run(eng, ("a0", "b", "c"))
    hs = eng._pool.block_hashes([int(t) for t in _PA])
    assert all(h in eng._kv_store for h in hs)
    held = []
    with eng._pool_lock:
        while True:
            blk = eng._pool.allocate()
            if blk is None:
                break
            held.append(blk)
        before, readmits = len(eng._kv_store), eng._kv_readmits
        assert eng._store_readmit(hs, 0, len(hs)) == []
        assert eng._kv_readmits == readmits
        assert len(eng._kv_store) == before
        assert all(h in eng._kv_store for h in hs)
        for blk in held:
            eng._pool.release(blk)
    eng._drain_spills()
    eng._pool.check()


def test_directory_publish_spill_retract_matches_jax(models):
    """Insert publishes the device tier, eviction republishes as host
    (spill first, then the device retraction), a store eviction
    retracts the host claim: the directory's view equals the
    reference's at every step."""
    jd, td = JaxDirectory(), PrefixDirectory()
    jeng, teng = _engines(models, jkw=dict(prefix_directory=jd),
                          tkw=dict(prefix_directory=td),
                          kv_host_store_bytes=1 << 20, replica_id=3,
                          **_TIER)
    hs = teng._pool.block_hashes([int(t) for t in _PA])
    _tier_run(jeng, ("a0",))
    _tier_run(teng, ("a0",))
    assert td.lookup(hs[0]) == jd.lookup(hs[0]) == {3: TIER_HBM}
    _tier_run(jeng, ("b", "c"))
    _tier_run(teng, ("b", "c"))
    assert td.lookup(hs[0]) == jd.lookup(hs[0]) == {3: TIER_HOST}
    assert td.match_depths(hs) == jd.match_depths(hs) == {3: len(hs)}
    assert td.metrics() == jd.metrics()
    teng._kv_store.pop(hs[0])
    assert td.lookup(hs[0]) == {}


def _resize_run(eng, targets, results):
    """Submit four requests and step, resizing the pool to the next
    target between steps; returns the pool sizes seen and checks every
    table entry lies inside the pool."""
    rng = np.random.default_rng(5)
    for i in range(4):
        eng.submit(f"e{i}", rng.integers(1, 64, 7).astype(np.int32),
                   on_done=_collect(results))
    sizes = []
    for t in range(200):
        if t < len(targets):
            eng.resize_pool(targets[t])
            sizes.append(eng._pool.n_blocks)
            assert _pool_len(eng) == eng._pool.n_blocks
            assert int(np.max(eng._tables)) < eng._pool.n_blocks
        if eng.step() == 0 and eng.n_waiting == 0 and t >= len(targets):
            return sizes
    raise AssertionError("engine did not drain")


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_resize_between_steps_matches_jax(models, kv_dtype):
    """The reference's bounds (floor M+1, arena-equivalent ceiling on
    the CPU, step); then resizes to the floor and the ceiling between
    steps while residents hold blocks on a dry pool: shrinks clamp at
    the eviction boundary and are counted, never raised; the tokens,
    clamps, resizes and per-tick pool sizes equal the reference's and
    plain greedy ``generate``."""
    jeng, teng = _engines(models, max_new_tokens=4, max_slots=4,
                          prompt_buckets=(8,), paged=True, block_size=4,
                          n_blocks=6, elastic_pool=True, kv_dtype=kv_dtype)
    for key in ("_pool_floor", "_pool_ceiling", "_resize_step"):
        assert getattr(teng, key) == getattr(jeng, key), key
    assert (teng._pool_floor, teng._pool_ceiling) == (4, 13)
    targets = [1, 13, 1, 1, 13, 4, 13]
    ref, got = {}, {}
    jsizes = _resize_run(jeng, targets, ref)
    tsizes = _resize_run(teng, targets, got)
    assert tsizes == jsizes
    assert min(tsizes) == 4 and max(tsizes) == 13
    for uri in ref:
        np.testing.assert_array_equal(got[uri], ref[uri], err_msg=uri)
    jm_, tm_ = jeng.cache_metrics(), teng.cache_metrics()
    for key in ("pool_resizes", "pool_resize_clamps", "preemptions",
                "n_blocks", "evictions"):
        assert tm_[key] == jm_[key], key
    assert tm_["pool_resize_clamps"] > 0
    assert _flight(teng) == _flight(jeng)
    teng._pool.check()
    if kv_dtype is None:
        rng = np.random.default_rng(5)
        for i in range(4):
            p = rng.integers(1, 64, 7).astype(np.int32)
            plain = generate(models[2], None, p[None], 4, device="cpu")[0]
            np.testing.assert_array_equal(got[f"e{i}"], plain.numpy())


def test_maybe_autoresize_loop_matches_jax(models):
    """The pump-side control loop: an idle pool shrinks one step, a
    degraded class holds the shrink, an allocation-failure streak grows
    back toward the ceiling even while goodput is degraded; each step's
    delta equals the reference's."""
    engines = _engines(models, max_new_tokens=4, max_slots=4,
                       prompt_buckets=(8,), paged=True, block_size=4,
                       n_blocks=13, elastic_pool=True)
    bad = {"interactive": 0.2}
    steps = []
    for eng in engines:
        deltas = [eng.maybe_autoresize(), eng.maybe_autoresize(goodput=bad)]
        held = []
        while True:
            blk = eng._pool.allocate()
            if blk is None:
                break
            held.append(blk)
        deltas.append(eng.maybe_autoresize(goodput=bad))
        deltas.append((eng._pool.n_blocks, _pool_len(eng)))
        for blk in held:
            eng._pool.release(blk)
        eng._pool.check()
        m = eng.cache_metrics()
        deltas.append((m["pool_resizes"], m["pool_floor"]))
        steps.append(deltas)
    assert steps[1] == steps[0] == [-4, 0, 4, (13, 13), (2, 4)]
    off = ContinuousEngine(models[2], models[3], device="cpu",
                           max_new_tokens=4, max_slots=4,
                           prompt_buckets=(8,), paged=True, block_size=4)
    assert off.maybe_autoresize() == 0


def test_admission_rechecks_after_acquiring_cached_matches(models):
    """A matched prefix block parked in the LRU counts as allocatable
    until admission acquires it.  With the pool held down to exactly
    the three cached blocks a prompt matches, the reference's gate
    passes and its allocation then hands out no block (the pump dies
    releasing ``None``); the port re-checks after acquiring, fails the
    request while nothing in flight can free a block, and serves it
    once blocks are free again, with ``generate``'s tokens."""
    _, eng = _engines(models, max_new_tokens=4, max_slots=2,
                      prompt_buckets=(8, 16), paged=True, block_size=4,
                      n_blocks=8)
    results, errors = {}, {}
    eng.submit("a", _PA, on_done=_collect(results))
    eng.drain()
    assert eng._pool.num_cached() == 3
    held = []
    while eng._pool.allocatable() > 3:
        held.append(eng._pool.allocate())
    assert eng._pool.num_cached() == 3
    prompt = np.concatenate([_PA[:12], [60, 61, 62, 63]]).astype(np.int32)
    eng.submit("b", prompt, on_done=_collect(results),
               on_error=lambda u, e: errors.__setitem__(u, e))
    eng.drain()
    assert isinstance(errors.pop("b"), RuntimeError)
    eng._pool.check()
    assert eng._pool.num_cached() == 3
    for blk in held:
        eng._pool.release(blk)
    eng.submit("b", prompt, on_done=_collect(results))
    eng.drain()
    assert not errors and eng._pool.metrics()["prefix_hits"] >= 3
    plain = generate(models[2], None, prompt[None], 4, device="cpu")[0]
    np.testing.assert_array_equal(results["b"], plain.numpy())
