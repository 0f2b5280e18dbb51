"""The port's prefill/decode handoff held to the JAX engine, engine to
engine and through a two-replica ``ClusterServing`` fleet.

Tiny f32 models, the same seeded weights in both packages
(``params_from_flax``), on the CPU.  Engine A prefills each request
and, at its first token, exports the row's block chain and a copy of
its K/V to engine B's ``submit_handoff``; B adopts the chain without a
prefill and decodes.  Greedy tokens must equal the reference's pair and
plain ``generate``, the handoff counters must match, both pools must be
idle and consistent, and the adopted blocks must hold, bitwise, the
bytes the source exported (int8 pools with their scales).  The
reference's composition errors, and its fleet pins: a prefill/decode
``ClusterServing`` round trip and a dropped handoff recovered by the
ack timeout, on the torch engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.serving.continuous import \
    ContinuousEngine as JaxEngine
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.lm import (TransformerLM, generate,
                                               params_from_flax)
from analytics_zoo_tpu_torch.ops.flash_attention import QuantKV
from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                             OutputQueue, ServingConfig)
from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine

_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64, ln_eps=1e-5)
_ENGINE = dict(max_new_tokens=5, max_slots=3, prompt_buckets=(8, 16),
               paged=True, block_size=4)


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(dtype=jnp.float32, num_kv_heads=2, **_CFG)
    variables = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    state = params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    tm = TransformerLM(dtype=torch.float32, num_kv_heads=2, **_CFG)
    tm.load_state_dict(state)
    return jm, variables, tm, state


def _prompts():
    rng = np.random.default_rng(11)
    return {f"h{i}": rng.integers(1, 64, int(rng.integers(2, 14)))
            .astype(np.int32) for i in range(4)}


def _pair_run(a, b, prompts, wrap=None):
    """Submit every prompt to ``a`` with ``b``'s ``submit_handoff`` as
    the handoff (through ``wrap`` when given) and step both until every
    request finished."""
    results = {}
    cb = b.submit_handoff if wrap is None else wrap(b)
    for uri, p in prompts.items():
        a.submit(uri, p, on_done=lambda u, t: results.__setitem__(
            u, np.asarray(t)), handoff_cb=cb)
    for _ in range(500):
        a.step()
        b.step()
        if len(results) == len(prompts):
            return results
    raise AssertionError("handoff pair did not finish")


def _parts(kv):
    return [kv.data, kv.scale] if isinstance(kv, QuantKV) else [kv]


def _bitwise_check(dest, seen):
    """A handoff callback that adds an adoption ack comparing, right
    after the copy and before any decode, the destination's adopted
    blocks with the exported copies (data and scales)."""
    def wrap(b):
        def cb(state):
            def on_adopt(uri, replica):
                slot = next(i for i, s in enumerate(b._slots)
                            if s is not None and s.uri == uri)
                blocks = b._row_blocks[slot][:state["chain"]["n"]]
                idx = torch.as_tensor(blocks)
                for pool, src in ((b._pk, state["k"]), (b._pv, state["v"])):
                    for d, s in zip(_parts(pool), _parts(src)):
                        assert torch.equal(d.index_select(1, idx), s), uri
                seen.append(uri)

            state["on_adopt"] = on_adopt
            b.submit_handoff(state)
        return cb
    return wrap


@pytest.mark.parametrize("extra", [{}, {"chunked": True,
                                        "tick_token_budget": 8},
                                   {"kv_dtype": "int8"}],
                         ids=["paged", "chunked", "int8"])
def test_handoff_pair_matches_jax(models, extra):
    """Prefill on A, hand off at the first token, decode on B: tokens
    equal the reference's pair and (f32 pools) plain ``generate``;
    every row went across once, both pools end idle and consistent,
    and the adopted blocks equal the exported bytes bitwise."""
    jm, jv, tm, state = models
    prompts = _prompts()
    ja, jb = (JaxEngine(jm, jv, **_ENGINE, **extra) for _ in range(2))
    ta, tb = (ContinuousEngine(tm, state, device="cpu", **_ENGINE,
                               **extra) for _ in range(2))
    seen = []
    ref = _pair_run(ja, jb, prompts)
    got = _pair_run(ta, tb, prompts, wrap=_bitwise_check(tb, seen))
    assert sorted(seen) == sorted(prompts)
    for uri, p in prompts.items():
        np.testing.assert_array_equal(got[uri], ref[uri], err_msg=uri)
        if "kv_dtype" not in extra:
            plain = generate(tm, None, p[None], 5, device="cpu")[0]
            np.testing.assert_array_equal(got[uri], plain.numpy(),
                                          err_msg=uri)
    n = len(prompts)
    assert ta._handoffs_out == ja._handoffs_out == n
    assert tb._handoffs_in == jb._handoffs_in == n
    for eng in (ta, tb):
        assert eng.n_active == 0
        eng._pool.check()
        assert eng._pool.num_referenced() == 0
    for key in ("handoffs_out", "handoffs_in", "chains_exported",
                "chains_adopted", "prefix_hits"):
        assert ta.cache_metrics()[key] == ja.cache_metrics()[key], key
        assert tb.cache_metrics()[key] == jb.cache_metrics()[key], key
    assert sum(r.get("handoffs_in", 0) for r in tb.flight.snapshot()) == n


def test_handoff_composition_errors(models):
    """The reference's refusals, at submit time: an arena engine (no
    block tables), a sampled request (unsplittable RNG stream), a
    speculative engine (no spec-aware handoff yet), and a chain of
    another block size or KV dtype."""
    _, _, tm, state = models
    p = np.arange(1, 5, dtype=np.int32)
    kw = dict(max_new_tokens=4, max_slots=2, prompt_buckets=(8,),
              device="cpu")
    arena = ContinuousEngine(tm, state, **kw)
    with pytest.raises(ValueError, match="requires paged"):
        arena.submit("a", p, handoff_cb=lambda st: None)
    with pytest.raises(ValueError, match="paged engine"):
        arena.submit_handoff({})
    paged = ContinuousEngine(tm, state, paged=True, block_size=4, **kw)
    with pytest.raises(ValueError, match="greedy-only"):
        paged.submit("s", p, temperature=0.7, rng_seed=1,
                     handoff_cb=lambda st: None)
    spec = ContinuousEngine(tm, state, paged=True, block_size=4,
                            draft_model=tm, draft_variables=state,
                            speculation_k=2, **kw)
    with pytest.raises(ValueError, match="spec-aware KV handoff"):
        spec.submit("d", p, handoff_cb=lambda st: None)
    with pytest.raises(ValueError, match="spec-aware KV handoff"):
        spec.submit_handoff({})
    chain = {"block_size": 8, "kv_dtype": "f32", "n": 1, "hashes": [None]}
    with pytest.raises(ValueError, match="block_size"):
        paged.submit_handoff({"chain": chain, "plen": 3, "max_new": 2})
    with pytest.raises(ValueError, match="kv_dtype"):
        paged.submit_handoff({"chain": dict(chain, block_size=4,
                                            kv_dtype="int8"),
                              "plen": 3, "max_new": 2})


def _fleet_im(models):
    return InferenceModel().load_torch_generator(
        models[2], None, 4, prompt_buckets=(8,), device="cpu")


def _fleet_prompts(seed, n):
    rng = np.random.default_rng(seed)
    return {f"d{i}": rng.integers(1, 64, 3 + i % 5).astype(np.int32)
            for i in range(n)}


def _check_fleet(models, srv, prompts, outs):
    for u, p in prompts.items():
        plain = generate(models[2], None, p[None], 4, device="cpu")[0]
        np.testing.assert_array_equal(outs[u], plain.numpy(), err_msg=u)
    for eng in srv.engines:
        assert eng.n_active == 0
        eng._pool.check()
        assert eng._pool.num_referenced() == 0


def test_disaggregated_fleet_round_trip(models):
    """A prefill/decode fleet on one broker (the reference's
    ``test_router`` pin): every request prefills on replica 0, ships
    its chain to replica 1 and decodes there; tokens equal ``generate``
    and the role counters and both pools account for every handoff."""
    cfg = ServingConfig(prompt_col="tokens", continuous_batching=True,
                        engine_slots=2, n_replicas=2, engine_paged=True,
                        engine_block_size=4, engine_blocks=24,
                        replica_roles=["prefill", "decode"])
    srv = ClusterServing(_fleet_im(models), cfg, embedded_broker=True)
    srv.start()
    try:
        iq, oq = InputQueue(port=srv.port), OutputQueue(port=srv.port)
        prompts = _fleet_prompts(7, 6)
        for u, p in prompts.items():
            iq.enqueue(u, tokens=p)
        outs = {u: np.asarray(oq.query(u, timeout=120)) for u in prompts}
        status = srv.router_status()
        assert status["roles"] == ["prefill", "decode"]
        assert status["routed"][0] == len(prompts)
        assert status["handoffs"] == len(prompts)
        assert srv.engines[0]._handoffs_out == len(prompts)
        assert srv.engines[1]._handoffs_in == len(prompts)
        _check_fleet(models, srv, prompts, outs)
    finally:
        srv.stop()


def test_dropped_handoff_recovered_by_ack_timeout(models):
    """Two-phase handoff (the reference's pin): the first delivery is
    dropped by fault injection, the pending entry times out, the sweep
    sends the retained chain again, and every request still answers
    ``generate``'s tokens; acks account for every adoption."""
    cfg = ServingConfig(prompt_col="tokens", continuous_batching=True,
                        engine_slots=2, n_replicas=2, engine_paged=True,
                        engine_block_size=4, engine_blocks=24,
                        replica_roles=["prefill", "decode"],
                        handoff_ack_timeout_s=2.0, retry_budget=3,
                        fault_injection=[{"kind": "drop_handoff",
                                          "at_handoff": 0}])
    srv = ClusterServing(_fleet_im(models), cfg, embedded_broker=True)
    srv.start()
    try:
        iq, oq = InputQueue(port=srv.port), OutputQueue(port=srv.port)
        prompts = _fleet_prompts(13, 3)
        for u, p in prompts.items():
            iq.enqueue(u, tokens=p)
        outs = {u: np.asarray(oq.query(u, timeout=120)) for u in prompts}
        status = srv.router_status()
        assert status["handoff_timeouts"] >= 1, status
        assert status["handoff_retries"] >= 1, status
        assert status["handoff_acks"] == len(prompts)
        assert status["deaths"] == 0
        assert not srv._pending_handoffs
        _check_fleet(models, srv, prompts, outs)
    finally:
        srv.stop()
