"""The port's chunked prefill held to the JAX package.

Tiny f32 models, the same seeded weights in both packages
(``params_from_flax``): the chunk forwards (``prefill_chunk_paged`` on
a chunk grid with rows at different fill frontiers, right-padded
chunks with a write limit, a table sliced narrow to the frontier and an
all-sink padding row; f32 and int8 pools, MHA and GQA; and the arena's
``prefill_chunk``) to 1e-5; the chunked ``ContinuousEngine`` (arena,
paged gather, paged fused on the CPU, int8 pools) against the JAX
chunked engine and the port's monolithic engine; sampled chunked
tokens against monolithic ones; the same scheduling decisions tick by
tick as the JAX engine (flight records) on a pool that runs dry
mid-prefill, with and without a draft model (the composition of
chunked prefill and speculative decoding); ``precompile_chunked``'s
grid against the reference's; the budget errors; and the serving stack
with ``engine_chunked=True`` against the JAX stack.
"""

import http.client
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.learn.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.serving import ClusterServing as JaxServing
from analytics_zoo_tpu.serving import HttpFrontend as JaxFrontend
from analytics_zoo_tpu.serving import ServingConfig as JaxConfig
from analytics_zoo_tpu.serving.continuous import \
    ContinuousEngine as JaxEngine
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.lm import (TransformerLM, generate,
                                               params_from_flax)
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.serving import (ClusterServing, HttpFrontend,
                                             ServingConfig)
from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine

jfa = importlib.import_module("analytics_zoo_tpu.ops.flash_attention")

_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64, ln_eps=1e-5)
_ENGINE = dict(max_new_tokens=6, max_slots=3, prompt_buckets=(8, 16),
               block_size=4)
_EOS = 13
# flight-record fields that carry the scheduler's decisions
_DECISIONS = ("kind", "decode_uris", "prefill_uris", "preempted",
              "budget_used", "chunks", "spec_proposed", "spec_accepted")


def _pair(seed, **cfg):
    """A reference model and its weights, and the port's twin."""
    jm = JaxLM(dtype=jnp.float32, **cfg)
    variables = jm.init(jax.random.key(seed), np.zeros((1, 8), np.int32))
    state = params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    tm = TransformerLM(dtype=torch.float32, **cfg)
    tm.load_state_dict(state)
    return jm, variables, tm, state


@pytest.fixture(scope="module")
def models():
    """Target (2 layers, 2 kv heads), a random 1-layer draft, and a
    head-dim-32 target the paged kernel takes (``kernel="fused"``)."""
    return (_pair(0, num_kv_heads=2, **_CFG),
            _pair(1, num_kv_heads=2, **dict(_CFG, num_layers=1)),
            _pair(2, num_kv_heads=1, **dict(_CFG, hidden_size=64,
                                            num_heads=2)))


# ---- model level --------------------------------------------------------

def _model_pools(rng, kind, layers, N, KH, bs, D):
    """The same initial per-layer pools in both packages."""
    out = []
    for _ in range(2):
        x = rng.standard_normal((layers, N, KH, bs, D)).astype(np.float32)
        if kind == "int8":
            data, scale = jfa.quantize_kv(jnp.asarray(x))
            scale = np.asarray(scale.astype(jnp.float32))
            out.append((tfa.QuantKV(torch.from_numpy(np.array(data)),
                                    torch.from_numpy(scale.copy()).to(
                                        torch.bfloat16)),
                        jfa.QuantKV(data, jnp.asarray(scale,
                                                      jnp.bfloat16))))
        else:
            out.append((torch.from_numpy(x), jnp.asarray(x)))
    return out


def _leaves(pool):
    """A pool of either package as f32 numpy arrays (int8: data and
    scales)."""
    if isinstance(pool, tfa.QuantKV):
        return [pool.data.float().numpy(), pool.scale.float().numpy()]
    if isinstance(pool, jfa.QuantKV):
        return [np.asarray(pool.data, np.float32),
                np.asarray(pool.scale.astype(jnp.float32))]
    return [np.asarray(pool)]


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_prefill_chunk_paged_matches_jax(kv_heads, kind):
    """A chunk grid as a chunked tick builds it: three rows at fill
    frontiers 6, 0 and 9 (mid block), chunks of 5, 8 and 3 tokens
    right-padded to 8 columns (writes limited to each chunk), tables
    sliced to 4 blocks (the frontier's width), and an all-sink padding
    row.  Last-position logits to 1e-5; every pool entry equal, the
    padding columns' dropped writes included."""
    jm, jv, tm, _ = _pair(3, num_kv_heads=kv_heads, **_CFG)
    rng = np.random.default_rng(10 + kv_heads)
    bs, N, D = 4, 16, 8
    (tk, jk), (tv, jv_) = _model_pools(rng, kind, 2, N, kv_heads, bs, D)
    pos = np.array([6, 0, 9, 0], np.int32)
    lens = np.array([5, 8, 3, 1], np.int32)
    tables = np.array([[2, 3, 4, 0], [5, 6, 0, 0], [7, 8, 9, 10],
                       [0, 0, 0, 0]], np.int32)
    toks = rng.integers(1, 64, (4, 8)).astype(np.int32)
    toks[3] = 0
    want, jk2, jv2 = jm.apply(jv, jnp.asarray(toks), jk, jv_,
                              jnp.asarray(tables), jnp.asarray(pos),
                              jnp.asarray(lens), kernel="gather",
                              method=JaxLM.prefill_chunk_paged)
    with torch.no_grad():
        got = tm.prefill_chunk_paged(
            torch.from_numpy(toks), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(pos), torch.from_numpy(lens), kernel="fused")
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3],
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(_leaves(tk) + _leaves(tv), _leaves(jk2) + _leaves(jv2)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_prefill_chunk_arena_matches_jax():
    """The arena's chunk forward on a read window of the rows' caches,
    at unaligned frontiers with right padding: logits and caches to
    1e-5."""
    jm, jv, tm, _ = _pair(3, num_kv_heads=2, **_CFG)
    rng = np.random.default_rng(5)
    ck = rng.standard_normal((2, 3, 16, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((2, 3, 16, 2, 8)).astype(np.float32)
    pos = np.array([3, 0, 7], np.int32)
    lens = np.array([5, 8, 2], np.int32)
    toks = rng.integers(1, 64, (3, 8)).astype(np.int32)
    want, jk, jvv = jm.apply(jv, jnp.asarray(toks), jnp.asarray(ck),
                             jnp.asarray(cv), jnp.asarray(pos),
                             jnp.asarray(lens), method=JaxLM.prefill_chunk)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.no_grad():
        got = tm.prefill_chunk(torch.from_numpy(toks), tk, tv,
                               torch.from_numpy(pos), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jvv), atol=1e-5)


# ---- engine ---------------------------------------------------------------

def _stream(long=False):
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 64, 8).astype(np.int32)
    lens = [5, 12, 3, 9, 14, 7] + ([16, 15] if long else [])
    reqs = [("a", np.r_[shared, [3, 4]])]
    reqs += [(f"r{i}", rng.integers(1, 64, n).astype(np.int32))
             for i, n in enumerate(lens)]
    reqs.append(("b", np.r_[shared, [5, 6, 7]]))
    return [(u, np.asarray(p, np.int32)) for u, p in reqs]


def _serve(engine, long=False, **submit):
    out = {}
    for i, (uri, prompt) in enumerate(_stream(long)):
        kw = dict(submit, rng_seed=100 + i) if submit else {}
        engine.submit(uri, prompt, lambda u, t: out.__setitem__(
            u, np.asarray(t)), **kw)
    engine.drain()
    return out


def _assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for uri in ref:
        np.testing.assert_array_equal(got[uri], ref[uri], err_msg=uri)


@pytest.mark.parametrize("mode", ["arena", "paged", "int8", "fused"])
def test_chunked_engine_matches_jax_and_monolithic(models, mode):
    """Greedy tokens of the chunked engine equal the JAX chunked
    engine's and the port's monolithic engine's: arena, paged (plain
    read), paged int8 pools, and paged ``kernel="fused"`` (the plain
    version on the CPU) on the head-dim-32 model."""
    jm, jv, tm, state = models[2] if mode == "fused" else models[0]
    kw = dict(_ENGINE, eos_id=_EOS, tick_token_budget=12)
    tkw = {}
    if mode != "arena":
        kw["paged"] = True
    if mode == "int8":
        kw["kv_dtype"] = "int8"
    if mode == "fused":
        tkw["kernel"] = "fused"
    jeng = JaxEngine(jm, jv, chunked=True, **kw)
    teng = ContinuousEngine(tm, state, chunked=True, device="cpu", **kw,
                            **tkw)
    ref, got = _serve(jeng), _serve(teng)
    del kw["tick_token_budget"]
    mono = _serve(ContinuousEngine(tm, state, device="cpu", **kw, **tkw))
    _assert_same(got, ref)
    _assert_same(got, mono)
    assert teng.kernel == ("fused" if mode == "fused" else "gather")
    assert teng.chunk_calls > 0
    jm_, tm_ = jeng.cache_metrics(), teng.cache_metrics()
    for key in ("tick_token_budget", "budget_utilization",
                "prefill_stall_ticks", "prefill_preemptions",
                "peak_resident"):
        assert tm_[key] == jm_[key], key


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_chunked_equals_monolithic(models, paged):
    """Sampled requests (a seed each, top-p) give the same tokens
    chunked as monolithic: the first token is drawn at position
    ``plen - 1`` either way, and every draw is a function of (seed,
    position, logits)."""
    jm, jv, tm, state = models[0]
    kw = dict(_ENGINE, eos_id=_EOS, paged=paged)
    samp = dict(temperature=0.8, top_p=0.9)
    mono = _serve(ContinuousEngine(tm, state, device="cpu", **kw), **samp)
    got = _serve(ContinuousEngine(tm, state, device="cpu", chunked=True,
                                  tick_token_budget=8, **kw), **samp)
    _assert_same(got, mono)


@pytest.mark.parametrize("draft,paged", [(False, True), (True, True),
                                         (True, False)])
def test_same_decisions_as_jax_tick_by_tick(models, draft, paged):
    """The same workload through both engines on a small pool that runs
    dry mid-prefill (paged): every tick's flight record carries the same
    kind, resident rows, preemptions, budget use, chunks and
    speculative proposals and acceptances; the tokens, the preemption
    counters and the acceptance record are equal, and every request
    equals plain greedy ``generate``.  With a draft this is the
    composition of chunked prefill and speculative decoding."""
    jm, jv, tm, state = models[0]
    djm, djv, dtm, dstate = models[1]
    kw = dict(_ENGINE, eos_id=_EOS, paged=paged, tick_token_budget=8)
    jkw, tkw = {}, {}
    if paged:
        kw["n_blocks"] = 8
    if draft:
        kw.update(tick_token_budget=12, speculation_k=2)
        jkw = dict(draft_model=djm, draft_variables=djv)
        tkw = dict(draft_model=dtm, draft_variables=dstate)
    jeng = JaxEngine(jm, jv, chunked=True, **kw, **jkw)
    teng = ContinuousEngine(tm, state, chunked=True, device="cpu", **kw,
                            **tkw)
    ref, got = _serve(jeng, long=True), _serve(teng, long=True)
    _assert_same(got, ref)
    for uri, prompt in _stream(long=True):
        plain = generate(tm, None, prompt[None], 6, eos_id=_EOS,
                         device="cpu")[0].numpy()
        np.testing.assert_array_equal(got[uri], plain, err_msg=uri)

    def decisions(eng):
        return [tuple(r.get(k) for k in _DECISIONS)
                for r in eng.flight.snapshot()]

    assert decisions(teng) == decisions(jeng)
    jm_, tm_ = jeng.cache_metrics(), teng.cache_metrics()
    for key in ("preemptions", "prefill_preemptions", "prefill_stall_ticks",
                "budget_utilization", "peak_resident"):
        assert tm_[key] == jm_[key], key
    if paged:
        assert jm_["prefill_preemptions"] > 0   # the pool ran dry
        assert tm_["referenced_blocks"] == 0
    if draft:
        assert teng.spec_acceptance() == jeng.spec_acceptance()
        assert {r["kind"] for r in teng.flight.snapshot()} >= {
            "spec", "spec_chunked"}
    snap_t = teng.telemetry.metrics.snapshot()
    snap_j = jeng.telemetry.metrics.snapshot()
    assert {k for k in snap_t if k.startswith("zoo_engine_")} == \
        {k for k in snap_j if k.startswith("zoo_engine_")}


def test_budget_errors(models):
    """The reference's two budget errors: below the smallest prompt
    bucket, and (paged) below one block."""
    jm, jv, tm, state = models[0]
    with pytest.raises(ValueError, match="smallest chunk bucket"):
        ContinuousEngine(tm, state, chunked=True, tick_token_budget=4,
                         device="cpu", **_ENGINE)
    with pytest.raises(ValueError, match="below block_size"):
        ContinuousEngine(tm, state, chunked=True, tick_token_budget=8,
                         paged=True, device="cpu",
                         **dict(_ENGINE, block_size=16))
    eng = ContinuousEngine(tm, state, device="cpu", **_ENGINE)
    with pytest.raises(ValueError, match="requires chunked=True"):
        eng.precompile_chunked()
    # the default budget is the reference's
    for kw in (dict(), dict(paged=True)):
        assert ContinuousEngine(
            tm, state, chunked=True, device="cpu", **_ENGINE,
            **kw).tick_token_budget == JaxEngine(
            jm, jv, chunked=True, **_ENGINE, **kw).tick_token_budget


def _record_jax_grid(eng, paged, draft):
    """Replace the JAX engine's grid programs by recorders (the grid is
    what is compared, so nothing compiles)."""
    seen = []
    if draft:
        def chunk(*a, read_len=None):
            seen.append(("chunk", a[4].shape[0], a[4].shape[1],
                         a[7].shape[1] if paged else read_len))
        name = "_spec_chunk_paged" if paged else "_spec_chunk"
        setattr(eng, name, chunk)
        step = "_spec_step_paged" if paged else "_spec_step"
        setattr(eng, step, lambda *a: seen.append(("round",)))
        return seen

    def get_fused(wd, sampled, use_topp, read_len=0):
        def run(*a):
            if wd:
                seen.append(("decode",))
            c = a[9] if paged else a[8]
            seen.append(("chunk", c.shape[0], c.shape[1],
                         a[12].shape[1] if paged else read_len))
        return run

    eng._get_fused = get_fused
    return seen


def _record_port_grid(eng):
    seen = []
    run_chunk, decode, spec = eng._run_chunk, eng._decode_call, \
        eng._spec_call

    def chunk(ctoks, cpos, clens, cslots, width):
        seen.append(("chunk",) + ctoks.shape + (width,))
        return run_chunk(ctoks, cpos, clens, cslots, width)

    def dec(*a):
        seen.append(("decode",))
        return decode(*a)

    def rnd(*a):
        seen.append(("round",))
        return spec(*a)

    eng._run_chunk, eng._decode_call, eng._spec_call = chunk, dec, rnd
    return seen


def _caches(eng):
    """Copies of every cache the engine keeps: the arena caches, or the
    paged pools without the sink block (block 0), where stray writes
    land by design."""
    if eng.paged:
        pools = [eng._pk, eng._pv]
        if eng.draft_model is not None:
            pools += [eng._dpk, eng._dpv]
        return [p[:, 1:].clone() for p in pools]
    caches = [eng._ck, eng._cv]
    if eng.draft_model is not None:
        caches += [eng._dck, eng._dcv]
    return [c.clone() for c in caches]


@pytest.mark.parametrize("draft,paged", [(False, True), (False, False),
                                         (True, True), (True, False)])
def test_precompile_grid_matches_jax(models, draft, paged):
    """``precompile_chunked`` visits the reference's grid of tick shapes
    (rows, chunk width, table width or read window; with and without
    the decode; spec engines: the two-tenant chunk call and one round),
    in the reference's order, and returns the same count — without
    touching any row's cache (the engine then serves the same tokens)."""
    jm, jv, tm, state = models[0]
    djm, djv, dtm, dstate = models[1]
    kw = dict(_ENGINE, eos_id=_EOS, paged=paged, chunked=True)
    jkw = tkw = {}
    if draft:
        kw["speculation_k"] = 2
        jkw = dict(draft_model=djm, draft_variables=djv)
        tkw = dict(draft_model=dtm, draft_variables=dstate)
    jeng = JaxEngine(jm, jv, **kw, **jkw)
    teng = ContinuousEngine(tm, state, device="cpu", **kw, **tkw)
    want = _record_jax_grid(jeng, paged, draft)
    n_ref = jeng.precompile_chunked()
    # a request in flight: precompiling must leave its row alone
    out = {}
    teng.submit("x", _stream()[1][1], lambda u, t: out.__setitem__(u, t))
    teng.step()
    got = _record_port_grid(teng)
    before = _caches(teng)
    assert teng.precompile_chunked() == n_ref
    assert got == want
    for a, b in zip(before, _caches(teng)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    del teng._run_chunk, teng._decode_call, teng._spec_call  # unwrap
    teng.drain()
    plain = generate(tm, None, _stream()[1][1][None], 6, eos_id=_EOS,
                     device="cpu")[0].numpy()
    np.testing.assert_array_equal(out["x"], plain)


def _post(port, tokens):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=90)
    try:
        conn.request("POST", "/v1/generate", json.dumps({"tokens": tokens}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def test_stack_chunked_matches_jax(models):
    """``ClusterServing`` + ``HttpFrontend`` with ``engine_chunked=True``
    (paged, a small budget): ``/v1/generate`` tokens equal the JAX
    stack's; a ``engine_speculation_k`` without a draft fails at
    ``start`` as in the reference."""
    jm, jv, tm, state = models[0]
    cfg = dict(prompt_col="tokens", continuous_batching=True,
               engine_slots=3, engine_paged=True, engine_block_size=4,
               engine_chunked=True, engine_tick_token_budget=8)
    jim = JaxInferenceModel().load_flax_generator(
        jm, jv, max_new_tokens=6, prompt_buckets=(8, 16))
    im = InferenceModel().load_torch_generator(
        tm, None, 6, prompt_buckets=(8, 16), device="cpu")
    prompts = [p.tolist() for _, p in _stream()[:4]]
    outs = []
    for serving, frontend, handle, config in (
            (JaxServing, JaxFrontend, jim, JaxConfig),
            (ClusterServing, HttpFrontend, im, ServingConfig)):
        srv = serving(handle, config(**cfg), embedded_broker=True).start()
        fe = frontend(redis_port=srv.port, timeout=90, serving=srv).start()
        try:
            assert srv.engine.chunked
            res = [_post(fe.port, p) for p in prompts]
        finally:
            fe.stop()
            srv.stop()
        assert all(status == 200 for status, _ in res), res
        outs.append([body["tokens"] for _, body in res])
    assert outs[1] == outs[0]
    srv = ClusterServing(im, ServingConfig(**dict(
        cfg, engine_chunked=False, engine_speculation_k=2)),
        embedded_broker=True)
    try:
        with pytest.raises(ValueError, match="needs a draft"):
            srv.start()
    finally:
        srv.stop()
