"""The port's speculative decoding held to the JAX package.

Tiny f32 models, the same seeded weights in both packages
(``params_from_flax``): the paged verify forward
(``verify_step_paged``) at unaligned positions through narrow tables
and f32 or int8 pools, to 1e-5; the acceptance rule
(``accept_proposals``) exactly, on random logits with eos and done rows;
batch ``speculative_generate`` against the reference's and against
plain greedy ``generate`` (self-draft and a random draft, k in
{1, 3, 7}, ragged prompts, eos); the speculative ``ContinuousEngine``
(arena and paged) against the JAX engine and ``generate``, with equal
acceptance records; ``InferenceModel`` with a draft, and the serving
stack's ``/v1/generate`` on a draft-loaded model, against the JAX
stack; and the mode's errors.
"""

import importlib
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.learn.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.models import speculative as jspec
from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.serving import ClusterServing as JaxServing
from analytics_zoo_tpu.serving import HttpFrontend as JaxFrontend
from analytics_zoo_tpu.serving import ServingConfig as JaxConfig
from analytics_zoo_tpu.serving.continuous import \
    ContinuousEngine as JaxEngine
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models import speculative as tspec
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
_GEN_EOS = 5     # emitted mid-row by two of _ragged()'s rows


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
    """Target (2 layers, 2 kv heads) and a random 1-layer draft."""
    return (_pair(0, num_kv_heads=2, **_CFG),
            _pair(1, num_kv_heads=2, **dict(_CFG, num_layers=1)))


def _draft(models, which):
    """(jax draft, jax vars, port draft, port state): the target itself
    (self-draft) or the random 1-layer draft."""
    return models[0] if which == "self" else models[1]


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
def test_verify_step_paged_matches_jax(kv_heads, kind):
    """k+1 = 4 verify rows per batch row at unaligned positions (mid
    block, one row straddling a block edge), the table sliced narrow to
    the rows' frontier, a row of all-sink padding; logits to 1e-5 and
    every pool entry the verify wrote equal."""
    jm, jv, tm, _ = _pair(2, num_kv_heads=kv_heads, **_CFG)
    rng = np.random.default_rng(kv_heads)
    bs, N, D = 4, 20, 8
    (tk, jk), (tv, jv_) = _model_pools(rng, kind, 2, N, kv_heads, bs, D)
    pos = np.array([5, 10, 2, 0], np.int32)
    tables = np.array([[3, 4, 5, 0], [6, 7, 8, 9], [10, 11, 0, 0],
                       [0, 0, 0, 0]], np.int32)       # narrow: 4 of M
    toks = rng.integers(1, 64, (4, 4)).astype(np.int32)
    want, jk2, jv2 = jm.apply(jv, jnp.asarray(toks), jk, jv_,
                              jnp.asarray(tables), jnp.asarray(pos),
                              kernel="gather",
                              method=JaxLM.verify_step_paged)
    with torch.no_grad():
        got = tm.verify_step_paged(
            torch.from_numpy(toks), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(pos), kernel="fused")    # plain on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for a, b in zip(_leaves(tk) + _leaves(tv), _leaves(jk2) + _leaves(jv2)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("eos_id,budget", [(None, False), (5, False),
                                           (5, True), (0, True)])
@pytest.mark.parametrize("k", [1, 3])
def test_accept_proposals_matches_jax(eos_id, budget, k):
    """Exact against the reference on random logits whose argmaxes
    match the proposals for random prefixes, with eos in the window and
    done rows."""
    rng = np.random.default_rng(k * 10 + (eos_id or 0))
    B, V = 16, 8
    logits = rng.standard_normal((B, k + 1, V)).astype(np.float32)
    t = logits.argmax(-1)
    d = rng.integers(0, V, (B, k)).astype(np.int32)
    for b in range(B):
        a = rng.integers(0, k + 1)
        d[b, :a] = t[b, :a]
    last = rng.integers(0, V, B).astype(np.int32)
    done = rng.random(B) < 0.25
    bud = rng.integers(0, k + 2, B).astype(np.int32) if budget else None
    want = jspec.accept_proposals(
        jnp.asarray(logits), jnp.asarray(d), jnp.asarray(last),
        jnp.asarray(done), k=k, eos_id=eos_id,
        budget=None if bud is None else jnp.asarray(bud))
    got = tspec.accept_proposals(
        torch.from_numpy(logits), torch.from_numpy(d),
        torch.from_numpy(last), torch.from_numpy(done), k=k, eos_id=eos_id,
        budget=None if bud is None else torch.from_numpy(bud))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ragged():
    rng = np.random.default_rng(3)
    lens = np.array([9, 4, 12], np.int32)
    prompts = np.zeros((3, 12), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(1, 64, n)
    return prompts, lens


@pytest.mark.parametrize("draft", ["self", "random"])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_speculative_generate_matches_jax_and_generate(models, draft, k):
    """Same tokens as the reference's speculative_generate and as plain
    greedy generate, on ragged prompts with an eos the streams emit; the
    round count equals the reference's."""
    jm, jv, tm, state = models[0]
    djm, djv, dtm, dstate = _draft(models, draft)
    prompts, lens = _ragged()
    want, wstats = jspec.speculative_generate(
        jm, jv, djm, djv, prompts, 10, k=k, eos_id=_GEN_EOS, prompt_len=lens)
    got, stats = tspec.speculative_generate(
        tm, None, dtm, dstate, prompts, 10, k=k, eos_id=_GEN_EOS,
        prompt_len=lens, device="cpu")
    plain = generate(tm, None, prompts, 10, prompt_len=lens, eos_id=_GEN_EOS,
                     device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert (got.numpy() == _GEN_EOS).any()
    assert stats["rounds"] == wstats["rounds"]
    np.testing.assert_array_equal(stats["per_row_emitted"],
                                  wstats["per_row_emitted"])
    if draft == "self":     # the draft is the target: all accepted
        assert stats["rounds"] <= -(-10 // (k + 1)) + 1


# ---- engine ---------------------------------------------------------------

def _stream():
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 64, 8).astype(np.int32)
    reqs = [("a", np.r_[shared, [3, 4]])]
    reqs += [(f"r{i}", rng.integers(1, 64, n).astype(np.int32))
             for i, n in enumerate([5, 12, 3, 9, 14, 7])]
    reqs.append(("b", np.r_[shared, [5, 6, 7]]))
    return [(u, np.asarray(p, np.int32)) for u, p in reqs]


def _serve(engine):
    out = {}
    for uri, prompt in _stream():
        engine.submit(uri, prompt, lambda u, t: out.__setitem__(
            u, np.asarray(t)))
    engine.drain()
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("draft", ["self", "random"])
def test_spec_engine_matches_jax_and_generate(models, paged, draft):
    """Arena and paged speculative engines: tokens equal the JAX
    engine's and plain greedy ``generate``'s, and the acceptance
    records (``spec_acceptance``) and the spec counters are equal."""
    jm, jv, tm, state = models[0]
    djm, djv, dtm, dstate = _draft(models, draft)
    kw = dict(_ENGINE, eos_id=_EOS, paged=paged, speculation_k=3)
    jeng = JaxEngine(jm, jv, draft_model=djm, draft_variables=djv, **kw)
    teng = ContinuousEngine(tm, state, draft_model=dtm,
                            draft_variables=dstate, device="cpu", **kw)
    ref, got = _serve(jeng), _serve(teng)
    assert sorted(got) == sorted(ref) == sorted(u for u, _ in _stream())
    for uri, prompt in _stream():
        np.testing.assert_array_equal(got[uri], ref[uri], err_msg=uri)
        plain = generate(tm, None, prompt[None], 6, eos_id=_EOS,
                         device="cpu")[0].numpy()
        np.testing.assert_array_equal(got[uri], plain, err_msg=uri)
    assert teng.spec_acceptance() == jeng.spec_acceptance()
    jm_, tm_ = jeng.cache_metrics(), teng.cache_metrics()
    for key in ("speculation_k", "spec_rounds", "spec_emitted",
                "spec_proposed", "spec_accepted", "preemptions"):
        assert tm_[key] == jm_[key], key
    if paged:
        assert tm_["draft_referenced_blocks"] == 0
        assert teng.capacity_report()["draft_n_blocks"] == \
            jeng.capacity_report()["draft_n_blocks"]


def test_draft_head_dim_resolves_its_own_read():
    """Each pool tenant resolves its paged read by its own head dim: a
    head-dim-8 draft (which the kernel does not take) reads through
    the plain gather while the head-dim-32 target stays on the kernel,
    and the engine still serves plain greedy tokens; an explicit
    ``kernel="fused"`` raises for the draft's shape."""
    cfg = dict(_CFG, hidden_size=128)                   # D = 32
    tm = TransformerLM(dtype=torch.float32, num_kv_heads=2, **cfg)
    dtm = TransformerLM(dtype=torch.float32, num_kv_heads=2,
                        **dict(_CFG, num_layers=1))     # D = 8
    kw = dict(_ENGINE, eos_id=_EOS, paged=True, speculation_k=2,
              draft_model=dtm, draft_variables=dtm.state_dict(),
              device="cpu")
    eng = ContinuousEngine(tm, None, **kw)
    assert (eng.kernel, eng._dkernel) == ("fused", "gather")
    out = _serve(eng)
    for uri, prompt in _stream():
        plain = generate(tm, None, prompt[None], 6, eos_id=_EOS,
                         device="cpu")[0].numpy()
        np.testing.assert_array_equal(out[uri], plain, err_msg=uri)
    with pytest.raises(ValueError, match="head dim 8"):
        ContinuousEngine(tm, None, kernel="fused", **kw)


def test_spec_engine_errors(models):
    """The reference's constructor and submit errors of the mode."""
    jm, jv, tm, state = models[0]
    djm, djv, dtm, dstate = models[1]
    with pytest.raises(ValueError, match="needs draft_variables"):
        ContinuousEngine(tm, state, draft_model=dtm, device="cpu",
                         **_ENGINE)
    small = TransformerLM(dtype=torch.float32, **dict(_CFG, vocab_size=32))
    with pytest.raises(ValueError, match="vocab"):
        ContinuousEngine(tm, state, draft_model=small,
                         draft_variables=small.state_dict(), device="cpu",
                         **_ENGINE)
    with pytest.raises(ValueError, match="speculation_k must be >= 1"):
        ContinuousEngine(tm, state, draft_model=dtm,
                         draft_variables=dstate, speculation_k=0,
                         device="cpu", **_ENGINE)
    with pytest.raises(ValueError, match="target's"):
        ContinuousEngine(tm, state, draft_model=tm,
                         draft_variables=dstate, device="cpu", **_ENGINE)
    eng = ContinuousEngine(tm, state, draft_model=dtm,
                           draft_variables=dstate, device="cpu", **_ENGINE)
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit("x", np.arange(1, 5, dtype=np.int32), temperature=0.5,
                   rng_seed=1)
    # the prompt budget leaves room for the k+1 verify positions
    assert eng.max_prompt_width == JaxEngine(
        jm, jv, draft_model=djm, draft_variables=djv,
        **_ENGINE).max_prompt_width


def test_abort_frees_both_pools(models):
    """Aborting a resident speculative row releases its blocks in the
    target AND the draft pool, like the reference."""
    jm, jv, tm, state = models[0]
    djm, djv, dtm, dstate = models[1]
    eng = ContinuousEngine(tm, state, draft_model=dtm,
                           draft_variables=dstate, paged=True,
                           device="cpu", **_ENGINE)
    eng.submit("x", np.arange(1, 11, dtype=np.int32))
    eng.submit("y", np.arange(2, 7, dtype=np.int32))
    eng.step()
    m = eng.cache_metrics()
    assert m["referenced_blocks"] > 0 and m["draft_referenced_blocks"] > 0
    assert eng.abort("x") and eng.abort("y")
    m = eng.cache_metrics()
    assert m["referenced_blocks"] == m["draft_referenced_blocks"] == 0
    assert eng.n_active == 0


def test_inference_model_with_a_draft(models):
    """``load_torch_generator(draft_model=, draft_variables=)``: the
    reference's pairing check and bucket bound, ``predict`` through
    ``speculative_generate`` equal to the JAX handle's with the same
    cumulative ``spec_stats``, and a speculative engine from
    ``make_continuous_engine``."""
    jm, jv, tm, state = models[0]
    djm, djv, dtm, dstate = models[1]
    with pytest.raises(ValueError, match="together"):
        InferenceModel().load_torch_generator(tm, None, 6,
                                              draft_model=dtm,
                                              device="cpu")
    with pytest.raises(ValueError, match="together"):
        InferenceModel().load_torch_generator(tm, None, 6,
                                              draft_variables=dstate,
                                              device="cpu")
    with pytest.raises(ValueError, match="needs a draft"):
        InferenceModel().load_torch_generator(
            tm, None, 6, prompt_buckets=(8, 16),
            device="cpu").make_continuous_engine(speculation_k=2)
    ref = JaxInferenceModel(batch_buckets=(1, 4)).load_flax_generator(
        jm, jv, max_new_tokens=6, prompt_buckets=(8, 16, 64),
        draft_model=djm, draft_variables=djv, speculation_k=3)
    im = InferenceModel(batch_buckets=(1, 4)).load_torch_generator(
        tm, None, 6, prompt_buckets=(8, 16, 64), draft_model=dtm,
        draft_variables=dstate, speculation_k=3, device="cpu")
    assert im.max_prompt_width == ref.max_prompt_width == 16
    prompts, lens = _ragged()
    batch = np.zeros((3, 16), np.int32)
    batch[:, :12] = prompts
    np.testing.assert_array_equal(im.predict(batch, lens),
                                  np.asarray(ref.predict(batch, lens)))
    assert im.spec_stats == ref.spec_stats
    eng = im.make_continuous_engine(max_slots=2, speculation_k=2)
    assert eng.draft_model is dtm and eng._spec_k == 2


def _post(port, tokens):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=90)
    try:
        conn.request("POST", "/v1/generate", json.dumps({"tokens": tokens}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def test_stack_with_a_draft_matches_jax(models):
    """``ClusterServing`` + ``HttpFrontend`` on a draft-loaded model (a
    paged speculative engine, the depth overridden by
    ``engine_speculation_k``): ``/v1/generate`` tokens equal the JAX
    stack's."""
    jm, jv, tm, state = models[0]
    djm, djv, dtm, dstate = models[1]
    cfg = dict(prompt_col="tokens", continuous_batching=True,
               engine_slots=3, engine_paged=True, engine_block_size=4,
               engine_speculation_k=2)
    jim = JaxInferenceModel().load_flax_generator(
        jm, jv, max_new_tokens=6, prompt_buckets=(8, 16), draft_model=djm,
        draft_variables=djv)
    im = InferenceModel().load_torch_generator(
        tm, None, 6, prompt_buckets=(8, 16), draft_model=dtm,
        draft_variables=dstate, device="cpu")
    prompts = [p.tolist() for _, p in _stream()[:3]]
    outs = []
    for serving, frontend, handle, config in (
            (JaxServing, JaxFrontend, jim, JaxConfig),
            (ClusterServing, HttpFrontend, im, ServingConfig)):
        srv = serving(handle, config(**cfg), embedded_broker=True).start()
        fe = frontend(redis_port=srv.port, timeout=90, serving=srv).start()
        try:
            assert srv.engine._spec_k == 2
            res = [_post(fe.port, p) for p in prompts]
        finally:
            fe.stop()
            srv.stop()
        assert all(status == 200 for status, _ in res), res
        outs.append([body["tokens"] for _, body in res])
    assert outs[1] == outs[0]
