"""The port's ContinuousEngine held to the JAX engine, in both modes.

The same request stream goes to the reference engine at f32 and to the
port on the CPU, on the same weights (``params_from_flax``): the slot
arena (``paged=False``, the default of both) and the paged engine
(``paged=True``; the reference's ``kernel="gather"``).  The stream
mixes prompt lengths, carries two requests that share two full prompt
blocks (the second is admitted in a later wave, so in paged mode it
attaches to the first one's published blocks), optionally two more that
name a ``register_prefix`` id, and stops rows at an ``eos_id`` that the
greedy streams really emit.  Greedy tokens must be IDENTICAL per URI,
and the preemption and prefix-hit counters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.serving.continuous import \
    ContinuousEngine as JaxEngine
from analytics_zoo_tpu_torch.models.lm import TransformerLM, params_from_flax
from analytics_zoo_tpu_torch.parallel.mesh import Mesh
from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine

_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64, ln_eps=1e-5)
_ENGINE = dict(max_new_tokens=6, max_slots=3, prompt_buckets=(8, 16),
               block_size=4)
_EOS = 13   # emitted mid-stream by several rows of this seed's streams


@pytest.fixture(scope="module")
def models():
    """The reference model and weights, and the port's model with the
    same weights converted (``params_from_flax``), also returned as the
    ``state_dict`` the port's engine takes as ``variables``."""
    jm = JaxLM(dtype=jnp.float32, num_kv_heads=2, **_CFG)
    variables = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    state = params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    tm = TransformerLM(dtype=torch.float32, num_kv_heads=2, **_CFG)
    tm.load_state_dict(state)
    return jm, variables, tm, state


def _stream():
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 64, 8).astype(np.int32)   # two full blocks
    reqs = [("a", shared.tolist() + [3, 4])]
    reqs += [(f"r{i}", rng.integers(1, 64, n).tolist())
             for i, n in enumerate([5, 12, 3, 9, 14, 7])]
    reqs.append(("b", shared.tolist() + [5, 6, 7]))
    return [(u, np.asarray(p, np.int32)) for u, p in reqs]


_PREFIX = np.arange(20, 29, dtype=np.int32)    # 2 full blocks + 1
_PREFIXED = [("p0", np.array([7, 8, 9], np.int32)),
             ("p1", np.array([30, 31, 32, 33, 34, 35], np.int32))]


def _run(engine, with_prefix=False):
    """Serve the stream (and, ``with_prefix``, two requests naming a
    registered prefix); returns (tokens per uri, cache_metrics)."""
    out = {}

    def done(u, t):
        out[u] = np.asarray(t)

    reqs = [(u, p, None) for u, p in _stream()]
    if with_prefix:
        pid = engine.register_prefix(_PREFIX)
        reqs[3:3] = [(u, p, pid) for u, p in _PREFIXED]
    for uri, prompt, prefix in reqs:
        engine.submit(uri, prompt, done, prefix=prefix)
    engine.drain()
    if with_prefix:
        engine.unregister_prefix(pid)
    return out, engine.cache_metrics()


def _assert_same(got, ref, with_prefix=False):
    uris = [u for u, _ in _stream()]
    if with_prefix:
        uris += [u for u, _ in _PREFIXED]
    assert sorted(got) == sorted(ref) == sorted(uris)
    for uri in ref:
        np.testing.assert_array_equal(got[uri], ref[uri], err_msg=uri)
    # the eos path ran: some row stopped early on eos (frozen tail)
    assert any((t[:-1] == _EOS).any() for t in got.values())


@pytest.mark.parametrize("ticks_per_step,cache_dtype,with_prefix", [
    (1, None, False), (4, None, False), (1, "bfloat16", False),
    (4, None, True), (1, "bfloat16", True)])
def test_arena_engine_tokens_match_jax(models, ticks_per_step, cache_dtype,
                                       with_prefix):
    """The default (arena) engine of both packages.  A bf16 arena under
    the f32 model stores the same rounded K/V in both packages, and the
    attention reads it back into f32 math on both sides."""
    jm, variables, tm, state = models
    kw = dict(_ENGINE, eos_id=_EOS, ticks_per_step=ticks_per_step)
    ref, ref_m = _run(JaxEngine(jm, variables, cache_dtype=cache_dtype,
                                **kw), with_prefix)
    got, got_m = _run(ContinuousEngine(
        tm, state, device="cpu", cache_dtype=cache_dtype and getattr(
            torch, cache_dtype), **kw), with_prefix)
    _assert_same(got, ref, with_prefix)
    assert got_m["mode"] == ref_m["mode"] == "arena"
    assert got_m["peak_resident"] == ref_m["peak_resident"]


def _paged_case(models, ticks_per_step, n_blocks, kv_dtype, with_prefix):
    jm, variables, tm, state = models
    kw = dict(_ENGINE, eos_id=_EOS, ticks_per_step=ticks_per_step,
              n_blocks=n_blocks, kv_dtype=kv_dtype, paged=True)
    ref, ref_m = _run(JaxEngine(jm, variables, kernel="gather", **kw),
                      with_prefix)
    got, got_m = _run(ContinuousEngine(tm, state, device="cpu", **kw),
                      with_prefix)
    _assert_same(got, ref, with_prefix)
    for key in ("preemptions", "prefix_hits", "prefix_queries"):
        assert got_m[key] == ref_m[key], key
    assert (got_m["preemptions"] > 0) == (n_blocks is not None)
    assert got_m["referenced_blocks"] == 0
    return got_m


@pytest.mark.parametrize("ticks_per_step,n_blocks,kv_dtype", [
    (1, None, None), (4, None, None), (1, 9, None), (4, 9, None),
    (1, None, "int8"), (4, 9, "bf16")])
def test_engine_tokens_match_jax(models, ticks_per_step, n_blocks,
                                 kv_dtype):
    """The paged engine.  ``n_blocks=9`` (8 usable blocks for 3 slots of
    up to 6 blocks each) forces preemption; ``None`` sizes the pool so
    none occurs.  int8 and bf16 pools store the same bytes in both
    packages (the quantization and the casts are bitwise equal), and the
    attention math is f32 on both sides."""
    got_m = _paged_case(models, ticks_per_step, n_blocks, kv_dtype, False)
    assert got_m["prefix_hits"] >= 2          # "b" shared "a"'s blocks


@pytest.mark.parametrize("ticks_per_step", [1, 4])
def test_paged_prefix_tokens_match_jax(models, ticks_per_step):
    """A registered prefix pins its two full blocks in the pool; the two
    requests naming it match them at admission."""
    got_m = _paged_case(models, ticks_per_step, None, None, True)
    assert got_m["prefix_hits"] >= 2 * 2


# A Llama-family model: rope, RMSNorm, SwiGLU, GQA, bias-free
# projections with biased q/k/v, untied head
_LLAMA = dict(_CFG, num_kv_heads=2, pos_encoding="rope", norm="rmsnorm",
              mlp="swiglu", use_bias=False, qkv_bias=True, tied_head=False,
              rope_base=500.0)


@pytest.fixture(scope="module")
def llama_models():
    """As ``models``, for the Llama config, with every initial value
    moved by seeded noise (flax starts biases at 0 and norm scales at
    1)."""
    jm = JaxLM(dtype=jnp.float32, **_LLAMA)
    params = jm.init(jax.random.key(1), np.zeros((1, 8), np.int32))[
        "params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), params)
    state = params_from_flax(params)
    tm = TransformerLM(dtype=torch.float32, **_LLAMA)
    tm.load_state_dict(state)
    return jm, {"params": params}, tm, state


@pytest.mark.parametrize("paged,n_blocks,with_prefix", [
    (False, None, False), (False, None, True), (True, None, False),
    (True, 9, False), (True, None, True)])
def test_llama_engine_tokens_match_jax(llama_models, paged, n_blocks,
                                       with_prefix):
    """Both engines serve the Llama config with the JAX engine's greedy
    tokens.  In the paged engine "b" attaches to the two full blocks
    "a" published (and the prefixed requests to the pinned ones): keys
    cached post-rotation at their absolute positions are read back by a
    later request; ``n_blocks=9`` adds preemption."""
    jm, variables, tm, state = llama_models
    kw = dict(_ENGINE, paged=paged, n_blocks=n_blocks)
    ref, ref_m = _run(JaxEngine(jm, variables, **kw, **(
        dict(kernel="gather") if paged else {})), with_prefix)
    got, got_m = _run(ContinuousEngine(tm, state, device="cpu", **kw),
                      with_prefix)
    assert sorted(got) == sorted(ref)
    for uri in ref:
        np.testing.assert_array_equal(got[uri], ref[uri], err_msg=uri)
    for key in ("preemptions", "prefix_hits", "prefix_queries"):
        assert got_m.get(key) == ref_m.get(key), key
    if paged:
        assert got_m["prefix_hits"] >= 2
        assert (got_m["preemptions"] > 0) == (n_blocks is not None)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_counts_prefill_shapes(models, paged):
    """Every admission prefill is counted by its shape: (rows, width) in
    the arena, (rows, suffix bucket, each row's start position) in
    paged mode, where the registered prefix and the blocks shared with
    an earlier prompt start rows past position 0."""
    _, _, tm, state = models
    eng = ContinuousEngine(tm, state, device="cpu", paged=paged, **_ENGINE)
    _run(eng, with_prefix=paged)
    shapes = eng.prefill_shapes
    assert sum(shapes.values()) == eng.prefill_calls > 0
    for key in shapes:
        assert key[1] in _ENGINE["prompt_buckets"]
        if paged:
            rows, _, pos = key
            assert len(pos) == rows
            assert all(p % _ENGINE["block_size"] == 0 for p in pos)
    if paged:
        assert any(p > 0 for _, _, pos in shapes for p in pos)


def test_default_engine_is_the_arena_in_both_packages(models):
    jm, variables, tm, state = models
    ref = JaxEngine(jm, variables, max_new_tokens=4)
    got = ContinuousEngine(tm, state, device="cpu", max_new_tokens=4)
    assert not ref.paged and not got.paged
    assert ref.cache_metrics()["mode"] == got.cache_metrics()["mode"] \
        == "arena"
    # head dim 8: the paged kernel does not take it, so the paged
    # engine resolves kernel=None to the plain read up front
    assert ContinuousEngine(tm, device="cpu", max_new_tokens=4,
                            paged=True).kernel == "gather"


def _model_of_head_dim(D):
    return TransformerLM(vocab_size=16, hidden_size=2 * D, num_layers=1,
                         num_heads=2, intermediate_size=16,
                         max_position=64, dtype=torch.float32)


@pytest.mark.parametrize("D,bs,want", [
    (32, 16, "fused"), (64, 1, "fused"), (96, 64, "fused"),
    (128, 16, "fused"), (8, 16, "gather"), (80, 16, "gather"),
    (64, 128, "gather")])
def test_paged_kernel_resolves_by_shape(D, bs, want):
    """kernel=None takes the paged kernel only where it takes (D, bs),
    decided in the constructor and recorded in ``engine.kernel``; an
    explicit kernel is kept, and an explicit "fused" for a shape the
    kernel does not take raises there, before any launch."""
    kw = dict(device="cpu", max_new_tokens=4, max_slots=2,
              prompt_buckets=(8,), paged=True, block_size=bs)
    model = _model_of_head_dim(D)
    assert ContinuousEngine(model, **kw).kernel == want
    assert ContinuousEngine(model, kernel="gather", **kw).kernel == "gather"
    if want == "fused":
        assert ContinuousEngine(model, kernel="fused", **kw).kernel \
            == "fused"
    else:
        with pytest.raises(ValueError, match="does not take head dim"):
            ContinuousEngine(model, kernel="fused", **kw)


@pytest.mark.parametrize("kw", [dict(kernel="fused"), dict(kv_dtype="bf16"),
                                dict(kv_dtype="int8")])
def test_arena_rejects_paged_knobs(models, kw):
    """As in the reference: kernel and kv_dtype select the paged path;
    the arena accepts only the plain read, kernel="gather"."""
    with pytest.raises(ValueError, match="require paged=True"):
        ContinuousEngine(models[2], device="cpu", **_ENGINE, **kw)
    ContinuousEngine(models[2], device="cpu", kernel="gather", **_ENGINE)


def test_engine_needs_a_device_or_cuda(models):
    """Entry points run on CUDA unless told otherwise: with no CUDA
    device, an engine built without ``device=`` raises."""
    tm = models[2]
    if torch.cuda.is_available():
        eng = ContinuousEngine(tm, **_ENGINE)
        assert eng.device.type == "cuda"
        tm.to("cpu")
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousEngine(tm, **_ENGINE)


@pytest.mark.parametrize("kw,item", [pytest.param(
    dict(mesh=Mesh({"dp": 2, "tp": 1}, "cpu")), "dp", id="kw0-item 6.5")])
def test_later_slice_modes_raise(models, kw, item):
    """A mesh with axes beyond tp serves (each axis but tp replicates,
    as in the reference; at tp 1 the engine serves this rank alone, with
    no control plane): its tokens equal a mesh-less engine's.  The
    tensor-parallel engines run in ``test_torch_tp_serving.py`` and
    ``test_torch_tp_mesh.py``; the QoS, elastic-pool and host-tier
    engines are built here and held to the reference in
    ``test_torch_qos.py`` and ``test_torch_kv_tier.py``."""
    on_mesh = ContinuousEngine(models[2], device="cpu", **_ENGINE, **kw)
    assert on_mesh.mesh.size(item) == 2 and on_mesh._lockstep is None
    got = _run(on_mesh)[0]
    ref = _run(ContinuousEngine(models[2], device="cpu", **_ENGINE))[0]
    assert sorted(got) == sorted(ref) == sorted(u for u, _ in _stream())
    for u in ref:
        np.testing.assert_array_equal(got[u], ref[u], err_msg=u)
    from analytics_zoo_tpu_torch.serving.policy import QosPolicy
    for ok in (dict(qos=QosPolicy()),
               dict(paged=True, elastic_pool=True),
               dict(paged=True, kv_host_store_bytes=1 << 20)):
        eng = ContinuousEngine(models[2], device="cpu", **_ENGINE, **ok)
        assert eng.cache_metrics()["qos"] is ("qos" in ok)


def test_sampled_submit_raises(models):
    """Sampling is served: a sampled submit without a seed raises as in
    the reference.  A deadline queues (an expired one is shed at
    admission); ``handoff_cb`` queues on a paged engine and raises on
    the arena, as in the reference."""
    eng = ContinuousEngine(models[2], device="cpu", **_ENGINE)
    prompt = np.arange(1, 5, dtype=np.int32)
    with pytest.raises(ValueError, match="rng_seed"):
        eng.submit("x", prompt, temperature=0.7)
    with pytest.raises(ValueError, match="requires paged"):
        eng.submit("x", prompt, handoff_cb=print)
    eng.submit("d", prompt, deadline_t=1.0)
    eng.submit("x", prompt, temperature=0.7, rng_seed=1)
    assert eng.n_waiting == 2
    eng.drain()
    assert eng.deadline_sheds == 1
    paged = ContinuousEngine(models[2], device="cpu", paged=True,
                             **_ENGINE)
    paged.submit("h", prompt, handoff_cb=print)
    assert paged.n_waiting == 1


def test_abort_releases_blocks(models):
    """An aborted resident frees its slot and every block it held; an
    aborted waiter leaves the queue."""
    _abort_case(models, paged=True)


def test_arena_abort_frees_the_slot(models):
    _abort_case(models, paged=False)


def _abort_case(models, paged):
    eng = ContinuousEngine(models[2], device="cpu", paged=paged,
                           **_ENGINE)
    done = {}
    for uri, prompt in _stream()[:4]:
        eng.submit(uri, prompt, lambda u, t: done.__setitem__(u, t))
    eng.step()
    resident = [s.uri for s in eng._slots if s is not None]
    assert eng.abort(resident[0]) and eng.abort("r2")
    assert not eng.abort("nope")
    eng.drain()
    assert set(done) == {"a", "r0", "r1", "r2"} - {resident[0], "r2"}
    assert eng.n_active == 0
    if paged:
        assert eng.cache_metrics()["referenced_blocks"] == 0
