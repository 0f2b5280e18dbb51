"""The port's paged ContinuousEngine held to the JAX engine.

The same request stream goes to the reference
``ContinuousEngine(paged=True, kernel="gather")`` at f32 and to the
port on the CPU, on the same weights (``params_from_flax``).  The
stream mixes prompt lengths, carries two requests that share two full
prompt blocks (the second is admitted in a later wave, so it attaches
to the first one's published blocks), and stops rows at an ``eos_id``
that the greedy streams really emit.  Greedy tokens must be IDENTICAL
per URI, and the preemption and prefix-hit counters equal.
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


def _run(engine):
    out = {}
    for uri, prompt in _stream():
        engine.submit(uri, prompt, lambda u, t: out.__setitem__(u, t))
    engine.drain()
    return out, engine.cache_metrics()


@pytest.mark.parametrize("ticks_per_step,n_blocks,kv_dtype", [
    (1, None, None), (4, None, None), (1, 9, None), (4, 9, None),
    (1, None, "int8"), (4, 9, "bf16")])
def test_engine_tokens_match_jax(models, ticks_per_step, n_blocks,
                                 kv_dtype):
    """``n_blocks=9`` (8 usable blocks for 3 slots of up to 6 blocks
    each) forces preemption; ``None`` sizes the pool so none occurs.
    int8 and bf16 pools store the same bytes in both packages (the
    quantization and the casts are bitwise equal), and the attention
    math is f32 on both sides."""
    jm, variables, tm, state = models
    kw = dict(_ENGINE, eos_id=_EOS, ticks_per_step=ticks_per_step,
              n_blocks=n_blocks, kv_dtype=kv_dtype)
    ref, ref_m = _run(JaxEngine(jm, variables, paged=True,
                                kernel="gather", **kw))
    got, got_m = _run(ContinuousEngine(tm, state, device="cpu", **kw))
    assert sorted(got) == sorted(ref) == sorted(u for u, _ in _stream())
    for uri in ref:
        np.testing.assert_array_equal(got[uri], np.asarray(ref[uri]),
                                      err_msg=uri)
    for key in ("preemptions", "prefix_hits", "prefix_queries"):
        assert got_m[key] == ref_m[key], key
    assert got_m["prefix_hits"] >= 2          # "b" shared "a"'s blocks
    assert (got_m["preemptions"] > 0) == (n_blocks is not None)
    # the eos path ran: some row stopped early on eos (frozen tail)
    assert any((t[:-1] == _EOS).any() for t in got.values())
    assert got_m["referenced_blocks"] == 0


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


@pytest.mark.parametrize("kw,item", [
    (dict(paged=False), "4.4"), (dict(chunked=True), "4.2"),
    (dict(draft_model=object()), "4.3"), (dict(qos=object()), "4.5"),
    (dict(elastic_pool=True), "4.6"),
    (dict(kv_host_store_bytes=1 << 20), "4.6"),
    (dict(mesh=object()), "item 6")])
def test_later_slice_modes_raise(models, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        ContinuousEngine(models[2], device="cpu", **_ENGINE, **kw)


def test_sampled_submit_raises(models):
    eng = ContinuousEngine(models[2], device="cpu", **_ENGINE)
    with pytest.raises(NotImplementedError, match="sampled"):
        eng.submit("x", np.arange(1, 5, dtype=np.int32), temperature=0.7,
                   rng_seed=1)


def test_abort_releases_blocks(models):
    """An aborted resident frees its slot and every block it held; an
    aborted waiter leaves the queue."""
    eng = ContinuousEngine(models[2], device="cpu", **_ENGINE)
    done = {}
    for uri, prompt in _stream()[:4]:
        eng.submit(uri, prompt, lambda u, t: done.__setitem__(u, t))
    eng.step()
    resident = [s.uri for s in eng._slots if s is not None]
    assert eng.abort(resident[0]) and eng.abort("r2")
    assert not eng.abort("nope")
    eng.drain()
    assert set(done) == {"a", "r0", "r1", "r2"} - {resident[0], "r2"}
    assert eng.cache_metrics()["referenced_blocks"] == 0
