"""The port's QoS, deadline and brownout modes held to the JAX engine.

Tiny f32 models, the same seeded weights in both packages
(``params_from_flax``).  Each mode runs the same requests through the
reference's ``ContinuousEngine`` and the port's on the CPU, stepped in
the same schedule, and must give equal greedy tokens and equal
decisions: the order requests finish in, the requests shed and their
errors, the deadline and brownout counters, and every tick's flight
record on the decision fields (tick kind, resident rows, preemptions,
speculative proposals and acceptances, the QoS backlog, the brownout
level, the deadline sheds).  QoS runs with an aging horizon far beyond
the test and deadlines are either long past or far ahead, so no
decision depends on timing.
"""

import collections
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.serving.continuous import \
    ContinuousEngine as JaxEngine
from analytics_zoo_tpu.serving.continuous import \
    DeadlineExceeded as JaxDeadlineExceeded
from analytics_zoo_tpu.serving.policy import QosPolicy as JaxQos
from analytics_zoo_tpu_torch.models.lm import (TransformerLM, generate,
                                               params_from_flax)
from analytics_zoo_tpu_torch.serving.continuous import (ContinuousEngine,
                                                        DeadlineExceeded)
from analytics_zoo_tpu_torch.serving.policy import QosPolicy

_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64, ln_eps=1e-5)
_ENGINE = dict(max_new_tokens=5, max_slots=2, prompt_buckets=(8, 16),
               block_size=4)
_MODES = {"arena": {}, "paged": dict(paged=True),
          "chunked": dict(paged=True, chunked=True, tick_token_budget=8)}
_DECISIONS = ("kind", "decode_uris", "prefill_uris", "preempted",
              "spec_proposed", "spec_accepted", "qos_depths",
              "brownout_level", "deadline_sheds")
_PRIORITIES = ("batch", "standard", "interactive")


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(dtype=jnp.float32, num_kv_heads=2, **_CFG)
    variables = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    state = params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    tm = TransformerLM(dtype=torch.float32, num_kv_heads=2, **_CFG)
    tm.load_state_dict(state)
    return jm, variables, tm, state


def _engines(models, qos=False, draft=False, **kw):
    """The reference engine and the port's, built alike (``qos``: each
    package's ``QosPolicy`` with aging beyond the test; ``draft``: the
    target drafts for itself, speculation_k 2)."""
    jm, jv, tm, state = models
    jkw, tkw = dict(_ENGINE, **kw), dict(_ENGINE, **kw)
    if qos:
        jkw["qos"], tkw["qos"] = JaxQos(aging_s=1e9), QosPolicy(aging_s=1e9)
    if draft:
        jkw.update(draft_model=jm, draft_variables=jv, speculation_k=2)
        tkw.update(draft_model=tm, draft_variables=state, speculation_k=2)
    return JaxEngine(jm, jv, **jkw), ContinuousEngine(tm, state,
                                                      device="cpu", **tkw)


def _requests(priorities=_PRIORITIES * 2, seed=3):
    """(uri, prompt, priority, tenant) per priority given; tenants
    alternate."""
    rng = np.random.default_rng(seed)
    return [(f"p{i}", rng.integers(1, 64, int(rng.integers(3, 14)))
             .astype(np.int32), pr, f"t{i % 2}")
            for i, pr in enumerate(priorities)]


class _Log:
    """One engine's outcomes: tokens and errors by URI, and the order
    requests finished or failed in."""

    def __init__(self):
        self.out, self.err, self.order = {}, {}, []

    def done(self, uri, toks):
        self.out[uri] = np.asarray(toks)
        self.order.append(uri)

    def error(self, uri, exc):
        self.err[uri] = exc
        self.order.append(uri)


def _submit(eng, log, reqs, **kw):
    for uri, prompt, priority, tenant in reqs:
        eng.submit(uri, prompt, log.done, on_error=log.error,
                   priority=priority, tenant=tenant, **kw)


def _run(eng, log, reqs, schedule=(), **kw):
    """Submit ``reqs`` and step until idle; ``schedule`` maps a step
    index to a brownout level set before that step."""
    _submit(eng, log, reqs, **kw)
    levels = dict(schedule)
    for t in range(500):
        if t in levels:
            eng.set_brownout(levels[t], standard_max_new=2)
        if eng.step() == 0 and eng.n_waiting == 0:
            return
    raise AssertionError("engine did not drain")


def _decisions(eng):
    return [tuple(r.get(k) for k in _DECISIONS)
            for r in eng.flight.snapshot()]


def _same(ref, got, jeng, teng):
    assert got.order == ref.order
    assert sorted(got.out) == sorted(ref.out)
    for uri in ref.out:
        np.testing.assert_array_equal(got.out[uri], ref.out[uri],
                                      err_msg=uri)
    assert sorted(got.err) == sorted(ref.err)
    assert _decisions(teng) == _decisions(jeng)


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_qos_engine_matches_jax(models, mode):
    """More requests than slots, three classes over two tenants, batch
    submitted first: the weighted queue admits, and (chunked) the grant
    rank lands chunks, in the reference's order; the backlog by class
    and tenant and the tokens are equal, and the tokens equal plain
    greedy ``generate`` (QoS only reorders)."""
    jeng, teng = _engines(models, qos=True, **_MODES[mode])
    reqs = _requests(("batch",) * 3 + ("standard",) * 2
                     + ("interactive",) * 3)
    ref, got = _Log(), _Log()
    for eng, log in ((jeng, ref), (teng, got)):
        _submit(eng, log, reqs)
    waiting = teng.cache_metrics()["qos_waiting"]
    assert waiting == jeng.cache_metrics()["qos_waiting"]
    assert sum(waiting.values()) == len(reqs)
    jeng.drain()
    teng.drain()
    _same(ref, got, jeng, teng)
    assert teng.cache_metrics()["qos"] is True
    # the weights move interactive work ahead of batch submitted first
    assert got.order.index("p7") < got.order.index("p2")
    tm = models[2]
    for uri, prompt, _, _ in reqs:
        plain = generate(tm, None, prompt[None], 5, device="cpu")[0]
        np.testing.assert_array_equal(got.out[uri], plain.numpy(),
                                      err_msg=uri)


def test_qos_off_is_plain_fifo(models):
    """Without a policy the queue is the plain deque of both packages,
    and the same stream finishes in the same order with the same
    decisions as the reference."""
    jeng, teng = _engines(models, paged=True)
    assert type(teng._waiting) is collections.deque
    assert teng.cache_metrics()["qos"] is False
    ref, got = _Log(), _Log()
    _run(jeng, ref, _requests())
    _run(teng, got, _requests())
    _same(ref, got, jeng, teng)


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_deadlines_match_jax(models, mode):
    """Requests whose deadline passed are shed at admission before any
    prefill, with ``DeadlineExceeded`` errors starting with
    ``deadline_exceeded``; their neighbours with time to spare are
    served; counters and flight records equal the reference's."""
    jeng, teng = _engines(models, **_MODES[mode])
    reqs = _requests()
    now = time.monotonic()
    ref, got = _Log(), _Log()
    for eng, log in ((jeng, ref), (teng, got)):
        for i, (uri, prompt, priority, tenant) in enumerate(reqs):
            eng.submit(uri, prompt, log.done, on_error=log.error,
                       priority=priority, tenant=tenant,
                       deadline_t=now - 1.0 if i % 3 == 1 else now + 600)
        eng.drain()
    _same(ref, got, jeng, teng)
    assert sorted(got.err) == ["p1", "p4"]
    for uri, exc in got.err.items():
        assert isinstance(exc, DeadlineExceeded), exc
        assert isinstance(ref.err[uri], JaxDeadlineExceeded)
        assert str(exc).startswith("deadline_exceeded")
    assert teng.deadline_sheds == jeng.deadline_sheds == 2
    snap = teng.telemetry.metrics.snapshot()
    assert snap["zoo_engine_deadline_admission_sheds_total"] == 2


def test_expired_only_queue_never_prefills(models):
    """An expired backlog is shed in one admission pass: no slot, no
    prefill call, no block."""
    jeng, teng = _engines(models, paged=True)
    p = np.asarray([7, 3, 9], np.int32)
    for eng in (jeng, teng):
        for i in range(3):
            eng.submit(f"d{i}", p, deadline_t=time.monotonic() - 0.5)
        eng.step()
        assert eng.n_active == 0 and eng.n_waiting == 0
        assert eng.deadline_sheds == 3
    assert teng.prefill_calls == 0
    assert teng.cache_metrics()["referenced_blocks"] == 0


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("level", [1, 2, 4])
def test_brownout_matches_jax(models, mode, level):
    """Levels 1, 2 and 4 from the start: held classes wait behind the
    admissible ones and are served work-conservingly once nothing
    admissible is left; level 2 clamps standard requests' tokens to 2
    at slot install.  Order, tokens, decisions and the level in every
    flight record equal the reference's."""
    jeng, teng = _engines(models, **_MODES[mode])
    reqs = _requests()
    ref, got = _Log(), _Log()
    _run(jeng, ref, reqs, schedule={0: level})
    _run(teng, got, reqs, schedule={0: level})
    _same(ref, got, jeng, teng)
    assert teng.brownout_level == level
    assert {r["brownout_level"] for r in teng.flight.snapshot()} == {level}
    if level >= 2:
        assert all(len(got.out[u]) == 2 for u, _, p, _ in reqs
                   if p == "standard")


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_brownout_level3_drops_speculation(models, mode):
    """A self-drafted speculative engine taken to level 3 for a few
    steps and back: the browned-out ticks decode with the target alone
    (``decode``/``chunked`` kinds, no proposals), the draft's pointer
    goes stale, and the tokens still equal plain greedy ``generate``
    (cut to 2 for standard requests admitted under the level's token
    clamp); tick kinds, proposals and acceptances equal the
    reference's."""
    jeng, teng = _engines(models, draft=True, **_MODES[mode])
    reqs = _requests()
    ref, got = _Log(), _Log()
    schedule = {2: 3, 6: 0}
    _run(jeng, ref, reqs, schedule=schedule)
    _run(teng, got, reqs, schedule=schedule)
    _same(ref, got, jeng, teng)
    kinds = [r["kind"] for r in teng.flight.snapshot()]
    assert not kinds[2].startswith("spec") and kinds[0].startswith("spec")
    assert teng.spec_acceptance() == jeng.spec_acceptance()
    tm = models[2]
    for uri, prompt, priority, _ in reqs:
        plain = generate(tm, None, prompt[None], 5, device="cpu")[0]
        n = len(got.out[uri])
        assert n == 5 or (n == 2 and priority == "standard"), (uri, n)
        np.testing.assert_array_equal(got.out[uri], plain.numpy()[:n],
                                      err_msg=uri)
