"""The port's serving stack held to the JAX stack on the same weights.

``ClusterServing`` and ``HttpFrontend`` of each package serve a tiny
``TransformerLM`` (f32, the port's weights from the reference's through
``params_from_flax``) on the CPU, in three modes: micro-batches
(``InferenceModel.predict``), the continuous arena engine and the
continuous paged engine.  Greedy tokens through the RESP queues, through
``/predict`` and through ``/v1/generate`` must equal JAX ``generate``;
an SSE stream's token events must equal its final tokens; a sampled
request with the same seed must repeat itself and equal the port's
``generate``; the ``/metrics`` families of the two stacks must be the
same names for the same ``ServingConfig``; two engine replicas must
serve the JAX tokens too; and modes the port does not serve yet must
answer an error naming their ROADMAP item instead of hanging.  No
latency is asserted.
"""

import http.client
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.learn.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.models.lm import generate as jax_generate
from analytics_zoo_tpu.serving import ClusterServing as JaxServing
from analytics_zoo_tpu.serving import HttpFrontend as JaxFrontend
from analytics_zoo_tpu.serving import ServingConfig as JaxConfig
from analytics_zoo_tpu.serving.continuous import \
    ContinuousEngine as JaxEngine
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.lm import (TransformerLM, generate,
                                               params_from_flax)
from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                             ContinuousEngine, HttpFrontend,
                                             InputQueue, OutputQueue,
                                             ServingConfig)

_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64, ln_eps=1e-5)
_NEW = 6
_BUCKETS = (8, 16)
_MODES = {
    "batch": dict(batch_size=8, batch_timeout_ms=20.0),
    "arena": dict(continuous_batching=True, engine_slots=3,
                  engine_ticks=2),
    "paged": dict(continuous_batching=True, engine_slots=3,
                  engine_paged=True, engine_block_size=4),
}
_TIMEOUT = 90


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(dtype=jnp.float32, num_kv_heads=2, **_CFG)
    variables = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    state = params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    tm = TransformerLM(dtype=torch.float32, num_kv_heads=2, **_CFG)
    tm.load_state_dict(state)
    return jm, variables, tm


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 64, n).astype(np.int32) for n in (5, 12, 3, 9)]


_JAX_REF = {}


def _jax_tokens(models, prompt):
    key = prompt.tobytes()
    if key not in _JAX_REF:
        jm, variables, _ = models
        _JAX_REF[key] = np.asarray(jax_generate(
            jm, variables, jnp.asarray(prompt[None]), _NEW))[0]
    return _JAX_REF[key]


class _Stack:
    """One running ClusterServing + HttpFrontend pair."""

    def __init__(self, serving, frontend):
        self.serving, self.frontend = serving, frontend

    def request(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.frontend.port,
                                          timeout=_TIMEOUT)
        try:
            conn.request(method, path,
                         None if body is None else json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read().decode()
        finally:
            conn.close()

    def generate(self, **body):
        status, text = self.request("POST", "/v1/generate",
                                    dict(tokens=body.pop("tokens"), **body))
        return status, text

    def families(self):
        status, text = self.request("GET", "/metrics")
        assert status == 200, text
        return {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE ")}

    def stop(self):
        self.frontend.stop()
        self.serving.stop()


def _port_stack(models, n_replicas=1, **cfg):
    im = InferenceModel().load_torch_generator(
        models[2], None, _NEW, prompt_buckets=_BUCKETS, device="cpu")
    srv = ClusterServing(im, ServingConfig(
        prompt_col="tokens", n_replicas=n_replicas, **cfg),
        embedded_broker=True).start()
    return _Stack(srv, HttpFrontend(redis_port=srv.port, timeout=_TIMEOUT,
                                    serving=srv).start())


def _jax_stack(models, **cfg):
    jm, variables, _ = models
    im = JaxInferenceModel().load_flax_generator(
        jm, variables, max_new_tokens=_NEW, prompt_buckets=_BUCKETS)
    srv = JaxServing(im, JaxConfig(prompt_col="tokens", **cfg),
                     embedded_broker=True).start()
    return _Stack(srv, JaxFrontend(redis_port=srv.port, timeout=_TIMEOUT,
                                   serving=srv).start())


_STACKS = {}


@pytest.fixture(scope="module", autouse=True)
def _stop_stacks():
    yield
    for st in _STACKS.values():
        st.stop()
    _STACKS.clear()


def _stack(models, mode):
    if mode not in _STACKS:
        _STACKS[mode] = _port_stack(models, **_MODES[mode])
    return _STACKS[mode]


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_queue_tokens_match_jax(models, mode):
    """Ragged prompts through InputQueue/OutputQueue."""
    st = _stack(models, mode)
    inq = InputQueue(port=st.serving.port)
    outq = OutputQueue(port=st.serving.port)
    uris = [inq.enqueue(f"q-{mode}-{i}", tokens=p)
            for i, p in enumerate(_prompts())]
    for uri, p in zip(uris, _prompts()):
        got = np.asarray(outq.query(uri, timeout=_TIMEOUT))
        np.testing.assert_array_equal(got, _jax_tokens(models, p),
                                      err_msg=uri)


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_http_tokens_match_jax(models, mode):
    """``/predict`` (one instance each) and ``/v1/generate``."""
    st = _stack(models, mode)
    prompts = _prompts()
    status, text = st.request("POST", "/predict", {
        "instances": [{"tokens": p.tolist()} for p in prompts]})
    assert status == 200, text
    for p, got in zip(prompts, json.loads(text)["predictions"]):
        np.testing.assert_array_equal(np.asarray(got, np.int32),
                                      _jax_tokens(models, p))
    for p in prompts[:2]:
        status, text = st.generate(tokens=p.tolist())
        assert status == 200, text
        np.testing.assert_array_equal(
            np.asarray(json.loads(text)["tokens"], np.int32),
            _jax_tokens(models, p))


def _sse(text):
    events = []
    for chunk in text.split("\n\n"):
        lines = dict(line.split(": ", 1) for line in chunk.splitlines()
                     if ": " in line and not line.startswith(":"))
        if "event" in lines:
            events.append((lines["event"], json.loads(lines["data"])))
    return events


@pytest.mark.parametrize("mode", ["arena", "paged"])
def test_sse_stream_equals_final_tokens(models, mode):
    st = _stack(models, mode)
    p = _prompts()[1]
    status, text = st.generate(tokens=p.tolist(), stream=True)
    assert status == 200, text
    events = _sse(text)
    assert events[0][0] == "start" and events[-1][0] == "done", events
    toks = [e["token"] for k, e in events if k == "token"]
    assert [e["index"] for k, e in events if k == "token"] == list(
        range(_NEW))
    np.testing.assert_array_equal(np.asarray(toks, np.int32),
                                  _jax_tokens(models, p))


@pytest.mark.parametrize("mode", ["arena", "paged"])
def test_sampled_generate_repeats_with_its_seed(models, mode):
    """The same seed twice gives the same tokens, equal to the port's
    ``generate``; another seed gives others."""
    st = _stack(models, mode)
    p = _prompts()[0]
    body = dict(tokens=p.tolist(), temperature=0.9, top_p=0.9, seed=1234)
    outs = []
    for _ in range(2):
        status, text = st.generate(**dict(body))
        assert status == 200, text
        outs.append(json.loads(text)["tokens"])
    assert outs[0] == outs[1]
    ref = generate(models[2], None, p[None], _NEW, temperature=0.9,
                   top_p=0.9, rng=1234, device="cpu")[0].tolist()
    assert outs[0] == ref
    others = set()
    for seed in (1, 2, 3):
        status, text = st.generate(**dict(body, seed=seed))
        assert status == 200, text
        others.add(tuple(json.loads(text)["tokens"]))
    assert len(others | {tuple(outs[0])}) > 1


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_metrics_families_match_jax(models, mode):
    """The same config and requests on both stacks expose the same
    ``/metrics`` family names."""
    prompts = _prompts()[:2]
    stacks = [_port_stack(models, **_MODES[mode]),
              _jax_stack(models, **_MODES[mode])]
    try:
        for st in stacks:
            for p in prompts:
                status, text = st.generate(tokens=p.tolist())
                assert status == 200, text
                np.testing.assert_array_equal(
                    np.asarray(json.loads(text)["tokens"], np.int32),
                    _jax_tokens(models, p))
        port, ref = (st.families() for st in stacks)
    finally:
        for st in stacks:
            st.stop()
    assert port == ref, (sorted(port - ref), sorted(ref - port))
    if mode != "batch":     # the engine's own scrape-time gauges
        assert {"zoo_engine_active_slots", "zoo_engine_queue_depth",
                "zoo_engine_kv_bytes_per_token"} <= port


def test_two_replicas_match_jax(models):
    st = _port_stack(models, n_replicas=2, **_MODES["paged"])
    try:
        assert len(st.serving.engines) == 2
        inq = InputQueue(port=st.serving.port)
        outq = OutputQueue(port=st.serving.port)
        prompts = _prompts() * 2
        uris = [inq.enqueue(f"r-{i}", tokens=p)
                for i, p in enumerate(prompts)]
        for uri, p in zip(uris, prompts):
            got = np.asarray(outq.query(uri, timeout=_TIMEOUT))
            np.testing.assert_array_equal(got, _jax_tokens(models, p),
                                          err_msg=uri)
    finally:
        st.stop()


def test_unported_modes_answer_errors(models, tmp_path):
    """An image payload that does not decode answers an error result
    (image payloads are served: ``tests/test_torch_data.py``), and
    ``from_config`` refuses a SavedModel directory (its TensorFlow
    loader, ROADMAP Queue 1 item 4, is not ported; ``.xml`` and ``.pt``
    artifacts serve: ``tests/test_torch_serving_cli.py``).  The engine
    modes of
    items 4.5 and 4.6 are served: ``/v1/generate`` with a deadline
    answers the JAX tokens, a request whose deadline has passed answers
    the reference's ``deadline_exceeded``, and servers with QoS or the
    elastic pool start and serve."""
    st = _stack(models, "paged")
    p = _prompts()[1]
    status, text = st.generate(tokens=p.tolist(), deadline_ms=60_000)
    assert status == 200, (status, text)
    np.testing.assert_array_equal(
        np.asarray(json.loads(text)["tokens"], np.int32),
        _jax_tokens(models, p))
    inq = InputQueue(port=st.serving.port)
    outq = OutputQueue(port=st.serving.port)
    late = inq.enqueue("late", tokens=p, deadline=np.int64(
        int(time.time() * 1000) - 1000))
    with pytest.raises(RuntimeError, match="deadline_exceeded"):
        outq.query(late, timeout=_TIMEOUT)
    assert st.serving.engines[0].deadline_sheds == 1
    uri = inq.enqueue_image("img", image=b"\x89PNG not an image",
                            col="tokens")
    with pytest.raises(RuntimeError, match="cannot identify image"):
        outq.query(uri, timeout=_TIMEOUT)
    # the stack still serves after both
    status, text = st.generate(tokens=_prompts()[2].tolist())
    assert status == 200, text
    for cfg in (dict(qos_enabled=True), dict(engine_elastic_pool=True)):
        st = _port_stack(models, **_MODES["paged"], **cfg)
        try:
            status, text = st.generate(tokens=p.tolist(),
                                       priority="interactive")
            assert status == 200, (cfg, status, text)
            np.testing.assert_array_equal(
                np.asarray(json.loads(text)["tokens"], np.int32),
                _jax_tokens(models, p))
        finally:
            st.stop()
    cfg = tmp_path / "config.yaml"
    cfg.write_text(f"model:\n  path: {tmp_path}\n")
    with pytest.raises(NotImplementedError, match="item 4"):
        ClusterServing.from_config(str(cfg), device="cpu")


def test_default_paged_stack_picks_the_kernel():
    """A paged server of the default config reads through the paged
    kernel wherever it takes the model's head dim and block size (on a
    CPU tensor the kernel's wrapper runs its plain version): the engine
    resolves ``"fused"`` and serves ``generate``'s greedy tokens."""
    torch.manual_seed(3)
    tm = TransformerLM(dtype=torch.float32, num_kv_heads=2,
                       **dict(_CFG, hidden_size=64, num_heads=2))
    im = InferenceModel().load_torch_generator(
        tm, None, _NEW, prompt_buckets=_BUCKETS, device="cpu")
    assert im.make_continuous_engine(paged=True, block_size=4).kernel == \
        "fused"
    assert ServingConfig().engine_kernel is None
    srv = ClusterServing(im, ServingConfig(prompt_col="tokens",
                                           **_MODES["paged"]),
                         embedded_broker=True).start()
    st = _Stack(srv, HttpFrontend(redis_port=srv.port, timeout=_TIMEOUT,
                                  serving=srv).start())
    try:
        assert [e.kernel for e in srv.engines] == ["fused"]
        for p in _prompts()[:2]:
            status, text = st.generate(tokens=p.tolist())
            assert status == 200, text
            pb = next(b for b in _BUCKETS if len(p) <= b)
            padded = np.zeros((1, pb), np.int32)
            padded[0, :len(p)] = p
            want = generate(tm, None, padded, _NEW, prompt_len=[len(p)],
                            device="cpu")[0].numpy()
            np.testing.assert_array_equal(
                np.asarray(json.loads(text)["tokens"], np.int32), want)
    finally:
        st.stop()


def test_inference_model_matches_jax(models):
    """``load_torch_generator`` + ``predict`` against the reference's
    ``load_flax_generator`` + ``predict``: ragged right-padded prompts,
    lengths given or inferred from the pad id, a batch above the largest
    batch bucket (chunked), and the same serving bounds."""
    jm, variables, tm = models
    prompts = _prompts()
    width = max(len(p) for p in prompts)
    batch = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    ref_im = JaxInferenceModel(batch_buckets=(1, 2)).load_flax_generator(
        jm, variables, max_new_tokens=_NEW, prompt_buckets=_BUCKETS)
    im = InferenceModel(batch_buckets=(1, 2)).load_torch_generator(
        tm, None, _NEW, prompt_buckets=_BUCKETS, device="cpu")
    assert (im.max_prompt_width, im.prompt_pad_id) == (
        ref_im.max_prompt_width, ref_im.prompt_pad_id)
    want = np.asarray(ref_im.predict(batch, lens))
    np.testing.assert_array_equal(im.predict(batch, lens), want)
    np.testing.assert_array_equal(im.predict(batch), want)
    with pytest.raises(ValueError, match="empty prompt"):
        im.predict(np.zeros((1, 4), np.int32))
    # weight-only quantization is served (tests/test_torch_quantize.py);
    # on-MXU int8 is load_flax's alone, as in the reference
    with pytest.raises(ValueError, match="only supported by load_flax"):
        im.load_torch_generator(tm, None, 4, quantize="int8_mxu",
                                device="cpu")
    # load_flax serves the reference's tree on a port module (through
    # the LM's own converter), as the reference's load_flax serves it
    flax_im = InferenceModel(batch_buckets=(1, 2)).load_flax(
        tm, variables, device="cpu")
    ref_flax = JaxInferenceModel(batch_buckets=(1, 2)).load_flax(
        jm, variables)
    np.testing.assert_allclose(flax_im.predict(batch),
                               np.asarray(ref_flax.predict(batch)),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="item 9"):
        im.load_tf("model")


@pytest.mark.parametrize("paged", [False, True])
def test_engine_surface_matches_jax(models, paged):
    """What the serving layer reads off an engine, after the same
    requests on both packages' engines: ``capacity_report`` (same keys,
    same values), the flight records' schema, the telemetry registry's
    metric names and the ``record_timings`` stamps."""
    jm, variables, tm = models
    kw = dict(max_new_tokens=_NEW, max_slots=3, prompt_buckets=_BUCKETS,
              record_timings=True, paged=paged, block_size=4)
    engines = [JaxEngine(jm, variables, **kw),
               ContinuousEngine(tm, None, device="cpu", **kw)]
    for eng in engines:
        for i, p in enumerate(_prompts()):
            eng.submit(f"u{i}", p, priority="interactive", tenant="t")
        eng.drain()
    ref, got = engines
    assert got.capacity_report() == ref.capacity_report()
    assert len(got.flight) == len(ref.flight) > 0
    assert [sorted(r) for r in got.flight.snapshot()] == [
        sorted(r) for r in ref.flight.snapshot()]
    assert sorted(n for n, _ in got.telemetry.metrics.items()) == sorted(
        n for n, _ in ref.telemetry.metrics.items())
    rt, gt = ref.pop_request_timings(), got.pop_request_timings()
    assert sorted(gt) == sorted(rt) == [f"u{i}" for i in range(4)]
    assert all(len(gt[u]["token_times"]) == _NEW for u in gt)
    assert got.alloc_fail_streak == 0 and got.spec_acceptance() is None
    got.set_brownout(0)
    for eng in engines:
        eng.set_brownout(1)
    assert got.brownout_level == ref.brownout_level == 1
    # no elastic pool: the control step is a no-op in both
    assert got.maybe_autoresize() == ref.maybe_autoresize() == 0
    if not paged:
        for eng in engines:
            with pytest.raises(ValueError, match="paged engine"):
                eng.submit_handoff({})
