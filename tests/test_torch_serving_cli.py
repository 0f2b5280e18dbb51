"""The port's config-file entry point: ``ClusterServing.from_config``,
``ServingConfig.from_yaml`` and ``python -m
analytics_zoo_tpu_torch.serving`` (``serving/__main__.py``), held to the
JAX package's.

- ``from_config`` over the reference's cases (an OpenVINO IR served
  through the queues; every refusal) with the same exception types and
  words.
- The port's CLI against the reference's CLI on the same IR, both
  answering ``/predict`` over HTTP, within 1e-5.
- A tiny BERT classifier pickled as ``.pt`` and served through the CLI
  on ``--platform cpu``: every answer equals
  ``InferenceModel().load_torch(path, device="cpu").predict`` of its row
  (atol 1e-6: the server pads micro-batches to its own batch sizes).
- Without ``--platform`` the CLI loads onto the card, and raises here.
- ``from_yaml`` reads a config into the reference's fields.
- The CLI as a process: banner, SIGTERM, exit code 0, a valid trace.
"""

import dataclasses
import http.client
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.serving import ClusterServing as JaxServing
from analytics_zoo_tpu.serving import ServingConfig as JaxConfig
from analytics_zoo_tpu.serving.__main__ import main as jax_main
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.transformer import (
    BERT, BERTForSequenceClassification)
from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                             OutputQueue, ServingConfig,
                                             validate_chrome_trace)
from analytics_zoo_tpu_torch.serving.__main__ import main

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_openvino import _mlp_ir  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_TIMEOUT = 60
_FEATS = ("input_ids", "token_type_ids", "attention_mask")


def _predict(port, instances):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=_TIMEOUT)
    conn.request("POST", "/predict", json.dumps({"instances": instances}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read()
    assert resp.status == 200, body
    return np.asarray(json.loads(body)["predictions"], np.float32)


def _config(tmp_path, model_path, **params):
    p = tmp_path / "config.yaml"
    lines = [f"model:\n  path: {model_path}\n"]
    if params:
        lines.append("params:\n" + "".join(f"  {k}: {v}\n"
                                           for k, v in params.items()))
    p.write_text("".join(lines))
    return str(p)


def _error(fn):
    """(type, message) of what ``fn`` raises."""
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def test_from_config_serves_an_ir_as_the_reference(tmp_path):
    rng = np.random.default_rng(5)
    xml, _ = _mlp_ir(tmp_path, rng)
    cfg = _config(tmp_path, xml, batch_size=16)
    x = rng.normal(size=(4,)).astype(np.float32)
    got = {}
    for name, cls, kw in (("port", ClusterServing, {"device": "cpu"}),
                          ("ref", JaxServing, {})):
        serving = cls.from_config(cfg, embedded_broker=True, **kw).start()
        try:
            InputQueue(port=serving.port).enqueue("cfg-req", x=x)
            got[name] = np.asarray(OutputQueue(port=serving.port).query(
                "cfg-req", timeout=_TIMEOUT))
        finally:
            serving.stop()
    np.testing.assert_allclose(got["port"], got["ref"], rtol=1e-5,
                               atol=1e-6)


def test_from_config_refuses_as_the_reference(tmp_path):
    blob = tmp_path / "weights.bin"
    blob.write_bytes(b"\0" * 8)
    cases = [str(blob), "/models/typo_dir", "/models/typo.xml",
             "/models/typo.pt", "''"]
    for path in cases:
        cfg = _config(tmp_path, path)
        want = _error(lambda: JaxServing.from_config(cfg))
        got = _error(lambda: ClusterServing.from_config(cfg, device="cpu"))
        assert got == want, path
    assert want[0] is ValueError and "model.path" in want[1]
    # continuous batching: the reference's words, and the port's loader
    xml = tmp_path / "weights.xml"
    xml.write_bytes(b"<net/>")
    cfg = _config(tmp_path, xml, continuous_batching="true")
    want = _error(lambda: JaxServing.from_config(cfg))
    got = _error(lambda: ClusterServing.from_config(cfg, device="cpu"))
    assert got[0] is want[0] is ValueError
    assert "load_flax_generator" in got[1]
    assert "load_torch_generator" in got[1]
    # a directory is a SavedModel, whose loader is not ported
    cfg = _config(tmp_path, tmp_path)
    with pytest.raises(NotImplementedError, match="item 4"):
        ClusterServing.from_config(cfg, device="cpu")


def test_cli_answers_as_the_reference_cli(tmp_path):
    rng = np.random.default_rng(6)
    xml, _ = _mlp_ir(tmp_path, rng)
    cfg = _config(tmp_path, xml, batch_size=8)
    xs = rng.normal(size=(3, 4)).astype(np.float32)
    instances = [{"x": x.tolist()} for x in xs]
    got = {}
    for name, run, extra in (("port", main, ["--platform", "cpu"]),
                             ("ref", jax_main, [])):
        serving, frontend, shutdown = run(
            [cfg, "--embedded-broker", "--http-port", "0"] + extra,
            block=False)
        try:
            assert frontend is not None and frontend.port > 0
            got[name] = _predict(frontend.port, instances)
        finally:
            shutdown()
    assert got["port"].shape == (3, 3)
    np.testing.assert_allclose(got["port"], got["ref"], rtol=1e-5,
                               atol=1e-6)


def _bert_pt(tmp_path):
    torch.manual_seed(0)
    model = BERTForSequenceClassification(2, BERT(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position=64))
    path = tmp_path / "bert.pt"
    torch.save(model, path)
    rng = np.random.default_rng(7)
    n, T = 10, 16
    lens = rng.integers(3, T + 1, n)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    rows = {"input_ids": rng.integers(1, 128, (n, T)).astype(np.int32) * mask,
            "token_type_ids": (np.arange(T)[None] >= lens[:, None] // 2
                               ).astype(np.int32) * mask,
            "attention_mask": mask}
    return str(path), rows


def test_cli_serves_a_pt_classifier_on_the_cpu(tmp_path):
    path, rows = _bert_pt(tmp_path)
    want = InferenceModel().load_torch(path, device="cpu").predict(
        *[rows[c] for c in _FEATS])
    cfg = _config(tmp_path, path, batch_size=4)
    serving, frontend, shutdown = main(
        [cfg, "--embedded-broker", "--http-port", "0", "--platform", "cpu"],
        block=False)
    try:
        assert serving.model.device == torch.device("cpu")
        n = len(want)
        got = np.concatenate([_predict(frontend.port, [
            {c: rows[c][i].tolist() for c in _FEATS}
            for i in range(lo, min(lo + 3, n))]) for lo in range(0, n, 3)])
    finally:
        shutdown()
    assert got.shape == want.shape == (10, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only host")
def test_cli_loads_onto_the_card_by_default(tmp_path):
    path, _ = _bert_pt(tmp_path)
    cfg = _config(tmp_path, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([cfg, "--embedded-broker"], block=False)


def test_from_yaml_reads_as_the_reference(tmp_path):
    cfg = _config(tmp_path, "/models/m.xml", batch_size=12, core_number=2,
                  workers=3, engine_slots=3, qos_enabled="true",
                  image_shape="[3, 32, 32]", continuous_batching="false")
    with open(cfg, "a") as f:
        f.write("redis:\n  src: h:7000\n")
    got = dataclasses.asdict(ServingConfig.from_yaml(cfg))
    want = dataclasses.asdict(JaxConfig.from_yaml(cfg))
    got.pop("engine_kernel")
    want.pop("engine_kernel")
    assert got == want
    assert (got["model_path"], got["redis_host"], got["redis_port"],
            got["batch_size"], got["engine_slots"], got["qos_enabled"]) == (
        "/models/m.xml", "h", 7000, 12, 3, True)


def test_cli_process_stops_cleanly_on_sigterm(tmp_path):
    rng = np.random.default_rng(8)
    xml, _ = _mlp_ir(tmp_path, rng)
    cfg = _config(tmp_path, xml, batch_size=4)
    trace = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving", cfg,
         "--embedded-broker", "--http-port", "0", "--platform", "cpu",
         "--trace", str(trace)], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        banner = proc.stdout.readline()
        assert "serving up on" in banner, proc.stderr.read()
        port = int(banner.split("http on :")[1].split()[0])
        x = rng.normal(size=(2, 4)).astype(np.float32)
        assert _predict(port, [{"x": r.tolist()} for r in x]).shape == (2, 3)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    assert "trace written" in out
    validate_chrome_trace(json.loads(trace.read_text()))
