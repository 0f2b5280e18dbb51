"""The port's continuous-batching engine held to the simulator
(``serving/sim/``, the pinned copy of the reference's), its flight
bundles rendered and replayed by ``serving/debug.py``, and the sim's
command line.

- Decision equivalence, as the reference's ``tests/test_sim.py``
  ``TestEngineSimEquivalence`` (the reference's tiny LM shape, f32, the
  same schedule and knobs): the port's ``ContinuousEngine`` and the
  pinned ``EngineModel`` make the same admission order, prefill-chunk
  grants ``(uri, tokens)`` and preemption victims, for ``fifo``, ``qos``
  and ``spec`` (a self-draft accepts every proposal, so the sim's
  acceptance is the constant k).
- The live bundle round trip (``dump_bundle`` -> ``replay_bundle``
  cross-check ok), then ``debug.main`` rc 0 (rendered, replayed) and rc
  2 (no bundle, unknown uri), as ``tests/test_flight.py``.
- ``python -S serving/debug.py <bundle> --replay``: the file alone, with
  neither torch nor numpy importable, rc 0.
- ``python -m analytics_zoo_tpu_torch.serving.sim gate
  tests/golden/sim_golden.json``: rc 0.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.models.lm import TransformerLM
from analytics_zoo_tpu_torch.serving import debug
from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine
from analytics_zoo_tpu_torch.serving.flight import SloWatchdog, dump_bundle
from analytics_zoo_tpu_torch.serving.policy import PRIORITIES, QosPolicy
from analytics_zoo_tpu_torch.serving.sim import (AcceptanceModel,
                                                 EngineConfig, EngineModel,
                                                 Request,
                                                 SUPPORTED_SCHEMA_VERSIONS,
                                                 replay_bundle)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "sim_golden.json"
KNOBS = dict(max_new_tokens=5, max_slots=3, prompt_buckets=(8, 16),
             chunked=True, tick_token_budget=16, paged=True, block_size=4)


@pytest.fixture(scope="module")
def lm():
    torch.manual_seed(0)
    model = TransformerLM(vocab_size=32, hidden_size=32, num_layers=2,
                          num_heads=2, intermediate_size=64, max_position=64,
                          dtype=torch.float32)
    return model, model.state_dict()


def engine_decisions(eng):
    """Admission order, chunk grants and preemption victims from the
    engine's telemetry events, as the reference's test reads them."""
    evs = eng.telemetry.events.snapshot()
    return {
        "admits": [a["uri"] for ph, nm, ts, d, t, a in evs
                   if nm == "admitted"],
        "chunks": [(a["uri"], a["tokens"]) for ph, nm, ts, d, t, a in evs
                   if nm == "prefill_chunk"],
        "preempts": [a["uri"] for ph, nm, ts, d, t, a in evs
                     if nm == "preempted"],
    }


def sim_decisions(reqs, qos, spec, n_blocks, **knobs):
    """The pinned ``EngineModel``'s decisions on the same schedule."""
    cfg = EngineConfig(slots=knobs["max_slots"],
                       max_new_tokens=knobs["max_new_tokens"],
                       prompt_buckets=knobs["prompt_buckets"],
                       chunked=knobs["chunked"],
                       tick_token_budget=knobs["tick_token_budget"],
                       paged=knobs["paged"],
                       block_size=knobs["block_size"], n_blocks=n_blocks,
                       spec_k=spec)
    acc = AcceptanceModel.constant(spec, spec) if spec else None
    m = EngineModel(cfg, qos=qos, acceptance=acc)
    for r in reqs:
        m.submit(r)
    for _ in range(100_000):
        if m.step() == 0 and not m._waiting:
            break
    ticks = [e for e in m.events if e["event"] == "tick"]
    assert all(r.finished and r.tokens == knobs["max_new_tokens"]
               for r in m.records.values())
    return {
        "admits": [u for e in ticks for u in e["admitted"]],
        "chunks": [(u, c) for e in ticks for u, c in e["chunks"]],
        "preempts": [u for e in ticks for u in e["preempted"]],
    }


@pytest.mark.parametrize("variant", ["fifo", "qos", "spec"])
def test_engine_decisions_equal_the_simulator(lm, variant):
    model, state = lm
    # huge aging keeps wall-clock time out of the rank
    qos = QosPolicy(aging_s=1e9) if variant == "qos" else None
    spec = 2 if variant == "spec" else 0
    kw = dict(KNOBS, n_blocks=12, enable_prefix_cache=False, qos=qos)
    if spec:
        kw.update(draft_model=model, draft_variables=state,
                  speculation_k=spec)
    eng = ContinuousEngine(model, None, device="cpu", **kw)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(10):
        plen = int(rng.integers(5, 17))
        pri = PRIORITIES[i % 3]
        eng.submit(f"r{i:02d}", rng.integers(1, 31, size=plen).astype(
            np.int32), priority=pri)
        reqs.append(Request(uri=f"r{i:02d}", arrival_t=i * 1e-6,
                            prompt_len=plen, gen_len=5, priority=pri))
    eng.drain()
    got = engine_decisions(eng)
    want = sim_decisions(reqs, qos, spec, 12, **KNOBS)
    assert got == want
    # the schedule exercises every decision kind
    assert got["preempts"] and len(got["chunks"]) > len(got["admits"])


def _bundle(lm, tmp_path):
    model, state = lm
    eng = ContinuousEngine(model, None, device="cpu", draft_model=model,
                           draft_variables=state, speculation_k=2,
                           qos=QosPolicy(), flight_capacity=64, **KNOBS)
    wd = SloWatchdog(registry=eng.telemetry.metrics)
    eng.telemetry.watchdog = wd
    rng = np.random.default_rng(1)
    for i in range(8):
        prompt = rng.integers(1, 31, size=int(rng.integers(5, 17)))
        eng.submit(f"q{i}", prompt.astype(np.int32),
                   priority=PRIORITIES[i % 3])
    eng.drain()
    config = {"engine_slots": 3, "engine_chunked": True,
              "engine_tick_token_budget": 16, "engine_paged": True,
              "engine_block_size": 4, "engine_speculation_k": 2,
              "qos_enabled": True, "qos_aging_s": 30.0}
    return dump_bundle(str(tmp_path), reason="test", detail={},
                       flight=eng.flight, telemetries=[eng.telemetry],
                       config=config, slo=wd.status(),
                       spec_acceptance=eng.spec_acceptance())


def test_live_bundle_replays_and_renders(lm, tmp_path, capsys):
    path = _bundle(lm, tmp_path)
    report = replay_bundle(path, seed=0)
    assert report["ok"] is True, report["crosscheck"]
    assert report["schema_version"] in SUPPORTED_SCHEMA_VERSIONS
    assert report["simulated"]["finished"] == 8
    for cls, d in report["sim_vs_observed"].items():
        assert abs(d["goodput"]) <= 0.5, (cls, d)
    assert debug.main([path, "--replay"]) == 0
    out = capsys.readouterr().out
    assert "tick timeline" in out and "crosscheck: OK" in out
    assert debug.main([str(tmp_path / "nope")]) == 2
    assert debug.main([path, "--uri", "ghost"]) == 2

    # the file alone, on a bare interpreter: no torch, no numpy
    proc = subprocess.run(
        [sys.executable, "-S", os.path.abspath(debug.__file__), path,
         "--replay"], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "crosscheck: OK" in proc.stdout
    probe = subprocess.run(
        [sys.executable, "-S", "-c", "import numpy"], capture_output=True)
    assert probe.returncode != 0      # the bare run really had no numpy


def test_sim_cli_gate():
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.sim", "gate",
         str(GOLDEN)], capture_output=True, text=True, timeout=120,
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
