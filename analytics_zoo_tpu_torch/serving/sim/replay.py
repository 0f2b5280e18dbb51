"""Flight-bundle replay: load a bundle (schema-gated), re-derive its
request metrics from the bundled trace, cross-check them against the
recorded watchdog score, and re-simulate the recorded schedule on the
modelled engine.

A copy of ``analytics_zoo_tpu/serving/sim/replay.py``, held to it by
``tests/test_torch_serving_pins.py``.  The tolerances are
``DEFAULT_TOLERANCES`` (documented in ``docs/simulation.md``).
Standard library only.
"""

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from ..policy import QosPolicy
from .model import (DEFAULT_SLO_TARGETS, AcceptanceModel, EngineConfig,
                    EngineModel, TimingModel, _Record, _t, summarize)
from .trace import Request

__all__ = ["SUPPORTED_SCHEMA_VERSIONS", "SchemaVersionError",
           "load_bundle", "derive_requests", "observed_metrics",
           "crosscheck", "resimulate", "replay_bundle",
           "DEFAULT_TOLERANCES"]

#: Flight/bundle schema versions this simulator understands.  Must
#: track ``serving/flight.py::FLIGHT_SCHEMA_VERSION`` — pinned against
#: it by tests/test_sim.py (this module cannot import flight.py: numpy).
SUPPORTED_SCHEMA_VERSIONS: Tuple[int, ...] = (1, 2, 3)

#: Replay cross-check tolerances (documented in docs/simulation.md).
#: ``goodput``: absolute per-class delta between trace-derived and
#: watchdog-recorded goodput.  ``count_slack``: relative shortfall of
#: trace-visible finished requests vs watchdog counts before the
#: goodput check is skipped as "ring truncated".  ``latency_rel`` /
#: ``latency_abs_s``: a latency percentile agrees when within
#: rel * recorded OR the absolute floor.
DEFAULT_TOLERANCES: Dict[str, float] = {
    "goodput": 0.05,
    "count_slack": 0.1,
    "latency_rel": 0.25,
    "latency_abs_s": 0.05,
}


class SchemaVersionError(ValueError):
    """The bundle's schema_version is newer/unknown to this simulator."""


def _read_json(path: str) -> Optional[Any]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _check_version(v: Any, where: str) -> None:
    if v is None:
        return      # pre-versioning producer: schema 1 by definition
    if not isinstance(v, int) or v not in SUPPORTED_SCHEMA_VERSIONS:
        raise SchemaVersionError(
            f"{where} carries schema_version={v!r} but this simulator "
            f"understands {list(SUPPORTED_SCHEMA_VERSIONS)}; upgrade "
            f"analytics_zoo_tpu_torch (or replay with a matching checkout) "
            f"instead of guessing at field meanings")


def load_bundle(path: str) -> Dict[str, Any]:
    """Load a bundle directory into plain dicts, refusing unknown
    schema versions.  Returns keys: ``manifest``, ``flight`` (dict),
    ``ticks`` (list), ``trace_events`` (list), ``metrics``, ``config``,
    ``slo``, ``spec_acceptance`` (absent files -> None/empty)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"not a bundle directory: {path}")
    manifest = _read_json(os.path.join(path, "manifest.json"))
    if manifest is None:
        raise FileNotFoundError(f"no manifest.json under {path} — not "
                                f"a flight bundle")
    _check_version(manifest.get("schema_version"), "manifest.json")
    flight = _read_json(os.path.join(path, "flight.json")) or {}
    _check_version(flight.get("schema_version"), "flight.json")
    ticks = flight.get("ticks") or []
    for rec in ticks:
        _check_version(rec.get("schema_version"),
                       f"flight tick seq={rec.get('seq')}")
        # v1 producers predate elastic pools: the pool size was static,
        # so every tick's n_blocks is free + used + the sink block
        if "free_blocks" in rec:
            rec.setdefault("n_blocks", int(rec["free_blocks"])
                           + int(rec.get("used_blocks", 0)) + 1)
    trace = _read_json(os.path.join(path, "trace.json")) or {}
    return {
        "path": path,
        "manifest": manifest,
        "flight": flight,
        "ticks": ticks,
        "trace_events": trace.get("traceEvents") or [],
        "metrics": _read_json(os.path.join(path, "metrics.json")),
        "config": _read_json(os.path.join(path, "config.json")),
        "slo": _read_json(os.path.join(path, "slo.json")),
        "spec_acceptance": _read_json(
            os.path.join(path, "spec_acceptance.json")),
    }


# ---------------------------------------------------------------------------
# trace-derived request records
# ---------------------------------------------------------------------------

def derive_requests(trace_events: List[Dict[str, Any]]
                    ) -> Dict[str, _Record]:
    """Rebuild per-request lifecycle records from Chrome-trace events
    (timestamps are microseconds of the recorder's monotonic clock;
    records keep seconds).  Mirrors the stamps telemetry fed the
    watchdog: queue-wait per admission epoch, TTFT per first-token
    epoch from the ORIGINAL arrival, TPOT over the final epoch."""
    recs: Dict[str, _Record] = {}

    def rec_for(uri: str, ts: float) -> _Record:
        r = recs.get(uri)
        if r is None:
            r = recs[uri] = _Record(uri=uri, priority="standard",
                                    tenant="", arrival=ts)
        return r

    for ev in trace_events:
        name = ev.get("name")
        args = ev.get("args") or {}
        uri = args.get("uri")
        if uri is None:
            continue
        ts = ev.get("ts", 0.0) / 1e6
        if name == "enqueued":
            rec_for(uri, ts).arrival = ts
        elif name == "queue_wait":
            r = rec_for(uri, ts)
            r.queue_waits.append(ev.get("dur", 0.0) / 1e6)
        elif name == "admitted":
            r = rec_for(uri, ts)
            r.admits.append(ts)
            if args.get("priority"):
                r.priority = args["priority"]
        elif name == "first_token":
            rec_for(uri, ts).first_tokens.append(ts)
        elif name == "preempted":
            rec_for(uri, ts).preempts += 1
        elif name == "request":
            r = rec_for(uri, ts)
            r.finish_t = ts + ev.get("dur", 0.0) / 1e6
            r.tokens = int(args.get("tokens", 0))
    return recs


def _prompt_lengths(trace_events: List[Dict[str, Any]]) -> Dict[str, int]:
    """Per-uri prompt length: the sum of its prefill_chunk span tokens
    in the FIRST admission epoch (later epochs re-stream the same
    prompt after preemption; summing all would double-count)."""
    out: Dict[str, int] = {}
    epoch_done: Dict[str, bool] = {}
    for ev in trace_events:
        name = ev.get("name")
        args = ev.get("args") or {}
        uri = args.get("uri")
        if uri is None:
            continue
        if name == "prefill_chunk" and not epoch_done.get(uri):
            out[uri] = out.get(uri, 0) + int(args.get("tokens", 0))
        elif name == "preempted" and not epoch_done.get(uri):
            out[uri] = 0        # mid-prefill eviction: restream counts fresh
        elif name == "first_token":
            epoch_done[uri] = True
    return out


def slo_targets_from_config(config: Optional[Dict[str, Any]]
                            ) -> Dict[str, Dict[str, float]]:
    """Per-class targets from a bundle's resolved ServingConfig
    (``slo_<metric>_s_<class>`` knobs), defaults where absent."""
    out = {c: dict(v) for c, v in DEFAULT_SLO_TARGETS.items()}
    if not config:
        return out
    for cls in out:
        for metric in ("ttft", "tpot", "queue_wait"):
            key = f"slo_{metric}_s_{cls}"
            if key in config:
                out[cls][metric] = float(config[key])
    return out


def observed_metrics(bundle: Dict[str, Any]) -> Dict[str, Any]:
    """Per-class latency/goodput summary re-derived purely from the
    bundle's trace events, judged against the bundle's own configured
    SLO targets."""
    recs = derive_requests(bundle["trace_events"])
    return summarize(recs, slo_targets_from_config(bundle.get("config")))


def crosscheck(observed: Dict[str, Any], slo: Optional[Dict[str, Any]],
               tolerances: Optional[Dict[str, float]] = None
               ) -> Dict[str, Any]:
    """Compare trace-derived per-class goodput against the recorded
    watchdog score (``slo.json``).  Returns ``{"ok", "checks": [...]}``
    where each check names the class, both values, the delta, and its
    verdict (``ok`` / ``breach`` / ``skipped_ring_truncated``)."""
    tol = dict(DEFAULT_TOLERANCES)
    tol.update(tolerances or {})
    checks: List[Dict[str, Any]] = []
    ok = True
    per_class = (slo or {}).get("per_class") or {}
    for cls, rec in sorted(per_class.items()):
        rec_fin = int(rec.get("finished", 0))
        if rec_fin == 0:
            continue
        obs = observed["per_class"].get(cls)
        obs_fin = obs["finished"] if obs else 0
        if obs_fin < rec_fin * (1.0 - tol["count_slack"]):
            checks.append({
                "class": cls, "metric": "goodput",
                "verdict": "skipped_ring_truncated",
                "observed_finished": obs_fin,
                "recorded_finished": rec_fin})
            continue
        delta = abs(obs["goodput"] - float(rec.get("goodput", 1.0)))
        good = delta <= tol["goodput"]
        ok = ok and good
        checks.append({
            "class": cls, "metric": "goodput",
            "observed": obs["goodput"],
            "recorded": _t(float(rec.get("goodput", 1.0))),
            "delta": _t(delta),
            "tolerance": tol["goodput"],
            "verdict": "ok" if good else "breach"})
    return {"ok": ok, "checks": checks}


# ---------------------------------------------------------------------------
# re-simulation
# ---------------------------------------------------------------------------

def engine_config_from_bundle(bundle: Dict[str, Any]) -> EngineConfig:
    """Map the bundle's resolved ServingConfig (+ tick samples where
    the config leaves a knob implicit) onto the sim's EngineConfig."""
    cfg = bundle.get("config") or {}
    ticks = bundle.get("ticks") or []
    spec = bundle.get("spec_acceptance") or {}
    spec_k = int(spec.get("k") or cfg.get("engine_speculation_k") or 0)
    paged = bool(cfg.get("engine_paged", False))
    n_blocks = cfg.get("engine_blocks")
    if paged:
        # v2 ticks carry the pool size directly (elastic pools move it
        # mid-run — size to the high-water mark); v1 falls back to the
        # static reconstruction used + free + sink
        peak = 0
        for rec in ticks:
            if "n_blocks" in rec:
                peak = max(peak, int(rec["n_blocks"]))
            elif "free_blocks" in rec:
                peak = max(peak, int(rec.get("free_blocks", 0))
                           + int(rec.get("used_blocks", 0)) + 1)
        if peak:
            n_blocks = max(int(n_blocks or 0), peak)
        if n_blocks is None:
            n_blocks = 256
    max_new = 0
    for ev in bundle.get("trace_events") or []:
        if ev.get("name") == "request":
            max_new = max(max_new,
                          int((ev.get("args") or {}).get("tokens", 0)))
    return EngineConfig(
        slots=int(cfg.get("engine_slots", 8)),
        max_new_tokens=max(max_new, 1) if max_new else 32,
        ticks_per_step=int(cfg.get("engine_ticks", 1)),
        chunked=bool(cfg.get("engine_chunked", False)),
        tick_token_budget=cfg.get("engine_tick_token_budget"),
        paged=paged,
        block_size=int(cfg.get("engine_block_size", 16)),
        n_blocks=int(n_blocks) if n_blocks is not None else None,
        spec_k=spec_k,
    )


def qos_from_config(cfg: Optional[Dict[str, Any]]) -> Optional[QosPolicy]:
    if not cfg or not cfg.get("qos_enabled"):
        return None
    return QosPolicy(
        weights={"interactive": float(cfg.get("qos_weight_interactive",
                                              8.0)),
                 "standard": float(cfg.get("qos_weight_standard", 4.0)),
                 "batch": float(cfg.get("qos_weight_batch", 1.0))},
        aging_s=float(cfg.get("qos_aging_s", 30.0)))


def requests_from_bundle(bundle: Dict[str, Any],
                         econf: EngineConfig) -> List[Request]:
    """The recorded request schedule: arrivals from ``enqueued``
    stamps (normalized so the first arrival is t=0), prompt lengths
    from first-epoch ``prefill_chunk`` sums (fallback: the smallest
    prompt bucket — non-chunked bundles don't record per-request
    prompt sizes), completion lengths from ``request`` span tokens
    (unfinished requests are skipped: their length is unknowable)."""
    evs = bundle["trace_events"]
    recs = derive_requests(evs)
    plens = _prompt_lengths(evs)
    arrivals = [r.arrival for r in recs.values() if r.finished]
    if not arrivals:
        return []
    t0 = min(arrivals)
    out = []
    for uri in sorted(recs):
        r = recs[uri]
        if not r.finished or r.tokens < 1:
            continue
        out.append(Request(
            uri=uri,
            arrival_t=_t(r.arrival - t0),
            prompt_len=max(1, plens.get(uri,
                                        econf.prompt_buckets[0])),
            gen_len=r.tokens,
            priority=r.priority,
            tenant=r.tenant))
    out.sort(key=lambda r: (r.arrival_t, r.uri))
    return out


def timing_from_ticks(ticks: List[Dict[str, Any]]) -> TimingModel:
    samples = []
    clean = []
    for rec in ticks:
        dur = rec.get("dur_ms")
        if dur is None:
            continue
        tokens = rec.get("budget_used")
        if tokens is None:
            # non-chunked ticks: active rows each advance ~1 token
            tokens = rec.get("active", 1)
        sample = (int(tokens), float(dur) / 1e3)
        samples.append(sample)
        # Ticks that triggered a jit build or retrace measure the
        # compiler, not the schedule; calibrate steady-state cost from
        # compile-free ticks whenever enough of them exist.
        if not rec.get("compiles"):
            clean.append(sample)
    if len(clean) >= 4:
        samples = clean
    return TimingModel.fit(samples)


def resimulate(bundle: Dict[str, Any], seed: int = 0,
               record_events: bool = False) -> Dict[str, Any]:
    """Re-run the bundle's recorded request schedule through the
    modelled engine (config from the bundle, timing fitted to its tick
    durations, spec acceptance from its calibration section) and
    summarize with the bundle's SLO targets."""
    econf = engine_config_from_bundle(bundle)
    acceptance = None
    spec = bundle.get("spec_acceptance")
    if econf.spec_k > 0 and spec and spec.get("counts"):
        acceptance = AcceptanceModel.from_counts(spec["counts"],
                                                 econf.spec_k)
    model = EngineModel(
        econf, qos=qos_from_config(bundle.get("config")),
        acceptance=acceptance, timing=timing_from_ticks(bundle["ticks"]),
        seed=seed, record_events=record_events)
    reqs = requests_from_bundle(bundle, econf)
    model.run(reqs)
    summary = summarize(model.records,
                        slo_targets_from_config(bundle.get("config")))
    summary["n_requests"] = len(reqs)
    summary["sim_ticks"] = model.ticks
    summary["preemptions"] = model.preemptions
    return summary


def replay_bundle(path: str, seed: int = 0,
                  resim: bool = True,
                  tolerances: Optional[Dict[str, float]] = None
                  ) -> Dict[str, Any]:
    """The whole replay pipeline: load + schema-gate, derive observed
    metrics, cross-check against the recorded watchdog score, and
    (optionally) re-simulate.  Returns one JSON-serializable report."""
    bundle = load_bundle(path)
    observed = observed_metrics(bundle)
    check = crosscheck(observed, bundle.get("slo"), tolerances)
    report: Dict[str, Any] = {
        "bundle": os.path.basename(os.path.abspath(path)),
        "schema_version": bundle["manifest"].get("schema_version", 1),
        "reason": bundle["manifest"].get("reason"),
        "observed": observed,
        "recorded_slo": (bundle.get("slo") or {}).get("per_class"),
        "crosscheck": check,
        "ok": check["ok"],
    }
    if resim:
        simulated = resimulate(bundle, seed=seed)
        report["simulated"] = simulated
        deltas = {}
        for cls, obs in observed["per_class"].items():
            sim_cls = simulated["per_class"].get(cls)
            if not sim_cls or not sim_cls["finished"]:
                continue
            deltas[cls] = {
                "goodput": _t(sim_cls["goodput"] - obs["goodput"]),
                "ttft_p99_s": _t(sim_cls["ttft"]["p99"]
                                 - obs["ttft"]["p99"]),
                "tpot_p99_s": _t(sim_cls["tpot"]["p99"]
                                 - obs["tpot"]["p99"]),
            }
        report["sim_vs_observed"] = deltas
    return report
