"""Diagnostic-bundle renderer
(``python -m analytics_zoo_tpu_torch.serving.debug``).

A copy of ``analytics_zoo_tpu/serving/debug.py``, held to it by
``tests/test_torch_serving_pins.py``.  It renders a flight bundle that
the port's engine wrote (``serving/flight.py`` ``dump_bundle``): the
trigger, the tick timeline before it, the SLO score at capture, the
request histories from the bundled trace and the log tail.

Usage::

    python -m analytics_zoo_tpu_torch.serving.debug <bundle-dir> \\
        [--ticks N] [--requests N] [--uri URI] [--logs N] [--replay]

``--replay`` runs the simulator (``serving/sim/``) over the bundle,
cross-checks the request metrics it derives from the trace against
the recorded watchdog score and prints the simulated-vs-recorded
deltas.  Exit code 0 on a rendered bundle, 1 when the replay's
cross-check breached its tolerances, 2 on an unreadable (or
unknown-schema) one.

Standard library only: the file runs on a bare Python with neither
torch nor numpy importable (``python -S path/to/serving/debug.py
<bundle-dir> --replay``), importing the simulator through a synthetic
parent package.  The ``-m`` spelling imports the package root, which
needs torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

# trace events that mark request-lifecycle edges, in render order
_LIFECYCLE = ("enqueued", "queue_wait", "admitted", "first_token",
              "preempted", "request", "request_error",
              "request_cancelled", "request_abandoned",
              "stream_disconnect")

# tick-record columns: (header, key, width); missing keys render "-"
_TICK_COLS = (("seq", "seq", 6), ("kind", "kind", 12),
              ("ms", "dur_ms", 8), ("act", "active", 4),
              ("dec", "decode_rows", 4), ("pre", "prefill_rows", 4),
              ("que", "queue_depth", 4), ("free", "free_blocks", 5),
              ("dfree", "draft_free_blocks", 6),
              ("fail", "alloc_failures", 5),
              ("strk", "alloc_fail_streak", 5),
              ("pre+", "preempted", 5), ("cmp", "compiles", 4))


def _load_json(path: str) -> Optional[Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _fmt_cell(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.2f}"
    return str(v)


def render_ticks(ticks: List[Dict[str, Any]], last: int,
                 out) -> None:
    tail = ticks[-last:]
    print(f"tick timeline ({len(tail)} of {len(ticks)} retained ticks, "
          f"newest last):", file=out)
    header = " ".join(h.rjust(w) for h, _, w in _TICK_COLS)
    print("  " + header, file=out)
    for t in tail:
        row = " ".join(_fmt_cell(t.get(k)).rjust(w)
                       for _, k, w in _TICK_COLS)
        print("  " + row, file=out)
    # the rows a tick carried (uri lists are too wide for the table)
    if tail:
        t = tail[-1]
        dec, pre = t.get("decode_uris"), t.get("prefill_uris")
        if dec is not None or pre is not None:
            print(f"  last tick rows: decode={dec or []} "
                  f"prefill={pre or []}", file=out)


def request_histories(trace: Dict[str, Any]
                      ) -> Dict[str, List[Dict[str, Any]]]:
    """Per-uri lifecycle edges from the bundled Chrome trace, each a
    dict of (name, ts seconds, args), sorted by time."""
    per_uri: Dict[str, List[Dict[str, Any]]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") not in ("X", "i"):
            continue
        name = ev.get("name")
        if name not in _LIFECYCLE:
            continue
        args = ev.get("args") or {}
        uri = args.get("uri")
        if not uri:
            continue
        per_uri.setdefault(uri, []).append(
            {"name": name, "ts": float(ev["ts"]) / 1e6,
             "dur": (float(ev.get("dur", 0.0)) / 1e6
                     if ev.get("ph") == "X" else None),
             "tid": ev.get("tid"), "args": args})
    for evs in per_uri.values():
        # spans order by their END ("request" starts at admission but
        # means "finished" — it must render after the tokens it spans)
        evs.sort(key=lambda e: e["ts"] + (e["dur"] or 0.0))
    return per_uri


def render_request(uri: str, evs: List[Dict[str, Any]], out) -> None:
    t0 = evs[0]["ts"]
    parts = []
    for e in evs:
        label = e["name"]
        if label == "admitted":
            label = f"admitted slot {e['tid']}"
        elif label == "request":
            end = e["ts"] + (e["dur"] or 0.0)
            parts.append(f"finished +{end - t0:.3f}s "
                         f"({e['args'].get('tokens', '?')} tokens)")
            continue
        elif label == "queue_wait":
            label = f"queue_wait {e['dur']:.3f}s"
            parts.append(label)
            continue
        parts.append(f"{label} +{e['ts'] - t0:.3f}s")
    print(f"  {uri}: " + " -> ".join(parts), file=out)


def render_slo(slo: Dict[str, Any], out) -> None:
    print("SLO score at capture:", file=out)
    for cls, s in (slo.get("per_class") or {}).items():
        br = s.get("breaches") or {}
        print(f"  {cls:<12} goodput={s.get('goodput', 1.0):.3f} "
              f"finished={s.get('finished', 0)} "
              f"breaches(ttft/tpot/queue)="
              f"{br.get('ttft', 0)}/{br.get('tpot', 0)}/"
              f"{br.get('queue_wait', 0)}", file=out)
    recent = slo.get("recent_breaches") or []
    for b in recent[-3:]:
        print(f"  recent: {b.get('class')}/{b.get('metric')} "
              f"{b.get('value_s')}s > {b.get('target_s')}s "
              f"uri={b.get('uri')}", file=out)


def _load_sim_replay():
    """Import ``serving.sim.replay`` in either spelling of this CLI.

    Under ``python -m`` the package-relative import just works.  As a
    bare file (``python path/to/debug.py``) there is no parent package,
    so build a synthetic one whose ``__path__`` is this directory and
    import the sim through it — the sim's ``from ..policy import ...``
    then resolves to the sibling ``policy.py`` file, and the whole
    chain stays stdlib-only (no numpy, no jax, nothing installed)."""
    if __package__:
        from .sim import replay  # type: ignore[no-redef]
        return replay
    import importlib
    import types
    name = "_azt_serving_bare"
    pkg = sys.modules.get(name)
    if pkg is None:
        pkg = types.ModuleType(name)
        pkg.__path__ = [os.path.dirname(os.path.abspath(__file__))]
        sys.modules[name] = pkg
    return importlib.import_module(f"{name}.sim.replay")


def render_replay(path: str, out, seed: int = 0) -> int:
    """Run the simulator's replay pipeline over a bundle and print the
    simulated-vs-recorded SLO deltas.  Returns a process exit code (0
    crosscheck ok, 1 tolerance breach, 2 unreadable/unknown schema)."""
    replay = _load_sim_replay()
    try:
        report = replay.replay_bundle(path, seed=seed)
    except (FileNotFoundError, ValueError) as e:
        # SchemaVersionError subclasses ValueError
        print(f"error: replay failed: {e}", file=sys.stderr)
        return 2
    print("replay (serving/sim, docs/simulation.md):", file=out)
    rec_cls = report.get("recorded_slo") or {}
    for cls, obs in (report["observed"].get("per_class") or {}).items():
        rec = rec_cls.get(cls) or {}
        sim = ((report.get("simulated") or {}).get("per_class")
               or {}).get(cls) or {}
        print(f"  {cls:<12} goodput recorded="
              f"{rec.get('goodput', float('nan')):.3f} "
              f"observed={obs['goodput']:.3f} "
              f"simulated={sim.get('goodput', float('nan')):.3f}  "
              f"ttft p99 observed={obs['ttft']['p99'] * 1e3:.1f}ms "
              f"simulated="
              f"{(sim.get('ttft') or {}).get('p99', 0.0) * 1e3:.1f}ms",
              file=out)
    for c in report["crosscheck"]["checks"]:
        if c["verdict"] == "skipped_ring_truncated":
            print(f"  crosscheck {c['class']}: skipped (trace ring "
                  f"truncated: {c['observed_finished']} of "
                  f"{c['recorded_finished']} visible)", file=out)
        else:
            print(f"  crosscheck {c['class']}: delta {c['delta']:+.3f} "
                  f"(tolerance {c['tolerance']}) [{c['verdict']}]",
                  file=out)
    print(f"  crosscheck: "
          f"{'OK' if report['ok'] else 'BREACH'}", file=out)
    return 0 if report["ok"] else 1


def render_bundle(path: str, *, ticks: int = 20, requests: int = 10,
                  uri: Optional[str] = None, logs: int = 5,
                  out=None) -> int:
    """Render one bundle directory; returns a process exit code."""
    out = out or sys.stdout
    manifest = _load_json(os.path.join(path, "manifest.json"))
    if manifest is None:
        print(f"error: {path!r} is not a diagnostic bundle "
              f"(no readable manifest.json)", file=sys.stderr)
        return 2
    print(f"bundle: {path}", file=out)
    print(f"reason: {manifest.get('reason')}  "
          f"written: {manifest.get('written_at')}", file=out)
    detail = manifest.get("detail") or {}
    if detail:
        print(f"trigger detail: "
              f"{json.dumps(detail, sort_keys=True)}", file=out)

    config = _load_json(os.path.join(path, "config.json")) or {}
    if config:
        keys = ("continuous_batching", "engine_slots", "engine_paged",
                "engine_blocks", "engine_block_size", "engine_kernel",
                "engine_kv_dtype", "engine_chunked",
                "engine_speculation_k", "qos_enabled",
                "flight_capacity")
        print("config: " + " ".join(
            f"{k}={config[k]}" for k in keys if k in config), file=out)

    flight = _load_json(os.path.join(path, "flight.json")) or {}
    tick_recs = flight.get("ticks") or []
    if tick_recs:
        render_ticks(tick_recs, ticks, out)
    else:
        print("tick timeline: empty (recorder disabled or no ticks "
              "before capture)", file=out)

    slo = _load_json(os.path.join(path, "slo.json"))
    if slo:
        render_slo(slo, out)

    trace = _load_json(os.path.join(path, "trace.json")) or {}
    per_uri = request_histories(trace)
    if uri is not None:
        if uri not in per_uri:
            print(f"error: uri {uri!r} has no events in this bundle "
                  f"(known: {sorted(per_uri)[:20]})", file=sys.stderr)
            return 2
        selected = [uri]
    else:
        # newest-active first: order by each request's last event time
        selected = sorted(per_uri,
                          key=lambda u: per_uri[u][-1]["ts"],
                          reverse=True)[:requests]
    if selected:
        print(f"request histories ({len(selected)} of "
              f"{len(per_uri)} in trace):", file=out)
        for u in selected:
            render_request(u, per_uri[u], out)

    log_path = os.path.join(path, "logs.jsonl")
    try:
        with open(log_path) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    except OSError:
        lines = []
    if lines:
        print(f"recent logs (last {min(logs, len(lines))} of "
              f"{len(lines)}):", file=out)
        for ln in lines[-logs:]:
            print("  " + ln, file=out)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.serving.debug",
        description="Render a serving diagnostic bundle "
                    "(docs/debugging.md)")
    ap.add_argument("bundle", help="bundle directory written by "
                                   "serving/flight.py dump_bundle")
    ap.add_argument("--ticks", type=int, default=20,
                    help="tick-timeline tail length (default 20)")
    ap.add_argument("--requests", type=int, default=10,
                    help="max request histories (default 10, newest)")
    ap.add_argument("--uri", default=None,
                    help="render only this request id's history")
    ap.add_argument("--logs", type=int, default=5,
                    help="log-tail length (default 5)")
    ap.add_argument("--replay", action="store_true",
                    help="re-simulate the bundle (serving/sim) and "
                         "print simulated-vs-recorded SLO deltas")
    ap.add_argument("--seed", type=int, default=0,
                    help="replay simulation seed (default 0)")
    args = ap.parse_args(argv)
    rc = render_bundle(args.bundle, ticks=args.ticks,
                       requests=args.requests, uri=args.uri,
                       logs=args.logs)
    if rc == 0 and args.replay:
        rc = render_replay(args.bundle, sys.stdout, seed=args.seed)
    return rc


if __name__ == "__main__":
    sys.exit(main())
