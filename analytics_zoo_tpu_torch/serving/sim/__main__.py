"""``python -m analytics_zoo_tpu_torch.serving.sim``: the simulator's
command line.

A copy of ``analytics_zoo_tpu/serving/sim/__main__.py``, held to it by
``tests/test_torch_serving_pins.py``.  Subcommands:

* ``run <scenario.(json|yaml)>``: a seeded synthetic scenario, printed
  as a per-class p50/p99 and goodput table; a ``sweep`` section expands
  into one row for each combination of its value lists;
* ``gate <golden.json>``: the pinned golden scenario against its
  recorded envelopes (exit 0 inside, 1 outside);
* ``replay <bundle-dir>``: a flight bundle's replay (exit 0 when the
  cross-check holds, 1 on a breach, 2 on an unreadable bundle).

Scenario files are JSON, or YAML where PyYAML imports.
"""

import argparse
import itertools
import json
import sys
from typing import Any, Dict, List, Optional

from ..policy import BrownoutPolicy, QosPolicy
from .fleet import FleetModel
from .model import (DEFAULT_SLO_TARGETS, AcceptanceModel, EngineConfig,
                    EngineModel, TimingModel, summarize)
from .replay import SchemaVersionError, replay_bundle
from .trace import diurnal_trace, poisson_trace, requests_from_dicts

__all__ = ["main", "run_scenario", "load_scenario", "check_envelopes"]


def _load_doc(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml  # an optional nicety, never a requirement
        except ImportError:
            raise SystemExit(
                f"{path}: YAML scenarios need pyyaml; re-write the "
                f"scenario as JSON (same keys) to stay stdlib-only")
        return yaml.safe_load(text) or {}
    return json.loads(text)


def load_scenario(path: str) -> Dict[str, Any]:
    doc = _load_doc(path)
    if not isinstance(doc, dict) or "trace" not in doc:
        raise SystemExit(f"{path}: a scenario needs a 'trace' section "
                         f"(see docs/simulation.md)")
    return doc


def _build_trace(spec: Dict[str, Any], seed: int):
    kind = spec.get("kind", "poisson")
    kw = dict(prompt_len=spec.get("prompt_len", (16, 256)),
              gen_len=spec.get("gen_len", (8, 64)),
              class_mix=spec.get("classes"),
              tenants=spec.get("tenants", ("",)),
              prefixes=spec.get("prefixes"),
              prefix_frac=float(spec.get("prefix_frac", 0.0)))
    if kind == "poisson":
        return _stamp_deadlines(
            poisson_trace(n_requests=int(spec["n_requests"]),
                          rate_rps=float(spec["rate_rps"]),
                          seed=seed, **kw), spec)
    if kind == "diurnal":
        return _stamp_deadlines(
            diurnal_trace(n_requests=int(spec["n_requests"]),
                          base_rps=float(spec["base_rps"]),
                          peak_rps=float(spec["peak_rps"]),
                          period_s=float(spec["period_s"]),
                          seed=seed, **kw), spec)
    if kind == "explicit":
        return _stamp_deadlines(requests_from_dicts(spec["requests"]),
                                spec)
    raise SystemExit(f"unknown trace kind {kind!r} "
                     f"(poisson | diurnal | explicit)")


def _stamp_deadlines(trace, spec: Dict[str, Any]):
    """Apply a per-class ``deadlines`` mapping (class -> seconds after
    arrival) AFTER generation: no RNG draws, so traces without the
    section stay byte-identical to previous releases."""
    dls = spec.get("deadlines")
    if not dls:
        return trace
    from dataclasses import replace
    out = []
    for r in trace:
        d = dls.get(r.priority)
        out.append(replace(r, deadline_s=float(d))
                   if d is not None else r)
    return out


def run_scenario(doc: Dict[str, Any],
                 seed: Optional[int] = None,
                 record_events: bool = False) -> Dict[str, Any]:
    """Run one scenario document; returns the summary (the model is
    discarded).  ``seed`` overrides the document's seed."""
    seed = int(doc.get("seed", 0)) if seed is None else int(seed)
    econf = EngineConfig.from_dict(doc.get("engine") or {})
    qos_doc = doc.get("qos") or {}
    qos = None
    if qos_doc.get("enabled"):
        qos = QosPolicy(
            weights=dict(qos_doc.get("weights") or {}),
            aging_s=float(qos_doc.get("aging_s", 30.0)))
    acc = None
    acc_doc = doc.get("spec_acceptance")
    if econf.spec_k > 0 and acc_doc:
        if "counts" in acc_doc:
            acc = AcceptanceModel.from_counts(acc_doc["counts"],
                                              econf.spec_k)
        elif "mean" in acc_doc:
            acc = AcceptanceModel.constant(round(acc_doc["mean"]),
                                           econf.spec_k)
    timing = TimingModel(**(doc.get("timing")
                            or {"base_s": 0.002,
                                "per_token_s": 0.00005}))
    targets = doc.get("slo") or DEFAULT_SLO_TARGETS
    brownout = None
    b_doc = doc.get("brownout") or {}
    if b_doc.get("enabled"):
        # the SAME BrownoutPolicy knobs ServingConfig exposes (see
        # docs/serving_qos.md "Overload & brownout")
        brownout = BrownoutPolicy(
            goodput_floor=float(b_doc.get("goodput_floor", 0.9)),
            queue_high=int(b_doc.get("queue_high", 64)),
            queue_recover_frac=float(
                b_doc.get("queue_recover_frac", 0.5)),
            alloc_streak_high=int(b_doc.get("alloc_streak_high", 4)),
            tick_s_high=float(b_doc.get("tick_s_high", 0.0)),
            enter_ticks=int(b_doc.get("enter_ticks", 3)),
            exit_ticks=int(b_doc.get("exit_ticks", 6)),
            standard_max_new=int(b_doc.get("standard_max_new", 16)))
    fleet_doc = doc.get("fleet")
    if fleet_doc:
        # disaggregated fleet scenario (docs/simulation.md): N modelled
        # replicas behind the real router, optional prefill/decode
        # roles with modelled KV handoff
        roles = fleet_doc.get("roles")
        n = int(fleet_doc.get("n_replicas",
                              len(roles) if roles else 1))
        fleet = FleetModel(
            [EngineConfig.from_dict(doc.get("engine") or {})
             for _ in range(n)],
            roles=roles, qos=qos, acceptance=acc, timing=timing,
            seed=seed, record_events=record_events,
            handoff_s=float(fleet_doc.get("handoff_s", 0.0)),
            # chaos twin: the same fault-schedule dicts
            # ServingConfig.fault_injection takes (serving/fault.py)
            faults=fleet_doc.get("faults"),
            retry_budget=int(fleet_doc.get("retry_budget", 2)),
            handoff_timeout_s=float(
                fleet_doc.get("handoff_timeout_s", 0.0)),
            request_deadline_s=float(
                fleet_doc.get("request_deadline_s", 0.0)),
            brownout=brownout, slo_targets=targets)
        fleet.run(_build_trace(doc["trace"], seed))
        out = fleet.summary(targets)
        out["seed"] = seed
        if record_events:
            out["event_log_lines"] = [
                line for e in fleet.engines
                for line in e.event_log_lines()]
        return out
    model = EngineModel(econf, qos=qos, acceptance=acc, timing=timing,
                        seed=seed, record_events=record_events,
                        brownout=brownout, slo_targets=targets)
    model.run(_build_trace(doc["trace"], seed))
    out = summarize(model.records, targets)
    out["seed"] = seed
    out["ticks"] = model.ticks
    out["preemptions"] = model.preemptions
    out["prefill_stall_ticks"] = model.prefill_stall_ticks
    if model.brownout is not None:
        # only-when-on keys, like the tiered-KV block below
        out["brownout_sheds"] = model.brownout_sheds
        out["brownout_max_level"] = model.brownout_max_level
        out["brownout_final_level"] = model.brownout_level
        out["brownout_transitions"] = model.brownout_transitions
    if model.brownout is not None or model.deadline_seen:
        out["deadline_sheds"] = model.deadline_sheds
    if model._prefix_on:
        # tiered-KV counters, present only when the tier is on (see
        # FleetModel.summary — same key-stability contract)
        out["kv_spills"] = model.kv_spills
        out["kv_readmits"] = model.kv_readmits
        out["kv_readmit_tokens_saved"] = model.kv_readmit_tokens_saved
        out["recompute_tokens_saved"] = model.recompute_tokens_saved
    if record_events:
        out["event_log_lines"] = model.event_log_lines()
    return out


def _apply_override(doc: Dict[str, Any], dotted: str, value) -> None:
    node = doc
    parts = dotted.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _sweep_rows(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Expand a ``sweep`` mapping of dotted-key -> value-list into the
    cartesian product of overridden scenario documents."""
    sweep = doc.get("sweep")
    if not sweep:
        return [{"label": "-", "doc": doc}]
    keys = list(sweep.keys())
    rows = []
    for combo in itertools.product(*(sweep[k] for k in keys)):
        d = json.loads(json.dumps(doc))     # deep copy, JSON-safe
        d.pop("sweep", None)
        for k, v in zip(keys, combo):
            _apply_override(d, k, v)
        rows.append({"label": " ".join(f"{k}={v}"
                                       for k, v in zip(keys, combo)),
                     "doc": d})
    return rows


def _fmt_ms(x: float) -> str:
    return f"{x * 1e3:8.1f}"


def _print_summary(out: Dict[str, Any], label: str = "",
                   file=None) -> None:
    f = file or sys.stdout
    if label and label != "-":
        print(f"--- {label}", file=f)
    print(f"{'class':<12} {'fin':>7} {'goodput':>8} {'ttft p50':>9} "
          f"{'ttft p99':>9} {'tpot p99':>9} {'qwait p99':>10}  (ms)",
          file=f)
    for cls, c in out["per_class"].items():
        print(f"{cls:<12} {c['finished']:>7} {c['goodput']:>8.3f} "
              f"{_fmt_ms(c['ttft']['p50']):>9} "
              f"{_fmt_ms(c['ttft']['p99']):>9} "
              f"{_fmt_ms(c['tpot']['p99']):>9} "
              f"{_fmt_ms(c['queue_wait']['p99']):>10}", file=f)
    extra = (f", {out['handoffs']} handoffs"
             if "handoffs" in out else "")
    print(f"total: {out['finished']} finished, {out['dropped']} "
          f"dropped, goodput {out['goodput']:.3f}, "
          f"{out['tokens_per_s']:.0f} tok/s over "
          f"{out['duration_s']:.2f}s simulated "
          f"({out.get('ticks', out.get('sim_ticks', 0))} ticks, "
          f"{out.get('preemptions', 0)} preemptions{extra})", file=f)


def check_envelopes(summary: Dict[str, Any],
                    envelopes: Dict[str, Dict[str, float]]
                    ) -> List[Dict[str, Any]]:
    """Assert envelope bounds against a summary.  Envelope keys are
    dotted metric paths rooted at the summary (e.g.
    ``per_class.interactive.ttft.p99``), each with optional ``min`` /
    ``max``.  Returns the list of violations (empty = in envelope)."""
    violations = []
    for path, bound in sorted(envelopes.items()):
        node: Any = summary
        ok_path = True
        for part in path.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                ok_path = False
                break
        if not ok_path or not isinstance(node, (int, float)):
            violations.append({"metric": path, "value": None,
                               "error": "metric missing from summary"})
            continue
        lo, hi = bound.get("min"), bound.get("max")
        if lo is not None and node < lo:
            violations.append({"metric": path, "value": node,
                               "min": lo})
        if hi is not None and node > hi:
            violations.append({"metric": path, "value": node,
                               "max": hi})
    return violations


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _cmd_replay(args) -> int:
    try:
        report = replay_bundle(args.bundle, seed=args.seed,
                               resim=not args.no_resim)
    except SchemaVersionError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        json.dump(report, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0 if report["ok"] else 1
    print(f"bundle {report['bundle']} (schema_version "
          f"{report['schema_version']}, reason: {report['reason']})")
    print("observed (re-derived from trace.json):")
    _print_summary(report["observed"])
    print("crosscheck vs recorded slo.json:")
    for c in report["crosscheck"]["checks"]:
        if c["verdict"] == "skipped_ring_truncated":
            print(f"  {c['class']:<12} goodput  SKIPPED (trace ring "
                  f"truncated: {c['observed_finished']} of "
                  f"{c['recorded_finished']} requests visible)")
        else:
            print(f"  {c['class']:<12} goodput  observed "
                  f"{c['observed']:.3f}  recorded {c['recorded']:.3f}  "
                  f"delta {c['delta']:+.3f}  [{c['verdict']}]")
    if "simulated" in report:
        print("simulated (modelled engine on the recorded schedule):")
        _print_summary(report["simulated"])
        for cls, d in sorted(report["sim_vs_observed"].items()):
            print(f"  {cls:<12} sim-vs-observed  goodput "
                  f"{d['goodput']:+.3f}  ttft p99 "
                  f"{d['ttft_p99_s'] * 1e3:+.1f}ms  tpot p99 "
                  f"{d['tpot_p99_s'] * 1e3:+.1f}ms")
    print("crosscheck:", "OK" if report["ok"] else "BREACH")
    return 0 if report["ok"] else 1


def _cmd_run(args) -> int:
    doc = load_scenario(args.scenario)
    rows = _sweep_rows(doc)
    results = []
    for row in rows:
        out = run_scenario(row["doc"], seed=args.seed)
        results.append({"label": row["label"], "summary": out})
    if args.json:
        json.dump(results, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0
    for r in results:
        _print_summary(r["summary"], r["label"])
    return 0


def _cmd_gate(args) -> int:
    doc = load_scenario(args.golden)
    envelopes = doc.get("envelopes")
    if not envelopes:
        print(f"error: {args.golden} has no 'envelopes' section — "
              f"nothing to gate on", file=sys.stderr)
        return 2
    # the pinned primary scenario plus any embedded extra_scenarios
    # (each a complete scenario doc with its own envelopes — e.g. the
    # disaggregated-fleet fixture); ALL must hold for exit 0
    gates = [(doc.get("name", args.golden), doc, envelopes)]
    for sub in doc.get("extra_scenarios") or []:
        sub_env = sub.get("envelopes")
        if not sub_env:
            print(f"error: extra scenario "
                  f"{sub.get('name', '?')!r} has no 'envelopes' "
                  f"section — nothing to gate on", file=sys.stderr)
            return 2
        gates.append((sub.get("name", "extra"), sub, sub_env))
    results = []
    all_violations = []
    for name, d, env in gates:
        summary = run_scenario(d, seed=args.seed)
        violations = check_envelopes(summary, env)
        results.append((name, summary, env, violations))
        all_violations.extend(
            dict(v, scenario=name) for v in violations)
    if args.json:
        json.dump({"summary": results[0][1],
                   "violations": all_violations},
                  sys.stdout, indent=2, sort_keys=True)
        print()
        return 1 if all_violations else 0
    for name, summary, env, violations in results:
        _print_summary(summary, name)
        if violations:
            print("ENVELOPE VIOLATIONS (see docs/simulation.md for "
                  "how to read and, when intended, re-pin these):")
            for v in violations:
                bound = (f">= {v['min']}" if "min" in v
                         else f"<= {v['max']}" if "max" in v
                         else v.get("error", "?"))
                print(f"  {v['metric']}: value {v['value']} violates "
                      f"{bound}")
        else:
            print(f"gate OK: {len(env)} envelope(s) hold")
    return 1 if all_violations else 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.serving.sim",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("replay", help="replay a diagnostic bundle")
    pr.add_argument("bundle", help="bundle directory (manifest.json...)")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--no-resim", action="store_true",
                    help="derive + crosscheck only, skip re-simulation")
    pr.add_argument("--json", action="store_true")
    pr.set_defaults(fn=_cmd_replay)

    pu = sub.add_parser("run", help="run a synthetic scenario (+sweep)")
    pu.add_argument("scenario", help="scenario JSON (or YAML) file")
    pu.add_argument("--seed", type=int, default=None,
                    help="override the scenario's seed")
    pu.add_argument("--json", action="store_true")
    pu.set_defaults(fn=_cmd_run)

    pg = sub.add_parser("gate",
                        help="assert a golden scenario's envelopes")
    pg.add_argument("golden", help="golden fixture JSON with envelopes")
    pg.add_argument("--seed", type=int, default=None)
    pg.add_argument("--json", action="store_true")
    pg.set_defaults(fn=_cmd_gate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
