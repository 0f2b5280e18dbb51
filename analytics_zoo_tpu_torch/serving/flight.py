"""Flight recorder, SLO watchdog and anomaly-triggered diagnostics: a
bounded ring of per-tick engine snapshots, per-class TTFT/TPOT/queue
wait targets with goodput gauges, an anomaly monitor that dumps a
self-contained diagnostic bundle, and structured logging correlated by
request uri.

A copy of ``analytics_zoo_tpu/serving/flight.py`` (host-side only; it
imports ``common.log``, ``frontdoor`` and ``telemetry``).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import shutil
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.common.log import logger
from analytics_zoo_tpu_torch.serving.frontdoor import PRIORITIES
from analytics_zoo_tpu_torch.serving.telemetry import (MetricsRegistry,
                                                 render_prometheus,
                                                 validate_chrome_trace)

__all__ = [
    "FLIGHT_SCHEMA_VERSION",
    "FlightRecorder", "SloPolicy", "SloWatchdog", "AnomalyMonitor",
    "dump_bundle", "prune_bundles", "JsonLogFormatter", "RingLogHandler",
    "install_flight_logging", "request_uri_context", "current_request_uri",
    "DEFAULT_SLO_TARGETS", "SLO_METRICS",
]

#: Version of the tick-record + bundle-manifest schema.  Bump whenever
#: a field changes meaning or disappears (pure additions are fine at
#: the same version); the discrete-event simulator
#: (``serving/sim/replay.py``) refuses bundles stamped with a version
#: it does not know rather than silently misreading them, and
#: docs/simulation.md pins the current number (guarded by
#: tests/test_flight.py).
#:
#: v2: every paged tick additionally records the per-tenant pool SIZE
#: (``n_blocks``, ``draft_n_blocks``) plus per-tick ``pool_resizes`` /
#: ``handoffs_out`` / ``handoffs_in`` deltas, so elastic-pool resizes
#: and prefill/decode handoffs are visible on the flight timeline.
#: The reader backfills ``n_blocks`` for v1 bundles (static pools:
#: free + used + sink), so v1 replays unchanged.
#:
#: v3: paged ticks additionally record per-tick ``kv_spills`` /
#: ``kv_readmits`` deltas (tiered KV memory, serving/kv_store.py) so
#: host-tier traffic is visible on the flight timeline.  The replayer
#: keeps accepting v1/v2 (the new fields are diagnostic-only — replay
#: does not consume them, so nothing is backfilled).
FLIGHT_SCHEMA_VERSION = 3

# ---------------------------------------------------------------------------
# request-id correlation
# ---------------------------------------------------------------------------

# The uri of the request the CURRENT thread/context is working for.
# The HTTP frontend sets it for the duration of each handler; every
# JSON log record (and the ring tail that lands in bundles) picks it
# up, so `grep '"uri": "x"' ` joins frontend, server, and engine lines.
_REQUEST_URI: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "zoo_request_uri", default=None)


def current_request_uri() -> Optional[str]:
    """The request uri bound to the current context, or None."""
    return _REQUEST_URI.get()


@contextlib.contextmanager
def request_uri_context(uri: Optional[str]):
    """Bind ``uri`` as the current request id for log correlation."""
    token = _REQUEST_URI.set(uri)
    try:
        yield
    finally:
        _REQUEST_URI.reset(token)


def _record_to_dict(record: logging.LogRecord) -> Dict[str, Any]:
    """One log record as the flat dict both the JSON formatter and the
    ring handler emit — same fields, so the stderr stream and the
    bundle tail agree line for line."""
    out: Dict[str, Any] = {
        "ts": round(record.created, 6),
        "level": record.levelname,
        "logger": record.name,
        "msg": record.getMessage(),
    }
    # explicit extra={"uri": ...} beats the ambient contextvar
    uri = getattr(record, "uri", None)
    if uri is None:
        uri = _REQUEST_URI.get()
    if uri is not None:
        out["uri"] = uri
    if record.exc_info:
        out["exc"] = logging.Formatter().formatException(record.exc_info)
    return out


class JsonLogFormatter(logging.Formatter):
    """One JSON object per line: ts / level / logger / msg, plus the
    correlated request ``uri`` when one is bound (contextvar or
    ``extra={"uri": ...}``) and the traceback under ``exc``."""

    def format(self, record: logging.LogRecord) -> str:
        return json.dumps(_record_to_dict(record), default=str)


class RingLogHandler(logging.Handler):
    """Bounded in-memory tail of structured log records — the "recent
    logs" a diagnostic bundle ships.  Appends are deque-atomic, so the
    hot path takes no lock."""

    def __init__(self, capacity: int = 1024, level: int = logging.DEBUG):
        super().__init__(level=level)
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._ring.append(_record_to_dict(record))
        except Exception:  # logging must never raise into the caller
            self.handleError(record)

    def snapshot(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        out = list(self._ring)
        if last is not None:
            out = out[-int(last):]
        return out


def install_flight_logging(capacity: int = 1024,
                           json_stderr: Optional[bool] = None
                           ) -> RingLogHandler:
    """Attach a :class:`RingLogHandler` to the package logger (reusing
    one that is already attached — idempotent across ClusterServing
    instances in one process) and optionally switch the stderr handler
    to JSON lines.

    ``json_stderr=None`` defers to the ``ZOO_TPU_LOG_JSON`` env var
    (any non-empty value other than "0" turns it on); the plain-text
    default stays human-first for interactive runs.
    """
    for h in logger.handlers:
        if isinstance(h, RingLogHandler):
            ring = h
            break
    else:
        ring = RingLogHandler(capacity=capacity)
        logger.addHandler(ring)
    if json_stderr is None:
        json_stderr = os.environ.get("ZOO_TPU_LOG_JSON", "0") not in ("", "0")
    if json_stderr:
        for h in logger.handlers:
            if isinstance(h, logging.StreamHandler) \
                    and not isinstance(h, RingLogHandler):
                h.setFormatter(JsonLogFormatter())
    return ring


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of per-tick engine state snapshots.

    The engine appends ONE plain dict per device step (see
    `ContinuousEngine._flight_record` for the schema) — no copies, no
    aggregation, no device reads beyond what the tick already computed
    for telemetry.  ``capacity`` ticks of history is the incident
    window a bundle captures, for well under a megabyte of host
    memory.

    Appends are deque-atomic so readers (`/debug/flight`, the bundle
    writer) snapshot without a lock; a snapshot taken mid-append is
    merely one tick short, never torn.
    """

    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0

    def next_seq(self) -> int:
        """Monotonic tick sequence number (survives ring wraparound —
        ``seq`` in the oldest retained record tells you how much
        history fell off)."""
        self._seq += 1
        return self._seq

    def record(self, rec: Dict[str, Any]) -> None:
        # every retained tick states which schema wrote it, so a ring
        # snapshot (or the bundle built from one) is self-describing
        # even when the producer predates the reader
        rec.setdefault("schema_version", FLIGHT_SCHEMA_VERSION)
        self._ring.append(rec)

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        """The retained ticks, oldest first; ``last`` trims to the tail."""
        out = list(self._ring)
        if last is not None:
            out = out[-int(last):]
        return out


# ---------------------------------------------------------------------------
# SLO watchdog
# ---------------------------------------------------------------------------

# the three request-latency dimensions the watchdog judges
SLO_METRICS = ("ttft", "tpot", "queue_wait")

# Per-class targets (seconds).  Interactive buys latency, batch buys
# throughput — same 8:4:1 philosophy as the QoS weights: the classes
# that preempt others also promise more.
DEFAULT_SLO_TARGETS: Dict[str, Dict[str, float]] = {
    "interactive": {"ttft": 1.0, "tpot": 0.25, "queue_wait": 0.5},
    "standard": {"ttft": 2.5, "tpot": 0.5, "queue_wait": 2.0},
    "batch": {"ttft": 10.0, "tpot": 2.0, "queue_wait": 30.0},
}


@dataclass(frozen=True)
class SloPolicy:
    """Per-priority-class latency targets, seconds.  A target of 0 or
    less disables that dimension for that class (nothing breaches)."""

    targets: Dict[str, Dict[str, float]] = field(
        default_factory=lambda: {c: dict(DEFAULT_SLO_TARGETS[c])
                                 for c in PRIORITIES})

    def target(self, cls: str, metric: str) -> float:
        return float(self.targets.get(cls, {}).get(metric, 0.0))


class SloWatchdog:
    """Judges every finished request against :class:`SloPolicy` and
    keeps the score in the shared `MetricsRegistry`.

    Fed by the `Telemetry` request hooks (queue-wait at admission,
    TTFT at the first token, mean TPOT at finish), so it sees exactly
    the stamps the histograms and spans see — one clock, every
    surface.  A request is GOOD when none of its three dimensions
    breached; ``zoo_slo_goodput_{cls}`` is the cumulative good/total
    ratio per class, the number a multi-replica router would route on.

    Breaches also land in a bounded recent ring with timestamps, which
    is what :class:`AnomalyMonitor` polls: a BURST of breaches inside
    a short window triggers a bundle, one slow request does not.
    """

    def __init__(self, policy: Optional[SloPolicy] = None,
                 registry: Optional[MetricsRegistry] = None,
                 prefix: str = "zoo_slo_", recent_capacity: int = 256):
        self.policy = policy or SloPolicy()
        self.prefix = prefix
        self._lock = threading.Lock()
        # uri -> set of breached metric names for the in-flight request
        self._open_breaches: Dict[str, set] = {}
        self._finished: Dict[str, int] = {c: 0 for c in PRIORITIES}
        self._good: Dict[str, int] = {c: 0 for c in PRIORITIES}
        self._breaches: Dict[Tuple[str, str], int] = {
            (c, m): 0 for c in PRIORITIES for m in SLO_METRICS}
        # (monotonic_ts, cls, metric, value, target, uri) — newest last
        self._recent: deque = deque(maxlen=int(recent_capacity))
        # per-class ring of recent finish outcomes (True = met every
        # target) — the brownout controller's goodput signal.  The
        # CUMULATIVE ratio above never recovers after a bad hour, so a
        # controller keyed on it could latch degraded forever; this
        # window forgets.
        self._window: Dict[str, deque] = {
            c: deque(maxlen=int(recent_capacity)) for c in PRIORITIES}
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._register(self.metrics)

    def _register(self, m: MetricsRegistry) -> None:
        p = self.prefix
        for c in PRIORITIES:
            m.gauge(f"{p}requests_total_{c}",
                    f"finished {c} requests judged against the SLO",
                    fn=(lambda c=c: self._finished[c]), kind="counter")
            m.gauge(f"{p}good_requests_total_{c}",
                    f"finished {c} requests that met every SLO target",
                    fn=(lambda c=c: self._good[c]), kind="counter")
            m.gauge(f"{p}goodput_{c}",
                    f"cumulative fraction of {c} requests meeting the SLO "
                    "(1.0 before any finish)",
                    fn=(lambda c=c: self._good[c] / self._finished[c]
                        if self._finished[c] else 1.0))
            for metric in SLO_METRICS:
                m.gauge(f"{p}{metric}_breaches_total_{c}",
                        f"{c} requests whose {metric} exceeded its target",
                        fn=(lambda c=c, metric=metric:
                            self._breaches[(c, metric)]), kind="counter")

    # -- observation hooks (called by Telemetry) ----------------------

    @staticmethod
    def _cls(priority: Optional[str]) -> str:
        return priority if priority in PRIORITIES else "standard"

    def _judge(self, cls: str, metric: str, value: float,
               uri: str) -> None:
        target = self.policy.target(cls, metric)
        if target <= 0.0 or value <= target:
            return
        with self._lock:
            self._breaches[(cls, metric)] += 1
            self._open_breaches.setdefault(uri, set()).add(metric)
            self._recent.append(
                (time.monotonic(), cls, metric, float(value), target, uri))

    def observe_queue_wait(self, priority: Optional[str], wait_s: float,
                           uri: str) -> None:
        self._judge(self._cls(priority), "queue_wait", wait_s, uri)

    def observe_ttft(self, priority: Optional[str], ttft_s: float,
                     uri: str) -> None:
        self._judge(self._cls(priority), "ttft", ttft_s, uri)

    def observe_finish(self, priority: Optional[str], uri: str,
                       tpot_s: Optional[float]) -> None:
        """Final judgement at request finish: fold in the mean TPOT
        (None for single-token responses — no gap to measure) and
        score the request good iff nothing breached."""
        cls = self._cls(priority)
        if tpot_s is not None:
            self._judge(cls, "tpot", tpot_s, uri)
        with self._lock:
            breached = self._open_breaches.pop(uri, None)
            self._finished[cls] += 1
            if not breached:
                self._good[cls] += 1
            self._window[cls].append(not breached)

    def drop(self, uri: str) -> None:
        """Forget an in-flight request that errored or was cancelled —
        it neither counts toward nor against goodput."""
        with self._lock:
            self._open_breaches.pop(uri, None)

    # -- introspection -------------------------------------------------

    def windowed_goodput(self, cls: str) -> float:
        """Fraction of the last ``recent_capacity`` finished ``cls``
        requests that met every SLO target — 1.0 before any finish.
        This (not the cumulative gauge) is what ``plan_brownout``
        consumes: it recovers when the engine does."""
        with self._lock:
            win = self._window.get(cls)
            if not win:
                return 1.0
            return sum(1 for ok in win if ok) / len(win)

    def breach_burst(self, window_s: float) -> int:
        """Breaches recorded in the trailing ``window_s`` seconds."""
        cutoff = time.monotonic() - float(window_s)
        with self._lock:
            return sum(1 for rec in self._recent if rec[0] >= cutoff)

    def status(self) -> Dict[str, Any]:
        """The /healthz + /debug/flight view: targets, per-class
        score, and the tail of recent breaches."""
        with self._lock:
            per_class = {}
            for c in PRIORITIES:
                fin = self._finished[c]
                per_class[c] = {
                    "finished": fin,
                    "good": self._good[c],
                    "goodput": (self._good[c] / fin) if fin else 1.0,
                    "breaches": {m: self._breaches[(c, m)]
                                 for m in SLO_METRICS},
                }
            recent = [{"age_s": round(time.monotonic() - t, 3),
                       "class": c, "metric": m,
                       "value_s": round(v, 4), "target_s": tgt, "uri": u}
                      for (t, c, m, v, tgt, u) in list(self._recent)[-8:]]
        return {"targets": {c: dict(self.policy.targets.get(c, {}))
                            for c in PRIORITIES},
                "per_class": per_class, "recent_breaches": recent}


# ---------------------------------------------------------------------------
# anomaly monitor
# ---------------------------------------------------------------------------

class AnomalyMonitor:
    """Turns raw engine/watchdog signals into rate-limited diagnostic
    bundles.  Four trigger kinds:

    - ``slo_breach_burst`` — >= ``breach_burst`` SLO breaches inside
      ``breach_window_s`` (one slow request never pages).
    - ``alloc_failure_streak`` — >= ``alloc_streak`` CONSECUTIVE ticks
      with at least one block-pool allocation failure: the pool is not
      momentarily tight, it is dry and staying dry.
    - ``steady_state_retrace`` — jit builds or retraces after the
      first ``steady_after_ticks`` ticks.  Cold-start compiles are
      normal; a compile at tick 10,000 means a shape leaked into a
      jitted signature and every occurrence costs seconds.
    - ``engine_crash`` — the pump thread's step raised; always worth a
      bundle (subject only to the rate limit).

    ``dump_cb(reason, detail)`` does the actual writing and returns
    the bundle path (or None on failure); this class only decides WHEN
    — at most one bundle per ``min_interval_s``, and the same reason
    re-fires only after the underlying signal clears and re-asserts.
    """

    def __init__(self, dump_cb: Callable[[str, Dict[str, Any]],
                                         Optional[str]],
                 *, min_interval_s: float = 30.0,
                 breach_burst: int = 8, breach_window_s: float = 10.0,
                 alloc_streak: int = 8, steady_after_ticks: int = 500):
        self.dump_cb = dump_cb
        self.min_interval_s = float(min_interval_s)
        self.breach_burst = int(breach_burst)
        self.breach_window_s = float(breach_window_s)
        self.alloc_streak = int(alloc_streak)
        self.steady_after_ticks = int(steady_after_ticks)
        self._lock = threading.Lock()
        self._last_dump_t: Optional[float] = None
        self._armed = {"slo_breach_burst": True,
                       "alloc_failure_streak": True}
        self._compile_baseline: Optional[int] = None
        # (wall_ts, reason, path) for /debug/flight and tests
        self.bundles: List[Tuple[float, str, Optional[str]]] = []

    # -- trigger decision ---------------------------------------------

    def _trigger(self, reason: str, detail: Dict[str, Any]) -> Optional[str]:
        """Rate-limited dump.  Never raises: a full disk or a bad
        directory must not take the pump thread with it."""
        with self._lock:
            now = time.monotonic()
            if self._last_dump_t is not None \
                    and now - self._last_dump_t < self.min_interval_s:
                return None
            self._last_dump_t = now
        try:
            path = self.dump_cb(reason, detail)
        except Exception:
            logger.exception("diagnostic bundle dump failed (%s)", reason)
            path = None
        self.bundles.append((time.time(), reason, path))
        if path:
            logger.warning("anomaly %s: diagnostic bundle written to %s",
                           reason, path)
        return path

    def poll(self, *, alloc_fail_streak: int = 0, ticks: int = 0,
             compiles: int = 0,
             watchdog: Optional[SloWatchdog] = None) -> None:
        """One cheap check per engine tick, driven by the pump thread.
        ``compiles`` is cumulative jit builds + retraces; ``ticks`` the
        cumulative tick count."""
        # alloc-failure streak: edge-triggered — re-arms when the
        # streak breaks, so one long drought is one bundle
        if alloc_fail_streak >= self.alloc_streak > 0:
            if self._armed["alloc_failure_streak"]:
                self._armed["alloc_failure_streak"] = False
                self._trigger("alloc_failure_streak",
                              {"streak_ticks": int(alloc_fail_streak),
                               "threshold": self.alloc_streak})
        else:
            self._armed["alloc_failure_streak"] = True
        # steady-state retrace: any compile growth past the warmup line
        if ticks >= self.steady_after_ticks > 0:
            if self._compile_baseline is None:
                self._compile_baseline = int(compiles)
            elif compiles > self._compile_baseline:
                grew = int(compiles) - self._compile_baseline
                self._compile_baseline = int(compiles)
                self._trigger("steady_state_retrace",
                              {"new_compiles": grew, "at_tick": int(ticks)})
        # SLO breach burst: level check over the watchdog's recent ring
        if watchdog is not None and self.breach_burst > 0:
            burst = watchdog.breach_burst(self.breach_window_s)
            if burst >= self.breach_burst:
                if self._armed["slo_breach_burst"]:
                    self._armed["slo_breach_burst"] = False
                    self._trigger("slo_breach_burst",
                                  {"breaches": int(burst),
                                   "window_s": self.breach_window_s,
                                   "threshold": self.breach_burst})
            else:
                self._armed["slo_breach_burst"] = True

    def crash(self, exc_text: str) -> Optional[str]:
        """The pump thread's engine.step() raised — dump what we have."""
        return self._trigger("engine_crash", {"traceback": exc_text})

    def history(self) -> List[Dict[str, Any]]:
        return [{"ts": t, "reason": r, "path": p}
                for (t, r, p) in self.bundles]


# ---------------------------------------------------------------------------
# bundle writer
# ---------------------------------------------------------------------------

def _write_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=str)


def dump_bundle(root: str, *, reason: str, detail: Dict[str, Any],
                flight: Optional[FlightRecorder] = None,
                telemetries: Sequence[Any] = (),
                config: Optional[Dict[str, Any]] = None,
                logs: Optional[List[Dict[str, Any]]] = None,
                slo: Optional[Dict[str, Any]] = None,
                spec_acceptance: Optional[Dict[str, Any]] = None,
                extra: Optional[Dict[str, Any]] = None) -> str:
    """Write one self-contained diagnostic bundle directory under
    ``root`` and return its path.

    Layout (every file optional except the manifest — a missing
    telemetry or flight ring writes an empty stub, never fails):

    - ``manifest.json`` — reason, trigger detail, wall time, file list,
      ``schema_version`` (``FLIGHT_SCHEMA_VERSION``)
    - ``flight.json`` — the flight-recorder ring, oldest tick first
    - ``metrics.json`` — merged registry snapshots + Prometheus text
    - ``trace.json`` — Chrome trace-event JSON (Perfetto-loadable)
    - ``config.json`` — the resolved ServingConfig
    - ``logs.jsonl`` — recent structured log records, one per line
    - ``spec_acceptance.json`` — recorded speculative-acceptance
      distribution (``ContinuousEngine.spec_acceptance``), written only
      when the engine runs a draft model; the simulator's calibration
      source (docs/simulation.md)

    ``telemetries`` is any iterable of `Telemetry` facades (serving
    job + engine); their registries merge in order into metrics.json
    and their event rings concatenate into trace.json.
    """
    os.makedirs(root, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    base = f"flight-{stamp}-{reason}"
    path = os.path.join(root, base)
    n = 1
    while os.path.exists(path):  # same-second triggers get a suffix
        n += 1
        path = os.path.join(root, f"{base}.{n}")
    os.makedirs(path)

    files = []
    tels = [t for t in telemetries if t is not None]

    ticks = flight.snapshot() if flight is not None else []
    _write_json(os.path.join(path, "flight.json"),
                {"schema_version": FLIGHT_SCHEMA_VERSION,
                 "capacity": flight.capacity if flight else 0,
                 "n_ticks": len(ticks), "ticks": ticks})
    files.append("flight.json")

    registries = []
    seen = set()
    for t in tels:
        if id(t.metrics) not in seen:
            seen.add(id(t.metrics))
            registries.append(t.metrics)
    merged: Dict[str, Any] = {}
    for r in registries:
        for k, v in r.snapshot().items():
            merged.setdefault(k, v)
    _write_json(os.path.join(path, "metrics.json"),
                {"snapshot": merged,
                 "prometheus": render_prometheus(*registries)})
    files.append("metrics.json")

    events: List[Dict[str, Any]] = []
    seen_events = set()
    for i, t in enumerate(tels):
        if id(t.events) in seen_events:
            continue
        seen_events.add(id(t.events))
        sub = t.events.to_chrome(
            process_name=f"serving-engine/{i}" if i else "serving-engine",
            pid=i + 1)
        events.extend(sub["traceEvents"])
    trace = {"traceEvents": events, "displayTimeUnit": "ms",
             "otherData": {"producer": "analytics_zoo_tpu_torch.serving.flight",
                           "reason": reason}}
    validate_chrome_trace(trace)
    _write_json(os.path.join(path, "trace.json"), trace)
    files.append("trace.json")

    _write_json(os.path.join(path, "config.json"), config or {})
    files.append("config.json")

    with open(os.path.join(path, "logs.jsonl"), "w") as f:
        for rec in (logs or []):
            f.write(json.dumps(rec, default=str) + "\n")
    files.append("logs.jsonl")

    if slo is not None:
        _write_json(os.path.join(path, "slo.json"), slo)
        files.append("slo.json")
    if spec_acceptance is not None:
        _write_json(os.path.join(path, "spec_acceptance.json"),
                    spec_acceptance)
        files.append("spec_acceptance.json")
    if extra:
        _write_json(os.path.join(path, "extra.json"), extra)
        files.append("extra.json")

    _write_json(os.path.join(path, "manifest.json"),
                {"schema_version": FLIGHT_SCHEMA_VERSION,
                 "reason": reason, "detail": detail,
                 "written_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
                 "unix_ts": round(time.time(), 3), "files": files,
                 "n_flight_ticks": len(ticks)})
    return path


def prune_bundles(root: str, keep: int) -> int:
    """Delete the oldest ``flight-*`` bundle directories under ``root``
    beyond ``keep`` (newest by mtime survive).  Returns the number
    removed; a missing root is zero, not an error."""
    try:
        names = [n for n in os.listdir(root) if n.startswith("flight-")
                 and os.path.isdir(os.path.join(root, n))]
    except OSError:
        return 0
    if len(names) <= keep:
        return 0
    names.sort(key=lambda n: os.path.getmtime(os.path.join(root, n)))
    removed = 0
    for n in names[:len(names) - keep]:
        shutil.rmtree(os.path.join(root, n), ignore_errors=True)
        removed += 1
    return removed
