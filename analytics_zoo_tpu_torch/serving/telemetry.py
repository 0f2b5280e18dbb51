"""Engine-wide telemetry: the metrics registry (counters, callback
gauges, windowed histograms, Prometheus text), the span event log
(Chrome trace JSON) and the per-engine :class:`Telemetry` facade fed by
the request-lifecycle hooks.

A copy of ``analytics_zoo_tpu/serving/telemetry.py`` (stdlib only).
Every input is a host int or float the engine already holds, so no
hook reads the device.
"""

from __future__ import annotations

import collections
import json
import math
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "WindowHistogram", "MetricsRegistry",
           "EventLog", "Telemetry", "render_prometheus",
           "validate_chrome_trace"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class Counter:
    """Monotonic cumulative counter (Prometheus ``counter``)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Instantaneous value: either ``set()`` by the owner or computed
    at scrape time by ``fn`` (preferred — the value is fresh and the
    owner pays nothing per update).  ``kind="counter"`` renders a
    monotonic source (e.g. the block pool's cumulative eviction count)
    with the Prometheus counter type while still reading it lazily."""

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None,
                 kind: str = "gauge"):
        self.name, self.help, self.fn, self.kind = name, help, fn, kind
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = v

    @property
    def value(self):
        if self.fn is not None:
            try:
                return self.fn()
            except Exception:
                return None     # a failing callback must not kill scrape
        return self._value

    def snapshot(self):
        return self.value


class WindowHistogram:
    """Sliding-window percentile estimator + cumulative count/sum —
    the generalization of the HTTP frontend's old ``_Percentiles``.

    The window is a preallocated ring of the last ``window`` samples
    (percentiles of recent traffic, the SLO view); ``count``/``sum``
    are cumulative since construction and MONOTONIC across
    ``snapshot()`` calls (the Prometheus summary view — rates come
    from their deltas).  ``reset_window()`` clears only the window
    (benchmarks drop warmup samples without breaking monotonicity).
    """

    kind = "summary"

    def __init__(self, name: str = "", help: str = "",
                 window: int = 2048):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.name, self.help = name, help
        self._window = int(window)
        self._ring: List[float] = [0.0] * self._window
        self._n = 0             # samples currently in the ring
        self._i = 0             # next write index
        self._count = 0         # cumulative, monotonic
        self._sum = 0.0         # cumulative, monotonic
        self._lock = threading.Lock()

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._ring[self._i] = v
            self._i = (self._i + 1) % self._window
            self._n = min(self._n + 1, self._window)
            self._count += 1
            self._sum += v

    def reset_window(self) -> None:
        """Drop the window samples; cumulative count/sum stand."""
        with self._lock:
            self._n = 0
            self._i = 0

    def _window_sorted(self) -> List[float]:
        with self._lock:
            vals = self._ring[:self._n] if self._n < self._window \
                else list(self._ring)
        vals.sort()
        return vals

    @staticmethod
    def _pct(sorted_vals: Sequence[float], q: float) -> float:
        """Linear-interpolated percentile (numpy 'linear' method) —
        kept dependency-free so this module stays jax/numpy-clean."""
        n = len(sorted_vals)
        if n == 1:
            return sorted_vals[0]
        pos = (q / 100.0) * (n - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac

    def percentile(self, q: float) -> Optional[float]:
        vals = self._window_sorted()
        return self._pct(vals, q) if vals else None

    def snapshot(self) -> dict:
        """``count``/``sum`` cumulative (monotonic); ``window`` is the
        current sample count and p50/p90/p99/min/max summarize ONLY
        the window (absent while the window is empty)."""
        vals = self._window_sorted()
        with self._lock:
            out = {"count": self._count, "sum": self._sum,
                   "window": len(vals)}
        if vals:
            out.update(p50=self._pct(vals, 50), p90=self._pct(vals, 90),
                       p99=self._pct(vals, 99), min=vals[0],
                       max=vals[-1])
        return out


class MetricsRegistry:
    """Named metric store with get-or-create accessors.  Creation is
    locked; the returned metric objects are themselves thread-safe, so
    hot paths hold a reference instead of re-looking-up by name."""

    def __init__(self):
        self._metrics: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, factory, cls):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(
            name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None,
              kind: str = "gauge") -> Gauge:
        g = self._get_or_create(
            name, lambda: Gauge(name, help, fn=fn, kind=kind), Gauge)
        if fn is not None:
            # a rebuilt engine re-registering on a shared Telemetry must
            # not leave the gauge reading the DEAD engine's state
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  window: int = 2048) -> WindowHistogram:
        return self._get_or_create(
            name, lambda: WindowHistogram(name, help, window=window),
            WindowHistogram)

    def items(self) -> List[Tuple[str, Any]]:
        with self._lock:
            return list(self._metrics.items())

    def snapshot(self) -> Dict[str, Any]:
        """Dict view: counters/gauges -> value, histograms -> their
        snapshot dicts."""
        return {name: m.snapshot() for name, m in self.items()}


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


def render_prometheus(*registries: MetricsRegistry) -> str:
    """Text exposition (``text/plain; version=0.0.4``) for one or more
    registries: counters and gauges as single samples, window
    histograms as summaries (p50/p90/p99 quantiles over the window,
    cumulative ``_count``/``_sum``)."""
    lines: List[str] = []
    seen = set()
    for reg in registries:
        for name, m in reg.items():
            if name in seen:        # first registration wins
                continue
            seen.add(name)
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, WindowHistogram):
                snap = m.snapshot()
                for q, key in ((0.5, "p50"), (0.9, "p90"),
                               (0.99, "p99")):
                    if key in snap:
                        lines.append(
                            f'{name}{{quantile="{q}"}} '
                            f'{_fmt(snap[key])}')
                lines.append(f"{name}_count {snap['count']}")
                lines.append(f"{name}_sum {_fmt(snap['sum'])}")
            else:
                v = m.snapshot()
                if v is None:
                    continue        # failed gauge callback: no sample
                lines.append(f"{name} {_fmt(v)}")
    return "\n".join(lines) + "\n"


# ---- event log (spans / instants / counter samples) -------------------

class EventLog:
    """Bounded ring of trace events.  Append is one deque.append of a
    plain tuple (CPython deque appends are atomic — no lock on the hot
    path); readers snapshot via ``list(deque)``.

    Event tuples: ``(ph, name, ts, dur, tid, args)`` with ``ph`` one of
    ``"X"`` (complete span, ``dur`` seconds), ``"i"`` (instant) or
    ``"C"`` (counter sample, ``args`` = series values).  ``ts``/``dur``
    are ``time.monotonic()`` seconds; ``tid`` picks the Perfetto track
    (slot index for per-slot work, :data:`TID_ENGINE` for the engine
    loop, :data:`TID_QUEUE` for queue-side request events)."""

    TID_QUEUE = 0
    TID_ENGINE = 1000

    def __init__(self, capacity: int = 65536):
        self._events: collections.deque = collections.deque(
            maxlen=int(capacity))

    def __len__(self) -> int:
        return len(self._events)

    def span(self, name: str, start: float, dur: float, tid: int = 0,
             args: Optional[dict] = None) -> None:
        self._events.append(("X", name, start, max(0.0, dur), tid,
                             args))

    def instant(self, name: str, ts: Optional[float] = None,
                tid: int = 0, args: Optional[dict] = None) -> None:
        self._events.append(("i", name,
                             time.monotonic() if ts is None else ts,
                             None, tid, args))

    def counter_sample(self, name: str, values: Dict[str, float],
                       ts: Optional[float] = None,
                       tid: Optional[int] = None) -> None:
        self._events.append(("C", name,
                             time.monotonic() if ts is None else ts,
                             None, self.TID_ENGINE if tid is None
                             else tid, dict(values)))

    def clear(self) -> None:
        self._events.clear()

    def snapshot(self) -> List[tuple]:
        return list(self._events)

    def to_chrome(self, process_name: str = "serving-engine",
                  pid: int = 1) -> dict:
        """Chrome trace-event JSON (the Perfetto/chrome://tracing
        format): timestamps in microseconds, ``X`` events carry
        ``dur``, ``C`` events carry their series in ``args``."""
        evs: List[dict] = [{
            "ph": "M", "pid": pid, "tid": 0, "ts": 0,
            "name": "process_name",
            "args": {"name": process_name}}]
        named_tids = {self.TID_QUEUE: "queue",
                      self.TID_ENGINE: "engine-loop"}
        tids_seen = set()
        for ph, name, ts, dur, tid, args in self.snapshot():
            ev = {"ph": ph, "name": name, "pid": pid, "tid": tid,
                  "ts": round(ts * 1e6, 3)}
            if ph == "X":
                ev["dur"] = round((dur or 0.0) * 1e6, 3)
            if ph == "i":
                ev["s"] = "t"       # thread-scoped instant
            if args:
                ev["args"] = args
            evs.append(ev)
            tids_seen.add(tid)
        for tid in sorted(tids_seen):
            evs.append({
                "ph": "M", "pid": pid, "tid": tid,
                "ts": 0, "name": "thread_name",
                "args": {"name": named_tids.get(tid, f"slot-{tid}")}})
        return {"traceEvents": evs, "displayTimeUnit": "ms"}


_CHROME_PHASES = {"X", "i", "C", "M", "B", "E", "b", "e", "n"}


def validate_chrome_trace(obj: Any) -> None:
    """Schema check for Chrome trace-event JSON (what Perfetto's
    legacy-JSON importer requires).  Raises ``ValueError`` on the
    first violation; also round-trips through ``json.dumps`` so a
    non-serializable ``args`` payload cannot slip through to a file
    Perfetto then refuses."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be an object with 'traceEvents'")
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for key in ("ph", "name", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing {key!r}")
        ph = ev["ph"]
        if ph not in _CHROME_PHASES:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if "ts" not in ev:
            raise ValueError(f"event {i} missing 'ts'")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i} 'ts' is not numeric")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)):
                raise ValueError(
                    f"event {i}: complete ('X') event needs numeric "
                    f"'dur'")
            if ev["dur"] < 0:
                raise ValueError(f"event {i}: negative 'dur'")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i} 'args' is not an object")
    json.dumps(obj)     # must be serializable as-is


# ---- per-request lifecycle facade -------------------------------------

class _Clock:
    """Host-side per-request lifecycle state (plain floats)."""

    __slots__ = ("arrival", "admitted", "first_token", "last_token",
                 "n_tokens", "priority")

    def __init__(self, arrival: float):
        self.arrival = arrival
        self.admitted: Optional[float] = None
        self.first_token: Optional[float] = None
        self.last_token: Optional[float] = None
        self.n_tokens = 0
        # priority class, learned at admission — the SLO watchdog needs
        # it at first-token and finish time, where the engine no longer
        # passes it
        self.priority: Optional[str] = None


class Telemetry:
    """One instance per serving engine (shareable with the serving job
    that owns it): a :class:`MetricsRegistry`, an :class:`EventLog`,
    and the request-lifecycle helpers the engine's state transitions
    call.  Always on — the opt-in part is only ``keep_request_stamps``
    (the legacy per-request raw stamp store behind the engine's
    ``record_timings``/``pop_request_timings`` shim), because per-uri
    retention is unbounded where the histograms are not.

    Metric-name convention: callers prefix by layer — ``zoo_engine_*``
    (ContinuousEngine), ``zoo_serving_*`` (ClusterServing),
    ``zoo_http_*`` (HttpFrontend) — so one Prometheus scrape can merge
    all three registries without collisions (docs/observability.md has
    the catalog)."""

    def __init__(self, events_capacity: int = 65536,
                 window: int = 8192, prefix: str = "zoo_engine_"):
        self.metrics = MetricsRegistry()
        self.events = EventLog(events_capacity)
        self.keep_request_stamps = False
        self._stamps: Dict[str, dict] = {}
        self._clocks: Dict[str, _Clock] = {}
        self._lock = threading.Lock()
        # Optional SloWatchdog (serving/flight.py) fed from the request
        # hooks below — it sees the SAME stamps the histograms and
        # spans record, so SLO judgements and percentiles agree by
        # construction.  None when nobody attached one.
        self.watchdog = None
        p = prefix
        m = self.metrics
        self.c_submitted = m.counter(
            p + "requests_submitted_total",
            "requests accepted by submit()")
        self.c_finished = m.counter(
            p + "requests_finished_total",
            "requests that emitted their final token")
        self.c_preempted = m.counter(
            p + "requests_preempted_total",
            "pool-dry preemptions back to the queue (re-admissions "
            "re-count in submitted)")
        self.c_errored = m.counter(
            p + "requests_errored_total",
            "requests failed in admission/prefill")
        self.c_tokens = m.counter(
            p + "tokens_emitted_total", "generated tokens")
        self.c_ticks = m.counter(
            p + "ticks_total", "engine device steps")
        self.c_chunks = m.counter(
            p + "prefill_chunks_total", "prefill chunks landed")
        self.c_jit_builds = m.counter(
            p + "jit_builds_total",
            "jitted-program cache misses (cold start only in steady "
            "state)")
        self.c_retraces = m.counter(
            p + "retraces_total",
            "retraces counted by TraceGuard regions wired to this "
            "telemetry")
        self.c_spec_proposed = m.counter(
            p + "spec_proposed_total",
            "draft tokens proposed to speculative verify rounds")
        self.c_spec_accepted = m.counter(
            p + "spec_accepted_total",
            "proposed draft tokens the target verify accepted "
            "(acceptance rate = accepted / proposed)")
        self.h_ttft = m.histogram(
            p + "ttft_seconds",
            "arrival -> first token (queueing + prefill)",
            window=window)
        self.h_tpot = m.histogram(
            p + "tpot_seconds",
            "inter-token gap between consecutive emitted tokens",
            window=window)
        self.h_queue_wait = m.histogram(
            p + "queue_wait_seconds", "arrival -> slot admission",
            window=window)
        # QoS front door (serving/frontdoor.py): per-priority-class
        # splits of queue wait and admission grants.  The registry is
        # label-free by design, so classes are name suffixes.  Always
        # registered (scrapes keep a stable catalog); only populated
        # when requests carry a priority.
        self.h_queue_wait_cls = {
            cls: m.histogram(
                p + f"queue_wait_seconds_{cls}",
                f"arrival -> slot admission, {cls}-class requests",
                window=window)
            for cls in ("interactive", "standard", "batch")}
        self.c_class_grants = {
            cls: m.counter(
                p + f"qos_grants_total_{cls}",
                f"slot admissions granted to {cls}-class requests")
            for cls in ("interactive", "standard", "batch")}
        self.h_tick = m.histogram(
            p + "tick_seconds", "engine step wall time",
            window=window)
        self.h_spec_accept = m.histogram(
            p + "spec_accept_len",
            "accepted draft tokens per row per verify round (0..k)",
            window=window)
        # exact acceptance-length counts (NOT windowed): the
        # simulator's calibration source — spec_acceptance() serializes
        # it into diagnostic bundles (docs/simulation.md)
        self._spec_accept_counts: Dict[int, int] = {}
        self._spec_rounds = 0
        # crash-recovery attempt counters (req_redispatched): uri ->
        # total placements, consumed into the request span at finish
        # so a trace shows which requests rode a replica death
        self._redispatch_attempts: Dict[str, int] = {}

    # -- request lifecycle (engine state transitions) ----------------

    def req_enqueued(self, uri: str) -> None:
        now = time.monotonic()
        with self._lock:
            self._clocks[uri] = _Clock(now)
            if self.keep_request_stamps:
                self._stamps[uri] = {"arrival": now, "token_times": []}
        self.c_submitted.inc()
        self.events.instant("enqueued", now, EventLog.TID_QUEUE,
                            {"uri": uri})

    def req_admitted(self, uri: str, slot: int,
                     prefilling: bool = False,
                     priority: Optional[str] = None) -> None:
        now = time.monotonic()
        with self._lock:
            ck = self._clocks.get(uri)
            if ck is None:      # engine driven without submit telemetry
                ck = self._clocks[uri] = _Clock(now)
            ck.admitted = now
            if priority is not None:
                ck.priority = priority
        self.h_queue_wait.record(now - ck.arrival)
        if priority is not None:
            h = self.h_queue_wait_cls.get(priority)
            if h is not None:
                h.record(now - ck.arrival)
                self.c_class_grants[priority].inc()
        if self.watchdog is not None:
            self.watchdog.observe_queue_wait(ck.priority, now - ck.arrival,
                                             uri)
        self.events.span("queue_wait", ck.arrival, now - ck.arrival,
                         EventLog.TID_QUEUE, {"uri": uri})
        args = {"uri": uri, "state": "PREFILLING" if prefilling
                else "DECODE"}
        if priority is not None:
            # replay (serving/sim/) needs per-class attribution from
            # the trace alone — the bundle's only per-request record
            args["priority"] = priority
        self.events.instant("admitted", now, slot, args)

    def req_token(self, uri: str, slot: int) -> None:
        now = time.monotonic()
        with self._lock:
            ck = self._clocks.get(uri)
            if ck is None:
                ck = self._clocks[uri] = _Clock(now)
            first = ck.first_token is None
            if first:
                ck.first_token = now
            else:
                gap = now - ck.last_token
            ck.last_token = now
            ck.n_tokens += 1
            if self.keep_request_stamps:
                st = self._stamps.get(uri)
                if st is not None:
                    st["token_times"].append(now)
        self.c_tokens.inc()
        if first:
            self.h_ttft.record(now - ck.arrival)
            self.events.instant("first_token", now, slot,
                                {"uri": uri})
            if self.watchdog is not None:
                self.watchdog.observe_ttft(ck.priority, now - ck.arrival,
                                           uri)
        else:
            self.h_tpot.record(gap)

    def req_finished(self, uri: str, slot: int,
                     n_tokens: Optional[int] = None) -> None:
        now = time.monotonic()
        with self._lock:
            ck = self._clocks.pop(uri, None)
        self.c_finished.inc()
        if self.watchdog is not None:
            # mean inter-token gap over the whole response — the SLO
            # view of TPOT (a single-token response has no gap)
            tpot = None
            if ck and ck.first_token is not None and ck.n_tokens > 1:
                tpot = (ck.last_token - ck.first_token) / (ck.n_tokens - 1)
            self.watchdog.observe_finish(ck.priority if ck else None,
                                         uri, tpot)
        start = ck.admitted if ck and ck.admitted is not None else now
        args = {"uri": uri,
                "tokens": n_tokens if n_tokens is not None
                else (ck.n_tokens if ck else 0)}
        with self._lock:
            attempts = self._redispatch_attempts.pop(uri, None)
        if attempts is not None:
            # the request survived a replica death: the span records
            # how many placements its at-least-once recovery took
            args["attempts"] = attempts
        self.events.span("request", start, now - start, slot, args)

    def req_preempted(self, uri: str, slot: int,
                      prefilling: bool = False) -> None:
        """Partial tokens are discarded and the request requeues: the
        clock keeps its ORIGINAL arrival (TTFT spans the preemption,
        like the legacy stamp store) but forgets its token history, so
        readmission re-records a first token."""
        now = time.monotonic()
        with self._lock:
            ck = self._clocks.get(uri)
            if ck is not None:
                ck.admitted = None
                ck.first_token = None
                ck.last_token = None
                ck.n_tokens = 0
            if self.keep_request_stamps:
                st = self._stamps.get(uri)
                if st is not None:
                    st["token_times"] = []
        self.c_preempted.inc()
        self.events.instant(
            "preempted", now, slot,
            {"uri": uri, "prefilling": prefilling})

    def req_errored(self, uri: str, exc: Optional[str] = None) -> None:
        with self._lock:
            self._clocks.pop(uri, None)
        if self.watchdog is not None:
            self.watchdog.drop(uri)
        self.c_errored.inc()
        self.events.instant("request_error", None, EventLog.TID_QUEUE,
                            {"uri": uri, "error": exc or ""})

    def req_redispatched(self, uri: str, attempt: int) -> None:
        """The broker re-placed this request on a surviving replica
        after its original replica died (at-least-once recovery).
        ``attempt`` is the TOTAL placement count (first submit = 1),
        surfaced in the request span at finish; the fleet-level
        ``zoo_router_requests_redispatched_total`` counter lives on
        the router, not here, so per-replica registries never
        double-count one fleet event."""
        with self._lock:
            self._redispatch_attempts[uri] = int(attempt)
            if len(self._redispatch_attempts) > 65536:
                self._redispatch_attempts.pop(
                    next(iter(self._redispatch_attempts)))
        self.events.instant("request_redispatched", None,
                            EventLog.TID_QUEUE,
                            {"uri": uri, "attempt": int(attempt)})

    def req_abandoned(self, uri: str, age_s: float) -> None:
        """A published result nobody ever collected was pruned — the
        request's TERMINAL event (it finished long ago; this marks the
        result's silent disposal, which used to be invisible)."""
        self.metrics.counter(
            "zoo_serving_requests_abandoned_total",
            "published results pruned uncollected after the ttl").inc()
        self.events.instant("request_abandoned", None,
                            EventLog.TID_QUEUE,
                            {"uri": uri, "age_s": round(age_s, 3)})

    # -- front door (serving/frontdoor.py) ---------------------------

    def req_cancelled(self, uri: str) -> None:
        """A live cancellation (explicit /v1/cancel or a mid-stream
        client disconnect) aborted the request ahead of the TTL path."""
        self.metrics.counter(
            "zoo_serving_requests_cancelled_total",
            "requests aborted by live cancellation (explicit cancel "
            "or mid-stream disconnect)").inc()
        if self.watchdog is not None:
            self.watchdog.drop(uri)
        self.events.instant("request_cancelled", None,
                            EventLog.TID_QUEUE, {"uri": uri})

    def stream_disconnect(self, uri: str) -> None:
        """An SSE write failed mid-stream — the client hung up; the
        cancel path fires next."""
        self.metrics.counter(
            "zoo_serving_stream_disconnects_total",
            "streaming clients that disconnected mid-response").inc()
        self.events.instant("stream_disconnect", None,
                            EventLog.TID_QUEUE, {"uri": uri})

    def backpressure_rejection(self) -> None:
        """An admission was refused because the bounded queue was full
        (the client got a 429 + Retry-After)."""
        self.metrics.counter(
            "zoo_serving_backpressure_rejections_total",
            "admissions refused with 429 under a full backlog").inc()

    def deadline_shed(self, uri: str) -> None:
        """A request's deadline passed while it waited in the queue, so
        admission shed it BEFORE prefill (terminal ``deadline_exceeded``
        error).  Distinct from the supervisor's in-flight give-up
        (``zoo_router_requests_given_up_total``): this request never
        cost a single engine tick."""
        with self._lock:
            self._clocks.pop(uri, None)
        if self.watchdog is not None:
            self.watchdog.drop(uri)
        self.metrics.counter(
            "zoo_engine_deadline_admission_sheds_total",
            "requests shed at admission because their deadline had "
            "already passed (never reached prefill)").inc()
        self.events.instant("deadline_shed", None, EventLog.TID_QUEUE,
                            {"uri": uri})

    def brownout_shed(self, priority: str) -> None:
        """The front door refused an admission because the brownout
        ladder browned its class out (429 + level-scaled Retry-After)."""
        self.metrics.counter(
            f"zoo_brownout_shed_total_{priority}",
            f"admissions refused with 429 because the brownout ladder "
            f"browned the {priority} class out").inc()

    def brownout_transition(self, level: int, prev: int) -> None:
        """The brownout controller moved the ladder — a trace instant
        (one per transition, not per tick) plus the transition
        counter; the current level rides the flight ring / metrics
        gauge, not this hook."""
        self.metrics.counter(
            "zoo_brownout_transitions_total",
            "brownout ladder level changes (either direction)").inc()
        self.events.instant(
            "brownout_level", None, EventLog.TID_QUEUE,
            {"level": int(level), "prev": int(prev)})

    # -- engine loop -------------------------------------------------

    def tick(self, start: float, dur: float,
             samples: Dict[str, float]) -> None:
        """One engine step: a span on the engine-loop track, a tick
        wall-time histogram sample, and a Perfetto counter track of
        the per-tick gauges (queue depth, row mix, free blocks, ...).
        Every value arrives as a host int/float the engine already
        computed — recording one costs two deque appends."""
        self.c_ticks.inc()
        self.h_tick.record(dur)
        self.events.span("tick", start, dur, EventLog.TID_ENGINE,
                         samples or None)
        if samples:
            self.events.counter_sample("engine", samples, start)

    def spec_round(self, proposed: int, accepted: int,
                   accept_lens) -> None:
        """One speculative verify round across the live rows: counter
        food for the acceptance rate (accepted/proposed, both
        cumulative), the per-row acceptance-length histogram, and an
        instant on the engine track so a Perfetto timeline shows how
        acceptance moves with the workload."""
        self.c_spec_proposed.inc(proposed)
        self.c_spec_accepted.inc(accepted)
        with self._lock:
            self._spec_rounds += 1
            for n in accept_lens:
                self.h_spec_accept.record(float(n))
                k = int(n)
                self._spec_accept_counts[k] = \
                    self._spec_accept_counts.get(k, 0) + 1
        self.events.instant("spec_round", None, EventLog.TID_ENGINE,
                            {"proposed": proposed,
                             "accepted": accepted})

    def spec_acceptance(self) -> Dict[str, Any]:
        """Serializable speculative-acceptance distribution: exact
        counts of accepted draft tokens per row per verify round since
        engine start (no window, no percentile loss).  ``counts`` keys
        are strings so the section round-trips through JSON bundles
        unchanged; the simulator calibrates its stochastic acceptance
        process from this (serving/sim/, docs/simulation.md)."""
        with self._lock:
            counts = {str(k): v for k, v in
                      sorted(self._spec_accept_counts.items())}
            rounds = self._spec_rounds
        total = sum(counts.values())
        mean = (sum(int(k) * v for k, v in counts.items()) / total
                if total else 0.0)
        return {"rounds": rounds, "samples": total,
                "mean_accept_len": round(mean, 6), "counts": counts}

    def jit_build(self, program: str, key: Any) -> None:
        """A jitted-program cache MISS (new (program, shape) variant):
        cold start builds these eagerly; one appearing in steady state
        is the retrace the trace timeline exists to catch."""
        self.c_jit_builds.inc()
        self.events.instant("jit_build", None, EventLog.TID_ENGINE,
                            {"program": program, "key": repr(key)})

    def retrace(self, label: str, count: int, region: str) -> None:
        """TraceGuard-observed compile-cache growth (lint/runtime.py
        feeds this when a guard is built with ``telemetry=``)."""
        self.c_retraces.inc(count)
        self.events.instant("retrace", None, EventLog.TID_ENGINE,
                            {"callable": label, "new_traces": count,
                             "region": region})

    def pool_event(self, kind: str, **info) -> None:
        """BlockPool hook (``event_cb``): evictions / allocation
        failures as instants on the engine track.  Called while the
        engine holds its pool lock — this only appends, it never locks
        or calls back."""
        self.events.instant("pool_" + kind, None, EventLog.TID_ENGINE,
                            info or None)

    # -- legacy stamp store (record_timings shim) --------------------

    def pop_request_stamps(self) -> Dict[str, dict]:
        """Drain the raw per-request stamp store (the engine's
        ``pop_request_timings`` back-compat surface): uri ->
        {"arrival": t, "token_times": [...]}."""
        with self._lock:
            out = self._stamps
            self._stamps = {}
        return out

    # -- maintenance ---------------------------------------------------

    def reset_windows(self) -> None:
        """Clear every histogram's sliding window (cumulative counts
        stand) — benchmarks call this after warmup so compile time
        never pollutes a percentile."""
        for _, metric in self.metrics.items():
            if isinstance(metric, WindowHistogram):
                metric.reset_window()

    def dump_trace(self, path: Optional[str] = None,
                   process_name: str = "serving-engine") -> dict:
        """Chrome trace-event JSON of the event ring (validated before
        return); with ``path``, also written to disk.  Load it at
        https://ui.perfetto.dev or chrome://tracing."""
        trace = self.events.to_chrome(process_name=process_name)
        validate_chrome_trace(trace)
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace
