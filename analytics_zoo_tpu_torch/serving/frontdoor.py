"""QoS front door plumbing: priority classes and the weighted wait queue
(re-exported from ``policy``), the per-request :class:`TokenEmitter`
between the pump's ``on_token`` hook and the wire, ``Retry-After``
estimation for backpressure, and the wire codecs of the control fields.

A copy of ``analytics_zoo_tpu/serving/frontdoor.py`` (stdlib, numpy and
``policy``).
"""

from __future__ import annotations

import collections
import json
import math
import time
from typing import List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.serving.policy import (  # noqa: F401 (re-export)
    DEFAULT_WEIGHTS, PRIORITIES, QosPolicy, WeightedWaitQueue)


class TokenEmitter:
    """Bounded per-request emission buffer between the engine's
    ``on_token`` hook and the wire.

    ``emit`` runs inside ``engine.step()`` on the pump thread and does
    two list appends — no Redis I/O, no locks, no device syncs, so the
    hot decode loop's cost profile is unchanged.  After each ``step()``
    the pump calls ``drain()`` and publishes everything in one
    pipeline.  Terminal markers (``finish``/``error``/``cancelled``)
    ride the same per-request buffer, so a request's final tokens are
    always published BEFORE its done marker even though ``on_done``
    fires mid-step.

    The per-request bound is the engine's ``max_new`` ceiling plus the
    terminal marker — the buffer structurally cannot outgrow it between
    drains; ``max_events`` is a belt-and-suspenders cap (oldest events
    drop, which a bound this size never triggers in practice)."""

    def __init__(self, max_events: int = 8192):
        self.max_events = int(max_events)
        self._buf: "collections.OrderedDict[str, collections.deque]" = \
            collections.OrderedDict()
        self.dropped = 0

    def _events(self, uri: str) -> collections.deque:
        q = self._buf.get(uri)
        if q is None:
            q = self._buf[uri] = collections.deque()
        return q

    def emit(self, uri: str, token: int, index: int) -> None:
        """Engine ``on_token`` hook (pump thread, mid-step)."""
        q = self._events(uri)
        if len(q) >= self.max_events:
            q.popleft()
            self.dropped += 1
        q.append(("tok", index, token))

    def finish(self, uri: str) -> None:
        self._events(uri).append(("done", 0, 0))

    def error(self, uri: str, message: str) -> None:
        self._events(uri).append(("error", 0, message))

    def cancelled(self, uri: str) -> None:
        self._events(uri).append(("cancelled", 0, 0))

    def discard(self, uri: str) -> None:
        self._buf.pop(uri, None)

    def drain(self) -> List[Tuple[str, List[tuple]]]:
        """Take everything buffered since the last drain, in emission
        order per request."""
        if not self._buf:
            return []
        out = [(uri, list(q)) for uri, q in self._buf.items() if q]
        self._buf.clear()
        return out


class ThroughputEstimator:
    """EWMA completions/sec from a cumulative finished counter —
    ``Retry-After`` needs a recent-throughput denominator, and sampling
    the counter the engine already increments costs nothing.  Returns
    ``fallback_rate`` until two observations exist (a cold or idle
    server must still send a FINITE Retry-After)."""

    def __init__(self, fallback_rate: float = 4.0, alpha: float = 0.3):
        self.fallback_rate = float(fallback_rate)
        self.alpha = float(alpha)
        self._last: Optional[Tuple[float, float]] = None
        self._rate = 0.0

    def observe(self, total_finished: float,
                now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self._last is not None:
            dt = now - self._last[1]
            if dt > 0:
                inst = max(0.0, total_finished - self._last[0]) / dt
                self._rate = (inst if self._rate == 0.0 else
                              self.alpha * inst +
                              (1 - self.alpha) * self._rate)
        self._last = (float(total_finished), now)

    def rate(self) -> float:
        return self._rate if self._rate > 0 else self.fallback_rate


def retry_after_s(depth: int, rate: float, lo: float = 1.0,
                  hi: float = 120.0, level: int = 0) -> int:
    """Seconds a 429'd client should wait: queue depth over recent
    completion throughput, clamped to ``[lo, hi]`` so the header is
    always finite and never tells a client to hammer back instantly.
    ``level`` is the brownout ladder level: each level scales the
    pre-clamp estimate by one extra multiple, so the hint is monotone
    non-decreasing as degradation deepens (a shed class should back
    off LONGER than a merely-queued one) while the ``hi`` clamp keeps
    even level-4 finite."""
    if rate <= 0:
        return int(hi)
    base = float(depth) / rate * (1 + max(0, int(level)))
    return int(min(hi, max(lo, base)))


# ---- request deadlines (docs/serving_qos.md "Overload & brownout") ----

#: Deadlines past 24h are a client bug (an absolute timestamp sent
#: where a relative budget belongs, a ms/s unit mix-up), not patience.
MAX_DEADLINE_MS = 24 * 3600 * 1000


def validate_deadline_ms(value) -> int:
    """A client-supplied deadline budget (``X-Request-Deadline-Ms``
    header or ``deadline_ms`` body field): milliseconds from now.
    Returns the validated integer budget; raises ``ValueError`` (the
    front door's 400 path) with a pointed message on anything
    non-numeric, non-finite, non-positive, or past the 24h ceiling."""
    if isinstance(value, bool):
        raise ValueError(
            f"deadline_ms must be a number of milliseconds, "
            f"got {value!r}")
    try:
        f = float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"deadline_ms must be a number of milliseconds, "
            f"got {value!r}")
    if math.isnan(f) or math.isinf(f):
        raise ValueError(
            f"deadline_ms must be finite, got {value!r}")
    if f <= 0:
        raise ValueError(
            f"deadline_ms must be > 0 (milliseconds from now), "
            f"got {value!r}")
    if f > MAX_DEADLINE_MS:
        raise ValueError(
            f"deadline_ms {value!r} exceeds the 24h ceiling "
            f"({MAX_DEADLINE_MS} ms) — send a relative budget, not an "
            f"absolute timestamp")
    return int(f)


def encode_deadline(deadline_ms, now_wall: Optional[float] = None
                    ) -> np.ndarray:
    """Validated relative budget -> the int64 ABSOLUTE unix wall-clock
    millisecond the input queue transports.  Wall clock (not monotonic)
    because the queue entry crosses process boundaries; the consumer
    converts back to its own monotonic domain at decode."""
    ms = validate_deadline_ms(deadline_ms)
    now_wall = time.time() if now_wall is None else now_wall
    return np.int64(int(now_wall * 1000.0) + ms)


def decode_deadline(v, now_wall: Optional[float] = None,
                    now_mono: Optional[float] = None) -> float:
    """Wire deadline (absolute wall-clock ms) -> the engine-side
    ``deadline_t`` in the consumer's ``time.monotonic`` domain
    (seconds).  0.0 means no deadline; an already-passed wall time
    yields a ``deadline_t`` in the past, which admission sheds."""
    wall_ms = int(np.asarray(v).reshape(-1)[0])
    if wall_ms <= 0:
        return 0.0
    now_wall = time.time() if now_wall is None else now_wall
    now_mono = time.monotonic() if now_mono is None else now_mono
    return now_mono + (wall_ms / 1000.0 - now_wall)


# ---- wire codecs ------------------------------------------------------

def encode_str_field(s: str) -> np.ndarray:
    """A string control field as the uint8 byte array the input queue
    transports (it rejects str/bytes fields by design)."""
    return np.frombuffer(s.encode("utf-8"), np.uint8).copy()


def decode_str_field(a) -> str:
    return bytes(np.asarray(a, np.uint8).reshape(-1).tolist()) \
        .decode("utf-8", "replace")


def encode_priority(priority: str) -> np.ndarray:
    try:
        return np.int32(PRIORITIES.index(priority))
    except ValueError:
        raise ValueError(
            f"priority must be one of {PRIORITIES}, got {priority!r}")


def decode_priority(v) -> str:
    idx = int(np.asarray(v).reshape(-1)[0])
    if not 0 <= idx < len(PRIORITIES):
        return "standard"
    return PRIORITIES[idx]


def sse_event(event: str, data: dict) -> bytes:
    """One ``text/event-stream`` frame (docs/serving_qos.md wire
    format)."""
    return (f"event: {event}\ndata: "
            f"{json.dumps(data, separators=(',', ':'))}\n\n"
            ).encode("utf-8")


# request ids travel through queue field names, log lines, span args,
# and response headers — keep the accepted alphabet boring enough that
# none of those surfaces needs escaping
_REQUEST_ID_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    "-_.:")


def normalize_request_id(value) -> Optional[str]:
    """A client-supplied ``X-Request-Id`` as a usable request uri, or
    None when it is absent/empty/oversized/outside the safe alphabet
    (the frontend then falls back to a generated uuid — a bad header
    never rejects the request, it just loses client-side
    correlation)."""
    if not isinstance(value, str):
        return None
    value = value.strip()
    if not value or len(value) > 128:
        return None
    if not all(c in _REQUEST_ID_CHARS for c in value):
        return None
    return value
