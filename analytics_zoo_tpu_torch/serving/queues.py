"""Cluster Serving client queues: ``InputQueue.enqueue(uri, **data)``
writes base64(npy) ndarrays to the input stream, ``OutputQueue.query``
and ``dequeue`` read results back from their hashes.

A copy of ``analytics_zoo_tpu/serving/queues.py`` (numpy and ``resp``).
"""

from __future__ import annotations

import base64
import io
import time
import uuid
from typing import Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.serving.resp import RespClient

INPUT_STREAM = "serving_stream"
RESULT_PREFIX = "result:"
SIGNAL_PREFIX = "rsig:"   # per-uri wakeup stream: XREAD BLOCK, not polling
TOKEN_PREFIX = "tok:"     # per-uri token stream (streaming requests):
#                           the pump publishes generated tokens + a
#                           terminal marker; stream_events() tails it
CANCEL_STREAM = "serving_cancel"  # client -> pump live-cancel requests
IMG_MAGIC = b"IMG!"       # field prefix: raw encoded image (JPEG/PNG bytes)
#                           decoded server-side — ref: Cluster Serving
#                           clients enqueued base64 image bytes and the
#                           Flink job decoded/resized before inference


class BacklogFull(RuntimeError):
    """The bounded admission queue refused an enqueue.  Subclasses
    ``RuntimeError`` so pre-existing ``except RuntimeError`` callers
    keep working; carries the observed depth and the cap so the HTTP
    frontend can map it to ``429`` with a computed ``Retry-After``."""

    def __init__(self, depth: int, max_backlog: int):
        self.depth = int(depth)
        self.max_backlog = int(max_backlog)
        super().__init__(
            f"serving backlog {self.depth} >= max_backlog "
            f"{self.max_backlog}; request rejected (not trimmed)")


def encode_ndarray(a: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.asarray(a), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode()


def decode_ndarray(s) -> np.ndarray:
    raw = base64.b64decode(s)
    return np.load(io.BytesIO(raw), allow_pickle=False)


class ImageBytes(bytes):
    """Marker type: a value that is ENCODED image bytes (JPEG/PNG), to be
    decoded server-side — lets image payloads travel through the generic
    ``enqueue(uri, col=value)`` surface (and the HTTP frontend) alongside
    dense-tensor columns."""


class InputQueue:
    """ref-parity: InputQueue(host, port).enqueue(uri, key=ndarray, ...)"""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 stream: str = INPUT_STREAM, max_backlog: int = 10000):
        """max_backlog > 0 rejects enqueues (BacklogFull) once the pending
        stream holds that many entries; 0 disables the cap.  No MAXLEN
        trimming is used: the server XDELs entries as it consumes them, so
        trimming could only ever drop requests that were never read."""
        self.client = RespClient(host, port)
        self.stream = stream
        self.max_backlog = max_backlog

    def enqueue(self, uri: Optional[str] = None, **data) -> str:
        """Enqueue one request; returns its uri (generated when omitted).
        `data` values are ndarrays (or scalars) keyed by input name."""
        uri = uri or str(uuid.uuid4())
        if "uri" in data:
            raise ValueError(
                "'uri' is the request id, not an input column name")
        fields = ["uri", uri]
        for k, v in data.items():
            if isinstance(v, ImageBytes):
                fields += [k, IMG_MAGIC + bytes(v)]
            elif isinstance(v, (bytes, bytearray, memoryview, str)):
                # np.asarray(bytes/str) would silently make a |S/|U
                # string scalar that explodes much later inside the
                # server's jit with an inscrutable error — refuse it
                # HERE with the fix named
                raise TypeError(
                    f"field {k!r} is {type(v).__name__}; wrap encoded "
                    f"images as ImageBytes(b) (or use enqueue_image), "
                    f"send tensors as ndarrays, and generative prompts "
                    f"as 1-D int32 token arrays (the prompt_col "
                    f"contract)")
            else:
                fields += [k, encode_ndarray(np.asarray(v))]
        return self._xadd_capped(uri, fields)

    def _xadd_capped(self, uri: str, fields) -> str:
        if not self.max_backlog:
            self.client.execute("XADD", self.stream, "*", *fields)
            return uri
        # add-then-check in ONE round-trip: concurrent producers that
        # overshoot each remove their own entry, so the cap holds under
        # racing threads without a MAXLEN trim dropping unread requests
        entry_id, depth = self.client.pipeline([
            ("XADD", self.stream, "*", *fields),
            ("XLEN", self.stream)])
        if int(depth or 0) > self.max_backlog:
            self.client.execute("XDEL", self.stream, entry_id)
            raise BacklogFull(int(depth) - 1, self.max_backlog)
        return uri

    def cancel(self, uri: str) -> None:
        """Request live cancellation of an in-flight request: the
        serving pump drains the cancel stream every loop iteration and
        calls ``engine.abort(uri)`` on its own thread, freeing BOTH
        pool tenants' blocks immediately instead of waiting for the
        ``result_ttl_s`` prune.  Idempotent; unknown uris are ignored
        server-side."""
        self.client.execute("XADD", CANCEL_STREAM, "*", "uri", uri)

    def enqueue_image(self, uri: Optional[str] = None, *,
                      image: bytes, col: str = "x") -> str:
        """Enqueue one ENCODED image (JPEG/PNG bytes) — the server decodes
        it natively (C++ libjpeg/libpng), resizes per its config, and
        batches it into the model input (ref: InputQueue.enqueue_image).
        The wire carries the compressed bytes, not a dense tensor."""
        uri = uri or str(uuid.uuid4())
        return self._xadd_capped(
            uri, ["uri", uri, col, IMG_MAGIC + bytes(image)])

    def close(self):
        self.client.close()


class OutputQueue:
    """ref-parity: OutputQueue().query(uri) / dequeue()."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379):
        self.client = RespClient(host, port)

    def query(self, uri: str, timeout: float = 30.0,
              poll_interval: float = 0.01) -> Optional[np.ndarray]:
        """Block until the result for `uri` lands (or timeout -> None).

        Waits on the per-uri signal stream with XREAD BLOCK — one blocking
        round-trip instead of a poll storm (the broker's condvar wakes the
        read the instant the server publishes).  `poll_interval` is kept
        for API compatibility; it only paces the legacy fallback path.
        Each XREAD blocks at most half the connection's own socket
        timeout: a read the socket gave up on would leave its late reply
        on the connection, where the next command would take it."""
        deadline = time.monotonic() + timeout
        key = RESULT_PREFIX + uri
        sig = SIGNAL_PREFIX + uri
        limit = self.client.sock.gettimeout()
        h = self.client.execute("HGETALL", key)
        while not h:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # the blocking XREAD auto-created the signal stream on the
                # broker; remove it so abandoned queries don't leak keys
                self.client.execute("DEL", sig)
                return None
            wait = remaining if limit is None else min(remaining, limit / 2)
            try:
                self.client.execute(
                    "XREAD", "COUNT", 1, "BLOCK",
                    max(1, int(wait * 1000)), "STREAMS", sig, "0-0")
            except Exception:
                time.sleep(poll_interval)   # legacy broker: plain polling
            h = self.client.execute("HGETALL", key)
        fields = {h[i].decode(): h[i + 1] for i in range(0, len(h), 2)}
        self.client.execute("DEL", key, sig)
        self.client.execute("SREM", "__result_keys__", uri)
        if "error" in fields:
            # the server could not process this request (bad payload,
            # shape mismatch) — fail fast rather than hand back None
            raise RuntimeError(
                f"serving error for {uri!r}: "
                f"{fields['error'].decode(errors='replace')}")
        return decode_ndarray(fields["value"])

    def stream_events(self, uri: str, timeout: float = 30.0,
                      poll_s: float = 1.0):
        """Tail the per-token stream of a ``stream=True`` request.

        Yields dicts in emission order: ``{"token": t, "index": i}``
        per generated token, then exactly one terminal —
        ``{"done": True}`` / ``{"cancelled": True}`` /
        ``{"error": msg}`` — after which the stream key is deleted and
        the generator returns.  ``{"ping": True}`` heartbeats surface
        between events (at most every ``poll_s``) so an SSE writer can
        touch its socket and detect a dead client while the engine is
        between tokens.  Re-emitted tokens after an engine preemption
        are deduplicated by index (a readmitted row regenerates its
        tokens deterministically).  A ``{"restart": attempt}`` event
        surfaces a crash-recovery redispatch (the broker re-placed
        the request on a surviving replica): the emitted-token index
        resets to 0 and the generation re-streams from the start —
        consumers must discard buffered tokens, never splice.
        Raises ``TimeoutError`` when no event lands for ``timeout``
        seconds."""
        key = TOKEN_PREFIX + uri
        last = b"0-0"
        next_index = 0
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.client.execute("DEL", key)
                raise TimeoutError(
                    f"no stream event for {uri!r} in {timeout}s")
            block_ms = max(1, int(min(remaining, poll_s) * 1000))
            resp = self.client.execute(
                "XREAD", "COUNT", 256, "BLOCK", block_ms,
                "STREAMS", key, last)
            if not resp:
                yield {"ping": True}
                continue
            for eid, flat in resp[0][1]:
                last = eid
                f = {flat[i].decode(): flat[i + 1]
                     for i in range(0, len(flat), 2)}
                if "restart" in f:
                    # crash-recovery redispatch: the replay starts
                    # over at index 0, so the dedup watermark must
                    # reset or every re-emitted token gets swallowed
                    next_index = 0
                    deadline = time.monotonic() + timeout
                    yield {"restart": int(f["restart"])}
                elif "t" in f:
                    idx = int(f.get("i", b"-1"))
                    if idx < next_index:    # preemption re-emission
                        continue
                    next_index = idx + 1
                    deadline = time.monotonic() + timeout
                    yield {"token": int(f["t"]), "index": idx}
                elif "done" in f:
                    self.client.execute("DEL", key)
                    yield {"done": True}
                    return
                elif "cancelled" in f:
                    self.client.execute("DEL", key)
                    yield {"cancelled": True}
                    return
                elif "error" in f:
                    self.client.execute("DEL", key)
                    yield {"error":
                           f["error"].decode(errors="replace")}
                    return

    def dequeue(self) -> Dict[str, np.ndarray]:
        """Drain every available result (ref: OutputQueue.dequeue).
        Results are stored under result:<uri>; the server keeps a set index
        of unread uris, which `query` prunes as results are consumed."""
        out: Dict[str, np.ndarray] = {}
        keys = self.client.execute("SMEMBERS", "__result_keys__") or []
        for uri in keys:
            try:
                v = self.query(uri.decode(), timeout=0.05)
            except RuntimeError:    # errored request: consumed, not drained
                continue
            if v is not None:
                out[uri.decode()] = v
        return out

    def close(self):
        self.client.close()
