"""Cluster Serving HTTP frontend: a stdlib ``ThreadingHTTPServer`` in
front of the RESP broker.

Routes: ``POST /predict`` (JSON instances), ``POST /v1/generate`` (the
generative front door: prompt, ``stream`` for server-sent events,
``priority``, ``tenant``, ``max_new``, ``temperature``, ``seed``,
``top_p``, ``prefix``; 429 with ``Retry-After`` when the admission
queue is full), ``POST /v1/cancel``, ``GET /metrics`` (Prometheus text),
``GET /trace``, ``GET /healthz`` and ``GET /debug/flight``.

A copy of ``analytics_zoo_tpu/serving/http_frontend.py``.
"""

from __future__ import annotations

import base64
import json
import ssl
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.common.log import logger
from analytics_zoo_tpu_torch.serving.flight import request_uri_context
from analytics_zoo_tpu_torch.serving.frontdoor import (ThroughputEstimator,
                                                 decode_priority,
                                                 encode_deadline,
                                                 encode_priority,
                                                 encode_str_field,
                                                 normalize_request_id,
                                                 retry_after_s, sse_event,
                                                 validate_deadline_ms)
from analytics_zoo_tpu_torch.serving.policy import (brownout_admit,
                                              brownout_classes)
from analytics_zoo_tpu_torch.serving.queues import (
    BacklogFull, ImageBytes, InputQueue, OutputQueue)
from analytics_zoo_tpu_torch.serving.telemetry import (
    MetricsRegistry, WindowHistogram, render_prometheus)


def _decode_value(v):
    """JSON value -> ndarray or image payload: nested lists,
    {"b64","shape","dtype"} dense tensors, or {"image_b64": ...} encoded
    JPEG/PNG bytes the server decodes natively (ref: FrontEndApp accepted
    base64 image bodies)."""
    if isinstance(v, dict):
        if "image_b64" in v:
            return ImageBytes(base64.b64decode(v["image_b64"],
                                               validate=True))
        raw = base64.b64decode(v["b64"], validate=True)
        a = np.frombuffer(raw, dtype=np.dtype(v.get("dtype", "float32")))
        return a.reshape(v["shape"]) if "shape" in v else a
    return np.asarray(v)


class _Percentiles:
    """Sliding-window latency gauge — back-compat shim over a telemetry
    :class:`WindowHistogram` (serving/telemetry.py), which generalized
    this class's private deque.  Same ms-scaled snapshot keys; same
    window-count semantics (``count`` is the samples currently in the
    window, not the cumulative total — that is the histogram's own
    ``snapshot()["count"]``)."""

    def __init__(self, window: int = 2048,
                 hist: Optional[WindowHistogram] = None):
        self._hist = hist if hist is not None else WindowHistogram(
            "latency_seconds", window=window)

    def record(self, seconds: float):
        self._hist.record(seconds)

    def snapshot(self) -> dict:
        s = self._hist.snapshot()
        if not s["window"]:
            return {"count": 0}
        return {
            "count": int(s["window"]),
            "p50_ms": round(s["p50"] * 1e3, 3),
            "p90_ms": round(s["p90"] * 1e3, 3),
            "p99_ms": round(s["p99"] * 1e3, 3),
        }


class HttpFrontend:
    """ref-parity: FrontEndApp — REST in front of the serving queues."""

    def __init__(self, redis_host: str = "127.0.0.1",
                 redis_port: int = 6379, http_port: int = 0,
                 timeout: float = 30.0,
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None,
                 serving=None, tokenizer=None,
                 prompt_col: Optional[str] = None,
                 max_backlog: Optional[int] = None):
        self.redis_host, self.redis_port = redis_host, redis_port
        self.timeout = timeout
        self.serving = serving          # optional ClusterServing for stats
        # bounded admission (backpressure): the pooled InputQueues
        # reject past this backlog with BacklogFull -> 429.  None
        # inherits the serving config's cap when attached.
        if max_backlog is None:
            max_backlog = (getattr(serving.config, "max_backlog", 10000)
                           if serving is not None else 10000)
        self.max_backlog = int(max_backlog)
        self._throughput = ThroughputEstimator()
        # text-in / text-out generative serving: a ``tokenizers``
        # Tokenizer instance or a tokenizer.json path.  Instances with a
        # "text" field encode into the prompt column; their results
        # decode back to strings (trimmed at the serving eos, if set).
        if isinstance(tokenizer, str):
            from tokenizers import Tokenizer

            tokenizer = Tokenizer.from_file(tokenizer)
        self.tokenizer = tokenizer
        # fallback mirrors server.py's continuous pump ("prompt") so an
        # unset ServingConfig.prompt_col yields ONE shared default
        self.prompt_col = prompt_col or (
            serving.config.prompt_col if serving is not None
            and getattr(serving.config, "prompt_col", None)
            else "prompt")
        self._eos_id = (serving.config.eos_id
                        if serving is not None else None)
        # frontend-local metrics (zoo_http_*); /metrics merges them
        # with the serving job's and the engine's registries at scrape
        self.registry = MetricsRegistry()
        self.latency = _Percentiles(hist=self.registry.histogram(
            "zoo_http_request_seconds",
            "end-to-end POST /predict wall time (failures included)"))
        self.c_rejected = self.registry.counter(
            "zoo_http_backpressure_rejections_total",
            "requests answered 429 under a full admission queue")
        self.c_disconnects = self.registry.counter(
            "zoo_http_stream_disconnects_total",
            "SSE clients that disconnected mid-stream (each triggers "
            "a live cancel)")
        if serving is not None:
            self.registry.gauge(
                "zoo_http_backlog",
                "input-stream entries not yet consumed by the backend",
                fn=lambda: self.serving.backlog())
        # ThreadingHTTPServer spawns a fresh thread per connection, so
        # thread-local caching would never hit: pool the RESP client pairs
        self._pool: list = []
        self._pool_lock = threading.Lock()
        self._pool_max = 16
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # route through our logger
                logger.debug("http: " + a[0], *a[1:])

            def _send(self, code: int, payload: dict,
                      headers: Optional[dict] = None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_429(self, depth, message, level=0):
                # header and body carry the SAME value by construction
                # — a client honoring either backs off identically
                ra = frontend._retry_after(depth, level=level)
                body = json.dumps({"error": message,
                                   "retry_after_s": ra}).encode()
                self.send_response(429)
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", str(ra))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_503_dead(self):
                # zero live replicas: refusing with a finite
                # Retry-After beats accepting a submit that can never
                # be placed (the supervisor may be restarting pumps —
                # clients should back off and retry, not hang)
                ra = frontend._retry_after(None)
                body = json.dumps(
                    {"error": "no live replicas — fleet is "
                              "recovering",
                     "retry_after_s": ra}).encode()
                self.send_response(503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", str(ra))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    self._send(200, frontend.health())
                elif path == "/metrics":
                    if "format=json" in query:
                        self._send(200, frontend.metrics())
                        return
                    body = frontend.prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/trace":
                    trace = frontend.trace()
                    if trace is None:
                        self._send(404, {
                            "error": "no engine telemetry attached "
                                     "(start the frontend with "
                                     "serving=...)"})
                    else:
                        self._send(200, trace)
                elif path == "/debug/flight":
                    n = 100
                    for part in query.split("&"):
                        if part.startswith("n="):
                            try:
                                n = max(1, int(part[2:]))
                            except ValueError:
                                pass
                    body = frontend.debug_flight(last=n)
                    if body is None:
                        self._send(404, {
                            "error": "no flight recorder attached "
                                     "(start the frontend with "
                                     "serving=...)"})
                    else:
                        self._send(200, body)
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/v1/generate":
                    self._do_generate()
                    return
                if self.path == "/v1/cancel":
                    self._do_cancel()
                    return
                if self.path != "/predict":
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                if frontend._fleet_dead():
                    self._send_503_dead()
                    return
                t0 = time.perf_counter()
                # record failures too — excluding timeouts would hide the
                # slowest tail exactly when the backend is unhealthy
                try:
                    # payload-shaped failures are the client's fault (400);
                    # everything else (broker down, RESP protocol error,
                    # backend crash) is a server-side failure (502)
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        body = self.rfile.read(n) or b"{}"
                        req = json.loads(body)
                        instances = req.get("instances")
                        if instances is None:
                            instances = [req]   # single-instance body
                        text_rows = []
                        decoded = []
                        for inst in instances:
                            if "text" in inst:
                                if frontend.tokenizer is None:
                                    raise ValueError(
                                        "'text' instances need the "
                                        "frontend started with "
                                        "tokenizer=...")
                                if frontend.prompt_col in inst:
                                    raise ValueError(
                                        f"instance carries BOTH 'text' "
                                        f"and {frontend.prompt_col!r}: "
                                        f"ambiguous prompt — send one")
                                inst = dict(inst)
                                ids = np.asarray(
                                    frontend.tokenizer.encode(
                                        str(inst.pop("text"))).ids,
                                    np.int32)
                                if ids.size == 0:
                                    raise ValueError(
                                        "text tokenized to zero tokens")
                                inst[frontend.prompt_col] = ids
                                text_rows.append(True)
                            else:
                                text_rows.append(False)
                            decoded.append({k: _decode_value(v)
                                            for k, v in inst.items()})
                        for inst in decoded:
                            if "uri" in inst:
                                raise ValueError(
                                    "'uri' is reserved for the request id"
                                    " and cannot be an input column")
                    except (json.JSONDecodeError, KeyError, ValueError,
                            TypeError, AttributeError) as e:
                        self._send(400,
                                   {"error": f"{type(e).__name__}: {e}"})
                        return
                    preds = frontend._predict(decoded, text_rows)
                except BacklogFull as e:
                    frontend._count_rejection()
                    self._send_429(e.depth, str(e))
                    return
                except TimeoutError as e:
                    self._send(504, {"error": str(e)})
                    return
                except Exception as e:   # backend/broker failure
                    self._send(502, {"error": f"{type(e).__name__}: {e}"})
                    return
                finally:
                    frontend.latency.record(time.perf_counter() - t0)
                self._send(200, {"predictions": preds})

            def _do_cancel(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    uri = req.get("uri")
                    if not uri or not isinstance(uri, str):
                        raise ValueError("body needs a string 'uri'")
                except (json.JSONDecodeError, ValueError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                pair = frontend._acquire()
                try:
                    pair[0].cancel(uri)
                except Exception as e:
                    pair[0].close()
                    pair[1].close()
                    self._send(502, {"error": f"{type(e).__name__}: {e}"})
                    return
                frontend._release(pair)
                self._send(200, {"uri": uri, "status": "cancelling"})

            def _do_generate(self):
                t0 = time.perf_counter()
                if frontend._fleet_dead():
                    self._send_503_dead()
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError("body must be a JSON object")
                    deadline_ms = frontend._deadline_ms(
                        req.pop("deadline_ms", None),
                        self.headers.get("X-Request-Deadline-Ms"))
                    fields, stream = frontend._generate_fields(req)
                    if deadline_ms is not None:
                        fields["deadline"] = encode_deadline(deadline_ms)
                except (json.JSONDecodeError, KeyError, ValueError,
                        TypeError, AttributeError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                # brownout admission gate (docs/serving_qos.md): with
                # at least one replica live (the fleet-dead 503 above
                # owns zero-live), a browned-out class gets 429 + a
                # level-scaled Retry-After — an honest "come back
                # later", never a silent queue-then-shed
                level = frontend._brownout_level()
                if level > 0:
                    pri = (decode_priority(fields["priority"])
                           if "priority" in fields else "standard")
                    if not brownout_admit(level, pri):
                        frontend._count_shed(pri)
                        self._send_429(
                            None,
                            f"brownout level {level}: {pri}-class "
                            f"admissions are shed — retry later",
                            level=level)
                        return
                pair = frontend._acquire()
                inq, outq = pair
                # a client-supplied X-Request-Id becomes the uri end to
                # end (spans, logs, SSE start event) so the caller's own
                # correlation id works on every surface; unusable values
                # silently fall back to a uuid rather than rejecting
                uri = normalize_request_id(
                    self.headers.get("X-Request-Id")) or str(uuid.uuid4())
                echo = {"X-Request-Id": uri}
                with request_uri_context(uri):
                    try:
                        try:
                            inq.enqueue(uri, **fields)
                        except BacklogFull as e:
                            # the rejecting XADD/XDEL completed cleanly —
                            # the pair is protocol-safe to pool again
                            frontend._count_rejection()
                            self._send_429(e.depth, str(e))
                            frontend._release(pair)
                            return
                        if not stream:
                            r = outq.query(uri, timeout=frontend.timeout)
                            if r is None:
                                raise TimeoutError(
                                    f"result for {uri} not ready within "
                                    f"{frontend.timeout}s")
                            frontend._release(pair)
                            self._send(200, frontend._generate_result(
                                uri, np.asarray(r)), headers=echo)
                            return
                    except TimeoutError as e:
                        pair[0].close()
                        pair[1].close()
                        self._send(504, {"error": str(e), "uri": uri},
                                   headers=echo)
                        return
                    except Exception as e:
                        pair[0].close()
                        pair[1].close()
                        self._send(502,
                                   {"error": f"{type(e).__name__}: {e}",
                                    "uri": uri}, headers=echo)
                        return
                    finally:
                        frontend.latency.record(time.perf_counter() - t0)
                    self._stream_sse(pair, uri)

            def _stream_sse(self, pair, uri):
                """Tail the request's token stream onto the socket as
                SSE.  A failed write means the client hung up: cancel
                the request so its KV blocks free NOW, not at the TTL
                prune."""
                inq, outq = pair
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.send_header("X-Request-Id", uri)
                self.end_headers()
                self.close_connection = True
                clean = False
                try:
                    self.wfile.write(sse_event("start", {"uri": uri}))
                    self.wfile.flush()
                    for ev in outq.stream_events(
                            uri, timeout=frontend.timeout):
                        if "ping" in ev:
                            # heartbeat: touches the socket so a dead
                            # client surfaces between tokens
                            self.wfile.write(b": ping\n\n")
                        elif "token" in ev:
                            self.wfile.write(sse_event(
                                "token", {"index": ev["index"],
                                          "token": ev["token"]}))
                        elif "restart" in ev:
                            # crash-recovery redispatch: the token
                            # index resets to 0 and the generation
                            # re-streams — the client must drop what
                            # it buffered, never splice
                            self.wfile.write(sse_event(
                                "restart",
                                {"uri": uri,
                                 "attempt": ev["restart"]}))
                        elif "done" in ev:
                            self.wfile.write(sse_event(
                                "done", {"uri": uri}))
                            clean = True
                        elif "cancelled" in ev:
                            self.wfile.write(sse_event(
                                "cancelled", {"uri": uri}))
                            clean = True
                        else:
                            err = ev.get("error", "")
                            # admission-time deadline sheds get their
                            # OWN terminal event so clients can
                            # distinguish "arrived too late" from a
                            # server-side failure without parsing text
                            kind = ("deadline_exceeded"
                                    if "deadline_exceeded" in err
                                    else "error")
                            self.wfile.write(sse_event(
                                kind, {"uri": uri, "error": err}))
                            clean = True
                        self.wfile.flush()
                        if clean:
                            break
                except (BrokenPipeError, ConnectionResetError,
                        OSError):
                    frontend._count_disconnect(uri)
                    try:
                        inq.cancel(uri)
                    except Exception:
                        logger.exception(
                            "disconnect cancel failed for %r", uri)
                except TimeoutError as e:
                    try:
                        self.wfile.write(sse_event(
                            "error", {"uri": uri, "error": str(e)}))
                        self.wfile.flush()
                    except OSError:
                        pass
                    clean = True
                if clean:
                    frontend._release(pair)
                else:
                    # abandoned mid-generator: the RESP read state is
                    # clean (each execute completed) but the token
                    # stream wasn't consumed — don't pool a pair whose
                    # tok: key may still receive events
                    pair[0].close()
                    pair[1].close()

        self._server = ThreadingHTTPServer(("0.0.0.0", http_port), Handler)
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            # handshake on first read (per-connection handler thread), not
            # inside accept() — a stalled client must not block the single
            # accept loop and with it every other request
            self._server.socket = ctx.wrap_socket(
                self._server.socket, server_side=True,
                do_handshake_on_connect=False)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ---- pooled queue clients -----------------------------------------

    def _acquire(self):
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        return (InputQueue(self.redis_host, self.redis_port,
                           max_backlog=self.max_backlog),
                OutputQueue(self.redis_host, self.redis_port))

    def _release(self, pair):
        with self._pool_lock:
            if len(self._pool) < self._pool_max:
                self._pool.append(pair)
                return
        pair[0].close()
        pair[1].close()

    def _predict(self, decoded, text_rows=None):
        # instances are decoded by the handler BEFORE enqueueing anything
        # (payload errors -> 400 without leaving orphaned work behind);
        # failures in here are backend-side by construction
        pair = self._acquire()
        inq, outq = pair
        try:
            uris = [inq.enqueue(str(uuid.uuid4()), **data)
                    for data in decoded]
            # one deadline for the whole request — per-uri waits share it
            # instead of compounding to n * timeout
            deadline = time.monotonic() + self.timeout
            preds = []
            for uri in uris:
                remaining = deadline - time.monotonic()
                r = outq.query(uri, timeout=max(0.0, remaining))
                if r is None:
                    raise TimeoutError(
                        f"result for {uri} not ready within "
                        f"{self.timeout}s")
                preds.append(np.asarray(r))
            out = []
            for i, p in enumerate(preds):
                if text_rows and i < len(text_rows) and text_rows[i]:
                    ids = p.astype(np.int64).ravel()
                    if self._eos_id is not None:
                        hits = np.nonzero(ids == self._eos_id)[0]
                        if hits.size:
                            ids = ids[:hits[0]]
                    out.append(self.tokenizer.decode(ids.tolist()))
                else:
                    out.append(p.tolist())
            preds = out
        except BaseException:
            # a failure may leave the RESP protocol state mid-message —
            # drop the pair rather than poisoning the pool
            pair[0].close()
            pair[1].close()
            raise
        else:
            self._release(pair)
            return preds

    # ---- front door (docs/serving_qos.md) -----------------------------

    def _generate_fields(self, req: dict):
        """/v1/generate JSON body -> input-queue fields.  Raises
        ``ValueError`` on anything payload-shaped (mapped to 400)."""
        body = dict(req)
        stream = bool(body.pop("stream", False))
        prompt = None
        if "text" in body:
            if self.tokenizer is None:
                raise ValueError("'text' needs the frontend started "
                                 "with tokenizer=...")
            if self.prompt_col in body:
                raise ValueError(
                    f"body carries BOTH 'text' and "
                    f"{self.prompt_col!r}: ambiguous prompt — send one")
            ids = np.asarray(
                self.tokenizer.encode(str(body.pop("text"))).ids,
                np.int32)
            if ids.size == 0:
                raise ValueError("text tokenized to zero tokens")
            prompt = ids
        elif self.prompt_col in body:
            prompt = np.asarray(
                _decode_value(body.pop(self.prompt_col)), np.int32)
        if prompt is None or prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"body needs 'text' or a 1-D {self.prompt_col!r} "
                f"token array")
        fields = {self.prompt_col: prompt}
        if "priority" in body:
            fields["priority"] = encode_priority(
                str(body.pop("priority")))
        if "tenant" in body:
            fields["tenant"] = encode_str_field(str(body.pop("tenant")))
        if "max_new" in body:
            fields["max_new"] = np.int32(int(body.pop("max_new")))
        if "temperature" in body:
            fields["temperature"] = np.float32(
                float(body.pop("temperature")))
        if "seed" in body:
            fields["seed"] = np.int64(int(body.pop("seed")))
        if "top_p" in body:
            fields["top_p"] = np.float32(float(body.pop("top_p")))
        if "prefix" in body:
            fields["prefix"] = np.int32(int(body.pop("prefix")))
        if stream:
            fields["stream"] = np.int32(1)
        if body:
            raise ValueError(
                f"unknown /v1/generate fields {sorted(body)}")
        return fields, stream

    def _generate_result(self, uri: str, tokens: np.ndarray) -> dict:
        out = {"uri": uri,
               "tokens": tokens.astype(np.int64).ravel().tolist()}
        if self.tokenizer is not None:
            ids = tokens.astype(np.int64).ravel()
            if self._eos_id is not None:
                hits = np.nonzero(ids == self._eos_id)[0]
                if hits.size:
                    ids = ids[:hits[0]]
            out["text"] = self.tokenizer.decode(ids.tolist())
        return out

    def _fleet_dead(self) -> bool:
        """True only when the attached serving job positively reports
        ZERO live pumps (``accepting_replicas() == 0``): detached
        frontends and micro-batch jobs (``None``) keep accepting —
        this guard is about not swallowing submits the router can
        never place."""
        if self.serving is None:
            return False
        try:
            return self.serving.accepting_replicas() == 0
        except Exception:
            return False

    def _retry_after(self, depth=None, level: int = 0) -> int:
        """Finite Retry-After for a 429: queue depth over the engine's
        recent completion throughput (frontdoor.retry_after_s clamps
        it, and the estimator falls back to a default rate, so the
        header is finite even on a cold or detached frontend).
        ``level`` is the brownout ladder level — the hint scales up
        monotonically with it, clamped finite at every level."""
        if depth is None and self.serving is not None:
            try:
                depth = self.serving.backlog()
            except Exception:
                depth = None
        if depth is None:
            depth = self.max_backlog
        if self.serving is not None:
            try:
                self._throughput.observe(
                    float(self.serving.telemetry.c_finished.value))
            except Exception:
                pass
        return retry_after_s(int(depth), self._throughput.rate(),
                             level=level)

    def _brownout_level(self) -> int:
        """The attached fleet's brownout ladder level (0 detached or
        when the controller is off)."""
        if self.serving is None:
            return 0
        try:
            return int(self.serving.brownout_level())
        except Exception:
            return 0

    def _deadline_ms(self, body_value, header_value):
        """Merge the ``deadline_ms`` body field and the
        ``X-Request-Deadline-Ms`` header into ONE validated relative
        budget (milliseconds), or None when neither was sent.  Raises
        ``ValueError`` (the 400 path) on anything invalid, or when
        both arrive and disagree — a split-brain deadline is a client
        bug, not a tiebreak."""
        vals = []
        if header_value is not None:
            vals.append(validate_deadline_ms(header_value))
        if body_value is not None:
            vals.append(validate_deadline_ms(body_value))
        if not vals:
            return None
        if len(vals) == 2 and vals[0] != vals[1]:
            raise ValueError(
                f"X-Request-Deadline-Ms header ({vals[0]}) and "
                f"deadline_ms body field ({vals[1]}) disagree — send "
                f"one, or the same value in both")
        return vals[0]

    def health(self) -> dict:
        """/healthz body: readiness for LOAD, not just liveness —
        admission-queue depth vs. cap, accepting/backpressure state,
        and the engine mode flags."""
        out = {"status": "ok", "accepting": True,
               "max_backlog": self.max_backlog}
        if self.serving is None:
            return out
        try:
            depth = int(self.serving.backlog())
        except Exception:
            depth = None
        accepting = (depth is None or not self.max_backlog
                     or depth < self.max_backlog)
        fleet_dead = self._fleet_dead()
        if fleet_dead:
            # zero live replicas beats any backlog arithmetic: the
            # fleet cannot place work at all until a pump returns
            accepting = False
        out.update({
            "backlog": depth,
            "accepting": accepting,
            "backpressure": not accepting,
            "engine": self.serving.mode_flags(),
        })
        if fleet_dead:
            out["live_replicas"] = 0
        lvl = self._brownout_level()
        out["brownout"] = {"level": lvl,
                           "admitting": list(brownout_classes(lvl))}
        wd = getattr(self.serving, "watchdog", None)
        if wd is not None:
            # the routing view of the SLO score: per-class goodput and
            # total breach counts (full detail lives at /debug/flight)
            st = wd.status()["per_class"]
            out["slo"] = {
                "goodput": {c: round(s["goodput"], 4)
                            for c, s in st.items()},
                "breaches": {c: sum(s["breaches"].values())
                             for c, s in st.items()},
            }
        if not accepting:
            out["retry_after_s"] = self._retry_after(depth)
        return out

    def _count_rejection(self) -> None:
        self.c_rejected.inc()
        if self.serving is not None:
            try:
                self.serving.telemetry.backpressure_rejection()
            except Exception:
                pass

    def _count_shed(self, priority: str) -> None:
        if self.serving is not None:
            try:
                self.serving.telemetry.brownout_shed(priority)
            except Exception:
                pass

    def _count_disconnect(self, uri: str) -> None:
        self.c_disconnects.inc()
        if self.serving is not None:
            try:
                self.serving.telemetry.stream_disconnect(uri)
            except Exception:
                pass

    # ---- lifecycle ----------------------------------------------------

    def start(self) -> "HttpFrontend":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        logger.info("HttpFrontend on :%d -> redis %s:%d", self.port,
                    self.redis_host, self.redis_port)
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ---- observability ------------------------------------------------

    def metrics(self) -> dict:
        """Legacy JSON metrics dict (``GET /metrics?format=json``)."""
        out = {"latency": self.latency.snapshot()}
        if self.serving is not None:
            out["serving"] = dict(self.serving.stats)
            try:
                out["backlog"] = self.serving.backlog()
            except Exception:
                out["backlog"] = None
        return out

    def _registries(self) -> list:
        regs = [self.registry]
        if self.serving is not None:
            tm = getattr(self.serving, "telemetry", None)
            if tm is not None:
                regs.append(tm.metrics)
            etm = getattr(getattr(self.serving, "engine", None),
                          "telemetry", None)
            if etm is not None and all(etm.metrics is not r
                                       for r in regs):
                regs.append(etm.metrics)
            # multi-replica: every replica's registry rides along; the
            # exposition dedupes by name (first registration wins), so
            # shared families keep replica 0's sample while the
            # zoo_router_*_r{r} families are per-replica by NAME
            for rtm in getattr(self.serving, "telemetries", ()) or ():
                if all(rtm.metrics is not r for r in regs):
                    regs.append(rtm.metrics)
        return regs

    def prometheus(self) -> str:
        """Text exposition over every reachable registry: the
        frontend's own HTTP latency, the serving job's request
        counters, and (continuous mode) the engine's TTFT/TPOT/queue/
        pool metrics.  Distinct name prefixes per layer mean the merge
        cannot collide."""
        return render_prometheus(*self._registries())

    def trace(self) -> Optional[dict]:
        """Chrome trace-event JSON from the nearest telemetry (engine
        first — its event ring holds the request spans), or None when
        the frontend runs without an attached serving job."""
        if self.serving is None:
            return None
        tm = getattr(getattr(self.serving, "engine", None),
                     "telemetry", None) \
            or getattr(self.serving, "telemetry", None)
        return tm.dump_trace() if tm is not None else None

    def debug_flight(self, last: int = 100) -> Optional[dict]:
        """``GET /debug/flight``: the live view of what a diagnostic
        bundle would capture — the flight ring's newest ``last`` tick
        records, the SLO watchdog's status, and the anomaly-bundle
        history.  None without an attached serving job."""
        if self.serving is None:
            return None
        fl = getattr(getattr(self.serving, "engine", None),
                     "flight", None) \
            or getattr(self.serving, "flight", None)
        out = {
            "capacity": fl.capacity if fl is not None else 0,
            "n_retained": len(fl) if fl is not None else 0,
            "ticks": fl.snapshot(last=last) if fl is not None else [],
        }
        wd = getattr(self.serving, "watchdog", None)
        if wd is not None:
            out["slo"] = wd.status()
        an = getattr(self.serving, "anomalies", None)
        if an is not None:
            out["anomalies"] = an.history()
        return out
