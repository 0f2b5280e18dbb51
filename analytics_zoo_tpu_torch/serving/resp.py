"""Minimal Redis-protocol (RESP2) server and client: the broker Cluster
Serving's clients and workers talk through.

A copy of ``analytics_zoo_tpu/serving/resp.py`` (stdlib only).  The
embedded server implements the command subset the serving stack uses
(PING, the X* stream commands, hashes, GET/SET, FLUSHDB); a real
``redis-server`` can take its place, since the client speaks standard
RESP.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# RESP2 encoding
# ---------------------------------------------------------------------------

def encode(obj) -> bytes:
    """Python -> RESP2: bytes/str -> bulk, int -> integer, list -> array,
    None -> null bulk, Exception -> error, bool ok-marker via _OK."""
    if obj is None:
        return b"$-1\r\n"
    if isinstance(obj, _OK):
        return b"+" + obj.msg.encode() + b"\r\n"
    if isinstance(obj, Exception):
        return b"-ERR " + str(obj).encode() + b"\r\n"
    if isinstance(obj, bool):
        return encode(int(obj))
    if isinstance(obj, int):
        return b":" + str(obj).encode() + b"\r\n"
    if isinstance(obj, str):
        obj = obj.encode()
    if isinstance(obj, (bytes, bytearray)):
        return b"$" + str(len(obj)).encode() + b"\r\n" + bytes(obj) + b"\r\n"
    if isinstance(obj, (list, tuple)):
        out = b"*" + str(len(obj)).encode() + b"\r\n"
        return out + b"".join(encode(x) for x in obj)
    raise TypeError(f"cannot RESP-encode {type(obj)}")


class _OK:
    def __init__(self, msg: str = "OK"):
        self.msg = msg


class _Reader:
    """Buffered RESP2 parser over a socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def _read_until(self, n: Optional[int] = None) -> bytes:
        if n is None:  # read a \r\n-terminated line
            while b"\r\n" not in self.buf:
                chunk = self.sock.recv(65536)
                if not chunk:
                    raise ConnectionError("peer closed")
                self.buf += chunk
            line, self.buf = self.buf.split(b"\r\n", 1)
            return line
        while len(self.buf) < n + 2:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("peer closed")
            self.buf += chunk
        data, self.buf = self.buf[:n], self.buf[n + 2:]
        return data

    def read(self):
        line = self._read_until()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RedisError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            return None if n == -1 else self._read_until(n)
        if t == b"*":
            n = int(rest)
            return None if n == -1 else [self.read() for _ in range(n)]
        raise ValueError(f"bad RESP type byte {t!r}")


class RedisError(Exception):
    pass


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class Stream:
    def __init__(self):
        self.entries: List[Tuple[bytes, List[bytes]]] = []  # (id, kv flat)
        self.seq = itertools.count(1)
        self.cond = threading.Condition()
        # consumer groups: name -> {"last": delivered-up-to id,
        #                           "pending": {id: consumer}}
        # (the mechanism behind horizontally-scaled serving workers —
        # ref: Flink source parallelism over XREADGROUP)
        self.groups: Dict[bytes, Dict] = {}

    def add(self, fields: List[bytes]) -> bytes:
        eid = f"{int(time.time() * 1000)}-{next(self.seq)}".encode()
        with self.cond:
            self.entries.append((eid, fields))
            self.cond.notify_all()
        return eid


def _id_after(eid: bytes, last: bytes) -> bool:
    def parse(x: bytes):
        a, _, b = x.partition(b"-")
        return (int(a), int(b or 0))
    return parse(eid) > parse(last)


def _range_bound(x: bytes, *, high: bool) -> Tuple[int, int]:
    """Parse an XRANGE start/end bound: '-'/'+' sentinels, and a bare
    ms timestamp means seq 0 at the start bound / seq max at the end
    bound (Redis semantics — both bounds are inclusive)."""
    if x == b"-":
        return (0, 0)
    if x == b"+":
        return (1 << 63, 1 << 63)
    a, dash, b = x.partition(b"-")
    if dash:
        return (int(a), int(b))
    return (int(a), (1 << 63) if high else 0)


def _scan_read_opts(args: List[bytes], i: int):
    """Parse [COUNT c] [BLOCK ms] up to STREAMS; returns (count, block_ms,
    index-of-STREAMS) — shared by XREAD and XREADGROUP."""
    count, block_ms = None, None
    while args[i].upper() != b"STREAMS":
        if args[i].upper() == b"COUNT":
            count = int(args[i + 1])
        elif args[i].upper() == b"BLOCK":
            block_ms = int(args[i + 1])
        i += 2
    return count, block_ms, i


def _await_fresh(s: "Stream", block_ms, select):
    """Run `select()` under s.cond until it yields entries or the block
    window expires.  select() may mutate claim state (XREADGROUP) — it is
    always called with the stream lock held, so claims are atomic."""
    deadline = None if block_ms is None else \
        time.monotonic() + block_ms / 1000.0
    while True:
        with s.cond:
            got = select()
            if got:
                return got
            if deadline is None:
                return None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            s.cond.wait(remaining)


class RespServer:
    """In-process broker. start() binds 127.0.0.1:port (0 = ephemeral)."""

    def __init__(self, port: int = 0):
        self.port = port
        self.streams: Dict[bytes, Stream] = {}
        self.hashes: Dict[bytes, Dict[bytes, bytes]] = {}
        self.kv: Dict[bytes, bytes] = {}
        self.sets: Dict[bytes, set] = {}
        self.lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()

    # ---- lifecycle ----------------------------------------------------

    def start(self) -> "RespServer":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self

    def stop(self):
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # small request/response frames: Nagle + delayed-ACK would add
            # a delay per reply that would dwarf the model forward itself
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        reader = _Reader(conn)
        try:
            while not self._stop.is_set():
                req = reader.read()
                if req is None:
                    return
                try:
                    resp = self._dispatch([bytes(x) if isinstance(
                        x, (bytes, bytearray)) else str(x).encode()
                        for x in req])
                except RedisError as e:
                    resp = e
                except Exception as e:  # command bug -> error reply
                    resp = RedisError(str(e))
                conn.sendall(encode(resp))
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    # ---- commands -----------------------------------------------------

    def _stream(self, key: bytes) -> Stream:
        with self.lock:
            if key not in self.streams:
                self.streams[key] = Stream()
            return self.streams[key]

    def _dispatch(self, args: List[bytes]):
        cmd = args[0].upper()
        if cmd == b"PING":
            return _OK("PONG")
        if cmd == b"FLUSHDB":
            with self.lock:
                self.streams.clear()
                self.hashes.clear()
                self.kv.clear()
                self.sets.clear()
            return _OK()
        if cmd == b"SET":
            self.kv[args[1]] = args[2]
            return _OK()
        if cmd == b"GET":
            return self.kv.get(args[1])
        if cmd == b"DEL":
            n = 0
            with self.lock:
                for k in args[1:]:
                    n += (self.kv.pop(k, None) is not None) + \
                        (self.hashes.pop(k, None) is not None) + \
                        (self.streams.pop(k, None) is not None) + \
                        (self.sets.pop(k, None) is not None)
            return n
        if cmd == b"SADD":
            with self.lock:
                s = self.sets.setdefault(args[1], set())
                before = len(s)
                s.update(args[2:])
                return len(s) - before
        if cmd == b"SREM":
            with self.lock:
                s = self.sets.get(args[1], set())
                before = len(s)
                s.difference_update(args[2:])
                return before - len(s)
        if cmd == b"SMEMBERS":
            with self.lock:
                return sorted(self.sets.get(args[1], set()))
        if cmd == b"SCARD":
            with self.lock:
                return len(self.sets.get(args[1], set()))
        if cmd == b"HSET":
            h = self.hashes.setdefault(args[1], {})
            kvs = args[2:]
            added = 0
            for i in range(0, len(kvs), 2):
                added += kvs[i] not in h
                h[kvs[i]] = kvs[i + 1]
            return added
        if cmd == b"HGETALL":
            h = self.hashes.get(args[1], {})
            out: List[bytes] = []
            for k, v in h.items():
                out.extend([k, v])
            return out
        if cmd == b"XADD":
            # XADD key [MAXLEN n] id field value ...
            i = 2
            if args[i].upper() == b"MAXLEN":
                i += 2
            i += 1  # the id (we always auto-assign '*' semantics)
            return self._stream(args[1]).add(list(args[i:]))
        if cmd == b"XLEN":
            return len(self._stream(args[1]).entries)
        if cmd == b"XRANGE":
            # XRANGE key start end [COUNT n] — inclusive id range; the
            # router leans on exact-id lookups (`XRANGE k eid eid`) to
            # re-read a dead replica's in-flight entries, so honouring
            # the bounds is correctness-critical, not a nicety.
            s = self._stream(args[1])
            lo = _range_bound(args[2], high=False)
            hi = _range_bound(args[3], high=True)
            count = int(args[5]) if len(args) > 5 and \
                args[4].upper() == b"COUNT" else None

            def _pid(eid: bytes) -> Tuple[int, int]:
                a, _, b = eid.partition(b"-")
                return (int(a), int(b or 0))
            with s.cond:
                got = [[eid, fv] for eid, fv in s.entries
                       if lo <= _pid(eid) <= hi]
            return got[:count] if count else got
        if cmd == b"XDEL":
            s = self._stream(args[1])
            ids = set(args[2:])
            with s.cond:
                before = len(s.entries)
                s.entries = [e for e in s.entries if e[0] not in ids]
                return before - len(s.entries)
        if cmd == b"XTRIM":
            s = self._stream(args[1])
            # XTRIM key MAXLEN n
            n = int(args[3])
            with s.cond:
                cut = max(0, len(s.entries) - n)
                s.entries = s.entries[cut:]
                return cut
        if cmd == b"XREAD":
            # XREAD [COUNT c] [BLOCK ms] STREAMS key id
            count, block_ms, i = _scan_read_opts(args, 1)
            key, last = args[i + 1], args[i + 2]
            s = self._stream(key)
            if last == b"$":
                with s.cond:
                    last = s.entries[-1][0] if s.entries else b"0-0"

            def select():
                fresh = [e for e in s.entries if _id_after(e[0], last)]
                return fresh[:count] if count else fresh

            got = _await_fresh(s, block_ms, select)
            if got is None:
                return None
            return [[key, [[eid, fv] for eid, fv in got]]]
        if cmd == b"XGROUP":
            # XGROUP CREATE key group id [MKSTREAM]
            if args[1].upper() != b"CREATE":
                raise RedisError("only XGROUP CREATE is supported")
            s = self._stream(args[2])
            start = args[4]
            with s.cond:
                if args[3] in s.groups:
                    raise RedisError("BUSYGROUP Consumer Group name "
                                     "already exists")
                if start == b"$":
                    start = s.entries[-1][0] if s.entries else b"0-0"
                s.groups[args[3]] = {"last": start, "pending": {}}
            return _OK()
        if cmd == b"XREADGROUP":
            # XREADGROUP GROUP g consumer [COUNT c] [BLOCK ms] STREAMS key >
            group, consumer = args[2], args[3]
            count, block_ms, i = _scan_read_opts(args, 4)
            key, cursor = args[i + 1], args[i + 2]
            if cursor != b">":
                raise RedisError("only the '>' cursor is supported")
            s = self._stream(key)
            with s.cond:
                if group not in s.groups:
                    raise RedisError(
                        f"NOGROUP no such consumer group {group.decode()}")

            def select():
                # atomic claim under s.cond (held by _await_fresh):
                # advance the group pointer so no other consumer sees these
                g = s.groups.get(group)
                if g is None:
                    return None
                fresh = [e for e in s.entries
                         if _id_after(e[0], g["last"])]
                if not fresh:
                    return None
                if count:
                    fresh = fresh[:count]
                g["last"] = fresh[-1][0]
                for eid, _ in fresh:
                    g["pending"][eid] = consumer
                return fresh

            got = _await_fresh(s, block_ms, select)
            if got is None:
                return None
            return [[key, [[eid, fv] for eid, fv in got]]]
        if cmd == b"XACK":
            # XACK key group id [id ...]
            s = self._stream(args[1])
            with s.cond:
                g = s.groups.get(args[2])
                if g is None:
                    return 0
                n = 0
                for eid in args[3:]:
                    n += g["pending"].pop(eid, None) is not None
                return n
        if cmd == b"XPENDING":
            # XPENDING key group -> [count, min-id, max-id, consumers]
            s = self._stream(args[1])
            with s.cond:
                g = s.groups.get(args[2])
                if g is None:
                    return [0, None, None, None]
                ids = sorted(g["pending"])
                return [len(ids), ids[0] if ids else None,
                        ids[-1] if ids else None, None]
        raise RedisError(f"unknown command {cmd.decode()}")


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class RespClient:
    """Tiny RESP2 client (drop-in for redis-py's execute_command subset);
    thread-safe via a per-call lock."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.reader = _Reader(self.sock)
        self.lock = threading.Lock()

    def execute(self, *args):
        payload = encode([a if isinstance(a, (bytes, bytearray))
                          else str(a).encode() for a in args])
        with self.lock:
            self.sock.sendall(payload)
            return self.reader.read()

    def pipeline(self, commands):
        """Send many commands in one write, read all replies (real Redis
        pipelining — one round-trip for N commands).

        Every reply is consumed even when some are errors — bailing out
        mid-stream would leave unread replies in the buffer and desync
        every later command on this connection.  The first error reply is
        raised after the stream is drained."""
        payload = b"".join(
            encode([a if isinstance(a, (bytes, bytearray))
                    else str(a).encode() for a in cmd])
            for cmd in commands)
        with self.lock:
            self.sock.sendall(payload)
            replies, first_err = [], None
            for _ in commands:
                try:
                    replies.append(self.reader.read())
                except RedisError as e:   # error reply: keep draining
                    replies.append(e)
                    first_err = first_err or e
        if first_err is not None:
            raise first_err
        return replies

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
