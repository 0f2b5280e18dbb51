"""ctypes bindings for the native host data plane: a copy of
``analytics_zoo_tpu/native/__init__.py``.

``dataplane.cpp`` beside this file is the reference's source byte for
byte (a test holds the two equal).  It is host C++, not a device kernel:
``g++`` builds it on first use into ``libzoo_dataplane.so`` next to the
source (rebuilt when the source is newer), with JPEG/PNG decode
(``-DZOO_WITH_IMAGE -ljpeg -lpng``) where the host has libjpeg and
libpng, else without.  Exposed: ``RingBuffer`` (a bounded byte queue
whose blocking calls release the GIL), ``read_csv_native`` (a
multithreaded numeric CSV parser), ``decode_image``, ``RecordWriter``/
``RecordReader`` (the ZREC record file, read through mmap),
``Prefetcher`` (a C++ thread streaming records into a ring) and
``pack_batch``/``unpack_batch`` (the ZREC payload codec).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "dataplane.cpp")
_SO = os.path.join(_HERE, "libzoo_dataplane.so")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    """Raised when the .so cannot be built (no g++) — callers fall back."""


def _build_so() -> str:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    # PID-unique tmp + atomic replace: concurrent first-use builds (multiple
    # worker processes, shared FS) must not corrupt each other's output.
    tmp = f"{_SO}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
            _SRC, "-o", tmp]
    # image decode needs system libjpeg/libpng; retry without if absent so
    # the tensor data plane still builds on minimal hosts
    attempts = [base + ["-DZOO_WITH_IMAGE", "-ljpeg", "-lpng"], base]
    last_err = ""
    for cmd in attempts:
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, _SO)
            return _SO
        except FileNotFoundError as e:
            raise NativeUnavailable(f"g++ not found: {e}") from e
        except subprocess.CalledProcessError as e:
            last_err = e.stderr[-2000:]
    raise NativeUnavailable(f"native build failed:\n{last_err}")


def load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build_so())
        c = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_size_t
        P, L, I, S = c
        lib.zrb_create.restype = P
        lib.zrb_create.argtypes = [S, L]
        lib.zrb_destroy.argtypes = [P]
        lib.zrb_close.argtypes = [P]
        lib.zrb_push.restype = I
        lib.zrb_push.argtypes = [P, ctypes.c_void_p, S, I]
        lib.zrb_peek_len.restype = L
        lib.zrb_peek_len.argtypes = [P, I]
        lib.zrb_pop.restype = L
        lib.zrb_pop.argtypes = [P, ctypes.c_void_p, S, I]
        lib.zrb_depth.restype = L
        lib.zrb_depth.argtypes = [P]
        lib.zrb_bytes.restype = L
        lib.zrb_bytes.argtypes = [P]
        lib.zdp_last_error.restype = ctypes.c_char_p
        lib.zcsv_open.restype = P
        lib.zcsv_open.argtypes = [ctypes.c_char_p, I]
        lib.zcsv_nrows.restype = L
        lib.zcsv_nrows.argtypes = [P]
        lib.zcsv_ncols.restype = I
        lib.zcsv_ncols.argtypes = [P]
        lib.zcsv_col_name.restype = ctypes.c_char_p
        lib.zcsv_col_name.argtypes = [P, I]
        lib.zcsv_col_is_int.restype = I
        lib.zcsv_col_is_int.argtypes = [P, I]
        lib.zcsv_col_data.restype = ctypes.POINTER(ctypes.c_double)
        lib.zcsv_col_data.argtypes = [P, I]
        lib.zcsv_col_idata.restype = ctypes.POINTER(ctypes.c_int64)
        lib.zcsv_col_idata.argtypes = [P, I]
        lib.zcsv_close.argtypes = [P]
        lib.zrec_writer_open.restype = P
        lib.zrec_writer_open.argtypes = [ctypes.c_char_p]
        lib.zrec_write.restype = L
        lib.zrec_write.argtypes = [P, ctypes.c_void_p, S]
        lib.zrec_writer_close.restype = I
        lib.zrec_writer_close.argtypes = [P]
        lib.zrec_open.restype = P
        lib.zrec_open.argtypes = [ctypes.c_char_p]
        lib.zrec_count.restype = L
        lib.zrec_count.argtypes = [P]
        lib.zrec_len.restype = L
        lib.zrec_len.argtypes = [P, L]
        lib.zrec_ptr.restype = ctypes.c_void_p
        lib.zrec_ptr.argtypes = [P, L]
        lib.zrec_read.restype = L
        lib.zrec_read.argtypes = [P, L, ctypes.c_void_p, S]
        lib.zrec_close.argtypes = [P]
        lib.zpf_start.restype = P
        lib.zpf_start.argtypes = [P, P, ctypes.POINTER(ctypes.c_long), L, I]
        lib.zpf_stop.argtypes = [P]
        # image decode symbols are absent when the .so was built without
        # libjpeg/libpng (ZOO_WITH_IMAGE unset)
        try:
            lib.zimg_decode.restype = ctypes.POINTER(ctypes.c_ubyte)
            lib.zimg_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
            lib.zimg_decode_mem.restype = ctypes.POINTER(ctypes.c_ubyte)
            lib.zimg_decode_mem.argtypes = [
                ctypes.c_void_p, S, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
            lib.zimg_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        except AttributeError:
            pass
        _lib = lib
        return lib


def available() -> bool:
    try:
        load_lib()
        return True
    except NativeUnavailable:
        return False


def _err() -> str:
    return load_lib().zdp_last_error().decode()


# ---------------------------------------------------------------------------
# Ring buffer
# ---------------------------------------------------------------------------

class RingBuffer:
    """Bounded byte queue backed by the C++ condvar ring (single consumer)."""

    def __init__(self, capacity_bytes: int = 64 << 20, max_items: int = 0):
        self._lib = load_lib()
        self._h = self._lib.zrb_create(capacity_bytes, max_items)

    def push(self, data: bytes, timeout: float = -1) -> bool:
        rc = self._lib.zrb_push(self._h, data, len(data),
                                int(timeout * 1000) if timeout >= 0 else -1)
        if rc == -2:
            raise RuntimeError("ring buffer closed")
        if rc == -3:
            raise ValueError("item larger than ring capacity")
        return rc == 0

    def pop(self, timeout: float = -1) -> Optional[bytes]:
        """Next item, or None when the ring is closed and drained."""
        ms = int(timeout * 1000) if timeout >= 0 else -1
        while True:
            n = self._lib.zrb_peek_len(self._h, ms)
            if n == -2:
                return None
            if n == -1:
                raise TimeoutError("ring buffer pop timed out")
            buf = ctypes.create_string_buffer(int(n))
            got = self._lib.zrb_pop(self._h, buf, int(n), ms)
            if got == -2:
                return None
            if got == -3:
                continue  # a different (larger) item won the race; re-peek
            if got == -1:
                raise TimeoutError("ring buffer pop timed out")
            return buf.raw[:got]

    def close(self):
        self._lib.zrb_close(self._h)

    def depth(self) -> int:
        return self._lib.zrb_depth(self._h)

    def nbytes(self) -> int:
        return self._lib.zrb_bytes(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.zrb_destroy(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# CSV
# ---------------------------------------------------------------------------

def read_csv_native(path: str, n_threads: int = 0) -> Dict[str, np.ndarray]:
    """Parse an all-numeric CSV (header required) into column arrays.

    Column dtypes match pandas: int64 when every field is an integer
    literal, float64 otherwise (empty fields -> NaN force float64).
    Raises ValueError on non-numeric content or duplicate header names —
    callers (data.readers) fall back to pandas for those files.
    """
    lib = load_lib()
    h = lib.zcsv_open(os.fspath(path).encode(), n_threads)
    if not h:
        raise ValueError(f"native csv parse failed for {path}: {_err()}")
    try:
        nrows = lib.zcsv_nrows(h)
        ncols = lib.zcsv_ncols(h)
        names = [lib.zcsv_col_name(h, i).decode() for i in range(ncols)]
        if len(set(names)) != ncols:
            raise ValueError(
                f"duplicate column names in {path}: {names} "
                "(pandas fallback handles de-duplication)")
        out: Dict[str, np.ndarray] = {}
        for i, name in enumerate(names):
            if lib.zcsv_col_is_int(h, i):
                ptr, dt = lib.zcsv_col_idata(h, i), np.int64
            else:
                ptr, dt = lib.zcsv_col_data(h, i), np.float64
            if nrows:
                out[name] = np.ctypeslib.as_array(ptr, shape=(nrows,)).copy()
            else:
                out[name] = np.empty(0, dt)
        return out
    finally:
        lib.zcsv_close(h)


# ---------------------------------------------------------------------------
# Image decode (SURVEY §2.3 native obligation: host-side C++ decode)
# ---------------------------------------------------------------------------

def image_available() -> bool:
    """True when the .so was built with libjpeg/libpng support."""
    try:
        return hasattr(load_lib(), "zimg_decode")
    except NativeUnavailable:
        return False


def decode_image(path_or_bytes) -> np.ndarray:
    """Decode a JPEG/PNG to an RGB uint8 HWC array via the C++ data plane.

    The decode runs with the GIL released (ctypes), so threading over
    files gives real parallelism — the Spark-partition-decode analog.
    Raises ValueError on undecodable input, NativeUnavailable when the
    library lacks image support (callers fall back to PIL).
    """
    lib = load_lib()
    if not hasattr(lib, "zimg_decode"):
        raise NativeUnavailable("built without libjpeg/libpng")
    h = ctypes.c_long()
    w = ctypes.c_long()
    c = ctypes.c_int()
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        buf = bytes(path_or_bytes)
        ptr = lib.zimg_decode_mem(buf, len(buf),
                                  ctypes.byref(h), ctypes.byref(w),
                                  ctypes.byref(c))
    else:
        ptr = lib.zimg_decode(os.fspath(path_or_bytes).encode(),
                              ctypes.byref(h), ctypes.byref(w),
                              ctypes.byref(c))
    if not ptr:
        raise ValueError(f"native image decode failed: {_err()}")
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        return arr.reshape(h.value, w.value, c.value)
    finally:
        lib.zimg_free(ptr)


# ---------------------------------------------------------------------------
# Record store
# ---------------------------------------------------------------------------

class RecordWriter:
    def __init__(self, path: str):
        self._lib = load_lib()
        self._h = self._lib.zrec_writer_open(os.fspath(path).encode())
        if not self._h:
            raise IOError(_err())

    def write(self, data: bytes) -> int:
        idx = self._lib.zrec_write(self._h, data, len(data))
        if idx < 0:
            raise IOError(_err())
        return idx

    def close(self):
        if self._h:
            if self._lib.zrec_writer_close(self._h) != 0:
                self._h = None
                raise IOError(_err())
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    def __init__(self, path: str):
        self._lib = load_lib()
        self._h = self._lib.zrec_open(os.fspath(path).encode())
        if not self._h:
            raise IOError(_err())

    def __len__(self) -> int:
        return self._lib.zrec_count(self._h)

    def get(self, i: int) -> memoryview:
        """Zero-copy view into the mmap'd file (valid until close)."""
        n = self._lib.zrec_len(self._h, i)
        if n < 0:
            raise IndexError(i)
        ptr = self._lib.zrec_ptr(self._h, i)
        return memoryview((ctypes.c_char * n).from_address(ptr)) \
            if n else memoryview(b"")

    def get_bytes(self, i: int) -> bytes:
        return bytes(self.get(i))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.zrec_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class Prefetcher:
    """C++ reader thread streaming records (given order) into a RingBuffer."""

    def __init__(self, reader: RecordReader, ring: RingBuffer,
                 order: Sequence[int], loop: bool = False):
        self._lib = load_lib()
        self._reader = reader   # keep alive
        self._ring = ring
        arr = (ctypes.c_long * len(order))(*order)
        self._h = self._lib.zpf_start(reader._h, ring._h, arr, len(order),
                                      1 if loop else 0)

    def stop(self):
        if getattr(self, "_h", None):
            self._lib.zpf_stop(self._h)
            self._h = None

    def __del__(self):
        self.stop()


# ---------------------------------------------------------------------------
# Tensor-dict <-> bytes codec (ZREC payload format)
# ---------------------------------------------------------------------------
# record := u32 n_arrays | n_arrays * [u16 name_len | name_utf8 |
#           u8 dtype_code_len | dtype_str | u8 ndim | u64*ndim shape |
#           u64 nbytes | raw little-endian bytes]

def pack_batch(batch: Dict[str, np.ndarray]) -> bytes:
    parts: List[bytes] = [struct.pack("<I", len(batch))]
    for name, a in batch.items():
        a = np.ascontiguousarray(a)
        nb = name.encode()
        dt = a.dtype.str.encode()  # e.g. b'<f4'
        parts.append(struct.pack("<H", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<B", len(dt)))
        parts.append(dt)
        parts.append(struct.pack("<B", a.ndim))
        parts.append(struct.pack(f"<{a.ndim}Q", *a.shape) if a.ndim else b"")
        raw = a.tobytes()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def peek_batch_rows(data) -> int:
    """Row count (first array's leading dim) of a packed batch, reading only
    the first header — no array payload is copied, so scanning every block
    of a mmap'd ZREC file at open is cheap."""
    mv = memoryview(data)
    (n,) = struct.unpack_from("<I", mv, 0)
    if not n:
        return 0
    off = 4
    (nlen,) = struct.unpack_from("<H", mv, off); off += 2 + nlen
    (dlen,) = struct.unpack_from("<B", mv, off); off += 1 + dlen
    (ndim,) = struct.unpack_from("<B", mv, off); off += 1
    if not ndim:
        return 1
    (rows,) = struct.unpack_from("<Q", mv, off)
    return rows


def unpack_batch(data) -> Dict[str, np.ndarray]:
    mv = memoryview(data)
    (n,) = struct.unpack_from("<I", mv, 0)
    off = 4
    out: Dict[str, np.ndarray] = {}
    for _ in range(n):
        (nlen,) = struct.unpack_from("<H", mv, off); off += 2
        name = bytes(mv[off:off + nlen]).decode(); off += nlen
        (dlen,) = struct.unpack_from("<B", mv, off); off += 1
        dt = bytes(mv[off:off + dlen]).decode(); off += dlen
        (ndim,) = struct.unpack_from("<B", mv, off); off += 1
        shape = struct.unpack_from(f"<{ndim}Q", mv, off) if ndim else ()
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", mv, off); off += 8
        a = np.frombuffer(mv[off:off + nbytes], dtype=dt).reshape(shape)
        off += nbytes
        out[name] = a.copy()  # own the memory (mv may be ring-buffer scratch)
    return out
