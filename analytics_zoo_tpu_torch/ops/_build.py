"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the root of the checkout, at its first use,
then loaded with ``ctypes``.  A library is named after a hash of its
source and the shared headers (``csrc/*.cuh``), so an edited source or
header builds anew; nothing here links against PyTorch, which keeps a
build to seconds.  ``nvcc``'s report (ptxas registers, shared memory,
spills) is kept beside each library as ``<library>.log``.

Building and loading are thread-safe: serving runs one pump thread per
engine replica, and the first launch of a kernel may come from several
at once.  One module lock covers build-and-load, so each library is
compiled once, by one thread of the process; the temporary file each
``nvcc`` writes is named after the process, which keeps processes
apart.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each library's entry points: every pointer and the stream
# are c_void_p, so ctypes never cuts one to 32 bits
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "paged_attention": {
        "paged_attention_splits": (_I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I),
        "paged_attention_fwd": (_P, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                                _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _P),
    },
    "flash_attention": {
        "flash_attention_fwd": (_P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _I, _I, _F, _P),
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _I, _I, _I, _I, _I, _I, _F, _P),
        "flash_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _F, _P),
        "flash_attention_bwd_delta": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
}
# one lock over build-and-load (re-entrant: ``load`` builds under it)
_LOCK = threading.RLock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    for cand in (cuda / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(name: str) -> Path:
    """Where library ``name`` is built: named after a hash of its source,
    the shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` per source, all started together.  Returns name -> path;
    raises with nvcc's output if any build fails."""
    with _LOCK:
        return _build_locked(names)


def _build_locked(names: Sequence[str]) -> Dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[n])     # atomic: a reader never sees half
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use (a dict
    read once it is loaded)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]
