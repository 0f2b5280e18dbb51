"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the root of the checkout, at its first use,
then loaded with ``ctypes``.  A library is named after a hash of its
source, so an edited source builds anew; nothing here links against
PyTorch, which keeps a build to seconds.  ``nvcc``'s report (ptxas
registers, shared memory, spills) is kept beside each library as
``<library>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of each library's entry points: every pointer and the stream
# are c_void_p, so ctypes never cuts one to 32 bits
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "paged_attention": {
        "paged_attention_fwd": (_P, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _P),
    },
}


def _nvcc() -> str:
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    for cand in (cuda / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` per source, all started together.  Returns name -> path;
    raises with nvcc's output if any build fails."""
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


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    lib = ctypes.CDLL(str(build_all((name,))[name]))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib
