"""The kernel build and load of the port under concurrent first use.

Serving runs one pump thread per engine replica, and the first launch
of a kernel may come from several threads at once.  A fake ``nvcc`` on
``CUDA_HOME`` (a shell script that sleeps, counts its runs and writes
its ``-o`` file) stands in for the CUDA compiler, so this runs on the
CPU: eight threads build at once and every one gets the library from a
single build.
"""

import ctypes
import os
import stat
import sys
import threading

import pytest

from analytics_zoo_tpu_torch.ops import _build


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    count = tmp_path / "runs"
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> '{count}'\n"
        "sleep 0.3\n"
        "out=''\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=\"$2\"; fi\n"
        "  shift\n"
        "done\n"
        "echo built > \"$out\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    return count


def _run_threads(fn, n=8):
    """``fn`` from ``n`` threads released together, with a short switch
    interval so the threads interleave inside the build."""
    results, errors = [], []
    barrier = threading.Barrier(n)

    def one():
        barrier.wait()
        try:
            results.append(fn())
        except Exception as e:      # collected, asserted below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def test_concurrent_build_all_builds_once(fake_nvcc):
    results, errors = _run_threads(lambda: _build.build_all(
        ("paged_attention",)))
    assert not errors, errors
    assert len(results) == 8
    path = _build.library_path("paged_attention")
    assert all(r == {"paged_attention": path} for r in results)
    assert path.read_text() == "built\n"
    assert fake_nvcc.read_text().count("run") == 1
    # no temporary file is left behind
    assert sorted(p.name for p in path.parent.iterdir()) == sorted(
        [path.name, path.with_suffix(".log").name])


def test_concurrent_load_builds_and_binds_once(fake_nvcc, monkeypatch):
    opened = []

    class FakeLib:
        def __init__(self, path):
            opened.append(path)

        def __getattr__(self, fn):
            f = type("Fn", (), {})()
            setattr(self, fn, f)
            return f

    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    results, errors = _run_threads(lambda: _build.load("flash_attention"))
    assert not errors, errors
    assert len({id(r) for r in results}) == 1
    assert len(opened) == 1
    assert fake_nvcc.read_text().count("run") == 1
    lib = results[0]
    for fn, argtypes in _build.SIGNATURES["flash_attention"].items():
        assert getattr(lib, fn).argtypes == list(argtypes)
        assert getattr(lib, fn).restype is ctypes.c_int
    assert os.path.exists(_build.library_path("flash_attention"))
