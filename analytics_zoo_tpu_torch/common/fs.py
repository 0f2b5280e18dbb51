"""Scheme-dispatch filesystem layer: a copy of
``analytics_zoo_tpu/common/fs.py``.

Plain local paths go to ``os``/``builtins.open`` and keep the native fast
paths (the C++ CSV parser, the mmap ZREC reader); ``scheme://`` URIs
(``gs://``, ``s3://``, ``hdfs://``, ``file://``, ``memory://``) go through
``fsspec``, imported only when such a URI is used, and a missing driver
raises at first use rather than reading nothing.  ``local_copy``
materialises a remote file in a per-process cache for the native
readers; ``upload`` pushes a locally written file out.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import List, Optional, Tuple

_SCHEME = re.compile(r"^[A-Za-z][A-Za-z0-9+.-]*://")


def is_remote(path) -> bool:
    """True for scheme:// URIs (gs://, s3://, hdfs://, memory://, ...).

    ``file://`` counts as remote-syntax (routed through fsspec, which
    resolves it locally) so that URI-shaped config values behave
    uniformly. Windows drive letters can't false-positive: ``C:/`` has
    no ``//``."""
    return isinstance(path, str) and _SCHEME.match(path) is not None


def _fs_for(path: str):
    """fsspec filesystem for a URI. Loud ImportError (with fsspec's
    install hint) when the scheme's driver isn't in the image."""
    import fsspec

    scheme = path.split("://", 1)[0]
    try:
        return fsspec.filesystem(scheme)
    except (ImportError, OSError) as e:
        # ImportError: driver package absent (s3fs, adlfs, ...);
        # OSError: driver present but its native dep is (hdfs→libjvm).
        # Either way: loud, with the fix named — never a local fallback.
        raise ImportError(
            f"accessing {path!r} needs a working fsspec driver for "
            f"{scheme!r}: {e}") from e


def open(path: str, mode: str = "rb"):  # noqa: A001 - deliberate shadow
    """Open local path or remote URI for streaming IO."""
    if not is_remote(path):
        import builtins

        return builtins.open(path, mode)
    import fsspec

    return fsspec.open(path, mode).open()


def exists(path: str) -> bool:
    if not is_remote(path):
        return os.path.exists(path)
    return _fs_for(path).exists(path)


def isdir(path: str) -> bool:
    if not is_remote(path):
        return os.path.isdir(path)
    return _fs_for(path).isdir(path)


def makedirs(path: str, exist_ok: bool = True) -> None:
    if not is_remote(path):
        os.makedirs(path, exist_ok=exist_ok)
        return
    _fs_for(path).makedirs(path, exist_ok=exist_ok)


def _with_scheme(fs, paths: List[str]) -> List[str]:
    """fsspec strips the scheme from listing results; put it back so
    every path in the pipeline stays openable by plain ``fs_open``."""
    return [fs.unstrip_protocol(p) for p in paths]


def listdir(path: str) -> List[str]:
    """Names (not full paths) of entries directly under a directory."""
    if not is_remote(path):
        return sorted(os.listdir(path))
    fs = _fs_for(path)
    return sorted(p.rstrip("/").rsplit("/", 1)[-1]
                  for p in fs.ls(path, detail=False))


def glob(pattern: str) -> List[str]:
    """Expand a glob; remote results keep their scheme prefix."""
    if not is_remote(pattern):
        import glob as _glob

        return sorted(_glob.glob(pattern))
    fs = _fs_for(pattern)
    return sorted(_with_scheme(fs, fs.glob(pattern)))


def walk(path: str) -> List[Tuple[str, List[str], List[str]]]:
    """os.walk-shaped traversal (root, dirnames, filenames), sorted."""
    if not is_remote(path):
        return sorted(os.walk(path))
    fs = _fs_for(path)
    out = []
    for root, dirs, files in fs.walk(path):
        out.append((fs.unstrip_protocol(root), sorted(dirs), sorted(files)))
    return sorted(out)


def join(base: str, *parts: str) -> str:
    """Path join that keeps remote URIs forward-slashed."""
    if not is_remote(base):
        return os.path.join(base, *parts)
    return "/".join([base.rstrip("/"), *[p.strip("/") for p in parts]])


_CACHE_DIR: Optional[str] = None


def _cache_dir() -> str:
    global _CACHE_DIR
    if _CACHE_DIR is None:
        _CACHE_DIR = tempfile.mkdtemp(prefix="zoo_fs_cache_")
    return _CACHE_DIR


def local_copy(path: str) -> str:
    """A real local file for native readers (mmap / C stdio).

    Local paths return unchanged (zero copies — the fast path stays
    fast).  Remote URIs download once into a per-process cache keyed by
    the full URI; repeated opens of the same URI reuse the copy."""
    if not is_remote(path):
        return path
    dst = _cache_key_path(path)
    if not os.path.exists(dst):
        fs = _fs_for(path)
        tmp = dst + ".part"
        fs.get_file(path, tmp)
        os.replace(tmp, dst)    # atomic: concurrent readers never see a
        #                         truncated download
    return dst


def _cache_key_path(path: str) -> str:
    import hashlib

    key = hashlib.blake2b(path.encode(), digest_size=10).hexdigest()
    return os.path.join(_cache_dir(), f"{key}_{path.rsplit('/', 1)[-1]}")


def prime_cache(local_path: str, remote_path: str) -> None:
    """Record ``local_path`` as the cached copy of ``remote_path`` so a
    writer that just uploaded an artifact doesn't immediately re-download
    it through ``local_copy``."""
    if not is_remote(remote_path):
        return
    dst = _cache_key_path(remote_path)
    if os.path.abspath(local_path) != os.path.abspath(dst):
        # same atomicity contract as local_copy: a concurrent reader that
        # sees dst exist must never see a partial copy
        shutil.copyfile(local_path, dst + ".part")
        os.replace(dst + ".part", dst)


def upload(local_path: str, remote_path: str) -> None:
    """Push a locally-written artifact to its remote destination."""
    if not is_remote(remote_path):
        if os.path.abspath(local_path) != os.path.abspath(remote_path):
            shutil.copyfile(local_path, remote_path)
        return
    fs = _fs_for(remote_path)
    parent = remote_path.rsplit("/", 1)[0]
    if parent and parent != remote_path:
        try:
            fs.makedirs(parent, exist_ok=True)
        except Exception:
            pass        # object stores have no real directories
    fs.put_file(local_path, remote_path)
