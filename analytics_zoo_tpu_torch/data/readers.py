"""File readers into ``XShards``: a copy of
``analytics_zoo_tpu/data/readers.py``.

``read_csv``, ``read_json`` and ``read_parquet`` take a path, a
directory, a glob or a list of them (local, or a URI through
``common.fs``), read each file into a pandas DataFrame (pandas is
imported when a file is read; numeric CSVs parse through the native
C++ reader first) and return one shard a file.  Files split over the
processes of the process group round-robin by sorted path (rank ``i``
reads files ``i, i + n, ...``; one process reads them all).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from analytics_zoo_tpu_torch.common import fs
from analytics_zoo_tpu_torch.common.context import (
    effective_process_count as _nhosts,
    effective_process_index as _hidx)
from analytics_zoo_tpu_torch.data.shards import XShards


def _expand(path_or_glob) -> List[str]:
    if isinstance(path_or_glob, (list, tuple)):
        out: List[str] = []
        for p in path_or_glob:
            out.extend(_expand(p))
        return sorted(set(out))
    if fs.isdir(path_or_glob):
        return sorted(
            fs.join(path_or_glob, f) for f in fs.listdir(path_or_glob)
            if not f.startswith(("_", ".")))
    matches = fs.glob(path_or_glob)
    if not matches and fs.exists(path_or_glob):
        matches = [path_or_glob]
    if not matches:
        raise FileNotFoundError(f"no files match {path_or_glob!r}")
    return matches


def _host_slice(files: List[str], host_index: Optional[int],
                num_hosts: Optional[int]) -> List[str]:
    hi = _hidx() if host_index is None else host_index
    nh = _nhosts() if num_hosts is None else num_hosts
    # Hosts beyond len(files) naturally get an empty list — never duplicate
    # a file across hosts.
    return files[hi::nh]


def _read_files(reader: Callable, path, shards_per_host, host_index,
                num_hosts, **kwargs) -> XShards:
    files = _expand(path)
    mine = _host_slice(files, host_index, num_hosts)
    shards = [reader(f, **kwargs) for f in mine]
    xs = XShards(
        shards,
        num_hosts=_nhosts() if num_hosts is None else num_hosts,
        host_index=_hidx() if host_index is None else host_index)
    if shards_per_host and shards:
        xs = xs.repartition(shards_per_host)
    return xs


def _read_csv_one(path, backend: str = "auto", **pandas_kwargs):
    """One CSV file -> pandas DataFrame.

    backend="native" uses the C++ multithreaded parser (numeric CSVs only;
    the Spark-parallel-ingest replacement — SURVEY.md §2.2); "pandas" always
    uses pandas; "auto" tries native and falls back on non-numeric content,
    pandas-specific kwargs, or a missing toolchain.
    """
    import pandas as pd

    if backend == "native" and pandas_kwargs:
        raise ValueError(
            f"backend='native' does not accept pandas kwargs "
            f"{sorted(pandas_kwargs)}; use backend='pandas' or 'auto'")
    if backend != "pandas" and not pandas_kwargs:
        try:
            from analytics_zoo_tpu_torch import native

            # remote URIs materialise through the per-process cache —
            # the C++ parser wants a real file (and a numeric-CSV
            # download is usually cheaper than row-wise remote reads)
            return pd.DataFrame(native.read_csv_native(fs.local_copy(path)))
        except Exception:
            if backend == "native":
                raise
    # pandas resolves fsspec URIs (gs://, s3://, memory://) natively —
    # but if the native attempt above already downloaded the file, parse
    # the cached copy instead of paying the transfer twice
    if fs.is_remote(path) and backend != "pandas" and not pandas_kwargs:
        path = fs.local_copy(path)
    return pd.read_csv(path, **pandas_kwargs)


def read_csv(path, shards_per_host: Optional[int] = None, *,
             host_index: Optional[int] = None,
             num_hosts: Optional[int] = None, backend: str = "auto",
             **pandas_kwargs) -> XShards:
    """ref-parity: zoo.orca.data.pandas.read_csv."""
    return _read_files(_read_csv_one, path, shards_per_host, host_index,
                       num_hosts, backend=backend, **pandas_kwargs)


def read_json(path, shards_per_host: Optional[int] = None, *,
              host_index: Optional[int] = None,
              num_hosts: Optional[int] = None, **pandas_kwargs) -> XShards:
    """ref-parity: zoo.orca.data.pandas.read_json."""
    import pandas as pd

    return _read_files(pd.read_json, path, shards_per_host, host_index,
                       num_hosts, **pandas_kwargs)


def read_parquet(path, shards_per_host: Optional[int] = None, *,
                 host_index: Optional[int] = None,
                 num_hosts: Optional[int] = None, **pandas_kwargs) -> XShards:
    import pandas as pd

    return _read_files(pd.read_parquet, path, shards_per_host, host_index,
                       num_hosts, **pandas_kwargs)


def from_ndarrays(data, num_shards: int = 1) -> XShards:
    """In-memory ndarray/dict/tuple -> XShards (ref: XShards.partition)."""
    return XShards.partition(data, num_shards)
