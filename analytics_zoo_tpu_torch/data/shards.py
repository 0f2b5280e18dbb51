"""XShards: partitioned host data, the port's copy.

A copy of ``analytics_zoo_tpu/data/shards.py`` (numpy, and pandas
imported only where a shard is a DataFrame), pinned to it by
``tests/test_torch_serving_pins.py``.  The port runs one process on one
card, so every shard is local (``num_hosts=1``); ``NNEstimator`` and
``NNModel`` (``frames/nnframes.py``) take an ``XShards`` of numpy dicts
or of DataFrames.
"""

from __future__ import annotations

import bisect
import copy
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


def _is_pandas(x) -> bool:
    try:
        import pandas as pd

        return isinstance(x, (pd.DataFrame, pd.Series))
    except ImportError:  # pragma: no cover
        return False


def shard_len(payload) -> int:
    """Row count of one shard payload (dict-of-ndarrays | ndarray | DF)."""
    if isinstance(payload, dict):
        if not payload:
            return 0
        return shard_len(next(iter(payload.values())))
    if isinstance(payload, (list, tuple)):
        return shard_len(payload[0]) if payload else 0
    return len(payload)


class XShards:
    """A list of local shards + awareness of sibling hosts.

    API parity with the reference's SparkXShards where it makes sense:
    ``transform_shard``, ``collect``, ``num_partitions``, ``repartition``,
    ``partition`` (static constructor), ``zip``, ``split``, plus
    numpy-centric helpers the estimators use (``to_numpy_dict``,
    ``row_count``).
    """

    def __init__(self, shards: Sequence[Any], *, num_hosts: int = 1,
                 host_index: int = 0):
        self._shards: List[Any] = list(shards)
        self.num_hosts = num_hosts
        self.host_index = host_index

    # ---- constructors -------------------------------------------------

    @staticmethod
    def partition(data: Any, num_shards: Optional[int] = None) -> "XShards":
        """Split an in-memory ndarray / dict / tuple-of-ndarrays into shards
        (ref: zoo.orca.data.XShards.partition)."""
        n = num_shards or 1
        total = shard_len(data)
        n = max(1, min(n, total)) if total else 1
        bounds = np.linspace(0, total, n + 1).astype(int)

        def take(x, lo, hi):
            if isinstance(x, dict):
                return {k: take(v, lo, hi) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(take(v, lo, hi) for v in x)
            return x[lo:hi]

        return XShards([take(data, bounds[i], bounds[i + 1])
                        for i in range(n)])

    @staticmethod
    def from_list(records: Sequence[Any],
                  num_shards: Optional[int] = None) -> "XShards":
        """Split a flat sequence of arbitrary records (rows) into shards.

        Unlike ``partition`` — which treats list/tuple payloads as
        *columns* — this slices the sequence row-wise, for payloads like
        [(path, label), ...] or [TextFeature, ...].
        """
        records = list(records)
        n = max(1, min(num_shards or 1, len(records) or 1))
        bounds = np.linspace(0, len(records), n + 1).astype(int)
        return XShards([records[bounds[i]:bounds[i + 1]]
                        for i in range(n)])

    # ---- core ops -----------------------------------------------------

    def transform_shard(self, fn: Callable, *args) -> "XShards":
        return XShards([fn(s, *args) for s in self._shards],
                       num_hosts=self.num_hosts, host_index=self.host_index)

    def collect(self) -> List[Any]:
        """Local shards (this host's partition of the global dataset)."""
        return list(self._shards)

    def num_partitions(self) -> int:
        return len(self._shards)

    def repartition(self, num_partitions: int) -> "XShards":
        """Re-split local shards into `num_partitions` equal pieces.

        Only supports payloads we can concat (ndarray / dict / DataFrame).
        """
        merged = self._concat(self._shards)
        return XShards.partition(merged, num_partitions)._with_host(
            self.num_hosts, self.host_index)

    def zip(self, other: "XShards") -> "XShards":
        if other.num_partitions() != self.num_partitions():
            raise ValueError("zip requires equal partition counts")
        return XShards([(a, b) for a, b in zip(self._shards, other._shards)],
                       num_hosts=self.num_hosts, host_index=self.host_index)

    def split(self, weights: Sequence[float], seed: int = 0):
        """Random row-level split (e.g. train/val). Returns len(weights)
        XShards."""
        rng = np.random.default_rng(seed)
        outs: List[List[Any]] = [[] for _ in weights]
        cum = np.cumsum(np.asarray(weights, dtype=np.float64))
        cum = cum / cum[-1]
        for s in self._shards:
            n = shard_len(s)
            u = rng.random(n)
            masks = []
            lo = 0.0
            for hi in cum:
                masks.append((u >= lo) & (u < hi))
                lo = hi
            for i, m in enumerate(masks):
                outs[i].append(self._mask(s, m))
        return [XShards(o, num_hosts=self.num_hosts,
                        host_index=self.host_index) for o in outs]

    # ---- numpy/pandas bridging ---------------------------------------

    def to_numpy_dict(self) -> Dict[str, np.ndarray]:
        """Concatenate all local shards into one dict of ndarrays.

        pandas shards become {col: values}; plain ndarrays become {"x": a}.
        """
        merged = self._concat(self._shards)
        if _is_pandas(merged):
            return {c: merged[c].to_numpy() for c in merged.columns}
        if isinstance(merged, dict):
            return {k: np.asarray(v) for k, v in merged.items()}
        if isinstance(merged, (list, tuple)):
            return {f"x{i}": np.asarray(v) for i, v in enumerate(merged)}
        return {"x": np.asarray(merged)}

    def row_count(self) -> int:
        return sum(shard_len(s) for s in self._shards)

    def get_schema(self):
        """Column names of the first shard (pandas parity helper)."""
        if not self._shards:
            return None
        s = self._shards[0]
        if _is_pandas(s):
            return {"columns": list(s.columns)}
        if isinstance(s, dict):
            return {"columns": list(s.keys())}
        return None

    # ---- internals ----------------------------------------------------

    def _with_host(self, num_hosts, host_index):
        self.num_hosts, self.host_index = num_hosts, host_index
        return self

    @staticmethod
    def _mask(payload, mask):
        if isinstance(payload, dict):
            return {k: XShards._mask(v, mask) for k, v in payload.items()}
        if isinstance(payload, (list, tuple)):
            return type(payload)(XShards._mask(v, mask) for v in payload)
        return payload[mask]  # ndarray and pandas share the same indexing

    @staticmethod
    def _concat(shards: Sequence[Any]):
        if not shards:
            return {}
        first = shards[0]
        if len(shards) == 1:
            return copy.copy(first)
        if _is_pandas(first):
            import pandas as pd

            return pd.concat(shards, ignore_index=True)
        if isinstance(first, dict):
            return {k: np.concatenate([np.asarray(s[k]) for s in shards])
                    for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(
                np.concatenate([np.asarray(s[i]) for s in shards])
                for i in range(len(first)))
        return np.concatenate([np.asarray(s) for s in shards])


class SparkXShards(XShards):
    """Alias retained for reference API parity (there is no Spark here)."""
