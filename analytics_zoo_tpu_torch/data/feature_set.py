"""FeatureSet: the DRAM and DISK tiers of a training set, a copy of
``analytics_zoo_tpu/data/feature_set.py``.

``FeatureSet`` keeps a dict of numpy arrays in host memory;
``FeatureSet.to_disk`` spills it to a ZREC record file of row blocks,
which ``DiskFeatureSet`` streams back through the native prefetch thread
and a ring buffer (shuffled by block each epoch).  Both feed
``Estimator.fit``, ``evaluate`` and ``predict``.  A ``{host}``
placeholder in a path expands to this process's rank in the process
group (0 without one), so each rank spills and streams its own shard
file, and ``device_stream`` yields batches of torch tensors on the
given device (or a mesh's) through ``data.loader.device_prefetch``,
this rank's rows under a ``sharding``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data.loader import NumpyBatchIterator, device_prefetch
from analytics_zoo_tpu_torch.data.shards import XShards

BLOCK_ROWS_DEFAULT = 4096


def _host_path(path: str) -> str:
    """Per-host shard-file naming: a ``{host}`` placeholder expands to this
    process's index, so N hosts spill/stream N disjoint files from one
    path template (the multihost DISK-tier contract: each host owns the
    shard file it writes — nothing is replicated)."""
    if "{host}" in path:
        from analytics_zoo_tpu_torch.common.context import \
            effective_process_index

        return path.format(host=effective_process_index())
    return path


class FeatureSet:
    """DRAM-tier feature set (ref: FeatureSet.rdd / DRAMFeatureSet)."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        lens = {k: len(v) for k, v in arrays.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"ragged arrays: {lens}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_arrays(arrays: Dict[str, np.ndarray]) -> "FeatureSet":
        return FeatureSet(arrays)

    @staticmethod
    def from_shards(shards: XShards) -> "FeatureSet":
        return FeatureSet(shards.to_numpy_dict())

    # -- API ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(next(iter(self.arrays.values()))) if self.arrays else 0

    def batches(self, batch_size: int, *, shuffle: bool = True,
                drop_remainder: bool = True, seed: int = 0, epoch: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        it = NumpyBatchIterator(self.arrays, batch_size, shuffle=shuffle,
                                drop_remainder=drop_remainder, seed=seed)
        it.epoch = epoch
        return it.epoch_batches()

    def device_stream(self, mesh, batch_size: int, *, depth: int = 2,
                      sharding=None, **kw):
        return device_prefetch(self.batches(batch_size, **kw), mesh,
                               depth=depth, sharding=sharding)

    def to_disk(self, path: Optional[str] = None,
                block_rows: int = BLOCK_ROWS_DEFAULT) -> "DiskFeatureSet":
        """Spill to the DISK tier: write row-blocks to a ZREC record file.

        ``path`` may be a remote URI (gs://, s3://, memory://; a
        ``{host}`` placeholder composes — each host uploads its own
        shard object): the file is written locally and pushed out, and
        the returned DiskFeatureSet streams from the primed local cache,
        not back over the wire."""
        from analytics_zoo_tpu_torch import native

        from analytics_zoo_tpu_torch.common import fs

        if path is None:
            fd, path = tempfile.mkstemp(suffix=".zrec")
            os.close(fd)
        path = _host_path(path)
        local = path
        if fs.is_remote(path):
            fd, local = tempfile.mkstemp(suffix=".zrec")
            os.close(fd)
        n = len(self)
        with native.RecordWriter(local) as w:
            for lo in range(0, n, block_rows):
                block = {k: v[lo:lo + block_rows]
                         for k, v in self.arrays.items()}
                w.write(native.pack_batch(block))
        if fs.is_remote(path):
            fs.upload(local, path)
            fs.prime_cache(local, path)
            os.remove(local)    # the cache copy is now the local source
        return DiskFeatureSet(path)


class DiskFeatureSet:
    """DISK-tier feature set over a ZREC file (ref: DiskFeatureSet /
    PmemFeatureSet — memory tier beyond DRAM, zoo feature/pmem/).

    Row-blocks are streamed by a *native* reader thread into a ring buffer
    (file IO + memcpy run in C++ while JAX computes), then re-batched to the
    requested batch size in numpy.  Block order is shuffled per epoch;
    intra-block order is preserved (the reference's PMEM path likewise
    shuffles at the chunk level).

    Multihost: the file is HOST-LOCAL — each host streams the shard it owns
    (spill with a ``{host}`` placeholder path, or any per-host path).  The
    Estimator aligns step/chunk counts across hosts via one row-count
    allgather, so uneven shards train on ``min_rows`` per host and
    evaluate/predict over every row exactly once.
    """

    def __init__(self, path: str, *, ring_mb: int = 128):
        from analytics_zoo_tpu_torch import native

        from analytics_zoo_tpu_torch.common import fs

        path = _host_path(path)
        self.path = path
        self._native = native
        # remote shard URIs (each host downloads only ITS {host} shard)
        # materialise through the per-process cache: the native reader
        # mmaps a real local file — streaming ZREC over object-store
        # range reads would serialise the prefetch thread on the wire
        self.reader = native.RecordReader(fs.local_copy(path))
        self.ring_bytes = ring_mb << 20
        meta = native.unpack_batch(self.reader.get(0)) if len(self.reader) \
            else {}
        self.colnames = sorted(meta)
        # Exact total: sum each block's header row count (header peek over
        # the mmap — no payload copies).  Files written through the public
        # RecordWriter/pack_batch API may have arbitrarily uneven blocks.
        self._n = sum(native.peek_batch_rows(self.reader.get(i))
                      for i in range(len(self.reader)))

    def __len__(self) -> int:
        return self._n

    def batches(self, batch_size: int, *, shuffle: bool = True,
                drop_remainder: bool = True, seed: int = 0, epoch: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        if self._n == 0 or (batch_size > self._n and drop_remainder):
            # a silent zero-batch epoch/eval would look like running while
            # doing nothing; with drop_remainder=False and rows present the
            # single short batch is emitted (the DRAM eval/predict contract)
            raise ValueError(
                f"per-host batch {batch_size} > host rows {self._n}")
        native = self._native
        nblocks = len(self.reader)
        order = np.arange(nblocks)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        ring = native.RingBuffer(self.ring_bytes)
        pf = native.Prefetcher(self.reader, ring, order.tolist(), loop=False)
        try:
            # Deque of blocks + a row cursor into the head block: each output
            # batch concatenates exactly the slices it needs (linear copies —
            # no re-concatenation of the whole pending buffer per batch).
            import collections

            pend: collections.deque = collections.deque()
            head_off = 0
            pend_rows = 0

            def emit(n):
                nonlocal head_off, pend_rows
                pieces: Dict[str, list] = {}
                need = n
                while need:
                    block = pend[0]
                    blen = len(next(iter(block.values()))) - head_off
                    take = min(need, blen)
                    for k, v in block.items():
                        pieces.setdefault(k, []).append(
                            v[head_off:head_off + take])
                    need -= take
                    if take == blen:
                        pend.popleft()
                        head_off = 0
                    else:
                        head_off += take
                pend_rows -= n
                return {k: np.concatenate(v) if len(v) > 1 else v[0]
                        for k, v in pieces.items()}

            while True:
                blob = ring.pop()
                if blob is None:
                    break
                block = native.unpack_batch(blob)
                pend.append(block)
                pend_rows += len(next(iter(block.values())))
                while pend_rows >= batch_size:
                    yield emit(batch_size)
            if pend_rows and not drop_remainder:
                yield emit(pend_rows)
        finally:
            ring.close()
            pf.stop()

    def device_stream(self, mesh, batch_size: int, *, depth: int = 2,
                      sharding=None, **kw):
        return device_prefetch(self.batches(batch_size, **kw), mesh,
                               depth=depth, sharding=sharding)

    def fingerprint(self) -> int:
        """Content fingerprint (row count + full first/last record hash),
        used by the Estimator to detect N hosts accidentally opening ONE
        replicated/shared shard file instead of per-host shards.  Distinct
        shards that differ anywhere in their first or last block hash
        differently; a genuine collision can be overridden with
        ANALYTICS_ZOO_TPU_ALLOW_SHARED_DISK=1."""
        import hashlib

        h = hashlib.blake2b(digest_size=7)
        h.update(str(self._n).encode())
        nrec = len(self.reader)
        if nrec:
            h.update(bytes(self.reader.get(0)))
            h.update(bytes(self.reader.get(nrec - 1)))
        return int.from_bytes(h.digest(), "little")

    def sample_block(self) -> Dict[str, np.ndarray]:
        """First row-block (shape/dtype probe) — reads one record, no
        prefetch thread / ring buffer involved."""
        if not len(self.reader):
            raise ValueError(f"{self.path} holds no records")
        return self._native.unpack_batch(self.reader.get(0))

    def batch_iterator(self, batch_size: int, *, shuffle: bool = True,
                       seed: int = 0) -> "_DiskEpochIterator":
        """NumpyBatchIterator-compatible epoch iterator (Estimator.fit's
        data protocol): each epoch_batches() call streams a fresh shuffled
        pass through the native prefetch thread."""
        return _DiskEpochIterator(self, batch_size, shuffle, seed)

    def to_dram(self) -> FeatureSet:
        cols: Dict[str, list] = {}
        for i in range(len(self.reader)):
            for k, v in self._native.unpack_batch(self.reader.get(i)).items():
                cols.setdefault(k, []).append(v)
        return FeatureSet({k: np.concatenate(v) for k, v in cols.items()})

    def close(self):
        self.reader.close()


class _DiskEpochIterator:
    """Adapter: DiskFeatureSet -> the epoch_batches() protocol fit uses."""

    def __init__(self, dfs: DiskFeatureSet, batch_size: int, shuffle: bool,
                 seed: int):
        self.dfs = dfs
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def steps_per_epoch(self) -> int:
        return len(self.dfs) // self.batch_size

    def epoch_batches(self):
        it = self.dfs.batches(self.batch_size, shuffle=self.shuffle,
                              drop_remainder=True, seed=self.seed,
                              epoch=self.epoch)
        self.epoch += 1
        return it
