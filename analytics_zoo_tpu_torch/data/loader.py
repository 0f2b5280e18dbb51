"""Host-side batch iteration: the port of
``analytics_zoo_tpu/data/loader.py`` for one device.

- ``NumpyBatchIterator``, copied as it is: the same per-epoch
  ``np.random.default_rng(seed + epoch).permutation`` means both packages
  see the same batches in the same order, shuffled or not.
- ``DataCreator``, copied as it is: every input the Estimator takes
  (a dict of arrays, an ``(x, y)`` pair, an ``XShards``, a
  ``FeatureSet`` or ``DiskFeatureSet``, or a callable ``config -> one of
  those``) normalised to a dict of numpy arrays.
- ``device_prefetch``: the reference's host-to-device stage, batches
  of numpy arrays as torch tensors on the device, a few copied ahead.
  Given a mesh and a batch placement (``parallel.partition.
  data_sharding``) each rank receives its rows of every global batch,
  the port's form of the reference's sharded global batches (one
  process a rank).
- ``data_shard``: the readers' ``(num_hosts, host_index)`` for a rank of
  a mesh: the data-shard groups of its batch axes, so that under tp and
  sp every rank of one dp coordinate reads the same files (the
  reference's processes are hosts; the port's are ranks, and the ranks
  of a tp or sp line are replicas of one host's rows).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.data.shards import XShards


class NumpyBatchIterator:
    """Epoch iterator over a dict of host-local ndarrays.

    Yields dicts of ndarrays with leading dim = batch size.  Shuffles
    with a per-epoch seed, so a fixed seed gives a reproducible data
    order.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int, *,
                 shuffle: bool = True, drop_remainder: bool = True,
                 seed: int = 0):
        if not arrays:
            raise ValueError("empty arrays dict")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        lens = {k: len(v) for k, v in arrays.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"ragged arrays: {lens}")
        self.arrays = arrays
        self.n = next(iter(lens.values()))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.seed = seed
        self.epoch = 0
        if batch_size > self.n:
            raise ValueError(
                f"per-host batch {batch_size} > host rows {self.n}")

    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def epoch_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        end = (self.n // self.batch_size) * self.batch_size \
            if self.drop_remainder else self.n
        if self.shuffle:
            # permute once per epoch per column, then serve contiguous
            # slices
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(self.n)
            arrays = {k: v[idx] for k, v in self.arrays.items()}
        else:
            arrays = self.arrays
        for lo in range(0, end, self.batch_size):
            yield {k: v[lo:lo + self.batch_size] for k, v in arrays.items()}
        self.epoch += 1


def device_prefetch(batches, device=None, depth: int = 2, sharding=None
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Each batch of ``batches`` (dicts of numpy arrays) as torch
    tensors on ``device`` (``None``: CUDA, raising without it; a
    ``parallel.mesh.Mesh``: its rank's device), with up to ``depth``
    batches copied ahead of the one handed out.  ``sharding`` (a
    ``parallel.partition.Placement`` of a batch, as ``data_sharding``
    gives) hands this rank its rows of each global batch: block
    ``my_group`` of the data-shard groups along dim 0; a global batch
    they do not divide raises."""
    from analytics_zoo_tpu_torch.device import resolve_device
    from analytics_zoo_tpu_torch.parallel.mesh import Mesh
    from analytics_zoo_tpu_torch.parallel.partition import (
        Placement, data_process_groups)

    if isinstance(device, Mesh):
        device = device.device
    share = None
    if sharding is not None:
        if not isinstance(sharding, Placement):
            raise TypeError(f"sharding must be a parallel.partition."
                            f"Placement (data_sharding(mesh)), got "
                            f"{type(sharding).__name__}")
        n_groups, my_group, _ = data_process_groups(sharding)
        share = (my_group, n_groups)
    dev = resolve_device(device)
    ahead: collections.deque = collections.deque()
    for batch in batches:
        if share is not None:
            batch = _rows_of(batch, *share)
        ahead.append({k: torch.as_tensor(np.ascontiguousarray(v)).to(
            dev, non_blocking=True) for k, v in batch.items()})
        if len(ahead) > depth:
            yield ahead.popleft()
    while ahead:
        yield ahead.popleft()


def data_shard(mesh=None):
    """``(num_hosts, host_index)`` to give ``data.readers``'s
    ``read_csv``/``read_json``/``read_parquet`` on ``mesh`` (default: the
    running context's): the count of its data-shard groups and this
    rank's (its dp coordinate); ``(1, 0)`` without a mesh."""
    from analytics_zoo_tpu_torch.common.context import context_mesh
    from analytics_zoo_tpu_torch.parallel.partition import (
        data_process_groups, data_sharding)

    mesh = mesh if mesh is not None else context_mesh()
    if mesh is None or mesh.devices == 1:
        return 1, 0
    n_groups, my_group, _ = data_process_groups(data_sharding(mesh))
    return n_groups, my_group


def _rows_of(batch: Dict[str, np.ndarray], index: int, count: int):
    """Block ``index`` of ``count`` equal blocks of a batch's rows."""
    n = len(next(iter(batch.values())))
    if n % count:
        raise ValueError(f"global batch {n} must be positive and "
                         f"divisible by data-shard group count {count}")
    per = n // count
    return {k: v[index * per:(index + 1) * per] for k, v in batch.items()}


class DataCreator:
    """The reference's data-creator contract (SURVEY.md §2.2: estimators
    accept ``data_creator(config) -> loader``).  Anything acceptable to
    `Estimator.fit` normalises through here: XShards, dict of ndarrays,
    (x, y) tuples, or a callable(config) returning one of those."""

    @staticmethod
    def to_arrays(data: Any, config: Optional[dict] = None,
                  feature_cols: Optional[Sequence[str]] = None,
                  label_cols: Optional[Sequence[str]] = None
                  ) -> Dict[str, np.ndarray]:
        if callable(data):
            data = data(config or {})
        # TFDataset bridging adapter (tfpark surface; duck-typed — also
        # covers subclasses — to keep the data layer import-free of tfpark)
        if not isinstance(data, dict) and callable(
                getattr(data, "to_arrays", None)):
            data = data.to_arrays()
        # FeatureSet tiers (import locally — feature_set imports loader)
        from analytics_zoo_tpu_torch.data import feature_set as _fs
        if isinstance(data, _fs.DiskFeatureSet):
            data = data.to_dram()       # eval/predict paths materialise
        if isinstance(data, _fs.FeatureSet):
            d = dict(data.arrays)
        elif isinstance(data, XShards):
            d = data.to_numpy_dict()
        elif isinstance(data, dict):
            d = {k: np.asarray(v) for k, v in data.items()}
        elif isinstance(data, (tuple, list)) and len(data) == 2:
            x, y = data
            d = {}
            if isinstance(x, dict):
                d.update({k: np.asarray(v) for k, v in x.items()})
            else:
                d["x"] = np.asarray(x)
            if isinstance(y, dict):
                d.update({k: np.asarray(v) for k, v in y.items()})
            else:
                d["y"] = np.asarray(y)
        else:
            raise TypeError(f"unsupported data type {type(data)}")
        if feature_cols or label_cols:
            sel = {}
            for c in list(feature_cols or []) + list(label_cols or []):
                if c not in d:
                    raise KeyError(f"column {c!r} not in data "
                                   f"(have {sorted(d)})")
                sel[c] = d[c]
            d = sel
        return d
