"""Host-side batch iteration: the port's copy of ``NumpyBatchIterator``.

The numpy half of ``analytics_zoo_tpu/data/loader.py``, copied as it is:
the same per-epoch ``np.random.default_rng(seed + epoch).permutation``
means both packages see the same batches in the same order, shuffled or
not.  The device half (sharded global batches, prefetch) has no
counterpart on one device: the Estimator copies each batch to the card.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


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
