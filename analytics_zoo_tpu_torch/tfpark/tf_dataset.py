"""TFDataset: the reference's dataset-bridging surface, the port's copy.

A copy of ``analytics_zoo_tpu/tfpark/tf_dataset.py`` (numpy only),
pinned to it by ``tests/test_torch_serving_pins.py``, on the port's
``data/loader.py`` (``DataCreator``) and ``data/feature_set.py``.  A
``TFDataset`` is a dict of equal-length columns and the reference's
batch metadata: ``batch_size`` (the training batch) and
``batch_per_thread`` (the inference batch), which the Estimator reads
when a call passes none; ``from_ndarrays(..., val_tensors=)`` carries a
validation set (``.val``) that ``fit`` takes when it is given none.
Named constructors: ``from_ndarrays``, ``from_rdd`` (an ``XShards``),
``from_image_set``, ``from_text_set`` and ``from_feature_set`` (a
``DiskFeatureSet`` raises ``TypeError``: it streams, pass it to
``fit``); ragged columns raise ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class TFDataset:
    """Adapter carrying (columns, batch metadata) — accepted anywhere the
    estimators take data (DataCreator normalises via ``to_arrays()``)."""

    def __init__(self, arrays: Dict[str, np.ndarray],
                 batch_size: int = -1, batch_per_thread: int = -1):
        lens = {k: len(v) for k, v in arrays.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"ragged columns: {lens}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        # reference semantics: batch_size is the GLOBAL training batch;
        # batch_per_thread is the per-worker inference batch
        self.batch_size = batch_size
        self.batch_per_thread = batch_per_thread

    # -- reference-parity constructors ---------------------------------

    @staticmethod
    def from_ndarrays(tensors, batch_size: int = -1,
                      batch_per_thread: int = -1,
                      val_tensors=None) -> "TFDataset":
        """tensors: dict of ndarrays, or (x, y) tuple like the reference's
        (features, labels) pair."""
        from analytics_zoo_tpu_torch.data.loader import DataCreator

        ds = TFDataset(DataCreator.to_arrays(tensors), batch_size,
                       batch_per_thread)
        if val_tensors is not None:
            ds.val = TFDataset.from_ndarrays(val_tensors)
        return ds

    @staticmethod
    def from_rdd(shards, batch_size: int = -1, batch_per_thread: int = -1,
                 **_compat) -> "TFDataset":
        """ref: from_rdd(rdd) — here the partitioned currency is XShards
        (SURVEY §2.2: XShards replaces the RDD)."""
        return TFDataset(shards.to_numpy_dict(), batch_size,
                         batch_per_thread)

    @staticmethod
    def from_image_set(image_set, batch_size: int = -1,
                       batch_per_thread: int = -1) -> "TFDataset":
        """ref: from_image_set(ImageSet) — images (+labels when present)
        become the x/y columns after the transform chain has run."""
        d = image_set.to_numpy_dict()
        return TFDataset(d, batch_size, batch_per_thread)

    @staticmethod
    def from_text_set(text_set, batch_size: int = -1,
                      batch_per_thread: int = -1) -> "TFDataset":
        """ref: from_text_set(TextSet) — tokens/labels after
        tokenize/word2idx/shape_sequence."""
        return TFDataset(text_set.to_numpy_dict(), batch_size,
                         batch_per_thread)

    @staticmethod
    def from_feature_set(feature_set, batch_size: int = -1,
                         batch_per_thread: int = -1) -> "TFDataset":
        """ref: from_feature_set(FeatureSet) — DRAM tier only; the DISK
        tier streams and should be passed to fit() directly."""
        from analytics_zoo_tpu_torch.data.feature_set import DiskFeatureSet

        if isinstance(feature_set, DiskFeatureSet):
            raise TypeError(
                "DiskFeatureSet streams from disk — pass it to "
                "Estimator.fit directly instead of materialising it "
                "through TFDataset")
        return TFDataset(dict(feature_set.arrays), batch_size,
                         batch_per_thread)

    # -- consumption ----------------------------------------------------

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return self.arrays

    def column_names(self) -> Sequence[str]:
        return list(self.arrays)

    def __len__(self) -> int:
        return len(next(iter(self.arrays.values()))) if self.arrays else 0


__all__ = ["TFDataset"]
