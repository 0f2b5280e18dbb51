"""NNFrames: DataFrame-native estimator and transformer stages.

The port of ``analytics_zoo_tpu/frames/nnframes.py``:
``NNEstimator(model, criterion).setFeaturesCol(...).fit(df)`` trains a
torch module through the port's Estimator and returns an ``NNModel``
whose ``transform(df)`` appends a ``prediction`` column;
``NNClassifier``/``NNClassifierModel`` specialise to integer labels and
argmax predictions.  ``df`` is a pandas DataFrame, a dict of numpy
arrays, or an ``XShards`` of either (``data/shards.py``).  pandas is
imported only where a DataFrame is met, so an ``XShards`` of numpy
dicts trains on a machine without pandas.

Each ``fit`` builds a fresh Estimator around the same module (the
module trains in place), with the reference's default optimizer,
``optax.adam(1e-3)``: ``torch.optim.Adam(lr=1e-3)``.  ``device`` (the
port's addition) is where it trains: ``cuda`` unless the caller names
another.  ``NNImageReader.readImages`` reads a directory of images
into a pandas DataFrame (the image column and the reference's schema
columns) through ``data.image.ImageSet``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from analytics_zoo_tpu_torch.data.shards import XShards
from analytics_zoo_tpu_torch.learn.estimator import TorchEstimator
from analytics_zoo_tpu_torch.utils.transform import Chain, Transform


def _is_df(x) -> bool:
    try:
        import pandas as pd
    except ImportError:
        return False
    return isinstance(x, pd.DataFrame)


class Preprocessing(Transform):
    """Composable column -> ndarray step: ``fn(np.ndarray) -> np.ndarray``
    applied to the stacked column; chain with ``>>``."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray],
                 name: str = "preprocessing"):
        super().__init__(fn, name)


class ChainedPreprocessing(Chain, Preprocessing):
    """Left-to-right composition of preprocessing steps."""


Preprocessing.chain_cls = ChainedPreprocessing


class ScalerPreprocessing(Preprocessing):
    def __init__(self, mean: float = 0.0, scale: float = 1.0):
        super().__init__(lambda a: ((a - mean) / scale).astype(np.float32),
                         "scaler")


def _col_to_array(df, col: str) -> np.ndarray:
    """Stack a DataFrame column of scalars or array-likes into [N, ...]."""
    vals = df[col].to_list()
    first = vals[0]
    if isinstance(first, (list, tuple, np.ndarray)):
        return np.stack([np.asarray(v) for v in vals])
    return np.asarray(df[col].to_numpy())


def df_to_arrays(df, feature_cols: Sequence[str],
                 label_cols: Sequence[str] = (),
                 feature_preprocessing: Optional[Preprocessing] = None):
    """DataFrame -> the Estimator's dict of arrays, the features passed
    through ``feature_preprocessing``."""
    out = {}
    for c in feature_cols:
        a = _col_to_array(df, c)
        if feature_preprocessing is not None:
            a = feature_preprocessing(a)
        out[c] = a
    for c in label_cols:
        out[c] = _col_to_array(df, c)
    return out


class NNEstimator:
    """``NNEstimator(model, criterion)`` with Spark-ML-style setters;
    ``fit(df)`` -> :class:`NNModel`."""

    def __init__(self, model, criterion: Union[str, Callable],
                 optimizer=None, *,
                 feature_preprocessing: Optional[Preprocessing] = None,
                 device=None):
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.feature_preprocessing = feature_preprocessing
        self.device = device
        self.feature_cols: List[str] = ["features"]
        self.label_cols: List[str] = ["label"]
        self.batch_size = 32
        self.max_epoch = 1

    def setFeaturesCol(self, *cols: str) -> "NNEstimator":
        self.feature_cols = list(cols)
        return self

    def setLabelCol(self, *cols: str) -> "NNEstimator":
        self.label_cols = list(cols)
        return self

    def setBatchSize(self, bs: int) -> "NNEstimator":
        self.batch_size = int(bs)
        return self

    def setMaxEpoch(self, n: int) -> "NNEstimator":
        self.max_epoch = int(n)
        return self

    def _make_estimator(self) -> TorchEstimator:
        opt = self.optimizer if self.optimizer is not None else 1e-3
        return TorchEstimator(self.model, self.criterion, opt,
                              feature_cols=tuple(self.feature_cols),
                              label_cols=tuple(self.label_cols),
                              device=self.device)

    def _arrays(self, df):
        if isinstance(df, XShards):
            shards = df.collect()
            if _is_df(shards[0]):
                import pandas as pd

                df = pd.concat(shards, ignore_index=True)
            else:
                df = df.to_numpy_dict()
        if _is_df(df):
            return df_to_arrays(df, self.feature_cols, self.label_cols,
                                self.feature_preprocessing)
        return df  # already a dict of arrays

    def fit(self, df, validation_df=None) -> "NNModel":
        est = self._make_estimator()
        val = self._arrays(validation_df) \
            if validation_df is not None else None
        est.fit(self._arrays(df), epochs=self.max_epoch,
                batch_size=self.batch_size, validation_data=val)
        return self._model_cls()(est, self.feature_cols,
                                 self.feature_preprocessing)

    def _model_cls(self):
        return NNModel


class NNModel:
    """A fitted stage: ``transform(df)`` appends ``prediction``."""

    prediction_col = "prediction"

    def __init__(self, estimator: TorchEstimator,
                 feature_cols: Sequence[str],
                 feature_preprocessing: Optional[Preprocessing] = None):
        self.estimator = estimator
        self.feature_cols = list(feature_cols)
        self.feature_preprocessing = feature_preprocessing
        self.batch_size = 128

    def setBatchSize(self, bs: int) -> "NNModel":
        self.batch_size = int(bs)
        return self

    def _predict_arrays(self, df) -> np.ndarray:
        arrays = df_to_arrays(df, self.feature_cols, (),
                              self.feature_preprocessing) \
            if _is_df(df) else df
        return self.estimator.predict(arrays, batch_size=self.batch_size)

    def _post(self, preds: np.ndarray):
        return [np.asarray(p) for p in preds]  # row-wise vectors

    def transform(self, df):
        if isinstance(df, XShards):
            return df.transform_shard(self.transform)
        preds = self._post(self._predict_arrays(df))
        out = df.copy()
        out[self.prediction_col] = preds
        return out

    def save(self, path: str):
        self.estimator.save(path)


class NNClassifier(NNEstimator):
    """Classification: integer labels, cross-entropy by default."""

    def __init__(self, model, criterion="sparse_categorical_crossentropy",
                 optimizer=None, **kw):
        super().__init__(model, criterion, optimizer, **kw)

    def _model_cls(self):
        return NNClassifierModel


class NNClassifierModel(NNModel):
    """``transform()`` yields the argmax class id (float, Spark ML's)."""

    def _post(self, preds: np.ndarray):
        return np.argmax(np.asarray(preds), axis=-1).astype(
            np.float64).tolist()


class NNImageReader:
    """The reference's image reader: ``readImages(path)`` returns a
    pandas DataFrame whose ``image`` column holds decoded RGB ndarrays
    (HWC uint8; float32 after a resize), decoded on the host by the
    native data plane or PIL (``data/image.py``), beside the schema
    columns ``origin``, ``height``, ``width``, ``n_channels`` (and
    ``label`` with ``with_label``); the class names are in
    ``df.attrs["class_names"]``."""

    @staticmethod
    def readImages(path: str, resize_h: int = -1, resize_w: int = -1,
                   with_label: bool = False, num_shards: int = 1):
        """Read a dir (or one-subdir-per-class tree when with_label)."""
        import pandas as pd

        from analytics_zoo_tpu_torch.data.image import ImageResize, ImageSet

        iset = ImageSet.read(path, num_shards=num_shards,
                             with_label=with_label)
        if resize_h > 0 and resize_w > 0:
            iset = iset.transform(ImageResize(resize_h, resize_w))
        rows = {"origin": [], "image": [], "height": [], "width": [],
                "n_channels": [], "label": []}
        for shard in iset.shards.collect():
            for img, label, p in zip(shard["image"], shard["label"],
                                     shard["path"]):
                rows["origin"].append(p)
                rows["image"].append(img)
                rows["height"].append(img.shape[0])
                rows["width"].append(img.shape[1])
                rows["n_channels"].append(img.shape[2])
                rows["label"].append(int(label))
        df = pd.DataFrame(rows)
        if not with_label:
            df = df.drop(columns=["label"])
        df.attrs["class_names"] = iset.class_names
        return df
