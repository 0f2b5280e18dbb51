"""NNFrames: DataFrame-style train and predict stages (the port of
``analytics_zoo_tpu/frames``)."""

from analytics_zoo_tpu_torch.frames.nnframes import (
    ChainedPreprocessing, NNClassifier, NNClassifierModel, NNEstimator,
    NNImageReader, NNModel, Preprocessing, ScalerPreprocessing,
    df_to_arrays)

__all__ = [
    "NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel",
    "NNImageReader", "Preprocessing", "ChainedPreprocessing",
    "ScalerPreprocessing", "df_to_arrays",
]
