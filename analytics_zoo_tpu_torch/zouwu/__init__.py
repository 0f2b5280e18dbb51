"""Zouwu — the time-series toolkit: the port of
``analytics_zoo_tpu/zouwu`` (forecasters, preprocessing, AutoTS and
``TCMFForecaster``)."""

from analytics_zoo_tpu_torch.zouwu.forecaster import (
    Forecaster, LSTMForecaster, MTNetForecaster, Seq2SeqForecaster,
    TCNForecaster)
from analytics_zoo_tpu_torch.zouwu.preprocessing import (
    MinMaxScaler, StandardScaler, TimeSequenceFeatureTransformer,
    datetime_features, roll, train_val_test_split)
from analytics_zoo_tpu_torch.zouwu.autots import AutoTSTrainer, TSPipeline

from analytics_zoo_tpu_torch.zouwu.tcmf import TCMFForecaster

__all__ = [
    "Forecaster", "LSTMForecaster", "TCNForecaster", "MTNetForecaster",
    "Seq2SeqForecaster", "TCMFForecaster",
    "roll", "train_val_test_split", "StandardScaler", "MinMaxScaler",
    "datetime_features", "TimeSequenceFeatureTransformer",
    "AutoTSTrainer", "TSPipeline",
]
