"""Zouwu — the time-series toolkit: the port of
``analytics_zoo_tpu/zouwu`` (forecasters, preprocessing and AutoTS).
``TCMFForecaster`` is not ported yet: making one raises, naming ROADMAP
Queue 1 item 8.2."""

from analytics_zoo_tpu_torch.zouwu.forecaster import (
    Forecaster, LSTMForecaster, MTNetForecaster, Seq2SeqForecaster,
    TCNForecaster)
from analytics_zoo_tpu_torch.zouwu.preprocessing import (
    MinMaxScaler, StandardScaler, TimeSequenceFeatureTransformer,
    datetime_features, roll, train_val_test_split)
from analytics_zoo_tpu_torch.zouwu.autots import AutoTSTrainer, TSPipeline


class TCMFForecaster:
    """Not ported yet (ROADMAP Queue 1 item 8.2's remainder)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TCMFForecaster is not ported yet (ROADMAP Queue 1 item 8.2)")


__all__ = [
    "Forecaster", "LSTMForecaster", "TCNForecaster", "MTNetForecaster",
    "Seq2SeqForecaster", "TCMFForecaster",
    "roll", "train_val_test_split", "StandardScaler", "MinMaxScaler",
    "datetime_features", "TimeSequenceFeatureTransformer",
    "AutoTSTrainer", "TSPipeline",
]
