"""AutoML — hyper-parameter search without Ray: the port of
``analytics_zoo_tpu/automl``."""

from analytics_zoo_tpu_torch.automl import hp
from analytics_zoo_tpu_torch.automl.search import (
    MedianStopper, SearchEngine, Trial)
from analytics_zoo_tpu_torch.automl.auto_estimator import AutoEstimator

__all__ = ["hp", "SearchEngine", "MedianStopper", "Trial", "AutoEstimator"]
