"""Training and inference entry points of the port."""

from analytics_zoo_tpu_torch.learn.estimator import Estimator

__all__ = ["Estimator"]
