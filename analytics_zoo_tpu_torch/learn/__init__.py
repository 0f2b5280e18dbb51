"""Training and inference entry points of the port."""

from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.learn.lora import LoRAConfig

__all__ = ["Estimator", "LoRAConfig"]
