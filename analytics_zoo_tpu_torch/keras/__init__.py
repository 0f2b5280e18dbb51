"""Keras-1.2-compatible API on PyTorch: the port of
``analytics_zoo_tpu/keras/``.

The same surface as the reference (layers with keras-style arguments,
``Sequential``/``Model``/``merge``, ``compile/fit/evaluate/predict``,
regularizers, optimizer and loss names), each layer an ``nn.Module``
that holds the reference's numbers and carries its variables
(``engine.set_variables``, ``get_weights``/``set_weights``), trained by
the port's ``TorchEstimator``.
"""

from analytics_zoo_tpu_torch.keras.engine import (Input, KerasNet, Model,
                                                  Sequential, merge)
from analytics_zoo_tpu_torch.keras import layers  # noqa: F401
from analytics_zoo_tpu_torch.keras.layers import *  # noqa: F401,F403
from analytics_zoo_tpu_torch.keras.optimizers import get_optimizer
from analytics_zoo_tpu_torch.keras.regularizers import l1, l1l2, l2

__all__ = [
    "Input", "KerasNet", "Model", "Sequential", "merge",
    "get_optimizer", "l1", "l2", "l1l2", "layers",
] + layers.__all__
