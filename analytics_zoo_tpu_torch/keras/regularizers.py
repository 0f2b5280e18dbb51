"""L1/L2 weight regularizers: the port of ``analytics_zoo_tpu/keras/
regularizers.py``.  A regularizer is a spec; ``KerasNet`` sums the
penalties of its layers' weights into the Estimator's ``param_loss``."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Regularizer:
    l1: float = 0.0
    l2: float = 0.0

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        pen = torch.zeros((), dtype=torch.float32, device=w.device)
        if self.l1:
            pen = pen + self.l1 * torch.sum(torch.abs(w))
        if self.l2:
            pen = pen + self.l2 * torch.sum(torch.square(w))
        return pen


def l1(v: float = 0.01) -> Regularizer:
    return Regularizer(l1=v)


def l2(v: float = 0.01) -> Regularizer:
    return Regularizer(l2=v)


def l1l2(l1_v: float = 0.01, l2_v: float = 0.01) -> Regularizer:
    return Regularizer(l1=l1_v, l2=l2_v)
