"""Chainable transforms, the port's copy.

A copy of ``analytics_zoo_tpu/utils/transform.py`` (standard library
only), pinned to it by ``tests/test_torch_serving_pins.py``: the
``Transform`` base with ``>>`` composition and the flattened ``Chain``
that the port's NNFrames preprocessing (``frames/nnframes.py``) builds
on.
"""

from __future__ import annotations

from typing import Callable, List, Sequence


class Transform:
    """Wraps ``fn(x) -> x``; compose left-to-right with ``>>``."""

    chain_cls: type = None  # bound to Chain below (subclasses override)

    def __init__(self, fn: Callable, name: str = "transform"):
        self.fn = fn
        self.name = name

    def __call__(self, x):
        return self.fn(x)

    def _steps(self) -> List["Transform"]:
        return [self]

    def __rshift__(self, other: "Transform") -> "Transform":
        cls = self.chain_cls or Chain
        return cls(self._steps() + other._steps())


class Chain(Transform):
    """Flattened left-to-right composition of Transforms."""

    def __init__(self, steps: Sequence[Transform]):
        self.steps = list(steps)
        super().__init__(self._apply, "chained")

    def _steps(self) -> List[Transform]:
        return list(self.steps)

    def _apply(self, x):
        for s in self.steps:
            x = s(x)
        return x


Transform.chain_cls = Chain
