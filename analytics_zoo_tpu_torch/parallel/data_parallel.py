"""What a data-parallel training step tells the layers it runs: this
rank's rows of the global batch and the process group over the batch
axes.

The reference trains on a dp mesh with one global view: a dropout mask
is drawn for the whole global batch, and BatchNorm's statistics are
means over the whole global batch.  The port runs one process a rank,
each on its rows.  While :func:`rows_of_global` is active (the
Estimator holds it over a step's forward and backward):

- :func:`rand` draws uniforms for the global batch from the step's
  generator and keeps this rank's rows, so dp=N draws what dp=1 draws;
- :func:`global_sums` all-reduces a layer's f32 sums with
  ``torch.distributed.nn.functional.all_reduce``, which has a gradient
  (BatchNorm's global statistics).

Outside it (one rank, evaluation, serving) both act on the local batch
alone.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_STATE = threading.local()


class RowShare:
    """This rank's share of a global batch: block ``index`` of ``count``
    equal blocks along dim 0, and the group the batch is split over."""

    def __init__(self, index: int, count: int, group):
        self.index, self.count, self.group = index, count, group


@contextlib.contextmanager
def rows_of_global(index: int, count: int, group):
    """Mark this thread's layers as running rows ``index`` of ``count``
    of a global batch (``count`` 1: a no-op)."""
    old = getattr(_STATE, "share", None)
    _STATE.share = RowShare(index, count, group) if count > 1 else None
    try:
        yield
    finally:
        _STATE.share = old


def current() -> Optional[RowShare]:
    return getattr(_STATE, "share", None)


def rand(shape, generator: torch.Generator, device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``; under a row share the
    global batch's draw (dim 0 times the share count), this rank's rows
    kept."""
    share = current()
    shape = tuple(shape)
    if share is None or not shape:
        return torch.rand(shape, generator=generator, device=device)
    n = shape[0]
    full = torch.rand((n * share.count,) + shape[1:], generator=generator,
                      device=device)
    return full[share.index * n:(share.index + 1) * n]


def global_sums(sums: torch.Tensor) -> torch.Tensor:
    """``sums`` added over the ranks of the share's group (as they are
    without one), differentiably."""
    share = current()
    if share is None:
        return sums
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(sums, group=share.group)


def global_count(n: int) -> int:
    """The rows of the global batch of which this rank holds ``n``."""
    share = current()
    return n if share is None else n * share.count
