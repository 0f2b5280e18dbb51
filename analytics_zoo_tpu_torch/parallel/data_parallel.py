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
  under :func:`seq_of_global` too (a sequence-parallel model's layers,
  which hold their chunk of dim 1), the global sequence's draw with this
  rank's chunk kept, so sp=N draws what sp=1 does.  A tensor-parallel
  layer's dropout acts on whole (replicated) activations, whose mask is
  the global one already;
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


@contextlib.contextmanager
def seq_of_global(index: int, count: int):
    """Mark this thread's layers as holding chunk ``index`` of ``count``
    of the global sequence along dim 1 (``count`` 1: a no-op)."""
    old = getattr(_STATE, "seq", None)
    _STATE.seq = (index, count) if count > 1 else None
    try:
        yield
    finally:
        _STATE.seq = old


def current_seq():
    """``(index, count)`` of this thread's sequence chunk, or None."""
    return getattr(_STATE, "seq", None)


def rand(shape, generator: torch.Generator, device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``; under a row share the
    global batch's draw (dim 0 times the share count), this rank's rows
    kept, and under a sequence share the global sequence's (dim 1 times
    its count), this rank's chunk kept."""
    share = current()
    seq = getattr(_STATE, "seq", None)
    shape = tuple(shape)
    if (share is None and seq is None) or not shape:
        return torch.rand(shape, generator=generator, device=device)
    full = list(shape)
    if share is not None:
        full[0] *= share.count
    if seq is not None:
        full[1] *= seq[1]
    out = torch.rand(tuple(full), generator=generator, device=device)
    if share is not None:
        n = shape[0]
        out = out[share.index * n:(share.index + 1) * n]
    if seq is not None:
        t = shape[1]
        out = out[:, seq[0] * t:(seq[0] + 1) * t]
    return out


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


def broadcast_start(tensors) -> None:
    """Give every rank rank 0's values of ``tensors`` IN PLACE (a
    model's parameters and buffers before training): one broadcast a
    dtype, of the tensors packed flat."""
    import torch.distributed as dist

    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, 0)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def average_grads(params, groups, count: int) -> None:
    """Replace each of ``params``' gradients by its sum over every
    process group in ``groups`` (None entries skipped), divided by
    ``count``: one coalesced all_reduce a group, in f32, or f64 where a
    gradient is (a missing gradient counts as zeros)."""
    import functools

    import torch.distributed as dist

    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    acc = functools.reduce(torch.promote_types, (g.dtype for g in grads),
                           torch.float32)
    flat = torch.cat([g.reshape(-1).to(acc) for g in grads])
    for group in groups:
        if group is not None:
            dist.all_reduce(flat, group=group)
    flat /= count
    off = 0
    for p, g in zip(params, grads):
        p.grad = flat[off:off + g.numel()].view_as(g).to(g.dtype)
        off += g.numel()


def mean_over(values, group, count: int):
    """Each scalar of the dict ``values`` averaged over the ``count``
    ranks of ``group`` (one all_reduce), as f32 scalars."""
    import torch.distributed as dist

    names = list(values)
    flat = torch.stack([values[k].detach().float().reshape(())
                        for k in names])
    dist.all_reduce(flat, group=group)
    flat /= count
    return dict(zip(names, flat))
