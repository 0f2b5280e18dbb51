"""Collectives with gradients: the conjugate operators of tensor- and
sequence-parallel training.

The reference writes one global program and lets XLA insert the
collectives and their transposes.  The port runs one process a rank, so
each layer calls its collectives itself, and each must carry the right
backward.  ``torch.distributed``'s own collectives have no gradient, and
``torch.distributed.nn.functional.all_reduce`` all-reduces its gradient
in backward, which is right only where each rank's loss is its own term
(a data-parallel rank's rows): under tensor parallelism every rank
computes the same loss, and that backward multiplies a gradient by the
axis size.  So the operators here are ``torch.autograd.Function`` s of
their own, in Megatron's conjugate pairs:

- :func:`copy_to` (Megatron's *f*): identity forward, all-reduce
  backward.  The input of a column-parallel layer: each rank's shard of
  the output sends back only its part of the input's gradient;
- :func:`reduce_from` (*g*): all-reduce forward, identity backward.  The
  output of a row-parallel layer, a vocab-split lookup;
- :func:`gather_from`: all-gather forward, this rank's slice backward.
  A vocab-split head's logits; a column-parallel output a replicated
  layer reads;
- :func:`scatter_to`: this rank's slice forward, all-gather backward.  A
  replicated tensor a split layer reads a part of.

The sequence axis (``sp``) has its own pair, under one gradient
convention, stated once here and kept by every layer:

  **Every sp rank computes the same loss.  The sequence is split by a
  plain slice (whose backward pads with zeros), gathered by**
  :func:`gather_seq` **, whose backward is a reduce-scatter (each rank's
  slice of the SUM of the ranks' gradients), and every parameter's
  gradient is averaged over dp x sp** (the Estimator all-reduces it over
  both lines and divides by their product).

Under it, a parameter used before the gather (the embeddings, every
layer) holds on each sp rank its slice's share of the gradient times
sp, and a parameter used after it (a pooler, a classifier, an LM head)
holds the whole gradient on every rank: the average over sp is the
gradient of the one global loss in both cases, so nothing after the
gather is counted sp times.  A model that does not split the sequence
computes the same gradient on every sp rank, and the average leaves it
as it is.

:func:`shift` moves a tensor one step around the sp ring (rank i sends
to i+1), and its backward is the reverse shift; :func:`all_to_all` (the
ulysses exchange) has the inverse exchange as its backward.

Every operator is the plain collective, with no autograd node, when
gradients are off (``torch.no_grad``/``torch.inference_mode``: serving
and evaluation), and the identity on an axis of size 1.  On the gloo
backend a CUDA tensor (several ranks on one card) goes through host
memory for the point-to-point and all-to-all exchanges, which gloo does
not run on a device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


class Line:
    """This rank's line along one mesh axis: its process ``group`` (None
    for an axis of size 1), its ``index`` on the axis, the axis ``size``
    and the global ``ranks`` of the line in axis order."""

    __slots__ = ("group", "index", "size", "ranks", "axis")

    def __init__(self, group, index: int, size: int,
                 ranks: Tuple[int, ...], axis: str = ""):
        self.group, self.index, self.size = group, int(index), int(size)
        self.ranks, self.axis = tuple(ranks), axis

    @classmethod
    def of(cls, mesh, axis: str) -> "Line":
        """``mesh``'s line along ``axis`` through this rank (size 1 when
        the mesh lacks the axis)."""
        if mesh is None or mesh.size(axis) == 1:
            return cls(None, 0, 1, (0,), axis)
        return cls(mesh.group(axis), mesh.coord(axis), mesh.size(axis),
                   mesh.group_ranks(axis), axis)

    def __repr__(self):
        return f"Line({self.axis!r}, {self.index} of {self.size})"


def _grad_on(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce(x, line: Line):
    dist.all_reduce(x, group=line.group)
    return x


def _all_gather(x, line: Line, dim: int):
    parts = [torch.empty_like(x) for _ in range(line.size)]
    dist.all_gather(parts, x.contiguous(), group=line.group)
    return torch.cat(parts, dim=dim)


def _slice(x, line: Line, dim: int):
    n = x.shape[dim]
    if n % line.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"into {line.size} shards over {line.axis!r}")
    step = n // line.size
    return x.narrow(dim, line.index * step, step).contiguous()


def _staged(x, line: Line):
    """``x`` where the line's backend can exchange it point to point:
    host memory for a CUDA tensor on gloo."""
    if x.is_cuda and dist.get_backend(line.group) == "gloo":
        return x.cpu()
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.line), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        return _all_reduce(x.contiguous().clone(), line)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _all_gather(x, line, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.line, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _slice(x, line, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.line, ctx.dim), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _all_gather(x, line, dim)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter: this rank's slice of the ranks' summed gradient
        return _slice(_all_reduce(g.contiguous().clone(), ctx.line),
                      ctx.line, ctx.dim), None, None


def _shift(x, line: Line, step: int):
    """``x`` of the rank ``step`` places before this one on the ring
    (each rank sends its own ``step`` places on)."""
    me = line.index
    dst = line.ranks[(me + step) % line.size]
    src = line.ranks[(me - step) % line.size]
    send = _staged(x.contiguous(), line)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, line.group),
           dist.P2POp(dist.irecv, recv, src, line.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return _shift(x, line, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.line, -1), None


def _exchange(x, line: Line, split: int, concat: int):
    """The all-to-all: ``x`` cut into ``size`` pieces along ``split``,
    piece j sent to rank j, the pieces received concatenated along
    ``concat`` in rank order."""
    n = line.size
    parts = [p.contiguous() for p in x.chunk(n, dim=split)]
    send = _staged(torch.stack(parts), line)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=line.group)
    recv = recv.to(x.device)
    return torch.cat(list(recv.unbind(0)), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, split, concat):
        ctx.line, ctx.split, ctx.concat = line, split, concat
        return _exchange(x, line, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.line, ctx.concat, ctx.split), None, None, \
            None


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

def copy_to(x, line: Optional[Line]):
    """Identity forward, all-reduce over ``line`` backward (Megatron's
    *f*): the input of a column-parallel layer."""
    if line is None or line.size == 1 or not _grad_on(x):
        return x
    return _CopyTo.apply(x, line)


def reduce_from(x, line: Optional[Line]):
    """All-reduce (sum) over ``line`` forward, identity backward
    (Megatron's *g*): a row-parallel layer's partial products.  Without
    gradients, ``x`` is reduced in place and returned."""
    if line is None or line.size == 1:
        return x
    if not _grad_on(x):
        return _all_reduce(x, line)
    return _ReduceFrom.apply(x, line)


def gather_from(x, line: Optional[Line], dim: int):
    """All-gather along ``dim`` over ``line`` forward, this rank's slice
    backward."""
    if line is None or line.size == 1:
        return x
    if not _grad_on(x):
        return _all_gather(x, line, dim)
    return _GatherFrom.apply(x, line, dim)


def scatter_to(x, line: Optional[Line], dim: int):
    """This rank's slice along ``dim`` forward, all-gather backward: a
    replicated tensor of which this rank reads its part."""
    if line is None or line.size == 1:
        return x
    if not _grad_on(x):
        return _slice(x, line, dim)
    return _ScatterTo.apply(x, line, dim)


def split_seq(x, line: Optional[Line], dim: int = 1):
    """This rank's slice of the sequence (a plain slice, contiguous: its
    backward pads with zeros, the sp convention above)."""
    if line is None or line.size == 1:
        return x
    return _slice(x, line, dim)


def gather_seq(x, line: Optional[Line], dim: int = 1):
    """The whole sequence from every sp rank's slice: all-gather
    forward, reduce-scatter backward (the sp convention above)."""
    if line is None or line.size == 1:
        return x
    if not _grad_on(x):
        return _all_gather(x, line, dim)
    return _GatherSeq.apply(x, line, dim)


def shift(x, line: Line):
    """The tensor of the previous rank on the ``line`` ring (each rank
    sends its own to the next); backward shifts the gradient back."""
    if line.size == 1:
        return x
    if not _grad_on(x):
        return _shift(x, line, 1)
    return _Shift.apply(x, line)


def all_to_all(x, line: Line, split: int, concat: int):
    """The ulysses exchange over ``line``: piece j of ``x`` along
    ``split`` to rank j, received pieces concatenated along ``concat``;
    backward is the inverse exchange."""
    if line.size == 1:
        return x
    if not _grad_on(x):
        return _exchange(x, line, split, concat)
    return _AllToAll.apply(x, line, split, concat)
