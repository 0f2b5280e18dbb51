"""Partition rules: regex path -> placement, and the helpers that cut a
tensor into a rank's shard and gather it back.  The port of
``analytics_zoo_tpu/parallel/partition.py``.

A placement (:class:`P`, the reference's ``PartitionSpec``) says, dim
by dim, which mesh axis a tensor is split over (``None``: whole on
every rank).  :func:`match_partition_rules` maps a tree of tensors (a
nested dict with ``/`` paths, as a flax tree, or a flat ``state_dict``)
to placements, first matching rule wins, with the reference's
divisibility fallback: a dim a rule splits over an axis it does not
divide stays whole.  In the port each rank holds only its shard
(:func:`shard_tensor`); :func:`gather_tensor` rebuilds the whole tensor.

:func:`shard_module` cuts a module's parameters to this rank's shards
under rules written for the reference's tree: each port parameter is
matched by its flax path and shape (``learn.lora.flax_path``,
``models.layers.flax_leaf``), and a split of the reference's leaf maps
onto the port tensor's dim (:func:`param_placements`).  A module that
runs its own sharded layers (``BERT``, ``TransformerLM``: Megatron's
column- and row-parallel layers) takes its placements through its
``tp_shard`` method; an ``nn.Embedding`` split on its rows becomes a
vocab-parallel lookup; any other split raises.

Data-parallel is the default (:data:`DP_RULES`: everything replicated,
the batch split over the dp-like axes).  :data:`FSDP_RULES` is named
for the reference's ZeRO layout; passing it raises
``NotImplementedError`` (ROADMAP Queue 1 item 6.1).
"""

from __future__ import annotations

import math
import re
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from analytics_zoo_tpu_torch.parallel import collectives as cc
from analytics_zoo_tpu_torch.parallel.mesh import (Mesh, batch_axes,
                                                   mesh_batch_size)


class P(tuple):
    """A placement: one entry a dim, ``None`` (whole) or a mesh axis
    name (or a tuple of names) the dim is split over."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


PartitionRules = Sequence[Tuple[str, P]]

# plain data-parallel: every parameter replicated
DP_RULES: PartitionRules = ((".*", P()),)

# the reference's ZeRO layout (every sizable tensor's leading dim over
# ``fsdp``): named for parity, not ported
FSDP_RULES: PartitionRules = ((r".*", P("fsdp")),)

_FSDP_ITEM = "ROADMAP Queue 1 item 6.1 (FSDP)"


def check_rules(rules: PartitionRules) -> None:
    """Raise for rules the port does not run: any placement on the
    ``fsdp`` axis (FSDP is not ported)."""
    for _, spec in rules:
        for entry in spec:
            names = entry if isinstance(entry, tuple) else (entry,)
            if "fsdp" in names:
                raise NotImplementedError(
                    f"partition rules placing tensors on 'fsdp' (FSDP_RULES)"
                    f" are not ported ({_FSDP_ITEM})")


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _valid_spec(spec: P, shape, mesh: Optional[Mesh]) -> P:
    """Drop spec entries that do not divide the tensor's shape (or exceed
    its rank), and entries naming axes the mesh lacks: one rule set
    serves many layer sizes, a dim that does not divide stays whole."""
    if len(spec) > len(shape):
        spec = P(*spec[:len(shape)])
    if mesh is None:
        return spec
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) *
                          (len(shape) - len(spec))):
        names = _names(entry)
        if not names or any(n not in mesh.shape for n in names):
            out.append(None)
            continue
        size = math.prod(mesh.shape[n] for n in names)
        out.append(entry if dim % size == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _map_tree(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def match_partition_rules(rules: PartitionRules, tree: Any,
                          mesh: Optional[Mesh] = None) -> Any:
    """The tree of placements for a tree of tensors (anything with a
    ``shape``) under ``rules``: scalars and one-element tensors are
    replicated; the first rule whose regex ``re.search``-matches a
    leaf's path wins; a leaf matching none is replicated.  Nested dict
    keys join with ``/``; a flat dict's keys are paths as they are."""
    check_rules(rules)

    def spec_for(name, leaf) -> P:
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or math.prod(shape) <= 1:
            return P()
        for pattern, spec in rules:
            if re.search(pattern, name):
                return _valid_spec(spec, shape, mesh)
        return P()

    return _map_tree(spec_for, tree)


class Placement:
    """A tensor's placement on a mesh (the reference's
    ``NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self):
        return f"Placement({self.spec})"


def data_sharding(mesh: Mesh, *, extra_batch_axes: Sequence[str] = ()
                  ) -> Placement:
    """The placement of a batch: the leading dim split over every
    dp-like axis of the mesh (and ``extra_batch_axes``)."""
    axes = tuple(batch_axes(mesh))
    axes += tuple(a for a in extra_batch_axes
                  if a in mesh.axis_names and a not in axes)
    return Placement(mesh, P(axes if axes else None))


def state_sharding(mesh: Mesh, state: Any,
                   rules: PartitionRules = DP_RULES) -> Any:
    """The placement tree of a parameter tree under ``rules``."""
    specs = match_partition_rules(rules, state, mesh)
    return _map_tree(lambda _, s: Placement(mesh, s), specs)


def data_process_groups(sharding: Placement):
    """Group processes by the rows of a batch they hold under
    ``sharding``: ``(n_groups, my_group, group_of_process)``.

    Each rank is a process in the port.  The batch is split over the
    placement's batch axes, so the ranks that share a coordinate on
    those axes hold the same rows (a group, fed identical data) and
    ranks of different groups hold disjoint rows.  Groups are ordered
    by the first row block they hold.  Data loaders split datasets
    across groups (one shard a group, replicated within it)."""
    mesh = sharding.mesh
    axes = [n for e in sharding.spec[:1] for n in _names(e)]
    n_ranks = mesh.devices

    def block(rank):
        c = mesh.coords(rank)
        b = 0
        for a in axes:
            b = b * mesh.shape[a] + c[a]
        return b

    gop = [block(r) for r in range(n_ranks)]
    n_groups = max(1, math.prod(mesh.shape[a] for a in axes))
    return n_groups, gop[mesh.rank], gop


def _spec_dims(spec: P, ndim: int):
    """(dim, axis names) of every split dim of a placement."""
    return [(d, _names(e)) for d, e in enumerate(tuple(spec)[:ndim])
            if _names(e)]


def _dim_index(mesh: Mesh, names) -> Tuple[int, int]:
    """This rank's shard index along a dim split over ``names`` (the
    first name outermost), and the number of shards."""
    idx, n = 0, 1
    for a in names:
        idx = idx * mesh.size(a) + mesh.coord(a)
        n *= mesh.size(a)
    return idx, n


def shard_tensor(full: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under placement ``spec``: each split
    dim cut into equal contiguous pieces, the rank's piece kept (a
    contiguous copy)."""
    out = full
    for dim, names in _spec_dims(spec, full.dim()):
        idx, n = _dim_index(mesh, names)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide into {n} shards over {names}")
        out = out.chunk(n, dim=dim)[idx]
    return out.contiguous()


def gather_tensor(local: torch.Tensor, spec: P, mesh: Mesh
                  ) -> torch.Tensor:
    """The whole tensor from every rank's shard under placement
    ``spec``: an all_gather a split axis, innermost first."""
    out = local
    for dim, names in reversed(_spec_dims(spec, local.dim())):
        for a in reversed(names):
            n = mesh.size(a)
            if n == 1:
                continue
            parts = [torch.empty_like(out) for _ in range(n)]
            dist.all_gather(parts, out.contiguous(), group=mesh.group(a))
            out = torch.cat(parts, dim=dim)
    return out


def batch_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of an ``n``-row global batch split over the
    mesh's batch axes (contiguous blocks in rank order); raises when
    they do not divide ``n``."""
    nb = mesh_batch_size(mesh)
    if n % nb:
        raise ValueError(f"global batch {n} must be positive and "
                         f"divisible by data-shard group count {nb}")
    _, my_group, _ = data_process_groups(data_sharding(mesh))
    per = n // nb
    return slice(my_group * per, (my_group + 1) * per)


# ---------------------------------------------------------------------------
# a module's parameters under rules: placements in the port's layout, and
# each rank's shards
# ---------------------------------------------------------------------------

def _leaf_groups(leaf):
    """The reference leaf's dims grouped as the port's folded dims take
    them (consecutive dims whose product is one folded dim)."""
    groups, i = [], 0
    for size in leaf.folded:
        group, prod = [], 1
        while i < len(leaf.shape) and (prod < size or not group):
            prod *= leaf.shape[i]
            group.append(i)
            i += 1
        groups.append(group)
    return groups


def port_spec(spec: P, leaf, name: str = "") -> P:
    """A placement of the reference's leaf (``models.layers.FlaxLeaf``)
    as a placement of the port tensor: a split leaf dim must lead its
    folded group (a head axis folded with the head dim splits into
    whole heads, contiguous in the port tensor)."""
    groups = _leaf_groups(leaf)
    out = [None] * len(leaf.perm)
    for d, entry in enumerate(tuple(spec)):
        if not _names(entry):
            continue
        g = next(j for j, grp in enumerate(groups) if d in grp)
        if groups[g][0] != d:
            raise NotImplementedError(
                f"{name}: placement {spec} splits dim {d} of the "
                f"reference's {leaf.shape}, which the port folds inside "
                f"another dim (ROADMAP Queue 1 item 6.6)")
        out[leaf.perm.index(g)] = entry
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def param_placements(model, rules: PartitionRules, mesh: Optional[Mesh]
                     ) -> dict:
    """``{name: placement}`` of every parameter of ``model`` under
    ``rules`` (written for the reference's tree), in the port tensor's
    dims, with the divisibility fallback on the reference's shapes."""
    from analytics_zoo_tpu_torch.learn.lora import flax_path
    from analytics_zoo_tpu_torch.models.layers import flax_leaf

    check_rules(rules)
    out = {}
    for name, _ in model.named_parameters():
        leaf = flax_leaf(model, name)
        spec = match_partition_rules(
            rules, {flax_path(model, name): leaf}, mesh)
        out[name] = port_spec(next(iter(spec.values())), leaf, name)
    return out


def vocab_lookup(weight, ids, line: cc.Line):
    """The rows of ``ids`` in a table split on its rows over the tp
    ``line`` (``weight``: this rank's rows ``[index*n, (index+1)*n)``):
    ids outside them read 0, and the partial lookups are summed over the
    line (``collectives.reduce_from``: each id's row comes from one
    rank, so the sum adds exact zeros)."""
    import torch.nn.functional as F

    n = weight.shape[0]
    local = ids - line.index * n
    ok = (local >= 0) & (local < n)
    x = F.embedding(torch.where(ok, local, torch.zeros_like(local)), weight)
    return cc.reduce_from(x * ok[..., None].to(x.dtype), line)


class _VocabSplit:
    """An ``nn.Embedding`` holding its rows of the table on a tp line,
    looked up by :func:`vocab_lookup`."""

    def forward(self, ids):
        return vocab_lookup(self.weight, ids, self.tp_line)


def tp_dim(placements: dict, name: str, allowed=()) -> Optional[int]:
    """The port dim of parameter ``name`` that ``placements`` split over
    ``tp`` (None: whole).  A split of more than one dim, over another
    axis, or of a dim not in ``allowed`` raises: the port trains
    Megatron's layout (column-parallel outputs, row-parallel inputs,
    vocab-split tables) and nothing else."""
    spec = tuple(placements.get(name, ()))
    dims = [d for d, e in enumerate(spec) if _names(e)]
    if not dims:
        return None
    if len(dims) > 1 or _names(spec[dims[0]]) != ("tp",) or \
            dims[0] not in allowed:
        raise NotImplementedError(
            f"{name}: placement {P(*spec)} is not one the port shards (the "
            f"Megatron layout over 'tp': column-parallel outputs, "
            f"row-parallel inputs, vocab-split tables; other placements "
            f"are ROADMAP Queue 1 item 6.6)")
    return dims[0]


def cut_param(module, attr: str, mesh: Mesh, dim: int) -> Optional[P]:
    """Replace ``module.attr`` (a parameter, or None) IN PLACE by this
    rank's shard of it along ``dim`` over ``mesh``'s ``tp`` axis, and
    return its placement (None when there is no parameter)."""
    import torch.nn as nn

    t = getattr(module, attr)
    if t is None:
        return None
    spec = P(*([None] * dim + ["tp"]))
    piece = shard_tensor(t.detach(), spec, mesh)
    setattr(module, attr, nn.Parameter(piece.clone(),
                                       requires_grad=t.requires_grad))
    return spec


def cut_params(module, mesh: Mesh, dims: dict) -> dict:
    """:func:`cut_param` for each parameter ``name`` (a dotted path
    under ``module``) of ``dims`` along its dim; returns the placements
    of those cut, keyed by their names."""
    out = {}
    for name, dim in dims.items():
        owner, _, attr = name.rpartition(".")
        spec = cut_param(module.get_submodule(owner), attr, mesh, dim)
        if spec is not None:
            out[name] = spec
    return out


def vocab_split(emb, mesh: Mesh) -> P:
    """Make the ``nn.Embedding`` ``emb`` vocab-parallel IN PLACE over
    ``mesh``'s ``tp`` axis: it keeps this rank's rows and looks ids up
    as :class:`_VocabSplit` does.  Returns the table's placement."""
    spec = cut_param(emb, "weight", mesh, 0)
    emb.tp_line = cc.Line.of(mesh, "tp")
    emb.__class__ = type(f"VocabSplit{type(emb).__name__}",
                         (_VocabSplit, type(emb)), {})
    return spec


def _split_axes(spec: P):
    return {n for e in spec for n in _names(e)}


def shard_module(model, mesh: Mesh, rules: PartitionRules) -> dict:
    """Cut ``model``'s parameters IN PLACE to this rank's shards under
    ``rules`` (the reference's partition rules), and return the
    placement of every parameter that was cut, in the port's layout.

    The rules are matched once (:func:`param_placements`: the
    divisibility fallback has left whole every dim the axes do not
    divide).  A submodule with a ``tp_shard(mesh, placements)`` method
    (placements keyed by its own parameter names) shards itself and
    returns the placements of what it cut (a column-parallel layer's
    bias is cut with its weight); an ``nn.Embedding`` split on its rows
    over ``tp`` becomes a vocab-parallel lookup; a split of anything
    else, or over another axis than ``tp``, raises
    ``NotImplementedError``."""
    import torch.nn as nn

    placements = param_placements(model, rules, mesh)
    cut, done = {}, set()
    for prefix, mod in model.named_modules():
        if any(d == "" or prefix == d or prefix.startswith(d + ".")
               for d in done):
            continue
        pre = prefix + "." if prefix else ""
        own = {n[len(pre):]: s for n, s in placements.items()
               if n.startswith(pre)}
        if hasattr(mod, "tp_shard"):
            cut.update({pre + n: s
                        for n, s in mod.tp_shard(mesh, own).items()})
            done.add(prefix)
            continue
        for attr, p in list(mod.named_parameters(recurse=False)):
            spec = own[attr]
            axes = _split_axes(spec)
            if not axes:
                continue
            if isinstance(mod, nn.Embedding) and attr == "weight" and \
                    tuple(spec) == ("tp",):
                cut[pre + attr] = vocab_split(mod, mesh)
                continue
            raise NotImplementedError(
                f"{pre + attr}: placement {spec} over {sorted(axes)} is not "
                f"one the port trains on {type(mod).__name__} (a row split "
                f"of an embedding table, or a module with its own "
                f"tp_shard; ROADMAP Queue 1 item 6.6)")
    return cut


def gather_state(state: dict, placements: dict, mesh: Mesh) -> dict:
    """A ``state_dict`` of shards as whole tensors (each placed tensor
    gathered over its axes; the rest as they are)."""
    return {k: gather_tensor(v, placements[k], mesh) if k in placements
            else v for k, v in state.items()}


def shard_state(state: dict, placements: dict, mesh: Mesh) -> dict:
    """A ``state_dict`` of whole tensors cut to this rank's shards."""
    return {k: shard_tensor(torch.as_tensor(v), placements[k], mesh)
            if k in placements else v for k, v in state.items()}
