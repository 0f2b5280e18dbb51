"""Device meshes over ``torch.distributed``: the port of
``analytics_zoo_tpu/parallel/mesh.py``.

The reference lays a ``jax.sharding.Mesh`` over the chips of one
program.  The port runs one process per rank, as PyTorch users launch it
(``torchrun``, or ``torch.multiprocessing`` in tests), and lays a
:class:`Mesh` over the ranks of the process group: named axes in the
reference's canonical order, built on
``torch.distributed.device_mesh.init_device_mesh``, with one process
group per axis for the collectives of the code that runs on each rank.
There is no ``shard_map``: per-rank code is PyTorch's idiom.

The collective backend follows the layout (:func:`choose_backend`): NCCL
where every rank has a card of its own, gloo on the CPU and where ranks
share a card (NCCL refuses two ranks on one device).  The choice is
printed when the process group starts; nothing falls back silently.
Several ranks on one card check the code and the per-rank kernels, not
their speed.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

# Canonical axis order: batch-like axes outermost, model axes last (the
# reference's: later axes get the fastest links).
CANONICAL_AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# the control plane (tensor-parallel serving's tick messages) may idle
# as long as a server waits for its next request
CONTROL_TIMEOUT = timedelta(days=7)


def resolve_axis_sizes(axes: Dict[str, int], n_devices: int
                       ) -> Dict[str, int]:
    """Resolve -1 ("fill") entries so that prod(sizes) == n_devices.

    At most one -1 is allowed.  Fixed axes must divide n_devices."""
    fills = [k for k, v in axes.items() if v == -1]
    if len(fills) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {fills}")
    fixed = math.prod(v for v in axes.values() if v != -1)
    if fills:
        if n_devices % fixed != 0:
            raise ValueError(
                f"Fixed mesh axes {axes} (product {fixed}) do not divide "
                f"device count {n_devices}")
        resolved = dict(axes)
        resolved[fills[0]] = n_devices // fixed
        return resolved
    if fixed != n_devices:
        raise ValueError(
            f"Mesh axes {axes} (product {fixed}) != device count {n_devices}")
    return dict(axes)


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` (set by
    ``torchrun``), else its global rank."""
    return int(os.environ.get("LOCAL_RANK", world()[0]))


def local_world_size() -> int:
    """The number of ranks on this host: ``LOCAL_WORLD_SIZE``, else the
    world size."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world()[1]))


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK``, or the shared card
    (``cuda:LOCAL_RANK % cards``) when the host has fewer cards than
    ranks; an explicit ``device`` of another type (``"cpu"``) as is."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "ranks on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def choose_backend(device) -> str:
    """``"nccl"`` where every rank of this host has a card of its own,
    ``"gloo"`` on the CPU and where ranks share a card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_world_size() \
        else "gloo"


def describe_backend(backend: str, device) -> str:
    rank, size = world()
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    where = ("the CPU" if dev.type != "cuda" else
             f"{cards} card(s) for {local_world_size()} local rank(s)")
    why = ("ranks share a card: NCCL refuses that" if backend == "gloo"
           and dev.type == "cuda" else "one card a rank"
           if backend == "nccl" else "CPU tensors")
    return (f"mesh: backend {backend} ({why}); rank {rank} of {size} on "
            f"{dev}, {where}")


def init_distributed(device=None, *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> str:
    """Start the default process group once, from the launcher's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them) unless ``init_method``,
    ``rank`` and ``world_size`` say otherwise, with the backend
    :func:`choose_backend` gives this rank's device.  Prints the backend
    and why; returns it.  A group already running is kept (its backend
    is returned)."""
    if dist.is_initialized():
        return dist.get_backend()
    dev = rank_device(device) if device is None or \
        torch.device(device).type == "cuda" else torch.device(device)
    backend = choose_backend(dev)
    kw = {}
    if rank is not None:
        kw["rank"] = int(rank)
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kw)
    print(describe_backend(backend, dev), flush=True)
    return backend


class Mesh:
    """Named axes over the ranks of the process group.

    ``shape`` maps each axis name to its size, in the canonical order
    (``axis_names``); the ranks are laid out row-major over it, as
    ``init_device_mesh`` lays them.  ``device`` is this rank's device.
    :meth:`size`, :meth:`coord` and :meth:`group` give an axis's size,
    this rank's coordinate on it and its process group (``None`` for an
    axis of size 1: no collective runs there).  A mesh whose every axis
    is 1 needs no process group (:func:`single_device_mesh`)."""

    def __init__(self, sizes: Dict[str, int], device, device_mesh=None):
        self.axis_names: Tuple[str, ...] = tuple(sizes)
        self.shape: Dict[str, int] = dict(sizes)
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self._groups: Dict[Tuple[str, int], object] = {}
        self._control: Dict[int, object] = {}
        # what this rank's engine on each lane keeps beside its groups
        # (a serving engine's parked handoff shards), by lane
        self.lane_boxes: Dict[int, object] = {}

    @property
    def devices(self) -> int:
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        return world()[0] if self.devices > 1 else 0

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate on every axis."""
        out = {}
        for name in reversed(self.axis_names):
            out[name] = rank % self.shape[name]
            rank //= self.shape[name]
        return {n: out[n] for n in self.axis_names}

    def coord(self, axis: str) -> int:
        if self.size(axis) == 1:
            return 0
        return self.coords(self.rank)[axis]

    def group(self, axis: str, lane: int = 0):
        """The process group of this rank's line along ``axis`` (None
        when the axis has size 1 or is not in the mesh).  ``lane`` 0 is
        the device mesh's own group; each other lane is a group of its
        own over the same ranks, made at its first request (a
        collective over the world: every rank asks for the same lanes in
        the same order), so that several engines on one rank run their
        collectives apart."""
        if self.size(axis) == 1:
            return None
        if (axis, lane) not in self._groups:
            if lane == 0:
                group = self.device_mesh.get_group(axis)
            else:
                group = self._new_groups(axis, None)
            self._groups[(axis, lane)] = group
        return self._groups[(axis, lane)]

    def group_ranks(self, axis: str, rank: Optional[int] = None
                    ) -> Tuple[int, ...]:
        """The global ranks of ``rank``'s (this rank's) line along
        ``axis``, in axis order (the first is the line's leader)."""
        me = self.coords(self.rank if rank is None else rank)
        out = []
        for rank in range(self.devices):
            c = self.coords(rank)
            if all(c[a] == me[a] for a in self.axis_names if a != axis):
                out.append(rank)
        return tuple(out)

    def _new_groups(self, axis: Optional[str], backend, **kw):
        """A new group for every line along ``axis`` (every rank of the
        mesh for ``None``), made on every rank in the same order (group
        creation is collective over the world); returns this rank's."""
        lines = []
        for rank in range(self.devices):
            line = self.group_ranks(axis, rank) if axis is not None \
                else tuple(range(self.devices))
            if line not in lines:
                lines.append(line)
        mine = self.group_ranks(axis) if axis is not None \
            else tuple(range(self.devices))
        out = None
        for line in lines:
            group = dist.new_group(list(line), backend=backend, **kw)
            if line == mine:
                out = group
        return out

    def control_group(self, lane: int = 0):
        """A gloo group over every rank of the mesh for host messages
        (``broadcast_object_list``), whatever the data backend, with a
        long timeout: a server's ranks wait on it while the server
        idles.  One group a ``lane`` (an engine's: several engines on
        one rank each take their own), made at its first request; every
        rank must ask for the same lanes at the same points (group
        creation is collective over the whole world).  None on a mesh
        of one rank."""
        if self.devices == 1:
            return None
        if lane not in self._control:
            self._control[lane] = self._new_groups(
                None, "gloo", timeout=CONTROL_TIMEOUT)
        return self._control[lane]

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(config=None, *, axes: Optional[Dict[str, int]] = None,
              device=None) -> Mesh:
    """A :class:`Mesh` from a config with ``axes`` (or an explicit axis
    dict) over the ranks of the process group (one rank without one).
    Axes are ordered canonically (:data:`CANONICAL_AXES`; unknown names
    last); size-1 axes stay, so rules naming them stay valid.
    ``device`` is this rank's device (default :func:`rank_device`)."""
    if axes is None:
        axes = getattr(config, "axes", None) or {"dp": -1}
    _, size = world()
    sizes = resolve_axis_sizes(dict(axes), size)
    names = sorted(sizes, key=lambda n: CANONICAL_AXES.index(n)
                   if n in CANONICAL_AXES else len(CANONICAL_AXES))
    ordered = {n: sizes[n] for n in names}
    dev = rank_device(device)
    if size == 1:
        return Mesh(ordered, dev)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, tuple(ordered.values()),
                          mesh_dim_names=tuple(ordered))
    return Mesh(ordered, dev, dm)


def single_device_mesh(axis: str = "dp", device=None) -> Mesh:
    """A one-rank mesh (no process group needed)."""
    return Mesh({axis: 1}, rank_device(device))


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes over which the batch dim is sharded (dp-like axes present)."""
    return tuple(a for a in ("dp", "fsdp") if a in mesh.axis_names)


def mesh_batch_size(mesh: Mesh) -> int:
    return int(math.prod(mesh.shape[a] for a in batch_axes(mesh)) or 1)
