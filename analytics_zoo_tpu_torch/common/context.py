"""Context bootstrap: the port of ``analytics_zoo_tpu/common/context.py``.

``init_orca_context(cluster_mode, device=None, mesh_axes=None)``
installs a process-wide :class:`ZooContext` holding this rank's device
and a :class:`~analytics_zoo_tpu_torch.parallel.mesh.Mesh`:

- ``"local"``: this process alone (one rank, every mesh axis 1), or
  the ranks of a process group the caller already started; the device
  is ``resolve_device(device)``: CUDA unless the caller names another
  (``device="cpu"`` on a host without one), raising without CUDA as
  every entry point does;
- ``"multihost"`` / ``"distributed"`` / ``"tpu-pod"``: one process a
  rank, started by a launcher (``torchrun``): the default process group
  from the launcher's environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``; explicit ``coordinator_address``
  (``host:port``), ``num_processes`` and ``process_id`` win, then the
  ``ZOO_*`` variables), with the collective backend chosen by layout
  and printed (``parallel.mesh.choose_backend``); each rank's device is
  ``cuda:LOCAL_RANK``, or the shared card when there are fewer cards
  than ranks.

``mesh_axes`` (default ``{"dp": -1}``) lays the mesh over the ranks;
a training mesh takes ``dp``, ``sp`` and ``tp`` together (``{"dp": 2,
"sp": 2, "tp": 2}`` on eight ranks), and the Estimator trains on the
context's mesh when it is given none.  While a context is up,
``device.resolve_device(None)`` returns its device, so an entry point
that takes no ``device`` runs where the context says;
:func:`effective_process_count` and :func:`effective_process_index` are
the process group's (1 and 0 without one); ``stop_orca_context()``
drops the context and leaves the process group running (a later
context reuses it).  Spark-era modes
(yarn, k8s, standalone) raise the reference's ``ValueError``;
``local_process_scope`` (distributed trials) raises
``NotImplementedError`` naming ROADMAP Queue 1 item 6.3.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import torch

from analytics_zoo_tpu_torch.common.config import TrainConfig

_TRIALS_ITEM = "ROADMAP Queue 1 item 6.3 (distributed trials)"
_MULTIHOST_MODES = ("multihost", "tpu-pod", "distributed")


class ZooContext:
    """Process-wide state: this rank's device, the mesh, the seed and
    the reference's free-form ``extra`` settings."""

    def __init__(self, device: torch.device, seed: int, extra=None,
                 mesh=None):
        from analytics_zoo_tpu_torch.parallel.mesh import Mesh

        self.device = device
        self.seed = seed
        self.extra = dict(extra or {})
        self.mesh = mesh if mesh is not None else Mesh({"dp": 1}, device)

    @property
    def num_devices(self) -> int:
        return self.mesh.devices

    @property
    def process_index(self) -> int:
        return effective_process_index()

    @property
    def num_processes(self) -> int:
        return effective_process_count()

    def __repr__(self):
        return (f"ZooContext(mesh={self.mesh.shape}, device={self.device}, "
                f"process={self.process_index}/{self.num_processes}, "
                f"seed={self.seed})")


class _OrcaContextMeta(type):
    """The context singleton, as the reference's ``OrcaContext``."""

    _ctx: Optional[ZooContext] = None
    _lock = threading.Lock()

    def get_context(cls) -> ZooContext:
        if cls._ctx is None:
            raise RuntimeError(
                "No context initialised — call init_orca_context() first")
        return cls._ctx


class OrcaContext(metaclass=_OrcaContextMeta):
    pass


def context_device() -> Optional[torch.device]:
    """The running context's device, or None without a context."""
    ctx = _OrcaContextMeta._ctx
    return None if ctx is None else ctx.device


def init_context(cluster_mode: str = "local", *, device=None,
                 mesh_axes=None, num_devices: Optional[int] = None,
                 coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 seed: Optional[int] = None, **extra: Any) -> ZooContext:
    """Install the context (see the module docstring) and return it.
    ``num_devices`` must equal the ranks of the process group (1
    without one)."""
    import os

    from analytics_zoo_tpu_torch.device import resolve_device
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

    if cluster_mode in _MULTIHOST_MODES:
        if coordinator_address is None:
            coordinator_address = os.environ.get("ZOO_COORDINATOR")
        if num_processes is None and "ZOO_NUM_PROCESSES" in os.environ:
            num_processes = int(os.environ["ZOO_NUM_PROCESSES"])
        if process_id is None and "ZOO_PROCESS_ID" in os.environ:
            process_id = int(os.environ["ZOO_PROCESS_ID"])
        init = None if coordinator_address is None \
            else f"tcp://{coordinator_address}"
        mesh_lib.init_distributed(device, init_method=init, rank=process_id,
                                  world_size=num_processes)
    elif cluster_mode != "local":
        raise ValueError(
            f"cluster_mode={cluster_mode!r}: Spark-era modes (yarn/k8s/"
            f"standalone) have no TPU equivalent; use 'local' or 'multihost'")
    ranks = mesh_lib.world()[1]
    if num_devices is not None and num_devices > ranks:
        raise ValueError(f"num_devices={num_devices} but only {ranks} "
                         f"devices are available (one a rank)")
    if num_devices is not None and num_devices != ranks:
        raise NotImplementedError(
            f"num_devices={num_devices} of {ranks} ranks: a mesh over a "
            f"subset of the process group is not ported ({_TRIALS_ITEM})")
    dev = mesh_lib.rank_device(device) if ranks > 1 \
        else resolve_device(device)
    mesh = mesh_lib.make_mesh(axes=dict(mesh_axes or {"dp": -1}),
                              device=dev)
    ctx = ZooContext(dev, TrainConfig().seed if seed is None else seed,
                     extra, mesh)
    with _OrcaContextMeta._lock:
        _OrcaContextMeta._ctx = ctx
    return ctx


def init_orca_context(cluster_mode: str = "local", **kwargs) -> ZooContext:
    """Reference-parity alias (ref: zoo.orca.init_orca_context)."""
    return init_context(cluster_mode, **kwargs)


def stop_orca_context() -> None:
    """Drop the context (ref: zoo.orca.stop_orca_context)."""
    with _OrcaContextMeta._lock:
        _OrcaContextMeta._ctx = None


def context_mesh():
    """The running context's mesh, or None without a context."""
    ctx = _OrcaContextMeta._ctx
    return None if ctx is None else ctx.mesh


def effective_process_count() -> int:
    """The number of processes the data plane splits files over: the
    process group's size (1 without one), the reference's
    ``jax.process_count()``."""
    from analytics_zoo_tpu_torch.parallel.mesh import world

    return world()[1]


def effective_process_index() -> int:
    """This process's index among them (its rank; 0 without a group)."""
    from analytics_zoo_tpu_torch.parallel.mesh import world

    return world()[0]


def local_process_scope(mesh_axes=None):
    """The reference's trial-isolation scope for distributed search: not
    ported (distributed trials are ROADMAP Queue 1 item 6.3)."""
    raise NotImplementedError(
        f"local_process_scope: distributed trials are not ported "
        f"({_TRIALS_ITEM})")
