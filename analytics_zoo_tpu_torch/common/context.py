"""Context bootstrap: the port of ``analytics_zoo_tpu/common/context.py``
for one device.

``init_orca_context("local", device=None)`` installs a process-wide
:class:`ZooContext` holding ``resolve_device(device)``: CUDA unless the
caller names another device (``device="cpu"`` on a host without one),
raising without CUDA as every entry point does.  While a context is up,
``device.resolve_device(None)`` returns its device, so an entry point
that takes no ``device`` (``zouwu.autots``, a forecaster built from a
config) runs where the context says; ``stop_orca_context()`` drops it.

The reference's other modes need more than one device and a mesh:
``cluster_mode`` other than ``"local"``, ``mesh_axes``, ``num_devices``
and ``local_process_scope`` raise ``NotImplementedError`` naming ROADMAP
Queue 1 items 6 and 7 (meshes, DDP and multi-host).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import torch

from analytics_zoo_tpu_torch.common.config import TrainConfig

_MESH_ITEMS = "ROADMAP Queue 1 items 6 and 7 (meshes, DDP, multi-host)"


class ZooContext:
    """Process-wide state: the device, the seed and the reference's
    free-form ``extra`` settings."""

    num_devices = 1

    def __init__(self, device: torch.device, seed: int, extra=None):
        self.device = device
        self.seed = seed
        self.extra = dict(extra or {})

    def __repr__(self):
        return f"ZooContext(device={self.device}, seed={self.seed})"


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
                 seed: Optional[int] = None, **extra: Any) -> ZooContext:
    """Install the context for ``device`` (None: CUDA, raising without
    it) and return it.  Only ``"local"`` mode on one device is
    ported."""
    from analytics_zoo_tpu_torch.device import resolve_device

    if cluster_mode != "local":
        raise NotImplementedError(
            f"cluster_mode={cluster_mode!r} is not ported: the port runs "
            f"'local' on one device ({_MESH_ITEMS})")
    if mesh_axes is not None or num_devices not in (None, 1):
        raise NotImplementedError(
            f"mesh_axes={mesh_axes!r}, num_devices={num_devices!r}: meshes "
            f"are not ported ({_MESH_ITEMS})")
    dev = resolve_device(device)
    ctx = ZooContext(dev, TrainConfig().seed if seed is None else seed,
                     extra)
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


def effective_process_count() -> int:
    """The number of processes the data plane splits files over: 1, the
    port runs one process (the reference's ``jax.process_count()``)."""
    return 1


def effective_process_index() -> int:
    """This process's index among them: 0."""
    return 0


def local_process_scope(mesh_axes=None):
    """The reference's trial-isolation scope for distributed search: not
    ported, there is no multi-process mesh to scope."""
    raise NotImplementedError(
        f"local_process_scope: distributed trials are not ported "
        f"({_MESH_ITEMS})")
