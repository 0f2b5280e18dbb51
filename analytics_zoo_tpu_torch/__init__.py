"""PyTorch/CUDA port of ``analytics_zoo_tpu``, slice by slice.

The JAX package beside this one is the reference: every module here
keeps its counterpart's path and names, and the tests hold the two to
each other on the same weights and inputs.  This package imports
``torch``, numpy and the standard library only — never JAX, and nothing
of the JAX package.  Importing it needs neither CUDA nor ``triton``;
CUDA kernels are built from ``ops/csrc`` at their first launch.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :func:`resolve_device`); on the CPU every kernel
wrapper runs its plain PyTorch version.
"""

from analytics_zoo_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
