"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the one the caller names, else
    the running context's (``init_orca_context(device=...)``), else
    ``cuda``.  With no CUDA device, no context and no explicit
    ``device`` this raises instead of quietly running the CPU path."""
    if device is None:
        from analytics_zoo_tpu_torch.common.context import context_device

        ctx = context_device()
        if ctx is not None:
            return ctx
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
