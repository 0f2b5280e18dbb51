"""The attention dispatch every attention layer shares.

The port of ``flash_ok`` and ``attention_dispatch`` from
``analytics_zoo_tpu/models/transformer.py``, without the mesh branches:
the port has no mesh yet (ROADMAP Queue 1 items 6 and 9), so a ``mesh``
argument raises.  The BERT family of that module is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops.flash_attention import (flash_attention,
                                                         flash_kernel_takes)
from analytics_zoo_tpu_torch.parallel.ring_attention import full_attention


def flash_ok(use_flash: Optional[bool], device, head_dim: int) -> bool:
    """Whether attention on ``device`` with heads of ``head_dim`` takes
    the flash kernel.

    ``use_flash=True``/``False`` force either branch.  ``None`` decides
    by the device and the shape, before any launch: the CUDA kernel for
    a CUDA tensor whose head dim the kernels are instantiated for
    (``ops.flash_attention.KERNEL_HEAD_DIMS``), :func:`full_attention`
    for any other head dim and for a CPU tensor, which is what the
    reference does off its TPU.  The reference's TPU rule (the kernel
    from sequence length 512 up, as measured on a TPU) does not carry
    over to the GPU."""
    if use_flash is not None:
        return bool(use_flash)
    return torch.device(device).type == "cuda" \
        and flash_kernel_takes(head_dim)


def attention_dispatch(q, k, v, kv_mask, *, causal: bool, mesh=None,
                       use_flash: Optional[bool] = None):
    """Flash attention where :func:`flash_ok` picks it, plain full
    attention otherwise.  q, k, v: ``[B, T, H, D]``."""
    if mesh is not None:
        raise NotImplementedError(
            "attention under a mesh (sequence-parallel or sharded flash) "
            "is not ported yet (ROADMAP Queue 1 items 6 and 9)")
    if flash_ok(use_flash, q.device, q.shape[-1]):
        return flash_attention(q, k, v, kv_mask, causal=causal)
    return full_attention(q, k, v, kv_mask, causal=causal)
