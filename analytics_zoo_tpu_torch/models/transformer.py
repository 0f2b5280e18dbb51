"""The attention dispatch every attention layer shares.

The port of ``flash_ok`` and ``attention_dispatch`` from
``analytics_zoo_tpu/models/transformer.py``, without the mesh branches:
the port has no mesh yet (ROADMAP Queue 1 items 6 and 9), so a ``mesh``
argument raises.  The BERT family of that module is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops.flash_attention import flash_attention
from analytics_zoo_tpu_torch.parallel.ring_attention import full_attention


def flash_ok(use_flash: Optional[bool], device) -> bool:
    """Whether attention on ``device`` takes the flash kernel.

    ``use_flash=True``/``False`` force either branch.  ``None`` means
    the CUDA kernel for a CUDA tensor and :func:`full_attention` for a
    CPU tensor, which is what the reference does off its TPU.  The
    reference's TPU rule (the kernel from sequence length 512 up, as
    measured on a TPU) does not carry over to the GPU."""
    if use_flash is not None:
        return bool(use_flash)
    return torch.device(device).type == "cuda"


def attention_dispatch(q, k, v, kv_mask, *, causal: bool, mesh=None,
                       use_flash: Optional[bool] = None):
    """Flash attention where :func:`flash_ok` picks it, plain full
    attention otherwise.  q, k, v: ``[B, T, H, D]``."""
    if mesh is not None:
        raise NotImplementedError(
            "attention under a mesh (sequence-parallel or sharded flash) "
            "is not ported yet (ROADMAP Queue 1 items 6 and 9)")
    if flash_ok(use_flash, q.device):
        return flash_attention(q, k, v, kv_mask, causal=causal)
    return full_attention(q, k, v, kv_mask, causal=causal)
