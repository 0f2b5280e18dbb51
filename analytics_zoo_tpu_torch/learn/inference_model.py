"""Prompt-bucket helpers shared by the serving engine.

Copied from ``analytics_zoo_tpu/learn/inference_model.py``, whose module
imports JAX; ``InferenceModel`` itself is not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def filter_prompt_buckets(prompt_buckets: Sequence[int],
                          max_position: int,
                          max_new_tokens: int) -> Tuple[int, ...]:
    """Prompt buckets usable by a generator: a bucket only counts if the
    padded prompt + generation still fits the model's position table.
    Shared by load_flax_generator and ContinuousEngine so the two entry
    paths can never disagree about which prompts are servable."""
    limit = int(max_position) - int(max_new_tokens)
    out = tuple(b for b in sorted(set(int(b) for b in prompt_buckets))
                if b <= limit)
    if not out:
        raise ValueError(
            f"no prompt bucket fits: max_position {max_position} - "
            f"max_new_tokens {max_new_tokens} = {limit} < smallest "
            f"bucket {min(prompt_buckets)}")
    return out
