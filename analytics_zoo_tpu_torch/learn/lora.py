"""LoRA fine-tuning: frozen base weights and rank-r adapters.

The port of ``analytics_zoo_tpu/learn/lora.py``.  The reference keeps the
adapters under a reserved ``__lora__`` key of the flax params tree and
merges ``W + scale·A@B`` inside the jitted step.  Here the adapters are
f32 ``nn.Parameter`` pairs held beside the model, keyed by the port's
parameter names, and :func:`merged_weights` swaps the merged weights
into the model for the length of a block (forward and backward, so a
layer that ``remat`` recomputes in backward reads the same merged
tensors), then puts the frozen base back.  The model itself is never
rebuilt or wrapped.

- Target selection is the reference's: ``LoRAConfig.target_regex``
  searches each weight's flax path (:func:`flax_path`: ``layers.0.
  attention.query.weight`` is ``layer_0/attention/query/kernel``), so
  the same kernels are picked on every model both packages share.
- ``a`` is ``[in, r]`` and ``b`` ``[r, out]``, the reference's shapes:
  ``in`` and ``out`` are the sizes of the reference kernel's input and
  output axes, which :func:`~analytics_zoo_tpu_torch.models.layers.
  flax_leaf` gives for each port weight (an ``nn.Linear`` ``[out, in]``
  transposed, an attention projection's head axes folded, a
  convolution's ``[out, in, *k]``).  A kernel of more than two
  dimensions needs its ``splits`` entry, as in the reference, and the
  merged delta is laid out back as the weight is.
- The base is frozen only while a block runs on the merged weights
  (:func:`merged_weights`): the module keeps its ``requires_grad``
  flags, and the optimizer is given the adapters alone.
- ``a`` is drawn from an explicit ``torch.Generator`` as ``normal /
  sqrt(fan_in)``, ``b`` starts at zero (so the merged model equals the
  base at step 0); both f32.  The draws are not threefry's: a test that
  compares with the reference sets both packages' adapters.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.models.layers import FlaxLeaf, flax_leaf
from analytics_zoo_tpu_torch.parallel import collectives as cc
from analytics_zoo_tpu_torch.parallel.partition import P

LORA_KEY = "__lora__"

# placed ahead of a model's partition rules, as the reference places
# them: the adapters replicate on every rank while the base weights shard
# (the port keeps the adapters beside the model, so no model parameter
# matches this rule)
LORA_RULES = ((re.escape(LORA_KEY), P()),)

DEFAULT_TARGETS = (r"(query|key|value|attn_out|ffn_up|ffn_down"
                   r"|Dense_\d+|dense\w*)/kernel$")

DEFAULT_SPLITS = ((r"(query|key|value)/kernel$", 1),
                  (r"attn_out/kernel$", 2))


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    target_regex: str = DEFAULT_TARGETS
    # (regex, n_input_dims) for kernels with ndim > 2
    splits: Tuple[Tuple[str, int], ...] = DEFAULT_SPLITS
    # adapters train in f32; the merged weight is cast to the base
    # weight's dtype
    dtype: Any = torch.float32

    @property
    def scale(self) -> float:
        return float(self.alpha) / float(self.rank)


def flax_path(model: nn.Module, name: str) -> str:
    """The reference's ``/``-joined params path of the port parameter
    ``name``: ``layers.<i>`` is ``layer_<i>``, an embedding table's
    ``weight`` is ``embedding`` and any other weight of two or more
    dimensions is ``kernel``."""
    parts = name.split(".")
    out: List[str] = []
    i = 0
    while i < len(parts) - 1:
        if parts[i] == "layers" and parts[i + 1].isdigit():
            out.append(f"layer_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    leaf = parts[-1]
    if leaf == "weight":
        owner = model.get_submodule(".".join(parts[:-1]))
        if isinstance(owner, nn.Embedding):
            leaf = "embedding"
        elif getattr(owner, "weight").dim() >= 2:
            leaf = "kernel"
    return "/".join(out + [leaf])


def port_name(lora_name: str) -> str:
    """The port parameter a reference adapter name (``layer_0::attention::
    query::kernel``) belongs to (``layers.0.attention.query.weight``)."""
    parts = []
    for p in lora_name.split("::"):
        m = re.fullmatch(r"layer_(\d+)", p)
        parts.extend(["layers", m.group(1)] if m else [p])
    parts[-1] = "weight"
    return ".".join(parts)


def target_paths(model: nn.Module, cfg: LoRAConfig) -> List[str]:
    """The names of every weight of two or more dimensions whose flax
    path the regex selects.  Raises when nothing matches: a fine-tune
    that trains nothing is the worst failure."""
    pat = re.compile(cfg.target_regex)
    names = [n for n, p in model.named_parameters()]
    hits = [n for n, p in model.named_parameters()
            if p.dim() >= 2 and pat.search(flax_path(model, n))]
    if not hits:
        raise ValueError(
            f"LoRA target_regex {cfg.target_regex!r} matched no kernel; "
            f"available paths include "
            f"{[flax_path(model, n) for n in names[:8]]}")
    return hits


def _n_in_dims(path: str, leaf: FlaxLeaf, cfg: LoRAConfig) -> int:
    """How many leading axes of the reference's kernel are its input: 1
    for a 2-D kernel, else its ``splits`` entry, as in the reference."""
    if len(leaf.shape) == 2:
        return 1
    for pat, n in cfg.splits:
        if re.search(pat, path):
            return n
    raise ValueError(
        f"LoRA target {path!r} has ndim={len(leaf.shape)} and no entry in "
        f"LoRAConfig.splits declares its input-dims split; add "
        f"(regex, n_input_dims) for it")


def init_lora(model: nn.Module, cfg: LoRAConfig, seed: int
              ) -> Dict[str, Dict[str, nn.Parameter]]:
    """Adapters ``{name: {"a": [in, r], "b": [r, out]}}`` for every
    target of ``model``, on its device, where ``in`` and ``out`` are the
    reference kernel's input and output sizes: ``a`` normal over
    ``sqrt(fan_in)`` from a ``torch.Generator`` seeded with ``seed``
    (drawn on the CPU, target by target), ``b`` zeros."""
    gen = torch.Generator().manual_seed(int(seed))
    params = dict(model.named_parameters())
    out = {}
    for name in target_paths(model, cfg):
        w, leaf = params[name], flax_leaf(model, name)
        n = _n_in_dims(flax_path(model, name), leaf, cfg)
        fan_in = int(np.prod(leaf.shape[:n]))
        fan_out = int(np.prod(leaf.shape[n:]))
        a = torch.randn((fan_in, cfg.rank), generator=gen,
                        dtype=cfg.dtype) / torch.sqrt(
                            torch.tensor(float(fan_in), dtype=cfg.dtype))
        out[name] = {
            "a": nn.Parameter(a.to(w.device)),
            "b": nn.Parameter(torch.zeros((cfg.rank, fan_out),
                                          dtype=cfg.dtype, device=w.device))}
    return out


def adapter_params(lora: Dict[str, Dict[str, torch.Tensor]]
                   ) -> List[torch.Tensor]:
    """Every adapter tensor, in a fixed order (the optimizer's)."""
    return [ab[k] for _, ab in sorted(lora.items()) for k in ("a", "b")]


def merge_weight(w: torch.Tensor, ab, scale: float,
                 leaf: FlaxLeaf, spec=None, mesh=None) -> torch.Tensor:
    """``W + scale·a@b`` in f32, cast to W's dtype (the reference's
    ``(W + delta).astype(W.dtype)``), the delta laid out as ``leaf``
    lays out the reference's kernel.  Under tensor parallelism ``w`` is
    this rank's shard under placement ``spec`` (port dims; ``leaf`` the
    whole kernel's): the replicated adapters' whole delta is cut to the
    same shard by ``collectives.scatter_to``, whose backward gathers the
    ranks' parts, so the adapters' gradients are whole on every rank."""
    delta = leaf.to_port(((ab["a"].float() @ ab["b"].float()) * scale)
                         .reshape(leaf.shape))
    for dim, entry in enumerate(spec or ()):
        if entry is not None:
            delta = cc.scatter_to(delta, cc.Line.of(mesh, entry), dim)
    return (w.float() + delta).to(w.dtype)


def merged_state(model: nn.Module, lora, cfg: LoRAConfig, state=None,
                 leaves=None) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` (or the whole tensors ``state`` of a
    sharded one, with the whole kernels' ``leaves``) with every adapter
    folded in: a plain ``state_dict`` (no adapter entries) that the base
    model loads and serves."""
    state = model.state_dict() if state is None else dict(state)
    with torch.no_grad():
        for name, ab in lora.items():
            leaf = leaves[name] if leaves else flax_leaf(model, name)
            state[name] = merge_weight(state[name], ab, cfg.scale, leaf)
    return state


@contextlib.contextmanager
def frozen(model: nn.Module):
    """Inside the block no parameter of ``model`` requires a gradient; on
    exit each has its own flag back, so the module is left as it came."""
    live = [p for p in model.parameters() if p.requires_grad]
    try:
        for p in live:
            p.requires_grad_(False)
        yield
    finally:
        for p in live:
            p.requires_grad_(True)


@contextlib.contextmanager
def swapped_weights(model: nn.Module, tensors: Dict[str, torch.Tensor]):
    """Inside the block, each parameter named in ``tensors`` reads as the
    given tensor (which may be the output of a differentiable
    computation); on exit the original parameters are back.  The model's
    modules are not replaced, and their other parameters and buffers
    are untouched."""
    saved = []
    try:
        for name, t in tensors.items():
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            saved.append((mod, attr, mod._parameters.pop(attr)))
            setattr(mod, attr, t)
        yield
    finally:
        for mod, attr, p in reversed(saved):
            delattr(mod, attr)
            mod._parameters[attr] = p


@contextlib.contextmanager
def merged_weights(model: nn.Module, lora, cfg: LoRAConfig, leaves=None,
                   placements=None, mesh=None):
    """Run the block on ``W + scale·a@b`` for every adapted weight, the
    base frozen (:func:`frozen`), so only the adapters get gradients.
    A sharded model passes its whole kernels' ``leaves`` and its
    ``placements`` (:func:`merge_weight`)."""
    placements = placements or {}
    with frozen(model):
        params = dict(model.named_parameters())
        merged = {name: merge_weight(
            params[name], ab, cfg.scale,
            leaves[name] if leaves else flax_leaf(model, name),
            placements.get(name), mesh)
            for name, ab in lora.items()}
        with swapped_weights(model, merged):
            yield


def lora_from_flax(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's adapter tree (``params["__lora__"]``: ``{"layer_0::
    attention::query::kernel": {"a", "b"}}``, leaves as numpy arrays or
    anything ``np.asarray`` takes) keyed by the port's parameter names.
    The shapes carry over as they are."""
    return {port_name(name): {k: torch.from_numpy(
        np.array(ab[k], dtype=np.float32)) for k in ("a", "b")}
        for name, ab in tree.items()}
