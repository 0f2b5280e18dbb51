"""The attention dispatch every attention layer shares, and the BERT
family.

The port of ``analytics_zoo_tpu/models/transformer.py``:

- ``flash_ok`` and ``attention_dispatch``: under a mesh with ``sp``
  above 1 the ring or ulysses attention of ``parallel.ring_attention``
  (``sp_strategy``), else the flash kernels on this rank's rows and
  heads as they are (a tensor-parallel rank's H/tp heads), else plain
  full attention;
- ``MultiHeadAttention``, the post-LN ``TransformerLayer``, ``BERT``
  (word, position and token-type embeddings, ``(sequence, pooled)``
  out), ``BERTForSequenceClassification``, ``BERTForQuestionAnswering``
  and :func:`qa_loss`.  BERT's attention is non-causal with a key
  padding mask (``attention_mask > 0``); on a CUDA tensor it runs the
  flash kernels forward and backward.  MoE layers (``moe_experts``)
  raise (ROADMAP item 2);
- tensor and sequence parallelism: ``BERT_PARTITION_RULES`` (the
  reference's Megatron layout) shard a BERT through its ``tp_shard``
  (the Estimator's ``partition_rules``): q/k/v and ``ffn_up``
  column-parallel (their input through ``collectives.copy_to``, each
  rank its H/tp heads and I/tp columns), ``attn_out`` and ``ffn_down``
  row-parallel (f32 partial products through ``collectives.
  reduce_from``, the bias added once), ``word_embeddings`` split on the
  vocab; a dim the axis does not divide stays whole.  ``BERT(mesh=)``
  with ``sp`` above 1 splits the sequence after the embeddings (which
  take global positions) and gathers it before the pooler
  (``collectives.gather_seq``), the counterpart of the reference's
  ``_constrain_seq``; dropout then draws the global sequence's masks;
- dropout with explicit seeds (:func:`dropout`, :func:`fold_in`), shared
  with ``models/lm.py``.  A training forward takes ``rng``, an integer
  seed (the Estimator passes ``fold_in(config.seed, step)``, the
  reference's ``fold_in(rng, step)``); every dropout site draws its mask
  from a ``torch.Generator`` on the tensor's device seeded with a hash
  of that seed and the site, never from torch's global generator.  So
  a run is reproducible, a resumed run draws the masks an uninterrupted
  one would, and a layer recomputed under ``remat`` draws its masks
  again identically.  The masks are not threefry's: the contract is
  held instead (kept share ~ 1 - p, kept values scaled by 1 / (1 - p),
  the same seed gives the same masks, ``train=False`` is identity);
- ``remat=True`` recomputes each layer in backward
  (``torch.utils.checkpoint``, non-reentrant), as the reference's
  ``nn.remat`` does.

Numerics follow the reference's cast points: parameters f32; every
dense projection in the model dtype; the three embeddings summed and
LayerNorm-ed (flax's eps 1e-6, fast variance) in f32 and cast to the
model dtype after the embedding dropout; the layers' LayerNorms f32
(so every layer after the first carries an f32 residual); GELU the
tanh approximation (flax's ``nn.gelu``); the pooler, the heads and the
returned sequence f32.  :func:`params_from_flax` converts the
reference's ``variables["params"]`` of the three models.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from analytics_zoo_tpu_torch.models.layers import HEAD_FOLDS, int8_of
from analytics_zoo_tpu_torch.ops.flash_attention import (
    flash_attention, flash_kernel_takes)
from analytics_zoo_tpu_torch.parallel import collectives as cc
from analytics_zoo_tpu_torch.parallel import data_parallel as dpar
from analytics_zoo_tpu_torch.parallel.partition import (P, cut_params,
                                                        tp_dim, vocab_split)
from analytics_zoo_tpu_torch.parallel.ring_attention import (
    full_attention, ring_self_attention)

# The reference's Megatron layout over its flax tree: q/k/v and ffn_up
# column-parallel, attn_out and ffn_down row-parallel, the word table
# split on the vocab.
BERT_PARTITION_RULES = (
    (r"word_embeddings/embedding", P("tp", None)),
    (r"(query|key|value)/kernel", P(None, "tp")),
    (r"attn_out/kernel", P("tp", None)),
    (r"ffn_up/kernel", P(None, "tp")),
    (r"ffn_down/kernel", P("tp", None)),
    (r".*", P()),
)


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
                       use_flash: Optional[bool] = None,
                       sp_strategy: str = "ring"):
    """The attention every layer shares: the sequence-parallel ring or
    ulysses attention (``sp_strategy``) when ``mesh`` splits the
    sequence (``sp`` above 1), else flash attention where
    :func:`flash_ok` picks it, else plain full attention.  q, k, v:
    ``[B, T, H, D]``, this rank's rows, sequence chunk and heads."""
    if mesh is not None and mesh.size("sp") > 1:
        return ring_self_attention(q, k, v, mesh, kv_mask, causal=causal,
                                   strategy=sp_strategy)
    if flash_ok(use_flash, q.device, q.shape[-1]):
        return flash_attention(q, k, v, kv_mask, causal=causal)
    return full_attention(q, k, v, kv_mask, causal=causal)


# ---------------------------------------------------------------------------
# dropout with explicit seeds
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new seed from ``seed`` and an integer ``data`` (a step, a layer
    or a dropout site): the port's ``jax.random.fold_in``, a 63-bit
    hash of the two on the host (``torch.Generator.manual_seed`` takes
    it as is)."""
    z = _mix64(int(seed) & _M64)
    return _mix64((z + (int(data) + 1) * _GOLDEN) & _M64) >> 1


def dropout(x, p: float, rng: Optional[int], train: bool):
    """flax ``nn.Dropout(p)(x, deterministic=not train)`` with the mask
    drawn from a ``torch.Generator`` on x's device seeded with ``rng``:
    each element kept with probability ``1 - p`` and scaled by
    ``1 / (1 - p)`` in x's dtype, the rest 0.  Identity when not
    ``train`` or ``p == 0``; ``rng`` is required otherwise."""
    if not train or p == 0.0:
        return x
    if rng is None:
        raise ValueError(
            f"dropout {p} in a training forward needs rng= (an integer "
            f"seed; the Estimator passes one a step)")
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - p
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(rng))
    # a data-parallel step draws the global batch's mask, keeps its rows
    mask = dpar.rand(x.shape, gen, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def run_layer(layer, remat: bool, train: bool, *args):
    """``layer(*args)``, recomputed in backward when ``remat`` and a
    training forward needs gradients.  Every argument that sets a mask
    (the layer's dropout seed) is a Python value passed in, so the
    recompute draws what the forward drew; no global RNG state is
    involved, so none is saved."""
    if remat and train and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return layer(*args)


def site_seed(rng: Optional[int], i: int) -> Optional[int]:
    """The seed of site ``i`` (a layer, or a dropout site in a layer)
    under ``rng``; ``None`` stays ``None`` (an evaluation forward)."""
    return None if rng is None else fold_in(rng, i)


# ---------------------------------------------------------------------------
# the BERT family
# ---------------------------------------------------------------------------


def _dense(layer: nn.Linear, x, dtype):
    """A flax ``Dense``/``DenseGeneral`` with ``dtype=dtype``: input,
    kernel and bias all promoted to the compute dtype; a Dense inside
    ``layers.int8_scope`` on the reference's int8 path."""
    q = int8_of(layer)
    if q is not None:
        from analytics_zoo_tpu_torch.learn.quantize import int8_dense

        return int8_dense(x, q, layer.bias)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: statistics in f32 with the
    fast variance ``max(0, E[x^2] - E[x]^2)``; the output is f32."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = float(eps)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (xf - mean) * mul + self.bias


def _not_ported(moe_experts: int = 0) -> None:
    if moe_experts:
        raise NotImplementedError(
            f"moe_experts={moe_experts!r} is not ported yet (ROADMAP "
            f"Queue 1 item 2: MoE layers)")


def row_dense(layer: nn.Linear, x, dtype, line):
    """A row-parallel Dense: this rank's input features times its shard
    of the weight, the f32 partial products summed over the tp ``line``
    (``collectives.reduce_from``), the whole bias added once, cast to
    ``dtype``."""
    part = F.linear(x.to(dtype), layer.weight.to(dtype)).float()
    part = cc.reduce_from(part, line)
    if layer.bias is not None:
        part = part + layer.bias.float()
    return part.to(dtype)


def _megatron_pair(placements, col: str, row: str, what: str) -> bool:
    """Whether a column-parallel ``col`` and the row-parallel ``row``
    that reads it are split (both or neither)."""
    c, r = tp_dim(placements, col, (0,)), tp_dim(placements, row, (1,))
    if (c is None) != (r is None):
        raise NotImplementedError(
            f"{what}: {col} split on {c} with {row} split on {r}; the "
            f"port trains Megatron's pair (columns of the first, rows of "
            f"the second) or both whole (ROADMAP Queue 1 item 6.6)")
    return c is not None


class MultiHeadAttention(nn.Module):
    """Non-causal self-attention under a key mask: q, k and v project to
    ``num_heads`` heads of ``head_dim`` (the reference's ``DenseGeneral
    ((H, D))``), :func:`attention_dispatch` with ``causal=False``, and
    ``attn_out`` over the heads.  Each projection is its own contiguous
    tensor, as the flash kernel takes it."""

    # the reference's head axes, folded into each projection's weight
    head_folds = HEAD_FOLDS

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 use_flash: Optional[bool] = None, mesh=None,
                 sp_strategy: str = "ring"):
        super().__init__()
        self._h, self._d = num_heads, head_dim
        self.dtype = dtype
        self.use_flash = use_flash
        self.mesh = mesh
        self.sp_strategy = sp_strategy
        # the tp line this rank's heads are split over (:meth:`tp_split`)
        self.tp_line: Optional[cc.Line] = None
        HD = num_heads * head_dim
        self.query = nn.Linear(hidden_size, HD)
        self.key = nn.Linear(hidden_size, HD)
        self.value = nn.Linear(hidden_size, HD)
        self.attn_out = nn.Linear(HD, hidden_size)

    def tp_split(self, mesh) -> dict:
        """Keep this rank's H/tp heads: q/k/v's output rows (and biases)
        and attn_out's input columns; returns their placements."""
        dims = {f"{lin}.{attr}": 0 for lin in ("query", "key", "value")
                for attr in ("weight", "bias")}
        dims["attn_out.weight"] = 1
        self.tp_line = cc.Line.of(mesh, "tp")
        self._h //= self.tp_line.size
        return cut_params(self, mesh, dims)

    def forward(self, x, kv_mask=None, train: bool = False):
        del train
        B, T, _ = x.shape
        xin = cc.copy_to(x, self.tp_line)
        q, k, v = (_dense(lin, xin, self.dtype).view(B, T, self._h,
                                                      self._d)
                   for lin in (self.query, self.key, self.value))
        o = attention_dispatch(q, k, v, kv_mask, causal=False,
                               mesh=self.mesh, use_flash=self.use_flash,
                               sp_strategy=self.sp_strategy)
        if self.tp_line is not None:
            return row_dense(self.attn_out, o.reshape(B, T, -1), self.dtype,
                             self.tp_line)
        return _dense(self.attn_out, o.reshape(B, T, -1), self.dtype)


class TransformerLayer(nn.Module):
    """The reference's post-LN encoder block: ``ln_attn(x + drop(attn))``
    then ``ln_ffn(x + drop(ffn_down(gelu(ffn_up(x)))))``; both norms
    f32.  ``rng`` seeds its two dropout masks."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 use_flash: Optional[bool] = None, mesh=None,
                 num_experts: int = 0, sp_strategy: str = "ring"):
        super().__init__()
        _not_ported(num_experts)
        self.dropout = float(dropout)
        self.dtype = dtype
        self.attention = MultiHeadAttention(
            hidden_size, num_heads, hidden_size // num_heads, dtype=dtype,
            use_flash=use_flash, mesh=mesh, sp_strategy=sp_strategy)
        self.ln_attn = LayerNorm(hidden_size)
        self.ffn_up = nn.Linear(hidden_size, intermediate_size)
        self.ffn_down = nn.Linear(intermediate_size, hidden_size)
        self.ln_ffn = LayerNorm(hidden_size)
        # the tp line ffn_up's columns and ffn_down's rows are split over
        self.tp_line: Optional[cc.Line] = None

    def tp_split(self, mesh) -> dict:
        """Keep this rank's I/tp columns of ffn_up (and its bias) and
        rows of ffn_down's input; returns their placements."""
        self.tp_line = cc.Line.of(mesh, "tp")
        return cut_params(self, mesh, {"ffn_up.weight": 0, "ffn_up.bias": 0,
                                       "ffn_down.weight": 1})

    def forward(self, x, kv_mask=None, train: bool = False,
                rng: Optional[int] = None):
        a = self.attention(x, kv_mask, train)
        a = dropout(a, self.dropout, site_seed(rng, 0), train)
        x = self.ln_attn(x + a)
        h = _dense(self.ffn_up, cc.copy_to(x, self.tp_line), self.dtype)
        h = F.gelu(h, approximate="tanh")
        if self.tp_line is not None:
            h = row_dense(self.ffn_down, h, self.dtype, self.tp_line)
        else:
            h = _dense(self.ffn_down, h, self.dtype)
        h = dropout(h, self.dropout, site_seed(rng, 1), train)
        return self.ln_ffn(x + h)


class BERT(nn.Module):
    """The reference's BERT encoder: ``forward(input_ids,
    token_type_ids=None, attention_mask=None, train=False, *, rng=None)``
    returns ``(sequence [B, T, E] f32, pooled [B, E] f32)``.  The
    defaults are BERT-base (``bert-base-uncased``'s config).
    ``attention_mask`` marks the keys that attend (``> 0``); a row with
    none attends nothing and gives finite outputs.  ``use_flash`` picks
    the attention (:func:`flash_ok`).

    ``mesh`` with an ``sp`` axis above 1 splits the sequence (its
    length must divide by sp) over it, with ``sp_strategy`` ``"ring"``
    or ``"ulysses"``; ``tp_shard`` (the Estimator's ``partition_rules``)
    splits the layers over ``tp``.  Both return the whole sequence and
    the pooled output on every rank.

    Parameters are created f32 with BERT's initialisation (normal 0.02,
    zero biases, unit norm scales) from the global torch generator; seed
    it with ``torch.manual_seed`` for reproducible random weights, or
    load converted weights (:func:`params_from_flax`)."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, max_position: int = 512,
                 type_vocab: int = 2, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, mesh=None,
                 remat: bool = False, use_flash: Optional[bool] = None,
                 moe_experts: int = 0, moe_every: int = 2,
                 moe_top_k: int = 2, sp_strategy: str = "ring"):
        super().__init__()
        del moe_every, moe_top_k
        _not_ported(moe_experts)
        if sp_strategy not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp strategy {sp_strategy!r} "
                             "(expected 'ring' or 'ulysses')")
        self.mesh = mesh
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_position = max_position
        self.dropout = float(dropout)
        self.dtype = dtype
        self.remat = bool(remat)
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position, hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab, hidden_size)
        self.emb_ln = LayerNorm(hidden_size)
        self.layers = nn.ModuleList(
            TransformerLayer(hidden_size, num_heads, intermediate_size,
                             dropout, dtype=dtype, use_flash=use_flash,
                             mesh=mesh, sp_strategy=sp_strategy)
            for _ in range(num_layers))
        self.pooler = nn.Linear(hidden_size, hidden_size)
        _init_normal(self)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                train: bool = False, *, rng: Optional[int] = None):
        T = input_ids.shape[1]
        if T > self.max_position:
            raise ValueError(f"sequence length {T} exceeds max_position "
                             f"{self.max_position}")
        ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        x = (self.word_embeddings(ids)
             + self.position_embeddings(
                 torch.arange(T, device=ids.device))[None]
             + self.token_type_embeddings(token_type_ids.long()))
        sp = cc.Line.of(self.mesh, "sp")
        if T % sp.size:
            raise ValueError(f"sequence length {T} does not divide over "
                             f"sp={sp.size}")
        # this rank's chunk of the sequence (positions are global: the
        # embeddings were summed over the whole of it)
        x = cc.split_seq(self.emb_ln(x), sp)
        kv_mask = None if attention_mask is None else \
            cc.split_seq(attention_mask > 0, sp)
        with dpar.seq_of_global(sp.index, sp.size):
            x = dropout(x, self.dropout, site_seed(rng, 0), train)
            x = x.to(self.dtype)
            for i, layer in enumerate(self.layers):
                x = run_layer(layer, self.remat, train, x, kv_mask, train,
                              site_seed(rng, i + 1))
        x = cc.gather_seq(x, sp)
        pooled = torch.tanh(F.linear(x[:, 0].float(),
                                     self.pooler.weight.float(),
                                     self.pooler.bias.float()))
        return x.float(), pooled

    def tp_shard(self, mesh, placements) -> dict:
        """Shard this encoder over ``mesh``'s ``tp`` axis under
        ``placements`` (``parallel.partition.shard_module``: each
        parameter's placement in the port's dims): a layer's q/k/v with
        its attn_out and its ffn_up with its ffn_down split in
        Megatron's pairs, the word table on its rows, the rest whole.
        Returns the placements of the parameters cut."""
        cut = {}
        for i, layer in enumerate(self.layers):
            pre = f"layers.{i}."
            att = pre + "attention."
            qkv = {tp_dim(placements, f"{att}{n}.weight", (0,))
                   for n in ("query", "key", "value")}
            if len(qkv) > 1:
                raise NotImplementedError(
                    f"layer {i}: query, key and value split differently "
                    f"({qkv}); the port splits them together (ROADMAP "
                    f"Queue 1 item 6.6)")
            if _megatron_pair(placements, att + "query.weight",
                              att + "attn_out.weight",
                              f"layer {i} attention"):
                cut.update({att + n: s for n, s in
                            layer.attention.tp_split(mesh).items()})
            if _megatron_pair(placements, pre + "ffn_up.weight",
                              pre + "ffn_down.weight", f"layer {i} MLP"):
                cut.update({pre + n: s
                            for n, s in layer.tp_split(mesh).items()})
        if tp_dim(placements, "word_embeddings.weight", (0,)) == 0:
            cut["word_embeddings.weight"] = vocab_split(
                self.word_embeddings, mesh)
        handled = ("query.", "key.", "value.", "attn_out.", "ffn_up.",
                   "ffn_down.", "word_embeddings.")
        for name in placements:
            if not any(h in name for h in handled):
                # the rest stays whole: a split of it raises
                tp_dim(placements, name)
        return cut


def _init_normal(module: nn.Module) -> None:
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02)


class BERTForSequenceClassification(nn.Module):
    """``classifier`` (f32) over BERT's pooled output: logits
    ``[B, num_classes]``.  ``bert`` defaults to BERT-base."""

    def __init__(self, num_classes: int = 2, bert: Optional[BERT] = None):
        super().__init__()
        self.bert = bert if bert is not None else BERT()
        self.classifier = nn.Linear(self.bert.hidden_size, num_classes)
        _init_normal(self.classifier)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                train: bool = False, *, rng: Optional[int] = None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              train, rng=rng)
        return self.classifier(pooled)


class BERTForQuestionAnswering(nn.Module):
    """The SQuAD head: ``qa_outputs`` (f32) over BERT's sequence, logits
    ``[B, T, 2]`` (start ``[..., 0]``, end ``[..., 1]``)."""

    def __init__(self, bert: Optional[BERT] = None):
        super().__init__()
        self.bert = bert if bert is not None else BERT()
        self.qa_outputs = nn.Linear(self.bert.hidden_size, 2)
        _init_normal(self.qa_outputs)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                train: bool = False, *, rng: Optional[int] = None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask, train,
                           rng=rng)
        return self.qa_outputs(seq)


def qa_loss(logits, targets):
    """The reference's SQuAD loss: the mean over rows of the start and
    end cross-entropies, halved.  targets: ``(start_positions,
    end_positions)``, integer ``[B]`` each."""
    start, end = targets
    ls = F.cross_entropy(logits[..., 0].float(), start.long(),
                         reduction="none")
    le = F.cross_entropy(logits[..., 1].float(), end.long(),
                         reduction="none")
    return torch.mean(ls + le) / 2.0


def params_from_flax(params) -> Dict[str, torch.Tensor]:
    """The reference's ``variables["params"]`` of a ``BERT``, a
    ``BERTForSequenceClassification`` or a ``BERTForQuestionAnswering``
    (leaves as numpy arrays or anything ``np.asarray`` takes) as the
    matching port module's ``state_dict``.  q/k/v kernels ``[E, H, D]``
    fold to ``[E, H*D]`` and ``attn_out``'s ``[H, D, E]`` to ``[H*D,
    E]``; every kernel transposes to ``nn.Linear``'s ``[out, in]``."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def linear(out, name, p, in_dims):
        k = np.asarray(p["kernel"], np.float32)
        n_in = int(np.prod(k.shape[:in_dims]))
        out[name + ".weight"] = t(k.reshape(n_in, -1).T)
        out[name + ".bias"] = t(np.asarray(p["bias"]).reshape(-1))

    def encoder(p, pre):
        out: Dict[str, torch.Tensor] = {}
        for name in ("word_embeddings", "position_embeddings",
                     "token_type_embeddings"):
            out[f"{pre}{name}.weight"] = t(p[name]["embedding"])
        for ln in ("scale", "bias"):
            out[f"{pre}emb_ln.{ln}"] = t(p["emb_ln"][ln])
        linear(out, pre + "pooler", p["pooler"], 1)
        n_layers = sum(1 for k in p if k.startswith("layer_"))
        for i in range(n_layers):
            lp, lpre = p[f"layer_{i}"], f"{pre}layers.{i}."
            for name, in_dims in HEAD_FOLDS.items():
                linear(out, f"{lpre}attention.{name}",
                       lp["attention"][name], in_dims)
            for name in ("ffn_up", "ffn_down"):
                linear(out, lpre + name, lp[name], 1)
            for ln in ("ln_attn", "ln_ffn"):
                for leaf in ("scale", "bias"):
                    out[f"{lpre}{ln}.{leaf}"] = t(lp[ln][leaf])
        return out

    if "bert" not in params:
        return encoder(params, "")
    out = encoder(params["bert"], "bert.")
    for head in ("classifier", "qa_outputs"):
        if head in params:
            linear(out, head, params[head], 1)
    return out
