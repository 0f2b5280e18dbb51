"""Decoder-only causal language model: training and the serving paths.

The port of ``analytics_zoo_tpu/models/lm.py``: the GPT-2 shape
(learned positions, pre-LayerNorm blocks, tanh-GELU MLP, biases, tied
head) and the Llama family the reference's ``net/hf_net.py`` imports
(rotary positions, RMSNorm, SwiGLU, bias-free projections with optional
q/k/v biases as in Qwen2, an untied f32 head), each with multi-head or
grouped-query attention:

- the dense forward (``__call__``/``hidden_states``) and ``prefill``,
  whose attention goes through ``models.transformer.attention_dispatch``
  (the flash kernel on a CUDA tensor whose head dim the kernels take).
  The forward is differentiable: ``train=True`` is the training
  forward (dropout, with masks seeded from the forward's ``rng``:
  ``models.transformer.dropout``; ``remat`` recomputes each layer in
  backward), and with grad on, the flash branch's gradient runs the
  CUDA backward kernels; :func:`lm_loss` is the reference's training
  loss, and :class:`LMWithFusedLoss` with :func:`fused_lm_loss` its
  blockwise form that never keeps the ``[B, T, V]`` logits;
- the slot-arena cache methods ``decode_step``, ``verify_step``/
  ``verify_hidden`` and ``prefill_chunk``, and :func:`generate`, greedy
  or sampled;
- the paged trio ``decode_step_paged``, ``verify_hidden_paged`` and
  ``prefill_chunk_paged``.

MoE layers (``moe_experts``) raise ``NotImplementedError`` until a later
slice ports them.

Numerics follow the reference's cast points, or bf16 logits drift from
it: parameters are stored f32; every dense projection computes in the
model dtype; LayerNorm (flax's fast variance, ``E[x^2] - E[x]^2``) and
RMSNorm compute in f32 and their callers cast back; the embedding sum is
cast to the model dtype; rotary positions rotate q and k in f32 at
absolute positions and cast back, and K is cached post-rotation;
attention output (f32) is cast before ``attn_out``; the head, tied or
untied, runs in f32.

Sampling (:func:`pick_next`, shared by :func:`generate` and every pick
of the serving engine) draws a row's token as a pure function of (seed,
absolute position of the token fed, logits), the reference's contract
(``fold_in(key(seed), pos)``), but with the port's own random numbers:
a counter-based integer hash of (seed, position, vocab index) in int64
arithmetic, identical on the CPU and the card, and Gumbel-max over the
temperature-scaled, :func:`top_p_filter`-ed logits.  Its tokens are not
threefry's.

Caches are updated IN PLACE by the arena and paged methods (the
reference returns new caches that the JAX engine donates back into the
same buffers), so those methods return only their outputs.
:func:`params_from_flax` converts the reference model's
``variables["params"]`` into this model's ``state_dict``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.layers import HEAD_FOLDS, int8_of
from analytics_zoo_tpu_torch.models.transformer import (LayerNorm, _dense,
                                                        attention_dispatch,
                                                        dropout, row_dense,
                                                        run_layer,
                                                        site_seed)
from analytics_zoo_tpu_torch.ops.flash_attention import (cache_attention,
                                                         paged_attention,
                                                         paged_kv_update)
from analytics_zoo_tpu_torch.parallel import collectives as cc
from analytics_zoo_tpu_torch.parallel import data_parallel as dpar
from analytics_zoo_tpu_torch.parallel.partition import (
    P, cut_params, param_placements, tp_dim, vocab_lookup)

# The reference's Megatron layout over its flax tree (paths and axes of
# the reference's parameters; :func:`shard_lm` maps them onto this
# model's tensors): q/k/v, ffn_up and ffn_gate column-parallel,
# attn_out and ffn_down row-parallel, the embedding and an untied head
# split on the vocab.  A model whose kv heads do not divide tp passes
# rules with the key/value kernels replicated (``P()``): its KV cache
# then replicates too.
LM_PARTITION_RULES = (
    (r"pos_embed/embedding", P()),      # positions replicate (before the
    (r"embed/embedding", P("tp", None)),   # vocab rule can re.search-match)
    (r"(query|key|value)/kernel", P(None, "tp")),
    (r"attn_out/kernel", P("tp", None)),
    (r"ffn_up/kernel", P(None, "tp")),
    (r"ffn_gate/kernel", P(None, "tp")),   # SwiGLU gate: column-parallel
    (r"ffn_down/kernel", P("tp", None)),
    (r"lm_head/kernel", P(None, "tp")),    # untied head: vocab-sharded
    (r".*", P()),
)


class _TP:
    """This rank's place on a mesh's ``tp`` axis and the collectives the
    sharded layers run over it: the conjugate operators of
    ``parallel.collectives``, which are the plain collectives with
    gradients off (serving)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = mesh.size("tp")
        self.rank = mesh.coord("tp")
        self._group = mesh.group("tp")
        # one line per process group the collectives run over
        self._lines: Dict[int, cc.Line] = {}
        # per thread: the group of the engine this thread runs (several
        # engines on one rank share the sharded weights, each with its
        # own group, so two pumps' collectives never pair up)
        self._local = threading.local()

    @property
    def group(self):
        return getattr(self._local, "group", None) or self._group

    @contextlib.contextmanager
    def using(self, group):
        """Run this thread's collectives over ``group`` (None: the
        mesh's own) for the length of the block."""
        prev = getattr(self._local, "group", None)
        self._local.group = group
        try:
            yield
        finally:
            self._local.group = prev

    @property
    def line(self) -> cc.Line:
        """The tp line this thread's collectives run over."""
        group = self.group
        line = self._lines.get(id(group))
        if line is None:
            line = self._lines[id(group)] = cc.Line(
                group, self.rank, self.size, self.mesh.group_ranks("tp"),
                "tp")
        return line

    def all_gather(self, x, dim: int):
        """The ranks' pieces along ``dim`` (backward: this rank's
        slice)."""
        return cc.gather_from(x, self.line, dim)

    def local(self, x, dim: int):
        """This rank's piece of a whole ``x`` (backward: all-gather)."""
        return cc.scatter_to(x, self.line, dim)

    def copy(self, x):
        """The input of a column-parallel layer: itself forward, its
        gradient summed over the line backward."""
        return cc.copy_to(x, self.line)

    def feed(self, x, have_local: bool, want_local: bool, dim: int):
        """``x`` split (or whole) along ``dim`` as the next layer takes
        it: gathered, cut, or as it is."""
        if have_local == want_local:
            return x
        return self.all_gather(x, dim) if have_local else \
            self.local(x, dim)


def _linear(layer: nn.Linear, x, dtype, tp: Optional[_TP] = None,
            row: bool = False):
    """:func:`_dense`, or a row-parallel layer (``row``: its input
    features split over tp) through :func:`row_dense`."""
    if tp is None or not row:
        return _dense(layer, x, dtype)
    return row_dense(layer, x, dtype, tp.line)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(dtype=float32)``: the f32 mean of squares
    ``ms``, ``mul = rsqrt(ms + eps) * scale``, then ``x * mul``; the
    output is f32."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = float(eps)
        self.scale = nn.Parameter(torch.ones(features))

    def forward(self, x):
        xf = x.float()
        mul = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps) \
            * self.scale
        return xf * mul


def _make_norm(kind: str, features: int, eps: float) -> nn.Module:
    """One norm selector for the block norms and the final norm, as the
    reference's ``_make_norm``: the two must never drift."""
    if kind == "rmsnorm":
        return RMSNorm(features, eps)
    if kind == "layernorm":
        return LayerNorm(features, eps)
    raise ValueError(f"norm must be 'layernorm' or 'rmsnorm', got "
                     f"{kind!r}")


def _apply_rope(x, pos, base: float):
    """Rotary position embedding (rotate-half convention), the
    reference's ``_apply_rope``.

    x: ``[..., T, H, D]`` (D even); pos: positions broadcastable against
    the T axis: ``arange(T)`` for the dense forward, a ``[1]`` or
    ``[B, 1]`` position for one cached decode step, ``[B, S]`` for S
    tokens a row.  Frequencies ``base ** (-arange(D/2) * 2 / D)`` and the
    angles are f32; the result is cast to x's dtype."""
    D = x.shape[-1]
    if D % 2:
        raise ValueError(
            f"rotary positions need an even head dim, got {D} "
            f"(hidden_size must be divisible by 2*num_heads)")
    half = D // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) * 2.0 / D)
    ang = pos[..., None].float() * freqs                # [..., T, half]
    cos = torch.cos(ang)[..., None, :]                  # [..., T, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


class DecoderAttention(nn.Module):
    """Causal self-attention: a dense forward, and cached decode against
    a slot-arena or a paged KV cache, sharing the same projections.
    ``num_kv_heads < num_heads`` is grouped-query attention: K/V project
    to fewer heads, each shared by ``num_heads // num_kv_heads`` query
    heads, and the caches store only the kv heads.  ``use_flash`` picks
    the dense forward's attention (``models.transformer.flash_ok``).

    ``pos_encoding="rope"`` rotates q and k at their absolute positions
    in every method (``rope_base``), before the K/V are cached and before
    the kv heads are repeated for the dense dispatch; ``"learned"``
    leaves positions to the model's table.  ``use_bias=False`` makes
    every projection bias-free; ``qkv_bias`` (None follows ``use_bias``)
    gives q/k/v biases of their own, the Qwen2 layout."""

    # the reference's head axes, folded into each projection's weight
    head_folds = HEAD_FOLDS

    def __init__(self, hidden_size: int, num_heads: int,
                 num_kv_heads: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 use_flash: Optional[bool] = None,
                 pos_encoding: str = "learned", rope_base: float = 10000.0,
                 use_bias: bool = True, qkv_bias: Optional[bool] = None):
        super().__init__()
        H = num_heads
        KH = num_kv_heads or H
        if H % KH:
            raise ValueError(
                f"num_heads {H} must be a multiple of num_kv_heads {KH}")
        D = hidden_size // H
        self._h, self._kh, self._d = H, KH, D
        # tensor parallelism (:func:`shard_lm`): the heads this rank
        # projects (``_h``, ``_kh`` shrink to its shard), which of q,
        # k/v and attn_out's input are split
        self.tp: Optional[_TP] = None
        self.q_split = self.kv_split = self.out_split = False
        # sequence parallelism (``TransformerLM(mesh=)``)
        self.sp_mesh = None
        self.sp_strategy = "ring"
        self.dtype = dtype
        self.use_flash = use_flash
        self.rope = pos_encoding == "rope"
        self.rope_base = float(rope_base)
        qkvb = use_bias if qkv_bias is None else qkv_bias
        self.query = nn.Linear(hidden_size, H * D, bias=qkvb)
        self.key = nn.Linear(hidden_size, KH * D, bias=qkvb)
        self.value = nn.Linear(hidden_size, KH * D, bias=qkvb)
        self.attn_out = nn.Linear(H * D, hidden_size, bias=use_bias)

    def _qkv(self, x, pos, xkv=None):
        """q ``[B, T, H, D]``, k and v ``[B, T, KH, D]`` of ``x`` (k and
        v of ``xkv`` where given); under rope q and k are rotated at
        positions ``pos`` (broadcastable against T, see
        :func:`_apply_rope`)."""
        B, T, _ = x.shape
        xkv = x if xkv is None else xkv
        q = _dense(self.query, x, self.dtype).view(B, T, self._h, self._d)
        k = _dense(self.key, xkv, self.dtype).view(B, T, self._kh, self._d)
        v = _dense(self.value, xkv, self.dtype).view(B, T, self._kh,
                                                      self._d)
        if self.rope:
            q = _apply_rope(q, pos, self.rope_base)
            k = _apply_rope(k, pos, self.rope_base)
        return q, k, v

    @staticmethod
    def _expand_kv(t, heads: int):
        """``[B, T, KH, D] -> [B, T, heads, D]`` by repeating each kv
        head over its query group, as the reference does before the
        dispatch, so the flash kernel sees plain multi-head operands."""
        if t.shape[2] == heads:
            return t
        return torch.repeat_interleave(t, heads // t.shape[2], dim=2)

    def _run_q(self, q):
        """The query heads attention runs over: this rank's shard, or
        under a replicated KV cache (``kv_split`` off while q is split:
        the ``KH % tp`` hatch) every head, gathered, so each rank
        computes the whole attention against the whole cache."""
        if self.tp is not None and self.q_split and not self.kv_split:
            return self.tp.all_gather(q, 2)
        return q

    def _out(self, o, B: int, S: int):
        """attn_out of the attention output ``[B, S, heads run, D]``:
        cut to this rank's heads, or gathered, as attn_out's input is
        split or whole."""
        if self.tp is not None:
            o = self.tp.feed(o, self.q_split and self.kv_split,
                             self.out_split, 2)
        return _linear(self.attn_out, o.reshape(B, S, -1), self.dtype,
                       self.tp, self.out_split)

    @property
    def _mesh(self):
        """The mesh the dense forward's attention dispatch sees: the
        model's sequence-parallel mesh while its layers hold a chunk of
        the sequence, else none (a tp rank's heads need no collective
        there)."""
        if self.sp_mesh is not None and dpar.current_seq() is not None:
            return self.sp_mesh
        return None

    def forward(self, x, return_kv: bool = False):
        """Causal attention over ``[B, T, E]`` -> ``[B, T, E]``.
        ``return_kv=True`` also returns this layer's K/V projections
        ``[B, T, KH, D]`` (the KV-arena prefill payload; post-rotation
        under rope; this rank's kv heads under tensor parallelism).
        Under a sequence share (``TransformerLM(mesh=)`` with sp above
        1) x is this rank's chunk, at global positions."""
        B, T, _ = x.shape
        pos = torch.arange(T, device=x.device)
        seq = dpar.current_seq()
        if seq is not None:
            pos = pos + seq[0] * T
        if self.tp is not None and torch.is_grad_enabled():
            out, k, v = self._forward_tp_grad(x, pos)
            return (out, k, v) if return_kv else out
        q, k, v = self._qkv(x, pos)
        q = self._run_q(q)
        H = q.shape[2]
        o = attention_dispatch(q, self._expand_kv(k, H),
                               self._expand_kv(v, H), None, causal=True,
                               mesh=self._mesh, use_flash=self.use_flash,
                               sp_strategy=self.sp_strategy)
        out = self._out(o, B, T)
        return (out, k, v) if return_kv else out

    def _forward_tp_grad(self, x, pos):
        """The tensor-parallel dense forward with gradients: the input
        of the split projections through ``_TP.copy``, and each rank's
        query heads paired with their own kv heads.  Under the ``KH %
        tp`` hatch (k/v whole while q splits) the whole K/V go through
        ``_TP.copy`` too, so the kv projections' gradient is summed over
        the ranks whose query heads read them."""
        tp, (B, T, _) = self.tp, x.shape
        xq = tp.copy(x) if self.q_split else x
        q, k, v = self._qkv(xq, pos, xq if self.kv_split else x)
        if self.q_split and not self.kv_split:
            heads = self._h * tp.size
            kx, vx = (self._expand_kv(tp.copy(t), heads).narrow(
                2, tp.rank * self._h, self._h) for t in (k, v))
        else:
            kx, vx = (self._expand_kv(t, self._h) for t in (k, v))
        o = attention_dispatch(q, kx, vx, None, causal=True,
                               mesh=self._mesh, use_flash=self.use_flash,
                               sp_strategy=self.sp_strategy)
        o = tp.feed(o, self.q_split, self.out_split, 2)
        out = _linear(self.attn_out, o.reshape(B, T, -1), self.dtype, tp,
                      self.out_split)
        return out, k, v

    def decode(self, x1, cache_k, cache_v, pos):
        """One cached decode step against a slot arena, IN PLACE.

        x1: ``[B, 1, E]``; cache_k/cache_v: ``[B, L, KH, D]``; pos: int32
        — a scalar advances the batch in lockstep, a ``[B]`` vector gives
        each row its own position.  Row b's K/V are written at its
        position, then it attends positions ``<= pos[b]``.  Returns
        ``[B, 1, E]`` in the model dtype."""
        B = x1.shape[0]
        L = cache_k.shape[1]
        # rotated at the current position; the cache already holds
        # post-rotation keys for earlier positions
        q, k1, v1 = self._qkv(x1, pos.reshape(1) if pos.dim() == 0
                              else pos[:, None])
        ar = torch.arange(L, device=x1.device)
        if pos.dim() == 0:
            cache_k[:, pos] = k1[:, 0].to(cache_k.dtype)
            cache_v[:, pos] = v1[:, 0].to(cache_v.dtype)
            visible = (ar <= pos)[None, None, None, None, :]
        else:
            rows = torch.arange(B, device=x1.device)
            p = pos.long()
            cache_k[rows, p] = k1[:, 0].to(cache_k.dtype)
            cache_v[rows, p] = v1[:, 0].to(cache_v.dtype)
            visible = (ar[None, :] <= p[:, None])[:, None, None, None, :]
        o = cache_attention(self._run_q(q), cache_k, cache_v, visible)
        return self._out(o, B, 1)

    def decode_k(self, xs, cache_k, cache_v, pos):
        """Cached decode of S tokens per row at once against a slot
        arena, IN PLACE: row b's tokens occupy positions ``pos[b] ..
        pos[b]+S-1`` (positions past the cache length are dropped), and
        token j attends positions ``<= pos[b] + j`` — block-causal
        against the cache.  xs: ``[B, S, E]``; pos: ``[B]`` int32.
        Returns ``[B, S, E]`` in the model dtype."""
        B, S, _ = xs.shape
        L = cache_k.shape[1]
        p = pos[:, None].long() + torch.arange(S, device=xs.device)[None]
        q, ks, vs = self._qkv(xs, p)
        keep = p < L
        rows = torch.arange(B, device=xs.device)[:, None].expand(B, S)
        cache_k[rows[keep], p[keep]] = ks[keep].to(cache_k.dtype)
        cache_v[rows[keep], p[keep]] = vs[keep].to(cache_v.dtype)
        visible = (torch.arange(L, device=xs.device)[None, None, :]
                   <= p[:, :, None])[:, None, None, :, :]
        o = cache_attention(self._run_q(q), cache_k, cache_v, visible)
        return self._out(o, B, S)

    def decode_paged(self, xs, pool_k, pool_v, tables, pos, limit=None,
                     kernel="fused"):
        """Cached decode of S tokens per row against a PAGED KV cache.

        xs: ``[B, S, E]``; pool_k/pool_v ``[N, KH, bs, D]`` (or QuantKV
        int8 pools); tables ``[B, M]`` int32; pos ``[B]`` int32 — row
        b's tokens occupy logical positions ``pos[b] .. pos[b]+S-1``.
        The S new K/V rows are written through the tables first (writes
        at positions ``>= limit[b]`` are dropped), then read back by
        :func:`paged_attention`, so each token attends itself.  Returns
        ``[B, S, E]`` in the model dtype."""
        B, S, _ = xs.shape
        q, ks, vs = self._qkv(xs, pos[:, None].long() + torch.arange(
            S, device=xs.device)[None])
        paged_kv_update(pool_k, pool_v, tables, pos, ks, vs, limit=limit)
        o = paged_attention(self._run_q(q), pool_k, pool_v, tables, pos,
                            kernel=kernel)
        return self._out(o, B, S)


class DecoderLayer(nn.Module):
    """Pre-norm causal decoder block: ``norm`` is ``"layernorm"`` or
    ``"rmsnorm"``, ``mlp`` ``"gelu"`` (tanh-GELU) or ``"swiglu"``
    (``ffn_down(silu(ffn_gate(x)) * ffn_up(x))``, all in the model
    dtype); ``use_bias``/``qkv_bias`` and the position knobs go to the
    attention (:class:`DecoderAttention`), ``use_bias`` to the MLP."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 num_kv_heads: Optional[int] = None,
                 ln_eps: float = 1e-6,
                 use_flash: Optional[bool] = None,
                 pos_encoding: str = "learned", rope_base: float = 10000.0,
                 norm: str = "layernorm", mlp: str = "gelu",
                 use_bias: bool = True, qkv_bias: Optional[bool] = None):
        super().__init__()
        if mlp not in ("gelu", "swiglu"):
            raise ValueError(f"mlp must be 'gelu' or 'swiglu', got {mlp!r}")
        self.dtype = dtype
        self.dropout = float(dropout)
        self.swiglu = mlp == "swiglu"
        self.ln_attn = _make_norm(norm, hidden_size, ln_eps)
        self.attention = DecoderAttention(
            hidden_size, num_heads, num_kv_heads=num_kv_heads, dtype=dtype,
            use_flash=use_flash, pos_encoding=pos_encoding,
            rope_base=rope_base, use_bias=use_bias, qkv_bias=qkv_bias)
        self.ln_ffn = _make_norm(norm, hidden_size, ln_eps)
        self.ffn_up = nn.Linear(hidden_size, intermediate_size,
                                bias=use_bias)
        self.ffn_down = nn.Linear(intermediate_size, hidden_size,
                                  bias=use_bias)
        if self.swiglu:
            self.ffn_gate = nn.Linear(hidden_size, intermediate_size,
                                      bias=use_bias)
        # tensor parallelism (:func:`shard_lm`): ffn_up/ffn_gate's output
        # and ffn_down's input split over tp
        self.tp: Optional[_TP] = None
        self.up_split = self.down_split = False

    def _mlp(self, x):
        if self.tp is not None and self.up_split:
            x = self.tp.copy(x)
        up = _dense(self.ffn_up, x, self.dtype)
        if self.swiglu:
            h = F.silu(_dense(self.ffn_gate, x, self.dtype)) * up
        else:
            h = F.gelu(up, approximate="tanh")
        if self.tp is not None:
            h = self.tp.feed(h, self.up_split, self.down_split, -1)
        return _linear(self.ffn_down, h, self.dtype, self.tp,
                       self.down_split)

    def _residual(self, x, a, train: bool = False,
                  rng: Optional[int] = None):
        """``x + drop(a)``, then ``+ drop(mlp(ln_ffn(.)))``: the two
        dropout sites of the reference's block, seeded ``site_seed(rng,
        0)`` and ``site_seed(rng, 1)`` (identity unless ``train``)."""
        x = x + dropout(a, self.dropout, site_seed(rng, 0), train)
        h = self._mlp(self.ln_ffn(x).to(self.dtype))
        return x + dropout(h, self.dropout, site_seed(rng, 1), train)

    def forward(self, x, train: bool = False, rng: Optional[int] = None):
        return self.forward_kv(x, train, rng)[0]

    def forward_kv(self, x, train: bool = False,
                   rng: Optional[int] = None):
        """The dense forward that also returns this layer's K/V
        ``[B, T, KH, D]``: the prompt-prefill payload the engine writes
        into its KV arena.  ``train`` applies dropout with masks seeded
        from ``rng`` (:func:`models.transformer.dropout`)."""
        a, k, v = self.attention(self.ln_attn(x).to(self.dtype),
                                 return_kv=True)
        return self._residual(x, a, train, rng), k, v

    def decode(self, x1, cache_k, cache_v, pos):
        a = self.attention.decode(self.ln_attn(x1).to(self.dtype),
                                  cache_k, cache_v, pos)
        return self._residual(x1, a)

    def decode_k(self, xs, cache_k, cache_v, pos):
        a = self.attention.decode_k(self.ln_attn(xs).to(self.dtype),
                                    cache_k, cache_v, pos)
        return self._residual(xs, a)

    def decode_paged(self, xs, pool_k, pool_v, tables, pos, limit=None,
                     kernel="fused"):
        a = self.attention.decode_paged(
            self.ln_attn(xs).to(self.dtype), pool_k, pool_v, tables, pos,
            limit=limit, kernel=kernel)
        return self._residual(xs, a)


class TransformerLM(nn.Module):
    """Decoder-only LM, served through a slot-arena or a paged KV cache
    (``serving/continuous.py``) or by :func:`generate`.

    The defaults are the GPT-2 shape (learned positions, LayerNorm,
    tanh-GELU, biases, tied head).  The Llama family is
    ``pos_encoding="rope"`` (``rope_base``; no position table, and
    ``max_position`` still bounds a sequence), ``norm="rmsnorm"``,
    ``mlp="swiglu"``, ``use_bias=False`` (with ``qkv_bias=True`` for
    Qwen2's biased q/k/v) and ``tied_head=False``, an f32 bias-free
    ``lm_head``; ``num_kv_heads`` sets grouped-query attention in
    either.  ``dropout`` applies after each block's attention and MLP in
    a training forward, with masks seeded from the forward's ``rng``
    (the Estimator passes one a step); ``remat=True`` recomputes each
    block in backward.  ``moe_experts`` takes only 0 (not ported yet).

    Parameters are created f32 with GPT-2's initialisation (normal
    0.02, zero biases, unit norm scales) from the global torch
    generator; seed it with ``torch.manual_seed`` for reproducible
    random weights, or load converted weights (:func:`params_from_flax`).
    ``use_flash`` picks the dense forward's attention, as in the
    reference: ``None`` is the flash kernel on a CUDA tensor (for a head
    dim the kernels take, ``models.transformer.flash_ok``) and plain
    full attention otherwise; ``True``/``False`` force either.
    """

    def __init__(self, vocab_size: int, hidden_size: int = 256,
                 num_layers: int = 4, num_heads: int = 4,
                 intermediate_size: int = 1024, max_position: int = 512,
                 dtype: torch.dtype = torch.bfloat16,
                 use_flash: Optional[bool] = None,
                 num_kv_heads: Optional[int] = None,
                 pos_encoding: str = "learned", ln_eps: float = 1e-6,
                 norm: str = "layernorm", mlp: str = "gelu",
                 use_bias: bool = True, tied_head: bool = True,
                 moe_experts: int = 0, rope_base: float = 10000.0,
                 qkv_bias: Optional[bool] = None, dropout: float = 0.0,
                 remat: bool = False, mesh=None, sp_strategy: str = "ring"):
        super().__init__()
        if sp_strategy not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp strategy {sp_strategy!r} "
                             "(expected 'ring' or 'ulysses')")
        if moe_experts:
            raise NotImplementedError(
                f"moe_experts={moe_experts!r} is not ported yet (ROADMAP "
                f"Queue 1 item 2: MoE layers)")
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"pos_encoding must be 'learned' or 'rope', "
                             f"got {pos_encoding!r}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.max_position = max_position
        self.dtype = dtype
        self.tied_head = tied_head
        self.remat = bool(remat)
        self.embed = nn.Embedding(vocab_size, hidden_size)
        # rope rotates q/k inside attention: no absolute position table
        self.pos_embed = nn.Embedding(max_position, hidden_size) \
            if pos_encoding == "learned" else None
        self.use_flash = use_flash
        self.layers = nn.ModuleList(
            DecoderLayer(hidden_size, num_heads, intermediate_size,
                         dropout, dtype=dtype, num_kv_heads=num_kv_heads,
                         ln_eps=ln_eps, use_flash=use_flash,
                         pos_encoding=pos_encoding, rope_base=rope_base,
                         norm=norm, mlp=mlp, use_bias=use_bias,
                         qkv_bias=qkv_bias)
            for _ in range(num_layers))
        self.ln_f = _make_norm(norm, hidden_size, ln_eps)
        # the sequence-parallel mesh of the dense forward
        self.mesh = mesh
        for layer in self.layers:
            layer.attention.sp_mesh = mesh
            layer.attention.sp_strategy = sp_strategy
        if not tied_head:
            self.lm_head = nn.Linear(hidden_size, vocab_size, bias=False)
        # tensor parallelism (:func:`shard_lm`): the embedding's rows and
        # the head's vocab split over tp
        self.tp: Optional[_TP] = None
        self.vocab_split = self.head_split = False
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif not name.endswith("scale"):
                    p.normal_(0.0, 0.02)

    def tp_shard(self, mesh, placements) -> dict:
        """Shard over ``mesh``'s ``tp`` axis under ``placements`` (the
        Estimator's ``partition_rules``, matched by
        ``parallel.partition.shard_module``): :func:`shard_lm_placed`."""
        return shard_lm_placed(self, mesh, placements)

    @property
    def kv_heads(self) -> int:
        """Heads actually stored in the KV cache (GQA-aware)."""
        return self.num_kv_heads or self.num_heads

    @property
    def cache_kv_heads(self) -> int:
        """The kv heads THIS rank's KV cache stores: :attr:`kv_heads`,
        or its shard under tensor parallelism with the k/v projections
        split (:func:`shard_lm`)."""
        if not self.layers:
            return self.kv_heads
        return self.layers[0].attention._kh

    def _logits(self, x):
        # f32 logits for a stable softmax/argmax, tied or untied; a
        # vocab-split head computes its slice and gathers the rest, so
        # every rank picks from the same logits
        if self.head_split if not self.tied_head else self.vocab_split:
            x = self.tp.copy(x)
        if not self.tied_head:
            q = int8_of(self.lm_head)
            if q is not None:
                from analytics_zoo_tpu_torch.learn.quantize import \
                    int8_dense

                out = int8_dense(x.float(), q)
            else:
                out = F.linear(x.float(), self.lm_head.weight.float())
            split = self.head_split
        else:
            out = x.float() @ self.embed.weight.float().t()
            split = self.vocab_split
        return self.tp.all_gather(out, -1) if split else out

    def _lookup(self, toks):
        """The token embeddings; a vocab-split table looks up the ids
        in its rows (``parallel.partition.vocab_lookup``)."""
        if not self.vocab_split:
            return self.embed(toks)
        return vocab_lookup(self.embed.weight, toks, self.tp.line)

    def _embed(self, toks, p):
        """Token embeddings (plus, for learned positions, the table's
        rows at positions ``p``) in the compute dtype."""
        x = self._lookup(toks)
        if self.pos_embed is not None:
            # positions past the table (padding columns of a suffix
            # grid) are clamped: their rows are never read, and an
            # out-of-range lookup would be a device assert on CUDA
            x = x + self.pos_embed(torch.clamp(p, max=self.max_position - 1))
        return x.to(self.dtype)

    def hidden_states(self, tokens, train: bool = False, *,
                      rng: Optional[int] = None):
        """Final-norm hidden states ``[B, T, E]`` (f32) of the
        causal forward: the forward minus the vocab head.  ``train``
        applies dropout, layer i's masks seeded from ``site_seed(rng,
        i)``, and ``remat`` recomputes each layer in backward.  With a
        ``mesh`` whose ``sp`` is above 1 the layers run on this rank's
        chunk of the sequence (the causal ring over global positions)
        and the whole is gathered after the final norm."""
        x = self._embed_prompt(tokens)
        sp = cc.Line.of(self.mesh, "sp")
        if x.shape[1] % sp.size:
            raise ValueError(f"sequence length {x.shape[1]} does not "
                             f"divide over sp={sp.size}")
        x = cc.split_seq(x, sp)
        with dpar.seq_of_global(sp.index, sp.size):
            for i, layer in enumerate(self.layers):
                x = run_layer(layer, self.remat, train, x, train,
                              site_seed(rng, i))
        return cc.gather_seq(self.ln_f(x), sp)

    def forward(self, tokens, train: bool = False, *,
                rng: Optional[int] = None):
        """Causal forward: logits ``[B, T, V]`` (f32)."""
        return self._logits(self.hidden_states(tokens, train, rng=rng))

    def _embed_prompt(self, tokens):
        """The embeddings of ``[B, T]`` tokens at positions ``0 .. T-1``
        (:meth:`_embed`), in the compute dtype."""
        T = tokens.shape[1]
        if T > self.max_position:
            raise ValueError(
                f"sequence length {T} exceeds max_position "
                f"{self.max_position} (out-of-range position lookups "
                f"would read clamped rows)")
        return self._embed(tokens.long(),
                           torch.arange(T, device=tokens.device)[None])

    def _prefill_hidden(self, tokens):
        """The causal forward's final-norm hidden states ``[B, T, E]``
        and every layer's K/V, stacked ``[n_layers, B, T, KH, D]``."""
        x = self._embed_prompt(tokens)
        ks, vs = [], []
        for layer in self.layers:
            x, k, v = layer.forward_kv(x)
            ks.append(k)
            vs.append(v)
        return self.ln_f(x), torch.stack(ks), torch.stack(vs)

    def prefill(self, tokens):
        """Causal forward that ALSO returns every layer's K/V: ``(logits
        [B, T, V], ks [n_layers, B, T, KH, D], vs)``.  One forward
        replaces T sequential decode steps when a request joins the
        slot arena."""
        h, ks, vs = self._prefill_hidden(tokens)
        return self._logits(h), ks, vs

    def decode_step(self, tok, caches_k, caches_v, pos):
        """One cached decode step against a slot arena, caches updated
        IN PLACE.  tok: ``[B]`` current tokens; caches_k/v:
        ``[n_layers, B, L, kv_heads, D]``; pos: int32, a scalar (lockstep
        batch) or ``[B]`` (per-row positions).  Returns logits ``[B, V]``
        (f32)."""
        p = pos.reshape(1, 1) if pos.dim() == 0 else pos[:, None]
        x = self._embed(tok[:, None].long(), p.long())
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, caches_k[i], caches_v[i], pos)
        return self._logits(self.ln_f(x))[:, 0]

    def verify_step(self, toks, caches_k, caches_v, pos):
        """Cached decode of S tokens per row in one forward (caches
        updated in place): toks ``[B, S]``; pos ``[B]`` int32, row b's
        tokens land at positions ``pos[b] .. pos[b]+S-1``.  Returns
        logits ``[B, S, V]``."""
        return self._logits(self.verify_hidden(toks, caches_k, caches_v,
                                               pos))

    def verify_hidden(self, toks, caches_k, caches_v, pos):
        """:meth:`verify_step` minus the vocab head: the final-norm
        hidden states ``[B, S, E]`` (f32)."""
        S = toks.shape[1]
        p = pos[:, None].long() + torch.arange(S, device=toks.device)
        x = self._embed(toks.long(), p)
        for i, layer in enumerate(self.layers):
            x = layer.decode_k(x, caches_k[i], caches_v[i], pos)
        return self.ln_f(x)

    def prefill_chunk(self, toks, caches_k, caches_v, pos, lens):
        """Prefill of a right-padded ``[B, C]`` chunk per row against the
        slot arena at positions ``pos[b] ..`` (caches updated in place;
        padding columns write dead K/V past the row's frontier, which
        later writes overwrite before anything attends them).  Returns
        each row's last-real-position logits ``[B, V]``, the head
        applied to ``[B, E]`` only."""
        h = self.verify_hidden(toks, caches_k, caches_v, pos)
        last_h = h[torch.arange(h.shape[0], device=h.device),
                   lens.long() - 1]
        return self._logits(last_h)

    def decode_step_paged(self, tok, pools_k, pools_v, tables, pos,
                          kernel="fused"):
        """One cached decode step against a PAGED KV cache.

        tok: ``[B]`` current tokens; pools_k/v: ``[n_layers, N,
        kv_heads, bs, D]`` (or QuantKV int8 pools) — one flat block pool
        per layer, updated in place; tables: ``[B, M]`` int32; pos:
        ``[B]`` int32.  Returns logits ``[B, V]`` (f32)."""
        x = self._embed(tok[:, None].long(), pos[:, None].long())
        for i, layer in enumerate(self.layers):
            x = layer.decode_paged(x, pools_k[i], pools_v[i], tables, pos,
                                   kernel=kernel)
        return self._logits(self.ln_f(x))[:, 0]

    def verify_step_paged(self, toks, pools_k, pools_v, tables, pos,
                          kernel="fused"):
        """:meth:`verify_step` against a paged cache: S tokens per row
        in one block-causal forward, their K/V written through the block
        tables (pools updated in place).  Returns logits ``[B, S, V]``.
        All S entries are written; a caller that advances ``pos`` by
        fewer than S leaves the surplus entries dead, and the next call
        overwrites them before the causal mask reaches them: speculative
        rollback copies no block."""
        return self._logits(self.verify_hidden_paged(
            toks, pools_k, pools_v, tables, pos, kernel=kernel))

    def verify_hidden_paged(self, toks, pools_k, pools_v, tables, pos,
                            limit=None, kernel="fused"):
        """S tokens per row in one block-causal forward against the
        paged cache (pools updated in place); returns the final-norm
        hidden states ``[B, S, E]`` (f32).  ``limit`` ([B] int32,
        optional) drops K/V writes at positions ``>= limit[b]``."""
        S = toks.shape[1]
        p = pos[:, None].long() + torch.arange(S, device=toks.device)
        x = self._embed(toks.long(), p)
        for i, layer in enumerate(self.layers):
            x = layer.decode_paged(x, pools_k[i], pools_v[i], tables, pos,
                                   limit=limit, kernel=kernel)
        return self.ln_f(x)

    def prefill_chunk_paged(self, toks, pools_k, pools_v, tables, pos,
                            lens, kernel="fused"):
        """Paged prefill of a right-padded ``[B, C]`` chunk per row at
        positions ``pos[b] ..``; writes are limited to ``pos + lens`` so
        padding columns write nothing.  Returns each row's
        last-real-position logits ``[B, V]`` (the head applied to
        ``[B, 1, E]``, never a ``[B, C, V]`` cube).  Also the whole of
        paged admission: a prompt's unshared suffix is its one chunk."""
        h = self.verify_hidden_paged(toks, pools_k, pools_v, tables, pos,
                                     limit=pos + lens, kernel=kernel)
        last_h = h[torch.arange(h.shape[0], device=h.device),
                   lens.long() - 1]
        return self._logits(last_h)


def lm_loss(logits, tokens):
    """Shifted next-token cross-entropy, mean over ``B x (T-1)``: the
    reference's ``lm_loss``.  logits ``[B, T, V]`` (computed in f32),
    tokens ``[B, T]`` integer."""
    V = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, V).float(),
                           tokens[:, 1:].reshape(-1).long())


def fused_lm_loss(per_sample_losses, _tokens):
    """Estimator loss for :class:`LMWithFusedLoss`: the model's output is
    already each row's cross-entropy, so the loss is their mean."""
    return per_sample_losses.mean()


def _block_ce(hx, yx, mx, emb, tp=None):
    """One block's summed masked cross-entropy per row: logits ``[B, tb,
    V]`` of the f32 hidden slice against the f32 table, made and
    dropped here (``LMWithFusedLoss`` recomputes them in backward).  A
    vocab-split table's logits are gathered over ``tp``."""
    logits = hx @ emb.t()
    if tp is not None:
        logits = tp.all_gather(logits, -1)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         yx.reshape(-1), reduction="none")
    return (ce.view(yx.shape) * mx).sum(dim=1)


class LMWithFusedLoss(nn.Module):
    """Training wrapper of a tied-head :class:`TransformerLM` that
    computes the shifted next-token cross-entropy block by block over
    the sequence, never keeping the ``[B, T, V]`` logits: the reference's
    ``LMWithFusedLoss``.

    The final hidden states (``lm.hidden_states``) are cut into blocks of
    ``t_block`` positions (the last padded with zeros and masked out, as
    the reference pads its scan); each block's f32 head product and
    cross-entropy run under ``torch.utils.checkpoint`` (non-reentrant),
    so backward recomputes that block's logits from its hidden slice and
    the peak holds one block's ``[B, t_block, V]`` at a time.  The cost is
    one more head product per block in backward.

    ``forward(tokens, train=False, *, rng=None)`` returns each row's mean
    cross-entropy ``[B]`` (f32); use ``loss=fused_lm_loss`` with the
    Estimator, and serve or generate with the inner ``lm``.  The mean of
    the output equals ``lm_loss(lm(tokens), tokens)``.  An untied head
    raises, as in the reference."""

    def __init__(self, lm: TransformerLM, t_block: int = 512):
        super().__init__()
        if not lm.tied_head:
            raise ValueError(
                "LMWithFusedLoss computes blockwise logits from the TIED "
                "embedding table; an untied-head model (tied_head=False, "
                "e.g. a llama import) would silently train the wrong "
                "projection: use loss=lm_loss on the plain model")
        self.lm = lm
        self.t_block = int(t_block)

    def forward(self, tokens, train: bool = False, *,
                rng: Optional[int] = None):
        from torch.utils.checkpoint import checkpoint

        h = self.lm.hidden_states(tokens, train, rng=rng)
        emb = self.lm.embed.weight.float()
        tp = self.lm.tp if self.lm.vocab_split else None
        if tp is not None:
            h = tp.copy(h)
        hs = h[:, :-1].float()
        ys = tokens[:, 1:].long()
        B, n, _ = hs.shape
        tb = min(self.t_block, n)
        pad = (-n) % tb
        if pad:
            hs = F.pad(hs, (0, 0, 0, pad))
            ys = F.pad(ys, (0, pad))
        mask = (torch.arange(n + pad, device=hs.device) < n).float()
        total = torch.zeros(B, dtype=torch.float32, device=hs.device)
        for lo in range(0, n + pad, tb):
            part = (hs[:, lo:lo + tb], ys[:, lo:lo + tb], mask[lo:lo + tb],
                    emb, tp)
            if torch.is_grad_enabled():
                total = total + checkpoint(_block_ce, *part,
                                           use_reentrant=False)
            else:
                total = total + _block_ce(*part)
        return total / n


def top_p_filter(scaled, top_p):
    """Nucleus filter over the last axis, the reference's
    ``top_p_filter``: keep the smallest set of tokens whose
    (temperature-scaled) probability mass reaches ``top_p``; everything
    else goes to -inf.  The highest-probability token always survives.
    ``top_p`` is a scalar or a per-row ``[..., 1]`` tensor; values >= 1
    or <= 0 disable the filter row-wise."""
    probs = torch.softmax(scaled, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sorted_probs, dim=-1)
    top_p = torch.as_tensor(top_p, dtype=scaled.dtype, device=scaled.device)
    # rank of the last kept token: first index where csum >= top_p
    keep_n = (csum < top_p).sum(dim=-1, keepdim=True) + 1
    kth = torch.gather(sorted_probs, -1,
                       torch.clamp(keep_n - 1, max=scaled.shape[-1] - 1))
    active = (top_p > 0.0) & (top_p < 1.0)
    return torch.where(active & (probs < kth),
                       torch.full_like(scaled, float("-inf")), scaled)


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a 32-bit
    constant, with every partial product below 2**63 (int64 arithmetic
    gives the same bits on the CPU and the card)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """MurmurHash3's 32-bit finalizer (a bijection with full
    avalanche) on int64 values in ``[0, 2**32)``."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def draw_uniforms(seeds, pos, vocab: int):
    """``[B, vocab]`` float64 uniforms in (0, 1), a pure function of each
    row's (seed, position) and the vocab index: 24 bits of a hash of the
    three, made in int64 on the rows' device."""
    seeds = torch.as_tensor(seeds).to(torch.int64) & _M32
    pos = torch.as_tensor(pos, device=seeds.device).to(torch.int64) & _M32
    base = _fmix32(_fmix32(seeds) ^ pos)
    idx = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    h = _fmix32(base[:, None] ^ _mul32(idx, 0x9E3779B1)[None])
    return ((h >> 8).to(torch.float64) + 0.5) * (1.0 / (1 << 24))


def pick_next(logits, pos, temps=None, seeds=None, top_ps=None,
              top_k: int = 0):
    """One token per row from per-row logits ``[B, V]``: the ONE pick
    definition of :func:`generate` and of the serving engine's first
    token and decode ticks, so a preempted and readmitted row replays
    identical tokens and the engine equals ``generate`` on the same
    seed.

    ``temps is None``: greedy argmax for every row.  Otherwise rows
    with ``temps > 0`` sample: ``logits / max(T, 1e-6)`` in f32, the
    ``top_k`` highest kept when ``top_k > 0``, then :func:`top_p_filter`
    when ``top_ps`` is given, then Gumbel-max with the uniforms of
    :func:`draw_uniforms` at (``seeds``, ``pos``), where ``pos`` is the
    absolute position of the token whose logits these are.  Rows with
    ``temps <= 0`` keep the argmax.  Returns int32 ``[B]``."""
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    if temps is None:
        return nxt
    temps = torch.as_tensor(temps, dtype=torch.float32,
                            device=logits.device)
    scaled = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth,
                             torch.full_like(scaled, float("-inf")), scaled)
    if top_ps is not None:
        scaled = top_p_filter(scaled, torch.as_tensor(
            top_ps, dtype=torch.float32, device=logits.device)[:, None])
    u = draw_uniforms(torch.as_tensor(seeds, device=logits.device), pos,
                      logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(scaled.double() + gumbel, dim=-1).to(torch.int32)
    return torch.where(temps > 0.0, sampled, nxt)


@torch.no_grad()
def generate(model: TransformerLM, variables, prompt, max_new_tokens: int,
             prompt_len=None, *, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 0.0, rng=None, eos_id: Optional[int] = None,
             prefill: str = "auto", device=None) -> torch.Tensor:
    """Generation with a slot-arena KV cache, the reference's
    forward-prefill path: one block-causal :meth:`~TransformerLM.
    verify_hidden` over the whole right-padded prompt fills the cache,
    then ``max_new_tokens - 1`` decode steps run at per-row positions.

    prompt: ``[B, P]`` int32 (numpy or tensor); ``prompt_len`` (optional
    ``[B]``) gives each row's true length, clipped to ``[1, P]``.
    ``variables``: a ``state_dict`` loaded into ``model`` first, or
    ``None`` for the model's own weights.  ``eos_id``: once a row emits
    it, the rest of the row is eos.  Runs on ``device`` (``cuda``
    unless the caller names another).  Returns int32
    ``[B, max_new_tokens]`` on that device.

    Sampling: ``temperature > 0`` samples through :func:`pick_next`,
    optionally truncated to the ``top_k`` most probable tokens and to
    the ``top_p`` nucleus (0 or >= 1 disables it).  ``rng`` is then
    required: an integer seed for every row, or ``[B]`` seeds, one a
    row.  The draw at each step is a function of (seed, position,
    logits) only, so the serving engine given the same seed emits the
    same tokens.  The reference samples on its lockstep scan path with
    threefry; the port samples on the forward-prefill path with its own
    random numbers.  ``prefill="scan"`` (ROADMAP Queue 1 item 2) is not
    ported yet and raises."""
    if prefill == "scan":
        raise NotImplementedError(
            "prefill='scan' is not ported yet (ROADMAP Queue 1 item 2)")
    if prefill not in ("auto", "forward"):
        raise ValueError(f"prefill must be auto|forward|scan, got "
                         f"{prefill!r}")
    if max_new_tokens < 1:
        raise ValueError("forward-prefill generation needs "
                         "max_new_tokens > 0")
    sampled = temperature > 0.0
    if sampled and rng is None:
        raise ValueError("temperature > 0 needs rng= (an integer seed, or "
                         "one seed a row)")
    dev = resolve_device(device)
    if variables is not None:
        model.load_state_dict(variables)
    model = model.to(dev).eval()
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32,
                             device=dev)
    B, Pn = prompt.shape
    L = Pn + max_new_tokens
    if L > model.max_position:
        raise ValueError(f"prompt+new = {L} exceeds max_position "
                         f"{model.max_position}")
    plen = torch.full((B,), Pn, dtype=torch.int32, device=dev) \
        if prompt_len is None else torch.clamp(
            torch.as_tensor(np.asarray(prompt_len), dtype=torch.int32,
                            device=dev), 1, Pn)
    samp = {}
    if sampled:
        seeds = np.broadcast_to(np.asarray(rng, np.int64) & _M32, (B,))
        samp = dict(temps=torch.full((B,), float(temperature), device=dev),
                    seeds=torch.as_tensor(seeds.copy(), device=dev),
                    top_ps=(torch.full((B,), float(top_p), device=dev)
                            if top_p > 0.0 else None),
                    top_k=int(top_k))
    D = model.hidden_size // model.num_heads
    ck = torch.zeros((model.num_layers, B, L, model.kv_heads, D),
                     dtype=model.dtype, device=dev)
    cv = torch.zeros_like(ck)
    # one block-causal forward writes K/V for every prompt position;
    # entries past a row's true length are dead (its mask never reaches
    # them) and generation overwrites them in order
    hidden = model.verify_hidden(prompt, ck, cv,
                                 torch.zeros(B, dtype=torch.int32,
                                             device=dev))
    last_h = hidden[torch.arange(B, device=dev), plen.long() - 1]
    tok = pick_next(model._logits(last_h), plen - 1, **samp)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    if eos_id is not None:
        done = tok == eos_id
    out, pos = [tok], plen
    for _ in range(max_new_tokens - 1):
        logits = model.decode_step(tok, ck, cv, pos)
        nxt = pick_next(logits, pos, **samp)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tok, pos = nxt, pos + 1
        out.append(nxt)
    return torch.stack(out, dim=1)


def params_from_flax(params, model: Optional["TransformerLM"] = None
                     ) -> Dict[str, torch.Tensor]:
    """The reference ``TransformerLM``'s ``variables["params"]`` tree
    (leaves as numpy arrays or anything ``np.asarray`` takes) as this
    model's ``state_dict``.  ``DenseGeneral`` kernels fold their head
    axes (``query``/``key``/``value`` ``[E, H, D]``, ``attn_out``
    ``[H, D, E]``) and every kernel transposes to ``nn.Linear``'s
    ``[out, in]``.  Every tree the reference builds converts: learned
    positions or none (rope), LayerNorm ``scale``/``bias`` or RMSNorm
    ``scale``, any projection with or without its bias (q/k/v biases
    alone, as in Qwen2), ``ffn_gate`` (SwiGLU) and an untied ``lm_head``
    (``[E, V]`` to ``[V, E]``).  Given a ``model`` sharded by
    :func:`shard_lm`, each tensor it splits comes back cut to this
    rank's shard (the tree is converted on the host; the device receives
    the shards only)."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    out: Dict[str, torch.Tensor] = {}

    def linear(name, p, in_dims):
        k = np.asarray(p["kernel"], np.float32)
        n_in = int(np.prod(k.shape[:in_dims]))
        out[name + ".weight"] = t(k.reshape(n_in, -1).T)
        if "bias" in p:
            out[name + ".bias"] = t(np.asarray(p["bias"]).reshape(-1))

    def norm(name, p):
        out[name + ".scale"] = t(p["scale"])
        if "bias" in p:
            out[name + ".bias"] = t(p["bias"])

    out["embed.weight"] = t(params["embed"]["embedding"])
    if "pos_embed" in params:
        out["pos_embed.weight"] = t(params["pos_embed"]["embedding"])
    norm("ln_f", params["ln_f"])
    if "lm_head" in params:
        linear("lm_head", params["lm_head"], 1)
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        lp, pre = params[f"layer_{i}"], f"layers.{i}."
        for ln in ("ln_attn", "ln_ffn"):
            norm(pre + ln, lp[ln])
        for name, in_dims in HEAD_FOLDS.items():
            linear(f"{pre}attention.{name}", lp["attention"][name], in_dims)
        for name in ("ffn_up", "ffn_down", "ffn_gate"):
            if name in lp:
                linear(pre + name, lp[name], 1)
    if model is not None and model.tp is not None:
        own = model.state_dict()
        out = {k: _rank_piece(model, k, t, own[k].shape)
               for k, t in out.items()}
    return out


# ---------------------------------------------------------------------------
# tensor parallelism: the reference's partition rules on this model
# ---------------------------------------------------------------------------

def shard_lm(model: TransformerLM, mesh, rules=None) -> dict:
    """Shard ``model`` IN PLACE over ``mesh``'s ``tp`` axis under the
    reference's partition ``rules`` (default :data:`LM_PARTITION_RULES`,
    matched once by ``parallel.partition.param_placements``), and return
    ``{"kv": bool}``: whether its k/v projections (so its KV cache) are
    split.  ``tp`` of 1 leaves the model as it is, and a model already
    sharded over ``mesh`` (by another engine that serves it) stays as it
    is.  :func:`shard_lm_placed` does the cutting."""
    if model.tp is not None:
        if model.tp.mesh is not mesh:
            raise ValueError("this model is already sharded over "
                             "another mesh")
        # sharded for another engine on this mesh: shared as it is
        return {"kv": any(layer.attention.kv_split
                          for layer in model.layers)}
    if mesh.size("tp") > 1:
        shard_lm_placed(model, mesh, param_placements(
            model, rules or LM_PARTITION_RULES, mesh))
    return {"kv": any(layer.attention.kv_split for layer in model.layers)}


def shard_lm_placed(model: TransformerLM, mesh, placements) -> dict:
    """Shard ``model`` IN PLACE over ``mesh``'s ``tp`` axis (above 1)
    under ``placements`` (each parameter's placement in the port's dims)
    and return the placements of the parameters cut.

    Each rank keeps its shard of every split tensor: q/k/v, ``ffn_up``
    and ``ffn_gate`` by output features (their biases with them),
    ``attn_out`` and ``ffn_down`` by input features (the f32 partial
    products all-reduced, the bias added once), the embedding and an
    untied head by vocab rows (a masked lookup then an all-reduce; the
    logits all-gathered before the pick).  A query head ``h = kh*G + g``
    stays with its kv head.  A tensor whose split dim does not divide tp
    stays whole (the rules' divisibility fallback): k/v of a model whose
    kv heads do not divide tp replicate, every rank gathers the query
    heads and computes the whole attention against the whole cache, and
    keeps its heads for ``attn_out``."""
    tp = _TP(mesh)

    def split(name, dim):
        return tp_dim(placements, name, (dim,)) == dim

    model.tp = tp
    dims = {}
    model.vocab_split = split("embed.weight", 0)
    if model.vocab_split:
        dims["embed.weight"] = 0
    if not model.tied_head:
        model.head_split = split("lm_head.weight", 0)
        if model.head_split:
            dims["lm_head.weight"] = 0
    for i, layer in enumerate(model.layers):
        att = layer.attention
        pre = f"layers.{i}."
        q, k, v = (split(f"{pre}attention.{n}.weight", 0)
                   for n in ("query", "key", "value"))
        o = split(pre + "attention.attn_out.weight", 1)
        if k != v or (k and not q):
            raise NotImplementedError(
                f"layer {i}: key split {k}, value split {v}, query split "
                f"{q}: the port splits k and v together, and only with q "
                f"(ROADMAP Queue 1 item 6.6)")
        att.tp, att.q_split, att.kv_split, att.out_split = tp, q, k, o
        cols = (["query"] if q else []) + (["key", "value"] if k else [])
        dims.update({f"{pre}attention.{n}.{a}": 0 for n in cols
                     for a in ("weight", "bias")})
        if q:
            att._h //= tp.size
        if k:
            att._kh //= tp.size
        if o:
            dims[pre + "attention.attn_out.weight"] = 1
        up = split(pre + "ffn_up.weight", 0)
        if layer.swiglu and split(pre + "ffn_gate.weight", 0) != up:
            raise NotImplementedError(
                f"layer {i}: ffn_gate split differs from ffn_up's "
                f"(ROADMAP Queue 1 item 6.6)")
        down = split(pre + "ffn_down.weight", 1)
        layer.tp, layer.up_split, layer.down_split = tp, up, down
        if up:
            dims.update({f"{pre}{n}.{a}": 0 for n in
                         ["ffn_up"] + (["ffn_gate"] if layer.swiglu else [])
                         for a in ("weight", "bias")})
        if down:
            dims[pre + "ffn_down.weight"] = 1
    for name in placements:
        if name not in dims:
            # the rest stays whole: a split of it raises
            tp_dim(placements, name)
    return cut_params(model, mesh, dims)


def load_sharded(model: TransformerLM, state: Dict[str, torch.Tensor]
                 ) -> None:
    """Load a ``state_dict`` into a (possibly sharded) model: each tensor
    of the model's own shape as is, a whole tensor of a split one cut to
    this rank's shard (its split dim is the one whose size differs)."""
    own = model.state_dict()
    missing = set(own) - set(state)
    unexpected = set(state) - set(own)
    if missing or unexpected:
        raise ValueError(f"state_dict does not match the model (missing "
                         f"{sorted(missing)[:4]}, unexpected "
                         f"{sorted(unexpected)[:4]})")
    model.load_state_dict({k: _rank_piece(model, k, torch.as_tensor(t),
                                          own[k].shape)
                           for k, t in state.items()})


def _rank_piece(model: TransformerLM, name: str, t: torch.Tensor, want
                ) -> torch.Tensor:
    """``t`` as this rank holds tensor ``name`` of shape ``want``: as it
    is, or a whole tensor cut along the one dim whose size differs."""
    if t.shape == want:
        return t
    dims = [d for d in range(t.dim()) if t.shape[d] != want[d]]
    if model.tp is None or t.dim() != len(want) or len(dims) != 1 \
            or t.shape[dims[0]] != want[dims[0]] * model.tp.size:
        raise ValueError(f"{name}: shape {tuple(t.shape)} is neither this "
                         f"rank's {tuple(want)} nor the whole of it")
    return model.tp.local(t, dims[0]).contiguous()

