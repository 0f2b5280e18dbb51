"""Decoder-only causal language model: the serving paths.

The port of ``analytics_zoo_tpu/models/lm.py`` as far as inference
needs it, for the GPT-2-shaped configuration (learned positions,
pre-LayerNorm blocks, tanh-GELU MLP, biases, tied head) with
grouped-query attention:

- the dense forward (``__call__``/``hidden_states``) and ``prefill``,
  whose attention goes through ``models.transformer.attention_dispatch``
  (the flash kernel on a CUDA tensor);
- the slot-arena cache methods ``decode_step``, ``verify_step``/
  ``verify_hidden`` and ``prefill_chunk``, and greedy :func:`generate`;
- the paged trio ``decode_step_paged``, ``verify_hidden_paged`` and
  ``prefill_chunk_paged``.

rope, RMSNorm, SwiGLU, untied heads and MoE raise
``NotImplementedError`` until a later slice ports them, and so does
``train=True``: the training path comes with the backward kernels.

Numerics follow the reference's cast points, or bf16 logits drift from
it: parameters are stored f32; every dense projection computes in the
model dtype; LayerNorm computes in f32 (flax's fast variance,
``E[x^2] - E[x]^2``) and its callers cast back; the embedding sum is
cast to the model dtype; attention output (f32) is cast before
``attn_out``; the tied head runs in f32.

Caches are updated IN PLACE by the arena and paged methods (the
reference returns new caches that the JAX engine donates back into the
same buffers), so those methods return only their outputs.
:func:`params_from_flax` converts the reference model's
``variables["params"]`` into this model's ``state_dict``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.transformer import attention_dispatch
from analytics_zoo_tpu_torch.ops.flash_attention import (cache_attention,
                                                         paged_attention,
                                                         paged_kv_update)


def _inference_only(train: bool) -> None:
    if train:
        raise NotImplementedError(
            "train=True is not ported yet (ROADMAP Queue 1 item 7: the "
            "training path, with the flash backward kernels)")


def _dense(layer: nn.Linear, x, dtype):
    """A flax ``Dense``/``DenseGeneral`` with ``dtype=dtype``: input,
    kernel and bias all promoted to the compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: statistics in f32 with the
    fast variance ``max(0, E[x^2] - E[x]^2)``; the output is f32."""

    def __init__(self, features: int, eps: float):
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


class DecoderAttention(nn.Module):
    """Causal self-attention: a dense forward, and cached decode against
    a slot-arena or a paged KV cache, sharing the same projections.
    ``num_kv_heads < num_heads`` is grouped-query attention: K/V project
    to fewer heads, each shared by ``num_heads // num_kv_heads`` query
    heads, and the caches store only the kv heads.  ``use_flash`` picks
    the dense forward's attention (``models.transformer.flash_ok``)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 num_kv_heads: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 use_flash: Optional[bool] = None):
        super().__init__()
        H = num_heads
        KH = num_kv_heads or H
        if H % KH:
            raise ValueError(
                f"num_heads {H} must be a multiple of num_kv_heads {KH}")
        D = hidden_size // H
        self._h, self._kh, self._d = H, KH, D
        self.dtype = dtype
        self.use_flash = use_flash
        self.query = nn.Linear(hidden_size, H * D)
        self.key = nn.Linear(hidden_size, KH * D)
        self.value = nn.Linear(hidden_size, KH * D)
        self.attn_out = nn.Linear(H * D, hidden_size)

    def _qkv(self, x):
        B, T, _ = x.shape
        return (_dense(self.query, x, self.dtype).view(B, T, self._h,
                                                       self._d),
                _dense(self.key, x, self.dtype).view(B, T, self._kh,
                                                     self._d),
                _dense(self.value, x, self.dtype).view(B, T, self._kh,
                                                       self._d))

    def _expand_kv(self, t):
        """``[B, T, KH, D] -> [B, T, H, D]`` by repeating each kv head
        over its query group, as the reference does before the dispatch,
        so the flash kernel sees plain multi-head operands."""
        if self._kh == self._h:
            return t
        return torch.repeat_interleave(t, self._h // self._kh, dim=2)

    def forward(self, x, return_kv: bool = False):
        """Causal attention over ``[B, T, E]`` -> ``[B, T, E]``.
        ``return_kv=True`` also returns this layer's K/V projections
        ``[B, T, KH, D]`` (the KV-arena prefill payload)."""
        q, k, v = self._qkv(x)
        o = attention_dispatch(q, self._expand_kv(k), self._expand_kv(v),
                               None, causal=True, use_flash=self.use_flash)
        out = _dense(self.attn_out, o.reshape(x.shape[0], x.shape[1], -1),
                     self.dtype)
        return (out, k, v) if return_kv else out

    def decode(self, x1, cache_k, cache_v, pos):
        """One cached decode step against a slot arena, IN PLACE.

        x1: ``[B, 1, E]``; cache_k/cache_v: ``[B, L, KH, D]``; pos: int32
        — a scalar advances the batch in lockstep, a ``[B]`` vector gives
        each row its own position.  Row b's K/V are written at its
        position, then it attends positions ``<= pos[b]``.  Returns
        ``[B, 1, E]`` in the model dtype."""
        B = x1.shape[0]
        L = cache_k.shape[1]
        q, k1, v1 = self._qkv(x1)
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
        o = cache_attention(q, cache_k, cache_v, visible)
        return _dense(self.attn_out, o.reshape(B, 1, -1), self.dtype)

    def decode_k(self, xs, cache_k, cache_v, pos):
        """Cached decode of S tokens per row at once against a slot
        arena, IN PLACE: row b's tokens occupy positions ``pos[b] ..
        pos[b]+S-1`` (positions past the cache length are dropped), and
        token j attends positions ``<= pos[b] + j`` — block-causal
        against the cache.  xs: ``[B, S, E]``; pos: ``[B]`` int32.
        Returns ``[B, S, E]`` in the model dtype."""
        B, S, _ = xs.shape
        L = cache_k.shape[1]
        q, ks, vs = self._qkv(xs)
        p = pos[:, None].long() + torch.arange(S, device=xs.device)[None]
        keep = p < L
        rows = torch.arange(B, device=xs.device)[:, None].expand(B, S)
        cache_k[rows[keep], p[keep]] = ks[keep].to(cache_k.dtype)
        cache_v[rows[keep], p[keep]] = vs[keep].to(cache_v.dtype)
        visible = (torch.arange(L, device=xs.device)[None, None, :]
                   <= p[:, :, None])[:, None, None, :, :]
        o = cache_attention(q, cache_k, cache_v, visible)
        return _dense(self.attn_out, o.reshape(B, S, -1), self.dtype)

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
        q, ks, vs = self._qkv(xs)
        paged_kv_update(pool_k, pool_v, tables, pos, ks, vs, limit=limit)
        o = paged_attention(q, pool_k, pool_v, tables, pos, kernel=kernel)
        return _dense(self.attn_out, o.reshape(B, S, -1), self.dtype)


class DecoderLayer(nn.Module):
    """Pre-LN causal decoder block with a tanh-GELU MLP."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int,
                 dtype: torch.dtype = torch.bfloat16,
                 num_kv_heads: Optional[int] = None,
                 ln_eps: float = 1e-6,
                 use_flash: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.ln_attn = LayerNorm(hidden_size, ln_eps)
        self.attention = DecoderAttention(hidden_size, num_heads,
                                          num_kv_heads=num_kv_heads,
                                          dtype=dtype, use_flash=use_flash)
        self.ln_ffn = LayerNorm(hidden_size, ln_eps)
        self.ffn_up = nn.Linear(hidden_size, intermediate_size)
        self.ffn_down = nn.Linear(intermediate_size, hidden_size)

    def _mlp(self, x):
        h = F.gelu(_dense(self.ffn_up, x, self.dtype), approximate="tanh")
        return _dense(self.ffn_down, h, self.dtype)

    def _residual(self, x, a):
        x = x + a
        return x + self._mlp(self.ln_ffn(x).to(self.dtype))

    def forward(self, x, train: bool = False):
        return self.forward_kv(x, train)[0]

    def forward_kv(self, x, train: bool = False):
        """The dense forward that also returns this layer's K/V
        ``[B, T, KH, D]``: the prompt-prefill payload the engine writes
        into its KV arena."""
        _inference_only(train)
        a, k, v = self.attention(self.ln_attn(x).to(self.dtype),
                                 return_kv=True)
        return self._residual(x, a), k, v

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
    """Decoder-only LM with tied embeddings, served through a slot-arena
    or a paged KV cache (``serving/continuous.py``) or by
    :func:`generate`.

    Parameters are created f32 with GPT-2's initialisation (normal
    0.02, zero biases, unit LayerNorm scales) from the global torch
    generator; seed it with ``torch.manual_seed`` for reproducible
    random weights, or load converted weights (:func:`params_from_flax`).
    ``use_flash`` picks the dense forward's attention, as in the
    reference: ``None`` is the flash kernel on a CUDA tensor and plain
    full attention on a CPU tensor; ``True``/``False`` force either.
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
                 moe_experts: int = 0):
        super().__init__()
        later = {"pos_encoding": (pos_encoding, "learned"),
                 "norm": (norm, "layernorm"), "mlp": (mlp, "gelu"),
                 "use_bias": (use_bias, True),
                 "tied_head": (tied_head, True),
                 "moe_experts": (moe_experts, 0)}
        for name, (got, ported) in later.items():
            if got != ported:
                raise NotImplementedError(
                    f"{name}={got!r} is not ported yet (ROADMAP Queue 1 "
                    f"item 2: rope, RMSNorm, SwiGLU, bias-free and "
                    f"untied-head configs, MoE)")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.max_position = max_position
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, hidden_size)
        self.pos_embed = nn.Embedding(max_position, hidden_size)
        self.use_flash = use_flash
        self.layers = nn.ModuleList(
            DecoderLayer(hidden_size, num_heads, intermediate_size,
                         dtype=dtype, num_kv_heads=num_kv_heads,
                         ln_eps=ln_eps, use_flash=use_flash)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(hidden_size, ln_eps)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif not name.endswith("scale"):
                    p.normal_(0.0, 0.02)

    @property
    def kv_heads(self) -> int:
        """Heads actually stored in the KV cache (GQA-aware)."""
        return self.num_kv_heads or self.num_heads

    def _logits(self, x):
        # tied head: f32 logits for a stable softmax/argmax
        return x.float() @ self.embed.weight.float().t()

    def _embed(self, toks, p):
        # positions past the table (padding columns of a suffix grid)
        # are clamped: their rows are never read, and an out-of-range
        # lookup would be a device assert on CUDA
        x = self.embed(toks) + self.pos_embed(
            torch.clamp(p, max=self.max_position - 1))
        return x.to(self.dtype)

    def hidden_states(self, tokens, train: bool = False):
        """Final-LayerNorm hidden states ``[B, T, E]`` (f32) of the
        causal forward: the forward minus the vocab head."""
        return self._prefill_hidden(tokens, train)[0]

    def forward(self, tokens, train: bool = False):
        """Causal forward: logits ``[B, T, V]`` (f32)."""
        return self._logits(self.hidden_states(tokens, train))

    def _prefill_hidden(self, tokens, train: bool = False):
        """The causal forward's final-norm hidden states ``[B, T, E]``
        and every layer's K/V, stacked ``[n_layers, B, T, KH, D]``."""
        _inference_only(train)
        T = tokens.shape[1]
        if T > self.max_position:
            raise ValueError(
                f"sequence length {T} exceeds max_position "
                f"{self.max_position} (out-of-range position lookups "
                f"would read clamped rows)")
        x = self._embed(tokens.long(),
                        torch.arange(T, device=tokens.device)[None])
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


@torch.no_grad()
def generate(model: TransformerLM, variables, prompt, max_new_tokens: int,
             prompt_len=None, *, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 0.0, rng=None, eos_id: Optional[int] = None,
             prefill: str = "auto", device=None) -> torch.Tensor:
    """Greedy generation with a slot-arena KV cache, the reference's
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

    Sampling (``temperature > 0``) and the lockstep ``prefill="scan"``
    path are not ported yet (ROADMAP Queue 1 item 2) and raise."""
    if temperature > 0.0 or prefill == "scan":
        raise NotImplementedError(
            "sampled generation and prefill='scan' are not ported yet "
            "(ROADMAP Queue 1 item 2)")
    if prefill not in ("auto", "forward"):
        raise ValueError(f"prefill must be auto|forward|scan, got "
                         f"{prefill!r}")
    if max_new_tokens < 1:
        raise ValueError("greedy forward-prefill generation needs "
                         "max_new_tokens > 0")
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
    tok = torch.argmax(model._logits(last_h), dim=-1).to(torch.int32)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    if eos_id is not None:
        done = tok == eos_id
    out, pos = [tok], plen
    for _ in range(max_new_tokens - 1):
        logits = model.decode_step(tok, ck, cv, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tok, pos = nxt, pos + 1
        out.append(nxt)
    return torch.stack(out, dim=1)


def params_from_flax(params) -> Dict[str, torch.Tensor]:
    """The reference ``TransformerLM``'s ``variables["params"]`` tree
    (leaves as numpy arrays or anything ``np.asarray`` takes) as this
    model's ``state_dict``.  ``DenseGeneral`` kernels fold their head
    axes (``query``/``key``/``value`` ``[E, H, D]``, ``attn_out``
    ``[H, D, E]``) and every kernel transposes to ``nn.Linear``'s
    ``[out, in]``."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def linear(p, in_dims):
        k = np.asarray(p["kernel"], np.float32)
        n_in = int(np.prod(k.shape[:in_dims]))
        return t(k.reshape(n_in, -1).T), t(np.asarray(p["bias"]).reshape(-1))

    def norm(p):
        return t(p["scale"]), t(p["bias"])

    out = {"embed.weight": t(params["embed"]["embedding"]),
           "pos_embed.weight": t(params["pos_embed"]["embedding"])}
    out["ln_f.scale"], out["ln_f.bias"] = norm(params["ln_f"])
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        lp, pre = params[f"layer_{i}"], f"layers.{i}."
        for ln in ("ln_attn", "ln_ffn"):
            out[pre + ln + ".scale"], out[pre + ln + ".bias"] = norm(lp[ln])
        ap = lp["attention"]
        for name, in_dims in (("query", 1), ("key", 1), ("value", 1),
                              ("attn_out", 2)):
            w, b = linear(ap[name], in_dims)
            out[f"{pre}attention.{name}.weight"] = w
            out[f"{pre}attention.{name}.bias"] = b
        for name in ("ffn_up", "ffn_down"):
            w, b = linear(lp[name], 1)
            out[f"{pre}{name}.weight"] = w
            out[f"{pre}{name}.bias"] = b
    return out
