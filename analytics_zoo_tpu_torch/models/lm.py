"""Decoder-only causal language model: the paged serving path.

The port of ``analytics_zoo_tpu/models/lm.py`` as far as the paged
continuous-batching engine needs it: ``TransformerLM`` with
``decode_step_paged``, ``verify_hidden_paged`` and
``prefill_chunk_paged``, for the GPT-2-shaped configuration (learned
positions, pre-LayerNorm blocks, tanh-GELU MLP, biases, tied head) with
grouped-query attention.  rope, RMSNorm, SwiGLU, untied heads and MoE
raise ``NotImplementedError`` until a later slice ports them.

Numerics follow the reference's cast points, or bf16 logits drift from
it: parameters are stored f32; every dense projection computes in the
model dtype; LayerNorm computes in f32 (flax's fast variance,
``E[x^2] - E[x]^2``) and its callers cast back; the embedding sum is
cast to the model dtype; attention output (f32) is cast before
``attn_out``; the tied head runs in f32.

KV pools are updated IN PLACE by the paged methods (the reference
returns new pools that the JAX engine donates back into the same
buffers).  :func:`params_from_flax` converts the reference model's
``variables["params"]`` into this model's ``state_dict``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.ops.flash_attention import (paged_attention,
                                                         paged_kv_update)


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
    """Causal self-attention against a paged KV cache.
    ``num_kv_heads < num_heads`` is grouped-query attention: K/V project
    to fewer heads, each shared by ``num_heads // num_kv_heads`` query
    heads, and the pool stores only the kv heads."""

    def __init__(self, hidden_size: int, num_heads: int,
                 num_kv_heads: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        H = num_heads
        KH = num_kv_heads or H
        if H % KH:
            raise ValueError(
                f"num_heads {H} must be a multiple of num_kv_heads {KH}")
        D = hidden_size // H
        self._h, self._kh, self._d = H, KH, D
        self.dtype = dtype
        self.query = nn.Linear(hidden_size, H * D)
        self.key = nn.Linear(hidden_size, KH * D)
        self.value = nn.Linear(hidden_size, KH * D)
        self.attn_out = nn.Linear(H * D, hidden_size)

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
        q = _dense(self.query, xs, self.dtype).view(B, S, self._h,
                                                    self._d)
        ks = _dense(self.key, xs, self.dtype).view(B, S, self._kh,
                                                   self._d)
        vs = _dense(self.value, xs, self.dtype).view(B, S, self._kh,
                                                     self._d)
        paged_kv_update(pool_k, pool_v, tables, pos, ks, vs, limit=limit)
        o = paged_attention(q, pool_k, pool_v, tables, pos, kernel=kernel)
        return _dense(self.attn_out, o.reshape(B, S, -1), self.dtype)


class DecoderLayer(nn.Module):
    """Pre-LN causal decoder block with a tanh-GELU MLP."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int,
                 dtype: torch.dtype = torch.bfloat16,
                 num_kv_heads: Optional[int] = None,
                 ln_eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.ln_attn = LayerNorm(hidden_size, ln_eps)
        self.attention = DecoderAttention(hidden_size, num_heads,
                                          num_kv_heads=num_kv_heads,
                                          dtype=dtype)
        self.ln_ffn = LayerNorm(hidden_size, ln_eps)
        self.ffn_up = nn.Linear(hidden_size, intermediate_size)
        self.ffn_down = nn.Linear(intermediate_size, hidden_size)

    def _mlp(self, x):
        h = F.gelu(_dense(self.ffn_up, x, self.dtype), approximate="tanh")
        return _dense(self.ffn_down, h, self.dtype)

    def decode_paged(self, xs, pool_k, pool_v, tables, pos, limit=None,
                     kernel="fused"):
        a = self.attention.decode_paged(
            self.ln_attn(xs).to(self.dtype), pool_k, pool_v, tables, pos,
            limit=limit, kernel=kernel)
        xs = xs + a
        return xs + self._mlp(self.ln_ffn(xs).to(self.dtype))


class TransformerLM(nn.Module):
    """Decoder-only LM with tied embeddings, served through a paged KV
    cache (``serving/continuous.py``).

    Parameters are created f32 with GPT-2's initialisation (normal
    0.02, zero biases, unit LayerNorm scales) from the global torch
    generator; seed it with ``torch.manual_seed`` for reproducible
    random weights, or load converted weights (:func:`params_from_flax`).
    """

    def __init__(self, vocab_size: int, hidden_size: int = 256,
                 num_layers: int = 4, num_heads: int = 4,
                 intermediate_size: int = 1024, max_position: int = 512,
                 dtype: torch.dtype = torch.bfloat16,
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
        self.layers = nn.ModuleList(
            DecoderLayer(hidden_size, num_heads, intermediate_size,
                         dtype=dtype, num_kv_heads=num_kv_heads,
                         ln_eps=ln_eps)
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
