"""HuggingFace checkpoint import: GPT-2 and the Llama family into the
port's ``TransformerLM``.

The port of ``analytics_zoo_tpu/net/hf_net.py``.  Each importer takes a
``transformers`` model instance (or a local path ``from_pretrained`` can
load) and returns ``(TransformerLM, variables)``: the port's model, built
with the source's configuration, and its weights in the reference's flax
layout (``{"params": ...}``, numpy leaves), so the same tree loads into
either package.  Load it into the port's model with
``model.load_state_dict(params_from_flax(variables["params"]))``.

Every configuration knob that would change the FUNCTION rather than the
weights fails loud (``NotImplementedError``), as in the reference: a
wrong-but-running conversion is the worst outcome an importer can have.
``transformers`` is imported inside the functions, so nothing else in
the port needs it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.lm import TransformerLM


def _np(t) -> np.ndarray:
    # .float(): bf16/fp16 tensors (a checkpoint loaded with
    # torch_dtype=bfloat16) cannot convert to numpy directly
    return t.detach().cpu().float().numpy()


def from_hf_gpt2(model_or_path, dtype: Optional[torch.dtype] = None
                 ) -> Tuple[TransformerLM, dict]:
    """Convert a HF ``GPT2LMHeadModel`` (instance or local path) to
    ``(TransformerLM, variables)``.  ``dtype`` sets the compute dtype of
    the returned model (default f32; parameters are stored f32)."""
    from transformers import GPT2LMHeadModel

    hf = model_or_path
    if not isinstance(hf, GPT2LMHeadModel):
        hf = GPT2LMHeadModel.from_pretrained(model_or_path)
    cfg = hf.config
    if getattr(cfg, "activation_function", "gelu_new") not in (
            "gelu_new", "gelu_pytorch_tanh"):
        raise NotImplementedError(
            f"GPT-2 activation {cfg.activation_function!r}: TransformerLM "
            f"uses tanh-GELU (gelu_new); other activations would silently "
            f"change the function")
    if not getattr(cfg, "tie_word_embeddings", True):
        raise NotImplementedError(
            "untied lm_head (tie_word_embeddings=False): the GPT-2 "
            "import ties logits to the embedding table")
    if getattr(cfg, "scale_attn_by_inverse_layer_idx", False):
        raise NotImplementedError(
            "scale_attn_by_inverse_layer_idx=True: TransformerLM scales "
            "attention by 1/sqrt(D) only")
    if getattr(cfg, "reorder_and_upcast_attn", False):
        raise NotImplementedError("reorder_and_upcast_attn=True is not "
                                  "replicated")
    if not getattr(cfg, "scale_attn_weights", True):
        raise NotImplementedError(
            "scale_attn_weights=False: TransformerLM always scales "
            "attention by 1/sqrt(D)")
    H = cfg.n_embd
    heads = cfg.n_head
    D = H // heads
    model = TransformerLM(
        vocab_size=cfg.vocab_size, hidden_size=H, num_layers=cfg.n_layer,
        num_heads=heads,
        intermediate_size=int(getattr(cfg, "n_inner", None) or 4 * H),
        max_position=cfg.n_positions, dtype=dtype or torch.float32,
        pos_encoding="learned", ln_eps=float(cfg.layer_norm_epsilon))

    sd = hf.state_dict()
    params = {
        "embed": {"embedding": _np(sd["transformer.wte.weight"])},
        "pos_embed": {"embedding": _np(sd["transformer.wpe.weight"])},
        "ln_f": {"scale": _np(sd["transformer.ln_f.weight"]),
                 "bias": _np(sd["transformer.ln_f.bias"])},
    }
    for i in range(cfg.n_layer):
        pre = f"transformer.h.{i}."
        # HF Conv1D stores [in, out]: already the flax kernel layout
        wq, wk, wv = np.split(_np(sd[pre + "attn.c_attn.weight"]), 3,
                              axis=1)
        bq, bk, bv = np.split(_np(sd[pre + "attn.c_attn.bias"]), 3)
        params[f"layer_{i}"] = {
            "ln_attn": {"scale": _np(sd[pre + "ln_1.weight"]),
                        "bias": _np(sd[pre + "ln_1.bias"])},
            "ln_ffn": {"scale": _np(sd[pre + "ln_2.weight"]),
                       "bias": _np(sd[pre + "ln_2.bias"])},
            "attention": {
                "query": {"kernel": wq.reshape(H, heads, D),
                          "bias": bq.reshape(heads, D)},
                "key": {"kernel": wk.reshape(H, heads, D),
                        "bias": bk.reshape(heads, D)},
                "value": {"kernel": wv.reshape(H, heads, D),
                          "bias": bv.reshape(heads, D)},
                "attn_out": {"kernel": _np(sd[pre + "attn.c_proj.weight"])
                             .reshape(heads, D, H),
                             "bias": _np(sd[pre + "attn.c_proj.bias"])},
            },
            "ffn_up": {"kernel": _np(sd[pre + "mlp.c_fc.weight"]),
                       "bias": _np(sd[pre + "mlp.c_fc.bias"])},
            "ffn_down": {"kernel": _np(sd[pre + "mlp.c_proj.weight"]),
                         "bias": _np(sd[pre + "mlp.c_proj.bias"])},
        }
    # GPT-2's lm_head is tied to wte: nothing to copy
    return model, {"params": params}


def from_hf_llama(model_or_path, dtype: Optional[torch.dtype] = None
                  ) -> Tuple[TransformerLM, dict]:
    """Convert a HF ``LlamaForCausalLM`` (instance or local path) to
    ``(TransformerLM, variables)``: RMSNorm + SwiGLU + rope + GQA +
    bias-free projections (q/k/v biases where ``attention_bias``)."""
    from transformers import LlamaForCausalLM

    hf = model_or_path
    if not isinstance(hf, LlamaForCausalLM):
        hf = LlamaForCausalLM.from_pretrained(model_or_path)
    cfg = hf.config
    if getattr(cfg, "mlp_bias", False):
        raise NotImplementedError(
            "mlp_bias=True llama projections are not mapped "
            "(TransformerLM's SwiGLU is bias-free)")
    return _from_llama_family(
        hf, cfg, dtype,
        qkv_bias=bool(getattr(cfg, "attention_bias", False)))


def _from_llama_family(hf, cfg, dtype, qkv_bias: bool
                       ) -> Tuple[TransformerLM, dict]:
    """The llama-family conversion shared by Llama, Mistral and Qwen2
    (biased q/k/v with ``qkv_bias``)."""
    H = cfg.hidden_size
    heads = cfg.num_attention_heads
    D = H // heads
    kvh = getattr(cfg, "num_key_value_heads", heads)
    if getattr(cfg, "rope_scaling", None):
        raise NotImplementedError(
            f"rope_scaling={cfg.rope_scaling!r}: TransformerLM applies "
            f"plain rotary embeddings")
    if getattr(cfg, "head_dim", None) not in (None, D):
        raise NotImplementedError(
            f"head_dim={cfg.head_dim} != hidden/heads={D}: "
            f"TransformerLM derives head dim from hidden_size")
    if getattr(cfg, "hidden_act", "silu") != "silu":
        raise NotImplementedError(
            f"hidden_act {cfg.hidden_act!r}: TransformerLM's SwiGLU "
            f"uses silu")
    tied = bool(getattr(cfg, "tie_word_embeddings", False))
    model = TransformerLM(
        vocab_size=cfg.vocab_size, hidden_size=H,
        num_layers=cfg.num_hidden_layers, num_heads=heads,
        intermediate_size=cfg.intermediate_size,
        max_position=cfg.max_position_embeddings,
        dtype=dtype or torch.float32, pos_encoding="rope",
        rope_base=float(getattr(cfg, "rope_theta", 10000.0)),
        num_kv_heads=kvh, norm="rmsnorm", mlp="swiglu", use_bias=False,
        qkv_bias=qkv_bias, tied_head=tied, ln_eps=float(cfg.rms_norm_eps))

    sd = hf.state_dict()

    def lin(name):                          # torch [out, in] -> [in, out]
        return _np(sd[name]).T

    params = {
        "embed": {"embedding": _np(sd["model.embed_tokens.weight"])},
        "ln_f": {"scale": _np(sd["model.norm.weight"])},
    }
    if not tied:
        params["lm_head"] = {"kernel": lin("lm_head.weight")}
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        attn = {
            "query": {"kernel": lin(pre + "self_attn.q_proj.weight")
                      .reshape(H, heads, D)},
            "key": {"kernel": lin(pre + "self_attn.k_proj.weight")
                    .reshape(H, kvh, D)},
            "value": {"kernel": lin(pre + "self_attn.v_proj.weight")
                      .reshape(H, kvh, D)},
            "attn_out": {"kernel": lin(pre + "self_attn.o_proj.weight")
                         .reshape(heads, D, H)},
        }
        if qkv_bias:
            for name, proj, n in (("query", "q_proj", heads),
                                  ("key", "k_proj", kvh),
                                  ("value", "v_proj", kvh)):
                attn[name]["bias"] = _np(
                    sd[f"{pre}self_attn.{proj}.bias"]).reshape(n, D)
        params[f"layer_{i}"] = {
            "ln_attn": {"scale": _np(sd[pre + "input_layernorm.weight"])},
            "ln_ffn": {"scale": _np(
                sd[pre + "post_attention_layernorm.weight"])},
            "attention": attn,
            "ffn_gate": {"kernel": lin(pre + "mlp.gate_proj.weight")},
            "ffn_up": {"kernel": lin(pre + "mlp.up_proj.weight")},
            "ffn_down": {"kernel": lin(pre + "mlp.down_proj.weight")},
        }
    return model, {"params": params}


def from_hf_mistral(model_or_path, dtype: Optional[torch.dtype] = None
                    ) -> Tuple[TransformerLM, dict]:
    """Convert a HF ``MistralForCausalLM``: llama-shaped when its
    sliding window is off (None or at least the position budget);
    windowed attention is not replicated and fails loud."""
    from transformers import MistralForCausalLM

    hf = model_or_path
    if not isinstance(hf, MistralForCausalLM):
        hf = MistralForCausalLM.from_pretrained(model_or_path)
    cfg = hf.config
    sw = getattr(cfg, "sliding_window", None)
    if sw is not None and sw < cfg.max_position_embeddings:
        raise NotImplementedError(
            f"sliding_window={sw} < max_position "
            f"{cfg.max_position_embeddings}: TransformerLM attends the "
            f"full causal window (a windowed checkpoint would silently "
            f"attend differently)")
    return _from_llama_family(hf, cfg, dtype, qkv_bias=False)


def from_hf_qwen2(model_or_path, dtype: Optional[torch.dtype] = None
                  ) -> Tuple[TransformerLM, dict]:
    """Convert a HF ``Qwen2ForCausalLM``: llama-shaped (RMSNorm, SwiGLU,
    rope, GQA, untied or tied head) plus BIASED q/k/v projections."""
    from transformers import Qwen2ForCausalLM

    hf = model_or_path
    if not isinstance(hf, Qwen2ForCausalLM):
        hf = Qwen2ForCausalLM.from_pretrained(model_or_path)
    cfg = hf.config
    # HF qwen2 windows only the layers from max_window_layers on: the
    # guard fires only when some layer would actually window
    if (getattr(cfg, "use_sliding_window", False)
            and getattr(cfg, "max_window_layers", 0)
            < cfg.num_hidden_layers
            and (getattr(cfg, "sliding_window", None) or 0)
            < cfg.max_position_embeddings):
        raise NotImplementedError(
            "use_sliding_window=True with windowed layers: "
            "TransformerLM attends the full causal window")
    return _from_llama_family(hf, cfg, dtype, qkv_bias=True)
