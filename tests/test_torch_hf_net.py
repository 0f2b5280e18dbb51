"""The port's HuggingFace importers (``analytics_zoo_tpu_torch/net/
hf_net.py``) held to ``transformers`` and to the reference importers.

Tiny random-init HF models (GPT-2, Llama, Qwen2, Mistral; nothing is
downloaded) go through the port's importer.  The converted tree must be
leaf for leaf the reference importer's (the same flax layout), and the
port's model, loaded with ``params_from_flax``, must give HF's logits
within 1e-4 and HF's greedy tokens, through ``generate`` and through
both engines.  Every guard against a configuration the model would run
differently fails loud.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.net import hf_net as jax_hf
from analytics_zoo_tpu_torch.models.lm import generate, params_from_flax
from analytics_zoo_tpu_torch.net import hf_net
from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine

transformers = pytest.importorskip("transformers")

_LLAMA_FAMILY = dict(vocab_size=96, hidden_size=32, intermediate_size=88,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=64,
                     rms_norm_eps=1e-5, attention_dropout=0.0,
                     tie_word_embeddings=False)


def _hf(family):
    torch.manual_seed(0)
    if family == "gpt2":
        cfg = transformers.GPT2Config(
            vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=2,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
        return transformers.GPT2LMHeadModel(cfg).eval()
    if family == "llama":
        return transformers.LlamaForCausalLM(transformers.LlamaConfig(
            rope_theta=10000.0, **_LLAMA_FAMILY)).eval()
    if family == "qwen2":
        return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            **_LLAMA_FAMILY)).eval()
    return transformers.MistralForCausalLM(transformers.MistralConfig(
        sliding_window=None, **_LLAMA_FAMILY)).eval()


_IMPORTERS = {"gpt2": "from_hf_gpt2", "llama": "from_hf_llama",
              "qwen2": "from_hf_qwen2", "mistral": "from_hf_mistral"}
_FAMILIES = list(_IMPORTERS)


@pytest.fixture(scope="module", params=_FAMILIES)
def pair(request):
    """(family, HF model, the port's model loaded with the converted
    weights, the converted variables)."""
    hf = _hf(request.param)
    model, variables = getattr(hf_net, _IMPORTERS[request.param])(hf)
    model.load_state_dict(params_from_flax(variables["params"]))
    return request.param, hf, model.eval(), variables


def test_tree_equals_the_reference_importers(pair):
    family, hf, _, variables = pair
    _, ref = getattr(jax_hf, _IMPORTERS[family])(hf)
    got = jax.tree_util.tree_flatten_with_path(variables)[0]
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_config_carried(pair):
    family, hf, model, variables = pair
    cfg = hf.config
    if family == "gpt2":
        assert model.pos_embed is not None and model.tied_head
        assert model.layers[0].ln_attn.eps == pytest.approx(1e-5)
        return
    assert model.pos_embed is None and not model.tied_head
    assert model.num_kv_heads == 2 and model.layers[0].swiglu
    attn = model.layers[0].attention
    assert attn.rope and attn.rope_base == pytest.approx(cfg.rope_theta)
    assert attn.attn_out.bias is None and model.layers[0].ffn_up.bias is None
    assert (attn.query.bias is not None) == (family == "qwen2")
    assert model.layers[0].ln_attn.eps == pytest.approx(1e-5)
    assert "lm_head" in variables["params"]


def test_logits_match_hf(pair):
    _, hf, model, _ = pair
    toks = np.random.default_rng(0).integers(0, 96, (3, 13))
    with torch.no_grad():
        ref = hf(torch.tensor(toks)).logits.numpy()
        got = model(torch.tensor(toks, dtype=torch.int32)).numpy()
    assert np.abs(ref - got).max() < 1e-4
    np.testing.assert_array_equal(ref.argmax(-1), got.argmax(-1))


def _hf_greedy(hf, prompt, n):
    with torch.no_grad():
        return hf.generate(torch.tensor(prompt.astype(np.int64)),
                           max_new_tokens=n, do_sample=False,
                           pad_token_id=0)[:, prompt.shape[1]:].numpy()


def test_generate_matches_hf(pair):
    _, hf, model, _ = pair
    prompt = np.random.default_rng(1).integers(1, 96, (2, 7)).astype(
        np.int32)
    got = generate(model, None, prompt, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), _hf_greedy(hf, prompt, 6))


@pytest.mark.parametrize("paged", [False, True])
def test_engines_serve_hf_tokens(pair, paged):
    """Both engines serve the imported model with HF's greedy tokens,
    each prompt alone in HF (no padding) and batched in the engine."""
    _, hf, model, _ = pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 96, n).astype(np.int32) for n in (5, 9, 3)]
    eng = ContinuousEngine(model, device="cpu", max_new_tokens=5,
                           max_slots=2, prompt_buckets=(8, 16),
                           paged=paged, block_size=4)
    out = {}
    for i, p in enumerate(prompts):
        eng.submit(f"r{i}", p, lambda u, t: out.__setitem__(u, t))
    eng.drain()
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            np.asarray(out[f"r{i}"]), _hf_greedy(hf, p[None], 5)[0])


_BASE = dict(vocab_size=32, hidden_size=16, intermediate_size=32,
             num_hidden_layers=1, num_attention_heads=2,
             max_position_embeddings=32)
_GPT2_BASE = dict(vocab_size=32, n_positions=32, n_embd=16, n_layer=1,
                  n_head=2)


def _guard_cases():
    t = transformers
    return {
        "gpt2-activation": (lambda: t.GPT2LMHeadModel(t.GPT2Config(
            activation_function="relu", **_GPT2_BASE)), "activation"),
        "gpt2-untied": (lambda: t.GPT2LMHeadModel(t.GPT2Config(
            tie_word_embeddings=False, **_GPT2_BASE)), "untied"),
        "gpt2-inverse-layer-idx": (lambda: t.GPT2LMHeadModel(t.GPT2Config(
            scale_attn_by_inverse_layer_idx=True, **_GPT2_BASE)),
            "inverse_layer_idx"),
        "gpt2-reorder": (lambda: t.GPT2LMHeadModel(t.GPT2Config(
            reorder_and_upcast_attn=True, **_GPT2_BASE)), "reorder"),
        "gpt2-unscaled": (lambda: t.GPT2LMHeadModel(t.GPT2Config(
            scale_attn_weights=False, **_GPT2_BASE)), "scale_attn_weights"),
        "llama-rope-scaling": (lambda: t.LlamaForCausalLM(t.LlamaConfig(
            rope_scaling={"rope_type": "linear", "factor": 2.0}, **_BASE)),
            "rope_scaling"),
        "llama-hidden-act": (lambda: t.LlamaForCausalLM(t.LlamaConfig(
            hidden_act="gelu", **_BASE)), "hidden_act"),
        "llama-head-dim": (lambda: t.LlamaForCausalLM(t.LlamaConfig(
            head_dim=16, **_BASE)), "head_dim"),
        "llama-mlp-bias": (lambda: t.LlamaForCausalLM(t.LlamaConfig(
            mlp_bias=True, **_BASE)), "mlp_bias"),
        "qwen2-sliding-window": (lambda: t.Qwen2ForCausalLM(t.Qwen2Config(
            use_sliding_window=True, sliding_window=8, max_window_layers=0,
            **dict(_BASE, max_position_embeddings=64))), "sliding_window"),
        "mistral-sliding-window": (lambda: t.MistralForCausalLM(
            t.MistralConfig(sliding_window=8, **dict(
                _BASE, max_position_embeddings=64))), "sliding_window"),
    }


_IMPORTER_OF = {"gpt2": hf_net.from_hf_gpt2, "llama": hf_net.from_hf_llama,
                "qwen2": hf_net.from_hf_qwen2,
                "mistral": hf_net.from_hf_mistral}


@pytest.mark.parametrize("case", list(_guard_cases()))
def test_guards_fail_loud(case):
    build, match = _guard_cases()[case]
    with pytest.raises(NotImplementedError, match=match):
        _IMPORTER_OF[case.split("-")[0]](build())


def test_llama_attention_bias_is_the_qwen2_layout():
    """``attention_bias=True`` Llamas import with biased q/k/v and
    bias-free output and MLP projections, as the reference maps them."""
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        attention_bias=True, **_LLAMA_FAMILY)).eval()
    model, variables = hf_net.from_hf_llama(hf)
    model.load_state_dict(params_from_flax(variables["params"]))
    attn = model.layers[0].attention
    assert attn.query.bias is not None and attn.attn_out.bias is None
    toks = np.random.default_rng(3).integers(0, 96, (2, 9))
    with torch.no_grad():
        ref = hf(torch.tensor(toks)).logits.numpy()
        got = model(torch.tensor(toks, dtype=torch.int32)).numpy()
    assert np.abs(ref - got).max() < 1e-4
