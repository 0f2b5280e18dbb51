"""Weight-only quantization on the port (``learn/quantize.py``,
``InferenceModel.load_torch_generator(quantize=...)``) held to the JAX
reference on the same weights.

- ``int8``: each quantized leaf's int8 values and scales equal the
  reference's after ``params_from_flax``'s transposition (linear
  kernels, attention projections folded over heads and their biases,
  the embedding and position tables), exactly; ``dequantize`` equals
  the reference's, and so do ``stats``.
- ``bf16``: the same leaves cast, the same ``stats``.
- The quantized generator's greedy tokens equal the reference's
  ``load_flax_generator(quantize="int8")``; at rest the model's own
  copies of the quantized weights are released; the speculative path
  and a continuous engine dequantize once, into the model, and serve
  the same tokens; ``"int8_mxu"`` raises, as in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.learn.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.learn.quantize import dequantize as jax_dequantize
from analytics_zoo_tpu.learn.quantize import \
    quantize_params as jax_quantize_params
from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.learn.quantize import (dequantize,
                                                    quantize_params)
from analytics_zoo_tpu_torch.models.lm import (TransformerLM,
                                               params_from_flax)

# GQA with q/k/v biases and learned positions: every leaf kind
_CFG = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_position=32,
            qkv_bias=True)
_NEW = 4


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(dtype=jnp.float32, **_CFG)
    variables = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    rng = np.random.default_rng(3)
    # off the init, so biases are not 0
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), variables["params"])
    return jm, {"params": params}


def _port(params):
    tm = TransformerLM(dtype=torch.float32, **_CFG)
    tm.load_state_dict(params_from_flax(params))
    return tm


def _leaf_map(tree, fn):
    """``params_from_flax`` of ``tree`` with each quantized leaf replaced
    by ``fn(leaf)``: the reference's values in the port's layout."""
    return params_from_flax(jax.tree_util.tree_map(
        lambda n: fn(n) if isinstance(n, dict) else np.zeros(np.shape(n)),
        tree, is_leaf=lambda n: isinstance(n, dict) and "__q8__" in n))


@pytest.mark.parametrize("min_size", [1024, 16])
def test_int8_values_and_scales_match_jax(models, min_size):
    _, variables = models
    ref, ref_stats = jax_quantize_params(variables, "int8", min_size)
    tm = _port(variables["params"])
    new, stats = quantize_params(tm.state_dict(), "int8", min_size,
                                 model=tm)
    assert stats == ref_stats
    qs = _leaf_map(ref["params"], lambda n: n["__q8__"])
    quantized = {k for k, v in new.items() if isinstance(v, dict)}
    want = {k for k, v in qs.items() if np.abs(v.numpy()).max() > 0}
    assert quantized == want
    assert "embed.weight" in quantized and "pos_embed.weight" in quantized
    assert ("layers.0.attention.query.bias" in quantized) == (min_size < 64)
    flat = _scales(ref["params"])
    assert set(flat) == quantized
    for k in quantized:
        np.testing.assert_array_equal(new[k]["q"].numpy(),
                                      qs[k].numpy().astype(np.int8))
        np.testing.assert_array_equal(new[k]["scale"].numpy().ravel(),
                                      flat[k].ravel())
    deq = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax_dequantize(ref)["params"]))
    got = dequantize(new)
    for k in deq:
        np.testing.assert_array_equal(got[k].numpy(), deq[k].numpy())


def _scales(params, path=()):
    """{port key: the reference's scale} of every quantized leaf."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict) and "__q8__" in v:
            parts = [p.replace("layer_", "layers.") for p in path]
            leaf = "weight" if k in ("kernel", "embedding") else k
            out[".".join(parts + [leaf])] = np.asarray(v["__q8_scale__"])
        elif isinstance(v, dict):
            out.update(_scales(v, path + (k,)))
    return out


def test_bf16_mode_matches_jax(models):
    _, variables = models
    ref, ref_stats = jax_quantize_params(variables, "bf16")
    tm = _port(variables["params"])
    new, stats = quantize_params(tm.state_dict(), "bf16", model=tm)
    assert stats == ref_stats
    want = params_from_flax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), ref["params"]))
    for k, v in new.items():
        np.testing.assert_array_equal(v.float().numpy(), want[k].numpy())
    # the reference casts [H, D] q/k/v biases (two dims), not the 1-D
    # norms and other biases
    assert new["layers.0.attention.query.bias"].dtype == torch.bfloat16
    assert new["layers.0.ffn_up.bias"].dtype == torch.float32
    with pytest.raises(ValueError, match="unknown quantize mode"):
        quantize_params(tm.state_dict(), "int4", model=tm)


def test_quantized_generator_matches_jax(models):
    jm, variables = models
    prompts = np.random.default_rng(0).integers(1, 64, (2, 8)).astype(
        np.int32)
    lens = np.array([8, 5], np.int32)
    ref = JaxInferenceModel(batch_buckets=(2,)).load_flax_generator(
        jm, variables, _NEW, prompt_buckets=(8,), quantize="int8")
    want = np.asarray(ref.predict(prompts, lens))
    tm = _port(variables["params"])
    im = InferenceModel(batch_buckets=(2,)).load_torch_generator(
        tm, None, _NEW, prompt_buckets=(8,), quantize="int8", device="cpu")
    assert im.quant_stats == ref.quant_stats
    np.testing.assert_array_equal(im.predict(prompts, lens), want)
    np.testing.assert_array_equal(im.predict(prompts, lens), want)
    # at rest the model holds no copy of the quantized weights
    assert tm.layers[0].attention.query.weight.numel() == 0
    assert tm.embed.weight.numel() == 0
    assert tm.ln_f.scale.numel() == 64
    # a continuous engine dequantizes once, into the model, and serves
    # the same tokens
    eng = im.make_continuous_engine(paged=True, max_slots=2)
    assert tm.layers[0].attention.query.weight.shape == (64, 64)
    out = {}
    for i, (p, n) in enumerate(zip(prompts, lens)):
        eng.submit(f"r{i}", p[:n], lambda u, t: out.__setitem__(u, t))
    eng.drain()
    for i in range(2):
        np.testing.assert_array_equal(out[f"r{i}"], want[i])
    np.testing.assert_array_equal(im.predict(prompts, lens), want)


def test_quantized_speculative_generator(models):
    """A draft-loaded quantized handle dequantizes once at load: the
    greedy tokens are the plain quantized generator's."""
    jm, variables = models
    prompts = np.random.default_rng(1).integers(1, 64, (2, 8)).astype(
        np.int32)
    plain = InferenceModel(batch_buckets=(2,)).load_torch_generator(
        _port(variables["params"]), None, _NEW, prompt_buckets=(8,),
        quantize="int8", device="cpu").predict(prompts)
    tm, draft = _port(variables["params"]), _port(variables["params"])
    im = InferenceModel(batch_buckets=(2,)).load_torch_generator(
        tm, None, _NEW, prompt_buckets=(8,), quantize="int8",
        device="cpu", draft_model=draft, draft_variables=draft.state_dict(),
        speculation_k=2)
    assert tm.layers[0].attention.query.weight.shape == (64, 64)
    np.testing.assert_array_equal(im.predict(prompts), plain)
    assert im.spec_stats["rounds"] > 0
    with pytest.raises(ValueError, match="only supported by load_flax"):
        InferenceModel().load_torch_generator(
            tm, None, _NEW, prompt_buckets=(8,), quantize="int8_mxu",
            device="cpu")
