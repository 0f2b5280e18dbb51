"""``InferenceModel.load_flax(quantize="int8_mxu")`` on modules outside
the Keras API, port against reference, on the CPU: a ``TransformerLM``
(tied and untied heads) and a width-8 ResNet-18.

The reference's ``int8_call`` intercepts every plain ``nn.Dense`` and
``nn.Conv`` of the module whose kernel was quantized and runs it as
int8 x int8 -> int32 with a dynamic per-tensor activation scale; every
other consumer of a quantized leaf (``nn.Embed`` tables, a tied head's
``attend``, the ``DenseGeneral`` attention projections) computes on the
dequantized float tree.  The port must take the same layers (the same
count), compute every int32 accumulator bitwise equal to the
reference's, in the same order, land within 1e-4 of the reference's
int8_mxu output and within the reference's own bound of f32
(``tests/test_quantize.py``: 0.1 of the largest logit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.learn import quantize as JQ
from analytics_zoo_tpu.learn.inference_model import (
    InferenceModel as JInferenceModel)
from analytics_zoo_tpu.models import image as JI
from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu_torch.learn import quantize as PQ
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models import image as PI
from analytics_zoo_tpu_torch.models.lm import TransformerLM

from test_torch_keras_serving import _Recorder

@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One torch thread for this file, restored after: a multi-threaded
    f32 GEMM may split its sums by the threads it finds free, which moves
    an activation by an ulp now and then, and an ulp at a rounding edge
    moves an int8 input (and its accumulator row) off the reference's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_LM = dict(vocab_size=2048, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position=32)


def _tree(make_shapes, seed):
    """Seeded normals in the reference's tree (``jax.eval_shape``: no
    initializer compiles), each kernel scaled by its fan-in, scales near
    1 and positive running variances."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        fan = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1
        w = (rng.normal(size=leaf.shape) / np.sqrt(fan)).astype(np.float32)
        if name in ("scale", "var"):
            return (1.0 + 0.1 * np.abs(w)).astype(np.float32)
        return w
    return jax.tree_util.tree_map_with_path(fill, dict(make_shapes()))


def _ref_int8(monkeypatch, jm, v, x):
    """The reference's ``load_flax(quantize="int8_mxu").predict`` (its
    ``int8_call`` on the batch as predict pads it): its int32
    accumulators in order, the layers it took and its output."""
    accs, layers = [], set()
    monkeypatch.setattr(JQ, "lax", _Recorder(accs))
    for name in ("_dense_int8", "_conv_int8"):
        inner = getattr(JQ, name)

        def taken(mod, *a, inner=inner):
            layers.add(tuple(mod.path))
            return inner(mod, *a)
        monkeypatch.setattr(JQ, name, taken)
    out = np.asarray(JInferenceModel().load_flax(
        jm, v, quantize="int8_mxu").predict(x))
    jax.effects_barrier()
    monkeypatch.undo()
    return accs, layers, out


def _port_int8(monkeypatch, im, x):
    accs = []
    inner = PQ._rescale

    def rescale(acc, *a):
        accs.append(acc.numpy().copy())
        return inner(acc, *a)
    monkeypatch.setattr(PQ, "_rescale", rescale)
    out = np.asarray(im.predict(x), np.float32)
    monkeypatch.undo()
    return accs, out


def _check(monkeypatch, jm, v, make_port, x, n_layers):
    ref_accs, ref_layers, ref_out = _ref_int8(monkeypatch, jm, v, x)
    im = InferenceModel().load_flax(make_port(), v, quantize="int8_mxu",
                                    device="cpu")
    accs, got = _port_int8(monkeypatch, im, x)
    assert im.int8_layers == len(ref_layers) == n_layers
    assert len(accs) == len(ref_accs) == n_layers
    for a, b in zip(accs, ref_accs):
        assert a.dtype == np.int32 and b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(got).all()
    scale = np.abs(ref_out).max()
    np.testing.assert_allclose(got, ref_out, rtol=0, atol=1e-4 * scale)
    want = np.asarray(InferenceModel().load_flax(
        make_port(), v, device="cpu").predict(x), np.float32)
    ref32 = np.asarray(JInferenceModel().load_flax(jm, v).predict(x))
    np.testing.assert_allclose(want, ref32, rtol=0, atol=1e-5 * scale)
    assert np.abs(got - want).max() / np.abs(want).max() < 0.1
    assert im.quant_stats == JInferenceModel().load_flax(
        jm, v, quantize="int8_mxu").quant_stats
    return im


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_int8_mxu_graceful_on_non_dense_consumers(monkeypatch, tied):
    """The reference's pin on the LM: the embedding, the tied head and
    the attention projections consume quantized leaves on the float
    path; ffn_up and ffn_down of each layer (and an untied head, on f32
    inputs) run int8.  The port takes the same layers with the same
    accumulators."""
    cfg = dict(_LM, tied_head=tied)
    jm = JaxLM(dtype=jnp.float32, **cfg)
    x = np.random.default_rng(0).integers(0, 2048, (2, 16)).astype(np.int32)
    v = _tree(lambda: jax.eval_shape(jm.init, jax.random.key(0), x[:1]), 0)
    im = _check(monkeypatch, jm, v,
                lambda: TransformerLM(dtype=torch.float32, **cfg), x,
                2 * cfg["num_layers"] + (0 if tied else 1))
    taken = {type(m).__name__ for m in im.model.modules()
             if isinstance(m, torch.nn.Linear) and m.weight.numel() == 0}
    assert taken == {"Linear"}
    att = im.model.layers[0].attention
    assert att.query.weight.numel() > 0 and att.attn_out.weight.numel() > 0


def test_int8_mxu_resnet18_width8(monkeypatch):
    """A width-8 ResNet-18 (f32): the convs whose kernels reach the
    quantizer's 1,024 elements (the stem and the 3x3 convs of stages
    1-3: 14; stage 0's 3x3 convs, the 1x1 projections and the head stay
    f32) run int8 with the reference's accumulators, the BatchNorms on
    their running statistics between them."""
    jm = JI.resnet18(10, width=8, dtype=jnp.float32)
    x = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    v = _tree(lambda: jax.eval_shape(
        lambda: jm.init(jax.random.key(0), x[:1], train=False)), 1)
    _check(monkeypatch, jm, v,
           lambda: PI.resnet18(10, width=8, dtype=torch.float32), x, 14)


# GPT-2 small's shape with an untied head, and ResNet-50: chip_smoke.py
# phase 19c serves both on the card and holds their int8 layer counts to
# the ones these tests record from the reference's interceptor
_GPT2 = dict(vocab_size=50257, hidden_size=768, num_layers=12,
             num_heads=12, intermediate_size=3072, max_position=1024,
             tied_head=False)
_FULL_WIDTH_INT8_LAYERS = {"gpt2_untied": 25, "resnet50": 54}


@pytest.mark.parametrize("name", sorted(_FULL_WIDTH_INT8_LAYERS))
def test_full_width_int8_layer_counts(monkeypatch, name):
    """The layers the reference's interceptor takes at full width, traced
    abstractly (``jax.eval_shape``: no weights, no arithmetic), and the
    layers the port's ``int8_sites`` picks from the same quantized
    leaves on a model on the meta device: GPT-2 small with an untied
    head (ffn_up and ffn_down of 12 layers and the head) and ResNet-50
    (its 53 convs and the head)."""
    x = np.zeros((1, 8) if name == "gpt2_untied" else (1, 32, 32, 3),
                 np.int32 if name == "gpt2_untied" else np.float32)
    if name == "gpt2_untied":
        jm = JaxLM(dtype=jnp.float32, **_GPT2)
        shapes = jax.eval_shape(jm.init, jax.random.key(0), x)
    else:
        jm = JI.resnet50(1000, dtype=jnp.float32)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x,
                                                train=False))

    def quantized(leaf):
        if len(leaf.shape) < 2 or np.prod(leaf.shape) < 1024:
            return leaf
        return {JQ._Q: jax.ShapeDtypeStruct(leaf.shape, jnp.int8),
                JQ._S: jax.ShapeDtypeStruct(
                    (1,) * (len(leaf.shape) - 1) + leaf.shape[-1:],
                    jnp.float32)}
    qtree = jax.tree_util.tree_map(quantized, dict(shapes))
    layers = set()
    for fn in ("_dense_int8", "_conv_int8"):
        inner = getattr(JQ, fn)

        def taken(mod, *a, inner=inner):
            layers.add(tuple(mod.path))
            return inner(mod, *a)
        monkeypatch.setattr(JQ, fn, taken)
    kw = {} if name == "gpt2_untied" else {"train": False}
    jax.eval_shape(lambda q: JQ.int8_call(jm, q, x, **kw), qtree)
    want = _FULL_WIDTH_INT8_LAYERS[name]
    assert len(layers) == want
    with torch.device("meta"):
        model = TransformerLM(**_GPT2) if name == "gpt2_untied" \
            else PI.resnet50(1000)
    leaves = {("params",) + tuple(p.key for p in path[1:]):
              {"q": torch.empty(leaf[JQ._Q].shape, dtype=torch.int8,
                                device="meta")}
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  qtree, is_leaf=JQ._is_qleaf)[0]
              if path[0].key == "params" and JQ._is_qleaf(leaf)}
    sites = PQ.int8_sites(model, leaves)
    assert len(sites) == want
    # the same modules: the reference's layer_<i> is the port's layers.<i>
    assert {n for n, m in model.named_modules() if m in sites} == {
        ".".join(f"layers.{p[6:]}" if p.startswith("layer_") else p
                 for p in path) for path in layers}
