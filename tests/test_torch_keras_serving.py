"""``InferenceModel.load_flax`` in its four quantize modes, port against
reference, on the CPU.

One Keras model (a conv path: a Conv2D, a grouped SeparableConv2D, max
pooling, Dense; a sequence path: an Embedding and a GRU) is built on
both sides and served from the same reference variables.  ``None``,
``"bf16"`` and ``"int8"`` (weight-only): predictions at 1e-5 and the
same ``quant_stats``.  ``"int8_mxu"``: every int32 accumulator BITWISE
equal to the reference's (int8 products are exact; the ops between the
int8 layers are exact too, relu, max and reshape, so each layer's int8
input is the reference's), the same count of int8 layers, the outputs at
1e-5 of the reference's int8_mxu outputs and within the reference's own
tolerance of f32 (``tests/test_quantize.py``: 0.15 of the largest logit,
argmax agreement); layers the reference's interceptor does not take
(Embedding, ConvTranspose, LocallyConnected, the LSTM's gates) run on
the dequantized float weights, as there.
"""

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu import init_orca_context, stop_orca_context
from analytics_zoo_tpu import keras as JK
from analytics_zoo_tpu.learn import quantize as JQ
from analytics_zoo_tpu.learn.inference_model import (
    InferenceModel as JInferenceModel)
from analytics_zoo_tpu_torch import keras as PK
from analytics_zoo_tpu_torch.learn import quantize as PQ
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """The full suite runs in 6 pytest-xdist workers that share the
    machine's cores; torch's default of one intra-op thread a core
    oversubscribes them, and small eager ops then spend their time
    handing work between threads. One torch thread for this file,
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


@pytest.fixture()
def mesh8():
    init_orca_context("local", mesh_axes={"dp": 8})
    yield
    stop_orca_context()


def _served(K):
    img, tok = K.Input(shape=(8, 8, 8)), K.Input(shape=(6,))
    x = K.Convolution2D(16, 3, 3, border_mode="same", activation="relu")(img)
    x = K.SeparableConvolution2D(32, 3, 3, border_mode="same",
                                 depth_multiplier=8, activation="relu")(x)
    x = K.Flatten()(K.MaxPooling2D(pool_size=2)(x))
    x = K.Dense(10)(K.Dense(64, activation="relu")(x))
    s = K.Dense(10)(K.GRU(32)(K.Embedding(100, 32)(tok)))
    return K.Model(input=[img, tok], output=K.merge([x, s], mode="concat"))


def _fallbacks(K):
    """Layers whose quantized kernels the reference's interceptor leaves
    on the float path, and one plain Dense it takes."""
    seq = K.Input(shape=(6, 16))
    x = K.LSTM(32, return_sequences=True)(seq)
    x = K.LocallyConnected1D(32, 2)(x)
    x = K.Reshape((5, 8, 4))(x)
    x = K.Deconvolution2D(32, 3, 3, subsample=(2, 2))(x)
    x = K.Flatten()(x)
    return K.Model(input=seq, output=K.Dense(10)(x))


def _inputs(rng, n=8):
    return [rng.normal(size=(n, 8, 8, 8)).astype(np.float32),
            rng.integers(0, 100, (n, 6)).astype(np.int32)]


def _variables(make, xs, seed=0):
    """The reference model and its tree (``jax.eval_shape``: no
    initializer compiles) of seeded normals, each kernel scaled by its
    fan-in."""
    jm = make(JK)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(seed)}, *xs, train=False))
    rng = np.random.default_rng(seed)

    def fill(leaf):
        fan = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1
        return (rng.normal(size=leaf.shape) / np.sqrt(fan)).astype(
            np.float32)

    return jm, jax.tree_util.tree_map(fill, dict(shapes))


@pytest.mark.parametrize("mode", [None, "bf16", "int8"])
def test_load_flax_matches_reference(mesh8, mode):
    rng = np.random.default_rng(0)
    xs = _inputs(rng)
    jm, v = _variables(_served, xs)
    ref = JInferenceModel().load_flax(jm, v, quantize=mode)
    im = InferenceModel().load_flax(_served(PK), v, quantize=mode,
                                    device="cpu")
    want, got = np.asarray(ref.predict(*xs)), im.predict(*xs)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert im.quant_stats == ref.quant_stats
    assert im.int8_layers == 0
    if mode:
        # the quantized weights rest quantized; predicting restores none
        assert im.model.ops_4.Dense_0.weight.numel() == 0
        np.testing.assert_array_equal(im.predict(*xs), got)


class _Recorder:
    """A stand-in for ``jax.lax`` inside the reference's quantize module
    that keeps every int32 accumulator it computes."""

    def __init__(self, accs):
        self._accs = accs

    def __getattr__(self, name):
        fn = getattr(jax.lax, name)
        if name not in ("dot_general", "conv_general_dilated"):
            return fn

        def call(*a, **kw):
            out = fn(*a, **kw)
            if isinstance(out, jax.core.Tracer):    # inside the RNN's scan
                jax.debug.callback(lambda v: self._accs.append(
                    np.asarray(v)), out, ordered=True)
            else:
                self._accs.append(np.asarray(out))
            return out
        return call


def _ref_int8(monkeypatch, jm, v, xs):
    """The reference's int8_call run eagerly: its accumulators in order,
    the distinct layers it took, and its output."""
    accs, layers = [], set()
    monkeypatch.setattr(JQ, "lax", _Recorder(accs))
    for name in ("_dense_int8", "_conv_int8"):
        inner = getattr(JQ, name)

        def taken(mod, *a, inner=inner):
            layers.add(tuple(mod.path))
            return inner(mod, *a)
        monkeypatch.setattr(JQ, name, taken)
    qv, _ = JQ.quantize_params(v, "int8")
    out = np.asarray(JQ.int8_call(jm, qv, *xs, train=False))
    monkeypatch.undo()
    return accs, layers, out


def _port_int8(monkeypatch, im, xs):
    accs = []
    inner = PQ._rescale

    def rescale(acc, *a):
        accs.append(acc.numpy().copy())
        return inner(acc, *a)
    monkeypatch.setattr(PQ, "_rescale", rescale)
    out = im.predict(*xs)
    monkeypatch.undo()
    return accs, out


def test_int8_mxu_accumulators_bitwise(mesh8, monkeypatch):
    rng = np.random.default_rng(1)
    xs = _inputs(rng)
    jm, v = _variables(_served, xs, seed=1)
    ref_accs, ref_layers, ref_out = _ref_int8(monkeypatch, jm, v, xs)
    im = InferenceModel().load_flax(_served(PK), v, quantize="int8_mxu",
                                    device="cpu")
    accs, got = _port_int8(monkeypatch, im, xs)
    # the convs, the SeparableConv's two, the Dense(64); the GRU's six
    # gates a step (Dense(10)'s 640-entry kernels stay f32)
    assert im.int8_layers == len(ref_layers) == 10
    assert len(accs) == len(ref_accs) == 4 + 6 * 6
    for a, b in zip(accs, ref_accs):
        assert a.dtype == np.int32 and b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got, ref_out, rtol=TOL, atol=TOL)
    # and the reference's own tolerance of f32 (test_quantize.py)
    f32 = InferenceModel().load_flax(_served(PK), v, device="cpu")
    want = f32.predict(*xs)
    assert np.abs(got - want).max() / np.abs(want).max() < 0.15
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.75
    assert im.quant_stats == JInferenceModel().load_flax(
        jm, v, quantize="int8_mxu").quant_stats


def test_int8_mxu_graceful_on_non_dense_consumers(mesh8, monkeypatch):
    """The reference's contract: quantized kernels its interceptor does
    not take (an LSTM's gates, a locally connected kernel, a transposed
    conv) run the dequantized float math; the port = the reference's
    int8_mxu, finite, near f32."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 6, 16)).astype(np.float32)
    jm, v = _variables(_fallbacks, [x])
    ref_accs, ref_layers, ref_out = _ref_int8(monkeypatch, jm, v, [x])
    im = InferenceModel().load_flax(_fallbacks(PK), v, quantize="int8_mxu",
                                    device="cpu")
    accs, got = _port_int8(monkeypatch, im, [x])
    assert im.int8_layers == len(ref_layers) == 1          # the Dense
    for a, b in zip(accs, ref_accs):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref_out, rtol=1e-4, atol=1e-4)
    want = InferenceModel().load_flax(_fallbacks(PK), v,
                                      device="cpu").predict(x)
    assert np.abs(got - want).max() / np.abs(want).max() < 0.1


def test_int8_matmul_pads_to_the_int8_gemm_shapes(monkeypatch):
    """The card's path (``torch._int_mm``) pads to more than 16 rows and
    widths a multiple of 8 and slices back; here its padded operands are
    run through the plain product and held to an int64 matmul."""
    rng = np.random.default_rng(3)
    calls = []

    def int_mm(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return (a.long() @ b.long()).int()

    monkeypatch.setattr(torch, "_int_mm", int_mm, raising=False)

    class Cudaish(torch.Tensor):
        is_cuda = True

    for m, k, n in ((1, 25, 10), (17, 8, 8), (5, 4608, 1000)):
        a = torch.as_tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8)
        b = torch.as_tensor(rng.integers(-127, 128, (k, n)), dtype=torch.int8)
        got = PQ.int8_matmul(a.as_subclass(Cudaish), b)
        np.testing.assert_array_equal(np.asarray(got),
                                      a.long().numpy() @ b.long().numpy())
        mp, kp, np_ = calls[-1][0][0], calls[-1][0][1], calls[-1][1][1]
        assert mp > 16 and kp % 8 == 0 and np_ % 8 == 0


def test_int8_mxu_only_through_load_flax():
    """The other loaders keep the reference's ValueError; a bad mode
    raises.  (Modules outside the Keras API take int8_mxu through
    ``load_flax``: ``test_torch_int8_modules.py``.)"""
    with pytest.raises(ValueError, match="int8_mxu"):
        InferenceModel().load_torch_generator(
            None, None, max_new_tokens=2, quantize="int8_mxu")
    with pytest.raises(ValueError, match="unknown quantize"):
        InferenceModel().load_flax(_served(PK), {}, quantize="fp8",
                                   device="cpu")

