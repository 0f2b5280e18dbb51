"""The port's OpenVINO IR translator (``net/openvino_ir.py``), its
loaders (``Net.load_openvino``, ``InferenceModel.load_openvino``) and
``Estimator.from_openvino``, held to the JAX package's.

Every IR is written once (the reference's own ``_IRBuilder`` from
``tests/test_openvino.py``) and read by both packages; the same numpy
inputs go through the reference's ``OpenVINONet`` and the port's.
Tolerance at f32: rtol 1e-5, atol 1e-6.  Errors raise the same types
with the same words.  Where the port takes what the reference refuses
(``rounding_type="ceil"`` pools, ``auto_pad``), the reference runs the
same function written with explicit floor-rounded pads.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.learn import Estimator as JaxEstimator
from analytics_zoo_tpu.learn.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.net import Net as JaxNet
from analytics_zoo_tpu.net import OpenVINONet as JaxOpenVINONet
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.net import Net, OpenVINONet

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_openvino import _IRBuilder, _mlp_ir  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


class _Builder(_IRBuilder):
    """The reference's writer, with every element type."""

    _TYPES = {np.float32: "f32", np.float16: "f16", np.float64: "f64",
              np.int64: "i64", np.int32: "i32", np.int16: "i16",
              np.int8: "i8", np.uint64: "u64", np.uint32: "u32",
              np.uint16: "u16", np.uint8: "u8", np.bool_: "boolean"}

    def const(self, arr, name=None):
        arr = np.ascontiguousarray(arr)
        lid = self.layer("Const", name=name, data={
            "element_type": self._TYPES[arr.dtype.type],
            "shape": ",".join(str(d) for d in arr.shape),
            "offset": str(len(self.blob)), "size": str(arr.nbytes)})
        self.blob += arr.tobytes()
        return lid

    def op(self, type_, *srcs, data=None, name=None):
        lid = self.layer(type_, name=name, data=data, n_in=len(srcs))
        for i, s in enumerate(srcs):
            self.edge(s, lid, i)
        return lid

    def result(self, src):
        res = self.layer("Result", n_in=1, n_out=0)
        self.edge(src, res, 0)


def _both(xml, *xs):
    """(reference output, port output) of the IR at ``xml``, as numpy."""
    ref = JaxOpenVINONet.from_ir(xml)
    port = OpenVINONet.from_ir(xml)
    assert port.input_names == ref.input_names
    assert port.output_names == ref.output_names
    assert set(port.params) == set(ref.params)
    for k, v in ref.params.items():
        got = port.params[k].numpy()
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    want = np.asarray(ref(ref.params, *[jnp.asarray(x) for x in xs]))
    with torch.no_grad():
        got = port(*[torch.from_numpy(np.asarray(x)) for x in xs]).numpy()
    return want, got


def _conv_pipeline_ir(tmp_path, rng):
    """The reference's conv/pool/reshape pipeline (``test_openvino.py``
    ``test_ir_conv_pool_reshape_pipeline``)."""
    b = _Builder()
    x = b.layer("Parameter", name="pixels")
    conv = b.op("Convolution", x, b.const(
        rng.normal(size=(4, 3, 3, 3)).astype(np.float32) * 0.3, "convw"),
        data={"strides": "1,1", "pads_begin": "1,1", "pads_end": "1,1",
              "dilations": "1,1"})
    add = b.op("Add", conv, b.const(
        rng.normal(size=(1, 4, 1, 1)).astype(np.float32), "convb"))
    relu = b.op("ReLU", add)
    mp = b.op("MaxPool", relu, data={"kernel": "2,2", "strides": "2,2",
                                     "pads_begin": "0,0", "pads_end": "0,0"})
    rm = b.op("ReduceMean", mp, b.const(np.asarray([2, 3], np.int64),
                                        "axes"),
              data={"keep_dims": "false"})
    rs = b.op("Reshape", rm, b.const(np.asarray([0, 4], np.int64), "shape"),
              data={"special_zero": "true"})
    mm = b.op("MatMul", rs, b.const(
        rng.normal(size=(4, 2)).astype(np.float32), "head"),
        data={"transpose_a": "false", "transpose_b": "false"})
    b.result(mm)
    return b.write(tmp_path, "cv")


def test_mlp(tmp_path):
    rng = np.random.default_rng(0)
    xml, _ = _mlp_ir(tmp_path, rng)
    want, got = _both(xml, rng.normal(size=(5, 4)).astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert set(OpenVINONet.from_ir(xml).params) == {"w1", "b1", "w2"}


def test_conv_pool_reshape_pipeline(tmp_path):
    rng = np.random.default_rng(1)
    xml = _conv_pipeline_ir(tmp_path, rng)
    want, got = _both(xml, rng.normal(size=(2, 3, 8, 8)).astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # shape-like Consts resolve at build and are not params
    assert set(OpenVINONet.from_ir(xml).params) == {"convw", "convb", "head"}


def test_prelu_channelwise_slope(tmp_path):
    b = _Builder()
    x = b.layer("Parameter", name="in")
    b.result(b.op("PReLU", x, b.const(np.asarray([0.1, 0.5, 2.0],
                                                 np.float32), "slope")))
    xml = b.write(tmp_path, "prelu")
    xin = np.random.default_rng(2).normal(size=(2, 3, 2, 2)).astype(
        np.float32)
    want, got = _both(xml, xin)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("table_dtype", [np.float32, np.int32])
def test_gather_embedding_lookup(tmp_path, table_dtype):
    """Gather (data, indices, axis Const) with negative indices (they
    wrap) and indices past the table (NaN, or the type's lowest value),
    as ``jnp.take`` reads them."""
    b = _Builder()
    ct = b.const(np.arange(20).reshape(5, 4).astype(table_dtype), "table")
    idx = b.layer("Parameter", name="ids")
    b.result(b.op("Gather", ct, idx, b.const(np.asarray([0], np.int64),
                                             "axis")))
    xml = b.write(tmp_path, "gather")
    want, got = _both(xml, np.asarray([[3, 0], [-1, 4], [5, -6]], np.int32))
    np.testing.assert_array_equal(got, want)
    # the axis-1 lookup of a batch of rows
    b = _Builder()
    x = b.layer("Parameter", name="x")
    idx = b.const(np.asarray([2, -1, 0], np.int64), "idx")
    b.result(b.op("Gather", x, idx, b.const(np.asarray(1, np.int64),
                                            "axis")))
    xml = b.write(tmp_path, "gather1")
    want, got = _both(xml, np.arange(24, dtype=np.float32).reshape(2, 4, 3))
    np.testing.assert_array_equal(got, want)


def test_every_op_of_the_curated_set(tmp_path):
    """One IR through every op of the reference's list: grouped and
    dilated convolutions with unequal pads, BatchNormInference, both
    Gelu modes, Clamp, the unary and binary ops, MatMul with transposes,
    Squeeze/Unsqueeze/Transpose/Concat, Softmax; f16, f64, i64 and i32
    Consts."""
    rng = np.random.default_rng(3)

    def w(*shape, scale=0.3, dtype=np.float32):
        return (rng.normal(size=shape) * scale).astype(dtype)

    b = _Builder()
    x = b.layer("Parameter", name="image")
    c1 = b.op("Convolution", x, b.const(w(8, 4, 3, 3), "c1"), data={
        "strides": "2,1", "pads_begin": "0,1", "pads_end": "2,0",
        "dilations": "1,2"})
    gc = b.op("GroupConvolution", c1, b.const(w(4, 2, 2, 3, 3), "gc"),
              data={"strides": "1,1", "pads_begin": "1,1",
                    "pads_end": "1,1", "dilations": "1,1"})
    bn = b.op("BatchNormInference", gc, b.const(w(8, scale=1.0) + 1, "g"),
              b.const(w(8), "beta"), b.const(w(8), "mean"),
              b.const(np.abs(w(8)) + 0.5, "var"), data={"epsilon": "1e-3"})
    act = b.op("Gelu", bn, data={"approximation_mode": "ERF"})
    act2 = b.op("Gelu", act, data={"approximation_mode": "TANH"})
    cl = b.op("Clamp", act2, data={"min": "-0.5", "max": "2.0"})
    sg = b.op("Sigmoid", cl)
    th = b.op("Tanh", cl)
    ex = b.op("Exp", th)
    sq = b.op("Sqrt", ex)
    mix = b.op("Add", b.op("Multiply", sg, sq),
               b.op("Divide", b.op("Subtract", ex, sg),
                    b.const(np.full((1, 8, 1, 1), 1.5, np.float16), "half")))
    mm = b.op("Minimum", b.op("Maximum", mix, b.const(
        np.asarray(0.25, np.float64), "floor")), sq)
    rm = b.op("ReduceMean", mm, b.const(np.asarray([-1], np.int64), "ax"),
              data={"keep_dims": "true"})                # N, 8, H, 1
    sqz = b.op("Squeeze", rm, b.const(np.asarray([3], np.int64), "sq_ax"))
    tr = b.op("Transpose", sqz, b.const(np.asarray([0, 2, 1], np.int64),
                                        "perm"))          # N, H, 8
    mt = b.op("MatMul", tr, b.const(w(5, 8), "proj"),
              data={"transpose_a": "false", "transpose_b": "true"})
    mt2 = b.op("MatMul", b.const(w(5, 3), "left"), mt,
               data={"transpose_a": "true", "transpose_b": "true"})
    uns = b.op("Unsqueeze", mt2, b.const(np.asarray([-1, 0], np.int32),
                                         "un_ax"))
    cat = b.op("Concat", uns, uns, data={"axis": "-1"})
    rs = b.op("Reshape", cat, b.const(np.asarray([0, 0, -1], np.int64),
                                      "target"),
              data={"special_zero": "true"})
    b.result(b.op("Softmax", rs, data={"axis": "2"}))
    xml = b.write(tmp_path, "zoo")
    want, got = _both(xml, rng.normal(size=(2, 4, 9, 10)).astype(
        np.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", list(_Builder._TYPES))
def test_every_element_type(tmp_path, dtype):
    """A Const of each element type read as the reference reads it (64-bit
    types as 32-bit); the unsigned types torch does not compute in read
    into a signed type that holds their values."""
    vals = np.asarray([[0, 1, 7], [100, 3, 1]]).astype(dtype)
    b = _Builder()
    b.layer("Parameter", name="unused")
    b.result(b.const(vals, "c"))
    xml = b.write(tmp_path, "types")
    ref = np.asarray(JaxOpenVINONet.from_ir(xml).params["c"])
    with torch.no_grad():
        got = OpenVINONet.from_ir(xml)(np.zeros(1, np.float32)).numpy()
    np.testing.assert_array_equal(got, ref)
    widened = {np.uint16: np.int32, np.uint32: np.int64, np.uint64: np.int64}
    assert got.dtype == widened.get(dtype, ref.dtype)


def _pool_ir(tmp_path, name, kind, data):
    b = _Builder()
    x = b.layer("Parameter", name="x")
    b.result(b.op(kind, x, data=data))
    return b.write(tmp_path, name)


@pytest.mark.parametrize("kind,exclude", [("AvgPool", "true"),
                                          ("AvgPool", "false"),
                                          ("MaxPool", None)])
def test_ceil_pools_and_unequal_pads(tmp_path, kind, exclude):
    """A ceil-rounded pool with unequal pads: the reference refuses
    ``rounding_type="ceil"``, so it runs the same windows written with
    floor rounding and the ragged window's positions as end pads, which
    a pool never counts (exclude-pad, max) or counts as OpenVINO does
    (include-pad: the window's extent within the declared pads, so the
    reference runs that case over a zero-padded input instead)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 11, 10)).astype(np.float32)
    data = {"kernel": "3,3", "strides": "2,2", "pads_begin": "1,0",
            "pads_end": "0,1", "rounding_type": "ceil"}
    if exclude is not None:
        data["exclude-pad"] = exclude
    xml = _pool_ir(tmp_path, "ceil", kind, data)
    with pytest.raises(NotImplementedError, match="rounding_type"):
        JaxOpenVINONet.from_ir(xml)(JaxOpenVINONet.from_ir(xml).params,
                                    jnp.asarray(x))
    with torch.no_grad():
        got = OpenVINONet.from_ir(xml)(torch.from_numpy(x)).numpy()
    # H: (11 + 1 - 3) / 2 -> ceil 4.5 = 5, +1 = 6 windows, the last
    # reading 1 past the pads; W: (10 + 1 - 3) / 2 = 4, +1 = 5, none
    assert got.shape == (2, 3, 6, 5)
    floor = dict(data, rounding_type="floor", pads_end="1,1")
    if exclude == "false":
        # include-pad: the declared pads count, the ragged position not
        floor = dict(floor, pads_begin="0,0", pads_end="1,0",
                     **{"exclude-pad": "true"})
        xp = np.pad(x, ((0, 0), (0, 0), (1, 0), (0, 1)))
        xml = _pool_ir(tmp_path, "floor", kind, floor)
        ref = JaxOpenVINONet.from_ir(xml)
        want = np.asarray(ref(ref.params, jnp.asarray(xp)))
    else:
        xml = _pool_ir(tmp_path, "floor", kind, floor)
        ref = JaxOpenVINONet.from_ir(xml)
        want = np.asarray(ref(ref.params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("auto_pad,conv_pads,pool_pads", [
    ("same_upper", ("0,0", "1,1"), ("0,0", "1,1")),
    ("same_lower", ("1,1", "0,0"), ("1,1", "0,0")),
    ("valid", ("0,0", "0,0"), ("0,0", "0,0"))])
def test_auto_pad(tmp_path, auto_pad, conv_pads, pool_pads):
    """``auto_pad`` on a convolution and on a pool, against the
    reference on the pads it resolves to: H 10 by stride 2 and kernel 3,
    W 8 by stride 1 and kernel 2, each 1 pad short of ``ceil(size /
    stride)`` outputs (at the end for ``same_upper``, the start for
    ``same_lower``), then the pool's 2 x 2 by stride 1 the same."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 2, 10, 8)).astype(np.float32)
    wt = rng.normal(size=(3, 2, 3, 2)).astype(np.float32)

    def ir(name, conv, pool):
        b = _Builder()
        xin = b.layer("Parameter", name="x")
        c = b.op("Convolution", xin, b.const(wt, "w"), data=dict(
            {"strides": "2,1", "dilations": "1,1"}, **conv))
        b.result(b.op("AvgPool", c, data=dict(
            {"kernel": "2,2", "strides": "1,1", "exclude-pad": "true"},
            **pool)))
        return b.write(tmp_path, name)

    auto = {"auto_pad": auto_pad, "pads_begin": "7,7", "pads_end": "7,7"}
    port_xml = ir("auto", auto, auto)
    ref = JaxOpenVINONet.from_ir(ir(
        "explicit", dict(pads_begin=conv_pads[0], pads_end=conv_pads[1]),
        dict(pads_begin=pool_pads[0], pads_end=pool_pads[1])))
    want = np.asarray(ref(ref.params, jnp.asarray(x)))
    with torch.no_grad():
        got = OpenVINONet.from_ir(port_xml)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_unsupported_layer_and_second_port_raise_as_the_reference(tmp_path):
    b = _Builder()
    x = b.layer("Parameter", name="in")
    b.result(b.op("ROIAlign", x))
    xml = b.write(tmp_path, "bad")
    ref = JaxNet.load_openvino(xml)
    with pytest.raises(NotImplementedError) as want:
        ref(ref.params, jnp.zeros((1, 4), jnp.float32))
    with pytest.raises(NotImplementedError) as got:
        Net.load_openvino(xml)       # the port refuses at build
    assert str(got.value) == str(want.value) and "ROIAlign" in str(got.value)

    b = _Builder()
    x = b.layer("Parameter", name="x")
    mp = b.layer("MaxPool", name="pool", n_in=1, n_out=2, data={
        "kernel": "2", "strides": "2", "pads_begin": "0", "pads_end": "0"})
    b.edge(x, mp, 0)
    res = b.layer("Result", n_in=1, n_out=0)
    b.edges.append((mp, "2", res, "0"))      # the indices output
    xml = b.write(tmp_path, "twoport")
    with pytest.raises(NotImplementedError) as want:
        JaxOpenVINONet.from_ir(xml)
    with pytest.raises(NotImplementedError) as got:
        OpenVINONet.from_ir(xml)
    assert str(got.value) == str(want.value) and "output port" in str(
        got.value)

    b = _Builder()
    x = b.layer("Parameter", name="x")
    b.result(b.op("Gather", x, b.const(np.zeros((1, 2), np.int64), "i"),
                  b.const(np.asarray(1, np.int64), "a"),
                  data={"batch_dims": "1"}))
    xml = b.write(tmp_path, "batchdims")
    ref = JaxOpenVINONet.from_ir(xml)
    with pytest.raises(NotImplementedError) as want:
        ref(ref.params, jnp.zeros((1, 3), jnp.float32))
    with pytest.raises(NotImplementedError) as got:
        OpenVINONet.from_ir(xml)
    assert str(got.value) == str(want.value)


def test_net_facade_errors(tmp_path):
    missing = str(tmp_path / "nope.xml")
    with pytest.raises(FileNotFoundError) as want:
        JaxNet.load_openvino(missing)
    with pytest.raises(FileNotFoundError) as got:
        Net.load_openvino(missing)
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError) as want:
        JaxNet.load_torch(3)
    with pytest.raises(TypeError) as got:
        Net.load_torch(3)
    assert str(got.value) == str(want.value)
    for load in (Net.load_tf, Net.load_keras):
        with pytest.raises(NotImplementedError, match="item 4"):
            load(str(tmp_path))
    m = torch.nn.Linear(3, 2)
    path = tmp_path / "m.pt"
    torch.save(m, path)
    assert Net.load_torch(m) is m
    back = Net.load_torch(str(path))
    np.testing.assert_array_equal(back.weight.detach().numpy(),
                                  m.weight.detach().numpy())


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_load_openvino_quantized_equals_the_reference(tmp_path, mode):
    """``quantize=`` over the IR's params: int8 values and scales
    bitwise the reference's, the same ``quant_stats``, and predictions
    equal to the reference's dequantized forward."""
    rng = np.random.default_rng(6)

    def dense(n_in, n_out):     # a network's init: variance 1 / n_in
        return (rng.normal(size=(n_in, n_out)) / np.sqrt(n_in)).astype(
            np.float32)

    b = _Builder()
    x = b.layer("Parameter", name="x")
    h = b.op("ReLU", b.op("Add", b.op(
        "MatMul", x, b.const(dense(16, 128), "w1"),
        data={"transpose_a": "false", "transpose_b": "false"}),
        b.const(dense(1, 128), "b1")))
    b.result(b.op("MatMul", h, b.const(dense(128, 10), "w2"),
                  data={"transpose_a": "false", "transpose_b": "false"}))
    xml = b.write(tmp_path, "q")
    xin = rng.normal(size=(6, 16)).astype(np.float32)
    ref = JaxInferenceModel().load_openvino(xml, quantize=mode)
    im = InferenceModel().load_openvino(xml, quantize=mode, device="cpu")
    assert im.quant_stats == ref.quant_stats
    rparams = ref._variables["params"]
    if mode == "int8":
        assert set(im._qstate) == {"w1", "w2"}      # b1 is under min_size
        for k, v in im._qstate.items():
            np.testing.assert_array_equal(v["q"].numpy(),
                                          np.asarray(rparams[k]["__q8__"]))
            rs = np.asarray(rparams[k]["__q8_scale__"])
            np.testing.assert_array_equal(
                v["scale"].reshape(rs.shape).numpy(), rs)
    else:
        for k, v in im._qstate.items():
            np.testing.assert_array_equal(
                v.float().numpy(), np.asarray(rparams[k], np.float32))
    np.testing.assert_allclose(im.predict(xin), np.asarray(ref.predict(xin)),
                               rtol=RTOL, atol=ATOL)
    plain = InferenceModel().load_openvino(xml, device="cpu").predict(xin)
    np.testing.assert_array_equal(im.predict(xin).argmax(1), plain.argmax(1))
    with pytest.raises(ValueError, match="only supported by load_flax"):
        InferenceModel().load_openvino(xml, quantize="int8_mxu",
                                       device="cpu")


def test_estimator_from_openvino(tmp_path):
    rng = np.random.default_rng(7)
    xml, _ = _mlp_ir(tmp_path, rng)
    with pytest.raises(ValueError) as want:
        JaxEstimator.from_openvino()
    with pytest.raises(ValueError) as got:
        Estimator.from_openvino()
    assert str(got.value) == str(want.value)
    est = Estimator.from_openvino(model_path=xml, feature_cols=("x",),
                                  label_cols=("y",), device="cpu")
    x = rng.normal(size=(13, 4)).astype(np.float32)
    ref = JaxOpenVINONet.from_ir(xml)
    want = np.asarray(ref(ref.params, jnp.asarray(x)))
    np.testing.assert_allclose(est.predict({"x": x}, batch_size=8), want,
                               rtol=RTOL, atol=ATOL)
    y = rng.normal(size=(13, 3)).astype(np.float32)
    ev = est.evaluate({"x": x, "y": y}, batch_size=8)
    np.testing.assert_allclose(ev["loss"], np.mean((want - y) ** 2),
                               rtol=1e-5)
    with pytest.raises(NotImplementedError, match="inference-only"):
        est.fit({"x": x, "y": y}, epochs=1, batch_size=8)
