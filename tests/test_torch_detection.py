"""The port's SSD detection (``models/detection.py``) against the JAX
package: anchors, the SSD forward in train and eval mode with its batch
statistics, ``multibox_loss`` with a best anchor that two boxes share
and padding rows, ``decode_detections``, and an ``SSDDetector`` fit.

Weights are seeded normals in the reference's tree (kernels scaled by
their fan-in); ``params_from_flax`` and ``batch_stats_from_flax`` carry
them into the port.  Tolerances: the f32 forward and running statistics
within 1e-5 of each tensor's largest magnitude (at least 1), in train
mode against a float64 evaluation (see the test); the loss and
its gradients within 1e-6 relative (sums over the anchors in another
order); the fit's losses 1e-5 relative and its parameters 1e-5 of each
tensor's scale.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu.models.detection as jdet
import analytics_zoo_tpu_torch.models.detection as tdet
from analytics_zoo_tpu import init_orca_context, stop_orca_context
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.models.layers import (batch_stats_from_flax,
                                                   params_from_flax)

_TOL = 1e-5


def _scaled(want):
    return _TOL * max(1.0, float(np.abs(np.asarray(want)).max()))


def _variables(model, x, seed=0):
    """Seeded weights and running statistics in the reference's tree,
    from the traced shapes of ``init`` (nothing is compiled)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0), x)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return (std * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("scale", "var"):
            return (1.0 + 0.2 * rng.random(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _as_f64(tm):
    """The same port module computing in float64."""
    tm = tm.double()
    for m in tm.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return tm


def _as_accurate(got, want, exact, what):
    """``got`` no further from the float64 ``exact`` than twice
    ``want`` is (or within the tolerance of it)."""
    exact = np.asarray(exact, np.float64)
    err, ref_err = (float(np.abs(np.asarray(a, np.float64) - exact).max())
                    for a in (got, want))
    assert err <= max(2 * ref_err, _scaled(exact)), (what, err, ref_err)


def _boxed_images(n, size, seed=0, max_boxes=4):
    """The reference test's planted squares (one a image, -1 padding)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.05, (n, size, size, 3)).astype(np.float32)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    classes = np.full((n, max_boxes), -1, np.int32)
    for i in range(n):
        s = int(rng.integers(size // 4, size // 2))
        top = int(rng.integers(0, size - s))
        left = int(rng.integers(0, size - s))
        x[i, top:top + s, left:left + s] = 1.0
        boxes[i, 0] = (top / size, left / size, (top + s) / size,
                       (left + s) / size)
        classes[i, 0] = i % 2
    return x, boxes, classes


@pytest.mark.parametrize("size", [64, 72, 256])
def test_anchors_match_jax(size):
    got = tdet.ssd_anchors(size, [8, 16, 32], [0.15, 0.35, 0.6])
    want = jdet.ssd_anchors(size, [8, 16, 32], [0.15, 0.35, 0.6])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tdet.SSD(1, image_size=size, backbone_width=8).anchors(),
        jdet.SSD(num_classes=1, image_size=size,
                 backbone_width=8).anchors())


@pytest.mark.parametrize("train", [False, True])
def test_ssd_forward_matches_jax(train):
    """Width 8 at 72 x 72 (32 does not divide it: ceil grids, odd sizes
    under the stride-2 convs), f32.  In train mode the deepest level's
    batch statistics (3 x 3 maps of 2 images) are ill-conditioned in f32
    in both packages, so there the port is held to a float64 evaluation:
    no further from it than twice the reference (as
    ``test_torch_image.py`` holds a ResNet-50's)."""
    jm = jdet.SSD(num_classes=2, image_size=72, backbone_width=8,
                  dtype=jnp.float32)

    def port():
        tm = tdet.SSD(2, image_size=72, backbone_width=8,
                      dtype=torch.float32)
        tm.load_state_dict({**params_from_flax(v["params"]),
                            **batch_stats_from_flax(v["batch_stats"])})
        return tm

    x = np.random.default_rng(1).standard_normal((2, 72, 72, 3)).astype(
        np.float32)
    v = _variables(jm, x)
    tm = port()
    if train:
        (wl, wc), mut = jax.jit(functools.partial(
            jm.apply, train=True, mutable=["batch_stats"]))(v, x)
    else:
        wl, wc = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        gl, gc = tm(torch.from_numpy(x), train=train)
        if train:
            exact = _as_f64(port())
            el, ec = exact(torch.from_numpy(x).double(), train=True)
    assert gl.shape == wl.shape and gc.shape == wc.shape
    assert gl.shape[1] == tm.anchors().shape[0]
    have = tm.state_dict()
    want = batch_stats_from_flax(mut["batch_stats"] if train
                                 else v["batch_stats"])
    for g, w in ((gl, wl), (gc, wc)):
        assert g.dtype == torch.float32
    if train:
        for g, w, e, what in ((gl, wl, el, "loc"), (gc, wc, ec, "cls")):
            _as_accurate(g.numpy(), np.asarray(w), e.numpy(), what)
        for name, w in want.items():
            _as_accurate(have[name].numpy(), w.numpy(),
                         exact.state_dict()[name].numpy(), name)
        return
    for g, w in ((gl, wl), (gc, wc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=_scaled(w), rtol=0)
    for name, w in want.items():
        np.testing.assert_allclose(have[name].numpy(), w.numpy(),
                                   atol=_scaled(w), rtol=0, err_msg=name)


def _shared_anchor_batch(anchors):
    """Two images: boxes 0 and 1 of image 0 share their best anchor
    (different classes and coordinates), image 1 has one box; every
    other row is padding."""
    boxes = np.zeros((2, 4, 4), np.float32)
    classes = np.full((2, 4), -1, np.int32)
    cy, cx, h, w = anchors[3 * 27]          # a square anchor of level 0
    boxes[0, 0] = (cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2)
    boxes[0, 1] = (cy - 0.45 * h, cx - 0.47 * w, cy + 0.46 * h,
                   cx + 0.44 * w)
    classes[0, :2] = (0, 1)
    boxes[1, 0] = (0.05, 0.55, 0.40, 0.95)
    classes[1, 0] = 1
    iou = tdet._iou_matrix(tdet._corners(torch.from_numpy(anchors)),
                           torch.from_numpy(boxes[0, :2])).numpy()
    best = iou.argmax(axis=0)
    assert best[0] == best[1], best             # the planted share
    return boxes, classes, int(best[0])


def _loss_and_grads(fn, loc, cls, boxes, classes, lib):
    if lib == "jax":
        val, grads = jax.value_and_grad(
            lambda p: fn(p, (jnp.asarray(boxes), jnp.asarray(classes))))(
                (jnp.asarray(loc), jnp.asarray(cls)))
        return float(val), [np.asarray(g) for g in grads]
    tl = torch.from_numpy(loc).requires_grad_()
    tc = torch.from_numpy(cls).requires_grad_()
    val = fn((tl, tc), (torch.from_numpy(boxes), torch.from_numpy(classes)))
    val.backward()
    return float(val.detach()), [tl.grad.numpy(), tc.grad.numpy()]


def test_multibox_loss_matches_jax_with_a_shared_anchor():
    anchors = jdet.ssd_anchors(64, [8, 16, 32], [0.15, 0.35, 0.6])
    boxes, classes, shared = _shared_anchor_batch(anchors)
    rng = np.random.default_rng(2)
    N = anchors.shape[0]
    loc = rng.standard_normal((2, N, 4)).astype(np.float32)
    cls = rng.standard_normal((2, N, 3)).astype(np.float32)
    jfn = jax.jit(jdet.multibox_loss(anchors, 2))
    tfn = tdet.multibox_loss(anchors, 2)
    losses = []
    for order in ([0, 1, 2, 3], [1, 0, 2, 3]):
        b, c = boxes[:, order], classes[:, order]
        want, wgrads = _loss_and_grads(jfn, loc, cls, b, c, "jax")
        got, tgrads = _loss_and_grads(tfn, loc, cls, b, c, "torch")
        np.testing.assert_allclose(got, want, rtol=1e-6)
        for g, w in zip(tgrads, wgrads):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9)
        losses.append(got)
        # the shared anchor takes the box of the higher index
        pos, tgt_cls, _ = tdet.match_targets(anchors, torch.from_numpy(b),
                                             torch.from_numpy(c))
        assert bool(pos[0, shared])
        assert int(tgt_cls[0, shared]) == int(c[0, 1]) + 1
    # which box the shared anchor keeps moves the loss
    assert losses[0] != losses[1]


def test_decode_detections_matches_jax():
    anchors = jdet.ssd_anchors(64, [8, 16, 32], [0.15, 0.35, 0.6])
    rng = np.random.default_rng(3)
    N = anchors.shape[0]
    loc = (0.2 * rng.standard_normal((2, N, 4))).astype(np.float32)
    cls = rng.standard_normal((2, N, 3)).astype(np.float32)
    cls[:, :, 0] += 1.5
    cls[0, 10:40, 1] += 6.0                  # overlapping detections
    got = tdet.decode_detections(loc, cls, anchors, score_thresh=0.4)
    want = jdet.decode_detections(loc, cls, anchors, score_thresh=0.4)
    assert len(got) == len(want) == 2 and len(got[0]["scores"]) > 1
    for g, w in zip(got, want):
        for k in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture()
def mesh8():
    init_orca_context("local", mesh_axes={"dp": 8})
    yield
    stop_orca_context()


def test_ssd_detector_sgd_fit_matches_jax(mesh8, monkeypatch):
    """Three SGD steps of ``SSDDetector`` (f32, width 8, 8 images of 64 x
    64, one step an epoch) from
    the same weights: the losses, every parameter and running
    statistic; ``predict`` and ``detect`` on the port."""
    monkeypatch.setattr(jdet, "SSD", functools.partial(jdet.SSD,
                                                       dtype=jnp.float32))
    monkeypatch.setattr(tdet, "SSD", functools.partial(tdet.SSD,
                                                       dtype=torch.float32))
    x, boxes, classes = _boxed_images(8, 64, seed=4)
    data = {"x": x, "boxes": boxes, "classes": classes}
    jd = jdet.SSDDetector(num_classes=2, image_size=64, backbone_width=8,
                          optimizer=optax.sgd(1e-3))
    v = _variables(jd.model, x[:1], seed=5)
    jd.estimator._initial_variables = v
    ref = jd.fit(data, epochs=3, batch_size=8)
    td = tdet.SSDDetector(num_classes=2, image_size=64, backbone_width=8,
                          optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-3),
                          device="cpu", config=TrainConfig())
    td.model.load_state_dict({**params_from_flax(v["params"]),
                              **batch_stats_from_flax(v["batch_stats"])})
    got = td.fit(data, epochs=3, batch_size=8)
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in ref], rtol=1e-5)
    st = jd.estimator.state
    want = {**params_from_flax(jax.device_get(st.params)),
            **batch_stats_from_flax(jax.device_get(st.batch_stats))}
    have = td.model.state_dict()
    assert set(want) == set(have)
    for name, w in want.items():
        np.testing.assert_allclose(have[name].numpy(), w.numpy(),
                                   atol=_scaled(w), rtol=0, err_msg=name)
    # predict gives the model's two outputs as a tuple of arrays
    tp = td.estimator.predict({"x": x}, batch_size=8)
    with torch.no_grad():
        want = td.model(torch.from_numpy(x))
    assert isinstance(tp, tuple) and len(tp) == 2
    for g, w in zip(tp, want):
        np.testing.assert_array_equal(g, w.numpy())
    dets = td.detect(x, batch_size=8, score_thresh=0.0, top_k=3)
    assert len(dets) == 8 and all(len(d["scores"]) <= 3 for d in dets)


def test_strided_pointwise_conv_on_cpu():
    """A stride-2 1x1 conv (a ResNet block's ``proj``) on the CPU runs as
    the subsampled input's 1x1 conv: the same values and gradients as the
    strided conv, and a backward over ``channels_last`` input with
    several threads that torch 2.13's oneDNN path crashed in."""
    from analytics_zoo_tpu_torch.models.layers import Conv2d, conv2d

    torch.manual_seed(0)
    layer = Conv2d(8, 16, 1, stride=2)
    with torch.no_grad():
        layer.bias.normal_()
    x = torch.randn(4, 8, 16, 16).to(memory_format=torch.channels_last)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, 8))
    try:
        xa = x.clone().requires_grad_()
        got = conv2d(layer, xa, torch.float32)
        got.square().sum().backward()
    finally:
        torch.set_num_threads(threads)
    ga = layer.weight.grad.clone()
    layer.weight.grad = None
    xb = x.contiguous().requires_grad_()
    want = torch.nn.functional.conv2d(xb, layer.weight, layer.bias,
                                      stride=2)
    want.square().sum().backward()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ga, layer.weight.grad, rtol=1e-5, atol=1e-5)
