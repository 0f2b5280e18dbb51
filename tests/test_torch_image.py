"""The port's image models (``models/image.py``) and the Estimator's
BatchNorm state and gradient accumulation, against the JAX package.

Weights and running statistics are the reference's init moved off it by
seeded noise (so BatchNorm scales, biases, means and variances are not
1/0/0/1); ``params_from_flax`` and ``batch_stats_from_flax`` carry them
over.  Every input size is even, so flax's asymmetric SAME padding of
the stride-2 convs (one more row and column at the end) shows if the
port pads otherwise.  f32 throughout.

Tolerance: 1e-5 of the compared tensor's largest magnitude (at least 1):
outputs, updated running statistics, Estimator parameters and
statistics after SGD, Adam losses.  One case is held otherwise: a
ResNet-50's train-mode forward at a test's width (2) is ill-conditioned
in f32 in both packages (the reference's own logits lie ~1e-4 of their
scale from a float64 evaluation, through the batch statistics of
channels that barely vary across 4 images), so there the port's
distance from the float64 evaluation of the same net must be no more
than twice the reference's; its eval forward is held to 1e-5.  The JAX
Estimator runs on the 8-device CPU mesh, where BatchNorm's statistics
are the whole batch's, as on one device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu import init_orca_context, stop_orca_context
from analytics_zoo_tpu.common.config import TrainConfig as JaxConfig
from analytics_zoo_tpu.learn import Estimator as JaxEstimator
from analytics_zoo_tpu.models import image as ji
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.models import ImageClassifier
from analytics_zoo_tpu_torch.models import image as ti
from analytics_zoo_tpu_torch.models.layers import (batch_stats_from_flax,
                                                   params_from_flax,
                                                   same_pads)

_ATOL = 1e-5
_F32 = dict(dtype=jnp.float32), dict(dtype=torch.float32)


def _noisy(tree, seed, positive=False):
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a, np.float32)
        noise = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return np.abs(a + noise) + 0.1 if positive else a + noise
    return jax.tree_util.tree_map(one, jax.device_get(tree))


def _variables(jm, x, seed=0):
    """(params, batch_stats) of the reference module, both off init."""
    v = jm.init(jax.random.key(seed), x)
    params = _noisy(v["params"], seed + 1)
    if "batch_stats" not in v:
        return params, None
    bs = jax.tree_util.tree_map_with_path(
        lambda path, a: _noisy(a, seed + 2 + len(path),
                               positive=path[-1].key == "var"),
        jax.device_get(v["batch_stats"]))
    return params, bs


def _port(tm, params, bs):
    state = params_from_flax(params)
    if bs is not None:
        state.update(batch_stats_from_flax(bs))
    tm.load_state_dict(state)
    return tm


def _images(n, hw, c=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, hw, hw, c)).astype(np.float32)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want):
    want = _np(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=0,
        atol=_ATOL * max(1.0, float(np.abs(want).max(initial=0))))


def _as_f64(tm):
    """The same port module computing in float64."""
    tm = tm.double()
    for m in tm.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return tm


def _as_accurate(got, want, exact):
    """``got`` no further from the float64 ``exact`` than twice
    ``want`` is (or within the 1e-5 tolerance of it)."""
    exact = _np(exact)
    err, ref_err = (float(np.abs(_np(a) - exact).max()) for a in (got, want))
    scale = max(1.0, float(np.abs(exact).max()))
    assert err <= max(2 * ref_err, _ATOL * scale), (err, ref_err)


def _buffers(tm):
    return {k: v.clone() for k, v in tm.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


# (name, reference module, port module, image size, ill-conditioned in
# train mode)
_NETS = [
    ("resnet18_small", lambda j: j.resnet18(5, small_inputs=True, width=4,
                                           **_F32[0]),
     lambda t: t.resnet18(5, small_inputs=True, width=4, **_F32[1]), 16,
     False),
    ("basic_imagenet_stem", lambda j: j.ResNet(
        5, stage_sizes=(1, 1, 1), width=4, **_F32[0]),
     lambda t: t.ResNet(5, stage_sizes=(1, 1, 1), width=4, **_F32[1]), 28,
     False),
    ("bottleneck_small", lambda j: j.ResNet(
        5, stage_sizes=(1, 2), width=4, small_inputs=True, bottleneck=True,
        **_F32[0]),
     lambda t: t.ResNet(5, stage_sizes=(1, 2), width=4, small_inputs=True,
                        bottleneck=True, **_F32[1]), 10, False),
    ("resnet50", lambda j: j.resnet50(5, width=2, **_F32[0]),
     lambda t: t.resnet50(5, width=2, **_F32[1]), 32, True),
]


@pytest.mark.parametrize("name,jmake,tmake,hw,deep", _NETS,
                         ids=[n[0] for n in _NETS])
def test_resnet_matches_jax(name, jmake, tmake, hw, deep):
    """Train-mode logits and the running statistics they update, then
    eval-mode logits on the running statistics, with the port's buffers
    unchanged by the eval forward."""
    x = _images(4, hw)
    jm = jmake(ji)
    params, bs = _variables(jm, x)
    tm = _port(tmake(ti), params, bs)
    want, mut = jm.apply({"params": params, "batch_stats": bs}, x,
                         train=True, mutable=["batch_stats"])
    got = tm(torch.as_tensor(x), train=True)
    new = batch_stats_from_flax(jax.device_get(mut["batch_stats"]))
    after = _buffers(tm)
    assert set(new) == set(after)
    if deep:
        exact = _as_f64(_port(tmake(ti), params, bs))
        _as_accurate(got, want, exact(torch.as_tensor(x).double(),
                                      train=True))
        for k in new:
            _as_accurate(after[k], new[k], exact.state_dict()[k])
    else:
        _close(got, want)
        for k in new:
            _close(after[k], new[k])
    want = jm.apply({"params": params, "batch_stats": mut["batch_stats"]},
                    x, train=False)
    with torch.no_grad():
        got = tm(torch.as_tensor(x))
    _close(got, want)
    assert all(torch.equal(v, _buffers(tm)[k]) for k, v in after.items())


def test_same_pads_are_flax_s():
    """flax pads a stride-2 conv of an even size one more at the end."""
    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(56, 3, 2) == (0, 1)
    assert same_pads(112, 3, 2) == (0, 1)       # the stem's max pool
    assert same_pads(57, 3, 2) == (1, 1)
    assert same_pads(8, 3, 1) == (1, 1)
    assert same_pads(56, 1, 2) == (0, 0)


def test_return_features_match_jax():
    x = _images(2, 16)
    jm = ji.ResNet(5, stage_sizes=(1, 1, 1), width=4, return_features=True,
                   **_F32[0])
    params, bs = _variables(jm, x, seed=4)
    tm = _port(ti.ResNet(5, stage_sizes=(1, 1, 1), width=4,
                         return_features=True, **_F32[1]), params, bs)
    want = jm.apply({"params": params, "batch_stats": bs}, x)
    with torch.no_grad():
        got = tm(torch.as_tensor(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape        # NHWC, as the reference
        _close(g, w)


def test_simple_cnn_and_classifier_match_jax():
    """SimpleCNN (biased convs, VALID pools, an NHWC flatten into its
    first Dense) in eval mode, and each ImageClassifier backbone."""
    x = _images(3, 12, c=1, seed=2)
    jm = ji.SimpleCNN(4, **_F32[0])
    params, _ = _variables(jm, x, seed=6)
    tm = _port(ti.SimpleCNN(4, **_F32[1]), params, None)
    with torch.no_grad():
        got = tm(torch.as_tensor(x))
    _close(got, jm.apply({"params": params}, x))
    train = tm(torch.as_tensor(x), train=True, rng=5)
    assert train.shape == (3, 4) and torch.isfinite(train).all()
    with pytest.raises(ValueError, match="rng"):
        tm(torch.as_tensor(x), train=True)
    for backbone, cls, kw in (("simple", ti.SimpleCNN, {}),
                              ("resnet18", ti.ResNet, {"width": 2}),
                              ("resnet34", ti.ResNet, {"width": 2}),
                              ("resnet50", ti.ResNet, {"width": 2})):
        assert isinstance(ImageClassifier(3, backbone, **kw), cls)
    assert ImageClassifier(3, "resnet34", width=2).stage_sizes == \
        (3, 4, 6, 3)
    with pytest.raises(ValueError, match="unknown backbone"):
        ImageClassifier(3, "vgg")
    with pytest.raises(ValueError, match="unknown backbone"):
        ji.ImageClassifier(3, "vgg")


# ---------------------------------------------------------------------------
# the Estimator: BatchNorm state, accumulation, checkpoints
# ---------------------------------------------------------------------------

_SMALL = dict(stage_sizes=(1, 1), width=4, small_inputs=True)


@pytest.fixture(scope="module")
def small():
    x = _images(24, 8, seed=7)
    y = np.random.default_rng(8).integers(0, 5, 24).astype(np.int32)
    jm = ji.ResNet(5, **_SMALL, **_F32[0])
    params, bs = _variables(jm, x[:2], seed=9)
    return jm, params, bs, {"x": x, "y": y}


@pytest.fixture()
def mesh8():
    init_orca_context("local", mesh_axes={"dp": 8})
    yield
    stop_orca_context()


def _jax_est(small, opt, accum=1):
    jm, params, bs, _ = small
    return JaxEstimator.from_flax(
        model=jm, loss="sparse_categorical_crossentropy", optimizer=opt,
        feature_cols=("x",), label_cols=("y",),
        initial_variables={"params": params, "batch_stats": bs},
        config=JaxConfig(deterministic=True, accum_steps=accum))


def _port_est(small, opt, accum=1, **kw):
    _, params, bs, _ = small
    tm = _port(ti.ResNet(5, **_SMALL, **_F32[1]), params, bs)
    return Estimator.from_torch(
        model=tm, loss="sparse_categorical_crossentropy", optimizer=opt,
        feature_cols=("x",), label_cols=("y",),
        config=TrainConfig(deterministic=True, accum_steps=accum, **kw),
        device="cpu")


def _jax_state(est):
    state = params_from_flax(jax.device_get(est.state.params))
    state.update(batch_stats_from_flax(jax.device_get(
        est.state.batch_stats)))
    return state


@pytest.mark.parametrize("accum", [1, 2])
def test_sgd_params_and_running_stats_match_jax(small, mesh8, accum):
    """Three SGD steps (batch 8; with ``accum_steps=2`` as two
    micro-batches of 4 whose statistics thread in order): every
    parameter and running statistic, and the losses."""
    data = small[3]
    ref = _jax_est(small, optax.sgd(0.1), accum)
    want = ref.fit(data, epochs=1, batch_size=8)
    est = _port_est(small, lambda ps: torch.optim.SGD(ps, lr=0.1), accum)
    got = est.fit(data, epochs=1, batch_size=8)
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-5)
    jstate, tstate = _jax_state(ref), est.model.state_dict()
    assert set(jstate) == set(tstate)
    for k in jstate:
        _close(tstate[k], jstate[k])


def test_adam_losses_match_jax(small, mesh8):
    data = small[3]
    want = _jax_est(small, 3e-3).fit(data, epochs=2, batch_size=8)
    got = _port_est(small, 3e-3).fit(data, epochs=2, batch_size=8)
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-5)


def test_accum_must_divide_batch(small):
    est = _port_est(small, 0.1, accum=3)
    with pytest.raises(ValueError, match="not divisible"):
        est.fit(small[3], epochs=1, batch_size=8)


def test_eval_and_predict_keep_stats_and_checkpoints_carry_them(
        small, tmp_path):
    """evaluate and predict leave every buffer bit for bit; a fit moves
    them; save_checkpoint/load_checkpoint and save/load restore them."""
    data = small[3]
    est = _port_est(small, 0.05, checkpoint_dir=str(tmp_path / "ck"))
    before = _buffers(est.model)
    est.evaluate(data, batch_size=6)
    est.predict({"x": data["x"]}, batch_size=5)
    assert all(torch.equal(v, _buffers(est.model)[k])
               for k, v in before.items())
    est.fit(data, epochs=1, batch_size=8)       # checkpoints at the end
    trained = _buffers(est.model)
    assert not all(torch.equal(v, trained[k]) for k, v in before.items())
    est.save(str(tmp_path / "export"))
    preds = est.predict({"x": data["x"]}, batch_size=8)
    for restore in ("checkpoint", "export"):
        fresh = _port_est(small, 0.05)
        assert not all(torch.equal(v, _buffers(fresh.model)[k])
                       for k, v in trained.items())
        if restore == "checkpoint":
            fresh.load_checkpoint(str(tmp_path / "ck"))
        else:
            fresh.load(str(tmp_path / "export"))
        assert all(torch.equal(v, _buffers(fresh.model)[k])
                   for k, v in trained.items()), restore
        np.testing.assert_array_equal(
            fresh.predict({"x": data["x"]}, batch_size=8), preds)
