"""The port's Keras layers (``analytics_zoo_tpu_torch.keras.layers``)
against the reference's (``analytics_zoo_tpu.keras.layers``) on the CPU.

Every name of the reference's ``__all__`` is built on both sides inside a
``Sequential``; the reference's variables (its tree, filled with seeded
normals, so no bias or scale is 0 or 1) are carried into the port with
``keras.engine.set_variables``, and the eval-mode forwards must agree at
f32 to 1e-5.  BatchNormalization is held in train mode too,
its updated statistics included.  The random layers are held to the
reference's train-mode statistics and eval-mode identity instead of
its masks (threefry's bits are not torch's).  Initializers are random
draws, so their distributions (fan modes, limits) are held instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu import keras as JK
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu_torch import keras as PK
from analytics_zoo_tpu_torch.keras import initializers as PI
from analytics_zoo_tpu_torch.keras.engine import (get_variables,
                                                  set_variables)


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
RANDOM = {"Dropout", "GaussianNoise", "GaussianDropout", "SpatialDropout1D",
          "SpatialDropout2D", "SpatialDropout3D"}


def _f(rng, *shape, positive=False):
    x = rng.normal(size=shape).astype(np.float32)
    return np.abs(x) + 0.1 if positive else x


def _ids(rng, *shape):
    return rng.integers(0, 10, shape).astype(np.int32)


# name -> (make(K) -> layer, inputs(rng) -> one array or a list)
CASES = {
    "Dense": (lambda K: K.Dense(5, activation="tanh"),
              lambda r: _f(r, 3, 4)),
    "Activation": (lambda K: K.Activation("gelu"), lambda r: _f(r, 3, 4)),
    "Dropout": (lambda K: K.Dropout(p=0.5), lambda r: _f(r, 3, 4)),
    "Flatten": (lambda K: K.Flatten(), lambda r: _f(r, 2, 3, 4, 2)),
    "Reshape": (lambda K: K.Reshape(target_shape=(4, 3)),
                lambda r: _f(r, 2, 3, 4)),
    "Permute": (lambda K: K.Permute(dims=(2, 1)), lambda r: _f(r, 2, 3, 4)),
    "RepeatVector": (lambda K: K.RepeatVector(n=5), lambda r: _f(r, 2, 3)),
    "Merge": (lambda K: K.Merge(mode="cos"),
              lambda r: [_f(r, 3, 4), _f(r, 3, 4)]),
    "Highway": (lambda K: K.Highway(), lambda r: _f(r, 3, 4)),
    "MaxoutDense": (lambda K: K.MaxoutDense(output_dim=6, nb_feature=3),
                    lambda r: _f(r, 3, 4)),
    "Masking": (lambda K: K.Masking(mask_value=0.0),
                lambda r: _f(r, 2, 4, 3) * (r.random((2, 4, 1)) > 0.4)),
    "Lambda": (lambda K: K.Lambda(function=lambda x: x * 2.0 + 1.0),
               lambda r: _f(r, 3, 4)),
    "LeakyReLU": (lambda K: K.LeakyReLU(), lambda r: _f(r, 3, 4)),
    "ELU": (lambda K: K.ELU(alpha=0.7), lambda r: _f(r, 3, 4)),
    "PReLU": (lambda K: K.PReLU(), lambda r: _f(r, 2, 3, 4)),
    "ThresholdedReLU": (lambda K: K.ThresholdedReLU(theta=0.5),
                        lambda r: _f(r, 3, 4)),
    "GaussianNoise": (lambda K: K.GaussianNoise(sigma=0.3),
                      lambda r: _f(r, 3, 4)),
    "GaussianDropout": (lambda K: K.GaussianDropout(p=0.3),
                        lambda r: _f(r, 3, 4)),
    "SpatialDropout1D": (lambda K: K.SpatialDropout1D(p=0.5),
                         lambda r: _f(r, 2, 5, 4)),
    "SpatialDropout2D": (lambda K: K.SpatialDropout2D(p=0.5),
                         lambda r: _f(r, 2, 3, 3, 4)),
    "SpatialDropout3D": (lambda K: K.SpatialDropout3D(p=0.5),
                         lambda r: _f(r, 2, 2, 3, 3, 4)),
    "Embedding": (lambda K: K.Embedding(input_dim=10, output_dim=4),
                  lambda r: _ids(r, 3, 5)),
    "BatchNormalization": (lambda K: K.BatchNormalization(),
                           lambda r: _f(r, 4, 3, 3, 5)),
    "LayerNormalization": (lambda K: K.LayerNormalization(),
                           lambda r: _f(r, 3, 6) * 3 + 1),
    "Convolution1D": (lambda K: K.Convolution1D(4, 3, border_mode="same",
                                                subsample_length=2,
                                                activation="relu"),
                      lambda r: _f(r, 2, 8, 3)),
    "Convolution2D": (lambda K: K.Convolution2D(4, 3, 3, border_mode="same",
                                                subsample=(2, 2)),
                      lambda r: _f(r, 2, 7, 8, 3)),
    "Convolution3D": (lambda K: K.Convolution3D(2, 2, 2, 2,
                                                border_mode="same"),
                      lambda r: _f(r, 1, 3, 4, 4, 2)),
    "AtrousConvolution1D": (lambda K: K.AtrousConvolution1D(
        4, 3, atrous_rate=2, border_mode="same"), lambda r: _f(r, 2, 9, 3)),
    "AtrousConvolution2D": (lambda K: K.AtrousConvolution2D(
        3, 3, 3, atrous_rate=(2, 2)), lambda r: _f(r, 2, 7, 7, 2)),
    "SeparableConvolution2D": (lambda K: K.SeparableConvolution2D(
        4, 3, 3, border_mode="same", subsample=(2, 2), depth_multiplier=2),
        lambda r: _f(r, 2, 6, 7, 3)),
    "Deconvolution2D": (lambda K: K.Deconvolution2D(
        2, 3, 3, border_mode="same", subsample=(2, 2)),
        lambda r: _f(r, 2, 4, 5, 3)),
    "Cropping1D": (lambda K: K.Cropping1D(cropping=(1, 2)),
                   lambda r: _f(r, 2, 6, 3)),
    "Cropping2D": (lambda K: K.Cropping2D(cropping=((1, 1), (0, 2))),
                   lambda r: _f(r, 2, 5, 5, 2)),
    "Cropping3D": (lambda K: K.Cropping3D(), lambda r: _f(r, 1, 4, 4, 4, 2)),
    "UpSampling1D": (lambda K: K.UpSampling1D(length=3),
                     lambda r: _f(r, 2, 3, 4)),
    "UpSampling2D": (lambda K: K.UpSampling2D(size=(2, 3)),
                     lambda r: _f(r, 2, 3, 3, 2)),
    "UpSampling3D": (lambda K: K.UpSampling3D(size=(1, 2, 2)),
                     lambda r: _f(r, 1, 2, 2, 2, 2)),
    "ZeroPadding1D": (lambda K: K.ZeroPadding1D(padding=(1, 2)),
                      lambda r: _f(r, 2, 3, 4)),
    "ZeroPadding2D": (lambda K: K.ZeroPadding2D(padding=(1, 2)),
                      lambda r: _f(r, 2, 3, 3, 2)),
    "ZeroPadding3D": (lambda K: K.ZeroPadding3D(padding=(1, 0, 2)),
                      lambda r: _f(r, 1, 2, 2, 2, 2)),
    "LocallyConnected1D": (lambda K: K.LocallyConnected1D(
        nb_filter=3, filter_length=2), lambda r: _f(r, 2, 5, 4)),
    "LocallyConnected2D": (lambda K: K.LocallyConnected2D(
        nb_filter=3, nb_row=2, nb_col=2, subsample=(2, 2)),
        lambda r: _f(r, 2, 5, 5, 2)),
    "MaxPooling1D": (lambda K: K.MaxPooling1D(pool_length=3, stride=2,
                                              border_mode="same"),
                     lambda r: _f(r, 2, 8, 3)),
    "MaxPooling2D": (lambda K: K.MaxPooling2D(pool_size=3, strides=2,
                                              border_mode="same"),
                     lambda r: _f(r, 2, 7, 8, 3)),
    "MaxPooling3D": (lambda K: K.MaxPooling3D(pool_size=2),
                     lambda r: _f(r, 1, 4, 4, 4, 2)),
    "AveragePooling1D": (lambda K: K.AveragePooling1D(
        pool_length=3, stride=2, border_mode="same"),
        lambda r: _f(r, 2, 8, 3)),
    "AveragePooling2D": (lambda K: K.AveragePooling2D(
        pool_size=(3, 2), strides=(2, 2), border_mode="same"),
        lambda r: _f(r, 2, 7, 7, 3)),
    "AveragePooling3D": (lambda K: K.AveragePooling3D(
        pool_size=2, border_mode="same"), lambda r: _f(r, 1, 3, 4, 5, 2)),
    "GlobalMaxPooling1D": (lambda K: K.GlobalMaxPooling1D(),
                           lambda r: _f(r, 2, 5, 4)),
    "GlobalMaxPooling2D": (lambda K: K.GlobalMaxPooling2D(),
                           lambda r: _f(r, 2, 3, 4, 3)),
    "GlobalMaxPooling3D": (lambda K: K.GlobalMaxPooling3D(),
                           lambda r: _f(r, 2, 2, 3, 4, 3)),
    "GlobalAveragePooling1D": (lambda K: K.GlobalAveragePooling1D(),
                               lambda r: _f(r, 2, 5, 4)),
    "GlobalAveragePooling2D": (lambda K: K.GlobalAveragePooling2D(),
                               lambda r: _f(r, 2, 3, 4, 3)),
    "GlobalAveragePooling3D": (lambda K: K.GlobalAveragePooling3D(),
                               lambda r: _f(r, 2, 2, 3, 4, 3)),
    "SimpleRNN": (lambda K: K.SimpleRNN(5, activation="relu",
                                        return_sequences=True),
                  lambda r: _f(r, 2, 6, 3)),
    "LSTM": (lambda K: K.LSTM(5, inner_activation="hard_sigmoid",
                              go_backwards=True),
             lambda r: _f(r, 2, 6, 3)),
    "GRU": (lambda K: K.GRU(4, return_sequences=True, go_backwards=True),
            lambda r: _f(r, 2, 6, 3)),
    "ConvLSTM2D": (lambda K: K.ConvLSTM2D(nb_filter=3, return_sequences=True),
                   lambda r: _f(r, 2, 3, 5, 4, 2)),
    "Bidirectional": (lambda K: K.Bidirectional(
        layer=K.LSTM(4, return_sequences=True), merge_mode="concat"),
        lambda r: _f(r, 2, 5, 3)),
    "TimeDistributed": (lambda K: K.TimeDistributed(layer=K.Dense(3)),
                        lambda r: _f(r, 2, 5, 4)),
    "Conv1D": (lambda K: K.Conv1D(4, 2, strides=2, padding="same"),
               lambda r: _f(r, 2, 7, 3)),
    "Conv2D": (lambda K: K.Conv2D(3, (2, 3), strides=(1, 2),
                                  padding="same", dilation_rate=(2, 1)),
               lambda r: _f(r, 2, 6, 7, 2)),
    "Conv3D": (lambda K: K.Conv3D(2, 2, strides=(1, 2, 1)),
               lambda r: _f(r, 1, 3, 4, 3, 2)),
    "Conv2DTranspose": (lambda K: K.Conv2DTranspose(2, (2, 3),
                                                    strides=(3, 2)),
                        lambda r: _f(r, 2, 3, 4, 3)),
    "SeparableConv2D": (lambda K: K.SeparableConv2D(4, 3, padding="valid"),
                        lambda r: _f(r, 2, 5, 5, 2)),
    "MaxPool1D": (lambda K: K.MaxPool1D(pool_size=2),
                  lambda r: _f(r, 2, 7, 3)),
    "MaxPool2D": (lambda K: K.MaxPool2D(pool_size=(2, 3), strides=(1, 2)),
                  lambda r: _f(r, 2, 5, 7, 3)),
    "MaxPool3D": (lambda K: K.MaxPool3D(pool_size=2, border_mode="same"),
                  lambda r: _f(r, 1, 3, 3, 4, 2)),
    "AvgPool1D": (lambda K: K.AvgPool1D(pool_size=3, strides=1),
                  lambda r: _f(r, 2, 7, 3)),
    "AvgPool2D": (lambda K: K.AvgPool2D(pool_size=2),
                  lambda r: _f(r, 2, 6, 7, 3)),
    "AvgPool3D": (lambda K: K.AvgPool3D(pool_size=(1, 2, 2)),
                  lambda r: _f(r, 1, 2, 4, 4, 2)),
    "Select": (lambda K: K.Select(dim=1, index=2), lambda r: _f(r, 2, 3, 4)),
    "Narrow": (lambda K: K.Narrow(dim=2, offset=1, length=2),
               lambda r: _f(r, 2, 3, 4)),
    "Squeeze": (lambda K: K.Squeeze(), lambda r: _f(r, 2, 1, 4, 1)),
    "ExpandDim": (lambda K: K.ExpandDim(dim=-1), lambda r: _f(r, 2, 3)),
    "Exp": (lambda K: K.Exp(), lambda r: _f(r, 2, 3)),
    "Log": (lambda K: K.Log(), lambda r: _f(r, 2, 3, positive=True)),
    "Sqrt": (lambda K: K.Sqrt(), lambda r: _f(r, 2, 3, positive=True)),
    "Square": (lambda K: K.Square(), lambda r: _f(r, 2, 3)),
    "Abs": (lambda K: K.Abs(), lambda r: _f(r, 2, 3)),
    "Negative": (lambda K: K.Negative(), lambda r: _f(r, 2, 3)),
    "Power": (lambda K: K.Power(power=2.5, scale=0.5, shift=3.0),
              lambda r: _f(r, 2, 3)),
    "CAdd": (lambda K: K.CAdd(size=(3, 4)), lambda r: _f(r, 2, 3, 4)),
    "CMul": (lambda K: K.CMul(size=(4,)), lambda r: _f(r, 2, 3, 4)),
    "Scale": (lambda K: K.Scale(size=(1, 4)), lambda r: _f(r, 2, 3, 4)),
    "SReLU": (lambda K: K.SReLU(), lambda r: _f(r, 2, 3, 4) * 2),
    "LRN2D": (lambda K: K.LRN2D(alpha=1e-2, n=3),
              lambda r: _f(r, 2, 3, 3, 6) * 3),
    "ResizeBilinear": (lambda K: K.ResizeBilinear(5, 7),
                       lambda r: _f(r, 2, 9, 4, 3)),
}


def _seeded(jm, x, rng):
    """The reference model's variables: its tree from ``jax.eval_shape``
    (no initializer compiles), filled with seeded normals (so no bias or
    scale is 0 or 1; variances uniform in [0.5, 1.5])."""
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        _jx(x), train=False))

    def fill(path, leaf):
        if path[0].key == "batch_stats" and path[-1].key == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.5 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _pair(name, seed=0):
    """(reference model, its variables, port model built and loaded, the
    inputs as numpy)."""
    make, inputs = CASES[name]
    rng = np.random.default_rng(seed)
    x = inputs(rng)
    jm = JK.Sequential().add(make(JL))
    pm = PK.Sequential().add(make(PK.layers))
    v = _seeded(jm, x, rng)
    pm.build_on(_tx(x))
    set_variables(pm, v)
    return jm, v, pm, x


def _jx(x):
    return [jnp.asarray(a) for a in x] if isinstance(x, list) \
        else jnp.asarray(x)


def _tx(x):
    return [torch.as_tensor(a) for a in x] if isinstance(x, list) \
        else torch.as_tensor(x)


def test_every_reference_name_has_a_case():
    assert sorted(CASES) == sorted(JL.__all__)
    assert sorted(PK.layers.__all__) == sorted(JL.__all__)


@pytest.mark.parametrize("name", JL.__all__)
def test_layer_matches_reference(name):
    jm, v, pm, x = _pair(name)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, _jx(x)))
    got = pm(_tx(x), train=False).detach().numpy()
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)
    if name in RANDOM:
        return
    # the variables go back out unchanged
    back = get_variables(pm)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(v)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(pa))


def test_batchnorm_train_mode_and_statistics():
    jm, v, pm, x = _pair("BatchNormalization", seed=3)
    want, upd = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    got = pm(torch.as_tensor(x), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    stats = get_variables(pm)["batch_stats"]["layers_0"]["BatchNorm_0"]
    ref = upd["batch_stats"]["layers_0"]["BatchNorm_0"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], np.asarray(ref[k]), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_layer_statistics(name):
    """Train mode: the reference's statistics (share dropped, the noise's
    scale, whole channels dropped for the spatial kinds), with both
    packages' draws on one large input; eval mode is the identity."""
    make, _ = CASES[name]
    shape = {"SpatialDropout1D": (8, 64, 64), "SpatialDropout2D":
             (8, 4, 4, 256), "SpatialDropout3D": (8, 2, 2, 2, 256)}.get(
                 name, (256, 256))
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    x = np.where(np.abs(x) < 0.05, 0.5, x).astype(np.float32)
    jm, pm = JK.Sequential().add(make(JL)), PK.Sequential().add(
        make(PK.layers))
    v = {}                      # no parameters
    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=True,
                              rngs={"dropout": jax.random.key(7)}))
    got = pm(torch.as_tensor(x), train=True, rng=11).numpy()
    np.testing.assert_array_equal(pm(torch.as_tensor(x), train=False).numpy(),
                                  x)
    np.testing.assert_array_equal(
        np.asarray(jm.apply(v, jnp.asarray(x), train=False)), x)

    def stats(y):
        if name == "GaussianNoise":
            return [np.mean(y - x), np.std(y - x)]
        if name == "GaussianDropout":
            return [np.mean(y / x - 1), np.std(y / x - 1)]
        dropped = y == 0
        if name.startswith("SpatialDropout"):
            # one draw a channel: every position agrees
            per = dropped.reshape(shape[0], -1, shape[-1])
            assert (per == per[:, :1]).all()
        kept = ~dropped
        return [dropped.mean(), np.mean(y[kept] / x[kept])]

    np.testing.assert_allclose(stats(got), stats(ref), atol=0.03)


@pytest.mark.parametrize("init", ["glorot_uniform", "glorot_normal",
                                  "he_uniform", "he_normal", "lecun_uniform",
                                  "lecun_normal", "uniform", "normal",
                                  "orthogonal"])
def test_initializer_distributions(init):
    """A Dense kernel [64, 128] and a conv kernel [3, 3, 16, 32] drawn by
    both packages: the same spread and mean, and for the bounded kinds
    the same limit (the uniform kinds' largest magnitude, the truncated
    normals' cut)."""
    from jax.nn import initializers as ji

    from analytics_zoo_tpu.keras.initializers import get_initializer

    torch.manual_seed(0)
    for shape in ((64, 128), (3, 3, 16, 32)):
        if init == "orthogonal" and len(shape) > 2:
            continue
        ref = np.asarray(get_initializer(init)(jax.random.key(0), shape))
        got = PI.get_initializer(init)(shape).numpy()
        assert got.shape == shape
        np.testing.assert_allclose(got.std(), ref.std(), rtol=0.05)
        np.testing.assert_allclose(got.mean(), ref.mean(),
                                   atol=0.05 * ref.std() + 1e-3)
        if init not in ("normal", "orthogonal"):    # bounded draws
            np.testing.assert_allclose(np.abs(got).max(),
                                       np.abs(ref).max(), rtol=0.08)
        if init == "orthogonal":
            np.testing.assert_allclose(got @ got.T, np.eye(64), atol=1e-5)
    del ji


def test_pooling_windows_and_errors():
    """``pool_length``/``stride`` win over ``pool_size``/``strides``;
    ``dim_ordering`` other than channels-last and ``align_corners``
    raise, as in the reference."""
    p = PK.layers.MaxPooling1D(pool_size=5, pool_length=2, stride=1)
    assert p.window == (2,) and p.strides == (1,)
    with pytest.raises(ValueError, match="channels-last"):
        PK.layers.Convolution2D(2, 3, 3, dim_ordering="th")
    with pytest.raises(ValueError, match="align_corners"):
        PK.layers.ResizeBilinear(2, 2, align_corners=True)(
            torch.zeros(1, 4, 4, 1))

    with pytest.raises(ValueError, match="out of range"):
        PK.layers.Select(dim=1, index=5)(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="batch axis"):
        PK.layers.Squeeze(dim=0)(torch.zeros(1, 3))
    with pytest.raises(ValueError, match="needs rng"):
        PK.layers.Dropout(0.5)(torch.zeros(2, 3), train=True)
