"""The port's ``tfpark``: ``GANEstimator`` and its losses
(``tfpark/gan.py``), ``TFDataset`` (``tfpark/tf_dataset.py``) and the
namespace, against the JAX package; and the Estimator's batch
resolution from a ``TFDataset``'s metadata.

A GAN step is held to the reference's step math written out here with
flax modules and ``optax.adam(2e-4, b1=0.5)`` on the same weights and
the same noise (the port draws its own noise from seeded generators,
not threefry, so the noise is given to both).  Tolerances: losses
within 1e-6 relative (1e-7 absolute where a mean cancels), gradients 1e-5 relative, the parameters after a
step within 1e-6 (an Adam step moves each by about its rate, 2e-4;
where a gradient is near 0, within that rate, see the test).
"""

import functools

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

import analytics_zoo_tpu.tfpark.gan as jgan
from analytics_zoo_tpu.data.feature_set import FeatureSet as JaxFeatureSet
from analytics_zoo_tpu.data.image import ImageSet as JaxImageSet
from analytics_zoo_tpu.data.shards import XShards as JaxXShards
from analytics_zoo_tpu.data.text import TextSet as JaxTextSet
from analytics_zoo_tpu.learn.estimator import \
    _resolve_batch as jax_resolve_batch
from analytics_zoo_tpu.tfpark import TFDataset as JaxTFDataset
from analytics_zoo_tpu_torch import keras as tkeras
from analytics_zoo_tpu_torch import tfpark
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.data.feature_set import (DiskFeatureSet,
                                                      FeatureSet)
from analytics_zoo_tpu_torch.data.image import ImageSet
from analytics_zoo_tpu_torch.data.shards import XShards
from analytics_zoo_tpu_torch.data.text import TextSet
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn.estimator import _resolve_batch
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.layers import Dense, params_from_flax
from analytics_zoo_tpu_torch.parallel.mesh import Mesh
from analytics_zoo_tpu_torch.tfpark import GANEstimator, TFDataset
from analytics_zoo_tpu_torch.tfpark import gan as tgan


class JGen(fnn.Module):
    @fnn.compact
    def __call__(self, z):
        h = fnn.tanh(fnn.Dense(16)(z))
        return fnn.Dense(2)(h)


class JDisc(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = fnn.tanh(fnn.Dense(16)(x))
        return fnn.Dense(1)(h)[..., 0]


class Gen(nn.Module):
    def __init__(self, noise_dim):
        super().__init__()
        self.Dense_0, self.Dense_1 = Dense(noise_dim, 16), Dense(16, 2)

    def forward(self, z):
        return self.Dense_1(torch.tanh(self.Dense_0(z)))


class Disc(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0, self.Dense_1 = Dense(2, 16), Dense(16, 1)

    def forward(self, x):
        return self.Dense_1(torch.tanh(self.Dense_0(x)))[..., 0]


_NAMES = ["minimax", "lsgan", "wasserstein"]


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    real = rng.standard_normal(9).astype(np.float32) * 3
    fake = rng.standard_normal(9).astype(np.float32) * 3
    for name in _NAMES:
        td, tg = tgan._LOSSES[name]
        jd, jg = jgan._LOSSES[name]
        np.testing.assert_allclose(
            float(td(torch.from_numpy(real), torch.from_numpy(fake))),
            float(jax.jit(jd)(real, fake)), rtol=1e-6)
        np.testing.assert_allclose(float(tg(torch.from_numpy(fake))),
                                   float(jax.jit(jg)(fake)), rtol=1e-6)


_TX = optax.adam(2e-4, b1=0.5)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _reference_d(gp, dp, real, noises, d_steps, loss):
    """The reference's ``GANEstimator`` step (``tfpark/gan.py``), its
    discriminator half on given noise: ``d_steps`` updates with the
    generator's samples detached.  Returns the updated parameters, the
    last loss and the last gradients."""
    gen, disc = JGen(), JDisc()
    d_loss_fn = jgan._LOSSES[loss][0]
    d_opt = _TX.init(dp)
    for i in range(d_steps):
        fake = jax.lax.stop_gradient(gen.apply({"params": gp}, noises[i]))

        def dl(p):
            return d_loss_fn(disc.apply({"params": p}, real),
                             disc.apply({"params": p}, fake))
        d_loss, gd = jax.value_and_grad(dl)(dp)
        upd, d_opt = _TX.update(gd, d_opt, dp)
        dp = optax.apply_updates(dp, upd)
    return dp, d_loss, gd


@functools.partial(jax.jit, static_argnums=(3,))
def _reference_g(gp, dp, noise, loss):
    """Its generator half: one update against the discriminator ``dp``."""
    gen, disc = JGen(), JDisc()
    g_loss_fn = jgan._LOSSES[loss][1]

    def gl(p):
        return g_loss_fn(disc.apply({"params": dp},
                                    gen.apply({"params": p}, noise)))
    g_loss, gg = jax.value_and_grad(gl)(gp)
    upd, _ = _TX.update(gg, _TX.init(gp), gp)
    return optax.apply_updates(gp, upd), g_loss, gg


def _flax_tree(mlp):
    """A ``Dense_0``/``Dense_1`` module's parameters as a flax tree."""
    return {n: {"kernel": getattr(mlp, n).weight.detach().numpy().T,
                "bias": getattr(mlp, n).bias.detach().numpy()}
            for n in ("Dense_0", "Dense_1")}


def _hold_update(model, want, grads):
    """The gradients left in ``.grad`` and the updated parameters.
    Adam's update is lr * m / (sqrt(v) + eps): a gradient that is
    rounding noise near 0 (a tanh unit the loss barely reaches) moves its
    parameter by a share of the rate that the noise decides, so there a
    parameter is held to the rate (2e-4), elsewhere to 1e-6."""
    have = model.state_dict()
    want, grads = params_from_flax(want), params_from_flax(grads)
    for name, p in model.named_parameters():
        g = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, atol=1e-7, rtol=1e-5,
                                   err_msg=name)
        tol = np.where(np.abs(g) > 1e-4, 1e-6, 2e-4)
        assert (np.abs(have[name].detach().numpy() - want[name].numpy())
                <= tol).all(), name


@pytest.mark.parametrize("loss", ["minimax", "wasserstein"])
@pytest.mark.parametrize("d_steps", [1, 3])
def test_gan_step_matches_reference_math(d_steps, loss):
    """One step: the discriminator half against the reference's from the
    same start; the generator half against the reference's against the
    discriminator the port's updates left (so the discriminator's
    tolerance does not pass into it)."""
    noise_dim, B = 4, 8
    rng = np.random.default_rng(d_steps)
    real = (rng.standard_normal((B, 2)) * 0.05 + [2.0, -1.0]).astype(
        np.float32)
    noises = [rng.standard_normal((B, noise_dim)).astype(np.float32)
              for _ in range(d_steps + 1)]
    gp = JGen().init(jax.random.key(1), noises[0])["params"]
    dp = JDisc().init(jax.random.key(2), real)["params"]
    dp2, d_loss, gd = jax.device_get(_reference_d(gp, dp, real, noises,
                                                  d_steps, loss))
    gen, disc = Gen(noise_dim), Disc()
    gen.load_state_dict(params_from_flax(gp))
    disc.load_state_dict(params_from_flax(dp))
    est = GANEstimator(gen, disc, loss=loss, noise_dim=noise_dim,
                       d_steps=d_steps, device="cpu")
    draws = []

    def given(step, i, b):
        draws.append((step, i))
        return torch.from_numpy(noises[i])

    est._noise = given
    # one batch of all B rows: the step sees them in a shuffled order,
    # which the mean losses do not see
    hist = est.fit(real, epochs=1, batch_size=B)
    assert draws == [(0, i) for i in range(d_steps + 1)]
    assert set(hist[0]) == {"d_loss", "g_loss", "epoch", "steps"}
    assert (hist[0]["epoch"], hist[0]["steps"]) == (1, 1)
    # the losses are means of O(1) logits that can cancel: 1e-6 relative
    # and 1e-7 absolute
    np.testing.assert_allclose(hist[0]["d_loss"], d_loss, rtol=1e-6,
                               atol=1e-7)
    _hold_update(disc, dp2, gd)
    gp2, g_loss, gg = jax.device_get(_reference_g(
        gp, _flax_tree(disc), noises[-1], loss))
    np.testing.assert_allclose(hist[0]["g_loss"], g_loss, rtol=1e-6,
                               atol=1e-7)
    _hold_update(gen, gp2, gg)
    opt = est.state["g_opt"]
    assert isinstance(opt, torch.optim.Adam)
    assert opt.defaults["lr"] == 2e-4 and opt.defaults["betas"] == \
        (0.5, 0.999) and opt.defaults["eps"] == 1e-8


def _fitted(seed):
    torch.manual_seed(0)
    real = (np.random.default_rng(0).standard_normal((64, 2)) * 0.05
            + [2.0, -1.0]).astype(np.float32)
    est = GANEstimator(Gen(8), Disc(), loss="lsgan", noise_dim=8, seed=seed,
                       device="cpu")
    return est, est.fit(real, epochs=2, batch_size=32)


def test_gan_same_seed_same_history():
    (a, ha), (b, hb) = _fitted(3), _fitted(3)
    assert ha == hb and len(ha) == 2 and ha[-1]["steps"] == 2
    np.testing.assert_array_equal(a.generate(5, seed=1),
                                  b.generate(5, seed=1))
    assert a.generate(16).shape == (16, 2)
    _, hc = _fitted(4)
    assert hc != ha


def test_gan_errors():
    with pytest.raises(RuntimeError, match="fit first"):
        GANEstimator(Gen(4), Disc(), noise_dim=4, device="cpu").generate(2)
    # a mesh is ported: one rank's mesh trains as no mesh does
    assert GANEstimator(Gen(4), Disc(), mesh=Mesh({"dp": 1}, "cpu"),
                        device="cpu")._dp == 1
    with pytest.raises(ValueError, match="unknown GAN loss"):
        GANEstimator(Gen(4), Disc(), loss="hinge", device="cpu")
    est = GANEstimator(Gen(4), Disc(), noise_dim=4, device="cpu")
    with pytest.raises(KeyError, match="ambiguous"):
        est.fit({"a": np.zeros((8, 2), np.float32),
                 "b": np.zeros((8, 2), np.float32)}, batch_size=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GANEstimator(Gen(4), Disc())


# ---- TFDataset --------------------------------------------------------

def _same(ds, jds):
    assert ds.column_names() == jds.column_names()
    assert len(ds) == len(jds)
    assert (ds.batch_size, ds.batch_per_thread) == (jds.batch_size,
                                                    jds.batch_per_thread)
    for k in jds.arrays:
        assert ds.arrays[k].dtype == jds.arrays[k].dtype
        np.testing.assert_array_equal(ds.arrays[k], jds.arrays[k])


def test_tf_dataset_constructors_match_jax():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    y = np.arange(10, dtype=np.float32)
    _same(TFDataset.from_ndarrays((x, y), batch_size=4),
          JaxTFDataset.from_ndarrays((x, y), batch_size=4))
    ds = TFDataset.from_ndarrays({"a": x}, batch_per_thread=2,
                                 val_tensors=(x[:2], y[:2]))
    _same(ds, JaxTFDataset.from_ndarrays({"a": x}, batch_per_thread=2))
    _same(ds.val, JaxTFDataset.from_ndarrays((x[:2], y[:2])))
    cols = {"x": np.arange(12, dtype=np.float32),
            "y": np.arange(12, dtype=np.float32)}
    _same(TFDataset.from_rdd(XShards.partition(cols, 3)),
          JaxTFDataset.from_rdd(JaxXShards.partition(cols, 3)))
    imgs = np.arange(6 * 8 * 8 * 3, dtype=np.uint8).reshape(6, 8, 8, 3)
    _same(TFDataset.from_image_set(ImageSet.from_arrays(imgs, np.arange(6))),
          JaxTFDataset.from_image_set(JaxImageSet.from_arrays(
              imgs, np.arange(6))))
    texts = ["a b c", "b c d", "d d e f g"]
    _same(TFDataset.from_text_set(
        TextSet.from_texts(texts, [0, 1, 1]).tokenize().word2idx()
        .shape_sequence(4), batch_size=2),
        JaxTFDataset.from_text_set(
            JaxTextSet.from_texts(texts, [0, 1, 1]).tokenize().word2idx()
            .shape_sequence(4), batch_size=2))
    fs_cols = {"x": np.ones((8, 2), np.float32),
               "y": np.zeros(8, np.float32)}
    _same(TFDataset.from_feature_set(FeatureSet(fs_cols)),
          JaxTFDataset.from_feature_set(JaxFeatureSet(fs_cols)))
    # the checks are the reference's (a DiskFeatureSet streams from a
    # file; an unopened one is enough for the type check)
    with pytest.raises(TypeError, match="streams from disk"):
        TFDataset.from_feature_set(DiskFeatureSet.__new__(DiskFeatureSet))
    with pytest.raises(ValueError, match="ragged columns"):
        TFDataset({"a": np.zeros(3), "b": np.zeros(4)})


def test_estimator_resolves_batch_as_jax():
    ds = TFDataset.from_ndarrays({"a": np.zeros((4, 1))}, batch_size=16,
                                 batch_per_thread=5)
    plain = {"a": np.zeros((4, 1))}
    for bs, data, attr in [(None, ds, "batch_size"),
                           (None, ds, "batch_per_thread"),
                           (8, ds, "batch_size"), (None, plain, "batch_size"),
                           (None, TFDataset(plain), "batch_per_thread")]:
        assert _resolve_batch(bs, data, attr) == \
            jax_resolve_batch(bs, data, attr)


def test_tf_dataset_batch_metadata_honored():
    """The reference's own check on the port: ``fit`` without a
    ``batch_size`` takes the TFDataset's (4 steps of 16), and
    ``val_tensors`` become the validation set."""
    x = np.ones((64, 3), np.float32)
    y = np.ones((64, 1), np.float32)
    ds = TFDataset.from_ndarrays((x, y), batch_size=16,
                                 val_tensors=(x[:16], y[:16]))
    est = Estimator.from_torch(model=nn.Linear(3, 1), loss="mse",
                               optimizer=lambda ps: torch.optim.SGD(
                                   ps, lr=0.01), device="cpu",
                               config=TrainConfig())
    steps = []
    inner = est._train_step

    def counted(batch):
        steps.append(len(batch["x"]))
        return inner(batch)

    est._train_step = counted
    hist = est.fit(ds, epochs=1)
    assert hist[0]["num_samples"] == 64.0 and steps == [16] * 4
    assert "val_loss" in hist[0]
    assert est.predict(ds).shape == (64, 1)


def test_tfpark_namespace():
    assert tfpark.TFEstimator is Estimator
    assert tfpark.TFPredictor is InferenceModel
    assert tfpark.GANEstimator is GANEstimator
    assert tfpark.TFDataset is TFDataset
    assert tfpark.text.NEREstimator.__name__ == "NEREstimator"
    with pytest.raises(TypeError, match="KerasModel wraps"):
        tfpark.KerasModel(object())
    keras_model = tkeras.Sequential().add(tkeras.Dense(2))
    assert tfpark.KerasModel(keras_model) is keras_model
