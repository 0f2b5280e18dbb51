"""Data-parallel training on the port: the Estimator on a dp=2 mesh of
two gloo processes (``_torch_dist_worker.py`` scenario ``dp``, one
launch for the module) against dp=1 (the same worker, no mesh) and
against the JAX Estimator on the 8-device dp mesh, on the same weights.

A small ResNet with BatchNorm (the reference's init moved off it by
seeded noise, as ``test_torch_image.py`` does): SGD parameters and
running statistics after a fit of 24 rows in batches of 8 (also with
``accum_steps=2``) within 1e-5 of the tensor's scale, Adam losses
within 1e-5, evaluate and predict (rows in global order on every rank).
A tiny LM with dropout: dp=2 draws the global batch's masks, so its SGD
parameters equal dp=1's (the port's masks are not the reference's, so
this one is not held to JAX).  Also: a global batch the ranks do not
divide raises the reference's message; ``read_csv`` splits five files
over the ranks; a checkpoint written by rank 0 restores on every rank
and in this process; host-local ``DiskFeatureSet`` shards train as the
interleaved global batches do on one rank; ``device_prefetch`` with a
batch placement hands each rank its rows.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu import init_orca_context, stop_orca_context
from analytics_zoo_tpu.common.config import TrainConfig as JaxConfig
from analytics_zoo_tpu.learn import Estimator as JaxEstimator
from analytics_zoo_tpu.models import image as ji
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.learn.estimator import TorchEstimator
from analytics_zoo_tpu_torch.models import image as ti
from analytics_zoo_tpu_torch.models.layers import (batch_stats_from_flax,
                                                   params_from_flax)
from analytics_zoo_tpu_torch.models.lm import TransformerLM

from _torch_dist import run_ranks

_SMALL = dict(stage_sizes=(1, 1), width=4, small_inputs=True)
_LM = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_position=16, dropout=0.1,
           dtype=torch.float32)


def _noisy(tree, seed, positive=False):
    rng = np.random.default_rng(seed)

    def one(path, a):
        a = np.asarray(a, np.float32)
        noise = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        pos = positive and path[-1].key == "var"
        return np.abs(a + noise) + 0.1 if pos else a + noise
    return jax.tree_util.tree_map_with_path(one, jax.device_get(tree))


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0,
                               err_msg=what)


def _states_close(a, b, what):
    assert set(a) == set(b)
    for k in a:
        _close(a[k], b[k], f"{what}: {k}")


@pytest.fixture(scope="module")
def dp(tmp_path_factory, devices):
    outdir = tmp_path_factory.mktemp("dp")
    x = np.random.default_rng(7).standard_normal((24, 8, 8, 3)).astype(
        np.float32)
    y = np.random.default_rng(8).integers(0, 5, 24).astype(np.int32)
    jm = ji.ResNet(5, **_SMALL, dtype=jax.numpy.float32)
    v = jm.init(jax.random.key(9), x[:2])
    params = _noisy(v["params"], 10)
    bs = _noisy(v["batch_stats"], 11, positive=True)
    state = params_from_flax(params)
    state.update(batch_stats_from_flax(bs))
    torch.manual_seed(0)
    lm = TransformerLM(**_LM)
    csv = outdir / "csv"
    csv.mkdir()
    for f in range(5):
        rows = list(range(f * 10, f * 10 + 4))
        (csv / f"part-{f}.csv").write_text(
            "a\n" + "\n".join(map(str, rows)) + "\n")
    torch.save({"data": {"x": x, "y": y}, "resnet_state": state,
                "lm_cfg": _LM, "lm_state": lm.state_dict(),
                "lm_tokens": np.random.default_rng(3).integers(
                    0, 32, (12, 16)).astype(np.int32)},
               outdir / "dp_in.pt")
    ranks = run_ranks("dp", outdir, 2)
    return outdir, {"x": x, "y": y}, (jm, params, bs), ranks


@pytest.fixture()
def mesh8():
    init_orca_context("local", mesh_axes={"dp": 8})
    yield
    stop_orca_context()


def _jax_fit(model, opt, data, epochs, accum=1):
    jm, params, bs = model
    est = JaxEstimator.from_flax(
        model=jm, loss="sparse_categorical_crossentropy", optimizer=opt,
        feature_cols=("x",), label_cols=("y",),
        initial_variables={"params": params, "batch_stats": bs},
        config=JaxConfig(deterministic=True, accum_steps=accum))
    hist = est.fit(data, epochs=epochs, batch_size=8)
    state = params_from_flax(jax.device_get(est.state.params))
    state.update(batch_stats_from_flax(jax.device_get(
        est.state.batch_stats)))
    return [h["loss"] for h in hist], state


@pytest.mark.parametrize("run,accum", [("sgd", 1), ("sgd_accum", 2)])
def test_sgd_params_and_running_stats(dp, mesh8, run, accum):
    """dp=2 = dp=1 = the JAX Estimator on its dp mesh: every parameter
    and running statistic, and the loss; both ranks hold the same."""
    _, data, model, ranks = dp
    loss2, s2 = ranks[0][(run, "dp2")]
    loss1, s1 = ranks[0][(run, "dp1")]
    want_loss, want = _jax_fit(model, optax.sgd(0.1), data, 1, accum)
    _states_close(ranks[1][(run, "dp2")][1], s2, "rank 1 = rank 0")
    _states_close(s2, s1, "dp2 = dp1")
    _states_close(s2, want, "dp2 = JAX")
    np.testing.assert_allclose(loss2, loss1, rtol=1e-5)
    np.testing.assert_allclose(loss2, want_loss, rtol=1e-5)


def test_adam_losses(dp, mesh8):
    _, data, model, ranks = dp
    want, _ = _jax_fit(model, 3e-3, data, 2)
    for r in ranks:
        np.testing.assert_allclose(r[("adam", "dp2")][0], want, rtol=1e-5)
    np.testing.assert_allclose(ranks[0][("adam", "dp1")][0], want,
                               rtol=1e-5)


def test_evaluate_and_predict_row_order(dp):
    """evaluate's weighted means over every row once, predict's rows in
    global order on both ranks (10 rows in chunks of 4: one padded)."""
    ranks = dp[3]
    for r in ranks:
        for k, v in ranks[0][("eval", "dp1")].items():
            np.testing.assert_allclose(r[("eval", "dp2")][k], v, rtol=1e-6)
        np.testing.assert_allclose(r[("predict", "dp2")],
                                   ranks[0][("predict", "dp1")], atol=1e-6)
        assert r[("predict", "dp2")].shape == (10, 5)


def test_dropout_on_dp2_equals_dp1(dp):
    ranks = dp[3]
    (l2, s2), (l1, s1) = ranks[0][("dropout", "dp2")], \
        ranks[0][("dropout", "dp1")]
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    _states_close(s2, s1, "dropout dp2 = dp1")
    _states_close(ranks[1][("dropout", "dp2")][1], s2, "rank 1 = rank 0")


def test_indivisible_global_batch_raises(dp):
    for r in dp[3]:
        assert r["indivisible"] == ("global batch 7 must be positive and "
                                    "divisible by data-shard group count 2")


def test_read_csv_disjoint(dp):
    r0, r1 = (set(r["csv_rows"]) for r in dp[3])
    assert r0.isdisjoint(r1)
    assert sorted(r0 | r1) == sorted(f * 10 + i for f in range(5)
                                     for i in range(4))
    assert len(r0) == 12 and len(r1) == 8     # files 0, 2, 4 on rank 0


def test_checkpoint_round_trip(dp):
    """Rank 0 writes, both ranks restore, and one process restores the
    same checkpoint."""
    outdir, data, _, ranks = dp
    for r in ranks:
        saved, restored, step = r["ckpt"]
        assert step == 3
        _states_close(restored, saved, "restored")
    model = ti.ResNet(5, **_SMALL, dtype=torch.float32)
    est = TorchEstimator(model, "sparse_categorical_crossentropy", 0.1,
                         config=TrainConfig(), device="cpu")
    est.load_checkpoint(str(outdir / "ck"))
    assert est._global_step == 3
    _states_close(est.model.state_dict(), ranks[0]["ckpt"][0], "1 rank")
    assert os.listdir(outdir / "ck") == ["ckpt_3"]


def test_disk_feature_set_shards(dp):
    """Each rank streams its own shard file ({host}); the global batch k
    is the ranks' k-th batches together, so dp=2 trains what one rank
    does on the interleaved rows; evaluate counts every row once and
    predict returns each rank's own rows."""
    _, data, _, ranks = dp
    half = 12
    order = [h * half + 4 * k + j for k in range(3) for h in range(2)
             for j in range(4)]
    inter = {k: v[order] for k, v in data.items()}
    loss, n, state, _, _, rows = ranks[0]["disk"]
    assert n == 24.0 and rows == 12
    # one rank on the interleaved rows, through the same TorchEstimator
    from _torch_dist_worker import _est, _sgd, _state
    est = _est({"resnet_state": torch.load(
        dp[0] / "dp_in.pt", weights_only=False)["resnet_state"]}, None,
        _sgd())
    hist = est.fit(inter, epochs=1, batch_size=8)
    np.testing.assert_allclose(loss, [h["loss"] for h in hist], rtol=1e-5)
    _states_close(state, _state(est), "disk dp2 = interleaved dp1")
    _states_close(ranks[1]["disk"][2], state, "rank 1 = rank 0")
    full = est.evaluate(data, batch_size=4)
    for r in ranks:
        for k, v in full.items():
            np.testing.assert_allclose(r["disk"][3][k], v, rtol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([ranks[0]["disk"][4], ranks[1]["disk"][4]]),
        est.predict({"x": data["x"]}, batch_size=4), atol=1e-5)


def test_device_prefetch_hands_each_rank_its_rows(dp):
    _, data, _, ranks = dp
    for i, r in enumerate(ranks):
        want = [data["y"][8 * k + 4 * i:8 * k + 4 * i + 4].tolist()
                for k in range(3)]
        assert r["prefetch"] == want
