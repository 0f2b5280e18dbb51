"""The port's AutoML (``hp``, ``SearchEngine``, ``AutoEstimator``), Zouwu
preprocessing and AutoTS, and its one-device ``init_orca_context``,
against the JAX package and the reference's own checks
(``tests/test_automl_zouwu.py``).

Search spaces sample the same configs as the reference's for a seed
(exact).  Every test that starts a context stops it in a fixture's
teardown: tier-1 runs files in shared worker processes, and a context
left up would move later tests' default device to the CPU.
"""

import numpy as np
import pandas as pd
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.automl import hp as jax_hp
from analytics_zoo_tpu.automl.search import SearchEngine as JaxEngine
from analytics_zoo_tpu.zouwu import autots as jax_autots
from analytics_zoo_tpu.zouwu import preprocessing as jax_pre
from analytics_zoo_tpu_torch import (OrcaContext, init_orca_context,
                                     resolve_device, stop_orca_context)
from analytics_zoo_tpu_torch.automl import (AutoEstimator, SearchEngine,
                                            hp)
from analytics_zoo_tpu_torch.automl.search import MedianStopper
from analytics_zoo_tpu_torch.common import context
from analytics_zoo_tpu_torch.zouwu import (AutoTSTrainer, StandardScaler,
                                           TCMFForecaster,
                                           TimeSequenceFeatureTransformer,
                                           TSPipeline, roll,
                                           train_val_test_split)
from analytics_zoo_tpu_torch.zouwu import autots


@pytest.fixture()
def cpu_context():
    ctx = init_orca_context("local", device="cpu")
    yield ctx
    stop_orca_context()


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _space(mod):
    return {"lr": mod.loguniform(1e-4, 1e-2),
            "units": mod.choice([8, 16]),
            "layers": mod.grid_search([1, 2, 3]),
            "nested": {"q": mod.quniform(0, 10, 2), "r": mod.randint(1, 9),
                       "u": mod.uniform(-1, 1)},
            "const": 7}


# ---- hp and the search engine --------------------------------------------

def test_hp_sampling_and_grid():
    space = _space(hp)
    rng = np.random.default_rng(0)
    cfg = hp.sample_config(space, rng)
    assert 1e-4 <= cfg["lr"] <= 1e-2
    assert cfg["units"] in (8, 16)
    assert cfg["nested"]["q"] % 2 == 0
    assert cfg["const"] == 7 and "layers" not in cfg
    assert [g["layers"] for g in hp.grid_configs(space)] == [1, 2, 3]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_hp_draws_equal_jax(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        assert hp.sample_config(_space(hp), a) == \
            jax_hp.sample_config(_space(jax_hp), b)
    assert hp.grid_configs(_space(hp)) == jax_hp.grid_configs(_space(jax_hp))


@pytest.mark.parametrize("seed", [0, 3])
def test_autots_trial_configs_equal_jax(seed):
    """The default AutoTS space draws the reference's trial configs."""
    def nop(config, report):
        return 0.0

    got = SearchEngine(nop, autots._DEFAULT_SPACE, n_sampling=6,
                       seed=seed)._configs()
    want = JaxEngine(nop, jax_autots._DEFAULT_SPACE, n_sampling=6,
                     seed=seed)._configs()
    assert got == want and len(got) == 6


def test_search_engine_finds_minimum():
    def trainable(config, report):
        return (config["lr"] - 0.3) ** 2

    eng = SearchEngine(trainable, {"lr": hp.uniform(0.0, 1.0)},
                       n_sampling=30, seed=1)
    best = eng.run()
    assert abs(best.config["lr"] - 0.3) < 0.15
    assert best.status == "done"


def test_search_engine_grid_and_errors():
    def trainable(config, report):
        if config["x"] == 2:
            raise RuntimeError("boom")
        return float(config["x"])

    eng = SearchEngine(trainable, {"x": hp.grid_search([1, 2, 3])})
    assert eng.run().config["x"] == 1
    statuses = {t.config["x"]: t.status for t in eng.trials}
    assert statuses[2] == "error"


def test_median_stopper_prunes():
    calls = []

    def trainable(config, report):
        for ep in range(5):
            report(ep, config["v"])
            calls.append((config["v"], ep))
        return config["v"]

    eng = SearchEngine(
        trainable, {"v": hp.grid_search([1., 1., 1., 1., 50.])},
        scheduler=MedianStopper(grace_epochs=1))
    assert eng.run().metric == 1.0
    pruned = [t for t in eng.trials if t.status == "pruned"]
    assert len(pruned) == 1 and pruned[0].config["v"] == 50.0
    assert len([c for c in calls if c[0] == 50.0]) < 5


def test_distributed_trials_raise():
    with pytest.raises(NotImplementedError, match="item 6"):
        SearchEngine(lambda c, r: 0.0, {"a": hp.grid_search([1, 2])},
                     distributed=True)
    assert SearchEngine._nprocs() == 1
    with pytest.raises(NotImplementedError, match="item 6"):
        AutoTSTrainer(lookback=4).fit({"value": np.zeros(40, np.float32)},
                                      distributed=True)


# ---- preprocessing ----------------------------------------------------------

def test_roll_and_split_and_scaler():
    data = np.arange(20, dtype=np.float32)
    x, y = roll(data, lookback=4, horizon=2)
    assert x.shape == (15, 4, 1) and y.shape == (15, 2, 1)
    np.testing.assert_allclose(x[0, :, 0], [0, 1, 2, 3])
    np.testing.assert_allclose(y[0, :, 0], [4, 5])
    jx, jy = jax_pre.roll(data, lookback=4, horizon=2)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    tr, va, te = train_val_test_split(data, 0.2, 0.2)
    assert len(tr) == 12 and len(va) == 4 and len(te) == 4
    assert tr[-1] < va[0] < te[0]
    sc = StandardScaler()
    mat = np.random.default_rng(0).normal(5, 3, (100, 2))
    z = sc.fit_transform(mat)
    assert abs(z.mean()) < 1e-5 and abs(z.std() - 1) < 1e-2
    np.testing.assert_allclose(sc.inverse_transform(z), mat, rtol=1e-4)


def _series_df(n=200):
    t = np.arange(n)
    return pd.DataFrame({
        "datetime": pd.date_range("2026-01-01", periods=n, freq="h"),
        "value": np.sin(t / 8).astype(np.float32) + 0.1})


def test_feature_transformer_roundtrip():
    df = _series_df(100)
    tf = TimeSequenceFeatureTransformer(lookback=12, horizon=2)
    x, y = tf.fit_transform(df)
    assert x.shape[1:] == (12, 6)    # value + 5 calendar features
    assert y.shape[1:] == (2, 1)
    jx, jy = jax_pre.TimeSequenceFeatureTransformer(
        lookback=12, horizon=2).fit_transform(df)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(tf.inverse(y[..., 0])[0],
                               df["value"].to_numpy()[12:14], rtol=1e-4)
    x2, _ = TimeSequenceFeatureTransformer.from_state(tf.state()).transform(
        df)
    np.testing.assert_allclose(x, x2, rtol=1e-5)


def test_transformer_reads_a_dict_without_pandas_columns():
    series = np.sin(np.arange(50) / 4).astype(np.float32)
    tf = TimeSequenceFeatureTransformer(lookback=6)
    x, y = tf.fit_transform({"value": series})
    assert x.shape == (44, 6, 1) and y.shape == (44, 1, 1)


# ---- AutoTS ----------------------------------------------------------------

def test_autots_end_to_end(cpu_context, tmp_path):
    torch.manual_seed(0)
    df = _series_df(220)
    trainer = AutoTSTrainer(horizon=1, lookback=12, search_space={
        "model": "tcn", "units": hp.choice([8]), "layers": 1,
        "lr": hp.loguniform(1e-3, 1e-2), "batch_size": 32})
    pipe = trainer.fit(df, n_sampling=2, epochs=2)
    assert pipe.forecaster.estimator.device.type == "cpu"
    ev = pipe.evaluate(df, metrics=("mse", "mae"))
    assert ev["mse"] < 1.0       # original units; sine amplitude 1
    preds = pipe.predict(df)
    assert preds.shape[1] == 1
    p = str(tmp_path / "pipe")
    pipe.save(p)
    pipe2 = TSPipeline.load(p)
    np.testing.assert_allclose(pipe2.predict(df), preds, rtol=1e-4)
    pipe2.fit(df, epochs=1, batch_size=32)


def test_tspipeline_predicts_true_future(cpu_context):
    df = _series_df(220)
    trainer = AutoTSTrainer(horizon=1, lookback=12, search_space={
        "model": "tcn", "units": 8, "layers": 1, "lr": 3e-3,
        "batch_size": 32})
    pipe = trainer.fit(df, n_sampling=1, epochs=1)
    assert pipe.predict(df.tail(12)).shape == (1, 1)
    assert len(pipe.predict(df)) == len(df) - 12 + 1


def test_autots_on_a_dict_series_with_lstm(cpu_context, tmp_path):
    """The card's path: a dict series (no pandas), an LSTM trial."""
    series = (np.sin(np.arange(300) / 6) + 0.05 * np.random.default_rng(
        0).standard_normal(300)).astype(np.float32)
    pipe = AutoTSTrainer(horizon=1, lookback=16, search_space={
        "model": "lstm", "units": 8, "layers": 1, "dropout": 0.0,
        "lr": 5e-3, "batch_size": 32}).fit({"value": series},
                                           n_sampling=1, epochs=2)
    preds = pipe.predict({"value": series})
    assert preds.shape == (300 - 16 + 1, 1) and np.isfinite(preds).all()
    pipe.save(str(tmp_path / "p"))
    np.testing.assert_array_equal(
        TSPipeline.load(str(tmp_path / "p")).predict({"value": series}),
        preds)


# ---- AutoEstimator ---------------------------------------------------------

class _Line(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Linear(1, 1)

    def forward(self, x):
        return self.w(x)


def test_auto_estimator_picks_a_learning_rate():
    x = np.linspace(-1, 1, 64, dtype=np.float32)[:, None]
    data = {"x": x, "y": 3 * x + 1}
    torch.manual_seed(0)
    auto = AutoEstimator.from_torch(lambda cfg: _Line(), loss="mse",
                                    device="cpu")
    assert AutoEstimator.from_flax is AutoEstimator.from_torch
    auto.fit(data, search_space={"lr": hp.grid_search([1e-4, 0.1])},
             epochs=20, batch_size=16)
    assert auto.get_best_config()["lr"] == 0.1
    est = auto.get_best_model()
    assert isinstance(est.optimizer, torch.optim.Adam)
    assert est.evaluate(data)["loss"] < 0.1
    with pytest.raises(NotImplementedError, match="item 6"):
        auto.fit(data, search_space={"lr": 0.1}, distributed=True)


# ---- the context and the entry points' device -------------------------------

def test_context_holds_the_device(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    ctx = init_orca_context("local", device="cpu")
    try:
        assert OrcaContext.get_context() is ctx
        assert resolve_device(None) == torch.device("cpu")
        assert ctx.num_devices == 1
    finally:
        stop_orca_context()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="No context"):
        OrcaContext.get_context()


@pytest.mark.parametrize("kw,err,match", [
    (dict(cluster_mode="yarn-client"), ValueError, "multihost"),
    (dict(cluster_mode="k8s"), ValueError, "Spark-era"),
    (dict(mesh_axes={"dp": 3}), ValueError, "device count 1"),
    (dict(num_devices=2), ValueError, "only 1 devices")])
def test_unported_context_modes_raise(kw, err, match):
    """Spark-era modes keep the reference's error, and one process
    holds one rank (the process group's modes run in
    ``test_torch_mesh.py``); distributed trials are not ported."""
    mode = kw.pop("cluster_mode", "local")
    with pytest.raises(err, match=match):
        init_orca_context(mode, device="cpu", **kw)
    assert context.context_device() is None
    with pytest.raises(NotImplementedError, match="item 6.3"):
        context.local_process_scope()


def test_entry_points_need_cuda_or_a_device(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_orca_context("local")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoEstimator.from_torch(lambda cfg: _Line())
    series = {"value": np.sin(np.arange(60) / 4).astype(np.float32)}
    # a trial that cannot get a device fails, so no trial succeeds
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoTSTrainer(lookback=6, search_space={
            "model": "tcn", "units": 4, "layers": 1}).fit(
                series, n_sampling=1, epochs=1)
    init_orca_context("local", device="cpu")
    try:
        pipe = AutoTSTrainer(lookback=6, search_space={
            "model": "tcn", "units": 4, "layers": 1}).fit(
                series, n_sampling=1, epochs=1)
        pipe.save(str(tmp_path / "p"))
    finally:
        stop_orca_context()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSPipeline.load(str(tmp_path / "p"))


def test_tcmf_is_not_ported():
    """``TCMFForecaster`` is now ported (``tests/test_torch_tcmf.py``):
    Zouwu exports the port's class, which runs where it is told and, as
    every entry point, defaults to the card."""
    from analytics_zoo_tpu_torch.zouwu.tcmf import TCMFForecaster as T

    assert TCMFForecaster is T
    assert TCMFForecaster(device="cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TCMFForecaster()
