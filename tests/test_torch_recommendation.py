"""The port's recommenders against the JAX package: NeuralCF,
WideAndDeep, SessionRecommender and DIEN, and the host-side ``auc``.

Weights are the reference's init moved off it by seeded noise (so the
zero-initialised wide table and biases are not 0); ``params_from_flax``
carries them into the port's modules.  Tolerances: the f32 forward
within 1e-5; the bf16 forward within 3e-2 absolute (every dense output
rounds to bf16, 2**-8 relative, and a recurrence compounds it over its
steps; outputs are of unit scale); Estimator fits (f32) within 1e-5:
SGD parameters, Adam losses relative.  Then the reference's own checks
(``tests/test_models_ncf.py``, ``tests/test_model_zoo.py``) on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu import init_orca_context as jax_init_context
from analytics_zoo_tpu import stop_orca_context as jax_stop_context
from analytics_zoo_tpu.common.config import TrainConfig as JaxConfig
from analytics_zoo_tpu.learn import Estimator as JaxEstimator
from analytics_zoo_tpu.learn.metrics import auc as jax_auc
from analytics_zoo_tpu.models import DIEN as JaxDIEN
from analytics_zoo_tpu.models import NeuralCF as JaxNCF
from analytics_zoo_tpu.models import SessionRecommender as JaxSession
from analytics_zoo_tpu.models import WideAndDeep as JaxWND
from analytics_zoo_tpu.models import ColumnFeatureInfo as JaxInfo
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn.metrics import auc
from analytics_zoo_tpu_torch.models.ncf import NeuralCF
from analytics_zoo_tpu_torch.models.ncf import \
    params_from_flax as ncf_params
from analytics_zoo_tpu_torch.models.recommendation import (
    DIEN, ColumnFeatureInfo, SessionRecommender, WideAndDeep,
    params_from_flax)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """The full suite runs in 6 pytest-xdist workers that share the
    machine's cores; torch's default of one intra-op thread a core
    oversubscribes them, and small eager ops then spend their time
    handing work between threads (the DIEN fit took 369.5 s in a
    6-worker run against 8 s alone). One torch thread for this file,
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ATOL = 1e-5            # forward, f32
_BF16_ATOL = 3e-2       # forward, bf16, unit-scale outputs
_LOSS_RTOL = 1e-5       # fit losses, f32
_PARAM_ATOL = 1e-5      # SGD parameters, f32
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}

_INFO = dict(wide_base_cols=["a", "b"], wide_base_dims=[10, 20],
             wide_cross_cols=["ab"], wide_cross_dims=[50],
             indicator_cols=["g"], indicator_dims=[3],
             embed_cols=["u", "i"], embed_in_dims=[100, 200],
             embed_out_dims=[8, 8], continuous_cols=["age"])


def _noisy(params, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
            np.shape(a)).astype(np.float32), jax.device_get(params))


def _wnd_batch(B=6, seed=1):
    rng = np.random.default_rng(seed)
    wide = rng.integers(0, 81, (B, 3)).astype(np.int32)
    wide[0, 1] = 0                                   # a padding id
    return dict(
        wide_cols=wide,
        indicator_cols=rng.integers(0, 4, (B, 1)).astype(np.int32),
        embed_cols=np.stack([rng.integers(0, 101, B),
                             rng.integers(0, 201, B)], 1).astype(np.int32),
        continuous_cols=rng.standard_normal((B, 1)).astype(np.float32))


def _dien_batch(B=5, T=10, n_items=40, seed=2):
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, n_items + 1, (B, T)).astype(np.int32)
    hist[:, T // 2:] = np.where(rng.random((B, T - T // 2)) < 0.4, 0,
                                hist[:, T // 2:])
    hist[-1, 3:] = 0
    return rng.integers(1, n_items + 1, B).astype(np.int32), hist


def _case(kind, dt):
    """(jax model, port model, positional inputs, keyword inputs)."""
    jdt, tdt = _DT[dt]
    rng = np.random.default_rng(0)
    if kind == "ncf":
        u = rng.integers(0, 11, 7).astype(np.int32)
        i = rng.integers(0, 13, 7).astype(np.int32)
        return (JaxNCF(10, 12, dtype=jdt), NeuralCF(10, 12, dtype=tdt),
                (u, i), {})
    if kind.startswith("wnd"):
        _, mt, how = kind.split(":")
        jm = JaxWND(2, JaxInfo(**_INFO), mt, dtype=jdt)
        tm = WideAndDeep(2, ColumnFeatureInfo(**_INFO), mt, dtype=tdt)
        batch = _wnd_batch()
        if how == "kw":
            return jm, tm, (), batch
        return jm, tm, tuple(batch[g] for g in jm.feature_groups()), {}
    if kind.startswith("session"):
        hist = kind.endswith("history")
        s = rng.integers(0, 51, (3, 5)).astype(np.int32)
        h = rng.integers(0, 51, (3, 8)).astype(np.int32)
        h[1, 4:] = 0
        return (JaxSession(50, 16, include_history=hist, dtype=jdt),
                SessionRecommender(50, 16, include_history=hist, dtype=tdt),
                (s, h) if hist else (s,), {})
    assert kind == "dien"
    return (JaxDIEN(40, 16, 16, dtype=jdt), DIEN(40, 16, 16, dtype=tdt),
            _dien_batch(), {})


_KINDS = ["ncf", "wnd:wide:pos", "wnd:deep:pos", "wnd:wide_n_deep:pos",
          "wnd:wide:kw", "wnd:deep:kw", "wnd:wide_n_deep:kw",
          "session:history", "session:plain", "dien"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", _KINDS)
def test_forward_matches_jax(kind, dt):
    jm, tm, args, kw = _case(kind, dt)
    params = _noisy(jm.init(jax.random.key(0), *args, **kw)["params"])
    want = np.asarray(jm.apply({"params": params}, *args, **kw))
    tm.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = tm(*map(_t, args), **{k: _t(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=_ATOL if dt == "f32" else _BF16_ATOL,
                               rtol=0)


def test_ncf_params_from_flax_names_every_parameter():
    jm, tm, args, _ = _case("ncf", "f32")
    params = jm.init(jax.random.key(0), *args)["params"]
    assert set(ncf_params(params)) == set(tm.state_dict())


@pytest.fixture()
def mesh8():
    jax_init_context("local", mesh_axes={"dp": 8})
    yield
    jax_stop_context()


def _ncf_data(n=64, seed=4):
    rng = np.random.default_rng(seed)
    u = rng.integers(1, 11, n).astype(np.int32)
    i = rng.integers(1, 13, n).astype(np.int32)
    return {"user": u, "item": i, "label": ((u + i) % 2).astype(np.int32)}


def _dien_data(n=48, seed=6):
    item, hist = _dien_batch(n, seed=seed)
    label = np.array([int(item[k] in hist[k]) for k in range(n)], np.int32)
    return {"item": item, "history": hist, "label": label}


_FITS = {
    "ncf": (lambda: JaxNCF(10, 12, dtype=jnp.float32),
            lambda: NeuralCF(10, 12, dtype=torch.float32), _ncf_data,
            ("user", "item")),
    "dien": (lambda: JaxDIEN(40, 16, 16, dtype=jnp.float32),
             lambda: DIEN(40, 16, 16, dtype=torch.float32), _dien_data,
             ("item", "history")),
}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("kind", sorted(_FITS))
def test_fit_matches_jax(mesh8, kind, opt):
    """The same weights, data order and optimizer: the same losses, and
    under SGD the same parameters."""
    jmk, tmk, data_fn, feats = _FITS[kind]
    data = data_fn()
    jm, tm = jmk(), tmk()
    params = _noisy(jm.init(jax.random.key(1), *[data[f][:2]
                                                  for f in feats])["params"])
    tm.load_state_dict(params_from_flax(params))
    jopt, topt = {
        "sgd": (optax.sgd(0.1), lambda ps: torch.optim.SGD(ps, lr=0.1)),
        "adam": (optax.adam(1e-2), 1e-2),
    }[opt]
    cols = dict(feature_cols=feats, label_cols=("label",))
    jest = JaxEstimator.from_flax(
        model=jm, loss="sparse_categorical_crossentropy", optimizer=jopt,
        initial_variables=params, config=JaxConfig(deterministic=True),
        **cols)
    ref = jest.fit(data, epochs=2, batch_size=16)
    test = Estimator.from_torch(
        model=tm, loss="sparse_categorical_crossentropy", optimizer=topt,
        config=TrainConfig(deterministic=True), device="cpu", **cols)
    got = test.fit(data, epochs=2, batch_size=16)
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in ref], rtol=_LOSS_RTOL)
    if opt == "sgd":
        want = params_from_flax(jax.device_get(jest.state.params))
        have = test.model.state_dict()
        assert set(want) == set(have)
        for name, w in want.items():
            np.testing.assert_allclose(have[name].numpy(), w.numpy(),
                                       atol=_PARAM_ATOL, rtol=0,
                                       err_msg=name)


# ---- the reference's own checks, on the port ------------------------------

def test_ncf_trains_and_predicts():
    rng = np.random.default_rng(0)
    n, users, items = 2048, 200, 100
    u = rng.integers(1, users + 1, n).astype(np.int32)
    i = rng.integers(1, items + 1, n).astype(np.int32)
    data = {"user": u, "item": i, "label": ((u + i) % 2 == 0).astype(
        np.int32)}
    torch.manual_seed(0)
    est = Estimator.from_torch(
        model=NeuralCF(user_count=users, item_count=items),
        loss="sparse_categorical_crossentropy", optimizer=2e-2,
        metrics=["accuracy"], feature_cols=("user", "item"),
        label_cols=("label",), device="cpu")
    hist = est.fit(data, epochs=12, batch_size=256)
    assert hist[-1]["accuracy"] > 0.95
    preds = est.predict(data, batch_size=256)
    assert preds.shape == (2048, 2)
    assert (np.argmax(preds, -1) == data["label"]).mean() > 0.95


def test_wide_and_deep_shapes():
    info = ColumnFeatureInfo(**_INFO)
    assert info.wide_dim_total == 80
    assert info.wide_offsets() == [1, 11, 31]
    B = 4
    batch = dict(wide_cols=torch.ones(B, 3, dtype=torch.int32),
                 indicator_cols=torch.ones(B, 1, dtype=torch.int32),
                 embed_cols=torch.ones(B, 2, dtype=torch.int32),
                 continuous_cols=torch.ones(B, 1))
    out = WideAndDeep(class_num=2, column_info=info)(**batch)
    assert out.shape == (B, 2) and out.dtype == torch.float32
    for mt in ("wide", "deep"):
        m = WideAndDeep(class_num=2, column_info=info, model_type=mt)
        assert m(**batch).shape == (B, 2)
    with pytest.raises(ValueError, match="missing inputs"):
        WideAndDeep(class_num=2, column_info=info)(batch["wide_cols"])


def test_wide_branch_is_sum_of_rows():
    info = ColumnFeatureInfo(wide_base_cols=["a"], wide_base_dims=[5])
    model = WideAndDeep(class_num=2, column_info=info, model_type="wide")
    ids = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    # the padding row gets a nonzero value: the masked gather ignores it
    table = np.arange(12, dtype=np.float32).reshape(6, 2)
    model.load_state_dict({"wide_embedding.weight": torch.from_numpy(table)})
    out = model(wide_cols=ids)
    np.testing.assert_allclose(out[0].detach(), table[1] + table[2],
                               rtol=1e-5)
    np.testing.assert_allclose(out[1].detach(), table[3], rtol=1e-5)
    out.sum().backward()
    assert float(model.wide_embedding.weight.grad[0].abs().sum()) == 0.0
    assert float(model.wide_embedding.weight.grad[1:4].abs().sum()) > 0


def test_session_recommender():
    model = SessionRecommender(item_count=50, item_embed=16,
                               session_length=5, include_history=True,
                               history_length=8)
    out = model(torch.ones(3, 5, dtype=torch.int32),
                torch.ones(3, 8, dtype=torch.int32))
    assert out.shape == (3, 51)
    with pytest.raises(ValueError, match="history"):
        model(torch.ones(3, 5, dtype=torch.int32))


def test_dien_learns_history_membership():
    """Click iff the target item appears in the behaviour history — the
    signal target attention and the AUGRU exist to capture."""
    rng = np.random.default_rng(0)
    n, T, n_items = 512, 10, 40
    hist = rng.integers(1, n_items + 1, (n, T)).astype(np.int32)
    hist[:, T // 2:] = np.where(rng.random((n, T - T // 2)) < 0.3, 0,
                                hist[:, T // 2:])    # ragged padding
    item = rng.integers(1, n_items + 1, n).astype(np.int32)
    label = np.array([int(item[i] in hist[i]) for i in range(n)],
                     np.int32)
    # balance: force half the positives
    pos = rng.random(n) < 0.5
    for i in np.flatnonzero(pos & (label == 0)):
        item[i] = hist[i, rng.integers(0, T // 2)]
        label[i] = 1
    torch.manual_seed(0)
    est = Estimator.from_torch(
        model=DIEN(item_count=n_items, item_embed=16, gru_hidden=16),
        loss="sparse_categorical_crossentropy", optimizer=5e-3,
        metrics=("accuracy",), feature_cols=("item", "history"),
        label_cols=("label",), device="cpu")
    data = {"item": item, "history": hist, "label": label}
    est.fit(data, epochs=35, batch_size=64)
    ev = est.evaluate(data, batch_size=64)
    assert ev["accuracy"] > 0.85, ev
    preds = est.predict({"item": item[:32], "history": hist[:32]},
                        batch_size=32)

    assert preds.shape == (32, 2)


# ---- auc ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "single_class",
                                  "perfect"])
def test_auc_matches_jax(case):
    rng = np.random.default_rng(7)
    scores = rng.random(200).astype(np.float32)
    labels = rng.integers(0, 2, 200)
    if case == "ties":
        scores = np.round(scores * 4) / 4
    elif case == "single_class":
        labels = np.ones(200, np.int64)
    elif case == "perfect":
        labels = (scores > 0.5).astype(np.int64)
    got, want = auc(scores, labels), jax_auc(scores, labels)
    if case == "single_class":
        assert np.isnan(got) and np.isnan(want)
    else:
        assert got == want
    if case == "perfect":
        assert got == 1.0
