"""The port's ``Estimator.from_torch`` held to the JAX ``Estimator.from_flax``.

The same tiny GPT-2-shaped LM (MHA, f32, plain attention on the CPU in
both packages), the same weights (the reference initialises them,
``params_from_flax`` carries them across; the JAX side starts from them
through ``initial_variables``) and the same token rows.  The JAX side
runs on the 8-device CPU mesh as ``tests/test_lm.py`` runs it.  Both
packages draw their batches from the same ``NumpyBatchIterator``
schedule (``seed + epoch`` permutations), shuffled or not.

- Adam at 3e-3 (``optimizer=3e-3`` on both sides): the per-epoch loss
  histories agree.  Adam turns a gradient near zero into a step of
  about +-lr whose sign is noise, so the parameters are compared after
  a run with plain SGD, where they must agree.
- ``evaluate`` (a row count that needs a padded chunk) and ``predict``.
- The observability and debug TrainConfig fields are honoured (held to
  the reference in ``tests/test_torch_observability.py``; the
  checkpoint fields in ``tests/test_torch_checkpoint.py``, and
  ``accum_steps`` in ``tests/test_torch_image.py``), and the
  default device raises on a CPU-only host while ``device="cpu"``
  runs.
"""

import json
import os
import sys
import types

import jax
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu import init_orca_context, stop_orca_context
from analytics_zoo_tpu.common.config import TrainConfig as JaxConfig
from analytics_zoo_tpu.learn import Estimator as JaxEstimator
from analytics_zoo_tpu.models.lm import LM_PARTITION_RULES
from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.models.lm import lm_loss as jax_lm_loss
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.models.lm import (TransformerLM, lm_loss,
                                               params_from_flax)

_CFG = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=16, ln_eps=1e-5)
_T = 12
# Losses: f32 on both sides, sums in another order (XLA on the CPU mesh
# against eager PyTorch): a few f32 ulps per step, carried through two
# epochs of updates.
_LOSS_RTOL = 1e-5
# Parameters after SGD at lr 0.5: each step moves a parameter by lr x a
# gradient that agrees to ~1e-7, over six steps.
_PARAM_ATOL = 1e-5


def _weights(cfg):
    """(reference model, its params as numpy, token rows, the config)."""
    jm = JaxLM(dtype=jax.numpy.float32, dropout=0.0, **cfg)
    params = jm.init(jax.random.key(7), np.zeros((1, 8), np.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    toks = np.random.default_rng(1).integers(0, 32, (24, _T)).astype(
        np.int32)
    return jm, params, toks, cfg


@pytest.fixture(scope="module")
def weights():
    return _weights(_CFG)


# A Llama-family config: rope, RMSNorm, SwiGLU, GQA, bias-free
# projections with q/k/v biases, an untied head
_LLAMA = dict(_CFG, num_heads=4, num_kv_heads=2, pos_encoding="rope",
              norm="rmsnorm", mlp="swiglu", use_bias=False, qkv_bias=True,
              tied_head=False)


@pytest.fixture(scope="module")
def llama_weights():
    return _weights(_LLAMA)


@pytest.fixture()
def mesh8():
    init_orca_context("local", mesh_axes={"dp": 8})
    yield
    stop_orca_context()


def _jax_est(weights, optimizer, deterministic=True):
    jm, params, _, _ = weights
    return JaxEstimator.from_flax(
        model=jm, loss=jax_lm_loss, optimizer=optimizer,
        feature_cols=("tokens",), label_cols=("tokens",),
        partition_rules=LM_PARTITION_RULES, initial_variables=params,
        config=JaxConfig(deterministic=deterministic))


def _port_est(weights, optimizer, deterministic=True):
    _, params, _, cfg = weights
    tm = TransformerLM(dtype=torch.float32, **cfg)
    tm.load_state_dict(params_from_flax(params))
    return Estimator.from_torch(
        model=tm, loss=lm_loss, optimizer=optimizer,
        feature_cols=("tokens",), label_cols=("tokens",),
        config=TrainConfig(deterministic=deterministic), device="cpu")


@pytest.mark.parametrize("deterministic", [True, False])
def test_fit_losses_match_jax_adam(weights, mesh8, deterministic):
    toks = weights[2]
    ref = _jax_est(weights, 3e-3, deterministic).fit(
        {"tokens": toks}, epochs=2, batch_size=8)
    got = _port_est(weights, 3e-3, deterministic).fit(
        {"tokens": toks}, epochs=2, batch_size=8)
    assert [h["num_samples"] for h in got] == [24.0, 24.0]
    assert set(got[0]) == set(ref[0])
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in ref], rtol=_LOSS_RTOL)
    assert got[1]["loss"] < got[0]["loss"]


def test_llama_fit_losses_match_jax_adam(llama_weights, mesh8):
    """The Llama config trains through ``Estimator.from_torch`` as it
    does through ``Estimator.from_flax``: the same Adam loss history."""
    toks = llama_weights[2]
    ref = _jax_est(llama_weights, 3e-3).fit({"tokens": toks}, epochs=2,
                                             batch_size=8)
    got = _port_est(llama_weights, 3e-3).fit({"tokens": toks}, epochs=2,
                                              batch_size=8)
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in ref], rtol=_LOSS_RTOL)
    assert got[1]["loss"] < got[0]["loss"]


def test_sgd_params_match_jax(weights, mesh8):
    _sgd_case(weights)


def test_llama_sgd_params_match_jax(llama_weights, mesh8):
    _sgd_case(llama_weights)


def _sgd_case(weights):
    """SGD at lr 0.5 for two epochs in both packages: losses, then every
    parameter."""
    toks = weights[2]
    jest = _jax_est(weights, optax.sgd(0.5), deterministic=False)
    ref = jest.fit({"tokens": toks}, epochs=2, batch_size=8)
    test = _port_est(weights, lambda ps: torch.optim.SGD(ps, lr=0.5),
                     deterministic=False)
    got = test.fit({"tokens": toks}, epochs=2, batch_size=8)
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in ref], rtol=_LOSS_RTOL)
    want = params_from_flax(jax.device_get(jest.state.params))
    have = test.model.state_dict()
    assert set(want) == set(have)
    for name, w in want.items():
        np.testing.assert_allclose(have[name].numpy(), w.numpy(),
                                   atol=_PARAM_ATOL, rtol=0, err_msg=name)
    start = params_from_flax(weights[1])
    moved = max(float((have[n] - start[n]).abs().max()) for n in have)
    assert moved > 100 * _PARAM_ATOL      # the run really trained


def test_evaluate_and_predict_match_jax(weights, mesh8):
    toks = weights[2][:20]      # 8 + 8 + 4: the last chunk is padded
    jest = _jax_est(weights, 1e-3)
    test = _port_est(weights, 1e-3)
    ref = jest.evaluate({"tokens": toks}, batch_size=8)
    got = test.evaluate({"tokens": toks}, batch_size=8)
    assert set(got) == set(ref) == {"loss"}
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
    pref = np.asarray(jest.predict({"tokens": toks}, batch_size=8))
    pgot = test.predict({"tokens": toks}, batch_size=8)
    assert pgot.shape == pref.shape == (20, _T, _CFG["vocab_size"])
    np.testing.assert_allclose(pgot, pref, atol=1e-4, rtol=0)


def test_validation_history_and_stop_callback(weights):
    toks = weights[2]
    est = _port_est(weights, 3e-3)

    def stopper(stats):
        return True

    stopper.requests_stop = True
    seen = []
    hist = est.fit({"tokens": toks}, epochs=3, batch_size=8,
                   validation_data={"tokens": toks[:5]},
                   callbacks=(lambda s: seen.append(s) or True, stopper))
    # an ordinary callback's truthy return never stops; stopper does
    assert len(hist) == len(seen) == 1
    assert set(hist[0]) == {"loss", "num_samples", "samples_per_sec",
                            "val_loss"}
    assert hist[0]["val_loss"] == pytest.approx(
        est.evaluate({"tokens": toks[:5]}, batch_size=8)["loss"])


@pytest.mark.parametrize("field,value", [
    ("tensorboard_dir", "tb"), ("metrics_jsonl", "m.jsonl"),
    ("profile", ("trace", 5, 5)), ("fault_inject_step", 3),
    ("debug_nans", True)])
def test_unported_train_config_fields_raise(weights, field, value, tmp_path,
                                            monkeypatch):
    """The observability and debug fields, which raised until they were
    ported, are honoured: set on the config of a fit of 6 steps, each
    leaves its output (a metrics file, event files, a trace of steps 5
    and 6), the fault raises after step 3, and ``debug_nans`` trains the
    same losses (``tests/test_torch_observability.py`` holds each to
    the reference)."""
    # TensorBoard's no-TensorFlow mode: the same writer, without a ~17 s
    # TensorFlow import
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))
    if field in ("tensorboard_dir", "metrics_jsonl"):
        value = str(tmp_path / value)
    elif field == "profile":
        value = (str(tmp_path / value[0]),) + value[1:]
    Estimator.from_torch(model=torch.nn.Linear(2, 2),
                         config=TrainConfig(**{field: value}), device="cpu")
    est = _port_est(weights, 1e-3)
    setattr(est.config, field, value)
    est.config.log_every_steps = 1
    if field == "fault_inject_step":
        with pytest.raises(RuntimeError, match="injected fault at step 3"):
            est.fit({"tokens": weights[2]}, epochs=2, batch_size=8)
        return
    hist = est.fit({"tokens": weights[2]}, epochs=2, batch_size=8)
    if field == "metrics_jsonl":
        with open(value) as f:
            assert [json.loads(r)["step"] for r in f] == [1, 2, 3, 4, 5, 6]
    elif field == "tensorboard_dir":
        assert any(n.startswith("events.") for n in os.listdir(value))
    elif field == "profile":
        assert any(n.endswith(".pt.trace.json.gz")
                   for n in os.listdir(value[0]))
    else:
        plain = _port_est(weights, 1e-3).fit({"tokens": weights[2]},
                                              epochs=2, batch_size=8)
        assert [h["loss"] for h in hist] == [h["loss"] for h in plain]


def test_default_device_is_cuda(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Estimator.from_torch(model=torch.nn.Linear(2, 2))
    est = Estimator.from_torch(model=torch.nn.Linear(2, 2), device="cpu")
    assert est.device == torch.device("cpu")
    x = np.ones((4, 2), np.float32)
    hist = est.fit({"x": x, "y": x}, epochs=1, batch_size=2)
    assert np.isfinite(hist[0]["loss"])
    assert isinstance(est.optimizer, torch.optim.Adam)
    assert est.optimizer.defaults["lr"] == 1e-3


def _loss_inputs(name, rng):
    """(preds, targets) as numpy for a loss or metric ``name``."""
    if "categorical" in name or name in ("accuracy", "top1accuracy",
                                         "top5accuracy"):
        logits = rng.standard_normal((6, 7)).astype(np.float32)
        labels = rng.integers(0, 7, 6).astype(np.int32)
        if name == "categorical_crossentropy":
            return logits, np.eye(7, dtype=np.float32)[labels]
        return logits, labels
    preds = rng.standard_normal((6, 3)).astype(np.float32) * 2
    if name in ("bce", "binary_crossentropy", "binary_accuracy"):
        return preds, (rng.random((6, 3)) > 0.5).astype(np.float32)
    return preds, rng.standard_normal((6, 3)).astype(np.float32)


@pytest.mark.parametrize("kind,name", [
    *(("loss", n) for n in ("mse", "mae", "bce",
                            "sparse_categorical_crossentropy",
                            "categorical_crossentropy", "huber")),
    *(("metric", n) for n in ("accuracy", "top5accuracy",
                              "binary_accuracy", "mae", "mse"))])
def test_losses_and_metrics_match_jax(kind, name):
    """Every named loss and metric of the port against the reference's
    on the same inputs (f32, one pass each: summation order only)."""
    from analytics_zoo_tpu.learn.metrics import get_metric as jax_metric
    from analytics_zoo_tpu.learn.objectives import get_loss as jax_loss
    from analytics_zoo_tpu_torch.learn.metrics import get_metric
    from analytics_zoo_tpu_torch.learn.objectives import get_loss

    preds, targets = _loss_inputs(name, np.random.default_rng(3))
    if kind == "loss":
        ours, ref = get_loss(name), jax_loss(name)
    else:
        ours, ref = get_metric(name)[1], jax_metric(name)[1]
    got = ours(torch.from_numpy(preds), torch.from_numpy(targets))
    want = ref(jax.numpy.asarray(preds), jax.numpy.asarray(targets))
    assert got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                               atol=1e-7)
