"""The Estimator's observability and debug fields on the port, held to
the reference's ``tests/test_observability.py`` (all its cases but the
keras one, whose API is not ported yet).

- ``set_tensorboard``: ``train.jsonl`` holds the reference's records on
  the same weights and data (NCF at f32 on both sides, the reference on
  the 8-device CPU mesh): the same steps and keys, losses within 1e-5
  relative (sums in another order); event files where TensorBoard is
  installed.
- ``set_profile``: a gzipped Chrome trace from ``torch.profiler``
  naming the steps' operations; a fault mid-trace stops it, so the next
  trace starts.
- ``fault_inject_step``: the fault comes after step N and before its
  checkpoint, so a fresh estimator resumes from step N - 1 and trains on.
- ``debug_nans``: raises ``FloatingPointError`` at the step whose batch
  poisons the loss, with the parameters of the step before; no
  process-global torch flag is left set.
- ``deterministic``: two runs give bit-identical losses.
"""

import glob
import gzip
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.common.config import TrainConfig as JaxConfig
from analytics_zoo_tpu.learn import Estimator as JaxEstimator
from analytics_zoo_tpu.models import NCF_PARTITION_RULES
from analytics_zoo_tpu.models import NeuralCF as JaxNCF
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.common.log import (start_profiler_trace,
                                                stop_profiler_trace)
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn.estimator import latest_checkpoint
from analytics_zoo_tpu_torch.learn.triggers import SeveralIteration
from analytics_zoo_tpu_torch.models.ncf import NeuralCF, params_from_flax

_NCF = dict(user_count=50, item_count=30, user_embed=8, item_embed=8,
            mf_embed=8, hidden_layers=(16,))
_LOSS_RTOL = 1e-5


def _est(state=None, **cfg_kw):
    torch.manual_seed(0)
    model = NeuralCF(**_NCF, dtype=torch.float32)
    if state is not None:
        model.load_state_dict(state)
    return Estimator.from_torch(
        model=model, loss="sparse_categorical_crossentropy",
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3),
        feature_cols=("user", "item"), label_cols=("label",),
        config=TrainConfig(log_every_steps=1, **cfg_kw), device="cpu")


def _data(n=256):
    rng = np.random.default_rng(0)
    return {"user": rng.integers(1, 50, n).astype(np.int32),
            "item": rng.integers(1, 30, n).astype(np.int32),
            "label": rng.integers(0, 2, n).astype(np.int32)}


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture()
def tensorboard_without_tf(monkeypatch):
    """TensorBoard's own no-TensorFlow mode (its ``compat.notf`` marker):
    the event writer is the same, and its import takes a second instead
    of importing TensorFlow (~17 s on a CPU host)."""
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))


def test_set_tensorboard_writes_jsonl_and_events(tmp_path, ctx8,
                                                 tensorboard_without_tf):
    jm = JaxNCF(**_NCF, dtype=jnp.float32)
    data = _data()
    variables = jm.init(jax.random.key(0), data["user"][:2],
                        data["item"][:2])
    ref = JaxEstimator.from_flax(
        model=jm, loss="sparse_categorical_crossentropy",
        optimizer=optax.adam(1e-3), feature_cols=("user", "item"),
        label_cols=("label",), partition_rules=NCF_PARTITION_RULES,
        initial_variables=variables,
        config=JaxConfig(log_every_steps=1)).set_tensorboard(
            str(tmp_path / "ref"), app_name="myapp")
    ref.fit(data, epochs=1, batch_size=64)
    est = _est(params_from_flax(jax.tree_util.tree_map(
        np.asarray, variables["params"]))).set_tensorboard(
            str(tmp_path), app_name="myapp")
    est.fit(data, epochs=1, batch_size=64)
    want = _records(tmp_path / "ref" / "myapp" / "train.jsonl")
    got = _records(tmp_path / "myapp" / "train.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        [1, 2, 3, 4]
    assert [set(r) for r in got] == [set(r) for r in want]
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], rtol=_LOSS_RTOL)
    try:
        import torch.utils.tensorboard  # noqa: F401
        has_tb = True
    except Exception:
        has_tb = False
    if has_tb:
        assert glob.glob(str(tmp_path / "myapp" / "train" / "events.*"))


def _trace_names(root):
    traces = glob.glob(str(root / "**" / "*.trace.json.gz"),
                       recursive=True)
    assert traces, f"no profiler trace under {root}"
    with gzip.open(traces[0], "rt") as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def test_profiler_trace_captured(tmp_path):
    est = _est().set_profile(str(tmp_path / "prof"), start_step=2,
                             n_steps=2)
    est.fit(_data(), epochs=1, batch_size=64)
    names = _trace_names(tmp_path / "prof")
    # the traced steps' work: the towers' matmuls and the optimizer
    assert any("addmm" in n or "linear" in n for n in names), names
    assert any("Adam" in n for n in names), names
    with pytest.raises(RuntimeError, match="no profiler trace"):
        stop_profiler_trace()


def test_fault_injection_then_resume(tmp_path):
    """Crash after step 3: the checkpoint of step 3 was not written, so a
    fresh estimator resumes from step 2 and finishes."""
    ckpt = str(tmp_path / "ckpt")
    est = _est(checkpoint_dir=ckpt, checkpoint_every_steps=1,
               fault_inject_step=3)
    with pytest.raises(RuntimeError,
                       match="injected fault at step 3 "
                             r"\(TrainConfig.fault_inject_step\)"):
        est.fit(_data(), epochs=2, batch_size=64,
                checkpoint_trigger=SeveralIteration(1))
    assert latest_checkpoint(ckpt) == 2
    est2 = _est(checkpoint_dir=ckpt)
    est2.load_checkpoint(ckpt)
    assert est2._global_step == 2
    stats = est2.fit(_data(), epochs=1, batch_size=64)
    assert np.isfinite(stats[-1]["loss"])
    assert est2._global_step > 2


def test_profiler_not_leaked_on_fault(tmp_path):
    """A crash while tracing stops the trace, so a retry starts another
    (a second start while one runs raises)."""
    est = _est(fault_inject_step=3)
    est.set_profile(str(tmp_path / "p1"), start_step=1, n_steps=50)
    with pytest.raises(RuntimeError, match="injected fault"):
        est.fit(_data(), epochs=1, batch_size=64)
    est2 = _est().set_profile(str(tmp_path / "p2"), start_step=1,
                              n_steps=2)
    est2.fit(_data(), epochs=1, batch_size=64)     # must not raise
    assert _trace_names(tmp_path / "p2")
    start_profiler_trace(str(tmp_path / "p3"))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            start_profiler_trace(str(tmp_path / "p3"))
    finally:
        stop_profiler_trace()


class _Reg(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(1, 1)

    def forward(self, x, train: bool = False):
        return self.dense(x[:, None])[:, 0]


def _reg_est():
    torch.manual_seed(0)
    return Estimator.from_torch(
        model=_Reg(), loss="mse", optimizer=1e-2, feature_cols=("x",),
        label_cols=("y",), config=TrainConfig(
            debug_nans=True, deterministic=True, log_every_steps=1),
        device="cpu")


def test_debug_nans_raises_at_faulting_step():
    """Step 3's batch poisons the loss: the fit raises there, before the
    optimizer steps, so the parameters are those after step 2."""
    n, bs = 256, 64
    x = np.linspace(-1, 1, n).astype(np.float32)
    y = (2 * x).astype(np.float32)
    y[2 * bs:3 * bs] = np.nan
    est = _reg_est()
    with pytest.raises(FloatingPointError, match="NaN.* at step 3"):
        est.fit({"x": x, "y": y}, epochs=1, batch_size=bs)
    clean = _reg_est()
    clean.fit({"x": x[:2 * bs], "y": y[:2 * bs]}, epochs=1, batch_size=bs)
    for name, p in clean.model.state_dict().items():
        assert torch.equal(est.model.state_dict()[name], p), name
        assert torch.isfinite(p).all()
    # the mode sets no process-global flag
    assert not torch.is_anomaly_enabled()


def test_deterministic_data_order_reproducible():
    losses = []
    for _ in range(2):
        est = _est(deterministic=True)
        seen = []
        est.fit(_data(), epochs=1, batch_size=64,
                callbacks=[lambda s: seen.append(s["loss"])])
        losses.append(seen)
    assert losses[0] == losses[1]
