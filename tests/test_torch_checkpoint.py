"""The port's Estimator checkpoints, auto-resume, exports and triggers.

The port's checkpoint format is its own (``torch.save`` of the model's
and the optimizer's ``state_dict``s, the step, the epoch and the dropout
seed, one ``ckpt_<step>`` directory a checkpoint), so the reference's
orbax checkpoints are not read here; the contract is held instead, on a
tiny ``BERTForSequenceClassification`` (f32, dropout 0.1, shuffled
batches) on the CPU:

- a checkpoint restores the model, the optimizer, the step, the epoch
  and the dropout seed bitwise;
- ``auto_resume`` after 2 of 4 epochs equals 4 epochs uninterrupted,
  losses and parameters bitwise (the same batches, the same masks, the
  same optimizer state);
- ``keep_checkpoints`` keeps the newest, ``checkpoint_every_steps``
  and ``checkpoint_trigger`` set the cadence;
- ``save``/``load`` and ``get_model``;
- the triggers copied from the reference decide as the reference's on
  the same states (the module is also pinned by its syntax tree in
  ``tests/test_torch_serving_pins.py``).
"""

import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.learn import triggers as jax_triggers
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn import triggers
from analytics_zoo_tpu_torch.learn.estimator import (checkpoint_steps,
                                                     latest_checkpoint)
from analytics_zoo_tpu_torch.models.transformer import (
    BERT, BERTForSequenceClassification)

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64)
_FEATS = ("input_ids", "token_type_ids", "attention_mask")


def _data(n=24, T=12, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, T + 1, n)
    return {"input_ids": rng.integers(0, 128, (n, T)).astype(np.int32),
            "token_type_ids": (np.arange(T)[None] >= lens[:, None] // 2
                               ).astype(np.int32),
            "attention_mask": (np.arange(T)[None] < lens[:, None]
                               ).astype(np.int32),
            "y": rng.integers(0, 2, n).astype(np.int32)}


def _est(ckpt=None, **cfg):
    torch.manual_seed(0)
    model = BERTForSequenceClassification(
        2, BERT(**TINY, dtype=torch.float32, dropout=0.1))
    return Estimator.from_torch(
        model=model, loss="sparse_categorical_crossentropy",
        optimizer=3e-3, feature_cols=_FEATS, label_cols=("y",),
        config=TrainConfig(checkpoint_dir=ckpt, seed=7, **cfg),
        device="cpu")


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n


def test_checkpoint_round_trip(tmp_path):
    est = _est(str(tmp_path))
    est.fit(_data(), epochs=1, batch_size=8)
    assert checkpoint_steps(str(tmp_path)) == [3]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3"]
    fresh = _est()
    with pytest.raises(FileNotFoundError):
        fresh.load_checkpoint(str(tmp_path / "none"))
    fresh.load_checkpoint(str(tmp_path))
    _same_state(est.model, fresh.model)
    opt_a, opt_b = est.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert opt_a["param_groups"] == opt_b["param_groups"]
    for k, s in opt_a["state"].items():
        for name, v in s.items():
            assert torch.equal(v, opt_b["state"][k][name]), (k, name)
    assert (fresh._global_step, fresh._epoch, fresh._seed) == (3, 1, 7)


def test_auto_resume_equals_uninterrupted(tmp_path):
    data = _data()
    whole = _est()
    ref = whole.fit(data, epochs=4, batch_size=8)
    first = _est(str(tmp_path))
    part = first.fit(data, epochs=2, batch_size=8, auto_resume=True)
    # a new process: a fresh model and optimizer, the same directory
    again = _est(str(tmp_path))
    rest = again.fit(data, epochs=4, batch_size=8, auto_resume=True)
    assert len(part) == len(rest) == 2
    assert [h["loss"] for h in part + rest] == [h["loss"] for h in ref]
    _same_state(whole.model, again.model)
    assert (again._global_step, again._epoch) == (12, 4)
    # everything done: nothing more to train
    assert _est(str(tmp_path)).fit(data, epochs=4, batch_size=8,
                                   auto_resume=True) == []


def test_auto_resume_needs_a_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _est().fit(_data(), epochs=1, batch_size=8, auto_resume=True)


def test_keep_checkpoints_and_every_steps(tmp_path):
    est = _est(str(tmp_path), checkpoint_every_steps=2, keep_checkpoints=2)
    est.fit(_data(), epochs=2, batch_size=8)
    # saves at steps 2, 3 (epoch end), 4, 6 (both); the two newest stay
    assert checkpoint_steps(str(tmp_path)) == [4, 6]
    assert latest_checkpoint(str(tmp_path)) == 6
    assert latest_checkpoint(str(tmp_path / "none")) is None


def test_checkpoint_trigger(tmp_path):
    est = _est(str(tmp_path), keep_checkpoints=10)
    est.fit(_data(), epochs=2, batch_size=8,
            checkpoint_trigger=triggers.SeveralIteration(4))
    assert checkpoint_steps(str(tmp_path)) == [4]
    est.fit(_data(), epochs=1, batch_size=8,
            checkpoint_trigger=triggers.MaxEpoch(3) & triggers.EveryEpoch())
    assert checkpoint_steps(str(tmp_path)) == [4, 9]


def test_save_load_and_get_model(tmp_path):
    est = _est()
    est.fit(_data(), epochs=1, batch_size=8)
    est.save(str(tmp_path / "export"))
    fresh = _est()
    fresh.load(str(tmp_path / "export"))
    _same_state(est.model, fresh.model)
    model, state = fresh.get_model()
    assert model is fresh.model and set(state) == set(
        est.model.state_dict())
    np.testing.assert_array_equal(fresh.predict(_data()),
                                  est.predict(_data()))


@pytest.mark.parametrize("field,value", [
    ("checkpoint_dir", "ckpt"), ("checkpoint_every_steps", 5),
    ("keep_checkpoints", 1)])
def test_checkpoint_config_fields_are_ported(tmp_path, field, value):
    if field == "checkpoint_dir":
        value = str(tmp_path / value)
    est = Estimator.from_torch(model=torch.nn.Linear(2, 2),
                               config=TrainConfig(**{field: value}),
                               device="cpu")
    x = np.ones((4, 2), np.float32)
    assert np.isfinite(est.fit({"x": x, "y": x}, batch_size=2)[0]["loss"])


_STATES = [{"step": s, "epoch": e, "epoch_end": end,
            "metrics": {"loss": loss, "accuracy": acc}}
           for s, e, end, loss, acc in (
               (0, 0, False, 2.0, 0.1), (3, 0, False, 1.5, 0.4),
               (4, 1, True, 0.9, 0.6), (8, 2, True, 0.4, 0.95),
               (9, 2, False, 0.3, 0.97))]


def _make(mod):
    return [mod.EveryEpoch(), mod.SeveralIteration(4),
            mod.MaxIteration(8), mod.MaxEpoch(2), mod.MinLoss(0.5),
            mod.MaxScore("accuracy", 0.9),
            mod.SeveralIteration(4) & mod.EveryEpoch(),
            mod.MinLoss(1.0) | mod.MaxIteration(3)]


def test_triggers_decide_as_the_reference():
    for ours, ref in zip(_make(triggers), _make(jax_triggers)):
        assert [ours(s) for s in _STATES] == [ref(s) for s in _STATES]
    stats = [{"epoch": i, "val_loss": v}
             for i, v in enumerate((1.0, 0.8, 0.85, 0.9, 0.7))]
    ours = triggers.EarlyStopping(patience=2)
    ref = jax_triggers.EarlyStopping(patience=2)
    assert [ours(s) for s in stats] == [ref(s) for s in stats]
    assert (ours.best, ours.stopped_epoch) == (ref.best, ref.stopped_epoch)


def test_early_stopping_stops_a_fit():
    est = _est()
    stop = triggers.EarlyStopping(monitor="loss", patience=1,
                                  min_delta=1e9)
    hist = est.fit(_data(), epochs=5, batch_size=8, callbacks=[stop])
    assert len(hist) == 2 and stop.stopped_epoch == 2
