"""Tensor- and sequence-parallel training on the port: the Estimator with
the reference's partition rules on four gloo ranks
(``_torch_dist_worker.py`` scenario ``tptrain``, one launch for the
module), on a ``{"dp": 2, "tp": 2}`` mesh (A) and a ``{"sp": 2, "tp":
2}`` mesh (B, the models built with ``mesh=`` so the sequence splits),
against the JAX Estimator on its 8-device dp mesh on the same weights:

- BERT under ``BERT_PARTITION_RULES`` and the LM under
  ``LM_PARTITION_RULES`` (GPT-2 shape with MHA; Llama shape with rope,
  SwiGLU and an untied head, GQA with 4 query heads over 1 kv head, the
  ``KH % tp`` hatch, and over 2): SGD parameters (every leaf, whole)
  within 1e-5 of scale, and the hatch's Adam losses within 1e-5;
- tp=2 gradients of every parameter equal one rank's, and a planted
  fault (a column-parallel input without its backward all-reduce, a
  row-parallel sum through ``torch.distributed.nn.functional.
  all_reduce``) fails that hold;
- dropout on: tp=2 and sp=2 x tp=2 train what one rank trains (the
  port's masks, so not held to JAX);
- LoRA on dp2 x tp2 learns (``tests/test_lora.py::test_lora_on_tp_mesh``);
- a dp=4 checkpoint (Adam state included) restores onto sp2 x tp2 and
  back, and both go on training alike
  (``tests/test_checkpoint_reshape.py``);
- the flash path's gradients on each tp rank's heads equal the whole
  heads' (``tests/test_ops_flash.py`` sharded backward).
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
from analytics_zoo_tpu.models import BERT as JaxBERT
from analytics_zoo_tpu.models import \
    BERTForSequenceClassification as JaxCls
from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.models.lm import lm_loss as jax_lm_loss
from analytics_zoo_tpu_torch.models import lm as tlm
from analytics_zoo_tpu_torch.models import transformer as ttr
from analytics_zoo_tpu_torch.ops import flash_attention as fa

from _torch_dist import Ranks

_BERT = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=4,
             intermediate_size=64, max_position=64)
_GPT = dict(vocab_size=32, hidden_size=32, num_layers=1, num_heads=4,
            intermediate_size=64, max_position=16)
_LLAMA = dict(_GPT, pos_encoding="rope", norm="rmsnorm", mlp="swiglu",
              use_bias=False, tied_head=False)
_LMS = {"mha": _GPT, "gqa1": dict(_LLAMA, num_kv_heads=1),
        "gqa2": dict(_LLAMA, num_kv_heads=2)}
_FEATS = ("input_ids", "token_type_ids", "attention_mask")
_HOLD = 1e-5


def _seeded(model, sample, seed):
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0),
                                               *sample))["params"]
    rng = np.random.default_rng(seed)

    def one(path, a):
        x = 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return x + 1.0 if path[-1].key == "scale" else x
    return jax.tree_util.tree_map_with_path(one, shapes)


def _cls_data(n=24, T=16, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (n, T)).astype(np.int32)
    lens = rng.integers(T // 2, T + 1, n)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    split = rng.integers(2, T - 2, n)
    types = (np.arange(T)[None] >= split[:, None]).astype(np.int32)
    y = rng.integers(0, 3, n).astype(np.int32)
    return {"input_ids": ids, "token_type_ids": types,
            "attention_mask": mask, "y": y}


def _close(got, want, what, hold=_HOLD):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=hold * scale, rtol=0,
                               err_msg=what)


def _states_close(a, b, what, hold=_HOLD):
    assert set(a) == set(b), what
    for k in a:
        _close(a[k], b[k], f"{what}: {k}", hold)


def _jax_fit(model, params, data, cols, loss, opt, epochs):
    est = JaxEstimator.from_flax(
        model=model, loss=loss, optimizer=opt, initial_variables=params,
        config=JaxConfig(deterministic=True), feature_cols=cols[0],
        label_cols=cols[1])
    hist = est.fit(data, epochs=epochs, batch_size=8)
    return [h["loss"] for h in hist], jax.device_get(est.state.params)


@pytest.fixture(scope="module")
def tp(tmp_path_factory, devices):
    outdir = tmp_path_factory.mktemp("tptrain")
    cls_data = _cls_data()
    toks = np.random.default_rng(3).integers(0, 32, (16, 16)).astype(
        np.int32)
    jcls = JaxCls(num_classes=3, bert=JaxBERT(**_BERT, dtype=jnp.float32,
                                              dropout=0.0, use_flash=False))
    bert_params = _seeded(jcls, [cls_data[c][:2] for c in _FEATS], 1)
    jlms = {k: JaxLM(**c, dtype=jnp.float32, dropout=0.0, use_flash=False)
            for k, c in _LMS.items()}
    lm_params = {k: _seeded(m, [toks[:2]], 2 + i)
                 for i, (k, m) in enumerate(jlms.items())}
    g = np.random.default_rng(9)
    flash = {n: g.standard_normal((2, 16, 4, 16)).astype(np.float32)
             for n in "qkvg"}
    flash["mask"] = g.random((2, 16)) > 0.25
    torch.save({"bert_cfg": _BERT,
                "bert_state": ttr.params_from_flax(bert_params),
                "cls_data": cls_data, "lm_cfg": _LMS,
                "lm_state": {k: tlm.params_from_flax(p)
                             for k, p in lm_params.items()},
                "lm_data": {"tokens": toks}, "flash": flash},
               outdir / "tptrain_in.pt")
    ranks = Ranks("tptrain", outdir, 4)
    # the reference's runs while the ranks train
    init_orca_context("local", mesh_axes={"dp": 8})
    try:
        cls_cols = (_FEATS, ("y",))
        want = {("bert", "sgd"): _jax_fit(
            jcls, bert_params, cls_data, cls_cols,
            "sparse_categorical_crossentropy", optax.sgd(0.1), 1)}
        runs = [(k, "sgd", optax.sgd(0.1), 1) for k in jlms] + [
            ("gqa1", "adam", optax.adam(1e-3), 2)]
        for k, opt, tx, ep in runs:
            want[(k, opt)] = _jax_fit(
                jlms[k], lm_params[k], {"tokens": toks},
                (("tokens",), ("tokens",)), jax_lm_loss, tx, ep)
    finally:
        stop_orca_context()
    return ranks.wait(), want


@pytest.mark.parametrize("mesh", ["A", "B"])
def test_bert_estimator_matches_reference(tp, mesh):
    """BERT_PARTITION_RULES on dp2 x tp2 and on sp2 x tp2 (ring): the
    losses and every whole SGD parameter equal the JAX Estimator's, on
    every rank."""
    ranks, want = tp
    loss, params = want[("bert", "sgd")]
    wstate = ttr.params_from_flax(params)
    for r in ranks:
        got_loss, state = r[("bert", "sgd", mesh)]
        np.testing.assert_allclose(got_loss, loss, rtol=_HOLD)
        _states_close(state, wstate, f"bert sgd {mesh}")


@pytest.mark.parametrize("kind", sorted(_LMS))
@pytest.mark.parametrize("mesh", ["A", "B"])
def test_lm_estimator_matches_reference(tp, kind, mesh):
    """LM_PARTITION_RULES (the vocab-split embedding and untied head,
    GQA paired per rank, under sp the causal ring at global positions):
    the losses and whole SGD parameters equal the JAX Estimator's, and
    the hatch's Adam losses."""
    ranks, want = tp
    loss, params = want[(kind, "sgd")]
    wstate = tlm.params_from_flax(params)
    for r in ranks:
        got_loss, state = r[("lm", kind, "sgd", mesh)]
        np.testing.assert_allclose(got_loss, loss, rtol=_HOLD)
        _states_close(state, wstate, f"{kind} sgd {mesh}")
        if kind == "gqa1":
            np.testing.assert_allclose(r[("lm", kind, "adam", mesh)],
                                       want[(kind, "adam")][0], rtol=_HOLD)


def test_fused_loss_over_a_vocab_split_table(tp):
    """LMWithFusedLoss on dp2 x tp2 (each block's logits gathered over
    tp) trains what one rank trains."""
    for r in tp[0]:
        (l2, s2), (l1, s1) = r[("fused", "A")], r[("fused", "one")]
        np.testing.assert_allclose(l2, l1, rtol=_HOLD)
        _states_close(s2, s1, "fused loss")


@pytest.mark.parametrize("mesh", ["A", "B"])
def test_accum_evaluate_predict_equal_one_rank(tp, mesh):
    """accum_steps=2 trains what one rank trains; evaluate's weighted
    means and predict's rows (global order, on every rank) equal one
    rank's."""
    for r in tp[0]:
        (loss, state, ev, pred), (l1, s1, ev1, p1) = r[("accum", mesh)], \
            r[("accum", "one")]
        np.testing.assert_allclose(loss, l1, rtol=_HOLD)
        _states_close(state, s1, f"accum {mesh}")
        assert set(ev) == set(ev1)
        for k in ev:
            np.testing.assert_allclose(ev[k], ev1[k], rtol=_HOLD)
        assert pred.shape == (10, 3)
        _close(pred, p1, f"predict {mesh}")


def _worst(got, want):
    """The largest gap over every parameter, each in its own scale."""
    return max(float(np.abs(got[n].numpy() - want[n].numpy()).max())
               / max(1.0, float(np.abs(want[n].numpy()).max()))
               for n in want)


@pytest.mark.parametrize("kind", ["bert", "mha", "gqa1"])
def test_tp_gradients_equal_one_rank_and_faults_show(tp, kind):
    """Every parameter's tp=2 gradient (whole) equals one rank's; with
    either planted fault the hold is broken many times over."""
    ranks = tp[0]
    for r in ranks:
        one = r[("grads", kind, "tp1")]
        assert _worst(r[("grads", kind, "tp2")], one) < _HOLD
    for fault in ("copy_to_plain", "reduce_from_library"):
        worst = max(_worst(r[("grads", kind, fault)],
                           r[("grads", kind, "tp1")]) for r in ranks)
        assert worst > 100 * _HOLD, (fault, worst)


@pytest.mark.parametrize("model", ["bert", "lm"])
@pytest.mark.parametrize("mesh", ["tp2", "sp2tp2"])
def test_dropout_masks_are_global(tp, model, mesh):
    for r in tp[0]:
        loss, state = r[("dropout", model, mesh)]
        want_loss, want = r[("dropout", model, "one")]
        np.testing.assert_allclose(loss, want_loss, rtol=_HOLD)
        _states_close(state, want, f"dropout {model} {mesh}")


def test_lora_learns_on_dp_tp_mesh(tp):
    for r in tp[0]:
        losses, adapters, merged = r["lora"]
        assert losses[-1] < losses[0], losses
        assert all(torch.isfinite(t).all() for t in merged.values())
    first = tp[0][0]["lora"][1]
    for r in tp[0][1:]:
        for name, ab in r["lora"][1].items():
            for k in ab:
                assert torch.equal(ab[k], first[name][k]), name


def _opt_close(a, b, what):
    assert a["state"].keys() == b["state"].keys()
    for i in a["state"]:
        for k, v in a["state"][i].items():
            _close(v, b["state"][i][k], f"{what} {i} {k}", 1e-6)


def test_checkpoint_restores_onto_any_mesh(tp):
    """dp=4 -> sp2 x tp2: whole weights and Adam moments restored as
    saved; the next epoch's losses and weights equal; and back."""
    for r in tp[0]:
        dp_state, b_state, dp_opt, b_opt = r["ckpt_in"]
        _states_close(b_state, dp_state, "restored", 1e-6)
        _opt_close(b_opt, dp_opt, "restored")
        (l_dp, s_dp), (l_b, s_b) = r["ckpt_next"]
        np.testing.assert_allclose(l_b, l_dp, rtol=_HOLD)
        _states_close(s_b, s_dp, "next epoch")
        b_state, back, b_opt, back_opt = r["ckpt_back"]
        _states_close(back, b_state, "back", 1e-6)
        _opt_close(back_opt, b_opt, "back")


def test_flash_gradients_on_a_ranks_heads(tp):
    """Each tp rank's flash backward on its two of four heads, gathered,
    equals the whole heads' backward."""
    g = np.random.default_rng(9)
    q, k, v, dout = (torch.from_numpy(g.standard_normal(
        (2, 16, 4, 16)).astype(np.float32)) for _ in range(4))
    mask = torch.from_numpy(g.random((2, 16)) > 0.25)
    whole = [t.clone().requires_grad_() for t in (q, k, v)]
    (fa.flash_attention(*whole, mask, causal=True) * dout).sum().backward()
    for r in tp[0]:
        for name, got, w in zip("qkv", r["flash_mine"], whole):
            np.testing.assert_allclose(got.numpy(), w.grad.numpy(),
                                       atol=1e-6, rtol=1e-6, err_msg=name)
