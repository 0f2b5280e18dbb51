"""The port's BERT family, dropout and remat held to the JAX package.

The reference's ``TINY`` BERT (vocab 128, hidden 32, 2 layers, 4 heads,
FFN 64) in f32 on the CPU: the JAX module initialises the weights (moved
off their init by seeded noise, so norm scales and biases are not 1/0),
``params_from_flax`` carries them into the port's module, and the same
numpy inputs (two token-type segments, a key mask with a fully padded
row) go through both.  The JAX side runs plain attention
(``use_flash=False``), as ``tests/test_transformer.py`` holds it to the
Pallas kernel.

- ``BERT``, both heads and ``qa_loss`` within 1e-5 (absolute; f32 sums
  in another order).
- A ``BERTForSequenceClassification`` fit at dropout 0 through the
  port's ``Estimator.from_torch`` against ``Estimator.from_flax`` on
  the 8-device CPU mesh: SGD losses (rtol 1e-5) and every parameter
  (atol 1e-5), AdamW with decay 1e-4 losses (rtol 1e-5).
- Dropout: the masks are not threefry's, so the contract is held
  (kept share within 0.01 of 1 - p over 2**20 draws, kept values
  scaled by 1 / (1 - p) exactly, the same seed the same mask, another
  seed another, ``train=False`` identity, the Estimator's seed a
  function of (config.seed, step)).
- Remat: remat on equals remat off at dropout 0.1, in losses and
  gradients, exactly (the recompute draws the same masks from the same
  seeds; on the CPU the arithmetic is the same).
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
    BERTForQuestionAnswering as JaxQA
from analytics_zoo_tpu.models import \
    BERTForSequenceClassification as JaxCls
from analytics_zoo_tpu.models import qa_loss as jax_qa_loss
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.models.lm import TransformerLM, lm_loss
from analytics_zoo_tpu_torch.models.transformer import (
    BERT, BERTForQuestionAnswering, BERTForSequenceClassification, dropout,
    fold_in, params_from_flax, qa_loss)
from analytics_zoo_tpu_torch.parallel.mesh import Mesh

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64)
_T = 16
_ATOL = 1e-5            # forward outputs, f32
_LOSS_RTOL = 1e-5       # fit losses, f32, a few steps
_PARAM_ATOL = 1e-5      # SGD parameters
_FEATS = ("input_ids", "token_type_ids", "attention_mask")


def _inputs(B=4, T=_T, seed=0):
    """ids, two token-type segments and a right-padded mask whose last
    row is fully padded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (B, T)).astype(np.int32)
    lens = rng.integers(T // 2, T + 1, B)
    lens[-1] = 0
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    split = rng.integers(2, T - 2, B)
    types = (np.arange(T)[None] >= split[:, None]).astype(np.int32)
    return ids, types, mask


def _noisy(params, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)


def _jax_bert(dropout_p=0.0):
    return JaxBERT(**TINY, dtype=jnp.float32, dropout=dropout_p,
                   use_flash=False)


def _port_bert(dropout_p=0.0, **kw):
    return BERT(**TINY, dtype=torch.float32, dropout=dropout_p,
                use_flash=False, **kw)


_KINDS = {
    "bert": (lambda: _jax_bert(), lambda: _port_bert()),
    "classifier": (lambda: JaxCls(num_classes=3, bert=_jax_bert()),
                   lambda: BERTForSequenceClassification(3, _port_bert())),
    "qa": (lambda: JaxQA(bert=_jax_bert()),
           lambda: BERTForQuestionAnswering(_port_bert())),
}


def _pair(kind, seed=0):
    jmk, tmk = _KINDS[kind]
    jm = jmk()
    ids, types, mask = _inputs()
    params = _noisy(jm.init(jax.random.key(seed), ids, types,
                            mask)["params"])
    tm = tmk()
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_forward_matches_jax(kind):
    jm, params, tm = _pair(kind)
    ids, types, mask = _inputs()
    want = jm.apply({"params": params}, ids, types, mask)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (ids, types, mask)))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=_ATOL,
                                   rtol=0)


def test_forward_without_optional_inputs_matches_jax():
    """No token types and no mask: type 0 everywhere, every key live."""
    jm, params, tm = _pair("bert")
    ids = _inputs()[0]
    seq, pooled = jm.apply({"params": params}, ids)
    with torch.no_grad():
        tseq, tpooled = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(tseq.numpy(), np.asarray(seq), atol=_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled),
                               atol=_ATOL, rtol=0)


def test_qa_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((5, _T, 2)).astype(np.float32) * 3
    start = rng.integers(0, _T, 5).astype(np.int32)
    end = rng.integers(0, _T, 5).astype(np.int32)
    want = float(jax_qa_loss(jnp.asarray(logits), (start, end)))
    got = qa_loss(torch.from_numpy(logits),
                  (torch.from_numpy(start), torch.from_numpy(end)))
    assert got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_flash_branch_equals_plain_on_cpu():
    """``use_flash=True`` takes ``flash_attention`` (on a CPU tensor its
    plain version, the function the CUDA kernel computes, with its
    autograd Function); it must equal the plain full attention in
    outputs and gradients, the fully padded row included."""
    _, params, plain = _pair("qa")
    flash = BERTForQuestionAnswering(BERT(**TINY, dtype=torch.float32,
                                          dropout=0.0, use_flash=True))
    flash.load_state_dict(plain.state_dict())
    feats = [torch.from_numpy(a) for a in _inputs()]
    outs = []
    for m in (plain, flash):
        m.zero_grad()
        out = m(*feats, train=True)
        out.square().sum().backward()
        # the pooler feeds no QA logit, so it gets no gradient
        outs.append((out.detach(), {n: p.grad.clone()
                                    for n, p in m.named_parameters()
                                    if p.grad is not None}))
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(),
                               atol=_ATOL, rtol=0)
    assert set(outs[0][1]) == set(outs[1][1])
    for n, g in outs[0][1].items():
        np.testing.assert_allclose(outs[1][1][n].numpy(), g.numpy(),
                                   atol=_ATOL, rtol=1e-5, err_msg=n)


@pytest.fixture()
def mesh8():
    init_orca_context("local", mesh_axes={"dp": 8})
    yield
    stop_orca_context()


def _cls_data(n=24, seed=5):
    ids, types, mask = _inputs(B=n, seed=seed)
    y = np.random.default_rng(seed).integers(0, 3, n).astype(np.int32)
    return {"input_ids": ids, "token_type_ids": types,
            "attention_mask": mask, "y": y}


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_classifier_fit_matches_jax(mesh8, opt):
    """Dropout 0, deterministic order: the same losses; under SGD the
    same parameters."""
    jm, params, tm = _pair("classifier")
    data = _cls_data()
    jopt, topt = {
        "sgd": (optax.sgd(0.1), lambda ps: torch.optim.SGD(ps, lr=0.1)),
        "adamw": (optax.adamw(1e-3),
                  lambda ps: torch.optim.AdamW(ps, lr=1e-3,
                                               weight_decay=1e-4)),
    }[opt]
    cols = dict(feature_cols=_FEATS, label_cols=("y",))
    jest = JaxEstimator.from_flax(
        model=jm, loss="sparse_categorical_crossentropy", optimizer=jopt,
        initial_variables=params, config=JaxConfig(deterministic=True),
        **cols)
    ref = jest.fit(data, epochs=2, batch_size=8)
    test = Estimator.from_torch(
        model=tm, loss="sparse_categorical_crossentropy", optimizer=topt,
        config=TrainConfig(deterministic=True), device="cpu", **cols)
    got = test.fit(data, epochs=2, batch_size=8)
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


def test_dropout_contract():
    x = torch.ones(1 << 20)
    y = dropout(x, 0.1, 7, train=True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.9))
    assert torch.equal(dropout(x, 0.1, 7, train=True), y)
    assert not torch.equal(dropout(x, 0.1, 8, train=True), y)
    assert dropout(x, 0.1, None, train=False) is x
    assert dropout(x, 0.0, None, train=True) is x
    assert not dropout(x, 1.0, 7, train=True).any()
    with pytest.raises(ValueError, match="rng"):
        dropout(x, 0.1, None, train=True)
    # the seeds: a function of (seed, data), different for each
    assert fold_in(0, 1) == fold_in(0, 1)
    assert len({fold_in(s, d) for s in range(4) for d in range(64)}) == 256
    assert all(0 <= fold_in(s, 3) < 2 ** 63 for s in (0, -1, 2 ** 70))


def test_bert_dropout_masks_follow_the_seed():
    """A training forward at dropout 0.1 repeats itself for one seed,
    changes with the seed, and ``train=False`` equals dropout 0."""
    tm = BERTForSequenceClassification(3, _port_bert(0.1))
    feats = [torch.from_numpy(a) for a in _inputs()]
    with torch.no_grad():
        a = tm(*feats, train=True, rng=11)
        b = tm(*feats, train=True, rng=11)
        c = tm(*feats, train=True, rng=12)
        ev = tm(*feats)
        tm.bert.dropout = 0.0
        for layer in tm.bert.layers:
            layer.dropout = 0.0
        ref = tm(*feats, train=True, rng=11)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(ev, ref) and not torch.equal(a, ref)


def _grads(model, feats, loss_fn, rng):
    model.zero_grad()
    loss = loss_fn(model(*feats, train=True, rng=rng))
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def test_bert_remat_equals_no_remat_at_dropout():
    base = BERTForSequenceClassification(3, _port_bert(0.1))
    remat = BERTForSequenceClassification(3, _port_bert(0.1, remat=True))
    remat.load_state_dict(base.state_dict())
    feats = [torch.from_numpy(a) for a in _inputs()]
    y = torch.tensor([0, 1, 2, 1])

    def loss_fn(logits):
        return torch.nn.functional.cross_entropy(logits, y)

    for rng in (3, 4):
        l0, g0 = _grads(base, feats, loss_fn, rng)
        l1, g1 = _grads(remat, feats, loss_fn, rng)
        assert torch.equal(l0, l1)
        for n in g0:
            assert torch.equal(g0[n], g1[n]), n


_LM = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_position=16)


def _lm_fit(seed=0, **kw):
    torch.manual_seed(0)
    tm = TransformerLM(dtype=torch.float32, **_LM, **kw)
    toks = np.random.default_rng(1).integers(0, 32, (16, 12)).astype(
        np.int32)
    est = Estimator.from_torch(
        model=tm, loss=lm_loss, optimizer=3e-3, feature_cols=("tokens",),
        label_cols=("tokens",), config=TrainConfig(seed=seed),
        device="cpu")
    hist = est.fit({"tokens": toks}, epochs=2, batch_size=4)
    return [h["loss"] for h in hist], est.model.state_dict()


def test_lm_dropout_and_remat_train():
    """``TransformerLM(dropout>0, remat=True)`` trains through the
    Estimator: the step seeds make a fit repeat itself, remat changes
    nothing (losses and parameters equal), another ``config.seed``
    draws other masks, and dropout 0.1 differs from dropout 0."""
    ref, ref_state = _lm_fit(dropout=0.1)
    again, _ = _lm_fit(dropout=0.1)
    remat, remat_state = _lm_fit(dropout=0.1, remat=True)
    other, _ = _lm_fit(seed=1, dropout=0.1)
    plain, _ = _lm_fit()
    assert np.isfinite(ref).all() and ref[1] < ref[0]
    assert ref == again == remat
    for n, w in ref_state.items():
        assert torch.equal(remat_state[n], w), n
    assert other != ref and plain != ref


def test_lm_dropout_in_a_training_forward_needs_a_seed():
    tm = TransformerLM(dtype=torch.float32, dropout=0.1, **_LM)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="rng"):
        tm(toks, train=True)
    with torch.no_grad():
        assert torch.equal(tm(toks), tm(toks, train=False, rng=5))


@pytest.mark.parametrize("kw,item", [
    (dict(moe_experts=4), "item 2"),
    (dict(mesh=Mesh({"dp": 1, "sp": 1, "tp": 1}, "cpu")), None),
    (dict(sp_strategy="ulysses"), None)],
    ids=["moe_experts", "mesh", "sp_strategy"])
def test_unported_bert_options_raise(kw, item):
    """MoE layers still raise; a mesh and the ulysses strategy are
    ported: on one rank they give the plain BERT's outputs."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            BERT(**TINY, **kw)
        return
    _, _, tm = _pair("bert")
    other = _port_bert(**kw)
    other.load_state_dict(tm.state_dict())
    ids, types, mask = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        for a, b in zip(other(ids, types, mask), tm(ids, types, mask)):
            assert torch.equal(a, b)
