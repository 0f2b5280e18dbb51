"""The port's text path against the JAX package: ``TextSet`` and
``load_glove`` (``data/text.py``), ``TextClassifier`` and ``KNRM``
(``models/text.py``), the taggers of ``tfpark/text/keras.py`` and the
estimators of ``tfpark/text``.

Weights are seeded normals in the reference's tree;
``params_from_flax`` carries them into the port.  Tolerances: the f32
forward and losses within 1e-5; Estimator fits (f32, deterministic
order) within 1e-5: SGD parameters, Adam losses relative.  The
estimators build bf16 models with dropout, so the fits swap in f32
models on both sides and take dropout out (the port's masks are not
threefry's; its dropout contract is held in ``test_torch_bert.py``).
"""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu.models.text as jtext
import analytics_zoo_tpu.tfpark.text as jtfpark
import analytics_zoo_tpu_torch.models.text as ttext
import analytics_zoo_tpu_torch.tfpark.text as ttfpark
import analytics_zoo_tpu_torch.tfpark.text.keras as tkeras
from analytics_zoo_tpu import init_orca_context, stop_orca_context
from analytics_zoo_tpu.common.config import TrainConfig as JaxConfig
from analytics_zoo_tpu.data.text import TextSet as JaxTextSet
from analytics_zoo_tpu.data.text import load_glove as jax_load_glove
from analytics_zoo_tpu.learn.objectives import \
    binary_crossentropy as jax_bce
from analytics_zoo_tpu.tfpark.text import keras as jkeras
from analytics_zoo_tpu.tfpark.text import token_accuracy as jax_token_acc
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.data.text import TextSet, load_glove
from analytics_zoo_tpu_torch.learn.objectives import binary_crossentropy
from analytics_zoo_tpu_torch.models.layers import params_from_flax
from analytics_zoo_tpu_torch.tfpark.text import token_accuracy

_ATOL = 1e-5
_LOSS_RTOL = 1e-5
_PARAM_ATOL = 1e-5

VOCAB = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliett", "kilo", "lima"]


def _params(jm, *args, seed=3):
    """Seeded normal weights (std 0.3) in the reference's tree: its
    shapes come from tracing ``init`` (nothing is compiled)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), *args)["params"]
    return jax.tree_util.tree_map(
        lambda s: 0.3 * rng.standard_normal(s.shape).astype(np.float32),
        shapes)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---- TextSet and GloVe ------------------------------------------------

_TEXTS = ["The cat sat on the mat.", "Dogs and cats; cats and DOGS!",
          "don't stop, won't stop", "a b c d e f g h i j", "",
          "zebra", "mat mat cat cat dog"]


def _stages(cls, case):
    ts = cls.from_texts(_TEXTS, [i % 3 for i in range(len(_TEXTS))],
                        num_shards=2).tokenize()
    if case == "sparse_index":
        ts = ts.word2idx(existing_index={"cat": 2, "mat": 40, "dogs": 7})
    elif case == "topn":
        ts = ts.word2idx(remove_topn=1, max_words_num=5)
    else:
        ts = ts.word2idx()
    trunc = "post" if case == "post" else "pre"
    return ts, ts.shape_sequence(4 if case in ("pre", "post") else 6,
                                 trunc_mode=trunc)


@pytest.mark.parametrize("case", ["ties", "sparse_index", "topn", "pre",
                                  "post"])
def test_textset_stages_match_jax(case):
    jraw, jts = _stages(JaxTextSet, case)
    traw, tts = _stages(TextSet, case)
    assert tts.word_index == jts.word_index
    assert list(tts.word_index) == list(jts.word_index)   # tie order
    assert tts.vocab_size() == jts.vocab_size()
    want, got = jts.to_numpy_dict(), tts.to_numpy_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    if case == "sparse_index":
        assert tts.vocab_size() == 41


def test_load_glove_matches_jax(tmp_path):
    path = tmp_path / "glove.4d.txt"
    path.write_text("cat 0.1 0.2 0.3 0.4\n"
                    "mat 1 2 3 4\n"
                    "broken 1 2\n"                       # malformed
                    "unindexed 5 5 5 5\n"
                    "dogs -1 -2 -3 -4\n", encoding="utf-8")
    index = TextSet.from_texts(_TEXTS).tokenize().word2idx().word_index
    got, hits = load_glove(str(path), index, 4)
    want, whits = jax_load_glove(str(path), index, 4)
    assert hits == whits == 3
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got[0].any()                               # pad row


# ---- the models -------------------------------------------------------

def _tokens(B, T, vocab, seed, pad_rows=(), pad_from=None):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, vocab, (B, T)).astype(np.int32)
    if pad_from is not None:
        t[0, pad_from:] = 0
    for r in pad_rows:
        t[r] = 0
    return t


def _case(kind):
    """(jax model, port model, positional inputs)."""
    f32, tf32 = jnp.float32, torch.float32
    if kind.startswith("classifier"):
        enc = kind.split(":")[1]
        kw = dict(class_num=4, vocab_size=30, token_length=12,
                  sequence_length=9, encoder=enc, encoder_output_dim=8)
        return (jtext.TextClassifier(**kw, dtype=f32),
                ttext.TextClassifier(**kw, dtype=tf32),
                (_tokens(3, 9, 30, 0, pad_from=5),))
    if kind.startswith("knrm"):
        mode = kind.split(":")[1]
        kw = dict(vocab_size=20, text1_length=4, text2_length=7,
                  embed_dim=8, kernel_num=5, target_mode=mode)
        t1 = _tokens(4, 4, 20, 1, pad_rows=(3,), pad_from=2)
        t2 = _tokens(4, 7, 20, 2, pad_from=3)
        t2[1, :2] = t1[1, :2]                       # exact matches
        return (jtext.KNRM(**kw, dtype=f32), ttext.KNRM(**kw, dtype=tf32),
                (t1, t2))
    kw = dict(vocab_size=15, embed_dim=6, hidden=5)
    toks = _tokens(3, 7, 15, 3, pad_rows=(2,), pad_from=4)
    if kind == "ner":
        return (jkeras.NER(**kw, num_entities=3, dtype=f32),
                tkeras.NER(**kw, num_entities=3, dtype=tf32), (toks,))
    if kind == "pos":
        return (jkeras.POSTagger(**kw, num_pos_tags=4, dtype=f32),
                tkeras.POSTagger(**kw, num_pos_tags=4, dtype=tf32), (toks,))
    assert kind == "intent_entity"
    return (jkeras.IntentEntity(**kw, num_intents=2, num_entities=3,
                                dtype=f32),
            tkeras.IntentEntity(**kw, num_intents=2, num_entities=3,
                                dtype=tf32), (toks,))


_KINDS = ["classifier:cnn", "classifier:lstm", "classifier:gru",
          "knrm:ranking", "knrm:classification", "ner", "pos",
          "intent_entity"]


@pytest.mark.parametrize("kind", _KINDS)
def test_forward_matches_jax(kind):
    jm, tm, args = _case(kind)
    params = _params(jm, *args)
    sd = params_from_flax(params)
    assert set(sd) == set(tm.state_dict())      # every parameter named
    tm.load_state_dict(sd)
    want = jax.jit(jm.apply)({"params": params}, *args)
    with torch.no_grad():
        got = tm(*map(_t, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    # IntentEntity's fully padded row pools to -1e9, so its intent
    # logits (~1e9) are held to 1e-6 relative, a few f32 ulps
    rtol = 1e-6 if kind == "intent_entity" else 0
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=_ATOL,
                                   rtol=rtol)
    if kind == "intent_entity":
        # the fully padded row pools to -1e9 before the intent head
        assert float(got[0][2].abs().max()) > 1e6


def test_birnn_cells_keep_the_reference_names():
    assert {"birnn.GRUCell_0.i.weight", "birnn.GRUCell_1.i.weight"} <= \
        set(tkeras.NER(15, embed_dim=6, hidden=5).state_dict())


def test_embed_weights_copied_and_checked():
    w = np.random.default_rng(0).standard_normal((30, 12)).astype(
        np.float32)
    m = ttext.TextClassifier(4, 30, token_length=12, embed_weights=w)
    np.testing.assert_array_equal(m.word_embedding.weight.detach(), w)
    assert m.word_embedding.weight.requires_grad
    w[0, 0] = 5.0                            # a copy, not an alias
    assert float(m.word_embedding.weight[0, 0].detach()) != 5.0
    with pytest.raises(ValueError, match=r"\(30, 12\) != expected "
                                         r"\(31, 12\)"):
        ttext.TextClassifier(4, 31, token_length=12, embed_weights=w)
    with pytest.raises(ValueError, match="unknown encoder"):
        ttext.TextClassifier(4, 30, encoder="rnn")


def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(5)
    il = rng.standard_normal((4, 3)).astype(np.float32)
    el = rng.standard_normal((4, 6, 5)).astype(np.float32)
    iy = rng.integers(0, 3, 4).astype(np.int32)
    ey = rng.integers(0, 5, (4, 6)).astype(np.int32)
    got = tkeras.intent_entity_loss((_t(il), _t(el)), (_t(iy), _t(ey)))
    want = jax.jit(jkeras.intent_entity_loss)((il, el), (iy, ey))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        float(token_accuracy(_t(el), _t(ey))),
        float(jax.jit(jax_token_acc)(el, ey)), rtol=1e-6)
    # binary cross-entropy broadcasts as optax's: [B, 1] logits against
    # [B] labels score every logit against every label
    logits = rng.standard_normal((5, 1)).astype(np.float32)
    y = rng.integers(0, 2, 5).astype(np.int32)
    for labels in (y, y[:, None]):
        np.testing.assert_allclose(
            float(binary_crossentropy(_t(logits), _t(labels))),
            float(jax.jit(jax_bce)(logits, labels)), rtol=1e-6)


# ---- the estimators ---------------------------------------------------

@pytest.fixture()
def mesh8():
    init_orca_context("local", mesh_axes={"dp": 8})
    yield
    stop_orca_context()


class _NoDropoutNN:
    """``flax.linen`` with every ``nn.Dropout`` at rate 0."""

    def __getattr__(self, name):
        return getattr(flax.linen, name)

    @staticmethod
    def Dropout(rate, **kw):
        return flax.linen.Dropout(0.0, **kw)


def _class_texts(n=48, seed=0):
    """Label 1 iff the text holds 'alpha' (the reference test's task)."""
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for _ in range(n):
        words = list(rng.choice(VOCAB[1:], size=6))
        y = int(rng.random() < 0.5)
        if y:
            words[rng.integers(0, len(words))] = "alpha"
        texts.append(" ".join(words))
        labels.append(y)
    return texts, labels


def _knrm_pairs(cls, n=48, seed=1):
    rng = np.random.default_rng(seed)
    q_texts, d_texts, labels = [], [], []
    for _ in range(n):
        q = list(rng.choice(VOCAB, size=4, replace=False))
        y = int(rng.random() < 0.5)
        d = q * 2 if y else list(rng.choice(
            [w for w in VOCAB if w not in q], size=8))
        q_texts.append(" ".join(q))
        d_texts.append(" ".join(d))
        labels.append(y)
    index = cls.from_texts(q_texts + d_texts).tokenize().word2idx() \
        .word_index
    qs = cls.from_texts(q_texts, labels).tokenize().word2idx(
        existing_index=index).shape_sequence(4)
    ds = cls.from_texts(d_texts).tokenize().word2idx(
        existing_index=index).shape_sequence(8)
    return qs, ds


def _fit_case(kind, monkeypatch):
    """(jax estimator class + kwargs, port's, jax data, port data, the
    jax model for the initial weights and its inputs)."""
    f32, tf32 = jnp.float32, torch.float32
    if kind == "classifier":
        monkeypatch.setattr(jtext, "nn", _NoDropoutNN())
        monkeypatch.setattr(ttext, "dropout", lambda x, p, rng, train: x)
        monkeypatch.setattr(jtext, "TextClassifier", functools.partial(
            jtext.TextClassifier, dtype=f32))
        monkeypatch.setattr(ttext, "TextClassifier", functools.partial(
            ttext.TextClassifier, dtype=tf32))
        texts, labels = _class_texts()
        jd = JaxTextSet.from_texts(texts, labels).tokenize().word2idx() \
            .shape_sequence(8)
        td = TextSet.from_texts(texts, labels).tokenize().word2idx() \
            .shape_sequence(8)
        kw = dict(class_num=2, vocab_size=td.vocab_size(), token_length=8,
                  sequence_length=8, encoder="cnn", encoder_output_dim=6)
        jm = jtext.TextClassifier(**kw)
        return (jtfpark.TextClassificationEstimator, kw,
                ttfpark.TextClassificationEstimator, kw, jd, td, jm,
                (jd.to_numpy_dict()["tokens"][:2],))
    if kind == "ner":
        nodrop = dict(dtype=f32, dropout=0.0)
        monkeypatch.setattr(jtfpark, "NER", functools.partial(
            jkeras.NER, **nodrop))
        monkeypatch.setattr(ttfpark, "NER", functools.partial(
            tkeras.NER, dtype=tf32, dropout=0.0))
        rng = np.random.default_rng(2)
        toks = rng.integers(0, 12, size=(48, 6)).astype(np.int32)
        data = {"tokens": toks, "y": (toks % 3).astype(np.int32)}
        kw = dict(num_entities=3, vocab_size=12, embed_dim=6, hidden=5)
        jm = jkeras.NER(vocab_size=12, embed_dim=6, hidden=5,
                        num_entities=3, **nodrop)
        return (jtfpark.NEREstimator, kw, ttfpark.NEREstimator, kw, data,
                data, jm, (toks[:2],))
    assert kind == "knrm"
    monkeypatch.setattr(jtext, "KNRM", functools.partial(jtext.KNRM,
                                                         dtype=f32))
    monkeypatch.setattr(ttext, "KNRM", functools.partial(ttext.KNRM,
                                                         dtype=tf32))
    jd, td = _knrm_pairs(JaxTextSet), _knrm_pairs(TextSet)
    kw = dict(vocab_size=td[0].vocab_size(), text1_length=4,
              text2_length=8, embed_dim=6, kernel_num=5)
    jm = jtext.KNRM(**kw)
    a, b = jd[0].to_numpy_dict(), jd[1].to_numpy_dict()
    return (jtfpark.KNRMEstimator, kw, ttfpark.KNRMEstimator, kw, jd, td,
            jm, (a["tokens"][:2], b["tokens"][:2]))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("kind", ["classifier", "ner", "knrm"])
def test_estimator_fit_matches_jax(mesh8, monkeypatch, kind, opt):
    """The same weights, data order and optimizer: the same losses, and
    under SGD the same parameters; KNRM's evaluate on the TextSet pair
    (``[B, 1]`` logits against ``[B]`` labels) too."""
    jcls, jkw, tcls, tkw, jdata, tdata, jm, init_args = _fit_case(
        kind, monkeypatch)
    params = _params(jm, *init_args, seed=4)
    jopt, topt = {
        "sgd": (optax.sgd(0.1), lambda ps: torch.optim.SGD(ps, lr=0.1)),
        "adam": (optax.adam(1e-2), 1e-2),
    }[opt]
    jest = jcls(**jkw, optimizer=jopt, initial_variables=params,
                config=JaxConfig(deterministic=True))
    ref = jest.fit(jdata, epochs=2, batch_size=16)
    test = tcls(**tkw, optimizer=topt, initial_variables=params_from_flax(
        params), config=TrainConfig(deterministic=True), device="cpu")
    got = test.fit(tdata, epochs=2, batch_size=16)
    assert set(got[0]) == set(ref[0])
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in ref], rtol=_LOSS_RTOL)
    if opt == "sgd":
        want = params_from_flax(jax.device_get(jest.estimator.state.params))
        have = test.model.state_dict()
        assert set(want) == set(have)
        for name, w in want.items():
            np.testing.assert_allclose(have[name].numpy(), w.numpy(),
                                       atol=_PARAM_ATOL, rtol=0,
                                       err_msg=name)
    if kind == "knrm":
        ev, jev = test.evaluate(tdata, batch_size=16), \
            jest.evaluate(jdata, batch_size=16)
        assert set(ev) == set(jev) == {"loss", "binary_accuracy"}
        for k in ev:
            np.testing.assert_allclose(ev[k], jev[k], rtol=_LOSS_RTOL)
