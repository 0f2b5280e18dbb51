"""The port's BERT entry points held to the JAX stack: ``BERTClassifier``,
NNFrames (``NNClassifier`` over a DataFrame and over an ``XShards``),
``InferenceModel.load_torch``/``load`` and ``ClusterServing``'s
``/predict`` over a fine-tuned classifier.

The reference's tiny BERT (vocab 128, hidden 32, 2 layers, 4 heads) at
f32, dropout 0, its weights moved into the port by ``params_from_flax``;
the same numpy rows on both sides (a fully padded row among them), the
same batch schedule (``NumpyBatchIterator``'s ``seed + epoch``
permutations).  Tolerances: losses rtol 1e-5, logits and SGD parameters
atol 1e-5 (f32, sums in another order); predictions of the same
estimator through another entry point atol 1e-6 (another batch
padding).
"""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu import init_orca_context, stop_orca_context
from analytics_zoo_tpu.common.config import TrainConfig as JaxConfig
from analytics_zoo_tpu.frames import NNClassifier as JaxNNClassifier
from analytics_zoo_tpu.learn.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.models import BERT as JaxBERT
from analytics_zoo_tpu.models import \
    BERTForSequenceClassification as JaxCls
from analytics_zoo_tpu.serving import ClusterServing as JaxServing
from analytics_zoo_tpu.serving import HttpFrontend as JaxFrontend
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.tfpark.text import BERTClassifier as JaxBERTClassifier
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.data.shards import XShards
from analytics_zoo_tpu_torch.frames import (NNClassifier, NNImageReader,
                                            Preprocessing)
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.transformer import (
    BERT, BERT_PARTITION_RULES, BERTForSequenceClassification,
    params_from_flax)
from analytics_zoo_tpu_torch.serving import (ClusterServing, HttpFrontend,
                                             ServingConfig)
from analytics_zoo_tpu_torch.data.text import TextSet
from analytics_zoo_tpu_torch.models.text import KNRM
from analytics_zoo_tpu_torch.tfpark.text import (BERTClassifier,
                                                 KNRMEstimator)

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64)
_FEATS = ("input_ids", "token_type_ids", "attention_mask")
_LOSS_RTOL = 1e-5
_ATOL = 1e-5
_SAME_ATOL = 1e-6
_TIMEOUT = 90


def _rows(n=24, T=12, seed=0):
    """Feature columns (the last row fully padded) and 2-class labels."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, T + 1, n)
    lens[-1] = 0
    out = {"input_ids": rng.integers(0, 128, (n, T)).astype(np.int32),
           "token_type_ids": (np.arange(T)[None] >= T // 2).repeat(
               n, 0).astype(np.int32),
           "attention_mask": (np.arange(T)[None] < lens[:, None]
                              ).astype(np.int32)}
    return out, rng.integers(0, 2, n).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    """(JAX classifier, its noisy params, the port's state_dict)."""
    jm = JaxCls(num_classes=2, bert=JaxBERT(**TINY, dtype=jnp.float32,
                                            dropout=0.0, use_flash=False))
    feats, _ = _rows()
    params = jm.init(jax.random.key(0), *(feats[c][:2]
                                          for c in _FEATS))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)
    return jm, params, params_from_flax(params)


def _port_model(weights):
    tm = BERTForSequenceClassification(
        2, BERT(**TINY, dtype=torch.float32, dropout=0.0, use_flash=False))
    tm.load_state_dict(weights[2])
    return tm


@pytest.fixture()
def mesh8():
    init_orca_context("local", mesh_axes={"dp": 8})
    yield
    stop_orca_context()


def test_bert_classifier_matches_jax(weights, mesh8):
    """``BERTClassifier`` on ``input_ids`` with its default optimizer
    (AdamW 2e-5, decay 1e-4): the same losses and predictions."""
    jm, params, _ = weights
    feats, y = _rows()
    data = {"input_ids": feats["input_ids"], "y": y}
    ref_est = JaxBERTClassifier(2, bert=jm.bert, initial_variables=params,
                                config=JaxConfig(deterministic=True))
    ref = ref_est.fit(data, epochs=2, batch_size=8)
    est = BERTClassifier(2, bert=BERT(**TINY, dtype=torch.float32,
                                      dropout=0.0, use_flash=False),
                         config=TrainConfig(deterministic=True),
                         device="cpu")
    est.model.load_state_dict(weights[2])
    opt = est.estimator.optimizer
    assert isinstance(opt, torch.optim.AdamW)
    assert (opt.defaults["lr"], opt.defaults["weight_decay"]) == (2e-5, 1e-4)
    got = est.fit(data, epochs=2, batch_size=8)
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in ref], rtol=_LOSS_RTOL)
    assert set(got[0]) == set(ref[0])
    np.testing.assert_allclose(
        est.predict({"input_ids": feats["input_ids"]}, batch_size=8),
        np.asarray(ref_est.predict({"input_ids": feats["input_ids"]},
                                   batch_size=8)), atol=_ATOL, rtol=0)
    # a TextSet input is accepted (its token ids feed the model)
    ts = TextSet.from_texts(["a b c d", "b c d e f", "c a a"] * 3,
                            [0, 1, 0] * 3).tokenize().word2idx() \
        .shape_sequence(16)
    hist = est.fit(ts, epochs=1, batch_size=8, feature_cols=("tokens",))
    assert np.isfinite(hist[0]["loss"]) and hist[0]["num_samples"] == 8.0
    # and the text-matching estimator builds
    assert isinstance(KNRMEstimator(128, embed_dim=8, kernel_num=3,
                                    device="cpu").model, KNRM)
    # partition rules are ported: BERT_PARTITION_RULES by default, any
    # rules given (they replicate without a tp axis)
    small = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                 intermediate_size=32, max_position=16)
    assert BERTClassifier(2, bert=BERT(**small), device="cpu").estimator \
        .rules == BERT_PARTITION_RULES
    assert BERTClassifier(2, bert=BERT(**small), partition_rules=(),
                          device="cpu").estimator.rules == ()


def _frame(feats, y):
    return pd.DataFrame({**{c: list(feats[c]) for c in _FEATS},
                         "label": y})


def test_nnclassifier_matches_jax(weights, mesh8):
    """``NNClassifier`` over a DataFrame, SGD: the fitted parameters and
    ``transform``'s predictions equal the reference's; over an
    ``XShards`` of numpy dicts (what the card's machine, which has no
    pandas, runs) the fit equals the DataFrame's bitwise."""
    jm, params, _ = weights
    feats, y = _rows()
    df = _frame(feats, y)

    class Seeded(JaxNNClassifier):
        def _make_estimator(self):
            est = super()._make_estimator()
            est._initial_variables = params
            return est

    def stage(clf):
        return clf.setFeaturesCol(*_FEATS).setLabelCol("label") \
            .setBatchSize(8).setMaxEpoch(2)

    ref = stage(Seeded(jm, optimizer=optax.sgd(0.1))).fit(df)
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731
    got = stage(NNClassifier(_port_model(weights), optimizer=sgd,
                             device="cpu")).fit(df)
    want = params_from_flax(jax.device_get(ref.estimator.state.params))
    have = got.estimator.model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(have[name].numpy(), w.numpy(),
                                   atol=_ATOL, rtol=0, err_msg=name)
    out, ref_out = got.transform(df), ref.transform(df)
    assert list(out.columns) == list(ref_out.columns)
    assert out["prediction"].tolist() == ref_out["prediction"].tolist()
    assert isinstance(out["prediction"].iloc[0], float)

    shards = XShards.partition({**feats, "label": y}, num_shards=3)
    sharded = stage(NNClassifier(_port_model(weights), optimizer=sgd,
                                 device="cpu")).fit(shards)
    for name, w in sharded.estimator.model.state_dict().items():
        assert torch.equal(w, have[name]), name
    parts = sharded.transform(shards).collect()
    assert len(parts) == 3
    assert [p for s in parts for p in s["prediction"]] == \
        out["prediction"].tolist()


def test_nnclassifier_defaults_and_preprocessing(weights):
    clf = NNClassifier(_port_model(weights), device="cpu",
                       feature_preprocessing=Preprocessing(
                           lambda a: a.astype(np.int64)))
    est = clf.setFeaturesCol(*_FEATS).setLabelCol("label") \
        .setBatchSize(8)._make_estimator()
    assert isinstance(est.optimizer, torch.optim.Adam)
    assert est.optimizer.defaults["lr"] == 1e-3
    feats, y = _rows()
    model = clf.fit(_frame(feats, y))
    assert model.transform(_frame(feats, y))["prediction"].notna().all()
    with pytest.raises(FileNotFoundError):      # as the reference's
        NNImageReader.readImages("no-such-images-dir")


def _fitted(weights):
    feats, y = _rows()
    est = Estimator.from_torch(
        model=_port_model(weights), loss="sparse_categorical_crossentropy",
        optimizer=1e-3, feature_cols=_FEATS, label_cols=("y",),
        config=TrainConfig(deterministic=True), device="cpu")
    est.fit({**feats, "y": y}, epochs=1, batch_size=8)
    return est, feats


def test_inference_model_load_torch_and_load(weights, tmp_path):
    """The fine-tuned module served by ``load_torch`` and by ``load`` of
    its ``Estimator.save`` export equals ``Estimator.predict``; batch
    padding rows (all-zero masks) stay out of the result."""
    est, feats = _fitted(weights)
    want = est.predict(feats, batch_size=8)
    args = [feats[c] for c in _FEATS]
    direct = InferenceModel().load_torch(est.model, device="cpu")
    np.testing.assert_allclose(direct.predict(*args), want,
                               atol=_SAME_ATOL, rtol=0)
    assert direct.model.training is False
    est.save(str(tmp_path / "export"))
    fresh = _port_model(weights)
    im = InferenceModel(batch_buckets=(1, 16)).load(
        str(tmp_path / "export"), fresh, device="cpu")
    got = im.predict(*args)      # 24 rows: a chunk of 16, then 8 of 16
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=_SAME_ATOL, rtol=0)
    # the bert encoder alone returns a tuple: served as a tuple
    seq, pooled = InferenceModel().load_torch(
        fresh.bert, device="cpu").predict(*args)
    assert seq.shape == (24, 12, 32) and pooled.shape == (24, 32)


def _post(port, instances):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=_TIMEOUT)
    try:
        conn.request("POST", "/predict",
                     json.dumps({"instances": instances}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_cluster_serving_predict_matches_jax(weights):
    """``/predict`` over the classifier through the port's stack and the
    reference's (``load_flax`` of the same weights), micro-batch mode,
    ``input_cols`` = ids, token types, mask: the same logits."""
    jm, params, _ = weights
    feats, _ = _rows(n=6, seed=2)
    instances = [{c: feats[c][i].tolist() for c in _FEATS}
                 for i in range(6)]
    cfg = dict(batch_size=4, batch_timeout_ms=20.0, input_cols=list(_FEATS))
    stacks = []
    try:
        for im, serving, frontend, config in (
                (InferenceModel().load_torch(_port_model(weights),
                                             device="cpu"),
                 ClusterServing, HttpFrontend, ServingConfig),
                (JaxInferenceModel().load_flax(jm, {"params": params}),
                 JaxServing, JaxFrontend, JaxServingConfig)):
            srv = serving(im, config(**cfg), embedded_broker=True).start()
            stacks.append((srv, frontend(redis_port=srv.port,
                                         timeout=_TIMEOUT,
                                         serving=srv).start()))
        answers = []
        for _, fe in stacks:
            status, text = _post(fe.port, instances)
            assert status == 200, text
            answers.append(np.asarray(json.loads(text)["predictions"]))
    finally:
        for srv, fe in stacks:
            fe.stop()
            srv.stop()
    got, want = answers
    assert got.shape == want.shape == (6, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=_ATOL, rtol=0)
