"""The zoo's partition rules and meshes on the port: two gloo ranks
(``_torch_dist_worker.py`` scenario ``tpzoo``, one launch for the
module) on a ``{"tp": 2}`` mesh and a ``{"dp": 2}`` mesh.

- NCF under ``NCF_PARTITION_RULES`` with the reference's
  ``test_ncf_tp_sharded_embeddings`` shape (64 users, so a 65-row user
  table that stays whole, and 63 items, a 64-row table that splits):
  SGD parameters and Adam losses against the JAX Estimator within 1e-5
  of scale;
- Wide & Deep under ``WND_PARTITION_RULES`` (every table split) against
  one rank;
- ``BERTClassifier`` with its default ``BERT_PARTITION_RULES`` (dropout
  on) and ``TextEstimator(partition_rules=)`` against one rank;
- ``GANEstimator(mesh=)`` on dp=2 against one rank;
- ``data.loader.data_shard``: the readers' shard of a rank is its dp
  coordinate.
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
from analytics_zoo_tpu.models.ncf import NCF_PARTITION_RULES as JAX_RULES
from analytics_zoo_tpu.models.ncf import NeuralCF as JaxNCF
from analytics_zoo_tpu_torch.models import recommendation as trec
from analytics_zoo_tpu_torch.models import transformer as ttr
from analytics_zoo_tpu_torch.models.layers import params_from_flax

from _torch_dist import Ranks

_NCF = dict(user_count=64, item_count=63, mf_embed=8, user_embed=8,
            item_embed=8)
_INFO = dict(wide_base_cols=["a", "b"], wide_base_dims=[10, 20],
             wide_cross_cols=["ab"], wide_cross_dims=[49],
             indicator_cols=["g"], indicator_dims=[3],
             embed_cols=["u", "i"], embed_in_dims=[99, 199],
             embed_out_dims=[8, 8], continuous_cols=["age"])
_BERT = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=4,
             intermediate_size=64, max_position=64)
_HOLD = 1e-5


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=_HOLD * scale, rtol=0,
                               err_msg=what)


def _states_close(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        _close(a[k], b[k], f"{what}: {k}")


def _jax_fit(model, params, data, opt, epochs):
    est = JaxEstimator.from_flax(
        model=model, loss="sparse_categorical_crossentropy", optimizer=opt,
        initial_variables=params, config=JaxConfig(deterministic=True),
        feature_cols=("user", "item"), label_cols=("label",),
        partition_rules=JAX_RULES)
    hist = est.fit(data, epochs=epochs, batch_size=16)
    return [h["loss"] for h in hist], jax.device_get(est.state.params)


@pytest.fixture(scope="module")
def zoo(tmp_path_factory, devices):
    outdir = tmp_path_factory.mktemp("tpzoo")
    rng = np.random.default_rng(0)
    ncf_data = {"user": rng.integers(0, 65, 64).astype(np.int32),
                "item": rng.integers(0, 64, 64).astype(np.int32),
                "label": rng.integers(0, 2, 64).astype(np.int32)}
    jm = JaxNCF(**_NCF, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), ncf_data["user"][:2],
        ncf_data["item"][:2]))["params"]
    params = jax.tree_util.tree_map(
        lambda a: 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        shapes)
    torch.manual_seed(0)
    wnd = trec.WideAndDeep(2, trec.ColumnFeatureInfo(**_INFO),
                           dtype=torch.float32)
    wide = rng.integers(0, 80, (32, 3)).astype(np.int32)
    wnd_data = dict(
        wide_cols=wide,
        indicator_cols=rng.integers(0, 4, (32, 1)).astype(np.int32),
        embed_cols=np.stack([rng.integers(0, 100, 32),
                             rng.integers(0, 200, 32)], 1).astype(np.int32),
        continuous_cols=rng.standard_normal((32, 1)).astype(np.float32),
        label=rng.integers(0, 2, 32).astype(np.int32))
    bert = ttr.BERT(**_BERT, dtype=torch.float32, use_flash=False)
    head = torch.nn.Linear(32, 3)
    torch.save({"ncf_cfg": _NCF, "ncf_state": params_from_flax(params),
                "ncf_data": ncf_data, "wnd_info": _INFO,
                "wnd_state": wnd.state_dict(), "wnd_data": wnd_data,
                "bert_cfg": _BERT, "bert_state": bert.state_dict(),
                "cls_head": head.state_dict(),
                "text_data": {
                    "input_ids": rng.integers(0, 128, (16, 16)).astype(
                        np.int32),
                    "y": rng.integers(0, 3, 16).astype(np.int32)},
                "gan_data": rng.standard_normal((32, 2)).astype(
                    np.float32)},
               outdir / "tpzoo_in.pt")
    ranks = Ranks("tpzoo", outdir, 2)
    init_orca_context("local", mesh_axes={"dp": 8})
    try:
        want = {"sgd": _jax_fit(jm, params, ncf_data, optax.sgd(0.1), 1),
                "adam": _jax_fit(jm, params, ncf_data, optax.adam(5e-3),
                                 2)}
    finally:
        stop_orca_context()
    return ranks.wait(), want


def test_ncf_tp_matches_reference_with_fallback(zoo):
    """The 64-row item tables split, the 65-row user tables stay whole
    (the rules' divisibility fallback); SGD parameters, SGD and Adam
    losses equal the JAX Estimator's, and one rank's."""
    ranks, want = zoo
    loss, params = want["sgd"]
    wstate = params_from_flax(params)
    for r in ranks:
        assert r[("ncf_split", "sgd")] == [
            "mf_item_embedding.weight", "mlp_item_embedding.weight"]
        got_loss, state = r[("ncf", "sgd", "tp2")]
        np.testing.assert_allclose(got_loss, loss, rtol=_HOLD)
        _states_close(state, wstate, "ncf sgd")
        np.testing.assert_allclose(r[("ncf", "adam", "tp2")][0],
                                   want["adam"][0], rtol=_HOLD)
        np.testing.assert_allclose(r[("ncf", "adam", "one")][0],
                                   want["adam"][0], rtol=_HOLD)


def test_wide_and_deep_tp_equals_one_rank(zoo):
    for r in zoo[0]:
        assert r["wnd_split"] == [
            "deep_embedding_i.weight", "deep_embedding_u.weight",
            "wide_embedding.weight"]
        (l2, s2), (l1, s1) = r[("wnd", "tp2")], r[("wnd", "one")]
        np.testing.assert_allclose(l2, l1, rtol=_HOLD)
        _states_close(s2, s1, "wide and deep")


@pytest.mark.parametrize("which", ["bertcls", "textest"])
def test_text_estimators_shard_and_equal_one_rank(zoo, which):
    """BERTClassifier with its default rules (dropout 0.1: the global
    masks) and TextEstimator(partition_rules=) on tp=2 train what one
    rank trains."""
    for r in zoo[0]:
        assert r["bertcls_split"] > 0
        (h2, s2), (h1, s1) = r[(which, "tp2")], r[(which, "one")]
        if which == "textest":
            h2, h1 = [h["loss"] for h in h2], [h["loss"] for h in h1]
        np.testing.assert_allclose(h2, h1, rtol=_HOLD)
        _states_close(s2, s1, which)


def test_gan_dp_equals_one_rank(zoo):
    for r in zoo[0]:
        h2, g2, d2 = r[("gan", "dp2")]
        h1, g1, d1 = r[("gan", "one")]
        for a, b in zip(h2, h1):
            assert a["steps"] == b["steps"] == 4
            np.testing.assert_allclose([a["d_loss"], a["g_loss"]],
                                       [b["d_loss"], b["g_loss"]],
                                       rtol=_HOLD)
        _states_close(g2, g1, "generator")
        _states_close(d2, d1, "discriminator")


def test_readers_shard_by_dp_coordinate(zoo):
    for i, r in enumerate(zoo[0]):
        assert r["data_shard"] == (1, 0)
        assert r["data_shard_dp"] == (2, i)
