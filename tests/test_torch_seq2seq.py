"""The port's ``Seq2Seq`` and ``greedy_generate`` (``models/seq2seq.py``)
and ``AnomalyDetector``, ``unroll`` and ``detect_anomalies``
(``models/anomaly.py``) against the JAX package.

Weights are seeded normals in the reference's tree; ``params_from_flax``
carries them into the port.  Tolerances: the f32 logits and predictions
within 1e-5; greedy tokens, windows and anomaly indices exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models import AnomalyDetector as JaxAnomaly
from analytics_zoo_tpu.models import Seq2Seq as JaxSeq2Seq
from analytics_zoo_tpu.models import detect_anomalies as jax_detect
from analytics_zoo_tpu.models import greedy_generate as jax_greedy
from analytics_zoo_tpu.models import unroll as jax_unroll
from analytics_zoo_tpu_torch.models import (AnomalyDetector, Seq2Seq,
                                            detect_anomalies,
                                            greedy_generate, unroll)
from analytics_zoo_tpu_torch.models.layers import params_from_flax

_ATOL = 1e-5


def _params(jm, *args, seed=3, std=0.5):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), *args)["params"]
    return jax.tree_util.tree_map(
        lambda s: std * rng.standard_normal(s.shape).astype(np.float32),
        shapes)


def _pair(rnn_type, bridge):
    kw = dict(vocab_size=13, embed_dim=6, hidden_sizes=(7, 5),
              rnn_type=rnn_type, bridge=bridge)
    jm = JaxSeq2Seq(**kw, dtype=jnp.float32)
    tm = Seq2Seq(**kw, dtype=torch.float32)
    rng = np.random.default_rng(1)
    enc = rng.integers(0, 13, (3, 6)).astype(np.int32)
    dec = rng.integers(0, 13, (3, 4)).astype(np.int32)
    params = _params(jm, enc, dec)
    sd = params_from_flax(params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    return jm, tm, params, enc, dec


_CASES = [("gru", "copy"), ("gru", "dense"), ("lstm", "copy"),
          ("lstm", "dense")]
_EOS_CASES = [("gru", "copy"), ("lstm", "dense")]


@pytest.mark.parametrize("rnn_type,bridge", _CASES)
def test_seq2seq_matches_jax(rnn_type, bridge):
    """Teacher-forced logits; greedy tokens without an eos, and for one
    bridge of each cell with an eos that the rows emit mid-way (so rows
    freeze at it)."""
    jm, tm, params, enc, dec = _pair(rnn_type, bridge)
    want = jax.jit(jm.apply)({"params": params}, enc, dec)
    with torch.no_grad():
        got = tm(torch.from_numpy(enc), torch.from_numpy(dec))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL,
                               rtol=0)
    v = {"params": params}
    greedy = jax.jit(jax_greedy, static_argnums=(0,),
                     static_argnames=("max_len", "bos_id", "eos_id"))
    free = np.asarray(greedy(jm, v, enc, max_len=6, bos_id=1))
    eos = int(free[0, 2])
    # eos on one bridge of each cell (each eos is a compile on the JAX side)
    eos_ids = (None, eos) if (rnn_type, bridge) in _EOS_CASES else (None,)
    for eos_id in eos_ids:
        want = free if eos_id is None else np.asarray(
            greedy(jm, v, enc, max_len=6, bos_id=1, eos_id=eos_id))
        got = greedy_generate(tm, None, enc, max_len=6, bos_id=1,
                              eos_id=eos_id, device="cpu")
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # with eos every row stays at it once emitted
    for row in got.numpy() if eos_id is not None else ():
        hit = np.flatnonzero(row == eos)
        if hit.size:
            assert (row[hit[0]:] == eos).all()


def test_greedy_generate_loads_variables_and_needs_a_device():
    _, tm, params, enc, _ = _pair("gru", "copy")
    fresh = Seq2Seq(vocab_size=13, embed_dim=6, hidden_sizes=(7, 5),
                    dtype=torch.float32)
    want = greedy_generate(tm, None, enc, max_len=4, device="cpu")
    got = greedy_generate(fresh, params_from_flax(params), enc, max_len=4,
                          device="cpu")
    assert torch.equal(got, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            greedy_generate(tm, None, enc, max_len=4)


def test_anomaly_detector_matches_jax():
    series = (np.sin(np.arange(120, dtype=np.float32) / 5)
              + 0.1 * np.random.default_rng(0).standard_normal(120)
              ).astype(np.float32)
    x, y = unroll(series, unroll_length=10)
    jx, jy = jax_unroll(series, unroll_length=10)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    x2, y2 = unroll(np.stack([series, -series], 1), 8, predict_step=3)
    jx2, jy2 = jax_unroll(np.stack([series, -series], 1), 8, predict_step=3)
    np.testing.assert_array_equal(x2, jx2)
    np.testing.assert_array_equal(y2, jy2)
    jm = JaxAnomaly(feature_shape=(10, 1), hidden_layers=(6, 4),
                    dropouts=(0.2, 0.2), dtype=jnp.float32)
    tm = AnomalyDetector((10, 1), hidden_layers=(6, 4), dropouts=(0.2, 0.2),
                         dtype=torch.float32)
    params = _params(jm, x[:8])
    tm.load_state_dict(params_from_flax(params))
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x[:16]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x[:16])).numpy()
    assert got.shape == want.shape == (16,)
    np.testing.assert_allclose(got, want, atol=_ATOL, rtol=0)
    idx = detect_anomalies(y[:16], got, anomaly_size=5)
    np.testing.assert_array_equal(idx, jax_detect(y[:16], want, 5))
    yt, yp = np.zeros(10), np.zeros(10)
    yp[3], yp[7] = 5.0, 2.0
    assert list(detect_anomalies(yt, yp, anomaly_size=2)) == [3, 7]
    # a training forward with dropout needs a seed and follows it
    xt = torch.from_numpy(x[:16])
    with pytest.raises(ValueError, match="rng="):
        tm(xt, train=True)
    a, b = tm(xt, train=True, rng=7), tm(xt, train=True, rng=7)
    assert torch.equal(a, b) and not torch.equal(a, tm(xt, train=True,
                                                      rng=8))
