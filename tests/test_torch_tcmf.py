"""The port's ``TCMFForecaster`` (``zouwu/tcmf.py``) against the JAX
package's.

The reference draws its initial ``F``, ``X`` and TCN weights from
``jax.random``, which the port cannot reproduce, so the parity tests
compute the reference's draws here (``jax.random.split(key(seed), 3)``,
as its ``fit`` does) and give them to the port's ``_fit``.

Tolerances: the factors after the reconstruction within 1e-5 of their
largest magnitude (f32, the same Adam in the same order, matmuls summed
in another order).  The TCN is bf16 in both packages, where a rounding
that falls the other way moves an Adam step by a whole ``lr``, so the
TCN's parameters and a loaded forecaster's predictions are held to 1e-5
with the TCN in f32 in both packages (their ``TCN`` replaced by one with
``dtype=float32``); at the default bf16 a loaded forecaster's
predictions agree within 3e-2 of their scale (bf16 rounds to 2**-8
relative).  Streamed against dense in the port: the reference's own
test's tolerances (``tests/test_tcmf.py``), NaNs present.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.models.forecast as jforecast
from analytics_zoo_tpu.zouwu import TCMFForecaster as JaxTCMF
from analytics_zoo_tpu.zouwu.preprocessing import roll as jax_roll
import analytics_zoo_tpu_torch.zouwu.tcmf as ttcmf
from analytics_zoo_tpu_torch.models.forecast import TCN
from analytics_zoo_tpu_torch.models.layers import params_from_flax
from analytics_zoo_tpu_torch.zouwu import TCMFForecaster


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """The full suite runs in 6 pytest-xdist workers that share the
    machine's cores; torch's default of one intra-op thread a core
    oversubscribes them, and small eager ops then spend their time
    handing work between threads (the TCMF fit test took 268.0 s in a
    6-worker run against 10 s alone). One torch thread for this file,
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ATOL = 1e-5
_BF16 = 3e-2


def _series(n=40, T=120, k=3, seed=0):
    """Y = F X on a sinusoidal basis, plus noise (the reference test's)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T + 24)
    X = np.stack([np.sin(2 * np.pi * t / p) for p in (12, 24, 37)])[:k]
    F = rng.normal(size=(n, k))
    Y = F @ X + 0.02 * rng.normal(size=(n, T + 24))
    return Y[:, :T].astype(np.float32), Y[:, T:].astype(np.float32)


def _close(got, want, atol=_ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _reference_init(y, rank, window, seed, chans, dtype=None):
    """The reference fit's initial F, X and TCN weights (as the port's
    ``state_dict``)."""
    n, T = y.shape
    kf, kx, kt = jax.random.split(jax.random.key(seed), 3)
    X = np.asarray(jax.random.normal(kx, (rank, T)) * 0.1)
    F = np.asarray(jax.random.normal(kf, (n, rank)) * 0.1)
    xs, _ = jax_roll(X.T, lookback=window, horizon=1)
    kw = {} if dtype is None else {"dtype": dtype}
    tcn = jforecast.TCN(output_dim=rank, horizon=1, dropout=0.0,
                        channels=chans, **kw)
    params = tcn.init(kt, jnp.asarray(xs[:1]))["params"]
    return F, X, params_from_flax(jax.device_get(params))


@pytest.fixture()
def f32_tcn(monkeypatch):
    """Both packages' TCMF TCN in f32."""
    monkeypatch.setattr(jforecast, "TCN",
                        functools.partial(jforecast.TCN, dtype=jnp.float32))
    monkeypatch.setattr(ttcmf, "TCN",
                        functools.partial(TCN, dtype=torch.float32))


def _tcn_params(fc):
    if isinstance(fc, JaxTCMF):
        return params_from_flax(jax.device_get(fc._tcn_params))
    return fc._tcn.state_dict()


@pytest.mark.parametrize("block", [None, 16])
def test_fit_matches_jax_from_the_same_start(f32_tcn, block):
    """Dense and streamed: F and X after 60 reconstruction epochs, the
    reported losses, and the TCN's parameters after 5 epochs."""
    y, _ = _series(n=48, T=60)
    y[3, 7] = np.nan
    kw = dict(rank=4, window=12, seed=5, series_block=block)
    ref = JaxTCMF(**kw)
    want = ref.fit(y, epochs=60, tcn_epochs=5)
    F0, X0, tcn = _reference_init(y, 4, 12, 5, (32, 32), jnp.float32)
    port = TCMFForecaster(**kw, device="cpu")
    got = port._fit(y, F0, X0, tcn, 60, 5)
    np.testing.assert_allclose(got["recon_loss"], want["recon_loss"],
                               rtol=_ATOL)
    np.testing.assert_allclose(got["tcn_loss"], want["tcn_loss"],
                               rtol=_ATOL)
    _close(port.F, ref.F)
    _close(port.X, ref.X)
    jp, tp = _tcn_params(ref), _tcn_params(port)
    assert set(jp) == set(tp)
    for k in jp:
        _close(tp[k], jp[k])


def test_dense_factors_match_jax_with_the_bf16_tcn():
    """The default (bf16) TCN does not touch the factors: F and X as the
    reference's."""
    y, _ = _series(n=20, T=50)
    ref = JaxTCMF(rank=3, window=8, seed=2)
    ref.fit(y, epochs=40, tcn_epochs=2)
    F0, X0, tcn = _reference_init(y, 3, 8, 2, (32, 32))
    port = TCMFForecaster(rank=3, window=8, seed=2, device="cpu")
    port._fit(y, F0, X0, tcn, 40, 2)
    _close(port.F, ref.F)
    _close(port.X, ref.X)


def _fitted_reference(tmp_path, **kw):
    y, future = _series(n=10, T=60)
    ref = JaxTCMF(rank=4, window=12, seed=3, **kw)
    ref.fit(y, epochs=50, tcn_epochs=20)
    ref.save(str(tmp_path))
    return ref, future


def test_load_of_a_reference_save_predicts_as_it(f32_tcn, tmp_path):
    ref, future = _fitted_reference(tmp_path)
    port = TCMFForecaster.load(str(tmp_path), device="cpu")
    _close(port.predict(8), ref.predict(8))
    assert port.series_block is None and port.rank == 4
    want = ref.evaluate(future, metrics=("mse", "mae", "smape"))
    got = port.evaluate(future, metrics=("mse", "mae", "smape"))
    for m in want:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-4)


def test_load_of_a_reference_save_bf16(tmp_path):
    ref, _ = _fitted_reference(tmp_path, series_block=4)
    port = TCMFForecaster.load(str(tmp_path), device="cpu")
    assert port.series_block == 4
    _close(port.predict(8), ref.predict(8), atol=_BF16)


def test_save_load_round_trip_both_ways(tmp_path):
    """The port's save loads back exactly, and the reference reads it."""
    y, _ = _series(n=10, T=60)
    fc = TCMFForecaster(rank=4, window=12, seed=3, device="cpu")
    fc.fit(y, epochs=30, tcn_epochs=10)
    pred = fc.predict(horizon=8)
    fc.save(str(tmp_path))
    again = TCMFForecaster.load(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(again.predict(horizon=8), pred)
    ref = JaxTCMF.load(str(tmp_path))
    _close(ref.predict(8), pred, atol=_BF16)


def test_streamed_equals_dense():
    """``series_block`` streams the same joint update: the factors and
    the forecast match the dense path at the reference test's
    tolerances, NaNs present."""
    y, _ = _series(n=48, T=60)
    y[3, 7] = np.nan
    y[40, 55] = np.nan
    dense = TCMFForecaster(rank=4, window=12, seed=5, device="cpu")
    dense.fit(y, epochs=60, tcn_epochs=5)
    streamed = TCMFForecaster(rank=4, window=12, seed=5, series_block=16,
                              device="cpu")
    streamed.fit(y, epochs=60, tcn_epochs=5)
    assert isinstance(streamed.F, np.ndarray)
    np.testing.assert_allclose(streamed.X, dense.X, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(streamed.F, dense.F, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(streamed.predict(8), dense.predict(8),
                               rtol=5e-3, atol=5e-4)


def test_fit_forecasts_and_bounds_the_streamed_block():
    """A fit reconstructs a low-rank matrix and beats persistence on the
    holdout (the reference test's bars, at fewer epochs); a streamed fit
    keeps every tensor it makes at block scale."""
    y, future = _series()
    fc = TCMFForecaster(rank=6, window=24, seed=1, device="cpu")
    stats = fc.fit(y, epochs=400, tcn_epochs=150)
    assert stats["recon_loss"] < 0.05, stats
    assert np.linalg.norm(fc.F @ fc.X - y) / np.linalg.norm(y) < 0.2
    mse = np.mean((fc.predict(24) - future) ** 2)
    assert mse < np.mean((y[:, -1:] - future) ** 2)
    n, T, B = 1024, 48, 32
    rng = np.random.default_rng(0)
    big = (rng.normal(size=(n, 3)) @ rng.normal(size=(3, T))).astype(
        np.float32)
    fc = TCMFForecaster(rank=3, window=12, seed=1, series_block=B,
                        collect_memory_stats=True, device="cpu")

    fc.fit(big, epochs=2, tcn_epochs=1)
    assert 0 < fc.peak_device_elems <= 4 * B * T < n * T // 4
    assert fc.predict(6).shape == (n, 6)


def test_errors_as_the_reference():
    y, future = _series(n=10, T=60)
    for cls, kw in ((JaxTCMF, {}), (TCMFForecaster, {"device": "cpu"})):
        fc = cls(rank=4, window=12, **kw)
        with pytest.raises(RuntimeError, match="fit first"):
            fc.predict(4)
        with pytest.raises(ValueError, match="must exceed window"):
            fc.fit(np.zeros((5, 10)))
        with pytest.raises(ValueError, match="n_series, T"):
            fc.fit(np.zeros(30))
        fc.fit(y, epochs=5, tcn_epochs=2)
        with pytest.raises(ValueError, match="unknown metric"):
            fc.evaluate(future, metrics=("r2",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TCMFForecaster()        # the default device is the card
