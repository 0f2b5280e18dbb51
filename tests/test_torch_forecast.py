"""The port's recurrent cells, forecasting nets and Zouwu forecasters
against the JAX package.

Weights are the reference's init moved off it by seeded noise;
``params_from_flax`` carries them over.  Tolerances: f32 within 1e-5
(outputs, Adam losses relative, predictions); bf16 within 3e-2 absolute
(every gate rounds to bf16, 2**-8 relative, compounded over the steps;
outputs of unit scale), with the output dtype held exactly (an f32
sequence out of a bf16 stack, as flax's f32 carry makes it).
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import init_orca_context as jax_init_context
from analytics_zoo_tpu import stop_orca_context as jax_stop_context
from analytics_zoo_tpu.models import forecast as jf
from analytics_zoo_tpu.models.rnn import RNNStack as JaxStack
from analytics_zoo_tpu.models.rnn import make_cell as jax_make_cell
from analytics_zoo_tpu.zouwu import forecaster as jzf
from analytics_zoo_tpu_torch.models import forecast as tf
from analytics_zoo_tpu_torch.models.layers import params_from_flax
from analytics_zoo_tpu_torch.models.rnn import RNNStack, make_cell, scan
from analytics_zoo_tpu_torch.zouwu import forecaster as tzf
from analytics_zoo_tpu_torch.zouwu import roll

_ATOL = 1e-5
_BF16_ATOL = 3e-2
# Adam losses: Adam scales each gradient element by its own running
# magnitude, so an element whose gradient is at f32 rounding level
# (~1e-7, e.g. MTNet's GRU input kernel) may step a full lr either way
# in the two packages; the gradients themselves are held to 1e-5
# (``test_net_gradients_match_jax``)
_LOSS_RTOL = 1e-4
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _noisy(params, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
            np.shape(a)).astype(np.float32), jax.device_get(params))


def _x(B=3, T=12, F=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, T, F)).astype(np.float32)


def _check(got, want, dt):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=_ATOL if dt == "f32" else _BF16_ATOL,
                               rtol=0)


class _JaxRNN(fnn.Module):
    """One flax cell under ``nn.RNN``, returning the carry and the
    sequence."""

    rnn_type: str
    features: int
    dtype: jnp.dtype

    @fnn.compact
    def __call__(self, x):
        cell = jax_make_cell(self.rnn_type, self.features, self.dtype)
        return fnn.RNN(cell, return_carry=True)(x)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru", "rnn"])
def test_cell_matches_flax_rnn(rnn_type, dt):
    jdt, tdt = _DT[dt]
    x = _x(T=9)
    jm = _JaxRNN(rnn_type, 6, jdt)
    xj = jnp.asarray(x, jdt)
    if rnn_type == "rnn" and dt == "bf16":
        # flax's scan refuses a bf16 carry after an f32 one; so does the
        # port's SimpleCell
        with pytest.raises(TypeError):
            jm.init(jax.random.key(0), xj)
        with pytest.raises(TypeError, match="SimpleCell"):
            scan(make_cell(rnn_type, 3, 6, tdt), torch.from_numpy(x).to(tdt))
        return
    params = _noisy(jm.init(jax.random.key(0), xj)["params"])
    carry, ys = jm.apply({"params": params}, xj)
    cell = make_cell(rnn_type, 3, 6, tdt)
    sd = params_from_flax(params)
    cell.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        tcarry, tys = scan(cell, torch.from_numpy(x).to(tdt))
        # one step through forward() = the scan's first step
        first, y0 = cell(cell.initial_carry(3, "cpu"),
                         torch.from_numpy(x[:, 0]).to(tdt))
    _check(tys, np.asarray(ys), dt)
    np.testing.assert_allclose(y0.float().numpy(), tys[:, 0].float().numpy(),
                               atol=_ATOL if dt == "f32" else _BF16_ATOL)
    for got, want in zip(jax.tree_util.tree_leaves(tcarry),
                         jax.tree_util.tree_leaves(carry)):
        _check(got, np.asarray(want), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rnn_type,seqs", [("lstm", False), ("gru", True)])
def test_rnn_stack_matches_jax(rnn_type, seqs, dt):
    jdt, tdt = _DT[dt]
    x = _x()
    jm = JaxStack((5, 4), rnn_type, return_sequences=seqs, dtype=jdt)
    xj = jnp.asarray(x, jdt)
    params = _noisy(jm.init(jax.random.key(0), xj)["params"])
    want = np.asarray(jm.apply({"params": params}, xj))
    assert want.dtype == np.float32
    tm = RNNStack((5, 4), rnn_type, return_sequences=seqs, dtype=tdt)
    tm.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        _check(tm(torch.from_numpy(x).to(tdt)), want, dt)


_NETS = {
    "lstm": (lambda d: jf.LSTMNet(2, 3, (8, 6), (0.0, 0.0), dtype=d),
             lambda d: tf.LSTMNet(2, 3, (8, 6), (0.0, 0.0), dtype=d), 12),
    "tcn": (lambda d: jf.TCN(2, 3, (8, 4), kernel_size=3, dropout=0.0,
                             dtype=d),
            lambda d: tf.TCN(2, 3, (8, 4), kernel_size=3, dropout=0.0,
                             dtype=d), 12),
    "tcn_k2_same_width": (
        lambda d: jf.TCN(1, 1, (3, 5), kernel_size=2, dtype=d),
        lambda d: tf.TCN(1, 1, (3, 5), kernel_size=2, dtype=d), 12),
    "mtnet": (lambda d: jf.MTNet(2, 2, long_num=3, series_length=4,
                                 ar_window=3, cnn_filters=8, rnn_hidden=8,
                                 dtype=d),
              lambda d: tf.MTNet(2, 2, long_num=3, series_length=4,
                                 ar_window=3, cnn_filters=8, rnn_hidden=8,
                                 dtype=d), 16),
    "mtnet_k4": (lambda d: jf.MTNet(1, 1, long_num=2, series_length=5,
                                    cnn_kernel=4, cnn_filters=6,
                                    rnn_hidden=6, dtype=d),
                 lambda d: tf.MTNet(1, 1, long_num=2, series_length=5,
                                    cnn_kernel=4, cnn_filters=6,
                                    rnn_hidden=6, dtype=d), 15),
    "seq2seq": (lambda d: jf.Seq2SeqTS(2, 3, 8, 2, dtype=d),
                lambda d: tf.Seq2SeqTS(2, 3, 8, 2, dtype=d), 12),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("net", sorted(_NETS))
def test_net_matches_jax(net, dt):
    jdt, tdt = _DT[dt]
    jmk, tmk, T = _NETS[net]
    x = _x(T=T)
    jm, tm = jmk(jdt), tmk(tdt)
    params = _noisy(jm.init(jax.random.key(0), x)["params"])
    want = np.asarray(jm.apply({"params": params}, x))
    tm.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        _check(tm(torch.from_numpy(x)), want, dt)


@pytest.mark.parametrize("net", ["lstm", "mtnet", "seq2seq", "tcn"])
def test_net_gradients_match_jax(net):
    """f32: every parameter's gradient of an mse loss = ``jax.grad``."""
    jmk, tmk, T = _NETS[net]
    x = _x(T=T)
    jm, tm = jmk(jnp.float32), tmk(torch.float32)
    params = _noisy(jm.init(jax.random.key(0), x)["params"])
    y = np.random.default_rng(1).standard_normal(
        jm.apply({"params": params}, x).shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.mean(
        (jm.apply({"params": p}, x) - y) ** 2))(params)
    tm.load_state_dict(params_from_flax(params))
    torch.mean((tm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2) \
        .backward()
    want = params_from_flax(jax.device_get(grads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=_ATOL, rtol=0, err_msg=name)


def test_net_state_dict_names_are_the_flax_tree():
    """Every parameter of each port net (its input width taken from a
    first input) has a name that ``params_from_flax`` gives."""
    for net, (jmk, tmk, T) in _NETS.items():
        x = _x(T=T)
        params = jmk(jnp.float32).init(jax.random.key(0), x)["params"]
        tm = tmk(torch.float32)
        with torch.no_grad():
            tm(torch.from_numpy(x))
        assert set(params_from_flax(params)) == set(tm.state_dict()), net


def test_tcn_is_causal():
    """The head reads the last step; with kernel 2, one dilation-1 block
    of two convs, its receptive field is the last 3 steps: the gradient
    with respect to earlier inputs is exactly 0."""
    torch.manual_seed(0)
    net = tf.TCN(output_dim=1, horizon=1, channels=(4,), kernel_size=2,
                 dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 8, 1)).astype(np.float32)).requires_grad_()
    net(x)[0, 0, 0].backward()
    assert float(x.grad[0, :5, 0].abs().sum()) == 0.0
    assert float(x.grad[0, 5:, 0].abs().sum()) > 0


def test_dropout_needs_a_seed_and_follows_it():
    net = tf.LSTMNet(1, 1, (6, 4), (0.5, 0.5))
    x = torch.from_numpy(_x(F=1))
    with pytest.raises(ValueError, match="rng"):
        net(x, train=True)
    a, b = net(x, train=True, rng=7), net(x, train=True, rng=7)
    assert torch.equal(a, b)
    assert not torch.equal(a, net(x, train=True, rng=8))
    assert torch.equal(net(x), net(x, train=False, rng=7))


# ---- the forecasters ------------------------------------------------------

@pytest.fixture()
def mesh8():
    jax_init_context("local", mesh_axes={"dp": 8})
    yield
    jax_stop_context()


def _series(n=160, F=1, seed=0):
    t = np.arange(n, dtype=np.float32)
    s = np.stack([np.sin(t / (5 + k)) for k in range(F)], 1)
    s += 0.1 * np.random.default_rng(seed).standard_normal(s.shape)
    return s.astype(np.float32)


_FORECASTERS = {
    "lstm": (dict(lstm_units=(8,), dropouts=(0.0,)), "LSTMForecaster", 8,
             1),
    "tcn": (dict(channels=(8, 8), dropout=0.0), "TCNForecaster", 8, 1),
    "mtnet": (dict(long_series_num=2, series_length=4, ar_window_size=2,
                   cnn_hid_size=6, rnn_hid_size=6), "MTNetForecaster", 12,
              1),
    "seq2seq": (dict(lstm_hidden_dim=8, future_seq_len=2),
                "Seq2SeqForecaster", 8, 2),
}


def _to_f32(jfc, tfc):
    """Both forecasters' nets in f32 and without dropout, for parity."""
    kw = {"dtype": jnp.float32}
    if hasattr(jfc.model, "dropout"):
        kw["dropout"] = 0.0
    jfc.model = jfc.estimator.model = jfc.model.clone(**kw)
    for m in tfc.model.modules():
        if getattr(m, "dtype", None) == torch.bfloat16:
            m.dtype = torch.float32
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0


@pytest.mark.parametrize("kind", sorted(_FORECASTERS))
def test_forecaster_matches_jax(mesh8, kind, tmp_path):
    """The same weights and data: Adam losses, predictions and the
    evaluate metrics agree; a save restores into a fresh forecaster."""
    kw, cls, lookback, horizon = _FORECASTERS[kind]
    x, y = roll(_series(F=2), lookback, horizon, target_cols=[0])
    jfc = getattr(jzf, cls)(lr=1e-2, **kw)
    tfc = getattr(tzf, cls)(lr=1e-2, device="cpu", **kw)
    _to_f32(jfc, tfc)
    params = _noisy(jfc.model.init(jax.random.key(0), x[:2])["params"])
    jfc.estimator._initial_variables = params
    tfc.model.load_state_dict(params_from_flax(params))
    want = [jfc.fit(x, y, epochs=1, batch_size=16)["loss"]
            for _ in range(2)]
    got = [tfc.fit(x, y, epochs=1, batch_size=16)["loss"] for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=_LOSS_RTOL)
    preds = tfc.predict(x[:10], batch_size=8)
    assert preds.shape == (10, horizon, 1)
    np.testing.assert_allclose(preds, np.asarray(jfc.predict(
        x[:10], batch_size=8)), atol=_ATOL, rtol=0)
    metrics = ("mse", "rmse", "mae", "smape")
    ev, jev = tfc.evaluate(x, y, metrics), jfc.evaluate(x, y, metrics)
    assert set(ev) == set(metrics)
    for m in metrics:
        np.testing.assert_allclose(ev[m], jev[m], rtol=1e-4, err_msg=m)
    path = str(tmp_path / kind)
    tfc.save(path)
    fresh = getattr(tzf, cls)(device="cpu", **kw)
    _to_f32(jfc, fresh)
    fresh.restore(path, sample_x=x[:2])
    np.testing.assert_array_equal(fresh.predict(x[:10], batch_size=8),
                                  preds)


def test_forecaster_y_shapes_and_bf16_default():
    """The default (bf16) nets: a ``[N]`` and a ``[N, D]`` y expand;
    predictions are f32 ``[N, horizon, D]``."""
    x, y = roll(_series(100)[:, 0], lookback=8, horizon=1)
    f = tzf.LSTMForecaster(lstm_units=(8,), dropouts=(0.0,), device="cpu")
    f.fit(x, y[:, 0, 0], epochs=1, batch_size=16)
    f.fit(x, y[:, 0], epochs=1, batch_size=16)
    p = f.predict(x[:4])
    assert p.shape == (4, 1, 1) and p.dtype == np.float32
    ev = f.evaluate(x, y, metrics=("mse", "smape"))
    assert set(ev) == {"mse", "smape"} and np.isfinite(list(ev.values())).all()


def test_forecaster_fit_predict(tmp_path):
    """The reference's ``test_forecaster_fit_predict`` on the port."""
    x, y = roll(np.sin(np.arange(300) / 5).astype(np.float32),
                lookback=16, horizon=1)
    torch.manual_seed(0)
    f = tzf.TCNForecaster(channels=(8, 8), lr=3e-3, device="cpu")
    stats = f.fit(x, y, epochs=4, batch_size=32)
    assert stats["loss"] < 0.5
    preds = f.predict(x[:10])
    assert preds.shape == (10, 1, 1)
    assert f.evaluate(x, y, metrics=("mse", "smape"))["mse"] < 0.5
    p = str(tmp_path / "fc")
    f.save(p)
    g = tzf.TCNForecaster(channels=(8, 8), device="cpu")
    g.restore(p, sample_x=x[:2])
    np.testing.assert_allclose(g.predict(x[:10]), preds, rtol=1e-4)


def test_forecaster_needs_cuda_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzf.TCNForecaster()
