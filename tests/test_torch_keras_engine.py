"""The port's Keras engine, optimizers, autograd, ``tfpark.KerasModel``
and ``Estimator.from_keras`` against the reference on the CPU.

Models are built on both sides and share weights through
``get_weights``/``set_weights`` (the reference's order and layouts),
so every comparison starts from the same numbers.  Tolerances: f32
forwards 1e-5; fits (the reference's Estimator on the dp=8 CPU mesh, the
port's eager one) SGD parameters after 3 steps and Adam losses at 1e-5,
with an L2 regularizer on; the optimizers 5 steps on the same gradients
at 1e-6.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import analytics_zoo_tpu.autograd as JA
from analytics_zoo_tpu import init_orca_context, stop_orca_context
from analytics_zoo_tpu import keras as JK
from analytics_zoo_tpu.keras.engine import collect_penalty as j_penalty
from analytics_zoo_tpu.keras.optimizers import get_optimizer as j_opt
from analytics_zoo_tpu.tfpark import KerasModel as JKerasModel

import analytics_zoo_tpu_torch.autograd as PA
from analytics_zoo_tpu_torch import keras as PK
from analytics_zoo_tpu_torch import tfpark
from analytics_zoo_tpu_torch.keras.engine import (collect_penalty,
                                                  get_variables,
                                                  set_variables)
from analytics_zoo_tpu_torch.keras.optimizers import get_optimizer
from analytics_zoo_tpu_torch.learn import Estimator


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """The full suite runs in 6 pytest-xdist workers that share the
    machine's cores; torch's default of one intra-op thread a core
    oversubscribes them, and small eager ops then spend their time
    handing work between threads. One torch thread for this file,
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
OPT_TOL = 1e-6


@pytest.fixture()
def mesh8():
    init_orca_context("local", mesh_axes={"dp": 8})
    yield
    stop_orca_context()


def _mlp(K, n=3, reg=None):
    m = K.Sequential()
    for i in range(n):
        m.add(K.Dense(4, activation="tanh", W_regularizer=reg))
    return m.add(K.Dense(2, b_regularizer=reg))


def _graph(K):
    """Two inputs, a shared Dense, a nested Sequential tower, merges."""
    a, b = K.Input(shape=(5,)), K.Input(shape=(5,))
    shared = K.Dense(6, activation="relu")
    tower = K.Sequential().add(K.Dense(8, activation="tanh")).add(K.Dense(3))
    s = K.merge([shared(a), shared(b)], mode="mul")
    y = K.merge([tower(s), K.Dense(3)(b)], mode="concat")
    return K.Model(input=[a, b], output=y)


def _ref_weights(jm, *xs):
    """The reference model's variables: its tree (``jax.eval_shape``, no
    initializer compiles) of seeded normals."""
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(3)}, *[jnp.asarray(x) for x in xs],
        train=False))
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(lambda a: (0.5 * rng.normal(
        size=a.shape)).astype(np.float32), dict(shapes))


def test_functional_model_shared_nested_merge():
    rng = np.random.default_rng(0)
    xa, xb = (rng.normal(size=(4, 5)).astype(np.float32) for _ in range(2))
    jm, pm = _graph(JK), _graph(PK)
    v = _ref_weights(jm, xa, xb)
    # one shared Dense -> one subtree; ops in topological order (the
    # merges, ops_1 and ops_4, have no parameters)
    assert sorted(v["params"]) == ["ops_0", "ops_2", "ops_3"]
    pm.ensure_built()                    # from the Input shapes
    set_variables(pm, v)
    want = np.asarray(jm.apply(v, jnp.asarray(xa), jnp.asarray(xb)))
    got = pm(torch.as_tensor(xa), torch.as_tensor(xb)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert pm.n_inputs == 2
    with pytest.raises(ValueError, match="takes 2 inputs"):
        pm(torch.as_tensor(xa))


def test_weights_cross_both_ways_past_ten_layers(mesh8):
    """JAX ``get_weights`` into the port's ``set_weights`` and back:
    equal predictions, and the layer order holds past 10 layers (a
    lexicographic order would put layers_10 before layers_2)."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(16, 3)).astype(np.float32)
    Y = rng.normal(size=(16, 2)).astype(np.float32)
    jm, pm = _mlp(JK, 11), _mlp(PK, 11)
    for m in (jm, pm):
        m.compile(optimizer="sgd", loss="mse")
    pm.compile(optimizer="sgd", loss="mse", device="cpu")
    jm.fit(X, Y, batch_size=8, nb_epoch=1)
    pm.fit(X, Y, batch_size=8, nb_epoch=1)
    pm.set_weights(jm.get_weights())
    np.testing.assert_allclose(pm.predict(X, batch_size=8),
                               jm.predict(X, batch_size=8), rtol=TOL,
                               atol=TOL)
    ws = pm.get_weights()
    ws[2 * 2 + 1] = np.full_like(ws[2 * 2 + 1], 0.25)   # layer 2's kernel
    pm.set_weights(ws)
    assert torch.all(pm.layers_2.Dense_0.weight == 0.25)
    assert not torch.all(pm.layers_10.Dense_0.weight == 0.25)
    jm.set_weights(pm.get_weights())
    np.testing.assert_allclose(jm.predict(X, batch_size=8),
                               pm.predict(X, batch_size=8), rtol=TOL,
                               atol=TOL)
    with pytest.raises(ValueError, match="expected"):
        pm.set_weights(ws[:-1])


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_fit_matches_reference_with_l2(mesh8, optimizer):
    """3 steps (SGD: the parameters; Adam: the loss history) with an L2
    penalty on every kernel and the last bias, from the same weights;
    evaluate's loss includes the penalty on both sides."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(24, 3)).astype(np.float32)
    Y = rng.normal(size=(24, 2)).astype(np.float32)
    jm, pm = _mlp(JK, reg=JK.l2(0.01)), _mlp(PK, reg=PK.l2(0.01))
    lr = 0.1 if optimizer == "sgd" else 0.01
    jm.compile(optimizer=optimizer, loss="mse", lr=lr)
    pm.compile(optimizer=optimizer, loss="mse", lr=lr, device="cpu")
    jest = jm._get_estimator(1)
    jest._ensure_state(jm._as_dict(X[:8], Y[:8]))
    pm.build_on(X[:2])
    pm.set_weights(jm.get_weights())
    ref = jm.fit(X, Y, batch_size=8, nb_epoch=1)
    got = pm.fit(X, Y, batch_size=8, nb_epoch=1)
    np.testing.assert_allclose(got[0]["loss"], ref[0]["loss"], rtol=TOL)
    if optimizer == "sgd":
        for a, b in zip(pm.get_weights(), jm.get_weights()):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        pm.evaluate(X, Y, batch_size=8)["loss"],
        jm.evaluate(X, Y, batch_size=8)["loss"], rtol=TOL)
    pen = float(collect_penalty(pm).detach())
    np.testing.assert_allclose(
        pen, float(j_penalty(jm, jm._estimator.state.params)), rtol=TOL)
    assert pen > 0
    assert pm.predict_classes(X[:5]).shape == (5,)


def test_custom_loss_in_fit_matches_reference(mesh8):
    """``autograd.custom_loss`` through compile/fit: the same Adam loss
    history on both sides (2 epochs of 3 steps, shuffled by the seed)."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(24, 4)).astype(np.float32)
    Y = rng.normal(size=(24, 1)).astype(np.float32)

    def expr(A):
        return A.custom_loss(lambda yt, yp: A.mean(
            A.abs(yt - yp) + 0.5 * A.square(yt - yp), axis=-1))

    jm, pm = (K.Sequential().add(K.Dense(4, activation="tanh")).add(
        K.Dense(1)) for K in (JK, PK))
    jm.compile(optimizer="adam", loss=expr(JA), lr=1e-2)
    pm.compile(optimizer="adam", loss=expr(PA), lr=1e-2, device="cpu")
    jm._get_estimator(1)._ensure_state(jm._as_dict(X[:8], Y[:8]))
    pm.build_on(X[:2])
    pm.set_weights(jm.get_weights())
    ref = jm.fit(X, Y, batch_size=8, nb_epoch=2)
    got = pm.fit(X, Y, batch_size=8, nb_epoch=2)
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in ref], rtol=TOL)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw",
                                  "adamax", "nadam", "adagrad", "adadelta",
                                  "rmsprop", "lamb"])
def test_optimizer_matches_optax(name):
    """5 steps on the same gradients from the same parameters, at each
    name's default rate: a kernel [4, 3], a bias, and a fused recurrent
    tensor (two reference leaves stacked, ``flax_chunks = 2``, for
    LAMB's per-leaf trust ratio)."""
    rng = np.random.default_rng(6)
    shapes = {"k": (4, 3), "b": (3,), "g0": (2, 5), "g1": (2, 5)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    tx = j_opt(name)
    p, st = jax.tree_util.tree_map(jnp.asarray, params), None
    st = tx.init(p)
    for g in grads:
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, p)
        p = optax.apply_updates(p, upd)
    tk = torch.nn.Parameter(torch.tensor(params["k"]))
    tb = torch.nn.Parameter(torch.tensor(params["b"]))
    tg = torch.nn.Parameter(torch.tensor(np.concatenate(
        [params["g0"], params["g1"]])))
    tg.flax_chunks = 2
    opt = get_optimizer(name)([tk, tb, tg])
    for g in grads:
        tk.grad, tb.grad = torch.tensor(g["k"]), torch.tensor(g["b"])
        tg.grad = torch.tensor(np.concatenate([g["g0"], g["g1"]]))
        opt.step()
    for got, key in ((tk, "k"), (tb, "b")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(p[key]),
                                   rtol=OPT_TOL, atol=OPT_TOL, err_msg=name)
    np.testing.assert_allclose(
        tg.detach().numpy(), np.concatenate([p["g0"], p["g1"]]),
        rtol=OPT_TOL, atol=OPT_TOL, err_msg=name)
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("adamm")


def _loss_fn(A):
    return A.custom_loss(lambda yt, yp: A.mean(A.clip(
        A.square(yt - yp) * 2 + A.log(A.exp(yp) + 1.0) - A.sqrt(
            A.abs(yt) + 1.0), -5.0, 5.0) + A.maximum(yp, 0.2) / A.minimum(
                yt + 3.0, 4.0), axis=-1))


def test_custom_loss_values_and_gradients():
    rng = np.random.default_rng(8)
    p = rng.normal(size=(6, 3)).astype(np.float32)
    t = rng.normal(size=(6, 3)).astype(np.float32)
    jl, pl = _loss_fn(JA), _loss_fn(PA)
    want, wgrad = jax.value_and_grad(lambda a: jl(a, jnp.asarray(t)))(
        jnp.asarray(p))
    tp = torch.tensor(p, requires_grad=True)
    got = pl(tp, torch.tensor(t))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wgrad),
                               rtol=TOL, atol=TOL)


def _layer(A, w0, w1):
    x, y = A.Variable.placeholder("x"), A.Variable.placeholder("y")
    w = A.Parameter((3, 2), init_weight=w0, name="w")
    b = A.Parameter((2,), init_weight=w1, name="b")
    out = A.softplus(A.mm(x, w) + b) * A.l2_normalize(A.mm(y, w), axis=-1)
    out = A.sum(A.stack([out, A.softsign(out) - w[0]], axis=1), axis=1)
    return A.CustomLayer(out_var=out, in_vars=(x, y))


def test_custom_layer_forward_and_gradients():
    """A two-input CustomLayer with Parameters used twice: forward and
    the gradients of its parameters and inputs, in a functional Model."""
    rng = np.random.default_rng(9)
    w0 = rng.normal(size=(3, 2)).astype(np.float32)
    w1 = rng.normal(size=(2,)).astype(np.float32)
    xa, xb = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2))
    jl, pl = _layer(JA, w0, w1), _layer(PA, w0, w1)
    v = jl.init({"params": jax.random.key(0)}, [jnp.asarray(xa),
                                                 jnp.asarray(xb)])

    def f(params, a, b):
        return jnp.sum(jl.apply({"params": params}, [a, b]) ** 2)

    want, (gp, ga) = jax.value_and_grad(f, argnums=(0, 1))(
        v["params"], jnp.asarray(xa), jnp.asarray(xb))
    ta = torch.tensor(xa, requires_grad=True)
    a, b = PK.Input(shape=(3,)), PK.Input(shape=(3,))
    model = PK.Model(input=[a, b], output=pl([a, b]))
    got = (model(ta, torch.tensor(xb)) ** 2).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=TOL,
                               atol=TOL)
    for name in ("w", "b"):
        np.testing.assert_allclose(getattr(pl, name).grad.numpy(),
                                   np.asarray(gp[name]), rtol=TOL, atol=TOL)
    assert sorted(get_variables(pl)["params"]) == ["b", "w"]


def test_operators_and_functions():
    x = PA.Variable.placeholder("x")
    expr = PA.clip(PA.square(x) + 2 * x - 1, -10, 10)
    np.testing.assert_allclose(expr.eval({x: torch.tensor([1.0, 2.0])}),
                               [2.0, 7.0])
    y = PA.Variable.placeholder("y")
    e = PA.squeeze(PA.expand_dims(3.0 / (1.0 - x), 0), 0) ** 2 - (-y)[0]
    got = e.eval({x: torch.tensor([3.0, 5.0]), y: torch.tensor([1.0, 4.0])})
    np.testing.assert_allclose(got, [3.25, 1.5625])
    s = PA.softmax(PA.mean(PA.sum(x, axis=0, keepdims=True), axis=0))
    assert float(s.eval({x: torch.ones(2, 3)}).sum()) == pytest.approx(1.0)
    assert PA.epsilon() == 1e-7


def test_kerasmodel_and_from_keras():
    """``tfpark.KerasModel`` is the identity on a Keras model and the
    reference's ``TypeError`` otherwise; ``Estimator.from_keras`` is
    ``from_torch`` and trains a Keras model as any module."""
    m = _mlp(PK, 1)
    assert tfpark.KerasModel(m) is m
    with pytest.raises(TypeError, match="KerasModel wraps"):
        tfpark.KerasModel(torch.nn.Linear(2, 2))
    with pytest.raises(TypeError, match="KerasModel wraps"):
        JKerasModel(object())
    assert Estimator.from_keras is Estimator.from_torch
    rng = np.random.default_rng(10)
    X = rng.normal(size=(16, 3)).astype(np.float32)
    m.build_on(X)
    est = Estimator.from_keras(model=m, loss="mse", optimizer=1e-2,
                               feature_cols=("x",), label_cols=("y",),
                               device="cpu")
    hist = est.fit({"x": X, "y": X[:, :2] * 2}, epochs=3, batch_size=8)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_save_load_without_sample(tmp_path):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(16, 6)).astype(np.float32)
    Y = rng.normal(size=(16, 1)).astype(np.float32)
    m = PK.Sequential().add(PK.Dense(8, activation="tanh")).add(
        PK.BatchNormalization()).add(PK.Dense(1))

    m.compile(optimizer="sgd", loss="mse", device="cpu")
    m.fit(X, Y, batch_size=8, nb_epoch=1)
    pred = m.predict(X[:10])
    m.save(str(tmp_path / "model"))
    m2 = PK.KerasNet.load(str(tmp_path / "model"))
    assert m2._compile_cfg["optimizer"] == "sgd"
    np.testing.assert_allclose(m2.predict(X[:10]), pred, atol=1e-6)
    for a, b in zip(m2.get_weights(), m.get_weights()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="compile"):
        PK.Sequential().add(PK.Dense(1)).fit(X, Y)
    assert "layers_1: BatchNormalization" in m.summary()
