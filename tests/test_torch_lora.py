"""The port's LoRA (``learn/lora.py``, ``Estimator.from_torch(lora=...)``)
and ``initial_variables`` held to the JAX reference.

- Target selection: the port's targets, as flax paths, are the
  reference's ``target_paths`` on the LM (GPT-2 and Llama shapes) and on
  BERT.
- The same weights (the reference initialises them, ``params_from_flax``
  carries them across) and the same adapters, set from one seed on both
  sides with ``b`` nonzero (``lora_from_flax``): 3 SGD steps give the
  same per-step losses and adapters, and the port's base is unchanged
  bitwise; under Adam the losses agree; ``merged_params`` equals
  ``params_from_flax(merge_lora(...))``.  f32 on both sides, sums in
  another order (XLA on the CPU mesh against eager PyTorch): 1e-5.
- The optimizer holds state for the adapters alone; checkpoints and
  accumulation carry them; the reference's two fail-loud cases.
- ``initial_variables``: the counterparts of the reference's
  ``test_estimator_initial_variables_seeding`` and
  ``test_initial_variables_lora_export_and_batch_stats``
  (``tests/test_hf_net.py``), on the reference's initial weights
  carried across (the HF import itself is held in
  ``tests/test_torch_hf_net.py``).
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
from analytics_zoo_tpu.learn.lora import LoRAConfig as JaxLoRAConfig
from analytics_zoo_tpu.learn.lora import merge_lora as jax_merge_lora
from analytics_zoo_tpu.learn.lora import target_paths as jax_target_paths
from analytics_zoo_tpu.models.lm import LM_PARTITION_RULES
from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.models.lm import lm_loss as jax_lm_loss
from analytics_zoo_tpu.models.transformer import BERT as JaxBERT
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.learn import Estimator, LoRAConfig
from analytics_zoo_tpu_torch.learn.estimator import latest_checkpoint
from analytics_zoo_tpu_torch.learn.lora import (LORA_KEY, flax_path,
                                                init_lora, lora_from_flax,
                                                target_paths)
from analytics_zoo_tpu_torch.models.lm import (TransformerLM, lm_loss,
                                               params_from_flax)
from analytics_zoo_tpu_torch.models.transformer import BERT

_CFG = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=16, ln_eps=1e-5)
_LLAMA = dict(_CFG, num_heads=4, num_kv_heads=2, pos_encoding="rope",
              norm="rmsnorm", mlp="swiglu", use_bias=False, qkv_bias=True,
              tied_head=False)
_BERT = dict(vocab_size=40, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position=16, dropout=0.0)
_T = 12
# f32 on both sides, sums in another order: a few ulps a step over 3
# steps
_TOL = 1e-5


@pytest.fixture()
def mesh8():
    init_orca_context("local", mesh_axes={"dp": 8})
    yield
    stop_orca_context()


@pytest.fixture(scope="module")
def weights():
    jm = JaxLM(dtype=jnp.float32, dropout=0.0, **_CFG)
    params = jm.init(jax.random.key(7), np.zeros((1, 8), np.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    toks = np.random.default_rng(1).integers(0, 32, (8, _T)).astype(
        np.int32)
    return jm, params, toks


def _adapters(params, cfg):
    """Adapters for every reference target, ``b`` nonzero, from a seed."""
    rng = np.random.default_rng(5)
    out = {}
    for path in jax_target_paths(params, cfg):
        leaf = params
        for k in path:
            leaf = leaf[k]
        n_in = 2 if path[-2] == "attn_out" else 1
        fan_in = int(np.prod(leaf.shape[:n_in]))
        fan_out = int(np.prod(leaf.shape[n_in:]))
        out["::".join(path)] = {
            "a": (rng.standard_normal((fan_in, cfg.rank)) /
                  np.sqrt(fan_in)).astype(np.float32),
            "b": (0.1 * rng.standard_normal((cfg.rank, fan_out))).astype(
                np.float32)}
    return out


def _jax_fit(weights, adapters, tx, epochs):
    jm, params, toks = weights
    est = JaxEstimator.from_flax(
        model=jm, loss=jax_lm_loss, optimizer=tx,
        feature_cols=("tokens",), label_cols=("tokens",),
        partition_rules=LM_PARTITION_RULES, initial_variables=params,
        lora=JaxLoRAConfig(rank=4), config=JaxConfig(deterministic=True))
    est._ensure_state({"tokens": toks})
    lora = est.state.params["__lora__"]
    seeded = jax.tree_util.tree_map(
        lambda dst, src: jax.device_put(src, dst.sharding), lora, adapters)
    est.state = est.state.replace(params={**est.state.params,
                                          "__lora__": seeded})
    hist = est.fit({"tokens": toks}, epochs=epochs, batch_size=8)
    return est, [h["loss"] for h in hist]


def _port_est(weights, adapters, optimizer, **kw):
    _, params, _ = weights
    tm = TransformerLM(dtype=torch.float32, **_CFG)
    est = Estimator.from_torch(
        model=tm, loss=lm_loss, optimizer=optimizer,
        feature_cols=("tokens",), label_cols=("tokens",),
        config=TrainConfig(deterministic=True, **kw), device="cpu",
        initial_variables=params_from_flax(params),
        lora=LoRAConfig(rank=4))
    if adapters is not None:
        with torch.no_grad():
            for name, ab in lora_from_flax(adapters).items():
                for k in ("a", "b"):
                    est._lora[name][k].copy_(ab[k])
    return est


@pytest.mark.parametrize("kind", ["gpt2", "llama", "bert"])
def test_targets_match_jax(kind):
    if kind == "bert":
        jm = JaxBERT(dtype=jnp.float32, **_BERT)
        tm = BERT(dtype=torch.float32, **_BERT)
    else:
        cfg = _CFG if kind == "gpt2" else _LLAMA
        jm = JaxLM(dtype=jnp.float32, **cfg)
        tm = TransformerLM(dtype=torch.float32, **cfg)
    params = jax.eval_shape(
        lambda: jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    )["params"]
    cfg = LoRAConfig()
    want = {"/".join(p) for p in jax_target_paths(params, JaxLoRAConfig())}
    got = target_paths(tm, cfg)
    assert {flax_path(tm, n) for n in got} == want
    assert len(got) == 12          # 2 layers x query key value attn_out
    #                                ffn_up ffn_down; ffn_gate, heads,
    #                                embeddings and norms stay frozen
    lora = init_lora(tm, cfg, seed=0)
    q = lora["layers.0.attention.query.weight"]
    assert q["a"].shape == (32, 8) and q["b"].shape == (8, 32)
    assert float(q["b"].detach().abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["gpt2", "llama", "bert"])
def test_flax_leaf_matches_jax(kind):
    """``flax_leaf`` of every port tensor names the reference leaf's
    shape, and takes the converted tensor back to that leaf exactly (the
    layout LoRA's merge and the int8 scales work in)."""
    from analytics_zoo_tpu_torch.models.layers import flax_leaf
    from analytics_zoo_tpu_torch.models.transformer import \
        params_from_flax as bert_from_flax

    if kind == "bert":
        jm, tm = (JaxBERT(dtype=jnp.float32, **_BERT),
                  BERT(dtype=torch.float32, **_BERT))
        convert = bert_from_flax
    else:
        cfg = _CFG if kind == "gpt2" else _LLAMA
        jm, tm = (JaxLM(dtype=jnp.float32, **cfg),
                  TransformerLM(dtype=torch.float32, **cfg))
        convert = params_from_flax
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    state = convert(params)
    assert set(state) == set(tm.state_dict())
    for name, t in state.items():
        ref = params
        for k in flax_path(tm, name).split("/"):
            ref = ref[k]
        leaf = flax_leaf(tm, name)
        assert leaf.shape == ref.shape, name
        np.testing.assert_array_equal(leaf.from_port(t).numpy(), ref)
        back = leaf.to_port(torch.from_numpy(np.array(ref)))
        assert torch.equal(back, t), name


def test_sgd_steps_match_jax(weights, mesh8):
    """3 SGD steps (one step an epoch, so the history is per step): the
    same losses and adapters; the base stays as it was, bitwise;
    ``merged_params`` equals the reference's merge."""
    _, params, toks = weights
    adapters = _adapters(params, JaxLoRAConfig(rank=4))
    ref, ref_losses = _jax_fit(weights, adapters, optax.sgd(0.5), 3)
    est = _port_est(weights, adapters,
                    lambda ps: torch.optim.SGD(ps, lr=0.5))
    base = {k: v.clone() for k, v in est.model.state_dict().items()}
    hist = est.fit({"tokens": toks}, epochs=3, batch_size=8)
    np.testing.assert_allclose([h["loss"] for h in hist], ref_losses,
                               rtol=_TOL)
    assert ref_losses[-1] < ref_losses[0]
    got = est.lora_params()
    want = lora_from_flax(jax.device_get(ref.state.params["__lora__"]))
    assert set(got) == set(want)
    for name in want:
        for k in ("a", "b"):
            np.testing.assert_allclose(got[name][k], want[name][k],
                                       atol=_TOL, rtol=0)
    for k, v in est.model.state_dict().items():
        assert torch.equal(v, base[k]), k
    merged = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax_merge_lora(jax.device_get(ref.state.params),
                                   JaxLoRAConfig(rank=4))))
    mine = est.merged_params()
    assert LORA_KEY not in mine and set(mine) == set(merged)
    for k in merged:
        np.testing.assert_allclose(mine[k], merged[k], atol=_TOL, rtol=0)


def test_adam_losses_match_jax(weights, mesh8):
    """AdamW over the adapters alone: the same loss history, and the
    optimizer's moments exist for the adapters only."""
    _, params, toks = weights
    adapters = _adapters(params, JaxLoRAConfig(rank=4))
    _, ref_losses = _jax_fit(weights, adapters, optax.adamw(1e-2), 3)
    est = _port_est(weights, adapters, lambda ps: torch.optim.AdamW(
        ps, lr=1e-2, eps=1e-8, weight_decay=1e-4))
    hist = est.fit({"tokens": toks}, epochs=3, batch_size=8)
    np.testing.assert_allclose([h["loss"] for h in hist], ref_losses,
                               rtol=_TOL)
    lora = est.lora_params()
    lora_elems = sum(t.numel() for ab in lora.values() for t in ab.values())
    state_elems = sum(t.numel() for s in est.optimizer.state.values()
                      for t in s.values() if t.dim() > 0)
    assert state_elems == 2 * lora_elems
    # the base got no gradient, and the module keeps its own flags: a
    # later estimator on it trains every parameter
    base = list(est.model.parameters())
    assert all(p.grad is None and p.requires_grad for p in base)


def test_checkpoint_roundtrip_with_lora(weights, tmp_path):
    """A saved LoRA estimator restores into a fresh one: the same
    predictions, adapters and step; auto-resume continues from it."""
    _, params, toks = weights
    est = _port_est(weights, None, 1e-2, checkpoint_dir=str(tmp_path))
    est.fit({"tokens": toks}, epochs=2, batch_size=4)
    preds = est.predict({"tokens": toks}, batch_size=4)
    est2 = _port_est(weights, None, 1e-2, checkpoint_dir=str(tmp_path))
    est2.load_checkpoint(str(tmp_path))
    assert est2._global_step == 4 == latest_checkpoint(str(tmp_path))
    np.testing.assert_allclose(est2.predict({"tokens": toks}, batch_size=4),
                               preds, rtol=1e-6, atol=1e-6)
    for name, ab in est.lora_params().items():
        for k, t in ab.items():
            assert torch.equal(est2.lora_params()[name][k], t)
    # 2 of 3 epochs are done: auto-resume trains the third alone
    hist = _port_est(weights, None, 1e-2, checkpoint_dir=str(tmp_path)).fit(
        {"tokens": toks}, epochs=3, batch_size=4, auto_resume=True)
    assert len(hist) == 1
    # an export carries the adapters, and a seeded estimator drops them
    _, exported = est.get_model()
    assert set(exported[LORA_KEY]) == set(est.lora_params())
    est.save(str(tmp_path / "export"))
    est3 = _port_est(weights, None, 1e-2)
    est3.load(str(tmp_path / "export"))
    np.testing.assert_allclose(est3.predict({"tokens": toks}, batch_size=4),
                               preds, rtol=1e-6, atol=1e-6)


def test_lora_with_gradient_accumulation(weights):
    """``accum_steps=2``: the adapters train, the base stays frozen, and
    the losses are the unaccumulated fit's (equal micro-batches of a
    mean loss, no dropout)."""
    _, params, toks = weights
    adapters = _adapters(params, JaxLoRAConfig(rank=4))
    runs = []
    for accum in (1, 2):
        est = _port_est(weights, adapters, 1e-2, accum_steps=accum)
        hist = est.fit({"tokens": toks}, epochs=3, batch_size=8)
        runs.append([h["loss"] for h in hist])
        assert not any(p.grad is not None for p in est.model.parameters())
    np.testing.assert_allclose(runs[1], runs[0], rtol=_TOL)
    assert runs[1][-1] < runs[1][0]


def test_no_match_and_unknown_split_fail_loud():
    tm = TransformerLM(dtype=torch.float32, **_CFG)
    with pytest.raises(ValueError, match="matched no"):
        Estimator.from_torch(model=tm, loss=lm_loss, device="cpu",
                             lora=LoRAConfig(rank=4,
                                             target_regex="does_not_exist"))
    cfg = LoRAConfig(rank=2, target_regex=r"query/kernel$", splits=())
    with pytest.raises(ValueError, match="input-dims split"):
        init_lora(tm, cfg, seed=1)


def _fresh():
    return TransformerLM(dtype=torch.float32, **_CFG)


def test_initial_variables_seeding(weights):
    """The estimator's weights are the imported ones, plain and as the
    frozen LoRA base (adapters fresh, loss falls); a wrong checkpoint
    raises."""
    state = params_from_flax(weights[1])
    data = {"tokens": np.random.default_rng(3).integers(
        0, 32, (16, 12)).astype(np.int32)}
    est = Estimator.from_torch(model=_fresh(), loss=lm_loss,
                               optimizer=1e-3, feature_cols=("tokens",),
                               label_cols=("tokens",), device="cpu",
                               initial_variables=state)
    for k, v in est.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    est2 = Estimator.from_torch(
        model=_fresh(), loss=lm_loss, optimizer=1e-2,
        feature_cols=("tokens",), label_cols=("tokens",), device="cpu",
        initial_variables={"params": state}, lora=LoRAConfig(rank=4))
    hist = est2.fit(data, epochs=2, batch_size=8)
    assert hist[-1]["loss"] < hist[0]["loss"]
    for k, v in est2.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    bad = {k: torch.zeros(2, 2) for k in state}
    with pytest.raises(ValueError, match="do not match"):
        Estimator.from_torch(model=_fresh(), loss=lm_loss,
                             device="cpu", initial_variables={"params": bad})
    with pytest.raises(ValueError, match="do not match"):
        Estimator.from_torch(model=_fresh(), loss=lm_loss,
                             device="cpu", initial_variables=dict(
                                 state, extra=torch.zeros(1)))


def test_initial_variables_lora_export_and_batch_stats(weights):
    """A LoRA export seeds a plain estimator with its adapters dropped
    and its base exact; a model with BatchNorm statistics refuses a
    source without them and takes one with them."""
    from analytics_zoo_tpu_torch.models.layers import BatchNorm, Dense

    state = params_from_flax(weights[1])
    data = {"tokens": np.random.default_rng(4).integers(
        0, 32, (16, 10)).astype(np.int32)}
    lora_est = Estimator.from_torch(
        model=_fresh(), loss=lm_loss, optimizer=1e-3,
        feature_cols=("tokens",), label_cols=("tokens",), device="cpu",
        initial_variables=state, lora=LoRAConfig(rank=4))
    lora_est.fit(data, epochs=1, batch_size=8)
    _, exported = lora_est.get_model()
    assert LORA_KEY in exported
    est = Estimator.from_torch(model=_fresh(), loss=lm_loss,
                               device="cpu",
                               initial_variables={"params": exported})
    for k, v in est.model.state_dict().items():
        assert torch.equal(v, state[k]), k

    class BN(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = Dense(4, 8)
            self.BatchNorm_0 = BatchNorm(8)
            self.Dense_1 = Dense(8, 2)

        def forward(self, x, train: bool = False):
            return self.Dense_1(self.BatchNorm_0(self.Dense_0(x), train))

    torch.manual_seed(0)
    full = BN().state_dict()
    buffers = {"BatchNorm_0.running_mean", "BatchNorm_0.running_var"}
    params = {k: v for k, v in full.items() if k not in buffers}
    xd = {"x": np.random.default_rng(4).normal(size=(16, 4)).astype(
        np.float32), "y": np.random.default_rng(5).integers(0, 2, 16)}
    with pytest.raises(ValueError, match="batch_stats"):
        Estimator.from_torch(model=BN(), loss="sparse_categorical_"
                             "crossentropy", device="cpu",
                             initial_variables={"params": params})
    good = Estimator.from_torch(
        model=BN(), loss="sparse_categorical_crossentropy", optimizer=1e-3,
        feature_cols=("x",), label_cols=("y",), device="cpu",
        initial_variables={"params": params, "batch_stats": {
            k: full[k] for k in buffers}})
    good.fit(xd, epochs=1, batch_size=8)
    assert good.model.BatchNorm_0.running_mean.shape == (8,)
