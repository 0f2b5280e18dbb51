"""Draft distillation on the port (``models/distill.py``) held to the JAX
reference, and the reference's own checks (``tests/test_distill.py``) on
the port.

- ``DistillLM``'s per-sample loss (temperature-softened forward KL plus
  a next-token CE share) equals the reference's on the same weights
  (``params_from_flax`` of the reference's ``draft`` and ``target``
  subtrees): f32, within 1e-5.
- At the reference test's size (a target trained on a deterministic
  token pattern, a 1-layer draft): distillation raises the speculative
  acceptance by at least one token a round; the target stays frozen;
  the optimizer holds state for the draft's parameters only; a vocab
  mismatch and a wrong target checkpoint raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.distill import DistillLM as JaxDistillLM
from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.models.distill import (DistillLM,
                                                    distill_draft,
                                                    distill_loss,
                                                    freeze_target_optimizer)
from analytics_zoo_tpu_torch.models.lm import (TransformerLM, lm_loss,
                                               params_from_flax)
from analytics_zoo_tpu_torch.models.speculative import speculative_generate


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """The full suite runs in 6 pytest-xdist workers that share the
    machine's cores; torch's default of one intra-op thread a core
    oversubscribes them, and small eager ops then spend their time
    handing work between threads (the distillation test took 140.6 s in
    a 6-worker run against 5 s alone). One torch thread for this file,
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V, T = 64, 160
_TARGET = dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=2,
               intermediate_size=64, max_position=T)
_DRAFT = dict(vocab_size=V, hidden_size=16, num_layers=1, num_heads=2,
              intermediate_size=32, max_position=T)
_ATOL = 1e-5


def test_distill_loss_matches_jax(temperature=2.0, ce_weight=0.1):
    pair = JaxDistillLM(draft=JaxLM(dtype=jnp.float32, **_DRAFT),
                        target=JaxLM(dtype=jnp.float32, **_TARGET),
                        temperature=temperature, ce_weight=ce_weight)
    toks = np.random.default_rng(2).integers(0, V, (3, 12)).astype(
        np.int32)
    variables = jax.jit(pair.init)(jax.random.key(1), toks)
    want = np.asarray(jax.jit(pair.apply)(variables, toks))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    draft = TransformerLM(dtype=torch.float32, **_DRAFT)
    target = TransformerLM(dtype=torch.float32, **_TARGET)
    draft.load_state_dict(params_from_flax(params["draft"]))
    target.load_state_dict(params_from_flax(params["target"]))
    got = DistillLM(draft, target, temperature=temperature,
                    ce_weight=ce_weight)(torch.from_numpy(toks), True,
                                         rng=0)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=_ATOL,
                               rtol=0)
    got.mean().backward()
    assert all(p.grad is None for p in target.parameters())
    assert all(p.grad is not None for p in draft.parameters())


@pytest.fixture(scope="module")
def target_setup():
    """A briefly-trained target on a deterministic token pattern, as the
    reference's test trains it: it must have structure to transfer."""
    torch.manual_seed(0)
    target = TransformerLM(dtype=torch.float32, **_TARGET)
    rng = np.random.default_rng(0)
    start = rng.integers(0, V, (64, 1))
    seqs = [start]
    for _ in range(31):
        seqs.append((seqs[-1] * 3 + 1) % V)
    corpus = {"tokens": np.concatenate(seqs, 1).astype(np.int32)}
    est = Estimator.from_torch(
        model=target, loss=lm_loss,
        # optax.adamw(3e-3)'s defaults
        optimizer=lambda ps: torch.optim.AdamW(ps, lr=3e-3,
                                               weight_decay=1e-4),
        feature_cols=("tokens",), label_cols=("tokens",), device="cpu")
    est.fit(corpus, epochs=10, batch_size=8)
    return target, {k: v.clone() for k, v in target.state_dict().items()}, \
        corpus


def _draft():
    return TransformerLM(dtype=torch.float32, **_DRAFT)


def test_distillation_raises_speculative_acceptance(target_setup):
    target, state, corpus = target_setup
    torch.manual_seed(1)
    draft = _draft()
    prompt = corpus["tokens"][:4, :8]
    _, s0 = speculative_generate(target, state, draft, None, prompt, 24,
                                 k=4, device="cpu")
    dv, hist = distill_draft(target, state, draft, corpus, epochs=10,
                             batch_size=8, device="cpu")
    _, s1 = speculative_generate(target, None, draft, dv, prompt, 24, k=4,
                                 device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert (s1["mean_accepted_per_round"]
            >= s0["mean_accepted_per_round"] + 1.0), (s0, s1)


def test_target_stays_frozen(target_setup):
    target, state, corpus = target_setup
    dv, _ = distill_draft(target, state, _draft(), corpus, epochs=2,
                          batch_size=8, device="cpu")
    for k, v in target.state_dict().items():
        assert torch.equal(v, state[k]), k
    # frozen for the fit only: the target's own flags are back
    assert all(p.requires_grad for p in target.parameters())
    # a plain servable draft state_dict
    assert set(dv) == set(_draft().state_dict())


def test_optimizer_state_only_for_draft(target_setup):
    target, state, corpus = target_setup
    target.load_state_dict(state)
    draft = _draft()
    est = Estimator.from_torch(
        model=DistillLM(draft, target), loss=distill_loss,
        optimizer=freeze_target_optimizer(
            lambda ps: torch.optim.AdamW(ps, lr=1e-3)),
        feature_cols=("tokens",), label_cols=("tokens",), device="cpu")
    est.fit({k: v[:16] for k, v in corpus.items()}, epochs=1, batch_size=8)
    draft_elems = sum(p.numel() for p in draft.parameters())
    opt_elems = sum(t.numel() for s in est.optimizer.state.values()
                    for t in s.values() if t.dim() > 0)
    assert opt_elems == 2 * draft_elems     # AdamW's two moments, draft only


def test_vocab_mismatch_fails_loud(target_setup):
    target, state, corpus = target_setup
    bad = TransformerLM(dtype=torch.float32, **dict(_DRAFT,
                                                    vocab_size=V * 2))
    with pytest.raises(ValueError, match="vocab"):
        distill_draft(target, state, bad, corpus, epochs=1, batch_size=8,
                      device="cpu")


def test_wrong_target_checkpoint_fails_loud(target_setup):
    target, state, corpus = target_setup
    wrong = {k: torch.zeros(3, 3) for k in state}
    with pytest.raises(ValueError, match="do not match"):
        distill_draft(target, wrong, _draft(), corpus, epochs=1,
                      batch_size=8, device="cpu")

