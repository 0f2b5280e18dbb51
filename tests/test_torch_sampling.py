"""Sampled decoding in the port, held to the reference's contract.

threefry and the port's counter-based draw give different tokens, so
sampled rows are held to the reference's invariants instead of its
tokens: the nucleus mask equals JAX's ``top_p_filter`` on the same
logits; the draws follow softmax(logits / T) (a chi-square test at fixed
seeds); a draw is a pure function of (seed, position, logits); the
engine (arena and paged, with a registered prefix) emits what the port's
``generate`` emits for the same seed; and a row preempted by a dry block
pool replays identical tokens.  Greedy rows sharing a batch with
sampled ones keep the JAX tokens exactly (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.models.lm import generate as jax_generate
from analytics_zoo_tpu.models.lm import top_p_filter as jax_top_p_filter
from analytics_zoo_tpu_torch.models.lm import (TransformerLM,
                                               draw_uniforms, generate,
                                               params_from_flax, pick_next,
                                               top_p_filter)
from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine

_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64, ln_eps=1e-5)
_ENGINE = dict(max_new_tokens=8, max_slots=3, prompt_buckets=(8, 16),
               block_size=4)
# chi-square critical values at p = 0.001 by degrees of freedom
_CHI2_999 = {7: 24.322, 4: 18.467}


def _tie_free_logits(rng, shape, scale=2.0):
    """Logits with no two equal values in a row (a tie makes the
    nucleus boundary depend on sort stability, not on the filter)."""
    x = rng.standard_normal(shape) * scale
    return (x + np.arange(shape[-1]) * 1e-3).astype(np.float32)


@pytest.mark.parametrize("top_p", [0.0, 0.05, 0.2, 0.5, 0.75, 0.9, 0.99,
                                   1.0, 1.5, -0.1])
def test_top_p_mask_matches_jax(top_p):
    logits = _tie_free_logits(np.random.default_rng(0), (16, 32))
    ref = np.asarray(jax_top_p_filter(jnp.asarray(logits),
                                      jnp.float32(top_p)))
    got = top_p_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_array_equal(got[~np.isinf(got)],
                                  logits[~np.isinf(ref)])
    # the most probable token always survives
    assert np.isfinite(got[np.arange(16), logits.argmax(-1)]).all()


def test_top_p_per_row_matches_jax():
    rng = np.random.default_rng(1)
    logits = _tie_free_logits(rng, (8, 16))
    top_p = np.array([0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0, 0.95],
                     np.float32)[:, None]
    ref = np.asarray(jax_top_p_filter(jnp.asarray(logits),
                                      jnp.asarray(top_p)))
    got = top_p_filter(torch.from_numpy(logits),
                       torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))


def _draws(logits, seed, n, temp=1.0, top_p=None):
    """``n`` draws from one row of logits at positions 0..n-1."""
    lg = torch.from_numpy(np.repeat(logits[None], n, 0))
    return pick_next(
        lg, torch.arange(n), torch.full((n,), temp),
        torch.full((n,), seed, dtype=torch.int64),
        None if top_p is None else torch.full((n,), top_p)).numpy()


@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("temp,top_p", [(1.0, None), (0.7, None),
                                        (1.3, 0.8)])
def test_draws_follow_softmax(seed, temp, top_p):
    """Chi-square of 20000 draws over vocab 8 against
    softmax(logits / T), restricted to the nucleus when ``top_p`` is
    set (p = 0.001 critical value)."""
    logits = np.array([1.2, 0.3, -0.5, 2.0, 0.0, -1.0, 0.8, 0.5],
                      np.float32)
    n = 20000
    toks = _draws(logits, seed, n, temp, top_p)
    scaled = torch.from_numpy(logits[None]) / temp
    if top_p is not None:
        scaled = top_p_filter(scaled, top_p)
    p = torch.softmax(scaled, -1)[0].double().numpy()
    keep = p > 0
    counts = np.bincount(toks, minlength=8)
    assert counts[~keep].sum() == 0        # filtered tokens never drawn
    expected = n * p[keep]
    chi2 = float(((counts[keep] - expected) ** 2 / expected).sum())
    assert chi2 < _CHI2_999[int(keep.sum()) - 1], (chi2, counts, expected)


def test_draw_is_a_function_of_seed_position_logits():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(_tie_free_logits(rng, (6, 64), 1.0))
    pos = torch.tensor([0, 5, 9, 17, 33, 60])
    t = torch.full((6,), 0.9)
    s = torch.tensor([11, 11, 12, 12, 2 ** 32 - 1, 0])
    a = pick_next(logits, pos, t, s, torch.full((6,), 0.95))
    b = pick_next(logits.clone(), pos.clone(), t, s.clone(),
                  torch.full((6,), 0.95))
    assert torch.equal(a, b)
    # a row's draw does not depend on the other rows of its batch
    for i in range(6):
        one = pick_next(logits[i:i + 1], pos[i:i + 1], t[i:i + 1],
                        s[i:i + 1], torch.full((1,), 0.95))
        assert int(one) == int(a[i])
    # seeds are taken mod 2**32, as the engine masks them
    assert torch.equal(draw_uniforms(torch.tensor([5]), [3], 16),
                       draw_uniforms(torch.tensor([5 + 2 ** 32]), [3], 16))
    # another seed, or another position, draws other tokens
    flat = torch.zeros(1, 64)
    seq = [int(pick_next(flat, torch.tensor([p]), torch.ones(1),
                         torch.tensor([1]))) for p in range(40)]
    other = [int(pick_next(flat, torch.tensor([p]), torch.ones(1),
                           torch.tensor([2]))) for p in range(40)]
    assert seq != other and len(set(seq)) > 20
    u = draw_uniforms(torch.arange(4), torch.zeros(4), 1000)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0


def test_greedy_rows_pick_the_argmax():
    logits = torch.from_numpy(_tie_free_logits(np.random.default_rng(3),
                                               (4, 32)))
    pos = torch.arange(4)
    got = pick_next(logits, pos, torch.tensor([0.0, 0.8, 0.0, 0.5]),
                    torch.tensor([1, 2, 3, 4]))
    assert int(got[0]) == int(logits[0].argmax())
    assert int(got[2]) == int(logits[2].argmax())
    assert torch.equal(pick_next(logits, pos),
                       logits.argmax(-1).to(torch.int32))


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(dtype=jnp.float32, num_kv_heads=2, **_CFG)
    variables = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    state = params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    tm = TransformerLM(dtype=torch.float32, num_kv_heads=2, **_CFG)
    tm.load_state_dict(state)
    return jm, variables, tm, state


_PREFIX = np.arange(20, 29, dtype=np.int32)


def _requests():
    """(uri, prompt, temperature, seed, top_p, uses the prefix)."""
    rng = np.random.default_rng(5)
    out = []
    for i, n in enumerate([5, 12, 3, 9, 14, 7]):
        p = rng.integers(1, 64, n).astype(np.int32)
        if i % 2:
            out.append((f"g{i}", p, 0.0, None, 0.0, False))
        else:
            out.append((f"s{i}", p, 0.8, 100 + i, 0.9 if i == 2 else 0.0,
                        False))
    out.append(("sp", np.array([7, 8, 9], np.int32), 1.1, 42, 0.0, True))
    out.append(("gp", np.array([30, 31, 32, 33], np.int32), 0.0, None,
                0.0, True))
    return out


def _serve(engine):
    out = {}
    pid = engine.register_prefix(_PREFIX)
    for uri, p, temp, seed, top_p, pref in _requests():
        engine.submit(uri, p, lambda u, t: out.__setitem__(u, t),
                      temperature=temp, rng_seed=seed, top_p=top_p,
                      prefix=pid if pref else None)
    engine.drain()
    return out


def _generate_one(tm, prompt, temp, seed, top_p):
    return generate(tm, None, prompt[None], _ENGINE["max_new_tokens"],
                    temperature=temp, top_p=top_p, rng=seed,
                    device="cpu")[0].numpy()


@pytest.mark.parametrize("paged,n_blocks", [(False, None), (True, None),
                                            (True, 9)])
def test_engine_equals_generate(models, paged, n_blocks):
    """Sampled and greedy rows in one engine equal ``generate`` of each
    prompt alone with the same seed (a prefix request against the
    concatenated prompt); ``n_blocks=9`` makes the paged pool preempt
    rows, which replay identical tokens.  Greedy rows also equal JAX
    ``generate``."""
    jm, variables, tm, state = models
    eng = ContinuousEngine(tm, None, device="cpu", paged=paged,
                           n_blocks=n_blocks, **_ENGINE)
    got = _serve(eng)
    if n_blocks is not None:
        assert eng.cache_metrics()["preemptions"] > 0
    for uri, p, temp, seed, top_p, pref in _requests():
        full = np.concatenate([_PREFIX, p]) if pref else p
        ref = _generate_one(tm, full, temp, seed, top_p)
        np.testing.assert_array_equal(got[uri], ref, err_msg=uri)
        if temp == 0.0:
            jref = np.asarray(jax_generate(jm, variables, full[None],
                                           _ENGINE["max_new_tokens"]))[0]
            np.testing.assert_array_equal(got[uri], jref, err_msg=uri)
    # sampling changed the sampled rows' tokens
    for uri, p, temp, seed, top_p, pref in _requests():
        if temp > 0:
            full = np.concatenate([_PREFIX, p]) if pref else p
            greedy = _generate_one(tm, full, 0.0, None, 0.0)
            assert not np.array_equal(got[uri], greedy), uri


def test_engine_ticks_per_step_keeps_the_draws(models):
    """Four ticks a step draw at the same positions as one tick a
    step."""
    tm = models[2]
    one = _serve(ContinuousEngine(tm, None, device="cpu", paged=True,
                                  **_ENGINE))
    four = _serve(ContinuousEngine(tm, None, device="cpu", paged=True,
                                   ticks_per_step=4, **_ENGINE))
    assert one.keys() == four.keys()
    for uri in one:
        np.testing.assert_array_equal(one[uri], four[uri], err_msg=uri)


def test_sampled_generate_rows_and_seeds(models):
    """A batch of sampled rows equals each row alone; per-row seeds
    equal single-seed calls; ``rng`` is required."""
    tm = models[2]
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, 64, (3, 9)).astype(np.int32)
    plen = np.array([9, 4, 6], np.int32)
    batch = generate(tm, None, prompt, 6, plen, temperature=0.9,
                     top_k=20, rng=[1, 2, 3], device="cpu").numpy()
    for i in range(3):
        alone = generate(tm, None, prompt[i:i + 1, :plen[i]], 6,
                         temperature=0.9, top_k=20, rng=i + 1,
                         device="cpu").numpy()
        np.testing.assert_array_equal(batch[i], alone[0])
    with pytest.raises(ValueError, match="rng="):
        generate(tm, None, prompt, 6, temperature=0.9, device="cpu")


def test_sampled_submit_needs_a_seed(models):
    eng = ContinuousEngine(models[2], None, device="cpu", **_ENGINE)
    with pytest.raises(ValueError, match="rng_seed"):
        eng.submit("x", np.arange(1, 5, dtype=np.int32), temperature=0.5)
    assert eng.n_waiting == 0
