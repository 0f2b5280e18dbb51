"""Engines on a dp x tp mesh: ``ContinuousEngine(mesh=...)`` over four
gloo processes laid out ``{"dp": 2, "tp": 2}`` (one a rank,
``_torch_dist_worker.py`` scenario ``dptp``) against the port's
one-rank engine and the JAX engine on a ``{"dp": 2, "tp": 2}`` mesh of
the conftest's CPU devices, on the same flax weights.

The reference shards over tp and replicates over every other axis, so
each dp line serves the tokens of a tp=2 engine.  In the port the rank
at coordinate 0 on every axis leads both lines: its control group spans
the four ranks, each line shards the model over its own tp pair.
Greedy tokens must equal the reference's in the paged-fused (the
kernel's plain version on the CPU), gather, chunked and arena modes,
and a sampled row must equal the port's one-rank engine; every rank
makes the same calls and holds one kv head of two.
"""

import jax
import pytest

from analytics_zoo_tpu.parallel.mesh import make_mesh

from _torch_dist import Ranks
from _torch_tp import jax_tokens, tp_inputs

COMBOS = ("fused-paged", "paged", "chunked", "arena")


@pytest.fixture(scope="module")
def dptp(tmp_path_factory, devices):
    outdir = tmp_path_factory.mktemp("dptp")
    inp, models = tp_inputs(outdir, COMBOS, False)
    workers = Ranks("dptp", outdir, 4)
    mesh = make_mesh(devices=jax.devices()[:4], axes={"dp": 2, "tp": 2})
    ref = {c: jax_tokens(models, c, inp["prompts_chunked" if "chunked" in c
                                        else "prompts"], mesh)
           for c in COMBOS}
    return inp, workers.wait(), ref


@pytest.mark.parametrize("combo", COMBOS)
def test_dp2_tp2_matches_tp1_and_jax(dptp, combo):
    """dp2 x tp2 = the port's tp=1 for every row (the sampled one
    included) and = the JAX engine on its dp2 x tp2 mesh for the greedy
    rows."""
    _, ranks, ref = dptp
    got = ranks[0]["tokens"]
    assert got[(combo, "dp2tp2")] == got[(combo, "tp1")], combo
    assert set(got[(combo, "dp2tp2")]) == set(ref[combo])
    for u, toks in ref[combo].items():
        if u == "u2":
            continue            # sampled on the port side
        assert got[(combo, "dp2tp2")][u] == toks, (combo, u)


def test_every_rank_replays_the_leader(dptp):
    """The four ranks sit at the four (dp, tp) coordinates, make the
    leader's calls (prefills, or chunk calls when chunked, and decode
    ticks) and hold one kv
    head of two in their pools and arenas."""
    _, ranks, _ = dptp
    assert sorted((r["coords"]["dp"], r["coords"]["tp"]) for r in ranks) \
        == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for combo in COMBOS:
        calls = {r["calls"][combo] for r in ranks}
        assert len(calls) == 1, (combo, calls)
        (prefills, ticks, chunks, shape), = calls
        assert ticks > 0 and (prefills > 0) != ("chunked" in combo)
        assert shape[2 if "paged" in combo else 3] == 1, (combo, shape)
        assert (chunks > 0) == ("chunked" in combo)
