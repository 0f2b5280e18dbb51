"""Shared by the port's tensor-parallel serving tests
(``test_torch_tp_*.py``): the reference's weights converted for the
workers, the host tier's and the fleet's inputs, and the JAX engine's
tokens on the 8-device CPU mesh at tp=2.
Each test module starts one two-rank worker launch
(``_torch_dist_worker.py`` scenario ``tp``, the combos it names) and
computes the JAX tokens while the workers run."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from analytics_zoo_tpu.models.lm import TransformerLM as JaxLM
from analytics_zoo_tpu.parallel.mesh import make_mesh
from analytics_zoo_tpu.serving.continuous import \
    ContinuousEngine as JaxEngine
from analytics_zoo_tpu_torch.models.lm import params_from_flax

from _torch_dist import Ranks

CFG = dict(vocab_size=32, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position=64)
DRAFT = dict(vocab_size=32, hidden_size=64, num_layers=1, num_heads=2,
             intermediate_size=64, max_position=64)
LLAMA = dict(vocab_size=32, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_size=96, max_position=64,
             pos_encoding="rope", norm="rmsnorm", mlp="swiglu",
             use_bias=False, tied_head=False)
MQA = dict(vocab_size=32, hidden_size=128, num_layers=1, num_heads=4,
           num_kv_heads=1, intermediate_size=96, max_position=64)
# the JAX engine's keywords for each combo (the reference reads paged
# pools through its gather by default)
JAX_KW = {
    "arena": dict(ticks_per_step=2),
    "paged": dict(paged=True, block_size=4),
    "chunked": dict(chunked=True, tick_token_budget=8),
    "spec": dict(_spec=True),
    "paged-chunked": dict(paged=True, block_size=4, chunked=True,
                          tick_token_budget=8),
    "spec-paged": dict(paged=True, block_size=4, _spec=True),
    "spec-chunked": dict(chunked=True, tick_token_budget=12, _spec=True),
    "spec-paged-chunked": dict(paged=True, block_size=4, chunked=True,
                               tick_token_budget=12, _spec=True),
    "fused-paged": dict(paged=True, block_size=4, kernel="fused"),
    "fused-paged-chunked": dict(paged=True, block_size=4, chunked=True,
                                tick_token_budget=8, kernel="fused"),
    "fused-spec-paged": dict(paged=True, block_size=4, _spec=True,
                             kernel="fused"),
    "fused-spec-paged-chunked": dict(paged=True, block_size=4,
                                     chunked=True, tick_token_budget=12,
                                     _spec=True, kernel="fused"),
    "int8-fused": dict(paged=True, block_size=4, kv_dtype="int8",
                       kernel="fused"),
}


def _jax_model(cfg, seed):
    """The reference model and seeded normal weights in its tree
    (``jax.eval_shape`` of its init: no init compile), scales near 1."""
    m = JaxLM(**cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(m.init, jax.random.key(0),
                            np.zeros((1, 8), np.int32))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        w = 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return w + 1.0 if path[-1].key == "scale" else w
    return m, jax.tree_util.tree_map_with_path(leaf, shapes)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return {f"u{i}": rng.integers(1, 32, n).astype(np.int32)
            for i, n in enumerate(lengths)}


def tp_inputs(outdir, combos, extras):
    """The weights (the reference's init, converted) and prompts the
    workers read, and the JAX models for the reference's runs."""
    jm, jv = _jax_model(CFG, 0)
    dm, dv = _jax_model(DRAFT, 9)
    qm, qv = _jax_model(MQA, 3)
    lm_, lv = _jax_model(LLAMA, 4)
    inp = {"combos": list(combos), "extras": extras,
           "cfg": dict(CFG, dtype=torch.float32),
           "draft_cfg": dict(DRAFT, dtype=torch.float32),
           "mqa_cfg": dict(MQA, dtype=torch.float32),
           "state": params_from_flax(jv["params"]),
           "draft_state": params_from_flax(dv["params"]),
           "mqa_state": params_from_flax(qv["params"]),
           "llama_cfg": dict(LLAMA, dtype=torch.float32),
           "params": jax.device_get(jv["params"]),
           "llama_params": jax.device_get(lv["params"]),
           "logit_tokens": np.random.default_rng(2).integers(
               0, 32, (2, 12)).astype(np.int32),
           "prompts": _prompts(21, (4, 6, 5)),
           "prompts_chunked": _prompts(21, (4, 12, 6))}
    torch.save(inp, outdir / "tp_in.pt")
    return inp, {"lm": (jm, jv), "draft": (dm, dv), "mqa": (qm, qv),
                 "llama": (lm_, lv)}


def jax_tokens(models, combo, prompts, mesh):
    """The JAX engine's greedy tokens on ``mesh`` (the sampled row left
    out)."""
    jm, jv = models["lm"]
    kw = dict(JAX_KW[combo])
    if kw.pop("_spec", False):
        dm, dv = models["draft"]
        kw.update(draft_model=dm, draft_variables=dv, speculation_k=2)
    eng = JaxEngine(jm, jv, mesh=mesh, max_new_tokens=5, max_slots=2,
                    prompt_buckets=(8, 16), eos_id=7, **kw)
    got = {}
    for u, p in prompts.items():
        eng.submit(u, p, max_new=3 + (int(u[1:]) % 3),
                   on_done=lambda uri, t: got.__setitem__(
                       uri, np.asarray(t).tolist()))
    eng.drain()
    return got


def run_module(tmp_path_factory, combos, extras):
    """One worker launch for the module, and the JAX engine's tokens on
    the tp=2 mesh for each combo."""
    outdir = tmp_path_factory.mktemp("tp")
    inp, models = tp_inputs(outdir, combos, extras)
    workers = Ranks("tp", outdir, 2)
    mesh = make_mesh(axes={"dp": -1, "tp": 2})
    ref = {c: jax_tokens(models, c, inp["prompts_chunked" if "chunked" in c
                                        else "prompts"], mesh)
           for c in combos if c in JAX_KW}
    return inp, workers.wait(), ref, models


def check_combo(tp, combo):
    """Port tp=2 = port tp=1 for every row (a sampled one included
    outside speculation), and = the JAX engine on its tp=2 mesh for the
    greedy rows."""
    _, ranks, ref, _ = tp
    got = ranks[0]["tokens"]
    assert got[(combo, "tp2")] == got[(combo, "tp1")], combo
    for u, toks in ref[combo].items():
        if u == "u2" and "spec" not in combo:
            continue            # sampled on the port side
        assert got[(combo, "tp2")][u] == toks, (combo, u)


# the host tier's and the fleet's inputs (test_torch_tp_tier.py and
# test_torch_tp_fleet.py)
PA = np.arange(1, 14, dtype=np.int32)          # 13 tokens, 3 full blocks
PB = np.arange(15, 28, dtype=np.int32)         # disjoint head
PC = np.array([2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26], np.int32)


def _token_prompts(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return {f"h{i}": rng.integers(1, 32, int(rng.integers(lo, hi)))
            .astype(np.int32) for i in range(n)}


def _fleet_prompts():
    """Six prompts, three of them sharing a 9-token head (two full
    blocks the directory can route by)."""
    out = _token_prompts(5, 6, 3, 8)
    head = np.arange(3, 12, dtype=np.int32)
    for i in (1, 3, 5):
        out[f"h{i}"] = np.concatenate([head, out[f"h{i}"][:2]])
    return out


def tier_inputs(outdir):
    """The weights (the reference's init, converted) and prompts the
    workers read (``tier_in.pt``), and the JAX model and its tree."""
    jm, jv = _jax_model(CFG, 0)
    inp = {"cfg": dict(CFG, dtype=torch.float32),
           "state": params_from_flax(jv["params"]),
           "PA": PA, "PB": PB, "PC": PC,
           "handoff_prompts": _token_prompts(11, 4, 2, 14),
           "fleet_prompts": _fleet_prompts()}
    torch.save(inp, outdir / "tier_in.pt")
    return inp, jm, jv
