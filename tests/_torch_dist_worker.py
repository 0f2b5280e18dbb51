"""One rank of the port's multi-process scenarios (started by
``tests/_torch_dist.py``): ``python _torch_dist_worker.py <scenario>
<rank> <world> <port> <outdir>``.  Joins a gloo process group on
localhost through ``init_orca_context("distributed")`` (the launcher's
environment variables, as ``torchrun`` sets them), runs the scenario on
the CPU and saves what it observed to ``<outdir>/<scenario>_<rank>.pt``.
Inputs the test made (weights, data) are read from ``<outdir>``.
Imports torch and the port only."""

import os
import sys

import numpy as np
import torch


def _setup(rank, world, port):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# meshes, partition rules, the context and the two sharded wrappers
# ---------------------------------------------------------------------------

def scenario_mesh(rank, world, outdir):
    from analytics_zoo_tpu_torch.common import context
    from analytics_zoo_tpu_torch.data.feature_set import _host_path
    from analytics_zoo_tpu_torch.data.readers import _host_slice
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.parallel import (
        FSDP_RULES, P, data_process_groups, data_sharding, gather_tensor,
        make_mesh, match_partition_rules, mesh_batch_size, shard_tensor)
    from analytics_zoo_tpu_torch.parallel.partition import batch_rows

    ctx = context.init_orca_context("distributed",
                                    mesh_axes={"tp": 2, "dp": -1},
                                    device="cpu")
    mesh = ctx.mesh
    out = {"axis_names": mesh.axis_names, "shape": dict(mesh.shape),
           "num_devices": ctx.num_devices,
           "process": (ctx.process_index, ctx.num_processes),
           "effective": (context.effective_process_count(),
                         context.effective_process_index()),
           "coords": mesh.coords(rank), "tp_line": mesh.group_ranks("tp"),
           "groups": data_process_groups(data_sharding(mesh)),
           "batch_size": mesh_batch_size(mesh),
           "rows": batch_rows(mesh, 8), "host_path": _host_path("s{host}.z"),
           "files": _host_slice([f"f{i}" for i in range(5)], None, None)}
    try:
        make_mesh(axes={"tp": 3})
    except ValueError as e:
        out["bad_axes"] = str(e)
    tree = {"dense": {"kernel": np.zeros((16, 8)), "bias": np.zeros((8,))},
            "emb": {"embedding": np.zeros((100, 7))},
            "scalar": np.float32(3.0)}
    rules = ((r"emb/embedding", P(None, "tp")), (r"kernel", P(None, "tp")),
             (r".*", P()))
    out["specs"] = match_partition_rules(rules, tree, mesh)
    try:
        match_partition_rules(FSDP_RULES, tree, mesh)
    except NotImplementedError as e:
        out["fsdp"] = str(e)
    full = torch.arange(48, dtype=torch.float32).reshape(4, 12)
    shard = shard_tensor(full, P("dp", "tp"), mesh)
    out["shard"] = shard
    out["gathered"] = gather_tensor(shard, P("dp", "tp"), mesh)

    # sharded_flash_attention: this rank's rows (dp) and heads (tp),
    # no collective; the test holds the gathered result to the whole
    g = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(g.standard_normal((4, 16, 4, 32)).astype(
        np.float32)) for _ in range(3))
    mask = torch.from_numpy(g.random((4, 16)) > 0.2)
    r, h = batch_rows(mesh, 4), slice(mesh.coord("tp") * 2,
                                      mesh.coord("tp") * 2 + 2)
    local = fa.sharded_flash_attention(
        q[r, :, h].contiguous(), k[r, :, h].contiguous(),
        v[r, :, h].contiguous(), mask[r], causal=True)
    out["flash_whole"] = fa.flash_attention(q, k, v, mask, causal=True)
    out["flash_mine"] = gather_tensor(local.contiguous(),
                                      P("dp", None, "tp"), mesh)

    # paged_attention_fused_tp on this rank's kv-head shard (f32 and an
    # int8 pool with its scales) and the replicated hatch
    B, S, H, KH, D, bs, N = 2, 3, 4, 2, 32, 4, 9
    qp = torch.from_numpy(g.standard_normal((B, S, H, D)).astype(
        np.float32))
    pools = [torch.from_numpy(g.standard_normal((N, KH, bs, D)).astype(
        np.float32)) for _ in range(2)]
    tables = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 7]], dtype=torch.int32)
    pos = torch.tensor([5, 9], dtype=torch.int32)
    t = mesh.coord("tp")
    for name, (pk, pv) in {"f32": pools, "int8": [
            fa.QuantKV(*fa.quantize_kv(p)) for p in pools]}.items():
        whole = fa.paged_attention(qp, pk, pv, tables, pos, kernel="gather")
        cut = (lambda p: fa.QuantKV(p.data[:, t:t + 1].contiguous(),
                                    p.scale[:, t:t + 1].contiguous())) \
            if name == "int8" else (lambda p: p[:, t:t + 1].contiguous())
        mine = fa.paged_attention_fused_tp(
            qp[:, :, 2 * t:2 * t + 2].contiguous(), cut(pk), cut(pv),
            tables, pos)
        out[f"paged_{name}"] = (whole[:, :, 2 * t:2 * t + 2], mine)
    mqa = pools[0][:, :1].contiguous(), pools[1][:, :1].contiguous()
    out["hatch"] = (fa.paged_attention(qp, *mqa, tables, pos,
                                       kernel="gather"),
                    fa.paged_attention_fused_tp(qp, *mqa, tables, pos))
    context.stop_orca_context()
    return out


# ---------------------------------------------------------------------------
# tensor-parallel serving
# ---------------------------------------------------------------------------

COMBOS = {
    "arena": dict(ticks_per_step=2),
    "paged": dict(paged=True, block_size=4, kernel="gather"),
    "chunked": dict(chunked=True, tick_token_budget=8),
    "spec": dict(_spec=True),
    "paged-chunked": dict(paged=True, block_size=4, chunked=True,
                          tick_token_budget=8, kernel="gather"),
    "spec-paged": dict(paged=True, block_size=4, _spec=True,
                       kernel="gather"),
    "spec-chunked": dict(chunked=True, tick_token_budget=12, _spec=True),
    "spec-paged-chunked": dict(paged=True, block_size=4, chunked=True,
                               tick_token_budget=12, _spec=True,
                               kernel="gather"),
    "fused-paged": dict(paged=True, block_size=4, kernel="fused"),
    "fused-paged-chunked": dict(paged=True, block_size=4, chunked=True,
                                tick_token_budget=8, kernel="fused"),
    "fused-spec-paged": dict(paged=True, block_size=4, _spec=True,
                             kernel="fused"),
    "fused-spec-paged-chunked": dict(paged=True, block_size=4,
                                     chunked=True, tick_token_budget=12,
                                     _spec=True, kernel="fused"),
    "int8-gather": dict(paged=True, block_size=4, kv_dtype="int8",
                        kernel="gather"),
    "int8-fused": dict(paged=True, block_size=4, kv_dtype="int8",
                       kernel="fused"),
}
ENGINE = dict(max_new_tokens=5, max_slots=2, prompt_buckets=(8, 16),
              eos_id=7, device="cpu")


def _serve(inp, rank, mesh, kw, prompts, cfg="cfg", state="state",
           sampled=None, rules=None):
    """One engine run: tokens on the leader, None on a follower (which
    follows until the leader stops it).  Returns (engine, tokens)."""
    from analytics_zoo_tpu_torch.models.lm import TransformerLM
    from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine

    kw = dict(kw)
    if kw.pop("_spec", False):
        kw.update(draft_model=TransformerLM(**inp["draft_cfg"]),
                  draft_variables=inp["draft_state"], speculation_k=2)
    eng = ContinuousEngine(TransformerLM(**inp[cfg]), inp[state],
                           mesh=mesh, partition_rules=rules, **ENGINE,
                           **kw)
    if mesh is not None and rank != 0:
        eng.follow()
        return eng, None
    got = {}
    for u, p in prompts.items():
        skw = dict(temperature=0.7, rng_seed=11) if u == sampled else {}
        eng.submit(u, p, max_new=3 + (int(u[1:]) % 3),
                   on_done=lambda uri, t: got.__setitem__(uri, t.tolist()),
                   **skw)
    eng.drain()
    if mesh is not None:
        eng.stop_followers()
    return eng, got


def scenario_tp(rank, world, outdir):
    from analytics_zoo_tpu_torch.common import context
    from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
    from analytics_zoo_tpu_torch.models.lm import (LM_PARTITION_RULES,
                                                   TransformerLM)
    from analytics_zoo_tpu_torch.parallel import P
    from analytics_zoo_tpu_torch.serving.server import (ClusterServing,
                                                        ServingConfig)

    inp = torch.load(os.path.join(outdir, "tp_in.pt"), weights_only=False)
    mesh = context.init_orca_context("distributed", mesh_axes={"tp": 2},
                                     device="cpu").mesh
    out = {"tokens": {}, "shapes": {}, "capacity": {}}
    for combo in inp["combos"]:
        kw = COMBOS[combo]
        prompts = inp["prompts_chunked" if "chunked" in combo
                      else "prompts"]
        sampled = None if "spec" in combo else "u2"
        for name, m in (("tp2", mesh), ("tp1", None)):
            if m is None and rank != 0:
                continue
            eng, got = _serve(inp, rank, m, kw, prompts, sampled=sampled)
            out["tokens"][(combo, name)] = got
            if name == "tp2":
                pools = {"k": eng._pk, "draft": getattr(eng, "_dpk", None)} \
                    if eng.paged else {"k": eng._ck}
                out["shapes"][combo] = {
                    n: ((tuple(p.data.shape), tuple(p.scale.shape))
                        if hasattr(p, "scale") else tuple(p.shape))
                    for n, p in pools.items() if p is not None}
                out["capacity"][combo] = eng.capacity_report()
    if not inp.get("extras"):
        context.stop_orca_context()
        return out
    # the sharded models' dense logits (vocab-split lookup and head,
    # row-parallel all-reduces; GPT-2 shape and a Llama shape)
    from analytics_zoo_tpu_torch.models.lm import (params_from_flax,
                                                   shard_lm)
    toks = torch.as_tensor(inp["logit_tokens"])
    for name in ("cfg", "llama_cfg"):
        m = TransformerLM(**inp[name])
        shard_lm(m, mesh)
        # the reference's tree, cut to this rank's shards on the host
        m.load_state_dict(params_from_flax(
            inp[name.replace("cfg", "params")], m))
        with torch.no_grad():
            out[("logits", name)] = m(toks)
    # kv heads that do not divide tp: the default rules refuse, the
    # hatch (k/v kernels replicated) replicates the cache
    from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine
    try:
        ContinuousEngine(TransformerLM(**inp["mqa_cfg"]), inp["mqa_state"],
                         mesh=mesh, paged=True, block_size=4, **ENGINE)
    except ValueError as e:
        out["mqa_error"] = str(e)
    rules = ((r"(key|value)/kernel", P()),) + LM_PARTITION_RULES
    for combo, kw in {"mqa-paged": dict(paged=True, block_size=4,
                                        kernel="gather"),
                      "mqa-fused": dict(paged=True, block_size=4,
                                        kernel="fused"),
                      "mqa-arena": {}}.items():
        for name, m in (("tp2", mesh), ("tp1", None)):
            if m is None and rank != 0:
                continue
            eng, got = _serve(inp, rank, m, kw, inp["prompts"], "mqa_cfg",
                              "mqa_state",
                              rules=rules if m is not None else None)
            out["tokens"][(combo, name)] = got
            if name == "tp2":
                out["shapes"][combo] = {"k": tuple(
                    (eng._pk if eng.paged else eng._ck).shape)}
                out["capacity"][combo] = eng.capacity_report()
    # ClusterServing on rank 0 answers through a follower rank
    im = InferenceModel().load_torch_generator(
        TransformerLM(**inp["cfg"]), inp["state"], 5,
        prompt_buckets=(8, 16), device="cpu")
    cfg = ServingConfig(prompt_col="tokens", continuous_batching=True,
                        engine_paged=True, engine_block_size=4,
                        engine_slots=2)
    try:
        ClusterServing(im, ServingConfig(continuous_batching=True,
                                         n_replicas=2),
                       engine_mesh=mesh).start()
    except ValueError as e:
        out["replicas_error"] = str(e)
    srv = ClusterServing(im, cfg, embedded_broker=rank == 0,
                         engine_mesh=mesh).start()
    if rank == 0:
        from analytics_zoo_tpu_torch.serving.queues import (InputQueue,
                                                            OutputQueue)

        inq, outq = InputQueue(port=srv.port), OutputQueue(port=srv.port)
        uris = [inq.enqueue(f"s{i}", tokens=p)
                for i, p in enumerate(inp["prompts"].values())]
        out["served"] = [np.asarray(outq.query(u, timeout=120)).tolist()
                         for u in uris]
        out["served_kernel"] = srv.engine.kernel
    srv.stop()
    if rank == 0:
        # the same requests through one rank's engine
        eng = ContinuousEngine(TransformerLM(**inp["cfg"]), inp["state"],
                               max_new_tokens=5, max_slots=2,
                               prompt_buckets=(8, 16), paged=True,
                               block_size=4, device="cpu")
        solo = {}
        for u, p in inp["prompts"].items():
            eng.submit(u, p, on_done=lambda uri, t: solo.__setitem__(
                uri, t.tolist()))
        eng.drain()
        out["served_solo"] = [solo[u] for u in inp["prompts"]]
    context.stop_orca_context()
    return out


# ---------------------------------------------------------------------------
# data-parallel training
# ---------------------------------------------------------------------------

def _resnet(inp):
    from analytics_zoo_tpu_torch.models import image as ti

    m = ti.ResNet(5, stage_sizes=(1, 1), width=4, small_inputs=True,
                  dtype=torch.float32)
    m.load_state_dict(inp["resnet_state"])
    return m


def _est(inp, mesh, opt, model=None, **cfg):
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.learn.estimator import TorchEstimator

    return TorchEstimator(
        model if model is not None else _resnet(inp),
        "sparse_categorical_crossentropy", opt, feature_cols=("x",),
        label_cols=("y",), config=TrainConfig(deterministic=True, **cfg),
        mesh=mesh, device=None if mesh is not None else "cpu")


def _sgd(lr=0.1):
    return lambda ps: torch.optim.SGD(ps, lr=lr)


def _state(est):
    return {k: v.detach().clone() for k, v in est.model.state_dict().items()}


def scenario_dp(rank, world, outdir):
    from analytics_zoo_tpu_torch.common import context
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.data.feature_set import (DiskFeatureSet,
                                                          FeatureSet)
    from analytics_zoo_tpu_torch.data.loader import device_prefetch
    from analytics_zoo_tpu_torch.data.readers import read_csv
    from analytics_zoo_tpu_torch.learn.estimator import TorchEstimator
    from analytics_zoo_tpu_torch.models.lm import TransformerLM, lm_loss
    from analytics_zoo_tpu_torch.parallel import data_sharding

    inp = torch.load(os.path.join(outdir, "dp_in.pt"), weights_only=False)
    data = inp["data"]
    mesh = context.init_orca_context("distributed", mesh_axes={"dp": -1},
                                     device="cpu").mesh
    out = {}
    runs = {"sgd": dict(opt=_sgd(), epochs=1),
            "sgd_accum": dict(opt=_sgd(), epochs=1, accum_steps=2),
            "adam": dict(opt=3e-3, epochs=2)}
    for name, r in runs.items():
        for dp, m in (("dp2", mesh), ("dp1", None)):
            if m is None and rank != 0:
                continue
            est = _est(inp, m, r["opt"], accum_steps=r.get("accum_steps", 1))
            hist = est.fit(data, epochs=r["epochs"], batch_size=8)
            out[(name, dp)] = ([h["loss"] for h in hist], _state(est))
            if name == "sgd":
                out[("eval", dp)] = est.evaluate(data, batch_size=6)
                out[("predict", dp)] = est.predict({"x": data["x"][:10]},
                                                   batch_size=4)
    try:
        _est(inp, mesh, _sgd()).fit(data, epochs=1, batch_size=7)
    except ValueError as e:
        out["indivisible"] = str(e)
    # dropout on: a tiny LM, dp=2 draws the global batch's masks
    toks = inp["lm_tokens"]
    for dp, m in (("dp2", mesh), ("dp1", None)):
        if m is None and rank != 0:
            continue
        torch.manual_seed(0)
        lm = TransformerLM(**inp["lm_cfg"])
        lm.load_state_dict(inp["lm_state"])
        est = TorchEstimator(lm, lm_loss, _sgd(0.5), feature_cols=("tokens",),
                             label_cols=("tokens",),
                             config=TrainConfig(deterministic=True),
                             mesh=m, device=None if m is not None else "cpu")
        hist = est.fit({"tokens": toks}, epochs=3, batch_size=4)
        out[("dropout", dp)] = ([h["loss"] for h in hist], _state(est))
    # each rank reads its files of five
    shards = read_csv(os.path.join(outdir, "csv"))
    out["csv_rows"] = sorted(int(v) for df in shards.collect()
                             for v in df["a"])
    # rank 0 writes the checkpoint, every rank restores it
    ck = os.path.join(outdir, "ck")
    est = _est(inp, mesh, _sgd(), checkpoint_dir=ck)
    est.fit(data, epochs=1, batch_size=8)
    saved = _state(est)
    fresh = _est(inp, mesh, _sgd())
    fresh.load_checkpoint(ck)
    out["ckpt"] = (saved, _state(fresh), fresh._global_step)
    # host-local disk shards: rank r streams half r of the rows
    half = len(data["x"]) // world
    mine = {k: v[rank * half:(rank + 1) * half] for k, v in data.items()}
    FeatureSet(mine).to_disk(os.path.join(outdir, "disk_{host}.zrec"),
                             block_rows=4)
    disk = DiskFeatureSet(os.path.join(outdir, "disk_{host}.zrec"))
    est = _est(inp, mesh, _sgd())
    hist = est.fit(disk, epochs=1, batch_size=8)
    out["disk"] = ([h["loss"] for h in hist], hist[0]["num_samples"],
                   _state(est), est.evaluate(disk, batch_size=4),
                   est.predict(disk, batch_size=4), len(disk))
    # device_prefetch with a batch placement: this rank's rows
    got = list(device_prefetch(FeatureSet(data).batches(8, shuffle=False),
                               mesh, sharding=data_sharding(mesh)))
    out["prefetch"] = [b["y"].tolist() for b in got]
    context.stop_orca_context()
    return out


if __name__ == "__main__":
    scenario, rank, world, port, outdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    _setup(rank, world, port)
    result = globals()[f"scenario_{scenario}"](rank, world, outdir)
    torch.save(result, os.path.join(outdir, f"{scenario}_{rank}.pt"))
