"""One rank of the port's multi-process scenarios (started by
``tests/_torch_dist.py``): ``python _torch_dist_worker.py <scenario>
<rank> <world> <port> <outdir>``.  Joins a gloo process group on
localhost through ``init_orca_context("distributed")`` (the launcher's
environment variables, as ``torchrun`` sets them), runs the scenario on
the CPU and saves what it observed to ``<outdir>/<scenario>_<rank>.pt``.
Inputs the test made (weights, data) are read from ``<outdir>``.
Imports torch and the port only."""

import copy
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
    # one replica, then two over the same mesh (two engines a rank on
    # lanes of their own, sharing the model the first server sharded)
    for key, n in (("served", 1), ("served_replicas", 2)):
        srv = ClusterServing(
            im, ServingConfig(prompt_col="tokens", continuous_batching=True,
                              engine_paged=True, engine_block_size=4,
                              engine_slots=2, n_replicas=n),
            embedded_broker=rank == 0, engine_mesh=mesh).start()
        if rank == 0:
            from analytics_zoo_tpu_torch.serving.queues import (InputQueue,
                                                                OutputQueue)

            inq, outq = InputQueue(port=srv.port), OutputQueue(port=srv.port)
            uris = [inq.enqueue(f"{key}{i}", tokens=p)
                    for i, p in enumerate(inp["prompts"].values())]
            out[key] = [np.asarray(outq.query(u, timeout=120)).tolist()
                        for u in uris]
            out[key + "_kernel"] = srv.engine.kernel
            out[key + "_engines"] = len(srv.engines)
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


def scenario_dptp(rank, world, outdir):
    """Engines on a ``{"dp": 2, "tp": 2}`` mesh: rank 0 leads every dp
    line, each line shards over its own tp pair; rank 0 also serves the
    same stream alone."""
    from analytics_zoo_tpu_torch.common import context

    inp = torch.load(os.path.join(outdir, "tp_in.pt"), weights_only=False)
    mesh = context.init_orca_context("distributed",
                                     mesh_axes={"dp": 2, "tp": 2},
                                     device="cpu").mesh
    out = {"tokens": {}, "coords": mesh.coords(rank), "calls": {}}
    for combo in inp["combos"]:
        prompts = inp["prompts_chunked" if "chunked" in combo
                      else "prompts"]
        for name, m in (("dp2tp2", mesh), ("tp1", None)):
            if m is None and rank != 0:
                continue
            eng, got = _serve(inp, rank, m, COMBOS[combo], prompts,
                              sampled="u2")
            out["tokens"][(combo, name)] = got
            if name == "dp2tp2":
                out["calls"][combo] = (
                    eng.prefill_calls, eng.decode_ticks, eng.chunk_calls,
                    tuple((eng._pk if eng.paged else eng._ck).shape))
    context.stop_orca_context()
    return out


TIER = dict(max_new_tokens=4, max_slots=2, prompt_buckets=(8, 16),
            paged=True, block_size=4, n_blocks=8, device="cpu")
TIER_METRICS = ("kv_spills", "kv_readmits", "kv_readmit_tokens_saved",
                "kv_spill_bytes", "kv_store_bytes", "referenced_blocks")


def _follow_or_lead(rank, engines, lead):
    """Followers run every engine's loop (a thread each); the leader
    runs ``lead()`` and then stops them."""
    import threading

    if rank != 0:
        threads = [threading.Thread(target=e.follow) for e in engines]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return None
    try:
        return lead()
    finally:
        for e in engines:
            e.stop_followers()


def _tier_runs(inp, rank, mesh, out):
    """The reference's host-tier pins on every rank: a0 cold, b and c
    churn the 8-block pool until a0's chain spills, a1 readmits it."""
    from analytics_zoo_tpu_torch.models.lm import TransformerLM
    from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine
    from analytics_zoo_tpu_torch.serving.kv_store import (PrefixDirectory,
                                                          TIER_HBM)

    seq = [("a0", inp["PA"]), ("b", inp["PB"]), ("c", inp["PC"]),
           ("a1", inp["PA"])]
    for kv in ("bf16", "int8"):
        for extra in ("paged", "chunked"):
            kw = dict(TIER, kv_dtype=kv)
            if extra == "chunked":
                kw.update(chunked=True, tick_token_budget=8)
            for name, m, store in (("tp2", mesh, 1 << 20),
                                   ("tp2_bare", mesh, 0),
                                   ("tp1", None, 1 << 20)):
                if m is None and rank != 0:
                    continue
                d = PrefixDirectory()
                eng = ContinuousEngine(
                    TransformerLM(**inp["cfg"]), inp["state"], mesh=m,
                    kv_host_store_bytes=store, replica_id=3,
                    prefix_directory=d if store else None, **kw)
                got, claims = {}, []

                def lead():
                    for u, p in seq:
                        eng.submit(u, p, on_done=lambda uri, t:
                                   got.__setitem__(uri, t.tolist()))
                        eng.drain()
                        if store:
                            hs = eng._pool.block_hashes(
                                [int(t) for t in inp["PA"]])
                            claims.append(d.lookup(hs[0]))
                if m is None:
                    lead()
                else:
                    _follow_or_lead(rank, [eng], lead)
                cm = eng.cache_metrics()
                key = (kv, extra, name)
                out["tier"][key] = {
                    "tokens": got, "claims": claims,
                    "metrics": {k: cm[k] for k in TIER_METRICS},
                    "flight": [(r["kind"], r.get("kv_spills"),
                                r.get("kv_readmits"))
                               for r in eng.flight.snapshot()],
                    "directory": d.metrics()}
                eng._pool.check()
                if not store:
                    continue
                hs = eng._pool.block_hashes([int(t) for t in inp["PA"]])
                info = out["tier"][key]
                info["stored"] = [h in eng._kv_store for h in hs]
                # a dry pool's readmit rolls back, the store stays whole
                # (local to each rank: no collective)
                held = []
                with eng._pool_lock:
                    while True:
                        blk = eng._pool.allocate()
                        if blk is None:
                            break
                        held.append(blk)
                    before = len(eng._kv_store)
                    info["dry"] = (eng._store_readmit(hs, 0, len(hs)),
                                   len(eng._kv_store) == before)
                    for blk in held:
                        eng._pool.release(blk)
                eng._pool.check()
                # a store eviction retracts the leader's host claim
                eng._kv_store.pop(hs[0])
                info["after_pop"] = d.lookup(hs[0])
                info["hbm_claim"] = TIER_HBM


def _handoff_pair(inp, rank, mesh, out):
    """Engine A prefills and exports at first token, engine B (lane 1)
    adopts and decodes: each rank moves its own shard."""
    from analytics_zoo_tpu_torch.models.lm import TransformerLM
    from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine

    for kv in (None, "int8"):
        got = {}
        kw = dict(mesh=mesh, max_new_tokens=5, max_slots=3,
                  prompt_buckets=(8, 16), paged=True, block_size=4,
                  kv_dtype=kv, device="cpu")
        a = ContinuousEngine(TransformerLM(**inp["cfg"]), inp["state"],
                             **kw)
        # the second engine (replica 1) shares the sharded model on a
        # lane of its own
        b = ContinuousEngine(a.model, None, replica_id=1, **kw)

        def lead():
            for u, p in inp["handoff_prompts"].items():
                a.submit(u, p, on_done=lambda uri, t: got.__setitem__(
                    uri, t.tolist()), handoff_cb=b.submit_handoff)
            while len(got) < len(inp["handoff_prompts"]):
                a.step()
                b.step()
        _follow_or_lead(rank, [a, b], lead)
        for e in (a, b):
            e._pool.check()
        out["handoff"][kv] = {
            "tokens": got, "counts": (a._handoffs_out, b._handoffs_in),
            "idle": (a._pool.num_referenced(), b._pool.num_referenced(),
                     a.n_active, b.n_active)}


def _handoff_resend(inp, rank, mesh, out):
    """A parked shard lives until the leader drops its own copy of the
    export: the first of 20 exports is adopted again after the 19 others
    (an ack-timeout retry), an export whose delivery fails is freed
    unadopted, one is adopted by its own source, and every rank's box
    ends empty."""
    from analytics_zoo_tpu_torch.models.lm import TransformerLM
    from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine

    kw = dict(mesh=mesh, max_new_tokens=5, max_slots=3,
              prompt_buckets=(8, 16), paged=True, block_size=4,
              device="cpu")
    a = ContinuousEngine(TransformerLM(**inp["cfg"]), inp["state"], **kw)
    b = ContinuousEngine(a.model, None, replica_id=1, **kw)
    prompts = {f"{u}-{i}": p for i in range(5)
               for u, p in inp["handoff_prompts"].items()}
    first = next(iter(prompts))
    got, states, again, errors = {}, {}, {}, []

    def deliver(state):
        states[state["uri"]] = state
        b.submit_handoff(state)

    def fail(state):
        raise RuntimeError("no replica took the handoff")

    def lead():
        for u, p in prompts.items():
            a.submit(u, p, on_done=lambda uri, t: got.__setitem__(
                uri, t.tolist()), handoff_cb=deliver)
        while len(got) < len(prompts):
            a.step()
            b.step()
        b.submit_handoff(dict(states[first], on_done=lambda uri, t:
                              again.__setitem__(uri, t.tolist())))
        while not again:
            b.step()
        states.clear()      # the deliverer's last copies
        a.submit("lost", next(iter(inp["handoff_prompts"].values())),
                 on_error=lambda uri, e: errors.append(uri),
                 handoff_cb=fail)
        while not errors:
            a.step()
        # a source adopting its own export (the router's last resort):
        # posted from inside its replay, so every rank adopts it
        a.submit("self", next(iter(inp["handoff_prompts"].values())),
                 on_done=lambda uri, t: again.__setitem__(uri, t.tolist()),
                 handoff_cb=a.submit_handoff)
        while "self" not in again:
            a.step()
        a.step()            # flushes the last releases
        return a._lockstep.handoffs._sent
    sent = _follow_or_lead(rank, [a, b], lead)
    for e in (a, b):
        e._pool.check()
    out["resend"] = {
        "tokens": got, "again": again.get(first), "errors": errors,
        "self": again.get("self"), "sent": sent,
        "parked": len(a._lockstep.handoffs),
        "counts": (a._handoffs_out, a._handoffs_in, b._handoffs_in),
        "idle": (a._pool.num_referenced(), b._pool.num_referenced(),
                 a.n_active, b.n_active)}


FLEET = dict(prompt_col="tokens", continuous_batching=True, engine_slots=2,
             n_replicas=2, engine_paged=True, engine_block_size=4,
             engine_blocks=24)
FLEET_MODES = {
    "replicas": {},
    "roles": dict(replica_roles=["prefill", "decode"],
                  prefix_directory=True,
                  engine_kv_host_store_bytes=1 << 20),
}


def _fleet(inp, rank, mesh, out):
    """``ClusterServing(n_replicas=2)`` over the tp mesh, with and
    without prefill/decode roles, the directory and host tiers; rank 0
    also runs the same fleets alone."""
    from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
    from analytics_zoo_tpu_torch.models.lm import TransformerLM
    from analytics_zoo_tpu_torch.serving.queues import (InputQueue,
                                                        OutputQueue)
    from analytics_zoo_tpu_torch.serving.server import (ClusterServing,
                                                        ServingConfig)

    ims = {}
    for mode, extra in FLEET_MODES.items():
        for name, m in (("tp2", mesh), ("tp1", None)):
            if m is None and rank != 0:
                continue
            if name not in ims:
                ims[name] = InferenceModel().load_torch_generator(
                    TransformerLM(**inp["cfg"]), inp["state"], 4,
                    prompt_buckets=(8, 16), device="cpu")
            srv = ClusterServing(ims[name], ServingConfig(**FLEET, **extra),
                                 embedded_broker=rank == 0,
                                 engine_mesh=m).start()
            hits = []
            if rank == 0 and srv._prefix_directory is not None:
                probe = srv._prefix_directory.match_depths

                def counted(hashes, probe=probe):
                    depths = probe(hashes)
                    hits.append(max(depths.values(), default=0))
                    return depths
                srv._prefix_directory.match_depths = counted
            got = None
            if rank == 0:
                inq, outq = InputQueue(port=srv.port), \
                    OutputQueue(port=srv.port)
                got = {}
                # one at a time: each sees the fleet the last one left
                for u, p in inp["fleet_prompts"].items():
                    inq.enqueue(f"{mode}-{u}", tokens=p)
                    got[u] = np.asarray(outq.query(
                        f"{mode}-{u}", timeout=120)).tolist()
            srv.stop()
            status = srv.router_status() if rank == 0 else None
            out["fleet"][(mode, name)] = {
                "tokens": got, "hits": hits, "status": status,
                "engines": [(e._handoffs_out, e._handoffs_in,
                             e._pool.num_referenced(), e.n_active,
                             e.cache_metrics()["kv_spills"])
                            for e in srv.engines],
                # exports the leader has not released yet
                "unreleased": [len(e._lockstep.handoffs._sent)
                               for e in srv.engines
                               if e._lockstep is not None]}


def _on_tp2(rank, outdir, *runs):
    """``runs`` on a ``{"tp": 2}`` mesh, over ``tier_in.pt``'s inputs."""
    from analytics_zoo_tpu_torch.common import context

    inp = torch.load(os.path.join(outdir, "tier_in.pt"), weights_only=False)
    mesh = context.init_orca_context("distributed", mesh_axes={"tp": 2},
                                     device="cpu").mesh
    out = {"tier": {}, "handoff": {}, "fleet": {}, "resend": {}}
    for run in runs:
        run(inp, rank, mesh, out)
    context.stop_orca_context()
    return out


def scenario_tier(rank, world, outdir):
    """The host tier and the prefix directory on a ``{"tp": 2}`` mesh."""
    return _on_tp2(rank, outdir, _tier_runs)


def scenario_fleet(rank, world, outdir):
    """Handoff and replicas on a ``{"tp": 2}`` mesh."""
    return _on_tp2(rank, outdir, _handoff_pair, _handoff_resend, _fleet)


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


# ---------------------------------------------------------------------------
# tensor- and sequence-parallel training
# ---------------------------------------------------------------------------

def _whole(t, spec, mesh):
    from analytics_zoo_tpu_torch.parallel import gather_tensor

    return gather_tensor(t.detach().contiguous(), spec, mesh)


def scenario_ring(rank, world, outdir):
    """Ring and ulysses attention at sp=2 and sp=4 (outputs and q/k/v
    gradients gathered), BERT on a dp2 x sp2 x tp2 mesh and the LM's
    causal ring on dp2 x sp4, forward."""
    from analytics_zoo_tpu_torch.common import context
    from analytics_zoo_tpu_torch.models.lm import TransformerLM
    from analytics_zoo_tpu_torch.models.transformer import (
        BERT, BERT_PARTITION_RULES)
    from analytics_zoo_tpu_torch.parallel import P, make_mesh
    from analytics_zoo_tpu_torch.parallel import collectives as cc
    from analytics_zoo_tpu_torch.parallel.partition import (batch_rows,
                                                            shard_module)
    from analytics_zoo_tpu_torch.parallel.ring_attention import \
        ring_self_attention

    inp = torch.load(os.path.join(outdir, "ring_in.pt"), weights_only=False)
    mesh3 = context.init_orca_context(
        "distributed", mesh_axes={"dp": 2, "sp": 2, "tp": 2},
        device="cpu").mesh
    q, k, v, g = (torch.from_numpy(inp[n]) for n in "qkvg")
    mask = torch.from_numpy(inp["mask"])
    out = {}
    for sp in (2, 4):
        mesh = make_mesh(axes={"dp": world // sp, "sp": sp}, device="cpu")
        line = cc.Line.of(mesh, "sp")

        def cut(t):
            n = t.shape[1] // sp
            return t[:, line.index * n:(line.index + 1) * n].contiguous()

        for strategy in ("ring", "ulysses"):
            for causal in (False, True):
                for masked in (False, True):
                    ql, kl, vl = (cut(t).requires_grad_() for t in (q, k, v))
                    o = ring_self_attention(
                        ql, kl, vl, mesh, cut(mask) if masked else None,
                        causal=causal, strategy=strategy)
                    (o * cut(g)).sum().backward()
                    out[(sp, strategy, causal, masked)] = [
                        _whole(t, P(None, "sp"), mesh)
                        for t in (o, ql.grad, kl.grad, vl.grad)]
        try:
            ring_self_attention(cut(q)[:, :, :3].contiguous(),
                                cut(k)[:, :, :3].contiguous(),
                                cut(v)[:, :, :3].contiguous(), mesh,
                                strategy="ulysses")
        except ValueError as e:
            out[("ulysses_heads", sp)] = str(e)
    # BERT, the reference's dp2 x sp2 x tp2 equivalence
    ids, amask = (torch.from_numpy(inp[n]) for n in ("ids", "amask"))
    bert = BERT(**inp["bert_cfg"], dtype=torch.float32, use_flash=False,
                mesh=mesh3)
    bert.load_state_dict(inp["bert_state"])
    shard_module(bert, mesh3, BERT_PARTITION_RULES)
    r = batch_rows(mesh3, len(ids))
    with torch.no_grad():
        seq, pooled = bert(ids[r], attention_mask=amask[r])
    out["bert"] = (_whole(seq, P("dp"), mesh3), _whole(pooled, P("dp"),
                                                       mesh3))
    # the LM's causal ring on dp2 x sp4
    mesh = make_mesh(axes={"dp": 2, "sp": 4}, device="cpu")
    lm = TransformerLM(**inp["lm_cfg"], mesh=mesh)
    lm.load_state_dict(inp["lm_state"])
    toks = torch.from_numpy(inp["toks"])
    r = batch_rows(mesh, len(toks))
    with torch.no_grad():
        out["lm"] = _whole(lm(toks[r]), P("dp"), mesh)
    context.stop_orca_context()
    return out if rank == 0 else {}


def _tp_est(model, loss, opt, cols, mesh, rules=None, lora=None, **cfg):
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.learn.estimator import TorchEstimator

    feats, labels = cols
    return TorchEstimator(
        model, loss, opt, feature_cols=feats, label_cols=labels,
        config=TrainConfig(deterministic=True, **cfg), mesh=mesh,
        device=None if mesh is not None else "cpu",
        partition_rules=rules, lora=lora)


def _whole_grads(model, placements, mesh):
    """Every parameter's gradient, whole (shards gathered)."""
    return {n: _whole(p.grad, placements[n], mesh) if n in placements
            else p.grad.detach().clone()
            for n, p in model.named_parameters()}


def scenario_tptrain(rank, world, outdir):
    """Training on {"dp": 2, "tp": 2} (A) and {"sp": 2, "tp": 2} (B):
    BERT and the LM (GPT-2 and Llama shapes, MHA and GQA with and
    without KH % tp) under the reference's rules, SGD states and Adam
    losses; tp gradients against one rank's and with two planted
    faults; dropout against one rank; LoRA on A; a dp=4 checkpoint
    through B and back; sharded flash gradients on a rank's heads."""
    from analytics_zoo_tpu_torch.common import context
    from analytics_zoo_tpu_torch.learn.lora import LoRAConfig
    from analytics_zoo_tpu_torch.models import lm as tlm
    from analytics_zoo_tpu_torch.models import transformer as ttr
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.parallel import P, make_mesh
    from analytics_zoo_tpu_torch.parallel import collectives as cc
    from analytics_zoo_tpu_torch.parallel.partition import shard_module

    inp = torch.load(os.path.join(outdir, "tptrain_in.pt"),
                     weights_only=False)
    mesh_a = context.init_orca_context(
        "distributed", mesh_axes={"dp": 2, "tp": 2}, device="cpu").mesh
    mesh_b = make_mesh(axes={"sp": 2, "tp": 2}, device="cpu")
    meshes = {"A": mesh_a, "B": mesh_b}
    out = {}
    cls = ("input_ids", "token_type_ids", "attention_mask"), ("y",)
    lmc = ("tokens",), ("tokens",)
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731

    def bert(mesh=None, dropout=0.0):
        m = ttr.BERTForSequenceClassification(3, ttr.BERT(
            **inp["bert_cfg"], dtype=torch.float32, use_flash=False,
            dropout=dropout, mesh=mesh))
        m.load_state_dict(inp["bert_state"])
        return m

    def lm(kind, mesh=None, dropout=0.0):
        m = tlm.TransformerLM(**inp["lm_cfg"][kind], dtype=torch.float32,
                              use_flash=False, dropout=dropout, mesh=mesh)
        m.load_state_dict(inp["lm_state"][kind])
        return m

    def fit(est, data, epochs=1):
        hist = est.fit(data, epochs=epochs, batch_size=8)
        return [h["loss"] for h in hist], copy.deepcopy(est.get_model()[1])

    # the Estimator against the reference (the test holds both meshes to
    # the JAX Estimator's run)
    for mk, mesh in meshes.items():
        sp_mesh = mesh if mk == "B" else None
        out[("bert", "sgd", mk)] = fit(_tp_est(
            bert(sp_mesh), "sparse_categorical_crossentropy", sgd, cls,
            mesh, ttr.BERT_PARTITION_RULES), inp["cls_data"])
        for kind in ("mha", "gqa1", "gqa2"):
            out[("lm", kind, "sgd", mk)] = fit(_tp_est(
                lm(kind, sp_mesh), tlm.lm_loss, sgd, lmc, mesh,
                tlm.LM_PARTITION_RULES), inp["lm_data"])
        out[("lm", "gqa1", "adam", mk)] = fit(_tp_est(
            lm("gqa1", sp_mesh), tlm.lm_loss, 1e-3, lmc, mesh,
            tlm.LM_PARTITION_RULES), inp["lm_data"], 2)[0]

    # the blockwise fused loss over a vocab-split table, against one rank
    for mk, mesh in (("A", mesh_a), ("one", None)):
        out[("fused", mk)] = fit(_tp_est(
            tlm.LMWithFusedLoss(lm("mha"), t_block=5), tlm.fused_lm_loss,
            sgd, lmc, mesh, tlm.LM_PARTITION_RULES), inp["lm_data"])

    # accum_steps, evaluate (a padded chunk) and predict (rows in global
    # order on every rank) on both meshes against one rank
    for mk, mesh in list(meshes.items()) + [("one", None)]:
        est = _tp_est(bert(mesh if mk == "B" else None),
                      "sparse_categorical_crossentropy", sgd, cls, mesh,
                      ttr.BERT_PARTITION_RULES, accum_steps=2)
        got = fit(est, inp["cls_data"])
        out[("accum", mk)] = got + (
            est.evaluate(inp["cls_data"], batch_size=6),
            est.predict({c: inp["cls_data"][c][:10] for c in cls[0]},
                        batch_size=4))

    # tp=2 gradients of every parameter against one rank's, then with a
    # planted fault: a column-parallel input without its backward
    # all-reduce, and a row-parallel sum through the library's autograd
    # all_reduce (its backward all-reduces the gradient again)
    batch = {k: torch.from_numpy(v[:8]) for k, v in inp["cls_data"].items()}
    lm_batch = torch.from_numpy(inp["lm_data"]["tokens"][:8])

    def grads(kind, mesh):
        if kind == "bert":
            m = bert()
            run = lambda: torch.nn.functional.cross_entropy(  # noqa: E731
                m(batch["input_ids"], batch["token_type_ids"],
                  batch["attention_mask"]), batch["y"].long())
            rules = ttr.BERT_PARTITION_RULES
        else:
            m = lm(kind)
            run = lambda: tlm.lm_loss(m(lm_batch), lm_batch)  # noqa: E731
            rules = tlm.LM_PARTITION_RULES
        placements = shard_module(m, mesh, rules) if mesh else {}
        run().backward()
        return _whole_grads(m, placements, mesh)

    from torch.distributed.nn.functional import all_reduce as lib_all_reduce
    faults = {
        "copy_to_plain": ("copy_to", lambda x, line: x),
        "reduce_from_library": ("reduce_from", lambda x, line: (
            lib_all_reduce(x, group=line.group) if line is not None
            and line.size > 1 else x))}
    for kind in ("bert", "mha", "gqa1"):
        out[("grads", kind, "tp1")] = grads(kind, None)
        out[("grads", kind, "tp2")] = grads(kind, mesh_b)
        for fault, (name, fn) in faults.items():
            keep = getattr(cc, name)
            setattr(cc, name, fn)
            try:
                out[("grads", kind, fault)] = grads(kind, mesh_b)
            finally:
                setattr(cc, name, keep)

    # dropout: the global tensor's masks, so tp=2 (and sp=2 x tp=2)
    # trains what one rank trains
    for name, sp_mesh in (("tp2", None), ("sp2tp2", mesh_b)):
        out[("dropout", "bert", name)] = fit(_tp_est(
            bert(sp_mesh, 0.1), "sparse_categorical_crossentropy", sgd,
            cls, mesh_b, ttr.BERT_PARTITION_RULES), inp["cls_data"])
        out[("dropout", "lm", name)] = fit(_tp_est(
            lm("gqa2", sp_mesh, 0.1), tlm.lm_loss, sgd, lmc, mesh_b,
            tlm.LM_PARTITION_RULES), inp["lm_data"])
    out[("dropout", "bert", "one")] = fit(_tp_est(
        bert(None, 0.1), "sparse_categorical_crossentropy", sgd, cls,
        None), inp["cls_data"])
    out[("dropout", "lm", "one")] = fit(_tp_est(
        lm("gqa2", None, 0.1), tlm.lm_loss, sgd, lmc, None),
        inp["lm_data"])

    # LoRA on dp2 x tp2: adapters replicate, the base shards
    est_l = _tp_est(lm("mha"), tlm.lm_loss,
                    lambda ps: torch.optim.AdamW(ps, lr=1e-2,
                                                 weight_decay=1e-4),
                    lmc, mesh_a, tlm.LM_PARTITION_RULES,
                    lora=LoRAConfig(rank=4))
    hist = est_l.fit(inp["lm_data"], epochs=3, batch_size=8)
    out["lora"] = ([h["loss"] for h in hist], est_l.lora_params(),
                   {k: v for k, v in est_l.merged_params().items()})

    # a dp=4 checkpoint restores onto sp2 x tp2, and a checkpoint written
    # there onto dp=4 again
    mesh_dp = make_mesh(axes={"dp": 4}, device="cpu")
    ck1, ck2 = (os.path.join(outdir, n) for n in ("ck1", "ck2"))

    def bert_est(mesh, sp_mesh, **cfg):
        return _tp_est(bert(sp_mesh), "sparse_categorical_crossentropy",
                       1e-3, cls, mesh, ttr.BERT_PARTITION_RULES, **cfg)

    est_dp = bert_est(mesh_dp, None, checkpoint_dir=ck1)
    est_dp.fit(inp["cls_data"], epochs=1, batch_size=8)
    est_b = bert_est(mesh_b, mesh_b)
    est_b.load_checkpoint(ck1)
    # copies: the estimators train on in place
    snap = lambda est: copy.deepcopy((est.get_model()[1],  # noqa: E731
                                      est._optimizer_state()))
    (dp_state, dp_opt), (b_state, b_opt) = snap(est_dp), snap(est_b)
    out["ckpt_in"] = (dp_state, b_state, dp_opt, b_opt)
    out["ckpt_next"] = (fit(est_dp, inp["cls_data"]),
                        fit(est_b, inp["cls_data"]))
    est_b.save_checkpoint(ck2)
    est_back = bert_est(mesh_dp, None)
    est_back.load_checkpoint(ck2)
    (b_state, b_opt), (back, back_opt) = snap(est_b), snap(est_back)
    out["ckpt_back"] = (b_state, back, b_opt, back_opt)

    # the flash path's gradients on this rank's heads (tp coordinate of A)
    q, k, v, g = (torch.from_numpy(inp["flash"][n]) for n in "qkvg")
    mask = torch.from_numpy(inp["flash"]["mask"])
    t = mesh_a.coord("tp")
    heads = slice(2 * t, 2 * t + 2)
    mine = [x[:, :, heads].contiguous().requires_grad_() for x in (q, k, v)]
    (fa.sharded_flash_attention(*mine, mask, causal=True)
     * g[:, :, heads]).sum().backward()
    out["flash_mine"] = [_whole(x.grad, P(None, None, "tp"), mesh_a)
                         for x in mine]
    context.stop_orca_context()
    return out


def scenario_tpzoo(rank, world, outdir):
    """The zoo on a {"tp": 2} mesh: NCF (a 65-row table stays whole, a
    64-row one splits) and Wide & Deep under their rules, SGD states and
    Adam losses; BERTClassifier with its default rules and
    TextEstimator(partition_rules=) against one rank; a GANEstimator on
    a {"dp": 2} mesh against one rank; the readers' shard of a rank."""
    from analytics_zoo_tpu_torch.common import context
    from analytics_zoo_tpu_torch.data.loader import data_shard
    from analytics_zoo_tpu_torch.models import ncf, recommendation, \
        transformer as ttr
    from analytics_zoo_tpu_torch.parallel import make_mesh
    from analytics_zoo_tpu_torch.tfpark import gan as tgan
    from analytics_zoo_tpu_torch.tfpark.text import (BERTClassifier,
                                                     TextEstimator)

    inp = torch.load(os.path.join(outdir, "tpzoo_in.pt"), weights_only=False)
    mesh = context.init_orca_context("distributed", mesh_axes={"tp": 2},
                                     device="cpu").mesh
    out = {"data_shard": data_shard(), "data_shard_dp": None}
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731

    def fit(est, data, epochs=1, bs=16):
        hist = est.fit(data, epochs=epochs, batch_size=bs)
        return [h["loss"] for h in hist], copy.deepcopy(est.get_model()[1])

    def ncf_model():
        m = ncf.NeuralCF(**inp["ncf_cfg"], dtype=torch.float32)
        m.load_state_dict(inp["ncf_state"])
        return m

    cols = ("user", "item"), ("label",)
    for m, name in ((mesh, "tp2"), (None, "one")):
        for opt, o, ep in (("sgd", sgd, 1), ("adam", 5e-3, 2)):
            est = _tp_est(ncf_model(), "sparse_categorical_crossentropy",
                          o, cols, m, ncf.NCF_PARTITION_RULES)
            out[("ncf", opt, name)] = fit(est, inp["ncf_data"], ep)
            if m is not None:
                out[("ncf_split", opt)] = sorted(est._placements)

    def wnd_model():
        mm = recommendation.WideAndDeep(
            2, recommendation.ColumnFeatureInfo(**inp["wnd_info"]),
            dtype=torch.float32)
        mm.load_state_dict(inp["wnd_state"])
        return mm

    wcols = ("wide_cols", "indicator_cols", "embed_cols",
             "continuous_cols"), ("label",)
    for m, name in ((mesh, "tp2"), (None, "one")):
        est = _tp_est(wnd_model(), "sparse_categorical_crossentropy", sgd,
                      wcols, m, recommendation.WND_PARTITION_RULES)
        out[("wnd", name)] = fit(est, inp["wnd_data"])
        if m is not None:
            out["wnd_split"] = sorted(est._placements)

    def bert():
        mm = ttr.BERT(**inp["bert_cfg"], dtype=torch.float32,
                      use_flash=False, dropout=0.1)
        mm.load_state_dict(inp["bert_state"])
        return mm

    for m, dev in ((mesh, None), (None, "cpu")):
        name = "tp2" if m is not None else "one"
        est = BERTClassifier(3, bert=bert(), mesh=m, device=dev,
                             optimizer=sgd)
        torch.manual_seed(0)
        est.model.classifier.load_state_dict(inp["cls_head"])
        out[("bertcls", name)] = fit(est.estimator, inp["text_data"], 1, 8)
        if m is not None:
            out["bertcls_split"] = len(est.estimator._placements)
        model = ttr.BERTForSequenceClassification(3, bert())
        model.classifier.load_state_dict(inp["cls_head"])
        te = TextEstimator(model, "sparse_categorical_crossentropy", sgd,
                           feature_cols=("input_ids",), mesh=m, device=dev,
                           partition_rules=ttr.BERT_PARTITION_RULES)
        out[("textest", name)] = (te.fit(inp["text_data"], batch_size=8),
                                  copy.deepcopy(te.estimator.get_model()[1]))

    # a GANEstimator on dp=2 over the same two ranks
    dp_mesh = make_mesh(axes={"dp": 2}, device="cpu")
    out["data_shard_dp"] = data_shard(dp_mesh)
    from analytics_zoo_tpu_torch.models.layers import Dense

    class _Net(torch.nn.Module):
        def __init__(self, n_in, n_out, squeeze):
            super().__init__()
            self.Dense_0, self.Dense_1 = Dense(n_in, 16), Dense(16, n_out)
            self.squeeze = squeeze

        def forward(self, x):
            y = self.Dense_1(torch.tanh(self.Dense_0(x)))
            return y[..., 0] if self.squeeze else y

    for m, dev in ((dp_mesh, None), (None, "cpu")):
        torch.manual_seed(0)
        g, d = _Net(4, 2, False), _Net(2, 1, True)
        est = tgan.GANEstimator(g, d, noise_dim=4, mesh=m, device=dev,
                                seed=3)
        hist = est.fit(inp["gan_data"], epochs=2, batch_size=8)
        out[("gan", "dp2" if m is not None else "one")] = (
            hist, copy.deepcopy(est.gen.state_dict()),
            copy.deepcopy(est.disc.state_dict()))
    context.stop_orca_context()
    return out


if __name__ == "__main__":
    scenario, rank, world, port, outdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    _setup(rank, world, port)
    result = globals()[f"scenario_{scenario}"](rank, world, outdir)
    torch.save(result, os.path.join(outdir, f"{scenario}_{rank}.pt"))
