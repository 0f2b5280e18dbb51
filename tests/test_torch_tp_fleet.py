"""Prefill/decode handoff and ``ClusterServing(n_replicas=2)`` on a
tensor-parallel mesh: two gloo processes (``_torch_dist_worker.py``
scenario ``fleet``) against the port's one-rank fleets and the JAX
package, on the same flax weights (``_torch_tp.tier_inputs``).

Handoff: each rank's source engine exports its shard of the chain and
its destination engine (replica 1: a second lane of the mesh) adopts
it; a follower keeps the shard until the leader releases it.
Replicas: two engines a rank share the one sharded model, each with its
own control and tp groups, with and without prefill/decode roles, the
directory and host tiers; every request answers as one rank's fleet and
as the reference's ``generate``.
"""

import numpy as np
import pytest

from analytics_zoo_tpu.models.lm import generate as jax_generate
from analytics_zoo_tpu.parallel.mesh import make_mesh
from analytics_zoo_tpu.serving.continuous import \
    ContinuousEngine as JaxEngine

from _torch_dist import Ranks
from _torch_tp import tier_inputs


def _jax_generate(jm, jv, prompts, n):
    """The reference's ``generate`` over the prompts as one ragged
    batch (right-padded, each row's own length)."""
    width = max(len(p) for p in prompts.values())
    batch = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts.values()):
        batch[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts.values()], np.int32)
    out = np.asarray(jax_generate(jm, jv, batch, n, prompt_len=lens))
    return {u: out[i].tolist() for i, u in enumerate(prompts)}


def _jax_engine_tokens(jm, jv, mesh, prompts, kv):
    eng = JaxEngine(jm, jv, mesh=mesh, max_new_tokens=5, max_slots=3,
                    prompt_buckets=(8, 16), paged=True, block_size=4,
                    kv_dtype=kv)
    got = {}
    for u, p in prompts.items():
        eng.submit(u, p, on_done=lambda uri, t: got.__setitem__(
            uri, np.asarray(t).tolist()))
    eng.drain()
    return got


@pytest.fixture(scope="module")
def fleet(tmp_path_factory, devices):
    outdir = tmp_path_factory.mktemp("fleet")
    inp, jm, jv = tier_inputs(outdir)
    workers = Ranks("fleet", outdir, 2)
    mesh = make_mesh(axes={"dp": -1, "tp": 2})
    ref = {"handoff": {None: _jax_generate(jm, jv, inp["handoff_prompts"],
                                           5),
                       "int8": _jax_engine_tokens(
                           jm, jv, mesh, inp["handoff_prompts"], "int8")},
           "generate": _jax_generate(jm, jv, inp["fleet_prompts"], 4)}
    return inp, workers.wait(), ref


@pytest.mark.parametrize("kv", [None, "int8"])
def test_tp2_handoff_pair_matches_jax(fleet, kv):
    """A -> B handoff under tp: every request prefills on A, ships each
    rank's shard of its chain to B on that rank and decodes there;
    tokens equal the reference's ``generate`` (f32 pools) or its int8
    paged engine at tp=2, every rank counts each export and adoption,
    and both pools end idle."""
    inp, ranks, ref = fleet
    n = len(inp["handoff_prompts"])
    assert ranks[0]["handoff"][kv]["tokens"] == ref["handoff"][kv]
    for r in ranks:
        assert r["handoff"][kv]["counts"] == (n, n)
        assert r["handoff"][kv]["idle"] == (0, 0, 0, 0)


def test_tp2_resent_and_undelivered_handoffs_free_their_shards(fleet):
    """A follower keeps its parked shard until the leader's release:
    the first of 20 exports, adopted again after the 19 others (an
    ack-timeout retry), decodes its tokens again on every rank; an
    export whose delivery fails errors on the leader and is freed; an
    export its own source adopts decodes on every rank; every rank's box
    ends empty and the leader has released every export."""
    inp, ranks, ref = fleet
    want = ref["handoff"][None]
    got = ranks[0]["resend"]
    assert got["tokens"] == {f"{u}-{i}": want[u] for i in range(5)
                             for u in want}
    assert got["again"] == got["tokens"]["h0-0"]
    assert got["errors"] == ["lost"]
    assert got["self"] == got["tokens"]["h0-0"]
    assert got["sent"] == {}
    for r in ranks:
        assert r["resend"]["parked"] == 0
        assert r["resend"]["counts"] == (22, 1, 21)
        assert r["resend"]["idle"] == (0, 0, 0, 0)


def test_handoff_box_keeps_a_shard_until_its_release():
    """``_HandoffBox`` (one rank, no process group): a shard outlives
    its takes until the release, the release waits for the adoptions it
    counts, a release of none frees at once, and a take with no export
    raises after its bounded wait."""
    from analytics_zoo_tpu_torch.serving.continuous import _HandoffBox

    box = _HandoffBox()
    box.put("a", {"k": 1})
    assert box.take("a") == {"k": 1} and box.take("a") == {"k": 1}
    box.release("a", 3)
    assert len(box) == 1
    assert box.take("a") == {"k": 1} and len(box) == 0
    box.put("b", {"k": 2})
    box.release("b", 0)
    assert len(box) == 0
    box.put("c", {"k": 3})
    box.release("c", 1)
    assert box.take("c") == {"k": 3} and len(box) == 0
    box.sent("d")
    box.sent("d")
    assert box.unsend("d") == 2 and box.unsend("d") == 0
    box.WAIT_S = 0.05
    with pytest.raises(RuntimeError, match="parked no shard"):
        box.take("e")


def test_handoff_box_under_threads():
    """Source threads that export and then release (in a lane's order)
    beside threads that adopt each export twice (the follow loops of
    other lanes of the rank): every adoption gets its own shard and the
    box ends empty."""
    import random
    import sys
    import threading

    from analytics_zoo_tpu_torch.serving.continuous import _HandoffBox

    box = _HandoffBox()
    uris = [f"u{i}" for i in range(200)]
    bad = []

    def adopt(part):
        for u in part:
            if box.take(u) != {"k": u}:
                bad.append(u)

    def source(part):
        for u in part:
            box.put(u, {"k": u})
        for u in part:
            box.release(u, 2)

    parts = [uris[i::4] for i in range(4)]
    jobs = [(source, p) for p in parts] + [(adopt, p) for p in parts] * 2
    random.Random(0).shuffle(jobs)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=f, args=(p,)) for f, p in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == [] and len(box) == 0


@pytest.mark.parametrize("mode", ["replicas", "roles"])
def test_tp2_replicas_answer_as_one_rank_and_jax(fleet, mode):
    """``ClusterServing(n_replicas=2, engine_mesh=tp2)``: every answer
    equals one rank's fleet and the reference's ``generate``; with
    prefill/decode roles every request hands off (on every rank's
    engines), the directory routes at least one request by its cached
    head, every rank's engines end idle, and the leader has released
    every export."""
    inp, ranks, ref = fleet
    n = len(inp["fleet_prompts"])
    got = ranks[0]["fleet"][(mode, "tp2")]
    one = ranks[0]["fleet"][(mode, "tp1")]
    assert got["tokens"] == one["tokens"] == ref["generate"]
    for r in ranks:
        engines = r["fleet"][(mode, "tp2")]["engines"]
        assert all(e[2:4] == (0, 0) for e in engines), engines
        if mode == "roles":
            assert engines[0][0] == n and engines[1][1] == n
    # the leader released every export it delivered
    assert got["unreleased"] == [0, 0]
    if mode == "roles":
        assert got["status"]["handoffs"] == n
        assert max(got["hits"]) > 0
        assert got["hits"] == one["hits"]
    else:
        assert sum(got["status"]["routed"]) == n
