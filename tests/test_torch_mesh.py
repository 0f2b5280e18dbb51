"""The port's meshes, partition rules and context modes
(``parallel/mesh.py``, ``parallel/partition.py``,
``common/context.py``), mirroring ``tests/test_context.py``, and the two
sharded kernel wrappers on each rank's shard
(``sharded_flash_attention``, ``paged_attention_fused_tp``), mirroring
``test_ops_flash.py``'s and ``test_paged_fused.py``'s mesh cases.

Four gloo processes (``_torch_dist_worker.py`` scenario ``mesh``, one
launch for the module) start through ``init_orca_context("distributed",
mesh_axes={"tp": 2, "dp": -1})``; on the CPU each wrapper runs its
kernel's plain version.  A gathered shard must equal the whole: bitwise
for the paged read (each rank runs the same per-head arithmetic), 1e-6
for flash attention.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from analytics_zoo_tpu.parallel import make_mesh as jax_mesh
from analytics_zoo_tpu.parallel import \
    match_partition_rules as jax_match
from analytics_zoo_tpu_torch.common import context
from analytics_zoo_tpu_torch.common.context import (OrcaContext,
                                                    init_orca_context,
                                                    stop_orca_context)
from analytics_zoo_tpu_torch.parallel import P, resolve_axis_sizes

from _torch_dist import run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("mesh", tmp_path_factory.mktemp("mesh"), 4)


def test_mesh_axes_resolution():
    assert resolve_axis_sizes({"dp": -1, "tp": 2}, 8) == {"dp": 4, "tp": 2}
    assert resolve_axis_sizes({"dp": 8}, 8) == {"dp": 8}
    with pytest.raises(ValueError):
        resolve_axis_sizes({"dp": 3}, 8)
    with pytest.raises(ValueError):
        resolve_axis_sizes({"dp": -1, "tp": -1}, 8)


def test_init_local_default_mesh():
    """One process: a one-rank mesh, the reference's default axes."""
    ctx = init_orca_context("local", device="cpu")
    try:
        assert ctx.num_devices == 1
        assert ctx.mesh.shape == {"dp": 1}
        assert OrcaContext.get_context() is ctx
        assert (ctx.process_index, ctx.num_processes) == (0, 1)
    finally:
        stop_orca_context()
    with pytest.raises(RuntimeError):
        OrcaContext.get_context()


def test_spark_modes_rejected_and_trials_unported():
    with pytest.raises(ValueError, match="multihost"):
        init_orca_context("yarn-client", device="cpu")
    with pytest.raises(NotImplementedError, match="item 6.3"):
        context.local_process_scope()


def test_distributed_context_and_canonical_order(ranks):
    """dp outermost whatever the dict order; four ranks laid row-major
    over it; the context's device, process index and count are the
    process group's."""
    for i, r in enumerate(ranks):
        assert r["axis_names"] == ("dp", "tp")
        assert r["shape"] == {"dp": 2, "tp": 2}
        assert r["num_devices"] == 4
        assert r["process"] == (i, 4) and r["effective"] == (4, i)
        assert r["coords"] == {"dp": i // 2, "tp": i % 2}
        assert r["tp_line"] == (2 * (i // 2), 2 * (i // 2) + 1)
        assert "device count 4" in r["bad_axes"]


def test_partition_rules_and_fallback(ranks, devices):
    """The reference's rules test on the port's mesh: the tp rule on a
    dim tp does not divide falls back to replication, as the reference's
    does on its dp=4 x tp=2 mesh."""
    got = ranks[0]["specs"]
    assert got["dense"]["kernel"] == P(None, "tp")
    assert got["dense"]["bias"] == P()
    assert got["emb"]["embedding"] == P()
    assert got["scalar"] == P()
    tree = {"dense": {"kernel": np.zeros((16, 8)), "bias": np.zeros((8,))},
            "emb": {"embedding": np.zeros((100, 7))},
            "scalar": np.float32(3.0)}
    ref = jax_match(((r"emb/embedding", JP(None, "tp")),
                     (r"kernel", JP(None, "tp")), (r".*", JP())), tree,
                    jax_mesh(axes={"dp": 4, "tp": 2}))
    for a, b in (("dense", "kernel"), ("dense", "bias"),
                 ("emb", "embedding")):
        assert tuple(got[a][b]) == tuple(ref[a][b]), (a, b)
    assert "item 6.1" in ranks[0]["fsdp"]


def test_data_groups_rows_and_host_files(ranks):
    """Ranks of one dp coordinate hold the same rows; a {host} path is
    the rank's; files split round-robin over the processes."""
    for i, r in enumerate(ranks):
        assert r["groups"] == (2, i // 2, [0, 0, 1, 1])
        assert r["batch_size"] == 2
        assert r["rows"] == slice(4 * (i // 2), 4 * (i // 2) + 4)
        assert r["host_path"] == f"s{i}.z"
        assert r["files"] == [f"f{j}" for j in range(5)][i::4]


def test_shard_and_gather_round_trip(ranks):
    full = torch.arange(48, dtype=torch.float32).reshape(4, 12)
    for i, r in enumerate(ranks):
        d, t = i // 2, i % 2
        assert torch.equal(r["shard"], full[2 * d:2 * d + 2,
                                            6 * t:6 * t + 6])
        assert torch.equal(r["gathered"], full)


def test_sharded_flash_on_mesh_matches_whole(ranks):
    """Each rank's rows and heads through ``sharded_flash_attention``,
    gathered, equal the whole batch's attention (causal, key mask)."""
    for r in ranks:
        np.testing.assert_allclose(r["flash_mine"].numpy(),
                                   r["flash_whole"].numpy(), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_fused_tp_sharded_pool_matches(ranks, kind):
    """``paged_attention_fused_tp`` on a rank's kv-head shard (the int8
    scales cut with their data) equals the whole pool's read of that
    rank's query heads, bitwise."""
    for r in ranks:
        whole, mine = r[f"paged_{kind}"]
        assert torch.equal(whole, mine)


def test_fused_tp_replicated_hatch(ranks):
    """KH=1 under tp=2: the replicated pool and every query head read on
    every rank equal one rank's read, bitwise (the ``KH % tp`` refusal
    of a sharded pool is the engine's: ``test_torch_tp_serving.py``)."""
    for r in ranks:
        solo, tp = r["hatch"]
        assert torch.equal(solo, tp)
