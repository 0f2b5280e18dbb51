"""Tensor-parallel serving on the port through the paged kernel's
sharded wrapper (``kernel="fused"``: ``paged_attention_fused_tp``,
which on the CPU runs the kernel's plain version on each rank's kv-head
shard): port tp=2 = port tp=1 = the JAX engine's fused read on its tp=2
mesh (Pallas interpret mode), greedy at f32, the int8 pool with its
scales sharded beside its data included (one two-rank worker launch for
the module, ``_torch_tp.py``)."""

import pytest

from _torch_tp import check_combo, run_module

COMBOS = ("fused-paged", "fused-paged-chunked", "int8-fused")


@pytest.fixture(scope="module")
def tp(tmp_path_factory, devices):
    return run_module(tmp_path_factory, COMBOS + ("int8-gather",), False)


@pytest.mark.parametrize("combo", COMBOS)
def test_fused_tp2_matches_tp1_and_jax_tp2(tp, combo):
    check_combo(tp, combo)


def test_int8_pool_shards_both_leaves(tp):
    """An int8 pool's data and its per-row scales both hold this rank's
    kv heads, and the gather reads the same tokens as the kernel's
    path."""
    for r in tp[1]:
        data, scale = r["shapes"]["int8-fused"]["k"]
        assert data[2] == 1 and scale[2] == 1 and len(scale) == 4
    got = tp[1][0]["tokens"]
    assert got[("int8-gather", "tp2")] == got[("int8-gather", "tp1")]
    assert got[("int8-gather", "tp2")] == got[("int8-fused", "tp2")]
