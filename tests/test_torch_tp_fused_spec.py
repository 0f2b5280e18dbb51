"""Tensor-parallel speculative serving on the port through the paged
kernel's sharded wrapper (``kernel="fused"`` for the target and the
draft tenant): port tp=2 = port tp=1 = the JAX engine's fused read on
its tp=2 mesh, greedy at f32 (one two-rank worker launch for the
module, ``_torch_tp.py``)."""

import pytest

from _torch_tp import check_combo, run_module

COMBOS = ("fused-spec-paged", "fused-spec-paged-chunked")


@pytest.fixture(scope="module")
def tp(tmp_path_factory, devices):
    return run_module(tmp_path_factory, COMBOS, False)


@pytest.mark.parametrize("combo", COMBOS)
def test_fused_spec_tp2_matches_tp1_and_jax_tp2(tp, combo):
    check_combo(tp, combo)
