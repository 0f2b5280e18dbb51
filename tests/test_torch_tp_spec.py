"""Tensor-parallel serving on the port, speculative combos: the
target and its draft both sharded under the same rules, each pool
tenant holding its kv heads; port tp=2 = port tp=1 = the JAX engine on
its tp=2 mesh, greedy at f32 (``test_torch_tp_serving.py`` has the
rest; one two-rank worker launch for the module, ``_torch_tp.py``)."""

import pytest

from _torch_tp import check_combo, run_module

COMBOS = ("spec", "spec-paged", "spec-chunked", "spec-paged-chunked")


@pytest.fixture(scope="module")
def tp(tmp_path_factory, devices):
    return run_module(tmp_path_factory, COMBOS, False)


@pytest.mark.parametrize("combo", COMBOS)
def test_spec_tp2_matches_tp1_and_jax_tp2(tp, combo):
    check_combo(tp, combo)


def test_draft_pool_sharded(tp):
    """The draft tenant's pool holds its kv heads too."""
    for r in tp[1]:
        assert r["shapes"]["spec-paged"]["draft"][2] == 1
        assert r["shapes"]["spec-paged"]["k"][2] == 1
