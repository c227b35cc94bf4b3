"""chip_smoke.py's plan and merge checks, driven on small CPU indexes: the
operands they build are the main path's (the partitioner's select_leaves,
the index's tile tables, plan_capacities' g_pad; the engine's tokenize,
plan, budget and scorer for the merge), the plan held is
pruned_scan.work_plan's, the merge held is pruned_scan.select_merge's,
and on CPU tensors neither launches a kernel."""

import numpy as np
import pytest
import torch

import chip_smoke
import scann_torch
from scann_torch.ops import pruned_scan as ps
import torch_threads  # noqa: F401  (torch threads per xdist worker)


def test_plan_check_holds_the_main_paths_plan():
    rng = np.random.default_rng(5)
    db = rng.standard_normal((3000, 16)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    s = (scann_torch.builder(db, 10, "dot_product", device="cpu")
         .tree(num_leaves=20, num_leaves_to_search=4,
               training_sample_size=3000)
         .score_brute_force(quantize="int8").build())
    ops = chip_smoke.plan_operands(s, q, 4)
    leaf_ids, valid, _ = s.partitioner.select_leaves(q, 4)
    assert torch.equal(ops[0], leaf_ids) and torch.equal(ops[1], valid)
    assert ops[-1] == ps.plan_capacities(64, 4, 20, s._layout.num_tiles,
                                         s._layout.max_ntiles)[0]
    rec = chip_smoke.plan_check(torch, s, q, 4, "a CPU tree-SQ index")
    assert rec["bit_equal"] and rec["launches"] == 0
    assert (rec["queries"], rec["leaves"], rec["num_leaves"]) == (64, 4, 20)
    assert "ms" not in rec          # timings are the card's alone
    plan = chip_smoke.pruned_plan(torch, s, q, 4)
    want = ps.invert(*ops, ops[-1] * ops[-2])
    assert all(torch.equal(a, b) for a, b in zip(plan, want))
    assert chip_smoke.plan_bound_bytes(256, 20, ops[-1], ops[-1] * 2) == (
        13 * 256 + 8 * 20 + ops[-1] * (4 * ps.QG + 4) + 24 * ops[-1])


def _index(engine):
    rng = np.random.default_rng(7)
    db = rng.standard_normal((4000, 16)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    measure = "squared_l2" if engine == "tree_sq" else "dot_product"
    tree = dict(soar_lambda=1.5, overretrieve_factor=2.0) \
        if engine == "soar" else {}
    b = scann_torch.builder(db, 10, measure, device="cpu").tree(
        num_leaves=20, num_leaves_to_search=4, training_sample_size=4000,
        **tree)
    if engine == "tree_sq":
        b = b.score_brute_force(quantize="int8").reorder(40)
    else:
        b = b.score_ah(2, anisotropic_quantization_threshold=0.2).reorder(50)
    s = b.build()
    s.search_batched(q.numpy())              # the lazy layout
    return s, q, 40 if engine == "tree_sq" else 50


@pytest.mark.parametrize("engine", ["tree_sq", "tree_ah", "soar"])
def test_merge_check_holds_the_main_paths_merge(engine, monkeypatch):
    s, q, k_pre = _index(engine)
    args, kw = chip_smoke.merge_operands(torch, s, q, 4, k_pre)
    # The operands are the main path's: its merge of them is the search's.
    want = s._pruned_select(q, k_pre, 4, None)
    got = s._dedup(*ps.merge_ids_torch(*args, **kw), k_pre)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (args[10] is None) == (engine != "tree_sq")   # the L2 restore
    rec = chip_smoke.merge_check(torch, s, q, 4, k_pre, f"a CPU {engine}")
    assert rec["bit_equal"] and rec["launches"] == 0
    assert (rec["queries"], rec["leaves"], rec["hot"]) == (64, 4, 4)
    assert rec["k"] == kw["k_fetch"] and "ms" not in rec
    # A merge that differs from the plain one fails the check.
    real = ps.select_merge
    monkeypatch.setattr(ps, "select_merge", lambda *a, **k: (
        real(*a, **k)[0], real(*a, **k)[1].flip(1)))
    with pytest.raises(AssertionError, match="ids differ"):
        chip_smoke.merge_check(torch, s, q, 4, k_pre, f"a CPU {engine}")
