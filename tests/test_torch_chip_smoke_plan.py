"""chip_smoke.py's plan check, driven on a small CPU tree-SQ index: the
operands it builds are the main path's (the partitioner's select_leaves,
the index's tile tables, plan_capacities' g_pad), the plan it holds is
pruned_scan.work_plan's, and on CPU tensors it launches no kernel."""

import numpy as np
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
