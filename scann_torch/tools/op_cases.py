"""Small operands for every custom op of ops/library.py.

``op_cases()`` maps each op's name to (op, CPU arguments, the plain
version's call on the same operands).  tests/test_torch_export.py runs
``torch.library.opcheck`` and the plain-version equality on them;
tests/test_torch_cuda_entry_points.py moves them to the card and holds
each kernel against the plain result.
"""

from __future__ import annotations

import numpy as np
import torch

from scann_torch.ops import fused_scan, library, pruned_lut
from scann_torch.ops import pruned_scan as ps
from scann_torch.ops import pruned_sq


def _plan(seed=0, nl=6, b=40, l=3):
    """A leaf-major plan of ``b`` queries over ``l`` of ``nl`` leaves of
    one or two tiles; returns (plan, number of tiles, the leaves' tile
    counts, the generator, the plan's operands: sel, valid, tile_start,
    ntiles, max_ntiles, g_pad)."""
    r = np.random.default_rng(seed)
    ntiles = r.integers(1, 3, nl).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    sel = np.stack([r.choice(nl, l, replace=False) for _ in range(b)])
    valid = r.random((b, l)) < 0.9
    g_pad, w_pad = ps.plan_capacities(b, l, nl, int(ntiles.sum()),
                                      int(ntiles.max()))
    t = torch.as_tensor
    args = (t(sel.astype(np.int32)), t(valid), t(tile_start), t(ntiles),
            int(ntiles.max()), g_pad)
    plan = ps.invert(*args, w_pad)
    return plan, int(ntiles.sum()), t(ntiles), r, args


def op_cases():
    """(op, args, plain) for every custom op at a small shape."""
    plan, nt, _, r, _ = _plan()
    t = torch.as_tensor
    d = 16
    q = t(r.standard_normal((40, d)).astype(np.float32)).to(torch.bfloat16)
    qg = q[plan.qg_query.long()]
    rows8 = t(r.integers(-127, 128, (nt, 256, d)).astype(np.int8))
    scale = t(r.uniform(1e-3, 1e-2, (nt, 256, 1)).astype(np.float32))
    bias8 = t(-r.uniform(0, 1, (nt, 256, 1)).astype(np.float32))
    p2, nt2, ntiles2, _, args2 = _plan(seed=1)
    # More pairs than a query group (invert's sorted plan, not
    # invert_small's), some of them invalid.
    *_, plan_args = _plan(seed=2, nl=9, b=70, l=4)
    q2 = q[p2.qg_query.long()]
    rows16 = t(r.standard_normal((nt2, 512, d)).astype(np.float32)).to(
        torch.bfloat16)
    bias16 = t(-r.uniform(0, 1, (nt2, 512, 1)).astype(np.float32))
    cb = t(r.standard_normal((8, 16, 2)).astype(np.float32))
    mean = torch.zeros(d)
    cb_k, csq = pruned_lut.lut_tables(cb, mean, 8, measure_l2=True)
    codes = r.integers(0, 16, (nt2 * 512, 8)).astype(np.uint8)
    codes3p = t(pruned_lut.pack_codes_nibble(codes, nt2))
    codes3 = t(pruned_lut.pack_codes_tiles(codes, nt2))
    cb_t = pruned_lut.codes_table(cb, 8)
    lut, inv = pruned_lut.lut_build_torch(q, cb_k, csq, measure_l2=True)
    k5q = t(r.standard_normal((5, 64)).astype(np.float32)).to(torch.bfloat16)
    k5r = t(r.standard_normal((2048, 64)).astype(np.float32)).to(
        torch.bfloat16)
    k5b = t(r.standard_normal(2048).astype(np.float32))
    packed = ps.score_work_torch(p2, q2, rows16, bias16, measure_l2=False,
                                 kpg=8)
    kgp = packed.shape[-1] // (p2.work_tile.shape[0] // packed.shape[0])
    qg_nt = ntiles2[p2.qg_leaf.long()].contiguous()
    w = p2.work_tile, p2.work_qg, p2.work_active
    w1 = plan.work_tile, plan.work_qg, plan.work_active
    g1, g2 = plan.qg_query.shape[0], p2.qg_query.shape[0]
    # The merge of p2's packed survivors: 2 of its 3 leaves hot, a pair
    # bias, the squared-L2 restore and padded slots (id -1).
    sel2, valid2, ts2 = args2[:3]
    dpid2 = t(np.where(r.random(nt2 * 512) < 0.9,
                       r.permutation(nt2 * 512), -1).astype(np.int32))
    bias2 = t(r.standard_normal(tuple(sel2.shape)).astype(np.float32))
    norm2 = t(r.uniform(0, 2, sel2.shape[0]).astype(np.float32))
    merge_args = (packed, p2.work_active, p2.pair_gid, p2.pair_row, sel2,
                  valid2, ts2, ntiles2, dpid2, bias2, norm2,
                  int(ntiles2.max()), 10, 2, 512)
    return {
        "pruned_sq_score": (
            library.pruned_sq_score,
            (*w1, qg, rows8, scale, bias8, g1, True, 4),
            lambda: pruned_sq.score_work_torch_sq(
                plan, qg, rows8, scale, bias8, measure_l2=True, kpg=4)),
        "pruned_rows_score": (
            library.pruned_rows_score,
            (*w, q2, rows16, bias16, g2, False, 8),
            lambda: ps.score_work_torch(p2, q2, rows16, bias16,
                                        measure_l2=False, kpg=8)),
        "pruned_lut_build": (
            library.pruned_lut_build, (q, cb_k, csq, True),
            lambda: pruned_lut.lut_build_torch(q, cb_k, csq,
                                               measure_l2=True)),
        "pruned_lut_score": (
            library.pruned_lut_score,
            (*w, p2.qg_query, lut, inv, codes3p, bias16, 8),
            lambda: pruned_lut.score_work_torch_lut(
                p2, q2, codes3p, cb_k, csq, bias16, measure_l2=True,
                kpg=8)),
        "pruned_codes_score": (
            library.pruned_codes_score,
            (*w, q2, codes3, cb_t, mean, bias16, g2, True, 8),
            lambda: pruned_lut.score_work_torch_codes(
                p2, q2, codes3, cb_t, mean, bias16, measure_l2=True,
                kpg=8)),
        "fused_scan_groupmax": (
            library.fused_scan_groupmax, (k5q, k5r, k5b, True),
            lambda: fused_scan.fused_scan_groupmax_torch(
                k5q, k5r, k5b, measure_l2=True)),
        "merge_groups": (
            library.merge_groups, (packed, qg_nt, kgp, 512, 10),
            lambda: ps.merge_groups_torch(packed, qg_nt, kgp=kgp, tile=512,
                                          k=10)),
        "pruned_plan": (
            library.pruned_plan, plan_args,
            lambda: ps.invert(*plan_args, plan_args[-1] * plan_args[-2])),
        "pruned_merge": (
            library.pruned_merge, merge_args,
            lambda: ps.merge_ids_torch(
                *merge_args[:11], max_ntiles=merge_args[11], k_fetch=10,
                hot=2, tile=512)),
    }
