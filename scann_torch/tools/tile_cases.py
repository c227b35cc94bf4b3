"""K1 and K2 scoring problems made from a seed, and their survivors held
to float64: shared by the card tests, chip_smoke.py and tile_breakdown.

Two scales of data (``unit`` in synthetic_case):
  * ``raw``: standard-normal queries, int8 codes over the full range with
    scales of 1e-3 to 1e-2 (K1), or bf16 rows of 0.3 a dimension (K2);
  * ``unit``: unit-norm queries and rows, int8 residual codes with the
    encoder's per-row scale, the scale of an index of unit vectors.
At raw scale and wide d_pad the plain version's own f32 error passes the
bars' 1e-6 / 1e-5 floors, so there the kernel is held to float64 relative
to the plain version (raw_excess, RAW_EXCESS_RATIO).
"""

from __future__ import annotations

import numpy as np
import torch

from scann_torch.ops import pruned_scan as ps
from scann_torch.ops import pruned_sq

# The kernel's largest float64 excess at raw scale is at most this multiple
# of the plain version's, at the (kernel, d_pad) of RAW_CASES.
RAW_EXCESS_RATIO = 1.5
RAW_CASES = (("k1", 768), ("k2", 384))


def synthetic_case(kernel: str, d: int, *, unit: bool, measure_l2: bool,
                   seed: int = 0, nq: int = 1000, nl: int = 60,
                   leaves: int = 8, device: str = "cuda"):
    """A K1 (``kernel`` "k1") or K2 ("k2") scoring problem from a seed:
    (plan, qg_rows, rows, scale or None, bias).  K1: leaves of 1-4
    256-slot tiles, int8 rows; K2: leaves of 1-2 512-slot tiles, bf16 rows
    with the bias -||x||^2 under squared L2.  10% of the slots are padding
    (bias -1e30).  ``unit``: the scale of the data (module docstring)."""
    r = np.random.default_rng(seed)
    tile, max_nt = (256, 4) if kernel == "k1" else (512, 2)
    d_pad = -(-d // 8) * 8
    ntiles = r.integers(1, max_nt + 1, nl).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    num_tiles = int(ntiles.sum())
    sel = np.argsort(r.random((nq, nl)), axis=1)[:, :leaves].astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=device)

    mnt = int(ntiles.max())
    g_pad, w_pad = ps.plan_capacities(nq, leaves, nl, num_tiles, mnt)
    plan = ps.invert(t(sel), t(np.ones((nq, leaves), bool)), t(tile_start),
                     t(ntiles), mnt, g_pad, w_pad)
    pad = r.random((num_tiles, tile, 1)) < 0.1
    q = np.zeros((nq, d_pad), np.float32)
    q[:, :d] = r.standard_normal((nq, d))
    if unit:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    qg = t(q).to(torch.bfloat16)[plan.qg_query.long()]
    if kernel == "k1":
        if unit:
            res = np.zeros((num_tiles, tile, d_pad))
            res[..., :d] = 0.4 / np.sqrt(d) * r.standard_normal(
                (num_tiles, tile, d))
            scale = np.abs(res).max(-1, keepdims=True) / 127
            rows = np.rint(res / scale).astype(np.int8)
        else:
            rows = np.zeros((num_tiles, tile, d_pad), np.int8)
            rows[..., :d] = r.integers(-127, 128, (num_tiles, tile, d))
            scale = r.uniform(1e-3, 1e-2, (num_tiles, tile, 1))
        rows_t, scale_t = t(rows), t(scale.astype(np.float32))
        bias = -r.uniform(0, 1, (num_tiles, tile, 1))
        if measure_l2:
            bias = -(((rows * scale) ** 2).sum(-1, keepdims=True))
    else:
        x = np.zeros((num_tiles, tile, d_pad), np.float32)
        x[..., :d] = 0.3 * r.standard_normal((num_tiles, tile, d))
        if unit:
            x /= np.linalg.norm(x, axis=-1, keepdims=True)
        x[pad[..., 0]] = 0.0
        rows_t, scale_t = t(x).to(torch.bfloat16), None
        bias = np.zeros((num_tiles, tile, 1))
        if measure_l2:
            bias = -(rows_t.float() ** 2).sum(-1, keepdim=True).cpu().numpy()
    bias = np.where(pad, -1e30, bias).astype(np.float32)
    return plan, qg, rows_t, scale_t, t(bias)


def score(kernel, case, kpg, measure_l2):
    """The wrapper of K1 / K2 (the kernel on a CUDA case)."""
    plan, qg, rows, scale, bias = case
    if kernel == "k1":
        return pruned_sq.score_work_sq(plan, qg, rows, scale, bias,
                                       measure_l2=measure_l2, kpg=kpg)
    return ps.score_work(plan, qg, rows, bias, measure_l2=measure_l2,
                         kpg=kpg)


def plain(kernel, case, kpg, measure_l2):
    """The plain torch version of K1 / K2."""
    plan, qg, rows, scale, bias = case
    if kernel == "k1":
        return pruned_sq.score_work_torch_sq(plan, qg, rows, scale, bias,
                                             measure_l2=measure_l2, kpg=kpg)
    return ps.score_work_torch(plan, qg, rows, bias, measure_l2=measure_l2,
                               kpg=kpg)


def exact_excess(case, packed, kpg, measure_l2):
    """|value - exact| - 2^-14 |exact| of every live survivor of an
    active item, its slot read from its identity and rescored in float64
    (the bars' form: the 9 identity bits cost up to 2^-14 relative)."""
    plan, qg, rows, scale, bias = case
    tile = rows.shape[1]
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    seg = packed.shape[-1] // mnt
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, ps.QG, mnt, seg)
    idx = torch.nonzero(act)
    mult = 2.0 if measure_l2 else 1.0
    parts = []
    for c0 in range(0, idx.shape[0], 1 << 17):
        gi, qi, ti, ci = idx[c0:c0 + (1 << 17)].unbind(1)
        val, arg, _ = ps._unpack(packed.reshape(act.shape)[gi, qi, ti, ci])
        slot = (ci % (tile // ps.SUBP)) * ps.SUBP + arg.long()
        tid = plan.work_tile.reshape(g_pad, mnt)[gi, ti].long()
        s = (rows[tid, slot].double() * qg[gi, qi].double()).sum(-1)
        s = s * (mult if scale is None else
                 scale.reshape(-1, tile)[tid, slot].double() * mult)
        exact = s + bias.reshape(-1, tile)[tid, slot].double()
        live = exact > -1e20
        parts.append(((val.double() - exact).abs()
                      - 2.0 ** -14 * exact.abs())[live])
    return torch.cat(parts)


def pair_excess(case, got, want):
    """|kernel - plain| - 2^-14 |plain| over the active segments."""
    plan = case[0]
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, ps.QG, mnt, got.shape[-1] // mnt).reshape(got.shape)
    va, vb = ps._unpack(got[act])[0].double(), ps._unpack(want[act])[0].double()
    live = vb > -1e20
    return ((va - vb).abs() - 2.0 ** -14 * vb.abs())[live]


def raw_excess(kernel, d, measure_l2, run, kpg=8):
    """(largest float64 excess of ``run(case)``'s survivors, the plain
    version's) on the raw-scale case of ``kernel`` at width d, seed d."""
    case = synthetic_case(kernel, d, unit=False, measure_l2=measure_l2,
                          seed=d)
    got = run(case)
    want = plain(kernel, case, kpg, measure_l2)
    torch.cuda.synchronize()
    return (float(exact_excess(case, got, kpg, measure_l2).max()),
            float(exact_excess(case, want, kpg, measure_l2).max()))
