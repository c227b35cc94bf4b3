"""Pruned (leaf-gathered) scoring: work plan, packed survivors, merge.

Port of scann_tpu/ops/pruned_scan.py.  Slots are sorted by leaf, each leaf
padded to a multiple of the tile size, and the (query, leaf) selections of
a batch are inverted into leaf-major work items: item
``w = group * max_ntiles + t`` scores tile ``t`` of one query group's leaf
for up to ``QG`` queries.  Each scorer keeps the top ``kpg`` of every
``SUBP``-slot group with its (tile, slot) identity packed into the low 9
mantissa bits, and ``merge_candidates`` (stratified gathers) or
``merge_candidates_fused`` (one top-k reduction per packed row) turns those
survivors into each query's top-k.

Both pruned engines (tree-AH and tree-SQ) hold their layout in one
``PrunedLayout`` and share ``fits``, ``plan_batch`` and ``candidates``.

Three hand-written CUDA kernels live behind this module: ``score_work`` (K2,
csrc/pruned_rows.cu, the port of the Pallas kernel ``score_work_pallas``:
decoded bf16 rows of tree-AH in reconstruct mode), ``merge_groups`` (K6,
csrc/merge_groups.cu, the port of ``merge_groups_pallas``) and
``work_plan`` (csrc/pruned_plan.cu: ``invert``'s plan built on the card
with no host synchronisation), each through its custom op
(ops/library.py).  On CUDA tensors they launch their kernels or raise; on
CPU tensors they run ``score_work_torch`` / ``merge_groups_torch`` /
``invert``.  The tree-SQ and LUT scorers
live in ops/pruned_sq.py and ops/pruned_lut.py.

Shapes, constants and path boundaries are the JAX package's, unchanged, so
both packages take the same path on the same batch.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from scann_torch.ops import topk as topk_ops

TILE = 512  # slots per leaf tile of the JAX tree-AH layout (tree-SQ uses 256)
SUBP = 32   # slots per candidate group
KPG = 8     # survivors kept per group (tree-AH default)
GP = TILE // SUBP  # candidate groups per TILE-slot tile
QG = 128    # queries per work group
_IDX_BITS = 5      # SUBP <= 32: the in-group slot packs into the mantissa
_IDX_MASK = (1 << _IDX_BITS) - 1
_TILE_BITS = 4     # tile-within-leaf packs above the slot (mnt <= 16)
_TILE_MASK = (1 << _TILE_BITS) - 1
MAX_NTILES = 1 << _TILE_BITS  # leaves larger than this many tiles take the
# dense path
MAX_PLAN_WORK = 100_000  # work-item budget of one plan; larger plans take
# the dense masked scan (kept equal to the JAX package's boundary)
HOT_LEAVES = 8  # leaves per query (by tokenization rank) merged at full
# survivor width; colder leaves contribute each group's top-1 only
_PAD_PENALTY = -1e30  # bias of padded / disallowed slots

_SENTINEL = 1 << 30
_ID_BITS = _IDX_BITS + _TILE_BITS
_ID_MASK = (1 << _ID_BITS) - 1

# Kernel launches of K2 and K6 and plans built on the card, counted by
# their CUDA implementations in ops/library.py (CPU calls never count).
launches = 0
launches_merge = 0
launches_plan = 0

_WORK_CHUNK = 32
_SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may use


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class WorkPlan(NamedTuple):
    """Leaf-major work decomposition of one query batch (uncompacted:
    item w = gid * max_ntiles + t; items with t >= ntiles(leaf) are
    inactive and their tile clamps to the group's last live tile)."""
    qg_query: torch.Tensor   # (G_pad, QG) int32 query row per group slot
    qg_leaf: torch.Tensor    # (G_pad,) int32 leaf of each group
    work_tile: torch.Tensor  # (G_pad * mnt,) int32 leaf tile per item
    work_qg: torch.Tensor    # (G_pad * mnt,) int32 query group per item
    work_active: torch.Tensor  # (G_pad * mnt,) int32 1 if live
    pair_gid: torch.Tensor   # (B, L) int32 group of each (query, leaf) pair
    pair_row: torch.Tensor   # (B, L) int32 row of the query in its group


def plan_capacities(batch: int, num_sel: int, num_leaves: int,
                    num_tiles: int, max_ntiles: int):
    """Static capacities: at most B*L/QG full groups plus one partial group
    per active leaf; work items are g_pad * max_ntiles."""
    del num_tiles
    p = batch * num_sel
    g_pad = p // QG + min(num_leaves, p) + 1
    return g_pad, g_pad * max_ntiles


def _arange(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def _work_layout(g_tile0, g_nt, max_ntiles: int):
    """(work_tile, work_active) of the uncompacted layout; inactive items
    clamp to the group's last live tile."""
    t_iota = _arange(max_ntiles, g_nt.device)[None, :]
    t_eff = torch.minimum(t_iota, torch.clamp_min(g_nt[:, None] - 1, 0))
    work_tile = (g_tile0[:, None] + t_eff).reshape(-1)
    work_active = (t_iota < g_nt[:, None]).to(torch.int32).reshape(-1)
    return work_tile, work_active


def invert(sel, valid_sel, tile_start, ntiles, max_ntiles: int,
           g_pad: int, w_pad: int) -> WorkPlan:
    """Leaf-major work plan from per-query leaf selections.

    sel: (B, L) int32 leaf ids (distinct within a row); valid_sel (B, L)
    bool (False entries produce no work); tile_start/ntiles (num_leaves,)
    int32 layout tables.  A stable sort puts the pairs in leaf order, so
    group membership and ranks match the JAX package exactly."""
    del w_pad
    b, l = sel.shape
    dev = sel.device
    nl = tile_start.shape[0]
    p = b * l
    sort_key = torch.where(valid_sel, sel, _SENTINEL).reshape(-1)
    key_s, pos_s = torch.sort(sort_key.to(torch.int32), stable=True)
    q_s = (pos_s // l).to(torch.int32)
    valid_s = key_s < _SENTINEL

    # Rank of each pair within its leaf run.
    pos_iota = _arange(p, dev)
    is_start = torch.ones((p,), dtype=torch.bool, device=dev)
    is_start[1:] = key_s[1:] != key_s[:-1]
    run_start = torch.cummax(torch.where(is_start, pos_iota, 0), 0).values
    rank = pos_iota - run_start
    row = rank % QG

    leaves = _arange(nl, dev)
    lb = torch.searchsorted(key_s, leaves).to(torch.int32)
    ub = torch.searchsorted(key_s, leaves, right=True).to(torch.int32)
    ngroups = (ub - lb + QG - 1) // QG
    gbase = torch.cumsum(ngroups, 0, dtype=torch.int32) - ngroups
    g_total = gbase[-1] + ngroups[-1]

    # Group id per sorted pair, scattered back to pair-major order.
    leaf_clip = torch.clamp_max(key_s, nl - 1).long()
    gid = gbase[leaf_clip] + rank // QG
    packed_gr = torch.where(valid_s, gid * QG + row, 0)
    gr_pair = torch.empty_like(packed_gr)
    gr_pair[pos_s] = packed_gr
    pair_gid = (gr_pair // QG).reshape(b, l)
    pair_row = (gr_pair % QG).reshape(b, l)

    # Leaf of each group: mark each leaf's first group, forward-fill.
    has = ngroups > 0
    leaf_mark = torch.zeros((g_pad,), dtype=torch.int32, device=dev)
    leaf_mark[gbase[has].long()] = leaves[has] + 1
    qg_leaf = torch.clamp_min(torch.cummax(leaf_mark, 0).values - 1, 0)
    qg_leaf_l = qg_leaf.long()
    g_iota = _arange(g_pad, dev)
    g_active = g_iota < g_total

    # Query ids per group: QG-wide slices of the leaf-sorted query list.
    # Starts clamp to [0, p] like XLA's dynamic_slice; lanes past a
    # group's live count read neighbouring queries the merge never reads.
    group_pos = lb[qg_leaf_l] + (g_iota - gbase[qg_leaf_l]) * QG
    q_s_pad = torch.cat([q_s, torch.zeros((QG,), dtype=torch.int32,
                                          device=dev)])
    start = torch.clamp(group_pos, 0, p).long()
    qg_query = q_s_pad[start[:, None] + torch.arange(QG, device=dev)]

    g_nt = torch.where(g_active, ntiles[qg_leaf_l], 0)
    work_tile, work_active = _work_layout(tile_start[qg_leaf_l], g_nt,
                                          max_ntiles)
    work_qg = g_iota[:, None].expand(g_pad, max_ntiles).reshape(-1)
    return WorkPlan(qg_query, qg_leaf, work_tile, work_qg, work_active,
                    pair_gid, pair_row)


def invert_small(sel, valid_sel, tile_start, ntiles,
                 max_ntiles: int) -> WorkPlan:
    """Analytic plan for tiny batches (B * L <= QG): one query group per
    (query, leaf) pair, no sorts; same kernel and merge contracts as
    invert()."""
    b, l = sel.shape
    dev = sel.device
    p = b * l
    leaf_flat = torch.clamp_min(sel.reshape(-1), 0).to(torch.int32)
    leaf_l = leaf_flat.long()
    q_of_pair = torch.repeat_interleave(_arange(b, dev), l)
    qg_query = q_of_pair[:, None].expand(p, QG).contiguous()
    g_nt = torch.where(valid_sel.reshape(-1), ntiles[leaf_l], 0)
    work_tile, work_active = _work_layout(tile_start[leaf_l], g_nt,
                                          max_ntiles)
    work_qg = torch.repeat_interleave(_arange(p, dev), max_ntiles)
    pair_gid = _arange(p, dev).reshape(b, l)
    pair_row = torch.zeros((b, l), dtype=torch.int32, device=dev)
    return WorkPlan(qg_query, leaf_flat, work_tile, work_qg, work_active,
                    pair_gid, pair_row)


def work_plan(sel, valid_sel, tile_start, ntiles, max_ntiles: int,
              g_pad: int) -> WorkPlan:
    """invert()'s plan through the custom op ``pruned_plan``
    (ops/library.py).  CPU tensors run invert itself; CUDA tensors launch
    csrc/pruned_plan.cu (or raise), which builds the same plan bit for bit
    with no host synchronisation.  Valid entries of ``sel`` must be leaf
    ids in [0, num_leaves), distinct within a row."""
    check_device(sel)
    from scann_torch.ops import library
    return WorkPlan(*library.pruned_plan(
        sel.to(torch.int32).contiguous(), valid_sel.contiguous(), tile_start,
        ntiles, max_ntiles, g_pad))


def _pack(v, a, t):
    """Pack (tile-within-leaf, in-group slot) into the low 9 mantissa bits
    of float32 scores; returns int32."""
    bits = v.view(torch.int32)
    return (bits & ~_ID_MASK) | ((t << _IDX_BITS) | a)


def _unpack(packed):
    """int32 packed -> (value, in-group slot, tile-within-leaf)."""
    arg = packed & _IDX_MASK
    t = (packed >> _IDX_BITS) & _TILE_MASK
    v = (packed & ~_ID_MASK).view(torch.float32)
    return v, arg, t


def _group_top_packed(grouped, t, axis: int, cat_axis: int,
                      kpg: int = KPG):
    """Top-kpg PACKED survivors per SUBP group: each slot's identity
    (tile ``t``, slot in group) is written into its score's low mantissa
    bits first, which makes every value of a group distinct, so each of
    the kpg passes is a max plus an equality mask that removes exactly one
    slot.  Returns int32 survivors stacked on ``cat_axis``."""
    shape = [1] * grouped.dim()
    shape[axis] = grouped.shape[axis]
    sub_iota = _arange(grouped.shape[axis], grouped.device).reshape(shape)
    ident = (torch.as_tensor(t, dtype=torch.int32, device=grouped.device)
             << _IDX_BITS) | sub_iota
    pv = ((grouped.contiguous().view(torch.int32) & ~_ID_MASK)
          | ident).view(torch.float32)
    outs = []
    for _ in range(kpg):
        m = torch.amax(pv, dim=axis)
        outs.append(m)
        pv = torch.where(pv == m.unsqueeze(axis), float("-inf"), pv)
    return torch.cat(outs, dim=cat_axis).view(torch.int32)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def score_work_torch(plan: WorkPlan, qg_rows, rows3, bias, *,
                     measure_l2: bool, kpg: int = KPG,
                     work_chunk: int = _WORK_CHUNK):
    """Plain torch version of the K2 scorer (twin of the JAX package's
    score_work_xla).  qg_rows: (G_pad, QG, d) bf16 gathered query groups;
    rows3: (num_tiles, TILE, d) bf16 decoded rows; bias: (num_tiles,
    TILE[, 1]) f32 (-||x_hat||^2 under squared L2, the pad penalty on dead
    slots).  ``s = scale * (rows . q) + bias`` with scale 2 under squared
    L2, then the packed top-kpg of every 32-slot group.  The bf16 x bf16
    products are exact in f32 but their sum is order-dependent, so values
    agree with the kernel and with the JAX package to ~2^-14 relative, not
    bit for bit.  Computes inactive items too (never read)."""
    w_pad = plan.work_tile.shape[0]
    mnt = w_pad // plan.qg_query.shape[0]
    scale = 2.0 if measure_l2 else 1.0
    bias2 = bias.reshape(bias.shape[0], -1)
    dev = rows3.device
    out = torch.empty((w_pad, QG, kpg * GP), dtype=torch.int32, device=dev)
    wi = torch.arange(w_pad, dtype=torch.int32, device=dev) % mnt
    for s0 in range(0, w_pad, work_chunk):
        wt = plan.work_tile[s0:s0 + work_chunk].long()
        wq = plan.work_qg[s0:s0 + work_chunk].long()
        c = wt.shape[0]
        s = torch.bmm(rows3[wt].float(), qg_rows[wq].float().transpose(1, 2))
        s = scale * s + bias2[wt][:, :, None]
        g = s.reshape(c, GP, SUBP, QG)
        packed = _group_top_packed(g, wi[s0:s0 + c, None, None, None],
                                   axis=2, cat_axis=1, kpg=kpg)
        out[s0:s0 + c] = packed.transpose(1, 2)
    g = w_pad // mnt
    return (out.reshape(g, mnt, QG, kpg * GP).transpose(1, 2)
            .reshape(g, QG, mnt * kpg * GP))


_RAW_ROW_BYTES = {"int8": 32, "bf16": 80, "codes": 32}


def tile_smem_bytes(rows: str, kpg: int) -> int:
    """Dynamic shared memory of one block of csrc/tile_mma.cuh for the
    staged ``rows`` of K1 ("int8"), K2 ("bf16") or K4 ("codes"): the bias
    plane of its 256-slot slab (and K1's scale or K4's squared-norm
    plane), then a 4-stage ring of 32-dimension chunks (the slab's raw
    rows: int8 in 32 bytes, bf16 in 80, or 32 bytes of codes; 64 queries,
    bf16 in 80-byte rows; K4's 32 mean values) and K1's or K4's chunk
    converted to bf16, which the staged survivors (64 queries x kpg x 8
    groups) reuse.  The dimension axis streams, so d_pad does not
    enter."""
    converted = rows != "bf16"
    ring = 4 * (256 * _RAW_ROW_BYTES[rows] + QG // 2 * 80
                + (32 * 4 if rows == "codes" else 0)) \
        + (256 * 80 if converted else 0)
    stage = QG // 2 * (kpg * 8 + 4) * 4
    return 256 * 4 * (2 if converted else 1) + max(ring, stage)


def check_device(t):
    """Raise ValueError unless ``t`` lies on the CPU (plain versions) or a
    CUDA device (the kernels)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def score_work(plan: WorkPlan, qg_rows, rows3, bias, *, measure_l2: bool,
               kpg: int = KPG):
    """K2 scorer, the custom op ``pruned_rows_score`` (ops/library.py).
    CPU tensors run the plain version; CUDA tensors launch the CUDA kernel
    (or raise: there is no fallback on the GPU)."""
    check_device(rows3)
    from scann_torch.ops import library
    return library.pruned_rows_score(
        plan.work_tile, plan.work_qg, plan.work_active, qg_rows, rows3, bias,
        plan.qg_query.shape[0], measure_l2, kpg)


def merge_candidates(plan: WorkPlan, packed, sel, valid_sel, tile_start,
                     ntiles, max_ntiles: int, k_fetch: int,
                     pair_bias=None, hot: int = HOT_LEAVES,
                     tile: int = TILE):
    """Per-query candidates from packed work outputs, then exact top-k.

    packed: (G_pad, QG, mnt*kpg*gp) int32.  The ``hot`` best-ranked leaves
    of each query read their full survivor lists; colder leaves first
    collapse their tiles by a float max (each packed float carries its
    identity, so the max needs no argmax) and read one gp-wide slice.
    Inactive segments of ``packed`` are never read unmasked, so whatever
    they hold cannot change the result.  Returns (vals (B, k), slots (B,
    k)) with slot = tile * tile_size + offset; dead candidates are -inf
    and -1.  pair_bias: optional (B, L) per-(query, leaf) additive term."""
    b, l = sel.shape
    dev = packed.device
    g_pad = plan.qg_query.shape[0]
    kgp = packed.shape[-1] // max_ntiles
    gp = tile // SUBP
    hot = min(hot, l)
    t_iota = _arange(max_ntiles, dev)
    sel_l = sel.long()

    def finish(vals, arg, t, sel_s, cols):
        tile0 = tile_start[sel_s][:, :, None, None]
        slots = (tile0 + t) * tile \
            + (_arange(arg.shape[-1], dev) % gp) * SUBP + arg
        if pair_bias is not None:
            vals = vals + pair_bias[:, cols][:, :, None, None]
        return vals.reshape(b, -1), slots.reshape(b, -1)

    gid = plan.pair_gid.long()
    prow = plan.pair_row.long()
    sel_h = sel_l[:, :hot]
    live_h = ((t_iota[None, None, :] < ntiles[sel_h][:, :, None])
              & valid_sel[:, :hot, None])
    cand_h = packed[gid[:, :hot], prow[:, :hot]].reshape(
        b, hot, max_ntiles, kgp)
    v_h, a_h, t_h = _unpack(cand_h)
    v_h = torch.where(live_h[..., None], v_h, float("-inf"))
    cand_vals, slots = finish(v_h, a_h, t_h, sel_h, slice(0, hot))

    if hot < l:
        cold = packed.reshape(g_pad, QG, max_ntiles, kgp)[..., :gp]
        cold_f = cold.contiguous().view(torch.float32)
        act = plan.work_active.reshape(g_pad, max_ntiles)
        cold_f = torch.where(act[:, None, :, None] == 1, cold_f,
                             float("-inf"))
        cold_red = torch.amax(cold_f, dim=2)          # (g_pad, QG, gp)
        cand_c = cold_red[gid[:, hot:], prow[:, hot:]]
        v_c, a_c, t_c = _unpack(cand_c.view(torch.int32))
        v_c = torch.where(valid_sel[:, hot:, None] & torch.isfinite(v_c),
                          v_c, float("-inf"))[:, :, None, :]
        v2, s2 = finish(v_c, a_c[:, :, None, :], t_c[:, :, None, :],
                        sel_l[:, hot:], slice(hot, l))
        cand_vals = torch.cat([cand_vals, v2], dim=-1)
        slots = torch.cat([slots, s2], dim=-1)
    k = min(k_fetch, cand_vals.shape[-1])
    # Exact everywhere: the JAX package switches to approx_max_k at k >= 32
    # on wide rows; torch has none (ROADMAP section 3).
    top_vals, pos = topk_ops.top_k(cand_vals, k)
    top_slots = torch.gather(slots, -1, pos.long())
    dead = top_vals < -1e20
    top_slots = torch.where(dead, -1, top_slots)
    top_vals = torch.where(dead, float("-inf"), top_vals)
    return top_vals, top_slots


# ------------------------------------------------------------ fused merge
# merge_candidates is built from gathers of whole survivor rows.  The fused
# merge instead reduces every (QG, w) packed row of every work group to its
# top-k (selection key, tile) in one kernel (K6), and the per-pair assembly
# gathers k-wide slices.  Selection is exact for k_fetch <= _FUSED_MAX_K:
# a query's global top-k_fetch holds at most k_fetch candidates of any one
# (query, leaf) pair, and within a pair the reduction is a true top-k.
#
# The selection key keeps bits [31..9] of the packed value as they are and
# rewrites the 9 identity bits from (tile, slot) to (group, slot), so key
# order refines the order merge_candidates ranks by (values with the
# identity bits cleared).  The tile travels beside the key and is recovered
# per pass by a second maximum over the winner mask: keys are unique per
# column up to the tile, equal keys are equal-scored candidates of
# different tiles, taken one per pass, largest tile first.

_FUSED_MAX_K = 32  # selection passes per row; wider budgets take
# merge_candidates
# 0xFF000000 = -2^127: finite with a zero mantissa, so identity bits OR'd
# into it can never form a NaN.
_BIG_NEG_F = float(np.int32(-(1 << 24)).view(np.float32))


def fused_merge_enabled(k_fetch: int) -> bool:
    """Merge policy, read at call time: the fused merge is off unless
    k_fetch <= _FUSED_MAX_K and SCANN_TORCH_FUSED_MERGE=1.  Both merges'
    times on the card are recorded in PERF.md; turn the default only with
    a test."""
    return (k_fetch <= _FUSED_MAX_K
            and os.environ.get("SCANN_TORCH_FUSED_MERGE", "0") == "1")


def _fused_rewrite(bits, col, nt1, valid1, gp_bits: int, kgp_bits: int):
    """Selection keys of packed rows.  bits (r, w) int32; col (1, w) or
    (r, w) int32 column index; nt1 / valid1 broadcastable (r, 1): the
    leaf's tile count and the pair's validity.  Columns of tiles >= nt1
    and of invalid pairs become -2^127.  Returns (pv (r, w) f32 keys,
    t_col int32 tile-within-leaf of each column)."""
    assert gp_bits <= _TILE_BITS, gp_bits
    col = col.to(torch.int32)
    t_col = col >> kgp_bits
    g = col & ((1 << gp_bits) - 1)
    ident = (g << _IDX_BITS) | (bits & _IDX_MASK)
    live = (t_col < nt1) & (valid1 != 0)
    key = ((bits & ~_ID_MASK) | ident).view(torch.float32)
    big_neg = torch.tensor(_BIG_NEG_F, dtype=torch.float32,
                           device=bits.device)
    return torch.where(live, key, big_neg), t_col.expand(bits.shape)


def _fused_passes(pv, t_col, k: int):
    """k selection passes over keyed rows: the largest key, the largest
    tile among the columns that hold it, and that one column set to
    -2^127.  Returns (m_bits (r, k) int32 selected keys, t_sel (r, k)
    int32)."""
    ms, ts = [], []
    for _ in range(k):
        m = torch.amax(pv, dim=1, keepdim=True)
        win = pv == m
        t_win = torch.amax(torch.where(win, t_col, -1), dim=1, keepdim=True)
        pv = torch.where(win & (t_col == t_win), _BIG_NEG_F, pv)
        ms.append(m.view(torch.int32))
        ts.append(t_win)
    return torch.cat(ms, dim=1), torch.cat(ts, dim=1)


def _fused_emit(m_bits, t_sel, base1, bias1, gp_bits: int, tile: int):
    """(value, slot) of selected keys m_bits and tiles t_sel (r, k):
    values are the packed scores with the identity bits cleared (what
    merge_candidates unpacks) plus the pair bias; base1 (r, 1) is the
    leaf's first slot."""
    dead = m_bits.view(torch.float32) == _BIG_NEG_F
    v = (m_bits & ~_ID_MASK).view(torch.float32)
    vals = torch.where(dead, float("-inf"), v + bias1)
    g = (m_bits >> _IDX_BITS) & ((1 << gp_bits) - 1)
    arg = m_bits & _IDX_MASK
    slots = torch.where(dead, -1, base1 + t_sel * tile + g * SUBP + arg)
    return vals, slots


def _bits(n: int) -> int:
    return n.bit_length() - 1


def merge_groups_torch(packed, qg_nt, *, kgp: int, tile: int, k: int,
                       group_chunk: int = 64):
    """Plain torch version of the K6 kernel (twin of the JAX package's
    merge_groups_pallas): every row of every group's (QG, w) packed block
    reduced to its top-k (key, tile).  Integer and compare work only, so
    the kernel is bit-equal to it."""
    g_pad, qg, w = packed.shape
    gp_bits, kgp_bits = _bits(tile // SUBP), _bits(kgp)
    col = _arange(w, packed.device)[None, :]
    mb = torch.empty((g_pad, qg, k), dtype=torch.int32, device=packed.device)
    ts = torch.empty_like(mb)
    for g0 in range(0, g_pad, group_chunk):
        bits = packed[g0:g0 + group_chunk].reshape(-1, w)
        nt1 = qg_nt[g0:g0 + group_chunk].repeat_interleave(qg)[:, None]
        pv, t_col = _fused_rewrite(bits, col, nt1, 1, gp_bits, kgp_bits)
        m, t = _fused_passes(pv, t_col, k)
        mb[g0:g0 + group_chunk] = m.reshape(-1, qg, k)
        ts[g0:g0 + group_chunk] = t.reshape(-1, qg, k)
    return mb, ts


def merge_groups(packed, qg_nt, *, kgp: int, tile: int, k: int):
    """K6, the group-major fused merge, the custom op ``merge_groups``
    (ops/library.py).  packed (g_pad, QG, w) int32; qg_nt (g_pad,) int32
    tile count of each group's leaf (any valid count for dead groups:
    their rows are never addressed).  Returns (m_bits, t_sel), each
    (g_pad, QG, k) int32.  CPU tensors run the plain version; CUDA tensors
    launch the CUDA kernel (or raise)."""
    check_device(packed)
    from scann_torch.ops import library
    return library.merge_groups(packed, qg_nt, kgp, tile, k)


_PAIR_CHUNK = 4096


def merge_pairs_torch(packed2, flat_idx, nt1, tile01, bias1, valid1, *,
                      kgp: int, tile: int, k: int):
    """Pair-major plain version of the fused merge (twin of the JAX
    package's merge_pairs_xla): gathers the packed row of each (query,
    leaf) pair and runs the same selection passes, so only addressed rows
    are reduced.  packed2 (g_pad*QG, w); flat_idx (P,) row of each pair;
    nt1 / tile01 / bias1 / valid1 (P, 1).  Returns (vals, slots) (P, k)."""
    gp_bits, kgp_bits = _bits(tile // SUBP), _bits(kgp)
    col = _arange(packed2.shape[1], packed2.device)[None, :]
    ms, ts = [], []
    for p0 in range(0, flat_idx.shape[0], _PAIR_CHUNK):
        cs = slice(p0, p0 + _PAIR_CHUNK)
        pv, t_col = _fused_rewrite(packed2[flat_idx[cs].long()], col,
                                   nt1[cs], valid1[cs], gp_bits, kgp_bits)
        m, t = _fused_passes(pv, t_col, k)
        ms.append(m)
        ts.append(t)
    return _fused_emit(torch.cat(ms), torch.cat(ts), tile01 * tile, bias1,
                       gp_bits, tile)


def merge_pairs_groups(plan: WorkPlan, packed, ntiles, flat_idx, tile01,
                       bias1, valid1, *, kgp: int, tile: int, k: int):
    """Group-major route of the fused merge: every row of every group
    reduced through merge_groups (K6), then a k-wide gather per (query,
    leaf) pair.  Same operands and result as merge_pairs_torch, bit for
    bit, with the whole (g_pad, QG, w) block in place of gathered rows."""
    # The kernel's outputs are addressed only at live (group, row)
    # coordinates: dead groups get a clamped but valid tile count, and
    # invalid pairs are masked after the gather.
    qg_nt = ntiles[torch.clamp(plan.qg_leaf, 0,
                               ntiles.shape[0] - 1).long()].to(
                                   torch.int32).contiguous()
    mb, ts = merge_groups(packed, qg_nt, kgp=kgp, tile=tile, k=k)
    flat_c = torch.clamp(flat_idx, 0, mb.shape[0] * mb.shape[1] - 1).long()
    vals, slots = _fused_emit(
        mb.reshape(-1, k)[flat_c], ts.reshape(-1, k)[flat_c], tile01 * tile,
        bias1, _bits(tile // SUBP), tile)
    return (torch.where(valid1 != 0, vals, float("-inf")),
            torch.where(valid1 != 0, slots, -1))


def fused_pair_operands(plan: WorkPlan, sel, valid_sel, tile_start, ntiles,
                        pair_bias=None):
    """Per-pair operands of the fused merge, each (P, 1) but the first:
    (flat_idx (P,) packed row of each pair, nt1 tile count of its leaf,
    tile01 first tile of its leaf, bias1 pair bias, valid1 validity)."""
    sel_l = sel.long()
    flat = (plan.pair_gid * QG + plan.pair_row).reshape(-1)
    nt1 = ntiles[sel_l].reshape(-1, 1).to(torch.int32)
    t01 = tile_start[sel_l].reshape(-1, 1).to(torch.int32)
    if pair_bias is not None:
        bias1 = pair_bias.float().reshape(-1, 1)
    else:
        bias1 = torch.zeros((sel.numel(), 1), dtype=torch.float32,
                            device=sel.device)
    return flat, nt1, t01, bias1, valid_sel.reshape(-1, 1).to(torch.int32)


def merge_candidates_fused(plan: WorkPlan, packed, sel, valid_sel,
                           tile_start, ntiles, max_ntiles: int,
                           k_fetch: int, pair_bias=None, tile: int = TILE):
    """Drop-in replacement for merge_candidates on small budgets (k_fetch
    <= _FUSED_MAX_K): every pair reduced to its top-k, no hot / cold
    strata, exact global selection, and a final top-k over L*k-wide rows.
    CUDA tensors take the group-major route (merge_pairs_groups, K6); CPU
    tensors gather each pair's row first (merge_pairs_torch), which
    reduces only addressed rows.  Both give the same result bit for bit."""
    b, l = sel.shape
    w = packed.shape[-1]
    kgp = w // max_ntiles
    k = min(k_fetch, w)
    flat, nt1, t01, bias1, valid1 = fused_pair_operands(
        plan, sel, valid_sel, tile_start, ntiles, pair_bias)
    if packed.device.type == "cpu":
        vals, slots = merge_pairs_torch(
            packed.reshape(-1, w), flat, nt1, t01, bias1, valid1, kgp=kgp,
            tile=tile, k=k)
    else:
        vals, slots = merge_pairs_groups(
            plan, packed, ntiles, flat, t01, bias1, valid1, kgp=kgp,
            tile=tile, k=k)
    vals = vals.reshape(b, l * k)
    slots = slots.reshape(b, l * k)
    top_vals, pos = topk_ops.top_k(vals, min(k_fetch, l * k))
    return top_vals, torch.gather(slots, -1, pos.long())


# ------------------------------------------------- the shared pruned stages
class PrunedLayout(NamedTuple):
    """A pruned engine's tile-major slot layout, built once per layout."""
    tile_start: torch.Tensor  # (num_leaves,) int32 first tile of each leaf
    ntiles: torch.Tensor      # (num_leaves,) int32 tiles of each leaf
    max_ntiles: int
    num_tiles: int
    dpid: torch.Tensor        # (tiles * tile,) int32 datapoint id, -1 pad
    bias: torch.Tensor        # (tiles, tile, 1) f32 per-slot bias plane
    tile: int                 # slots per tile: TILE, or 256 in tree-SQ


def fits(layout: PrunedLayout, nq: int, leaves: int) -> bool:
    """True when the plan stays within MAX_PLAN_WORK items (read at call
    time); larger plans take the dense masked scan."""
    num_leaves = layout.ntiles.shape[0]
    _, w_pad = plan_capacities(nq, min(leaves, num_leaves), num_leaves,
                               layout.num_tiles, layout.max_ntiles)
    return w_pad <= MAX_PLAN_WORK


def plan_batch(layout: PrunedLayout, sel, valid_sel, restrict=None):
    """(plan, bias plane, hot leaves) of (B, L) selections: invert_small
    and an all-hot merge (the full-survivor gather is tiny) at B * L <=
    QG, else work_plan.  An allowlist folds into the bias plane, so
    disallowed slots never take survivor capacity."""
    b, l = sel.shape
    hot = HOT_LEAVES
    if b * l <= QG:
        plan = invert_small(sel, valid_sel, layout.tile_start, layout.ntiles,
                            layout.max_ntiles)
        hot = l
    else:
        g_pad, _ = plan_capacities(b, l, layout.ntiles.shape[0],
                                   layout.num_tiles, layout.max_ntiles)
        plan = work_plan(sel, valid_sel, layout.tile_start, layout.ntiles,
                         layout.max_ntiles, g_pad)
    bias = layout.bias
    if restrict is not None:
        dp = layout.dpid
        allow = restrict[torch.clamp(dp, 0, restrict.shape[0] - 1).long()]
        allow = allow & (dp >= 0)
        bias = bias + torch.where(allow.reshape(bias.shape), 0.0,
                                  _PAD_PENALTY)
    return plan, bias, hot


def candidates(layout: PrunedLayout, plan: WorkPlan, packed, sel, valid_sel,
               k_fetch: int, pair_bias, hot: int, q_l2=None):
    """Each query's best ``k_fetch`` (values, datapoint ids; -inf and -1
    dead) through the merge fused_merge_enabled picks.  Under squared L2
    ``q_l2`` holds the queries the scorer took, whose -||q||^2 is
    restored so the values are negated squared distances."""
    if fused_merge_enabled(k_fetch):
        vals, slots = merge_candidates_fused(
            plan, packed, sel, valid_sel, layout.tile_start, layout.ntiles,
            layout.max_ntiles, k_fetch, pair_bias=pair_bias,
            tile=layout.tile)
    else:
        vals, slots = merge_candidates(
            plan, packed, sel, valid_sel, layout.tile_start, layout.ntiles,
            layout.max_ntiles, k_fetch, pair_bias=pair_bias, hot=hot,
            tile=layout.tile)
    dpids = torch.where(slots >= 0,
                        layout.dpid[torch.clamp_min(slots, 0).long()], -1)
    if q_l2 is not None:
        vals = vals - (q_l2 * q_l2).sum(-1)[:, None]
    return vals, dpids


def build_layout_host(leaf: np.ndarray, num_leaves: int, seed: int = 0,
                      tile: int = TILE):
    """Host-side tile-major layout (numpy, same seed and order as the JAX
    package): returns (order, tile_start, ntiles, num_tiles) where
    ``order`` lists source slot indices in tile-major order with -1 for
    intra-leaf padding.  Slots are grouped by leaf, randomly permuted within
    the leaf (the group-max collision contract), and each leaf padded to a
    multiple of ``tile``; empty leaves keep one padded tile."""
    rng = np.random.default_rng(seed)
    order_by_leaf = np.argsort(leaf, kind="stable")
    counts = np.bincount(leaf, minlength=num_leaves)
    ntiles = np.maximum(1, -(-counts // tile)).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    num_tiles = int(ntiles.sum())
    order = np.full((num_tiles * tile,), -1, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for lf in range(num_leaves):
        members = order_by_leaf[starts[lf]:starts[lf] + counts[lf]]
        if len(members) > 1:
            members = members[rng.permutation(len(members))]
        base = tile_start[lf] * tile
        order[base:base + len(members)] = members
    return order, tile_start, ntiles, num_tiles
