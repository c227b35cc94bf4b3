"""Pruned (leaf-gathered) scoring: work plan, packed survivors, merge.

Port of the plan, merge and layout parts of scann_tpu/ops/pruned_scan.py
(the scorer itself lives in ops/pruned_sq.py).  Slots are sorted by leaf,
each leaf padded to a multiple of the tile size, and the (query, leaf)
selections of a batch are inverted into leaf-major work items: item
``w = group * max_ntiles + t`` scores tile ``t`` of one query group's leaf
for up to ``QG`` queries.  Each scorer keeps the top ``kpg`` of every
``SUBP``-slot group with its (tile, slot) identity packed into the low 9
mantissa bits, and ``merge_candidates`` turns those survivors into each
query's top-k.

Shapes, constants and path boundaries are the JAX package's, unchanged, so
both packages take the same path on the same batch; the arithmetic is
plain torch.
"""

from __future__ import annotations

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

_SENTINEL = 1 << 30
_ID_BITS = _IDX_BITS + _TILE_BITS
_ID_MASK = (1 << _ID_BITS) - 1


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
