"""Tree-X searcher with residual per-row int8 leaves (tree-SQ).

Port of the residual-int8 mode of scann_tpu/models/tree_x.py: rows are
stored as x = c_leaf + scale_row * int8[d], tile-major per leaf (256-slot
tiles), and a batch scores only its selected leaves through the pruned
path: tokenize -> plan (pruned_scan.invert) -> score (K1,
ops/pruned_sq.py) -> merge (pruned_scan.merge_candidates, which adds the
exact f32 q.c_leaf per pair).  Plans over MAX_PLAN_WORK items and the full
scan run the dense masked scan over every slot instead.  Float32 / bf16 /
global-int8 leaves are not ported yet (ROADMAP item 21).
"""

from __future__ import annotations

import numpy as np
import torch

from scann_torch import config as cfg
from scann_torch.models import base
from scann_torch.ops import pruned_scan
from scann_torch.ops import pruned_sq
from scann_torch.ops import topk as topk_ops
from scann_torch.partitioning import kmeans_tree

_SCORE_CHUNK = 65536   # slots per chunk of the dense masked scan
_ENCODE_CHUNK = 131072
_DENSE_QUERY_BLOCK = 2048  # queries per block of the dense scan (bounds
# the (queries, chunk) f32 intermediates)
_SQ_TILE = 256          # slots per leaf tile of the tree-SQ layout
_PAD_PENALTY = -1e30    # bias of padded / disallowed slots


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class TreeXSearcher(base.Searcher):
    """Partitioned exact scoring (tree + score_brute_force(int8))."""

    def __init__(self, database: np.ndarray, scann_config: cfg.ScannConfig,
                 device: torch.device):
        super().__init__(database, scann_config, device)
        self.part_cfg = scann_config.partitioning
        self.measure = cfg.internal_measure(scann_config.distance_measure)
        self.quantize_mode = scann_config.brute_force.quantize
        self._sq_mode = False
        self._build()

    def _build(self):
        x_dev = self._build_x_dev
        n = x_dev.shape[0]
        self.partitioner = kmeans_tree.KMeansTreePartitioner.train(
            x_dev, self.part_cfg, self.measure, self.config.seed)
        tokens = self.partitioner.tokenize_database(x_dev).cpu().numpy()
        if self.quantize_mode != cfg.INT8 or self.partitioner.num_leaves <= 1:
            base.not_ported("Tree-X float32/bfloat16/global-int8 leaves", 21)
        # Max-size bound per partition for the pruned scorer (MAX_NTILES
        # tiles per leaf): split oversized partitions, retokenize against
        # the grown center set, split again, then cap what is left.
        nl = self.part_cfg.num_leaves
        hard_cap = pruned_scan.MAX_NTILES * _SQ_TILE
        cap = int(min(hard_cap, max(2.0 * n / max(nl, 1), _SQ_TILE)))
        centers_np = self.partitioner.centers.cpu().numpy()
        tokens, grown = kmeans_tree.split_oversized(x_dev, tokens,
                                                    centers_np, cap)
        if grown.shape[0] != centers_np.shape[0]:
            centers_np = grown
            self._register_centers(centers_np)
            tokens = self.partitioner.tokenize_database(x_dev).cpu().numpy()
            tokens, grown = kmeans_tree.split_oversized(x_dev, tokens,
                                                        centers_np, cap)
            if grown.shape[0] != centers_np.shape[0]:
                centers_np = grown
                self._register_centers(centers_np)
        counts = np.bincount(tokens, minlength=centers_np.shape[0])
        if counts.max() > hard_cap:
            tokens = kmeans_tree.cap_partition_sizes(x_dev, tokens,
                                                     centers_np, hard_cap)
        self.datapoint_to_token = tokens[:, None]
        if not self._build_sq(x_dev, tokens):
            base.not_ported("Tree-X leaves over the pruned tile budget "
                             "(dense global-int8 layout)", 21)
        self._build_x_dev = None

    def _build_sq(self, x_dev, tokens) -> bool:
        """Tile-major residual per-row int8 leaves.  Returns False when a
        leaf outgrew the scorer's tile budget."""
        num_leaves = self.partitioner.num_leaves
        order, tile_start, ntiles, num_tiles = pruned_scan.build_layout_host(
            tokens.astype(np.int64), num_leaves, seed=self.config.seed,
            tile=_SQ_TILE)
        if int(ntiles.max()) > pruned_scan.MAX_NTILES:
            return False
        # Pad the tile count so the dense scan's chunk divides the slot
        # count; the extra tiles lie past every leaf (dpid -1).
        chunk_tiles = min(_SCORE_CHUNK // _SQ_TILE, _round_up(num_tiles, 8))
        total_tiles = _round_up(num_tiles, chunk_tiles)
        s_pad = total_tiles * _SQ_TILE
        src = np.full((s_pad,), -1, np.int64)
        src[:order.shape[0]] = order
        leaf = np.where(src >= 0, tokens[np.maximum(src, 0)], 0
                        ).astype(np.int32)
        dpid = np.where(src >= 0, src, -1).astype(np.int32)

        d = self.dims
        d_pad = _round_up(d, 8)
        l2 = self.measure == cfg.SQUARED_L2
        dev = self.device
        centers = self.partitioner.centers
        src_t = torch.from_numpy(src).to(dev)
        leaf_t = torch.from_numpy(leaf).to(dev)
        rows = torch.zeros((s_pad, d_pad), dtype=torch.int8, device=dev)
        scale = torch.empty((s_pad,), dtype=torch.float32, device=dev)
        sq = torch.empty((s_pad,), dtype=torch.float32, device=dev)
        for s0 in range(0, s_pad, _ENCODE_CHUNK):
            src_c = src_t[s0:s0 + _ENCODE_CHUNK]
            xs = x_dev[torch.clamp_min(src_c, 0)].float()
            crows = centers[leaf_t[s0:s0 + _ENCODE_CHUNK].long()]
            delta = torch.where((src_c >= 0)[:, None], xs - crows, 0.0)
            q8, sc = base._row_quantize(delta)
            deq = q8.float() * sc[:, None] + crows
            rows[s0:s0 + _ENCODE_CHUNK, :d] = q8
            scale[s0:s0 + _ENCODE_CHUNK] = sc
            sq[s0:s0 + _ENCODE_CHUNK] = (deq * deq).sum(-1)
        dpid_t = torch.from_numpy(dpid).to(dev)
        bias = torch.where(dpid_t >= 0, -sq if l2 else torch.zeros_like(sq),
                           _PAD_PENALTY)
        self.slot_rows = rows.reshape(total_tiles, _SQ_TILE, d_pad)
        self.slot_scale = scale.reshape(total_tiles, _SQ_TILE, 1)
        self._bias2 = bias.reshape(total_tiles, _SQ_TILE, 1)
        self._sq_norms = sq if l2 else None
        self.slot_leaf = leaf_t
        self.slot_dpid = dpid_t
        self._p_tile_start = torch.from_numpy(tile_start).to(dev)
        self._p_ntiles = torch.from_numpy(ntiles).to(dev)
        self._p_max_ntiles = int(ntiles.max())
        self._p_num_tiles = num_tiles
        self._num_slots = int((dpid >= 0).sum())
        self._chunk = chunk_tiles * _SQ_TILE
        self._sq_mode = True
        return True

    @property
    def _pruned_available(self) -> bool:
        return self._sq_mode

    def _default_leaves(self) -> int:
        return self.part_cfg.num_leaves_to_search

    def _select_candidates(self, queries, k_pre: int, leaves: int,
                           full_scan: bool = False, restrict=None):
        num_leaves = self.partitioner.num_leaves
        if not full_scan and leaves < num_leaves:
            _, w_pad = pruned_scan.plan_capacities(
                queries.shape[0], min(leaves, num_leaves), num_leaves,
                self._p_num_tiles, self._p_max_ntiles)
            if w_pad <= pruned_scan.MAX_PLAN_WORK:
                return self._pruned_select(queries, k_pre, leaves, restrict)
        return self._dense_select(queries, k_pre, leaves, full_scan,
                                  restrict)

    def _dense_select(self, queries, k_pre, leaves, full_scan, restrict):
        """Masked scan over every slot (full scan, or plans over the work
        budget): per slot sim = scale * (q_bf16 . int8) + q.c_leaf (dot),
        or 2 q.x_hat - ||x_hat||^2 - ||q||^2 (squared L2)."""
        nq = queries.shape[0]
        num_leaves = self.partitioner.num_leaves
        leaves = max(1, min(leaves, num_leaves))
        dev = queries.device
        if full_scan or leaves >= num_leaves:
            mask_dense = torch.ones((nq, num_leaves), dtype=torch.bool,
                                    device=dev)
        else:
            leaf_ids, _ = self.partitioner.tokenize_queries(queries, leaves)
            mask_dense = torch.zeros((nq, num_leaves), dtype=torch.bool,
                                     device=dev)
            mask_dense.scatter_(1, leaf_ids.long(), True)
        self._stage("tokenize")
        d_pad = self.slot_rows.shape[-1]
        rows = self.slot_rows.reshape(-1, d_pad)
        scale_flat = self.slot_scale.reshape(-1)
        leaf_all = self.slot_leaf.long()
        dpid_all = self.slot_dpid
        q_bf = torch.nn.functional.pad(
            queries, (0, d_pad - queries.shape[1])).to(torch.bfloat16).float()
        q_c = queries @ self.partitioner.centers.T     # (nq, num_leaves)
        q_sq = (queries * queries).sum(-1)
        chunk = self._chunk
        k_fetch = min(k_pre, dpid_all.shape[0])
        out_v, out_s = [], []
        for b0 in range(0, nq, _DENSE_QUERY_BLOCK):
            qb = slice(b0, b0 + _DENSE_QUERY_BLOCK)
            vals = slots = None
            for start in range(0, rows.shape[0], chunk):
                cs = slice(start, start + chunk)
                leaf_c = leaf_all[cs]
                dpid_c = dpid_all[cs]
                dots = q_bf[qb] @ rows[cs].float().T
                qx = dots * scale_flat[cs][None, :] + q_c[qb][:, leaf_c]
                if self.measure == cfg.DOT_PRODUCT:
                    sim = qx
                else:
                    sim = (2.0 * qx - self._sq_norms[cs][None, :]
                           - q_sq[qb][:, None])
                valid = (dpid_c >= 0)[None, :] & mask_dense[qb][:, leaf_c]
                if restrict is not None:
                    allow = restrict[torch.clamp(
                        dpid_c, 0, restrict.shape[0] - 1).long()]
                    valid = valid & allow[None, :]
                cvals, cpos = topk_ops.chunk_top_k(
                    sim, min(k_fetch, chunk), valid=valid)
                cslot = torch.where(cpos >= 0, start + cpos, -1)
                if vals is None:
                    vals, slots = cvals, cslot
                else:
                    vals, slots = topk_ops.merge_top_k(vals, slots, cvals,
                                                       cslot, k_fetch)
            out_v.append(vals)
            out_s.append(slots)
        vals, slots = torch.cat(out_v), torch.cat(out_s)
        self._stage("scan")
        dpids = torch.where(slots >= 0,
                            dpid_all[torch.clamp_min(slots, 0).long()], -1)
        return vals, dpids

    def _pruned_select(self, queries, k_pre: int, leaves: int, restrict):
        """Leaf-gathered exact selection through the K1 scorer."""
        partitioner = self.partitioner
        num_leaves = partitioner.num_leaves
        leaves = max(1, min(leaves, num_leaves))
        nq = queries.shape[0]
        leaf_ids, c_sims = partitioner.tokenize_queries(queries, leaves)
        valid_sel = partitioner.spilling_mask(c_sims)
        # Exact f32 q.c_leaf joins per (query, leaf) at merge time.
        c_sel = partitioner.centers[leaf_ids.long()]       # (nq, L, d)
        pair_bias = torch.bmm(c_sel, queries[:, :, None])[:, :, 0]
        l2 = self.measure == cfg.SQUARED_L2
        if l2:
            pair_bias = 2.0 * pair_bias
        self._stage("tokenize")

        d_pad = self.slot_rows.shape[-1]
        q_bf = torch.nn.functional.pad(
            queries, (0, d_pad - queries.shape[1])).to(torch.bfloat16)
        merge_hot = pruned_scan.HOT_LEAVES
        if nq * leaves <= pruned_scan.QG:
            plan = pruned_scan.invert_small(
                leaf_ids, valid_sel, self._p_tile_start, self._p_ntiles,
                self._p_max_ntiles)
            merge_hot = leaves
        else:
            g_pad, w_pad = pruned_scan.plan_capacities(
                nq, leaves, num_leaves, self._p_num_tiles,
                self._p_max_ntiles)
            plan = pruned_scan.invert(
                leaf_ids, valid_sel, self._p_tile_start, self._p_ntiles,
                self._p_max_ntiles, g_pad, w_pad)
        bias2 = self._bias2
        if restrict is not None:
            # Allowlists fold into the per-slot bias plane.
            dp = self.slot_dpid
            allow = restrict[torch.clamp(dp, 0,
                                         restrict.shape[0] - 1).long()]
            allow = allow & (dp >= 0)
            bias2 = bias2 + torch.where(allow.reshape(bias2.shape), 0.0,
                                        _PAD_PENALTY)
        qg_rows = q_bf[plan.qg_query.long()]
        k_fetch = min(k_pre, self.slot_dpid.shape[0])
        # kpg=4 keeps the in-group collision loss under ~1e-3 at k=10.
        kpg = 4 if k_fetch <= 64 else 8
        self._stage("plan")
        packed = pruned_sq.score_work_sq(
            plan, qg_rows, self.slot_rows, self.slot_scale, bias2,
            measure_l2=l2, kpg=kpg)
        self._stage("score")
        cand_vals, cand_slots = pruned_scan.merge_candidates(
            plan, packed, leaf_ids, valid_sel, self._p_tile_start,
            self._p_ntiles, self._p_max_ntiles, k_fetch,
            pair_bias=pair_bias, hot=merge_hot, tile=self.slot_rows.shape[1])
        dpids = torch.where(
            cand_slots >= 0,
            self.slot_dpid[torch.clamp_min(cand_slots, 0).long()], -1)
        if l2:
            # Restore the rank-invariant -||q||^2 (true squared distances).
            cand_vals = cand_vals - (queries * queries).sum(-1)[:, None]
        self._stage("merge")
        return cand_vals, dpids
