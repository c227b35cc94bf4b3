"""Tree-X searcher: partitioning + exact leaf scoring (port of
scann_tpu/models/tree_x.py).

Two layouts, as in the JAX package:

* residual per-row int8 leaves (tree-SQ, ``score_brute_force("int8")``
  with more than one leaf): rows are stored as x = c_leaf + scale_row *
  int8[d], tile-major per leaf (256-slot tiles), and a batch scores only
  its selected leaves through the pruned path: tokenize -> plan
  (pruned_scan.work_plan) -> score (K1, ops/pruned_sq.py) -> merge
  (pruned_scan.merge_candidates, which adds the exact f32 q.c_leaf per
  pair).  Plans over MAX_PLAN_WORK items and the full scan run the dense
  masked scan over every slot instead.
* dense leaf-sorted rows for everything else: float32 or bfloat16 leaves,
  a single-leaf tree, and int8 leaves whose partition outgrew the pruned
  tile budget (global per-dimension int8 multipliers, ops/quantize.py).
  Every search is the dense masked scan: all rows scored chunk by chunk
  for the batch, masked by each query's selected leaves.  Plain torch: no
  Pallas kernel of the JAX package is involved.

Typed (int8 / uint8) input rows stay 1 B a dimension through the build:
sampling, tokenization, splits and the residual int8 encode cast what
they gather, and float32-mode dense leaves are stored as bfloat16, which
holds every int8 / uint8 value exactly.  With a projection the index is
built on the projected rows.

A ``reorder`` rescores the best candidates exactly (models/base.py); its
residual int8 rows take the final primary tokens and the centers.  Both
layouts search the caller's leaves when a batch names them, and mask the
tokenizer's selection by query spilling.  SOAR and AVQ apply to tree-AH:
Tree-X builds the index it builds without them, as the JAX package does.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from scann_torch import config as cfg
from scann_torch.models import base
from scann_torch.ops import pruned_scan
from scann_torch.ops import pruned_sq
from scann_torch.ops import quantize as quant_ops
from scann_torch.ops import topk as topk_ops
from scann_torch.partitioning import kmeans_tree
from scann_torch.utils import profiling

_SCORE_CHUNK = 65536   # slots per chunk of the dense masked scan
_ENCODE_CHUNK = 131072
_DENSE_QUERY_BLOCK = 2048  # queries per block of the dense scan (bounds
# the (queries, chunk) f32 intermediates)
_SQ_TILE = 256          # slots per leaf tile of the tree-SQ layout
_PAD_PENALTY = -1e30    # bias of padded / disallowed slots

_log = logging.getLogger("scann_torch")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class TreeXSearcher(base.Searcher):
    """Partitioned exact scoring (tree + score_brute_force)."""

    def __init__(self, database: np.ndarray, scann_config: cfg.ScannConfig,
                 device: torch.device, docids=None):
        super().__init__(database, scann_config, device, docids)
        self.part_cfg = scann_config.partitioning
        self.measure = cfg.internal_measure(scann_config.distance_measure)
        self.quantize_mode = scann_config.brute_force.quantize
        self._sq_mode = False
        self._inv_mult = None
        self._build()

    def _build(self):
        x_dev = self._project_database(self._build_x_dev)
        n = x_dev.shape[0]
        unused = [name for name, value in (("soar_lambda", self.part_cfg.soar),
                                           ("avq", self.part_cfg.avq))
                  if value is not None]
        if unused:
            # The JAX package's Tree-X reads neither: the index is the one
            # built without them.
            _log.warning("Tree-X ignores the partitioning setting(s) %s: "
                         "they apply to score_ah", ", ".join(unused))
        with profiling.phase("partition"):
            self.partitioner = kmeans_tree.KMeansTreePartitioner.train(
                x_dev, self.part_cfg, self.measure, self.config.seed)
            tokens = self.partitioner.tokenize_database(x_dev).cpu().numpy()
            tree_sq = (self.quantize_mode == cfg.INT8
                       and self.partitioner.num_leaves > 1)
            if tree_sq:
                # Max-size bound per partition for the pruned scorer
                # (MAX_NTILES tiles per leaf): split oversized partitions,
                # retokenize against the grown center set, split again, then
                # cap what is left.
                nl = self.part_cfg.num_leaves
                hard_cap = pruned_scan.MAX_NTILES * _SQ_TILE
                cap = int(min(hard_cap, max(2.0 * n / max(nl, 1), _SQ_TILE)))
                centers_np = self.partitioner.centers.cpu().numpy()
                tokens, grown = kmeans_tree.split_oversized(x_dev, tokens,
                                                            centers_np, cap)
                if grown.shape[0] != centers_np.shape[0]:
                    centers_np = grown
                    self._register_centers(centers_np)
                    tokens = self.partitioner.tokenize_database(
                        x_dev).cpu().numpy()
                    tokens, grown = kmeans_tree.split_oversized(
                        x_dev, tokens, centers_np, cap)
                    if grown.shape[0] != centers_np.shape[0]:
                        centers_np = grown
                        self._register_centers(centers_np)
                counts = np.bincount(tokens, minlength=centers_np.shape[0])
                if counts.max() > hard_cap:
                    tokens = kmeans_tree.cap_partition_sizes(
                        x_dev, tokens, centers_np, hard_cap)
        self._finish_deferred_reorder(x_dev, tokens)
        self.datapoint_to_token = tokens[:, None]
        if not (tree_sq and self._build_sq(x_dev, tokens)):
            # Dense leaf-sorted rows; int8 leaves whose layout the pruned
            # scorer declines take global int8 multipliers.
            self._build_dense(x_dev, tokens)
        self._build_x_dev = None

    def _build_dense(self, x_dev, tokens):
        """Leaf-sorted rows for the dense masked scan, padded to a multiple
        of its chunk (padding: dpid -1)."""
        with profiling.phase("layout"):
            n = x_dev.shape[0]
            order = np.argsort(tokens, kind="stable")
            self._num_slots = n
            chunk = _SCORE_CHUNK if n >= _SCORE_CHUNK else _round_up(n, 128)
            self._chunk = chunk
            s_pad = _round_up(n, chunk)
            dev = self.device
            # Typed float32-mode leaves: bfloat16 holds int8 / uint8 exactly.
            typed = (x_dev.dtype in (torch.int8, torch.uint8)
                     and self.quantize_mode == cfg.FLOAT32)
            rows = torch.zeros(
                (s_pad, x_dev.shape[1]),
                dtype=torch.bfloat16 if typed else torch.float32, device=dev)
            rows[:n] = x_dev[torch.from_numpy(order).to(dev)]
            leaf = np.zeros((s_pad,), np.int32)
            leaf[:n] = tokens[order]
            dpid = np.full((s_pad,), -1, np.int32)
            dpid[:n] = order
            self.slot_leaf = torch.from_numpy(leaf).to(dev)
            self.slot_dpid = torch.from_numpy(dpid).to(dev)
        self._inv_mult = None
        self._sq_norms = None
        with profiling.phase("quantize"):
            if typed:
                self.slot_rows = rows
                if self.measure == cfg.SQUARED_L2:
                    self._sq_norms = (rows.float() ** 2).sum(-1)
            elif self.quantize_mode == cfg.INT8:
                sq = quant_ops.scalar_quantize(rows)
                self.slot_rows = sq.data
                self._inv_mult = sq.inverse_multipliers
                self._sq_norms = sq.sq_norms
            elif self.quantize_mode == cfg.BFLOAT16:
                self.slot_rows = quant_ops.bfloat16_quantize(rows)
                self._sq_norms = (rows * rows).sum(-1)
            else:
                self.slot_rows = rows
                if self.measure == cfg.SQUARED_L2:
                    self._sq_norms = (rows * rows).sum(-1)

    def _build_sq(self, x_dev, tokens) -> bool:
        """Tile-major residual per-row int8 leaves.  Returns False when a
        leaf outgrew the scorer's tile budget."""
        num_leaves = self.partitioner.num_leaves
        with profiling.phase("layout"):
            order, tile_start, ntiles, num_tiles = \
                pruned_scan.build_layout_host(
                    tokens.astype(np.int64), num_leaves,
                    seed=self.config.seed, tile=_SQ_TILE)
            if int(ntiles.max()) > pruned_scan.MAX_NTILES:
                return False
            # Pad the tile count so the dense scan's chunk divides the slot
            # count; the extra tiles lie past every leaf (dpid -1).
            chunk_tiles = min(_SCORE_CHUNK // _SQ_TILE,
                              _round_up(num_tiles, 8))
            total_tiles = _round_up(num_tiles, chunk_tiles)
            s_pad = total_tiles * _SQ_TILE
            src = np.full((s_pad,), -1, np.int64)
            src[:order.shape[0]] = order
            leaf = np.where(src >= 0, tokens[np.maximum(src, 0)], 0
                            ).astype(np.int32)
            dpid = np.where(src >= 0, src, -1).astype(np.int32)

        with profiling.phase("quantize"):
            d = x_dev.shape[1]
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
            bias = torch.where(dpid_t >= 0,
                               -sq if l2 else torch.zeros_like(sq),
                               _PAD_PENALTY)
        self.slot_rows = rows.reshape(total_tiles, _SQ_TILE, d_pad)
        self.slot_scale = scale.reshape(total_tiles, _SQ_TILE, 1)
        self._bias2 = bias.reshape(total_tiles, _SQ_TILE, 1)
        self._sq_norms = sq if l2 else None
        self._inv_mult = None
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
                           full_scan: bool = False, restrict=None,
                           pre_tokenized=None):
        """``pre_tokenized``: optional (q, L) int32 leaves to search per
        query in place of the tokenizer's, -1 entries unused."""
        num_leaves = self.partitioner.num_leaves
        if self._sq_mode and not full_scan and leaves < num_leaves:
            _, w_pad = pruned_scan.plan_capacities(
                queries.shape[0], min(leaves, num_leaves), num_leaves,
                self._p_num_tiles, self._p_max_ntiles)
            if w_pad <= pruned_scan.MAX_PLAN_WORK:
                return self._pruned_select(queries, k_pre, leaves, restrict,
                                           pre_tokenized)
        return self._dense_select(queries, k_pre, leaves, restrict,
                                  pre_tokenized)

    def _dense_select(self, queries, k_pre, leaves, restrict,
                      pre_tokenized=None):
        """Masked scan over every slot (the dense layouts' every search; in
        tree-SQ the full scan and plans over the work budget).  Per slot:
        tree-SQ sim = scale * (q_bf16 . int8) + q.c_leaf (dot), or
        2 q.x_hat - ||x_hat||^2 - ||q||^2 (squared L2); dense rows
        sim = q' . x (dot), or -(||q||^2 - 2 q'.x + ||x||^2), with q' the
        query times the int8 multipliers, or rounded to bf16, or as it is
        for float32 rows."""
        with profiling.span("tokenize"):
            nq = queries.shape[0]
            num_leaves = self.partitioner.num_leaves
            leaves = max(1, min(leaves, num_leaves))
            dev = queries.device
            if (pre_tokenized is None and leaves >= num_leaves
                    and self.partitioner.query_spilling_type
                    == "fixed_number"):
                mask_dense = torch.ones((nq, num_leaves), dtype=torch.bool,
                                        device=dev)
            else:
                leaf_ids, keep, _ = self.partitioner.select_leaves(
                    queries, leaves, pre_tokenized)
                # Unused entries scatter to a spare column past the last leaf.
                mask_dense = torch.zeros((nq, num_leaves + 1),
                                         dtype=torch.bool, device=dev)
                mask_dense.scatter_(1, torch.where(keep, leaf_ids,
                                                   num_leaves).long(), True)
                mask_dense = mask_dense[:, :num_leaves]
            self._stage("tokenize")
        with profiling.span("scan"):
            rows = self.slot_rows.reshape(-1, self.slot_rows.shape[-1])
            leaf_all = self.slot_leaf.long()
            dpid_all = self.slot_dpid
            q_sq = (queries * queries).sum(-1)
            sq_res = self._sq_mode
            if sq_res:
                scale_flat = self.slot_scale.reshape(-1)
                q_op = torch.nn.functional.pad(
                    queries, (0, rows.shape[1] - queries.shape[1])).to(
                        torch.bfloat16).float()
                q_c = queries @ self.partitioner.centers.T   # (nq, num_leaves)
            elif self._inv_mult is not None:
                q_op = queries * self._inv_mult[None, :]
            elif rows.dtype == torch.bfloat16:
                q_op = queries.to(torch.bfloat16).float()
            else:
                q_op = queries
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
                    dots = q_op[qb] @ rows[cs].float().T
                    if sq_res:
                        qx = (dots * scale_flat[cs][None, :]
                              + q_c[qb][:, leaf_c])
                        sim = (qx if self.measure == cfg.DOT_PRODUCT else
                               2.0 * qx - self._sq_norms[cs][None, :]
                               - q_sq[qb][:, None])
                    elif self.measure == cfg.DOT_PRODUCT:
                        sim = dots
                    else:
                        sim = -(q_sq[qb][:, None] - 2.0 * dots
                                + self._sq_norms[cs][None, :])
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

    def _pruned_select(self, queries, k_pre: int, leaves: int, restrict,
                       pre_tokenized=None):
        """Leaf-gathered exact selection through the K1 scorer."""
        with profiling.span("tokenize"):
            partitioner = self.partitioner
            num_leaves = partitioner.num_leaves
            leaves = max(1, min(leaves, num_leaves))
            nq = queries.shape[0]
            leaf_ids, valid_sel, _ = partitioner.select_leaves(
                queries, leaves, pre_tokenized)
            # Exact f32 q.c_leaf of the f32 centers joins per (query, leaf) at
            # merge time, whatever tokenized the query (int8 centers, an upper
            # tree or the caller).
            c_sel = partitioner.centers[leaf_ids.long()]       # (nq, L, d)
            pair_bias = torch.bmm(c_sel, queries[:, :, None])[:, :, 0]
            l2 = self.measure == cfg.SQUARED_L2
            if l2:
                pair_bias = 2.0 * pair_bias
            self._stage("tokenize")

        with profiling.span("plan"):
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
                g_pad, _ = pruned_scan.plan_capacities(
                    nq, leaves, num_leaves, self._p_num_tiles,
                    self._p_max_ntiles)
                plan = pruned_scan.work_plan(
                    leaf_ids, valid_sel, self._p_tile_start, self._p_ntiles,
                    self._p_max_ntiles, g_pad)
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
        with profiling.span("score"):
            packed = pruned_sq.score_work_sq(
                plan, qg_rows, self.slot_rows, self.slot_scale, bias2,
                measure_l2=l2, kpg=kpg)
            self._stage("score")
        with profiling.span("merge"):
            tile = self.slot_rows.shape[1]
            if pruned_scan.fused_merge_enabled(k_fetch):
                cand_vals, cand_slots = pruned_scan.merge_candidates_fused(
                    plan, packed, leaf_ids, valid_sel, self._p_tile_start,
                    self._p_ntiles, self._p_max_ntiles, k_fetch,
                    pair_bias=pair_bias, tile=tile)
            else:
                cand_vals, cand_slots = pruned_scan.merge_candidates(
                    plan, packed, leaf_ids, valid_sel, self._p_tile_start,
                    self._p_ntiles, self._p_max_ntiles, k_fetch,
                    pair_bias=pair_bias, hot=merge_hot, tile=tile)
            dpids = torch.where(
                cand_slots >= 0,
                self.slot_dpid[torch.clamp_min(cand_slots, 0).long()], -1)
            if l2:
                # Restore the rank-invariant -||q||^2 (true squared distances).
                cand_vals = cand_vals - (queries * queries).sum(-1)[:, None]
            self._stage("merge")
        return cand_vals, dpids
