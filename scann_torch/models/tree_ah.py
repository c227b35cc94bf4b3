"""Tree-AH searcher: partition + asymmetric-hashing scoring + reorder.

Port of the product-quantization, int8 / float32 lookup modes of
scann_tpu/models/tree_ah.py.  Rows are stored as AH codes of the residual
x - c_leaf (dot product) or of x (squared L2), 16 or 256 centers per
block.  A batch scores only its selected leaves through the pruned path:
tokenize -> plan (pruned_scan.invert) -> score (K3, the int8-LUT scorer
over pair-packed 4-bit codes, or K4, the decode scorer, for float32
lookup and 256 centers; ops/pruned_lut.py) -> merge
(pruned_scan.merge_candidates, which adds q.c_leaf per pair under residual
quantization).  Plans over MAX_PLAN_WORK items and the full scan run the
dense masked LUT16 scan over every slot (ops/lut16.py).  The base class
then reorders the best candidates exactly.

Not ported yet (each raises NotImplementedError): lookup_type
"reconstruct", stacked quantization, variable chunks, SOAR, AVQ, mutation,
projection and the non-partitioned searcher.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from scann_torch import config as cfg
from scann_torch.models import base
from scann_torch.ops import ah as ah_ops
from scann_torch.ops import kmeans as kmeans_ops
from scann_torch.ops import lut16 as lut16_ops
from scann_torch.ops import pruned_lut
from scann_torch.ops import pruned_scan
from scann_torch.ops import topk as topk_ops
from scann_torch.partitioning import kmeans_tree
from scann_torch.utils import native

_SCORE_CHUNK = 65536    # slots per chunk of the dense masked scan
_ENCODE_CHUNK = 32768   # rows per encoding chunk (bounds the (chunk, B, J)
# residual-stats arrays)
_DENSE_QUERY_BLOCK = 2048  # queries per block of the dense scan
_PAD_PENALTY = -1e30    # bias of padded / disallowed slots

_log = logging.getLogger("scann_torch")


class TreeAHIndex(NamedTuple):
    """Index arrays in the leaf-sorted slot layout of the dense scan."""
    codes: Optional[torch.Tensor]  # (S, B) uint8, uploaded on first dense use
    slot_dpid: torch.Tensor        # (S,) int32, -1 padding
    slot_leaf: torch.Tensor        # (S,) int32, 0 for padding


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def check_supported(scann_config: cfg.ScannConfig):
    """Raise NotImplementedError for the tree-AH settings not ported yet."""
    ah = scann_config.asymmetric_hash
    if ah.lookup_type == "reconstruct":
        base.not_ported("lookup_type='reconstruct' (kernels K2 and K5)", 13)
    if ah.quantization_scheme == "stacked":
        base.not_ported("stacked quantization", 16)
    if ah.variable_dims_per_block is not None:
        base.not_ported("variable_dims_per_block", 16)
    if ah.lookup_type not in (cfg.INT8, cfg.FLOAT32):
        raise ValueError(f"unknown lookup_type {ah.lookup_type!r}")
    if ah.clusters_per_block not in (16, 256):
        raise ValueError("hash_type must be lut16 or lut256")
    if (scann_config.partitioning is None
            or scann_config.partitioning.num_leaves <= 1):
        base.not_ported("the non-partitioned AH searcher", 13)
    ro = scann_config.reordering
    if ro is not None and ro.quantize == cfg.INT8 and not ro.residual:
        base.not_ported("non-residual int8 reordering", 12)


class TreeAHSearcher(base.Searcher):
    """Partitioned asymmetric-hashing searcher."""

    def __init__(self, database: np.ndarray, scann_config: cfg.ScannConfig,
                 device: torch.device):
        check_supported(scann_config)
        super().__init__(database, scann_config, device)
        self._init_config(scann_config)
        self._build()
        self._build_x_dev = None

    def _init_config(self, scann_config):
        self.part_cfg = scann_config.partitioning
        self.ah_cfg = scann_config.asymmetric_hash
        self.measure = cfg.internal_measure(scann_config.distance_measure)
        self.residual = bool(self.ah_cfg.residual_quantization)
        if self.residual and self.measure != cfg.DOT_PRODUCT:
            raise ValueError("residual quantization requires dot product "
                             "distance")
        self._kpg_override = None   # tests force a survivor width with it
        self._recon_mean = None

    # ------------------------------------------------------------- build
    def _build(self):
        x_dev = self._build_x_dev
        n, d = x_dev.shape
        seed = self.config.seed
        self.partitioner = kmeans_tree.KMeansTreePartitioner.train(
            x_dev, self.part_cfg, self.measure, seed)
        # Max-size bound per partition for the pruned scorers (MAX_NTILES
        # tiles per leaf): split oversized partitions, retokenize against
        # the grown center set, split again, then cap what is left.
        nl = self.part_cfg.num_leaves
        hard_cap = pruned_scan.MAX_NTILES * pruned_scan.TILE
        cap = int(min(hard_cap, max(2.0 * n / max(nl, 1), pruned_scan.TILE)))
        tokens = self.partitioner.tokenize_database(x_dev).cpu().numpy()
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
        tokens = np.asarray(tokens, np.int32)
        # Residual int8 reordering waits for the final primary tokens: its
        # q.c_leaf bias must match the centers the residuals are taken
        # against.
        self._finish_deferred_reorder(x_dev, tokens)
        self.datapoint_to_token = tokens[:, None]

        tokens_t = torch.from_numpy(tokens).to(self.device).long()
        if self.residual:
            primary_vecs = x_dev - self.partitioner.centers[tokens_t]
        else:
            primary_vecs = x_dev

        gen = torch.Generator().manual_seed(seed + 1)
        sample_idx = kmeans_ops.sample_rows(
            gen, n, self.ah_cfg.training_sample_size)
        self.model = ah_ops.train_ah_model(
            gen, primary_vecs[sample_idx.to(self.device)],
            self.ah_cfg.dimensions_per_block,
            self.ah_cfg.clusters_per_block,
            self.ah_cfg.training_iterations, dims=d)
        codes = self._encode_dataset(primary_vecs, x_dev)
        self.index = self._layout_slots(codes, tokens,
                                        np.arange(n, dtype=np.int32))
        self._invalidate_pruned()

    def _encode_dataset(self, vectors, originals) -> np.ndarray:
        """Encode all vectors in fixed-size chunks; also keeps the mean
        squared quantization error over the encoded slots."""
        threshold = self.ah_cfg.anisotropic_quantization_threshold
        noise_shaped = not math.isnan(threshold)
        out = []
        err_sum = 0.0
        for s0 in range(0, vectors.shape[0], _ENCODE_CHUNK):
            v = vectors[s0:s0 + _ENCODE_CHUNK].float()
            if noise_shaped:
                codes = ah_ops.encode_noise_shaped(
                    v, originals[s0:s0 + _ENCODE_CHUNK].float(), self.model,
                    threshold)
            else:
                codes = ah_ops.encode(v, self.model)
            recon = ah_ops.reconstruct(codes, self.model)
            err_sum += float(((v - recon) ** 2).sum())
            out.append(codes.cpu().numpy())
        self._encoded_slots = vectors.shape[0]
        self._quantization_error_sq = err_sum / max(vectors.shape[0], 1)
        return np.concatenate(out, axis=0)

    def _layout_slots(self, codes: np.ndarray, leaf: np.ndarray,
                      dpid: np.ndarray) -> TreeAHIndex:
        """Sort slots by leaf and pad to a chunk multiple (the layout of
        the dense scan and of the serialized index).  The device copy of
        the codes is made when a dense query first arrives: pruned
        queries read the tile-major layout instead."""
        order, _ = native.sort_by_leaf(leaf, self.partitioner.num_leaves)
        codes = native.gather_rows_i8(codes, order)
        leaf = leaf[order]
        dpid = dpid[order]
        s = codes.shape[0]
        self._num_slots = s
        chunk = _SCORE_CHUNK if s >= _SCORE_CHUNK else _round_up(s, 128)
        self._chunk = chunk
        pad = _round_up(s, chunk) - s
        if pad:
            codes = np.pad(codes, ((0, pad), (0, 0)))
            leaf = np.pad(leaf, (0, pad))
            dpid = np.pad(dpid, (0, pad), constant_values=-1)
        self._host = {"codes": codes, "leaf": leaf.astype(np.int32),
                      "dpid": dpid.astype(np.int32)}
        return TreeAHIndex(
            codes=None,
            slot_dpid=torch.from_numpy(self._host["dpid"]).to(self.device),
            slot_leaf=torch.from_numpy(self._host["leaf"]).to(self.device))

    def _ensure_dense_codes(self):
        if self.index.codes is None:
            self.index = self.index._replace(
                codes=torch.from_numpy(self._host["codes"]).to(self.device))

    # -------------------------------------------------- pruned leaf layout
    @property
    def _pruned_available(self) -> bool:
        return self.partitioner.num_leaves > 1

    @property
    def _int8_lut(self) -> bool:
        """True when the pruned path takes K3 (int8 lookup over 4-bit
        codes); float32 lookup and 256-center codes take K4."""
        return (self.ah_cfg.lookup_type == cfg.INT8
                and self.ah_cfg.clusters_per_block == 16)

    def _invalidate_pruned(self):
        self._p_bias = None
        self._p_codes = None
        self._p_cb = None
        self._p_csq = None
        self._p_mean = None
        self._p_dpid = None
        self._p_tile_start = None
        self._p_ntiles = None
        self._p_max_ntiles = 0
        self._p_num_tiles = 0

    def _decode_mean(self):
        """Mean of the decoded bf16 rows over live slots (squared L2 only:
        rows and queries are centered on it before the bf16 cast, since L2
        is translation-invariant and the neighbor gaps are tiny next to
        the uncentered products).  A function of the codes alone, so a
        reloaded index reproduces it."""
        h = self._host
        total = np.zeros((self.dims,), np.float64)
        for s in range(0, h["codes"].shape[0], _ENCODE_CHUNK):
            codes = torch.from_numpy(h["codes"][s:s + _ENCODE_CHUNK]).to(
                self.device)
            live = torch.from_numpy(h["dpid"][s:s + _ENCODE_CHUNK] >= 0).to(
                self.device)
            r = ah_ops.reconstruct(codes, self.model)
            r = torch.where(live[:, None], r, 0.0).to(torch.bfloat16)
            total += r.float().sum(0).double().cpu().numpy()
        count = int((h["dpid"] >= 0).sum())
        mean = (total / max(count, 1)).astype(np.float32)
        return torch.from_numpy(mean).to(self.device)

    def _ensure_pruned(self):
        """Build the tile-major per-leaf code layout of the pruned scorers
        on first use: pair-packed 4-bit codes for K3, one byte per block
        (255 = padding) for K4, plus the scorer's compact codebook table
        (centered, with its squared norms, for K3), the pad-penalty bias
        plane and the mean."""
        if self._p_codes is not None:
            return
        h = self._host
        live = np.nonzero(h["dpid"] >= 0)[0]
        order, tile_start, ntiles, num_tiles = pruned_scan.build_layout_host(
            h["leaf"][live].astype(np.int64), self.partitioner.num_leaves,
            seed=self.config.seed)
        if int(ntiles.max()) > pruned_scan.MAX_NTILES:
            _log.warning("pruned layout disabled: max leaf needs %d tiles "
                         "(> %d)", int(ntiles.max()), pruned_scan.MAX_NTILES)
            return
        # order indexes into `live`; -1 entries are intra-leaf padding.
        src = np.where(order >= 0, live[np.maximum(order, 0)], -1)
        dpid = np.where(src >= 0, h["dpid"][np.maximum(src, 0)], -1)
        dev = self.device
        if self.measure == cfg.SQUARED_L2 and self._recon_mean is None:
            self._recon_mean = self._decode_mean()
        dpb = self.model.dims_per_block
        b_pad = _round_up(self.model.num_blocks, pruned_lut._BLK)
        d_pad = b_pad * dpb
        rows = h["codes"][np.maximum(src, 0)]
        if self._int8_lut:
            codes3 = pruned_lut.pack_codes_nibble(
                np.where((src >= 0)[:, None], rows, 0).astype(np.uint8),
                num_tiles)
        else:
            codes3 = pruned_lut.pack_codes_tiles(
                np.where((src >= 0)[:, None], rows,
                         pruned_lut._PAD_CODE).astype(np.uint8), num_tiles)
        bias = np.where(dpid >= 0, 0.0, _PAD_PENALTY).astype(np.float32)
        self._p_bias = torch.from_numpy(
            bias.reshape(num_tiles, pruned_scan.TILE, 1)).to(dev)
        mean = torch.zeros((d_pad,), dtype=torch.float32, device=dev)
        if self._recon_mean is not None:
            mean[:self._recon_mean.shape[0]] = self._recon_mean
        self._p_mean = mean
        codebook = self.model.codebook.to(dev)
        if self._int8_lut:
            self._p_cb, self._p_csq = pruned_lut.lut_tables(
                codebook, mean, b_pad,
                measure_l2=self.measure == cfg.SQUARED_L2)
        else:
            self._p_cb = pruned_lut.codes_table(codebook, b_pad)
        self._p_dpid = torch.from_numpy(dpid.astype(np.int32)).to(dev)
        self._p_tile_start = torch.from_numpy(tile_start).to(dev)
        self._p_ntiles = torch.from_numpy(ntiles).to(dev)
        self._p_max_ntiles = int(ntiles.max())
        self._p_num_tiles = num_tiles
        self._p_codes = torch.from_numpy(codes3).to(dev)

    # ------------------------------------------------------------- query
    def _default_leaves(self) -> int:
        return self.part_cfg.num_leaves_to_search

    def _prepare_for_query(self, nq: int, leaves: int,
                           full_scan: bool) -> bool:
        """Materialize the layout this batch will read; True when it takes
        the pruned path (leaf-gathered queries whose plan fits the work
        budget), False for the dense masked scan."""
        num_leaves = self.partitioner.num_leaves
        if not full_scan and leaves < num_leaves:
            self._ensure_pruned()
            if self._p_codes is not None:
                _, w_pad = pruned_scan.plan_capacities(
                    nq, min(leaves, num_leaves), num_leaves,
                    self._p_num_tiles, self._p_max_ntiles)
                if w_pad <= pruned_scan.MAX_PLAN_WORK:
                    return True
        self._ensure_dense_codes()
        return False

    def _select_candidates(self, queries, k_pre: int, leaves: int,
                           full_scan: bool = False, restrict=None):
        if self._prepare_for_query(queries.shape[0], leaves, full_scan):
            return self._pruned_select(queries, k_pre, leaves, restrict)
        return self._dense_select(queries, k_pre, leaves, full_scan,
                                  restrict)

    def _dense_select(self, queries, k_pre, leaves, full_scan, restrict):
        """Masked LUT16 scan over every slot (full scan, or plans over the
        work budget).  The LUTs here are quantized per query with each
        block centered on its midpoint (ah.quantize_luts), unlike K3's."""
        nq = queries.shape[0]
        num_leaves = self.partitioner.num_leaves
        dev = queries.device
        luts = ah_ops.build_luts(queries, self.model, self.measure,
                                 self.ah_cfg.lookup_type)
        leaves = num_leaves if full_scan else max(1, min(leaves, num_leaves))
        leaf_ids, center_sims = self.partitioner.tokenize_queries(queries,
                                                                  leaves)
        # One (query, leaf) table: -inf for unselected leaves, else the
        # q.c_leaf bias under residual quantization (0 otherwise).
        vals = (center_sims if self.residual
                else torch.zeros_like(center_sims))
        combo = torch.full((nq, num_leaves), float("-inf"), device=dev)
        combo.scatter_(1, leaf_ids.long(), vals)
        self._stage("tokenize")

        codes_all = self.index.codes
        leaf_all = self.index.slot_leaf.long()
        dpid_all = self.index.slot_dpid
        cpb = self.ah_cfg.clusters_per_block
        chunk = self._chunk
        k_fetch = min(k_pre, dpid_all.shape[0])
        lut_flat = lut16_ops.lut_matrix(luts)
        inv_mult = luts.inv_multiplier if luts.int8 is not None else None
        blocks = range(0, nq, _DENSE_QUERY_BLOCK)
        state = [None] * len(blocks)
        for start in range(0, dpid_all.shape[0], chunk):
            cs = slice(start, start + chunk)
            leaf_c, dpid_c = leaf_all[cs], dpid_all[cs]
            oh = lut16_ops.one_hot_codes(codes_all[cs], cpb)
            valid = (dpid_c >= 0)[None, :]
            if restrict is not None:
                allow = restrict[torch.clamp(
                    dpid_c, 0, restrict.shape[0] - 1).long()]
                valid = valid & allow[None, :]
            for bi, b0 in enumerate(blocks):
                qb = slice(b0, b0 + _DENSE_QUERY_BLOCK)
                sim = lut16_ops.score_one_hot(
                    oh, lut_flat[qb],
                    None if inv_mult is None else inv_mult[qb])
                sim = sim + combo[qb][:, leaf_c]
                cvals, cpos = topk_ops.chunk_top_k(
                    sim, min(k_fetch, chunk), valid=valid)
                cslot = torch.where(cpos >= 0, start + cpos, -1)
                if state[bi] is not None:
                    cvals, cslot = topk_ops.merge_top_k(
                        *state[bi], cvals, cslot, k_fetch)
                state[bi] = (cvals, cslot)
        vals = torch.cat([s[0] for s in state])
        slots = torch.cat([s[1] for s in state])
        self._stage("scan")
        dpids = torch.where(slots >= 0,
                            dpid_all[torch.clamp_min(slots, 0).long()], -1)
        return vals + luts.base[:, None], dpids

    def _pruned_select(self, queries, k_pre: int, leaves: int, restrict):
        """Leaf-gathered candidate selection through K3 or K4."""
        partitioner = self.partitioner
        num_leaves = partitioner.num_leaves
        leaves = max(1, min(leaves, num_leaves))
        nq = queries.shape[0]
        leaf_ids, center_sims = partitioner.tokenize_queries(queries, leaves)
        valid_sel = partitioner.spilling_mask(center_sims)
        self._stage("tokenize")

        q_c = queries
        if self._recon_mean is not None:
            q_c = queries - self._recon_mean[None, :]
        d_pad = self._p_mean.shape[0]
        q_bf = torch.nn.functional.pad(
            q_c, (0, d_pad - q_c.shape[1])).to(torch.bfloat16)
        merge_hot = pruned_scan.HOT_LEAVES
        if nq * leaves <= pruned_scan.QG:
            # Small-batch fast path: one group per pair, no sorts, and an
            # all-hot merge (the full-survivor gather is tiny).
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
        p_bias = self._p_bias
        if restrict is not None:
            # Allowlists fold into the per-slot bias plane, so disallowed
            # slots never take survivor capacity.
            dp = self._p_dpid
            allow = restrict[torch.clamp(dp, 0,
                                         restrict.shape[0] - 1).long()]
            allow = allow & (dp >= 0)
            p_bias = p_bias + torch.where(allow.reshape(p_bias.shape), 0.0,
                                          _PAD_PENALTY)
        qg_rows = q_bf[plan.qg_query.long()]           # (G_pad, QG, d_pad)
        l2 = self.measure == cfg.SQUARED_L2
        k_fetch = k_pre
        # Survivors per group follow the worst-case density of wanted
        # candidates per 32-slot group; it only binds at small partition
        # counts, where a few big leaves hold a query's whole top-k.
        avg_leaf = max(1, self._num_slots // num_leaves)
        density = k_fetch * pruned_scan.SUBP / avg_leaf
        kpg = 16 if (density > 5.0 and num_leaves < 512) else pruned_scan.KPG
        if self._kpg_override:
            kpg = self._kpg_override
        self._stage("plan")
        if self._int8_lut:
            packed = pruned_lut.score_work_lut(
                plan, qg_rows, self._p_codes, self._p_cb, self._p_csq,
                p_bias, measure_l2=l2, kpg=kpg)
        else:
            packed = pruned_lut.score_work_codes(
                plan, qg_rows, self._p_codes, self._p_cb, self._p_mean,
                p_bias, measure_l2=l2, kpg=kpg)
        self._stage("score")
        cand_vals, cand_slots = pruned_scan.merge_candidates(
            plan, packed, leaf_ids, valid_sel, self._p_tile_start,
            self._p_ntiles, self._p_max_ntiles, k_fetch,
            pair_bias=center_sims if self.residual else None, hot=merge_hot)
        dpids = torch.where(
            cand_slots >= 0,
            self._p_dpid[torch.clamp_min(cand_slots, 0).long()], -1)
        if l2:
            # Restore the rank-invariant -||q||^2 of the centered query.
            cand_vals = cand_vals - (q_c * q_c).sum(-1)[:, None]
        self._stage("merge")
        return cand_vals, dpids
