"""Tree-AH searcher: partition + asymmetric-hashing scoring + reorder.

Port of the product-quantization modes of scann_tpu/models/tree_ah.py.
Rows are stored as AH codes of the residual x - c_leaf (dot product with a
tree) or of x, 16 or 256 centers per block.  A batch scores only its
selected leaves through the pruned path: tokenize -> plan
(pruned_scan.invert) -> score -> merge (pruned_scan.merge_candidates, or
merge_candidates_fused through K6 when fused_merge_enabled says so).  The
scorer follows ``lookup_type``:

* int8 lookup over 4-bit codes: K3, the int8-LUT scorer (ops/pruned_lut.py);
* float32 lookup, and 256 centers per block: K4, the decode scorer
  (ops/pruned_lut.py);
* "reconstruct": the codes are decoded once into bf16 rows x_hat (decoded
  residual plus the leaf center) held in device memory, and K2
  (pruned_scan.score_work) multiplies them with the bf16 query groups.
  The rows already hold the center, so no q.c_leaf term joins at merge
  time.  Slots are laid out in random order, and the full scan runs K5
  (ops/fused_scan.py): one candidate per 256-slot group, then an exact
  top-k over the group winners.

Under residual quantization the LUT modes add q.c_leaf per (query, leaf)
pair at merge time.  Plans over MAX_PLAN_WORK items, restricted full scans
and the LUT modes' full scan run a dense masked scan over every slot
(LUT16 through ops/lut16.py, or a chunked product with the decoded rows).
Without a tree (``partitioning`` None) there is no tokenization, no
residual and no pruned layout: every query is a full scan.  The base class
then reorders the best candidates exactly.

SOAR stores each row twice, in its primary leaf and in a secondary leaf
chosen by orthogonality amplification (2n slots, the primary leaves capped
at half the scorers' tile budget); every selection then keeps
ceil(k_pre * overretrieve_factor) candidates and drops repeated ids
(topk.dedup_candidates) before the best k_pre.  AVQ refits the centers
after tokenization.  A batch may name its leaves (``pre_tokenized``), and
query spilling masks the tokenizer's selection.

Not ported yet (each raises NotImplementedError): stacked quantization,
variable chunks, mutation, projection and a single-leaf tree.  Every
scorer serves every width on the card as on the CPU.
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
from scann_torch.ops import fused_scan
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
_PAD_PENALTY = fused_scan._PAD_PENALTY  # bias of padded / disallowed slots
_GROUP = fused_scan.SUB  # slots per candidate group of the dense recon scan
RECONSTRUCT = "reconstruct"

_log = logging.getLogger("scann_torch")


class TreeAHIndex(NamedTuple):
    """Index arrays in the leaf-sorted slot layout of the dense scan."""
    codes: Optional[torch.Tensor]  # (S, B) uint8, uploaded on first dense use
    slot_dpid: torch.Tensor        # (S,) int32, -1 padding
    slot_leaf: torch.Tensor        # (S,) int32, 0 for padding


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def check_supported(scann_config: cfg.ScannConfig):
    """Raise NotImplementedError for the tree-AH settings not ported
    yet."""
    ah = scann_config.asymmetric_hash
    if ah.quantization_scheme == "stacked":
        base.not_ported("stacked quantization", 16)
    if ah.variable_dims_per_block is not None:
        base.not_ported("variable_dims_per_block", 16)
    if ah.lookup_type not in (cfg.INT8, cfg.FLOAT32, RECONSTRUCT):
        raise ValueError(f"unknown lookup_type {ah.lookup_type!r}")
    if ah.clusters_per_block not in (16, 256):
        raise ValueError("hash_type must be lut16 or lut256")
    if (scann_config.partitioning is not None
            and scann_config.partitioning.num_leaves <= 1):
        base.not_ported("a single-leaf tree under score_ah", 13)


def _slot_chunk(num_slots: int, recon: bool) -> int:
    """Slots a chunk of the dense scan's layout of ``num_slots`` slots;
    the layout pads to a multiple of it.  Small indexes align to the
    fused scan's slot block in reconstruct mode."""
    if num_slots >= _SCORE_CHUNK:
        return _SCORE_CHUNK
    return _round_up(num_slots, fused_scan.BS if recon else 128)


def _takes_k5(num_slots: int, k_pre: int) -> bool:
    """True when an unrestricted reconstruct-mode full scan over
    ``num_slots`` padded slots goes through K5: enough 256-slot groups
    that one candidate a group loses a negligible share of the top
    ``k_pre``."""
    return num_slots // fused_scan.SUB >= 4 * k_pre


def _survivors_per_group(k_fetch: int, num_slots: int,
                         num_leaves: int) -> int:
    """kpg of a pruned search: the worst-case density of wanted candidates
    per 32-slot group; it only binds at small partition counts, where a
    few big leaves hold a query's whole top-k."""
    avg_leaf = max(1, num_slots // num_leaves)
    density = k_fetch * pruned_scan.SUBP / avg_leaf
    return 16 if (density > 5.0 and num_leaves < 512) else pruned_scan.KPG


class TreeAHSearcher(base.Searcher):
    """Asymmetric-hashing searcher, partitioned or not."""

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
        if self.part_cfg is None:
            self.partitioner = None
        if self.residual and self.measure != cfg.DOT_PRODUCT:
            raise ValueError("residual quantization requires dot product "
                             "distance")
        self._kpg_override = None   # tests force a survivor width with it
        self._recon_mean = None

    # ------------------------------------------------------------- build
    @property
    def _soar(self) -> Optional[cfg.SoarConfig]:
        return self.part_cfg.soar if self.part_cfg is not None else None

    def _k_fetch(self, k_pre: int) -> int:
        """Candidates a selection keeps: SOAR over-retrieves by its factor,
        since a row can come back twice before the dedup."""
        soar = self._soar
        if soar is None:
            return k_pre
        return int(math.ceil(k_pre * soar.overretrieve_factor))

    def _dedup(self, vals, dpids, k_pre: int):
        """SOAR: keep each row's best copy, then the best k_pre."""
        if self._soar is None:
            return vals, dpids
        vals, dpids = topk_ops.dedup_candidates(vals, dpids)
        vals, pos = topk_ops.top_k(vals, min(k_pre, vals.shape[-1]))
        return vals, torch.gather(dpids, -1, pos.long())

    def _build(self):
        x_dev = self._build_x_dev
        n, d = x_dev.shape
        seed = self.config.seed
        tokens2 = None
        if self.part_cfg is None:
            tokens = np.zeros((n,), np.int32)
        else:
            tokens, tokens2 = self._train_partition(x_dev)
        self.datapoint_to_token = (tokens2 if tokens2 is not None
                                   else tokens[:, None])

        if self.residual and self.partitioner is not None:
            tokens_t = torch.from_numpy(tokens).to(self.device).long()
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
        self._encoded_slots = 0
        self._quantization_error_sq = 0.0
        codes = self._encode_dataset(primary_vecs, x_dev)
        leaf = tokens
        dpid = np.arange(n, dtype=np.int32)
        if tokens2 is not None:
            # SOAR: each row also lives in its secondary leaf, encoded as
            # the residual against that leaf's center; 2n slots.
            sec = torch.from_numpy(tokens2[:, 1]).to(self.device).long()
            codes = np.concatenate([codes, self._encode_dataset(
                x_dev - self.partitioner.centers[sec], x_dev)])
            leaf = np.concatenate([tokens2[:, 0], tokens2[:, 1]])
            dpid = np.concatenate([dpid, dpid])
        self.index = self._layout_slots(codes, leaf.astype(np.int32), dpid)
        self._build_recon()

    def _train_partition(self, x_dev):
        """Train the tree; return the final primary token of each row and,
        under SOAR, the (n, 2) primary and secondary tokens (else None)."""
        n = x_dev.shape[0]
        part = self.part_cfg
        self.partitioner = kmeans_tree.KMeansTreePartitioner.train(
            x_dev, part, self.measure, self.config.seed)
        if self.partitioner.num_leaves != part.num_leaves:
            # Hierarchical training rounds num_leaves up to k1 * k2.
            self._register_centers(self.partitioner.centers.cpu().numpy())
        # Max-size bound per partition for the pruned scorers (MAX_NTILES
        # tiles per leaf, shared by a row's two slots under SOAR): split
        # oversized partitions, retokenize against the grown center set,
        # split again, then cap what is left.
        soar = self._soar
        soar_mult = 2 if soar is not None else 1
        nl = self.part_cfg.num_leaves
        hard_cap = pruned_scan.MAX_NTILES * pruned_scan.TILE
        cap = int(min(hard_cap // soar_mult,
                      max(2.0 * n / max(nl, 1), pruned_scan.TILE)))
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
        nl = centers_np.shape[0]
        counts = np.bincount(tokens, minlength=nl)
        if counts.max() > hard_cap // soar_mult:
            tokens = kmeans_tree.cap_partition_sizes(
                x_dev, tokens, centers_np, hard_cap // soar_mult)
        tokens2 = None
        if soar is not None:
            tokens2 = self.partitioner.tokenize_database_soar(
                x_dev, soar).cpu().numpy().astype(np.int64)
            tokens2[:, 0] = tokens
            cap_total = int(min(hard_cap, max(4.0 * soar_mult * n / nl,
                                              2 * pruned_scan.TILE)))
            tokens2[:, 1] = kmeans_tree.cap_partition_sizes(
                x_dev, tokens2[:, 1], centers_np, cap_total,
                base_counts=np.bincount(tokens2[:, 0], minlength=nl),
                forbid=tokens2[:, 0])
            tokens2 = tokens2.astype(np.int32)
        if self.part_cfg.avq is not None:
            # AVQ refits the centers after tokenization; residuals are taken
            # against the refit centers.
            max_leaf = int(np.bincount(
                tokens, minlength=self.part_cfg.num_leaves).max())
            self.partitioner = self.partitioner.apply_avq(
                x_dev, tokens, float(self.part_cfg.avq), max(1, max_leaf))
        tokens = np.asarray(tokens, np.int32)
        # Residual int8 reordering waits for the final primary tokens: its
        # q.c_leaf bias must match the centers the residuals are taken
        # against.
        self._finish_deferred_reorder(x_dev, tokens)
        return tokens, tokens2

    def _encode_dataset(self, vectors, originals) -> np.ndarray:
        """Encode all vectors in fixed-size chunks; also keeps the running
        mean squared quantization error over the encoded slots."""
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
        # Running mean over every slot encoded so far (SOAR encodes twice).
        prev = self._quantization_error_sq * self._encoded_slots
        self._encoded_slots += vectors.shape[0]
        self._quantization_error_sq = ((prev + err_sum)
                                       / max(self._encoded_slots, 1))
        return np.concatenate(out, axis=0)

    def _layout_slots(self, codes: np.ndarray, leaf: np.ndarray,
                      dpid: np.ndarray) -> TreeAHIndex:
        """Sort slots by leaf and pad to a chunk multiple (the layout of
        the dense scan and of the serialized index).  Reconstruct mode
        then permutes the slots at random (the same numpy draw as the JAX
        package, so both lay an index out identically): the group-max
        scans need a query's best slots spread over the groups.  The
        device copy of the codes is made when a dense LUT query first
        arrives."""
        num_leaves = (self.partitioner.num_leaves
                      if self.partitioner is not None
                      else (int(leaf.max()) + 1 if len(leaf) else 1))
        order, _ = native.sort_by_leaf(leaf, num_leaves)
        if self._recon_mode:
            order = order[np.random.default_rng(
                self.config.seed).permutation(len(order))]
        codes = native.gather_rows_i8(codes, order)
        leaf = leaf[order]
        dpid = dpid[order]
        s = codes.shape[0]
        self._num_slots = s
        chunk = _slot_chunk(s, self._recon_mode)
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

    # -------------------------------------------------- reconstruct mode
    @property
    def _recon_mode(self) -> bool:
        return self.ah_cfg.lookup_type == RECONSTRUCT

    @property
    def _recon_dim(self) -> int:
        """Feature dimension of the decoded rows: padded to 128."""
        return _round_up(self.dims, 128)

    def _decode_slots(self, codes, slot_leaf, slot_dpid, mean=None):
        """Decode codes into bf16 approximate rows: x_hat = c_leaf +
        recon(codes) under residual quantization, recon(codes) otherwise,
        minus ``mean`` (squared L2: see _decode_mean), zero on dead slots,
        zero-padded to _recon_dim.  Also returns ||x_hat||^2 of the f32
        rows, summed before the bf16 cast."""
        recon = ah_ops.reconstruct(codes, self.model)
        if self.residual and self.partitioner is not None:
            recon = recon + self.partitioner.centers[
                torch.clamp_min(slot_leaf, 0).long()]
        if mean is not None:
            recon = recon - mean[None, :]
        recon = torch.where((slot_dpid >= 0)[:, None], recon, 0.0)
        recon = torch.nn.functional.pad(
            recon, (0, self._recon_dim - recon.shape[1]))
        return recon.to(torch.bfloat16), (recon * recon).sum(-1)

    def _decode_chunks(self, codes, leaf, dpid):
        """_decode_slots over host arrays in chunks; returns the device
        rows (n, _recon_dim) bf16 and their squared norms (n,) f32."""
        rows, sqs = [], []
        for s in range(0, codes.shape[0], _ENCODE_CHUNK):
            up = [torch.from_numpy(np.ascontiguousarray(
                a[s:s + _ENCODE_CHUNK])).to(self.device)
                for a in (codes, leaf, dpid)]
            r, q = self._decode_slots(*up, mean=self._recon_mean)
            rows.append(r)
            sqs.append(q)
        return torch.cat(rows), torch.cat(sqs)

    def _make_bias(self, sq, dpid):
        """Per-slot additive bias of K2 and K5: -||x_hat||^2 under squared
        L2, the pad penalty on empty slots."""
        bias = -sq if self.measure == cfg.SQUARED_L2 else torch.zeros_like(sq)
        return torch.where(dpid >= 0, bias, _PAD_PENALTY)

    def _build_recon(self):
        """Reset every derived layout; in reconstruct mode compute the
        mean and, without a pruned path, the full-scan rows."""
        self._recon_rows = None
        self._recon_sq = None
        self._recon_bias = None
        self._recon_mean = None
        self._invalidate_pruned()
        if not self._recon_mode:
            return
        if self.measure == cfg.SQUARED_L2:
            self._recon_mean = self._decode_mean()
        if self._pruned_available:
            # Partitioned searchers serve from the pruned tile-major rows;
            # the full-scan layout is built when a dense query arrives.
            return
        self._ensure_recon_rows()

    def _ensure_recon_rows(self):
        """Decoded rows in the slot order of the full scan (K5 and the
        dense masked scan of reconstruct mode), built on first use."""
        if self._recon_rows is not None:
            return
        h = self._host
        self._recon_rows, self._recon_sq = self._decode_chunks(
            h["codes"], h["leaf"], h["dpid"])
        self._recon_bias = self._make_bias(self._recon_sq,
                                           self.index.slot_dpid)

    # -------------------------------------------------- pruned leaf layout
    @property
    def _pruned_available(self) -> bool:
        return (self.partitioner is not None
                and self.partitioner.num_leaves > 1)

    @property
    def _int8_lut(self) -> bool:
        """True when the pruned path takes K3 (int8 lookup over 4-bit
        codes); float32 lookup and 256-center codes take K4."""
        return (self.ah_cfg.lookup_type == cfg.INT8
                and self.ah_cfg.clusters_per_block == 16)

    def _invalidate_pruned(self):
        self._p_rows = None
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
        """Build the tile-major per-leaf layout of the pruned scorers on
        first use: decoded bf16 rows and their bias plane (-||x_hat||^2
        under squared L2) for K2; pair-packed 4-bit codes for K3 or one
        byte per block (255 = padding) for K4, plus the scorer's compact
        codebook table (centered, with its squared norms, for K3), the
        pad-penalty bias plane and the mean."""
        if not self._pruned_available or self._pruned_built:
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
        self._p_dpid = torch.from_numpy(dpid.astype(np.int32)).to(dev)
        self._p_tile_start = torch.from_numpy(tile_start).to(dev)
        self._p_ntiles = torch.from_numpy(ntiles).to(dev)
        self._p_max_ntiles = int(ntiles.max())
        self._p_num_tiles = num_tiles
        if self._recon_mode:
            codes = np.where((src >= 0)[:, None],
                             h["codes"][np.maximum(src, 0)], 0).astype(
                                 np.uint8)
            leaf = np.where(src >= 0, h["leaf"][np.maximum(src, 0)], 0)
            rows, sq = self._decode_chunks(codes, leaf.astype(np.int32),
                                           dpid.astype(np.int32))
            self._p_bias = self._make_bias(sq, self._p_dpid).reshape(
                num_tiles, pruned_scan.TILE, 1)
            self._p_rows = rows.reshape(num_tiles, pruned_scan.TILE, -1)
            return
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
        self._p_codes = torch.from_numpy(codes3).to(dev)

    @property
    def _pruned_built(self) -> bool:
        return (self._p_rows if self._recon_mode else self._p_codes) \
            is not None

    # ------------------------------------------------------------- query
    def _default_leaves(self) -> int:
        if self.part_cfg is None:
            return 0
        return self.part_cfg.num_leaves_to_search

    def _prepare_for_query(self, nq: int, leaves: int,
                           full_scan: bool) -> bool:
        """Materialize the layout this batch will read; True when it takes
        the pruned path (leaf-gathered queries whose plan fits the work
        budget), False for a dense path (full scan, no tree, or a plan
        over the budget): the decoded rows in reconstruct mode, the device
        codes otherwise."""
        if (self._pruned_available and not full_scan
                and leaves < self.partitioner.num_leaves):
            num_leaves = self.partitioner.num_leaves
            self._ensure_pruned()
            if self._pruned_built:
                _, w_pad = pruned_scan.plan_capacities(
                    nq, min(leaves, num_leaves), num_leaves,
                    self._p_num_tiles, self._p_max_ntiles)
                if w_pad <= pruned_scan.MAX_PLAN_WORK:
                    return True
        if self._recon_mode:
            self._ensure_recon_rows()
        else:
            self._ensure_dense_codes()
        return False

    def _select_candidates(self, queries, k_pre: int, leaves: int,
                           full_scan: bool = False, restrict=None,
                           pre_tokenized=None):
        """``pre_tokenized``: optional (q, L) int32 leaves to search per
        query in place of the tokenizer's, -1 entries unused."""
        if self._prepare_for_query(queries.shape[0], leaves, full_scan):
            return self._pruned_select(queries, k_pre, leaves, restrict,
                                       pre_tokenized)
        if (self._recon_mode and full_scan and restrict is None
                and _takes_k5(self._recon_rows.shape[0], k_pre)):
            return self._fused_select(queries, k_pre)
        return self._dense_select(queries, k_pre, leaves, full_scan,
                                  restrict, pre_tokenized)

    def _recon_queries(self, queries, d_pad: int):
        """(centered f32 queries, their bf16 copy zero-padded to d_pad)."""
        q_c = queries
        if self._recon_mean is not None:
            q_c = queries - self._recon_mean[None, :]
        q_bf = torch.nn.functional.pad(
            q_c, (0, d_pad - q_c.shape[1])).to(torch.bfloat16)
        return q_c, q_bf

    def _fused_select(self, queries, k_pre: int):
        """Full-scan candidate selection through K5 (ops/fused_scan.py):
        one candidate per 256-slot group, no materialized score matrix,
        then an exact top-k over the group winners (the JAX package takes
        approx_max_k there)."""
        q_c, q_bf = self._recon_queries(queries, self._recon_rows.shape[1])
        l2 = self.measure == cfg.SQUARED_L2
        self._stage("tokenize")
        vals, slots = fused_scan.fused_scan_groupmax(
            q_bf, self._recon_rows, self._recon_bias, measure_l2=l2)
        vals, pos = topk_ops.top_k(vals, min(self._k_fetch(k_pre),
                                             vals.shape[-1]))
        slots = torch.gather(slots, -1, pos.long())
        dpids = self.index.slot_dpid[torch.clamp_min(slots, 0).long()]
        dead = vals < -1e20
        vals = torch.where(dead, float("-inf"), vals)
        dpids = torch.where(dead, -1, dpids)
        if l2:
            # Restore the rank-invariant -||q||^2 of the centered query, so
            # the values are true negated squared distances.
            vals = vals - (q_c * q_c).sum(-1)[:, None]
        vals, dpids = self._dedup(vals, dpids, k_pre)
        self._stage("scan")
        return vals, dpids

    def _dense_select(self, queries, k_pre, leaves, full_scan, restrict,
                      pre_tokenized=None):
        """Masked scan over every slot (LUT modes' full scan, restricted
        full scans, plans over the work budget).  LUT modes score with the
        LUT16 one-hot product; the LUTs here are quantized per query with
        each block centered on its midpoint (ah.quantize_luts), unlike
        K3's.  Reconstruct mode multiplies the bf16 queries with the
        decoded rows chunk by chunk (a plain product, as in the JAX
        package) and, given enough groups, keeps one candidate per
        256-slot group of the randomly ordered slots before the top-k."""
        nq = queries.shape[0]
        dev = queries.device
        recon = self._recon_mode
        l2 = self.measure == cfg.SQUARED_L2
        luts = lut_flat = inv_mult = None
        if recon:
            q_c, q_bf = self._recon_queries(queries,
                                            self._recon_rows.shape[1])
            q_f = q_bf.float()
            q_sq = (q_c * q_c).sum(-1)
        else:
            luts = ah_ops.build_luts(queries, self.model, self.measure,
                                     self.ah_cfg.lookup_type)
            lut_flat = lut16_ops.lut_matrix(luts)
            inv_mult = luts.inv_multiplier if luts.int8 is not None else None
        combo = None
        if self._pruned_available:
            num_leaves = self.partitioner.num_leaves
            leaves = (num_leaves if full_scan
                      else max(1, min(leaves, num_leaves)))
            bias = self.residual and not recon
            leaf_ids, keep, center_sims = self.partitioner.select_leaves(
                queries, leaves, pre_tokenized, pair_sims=bias)
            # One (query, leaf) table: -inf for unselected leaves, else the
            # q.c_leaf bias under residual quantization (0 otherwise, and
            # in reconstruct mode, whose rows hold the center).  Unused
            # entries scatter to a spare column past the last leaf.
            vals = (center_sims if bias
                    else torch.zeros(leaf_ids.shape, device=dev))
            cols = torch.where(keep, leaf_ids, num_leaves).long()
            combo = torch.full((nq, num_leaves + 1), float("-inf"),
                               device=dev)
            combo.scatter_(1, cols, torch.where(keep, vals, float("-inf")))
            combo = combo[:, :num_leaves]
        self._stage("tokenize")

        leaf_all = self.index.slot_leaf.long()
        dpid_all = self.index.slot_dpid
        cpb = self.ah_cfg.clusters_per_block
        chunk = self._chunk
        n_slots = dpid_all.shape[0]
        k_fetch = min(self._k_fetch(k_pre), n_slots)
        groupmax = (recon and chunk % _GROUP == 0
                    and n_slots // _GROUP >= 4 * k_fetch)
        blocks = range(0, nq, _DENSE_QUERY_BLOCK)
        state = [None] * len(blocks)
        for start in range(0, n_slots, chunk):
            cs = slice(start, start + chunk)
            leaf_c, dpid_c = leaf_all[cs], dpid_all[cs]
            if recon:
                rows_c = self._recon_rows[cs].float()
            else:
                oh = lut16_ops.one_hot_codes(self.index.codes[cs], cpb)
            valid = (dpid_c >= 0)[None, :]
            if restrict is not None:
                allow = restrict[torch.clamp(
                    dpid_c, 0, restrict.shape[0] - 1).long()]
                valid = valid & allow[None, :]
            for bi, b0 in enumerate(blocks):
                qb = slice(b0, b0 + _DENSE_QUERY_BLOCK)
                if recon:
                    sim = q_f[qb] @ rows_c.T
                    if l2:
                        sim = -(q_sq[qb][:, None] - 2.0 * sim
                                + self._recon_sq[cs][None, :])
                else:
                    sim = lut16_ops.score_one_hot(
                        oh, lut_flat[qb],
                        None if inv_mult is None else inv_mult[qb])
                if combo is not None:
                    sim = sim + combo[qb][:, leaf_c]
                if groupmax:
                    gv, gslot = fused_scan.group_max_first(
                        torch.where(valid, sim, float("-inf")), start)
                    if state[bi] is None:
                        state[bi] = ([], [])
                    state[bi][0].append(gv)
                    state[bi][1].append(gslot)
                    continue
                cvals, cpos = topk_ops.chunk_top_k(
                    sim, min(k_fetch, chunk), valid=valid)
                cslot = torch.where(cpos >= 0, start + cpos, -1)
                if state[bi] is not None:
                    cvals, cslot = topk_ops.merge_top_k(
                        *state[bi], cvals, cslot, k_fetch)
                state[bi] = (cvals, cslot)
        if groupmax:
            gvs = torch.cat([torch.cat(s[0], dim=1) for s in state])
            gss = torch.cat([torch.cat(s[1], dim=1) for s in state])
            vals, pos = topk_ops.top_k(gvs, min(k_fetch, gvs.shape[1]))
            slots = torch.gather(gss, -1, pos.long())
            slots = torch.where(torch.isneginf(vals), -1, slots)
        else:
            vals = torch.cat([s[0] for s in state])
            slots = torch.cat([s[1] for s in state])
        dpids = torch.where(slots >= 0,
                            dpid_all[torch.clamp_min(slots, 0).long()], -1)
        if luts is not None:
            vals = vals + luts.base[:, None]
        vals, dpids = self._dedup(vals, dpids, k_pre)
        self._stage("scan")
        return vals, dpids

    def _pruned_select(self, queries, k_pre: int, leaves: int, restrict,
                       pre_tokenized=None):
        """Leaf-gathered candidate selection through K2, K3 or K4."""
        partitioner = self.partitioner
        num_leaves = partitioner.num_leaves
        leaves = max(1, min(leaves, num_leaves))
        nq = queries.shape[0]
        recon_path = self._p_rows is not None
        # The decoded rows already hold the leaf center.
        residual_bias = self.residual and not recon_path
        leaf_ids, valid_sel, center_sims = partitioner.select_leaves(
            queries, leaves, pre_tokenized, pair_sims=residual_bias)
        self._stage("tokenize")

        pair_bias = center_sims if residual_bias else None
        d_pad = (self._p_rows.shape[-1] if recon_path
                 else self._p_mean.shape[0])
        q_c, q_bf = self._recon_queries(queries, d_pad)
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
        # K3 takes the batch's queries whole (its LUT pre-pass builds one
        # LUT per query); K2 and K4 take the gathered query groups.
        qg_rows = (None if self._int8_lut and not recon_path
                   else q_bf[plan.qg_query.long()])   # (G_pad, QG, d_pad)
        l2 = self.measure == cfg.SQUARED_L2
        k_fetch = self._k_fetch(k_pre)
        kpg = self._kpg_override or _survivors_per_group(
            k_fetch, self._num_slots, num_leaves)
        self._stage("plan")
        if recon_path:
            packed = pruned_scan.score_work(
                plan, qg_rows, self._p_rows, p_bias, measure_l2=l2, kpg=kpg)
        elif self._int8_lut:
            packed = pruned_lut.score_work_lut(
                plan, q_bf, self._p_codes, self._p_cb, self._p_csq,
                p_bias, measure_l2=l2, kpg=kpg)
        else:
            packed = pruned_lut.score_work_codes(
                plan, qg_rows, self._p_codes, self._p_cb, self._p_mean,
                p_bias, measure_l2=l2, kpg=kpg)
        self._stage("score")
        if pruned_scan.fused_merge_enabled(k_fetch):
            cand_vals, cand_slots = pruned_scan.merge_candidates_fused(
                plan, packed, leaf_ids, valid_sel, self._p_tile_start,
                self._p_ntiles, self._p_max_ntiles, k_fetch,
                pair_bias=pair_bias)
        else:
            cand_vals, cand_slots = pruned_scan.merge_candidates(
                plan, packed, leaf_ids, valid_sel, self._p_tile_start,
                self._p_ntiles, self._p_max_ntiles, k_fetch,
                pair_bias=pair_bias, hot=merge_hot)
        dpids = torch.where(
            cand_slots >= 0,
            self._p_dpid[torch.clamp_min(cand_slots, 0).long()], -1)
        if l2:
            # Restore the rank-invariant -||q||^2 of the centered query.
            cand_vals = cand_vals - (q_c * q_c).sum(-1)[:, None]
        cand_vals, dpids = self._dedup(cand_vals, dpids, k_pre)
        self._stage("merge")
        return cand_vals, dpids
