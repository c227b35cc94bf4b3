"""Tree-AH searcher: partition + asymmetric-hashing scoring + reorder.

Port of the product-quantization modes of scann_tpu/models/tree_ah.py.
Rows are stored as AH codes of the residual x - c_leaf (dot product with a
tree) or of x, 16 or 256 centers per block.  A batch scores only its
selected leaves through the pruned path: tokenize -> plan
(pruned_scan.work_plan) -> score -> merge (pruned_scan.merge_candidates, or
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
(topk.dedup_candidates) before the best k_pre, in a ``dedup`` span and
stage of its own after the selection's last (``merge`` or ``scan``);
without SOAR no such span, mark or launch exists.  AVQ refits the centers
after tokenization.  A batch may name its leaves (``pre_tokenized``), and
query spilling masks the tokenizer's selection.

Stacked (additive) codes and VARIABLE_CHUNK codes take the pruned path
through K2 in reconstruct mode and the dense masked scan in the LUT modes
(stacked LUTs are quantized on a zero base: they carry no residual bias),
as in the JAX package.  A one-leaf tree searches every slot (K5 in
reconstruct mode, the dense scan otherwise); over 8,192 rows the build's
leaf-size cap splits its leaf, as the JAX package's does.  With a projection the
codes, the tree and every scorer work at the projected width; the reorder
rescores the original rows.  Every scorer serves every width on the card
as on the CPU.

Mutation (built with docids) edits the slot layout in place: an upsert
tokenizes and encodes its rows as the build does and writes them into
free slots (dpid -1), taken last-in first-out, every row's primary slot
before the SOAR secondaries, growing the layout by a fifth when the free
slots run out; a delete frees its slots.  The pruned layout is rebuilt
from the slots at the next query, and the reconstruct full-scan rows are
written in place, decoded with the mean of the last (re)build: the JAX
package's order of operations, slot for slot.  ``incremental_maintenance``
splits oversized leaves (a 2-means over their members) and merges leaves
deletes have drained.
"""

from __future__ import annotations

import dataclasses
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
from scann_torch.ops import stacked as stacked_ops
from scann_torch.ops import topk as topk_ops
from scann_torch.partitioning import kmeans_tree
from scann_torch.utils import native
from scann_torch.utils import profiling

_SCORE_CHUNK = 65536    # slots per chunk of the dense masked scan
_ENCODE_CHUNK = 32768   # rows per encoding chunk (bounds the (chunk, B, J)
# residual-stats arrays)
_DENSE_QUERY_BLOCK = 2048  # queries per block of the dense scan
_PAD_PENALTY = fused_scan._PAD_PENALTY  # bias of padded / disallowed slots
_GROUP = fused_scan.SUB  # slots per candidate group of the dense recon scan
RECONSTRUCT = "reconstruct"

# SOAR secondary slots laid out by builds and upserts, a number the host
# already holds (no wait on the card).
secondary_slots = 0

_log = logging.getLogger("scann_torch")


class TreeAHIndex(NamedTuple):
    """Index arrays in the leaf-sorted slot layout of the dense scan."""
    codes: Optional[torch.Tensor]  # (S, B) uint8, uploaded on first dense use
    slot_dpid: torch.Tensor        # (S,) int32, -1 padding
    slot_leaf: torch.Tensor        # (S,) int32, 0 for padding


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def check_supported(scann_config: cfg.ScannConfig):
    """Raise ValueError for tree-AH settings no searcher serves."""
    ah = scann_config.asymmetric_hash
    if ah.lookup_type not in (cfg.INT8, cfg.FLOAT32, RECONSTRUCT):
        raise ValueError(f"unknown lookup_type {ah.lookup_type!r}")
    if ah.clusters_per_block not in (16, 256):
        raise ValueError("hash_type must be lut16 or lut256")
    if (ah.quantization_scheme == "stacked"
            and cfg.internal_measure(scann_config.distance_measure)
            == cfg.SQUARED_L2 and ah.lookup_type != RECONSTRUCT):
        raise ValueError(
            "stacked quantization under squared L2 requires "
            "lookup_type='reconstruct' (additive ||x_hat||^2 cross terms "
            "are not LUT-decomposable)")


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

    _mutable = True

    def __init__(self, database: np.ndarray, scann_config: cfg.ScannConfig,
                 device: torch.device, docids=None):
        check_supported(scann_config)
        super().__init__(database, scann_config, device, docids)
        self._init_config(scann_config)
        self._build()
        self._build_x_dev = None

    def _init_config(self, scann_config):
        self.part_cfg = scann_config.partitioning
        self.ah_cfg = scann_config.asymmetric_hash
        self.measure = cfg.internal_measure(scann_config.distance_measure)
        self.residual = bool(self.ah_cfg.residual_quantization)
        self.stacked = self.ah_cfg.quantization_scheme == "stacked"
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
        """SOAR: keep each row's best copy, then the best k_pre, as the
        ``dedup`` span and stage.  Without SOAR the candidates pass
        through untouched."""
        if self._soar is None:
            return vals, dpids
        with profiling.span("dedup"):
            vals, dpids = topk_ops.dedup_candidates(vals, dpids)
            vals, pos = topk_ops.top_k(vals, min(k_pre, vals.shape[-1]))
            dpids = torch.gather(dpids, -1, pos.long())
            self._stage("dedup")
        return vals, dpids

    def _build(self):
        global secondary_slots
        x_dev = self._project_database(self._build_x_dev)
        n, d = x_dev.shape
        seed = self.config.seed
        tokens2 = None
        with profiling.phase("partition"):
            if self.part_cfg is None:
                tokens = np.zeros((n,), np.int32)
            else:
                tokens, tokens2 = self._train_partition(x_dev)
        self.datapoint_to_token = (tokens2 if tokens2 is not None
                                   else tokens[:, None])
        # Residual int8 reordering waits for the final primary tokens: its
        # q.c_leaf bias must match the centers the residuals are taken
        # against.
        self._finish_deferred_reorder(x_dev, tokens)

        with profiling.phase("quantize"):
            if self.residual and self.partitioner is not None:
                primary_vecs = self.partitioner.residualize(x_dev, tokens)
            else:
                primary_vecs = x_dev
            gen = torch.Generator().manual_seed(seed + 1)
            sample_idx = kmeans_ops.sample_rows(
                gen, n, self.ah_cfg.training_sample_size)
            sample = primary_vecs[sample_idx.to(self.device)]
            if self.stacked:
                self.model = stacked_ops.train_stacked(
                    gen, sample, -(-d // self.ah_cfg.dimensions_per_block),
                    self.ah_cfg.clusters_per_block,
                    self.ah_cfg.training_iterations)
            else:
                self.model = ah_ops.train_ah_model(
                    gen, sample, self.ah_cfg.dimensions_per_block,
                    self.ah_cfg.clusters_per_block,
                    self.ah_cfg.training_iterations, dims=d,
                    variable_dims_per_block=(
                        self.ah_cfg.variable_dims_per_block))
            self._encoded_slots = 0
            self._quantization_error_sq = 0.0
            codes = self._encode_dataset(primary_vecs, x_dev)
            leaf = tokens
            dpid = np.arange(n, dtype=np.int32)
            if tokens2 is not None:
                # SOAR: each row also lives in its secondary leaf, encoded
                # as the residual against that leaf's center; 2n slots.
                secondary_slots += n
                codes = np.concatenate([codes, self._encode_dataset(
                    self.partitioner.residualize(x_dev, tokens2[:, 1]),
                    x_dev)])
                leaf = np.concatenate([tokens2[:, 0], tokens2[:, 1]])
                dpid = np.concatenate([dpid, dpid])
        with profiling.phase("layout"):
            self.index = self._layout_slots(codes, leaf.astype(np.int32),
                                            dpid)
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
        return np.asarray(tokens, np.int32), tokens2

    def _encode_dataset(self, vectors, originals) -> np.ndarray:
        """Encode all vectors in fixed-size chunks; also keeps the running
        mean squared quantization error over the encoded slots."""
        threshold = self.ah_cfg.anisotropic_quantization_threshold
        noise_shaped = not math.isnan(threshold)
        out = []
        err_sum = 0.0
        for s0 in range(0, vectors.shape[0], _ENCODE_CHUNK):
            v = vectors[s0:s0 + _ENCODE_CHUNK].float()
            if self.stacked:
                codes = stacked_ops.encode_stacked(v, self.model)
            elif noise_shaped:
                codes = ah_ops.encode_noise_shaped(
                    v, originals[s0:s0 + _ENCODE_CHUNK].float(), self.model,
                    threshold)
            else:
                codes = ah_ops.encode(v, self.model)
            recon = self._reconstruct(codes)
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
        self._reset_mutation_maps(num_leaves)
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
        """Feature dimension of the decoded rows: the index width padded
        to 128."""
        return _round_up(self._index_dims, 128)

    def _reconstruct(self, codes):
        """Codes -> approximate (n, index width) f32 vectors."""
        if self.stacked:
            return stacked_ops.reconstruct_stacked(codes, self.model)
        return ah_ops.reconstruct(codes, self.model)

    def _decode_slots(self, codes, slot_leaf, slot_dpid, mean=None):
        """Decode codes into bf16 approximate rows: x_hat = c_leaf +
        recon(codes) under residual quantization, recon(codes) otherwise,
        minus ``mean`` (squared L2: see _decode_mean), zero on dead slots,
        zero-padded to _recon_dim.  Also returns ||x_hat||^2 of the f32
        rows, summed before the bf16 cast."""
        recon = self._reconstruct(codes)
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
    def _partitioned(self) -> bool:
        return (self.partitioner is not None
                and self.partitioner.num_leaves > 1)

    @property
    def _pruned_available(self) -> bool:
        """True when leaf-gathered queries take the pruned path: every
        tree of more than one leaf in reconstruct mode (K2), and fixed
        product chunks in the LUT modes (K3 / K4).  Stacked and
        VARIABLE_CHUNK codes in a LUT mode take the dense scan, as in the
        JAX package."""
        fixed_product = (not self.stacked
                         and self.ah_cfg.variable_dims_per_block is None)
        return (self._recon_mode or fixed_product) and self._partitioned

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
        total = np.zeros((self._index_dims,), np.float64)
        for s in range(0, h["codes"].shape[0], _ENCODE_CHUNK):
            codes = torch.from_numpy(h["codes"][s:s + _ENCODE_CHUNK]).to(
                self.device)
            live = torch.from_numpy(h["dpid"][s:s + _ENCODE_CHUNK] >= 0).to(
                self.device)
            r = self._reconstruct(codes)
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
        pad-penalty bias plane and the mean.  A ``layout`` span."""
        if not self._pruned_available or self._pruned_built:
            return
        with profiling.phase("layout"):
            self._build_pruned()

    def _build_pruned(self):
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
        with profiling.span("tokenize"):
            q_c, q_bf = self._recon_queries(queries, self._recon_rows.shape[1])
            l2 = self.measure == cfg.SQUARED_L2
            self._stage("tokenize")
        with profiling.span("scan"):
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
            self._stage("scan")
        return self._dedup(vals, dpids, k_pre)

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
        with profiling.span("tokenize"):
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
                if self.stacked:
                    # Stacked LUTs carry no residual bias: quantized on a zero
                    # base (dot product only; squared L2 is refused).
                    luts = ah_ops.quantize_luts(
                        stacked_ops.build_stacked_luts(queries, self.model),
                        torch.zeros((nq,), dtype=torch.float32, device=dev),
                        self.ah_cfg.lookup_type)
                else:
                    luts = ah_ops.build_luts(queries, self.model, self.measure,
                                             self.ah_cfg.lookup_type)
                lut_flat = lut16_ops.lut_matrix(luts)
                inv_mult = (luts.inv_multiplier if luts.int8 is not None
                            else None)
            combo = None
            if self._partitioned:
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

        with profiling.span("scan"):
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
            self._stage("scan")
        return self._dedup(vals, dpids, k_pre)

    def _pruned_select(self, queries, k_pre: int, leaves: int, restrict,
                       pre_tokenized=None):
        """Leaf-gathered candidate selection through K2, K3 or K4."""
        with profiling.span("tokenize"):
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

        with profiling.span("plan"):
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
                g_pad, _ = pruned_scan.plan_capacities(
                    nq, leaves, num_leaves, self._p_num_tiles,
                    self._p_max_ntiles)
                plan = pruned_scan.work_plan(
                    leaf_ids, valid_sel, self._p_tile_start, self._p_ntiles,
                    self._p_max_ntiles, g_pad)
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
        with profiling.span("score"):
            if recon_path:
                packed = pruned_scan.score_work(
                    plan, qg_rows, self._p_rows, p_bias, measure_l2=l2,
                    kpg=kpg)
            elif self._int8_lut:
                packed = pruned_lut.score_work_lut(
                    plan, q_bf, self._p_codes, self._p_cb, self._p_csq,
                    p_bias, measure_l2=l2, kpg=kpg)
            else:
                packed = pruned_lut.score_work_codes(
                    plan, qg_rows, self._p_codes, self._p_cb, self._p_mean,
                    p_bias, measure_l2=l2, kpg=kpg)
            self._stage("score")
        with profiling.span("merge"):
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
            self._stage("merge")
        return self._dedup(cand_vals, dpids, k_pre)

    # ----------------------------------------------------------- mutation
    def _reset_mutation_maps(self, num_leaves: int):
        """State of a freshly laid-out (or loaded) index: no slot table
        yet, and no per-leaf mutation or deletion pressure."""
        self._slot_table = None
        self._free_slots = None
        self._leaf_mutations = np.zeros((num_leaves,), np.int64)
        self._leaf_deletions = np.zeros((num_leaves,), np.int64)
        self._in_maintenance = False

    def _dev(self, a):
        """A device copy of a host array (never a view of it: the host
        arrays are written in place)."""
        return torch.tensor(np.ascontiguousarray(a), device=self.device)

    def _ensure_mutable_maps(self):
        """The id -> slots table ((n, 2) int64, -1 empty; two columns for
        SOAR) and the free slots, in the order they are taken (from the
        end: the lowest free slot last)."""
        if self._slot_table is not None:
            return
        # Own copies: the device tensors may view the host arrays.
        self._host = {k: v.copy() for k, v in self._host.items()}
        dp = self._host["dpid"]
        live = np.nonzero(dp >= 0)[0]
        d_live = dp[live].astype(np.int64)
        order = np.argsort(d_live, kind="stable")
        ds, ss = d_live[order], live[order]
        n_max = int(ds.max()) + 1 if len(ds) else 0
        table = np.full((n_max, 2), -1, np.int64)
        is_first = np.concatenate([[True], ds[1:] != ds[:-1]])
        table[ds[is_first], 0] = ss[is_first]
        table[ds[~is_first], 1] = ss[~is_first]
        self._slot_table = table
        self._free_slots = list(np.nonzero(dp < 0)[0][::-1])

    def _table_pop(self, i: int):
        """Return and clear the slots holding row i."""
        if i >= len(self._slot_table):
            return []
        slots = [int(x) for x in self._slot_table[i] if x >= 0]
        self._slot_table[i] = -1
        return slots

    def _table_add(self, i: int, slot: int):
        if i >= len(self._slot_table):
            grow = max(i + 1 - len(self._slot_table),
                       len(self._slot_table) // 5 + 1)
            self._slot_table = np.concatenate(
                [self._slot_table, np.full((grow, 2), -1, np.int64)])
        self._slot_table[i, 0 if self._slot_table[i, 0] < 0 else 1] = slot

    def _encode_rows(self, x):
        """Tokenize, residualize and encode rows (a device tensor in the
        index space) as the build does.  Returns ((n, 1 or 2 under SOAR)
        int32 tokens, the codes of each token column)."""
        soar = self._soar
        if self.partitioner is None:
            tokens = np.zeros((x.shape[0], 1), np.int32)
        elif soar is not None:
            tokens = self.partitioner.tokenize_database_soar(
                x, soar).cpu().numpy()
        else:
            tokens = self.partitioner.tokenize_database(
                x).cpu().numpy()[:, None]
        threshold = self.ah_cfg.anisotropic_quantization_threshold
        codes = []
        for col in range(tokens.shape[1]):
            v = (self.partitioner.residualize(x, tokens[:, col])
                 if self.residual and self.partitioner is not None else x)
            if self.stacked:
                c = stacked_ops.encode_stacked(v, self.model)
            elif not math.isnan(threshold):
                c = ah_ops.encode_noise_shaped(v, x, self.model, threshold)
            else:
                c = ah_ops.encode(v, self.model)
            codes.append(c.cpu().numpy())
        return tokens.astype(np.int32), codes

    def _grow_slots(self, extra: int):
        """Append free slots (a fifth of the layout at least, in whole
        chunks), re-upload, and rebuild the derived layouts (the
        reconstruct mean is recomputed)."""
        h = self._host
        grow = _round_up(max(extra, h["codes"].shape[0] // 5 + 1),
                         self._chunk)
        h["codes"] = np.pad(h["codes"], ((0, grow), (0, 0)))
        h["leaf"] = np.pad(h["leaf"], (0, grow))
        h["dpid"] = np.pad(h["dpid"], (0, grow), constant_values=-1)
        self._free_slots.extend(range(len(h["dpid"]) - grow, len(h["dpid"])))
        self.index = TreeAHIndex(
            codes=None if self.index.codes is None else self._dev(h["codes"]),
            slot_dpid=self._dev(h["dpid"]), slot_leaf=self._dev(h["leaf"]))
        self._build_recon()

    def _apply_upsert(self, ids: np.ndarray, vecs: np.ndarray):
        global secondary_slots
        self._ensure_mutable_maps()
        raw = np.asarray(vecs, np.float32)
        # Encode in the (projected) index space; the reorder keeps the
        # original rows.
        x = self._project_database(torch.as_tensor(raw, device=self.device))
        tokens, codes_per_col = self._encode_rows(x)
        freed = []
        for i in ids:
            for slot in self._table_pop(int(i)):
                self._host["dpid"][slot] = -1
                self._free_slots.append(slot)
                freed.append(slot)
        needed = len(ids) * tokens.shape[1]
        if len(self._free_slots) < needed:
            self._grow_slots(needed - len(self._free_slots))
        slots = []
        for col in range(tokens.shape[1]):
            for i in ids:
                slot = self._free_slots.pop()
                slots.append(slot)
                self._table_add(int(i), int(slot))
        secondary_slots += len(ids) * (tokens.shape[1] - 1)
        slot_arr = np.asarray(slots, np.int64)
        code_arr = np.concatenate(codes_per_col).astype(np.uint8)
        leaf_arr = tokens.T.reshape(-1).astype(np.int32)
        dpid_arr = np.tile(np.asarray(ids, np.int32), tokens.shape[1])
        h = self._host
        h["codes"][slot_arr] = code_arr
        h["leaf"][slot_arr] = leaf_arr
        h["dpid"][slot_arr] = dpid_arr
        # Freed slots not taken again end empty; the rest hold their row.
        touched = np.unique(np.concatenate(
            [slot_arr, np.asarray(freed, np.int64)]))
        sidx = torch.as_tensor(touched, device=self.device)
        self.index.slot_dpid[sidx] = self._dev(h["dpid"][touched])
        self.index.slot_leaf[sidx] = self._dev(h["leaf"][touched])
        if self.index.codes is not None:
            self.index.codes[sidx] = self._dev(h["codes"][touched])
        self._num_slots = int(np.sum(h["dpid"] >= 0))
        if self._recon_mode and self._recon_rows is not None:
            # Decoded with the current (possibly stale) mean, as in the JAX
            # package.
            r, q = self._decode_slots(
                self._dev(code_arr), self._dev(leaf_arr),
                self._dev(dpid_arr), mean=self._recon_mean)
            nidx = torch.as_tensor(slot_arr, device=self.device)
            self._recon_rows[nidx] = r
            self._recon_sq[nidx] = q
            self._recon_bias[nidx] = self._make_bias(q, self._dev(dpid_arr))
        self._invalidate_pruned()
        self._grow_token_map(ids, tokens)
        if self.reorder_helper is not None:
            self.reorder_helper.ensure_capacity(int(ids.max()) + 1)
            self.reorder_helper.update_rows(ids, raw, tokens=tokens[:, 0])
        if not self._in_maintenance:
            np.add.at(self._leaf_mutations, leaf_arr, 1)

    def _grow_token_map(self, ids, tokens):
        t = np.asarray(self.datapoint_to_token)
        width = t.shape[1]
        max_id = int(ids.max())
        if max_id >= t.shape[0]:
            t = np.pad(t, ((0, max_id + 1 - t.shape[0]), (0, 0)),
                       constant_values=-1)
        t[ids, :min(width, tokens.shape[1])] = tokens[:, :width]
        self.datapoint_to_token = t

    def _apply_delete(self, ids: np.ndarray):
        self._ensure_mutable_maps()
        slots = []
        for i in ids:
            slots.extend(self._table_pop(int(i)))
        if not slots:
            return
        slot_arr = np.asarray(slots, np.int64)
        np.add.at(self._leaf_deletions, self._host["leaf"][slot_arr], 1)
        self._host["dpid"][slot_arr] = -1
        self._free_slots.extend(slots)
        sidx = torch.as_tensor(slot_arr, device=self.device)
        self.index.slot_dpid[sidx] = -1
        if self._recon_mode and self._recon_bias is not None:
            self._recon_bias[sidx] = _PAD_PENALTY
        self._invalidate_pruned()
        self._num_slots = int(np.sum(self._host["dpid"] >= 0))

    # -------------------------------------------- incremental maintenance
    def incremental_maintenance(self, max_splits: int = 4,
                                max_merges: int = 4) -> int:
        """Split the most oversized leaves (over twice the mean primary
        count, largest first) and merge the leaves deletes have drained
        (under max(2, 5% of the mean of non-empty leaves), smallest
        first, applied in descending leaf order).  The codebook and every
        untouched leaf's slots stay.  Returns the leaves changed."""
        if self.partitioner is None or self._mut is None:
            return 0
        st = self._mut

        def primary_counts():
            t = self.datapoint_to_token
            na = min(len(st.alive), len(t))
            prim = np.where(st.alive[:na], t[:na, 0], -1)
            return np.bincount(prim[prim >= 0],
                               minlength=self.partitioner.num_leaves)

        counts = primary_counts()
        avg = max(1.0, counts.mean())
        oversized = np.nonzero(counts > 2.0 * avg)[0]
        oversized = oversized[np.argsort(-counts[oversized])][:max_splits]
        changed = 0
        for tok in oversized:
            if self._split_partition(int(tok)):
                changed += 1
        if max_merges and self.partitioner.num_leaves > 2:
            counts = primary_counts()
            avg = max(1.0, counts[counts > 0].mean()
                      if (counts > 0).any() else 1.0)
            underfull = np.nonzero((counts < max(2.0, 0.05 * avg))
                                   & (self._leaf_deletions > 0))[0]
            underfull = underfull[np.argsort(counts[underfull],
                                             kind="stable")][:max_merges]
            for tok in sorted((int(x) for x in underfull), reverse=True):
                if self.partitioner.num_leaves <= 2:
                    break
                if self._merge_partition(tok):
                    changed += 1
        self._leaf_mutations[:] = 0
        return changed

    def _set_centers(self, centers: np.ndarray, upper_assign):
        """Install a changed center set (int8 copy requantized) and its
        leaf count in part_cfg and config."""
        part = self.partitioner
        c = torch.as_tensor(centers, dtype=torch.float32, device=self.device)
        centers_int8 = inv_mult = None
        if part.centers_int8 is not None:
            from scann_torch.ops import quantize as quant_ops
            sq = quant_ops.scalar_quantize(c)
            centers_int8, inv_mult = sq.data, sq.inverse_multipliers
        self.partitioner = part._replace(
            centers=c, centers_int8=centers_int8, centers_inv_mult=inv_mult,
            upper_assign=upper_assign)
        if (self.reorder_helper is not None
                and self.reorder_helper._leaf is not None):
            # The residual rescore biases q.c_leaf against these centers.
            self.reorder_helper._centers = self.partitioner.centers
        self.part_cfg = dataclasses.replace(
            self.part_cfg, num_leaves=centers.shape[0],
            num_leaves_to_search=min(self.part_cfg.num_leaves_to_search,
                                     centers.shape[0]))
        self.config = dataclasses.replace(self.config,
                                          partitioning=self.part_cfg)

    def _reinsert(self, ids: np.ndarray):
        """Re-tokenize and re-encode rows under the changed tree."""
        self._in_maintenance = True
        try:
            self._apply_upsert(ids.astype(np.int64), self._mut.vectors[ids])
        finally:
            self._in_maintenance = False

    def _merge_partition(self, token: int) -> bool:
        """Drop one leaf: its center goes, the leaf ids above it shift
        down by one, and its rows (primary members and SOAR spills) are
        re-tokenized against the remaining centers."""
        self._ensure_mutable_maps()
        st = self._mut
        t = self.datapoint_to_token
        na = min(len(st.alive), len(t))
        affected = np.nonzero(st.alive[:na]
                              & (t[:na] == token).any(axis=1))[0]
        centers = np.delete(self.partitioner.centers.cpu().numpy(), token,
                            axis=0)
        upper_assign = self.partitioner.upper_assign
        if upper_assign is not None:
            keep = np.delete(np.arange(upper_assign.shape[0]), token)
            upper_assign = upper_assign[torch.as_tensor(
                keep, device=upper_assign.device)]
        self._set_centers(centers, upper_assign)
        t = np.array(t)
        t[t > token] -= 1
        self.datapoint_to_token = t
        h = self._host
        h["leaf"][h["leaf"] > token] -= 1
        sl = self.index.slot_leaf
        self.index = self.index._replace(
            slot_leaf=torch.where(sl > token, sl - 1, sl))
        rh = self.reorder_helper
        if rh is not None and rh._leaf is not None:
            rh._leaf = torch.where(rh._leaf > token, rh._leaf - 1, rh._leaf)
        self._leaf_mutations = np.delete(self._leaf_mutations, token)
        self._leaf_deletions = np.delete(self._leaf_deletions, token)
        self._invalidate_pruned()
        if len(affected):
            self._reinsert(affected)
        return True

    def _split_partition(self, token: int) -> bool:
        """Split one leaf by a 2-means (k-means++, 5 iterations) over its
        members: one half keeps its id, the other becomes a new last leaf,
        and only its members are re-tokenized."""
        st = self._mut
        t = self.datapoint_to_token
        na = min(len(st.alive), len(t))
        members = np.nonzero(st.alive[:na] & (t[:na, 0] == token))[0]
        if len(members) < 4:
            return False
        x = self._project_database(torch.as_tensor(
            st.vectors[members], device=self.device))
        gen = torch.Generator().manual_seed(self.config.seed + 131 + token)
        c2 = kmeans_ops.kmeans(gen, x, 2, iterations=5,
                               init="kmeans++").centers.cpu().numpy()
        centers = self.partitioner.centers.cpu().numpy().copy()
        centers[token] = c2[0]
        centers = np.concatenate([centers, c2[1:2]], axis=0)
        upper_assign = self.partitioner.upper_assign
        if upper_assign is not None:
            up = self.partitioner.upper_centers.cpu().numpy()
            d = ((up - c2[1][None, :]) ** 2).sum(-1)
            add = (np.argsort(d)[:2][None, :] if upper_assign.dim() == 2
                   else np.asarray([np.argmin(d)]))
            upper_assign = torch.cat([upper_assign, torch.as_tensor(
                add.astype(np.int32), device=upper_assign.device)])
        self._set_centers(centers, upper_assign)
        self._leaf_mutations = np.concatenate(
            [self._leaf_mutations, np.zeros((1,), np.int64)])
        self._leaf_deletions = np.concatenate(
            [self._leaf_deletions, np.zeros((1,), np.int64)])
        self._reinsert(members)
        return True
