"""Searcher base: the search pipeline (port of scann_tpu/models/base.py).

``search_batched`` -> ``_select_candidates`` (per engine, on the
projected queries when the index has a projection, optionally on the
caller's leaves) -> optional exact reordering of the best
``pre_reorder_num_neighbors`` (``ReorderHelper``), after the per-query
k_pre mask, the pre-reordering epsilon and pre-reordering crowding ->
crowding -> final top-k, conversion to user distance, and INVALID / NaN
padding; the post-reordering epsilon and a per-query k mask the host
copy.  Torch runs eagerly: a batch is enqueued on the device stream,
and on a CUDA device its upload and its result copy are enqueued with it,
each on a copy stream of its own (``_BatchCopies``), so ``PendingSearch``
waits for its own batch only.  Batches are not padded to power-of-two
buckets (that bounded JAX recompilation); per-query results never depend
on the batch they ride in.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from scann_torch import config as cfg
from scann_torch.ops import distance as dist_ops
from scann_torch.ops import pruned_scan
from scann_torch.ops import quantize as quant_ops
from scann_torch.ops import topk as topk_ops
from scann_torch.utils import profiling


# Counters (utils/profiling.py lists them): CUDA batches enqueued with
# their result copy (a split batch: one a sub-batch), and result() calls
# whose result copy had not finished when they were made.
async_batches = 0
result_waits = 0

_copy_streams: dict = {}     # CUDA device index -> (upload, download)


class _BatchCopies:
    """One CUDA batch's host<->device copies, each on a copy stream of the
    device's own, one a direction, so that an upload never queues behind
    a download that waits for compute; each ordered by an event against
    the compute stream, the current stream at the call."""

    def __init__(self, device):
        self.compute = torch.cuda.current_stream(device)
        dev = self.compute.device_index
        if dev not in _copy_streams:
            _copy_streams[dev] = (torch.cuda.Stream(dev),
                                  torch.cuda.Stream(dev))
        self.h2d, self.d2h = _copy_streams[dev]

    def upload(self, x):
        """A host array on the device, ready for the compute stream's work
        enqueued after the call.  The copy is from the caller's pageable
        memory: CUDA stages it, and the host waits only for the
        upload stream.  On an H100 host that took 0.96 ms for a 5 MB
        batch, where a copy into pinned memory first took 2.67 ms."""
        with torch.cuda.stream(self.h2d):
            dev = torch.as_tensor(np.ascontiguousarray(x)).to(
                self.h2d.device, non_blocking=True)
        self.compute.wait_event(self.h2d.record_event())
        # Not reused by the allocator before the compute stream is done.
        dev.record_stream(self.compute)
        return dev

    def download(self, *tensors):
        """Enqueues the copy of the compute stream's tensors, after its work
        so far, into pinned host memory (torch's caching host allocator);
        returns the function that waits for that copy alone and gives
        numpy copies of its own (no array aliases a buffer that a later
        batch writes, and pinned memory is held only while a batch is in
        flight)."""
        global async_batches
        async_batches += 1
        self.d2h.wait_event(self.compute.record_event())
        with torch.cuda.stream(self.d2h):
            hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors]
            for h, t in zip(hosts, tensors):
                h.copy_(t, non_blocking=True)
                # Not overwritten by the next batch before the copy.
                t.record_stream(self.d2h)
        copied = self.d2h.record_event()

        def fetch():
            global result_waits
            if not copied.query():
                result_waits += 1
            copied.synchronize()
            return tuple(h.numpy().copy() for h in hosts)

        return fetch


class PendingSearch:
    """Handle for an enqueued batched search; .result() waits for the
    batch's results on the host (on the CPU it copies them there) and
    caches them (the ``result`` span, with the search's batch id)."""

    __slots__ = ("_finalize", "_result", "_batch")

    def __init__(self, finalize, batch=None):
        self._finalize = finalize
        self._result = None
        self._batch = batch

    def result(self):
        if self._finalize is not None:
            with profiling.span("result", self._batch):
                self._result = self._finalize()
            self._finalize = None
        return self._result


# Device-batch cap of the pruned path, halved until batch * leaves fits the
# pair budget: the JAX package's boundaries, kept so that both packages
# split a batch the same way.
_PRUNED_MAX_BATCH = 65536
_PRUNED_PAIR_BUDGET = 32768 * 50


def pruned_dispatch_cap(leaves: int) -> int:
    """Largest pruned dispatch batch for a given leaves_to_search (floor
    1024)."""
    cap = _PRUNED_MAX_BATCH
    while cap > 1024 and cap * max(int(leaves), 1) > _PRUNED_PAIR_BUDGET:
        cap //= 2
    return cap


def _row_quantize(delta):
    """Per-row symmetric int8: codes = round(delta / scale), scale =
    max|delta_d| / 127 per row (0 for all-zero rows).  Returns (int8
    codes, (n,) f32 dequant scale)."""
    m = delta.abs().amax(dim=-1)
    scale = m / 127.0
    inv = torch.where(m > 0, 127.0 / torch.clamp_min(m, 1e-30), 0.0)
    q8 = torch.clamp(torch.round(delta * inv[:, None]), -127, 127).to(
        torch.int8)
    return q8, scale


def last_positions(ids) -> np.ndarray:
    """Positions of the last occurrence of each id, in call order: the rows
    a scatter writes, so that a repeated id keeps its last row on any
    device (index_put_ picks no defined winner among repeats on CUDA)."""
    ids = np.asarray(ids)
    _, first_rev = np.unique(ids[::-1], return_index=True)
    return np.sort(len(ids) - 1 - first_rev)


class ReorderHelper:
    """Rescoring of candidate lists against a compressed copy of the
    dataset: float32, bfloat16, residual int8 (rows stored as per-row
    int8 of x - c_primary_leaf; the exact f32 q.c_leaf is added back at
    rescore time), or int8 with per-dimension multipliers (optionally
    noise-shaped), which serves int8 reordering without a tree and
    ``reorder(..., quantize="int8", residual=False)``."""

    def __init__(self, database, measure: str,
                 reorder_cfg: cfg.ReorderConfig, residual_tokens=None,
                 centers=None):
        self.measure = measure
        self.config = reorder_cfg
        self._leaf = None
        self._centers = None
        self._row_scale = None
        self._inv_mult = None
        x = database.float()
        if (reorder_cfg.quantize == cfg.INT8 and residual_tokens is not None
                and centers is not None):
            tokens = torch.as_tensor(residual_tokens, device=x.device).to(
                torch.int32)
            c_rows = centers[tokens.long()]
            q8, scale = _row_quantize(x - c_rows)
            self._db = q8
            self._row_scale = scale
            self._leaf = tokens
            self._centers = centers
            # ||x_hat||^2 of the reconstructed row c + delta_hat (L2 path).
            deq = q8.float() * scale[:, None] + c_rows
            self._sq_norms = (deq * deq).sum(-1)
        elif reorder_cfg.quantize == cfg.INT8:
            thr = reorder_cfg.anisotropic_quantization_threshold
            if math.isnan(thr):
                sq = quant_ops.scalar_quantize(x)
            else:
                sq = quant_ops.scalar_quantize_noise_shaped(x, thr)
            self._db = sq.data
            self._inv_mult = sq.inverse_multipliers
            self._sq_norms = sq.sq_norms
        elif reorder_cfg.quantize == cfg.BFLOAT16:
            self._db = x.to(torch.bfloat16)
            self._sq_norms = (x * x).sum(-1)
        else:
            self._db = x
            self._sq_norms = None

    def ensure_capacity(self, n: int):
        """Grow the rows to hold at least n (by a fifth and 128 more, as in
        the JAX package)."""
        cap = self._db.shape[0]
        if n <= cap:
            return
        grow = max(n, int(cap * 1.2) + 128) - cap

        def pad(t):
            return None if t is None else torch.cat(
                [t, t.new_zeros((grow,) + tuple(t.shape[1:]))])

        self._db = pad(self._db)
        self._sq_norms = pad(self._sq_norms)
        self._leaf = pad(self._leaf)
        self._row_scale = pad(self._row_scale)

    def update_rows(self, ids, rows, tokens=None):
        """Write rows ``ids`` (the mutation path).  Residual int8 takes the
        rows' primary leaves (``tokens``); per-dimension int8 keeps its
        build's multipliers and rounds plainly (no noise shaping), as the
        JAX package does.  A repeated id keeps its last row."""
        if self._leaf is not None and tokens is None:
            raise ValueError("residual int8 reordering requires primary "
                             "tokens on update_rows")
        keep = last_positions(ids)
        dev = self._db.device
        idx = torch.as_tensor(np.asarray(ids)[keep], device=dev).long()
        x = torch.as_tensor(np.asarray(rows, np.float32)[keep], device=dev)
        if self._leaf is not None:
            tok = torch.as_tensor(np.asarray(tokens, np.int32)[keep],
                                  device=dev)
            c_rows = self._centers[tok.long()]
            q8, scale = _row_quantize(x - c_rows)
            deq = q8.float() * scale[:, None] + c_rows
            self._db[idx] = q8
            self._row_scale[idx] = scale
            self._sq_norms[idx] = (deq * deq).sum(-1)
            self._leaf[idx] = tok
        elif self._inv_mult is not None:
            q8 = torch.clamp(torch.round(x / self._inv_mult[None, :]),
                             -127, 127).to(torch.int8)
            deq = q8.float() * self._inv_mult[None, :]
            self._db[idx] = q8
            self._sq_norms[idx] = (deq * deq).sum(-1)
        else:
            self._db[idx] = x.to(self._db.dtype)
            if self._sq_norms is not None:
                self._sq_norms[idx] = (x * x).sum(-1)

    def rescore(self, queries, candidate_idx):
        """(q, d) x (q, k_pre) -> (q, k_pre) exact similarities."""
        if self._leaf is not None:
            valid = candidate_idx >= 0
            safe = torch.where(valid, candidate_idx, 0).long()
            qd = dist_ops.one_to_many_gathered(
                queries, self._db, candidate_idx, cfg.DOT_PRODUCT)
            qd = qd * self._row_scale[safe]
            qc = queries @ self._centers.T                   # (q, L)
            bias = torch.gather(qc, 1, self._leaf[safe].long())
            dots = torch.where(valid, qd + bias, float("-inf"))
            if self.measure == cfg.DOT_PRODUCT:
                return dots
            q_sq = (queries * queries).sum(-1, keepdim=True)
            sim = -torch.clamp_min(
                q_sq - 2.0 * dots + self._sq_norms[safe], 0.0)
            return torch.where(valid, sim, float("-inf"))
        q, q_sq = queries, None
        if self._inv_mult is not None:
            # The multipliers fold into the query, so the cross term is
            # q . dequant(x); the query norm is the original query's.
            q = queries * self._inv_mult[None, :]
            q_sq = (queries * queries).sum(-1)
        elif self._db.dtype == torch.bfloat16:
            q = queries.to(torch.bfloat16)
            q_sq = (queries * queries).sum(-1)
        return dist_ops.one_to_many_gathered(
            q, self._db, candidate_idx, self.measure,
            db_sq_norms=self._sq_norms, query_sq_norms=q_sq)


def resolve_device(device) -> torch.device:
    """torch.device for an entry point.  CUDA must be present when asked
    for: there is no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Searcher:
    """Base searcher; subclasses implement _select_candidates()."""

    # Optional callable(stage_name), called on the host right after each
    # search stage has been enqueued ("tokenize", "plan", "score",
    # "merge" on the pruned path, "tokenize", "scan" on the dense scan,
    # then "reorder" when a reorder helper is set, then "finish");
    # chip_smoke.py records CUDA events with it.  Each stage's host span
    # (utils/profiling.py) ends at its call.
    stage_hook = None

    # Whether _apply_upsert / _apply_delete are served: brute force and
    # tree-AH; Tree-X refuses, as in the JAX package.
    _mutable = False

    def __init__(self, database: np.ndarray, scann_config: cfg.ScannConfig,
                 device: torch.device, docids=None):
        self.config = scann_config
        self.device = device
        self.n_points, self.dims = database.shape
        self.docids = list(docids) if docids is not None else None
        if self.docids is not None and len(self.docids) != self.n_points:
            raise ValueError("docids must have one entry per database row")
        # One upload shared by every build phase; typed (int8 / uint8)
        # rows stay 1 B a dimension and each phase casts what it gathers.
        # The upload puts the rows on the device: the first part of the
        # ``layout`` phase.
        if database.dtype not in (np.int8, np.uint8):
            database = np.asarray(database, np.float32)
        with profiling.phase("layout"):
            self._build_x_dev = torch.as_tensor(database, device=device)
            if self.docids is not None and device.type == "cpu":
                # Mutation writes the index rows in place: never the
                # caller's.
                self._build_x_dev = self._build_x_dev.clone()
        self.reorder_helper = None
        self._reorder_deferred = False
        self._crowding_attrs = None
        ro = scann_config.reordering
        if ro is not None:
            # Reordering rescores against the original (unprojected) rows.
            if (ro.quantize == cfg.INT8 and ro.residual
                    and scann_config.partitioning is not None
                    and scann_config.projection is None):
                # Residual int8 rows need the final primary tokens: the
                # subclass build calls _finish_deferred_reorder.
                self._reorder_deferred = True
            else:
                with profiling.phase("quantize"):
                    self.reorder_helper = ReorderHelper(
                        self._build_x_dev,
                        cfg.internal_measure(scann_config.distance_measure),
                        ro)
        self.projector = None
        if scann_config.projection is not None:
            from scann_torch.ops import projection as proj_ops
            self.projector = proj_ops.train_projection(
                database, scann_config.projection, seed=scann_config.seed,
                device=device)
        self._enable_mutation(database, self.docids)

    def _project_database(self, x_dev):
        """The rows the index is built on: the projection of the uploaded
        database (float32), or the upload itself."""
        if self.projector is None:
            return x_dev
        return self.projector.project(x_dev)

    def _project_queries(self, queries):
        """Queries in the index's (possibly projected) space."""
        if self.projector is None:
            return queries
        return self.projector.project(queries)

    @property
    def query_dims(self) -> int:
        """Width of the queries a search takes (before any projection)."""
        return self.dims

    @property
    def _index_dims(self) -> int:
        """Width of the rows the index is built on."""
        return self.dims if self.projector is None else \
            self.projector.out_dims

    def set_metadata(self, getter):
        """Attach a data.dataset.MetadataGetter; ``metadata_for`` then
        looks up the payloads of result indices."""
        self._metadata = getter

    def metadata_for(self, indices):
        """Per-neighbor metadata payloads for a result index array (None
        for invalid indices)."""
        getter = getattr(self, "_metadata", None)
        if getter is None:
            raise ValueError("call set_metadata(getter) first")
        idx = np.asarray(indices)
        flat = [getter.get(int(i)) if i >= 0 else None
                for i in idx.reshape(-1)]
        return np.asarray(flat, dtype=object).reshape(idx.shape)

    def _finish_deferred_reorder(self, x_dev, tokens):
        """Create the residual int8 reorder helper once the primary
        tokenization exists."""
        if not self._reorder_deferred:
            return
        with profiling.phase("quantize"):
            self.reorder_helper = ReorderHelper(
                x_dev, cfg.internal_measure(self.config.distance_measure),
                self.config.reordering, residual_tokens=tokens,
                centers=self.partitioner.centers)
        self._reorder_deferred = False

    def _stage(self, name: str):
        if self.stage_hook is not None:
            self.stage_hook(name)

    def set_crowding(self, attributes):
        """Attach per-datapoint crowding attributes, (n_points,) or
        (n_points, num_dims) int32; searches then cap their results per
        attribute with ``per_crowding_attribute_num_neighbors`` (after the
        reorder) and ``per_crowding_attribute_pre_reordering_num_neighbors``
        (before it): an int, or one int per dimension."""
        attributes = np.asarray(attributes, np.int32)
        if attributes.ndim == 1:
            attributes = attributes[:, None]
        if attributes.ndim != 2 or attributes.shape[0] != self.n_points:
            raise ValueError(
                f"crowding attributes must have shape ({self.n_points},) "
                f"or ({self.n_points}, num_dims)")
        self._crowding_attrs = torch.as_tensor(attributes,
                                               device=self.device)

    def _crowd(self, sim, idx, limits):
        attrs = self._crowding_attrs[torch.clamp_min(idx, 0).long()]
        return topk_ops.crowding_filter_multi(sim, idx, attrs, limits)

    # -------------------------------------------------------- overridables
    def _select_candidates(self, queries, k_pre: int, leaves: int,
                           full_scan: bool = False, restrict=None,
                           pre_tokenized=None):
        """Return (similarities, indices), each (q, >= k_pre), best-first
        not required; indices may contain INVALID_INDEX."""
        raise NotImplementedError

    def _default_leaves(self) -> int:
        return 0

    @property
    def _pruned_available(self) -> bool:
        return False

    def _dedup(self, vals, dpids, k_pre: int):
        """Candidates after the selection's last stage; SOAR overrides it."""
        return vals, dpids

    def _pruned_select(self, queries, k_pre: int, leaves: int, restrict,
                       pre_tokenized=None):
        """Leaf-gathered candidate selection: tokenize -> plan -> score ->
        merge, one span and stage mark each, then the engine's dedup.  An
        engine with a pruned_scan.PrunedLayout in ``_layout`` supplies
        _pruned_tokenize(queries, leaves, pre_tokenized) -> (leaf ids, valid
        mask, per-pair bias or None); _pruned_queries(queries) -> (the
        scorer's queries, the queries of the squared-L2 restore or None,
        whether the scorer takes them as gathered query groups);
        _pruned_budget(k_pre) -> (k_fetch, kpg); and _pruned_score(plan,
        queries, query groups, bias, kpg) -> the packed survivors."""
        with profiling.span("tokenize"):
            leaves = max(1, min(leaves, self.partitioner.num_leaves))
            leaf_ids, valid_sel, pair_bias = self._pruned_tokenize(
                queries, leaves, pre_tokenized)
            self._stage("tokenize")
        with profiling.span("plan"):
            q_op, q_l2, grouped = self._pruned_queries(queries)
            plan, bias, hot = pruned_scan.plan_batch(self._layout, leaf_ids,
                                                     valid_sel, restrict)
            qg_rows = q_op[plan.qg_query.long()] if grouped else None
            k_fetch, kpg = self._pruned_budget(k_pre)
            self._stage("plan")
        with profiling.span("score"):
            packed = self._pruned_score(plan, q_op, qg_rows, bias, kpg)
            self._stage("score")
        with profiling.span("merge"):
            vals, dpids = pruned_scan.candidates(
                self._layout, plan, packed, leaf_ids, valid_sel, k_fetch,
                pair_bias, hot, q_l2)
            self._stage("merge")
        return self._dedup(vals, dpids, k_pre)

    def _register_centers(self, centers_np: np.ndarray):
        """Install a grown center set on the partitioner (its int8 copy
        requantized, each new leaf assigned to its nearest upper cluster,
        or nearest two under the upper tree's SOAR) and propagate
        num_leaves through part_cfg and config."""
        part = self.partitioner
        centers = torch.as_tensor(centers_np, dtype=torch.float32,
                                  device=self.device)
        centers_int8 = inv_mult = None
        if part.centers_int8 is not None:
            sq = quant_ops.scalar_quantize(centers)
            centers_int8, inv_mult = sq.data, sq.inverse_multipliers
        upper_assign = part.upper_assign
        if upper_assign is not None and centers_np.shape[0] > \
                upper_assign.shape[0]:
            up = part.upper_centers.cpu().numpy()
            new_c = centers_np[upper_assign.shape[0]:]
            d = ((new_c[:, None, :] - up[None, :, :]) ** 2).sum(-1)
            if upper_assign.dim() == 2:
                add = np.argsort(d, axis=1)[:, :2]
            else:
                add = d.argmin(1)
            upper_assign = torch.cat([upper_assign, torch.from_numpy(
                add.astype(np.int32)).to(upper_assign.device)])
        self.partitioner = part._replace(
            centers=centers, centers_int8=centers_int8,
            centers_inv_mult=inv_mult, upper_assign=upper_assign)
        if (self.reorder_helper is not None
                and self.reorder_helper._leaf is not None):
            self.reorder_helper._centers = self.partitioner.centers
        self.part_cfg = dataclasses.replace(
            self.part_cfg, num_leaves=centers_np.shape[0])
        self.config = dataclasses.replace(self.config,
                                          partitioning=self.part_cfg)
        mutations = getattr(self, "_leaf_mutations", None)
        if mutations is not None and centers_np.shape[0] > len(mutations):
            self._leaf_mutations = np.concatenate([mutations, np.zeros(
                (centers_np.shape[0] - len(mutations),), np.int64)])

    # ------------------------------------------------------------ pipeline
    def _search_impl(self, queries, k: int, k_pre: int, leaves: int,
                     full_scan: bool = False, restrict=None,
                     pre_tokenized=None, k_pre_vec=None, pre_epsilon=None,
                     crowding_limit=(), pre_crowding_limit=()):
        """Select, reorder and finish one device batch.  Before the exact
        rescore, the best-first candidates are cut per query
        (``k_pre_vec``), by the approximate similarity (``pre_epsilon``,
        in similarity units) and by pre-reorder crowding; crowding after
        it caps the final results."""
        # Selection runs in the (possibly projected) index space; the
        # exact reorder takes the original queries.
        sim, idx = self._select_candidates(self._project_queries(queries),
                                           k_pre, leaves,
                                           full_scan=full_scan,
                                           restrict=restrict,
                                           pre_tokenized=pre_tokenized)
        if self.reorder_helper is not None:
            with profiling.span("reorder"):
                # Keep the best k_pre, rescore exactly, then the final k.
                if sim.shape[-1] > k_pre:
                    sim, pos = topk_ops.top_k(sim, k_pre)
                    idx = torch.gather(idx, -1, pos.long())
                if k_pre_vec is not None:
                    # Best first, a per-query k_pre is a column mask.
                    sim, idx = topk_ops.sort_results(sim, idx)
                    col = torch.arange(sim.shape[-1], device=sim.device)
                    keep = col[None, :] < k_pre_vec[:, None]
                    sim = torch.where(keep, sim, float("-inf"))
                    idx = torch.where(keep, idx, topk_ops.INVALID_INDEX)
                if pre_epsilon is not None:
                    keep = sim >= pre_epsilon[:, None]
                    sim = torch.where(keep, sim, float("-inf"))
                    idx = torch.where(keep, idx, topk_ops.INVALID_INDEX)
                if pre_crowding_limit:
                    sim, idx = self._crowd(sim, idx, pre_crowding_limit)
                sim = self.reorder_helper.rescore(queries, idx)
                self._stage("reorder")
        with profiling.span("finish"):
            if crowding_limit:
                sim, idx = self._crowd(sim, idx, crowding_limit)
            kk = min(k, sim.shape[-1])
            vals, pos = topk_ops.top_k(sim, kk)
            idx = torch.gather(idx, -1, pos.long())
            idx = torch.where(torch.isneginf(vals), topk_ops.INVALID_INDEX,
                              idx)
            dist = dist_ops.similarity_to_user_distance(
                vals, self.config.distance_measure)
            dist = torch.where(idx == topk_ops.INVALID_INDEX, float("nan"),
                               dist)
            if kk < k:
                pad = k - kk
                idx = torch.nn.functional.pad(idx, (0, pad),
                                              value=topk_ops.INVALID_INDEX)
                dist = torch.nn.functional.pad(dist, (0, pad),
                                               value=float("nan"))
            self._stage("finish")
        return idx, dist

    def _resolve_params(self, final_num_neighbors, pre_reorder_num_neighbors,
                        leaves_to_search):
        k = self.config.num_neighbors
        if final_num_neighbors is not None and final_num_neighbors > 0:
            k = final_num_neighbors
        if self.reorder_helper is not None:
            k_pre = self.reorder_helper.config.reordering_num_neighbors
        else:
            k_pre = k
        if (pre_reorder_num_neighbors is not None
                and pre_reorder_num_neighbors > 0):
            k_pre = pre_reorder_num_neighbors
        k_pre = max(k_pre, k)
        leaves = self._default_leaves()
        if leaves_to_search is not None and leaves_to_search > 0:
            leaves = leaves_to_search
        return k, k_pre, leaves

    def _crowding_limits(self, limit, name: str, what: str):
        """Per-dimension crowding caps of one search parameter (() when
        not given)."""
        if limit is None:
            return ()
        if self._crowding_attrs is None:
            raise ValueError(f"call set_crowding(attributes) before "
                             f"searching with {name}")
        num_dims = self._crowding_attrs.shape[1]
        if np.isscalar(limit):
            return (int(limit),) * num_dims
        limits = tuple(int(x) for x in limit)
        if len(limits) != num_dims:
            raise ValueError(f"expected {num_dims} {what}limits, got "
                             f"{len(limits)}")
        return limits

    def _check_pre_tokenized(self, leaves_arr, nq: int, num_leaves: int):
        if num_leaves == 0:
            raise ValueError(
                "pre_tokenized_leaves requires a partitioned searcher")
        pt = np.asarray(leaves_arr, np.int32)
        if pt.ndim != 2 or pt.shape[0] != nq:
            raise ValueError(f"pre_tokenized_leaves must be (num_queries, "
                             f"L), got {pt.shape}")
        if pt.max() >= num_leaves:
            raise ValueError("pre_tokenized leaf id out of range")
        if pt.shape[1] > num_leaves:
            # The pruned plan's capacities are sized from min(L,
            # num_leaves): a wider list would drop candidates.
            raise ValueError(
                f"pre_tokenized_leaves is wider ({pt.shape[1]}) than "
                f"num_leaves ({num_leaves})")
        srt = np.sort(np.where(pt < 0, -np.arange(1, pt.shape[1] + 1)[
            None, :], pt), axis=1)
        if np.any(srt[:, 1:] == srt[:, :-1]):
            # The plan assumes distinct leaves per row.
            raise ValueError(
                "pre_tokenized_leaves rows must not repeat a leaf id")
        return pt

    # ------------------------------------------------------------- public
    def search_batched(self, queries, final_num_neighbors=None,
                       pre_reorder_num_neighbors=None, leaves_to_search=None,
                       restrict_allowlist=None,
                       per_crowding_attribute_num_neighbors=None,
                       pre_tokenized_leaves=None,
                       post_reordering_epsilon=None,
                       pre_reordering_epsilon=None,
                       per_crowding_attribute_pre_reordering_num_neighbors
                       =None):
        """Batched search; dispatches and blocks for the results."""
        return self.search_batched_async(
            queries, final_num_neighbors, pre_reorder_num_neighbors,
            leaves_to_search, restrict_allowlist,
            per_crowding_attribute_num_neighbors, pre_tokenized_leaves,
            post_reordering_epsilon, pre_reordering_epsilon,
            per_crowding_attribute_pre_reordering_num_neighbors).result()

    def search_batched_async(self, queries, final_num_neighbors=None,
                             pre_reorder_num_neighbors=None,
                             leaves_to_search=None, restrict_allowlist=None,
                             per_crowding_attribute_num_neighbors=None,
                             pre_tokenized_leaves=None,
                             post_reordering_epsilon=None,
                             pre_reordering_epsilon=None,
                             per_crowding_attribute_pre_reordering_num_neighbors
                             =None):
        """Batched search; returns a PendingSearch whose .result() is
        (indices, distances), numpy arrays of shape (num_queries, k).

        restrict_allowlist: optional (n_points,) bool mask of datapoints
        results may come from.  per_crowding_attribute_num_neighbors and
        per_crowding_attribute_pre_reordering_num_neighbors: caps on the
        results (after the reorder) and candidates (before it) sharing an
        attribute of set_crowding.  pre_tokenized_leaves: (num_queries, L)
        int32 leaves to search per query in place of the tokenizer's, -1
        entries unused.  post_reordering_epsilon / pre_reordering_epsilon:
        distance cutoffs on the final results and on the approximate
        candidates before the reorder (dot product keeps dot >= epsilon,
        the other measures distance <= epsilon).  final_num_neighbors,
        pre_reorder_num_neighbors and both epsilons also take one value a
        query; the batch is sized by the largest and the rest apply as
        masks.

        The call is the ``search`` span of utils/profiling.py, and the
        handle's result() the ``result`` span of the same batch id."""
        batch = profiling.batch_id()
        with profiling.span("search", batch):
            finalize = self._dispatch(
                queries, final_num_neighbors, pre_reorder_num_neighbors,
                leaves_to_search, restrict_allowlist,
                per_crowding_attribute_num_neighbors, pre_tokenized_leaves,
                post_reordering_epsilon, pre_reordering_epsilon,
                per_crowding_attribute_pre_reordering_num_neighbors)
        return PendingSearch(finalize, batch)

    def _dispatch(self, queries, final_num_neighbors,
                  pre_reorder_num_neighbors, leaves_to_search,
                  restrict_allowlist, per_crowding_attribute_num_neighbors,
                  pre_tokenized_leaves, post_reordering_epsilon,
                  pre_reordering_epsilon,
                  per_crowding_attribute_pre_reordering_num_neighbors):
        """Check, upload and enqueue one batch (a split batch: each of its
        sub-batches) and, on a CUDA device, its result copy; returns the
        function that gives the results on the host."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ValueError(f"queries must be 2d, got shape {queries.shape}")
        nq = queries.shape[0]

        def _vec_param(v, name):
            """An int or a (num_queries,) array -> (the max, the array)."""
            if v is None or np.isscalar(v):
                return v, None
            arr = np.asarray(v, np.int32)
            if arr.shape != (nq,):
                raise ValueError(
                    f"{name} must be an int or a (num_queries,) array, "
                    f"got shape {arr.shape}")
            return int(arr.max()), arr

        final_num_neighbors, k_vec = _vec_param(final_num_neighbors,
                                                "final_num_neighbors")
        pre_reorder_num_neighbors, k_pre_vec = _vec_param(
            pre_reorder_num_neighbors, "pre_reorder_num_neighbors")
        if self.config.distance_measure == cfg.COSINE:
            # Cosine is the dot product of unit vectors: the factory
            # normalized the database.
            norms = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(norms, 1e-20)
        if queries.shape[1] != self.dims:
            raise ValueError(
                f"query dimensionality {queries.shape[1]} does not match "
                f"database dimensionality {self.dims}")
        k, k_pre, leaves = self._resolve_params(
            final_num_neighbors, pre_reorder_num_neighbors, leaves_to_search)
        crowding_limit = self._crowding_limits(
            per_crowding_attribute_num_neighbors,
            "per_crowding_attribute_num_neighbors", "crowding ")
        pre_crowding_limit = self._crowding_limits(
            per_crowding_attribute_pre_reordering_num_neighbors,
            "per_crowding_attribute_pre_reordering_num_neighbors",
            "pre-reordering crowding ")
        num_leaves = getattr(getattr(self, "part_cfg", None), "num_leaves",
                             0) or 0
        pre_tok = None
        if pre_tokenized_leaves is not None:
            pre_tok = self._check_pre_tokenized(pre_tokenized_leaves, nq,
                                                num_leaves)
            leaves = pre_tok.shape[1]
        full_scan = (pre_tok is None
                     and (leaves == 0 or leaves >= (num_leaves or 1 << 30)))
        pruned = not full_scan and self._pruned_available
        disp_cap = pruned_dispatch_cap(leaves) if pruned else nq
        if pruned and nq > disp_cap:
            # The pruned plan's scratch grows with batch * leaves: enqueue
            # every sub-batch, then materialize.  Per-query arrays are
            # sliced with their queries.
            def _sl(v, i):
                if v is None or np.isscalar(v):
                    return v
                return np.asarray(v)[i:i + disp_cap]

            pending = [self.search_batched_async(
                queries[i:i + disp_cap],
                final_num_neighbors if k_vec is None else _sl(k_vec, i),
                (pre_reorder_num_neighbors if k_pre_vec is None
                 else _sl(k_pre_vec, i)),
                leaves_to_search, restrict_allowlist,
                per_crowding_attribute_num_neighbors,
                None if pre_tok is None else _sl(pre_tok, i),
                _sl(post_reordering_epsilon, i),
                _sl(pre_reordering_epsilon, i),
                per_crowding_attribute_pre_reordering_num_neighbors)
                for i in range(0, nq, disp_cap)]

            def _combine():
                outs = [p.result() for p in pending]
                dist = np.concatenate([o[1] for o in outs], axis=0)
                if self.docids is not None:
                    return [row for o in outs for row in o[0]], dist
                return np.concatenate([o[0] for o in outs], axis=0), dist

            return _combine
        dev = self.device
        copies = _BatchCopies(dev) if dev.type == "cuda" else None
        if copies is None:
            def upload(x):
                return torch.as_tensor(x, device=dev)
        else:
            upload = copies.upload
        restrict = None
        if restrict_allowlist is not None:
            allow = np.asarray(restrict_allowlist, bool)
            if allow.shape != (self.n_points,):
                raise ValueError(
                    f"restrict_allowlist must have shape ({self.n_points},)")
            restrict = upload(allow)
        k_pre_dev = None
        if k_pre_vec is not None:
            floor = k_vec if k_vec is not None else k
            k_pre_dev = upload(np.maximum(k_pre_vec, floor))
        pre_eps = None
        if pre_reordering_epsilon is not None:
            eps = np.broadcast_to(np.asarray(pre_reordering_epsilon,
                                             np.float32), (nq,))
            # User distance -> similarity cutoff: dot keeps sim >= eps,
            # squared L2 (sim = -d) sim >= -eps, cosine (d = 1 - sim)
            # sim >= 1 - eps.
            if self.config.distance_measure == cfg.DOT_PRODUCT:
                sim_eps = eps
            elif self.config.distance_measure == cfg.COSINE:
                sim_eps = 1.0 - eps
            else:
                sim_eps = -eps
            pre_eps = upload(np.array(sim_eps, np.float32))
        q_dev = upload(queries)
        if leaves > 0 and num_leaves:
            leaves = min(leaves, num_leaves)
        idx_dev, dist_dev = self._search_impl(
            q_dev, k, k_pre, leaves, full_scan=full_scan, restrict=restrict,
            pre_tokenized=None if pre_tok is None else upload(pre_tok),
            k_pre_vec=k_pre_dev, pre_epsilon=pre_eps,
            crowding_limit=crowding_limit,
            pre_crowding_limit=pre_crowding_limit)
        if copies is None:
            def fetch():
                return idx_dev.cpu().numpy(), dist_dev.cpu().numpy()
        else:
            fetch = copies.download(idx_dev, dist_dev)

        def _finalize():
            idx, dist = fetch()
            if post_reordering_epsilon is not None:
                eps = np.broadcast_to(np.asarray(post_reordering_epsilon,
                                                 np.float32), (nq,))[:, None]
                # NaN-safe: a NaN distance stays dropped.
                if self.config.distance_measure == cfg.DOT_PRODUCT:
                    bad = ~(dist >= eps)
                else:
                    bad = ~(dist <= eps)
                idx = np.where(bad, topk_ops.INVALID_INDEX, idx)
                dist = np.where(bad, np.nan, dist)
            if k_vec is not None:
                # Results are best first: a per-query k is a column mask.
                bad = np.arange(idx.shape[1])[None, :] >= k_vec[:, None]
                idx = np.where(bad, topk_ops.INVALID_INDEX, idx)
                dist = np.where(bad, np.nan, dist)
            if self.docids is not None:
                # Lists of docids, None at invalid slots.
                return ([[self.docids[j] if j >= 0 else None for j in row]
                         for row in idx], dist)
            return idx, dist

        return _finalize

    def search_batched_parallel(self, queries, final_num_neighbors=None,
                                pre_reorder_num_neighbors=None,
                                leaves_to_search=None, batch_size=256,
                                **kwargs):
        """The reference API's name for search_batched (one device batch
        already fills the card; ``batch_size`` is accepted and unused)."""
        del batch_size
        return self.search_batched(queries, final_num_neighbors,
                                   pre_reorder_num_neighbors,
                                   leaves_to_search, **kwargs)

    def search(self, q, final_num_neighbors=None,
               pre_reorder_num_neighbors=None, leaves_to_search=None,
               **kwargs):
        """Single-query search."""
        q = np.asarray(q, dtype=np.float32)
        if q.ndim != 1:
            raise ValueError(f"query must be 1d, got shape {q.shape}")
        idx, dist = self.search_batched(q[None, :], final_num_neighbors,
                                        pre_reorder_num_neighbors,
                                        leaves_to_search, **kwargs)
        return idx[0], dist[0]

    # ---------------------------------------------------------- mutation
    def _mutation_state(self):
        if getattr(self, "_mut", None) is None:
            raise ValueError("upsert/delete require the searcher to be "
                             "built with docids")
        return self._mut

    def _enable_mutation(self, database, docids):
        from scann_torch import mutation
        self._mut = (mutation.MutationState(database, docids)
                     if docids is not None else None)

    def _refuse_mutation(self):
        """Searchers without mutation refuse before any state changes (the
        JAX package appends the rows first, then raises)."""
        if not self._mutable:
            raise NotImplementedError(
                f"{type(self).__name__} does not support dynamic updates yet")

    def upsert(self, docids, database, batch_size=1):
        """Insert rows under new docids, or overwrite the rows of known
        ones.  Past the partitioning's incremental threshold the searcher
        rebalances (mode "online") or runs incremental_maintenance (mode
        "online_incremental")."""
        del batch_size
        from scann_torch import mutation
        if not isinstance(docids, list):
            docids = [docids]
        vecs = np.asarray(database, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if self.config.distance_measure == cfg.COSINE:
            vecs = vecs / np.maximum(
                np.linalg.norm(vecs, axis=1, keepdims=True), 1e-20)
        st = self._mutation_state()
        self._refuse_mutation()
        existing = mutation.resolve_upsert_ids(st, docids, len(vecs))
        ids = existing.copy()
        for i in np.nonzero(existing >= 0)[0]:
            # Updates in call order: a docid given twice keeps its last row.
            st.vectors[existing[i]] = vecs[i]
            st.alive[existing[i]] = True
        new = np.nonzero(existing < 0)[0]
        if len(new):
            # New docids take the next ids in call order (one append: the
            # mirror is copied once a call, not once a row).
            ids[new] = st.append(vecs[new])
            for i in new:
                st.docid_to_id[docids[i]] = int(ids[i])
                self.docids.append(docids[i])
        self._apply_upsert(ids, vecs)
        self.n_points = len(st.vectors)
        st.mutations_since_rebuild += len(vecs)
        part_cfg = getattr(self, "part_cfg", None)
        if mutation.incremental_threshold_exceeded(part_cfg, st,
                                                   self.n_points):
            if (part_cfg.incremental_mode == "online_incremental"
                    and hasattr(self, "incremental_maintenance")):
                self.incremental_maintenance()
                st.mutations_since_rebuild = 0
            else:
                self.rebalance()

    def delete(self, docids):
        """Tombstone rows by docid.  Under "online_incremental", past the
        threshold, incremental_maintenance merges drained leaves away.  An
        unknown or repeated docid raises before any row is deleted."""
        from scann_torch import mutation
        if not isinstance(docids, list):
            docids = [docids]
        st = self._mutation_state()
        self._refuse_mutation()
        seen = set()
        for d in docids:
            if d not in st.docid_to_id or d in seen:
                raise ValueError(f"unknown docid: {d!r}")
            seen.add(d)
        ids = []
        for d in docids:
            i = st.docid_to_id.pop(d)
            st.alive[i] = False
            ids.append(i)
        self._apply_delete(np.asarray(ids, np.int64))
        st.mutations_since_rebuild += len(ids)
        part_cfg = getattr(self, "part_cfg", None)
        if (mutation.incremental_threshold_exceeded(part_cfg, st,
                                                    self.n_points)
                and part_cfg.incremental_mode == "online_incremental"
                and hasattr(self, "incremental_maintenance")):
            self.incremental_maintenance()
            st.mutations_since_rebuild = 0

    def rebalance(self):
        """Retrain and rebuild the index from the live rows on the same
        device, dropping tombstones; rows are renumbered."""
        st = self._mutation_state()
        live, keep = st.live_database()
        docids = [self.docids[i] for i in keep]
        from scann_torch import factory
        fresh = factory.create_searcher(live, self.config, self.device,
                                        docids=docids)
        self.__dict__.update(fresh.__dict__)

    def _apply_upsert(self, ids: np.ndarray, vecs: np.ndarray):
        raise NotImplementedError(
            f"{type(self).__name__} does not support dynamic updates yet")

    def _apply_delete(self, ids: np.ndarray):
        raise NotImplementedError(
            f"{type(self).__name__} does not support dynamic updates yet")

    def get_health_stats(self):
        """Partition imbalance and quantization error, as a dict."""
        from scann_torch.utils import health
        return health.compute_health_stats(self).as_dict()

    def initialize_health_stats(self):
        """Stats are derived on demand: nothing to initialize."""
        return None

    def serialize(self, artifacts_dir):
        """Write scann_config.json + scann_assets.npz (the JAX package's
        format; either package loads the result)."""
        from scann_torch.utils import serialization
        serialization.save_searcher(self, artifacts_dir)

