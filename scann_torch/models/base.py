"""Searcher base: the search pipeline (port of scann_tpu/models/base.py).

``search_batched`` -> ``_select_candidates`` (per engine) -> final top-k,
conversion to user distance, and INVALID / NaN padding.  Torch runs
eagerly: a batch is enqueued on the device stream and ``PendingSearch``
copies the result to the host when asked.  Batches are not padded to
power-of-two buckets (that bounded JAX recompilation); per-query results
never depend on the batch they ride in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scann_torch import config as cfg
from scann_torch.ops import distance as dist_ops
from scann_torch.ops import topk as topk_ops


class PendingSearch:
    """Handle for an enqueued batched search; .result() waits for the
    device, copies (indices, distances) to the host and caches them."""

    __slots__ = ("_finalize", "_result")

    def __init__(self, finalize):
        self._finalize = finalize
        self._result = None

    def result(self):
        if self._finalize is not None:
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


# search_batched parameters of the JAX package that the port does not
# serve yet: passing any of them (not None) raises NotImplementedError.
_UNPORTED_PARAMS = ("per_crowding_attribute_num_neighbors",
                    "pre_tokenized_leaves", "post_reordering_epsilon",
                    "pre_reordering_epsilon",
                    "per_crowding_attribute_pre_reordering_num_neighbors")


def not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP item "
                              f"{item})")


class Searcher:
    """Base searcher; subclasses implement _select_candidates()."""

    # Optional callable(stage_name), called on the host right after each
    # search stage has been enqueued ("tokenize", "plan", "score",
    # "merge" on the pruned path, "tokenize", "scan" on the dense scan,
    # then "finish"); chip_smoke.py records CUDA events with it.
    stage_hook = None

    def __init__(self, database: np.ndarray, scann_config: cfg.ScannConfig,
                 device: torch.device):
        self.config = scann_config
        self.device = device
        self.n_points, self.dims = database.shape
        self._build_x_dev = torch.as_tensor(
            np.asarray(database, np.float32), device=device)

    def _stage(self, name: str):
        if self.stage_hook is not None:
            self.stage_hook(name)

    # -------------------------------------------------------- overridables
    def _select_candidates(self, queries, k_pre: int, leaves: int,
                           full_scan: bool = False, restrict=None):
        """Return (similarities, indices), each (q, >= k_pre), best-first
        not required; indices may contain INVALID_INDEX."""
        raise NotImplementedError

    def _default_leaves(self) -> int:
        return 0

    @property
    def _pruned_available(self) -> bool:
        return False

    def _register_centers(self, centers_np: np.ndarray):
        """Install a grown center set on the partitioner and propagate
        num_leaves through part_cfg and config."""
        self.partitioner = self.partitioner._replace(
            centers=torch.as_tensor(centers_np, dtype=torch.float32,
                                    device=self.device))
        self.part_cfg = dataclasses.replace(
            self.part_cfg, num_leaves=centers_np.shape[0])
        self.config = dataclasses.replace(self.config,
                                          partitioning=self.part_cfg)

    # ------------------------------------------------------------ pipeline
    def _search_impl(self, queries, k: int, k_pre: int, leaves: int,
                     full_scan: bool = False, restrict=None):
        sim, idx = self._select_candidates(queries, k_pre, leaves,
                                           full_scan=full_scan,
                                           restrict=restrict)
        kk = min(k, sim.shape[-1])
        vals, pos = topk_ops.top_k(sim, kk)
        idx = torch.gather(idx, -1, pos.long())
        idx = torch.where(torch.isneginf(vals), topk_ops.INVALID_INDEX, idx)
        dist = dist_ops.similarity_to_user_distance(
            vals, self.config.distance_measure)
        dist = torch.where(idx == topk_ops.INVALID_INDEX, float("nan"), dist)
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
        k_pre = k
        if (pre_reorder_num_neighbors is not None
                and pre_reorder_num_neighbors > 0):
            k_pre = pre_reorder_num_neighbors
        k_pre = max(k_pre, k)
        leaves = self._default_leaves()
        if leaves_to_search is not None and leaves_to_search > 0:
            leaves = leaves_to_search
        return k, k_pre, leaves

    # ------------------------------------------------------------- public
    def search_batched(self, queries, final_num_neighbors=None,
                       pre_reorder_num_neighbors=None, leaves_to_search=None,
                       restrict_allowlist=None, **unported):
        """Batched search; dispatches and blocks for the results."""
        return self.search_batched_async(
            queries, final_num_neighbors, pre_reorder_num_neighbors,
            leaves_to_search, restrict_allowlist, **unported).result()

    def search_batched_async(self, queries, final_num_neighbors=None,
                             pre_reorder_num_neighbors=None,
                             leaves_to_search=None, restrict_allowlist=None,
                             **unported):
        """Batched search; returns a PendingSearch whose .result() is
        (indices, distances), numpy arrays of shape (num_queries, k).

        restrict_allowlist: optional (n_points,) bool mask of datapoints
        results may come from.  The JAX package's other search parameters
        (per-query arrays, crowding, pre-tokenized leaves, epsilons) raise
        NotImplementedError when given."""
        for name, value in unported.items():
            if name not in _UNPORTED_PARAMS:
                raise TypeError(f"unexpected search parameter {name!r}")
            if value is not None:
                not_ported(f"search parameter {name}", 14)
        for name, value in (("final_num_neighbors", final_num_neighbors),
                            ("pre_reorder_num_neighbors",
                             pre_reorder_num_neighbors)):
            if value is not None and not np.isscalar(value):
                not_ported(f"per-query {name}", 14)
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ValueError(f"queries must be 2d, got shape {queries.shape}")
        if queries.shape[1] != self.dims:
            raise ValueError(
                f"query dimensionality {queries.shape[1]} does not match "
                f"database dimensionality {self.dims}")
        k, k_pre, leaves = self._resolve_params(
            final_num_neighbors, pre_reorder_num_neighbors, leaves_to_search)
        nq = queries.shape[0]
        num_leaves = getattr(getattr(self, "part_cfg", None), "num_leaves",
                             0)
        full_scan = leaves == 0 or leaves >= (num_leaves or 1 << 30)
        pruned = not full_scan and self._pruned_available
        disp_cap = pruned_dispatch_cap(leaves) if pruned else nq
        if pruned and nq > disp_cap:
            # The pruned plan's scratch grows with batch * leaves: enqueue
            # every sub-batch, then materialize.
            pending = [self.search_batched_async(
                queries[i:i + disp_cap], final_num_neighbors,
                pre_reorder_num_neighbors, leaves_to_search,
                restrict_allowlist) for i in range(0, nq, disp_cap)]

            def _combine():
                outs = [p.result() for p in pending]
                return (np.concatenate([o[0] for o in outs], axis=0),
                        np.concatenate([o[1] for o in outs], axis=0))

            return PendingSearch(_combine)
        restrict = None
        if restrict_allowlist is not None:
            allow = np.asarray(restrict_allowlist, bool)
            if allow.shape != (self.n_points,):
                raise ValueError(
                    f"restrict_allowlist must have shape ({self.n_points},)")
            restrict = torch.as_tensor(allow, device=self.device)
        q_dev = torch.as_tensor(queries, device=self.device)
        if leaves > 0 and num_leaves:
            leaves = min(leaves, num_leaves)
        idx_dev, dist_dev = self._search_impl(q_dev, k, k_pre, leaves,
                                              full_scan=full_scan,
                                              restrict=restrict)

        def _finalize():
            return idx_dev.cpu().numpy(), dist_dev.cpu().numpy()

        return PendingSearch(_finalize)

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

    def serialize(self, artifacts_dir):
        """Write scann_config.json + scann_assets.npz (the JAX package's
        format; either package loads the result)."""
        from scann_torch.utils import serialization
        serialization.save_searcher(self, artifacts_dir)

