"""Exact brute-force searchers over float32, int8 or bfloat16 rows (port of
scann_tpu/models/brute_force.py): the float32 one is the benchmark's exact
ground truth.

* float32: the queries times the rows in full float32;
* int8: rows scalar-quantized with per-dimension multipliers
  (ops/quantize.py), which fold into the query, so the product is
  q * inv_mult . int8 rows; squared L2 takes the stored norms of the
  dequantized rows and the original query's norm;
* bfloat16: rows rounded to bf16 and multiplied with the bf16 query (the
  products are exact in f32), squared L2 with the float32 rows' norms;
* L1 (float32 only): the elementwise |q - x| sum, whose (queries, chunk,
  d) block sets the chunk: the database axis is cut d times finer.

* typed (int8 / uint8) input rows under float32 scoring: the rows stay
  1 B a dimension on the device and each scoring chunk converts exactly
  to float32 (squared L2 takes the norms of the float cast);
* with a projection, the projected float32 rows (the reorder, if any,
  rescores the original rows).

The database axis is scored in chunks whose score block stays under
_MAX_SCORES entries, each chunk's top-k merged into the running one.
"""

from __future__ import annotations

import numpy as np
import torch

from scann_torch import config as cfg
from scann_torch.models import base
from scann_torch.ops import distance as dist_ops
from scann_torch.ops import quantize as quant_ops
from scann_torch.ops import topk as topk_ops
from scann_torch.utils import profiling

# Chunk the database axis so one chunk's score block stays under ~256M
# entries (1 GiB of f32); chunk top-ks are merged.
_MAX_SCORES = 1 << 28


class BruteForceSearcher(base.Searcher):
    """Exact search over a float32, bfloat16 or int8 copy of the dataset."""

    _mutable = True

    def __init__(self, database: np.ndarray, scann_config: cfg.ScannConfig,
                 device: torch.device, docids=None):
        super().__init__(database, scann_config, device, docids)
        x = self._project_database(self._build_x_dev)
        self.quantize_mode = scann_config.brute_force.quantize
        self._inv_mult = None
        self._sq_norms = None
        with profiling.phase("quantize"):
            if x.dtype in (torch.int8, torch.uint8):
                # Typed rows; ops/distance converts each scoring chunk
                # exactly.
                self._db = x
                if cfg.internal_measure(scann_config.distance_measure) \
                        == cfg.SQUARED_L2:
                    self._sq_norms = (x.float() ** 2).sum(-1)
            elif self.quantize_mode == cfg.INT8:
                sq = quant_ops.scalar_quantize(x)
                self._db = sq.data
                self._inv_mult = sq.inverse_multipliers
                self._sq_norms = sq.sq_norms
            elif self.quantize_mode == cfg.BFLOAT16:
                self._db = quant_ops.bfloat16_quantize(x)
                self._sq_norms = (x * x).sum(-1)
            else:
                self._db = x
        self._valid = torch.ones((x.shape[0],), dtype=torch.bool,
                                 device=device)
        self._build_x_dev = None

    # ----------------------------------------------------------- mutation
    def _apply_upsert(self, ids: np.ndarray, vecs: np.ndarray):
        """Write rows ``ids`` (growing the capacity by a fifth at least):
        int8 rows with the build's multipliers, typed rows rounded and
        clipped to their dtype, bf16 / float32 rows with their norms.  A
        repeated id keeps its last row."""
        keep = base.last_positions(ids)
        raw = np.asarray(vecs, np.float32)
        dev = self._db.device
        x = self._project_database(torch.as_tensor(raw[keep], device=dev))
        cap = self._db.shape[0]
        need = int(ids.max()) + 1
        if need > cap:
            grow = max(need - cap, cap // 5 + 1)
            self._db = torch.cat([self._db, self._db.new_zeros(
                (grow, self._db.shape[1]))])
            if self._sq_norms is not None:
                self._sq_norms = torch.cat([self._sq_norms,
                                            self._sq_norms.new_zeros(grow)])
            self._valid = torch.cat([self._valid,
                                     self._valid.new_zeros(grow)])
        idx = torch.as_tensor(ids[keep], device=dev).long()
        if self.quantize_mode == cfg.INT8:
            q = torch.clamp(torch.round(x / self._inv_mult[None, :]),
                            -127, 127).to(torch.int8)
            deq = q.float() * self._inv_mult[None, :]
            self._db[idx] = q
            self._sq_norms[idx] = (deq * deq).sum(-1)
        elif self._db.dtype in (torch.int8, torch.uint8):
            info = torch.iinfo(self._db.dtype)
            q = torch.clamp(torch.round(x), info.min, info.max).to(
                self._db.dtype)
            self._db[idx] = q
            if self._sq_norms is not None:
                self._sq_norms[idx] = (q.float() ** 2).sum(-1)
        else:
            self._db[idx] = x.to(self._db.dtype)
            if self._sq_norms is not None:
                self._sq_norms[idx] = (x * x).sum(-1)
        self._valid[idx] = True
        if self.reorder_helper is not None:
            self.reorder_helper.ensure_capacity(need)
            self.reorder_helper.update_rows(ids, raw)

    def _apply_delete(self, ids: np.ndarray):
        self._valid[torch.as_tensor(ids, device=self._valid.device).long()] \
            = False

    def _query_operand(self, queries):
        """(the query operand of the product, the original queries' squared
        norms where the product's query is not the original)."""
        if self._inv_mult is not None:
            return (queries * self._inv_mult[None, :],
                    (queries * queries).sum(-1))
        if self._db.dtype == torch.bfloat16:
            return queries.to(torch.bfloat16), (queries * queries).sum(-1)
        return queries, None

    def _select_candidates(self, queries, k_pre, leaves, full_scan=False,
                           restrict=None, pre_tokenized=None):
        del leaves, full_scan, pre_tokenized
        with profiling.span("scan"):
            nq = queries.shape[0]
            n, d = self._db.shape
            measure = cfg.internal_measure(self.config.distance_measure)
            valid = self._valid
            if restrict is not None:
                # Rows past n_points are spare capacity.
                valid = valid & torch.nn.functional.pad(
                    restrict, (0, n - restrict.shape[0]), value=False)
            q, q_sq = self._query_operand(queries)
            # L1 has no product form: its (q, chunk, d) block is the live cost.
            cost = d if measure == cfg.L1 else 1
            k = min(k_pre, n)
            chunk = min(n, max(1, _MAX_SCORES // max(nq * cost, 1)))
            vals = idx = None
            for start in range(0, n, chunk):
                cs = slice(start, start + chunk)
                sim = dist_ops.similarity(
                    q, self._db[cs], measure,
                    db_sq_norms=(None if self._sq_norms is None
                                 else self._sq_norms[cs]),
                    query_sq_norms=q_sq)
                cvals, cpos = topk_ops.chunk_top_k(
                    sim, min(k, sim.shape[1]), valid=valid[cs][None, :])
                cidx = torch.where(cpos >= 0, start + cpos,
                                   topk_ops.INVALID_INDEX)
                if vals is None:
                    vals, idx = cvals, cidx
                else:
                    vals, idx = topk_ops.merge_top_k(vals, idx, cvals, cidx, k)
            self._stage("scan")
        return vals, idx
