"""Exact float32 brute-force searcher (port of the float32 mode of
scann_tpu/models/brute_force.py): the exact ground truth of the benchmark.
int8 / bfloat16 / typed databases and the other measures are not ported
yet (ROADMAP item 11).
"""

from __future__ import annotations

import numpy as np
import torch

from scann_torch import config as cfg
from scann_torch.models import base
from scann_torch.ops import distance as dist_ops
from scann_torch.ops import topk as topk_ops

# Chunk the database axis so one chunk's score matrix stays under ~256M
# entries (1 GiB of f32); chunk top-ks are merged.
_MAX_SCORES = 1 << 28


class BruteForceSearcher(base.Searcher):
    """Exact search over a float32 copy of the dataset."""

    def __init__(self, database: np.ndarray, scann_config: cfg.ScannConfig,
                 device: torch.device):
        super().__init__(database, scann_config, device)
        self.quantize_mode = cfg.FLOAT32
        self._db = self._build_x_dev
        self._valid = torch.ones((self._db.shape[0],), dtype=torch.bool,
                                 device=device)
        self._build_x_dev = None

    def _select_candidates(self, queries, k_pre, leaves, full_scan=False,
                           restrict=None):
        del leaves, full_scan
        nq = queries.shape[0]
        n = self._db.shape[0]
        measure = cfg.internal_measure(self.config.distance_measure)
        valid = self._valid
        if restrict is not None:
            valid = valid & restrict
        k = min(k_pre, n)
        chunk = min(n, max(1, _MAX_SCORES // max(nq, 1)))
        vals = idx = None
        for start in range(0, n, chunk):
            sim = dist_ops.similarity(queries, self._db[start:start + chunk],
                                      measure)
            cvals, cpos = topk_ops.chunk_top_k(
                sim, min(k, sim.shape[1]),
                valid=valid[start:start + chunk][None, :])
            cidx = torch.where(cpos >= 0, start + cpos,
                               topk_ops.INVALID_INDEX)
            if vals is None:
                vals, idx = cvals, cidx
            else:
                vals, idx = topk_ops.merge_top_k(vals, idx, cvals, cidx, k)
        return vals, idx
