"""Searcher export: ``torch.export`` programs that search with no searcher.

Port of scann_tpu/export.py onto ``torch.export``:

  * ``save_exported_searcher(path, searcher, ...)`` traces the searcher's
    search (``_search_impl``) at one operating point (k, pre-reorder
    candidates, leaves) for each power-of-two query bucket and writes
    ``search_b{B}.pt2`` (``torch.export.save``), with the index tensors
    held in the program as its constants, and ``meta.json``.
  * ``load_exported_searcher(path)`` reloads them with ``torch.export.load``
    and searches without building a searcher: a batch pads to the
    smallest bucket that holds it, and a larger batch runs in chunks of
    the largest bucket.

The kernels appear in the programs as calls to the custom ops of
ops/library.py (their fake implementations give the shapes while
tracing), so a loading process imports that module (this one does) and a
program runs on the device it was exported on: the kernels on a CUDA
export, their plain versions on a CPU one.  ``meta.json`` records that
device under ``"platforms"`` and whether the fused merge (K6,
``SCANN_TORCH_FUSED_MERGE=1`` at export time) is baked in.  The JAX
package's StableHLO exports are neither read nor written here.

Scope, as in the JAX package: one operating point per export; per-query
parameters, restricts and crowding stay on the live searcher's API, and
results are integer datapoint ids (docids are a live-searcher feature).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

# Registers the kernels' custom ops for torch.export.load.
from scann_torch.ops import library  # noqa: F401

_META = "meta.json"


def _next_bucket(n: int) -> int:
    """The power-of-two query bucket (at least 8) that holds n queries."""
    b = 8
    while b < n:
        b *= 2
    return b


def _program_file(bucket: int) -> str:
    return f"search_b{bucket}.pt2"


class _SearchProgram(torch.nn.Module):
    """forward(queries) -> (indices int32, distances f32) of one batch at
    a fixed operating point."""

    def __init__(self, searcher, k: int, k_pre: int, leaves: int,
                 full_scan: bool):
        super().__init__()
        self._searcher = searcher
        self._args = (k, k_pre, leaves, full_scan)

    def forward(self, queries):
        k, k_pre, leaves, full_scan = self._args
        return self._searcher._search_impl(queries, k, k_pre, leaves,
                                           full_scan=full_scan)


def save_exported_searcher(path: str, searcher, batch_sizes=(1024,),
                           final_num_neighbors=None,
                           pre_reorder_num_neighbors=None,
                           leaves_to_search=None):
    """Export the search of ``searcher`` at one operating point, one
    program per query bucket (the next power of two of each of
    ``batch_sizes``).  Returns the list of buckets."""
    k, k_pre, leaves = searcher._resolve_params(
        final_num_neighbors, pre_reorder_num_neighbors, leaves_to_search)
    num_leaves = getattr(getattr(searcher, "part_cfg", None), "num_leaves",
                         0) or 0
    full_scan = leaves == 0 or leaves >= (num_leaves or 1 << 30)
    if leaves > 0 and num_leaves:
        leaves = min(leaves, num_leaves)
    os.makedirs(path, exist_ok=True)
    buckets = sorted({_next_bucket(b) for b in batch_sizes})
    program = _SearchProgram(searcher, k, k_pre, leaves, full_scan)
    hook, searcher.stage_hook = searcher.stage_hook, None
    try:
        for bucket in buckets:
            prepare = getattr(searcher, "_prepare_for_query", None)
            if prepare is not None:
                # Build the lazy layouts this bucket reads before tracing.
                prepare(bucket, leaves, full_scan)
            q = torch.zeros((bucket, searcher.query_dims),
                            dtype=torch.float32, device=searcher.device)
            ep = torch.export.export(program, (q,), strict=False)
            torch.export.save(ep, os.path.join(path, _program_file(bucket)))
    finally:
        searcher.stage_hook = hook
    with open(os.path.join(path, _META), "w") as f:
        json.dump({"buckets": buckets, "k": k, "k_pre": k_pre,
                   "leaves": leaves, "dims": int(searcher.query_dims),
                   "distance_measure": searcher.config.distance_measure,
                   "platforms": [searcher.device.type],
                   "fused_merge": os.environ.get(
                       "SCANN_TORCH_FUSED_MERGE", "0") == "1"}, f)
    return buckets


class ExportedSearcher:
    """Search over a save_exported_searcher directory: the exported
    programs alone, no searcher object."""

    def __init__(self, path: str):
        with open(os.path.join(path, _META)) as f:
            self.meta = json.load(f)
        self.device = torch.device(self.meta["platforms"][0])
        self._programs = {
            bucket: torch.export.load(
                os.path.join(path, _program_file(bucket))).module()
            for bucket in self.meta["buckets"]}

    def search_batched(self, queries):
        """Returns (indices, distances), numpy arrays of shape
        (num_queries, k)."""
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        if self.meta["distance_measure"] == "cosine":
            queries = queries / np.maximum(
                np.linalg.norm(queries, axis=1, keepdims=True), 1e-20)
        fits = [b for b in self.meta["buckets"] if b >= nq]
        if not fits:
            big = max(self.meta["buckets"])
            outs = [self.search_batched(queries[i:i + big])
                    for i in range(0, nq, big)]
            return (np.concatenate([o[0] for o in outs]),
                    np.concatenate([o[1] for o in outs]))
        bucket = min(fits)
        if bucket != nq:
            queries = np.pad(queries, ((0, bucket - nq), (0, 0)))
        with torch.no_grad():
            idx, dist = self._programs[bucket](
                torch.from_numpy(queries).to(self.device))
        return idx[:nq].cpu().numpy(), dist[:nq].cpu().numpy()


def load_exported_searcher(path: str) -> ExportedSearcher:
    return ExportedSearcher(path)
