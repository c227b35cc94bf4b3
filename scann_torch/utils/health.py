"""Index health statistics (port of scann_tpu/utils/health.py).

Partition imbalance (the weighted and the positive variant) over the rows'
tokens, and the root mean squared quantization error the tree-AH build
keeps over every slot it encoded.  Derived on demand from the index
arrays, so they follow every mutation.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HealthStats:
    partition_weighted_avg_relative_imbalance: float = 0.0
    partition_avg_relative_positive_imbalance: float = 0.0
    avg_quantization_error: float = 0.0
    sum_partition_sizes: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


def partition_imbalance(sizes: np.ndarray) -> tuple[float, float]:
    """(weighted average relative, average relative positive) imbalance of
    partition sizes."""
    sizes = np.asarray(sizes, np.float64)
    total = sizes.sum()
    if total == 0:
        return 0.0, 0.0
    n = len(sizes)
    weighted = float((sizes / total * sizes).sum() / (total / n) - 1.0)
    best = total / n
    over = sizes[sizes > best]
    positive = 0.0
    if len(over) > 0 and best > 0:
        positive = float((over - best).mean() / best)
    return weighted, positive


def compute_health_stats(searcher) -> HealthStats:
    """Health stats from a searcher's index arrays.  Every token column
    counts, so under SOAR a row counts in both its leaves (and
    ``sum_partition_sizes`` is twice the rows)."""
    stats = HealthStats()
    tokens = getattr(searcher, "datapoint_to_token", None)
    part_cfg = getattr(searcher, "part_cfg", None)
    if tokens is None or part_cfg is None:
        stats.sum_partition_sizes = searcher.n_points
        return stats
    flat = np.asarray(tokens).reshape(-1)
    flat = flat[flat >= 0]
    sizes = np.bincount(flat, minlength=part_cfg.num_leaves)
    stats.sum_partition_sizes = int(sizes.sum())
    w, p = partition_imbalance(sizes)
    stats.partition_weighted_avg_relative_imbalance = w
    stats.partition_avg_relative_positive_imbalance = p
    # The rms ||x - x_hat|| over the encoded slots (tree-AH).
    if (getattr(searcher, "model", None) is not None
            and hasattr(searcher, "_quantization_error_sq")):
        stats.avg_quantization_error = float(
            np.sqrt(searcher._quantization_error_sq))
    return stats
