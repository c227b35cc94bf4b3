"""Autopilot: a concrete config chosen from the corpus's shape.

Port of scann_tpu/utils/autopilot.py.  ``autopilot_rewrite`` turns a
config that holds only an ``AutopilotConfig`` into brute force, tree-AH or
tree-SQ, with the JAX package's rules and constants, so both packages
write the same config JSON for the same corpus shape.  Two heuristic sets
(``AutopilotConfig.heuristics``):

``"tpu"`` (the default; the name is the JAX package's):

  * about ``_TPU_LEAF_ROWS`` rows a leaf, capped at ``_TPU_TOKENIZE_CAP *
    sqrt(n)`` leaves (the query tokenization product grows with the leaf
    count), at least 16;
  * below 16 leaves' worth of rows, brute force;
  * leaves_to_search from a scanned-fraction curve for the configured
    ``target_recall``: ``_RECALL_CURVE`` for tree-AH (AH codes and the
    reorder lose a little below the candidate recall) and
    ``_RECALL_CURVE_SQ`` for tree-SQ (exact int8 scores: the end recall is
    about the candidate recall).  Both curves are recall figures measured
    on trees the JAX package built on a TPU for a glove-shaped corpus; the
    recall a tree reaches at a scanned fraction is a property of the
    partition, not of the device, and re-measuring the curves on the card
    waits for the port's benchmark (ROADMAP item 11);
  * engine "tree_sq" needs no reordering; "tree_ah" reorders
    ceil(max(2k, 100 sqrt(k))) candidates.

``"reference"``: the reference library's AutopilotTreeAh rules
(single_machine_autopilot.cc, defaults of auto_tuning.proto: l1_size
32768, l3_size 33554432):

  * below a minimum corpus size, brute force;
  * otherwise LUT16 AH with 2 dims a block, residual quantization and
    noise shaping 0.2 under dot product;
  * leaf size ~ 2 * ah_size * l1 / dim, floored at 2 * kmeans_stable_size;
  * partitions = n / leaf_size capped by the L3 bound and a training-time
    bound sqrt(60 * 32 * 2e9 / dim / 200);
  * leaves_to_search = ceil(42 * 2^(ln(tree / 42) / ln 10));
  * reorder = ceil(max(2k, 100 sqrt(k))).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from scann_torch import config as cfg

_L1_SIZE = 32768
_L3_SIZE = 33554432
_AH_SIZE = 2
_KMEANS_STABLE_SIZE = 100
_SAFETY = 2
_MAGIC = 42

# The JAX package's "tpu" constants, kept as they are: the rewritten
# configs must equal the JAX package's.
_TPU_LEAF_ROWS = 500       # rows a leaf
_TPU_TOKENIZE_CAP = 8.0    # num_leaves <= cap * sqrt(n)
# (candidate recall, scanned fraction of leaves) anchors for engines whose
# end recall sits below the candidate recall (AH codes + reorder).
_RECALL_CURVE = ((0.90, 0.04), (0.95, 0.075), (0.97, 0.12), (0.98, 0.20))
# End-to-end (recall@10, scanned fraction) anchors of the exact tree-SQ
# engine, read on one 2,338-leaf tree of the glove-shaped corpus (0.9305
# at 50 leaves, 0.9593 at 100, 0.9705 at 150, 0.9825 at 300).
_RECALL_CURVE_SQ = ((0.93, 0.021), (0.959, 0.043), (0.970, 0.064),
                    (0.9825, 0.128))


def _scan_fraction(target_recall: float, pts=_RECALL_CURVE) -> float:
    """Scanned-leaf fraction reaching ``target_recall`` (piecewise-linear
    over the anchors; 1.5x the last fraction beyond them)."""
    if target_recall <= pts[0][0]:
        return pts[0][1] * max(target_recall / pts[0][0], 0.25)
    for (r0, f0), (r1, f1) in zip(pts, pts[1:]):
        if target_recall <= r1:
            t = (target_recall - r0) / (r1 - r0)
            return f0 + t * (f1 - f0)
    return pts[-1][1] * 1.5


def autopilot_rewrite(config: cfg.ScannConfig, database: np.ndarray
                      ) -> cfg.ScannConfig:
    """Autopilot config + corpus -> a concrete config."""
    n, dim = database.shape
    if dim == 0:
        raise ValueError("Not supported: dim == 0.")
    k = config.num_neighbors
    auto = config.autopilot or cfg.AutopilotConfig()
    tpu_mode = getattr(auto, "heuristics", "tpu") != "reference"

    ah2_leaf_size = math.ceil(_AH_SIZE * 2 * _L1_SIZE / dim)
    ah2_leaf_size = max(ah2_leaf_size, _SAFETY * _KMEANS_STABLE_SIZE)
    approx_num_neighbors = math.ceil(
        max(1.0 * _SAFETY * k, 100 * math.sqrt(k)))
    if tpu_mode:
        # Below 16 leaves' worth of rows a partition buys nothing.
        treeah_bound = 16 * _TPU_LEAF_ROWS
    else:
        treeah_bound = max(_SAFETY * approx_num_neighbors,
                           _MAGIC * ah2_leaf_size)

    if n < treeah_bound:
        return cfg.ScannConfig(
            num_neighbors=k, distance_measure=config.distance_measure,
            brute_force=cfg.BruteForceConfig(), seed=config.seed)

    exact_sq = (auto.engine == "tree_sq"
                and config.distance_measure in (cfg.DOT_PRODUCT,
                                                cfg.COSINE))
    if tpu_mode:
        tree_size = min(n // _TPU_LEAF_ROWS,
                        math.ceil(_TPU_TOKENIZE_CAP * math.sqrt(n)))
        tree_size = max(tree_size, 16)
        frac = _scan_fraction(min(max(auto.target_recall, 0.5), 0.999),
                              _RECALL_CURVE_SQ if exact_sq
                              else _RECALL_CURVE)
        leaves_to_search = min(tree_size,
                               max(2, math.ceil(frac * tree_size)))
    else:
        l3_size_bound = math.ceil(_L3_SIZE / dim / 4)
        tree_size = n // ah2_leaf_size
        train_size_bound = math.ceil(math.sqrt(
            60.0 * 32 * 2e9 / dim / (_SAFETY * _KMEANS_STABLE_SIZE)))
        tree_size = min(tree_size, l3_size_bound, train_size_bound)
        tree_size = max(tree_size, 1)

        leaves_to_search = math.ceil(
            _MAGIC * math.pow(2.0, math.log(1.0 * tree_size / _MAGIC)
                              / math.log(10.0)))
        leaves_to_search = min(tree_size, leaves_to_search)

    partitioning = cfg.PartitioningConfig(
        num_leaves=tree_size,
        num_leaves_to_search=max(1, leaves_to_search),
        training_sample_size=tree_size * _KMEANS_STABLE_SIZE * _SAFETY,
        min_partition_size=10,
        training_iterations=10,
        random_init=True,
        incremental_threshold=(0.5 if auto.incremental_mode
                               in ("online", "online_incremental")
                               else None),
        incremental_mode=("online_incremental"
                          if auto.incremental_mode
                          == "online_incremental" else "online"))

    if exact_sq:
        # Residual-int8 tree-SQ leaves: exact int8 scores need no reorder.
        # The reference formula is sized for AH's overscan, so under it
        # tree-SQ searches a sixteenth of its leaves.
        if not tpu_mode:
            partitioning = dataclasses.replace(
                partitioning,
                num_leaves_to_search=max(
                    2, math.ceil(leaves_to_search / 16)))
        return cfg.ScannConfig(
            num_neighbors=k,
            distance_measure=config.distance_measure,
            partitioning=partitioning,
            brute_force=cfg.BruteForceConfig(quantize=cfg.INT8),
            seed=config.seed)

    residual = config.distance_measure == cfg.DOT_PRODUCT
    return cfg.ScannConfig(
        num_neighbors=k,
        distance_measure=config.distance_measure,
        partitioning=partitioning,
        asymmetric_hash=cfg.AsymmetricHashConfig(
            dimensions_per_block=_AH_SIZE,
            anisotropic_quantization_threshold=(0.2 if residual
                                                else math.nan),
            training_sample_size=16 * _KMEANS_STABLE_SIZE * _SAFETY * 10,
            training_iterations=10,
            residual_quantization=residual),
        reordering=cfg.ReorderConfig(
            reordering_num_neighbors=approx_num_neighbors,
            quantize=auto.reordering_dtype),
        seed=config.seed)
