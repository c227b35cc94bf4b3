"""Searcher factory: config -> searcher (port of scann_tpu/factory.py).

asymmetric_hash, with or without partitioning -> TreeAHSearcher (with
optional reordering); partitioning + brute_force(int8) -> TreeXSearcher
(residual-int8 tree-SQ); brute_force(float32) alone -> BruteForceSearcher.
Every other composition raises NotImplementedError naming the ROADMAP item
that will port it; no setting is silently dropped.
"""

from __future__ import annotations

import numpy as np

from scann_torch import config as cfg
from scann_torch.models import base
from scann_torch.partitioning import kmeans_tree


def check_supported(scann_config: cfg.ScannConfig):
    """Raise NotImplementedError for any setting the port does not serve."""
    c = scann_config
    if c.autopilot is not None:
        base.not_ported("autopilot", 17)
    if c.projection is not None:
        base.not_ported("projection", 16)
    if c.distance_measure not in (cfg.DOT_PRODUCT, cfg.SQUARED_L2):
        base.not_ported(f"distance measure {c.distance_measure!r}", 11)
    if c.asymmetric_hash is not None:
        from scann_torch.models import tree_ah
        tree_ah.check_supported(c)
    else:
        if c.reordering is not None:
            base.not_ported("reordering without score_ah", 12)
        quantize = c.brute_force.quantize
        if c.partitioning is None:
            if quantize != cfg.FLOAT32:
                base.not_ported(f"{quantize} brute force", 11)
            return
        if quantize != cfg.INT8:
            base.not_ported(f"Tree-X {quantize} leaves", 21)
        if c.partitioning.num_leaves <= 1:
            base.not_ported("single-leaf Tree-X (dense global-int8 leaves)",
                             21)
    if c.partitioning is None:
        return      # the non-partitioned AH searcher
    bad = kmeans_tree.unsupported_partitioning(c.partitioning)
    if bad is not None:
        base.not_ported(f"partitioning {bad}", 14)
    if c.partitioning.incremental_threshold is not None:
        base.not_ported("incremental_threshold (mutation)", 15)


def create_searcher(database, scann_config: cfg.ScannConfig, device,
                    docids=None):
    """Build a searcher from a config on ``device``."""
    if docids is not None:
        base.not_ported("docids", 15)
    check_supported(scann_config)
    dev = base.resolve_device(device)
    database = np.asarray(database, dtype=np.float32)
    if database.ndim != 2:
        raise ValueError(f"database must be 2d, got shape {database.shape}")
    if scann_config.asymmetric_hash is not None:
        from scann_torch.models import tree_ah
        return tree_ah.TreeAHSearcher(database, scann_config, dev)
    if scann_config.partitioning is not None:
        from scann_torch.models import tree_x
        return tree_x.TreeXSearcher(database, scann_config, dev)
    from scann_torch.models import brute_force
    return brute_force.BruteForceSearcher(database, scann_config, dev)
