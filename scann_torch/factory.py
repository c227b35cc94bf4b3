"""Searcher factory: config -> searcher (port of scann_tpu/factory.py).

asymmetric_hash, with or without partitioning -> TreeAHSearcher;
partitioning + brute_force -> TreeXSearcher (residual-int8 tree-SQ, or
float32 / bfloat16 / global-int8 dense leaves); brute_force alone ->
BruteForceSearcher (float32, int8 or bfloat16 rows).  Any of them may
reorder (float32, bfloat16, residual or per-dimension int8 rows).  Cosine
runs as dot product over unit rows (normalized here) and unit queries;
L1 is float32 brute force only (config.py refuses the rest).  Every other
composition raises NotImplementedError naming the ROADMAP item that will
port it; no setting is silently dropped.  Typed (int8 / uint8) input
datasets are cast to float32 (item 11 ports their native rows).
"""

from __future__ import annotations

import numpy as np

from scann_torch import config as cfg
from scann_torch.models import base


def check_supported(scann_config: cfg.ScannConfig, device=None, dims=None,
                    rows=None):
    """Raise NotImplementedError for any setting the port does not serve.
    The port serves every width and index size on every device; ``device``,
    ``dims`` and ``rows`` are accepted for the loader's and the
    constructor's calls."""
    del device, dims, rows
    c = scann_config
    if c.autopilot is not None:
        base.not_ported("autopilot", 17)
    if c.projection is not None:
        base.not_ported("projection", 16)
    if c.asymmetric_hash is not None:
        from scann_torch.models import tree_ah
        tree_ah.check_supported(c)
    if c.partitioning is None:
        return
    if c.partitioning.incremental_threshold is not None:
        base.not_ported("incremental_threshold (mutation)", 15)


def create_searcher(database, scann_config: cfg.ScannConfig, device,
                    docids=None):
    """Build a searcher from a config on ``device``."""
    if docids is not None:
        base.not_ported("docids", 15)
    dev = base.resolve_device(device)
    database = np.asarray(database, dtype=np.float32)
    if database.ndim != 2:
        raise ValueError(f"database must be 2d, got shape {database.shape}")
    check_supported(scann_config, dev, database.shape[1], database.shape[0])
    if scann_config.distance_measure == cfg.COSINE:
        # Cosine = dot product over unit vectors (queries normalize at
        # search time, base.Searcher.search_batched).
        norms = np.linalg.norm(database, axis=1, keepdims=True)
        database = database / np.maximum(norms, 1e-20)
    if scann_config.asymmetric_hash is not None:
        from scann_torch.models import tree_ah
        return tree_ah.TreeAHSearcher(database, scann_config, dev)
    if scann_config.partitioning is not None:
        from scann_torch.models import tree_x
        return tree_x.TreeXSearcher(database, scann_config, dev)
    from scann_torch.models import brute_force
    return brute_force.BruteForceSearcher(database, scann_config, dev)
