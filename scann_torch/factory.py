"""Searcher factory: config -> searcher (port of scann_tpu/factory.py).

asymmetric_hash, with or without partitioning -> TreeAHSearcher;
partitioning + brute_force -> TreeXSearcher (residual-int8 tree-SQ, or
float32 / bfloat16 / global-int8 dense leaves); brute_force alone ->
BruteForceSearcher (float32, int8 or bfloat16 rows).  Any of them may
reorder (float32, bfloat16, residual or per-dimension int8 rows).  Cosine
runs as dot product over unit rows (normalized here) and unit queries;
L1 is float32 brute force only (config.py refuses the rest).  A
projection (pca, eigenvalue OPQ, truncate, random orthogonal) applies
before any of them.  Typed (int8 / uint8) databases stay typed where the
JAX package's rule keeps them (brute force and Tree-X without a
reorder, a projection or cosine) and are cast to float32 everywhere
else, where the JAX package casts them.  An autopilot config is rewritten
into one of these compositions first (utils/autopilot.py), on the
normalized rows under cosine, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from scann_torch import config as cfg
from scann_torch.models import base


def check_supported(scann_config: cfg.ScannConfig, device=None, dims=None,
                    rows=None):
    """Raise ValueError for a tree-AH setting no searcher serves.  The port
    serves every width and index size on every device; ``device``,
    ``dims`` and ``rows`` are accepted for the loader's and the
    constructor's calls."""
    del device, dims, rows
    c = scann_config
    if c.asymmetric_hash is not None:
        from scann_torch.models import tree_ah
        tree_ah.check_supported(c)


def typed_ok(database: np.ndarray, scann_config: cfg.ScannConfig) -> bool:
    """True when an int8 / uint8 database is built and searched without a
    float32 copy (the JAX package's rule): brute force, or Tree-X with
    float32 or residual-int8 leaves, with no AH, reorder, projection,
    autopilot or cosine."""
    c = scann_config
    return (database.dtype in (np.int8, np.uint8)
            and c.asymmetric_hash is None
            and c.reordering is None
            and c.projection is None
            and c.autopilot is None
            and c.distance_measure != cfg.COSINE
            and (c.brute_force is None
                 or c.brute_force.quantize in (None, cfg.FLOAT32)
                 or (c.partitioning is not None
                     and c.brute_force.quantize == cfg.INT8)))


def create_searcher(database, scann_config: cfg.ScannConfig, device,
                    docids=None):
    """Build a searcher from a config on ``device``.  ``database`` is an
    (n, d) array or a data.dataset.DenseDataset, whose docids serve when
    ``docids`` is None.  With docids, results are lists of docids and the
    searcher takes upsert / delete / rebalance (brute force and tree-AH)."""
    from scann_torch.data import dataset as dataset_mod
    if isinstance(database, dataset_mod.DenseDataset):
        if docids is None:
            docids = database.docids
        database = database.data
    dev = base.resolve_device(device)
    database = np.asarray(database)
    if not typed_ok(database, scann_config) and \
            database.dtype != np.float32:
        database = np.asarray(database, dtype=np.float32)
    if database.ndim != 2:
        raise ValueError(f"database must be 2d, got shape {database.shape}")
    if scann_config.distance_measure == cfg.COSINE:
        # Cosine = dot product over unit vectors (queries normalize at
        # search time, base.Searcher.search_batched).
        norms = np.linalg.norm(database, axis=1, keepdims=True)
        database = database / np.maximum(norms, 1e-20)
    if scann_config.autopilot is not None:
        from scann_torch.utils import autopilot
        scann_config = autopilot.autopilot_rewrite(scann_config, database)
    check_supported(scann_config, dev, database.shape[1], database.shape[0])
    if scann_config.asymmetric_hash is not None:
        from scann_torch.models import tree_ah
        return tree_ah.TreeAHSearcher(database, scann_config, dev, docids)
    if scann_config.partitioning is not None:
        from scann_torch.models import tree_x
        return tree_x.TreeXSearcher(database, scann_config, dev, docids)
    from scann_torch.models import brute_force
    return brute_force.BruteForceSearcher(database, scann_config, dev,
                                          docids)
