"""Batched distances (port of scann_tpu/ops/distance.py).

Every scoring function returns **similarity** (higher is closer); the
user-facing sign is restored at the API boundary (models/base.py).
Products run in float32: on the GPU ``torch.matmul`` keeps full f32 unless
the caller enables TF32 (``torch.backends.cuda.matmul.allow_tf32``), which
the port never does.
"""

from __future__ import annotations

import torch

from scann_torch import config as cfg


def dot_products(queries, database):
    """(q, d) x (n, d) -> (q, n) float32 dot products."""
    return queries.float() @ database.float().T


def squared_l2(queries, database):
    """(q, d) x (n, d) -> (q, n) squared L2 distances via the
    ||q||^2 - 2 q.x + ||x||^2 expansion, clamped at 0."""
    db_sq_norms = (database.float() ** 2).sum(-1)
    query_sq_norms = (queries.float() ** 2).sum(-1)
    dots = dot_products(queries, database)
    d = query_sq_norms[:, None] - 2.0 * dots + db_sq_norms[None, :]
    return torch.clamp_min(d, 0.0)


def similarity(queries, database, measure):
    """Similarity scores, higher == closer, for dot product or squared L2."""
    if measure == cfg.DOT_PRODUCT:
        return dot_products(queries, database)
    if measure == cfg.SQUARED_L2:
        return -squared_l2(queries, database)
    raise ValueError(f"unsupported distance measure: {measure}")


def similarity_to_user_distance(sim, measure):
    """Internal similarity -> user distance: dot_product returns dot
    products, squared_l2 squared distances, cosine 1 - cos."""
    if measure == cfg.DOT_PRODUCT:
        return sim
    if measure == cfg.COSINE:
        return 1.0 - sim
    return -sim
