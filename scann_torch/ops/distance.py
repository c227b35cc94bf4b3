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


def squared_l2(queries, database, db_sq_norms=None, query_sq_norms=None):
    """(q, d) x (n, d) -> (q, n) squared L2 distances via the
    ||q||^2 - 2 q.x + ||x||^2 expansion, clamped at 0.  ``db_sq_norms``
    may be stored ones (int8 rows keep the norms of their dequantized
    values); with an int8 database whose multipliers are folded into the
    query, pass ``query_sq_norms`` of the original queries."""
    if db_sq_norms is None:
        db_sq_norms = (database.float() ** 2).sum(-1)
    if query_sq_norms is None:
        query_sq_norms = (queries.float() ** 2).sum(-1)
    dots = dot_products(queries, database)
    d = query_sq_norms[:, None] - 2.0 * dots + db_sq_norms[None, :]
    return torch.clamp_min(d, 0.0)


def l1_distance(queries, database):
    """(q, d) x (n, d) -> (q, n) Manhattan distances: elementwise, no
    product decomposition, so callers chunk the database axis by d."""
    return (queries.float()[:, None, :]
            - database.float()[None, :, :]).abs().sum(-1)


def similarity(queries, database, measure, db_sq_norms=None,
               query_sq_norms=None):
    """Similarity scores, higher == closer, for dot product, squared L2 or
    L1."""
    if measure == cfg.DOT_PRODUCT:
        return dot_products(queries, database)
    if measure == cfg.SQUARED_L2:
        return -squared_l2(queries, database, db_sq_norms, query_sq_norms)
    if measure == cfg.L1:
        return -l1_distance(queries, database)
    raise ValueError(f"unsupported distance measure: {measure}")


def similarity_to_user_distance(sim, measure):
    """Internal similarity -> user distance: dot_product returns dot
    products, squared_l2 and l1 distances, cosine 1 - cos."""
    if measure == cfg.DOT_PRODUCT:
        return sim
    if measure == cfg.COSINE:
        return 1.0 - sim
    return -sim


def one_to_many_gathered(queries, database, candidate_idx, measure,
                         db_sq_norms=None, query_sq_norms=None):
    """Exact scores of per-query candidate lists (the reordering product).

    queries: (q, d); database: (n, d) of any float or int dtype;
    candidate_idx: (q, k) int32, -1 = invalid (-inf similarity).  Rows are
    gathered, converted to float32 and multiplied with their query in
    float32."""
    valid = candidate_idx >= 0
    safe = torch.where(valid, candidate_idx, 0).long()
    rows_f = database[safe.reshape(-1)].reshape(
        candidate_idx.shape + (database.shape[-1],)).float()
    q_f = queries.float()
    dots = torch.bmm(rows_f, q_f[:, :, None])[:, :, 0]      # (q, k)
    if measure == cfg.DOT_PRODUCT:
        sim = dots
    elif measure == cfg.SQUARED_L2:
        if db_sq_norms is None:
            row_sq = (rows_f * rows_f).sum(-1)
        else:
            row_sq = db_sq_norms[safe]
        if query_sq_norms is None:
            q_sq = (q_f * q_f).sum(-1, keepdim=True)
        else:
            q_sq = query_sq_norms[:, None]
        sim = -torch.clamp_min(q_sq - 2.0 * dots + row_sq, 0.0)
    else:
        raise ValueError(f"unsupported distance measure: {measure}")
    return torch.where(valid, sim, float("-inf"))
