"""Top-k selection, crowding and SOAR's duplicate suppression (port of
scann_tpu/ops/topk.py).

The JAX package switches to ``jax.lax.approx_max_k`` for chunks wider than
8192 columns; torch has no approximate top-k, so every selection here is
exact (ROADMAP section 3 records the deviation).  The crowding filters and
dedup_candidates rank with stable sorts, so equal scores keep the JAX
package's order.
"""

from __future__ import annotations

import torch

# Invalid-candidate sentinel in result index arrays.
INVALID_INDEX = -1


_LOW32 = 0xFFFFFFFF


def top_k(scores, k):
    """Per-row exact top-k of a (..., n) float32 similarity array, best
    first, equal values in index order (``jax.lax.top_k``'s tie rule, which
    ``torch.topk`` does not promise).  Each entry becomes one int64 key,
    order-preserving float bits above the complemented column index, so a
    single ``torch.topk`` decides both.  Returns (values, int32 indices)."""
    n = scores.shape[-1]
    k = min(k, n)
    bits = scores.float().contiguous().view(torch.int32).long()
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # float order
    col = torch.arange(n, dtype=torch.int64, device=scores.device)
    keys = (bits << 32) | (_LOW32 - col)
    top = torch.topk(keys, k, dim=-1).values
    pos = _LOW32 - (top & _LOW32)
    return torch.gather(scores, -1, pos), pos.to(torch.int32)


def top_k_with_invalid(scores, k, valid=None):
    """top_k that first masks invalid entries to -inf and reports them as
    INVALID_INDEX in the output indices."""
    if valid is not None:
        scores = torch.where(valid, scores, float("-inf"))
    vals, idx = top_k(scores, k)
    idx = torch.where(torch.isneginf(vals), INVALID_INDEX, idx)
    return vals, idx


def chunk_top_k(scores, k, valid=None):
    """Per-chunk candidate selection (exact; see the module note)."""
    return top_k_with_invalid(scores, k, valid=valid)


def merge_top_k(vals_a, idx_a, vals_b, idx_b, k):
    """Merge two per-row candidate lists into the best k by similarity."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    v, pos = top_k(vals, k)
    return v, torch.gather(idx, -1, pos.long())


def _take(a, pos):
    return torch.gather(a, -1, pos)


def sort_results(vals, idx):
    """Best-first order, equal values in position order; invalid entries
    (-inf) go last."""
    order = torch.sort(-vals, dim=-1, stable=True).indices
    return _take(vals, order), _take(idx, order)


def crowding_rank(vals, idx, attrs):
    """Rank of each candidate by score among the candidates of its row that
    share its attribute (0 = best), in the input's positions; invalid
    candidates rank after every valid one.  Two stable sorts, by score
    descending and then by attribute, lay each attribute's run out best
    first; the rank is the distance from the run's start."""
    masked = torch.where(idx == INVALID_INDEX, float("-inf"), vals)
    order1 = torch.sort(-masked, dim=-1, stable=True).indices
    a1 = _take(attrs, order1)
    order2 = torch.sort(a1, dim=-1, stable=True).indices
    perm = _take(order1, order2)
    a = _take(attrs, perm)
    pos = torch.arange(a.shape[-1], device=a.device).expand(a.shape)
    run_break = torch.ones_like(a, dtype=torch.bool)
    run_break[..., 1:] = a[..., 1:] != a[..., :-1]
    run_start = torch.cummax(torch.where(run_break, pos, 0), dim=-1).values
    rank = pos - run_start
    return torch.empty_like(rank).scatter_(-1, perm, rank)


def crowding_filter(vals, idx, attrs, limit: int):
    """Keep the best ``limit`` candidates of each attribute per row; the
    rest (and invalid entries) become -inf / INVALID_INDEX in place."""
    rank = crowding_rank(vals, idx, attrs)
    drop = (rank >= limit) | (idx == INVALID_INDEX)
    return (torch.where(drop, float("-inf"), vals),
            torch.where(drop, INVALID_INDEX, idx))


def crowding_filter_multi(vals, idx, attrs, limits):
    """Crowding over several attribute dimensions: attrs (q, k, A), one
    limit per dimension.  A candidate survives when its rank within its
    attribute is under the limit in every dimension (the JAX package's
    conservative intersection of the per-dimension filters)."""
    keep = idx != INVALID_INDEX
    for a in range(attrs.shape[-1]):
        rank = crowding_rank(vals, idx, attrs[..., a])
        keep = keep & (rank < int(limits[a]))
    return (torch.where(keep, vals, float("-inf")),
            torch.where(keep, idx, INVALID_INDEX))


def dedup_candidates(vals, idx):
    """Drop repeated ids per row (SOAR stores a row in two leaves), keeping
    the best-scored copy.  Two stable sorts, by score descending and then
    by id, put each id's copies together best first; later copies and
    invalid entries become -inf / INVALID_INDEX.  The output is in id
    order, as the JAX package's."""
    order1 = torch.sort(-vals, dim=-1, stable=True).indices
    idx1, vals1 = _take(idx, order1), _take(vals, order1)
    order2 = torch.sort(idx1, dim=-1, stable=True).indices
    idx2, vals2 = _take(idx1, order2), _take(vals1, order2)
    dup = torch.zeros_like(idx2, dtype=torch.bool)
    dup[..., 1:] = idx2[..., 1:] == idx2[..., :-1]
    dup = dup | (idx2 == INVALID_INDEX)
    return (torch.where(dup, float("-inf"), vals2),
            torch.where(dup, INVALID_INDEX, idx2))
