"""Top-k selection (port of scann_tpu/ops/topk.py).

The JAX package switches to ``jax.lax.approx_max_k`` for chunks wider than
8192 columns; torch has no approximate top-k, so every selection here is
exact (ROADMAP section 3 records the deviation).
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
