"""Exact k nearest neighbours in plain torch: the benchmark's reference.

Float32 products with TF32 off, in blocks of queries, pick 32 candidates a
query; their distances are then recomputed in float64 directly from the
rows (sum of products, or sum of squared differences), and the best k of
those are the truth.  Nothing here imports the program under test, and
nothing takes anything the program has made: the rows and the queries are
the benchmark's own.

Measures: "dot_product" (larger is nearer; the distance is the dot
product itself, as the program reports it) and "squared_l2".
"""

from __future__ import annotations

import contextlib

import torch

CANDIDATES = 32


@contextlib.contextmanager
def tf32_off():
    """Float32 matmuls in float32, whatever the process had set."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def larger_is_nearer(measure: str) -> bool:
    if measure == "dot_product":
        return True
    if measure == "squared_l2":
        return False
    raise ValueError(f"unsupported measure {measure!r}")


def distances64(rows, queries, ids, measure: str):
    """Float64 distances of each query to its ids: (m, k) from rows (n, d),
    queries (m, d) and ids (m, k), all on one device."""
    x = rows[ids.reshape(-1)].reshape(ids.shape + (rows.shape[1],))
    x = x.double()
    q = queries.double()[:, None, :]
    if measure == "dot_product":
        return (x * q).sum(-1)
    if measure == "squared_l2":
        return ((x - q) ** 2).sum(-1)
    raise ValueError(f"unsupported measure {measure!r}")


def scale64(rows, queries, ids, measure: str):
    """The size of the numbers a distance is computed from (|q| |x| for
    the dot product, |q|^2 + |x|^2 for squared L2): the unit in which a
    rounding gap is read."""
    x = rows[ids.reshape(-1)].reshape(ids.shape + (rows.shape[1],))
    xn = (x.double() ** 2).sum(-1)
    qn = (queries.double() ** 2).sum(-1)[:, None]
    if measure == "dot_product":
        return torch.sqrt(xn * qn)
    return xn + qn


def exact_top_k(rows, queries, k: int, measure: str, block: int = 2048):
    """(ids (m, k) int64, distances (m, k) float64), best first."""
    nearer = larger_is_nearer(measure)
    out_ids, out_d = [], []
    with tf32_off():
        sq = (rows * rows).sum(-1) if measure == "squared_l2" else None
        for i in range(0, queries.shape[0], block):
            q = queries[i:i + block]
            s = q @ rows.T
            if sq is not None:
                s = 2.0 * s - sq[None, :]     # larger is nearer
            cand = torch.topk(s, min(CANDIDATES, rows.shape[0]),
                              dim=1).indices
            del s
            d = distances64(rows, q, cand, measure)
            order = torch.sort(d, dim=1, descending=nearer,
                               stable=True).indices[:, :k]
            out_ids.append(torch.gather(cand, 1, order))
            out_d.append(torch.gather(d, 1, order))
    return torch.cat(out_ids), torch.cat(out_d)
