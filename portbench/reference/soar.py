"""A plain reference of SOAR spilled assignment and of the search over
its leaves, in float32 torch with TF32 off, written from the paper: Sun
et al., "SOAR: Improved Indexing for Approximate Nearest Neighbor
Search", NeurIPS 2023 (arXiv:2404.00774), section 3; ScaNN's
``DatabaseSpillingConfig`` with ``TWO_CENTER_ORTHOGONALITY_AMPLIFIED``.
It imports torch only: neither JAX nor the package under test.

``assign(rows, centers, lam)``: each row x goes to

* its primary center c, the nearest by squared L2;
* its secondary center c', the argmin over every other center of the
  orthogonality-amplified residual loss

      ||r'||^2 + lam * <r', r>^2 / ||r||^2,   r = x - c,  r' = x - c'.

``search(rows, queries, centers, assignment, leaves, k)``: the
leaf-restricted exact answer.  Each query searches its ``leaves`` best
centers by the tree's query tokenization for the dot product: the
largest float32 dot products q . c, exactly (no approximate top-k, no
upper tree, no query spilling); a row is a candidate when its primary or
its secondary center is among them, and it counts once.  The answer is
the candidates' exact top k by dot product: float32 products pick 32
candidates a query, re-ranked in float64 (larger is nearer; the
distance is the dot product itself).

The comparisons that hold a program to it: ``compare_assignment`` (the
program's two centers a row against ``assign``'s, each disagreement
judged in float64), ``outside_searched`` (returned ids in none of the
query's searched leaves), ``repeated`` (rows that name an id twice) and
``recall`` (against an answer such as ``search``'s).

Departures from the paper, each a choice the paper leaves open:

* A row that lies on its primary center (r = 0) has no direction to
  amplify: its loss is ||r'||^2 alone (the ratio is taken as 0).
* Ties of the argmin go to the lowest center index, in both
  assignments.
* The squared distances are formed as ||x||^2 - 2 x . c + ||c||^2 in
  float32, a product the GPU computes fast; two centers whose float64
  distances differ by less than float32's rounding of that sum may come
  out in either order (``sq_dist64`` and ``soar_loss64`` give the float64
  values a comparison judges such a near-tie by).
* Only the one extra center of the paper's main method; lam is its
  hyperparameter, taken as given (1.5 in the benchmark).
"""

from __future__ import annotations

import contextlib

import torch

CANDIDATES = 32          # float32 candidates a query, re-ranked in float64
# Two primaries differ at a float32 tie when their float64 squared
# distances lie within this much of each other, relative to ||x||^2 +
# ||c||^2: a few float32 roundings of the expanded sum.
F32_TIE = 2.0 ** -20
# Two secondaries differ at a near-tie of the SOAR loss when their float64
# losses lie within this much of each other, relative to the reference's.
LOSS_TIE = 1e-5


@contextlib.contextmanager
def tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _sq_dist32(x, centers):
    """(b, c) float32 squared distances of rows x to every center."""
    return ((x * x).sum(1, keepdim=True) - 2.0 * (x @ centers.T)
            + (centers * centers).sum(1)[None, :])


def assign(rows, centers, lam: float, block: int = 32768):
    """(n, 2) int64: each row's primary and secondary center."""
    rows, centers = rows.float(), centers.float()
    out = []
    with tf32_off():
        for i in range(0, rows.shape[0], block):
            x = rows[i:i + block]
            d2 = _sq_dist32(x, centers)
            prim = torch.argmin(d2, dim=1)
            r = x - centers[prim]
            r_sq = (r * r).sum(1, keepdim=True)
            # <r', r> = <x - c', r> = <x, r> - <c', r>
            proj = (x * r).sum(1, keepdim=True) - r @ centers.T
            ratio = torch.where(r_sq > 0, proj * proj
                                / torch.where(r_sq > 0, r_sq, 1.0), 0.0)
            loss = d2 + lam * ratio
            loss[torch.arange(len(x), device=x.device), prim] = float("inf")
            out.append(torch.stack([prim, torch.argmin(loss, dim=1)], 1))
    return torch.cat(out)


def sq_dist64(rows, centers, ids):
    """(n, j) float64 squared distances of each row to its centers
    ``ids`` (n, j)."""
    x = rows.double()[:, None, :]
    c = centers.double()[ids]
    return ((x - c) ** 2).sum(-1)


def soar_loss64(rows, centers, primary, ids, lam: float):
    """(n, j) float64 SOAR loss of each row's candidate secondaries
    ``ids`` (n, j), given its primary (n,)."""
    x = rows.double()
    r = x - centers.double()[primary]
    r_sq = (r * r).sum(1, keepdim=True)
    rp = x[:, None, :] - centers.double()[ids]
    proj = (rp * r[:, None, :]).sum(-1)
    ratio = torch.where(r_sq > 0, proj * proj
                        / torch.where(r_sq > 0, r_sq, 1.0), 0.0)
    return (rp * rp).sum(-1) + lam * ratio


def center_scores(queries, centers):
    """(m, c) float32 dot products of queries with the centers: the
    query tokenization's scores (larger is nearer)."""
    with tf32_off():
        return queries.float() @ centers.float().T


def select_leaves(queries, centers, leaves: int, tie: float = 0.0):
    """(chosen (m, leaves) int64, searched (m, c) bool): each query's
    ``leaves`` best centers, and the mask of centers whose score lies
    within ``tie`` of the last chosen one's or above (ties either way:
    with tie 0, the chosen centers and any exactly tied with the last)."""
    s = center_scores(queries, centers)
    chosen = torch.topk(s, leaves, dim=1).indices
    last = torch.gather(s, 1, chosen).amin(1, keepdim=True)
    return chosen, s >= last - tie


def search(rows, queries, centers, assignment, leaves: int, k: int,
           block: int = 1024):
    """(ids (m, k) int64, dot products (m, k) float64), best first: the
    leaf-restricted exact answer.  A query with fewer than k candidates
    pads with id -1 and -inf."""
    rows, queries = rows.float(), queries.float()
    prim, sec = assignment[:, 0], assignment[:, 1]
    out_i, out_d = [], []
    with tf32_off():
        for i in range(0, queries.shape[0], block):
            q = queries[i:i + block]
            chosen, _ = select_leaves(q, centers, leaves)
            picked = torch.zeros((len(q), centers.shape[0]), dtype=torch.bool,
                                 device=q.device)
            picked.scatter_(1, chosen, True)
            member = picked[:, prim] | picked[:, sec]
            s = q @ rows.T
            s = torch.where(member, s, float("-inf"))
            v, cand = torch.topk(s, min(CANDIDATES, rows.shape[0]), dim=1)
            d = (rows.double()[cand] * q.double()[:, None, :]).sum(-1)
            d = torch.where(torch.isneginf(v), float("-inf"), d)
            order = torch.sort(d, dim=1, descending=True,
                               stable=True).indices[:, :k]
            ids = torch.gather(cand, 1, order)
            d = torch.gather(d, 1, order)
            out_i.append(torch.where(torch.isneginf(d), -1, ids))
            out_d.append(d)
    return torch.cat(out_i), torch.cat(out_d)


def compare_assignment(rows, centers, lam: float, got, block: int = 32768):
    """Counts of how the assignment ``got`` ((n, 2): primary, secondary)
    stands against ``assign``'s on the same rows and centers:

      rows                    n
      secondary_is_primary    rows whose two centers are one
      primary_differ          rows with another primary
      primary_not_tied        ... whose two float64 squared distances lie
                              more than F32_TIE apart
      secondary_compared      rows with the same primary
      secondary_differ        ... with another secondary
      secondary_not_near_tie  ... whose two float64 SOAR losses lie more
                              than LOSS_TIE apart
    """
    out = dict.fromkeys(("secondary_is_primary", "primary_differ",
                         "primary_not_tied", "secondary_compared",
                         "secondary_differ", "secondary_not_near_tie"), 0)
    out["rows"] = int(rows.shape[0])
    got = torch.as_tensor(got, device=rows.device).long()
    for i in range(0, rows.shape[0], block):
        x = rows[i:i + block].float()
        g = got[i:i + block]
        want = assign(x, centers, lam, block)
        out["secondary_is_primary"] += int((g[:, 0] == g[:, 1]).sum())
        pd = g[:, 0] != want[:, 0]
        out["primary_differ"] += int(pd.sum())
        if pd.any():
            pair = torch.stack([g[pd, 0], want[pd, 0]], 1)
            d = sq_dist64(x[pd], centers, pair)
            scale = (x[pd].double() ** 2).sum(1) \
                + (centers.double()[pair] ** 2).sum(-1).amax(1)
            out["primary_not_tied"] += int(
                ((d[:, 0] - d[:, 1]).abs() > F32_TIE * scale).sum())
        same = ~pd
        out["secondary_compared"] += int(same.sum())
        sd = same & (g[:, 1] != want[:, 1])
        out["secondary_differ"] += int(sd.sum())
        if sd.any():
            pair = torch.stack([g[sd, 1], want[sd, 1]], 1)
            loss = soar_loss64(x[sd], centers, want[sd, 0], pair, lam)
            out["secondary_not_near_tie"] += int(
                ((loss[:, 0] - loss[:, 1]).abs()
                 > LOSS_TIE * loss[:, 1].abs()).sum())
    return out


def outside_searched(ids, queries, centers, assignment, leaves: int,
                     tie: float = 1e-6, block: int = 4096) -> int:
    """Returned ids ((m, k), -1 unused) that lie in none of their query's
    searched leaves: neither the row's primary nor its secondary among the
    query's ``leaves`` best centers, a center tied with the last one
    within ``tie`` x |q| x the largest |c| counting as searched either
    way."""
    ids = torch.as_tensor(ids, device=queries.device).long()
    c_norm = float(torch.linalg.norm(centers.float(), dim=1).max())
    bad = 0
    for i in range(0, queries.shape[0], block):
        q = queries[i:i + block].float()
        tol = tie * c_norm * torch.linalg.norm(q, dim=1, keepdim=True)
        s = center_scores(q, centers)
        chosen = torch.topk(s, leaves, dim=1).indices
        last = torch.gather(s, 1, chosen).amin(1, keepdim=True)
        searched = s >= last - tol
        got = ids[i:i + block]
        a = assignment[torch.clamp_min(got, 0)]
        hit = (torch.gather(searched, 1, a[..., 0])
               | torch.gather(searched, 1, a[..., 1]))
        bad += int((~hit & (got >= 0)).sum())
    return bad


def repeated(ids) -> int:
    """Rows of ``ids`` ((m, k), -1 unused) that name an id twice."""
    ids = torch.as_tensor(ids)
    srt = torch.sort(ids, dim=1).values
    return int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0))
               .any(1).sum())


def recall(ids, truth) -> float:
    """Share of ``truth``'s ids ((m, k), -1 unused) found in the same row
    of ``ids``."""
    ids = torch.as_tensor(ids, device=truth.device).long()
    hit = (ids[:, :, None] == truth[:, None, :]).any(1) & (truth >= 0)
    return float(hit.sum()) / max(int((truth >= 0).sum()), 1)
