"""Batched k-means (port of scann_tpu/ops/kmeans.py).

Each Lloyd iteration is one (sample x centers) product + argmin, a
per-center ``index_add_``, and deterministic farthest-point reseeding of
clusters below the minimum size.  Random draws (sampling, initial centers)
come from a seeded ``torch.Generator`` on the CPU, so a build gives the
same partition on any device; they differ from ``jax.random``'s draws, so
the tests hand both packages the same initial centers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KMeansResult(NamedTuple):
    centers: torch.Tensor      # (k, d) f32
    assignments: torch.Tensor  # (n,) int32
    counts: torch.Tensor       # (k,) int32


def assign(x, centers, x_sq=None, *, block_rows=None):
    """Nearest-center (squared L2) assignment.  Returns (assignments int32,
    squared distance to the assigned center).  ``block_rows`` bounds the
    (rows, centers) f32 intermediate to block_rows * k * 4 bytes."""
    n = x.shape[0]
    if block_rows is not None and n > block_rows:
        parts = [assign(x[i:i + block_rows], centers,
                        None if x_sq is None else x_sq[i:i + block_rows])
                 for i in range(0, n, block_rows)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    c_sq = (centers * centers).sum(-1)
    # ||x-c||^2 - ||x||^2 = ||c||^2 - 2 x.c: the row norm does not move
    # the argmin.
    partial = c_sq[None, :] - 2.0 * (x @ centers.T)
    a = torch.argmin(partial, dim=-1)
    if x_sq is None:
        x_sq = (x * x).sum(-1)
    best = torch.gather(partial, 1, a[:, None])[:, 0]
    return a.to(torch.int32), torch.clamp_min(best + x_sq, 0.0)


def _update_centers(x, a, k):
    idx = a.long()
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32,
                       device=x.device).index_add_(0, idx, x)
    counts = torch.zeros((k,), dtype=torch.float32,
                         device=x.device).index_add_(
                             0, idx, torch.ones_like(x[:, 0]))
    centers = sums / torch.clamp_min(counts, 1.0)[:, None]
    return centers, counts.to(torch.int32)


def _reseed_bad_centers(x, centers, a, counts, sq_dists, min_size):
    """Replace the centers of clusters with < min_size members by the
    points farthest from their assigned centers (the r-th bad cluster, in
    index order, takes the r-th farthest point)."""
    del a
    bad = counts < min_size
    bad_rank = torch.cumsum(bad.to(torch.int32), 0) - 1
    order = torch.argsort(-sq_dists, stable=True)
    seed_idx = order[torch.clamp(bad_rank, 0, x.shape[0] - 1).long()]
    new_centers = torch.where(bad[:, None], x[seed_idx], centers)
    return new_centers, bad.any()


def _normalize(c, spherical: bool):
    if not spherical:
        return c
    return c / torch.clamp_min(torch.linalg.norm(c, dim=-1, keepdim=True),
                               1e-20)


def lloyd_step(x, centers, x_sq, k, min_size, *, spherical=False,
               block_rows=None):
    """One Lloyd iteration: assign, update (empty clusters keep their
    center), reseed undersized clusters, renormalize if spherical."""
    a, sq_dists = assign(x, centers, x_sq, block_rows=block_rows)
    new_centers, counts = _update_centers(x, a, k)
    new_centers = torch.where((counts > 0)[:, None], new_centers, centers)
    new_centers, _ = _reseed_bad_centers(x, new_centers, a, counts,
                                         sq_dists, min_size)
    return _normalize(new_centers, spherical)


def kmeans(generator, x, k, *, iterations=12, init="random", spherical=False,
           min_cluster_size=1, block_rows=None):
    """Train k-means centers over ``x`` ((n, d) f32 tensor).

    init: "random" (k distinct sample rows) or "kmeans++"; min_cluster_size
    is capped at n / k like the JAX package (and its reference)."""
    n, _ = x.shape
    if k > n:
        raise ValueError(f"cannot train {k} centers from {n} points")
    min_size = max(1, min(min_cluster_size, n // k))
    x = x.float()
    x_sq = (x * x).sum(-1)
    if init == "kmeans++":
        centers = _kmeanspp_init(generator, x, k, x_sq)
    else:
        perm = torch.randperm(n, generator=generator)[:k].to(x.device)
        centers = x[perm]
    centers = _normalize(centers, spherical)
    for _ in range(iterations):
        centers = lloyd_step(x, centers, x_sq, k, min_size,
                             spherical=spherical, block_rows=block_rows)
    a, _ = assign(x, centers, x_sq, block_rows=block_rows)
    _, counts = _update_centers(x, a, k)
    return KMeansResult(centers, a, counts)


def _kmeanspp_init(generator, x, k, x_sq):
    """k-means++ D^2 seeding (k - 1 sequential draws)."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (1,), generator=generator))
    c = x[first]
    min_sq = torch.clamp_min(x_sq - 2.0 * (x @ c) + (c * c).sum(), 0.0)
    out = [c]
    for _ in range(k - 1):
        probs = (min_sq / torch.clamp_min(min_sq.sum(), 1e-30)).cpu()
        idx = int(torch.multinomial(probs + 1e-30, 1, generator=generator))
        c = x[idx]
        sq = torch.clamp_min(x_sq - 2.0 * (x @ c) + (c * c).sum(), 0.0)
        min_sq = torch.minimum(min_sq, sq)
        out.append(c)
    return torch.stack(out)


def sample_rows(generator, n_total, sample_size):
    """Uniform row sample without replacement (CPU int64 indices)."""
    if sample_size >= n_total:
        return torch.arange(n_total)
    return torch.randperm(n_total, generator=generator)[:sample_size]
