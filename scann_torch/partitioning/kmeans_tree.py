"""K-means tree partitioner, flat path (port of
scann_tpu/partitioning/kmeans_tree.py).

Trains leaf centers on a sample, tokenizes queries (top-L centers under the
search measure) and the database (nearest center under squared L2), and
bounds leaf sizes for the pruned scorer by splitting oversized leaves with
a batched 2-means (``split_oversized``) and, as a last resort, moving
boundary members to their best non-full leaf (``cap_partition_sizes``).
The upper tree, hierarchical training, SOAR, AVQ, int8 centroids and
distance-conditioned query spilling are not ported yet (ROADMAP item 14)
and raise NotImplementedError.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from scann_torch import config as cfg
from scann_torch.ops import distance as dist_ops
from scann_torch.ops import kmeans as kmeans_ops
from scann_torch.ops import topk as topk_ops

# Chunk size (database rows) for build-time tokenization sweeps.
_TOKENIZE_CHUNK = 65536
# Training points per leaf below which k-means is considered unstable.
_KMEANS_STABLE_SAMPLE_PER_LEAF = 100
# Rows per block of the k-means assignment (bounds the f32 intermediate).
_KMEANS_BLOCK_ROWS = 65536
# Bound on the (leaves, members, d) gather of one 2-means batch.
_SPLIT_BATCH_ELEMS = 1 << 26

_log = logging.getLogger("scann_torch")


def unsupported_partitioning(part: cfg.PartitioningConfig) -> Optional[str]:
    """Name of the first setting of ``part`` the port does not serve yet,
    or None."""
    if part.upper_tree is not None:
        return "upper_tree"
    if part.hierarchical_top:
        return "hierarchical_top"
    if part.soar is not None:
        return "soar"
    if part.avq is not None:
        return "avq"
    if part.quantize_centroids:
        return "quantize_centroids"
    if part.query_spilling_type != "fixed_number":
        return f"query_spilling_type={part.query_spilling_type!r}"
    return None


class KMeansTreePartitioner(NamedTuple):
    """Trained flat k-means tree; centers live on the search device."""
    centers: torch.Tensor  # (num_leaves, d) f32
    query_distance: str    # measure used for query tokenization

    @property
    def num_leaves(self) -> int:
        return self.centers.shape[0]

    def spilling_mask(self, sims):
        """(B, L) keep-mask over rank-ordered center similarities.  The
        partitioner serves ``fixed_number`` spilling only, which keeps
        every selected leaf."""
        return torch.ones(sims.shape, dtype=torch.bool, device=sims.device)

    @staticmethod
    def train(database, part: cfg.PartitioningConfig, measure: str,
              seed: int) -> "KMeansTreePartitioner":
        """Train the flat tree on a sample of ``database`` ((n, d) f32
        tensor on the search device)."""
        bad = unsupported_partitioning(part)
        if bad is not None:
            raise NotImplementedError(
                f"partitioning {bad} is not ported yet (ROADMAP item 14)")
        n = database.shape[0]
        effective_sample = min(n, part.training_sample_size)
        if effective_sample < _KMEANS_STABLE_SAMPLE_PER_LEAF * part.num_leaves:
            _log.warning(
                "k-means training sample (%d) is below %d per leaf for "
                "num_leaves=%d; the trained partition may be unstable and "
                "recall may suffer. Raise training_sample_size toward %d.",
                effective_sample, _KMEANS_STABLE_SAMPLE_PER_LEAF,
                part.num_leaves,
                _KMEANS_STABLE_SAMPLE_PER_LEAF * part.num_leaves)
        gen = torch.Generator().manual_seed(seed)
        sample_idx = kmeans_ops.sample_rows(gen, n, part.training_sample_size)
        sample = database[sample_idx.to(database.device)].float()
        result = kmeans_ops.kmeans(
            gen, sample, part.num_leaves,
            iterations=part.training_iterations,
            init="random" if part.random_init else "kmeans++",
            spherical=part.spherical,
            min_cluster_size=part.min_partition_size,
            block_rows=_KMEANS_BLOCK_ROWS)
        return KMeansTreePartitioner(centers=result.centers,
                                     query_distance=measure)

    def query_center_scores(self, queries):
        """(q, num_leaves) similarity of queries to centers under the query
        tokenization measure (f32 products)."""
        return dist_ops.similarity(queries, self.centers, self.query_distance)

    def tokenize_queries(self, queries, num_leaves_to_search: int):
        """Top-L leaf ids per query, exact (the JAX package takes
        approx_max_k at >= 2048 leaves).  Returns (leaf_ids int32, sims)."""
        scores = self.query_center_scores(queries)
        sims, ids = topk_ops.top_k(scores, num_leaves_to_search)
        return ids, sims

    def tokenize_database(self, database):
        """Nearest center (squared L2) per row, chunked; int32 tensor."""
        return _tokenize_run(database, self.centers)


def _tokenize_run(x, centers):
    parts = [kmeans_ops.assign(x[i:i + _TOKENIZE_CHUNK].float(), centers)[0]
             for i in range(0, x.shape[0], _TOKENIZE_CHUNK)]
    return torch.cat(parts)


def _two_means_batch(x, idx_t, valid_t):
    """Batched 2-means over padded member tables (one row per oversized
    leaf): far-pair seeding, then 6 masked Lloyd steps.  Returns
    (c0, c1, assign == 1)."""
    xm = x[idx_t.long()].float()                     # (m, max_m, d)
    v = valid_t.float()
    rows = torch.arange(xm.shape[0], device=x.device)
    neg = torch.tensor(-1.0, device=x.device)
    d0 = ((xm - xm[:, :1]) ** 2).sum(-1)
    c1 = xm[rows, torch.argmax(torch.where(valid_t, d0, neg), dim=1)]
    d1 = ((xm - c1[:, None]) ** 2).sum(-1)
    c0 = xm[rows, torch.argmax(torch.where(valid_t, d1, neg), dim=1)]
    c = torch.stack([c0, c1], dim=1)                 # (m, 2, d)

    def assign_to(c):
        d = ((c * c).sum(-1)[:, None, :]
             - 2.0 * torch.bmm(xm, c.transpose(1, 2)))
        return torch.argmin(d, dim=2)

    for _ in range(6):
        a = assign_to(c)
        w = v[:, :, None] * torch.nn.functional.one_hot(a, 2).float()
        sums = torch.bmm(w.transpose(1, 2), xm)      # (m, 2, d)
        cnt = w.sum(1)[:, :, None]
        c = torch.where(cnt > 0, sums / torch.clamp_min(cnt, 1.0), c)
    return c[:, 0], c[:, 1], assign_to(c) == 1


def split_oversized(x, tokens: np.ndarray, centers: np.ndarray, cap: int,
                    max_rounds: int = 8):
    """Bound every partition to <= cap members by splitting over-cap
    partitions with a local 2-means (the first half keeps the leaf id, the
    second becomes a new leaf).  ``x``: (n, d) tensor on the build device.
    Returns (tokens int64, centers f32) as numpy; num_leaves may grow."""
    tokens = np.array(tokens, np.int64, copy=True)
    centers = np.array(centers, np.float32, copy=True)
    for _round in range(max_rounds):
        counts = np.bincount(tokens, minlength=len(centers))
        over = np.nonzero(counts > cap)[0]
        if len(over) == 0:
            break
        max_m = int(counts[over].max())
        _log.info("split round %d: %d oversized leaves, max %d members",
                  _round, len(over), max_m)
        order = np.argsort(tokens, kind="stable")
        starts = np.searchsorted(tokens[order], over)
        idx_t = np.zeros((len(over), max_m), np.int32)
        valid_t = np.zeros((len(over), max_m), bool)
        for j, lf in enumerate(over):
            m = counts[lf]
            idx_t[j, :m] = order[starts[j]:starts[j] + m]
            valid_t[j, :m] = True
        step = max(1, _SPLIT_BATCH_ELEMS // (max_m * x.shape[1]))
        c0, c1, assign = [], [], []
        for s0 in range(0, len(over), step):
            a0, a1, asg = _two_means_batch(
                x, torch.from_numpy(idx_t[s0:s0 + step]).to(x.device),
                torch.from_numpy(valid_t[s0:s0 + step]).to(x.device))
            c0.append(a0.cpu().numpy())
            c1.append(a1.cpu().numpy())
            assign.append(asg.cpu().numpy())
        c0, c1 = np.concatenate(c0), np.concatenate(c1)
        assign = np.concatenate(assign)
        new_centers = []
        for j, lf in enumerate(over):
            members = idx_t[j][valid_t[j]]
            a = assign[j][valid_t[j]]
            centers[lf] = c0[j]
            tokens[members[a]] = len(centers) + len(new_centers)
            new_centers.append(c1[j])
        centers = np.concatenate([centers, np.stack(new_centers)], axis=0)
    return tokens, centers


def cap_partition_sizes(x, tokens: np.ndarray, centers: np.ndarray, cap: int,
                        rounds: int = 4) -> np.ndarray:
    """Bound every partition to <= cap members by moving the boundary
    members of over-cap partitions (smallest best-alternative minus own
    distance gap) to their best non-full partition.  ``x``: (n, d) tensor
    on the build device.  Returns int64 tokens (numpy)."""
    tokens = np.array(tokens, np.int64, copy=True)
    nl = centers.shape[0]
    dev = x.device
    cj = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    c_sq = (cj * cj).sum(1)
    iota = torch.arange(nl, device=dev)[None, :]
    inf = torch.tensor(float("inf"), device=dev)

    def _alt(xm, own, room):
        d = c_sq[None, :] - 2.0 * (xm @ cj.T)
        d_own = torch.gather(d, 1, own[:, None])[:, 0]
        d = torch.where(room[None, :], d, inf)
        d = torch.where(iota == own[:, None], inf, d)
        alt = torch.argmin(d, dim=1)
        return d_own, d.min(dim=1).values, alt

    for _ in range(rounds):
        counts = np.bincount(tokens, minlength=nl)
        over_mask = counts > cap
        over = np.nonzero(over_mask)[0]
        if len(over) == 0:
            break
        cand = np.nonzero(over_mask[tokens])[0]
        room = torch.from_numpy(counts < cap).to(dev)
        d_own = np.empty(len(cand), np.float32)
        d_alt = np.empty(len(cand), np.float32)
        alt = np.empty(len(cand), np.int64)
        step = 32768
        for s0 in range(0, len(cand), step):
            cv = cand[s0:s0 + step]
            o, a_d, a_i = _alt(x[torch.from_numpy(cv).to(dev)].float(),
                               torch.from_numpy(tokens[cv]).to(dev), room)
            d_own[s0:s0 + len(cv)] = o.cpu().numpy()
            d_alt[s0:s0 + len(cv)] = a_d.cpu().numpy()
            alt[s0:s0 + len(cv)] = a_i.cpu().numpy()
        delta = d_alt - d_own
        moved_any = False
        for lf in over:
            members = np.nonzero(tokens[cand] == lf)[0]
            excess = int(counts[lf] - cap)
            if excess <= 0 or len(members) == 0:
                continue
            take = members[np.argsort(delta[members])[:min(
                excess, len(members))]]
            take = take[np.isfinite(delta[take])]
            if len(take):
                tokens[cand[take]] = alt[take]
                moved_any = True
        if not moved_any:
            break
    return tokens
