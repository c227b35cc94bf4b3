"""K-means tree partitioner (port of scann_tpu/partitioning/kmeans_tree.py).

Trains leaf centers on a sample (flat, or two-level with
``hierarchical_top``), tokenizes queries (top-L centers under the search
measure, optionally against int8 centers and pruned by an upper tree over
the leaf centers) and the database (nearest center under squared L2, plus
SOAR's orthogonality-amplified secondary center), refits centers with AVQ,
masks selected leaves by distance-conditioned query spilling, and bounds
leaf sizes for the pruned scorers by splitting oversized leaves with a
batched 2-means (``split_oversized``) and, as a last resort, moving
boundary members to their best non-full leaf (``cap_partition_sizes``).
Query tokenization is exact: the JAX package selects with approx_max_k
from 2048 leaves on when L * 8 <= num_leaves (ROADMAP section 3).
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from scann_torch import config as cfg
from scann_torch.ops import distance as dist_ops
from scann_torch.ops import kmeans as kmeans_ops
from scann_torch.ops import quantize as quant_ops
from scann_torch.ops import topk as topk_ops
from scann_torch.utils import profiling

# Chunk size (database rows) for build-time tokenization sweeps.
_TOKENIZE_CHUNK = 65536
# Training points per leaf below which k-means is considered unstable.
_KMEANS_STABLE_SAMPLE_PER_LEAF = 100
# Rows per block of the k-means assignment (bounds the f32 intermediate).
_KMEANS_BLOCK_ROWS = 65536
# Bound on the (leaves, members, d) gather of one 2-means, AVQ or
# sub-k-means batch.
_SPLIT_BATCH_ELEMS = 1 << 26

_log = logging.getLogger("scann_torch")


class KMeansTreePartitioner(NamedTuple):
    """Trained k-means tree; tensors live on the search device."""
    centers: torch.Tensor  # (num_leaves, d) f32
    query_distance: str    # measure used for query tokenization
    centers_int8: Optional[torch.Tensor] = None      # (num_leaves, d) int8
    centers_inv_mult: Optional[torch.Tensor] = None  # (d,) f32
    upper_centers: Optional[torch.Tensor] = None     # (U, d) f32
    # (num_leaves,) int32, or (num_leaves, 2) under the upper tree's SOAR
    upper_assign: Optional[torch.Tensor] = None
    upper_leaves_to_search: int = 1
    # "fixed_number" searches every selected leaf; the other types mask the
    # selected leaves past a threshold relative to the best one.
    query_spilling_type: str = "fixed_number"
    query_spilling_threshold: float = 0.0

    @property
    def num_leaves(self) -> int:
        return self.centers.shape[0]

    def spilling_mask(self, sims):
        """(B, L) keep-mask over rank-ordered center similarities."""
        return spilling_mask(sims, self.query_spilling_type,
                             self.query_spilling_threshold)

    @staticmethod
    def train(database, part: cfg.PartitioningConfig, measure: str,
              seed: int) -> "KMeansTreePartitioner":
        """Train the tree on a sample of ``database`` ((n, d) f32 tensor on
        the search device)."""
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
        upper_centers = upper_assign = None
        upper_l = 1
        if part.hierarchical_top and part.num_leaves > part.hierarchical_top:
            # Two-level training; the top level doubles as the upper tree.
            (centers, upper_centers, upper_assign,
             upper_l) = _hierarchical_centers(gen, sample, part)
        else:
            centers = kmeans_ops.kmeans(
                gen, sample, part.num_leaves,
                iterations=part.training_iterations,
                init="random" if part.random_init else "kmeans++",
                spherical=part.spherical,
                min_cluster_size=part.min_partition_size,
                block_rows=_KMEANS_BLOCK_ROWS).centers
            up = part.upper_tree
            if up is not None and up.num_leaves > 1:
                (upper_centers, upper_assign,
                 upper_l) = _train_upper_tree(centers, up, measure, seed)
        centers_int8 = inv_mult = None
        if part.quantize_centroids:
            sq = quant_ops.scalar_quantize(centers)
            centers_int8, inv_mult = sq.data, sq.inverse_multipliers
        spill_type = part.query_spilling_type
        spill_thr = part.query_spilling_threshold
        if spill_type in ("additive", "multiplicative") and spill_thr is None:
            spill_thr = learn_spilling_threshold(
                sample, centers, spill_type, part.expected_spill_factor,
                part.num_leaves_to_search)
        return KMeansTreePartitioner(
            centers=centers, query_distance=measure,
            centers_int8=centers_int8, centers_inv_mult=inv_mult,
            upper_centers=upper_centers, upper_assign=upper_assign,
            upper_leaves_to_search=upper_l,
            query_spilling_type=spill_type,
            query_spilling_threshold=float(spill_thr or 0.0))

    def query_center_scores(self, queries):
        """(q, num_leaves) similarity of queries to centers under the query
        tokenization measure (f32 products; with int8 centers, the query
        times the multipliers against the int8 centers)."""
        if self.centers_int8 is not None:
            c8 = self.centers_int8.float()
            inv = self.centers_inv_mult
            return dist_ops.similarity(
                queries * inv[None, :], c8, self.query_distance,
                db_sq_norms=((c8 * inv[None, :]) ** 2).sum(-1),
                query_sq_norms=(queries * queries).sum(-1))
        return dist_ops.similarity(queries, self.centers, self.query_distance)

    def tokenize_queries(self, queries, num_leaves_to_search: int):
        """Top-L leaf ids per query, exact; with an upper tree, only the
        leaves of the top upper_leaves_to_search upper clusters (either of
        a leaf's two under the upper tree's SOAR) compete.  Returns
        (leaf_ids int32, sims)."""
        scores = self.query_center_scores(queries)
        if self.upper_centers is not None:
            up_scores = dist_ops.similarity(queries, self.upper_centers,
                                            self.query_distance)
            _, up_ids = topk_ops.top_k(up_scores,
                                       self.upper_leaves_to_search)
            sel = torch.zeros(up_scores.shape, dtype=torch.bool,
                              device=scores.device)
            sel.scatter_(1, up_ids.long(), True)
            ua = self.upper_assign.long()
            if ua.dim() == 2:
                allowed = sel[:, ua[:, 0]] | sel[:, ua[:, 1]]
            else:
                allowed = sel[:, ua]
            scores = torch.where(allowed, scores, float("-inf"))
        sims, ids = topk_ops.top_k(scores, num_leaves_to_search)
        return ids, sims

    def select_leaves(self, queries, leaves: int, pre_tokenized=None,
                      pair_sims: bool = False):
        """(leaf_ids, keep mask, center sims) of a batch: the caller's
        (q, L) leaves, -1 entries unused (sims the f32 q.c_leaf of the f32
        centers, computed when ``pair_sims``, else None), or the
        tokenizer's top ``leaves`` masked by query spilling."""
        if pre_tokenized is not None:
            leaf_ids = torch.clamp_min(pre_tokenized, 0)
            sims = None
            if pair_sims:
                c_sel = self.centers[leaf_ids.long()]
                sims = torch.bmm(c_sel, queries[:, :, None])[:, :, 0]
            return leaf_ids, pre_tokenized >= 0, sims
        leaf_ids, sims = self.tokenize_queries(queries, leaves)
        return leaf_ids, self.spilling_mask(sims), sims

    def tokenize_database(self, database):
        """Nearest center (squared L2) per row, chunked; int32 tensor."""
        return _tokenize_run(database, self.centers)

    def tokenize_database_soar(self, database, soar: cfg.SoarConfig):
        """SOAR's two centers per row, (n, 2) int32: the nearest, and the
        center minimizing ||x-c||^2 + lambda ((x-c) . r_hat)^2 with r_hat
        the normalized primary residual.  A ``spill`` phase (inside the
        build's ``partition``)."""
        with profiling.phase("spill"):
            return _tokenize_soar_run(database, self.centers,
                                      float(soar.lambda_))

    def residualize(self, database, tokens):
        """x - c_token per row (f32 tensor on the centers' device)."""
        x = torch.as_tensor(database, device=self.centers.device).float()
        t = torch.as_tensor(tokens, device=self.centers.device).long()
        return x - self.centers[t]

    def apply_avq(self, database, tokens, eta: float,
                  max_leaf_size: int) -> "KMeansTreePartitioner":
        """Refit each leaf's center by anisotropic least squares over its
        members X:
            c = eta (W I + (eta - 1) sum ||x||^(eta-3) x x^T)^-1
                    sum ||x||^(eta-1) x,   W = sum ||x||^(eta-1),
        batched over leaves (a padded member table and one batched f32
        solve).  Empty leaves keep their centers."""
        x = torch.as_tensor(database, dtype=torch.float32,
                            device=self.centers.device)
        d = x.shape[1]
        nl = self.num_leaves
        tokens = np.asarray(tokens).reshape(-1)
        slot_idx, valid = _pad_partition_index(tokens, nl, max_leaf_size)
        eye = torch.eye(d, dtype=torch.float32, device=x.device)
        fillzero = 1.0 if eta == 1.0 else 0.0
        step = max(1, _SPLIT_BATCH_ELEMS // (max_leaf_size * d))
        out = []
        for s0 in range(0, nl, step):
            idx = torch.from_numpy(slot_idx[s0:s0 + step]).to(x.device)
            v = torch.from_numpy(valid[s0:s0 + step]).to(x.device).float()
            xm = x[idx.long()] * v[:, :, None]
            norms = torch.linalg.norm(xm, dim=-1)
            nz = norms > 1e-20
            w = torch.where(nz, norms ** (eta - 1.0), fillzero * v)
            sw = torch.where(nz, norms ** (0.5 * (eta - 3.0)), 0.0)
            xw = xm * sw[:, :, None]
            xtx = torch.bmm(xw.transpose(1, 2), xw)
            wsum = (xm * w[:, :, None]).sum(1)
            tw = w.sum(1)
            a_mat = tw[:, None, None] * eye + (eta - 1.0) * xtx
            # Empty leaves solve against the identity; their result is
            # dropped.
            a_mat = torch.where((tw > 0)[:, None, None], a_mat, eye)
            c = eta * torch.linalg.solve_ex(a_mat, wsum[:, :, None])[0][
                :, :, 0]
            out.append(torch.where((tw > 0)[:, None], c, 0.0))
        new_centers = torch.cat(out)
        counts = torch.from_numpy(np.bincount(tokens, minlength=nl)).to(
            x.device)
        new_centers = torch.where((counts > 0)[:, None], new_centers,
                                  self.centers)
        return self._replace(centers=new_centers)


def spilling_mask(sims, spilling_type: str, threshold: float):
    """(B, L) keep-mask over rank-ordered center similarities (higher
    better; -distance under squared L2): "additive" keeps d_k <= d_best +
    thr, "absolute_distance" d_k <= thr, "multiplicative" d_k <= thr *
    d_best, "fixed_number" every leaf."""
    t = spilling_type
    if t == "fixed_number":
        return torch.ones(sims.shape, dtype=torch.bool, device=sims.device)
    thr = threshold
    best = sims[:, :1]
    if t == "additive":
        return sims >= best - thr
    if t == "absolute_distance":
        return sims >= -thr
    if t == "multiplicative":
        return -sims <= thr * torch.clamp_min(-best, 0.0)
    raise ValueError(f"unknown query_spilling_type: {t}")


def _train_upper_tree(centers, up: cfg.UpperTreeConfig, measure: str,
                      seed: int):
    """Cluster the leaf centers into the upper tree (k-means++, 10
    iterations); its AVQ refits the upper centers, its SOAR gives each leaf
    a second upper cluster.  Returns (upper_centers, upper_assign,
    upper_leaves_to_search)."""
    res = kmeans_ops.kmeans(
        torch.Generator().manual_seed(seed + 7), centers,
        min(up.num_leaves, centers.shape[0]), iterations=10, init="kmeans++")
    upper_centers, upper_assign = res.centers, res.assignments
    if up.avq is not None:
        counts = np.bincount(upper_assign.cpu().numpy(),
                             minlength=upper_centers.shape[0])
        upper_centers = KMeansTreePartitioner(
            centers=upper_centers, query_distance=measure).apply_avq(
                centers, upper_assign.cpu().numpy(), float(up.avq),
                max(1, int(counts.max()))).centers
    if up.soar_lambda is not None:
        soar = cfg.SoarConfig(lambda_=float(up.soar_lambda),
                              overretrieve_factor=(up.overretrieve_factor
                                                   or 2.0))
        upper_assign = KMeansTreePartitioner(
            centers=upper_centers, query_distance=measure
        ).tokenize_database_soar(centers, soar)
    upper_l = max(1, min(up.num_leaves_to_search, upper_centers.shape[0]))
    return upper_centers, upper_assign, upper_l


def _tokenize_run(x, centers):
    parts = [kmeans_ops.assign(x[i:i + _TOKENIZE_CHUNK].float(), centers)[0]
             for i in range(0, x.shape[0], _TOKENIZE_CHUNK)]
    return torch.cat(parts)


def _tokenize_soar_run(x, centers, lam: float):
    out = []
    for i in range(0, x.shape[0], _TOKENIZE_CHUNK):
        c = x[i:i + _TOKENIZE_CHUNK].float()
        prim, _ = kmeans_ops.assign(c, centers)
        r = c - centers[prim.long()]
        rnorm = torch.linalg.norm(r, dim=-1, keepdim=True)
        r_hat = torch.where(rnorm < 1e-7, 0.0,
                            r / torch.clamp_min(rnorm, 1e-20))
        term1 = dist_ops.squared_l2(c, centers)
        # (x - c_j) . r_hat = x . r_hat - c_j . r_hat
        term2 = (c * r_hat).sum(-1, keepdim=True) - r_hat @ centers.T
        soar_dist = term1 + lam * term2 * term2
        soar_dist.scatter_(1, prim.long()[:, None], float("inf"))
        sec = torch.argmin(soar_dist, dim=-1).to(torch.int32)
        out.append(torch.stack([prim, sec], dim=-1))
    return torch.cat(out)


def _hierarchical_centers(gen, sample, part: cfg.PartitioningConfig):
    """Two-level training: k1 = hierarchical_top clusters of the sample,
    then one masked sub-k-means of k2 = ceil(num_leaves / k1) centers per
    top cluster (spread initialization over its member list, max(iters //
    2, 4) Lloyd steps), batched.  Returns (centers (k1 * k2, d),
    upper_centers (k1, d), upper_assign, upper_leaves_to_search)."""
    k1 = int(part.hierarchical_top)
    k2 = -(-part.num_leaves // k1)
    top = kmeans_ops.kmeans(
        gen, sample, k1, iterations=part.training_iterations,
        init="random" if part.random_init else "kmeans++",
        spherical=part.spherical, block_rows=_KMEANS_BLOCK_ROWS)
    tokens = top.assignments.cpu().numpy()
    counts = np.bincount(tokens, minlength=k1)
    max_m = max(int(counts.max()), k2)
    idx_t, valid_t = _pad_partition_index(tokens, k1, max_m)
    stride = max(max_m // k2, 1)
    iters = max(part.training_iterations // 2, 4)
    d = sample.shape[1]
    step = max(1, _SPLIT_BATCH_ELEMS // (max_m * d))
    subs = []
    for s0 in range(0, k1, step):
        xm = sample[torch.from_numpy(idx_t[s0:s0 + step]).to(
            sample.device).long()]                        # (m, max_m, d)
        v = torch.from_numpy(valid_t[s0:s0 + step]).to(sample.device).float()
        c = xm[:, 0:k2 * stride:stride]                   # (m, k2, d)
        for _ in range(iters):
            c_sq = (c * c).sum(-1)
            a = torch.argmin(c_sq[:, None, :]
                             - 2.0 * torch.bmm(xm, c.transpose(1, 2)), dim=-1)
            w = v[:, :, None] * torch.nn.functional.one_hot(a, k2).float()
            sums = torch.bmm(w.transpose(1, 2), xm)
            cnt = w.sum(1)[:, :, None]
            c = torch.where(cnt > 0, sums / torch.clamp_min(cnt, 1.0), c)
        subs.append(c)
    centers = torch.cat(subs).reshape(k1 * k2, d)
    upper_assign = torch.from_numpy(
        np.repeat(np.arange(k1, dtype=np.int32), k2)).to(sample.device)
    # Enough top clusters that the true top-L leaves are reachable: L leaves
    # spread over about L distinct tops at worst, with a 2x margin.
    upper_l = max(1, min(k1, 2 * -(-part.num_leaves_to_search * k1
                                   // max(part.num_leaves, 1)) + 4))
    return centers, top.centers, upper_assign, upper_l


def learn_spilling_threshold(sample, centers, spilling_type: str,
                             spill_factor: float, max_centers: int) -> float:
    """Learned query-spilling threshold: pool the additive (d_k - d_0) or
    multiplicative (d_k / d_0) spill statistics of the sample's top
    max_centers centers and take the quantile whose expected spill count
    matches spill_factor."""
    if spill_factor <= 1.0:
        return 0.0
    max_n = int(min(centers.shape[0], max(2, max_centers)))
    parts = []
    for i in range(0, sample.shape[0], _TOKENIZE_CHUNK):
        dsq = dist_ops.squared_l2(sample[i:i + _TOKENIZE_CHUNK].float(),
                                  centers)
        top = torch.topk(dsq, max_n, dim=-1, largest=False).values
        if spilling_type == "additive":
            parts.append(top[:, 1:] - top[:, :1])
        else:
            parts.append(top[:, 1:] / torch.clamp_min(top[:, :1], 1e-20))
    spills = torch.cat(parts).cpu().numpy().reshape(-1)
    n_sample = sample.shape[0]
    if max_n <= spill_factor:
        return float(spills.max())
    idx = min(int(math.floor((spill_factor - 1.0) * n_sample)),
              len(spills) - 1)
    return float(np.partition(spills, idx)[idx])


def _pad_partition_index(tokens: np.ndarray, num_leaves: int,
                         max_leaf_size: int):
    """(num_leaves, max_leaf_size) member-index table and validity mask of
    a tokenization (members in row order, truncated at max_leaf_size)."""
    tokens = np.asarray(tokens).reshape(-1)
    order = np.argsort(tokens, kind="stable")
    sorted_tokens = tokens[order]
    starts = np.searchsorted(sorted_tokens, np.arange(num_leaves))
    ends = np.searchsorted(sorted_tokens, np.arange(num_leaves), side="right")
    idx = np.zeros((num_leaves, max_leaf_size), np.int32)
    valid = np.zeros((num_leaves, max_leaf_size), bool)
    for lf in range(num_leaves):
        members = order[starts[lf]:ends[lf]][:max_leaf_size]
        idx[lf, :len(members)] = members
        valid[lf, :len(members)] = True
    return idx, valid


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
                        base_counts: Optional[np.ndarray] = None,
                        forbid: Optional[np.ndarray] = None,
                        rounds: int = 4) -> np.ndarray:
    """Bound every partition to <= cap members by moving the boundary
    members of over-cap partitions (smallest best-alternative minus own
    distance gap) to their best non-full partition.  ``x``: (n, d) tensor
    on the build device.  ``base_counts``: slots each partition already
    holds (SOAR's primaries when its secondaries are capped); ``forbid``:
    (n,) partition each row may not move to (its primary under SOAR).
    Returns int64 tokens (numpy)."""
    tokens = np.array(tokens, np.int64, copy=True)
    nl = centers.shape[0]
    dev = x.device
    cj = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    c_sq = (cj * cj).sum(1)
    iota = torch.arange(nl, device=dev)[None, :]
    inf = torch.tensor(float("inf"), device=dev)
    extra = base_counts if base_counts is not None else 0
    fb_all = (np.asarray(forbid, np.int64) if forbid is not None
              else np.full(len(tokens), -1, np.int64))

    def _alt(xm, own, room, fb):
        d = c_sq[None, :] - 2.0 * (xm @ cj.T)
        d_own = torch.gather(d, 1, own[:, None])[:, 0]
        d = torch.where(room[None, :], d, inf)
        d = torch.where(iota == own[:, None], inf, d)
        d = torch.where(iota == fb[:, None], inf, d)
        alt = torch.argmin(d, dim=1)
        return d_own, d.min(dim=1).values, alt

    for _ in range(rounds):
        counts = np.bincount(tokens, minlength=nl) + extra
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
                               torch.from_numpy(tokens[cv]).to(dev), room,
                               torch.from_numpy(fb_all[cv]).to(dev))
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
