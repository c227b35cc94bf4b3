"""Sparse input: a CSR container, a hashed projection into the dense
pipeline and an exact sparse scan (port of scann_tpu/data/sparse.py).

* ``SparseMatrix``: CSR (indptr / indices / values), also built from a
  scipy.sparse matrix or a dense array.
* ``SparseHashingProjection``: signed feature hashing (the JAX package's
  splitmix64 mixing, in numpy, so both packages hash a column to the same
  bucket and sign), an unbiased dot-product estimator.
* ``sparse_searcher``: projects the database, builds a dense searcher
  over it (brute force, or above 100,000 rows tree + score_ah(2) +
  reorder(4k)), and wraps it in ``SparseSearcher``, whose queries project
  the same way and whose candidates are rescored exactly on the host
  against the original CSR rows.
* ``SparseExactSearcher``: the exact scan for dot product, cosine,
  squared L2, L1, hamming and jaccard: the queries are densified once a
  batch, and each database CSR chunk gathers the query columns at its
  nonzeros and sums each row's contributions with ``index_add_`` on the
  searcher's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scann_torch.models import base
from scann_torch.ops import topk as topk_ops

# Bound on the (queries, nonzeros) gathered block of the exact scan.
_MAX_GATHER = 1 << 26


class SparseMatrix(NamedTuple):
    """CSR sparse matrix (float32 values, int64 indices)."""
    indptr: np.ndarray   # (n + 1,)
    indices: np.ndarray  # (nnz,)
    values: np.ndarray   # (nnz,)
    shape: tuple

    @staticmethod
    def from_any(m) -> "SparseMatrix":
        if isinstance(m, SparseMatrix):
            return m
        if hasattr(m, "tocsr"):  # scipy.sparse
            csr = m.tocsr()
            csr.sort_indices()
            return SparseMatrix(np.asarray(csr.indptr, np.int64),
                                np.asarray(csr.indices, np.int64),
                                np.asarray(csr.data, np.float32),
                                tuple(csr.shape))
        if isinstance(m, np.ndarray) and m.ndim == 2:
            rows, cols = np.nonzero(m)
            indptr = np.concatenate(
                [[0], np.cumsum(np.bincount(rows, minlength=m.shape[0]))])
            return SparseMatrix(indptr.astype(np.int64),
                                cols.astype(np.int64),
                                m[rows, cols].astype(np.float32), m.shape)
        raise TypeError(f"cannot interpret {type(m)} as a sparse matrix")

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    def row(self, i: int):
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:e], self.values[s:e]

    def row_ids(self) -> np.ndarray:
        """The row of every stored entry."""
        return np.repeat(np.arange(self.n_rows),
                         np.diff(self.indptr).astype(np.int64))

    def dot_dense_rows(self, rows: "SparseMatrix", idx: np.ndarray):
        """Exact sparse dot products self[q] . rows[idx[q, j]] for a
        candidate matrix idx ((nq, k), entries < 0 give -inf): every
        candidate row's entries looked up in the query's, products and sums
        in float64 in the row's order, rounded to float32."""
        cand = np.asarray(idx, np.int64)
        nq, k = cand.shape
        safe = np.maximum(cand, 0).reshape(-1)
        starts = rows.indptr[safe]
        lens = rows.indptr[safe + 1] - starts
        total = int(lens.sum())
        pair = np.repeat(np.arange(nq * k), lens)
        pos = (np.repeat(starts - np.cumsum(lens) + lens, lens)
               + np.arange(total))
        dim = int(max(self.shape[1], rows.shape[1]))
        qkeys = self.row_ids() * dim + self.indices
        order = np.argsort(qkeys, kind="stable")
        qkeys = qkeys[order]
        keys = (pair // k) * dim + rows.indices[pos]
        j = np.minimum(np.searchsorted(qkeys, keys), max(len(qkeys) - 1, 0))
        hit = (qkeys[j] == keys) if len(qkeys) else np.zeros_like(keys, bool)
        qv = self.values[order][j] if len(qkeys) else np.zeros(total)
        prod = np.where(hit, qv.astype(np.float64)
                        * rows.values[pos].astype(np.float64), 0.0)
        out = np.bincount(pair, weights=prod, minlength=nq * k)
        out = out.astype(np.float32).reshape(nq, k)
        return np.where(cand >= 0, out, -np.inf).astype(np.float32)


class SparseHashingProjection(NamedTuple):
    """Signed feature hashing: column c -> bucket h(c) with sign s(c)."""
    out_dims: int
    seed: int

    def _hash(self, cols: np.ndarray):
        # splitmix64 mixing, deterministic across processes and packages.
        with np.errstate(over="ignore"):
            x = (cols.astype(np.uint64)
                 + np.uint64(0x9E3779B97F4A7C15)
                 * np.uint64(self.seed + 1))
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            x = x ^ (x >> np.uint64(31))
        bucket = (x % np.uint64(self.out_dims)).astype(np.int64)
        sign = np.where((x >> np.uint64(63)) & np.uint64(1), -1.0, 1.0)
        return bucket, sign.astype(np.float32)

    def project(self, m: SparseMatrix, device="cpu") -> np.ndarray:
        """(n, out_dims) float32 numpy: each entry's signed value summed
        into its bucket (``index_add_`` on ``device``)."""
        bucket, sign = self._hash(m.indices)
        flat = torch.from_numpy(m.row_ids() * self.out_dims + bucket)
        out = torch.zeros((m.n_rows * self.out_dims,), dtype=torch.float32,
                          device=device)
        out.index_add_(0, flat.to(device),
                       torch.from_numpy(m.values * sign).to(device))
        return out.reshape(m.n_rows, self.out_dims).cpu().numpy()


def _row_sq(m: SparseMatrix) -> np.ndarray:
    out = np.zeros((m.n_rows,), np.float32)
    np.add.at(out, m.row_ids(), m.values ** 2)
    return out


class SparseSearcher:
    """Dense searcher over hashed projections of sparse vectors, with
    optional exact host rescoring against the original CSR rows."""

    def __init__(self, searcher, projection: SparseHashingProjection,
                 database: SparseMatrix, exact_rescore: bool = True,
                 overretrieve: float = 2.0):
        self.searcher = searcher
        self.projection = projection
        self.database = database
        self.exact_rescore = exact_rescore
        self.overretrieve = float(overretrieve)
        self.measure = searcher.config.distance_measure
        # The exact rescore ranks by the true measure of the original rows.
        self._row_sq = _row_sq(database)

    def search_batched(self, queries, final_num_neighbors=None, **kwargs):
        q = SparseMatrix.from_any(queries)
        dense_q = self.projection.project(q, self.searcher.device)
        k = final_num_neighbors or self.searcher.config.num_neighbors
        fetch = (max(int(self.overretrieve * k), k + 10)
                 if self.exact_rescore else k)
        idx, dist = self.searcher.search_batched(
            dense_q, final_num_neighbors=fetch, **kwargs)
        idx = np.asarray(idx)
        if not self.exact_rescore:
            return idx[:, :k], np.asarray(dist)[:, :k]
        safe_idx = np.maximum(idx, 0)
        dots = q.dot_dense_rows(self.database, safe_idx)
        q_sq = _row_sq(q)
        if self.measure == "squared_l2":
            exact = -(q_sq[:, None] - 2.0 * dots + self._row_sq[safe_idx])
        elif self.measure == "cosine":
            denom = np.sqrt(np.maximum(q_sq[:, None]
                                       * self._row_sq[safe_idx], 1e-20))
            exact = dots / denom
        else:
            exact = dots
        exact = np.where(idx >= 0, exact, -np.inf)
        order = np.argsort(-exact, axis=1)[:, :k]
        top = np.take_along_axis(exact, order, axis=1)
        if self.measure == "squared_l2":
            user = -top
        elif self.measure == "cosine":
            user = 1.0 - top
        else:
            user = top
        user = np.where(np.isneginf(top), np.nan, user)
        return (np.take_along_axis(np.where(idx >= 0, idx, -1), order,
                                   axis=1), user)


class SparseExactSearcher:
    """Exact sparse search, no hashing.  Every measure reduces to
    per-nonzero contributions summed per row plus per-row aggregates:

      dot_product   S = sum v * q_c
      squared_l2    ||q||^2 + ||x||^2 - 2 S
      cosine        S / (||q|| ||x||)
      l1            sum |q| + sum over nnz(x) of (|v - q_c| - |q_c|)
      hamming       nnz(q) + nnz(x) - sum [(q_c != 0) + (q_c == v)]
      jaccard       1 - sum min(q_c, v) / (sum q + sum (max(q_c, v) - q_c))
                    (nonnegative data only)
    """

    MEASURES = ("dot_product", "cosine", "squared_l2", "l1", "hamming",
                "jaccard")

    def __init__(self, database, num_neighbors: int,
                 distance_measure: str = "dot_product",
                 chunk_rows: int = 32768, device="cuda"):
        if distance_measure not in self.MEASURES:
            raise ValueError(
                f"unsupported sparse exact measure {distance_measure!r}; "
                f"choose from {self.MEASURES}")
        self.device = base.resolve_device(device)
        m = SparseMatrix.from_any(database)
        # Stored zeros would corrupt the hamming / jaccard support counts.
        if np.any(m.values == 0.0):
            keep = m.values != 0.0
            counts = np.bincount(m.row_ids()[keep], minlength=m.n_rows)
            m = SparseMatrix(
                np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
                m.indices[keep], m.values[keep], m.shape)
        if distance_measure == "jaccard" and np.any(m.values < 0):
            raise ValueError("jaccard requires nonnegative values")
        self.database = m
        self.k = int(num_neighbors)
        self.measure = distance_measure
        self.dims = int(m.shape[1])
        self.chunk_rows = int(chunk_rows)
        row_of = m.row_ids()
        dev = self.device
        self._row_sq = torch.from_numpy(_row_sq(m)).to(dev)
        self._row_nnz = torch.from_numpy(
            np.diff(m.indptr).astype(np.float32)).to(dev)
        # Each chunk: its nonzeros' columns, values and rows within the
        # chunk, on the device.
        self._chunks = []
        for start in range(0, m.n_rows, self.chunk_rows):
            end = min(start + self.chunk_rows, m.n_rows)
            s, e = int(m.indptr[start]), int(m.indptr[end])
            self._chunks.append((
                start, end,
                torch.from_numpy(m.indices[s:e]).to(dev),
                torch.from_numpy(m.values[s:e]).to(dev),
                torch.from_numpy(row_of[s:e] - start).to(dev)))

    def _chunk_sims(self, q_dense, q_aggr, chunk):
        """(nq, rows of the chunk) similarities."""
        start, end, cols, vals, segs = chunk
        rows = end - start
        measure = self.measure
        qg = q_dense[:, cols]                          # (nq, P)
        v = vals[None, :]
        if measure in ("dot_product", "cosine", "squared_l2"):
            parts = [qg * v]
        elif measure == "l1":
            parts = [(v - qg).abs() - qg.abs()]
        elif measure == "hamming":
            parts = [(qg != 0).float() + (qg == v).float()]
        else:
            parts = [torch.minimum(qg, v), torch.maximum(qg, v) - qg]
        sums = [torch.zeros((qg.shape[0], rows), dtype=torch.float32,
                            device=qg.device).index_add_(1, segs, p)
                for p in parts]
        s0 = sums[0]
        row_sq = self._row_sq[start:end][None, :]
        if measure == "dot_product":
            return s0
        if measure == "squared_l2":
            return -(q_aggr[:, 0:1] + row_sq - 2.0 * s0)
        if measure == "cosine":
            return s0 / torch.sqrt(torch.clamp_min(q_aggr[:, 0:1] * row_sq,
                                                   1e-20))
        if measure == "l1":
            return -(q_aggr[:, 1:2] + s0)
        if measure == "hamming":
            return -(q_aggr[:, 2:3] + self._row_nnz[start:end][None, :]
                     - s0)
        union = q_aggr[:, 3:4] + sums[1]
        return -torch.where(union > 0, 1.0 - s0 / union, 1.0)

    def search_batched(self, queries, final_num_neighbors=None):
        q = SparseMatrix.from_any(queries)
        if q.shape[1] != self.dims:
            raise ValueError(
                f"query dims {q.shape[1]} != database dims {self.dims}")
        nq = q.n_rows
        k = int(final_num_neighbors or self.k)
        if nq * (self.dims + 1) > (1 << 28):
            raise ValueError(
                "query densification would exceed 1 GiB "
                f"({nq} x {self.dims} dims); use smaller query batches or "
                "the hashed sparse_searcher for very high-dimensional data")
        q_dense = np.zeros((nq, self.dims), np.float32)
        q_dense[q.row_ids(), q.indices] = q.values
        q_aggr = np.stack([(q_dense ** 2).sum(axis=1),
                           np.abs(q_dense).sum(axis=1),
                           np.bincount(q.row_ids(), minlength=nq),
                           q_dense.sum(axis=1)], axis=1).astype(np.float32)
        q_dev = torch.from_numpy(q_dense).to(self.device)
        qa_dev = torch.from_numpy(q_aggr).to(self.device)

        best_v = np.full((nq, k), -np.inf, np.float32)
        best_i = np.full((nq, k), -1, np.int64)
        for chunk in self._chunks:
            start = chunk[0]
            block = max(1, _MAX_GATHER // max(chunk[2].shape[0], 1))
            vs, ids = [], []
            for b0 in range(0, nq, block):
                sims = self._chunk_sims(q_dev[b0:b0 + block],
                                        qa_dev[b0:b0 + block], chunk)
                v_k, i_k = topk_ops.top_k(sims, min(k, sims.shape[1]))
                vs.append(v_k)
                ids.append(i_k)
            v_k = torch.cat(vs).cpu().numpy()
            i_k = torch.cat(ids).cpu().numpy().astype(np.int64) + start
            ok = ~np.isneginf(v_k)
            allv = np.concatenate([best_v, v_k], axis=1)
            alli = np.concatenate([best_i, np.where(ok, i_k, -1)], axis=1)
            top = np.argsort(-allv, axis=1, kind="stable")[:, :k]
            best_v = np.take_along_axis(allv, top, axis=1)
            best_i = np.take_along_axis(alli, top, axis=1)
        if self.measure == "dot_product":
            dist = best_v
        elif self.measure == "cosine":
            dist = 1.0 - best_v
        else:   # squared_l2 / l1 / hamming / jaccard: sim == -distance
            dist = -best_v
        dist = np.where(np.isneginf(best_v), np.nan, dist)
        return best_i, dist


def sparse_searcher(database, num_neighbors: int,
                    distance_measure: str = "dot_product",
                    projection_dims: int = 256, seed: int = 42,
                    exact_rescore: bool = True, overretrieve: float = 2.0,
                    configure=None, device="cuda") -> SparseSearcher:
    """Build a searcher over sparse input on ``device``.

    database: SparseMatrix / scipy CSR / dense ndarray.  configure:
    optional fn(builder) -> builder to pick tree / AH settings; the
    default is brute force up to 100,000 rows, above it tree + AH."""
    from scann_torch.builder import builder
    m = SparseMatrix.from_any(database)
    dev = base.resolve_device(device)
    proj = SparseHashingProjection(out_dims=projection_dims, seed=seed)
    dense = proj.project(m, dev)
    b = builder(dense, num_neighbors, distance_measure, device=dev)
    if configure is not None:
        b = configure(b)
    elif m.n_rows > 100_000:
        b = (b.tree(num_leaves=max(2, m.n_rows // 512),
                    num_leaves_to_search=max(1, m.n_rows // 512 // 20))
             .score_ah(2).reorder(4 * num_neighbors))
    else:
        b = b.score_brute_force()
    return SparseSearcher(b.build(), proj, m,
                          exact_rescore=exact_rescore,
                          overretrieve=overretrieve)
