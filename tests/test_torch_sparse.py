"""Sparse input in the port against scann_tpu on the CPU.

Hashing: the port's splitmix64 buckets and signs are the JAX package's,
bit for bit, and so are its projected rows (one float32 sum a bucket in
the entries' order); the CSR container and the exact host rescore
(float64 sums, rounded to float32) equal the JAX ones.
SparseExactSearcher: for every measure it serves, ids found in the JAX
searcher's top 10 of the same query (>= 99.9%), distances within 1e-5
relative (1e-5 absolute near zero; squared L2 relative to ||q||^2 +
||x||^2).  sparse_searcher: a JAX-built dense
index over the hashed rows (tree + score_ah + reorder, as the default
configuration above 100,000 rows), loaded by the port and wrapped with the
same projection, returns the JAX searcher's results, exact rescore
included; the port's own build takes the same route."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse

import scann_torch
import scann_tpu
from scann_torch.data import sparse as tsp
from scann_tpu.data import sparse as jsp
import torch_threads  # noqa: F401  (torch threads per xdist worker)

ID_AGREE = 0.999


def _csr(n, dims, nnz, seed, nonneg=False, binary=False):
    r = np.random.default_rng(seed)
    indices = np.concatenate([np.sort(r.choice(dims, nnz, replace=False))
                              for _ in range(n)]).astype(np.int64)
    if binary:
        values = np.ones(n * nnz, np.float32)
    elif nonneg:
        values = r.uniform(0.1, 2.0, n * nnz).astype(np.float32)
    else:
        values = r.standard_normal(n * nnz).astype(np.float32)
    indptr = np.arange(n + 1, dtype=np.int64) * nnz
    return indptr, indices, values, (n, dims)


def _pair(n, dims, nnz, seed, **kw):
    parts = _csr(n, dims, nnz, seed, **kw)
    return tsp.SparseMatrix(*parts), jsp.SparseMatrix(*parts)


def test_hashing_is_the_jax_hashing():
    cols = np.concatenate([np.arange(5000), np.random.default_rng(0).integers(
        0, 2 ** 40, 5000)]).astype(np.int64)
    for out_dims, seed in ((256, 42), (1000, 0), (7, 123)):
        tb, ts_ = tsp.SparseHashingProjection(out_dims, seed)._hash(cols)
        jb, js_ = jsp.SparseHashingProjection(out_dims, seed)._hash(cols)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(ts_, js_)
    t, j = _pair(300, 30522, 40, 1)
    np.testing.assert_array_equal(
        tsp.SparseHashingProjection(256, 42).project(t),
        jsp.SparseHashingProjection(256, 42).project(j))


def test_containers_and_rescore_match_jax():
    r = np.random.default_rng(3)
    m = scipy.sparse.random(40, 300, density=0.05, format="csr",
                            random_state=4, dtype=np.float32)
    dense = m.toarray()
    for src in (m, dense):
        t = tsp.SparseMatrix.from_any(src)
        j = jsp.SparseMatrix.from_any(src)
        for a, b in zip(t[:3], j[:3]):
            np.testing.assert_array_equal(a, b)
        assert tuple(t.shape) == tuple(j.shape)
    t, j = _pair(200, 500, 12, 5)
    tq, jq = _pair(16, 500, 30, 6)
    cand = r.integers(-1, 200, (16, 25)).astype(np.int32)
    got = tq.dot_dense_rows(t, cand)
    want = jq.dot_dense_rows(j, cand)
    np.testing.assert_array_equal(got, want)


def _assert_same(want, got, name):
    (wi, wd), (gi, gd) = want, got
    found = (wi[:, :, None] == gi[:, None, :]).any(-1)
    assert found.mean() >= ID_AGREE, (name, found.mean())
    same = (gi == wi) & (wi >= 0)
    np.testing.assert_allclose(gd[same], wd[same], rtol=1e-5, atol=1e-5,
                               err_msg=name)
    np.testing.assert_array_equal(np.isnan(gd), np.isnan(wd))


@pytest.mark.parametrize("measure", jsp.SparseExactSearcher.MEASURES)
def test_exact_searcher_matches_jax(measure):
    kw = {"nonneg": True} if measure == "jaccard" else (
        {"binary": True} if measure == "hamming" else {})
    t, j = _pair(1500, 2000, 16, 7, **kw)
    tq, jq = _pair(24, 2000, 24, 8, **kw)
    # Chunks of 512 rows: the last one is partial.
    ts = tsp.SparseExactSearcher(t, 10, measure, chunk_rows=512,
                                 device="cpu")
    js = jsp.SparseExactSearcher(j, 10, measure, chunk_rows=512)
    _assert_same(js.search_batched(jq), ts.search_batched(tq), measure)


def test_exact_searcher_blocks_queries_and_validates(monkeypatch):
    t, j = _pair(900, 800, 10, 9)
    tq, jq = _pair(30, 800, 20, 10)
    ts = tsp.SparseExactSearcher(t, 5, "squared_l2", chunk_rows=256,
                                 device="cpu")
    want = ts.search_batched(tq)
    monkeypatch.setattr(tsp, "_MAX_GATHER", 256 * 10 * 7)   # 7 a block
    got = ts.search_batched(tq, final_num_neighbors=5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _assert_same(jsp.SparseExactSearcher(j, 5, "squared_l2").search_batched(
        jq), got, "blocked")
    with pytest.raises(ValueError, match="unsupported"):
        tsp.SparseExactSearcher(t, 5, "l2", device="cpu")
    neg = tsp.SparseMatrix(*_csr(10, 50, 3, 1))
    with pytest.raises(ValueError, match="nonnegative"):
        tsp.SparseExactSearcher(neg, 5, "jaccard", device="cpu")
    with pytest.raises(ValueError, match="dims"):
        ts.search_batched(tsp.SparseMatrix(*_csr(2, 801, 3, 1)))


def _as_configured(sparse_searcher):
    c = sparse_searcher.searcher.config
    return dataclasses.replace(c, partitioning=dataclasses.replace(
        c.partitioning, num_leaves=8)).to_json()


def _tree_ah(b):
    return (b.tree(num_leaves=8, num_leaves_to_search=3,
                   training_sample_size=2000)
            .score_ah(2).reorder(40))


def _near_copies(m, rows, scale=1.02):
    """Queries that are scaled copies of the given database rows."""
    lens = np.diff(m.indptr)[rows]
    pos = np.concatenate([np.arange(m.indptr[r], m.indptr[r + 1])
                          for r in rows])
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return (indptr, m.indices[pos], (m.values[pos] * scale).astype(
        np.float32), (len(rows), m.shape[1]))


@pytest.mark.parametrize("measure", ["dot_product", "squared_l2"])
def test_sparse_searcher_on_a_jax_built_index(measure, tmp_path):
    t, j = _pair(2000, 30522, 30, 11, nonneg=True)
    src = np.arange(0, 2000, 61)[:32]
    parts = _near_copies(t, src)
    tq, jq = tsp.SparseMatrix(*parts), jsp.SparseMatrix(*parts)
    jss = jsp.sparse_searcher(j, 10, measure, configure=_tree_ah)
    jss.searcher.serialize(str(tmp_path))
    loaded = scann_torch.load_searcher(str(tmp_path), device="cpu")
    tss = tsp.SparseSearcher(loaded, tsp.SparseHashingProjection(256, 42),
                             t)
    _assert_same(jss.search_batched(jq), tss.search_batched(tq), measure)
    # The port's own build over the same rows takes the same route, finds
    # each query's source row first, and reports its exact distance.
    own = tsp.sparse_searcher(t, 10, measure, configure=_tree_ah,
                              device="cpu")
    # (num_leaves as configured: each build may split oversized leaves.)
    assert _as_configured(own) == _as_configured(jss)
    idx, dist = own.search_batched(tq)
    assert (idx[:, 0] == src).mean() >= 0.9
    ei, ed = tsp.SparseExactSearcher(t, 10, measure, device="cpu"
                                     ).search_batched(tq)
    first = idx[:, 0] == ei[:, 0]
    # Squared L2 is computed from ||q||^2 + ||x||^2 - 2 q.x: its rounding
    # scales with those terms.
    scale = np.abs(ed[first, 0])
    if measure == "squared_l2":
        sq = lambda m, r: float((m.row(int(r))[1] ** 2).sum())
        scale = scale + np.array([sq(tq, i) + sq(t, r) for i, r in zip(
            np.nonzero(first)[0], idx[first, 0])])
    assert np.all(np.abs(dist[first, 0] - ed[first, 0])
                  <= 1e-5 * scale + 1e-6)


def test_default_route_above_100k_rows(monkeypatch):
    """Above 100,000 rows the default is tree + score_ah(2) +
    reorder(4k), as in the JAX package: checked on the builder the
    default configuration makes (no build)."""
    made = {}

    class _Stop(Exception):
        pass

    def fake_build(self, docids=None):
        made["config"] = self.create_config()
        raise _Stop

    monkeypatch.setattr(scann_torch.ScannBuilder, "build", fake_build)
    m = tsp.SparseMatrix(np.zeros(200_002, np.int64), np.zeros(0, np.int64),
                         np.zeros(0, np.float32), (200_001, 50))
    with pytest.raises(_Stop):
        tsp.sparse_searcher(m, 10, device="cpu")
    c = made["config"]
    assert c.partitioning.num_leaves == 200_001 // 512
    assert c.partitioning.num_leaves_to_search == 200_001 // 512 // 20
    assert c.asymmetric_hash.dimensions_per_block == 2
    assert c.reordering.reordering_num_neighbors == 40
