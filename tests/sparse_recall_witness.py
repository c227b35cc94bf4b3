"""Recall@10 of sparse_searcher on a SPLADE-shaped corpus (chip_smoke.py's
generator, drawn on the CPU): the JAX package's searcher beside the port's,
both built and searched on the CPU from the same rows with the default
tree + AH route at each of ``seeds`` build seeds; the port searching the
JAX package's first index, loaded across; and the ceiling the hashing
alone sets: brute force over the same hashed rows with the same exact
rescore of the best max(2k, k + 10).  Not a test; run from the repository
root:

    JAX_PLATFORMS=cpu python tests/sparse_recall_witness.py \
        [rows] [queries] [seeds]

Prints one JSON object.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np
import scipy.sparse
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import scann_torch  # noqa: E402
from scann_tpu.data import sparse as sparse_jax  # noqa: E402
from scann_torch.data import sparse as sparse_port  # noqa: E402

K = 10


def recall(idx, truth):
    return float(np.mean([len(set(a) & set(b)) / K
                          for a, b in zip(idx, truth)]))


def main(n=150_000, nq=100, seeds=3):
    rows, qs = chip_smoke.make_splade_like(torch, n, nq, device="cpu")
    db, q = (scipy.sparse.csr_matrix((v, i, p), shape=shape)
             for p, i, v, shape in (rows, qs))
    exact = (q @ db.T).toarray()
    truth = np.argsort(-exact, axis=1, kind="stable")[:, :K]
    out = {"rows": n, "queries": nq, "nnz_per_row": db.nnz / n,
           "nnz_per_query": q.nnz / nq}

    proj = sparse_port.SparseHashingProjection(out_dims=256, seed=42)
    hashed = proj.project(sparse_port.SparseMatrix.from_any(db))
    hq = proj.project(sparse_port.SparseMatrix.from_any(q))
    fetch = max(2 * K, K + 10)
    cand = np.argsort(-(hq @ hashed.T), axis=1, kind="stable")[:, :fetch]
    rescored = np.take_along_axis(exact, cand, 1)
    best = np.take_along_axis(
        cand, np.argsort(-rescored, axis=1, kind="stable")[:, :K], 1)
    out["hashed_brute_force_recall"] = recall(best, truth)

    def configure(seed):
        # sparse_searcher's default above 100,000 rows, at a build seed.
        return lambda b: (b.tree(num_leaves=max(2, n // 512),
                                 num_leaves_to_search=max(1, n // 512 // 20))
                          .score_ah(2).reorder(4 * K).set_seed(seed))

    for seed in range(42, 42 + seeds):
        for name, pkg, kw in (("jax", sparse_jax, {}),
                              ("port", sparse_port, {"device": "cpu"})):
            t0 = time.perf_counter()
            s = pkg.sparse_searcher(db, K, configure=configure(seed), **kw)
            out[f"{name}_build_s_seed{seed}"] = time.perf_counter() - t0
            ids = np.asarray(s.search_batched(q)[0])
            out[f"{name}_recall_seed{seed}"] = recall(ids, truth)
            if name == "jax" and seed == 42:
                with tempfile.TemporaryDirectory() as d:
                    s.searcher.serialize(d)
                    loaded = sparse_port.SparseSearcher(
                        scann_torch.load_searcher(d, device="cpu"), proj,
                        sparse_port.SparseMatrix.from_any(db))
                cross = np.asarray(loaded.search_batched(q)[0])
                out["port_on_jax_index_recall"] = recall(cross, truth)
                out["port_on_jax_index_ids_equal"] = float(
                    np.mean(cross == ids))
    print(json.dumps(out))


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])
