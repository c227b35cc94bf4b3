"""CPU dry run of the sharded path on a gloo mesh of spawned processes
(the port of the JAX package's dryrun_multichip).

    python -m scann_torch.parallel.dryrun [n_ranks]

On n ranks (a (2, n / 2) mesh for an even n >= 4, else (1, n)) it runs a
data-parallel k-means step, the ah and sq builds with SOAR, a search and
a restricted search, from_searcher of a single-host index and an upsert
that each new vector finds first, and prints one line from rank 0.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def make_data(n=8000, d=32, nq=32, seed=0):
    """Unit rows around 64 topics (noise 0.3) and Gaussian queries."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32)
    db = (centers[rng.integers(0, 64, n)]
          + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    return db, q


def dryrun_rank(mesh) -> str:
    """The dry run's body on one rank of ``mesh``; returns its summary."""
    import scann_torch
    from scann_torch.parallel import build as build_mod
    from scann_torch.parallel import mesh as mesh_mod

    db, q = make_data()
    ranks = build_mod._Ranks(mesh, "shard")
    # Data-parallel Lloyd step: sums and counts all-reduced over every rank.
    x = db[:4096]
    lp = len(x) // ranks.n
    c1 = build_mod.sharded_kmeans_step(
        torch.as_tensor(x[ranks.pos * lp:(ranks.pos + 1) * lp]),
        torch.as_tensor(db[:64]), None)
    assert c1.shape == (64, db.shape[1])

    # Sharded build (SOAR doubles the slots) and search; restricts.
    config = (scann_torch.builder(db, 10, "dot_product", device="cpu")
              .tree(num_leaves=64, num_leaves_to_search=8,
                    training_sample_size=8000, soar_lambda=1.5)
              .score_ah(2, anisotropic_quantization_threshold=0.2)
              .reorder(50).create_config())
    sharded = build_mod.build_sharded(db, config, mesh)
    idx, dist = sharded.search_batched(q)
    assert idx.shape == (len(q), 10), idx.shape
    assert np.isfinite(dist[idx >= 0]).all()
    assert (sharded._host_parts["slot_dpid"] >= 0).sum() == 2 * len(db)
    allow = np.zeros(len(db), bool)
    allow[::2] = True
    idx_r, _ = sharded.search_batched(q, restrict_allowlist=allow)
    assert (idx_r[idx_r >= 0] % 2 == 0).all()

    # Re-sharding a single-host index serves on the mesh too, and the
    # O(batch) slot writes of an upsert serve at once.
    searcher = (scann_torch.builder(db, 10, "dot_product", device="cpu")
                .tree(num_leaves=64, num_leaves_to_search=8,
                      training_sample_size=10000)
                .score_ah(2, anisotropic_quantization_threshold=0.2)
                .reorder(50).build())
    sharded2 = mesh_mod.ShardedTreeAHSearcher.from_searcher(
        searcher, db, mesh)
    idx2, _ = sharded2.search_batched(q)
    assert idx2.shape == (len(q), 10)
    new_ids = np.arange(len(db), len(db) + 4)
    sharded2.upsert(new_ids, q[:4])
    idx3, _ = sharded2.search_batched(q[:4])
    assert np.array_equal(idx3[:, 0], new_ids), idx3[:, 0]

    # The exact residual-int8 leaves (leaf_format "sq") with SOAR.
    config_sq = (scann_torch.builder(db, 10, "dot_product", device="cpu")
                 .tree(num_leaves=64, num_leaves_to_search=8,
                       training_sample_size=8000, soar_lambda=1.5)
                 .score_brute_force(quantize="int8").create_config())
    sharded3 = build_mod.build_sharded(db, config_sq, mesh)
    assert sharded3.leaf_format == "sq"
    assert int((sharded3._host_parts["slot_dpid"] >= 0).sum()) == 2 * len(db)
    idx4, dist4 = sharded3.search_batched(q)
    assert idx4.shape == (len(q), 10)
    assert np.isfinite(dist4[idx4 >= 0]).all()
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return (f"sharded kmeans + sharded build (ah + sq formats) + sharded "
            f"search + from_searcher + upsert OK; mesh={shape}")


def dryrun_multichip(n_ranks: int = 4) -> str:
    """Run the dry run on ``n_ranks`` spawned gloo processes."""
    from scann_torch.parallel import launch
    if n_ranks >= 4 and n_ranks % 2 == 0:
        n_data, n_shards = 2, n_ranks // 2
    else:
        n_data, n_shards = 1, n_ranks
    out = launch.spawn(dryrun_rank, n_data, n_shards, device_type="cpu")
    return f"dryrun_multichip({n_ranks}): {out[0]}"


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
