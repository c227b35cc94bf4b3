"""The gloo job of tests/test_torch_sharded.py: every scenario of the
port's sharded index on a (2, 2) mesh of spawned processes.  It imports
no JAX: the test prepares the JAX package's artifacts and inputs under
``work``, the job loads and searches them, builds, mutates and serializes
with scann_torch, and each rank returns its results to the test."""

import os

import numpy as np
import torch

import scann_torch
from scann_torch.parallel import build as build_mod
from scann_torch.parallel import dryrun
from scann_torch.parallel import mesh as mesh_mod

TABLE_KEYS = ("codes", "slot_leaf", "slot_dpid", "rows_i8", "rows_sq",
              "rows_scale")


def search_kwargs(inp, measure):
    """Every keyword argument of search_batched, one case each."""
    nq = len(inp["q"])
    eps = {"dot_product": 0.3, "cosine": 0.7, "squared_l2": 1.4}[measure]
    return {
        "default": {},
        "leaves_and_pre": dict(leaves_to_search=3,
                               pre_reorder_num_neighbors=20),
        "final_k": dict(final_num_neighbors=6),
        "per_query_k": dict(final_num_neighbors=inp["ks"]),
        "restrict": dict(restrict_allowlist=inp["allow"]),
        "crowding": dict(per_crowding_attribute_num_neighbors=2),
        "pre_crowding": dict(
            per_crowding_attribute_pre_reordering_num_neighbors=2),
        "pre_tokenized": dict(pre_tokenized_leaves=inp["pretok"]),
        "epsilon": dict(post_reordering_epsilon=eps),
        "epsilon_per_query": dict(
            post_reordering_epsilon=np.linspace(eps - 0.3, eps + 0.3, nq)),
    }


def search_all(s, inp, measure):
    s.set_crowding(inp["attrs"][:s.n_points])
    return {name: s.search_batched(inp["q"], **kw)
            for name, kw in search_kwargs(inp, measure).items()}


def mutate(s, extra, first_new):
    """The scripted sequence: insert, update (one id twice over the
    calls), delete, and an insert past the free slots, so every shard
    grows."""
    per_row = 2 if s.part_cfg.soar is not None else 1
    # Half the free slots first (the layout pads each shard to a multiple
    # of 128 slots here, so a few hundred rows cover every step).
    n_new = max(4, int((s._host_parts["slot_dpid"] < 0).sum()) // per_row
                // 2)
    s.upsert(np.arange(first_new, first_new + n_new), extra[:n_new])
    s.upsert([3, 7, 11], extra[n_new:n_new + 3])
    s.delete([5, first_new + 1, first_new + 2])
    s.upsert([7], extra[n_new + 3:n_new + 4])
    free = int((np.asarray(s._host_parts["slot_dpid"]) < 0).sum())
    n_over = free // per_row + 1
    s.upsert(np.arange(first_new + n_new, first_new + n_new + n_over),
             extra[n_new + 4:n_new + 4 + n_over])
    return n_over


def tables(s):
    hp = s.gather_host_parts()
    return {k: np.array(hp[k]) for k in TABLE_KEYS}   # copies


def job(mesh, work):
    inp = dict(np.load(os.path.join(work, "inputs.npz")))
    out = {"rank": torch.distributed.get_rank(),
           "coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("shard"))}
    # Searches on the JAX package's sharded artifacts, then the scripted
    # mutation, then the port's own serialization for the JAX loader.
    for name, measure in (("ah_soar", "dot_product"),
                          ("sq_l2_spill", "squared_l2"),
                          ("sq_cosine_avq_soar", "cosine")):
        s = mesh_mod.load_sharded(os.path.join(work, "jax_" + name), mesh)
        res = {"search": search_all(s, inp, measure),
               "loaded_tables": tables(s)}
        if name != "sq_cosine_avq_soar":
            refreshes = []
            refresh = s._refresh_device
            s._refresh_device = lambda *a: (refreshes.append(a),
                                            refresh(*a))
            res["n_over"] = mutate(s, inp["extra"], s.n_points)
            res["refreshes"] = len(refreshes)
            res["state_is_host"] = all(
                np.array_equal(s.state[k].numpy(), s._local(k))
                for k in TABLE_KEYS if k in s.state)
            res["mutated_tables"] = tables(s)
            res["mutated_search"] = search_all(s, inp, measure)
            s.serialize(os.path.join(work, "port_" + name))
        out[name] = res
    # from_searcher of single-host JAX indexes loaded into the port: the
    # layout slot for slot (a PCA tree-AH, a plain tree-AH, a tree-SQ).
    db = inp["db"]
    for name in ("pca", "tree_ah", "tree_sq"):
        single = scann_torch.load_searcher(
            os.path.join(work, "jax_single_" + name), device="cpu")
        s = mesh_mod.ShardedTreeAHSearcher.from_searcher(single, db, mesh)
        out["from_" + name] = {"tables": tables(s),
                               "search": s.search_batched(inp["q"])}
    out["jax_from_pca"] = {"search": mesh_mod.load_sharded(
        os.path.join(work, "jax_from_pca"), mesh).search_batched(inp["q"])}
    # The port's own builds of the JAX configurations, in memory, with a
    # compute device and spilled to one shared directory.
    for name in ("ah_soar", "sq_l2_spill", "sq_cosine_avq_soar"):
        s = mesh_mod.load_sharded(os.path.join(work, "jax_" + name), mesh)
        built = build_mod.build_sharded(db, s.config, mesh)
        out["build_" + name] = {"search": built.search_batched(inp["q"]),
                                "live": int((built._host_parts["slot_dpid"]
                                             >= 0).sum())}
    # The data-parallel Lloyd path, which the JAX package takes above 2^25
    # sample floats, at this size.
    s = mesh_mod.load_sharded(os.path.join(work, "jax_sq_l2_spill"), mesh)
    bound = build_mod._SINGLE_ENGINE_FLOATS
    build_mod._SINGLE_ENGINE_FLOATS = 0
    try:
        lloyd = build_mod.build_sharded(db, s.config, mesh)
    finally:
        build_mod._SINGLE_ENGINE_FLOATS = bound
    out["build_lloyd"] = {"search": lloyd.search_batched(inp["q"])}

    def chunks():
        for i in range(0, len(db), 1500):
            yield db[i:i + 1500]

    mem = build_mod.build_sharded_streaming(chunks, s.config, mesh)
    spill = build_mod.build_sharded_streaming(
        chunks, s.config, mesh, spill_dir=os.path.join(work, "spill"))
    comp = build_mod.build_sharded_streaming(chunks, s.config, mesh,
                                             compute_device="cpu")
    out["spill"] = {"mem": tables(mem), "spill": tables(spill),
                    "mem_search": mem.search_batched(inp["q"]),
                    "spill_search": spill.search_batched(inp["q"]),
                    "compute_search": comp.search_batched(inp["q"])}
    # One data-parallel Lloyd step over every rank.
    ranks = build_mod._Ranks(mesh, "shard")
    x = inp["kmeans_x"]
    lp = len(x) // ranks.n
    out["kmeans_step"] = build_mod.sharded_kmeans_step(
        torch.as_tensor(x[ranks.pos * lp:(ranks.pos + 1) * lp]),
        torch.as_tensor(inp["kmeans_c0"]), None,
        valid_rows=int(inp["kmeans_valid"])).numpy()
    out["dryrun"] = dryrun.dryrun_rank(mesh)
    return out
