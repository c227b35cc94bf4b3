"""Index serialization: ``scann_config.json`` + ``scann_assets.npz``.

Port of scann_tpu/utils/serialization.py for the searchers the port
serves: TreeAHSearcher (product codes with int8 / float32 / reconstruct
lookup, with or without a tree, SOAR's two slots a row included),
TreeXSearcher (residual-int8 tree-SQ, or float32 / bfloat16 / global-int8
dense leaves) and BruteForceSearcher (float32, int8 or bfloat16 rows),
each with or without float32, bfloat16, residual-int8 or per-dimension
int8 reordering; the partitioner's int8 centers, upper tree and query
spilling travel with it, and so do a projection (its matrix and output
width), stacked codebooks, VARIABLE_CHUNK block tables and typed (int8 /
uint8) rows in their dtype.  A searcher built with docids also writes
``scann_docids.json`` and its mutation state (the float32 row mirror, the
alive mask and the mutations since the last rebuild), so a reloaded index
takes upserts and deletes where it left off.  ``searcher_to_tensors`` /
``searcher_from_tensors`` carry the same assets as one flat dict of numpy
arrays (the config and the docids as JSON bytes).  Keys, dtypes and the
config/meta blob are the JAX package's, so each package loads the other's
index: the port
searches an index built by scann_tpu (the search parity tests), and
scann_tpu loads an index built by the port.  Loading
turns the numpy arrays into tensors on the requested device; index dtypes
stay those of the files (int32 tables, int8 rows, f32 planes and centers;
bfloat16 rows travel as their uint16 bit patterns).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from scann_torch import config as cfg

_CONFIG_FILE = "scann_config.json"
_ASSETS_FILE = "scann_assets.npz"
_DOCIDS_FILE = "scann_docids.json"


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def collect_assets(searcher):
    """Flatten a searcher into (numpy arrays, JSON-able config+meta)."""
    arrays: dict = {}
    dtypes: dict = {}
    meta: dict = {"type": type(searcher).__name__,
                  "n_points": searcher.n_points, "dims": searcher.dims}

    def put(key, arr):
        if arr is None:
            return
        if isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16:
            # No numpy bfloat16: store the bit patterns.
            arrays[key] = _to_numpy(arr.view(torch.int16)).view(np.uint16)
            dtypes[key] = "bfloat16"
            return
        a = _to_numpy(arr)
        arrays[key], dtypes[key] = a, str(a.dtype)

    def put_partitioner(part):
        for key in ("centers", "centers_int8", "centers_inv_mult",
                    "upper_centers", "upper_assign"):
            put(key, getattr(part, key))
        meta["query_spilling_type"] = part.query_spilling_type
        meta["query_spilling_threshold"] = part.query_spilling_threshold
        meta["upper_leaves_to_search"] = part.upper_leaves_to_search

    rh = getattr(searcher, "reorder_helper", None)
    if rh is not None:
        put("reorder_db", rh._db)
        put("reorder_inv_mult", rh._inv_mult)
        put("reorder_sq_norms", rh._sq_norms)
        if rh._leaf is not None:
            # Residual int8 reordering: the primary-leaf table and per-row
            # dequant scales (centers reload from the partitioner assets).
            put("reorder_leaf", rh._leaf)
            put("reorder_row_scale", rh._row_scale)
            meta["reorder_residual"] = True
    if searcher.projector is not None:
        put("proj_matrix", searcher.projector.matrix)
        meta["proj_out_dims"] = searcher.projector.out_dims
    mut = getattr(searcher, "_mut", None)
    if mut is not None:
        put("mut_vectors", mut.vectors)
        put("mut_alive", mut.alive)
        meta["mutations_since_rebuild"] = mut.mutations_since_rebuild

    tname = meta["type"]
    if tname == "BruteForceSearcher":
        put("bf_db", searcher._db)
        put("bf_inv_mult", searcher._inv_mult)
        put("bf_sq_norms", searcher._sq_norms)
        put("bf_valid", searcher._valid)
    elif tname == "TreeAHSearcher":
        from scann_torch.utils import native
        codes_np = searcher._host["codes"]
        if searcher.ah_cfg.clusters_per_block == 16:
            # 4-bit pair-packed on disk.
            put("codes_packed", native.pack4(codes_np))
        else:
            put("codes", codes_np)
        meta["num_blocks"] = int(codes_np.shape[1])
        put("slot_dpid", searcher.index.slot_dpid)
        put("slot_leaf", searcher.index.slot_leaf)
        # Stacked codes keep their stage codebooks under the same key.
        put("codebook", searcher.model.codebooks if searcher.stacked
            else searcher.model.codebook)
        put("block_dims", getattr(searcher.model, "block_dims", None))
        put("datapoint_to_token",
            np.asarray(searcher.datapoint_to_token, np.int32))
        meta["model_dims"] = searcher.model.dims
        meta["num_slots"] = searcher._num_slots
        meta["chunk"] = searcher._chunk
        meta["quantization_error_sq"] = searcher._quantization_error_sq
        meta["encoded_slots"] = searcher._encoded_slots
        if searcher.partitioner is not None:
            put_partitioner(searcher.partitioner)
    elif tname == "TreeXSearcher":
        put("slot_rows", searcher.slot_rows)
        put("slot_leaf", searcher.slot_leaf)
        put("slot_dpid", searcher._layout.dpid if searcher._sq_mode
            else searcher.slot_dpid)
        put("tx_inv_mult", searcher._inv_mult)
        put("tx_sq_norms", searcher._sq_norms)
        put("datapoint_to_token",
            np.asarray(searcher.datapoint_to_token, np.int32))
        meta["num_slots"] = searcher._num_slots
        meta["chunk"] = searcher._chunk
        if searcher._sq_mode:
            # Residual int8 tile-major leaves (the pruned path).
            meta["tx_mode"] = "residual_int8"
            meta["max_ntiles"] = searcher._layout.max_ntiles
            meta["num_tiles"] = searcher._layout.num_tiles
            put("tx_scale", searcher.slot_scale)
            put("tx_bias2", searcher._layout.bias)
            put("tx_tile_start", searcher._layout.tile_start)
            put("tx_ntiles", searcher._layout.ntiles)
        put_partitioner(searcher.partitioner)
    else:
        raise ValueError(f"cannot serialize searcher type {tname}")
    meta["dtypes"] = dtypes
    blob = {"config": json.loads(searcher.config.to_json()), "meta": meta}
    return arrays, blob


def save_searcher(searcher, artifacts_dir: str):
    os.makedirs(artifacts_dir, exist_ok=True)
    arrays, blob = collect_assets(searcher)
    with open(os.path.join(artifacts_dir, _CONFIG_FILE), "w") as f:
        f.write(json.dumps(blob, indent=2))
    np.savez(os.path.join(artifacts_dir, _ASSETS_FILE), **arrays)
    if searcher.docids is not None:
        with open(os.path.join(artifacts_dir, _DOCIDS_FILE), "w") as f:
            json.dump(searcher.docids, f)


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), np.uint8).copy()


def searcher_to_tensors(searcher) -> dict:
    """Searcher -> flat dict of numpy arrays (embeddable in a checkpoint):
    the assets, the config/meta blob as ``scann_config_json`` and the
    docids, when present, as ``scann_docids_json`` (JSON bytes, uint8)."""
    arrays, blob = collect_assets(searcher)
    out = dict(arrays)
    out["scann_config_json"] = _json_bytes(blob)
    if searcher.docids is not None:
        out["scann_docids_json"] = _json_bytes(searcher.docids)
    return out


def searcher_from_tensors(tensors: dict, device):
    """Inverse of searcher_to_tensors, on ``device``."""
    from scann_torch.models import base
    dev = base.resolve_device(device)
    # Own, writable copies: the index tensors are written in place.
    arrays = {k: np.array(v) for k, v in tensors.items()}
    blob = json.loads(bytes(arrays.pop("scann_config_json")).decode())
    docids = None
    if "scann_docids_json" in arrays:
        docids = json.loads(bytes(arrays.pop("scann_docids_json")).decode())
    return _restore_searcher(blob, arrays, docids, dev)


def load_searcher(artifacts_dir: str, device):
    """Reconstruct a searcher on ``device`` without retraining."""
    from scann_torch.models import base
    dev = base.resolve_device(device)
    with open(os.path.join(artifacts_dir, _CONFIG_FILE)) as f:
        blob = json.load(f)
    docids = None
    if os.path.exists(os.path.join(artifacts_dir, _DOCIDS_FILE)):
        with open(os.path.join(artifacts_dir, _DOCIDS_FILE)) as f:
            docids = json.load(f)
    with np.load(os.path.join(artifacts_dir, _ASSETS_FILE)) as raw:
        arrays = {k: raw[k] for k in raw.files}
    return _restore_searcher(blob, arrays, docids, dev)


def _restore_searcher(blob: dict, arrays: dict, docids, dev):
    from scann_torch import factory
    scann_config = cfg._config_from_dict(blob["config"])
    meta = blob["meta"]
    factory.check_supported(scann_config, dev, meta["dims"],
                            meta["n_points"])

    def tensor(key):
        if key not in arrays:
            return None
        a = np.ascontiguousarray(arrays[key])
        if meta["dtypes"][key] == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).to(dev).view(
                torch.bfloat16)
        return torch.from_numpy(a).to(dev)

    def partitioner():
        from scann_torch.partitioning import kmeans_tree
        part = scann_config.partitioning
        upper_l = 1
        if part is not None and part.upper_tree is not None:
            upper_l = part.upper_tree.num_leaves_to_search
        # Hierarchical training derives its own upper fan-out: the stored
        # value wins.
        upper_l = int(meta.get("upper_leaves_to_search", upper_l))
        return kmeans_tree.KMeansTreePartitioner(
            centers=tensor("centers"),
            query_distance=cfg.internal_measure(
                scann_config.distance_measure),
            centers_int8=tensor("centers_int8"),
            centers_inv_mult=tensor("centers_inv_mult"),
            upper_centers=tensor("upper_centers"),
            upper_assign=tensor("upper_assign"),
            upper_leaves_to_search=upper_l,
            query_spilling_type=meta.get("query_spilling_type",
                                         "fixed_number"),
            query_spilling_threshold=float(meta.get(
                "query_spilling_threshold", 0.0)))

    tname = meta["type"]
    if tname == "BruteForceSearcher":
        from scann_torch.models import brute_force
        s = object.__new__(brute_force.BruteForceSearcher)
        _init_base(s, scann_config, meta, dev, tensor, arrays, docids)
        s.quantize_mode = scann_config.brute_force.quantize
        s._db = tensor("bf_db")
        s._inv_mult = tensor("bf_inv_mult")
        s._sq_norms = tensor("bf_sq_norms")
        s._valid = tensor("bf_valid")
        if s._valid is None:
            s._valid = torch.ones((s._db.shape[0],), dtype=torch.bool,
                                  device=dev)
        return s
    if tname == "TreeAHSearcher":
        from scann_torch.models import tree_ah
        from scann_torch.ops import ah as ah_ops
        from scann_torch.utils import native
        s = object.__new__(tree_ah.TreeAHSearcher)
        _init_base(s, scann_config, meta, dev, tensor, arrays, docids)
        s._init_config(scann_config)
        if "codes_packed" in arrays:
            codes_np = native.unpack4(arrays["codes_packed"],
                                      meta["num_blocks"])
        else:
            codes_np = np.ascontiguousarray(arrays["codes"], np.uint8)
        s.index = tree_ah.TreeAHIndex(codes=None,
                                      slot_dpid=tensor("slot_dpid"),
                                      slot_leaf=tensor("slot_leaf"))
        if s.stacked:
            from scann_torch.ops import stacked as stacked_ops
            s.model = stacked_ops.StackedModel(codebooks=tensor("codebook"),
                                               dims=meta["model_dims"])
        else:
            s.model = ah_ops.AHModel(codebook=tensor("codebook"),
                                     dims=meta["model_dims"],
                                     block_dims=tensor("block_dims"))
        s._num_slots = meta["num_slots"]
        s._chunk = meta["chunk"]
        s._quantization_error_sq = meta.get("quantization_error_sq", 0.0)
        s._encoded_slots = meta.get("encoded_slots", 0)
        s.datapoint_to_token = arrays["datapoint_to_token"]
        # A non-partitioned index carries no centers.
        s.partitioner = partitioner() if "centers" in arrays else None
        if s.reorder_helper is not None and s.reorder_helper._leaf is not None:
            s.reorder_helper._centers = s.partitioner.centers
        s._host = {"codes": codes_np,
                   "leaf": np.asarray(arrays["slot_leaf"], np.int32),
                   "dpid": np.asarray(arrays["slot_dpid"], np.int32)}
        # A fresh slot table and zero leaf pressure, deletions included
        # (the JAX loader leaves _leaf_deletions unset, so its maintenance
        # fails on a reloaded index; ROADMAP section 3).
        s._reset_mutation_maps(s.partitioner.num_leaves
                               if s.partitioner is not None else 1)
        # Decoded rows are not stored: reconstruct mode rebuilds them (and
        # the mean) from the codes, as the JAX package does on load.
        s._build_recon()
        return s
    if tname == "TreeXSearcher":
        from scann_torch.models import tree_x
        s = object.__new__(tree_x.TreeXSearcher)
        _init_base(s, scann_config, meta, dev, tensor, arrays, docids)
        s.part_cfg = scann_config.partitioning
        s.measure = cfg.internal_measure(scann_config.distance_measure)
        s.quantize_mode = scann_config.brute_force.quantize
        s.slot_rows = tensor("slot_rows")
        s.slot_leaf = tensor("slot_leaf")
        dpid = tensor("slot_dpid")
        s._inv_mult = tensor("tx_inv_mult")
        s._sq_norms = tensor("tx_sq_norms")
        s._num_slots = meta["num_slots"]
        s._chunk = meta["chunk"]
        s._sq_mode = meta.get("tx_mode") == "residual_int8"
        if s._sq_mode:
            from scann_torch.ops import pruned_scan
            tile = s.slot_rows.shape[1]
            s.slot_scale = tensor("tx_scale").reshape(-1, tile, 1)
            s._layout = pruned_scan.PrunedLayout(
                tensor("tx_tile_start"), tensor("tx_ntiles"),
                meta["max_ntiles"], meta["num_tiles"], dpid,
                tensor("tx_bias2").reshape(-1, tile, 1), tile)
        else:
            s.slot_dpid = dpid
        s.datapoint_to_token = arrays["datapoint_to_token"]
        s.partitioner = partitioner()
        if s.reorder_helper is not None and s.reorder_helper._leaf is not None:
            s.reorder_helper._centers = s.partitioner.centers
        return s
    raise ValueError(f"unknown searcher type in artifacts: {tname}")


def _init_base(s, scann_config, meta, dev, tensor, arrays, docids):
    from scann_torch.models import base
    s.config = scann_config
    s.device = dev
    s.n_points = meta["n_points"]
    s.dims = meta["dims"]
    s.docids = docids
    s._mut = None
    if "mut_vectors" in arrays:
        from scann_torch import mutation
        st = mutation.MutationState(arrays["mut_vectors"], docids)
        st.alive = np.array(arrays["mut_alive"], bool)
        st.docid_to_id = {d: i for i, d in enumerate(docids) if st.alive[i]}
        st.mutations_since_rebuild = meta.get("mutations_since_rebuild", 0)
        s._mut = st
    s._build_x_dev = None
    s._reorder_deferred = False
    s._crowding_attrs = None
    s.projector = None
    if "proj_out_dims" in meta:
        from scann_torch.ops import projection as proj_ops
        s.projector = proj_ops.Projector(matrix=tensor("proj_matrix"),
                                         out_dims=int(meta["proj_out_dims"]))
    s.reorder_helper = None
    if scann_config.reordering is not None:
        rh = object.__new__(base.ReorderHelper)
        rh.measure = cfg.internal_measure(scann_config.distance_measure)
        rh.config = scann_config.reordering
        rh._db = tensor("reorder_db")
        rh._inv_mult = tensor("reorder_inv_mult")
        rh._sq_norms = tensor("reorder_sq_norms")
        rh._leaf = tensor("reorder_leaf")
        rh._row_scale = tensor("reorder_row_scale")
        # Residual mode biases against the partitioner centers, which the
        # searcher branch sets once the partitioner is loaded.
        rh._centers = None
        s.reorder_helper = rh
