"""Leaf-sharded tree searcher over a ("data", "shard") DeviceMesh (port of
scann_tpu/parallel/mesh.py on torch.distributed).

A large index shards its leaves over the mesh's "shard" dim while query
batches split over its "data" dim.  Every rank runs the same code on its
own mesh coordinate (SPMD): shard ``s`` owns leaves ``[s * lps,
(s + 1) * lps)``, ``lps = ceil(num_leaves / n_shards)``, and only that
shard's tables are uploaded to the rank's device.

Search: centers (a few MB) are replicated; each rank tokenizes its slice
of the queries against all centers, scores only the slots of its shard
(the LUT16 one-hot product over its codes, or the exact int8 rows of the
sq format), rescores its own candidates against its int8 residual rows,
and all-gathers the per-shard (score, id) lists over the shard group, in
shard order, for the final dedup, crowding and top-k.  The results are
then all-gathered over the data group, so every rank returns the whole
batch, as the JAX package's single controller does.

Every method that touches the index is collective: each rank calls it
with the same arguments.  There is no hand kernel on this path: the JAX
sharded path reaches no Pallas call, so the scans stay plain torch on the
rank's device.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from scann_torch import config as cfg
from scann_torch.ops import ah as ah_ops
from scann_torch.ops import distance as dist_ops
from scann_torch.ops import lut16 as lut16_ops
from scann_torch.ops import topk as topk_ops
from scann_torch.parallel import layout as layout_ops
from scann_torch.partitioning.kmeans_tree import spilling_mask

# Queries scored at once on a rank (bounds the (queries, chunk) scores).
_QUERY_BLOCK = 2048
_TOKENIZE_BLOCK = 256   # upsert rows per (rows, leaves, d) numpy block


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def mesh_device(mesh) -> torch.device:
    """The device of this rank's tables: the CPU for a "cpu" mesh, the
    current CUDA device for a "cuda" mesh (which needs a card)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if mesh.device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unsupported mesh device type {mesh.device_type!r}")


def all_gather(t, group):
    """List form of all_gather: the group's tensors in group rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def all_gather_np(arr: np.ndarray, group, device) -> list:
    """All-gather a numpy array of any dtype (as bytes on ``device``)."""
    arr = np.ascontiguousarray(arr)
    raw = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    parts = all_gather(raw.to(device), group)
    return [p.cpu().numpy().view(arr.dtype).reshape(arr.shape)
            for p in parts]


def _dedup_slots(vals, dpids, slots):
    """Per-row duplicate suppression keeping the best score, with the slot
    of each kept copy (SOAR; DeduplicateDatabaseSpilledResults)."""
    order1 = torch.sort(-vals, dim=-1, stable=True).indices
    v = torch.gather(vals, -1, order1)
    d = torch.gather(dpids, -1, order1)
    sl = torch.gather(slots, -1, order1)
    order2 = torch.sort(d, dim=-1, stable=True).indices
    v = torch.gather(v, -1, order2)
    d = torch.gather(d, -1, order2)
    sl = torch.gather(sl, -1, order2)
    dup = torch.zeros_like(d, dtype=torch.bool)
    dup[..., 1:] = d[..., 1:] == d[..., :-1]
    dup = dup | (d == -1)
    return (torch.where(dup, float("-inf"), v), torch.where(dup, -1, d),
            torch.where(dup, -1, sl))


class ShardedTreeAHSearcher:
    """Leaf-sharded tree searcher over a 2-D ("data", "shard") mesh.

    Two leaf formats share one engine:
      * "ah": 4-bit AH codes scored by LUT16 one-hot products, then the
        exact residual-int8 rescore of the local candidates;
      * "sq": no codes; the residual per-row int8 rows are scored exactly,
        chunk by chunk, so selection and rescore are one pass (config tree
        + score_brute_force int8), d + 8 B a vector.

    Construct with build_sharded(), from_searcher() or load_sharded()."""

    def __init__(self, scann_config: cfg.ScannConfig, mesh,
                 codebook, centers, host_parts: dict,
                 shard_axis: str = "shard", data_axis: str = "data",
                 projector=None, query_spilling=None):
        self.config = scann_config
        self.part_cfg = scann_config.partitioning
        self.ah_cfg = scann_config.asymmetric_hash
        self.leaf_format = "ah" if self.ah_cfg is not None else "sq"
        self.measure = cfg.internal_measure(scann_config.distance_measure)
        self.user_measure = scann_config.distance_measure
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.data_axis = data_axis
        self.n_shards = mesh.size(mesh.mesh_dim_names.index(shard_axis))
        self.n_data = mesh.size(mesh.mesh_dim_names.index(data_axis))
        self.shard = mesh.get_local_rank(shard_axis)
        self.data_index = mesh.get_local_rank(data_axis)
        self.device = mesh_device(mesh)
        self._shard_group = mesh.get_group(shard_axis)
        self._data_group = mesh.get_group(data_axis)
        # Projected (PCA / OPQ / truncate) indexes: tokenization and code
        # scoring run in the projected space, the rescore rows are stored
        # absolute in the original space ("reorder stays raw").
        self.projector = projector
        self.absolute_rows = bool(host_parts.get("absolute_rows",
                                                 projector is not None))
        if query_spilling is None and self.part_cfg is not None:
            query_spilling = (
                self.part_cfg.query_spilling_type or "fixed_number",
                self.part_cfg.query_spilling_threshold or 0.0)
        qs = query_spilling or ("fixed_number", 0.0)
        self.query_spilling = (str(qs[0]), float(qs[1]))
        block_dims = host_parts.get("block_dims")
        self.model = (ah_ops.AHModel(
            codebook=torch.as_tensor(np.asarray(codebook),
                                     dtype=torch.float32).to(self.device),
            dims=int(host_parts.get("model_dims", host_parts["dims"])),
            block_dims=(None if block_dims is None else torch.as_tensor(
                np.asarray(block_dims)).to(self.device)))
            if codebook is not None else None)
        self.num_leaves = int(host_parts["num_leaves"])
        self._shard_chunk = int(host_parts["chunk"])
        # Every shard's slot_leaf / slot_dpid (n_shards, S); the heavy
        # tables of this shard only (1, S, ...).
        hp = dict(host_parts)
        self._shard_slots = int(hp["rows_i8"].shape[1])
        self._host_parts = hp
        self.n_points = int(max(0, np.asarray(hp["slot_dpid"]).max())) + 1
        self._crowding_attrs = None
        self.state = {"centers": self._dev(centers, torch.float32)}
        self._refresh_device()
        if self.model is not None:
            self.state["codebook"] = self.model.codebook
        if self.projector is not None and self.projector.matrix is not None:
            self.state["proj"] = self.projector.matrix.float().to(
                self.device)

    def _dev(self, a, dtype=None):
        """A device copy of a host array, never a view of it: a mutation
        reaches the device only through its slot writes, on the CPU too."""
        t = torch.from_numpy(np.array(a))
        return t.to(device=self.device, dtype=dtype or t.dtype)

    def _local(self, key):
        """This shard's row of a host table, (S, ...)."""
        hp = self._host_parts
        return hp[key][self.shard if key in ("slot_leaf", "slot_dpid")
                       else 0]

    # ---------------------------------------------------------- builders
    @classmethod
    def from_searcher(cls, searcher, database: np.ndarray, mesh,
                      shard_axis: str = "shard", data_axis: str = "data"):
        """Re-shard a fully built single-host tree-AH or tree-SQ searcher
        (the database rows are compressed to int8 for the rescore)."""
        if searcher.partitioner is None:
            raise ValueError("sharded search requires a partitioned index")
        projector = getattr(searcher, "projector", None)
        n_shards = mesh.size(mesh.mesh_dim_names.index(shard_axis))
        num_leaves = searcher.partitioner.num_leaves
        model_dims = None
        if getattr(searcher, "_sq_mode", False):
            # Tree-SQ: no codes; the residual rows re-derive from the
            # database (the sq format stores exactly them).
            slot_leaf = searcher.slot_leaf.cpu().numpy()
            slot_dpid = searcher.slot_dpid.cpu().numpy()
            codes = np.zeros((slot_leaf.shape[0], 0), np.uint8)
            codebook = None
        else:
            codes = np.asarray(searcher._host["codes"])
            slot_leaf = searcher.index.slot_leaf.cpu().numpy()
            slot_dpid = searcher.index.slot_dpid.cpu().numpy()
            codebook = searcher.model.codebook.cpu().numpy()
            model_dims = searcher.model.dims
        database = np.asarray(database, np.float32)
        centers = searcher.partitioner.centers.cpu().numpy()
        host_parts = layout_ops._layout_shards(
            codes, slot_leaf, slot_dpid, database, num_leaves, n_shards,
            dims=database.shape[1], centers=centers,
            absolute_rows=projector is not None,
            local_shard=mesh.get_local_rank(shard_axis))
        if model_dims is not None:
            host_parts["model_dims"] = model_dims
        if (codebook is not None
                and getattr(searcher.model, "block_dims", None) is not None):
            host_parts["block_dims"] = searcher.model.block_dims.cpu().numpy()
        part = searcher.partitioner
        return cls(searcher.config, mesh, codebook, centers, host_parts,
                   shard_axis, data_axis, projector=projector,
                   query_spilling=(part.query_spilling_type,
                                   part.query_spilling_threshold))

    def set_crowding(self, attributes):
        """Per-datapoint crowding attributes by global datapoint id (the
        single-host Searcher.set_crowding contract), replicated on every
        rank and gathered after the cross-shard merge."""
        attributes = np.asarray(attributes, np.int32)
        if attributes.ndim == 1:
            attributes = attributes[:, None]
        if attributes.ndim != 2 or attributes.shape[0] != self.n_points:
            raise ValueError(
                f"crowding attributes must have shape ({self.n_points},) "
                f"or ({self.n_points}, num_dims), got {attributes.shape}")
        self._crowding_attrs = self._dev(attributes)

    # ------------------------------------------------------- maintenance
    def get_health_stats(self):
        """Partition imbalance and occupancy from the slot tables (the
        single-host Searcher.get_health_stats)."""
        from scann_torch.utils import health
        hp = self._host_parts
        leaf = np.asarray(hp["slot_leaf"]).reshape(-1)
        dpid = np.asarray(hp["slot_dpid"]).reshape(-1)
        sizes = np.bincount(leaf[dpid >= 0], minlength=self.num_leaves)
        stats = health.HealthStats()
        stats.sum_partition_sizes = int(sizes.sum())
        (stats.partition_weighted_avg_relative_imbalance,
         stats.partition_avg_relative_positive_imbalance) = (
             health.partition_imbalance(sizes))
        return stats.as_dict()

    def _refresh_device(self, keys=("codes", "slot_leaf", "slot_dpid",
                                    "rows_i8", "rows_sq", "rows_scale")):
        """Upload this shard's tables whole."""
        for key in keys:
            if key == "codes" and self.leaf_format == "sq":
                continue  # the sq format stores no codes
            self.state[key] = self._dev(self._local(key))

    def _scatter_slots(self, sh_idx, sl_idx, keys):
        """Write a few (shard, slot) entries of the mutated host tables to
        the device, O(batch): each rank writes the entries of its own
        shard and drops the rest."""
        mine = np.asarray(sh_idx) == self.shard
        sl = np.asarray(sl_idx)[mine]
        if not len(sl):
            return
        sl_dev = self._dev(sl.astype(np.int64))
        for key in keys:
            self.state[key][sl_dev] = self._dev(self._local(key)[sl])

    def delete(self, ids):
        """Remove datapoints by global id, every slot copy (SOAR spills
        too).  KeyError, on every rank alike, for an id not present."""
        ids = np.asarray(ids, np.int64).ravel()
        hp = self._host_parts
        sd = np.asarray(hp["slot_dpid"])
        mask = np.isin(sd, ids)
        found = np.unique(sd[mask])
        missing = np.setdiff1d(ids, found)
        if len(missing):
            raise KeyError(f"datapoint ids not present: {missing[:8]}")
        sd[mask] = -1
        hp["slot_dpid"] = sd
        sh_idx, sl_idx = np.nonzero(mask)
        self._scatter_slots(sh_idx, sl_idx, ("slot_dpid",))

    def _tokenize(self, vp, centers):
        """Primary leaf (and SOAR's secondary) of each row, in numpy row
        blocks (each row's numbers do not depend on the block)."""
        soar = self.part_cfg.soar if self.part_cfg else None
        cols = [[], []]
        for s in range(0, len(vp), _TOKENIZE_BLOCK):
            v = vp[s:s + _TOKENIZE_BLOCK]
            diff = v[:, None, :] - centers[None, :, :]
            d2 = np.einsum("nld,nld->nl", diff, diff)
            prim = d2.argmin(axis=1).astype(np.int32)
            cols[0].append(prim)
            if soar is not None:
                r = v - centers[prim]
                rn = np.linalg.norm(r, axis=1, keepdims=True)
                r_hat = np.where(rn < 1e-7, 0.0,
                                 r / np.maximum(rn, 1e-20))
                proj = np.einsum("nld,nd->nl", diff, r_hat)
                score = d2 + float(soar.lambda_) * proj * proj
                score[np.arange(len(v)), prim] = np.inf
                cols[1].append(score.argmin(axis=1).astype(np.int32))
        return [np.concatenate(c) for c in cols if c]

    def upsert(self, ids, vectors):
        """Insert or update datapoints by global id: tokenize (and SOAR's
        secondary), encode with the shared codebook, int8-compress with
        fixed per-row multipliers, and place into free slots in the global
        (shard, slot) order (updates free the old copies first).  Growth
        adds whole chunks to every shard and re-uploads the tables; else
        only the touched slots are written."""
        ids = np.asarray(ids, np.int64).ravel()
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if len(ids) != len(vecs):
            raise ValueError("ids and vectors length mismatch")
        if self.user_measure == cfg.COSINE:
            vecs = vecs / np.maximum(
                np.linalg.norm(vecs, axis=1, keepdims=True), 1e-20)
        hp = self._host_parts
        sd = np.asarray(hp["slot_dpid"])
        # Update = delete + insert.
        mask = np.isin(sd, ids)
        del_sh, del_sl = np.nonzero(mask)
        sd[mask] = -1

        centers = self.state["centers"].cpu().numpy()
        # Projected indexes tokenize and encode in the projected space;
        # the int8 rescore rows stay absolute in the original space.
        if self.projector is not None:
            vp = self.projector.project(
                self._dev(vecs, torch.float32)).cpu().numpy()
        else:
            vp = vecs
        token_cols = self._tokenize(vp, centers)

        sq_fmt = self.leaf_format == "sq"
        threshold = (float("nan") if sq_fmt
                     else self.ah_cfg.anisotropic_quantization_threshold)
        residual = sq_fmt or bool(self.ah_cfg.residual_quantization)
        new_rows = []  # (slot_leaf, dpid, codes, rows_i8, rows_sq, scale)
        for col in token_cols:
            v = vp - centers[col] if residual else vp
            if sq_fmt:
                codes = np.zeros((len(vecs), 0), np.uint8)
            elif not math.isnan(threshold):
                codes = ah_ops.encode_noise_shaped(
                    self._dev(v), self._dev(vp), self.model,
                    threshold).cpu().numpy()
            else:
                codes = ah_ops.encode(self._dev(v), self.model).cpu().numpy()
            # Residual int8 rescore rows against this slot's center;
            # absolute rows for projected indexes.
            c_rows = (np.zeros_like(vecs) if self.absolute_rows
                      else centers[col])
            q, sqn, scale = layout_ops.compress_rows(vecs - c_rows, c_rows)
            new_rows.append((col, ids.astype(np.int32), codes, q,
                             sqn.astype(np.float32), scale))

        total_new = sum(len(r[0]) for r in new_rows)
        free_sh, free_slot = np.nonzero(sd < 0)
        grew = len(free_sh) < total_new
        if grew:
            grow = _round_up(total_new - len(free_sh), self._shard_chunk)
            for key, fill in (("codes", 0), ("slot_leaf", 0),
                              ("slot_dpid", -1), ("rows_i8", 0),
                              ("rows_sq", 0.0), ("rows_scale", 0.0)):
                a = sd if key == "slot_dpid" else np.asarray(hp[key])
                pad = [(0, 0), (0, grow)] + [(0, 0)] * (a.ndim - 2)
                hp[key] = np.pad(a, pad, constant_values=fill)
            sd = hp["slot_dpid"]
            self._shard_slots = sd.shape[1]
            free_sh, free_slot = np.nonzero(sd < 0)
        hp["slot_dpid"] = sd
        leaf_tab = np.asarray(hp["slot_leaf"])
        heavy = {key: np.asarray(hp[key]) for key in layout_ops.HEAVY_KEYS}
        cursor = 0
        for col, dpids, codes, q, sqn, scale in new_rows:
            take = slice(cursor, cursor + len(dpids))
            sh, sl = free_sh[take], free_slot[take]
            leaf_tab[sh, sl] = col
            sd[sh, sl] = dpids
            mine = sh == self.shard
            for key, vals in (("codes", codes), ("rows_i8", q),
                              ("rows_sq", sqn), ("rows_scale", scale)):
                heavy[key][0, sl[mine]] = vals[mine]
            cursor += len(dpids)
        hp.update(slot_leaf=leaf_tab, slot_dpid=sd, **heavy)
        self.n_points = max(self.n_points, int(ids.max()) + 1)
        if grew:
            # Every shard's tables changed shape: the one O(index) path
            # (bulk loads size the capacity with build_sharded_streaming).
            self._refresh_device()
            return
        touched_sh = np.concatenate([del_sh, free_sh[:total_new]])
        touched_sl = np.concatenate([del_sl, free_slot[:total_new]])
        flat = touched_sh.astype(np.int64) * self._shard_slots + touched_sl
        _, first = np.unique(flat, return_index=True)
        keys = ("slot_leaf", "slot_dpid", "rows_i8", "rows_sq", "rows_scale")
        if self.leaf_format == "ah":
            keys = keys + ("codes",)
        self._scatter_slots(touched_sh[first], touched_sl[first], keys)

    # ------------------------------------------------------------ search
    def _project(self, queries):
        if "proj" in self.state:
            return queries @ self.state["proj"]
        if self.projector is not None:
            return queries[:, :self.projector.out_dims]
        return queries

    def _leaf_mask(self, q_t, leaves, pre_tok, with_bias):
        """(nq, L) mask of the searched leaves and, for residual scoring,
        (nq, L) f32 q.c bias at those leaves (None otherwise)."""
        num_leaves = self.num_leaves
        centers = self.state["centers"]
        nq = q_t.shape[0]
        bias_src = None
        if pre_tok is not None:
            # Per-query leaf lists replace tokenization; -1 entries search
            # fewer leaves for that query.
            leaf_ids = torch.clamp_min(pre_tok, 0).long()
            tgt = torch.where(pre_tok >= 0, leaf_ids, num_leaves)
            if with_bias:
                bias_src = torch.einsum("nd,nld->nl", q_t,
                                        centers[leaf_ids])
        else:
            sims_qc = dist_ops.similarity(q_t, centers, self.measure)
            center_sims, leaf_ids = topk_ops.top_k(sims_qc, leaves)
            leaf_ids = leaf_ids.long()
            spill_type, spill_thr = self.query_spilling
            if spill_type != "fixed_number":
                # Distance-conditioned query spilling: ``leaves`` is the
                # most searched, the threshold masks the tail.
                keep = spilling_mask(center_sims, spill_type, spill_thr)
                tgt = torch.where(keep, leaf_ids, num_leaves)
            else:
                tgt = leaf_ids
            bias_src = center_sims if with_bias else None
        mask = torch.zeros((nq, num_leaves + 1), dtype=torch.bool,
                           device=q_t.device)
        mask.scatter_(1, tgt, True)
        bias = None
        if bias_src is not None:
            bias = torch.zeros((nq, num_leaves + 1), dtype=torch.float32,
                               device=q_t.device)
            bias.scatter_(1, tgt, bias_src.float())
            bias = bias[:, :num_leaves]
        return mask[:, :num_leaves], bias

    def _scan(self, nq, k_fetch, score_chunk, mask, allow):
        """Chunked masked top-k_fetch over this shard's slots;
        ``score_chunk(start, stop)`` gives the (nq, chunk) similarities.
        Returns (vals, local slots)."""
        chunk = self._shard_chunk
        slot_leaf = self.state["slot_leaf"]
        slot_dpid = self.state["slot_dpid"]
        vals = torch.full((nq, k_fetch), float("-inf"), device=self.device)
        pos = torch.full((nq, k_fetch), -1, dtype=torch.int32,
                         device=self.device)
        for start in range(0, self._shard_slots, chunk):
            stop = start + chunk
            leaf_c = slot_leaf[start:stop].long()
            dpid_c = slot_dpid[start:stop]
            sim = score_chunk(start, stop, leaf_c)
            vmask = (dpid_c >= 0)[None, :] & mask[:, leaf_c]
            if allow is not None:
                ok = allow[torch.clamp(dpid_c, 0, allow.shape[0] - 1).long()]
                vmask = vmask & ok[None, :]
            cvals, cpos = topk_ops.chunk_top_k(sim, min(k_fetch, chunk),
                                               valid=vmask)
            cslot = torch.where(cpos >= 0, start + cpos, -1).to(torch.int32)
            vals, pos = topk_ops.merge_top_k(vals, pos, cvals, cslot,
                                             k_fetch)
        return vals, pos

    def _merge_shards(self, vals, dpids, k, limits, attrs):
        """All-gather the per-shard candidate lists over the shard group
        (concatenated in shard order), dedup SOAR copies, crowd, top-k."""
        g_vals = torch.cat(all_gather(vals, self._shard_group), dim=1)
        g_ids = torch.cat(all_gather(dpids, self._shard_group), dim=1)
        if self.part_cfg is not None and self.part_cfg.soar is not None:
            # A spilled datapoint's two copies can live on different
            # shards: keep the best after the gather.
            g_vals, g_ids = topk_ops.dedup_candidates(g_vals, g_ids)
        if limits:
            a_g = attrs[torch.clamp(g_ids, 0, attrs.shape[0] - 1).long()]
            g_vals, g_ids = topk_ops.crowding_filter_multi(
                g_vals, g_ids, a_g, limits)
        vals_k, posk = topk_ops.top_k(g_vals, min(k, g_vals.shape[-1]))
        ids_k = torch.gather(g_ids, -1, posk.long())
        ids_k = torch.where(torch.isneginf(vals_k), -1, ids_k)
        return ids_k, dist_ops.similarity_to_user_distance(
            vals_k, self.user_measure)

    def _step_ah(self, queries, k, k_pre, leaves, allow, attrs,
                 crowding_limit, pre_crowding_limit, pre_tok):
        """This rank's part of one query block in the ah format."""
        ah = self.ah_cfg
        soar = self.part_cfg.soar if self.part_cfg else None
        lookup = "int8" if ah.lookup_type == "reconstruct" else ah.lookup_type
        k_fetch = (int(math.ceil(k_pre * soar.overretrieve_factor))
                   if soar is not None else k_pre)
        k_fetch = min(k_fetch, self._shard_slots)
        st = self.state
        q_t = self._project(queries)
        luts = ah_ops.build_luts(q_t, self.model, self.measure, lookup)
        mask, bias = self._leaf_mask(q_t, leaves, pre_tok,
                                     bool(ah.residual_quantization))
        codes = st["codes"]
        cpb = ah.clusters_per_block

        def score_chunk(start, stop, leaf_c):
            sim = lut16_ops.score_codes_chunk(codes[start:stop], luts, cpb)
            return sim if bias is None else sim + bias[:, leaf_c]

        vals, lslots = self._scan(queries.shape[0], k_fetch, score_chunk,
                                  mask, allow)
        vals = vals + luts.base[:, None]
        safe = torch.clamp_min(lslots, 0).long()
        dpids = torch.where(lslots >= 0, st["slot_dpid"][safe], -1)
        if soar is not None:
            vals, dpids, lslots = _dedup_slots(vals, dpids, lslots)
        if pre_crowding_limit:
            # Pre-reordering crowding on this shard's AH scores; the same
            # caps apply again after the cross-shard merge.
            a_pre = attrs[torch.clamp(dpids, 0, attrs.shape[0] - 1).long()]
            vals, dpids_f = topk_ops.crowding_filter_multi(
                vals, dpids, a_pre, pre_crowding_limit)
            lslots = torch.where(dpids_f < 0, -1, lslots)
            dpids = dpids_f
        # Exact local rescore on the residual int8 rows: each slot stores
        # x - c_{slot_leaf} with a per-row scale; the exact q.c bias comes
        # from the replicated float centers.
        safe = torch.clamp_min(lslots, 0)
        qd = dist_ops.one_to_many_gathered(queries, st["rows_i8"], safe,
                                           cfg.DOT_PRODUCT)
        qd = qd * st["rows_scale"][safe.long()]
        if self.absolute_rows:
            dots_x = qd
        else:
            qc_dot = queries @ st["centers"].T
            dots_x = qd + torch.gather(qc_dot, 1,
                                       st["slot_leaf"][safe.long()].long())
        if self.measure == cfg.SQUARED_L2:
            q_sq = (queries * queries).sum(-1, keepdim=True)
            row_sq = st["rows_sq"][safe.long()]
            exact = -torch.clamp_min(q_sq - 2.0 * dots_x + row_sq, 0.0)
        else:
            exact = dots_x
        exact = torch.where(lslots >= 0, exact, float("-inf"))
        lims = crowding_limit or pre_crowding_limit
        if crowding_limit and pre_crowding_limit:
            lims = tuple(min(a, b) for a, b in zip(crowding_limit,
                                                   pre_crowding_limit))
        return self._merge_shards(exact, dpids, k, lims, attrs)

    def _step_sq(self, queries, k, leaves, allow, attrs, crowding_limit,
                 pre_tok):
        """This rank's part of one query block in the sq format: exact
        scores, so selection and rescore are one pass; under SOAR each
        shard fetches 2k and the copies dedup after the gather."""
        soar = self.part_cfg.soar if self.part_cfg else None
        k_fetch = min(2 * k if soar is not None else k, self._shard_slots)
        st = self.state
        q_t = self._project(queries)
        mask, _ = self._leaf_mask(q_t, leaves, pre_tok, False)
        # Exact f32 q.c per leaf (none for absolute rows), the bf16 query
        # against int8 rows with float32 sums: bf16 x int8 products are
        # exact in float32.
        qc_dot = None if self.absolute_rows else queries @ st["centers"].T
        q_bf = queries.to(torch.bfloat16).float()
        q_sq = (queries * queries).sum(-1)
        rows_i8, scale, rows_sq = st["rows_i8"], st["rows_scale"], \
            st["rows_sq"]

        def score_chunk(start, stop, leaf_c):
            qx = (q_bf @ rows_i8[start:stop].float().T) \
                * scale[start:stop][None, :]
            if qc_dot is not None:
                qx = qx + qc_dot[:, leaf_c]
            if self.measure == cfg.SQUARED_L2:
                return -(q_sq[:, None] - 2.0 * qx
                         + rows_sq[start:stop][None, :])
            return qx

        vals, lslots = self._scan(queries.shape[0], k_fetch, score_chunk,
                                  mask, allow)
        dpids = torch.where(lslots >= 0,
                            st["slot_dpid"][torch.clamp_min(lslots, 0)
                                            .long()], -1)
        return self._merge_shards(vals, dpids, k, crowding_limit, attrs)

    def _crowding_tuple(self, lim, kwarg_name):
        if lim is None:
            return ()
        if self._crowding_attrs is None:
            raise ValueError("call set_crowding(attributes) before "
                             "searching with " + kwarg_name)
        num_dims = self._crowding_attrs.shape[1]
        if np.isscalar(lim):
            return (int(lim),) * num_dims
        out = tuple(int(x) for x in lim)
        if len(out) != num_dims:
            raise ValueError(
                f"expected {num_dims} crowding limits, got {len(out)}")
        return out

    def search_batched(self, queries, final_num_neighbors=None,
                       pre_reorder_num_neighbors=None, leaves_to_search=None,
                       restrict_allowlist=None,
                       per_crowding_attribute_num_neighbors=None,
                       pre_tokenized_leaves=None,
                       post_reordering_epsilon=None,
                       per_crowding_attribute_pre_reordering_num_neighbors=(
                           None)):
        """Sharded batched search with the single-host keyword arguments:
        restricts (the allowlist replicated and masked per shard),
        crowding (call set_crowding first; the cap applies after the
        cross-shard merge), pre-tokenized per-query leaf lists (split with
        the queries), per-query k and epsilons (on the host).  Every rank
        returns the whole batch's (ids int32, distances float32)."""
        crowding_limit = self._crowding_tuple(
            per_crowding_attribute_num_neighbors,
            "per_crowding_attribute_num_neighbors")
        pre_crowding_limit = self._crowding_tuple(
            per_crowding_attribute_pre_reordering_num_neighbors,
            "per_crowding_attribute_pre_reordering_num_neighbors")
        # Per-query result counts: sized by the largest, each query's
        # tail masked after the sorted merge.
        k_arr = None
        if final_num_neighbors is not None and np.ndim(final_num_neighbors):
            k_arr = np.asarray(final_num_neighbors, np.int64)
            if k_arr.ndim != 1 or len(k_arr) != len(queries):
                raise ValueError(
                    "per-query final_num_neighbors must be a 1-D array "
                    "with one entry per query")
            k = int(k_arr.max())
        else:
            k = final_num_neighbors or self.config.num_neighbors
        k_pre = k
        if self.config.reordering is not None:
            k_pre = self.config.reordering.reordering_num_neighbors
        if pre_reorder_num_neighbors:
            k_pre = pre_reorder_num_neighbors
        k_pre = max(k, k_pre)
        leaves = leaves_to_search or self.part_cfg.num_leaves_to_search
        leaves = max(1, min(leaves, self.num_leaves))
        queries = np.asarray(queries, np.float32)
        if self.user_measure == cfg.COSINE:
            queries = queries / np.maximum(
                np.linalg.norm(queries, axis=1, keepdims=True), 1e-20)
        nq = queries.shape[0]
        bucket = _round_up(max(nq, self.n_data), self.n_data)
        padded = np.zeros((bucket, queries.shape[1]), np.float32)
        padded[:nq] = queries
        pt_padded = None
        if pre_tokenized_leaves is not None:
            pre_tok = np.asarray(pre_tokenized_leaves, np.int32)
            if pre_tok.ndim != 2 or pre_tok.shape[0] != nq:
                raise ValueError(
                    f"pre_tokenized_leaves must be (num_queries, L), got "
                    f"{pre_tok.shape}")
            if pre_tok.max() >= self.num_leaves:
                raise ValueError("pre_tokenized leaf id out of range")
            if pre_tok.shape[1] > self.num_leaves:
                raise ValueError(
                    f"pre_tokenized_leaves is wider ({pre_tok.shape[1]}) "
                    f"than num_leaves ({self.num_leaves})")
            pt_padded = np.full((bucket, pre_tok.shape[1]), -1, np.int32)
            pt_padded[:nq] = pre_tok
        allow = None
        if restrict_allowlist is not None:
            allow = self._dev(np.asarray(restrict_allowlist, bool))
        attrs = self._crowding_attrs
        # This rank's slice of the bucket, in query blocks.
        per = bucket // self.n_data
        lo = self.data_index * per
        ids_parts, dist_parts = [], []
        for s in range(lo, lo + per, _QUERY_BLOCK):
            e = min(s + _QUERY_BLOCK, lo + per)
            q = self._dev(padded[s:e])
            pt = None if pt_padded is None else self._dev(pt_padded[s:e])
            if self.leaf_format == "sq":
                # Exact leaves: no reorder stage, so the pre-reordering
                # cap is the post cap (the tighter per dimension).
                lims = crowding_limit
                if pre_crowding_limit:
                    lims = (tuple(min(a, b) for a, b in zip(
                        crowding_limit, pre_crowding_limit))
                        if crowding_limit else pre_crowding_limit)
                ids_b, dist_b = self._step_sq(q, k, leaves, allow, attrs,
                                              lims, pt)
            else:
                ids_b, dist_b = self._step_ah(q, k, k_pre, leaves, allow,
                                              attrs, crowding_limit,
                                              pre_crowding_limit, pt)
            ids_parts.append(ids_b)
            dist_parts.append(dist_b)
        ids_l = torch.cat(ids_parts).to(torch.int32)
        dist_l = torch.cat(dist_parts).float()
        idx = torch.cat(all_gather(ids_l, self._data_group)).cpu().numpy()
        dist = torch.cat(all_gather(dist_l, self._data_group)).cpu().numpy()
        idx, dist = idx[:nq], dist[:nq]
        if post_reordering_epsilon is not None:
            eps = np.asarray(post_reordering_epsilon, np.float32)
            if eps.ndim:  # per-query epsilon vector
                if eps.shape != (nq,):
                    raise ValueError(
                        "per-query post_reordering_epsilon must have one "
                        "entry per query")
                eps = eps[:, None]
            if self.config.distance_measure == cfg.DOT_PRODUCT:
                bad = ~(dist >= eps)
            else:
                bad = ~(dist <= eps)
            idx = np.where(bad, -1, idx)
            dist = np.where(bad, np.nan, dist)
        if k_arr is not None:
            tail = np.arange(k)[None, :] >= k_arr[:, None]
            idx = np.where(tail, -1, idx)
            dist = np.where(tail, np.nan, dist)
        return idx, dist

    # -------------------------------------------------------- persistence
    def gather_host_parts(self) -> dict:
        """Every shard's host tables on every rank (collective over the
        shard group): the JAX package's (n_shards, S, ...) layout."""
        hp = dict(self._host_parts)
        for key in layout_ops.HEAVY_KEYS:
            parts = all_gather_np(np.asarray(hp[key])[0],
                                  self._shard_group, self.device)
            hp[key] = np.stack(parts)
        return hp

    def serialize(self, artifacts_dir: str):
        """Write ``sharded_assets.npz`` and ``sharded_config.json`` in the
        JAX package's format (collective; rank 0 writes, and every rank
        returns after the files exist)."""
        hp = self.gather_host_parts()
        if dist.get_rank() == 0:
            os.makedirs(artifacts_dir, exist_ok=True)
            extra = ({} if self.model is None
                     else {"codebook": self.model.codebook.cpu().numpy()})
            if self.model is not None and self.model.block_dims is not None:
                extra["block_dims"] = self.model.block_dims.cpu().numpy()
            if (self.projector is not None
                    and self.projector.matrix is not None):
                extra["proj_matrix"] = self.projector.matrix.cpu().numpy()
            np.savez(os.path.join(artifacts_dir, "sharded_assets.npz"),
                     codes=hp["codes"], slot_leaf=hp["slot_leaf"],
                     slot_dpid=hp["slot_dpid"], rows_i8=hp["rows_i8"],
                     rows_sq=hp["rows_sq"], rows_scale=hp["rows_scale"],
                     centers=self.state["centers"].cpu().numpy(), **extra)
            meta = {"num_leaves": self.num_leaves,
                    "dims": int(hp["dims"]),
                    "chunk": self._shard_chunk,
                    "n_shards": self.n_shards,
                    "leaf_format": self.leaf_format,
                    "config": json.loads(self.config.to_json())}
            if self.projector is not None:
                meta["proj_out_dims"] = int(self.projector.out_dims)
                meta["absolute_rows"] = bool(self.absolute_rows)
            if "model_dims" in hp:
                meta["model_dims"] = int(hp["model_dims"])
            with open(os.path.join(artifacts_dir, "sharded_config.json"),
                      "w") as f:
                json.dump(meta, f, indent=2)
        dist.barrier()


def load_sharded(artifacts_dir: str, mesh, shard_axis: str = "shard",
                 data_axis: str = "data") -> ShardedTreeAHSearcher:
    """Load a sharded index written by either package; each rank keeps
    its own shard."""
    with open(os.path.join(artifacts_dir, "sharded_config.json")) as f:
        meta = json.load(f)
    n_shards = mesh.size(mesh.mesh_dim_names.index(shard_axis))
    if meta["n_shards"] != n_shards:
        raise ValueError(
            f"index was sharded {meta['n_shards']}-way; mesh has "
            f"{n_shards} shards")
    scann_config = cfg._config_from_dict(meta["config"])
    shard = mesh.get_local_rank(shard_axis)
    with np.load(os.path.join(artifacts_dir, "sharded_assets.npz")) as raw:
        if "rows_scale" not in raw.files:
            raise ValueError(
                "sharded artifacts predate residual per-row rescore (no "
                "rows_scale); rebuild the sharded index")
        host_parts = {k: np.array(raw[k][shard:shard + 1])
                      if k in layout_ops.HEAVY_KEYS else np.array(raw[k])
                      for k in ("codes", "slot_leaf", "slot_dpid",
                                "rows_i8", "rows_sq", "rows_scale")}
        extra = {k: np.array(raw[k]) for k in
                 ("codebook", "block_dims", "proj_matrix", "centers")
                 if k in raw.files}
    host_parts.update(num_leaves=meta["num_leaves"], dims=meta["dims"],
                      chunk=meta["chunk"])
    if "model_dims" in meta:
        host_parts["model_dims"] = meta["model_dims"]
    if "absolute_rows" in meta:
        host_parts["absolute_rows"] = bool(meta["absolute_rows"])
    if "block_dims" in extra:
        host_parts["block_dims"] = extra["block_dims"]
    projector = None
    if "proj_out_dims" in meta:
        from scann_torch.ops.projection import Projector
        mat = extra.get("proj_matrix")
        projector = Projector(
            matrix=None if mat is None else torch.as_tensor(mat),
            out_dims=int(meta["proj_out_dims"]))
    return ShardedTreeAHSearcher(scann_config, mesh, extra.get("codebook"),
                                 extra["centers"], host_parts, shard_axis,
                                 data_axis, projector=projector)
