"""Sharded index build over a ("data", "shard") DeviceMesh (port of the
build half of scann_tpu/parallel/mesh.py).

  1. A streaming reservoir sample (numpy, the JAX package's draws) and
     k-means on it: one engine on rank 0 below 2^25 sample floats,
     data-parallel Lloyd steps over every rank above (sums and counts
     all-reduced, ``sharded_kmeans_step``); oversized partitions split on
     the sample; the optional AVQ refit from per-leaf sufficient
     statistics that every rank accumulates over its rows, all-reduced.
  2. The AH codebook on sampled residuals (rank 0).
  3. A second streaming pass: each chunk's rows split over every rank,
     which tokenizes (and SOAR's secondary), encodes and int8-compresses
     its slice; the outputs are all-gathered in row order and each rank
     keeps the leaf and dpid of every slot and the heavy columns of its
     own shard.
  4. The per-shard leaf-sorted layout (parallel/layout.py).

``jax.random`` becomes ``torch.Generator`` seeded from ``config.seed``
(k-means) and ``seed + 1`` (the codebook), so a build matches the JAX
package's only statistically; the reservoir sample is the same.  Rank 0
trains and broadcasts what every rank must hold alike (centers,
codebook), so the ranks never diverge.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from scann_torch import config as cfg
from scann_torch.ops import ah as ah_ops
from scann_torch.ops import distance as dist_ops
from scann_torch.ops import kmeans as kmeans_ops
from scann_torch.parallel import layout as layout_ops
from scann_torch.parallel import mesh as mesh_ops
from scann_torch.partitioning import kmeans_tree as kt
from scann_torch.utils import transfer

_log = logging.getLogger("scann_torch")

# Rows per streamed chunk of build_sharded (bounds device memory).
_BUILD_CHUNK = 1 << 17
# Rows per assignment block on a single compute device: bounds the
# (rows, leaves) f32 intermediates to about 512 MB.
_ASSIGN_BYTES = 1 << 29
# Sample floats up to which one k-means engine trains the centers (the
# JAX package's bound); above it, data-parallel Lloyd steps.
_SINGLE_ENGINE_FLOATS = 1 << 25


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def build_sharded(database: np.ndarray, scann_config: cfg.ScannConfig,
                  mesh, shard_axis: str = "shard",
                  data_axis: str = "data"):
    """Sharded build from an in-memory array (every rank passes the same
    one): the streaming build over fixed-size chunks."""
    database = np.asarray(database, np.float32)

    def chunks():
        for s in range(0, len(database), _BUILD_CHUNK):
            yield database[s:s + _BUILD_CHUNK]

    return build_sharded_streaming(chunks, scann_config, mesh,
                                   shard_axis=shard_axis,
                                   data_axis=data_axis)


def _reservoir_sample(chunks, sample_size: int, rng) -> tuple:
    """One streaming pass: a uniform reservoir sample (the reference's
    reservoir sampling) and the total row count, with the JAX package's
    numpy draws."""
    reservoir = None
    n_seen = 0
    for rows in chunks:
        rows = np.asarray(rows, np.float32)
        m = rows.shape[0]
        if reservoir is None:
            reservoir = np.empty((sample_size, rows.shape[1]), np.float32)
        take_direct = min(max(sample_size - n_seen, 0), m)
        if take_direct:
            reservoir[n_seen:n_seen + take_direct] = rows[:take_direct]
        if m > take_direct:
            # Vectorized reservoir replacement for the remainder.
            idx = np.arange(n_seen + take_direct + 1, n_seen + m + 1)
            j = (rng.random(m - take_direct) * idx).astype(np.int64)
            sel = np.nonzero(j < sample_size)[0]
            reservoir[j[sel]] = rows[take_direct + sel]
        n_seen += m
    if reservoir is None:
        raise ValueError("empty database")
    return reservoir[:min(sample_size, n_seen)], n_seen


def sharded_kmeans_step(x_local, centers, mesh, data_axis: str = "data",
                        valid_rows: Optional[int] = None):
    """One data-parallel Lloyd iteration: this rank assigns its rows
    ``x_local`` (its equal slice of the padded global rows, in data-axis
    order), and the per-center sums and counts are all-reduced over the
    data group; with ``mesh`` None, over every rank of the group, in rank
    order.  ``valid_rows`` masks the zero padding at the tail of the
    global row count."""
    x = torch.as_tensor(x_local, dtype=torch.float32)
    c = torch.as_tensor(centers, dtype=torch.float32).to(x.device)
    k = c.shape[0]
    c_sq = (c * c).sum(-1)
    a = torch.argmin(c_sq[None, :] - 2.0 * (x @ c.T), dim=-1)
    w = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
    if mesh is None:
        dev, group = dist.get_rank(), None
    else:
        dev, group = (mesh.get_local_rank(data_axis),
                      mesh.get_group(data_axis))
    if valid_rows is not None:
        global_row = dev * x.shape[0] + torch.arange(x.shape[0],
                                                     device=x.device)
        w = (global_row < valid_rows).float()
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32,
                       device=x.device).index_add_(0, a, x * w[:, None])
    counts = torch.zeros((k,), dtype=torch.float32,
                         device=x.device).index_add_(0, a, w)
    dist.all_reduce(sums, group=group)
    dist.all_reduce(counts, group=group)
    new_c = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where((counts > 0)[:, None], new_c, c)


class _Ranks:
    """This rank's place in the build: its flat position in the mesh
    (row order), its shard, the world's communication device."""

    def __init__(self, mesh, shard_axis):
        flat = mesh.mesh.flatten()
        self.n = int(flat.numel())
        if flat.tolist() != list(range(dist.get_world_size())):
            raise ValueError("the mesh must hold every rank of the group, "
                             "in rank order")
        self.pos = dist.get_rank()   # rows are gathered in rank order
        self.lead = self.pos == 0
        self.root = 0
        self.shard = mesh.get_local_rank(shard_axis)
        self.device = mesh_ops.mesh_device(mesh)

    def bcast(self, obj):
        """Rank 0's object (numpy arrays, ints) on every rank."""
        box = [obj if self.lead else None]
        dist.broadcast_object_list(box, src=self.root)
        return box[0]

    def gather_rows(self, parts):
        """All-gather per-row outputs (1-D or 2-D tensors of any dtype,
        equal rows on every rank) in rank order, as one byte matrix."""
        packed, spec = _pack(parts)
        got = mesh_ops.all_gather(packed.to(self.device), None)
        return _unpack(torch.cat(got).cpu(), spec)

    def bcast_rows(self, parts, spec):
        """Rank 0's per-row outputs on every rank (``spec``: the row count
        and each output's (dtype, width))."""
        m, fields = spec
        width = sum(torch.empty((), dtype=dt).element_size()
                    * (1 if w is None else w) for dt, w in fields)
        if self.lead:
            packed, _ = _pack(parts)
            packed = packed.to(self.device)
        else:
            packed = torch.empty((m, width), dtype=torch.uint8,
                                 device=self.device)
        dist.broadcast(packed, src=self.root)
        return _unpack(packed.cpu(), (fields,))


def _pack(parts):
    """Per-row tensors -> one (m, bytes) uint8 matrix and its layout."""
    cols, fields = [], []
    for t in parts:
        t = t.contiguous()
        width = t.shape[1] if t.ndim == 2 else None
        fields.append((t.dtype, width))
        t2 = t if t.ndim == 2 else t[:, None]
        if t2.shape[1]:
            cols.append(t2.view(torch.uint8).reshape(t2.shape[0], -1))
    m = parts[0].shape[0]
    packed = (torch.cat(cols, dim=1) if cols
              else torch.empty((m, 0), dtype=torch.uint8))
    return packed, (fields,)


def _unpack(packed, spec):
    (fields,) = spec
    out, off = [], 0
    for dt, width in fields:
        w = 1 if width is None else width
        nbytes = torch.empty((), dtype=dt).element_size() * w
        raw = packed[:, off:off + nbytes].contiguous()
        off += nbytes
        t = (raw.view(dt) if w else
             torch.empty((packed.shape[0], 0), dtype=dt))
        out.append(t[:, 0] if width is None else t)
    return out


def _field_spec(m, dims, num_blocks, soar):
    one = ((torch.int32, None), (torch.uint8, num_blocks),
           (torch.int8, dims), (torch.float32, None), (torch.float32, None))
    return m, (one + one if soar else one)


def build_sharded_streaming(chunks_fn, scann_config: cfg.ScannConfig,
                            mesh, shard_axis: str = "shard",
                            data_axis: str = "data",
                            compute_device=None,
                            spill_dir: Optional[str] = None):
    """Sharded build that never holds the float32 database: ``chunks_fn``
    returns a fresh iterator of (m, d) float32 row chunks (called for the
    sample, for the AVQ pass when configured, and for the encode pass),
    the same on every rank.  Host memory is one chunk plus the compressed
    index.

    ``compute_device``: one device (a ``torch.device`` or its name) on
    which rank 0 runs every compute pass (k-means, tokenize, SOAR,
    encode) alone and broadcasts the outputs, while the index is laid out
    for and served from ``mesh`` ("build on one big card, serve on a
    mesh").  Without it each rank computes on its own device.

    ``spill_dir``: disk-backed build state (parallel/layout.py,
    _SpillState): the trained centers and codebook, append-only encode
    spills with chunk-granular progress, and a memmap layout, so host RAM
    stays O(one chunk) and a crashed build resumes from its last
    committed chunk when rerun with the same directory.  The index is
    bit-identical to the in-memory build's."""
    part = scann_config.partitioning
    ah = scann_config.asymmetric_hash
    bf = scann_config.brute_force
    sq_mode = (ah is None and bf is not None and bf.quantize == cfg.INT8)
    if part is None or (ah is None and not sq_mode):
        raise ValueError(
            "build_sharded requires tree + score_ah, or tree + "
            "score_brute_force(quantize='int8') for the exact sq format")
    soar = part.soar
    # The sq format always stores residual rows; the AH format follows
    # ah.residual_quantization (set by the builder from the internal
    # measure), as search assumes.
    residual = sq_mode or bool(ah.residual_quantization)
    is_cosine = scann_config.distance_measure == cfg.COSINE
    if soar is not None and not residual:
        raise ValueError("SOAR requires residual quantization")
    if scann_config.projection is not None:
        raise ValueError(
            "the streaming sharded build does not train projections; "
            "build a single-host projected searcher and shard it with "
            "ShardedTreeAHSearcher.from_searcher")
    seed = scann_config.seed
    rng = np.random.default_rng(seed)
    ranks = _Ranks(mesh, shard_axis)
    n_shards = mesh.size(mesh.mesh_dim_names.index(shard_axis))
    if compute_device is not None:
        comp = torch.device(compute_device)
        if comp.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("compute_device is a CUDA device but CUDA "
                               "is not available")
        build_block = max(1024, 1 << int(math.log2(max(
            1024, _ASSIGN_BYTES // max(4 * part.num_leaves, 1)))))
    else:
        comp = ranks.device
        build_block = None

    def _norm(rows):
        if not is_cosine:
            return rows
        return rows / np.maximum(
            np.linalg.norm(rows, axis=1, keepdims=True), 1e-20)

    def _put(x):
        return transfer.to_device(x, device=comp)

    spill = (layout_ops._SpillState(spill_dir, n_shards, writer=ranks.lead)
             if spill_dir is not None else None)
    if spill is not None:
        dist.barrier()   # the directory exists before anyone reads it
    ph = spill.load_phase1() if spill is not None else None
    if ph is None:
        # -- 1. streaming reservoir sample + k-means.
        sample, n = _reservoir_sample(
            map(_norm, chunks_fn()), min(part.training_sample_size, 1 << 30),
            rng)
        sample_n, d = sample.shape
        if compute_device is not None or sample_n * d <= _SINGLE_ENGINE_FLOATS:
            # The sample fits one device: the full single-host k-means
            # engine (kmeans++ or random init, reseeding, minimum sizes).
            centers = None
            if ranks.lead:   # rank 0 trains, then broadcasts
                res = kmeans_ops.kmeans(
                    torch.Generator().manual_seed(seed), _put(sample),
                    part.num_leaves, iterations=part.training_iterations,
                    init="random" if part.random_init else "kmeans++",
                    spherical=part.spherical,
                    min_cluster_size=part.min_partition_size,
                    block_rows=build_block)
                centers = res.centers.cpu().numpy()
            centers = ranks.bcast(centers)
        else:
            # Huge samples: data-parallel Lloyd iterations over every rank.
            lp = _round_up(sample_n, ranks.n) // ranks.n
            local = np.zeros((lp, d), np.float32)
            mine = sample[ranks.pos * lp:(ranks.pos + 1) * lp]
            local[:len(mine)] = mine
            x_local = transfer.to_device(local, device=ranks.device)
            c = torch.as_tensor(sample[rng.choice(sample_n, part.num_leaves,
                                                  replace=False)])
            c = c.to(ranks.device)
            for _ in range(part.training_iterations):
                # Every rank is one position of the data axis here.
                c = sharded_kmeans_step(x_local, c, None,
                                        valid_rows=sample_n)
            centers = ranks.bcast(c.cpu().numpy())
        _log.info("sharded build: centers trained (%d leaves) over %d rows",
                  part.num_leaves, n)

        # -- 1b. split oversized partitions on the sample (scaled cap): the
        # sample's leaf sizes estimate the database's.
        cap = max(2.0 * n / max(part.num_leaves, 1), 1024)
        cap_sample = max(int(cap * sample_n / max(n, 1)), 8)
        if ranks.lead:
            xs = _put(sample)
            tokens_s, _ = kmeans_ops.assign(xs, _put(centers),
                                            block_rows=build_block)
            _, centers = kt.split_oversized(
                xs, tokens_s.cpu().numpy().astype(np.int64), centers,
                cap_sample)
        centers = ranks.bcast(centers)
        if centers.shape[0] != part.num_leaves:
            part = dataclasses.replace(part, num_leaves=centers.shape[0])
            scann_config = dataclasses.replace(scann_config, partitioning=part)
            _log.info("sharded build: split to %d leaves", part.num_leaves)

        # -- 1c. streaming AVQ centroid refit: the per-leaf sufficient
        # statistics (eta-weighted Gram matrix, weighted sum, total
        # weight) are additive over rows, so one tokenize-only pass
        # accumulates them.  Assignment keeps the pre-refit centers;
        # residuals, rescore rows and query tokenization use the refit.
        centers_assign = centers
        if part.avq is not None:
            if not residual:
                raise ValueError("avq requires residual quantization")
            centers = _avq_refit(chunks_fn, _norm, centers_assign,
                                 float(part.avq), ranks, comp,
                                 compute_device is not None, build_block)
            _log.info("sharded build: AVQ centroid refit applied (eta=%g)",
                      float(part.avq))

        # -- 2. AH codebook on sampled residuals.
        codebook = block_dims = None
        if not sq_mode:
            if ranks.lead:
                xs = _put(sample)
                a, _ = kmeans_ops.assign(xs, _put(centers_assign),
                                         block_rows=build_block)
                resid = (xs - _put(centers)[a.long()]) if residual else xs
                model = ah_ops.train_ah_model(
                    torch.Generator().manual_seed(seed + 1), resid,
                    ah.dimensions_per_block, ah.clusters_per_block,
                    ah.training_iterations, dims=d,
                    variable_dims_per_block=ah.variable_dims_per_block)
                codebook = model.codebook.cpu().numpy()
                if model.block_dims is not None:
                    block_dims = model.block_dims.cpu().numpy()
            codebook, block_dims = ranks.bcast((codebook, block_dims))
            _log.info("sharded build: AH codebook trained")

        if spill is not None:
            if ranks.lead:
                spill.save_phase1(
                    centers=centers, centers_assign=centers_assign,
                    codebook=codebook, block_dims=block_dims,
                    dims=np.int64(d), n=np.int64(n),
                    num_leaves=np.int64(part.num_leaves))
            dist.barrier()
    else:
        # Resume: phases 1-2 restore from the spill checkpoint; only the
        # encode pass runs again (and itself resumes mid-pass).
        d = int(ph["dims"])
        if int(ph["num_leaves"]) != part.num_leaves:
            part = dataclasses.replace(part, num_leaves=int(ph["num_leaves"]))
            scann_config = dataclasses.replace(scann_config, partitioning=part)
        centers = ph["centers"]
        centers_assign = ph["centers_assign"]
        codebook = None if sq_mode else ph["codebook"]
        block_dims = ph.get("block_dims")
        _log.info("sharded build: resumed trained state from spill "
                  "(%d leaves)", part.num_leaves)

    # -- 3. second streaming pass: tokenize (+SOAR) + encode + compress.
    num_blocks_enc = 0 if sq_mode else int(codebook.shape[0])
    encoder = None
    if compute_device is None or ranks.lead:   # with it, rank 0 encodes
        model = None if sq_mode else ah_ops.AHModel(
            codebook=_put(codebook), dims=d,
            block_dims=(None if block_dims is None
                        else torch.as_tensor(block_dims).to(comp)))
        encoder = _Encoder(_put(centers_assign), _put(centers), model, ah,
                           residual, soar, sq_mode, build_block)
    leaves_per_shard = -(-part.num_leaves // n_shards)
    if spill is not None:
        sink = spill.encode_sink(dims=d, num_blocks=num_blocks_enc,
                                 local_shard=ranks.shard)
        dist.barrier()   # every rank read the progress before rank 0 moves
    else:
        sink = layout_ops._MemEncodeSink(n_shards, local_shard=ranks.shard)

    def _append(tokens, codes, rows, sq, scale, dpids):
        owner = tokens // leaves_per_shard
        for sh in range(n_shards):
            sel = np.nonzero(owner == sh)[0]
            if not len(sel):
                continue
            sink.put(sh, codes=codes[sel], leaf=tokens[sel],
                     dpid=dpids[sel], rows=rows[sel], sq=sq[sel],
                     scale=scale[sel])

    row_base = sink.rows_done
    skip_chunks = sink.chunks_done
    if skip_chunks:
        _log.info("sharded build: resuming encode at chunk %d (%d rows "
                  "already spilled)", skip_chunks, row_base)
    ci = -1
    for rows in chunks_fn():
        ci += 1
        if ci < skip_chunks:
            continue
        rows = _norm(np.asarray(rows, np.float32))
        m_rows = rows.shape[0]
        if compute_device is not None:
            spec = _field_spec(m_rows, d, num_blocks_enc, soar is not None)
            out = encoder(_put(rows)) if ranks.lead else None
            out = ranks.bcast_rows(out, spec)
        else:
            lp = _round_up(m_rows, ranks.n) // ranks.n
            local = np.zeros((lp, d), np.float32)
            mine = rows[ranks.pos * lp:(ranks.pos + 1) * lp]
            local[:len(mine)] = mine
            out = ranks.gather_rows(encoder(_put(local)))
        out = [o[:m_rows].numpy() for o in out]
        dpids = np.arange(row_base, row_base + m_rows, dtype=np.int32)
        _append(*out[:5], dpids)
        if soar is not None:
            _append(*out[5:], dpids)
        row_base += m_rows
        sink.commit(ci + 1, row_base)
    _log.info("sharded build: %d rows tokenized + encoded", row_base)

    # -- 4. per-shard leaf-sorted layout.
    if spill is not None:
        if ranks.lead:
            sink.write_layout(n_shards)
        dist.barrier()
    host_parts = sink.layout(part.num_leaves, n_shards, dims=d,
                             num_blocks=num_blocks_enc)
    if block_dims is not None:
        host_parts["block_dims"] = np.asarray(block_dims)
    _log.info("sharded build: slots laid out over %d shards", n_shards)
    return mesh_ops.ShardedTreeAHSearcher(
        scann_config, mesh, codebook, np.asarray(centers, np.float32),
        host_parts, shard_axis, data_axis)


def _avq_refit(chunks_fn, norm, centers_assign, eta, ranks, comp,
               lead_only, build_block):
    """Streaming AVQ refit (the reference's AvqAccumulator): each rank
    accumulates its rows' per-leaf statistics, all-reduced, then rank 0
    solves each leaf's system and broadcasts the centers."""
    num_l, d = centers_assign.shape
    if num_l * d * d * 4 > (1 << 31):
        raise ValueError(
            f"streaming AVQ statistics need num_leaves*d*d*4 = "
            f"{num_l * d * d * 4} bytes; reduce num_leaves or project first")
    # At eta == 1 zero-norm members count toward the mean (fillzero 1).
    fillzero = 1.0 if eta == 1.0 else 0.0
    dev = comp if lead_only else ranks.device
    ca = torch.as_tensor(centers_assign).to(dev)
    acc_a = torch.zeros((num_l, d, d), dtype=torch.float32, device=dev)
    acc_b = torch.zeros((num_l, d), dtype=torch.float32, device=dev)
    acc_tw = torch.zeros((num_l,), dtype=torch.float32, device=dev)
    blk = 2048
    for rows in chunks_fn():
        rows = norm(np.asarray(rows, np.float32))
        if lead_only and not ranks.lead:
            continue
        if not lead_only:
            lp = _round_up(len(rows), ranks.n) // ranks.n
            rows = rows[ranks.pos * lp:(ranks.pos + 1) * lp]
        if not len(rows):
            continue
        x = transfer.to_device(rows, device=dev)
        tokens, _ = kmeans_ops.assign(x, ca, block_rows=build_block)
        norms = torch.linalg.norm(x, dim=-1)
        nz = norms > 1e-20
        w = torch.where(nz, norms ** (eta - 1.0),
                        torch.full_like(norms, fillzero))
        sw = torch.where(nz, norms ** (0.5 * (eta - 3.0)),
                         torch.zeros_like(norms))
        xw = x * sw[:, None]
        t = tokens.long()
        for s in range(0, len(x), blk):
            xb = xw[s:s + blk]
            acc_a.index_add_(0, t[s:s + blk], xb[:, :, None] * xb[:, None, :])
        acc_b.index_add_(0, t, x * w[:, None])
        acc_tw.index_add_(0, t, w)
    if not lead_only:
        for acc in (acc_a, acc_b, acc_tw):
            dist.all_reduce(acc)
    new = None
    if ranks.lead:
        eye = torch.eye(d, device=dev)
        a_mat = acc_tw[:, None, None] * eye + (eta - 1.0) * acc_a
        solved = eta * torch.linalg.solve(
            torch.where((acc_tw > 0)[:, None, None], a_mat, eye),
            acc_b[:, :, None])[:, :, 0]
        new = torch.where((acc_tw > 0)[:, None], solved, ca).cpu().numpy()
    return ranks.bcast(new)


class _Encoder:
    """Tokenize, SOAR secondary, encode and int8-compress one block of
    rows on the compute device; returns the per-row outputs (tokens,
    codes, rows_i8, rows_sq, rows_scale[, the same for the secondary])."""

    def __init__(self, ca, cr, model, ah, residual, soar, sq_mode,
                 build_block):
        self.ca, self.cr, self.model = ca, cr, model
        self.residual, self.soar, self.sq_mode = residual, soar, sq_mode
        self.threshold = (math.nan if sq_mode
                          else ah.anisotropic_quantization_threshold)
        self.build_block = build_block

    def __call__(self, x):
        b = self.build_block
        if b is None or x.shape[0] <= b:
            return self._block(x)
        parts = [self._block(x[s:s + b]) for s in range(0, x.shape[0], b)]
        return [torch.cat(p) for p in zip(*parts)]

    def _enc(self, vecs, x):
        if self.sq_mode:
            # The sq format has no codes: a zero-width placeholder.
            return torch.zeros((vecs.shape[0], 0), dtype=torch.uint8,
                               device=vecs.device)
        if not math.isnan(self.threshold):
            return ah_ops.encode_noise_shaped(vecs, x, self.model,
                                              self.threshold)
        return ah_ops.encode(vecs, self.model)

    @staticmethod
    def _row_compress(x, c_rows):
        """Residual per-row int8 rescore rows against the slot's center."""
        delta = x - c_rows
        m = delta.abs().amax(dim=-1)
        scale = m / 127.0
        inv = torch.where(m > 0, 127.0 / torch.clamp_min(m, 1e-30),
                          torch.zeros_like(m))
        rows_q = torch.clamp(torch.round(delta * inv[:, None]), -127,
                             127).to(torch.int8)
        deq = rows_q.float() * scale[:, None] + c_rows
        return rows_q, (deq * deq).sum(-1), scale

    def _block(self, x):
        # ca: assignment centers (pre-AVQ); cr: residual centers (after
        # the refit); the same tensor without AVQ.
        ca, cr = self.ca, self.cr
        tokens, _ = kmeans_ops.assign(x, ca)
        cprim0 = cr[tokens.long()]
        vecs = (x - cprim0) if self.residual else x
        out = [tokens.to(torch.int32), self._enc(vecs, x),
               *self._row_compress(x, cprim0)]
        if self.soar is None:
            return out
        # SOAR secondary: argmin ||x-c||^2 + lambda ((x-c).r_hat)^2 over
        # the centers other than the primary, in the pre-AVQ geometry.
        r = x - ca[tokens.long()]
        rnorm = torch.linalg.norm(r, dim=-1, keepdim=True)
        r_hat = torch.where(rnorm < 1e-7, torch.zeros_like(r),
                            r / torch.clamp_min(rnorm, 1e-20))
        term1 = dist_ops.squared_l2(x, ca)
        x_dot_r = (x * r_hat).sum(-1, keepdim=True)
        t2 = x_dot_r - r_hat @ ca.T
        sdist = term1 + float(self.soar.lambda_) * t2 * t2
        sdist[torch.arange(x.shape[0], device=x.device),
              tokens.long()] = float("inf")
        tokens2 = torch.argmin(sdist, dim=-1)
        c2_rows = cr[tokens2]
        # Secondary slots store residuals against their own center, so
        # every slot's rescore bias is q.c_{slot_leaf}.
        return out + [tokens2.to(torch.int32),
                      self._enc(x - c2_rows, x),
                      *self._row_compress(x, c2_rows)]
