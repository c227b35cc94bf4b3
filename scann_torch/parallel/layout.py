"""Slot layout of the sharded index, and the sinks of the build's encode
pass (port of the layout half of scann_tpu/parallel/mesh.py).

Shard ``s`` owns leaves ``[s * lps, (s + 1) * lps)``, ``lps =
ceil(num_leaves / n_shards)``.  Within a shard the slots are sorted by
leaf (stable, so equal leaves keep their append order) and every shard is
padded to one common multiple of ``chunk = min(65536, ...)`` slots, dead
slots carrying dpid -1.

Each rank keeps ``slot_leaf`` and ``slot_dpid`` of every shard (8 B a
slot: the global free-slot order of mutation needs them) and the heavy
tables (``codes``, ``rows_i8``, ``rows_sq``, ``rows_scale``) of its own
shard only, with a leading axis of 1 (``_layout_shards_from_parts`` with
``local_shard=None`` keeps every shard's: the JAX package's host layout).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

HEAVY_KEYS = ("codes", "rows_i8", "rows_sq", "rows_scale")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def layout_chunk(max_slots: int) -> tuple:
    """(chunk, padded slots a shard) for the fullest shard's slot count."""
    chunk = min(65536, _round_up(max(max_slots, 128), 128))
    return chunk, _round_up(max(max_slots, chunk), chunk)


class _MemEncodeSink:
    """In-memory encode accumulator: per-shard chunk lists, concatenated
    and leaf-sorted by ``_layout_shards_from_parts``.  The heavy columns
    of shards other than ``local_shard`` are dropped as they arrive."""

    chunks_done = 0
    rows_done = 0

    def __init__(self, n_shards: int, local_shard: int):
        self.local_shard = local_shard
        self.acc = [{"codes": [], "leaf": [], "dpid": [], "rows": [],
                     "sq": [], "scale": []} for _ in range(n_shards)]

    def put(self, sh, **arrs):
        a = self.acc[sh]
        for k, v in arrs.items():
            if sh == self.local_shard or k in ("leaf", "dpid"):
                a[k].append(v)

    def commit(self, chunks_done: int, rows_done: int):
        pass

    def layout(self, num_leaves, n_shards, dims, num_blocks):
        return _layout_shards_from_parts(self.acc, num_leaves, n_shards,
                                         dims=dims, num_blocks=num_blocks,
                                         local_shard=self.local_shard)


# (key, dtype) of the per-slot encode outputs; "codes" has width
# num_blocks (0 in the sq format), "rows" has width dims, the rest are
# scalar per slot.
_SPILL_KEYS = (("codes", np.uint8), ("leaf", np.int32), ("dpid", np.int32),
               ("rows", np.int8), ("sq", np.float32),
               ("scale", np.float32))
_OUT_NAME = {"codes": "codes", "leaf": "slot_leaf", "dpid": "slot_dpid",
             "rows": "rows_i8", "sq": "rows_sq", "scale": "rows_scale"}


class _SpillState:
    """Disk-backed streaming-build state (``spill_dir``).

    Three artifacts keep the build's host RAM at O(one chunk) and make it
    resumable after a crash:
      * ``phase1.npz``: trained centers (and assignment centers, AH
        codebook, block_dims), so phases 1-2 are skipped on resume;
      * ``enc_s{shard}_{key}.bin``: append-only encode spill files, with
        ``encode_progress.json`` replaced atomically after every chunk (a
        crashed encode pass resumes at the last committed chunk; the files
        are first truncated to the committed byte counts);
      * ``layout_{key}.npy``: the leaf-sorted slot tables, gathered from
        the spill files in bounded blocks and opened as copy-on-write
        memmaps.

    The emitted index is bit-identical to the in-memory build's (same
    append order, same stable leaf sort).  Rank 0 of the mesh writes every
    file; the other ranks read them, so ``spill_dir`` must be one
    directory that every rank sees."""

    def __init__(self, spill_dir: str, n_shards: int, writer: bool = True):
        self.dir = spill_dir
        self.n_shards = n_shards
        self.writer = writer
        if writer:
            os.makedirs(spill_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def load_phase1(self):
        p = self.path("phase1.npz")
        if not os.path.exists(p):
            return None
        with np.load(p) as raw:
            return {k: raw[k] for k in raw.files}

    def save_phase1(self, **arrs):
        # np.savez appends ".npz" when absent: keep the tmp suffix valid.
        tmp = self.path("phase1.tmp.npz")
        np.savez(tmp, **{k: v for k, v in arrs.items() if v is not None})
        os.replace(tmp, self.path("phase1.npz"))

    def encode_sink(self, dims: int, num_blocks: int, local_shard: int):
        return _SpillEncodeSink(self, dims, num_blocks, local_shard)


class _SpillEncodeSink:
    """Append-only disk spill of the encode pass (see _SpillState)."""

    def __init__(self, spill: _SpillState, dims: int, num_blocks: int,
                 local_shard: int):
        self.spill = spill
        self.local_shard = local_shard
        self.widths = {"codes": num_blocks, "leaf": 1, "dpid": 1,
                       "rows": dims, "sq": 1, "scale": 1}
        self.prog_path = spill.path("encode_progress.json")
        self.chunks_done = 0
        self.rows_done = 0
        self.counts = [0] * spill.n_shards
        if os.path.exists(self.prog_path):
            with open(self.prog_path) as f:
                prog = json.load(f)
            self.chunks_done = int(prog["chunks_done"])
            self.rows_done = int(prog["rows_done"])
            self.counts = [int(c) for c in prog["counts"]]
        self.files = {}
        if not spill.writer:
            return
        for sh in range(spill.n_shards):
            for key, dt in _SPILL_KEYS:
                if self.widths[key] == 0:
                    continue
                p = spill.path(f"enc_s{sh}_{key}.bin")
                want = (self.counts[sh] * self.widths[key]
                        * np.dtype(dt).itemsize)
                if os.path.exists(p):
                    if os.path.getsize(p) < want:
                        raise ValueError(
                            f"spill file {p} is shorter than its progress "
                            f"record ({os.path.getsize(p)} < {want} "
                            f"bytes); the spill dir is corrupt: delete it "
                            f"and rebuild")
                    # A crash between the file writes and the progress
                    # commit leaves a partial chunk tail: drop it.
                    os.truncate(p, want)
                elif want:
                    raise ValueError(
                        f"spill file {p} is missing but progress records "
                        f"{want} bytes; delete the spill dir and rebuild")
                else:
                    open(p, "wb").close()
                self.files[(sh, key)] = open(p, "ab")

    def put(self, sh, **arrs):
        self.counts[sh] += len(arrs["leaf"])
        if not self.spill.writer:
            return
        for key, dt in _SPILL_KEYS:
            if self.widths[key] == 0:
                continue
            self.files[(sh, key)].write(
                np.ascontiguousarray(arrs[key], dtype=dt).tobytes())

    def commit(self, chunks_done: int, rows_done: int):
        if self.spill.writer:
            for f in self.files.values():
                f.flush()
            tmp = self.prog_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"chunks_done": chunks_done,
                           "rows_done": rows_done,
                           "counts": self.counts}, f)
            os.replace(tmp, self.prog_path)
        self.chunks_done = chunks_done
        self.rows_done = rows_done

    def write_layout(self, n_shards):
        """The writer's half of ``layout``: the leaf-sorted tables of every
        shard into ``layout_{key}.npy``."""
        for f in self.files.values():
            f.close()
        self.files = {}
        counts = self.counts
        _, slots_padded = layout_chunk(max(max(counts), 1))
        for key, dt in _SPILL_KEYS:
            w = self.widths[key]
            if w == 0:
                continue  # the sq format's codes: no file
            shape = ((n_shards, slots_padded) if key not in
                     ("codes", "rows") else (n_shards, slots_padded, w))
            mm = np.lib.format.open_memmap(
                self.spill.path(f"layout_{key}.npy"), mode="w+",
                dtype=dt, shape=shape)
            if key == "dpid":
                mm[:] = -1  # open_memmap zero-fills; dead slots are -1
            for sh in range(n_shards):
                m = counts[sh]
                if m == 0:
                    continue
                leaf = np.fromfile(self.spill.path(f"enc_s{sh}_leaf.bin"),
                                   dtype=np.int32, count=m)
                order = np.argsort(leaf, kind="stable")
                src = np.memmap(
                    self.spill.path(f"enc_s{sh}_{key}.bin"), dtype=dt,
                    mode="r",
                    shape=(m,) if key not in ("codes", "rows") else (m, w))
                # Bounded gather blocks: about 128 MB of sorted rows at a
                # time through the page cache.
                blk = max((1 << 27) // max(w * np.dtype(dt).itemsize, 1), 1)
                for s in range(0, m, blk):
                    sel = order[s:s + blk]
                    mm[sh, s:s + len(sel)] = src[sel]
                del src
            mm.flush()
            del mm

    def layout(self, num_leaves, n_shards, dims, num_blocks):
        """Open the written tables: every shard's leaf and dpid, the heavy
        tables of ``local_shard``, as copy-on-write memmaps (writes stay in
        this process)."""
        chunk, slots_padded = layout_chunk(max(max(self.counts), 1))
        host_parts = {}
        for key, dt in _SPILL_KEYS:
            name = _OUT_NAME[key]
            if self.widths[key] == 0:
                host_parts[name] = np.zeros((1, slots_padded, 0), dt)
                continue
            mm = np.load(self.spill.path(f"layout_{key}.npy"),
                         mmap_mode="c")
            if name in HEAVY_KEYS:
                mm = mm[self.local_shard:self.local_shard + 1]
            host_parts[name] = mm
        host_parts.update(num_leaves=num_leaves, dims=dims, chunk=chunk)
        return host_parts


def _empty_part(dims: int, num_blocks: int) -> dict:
    return {"codes": np.zeros((0, num_blocks), np.uint8),
            "leaf": np.zeros((0,), np.int32),
            "dpid": np.zeros((0,), np.int32),
            "rows": np.zeros((0, dims), np.int8),
            "sq": np.zeros((0,), np.float32),
            "scale": np.zeros((0,), np.float32)}


def _layout_shards_from_parts(acc, num_leaves: int, n_shards: int,
                              dims: int, num_blocks: int,
                              local_shard: Optional[int] = None) -> dict:
    """Concatenate per-shard compressed buffers, leaf-sort within each
    shard, pad to a common chunk-aligned size.  Heavy tables are laid out
    for ``local_shard`` only (every shard when None)."""
    heavy = set(range(n_shards) if local_shard is None else (local_shard,))
    parts = []
    for i in range(len(acc)):
        a = acc[i]
        part = _empty_part(dims, num_blocks)
        for k in list(a):
            if a[k]:
                part[k] = np.concatenate(a[k], axis=0)
            a[k] = None  # free the chunk buffers as we go
        parts.append(part)
        acc[i] = None
    max_slots = max((len(p["leaf"]) for p in parts), default=1)
    chunk, slots_padded = layout_chunk(max_slots)
    n_heavy = len(heavy)
    sh_leaf = np.zeros((n_shards, slots_padded), np.int32)
    sh_dpid = np.full((n_shards, slots_padded), -1, np.int32)
    sh_codes = np.zeros((n_heavy, slots_padded, num_blocks), np.uint8)
    sh_rows = np.zeros((n_heavy, slots_padded, dims), np.int8)
    sh_sq = np.zeros((n_heavy, slots_padded), np.float32)
    sh_scale = np.zeros((n_heavy, slots_padded), np.float32)
    for sh, p in enumerate(parts):
        order = np.argsort(p["leaf"], kind="stable")
        m = len(order)
        sh_leaf[sh, :m] = p["leaf"][order]
        sh_dpid[sh, :m] = p["dpid"][order]
        if sh in heavy:
            h = sh if local_shard is None else 0
            for key, dst in (("codes", sh_codes), ("rows", sh_rows),
                             ("sq", sh_sq), ("scale", sh_scale)):
                dst[h, :m] = p[key][order]
        parts[sh] = None
    return {"codes": sh_codes, "slot_leaf": sh_leaf, "slot_dpid": sh_dpid,
            "rows_i8": sh_rows, "rows_sq": sh_sq, "rows_scale": sh_scale,
            "num_leaves": num_leaves, "dims": dims, "chunk": chunk}


def compress_rows(delta, c_rows):
    """Residual per-row int8 rescore rows (numpy): ``delta = x - c`` with
    ``c_rows`` the slot's center (zeros for absolute rows).  Returns
    (int8 rows, squared norm of the dequantized row, scale)."""
    m = np.abs(delta).max(axis=1)
    scale = (m / 127.0).astype(np.float32)
    inv = np.where(m > 0, 127.0 / np.maximum(m, 1e-30), 0.0)
    q = np.clip(np.round(delta * inv[:, None]), -127, 127).astype(np.int8)
    deq = q.astype(np.float32) * scale[:, None] + c_rows
    return q, (deq * deq).sum(axis=1), scale


def _layout_shards(codes: np.ndarray, slot_leaf: np.ndarray,
                   slot_dpid: np.ndarray, database: np.ndarray,
                   num_leaves: int, n_shards: int, dims: int,
                   centers: np.ndarray, absolute_rows: bool,
                   local_shard: int) -> dict:
    """Group the live slots of a resident index into leaf-owner shards
    (the from_searcher path): residual-compress the rescore rows of the
    heavy shards, then defer to the compressed-parts layout.

    ``absolute_rows``: int8 of the raw row instead of the residual against
    its leaf center, for projected indexes, whose centers live in the
    projected space while the rescore stays in the original space."""
    valid = np.nonzero(slot_dpid >= 0)[0]
    centers = np.asarray(centers, np.float32)
    leaves_per_shard = -(-num_leaves // n_shards)
    acc = [{"codes": [], "leaf": [], "dpid": [], "rows": [], "sq": [],
            "scale": []}
           for _ in range(n_shards)]
    step = 1 << 18
    for s in range(0, len(valid), step):
        sel = valid[s:s + step]
        owner = slot_leaf[sel] // leaves_per_shard
        for sh in range(n_shards):
            pick = np.nonzero(owner == sh)[0]
            if not len(pick):
                continue
            a = acc[sh]
            a["leaf"].append(slot_leaf[sel[pick]].astype(np.int32))
            a["dpid"].append(slot_dpid[sel[pick]].astype(np.int32))
            if sh != local_shard:
                continue
            rows = database[slot_dpid[sel[pick]]]
            c_rows = (np.zeros_like(rows) if absolute_rows
                      else centers[slot_leaf[sel[pick]]])
            q, sq, scale = compress_rows(rows - c_rows, c_rows)
            a["codes"].append(codes[sel[pick]])
            a["rows"].append(q)
            a["sq"].append(sq)
            a["scale"].append(scale)
    parts = _layout_shards_from_parts(acc, num_leaves, n_shards, dims=dims,
                                      num_blocks=codes.shape[1],
                                      local_shard=local_shard)
    parts["absolute_rows"] = absolute_rows
    return parts
