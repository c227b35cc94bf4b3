"""Asymmetric hashing (product quantization): training, encoding, LUTs.

Port of scann_tpu/ops/ah.py.  A d-dim vector splits into ``num_blocks``
blocks of ``dims_per_block`` (a ragged tail is zero-padded; its center
coordinates train to zero), or, under VARIABLE_CHUNK, into blocks of
given widths: the model's ``block_dims`` table names the feature
dimensions of each block, padded to the widest block with a sentinel
column that always reads zero, so every chunked op is one gather and the
math after it does not depend on the widths.

  * ``train_ah_model``: one k-means++ per block on a (residual) sample.
  * ``encode``: per-block nearest center.
  * ``encode_noise_shaped``: anisotropic (score-aware) coordinate descent
    minimizing eta * ||r_par||^2 + ||r_perp||^2, 10 rounds over the blocks
    in decreasing initial-residual order.
  * ``build_luts`` / ``quantize_luts``: per-query similarity LUTs with the
    per-query symmetric int8 conversion of the dense scan (each block
    centered on its midpoint, the midpoints folded into ``base``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from scann_torch import config as cfg
from scann_torch.ops import kmeans as kmeans_ops


class AHModel(NamedTuple):
    codebook: torch.Tensor  # (num_blocks, clusters_per_block, max width)
    dims: int               # original (unpadded) dimensionality
    # VARIABLE_CHUNK: (num_blocks, max width) int32 feature dimensions of
    # each block, sentinel ``dims`` on padding; None for fixed chunks.
    block_dims: Optional[torch.Tensor] = None

    @property
    def num_blocks(self) -> int:
        return self.codebook.shape[0]

    @property
    def clusters_per_block(self) -> int:
        return self.codebook.shape[1]

    @property
    def dims_per_block(self) -> int:
        return self.codebook.shape[2]

    @property
    def padded_dims(self) -> int:
        return self.num_blocks * self.dims_per_block


def pad_to_blocks(x, dims_per_block: int):
    """Zero-pad the feature axis to a whole number of blocks."""
    pad = (-x.shape[-1]) % dims_per_block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x


def chunk(x, dims_per_block: int):
    """(..., d) -> (..., num_blocks, dims_per_block) with zero tail pad."""
    x = pad_to_blocks(x, dims_per_block)
    return x.reshape(x.shape[:-1] + (-1, dims_per_block))


def make_block_dims(dims: int, widths: Sequence[int]) -> np.ndarray:
    """VARIABLE_CHUNK table: block b owns ``widths[b]`` consecutive
    feature dimensions.  Returns (num_blocks, max width) int32 with
    sentinel ``dims`` padding."""
    widths = [int(w) for w in widths]
    if any(w <= 0 for w in widths):
        raise ValueError("variable chunk widths must be positive")
    if sum(widths) != dims:
        raise ValueError(
            f"variable chunk widths must sum to the dimensionality: "
            f"sum({widths}) = {sum(widths)} != {dims}")
    table = np.full((len(widths), max(widths)), dims, np.int32)
    off = 0
    for b, w in enumerate(widths):
        table[b, :w] = np.arange(off, off + w)
        off += w
    return table


def chunk_model(x, model: AHModel):
    """(..., d) -> (..., num_blocks, width) under the model's chunking (a
    reshape, or a block_dims gather past a zero sentinel column)."""
    if model.block_dims is None:
        return chunk(x, model.dims_per_block)
    xp = torch.nn.functional.pad(x, (0, 1))
    return xp[..., model.block_dims.to(x.device).long()]


def train_ah_model(generator, sample, dims_per_block: int,
                   clusters_per_block: int = 16, iterations: int = 10,
                   dims: Optional[int] = None,
                   variable_dims_per_block=None) -> AHModel:
    """Train per-block codebooks on a (residual) sample: one k-means++ run
    per block, all draws from ``generator`` in block order.
    ``variable_dims_per_block``: per-block widths (VARIABLE_CHUNK); the
    padding coordinates of the narrower blocks are zero in the codebook."""
    if dims is None:
        dims = sample.shape[-1]
    block_dims = None
    x = sample.float()
    if variable_dims_per_block is not None:
        block_dims = torch.as_tensor(
            make_block_dims(dims, variable_dims_per_block), device=x.device)
        xc = chunk_model(x, AHModel(codebook=x.new_zeros(
            (block_dims.shape[0], clusters_per_block, block_dims.shape[1])),
            dims=dims, block_dims=block_dims))
    else:
        xc = chunk(x, dims_per_block)
    xb = xc.transpose(0, 1)
    books = [kmeans_ops.kmeans(generator, xb[b].contiguous(),
                               clusters_per_block, iterations=iterations,
                               init="kmeans++").centers
             for b in range(xb.shape[0])]
    codebook = torch.stack(books)
    if block_dims is not None:
        # Padding slots carry exact zeros (reseeding can leave noise).
        codebook = torch.where((block_dims < dims)[:, None, :], codebook,
                               0.0)
    return AHModel(codebook=codebook, dims=dims, block_dims=block_dims)


def _block_stats(vectors, originals, model: AHModel):
    """Per (point, block, center): squared residual norm and the residual's
    component parallel to the original datapoint."""
    cb = model.codebook
    vc = chunk_model(vectors, model)                 # (n, B, d)
    oc = chunk_model(originals, model)
    v_dot_c = torch.einsum("nbd,bjd->nbj", vc, cb)
    o_dot_c = torch.einsum("nbd,bjd->nbj", oc, cb)
    v_sq = (vc * vc).sum(-1)
    c_sq = (cb * cb).sum(-1)
    rn = v_sq[:, :, None] - 2.0 * v_dot_c + c_sq[None, :, :]
    inv_norm = 1.0 / torch.clamp_min(torch.linalg.norm(originals, dim=-1),
                                     1e-20)
    v_dot_o = (vc * oc).sum(-1)
    pc = (v_dot_o[:, :, None] - o_dot_c) * inv_norm[:, None, None]
    return rn, pc


def encode(vectors, model: AHModel):
    """Per-block nearest-center encoding -> (n, num_blocks) uint8."""
    cb = model.codebook
    vc = chunk_model(vectors.float(), model)
    dots = torch.einsum("nbd,bjd->nbj", vc, cb)
    c_sq = (cb * cb).sum(-1)
    # argmin ||v - c||^2 == argmin (||c||^2 - 2 v.c)
    return torch.argmin(c_sq[None, :, :] - 2.0 * dots, dim=-1).to(
        torch.uint8)


_NOISE_SHAPING_ROUNDS = 10


def _parallel_cost_multiplier(threshold, squared_norms, dims):
    """eta(T) of the anisotropic loss."""
    sq = torch.clamp_min(squared_norms, 1e-20)
    parallel_cost = (threshold * threshold) / sq
    perp_cost = (1.0 - parallel_cost) / (dims - 1.0)
    return parallel_cost / torch.clamp_min(perp_cost, 1e-20)


def encode_noise_shaped(vectors, originals, model: AHModel,
                        threshold: float, eta: float = math.nan):
    """Anisotropic encoding by coordinate descent: start at each block's
    nearest center, visit blocks in decreasing initial-residual order, and
    switch a block's center only when that strictly lowers
    eta * d(par^2) + d(perp^2); candidates that raise the parallel norm
    are skipped.  The only sequential state is the per-point parallel
    residual component."""
    n = vectors.shape[0]
    vectors = vectors.float()
    originals = originals.float()
    rn, pc = _block_stats(vectors, originals, model)
    num_blocks = model.num_blocks
    sq_norms = (originals ** 2).sum(-1)
    if math.isnan(eta):
        eta_v = _parallel_cost_multiplier(threshold, sq_norms, model.dims)
    else:
        eta_v = torch.full((n,), eta, dtype=torch.float32,
                           device=vectors.device)

    codes0 = torch.argmin(rn, dim=-1)                            # (n, B)
    p = torch.gather(pc, 2, codes0[:, :, None])[:, :, 0].sum(-1)  # (n,)
    init_rn = torch.gather(rn, 2, codes0[:, :, None])[:, :, 0]
    order = torch.argsort(-init_rn, dim=-1, stable=True)
    # Each row's blocks in visit order, so a step reads one block slab.
    j_full = order[:, :, None].expand(-1, -1, rn.shape[2])
    rn_pm = torch.gather(rn, 1, j_full)
    pc_pm = torch.gather(pc, 1, j_full)
    codes = torch.gather(codes0, 1, order)
    inf = torch.tensor(float("inf"), device=vectors.device)
    for s in range(_NOISE_SHAPING_ROUNDS * num_blocks):
        j = s % num_blocks
        rn_b, pc_b = rn_pm[:, j], pc_pm[:, j]                     # (n, J)
        cur = codes[:, j:j + 1]
        cur_rn = torch.gather(rn_b, 1, cur)
        cur_pc = torch.gather(pc_b, 1, cur)
        new_p = p[:, None] - cur_pc + pc_b
        pnd = new_p * new_p - (p * p)[:, None]
        rnd = rn_b - cur_rn
        cost = eta_v[:, None] * pnd + (rnd - pnd)
        cost = torch.where(pnd > 0.0, inf, cost)
        cost.scatter_(1, cur, float("inf"))       # never the current center
        best_cost, best_j = torch.min(cost, dim=-1, keepdim=True)
        switch = best_cost < 0.0
        codes[:, j:j + 1] = torch.where(switch, best_j, cur)
        p = torch.where(switch[:, 0], torch.gather(new_p, 1, best_j)[:, 0],
                        p)
    out = torch.empty_like(codes)
    out.scatter_(1, order, codes)
    return out.to(torch.uint8)


def reconstruct(codes, model: AHModel):
    """Decode (n, B) codes back to approximate (n, dims) vectors."""
    cb = model.codebook
    blocks = torch.arange(cb.shape[0], device=cb.device)
    rows = cb[blocks[None, :], codes.long()]              # (n, B, dpb)
    flat = rows.reshape(codes.shape[0], -1)
    if model.block_dims is None:
        return flat[:, :model.dims]
    # VARIABLE_CHUNK: each block's values go back to its dimensions (the
    # padding lands on the dropped sentinel column).
    out = flat.new_zeros((codes.shape[0], model.dims + 1))
    out.index_add_(1, model.block_dims.reshape(-1).to(flat.device).long(),
                   flat)
    return out[:, :model.dims]


class LookupTables(NamedTuple):
    """Per-query lookup tables in the similarity convention."""
    int8: Optional[torch.Tensor]   # (q, B, J) int8
    raw: Optional[torch.Tensor]    # (q, B, J) f32 (float lookup)
    inv_multiplier: torch.Tensor   # (q,) f32: accum * inv_multiplier -> f32
    base: torch.Tensor             # (q,) f32 additive per-query constant


def build_luts(queries, model: AHModel, measure: str,
               lookup_dtype: str = cfg.INT8) -> LookupTables:
    """dot_product: lut = q_b . c; squared_l2: lut = 2 q_b . c - ||c||^2
    with the per-query -||q||^2 carried in ``base``."""
    qf = queries.float()
    qc = chunk_model(qf, model)
    cb = model.codebook
    dots = torch.einsum("qbd,bjd->qbj", qc, cb)
    if measure == cfg.DOT_PRODUCT:
        raw = dots
        base = torch.zeros((qf.shape[0],), dtype=torch.float32,
                           device=qf.device)
    elif measure == cfg.SQUARED_L2:
        c_sq = (cb * cb).sum(-1)
        raw = 2.0 * dots - c_sq[None, :, :]
        base = -(qf * qf).sum(-1)
    else:
        raise ValueError(f"unsupported measure: {measure}")
    return quantize_luts(raw, base, lookup_dtype)


def quantize_luts(raw, base, lookup_dtype: str) -> LookupTables:
    """Per-query fixed-point conversion of raw (q, B, J) tables.  Each
    block is first centered on its midpoint (exactly one entry per block
    joins a score, so the sum of midpoints folds into ``base``); the
    multiplier is 127 / the largest centered magnitude of the query."""
    if lookup_dtype == cfg.INT8:
        mid = 0.5 * (raw.amax(dim=2, keepdim=True)
                     + raw.amin(dim=2, keepdim=True))
        centered = raw - mid
        base = base + mid[:, :, 0].sum(dim=1)
        max_abs = torch.clamp_min(centered.abs().amax(dim=(1, 2)),
                                  math.sqrt(torch.finfo(torch.float32).eps))
        # A true division (scalar / tensor would be reciprocal * scalar).
        mult = torch.div(torch.tensor(127.0, device=raw.device), max_abs)
        q8 = torch.clamp(torch.round(centered * mult[:, None, None]),
                         -127, 127).to(torch.int8)
        return LookupTables(int8=q8, raw=None, inv_multiplier=1.0 / mult,
                            base=base)
    return LookupTables(int8=None, raw=raw,
                        inv_multiplier=torch.ones_like(base), base=base)
