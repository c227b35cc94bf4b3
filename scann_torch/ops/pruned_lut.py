"""Pruned scoring straight from the AH codes (tree-AH scorers K3 and K4).

Port of scann_tpu/ops/pruned_lut.py.  Only the codes live in device
memory, tile-major per leaf (512-slot tiles); two scorers read them:

* ``score_work_lut`` (K3, int8 lookup with 16 centers per block): per
  query group the LUT ``centered codebook . q`` (``2 q.c - ||c||^2`` under
  squared L2) is quantized per query to int8 (multiplier 127 / max|entry|),
  and each slot's score is the int32 sum of its blocks' LUT entries,
  dequantized, plus the slot's bias.  Codes are pair-packed 4 bits each.
* ``score_work_codes`` (K4, float lookup, and 256 centers per block): each
  tile is decoded through the bf16 codebook (minus the mean), rounded to
  bf16 and multiplied with the bf16 query group in f32; under squared L2
  ``2 dot - ||recon||^2``.  Codes are one byte per block, 255 = padding.

Both keep the top ``kpg`` of every 32-slot group with packed identities
and write int32 (G_pad, 128, mnt * kpg * 16), the contract of
ops/pruned_scan.py.  Under residual quantization the q.c_leaf term joins
at merge time (merge_candidates pair_bias).

On CUDA tensors the entry points launch the hand-written kernels
csrc/pruned_lut.cu and csrc/pruned_codes.cu (ports of the Pallas kernels
``score_work_pallas_lut`` and ``score_work_pallas_codes``; K4 on the
tile product of csrc/tile_mma.cuh, as K1 and K2) or raise; on
CPU tensors they run ``score_work_torch_lut`` / ``score_work_torch_codes``,
the plain torch versions with the same output contract.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from scann_torch.ops import pruned_scan as ps
from scann_torch.ops.pruned_scan import _SMEM_LIMIT, _check

# Kernel launches made by score_work_lut / score_work_codes (CPU calls
# never count).
launches_lut = 0
launches_codes = 0

_BLK = 8          # code blocks pad to a multiple of this
_PAD_CODE = 255   # matches no center of a 16-center block
_WORK_CHUNK = 32
_LUT_CENTERS = 16


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_codes_tiles(codes_flat: np.ndarray, num_tiles: int) -> np.ndarray:
    """(num_tiles*TILE, B) uint8 codes -> (num_tiles, TILE, B_pad) with
    255-padded tail blocks (the K4 layout)."""
    b = codes_flat.shape[1]
    b_pad = _round_up(b, _BLK)
    out = np.full((codes_flat.shape[0], b_pad), _PAD_CODE, np.uint8)
    out[:, :b] = codes_flat
    return out.reshape(num_tiles, ps.TILE, b_pad)


def pack_codes_nibble(codes_flat: np.ndarray, num_tiles: int) -> np.ndarray:
    """(num_tiles*TILE, B) uint8 center ids in [0, 16) -> pair-packed
    (num_tiles, TILE, B_pad/2) uint8 (the K3 layout): byte k holds block 2k
    in its low nibble and 2k+1 in its high nibble; pad blocks and pad slots
    are code 0, whose LUT entries are exactly zero."""
    b = codes_flat.shape[1]
    b_pad = _round_up(b, _BLK)
    full = np.zeros((codes_flat.shape[0], b_pad), np.uint8)
    full[:, :b] = codes_flat
    packed = (full[:, 0::2] | (full[:, 1::2] << 4)).astype(np.uint8)
    return packed.reshape(num_tiles, ps.TILE, b_pad // 2)


def expand_codebook(codebook, d_pad: int, b_pad: int) -> np.ndarray:
    """(B, C, dpb) codebook -> (b_pad*C, d_pad) f32 decode matrix: row
    j*C + c holds center c of block j at its dimension offset."""
    cb = np.asarray(codebook, np.float32)
    b, cpb, dpb = cb.shape
    out = np.zeros((b_pad * cpb, d_pad), np.float32)
    for blk in range(b):
        out[blk * cpb:(blk + 1) * cpb, blk * dpb:(blk + 1) * dpb] = cb[blk]
    return out


def _padded_blocks(codebook, b_pad: int):
    """(B, C, dpb) codebook -> (b_pad, C, dpb) f32 with zero tail blocks."""
    cb = codebook.to(torch.float32)
    return torch.nn.functional.pad(cb, (0, 0, 0, 0, 0, b_pad - cb.shape[0]))


def lut_tables(codebook, mean, b_pad: int, *, measure_l2: bool):
    """The K3 tables of one index, computed once when its layout is built:
    the compact centered codebook (b_pad*16, dpb) f32 holding bf16 values
    (row j*16 + c is center c of block j minus the mean on block j's
    dimensions) and the squared norms (b_pad*16,) of the unrounded centered
    rows (zero under dot product, where the LUT has no norm term).
    Pad-block rows stay exactly zero: the mean is zero on their
    dimensions.  The same values as the JAX package's _centered_cb on the
    expanded codebook, without its zero columns."""
    cb = _padded_blocks(codebook, b_pad)
    cb_c = cb - mean.reshape(b_pad, 1, cb.shape[2])
    csq = (cb_c * cb_c).sum(dim=2).reshape(-1)
    if not measure_l2:
        csq = torch.zeros_like(csq)
    cb_k = cb_c.to(torch.bfloat16).float().reshape(-1, cb.shape[2])
    return cb_k.contiguous(), csq.contiguous()


def codes_table(codebook, b_pad: int):
    """The K4 table of one index: the compact bf16-rounded codebook
    (b_pad*cpb, dpb) f32, row j*cpb + c = center c of block j."""
    cb = _padded_blocks(codebook, b_pad)
    return cb.to(torch.bfloat16).float().reshape(-1, cb.shape[2]).contiguous()


def _finish(out, w_pad: int, mnt: int, kpg: int):
    g = w_pad // mnt
    return (out.reshape(g, mnt, ps.QG, kpg * ps.GP).transpose(1, 2)
            .reshape(g, ps.QG, mnt * kpg * ps.GP))


def score_work_torch_lut(plan, qg_rows, codes3p, cb_k, csq, bias, *,
                         measure_l2: bool, kpg: int = ps.KPG,
                         work_chunk: int = _WORK_CHUNK):
    """Plain torch version of the K3 scorer (twin of the JAX package's
    score_work_xla_lut, which takes the query groups transposed and the
    expanded codebook).  qg_rows: (G_pad, QG, d_pad) bf16; codes3p:
    (num_tiles, TILE, b_pad/2) uint8; cb_k, csq: lut_tables(); bias:
    (num_tiles, TILE[, 1]) f32.  The LUT sums bf16 x bf16 products, exact
    in f32; with two dimensions per block a LUT entry is one rounded sum
    and order-free, so the int8 LUT and the packed output are bit-equal to
    the JAX package's.  Wider blocks may differ in the last bit of an
    entry.  The integer sums are exact in f32 (below 2^24).  Computes
    inactive items too (never read)."""
    w_pad = plan.work_tile.shape[0]
    mnt = w_pad // plan.qg_query.shape[0]
    scale = 2.0 if measure_l2 else 1.0
    b_pad = codes3p.shape[-1] * 2
    dpb = cb_k.shape[1]
    dev = codes3p.device
    bias2 = bias.reshape(bias.shape[0], -1)
    cb3 = cb_k.reshape(b_pad, _LUT_CENTERS, dpb)
    centers = torch.arange(_LUT_CENTERS, dtype=torch.int32, device=dev)
    c127 = torch.tensor(127.0, device=dev)
    out = torch.empty((w_pad, ps.QG, kpg * ps.GP), dtype=torch.int32,
                      device=dev)
    wi = torch.arange(w_pad, dtype=torch.int32, device=dev) % mnt
    for s0 in range(0, w_pad, work_chunk):
        wt = plan.work_tile[s0:s0 + work_chunk].long()
        wq = plan.work_qg[s0:s0 + work_chunk].long()
        c = wt.shape[0]
        q = qg_rows[wq].float().reshape(c, ps.QG, b_pad, dpb)
        lutf = torch.einsum("bkd,nqbd->nbkq", cb3, q).reshape(
            c, b_pad * _LUT_CENTERS, ps.QG)              # (C, W, QG)
        lutf = scale * lutf - csq[None, :, None]
        m = torch.clamp_min(lutf.abs().amax(dim=1, keepdim=True), 1e-20)
        # A true division: torch evaluates scalar / tensor as a reciprocal
        # times the scalar, which rounds differently.
        lut = torch.clamp(torch.round(lutf * torch.div(c127, m)), -127, 127)
        packed_c = codes3p[wt].to(torch.int32)           # (C, TILE, b2)
        codes = torch.stack([packed_c & 15, packed_c >> 4], dim=-1).reshape(
            c, ps.TILE, b_pad)
        oh = (codes[..., None] == centers).to(torch.float32).reshape(
            c, ps.TILE, b_pad * _LUT_CENTERS)
        acc = torch.bmm(oh, lut)                         # exact integers
        s = acc * (m * (1.0 / 127.0)) + bias2[wt][:, :, None]
        g = s.reshape(c, ps.GP, ps.SUBP, ps.QG)
        packed = ps._group_top_packed(g, wi[s0:s0 + c, None, None, None],
                                      axis=2, cat_axis=1, kpg=kpg)
        out[s0:s0 + c] = packed.transpose(1, 2)
    return _finish(out, w_pad, mnt, kpg)


def score_work_torch_codes(plan, qg_rows, codes3, cb_k, mean, bias, *,
                           measure_l2: bool, kpg: int = ps.KPG,
                           work_chunk: int = _WORK_CHUNK):
    """Plain torch version of the K4 scorer (twin of the JAX package's
    score_work_xla_codes).  codes3: (num_tiles, TILE, b_pad) uint8; cb_k:
    codes_table() (16 or 256 centers per block); mean: (d_pad,) f32; the
    rest as for K3.  A row is its blocks' bf16 codebook rows side by side
    minus the mean; the f32 sum over d_pad of the scores is
    order-dependent, so values agree with the kernel and with the JAX
    package to ~2^-14 relative, not bit for bit."""
    w_pad = plan.work_tile.shape[0]
    mnt = w_pad // plan.qg_query.shape[0]
    b_pad = codes3.shape[-1]
    w, dpb = cb_k.shape
    cpb = w // b_pad
    dev = codes3.device
    bias2 = bias.reshape(bias.shape[0], -1)
    # One extra zero row: what a code >= cpb (padding) decodes to.
    table = torch.cat([cb_k, torch.zeros((1, dpb), device=dev)])
    block0 = torch.arange(b_pad, dtype=torch.int64, device=dev) * cpb
    out = torch.empty((w_pad, ps.QG, kpg * ps.GP), dtype=torch.int32,
                      device=dev)
    wi = torch.arange(w_pad, dtype=torch.int32, device=dev) % mnt
    for s0 in range(0, w_pad, work_chunk):
        wt = plan.work_tile[s0:s0 + work_chunk].long()
        wq = plan.work_qg[s0:s0 + work_chunk].long()
        c = wt.shape[0]
        codes = codes3[wt].long()                        # (C, TILE, b_pad)
        rows = torch.where(codes < cpb, block0 + codes, w)
        recon = table[rows].reshape(c, ps.TILE, b_pad * dpb) - mean
        q = qg_rows[wq].float()
        s = torch.bmm(recon.to(torch.bfloat16).float(), q.transpose(1, 2))
        if measure_l2:
            s = 2.0 * s - (recon * recon).sum(-1, keepdim=True)
        s = s + bias2[wt][:, :, None]
        g = s.reshape(c, ps.GP, ps.SUBP, ps.QG)
        packed = ps._group_top_packed(g, wi[s0:s0 + c, None, None, None],
                                      axis=2, cat_axis=1, kpg=kpg)
        out[s0:s0 + c] = packed.transpose(1, 2)
    return _finish(out, w_pad, mnt, kpg)


def _common_checks(plan, qg_rows, codes, bias, kpg, d_pad, dev):
    num_tiles, tile = codes.shape[:2]
    g_pad = plan.qg_query.shape[0]
    w_pad = plan.work_tile.shape[0]
    if tile != ps.TILE or w_pad % g_pad:
        raise ValueError(f"unsupported shapes: tile {tile} (needs "
                         f"{ps.TILE}), w_pad {w_pad}, g_pad {g_pad}")
    if not 1 <= kpg <= ps.SUBP:
        raise ValueError(f"kpg must be in [1, {ps.SUBP}], got {kpg}")
    _check("work_tile", plan.work_tile, torch.int32, (w_pad,), dev)
    _check("work_active", plan.work_active, torch.int32, (w_pad,), dev)
    _check("qg_rows", qg_rows, torch.bfloat16, (g_pad, ps.QG, d_pad), dev)
    _check("bias", bias, torch.float32,
           (num_tiles, tile) + (1,) * (bias.dim() - 2), dev)
    return g_pad, w_pad, w_pad // g_pad


_LUT_QUERIES = ps.QG // 2   # queries per K3 block (two blocks a group)
_LUT_PAD = 16               # bytes added to each query's LUT row
_LUT_PARTS = 4              # LUT-build threads per query


def lut_smem_bytes(b_pad: int, kpg: int = ps.KPG) -> int:
    """Shared memory of one K3 block: the int8 LUT of its 64 queries (a row
    of b_pad*16 entries plus 16 bytes each), the per-query planes, one
    tile's bias and packed codes, and the survivors of 8 groups
    (csrc/pruned_lut.cu)."""
    return _LUT_QUERIES * (b_pad * _LUT_CENTERS + _LUT_PAD) \
        + (_LUT_QUERIES * (1 + _LUT_PARTS) + ps.TILE) * 4 \
        + ps.TILE * (b_pad // 2) + _LUT_QUERIES * (kpg * 8 + 4) * 4


def lut_max_b_pad(kpg: int) -> int:
    """The widest b_pad (a multiple of 8) whose K3 block fits the shared
    memory of one H100 block at kpg survivors a group: 160 at kpg <= 8,
    144 at 16."""
    b_pad = _BLK
    while lut_smem_bytes(b_pad + _BLK, kpg) <= _SMEM_LIMIT:
        b_pad += _BLK
    return b_pad


def score_work_lut(plan, qg_rows, codes3p, cb_k, csq, bias, *,
                   measure_l2: bool, kpg: int = ps.KPG):
    """K3 scorer.  CPU tensors run the plain version; CUDA tensors launch
    the CUDA kernel (or raise: there is no fallback on the GPU).  cb_k and
    csq are the index's lut_tables() (centering the codebook is done once
    per index; the JAX package does it per call, outside its kernel); the
    LUT product itself runs inside the kernel."""
    if codes3p.device.type == "cpu":
        return score_work_torch_lut(plan, qg_rows, codes3p, cb_k, csq, bias,
                                    measure_l2=measure_l2, kpg=kpg)
    if codes3p.device.type != "cuda":
        raise ValueError(f"unsupported device {codes3p.device}")
    global launches_lut
    from scann_torch import _cuda
    dev = codes3p.device
    num_tiles, tile, b2 = codes3p.shape
    b_pad = b2 * 2
    if b_pad % _BLK:
        raise ValueError(f"b_pad {b_pad} must be a multiple of {_BLK}")
    if lut_smem_bytes(b_pad, kpg) > _SMEM_LIMIT:
        raise ValueError(
            f"{b_pad} code blocks with {kpg} survivors a group need "
            f"{lut_smem_bytes(b_pad, kpg)} B of shared memory for the int8 "
            f"LUT, over the {_SMEM_LIMIT} B a block may use")
    dims_per_block = cb_k.shape[1]
    d_pad = b_pad * dims_per_block
    g_pad, w_pad, mnt = _common_checks(plan, qg_rows, codes3p, bias, kpg,
                                       d_pad, dev)
    _check("codes3p", codes3p, torch.uint8, (num_tiles, tile, b2), dev)
    _check("cb_k", cb_k, torch.float32,
           (b_pad * _LUT_CENTERS, dims_per_block), dev)
    _check("csq", csq, torch.float32, (b_pad * _LUT_CENTERS,), dev)
    if cb_k.data_ptr() % 16 or csq.data_ptr() % 16:
        raise ValueError("cb_k and csq must start on a 16-byte boundary "
                         "(the kernel reads them 16 bytes at a time)")
    out = torch.empty((g_pad, ps.QG, mnt * kpg * ps.GP), dtype=torch.int32,
                      device=dev)
    lib = _cuda.library("pruned_lut")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pruned_lut_score(
            plan.work_tile.data_ptr(), plan.work_active.data_ptr(),
            qg_rows.data_ptr(), codes3p.data_ptr(), cb_k.data_ptr(),
            csq.data_ptr(), bias.data_ptr(), out.data_ptr(), g_pad, mnt, kpg,
            b_pad, dims_per_block, d_pad,
            ctypes.c_float(2.0 if measure_l2 else 1.0), stream)
    if err != 0:
        raise RuntimeError(f"pruned_lut kernel launch failed: "
                           f"{_cuda.error_string(lib, err)} ({err})")
    launches_lut += 1
    return out


def score_work_codes(plan, qg_rows, codes3, cb_k, mean, bias, *,
                     measure_l2: bool, kpg: int = ps.KPG):
    """K4 scorer.  CPU tensors run the plain version; CUDA tensors launch
    the CUDA kernel (or raise: there is no fallback on the GPU) at any
    width: its shared memory does not grow with d_pad
    (ps.tile_smem_bytes("codes", kpg)).  cb_k is the index's
    codes_table()."""
    if codes3.device.type == "cpu":
        return score_work_torch_codes(plan, qg_rows, codes3, cb_k, mean,
                                      bias, measure_l2=measure_l2, kpg=kpg)
    if codes3.device.type != "cuda":
        raise ValueError(f"unsupported device {codes3.device}")
    global launches_codes
    from scann_torch import _cuda
    dev = codes3.device
    num_tiles, tile, b_pad = codes3.shape
    w, dims_per_block = cb_k.shape
    d_pad = b_pad * dims_per_block
    cpb = w // b_pad
    if b_pad % _BLK or cpb not in (16, 256) or cpb * b_pad != w:
        raise ValueError(f"unsupported codes: b_pad {b_pad} (needs a "
                         f"multiple of {_BLK}), {w} codebook rows (needs 16 "
                         f"or 256 per block)")
    g_pad, w_pad, mnt = _common_checks(plan, qg_rows, codes3, bias, kpg,
                                       d_pad, dev)
    _check("codes3", codes3, torch.uint8, (num_tiles, tile, b_pad), dev)
    _check("cb_k", cb_k, torch.float32, (w, dims_per_block), dev)
    _check("mean", mean, torch.float32, (d_pad,), dev)
    if mean.data_ptr() % 16:
        raise ValueError("mean must start on a 16-byte boundary (the "
                         "kernel copies it 16 bytes at a time)")
    out = torch.empty((g_pad, ps.QG, mnt * kpg * ps.GP), dtype=torch.int32,
                      device=dev)
    lib = _cuda.library("pruned_codes")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pruned_codes_score(
            plan.work_tile.data_ptr(), plan.work_active.data_ptr(),
            qg_rows.data_ptr(), codes3.data_ptr(), cb_k.data_ptr(),
            mean.data_ptr(), bias.data_ptr(), out.data_ptr(), w_pad, mnt,
            kpg, b_pad, cpb, dims_per_block, int(measure_l2), stream)
    if err != 0:
        raise RuntimeError(f"pruned_codes kernel launch failed: "
                           f"{_cuda.error_string(lib, err)} ({err})")
    launches_codes += 1
    return out
