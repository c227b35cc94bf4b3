"""Pruned exact scoring over residual per-row int8 leaves (tree-SQ scorer).

Port of scann_tpu/ops/pruned_sq.py.  Each active work item scores one
(256, d_pad) int8 residual tile against one (128, d_pad) bf16 query group:
``s = (int8 . q) * (scale * smult) + bias`` with f32 accumulation (smult 2
under squared L2), then keeps the top ``kpg`` of every 32-slot group with
the (tile, slot) identity packed into the low mantissa bits
(pruned_scan._group_top_packed).  The output is int32
(G_pad, 128, mnt * kpg * gp), item w writing columns
[(w % mnt) * kpg * gp, ...) of group w // mnt; inactive segments are left
unwritten and the merge never reads them.

``score_work_sq`` is the entry point: on CUDA tensors it launches the
hand-written kernel csrc/pruned_sq.cu (the port of the Pallas kernel
``score_work_pallas_sq``); on CPU tensors it runs ``score_work_torch_sq``,
the plain torch version with the same output contract.
"""

from __future__ import annotations

import ctypes

import torch

from scann_torch.ops import pruned_scan as ps
from scann_torch.ops.pruned_scan import _check

# Kernel launches made by score_work_sq (CPU calls never count).
launches = 0

_WORK_CHUNK = 128
_TILE = 256          # slots per tree-SQ leaf tile


def score_work_torch_sq(plan, qg_rows, rows3, scale, bias, *,
                        measure_l2: bool, kpg: int = 4,
                        work_chunk: int = _WORK_CHUNK):
    """Plain torch version of the K1 scorer (twin of the JAX package's
    score_work_xla_sq).  qg_rows: (G_pad, QG, d_pad) bf16; rows3:
    (num_tiles, tile, d_pad) int8; scale, bias: (num_tiles, tile[, 1])
    f32.  int8 and bf16 values convert exactly to f32 before the product,
    so every product is exact and only the summation order differs from
    the kernel.  Computes inactive items too (their values are never
    read)."""
    w_pad = plan.work_tile.shape[0]
    mnt = w_pad // plan.qg_query.shape[0]
    smult = 2.0 if measure_l2 else 1.0
    tile = rows3.shape[1]
    gp = tile // ps.SUBP
    scale2 = scale.reshape(-1, tile)
    bias2 = bias.reshape(-1, tile)
    dev = rows3.device
    out = torch.empty((w_pad, ps.QG, kpg * gp), dtype=torch.int32,
                      device=dev)
    wi = torch.arange(w_pad, dtype=torch.int32, device=dev) % mnt
    for s0 in range(0, w_pad, work_chunk):
        wt = plan.work_tile[s0:s0 + work_chunk].long()
        wq = plan.work_qg[s0:s0 + work_chunk].long()
        c = wt.shape[0]
        r = rows3[wt].float()                       # (C, tile, d)
        q = qg_rows[wq].float()                     # (C, QG, d)
        dots = torch.bmm(r, q.transpose(1, 2))      # (C, tile, QG)
        s = dots * (scale2[wt] * smult)[:, :, None] + bias2[wt][:, :, None]
        g = s.reshape(c, gp, ps.SUBP, ps.QG)
        packed = ps._group_top_packed(g, wi[s0:s0 + c, None, None, None],
                                      axis=2, cat_axis=1, kpg=kpg)
        out[s0:s0 + c] = packed.transpose(1, 2)
    g = w_pad // mnt
    return (out.reshape(g, mnt, ps.QG, kpg * gp).transpose(1, 2)
            .reshape(g, ps.QG, mnt * kpg * gp))


def score_work_sq(plan, qg_rows, rows3, scale, bias, *, measure_l2: bool,
                  kpg: int = 4):
    """K1 scorer.  CPU tensors run the plain version; CUDA tensors launch
    the CUDA kernel (or raise: there is no fallback on the GPU)."""
    if rows3.device.type == "cpu":
        return score_work_torch_sq(plan, qg_rows, rows3, scale, bias,
                                   measure_l2=measure_l2, kpg=kpg)
    if rows3.device.type != "cuda":
        raise ValueError(f"unsupported device {rows3.device}")
    global launches
    from scann_torch import _cuda
    dev = rows3.device
    num_tiles, tile, d_pad = rows3.shape
    g_pad = plan.qg_query.shape[0]
    w_pad = plan.work_tile.shape[0]
    if tile != _TILE or w_pad % g_pad or d_pad % 8:
        raise ValueError(f"unsupported shapes: tile {tile} (needs {_TILE}),"
                         f" w_pad {w_pad}, g_pad {g_pad}, d_pad {d_pad} "
                         f"(needs a multiple of 8)")
    if not 1 <= kpg <= ps.SUBP:
        raise ValueError(f"kpg must be in [1, {ps.SUBP}], got {kpg}")
    mnt = w_pad // g_pad
    gp = tile // ps.SUBP
    _check("work_tile", plan.work_tile, torch.int32, (w_pad,), dev)
    _check("work_active", plan.work_active, torch.int32, (w_pad,), dev)
    _check("qg_rows", qg_rows, torch.bfloat16, (g_pad, ps.QG, d_pad), dev)
    _check("rows3", rows3, torch.int8, (num_tiles, tile, d_pad), dev)
    for name, plane in (("scale", scale), ("bias", bias)):
        _check(name, plane, torch.float32,
               (num_tiles, tile) + (1,) * (plane.dim() - 2), dev)
    out = torch.empty((g_pad, ps.QG, mnt * kpg * gp), dtype=torch.int32,
                      device=dev)
    lib = _cuda.library("pruned_sq")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pruned_sq_score(
            plan.work_tile.data_ptr(), plan.work_active.data_ptr(),
            qg_rows.data_ptr(), rows3.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), w_pad, mnt, kpg, d_pad,
            ctypes.c_float(2.0 if measure_l2 else 1.0), stream)
    if err != 0:
        raise RuntimeError(f"pruned_sq kernel launch failed: "
                           f"{_cuda.error_string(lib, err)} ({err})")
    launches += 1
    return out
