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

``score_work_sq`` is the entry point, through the custom op
``pruned_sq_score`` (ops/library.py): on CUDA tensors it launches the
hand-written kernel csrc/pruned_sq.cu (the port of the Pallas kernel
``score_work_pallas_sq``); on CPU tensors it runs ``score_work_torch_sq``,
the plain torch version with the same output contract.
"""

from __future__ import annotations

import torch

from scann_torch.ops import pruned_scan as ps

# Kernel launches of K1, counted by its CUDA implementation in
# ops/library.py (CPU calls never count).
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
    """K1 scorer, the custom op ``pruned_sq_score`` (ops/library.py).  CPU
    tensors run the plain version; CUDA tensors launch the CUDA kernel (or
    raise: there is no fallback on the GPU)."""
    ps.check_device(rows3)
    from scann_torch.ops import library
    return library.pruned_sq_score(
        plan.work_tile, plan.work_qg, plan.work_active, qg_rows, rows3, scale,
        bias, plan.qg_query.shape[0], measure_l2, kpg)
