"""The port's hand-written kernels as ``torch.library`` custom ops.

One op under the namespace ``scann_torch`` for each kernel entry point:

=========================  ====  ==========================================
op                         K     CUDA implementation (csrc/)
=========================  ====  ==========================================
``pruned_sq_score``        K1    pruned_sq.cu ``pruned_sq_score``
``pruned_rows_score``      K2    pruned_rows.cu ``pruned_rows_score``
``pruned_lut_build``       K3    pruned_lut.cu ``pruned_lut_build``
``pruned_lut_score``       K3    pruned_lut.cu ``pruned_lut_score``
``pruned_codes_score``     K4    pruned_codes.cu ``pruned_codes_score``
``fused_scan_groupmax``    K5    fused_scan.cu ``fused_scan_groupmax``
``merge_groups``           K6    merge_groups.cu ``merge_groups_topk``
``pruned_plan``            plan  pruned_plan.cu ``pruned_plan``
``pruned_merge``           merge pruned_merge.cu ``pruned_merge``
=========================  ====  ==========================================

Each takes tensors, ints, floats and bools only (a ``WorkPlan`` travels as
its tensors).  The CUDA implementation checks its operands, launches the
kernel through ctypes on the current stream (or raises) and adds one to
its module's launch counter (``pruned_sq.launches``,
``pruned_scan.launches``, ``pruned_lut.launches_lut``,
``pruned_lut.launches_codes``, ``fused_scan.launches``,
``pruned_scan.launches_merge``, ``pruned_scan.launches_plan``,
``pruned_scan.launches_select``; the two halves of K3 count once, at the
scorer, and the plan's kernels once a plan).  The CPU implementation is
the plain torch version.  The fake
implementation gives the output shapes, so ``torch.export`` traces a
search through the ops without reading their operands: an exported
program holds calls to ``torch.ops.scann_torch.*``, and the process that
loads it imports this module to register them.  The entry points of
ops/pruned_sq.py, ops/pruned_scan.py, ops/pruned_lut.py and
ops/fused_scan.py call these ops on every device.

The first import registers the ops; it is the ``register`` span of
utils/profiling.py, opened below and closed at the end of this module.  A
custom op's first call imports ``torch._dynamo`` (its implementations run
under ``torch._disable_dynamo``), and with it ``torch.distributed`` and
sympy: seconds, 8-10 on the CUDA build.  This module imports it itself,
so that the cost falls in the registration and not in the first search
stage that calls an op.
"""

from __future__ import annotations

import ctypes
import types
from typing import Optional

import torch

from scann_torch.ops import fused_scan as fs
from scann_torch.ops import pruned_lut as pl
from scann_torch.ops import pruned_scan as ps
from scann_torch.ops import pruned_sq as psq
from scann_torch.ops.pruned_scan import _check
from scann_torch.utils import profiling

_registering = profiling.phase("register")
_registering.__enter__()
import torch._dynamo  # noqa: E402,F401  (see the module's docstring)

Tensor = torch.Tensor


def _plan(work_tile, work_qg, work_active, qg_query):
    """The WorkPlan fields the scorers read."""
    return types.SimpleNamespace(work_tile=work_tile, work_qg=work_qg,
                                 work_active=work_active, qg_query=qg_query)


def _launch(lib_name: str, entry: str, dev, *args):
    """Call ``entry`` of csrc/<lib_name>.cu on the current stream of
    ``dev``; raise with the kernel's message on a non-zero return."""
    from scann_torch import _cuda
    lib = _cuda.library(lib_name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{lib_name} kernel launch failed: "
                           f"{_cuda.error_string(lib, err)} ({err})")


def _tile_checks(work_tile, work_active, g_pad: int, kpg: int, tile: int,
                 want_tile: int, dev, d_pad=None):
    """Checks shared by the tile scorers; returns (w_pad, mnt).  K1 and
    K2 pass their ``d_pad``, which must be a multiple of 8."""
    w_pad = work_tile.shape[0]
    if tile != want_tile or w_pad % g_pad or (d_pad or 0) % 8:
        raise ValueError(f"unsupported shapes: tile {tile} (needs "
                         f"{want_tile}), w_pad {w_pad}, g_pad {g_pad}"
                         + ("" if d_pad is None else
                            f", d_pad {d_pad} (needs a multiple of 8)"))
    if not 1 <= kpg <= ps.SUBP:
        raise ValueError(f"kpg must be in [1, {ps.SUBP}], got {kpg}")
    _check("work_tile", work_tile, torch.int32, (w_pad,), dev)
    _check("work_active", work_active, torch.int32, (w_pad,), dev)
    return w_pad, w_pad // g_pad


def _packed_out(work_tile, g_pad: int, kpg: int, gp: int):
    mnt = work_tile.shape[0] // g_pad
    return work_tile.new_empty((g_pad, ps.QG, mnt * kpg * gp),
                               dtype=torch.int32)


# ---------------------------------------------------------------- K1
@torch.library.custom_op("scann_torch::pruned_sq_score", mutates_args=(),
                         device_types="cpu")
def pruned_sq_score(work_tile: Tensor, work_qg: Tensor, work_active: Tensor,
                    qg_rows: Tensor, rows3: Tensor, scale: Tensor,
                    bias: Tensor, g_pad: int, measure_l2: bool,
                    kpg: int) -> Tensor:
    """K1: tree-SQ's int8 tiles against bf16 query groups."""
    plan = _plan(work_tile, work_qg, work_active,
                 work_tile.new_empty((g_pad, 0)))
    return psq.score_work_torch_sq(plan, qg_rows, rows3, scale, bias,
                                   measure_l2=measure_l2, kpg=kpg)


@pruned_sq_score.register_kernel("cuda")
def _pruned_sq_score_cuda(work_tile, work_qg, work_active, qg_rows, rows3,
                          scale, bias, g_pad, measure_l2, kpg):
    del work_qg
    dev = rows3.device
    num_tiles, tile, d_pad = rows3.shape
    w_pad, mnt = _tile_checks(work_tile, work_active, g_pad, kpg, tile,
                              psq._TILE, dev, d_pad)
    _check("qg_rows", qg_rows, torch.bfloat16, (g_pad, ps.QG, d_pad), dev)
    _check("rows3", rows3, torch.int8, (num_tiles, tile, d_pad), dev)
    for name, plane in (("scale", scale), ("bias", bias)):
        _check(name, plane, torch.float32,
               (num_tiles, tile) + (1,) * (plane.dim() - 2), dev)
    out = _packed_out(work_tile, g_pad, kpg, tile // ps.SUBP)
    _launch("pruned_sq", "pruned_sq_score", dev, work_tile.data_ptr(),
            work_active.data_ptr(), qg_rows.data_ptr(), rows3.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), w_pad, mnt,
            kpg, d_pad, ctypes.c_float(2.0 if measure_l2 else 1.0))
    psq.launches += 1
    return out


@pruned_sq_score.register_fake
def _(work_tile, work_qg, work_active, qg_rows, rows3, scale, bias, g_pad,
      measure_l2, kpg):
    return _packed_out(work_tile, g_pad, kpg, rows3.shape[1] // ps.SUBP)


# ---------------------------------------------------------------- K2
@torch.library.custom_op("scann_torch::pruned_rows_score", mutates_args=(),
                         device_types="cpu")
def pruned_rows_score(work_tile: Tensor, work_qg: Tensor,
                      work_active: Tensor, qg_rows: Tensor, rows3: Tensor,
                      bias: Tensor, g_pad: int, measure_l2: bool,
                      kpg: int) -> Tensor:
    """K2: reconstruct mode's decoded bf16 tiles against bf16 query
    groups."""
    plan = _plan(work_tile, work_qg, work_active,
                 work_tile.new_empty((g_pad, 0)))
    return ps.score_work_torch(plan, qg_rows, rows3, bias,
                               measure_l2=measure_l2, kpg=kpg)


@pruned_rows_score.register_kernel("cuda")
def _pruned_rows_score_cuda(work_tile, work_qg, work_active, qg_rows, rows3,
                            bias, g_pad, measure_l2, kpg):
    del work_qg
    dev = rows3.device
    num_tiles, tile, d_pad = rows3.shape
    w_pad, mnt = _tile_checks(work_tile, work_active, g_pad, kpg, tile,
                              ps.TILE, dev, d_pad)
    _check("qg_rows", qg_rows, torch.bfloat16, (g_pad, ps.QG, d_pad), dev)
    _check("rows3", rows3, torch.bfloat16, (num_tiles, tile, d_pad), dev)
    _check("bias", bias, torch.float32,
           (num_tiles, tile) + (1,) * (bias.dim() - 2), dev)
    out = _packed_out(work_tile, g_pad, kpg, ps.GP)
    _launch("pruned_rows", "pruned_rows_score", dev, work_tile.data_ptr(),
            work_active.data_ptr(), qg_rows.data_ptr(), rows3.data_ptr(),
            bias.data_ptr(), out.data_ptr(), w_pad, mnt, kpg, d_pad,
            ctypes.c_float(2.0 if measure_l2 else 1.0))
    ps.launches += 1
    return out


@pruned_rows_score.register_fake
def _(work_tile, work_qg, work_active, qg_rows, rows3, bias, g_pad,
      measure_l2, kpg):
    return _packed_out(work_tile, g_pad, kpg, ps.GP)


# ---------------------------------------------------------------- K3
@torch.library.custom_op("scann_torch::pruned_lut_build", mutates_args=(),
                         device_types="cpu")
def pruned_lut_build(q_rows: Tensor, cb_k: Tensor, csq: Tensor,
                     measure_l2: bool) -> tuple[Tensor, Tensor]:
    """K3's pre-pass: each query's int8 LUT (nq, b_pad * 16) and its
    dequantization factor (nq,)."""
    return pl.lut_build_torch(q_rows, cb_k, csq, measure_l2=measure_l2)


@pruned_lut_build.register_kernel("cuda")
def _pruned_lut_build_cuda(q_rows, cb_k, csq, measure_l2):
    dev = q_rows.device
    nq = q_rows.shape[0]
    dims_per_block = cb_k.shape[1]
    b_pad = csq.shape[0] // pl._LUT_CENTERS
    d_pad = b_pad * dims_per_block
    if b_pad % pl._BLK:
        raise ValueError(f"b_pad {b_pad} must be a multiple of {pl._BLK}")
    _check("q_rows", q_rows, torch.bfloat16, (nq, d_pad), dev)
    _check("cb_k", cb_k, torch.float32,
           (b_pad * pl._LUT_CENTERS, dims_per_block), dev)
    _check("csq", csq, torch.float32, (b_pad * pl._LUT_CENTERS,), dev)
    if nq == 0:
        raise ValueError("q_rows holds no query")
    if cb_k.data_ptr() % 16 or csq.data_ptr() % 16:
        raise ValueError("cb_k and csq must start on a 16-byte boundary "
                         "(the kernel reads them 16 bytes at a time)")
    lut = torch.empty((nq, b_pad * pl._LUT_CENTERS), dtype=torch.int8,
                      device=dev)
    inv = torch.empty((nq,), dtype=torch.float32, device=dev)
    _launch("pruned_lut", "pruned_lut_build", dev, q_rows.data_ptr(),
            cb_k.data_ptr(), csq.data_ptr(), lut.data_ptr(), inv.data_ptr(),
            nq, b_pad, dims_per_block, d_pad,
            ctypes.c_float(2.0 if measure_l2 else 1.0))
    return lut, inv


@pruned_lut_build.register_fake
def _(q_rows, cb_k, csq, measure_l2):
    nq = q_rows.shape[0]
    return (q_rows.new_empty((nq, csq.shape[0]), dtype=torch.int8),
            q_rows.new_empty((nq,), dtype=torch.float32))


@torch.library.custom_op("scann_torch::pruned_lut_score", mutates_args=(),
                         device_types="cpu")
def pruned_lut_score(work_tile: Tensor, work_qg: Tensor, work_active: Tensor,
                     qg_query: Tensor, lut: Tensor, inv: Tensor,
                     codes3p: Tensor, bias: Tensor, kpg: int) -> Tensor:
    """K3's scorer: int32 sums of the pair-packed 4-bit codes' LUT
    entries, dequantized, plus the bias; packed top kpg."""
    return pl.lut_score_torch(_plan(work_tile, work_qg, work_active,
                                    qg_query), lut, inv, codes3p, bias,
                              kpg=kpg)


@pruned_lut_score.register_kernel("cuda")
def _pruned_lut_score_cuda(work_tile, work_qg, work_active, qg_query, lut,
                           inv, codes3p, bias, kpg):
    del work_qg
    dev = codes3p.device
    num_tiles, tile, b2 = codes3p.shape
    b_pad = b2 * 2
    if b_pad % pl._BLK:
        raise ValueError(f"b_pad {b_pad} must be a multiple of {pl._BLK}")
    g_pad = qg_query.shape[0]
    w_pad, mnt = _tile_checks(work_tile, work_active, g_pad, kpg, tile,
                              ps.TILE, dev)
    nq = lut.shape[0]
    _check("qg_query", qg_query, torch.int32, (g_pad, ps.QG), dev)
    _check("lut", lut, torch.int8, (nq, b_pad * pl._LUT_CENTERS), dev)
    _check("inv", inv, torch.float32, (nq,), dev)
    _check("codes3p", codes3p, torch.uint8, (num_tiles, tile, b2), dev)
    _check("bias", bias, torch.float32,
           (num_tiles, tile) + (1,) * (bias.dim() - 2), dev)
    out = _packed_out(work_tile, g_pad, kpg, ps.GP)
    _launch("pruned_lut", "pruned_lut_score", dev, work_tile.data_ptr(),
            work_active.data_ptr(), qg_query.data_ptr(), lut.data_ptr(),
            inv.data_ptr(), codes3p.data_ptr(), bias.data_ptr(),
            out.data_ptr(), g_pad, mnt, kpg, b_pad)
    pl.launches_lut += 1
    return out


@pruned_lut_score.register_fake
def _(work_tile, work_qg, work_active, qg_query, lut, inv, codes3p, bias,
      kpg):
    return _packed_out(work_tile, qg_query.shape[0], kpg, ps.GP)


# ---------------------------------------------------------------- K4
@torch.library.custom_op("scann_torch::pruned_codes_score",
                         mutates_args=(), device_types="cpu")
def pruned_codes_score(work_tile: Tensor, work_qg: Tensor,
                       work_active: Tensor, qg_rows: Tensor, codes3: Tensor,
                       cb_k: Tensor, mean: Tensor, bias: Tensor, g_pad: int,
                       measure_l2: bool, kpg: int) -> Tensor:
    """K4: tiles decoded from one-byte codes through the bf16 codebook,
    against bf16 query groups."""
    plan = _plan(work_tile, work_qg, work_active,
                 work_tile.new_empty((g_pad, 0)))
    return pl.score_work_torch_codes(plan, qg_rows, codes3, cb_k, mean, bias,
                                     measure_l2=measure_l2, kpg=kpg)


@pruned_codes_score.register_kernel("cuda")
def _pruned_codes_score_cuda(work_tile, work_qg, work_active, qg_rows, codes3,
                             cb_k, mean, bias, g_pad, measure_l2, kpg):
    del work_qg
    dev = codes3.device
    num_tiles, tile, b_pad = codes3.shape
    w, dims_per_block = cb_k.shape
    d_pad = b_pad * dims_per_block
    cpb = w // b_pad
    if b_pad % pl._BLK or cpb not in (16, 256) or cpb * b_pad != w:
        raise ValueError(f"unsupported codes: b_pad {b_pad} (needs a "
                         f"multiple of {pl._BLK}), {w} codebook rows (needs "
                         f"16 or 256 per block)")
    w_pad, mnt = _tile_checks(work_tile, work_active, g_pad, kpg, tile,
                              ps.TILE, dev)
    _check("qg_rows", qg_rows, torch.bfloat16, (g_pad, ps.QG, d_pad), dev)
    _check("bias", bias, torch.float32,
           (num_tiles, tile) + (1,) * (bias.dim() - 2), dev)
    _check("codes3", codes3, torch.uint8, (num_tiles, tile, b_pad), dev)
    _check("cb_k", cb_k, torch.float32, (w, dims_per_block), dev)
    _check("mean", mean, torch.float32, (d_pad,), dev)
    if mean.data_ptr() % 16:
        raise ValueError("mean must start on a 16-byte boundary (the "
                         "kernel copies it 16 bytes at a time)")
    out = _packed_out(work_tile, g_pad, kpg, ps.GP)
    _launch("pruned_codes", "pruned_codes_score", dev, work_tile.data_ptr(),
            work_active.data_ptr(), qg_rows.data_ptr(), codes3.data_ptr(),
            cb_k.data_ptr(), mean.data_ptr(), bias.data_ptr(),
            out.data_ptr(), w_pad, mnt, kpg, b_pad, cpb, dims_per_block,
            int(measure_l2))
    pl.launches_codes += 1
    return out


@pruned_codes_score.register_fake
def _(work_tile, work_qg, work_active, qg_rows, codes3, cb_k, mean, bias,
      g_pad, measure_l2, kpg):
    return _packed_out(work_tile, g_pad, kpg, ps.GP)


# ---------------------------------------------------------------- K5
@torch.library.custom_op("scann_torch::fused_scan_groupmax",
                         mutates_args=(), device_types="cpu")
def fused_scan_groupmax(queries: Tensor, rows: Tensor, bias: Tensor,
                        measure_l2: bool) -> tuple[Tensor, Tensor]:
    """K5: the max and first argmax of every 256-slot group of
    ``scale * rows . q + bias``.  On the card the query count must be a
    multiple of the kernel's query tile (the entry point pads)."""
    return fs.fused_scan_groupmax_torch(queries, rows, bias,
                                        measure_l2=measure_l2)


@fused_scan_groupmax.register_kernel("cuda")
def _fused_scan_groupmax_cuda(queries, rows, bias, measure_l2):
    dev = rows.device
    q, d = queries.shape
    s = rows.shape[0]
    if q % fs.QT:
        raise ValueError(f"{q} queries: the kernel takes a multiple of "
                         f"{fs.QT}")
    _check("queries", queries, torch.bfloat16, (q, d), dev)
    _check("rows", rows, torch.bfloat16, (s, d), dev)
    _check("bias", bias, torch.float32, (s,), dev)
    n_groups = s // fs.SUB
    vals = torch.empty((q, n_groups), dtype=torch.float32, device=dev)
    idx = torch.empty((q, n_groups), dtype=torch.int32, device=dev)
    _launch("fused_scan", "fused_scan_groupmax", dev, queries.data_ptr(),
            rows.data_ptr(), bias.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), q, s, d,
            ctypes.c_float(2.0 if measure_l2 else 1.0))
    fs.launches += 1
    return vals, idx


@fused_scan_groupmax.register_fake
def _(queries, rows, bias, measure_l2):
    shape = (queries.shape[0], rows.shape[0] // fs.SUB)
    return (queries.new_empty(shape, dtype=torch.float32),
            queries.new_empty(shape, dtype=torch.int32))


# ---------------------------------------------------------------- K6
@torch.library.custom_op("scann_torch::merge_groups", mutates_args=(),
                         device_types="cpu")
def merge_groups(packed: Tensor, qg_nt: Tensor, kgp: int, tile: int,
                 k: int) -> tuple[Tensor, Tensor]:
    """K6: every row of every group's packed block reduced to its top-k
    (key, tile)."""
    return ps.merge_groups_torch(packed, qg_nt, kgp=kgp, tile=tile, k=k)


@merge_groups.register_kernel("cuda")
def _merge_groups_cuda(packed, qg_nt, kgp, tile, k):
    dev = packed.device
    g_pad, qg, w = packed.shape
    gp = tile // ps.SUBP
    bits = ps._bits
    if (qg != ps.QG or kgp & (kgp - 1) or gp & (gp - 1)
            or bits(gp) > ps._TILE_BITS or w % kgp):
        raise ValueError(f"unsupported shapes: {qg} rows per group (needs "
                         f"{ps.QG}), kgp {kgp} and tile/32 = {gp} (need "
                         f"powers of two, tile/32 <= {ps.MAX_NTILES}), w {w}")
    if not 1 <= k <= min(ps._FUSED_MAX_K, w):
        raise ValueError(f"k must be in [1, min({ps._FUSED_MAX_K}, w)], got "
                         f"{k}")
    _check("packed", packed, torch.int32, (g_pad, qg, w), dev)
    _check("qg_nt", qg_nt, torch.int32, (g_pad,), dev)
    mb = torch.empty((g_pad, qg, k), dtype=torch.int32, device=dev)
    ts = torch.empty_like(mb)
    _launch("merge_groups", "merge_groups_topk", dev, packed.data_ptr(),
            qg_nt.data_ptr(), mb.data_ptr(), ts.data_ptr(), g_pad, w, k,
            bits(gp), bits(kgp))
    ps.launches_merge += 1
    return mb, ts


@merge_groups.register_fake
def _(packed, qg_nt, kgp, tile, k):
    shape = (packed.shape[0], packed.shape[1], k)
    return packed.new_empty(shape), packed.new_empty(shape)


# ---------------------------------------------------------------- plan
@torch.library.custom_op("scann_torch::pruned_plan", mutates_args=(),
                         device_types="cpu")
def pruned_plan(sel: Tensor, valid_sel: Tensor, tile_start: Tensor,
                ntiles: Tensor, max_ntiles: int, g_pad: int
                ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
                           Tensor]:
    """The leaf-major work plan of a pruned batch, the fields of
    ``pruned_scan.WorkPlan`` in order."""
    return tuple(ps.invert(sel, valid_sel, tile_start, ntiles, max_ntiles,
                           g_pad, g_pad * max_ntiles))


def _plan_out(sel, max_ntiles: int, g_pad: int):
    w_pad = g_pad * max_ntiles
    shapes = ((g_pad, ps.QG), (g_pad,), (w_pad,), (w_pad,), (w_pad,),
              tuple(sel.shape), tuple(sel.shape))
    return tuple(sel.new_empty(s, dtype=torch.int32) for s in shapes)


@pruned_plan.register_kernel("cuda")
def _pruned_plan_cuda(sel, valid_sel, tile_start, ntiles, max_ntiles, g_pad):
    from scann_torch import _cuda
    dev = sel.device
    b, l = sel.shape
    p, nl = b * l, tile_start.shape[0]
    if p == 0 or nl == 0 or max_ntiles < 1 or g_pad < 1:
        raise ValueError(f"unsupported shapes: {b} x {l} pairs, {nl} "
                         f"leaves, max_ntiles {max_ntiles}, g_pad {g_pad}")
    _check("sel", sel, torch.int32, (b, l), dev)
    _check("valid_sel", valid_sel, torch.bool, (b, l), dev)
    _check("tile_start", tile_start, torch.int32, (nl,), dev)
    _check("ntiles", ntiles, torch.int32, (nl,), dev)
    nbytes = ctypes.c_int64()
    lib = _cuda.library("pruned_plan")
    err = lib.pruned_plan_scratch_bytes(p, nl, ctypes.byref(nbytes))
    if err != 0:
        raise RuntimeError(f"pruned_plan scratch: "
                           f"{_cuda.error_string(lib, err)} ({err})")
    scratch = torch.empty((nbytes.value,), dtype=torch.uint8, device=dev)
    out = _plan_out(sel, max_ntiles, g_pad)
    _launch("pruned_plan", "pruned_plan", dev, sel.data_ptr(),
            valid_sel.data_ptr(), tile_start.data_ptr(), ntiles.data_ptr(),
            scratch.data_ptr(), *(t.data_ptr() for t in out), nbytes.value,
            p, l, nl, g_pad, max_ntiles)
    ps.launches_plan += 1
    return out


@pruned_plan.register_fake
def _(sel, valid_sel, tile_start, ntiles, max_ntiles, g_pad):
    return _plan_out(sel, max_ntiles, g_pad)


# ---------------------------------------------------------------- merge
@torch.library.custom_op("scann_torch::pruned_merge", mutates_args=(),
                         device_types="cpu")
def pruned_merge(packed: Tensor, work_active: Tensor, pair_gid: Tensor,
                 pair_row: Tensor, sel: Tensor, valid_sel: Tensor,
                 tile_start: Tensor, ntiles: Tensor, dpid: Tensor,
                 pair_bias: Optional[Tensor], q_norm: Optional[Tensor],
                 max_ntiles: int, k_fetch: int, hot: int,
                 tile: int) -> tuple[Tensor, Tensor]:
    """Each query's top min(k_fetch, n) merge candidates as (values,
    datapoint ids), ``pruned_scan.merge_ids_torch``."""
    return ps.merge_ids_torch(
        packed, work_active, pair_gid, pair_row, sel, valid_sel, tile_start,
        ntiles, dpid, pair_bias, q_norm, max_ntiles=max_ntiles,
        k_fetch=k_fetch, hot=hot, tile=tile)


def _merge_out(packed, sel, max_ntiles: int, k_fetch: int, hot: int,
               tile: int):
    b, l = sel.shape
    n = ps.merge_width(l, hot, max_ntiles, packed.shape[-1] // max_ntiles,
                       tile // ps.SUBP)
    k = min(k_fetch, n)
    return (packed.new_empty((b, k), dtype=torch.float32),
            packed.new_empty((b, k), dtype=torch.int32))


@pruned_merge.register_kernel("cuda")
def _pruned_merge_cuda(packed, work_active, pair_gid, pair_row, sel,
                       valid_sel, tile_start, ntiles, dpid, pair_bias, q_norm,
                       max_ntiles, k_fetch, hot, tile):
    del work_active
    dev = packed.device
    b, l = sel.shape
    g_pad, qg, w = packed.shape
    hot = min(hot, l)
    kgp, gp = w // max(max_ntiles, 1), tile // ps.SUBP
    n = ps.merge_width(l, hot, max_ntiles, kgp, gp)
    if (qg != ps.QG or max_ntiles < 1 or w != max_ntiles * kgp
            or tile != gp * ps.SUBP or hot < 1
            or not ps.select_fits(n, min(k_fetch, n), kgp, gp, max_ntiles)):
        raise ValueError(
            f"unsupported merge: {qg} rows a group (needs {ps.QG}), w {w}, "
            f"max_ntiles {max_ntiles} (needs <= {ps.MAX_NTILES}), tile "
            f"{tile}, hot {hot} of {l} leaves, {n} candidates (needs <= "
            f"{ps._SELECT_MAX_N}), k_fetch {k_fetch} (k needs 1 to "
            f"{ps._SELECT_MAX_K}), kgp {kgp} and tile/32 {gp} (need "
            f"multiples of 4)")
    _check("packed", packed, torch.int32, (g_pad, qg, w), dev)
    for name, t, dtype in (("pair_gid", pair_gid, torch.int32),
                           ("pair_row", pair_row, torch.int32),
                           ("sel", sel, torch.int32),
                           ("valid_sel", valid_sel, torch.bool)):
        _check(name, t, dtype, (b, l), dev)
    nl = tile_start.shape[0]
    _check("tile_start", tile_start, torch.int32, (nl,), dev)
    _check("ntiles", ntiles, torch.int32, (nl,), dev)
    _check("dpid", dpid, torch.int32, (dpid.shape[0],), dev)
    if pair_bias is not None:
        _check("pair_bias", pair_bias, torch.float32, (b, l), dev)
    if q_norm is not None:
        _check("q_norm", q_norm, torch.float32, (b,), dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed must start on a 16-byte boundary (the "
                         "kernel reads it 16 bytes at a time)")
    vals, ids = _merge_out(packed, sel, max_ntiles, k_fetch, hot, tile)
    if b == 0:
        return vals, ids
    _launch("pruned_merge", "pruned_merge", dev, packed.data_ptr(),
            pair_gid.data_ptr(), pair_row.data_ptr(), sel.data_ptr(),
            valid_sel.data_ptr(), tile_start.data_ptr(), ntiles.data_ptr(),
            dpid.data_ptr(),
            None if pair_bias is None else pair_bias.data_ptr(),
            None if q_norm is None else q_norm.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), b, l, hot, max_ntiles, kgp, gp, tile,
            vals.shape[1])
    ps.launches_select += 1
    return vals, ids


@pruned_merge.register_fake
def _(packed, work_active, pair_gid, pair_row, sel, valid_sel, tile_start,
      ntiles, dpid, pair_bias, q_norm, max_ntiles, k_fetch, hot, tile):
    return _merge_out(packed, sel, max_ntiles, k_fetch, hot, tile)


OPS = (pruned_sq_score, pruned_rows_score, pruned_lut_build,
       pruned_lut_score, pruned_codes_score, fused_scan_groupmax,
       merge_groups, pruned_plan, pruned_merge)

_registering.__exit__(None, None, None)
del _registering
