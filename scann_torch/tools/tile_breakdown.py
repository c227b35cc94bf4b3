"""K1, K2 and K4 (the tile x query-group scorers of csrc/tile_mma.cuh) on
one CUDA card: where their time goes, and how close their sums come to
float64.

    python3 -m scann_torch.tools.tile_breakdown

Builds csrc/pruned_sq.cu, csrc/pruned_rows.cu and csrc/pruned_codes.cu as
they are and from edited copies of csrc/tile_mma.cuh:
  * "no selection": scores are computed but only a token of them is kept
    (the survivors' copy-out still runs), so the difference to the kernel
    is the survivor selection;
  * "sort 8 at kpg <= 4": the selection sorts all 8 values of a lane at
    every kpg, where the kernel keeps only the top 4 for kpg <= 4 (K1's
    main path); at K2's kpg 8 the two are the same code, which shows the
    spread of the timing;
  * "chained accumulator": every mma adds into the running sum inside the
    tensor core, where the kernel starts each mma from zero and adds its
    partial with a rounded f32 add;
  * K4 only, "no selection, no decode": as "no selection", and the decode
    step skipped (the product runs on whatever the converted tile holds),
    so the difference to "no selection" is the decode and what is left is
    the copies and the product;
  * K4 only, "dpb at run time" (an edited csrc/pruned_codes.cu): 2 and 4
    dimensions a block take the kernel that reads the width at run time
    and the code bytes from shared memory (CodesN), where the kernel
    fixes the width at compile time and holds the bytes in registers.
Time: each variant on a synthetic plan shaped like the benchmark's at
leaves=100 (10,000 queries, 100 of 2000 leaves; tree-SQ: leaves of 1-4
256-slot tiles, d_pad 104, kpg 4; reconstruct: leaves of 1-2 512-slot
tiles, d_pad 128, kpg 8; float32 lookup: the same tiles as 50 code blocks
of 16 centers at 2 dimensions a block, d_pad 112, kpg 8; K4 also as 25
blocks of 256 centers at 4 dimensions a block, d_pad 128, for the kernel
and "dpb at run time"): 5 rounds over the variants in turn, each round the
median of 10 CUDA-event timings; the line gives the median of the rounds
and their range.
Accuracy: on smaller plans at several widths, with data of two scales
(scann_torch/tools/tile_cases.py), every live survivor of the kernel, of
the chained variant and of the plain version is rescored in float64 from
its identity; the line gives the largest |value - exact| - 2^-14 |exact|
of each and of the kernel against the plain version, and at the raw-scale
cases the card tests hold (tile_cases.RAW_CASES) whether the kernel and
the chained variant stay within RAW_EXCESS_RATIO times the plain
version's.  The variants' sources and libraries go to a temporary
directory.
"""

from __future__ import annotations

import ctypes
import tempfile

import numpy as np
import torch

from scann_torch.ops import pruned_scan as ps
from scann_torch.tools import tile_cases
from scann_torch.tools.variants import build_variant

_SELECT = ("survivors::quad_top_kpg<kKeep>(pv, kpg, kWarps, tq == 0, "
           "[&](int r) {")
_NO_SELECT = ("if (pv[0][0] == 1234.5f && pv[7][7] == 2.f) stage_s[0] = 1; "
              "if (0) " + _SELECT)
_SORT8 = ("return a.kpg <= 4 ? launch<T, 4>(a, w_pad, s) : "
          "launch<T, 8>(a, w_pad, s);", "return launch<T, 8>(a, w_pad, s);")
_CHAINED = [
    ('"{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};',
     '"{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};'),
    (': "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])',
     ': "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])'),
    ("mma_bf16(part[mi], af[mi],", "mma_bf16(acc[mi][j], af[mi],"),
    ("acc[mi][j][e] = __fadd_rn(acc[mi][j][e], part[mi][e]);", "(void)e;")]
_NO_DECODE = ("sq = decode_codes<T>(", "if (0) sq = decode_codes<T>(")
_RUNTIME_DPB = (
    "  if (dpb == 2) return tile_mma::score<Codes2>(a, w_pad, stream);\n"
    "  if (dpb == 4) return tile_mma::score<Codes4>(a, w_pad, stream);\n",
    "")
VARIANTS = {"kernel": [], "no selection": [(_SELECT, _NO_SELECT)],
            "sort 8 at kpg <= 4": [_SORT8],
            "chained accumulator": _CHAINED}
K4_VARIANTS = {"kernel": [], "no selection": [(_SELECT, _NO_SELECT)],
               "no selection, no decode": [(_SELECT, _NO_SELECT),
                                           _NO_DECODE],
               "chained accumulator": _CHAINED,
               "dpb at run time": [_RUNTIME_DPB]}
# The file a variant edits, where it is not csrc/tile_mma.cuh.
EDITED = {"dpb at run time": "pruned_codes.cu"}
KERNELS = {"k1": ("pruned_sq", "pruned_sq_score"),
           "k2": ("pruned_rows", "pruned_rows_score"),
           "k4": ("pruned_codes", "pruned_codes_score")}
# (d, kpg) of the bench-shaped plan and the accuracy widths of each kernel.
BENCH = {"k1": (100, 4), "k2": (128, 8), "k4": (100, 8)}
WIDTHS = {"k1": (100, 384, 768), "k2": (128, 256, 384),
          "k4": (100, 384, 768)}


def run_kernel(lib, kernel, case, kpg, measure_l2, out):
    """One launch of a built K1 / K2 / K4 library on ``case`` into
    ``out``."""
    plan, qg, rows, scale, bias = case
    g_pad, w_pad = plan.qg_query.shape[0], plan.work_tile.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    mult = ctypes.c_float(2.0 if measure_l2 else 1.0)
    common = (plan.work_tile.data_ptr(), plan.work_active.data_ptr(),
              qg.data_ptr(), rows.data_ptr())
    if kernel == "k4":
        cb, mean = scale
        b_pad = rows.shape[-1]
        err = lib.pruned_codes_score(
            *common, cb.data_ptr(), mean.data_ptr(), bias.data_ptr(),
            out.data_ptr(), w_pad, w_pad // g_pad, kpg, b_pad,
            cb.shape[0] // b_pad, cb.shape[1], int(measure_l2), stream)
        if err:
            raise RuntimeError(f"{kernel} launch failed ({err})")
        return
    tail = (out.data_ptr(), w_pad, w_pad // g_pad, kpg, rows.shape[-1], mult,
            stream)
    if kernel == "k1":
        err = lib.pruned_sq_score(*common, scale.data_ptr(), bias.data_ptr(),
                                  *tail)
    else:
        err = lib.pruned_rows_score(*common, bias.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"{kernel} launch failed ({err})")


def qg_width(case) -> int:
    """d_pad of a case (the query groups' width)."""
    return case[1].shape[-1]


def _time(lib, kernel, case, kpg, out):
    """Median of 10 CUDA-event timings of one launch, in ms."""
    times = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run_kernel(lib, kernel, case, kpg, False, out)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _rounds(libs, kernel, case, kpg):
    """5 rounds over ``libs`` in turn on ``case``: {name: [ms a round]}
    and the case's active items."""
    plan = case[0]
    mnt = plan.work_tile.shape[0] // plan.qg_query.shape[0]
    seg = kpg * case[2].shape[1] // ps.SUBP
    out = torch.empty((plan.qg_query.shape[0], ps.QG, mnt * seg),
                      dtype=torch.int32, device="cuda")
    for lib in libs.values():
        run_kernel(lib, kernel, case, kpg, False, out)
    torch.cuda.synchronize()
    rounds = {name: [] for name in libs}
    for _ in range(5):
        for name, lib in libs.items():
            rounds[name].append(_time(lib, kernel, case, kpg, out))
    return rounds, int(plan.work_active.sum())


def _line(rounds) -> str:
    return ", ".join(f"{n} {float(np.median(t)):.3f} ms [{min(t):.3f}-"
                     f"{max(t):.3f}]" for n, t in rounds.items())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tile_breakdown needs a CUDA card")
    print(torch.cuda.get_device_name(0))
    raw_cases = dict(tile_cases.RAW_CASES)
    with tempfile.TemporaryDirectory() as tmp:
        for kernel, (lib_name, fn) in KERNELS.items():
            variants = K4_VARIANTS if kernel == "k4" else VARIANTS
            libs = {v: build_variant(tmp, v, lib_name, fn,
                                     EDITED.get(v, "tile_mma.cuh"), e)
                    for v, e in variants.items()}
            d, kpg = BENCH[kernel]
            case = tile_cases.synthetic_case(
                kernel, d, unit=True, measure_l2=False, nq=10_000, nl=2000,
                leaves=100)
            rounds, active = _rounds(libs, kernel, case, kpg)
            ms = {n: float(np.median(t)) for n, t in rounds.items()}
            split = f"; selection {ms['kernel'] - ms['no selection']:.3f} ms"
            if kernel == "k4":
                rest = ms["no selection, no decode"]
                split += (f", decode {ms['no selection'] - rest:.3f} ms, "
                          f"copies and product {rest:.3f} ms")
            print(f"{kernel} time at d_pad {qg_width(case)}, kpg {kpg}, "
                  f"{active} active items: {_line(rounds)}{split}")
            if kernel == "k4":
                del case
                case = tile_cases.synthetic_case(
                    kernel, d, unit=True, measure_l2=False, nq=10_000,
                    nl=2000, leaves=100, cpb=256, dpb=4)
                rounds, active = _rounds(
                    {v: libs[v] for v in ("kernel", "dpb at run time")},
                    kernel, case, kpg)
                print(f"{kernel} time at 256 centers, 4 dimensions a block, "
                      f"d_pad {qg_width(case)}, kpg {kpg}, {active} active "
                      f"items: {_line(rounds)}")
            del case
            for d in WIDTHS[kernel]:
                for unit in (False, True):
                    for measure_l2 in (False, True):
                        kpg = 8
                        case = tile_cases.synthetic_case(
                            kernel, d, unit=unit, measure_l2=measure_l2,
                            seed=d + unit)
                        want = tile_cases.plain(kernel, case, kpg, measure_l2)
                        got = {}
                        for name in ("kernel", "chained accumulator"):
                            got[name] = torch.empty_like(want)
                            run_kernel(libs[name], kernel, case, kpg,
                                       measure_l2, got[name])
                        torch.cuda.synchronize()
                        line = {n: float(tile_cases.exact_excess(
                                    case, o, kpg, measure_l2).max())
                                for n, o in (("kernel", got["kernel"]),
                                             ("chained", got[
                                                 "chained accumulator"]),
                                             ("plain", want))}
                        line["kernel vs plain"] = float(tile_cases.pair_excess(
                            case, got["kernel"], want).max())
                        verdict = ""
                        if not unit and raw_cases.get(kernel) == d:
                            bar = tile_cases.RAW_EXCESS_RATIO * line["plain"]
                            verdict = "; within %g x plain: %s" % (
                                tile_cases.RAW_EXCESS_RATIO, ", ".join(
                                    f"{n} {'yes' if line[n] <= bar else 'no'}"
                                    for n in ("kernel", "chained")))
                        print(f"{kernel} accuracy d {d} "
                              f"{'unit' if unit else 'raw'} "
                              f"{'l2' if measure_l2 else 'dot'} kpg {kpg}: "
                              + ", ".join(f"{n} {v:.3g}"
                                          for n, v in line.items())
                              + verdict)
                        del case, want, got


if __name__ == "__main__":
    main()
