"""K1 and K2 (the tile x query-group scorers of csrc/tile_mma.cuh) on one
CUDA card: where their time goes, and how close their sums come to float64.

    python3 -m scann_torch.tools.tile_breakdown

Builds csrc/pruned_sq.cu and csrc/pruned_rows.cu as they are and from
edited copies of csrc/tile_mma.cuh:
  * "no selection": scores are computed but only a token of them is kept
    (the survivors' copy-out still runs), so the difference to the kernel
    is the survivor selection;
  * "sort 8 at kpg <= 4": the selection sorts all 8 values of a lane at
    every kpg, where the kernel keeps only the top 4 for kpg <= 4 (K1's
    main path); at K2's kpg 8 the two are the same code, which shows the
    spread of the timing;
  * "chained accumulator": every mma adds into the running sum inside the
    tensor core, where the kernel starts each mma from zero and adds its
    partial with a rounded f32 add.
Time: each variant on a synthetic plan shaped like the benchmark's at
leaves=100 (10,000 queries, 100 of 2000 leaves; tree-SQ: leaves of 1-4
256-slot tiles, d_pad 104, kpg 4; reconstruct: leaves of 1-2 512-slot
tiles, d_pad 128, kpg 8): 5 rounds over the variants in turn, each round
the median of 10 CUDA-event timings; the line gives the median of the
rounds and their range.
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
VARIANTS = {"kernel": [], "no selection": [(_SELECT, _NO_SELECT)],
            "sort 8 at kpg <= 4": [_SORT8],
            "chained accumulator": _CHAINED}
KERNELS = {"k1": ("pruned_sq", "pruned_sq_score"),
           "k2": ("pruned_rows", "pruned_rows_score")}


def run_kernel(lib, kernel, case, kpg, measure_l2, out):
    """One launch of a built K1 / K2 library on ``case`` into ``out``."""
    plan, qg, rows, scale, bias = case
    g_pad, w_pad = plan.qg_query.shape[0], plan.work_tile.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    mult = ctypes.c_float(2.0 if measure_l2 else 1.0)
    common = (plan.work_tile.data_ptr(), plan.work_active.data_ptr(),
              qg.data_ptr(), rows.data_ptr())
    tail = (out.data_ptr(), w_pad, w_pad // g_pad, kpg, rows.shape[-1], mult,
            stream)
    if kernel == "k1":
        err = lib.pruned_sq_score(*common, scale.data_ptr(), bias.data_ptr(),
                                  *tail)
    else:
        err = lib.pruned_rows_score(*common, bias.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"{kernel} launch failed ({err})")


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tile_breakdown needs a CUDA card")
    print(torch.cuda.get_device_name(0))
    raw_cases = dict(tile_cases.RAW_CASES)
    with tempfile.TemporaryDirectory() as tmp:
        for kernel, (lib_name, fn) in KERNELS.items():
            libs = {v: build_variant(tmp, v, lib_name, fn, "tile_mma.cuh", e)
                    for v, e in VARIANTS.items()}
            d, kpg = (100, 4) if kernel == "k1" else (128, 8)
            case = tile_cases.synthetic_case(
                kernel, d, unit=True, measure_l2=False, nq=10_000, nl=2000,
                leaves=100)
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
            ms = {n: float(np.median(t)) for n, t in rounds.items()}
            print(f"{kernel} time at d_pad {case[2].shape[-1]}, kpg {kpg}, "
                  f"{int(plan.work_active.sum())} active items: "
                  + ", ".join(f"{n} {ms[n]:.3f} ms [{min(t):.3f}-"
                              f"{max(t):.3f}]" for n, t in rounds.items())
                  + f"; selection {ms['kernel'] - ms['no selection']:.3f} ms")
            del case, out
            widths = (100, 384, 768) if kernel == "k1" else (128, 256, 384)
            for d in widths:
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
