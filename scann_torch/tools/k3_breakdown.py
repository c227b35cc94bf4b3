"""Where K3's time goes, on one CUDA card.

    python3 -m scann_torch.tools.k3_breakdown

Builds csrc/pruned_lut.cu as it is and two variants of it compiled from
edited copies of the source: without the survivor selection (scores are
computed but only a token of them is kept) and, in addition, without the
LUT build (the product runs on whatever the shared memory holds).  Each
runs on a synthetic plan shaped like the benchmark's at leaves=100 (10,000
queries, 100 of 2000 leaves of one or two 512-slot tiles, 50 code blocks at
two dimensions per block) at 8 and 16 survivors a group.  The full kernel
must equal the plain version bit for bit; the variants' output is not
meaningful.  Prints one line per (kpg, variant): the median of 10
CUDA-event timings, and the differences as the cost of the selection and
of the LUT build.  The variants' sources and libraries go to a temporary
directory.
"""

from __future__ import annotations

import ctypes
import tempfile

import numpy as np
import torch

from scann_torch.ops import pruned_lut as pl
from scann_torch.ops import pruned_scan as ps
from scann_torch.tools.variants import build_variant

_SELECT = "survivors::quad_top_kpg(pv, kpg, kWarps, tq == 0, [&](int r) {"
_NO_SELECT = ("if (pv[0][0] == 1234.5f && pv[7][7] == 2.f) stage_s[0] = 1; "
              "if (0) " + _SELECT)
_NO_LUT = [("  if (dpb == 2)\n    build_lut<2>", "  if (0)\n    build_lut<2>"),
           ("  else\n    build_lut<0>", "  else if (0)\n    build_lut<0>")]
VARIANTS = {"kernel": [], "no selection": [(_SELECT, _NO_SELECT)],
            "no selection, no LUT build": [(_SELECT, _NO_SELECT), *_NO_LUT]}


def bench_like_inputs(seed: int = 0, nq: int = 10_000, nl: int = 2000,
                      leaves: int = 100, blocks: int = 50, dpb: int = 2):
    """(plan, qg_rows, codes3p, cb_k, csq, bias) on the card."""
    r = np.random.default_rng(seed)
    b_pad = -(-blocks // 8) * 8
    ntiles = np.where(r.random(nl) < 0.88, 2, 1).astype(np.int32)
    tile_start = np.concatenate([[0], np.cumsum(ntiles)[:-1]]).astype(
        np.int32)
    num_tiles = int(ntiles.sum())
    sel = np.argsort(r.random((nq, nl)), axis=1)[:, :leaves].astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device="cuda")

    g_pad, w_pad = ps.plan_capacities(nq, leaves, nl, num_tiles, 2)
    plan = ps.invert(t(sel), t(np.ones((nq, leaves), bool)), t(tile_start),
                     t(ntiles), 2, g_pad, w_pad)
    codes = r.integers(0, 16, (num_tiles * ps.TILE, blocks)).astype(np.uint8)
    bias = np.where(r.random((num_tiles, ps.TILE, 1)) < 0.1, -1e30, 0.0)
    cb = t((0.3 * r.standard_normal((blocks, 16, dpb))).astype(np.float32))
    cb_k, csq = pl.lut_tables(cb, torch.zeros(b_pad * dpb, device="cuda"),
                              b_pad, measure_l2=False)
    q = np.zeros((nq, b_pad * dpb), np.float32)
    q[:, :blocks * dpb] = r.standard_normal((nq, blocks * dpb))
    qg = t(q).to(torch.bfloat16)[plan.qg_query.long()]
    return (plan, qg, t(pl.pack_codes_nibble(codes, num_tiles)), cb_k, csq,
            t(bias.astype(np.float32)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k3_breakdown needs a CUDA card")
    plan, qg, codes3p, cb_k, csq, bias = bench_like_inputs()
    g_pad, w_pad = plan.qg_query.shape[0], plan.work_tile.shape[0]
    mnt, b_pad = w_pad // g_pad, codes3p.shape[-1] * 2
    dpb = cb_k.shape[1]
    print(f"{torch.cuda.get_device_name(0)}; plan: {g_pad} groups, "
          f"{int(plan.work_active.sum())} active items of {w_pad}")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {n: build_variant(tmp, n, "pruned_lut", "pruned_lut_score",
                                 "pruned_lut.cu", e)
                for n, e in VARIANTS.items()}
        for kpg in (8, 16):
            want = pl.score_work_torch_lut(plan, qg, codes3p, cb_k, csq,
                                           bias, measure_l2=False, kpg=kpg)
            ms = {}
            for name, lib in libs.items():
                out = torch.empty((g_pad, ps.QG, mnt * kpg * ps.GP),
                                  dtype=torch.int32, device="cuda")

                def run():
                    err = lib.pruned_lut_score(
                        plan.work_tile.data_ptr(),
                        plan.work_active.data_ptr(), qg.data_ptr(),
                        codes3p.data_ptr(), cb_k.data_ptr(), csq.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), g_pad, mnt, kpg,
                        b_pad, dpb, b_pad * dpb, ctypes.c_float(1.0),
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed ({err})")

                run()
                torch.cuda.synchronize()
                if name == "kernel":
                    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool()
                    act = act.expand(g_pad, ps.QG, mnt, kpg * ps.GP)
                    if not torch.equal(out.reshape(act.shape)[act],
                                       want.reshape(act.shape)[act]):
                        raise AssertionError("K3 differs from its plain "
                                             "version")
                times = []
                for _ in range(10):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    run()
                    b.record()
                    b.synchronize()
                    times.append(a.elapsed_time(b))
                ms[name] = float(np.median(times))
                print(f"kpg {kpg}, {name}: {ms[name]:.3f} ms")
            base = ms["no selection, no LUT build"]
            print(f"kpg {kpg}: product, staging and copies {base:.3f} ms, "
                  f"LUT build {ms['no selection'] - base:.3f} ms, "
                  f"selection {ms['kernel'] - ms['no selection']:.3f} ms")


if __name__ == "__main__":
    main()
