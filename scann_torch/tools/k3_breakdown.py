"""Where K3's time goes, on one CUDA card.

    python3 -m scann_torch.tools.k3_breakdown

K3 is two kernels of csrc/pruned_lut.cu: the pre-pass that builds each
query's int8 LUT once (pruned_lut_build) and the scorer that streams the
LUTs and the codes through shared memory (pruned_lut_score).  This builds
the source as it is and a variant of it compiled from an edited copy:
the scorer without the survivor selection (scores are computed but only
a token of them is kept).  Each runs on a synthetic plan shaped like the
benchmark's at leaves=100 (10,000 queries, 100 of 2000 leaves of one or
two 512-slot tiles) at 50 code blocks (b_pad 56, the benchmark's two
dimensions a block) and at 480 (GIST-960), at 8 and 16 survivors a group.
The full kernels must equal the plain version bit for bit; the variant's
output is not meaningful.  Prints one line per (b_pad, kpg, part): the
median of 10 CUDA-event timings of the LUT pre-pass, of the scorer and of
the scorer without the selection, and the difference as the cost of the
selection.  The variant's source and library go to a temporary directory.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile

import numpy as np
import torch

from scann_torch import _cuda
from scann_torch.ops import pruned_lut as pl
from scann_torch.ops import pruned_scan as ps
from scann_torch.tools.variants import build_variant

_SELECT = "survivors::quad_top_kpg(pv, kpg, kWarps, tq == 0, [&](int r) {"
_NO_SELECT = ("if (pv[0][0] == 1234.5f && pv[7][7] == 2.f) stage_s[0] = 1; "
              "if (0) " + _SELECT)
VARIANTS = {"scorer": [], "scorer, no selection": [(_SELECT, _NO_SELECT)]}


def bench_like_inputs(seed: int = 0, nq: int = 10_000, nl: int = 2000,
                      leaves: int = 100, blocks: int = 50, dpb: int = 2):
    """(plan, q_rows, codes3p, cb_k, csq, bias) on the card: q_rows the
    batch's (nq, b_pad * dpb) bf16 queries, as score_work_lut takes
    them."""
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
    return (plan, t(q).to(torch.bfloat16),
            t(pl.pack_codes_nibble(codes, num_tiles)), cb_k, csq,
            t(bias.astype(np.float32)))


def _median_ms(run) -> float:
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def breakdown(blocks: int, libs) -> None:
    """Times K3's parts at ``blocks`` code blocks, 8 and 16 survivors."""
    plan, q, codes3p, cb_k, csq, bias = bench_like_inputs(blocks=blocks)
    g_pad, w_pad = plan.qg_query.shape[0], plan.work_tile.shape[0]
    mnt, b_pad = w_pad // g_pad, codes3p.shape[-1] * 2
    nq, dpb = q.shape[0], cb_k.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    print(f"b_pad {b_pad}; plan: {g_pad} groups, "
          f"{int(plan.work_active.sum())} active items of {w_pad}")
    lut = torch.empty((nq, b_pad * 16), dtype=torch.int8, device="cuda")
    inv = torch.empty((nq,), dtype=torch.float32, device="cuda")
    build = _cuda.library("pruned_lut").pruned_lut_build

    def run_build():
        err = build(q.data_ptr(), cb_k.data_ptr(), csq.data_ptr(),
                    lut.data_ptr(), inv.data_ptr(), nq, b_pad, dpb,
                    b_pad * dpb, ctypes.c_float(1.0), stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")

    lut_ms = _median_ms(run_build)
    print(f"b_pad {b_pad}, LUT pre-pass: {lut_ms:.3f} ms")
    for kpg in (8, 16):
        want = pl.score_work_torch_lut(plan, q[plan.qg_query.long()],
                                       codes3p, cb_k, csq, bias,
                                       measure_l2=False, kpg=kpg)
        ms = {}
        for name, lib in libs.items():
            out = torch.empty((g_pad, ps.QG, mnt * kpg * ps.GP),
                              dtype=torch.int32, device="cuda")

            def run():
                err = lib.pruned_lut_score(
                    plan.work_tile.data_ptr(), plan.work_active.data_ptr(),
                    plan.qg_query.data_ptr(), lut.data_ptr(),
                    inv.data_ptr(), codes3p.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), g_pad, mnt, kpg, b_pad, stream)
                if err:
                    raise RuntimeError(f"launch failed ({err})")

            ms[name] = _median_ms(run)
            if name == "scorer":
                act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool()
                act = act.expand(g_pad, ps.QG, mnt, kpg * ps.GP)
                if not torch.equal(out.reshape(act.shape)[act],
                                   want.reshape(act.shape)[act]):
                    raise AssertionError("K3 differs from its plain "
                                         "version")
            print(f"b_pad {b_pad}, kpg {kpg}, {name}: {ms[name]:.3f} ms")
        print(f"b_pad {b_pad}, kpg {kpg}: LUT pre-pass {lut_ms:.3f} ms, "
              f"product, staging and copies "
              f"{ms['scorer, no selection']:.3f} ms, selection "
              f"{ms['scorer'] - ms['scorer, no selection']:.3f} ms, "
              f"K3 {lut_ms + ms['scorer']:.3f} ms")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k3_breakdown needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {n: build_variant(tmp, n, "pruned_lut", "pruned_lut_score",
                                 "pruned_lut.cu", e)
                for n, e in VARIANTS.items()}
        for blocks in (50, 480):
            breakdown(blocks, libs)


if __name__ == "__main__":
    main()
