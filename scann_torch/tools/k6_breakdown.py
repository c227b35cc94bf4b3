"""Where K6's time goes (csrc/merge_groups.cu, the fused merge), on one
CUDA card.

    python3 -m scann_torch.tools.k6_breakdown

Builds csrc/merge_groups.cu as it is and from edited copies of it:
  * "1 row a warp" and "4 rows a warp": the direct kernels (rows of up to
    256 columns) interleave that many rows a warp, where the kernel takes
    2;
  * "no passes": the direct kernels read, key and sort the rows and write
    each lane's head entry but run no selection pass, so the difference
    to the kernel is the k passes.
Each runs on two synthetic packed blocks shaped like the benchmark's at
leaves=100 (9,813 groups of 128 rows: tree-AH's 2 tiles x 8 survivors x
16 groups, w 256, k 30; tree-SQ's 4 tiles x 4 survivors x 8 groups, w 128,
k 10), with standard-normal scores, identities as a scorer packs them and
each group's tile count drawn from 1 to its tiles: 5 rounds over the
variants in turn, each round the median of 10 CUDA-event timings; the line
gives the median of the rounds and their range.  The kernel and the row
variants must equal the plain version bit for bit; the "no passes"
output is not meaningful.  The variants' sources and libraries go to a
temporary directory.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from scann_torch.ops import pruned_scan as ps
from scann_torch.tools.variants import build_variant

_ROWS = "constexpr int kDirectRows = 2;"
_PASSES = "  uint32_t om[R], ot[R];\n  for (int p = 0; p < k; ++p) {"
# No pass runs; each lane writes its head entry, so the rows are still
# read, keyed and sorted.
_NO_PASSES = ("  uint32_t om[R], ot[R];\n"
              "  for (int r = 0; r < R; ++r) {\n"
              "    om[r] = st[r].img[0] ^ st[r].fb_img;\n"
              "    ot[r] = static_cast<uint32_t>(st[r].tl) ^ st[r].fb_t;\n"
              "  }\n"
              "  for (int p = 0; p < 0; ++p) {")
VARIANTS = {"kernel": [],
            "1 row a warp": [(_ROWS, _ROWS.replace("2;", "1;"))],
            "4 rows a warp": [(_ROWS, _ROWS.replace("2;", "4;"))],
            "no passes": [(_PASSES, _NO_PASSES)]}
# (tile, survivors a group, tiles a leaf, k) of the two blocks.
BLOCKS = {"tree-AH": (512, 8, 2, 30), "tree-SQ": (256, 4, 4, 10)}


def packed_block(r, tile, kpg, mnt, g_pad=9813):
    """(packed (g_pad, 128, w) int32, qg_nt, kgp) on the card."""
    gp = tile // ps.SUBP
    kgp = kpg * gp
    w = mnt * kgp
    scores = r.standard_normal((g_pad, ps.QG, w)).astype(np.float32)
    first = r.integers(0, ps.SUBP, (g_pad, ps.QG, mnt, 1, gp))
    arg = (first + np.arange(kpg)[None, None, None, :, None]) % ps.SUBP
    ident = ((np.arange(w) // kgp) << 5)[None, None, :] | arg.reshape(
        g_pad, ps.QG, w)
    packed = ((scores.view(np.int32) & ~511) | ident).astype(np.int32)
    nt = r.integers(1, mnt + 1, g_pad).astype(np.int32)
    return (torch.as_tensor(packed, device="cuda"),
            torch.as_tensor(nt, device="cuda"), kgp)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k6_breakdown needs a CUDA card")
    print(torch.cuda.get_device_name(0))
    r = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {v: build_variant(tmp, v, "merge_groups", "merge_groups_topk",
                                 "merge_groups.cu", e)
                for v, e in VARIANTS.items()}
        for name, (tile, kpg, mnt, k) in BLOCKS.items():
            packed, nt, kgp = packed_block(r, tile, kpg, mnt)
            g_pad, _, w = packed.shape
            outs = [torch.empty((g_pad, ps.QG, k), dtype=torch.int32,
                                device="cuda") for _ in range(2)]
            want = ps.merge_groups_torch(packed, nt, kgp=kgp, tile=tile, k=k)

            def run(lib):
                err = lib.merge_groups_topk(
                    packed.data_ptr(), nt.data_ptr(), outs[0].data_ptr(),
                    outs[1].data_ptr(), g_pad, w, k,
                    (tile // ps.SUBP).bit_length() - 1,
                    kgp.bit_length() - 1,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"K6 launch failed ({err})")

            for v, lib in libs.items():
                run(lib)
                torch.cuda.synchronize()
                same = all(torch.equal(o, x) for o, x in zip(outs, want))
                if v != "no passes" and not same:
                    raise AssertionError(f"{v} differs from the plain "
                                         f"version on the {name} block")
            rounds = {v: [] for v in libs}
            for _ in range(5):
                for v, lib in libs.items():
                    times = []
                    for _ in range(10):
                        a = torch.cuda.Event(enable_timing=True)
                        b = torch.cuda.Event(enable_timing=True)
                        a.record()
                        run(lib)
                        b.record()
                        b.synchronize()
                        times.append(a.elapsed_time(b))
                    rounds[v].append(float(np.median(times)))
            ms = {v: float(np.median(t)) for v, t in rounds.items()}
            print(f"K6 {name} block ({g_pad} x {ps.QG} x {w}, k {k}): "
                  + ", ".join(f"{v} {ms[v]:.3f} ms [{min(t):.3f}-"
                              f"{max(t):.3f}]" for v, t in rounds.items())
                  + f"; passes {ms['kernel'] - ms['no passes']:.3f} ms")
            del packed, outs, want


if __name__ == "__main__":
    main()
