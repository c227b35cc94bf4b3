"""The selection kernel (csrc/pruned_merge.cu, the merge stage) against its
plain version and its byte bound, on one CUDA card.

    python3 -m scann_torch.tools.merge_breakdown

Three synthetic merges shaped like the benchmark's cells (``SHAPES``):
10,000 queries over 2,000 leaves of 1 to ``mnt`` tiles (one leaf of
``mnt``), each query's ``l`` leaves distinct and 5% of its pairs invalid,
the plan built on the card (``pruned_scan.plan_batch``), standard-normal
scores packed with identities as a scorer packs them (the kpg survivors of
one tile and group distinct slots), padded slots (id -1) a tenth of the
layout.  Each line: the kernel's ms (median of 20 CUDA-event timings
after 3 warm-ups) and the plain version's (``merge_ids_torch`` on the
card, the merge before the kernel: median of 5), the bytes the merge
needs (every live survivor it reads once: the hot pairs' live tiles, a
gp-word slice of each live tile of the cold pairs; each pair's five
operands and its bias; the winners' ids and outputs) over 3.35 TB/s, the
share of that bound the kernel reaches, whether the two agree bit for
bit, and the kernel's occupancy (registers, dynamic shared memory a
block, blocks an SM).  ``merge_case`` builds the operands;
tests/test_torch_cuda_merge.py builds its cases with it.

The operands are synthetic: their tile counts, scores and dead slots are
drawn, not the cells' indexes', so the times are the kernel's at these
shapes and not the cells'.  chip_smoke.py's merge check times the kernel
on the operands of real indexes at the cells' search points.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from scann_torch.ops import pruned_scan as ps

_HBM_BYTES_S = 3.35e12
# name: (queries, leaves a query, tiles a leaf at most, tile, survivors a
# group, k_fetch, pair bias, squared-L2 restore)
SHAPES = {
    "glove100-ah": (10_000, 100, 2, 512, 8, 100, True, False),
    "glove100-soar": (10_000, 40, 4, 512, 8, 300, True, False),
    "sift1m-sq": (10_000, 8, 4, 256, 4, 40, False, True),
}


def merge_case(seed, b, l, mnt, tile, kpg, *, num_leaves=2000, bias=True,
               l2=False, p_invalid=0.05, coarse=False, p_dead=0.0,
               device="cuda"):
    """Operands of one merge: (args, kwargs) of
    ``pruned_scan.select_merge`` / ``merge_ids_torch``.  ``coarse`` draws
    the scores from 16 values (ties across hot and cold columns);
    ``p_dead`` sets that share of the scores to the pad penalty (an
    allowlist that kills most slots); invalid pairs' leaf ids are -1 half
    the time; inactive work items hold NaN garbage."""
    g = torch.Generator(device=device).manual_seed(seed)
    dev = torch.device(device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    nl = num_leaves
    ntiles = (rand(nl) * mnt).to(torch.int32).clamp(0, mnt - 1) + 1
    ntiles[0] = mnt
    tile_start = (torch.cumsum(ntiles, 0) - ntiles).to(torch.int32)
    num_tiles = int(ntiles.sum())
    slots = num_tiles * tile
    dpid = torch.randperm(slots, generator=g, device=dev).to(torch.int32)
    dpid = torch.where(rand(slots) < 0.1, -1, dpid)
    layout = ps.PrunedLayout(tile_start, ntiles, mnt, num_tiles, dpid,
                             torch.zeros((num_tiles, tile, 1), device=dev),
                             tile)
    sel = rand(b, nl).argsort(1)[:, :l].to(torch.int32).contiguous()
    valid = rand(b, l) >= p_invalid
    sel = torch.where(~valid & (rand(b, l) < 0.5), -1, sel)
    plan, _, hot = ps.plan_batch(layout, sel, valid)
    g_pad = plan.qg_query.shape[0]
    gp = tile // ps.SUBP
    kgp = kpg * gp
    w = mnt * kgp
    if coarse:
        scores = (rand(g_pad, ps.QG, w) * 16).floor() * 0.25 - 2.0
    else:
        scores = torch.randn((g_pad, ps.QG, w), generator=g, device=dev)
    scores = torch.where(rand(g_pad, ps.QG, w) < p_dead,
                         ps._PAD_PENALTY, scores)
    first = (rand(g_pad, ps.QG, mnt, 1, gp) * ps.SUBP).to(torch.int32)
    arg = (first + torch.arange(kpg, dtype=torch.int32, device=dev)[
        None, None, None, :, None]) % ps.SUBP
    ident = ((torch.arange(w, dtype=torch.int32, device=dev) // kgp) << 5
             ) | arg.reshape(g_pad, ps.QG, w)
    packed = (scores.view(torch.int32) & ~511) | ident
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, ps.QG, mnt, kgp).reshape(g_pad, ps.QG, w)
    nan = torch.tensor(float("nan"), device=dev).view(torch.int32)
    packed = torch.where(act, packed, nan).contiguous()
    del scores, first, arg, ident, act
    pair_bias = torch.randn((b, l), generator=g, device=dev) if bias else None
    q_norm = rand(b) * 2 if l2 else None
    args = (packed, plan.work_active, plan.pair_gid, plan.pair_row, sel,
            valid, tile_start, ntiles, dpid, pair_bias, q_norm)
    return args, dict(max_ntiles=mnt, hot=hot, tile=tile)


def bound_bytes(args, kw, k_fetch: int) -> int:
    """Bytes the merge needs: each live survivor read once (hot pairs'
    live tiles, gp words of each live tile of cold pairs), each pair's
    leaf id, validity, group, row, tile count and bias, each result's
    id lookup and its outputs (value and id)."""
    packed, _, _, _, sel, valid, _, ntiles, _, pair_bias, q_norm = args
    b, l = sel.shape
    mnt, hot, tile = kw["max_ntiles"], min(kw["hot"], l), kw["tile"]
    kgp, gp = packed.shape[-1] // mnt, tile // ps.SUBP
    nt = torch.where(valid, ntiles[sel.clamp_min(0).long()], 0).long()
    words = int(nt[:, :hot].sum()) * kgp + int(nt[:, hot:].sum()) * gp
    k = min(k_fetch, ps.merge_width(l, hot, mnt, kgp, gp))
    per_pair = 4 + 1 + 4 + 4 + 4 + (4 if pair_bias is not None else 0)
    return (4 * words + b * l * per_pair + (4 * b if q_norm is not None
                                            else 0) + b * k * (4 + 8))


def _ms(fn, reps: int, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return float(np.median(times))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("merge_breakdown needs a CUDA card")
    from scann_torch import _cuda
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    for seed, (name, shape) in enumerate(SHAPES.items()):
        b, l, mnt, tile, kpg, k, bias, l2 = shape
        args, kw = merge_case(seed, b, l, mnt, tile, kpg, bias=bias, l2=l2)
        got = ps.select_merge(*args, k_fetch=k, **kw)
        want = ps.merge_ids_torch(*args, k_fetch=k, **kw)
        equal = bool(torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1]))
        ms = _ms(lambda: ps.select_merge(*args, k_fetch=k, **kw), 20)
        plain_ms = _ms(lambda: ps.merge_ids_torch(*args, k_fetch=k, **kw), 5,
                       warm=1)
        nbytes = bound_bytes(args, kw, k)
        bound_ms = nbytes / _HBM_BYTES_S * 1e3
        kgp = args[0].shape[-1] // mnt
        n = ps.merge_width(l, kw["hot"], mnt, kgp, tile // ps.SUBP)
        print(json.dumps({
            "shape": name, "queries": b, "leaves": l, "hot": kw["hot"],
            "max_ntiles": mnt, "kgp": kgp, "n": n, "k": min(k, n),
            "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
            "bound_ms": round(bound_ms, 4), "bound_bytes": nbytes,
            "roofline_pct": round(100 * bound_ms / ms, 2),
            "bit_equal": equal,
            "occupancy": _cuda.occupancy("pruned_merge", n, min(k, n))}))
        del args, got, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
