#!/usr/bin/env python3
"""Drive the scann_torch port end to end on one CUDA card.

    python3 chip_smoke.py

Phases (any failure is an uncaught exception and a non-zero exit):
  1. card: name, power limit, TF32 off;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. main-path index: the benchmark corpus (bench.py's make_glove_like at
     1,183,514 x 100, 10,000 queries; copied here, this script imports
     neither JAX nor the JAX package) built with the port's tree-SQ
     builder at bench.py's config (2000 leaves, 100 to search, 250,000
     training samples, int8), and exact float32 brute-force ground truth;
  4. kernel phase: every kernel of the path against its plain torch
     version on the inputs the main path gives it, with timings and the
     card's bound for the same work; K1 also at d_pad 384 and 768 on
     synthetic plans (scann_torch/tools/tile_cases.synthetic_case: a
     few hundred active items at the scale of an index of unit vectors,
     dot and squared L2, 4 and 8 survivors a group), held to the same bar
     against its plain version and against float64, and at d_pad 768 on
     raw-scale data, where its float64 excess is held to 1.5 times the
     plain version's (tile_cases.RAW_EXCESS_RATIO);
  5. main path: search_batched over all queries at leaves 50, 80, 100, 150
     and the full scan with recall@10, QPS and per-stage times, and a
     16-query cross-check of the CUDA path against the CPU plain path on
     the same (serialized) index;
  6. tree-AH (bench.py's tree + AH + reorder config on the same corpus:
     score_ah(2, anisotropic threshold 0.2), reorder(100)): three builds
     (int8 lookup with float32 reorder, the same with residual-int8
     reorder, float32 lookup); K3 and K4 against their plain versions at
     the main path's inputs (dot and squared L2, 8 and 16 survivors per
     group, K4 also with 256 centers per block on a small index) with
     timings and bounds; K4 also at d_pad 256, 384 and 768 (16 centers x
     2 dimensions a block and 256 x 4, 8 and 16 survivors, dot and squared
     L2) on synthetic plans as K1, and at d_pad 768 on raw-scale data;
     the sweep leaves 50 / 100 / 150 x pre-reorder
     100 / 250 on both reorder types (every point must launch K3), one
     float32-lookup point (must launch K4), the dense LUT16 scan (full
     scan) over all queries, the CUDA-vs-CPU cross-check, and a 200-dim
     float32-lookup index (d_pad 208, past the 144 K4 once served) that
     must launch K4 and agree with the CPU plain path;
  7. tree-AH in reconstruct mode (the same config with
     asymmetric_hash.lookup_type = "reconstruct", float32 reorder rows):
     build, the CUDA-vs-CPU cross-check on its own serialization; K2
     against its plain version at the main path's inputs (dot and squared
     L2, 8 and 16 survivors per group; and at d_pad 256 and 384 on
     synthetic plans as K1, raw scale at 384) and K5 against its chunked plain
     version on all 10,000 queries (dot and squared L2), timed beside the
     bf16 torch.matmul + amax / argmax composition; the sweep leaves 50 /
     100 / 150 with 100 pre-reorder candidates (every point must launch
     K2) and the full scan (must launch K5); and the same scorer with no
     tree (score_ah + reorder alone), whose every search is a K5 scan;
  8. the fused merge: K6 against its plain version, bit for bit, on
     tree-SQ's packed block at leaves=100 (k 10, in phase 5), on tree-AH's
     (k 30, in phase 6) and on a synthetic block at the widest row a
     scorer writes (w 8192, k 32), and one search at leaves=100 on each
     engine with SCANN_TORCH_FUSED_MERGE off and on (on must launch K6 and
     lose no more than 0.002 of recall@10);
  9. the width guards: on the card a K3 width no survivor count serves
     and a no-tree reconstruct searcher over 384 dimensions whose
     searches are K5 scans raise NotImplementedError naming item 13
     before any training; then the
     occupancy line of the six kernels (registers a thread, dynamic shared
     memory a block, resident blocks an SM, at the main path's shapes), the
     kernels JSON line, the card line, and the final ok line.
Exits non-zero without CUDA, and in a directory without the scann_torch
package.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_DB, N_QUERY, DIM, K = 1_183_514, 10_000, 100, 10
NUM_LEAVES, LEAVES_TO_SEARCH, TRAIN_SAMPLE = 2000, 100, 250_000
SWEEP = (50, 80, 100, 150)
RECALL_FLOOR_AT_100 = 0.935
# tree-AH: leaves x pre-reorder sweep, and the recall@10 floor at leaves
# 100 with 100 pre-reorder candidates (float32 reorder): the first value
# measured on the card less 1 pt, the build-to-build spread.
AH_SWEEP = ((50, 100), (50, 250), (100, 100), (100, 250), (150, 100),
            (150, 250))
AH_REORDER = 100
AH_RECALL_FLOOR_AT_100 = 0.9472   # first card run: 0.9572
# Reconstruct mode: the same codes, tree and exact reorder, so the same
# floor at leaves 100 / 100 candidates; the full scan through K5 loses only
# group collisions (about k^2 * 256 / (2 S) of the 100 candidates), with a
# tree and without one (first card run without a tree: 0.9951).
RECON_SWEEP = (50, 100, 150)
RECON_FULL_SCAN_FLOOR = 0.985
FUSED_MERGE_PRE = 30            # tree-AH budget of the fused-merge points
FUSED_MERGE_MAX_RECALL_LOSS = 0.002
# Peaks of one H100 SXM (NVIDIA data sheet; dense tensor cores).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
# K1 vs plain version: unpacked values within 2^-14 relative (the 2^-15
# identity perturbation plus summation order; int8 x bf16 products are
# exact in f32) with a 1e-6 floor for sums that cancel to near zero, and
# packed identities equal on >= 99.9% of survivors.
K1_RTOL, K1_ATOL, K1_MIN_ID_AGREE = 2.0 ** -14, 1e-6, 0.999
# K3 vs plain version: packed survivors bit-equal (exact products, one
# rounded sum per LUT entry at two dimensions per block, exact integer
# sums).  K4 vs plain version: K1's bar, with a 1e-5 floor for squared-L2
# scores 2 dot - ||x||^2 that cancel to near zero.
K4_ATOL = 1e-5
# K2 vs plain version: K4's bar (bf16 x bf16 products at differing
# exponents, so the f32 sums depend on their order), identities equal on
# >= 99.99% of live survivors.  K5 vs plain version: values within 1e-5
# relative plus 1e-5 (exact products, f32 sums in another order), slot ids
# equal on >= 99.9% of groups, and where they differ the plain score of the
# kernel's slot within that tolerance of the plain maximum (a tie up to
# summation order).  K6 vs plain version: bit-equal.
K2_MIN_ID_AGREE = 0.9999
K5_RTOL, K5_ATOL, K5_MIN_ID_AGREE = 1e-5, 1e-5, 0.999
TIMING_REPS = 20
# The instruction of K1, K2 and K4 (csrc/tile_mma.cuh), for the kernels
# line.
TILE_MMA = "mma.sync m16n8k16 bf16 (csrc/tile_mma.cuh), 4-stage cp.async ring"
PLAIN_TIMING_REPS = 5

# The benchmark corpus: a verbatim copy of bench.make_glove_like (and its
# constants); tests/test_torch_isolation.py holds the two equal.
TOPICS_PER_ROW = 12
TOPIC_NOISE = 0.045


def make_glove_like(n, nq, d, seed=0):
    """Mixture of n/12 unit-sphere topics + per-dim noise 0.045,
    L2-normalized (angular)."""
    rng = np.random.default_rng(seed)
    n_topics = max(n // TOPICS_PER_ROW, 64)
    topics = rng.standard_normal((n_topics, d)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)

    def draw(m, seed2):
        r = np.random.default_rng(seed2)
        a = r.integers(0, n_topics, m)
        x = (topics[a]
             + TOPIC_NOISE * r.standard_normal((m, d)).astype(np.float32))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return x.astype(np.float32)

    return draw(n, seed + 1), draw(nq, seed + 2)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def recall_at_k(idx, truth):
    k = truth.shape[1]
    return sum(len(set(idx[i][:k]) & set(truth[i]))
               for i in range(len(truth))) / (len(truth) * k)


def time_ms(torch, fn, reps=TIMING_REPS):
    """Median CUDA-event time of fn() over reps runs after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


class StageTimer:
    """Searcher.stage_hook that records a CUDA event per stage mark and
    sums the device time between consecutive marks by stage name."""

    def __init__(self, torch):
        self.torch = torch
        self.marks = []

    def start(self):
        self.marks = [("start", self._event())]

    def _event(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def __call__(self, name):
        self.marks.append((name, self._event()))

    def stage_ms(self):
        self.torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def pruned_plan(torch, searcher, queries, leaves):
    """The work plan the main path builds for this batch."""
    from scann_torch.ops import pruned_scan
    part = searcher.partitioner
    nq = queries.shape[0]
    leaf_ids, _ = part.tokenize_queries(queries, leaves)
    valid = torch.ones((nq, leaves), dtype=torch.bool, device=queries.device)
    g_pad, w_pad = pruned_scan.plan_capacities(
        nq, leaves, part.num_leaves, searcher._p_num_tiles,
        searcher._p_max_ntiles)
    return pruned_scan.invert(leaf_ids, valid, searcher._p_tile_start,
                              searcher._p_ntiles, searcher._p_max_ntiles,
                              g_pad, w_pad)


def k1_inputs(torch, searcher, queries, leaves, measure_l2):
    """The exact K1 inputs the main path builds for this batch."""
    part = searcher.partitioner
    plan = pruned_plan(torch, searcher, queries, leaves)
    d_pad = searcher.slot_rows.shape[-1]
    q_bf = torch.nn.functional.pad(
        queries, (0, d_pad - queries.shape[1])).to(torch.bfloat16)
    qg_rows = q_bf[plan.qg_query.long()]
    bias = searcher._bias2
    if measure_l2:
        # Squared-L2 bias plane of the same index: -||x_hat||^2 per slot.
        rows = searcher.slot_rows.float() * searcher.slot_scale
        centers = torch.nn.functional.pad(
            part.centers, (0, d_pad - part.centers.shape[1]))
        c = centers[searcher.slot_leaf.long()].reshape(rows.shape)
        sq = ((rows + c) ** 2).sum(-1, keepdim=True)
        bias = torch.where(bias > -1e20, -sq, bias).contiguous()
    return plan, qg_rows, bias


def plan_counts(plan):
    """(active items, distinct active tiles, active query groups)."""
    active = plan.work_active.bool()
    mnt = plan.work_tile.shape[0] // plan.qg_query.shape[0]
    return (int(active.sum()), int(plan.work_tile[active].unique().numel()),
            int(active.reshape(-1, mnt).any(1).sum()))


def _bound(nbytes, t_ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(plan, rows3, kpg):
    """Least time (ms) for the K1 work of this plan on one H100: bytes of
    each distinct input read once (active tiles' rows, scale, bias; active
    groups' queries; the work tables) and each active output segment
    written once, vs the bf16 tensor-core time of the active products."""
    n_active, tiles, groups = plan_counts(plan)
    tile, d_pad = rows3.shape[1], rows3.shape[2]
    nbytes = (tiles * tile * (d_pad + 8) + groups * 128 * d_pad * 2
              + plan.work_tile.shape[0] * 8
              + n_active * 128 * kpg * (tile // 32) * 4)
    t_ops = 2.0 * n_active * tile * 128 * d_pad / BF16_FLOPS
    return _bound(nbytes, t_ops) + (n_active,)


def ah_inputs(torch, searcher, queries, leaves, measure_l2):
    """The exact K3 / K4 inputs of the main path for this batch: (plan,
    qg_rows, codes, codebook table, squared norms (K3) or mean (K4),
    bias).  A squared-L2 case on a dot-product index takes the mean of
    its decoded rows, as an L2 index has, centers the queries on it and
    derives the tables for it, as the searcher does once per index."""
    from scann_torch.ops import pruned_lut
    searcher._ensure_pruned()
    plan = pruned_plan(torch, searcher, queries, leaves)
    mean = searcher._p_mean
    d_pad = mean.shape[0]
    if measure_l2 and searcher._recon_mean is None:
        mean = torch.zeros_like(mean)
        mean[:searcher.dims] = searcher._decode_mean()
    q = queries - mean[None, :searcher.dims]
    q_bf = torch.nn.functional.pad(q, (0, d_pad - q.shape[1])).to(
        torch.bfloat16)
    if searcher._int8_lut:
        tables = pruned_lut.lut_tables(
            searcher.model.codebook.to(mean.device), mean,
            d_pad // searcher.model.dims_per_block, measure_l2=measure_l2)
    else:
        tables = (searcher._p_cb, mean)
    return (plan, q_bf[plan.qg_query.long()], searcher._p_codes, *tables,
            searcher._p_bias)


def k3_bound(plan, codes3p, dpb, kpg):
    """Least time (ms) for the K3 work of this plan on one H100.  Bytes:
    each distinct input once (active tiles' packed codes and bias, active
    groups' bf16 queries, the compact codebook and norms, the work tables)
    and each active output segment once.  Operations: the LUT product of
    each active group at the bf16 tensor-core peak plus one int8 LUT entry
    added per (slot, block, query) of each active item at the int8 peak.
    The lookup itself is a table read, no arithmetic: the one-hot matmul
    the TPU kernel spends on it is not work the function needs."""
    n_active, tiles, groups = plan_counts(plan)
    tile, b2 = codes3p.shape[1], codes3p.shape[2]
    w, d_pad = b2 * 2 * 16, b2 * 2 * dpb
    nbytes = (tiles * tile * (b2 + 4) + groups * 128 * d_pad * 2
              + w * (dpb + 1) * 4 + plan.work_tile.shape[0] * 8
              + n_active * 128 * kpg * (tile // 32) * 4)
    t_ops = (2.0 * groups * w * 128 * dpb / BF16_FLOPS
             + 1.0 * n_active * tile * b2 * 2 * 128 / INT8_OPS)
    return _bound(nbytes, t_ops) + (n_active,)


def k4_bound(plan, codes3, cpb, dpb, kpg):
    """Least time (ms) for the K4 work of this plan: bytes as for K3 with
    one byte per block and slot and the f32 mean; operations: the decoded
    tile x query-group product of each active item at the bf16 peak (the
    decode itself is a table read, no arithmetic)."""
    n_active, tiles, groups = plan_counts(plan)
    tile, b_pad = codes3.shape[1], codes3.shape[2]
    d_pad = b_pad * dpb
    nbytes = (tiles * tile * (b_pad + 4) + groups * 128 * d_pad * 2
              + b_pad * cpb * dpb * 4 + d_pad * 4
              + plan.work_tile.shape[0] * 8
              + n_active * 128 * kpg * (tile // 32) * 4)
    t_ops = 2.0 * n_active * tile * 128 * d_pad / BF16_FLOPS
    return _bound(nbytes, t_ops) + (n_active,)


def compare_packed(torch, name, got, want, plan, atol=None,
                   min_id=K1_MIN_ID_AGREE):
    """Hold a kernel's packed output against the plain version's on active
    segments: bit-equal when ``atol`` is None, else unpacked values within
    K1_RTOL relative plus ``atol`` and identities equal on ``min_id`` of
    survivors.  Returns (max_abs_err, identity agreement)."""
    from scann_torch.ops import pruned_scan
    g_pad = plan.qg_query.shape[0]
    mnt = plan.work_tile.shape[0] // g_pad
    seg = got.shape[-1] // mnt
    act = plan.work_active.reshape(g_pad, 1, mnt, 1).bool().expand(
        g_pad, 128, mnt, seg)
    a = got.reshape(g_pad, 128, mnt, seg)[act]
    b = want.reshape(g_pad, 128, mnt, seg)[act]
    va, _, _ = pruned_scan._unpack(a)
    vb, _, _ = pruned_scan._unpack(b)
    live = vb > -1e20            # padded slots carry the -1e30 penalty
    err = (va.double() - vb.double()).abs()[live]
    tol = K1_RTOL * vb.double().abs()[live] + (atol or 0.0)
    bad = int((err > tol).sum()) + int(((va > -1e20) != live).sum())
    ident = float(((a & pruned_scan._ID_MASK)
                   == (b & pruned_scan._ID_MASK)).double().mean())
    if atol is None:
        bad += int((a != b).sum())
    if bad or ident < min_id or not torch.isfinite(va).all():
        raise AssertionError(
            f"{name} disagrees with its plain version: {bad} of {a.numel()} "
            f"survivors out of tolerance, identities agree {ident:.6f}")
    return (float(err.max()) if err.numel() else 0.0), ident


# The bar of each tile kernel against its plain version: (atol, least
# identity agreement).
TILE_BARS = {"k1": (K1_ATOL, K1_MIN_ID_AGREE),
             "k2": (K4_ATOL, K2_MIN_ID_AGREE),
             "k4": (K4_ATOL, K1_MIN_ID_AGREE)}


def wide_checks(torch, name, widths, kpgs, shapes=((16, 2),)):
    """K1 ("k1"), K2 ("k2") or K4 ("k4", at each (centers, dimensions per
    block) of ``shapes``) against its plain version at d_pads the main
    path does not reach, on synthetic plans at the scale of an index of
    unit vectors, dot and squared L2: the bar of the main path's inputs,
    and the same bar against float64 scores of the survivors; then at the
    kernel's raw-scale width (tile_cases.RAW_CASES), the largest float64
    excess within RAW_EXCESS_RATIO times the plain version's.  Returns the
    largest max_abs_err against the plain version."""
    from scann_torch.tools import tile_cases
    atol, min_id = TILE_BARS[name]
    worst = 0.0
    for d in widths:
        for cpb, dpb in shapes:
            for measure_l2 in (False, True):
                case = tile_cases.synthetic_case(
                    name, d, unit=True, measure_l2=measure_l2, seed=d,
                    cpb=cpb, dpb=dpb)
                plan, qg = case[:2]
                what = f"{name.upper()} at d_pad {qg.shape[-1]}" + (
                    f", {cpb} centers x {dpb} dims" if name == "k4" else "")
                for kpg in kpgs:
                    got = tile_cases.score(name, case, kpg, measure_l2)
                    want = tile_cases.plain(name, case, kpg, measure_l2)
                    torch.cuda.synchronize()
                    err, ident = compare_packed(torch, what, got, want, plan,
                                                atol=atol, min_id=min_id)
                    excess = {w: float(tile_cases.exact_excess(
                        case, o, kpg, measure_l2).max())
                        for w, o in (("kernel", got), ("plain", want))}
                    if excess["kernel"] > atol:
                        raise AssertionError(
                            f"{what} misses float64 by "
                            f"{excess['kernel']:.3g} over the bar")
                    worst = max(worst, err)
                    log(f"{what} vs plain ({'l2' if measure_l2 else 'dot'}, "
                        f"kpg {kpg}, {int(plan.work_active.sum())} active "
                        f"items): max |err| {err:.3g}, identities agree "
                        f"{ident:.6f}; largest |value - float64| - 2^-14 "
                        f"|float64|: kernel {excess['kernel']:.3g}, plain "
                        f"{excess['plain']:.3g}")
                    del got, want
                del case, plan, qg
                torch.cuda.empty_cache()
    d = dict(tile_cases.RAW_CASES)[name]
    for measure_l2 in (False, True):
        kernel, plain = tile_cases.raw_excess(
            name, d, measure_l2,
            lambda case: tile_cases.score(name, case, 8, measure_l2))
        log(f"{name.upper()} at d_pad {d}, raw scale, "
            f"{'l2' if measure_l2 else 'dot'}, kpg 8: largest |value - "
            f"float64| - 2^-14 |float64|: kernel {kernel:.3g}, plain "
            f"{plain:.3g}")
        if not 0 < plain or kernel > tile_cases.RAW_EXCESS_RATIO * plain:
            raise AssertionError(
                f"{name.upper()} at d_pad {d}, raw scale: float64 excess "
                f"{kernel:.3g} over {tile_cases.RAW_EXCESS_RATIO} x the plain "
                f"version's {plain:.3g}")
    torch.cuda.empty_cache()
    return worst


def k2_bound(plan, rows3, kpg):
    """Least time (ms) for the K2 work of this plan on one H100.  Bytes:
    each distinct input once (active tiles' bf16 rows and bias, active
    groups' bf16 queries, the work tables) and each active output segment
    once; operations: the tile x query-group product of each active item
    at the bf16 tensor-core peak."""
    n_active, tiles, groups = plan_counts(plan)
    tile, d_pad = rows3.shape[1], rows3.shape[2]
    nbytes = (tiles * tile * (d_pad * 2 + 4) + groups * 128 * d_pad * 2
              + plan.work_tile.shape[0] * 8
              + n_active * 128 * kpg * (tile // 32) * 4)
    t_ops = 2.0 * n_active * tile * 128 * d_pad / BF16_FLOPS
    return _bound(nbytes, t_ops) + (n_active,)


def k5_bound(nq, rows):
    """Least time (ms) for one K5 call: the bf16 products of every (query,
    slot) pair at the tensor-core peak, vs the rows, bias and queries read
    once and the two (Q, S/256) outputs written once."""
    s, d = rows.shape
    nbytes = s * (d * 2 + 4) + nq * d * 2 + nq * (s // 256) * 8
    return _bound(nbytes, 2.0 * nq * s * d / BF16_FLOPS)


def k6_bound(plan, packed, k):
    """Least time (ms) for the K6 work of this plan: the packed rows of the
    active groups read once, 2k words a row written; no arithmetic to
    speak of, so bytes bind."""
    groups = plan_counts(plan)[2]
    w = packed.shape[-1]
    return _bound(groups * (128 * (w + 2 * k) * 4 + 4), 0.0) + (groups,)


def recon_k2_inputs(torch, searcher, queries, leaves, measure_l2):
    """The exact K2 inputs of the main path for this batch: (plan, qg_rows,
    rows, bias).  The squared-L2 case runs on the same plan and rows with
    the bias plane an L2 index has: -||x_hat||^2 on live slots."""
    searcher._ensure_pruned()
    plan = pruned_plan(torch, searcher, queries, leaves)
    rows = searcher._p_rows
    _, q_bf = searcher._recon_queries(queries, rows.shape[-1])
    bias = searcher._p_bias
    if measure_l2:
        sq = (rows.float() ** 2).sum(-1, keepdim=True)
        bias = torch.where(bias > -1e20, -sq, bias).contiguous()
    return plan, q_bf[plan.qg_query.long()], rows, bias


def compare_groupmax(torch, got, want, q_bf, rows, bias, scale):
    """Hold K5's (vals, idx) against the plain version's (see K5_RTOL).
    Returns (max_abs_err, slot agreement)."""
    (gv, gi), (wv, wi) = got, want
    tol = K5_RTOL * wv.abs() + K5_ATOL
    err = (gv - wv).abs()
    same = gi == wi
    agree = float(same.double().mean())
    qi = (~same).nonzero()[:, 0]
    alt_slot = gi[~same].long()
    alt = scale * (q_bf[qi].float() * rows[alt_slot].float()).sum(-1) \
        + bias[alt_slot]
    bad = int((err > tol).sum()) + int(
        ((alt - wv[~same]).abs() > tol[~same]).sum())
    if bad or agree < K5_MIN_ID_AGREE or gv.shape != wv.shape:
        raise AssertionError(
            f"K5 disagrees with its plain version: {bad} of {gv.numel()} "
            f"groups out of tolerance, slots agree {agree:.6f}")
    return float(err[wv > -1e20].max()), agree


def groupmax_composition(torch, q_bf, rows, bias, scale, chunk=65536):
    """The PyTorch composition that computes K5's function with library
    calls: a chunked bf16 torch.matmul (bf16 scores), then amax and argmax
    over the reshaped groups.  Timed beside K5; the port never calls it."""
    vals, idx = [], []
    for s0 in range(0, rows.shape[0], chunk):
        sim = scale * torch.matmul(q_bf, rows[s0:s0 + chunk].T).float() \
            + bias[s0:s0 + chunk][None, :]
        g = sim.reshape(q_bf.shape[0], -1, 256)
        vals.append(g.amax(-1))
        idx.append(g.argmax(-1))
    return torch.cat(vals, 1), torch.cat(idx, 1)


def k6_check(torch, rec, what, plan, packed, ntiles, tile, k, mnt):
    """K6 against its plain version on one packed block, bit for bit on
    the rows of active groups (max_abs_err is the largest difference of
    the output words, selected keys and tiles, as integers), with timings
    and the bound."""
    from scann_torch.ops import pruned_scan
    kgp = packed.shape[-1] // mnt
    qg_nt = ntiles[torch.clamp(plan.qg_leaf, 0,
                               ntiles.shape[0] - 1).long()].contiguous()
    run = lambda: pruned_scan.merge_groups(       # noqa: E731
        packed, qg_nt, kgp=kgp, tile=tile, k=k)
    plain = lambda: pruned_scan.merge_groups_torch(   # noqa: E731
        packed, qg_nt, kgp=kgp, tile=tile, k=k)
    got, want = run(), plain()
    torch.cuda.synchronize()
    live = plan.work_active.reshape(-1, mnt)[:, 0] == 1
    if not bool(live.any()):
        raise AssertionError(f"K6 ({what}): the plan has no active group")
    gaps = [(a[live].long() - b[live].long()).abs()
            for a, b in zip(got, want)]
    diff = sum(int((g != 0).sum()) for g in gaps)
    err = float(max(int(g.max()) for g in gaps))
    if diff:
        raise AssertionError(f"K6 ({what}) differs from its plain version "
                             f"in {diff} words (largest gap {err:.0f})")
    del got, want, gaps
    point = {"max_abs_err": err, "ms": time_ms(torch, run),
             "plain_ms": time_ms(torch, plain, reps=PLAIN_TIMING_REPS)}
    point["bound_ms"], point["bound_by"], groups = k6_bound(plan, packed, k)
    rec[what] = point
    log(f"K6 vs plain ({what}: {tuple(packed.shape)} packed, k {k}): "
        f"max word difference {err:.0f} on {groups} active groups; "
        f"{point['ms']:.3f} ms (plain "
        f"{point['plain_ms']:.3f} ms), bound {point['bound_ms']:.4f} ms by "
        f"{point['bound_by']}")


def k6_wide_check(torch, seed=6):
    """K6 bit-equal to its plain version at the widest row a scorer
    writes: 16 tiles of 512 slots at 32 survivors a group (w 8192), k 32,
    on 16 groups whose tile counts run from 0 (all-dead rows) to 16, with
    scores on a coarse grid so the value bits tie often.  Returns the row
    width."""
    from scann_torch.ops import pruned_scan
    r = np.random.default_rng(seed)
    g_pad, mnt, kpg, tile, k = 16, 16, 32, 512, 32
    gp = tile // 32
    kgp = kpg * gp
    w = mnt * kgp
    scores = (r.integers(-8, 8, (g_pad, 128, w)) * 0.25).astype(np.float32)
    scores[r.random(scores.shape) < 0.05] = -1e30
    col = np.arange(w)
    first = r.integers(0, 32, (g_pad, 128, mnt, 1, gp))
    arg = (first + np.arange(kpg)[None, None, None, :, None]) % 32
    ident = ((col // kgp) << 5)[None, None, :] | arg.reshape(g_pad, 128, w)
    packed = torch.as_tensor(
        ((scores.view(np.int32) & ~511) | ident).astype(np.int32),
        device="cuda")
    qg_nt = torch.as_tensor(np.arange(g_pad, dtype=np.int32) % (mnt + 1),
                            device="cuda")
    got = pruned_scan.merge_groups(packed, qg_nt, kgp=kgp, tile=tile, k=k)
    want = pruned_scan.merge_groups_torch(packed, qg_nt, kgp=kgp, tile=tile,
                                          k=k)
    torch.cuda.synchronize()
    diff = sum(int((a != b).sum()) for a, b in zip(got, want))
    if diff:
        raise AssertionError(f"K6 at w {w}, k {k} differs from its plain "
                             f"version in {diff} words")
    log(f"K6 vs plain at the widest row (w {w}, k {k}, {g_pad} groups with "
        f"0-{mnt} live tiles): bit-equal")
    return w


def guard_checks(scann_torch):
    """On the card, a K3 width that no survivor count serves (int8 lookup
    over 200 code blocks) and a no-tree reconstruct searcher over 512
    dimensions large enough that every search is a K5 scan (20,000 rows:
    80 groups of 256 slots for 10 candidates) raise NotImplementedError
    naming item 13 before any training."""
    for what, d, lookup, tree, n in (
            ("K3 width", 400, "int8", True, 2000),
            ("no-tree K5 width", 400, "reconstruct", False, 20_000)):
        db = np.zeros((n, d), np.float32)
        kw = dict(num_leaves=10, num_leaves_to_search=2,
                  training_sample_size=2000) if tree else {}
        config = ah_config(scann_torch, db, "dot_product", lookup, None, **kw)
        t0 = time.perf_counter()
        try:
            scann_torch.create_searcher(db, config, "cuda")
        except NotImplementedError as e:
            if "item 13" not in str(e):
                raise
            log(f"{what} (d {d}, {lookup}) refused in "
                f"{time.perf_counter() - t0:.3f} s: {e}")
        else:
            raise AssertionError(f"{what}: d {d} built on the card")


def wide_codes_search(scann_torch):
    """A float32-lookup tree-AH index of 200 dimensions (d_pad 208, past
    the 144 K4 once served) builds and searches on the card, launches K4
    once, and agrees with the CPU plain path on the same index."""
    from scann_torch.ops import pruned_lut
    r = np.random.default_rng(2)
    db = r.standard_normal((20000, 200)).astype(np.float32)
    q = r.standard_normal((200, 200)).astype(np.float32)
    s = scann_torch.create_searcher(db, ah_config(
        scann_torch, db, "dot_product", "float32", "float32", num_leaves=32,
        num_leaves_to_search=4, training_sample_size=10000), "cuda")
    before = pruned_lut.launches_codes
    idx, dist = s.search_batched(q, pre_reorder_num_neighbors=30)
    if pruned_lut.launches_codes != before + 1 or idx.shape != (200, K):
        raise AssertionError("the 200-dim float32-lookup search did not "
                             "launch K4 once")
    cross_check(scann_torch, s, q, "float32 lookup at d 200 (d_pad "
                f"{s._p_mean.shape[0]})", pre_reorder_num_neighbors=30)


def fused_merge_points(torch, searcher, timer, queries, db, truth, what,
                       exact_distances, **kw):
    """One search with the stratified merge and one with the fused merge
    (SCANN_TORCH_FUSED_MERGE=1) on the same index in the same run; the
    fused one must launch K6 and keep recall@10.  Returns the two points;
    K6's launch count is left in pruned_scan.launches_merge."""
    from scann_torch.ops import pruned_scan
    searcher.stage_hook = timer
    out = {}
    for mode in ("stratified", "fused"):
        os.environ["SCANN_TORCH_FUSED_MERGE"] = "1" if mode == "fused" else "0"
        try:
            idx, dist, wall, stages, launched = timed_search(
                torch, searcher, timer, queries,
                lambda: pruned_scan.launches_merge, **kw)
        finally:
            os.environ.pop("SCANN_TORCH_FUSED_MERGE")
        check_results(queries, db, idx, dist, f"{what} {mode} merge",
                      exact_distances)
        if launched != (1 if mode == "fused" else 0):
            raise AssertionError(f"{what}: the {mode} merge launched K6 "
                                 f"{launched} times")
        out[mode] = {"recall": recall_at_k(idx, truth), "qps": N_QUERY / wall,
                     "merge_ms": stages["merge"], "k6_launches": launched,
                     "stage_ms": stages}
        log(f"{what} {mode} merge {kw}: recall@10 {out[mode]['recall']:.4f}, "
            f"qps {N_QUERY / wall:.0f}, K6 launches {launched}, stage ms "
            f"{stages}")
    searcher.stage_hook = None
    loss = out["stratified"]["recall"] - out["fused"]["recall"]
    if loss > FUSED_MERGE_MAX_RECALL_LOSS:
        raise AssertionError(f"{what}: the fused merge loses {loss:.4f} of "
                             f"recall@10")
    return out


def ah_config(scann_torch, db, measure, lookup, reorder, hash_type="lut16",
              dpb=2, **tree):
    b = scann_torch.builder(db, K, measure)
    if tree:
        b = b.tree(**tree)
    b = b.score_ah(dpb, anisotropic_quantization_threshold=0.2,
                   hash_type=hash_type)
    if reorder is not None:
        b = b.reorder(AH_REORDER, quantize=reorder)
    config = b.create_config()
    return dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type=lookup))


def timed_search(torch, searcher, timer, queries, count, **kw):
    """One warm-up, then one timed search_batched with stage times and the
    kernel launches ``count()`` saw during the timed run."""
    searcher.search_batched(queries, **kw)
    torch.cuda.synchronize()
    before = count()
    timer.start()
    t0 = time.perf_counter()
    idx, dist = searcher.search_batched(queries, **kw)
    wall = time.perf_counter() - t0
    stages = {k: round(v, 3) for k, v in timer.stage_ms().items()}
    return idx, dist, wall, stages, count() - before


def check_results(queries, db, idx, dist, what, exact_distances):
    if idx.shape != (len(queries), K) or not np.isfinite(dist).all():
        raise AssertionError(f"bad results at {what}: shape {idx.shape}, "
                             f"finite {np.isfinite(dist).mean()}")
    if exact_distances:
        exact = np.einsum("qd,qkd->qk", queries, db[idx])
        if np.abs(exact - dist).max() > 2e-2:
            raise AssertionError(f"distances at {what} are not the dot "
                                 f"products of the returned rows")


def cross_check(scann_torch, searcher, queries, what, **kw):
    """The same index, serialized and searched on the CPU plain path,
    returns what the CUDA path returns for a few queries (at leaves=100
    unless ``kw`` says otherwise)."""
    kw = kw or {"leaves_to_search": LEAVES_TO_SEARCH}
    with tempfile.TemporaryDirectory() as tmp:
        searcher.serialize(tmp)
        cpu = scann_torch.load_searcher(tmp, device="cpu")
        i_cpu, d_cpu = cpu.search_batched(queries[:16], **kw)
    i_gpu, d_gpu = searcher.search_batched(queries[:16], **kw)
    same = i_cpu == i_gpu
    agree = float(np.mean(same))
    if agree < 0.99 or not np.allclose(d_cpu[same], d_gpu[same], rtol=1e-4):
        raise AssertionError(f"{what}: CUDA and CPU paths disagree: ids "
                             f"{agree:.4f}")
    log(f"{what}: CUDA vs CPU plain path on 16 queries: ids agree "
        f"{agree:.4f}")


def tree_ah_phase(torch, scann_torch, db, queries, truth, q_dev, k6):
    """Phase 6; returns (K3 record, K4 record, summary dict) and adds the
    tree-AH part of K6's record to ``k6``."""
    from scann_torch import _cuda
    from scann_torch.ops import pruned_lut
    from scann_torch.ops import pruned_scan
    tree = dict(num_leaves=NUM_LEAVES, num_leaves_to_search=LEAVES_TO_SEARCH,
                training_sample_size=TRAIN_SAMPLE)
    searchers, build_s = {}, {}
    for name, lookup, reorder in (("int8_f32", "int8", "float32"),
                                  ("int8_int8", "int8", "int8"),
                                  ("float_f32", "float32", "float32")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        searchers[name] = scann_torch.create_searcher(
            db, ah_config(scann_torch, db, "dot_product", lookup, reorder,
                          **tree), "cuda")
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        s = searchers[name]
        s._ensure_pruned()
        rh = s.reorder_helper
        code_b = s._p_codes.numel() + s._p_bias.numel() * 4 \
            + s._p_dpid.numel() * 4
        reorder_b = sum(t.numel() * t.element_size() for t in (
            rh._db, rh._sq_norms, rh._leaf, rh._row_scale) if t is not None)
        log(f"tree-AH build {name}: {build_s[name]:.1f} s, "
            f"{s.partitioner.num_leaves} leaves, max_ntiles "
            f"{s._p_max_ntiles}, {s._p_num_tiles} tiles, codes "
            f"{code_b / N_DB:.1f} B/vector, reorder {reorder_b / N_DB:.1f} "
            f"B/vector, quantization error "
            f"{s._quantization_error_sq ** 0.5:.4f}")
    main, main_i8, main_f = (searchers[n] for n in
                             ("int8_f32", "int8_int8", "float_f32"))
    dpb = main.model.dims_per_block

    # Kernel phase: K3 and K4 at the main path's inputs.
    k3, k4 = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    k3["occupancy"] = _cuda.occupancy("pruned_lut",
                                      main._p_codes.shape[-1] * 2, 8)
    for measure_l2 in (False, True):
        for kpg in (8, 16):
            tag = f"{'l2' if measure_l2 else 'dot'}, kpg {kpg}"
            a3 = ah_inputs(torch, main, q_dev, LEAVES_TO_SEARCH, measure_l2)
            got = pruned_lut.score_work_lut(
                *a3, measure_l2=measure_l2, kpg=kpg)
            want = pruned_lut.score_work_torch_lut(
                *a3, measure_l2=measure_l2, kpg=kpg)
            torch.cuda.synchronize()
            err, ident = compare_packed(torch, "K3", got, want, a3[0])
            k3["max_abs_err"] = max(k3["max_abs_err"], err)
            log(f"K3 vs plain ({tag}): bit-equal, w_pad "
                f"{a3[0].work_tile.shape[0]}, active "
                f"{int(a3[0].work_active.sum())}")
            if not measure_l2 and kpg == 8:    # the main path's block
                k6_check(torch, k6, "tree_ah", a3[0], got, main._p_ntiles,
                         pruned_scan.TILE, FUSED_MERGE_PRE,
                         main._p_max_ntiles)
            del got, want
            a4 = ah_inputs(torch, main_f, q_dev, LEAVES_TO_SEARCH,
                           measure_l2)
            got = pruned_lut.score_work_codes(
                *a4, measure_l2=measure_l2, kpg=kpg)
            want = pruned_lut.score_work_torch_codes(
                *a4, measure_l2=measure_l2, kpg=kpg)
            torch.cuda.synchronize()
            err, ident = compare_packed(torch, "K4", got, want, a4[0],
                                        atol=K4_ATOL)
            k4["max_abs_err"] = max(k4["max_abs_err"], err)
            log(f"K4 vs plain ({tag}): max |err| {err:.3g}, identities "
                f"agree {ident:.6f}")
            del got, want
            if not measure_l2 and kpg == 8:    # the main path's case
                for rec, fn, plain, args, bound in (
                        (k3, pruned_lut.score_work_lut,
                         pruned_lut.score_work_torch_lut, a3,
                         k3_bound(a3[0], a3[2], dpb, kpg)),
                        (k4, pruned_lut.score_work_codes,
                         pruned_lut.score_work_torch_codes, a4,
                         k4_bound(a4[0], a4[2], 16, dpb, kpg))):
                    rec["ms"] = time_ms(torch, lambda: fn(
                        *args, measure_l2=False, kpg=kpg))
                    rec["plain_ms"] = time_ms(torch, lambda: plain(
                        *args, measure_l2=False, kpg=kpg),
                        reps=PLAIN_TIMING_REPS)
                    rec["bound_ms"], rec["bound_by"], n_act = bound
                    log(f"{fn.__name__} at leaves={LEAVES_TO_SEARCH}, "
                        f"{N_QUERY} queries, kpg {kpg}: {rec['ms']:.3f} ms "
                        f"(plain {rec['plain_ms']:.3f} ms), bound "
                        f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} "
                        f"({n_act} active items)")
            del a3, a4
            torch.cuda.empty_cache()
    # K4 with 256 centers per block (lut256, 4 dims per block), small index.
    small = scann_torch.create_searcher(
        db[:60_000], ah_config(scann_torch, db[:60_000], "squared_l2",
                               "int8", None, hash_type="lut256", dpb=4,
                               num_leaves=100, num_leaves_to_search=10,
                               training_sample_size=60_000), "cuda")
    a4 = ah_inputs(torch, small, q_dev[:2000], 10, True)
    got = pruned_lut.score_work_codes(*a4, measure_l2=True, kpg=8)
    want = pruned_lut.score_work_torch_codes(*a4, measure_l2=True, kpg=8)
    torch.cuda.synchronize()
    err, ident = compare_packed(torch, "K4 (256 centers)", got, want, a4[0],
                                atol=K4_ATOL)
    k4["max_abs_err"] = max(k4["max_abs_err"], err)
    log(f"K4 vs plain (256 centers per block, l2, kpg 8, "
        f"{int(a4[0].work_active.sum())} active items): max |err| "
        f"{err:.3g}, identities agree {ident:.6f}")
    idx, _ = small.search_batched(queries[:2000], leaves_to_search=10)
    if idx.shape != (2000, K) or (idx < 0).any():
        raise AssertionError("lut256 search returned invalid ids")
    del small, got, want, a4
    torch.cuda.empty_cache()
    # K4 past the width it once refused (d_pad 144), both codebook shapes.
    k4["max_abs_err"] = max(k4["max_abs_err"], wide_checks(
        torch, "k4", (256, 384, 768), (8, 16), shapes=((16, 2), (256, 4))))
    k4["occupancy"] = _cuda.occupancy("pruned_codes", main_f._p_mean.shape[0],
                                      dpb, 8)
    if k4["occupancy"]["smem_bytes"] != pruned_scan.tile_smem_bytes(
            "codes", 8):
        raise AssertionError("K4's shared memory differs from "
                             "tile_smem_bytes")

    # Main path through the public entry points.
    timer = StageTimer(torch)
    pruned_lut.launches_lut = pruned_lut.launches_codes = 0
    points = []
    for name, s in (("int8_f32", main), ("int8_int8", main_i8)):
        s.stage_hook = timer
        for leaves, pre in AH_SWEEP:
            idx, dist, wall, stages, launched = timed_search(
                torch, s, timer, queries, lambda: pruned_lut.launches_lut,
                leaves_to_search=leaves, pre_reorder_num_neighbors=pre)
            check_results(queries, db, idx, dist,
                          f"tree-AH {name} leaves={leaves} pre={pre}",
                          exact_distances=name == "int8_f32")
            if launched == 0:
                raise AssertionError(f"tree-AH {name} leaves={leaves} "
                                     f"pre={pre} did not launch K3")
            points.append({"index": name, "leaves": leaves, "pre": pre,
                           "recall": recall_at_k(idx, truth),
                           "qps": N_QUERY / wall, "k3_launches": launched,
                           "stage_ms": stages})
            log(f"tree-AH {name} leaves={leaves} pre={pre}: recall@10 "
                f"{points[-1]['recall']:.4f}, qps {N_QUERY / wall:.0f}, K3 "
                f"launches {launched}, stage ms {stages}")
        s.stage_hook = None
    k3["launches"] = pruned_lut.launches_lut
    if pruned_lut.launches_codes:
        raise AssertionError("an int8-lookup point launched K4")
    main_f.stage_hook = timer
    idx, dist, wall, stages, launched = timed_search(
        torch, main_f, timer, queries, lambda: pruned_lut.launches_codes,
        leaves_to_search=LEAVES_TO_SEARCH)
    main_f.stage_hook = None
    check_results(queries, db, idx, dist, "tree-AH float32 lookup", True)
    k4["launches"] = pruned_lut.launches_codes
    if launched == 0:
        raise AssertionError("the float32-lookup point did not launch K4")
    points.append({"index": "float_f32", "leaves": LEAVES_TO_SEARCH,
                   "pre": AH_REORDER, "recall": recall_at_k(idx, truth),
                   "qps": N_QUERY / wall, "k4_launches": launched,
                   "stage_ms": stages})
    log(f"tree-AH float32 lookup leaves={LEAVES_TO_SEARCH}: recall@10 "
        f"{points[-1]['recall']:.4f}, qps {N_QUERY / wall:.0f}, K4 launches "
        f"{launched}, stage ms {stages}")
    at100 = next(p for p in points if (p["index"], p["leaves"], p["pre"])
                 == ("int8_f32", 100, 100))["recall"]
    if at100 < AH_RECALL_FLOOR_AT_100:
        raise AssertionError(f"tree-AH recall@10 {at100:.4f} at leaves=100, "
                             f"pre-reorder 100 is under "
                             f"{AH_RECALL_FLOOR_AT_100}")

    # Dense LUT16 scan: the full scan over all queries launches no kernel.
    main.stage_hook = timer
    idx, dist, wall, stages, launched = timed_search(
        torch, main, timer, queries,
        lambda: pruned_lut.launches_lut + pruned_lut.launches_codes,
        leaves_to_search=main.partitioner.num_leaves)
    main.stage_hook = None
    check_results(queries, db, idx, dist, "tree-AH dense", True)
    if launched:
        raise AssertionError("the full scan launched a pruned scorer")
    dense = {"recall": recall_at_k(idx, truth), "qps": N_QUERY / wall,
             "stage_ms": stages}
    log(f"tree-AH dense scan (full scan): recall@10 {dense['recall']:.4f}, "
        f"qps {dense['qps']:.0f}, stage ms {stages}")
    main.index = main.index._replace(codes=None)   # free the dense layout

    pruned_scan.launches_merge = 0
    merges = fused_merge_points(
        torch, main, timer, queries, db, truth, "tree-AH", True,
        leaves_to_search=LEAVES_TO_SEARCH,
        pre_reorder_num_neighbors=FUSED_MERGE_PRE)
    k6["launches"] += pruned_scan.launches_merge

    cross_check(scann_torch, main, queries, "tree-AH")
    wide_codes_search(scann_torch)
    return k3, k4, {"build_s": build_s, "points": points, "dense": dense,
                    "merge": merges, "b_pad": main._p_codes.shape[-1] * 2,
                    "k4_d_pad": main_f._p_mean.shape[0]}


def recon_phase(torch, scann_torch, db, queries, truth, q_dev):
    """Phase 7; returns (K2 record, K5 record, summary dict)."""
    from scann_torch import _cuda
    from scann_torch.ops import fused_scan
    from scann_torch.ops import pruned_scan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = scann_torch.create_searcher(
        db, ah_config(scann_torch, db, "dot_product", "reconstruct",
                      "float32", num_leaves=NUM_LEAVES,
                      num_leaves_to_search=LEAVES_TO_SEARCH,
                      training_sample_size=TRAIN_SAMPLE), "cuda")
    s._ensure_pruned()
    s._ensure_recon_rows()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    pruned_b = nbytes(s._p_rows, s._p_bias, s._p_dpid)
    scan_b = nbytes(s._recon_rows, s._recon_bias, s._recon_sq)
    reorder_b = nbytes(s.reorder_helper._db)
    log(f"reconstruct build: {build_s:.1f} s (both layouts), "
        f"{s.partitioner.num_leaves} leaves, max_ntiles {s._p_max_ntiles}, "
        f"{s._p_num_tiles} tiles; resident on the card: pruned rows "
        f"{pruned_b / 1e6:.0f} MB ({pruned_b / N_DB:.1f} B/vector), "
        f"full-scan rows {scan_b / 1e6:.0f} MB ({scan_b / N_DB:.1f} "
        f"B/vector, {s._recon_rows.shape[0]} slots), reorder rows "
        f"{reorder_b / 1e6:.0f} MB; quantization error "
        f"{s._quantization_error_sq ** 0.5:.4f}")
    cross_check(scann_torch, s, queries, "reconstruct")

    # Kernel phase: K2 at the main path's inputs.
    k2 = {"max_abs_err": 0.0}
    for measure_l2 in (False, True):
        for kpg in (8, 16):
            args = recon_k2_inputs(torch, s, q_dev, LEAVES_TO_SEARCH,
                                   measure_l2)
            got = pruned_scan.score_work(*args, measure_l2=measure_l2,
                                         kpg=kpg)
            want = pruned_scan.score_work_torch(*args, measure_l2=measure_l2,
                                                kpg=kpg)
            torch.cuda.synchronize()
            err, ident = compare_packed(torch, "K2", got, want, args[0],
                                        atol=K4_ATOL, min_id=K2_MIN_ID_AGREE)
            k2["max_abs_err"] = max(k2["max_abs_err"], err)
            log(f"K2 vs plain ({'l2' if measure_l2 else 'dot'}, kpg {kpg}): "
                f"max |err| {err:.3g}, identities agree {ident:.6f}, w_pad "
                f"{args[0].work_tile.shape[0]}, active "
                f"{int(args[0].work_active.sum())}")
            del got, want
            if not measure_l2 and kpg == 8:    # the main path's case
                k2["ms"] = time_ms(torch, lambda: pruned_scan.score_work(
                    *args, measure_l2=False, kpg=kpg))
                k2["plain_ms"] = time_ms(
                    torch, lambda: pruned_scan.score_work_torch(
                        *args, measure_l2=False, kpg=kpg),
                    reps=PLAIN_TIMING_REPS)
                k2["bound_ms"], k2["bound_by"], n_act = k2_bound(
                    args[0], args[2], kpg)
                log(f"K2 at leaves={LEAVES_TO_SEARCH}, {N_QUERY} queries, "
                    f"kpg {kpg}: {k2['ms']:.3f} ms (plain "
                    f"{k2['plain_ms']:.3f} ms), bound {k2['bound_ms']:.4f} "
                    f"ms by {k2['bound_by']} ({n_act} active items)")
            del args
            torch.cuda.empty_cache()

    k2["max_abs_err"] = max(k2["max_abs_err"],
                            wide_checks(torch, "k2", (256, 384), (8, 16)))
    k2["occupancy"] = _cuda.occupancy("pruned_rows", s._p_rows.shape[-1],
                                      pruned_scan.KPG)
    if k2["occupancy"]["smem_bytes"] != pruned_scan.tile_smem_bytes(
            "bf16", pruned_scan.KPG):
        raise AssertionError("K2's shared memory differs from "
                             "tile_smem_bytes")

    # K5 on the full-scan layout, at the main path's shape.
    rows, bias = s._recon_rows, s._recon_bias
    k5 = {"occupancy": _cuda.occupancy("fused_scan", rows.shape[1])}
    _, q_bf = s._recon_queries(q_dev, rows.shape[1])
    for measure_l2 in (False, True):
        # Squared L2 on the same rows: the bias plane an L2 index has.
        b = bias if not measure_l2 else torch.where(
            bias > -1e20, -(rows.float() ** 2).sum(-1), bias)
        got = fused_scan.fused_scan_groupmax(q_bf, rows, b,
                                             measure_l2=measure_l2)
        want = fused_scan.fused_scan_groupmax_torch(q_bf, rows, b,
                                                    measure_l2=measure_l2)
        torch.cuda.synchronize()
        err, agree = compare_groupmax(torch, got, want, q_bf, rows, b,
                                      2.0 if measure_l2 else 1.0)
        k5["max_abs_err"] = max(k5.get("max_abs_err", 0.0), err)
        log(f"K5 vs plain ({'l2' if measure_l2 else 'dot'}, "
            f"{q_bf.shape[0]} queries x {rows.shape[0]} slots): max |err| "
            f"{err:.3g}, slots agree {agree:.6f}")
        del got, want, b
        torch.cuda.empty_cache()
    k5["ms"] = time_ms(torch, lambda: fused_scan.fused_scan_groupmax(
        q_bf, rows, bias))
    k5["plain_ms"] = time_ms(
        torch, lambda: fused_scan.fused_scan_groupmax_torch(q_bf, rows, bias),
        reps=PLAIN_TIMING_REPS)
    composition_ms = time_ms(torch, lambda: groupmax_composition(
        torch, q_bf, rows, bias, 1.0), reps=PLAIN_TIMING_REPS)
    k5["bound_ms"], k5["bound_by"] = k5_bound(N_QUERY, rows)
    log(f"K5 at {N_QUERY} queries x {rows.shape[0]} slots x "
        f"{rows.shape[1]}: {k5['ms']:.3f} ms (plain {k5['plain_ms']:.3f} ms;"
        f" bf16 torch.matmul + amax/argmax composition "
        f"{composition_ms:.3f} ms), bound {k5['bound_ms']:.4f} ms by "
        f"{k5['bound_by']}")
    del q_bf
    torch.cuda.empty_cache()

    # Main path through the public entry points.
    timer = StageTimer(torch)
    s.stage_hook = timer
    pruned_scan.launches = fused_scan.launches = 0
    points = []
    for leaves in RECON_SWEEP:
        idx, dist, wall, stages, launched = timed_search(
            torch, s, timer, queries, lambda: pruned_scan.launches,
            leaves_to_search=leaves, pre_reorder_num_neighbors=AH_REORDER)
        check_results(queries, db, idx, dist, f"reconstruct leaves={leaves}",
                      True)
        if launched == 0:
            raise AssertionError(f"reconstruct leaves={leaves} did not "
                                 f"launch K2")
        points.append({"leaves": leaves, "pre": AH_REORDER,
                       "recall": recall_at_k(idx, truth),
                       "qps": N_QUERY / wall, "k2_launches": launched,
                       "stage_ms": stages})
        log(f"reconstruct leaves={leaves} pre={AH_REORDER}: recall@10 "
            f"{points[-1]['recall']:.4f}, qps {N_QUERY / wall:.0f}, K2 "
            f"launches {launched}, stage ms {stages}")
    k2["launches"] = pruned_scan.launches
    if fused_scan.launches:
        raise AssertionError("a pruned reconstruct point launched K5")
    idx, dist, wall, stages, launched = timed_search(
        torch, s, timer, queries, lambda: fused_scan.launches,
        leaves_to_search=s.partitioner.num_leaves)
    s.stage_hook = None
    check_results(queries, db, idx, dist, "reconstruct full scan", True)
    k5["launches"] = fused_scan.launches
    if launched == 0 or pruned_scan.launches != k2["launches"]:
        raise AssertionError("the reconstruct full scan did not go through "
                             "K5 alone")
    full = {"recall": recall_at_k(idx, truth), "qps": N_QUERY / wall,
            "k5_launches": launched, "stage_ms": stages}
    log(f"reconstruct full scan (K5): recall@10 {full['recall']:.4f}, qps "
        f"{full['qps']:.0f}, K5 launches {launched}, stage ms {stages}")
    at100 = next(p for p in points
                 if p["leaves"] == LEAVES_TO_SEARCH)["recall"]
    if at100 < AH_RECALL_FLOOR_AT_100:
        raise AssertionError(f"reconstruct recall@10 {at100:.4f} at "
                             f"leaves=100 is under {AH_RECALL_FLOOR_AT_100}")
    if full["recall"] < RECON_FULL_SCAN_FLOOR:
        raise AssertionError(f"reconstruct full-scan recall@10 "
                             f"{full['recall']:.4f} is under "
                             f"{RECON_FULL_SCAN_FLOOR}")
    s = None
    torch.cuda.empty_cache()

    # The same scorer with no tree: every search is a K5 scan.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = scann_torch.create_searcher(
        db, ah_config(scann_torch, db, "dot_product", "reconstruct",
                      "float32"), "cuda")
    torch.cuda.synchronize()
    flat_build_s = time.perf_counter() - t0
    if flat.partitioner is not None or flat._recon_rows is None:
        raise AssertionError("the no-tree searcher has a tree, or its "
                             "full-scan rows were not built with it")
    flat.stage_hook = timer
    idx, dist, wall, stages, launched = timed_search(
        torch, flat, timer, queries, lambda: fused_scan.launches)
    flat.stage_hook = None
    check_results(queries, db, idx, dist, "reconstruct without a tree", True)
    k5["launches"] = fused_scan.launches
    if launched == 0 or pruned_scan.launches != k2["launches"]:
        raise AssertionError("the no-tree reconstruct search did not go "
                             "through K5 alone")
    no_tree = {"build_s": flat_build_s, "recall": recall_at_k(idx, truth),
               "qps": N_QUERY / wall, "k5_launches": launched,
               "slots": flat._recon_rows.shape[0], "stage_ms": stages}
    log(f"reconstruct without a tree (build {flat_build_s:.1f} s, "
        f"{no_tree['slots']} slots): recall@10 {no_tree['recall']:.4f}, qps "
        f"{no_tree['qps']:.0f}, K5 launches {launched}, stage ms {stages}")
    if no_tree["recall"] < RECON_FULL_SCAN_FLOOR:
        raise AssertionError(f"no-tree reconstruct recall@10 "
                             f"{no_tree['recall']:.4f} is under "
                             f"{RECON_FULL_SCAN_FLOOR}")
    # leaves_to_search=0 is the searcher's own default: a full scan.
    cross_check(scann_torch, flat, queries, "reconstruct without a tree",
                leaves_to_search=0)
    return k2, k5, {"build_s": build_s, "points": points, "full_scan": full,
                    "no_tree": no_tree,
                    "k5_composition_ms": composition_ms,
                    "d_pad": rows.shape[1],
                    "pruned_rows_mb": pruned_b / 1e6,
                    "full_scan_rows_mb": scan_b / 1e6}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scann_torch
    from scann_torch import _cuda
    from scann_torch.ops import pruned_scan
    from scann_torch.ops import pruned_sq

    # 1. card
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. kernels
    t0 = time.perf_counter()
    msgs = _cuda.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, text in msgs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. main-path index and ground truth
    t0 = time.perf_counter()
    db, queries = make_glove_like(N_DB, N_QUERY, DIM)
    log(f"corpus {db.shape} + {queries.shape} in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    searcher = (scann_torch.builder(db, K, "dot_product")
                .tree(num_leaves=NUM_LEAVES,
                      num_leaves_to_search=LEAVES_TO_SEARCH,
                      training_sample_size=TRAIN_SAMPLE)
                .score_brute_force(quantize="int8").build())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index_bytes = sum(t.numel() * t.element_size() for t in (
        searcher.slot_rows, searcher.slot_scale, searcher._bias2,
        searcher.slot_leaf, searcher.slot_dpid, searcher._p_tile_start,
        searcher._p_ntiles, searcher.partitioner.centers))
    nl = searcher.partitioner.num_leaves
    log(f"build {build_s:.1f} s: {nl} leaves, max_ntiles "
        f"{searcher._p_max_ntiles}, {searcher._p_num_tiles} tiles, index "
        f"{index_bytes / N_DB:.1f} B/vector")
    t0 = time.perf_counter()
    bf = scann_torch.builder(db, K, "dot_product").score_brute_force().build()
    truth, _ = bf.search_batched(queries)
    del bf
    log(f"ground truth (f32 brute force) in {time.perf_counter() - t0:.1f} s")

    # 4. kernel phase: K1 against its plain version at main-path inputs
    q_dev = torch.as_tensor(queries, device="cuda")
    k1 = {}
    k6 = {"launches": 0}
    for measure_l2, kpg in ((False, 4), (True, 4), (False, 8), (True, 8)):
        plan, qg_rows, bias = k1_inputs(torch, searcher, q_dev,
                                        LEAVES_TO_SEARCH, measure_l2)
        args = (plan, qg_rows, searcher.slot_rows, searcher.slot_scale, bias)
        got = pruned_sq.score_work_sq(*args, measure_l2=measure_l2, kpg=kpg)
        want = pruned_sq.score_work_torch_sq(*args, measure_l2=measure_l2,
                                             kpg=kpg)
        torch.cuda.synchronize()
        err, ident = compare_packed(torch, "K1", got, want, plan,
                                    atol=K1_ATOL)
        k1["max_abs_err"] = max(k1.get("max_abs_err", 0.0), err)
        log(f"K1 vs plain ({'l2' if measure_l2 else 'dot'}, kpg {kpg}): "
            f"max |err| {err:.3g}, identities agree {ident:.6f}, "
            f"w_pad {plan.work_tile.shape[0]}, active "
            f"{int(plan.work_active.sum())}")
        if not measure_l2 and kpg == 4:   # the main path's case
            k1["ms"] = time_ms(torch, lambda: pruned_sq.score_work_sq(
                *args, measure_l2=False, kpg=4))
            k1["plain_ms"] = time_ms(
                torch, lambda: pruned_sq.score_work_torch_sq(
                    *args, measure_l2=False, kpg=4))
            k1["bound_ms"], k1["bound_by"], n_act = k1_bound(
                plan, searcher.slot_rows, kpg)
            log(f"K1 at leaves={LEAVES_TO_SEARCH}, {N_QUERY} queries: "
                f"{k1['ms']:.3f} ms (plain {k1['plain_ms']:.3f} ms), bound "
                f"{k1['bound_ms']:.4f} ms by {k1['bound_by']} "
                f"({n_act} active items)")
            k6_check(torch, k6, "tree_sq", plan, got, searcher._p_ntiles,
                     searcher.slot_rows.shape[1], K, searcher._p_max_ntiles)
        del got, want, plan, qg_rows, bias, args
    torch.cuda.empty_cache()
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            wide_checks(torch, "k1", (384, 768), (4, 8)))
    d_pad = searcher.slot_rows.shape[-1]
    k1["occupancy"] = _cuda.occupancy("pruned_sq", d_pad, 4)
    if k1["occupancy"]["smem_bytes"] != pruned_scan.tile_smem_bytes("int8",
                                                                     4):
        raise AssertionError("K1's shared memory differs from "
                             "tile_smem_bytes")

    # 5. main path through the public entry points
    timer = StageTimer(torch)
    searcher.stage_hook = timer
    pruned_sq.launches = 0
    points = []
    for leaves in SWEEP + (nl,):
        idx, dist, wall, stages, launched = timed_search(
            torch, searcher, timer, queries, lambda: pruned_sq.launches,
            leaves_to_search=leaves)
        check_results(queries, db, idx, dist, f"leaves={leaves}", True)
        if leaves < nl and launched == 0:
            raise AssertionError(f"leaves={leaves} did not launch K1")
        points.append({"leaves": leaves, "recall": recall_at_k(idx, truth),
                       "qps": N_QUERY / wall, "k1_launches": launched,
                       "stage_ms": stages})
        log(f"leaves={leaves}: recall@10 {points[-1]['recall']:.4f}, qps "
            f"{N_QUERY / wall:.0f}, K1 launches {launched}, stage ms "
            f"{stages}")
    searcher.stage_hook = None
    k1["launches"] = pruned_sq.launches
    if k1["launches"] == 0:
        raise AssertionError("the main path never launched K1")
    at100 = next(p for p in points if p["leaves"] == 100)["recall"]
    if at100 < RECALL_FLOOR_AT_100:
        raise AssertionError(f"recall@10 {at100:.4f} at leaves=100 is under "
                             f"{RECALL_FLOOR_AT_100}")

    pruned_scan.launches_merge = 0
    sq_merges = fused_merge_points(
        torch, searcher, timer, queries, db, truth, "tree-SQ", True,
        leaves_to_search=LEAVES_TO_SEARCH)
    k6["launches"] += pruned_scan.launches_merge

    cross_check(scann_torch, searcher, queries, "tree-SQ")
    del searcher
    torch.cuda.empty_cache()

    # 6. tree-AH
    k3, k4, ah_summary = tree_ah_phase(torch, scann_torch, db, queries,
                                       truth, q_dev, k6)

    # 7. tree-AH in reconstruct mode
    k2, k5, recon_summary = recon_phase(torch, scann_torch, db, queries,
                                        truth, q_dev)

    # K6 at the widest row a scorer writes; the fault-3a guards.
    k6["widest_row"] = k6_wide_check(torch)
    k6["occupancy"] = {w: _cuda.occupancy("merge_groups", w)
                       for w in (128, 256, k6["widest_row"])}
    guard_checks(scann_torch)

    # K6's line: the tree-AH block (the wider rows, k 30); both blocks'
    # numbers are in the summary.
    k6.update(k6["tree_ah"])
    summary = {"build_s": build_s, "num_leaves": nl,
               "index_bytes_per_vector": index_bytes / N_DB,
               "points": points, "merge": sq_merges, "tree_ah": ah_summary,
               "reconstruct": recon_summary,
               "k6": {b: k6[b] for b in ("tree_sq", "tree_ah")}}
    log("summary " + json.dumps(summary))
    # What the card makes of the six kernels at the main path's shapes
    # (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerSM); K6 at
    # tree-SQ's and tree-AH's row widths and at the widest.
    log("occupancy " + json.dumps({
        "pruned_sq": {"d_pad": d_pad, "kpg": 4, **k1["occupancy"]},
        "pruned_rows": {"d_pad": recon_summary["d_pad"], "kpg": 8,
                        **k2["occupancy"]},
        "pruned_lut": {"b_pad": ah_summary["b_pad"], **k3["occupancy"]},
        "pruned_codes": {"d_pad": ah_summary["k4_d_pad"], "dpb": 2,
                         "kpg": 8, **k4["occupancy"]},
        "fused_scan": {"d_pad": recon_summary["d_pad"],
                       **k5["occupancy"]},
        "merge_groups": {f"w {w}": o
                         for w, o in k6["occupancy"].items()}}))
    # library_ms is None for all six: no single PyTorch call computes a
    # gathered tile x query-group score with a packed per-32-slot top-k
    # (K1-K4), a product reduced to per-group maxima without the score
    # matrix (K5: the matmul + amax / argmax composition is timed above),
    # or k masked-maximum passes over rewritten keys (K6).
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"scann_torch/csrc/{name}.cu", "replaces": replaces,
         "launches": rec["launches"], "max_abs_err": rec["max_abs_err"],
         "ms": rec["ms"], "plain_ms": rec["plain_ms"],
         "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
         "library_ms": None, "design": design}
        for name, replaces, rec, design in (
            ("pruned_sq", "scann_tpu/ops/pruned_sq.py:43", k1, TILE_MMA),
            ("pruned_rows", "scann_tpu/ops/pruned_scan.py:297", k2, TILE_MMA),
            ("pruned_lut", "scann_tpu/ops/pruned_lut.py:225", k3,
             "mma.sync m16n8k32 s8, one-hot operand in registers"),
            ("pruned_codes", "scann_tpu/ops/pruned_lut.py:75", k4,
             TILE_MMA + ", codes decoded in shared memory"),
            ("fused_scan", "scann_tpu/ops/fused_scan.py:58", k5,
             "wgmma m64n256k16 bf16, 4-stage cp.async ring"),
            ("merge_groups", "scann_tpu/ops/pruned_scan.py:705", k6,
             "keys in registers, redux.sync passes"))]}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
