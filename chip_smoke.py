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
     card's bound for the same work;
  5. main path: search_batched over all queries at leaves 50, 80, 100, 150
     and the full scan with recall@10, QPS and per-stage times, and a
     16-query cross-check of the CUDA path against the CPU plain path on
     the same (serialized) index;
  6. the kernels JSON line, the card line, and the final ok line.
Exits non-zero without CUDA, and in a directory without the scann_torch
package.
"""

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
# Peaks of one H100 SXM (NVIDIA data sheet; dense tensor-core bf16).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# K1 vs plain version: unpacked values within 2^-14 relative (the 2^-15
# identity perturbation plus summation order; int8 x bf16 products are
# exact in f32) with a 1e-6 floor for sums that cancel to near zero, and
# packed identities equal on >= 99.9% of survivors.
K1_RTOL, K1_ATOL, K1_MIN_ID_AGREE = 2.0 ** -14, 1e-6, 0.999
TIMING_REPS = 20

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


def k1_inputs(torch, searcher, queries, leaves, measure_l2):
    """The exact K1 inputs the main path builds for this batch."""
    from scann_torch.ops import pruned_scan
    part = searcher.partitioner
    nq = queries.shape[0]
    leaf_ids, _ = part.tokenize_queries(queries, leaves)
    valid = torch.ones((nq, leaves), dtype=torch.bool, device=queries.device)
    g_pad, w_pad = pruned_scan.plan_capacities(
        nq, leaves, part.num_leaves, searcher._p_num_tiles,
        searcher._p_max_ntiles)
    plan = pruned_scan.invert(leaf_ids, valid, searcher._p_tile_start,
                              searcher._p_ntiles, searcher._p_max_ntiles,
                              g_pad, w_pad)
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


def k1_bound(plan, rows3, kpg):
    """Least time (ms) for the K1 work of this plan on one H100: bytes of
    each distinct input read once (active tiles' rows, scale, bias; active
    groups' queries; the work tables) and each active output segment
    written once, vs the bf16 tensor-core time of the active products."""
    active = plan.work_active.bool()
    n_active = int(active.sum())
    tiles = int(plan.work_tile[active].unique().numel())
    mnt = plan.work_tile.shape[0] // plan.qg_query.shape[0]
    groups = int(active.reshape(-1, mnt).any(1).sum())
    tile, d_pad = rows3.shape[1], rows3.shape[2]
    nbytes = (tiles * tile * (d_pad + 8) + groups * 128 * d_pad * 2
              + plan.work_tile.shape[0] * 8
              + n_active * 128 * kpg * (tile // 32) * 4)
    flops = 2.0 * n_active * tile * 128 * d_pad
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_active)


def compare_k1(torch, got, want, plan):
    """Hold the kernel's output against the plain version's on active
    segments; returns (max_abs_err, identity agreement)."""
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
    err = (va.double() - vb.double()).abs()
    tol = K1_RTOL * vb.double().abs() + K1_ATOL
    bad = int((err > tol).sum())
    ident = float(((a & pruned_scan._ID_MASK)
                   == (b & pruned_scan._ID_MASK)).double().mean())
    if bad or ident < K1_MIN_ID_AGREE or not torch.isfinite(va).all():
        raise AssertionError(
            f"K1 disagrees with its plain version: {bad} of {a.numel()} "
            f"survivors out of tolerance, identities agree {ident:.6f}")
    return float(err.max()), ident


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scann_torch
    from scann_torch import _cuda
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
    for measure_l2, kpg in ((False, 4), (True, 4), (False, 8), (True, 8)):
        plan, qg_rows, bias = k1_inputs(torch, searcher, q_dev,
                                        LEAVES_TO_SEARCH, measure_l2)
        args = (plan, qg_rows, searcher.slot_rows, searcher.slot_scale, bias)
        got = pruned_sq.score_work_sq(*args, measure_l2=measure_l2, kpg=kpg)
        want = pruned_sq.score_work_torch_sq(*args, measure_l2=measure_l2,
                                             kpg=kpg)
        torch.cuda.synchronize()
        err, ident = compare_k1(torch, got, want, plan)
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
        del got, want, plan, qg_rows, bias, args
    torch.cuda.empty_cache()

    # 5. main path through the public entry points
    timer = StageTimer(torch)
    searcher.stage_hook = timer
    pruned_sq.launches = 0
    points = []
    for leaves in SWEEP + (nl,):
        searcher.search_batched(queries, leaves_to_search=leaves)  # warm-up
        before = pruned_sq.launches
        torch.cuda.synchronize()
        timer.start()
        t0 = time.perf_counter()
        idx, dist = searcher.search_batched(queries, leaves_to_search=leaves)
        wall = time.perf_counter() - t0
        stages = timer.stage_ms()
        r = recall_at_k(idx, truth)
        if idx.shape != (N_QUERY, K) or not np.isfinite(dist).all():
            raise AssertionError(f"bad results at leaves={leaves}: shape "
                                 f"{idx.shape}, finite "
                                 f"{np.isfinite(dist).mean()}")
        exact = np.einsum("qd,qkd->qk", queries, db[idx])
        if np.abs(exact - dist).max() > 2e-2:
            raise AssertionError(f"distances at leaves={leaves} are not the "
                                 f"dot products of the returned rows")
        launched = pruned_sq.launches - before
        if leaves < nl and launched == 0:
            raise AssertionError(f"leaves={leaves} did not launch K1")
        points.append({"leaves": leaves, "recall": r, "qps": N_QUERY / wall,
                       "k1_launches": launched,
                       "stage_ms": {k: round(v, 3) for k, v in stages.items()}})
        log(f"leaves={leaves}: recall@10 {r:.4f}, qps {N_QUERY / wall:.0f}, "
            f"K1 launches {launched}, stage ms {points[-1]['stage_ms']}")
    searcher.stage_hook = None
    k1["launches"] = pruned_sq.launches
    if k1["launches"] == 0:
        raise AssertionError("the main path never launched K1")
    at100 = next(p for p in points if p["leaves"] == 100)["recall"]
    if at100 < RECALL_FLOOR_AT_100:
        raise AssertionError(f"recall@10 {at100:.4f} at leaves=100 is under "
                             f"{RECALL_FLOOR_AT_100}")

    # Cross-check: the same index, serialized and searched on the CPU plain
    # path, returns what the CUDA path returns for a few queries.
    with tempfile.TemporaryDirectory() as tmp:
        searcher.serialize(tmp)
        cpu = scann_torch.load_searcher(tmp, device="cpu")
        i_cpu, d_cpu = cpu.search_batched(queries[:16],
                                          leaves_to_search=LEAVES_TO_SEARCH)
    i_gpu, d_gpu = searcher.search_batched(queries[:16],
                                           leaves_to_search=LEAVES_TO_SEARCH)
    agree = float(np.mean(i_cpu == i_gpu))
    same = i_cpu == i_gpu
    if agree < 0.99 or not np.allclose(d_cpu[same], d_gpu[same], rtol=1e-4):
        raise AssertionError(f"CUDA and CPU paths disagree: ids {agree:.4f}")
    log(f"CUDA vs CPU plain path on 16 queries: ids agree {agree:.4f}")

    summary = {"build_s": build_s, "num_leaves": nl,
               "index_bytes_per_vector": index_bytes / N_DB,
               "points": points}
    log("summary " + json.dumps(summary))
    log(json.dumps({"kernels": [{
        "name": "pruned_sq", "route": "cuda",
        "source": "scann_torch/csrc/pruned_sq.cu",
        "replaces": "scann_tpu/ops/pruned_sq.py:43",
        "launches": k1["launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}]}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
