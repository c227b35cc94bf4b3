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
     and the full scan with recall@10, QPS and per-stage times (every
     pruned batch must launch K1 and the plan kernels), and a
     16-query cross-check of the CUDA path against the CPU plain path on
     the same (serialized) index;
  6. tree-AH (bench.py's tree + AH + reorder config on the same corpus:
     score_ah(2, anisotropic threshold 0.2), reorder(100)): three builds
     (int8 lookup with float32 reorder, the same with residual-int8
     reorder, float32 lookup); the plan kernels (csrc/pruned_plan.cu,
     through pruned_scan.work_plan) on the int8-lookup index's own
     operands at leaves 100 (the glove cell's shape) against plain invert
     on the same operands, every field bit-equal, both timed with the
     plan's byte bound; K3 and K4 against their plain versions at
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
  9. the widths the card once refused: a GIST-960-shaped corpus
     (make_sift_like below at 960 dimensions, the public
     gist-960-euclidean's width; GIST_ROWS rows, cut from its 1,000,000
     so the phase fits the script's time limit; its 1,000 queries),
     squared L2, with exact float32 ground truth: a tree-AH int8-lookup
     index (K3 at b_pad 480 against its plain version, 8 and 16
     survivors, timed with its bound; one search that must launch K3)
     and a no-tree reconstruct index (K5 against its plain version at the
     index's d_pad 1024 and at d 960, timed with its bound; one search
     that must launch K5), each cross-checked against the CPU plain path
     on its own serialization;
 10. the tree-SQ + reorder main path (benchmarks/extra_configs.py config
     3b): make_sift_like(1,000,000, 10,000, 128), squared L2, exact
     float32 ground truth, tree(2000 leaves, 100 to search, 100,000
     training samples) + score_brute_force("int8"), alone (there also
     the plan kernels at leaves 8, the SIFT cell's shape, held and timed
     as in phase 6) and with an exact float32 reorder(40), swept at
     leaves 8 / 16 / 40 / 100 with
     recall@10, QPS and stage times; every point must launch K1, and
     recall@10 at leaves=8 with the reorder must reach
     SIFT_RECALL_FLOOR_AT_8; the reorder index is cross-checked against
     the CPU plain path;
 11. one search each of the other score_brute_force compositions on the
     phase-3 corpus at full size, with recall@10 against its float32
     truth and QPS: int8 and bfloat16 brute force, Tree-X float32 and
     bfloat16 leaves at leaves=100 (the dense masked scan), cosine brute
     force; and L1 brute force on 1,000 queries, its top 10 checked
     against a numpy L1 top-10 on L1_CHECKED queries;
 12. the search features (ROADMAP item 14) on the phase-3 corpus:
     benchmarks/extra_configs.py config 4 (tree(2000 leaves, 40 to
     search, SOAR lambda 1.5) + score_ah(2, 0.2) + reorder(150), int8
     lookup: K3) with and without SOAR, at its own 100,000 training
     samples and at bench.py's 250,000 (the floor holds the latter; see
     SOAR_RECALL_FLOOR), each with recall@10, QPS, stage times, build
     seconds and bytes per vector, no repeated id in any row, and the
     dedup timed on its own inputs; K3 bit-equal to its plain version on
     the SOAR layout; on the 250,000-sample SOAR index every search
     parameter held by rule on every row (per-query final_num_neighbors
     and pre_reorder_num_neighbors, both epsilons, crowding with
     attribute id % 1000 and caps of 2 before and after the reorder,
     each filter timed, pre_tokenized_leaves equal to the tokenizer's);
     the same SOAR config in reconstruct mode (K2 at 40 leaves and K5 on
     the full scan, each held against its plain version); and the phase-3
     tree-SQ config with learned multiplicative query spilling, int8
     centroids and hierarchical_top=45 (K1; mean leaves searched;
     cross-checked against the CPU);
 13. data and encodings (ROADMAP items 11, 13, 16), each part with
     recall@10, QPS, stage ms, build seconds and index bytes a vector:
     a. phase 10's corpus rounded and clipped to uint8: tree-SQ (config 3b
        without the reorder, K1 at its leaves sweep, K1 held against its
        plain version on the typed plan) beside the same values cast to
        float32, both built deterministically (ids >= 99.9% equal, recall
        within 0.001), and uint8 brute force on 1,000 queries (rows 1 B a
        dimension);
     b. phase 9's corpus and tree with pca(128) (K3 at b_pad 64, bit-equal
        to its plain version) and opq() (out 960, b_pad 480; recall no
        lower than phase 9's less 0.01) + tree-AH int8 + reorder(100)
        against the original rows;
     c. bench.py's tree-AH config on the phase-3 corpus with stacked codes
        and with variable_dims_per_block=[4]*10+[2]*30 in reconstruct mode
        (K2 at leaves 100, K5 on the full scan, each held against its plain
        version) and in int8 lookup (the dense scan, 1,000 queries), and
        the one-leaf tree in reconstruct mode (a K5 full scan, recall@10
        >= 0.985);
     d. a SPLADE-shaped sparse corpus (1,000,000 CSR rows over 30,522
        terms, about 120 Zipf-distributed terms a row; 1,000 queries of
        about 40): sparse_searcher's default (K3, exact host rescore)
        against the exact product (cuSPARSE), and SparseExactSearcher on
        100,000 rows for 100 queries;
 14. mutation and health (ROADMAP item 15) on the phase-3 corpus with
     bench.py's tree-AH config and docids "d{i}": a. an int8-lookup index
     built on the first MUT_BASE rows takes the held-out rows (10 upsert
     batches, the last ones past the free slots, so the layout grows),
     100,000 deletes (10 batches), 10,000 updates with other rows'
     vectors and 1,000 re-inserts, each batch timed with the first
     1,000-query search after it (the pruned-layout rebuild apart); then
     all 10,000 queries at leaves 100 / 100 candidates (must launch K3;
     K3 bit-equal to its plain version on the mutated plan), recall@10
     against exact float32 brute force over the live rows, no deleted
     docid back, every result a live docid; e. that index serialized
     with its docids and mutation state, reloaded on the card and on the
     CPU (the same docids on 16 queries); d. its rebalance(), timed, and
     the mutated index's recall within MUT_MAX_RECALL_LOSS of the rebuilt
     one's; b. the same sequence on the reconstruct index (K2 at leaves
     100, K5 on the full scan, each held against its plain version); c.
     an online_incremental index (threshold MUT_INCREMENTAL): skewed
     upserts until a split fires, deletes that drain a leaf until a merge
     fires, each leaf count as the rule predicts from the counts, the
     weighted imbalance lower after the split, recall within
     MUT_INCREMENTAL_MAX_LOSS of its rebalance's; f. float32 and int8
     brute force with docids against numpy exact;
 15. the entry points (ROADMAP items 17, 18 and 20) on the phase-3
     corpus: a. searcher_from_pbtxt of bench.py's tree-SQ config as a
     reference text proto (its config equal to the builder's, K1 at
     leaves 100, recall@10 >= RECALL_FLOOR_AT_100); b. autopilot(), tree-AH
     (K3, recall@10 >= AH_RECALL_FLOOR_AT_100) and engine="tree_sq" (K1,
     diagnostic against its 0.95 target); c. phase 6's int8-lookup index,
     written by save_reference_assets in phase 6, reloaded on the card
     (ids >= 99.9% equal to the live index's at leaves 100 / 100
     candidates, K3) and the residual-int8-reorder index's refusal; d.
     serve() of phase 5's serialized index: 2,000 single /search calls
     from 32 client threads and one octet-stream /search_batched of all
     queries, each answer against search_batched (ids >= 99.9%, distances
     within 1e-5 relative where the ids agree), with the dispatch and
     finalize times of search_batched_async; f. a torch.profiler trace of
     one tree-SQ search (device-busy and idle share, the longest device
     operations); e. save_exported_searcher of tree-SQ at leaves 100 (K1)
     and tree-AH int8 at leaves 100 / 100 (K3), and of indexes of the
     first EXPORT_ROWS rows: reconstruct at leaves 100 (K2) and full scan
     (K5), float32 lookup (K4), tree-SQ with the fused merge (K6); each
     reloaded in a fresh process that imports only scann_torch.export,
     its ids >= 99.9% equal to the live searcher's, its launches counted
     there;
 16. the sharded index (ROADMAP item 19) on a (1, 1) NCCL DeviceMesh: a.
     ShardedTreeAHSearcher.from_searcher of phase 6's residual-int8
     tree-AH index (recall@10 at leaves 100 / 100 candidates >= phase 6's
     reading less SHARDED_AH_SLACK) and b. of phase 5's tree-SQ index (sq
     format, leaves 100, >= phase 5's less SHARDED_SQ_SLACK); c.
     build_sharded of bench.py's tree-AH and tree-SQ configs (phases 6's
     and 5's floors, build seconds); d. serialize -> load_sharded (ids
     equal on every query); e. upsert of the queries as 10,000 new rows
     (each its own first result) and delete of 10,000 ids (none
     returned); f. a restrict allowlist of even ids (only even ids).  It
     launches none of the seven kernels (the JAX sharded path reaches no
     Pallas call);
then the occupancy line of the seven kernels (registers a thread, dynamic
shared memory a block, resident blocks an SM, at the main path's shapes;
K3 and K5 also at the widths of phase 9; the plan's four kernels with
their static shared memory), the kernels JSON line (with each kernel's
launches in phases 12-16), the card line, and
the final ok line.
Exits non-zero without CUDA, and in a directory without the scann_torch
package.
"""

import atexit
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

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
# Phase 9: the GIST-960 shape.  Rows cut from gist-960-euclidean's
# 1,000,000 to fit the script's time limit; its 1,000 queries.
GIST_DIM, GIST_ROWS, GIST_QUERIES = 960, 200_000, 1_000
GIST_TREE = dict(num_leaves=400, num_leaves_to_search=40,
                 training_sample_size=100_000)
# Phase 10: benchmarks/extra_configs.py config 3b.  Floor: the TPU
# reference's recall@10 0.9940 at leaves=8 (BENCH_EXTRA.md, secondary
# configs) less the 1 pt build-to-build spread and 0.5 pt for the RNG.
SIFT_N, SIFT_Q, SIFT_D = 1_000_000, 10_000, 128
SIFT_TREE = dict(num_leaves=2000, num_leaves_to_search=100,
                 training_sample_size=100_000)
SIFT_SWEEP = (8, 16, 40, 100)
SIFT_REORDER = 40
SIFT_RECALL_FLOOR_AT_8 = 0.979
# Phase 11: L1 brute force runs on this many queries, and this many of
# them are checked against a numpy L1 top-10 (each a full pass over the
# corpus on the host).
L1_QUERIES, L1_CHECKED = 1_000, 20
# Phase 12: benchmarks/extra_configs.py config 4 on the bench corpus,
# searched at 40 leaves, at its own 100,000 training samples and at
# bench.py's 250,000.  The first is about one sample per topic of this
# corpus, which leaves k-means a near-arbitrary partition
# (BENCH_EXTRA.md, "the k-means sampling lesson"); the TPU reference's
# 0.9974 (BENCH_EXTRA.md, secondary configs) was measured on the round-3
# corpus that the current one superseded.  So the recall floor holds the
# 250,000-sample build: the first card value less the 1 pt build-to-build
# spread.  At either sample SOAR may lose at most 0.002 to the same index
# without it.
SOAR_TREE = dict(num_leaves=2000, num_leaves_to_search=40)
SOAR_TRAIN_DEFINED, SOAR_TRAIN = 100_000, 250_000
SOAR_LAMBDA, SOAR_LEAVES, SOAR_REORDER = 1.5, 40, 150
SOAR_RECALL_FLOOR = 0.9524   # first card run: 0.9624 (PERF.md section 5)
SOAR_MAX_LOSS = 0.002
SOAR_K5_QUERIES = 2_000       # K5 against its plain version on these
# The exact rescore of one candidate list is a float32 batched product
# whose summation order follows the list's width, so rescoring the same
# candidates at widths 20 and 150 may differ in the last bits: two
# results within that much of each other may trade places.
RESCORE_RTOL = 1e-6
CROWDING_ATTRS, CROWDING_CAP = 1000, 2   # attribute id % 1000, cap 2
HIERARCHICAL_TOP = 45         # 45 x 45 = 2,025 leaves

# Phase 15: the entry points.  Exported programs take 1,024-query
# buckets; the indexes of K2, K4, K5 and K6's exports are built on the
# corpus's first EXPORT_ROWS rows.  Served, reloaded and exported answers
# agree with the live searcher on ENTRY_ID_AGREE of ids, distances within
# ENTRY_DIST_RTOL where the ids agree.
EXPORT_BUCKET, EXPORT_ROWS = 1024, 100_000
SERVE_SINGLE, SERVE_CLIENTS = 2_000, 32
ENTRY_ID_AGREE, ENTRY_DIST_RTOL = 0.999, 1e-5
AUTOPILOT_SQ_TARGET = 0.95
# bench.py's tree-SQ config (bench.py:269-273) as a reference ScannConfig
# text proto.
TREE_SQ_PBTXT = """
num_neighbors: 10
distance_measure { distance_measure: "DotProductDistance" }
partitioning {
  num_children: 2000
  min_cluster_size: 50
  max_clustering_iterations: 12
  single_machine_center_initialization: RANDOM_INITIALIZATION
  query_spilling {
    spilling_type: FIXED_NUMBER_OF_CENTERS
    max_spill_centers: 100
  }
  expected_sample_size: 250000
  partitioning_type: GENERIC
  query_tokenization_type: FLOAT
}
brute_force { fixed_point { enabled: true } }
"""

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


# The tree-SQ + reorder corpus: a verbatim copy of
# benchmarks/extra_configs.make_sift_like; tests/test_torch_isolation.py
# holds the two equal.
def make_sift_like(n=1_000_000, nq=10_000, d=128, seed=0):
    """SIFT-ish: non-negative, un-normalized, *hierarchical* cluster
    structure (topics -> subtopics -> points) so nearest neighbors are
    genuinely close — flat noise-only mixtures make the true top-10
    near-equidistant at 1M scale, which no fixed-bit quantizer (ours or
    the reference's) can rank."""
    rng = np.random.default_rng(seed)
    n_topics, subs_per_topic = 1024, 40
    topics = rng.gamma(2.0, 20.0, (n_topics, d)).astype(np.float32)
    sub_offsets = 6.0 * rng.standard_normal(
        (n_topics * subs_per_topic, d)).astype(np.float32)

    def draw(m, s2):
        r = np.random.default_rng(s2)
        sub = r.integers(0, n_topics * subs_per_topic, m)
        x = (topics[sub // subs_per_topic] + sub_offsets[sub]
             + 1.5 * r.standard_normal((m, d)).astype(np.float32))
        return np.maximum(x, 0.0).astype(np.float32)

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


def plan_operands(searcher, queries, leaves):
    """The operands of the main path's plan for this batch, as its
    _pruned_select makes them: (leaf ids and their valid mask from the
    partitioner's select_leaves, tile starts, tile counts, max tiles,
    g_pad)."""
    from scann_torch.ops import pruned_scan
    part = searcher.partitioner
    leaf_ids, valid, _ = part.select_leaves(queries, leaves, None)
    lay = searcher._layout
    g_pad, _ = pruned_scan.plan_capacities(
        queries.shape[0], leaves, part.num_leaves, lay.num_tiles,
        lay.max_ntiles)
    return (leaf_ids, valid, lay.tile_start, lay.ntiles, lay.max_ntiles,
            g_pad)


def pruned_plan(torch, searcher, queries, leaves):
    """The work plan the main path builds for this batch (the plan kernels
    on the card, plain invert on the CPU)."""
    from scann_torch.ops import pruned_scan
    return pruned_scan.work_plan(*plan_operands(searcher, queries, leaves))


def plan_bound_bytes(p, nl, g_pad, w_pad):
    """The plan's bytes read and written once: sel (4 B) and valid (1 B) a
    pair, the two leaf tables, qg_query and qg_leaf a group, the three
    work tables an item, pair_gid and pair_row a pair."""
    return 5 * p + 8 * nl + g_pad * (4 * 128 + 4) + 12 * w_pad + 8 * p


def plan_check(torch, searcher, queries, leaves, what):
    """The plan of the main path's operands (pruned_scan.work_plan: the
    plan kernels on CUDA tensors) against plain invert on the same
    operands, every WorkPlan field bit for bit; on the card also both
    timed and the byte bound.  Returns the record."""
    from scann_torch.ops import pruned_scan
    ops = plan_operands(searcher, queries, leaves)
    g_pad, mnt = ops[-1], ops[-2]
    w_pad = g_pad * mnt
    before = pruned_scan.launches_plan
    got = pruned_scan.work_plan(*ops)
    launched = pruned_scan.launches_plan - before
    want = pruned_scan.invert(*ops, w_pad)
    for name, g, w in zip(pruned_scan.WorkPlan._fields, got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"plan of {what}: {name} differs from "
                                 f"invert")
    b, l = ops[0].shape
    nl = ops[2].shape[0]
    rec = {"queries": b, "leaves": l, "num_leaves": nl, "max_ntiles": mnt,
           "g_pad": g_pad, "invalid": int((~ops[1]).sum()),
           "bit_equal": True, "max_abs_err": 0.0,
           "launches": launched}
    if queries.is_cuda:
        if launched != 1:
            raise AssertionError(f"plan of {what}: {launched} plan kernel "
                                 f"calls, want 1")
        rec["ms"] = time_ms(torch, lambda: pruned_scan.work_plan(*ops))
        rec["plain_ms"] = time_ms(torch, lambda: pruned_scan.invert(
            *ops, w_pad), reps=PLAIN_TIMING_REPS)
        rec["bound_ms"], rec["bound_by"] = _bound(
            plan_bound_bytes(b * l, nl, g_pad, w_pad), 0.0)
        log(f"plan of {what} ({b} x {l} of {nl} leaves, max_ntiles {mnt}, "
            f"{rec['invalid']} invalid entries): bit-equal to invert; "
            f"{rec['ms']:.3f} ms (plain invert {rec['plain_ms']:.3f} ms), "
            f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}")
    return rec


def k1_inputs(torch, searcher, queries, leaves, measure_l2):
    """The exact K1 inputs the main path builds for this batch."""
    part = searcher.partitioner
    plan = pruned_plan(torch, searcher, queries, leaves)
    d_pad = searcher.slot_rows.shape[-1]
    q_bf = torch.nn.functional.pad(
        queries, (0, d_pad - queries.shape[1])).to(torch.bfloat16)
    qg_rows = q_bf[plan.qg_query.long()]
    bias = searcher._layout.bias
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
    """The exact K3 / K4 inputs of the main path for this batch (queries
    in the index's space, projected where it has a projection): (plan,
    the batch's bf16 queries (K3) or the gathered query groups (K4),
    codes, codebook table, squared norms (K3) or mean (K4), bias).  A squared-L2 case on a dot-product index takes the mean of
    its decoded rows, as an L2 index has, centers the queries on it and
    derives the tables for it, as the searcher does once per index."""
    from scann_torch.ops import pruned_lut
    searcher._ensure_pruned()
    plan = pruned_plan(torch, searcher, queries, leaves)
    mean = searcher._p_mean
    d_pad = mean.shape[0]
    dims = searcher._index_dims
    if measure_l2 and searcher._recon_mean is None:
        mean = torch.zeros_like(mean)
        mean[:dims] = searcher._decode_mean()
    q = queries - mean[None, :dims]
    q_bf = torch.nn.functional.pad(q, (0, d_pad - q.shape[1])).to(
        torch.bfloat16)
    if searcher._int8_lut:
        tables = pruned_lut.lut_tables(
            searcher.model.codebook.to(mean.device), mean,
            d_pad // searcher.model.dims_per_block, measure_l2=measure_l2)
    else:
        tables = (searcher._p_cb, mean)
    q_in = q_bf if searcher._int8_lut else q_bf[plan.qg_query.long()]
    return (plan, q_in, searcher._p_codes, *tables, searcher._layout.bias)


def k3_plain(plan, q_bf, *rest, **kw):
    """K3's plain version on ah_inputs' arguments (it takes the gathered
    query groups)."""
    from scann_torch.ops import pruned_lut
    return pruned_lut.score_work_torch_lut(
        plan, q_bf[plan.qg_query.long()], *rest, **kw)


def k3_bound(plan, nq, codes3p, dpb, kpg):
    """Least time (ms) for the K3 work of this plan on one H100.  Bytes:
    each distinct input once (active tiles' packed codes and bias, the
    batch's nq bf16 queries, the compact codebook and norms, the work
    tables and the group-row -> query map) and each active output segment
    once.  Operations: each query's LUT product (a LUT depends only on
    the query and the codebook) at the bf16 tensor-core peak plus one
    int8 LUT entry added per (slot, block, query) of each active item at
    the int8 peak.  The lookup itself is a table read, no arithmetic: the
    one-hot matmul the TPU kernel spends on it is not work the function
    needs."""
    n_active, tiles, groups = plan_counts(plan)
    tile, b2 = codes3p.shape[1], codes3p.shape[2]
    w, d_pad = b2 * 2 * 16, b2 * 2 * dpb
    nbytes = (tiles * tile * (b2 + 4) + nq * d_pad * 2
              + w * (dpb + 1) * 4 + plan.work_tile.shape[0] * 8
              + plan.qg_query.numel() * 4
              + n_active * 128 * kpg * (tile // 32) * 4)
    t_ops = (2.0 * nq * w * dpb / BF16_FLOPS
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


def exact_truth(scann_torch, db, queries, measure):
    """Exact float32 brute-force top-10 on the card."""
    bf = scann_torch.builder(db, K, measure).score_brute_force().build()
    truth, _ = bf.search_batched(queries)
    return truth


def wide_phase(torch, scann_torch):
    """Phase 9; returns (K3 record at b_pad 480, K5 record at d 960,
    summary dict, the corpus (rows, queries, truth) for phase 13)."""
    from scann_torch.ops import fused_scan
    from scann_torch.ops import pruned_lut
    t0 = time.perf_counter()
    db, queries = make_sift_like(GIST_ROWS, GIST_QUERIES, GIST_DIM, seed=9)
    q_dev = torch.as_tensor(queries, device="cuda")
    truth = exact_truth(scann_torch, db, queries, "squared_l2")
    log(f"GIST-960-shaped corpus {db.shape} + {queries.shape} and its "
        f"truth in {time.perf_counter() - t0:.1f} s")
    leaves = GIST_TREE["num_leaves_to_search"]
    out, k3, k5 = {}, {"max_abs_err": 0.0}, {}

    # Tree-AH, int8 lookup: K3 at b_pad 480.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = scann_torch.create_searcher(db, ah_config(
        scann_torch, db, "squared_l2", "int8", "float32", **GIST_TREE),
        "cuda")
    s._ensure_pruned()
    torch.cuda.synchronize()
    out["tree_ah_build_s"] = time.perf_counter() - t0
    b_pad = s._p_codes.shape[-1] * 2
    log(f"GIST tree-AH int8 lookup build: {out['tree_ah_build_s']:.1f} s, "
        f"{s.partitioner.num_leaves} leaves, b_pad {b_pad}")
    if b_pad != GIST_DIM // 2:
        raise AssertionError(f"b_pad {b_pad}, expected {GIST_DIM // 2}")
    dpb = s.model.dims_per_block
    for kpg in (8, 16):
        a3 = ah_inputs(torch, s, q_dev, leaves, True)
        got = pruned_lut.score_work_lut(*a3, measure_l2=True, kpg=kpg)
        want = k3_plain(*a3, measure_l2=True, kpg=kpg)
        torch.cuda.synchronize()
        err, _ = compare_packed(torch, "K3 at b_pad 480", got, want, a3[0])
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        log(f"K3 vs plain (b_pad {b_pad}, l2, kpg {kpg}): bit-equal, w_pad "
            f"{a3[0].work_tile.shape[0]}, active "
            f"{int(a3[0].work_active.sum())}")
        if kpg == 8:
            k3["ms"] = time_ms(torch, lambda: pruned_lut.score_work_lut(
                *a3, measure_l2=True, kpg=8))
            k3["plain_ms"] = time_ms(torch, lambda: k3_plain(
                *a3, measure_l2=True, kpg=8), reps=PLAIN_TIMING_REPS)
            k3["bound_ms"], k3["bound_by"], n_act = k3_bound(
                a3[0], GIST_QUERIES, a3[2], dpb, 8)
            log(f"K3 at b_pad {b_pad}, leaves={leaves}, {GIST_QUERIES} "
                f"queries, kpg 8: {k3['ms']:.3f} ms (plain "
                f"{k3['plain_ms']:.3f} ms), bound {k3['bound_ms']:.4f} ms "
                f"by {k3['bound_by']} ({n_act} active items)")
        del a3, got, want
    timer = StageTimer(torch)
    s.stage_hook = timer
    pruned_lut.launches_lut = 0
    idx, dist, wall, stages, launched = timed_search(
        torch, s, timer, queries, lambda: pruned_lut.launches_lut,
        leaves_to_search=leaves, pre_reorder_num_neighbors=AH_REORDER)
    s.stage_hook = None
    check_results(queries, db, idx, dist, "GIST tree-AH", False)
    if launched == 0:
        raise AssertionError("the GIST tree-AH search did not launch K3")
    k3["launches"] = pruned_lut.launches_lut
    out["tree_ah"] = {"leaves": leaves, "pre": AH_REORDER,
                      "recall": recall_at_k(idx, truth),
                      "qps": GIST_QUERIES / wall, "k3_launches": launched,
                      "stage_ms": stages}
    log(f"GIST tree-AH int8 lookup leaves={leaves} pre={AH_REORDER}: "
        f"recall@10 {out['tree_ah']['recall']:.4f}, qps "
        f"{out['tree_ah']['qps']:.0f}, K3 launches {launched}, stage ms "
        f"{stages}")
    cross_check(scann_torch, s, queries, "GIST tree-AH int8 lookup", db,
                leaves_to_search=leaves, pre_reorder_num_neighbors=AH_REORDER)
    s = None
    torch.cuda.empty_cache()

    # Reconstruct mode without a tree: K5 at d 960 (d_pad 1024).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = scann_torch.create_searcher(db, ah_config(
        scann_torch, db, "squared_l2", "reconstruct", "float32"), "cuda")
    torch.cuda.synchronize()
    out["no_tree_build_s"] = time.perf_counter() - t0
    rows, bias = flat._recon_rows, flat._recon_bias
    _, q_bf = flat._recon_queries(q_dev, rows.shape[1])
    log(f"GIST reconstruct without a tree: build "
        f"{out['no_tree_build_s']:.1f} s, {rows.shape[0]} slots x d_pad "
        f"{rows.shape[1]}")
    # d 960: the first 960 dimensions (the rest are the layout's zeros).
    rows_960 = rows[:, :GIST_DIM].contiguous()
    q_960 = q_bf[:, :GIST_DIM].contiguous()
    for what, qq, rr in (("d_pad 1024", q_bf, rows), ("d 960", q_960,
                                                       rows_960)):
        got = fused_scan.fused_scan_groupmax(qq, rr, bias, measure_l2=True)
        want = fused_scan.fused_scan_groupmax_torch(qq, rr, bias,
                                                    measure_l2=True)
        torch.cuda.synchronize()
        err, agree = compare_groupmax(torch, got, want, qq, rr, bias, 2.0)
        k5["max_abs_err"] = max(k5.get("max_abs_err", 0.0), err)
        log(f"K5 vs plain ({what}, l2, {qq.shape[0]} queries x "
            f"{rr.shape[0]} slots): max |err| {err:.3g}, slots agree "
            f"{agree:.6f}")
        del got, want
    k5["ms"] = time_ms(torch, lambda: fused_scan.fused_scan_groupmax(
        q_960, rows_960, bias, measure_l2=True))
    k5["plain_ms"] = time_ms(torch, lambda: fused_scan.fused_scan_groupmax_torch(
        q_960, rows_960, bias, measure_l2=True), reps=PLAIN_TIMING_REPS)
    k5["bound_ms"], k5["bound_by"] = k5_bound(GIST_QUERIES, rows_960)
    log(f"K5 at d 960, {GIST_QUERIES} queries x {rows.shape[0]} slots: "
        f"{k5['ms']:.3f} ms (plain {k5['plain_ms']:.3f} ms), bound "
        f"{k5['bound_ms']:.4f} ms by {k5['bound_by']}")
    del rows_960, q_960, q_bf
    flat.stage_hook = timer
    fused_scan.launches = 0
    idx, dist, wall, stages, launched = timed_search(
        torch, flat, timer, queries, lambda: fused_scan.launches)
    flat.stage_hook = None
    check_results(queries, db, idx, dist, "GIST reconstruct", False)
    if launched == 0:
        raise AssertionError("the GIST no-tree search did not launch K5")
    k5["launches"] = fused_scan.launches
    out["no_tree"] = {"recall": recall_at_k(idx, truth),
                      "qps": GIST_QUERIES / wall, "k5_launches": launched,
                      "stage_ms": stages}
    log(f"GIST reconstruct without a tree: recall@10 "
        f"{out['no_tree']['recall']:.4f}, qps {out['no_tree']['qps']:.0f}, "
        f"K5 launches {launched}, stage ms {stages}")
    cross_check(scann_torch, flat, queries, "GIST reconstruct without a "
                "tree", db, leaves_to_search=0)
    return k3, k5, out, (db, queries, truth)


def sift_phase(torch, scann_torch):
    """Phase 10: config 3b; returns its summary dict and the corpus (rows,
    queries) for phase 13."""
    from scann_torch.ops import pruned_sq
    t0 = time.perf_counter()
    db, queries = make_sift_like(SIFT_N, SIFT_Q, SIFT_D)
    truth = exact_truth(scann_torch, db, queries, "squared_l2")
    log(f"SIFT-shaped corpus {db.shape} + {queries.shape} and its truth in "
        f"{time.perf_counter() - t0:.1f} s")
    timer = StageTimer(torch)
    out = {}
    for reorder in (None, SIFT_REORDER):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = (scann_torch.builder(db, K, "squared_l2").tree(**SIFT_TREE)
             .score_brute_force(quantize="int8"))
        if reorder:
            b = b.reorder(reorder)
        s = b.build()
        torch.cuda.synchronize()
        name = f"reorder {reorder}" if reorder else "tree-SQ alone"
        rec = {"build_s": time.perf_counter() - t0, "points": []}
        log(f"SIFT {name}: build {rec['build_s']:.1f} s, "
            f"{s.partitioner.num_leaves} leaves")
        if not reorder:
            # The plan kernels at the SIFT cell's shape (leaves 8).
            out["plan"] = plan_check(
                torch, s, torch.as_tensor(queries, device="cuda"),
                SIFT_SWEEP[0], f"SIFT tree-SQ at leaves={SIFT_SWEEP[0]}")
        s.stage_hook = timer
        pruned_sq.launches = 0
        for leaves in SIFT_SWEEP:
            idx, dist, wall, stages, launched = timed_search(
                torch, s, timer, queries, lambda: pruned_sq.launches,
                leaves_to_search=leaves)
            check_results(queries, db, idx, dist, f"SIFT {name}", False)
            if launched == 0:
                raise AssertionError(f"SIFT {name} leaves={leaves} did not "
                                     f"launch K1")
            rec["points"].append({"leaves": leaves,
                                  "recall": recall_at_k(idx, truth),
                                  "qps": SIFT_Q / wall,
                                  "k1_launches": launched,
                                  "stage_ms": stages})
            log(f"SIFT {name} leaves={leaves}: recall@10 "
                f"{rec['points'][-1]['recall']:.4f}, qps "
                f"{SIFT_Q / wall:.0f}, K1 launches {launched}, stage ms "
                f"{stages}")
        s.stage_hook = None
        rec["k1_launches"] = pruned_sq.launches
        out[name] = rec
        if reorder:
            at8 = rec["points"][0]["recall"]
            if at8 < SIFT_RECALL_FLOOR_AT_8:
                raise AssertionError(
                    f"SIFT tree-SQ + reorder({reorder}) recall@10 {at8:.4f} "
                    f"at leaves=8 is under {SIFT_RECALL_FLOOR_AT_8}")
            cross_check(scann_torch, s, queries, f"SIFT {name}", db,
                        leaves_to_search=SIFT_SWEEP[0])
        s = None
        torch.cuda.empty_cache()
    return out, (db, queries)


def composition_phase(torch, scann_torch, db, queries, truth):
    """Phase 11: the other score_brute_force compositions on the phase-3
    corpus; returns its summary dict."""
    out = {}
    tree = dict(num_leaves=NUM_LEAVES, num_leaves_to_search=LEAVES_TO_SEARCH,
                training_sample_size=TRAIN_SAMPLE)
    timer = StageTimer(torch)
    for name, measure, quantize, with_tree in (
            ("brute force int8", "dot_product", "int8", False),
            ("brute force bfloat16", "dot_product", "bfloat16", False),
            ("Tree-X float32 leaves", "dot_product", "float32", True),
            ("Tree-X bfloat16 leaves", "dot_product", "bfloat16", True),
            ("cosine brute force", "cosine", "float32", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = scann_torch.builder(db, K, measure)
        if with_tree:
            b = b.tree(**tree)
        s = b.score_brute_force(quantize=quantize).build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        s.stage_hook = timer
        idx, dist, wall, stages, _ = timed_search(
            torch, s, timer, queries, lambda: 0,
            **({"leaves_to_search": LEAVES_TO_SEARCH} if with_tree else {}))
        s.stage_hook = None
        # The corpus is unit rows: cosine ranks as dot product does.
        check_results(queries, db, idx, 1.0 - dist if measure == "cosine"
                      else dist, name, quantize == "float32")
        out[name] = {"build_s": build_s, "recall": recall_at_k(idx, truth),
                     "qps": N_QUERY / wall, "stage_ms": stages}
        log(f"{name}: build {build_s:.1f} s, recall@10 "
            f"{out[name]['recall']:.4f}, qps {out[name]['qps']:.0f}, stage "
            f"ms {stages}")
        s = None
        torch.cuda.empty_cache()
    s = scann_torch.builder(db, K, "l1").score_brute_force().build()
    q1 = queries[:L1_QUERIES]
    s.stage_hook = timer
    idx, dist, wall, stages, _ = timed_search(torch, s, timer, q1, lambda: 0)
    s.stage_hook = None
    check_results(q1, db, idx, dist, "L1 brute force", False)
    found = 0
    for i in range(L1_CHECKED):
        l1 = np.abs(db - q1[i]).sum(1)
        want = np.argpartition(l1, K)[:K]
        found += len(set(idx[i]) & set(want))
        if not np.allclose(np.sort(l1[want]), dist[i], rtol=1e-4):
            raise AssertionError(f"L1 distances of query {i} differ from "
                                 f"numpy's")
    agree = found / (L1_CHECKED * K)
    if agree < 0.99:
        raise AssertionError(f"L1 top-10 agrees with numpy on {agree:.4f}")
    out["L1 brute force"] = {"queries": L1_QUERIES, "qps": L1_QUERIES / wall,
                             "numpy_agree": agree, "stage_ms": stages}
    log(f"L1 brute force on {L1_QUERIES} queries: qps "
        f"{L1_QUERIES / wall:.0f}, top-10 ids agree with numpy's on "
        f"{L1_CHECKED} queries {agree:.4f}, stage ms {stages}")
    return out


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
    bias = searcher._layout.bias
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


def cross_check(scann_torch, searcher, queries, what, l2_db=None, **kw):
    """The same index, serialized and searched on the CPU plain path,
    returns what the CUDA path returns for a few queries (at leaves=100
    unless ``kw`` says otherwise): ids equal on 99% and distances within
    1e-4 relative; a squared-L2 index passes its rows as ``l2_db``, and
    its distances are held relative to |d| + ||q||^2 + ||x||^2 (they are
    computed from those terms)."""
    kw = kw or {"leaves_to_search": LEAVES_TO_SEARCH}
    q = queries[:16]
    with tempfile.TemporaryDirectory() as tmp:
        searcher.serialize(tmp)
        cpu = scann_torch.load_searcher(tmp, device="cpu")
        i_cpu, d_cpu = cpu.search_batched(q, **kw)
    i_gpu, d_gpu = searcher.search_batched(q, **kw)
    same = i_cpu == i_gpu
    agree = float(np.mean(same))
    scale = np.abs(d_cpu)
    if l2_db is not None:
        scale = scale + (q ** 2).sum(1)[:, None] + (
            l2_db[np.maximum(i_cpu, 0)] ** 2).sum(-1)
    err = np.abs(d_cpu - d_gpu)[same]
    if agree < 0.99 or not np.all(err <= 1e-4 * scale[same] + 1e-8):
        raise AssertionError(f"{what}: CUDA and CPU paths disagree: ids "
                             f"{agree:.4f}")
    log(f"{what}: CUDA vs CPU plain path on 16 queries: ids agree "
        f"{agree:.4f}")


def tree_ah_phase(torch, scann_torch, db, queries, truth, q_dev, k6, work):
    """Phase 6; returns (K3 record, K4 record, summary dict) and adds the
    tree-AH part of K6's record to ``k6``.  The summary's
    "reference_assets" entry is phase 15c's input: the int8-lookup
    index written under ``work`` by save_reference_assets."""
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
        code_b = s._p_codes.numel() + s._layout.bias.numel() * 4 \
            + s._layout.dpid.numel() * 4
        reorder_b = sum(t.numel() * t.element_size() for t in (
            rh._db, rh._sq_norms, rh._leaf, rh._row_scale) if t is not None)
        log(f"tree-AH build {name}: {build_s[name]:.1f} s, "
            f"{s.partitioner.num_leaves} leaves, max_ntiles "
            f"{s._layout.max_ntiles}, {s._layout.num_tiles} tiles, codes "
            f"{code_b / N_DB:.1f} B/vector, reorder {reorder_b / N_DB:.1f} "
            f"B/vector, quantization error "
            f"{s._quantization_error_sq ** 0.5:.4f}")
    main, main_i8, main_f = (searchers[n] for n in
                             ("int8_f32", "int8_int8", "float_f32"))
    dpb = main.model.dims_per_block
    # The plan kernels at the glove cell's shape (this index, leaves 100).
    plan = plan_check(torch, main, q_dev, LEAVES_TO_SEARCH,
                      f"tree-AH at leaves={LEAVES_TO_SEARCH}")

    # Kernel phase: K3 and K4 at the main path's inputs.
    k3, k4 = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    k3["occupancy"] = {
        f"b_pad {b}, kpg {kpg}": _cuda.occupancy("pruned_lut", b, kpg)
        for b in (main._p_codes.shape[-1] * 2, GIST_DIM // 2)
        for kpg in (8, 16)}
    for measure_l2 in (False, True):
        for kpg in (8, 16):
            tag = f"{'l2' if measure_l2 else 'dot'}, kpg {kpg}"
            a3 = ah_inputs(torch, main, q_dev, LEAVES_TO_SEARCH, measure_l2)
            got = pruned_lut.score_work_lut(
                *a3, measure_l2=measure_l2, kpg=kpg)
            want = k3_plain(*a3, measure_l2=measure_l2, kpg=kpg)
            torch.cuda.synchronize()
            err, ident = compare_packed(torch, "K3", got, want, a3[0])
            k3["max_abs_err"] = max(k3["max_abs_err"], err)
            log(f"K3 vs plain ({tag}): bit-equal, w_pad "
                f"{a3[0].work_tile.shape[0]}, active "
                f"{int(a3[0].work_active.sum())}")
            if not measure_l2 and kpg == 8:    # the main path's block
                k6_check(torch, k6, "tree_ah", a3[0], got,
                         main._layout.ntiles, pruned_scan.TILE,
                         FUSED_MERGE_PRE, main._layout.max_ntiles)
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
                        (k3, pruned_lut.score_work_lut, k3_plain, a3,
                         k3_bound(a3[0], N_QUERY, a3[2], dpb, kpg)),
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
    # Phase 15c's reference-format copy of the int8-lookup index, with the
    # live ids it is held to; the residual-int8-reorder index must refuse
    # without lossy_reorder_downgrade.
    ref_dir = os.path.join(work, "reference_assets")
    t0 = time.perf_counter()
    scann_torch.save_reference_assets(main, ref_dir)
    ref_save_s = time.perf_counter() - t0
    ref_ids = main.search_batched(queries, leaves_to_search=LEAVES_TO_SEARCH,
                                  pre_reorder_num_neighbors=AH_REORDER)[0]
    # Phase 16's input: the residual-int8 index, resharded there.
    i8_dir = os.path.join(work, "tree_ah_int8")
    main_i8.serialize(i8_dir)
    try:
        scann_torch.save_reference_assets(main_i8,
                                          os.path.join(work, "refused"))
        refusal = "no error"
    except ValueError as e:
        refusal = f"ValueError: {e}"
    return k3, k4, {"build_s": build_s, "plan": plan, "points": points,
                    "dense": dense,
                    "merge": merges, "b_pad": main._p_codes.shape[-1] * 2,
                    "k4_d_pad": main_f._p_mean.shape[0],
                    "reference_assets": (ref_dir, ref_ids, ref_save_s,
                                         refusal),
                    "int8_residual_dir": i8_dir}


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

    pruned_b = nbytes(s._p_rows, s._layout.bias, s._layout.dpid)
    scan_b = nbytes(s._recon_rows, s._recon_bias, s._recon_sq)
    reorder_b = nbytes(s.reorder_helper._db)
    log(f"reconstruct build: {build_s:.1f} s (both layouts), "
        f"{s.partitioner.num_leaves} leaves, max_ntiles "
        f"{s._layout.max_ntiles}, {s._layout.num_tiles} tiles; resident "
        f"on the card: pruned rows "
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
    k5 = {"occupancy": _cuda.occupancy("fused_scan")}
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


def no_repeats(idx, what):
    """Raise when a result row names an id twice (-1 padding aside)."""
    pad = -np.arange(1, idx.shape[1] + 1)[None, :]
    srt = np.sort(np.where(idx >= 0, idx, pad), axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError(f"{what}: a row repeats an id")


def soar_config(scann_torch, db, lookup, soar, train=SOAR_TRAIN):
    """Config 4 (benchmarks/extra_configs.py:127-143), with or without
    SOAR, in the given lookup mode, at ``train`` training samples."""
    b = (scann_torch.builder(db, K, "dot_product")
         .tree(**SOAR_TREE, training_sample_size=train,
               soar_lambda=SOAR_LAMBDA if soar else None)
         .score_ah(2, anisotropic_quantization_threshold=0.2)
         .reorder(SOAR_REORDER))
    config = b.create_config()
    return dataclasses.replace(config, asymmetric_hash=dataclasses.replace(
        config.asymmetric_hash, lookup_type=lookup))


def timed_build(torch, make):
    """(searcher, build seconds), tree-AH's pruned layout included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = make()
    if hasattr(s, "_ensure_pruned"):
        s._ensure_pruned()
    torch.cuda.synchronize()
    return s, time.perf_counter() - t0


def record_calls(searcher, name):
    """Route the searcher's method ``name`` through a recorder; returns
    (the list of each call's arguments, the method).  ``del
    searcher.<name>`` restores it."""
    method = getattr(searcher, name)
    calls = []
    setattr(searcher, name,
            lambda *args: (calls.append(args), method(*args))[1])
    return calls, method


def cut_lists(torch, searcher, q_dev, rows, k, k_max, leaves):
    """Best-first candidates of the queries ``rows``: the best ``k`` at a
    budget of ``k`` and the best ``k`` + 1 at a budget of ``k_max``, as
    ((scores, ids), (scores, ids)) numpy arrays."""
    from scann_torch.ops import topk
    q = q_dev[torch.as_tensor(rows, device=q_dev.device)]
    out = []
    for budget, width in ((k, k), (k_max, k + 1)):
        v, d = topk.sort_results(*searcher._select_candidates(q, budget,
                                                              leaves))
        out.append((v[:, :width].cpu().numpy(), d[:, :width].cpu().numpy()))
    return out


def cut_at_a_tie(va, da, vb, db_):
    """Whether one query's best k candidates at a small budget (scores
    ``va``, ids ``da``) and its best k + 1 at a large one (``vb``, ``db_``)
    can differ only in the order of tied scores: both k-th scores are
    equal, the large budget's (k + 1)-th ties them, so either tie order
    cuts a different candidate, and the ids above that score agree."""
    k = va.shape[0]
    cut = va[-1]
    return bool(vb[k - 1] == cut and vb[k] == cut
                and set(da[va > cut].tolist())
                == set(db_[:k][vb[:k] > cut].tolist()))


def equal_up_to_rounding(ia, da, ib, db_, candidates):
    """Whether two result rows (ids ``ia``, ``ib``, distances ``da``,
    ``db_``) rescored from the same ``candidates`` can differ only by the
    rounding of the rescore: position by position their distances agree
    within RESCORE_RTOL, so do an id's two distances where both rows hold
    it, and every id where the rows differ is one of the candidates."""
    close = dict(rtol=RESCORE_RTOL, atol=0.0, equal_nan=True)
    if not np.allclose(da, db_, **close):
        return False
    dist_b = dict(zip(ib.tolist(), db_.tolist()))
    for i, d in zip(ia.tolist(), da.tolist()):
        if i in dist_b and not np.isclose(d, dist_b[i], **close):
            return False
    moved = set(ia[ia != ib].tolist()) | set(ib[ia != ib].tolist())
    return moved <= set(candidates.tolist())


def check_k_pre_rows(torch, searcher, queries, q_dev, base_i, k_small,
                     k_large, leaves):
    """Per-query ``pre_reorder_num_neighbors``: the even rows ask for
    ``k_small``, the odd ones for ``k_large``, the searcher's own budget,
    whose plain search gave ``base_i``.  An odd row must equal it; an even
    one rescores the best ``k_small`` of the ``k_large`` selection and must
    equal the scalar ``k_small`` search, which rescores the best of its
    own, smaller SOAR over-retrieval.  Both draw on the same survivors and
    select exactly, so they can differ in two ways only.  Where the
    ``k_small``-th score ties the next, the two tie orders cut different
    candidates.  Where both hand the rescore the same candidates, the
    rescore's product at width ``k_large`` may round otherwise than at
    ``k_small`` (RESCORE_RTOL), and results that close may trade places
    (``equal_up_to_rounding``).  Every differing row is logged with both
    candidate lists and must be one of these.  Returns (tied rows,
    differing rows, rows that differ by rounding) among the even ones."""
    from scann_torch.models import tree_ah
    kpg = [tree_ah._survivors_per_group(searcher._k_fetch(k),
                                        searcher._num_slots,
                                        searcher.partitioner.num_leaves)
           for k in (k_small, k_large)]
    if kpg[0] != kpg[1]:
        raise AssertionError(f"survivors per group differ: {kpg}")
    nq = queries.shape[0]
    kw = dict(leaves_to_search=leaves)
    pres = np.where(np.arange(nq) % 2 == 0, k_small, k_large).astype(
        np.int32)
    idx, dist = searcher.search_batched(
        queries, pre_reorder_num_neighbors=pres, **kw)
    small, small_d = searcher.search_batched(
        queries, pre_reorder_num_neighbors=k_small, **kw)
    rows = np.arange(0, nq, 2)
    (va, da), (vb, db_) = cut_lists(torch, searcher, q_dev, rows, k_small,
                                    k_large, leaves)
    tied = [cut_at_a_tie(va[j], da[j], vb[j], db_[j])
            for j in range(len(rows))]
    differ = np.nonzero((idx[rows] != small[rows]).any(1))[0]
    rounding = {}
    for j in differ:
        r = rows[j]
        same_candidates = (np.array_equal(da[j], db_[j][:k_small])
                           and np.array_equal(va[j], vb[j][:k_small]))
        rounding[j] = same_candidates and equal_up_to_rounding(
            idx[r], dist[r], small[r], small_d[r], da[j])
        log(f"k_pre row {r}: ids {idx[r].tolist()} distances "
            f"{dist[r].tolist()} against the scalar search's "
            f"{small[r].tolist()} {small_d[r].tolist()}; best {k_small} at "
            f"a budget of {k_small}: ids {da[j].tolist()} scores "
            f"{va[j].tolist()}; best {k_small + 1} at {k_large}: ids "
            f"{db_[j].tolist()} scores {vb[j].tolist()}; tie at the cut: "
            f"{tied[j]}; the same candidates, rescored within rounding: "
            f"{rounding[j]}")
    if not (np.array_equal(idx[1::2], base_i[1::2])
            and all(tied[j] or rounding[j] for j in differ)):
        raise AssertionError("per-query pre_reorder_num_neighbors")
    return sum(tied), len(differ), sum(rounding.values())


def search_features_phase(torch, scann_torch, db, queries, truth, q_dev):
    """Phase 12: ROADMAP item 14.  Returns (launches of K1-K5 in this
    phase, summary dict)."""
    from scann_torch.models import tree_ah
    from scann_torch.ops import fused_scan
    from scann_torch.ops import pruned_lut
    from scann_torch.ops import pruned_scan
    from scann_torch.ops import pruned_sq
    out = {}
    launches = {"pruned_sq": 0, "pruned_rows": 0, "pruned_lut": 0,
                "pruned_codes": 0, "fused_scan": 0}
    pruned_scan.launches_plan = 0     # read once, at the phase's end
    timer = StageTimer(torch)

    def index_mb(s):
        rh = s.reorder_helper
        return sum(t.numel() * t.element_size() for t in (
            s._p_codes, s._layout.bias, s._layout.dpid, s._p_rows,
            s.partitioner.centers, rh._db) if t is not None) / 1e6

    # 1. Config 4 with and without SOAR (int8 lookup: K3), at its own
    # training sample and at bench.py's.
    soar = None
    for train in (SOAR_TRAIN_DEFINED, SOAR_TRAIN):
        for name, with_soar in (("soar", True), ("no_soar", False)):
            what = f"config 4 {name}, {train} samples"
            s, build_s = timed_build(
                torch, lambda: scann_torch.create_searcher(
                    db, soar_config(scann_torch, db, "int8", with_soar,
                                    train), "cuda"))
            s.stage_hook = timer
            pruned_lut.launches_lut = pruned_lut.launches_codes = 0
            calls, dedup = record_calls(s, "_dedup")
            idx, dist, wall, stages, launched = timed_search(
                torch, s, timer, queries, lambda: pruned_lut.launches_lut,
                leaves_to_search=SOAR_LEAVES)
            del s._dedup
            s.stage_hook = None
            launches["pruned_lut"] += pruned_lut.launches_lut
            check_results(queries, db, idx, dist, what, True)
            no_repeats(idx, what)
            if launched == 0 or pruned_lut.launches_codes:
                raise AssertionError(f"{what} did not go through K3")
            rec = {"build_s": build_s,
                   "num_leaves": s.partitioner.num_leaves,
                   "slots": s._num_slots, "recall": recall_at_k(idx, truth),
                   "qps": N_QUERY / wall, "k3_launches": launched,
                   "stage_ms": stages,
                   "bytes_per_vector": index_mb(s) * 1e6 / N_DB}
            if with_soar:
                # The dedup's own time, on the inputs of the timed search.
                # The search marks the dedup as a stage of its own after
                # the merge's; the share is of the two together, what the
                # merge stage held before the dedup had its own mark.
                rec["dedup_ms"] = time_ms(torch, lambda: dedup(*calls[-1]))
                rec["dedup_share_of_merge"] = (
                    rec["dedup_ms"] / (stages["merge"] + stages["dedup"]))
                if train == SOAR_TRAIN:
                    soar = s
            out[f"config4_{train}_{name}"] = rec
            log(f"{what}: build {build_s:.1f} s, {rec['num_leaves']} "
                f"leaves, {rec['slots']} slots, "
                f"{rec['bytes_per_vector']:.1f} B/vector; leaves="
                f"{SOAR_LEAVES}: recall@10 {rec['recall']:.4f}, qps "
                f"{rec['qps']:.0f}, K3 launches {launched}, stage ms "
                f"{stages}" + (f", dedup {rec['dedup_ms']:.3f} ms"
                               if with_soar else ""))
            s = None
        r_soar = out[f"config4_{train}_soar"]["recall"]
        r_plain = out[f"config4_{train}_no_soar"]["recall"]
        if r_soar < r_plain - SOAR_MAX_LOSS or (
                train == SOAR_TRAIN and r_soar < SOAR_RECALL_FLOOR):
            raise AssertionError(
                f"config 4 at {train} samples: recall@10 with SOAR "
                f"{r_soar:.4f} (without {r_plain:.4f}) is under its floor")
    # K3 on the SOAR layout, at the inputs and survivor width of the path.
    kpg = tree_ah._survivors_per_group(soar._k_fetch(SOAR_REORDER),
                                       soar._num_slots,
                                       soar.partitioner.num_leaves)
    a3 = ah_inputs(torch, soar, q_dev, SOAR_LEAVES, False)
    got = pruned_lut.score_work_lut(*a3, measure_l2=False, kpg=kpg)
    want = k3_plain(*a3, measure_l2=False, kpg=kpg)
    torch.cuda.synchronize()
    compare_packed(torch, "K3 (SOAR)", got, want, a3[0])
    log(f"K3 vs plain on the SOAR layout (kpg {kpg}, "
        f"{int(a3[0].work_active.sum())} active items): bit-equal")
    del a3, got, want

    # 4. Search parameters on the config-4 SOAR index, each held by rule
    # on every row.
    kw = dict(leaves_to_search=SOAR_LEAVES)
    base_i, base_d = soar.search_batched(queries, **kw)
    rng = np.random.default_rng(12)
    ks = rng.integers(1, K + 1, N_QUERY).astype(np.int32)
    idx, dist = soar.search_batched(queries, final_num_neighbors=ks, **kw)
    col = np.arange(K)[None, :]
    if not (np.array_equal(idx >= 0, col < ks[:, None])
            and np.array_equal(np.where(col < ks[:, None], idx, -1),
                               np.where(col < ks[:, None], base_i, -1))):
        raise AssertionError("per-query final_num_neighbors")
    ties, differ, rounding = check_k_pre_rows(
        torch, soar, queries, q_dev, base_i, 20, SOAR_REORDER, SOAR_LEAVES)
    log(f"per-query pre_reorder_num_neighbors: {ties} of {N_QUERY // 2} "
        f"rows with 20 have their 20th candidate's score tied with the "
        f"21st; {differ} rows differ from the scalar search, each at such "
        f"a tie or ({rounding} of them) by the rescore's rounding")
    eps = (base_d[:, 2] + base_d[:, 3]) / 2
    idx, dist = soar.search_batched(queries, post_reordering_epsilon=eps,
                                    **kw)
    kept = idx >= 0
    if not (np.all(kept[:, :3]) and np.all(np.where(kept, dist, np.inf)
                                           >= eps[:, None])
            and np.array_equal(np.where(kept, idx, -1),
                               np.where(kept, base_i, -1))):
        raise AssertionError("post_reordering_epsilon")
    pre_eps = np.where(np.arange(N_QUERY) % 2 == 0, -1e9, 1e9)
    idx, _ = soar.search_batched(queries, pre_reordering_epsilon=pre_eps,
                                 **kw)
    if not (np.array_equal(idx[::2], base_i[::2]) and (idx[1::2] == -1).all()):
        raise AssertionError("pre_reordering_epsilon")
    attrs = (np.arange(N_DB) % CROWDING_ATTRS).astype(np.int32)
    soar.set_crowding(attrs)
    soar.stage_hook = timer
    calls, crowd = record_calls(soar, "_crowd")
    idx, dist, wall, crowd_stages, _ = timed_search(
        torch, soar, timer, queries, lambda: 0,
        per_crowding_attribute_num_neighbors=CROWDING_CAP,
        per_crowding_attribute_pre_reordering_num_neighbors=CROWDING_CAP,
        **kw)
    del soar._crowd
    soar.stage_hook = None
    for row in idx:
        if np.bincount(attrs[row[row >= 0]]).max(initial=0) > CROWDING_CAP:
            raise AssertionError("crowding: an attribute exceeds its cap")
    pre_args, post_args = calls[-2], calls[-1]
    crowding = {"recall": recall_at_k(idx, truth), "qps": N_QUERY / wall,
                "stage_ms": crowd_stages,
                "pre_ms": time_ms(torch, lambda: crowd(*pre_args)),
                "post_ms": time_ms(torch, lambda: crowd(*post_args))}
    crowding["pre_share_of_reorder"] = (crowding["pre_ms"]
                                        / crowd_stages["reorder"])
    crowding["post_share_of_finish"] = (crowding["post_ms"]
                                        / crowd_stages["finish"])
    pt = soar.partitioner.tokenize_queries(q_dev, SOAR_LEAVES)[0].cpu().numpy()
    idx, _ = soar.search_batched(queries, pre_tokenized_leaves=pt)
    if not np.array_equal(idx, base_i):
        raise AssertionError("pre_tokenized_leaves differ from the "
                             "tokenizer's search")
    out["search_params"] = {"crowding": crowding}
    log(f"config 4 search parameters: per-query k and k_pre, both "
        f"epsilons, pre_tokenized_leaves hold on every row; crowding "
        f"(id % {CROWDING_ATTRS}, caps {CROWDING_CAP} before and after the "
        f"reorder): recall@10 {crowding['recall']:.4f}, qps "
        f"{crowding['qps']:.0f}, stage ms {crowd_stages}, pre-reorder "
        f"crowding {crowding['pre_ms']:.3f} ms, post {crowding['post_ms']:.3f}"
        f" ms")
    soar = None
    torch.cuda.empty_cache()

    # 2. The SOAR index in reconstruct mode: K2 at 40 leaves, K5 on the
    # full scan.
    s, build_s = timed_build(torch, lambda: scann_torch.create_searcher(
        db, soar_config(scann_torch, db, "reconstruct", True), "cuda"))
    kpg = tree_ah._survivors_per_group(s._k_fetch(SOAR_REORDER),
                                       s._num_slots,
                                       s.partitioner.num_leaves)
    args = recon_k2_inputs(torch, s, q_dev, SOAR_LEAVES, False)
    got = pruned_scan.score_work(*args, measure_l2=False, kpg=kpg)
    want = pruned_scan.score_work_torch(*args, measure_l2=False, kpg=kpg)
    torch.cuda.synchronize()
    err, ident = compare_packed(torch, "K2 (SOAR)", got, want, args[0],
                                atol=K4_ATOL, min_id=K2_MIN_ID_AGREE)
    log(f"K2 vs plain on the SOAR layout (kpg {kpg}): max |err| {err:.3g}, "
        f"identities agree {ident:.6f}")
    del args, got, want
    rec = {"build_s": build_s, "slots": s._num_slots}
    s.stage_hook = timer
    for what, leaves, counter in (
            ("pruned", SOAR_LEAVES, lambda: pruned_scan.launches),
            ("full_scan", s.partitioner.num_leaves,
             lambda: fused_scan.launches)):
        pruned_scan.launches = fused_scan.launches = 0
        idx, dist, wall, stages, launched = timed_search(
            torch, s, timer, queries, counter, leaves_to_search=leaves)
        launches["pruned_rows"] += pruned_scan.launches
        launches["fused_scan"] += fused_scan.launches
        check_results(queries, db, idx, dist, f"SOAR reconstruct {what}",
                      True)
        no_repeats(idx, f"SOAR reconstruct {what}")
        if launched == 0:
            raise AssertionError(f"SOAR reconstruct {what} did not launch "
                                 f"its kernel")
        rec[what] = {"leaves": leaves, "recall": recall_at_k(idx, truth),
                     "qps": N_QUERY / wall, "launches": launched,
                     "stage_ms": stages}
        log(f"SOAR reconstruct {what} (leaves={leaves}): recall@10 "
            f"{rec[what]['recall']:.4f}, qps {N_QUERY / wall:.0f}, "
            f"{'K2' if what == 'pruned' else 'K5'} launches {launched}, "
            f"stage ms {stages}")
    s.stage_hook = None
    rows, bias = s._recon_rows, s._recon_bias
    _, q_bf = s._recon_queries(q_dev[:SOAR_K5_QUERIES], rows.shape[1])
    got = fused_scan.fused_scan_groupmax(q_bf, rows, bias)
    want = fused_scan.fused_scan_groupmax_torch(q_bf, rows, bias)
    torch.cuda.synchronize()
    err, agree = compare_groupmax(torch, got, want, q_bf, rows, bias, 1.0)
    log(f"K5 vs plain on the SOAR full-scan rows ({SOAR_K5_QUERIES} queries "
        f"x {rows.shape[0]} slots): max |err| {err:.3g}, slots agree "
        f"{agree:.6f}")
    out["soar_reconstruct"] = rec
    s = rows = bias = q_bf = got = want = None
    torch.cuda.empty_cache()

    # 3. The bench tree-SQ config (K1) with learned multiplicative query
    # spilling, int8 centroids, and a hierarchical tree.
    for name, extra in (("spilling", dict(
            query_spilling_type="multiplicative")),
            ("int8_centroids", dict(quantize_centroids=True)),
            ("hierarchical", dict(hierarchical_top=HIERARCHICAL_TOP))):
        s, build_s = timed_build(torch, lambda: scann_torch.builder(
            db, K, "dot_product").tree(
                num_leaves=NUM_LEAVES, num_leaves_to_search=LEAVES_TO_SEARCH,
                training_sample_size=TRAIN_SAMPLE, **extra)
            .score_brute_force(quantize="int8").build())
        s.stage_hook = timer
        pruned_sq.launches = 0
        idx, dist, wall, stages, launched = timed_search(
            torch, s, timer, queries, lambda: pruned_sq.launches,
            leaves_to_search=LEAVES_TO_SEARCH)
        s.stage_hook = None
        launches["pruned_sq"] += pruned_sq.launches
        check_results(queries, db, idx, dist, f"tree-SQ {name}", True)
        if launched == 0:
            raise AssertionError(f"tree-SQ {name} did not launch K1")
        part = s.partitioner
        _, sims = part.tokenize_queries(q_dev, LEAVES_TO_SEARCH)
        mean_leaves = float(part.spilling_mask(sims).sum(1).float().mean())
        rec = {"build_s": build_s, "num_leaves": part.num_leaves,
               "recall": recall_at_k(idx, truth), "qps": N_QUERY / wall,
               "mean_leaves_searched": mean_leaves, "k1_launches": launched,
               "stage_ms": stages,
               "spilling_threshold": part.query_spilling_threshold,
               "upper_leaves_to_search": (part.upper_leaves_to_search
                                          if part.upper_centers is not None
                                          else 0)}
        out[f"tree_sq_{name}"] = rec
        log(f"tree-SQ {name}: build {build_s:.1f} s, {part.num_leaves} "
            f"leaves; leaves={LEAVES_TO_SEARCH}: recall@10 "
            f"{rec['recall']:.4f}, qps {rec['qps']:.0f}, mean leaves "
            f"searched {mean_leaves:.2f}, K1 launches {launched}, stage ms "
            f"{stages}")
        cross_check(scann_torch, s, queries, f"tree-SQ {name}")
        s = None
        torch.cuda.empty_cache()
    launches["pruned_plan"] = pruned_scan.launches_plan
    out["launches"] = launches
    log(f"phase 12 launches: {launches}")
    return launches, out


# Phase 13: ROADMAP items 11 (typed input datasets), 13 (the one-leaf AH
# tree) and 16 (data and encodings).  Part a: phase 10's corpus rounded
# and clipped to uint8, as SIFT1M's descriptors are; part b: phase 9's
# corpus, its tree and budget; part c: the phase-3 corpus with bench.py's
# tree-AH config; part d: a SPLADE-shaped sparse corpus (BERT's
# vocabulary, about 120 Zipf-distributed terms a row, 40 a query).
PCA_DIMS = 128                      # pca(128): 64 blocks of 2, b_pad 64
VARIABLE_WIDTHS = (4,) * 10 + (2,) * 30   # 100 dimensions in 40 blocks
ENC_LUT_QUERIES = 1_000             # queries of the dense LUT scans
TYPED_BF_QUERIES = 1_000            # queries of the typed brute force
TYPED_MIN_ID_AGREE, TYPED_MAX_RECALL_GAP = 0.999, 0.001
OPQ_MAX_LOSS = 0.01                 # OPQ vs phase 9's tree-AH, recall@10
SPLADE_ROWS, SPLADE_QUERIES, SPLADE_VOCAB = 1_000_000, 1_000, 30_522
SPLADE_ROW_NNZ, SPLADE_QUERY_NNZ = 120, 40
SPARSE_EXACT_ROWS, SPARSE_EXACT_QUERIES = 100_000, 100


def device_bytes(s):
    """Bytes of the index tensors a searcher holds on the card."""
    ts = [getattr(s, a, None) for a in (
        "_db", "_sq_norms", "slot_rows", "slot_scale", "slot_leaf",
        "slot_dpid", "_p_rows", "_p_codes", "_recon_rows", "_recon_bias")]
    layout = getattr(s, "_layout", None)
    if layout is not None:
        ts += [layout.bias, layout.dpid]
    index = getattr(s, "index", None)
    if index is not None:
        ts += [index.codes, index.slot_dpid, index.slot_leaf]
    part = getattr(s, "partitioner", None)
    if part is not None:
        ts.append(part.centers)
    if s.reorder_helper is not None:
        ts += [s.reorder_helper._db, s.reorder_helper._sq_norms]
    if s.projector is not None:
        ts.append(s.projector.matrix)
    seen, total = set(), 0
    for t in ts:
        if t is not None and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def make_splade_like(torch, n, nq, seed=13, device="cuda"):
    """(rows, queries) as CSR numpy arrays (indptr, indices, values,
    shape): about SPLADE_ROW_NNZ / SPLADE_QUERY_NNZ distinct terms of
    BERT's vocabulary a row, drawn from a Zipf law (exponent 1) over a
    random term order, with positive SPLADE-like weights.  Drawn on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = 1.0 / torch.arange(1, SPLADE_VOCAB + 1, device=device,
                           dtype=torch.float64)
    cdf = torch.cumsum(p / p.sum(), 0)
    perm = torch.randperm(SPLADE_VOCAB, generator=gen, device=device)

    def draw(m, nnz):
        draws = nnz * 3 // 2
        ptr, idx, val = [np.zeros(1, np.int64)], [], []
        for r0 in range(0, m, 100_000):
            mm = min(100_000, m - r0)
            u = torch.rand((mm, draws), generator=gen, device=device,
                           dtype=torch.float64)
            cols = perm[torch.searchsorted(cdf, u).clamp_max(
                SPLADE_VOCAB - 1)]
            cols, _ = cols.sort(dim=1)
            first = torch.ones_like(cols, dtype=torch.bool)
            first[:, 1:] = cols[:, 1:] != cols[:, :-1]
            # nnz of the distinct terms, at random; fewer when a row drew
            # fewer distinct terms.
            key = torch.where(first, torch.rand(
                (mm, draws), generator=gen, device=device), -1.0)
            keyk, pos = key.topk(nnz, dim=1)
            sel = torch.where(keyk >= 0, torch.gather(cols, 1, pos),
                              SPLADE_VOCAB)
            sel, _ = sel.sort(dim=1)
            keep = sel < SPLADE_VOCAB
            w = 0.05 + 0.7 * torch.empty((mm, nnz), device=device
                                         ).exponential_(1.0, generator=gen)
            ptr.append(ptr[-1][-1] + np.cumsum(
                keep.sum(1).cpu().numpy().astype(np.int64)))
            idx.append(sel[keep].cpu().numpy().astype(np.int64))
            val.append(w[keep].float().cpu().numpy())
        return (np.concatenate(ptr), np.concatenate(idx),
                np.concatenate(val), (m, SPLADE_VOCAB))

    return draw(n, SPLADE_ROW_NNZ), draw(nq, SPLADE_QUERY_NNZ)


def sparse_truth(torch, rows, queries, k=K):
    """Exact sparse dot-product top-k on the card, with cuSPARSE (a CSR x
    dense product; independent of the port's sparse code)."""
    def csr(m):
        return torch.sparse_csr_tensor(
            torch.from_numpy(m[0]), torch.from_numpy(m[1]),
            torch.from_numpy(m[2]), size=m[3],
            check_invariants=False).to("cuda")

    warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
    warnings.filterwarnings("ignore", "Sparse invariant checks")
    q_dense = csr(queries).to_dense()
    best_v = best_i = None
    step = 250_000
    for r0 in range(0, rows[3][0], step):
        r1 = min(r0 + step, rows[3][0])
        lo, hi = int(rows[0][r0]), int(rows[0][r1])
        part = (rows[0][r0:r1 + 1] - lo, rows[1][lo:hi], rows[2][lo:hi],
                (r1 - r0, rows[3][1]))
        sims = (csr(part) @ q_dense.T).T                   # (nq, rows)
        v, i = sims.topk(min(k, r1 - r0), dim=1)
        i = i + r0
        if best_v is not None:
            v, pos = torch.cat([best_v, v], 1).topk(k, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, pos)
        best_v, best_i = v, i
    return best_i.cpu().numpy(), best_v.cpu().numpy()


def encodings_phase(torch, scann_torch, glove, gist, sift, wide_summary):
    """Phase 13: ROADMAP items 11 (typed), 13 and 16.  Returns (launches
    of K1-K5 in this phase's searches, the largest kernel-vs-plain error
    of each kernel held here, summary dict)."""
    from scann_torch.data import sparse as sparse_mod
    from scann_torch.models import tree_ah
    from scann_torch.ops import fused_scan
    from scann_torch.ops import pruned_lut
    from scann_torch.ops import pruned_scan
    from scann_torch.ops import pruned_sq
    t_phase = time.perf_counter()
    out = {}
    launches = {"pruned_sq": 0, "pruned_rows": 0, "pruned_lut": 0,
                "pruned_codes": 0, "fused_scan": 0}
    pruned_scan.launches_plan = 0     # read once, at the phase's end
    errs = {}
    timer = StageTimer(torch)

    def counted(s, queries, what, **kw):
        """One timed search with every kernel count set to 0 just before;
        the launches it made join the phase's."""
        pruned_sq.launches = pruned_scan.launches = 0
        pruned_lut.launches_lut = pruned_lut.launches_codes = 0
        fused_scan.launches = 0
        inner = getattr(s, "searcher", s)     # a SparseSearcher's index
        inner.stage_hook = timer
        idx, dist, wall, stages, _ = timed_search(
            torch, s, timer, queries, lambda: 0, **kw)
        inner.stage_hook = None
        got = {"pruned_sq": pruned_sq.launches,
               "pruned_rows": pruned_scan.launches,
               "pruned_lut": pruned_lut.launches_lut,
               "pruned_codes": pruned_lut.launches_codes,
               "fused_scan": fused_scan.launches}
        for name, n in got.items():
            launches[name] += n
        nq = getattr(queries, "n_rows", None) or len(queries)
        if not np.isfinite(dist).all() or idx.shape != (nq, K):
            raise AssertionError(f"{what}: bad results")
        return idx, wall, stages, {n: c for n, c in got.items() if c}

    def note(rec, what):
        log(f"{what}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items()))

    # a. Typed: phase 10's corpus as uint8.  The typed build and the
    # float32-cast build run with deterministic index_add_ so that the
    # comparison sees the typed path alone, not run-to-run atomics.
    db_f, q_f = sift
    db8 = np.clip(np.rint(db_f), 0, 255).astype(np.uint8)
    q8 = np.clip(np.rint(q_f), 0, 255).astype(np.float32)
    sift = db_f = q_f = None
    truth8 = exact_truth(scann_torch, db8.astype(np.float32), q8,
                         "squared_l2")
    typed = {}
    results = {}
    for name, rows in (("uint8", db8), ("float32 cast", None)):
        rows = db8 if rows is not None else db8.astype(np.float32)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            s, build_s = timed_build(torch, lambda: scann_torch.builder(
                rows, K, "squared_l2").tree(**SIFT_TREE)
                .score_brute_force(quantize="int8").build())
        finally:
            torch.use_deterministic_algorithms(False)
        rec = {"build_s": build_s, "num_leaves": s.partitioner.num_leaves,
               "bytes_per_vector": device_bytes(s) / len(db8),
               "build_input_bytes_per_vector": rows.itemsize * rows.shape[1],
               "points": []}
        results[name] = []
        for leaves in SIFT_SWEEP:
            idx, wall, stages, got = counted(
                s, q8, f"typed {name}", leaves_to_search=leaves)
            if not got.get("pruned_sq"):
                raise AssertionError(f"typed {name} leaves={leaves} did not "
                                     f"launch K1")
            results[name].append(idx)
            rec["points"].append({"leaves": leaves,
                                  "recall": recall_at_k(idx, truth8),
                                  "qps": SIFT_Q / wall, "launches": got,
                                  "stage_ms": stages})
            log(f"typed {name} tree-SQ leaves={leaves}: recall@10 "
                f"{rec['points'][-1]['recall']:.4f}, qps "
                f"{SIFT_Q / wall:.0f}, launches {got}, stage ms {stages}")
        if name == "uint8":
            q_dev = torch.as_tensor(q8, device="cuda")
            plan, qg_rows, bias = k1_inputs(torch, s, q_dev, 100, False)
            args = (plan, qg_rows, s.slot_rows, s.slot_scale, bias)
            got = pruned_sq.score_work_sq(*args, measure_l2=True, kpg=4)
            want = pruned_sq.score_work_torch_sq(*args, measure_l2=True,
                                                 kpg=4)
            torch.cuda.synchronize()
            err, ident = compare_packed(torch, "K1 (typed)", got, want, plan,
                                        atol=K1_ATOL)
            errs["pruned_sq"] = err
            log(f"K1 vs plain on the typed plan (l2, kpg 4, leaves 100): "
                f"max |err| {err:.3g}, identities agree {ident:.6f}")
            del plan, qg_rows, bias, args, got, want, q_dev
        typed[name] = rec
        log(f"typed {name}: build {build_s:.1f} s, {rec['num_leaves']} "
            f"leaves, index {rec['bytes_per_vector']:.1f} B/vector")
        s = None
        torch.cuda.empty_cache()
    agree = [float(np.mean(a == b)) for a, b in zip(results["uint8"],
                                                    results["float32 cast"])]
    gaps = [abs(a["recall"] - b["recall"]) for a, b in zip(
        typed["uint8"]["points"], typed["float32 cast"]["points"])]
    typed["ids_equal"] = agree
    log(f"typed uint8 vs float32 cast, ids equal {agree}, recall gaps "
        f"{gaps}")
    if min(agree) < TYPED_MIN_ID_AGREE or max(gaps) > TYPED_MAX_RECALL_GAP:
        raise AssertionError("the typed build differs from the float32-cast "
                             "build")
    results = {}
    qb = q8[:TYPED_BF_QUERIES]
    for name, rows in (("uint8", db8), ("float32 cast",
                                        db8.astype(np.float32))):
        s, build_s = timed_build(torch, lambda: scann_torch.builder(
            rows, K, "squared_l2").score_brute_force().build())
        idx, wall, stages, _ = counted(s, qb, f"typed brute force {name}")
        rec = {"build_s": build_s, "rows_bytes_per_vector":
               s._db.element_size() * s._db.shape[1],
               "recall": recall_at_k(idx, truth8[:TYPED_BF_QUERIES]),
               "qps": TYPED_BF_QUERIES / wall, "stage_ms": stages}
        results[name] = idx
        typed[f"brute_force {name}"] = rec
        note(rec, f"typed brute force {name} ({TYPED_BF_QUERIES} queries)")
        s = None
        torch.cuda.empty_cache()
    if typed["brute_force uint8"]["rows_bytes_per_vector"] != SIFT_D:
        raise AssertionError("typed brute-force rows are not 1 B a dimension")
    bf_agree = float(np.mean(results["uint8"] == results["float32 cast"]))
    typed["brute_force_ids_equal"] = bf_agree
    if bf_agree < TYPED_MIN_ID_AGREE:
        raise AssertionError(f"typed brute force ids equal {bf_agree}")
    out["typed"] = typed
    db8 = q8 = truth8 = qb = results = None

    # b. Projections on phase 9's corpus, its tree, leaves and budget.
    db, queries, truth = gist
    gist = None
    leaves = GIST_TREE["num_leaves_to_search"]
    base = wide_summary["tree_ah"]["recall"]
    proj = {"unprojected_recall": base}
    for name, project in (("pca", lambda b: b.pca(
            PCA_DIMS, pca_significance_threshold=None)),
            ("opq", lambda b: b.opq())):
        def make():
            b = project(scann_torch.builder(db, K, "squared_l2")
                        .tree(**GIST_TREE)
                        .score_ah(2, anisotropic_quantization_threshold=0.2)
                        .reorder(AH_REORDER))
            config = b.create_config()
            return scann_torch.create_searcher(db, dataclasses.replace(
                config, asymmetric_hash=dataclasses.replace(
                    config.asymmetric_hash, lookup_type="int8")), "cuda")
        s, build_s = timed_build(torch, make)
        b_pad = s._p_codes.shape[-1] * 2
        idx, wall, stages, got = counted(
            s, queries, f"GIST {name}", leaves_to_search=leaves,
            pre_reorder_num_neighbors=AH_REORDER)
        if not got.get("pruned_lut"):
            raise AssertionError(f"GIST {name} did not launch K3")
        rec = {"out_dims": s.projector.out_dims, "b_pad": b_pad,
               "build_s": build_s, "recall": recall_at_k(idx, truth),
               "qps": GIST_QUERIES / wall, "launches": got,
               "stage_ms": stages,
               "bytes_per_vector": device_bytes(s) / GIST_ROWS}
        note(rec, f"GIST {name} tree-AH int8 + reorder({AH_REORDER}) at "
                  f"leaves={leaves} (phase 9 unprojected: {base:.4f})")
        if name == "pca":
            if b_pad != PCA_DIMS // 2:
                raise AssertionError(f"PCA b_pad {b_pad}")
            q_proj = s._project_queries(torch.as_tensor(queries,
                                                        device="cuda"))
            for kpg in (8, 16):
                a3 = ah_inputs(torch, s, q_proj, leaves, True)
                got3 = pruned_lut.score_work_lut(*a3, measure_l2=True,
                                                 kpg=kpg)
                want3 = k3_plain(*a3, measure_l2=True, kpg=kpg)
                torch.cuda.synchronize()
                err, _ = compare_packed(torch, "K3 at b_pad 64", got3, want3,
                                        a3[0])
                errs["pruned_lut"] = max(errs.get("pruned_lut", 0.0), err)
                log(f"K3 vs plain on the PCA index (b_pad {b_pad}, l2, kpg "
                    f"{kpg}): bit-equal, active "
                    f"{int(a3[0].work_active.sum())}")
                del a3, got3, want3
            cross_check(scann_torch, s, queries, "GIST PCA tree-AH", db,
                        leaves_to_search=leaves,
                        pre_reorder_num_neighbors=AH_REORDER)
        elif rec["recall"] < base - OPQ_MAX_LOSS:
            raise AssertionError(f"OPQ recall@10 {rec['recall']:.4f} under "
                                 f"phase 9's {base:.4f} less {OPQ_MAX_LOSS}")
        proj[name] = rec
        s = None
        torch.cuda.empty_cache()
    out["projection"] = proj
    db = queries = truth = None

    # c. Stacked, variable chunks and the one-leaf tree on the phase-3
    # corpus with bench.py's tree-AH config.
    db, queries, truth = glove
    q_dev = torch.as_tensor(queries, device="cuda")
    bench_tree = dict(num_leaves=NUM_LEAVES,
                      num_leaves_to_search=LEAVES_TO_SEARCH,
                      training_sample_size=TRAIN_SAMPLE)
    models = {}
    for name, tree, ah in (
            ("stacked", bench_tree, dict(quantization_scheme="stacked")),
            ("variable", bench_tree,
             dict(variable_dims_per_block=VARIABLE_WIDTHS)),
            ("single_leaf", dict(num_leaves=1, num_leaves_to_search=1), {})):
        for lookup in ("reconstruct", "int8"):
            if name == "single_leaf" and lookup == "int8":
                continue
            def make():
                b = (scann_torch.builder(db, K, "dot_product").tree(**tree)
                     .score_ah(2, anisotropic_quantization_threshold=0.2,
                               **ah).reorder(AH_REORDER))
                config = b.create_config()
                return scann_torch.create_searcher(db, dataclasses.replace(
                    config, asymmetric_hash=dataclasses.replace(
                        config.asymmetric_hash, lookup_type=lookup)),
                    "cuda")
            s, build_s = timed_build(torch, make)
            nl = s.partitioner.num_leaves
            rec = {"build_s": build_s, "num_leaves": nl,
                   "bytes_per_vector": device_bytes(s) / N_DB}
            if lookup == "int8":
                qs = queries[:ENC_LUT_QUERIES]
                idx, wall, stages, got = counted(
                    s, qs, f"{name} int8", leaves_to_search=LEAVES_TO_SEARCH)
                if got:
                    raise AssertionError(f"{name} int8 lookup launched {got}")
                rec.update(recall=recall_at_k(idx, truth[:len(qs)]),
                           qps=len(qs) / wall, stage_ms=stages)
                rec["bytes_per_vector"] = device_bytes(s) / N_DB
                note(rec, f"{name} int8 lookup, dense scan, leaves="
                          f"{LEAVES_TO_SEARCH} ({len(qs)} queries)")
                models[f"{name}_int8"] = rec
                s = None
                torch.cuda.empty_cache()
                continue
            # The one-leaf tree: every search a full scan (at this size the
            # build's leaf-size cap splits the leaf, as in the JAX package).
            points = ((("pruned", LEAVES_TO_SEARCH),)
                      if name != "single_leaf" else ()) + (("full_scan", nl),)
            for what, lv in points:
                idx, wall, stages, got = counted(
                    s, queries, f"{name} {what}", leaves_to_search=lv)
                kernel = "pruned_rows" if what == "pruned" else "fused_scan"
                if not got.get(kernel):
                    raise AssertionError(f"{name} reconstruct {what} did not "
                                         f"launch {kernel}")
                rec[what] = {"leaves": lv, "recall": recall_at_k(idx, truth),
                             "qps": N_QUERY / wall, "launches": got,
                             "stage_ms": stages}
                log(f"{name} reconstruct {what} (leaves={lv}): recall@10 "
                    f"{rec[what]['recall']:.4f}, qps {N_QUERY / wall:.0f}, "
                    f"launches {got}, stage ms {stages}")
            if (name == "single_leaf"
                    and rec["full_scan"]["recall"] < RECON_FULL_SCAN_FLOOR):
                raise AssertionError(
                    f"{name} full scan recall@10 "
                    f"{rec['full_scan']['recall']:.4f} under "
                    f"{RECON_FULL_SCAN_FLOOR}")
            rec["bytes_per_vector"] = device_bytes(s) / N_DB
            log(f"{name} reconstruct: build {build_s:.1f} s, {nl} leaves, "
                f"{rec['bytes_per_vector']:.1f} B/vector on the card")
            if name != "single_leaf":
                kpg = tree_ah._survivors_per_group(
                    s._k_fetch(AH_REORDER), s._num_slots, nl)
                args = recon_k2_inputs(torch, s, q_dev, LEAVES_TO_SEARCH,
                                       False)
                got = pruned_scan.score_work(*args, measure_l2=False,
                                             kpg=kpg)
                want = pruned_scan.score_work_torch(*args, measure_l2=False,
                                                    kpg=kpg)
                torch.cuda.synchronize()
                err, ident = compare_packed(
                    torch, f"K2 ({name})", got, want, args[0], atol=K4_ATOL,
                    min_id=K2_MIN_ID_AGREE)
                errs["pruned_rows"] = max(errs.get("pruned_rows", 0.0), err)
                log(f"K2 vs plain on the {name} layout (kpg {kpg}): max "
                    f"|err| {err:.3g}, identities agree {ident:.6f}")
                del args, got, want
            rows, bias = s._recon_rows, s._recon_bias
            _, q_bf = s._recon_queries(q_dev[:SOAR_K5_QUERIES], rows.shape[1])
            got = fused_scan.fused_scan_groupmax(q_bf, rows, bias)
            want = fused_scan.fused_scan_groupmax_torch(q_bf, rows, bias)
            torch.cuda.synchronize()
            err, agree = compare_groupmax(torch, got, want, q_bf, rows, bias,
                                          1.0)
            errs["fused_scan"] = max(errs.get("fused_scan", 0.0), err)
            log(f"K5 vs plain on the {name} rows ({SOAR_K5_QUERIES} queries "
                f"x {rows.shape[0]} slots): max |err| {err:.3g}, slots agree "
                f"{agree:.6f}")
            models[f"{name}_reconstruct"] = rec
            s = rows = bias = q_bf = got = want = None
            torch.cuda.empty_cache()
    out["models"] = models
    db = queries = truth = glove = q_dev = None

    # d. Sparse: sparse_searcher's default above 100,000 rows (tree +
    # score_ah(2) + reorder(4k), K3) with the exact host rescore, and the
    # exact sparse scan on a slice.
    t0 = time.perf_counter()
    rows, qs = make_splade_like(torch, SPLADE_ROWS, SPLADE_QUERIES)
    truth, _ = sparse_truth(torch, rows, qs)
    gen_s = time.perf_counter() - t0
    db_m, q_m = sparse_mod.SparseMatrix(*rows), sparse_mod.SparseMatrix(*qs)
    nnz_row = len(db_m.indices) / SPLADE_ROWS
    nnz_q = len(q_m.indices) / SPLADE_QUERIES
    s, build_s = timed_build(torch, lambda: scann_torch.sparse_searcher(
        db_m, K, "dot_product"))
    inner = s.searcher
    sp = {"rows": SPLADE_ROWS, "nnz_per_row": nnz_row, "nnz_per_query":
          nnz_q, "corpus_and_truth_s": gen_s, "build_s": build_s,
          "num_leaves": inner.partitioner.num_leaves,
          "leaves_to_search": inner.part_cfg.num_leaves_to_search}
    idx, wall, stages, got = counted(s, q_m, "sparse searcher")
    if not got.get("pruned_lut"):
        raise AssertionError("the sparse searcher did not launch K3")
    sp.update(recall=recall_at_k(idx, truth), qps=SPLADE_QUERIES / wall,
              launches=got, stage_ms=stages,
              bytes_per_vector=device_bytes(inner) / SPLADE_ROWS)
    note(sp, "sparse_searcher (SPLADE-shaped, 256 hashed dims)")
    s = inner = None
    torch.cuda.empty_cache()
    sub = (db_m.indptr[:SPARSE_EXACT_ROWS + 1],
           db_m.indices[:db_m.indptr[SPARSE_EXACT_ROWS]],
           db_m.values[:db_m.indptr[SPARSE_EXACT_ROWS]],
           (SPARSE_EXACT_ROWS, SPLADE_VOCAB))
    q_sub = (q_m.indptr[:SPARSE_EXACT_QUERIES + 1],
             q_m.indices[:q_m.indptr[SPARSE_EXACT_QUERIES]],
             q_m.values[:q_m.indptr[SPARSE_EXACT_QUERIES]],
             (SPARSE_EXACT_QUERIES, SPLADE_VOCAB))
    want_i, want_v = sparse_truth(torch, sub, q_sub)
    ex, build_s = timed_build(torch, lambda: scann_torch.SparseExactSearcher(
        sparse_mod.SparseMatrix(*sub), K, "dot_product"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ei, ed = ex.search_batched(sparse_mod.SparseMatrix(*q_sub))
    wall = time.perf_counter() - t0
    found = float((want_i[:, :, None] == ei[:, None, :]).any(-1).mean())
    derr = float(np.abs(ed - want_v).max() / np.abs(want_v).max())
    sp["exact"] = {"rows": SPARSE_EXACT_ROWS,
                   "queries": SPARSE_EXACT_QUERIES, "build_s": build_s,
                   "qps": SPARSE_EXACT_QUERIES / wall, "ids_found": found,
                   "max_rel_dist_err": derr}
    note(sp["exact"], "SparseExactSearcher vs cuSPARSE top-10")
    if found < 0.999 or derr > 1e-4:
        raise AssertionError("SparseExactSearcher disagrees with the exact "
                             "product")
    out["sparse"] = sp
    launches["pruned_plan"] = pruned_scan.launches_plan
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13 launches: {launches}; {out['seconds']:.1f} s")
    for name, n in launches.items():
        if name != "pruned_codes" and n == 0:
            raise AssertionError(f"phase 13 never launched {name}")
    return launches, errs, out


# Phase 14: ROADMAP item 15, mutation and health, on the phase-3 corpus
# with bench.py's tree-AH config and docids "d{i}".  The index is built on
# the first MUT_BASE rows; the held-out rows are upserted in batches, then
# random original docids are deleted, existing docids updated with other
# rows' vectors and deleted docids re-inserted.  Recall@10 is taken
# against exact float32 brute force over the live rows, and held against a
# fresh build on the same live rows (rebalance()): deleting a tenth of a
# corpus of about 12 rows a topic removes true neighbours, so recall over
# the live rows is not comparable with phase 6's over the whole corpus.
MUT_BASE = 1_083_514
MUT_BATCHES, MUT_BATCH = 10, 10_000
MUT_UPDATES, MUT_REINSERT = 10_000, 1_000
MUT_QUERIES = 1_000         # the first search after each mutation batch
MUT_MAX_RECALL_LOSS = 0.01  # 14a against its rebalance (14d), 100 / 100
MUT_INCREMENTAL = 0.05      # 14c's incremental_threshold (a fraction)
MUT_INCREMENTAL_MAX_LOSS = 0.02   # 14c against its rebalance, 1,000 queries
MUT_BF_ROWS = 100_000       # 14f's brute-force corpus
MUT_BF_QUERIES = 1_000


def live_truth(torch, s, queries, k=K, block=256):
    """Docids of the exact float32 top-k over a mutable searcher's live
    rows (its host mirror), by dot product on the card."""
    st = s._mut
    live = np.nonzero(st.alive)[0]
    x = torch.as_tensor(st.vectors[live], device="cuda")
    q = torch.as_tensor(queries, device="cuda")
    tops = [torch.topk(q[i:i + block] @ x.T, k, dim=1).indices.cpu().numpy()
            for i in range(0, len(queries), block)]
    del x
    return np.asarray(s.docids, object)[live[np.concatenate(tops)]]


def docid_recall(idx, truth):
    return sum(len(set(r) & set(t)) for r, t in zip(idx, truth)) / (
        len(truth) * truth.shape[1])


def check_live(s, idx, gone, what):
    """Every result a live docid, and none of the deleted ones."""
    live = s._mut.docid_to_id
    flat = [d for row in idx for d in row]
    if any(d is None or d not in live for d in flat):
        raise AssertionError(f"{what}: a result is not a live docid")
    if set(flat) & gone:
        raise AssertionError(f"{what}: a deleted docid came back")


def mutation_sequence(torch, s, db, queries, seed=14):
    """14a / 14b's sequence on searcher ``s`` (built on db[:MUT_BASE] with
    docids d{i}); each batch is timed with the first search after it and
    the pruned-layout rebuild apart.  Returns (per-kind timing records,
    the docids deleted and not re-inserted)."""
    rng = np.random.default_rng(seed)
    recs = []
    slots0 = len(s._host["dpid"])

    def step(kind, n, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s._ensure_pruned()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        s.search_batched(queries[:MUT_QUERIES])
        t3 = time.perf_counter()
        recs.append({"kind": kind, "rows": n, "mutate_s": t1 - t0,
                     "rebuild_s": t2 - t1, "search_s": t3 - t2})
        log(f"  {kind} of {n} rows: {t1 - t0:.3f} s, pruned-layout rebuild "
            f"{t2 - t1:.3f} s, first search {t3 - t2:.3f} s")

    for b in range(MUT_BATCHES):
        lo = MUT_BASE + b * MUT_BATCH
        step("upsert", MUT_BATCH, lambda: s.upsert(
            [f"d{i}" for i in range(lo, lo + MUT_BATCH)],
            db[lo:lo + MUT_BATCH]))
    deleted = rng.choice(MUT_BASE, MUT_BATCHES * MUT_BATCH, replace=False)
    for b in range(MUT_BATCHES):
        part = deleted[b * MUT_BATCH:(b + 1) * MUT_BATCH]
        step("delete", MUT_BATCH,
             lambda: s.delete([f"d{i}" for i in part]))
    keep = np.setdiff1d(np.arange(MUT_BASE), deleted)
    upd = rng.choice(keep, MUT_UPDATES, replace=False)
    src = rng.choice(N_DB, MUT_UPDATES, replace=False)
    step("update", MUT_UPDATES, lambda: s.upsert(
        [f"d{i}" for i in upd], db[src]))
    back = deleted[:MUT_REINSERT]
    step("reinsert", MUT_REINSERT, lambda: s.upsert(
        [f"d{i}" for i in back], db[back]))
    if len(s._host["dpid"]) <= slots0:
        raise AssertionError("no upsert batch overflowed the free slots")
    out = {}
    for kind in ("upsert", "delete", "update", "reinsert"):
        rs = [r for r in recs if r["kind"] == kind]
        rows = sum(r["rows"] for r in rs)
        mut = sum(r["mutate_s"] for r in rs)
        srch = sum(r["search_s"] for r in rs)
        out[kind] = {"batches": len(rs), "rows": rows,
                     "rows_per_s": rows / (mut + srch), "mutate_s": mut,
                     "first_search_s": srch,
                     "rebuild_s": sum(r["rebuild_s"] for r in rs),
                     "rebuild_s_max": max(r["rebuild_s"] for r in rs)}
    out["slots"] = [slots0, len(s._host["dpid"])]
    return out, {f"d{i}" for i in deleted[MUT_REINSERT:]}


def mutation_phase(torch, scann_torch, db, queries, ah_at100):
    """Phase 14: ROADMAP item 15.  Returns (launches of K2, K3 and K5 in
    this phase's searches, the largest kernel-vs-plain error of each
    kernel held here, summary dict)."""
    from scann_torch.ops import fused_scan
    from scann_torch.ops import pruned_lut
    from scann_torch.ops import pruned_scan
    t_phase = time.perf_counter()
    launches = {"pruned_rows": 0, "pruned_lut": 0, "fused_scan": 0}
    pruned_scan.launches_plan = 0     # read once, at the phase's end
    errs = {}
    out = {}
    q_dev = torch.as_tensor(queries, device="cuda")
    tree = dict(num_leaves=NUM_LEAVES, num_leaves_to_search=LEAVES_TO_SEARCH,
                training_sample_size=TRAIN_SAMPLE)
    base_ids = [f"d{i}" for i in range(MUT_BASE)]

    def counted(s, qs, **kw):
        """A search with every kernel count set to 0 just before; its
        launches join the phase's."""
        pruned_scan.launches = pruned_lut.launches_lut = 0
        fused_scan.launches = 0
        idx, dist = s.search_batched(qs, **kw)
        got = {"pruned_rows": pruned_scan.launches,
               "pruned_lut": pruned_lut.launches_lut,
               "fused_scan": fused_scan.launches}
        for name, n in got.items():
            launches[name] += n
        if not np.isfinite(dist).all() or len(idx) != len(qs):
            raise AssertionError("bad results on a mutated index")
        return idx, {n: c for n, c in got.items() if c}

    def build(lookup, **extra):
        config = ah_config(scann_torch, db[:MUT_BASE], "dot_product", lookup,
                           "float32", **tree, **extra)
        return timed_build(torch, lambda: scann_torch.create_searcher(
            db[:MUT_BASE], config, "cuda", docids=base_ids))

    # a. int8 lookup (K3).
    a, build_s = build("int8")
    seq, gone = mutation_sequence(torch, a, db, queries)
    truth = live_truth(torch, a, queries)
    idx, got = counted(a, queries, leaves_to_search=LEAVES_TO_SEARCH,
                       pre_reorder_num_neighbors=AH_REORDER)
    if not got.get("pruned_lut"):
        raise AssertionError("the mutated int8-lookup index did not launch "
                             "K3")
    check_live(a, idx, gone, "14a")
    rec_a = docid_recall(idx, truth)
    a3 = ah_inputs(torch, a, q_dev, LEAVES_TO_SEARCH, False)
    kpg = tree_ah_kpg(a)
    k3_got = pruned_lut.score_work_lut(*a3, measure_l2=False, kpg=kpg)
    k3_want = k3_plain(*a3, measure_l2=False, kpg=kpg)
    torch.cuda.synchronize()
    errs["pruned_lut"], _ = compare_packed(torch, "K3 (mutated)", k3_got,
                                           k3_want, a3[0])
    n_act = int(a3[0].work_active.sum())
    del a3, k3_got, k3_want
    out["a"] = {"build_s": build_s, "sequence": seq, "recall": rec_a,
                "phase6_recall": ah_at100, "k3_active_items": n_act,
                "health": a.get_health_stats(),
                "num_leaves": a.partitioner.num_leaves,
                "live_rows": int(a._mut.alive.sum())}
    log(f"14a int8 lookup, mutated: recall@10 {rec_a:.4f} against the live "
        f"rows (phase 6 over the whole corpus: {ah_at100:.4f}), K3 "
        f"bit-equal on the mutated plan ({n_act} active items), sequence "
        f"{json.dumps(seq)}, health {out['a']['health']}")

    # e. the mutated index serialized with its docids and mutation state,
    # loaded on the card and on the CPU.
    q16 = queries[:16]
    kw = dict(leaves_to_search=LEAVES_TO_SEARCH)
    want = a.search_batched(q16, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        a.serialize(tmp)
        save_s = time.perf_counter() - t0
        gpu = scann_torch.load_searcher(tmp, device="cuda")
        cpu = scann_torch.load_searcher(tmp, device="cpu")
    for what, s in (("card", gpu), ("cpu", cpu)):
        got_i, got_d = s.search_batched(q16, **kw)
        same = np.mean([x == y for r, t in zip(got_i, want[0])
                        for x, y in zip(r, t)])
        err = np.abs(got_d - want[1]).max()
        if same < 0.99 or err > 1e-4 * np.abs(want[1]).max():
            raise AssertionError(f"14e: the reloaded index ({what}) "
                                 f"disagrees: ids {same:.4f}")
        if s._mut.mutations_since_rebuild != a._mut.mutations_since_rebuild:
            raise AssertionError("14e: the mutation count did not travel")
    out["e"] = {"save_s": save_s, "ids_equal": float(same)}
    log(f"14e: serialized in {save_s:.1f} s; the card and CPU reloads "
        f"return the mutated index's docids on 16 queries")
    del gpu, cpu

    # d. rebalance() on index a.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.rebalance()
    a._ensure_pruned()
    torch.cuda.synchronize()
    reb_s = time.perf_counter() - t0
    idx, _ = counted(a, queries, leaves_to_search=LEAVES_TO_SEARCH,
                     pre_reorder_num_neighbors=AH_REORDER)
    check_live(a, idx, gone, "14d")
    rec_d = docid_recall(idx, truth)
    out["d"] = {"rebalance_s": reb_s, "recall": rec_d,
                "num_leaves": a.partitioner.num_leaves,
                "health": a.get_health_stats()}
    log(f"14d rebalance: {reb_s:.1f} s, recall@10 {rec_d:.4f} (14a "
        f"{rec_a:.4f}), health {out['d']['health']}")
    if abs(rec_d - rec_a) > MUT_MAX_RECALL_LOSS:
        raise AssertionError(f"14a recall@10 {rec_a:.4f} is not within "
                             f"{MUT_MAX_RECALL_LOSS} of its rebalance's "
                             f"{rec_d:.4f}")
    a = None
    torch.cuda.empty_cache()

    # b. reconstruct mode (K2 pruned, K5 full scan), the same sequence.
    b, build_s = build("reconstruct")
    nl = b.partitioner.num_leaves
    counted(b, queries[:MUT_QUERIES], leaves_to_search=nl)  # rows in place
    seq, gone_b = mutation_sequence(torch, b, db, queries)
    if gone_b != gone:
        raise AssertionError("14b's sequence differs from 14a's")
    rec_b = {}
    for what, lv in (("pruned", LEAVES_TO_SEARCH), ("full_scan", nl)):
        idx, got = counted(b, queries, leaves_to_search=lv,
                           pre_reorder_num_neighbors=AH_REORDER)
        kernel = "pruned_rows" if what == "pruned" else "fused_scan"
        if not got.get(kernel):
            raise AssertionError(f"14b {what} did not launch {kernel}")
        check_live(b, idx, gone, f"14b {what}")
        rec_b[what] = docid_recall(idx, truth)
    args = recon_k2_inputs(torch, b, q_dev, LEAVES_TO_SEARCH, False)
    kpg = tree_ah_kpg(b)
    k2_got = pruned_scan.score_work(*args, measure_l2=False, kpg=kpg)
    k2_want = pruned_scan.score_work_torch(*args, measure_l2=False, kpg=kpg)
    torch.cuda.synchronize()
    errs["pruned_rows"], ident = compare_packed(
        torch, "K2 (mutated)", k2_got, k2_want, args[0], atol=K4_ATOL,
        min_id=K2_MIN_ID_AGREE)
    del args, k2_got, k2_want
    rows, bias = b._recon_rows, b._recon_bias
    _, q_bf = b._recon_queries(q_dev[:SOAR_K5_QUERIES], rows.shape[1])
    k5_got = fused_scan.fused_scan_groupmax(q_bf, rows, bias)
    k5_want = fused_scan.fused_scan_groupmax_torch(q_bf, rows, bias)
    torch.cuda.synchronize()
    errs["fused_scan"], agree = compare_groupmax(torch, k5_got, k5_want,
                                                 q_bf, rows, bias, 1.0)
    out["b"] = {"build_s": build_s, "sequence": seq, "recall": rec_b,
                "k2_identities": ident, "k5_slots_agree": agree,
                "slots": int(rows.shape[0])}
    log(f"14b reconstruct, mutated: recall@10 {rec_b}, K2 max |err| "
        f"{errs['pruned_rows']:.3g} (identities {ident:.6f}), K5 max |err| "
        f"{errs['fused_scan']:.3g} (slots {agree:.6f}, {rows.shape[0]} "
        f"slots), sequence {json.dumps(seq)}")
    b = rows = bias = q_bf = k5_got = k5_want = None
    torch.cuda.empty_cache()

    # c. online_incremental maintenance: skewed upserts split, a drained
    # leaf merges.
    c, build_s = build("int8", incremental_threshold=MUT_INCREMENTAL,
                       incremental_mode="online_incremental")
    events = []
    maint = c.incremental_maintenance

    def predict():
        """Splits and merges the maintenance rule will make now."""
        t = c.datapoint_to_token
        alive = c._mut.alive[:len(t)]
        counts = np.bincount(t[alive, 0], minlength=c.partitioner.num_leaves)
        avg = max(1.0, counts.mean())
        splits = min(4, int((counts > 2.0 * avg).sum()))
        nz = counts[counts > 0]
        under = (counts < max(2.0, 0.05 * max(1.0, nz.mean()))) \
            & (c._leaf_deletions > 0)
        return splits, min(4, int(under.sum()))

    def maintenance(*args, **kw):
        splits, merges = predict()
        before = (c.partitioner.num_leaves, c.get_health_stats())
        t0 = time.perf_counter()
        changed = maint(*args, **kw)
        torch.cuda.synchronize()
        events.append({"predicted_splits": splits,
                       "predicted_merges": merges, "changed": changed,
                       "leaves": [before[0], c.partitioner.num_leaves],
                       "weighted_imbalance": [
                           before[1][
                               "partition_weighted_avg_relative_imbalance"],
                           c.get_health_stats()[
                               "partition_weighted_avg_relative_imbalance"]],
                       "seconds": time.perf_counter() - t0})
        return changed

    c.incremental_maintenance = maintenance
    prim = c.datapoint_to_token[:, 0]
    big = int(np.bincount(prim).argmax())
    members = np.nonzero(prim == big)[0]
    rng = np.random.default_rng(15)
    need = int(MUT_INCREMENTAL * MUT_BASE) + MUT_BATCH
    n_up = 0
    while not events:
        src = db[rng.choice(members, MUT_BATCH)]
        rows = src + 0.01 * rng.standard_normal(src.shape).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        c.upsert([f"s{i}" for i in range(n_up, n_up + MUT_BATCH)], rows)
        n_up += MUT_BATCH
        if n_up > need:
            raise AssertionError("14c: the skewed upserts never maintained")
    alive_prim = c.datapoint_to_token[:, 0]
    counts = np.bincount(alive_prim[c._mut.alive],
                         minlength=c.partitioner.num_leaves)
    nonempty = np.nonzero(counts > 0)[0]
    drain = int(nonempty[np.argmin(counts[nonempty])])
    gone_c = [c.docids[i] for i in np.nonzero(c._mut.alive
                                              & (alive_prim == drain))[0]]
    others = np.setdiff1d(np.nonzero(c._mut.alive)[0],
                          np.nonzero(alive_prim == drain)[0])
    pool = rng.permutation(others)
    n_del, p = 0, 0
    c.delete(gone_c)
    n_del += len(gone_c)
    while len(events) < 2:
        part = pool[p:p + MUT_BATCH]
        p += MUT_BATCH
        c.delete([c.docids[i] for i in part])
        n_del += len(part)
        if p > len(pool):
            raise AssertionError("14c: the deletes never maintained")
    for e in events:
        if e["leaves"][1] - e["leaves"][0] != \
                e["predicted_splits"] - e["predicted_merges"] or \
                e["changed"] != e["predicted_splits"] + e["predicted_merges"]:
            raise AssertionError(f"14c: maintenance did not change the "
                                 f"leaves as predicted: {e}")
    if events[0]["predicted_splits"] < 1 or events[1]["predicted_merges"] < 1:
        raise AssertionError(f"14c: no split or no merge fired: {events}")
    if events[0]["weighted_imbalance"][1] >= \
            events[0]["weighted_imbalance"][0]:
        raise AssertionError("14c: the split did not lower the weighted "
                             "imbalance")
    qs = queries[:MUT_QUERIES]
    idx, got = counted(c, qs, leaves_to_search=LEAVES_TO_SEARCH,
                       pre_reorder_num_neighbors=AH_REORDER)
    check_live(c, idx, set(), "14c")
    truth_c = live_truth(torch, c, qs)
    rec_c = docid_recall(idx, truth_c)
    c._ensure_pruned()
    out["c"] = {"build_s": build_s, "skewed_upserts": n_up,
                "deletes": n_del, "drained_leaf_rows": len(gone_c),
                "maintenance": events, "recall": rec_c, "launches": got,
                "pruned_layout": c._pruned_built,
                "health": c.get_health_stats()}
    c.rebalance()
    idx, _ = counted(c, qs, leaves_to_search=LEAVES_TO_SEARCH,
                     pre_reorder_num_neighbors=AH_REORDER)
    out["c"]["rebalanced_recall"] = docid_recall(idx, truth_c)
    log(f"14c online_incremental: {n_up} skewed upserts, {n_del} deletes "
        f"({len(gone_c)} drained one leaf), maintenance {events}, recall@10 "
        f"{rec_c:.4f} on {len(qs)} queries (rebalanced: "
        f"{out['c']['rebalanced_recall']:.4f}), launches {got}, pruned "
        f"layout {out['c']['pruned_layout']}, health {out['c']['health']}")
    if rec_c < out["c"]["rebalanced_recall"] - MUT_INCREMENTAL_MAX_LOSS:
        raise AssertionError(f"14c recall@10 {rec_c:.4f} is under its "
                             f"rebalance's less {MUT_INCREMENTAL_MAX_LOSS}")
    c = None
    torch.cuda.empty_cache()

    # f. brute force (float32, int8) with docids against numpy exact.
    bf = {}
    qs = queries[:MUT_BF_QUERIES]
    for quant in ("float32", "int8"):
        s = (scann_torch.builder(db[:MUT_BF_ROWS], K, "dot_product")
             .score_brute_force(quant).build(
                 docids=[f"d{i}" for i in range(MUT_BF_ROWS)]))
        n_new = MUT_BF_ROWS // 10
        s.upsert([f"d{i}" for i in range(MUT_BF_ROWS, MUT_BF_ROWS + n_new)],
                 db[MUT_BF_ROWS:MUT_BF_ROWS + n_new])
        dele = rng.choice(MUT_BF_ROWS, n_new, replace=False)
        s.delete([f"d{i}" for i in dele])
        idx, dist = s.search_batched(qs)
        live = np.nonzero(s._mut.alive)[0]
        rows = s._db[torch.as_tensor(live, device="cuda")].float().cpu().numpy()
        qn = qs
        if s._inv_mult is not None:
            qn = qs * s._inv_mult.cpu().numpy()[None, :]
        sims = qn @ rows.T
        top = np.argsort(-sims, axis=1, kind="stable")[:, :K]
        want = np.asarray(s.docids, object)[live[top]]
        found = np.mean([len(set(r) & set(t)) / K for r, t in zip(idx, want)])
        derr = float(np.abs(np.take_along_axis(sims, top, 1) - dist).max())
        check_live(s, idx, {f"d{i}" for i in dele}, f"14f {quant}")
        bf[quant] = {"ids_found": found, "max_dist_err": derr}
        if found < 0.999 or derr > 1e-3:
            raise AssertionError(f"14f {quant} brute force disagrees with "
                                 f"numpy exact: ids {found:.4f}")
        s = None
    out["f"] = bf
    log(f"14f brute force with docids against numpy exact: {bf}")
    launches["pruned_plan"] = pruned_scan.launches_plan
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 launches: {launches}; {out['seconds']:.1f} s")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"phase 14 never launched {name}")
    return launches, errs, out


# Phase 15: ROADMAP items 17 (config tooling), 18 (serving and export) and
# 20 (profiling) on the phase-3 corpus, through the kernels of phases 4-7.
_KERNEL_COUNTERS = (
    ("pruned_sq", "pruned_sq", "launches"),
    ("pruned_rows", "pruned_scan", "launches"),
    ("pruned_lut", "pruned_lut", "launches_lut"),
    ("pruned_codes", "pruned_lut", "launches_codes"),
    ("fused_scan", "fused_scan", "launches"),
    ("merge_groups", "pruned_scan", "launches_merge"),
    ("pruned_plan", "pruned_scan", "launches_plan"))

# Run in a fresh process: reload each exported program with only
# scann_torch.export, search the queries, and report the kernels each
# search launched.
_RELOAD_EXPORTS = r"""
import json, sys, time
import numpy as np
import torch
from scann_torch import export
from scann_torch.ops import fused_scan, pruned_lut, pruned_scan, pruned_sq
mods = {"pruned_sq": pruned_sq, "pruned_scan": pruned_scan,
        "pruned_lut": pruned_lut, "fused_scan": fused_scan}
counters = json.loads(sys.argv[3])
spec = json.load(open(sys.argv[1]))
queries = np.load(spec["queries"])
out = {}
for name, path in spec["exports"].items():
    t0 = time.perf_counter()
    ex = export.load_exported_searcher(path)
    load_s = time.perf_counter() - t0
    for _, mod, attr in counters:
        setattr(mods[mod], attr, 0)
    t0 = time.perf_counter()
    idx, dist = ex.search_batched(queries)
    search_s = time.perf_counter() - t0
    np.save(path + "/reloaded_idx.npy", idx)
    np.save(path + "/reloaded_dist.npy", dist)
    out[name] = {"load_s": load_s, "search_s": search_s,
                 "launches": {k: getattr(mods[mod], attr)
                              for k, mod, attr in counters}}
    del ex
    torch.cuda.empty_cache()
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.",
                                                             "scann_tpu"))]
assert not bad, bad
json.dump(out, open(sys.argv[2], "w"))
"""


def kernel_counts():
    """The seven kernels' launch counters, by kernel name."""
    import importlib
    return {name: getattr(importlib.import_module(f"scann_torch.ops.{mod}"),
                          attr) for name, mod, attr in _KERNEL_COUNTERS}


def zero_counts():
    import importlib
    for _, mod, attr in _KERNEL_COUNTERS:
        setattr(importlib.import_module(f"scann_torch.ops.{mod}"), attr, 0)


def ids_agree(a, b):
    return float(np.mean(np.asarray(a) == np.asarray(b)))


def hold_answers(got_idx, got_dist, want_idx, want_dist, what):
    """ids >= ENTRY_ID_AGREE equal, distances within ENTRY_DIST_RTOL
    relative where they are; returns the id agreement."""
    got_idx, want_idx = np.asarray(got_idx), np.asarray(want_idx)
    agree = ids_agree(got_idx, want_idx)
    same = got_idx == want_idx
    gd, wd = np.asarray(got_dist)[same], np.asarray(want_dist)[same]
    err = float(np.max(np.abs(gd - wd) / np.maximum(np.abs(wd), 1e-30),
                       initial=0.0))
    if agree < ENTRY_ID_AGREE or err > ENTRY_DIST_RTOL:
        raise AssertionError(f"{what}: ids agree on {agree:.6f} (needs "
                             f">= {ENTRY_ID_AGREE}), distances within "
                             f"{err:.3g} relative (needs <= "
                             f"{ENTRY_DIST_RTOL})")
    return agree


def trace_share(torch, searcher, queries, trace_dir):
    """One search_batched inside profiling.trace: (device-busy share of
    the traced window, idle share, the five longest device operations by
    summed ms), from the Chrome trace's device events; (None, None, [])
    when the trace holds no device event."""
    from scann_torch.utils import profiling
    searcher.search_batched(queries)
    torch.cuda.synchronize()
    with profiling.trace(trace_dir):
        searcher.search_batched(queries)
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset")]
    if not dev:
        return None, None, []
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, t0
    for e in sorted(dev, key=lambda e: e["ts"]):
        a, b = max(e["ts"], end), e["ts"] + e["dur"]
        if b > a:
            busy += b - a
            end = b
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    share = busy / (t1 - t0)
    return share, 1.0 - share, [(n[:90], round(ms, 3)) for n, ms in top]


def entry_points_phase(torch, scann_torch, db, queries, truth, sq_dir, ref,
                       work):
    """Phase 15: the entry points.  ``sq_dir``: phase 5's serialized tree-SQ
    index; ``ref``: phase 6's reference-format int8-lookup index (its
    directory, the live ids it is held to, the save's seconds, the
    residual-int8 refusal's message).  Returns (launches of the six
    kernels in this phase's searches and reloaded exports, summary
    dict)."""
    from scann_torch import export as texport
    t_phase = time.perf_counter()
    launches = {name: 0 for name, _, _ in _KERNEL_COUNTERS}
    out = {}

    def counted(fn, *args, **kw):
        zero_counts()
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kernel_counts()
        for name, n in got.items():
            launches[name] += n
        return res, wall, {n: c for n, c in got.items() if c}

    # a. Config text.
    text_b = scann_torch.builder_from_pbtxt(db, TREE_SQ_PBTXT)
    want_cfg = (scann_torch.builder(db, K, "dot_product")
                .tree(num_leaves=NUM_LEAVES,
                      num_leaves_to_search=LEAVES_TO_SEARCH,
                      training_sample_size=TRAIN_SAMPLE)
                .score_brute_force(quantize="int8").create_config())
    if text_b.create_config().to_json() != want_cfg.to_json():
        raise AssertionError("15a: the text proto's config differs from "
                             "phase 3's builder config")
    t0 = time.perf_counter()
    s = text_b.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s.search_batched(queries)
    (idx, dist), wall, got = counted(s.search_batched, queries,
                                     leaves_to_search=LEAVES_TO_SEARCH)
    check_results(queries, db, idx, dist, "15a", True)
    rec = recall_at_k(idx, truth)
    if not got.get("pruned_sq") or rec < RECALL_FLOOR_AT_100:
        raise AssertionError(f"15a: recall@10 {rec:.4f} (floor "
                             f"{RECALL_FLOOR_AT_100}), launches {got}")
    out["a"] = {"build_s": build_s, "recall": rec, "qps": N_QUERY / wall,
                "launches": got}
    log(f"15a searcher_from_pbtxt (bench.py's tree-SQ config as text): "
        f"config equal to the builder's, built in {build_s:.1f} s, leaves="
        f"{LEAVES_TO_SEARCH} recall@10 {rec:.4f}, qps {N_QUERY / wall:.0f}, "
        f"launches {got}")
    del s, idx, dist
    torch.cuda.empty_cache()

    # b. Autopilot.
    out["b"] = {}
    for engine, kernel in (("tree_ah", "pruned_lut"), ("tree_sq",
                                                         "pruned_sq")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = scann_torch.builder(db, K, "dot_product").autopilot(
            engine=engine).build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        s.search_batched(queries)
        (idx, dist), wall, got = counted(s.search_batched, queries)
        check_results(queries, db, idx, dist, f"15b {engine}",
                      engine == "tree_ah")
        rec = recall_at_k(idx, truth)
        leaves, nl = s.part_cfg.num_leaves_to_search, \
            s.partitioner.num_leaves
        rec_b = {"config": json.loads(s.config.to_json()),
                 "build_s": build_s, "recall": rec, "qps": N_QUERY / wall,
                 "leaves_to_search": leaves, "num_leaves": nl,
                 "launches": got}
        out["b"][engine] = rec_b
        if not got.get(kernel):
            raise AssertionError(f"15b autopilot {engine} did not launch "
                                 f"{kernel}: {got}")
        if engine == "tree_ah" and rec < AH_RECALL_FLOOR_AT_100:
            raise AssertionError(f"15b autopilot tree_ah recall@10 "
                                 f"{rec:.4f} is under "
                                 f"{AH_RECALL_FLOOR_AT_100}")
        if engine == "tree_sq":
            rec_b["reaches_target"] = rec >= AUTOPILOT_SQ_TARGET
        log(f"15b autopilot(engine={engine!r}): config "
            f"{json.dumps(rec_b['config'])}"
            f"; {nl} leaves after splits, {leaves} searched "
            f"({leaves / nl:.4f}), built in {build_s:.1f} s, recall@10 "
            f"{rec:.4f}, qps {N_QUERY / wall:.0f}, launches {got}"
            + (f", target {AUTOPILOT_SQ_TARGET} reached: "
               f"{rec_b['reaches_target']}" if engine == "tree_sq" else ""))
        del s, idx, dist
        torch.cuda.empty_cache()

    # c. Reference assets (written in phase 6).
    ref_dir, ref_ids, ref_save_s, refusal = ref
    if not refusal.startswith("ValueError"):
        raise AssertionError(f"15c: the residual-int8 index did not refuse "
                             f"without lossy_reorder_downgrade: {refusal}")
    t0 = time.perf_counter()
    ah = scann_torch.load_reference_assets(ref_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    kw_ah = dict(leaves_to_search=LEAVES_TO_SEARCH,
                 pre_reorder_num_neighbors=AH_REORDER)
    (ah_idx, ah_dist), wall, got = counted(ah.search_batched, queries,
                                           **kw_ah)
    agree = ids_agree(ah_idx, ref_ids)
    if agree < ENTRY_ID_AGREE or not got.get("pruned_lut"):
        raise AssertionError(f"15c: reloaded ids agree on {agree:.6f}, "
                             f"launches {got}")
    ref_bytes = sum(os.path.getsize(os.path.join(ref_dir, f))
                    for f in os.listdir(ref_dir))
    out["c"] = {"save_s": ref_save_s, "load_s": load_s, "bytes": ref_bytes,
                "ids_agree": agree, "launches": got, "refusal": refusal}
    log(f"15c reference assets: saved in {ref_save_s:.1f} s ({ref_bytes} "
        f"bytes), loaded on the card in {load_s:.1f} s, ids agree "
        f"{agree:.6f} with the live index at leaves {LEAVES_TO_SEARCH} / "
        f"{AH_REORDER}, launches {got}; residual int8 reorder: {refusal}")

    # d. Serving phase 5's index.
    import http.client
    import threading
    server = scann_torch.serve(sq_dir, host="127.0.0.1", port=0, block=False)
    ss = server.searcher
    try:
        (sq_idx, sq_dist), _, _ = counted(ss.search_batched, queries)
        zero_counts()
        lat = [0.0] * SERVE_SINGLE
        answers = [None] * SERVE_SINGLE
        errors = []
        server.service.batches = server.service.queries = 0

        def client(lo):
            try:
                for i in range(lo, SERVE_SINGLE, SERVE_CLIENTS):
                    body = json.dumps({"query": queries[i].tolist()})
                    t0 = time.perf_counter()
                    conn = http.client.HTTPConnection(server.host,
                                                      server.port,
                                                      timeout=120)
                    conn.request("POST", "/search", body=body, headers={
                        "Content-Type": "application/json"})
                    resp = conn.getresponse()
                    data = json.loads(resp.read())
                    conn.close()
                    lat[i] = time.perf_counter() - t0
                    if resp.status != 200:
                        raise RuntimeError(f"/search {resp.status}: {data}")
                    answers[i] = data
            except Exception as e:
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        single_wall = time.perf_counter() - t0
        if errors:
            raise AssertionError(f"15d single queries failed: {errors[:3]}")
        mean_batch = server.service.queries / max(server.service.batches, 1)
        single_agree = hold_answers(
            [a["indices"][0] for a in answers],
            [a["distances"][0] for a in answers], sq_idx[:SERVE_SINGLE],
            sq_dist[:SERVE_SINGLE], "15d /search")
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", "/search_batched", body=queries.tobytes(),
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        batched_wall = time.perf_counter() - t0
        conn.close()
        if resp.status != 200:
            raise AssertionError(f"15d /search_batched {resp.status}")
        batched_agree = hold_answers(data["indices"], data["distances"],
                                     sq_idx, sq_dist, "15d /search_batched")
        got = {n: c for n, c in kernel_counts().items() if c}
        for name, n in kernel_counts().items():
            launches[name] += n
        if not got.get("pruned_sq"):
            raise AssertionError(f"15d: serving launched no K1: {got}")
        # Double buffering pays when search_batched_async returns before
        # the card finishes: its dispatch against its finalize.
        disp, fin = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = ss.search_batched_async(queries)
            t1 = time.perf_counter()
            pending.result()
            t2 = time.perf_counter()
            disp.append(t1 - t0)
            fin.append(t2 - t1)
        lat_ms = np.asarray(lat) * 1e3
        out["d"] = {"single_qps": SERVE_SINGLE / single_wall,
                    "p50_ms": float(np.percentile(lat_ms, 50)),
                    "p99_ms": float(np.percentile(lat_ms, 99)),
                    "mean_micro_batch": mean_batch,
                    "batched_qps": N_QUERY / batched_wall,
                    "single_ids_agree": single_agree,
                    "batched_ids_agree": batched_agree,
                    "dispatch_ms": float(np.median(disp)) * 1e3,
                    "finalize_ms": float(np.median(fin)) * 1e3,
                    "launches": got}
        log(f"15d serving: {SERVE_SINGLE} /search calls from "
            f"{SERVE_CLIENTS} threads at {out['d']['single_qps']:.0f} qps, "
            f"latency p50 {out['d']['p50_ms']:.2f} ms p99 "
            f"{out['d']['p99_ms']:.2f} ms, mean micro-batch "
            f"{mean_batch:.1f}, ids agree {single_agree:.6f}; one "
            f"octet-stream /search_batched of {N_QUERY} at "
            f"{out['d']['batched_qps']:.0f} qps, ids agree "
            f"{batched_agree:.6f}; search_batched_async dispatch "
            f"{out['d']['dispatch_ms']:.2f} ms, finalize "
            f"{out['d']['finalize_ms']:.2f} ms; launches {got}")
    finally:
        server.stop()

    # f. The first trace.
    zero_counts()
    share, idle, top = trace_share(torch, ss, queries,
                                   os.path.join(work, "trace"))
    for name, n in kernel_counts().items():
        launches[name] += n
    out["f"] = {"busy_share": share, "idle_share": idle, "top": top}
    log(f"15f trace of one {N_QUERY}-query tree-SQ search at leaves "
        f"{LEAVES_TO_SEARCH}: device busy share "
        + ("not measured (no device events in the trace)" if share is None
           else f"{share:.4f}, idle {idle:.4f}, longest device operations "
           f"(ms) {top}"))

    # e. Export: tree-SQ and tree-AH int8 at full size, then the other
    # kernels' engines on the first EXPORT_ROWS rows.
    exports, live = {}, {}

    def export(name, searcher, want, **kw):
        path = os.path.join(work, "export", name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texport.save_exported_searcher(path, searcher,
                                       batch_sizes=(EXPORT_BUCKET,), **kw)
        secs = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        exports[name] = path
        live[name] = want
        out.setdefault("e", {})[name] = {"export_s": secs, "bytes": nbytes}

    export("tree_sq_l100", ss, (sq_idx, sq_dist))
    export("tree_ah_l100", ah, (ah_idx, ah_dist), **kw_ah)
    del ss, ah, server
    torch.cuda.empty_cache()
    sub = db[:EXPORT_ROWS]
    tree = dict(num_leaves=NUM_LEAVES, num_leaves_to_search=LEAVES_TO_SEARCH,
                training_sample_size=EXPORT_ROWS)
    recon = scann_torch.create_searcher(
        sub, ah_config(scann_torch, sub, "dot_product", "reconstruct",
                       "float32", **tree), "cuda")
    nl = recon.partitioner.num_leaves
    for name, leaves, kernel in (("reconstruct_l100", LEAVES_TO_SEARCH,
                                  "pruned_rows"),
                                 ("reconstruct_full", nl, "fused_scan")):
        res, _, got = counted(recon.search_batched, queries,
                              leaves_to_search=leaves)
        if not got.get(kernel):
            raise AssertionError(f"15e live {name} launched no {kernel}")
        export(name, recon, res, leaves_to_search=leaves)
    del recon
    flt = scann_torch.create_searcher(
        sub, ah_config(scann_torch, sub, "dot_product", "float32", "float32",
                       **tree), "cuda")
    res, _, got = counted(flt.search_batched, queries)
    if not got.get("pruned_codes"):
        raise AssertionError("15e live float32 lookup launched no K4")
    export("float32_lookup_l100", flt, res)
    del flt
    sq = (scann_torch.builder(sub, K, "dot_product").tree(**tree)
          .score_brute_force(quantize="int8").build())
    os.environ["SCANN_TORCH_FUSED_MERGE"] = "1"
    try:
        res, _, got = counted(sq.search_batched, queries)
        if not got.get("merge_groups"):
            raise AssertionError("15e live fused merge launched no K6")
        export("tree_sq_fused_merge", sq, res)
    finally:
        del os.environ["SCANN_TORCH_FUSED_MERGE"]
    del sq
    torch.cuda.empty_cache()
    qpath = os.path.join(work, "queries.npy")
    np.save(qpath, queries)
    spec_path = os.path.join(work, "exports.json")
    with open(spec_path, "w") as f:
        json.dump({"queries": qpath, "exports": exports}, f)
    res_path = os.path.join(work, "reloaded.json")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _RELOAD_EXPORTS, spec_path, res_path,
         json.dumps(_KERNEL_COUNTERS)], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"15e reload process failed:\n{proc.stderr}")
    reload_s = time.perf_counter() - t0
    with open(res_path) as f:
        reloaded = json.load(f)
    want_kernel = {"tree_sq_l100": "pruned_sq", "tree_ah_l100": "pruned_lut",
                   "reconstruct_l100": "pruned_rows",
                   "reconstruct_full": "fused_scan",
                   "float32_lookup_l100": "pruned_codes",
                   "tree_sq_fused_merge": "merge_groups"}
    for name, path in exports.items():
        r = reloaded[name]
        agree = hold_answers(np.load(os.path.join(path, "reloaded_idx.npy")),
                             np.load(os.path.join(path,
                                                  "reloaded_dist.npy")),
                             *live[name], f"15e {name}")
        got = {n: c for n, c in r["launches"].items() if c}
        if not got.get(want_kernel[name]):
            raise AssertionError(f"15e reloaded {name} launched no "
                                 f"{want_kernel[name]}: {got}")
        for n, c in got.items():
            launches[n] += c
        out["e"][name].update(load_s=r["load_s"], search_s=r["search_s"],
                              ids_agree=agree, launches=got)
        log(f"15e export {name}: exported in "
            f"{out['e'][name]['export_s']:.1f} s, {out['e'][name]['bytes']} "
            f"bytes; reloaded in a fresh process in {r['load_s']:.1f} s, "
            f"{N_QUERY} queries in {r['search_s']:.2f} s, ids agree "
            f"{agree:.6f}, launches {got}")
    out["e_reload_process_s"] = reload_s
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 launches: {launches}; {out['seconds']:.1f} s")
    for name, n in launches.items():
        if not n:
            raise AssertionError(f"phase 15 never launched {name}")
    return launches, out


# Phase 16: the sharded index (ROADMAP item 19) on a (1, 1) NCCL mesh.
# Its recall floors, from this run: phase 6's residual-int8 reading at
# leaves 100 / pre 100 less 0.01 (the same codes and leaves, every slot of
# them scored; int8-LUT ties may fall otherwise), phase 5's at leaves 100
# less 0.002 (exact within the leaves), and the builds at phases 6's and
# 5's floors.  The held-out rows of 16e are the 10,000 queries (unit
# vectors, so each is its own best match).
SHARDED_AH_SLACK, SHARDED_SQ_SLACK = 0.01, 0.002


def sharded_search(torch, s, queries, **kw):
    """One warm-up on 1,000 queries, then the timed search."""
    s.search_batched(queries[:1000], **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, dist = s.search_batched(queries, **kw)
    torch.cuda.synchronize()
    return idx, dist, len(queries) / (time.perf_counter() - t0)


def sharded_phase(torch, scann_torch, db, queries, truth, sq_dir, ah_dir,
                  sq_at100, ah_i8_at100, work):
    """Phase 16: ShardedTreeAHSearcher on the card.  ``sq_dir`` / ``ah_dir``:
    phases 5's and 6's serialized tree-SQ and residual-int8 tree-AH
    indexes, ``sq_at100`` / ``ah_i8_at100`` their recall@10 at leaves 100.
    Returns (the seven kernels' launches in this phase, summary dict)."""
    import torch.distributed as dist
    from scann_torch.parallel import build as build_mod
    from scann_torch.parallel import launch
    from scann_torch.parallel import mesh as mesh_mod
    t_phase = time.perf_counter()
    out = {}
    zero_counts()
    store = dist.FileStore(os.path.join(work, "mesh_store"), 1)
    mesh = launch.init_mesh(1, 1, store=store, device_type="cuda")

    def card_bytes(s):
        return sum(t.numel() * t.element_size() for t in s.state.values()
                   ) / s.n_points

    def hold(name, idx, dist_, qps, floor, extra=""):
        check_results(queries, db, idx, dist_, f"sharded {name}", True)
        r = recall_at_k(idx, truth)
        log(f"sharded {name}: recall@10 {r:.4f} (floor {floor:.4f}), "
            f"{qps:.0f} QPS{extra}")
        if r < floor:
            raise AssertionError(f"sharded {name}: recall@10 {r:.4f} is "
                                 f"under {floor:.4f}")
        return r

    try:
        # a, b. from_searcher of phases 6's and 5's indexes.
        for name, path, kw, floor in (
                ("from_tree_ah_int8", ah_dir,
                 dict(leaves_to_search=100, pre_reorder_num_neighbors=100),
                 ah_i8_at100 - SHARDED_AH_SLACK),
                ("from_tree_sq", sq_dir, dict(leaves_to_search=100),
                 sq_at100 - SHARDED_SQ_SLACK)):
            single = scann_torch.load_searcher(path, device="cuda")
            t0 = time.perf_counter()
            s = mesh_mod.ShardedTreeAHSearcher.from_searcher(single, db, mesh)
            torch.cuda.synchronize()
            reshard_s = time.perf_counter() - t0
            del single
            idx, dist_, qps = sharded_search(torch, s, queries, **kw)
            out[name] = {"recall": hold(name, idx, dist_, qps, floor,
                                        f", resharded in {reshard_s:.1f} s"),
                         "floor": floor, "qps": qps, "reshard_s": reshard_s,
                         "format": s.leaf_format,
                         "card_bytes_per_vector": card_bytes(s)}
            del s
            torch.cuda.empty_cache()
        # c. build_sharded of bench.py's tree-AH and tree-SQ configs.
        tree = dict(num_leaves=NUM_LEAVES,
                    num_leaves_to_search=LEAVES_TO_SEARCH,
                    training_sample_size=TRAIN_SAMPLE)
        configs = {
            "build_tree_ah": (ah_config(scann_torch, db, "dot_product",
                                        "int8", "int8", **tree),
                              AH_RECALL_FLOOR_AT_100),
            "build_tree_sq": (scann_torch.builder(db, K, "dot_product")
                              .tree(**tree).score_brute_force(quantize="int8")
                              .create_config(), RECALL_FLOOR_AT_100)}
        built = {}
        for name, (config, floor) in configs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = build_mod.build_sharded(db, config, mesh)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            idx, dist_, qps = sharded_search(torch, s, queries)
            out[name] = {"recall": hold(name, idx, dist_, qps, floor,
                                        f", built in {build_s:.1f} s"),
                         "floor": floor, "qps": qps, "build_s": build_s,
                         "num_leaves": s.num_leaves,
                         "card_bytes_per_vector": card_bytes(s)}
            built[name] = (s, idx)
        # d. serialize -> load_sharded: the same ids on every query.
        s, idx = built["build_tree_ah"]
        t0 = time.perf_counter()
        s.serialize(os.path.join(work, "sharded"))
        s2 = mesh_mod.load_sharded(os.path.join(work, "sharded"), mesh)
        round_s = time.perf_counter() - t0
        idx2, _ = s2.search_batched(queries)
        agree = ids_agree(idx, idx2)
        del s2
        log(f"sharded serialize + load_sharded in {round_s:.1f} s: ids "
            f"equal on {agree:.6f}")
        if agree != 1.0:
            raise AssertionError("load_sharded changed the answers")
        out["reload"] = {"ids_equal": agree, "seconds": round_s}
        # e. upsert the 10,000 held-out rows, delete 10,000 ids.
        new_ids = np.arange(N_DB, N_DB + len(queries))
        t0 = time.perf_counter()
        s.upsert(new_ids, queries)
        torch.cuda.synchronize()
        up_s = time.perf_counter() - t0
        idx, _ = s.search_batched(queries)
        first = float(np.mean(idx[:, 0] == new_ids))
        gone = np.arange(0, N_DB, N_DB // 10_000)[:10_000]
        t0 = time.perf_counter()
        s.delete(gone)
        torch.cuda.synchronize()
        del_s = time.perf_counter() - t0
        idx, _ = s.search_batched(queries)
        back = int(np.isin(idx, gone).sum())
        log(f"sharded upsert of {len(new_ids)} rows in {up_s:.2f} s (each "
            f"its own first: {first:.6f}), delete of {len(gone)} ids in "
            f"{del_s:.2f} s ({back} deleted ids returned)")
        if first != 1.0 or back:
            raise AssertionError("sharded upsert / delete answers wrong")
        out["mutation"] = {"upsert_s": up_s, "own_first": first,
                           "delete_s": del_s, "deleted_returned": back}
        # f. a restrict allowlist of even ids.
        s, _ = built["build_tree_sq"]
        allow = np.zeros(s.n_points, bool)
        allow[::2] = True
        idx, _ = s.search_batched(queries, restrict_allowlist=allow)
        odd = int((idx[idx >= 0] % 2).sum())
        log(f"sharded restrict to even ids: {odd} odd ids returned, "
            f"{float(np.mean(idx >= 0)):.6f} of the slots filled")
        if odd:
            raise AssertionError("the allowlist let odd ids through")
        out["restrict_odd_ids"] = odd
        del built, s
        torch.cuda.empty_cache()
    finally:
        launch.close()
    launches = kernel_counts()
    if any(launches.values()):
        raise AssertionError(f"the sharded path launched a kernel: "
                             f"{launches}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16 (sharded index) in {out['seconds']:.1f} s")
    return launches, out


def tree_ah_kpg(s):
    """kpg of a tree-AH searcher's pruned search at the bench budget."""
    from scann_torch.models import tree_ah
    return tree_ah._survivors_per_group(s._k_fetch(AH_REORDER), s._num_slots,
                                        s.partitioner.num_leaves)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scann_torch
    from scann_torch import _cuda
    # Serialized indexes and exports of phases 5, 6 and 15.
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, work, True)
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
        searcher.slot_rows, searcher.slot_scale, searcher._layout.bias,
        searcher.slot_leaf, searcher._layout.dpid, searcher._layout.tile_start,
        searcher._layout.ntiles, searcher.partitioner.centers))
    nl = searcher.partitioner.num_leaves
    log(f"build {build_s:.1f} s: {nl} leaves, max_ntiles "
        f"{searcher._layout.max_ntiles}, {searcher._layout.num_tiles} tiles, "
        f"index "
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
            k6_check(torch, k6, "tree_sq", plan, got, searcher._layout.ntiles,
                     searcher.slot_rows.shape[1], K,
                     searcher._layout.max_ntiles)
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
    pruned_sq.launches = pruned_scan.launches_plan = 0
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
    plan_launches = pruned_scan.launches_plan
    if k1["launches"] == 0 or plan_launches == 0:
        raise AssertionError(f"the main path launched K1 {k1['launches']} "
                             f"and the plan kernels {plan_launches} times")
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
    sq_dir = os.path.join(work, "tree_sq")     # served in phase 15d
    searcher.serialize(sq_dir)
    del searcher
    torch.cuda.empty_cache()

    # 6. tree-AH
    k3, k4, ah_summary = tree_ah_phase(torch, scann_torch, db, queries,
                                       truth, q_dev, k6, work)
    ref_assets = ah_summary.pop("reference_assets")
    ah_i8_dir = ah_summary.pop("int8_residual_dir")

    # 7. tree-AH in reconstruct mode
    k2, k5, recon_summary = recon_phase(torch, scann_torch, db, queries,
                                        truth, q_dev)

    # K6 at the widest row a scorer writes.
    k6["widest_row"] = k6_wide_check(torch)
    k6["occupancy"] = {w: _cuda.occupancy("merge_groups", w)
                       for w in (128, 256, k6["widest_row"])}

    # 9-11. the widths once refused, tree-SQ + reorder, the other
    # compositions.
    k3_wide, k5_wide, wide_summary, gist = wide_phase(torch, scann_torch)
    sift_summary, sift = sift_phase(torch, scann_torch)
    compositions = composition_phase(torch, scann_torch, db, queries, truth)
    # 12. ROADMAP item 14's search features.
    features_launches, features = search_features_phase(
        torch, scann_torch, db, queries, truth, q_dev)
    # 13. ROADMAP items 11 (typed), 13 and 16: data and encodings.
    enc_launches, enc_errs, encodings = encodings_phase(
        torch, scann_torch, (db, queries, truth), gist, sift, wide_summary)
    gist = sift = None
    # 14. ROADMAP item 15: mutation and health.
    ah_at100 = next(p for p in ah_summary["points"] if (
        p["index"], p["leaves"], p["pre"]) == ("int8_f32", 100, 100))["recall"]
    mut_launches, mut_errs, mutation = mutation_phase(
        torch, scann_torch, db, queries, ah_at100)
    # 15. ROADMAP items 17, 18 and 20: the entry points.
    entry_launches, entry = entry_points_phase(
        torch, scann_torch, db, queries, truth, sq_dir, ref_assets, work)
    # 16. ROADMAP item 19: the sharded index.
    ah_i8_at100 = next(p for p in ah_summary["points"] if (
        p["index"], p["leaves"], p["pre"]) == ("int8_int8", 100, 100))["recall"]
    sharded_launches, sharded = sharded_phase(
        torch, scann_torch, db, queries, truth, sq_dir, ah_i8_dir, at100,
        ah_i8_at100, work)

    for rec, name in ((k1, "pruned_sq"), (k2, "pruned_rows"),
                      (k3, "pruned_lut"), (k5, "fused_scan")):
        rec["max_abs_err"] = max(rec["max_abs_err"], enc_errs.get(name, 0.0),
                                 mut_errs.get(name, 0.0))
    # K6's line: the tree-AH block (the wider rows, k 30); both blocks'
    # numbers are in the summary.
    k6.update(k6["tree_ah"])
    summary = {"build_s": build_s, "num_leaves": nl,
               "index_bytes_per_vector": index_bytes / N_DB,
               "points": points, "merge": sq_merges, "tree_ah": ah_summary,
               "reconstruct": recon_summary,
               "k6": {b: k6[b] for b in ("tree_sq", "tree_ah")},
               "wide": {**wide_summary, "k3_b_pad_480": k3_wide,
                        "k5_d_960": k5_wide},
               "sift_tree_sq": sift_summary, "compositions": compositions,
               "search_features": features, "encodings": encodings,
               "mutation": mutation, "entry_points": entry,
               "sharded": sharded}
    log("summary " + json.dumps(summary))
    # What the card makes of the seven kernels at the main path's shapes
    # (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerSM); K6 at
    # tree-SQ's and tree-AH's row widths and at the widest.
    log("occupancy " + json.dumps({
        "pruned_sq": {"d_pad": d_pad, "kpg": 4, **k1["occupancy"]},
        "pruned_rows": {"d_pad": recon_summary["d_pad"], "kpg": 8,
                        **k2["occupancy"]},
        "pruned_lut": k3["occupancy"],
        "pruned_codes": {"d_pad": ah_summary["k4_d_pad"], "dpb": 2,
                         "kpg": 8, **k4["occupancy"]},
        "fused_scan": {"d_pad": [recon_summary["d_pad"], GIST_DIM, 1024],
                       "the same at every d": True, **k5["occupancy"]},
        "merge_groups": {f"w {w}": o
                         for w, o in k6["occupancy"].items()},
        "pruned_plan": {f: _cuda.occupancy("pruned_plan", i) for i, f in
                        enumerate(("radix_histogram", "radix_scatter",
                                   "plan_bounds", "plan_emit"))}}))
    # The plan kernels' line: their timing at the glove cell's shape
    # (phase 6; the SIFT cell's is in the summary), their launches in the
    # main path's sweep (phase 5).
    plan = {**ah_summary["plan"], "launches": plan_launches}
    # library_ms is None for all seven: no single PyTorch call computes a
    # gathered tile x query-group score with a packed per-32-slot top-k
    # (K1-K4), a product reduced to per-group maxima without the score
    # matrix (K5: the matmul + amax / argmax composition is timed above),
    # k masked-maximum passes over rewritten keys (K6), or inverts
    # (query, leaf) pairs into leaf-major groups (the plan).
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"scann_torch/csrc/{name}.cu", "replaces": replaces,
         "launches": rec["launches"], "max_abs_err": rec["max_abs_err"],
         "ms": rec["ms"], "plain_ms": rec["plain_ms"],
         "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
         "library_ms": None, "design": design,
         "launches_phase12": features_launches.get(name, 0),
         "launches_phase13": enc_launches.get(name, 0),
         "launches_phase14": mut_launches.get(name, 0),
         "launches_phase15": entry_launches.get(name, 0),
         "launches_phase16": sharded_launches.get(name, 0)}
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
             "keys in registers, redux.sync passes"),
            ("pruned_plan", None, plan,
             "stable LSD radix sort by leaf (match_any ranks), run bounds, "
             "a block a group"))]}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
