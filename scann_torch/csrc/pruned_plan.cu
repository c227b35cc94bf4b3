// Leaf-major work plan of a pruned batch (the search's "plan" stage).
//
// Replaces no TPU kernel: the JAX package builds this plan with XLA ops
// (scann_tpu/ops/pruned_scan.py invert), and the port's plain torch version
// (scann_torch/ops/pruned_scan.py invert) stays the CPU implementation and
// the reference.  On the card that version waits on the host (its
// boolean-mask index is a nonzero, which synchronises the stream), ranks
// the B*L pairs by a cummax over one row of B*L, and launches about 75
// kernels.  Contract: every field of the WorkPlan equal to invert's, bit
// for bit, where each valid entry of sel is a leaf id in [0, nl) and the
// valid leaves of a row are distinct (the callers' inputs); a valid entry
// outside [0, nl) counts as invalid here.
//
// One call, on the given stream, with no host synchronisation: a memset
// of the counters, a histogram, a launch a sort pass, then two more.
//   sort         a stable LSD radix sort of the pairs by key = valid ? sel
//                : nl (above every leaf), with the pair index as value: one
//                pass a byte of the key's bits (two below 65,536 leaves).
//                radix_histogram counts every pass's digits over all pairs
//                at once; then a radix_scatter a pass: each warp ranks its
//                part of a tile in order (match_any, per-warp digit counts
//                in shared memory, so equal digits keep their order), and
//                each digit's thread finds the tile's first position by a
//                decoupled look-back over the earlier tiles' published
//                counts.  The first pass reads sel and valid.
//   plan_bounds  each run of one valid key in the sorted keys writes its
//                leaf's first and one-past-last sorted positions (lb, ub);
//                absent leaves keep 0 and 0.  The last block to finish
//                then scans the leaves: ngroups = ceil((ub - lb) / QG), its
//                exclusive scan gbase, the total g_total and the last leaf
//                holding a group.
//   plan_emit    the pair blocks: sorted position i of leaf k has rank
//                i - lb[k], so group gbase[k] + rank / QG and row
//                rank % QG, scattered to pair order through pos_s (0 and 0
//                for invalid pairs).  Then a block a group: its leaf, by
//                binary search in gbase (groups from g_total on take the
//                last leaf that holds a group, 0 if none does); its QG
//                query lanes pos_s[start + j] / L from start =
//                clamp(lb[leaf] + (g - gbase[leaf]) * QG, 0, B*L), 0 past
//                the pairs (the padding lanes read neighbouring queries, as
//                invert's); its mnt work items.
//
// What bounds it on the H100: bytes, and few of them.  At the glove cell's
// shape (10,000 queries x 100 leaves of 2,000, mnt 2) the inputs and the
// plan are about 18 MB, 5.5 us at 3.35 TB/s; each sort pass reads and
// writes the keys and values once more (8 MB), and the launches, a few
// microseconds each, are of the same order.  What the design does about
// it: the sort makes only the passes the leaf count needs, with 32-bit
// values, and no pass waits on a serial scan (the look-back overlaps the
// tiles); the pair ranks come from lb, which the run boundaries give in
// one pass, not from a scan over the pairs; the only serial scan is over
// the leaves, in a last block; every other step is one thread a pair or a
// block a group, each reading what it needs once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQG = 128;              // queries a work group
constexpr int kThreads = 256;         // every kernel but plan_emit
constexpr int kWarps = kThreads / 32;
constexpr int kRadix = 256;           // digits a sort pass (8 bits)
constexpr int kItems = 16;            // pairs a thread in a sort tile
constexpr int kTile = kThreads * kItems;
constexpr int kWarpSpan = 32 * kItems;
static_assert(kThreads == kRadix, "a thread a digit");

constexpr int kMaxPasses = 4;         // 8 bits a pass, keys under 2^31

// gscal: [0] g_total, [1] the last leaf holding a group (0 if none), [2]
// plan_bounds' count of finished blocks, [3, 3 + kMaxPasses) each sort
// pass's count of tiles taken.
constexpr int kGTotal = 0, kLastLeaf = 1, kDoneBounds = 2, kTilesTaken = 3;
constexpr int kScalars = 3 + kMaxPasses;

// A tile's status word for one digit: a flag in the top two bits (0: not
// yet published), its count of the digit (kAggregate) or the count of the
// digit in it and every earlier tile (kPrefix) below.
constexpr uint32_t kAggregate = 1u << 30, kPrefix = 2u << 30;
constexpr uint32_t kValue = kAggregate - 1;

// Sort passes: 8 bits each of the key's, leaf ids [0, nl) and the
// sentinel nl.
int passes(int nl) {
  int b = 1;
  while (b < 31 && (1 << b) <= nl) ++b;
  return (b + 7) / 8;
}

int blocks(int n, int per) { return n > 0 ? (n + per - 1) / per : 1; }

__device__ __forceinline__ int32_t warp_inclusive_scan(int32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Exclusive scan of one value a thread over a block of kThreads; *total
// gets the sum.  Every thread must call it.
__device__ int32_t block_exclusive_scan(int32_t v, int32_t* total) {
  __shared__ int32_t warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t incl = warp_inclusive_scan(v);
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = warp_inclusive_scan(lane < kWarps ? warp_total[lane]
                                                        : 0);
    if (lane < kWarps) warp_total[lane] = w;
  }
  __syncthreads();
  const int32_t out = incl - v + (warp > 0 ? warp_total[warp - 1] : 0);
  *total = warp_total[kWarps - 1];
  __syncthreads();   // warp_total is free again for the next call
  return out;
}

// True in exactly one block of the grid: the last to arrive at *done
// (zeroed before the launch), once every block's writes before the call
// are visible to it.
__device__ bool last_block(int32_t* done) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int n = atomicAdd(reinterpret_cast<unsigned int*>(done),
                                     1u);
    is_last = n == gridDim.x - 1;
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// The sort key of pair i: its leaf, or nl where it makes no work.  The
// first pass reads sel and valid, later passes the previous pass's keys.
__device__ __forceinline__ uint32_t pair_key(const uint32_t* keys_in,
                                             const int32_t* sel,
                                             const uint8_t* valid, int i,
                                             int nl) {
  if (keys_in != nullptr) return keys_in[i];
  const int32_t s = sel[i];
  return (valid[i] != 0 && s >= 0 && s < nl) ? static_cast<uint32_t>(s)
                                             : static_cast<uint32_t>(nl);
}

// One atomic a distinct digit of the warp: each live lane's digit d adds
// one to count[d].  Every lane of the warp calls it.
__device__ __forceinline__ void warp_count_add(uint32_t* count, uint32_t d,
                                               bool live) {
  const unsigned int peers = __match_any_sync(0xffffffffu,
                                              live ? d : kRadix);
  if (live && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&count[d], __popc(peers));
}

// digits (passes, kRadix): every pass's count of each digit over all the
// pairs (zeroed before the launch).
__global__ void __launch_bounds__(kThreads)
    radix_histogram(const int32_t* __restrict__ sel,
                    const uint8_t* __restrict__ valid, uint32_t* digits,
                    int p, int nl, int npass) {
  __shared__ uint32_t count[kMaxPasses][kRadix];
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < kMaxPasses; ++q) count[q][t] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  uint32_t key[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {   // every load before the counting
    const int i = base + j * kThreads + t;
    key[j] = i < p ? pair_key(nullptr, sel, valid, i, nl) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = base + j * kThreads + t < p;
    for (int q = 0; q < npass; ++q)
      warp_count_add(count[q], (key[j] >> (8 * q)) & (kRadix - 1), live);
  }
  __syncthreads();
  for (int q = 0; q < npass; ++q)
    if (count[q][t] != 0) atomicAdd(&digits[q * kRadix + t], count[q][t]);
}

// One stable pass: each pair of a tile to its digit's next position.
// digits: this pass's counts over all pairs; status (tiles, kRadix): this
// pass's status words, zeroed before the launch; tiles_taken: this pass's
// tile counter, zeroed before the launch (a block takes the next tile, so
// every earlier tile is held by a block that has started).
__global__ void __launch_bounds__(kThreads)
    radix_scatter(const uint32_t* __restrict__ keys_in,
                  const int32_t* __restrict__ vals_in,
                  const int32_t* __restrict__ sel,
                  const uint8_t* __restrict__ valid,
                  const uint32_t* __restrict__ digits, uint32_t* status,
                  int32_t* tiles_taken, uint32_t* __restrict__ keys_out,
                  int32_t* __restrict__ vals_out, int p, int nl, int shift) {
  __shared__ uint32_t warp_count[kWarps][kRadix];
  __shared__ int tile_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_count[w][t] = 0;
  if (t == 0) tile_s = atomicAdd(tiles_taken, 1);
  __syncthreads();
  const int tile = tile_s;
  // The warp walks its kWarpSpan pairs in order, 32 at a time: a pair's
  // rank among its warp's equal digits is the count before this step plus
  // the equal lanes below it.
  const unsigned int below = (1u << lane) - 1u;
  const int base = tile * kTile + warp * kWarpSpan;
  uint32_t key[kItems];
  int32_t val[kItems], rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {   // every load before the ranking
    const int i = base + j * 32 + lane;
    key[j] = i < p ? pair_key(keys_in, sel, valid, i, nl) : 0u;
    val[j] = i < p ? (vals_in != nullptr ? vals_in[i] : i) : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = base + j * 32 + lane < p;
    const uint32_t d = (key[j] >> shift) & (kRadix - 1);
    // Pairs past p form a group of their own (digit kRadix) and count
    // nowhere.
    const unsigned int peers = __match_any_sync(0xffffffffu,
                                                live ? d : kRadix);
    const int leader = __ffs(peers) - 1;
    uint32_t before = 0;
    if (live && lane == leader) {
      before = warp_count[warp][d];
      warp_count[warp][d] = before + __popc(peers);
    }
    before = __shfl_sync(0xffffffffu, before, leader);
    rank[j] = live ? static_cast<int32_t>(before) + __popc(peers & below)
                   : -1;
    __syncwarp();
  }
  __syncthreads();
  // Thread t is digit t: each warp's first position within the tile, the
  // tile's count, its publication and the look-back over earlier tiles.
  uint32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = warp_count[w][t];
    warp_count[w][t] = count;
    count += c;
  }
  uint32_t* const mine = status + static_cast<int64_t>(tile) * kRadix + t;
  uint32_t earlier = 0;
  if (tile == 0) {
    atomicExch(mine, kPrefix | count);
  } else {
    atomicExch(mine, kAggregate | count);
    for (int b = tile - 1;; --b) {
      const volatile uint32_t* at =
          status + static_cast<int64_t>(b) * kRadix + t;
      uint32_t word;
      do {
        word = *at;
      } while ((word & ~kValue) == 0);
      earlier += word & kValue;
      if (word & kPrefix) break;
    }
    atomicExch(mine, kPrefix | (earlier + count));
  }
  int32_t total;
  const int32_t first = block_exclusive_scan(
      static_cast<int32_t>(digits[t]), &total);
  const uint32_t start = static_cast<uint32_t>(first) + earlier;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_count[w][t] += start;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (rank[j] < 0) continue;
    const uint32_t d = (key[j] >> shift) & (kRadix - 1);
    const uint32_t pos = warp_count[warp][d] + rank[j];
    keys_out[pos] = key[j];
    vals_out[pos] = val[j];
  }
}

__device__ __forceinline__ int32_t ngroups(const int32_t* lb,
                                           const int32_t* ub, int leaf) {
  // Written by other blocks of this launch: read past L1.
  return (__ldcg(ub + leaf) - __ldcg(lb + leaf) + kQG - 1) / kQG;
}

// One block of kThreads: gbase, g_total and the last leaf from lb and ub.
__device__ void leaf_scan(const int32_t* lb, const int32_t* ub,
                          int32_t* __restrict__ gbase,
                          int32_t* __restrict__ gscal, int nl) {
  __shared__ int32_t last;
  const int t = threadIdx.x;
  const int per = (nl + kThreads - 1) / kThreads;
  const int b0 = min(t * per, nl), b1 = min(b0 + per, nl);
  int32_t sum = 0, my_last = -1;
  for (int i = b0; i < b1; ++i) {
    const int32_t ng = ngroups(lb, ub, i);
    sum += ng;
    if (ng > 0) my_last = i;
  }
  if (t == 0) last = -1;
  int32_t total;
  int32_t run = block_exclusive_scan(sum, &total);
  if (my_last >= 0) atomicMax(&last, my_last);
  __syncthreads();
  for (int i = b0; i < b1; ++i) {
    gbase[i] = run;
    run += ngroups(lb, ub, i);
  }
  if (t == 0) {
    gscal[kGTotal] = total;
    gscal[kLastLeaf] = max(last, 0);
  }
}

__global__ void __launch_bounds__(kThreads)
    plan_bounds(const uint32_t* __restrict__ key_s, int32_t* lb, int32_t* ub,
                int32_t* __restrict__ gbase, int32_t* gscal, int p, int nl) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t n = static_cast<uint32_t>(nl);
  if (i < p) {
    const uint32_t k = key_s[i];
    if (k < n) {
      if (i == 0 || key_s[i - 1] != k) lb[k] = i;
      if (i == p - 1 || key_s[i + 1] != k) ub[k] = i + 1;
    }
  }
  if (!last_block(gscal + kDoneBounds)) return;
  leaf_scan(lb, ub, gbase, gscal, nl);
}

// Blocks [0, pair_blocks) write pair_gid and pair_row, one thread a sorted
// pair; the g_pad blocks after them write one group each.
__global__ void __launch_bounds__(kQG)
    plan_emit(const uint32_t* __restrict__ key_s,
              const int32_t* __restrict__ pos_s,
              const int32_t* __restrict__ lb,
              const int32_t* __restrict__ gbase,
              const int32_t* __restrict__ gscal,
              const int32_t* __restrict__ tile_start,
              const int32_t* __restrict__ ntiles,
              int32_t* __restrict__ pair_gid, int32_t* __restrict__ pair_row,
              int32_t* __restrict__ qg_query, int32_t* __restrict__ qg_leaf,
              int32_t* __restrict__ work_tile, int32_t* __restrict__ work_qg,
              int32_t* __restrict__ work_active, int pair_blocks, int p,
              int l, int nl, int mnt) {
  if (static_cast<int>(blockIdx.x) < pair_blocks) {
    const int i = blockIdx.x * kQG + threadIdx.x;
    if (i >= p) return;
    const uint32_t k = key_s[i];
    int32_t gid = 0, row = 0;
    if (k < static_cast<uint32_t>(nl)) {
      const int32_t rank = i - lb[k];
      gid = gbase[k] + rank / kQG;
      row = rank % kQG;
    }
    const int32_t pos = pos_s[i];
    pair_gid[pos] = gid;
    pair_row[pos] = row;
    return;
  }
  const int g = blockIdx.x - pair_blocks;
  const int32_t g_total = gscal[kGTotal];
  int leaf;
  if (g < g_total) {
    // The last leaf whose first group is at or before g: the leaf holding g.
    int lo = 0, hi = nl;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (gbase[mid] <= g) lo = mid + 1;
      else hi = mid;
    }
    leaf = lo - 1;
  } else {
    leaf = gscal[kLastLeaf];
  }
  const int64_t group_pos =
      static_cast<int64_t>(lb[leaf]) +
      static_cast<int64_t>(g - gbase[leaf]) * kQG;
  const int64_t start =
      group_pos < 0 ? 0 : (group_pos > p ? int64_t{p} : group_pos);
  const int64_t i = start + threadIdx.x;
  qg_query[static_cast<int64_t>(g) * kQG + threadIdx.x] =
      i < p ? pos_s[i] / l : 0;
  const int32_t nt = g < g_total ? ntiles[leaf] : 0;
  const int32_t t0 = tile_start[leaf];
  for (int t = threadIdx.x; t < mnt; t += kQG) {
    const int64_t w = static_cast<int64_t>(g) * mnt + t;
    work_tile[w] = t0 + min(t, max(nt - 1, 0));
    work_active[w] = t < nt ? 1 : 0;
    work_qg[w] = g;
  }
  if (threadIdx.x == 0) qg_leaf[g] = leaf;
}

// The call's scratch, carved from one buffer: two key and two value
// buffers of p; then, zeroed together at the start of a call, lb, ub,
// gscal, every pass's digit counts and every pass's status words; then
// gbase.
struct Scratch {
  uint32_t* keys[2];
  int32_t* vals[2];
  int32_t *lb, *ub, *gscal;
  uint32_t *digits, *status;
  int32_t* gbase;
  size_t zeroed_bytes, total;
};

size_t align_up(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// base may be null: then only the sizes (total) mean anything.
Scratch layout(void* base, int p, int nl) {
  Scratch s{};
  const uintptr_t c = reinterpret_cast<uintptr_t>(base);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const uintptr_t at = c + off;
    off += align_up(bytes);
    return at;
  };
  const size_t pair = sizeof(int32_t) * static_cast<size_t>(p);
  for (int b = 0; b < 2; ++b) {
    s.keys[b] = reinterpret_cast<uint32_t*>(take(pair));
    s.vals[b] = reinterpret_cast<int32_t*>(take(pair));
  }
  const size_t leaf = sizeof(int32_t) * static_cast<size_t>(nl);
  const size_t status = sizeof(uint32_t) * kRadix * passes(nl) *
                        static_cast<size_t>(blocks(p, kTile));
  s.zeroed_bytes = 2 * leaf + sizeof(int32_t) * kScalars +
                   sizeof(uint32_t) * kRadix * kMaxPasses + status;
  s.lb = reinterpret_cast<int32_t*>(take(s.zeroed_bytes));
  s.ub = s.lb + nl;
  s.gscal = s.ub + nl;
  s.digits = reinterpret_cast<uint32_t*>(s.gscal + kScalars);
  s.status = s.digits + kRadix * kMaxPasses;
  s.gbase = reinterpret_cast<int32_t*>(take(leaf));
  s.total = off;
  return s;
}

// Status words hold counts below 2^30.
bool supported(int p, int nl) {
  return p >= 1 && p < (1 << 30) && nl >= 1;
}

}  // namespace

// Bytes of scratch a call of pruned_plan needs for p pairs over nl leaves,
// into *bytes (int64).
extern "C" int pruned_plan_scratch_bytes(int p, int nl, void* bytes) {
  if (!supported(p, nl)) return static_cast<int>(cudaErrorInvalidValue);
  *static_cast<int64_t*>(bytes) =
      static_cast<int64_t>(layout(nullptr, p, nl).total);
  return 0;
}

// The plan of p = B*L pairs (l = L leaves a query) over nl leaves: sel
// int32 and valid bool (one byte), both (B, L) contiguous; tile_start and
// ntiles (nl,) int32; scratch of scratch_bytes (pruned_plan_scratch_bytes,
// 256-byte aligned).  Outputs, all int32: qg_query (g_pad, 128), qg_leaf
// (g_pad,), work_tile, work_qg, work_active (g_pad * mnt,), pair_gid and
// pair_row (p,).
extern "C" int pruned_plan(const void* sel, const void* valid,
                           const void* tile_start, const void* ntiles,
                           void* scratch, void* qg_query, void* qg_leaf,
                           void* work_tile, void* work_qg, void* work_active,
                           void* pair_gid, void* pair_row,
                           int64_t scratch_bytes, int p, int l, int nl,
                           int g_pad, int mnt, void* stream) {
  if (!supported(p, nl) || l < 1 || g_pad < 1 || mnt < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = layout(scratch, p, nl);
  if (scratch_bytes < static_cast<int64_t>(s.total))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sel32 = static_cast<const int32_t*>(sel);
  const auto* valid8 = static_cast<const uint8_t*>(valid);
  cudaError_t err = cudaMemsetAsync(s.lb, 0, s.zeroed_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = blocks(p, kTile), npass = passes(nl);
  radix_histogram<<<tiles, kThreads, 0, st>>>(sel32, valid8, s.digits, p,
                                              nl, npass);
  const uint32_t* keys_in = nullptr;
  const int32_t* vals_in = nullptr;
  for (int q = 0; q < npass; ++q) {
    radix_scatter<<<tiles, kThreads, 0, st>>>(
        keys_in, vals_in, sel32, valid8, s.digits + q * kRadix,
        s.status + static_cast<size_t>(q) * tiles * kRadix,
        s.gscal + kTilesTaken + q, s.keys[q & 1], s.vals[q & 1], p, nl,
        8 * q);
    keys_in = s.keys[q & 1];
    vals_in = s.vals[q & 1];
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_bounds<<<blocks(p, kThreads), kThreads, 0, st>>>(
      keys_in, s.lb, s.ub, s.gbase, s.gscal, p, nl);
  const int pair_blocks = blocks(p, kQG);
  auto i32 = [](void* x) { return static_cast<int32_t*>(x); };
  plan_emit<<<pair_blocks + g_pad, kQG, 0, st>>>(
      keys_in, vals_in, s.lb, s.gbase, s.gscal,
      static_cast<const int32_t*>(tile_start),
      static_cast<const int32_t*>(ntiles), i32(pair_gid), i32(pair_row),
      i32(qg_query), i32(qg_leaf), i32(work_tile), i32(work_qg),
      i32(work_active), pair_blocks, p, l, nl, mnt);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of one of the plan's kernels (0 radix_histogram, 1
// radix_scatter, 2 plan_bounds, 3 plan_emit): registers a thread, static
// shared memory a block (none is dynamic), resident blocks an SM, local
// bytes a thread, into info (4 ints).
extern "C" int pruned_plan_occupancy(int kernel, void* info) {
  const void* fns[] = {reinterpret_cast<const void*>(radix_histogram),
                       reinterpret_cast<const void*>(radix_scatter),
                       reinterpret_cast<const void*>(plan_bounds),
                       reinterpret_cast<const void*>(plan_emit)};
  if (kernel < 0 || kernel > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fns[kernel]);
  int resident = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, fns[kernel], kernel == 3 ? kQG : kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(info);
  o[0] = attr.numRegs;
  o[1] = static_cast<int>(attr.sharedSizeBytes);
  o[2] = resident;
  o[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
