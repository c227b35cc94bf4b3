// Candidate merge of a pruned batch (the search's "merge" stage): each
// query's exact top k from its packed survivors, with datapoint ids.
//
// Replaces no Pallas kernel: the JAX package merges with XLA ops
// (scann_tpu/ops/pruned_scan.py::merge_candidates, :459), and so did the
// port (scann_torch/ops/pruned_scan.py merge_candidates, plain torch, the
// CPU implementation and the reference): about 110 launches a batch that
// gather every hot (query, leaf) row, unpack it into three arrays of its
// size, max-reduce the cold slice of every work group, concatenate the
// candidates, turn each into an int64 key and run torch.topk over them.
// Contract (bit for bit, values and ids): merge_candidates, then the
// slot -> id lookup through dpid, then the squared-L2 restore, as
// pruned_scan.merge_ids_torch chains them.  For query q with l selected
// leaves, the first ``hot`` of them (its best-ranked) hot:
//   hot column (h, t, c), h < hot, t < mnt, c < kgp, in that order: the
//     packed word w of row (pair_gid, pair_row) of pair (q, h), column
//     t * kgp + c; value = w with its 9 identity bits cleared where the
//     pair is valid and t < ntiles[sel], else -inf;
//   cold column (j, c), j < l - hot, c < gp, after every hot column: the
//     word of the largest float over the live tiles t of column t*kgp + c
//     (the identity bits make it unique), cleared; -inf unless the pair is
//     valid and the cleared value finite;
//   then + pair_bias[q, h] when a bias is given (a rounded add, never
//   contracted).  The top k by (value, descending; column, ascending),
//   with values ordered through their order-preserving bits (+0.0 above
//   -0.0), as topk_ops.top_k orders them.  A value below -1e20 is dead:
//   -inf and id -1.  Otherwise slot = (tile_start[sel] + t') * tile +
//   (c % gp) * 32 + a', with (t', a') the word's identity bits (tile,
//   slot in group), id = dpid[slot], and the value less q_norm[q] when
//   norms are given.  Where a pair is valid, its group's live tiles are
//   t < ntiles[sel]: every plan (invert, invert_small, pruned_plan.cu)
//   makes them so, and the plain version reads them from work_active.
//
// Limits: k <= kMaxK (1,024) and n = hot*mnt*kgp + (l - hot)*gp <=
// kMaxN (49,152: hot 8 leaves of 16 tiles of 256 columns, 32,768, plus
// 1,024 cold leaves of 16 columns or 2,048 of 8); kgp and gp multiples of
// 4 (16-byte loads).  pruned_scan.select_fits states the same limits, and
// larger merges keep the plain version.
//
// What bounds it on the H100: bytes.  Each query reads its hot rows' live
// tiles (glove: 8 leaves x 2 tiles x 128 words, 8 KB) and a gp-word slice
// of each live tile of each cold leaf (92 x 2 x 64 B, 11.8 KB), about
// 0.2 GB for 10,000 queries (60 us at 3.35 TB/s), and writes 8 bytes a
// result.  What the design does about it: every live survivor is read
// from device memory once, in 16-byte loads (a hot tile's row in quads
// along the warp, a cold slice as 64 or 32 contiguous bytes), and becomes
// a 32-bit key in shared memory whose column is its position; no
// candidate, key or slot array reaches device memory.  A radix select (a
// byte a pass, warp-aggregated shared-memory histograms, stopping as soon
// as the boundary bucket holds exactly the keys still needed) finds the
// k-th key; one ordered pass over the columns takes the keys above it and
// the first of its ties in column order, straight into their sorted
// buffer's slots; a bitonic sort in shared memory orders the k winners;
// the outputs are written coalesced, each winner's identity read back
// from its word (L2) for its slot.  A block of eight warps selects one
// query, at every shape the limits allow.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "survivors.cuh"

namespace {

using survivors::kIdMask;
using survivors::kIdxBits;
using survivors::kQG;
using survivors::kSubp;

constexpr int kMaxK = 1024;
constexpr int kMaxN = 49152;
constexpr int kMaxTiles = 16;          // tiles a leaf (4 identity bits)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBins = 256;             // a byte a radix pass
constexpr int kState = 64;             // ints of a block's scratch
constexpr float kDeadBelow = -1e20f;
constexpr uint32_t kNegInfBits = 0xFF800000u;

// Scratch ints: each warp's suffix total in the digit search, the chosen
// digit, the count above it and in it, then the compaction's per-warp
// counts (two rounds' worth, two counts each).
constexpr int kWsum = 0, kDigit = kWarps, kAbove = kWarps + 1,
              kCount = kWarps + 2, kCnt = 16;
static_assert(kCnt + 2 * kWarps * 2 <= kState, "scratch");

// Order-preserving image of an f32 bit pattern (unsigned order = the order
// of topk_ops.top_k's keys: float order, -0.0 just below +0.0) and its
// inverse.
__device__ __forceinline__ uint32_t image(uint32_t b) {
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ uint32_t bits_of(uint32_t img) {
  return (img & 0x80000000u) ? (img & 0x7FFFFFFFu) : ~img;
}

struct Args {
  const int32_t* packed;
  const int32_t* pair_gid;
  const int32_t* pair_row;
  const int32_t* sel;
  const uint8_t* valid;
  const int32_t* tile_start;
  const int32_t* ntiles;
  const int32_t* dpid;
  const float* pair_bias;   // nullptr: no bias
  const float* q_norm;      // nullptr: no restore
  float* vals;
  int32_t* ids;
  int b, l, hot, mnt, kgp, gp, tile, k, n, n_hot;
};

// A (query, leaf) pair: its packed row (nullptr when invalid), its live
// tile count (0 when invalid) and its bias.
struct Pair {
  const int32_t* row;
  int nt;
  float bias;
};

__device__ __forceinline__ Pair pair_of(const Args& a, int q, int h) {
  const long long i = static_cast<long long>(q) * a.l + h;
  Pair p{nullptr, 0, 0.f};
  if (a.valid[i]) {
    p.nt = a.ntiles[a.sel[i]];
    p.row = a.packed + (static_cast<long long>(a.pair_gid[i]) * kQG +
                        a.pair_row[i]) * (a.mnt * a.kgp);
  }
  if (a.pair_bias) p.bias = a.pair_bias[i];
  return p;
}

__device__ __forceinline__ uint32_t key_of(float v, const Args& a,
                                           float bias) {
  if (a.pair_bias) v = __fadd_rn(v, bias);
  return image(__float_as_uint(v));
}

// The word of the largest float among column c's live tiles (-inf bits
// when none is live).  Images compare as the floats do: the words of one
// column differ in their tile bits, so no two are +0.0 and -0.0.
__device__ __forceinline__ uint32_t cold_max(const Pair& p, int c, int kgp) {
  uint32_t m = image(kNegInfBits);
  for (int t = 0; t < p.nt; ++t)
    m = max(m, image(static_cast<uint32_t>(__ldg(p.row + t * kgp + c))));
  return bits_of(m);
}

__host__ __device__ __forceinline__ int k_pad(int k) {
  int p = 32;
  while (p < k) p <<= 1;
  return p;
}

// Shared memory of a block: the sort buffer (k_pad 64-bit entries), the
// keys (n rounded up to 4), the histogram and the scratch ints.
__host__ __device__ __forceinline__ int smem_bytes(int n, int k) {
  return k_pad(k) * 8 + ((n + 3) & ~3) * 4 + kBins * 4 + kState * 4;
}

// A block a query.
__global__ void __launch_bounds__(kThreads)
select_kernel(Args a) {
  constexpr int kSize = kThreads;
  const int rank = threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = rank >> 5;
  const int q = blockIdx.x;
  const int n = a.n, k = a.k, kpad = k_pad(k);

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem);
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + kpad * 8);
  uint32_t* hist = keys + ((n + 3) & ~3);
  int* st = reinterpret_cast<int*>(hist + kBins);

  // 1. Keys.  Hot: unit u is quad u % hq of tile (u / hq) % mnt of hot
  // leaf u / (mnt * hq); its four columns are 4u..4u+3.
  const int hq = a.kgp >> 2;
  for (int u = rank; u < a.hot * a.mnt * hq; u += kSize) {
    const int h = u / (a.mnt * hq);
    const int t = (u / hq) % a.mnt;
    const Pair p = pair_of(a, q, h);
    uint4 w = make_uint4(kNegInfBits, kNegInfBits, kNegInfBits,
                         kNegInfBits);
    if (t < p.nt) {
      w = __ldg(reinterpret_cast<const uint4*>(p.row + t * a.kgp +
                                               4 * (u % hq)));
      w.x &= ~kIdMask;
      w.y &= ~kIdMask;
      w.z &= ~kIdMask;
      w.w &= ~kIdMask;
    }
    reinterpret_cast<uint4*>(keys)[u] = make_uint4(
        key_of(__uint_as_float(w.x), a, p.bias),
        key_of(__uint_as_float(w.y), a, p.bias),
        key_of(__uint_as_float(w.z), a, p.bias),
        key_of(__uint_as_float(w.w), a, p.bias));
  }
  // Cold: unit u is quad u % cq of cold leaf u / cq; columns n_hot + 4u...
  const int cq = a.gp >> 2;
  for (int u = rank; u < (a.l - a.hot) * cq; u += kSize) {
    const Pair p = pair_of(a, q, a.hot + u / cq);
    const int c0 = 4 * (u % cq);
    uint32_t m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = image(kNegInfBits);
    for (int t = 0; t < p.nt; ++t) {
      const uint4 w =
          __ldg(reinterpret_cast<const uint4*>(p.row + t * a.kgp + c0));
      m[0] = max(m[0], image(w.x));
      m[1] = max(m[1], image(w.y));
      m[2] = max(m[2], image(w.z));
      m[3] = max(m[3], image(w.w));
    }
    uint32_t kk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = __uint_as_float(bits_of(m[j]) & ~kIdMask);
      if (!isfinite(v)) v = -INFINITY;
      kk[j] = key_of(v, a, p.bias);
    }
    reinterpret_cast<uint4*>(keys)[(a.n_hot >> 2) + u] =
        make_uint4(kk[0], kk[1], kk[2], kk[3]);
  }
  for (int i = k + rank; i < kpad; i += kSize) buf[i] = 0;   // sorts last
  __syncthreads();

  // 2. The k-th key by radix select: keys whose masked bits equal
  // ``prefix`` are the candidates (``ties`` of them), of which ``needed``
  // are taken; every key whose masked bits exceed it is taken.
  uint32_t prefix = 0, mask = 0;
  int needed = k, ties = n;
  constexpr int kPer = kBins / kSize;    // histogram bins a thread scans
  static_assert(kBins % kSize == 0, "bins split evenly");
  for (int shift = 24; shift >= 0 && ties != needed; shift -= 8) {
    for (int i = rank; i < kBins; i += kSize) hist[i] = 0;
    __syncthreads();
    for (int c0 = 0; c0 < n; c0 += kSize) {
      const int c = c0 + rank;
      uint32_t d = 0;
      bool m = false;
      if (c < n) {
        const uint32_t key = keys[c];
        m = (key & mask) == prefix;
        d = (key >> shift) & (kBins - 1);
      }
      const unsigned act = __ballot_sync(0xffffffffu, m);
      if (m) {
        const unsigned peers = __match_any_sync(act, d);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
      }
    }
    __syncthreads();
    // The digit: the largest whose suffix count reaches ``needed``.
    int loc = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) loc += hist[rank * kPer + j];
    int x = loc;                         // inclusive suffix sum in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(0xffffffffu, x, o);
      if (lane + o < 32) x += y;
    }
    int above = x - loc;                 // keys in the bins above mine
    if (lane == 0) st[kWsum + warp] = x;
    __syncthreads();
    for (int w2 = warp + 1; w2 < kWarps; ++w2) above += st[kWsum + w2];
    for (int j = kPer - 1; j >= 0; --j) {
      const int hc = hist[rank * kPer + j];
      if (above < needed && above + hc >= needed) {
        st[kDigit] = rank * kPer + j;
        st[kAbove] = above;
        st[kCount] = hc;
      }
      above += hc;
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(st[kDigit]) << shift;
    mask |= static_cast<uint32_t>(kBins - 1) << shift;
    needed -= st[kAbove];
    ties = st[kCount];
  }

  // 3. The winners in column order: every key above the prefix and the
  // first ``needed`` of its ties.  The selected keys before column c are
  // (keys above before c) + min(ties before c, needed), which is c's slot
  // in the buffer.
  const unsigned lt = (1u << lane) - 1u;
  int run_in = 0, run_tie = 0, parity = 0;
  for (int c0 = 0; c0 < n && run_in + min(run_tie, needed) < k;
       c0 += kSize) {
    const int c = c0 + rank;
    const uint32_t key = c < n ? keys[c] : 0u;
    const bool in = c < n && (key & mask) > prefix;
    const bool tie = c < n && (key & mask) == prefix;
    const unsigned bi = __ballot_sync(0xffffffffu, in);
    const unsigned bt = __ballot_sync(0xffffffffu, tie);
    int* cnt = st + kCnt + parity * kWarps * 2;
    if (lane == 0) {
      cnt[2 * warp] = __popc(bi);
      cnt[2 * warp + 1] = __popc(bt);
    }
    __syncthreads();
    int off_in = 0, off_tie = 0, tot_in = 0, tot_tie = 0;
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) {
      const int ci = cnt[2 * w2], ct = cnt[2 * w2 + 1];
      if (w2 < warp) {
        off_in += ci;
        off_tie += ct;
      }
      tot_in += ci;
      tot_tie += ct;
    }
    parity ^= 1;
    const int tie_rank = run_tie + off_tie + __popc(bt & lt);
    if (in || (tie && tie_rank < needed)) {
      const int pos = run_in + off_in + __popc(bi & lt) +
                      min(tie_rank, needed);
      buf[pos] = (static_cast<uint64_t>(key) << 32) |
                 (0xFFFFFFFFu - static_cast<uint32_t>(c));
    }
    run_in += tot_in;
    run_tie += tot_tie;
  }
  __syncthreads();

  // 4. Bitonic sort of the buffer, largest entry first: key descending,
  // then column ascending (the entry holds ~column below the key).
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = rank; i < (kpad >> 1); i += kSize) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const uint64_t x = buf[lo], y = buf[hi];
        if ((x < y) == ((lo & size) == 0)) {
          buf[lo] = y;
          buf[hi] = x;
        }
      }
      __syncthreads();
    }
  }

  // 5. Values and ids, coalesced.
  for (int i = rank; i < k; i += kSize) {
    const uint64_t e = buf[i];
    const float v = __uint_as_float(bits_of(static_cast<uint32_t>(e >> 32)));
    const int c = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(e));
    float ov = -INFINITY;
    int32_t id = -1;
    if (!(v < kDeadBelow)) {
      int h, cc;
      uint32_t w;
      if (c < a.n_hot) {
        h = c / (a.mnt * a.kgp);
        const int r = c - h * (a.mnt * a.kgp);
        cc = r % a.kgp;
        w = static_cast<uint32_t>(__ldg(pair_of(a, q, h).row + r));
      } else {
        const int j = (c - a.n_hot) / a.gp;
        h = a.hot + j;
        cc = c - a.n_hot - j * a.gp;
        w = cold_max(pair_of(a, q, h), cc, a.kgp);
      }
      const int leaf = a.sel[static_cast<long long>(q) * a.l + h];
      const int slot =
          (a.tile_start[leaf] + static_cast<int>((w >> kIdxBits) & 15u)) *
              a.tile +
          (cc % a.gp) * kSubp + static_cast<int>(w & ((1u << kIdxBits) - 1));
      id = slot >= 0 ? a.dpid[slot] : -1;
      ov = a.q_norm ? __fsub_rn(v, a.q_norm[q]) : v;
    }
    a.vals[static_cast<long long>(q) * k + i] = ov;
    a.ids[static_cast<long long>(q) * k + i] = id;
  }
}

long long width(int l, int hot, int mnt, int kgp, int gp) {
  return static_cast<long long>(hot) * mnt * kgp +
         static_cast<long long>(l - hot) * gp;
}

bool supported(int b, int l, int hot, int mnt, int kgp, int gp, int tile,
               int k) {
  if (b < 1 || l < 1 || hot < 1 || hot > l || mnt < 1 || mnt > kMaxTiles ||
      kgp < 4 || kgp % 4 || gp < 4 || gp % 4 || tile != gp * kSubp)
    return false;
  const long long n = width(l, hot, mnt, kgp, gp);
  return n <= kMaxN && k >= 1 && k <= kMaxK && k <= n;
}

}  // namespace

// Each query's top k of its merge candidates.  packed (g_pad, 128, mnt *
// kgp) int32; pair_gid, pair_row, sel int32 and valid bool (one byte),
// (b, l); tile_start, ntiles (num_leaves,) int32; dpid (slots,) int32;
// pair_bias (b, l) f32 or null; q_norm (b,) f32 or null.  Outputs vals
// (b, k) f32 and ids (b, k) int32.  hot <= l leaves a query are hot; gp =
// tile / 32.  Refuses (cudaErrorInvalidValue) what ``supported`` does not
// take.
extern "C" int pruned_merge(const void* packed, const void* pair_gid,
                            const void* pair_row, const void* sel,
                            const void* valid, const void* tile_start,
                            const void* ntiles, const void* dpid,
                            const void* pair_bias, const void* q_norm,
                            void* vals, void* ids, int b, int l, int hot,
                            int mnt, int kgp, int gp, int tile, int k,
                            void* stream) {
  if (!supported(b, l, hot, mnt, kgp, gp, tile, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(width(l, hot, mnt, kgp, gp));
  const Args a{static_cast<const int32_t*>(packed),
               static_cast<const int32_t*>(pair_gid),
               static_cast<const int32_t*>(pair_row),
               static_cast<const int32_t*>(sel),
               static_cast<const uint8_t*>(valid),
               static_cast<const int32_t*>(tile_start),
               static_cast<const int32_t*>(ntiles),
               static_cast<const int32_t*>(dpid),
               static_cast<const float*>(pair_bias),
               static_cast<const float*>(q_norm),
               static_cast<float*>(vals),
               static_cast<int32_t*>(ids),
               b, l, hot, mnt, kgp, gp, tile, k, n, hot * mnt * kgp};
  const int smem = smem_bytes(n, k);
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, dynamic shared memory a block, resident blocks an SM
// and local (spill) bytes a thread of a merge of n candidates and k
// results, into info[0..3].
extern "C" int pruned_merge_occupancy(int n, int k, void* info) {
  if (n < 1 || n > kMaxN || k < 1 || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  int* o = static_cast<int*>(info);
  const int smem = smem_bytes(n, k);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, select_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, select_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = attr.numRegs;
  o[1] = smem;
  o[2] = blocks;
  o[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
