// Group-major fused merge ("K6"): every packed survivor row reduced to its
// top-k (selection key, tile).
//
// Replaces the Pallas TPU kernel scann_tpu/ops/pruned_scan.py
// merge_groups_pallas (kernel :705-713, pallas_call at :724; bit math
// _fused_rewrite :619-641 and _fused_passes :644-662).  Contract (shared
// with the plain torch version scann_torch/ops/pruned_scan.py
// merge_groups_torch, bit for bit): for every row (g, q) of packed
// (g_pad, 128, w) and every column c,
//   t(c)   = c >> kgp_bits                    (tile within the leaf)
//   key(c) = (packed & ~511) | ((c & (gp - 1)) << 5) | (packed & 31)
//            as an f32 bit pattern, or -2^127 where t(c) >= qg_nt[g]
// then k passes, each: the largest key (compared as floats), the largest
// tile among the columns that hold it, and every column holding that
// (key, tile) set to -2^127.  Pass p writes the key's bits to
// m_bits[g, q, p] and the tile to t_sel[g, q, p].  Integer and compare
// work only.  (Keys compare through an order-preserving 32-bit image of
// their bits, which puts -0.0 below +0.0 where floats call them equal: a
// score of exactly -0.0 whose identity bits are all zero is the one key
// this orders differently.)
//
// What bounds it on the H100: the packed block is read once (w words a
// row) and 2k words a row are written; there is no arithmetic to speak
// of, so the bound is bytes.  What the design does about it: the row is
// read once, in 16-byte loads (lane l holds columns 4 (l + 32 i) + 0..3),
// and its keys stay in registers.  A key and its tile form one 64-bit
// entry, image << 32 | tile, whose unsigned order is the pass order.  Each
// lane sorts its entries above -2^127 once (a sorting network) and keeps
// apart the largest tile of its -2^127 columns (dead, or already taken:
// taking a -2^127 column changes nothing) and its largest entry below
// -2^127.  A pass is a redux.sync maximum over the lanes' head images,
// then a second one over the head tiles of the lanes at that image; the
// lanes whose head is that entry pop it (its column joins the -2^127
// tiles).  Rows of up to 256 columns keep every entry in registers, two
// rows a warp so that their passes overlap; wider rows keep each lane's
// top 8 and rescan the lane's columns below the last entry taken when
// they run out.  No shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "survivors.cuh"

namespace {

using survivors::kIdMask;
using survivors::kIdxBits;
using survivors::kQG;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr uint32_t kBigNegBits = 0xFF000000u;   // -2^127
constexpr uint32_t kBigNegImg = ~kBigNegBits;   // its image
constexpr uint64_t kBigNegEntry = static_cast<uint64_t>(kBigNegImg) << 32;
constexpr int kStreamKeep = 8;                  // entries a lane keeps on
                                                // wide rows

// Order-preserving image of an f32 bit pattern (unsigned order = float
// order, -0.0 just below +0.0) and its inverse.
__device__ __forceinline__ uint32_t image(uint32_t b) {
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ uint32_t bits_of(uint32_t img) {
  return (img & 0x80000000u) ? (img & 0x7FFFFFFFu) : ~img;
}

struct Cols {
  int w, gmask, kgp_bits;
};

// The selection entry of column c holding packed word ``bits``.
__device__ __forceinline__ uint64_t entry(uint32_t bits, int c, int nt,
                                          const Cols& cols) {
  const uint32_t t = static_cast<uint32_t>(c >> cols.kgp_bits);
  const uint32_t ident = ((c & cols.gmask) << kIdxBits) |
                         (bits & ((1u << kIdxBits) - 1));
  const uint32_t key =
      static_cast<int>(t) < nt ? (bits & ~static_cast<uint32_t>(kIdMask)) |
                                     ident
                               : kBigNegBits;
  return (static_cast<uint64_t>(image(key)) << 32) | t;
}

// The fallback head of a lane with no entry above -2^127 left:
// (-2^127, largest such tile), else its largest entry below -2^127, else
// 0 (no column).  ``fb`` after a column of tile t was taken.
__device__ __forceinline__ uint64_t taken(uint64_t fb, uint32_t t) {
  const uint32_t bt = (fb >> 32) == kBigNegImg
                          ? max(static_cast<uint32_t>(fb), t) : t;
  return kBigNegEntry | bt;
}

// Folds entry e into a lane's fallback: -2^127 entries raise the tile,
// lower entries are kept if they are the largest (and no -2^127 exists).
__device__ __forceinline__ void fold(uint64_t e, uint64_t& fb) {
  if ((e >> 32) == kBigNegImg) {
    fb = taken(fb, static_cast<uint32_t>(e));
  } else if ((fb >> 32) != kBigNegImg && e > fb) {
    fb = e;
  }
}

// The 4 words of columns c0..c0+3 of a row (w % 4 == 0: one 16-byte load).
__device__ __forceinline__ uint4 load4(const int32_t* src, int c0, int w) {
  if ((w & 3) == 0)
    return __ldg(reinterpret_cast<const uint4*>(src + c0));
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = c0 + j < w ? static_cast<uint32_t>(__ldg(src + c0 + j)) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void cmp_swap(uint64_t& a, uint64_t& b) {
  const bool s = a < b;
  const uint64_t hi = s ? b : a;
  b = s ? a : b;
  a = hi;
}

// Sorts N entries, largest first (N = 4: 5 comparators; N = 8: Batcher's
// 19).
template <int N>
__device__ __forceinline__ void sort_desc(uint64_t (&v)[N]) {
  if constexpr (N == 4) {
    constexpr int kNet[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
#pragma unroll
    for (int i = 0; i < 5; ++i) cmp_swap(v[kNet[i][0]], v[kNet[i][1]]);
  } else {
    static_assert(N == 8, "4 or 8 entries a lane");
    constexpr int kNet[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2},
                                 {1, 3}, {4, 6}, {5, 7}, {1, 2}, {5, 6},
                                 {0, 4}, {3, 7}, {1, 5}, {2, 6}, {1, 4},
                                 {3, 6}, {2, 4}, {3, 5}, {3, 4}};
#pragma unroll
    for (int i = 0; i < 19; ++i) cmp_swap(v[kNet[i][0]], v[kNet[i][1]]);
  }
}

// Drops a lane's head entry (the list shifts up, 0 enters at the end).
template <int N>
__device__ __forceinline__ void shift(uint64_t (&l)[N]) {
#pragma unroll
  for (int i = 0; i < N - 1; ++i) l[i] = l[i + 1];
  l[N - 1] = 0;
}

// A row's state in a lane of the direct kernels during the passes: the
// sorted entries split into images img[0..kN) (0: none) and their tiles,
// 8 bits each in tl (tile i in bits 8i..8i+7: w <= 256, so a tile is
// below 256), and the fallback head (fb_img, fb_t) as in taken().
template <int kN>
struct Lane {
  uint32_t img[kN];
  uint64_t tl;
  uint32_t fb_img, fb_t;
};

// A column of tile t was taken: the fallback becomes (-2^127, the largest
// such tile).
template <int kN>
__device__ __forceinline__ void take(Lane<kN>& s, uint32_t t) {
  s.fb_t = s.fb_img == kBigNegImg ? max(s.fb_t, t) : t;
  s.fb_img = kBigNegImg;
}

// Rows of w <= 4 * kN * 32 columns, w % 4 == 0: kN entries a lane, all in
// registers; R rows a warp.  A pass is the wide rows' kernel's on the
// split state.
template <int kN, int R>
__global__ void __launch_bounds__(kThreads)
merge_direct_kernel(const int32_t* __restrict__ packed,
                    const int32_t* __restrict__ qg_nt,
                    int32_t* __restrict__ m_bits, int32_t* __restrict__ t_sel,
                    Cols cols, int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * R;
  Lane<kN> st[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int nt = qg_nt[(row0 + r) / kQG];
    const int32_t* src = packed + (row0 + r) * cols.w;
    uint64_t l[kN], lo = 0;
    uint32_t bn = 0;   // 1 + the largest tile of a -2^127 column, or 0
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) {
      const int c0 = 4 * (lane + 32 * i);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c0 < cols.w) v = __ldg(reinterpret_cast<const uint4*>(src + c0));
      const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        l[4 * i + j] = 0;
        if (c0 + j >= cols.w) continue;
        const uint64_t e = entry(vw[j], c0 + j, nt, cols);
        const uint32_t hi = static_cast<uint32_t>(e >> 32);
        if (hi > kBigNegImg)
          l[4 * i + j] = e;
        else if (hi == kBigNegImg)
          bn = max(bn, static_cast<uint32_t>(e) + 1u);
        else if (e > lo)
          lo = e;
      }
    }
    sort_desc(l);
    st[r].tl = 0;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      st[r].img[i] = static_cast<uint32_t>(l[i] >> 32);
      st[r].tl |= (l[i] & 0xffull) << (8 * i);
    }
    st[r].fb_img = bn ? kBigNegImg : static_cast<uint32_t>(lo >> 32);
    st[r].fb_t = bn ? bn - 1u : static_cast<uint32_t>(lo);
  }
  uint32_t om[R], ot[R];
  for (int p = 0; p < k; ++p) {
    uint32_t hi[R], ht[R], m[R], t1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool listed = st[r].img[0] != 0;
      hi[r] = listed ? st[r].img[0] : st[r].fb_img;
      ht[r] = listed ? static_cast<uint32_t>(st[r].tl) & 0xffu : st[r].fb_t;
      m[r] = __reduce_max_sync(0xffffffffu, hi[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      t1[r] = __reduce_max_sync(0xffffffffu, hi[r] == m[r] ? ht[r] + 1u : 0u);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t t = t1[r] - 1u;
      if (hi[r] == m[r] && ht[r] == t) {
        Lane<kN>& s = st[r];
        if (s.img[0] == m[r]) {
          // Every column of this lane holding (key, tile) is taken.
          do {
            take(s, t);
#pragma unroll
            for (int i = 0; i < kN - 1; ++i) s.img[i] = s.img[i + 1];
            s.img[kN - 1] = 0;
            s.tl >>= 8;
          } while (s.img[0] == m[r] &&
                   (static_cast<uint32_t>(s.tl) & 0xffu) == t);
        } else {
          take(s, t);
        }
      }
      if (lane == p) {
        om[r] = m[r];
        ot[r] = t;
      }
    }
  }
  if (lane < k) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m_bits[(row0 + r) * k + lane] = static_cast<int32_t>(bits_of(om[r]));
      t_sel[(row0 + r) * k + lane] = static_cast<int32_t>(ot[r]);
    }
  }
}

// Rows of any width: one row a warp; a lane keeps its top kStreamKeep
// entries below ``thr`` and rescans its columns (from L1 / L2) when they
// run out.  Returns whether the lane holds more such entries than it kept.
__device__ __forceinline__ bool scan(const int32_t* src, int nt, int lane,
                                     const Cols& cols, uint64_t thr,
                                     uint64_t (&l)[kStreamKeep],
                                     uint64_t* fb) {
#pragma unroll
  for (int i = 0; i < kStreamKeep; ++i) l[i] = 0;
  int count = 0;
  for (int c0 = 4 * lane; c0 < cols.w; c0 += 128) {
    const uint4 v = load4(src, c0, cols.w);
    const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j >= cols.w) continue;
      uint64_t e = entry(vw[j], c0 + j, nt, cols);
      if ((e >> 32) <= kBigNegImg) {
        if (fb) fold(e, *fb);
        continue;
      }
      if (e >= thr) continue;
      ++count;
#pragma unroll
      for (int s = 0; s < kStreamKeep; ++s) cmp_swap(l[s], e);
    }
  }
  return count > kStreamKeep;
}

__global__ void __launch_bounds__(kThreads)
merge_stream_kernel(const int32_t* __restrict__ packed,
                    const int32_t* __restrict__ qg_nt,
                    int32_t* __restrict__ m_bits, int32_t* __restrict__ t_sel,
                    Cols cols, int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const int nt = qg_nt[row / kQG];
  const int32_t* src = packed + row * cols.w;
  uint64_t l[kStreamKeep], fb = 0;
  bool more = scan(src, nt, lane, cols, ~0ull, l, &fb);
  uint32_t om = 0, ot = 0;
  for (int p = 0; p < k; ++p) {
    const uint64_t head = l[0] > fb ? l[0] : fb;
    const uint32_t m =
        __reduce_max_sync(0xffffffffu, static_cast<uint32_t>(head >> 32));
    const uint32_t t =
        __reduce_max_sync(0xffffffffu,
                          (head >> 32) == m ? static_cast<uint32_t>(head) + 1u
                                            : 0u) - 1u;
    const uint64_t win = (static_cast<uint64_t>(m) << 32) | t;
    if (head == win) {
      if (l[0] == win) {
        // Every column of this lane holding (key, tile) is taken; a list
        // run dry is restocked with the lane's entries below it.
        do {
          fb = taken(fb, t);
          shift(l);
          if (l[0] == 0 && more)
            more = scan(src, nt, lane, cols, win, l, nullptr);
        } while (l[0] == win);
      } else {
        fb = taken(fb, t);
      }
    }
    if (lane == p) {
      om = m;
      ot = t;
    }
  }
  if (lane < k) {
    m_bits[row * k + lane] = static_cast<int32_t>(bits_of(om));
    t_sel[row * k + lane] = static_cast<int32_t>(ot);
  }
}

constexpr int kDirectRows = 2;   // rows a warp of the direct kernels

// The kernel that serves rows of w columns, and the rows a block.
template <class F>
int dispatch(int w, F f) {
  if (w % 4 == 0 && w <= 128)
    return f(merge_direct_kernel<4, kDirectRows>, kDirectRows);
  if (w % 4 == 0 && w <= 256)
    return f(merge_direct_kernel<8, kDirectRows>, kDirectRows);
  return f(merge_stream_kernel, 1);
}

}  // namespace

extern "C" int merge_groups_topk(const void* packed, const void* qg_nt,
                                 void* m_bits, void* t_sel, int g_pad, int w,
                                 int k, int gp_bits, int kgp_bits,
                                 void* stream) {
  const long long n_rows = static_cast<long long>(g_pad) * kQG;
  const Cols cols{w, (1 << gp_bits) - 1, kgp_bits};
  return dispatch(w, [&](auto kernel, int rows_per_warp) {
    // n_rows is a multiple of 128, so of the rows a block takes.
    const unsigned blocks =
        static_cast<unsigned>(n_rows / (kWarps * rows_per_warp));
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(packed),
        static_cast<const int32_t*>(qg_nt), static_cast<int32_t*>(m_bits),
        static_cast<int32_t*>(t_sel), cols, k);
    return static_cast<int>(cudaGetLastError());
  });
}

// Registers a thread, dynamic shared memory a block (none), resident
// blocks an SM and local (spill) bytes a thread of the kernel that serves
// rows of w columns, into info[0..3].
extern "C" int merge_groups_occupancy(int w, void* info) {
  int* o = static_cast<int*>(info);
  return dispatch(w, [&](auto kernel, int) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    o[0] = attr.numRegs;
    o[1] = 0;
    o[2] = blocks;
    o[3] = static_cast<int>(attr.localSizeBytes);
    return 0;
  });
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
