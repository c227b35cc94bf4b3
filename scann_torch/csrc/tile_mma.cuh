// Tile x query-group product on the bf16 tensor cores, with the packed
// survivor epilogue: the body shared by the pruned scorers over gathered
// rows, K1 (pruned_sq.cu: int8 residual rows, a scale per slot) and K2
// (pruned_rows.cu: decoded bf16 rows, one scale).
//
// For every ACTIVE work item w (tile = work_tile[w], group g = w / mnt,
// t = w % mnt) and every slot of the tile and query of the group:
//   s = (rows[tile, slot] . qg_rows[g, q]) * scale + bias[tile, slot]
// with exact products (int8 and bf16 values are exact in bf16, their
// products exact in f32) summed in f32, and the scale and bias applied as
// a rounded multiply then a rounded add (survivors::scale_bias); then the
// top kpg of every 32-slot group with the (t, slot) identity packed into
// the low 9 bits, into int32 out[g, q, t*kpg*gp + pass*gp + group].
// Inactive items write nothing.
//
// Design:
//   * A block scores one 256-slot slab of a tile (8 candidate groups)
//     against one half of the query group (64 queries): grid = items x
//     slabs x 2, the two halves of an item side by side so the second
//     reads the rows from L2.  8 warps; a warp owns one 32-slot group x
//     the 64 queries.
//   * Products: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
//     queries the M side (4 m-tiles), slots the N side (4 n-tiles), so 16
//     mma a k-step and 64 f32 accumulators a thread.  Each mma starts from
//     zero and its 16-product partial joins the running sum by a rounded
//     f32 add: chained through the tensor core's accumulator, whose
//     additions do not round to nearest, the sums drift from float64 with
//     the width (scann_torch/tools/tile_breakdown.py measures both forms).
//     Both operands come from shared memory by ldmatrix: the
//     staged rows are slot-major with the dimension contiguous, which is
//     the col-major B operand as it stands (no transpose).
//   * The dimension axis streams in chunks of 32 through a 4-stage
//     cp.async ring (bias and scale planes join the first group), so the
//     shared memory of a block does not grow with d_pad.  Rows of a chunk
//     are padded to 80 bytes, which puts the 8 rows an ldmatrix phase
//     reads on 8 distinct 16-byte bank groups.  Dimensions past d_pad are
//     zero-filled by the copy (src-size 0) in both operands, which is
//     exact; a chunk runs only the k-steps of 16 that hold data.
//   * int8 rows (K1) are copied raw and converted to bf16 in shared
//     memory once per chunk (exact for |x| <= 128: 2^23 + x + 128 as a
//     float, minus 2^23 + 128, then the top 16 bits), so the product loop
//     is the same for both kernels.
//   * Epilogue: a query's 32 scores of the group lie in the 4 lanes of a
//     quad, 8 registers each (the m16n8 accumulator layout), which is the
//     input of survivors::quad_top_kpg (the top-4 form for kpg <= 4:
//     tile_breakdown.py times it against sorting all 8).  The
//     survivors of the block's 8 groups are staged in shared memory over
//     the ring, so each (query, pass) leaves as one full 32-byte sector.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "survivors.cuh"

namespace tile_mma {

using survivors::kQG;
using survivors::kSubp;

constexpr int kSlots = 256;               // slots a block scores
constexpr int kQH = kQG / 2;              // queries a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;     // = groups of the slab
constexpr int kKC = 32;                   // dimensions a chunk
constexpr int kStages = 4;
constexpr int kRowB = kKC * 2 + 16;       // bytes of a staged bf16 row

static_assert(kWarps * kSubp == kSlots, "a warp per candidate group");

// Kernel traits: K1 stages int8 rows and has a scale plane; K2 stages
// bf16 rows and scales by one number.
template <bool kInt8Rows, int kTileSlots>
struct Rows {
  static constexpr bool kInt8 = kInt8Rows;
  static constexpr int kTile = kTileSlots;
  static constexpr int kSlabs = kTileSlots / kSlots;
  static constexpr int kGroups = kTileSlots / kSubp;
  static constexpr int kRawRowB = kInt8 ? kKC : kRowB;  // raw rows a stage
  static constexpr int kStageB = kSlots * kRawRowB + kQH * kRowB;
  static constexpr int kConvB = kInt8 ? kSlots * kRowB : 0;
  static constexpr int kPlaneB = kSlots * 4 * (kInt8 ? 2 : 1);
};

// Dynamic shared memory of a block: bias (and scale) planes, then the
// ring (and K1's converted tile), which the staged survivors reuse.  It
// does not depend on d_pad.
template <class T>
__host__ __device__ constexpr int smem_bytes(int kpg) {
  const int ring = kStages * T::kStageB + T::kConvB;
  const int stage = kQH * (kpg * kWarps + 4) * 4;
  return T::kPlaneB + (ring > stage ? ring : stage);
}

struct Args {
  const int32_t* work_tile;
  const int32_t* work_active;
  const __nv_bfloat16* qg_rows;   // (G_pad, 128, d_pad)
  const void* rows;               // (num_tiles, tile, d_pad) int8 or bf16
  const float* scale;             // (num_tiles, tile) (K1) or null
  const float* bias;              // (num_tiles, tile)
  int32_t* out;
  int mnt, kpg, d_pad;
  float mult;                     // K1: smult (scale * smult); K2: scale
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// d = A (16 x 16) . B (16 x 8), from a zero accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Four signed bytes to four bf16 (two bf16x2 words, lower k in the low
// half), exactly: byte b + 128 goes into the mantissa of 2^23, the float
// subtraction leaves b, and its top 16 bits are b in bf16.
__device__ __forceinline__ uint2 int8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)),
                     8388736.f);
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

template <class T, int kKeep>
__global__ void __launch_bounds__(kThreads, 2)
tile_score_kernel(const Args a) {
  const int half = blockIdx.x & 1;
  const int rest = blockIdx.x >> 1;
  const int slab = rest % T::kSlabs;
  const int w = rest / T::kSlabs;
  if (a.work_active[w] != 1) return;
  const int g = w / a.mnt;
  const int t = w - g * a.mnt;
  const int tile = a.work_tile[w];
  const int d_pad = a.d_pad;

  extern __shared__ __align__(16) unsigned char smem[];
  float* bias_s = reinterpret_cast<float*>(smem);         // kSlots
  float* scale_s = bias_s + kSlots;                       // kSlots (K1)
  unsigned char* ring = smem + T::kPlaneB;
  const uint32_t ring_a =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint32_t conv_a = ring_a + kStages * T::kStageB;  // K1 only
  const int tid = threadIdx.x;
  const size_t slot0 = static_cast<size_t>(tile) * T::kTile + slab * kSlots;
  const __nv_bfloat16* qsrc =
      a.qg_rows + (static_cast<size_t>(g) * kQG + half * kQH) * d_pad;
  const int n_kc = (d_pad + kKC - 1) / kKC;

  // Chunk c of the slab's rows and the half's queries into stage c %
  // kStages; pieces past d_pad are zero-filled (src-size 0).
  auto load_chunk = [&](int c) {
    const int d0 = c * kKC;
    const uint32_t st = ring_a + (c % kStages) * T::kStageB;
    if constexpr (T::kInt8) {
      const int8_t* rsrc = static_cast<const int8_t*>(a.rows);
#pragma unroll
      for (int k = 0; k < kSlots * 4 / kThreads; ++k) {
        const int i = tid + k * kThreads;
        const int r = i >> 2;
        const int dim = d0 + (i & 3) * 8;
        const bool in = dim < d_pad;
        cp_async8(st + r * T::kRawRowB + (i & 3) * 8,
                  rsrc + (slot0 + r) * d_pad + (in ? dim : 0), in ? 8 : 0);
      }
    } else {
      const __nv_bfloat16* rsrc = static_cast<const __nv_bfloat16*>(a.rows);
#pragma unroll
      for (int k = 0; k < kSlots * 4 / kThreads; ++k) {
        const int i = tid + k * kThreads;
        const int r = i >> 2;
        const int dim = d0 + (i & 3) * 8;
        const bool in = dim < d_pad;
        cp_async16(st + r * T::kRawRowB + (i & 3) * 16,
                   rsrc + (slot0 + r) * d_pad + (in ? dim : 0), in ? 16 : 0);
      }
    }
    {
      const int r = tid >> 2;
      const int dim = d0 + (tid & 3) * 8;
      const bool in = dim < d_pad;
      cp_async16(st + kSlots * T::kRawRowB + r * kRowB + (tid & 3) * 16,
                 qsrc + static_cast<size_t>(r) * d_pad + (in ? dim : 0),
                 in ? 16 : 0);
    }
  };

  // The planes join the first group of copies.
  if (tid < kSlots / 4)
    cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(bias_s)) +
                   tid * 16, a.bias + slot0 + tid * 4, 16);
  if constexpr (T::kInt8) {
    if (tid >= kThreads - kSlots / 4) {
      const int i = tid - (kThreads - kSlots / 4);
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(scale_s)) +
                     i * 16, a.scale + slot0 + i * 4, 16);
    }
  }
  load_chunk(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < n_kc) load_chunk(s);
    cp_async_commit();
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;               // fragment row / column group
  const int tq = lane & 3;                // thread in the quad
  // ldmatrix row addresses of this lane.  A (queries): matrices (rows 0-7
  // | 8-15) x (k 0-7 | 8-15) of a 16 x 16 tile.  B (slots): matrices
  // (n-tile j, k 0-7), (j, k 8-15), (j + 1, k 0-7), (j + 1, k 8-15).
  const uint32_t a_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * kRowB + (lane >> 4) * 16;
  const uint32_t b_off =
      (warp * kSubp + (lane >> 4) * 8 + (lane & 7)) * kRowB +
      ((lane >> 3) & 1) * 16;

  // acc[mi][j]: queries 16 mi + gq (+8), slots 8 j + 2 tq (+1) of the
  // warp's group.
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  for (int c = 0; c < n_kc; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c landed; chunk c - 1 consumed everywhere
    if (c + kStages - 1 < n_kc) load_chunk(c + kStages - 1);
    cp_async_commit();
    const uint32_t st = ring_a + (c % kStages) * T::kStageB;
    uint32_t b_base = st;
    if constexpr (T::kInt8) {
      // Raw int8 rows (32 bytes) -> bf16 rows of the converted tile.
      const unsigned char* raw = ring + (c % kStages) * T::kStageB;
      unsigned char* conv = ring + kStages * T::kStageB;
#pragma unroll
      for (int k = 0; k < kSlots * 2 / kThreads; ++k) {
        const int i = tid + k * kThreads;
        const int r = i >> 1;
        const int h = i & 1;
        const uint4 v = *reinterpret_cast<const uint4*>(raw + r * kKC + h * 16);
        const uint2 x0 = int8x4_to_bf16x4(v.x), x1 = int8x4_to_bf16x4(v.y);
        const uint2 x2 = int8x4_to_bf16x4(v.z), x3 = int8x4_to_bf16x4(v.w);
        uint4* dst = reinterpret_cast<uint4*>(conv + r * kRowB + h * 32);
        dst[0] = make_uint4(x0.x, x0.y, x1.x, x1.y);
        dst[1] = make_uint4(x2.x, x2.y, x3.x, x3.y);
      }
      __syncthreads();
      b_base = conv_a;
    }
    const uint32_t a_base = st + kSlots * T::kRawRowB + a_off;
    b_base += b_off;
    const int rem = d_pad - c * kKC;
    const int n_ks = rem >= kKC ? kKC / 16 : (rem + 15) / 16;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      if (ks < n_ks) {
        uint32_t af[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(af[mi], a_base + mi * 16 * kRowB + ks * 32);
        uint32_t bf[2][4];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          ldmatrix_x4(bf[jp], b_base + jp * 16 * kRowB + ks * 32);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float part[4][4];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
            mma_bf16(part[mi], af[mi], bf[j >> 1][(j & 1) * 2],
                     bf[j >> 1][(j & 1) * 2 + 1]);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mi][j][e] = __fadd_rn(acc[mi][j][e], part[mi][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: survivors are staged over it

  // Scale, bias and identity of this thread's 8 slots: s = 2 j + e is
  // slot 8 j + 2 tq + e of the group; row 2 mi + h of the selection is
  // query 16 mi + 8 h + gq of the half.
  float bj[8], sj[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int sl = warp * kSubp + 8 * (s >> 1) + 2 * tq + (s & 1);
    bj[s] = bias_s[sl];
    sj[s] = T::kInt8 ? __fmul_rn(scale_s[sl], a.mult) : a.mult;
  }
  float pv[8][8];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < 8; ++s)
        pv[2 * mi + h][s] = survivors::pack(
            survivors::scale_bias(acc[mi][s >> 1][2 * h + (s & 1)], sj[s],
                                  bj[s]),
            survivors::identity(t, 8 * (s >> 1) + 2 * tq + (s & 1)));
  // stage_s[q * qstride + pass * 8 + warp]: the 8 groups of the slab are
  // one 32-byte sector of each (query, pass).
  int32_t* stage_s = reinterpret_cast<int32_t*>(ring);
  const int kpg = a.kpg;
  const int qstride = kpg * kWarps + 4;   // + 4: conflict-free writes
  survivors::quad_top_kpg<kKeep>(pv, kpg, kWarps, tq == 0, [&](int r) {
    return stage_s + (16 * (r >> 1) + 8 * (r & 1) + gq) * qstride + warp;
  });
  __syncthreads();
  const int seg = kpg * T::kGroups;
  const size_t width = static_cast<size_t>(a.mnt) * seg;
  int32_t* obase = a.out + (static_cast<size_t>(g) * kQG + half * kQH) * width +
                   t * seg + slab * kWarps;
  for (int i = tid; i < kQH * kpg * 2; i += kThreads) {
    const int q = i / (kpg * 2);
    const int p = (i >> 1) - q * kpg;
    const int h = (i & 1) * 4;
    *reinterpret_cast<uint4*>(obase + q * width + p * T::kGroups + h) =
        *reinterpret_cast<const uint4*>(stage_s + q * qstride + p * kWarps +
                                        h);
  }
}

template <class T, int kKeep>
int launch(const Args& a, int w_pad, cudaStream_t stream) {
  const int smem = smem_bytes<T>(a.kpg);
  cudaError_t err = cudaFuncSetAttribute(
      tile_score_kernel<T, kKeep>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_score_kernel<T, kKeep>
      <<<w_pad * T::kSlabs * 2, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launches the kernel over w_pad work items (kpg <= 4 keeps a lane's top
// 4 only).
template <class T>
int score(const Args& a, int w_pad, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.kpg <= 4 ? launch<T, 4>(a, w_pad, s) : launch<T, 8>(a, w_pad, s);
}

template <class T, int kKeep>
int occupancy_of(int kpg, int* o) {
  const int smem = smem_bytes<T>(kpg);
  cudaError_t err = cudaFuncSetAttribute(
      tile_score_kernel<T, kKeep>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, tile_score_kernel<T, kKeep>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, tile_score_kernel<T, kKeep>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = attr.numRegs;
  o[1] = smem;
  o[2] = blocks;
  o[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// Registers a thread, dynamic shared memory a block, resident blocks an SM
// and local (spill) bytes a thread of the kernel that serves kpg, into
// info[0..3] (the same at every d_pad).
template <class T>
int occupancy(int kpg, void* info) {
  int* o = static_cast<int*>(info);
  return kpg <= 4 ? occupancy_of<T, 4>(kpg, o) : occupancy_of<T, 8>(kpg, o);
}

}  // namespace tile_mma
