// Pruned int8-LUT scorer over pair-packed 4-bit AH codes (tree-AH, "K3").
//
// Replaces the Pallas TPU kernel scann_tpu/ops/pruned_lut.py
// score_work_pallas_lut (_lut_kernel, pallas_call at :332).  Contract
// (shared with the plain torch version scann_torch/ops/pruned_lut.py
// score_work_torch_lut): for every query group g with an active item,
//   lutf[w, q] = sum_k cb[w, k] * query[g, q, block(w)*dpb + k]   (f32)
//   lutf       = scale * lutf - csq[w]        (scale 2 under squared L2)
//   m[q]       = max(max_w |lutf[w, q]|, 1e-20)
//   lut[w, q]  = clip(rint(lutf * (127 / m[q])), -127, 127)       (int8)
//   inv[q]     = m[q] * (1 / 127)
// with w = block*16 + center over the compact centered codebook (bf16
// values held in f32), and for every active item w = g*mnt + t of it
//   acc[slot, q] = sum_block lut[block*16 + nibble(slot, block), q]  (int32)
//   s            = float(acc) * inv[q] + bias[slot]   (rounded mul, add)
// then the survivor epilogue (survivors.cuh) into
// out[g, q, t*kpg*16 + pass*16 + group].  Inactive items write nothing.
//
// What bounds it on the H100: the codes are half a byte per block and
// slot, so the bytes bound is a fraction of a millisecond for a 10k-query
// batch; the lookups are one int8 add per (slot, block, query).  Done as
// the TPU kernel did them, as a one-hot x LUT product, they become int8
// tensor-core work: mma.sync m16n8k32 s8 x s8 -> s32, queries the M side,
// slots the N side, a k-step of 32 = two code blocks x 16 centers.
//   * A block owns 64 of a query group's 128 queries (two blocks a group):
//     its LUT is 64 rows of b_pad*16 signed bytes, each row padded by 16
//     bytes so the ldmatrix loads of the A fragments are free of bank
//     conflicts, and two blocks fit on an SM at the bench's b_pad 56 (the
//     registers allow no third).  The per-query m[q] needs no other query,
//     so the split changes no bit.  The LUT is built in two passes over
//     the codebook product (the first for the per-query maximum), each
//     entry summed in the plain version's order; at 2 dimensions per
//     block a block's codebook rows come as 16-byte loads (one scalar load
//     per entry, broadcast to the warp, would bound it).
//   * The one-hot B operand is built in registers, never stored: a thread
//     holds 4 consecutive k of slot column n, so its register is
//     1 << 8 * (nibble - 4 * (lane & 3)), zero when that byte lies outside
//     [0, 4) (shl.b32 clamps the shift).  The nibbles come from the tile's
//     codes, staged in shared memory.
//   * A warp owns one 32-slot candidate group x the block's 64 queries
//     (16 mma a k-step, 64 accumulators a thread); the 16 groups of a tile
//     take two rounds of the 8 warps.  The integer sums are exact, so the
//     output is bit-equal to the plain version.
//   * Epilogue: a query's 32 scores of the group lie in the 4 lanes of a
//     quad, 8 registers each.  survivors::quad_top_kpg sorts each lane's 8
//     once, then a pass is two shuffles of the heads and one pop, for the
//     8 queries of a thread at once.  The survivors of a round's 8 groups
//     go through shared memory, so each (query, pass) leaves as one full
//     32-byte sector instead of 8 scattered words.  The selection, not the
//     product, is the larger part of the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "survivors.cuh"

namespace {

using survivors::kQG;
using survivors::kSubp;

constexpr int kTile = 512;                // slots per leaf tile
constexpr int kGroups = kTile / kSubp;    // 16 candidate groups
constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQH = kQG / 2;              // queries per block
constexpr int kParts = kThreads / kQH;    // LUT-build threads per query
constexpr int kCenters = 16;
constexpr int kLutPad = 16;               // bytes added to each LUT row

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// float(x) for |x| < 2^22 (an accumulator is at most 127 * b_pad) on the
// FP32 pipe: the bits 0x4B400000 + x are the float 1.5 * 2^23 + x.
__device__ __forceinline__ float small_int_to_float(int x) {
  return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.f);
}

// The 4 one-hot bytes k = 4t .. 4t+3 of a center id: byte nib - 4t is 1.
// t32 = 32 t; a shift of 32 or more (as unsigned) gives 0.
__device__ __forceinline__ uint32_t one_hot(uint32_t nib, uint32_t t32) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(r) : "r"(1u), "r"(nib * 8u - t32));
  return r;
}

// The 16 entries of block j for one query row: lv[c] = scale * (cb[j*16 +
// c] . q_j) - csq[j*16 + c], each dot summed over k in order (bf16 x bf16
// products are exact in f32, so fma == mul + add).  kDpb = 0 reads dpb
// from the argument and the codebook one value at a time.
template <int kDpb>
__device__ __forceinline__ void lut_entries(
    const float* __restrict__ cb, const float* __restrict__ csq,
    const __nv_bfloat16* __restrict__ qrow, int j, int dpb, float scale,
    float (&lv)[kCenters]) {
  float acc[kCenters];
#pragma unroll
  for (int c = 0; c < kCenters; ++c) acc[c] = 0.f;
  if constexpr (kDpb > 0) {
    float cbv[kCenters * kDpb];
    const float4* src =
        reinterpret_cast<const float4*>(cb + j * kCenters * kDpb);
#pragma unroll
    for (int i = 0; i < kCenters * kDpb / 4; ++i) {
      const float4 v = __ldg(src + i);
      cbv[4 * i] = v.x;
      cbv[4 * i + 1] = v.y;
      cbv[4 * i + 2] = v.z;
      cbv[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < kDpb; ++k) {
      const float qk = __bfloat162float(qrow[j * kDpb + k]);
#pragma unroll
      for (int c = 0; c < kCenters; ++c)
        acc[c] = fmaf(cbv[c * kDpb + k], qk, acc[c]);
    }
  } else {
    const float* cbj = cb + j * kCenters * dpb;
    for (int k = 0; k < dpb; ++k) {
      const float qk = __bfloat162float(qrow[j * dpb + k]);
#pragma unroll
      for (int c = 0; c < kCenters; ++c)
        acc[c] = fmaf(cbj[c * dpb + k], qk, acc[c]);
    }
  }
  const float4* cs = reinterpret_cast<const float4*>(csq + j * kCenters);
#pragma unroll
  for (int i = 0; i < kCenters / 4; ++i) {
    const float4 v = __ldg(cs + i);
    lv[4 * i] = __fsub_rn(__fmul_rn(scale, acc[4 * i]), v.x);
    lv[4 * i + 1] = __fsub_rn(__fmul_rn(scale, acc[4 * i + 1]), v.y);
    lv[4 * i + 2] = __fsub_rn(__fmul_rn(scale, acc[4 * i + 2]), v.z);
    lv[4 * i + 3] = __fsub_rn(__fmul_rn(scale, acc[4 * i + 3]), v.w);
  }
}

// The int8 LUT of the block's 64 queries, lut_s[q * stride + w], and
// inv_s[q]: thread (q, r) covers blocks r, r + kParts, ...; two passes
// over the entries, the first for the per-query maximum.
template <int kDpb>
__device__ __forceinline__ void build_lut(
    const __nv_bfloat16* __restrict__ qg_rows, const float* __restrict__ cb,
    const float* __restrict__ csq, int8_t* lut_s, float* inv_s,
    float* pmax_s, int g, int half, int b_pad, int dpb, int d_pad,
    int stride, float scale) {
  const int q = threadIdx.x & (kQH - 1);
  const int r = threadIdx.x / kQH;
  const __nv_bfloat16* qrow =
      qg_rows + (static_cast<size_t>(g) * kQG + half * kQH + q) * d_pad;
  int8_t* lrow = lut_s + q * stride;
  float mx = 0.f;
  for (int j = r; j < b_pad; j += kParts) {
    float lv[kCenters];
    lut_entries<kDpb>(cb, csq, qrow, j, dpb, scale, lv);
#pragma unroll
    for (int c = 0; c < kCenters; ++c) mx = fmaxf(mx, fabsf(lv[c]));
  }
  pmax_s[r * kQH + q] = mx;
  __syncthreads();
  float m = pmax_s[q];
  for (int p = 1; p < kParts; ++p) m = fmaxf(m, pmax_s[p * kQH + q]);
  m = fmaxf(m, 1e-20f);
  const float mult = __fdiv_rn(127.f, m);
  if (r == 0) inv_s[q] = __fmul_rn(m, static_cast<float>(1.0 / 127.0));
  for (int j = r; j < b_pad; j += kParts) {
    float lv[kCenters];
    lut_entries<kDpb>(cb, csq, qrow, j, dpb, scale, lv);
    uint32_t packed[kCenters / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < kCenters; ++c) {
      // clip(rint(x)) == rint(clip(x)) for integer bounds, and adding
      // 1.5 * 2^23 rounds to the nearest integer, ties to even, as rintf
      // does, into the low mantissa bits: the low byte is the int8 (no
      // trip through the slow conversion unit).
      const float v =
          fminf(fmaxf(__fmul_rn(lv[c], mult), -127.f), 127.f);
      packed[c / 4] |= (__float_as_uint(__fadd_rn(v, 12582912.f)) & 0xFFu)
                       << (8 * (c % 4));
    }
    *reinterpret_cast<uint4*>(lrow + j * kCenters) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
pruned_lut_kernel(const int32_t* __restrict__ work_tile,
                  const int32_t* __restrict__ work_active,
                  const __nv_bfloat16* __restrict__ qg_rows,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ cb, const float* __restrict__ csq,
                  const float* __restrict__ bias, int32_t* __restrict__ out,
                  int mnt, int kpg, int b_pad, int dpb, int d_pad,
                  float scale) {
  const int g = blockIdx.x >> 1;
  const int half = blockIdx.x & 1;        // queries half*64 .. +63
  int n_act = 0;  // active items of a group are its first ntiles(leaf)
  while (n_act < mnt && work_active[g * mnt + n_act] == 1) ++n_act;
  if (n_act == 0) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const int wdim = b_pad * kCenters;
  const int stride = wdim + kLutPad;      // bytes per LUT row (query)
  const int cwords = b_pad / 8;           // code words per slot
  int8_t* lut_s = reinterpret_cast<int8_t*>(smem);             // kQH rows
  float* inv_s = reinterpret_cast<float*>(smem + kQH * stride);  // kQH
  float* pmax_s = inv_s + kQH;                                 // kParts x kQH
  float* bias_s = pmax_s + kParts * kQH;                       // kTile
  uint32_t* code_s = reinterpret_cast<uint32_t*>(bias_s + kTile);
  // A round's survivors, stage_s[q * qstride + pass * 8 + warp]: the 8
  // groups of a round are one 32-byte sector of each (query, pass).
  int32_t* stage_s = reinterpret_cast<int32_t*>(code_s + kTile * cwords);
  const int qstride = kpg * kWarps + 4;   // + 4: conflict-free writes

  // ---- per-group LUT; two dimensions per block (the benchmark's
  // `score_ah(2)`) has its codebook rows come as 16-byte loads.
  if (dpb == 2)
    build_lut<2>(qg_rows, cb, csq, lut_s, inv_s, pmax_s, g, half, b_pad, dpb,
                 d_pad, stride, scale);
  else
    build_lut<0>(qg_rows, cb, csq, lut_s, inv_s, pmax_s, g, half, b_pad, dpb,
                 d_pad, stride, scale);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;               // fragment row / column group
  const int tq = lane & 3;                // thread in the quad
  const uint32_t t32 = 32u * tq;
  const int seg = kpg * kGroups;
  const size_t width = static_cast<size_t>(mnt) * seg;
  // ldmatrix row address of this lane: matrices (rows 0-7 | 8-15) x
  // (bytes 0-15 | 16-31) of a 16-query x 32-byte A tile.
  const uint32_t a_lane =
      static_cast<uint32_t>(__cvta_generic_to_shared(lut_s)) +
      ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + (lane >> 4) * 16;
  for (int t = 0; t < n_act; ++t) {
    const int tile = work_tile[g * mnt + t];
    __syncthreads();  // LUT complete; previous tile's staging consumed
    const uint32_t* csrc = reinterpret_cast<const uint32_t*>(
        codes + static_cast<size_t>(tile) * kTile * (b_pad / 2));
    for (int i = threadIdx.x; i < kTile * cwords; i += kThreads)
      code_s[i] = csrc[i];
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      bias_s[i] = bias[static_cast<size_t>(tile) * kTile + i];
    __syncthreads();

    for (int gi = warp; gi < kGroups; gi += kWarps) {
      // acc[mi][j]: queries 16 mi + gq (+8), slots 8 j + 2 tq (+1) of the
      // group (the m16n8 accumulator layout).
      int acc[4][4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;
      // Slot 8 j + gq of the group is this thread's one-hot column j.
      const uint32_t* crow = code_s + (gi * kSubp + gq) * cwords;
      for (int jw = 0; jw < cwords; ++jw) {
        uint32_t cw[4];   // 4 code bytes = 4 k-steps of each column
#pragma unroll
        for (int j = 0; j < 4; ++j) cw[j] = crow[j * 8 * cwords + jw];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kstep = jw * 4 + i;   // blocks 2 kstep, 2 kstep + 1
          uint32_t a[4][4];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
            ldmatrix_x4(a[mi], a_lane + mi * 16 * stride + kstep * 32);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t byte = cw[j] >> (8 * i);
            const uint32_t b0 = one_hot(byte & 15u, t32);
            const uint32_t b1 = one_hot((byte >> 4) & 15u, t32);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) mma_s8(acc[mi][j], a[mi], b0, b1);
          }
        }
      }
      // Row 2 mi + h of the selection is query 16 mi + 8 h + gq.
      float pv[8][8];
      float bj[8];
#pragma unroll
      for (int s = 0; s < 8; ++s)
        bj[s] = bias_s[gi * kSubp + 8 * (s >> 1) + 2 * tq + (s & 1)];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float inv = inv_s[16 * mi + 8 * h + gq];
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            const float sc = survivors::scale_bias(
                small_int_to_float(acc[mi][s >> 1][2 * h + (s & 1)]), inv,
                bj[s]);
            pv[2 * mi + h][s] = survivors::pack(
                sc, survivors::identity(t, 8 * (s >> 1) + 2 * tq + (s & 1)));
          }
        }
      }
      survivors::quad_top_kpg(pv, kpg, kWarps, tq == 0, [&](int r) {
        return stage_s + (16 * (r >> 1) + 8 * (r & 1) + gq) * qstride + warp;
      });
      __syncthreads();
      // Copy the round's survivors out, 16 bytes a thread and step.
      const int col0 = t * seg + (gi - warp);
      for (int i = threadIdx.x; i < kQH * kpg * 2; i += kThreads) {
        const int q = i / (kpg * 2);
        const int p = (i >> 1) - q * kpg;
        const int h = (i & 1) * 4;
        *reinterpret_cast<uint4*>(
            out + (static_cast<size_t>(g) * kQG + half * kQH + q) * width +
            col0 + p * kGroups + h) =
            *reinterpret_cast<const uint4*>(stage_s + q * qstride +
                                            p * kWarps + h);
      }
      __syncthreads();
    }
  }
}

}  // namespace

static int pruned_lut_smem_bytes(int b_pad, int kpg) {
  return kQH * (b_pad * kCenters + kLutPad) + (kQH + kParts * kQH + kTile) * 4 +
         kTile * (b_pad / 2) + kQH * (kpg * kWarps + 4) * 4;
}

extern "C" int pruned_lut_score(const void* work_tile, const void* work_active,
                                const void* qg_rows, const void* codes,
                                const void* cb, const void* csq,
                                const void* bias, void* out, int g_pad, int mnt,
                                int kpg, int b_pad, int dpb, int d_pad,
                                float scale, void* stream) {
  const int smem = pruned_lut_smem_bytes(b_pad, kpg);
  cudaError_t err = cudaFuncSetAttribute(
      pruned_lut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pruned_lut_kernel<<<2 * g_pad, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(work_tile),
      static_cast<const int32_t*>(work_active),
      static_cast<const __nv_bfloat16*>(qg_rows),
      static_cast<const uint8_t*>(codes), static_cast<const float*>(cb),
      static_cast<const float*>(csq), static_cast<const float*>(bias),
      static_cast<int32_t*>(out), mnt, kpg, b_pad, dpb, d_pad, scale);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, dynamic shared memory a block, resident blocks an SM
// and local (spill) bytes a thread of the kernel at b_pad code blocks and
// kpg survivors a group, into info[0..3].
extern "C" int pruned_lut_occupancy(int b_pad, int kpg, void* info) {
  int* o = static_cast<int*>(info);
  const int smem = pruned_lut_smem_bytes(b_pad, kpg);
  cudaError_t err = cudaFuncSetAttribute(
      pruned_lut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, pruned_lut_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pruned_lut_kernel, kThreads, smem);
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
