// Fused full-scan score + group max (tree-AH reconstruct mode, "K5").
//
// Replaces the Pallas TPU kernel scann_tpu/ops/fused_scan.py
// fused_scan_groupmax (_kernel :58-70, pallas_call at :92).  Contract
// (shared with the plain torch version scann_torch/ops/fused_scan.py
// fused_scan_groupmax_torch): for every query q and every group G of 256
// consecutive slots,
//   s[slot]   = scale * (rows[slot] . queries[q]) + bias[slot]
//               (bf16 x bf16 products, exact in f32, f32 accumulation;
//               a rounded multiply then a rounded add, never an fma)
//   vals[q,G] = max over the group's slots of s
//   idx[q,G]  = the global slot id of that maximum, the first slot on ties
// The (Q, S) score matrix is never written.  The TPU kernel wrote its
// outputs block-major and transposed them afterwards (a Mosaic layout
// matter); this one writes the (Q, S/256) layout directly.
//
// What bounds it on the H100: 2 * Q * S * d operations against S * d * 2
// bytes of rows and Q * S / 256 * 8 bytes of output, so from a few hundred
// queries on it is bound by operations at the bf16 tensor-core rate.  This
// first version runs the products on the CUDA cores in f32, a register-
// tiled product like a plain SGEMM: a block of 8 warps owns 64 queries and
// walks the 8 groups of one 2048-slot block; per group the 256 x 128-dim
// bf16 rows are staged in shared memory (rows padded to an odd word count,
// so the 32 lanes of a warp read 32 banks).  Warp = 8 queries, lane = 8
// slots (lane + 32 j), 64 accumulators a thread; the group maximum is a
// per-thread scan in slot order then a 5-step warp butterfly on (value,
// slot) pairs that prefers the lower slot on equal values.  mma / wgmma on
// the staged tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQB = 64;        // queries per block
constexpr int kSub = 256;      // slots per candidate group
constexpr int kBS = 2048;      // slots per block of groups
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarpQ = 8;      // queries per warp
constexpr int kLaneS = 8;      // slots per lane
constexpr int kDC = 128;       // dimensions staged per step
constexpr int kRowWords = kDC / 2 + 1;  // odd: conflict-free row reads

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// queries (Q_pad, d) bf16 with Q_pad % 64 == 0, rows (S, d) bf16 with
// S % 2048 == 0 and d % 128 == 0, bias (S,) f32; vals / idx (Q_pad, S/256).
__global__ void __launch_bounds__(kThreads)
fused_scan_kernel(const uint32_t* __restrict__ queries,
                  const uint32_t* __restrict__ rows,
                  const float* __restrict__ bias,
                  float* __restrict__ vals, int32_t* __restrict__ idx,
                  int d, int n_groups, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  // q_s[word][query]: word c of all 64 queries side by side, so a warp
  // reads its 8 queries' word c as two 16-byte broadcasts.
  uint32_t* q_s = reinterpret_cast<uint32_t*>(smem);       // d/2 x kQB
  uint32_t* r_s = q_s + (d / 2) * kQB;                     // kSub x kRowWords
  const int words = d / 2;
  const int q_block = blockIdx.x * kQB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kQB * words; i += kThreads) {
    const int q = i / words;
    const int c = i - q * words;
    q_s[c * kQB + q] = queries[static_cast<size_t>(q_block + q) * words + c];
  }

  const uint4* qv = reinterpret_cast<const uint4*>(q_s) + warp * 2;
  for (int gi = 0; gi < kBS / kSub; ++gi) {
    const int group = blockIdx.y * (kBS / kSub) + gi;
    const size_t slot0 = static_cast<size_t>(group) * kSub;
    float acc[kWarpQ][kLaneS];
#pragma unroll
    for (int a = 0; a < kWarpQ; ++a)
#pragma unroll
      for (int j = 0; j < kLaneS; ++j) acc[a][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += kDC) {
      __syncthreads();   // the previous stage's reads (and q_s) are done
      const int w0 = d0 / 2;
      for (int i = threadIdx.x; i < kSub * (kDC / 2); i += kThreads) {
        const int r = i / (kDC / 2);
        const int c = i - r * (kDC / 2);
        r_s[r * kRowWords + c] = rows[(slot0 + r) * words + w0 + c];
      }
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < kDC / 2; ++c) {
        const uint4 qa = qv[(w0 + c) * (kQB / 4)];
        const uint4 qb = qv[(w0 + c) * (kQB / 4) + 1];
        const uint32_t qw[kWarpQ] = {qa.x, qa.y, qa.z, qa.w,
                                     qb.x, qb.y, qb.z, qb.w};
        float xl[kLaneS], xh[kLaneS];
#pragma unroll
        for (int j = 0; j < kLaneS; ++j) {
          const uint32_t xw = r_s[(lane + 32 * j) * kRowWords + c];
          xl[j] = lo_bf16(xw);
          xh[j] = hi_bf16(xw);
        }
#pragma unroll
        for (int a = 0; a < kWarpQ; ++a) {
          const float ql = lo_bf16(qw[a]);
          const float qh = hi_bf16(qw[a]);
#pragma unroll
          for (int j = 0; j < kLaneS; ++j) {
            // bf16 x bf16 products are exact in f32: fma == mul + add.
            acc[a][j] = fmaf(xl[j], ql, acc[a][j]);
            acc[a][j] = fmaf(xh[j], qh, acc[a][j]);
          }
        }
      }
    }

    float bj[kLaneS];
#pragma unroll
    for (int j = 0; j < kLaneS; ++j) bj[j] = bias[slot0 + lane + 32 * j];
#pragma unroll
    for (int a = 0; a < kWarpQ; ++a) {
      // Slots rise with j, and only a strictly larger value replaces the
      // best, so the first slot wins a tie.
      float best = __fadd_rn(__fmul_rn(scale, acc[a][0]), bj[0]);
      int arg = lane;
#pragma unroll
      for (int j = 1; j < kLaneS; ++j) {
        const float s = __fadd_rn(__fmul_rn(scale, acc[a][j]), bj[j]);
        if (s > best) {
          best = s;
          arg = lane + 32 * j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        if (ov > best || (ov == best && oa < arg)) {
          best = ov;
          arg = oa;
        }
      }
      if (lane == a) {
        const size_t o =
            static_cast<size_t>(q_block + warp * kWarpQ + a) * n_groups + group;
        vals[o] = best;
        idx[o] = static_cast<int32_t>(slot0) + arg;
      }
    }
  }
}

}  // namespace

static int fused_scan_smem_bytes(int d) {
  return (d / 2) * kQB * 4 + kSub * kRowWords * 4;
}

extern "C" int fused_scan_groupmax(const void* queries, const void* rows,
                                   const void* bias, void* vals, void* idx,
                                   int q_pad, int s, int d, float scale,
                                   void* stream) {
  const int smem = fused_scan_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(q_pad / kQB, s / kBS);
  fused_scan_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(queries),
      static_cast<const uint32_t*>(rows), static_cast<const float*>(bias),
      static_cast<float*>(vals), static_cast<int32_t*>(idx), d, s / kSub,
      scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
