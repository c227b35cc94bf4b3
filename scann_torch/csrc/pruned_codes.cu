// Pruned decode scorer over 8-bit AH center ids (tree-AH float lookup and
// lut256, "K4").
//
// Replaces the Pallas TPU kernel scann_tpu/ops/pruned_lut.py
// score_work_pallas_codes (_kernel, pallas_call at :156).  Contract (shared
// with the plain torch version scann_torch/ops/pruned_lut.py
// score_work_torch_codes): for every ACTIVE work item w,
//   tile = work_tile[w], group g = w / mnt, t = w % mnt
//   recon[slot, d] = cb[block(d)*cpb + code(slot, block(d)), d] - mean[d]
//                    (f32; a code >= cpb selects no center: 0 - mean[d])
//   sq[slot]       = sum_d recon[slot, d]^2        (from the f32 row)
//   dot            = bf16(recon[slot]) . qg_rows[g] (128 x d_pad bf16),
//                    exact products, f32 accumulation
//   s              = dot + bias            (dot product)
//                    2 * dot - sq + bias   (squared L2)
// then the survivor epilogue (survivors.cuh) into
// out[g, q, t*kpg*16 + pass*16 + group].  Inactive items write nothing.
//
// The TPU kernel decoded with a one-hot x codebook matmul; here the decode
// is a table read through the cache (the compact codebook is a few KB for
// 16 centers per block and at most a few hundred KB for 256).
//
// What bounds it on the H100: one byte per block and slot in, so the bytes
// bound is a fraction of a millisecond per 10k-query batch, like the bf16
// tensor-core time of the products.  This first version is K1 (pruned_sq.cu)
// with a decode in place of the int8 load and runs far from both roofs:
// the products run on the CUDA cores in f32.  One block per work item
// decodes the 512-slot tile once into shared memory as bf16 pairs (rows
// padded to an odd word count, so per-lane row reads hit 32 banks) beside
// the f32 query group; warp = 32-slot group, lane = slot, so the top-kpg
// selection is a warp max over registers.  wgmma on the decoded tile is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "survivors.cuh"

namespace {

using survivors::kQG;
using survivors::kSubp;

constexpr int kTile = 512;    // slots per leaf tile (= threads per block)
constexpr int kGroups = kTile / kSubp;
constexpr int kQChunk = 32;   // query columns accumulated per pass

__host__ __device__ inline int row_words(int d_pad) {
  return d_pad / 2 + 1;       // d_pad % 8 == 0, so this is odd
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(
      __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__global__ void __launch_bounds__(kTile)
pruned_codes_kernel(const int32_t* __restrict__ work_tile,
                    const int32_t* __restrict__ work_active,
                    const __nv_bfloat16* __restrict__ qg_rows,
                    const uint8_t* __restrict__ codes,
                    const float* __restrict__ cb,
                    const float* __restrict__ mean,
                    const float* __restrict__ bias,
                    int32_t* __restrict__ out,
                    int mnt, int kpg, int b_pad, int cpb, int dpb,
                    int measure_l2) {
  const int w = blockIdx.x;
  if (work_active[w] != 1) return;
  const int d_pad = b_pad * dpb;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                 // kQG x d_pad
  uint32_t* r_s = reinterpret_cast<uint32_t*>(q_s + kQG * d_pad);
  const int rw = row_words(d_pad);
  const int g = w / mnt;
  const int t = w - g * mnt;
  const int tile = work_tile[w];
  const int slot = threadIdx.x;

  const __nv_bfloat162* qsrc = reinterpret_cast<const __nv_bfloat162*>(
      qg_rows + static_cast<size_t>(g) * kQG * d_pad);
  for (int i = threadIdx.x; i < kQG * d_pad / 2; i += kTile) {
    const float2 f = __bfloat1622float2(qsrc[i]);
    q_s[2 * i] = f.x;
    q_s[2 * i + 1] = f.y;
  }

  // Decode this thread's slot: f32 row for sq, bf16 pairs into shared.
  float sq = 0.f;
  {
    const uint8_t* crow =
        codes + (static_cast<size_t>(tile) * kTile + slot) * b_pad;
    uint32_t* myrow_w = r_s + slot * rw;
    uint32_t low = 0u;
    for (int j = 0; j < b_pad; ++j) {
      const int code = crow[j];
      const float* center =
          cb + (static_cast<size_t>(j) * cpb + code) * dpb;
      for (int k = 0; k < dpb; ++k) {
        const int d = j * dpb + k;
        const float c = code < cpb ? center[k] : 0.f;
        const float v = __fsub_rn(c, mean[d]);
        sq = fmaf(v, v, sq);
        const uint32_t bits = bf16_bits(v);
        if (d & 1)
          myrow_w[d >> 1] = low | (bits << 16);
        else
          low = bits;
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float b = bias[static_cast<size_t>(tile) * kTile + slot];
  const int ident = survivors::identity(t, lane);
  const int seg = kpg * kGroups;
  const size_t width = static_cast<size_t>(mnt) * seg;
  int32_t* obase = out + static_cast<size_t>(g) * kQG * width + t * seg + warp;
  const uint32_t* myrow = r_s + slot * rw;
  const int quads = d_pad / 4;

  for (int q0 = 0; q0 < kQG; q0 += kQChunk) {
    float acc[kQChunk];
#pragma unroll
    for (int j = 0; j < kQChunk; ++j) acc[j] = 0.f;
    const float* qbase = q_s + q0 * d_pad;
    for (int c = 0; c < quads; ++c) {
      const uint32_t w0 = myrow[2 * c];
      const uint32_t w1 = myrow[2 * c + 1];
      const float x0 = __uint_as_float(w0 << 16);
      const float x1 = __uint_as_float(w0 & 0xffff0000u);
      const float x2 = __uint_as_float(w1 << 16);
      const float x3 = __uint_as_float(w1 & 0xffff0000u);
      const float* qp = qbase + 4 * c;
#pragma unroll
      for (int j = 0; j < kQChunk; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qp + j * d_pad);
        // bf16 x bf16 products are exact in f32, so fma == mul + add here.
        acc[j] = fmaf(x0, qv.x, acc[j]);
        acc[j] = fmaf(x1, qv.y, acc[j]);
        acc[j] = fmaf(x2, qv.z, acc[j]);
        acc[j] = fmaf(x3, qv.w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kQChunk; ++j) {
      float s = acc[j];
      if (measure_l2) s = __fsub_rn(__fmul_rn(2.f, s), sq);
      const float pv = survivors::pack(__fadd_rn(s, b), ident);
      survivors::warp_top_kpg(pv, kpg, kGroups, lane,
                              obase + static_cast<size_t>(q0 + j) * width);
    }
  }
}

}  // namespace

static int pruned_codes_smem_bytes(int d_pad) {
  return kQG * d_pad * 4 + kTile * row_words(d_pad) * 4;
}

extern "C" int pruned_codes_score(const void* work_tile,
                                  const void* work_active, const void* qg_rows,
                                  const void* codes, const void* cb,
                                  const void* mean, const void* bias,
                                  void* out, int w_pad, int mnt, int kpg,
                                  int b_pad, int cpb, int dpb, int measure_l2,
                                  void* stream) {
  const int smem = pruned_codes_smem_bytes(b_pad * dpb);
  cudaError_t err = cudaFuncSetAttribute(
      pruned_codes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pruned_codes_kernel<<<w_pad, kTile, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(work_tile),
      static_cast<const int32_t*>(work_active),
      static_cast<const __nv_bfloat16*>(qg_rows),
      static_cast<const uint8_t*>(codes), static_cast<const float*>(cb),
      static_cast<const float*>(mean), static_cast<const float*>(bias),
      static_cast<int32_t*>(out), mnt, kpg, b_pad, cpb, dpb, measure_l2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
