// Pruned exact scorer over residual per-row int8 leaves (tree-SQ, "K1").
//
// Replaces the Pallas TPU kernel scann_tpu/ops/pruned_sq.py
// score_work_pallas_sq (_kernel, pallas_call at :107).  Contract (shared
// with the plain torch version scann_torch/ops/pruned_sq.py
// score_work_torch_sq): for every ACTIVE work item w,
//   tile  = work_tile[w], group g = w / mnt, t = w % mnt
//   dot   = rows3[tile] (256 x d_pad int8, exact in f32)
//           . qg_rows[g] (128 x d_pad bf16, exact in f32), f32 accumulation
//   s     = dot * (scale * smult) + bias       (rounded mul, then add)
//   packed identity (t << 5 | slot-in-group) into the low 9 mantissa bits,
//   keep the top kpg of every 32-slot group by kpg max-and-mask passes and
//   write int32 out[g, q, t*kpg*8 + pass*8 + group].
// Inactive items write nothing (the merge never reads their segments).
//
// What bounds it on the H100: counted once, the inputs and outputs of a
// 10k-query batch are a few hundred MB (bytes bound ~0.1-0.3 ms at
// 3.35 TB/s), and the products are ~1e11 multiply-adds (~0.2 ms at the
// bf16 tensor-core peak), so an ideal kernel sits near both roofs.  This
// first version is deliberately simple and runs far from either: the
// products run on the CUDA cores in f32 (exact products, so any summation
// order is within the plain version's rounding), not on the tensor cores.
// Its design keeps the work on-chip: one block per work item stages the
// query group (as f32) and the int8 tile (rows padded to an odd word
// count, so the per-lane row reads hit 32 distinct banks) in shared
// memory; warp = 32-slot group, lane = slot, so the per-group top-kpg
// selection is a warp max over registers (__shfl_xor_sync) with no shared
// memory traffic, and each survivor leaves the chip as one int32.  The
// query-group reads are warp-wide broadcasts (float4: four FMAs per
// load).  Moving the product to wgmma with TMA-fed tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQG = 128;      // queries per work group
constexpr int kTile = 256;    // slots per leaf tile (= threads per block)
constexpr int kSubp = 32;     // slots per candidate group (= warp)
constexpr int kGroups = kTile / kSubp;
constexpr int kQChunk = 32;   // query columns accumulated per pass
constexpr int kIdxBits = 5;
constexpr int kIdMask = (1 << 9) - 1;

__host__ __device__ inline int row_words(int d_pad) {
  return d_pad / 4 + 1;       // d_pad % 8 == 0, so this is odd
}

__global__ void __launch_bounds__(kTile)
pruned_sq_kernel(const int32_t* __restrict__ work_tile,
                 const int32_t* __restrict__ work_active,
                 const __nv_bfloat16* __restrict__ qg_rows,
                 const int8_t* __restrict__ rows3,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 int32_t* __restrict__ out,
                 int mnt, int kpg, int d_pad, float smult) {
  const int w = blockIdx.x;
  if (work_active[w] != 1) return;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                 // kQG x d_pad
  uint32_t* r_s = reinterpret_cast<uint32_t*>(q_s + kQG * d_pad);
  const int rw = row_words(d_pad);
  const int wpr = d_pad / 4;
  const int g = w / mnt;
  const int t = w - g * mnt;
  const int tile = work_tile[w];

  const __nv_bfloat162* qsrc = reinterpret_cast<const __nv_bfloat162*>(
      qg_rows + static_cast<size_t>(g) * kQG * d_pad);
  for (int i = threadIdx.x; i < kQG * d_pad / 2; i += kTile) {
    const float2 f = __bfloat1622float2(qsrc[i]);
    q_s[2 * i] = f.x;
    q_s[2 * i + 1] = f.y;
  }
  const uint32_t* rsrc = reinterpret_cast<const uint32_t*>(
      rows3 + static_cast<size_t>(tile) * kTile * d_pad);
  for (int i = threadIdx.x; i < kTile * wpr; i += kTile) {
    const int r = i / wpr;
    r_s[r * rw + (i - r * wpr)] = rsrc[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x;
  const float sc = scale[static_cast<size_t>(tile) * kTile + slot] * smult;
  const float b = bias[static_cast<size_t>(tile) * kTile + slot];
  const int ident = (t << kIdxBits) | lane;
  const int seg = kpg * kGroups;
  const size_t width = static_cast<size_t>(mnt) * seg;
  int32_t* obase = out + static_cast<size_t>(g) * kQG * width + t * seg + warp;
  const uint32_t* myrow = r_s + slot * rw;

  for (int q0 = 0; q0 < kQG; q0 += kQChunk) {
    float acc[kQChunk];
#pragma unroll
    for (int j = 0; j < kQChunk; ++j) acc[j] = 0.f;
    const float* qbase = q_s + q0 * d_pad;
    for (int c = 0; c < wpr; ++c) {
      const uint32_t word = myrow[c];
      const float x0 = static_cast<float>(static_cast<int8_t>(word & 0xff));
      const float x1 =
          static_cast<float>(static_cast<int8_t>((word >> 8) & 0xff));
      const float x2 =
          static_cast<float>(static_cast<int8_t>((word >> 16) & 0xff));
      const float x3 = static_cast<float>(static_cast<int8_t>(word >> 24));
      const float* qp = qbase + 4 * c;
#pragma unroll
      for (int j = 0; j < kQChunk; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qp + j * d_pad);
        // int8 x bf16 products are exact in f32, so fma == mul + add here.
        acc[j] = fmaf(x0, qv.x, acc[j]);
        acc[j] = fmaf(x1, qv.y, acc[j]);
        acc[j] = fmaf(x2, qv.z, acc[j]);
        acc[j] = fmaf(x3, qv.w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kQChunk; ++j) {
      // Rounded multiply then add, never contracted to an fma: the low
      // bits feed the identity packing and the selection.
      const float s = __fadd_rn(__fmul_rn(acc[j], sc), b);
      float pv = __int_as_float((__float_as_int(s) & ~kIdMask) | ident);
      int32_t* o = obase + static_cast<size_t>(q0 + j) * width;
      for (int p = 0; p < kpg; ++p) {
        float m = pv;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) o[p * kGroups] = __float_as_int(m);
        if (pv == m) pv = -INFINITY;  // values are distinct: one lane
      }
    }
  }
}

}  // namespace

extern "C" int pruned_sq_score(const void* work_tile, const void* work_active,
                               const void* qg_rows, const void* rows3,
                               const void* scale, const void* bias, void* out,
                               int w_pad, int mnt, int kpg, int d_pad,
                               float smult, void* stream) {
  const size_t smem = static_cast<size_t>(kQG) * d_pad * sizeof(float) +
                      static_cast<size_t>(kTile) * row_words(d_pad) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      pruned_sq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pruned_sq_kernel<<<w_pad, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(work_tile),
      static_cast<const int32_t*>(work_active),
      static_cast<const __nv_bfloat16*>(qg_rows),
      static_cast<const int8_t*>(rows3), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<int32_t*>(out), mnt, kpg,
      d_pad, smult);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
