// Pruned scorer over decoded bf16 rows (tree-AH in reconstruct mode, "K2").
//
// Replaces the Pallas TPU kernel scann_tpu/ops/pruned_scan.py
// score_work_pallas (_kernel :297-317, pallas_call at :398).  Contract
// (shared with the plain torch version scann_torch/ops/pruned_scan.py
// score_work_torch): for every ACTIVE work item w,
//   tile = work_tile[w], group g = w / mnt, t = w % mnt
//   dot  = rows[tile] (512 x d_pad bf16) . qg_rows[g] (128 x d_pad bf16),
//          exact products, f32 accumulation
//   s    = scale * dot + bias[tile]   (scale 2 under squared L2, where the
//          bias plane carries -||x_hat||^2; a rounded multiply then a
//          rounded add, never an fma)
// then the survivor epilogue (survivors.cuh) into
// out[g, q, t*kpg*16 + pass*16 + group].  Inactive items write nothing.
//
// What bounds it on the H100: the decoded tile is 2 bytes per dimension and
// slot, read once per work item, against 128 x 512 x d_pad products; at
// 128 queries a group both the bytes and the bf16 tensor-core time of one
// 10k-query batch are a fraction of a millisecond.  This first version is
// K4 (pruned_codes.cu) without the decode and runs far from both roofs:
// the products run on the CUDA cores in f32.  One block per work item
// copies the 512-slot tile into shared memory as bf16 pairs (rows padded
// to an odd word count, so per-lane row reads hit 32 banks) beside the f32
// query group; warp = 32-slot group, lane = slot, so the top-kpg selection
// is a warp max over registers.  The 16 slot groups of a tile are
// independent: walking the tile in slabs of a few groups would let d_pad
// above 128 fit in shared memory, and wgmma on the staged tile is the way
// to the tensor cores; both are later work.

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

__global__ void __launch_bounds__(kTile)
pruned_rows_kernel(const int32_t* __restrict__ work_tile,
                   const int32_t* __restrict__ work_active,
                   const __nv_bfloat16* __restrict__ qg_rows,
                   const uint32_t* __restrict__ rows,
                   const float* __restrict__ bias,
                   int32_t* __restrict__ out,
                   int mnt, int kpg, int d_pad, float scale) {
  const int w = blockIdx.x;
  if (work_active[w] != 1) return;
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
  // The tile as bf16 pairs: consecutive threads copy consecutive words of
  // a row, so the global reads coalesce and the padded rows take the
  // shared-memory writes without bank conflicts.
  const int words = d_pad / 2;
  const uint32_t* tsrc = rows + static_cast<size_t>(tile) * kTile * words;
  for (int i = threadIdx.x; i < kTile * words; i += kTile) {
    const int r = i / words;
    r_s[r * rw + (i - r * words)] = tsrc[i];
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
      const float pv =
          survivors::pack(survivors::scale_bias(acc[j], scale, b), ident);
      survivors::warp_top_kpg(pv, kpg, kGroups, lane,
                              obase + static_cast<size_t>(q0 + j) * width);
    }
  }
}

}  // namespace

static int pruned_rows_smem_bytes(int d_pad) {
  return kQG * d_pad * 4 + kTile * row_words(d_pad) * 4;
}

extern "C" int pruned_rows_score(const void* work_tile,
                                 const void* work_active, const void* qg_rows,
                                 const void* rows, const void* bias, void* out,
                                 int w_pad, int mnt, int kpg, int d_pad,
                                 float scale, void* stream) {
  const int smem = pruned_rows_smem_bytes(d_pad);
  cudaError_t err = cudaFuncSetAttribute(
      pruned_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pruned_rows_kernel<<<w_pad, kTile, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(work_tile),
      static_cast<const int32_t*>(work_active),
      static_cast<const __nv_bfloat16*>(qg_rows),
      static_cast<const uint32_t*>(rows), static_cast<const float*>(bias),
      static_cast<int32_t*>(out), mnt, kpg, d_pad, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
