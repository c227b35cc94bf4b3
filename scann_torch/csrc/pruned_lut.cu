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
// The TPU kernel did the lookup as a one-hot x LUT matmul and kept the LUT
// in scratch across the sequential grid steps of a group.  Here the lookup
// is an indexed shared-memory read, and one block owns one query group:
// it builds the group's LUT once in shared memory (two passes over the
// codebook product, the first for the per-query maximum, so no f32 copy
// of the LUT is ever held) and loops over the group's active tiles.
//
// What bounds it on the H100: the codes are half a byte per block and
// slot, so the bytes bound is a fraction of a millisecond for a 10k-query
// batch, and so is the one-hot matmul at the int8 tensor-core peak.  This
// first version runs the lookups on the integer ALUs and is bound by
// them.  Its design keeps them cheap: the LUT is stored biased to
// unsigned bytes, one row = 128 queries = 32 words, so a warp reads a row
// without bank conflicts (lane = 4 queries, every lane the same row) and
// adds four lookups with two masked adds into packed 16-bit sums.  A warp
// walks the 32 slots of a candidate group with both accumulator sets in
// registers, so the top-kpg selection needs no shuffles and no shared
// memory.  An mma-based one-hot product is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "survivors.cuh"

namespace {

using survivors::kQG;
using survivors::kSubp;

constexpr int kTile = 512;                // slots per leaf tile
constexpr int kGroups = kTile / kSubp;    // 16 candidate groups
constexpr int kThreads = 256;             // 8 warps, two groups each
constexpr int kWarps = kThreads / 32;
constexpr int kCenters = 16;
constexpr int kLutBias = 127;             // int8 LUT stored as value + 127

__global__ void __launch_bounds__(kThreads)
pruned_lut_kernel(const int32_t* __restrict__ work_tile,
                  const int32_t* __restrict__ work_active,
                  const __nv_bfloat16* __restrict__ qg_rows,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ cb, const float* __restrict__ csq,
                  const float* __restrict__ bias, int32_t* __restrict__ out,
                  int mnt, int kpg, int b_pad, int dpb, int d_pad,
                  float scale) {
  const int g = blockIdx.x;
  int n_act = 0;  // active items of a group are its first ntiles(leaf)
  while (n_act < mnt && work_active[g * mnt + n_act] == 1) ++n_act;
  if (n_act == 0) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const int wdim = b_pad * kCenters;
  const int cwords = b_pad / 8;           // code words per slot
  uint32_t* lut_s = reinterpret_cast<uint32_t*>(smem);      // wdim x 32
  float* inv_s = reinterpret_cast<float*>(lut_s + wdim * 32);   // kQG
  float* pmax_s = inv_s + kQG;                                  // 2 x kQG
  float* bias_s = pmax_s + 2 * kQG;                             // kTile
  uint32_t* code_s = reinterpret_cast<uint32_t*>(bias_s + kTile);

  // ---- per-group LUT: thread (q, r) covers blocks r, r + 2, ...
  {
    const int q = threadIdx.x & (kQG - 1);
    const int r = threadIdx.x >> 7;
    const __nv_bfloat16* qrow =
        qg_rows + (static_cast<size_t>(g) * kQG + q) * d_pad;
    uint8_t* lut_b = reinterpret_cast<uint8_t*>(lut_s);
    float mx = 0.f;
    float mult = 0.f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int j = r; j < b_pad; j += 2) {
        for (int c = 0; c < kCenters; ++c) {
          const int w = j * kCenters + c;
          float acc = 0.f;
          // bf16 x bf16 products are exact in f32, so fma == mul + add.
          for (int k = 0; k < dpb; ++k)
            acc = fmaf(cb[w * dpb + k],
                       __bfloat162float(qrow[j * dpb + k]), acc);
          const float lv = __fsub_rn(__fmul_rn(scale, acc), csq[w]);
          if (pass == 0) {
            mx = fmaxf(mx, fabsf(lv));
          } else {
            float v = rintf(__fmul_rn(lv, mult));
            v = fminf(fmaxf(v, -127.f), 127.f);
            lut_b[w * kQG + q] =
                static_cast<uint8_t>(static_cast<int>(v) + kLutBias);
          }
        }
      }
      if (pass == 0) {
        pmax_s[r * kQG + q] = mx;
        __syncthreads();
        const float m = fmaxf(fmaxf(pmax_s[q], pmax_s[kQG + q]), 1e-20f);
        mult = __fdiv_rn(127.f, m);
        if (r == 0) inv_s[q] = __fmul_rn(m, static_cast<float>(1.0 / 127.0));
      }
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = kpg * kGroups;
  const size_t width = static_cast<size_t>(mnt) * seg;
  const int offset = kLutBias * b_pad;    // bias summed over all blocks
  for (int t = 0; t < n_act; ++t) {
    const int tile = work_tile[g * mnt + t];
    __syncthreads();  // LUT complete; previous tile's staging consumed
    float inv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) inv[k] = inv_s[4 * lane + k];
    const uint32_t* csrc = reinterpret_cast<const uint32_t*>(
        codes + static_cast<size_t>(tile) * kTile * (b_pad / 2));
    for (int i = threadIdx.x; i < kTile * cwords; i += kThreads)
      code_s[i] = csrc[i];
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      bias_s[i] = bias[static_cast<size_t>(tile) * kTile + i];
    __syncthreads();

    for (int gi = warp; gi < kGroups; gi += kWarps) {
      // Packed sums: lo holds queries 4*lane+0 (low half) and +2 (high
      // half), hi holds +1 and +3; each half stays under 2^16
      // (254 * b_pad) for every b_pad the shared memory admits.
      uint32_t lo[kSubp], hi[kSubp];
#pragma unroll
      for (int s = 0; s < kSubp; ++s) lo[s] = hi[s] = 0u;
      const uint32_t* crow = code_s + gi * kSubp * cwords;
      for (int jw = 0; jw < cwords; ++jw) {
        const uint32_t* lrow = lut_s + jw * 8 * kCenters * 32 + lane;
#pragma unroll
        for (int s = 0; s < kSubp; ++s) {
          const uint32_t cw = crow[s * cwords + jw];  // 8 blocks, broadcast
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const uint32_t nib = (cw >> (4 * n)) & 15u;
            const uint32_t v = lrow[(n * kCenters + nib) * 32];
            lo[s] += v & 0x00ff00ffu;
            hi[s] += (v >> 8) & 0x00ff00ffu;
          }
        }
      }
      int32_t* obase = out + static_cast<size_t>(g) * kQG * width +
                       t * seg + gi;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float pv[kSubp];
#pragma unroll
        for (int s = 0; s < kSubp; ++s) {
          const uint32_t packed = (k & 1) ? hi[s] : lo[s];
          const int acc =
              static_cast<int>((k & 2) ? (packed >> 16) : (packed & 0xffffu)) -
              offset;
          const float sc = survivors::scale_bias(
              static_cast<float>(acc), inv[k], bias_s[gi * kSubp + s]);
          pv[s] = survivors::pack(sc, survivors::identity(t, s));
        }
        survivors::thread_top_kpg(
            pv, kpg, kGroups,
            obase + static_cast<size_t>(4 * lane + k) * width);
      }
    }
  }
}

}  // namespace

static int pruned_lut_smem_bytes(int b_pad) {
  return b_pad * 16 * 128 + (3 * 128 + 512) * 4 + 512 * (b_pad / 2);
}

extern "C" int pruned_lut_score(const void* work_tile, const void* work_active,
                                const void* qg_rows, const void* codes,
                                const void* cb, const void* csq,
                                const void* bias, void* out, int g_pad, int mnt,
                                int kpg, int b_pad, int dpb, int d_pad,
                                float scale, void* stream) {
  const int smem = pruned_lut_smem_bytes(b_pad);
  cudaError_t err = cudaFuncSetAttribute(
      pruned_lut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pruned_lut_kernel<<<g_pad, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(work_tile),
      static_cast<const int32_t*>(work_active),
      static_cast<const __nv_bfloat16*>(qg_rows),
      static_cast<const uint8_t*>(codes), static_cast<const float*>(cb),
      static_cast<const float*>(csq), static_cast<const float*>(bias),
      static_cast<int32_t*>(out), mnt, kpg, b_pad, dpb, d_pad, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
