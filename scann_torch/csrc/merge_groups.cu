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
// tile among the columns that hold it, that one column set to -2^127.
// Pass p writes the key's bits to m_bits[g, q, p] and the tile to
// t_sel[g, q, p].  Integer and compare work only.
//
// What bounds it on the H100: the packed block is read once (w words a
// row) and 2k words a row are written; there is no arithmetic to speak
// of, so the bound is bytes.  One warp owns a row: it rewrites the row
// into shared memory once (lane = column mod 32, so every later read is
// conflict-free), and a pass is a per-lane scan of w / 32 keys followed by
// a 5-step butterfly on (key, tile, column).  The k passes re-read the row
// from shared memory; keeping a lane's keys in registers, or a per-lane
// sorted prefix, would cut that and is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "survivors.cuh"

namespace {

using survivors::kIdMask;
using survivors::kIdxBits;
using survivors::kQG;

constexpr int kRows = 8;                  // rows (warps) per block
constexpr int kThreads = kRows * 32;
constexpr uint32_t kBigNegBits = 0xFF000000u;   // -2^127

// True when candidate (v, t, c) replaces the best so far (bv, bt, bc); a
// negative column means "none yet".
__device__ __forceinline__ bool beats(float v, int t, int c, float bv, int bt,
                                      int bc) {
  return c >= 0 && (bc < 0 || v > bv || (v == bv && t > bt));
}

__global__ void __launch_bounds__(kThreads)
merge_groups_kernel(const int32_t* __restrict__ packed,
                    const int32_t* __restrict__ qg_nt,
                    int32_t* __restrict__ m_bits, int32_t* __restrict__ t_sel,
                    long long n_rows, int w, int k, int gp_bits,
                    int kgp_bits) {
  extern __shared__ float pv_s[];          // kRows x w keys
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + warp;
  if (row >= n_rows) return;
  float* pv = pv_s + warp * w;
  const float big_neg = __uint_as_float(kBigNegBits);
  const int nt = qg_nt[row / kQG];
  const int32_t* src = packed + row * w;
  const int gmask = (1 << gp_bits) - 1;
  for (int c = lane; c < w; c += 32) {
    const int bits = src[c];
    const int ident = ((c & gmask) << kIdxBits) | (bits & ((1 << kIdxBits) - 1));
    const float key = __int_as_float((bits & ~kIdMask) | ident);
    pv[c] = (c >> kgp_bits) < nt ? key : big_neg;
  }
  __syncwarp();

  int my_m = 0, my_t = 0;
  for (int p = 0; p < k; ++p) {
    float bv = 0.f;
    int bt = -1, bc = -1;
    for (int c = lane; c < w; c += 32) {
      const float v = pv[c];
      const int t = c >> kgp_bits;
      if (beats(v, t, c, bv, bt, bc)) {
        bv = v;
        bt = t;
        bc = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int ot = __shfl_xor_sync(0xffffffffu, bt, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      if (beats(ov, ot, oc, bv, bt, bc)) {
        bv = ov;
        bt = ot;
        bc = oc;
      }
    }
    // Key and tile agree on every lane now; the column may not where
    // several columns hold the same (key, tile), which only dead columns
    // do: take lane 0's.
    bc = __shfl_sync(0xffffffffu, bc, 0);
    if (lane == p) {
      my_m = __float_as_int(bv);
      my_t = bt;
    }
    if (lane == 0) pv[bc] = big_neg;
    __syncwarp();
  }
  if (lane < k) {
    m_bits[row * k + lane] = my_m;
    t_sel[row * k + lane] = my_t;
  }
}

}  // namespace

extern "C" int merge_groups_topk(const void* packed, const void* qg_nt,
                                 void* m_bits, void* t_sel, int g_pad, int w,
                                 int k, int gp_bits, int kgp_bits,
                                 void* stream) {
  const int smem = kRows * w * 4;
  cudaError_t err = cudaFuncSetAttribute(
      merge_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_rows = static_cast<long long>(g_pad) * kQG;
  const unsigned blocks = static_cast<unsigned>((n_rows + kRows - 1) / kRows);
  merge_groups_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(qg_nt),
      static_cast<int32_t*>(m_bits), static_cast<int32_t*>(t_sel), n_rows, w,
      k, gp_bits, kgp_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
