// Survivor epilogue shared by the pruned scorers (pruned_sq.cu,
// pruned_lut.cu, pruned_codes.cu): the port of the JAX package's
// pruned_scan._group_top_packed.
//
// A score becomes a survivor in two steps.  First its (tile-in-leaf, slot-
// in-group) identity is written into the low 9 mantissa bits, which makes
// every value of a 32-slot group distinct.  Then kpg passes each take the
// group's maximum and mask the one slot that held it.  Pass p of group gi
// of work item (g, t) lands in int32 column t*kpg*groups + p*groups + gi of
// out[g, q, :], the layout the merge reads.
//
// Two forms of the selection: across the lanes of a warp (lane = slot, one
// query at a time), and within one thread that holds all 32 slots of a
// group in registers.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace survivors {

constexpr int kQG = 128;        // queries per work group
constexpr int kSubp = 32;       // slots per candidate group (= warp)
constexpr int kIdxBits = 5;     // slot-in-group bits
constexpr int kIdMask = (1 << 9) - 1;

// dot * scale + bias as a rounded multiply then a rounded add, never
// contracted to an fma: the low bits feed the identity packing and the
// selection, and the plain torch versions round twice.
__device__ __forceinline__ float scale_bias(float acc, float scale,
                                            float bias) {
  return __fadd_rn(__fmul_rn(acc, scale), bias);
}

__device__ __forceinline__ int identity(int t, int slot_in_group) {
  return (t << kIdxBits) | slot_in_group;
}

__device__ __forceinline__ float pack(float s, int ident) {
  return __int_as_float((__float_as_int(s) & ~kIdMask) | ident);
}

// Lane = slot.  All 32 lanes call with their packed value; lane 0 writes
// the kpg survivors to o[0], o[stride], ...
__device__ __forceinline__ void warp_top_kpg(float pv, int kpg, int stride,
                                             int lane, int32_t* o) {
  for (int p = 0; p < kpg; ++p) {
    float m = pv;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) o[p * stride] = __float_as_int(m);
    if (pv == m) pv = -INFINITY;  // values are distinct: one lane
  }
}

// One thread holds the 32 packed values of a group (fully unrolled, so pv
// stays in registers) and writes the kpg survivors itself.
__device__ __forceinline__ void thread_top_kpg(float (&pv)[kSubp], int kpg,
                                               int stride, int32_t* o) {
  for (int p = 0; p < kpg; ++p) {
    float m = pv[0];
#pragma unroll
    for (int s = 1; s < kSubp; ++s) m = fmaxf(m, pv[s]);
    o[p * stride] = __float_as_int(m);
#pragma unroll
    for (int s = 0; s < kSubp; ++s)
      if (pv[s] == m) pv[s] = -INFINITY;
  }
}

}  // namespace survivors
