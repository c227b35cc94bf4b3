// Survivor epilogue shared by the pruned scorers (pruned_sq.cu,
// pruned_rows.cu, pruned_lut.cu, pruned_codes.cu): the port of the JAX
// package's pruned_scan._group_top_packed.
//
// A score becomes a survivor in two steps.  First its (tile-in-leaf, slot-
// in-group) identity is written into the low 9 mantissa bits, which makes
// every value of a 32-slot group distinct.  Then kpg passes each take the
// group's maximum and mask the one slot that held it.  Pass p of group gi
// of work item (g, t) lands in int32 column t*kpg*groups + p*groups + gi of
// out[g, q, :], the layout the merge reads.
//
// Two forms of the selection: across the lanes of a warp (lane = slot, one
// query at a time), and across the 4 lanes of a quad that hold 8 slots
// each (the mma accumulator layout).

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

// Sorts 8 values, largest first (Batcher's 19-comparator network).
__device__ __forceinline__ void sort8_desc(float (&v)[8]) {
  constexpr int kNet[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2},
                               {1, 3}, {4, 6}, {5, 7}, {1, 2}, {5, 6},
                               {0, 4}, {3, 7}, {1, 5}, {2, 6}, {1, 4},
                               {3, 6}, {2, 4}, {3, 5}, {3, 4}};
#pragma unroll
  for (int i = 0; i < 19; ++i) {
    const float hi = fmaxf(v[kNet[i][0]], v[kNet[i][1]]);
    v[kNet[i][1]] = fminf(v[kNet[i][0]], v[kNet[i][1]]);
    v[kNet[i][0]] = hi;
  }
}

// The 4 largest of 8 values in v[0..3], largest first; v[4..7] are left
// undefined.  Two sorted halves (5 comparators each), the top 4 of their
// union as a bitonic sequence (4 maxima), then 4 comparators.
__device__ __forceinline__ void top4of8_desc(float (&v)[8]) {
  constexpr int kNet[10][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2},
                               {1, 3}, {4, 6}, {5, 7}, {1, 2}, {5, 6}};
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const float hi = fmaxf(v[kNet[i][0]], v[kNet[i][1]]);
    v[kNet[i][1]] = fminf(v[kNet[i][0]], v[kNet[i][1]]);
    v[kNet[i][0]] = hi;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], v[7 - i]);
  constexpr int kBitonic[4][2] = {{0, 2}, {1, 3}, {0, 1}, {2, 3}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float hi = fmaxf(v[kBitonic[i][0]], v[kBitonic[i][1]]);
    v[kBitonic[i][1]] = fminf(v[kBitonic[i][0]], v[kBitonic[i][1]]);
    v[kBitonic[i][0]] = hi;
  }
}

// The 4 lanes of a quad (lane & 3) hold the 32 packed values of a group, 8
// each, for R rows (queries) at once: pv[r] is row r's part (fully
// unrolled, so pv stays in registers, and the R selections of a pass are
// independent, so their latencies overlap).  Each lane sorts its kKeep
// largest values once (kKeep 4 serves kpg <= 4: no lane gives more than
// kpg survivors); a pass then takes the maximum of the 4 heads and the
// lane that held it (values are distinct: one lane) pops its head.  Every
// lane of the warp calls; the quad's ``writer`` lane writes row r's kpg
// survivors to out(r)[0], out(r)[stride], ...
template <int kKeep = 8, int R, class Out>
__device__ __forceinline__ void quad_top_kpg(float (&pv)[R][8], int kpg,
                                             int stride, bool writer,
                                             Out out) {
  static_assert(kKeep == 4 || kKeep == 8, "a lane keeps 4 or 8 values");
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if constexpr (kKeep == 8)
      sort8_desc(pv[r]);
    else
      top4of8_desc(pv[r]);
  }
  for (int p = 0; p < kpg; ++p) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float m = fmaxf(pv[r][0], __shfl_xor_sync(0xffffffffu, pv[r][0], 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (writer) out(r)[p * stride] = __float_as_int(m);
      const bool pop = pv[r][0] == m;
#pragma unroll
      for (int s = 0; s < kKeep - 1; ++s)
        pv[r][s] = pop ? pv[r][s + 1] : pv[r][s];
      pv[r][kKeep - 1] = pop ? -INFINITY : pv[r][kKeep - 1];
    }
  }
}

}  // namespace survivors
