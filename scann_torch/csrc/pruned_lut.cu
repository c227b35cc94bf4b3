// Pruned int8-LUT scorer over pair-packed 4-bit AH codes (tree-AH, "K3").
//
// Replaces the Pallas TPU kernel scann_tpu/ops/pruned_lut.py
// score_work_pallas_lut (_lut_kernel, pallas_call at :332).  Contract
// (shared with the plain torch version scann_torch/ops/pruned_lut.py
// score_work_torch_lut): for every query group g with an active item and
// every query row q of it (query qq = qg_query[g, q]),
//   lutf[w, q] = sum_k cb[w, k] * query[qq, block(w)*dpb + k]   (f32)
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
//   * The LUT depends only on the query and the codebook, so a pre-pass
//     kernel (lut_build_kernel) builds each query's int8 LUT and inv[q]
//     once per batch into device memory, instead of once per (group,
//     query row): bit-equal, and at 100 leaves about 125 times less work.
//     A thread covers a quarter of one query's blocks, in two passes over
//     the codebook product (the first for the per-query maximum, which
//     spans the whole LUT), each entry summed in the plain version's
//     order; at 2 dimensions per block a block's codebook rows come as
//     16-byte loads broadcast to the warp.
//   * The scorer's block owns 64 of a query group's 128 queries (two
//     blocks a group, two blocks an SM, so one block's selection
//     overlaps the other's product) and walks each tile as two 256-slot
//     slabs, a warp per 32-slot candidate group of the slab (8 warps).
//     Both operands that grow with the width stream in chunks of 32 code
//     blocks through a 2-stage cp.async ring, one step per (tile, slab,
//     chunk): the 64 queries' LUT rows of the chunk (gathered through
//     qg_query, 512 bytes each, each staged row padded by 16 bytes so
//     the ldmatrix loads of the A fragments are free of bank conflicts)
//     and the slab's code words of the chunk (16 bytes a slot).  The
//     int32 accumulators stay in registers across a slab's chunks, so
//     shared memory does not grow with b_pad (106-122 KB).  Up to b_pad
//     64 (the benchmark's 56 among them) the whole LUT is one chunk,
//     copied once a block and kept, and a slab is one step of its codes;
//     wider LUTs are copied again for each slab from L2.
//   * The one-hot B operand is built in registers, never stored: a thread
//     holds 4 consecutive k of slot column n, so its register is
//     1 << 8 * (nibble - 4 * (lane & 3)), zero when that byte lies outside
//     [0, 4) (shl.b32 clamps the shift).
//   * A warp computes its group x the block's 64 queries (16 mma a k-step,
//     64 accumulators a thread).  The integer sums are exact, so the
//     output is bit-equal to the plain version at every width.
//   * Epilogue: a query's 32 scores of the group lie in the 4 lanes of a
//     quad, 8 registers each.  survivors::quad_top_kpg sorts each lane's 8
//     once, then a pass is two shuffles of the heads and one pop, for the
//     8 queries of a thread at once.  The survivors of the slab's 8
//     groups go through shared memory, so each (query, pass) leaves as
//     one full 32-byte sector instead of 8 scattered words.  The
//     accumulators are zeroed after the selection: zeroed at the top of a
//     tile's first chunk instead, they stay live through the selection
//     and spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "survivors.cuh"

namespace {

using survivors::kQG;
using survivors::kSubp;

constexpr int kTile = 512;                // slots per leaf tile
constexpr int kGroups = kTile / kSubp;    // 16 candidate groups
constexpr int kSlab = 256;                // slots of a tile a block scores
constexpr int kWarps = kSlab / kSubp;     // a warp per candidate group
constexpr int kThreads = kWarps * 32;
constexpr int kQH = kQG / 2;              // queries per block
constexpr int kCenters = 16;
constexpr int kBuildThreads = 256;        // LUT pre-pass: 64 queries x 4
constexpr int kParts = kBuildThreads / kQH;  // LUT-build threads per query
constexpr int kCB = 32;                   // code blocks a streamed chunk
constexpr int kResident = 64;             // b_pad up to this: one chunk
constexpr int kStages = 2;
// A staged LUT row is the chunk's bytes plus 16 (an odd number of 16-byte
// units, so an ldmatrix phase's 8 rows fall on 8 bank groups).
constexpr int kLutRingB = kStages * kQH * (kCB * kCenters + 16);

static_assert(kQH * (kResident * kCenters + 16) <= kLutRingB,
              "a resident LUT fits the streamed ring");

// The chunk layout of a b_pad: up to kResident blocks the whole LUT is one
// chunk, copied once a block and kept; wider LUTs stream in kCB chunks.
struct Chunks {
  int cb;         // blocks a chunk
  int n;          // chunks
  int lut_row_b;  // bytes a staged LUT row
  int cstride;    // staged code words a slot (9 where 8 would put a
                  // warp's 8 rows on 4 banks)
  int lut_b;      // bytes of the LUT space (one resident LUT, or the ring)
  int code_b;     // bytes a code stage
  __host__ __device__ explicit Chunks(int b_pad) {
    cb = b_pad <= kResident ? b_pad : kCB;
    n = (b_pad + cb - 1) / cb;
    lut_row_b = cb * kCenters + 16;
    cstride = cb / 8 + (cb == kResident);
    lut_b = b_pad <= kResident ? kQH * lut_row_b : kLutRingB;
    code_b = kSlab * cstride * 4;
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

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

// The int8 LUT of 64 queries of the batch, lut[qq * b_pad*16 + w], and
// inv[qq]: thread (q, r) covers blocks r, r + kParts, ... of query
// blockIdx.x * 64 + q; two passes over the entries, the first for the
// per-query maximum.
template <int kDpb>
__global__ void __launch_bounds__(kBuildThreads)
lut_build_kernel(const __nv_bfloat16* __restrict__ q_rows,
                 const float* __restrict__ cb, const float* __restrict__ csq,
                 int8_t* __restrict__ lut, float* __restrict__ inv, int nq,
                 int b_pad, int dpb, int d_pad, float scale) {
  __shared__ float pmax_s[kParts * kQH];
  const int q = threadIdx.x & (kQH - 1);
  const int r = threadIdx.x / kQH;
  const int qq = blockIdx.x * kQH + q;
  const bool live = qq < nq;
  const __nv_bfloat16* qrow =
      q_rows + static_cast<size_t>(live ? qq : nq - 1) * d_pad;
  int8_t* lrow = lut + static_cast<size_t>(qq) * b_pad * kCenters;
  float mx = 0.f;
  for (int j = r; j < b_pad; j += kParts) {
    float lv[kCenters];
    lut_entries<kDpb>(cb, csq, qrow, j, dpb, scale, lv);
#pragma unroll
    for (int c = 0; c < kCenters; ++c) mx = fmaxf(mx, fabsf(lv[c]));
  }
  pmax_s[r * kQH + q] = mx;
  __syncthreads();
  if (!live) return;
  float m = pmax_s[q];
  for (int p = 1; p < kParts; ++p) m = fmaxf(m, pmax_s[p * kQH + q]);
  m = fmaxf(m, 1e-20f);
  const float mult = __fdiv_rn(127.f, m);
  if (r == 0) inv[qq] = __fmul_rn(m, static_cast<float>(1.0 / 127.0));
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
                  const int32_t* __restrict__ qg_query,
                  const int8_t* __restrict__ lut,
                  const float* __restrict__ inv,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ bias, int32_t* __restrict__ out,
                  int mnt, int kpg, int b_pad) {
  const int g = blockIdx.x >> 1;
  const int half = blockIdx.x & 1;        // queries half*64 .. +63
  int n_act = 0;  // active items of a group are its first ntiles(leaf)
  while (n_act < mnt && work_active[g * mnt + n_act] == 1) ++n_act;
  if (n_act == 0) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t lut_ring =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const Chunks ch(b_pad);
  const bool resident = ch.n == 1;
  const uint32_t code_ring = lut_ring + ch.lut_b;
  const uint32_t* code_s =
      reinterpret_cast<const uint32_t*>(smem + ch.lut_b);
  float* bias_s = reinterpret_cast<float*>(smem + ch.lut_b +
                                           kStages * ch.code_b);  // 2 slabs
  const uint32_t bias_sa =
      static_cast<uint32_t>(__cvta_generic_to_shared(bias_s));
  float* inv_s = bias_s + 2 * kSlab;                           // kQH
  int* qq_s = reinterpret_cast<int*>(inv_s + kQH);             // kQH
  // A slab's survivors, stage_s[q * qstride + pass * 8 + group]: the 8
  // groups of a (query, pass) are one 32-byte sector.
  int32_t* stage_s = reinterpret_cast<int32_t*>(qq_s + kQH);
  const int qstride = kpg * kWarps + 4;   // + 4: conflict-free writes

  const int tid = threadIdx.x;
  if (tid < kQH) {
    const int qq = qg_query[g * kQG + half * kQH + tid];
    qq_s[tid] = qq;
    inv_s[tid] = inv[qq];
  }
  __syncthreads();

  const int cb = ch.cb;
  const int lut_stage_b = kQH * ch.lut_row_b;
  // Steps run (tile, slab, chunk) in order; a slab's step u = t * 2 + slab.
  const int steps = n_act * 2 * ch.n;
  const size_t lut_row = static_cast<size_t>(b_pad) * kCenters;
  const int code_row = b_pad / 2;              // code bytes a slot

  auto issue = [&](int step) {
    const int u = step / ch.n;
    const int c = step - u * ch.n;
    const int slab = u & 1;
    const int nb = min(cb, b_pad - c * cb);    // a multiple of 8
    const int tile = work_tile[g * mnt + (u >> 1)];
    if (!resident || step == 0) {
      const uint32_t dst =
          lut_ring + (resident ? 0 : step % kStages) * lut_stage_b;
      for (int i = tid; i < kQH * nb; i += kThreads) {
        const int q = i / nb;
        const int p = i - q * nb;
        cp_async16(dst + q * ch.lut_row_b + p * 16,
                   lut + qq_s[q] * lut_row + (c * cb + p) * kCenters);
      }
    }
    const int nw = nb / 8;
    const uint32_t cdst = code_ring + (step % kStages) * ch.code_b;
    const uint8_t* csrc =
        codes + (static_cast<size_t>(tile) * kTile + slab * kSlab) * code_row +
        c * (cb / 2);
    for (int i = tid; i < kSlab * nw; i += kThreads) {
      const int slot = i / nw;
      const int w = i - slot * nw;
      cp_async4(cdst + (slot * ch.cstride + w) * 4,
                csrc + slot * code_row + w * 4);
    }
    if (c == 0) {
      const float* bsrc =
          bias + static_cast<size_t>(tile) * kTile + slab * kSlab;
      for (int i = tid; i < kSlab / 4; i += kThreads)
        cp_async16(bias_sa + ((u & 1) * kSlab + i * 4) * 4, bsrc + i * 4);
    }
  };

  const int warp = tid >> 5;              // candidate group of the slab
  const int lane = tid & 31;
  const int gq = lane >> 2;               // fragment row / column group
  const int tq = lane & 3;                // thread in the quad
  const uint32_t t32 = 32u * tq;
  const int seg = kpg * kGroups;
  const size_t width = static_cast<size_t>(mnt) * seg;
  // ldmatrix row address of this lane within a LUT stage: matrices (rows
  // 0-7 | 8-15) x (bytes 0-15 | 16-31) of a 16-query x 32-byte A tile.
  const uint32_t a_lane =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * ch.lut_row_b + (lane >> 4) * 16;

  // acc[mi][j]: queries 16 mi + gq (+8), slots 8 j + 2 tq (+1) of the
  // group (the m16n8 accumulator layout), summed over a tile's chunks.
  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;
  issue(0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    // The stage refilled here was read by step - 1, finished everywhere.
    if (step + 1 < steps) issue(step + 1);
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();   // step's chunk has landed for every thread
    const int u = step / ch.n;
    const int c = step - u * ch.n;
    const int t = u >> 1;
    const int nw = min(cb, b_pad - c * cb) / 8;
    const uint32_t a_base =
        lut_ring + (resident ? 0 : step % kStages) * lut_stage_b + a_lane;
    // Slot 8 j + gq of the group is this thread's one-hot column j.
    const int cstride = ch.cstride;
    const uint32_t* crow = code_s + (step % kStages) * (ch.code_b / 4) +
                           (warp * kSubp + gq) * cstride;
    for (int jw = 0; jw < nw; ++jw) {
      uint32_t cw[4];   // 4 code bytes = 4 k-steps of each column
#pragma unroll
      for (int j = 0; j < 4; ++j) cw[j] = crow[j * 8 * cstride + jw];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kstep = jw * 4 + i;   // blocks 2 kstep, 2 kstep + 1
        uint32_t a[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(a[mi], a_base + mi * 16 * ch.lut_row_b + kstep * 32);
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
    if (c == ch.n - 1) {
      // Slab u & 1 of tile t is complete.  Row 2 mi + h of the selection
      // is query 16 mi + 8 h + gq.
      float pv[8][8];
      float bj[8];
      const float* bt = bias_s + (u & 1) * kSlab + warp * kSubp;
#pragma unroll
      for (int s = 0; s < 8; ++s)
        bj[s] = bt[8 * (s >> 1) + 2 * tq + (s & 1)];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float iv = inv_s[16 * mi + 8 * h + gq];
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            const float sc = survivors::scale_bias(
                small_int_to_float(acc[mi][s >> 1][2 * h + (s & 1)]), iv,
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
      // Copy the slab's survivors out, 16 bytes a thread and step.
      for (int i = tid; i < kQH * kpg * 2; i += kThreads) {
        const int q = i / (kpg * 2);
        const int p = (i >> 1) - q * kpg;
        const int h = (i & 1) * 4;
        *reinterpret_cast<uint4*>(
            out + (static_cast<size_t>(g) * kQG + half * kQH + q) * width +
            t * seg + p * kGroups + (u & 1) * kWarps + h) =
            *reinterpret_cast<const uint4*>(stage_s + q * qstride +
                                            p * kWarps + h);
      }
      // The next slab's sums start here, after the selection: zeroed at
      // the top of its first chunk instead, the accumulators would stay
      // live through the selection and spill.
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;
    }
    __syncthreads();   // the stage is free for the copy of step + 2
  }
}

}  // namespace

static int pruned_lut_smem_bytes(int b_pad, int kpg) {
  const Chunks ch(b_pad);
  return ch.lut_b + kStages * ch.code_b + (2 * kSlab + 2 * kQH) * 4 +
         kQH * (kpg * kWarps + 4) * 4;
}

// The int8 LUTs of nq queries (q_rows (nq, d_pad) bf16) into lut
// (nq, b_pad * 16) int8 and inv (nq,) f32.
extern "C" int pruned_lut_build(const void* q_rows, const void* cb,
                                const void* csq, void* lut, void* inv, int nq,
                                int b_pad, int dpb, int d_pad, float scale,
                                void* stream) {
  const int blocks = (nq + kQH - 1) / kQH;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(q_rows);
  const float* c = static_cast<const float*>(cb);
  const float* s = static_cast<const float*>(csq);
  int8_t* l = static_cast<int8_t*>(lut);
  float* v = static_cast<float*>(inv);
  // Two dimensions per block (the benchmark's `score_ah(2)`) has its
  // codebook rows come as 16-byte loads.
  if (dpb == 2)
    lut_build_kernel<2><<<blocks, kBuildThreads, 0, st>>>(
        q, c, s, l, v, nq, b_pad, dpb, d_pad, scale);
  else
    lut_build_kernel<0><<<blocks, kBuildThreads, 0, st>>>(
        q, c, s, l, v, nq, b_pad, dpb, d_pad, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pruned_lut_score(const void* work_tile, const void* work_active,
                                const void* qg_query, const void* lut,
                                const void* inv, const void* codes,
                                const void* bias, void* out, int g_pad, int mnt,
                                int kpg, int b_pad, void* stream) {
  const int smem = pruned_lut_smem_bytes(b_pad, kpg);
  cudaError_t err = cudaFuncSetAttribute(
      pruned_lut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pruned_lut_kernel<<<2 * g_pad, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(work_tile),
      static_cast<const int32_t*>(work_active),
      static_cast<const int32_t*>(qg_query), static_cast<const int8_t*>(lut),
      static_cast<const float*>(inv), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(bias), static_cast<int32_t*>(out), mnt, kpg,
      b_pad);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, dynamic shared memory a block, resident blocks an SM
// and local (spill) bytes a thread of the scorer at b_pad code blocks and
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
