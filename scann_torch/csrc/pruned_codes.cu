// Pruned decode scorer over 8-bit AH center ids (tree-AH float lookup and
// lut256, "K4").
//
// Replaces the Pallas TPU kernel scann_tpu/ops/pruned_lut.py
// score_work_pallas_codes (_kernel :75-111, pallas_call at :156).
// Contract (shared with the plain torch version
// scann_torch/ops/pruned_lut.py score_work_torch_codes): for every ACTIVE
// work item w,
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
// What bounds it on the H100: one byte per block and slot in, and the
// 512 x 128 x d_pad products of each item; per 10k-query batch both the
// bytes and the bf16 tensor-core time are a fraction of a millisecond.
// What the design does about it: K4 is K2 (pruned_rows.cu) with a decode
// in place of the row copy.  The body is csrc/tile_mma.cuh: the codes of
// a 32-dimension chunk (a few bytes a slot) and its mean values stream
// through the cp.async ring, each block decodes its 256-slot slab into a
// bf16 tile in shared memory (the TPU kernel decoded with a one-hot x
// codebook matmul; here the decode is a table read through L1), the
// products run on the bf16 tensor cores (mma.sync m16n8k16), and the
// squared norms ride in a per-slot plane to the epilogue.  Shared memory
// does not grow with d_pad, so any width runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "survivors.cuh"
#include "tile_mma.cuh"

namespace {

using tile_mma::Rows;
using tile_mma::Src;
// 2 and 4 dimensions per block decode with the chunk's codes in
// registers; any other width reads them from shared memory.
using Codes2 = Rows<Src::kCodes, /*kTileSlots=*/512, /*kDpbC=*/2>;
using Codes4 = Rows<Src::kCodes, /*kTileSlots=*/512, /*kDpbC=*/4>;
using CodesN = Rows<Src::kCodes, /*kTileSlots=*/512, /*kDpbC=*/0>;

}  // namespace

extern "C" int pruned_codes_score(const void* work_tile,
                                  const void* work_active, const void* qg_rows,
                                  const void* codes, const void* cb,
                                  const void* mean, const void* bias,
                                  void* out, int w_pad, int mnt, int kpg,
                                  int b_pad, int cpb, int dpb, int measure_l2,
                                  void* stream) {
  tile_mma::Args a{static_cast<const int32_t*>(work_tile),
                   static_cast<const int32_t*>(work_active),
                   static_cast<const __nv_bfloat16*>(qg_rows),
                   codes,
                   nullptr,
                   static_cast<const float*>(bias),
                   static_cast<int32_t*>(out),
                   mnt, kpg, b_pad * dpb, measure_l2 ? 2.f : 1.f};
  a.cb = static_cast<const float*>(cb);
  a.mean = static_cast<const float*>(mean);
  a.cpb = cpb;
  a.dpb = dpb;
  a.b_pad = b_pad;
  a.l2 = measure_l2;
  if (dpb == 2) return tile_mma::score<Codes2>(a, w_pad, stream);
  if (dpb == 4) return tile_mma::score<Codes4>(a, w_pad, stream);
  return tile_mma::score<CodesN>(a, w_pad, stream);
}

// Registers a thread, dynamic shared memory a block, resident blocks an SM
// and local (spill) bytes a thread of the kernel that serves dpb
// dimensions per block at kpg survivors a group, into info[0..3]; d_pad is
// taken for the signature's sake: nothing of the kernel depends on it.
extern "C" int pruned_codes_occupancy(int d_pad, int dpb, int kpg,
                                      void* info) {
  (void)d_pad;
  if (dpb == 2) return tile_mma::occupancy<Codes2>(kpg, info);
  if (dpb == 4) return tile_mma::occupancy<Codes4>(kpg, info);
  return tile_mma::occupancy<CodesN>(kpg, info);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
