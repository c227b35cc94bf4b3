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
//   keep the top kpg of every 32-slot group and write int32
//   out[g, q, t*kpg*8 + pass*8 + group].
// Inactive items write nothing (the merge never reads their segments).
//
// What bounds it on the H100: counted once, the inputs and outputs of a
// 10k-query batch are a few hundred MB (bytes bound ~0.1-0.3 ms at
// 3.35 TB/s), and the products are ~1e11 multiply-adds (~0.2 ms at the
// bf16 tensor-core peak), so an ideal kernel sits near both roofs.  What
// the design does about it: the product runs on the bf16 tensor cores
// (mma.sync m16n8k16; int8 values are exact in bf16), streamed over the
// dimension axis in chunks of 32 through a cp.async ring, so any d_pad
// that is a multiple of 8 fits; the int8 rows are copied raw (half the
// bytes of bf16) and converted once per chunk in shared memory.  Each
// block scores the 256-slot tile against 64 queries (two blocks an item,
// the second reading the tile from L2); the survivor selection runs across
// the quads of the accumulator layout and leaves in full sectors.  With
// the product on the tensor cores, that selection and the staging set the
// pace, not the bytes or the products.  The body is csrc/tile_mma.cuh,
// shared with K2 (pruned_rows.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "survivors.cuh"
#include "tile_mma.cuh"

namespace {

using SqRows = tile_mma::Rows<tile_mma::Src::kInt8, /*kTileSlots=*/256>;

}  // namespace

extern "C" int pruned_sq_score(const void* work_tile, const void* work_active,
                               const void* qg_rows, const void* rows3,
                               const void* scale, const void* bias, void* out,
                               int w_pad, int mnt, int kpg, int d_pad,
                               float smult, void* stream) {
  const tile_mma::Args a{static_cast<const int32_t*>(work_tile),
                         static_cast<const int32_t*>(work_active),
                         static_cast<const __nv_bfloat16*>(qg_rows),
                         rows3,
                         static_cast<const float*>(scale),
                         static_cast<const float*>(bias),
                         static_cast<int32_t*>(out),
                         mnt, kpg, d_pad, smult};
  return tile_mma::score<SqRows>(a, w_pad, stream);
}

// Registers a thread, dynamic shared memory a block, resident blocks an SM
// and local (spill) bytes a thread at kpg survivors a group, into
// info[0..3]; d_pad is taken for the signature's sake: nothing of the
// kernel depends on it.
extern "C" int pruned_sq_occupancy(int d_pad, int kpg, void* info) {
  (void)d_pad;
  return tile_mma::occupancy<SqRows>(kpg, info);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
