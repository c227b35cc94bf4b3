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
// 10k-query batch are a fraction of a millisecond.  What the design does
// about it: the product runs on the bf16 tensor cores (mma.sync
// m16n8k16), the rows and queries stream over the dimension axis in
// chunks of 32 through a cp.async ring, so shared memory does not grow
// with d_pad (any multiple of 8 runs), and each block scores one 256-slot
// slab of the tile against 64 queries (four blocks an item), selecting
// survivors across the quads of the accumulator layout and writing them
// in full sectors.  The body is csrc/tile_mma.cuh, shared with K1
// (pruned_sq.cu): K2 copies its bf16 rows as they are and scales by one
// number.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "survivors.cuh"
#include "tile_mma.cuh"

namespace {

using BfRows = tile_mma::Rows</*kInt8Rows=*/false, /*kTileSlots=*/512>;

}  // namespace

extern "C" int pruned_rows_score(const void* work_tile,
                                 const void* work_active, const void* qg_rows,
                                 const void* rows, const void* bias, void* out,
                                 int w_pad, int mnt, int kpg, int d_pad,
                                 float scale, void* stream) {
  const tile_mma::Args a{static_cast<const int32_t*>(work_tile),
                         static_cast<const int32_t*>(work_active),
                         static_cast<const __nv_bfloat16*>(qg_rows),
                         rows,
                         nullptr,
                         static_cast<const float*>(bias),
                         static_cast<int32_t*>(out),
                         mnt, kpg, d_pad, scale};
  return tile_mma::score<BfRows>(a, w_pad, stream);
}

// Registers a thread, dynamic shared memory a block, resident blocks an SM
// and local (spill) bytes a thread at kpg survivors a group, into
// info[0..3]; d_pad is taken for the signature's sake: nothing of the
// kernel depends on it.
extern "C" int pruned_rows_occupancy(int d_pad, int kpg, void* info) {
  (void)d_pad;
  return tile_mma::occupancy<BfRows>(kpg, info);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
