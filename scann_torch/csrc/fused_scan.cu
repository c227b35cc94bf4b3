// Fused full-scan score + group max (tree-AH reconstruct mode, "K5").
//
// Replaces the Pallas TPU kernel scann_tpu/ops/fused_scan.py
// fused_scan_groupmax (_kernel :58-70, pallas_call at :92).  Contract
// (shared with the plain torch version scann_torch/ops/fused_scan.py
// fused_scan_groupmax_torch): for every query q and every group G of 256
// consecutive slots,
//   s[slot]   = scale * (rows[slot] . queries[q]) + bias[slot]
//               (bf16 x bf16 products, exact in f32, f32 accumulation;
//               a rounded multiply then a rounded add, never an fma)
//   vals[q,G] = max over the group's slots of s
//   idx[q,G]  = the global slot id of that maximum, the first slot on ties
// The (Q, S) score matrix is never written.  The TPU kernel wrote its
// outputs block-major and transposed them afterwards (a Mosaic layout
// matter); this one writes the (Q, S/256) layout directly.
//
// What bounds it on the H100: 2 * Q * S * d operations against S * d * 2
// bytes of rows and Q * S / 256 * 8 bytes of output, so from a few hundred
// queries on it is bound by operations at the bf16 tensor-core rate.  The
// products run on the tensor cores as wgmma.mma_async m64n256k16 (bf16 in,
// f32 accumulators), so a 256-slot candidate group is one wgmma N extent
// and its maximum is a reduction inside the accumulator registers:
//   * a block of two warpgroups owns 128 queries (64 each) and walks the
//     8 groups of one 2048-slot block;
//   * both operands stream along the dimension axis in chunks of 64 (one
//     128-byte row a chunk): a stage holds a group's 256 row chunks
//     (32 KB) and the 128 query chunks of the same dimensions (16 KB), a
//     ring of 4 stages filled with cp.async, so three stages are in
//     flight while the tensor cores work on the fourth, and shared memory
//     is 4 x 48 KB at every d.  The accumulators of the 128 queries x 256
//     slots stay in registers across a group's chunks;
//   * the loop runs groups outer and chunks inner, so a query chunk is
//     copied once a group (8 times a block), from L2: the accumulators of
//     a second group would not fit the registers, and the query bytes are
//     half a row chunk's;
//   * tiles are stored in the 128-byte swizzled K-major layout the wgmma
//     descriptors read (16-byte chunk c of row r at c ^ (r & 7)), which is
//     also free of bank conflicts for the cp.async writes;
//   * after a group's last chunk each thread holds 64 scores of two query
//     rows (columns 8j + 2t + {0, 1}); it scans them in rising slot order
//     with a strict compare, then two __shfl_xor_sync steps across the
//     quad that hold a row take the maximum, preferring the lower slot on
//     equal values.  No score matrix.
// Row traffic: the grid runs the query tiles of one 2048-slot block next
// to each other (blockIdx.x = query tile), so the 79 blocks of a 10,000-
// query batch read a slot block at about the same time: the rows come from
// device memory about once (S * d * 2 bytes, 319 MB at bench scale) and
// from L2 for the other query tiles (Q / 128 passes, 25 GB through L2).
// Each block also reads its query tile once a group (Q * d * 2 * S / 256
// bytes, 12.8 GB through L2 at bench scale).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQT = 128;          // queries per block: two warpgroups
constexpr int kSub = 256;         // slots per candidate group = wgmma N
constexpr int kBS = 2048;         // slots per block
constexpr int kGroups = kBS / kSub;
constexpr int kKC = 64;           // dimensions per chunk: one 128-byte row
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kRowChunkBytes = kSub * kKC * 2;   // 32 KB
constexpr int kQChunkBytes = kQT * kKC * 2;      // 16 KB
constexpr int kStageBytes = kRowChunkBytes + kQChunkBytes;

// Byte offset of 16-byte chunk c of row r in a 128-byte swizzled tile.
__device__ __forceinline__ uint32_t swizzled(uint32_t r, uint32_t c) {
  return r * 128u + ((c ^ (r & 7u)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: start address, leading offset 16 B (unused by this layout),
// stride 1024 B between groups of 8 rows, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (+)= A (64 x 16, queries) . B (256 x 16, rows)^T for one warpgroup;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma and its wait.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// queries (Q_pad, d) bf16 with Q_pad % 128 == 0, rows (S, d) bf16 with
// S % 2048 == 0 and d % 64 == 0, bias (S,) f32; vals / idx (Q_pad, S/256).
// Grid (Q_pad / 128, S / 2048).
__global__ void __launch_bounds__(kThreads, 1)
fused_scan_kernel(const uint16_t* __restrict__ queries,
                  const uint16_t* __restrict__ rows,
                  const float* __restrict__ bias,
                  float* __restrict__ vals, int32_t* __restrict__ idx,
                  int d, int n_groups, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte alignment (the host adds the slack).
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const int n_kc = d / kKC;
  const uint32_t r_s = base;   // kStages x (256 row + 128 query chunks)
  const int tid = threadIdx.x;
  const int q_block = blockIdx.x * kQT;
  const size_t slot_base = static_cast<size_t>(blockIdx.y) * kBS;
  const size_t row_bytes = static_cast<size_t>(d) * 2;
  const char* rsrc = reinterpret_cast<const char*>(rows);
  const char* qsrc = reinterpret_cast<const char*>(queries) +
                     static_cast<size_t>(q_block) * row_bytes;
  const int steps = kGroups * n_kc;   // (group, chunk) in order

  auto load_stage = [&](int step) {
    const int gi = step / n_kc;
    const int kc = step - gi * n_kc;
    const uint32_t dst = r_s + (step % kStages) * kStageBytes;
    const char* src = rsrc + (slot_base + gi * kSub) * row_bytes + kc * 128;
#pragma unroll
    for (int k = 0; k < kSub * 8 / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int r = i >> 3;
      const int c = i & 7;
      cp_async16(dst + swizzled(r, c), src + r * row_bytes + c * 16);
    }
    const uint32_t qdst = dst + kRowChunkBytes;
#pragma unroll
    for (int k = 0; k < kQT * 8 / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int r = i >> 3;
      const int c = i & 7;
      cp_async16(qdst + swizzled(r, c), qsrc + r * row_bytes + kc * 128 +
                                            c * 16);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }

  const int wg = tid >> 7;            // warpgroup: queries wg*64 ..
  const int warp = (tid >> 5) & 3;    // rows 16*warp .. of the warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    // Chunk `step` has landed (every group is committed, empty or not).
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    // Make this thread's cp.async writes visible to the wgmma (async)
    // proxy, then to the other threads.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // The stage refilled here was read by step - 1, finished everywhere.
    if (step + kStages - 1 < steps) load_stage(step + kStages - 1);
    cp_async_commit();

    const int gi = step / n_kc;
    const int kc = step - gi * n_kc;
    const uint32_t b0 = r_s + (step % kStages) * kStageBytes;
    const uint32_t a0 = b0 + kRowChunkBytes + wg * 64 * 128;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk)
      wgmma_m64n256k16(acc, smem_desc(a0 + kk * 32), smem_desc(b0 + kk * 32),
                       (kc | kk) != 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (kc != n_kc - 1) continue;

    // Group gi is complete.  acc[4j + 2h + e] is query row 8h + g of this
    // warp's 16, slot 8j + 2t + e of the group.
    const size_t slot0 = slot_base + gi * kSub;
    const float2* bb = reinterpret_cast<const float2*>(bias + slot0) + t;
    float best[2];
    int arg[2];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 b = __ldg(bb + 4 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // Slots rise with (j, e), and only a strictly larger value
          // replaces the best, so the first slot wins a tie.
          const float s = __fadd_rn(__fmul_rn(scale, acc[4 * j + 2 * h + e]),
                                    e ? b.y : b.x);
          const int c = 8 * j + 2 * t + e;
          if (j == 0 && e == 0) {
            best[h] = s;
            arg[h] = c;
          } else if (s > best[h]) {
            best[h] = s;
            arg[h] = c;
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[h], off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg[h], off);
        if (ov > best[h] || (ov == best[h] && oa < arg[h])) {
          best[h] = ov;
          arg[h] = oa;
        }
      }
      if (t == 0) {
        const size_t o =
            static_cast<size_t>(q_block + wg * 64 + warp * 16 + 8 * h + g) *
                n_groups +
            blockIdx.y * kGroups + gi;
        vals[o] = best[h];
        idx[o] = static_cast<int32_t>(slot0) + arg[h];
      }
    }
  }
}

}  // namespace

static int fused_scan_smem_bytes() {
  return kStages * kStageBytes + 1024;
}

extern "C" int fused_scan_groupmax(const void* queries, const void* rows,
                                   const void* bias, void* vals, void* idx,
                                   int q_pad, int s, int d, float scale,
                                   void* stream) {
  const int smem = fused_scan_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      fused_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(q_pad / kQT, s / kBS);
  fused_scan_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(queries),
      static_cast<const uint16_t*>(rows), static_cast<const float*>(bias),
      static_cast<float*>(vals), static_cast<int32_t*>(idx), d, s / kSub,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, dynamic shared memory a block, resident blocks an SM
// and local (spill) bytes a thread of the kernel (the same at every d),
// into info[0..3].
extern "C" int fused_scan_occupancy(void* info) {
  int* o = static_cast<int*>(info);
  const int smem = fused_scan_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      fused_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fused_scan_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fused_scan_kernel, kThreads, smem);
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
