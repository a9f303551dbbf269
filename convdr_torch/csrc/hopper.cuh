// Hopper (sm_90a) primitives shared by the port's kernels: mbarriers, TMA
// tensor loads and stores and their tensor maps, wgmma descriptors, issue,
// fences and waits, named barriers and programmatic dependent launch.
// Device code needs -gencode arch=compute_90a,code=sm_90a (wgmma exists
// only there).
//
// Conventions of the shared-memory operands. A tile is rows of `row_bytes`
// (16, 32 or 64 bf16: 32, 64 or 128 bytes) written by TMA with the swizzle
// of the same width (CU_TENSOR_MAP_SWIZZLE_32B / 64B / 128B), based at a
// multiple of 1024 bytes. A wgmma descriptor of such a tile gives the same
// swizzle and a stride of 8 * row_bytes between 8-row groups; one swizzle
// atom spans a whole row, so the tile reads both as K-major (rows = M or N,
// 16-element k-steps at +32 bytes inside the row) and as MN-major (rows =
// K, k-steps at +16 rows; the row is all of N, at most one atom).
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA);
// a __syncthreads() after it makes it visible to the block.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` more to land through TMA.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival on bar once every cp.async this thread issued before has
// landed (the arrival is counted in the barrier's init count: .noinc).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(shared_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(shared_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

// Waits until the phase of parity `parity` has completed. A phase still
// open after 4 s is a fault of the protocol, not a slow copy: the kernel
// traps (the launch reports an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - start > 4000000000ull) __trap();
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------
// The box of a rank-4 map at coordinates (c0, c1, c2, c3), innermost first,
// into shared memory at dst; its bytes complete a transaction on bar.
// Elements outside the tensor arrive as zeros (and count).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(shared_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(shared_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The box of a rank-2 map at (c0, c1), innermost first; as tma_load_4d.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(shared_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(shared_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The box of a rank-4 map at (c0, c1, c2, c3) from shared memory at src
// (elements outside the tensor are not written), as one bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(shared_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's committed TMA stores have completed.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Waits until this thread's committed TMA stores have read their shared
// memory (the writes to global memory may still be in flight).
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before later TMA reads of them.
__device__ __forceinline__ void fence_shared_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of the `count` threads (whole warps) that name barrier `id`.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The byte offset of 16-byte chunk `chunk` of row `row` in a tile of
// `row_bytes` rows written or read by TMA with the swizzle of that width
// (based at a multiple of 1024 bytes).
__host__ __device__ constexpr int swizzled_chunk_offset(int row, int chunk, int row_bytes) {
  return row * row_bytes + 16 * (chunk ^ ((row * row_bytes >> 7) & (row_bytes / 16 - 1)));
}

// ---------------------------------------------------------------------------
// programmatic dependent launch
// ---------------------------------------------------------------------------
// In a kernel launched with cudaLaunchAttributeProgrammaticStreamSerialization:
// waits until the grid before it on the stream has completed and its writes
// are visible (returns at once in a kernel launched without it).
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Lets the next grid on the stream (launched with the attribute) start.
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Swizzle field of a descriptor for rows of `row_bytes` (32, 64, 128).
__host__ __device__ constexpr int wgmma_swizzle(int row_bytes) {
  return row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
}

// The descriptor of a swizzled tile at shared address `addr` (see the
// conventions above): start address, both byte offsets 8 * row_bytes (the
// leading one is read only by layouts wider than one atom), swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int row_bytes) {
  const uint64_t stride = static_cast<uint64_t>(8 * row_bytes) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | stride << 16 | stride << 32 |
         static_cast<uint64_t>(wgmma_swizzle(row_bytes)) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an in-flight wgmma reads or writes: no access to
// them moves across this point (place after a wait, before an issue).
template <int N>
__device__ __forceinline__ void wgmma_fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Accumulator fragments (m64nN, f32): warp w of the warpgroup, lane (g =
// lane / 4, t = lane % 4) holds d[4j + 2r + e] = row 16w + g + 8r, column
// 8j + 2t + e. The A fragment of a k-step from registers (bf16 pairs) is
// {row g cols 2t.., row g + 8 cols 2t.., row g cols 8 + 2t.., row g + 8
// cols 8 + 2t..}: the packed accumulator pairs of two 8-column chunks.

// d (64 x 32) (+)= A (64 x 16, shared, K-major) * B (32 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 16, shared, K-major) * B (64 x 16, shared, K-major)^T:
// S of 64 queries and a 64-key tile, d[4j + 2r + e] = row 16w + g + 8r, key
// 8j + 2t + e (the fragments above); kk-th k-step at +2 * kk in both
// descriptors (32 bytes along the swizzled rows). Its columns 16kk..16kk+15
// packed as bf16 pairs, {d[8kk], d[8kk + 1]}, {d[8kk + 2], d[8kk + 3]}, ...,
// are the A fragment of k-step kk of a product with S (or P) as A.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 16) (+)= A (64 x 16, registers) * B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 32) (+)= A (64 x 16, registers) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                             int accumulate) {
  wgmma_rs_n16(d, a, desc_b, accumulate);
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                             int accumulate) {
  wgmma_rs_n32(d, a, desc_b, accumulate);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                             int accumulate) {
  wgmma_rs_n64(d, a, desc_b, accumulate);
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------
// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda; null if the driver has none.
using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                          const cuuint32_t*, CUtensorMapInterleave,
                                          CUtensorMapSwizzle, CUtensorMapL2promotion,
                                          CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<TensorMapEncodeTiled>(p)
                                                : nullptr;
  }();
  return fn;
}

// The map of a contiguous [B, T, H, D] tensor, bf16 (or f32 with `f32`),
// whose box is `rows` consecutive t of one (b, h) and at most 128 bytes
// of d: all of a bf16 row (D = 16, 32, 64), min(D, 32) floats of an f32
// one (D = 64 takes two boxes a row, at d = 0 and 32); swizzled by the
// box row's width (32, 64 or 128 bytes); rows past T arrive as zeros.
// Returns false if the driver refuses it.
inline bool encode_bthd_map(CUtensorMap* map, const void* base, int batch, int seq, int heads,
                            int head_dim, int rows, bool f32 = false) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t elem = f32 ? 4 : 2;
  const cuuint64_t row = elem * head_dim;
  const cuuint32_t box_d = f32 && head_dim > 32 ? 32 : head_dim;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};  // bytes, dims 1..3
  const cuuint32_t box[4] = {box_d, 1u, static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const cuuint64_t box_bytes = elem * box_d;
  const CUtensorMapSwizzle swizzle = box_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a row-major [rows, cols] matrix (f32 or bf16; a row pitch of
// `cols` elements, a multiple of 16 bytes) whose box is `box_rows` rows of
// 128 bytes (32 f32 or 64 bf16 columns), swizzled by 128 bytes; columns
// past `cols` arrive as zeros. Returns false if the driver refuses it.
inline bool encode_rows_map(CUtensorMap* map, const void* base, bool bf16, int cols, int rows,
                            int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t elem = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {elem * cols};  // bytes, dim 1
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1u, 1u};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
