// Hopper (sm_90a) primitives shared by the port's kernels: mbarriers, TMA
// tensor loads and stores and their tensor maps, wgmma descriptors, issue,
// fences and waits, named barriers and programmatic dependent launch.
// Device code needs -gencode arch=compute_90a,code=sm_90a (wgmma exists
// only there).
//
// Conventions of the shared-memory operands. A tile is rows of `row_bytes`
// (16, 32 or 64 bf16: 32, 64 or 128 bytes; 128 int8) written by TMA with
// the swizzle of the same width (CU_TENSOR_MAP_SWIZZLE_32B / 64B / 128B),
// based at a multiple of 1024 bytes. A wgmma descriptor of such a tile
// gives the same swizzle and a stride of 8 * row_bytes between 8-row
// groups; one swizzle atom spans a whole row, so the tile reads both as
// K-major (rows = M or N, k-steps of 32 bytes, 16 bf16 or 32 int8, at +32
// bytes inside the row) and as MN-major (rows = K, k-steps at +16 rows;
// the row is all of N, at most one atom; bf16 only: wgmma takes 8-bit
// operands K-major alone).
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

// The box of a rank-3 map at (c0, c1, c2), innermost first; as tma_load_4d.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(shared_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(shared_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
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

// An L2 policy that evicts first what it marks (data not read again soon).
__device__ __forceinline__ uint64_t l2_evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// The box of a rank-2 map at (c0, c1) from shared memory at src, written
// under the L2 policy `policy` (elements outside the tensor are not
// written), as one bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(shared_addr(src)), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's committed TMA stores have completed.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Waits until this thread's committed TMA stores, all but the N most
// recent groups, have read their shared memory (the writes to global
// memory may still be in flight).
template <int N = 0>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
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
template <int N>
__device__ __forceinline__ void wgmma_fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
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

// d (64 x N) (+)= A (64 x 16, shared, K-major) * B (N x 16, shared, K-major)^T
// with A's and B's descriptors desc_a + kOffA and desc_b + kOffB (16-byte
// units). The offsets are added inside the asm, so that a caller issuing
// many products over one tile keeps two descriptors live, not one pair of
// registers a product.
template <int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_ss_at_n8(float (&d)[4], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %6, 0;\n"
      "add.s64 da, %4, %7;\nadd.s64 db, %5, %8;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kOffA), "n"(kOffB));
}

template <int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_ss_at_n16(float (&d)[8], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %10, 0;\n"
      "add.s64 da, %8, %11;\nadd.s64 db, %9, %12;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kOffA), "n"(kOffB));
}

template <int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_ss_at_n32(float (&d)[16], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %18, 0;\n"
      "add.s64 da, %16, %19;\nadd.s64 db, %17, %20;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kOffA), "n"(kOffB));
}

template <int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_ss_at_n64(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %34, 0;\n"
      "add.s64 da, %32, %35;\nadd.s64 db, %33, %36;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kOffA), "n"(kOffB));
}

template <int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_ss_at_n128(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %66, 0;\n"
      "add.s64 da, %64, %67;\nadd.s64 db, %65, %68;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kOffA), "n"(kOffB));
}

template <int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_ss_at_n256(float (&d)[128], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %130, 0;\n"
      "add.s64 da, %128, %131;\nadd.s64 db, %129, %132;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kOffA), "n"(kOffB));
}

template <int N, int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_ss_at(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  if constexpr (N == 8)
    wgmma_ss_at_n8<kOffA, kOffB>(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 16)
    wgmma_ss_at_n16<kOffA, kOffB>(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 32)
    wgmma_ss_at_n32<kOffA, kOffB>(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 64)
    wgmma_ss_at_n64<kOffA, kOffB>(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 128)
    wgmma_ss_at_n128<kOffA, kOffB>(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 256)
    wgmma_ss_at_n256<kOffA, kOffB>(d, desc_a, desc_b, accumulate);
}


// The three-part bf16 product of f32 queries and bf16 passages, one stage
// of 64 k (a 128-byte swizzled row): q = q1 + q2 + q3 exactly (three bf16
// parts, ops/fused_search.py bf16_query_parts), so S = sum over k of
// (q1 p + q2 p + q3 p), every product exact in f32. Part p's product reads
// A at desc_a + kAOff + p kAStep and B at desc_b + p kBStep (16-byte
// units): the queries' parts as A (kAStep the part tiles' distance, kBStep
// 0) or as B (kAStep 0; kAOff picks a 64-row block of the passage tile).
// k-steps kk = 0..3 (+2 kk in both descriptors: 32 bytes along the
// swizzled rows) in order, and in each k-step parts 1, 2, 3 in turn into
// one accumulator: the one order of every bf16 score in the port (kernels
// 2, 3 and 4), so their outputs agree bit for bit (an output's bits depend
// on its A row, B row and this order only, whichever operand the queries
// are: the probe in scores_groupmax.cu). `first`: the stage is a score's
// first (the very first product overwrites the accumulator).
template <int N, int kAStep, int kBStep, int kAOff = 0>
__device__ __forceinline__ void wgmma_bf16_parts_stage(float (&d)[N / 2], uint64_t desc_a,
                                                       uint64_t desc_b, bool first) {
  const int acc = first ? 0 : 1;  // the stage's first product overwrites
  wgmma_ss_at<N, kAOff, 0>(d, desc_a, desc_b, acc);
  wgmma_ss_at<N, kAOff + kAStep, kBStep>(d, desc_a, desc_b, 1);
  wgmma_ss_at<N, kAOff + 2 * kAStep, 2 * kBStep>(d, desc_a, desc_b, 1);
  wgmma_ss_at<N, kAOff + 2, 2>(d, desc_a, desc_b, 1);
  wgmma_ss_at<N, kAOff + kAStep + 2, kBStep + 2>(d, desc_a, desc_b, 1);
  wgmma_ss_at<N, kAOff + 2 * kAStep + 2, 2 * kBStep + 2>(d, desc_a, desc_b, 1);
  wgmma_ss_at<N, kAOff + 4, 4>(d, desc_a, desc_b, 1);
  wgmma_ss_at<N, kAOff + kAStep + 4, kBStep + 4>(d, desc_a, desc_b, 1);
  wgmma_ss_at<N, kAOff + 2 * kAStep + 4, 2 * kBStep + 4>(d, desc_a, desc_b, 1);
  wgmma_ss_at<N, kAOff + 6, 6>(d, desc_a, desc_b, 1);
  wgmma_ss_at<N, kAOff + kAStep + 6, kBStep + 6>(d, desc_a, desc_b, 1);
  wgmma_ss_at<N, kAOff + 2 * kAStep + 6, 2 * kBStep + 6>(d, desc_a, desc_b, 1);
}

// The six-part bf16 product of f32 queries and f32 passages, one stage of
// 32 k (a 64-byte swizzled row of bf16 parts): q = q1 + q2 + q3 and p =
// p1 + p2 + p3 exactly (bf16_split2), and of the nine products q_i p_j,
// each exact in f32, the six above 2^-20 of |q p|: (1,1), (1,2), (2,1),
// (1,3), (2,2), (3,1), issued in that order each k-step (the counterpart
// of the MXU's Precision.HIGHEST on f32 x f32). (1,1) goes into `big`
// and the five small ones into `small`, so that the large running sum
// takes one truncating tensor-core add a k-step and not six (one
// accumulator broke the 1e-5 |q| max|p| f32 tolerance on long one-signed
// sums on an H100); the caller adds the two, rounded to nearest, at the
// end. The passages' parts are A (part j at desc_a + j kPStep, 16-byte
// units) and the queries' parts B (part i at desc_b + i kQStep); k-steps
// kk = 0, 1 at +2 kk in both. Kernels 2, 3 and 4 on f32 passages all
// issue this order into these two sums (wgmma_f32_parts_rs_kstep with A
// from registers), so their outputs agree bit for bit. `first`: the stage
// is a score's first (the first product of each sum overwrites it).
template <int N, int kQStep, int kPStep, int kK>
__device__ __forceinline__ void wgmma_f32_parts_kstep(float (&big)[N / 2], float (&small)[N / 2],
                                                      uint64_t desc_a, uint64_t desc_b, int acc) {
  wgmma_ss_at<N, kK, kK>(big, desc_a, desc_b, acc);                                // (1,1)
  wgmma_ss_at<N, kPStep + kK, kK>(small, desc_a, desc_b, acc);                     // (1,2)
  wgmma_ss_at<N, kK, kQStep + kK>(small, desc_a, desc_b, 1);                       // (2,1)
  wgmma_ss_at<N, 2 * kPStep + kK, kK>(small, desc_a, desc_b, 1);                   // (1,3)
  wgmma_ss_at<N, kPStep + kK, kQStep + kK>(small, desc_a, desc_b, 1);              // (2,2)
  wgmma_ss_at<N, kK, 2 * kQStep + kK>(small, desc_a, desc_b, 1);                   // (3,1)
}

template <int N, int kQStep, int kPStep>
__device__ __forceinline__ void wgmma_f32_parts_stage(float (&big)[N / 2], float (&small)[N / 2],
                                                      uint64_t desc_a, uint64_t desc_b,
                                                      bool first) {
  wgmma_f32_parts_kstep<N, kQStep, kPStep, 0>(big, small, desc_a, desc_b, first ? 0 : 1);
  wgmma_f32_parts_kstep<N, kQStep, kPStep, 2>(big, small, desc_a, desc_b, 1);
}

// The three bf16 parts of two f32 values a and b, each part's pair packed
// as a bf16x2 word (a in the low half): the arithmetic of
// ops/fused_search.py bf16_query_parts (cut to the top 16 bits, the exact
// remainder cut again, what is left rounded to nearest even, which is
// exact but under bf16's subnormals), so its parts bit for bit.
__device__ __forceinline__ void bf16_split2(float a, float b, uint32_t (&w)[3]) {
  const float a1 = __uint_as_float(__float_as_uint(a) & 0xffff0000u);
  const float b1 = __uint_as_float(__float_as_uint(b) & 0xffff0000u);
  const float ar = __fsub_rn(a, a1), br = __fsub_rn(b, b1);  // exact
  const float a2 = __uint_as_float(__float_as_uint(ar) & 0xffff0000u);
  const float b2 = __uint_as_float(__float_as_uint(br) & 0xffff0000u);
  w[0] = (__float_as_uint(a1) >> 16) | (__float_as_uint(b1) & 0xffff0000u);
  w[1] = (__float_as_uint(a2) >> 16) | (__float_as_uint(b2) & 0xffff0000u);
  const __nv_bfloat162 p3 = __floats2bfloat162_rn(__fsub_rn(ar, a2), __fsub_rn(br, b2));
  w[2] = *reinterpret_cast<const uint32_t*>(&p3);
}

// The three bf16 parts (bf16_split2) of floats 8c..8c+7 of a row, x then y,
// as 16-byte chunk c of row r of three part tiles (part j at parts + j
// kPart) in the swizzle of the row's width.
template <int kRowBytes, int kPart>
__device__ __forceinline__ void store_parts(unsigned char* parts, int r, int c, float4 x,
                                            float4 y) {
  uint32_t w[4][3];
  bf16_split2(x.x, x.y, w[0]);
  bf16_split2(x.z, x.w, w[1]);
  bf16_split2(y.x, y.y, w[2]);
  bf16_split2(y.z, y.w, w[3]);
  const int at = swizzled_chunk_offset(r, c, kRowBytes);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    *reinterpret_cast<uint4*>(parts + j * kPart + at) =
        make_uint4(w[0][j], w[1][j], w[2][j], w[3][j]);
}

// Splits 16-byte chunk c (4 k) of row `box_row` of an f32 box of 128-byte
// rows (32 f32, laid out by TMA's 128-byte swizzle) into row `row` of
// three bf16 part tiles of 64-byte rows (the 64-byte swizzle's layout,
// part j at parts + j kPartBytes): the passages' parts of a six-part stage.
template <int kPartBytes>
__device__ __forceinline__ void split_f32_chunk(const unsigned char* box, int box_row,
                                                unsigned char* parts, int row, int c) {
  const float4 v =
      *reinterpret_cast<const float4*>(box + swizzled_chunk_offset(box_row, c, 128));
  uint32_t lo[3], hi[3];
  bf16_split2(v.x, v.y, lo);
  bf16_split2(v.z, v.w, hi);
  const int at = swizzled_chunk_offset(row, c >> 1, 64) + 8 * (c & 1);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    *reinterpret_cast<uint2*>(parts + j * kPartBytes + at) = make_uint2(lo[j], hi[j]);
}

// d (64 x N) (+)= A (64 x 16, registers: the fragment above) * B (N x 16,
// shared, K-major)^T, B's descriptor at desc_b + kOffB (16-byte units);
// with kTransB, B (16 x N, shared, MN-major: rows are k, 16 rows a
// k-step). The registers of `a` are read after the issue: the caller keeps
// them unchanged until the product has landed (wgmma_wait).
template <int kOffB, int kTransB = 0>
__device__ __forceinline__ void wgmma_rs_kb_n8(float (&d)[4], const uint32_t (&a)[4],
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %9, 0;\nadd.s64 db, %8, %10;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, db, p, 1, 1, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(kOffB), "n"(kTransB));
}

template <int kOffB, int kTransB = 0>
__device__ __forceinline__ void wgmma_rs_kb_n16(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %13, 0;\nadd.s64 db, %12, %14;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, db, p, 1, 1, %15;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(kOffB), "n"(kTransB));
}

template <int kOffB, int kTransB = 0>
__device__ __forceinline__ void wgmma_rs_kb_n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %21, 0;\nadd.s64 db, %20, %22;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, db, p, 1, 1, %23;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(kOffB), "n"(kTransB));
}

template <int kOffB, int kTransB = 0>
__device__ __forceinline__ void wgmma_rs_kb_n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %37, 0;\nadd.s64 db, %36, %38;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, %39;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(kOffB), "n"(kTransB));
}

template <int N, int kOffB, int kTransB = 0>
__device__ __forceinline__ void wgmma_rs_kb_at(float (&d)[N / 2], const uint32_t (&a)[4],
                                               uint64_t desc_b, int accumulate) {
  if constexpr (N == 8)
    wgmma_rs_kb_n8<kOffB, kTransB>(d, a, desc_b, accumulate);
  else if constexpr (N == 16)
    wgmma_rs_kb_n16<kOffB, kTransB>(d, a, desc_b, accumulate);
  else if constexpr (N == 32)
    wgmma_rs_kb_n32<kOffB, kTransB>(d, a, desc_b, accumulate);
  else if constexpr (N == 64)
    wgmma_rs_kb_n64<kOffB, kTransB>(d, a, desc_b, accumulate);
}

// One k-step of the six-part product with the passages' parts as A from
// registers (pa[j]: part j's fragment) and the queries' parts as B
// (K-major, part i at desc_b + i kQStep, the k-step at + kK): the
// products, order and sums of wgmma_f32_parts_kstep.
template <int N, int kQStep, int kK>
__device__ __forceinline__ void wgmma_f32_parts_rs_kstep(float (&big)[N / 2],
                                                         float (&small)[N / 2],
                                                         const uint32_t (&pa)[3][4],
                                                         uint64_t desc_b, int acc) {
  wgmma_rs_kb_at<N, kK>(big, pa[0], desc_b, acc);                 // (1,1)
  wgmma_rs_kb_at<N, kK>(small, pa[1], desc_b, acc);               // (1,2)
  wgmma_rs_kb_at<N, kK + kQStep>(small, pa[0], desc_b, 1);        // (2,1)
  wgmma_rs_kb_at<N, kK>(small, pa[2], desc_b, 1);                 // (1,3)
  wgmma_rs_kb_at<N, kK + kQStep>(small, pa[1], desc_b, 1);        // (2,2)
  wgmma_rs_kb_at<N, kK + 2 * kQStep>(small, pa[0], desc_b, 1);    // (3,1)
}

// This thread's f32 values of the register A fragment of k-step kk (16 k
// at 16 kk) of rows r and r + 8 of an f32 box of 128-byte rows (32 f32,
// TMA's 128-byte swizzle): v[i] holds fragment register i's pair (lane t
// = lane % 4: rows r, r + 8, r, r + 8 at k 2t, 2t, 2t + 8, 2t + 8).
__device__ __forceinline__ void load_f32_fragment(const unsigned char* box, int r, int kk, int t,
                                                  float2 (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = *reinterpret_cast<const float2*>(
        box + swizzled_chunk_offset(r + 8 * (i & 1), 4 * kk + 2 * (i >> 1) + (t >> 1), 128) +
        8 * (t & 1));
}

// The three bf16 parts of a fragment's f32 values (bf16_split2): pa[j][i]
// is part j of register i's pair.
__device__ __forceinline__ void split_f32_fragment(const float2 (&v)[4], uint32_t (&pa)[3][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t w[3];
    bf16_split2(v[i].x, v[i].y, w);
#pragma unroll
    for (int j = 0; j < 3; ++j) pa[j][i] = w[j];
  }
}

// Pins a fragment's registers (as wgmma_fence_regs): a register A read by
// an in-flight product keeps its value until this point.
__device__ __forceinline__ void pin_fragment(uint32_t (&pa)[3][4]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[j][i])::"memory");
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

// d (64 x 256, s32) (+)= A (64 x 32, s8, shared, K-major) * B (256 x 32,
// s8, shared, K-major)^T. 8-bit operands are K-major only: a tile of
// 128-byte rows is read with wgmma_desc(addr, 128), k-step kk (32 int8) at
// +2 * kk in both descriptors; d's fragments are the f32 ones above, as s32
// (integer sums: exact in any order).
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
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

// The map of a row-major [rows, cols] matrix of `elem_bytes` elements (1
// int8, copied as bytes; 2 bf16; 4 f32; a row pitch of `cols` elements, a
// multiple of 16 bytes) whose box is `box_rows` rows of 128 bytes (128
// int8, 64 bf16 or 32 f32 columns), swizzled by 128 bytes; elements past
// `cols` or `rows` arrive as zeros (a store writes none of them). Returns
// false if the driver refuses it.
inline bool encode_rows_map(CUtensorMap* map, const void* base, int elem_bytes, int cols,
                            int rows, int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t elem = static_cast<cuuint64_t>(elem_bytes);
  const CUtensorMapDataType type = elem_bytes == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {elem * cols};  // bytes, dim 1
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1u, 1u};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The map of a contiguous [parts, rows, cols] bf16 tensor (a row pitch of
// `cols` elements, a multiple of 8) whose box is `box_rows` rows of one
// part and `box_cols` columns (64: 128 bytes, swizzled by 128 bytes; 32:
// 64 bytes, swizzled by 64); rows past `rows` and columns past `cols`
// arrive as zeros. Returns false if the driver refuses it.
inline bool encode_parts_map(CUtensorMap* map, const void* base, int parts, int cols, int rows,
                             int box_rows, int box_cols = 64) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(parts)};
  const cuuint64_t strides[2] = {2ull * cols, 2ull * cols * rows};  // bytes, dims 1..2
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace
