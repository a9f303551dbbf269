// Pieces shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu): the log2-domain exponential,
// cp.async copies, a bf16 pair's rounding and the per-block tile plan over
// segment ranges.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// The segment of the rows past T in a tile's id buffer: no live row has it
// (the ids are the 0/1 attention mask).
constexpr int kNoSegment = INT_MIN;

// 2^x, MUFU.EX2 with subnormal results flushed to 0 (x <= 0 here: a
// probability below 2^-126 is 0 at every tolerance the kernels keep).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with pred false nothing is read and the
// 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// the tile plan
// ---------------------------------------------------------------------------
// Writes the indices of the tiles of kKeys rows that some live row of
// [q0, q0 + kRows) may pair with, in order, to plan[0, n), and n to
// plan[nt]; returns n. A tile row can share a row's segment only if that
// segment lies in the tile's range. Segment equality is symmetric, so the
// block's rows may be queries (tiles of keys) or keys (tiles of queries).
// Called by every thread of the block.
template <int kRows, int kKeys, int kThreads>
__device__ int plan_tiles(const int* __restrict__ segb, int seq, int q0,
                          int* plan) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kPerLane = (kRows + 31) / 32;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nt = (seq + kKeys - 1) / kKeys;

  int qseg[kPerLane];
  bool qlive[kPerLane];
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int r = lane + 32 * m;
    qlive[m] = r < kRows && q0 + r < seq;
    qseg[m] = qlive[m] ? segb[q0 + r] : 0;
  }
  for (int t = warp; t < nt; t += kWarps) {
    int lo = INT_MAX;
    int hi = INT_MIN;
#pragma unroll
    for (int c = lane; c < kKeys; c += 32) {
      const int key = t * kKeys + c;
      if (key < seq) {
        const int s = segb[key];
        lo = min(lo, s);
        hi = max(hi, s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    bool need = false;
#pragma unroll
    for (int m = 0; m < kPerLane; ++m)
      need |= qlive[m] && qseg[m] >= lo && qseg[m] <= hi;
    need = __any_sync(0xffffffffu, need);
    if (lane == 0) plan[t] = need;
  }
  __syncthreads();
  if (warp == 0) {  // compact in place: entry t moves to a slot <= t
    int n = 0;
    for (int base = 0; base < nt; base += 32) {
      const int t = base + lane;
      const bool keep = t < nt && plan[t] != 0;
      const unsigned kept = __ballot_sync(0xffffffffu, keep);
      __syncwarp();  // every lane has read its entry of this chunk
      if (keep) plan[n + __popc(kept & ((1u << lane) - 1u))] = t;
      n += __popc(kept);
      __syncwarp();
    }
    if (lane == 0) plan[nt] = n;
  }
  __syncthreads();
  return plan[nt];
}

__host__ __device__ constexpr int plan_bytes(int seq, int keys) {
  return 4 * ((seq + keys - 1) / keys + 1);
}

}  // namespace
