// Pass B of the streaming exact search, for Hopper (sm_90a): the scores of
// the selected passage groups only.
//
// Replaces: convdr_tpu/ops/pallas_search.py:462-522,
// `extract_candidate_scores` (kernel `_extract_candidates_kernel` at
// :419-455). Pass A is convdr_streaming_groupmax in scores_groupmax.cu.
//
// Computes cand[s, r] = <q[s / kg], p[g * G + r]> for every slot
// s = query * kg + j of gsel [Q, kg] (g = gsel[query, j]) and r < G: the
// [Q, kg, G] scores of the groups each query selected, and nothing else.
// The TPU kernel recomputes whole passage tiles for every query tile and
// scatters the selected groups through a one-hot matmul; here only the
// selected rows are scored, and each of them is read once: the wrapper
// sorts the slots by group (`slots`, with `starts[g]..starts[g+1]` the
// slots of group g), one block owns one group, and it walks that group's
// slots in tiles of up to 128, so a group's G rows come from device memory
// once whatever the number of queries that picked it (a tile after the
// first finds them in L2). Groups no query picked cost one empty block.
//
// Exactness: each score is one sequential fmaf(q, p, acc) chain over
// k = 0..D-1 from 0, zero padding only after the last k, which is the order
// of every f32 and bf16 output of kernel 2 (scores_groupmax.cu); with int8
// passages every partial sum is an exact integer below 2^24, so the chain
// equals kernel 2's tensor-core integer sums. So each candidate score is
// bit-identical to kernel 2's score of that (query, row), and pass A's
// group maxima are exactly the maxima of these scores: group pruning stays
// exact. Passages are f32, bf16 or int8 (upcast as loaded).
//
// What bounds it on an H100: 2 * Q * kg * G * D operations (10.2 GFLOP at
// Q=512, kg=101, G=128, D=768: ~0.15 ms at 67 TFLOP/s f32) against the
// bytes of the selected rows read once plus the [Q, kg, G] output (up to
// N * D * 4 bytes: ~0.48 ms when every group is picked). The inner loop
// does one shared load of the passage value and up to 16 of query values
// per 16 FMAs, so it runs well below the FMA peak; this first version is
// right and simple, not tuned.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileK = 32;     // depth per shared-memory stage
constexpr int kMaxSlots = 128; // slots per tile
constexpr int kPerThread = 16; // accumulators per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(signed char x) {
  return static_cast<float>(x);
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
extract_candidates_kernel(const float* __restrict__ q,
                          const P* __restrict__ p,
                          const int* __restrict__ slots,
                          const int* __restrict__ starts,
                          float* __restrict__ cand, int d, int kg,
                          int group) {
  // [k][row] and [k][slot]; the +1 spreads the transposing stores over
  // the banks.
  __shared__ float ps[kTileK][128 + 1];
  __shared__ float qs[kTileK][kMaxSlots + 1];

  const int g = blockIdx.x;
  const int s0 = starts[g];
  const int s1 = starts[g + 1];
  if (s0 == s1) return;

  const int tid = threadIdx.x;
  const int stride = kThreads / group;        // slots sharing a row index
  const int tile = min(kPerThread * stride, kMaxSlots);
  const int per_thread = tile / stride;       // <= kPerThread
  const int r = tid % group;                  // this thread's row in group
  const int m0 = tid / group;                 // its first slot in the tile
  const long long row0 = static_cast<long long>(g) * group;

  for (int t0 = s0; t0 < s1; t0 += tile) {
    const int cnt = min(tile, s1 - t0);
    float acc[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kTileK) {
      for (int i = tid; i < group * kTileK; i += kThreads) {
        const int rr = i / kTileK;
        const int c = i % kTileK;
        const int gc = k0 + c;
        ps[c][rr] = gc < d ? to_float(p[(row0 + rr) * d + gc]) : 0.f;
      }
      for (int i = tid; i < tile * kTileK; i += kThreads) {
        const int mm = i / kTileK;
        const int c = i % kTileK;
        const int gc = k0 + c;
        float v = 0.f;
        if (mm < cnt && gc < d)
          v = q[static_cast<long long>(slots[t0 + mm] / kg) * d + gc];
        qs[c][mm] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kTileK; ++kk) {
        const float b = ps[kk][r];
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
          if (i < per_thread) acc[i] = fmaf(qs[kk][m0 + stride * i], b, acc[i]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int m = m0 + stride * i;
      if (i < per_thread && m < cnt)
        cand[static_cast<long long>(slots[t0 + m]) * group + r] = acc[i];
    }
  }
}

}  // namespace

// q f32 [Q, D]; p [n_groups * group, D] (p_dtype 0 = float32, 1 = bfloat16,
// 2 = int8); slots int32 [Q * kg], the slot ids s = query * kg + j sorted
// by their group; starts int32 [n_groups + 1], the first sorted slot of each
// group; cand f32 [Q, kg, group]. group in {8, 16, 32, 64, 128}.
// Returns a cudaError_t (0 = launched).
extern "C" int convdr_extract_candidates(const void* q, const void* p,
                                         const void* slots, const void* starts,
                                         void* cand, int n_groups, int d,
                                         int kg, int group, int p_dtype,
                                         void* stream) {
  if (n_groups <= 0 || d <= 0 || kg <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (group != 8 && group != 16 && group != 32 && group != 64 && group != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const int* sl = static_cast<const int*>(slots);
  const int* st = static_cast<const int*>(starts);
  float* out = static_cast<float*>(cand);
  if (p_dtype == 0) {
    extract_candidates_kernel<float><<<n_groups, kThreads, 0, s>>>(
        qf, static_cast<const float*>(p), sl, st, out, d, kg, group);
  } else if (p_dtype == 1) {
    extract_candidates_kernel<__nv_bfloat16><<<n_groups, kThreads, 0, s>>>(
        qf, static_cast<const __nv_bfloat16*>(p), sl, st, out, d, kg, group);
  } else if (p_dtype == 2) {
    extract_candidates_kernel<signed char><<<n_groups, kThreads, 0, s>>>(
        qf, static_cast<const signed char*>(p), sl, st, out, d, kg, group);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
