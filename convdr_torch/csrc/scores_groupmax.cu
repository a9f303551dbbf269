// Inner-product scores with a fused group-max epilogue, for Hopper (sm_90a).
//
// Replaces: convdr_tpu/ops/pallas_search.py:118-179, `fused_scores_groupmax`
// (kernel `_score_groupmax_kernel` at :93-112), the score stage of the exact
// FlatIP search. The JAX package's default XLA path computes the same
// function (ops/exact_search.py `_chunked_topk`: matmul, then per-group max).
//
// Computes S = Q P^T in f32 ([Q, N]) and the maximum of every run of G
// consecutive columns ([Q, N/G]). Q is f32 [Q, D]; P is f32 or bf16 [N, D]
// (bf16 is upcast to f32 as it is loaded). Products and sums are plain f32
// FMAs on the CUDA cores: no TF32 tensor-core path, because the exact-search
// contract (scores the f32 oracle would give, ops/exact_search.py) does not
// survive TF32's 10-bit mantissa.
//
// What bounds it on an H100: 2*Q*N*D operations at the 67 TFLOP/s f32
// (non-tensor) peak; at Q=512, N=524288, D=768 that is 412 GFLOP, ~6.2 ms,
// against ~0.8 ms for the bytes (P read once, S written once). So it is
// bound by operations, and the design keeps the FMA units fed: 64x128 output
// tiles, 128 threads each holding an 8x8 register tile, a K-loop over D in
// steps of 32 through shared memory, four 16-byte shared loads per 64 FMAs.
// The epilogue writes the score tile (16-byte stores, coalesced by row) and
// reduces each group of G columns (G/8 neighbouring threads hold it) with
// warp shuffles, so the scores are never read back for the group maxima.
// N must be a multiple of 128 (the caller pads rows); Q and D are any size.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTileM = 64;   // queries per block
constexpr int kTileN = 128;  // passage rows per block
constexpr int kTileK = 32;   // depth per shared-memory stage
constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
scores_groupmax_kernel(const float* __restrict__ q, const P* __restrict__ p,
                       float* __restrict__ scores, float* __restrict__ gmax,
                       int nq, int n, int d, int group) {
  // Tiles are stored transposed ([k][row]) so a thread reads its 8 rows of
  // one k as two float4; the +4 keeps rows 16-byte aligned.
  __shared__ __align__(16) float as[kTileK][kTileM + 4];
  __shared__ __align__(16) float bs[kTileK][kTileN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx*8 .. tx*8+7
  const int ty = tid / 16;  // row group: rows ty*8 .. ty*8+7
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kTileK) {
    for (int i = tid; i < kTileM * kTileK; i += kThreads) {
      const int r = i / kTileK;
      const int c = i % kTileK;
      const int gr = m0 + r;
      const int gc = k0 + c;
      as[c][r] = (gr < nq && gc < d)
                     ? q[static_cast<long long>(gr) * d + gc]
                     : 0.f;
    }
    for (int i = tid; i < kTileN * kTileK; i += kThreads) {
      const int r = i / kTileK;
      const int c = i % kTileK;
      const int gc = k0 + c;
      bs[c][r] = gc < d
                     ? to_float(p[static_cast<long long>(n0 + r) * d + gc])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][tx * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue. Lanes 16*h + tx of a warp share one row group, so the
  // G/8 threads of a column group are neighbouring lanes: xor-shuffles over
  // offsets below G/8 stay inside the group.
  const int lanes = group / 8;
  const int groups_per_row = n / group;
  const int col = n0 + tx * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    float mx = acc[i][0];
#pragma unroll
    for (int j = 1; j < 8; ++j) mx = fmaxf(mx, acc[i][j]);
    for (int off = 1; off < lanes; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (row < nq) {
      float4* sp = reinterpret_cast<float4*>(
          scores + static_cast<long long>(row) * n + col);
      sp[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      sp[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      if (tx % lanes == 0)
        gmax[static_cast<long long>(row) * groups_per_row + col / group] = mx;
    }
  }
}

}  // namespace

// p_dtype: 0 = float32, 1 = bfloat16. group in {8, 16, 32, 64, 128};
// n % 128 == 0. Returns a cudaError_t (0 = launched).
extern "C" int convdr_scores_groupmax(const void* q, const void* p,
                                      void* scores, void* gmax, int nq, int n,
                                      int d, int group, int p_dtype,
                                      void* stream) {
  if (nq <= 0 || n <= 0 || d <= 0 || n % kTileN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (group != 8 && group != 16 && group != 32 && group != 64 && group != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / kTileN, (nq + kTileM - 1) / kTileM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0) {
    scores_groupmax_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(p),
        static_cast<float*>(scores), static_cast<float*>(gmax), nq, n, d,
        group);
  } else if (p_dtype == 1) {
    scores_groupmax_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(p),
        static_cast<float*>(scores), static_cast<float*>(gmax), nq, n, d,
        group);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
