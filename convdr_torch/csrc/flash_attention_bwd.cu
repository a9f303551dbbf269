// Flash attention backward with segment-id masking, f32, for Hopper (sm_90a).
//
// Replaces: the custom VJP behind convdr_tpu/models/attention.py:54,
// `flash_attention`, i.e. `_flash_attention_bwd` of
// jax.experimental.pallas.ops.tpu.flash_attention (jax 0.9.0), whose two
// Pallas TPU kernels are `_flash_attention_bwd_dkv` (pallas_call :1121) and
// `_flash_attention_bwd_dq` (pallas_call :1456). As there, D = rowsum(dO * O)
// is computed outside the kernels (one torch reduction in the wrapper).
//
// Computes, for S = scale * Q K^T under the forward's mask (query t sees key
// s iff seg[b, t] == seg[b, s]; keys past T masked) and the forward's
// per-row log-sum-exp `lse`:
//   P  = exp(S - lse),  dP = dO V^T,  dS = P * (dP - D)
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K
// The FlashAttention-2 split, two kernels, no atomics (deterministic):
// * dkdv: one block per (32-key tile, head, batch row), looping over query
//   tiles; dK and dV of its keys accumulate in registers.
// * dq: one block per (32-query tile, head, batch row), looping over key
//   tiles; dQ of its queries accumulates in registers.
// Layouts are the forward's: q/k/v/o/dO/dQ/dK/dV [B, T, H, D] contiguous and
// 16-byte aligned, seg [B, T] int32, lse and D [B, H, T] f32.
//
// What bounds it on an H100: about 10 * D operations per allowed (query,
// key) pair (S and dP recomputed, three products accumulated) against the
// bytes of eight [B, T, H, D] tensors; at the student's shape (B = 4,
// T = 256, H = 12, D = 64) the operations bound it, in f32 on the CUDA cores
// (67 TFLOP/s): training keeps full f32 products, no TF32.
//
// Design: four threads share one row (the block's key, or query), each
// holding D/4 of its dimensions, interleaved in 16-byte chunks so that a
// quad's reads of one streamed row hit four consecutive chunks (one
// shared-memory wavefront, broadcast across the warp's eight rows). Row dot
// products are summed across the quad with two shuffles. The streamed tile
// (32 rows of two operands) sits in shared memory; a tile no row of the
// block can see is neither loaded nor processed. f32 FMA throughout.
// Tensor cores (wgmma), TMA and pipelined tile loads are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSplit = 4;                 // threads per row
constexpr int kRows = 32;                 // rows a block owns
constexpr int kThreads = kRows * kSplit;  // 128
constexpr int kTile = 32;                 // rows of the streamed tile

__device__ __forceinline__ float quad_sum(float x, unsigned mask) {
  x += __shfl_xor_sync(mask, x, 1);
  x += __shfl_xor_sync(mask, x, 2);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

// Loads rows r0 .. r0 + kTile - 1 (zero past seq) of two [B, T, H, D]
// operands into shared tiles, 16 bytes per load.
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          float (*as)[D], float (*bs)[D],
                                          long long base, long long tok,
                                          int r0, int seq) {
  constexpr int kVecPerRow = D / 4;
  for (int i = threadIdx.x; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = x;
    if (r0 + r < seq) {
      const long long off = base + (r0 + r) * tok + c;
      x = *reinterpret_cast<const float4*>(a + off);
      y = *reinterpret_cast<const float4*>(b + off);
    }
    *reinterpret_cast<float4*>(&as[r][c]) = x;
    *reinterpret_cast<float4*>(&bs[r][c]) = y;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ di,
                      const int* __restrict__ seg, float* __restrict__ dk,
                      float* __restrict__ dv, int seq, int heads, float scale) {
  constexpr int kChunks = D / (4 * kSplit);  // float4 chunks per thread
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float lses[kTile];
  __shared__ float dis[kTile];
  __shared__ int segq[kTile];

  const int tid = threadIdx.x;
  const int part = tid % kSplit;
  const unsigned lane = tid % 32;
  const unsigned quad = 0xFu << (lane & ~3u);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key = blockIdx.x * kRows + tid / kSplit;
  const bool live = key < seq;
  const long long tok = static_cast<long long>(heads) * D;
  const long long base = static_cast<long long>(b) * seq * tok +
                         static_cast<long long>(h) * D;
  const int* segb = seg + static_cast<long long>(b) * seq;
  const long long row_stats = (static_cast<long long>(b) * heads + h) * seq;

  // chunk j of this thread covers dims 4 * (part + kSplit * j) .. + 3
  float4 kr[kChunks], vr[kChunks], dkr[kChunks], dvr[kChunks];
  const int segk = live ? segb[key] : 0;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = 4 * (part + kSplit * j);
    kr[j] = vr[j] = dkr[j] = dvr[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      kr[j] = *reinterpret_cast<const float4*>(k + base + key * tok + c);
      vr[j] = *reinterpret_cast<const float4*>(v + base + key * tok + c);
    }
  }

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    if (tid < kTile) {
      const int qi = q0 + tid;
      const bool in = qi < seq;
      segq[tid] = in ? segb[qi] : 0;
      lses[tid] = in ? lse[row_stats + qi] : 0.f;
      dis[tid] = in ? di[row_stats + qi] : 0.f;
    }
    __syncthreads();
    bool any = false;
#pragma unroll 8
    for (int i = 0; i < kTile; ++i)
      any |= live && (q0 + i < seq) && (segq[i] == segk);
    if (!__syncthreads_or(any)) continue;
    load_tile<D>(q, dout, qs, dos, base, tok, q0, seq);
    __syncthreads();
    if (!any) continue;  // the whole quad shares this row, so skips together

#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      float4 qc[kChunks], dc[kChunks];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int c = 4 * (part + kSplit * j);
        qc[j] = *reinterpret_cast<const float4*>(&qs[i][c]);
        dc[j] = *reinterpret_cast<const float4*>(&dos[i][c]);
        s += dot4(qc[j], kr[j]);
        dp += dot4(dc[j], vr[j]);
      }
      s = quad_sum(s, quad);
      dp = quad_sum(dp, quad);
      const bool allowed = (q0 + i < seq) && (segq[i] == segk);
      const float p = allowed ? expf(s * scale - lses[i]) : 0.f;
      const float ds = p * (dp - dis[i]);
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        fma4(dvr[j], p, dc[j]);
        fma4(dkr[j], ds, qc[j]);
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = 4 * (part + kSplit * j);
    const float4 g = make_float4(dkr[j].x * scale, dkr[j].y * scale,
                                 dkr[j].z * scale, dkr[j].w * scale);
    *reinterpret_cast<float4*>(dk + base + key * tok + c) = g;
    *reinterpret_cast<float4*>(dv + base + key * tok + c) = dvr[j];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int* __restrict__ seg, float* __restrict__ dq, int seq,
                    int heads, float scale) {
  constexpr int kChunks = D / (4 * kSplit);
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];
  __shared__ int segk[kTile];

  const int tid = threadIdx.x;
  const int part = tid % kSplit;
  const unsigned lane = tid % 32;
  const unsigned quad = 0xFu << (lane & ~3u);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kRows + tid / kSplit;
  const bool live = row < seq;
  const long long tok = static_cast<long long>(heads) * D;
  const long long base = static_cast<long long>(b) * seq * tok +
                         static_cast<long long>(h) * D;
  const int* segb = seg + static_cast<long long>(b) * seq;
  const long long row_stats = (static_cast<long long>(b) * heads + h) * seq;

  float4 qr[kChunks], dor[kChunks], dqr[kChunks];
  int segq = 0;
  float lse_r = 0.f, di_r = 0.f;
  if (live) {
    segq = segb[row];
    lse_r = lse[row_stats + row];
    di_r = di[row_stats + row];
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = 4 * (part + kSplit * j);
    qr[j] = dor[j] = dqr[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      qr[j] = *reinterpret_cast<const float4*>(q + base + row * tok + c);
      dor[j] = *reinterpret_cast<const float4*>(dout + base + row * tok + c);
    }
  }

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    if (tid < kTile) segk[tid] = k0 + tid < seq ? segb[k0 + tid] : 0;
    __syncthreads();
    bool any = false;
#pragma unroll 8
    for (int j = 0; j < kTile; ++j)
      any |= live && (k0 + j < seq) && (segk[j] == segq);
    if (!__syncthreads_or(any)) continue;
    load_tile<D>(k, v, ks, vs, base, tok, k0, seq);
    __syncthreads();
    if (!any) continue;  // the whole quad shares this row, so skips together

#pragma unroll 2
    for (int jk = 0; jk < kTile; ++jk) {
      float4 kc[kChunks];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int c = 4 * (part + kSplit * j);
        kc[j] = *reinterpret_cast<const float4*>(&ks[jk][c]);
        s += dot4(qr[j], kc[j]);
        dp += dot4(dor[j], *reinterpret_cast<const float4*>(&vs[jk][c]));
      }
      s = quad_sum(s, quad);
      dp = quad_sum(dp, quad);
      const bool allowed = (k0 + jk < seq) && (segk[jk] == segq);
      const float p = allowed ? expf(s * scale - lse_r) : 0.f;
      const float ds = p * (dp - di_r);
#pragma unroll
      for (int j = 0; j < kChunks; ++j) fma4(dqr[j], ds, kc[j]);
    }
  }

  if (!live) return;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = 4 * (part + kSplit * j);
    const float4 g = make_float4(dqr[j].x * scale, dqr[j].y * scale,
                                 dqr[j].z * scale, dqr[j].w * scale);
    *reinterpret_cast<float4*>(dq + base + row * tok + c) = g;
  }
}

bool bad_shape(int batch, int seq, int heads) {
  return batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 ||
         heads > 65535;
}

}  // namespace

// head_dim 16, 32 or 64; f32 only. Each returns a cudaError_t (0 = launched).
extern "C" int convdr_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* seg, void* dk, void* dv,
    int batch, int seq, int heads, int head_dim, float scale, void* stream) {
  if (bad_shape(batch, seq, heads)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONVDR_DKDV(D)                                                        \
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, 0, s>>>(                         \
      static_cast<const float*>(q), static_cast<const float*>(k),             \
      static_cast<const float*>(v), static_cast<const float*>(dout),          \
      static_cast<const float*>(lse), static_cast<const float*>(di),          \
      static_cast<const int*>(seg), static_cast<float*>(dk),                  \
      static_cast<float*>(dv), seq, heads, scale)
  switch (head_dim) {
    case 16: CONVDR_DKDV(16); break;
    case 32: CONVDR_DKDV(32); break;
    case 64: CONVDR_DKDV(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CONVDR_DKDV
  return static_cast<int>(cudaGetLastError());
}

extern "C" int convdr_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* seg, void* dq, int batch,
    int seq, int heads, int head_dim, float scale, void* stream) {
  if (bad_shape(batch, seq, heads)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONVDR_DQ(D)                                                          \
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, s>>>(                           \
      static_cast<const float*>(q), static_cast<const float*>(k),             \
      static_cast<const float*>(v), static_cast<const float*>(dout),          \
      static_cast<const float*>(lse), static_cast<const float*>(di),          \
      static_cast<const int*>(seg), static_cast<float*>(dq), seq, heads,      \
      scale)
  switch (head_dim) {
    case 16: CONVDR_DQ(16); break;
    case 32: CONVDR_DQ(32); break;
    case 64: CONVDR_DQ(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CONVDR_DQ
  return static_cast<int>(cudaGetLastError());
}
