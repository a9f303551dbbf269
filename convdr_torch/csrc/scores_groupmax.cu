// Inner-product scores with a fused group-max epilogue, for Hopper (sm_90a).
//
// Replaces: convdr_tpu/ops/pallas_search.py:118-179, `fused_scores_groupmax`
// (kernel `_score_groupmax_kernel` at :93-112), the score stage of the exact
// FlatIP search. The JAX package's default XLA path computes the same
// function (ops/exact_search.py `_chunked_topk`: matmul, then per-group max).
// The same source also holds pass A of the streaming search
// (convdr_streaming_groupmax; replaces pallas_search.py:366-416,
// `streaming_groupmax`, kernel `_groupmax_only_kernel` at :352): the same
// kernels with the score store compiled out, so only the [Q, N/G] maxima
// reach device memory and they are bit-identical to kernel 2's.
//
// Computes S = Q P^T ([Q, N] f32) and the maximum of every run of G
// consecutive columns ([Q, N/G]). P is f32, bf16 or int8 [N, D]. Two paths:
//
// f32 and bf16 passages: f32 FMAs on the CUDA cores. What bounds them on an
// H100 is operations: 2*Q*N*D at the 67 TFLOP/s f32 peak (412 GFLOP, ~6.2 ms
// at Q=512, N=524288, D=768) against ~0.8 ms for the bytes. TF32 or 3xTF32
// tensor-core products are ruled out, and so is any split-K, tree or warp
// reduction: every score is ONE sequential fmaf(q[k], p[k], acc) chain over
// k = 0..D-1 from 0, zero padding only after the last k. That order is what
// makes kernel 2's scores, pass A's maxima and pass B's candidate scores
// (streaming_search.cu) bit-identical, on which exact group pruning rests.
// The design keeps the FMA units fed within that order:
//   * a 128x128 block tile (64x128 when Q <= 64), 256 (128) threads, each
//     holding an 8x8 register tile that walks k in order for every output.
//     The tile's 64 accumulators and the 64 operand registers of 4 k leave
//     no room for loads in flight at the 128 registers that two blocks an
//     SM allow (ptxas spills there), so the kernel takes up to 255
//     registers and one block (8 warps) an SM, with the k loop of a stage
//     unrolled: faster on the card than two blocks of 128 registers
//     (chip_smoke.py prints ptxas's report and the launch configuration);
//   * a ring of 3 shared-memory stages of 32 k, filled by 16-byte
//     cp.async.cg copies (rows past Q and k past D zero-filled by the
//     src-size-0 form), so stages k+1 and k+2 load while stage k computes;
//   * tiles stay k-contiguous as copied (cp.async cannot transpose); row
//     pitches of 36 floats (f32) and 40 bf16 put the 4 query rows and 8
//     passage rows a warp reads at once in distinct banks, and a thread's
//     rows are strided (row = i * BM/8 + ty, col = j * 16 + tx) so they are
//     neighbours across the warp. Per 4 k a thread issues 16 LDS.128 (8 for
//     the query rows, 8 for the passage rows; LDS.64 + widening for bf16)
//     for 256 FMAs, with no integer division in the loop;
//   * the grid walks query tiles fastest, so the Q/BM blocks that share a
//     passage tile run together and read it from device memory once.
//
// int8 passages (SQ8 storage, ops/quant.py): the wrapper turns the
// int-valued f32 queries into int8 (exact in [-127, 127]), and the product
// runs on the int8 tensor cores: mma.sync m16n8k32 s8 x s8 -> s32, fragments
// by ldmatrix from the same cp.async ring (128 k a stage, row pitch 144
// bytes, conflict-free for ldmatrix). The sums are integers, so any order
// gives the same result, and the s32 -> f32 conversion is exact because
// |sum| <= 1040 * 127^2 < 2^24: the scores equal the plain version and the
// integer oracle bit for bit. The bound there is bytes (the int8 block plus
// the [Q, N] f32 score store), ~0.44 ms at the shape above.
//
// Epilogue (both paths): the accumulator tile goes through shared memory
// (pitch BN + 8 floats, conflict-free), then each warp takes whole rows:
// 16-byte score stores, 512 contiguous bytes a row (compiled out for pass
// A), and the max of each group of G columns by __shfl_xor_sync over the G/4
// lanes that hold it.
//
// N must be a multiple of 128 (the callers pad rows). The wrapper passes D
// padded with zero columns to a multiple of 16 bytes' worth of elements
// (4 f32, 8 bf16, 16 int8) and 16-byte aligned operands; zeros after the
// last k keep the chain order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 128;   // passage rows per block
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kCPitch = kTileN + 8;  // epilogue tile pitch (floats)

// ---------------------------------------------------------------------------
// cp.async and tensor-core helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with pred false nothing is read and the
// 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies a [rows, 16-byte chunks] tile of a row-major [nrows, d] operand
// (row pitch `d` elements of `T`) into shared memory with row pitch `pitch`
// elements; rows at or past `nrows` and chunks at or past the row's end are
// zero-filled. kChunks is the tile's chunks a row.
template <typename T, int kRows, int kChunks, int kPitch, int kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int nrows, int k0, int d,
                                          int tid) {
  constexpr int kPer = 16 / sizeof(T);  // elements a chunk
  static_assert(kRows * kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int c = tid + it * kThreads;
    const int r = c / kChunks;  // powers of two: shifts
    const int ch = c % kChunks;
    const int gk = k0 + ch * kPer;
    const bool ok = (row0 + r < nrows) && (gk < d);
    const T* g = ok ? src + static_cast<long long>(row0 + r) * d + gk : src;
    cp_async16(dst + r * kPitch + ch * kPer, g, ok);
  }
}

// ---------------------------------------------------------------------------
// the epilogue: an f32 [BM, kTileN] tile in shared memory (pitch kCPitch)
// ---------------------------------------------------------------------------
template <int kBM, int kThreads, bool kStore>
__device__ __forceinline__ void store_tile(const float* cs,
                                           float* __restrict__ scores,
                                           float* __restrict__ gmax, int m0,
                                           int n0, int nq, int n, int group,
                                           int tid) {
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int lanes = group / 4;  // lanes holding one group (2..32)
  const int groups_per_row = n / group;
  const int col = n0 + lane * 4;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = m0 + r;
    if (row >= nq) break;  // warp-uniform: later rows are past Q too
    const float4 v = *reinterpret_cast<const float4*>(cs + r * kCPitch + lane * 4);
    if constexpr (kStore)
      *reinterpret_cast<float4*>(scores + static_cast<long long>(row) * n + col) = v;
    float mx = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
    for (int off = 1; off < lanes; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane % lanes == 0)
      gmax[static_cast<long long>(row) * groups_per_row + col / group] = mx;
  }
}

// ---------------------------------------------------------------------------
// f32 / bf16 passages: f32 FMA on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kTileK = 32;   // depth per stage
constexpr int kAPitch = kTileK + 4;  // floats

template <typename P>
struct FmaTile;
template <>
struct FmaTile<float> {
  static constexpr int kPitch = kTileK + 4;  // 144 bytes
  __device__ __forceinline__ static float4 read4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};
template <>
struct FmaTile<__nv_bfloat16> {
  static constexpr int kPitch = kTileK + 8;  // 80 bytes
  __device__ __forceinline__ static float4 read4(const __nv_bfloat16* p) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 lo = __bfloat1622float2(p2[0]);  // exact widening
    const float2 hi = __bfloat1622float2(p2[1]);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

template <int kBM>
struct FmaShape {
  static constexpr int kThreads = kBM * 2;  // (BM/8) x (kTileN/8) threads
  static constexpr int kRowGroups = kBM / 8;
};

template <typename P, int kBM>
constexpr int fma_smem_bytes() {
  constexpr int stage =
      kBM * kAPitch * 4 + kTileN * FmaTile<P>::kPitch * static_cast<int>(sizeof(P));
  constexpr int ring = kStages * stage;
  constexpr int c = kBM * kCPitch * 4;
  return ring > c ? ring : c;
}

// kStore: write the score tile (kernel 2) or only the group maxima (pass A
// of the streaming search; `scores` is then unused and may be null).
template <typename P, int kBM, bool kStore>
__global__ void __launch_bounds__(FmaShape<kBM>::kThreads, 1)
scores_groupmax_fma(const float* __restrict__ q, const P* __restrict__ p,
                    float* __restrict__ scores, float* __restrict__ gmax,
                    int nq, int n, int d, int group) {
  constexpr int kThreads = FmaShape<kBM>::kThreads;
  constexpr int kRG = FmaShape<kBM>::kRowGroups;
  constexpr int kBPitch = FmaTile<P>::kPitch;
  constexpr int kAStage = kBM * kAPitch;       // floats
  constexpr int kBStage = kTileN * kBPitch;    // elements of P
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);
  P* bs = reinterpret_cast<P*>(smem + kStages * kAStage * 4);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // a warp is 4 row groups x 8 column groups; warps tile 2 column halves
  const int tx = (warp % 2) * 8 + lane % 8;    // 0..15
  const int ty = (warp / 2) * 4 + lane / 8;    // 0..kRG-1
  const int q_tiles = (nq + kBM - 1) / kBM;
  const int m0 = (blockIdx.x % q_tiles) * kBM;
  const int n0 = (blockIdx.x / q_tiles) * kTileN;
  const int nk = (d + kTileK - 1) / kTileK;

  auto load_stage = [&](int kt) {
    const int slot = kt % kStages;
    load_tile<float, kBM, kTileK / 4, kAPitch, kThreads>(
        as + slot * kAStage, q, m0, nq, kt * kTileK, d, tid);
    load_tile<P, kTileN, static_cast<int>(kTileK * sizeof(P) / 16), kBPitch, kThreads>(
        bs + slot * kBStage, p + static_cast<long long>(n0) * d, 0, kTileN,
        kt * kTileK, d, tid);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt-1's slot is free
    if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1);
    cp_async_commit();
    const float* a_s = as + (kt % kStages) * kAStage + ty * kAPitch;
    const P* b_s = bs + (kt % kStages) * kBStage + tx * kBPitch;
#pragma unroll
    for (int kq = 0; kq < kTileK; kq += 4) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = FmaTile<P>::read4(b_s + j * 16 * kBPitch + kq);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(a_s + i * kRG * kAPitch + kq);
        // k, k+1, k+2, k+3 in order for every output: the chain order
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the epilogue tile

  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[(i * kRG + ty) * kCPitch + j * 16 + tx] = acc[i][j];
  __syncthreads();
  store_tile<kBM, kThreads, kStore>(cs, scores, gmax, m0, n0, nq, n, group, tid);
}

// ---------------------------------------------------------------------------
// int8 passages: s8 x s8 -> s32 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kI8BM = 128;
constexpr int kI8TileK = 128;              // bytes of k a stage
constexpr int kI8Pitch = kI8TileK + 16;    // 144 bytes: ldmatrix conflict-free
constexpr int kI8Threads = 256;            // 8 warps: 2 (queries) x 4 (rows)
constexpr int kI8Stage = (kI8BM + kTileN) * kI8Pitch;

constexpr int i8_smem_bytes() {
  constexpr int ring = kStages * kI8Stage;
  constexpr int c = kI8BM * kCPitch * 4;
  return ring > c ? ring : c;
}

template <bool kStore>
__global__ void __launch_bounds__(kI8Threads, 2)
scores_groupmax_i8(const int8_t* __restrict__ q, const int8_t* __restrict__ p,
                   float* __restrict__ scores, float* __restrict__ gmax,
                   int nq, int n, int d, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / 4;  // 64 query rows each
  const int wn = warp % 4;  // 32 passage rows each
  const int q_tiles = (nq + kI8BM - 1) / kI8BM;
  const int m0 = (blockIdx.x % q_tiles) * kI8BM;
  const int n0 = (blockIdx.x / q_tiles) * kTileN;
  const int nk = (d + kI8TileK - 1) / kI8TileK;

  auto load_stage = [&](int kt) {
    int8_t* a_s = ring + (kt % kStages) * kI8Stage;
    int8_t* b_s = a_s + kI8BM * kI8Pitch;
    load_tile<int8_t, kI8BM, kI8TileK / 16, kI8Pitch, kI8Threads>(
        a_s, q, m0, nq, kt * kI8TileK, d, tid);
    load_tile<int8_t, kTileN, kI8TileK / 16, kI8Pitch, kI8Threads>(
        b_s, p + static_cast<long long>(n0) * d, 0, kTileN, kt * kI8TileK, d, tid);
  };

  int acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8.
  // A (16x32 of a m16 tile): matrices (rows 0-7 | 8-15) x (k 0-15 | 16-31).
  const int a_row = wm * 64 + (lane % 8) + ((lane / 8) % 2) * 8;
  const int a_k = (lane / 16) * 16;
  // B (two n8 tiles x 32 k): matrices (tile j, k 0-15), (j, k 16-31),
  // (j+1, k 0-15), (j+1, k 16-31).
  const int b_row = wn * 32 + (lane / 16) * 8 + (lane % 8);
  const int b_k = ((lane / 8) % 2) * 16;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1);
    cp_async_commit();
    const int8_t* a_s = ring + (kt % kStages) * kI8Stage;
    const int8_t* b_s = a_s + kI8BM * kI8Pitch;
#pragma unroll
    for (int ks = 0; ks < kI8TileK; ks += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], a_s + (a_row + i * 16) * kI8Pitch + ks + a_k);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + (b_row + j * 8) * kI8Pitch + ks + b_k);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // C fragment: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8.
  float* cs = reinterpret_cast<float*>(smem);
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm * 64 + i * 16 + g;
      const int c = wn * 32 + j * 8 + 2 * t;
      // exact: |sum| <= 1040 * 127^2 < 2^24
      *reinterpret_cast<float2*>(cs + r * kCPitch + c) =
          make_float2(static_cast<float>(acc[i][j][0]), static_cast<float>(acc[i][j][1]));
      *reinterpret_cast<float2*>(cs + (r + 8) * kCPitch + c) =
          make_float2(static_cast<float>(acc[i][j][2]), static_cast<float>(acc[i][j][3]));
    }
  __syncthreads();
  store_tile<kI8BM, kI8Threads, kStore>(cs, scores, gmax, m0, n0, nq, n, group, tid);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Config {
  int threads, smem, rows;  // block threads, dynamic shared bytes, BM
  const void* fn;
};

template <bool kStore>
Config config(int p_dtype, int nq) {
  const bool small = nq <= 64;
  if (p_dtype == 0)
    return small ? Config{128, fma_smem_bytes<float, 64>(), 64,
                          (const void*)scores_groupmax_fma<float, 64, kStore>}
                 : Config{256, fma_smem_bytes<float, 128>(), 128,
                          (const void*)scores_groupmax_fma<float, 128, kStore>};
  if (p_dtype == 1)
    return small ? Config{128, fma_smem_bytes<__nv_bfloat16, 64>(), 64,
                          (const void*)scores_groupmax_fma<__nv_bfloat16, 64, kStore>}
                 : Config{256, fma_smem_bytes<__nv_bfloat16, 128>(), 128,
                          (const void*)scores_groupmax_fma<__nv_bfloat16, 128, kStore>};
  return Config{kI8Threads, i8_smem_bytes(), kI8BM,
                (const void*)scores_groupmax_i8<kStore>};
}

template <bool kStore>
int launch(const void* q, const void* p, void* scores, void* gmax, int nq,
           int n, int d, int group, int p_dtype, void* stream) {
  if (nq <= 0 || n <= 0 || d <= 0 || n % kTileN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (group != 8 && group != 16 && group != 32 && group != 64 && group != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p_dtype < 0 || p_dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = p_dtype == 0 ? 4 : p_dtype == 1 ? 8 : 16;
  if (d % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config<kStore>(p_dtype, nq);
  const long long blocks =
      static_cast<long long>((nq + cfg.rows - 1) / cfg.rows) * (n / kTileN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      cfg.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  float* sf = static_cast<float*>(scores);
  float* gf = static_cast<float*>(gmax);
  const float* qf = static_cast<const float*>(q);
  if (p_dtype == 0) {
    const float* pp = static_cast<const float*>(p);
    if (cfg.rows == 64)
      scores_groupmax_fma<float, 64, kStore><<<grid, cfg.threads, cfg.smem, s>>>(
          qf, pp, sf, gf, nq, n, d, group);
    else
      scores_groupmax_fma<float, 128, kStore><<<grid, cfg.threads, cfg.smem, s>>>(
          qf, pp, sf, gf, nq, n, d, group);
  } else if (p_dtype == 1) {
    const __nv_bfloat16* pp = static_cast<const __nv_bfloat16*>(p);
    if (cfg.rows == 64)
      scores_groupmax_fma<__nv_bfloat16, 64, kStore><<<grid, cfg.threads, cfg.smem, s>>>(
          qf, pp, sf, gf, nq, n, d, group);
    else
      scores_groupmax_fma<__nv_bfloat16, 128, kStore><<<grid, cfg.threads, cfg.smem, s>>>(
          qf, pp, sf, gf, nq, n, d, group);
  } else {
    scores_groupmax_i8<kStore><<<grid, cfg.threads, cfg.smem, s>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(p), sf, gf,
        nq, n, d, group);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [Q, D] row-major: f32 for p_dtype 0 (float32) and 1 (bfloat16), int8
// for p_dtype 2 (int8, the int-valued queries of quantize_queries). p [N, D]
// row-major. D a multiple of 4 / 8 / 16 (16 bytes of P), both operands
// 16-byte aligned. group in {8, 16, 32, 64, 128}; n % 128 == 0. Returns a
// cudaError_t (0 = launched).
extern "C" int convdr_scores_groupmax(const void* q, const void* p,
                                      void* scores, void* gmax, int nq, int n,
                                      int d, int group, int p_dtype,
                                      void* stream) {
  return launch<true>(q, p, scores, gmax, nq, n, d, group, p_dtype, stream);
}

// Pass A of the streaming search: the group maxima only, the same
// arguments less the scores.
extern "C" int convdr_streaming_groupmax(const void* q, const void* p,
                                         void* gmax, int nq, int n, int d,
                                         int group, int p_dtype,
                                         void* stream) {
  return launch<false>(q, p, nullptr, gmax, nq, n, d, group, p_dtype, stream);
}

// The launch configuration chosen for (p_dtype, nq): out[0] threads a
// block, out[1] dynamic shared memory bytes, out[2] query rows a block,
// out[3] resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// after the shared-memory attribute is set). Returns a cudaError_t.
extern "C" int convdr_scores_groupmax_config(int p_dtype, int nq, int* out) {
  if (p_dtype < 0 || p_dtype > 2 || nq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config<true>(p_dtype, nq);
  cudaError_t err = cudaFuncSetAttribute(
      cfg.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cfg.fn,
                                                      cfg.threads, cfg.smem);
  out[0] = cfg.threads;
  out[1] = cfg.smem;
  out[2] = cfg.rows;
  out[3] = blocks;
  return static_cast<int>(err);
}
