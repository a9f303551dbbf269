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
// consecutive columns ([Q, N/G]). P is f32, bf16 or int8 [N, D]. Three paths:
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
// f32 and bf16 passages at Q <= 32 (kSmallQMax, Q*; the serving search is
// Q=1): the tile above would compute 64 query rows for each live one, and
// what bounds the work is bytes (the block, 0.48 ms f32 / 0.24 ms bf16 at
// N=524288, D=768), so this path streams the block once at the lowest cost
// an element, in the same chain order:
//   * one consumer thread a passage row, holding one accumulator a query
//     (Q rounded up to a power of two, 1..32, a template instance each); k
//     is never split: each score is still the single chain above, bf16
//     widened exactly by __bfloat1622float2 before its FMA;
//   * [128 rows x 128 bytes of k] boxes (32 f32 / 64 bf16 k) come in by TMA
//     (cp.async.bulk.tensor.2d, k past D zero-filled) into a ring of 3
//     stages, issued by one producer thread and drained under full / empty
//     mbarriers (csrc/hopper.cuh); the 128-byte swizzle puts a warp's 32
//     rows of one 16-byte chunk on all banks (4 wavefronts an LDS.128);
//   * the queries are copied to shared memory once a block as [k/4][Q]
//     float4 and read as broadcasts: one LDS.128 feeds 4 FMAs a query;
//   * a persistent grid (up to 2 blocks an SM) walks the 128-row tiles, the
//     ring running across tiles, so the next tile's loads overlap this
//     tile's FMAs and epilogue;
//   * epilogue from the registers: scores 128 bytes a warp a query
//     (compiled out for pass A); the max of G consecutive rows, i.e. G
//     consecutive threads, by __shfl_xor_sync for G <= 32 and one
//     shared-memory step across warps for G = 64, 128 (a max is exact, so
//     its order is free).
// Its queries must fit in shared memory beside the ring (D <= 1408 at
// Q = 17..32, 2816 at Q = 9..16); larger D takes the tile path. Q* is the
// largest Q at which this path beat the tile path on an H100 in both
// dtypes (convdr_torch/scripts/score_sweep.py, which chip_smoke.py runs:
// kernels 2 and 3 at Q = 1..64, bit for bit equal to the tile path).
//
// int8 passages (SQ8 storage, ops/quant.py): the wrapper turns the
// int-valued f32 queries into int8 (exact in [-127, 127]), and the product
// runs on Hopper's int8 tensor cores: wgmma m64n256k32 s8 x s8 -> s32, both
// operands K-major from shared memory as they are stored ([Q, D], [N, D]:
// no transpose). The sums are integers, so any order gives the same result,
// and the s32 -> f32 conversion is exact because |sum| <= 1040 * 127^2 <
// 2^24: the scores equal the plain version and the integer oracle bit for
// bit. At Q=512, N=524288, D=768 kernel 2 is bound by bytes (the int8 block
// plus the [Q, N] f32 score store, ~0.45 ms) and pass A by operations
// (2QND at the 1979 TOP/s int8 peak, ~0.21 ms; bytes ~0.12). The design:
//   * a persistent grid, one block an SM: a TMA producer warp and two
//     consumer warpgroups of 64 query rows, over tiles of 128 queries x 256
//     passage rows (wgmma m64n256k32: 128 s32 registers a thread), query
//     tiles fastest, so the blocks that share a passage tile run together
//     and it comes from device memory once;
//   * [rows x 128 bytes of k] boxes by TMA (128-byte swizzle; rows past Q
//     and k past D arrive as zeros) into a ring of 4 (pass A) or 3 (kernel
//     2, beside its staging) 48 KB stages that runs across tiles, under
//     full / empty mbarriers, so the next tile's loads overlap this tile's
//     products and epilogue; a stage is four k32 steps in one commit group,
//     released once the next stage's group is issued and its own has
//     landed;
//   * the epilogue from the registers: the max of G consecutive columns over
//     a thread's 8-column chunks and the quad's 4 lanes (__shfl_xor_sync;
//     G a template argument, so the groups' chains unroll and interleave),
//     with no shared-memory step; kernel 2's scores as f32, 64 columns a
//     round, into one of two staging halves a warpgroup laid out as TMA's
//     swizzle wants it, then out by TMA stores marked L2 evict-first that
//     drain while the next rounds and tiles compute (compiled out for pass
//     A). On an H100 this beat 128-row tiles (more query bytes a product),
//     st.global from the registers (the warps stall on the stores) and one
//     128-column round (its second round waits on the first's reads).
//
// Epilogue (the FMA tile path): the accumulator tile goes through shared memory
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

#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kTileN = 128;   // passage rows per block
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kCPitch = kTileN + 8;  // epilogue tile pitch (floats)

// ---------------------------------------------------------------------------
// cp.async helpers
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
// f32 / bf16 passages at Q <= kSmallQMax: one thread a passage row
// ---------------------------------------------------------------------------
constexpr int kSmallQMax = 32;                 // Q*: the largest Q this path takes
constexpr int kSqRows = 128;                   // passage rows a tile, one a consumer
constexpr int kSqConsumers = kSqRows;          // 4 warps
constexpr int kSqWarps = kSqConsumers / 32;
constexpr int kSqThreads = kSqConsumers + 32;  // + the TMA producer warp
constexpr int kSqStages = 3;                   // mbarrier ring depth
constexpr int kSqStageBytes = kSqRows * 128;   // 128 bytes of k a row: 16 KB
constexpr int kSqMaxBlocksPerSm = 2;           // the persistent grid
constexpr int kMaxSmem = 227 * 1024;           // a block's dynamic shared memory
constexpr int kUnrollFmas = 1024;              // FMAs a thread in the unrolled stage body

// Queries a block computes for Q: Q rounded up to a power of two.
inline int sq_bucket(int nq) {
  int b = 1;
  while (b < nq) b <<= 1;
  return b;
}

// Shared memory from a 1024-byte aligned base (the 128-byte swizzle's
// atom): the ring's stages, the queries as [dk / 4][kQ] float4 (dk = D
// rounded up to a stage's k; zero past Q and past D), the cross-warp
// group maxima [kSqWarps][kQ], the full and empty barriers; + 1024 bytes
// to align the base.
inline int sq_smem_bytes(int kq, int dk) {
  return 1024 + kSqStages * kSqStageBytes + kq * dk * 4 + kSqWarps * kq * 4 +
         2 * kSqStages * 8;
}

// 4 consecutive k of a passage row into every query's chain, k in order;
// q4[j] holds query j's 4 values at these k.
template <int kQ>
__device__ __forceinline__ void sq_fma4(float (&acc)[kQ], const float4* q4, float p0, float p1,
                                        float p2, float p3) {
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const float4 a = q4[j];
    acc[j] = fmaf(a.x, p0, acc[j]);
    acc[j] = fmaf(a.y, p1, acc[j]);
    acc[j] = fmaf(a.z, p2, acc[j]);
    acc[j] = fmaf(a.w, p3, acc[j]);
  }
}

__device__ __forceinline__ float2 widen_bf16x2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));  // exact
}

// One 16-byte chunk of a passage row: 4 f32 or 8 bf16 k, in order.
template <typename P, int kQ>
__device__ __forceinline__ void sq_chunk(float (&acc)[kQ], const float4* q4, uint4 raw) {
  if constexpr (sizeof(P) == 4) {
    sq_fma4<kQ>(acc, q4, __uint_as_float(raw.x), __uint_as_float(raw.y), __uint_as_float(raw.z),
                __uint_as_float(raw.w));
  } else {
    const float2 k01 = widen_bf16x2(raw.x), k23 = widen_bf16x2(raw.y);
    const float2 k45 = widen_bf16x2(raw.z), k67 = widen_bf16x2(raw.w);
    sq_fma4<kQ>(acc, q4, k01.x, k01.y, k23.x, k23.y);
    sq_fma4<kQ>(acc, q4 + kQ, k45.x, k45.y, k67.x, k67.y);
  }
}

// A persistent grid walks the 128-row passage tiles (tile blockIdx.x, then
// + gridDim.x). Thread 128 (the producer warp's first lane) streams each
// tile's [128 rows x 128 bytes of k] boxes by TMA into a ring of kSqStages
// stages, across tiles, so the next tile's loads overlap this one's FMAs
// and epilogue; consumer thread t owns row t of every tile and holds kQ
// accumulators. A stage lands on its full barrier and is released by all
// 128 consumers on its empty barrier.
template <typename P, int kQ, bool kStore>
__global__ void __launch_bounds__(kSqThreads, 1)
scores_groupmax_small_q(const __grid_constant__ CUtensorMap p_map, const float* __restrict__ q,
                        float* __restrict__ scores, float* __restrict__ gmax, int nq, int n,
                        int d, int group) {
  constexpr int kBoxK = 128 / static_cast<int>(sizeof(P));  // k of a stage: 32 or 64
  constexpr int kChunk4 = 4 / static_cast<int>(sizeof(P));   // float4 of q a chunk: 1 or 2
  constexpr int kChunkFmas = kQ * 4 * kChunk4;               // FMAs of a chunk a thread
  constexpr int kUnroll = kChunkFmas * 8 <= kUnrollFmas ? 8 : kUnrollFmas / kChunkFmas;
  extern __shared__ __align__(16) unsigned char sq_smem[];
  unsigned char* smem = sq_smem + ((1024u - (shared_addr(sq_smem) & 1023u)) & 1023u);
  const int nk = (d + kBoxK - 1) / kBoxK;
  const int dk4 = nk * (kBoxK / 4);  // float4 of k a query
  float4* qs = reinterpret_cast<float4*>(smem + kSqStages * kSqStageBytes);
  float* red = reinterpret_cast<float*>(qs + dk4 * kQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kSqWarps * kQ);
  uint64_t* empty = full + kSqStages;
  const int tid = threadIdx.x;
  const int tiles = n / kSqRows;

  if (tid == kSqConsumers) {
    for (int s = 0; s < kSqStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kSqConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kSqConsumers) {  // the producer
    if (tid == kSqConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % kSqStages;
          if (it >= kSqStages) mbar_wait(empty + s, (it / kSqStages - 1) & 1);
          mbar_arrive_expect_tx(full + s, kSqStageBytes);
          tma_load_2d(smem + s * kSqStageBytes, &p_map, full + s, kc * kBoxK, tile * kSqRows);
        }
    }
    return;
  }

  // the queries, once a block, while the first stages load
  for (int i = tid; i < kQ * dk4; i += kSqConsumers) {
    const int j = i / dk4;
    const int k4 = i - j * dk4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < nq && 4 * k4 < d)
      v = *reinterpret_cast<const float4*>(q + static_cast<long long>(j) * d + 4 * k4);
    qs[k4 * kQ + j] = v;
  }
  named_barrier(1, kSqConsumers);

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gshift = __ffs(group) - 1;
  const int groups_per_row = n >> gshift;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) acc[j] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % kSqStages;
      mbar_wait(full + s, (it / kSqStages) & 1);
      const unsigned char* rows = smem + s * kSqStageBytes;
      const float4* q4 = qs + kc * (kBoxK / 4) * kQ;
      // the row's 8 chunks in k order; the swizzle spreads the warp's 32
      // rows of one chunk over all banks (4 wavefronts an LDS.128). The
      // unrolled body stays within kUnrollFmas FMAs a thread: at 2048 (bf16,
      // Q=32) the stage ran at half the rate of f32's 1024
#pragma unroll 1
      for (int c0 = 0; c0 < 8; c0 += kUnroll) {
#pragma unroll
        for (int c = c0; c < c0 + kUnroll; ++c) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(rows + swizzled_chunk_offset(tid, c, 128));
          sq_chunk<P, kQ>(acc, q4 + c * kChunk4 * kQ, raw);
        }
      }
      mbar_arrive(empty + s);
    }

    // scores: 128 bytes a warp a query; maxima: G consecutive threads
    const int row = tile * kSqRows + tid;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (j < nq) {
        if constexpr (kStore) scores[static_cast<long long>(j) * n + row] = acc[j];
        float mx = acc[j];
        for (int off = 1; off < group && off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (group <= 32) {
          if ((lane & (group - 1)) == 0)
            gmax[static_cast<long long>(j) * groups_per_row + (row >> gshift)] = mx;
        } else if (lane == 0) {
          red[warp * kQ + j] = mx;
        }
      }
    }
    if (group > 32) {  // G = 64, 128: the warps' maxima through shared memory
      named_barrier(1, kSqConsumers);
      const int warps_a_group = group / 32;
      const int groups_a_tile = kSqRows / group;
      if (tid < nq * groups_a_tile) {
        const int j = tid / groups_a_tile;
        const int g = tid - j * groups_a_tile;
        float mx = red[g * warps_a_group * kQ + j];
        for (int w = 1; w < warps_a_group; ++w)
          mx = fmaxf(mx, red[(g * warps_a_group + w) * kQ + j]);
        gmax[static_cast<long long>(j) * groups_per_row + tile * groups_a_tile + g] = mx;
      }
      named_barrier(1, kSqConsumers);  // red is free for the next tile
    }
  }
}

// ---------------------------------------------------------------------------
// int8 passages: wgmma s8 x s8 -> s32 over a TMA ring
// ---------------------------------------------------------------------------
constexpr int kI8Rows = 64;                    // query rows a consumer warpgroup: wgmma's M
constexpr int kI8BM = 2 * kI8Rows;             // query rows a tile: two consumer warpgroups
constexpr int kI8BN = 256;                     // passage rows a tile: wgmma's N
constexpr int kI8KBytes = 128;                 // k a stage: one 128-byte swizzled row (128 int8)
constexpr int kI8Consumers = 256;              // two warpgroups
constexpr int kI8Threads = kI8Consumers + 32;  // + the TMA producer warp
constexpr int kI8MaxStages = 4;
constexpr int kI8MaxBlocksPerSm = 1;           // the persistent grid
constexpr int kI8StoreCols = 64;               // score columns a warpgroup stores a round
constexpr int kI8BoxBytes = kI8Rows * 32 * 4;  // a TMA store box: [64 rows][32 f32]

// Shared memory of a block (from a 1024-byte aligned base): the ring's
// stages ([kI8BM][128] query bytes, then [kI8BN][128] passage bytes, both
// as TMA's 128-byte swizzle lays them), for kernel 2 two staging halves of
// [64][kI8StoreCols] f32 a warpgroup (TMA store boxes of [64][32],
// swizzled alike), the full and empty barriers; as many stages as fit, up
// to kI8MaxStages: 4 for pass A, 3 beside kernel 2's staging.
template <bool kStore>
struct I8Tile {
  static constexpr int kABytes = kI8BM * kI8KBytes;
  static constexpr int kStageBytes = kABytes + kI8BN * kI8KBytes;
  static constexpr int kHalfBytes = kI8Rows * kI8StoreCols * 4;
  static constexpr int kStagingBytes = kStore ? 2 * 2 * kHalfBytes : 0;
  static constexpr int kFit =
      (kMaxSmem - 1024 - kStagingBytes - 2 * 8 * kI8MaxStages) / kStageBytes;
  static constexpr int kRing = kFit < kI8MaxStages ? kFit : kI8MaxStages;
  static constexpr int kSmem = 1024 + kRing * kStageBytes + kStagingBytes + 2 * 8 * kRing;
  static_assert(kRing >= 3, "a ring of three stages at least");
  static_assert(kStageBytes % 1024 == 0 && kHalfBytes % 1024 == 0, "1024-byte bases");
};

// The group maxima of a warpgroup's 64 x kI8BN tile from its accumulator
// fragments (row 16w + g + 8r, column 8j + 2t + e): a group is kGJ of a
// thread's 8-column chunks j across the quad's 4 lanes. int max (exact),
// the quad's xor shuffles, then one conversion (|sum| < 2^24); lane t
// stores the groups k with k % 4 == t, so a warp's store covers 4
// consecutive maxima of 8 rows. kGJ is a template argument so that the
// groups unroll with no branch between them (a loop over a runtime G made
// pass A 1.3x slower on an H100).
template <int kGJ>
__device__ __forceinline__ void i8_group_max(const int (&acc)[kI8BN / 2],
                                             float* __restrict__ gmax, int row_base, int nq,
                                             int n0, int n, int gshift, int t) {
  constexpr int kGroups = kI8BN / 8 / kGJ;  // groups a row of the tile
  const int groups_per_row = n >> gshift;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + 8 * r;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      int m = INT_MIN;
#pragma unroll
      for (int j = k * kGJ; j < (k + 1) * kGJ; ++j)
        m = max(m, max(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
      m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (row < nq) {
        if ((k & 3) == t && n0 + 8 * kGJ * k < n)
          gmax[static_cast<long long>(row) * groups_per_row + (n0 >> gshift) + k] =
              __int2float_rn(m);
      }
    }
  }
}

// A persistent grid walks the [kI8BM queries x kI8BN passages] tiles,
// query tiles fastest (tile % q_tiles), so the blocks that share a passage
// tile run together and it comes from device memory once. Thread 256 (the
// producer warp's first lane) streams each tile's query and passage boxes
// ([rows x 128 bytes of k], rows past Q and k past D as zeros) by TMA into
// a ring of kRing stages that runs across tiles, so the next tile's loads
// overlap this tile's products and epilogue. Consumer warpgroup w owns
// query rows 64w..64w+63 of every tile: per stage 4 wgmma m64n256k32 from
// shared memory, one commit group, stage s-1 released once stage s's group
// is issued and s-1's has landed. Epilogue from the registers: the group
// maxima, then (kernel 2) the scores as f32, kI8StoreCols columns a round,
// into one of the warpgroup's two staging halves and out by TMA stores
// (L2 evict-first: the scores are not read again here, the passage tiles
// are) that drain while the next rounds and the next tile compute.
// Registers: 288 threads cap a thread at 65,536 / 384 = 168 (ptxas), the
// 128 accumulators leave 40; the producer in a consumer thread (256
// threads, 255 registers) put a branch among the products in flight and
// ptxas serialized them (C7518), and setmaxnreg did not lift the cap
// ptxas allocates by.
template <bool kStore>
__global__ void __launch_bounds__(kI8Threads, kI8MaxBlocksPerSm)
scores_groupmax_s8(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap p_map,
                   const __grid_constant__ CUtensorMap s_map, float* __restrict__ gmax, int nq,
                   int n, int d, int group) {
  using Tl = I8Tile<kStore>;
  constexpr int kRing = Tl::kRing;
  constexpr int kAcc = kI8BN / 2;  // s32 registers a thread: the 64 x kI8BN accumulator
  extern __shared__ __align__(16) unsigned char i8_smem[];
  unsigned char* smem = i8_smem + ((1024u - (shared_addr(i8_smem) & 1023u)) & 1023u);
  unsigned char* staging = smem + kRing * Tl::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + Tl::kStagingBytes);
  uint64_t* empty = full + kRing;
  const int tid = threadIdx.x;
  const int q_tiles = (nq + kI8BM - 1) / kI8BM;
  const int tiles = q_tiles * ((n + kI8BN - 1) / kI8BN);
  const int nk = (d + kI8KBytes - 1) / kI8KBytes;

  if (tid == kI8Consumers) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kI8Consumers / 32);  // each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kI8Consumers) {  // the producer
    if (tid == kI8Consumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % q_tiles) * kI8BM;
        const int n0 = (tile / q_tiles) * kI8BN;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % kRing;
          if (it >= kRing) mbar_wait(empty + s, (it / kRing - 1) & 1);
          unsigned char* st = smem + s * Tl::kStageBytes;
          mbar_arrive_expect_tx(full + s, Tl::kStageBytes);
          tma_load_2d(st, &q_map, full + s, kc * kI8KBytes, m0);
          tma_load_2d(st + Tl::kABytes, &p_map, full + s, kc * kI8KBytes, n0);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int warp = wtid / 32;  // rows 16 warp + g, + 8 of the warpgroup's 64
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int gj = group >> 3;  // 8-column chunks a group: 1..16
  const int gshift = __ffs(group) - 1;
  const uint32_t base = shared_addr(smem);
  unsigned char* my_staging = staging + wg * (Tl::kStagingBytes / 2);
  // This thread's float2 at row 16 warp + g (+ 8: + 1024 bytes) and
  // 8-column chunk c of a [64][32] f32 box lies at sw + 32 * (c ^ g / 2):
  // the 128-byte swizzle XORs the 16-byte chunk 2c + t/2 with g
  const int sw = (16 * warp + g) * 128 + 16 * ((t / 2) ^ (g & 1)) + 8 * (t & 1);
  const int gh = g >> 1;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile / q_tiles) * kI8BN;
    const int row0 = (tile % q_tiles) * kI8BM + kI8Rows * wg;  // this warpgroup's first row
    int acc[kAcc];
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % kRing;
      mbar_wait(full + s, (it / kRing) & 1);
      const uint32_t st = base + s * Tl::kStageBytes;
      const uint64_t da = wgmma_desc(st + wg * kI8Rows * kI8KBytes, kI8KBytes);
      const uint64_t db = wgmma_desc(st + Tl::kABytes, kI8KBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kI8KBytes / 32; ++kk)
        wgmma_s8_n256(acc, da + 2 * kk, db + 2 * kk, (kc | kk) != 0);
      wgmma_commit();
      if (kc > 0) {  // the previous stage's products have landed: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + (it - 1) % kRing);
      }
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + (it - 1) % kRing);
    if (row0 >= nq) continue;  // warpgroup-uniform: none of its rows is a query

    const int row_base = row0 + 16 * warp + g;
    switch (gj) {
      case 1: i8_group_max<1>(acc, gmax, row_base, nq, n0, n, gshift, t); break;
      case 2: i8_group_max<2>(acc, gmax, row_base, nq, n0, n, gshift, t); break;
      case 4: i8_group_max<4>(acc, gmax, row_base, nq, n0, n, gshift, t); break;
      case 8: i8_group_max<8>(acc, gmax, row_base, nq, n0, n, gshift, t); break;
      default: i8_group_max<16>(acc, gmax, row_base, nq, n0, n, gshift, t); break;
    }

    if constexpr (kStore) {
      // the scores: round c0 into staging half (c0 / 64) % 2, laid out as
      // TMA's swizzle lays two [64][32] f32 boxes (a warp's float2 writes
      // fill all banks twice: 2 wavefronts for 256 bytes), once the stores
      // of the round before last have read that half; then 2 TMA stores.
      // Rows past Q and columns past N are not written.
#pragma unroll
      for (int c0 = 0; c0 < kI8BN; c0 += kI8StoreCols) {
        if (n0 + c0 >= n) break;  // uniform
        unsigned char* half = my_staging + ((c0 / kI8StoreCols) & 1) * Tl::kHalfBytes;
        if (wtid == 0) tma_store_wait_read<1>();
        named_barrier(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < kI8StoreCols / 8; ++jj) {
          const int j = c0 / 8 + jj;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(half + (jj / 4) * kI8BoxBytes + sw +
                                       32 * ((jj % 4) ^ gh) + 1024 * r) =
                make_float2(__int2float_rn(acc[4 * j + 2 * r]),
                            __int2float_rn(acc[4 * j + 2 * r + 1]));
        }
        fence_shared_to_async();
        named_barrier(1 + wg, 128);
        if (wtid == 0) {
          const uint64_t policy = l2_evict_first_policy();
#pragma unroll
          for (int b = 0; b < kI8StoreCols / 32; ++b)
            tma_store_2d(&s_map, half + b * kI8BoxBytes, n0 + c0 + 32 * b, row0, policy);
          tma_store_commit();
        }
      }
    }
  }
  if constexpr (kStore) {
    if (wtid == 0) tma_store_wait_read<0>();  // the staging outlives its reads
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Config {
  int threads, smem, rows;  // block threads, dynamic shared bytes, query rows a block
  const void* fn;
  int path;                 // kPathTile, kPathSmallQ or kPathInt8
};
constexpr int kPathTile = 0, kPathSmallQ = 1, kPathInt8 = 2;

template <typename P, bool kStore>
const void* small_q_fn(int kq) {
  switch (kq) {
    case 1: return (const void*)scores_groupmax_small_q<P, 1, kStore>;
    case 2: return (const void*)scores_groupmax_small_q<P, 2, kStore>;
    case 4: return (const void*)scores_groupmax_small_q<P, 4, kStore>;
    case 8: return (const void*)scores_groupmax_small_q<P, 8, kStore>;
    case 16: return (const void*)scores_groupmax_small_q<P, 16, kStore>;
    default: return (const void*)scores_groupmax_small_q<P, kSmallQMax, kStore>;
  }
}

// int8 passages take the wgmma kernel at every Q. f32 and bf16 passages
// take the small-Q path at Q <= kSmallQMax when its queries fit in shared
// memory beside the ring (D <= 1408 at Q = 17..32; the tile path takes
// larger D).
template <bool kStore>
Config config(int p_dtype, int nq, int d) {
  if (p_dtype == 2) {
    return Config{kI8Threads, I8Tile<kStore>::kSmem, kI8BM,
                  (const void*)scores_groupmax_s8<kStore>, kPathInt8};
  }
  if (nq <= kSmallQMax) {
    const int kq = sq_bucket(nq);
    const int box_k = p_dtype == 0 ? 32 : 64;
    const int smem = sq_smem_bytes(kq, (d + box_k - 1) / box_k * box_k);
    if (smem <= kMaxSmem)
      return Config{kSqThreads, smem, kq,
                    p_dtype == 0 ? small_q_fn<float, kStore>(kq)
                                 : small_q_fn<__nv_bfloat16, kStore>(kq),
                    kPathSmallQ};
  }
  const bool small = nq <= 64;
  if (p_dtype == 0)
    return small ? Config{128, fma_smem_bytes<float, 64>(), 64,
                          (const void*)scores_groupmax_fma<float, 64, kStore>, kPathTile}
                 : Config{256, fma_smem_bytes<float, 128>(), 128,
                          (const void*)scores_groupmax_fma<float, 128, kStore>, kPathTile};
  return small ? Config{128, fma_smem_bytes<__nv_bfloat16, 64>(), 64,
                        (const void*)scores_groupmax_fma<__nv_bfloat16, 64, kStore>, kPathTile}
               : Config{256, fma_smem_bytes<__nv_bfloat16, 128>(), 128,
                        (const void*)scores_groupmax_fma<__nv_bfloat16, 128, kStore>, kPathTile};
}

// The blocks an SM a persistent grid launches: up to max_per_sm.
int persistent_per_sm(const Config& cfg, int blocks_per_sm) {
  const int cap = cfg.path == kPathSmallQ ? kSqMaxBlocksPerSm : kI8MaxBlocksPerSm;
  return blocks_per_sm < cap ? blocks_per_sm : cap;
}

// Resident blocks an SM of cfg (after its shared-memory attribute is set).
cudaError_t blocks_per_sm(const Config& cfg, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(cfg.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cfg.fn, cfg.threads, cfg.smem);
}

// A persistent grid (the small-Q and int8 paths): persistent_per_sm
// blocks an SM, no more blocks than tiles.
cudaError_t persistent_grid(const Config& cfg, long long tiles, int* grid) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = blocks_per_sm(cfg, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long most = static_cast<long long>(sms) * persistent_per_sm(cfg, per_sm);
  *grid = static_cast<int>(tiles < most ? tiles : most);
  return cudaSuccess;
}

cudaError_t launch_small_q(const Config& cfg, const float* q, const void* p, float* scores,
                           float* gmax, int nq, int n, int d, int group, int p_dtype,
                           cudaStream_t s) {
  alignas(64) CUtensorMap map;
  if (!encode_rows_map(&map, p, p_dtype == 1 ? 2 : 4, d, n, kSqRows))
    return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = persistent_grid(cfg, n / kSqRows, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&map, &q, &scores, &gmax, &nq, &n, &d, &group};
  err = cudaLaunchKernel(cfg.fn, dim3(grid), dim3(cfg.threads), args, cfg.smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The int8 kernel: maps of the int8 queries [Q, D] and passages [N, D]
// (boxes of kI8BM and kI8BN rows of 128 bytes) and, for kernel 2, of the
// f32 scores [Q, N] (boxes of [64 rows][32 columns]).
template <bool kStore>
cudaError_t launch_s8(const Config& cfg, const void* q, const void* p, float* scores,
                      float* gmax, int nq, int n, int d, int group, cudaStream_t s) {
  alignas(64) CUtensorMap maps[3] = {};
  if (!encode_rows_map(&maps[0], q, 1, d, nq, kI8BM) ||
      !encode_rows_map(&maps[1], p, 1, d, n, kI8BN) ||
      (kStore && !encode_rows_map(&maps[2], scores, 4, n, nq, kI8Rows)))
    return cudaErrorInvalidValue;
  const long long tiles =
      static_cast<long long>((nq + kI8BM - 1) / kI8BM) * ((n + kI8BN - 1) / kI8BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = persistent_grid(cfg, tiles, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&maps[0], &maps[1], &maps[2], &gmax, &nq, &n, &d, &group};
  err = cudaLaunchKernel(cfg.fn, dim3(grid), dim3(cfg.threads), args, cfg.smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
  const Config cfg = config<kStore>(p_dtype, nq, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(scores);
  float* gf = static_cast<float*>(gmax);
  if (cfg.path == kPathInt8)
    return static_cast<int>(launch_s8<kStore>(cfg, q, p, sf, gf, nq, n, d, group, s));
  const float* qf = static_cast<const float*>(q);
  if (cfg.path == kPathSmallQ)
    return static_cast<int>(launch_small_q(cfg, qf, p, sf, gf, nq, n, d, group, p_dtype, s));
  const long long blocks =
      static_cast<long long>((nq + cfg.rows - 1) / cfg.rows) * (n / kTileN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      cfg.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (p_dtype == 0) {
    const float* pp = static_cast<const float*>(p);
    if (cfg.rows == 64)
      scores_groupmax_fma<float, 64, kStore><<<grid, cfg.threads, cfg.smem, s>>>(
          qf, pp, sf, gf, nq, n, d, group);
    else
      scores_groupmax_fma<float, 128, kStore><<<grid, cfg.threads, cfg.smem, s>>>(
          qf, pp, sf, gf, nq, n, d, group);
  } else {
    const __nv_bfloat16* pp = static_cast<const __nv_bfloat16*>(p);
    if (cfg.rows == 64)
      scores_groupmax_fma<__nv_bfloat16, 64, kStore><<<grid, cfg.threads, cfg.smem, s>>>(
          qf, pp, sf, gf, nq, n, d, group);
    else
      scores_groupmax_fma<__nv_bfloat16, 128, kStore><<<grid, cfg.threads, cfg.smem, s>>>(
          qf, pp, sf, gf, nq, n, d, group);
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

// The launch configuration chosen for (p_dtype, nq, d), d as the kernel
// takes it (padded to 16 bytes of P): out[0] threads a block, out[1]
// dynamic shared memory bytes, out[2] query rows a block (the small-Q
// path: Q rounded up to a power of two), out[3] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the shared-memory
// attribute is set), out[4] the path (0 the FMA tile, 1 the small-Q TMA
// path, 2 the int8 wgmma kernel), out[5] the blocks an SM the persistent
// grids of the small-Q and int8 paths launch (0 on the tile paths: one
// block a tile).
// Returns a cudaError_t.
extern "C" int convdr_scores_groupmax_config(int p_dtype, int nq, int d, int* out) {
  if (p_dtype < 0 || p_dtype > 2 || nq <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config<true>(p_dtype, nq, d);
  int blocks = 0;
  const cudaError_t err = blocks_per_sm(cfg, &blocks);
  out[0] = cfg.threads;
  out[1] = cfg.smem;
  out[2] = cfg.rows;
  out[3] = blocks;
  out[4] = cfg.path;
  out[5] = cfg.path == kPathTile ? 0 : persistent_per_sm(cfg, blocks);
  return static_cast<int>(err);
}
