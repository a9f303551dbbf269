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
// consecutive columns ([Q, N/G]). P is f32, bf16 or int8 [N, D]. Three
// dtype paths:
//
// bf16 passages: the JAX kernel's dot runs on the MXU at
// Precision.HIGHEST on f32 queries and f32-promoted bf16 tiles
// (pallas_search.py:93-103, :352-359, :444): a split-precision product
// of bf16 passes, three on f32 x bf16 (":46": half the passes of f32 x
// f32), with the recall@100 set as its contract and ~1-ulp score
// differences (:21-27). Its counterpart here: each f32 query splits
// exactly into three bf16 parts, q = q1 + q2 + q3 (truncation: 8 bits of
// significand a part cover f32's 24; ops/fused_search.py
// bf16_query_parts makes them, [3, Q, D]); every q_part * p is exact in
// f32, and S = sum over k of the three parts' products is three bf16
// wgmma products with f32 accumulation, k-steps of 16 in order and in
// each k-step parts 1, 2, 3 in turn into one accumulator
// (hopper.cuh wgmma_bf16_parts_stage). Kernels 2, 3 and 4
// (streaming_search.cu) all issue that order, and an output's bits depend
// only on its A row, B row and the k order (the probe below, held by
// tests/test_torch_cuda.py: not on the instruction's N, the row's place in
// the 64-row tile, the column's place or the block), so scores, pass A's
// maxima and pass B's candidates agree bit for bit at every Q and group
// pruning stays exact. Against the f64 product of the same operands a
// score is within 2 D 2^-24 sum |q_k p_k|. What bounds it on an H100: at
// Q >= ~128 the three-part operations (3 x 2QND at the 989 TFLOP/s bf16
// peak, 1.22 ms at Q=512, N=524288, D=768), below that the bytes (the
// 0.8 GB block, 0.24 ms; kernel 2 adds the [Q, N] f32 scores). The design
// is the int8 kernel's (below) with bf16 operands:
//   * a persistent grid, one block an SM: a TMA producer warp and two
//     consumer warpgroups. At Q > 64, tiles of 128 queries x 256 passages,
//     a warpgroup its 64 query rows as A (m64n256: 128 f32 registers a
//     thread). At Q <= 64 (the serving search is Q=1) the roles swap: the
//     passages are A (a warpgroup two 64-row blocks of the 256-row tile)
//     and the query parts B, N = Q rounded up to 8, 16, 32 or 64, so a
//     few queries cost no tensor work for 64 (m64n8 at Q=1: 1/8 of the
//     operations of a 64-query A); the probe shows the swap keeps the bits;
//   * per stage, the three query parts' [rows x 128 bytes of k] boxes (3D
//     map of [3, Q, D], rows past Q as zeros) and the passages' [256 x 128
//     bytes] box (as stored: no copy or cast in device memory), 128-byte
//     swizzled, into a ring of 2 stages of 80 KB (Q > 64) or 3-4 of 35-56
//     KB under full / empty mbarriers that runs across tiles; all operands
//     from shared memory (wgmma's A from registers would hold a stage's 12
//     parts x 4 registers beside the 128 accumulators, past 288 threads'
//     168);
//   * the epilogue from the registers: at Q > 64 the group maxima and
//     kernel 2's TMA store rounds as the int8 kernel's; at Q <= 64 the
//     scores by st.global (8 consecutive rows of 4 queries a warp store),
//     the maxima of G = 8, 16 by shuffles, of larger G through one
//     shared-memory step across the warpgroup's warps; pass A compiles
//     the store out.
//
// f32 passages: f32 FMAs on the CUDA cores. What bounds them on an
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
//   * tiles stay k-contiguous as copied (cp.async cannot transpose); a row
//     pitch of 36 floats puts the 4 query rows and 8 passage rows a warp
//     reads at once in distinct banks, and a thread's rows are strided
//     (row = i * BM/8 + ty, col = j * 16 + tx) so they are neighbours
//     across the warp. Per 4 k a thread issues 16 LDS.128 (8 for the query
//     rows, 8 for the passage rows) for 256 FMAs, with no integer division
//     in the loop;
//   * the grid walks query tiles fastest, so the Q/BM blocks that share a
//     passage tile run together and read it from device memory once.
//
// f32 passages at Q <= 32 (kSmallQMax, Q*; the serving search is Q=1): the
// tile above would compute 64 query rows for each live one, and what
// bounds the work is bytes (the block, 0.48 ms at N=524288, D=768), so
// this path streams the block once at the lowest cost an element, in the
// same chain order:
//   * one consumer thread a passage row, holding one accumulator a query
//     (Q rounded up to a power of two, 1..32, a template instance each); k
//     is never split: each score is still the single chain above;
//   * [128 rows x 128 bytes of k] boxes (32 k) come in by TMA
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
// largest Q at which this path beat the tile path on an H100
// (convdr_torch/scripts/score_sweep.py, which chip_smoke.py runs:
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
// Epilogue (the f32 FMA tile path): the accumulator tile goes through shared memory
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
// f32 passages: f32 FMA on the CUDA cores
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
// f32 passages at Q <= kSmallQMax: one thread a passage row
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

// One 16-byte chunk of a passage row: 4 f32 k, in order.
template <typename P, int kQ>
__device__ __forceinline__ void sq_chunk(float (&acc)[kQ], const float4* q4, uint4 raw) {
  static_assert(sizeof(P) == 4, "f32 passages: bf16 takes the wgmma kernel");
  sq_fma4<kQ>(acc, q4, __uint_as_float(raw.x), __uint_as_float(raw.y), __uint_as_float(raw.z),
              __uint_as_float(raw.w));
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
// bf16 passages: the three-part bf16 wgmma product over a TMA ring
// ---------------------------------------------------------------------------
constexpr int kBfRows = 64;                    // rows of a wgmma's A: M
constexpr int kBfBM = 2 * kBfRows;             // query rows a tile at Q > kBfSmallQMax
constexpr int kBfBN = 256;                     // passage rows a tile
constexpr int kBfKBytes = 128;                 // k a stage: one 128-byte swizzled row (64 bf16)
constexpr int kBfK = kBfKBytes / 2;
constexpr int kBfParts = 3;                    // q = q1 + q2 + q3, bf16 each
constexpr int kBfConsumers = 256;              // two warpgroups
constexpr int kBfThreads = kBfConsumers + 32;  // + the TMA producer warp
constexpr int kBfMaxStages = 4;
constexpr int kBfSmallQMax = 64;               // the largest Q of the small-Q tiles

// Q > kBfSmallQMax: a tile is 128 queries x 256 passages, warpgroup w its
// query rows 64w.. (the parts as A) against all 256 passages (B; m64n256).
// A block's shared memory (from a 1024-byte aligned base): a stage holds
// the three query parts' [128][128 bytes] boxes, then the passages'
// [256][128 bytes], as TMA's 128-byte swizzle lays them; for kernel 2 two
// staging halves a warpgroup (the int8 kernel's [64][kI8StoreCols] f32
// rounds) for its TMA score stores; the full and empty barriers; 2 stages
// of 80 KB.
template <bool kStore>
struct BfTile {
  static constexpr int kPartBytes = kBfBM * kBfKBytes;
  static constexpr int kABytes = kBfParts * kPartBytes;
  static constexpr int kStageBytes = kABytes + kBfBN * kBfKBytes;
  static constexpr int kHalfBytes = kBfRows * kI8StoreCols * 4;
  static constexpr int kStagingBytes = kStore ? 2 * 2 * kHalfBytes : 0;
  static constexpr int kFit =
      (kMaxSmem - 1024 - kStagingBytes - 2 * 8 * kBfMaxStages) / kStageBytes;
  static constexpr int kRing = kFit < kBfMaxStages ? kFit : kBfMaxStages;
  static constexpr int kSmem = 1024 + kRing * kStageBytes + kStagingBytes + 2 * 8 * kRing;
  static_assert(kRing >= 2, "a ring of two stages at least");
  static_assert(kPartBytes % 1024 == 0 && kStageBytes % 1024 == 0, "1024-byte bases");
};

// Q <= kBfSmallQMax (the serving search is Q=1): the operands swap roles,
// so that no tensor work is spent on 64 query rows for a few live ones:
// the passages are A (warpgroup w: passage rows 128w.. of the 256-row
// tile, two 64-row blocks) and the queries' parts B, kNq >= Q rows (8,
// 16, 32 or 64; m64nkNq). The queries come as f32 and the consumers split
// them, stage by stage (bf16_split2: the arithmetic of bf16_query_parts),
// so that the search costs one launch. A stage holds the passages'
// [256][128 bytes] box, then the three parts' [kNq][128 bytes], then the
// queries' two f32 boxes [kNq][32 f32]; then the warps' 16-row maxima for
// the group maxima of G >= 32 ([2 warpgroups][8 16-row chunks][kNq] f32),
// and the full and empty barriers; up to 4 stages.
template <int kNq>
struct BfSmallTile {
  static constexpr int kPBytes = kBfBN * kBfKBytes;
  static constexpr int kPartBytes = kNq * kBfKBytes;
  static constexpr int kQBoxBytes = kNq * kBfKBytes;  // [kNq][32 f32]
  static constexpr int kStageBytes = kPBytes + kBfParts * kPartBytes + 2 * kQBoxBytes;
  static constexpr int kRedBytes = 2 * 8 * kNq * 4;
  static constexpr int kFit =
      (kMaxSmem - 1024 - kRedBytes - 2 * 8 * kBfMaxStages) / kStageBytes;
  static constexpr int kRing = kFit < kBfMaxStages ? kFit : kBfMaxStages;
  static constexpr int kSmem = 1024 + kRing * kStageBytes + kRedBytes + 2 * 8 * kRing;
  static_assert(kRing >= 3, "a ring of three stages at least");
  static_assert(kPartBytes % 1024 == 0 && kStageBytes % 1024 == 0, "1024-byte bases");
};

// The group maxima of a warpgroup's 64 x kN tile from its accumulator
// fragments (row 16w + g + 8r, column c0 + 8j + 2t + e), as
// i8_group_max: a group is kGJ of a thread's 8-column chunks across the
// quad's 4 lanes, lane t stores the groups k with k % 4 == t.
template <int kN, int kGJ>
__device__ __forceinline__ void bf_group_max(const float (&acc)[kN / 2], float* __restrict__ gmax,
                                             int row_base, int nq, int c0, int n, int gshift,
                                             int t) {
  constexpr int kGroups = kN / 8 / kGJ;  // groups a row of the warpgroup's tile
  const int groups_per_row = n >> gshift;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + 8 * r;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      float m = fmaxf(acc[4 * k * kGJ + 2 * r], acc[4 * k * kGJ + 2 * r + 1]);
#pragma unroll
      for (int j = k * kGJ + 1; j < (k + 1) * kGJ; ++j)
        m = fmaxf(m, fmaxf(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (row < nq) {
        if ((k & 3) == t && c0 + 8 * kGJ * k < n)
          gmax[static_cast<long long>(row) * groups_per_row + (c0 >> gshift) + k] = m;
      }
    }
  }
}

// The int8 kernel's structure with bf16 operands, at Q > kBfSmallQMax: a
// persistent grid walks the 128 x 256 tiles, query tiles fastest; thread
// 256 (the producer warp's first lane) streams each tile's three
// query-part boxes (a 3D map of [3, Q, D]; rows past Q and k past D as
// zeros) and its passage box (as stored, [N, D]) by TMA into a ring that
// runs across tiles; each consumer warpgroup issues, per stage,
// wgmma_bf16_parts_stage (hopper.cuh: 4 k-steps x parts 1, 2, 3 of
// m64n256k16, one commit group) and releases the stage before once this
// one's group is issued and that one's has landed. Epilogue from the
// registers as the int8 kernel's: the group maxima, then (kernel 2) the
// scores through the staging halves and TMA stores. Registers: the m64n256
// f32 accumulator is 128 a thread of the 168 that 288 threads leave.
template <bool kStore>
__global__ void __launch_bounds__(kBfThreads, 1)
scores_groupmax_bf16(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap p_map,
                     const __grid_constant__ CUtensorMap s_map, float* __restrict__ scores,
                     float* __restrict__ gmax, int nq, int n, int d, int group) {
  using Tl = BfTile<kStore>;
  constexpr int kRing = Tl::kRing;
  constexpr int kAcc = kBfBN / 2;  // f32 registers a thread: the 64 x 256 accumulator
  extern __shared__ __align__(16) unsigned char bf_smem[];
  unsigned char* smem = bf_smem + ((1024u - (shared_addr(bf_smem) & 1023u)) & 1023u);
  // the staging halves lie just below the barriers (found from `full` in
  // the epilogue: no pointer of its own live across the products)
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kRing * Tl::kStageBytes + Tl::kStagingBytes);
  uint64_t* empty = full + kRing;
  const int tid = threadIdx.x;
  const int q_tiles = (nq + kBfBM - 1) / kBfBM;
  const int tiles = q_tiles * ((n + kBfBN - 1) / kBfBN);
  const int nk = (d + kBfK - 1) / kBfK;

  if (tid == kBfConsumers) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kBfConsumers / 32);  // each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kBfConsumers) {  // the producer
    if (tid == kBfConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % q_tiles) * kBfBM;
        const int n0 = (tile / q_tiles) * kBfBN;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % kRing;
          if (it >= kRing) mbar_wait(empty + s, (it / kRing - 1) & 1);
          unsigned char* st = smem + s * Tl::kStageBytes;
          mbar_arrive_expect_tx(full + s, Tl::kStageBytes);
#pragma unroll
          for (int part = 0; part < kBfParts; ++part)
            tma_load_3d(st + part * Tl::kPartBytes, &q_map, full + s, kc * kBfK, m0, part);
          tma_load_2d(st + Tl::kABytes, &p_map, full + s, kc * kBfK, n0);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int lane = tid % 32;
  const uint32_t a_base = shared_addr(smem) + wg * kBfRows * kBfKBytes;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[kAcc];
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % kRing;
      mbar_wait(full + s, (it / kRing) & 1);
      const uint32_t st = a_base + s * Tl::kStageBytes;
      wgmma_fence();
      wgmma_bf16_parts_stage<kBfBN, (Tl::kPartBytes >> 4), 0>(
          acc, wgmma_desc(st, kBfKBytes),
          wgmma_desc(st - wg * kBfRows * kBfKBytes + Tl::kABytes, kBfKBytes), kc == 0);
      wgmma_commit();
      if (kc > 0) {  // the previous stage's products have landed: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + (it - 1) % kRing);
      }
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + (it - 1) % kRing);
    // the epilogue's values, from here on only (fewer registers live across
    // the products)
    const int n0 = (tile / q_tiles) * kBfBN;
    const int row0 = (tile % q_tiles) * kBfBM + kBfRows * wg;  // this warpgroup's first row
    if (row0 >= nq) continue;  // warpgroup-uniform: none of its rows is a query
    const int wtid = tid % 128;
    const int warp = wtid / 32;  // rows 16 warp + g, + 8 of the warpgroup's 64
    const int g = lane / 4;
    const int t = lane % 4;
    const int gj = group >> 3;  // 8-column chunks a group: 1..16
    const int gshift = __ffs(group) - 1;
    const int row_base = row0 + 16 * warp + g;
    switch (gj) {
      case 1: bf_group_max<kBfBN, 1>(acc, gmax, row_base, nq, n0, n, gshift, t); break;
      case 2: bf_group_max<kBfBN, 2>(acc, gmax, row_base, nq, n0, n, gshift, t); break;
      case 4: bf_group_max<kBfBN, 4>(acc, gmax, row_base, nq, n0, n, gshift, t); break;
      case 8: bf_group_max<kBfBN, 8>(acc, gmax, row_base, nq, n0, n, gshift, t); break;
      default: bf_group_max<kBfBN, 16>(acc, gmax, row_base, nq, n0, n, gshift, t); break;
    }

    if constexpr (kStore) {
      // the int8 kernel's rounds: kI8StoreCols columns into one of the two
      // staging halves once the stores of the round before last have read
      // it, then 2 TMA stores; rows past Q and columns past N not written.
      // This thread's float2 at row 16 warp + g and 8-column chunk c of a
      // [64][32] f32 box lies at sw + 32 * (c ^ g / 2)
      unsigned char* my_staging = reinterpret_cast<unsigned char*>(full) - Tl::kStagingBytes +
                                  wg * (Tl::kStagingBytes / 2);
      const int sw = (16 * warp + g) * 128 + 16 * ((t / 2) ^ (g & 1)) + 8 * (t & 1);
      const int gh = g >> 1;
#pragma unroll
      for (int c0 = 0; c0 < kBfBN; c0 += kI8StoreCols) {
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
                make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
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
    if (tid % 128 == 0) tma_store_wait_read<0>();  // the staging outlives its reads
  }
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

// One 64-row passage block of a small-Q tile (accumulator fragments: row
// 16w + g + 8r of the block, query column 8j + 2t + e), rows c0 + row in
// the scores: kernel 2's scores (4 bytes a thread; a warp's store covers
// 8 consecutive rows of 4 queries), and the group maxima of G = 8 and 16
// directly (the max over the 8 lanes of a quad position, then over r);
// for G >= 32 the warp's 16-row maxima go to red[chunk][kNq] for the
// warpgroup to combine.
template <int kNq, bool kStore>
__device__ __forceinline__ void bf_small_block(const float (&acc)[kNq / 2],
                                               float* __restrict__ scores,
                                               float* __restrict__ gmax, float* red, int nq,
                                               int n, int c0, int warp, int g, int t,
                                               int group, int gshift) {
  const int groups_per_row = n >> gshift;
#pragma unroll
  for (int j = 0; j < kNq / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 8 * j + 2 * t + e;
      float m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = acc[4 * j + 2 * r + e];
        if constexpr (kStore) {
          if (q < nq) scores[static_cast<long long>(q) * n + c0 + 16 * warp + 8 * r + g] = v;
        }
        m[r] = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 8));
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 16));
      }
      if (g == 0) {
        if (group == 8) {
          if (q < nq) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
              gmax[static_cast<long long>(q) * groups_per_row + ((c0 + 16 * warp + 8 * r) >> 3)] =
                  m[r];
          }
        } else if (group == 16) {
          if (q < nq)
            gmax[static_cast<long long>(q) * groups_per_row + ((c0 + 16 * warp) >> 4)] =
                fmaxf(m[0], m[1]);
        } else {
          red[warp * kNq + q] = fmaxf(m[0], m[1]);
        }
      }
    }
  }
}

// bf16 passages at Q <= kBfSmallQMax: as scores_groupmax_bf16 with the
// roles swapped (BfSmallTile): a persistent grid walks the 256-row passage
// tiles; per stage each warpgroup issues, for each of its two 64-row
// passage blocks, wgmma_bf16_parts_stage with the passages as A and the
// query parts as B (m64nkNq: the same k order, parts 1, 2, 3 each k-step,
// so the same bits as the Q > 64 tiles); the ring, its barriers and the
// release of a stage are the int8 kernel's. Epilogue from the registers
// (bf_small_block), then for G >= 32 the warpgroup combines its warps'
// 16-row maxima (G / 16 of them a group) through shared memory.
template <bool kStore, int kNq>
__global__ void __launch_bounds__(kBfThreads, 1)
scores_groupmax_bf16_small_q(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap p_map,
                             const __grid_constant__ CUtensorMap s_map,
                             float* __restrict__ scores, float* __restrict__ gmax, int nq, int n,
                             int d, int group) {
  using Tl = BfSmallTile<kNq>;
  constexpr int kRing = Tl::kRing;
  extern __shared__ __align__(16) unsigned char bf_smem[];
  unsigned char* smem = bf_smem + ((1024u - (shared_addr(bf_smem) & 1023u)) & 1023u);
  float* red = reinterpret_cast<float*>(smem + kRing * Tl::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing * Tl::kStageBytes + Tl::kRedBytes);
  uint64_t* empty = full + kRing;
  const int tid = threadIdx.x;
  const int tiles = (n + kBfBN - 1) / kBfBN;
  const int nk = (d + kBfK - 1) / kBfK;

  if (tid == kBfConsumers) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kBfConsumers / 32);  // each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kBfConsumers) {  // the producer
    if (tid == kBfConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % kRing;
          if (it >= kRing) mbar_wait(empty + s, (it / kRing - 1) & 1);
          unsigned char* st = smem + s * Tl::kStageBytes;
          unsigned char* qf = st + Tl::kPBytes + kBfParts * Tl::kPartBytes;
          mbar_arrive_expect_tx(full + s, Tl::kPBytes + 2 * Tl::kQBoxBytes);
          tma_load_2d(st, &p_map, full + s, kc * kBfK, tile * kBfBN);
          tma_load_2d(qf, &q_map, full + s, kc * kBfK, 0);
          tma_load_2d(qf + Tl::kQBoxBytes, &q_map, full + s, kc * kBfK + 32, 0);
        }
    }
    return;
  }

  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int gshift = __ffs(group) - 1;
  const uint32_t base = shared_addr(smem);
  float* my_red = red + wg * 8 * kNq;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int c0 = tile * kBfBN + 128 * wg;  // this warpgroup's first passage row
    float acc0[kNq / 2], acc1[kNq / 2];
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % kRing;
      mbar_wait(full + s, (it / kRing) & 1);
      // the queries' parts of this stage, half the 16-byte f32 chunks (4 k
      // of a row) a warpgroup: chunk c4 of row r of the two swizzled boxes
      // into 8 bytes of each part's swizzled row; then both warpgroups'
      // parts before either's products
      unsigned char* parts = smem + s * Tl::kStageBytes + Tl::kPBytes;
      const unsigned char* qf = parts + kBfParts * Tl::kPartBytes;
      for (int c = tid; c < kNq * 16; c += kBfConsumers) {
        const int r = c >> 4;
        const int c4 = c & 15;
        const float4 v = *reinterpret_cast<const float4*>(
            qf + (c4 >> 3) * Tl::kQBoxBytes + swizzled_chunk_offset(r, c4 & 7, kBfKBytes));
        uint32_t lo[3], hi[3];
        bf16_split2(v.x, v.y, lo);
        bf16_split2(v.z, v.w, hi);
        const int at = swizzled_chunk_offset(r, c4 >> 1, kBfKBytes) + 8 * (c4 & 1);
#pragma unroll
        for (int part = 0; part < kBfParts; ++part)
          *reinterpret_cast<uint2*>(parts + part * Tl::kPartBytes + at) =
              make_uint2(lo[part], hi[part]);
      }
      fence_shared_to_async();
      named_barrier(3, kBfConsumers);  // 1 and 2 are the warpgroups' own
      const uint32_t st = base + s * Tl::kStageBytes;
      const uint64_t da = wgmma_desc(st + wg * 128 * kBfKBytes, kBfKBytes);
      const uint64_t db = wgmma_desc(st + Tl::kPBytes, kBfKBytes);
      wgmma_fence();
      wgmma_bf16_parts_stage<kNq, 0, (Tl::kPartBytes >> 4), 0>(acc0, da, db, kc == 0);
      wgmma_bf16_parts_stage<kNq, 0, (Tl::kPartBytes >> 4), (kBfRows * kBfKBytes >> 4)>(
          acc1, da, db, kc == 0);
      wgmma_commit();
      if (kc > 0) {  // the previous stage's products have landed: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + (it - 1) % kRing);
      }
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc0);
    wgmma_fence_regs(acc1);
    if (lane == 0) mbar_arrive(empty + (it - 1) % kRing);
    if (c0 >= n) continue;  // warpgroup-uniform: the second half of a last tile of 128 rows

    bf_small_block<kNq, kStore>(acc0, scores, gmax, my_red, nq, n, c0, warp, g, t, group,
                                gshift);
    bf_small_block<kNq, kStore>(acc1, scores, gmax, my_red + 4 * kNq, nq, n, c0 + kBfRows, warp,
                                g, t, group, gshift);
    if (group >= 32) {  // the warpgroup's G / 16 chunks a group
      named_barrier(1 + wg, 128);
      const int chunks = group >> 4;
      const int groups = 128 >> gshift;
      for (int i = wtid; i < groups * kNq; i += 128) {
        const int k = i / kNq;
        const int q = i - k * kNq;
        float m = my_red[k * chunks * kNq + q];
        for (int c = 1; c < chunks; ++c) m = fmaxf(m, my_red[(k * chunks + c) * kNq + q]);
        if (q < nq) gmax[static_cast<long long>(q) * (n >> gshift) + (c0 >> gshift) + k] = m;
      }
      named_barrier(1 + wg, 128);  // red is free for the next tile
    }
  }
}

// ---------------------------------------------------------------------------
// the probe of the bf16 wgmma's bits
// ---------------------------------------------------------------------------
// One warpgroup a block, every block the same problem, stage by stage over
// k (64 a stage, zeros past D): A holds rows a[part][i] (three parts of 64
// rows, [3][64][D]) at tile row (i + a_shift) % 64, B rows b[part][r] (r <
// kN, [3][256][D]) at tile row (r + b_shift) % kN, both written by the
// threads in the layout TMA's 128-byte swizzle gives. swap 0: the
// three-part product of the kernels above (wgmma_bf16_parts_stage: A's
// parts, B's part 0); kSwap: A's part 0 (a 64-row tile of passages) times
// B's three parts (query parts as B), each k-step's parts in the same
// order. out[block][64][kN] holds the accumulator by tile row and column
// (row 16w + g + 8r, column 8j + 2t + e), so that a test can read off
// whether an output's bits depend on anything but its A row, its B row and
// the k order (tests/test_torch_cuda.py).
constexpr int kProbeAPart = 64 * kBfKBytes;
constexpr int kProbeBPart = 256 * kBfKBytes;
constexpr int kProbeSmem = 1024 + kBfParts * (kProbeAPart + kProbeBPart);

template <int kN, bool kSwap>
__global__ void __launch_bounds__(128, 1)
wgmma_bf16_probe(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                 float* __restrict__ out, int d, int a_shift, int b_shift) {
  extern __shared__ __align__(16) unsigned char pr_smem[];
  unsigned char* smem = pr_smem + ((1024u - (shared_addr(pr_smem) & 1023u)) & 1023u);
  unsigned char* as = smem;
  unsigned char* bs = smem + kBfParts * kProbeAPart;
  const int tid = threadIdx.x;
  const int nk = (d + kBfK - 1) / kBfK;
  float acc[kN / 2];
  for (int kc = 0; kc < nk; ++kc) {
    for (int c = tid; c < kBfParts * 64 * 8; c += 128) {  // 16-byte chunks of A
      const int part = c / 512, i = (c / 8) % 64, ch = c % 8, k = kc * kBfK + 8 * ch;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < d) v = *reinterpret_cast<const uint4*>(a + (static_cast<long long>(part) * 64 + i) * d + k);
      *reinterpret_cast<uint4*>(as + part * kProbeAPart +
                                swizzled_chunk_offset((i + a_shift) % 64, ch, kBfKBytes)) = v;
    }
    for (int c = tid; c < kBfParts * kN * 8; c += 128) {  // 16-byte chunks of B
      const int part = c / (8 * kN), r = (c / 8) % kN, ch = c % 8, k = kc * kBfK + 8 * ch;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < d) v = *reinterpret_cast<const uint4*>(b + (static_cast<long long>(part) * 256 + r) * d + k);
      *reinterpret_cast<uint4*>(bs + part * kProbeBPart +
                                swizzled_chunk_offset((r + b_shift) % kN, ch, kBfKBytes)) = v;
    }
    fence_shared_to_async();
    __syncthreads();
    const uint64_t da = wgmma_desc(shared_addr(as), kBfKBytes);
    const uint64_t db = wgmma_desc(shared_addr(bs), kBfKBytes);
    wgmma_fence();
    if constexpr (!kSwap)
      wgmma_bf16_parts_stage<kN, (kProbeAPart >> 4), 0>(acc, da, db, kc == 0);
    else
      wgmma_bf16_parts_stage<kN, 0, (kProbeBPart >> 4)>(acc, da, db, kc == 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    __syncthreads();  // the tiles are rewritten next stage
  }
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float* o = out + static_cast<long long>(blockIdx.x) * 64 * kN;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[(16 * warp + g + 8 * r) * kN + 8 * j + 2 * t + e] = acc[4 * j + 2 * r + e];
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Config {
  int threads, smem, rows;  // block threads, dynamic shared bytes, query rows a block
  const void* fn;
  int path;                 // kPathTile, kPathSmallQ, kPathInt8 or kPathBf16
};
constexpr int kPathTile = 0, kPathSmallQ = 1, kPathInt8 = 2, kPathBf16 = 3;

template <bool kStore>
const void* small_q_fn(int kq) {
  switch (kq) {
    case 1: return (const void*)scores_groupmax_small_q<float, 1, kStore>;
    case 2: return (const void*)scores_groupmax_small_q<float, 2, kStore>;
    case 4: return (const void*)scores_groupmax_small_q<float, 4, kStore>;
    case 8: return (const void*)scores_groupmax_small_q<float, 8, kStore>;
    case 16: return (const void*)scores_groupmax_small_q<float, 16, kStore>;
    default: return (const void*)scores_groupmax_small_q<float, kSmallQMax, kStore>;
  }
}

// int8 and bf16 passages take their wgmma kernels at every Q (bf16: the
// small-Q tiles up to kBfSmallQMax, queries rounded up to 8, 16, 32 or
// 64). f32 passages take the small-Q path
// at Q <= kSmallQMax when its queries fit in shared memory beside the ring
// (D <= 1408 at Q = 17..32; the tile path takes larger D).
template <bool kStore>
Config config(int p_dtype, int nq, int d) {
  if (p_dtype == 2) {
    return Config{kI8Threads, I8Tile<kStore>::kSmem, kI8BM,
                  (const void*)scores_groupmax_s8<kStore>, kPathInt8};
  }
  if (p_dtype == 1) {
    if (nq > kBfSmallQMax)
      return Config{kBfThreads, BfTile<kStore>::kSmem, kBfBM,
                    (const void*)scores_groupmax_bf16<kStore>, kPathBf16};
    switch (nq <= 8 ? 8 : nq <= 16 ? 16 : nq <= 32 ? 32 : 64) {
      case 8: return Config{kBfThreads, BfSmallTile<8>::kSmem, 8,
                            (const void*)scores_groupmax_bf16_small_q<kStore, 8>, kPathBf16};
      case 16: return Config{kBfThreads, BfSmallTile<16>::kSmem, 16,
                             (const void*)scores_groupmax_bf16_small_q<kStore, 16>, kPathBf16};
      case 32: return Config{kBfThreads, BfSmallTile<32>::kSmem, 32,
                             (const void*)scores_groupmax_bf16_small_q<kStore, 32>, kPathBf16};
      default: return Config{kBfThreads, BfSmallTile<64>::kSmem, 64,
                             (const void*)scores_groupmax_bf16_small_q<kStore, 64>, kPathBf16};
    }
  }
  if (nq <= kSmallQMax) {
    const int kq = sq_bucket(nq);
    const int smem = sq_smem_bytes(kq, (d + 31) / 32 * 32);
    if (smem <= kMaxSmem) return Config{kSqThreads, smem, kq, small_q_fn<kStore>(kq), kPathSmallQ};
  }
  return nq <= 64 ? Config{128, fma_smem_bytes<float, 64>(), 64,
                           (const void*)scores_groupmax_fma<float, 64, kStore>, kPathTile}
                  : Config{256, fma_smem_bytes<float, 128>(), 128,
                           (const void*)scores_groupmax_fma<float, 128, kStore>, kPathTile};
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

// A persistent grid (the small-Q, int8 and bf16 paths): persistent_per_sm
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
                           float* gmax, int nq, int n, int d, int group, cudaStream_t s) {
  alignas(64) CUtensorMap map;
  if (!encode_rows_map(&map, p, 4, d, n, kSqRows)) return cudaErrorInvalidValue;
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

// The bf16 kernels: maps of the queries (Q > kBfSmallQMax: their parts [3,
// Q, D], boxes of one part's 128 rows x 128 bytes of k; else the f32 [Q,
// D], boxes of kNq rows x 32 f32) and the passages [N, D] (boxes of kBfBN
// rows) and, for kernel 2 at Q > kBfSmallQMax, of the f32 scores [Q, N]
// (boxes of [64 rows][32 columns]).
template <bool kStore>
cudaError_t launch_bf16(const Config& cfg, const void* q, const void* p, float* scores,
                        float* gmax, int nq, int n, int d, int group, cudaStream_t s) {
  const bool small = nq <= kBfSmallQMax;
  alignas(64) CUtensorMap maps[3] = {};
  if (!(small ? encode_rows_map(&maps[0], q, 4, d, nq, cfg.rows)
              : encode_parts_map(&maps[0], q, kBfParts, d, nq, cfg.rows)) ||
      !encode_rows_map(&maps[1], p, 2, d, n, kBfBN) ||
      (kStore && !small && !encode_rows_map(&maps[2], scores, 4, n, nq, kBfRows)))
    return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>(small ? 1 : (nq + kBfBM - 1) / kBfBM) *
                          ((n + kBfBN - 1) / kBfBN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = persistent_grid(cfg, tiles, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&maps[0], &maps[1], &maps[2], &scores, &gmax, &nq, &n, &d, &group};
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
  if (cfg.path == kPathBf16)
    return static_cast<int>(launch_bf16<kStore>(cfg, q, p, sf, gf, nq, n, d, group, s));
  const float* qf = static_cast<const float*>(q);
  if (cfg.path == kPathSmallQ)
    return static_cast<int>(launch_small_q(cfg, qf, p, sf, gf, nq, n, d, group, s));
  const long long blocks =
      static_cast<long long>((nq + cfg.rows - 1) / cfg.rows) * (n / kTileN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      cfg.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks));
  const float* pp = static_cast<const float*>(p);
  if (cfg.rows == 64)
    scores_groupmax_fma<float, 64, kStore><<<grid, cfg.threads, cfg.smem, s>>>(
        qf, pp, sf, gf, nq, n, d, group);
  else
    scores_groupmax_fma<float, 128, kStore><<<grid, cfg.threads, cfg.smem, s>>>(
        qf, pp, sf, gf, nq, n, d, group);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSwap>
cudaError_t launch_probe(int n_inst, const void* a, const void* b, float* out, int blocks, int d,
                         int a_shift, int b_shift, cudaStream_t s) {
  const void* fn;
  switch (n_inst) {
    case 8: fn = (const void*)wgmma_bf16_probe<8, kSwap>; break;
    case 16: fn = (const void*)wgmma_bf16_probe<16, kSwap>; break;
    case 32: fn = (const void*)wgmma_bf16_probe<32, kSwap>; break;
    case 64: fn = (const void*)wgmma_bf16_probe<64, kSwap>; break;
    case 128: fn = (const void*)wgmma_bf16_probe<128, kSwap>; break;
    case 256: fn = (const void*)wgmma_bf16_probe<256, kSwap>; break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kProbeSmem);
  if (err != cudaSuccess) return err;
  void* args[] = {&a, &b, &out, &d, &a_shift, &b_shift};
  err = cudaLaunchKernel(fn, dim3(blocks), dim3(128), args, kProbeSmem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// q: f32 [Q, D] row-major for p_dtype 0 (float32 passages) and for 1
// (bfloat16) at Q <= 64 (the kernel splits them); the three bf16 parts [3,
// Q, D] of the f32 queries (ops/fused_search.py bf16_query_parts) for 1 at
// Q > 64; int8 [Q, D] for 2 (int8, the int-valued queries of
// quantize_queries). p [N, D] row-major. D a multiple of 4 / 8 / 16 (16
// bytes of P), both operands 16-byte aligned. group in {8, 16, 32, 64,
// 128}; n % 128 == 0. Returns a cudaError_t (0 = launched).
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
// dynamic shared memory bytes, out[2] query rows a block (the f32 small-Q
// path: Q rounded up to a power of two; bf16 up to Q=64: Q rounded up to
// 8, 16, 32 or 64), out[3] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the shared-memory
// attribute is set), out[4] the path (0 the f32 FMA tile, 1 the f32 small-Q
// TMA path, 2 the int8 wgmma kernel, 3 the bf16 three-part wgmma kernel),
// out[5] the blocks an SM the persistent grids of paths 1-3 launch (0 on
// the tile path: one block a tile).
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

// The probe of the bf16 wgmma's bits (wgmma_bf16_probe): `blocks` blocks
// of the same problem, a [3, 64, d] and b [3, 256, d] bf16 (d a multiple
// of 8, 16-byte aligned), out [blocks, 64, n_inst] f32; n_inst (the
// instruction's N) in {8, 16, 32, 64, 128, 256}; swap 0 the kernels'
// three-part product, 1 the query parts as B. Returns a cudaError_t.
extern "C" int convdr_wgmma_bf16_probe(const void* a, const void* b, void* out, int blocks,
                                       int n_inst, int d, int a_shift, int b_shift, int swap,
                                       void* stream) {
  if (blocks <= 0 || d <= 0 || d % 8 != 0 || a_shift < 0 || b_shift < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  return static_cast<int>(swap ? launch_probe<true>(n_inst, a, b, o, blocks, d, a_shift, b_shift, s)
                               : launch_probe<false>(n_inst, a, b, o, blocks, d, a_shift, b_shift, s));
}
