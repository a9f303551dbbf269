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
// dtype paths, each on the tensor cores:
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
// f32 passages: the JAX kernel's dot at Precision.HIGHEST on f32 x f32,
// which the MXU computes as six bf16 passes (":46": f32 x bf16 "needs half
// the MXU passes of f32 x f32"), with the same recall@100 contract. Its
// counterpart here: each f32 operand splits exactly into three bf16 parts
// (x = x1 + x2 + x3, bf16_query_parts' truncation; exact for |x| >= 2^-110
// and for 0), and a score is the sum over k of the six products q_i p_j
// with i + j <= 4: (1,1), (1,2), (2,1), (1,3), (2,2), (3,1), each exact in
// f32, as six bf16 wgmma products a k-step in that order (hopper.cuh
// wgmma_f32_parts_stage). The dropped (2,3), (3,2), (3,3) are below 2^-20
// sum |q_k p_k| (|x2| < 2^-7 |x|, |x3| < 2^-14 |x|). (1,1) has a sum of
// its own and the five small products share a second, added round to
// nearest at the end: with one sum, six truncating tensor-core adds a
// k-step broke the f32 tolerance of 1e-5 |q| max|p| on long one-signed
// sums (near-parallel positive rows) on an H100; two sums hold it. A score
// is within 2 D 2^-24 sum |q_k p_k| of the f64 product. Kernels 2, 3 and 4
// (streaming_search.cu) issue the same products in the same order into
// the same two sums at every Q, and an output's bits depend only on its A
// row, B row and the k order (the probe below), so scores, pass A's
// maxima and pass B's candidates agree bit for bit and group pruning stays
// exact. The queries' parts come from the wrapper above Q=16 ([3, Q, D8])
// and are split by the kernel up to it; the passages are split in the
// kernel from the f32 boxes TMA brings (the block stays stored as it is,
// and no parts reach device memory: a pre-pass would move 16 bytes an
// element for 4). What bounds it on an H100: at Q >= ~64 the six-part
// operations (6 x 2QND at the 989 TFLOP/s bf16 peak, 2.50 ms at Q=512,
// N=524288, D=768), below that the bytes (the 1.6 GB block, 0.48 ms;
// kernel 2 adds the [Q, N] f32 scores). The design keeps the bf16
// kernel's persistent grid, TMA producer warp and two consumer
// warpgroups, with the passages as wgmma's A at every Q, so that each
// warpgroup's products depend on its own split alone (with the queries
// as A both warpgroups need every passage row's parts as B, and the
// barrier between the two halves of the split was slower on the card):
//   * Q > 64: tiles of 128 queries x 128 passages, 32 k a stage (the
//     query parts' [128][64 bytes] boxes by a 3D map of [3, Q, D8],
//     64-byte swizzle, and the f32 passage box [128][128 bytes], 128-byte
//     swizzle), a ring of 4 stages of 40 KB; warpgroup w splits its 64
//     passage rows into one of two part buffers of its own (64-byte rows
//     in the 64-byte swizzle's layout) and issues m64n128 with them as A
//     and the stage's query parts as B (the two sums: 128 registers of
//     the 168 that 288 threads leave);
//   * Q <= 64 (the serving search is Q=1): tiles of 128 passages; each
//     thread reads its A fragments' f32 values and splits them in
//     registers (no passage part touches shared memory: as shared-memory A
//     tiles, read six times a k-step, they made shared memory the limit on
//     an H100); m64nN with N = Q rounded up to 8, 16, 32 or 64. Up to Q=16
//     the queries' f32 box comes beside the passages' in each stage and
//     each warpgroup splits it into one of two buffers of its own and
//     releases the stage at once, so the ring (up to 6 stages) holds only
//     loads in flight; from Q=17 the wrapper's query parts come by TMA
//     (that split and its barriers cost more there than the wrapper's
//     six tensor ops);
//   * the epilogue from the registers after the two sums are added: the
//     scores by st.global (8 consecutive rows of 4 queries a warp store;
//     at Q > 64 this beat the bf16 kernel's TMA-store rounds on the card),
//     the group maxima of G = 8, 16 by shuffles, of larger G through one
//     shared-memory step across the warps; pass A compiles the store out.
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
// N must be a multiple of 128 (the callers pad rows). The wrapper passes D
// padded with zero columns to a multiple of 16 bytes' worth of elements
// (4 f32, 8 bf16, 16 int8) and 16-byte aligned operands; zeros after the
// last k leave every score as it was.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kRowTile = 128;         // N is a multiple of it (the callers pad rows)
constexpr int kMaxSmem = 227 * 1024;  // a block's dynamic shared memory

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
// f32 passages: the six-part bf16 wgmma product over a TMA ring
// ---------------------------------------------------------------------------
constexpr int kF32Rows = 64;                 // rows of a wgmma's A: M
constexpr int kF32BM = 2 * kF32Rows;         // query rows a tile at Q > kF32SmallQMax
constexpr int kF32BN = 128;                  // passage rows a tile
constexpr int kF32K = 32;                    // k a stage: a 128-byte f32 row, a 64-byte part row
constexpr int kF32BoxRow = 4 * kF32K;        // bytes of an f32 box row (the 128-byte swizzle)
constexpr int kF32PartRow = 2 * kF32K;       // bytes of a bf16 part row (the 64-byte swizzle)
constexpr int kF32MaxStages = 6;
constexpr int kF32SmallQMax = 64;            // the largest Q of the small-Q tiles
constexpr int kF32SplitQMax = 16;            // the largest Q whose queries the kernel splits

// Q <= kF32SmallQMax (the serving search is Q=1): the passages are A
// (warpgroup w: passage rows 64w.. of the 128-row tile), from registers,
// and the queries' parts B, kNq >= Q rows (8, 16, 32 or 64; m64nkNq). A
// stage holds what TMA brings: the passages' f32 [128][128 bytes] box,
// then at Q <= kF32SplitQMax the queries' f32 [kNq][128 bytes], above it
// their three parts [kNq][64 bytes] (a 3D map of the wrapper's [3, Q,
// D8]). Each thread reads its A fragments' f32 values from the box and
// splits them in registers, so no passage part touches shared memory (its
// parts as shared-memory A tiles, read six times a k-step, made shared
// memory the limit on an H100). Up to kF32SplitQMax each warpgroup splits
// the queries into one of two buffers of its own, in turn ([kNq][64
// bytes] a part, at least 1 KB), and releases the stage at once, so the
// ring holds only loads in flight; above it that split and its barriers
// cost more on an H100 than the wrapper's six tensor ops, and a stage is
// released once its products have landed. Then the warps' 16-row maxima for the group maxima of G >= 32
// ([8 16-row chunks of the tile][kNq] f32), and the barriers.
template <int kNq>
struct F32SmallTile {
  static constexpr bool kSplitQ = kNq <= kF32SplitQMax;
  static constexpr int kPBox = kF32BN * kF32BoxRow;
  static constexpr int kQPart = kNq * kF32PartRow < 1024 ? 1024 : kNq * kF32PartRow;
  static constexpr int kStageBytes = kPBox + (kSplitQ ? kNq * kF32BoxRow : 3 * kQPart);
  static constexpr int kQBufBytes = 3 * kQPart;
  static constexpr int kPartsBytes = kSplitQ ? 2 * 2 * kQBufBytes : 0;
  static constexpr int kRedBytes = 8 * kNq * 4;
  static constexpr int kFit =
      (kMaxSmem - 1024 - kPartsBytes - kRedBytes - 2 * 8 * kF32MaxStages) / kStageBytes;
  static constexpr int kRing = kFit < kF32MaxStages ? kFit : kF32MaxStages;
  static constexpr int kSmem =
      1024 + kRing * kStageBytes + kPartsBytes + kRedBytes + 2 * 8 * kRing;
  static_assert(kRing >= 4, "a ring of four stages at least");
  static_assert(kStageBytes % 1024 == 0 && kQBufBytes % 1024 == 0, "1024-byte bases");
};

// The group maxima of G >= 32 of a 128-row passage tile whose first row is
// row0, from the warps' 16-row maxima red[chunk][kNq] (chunk 4 wg + warp,
// as bf_small_block leaves them): G / 16 chunks a group, combined by the
// two consumer warpgroups (named barrier 3) for queries q < nq of gmax.
template <int kNq>
__device__ __forceinline__ void combine_chunk_maxima(const float* red, float* __restrict__ gmax,
                                                     int nq, int n, int row0, int group,
                                                     int gshift, int tid) {
  named_barrier(3, kBfConsumers);
  const int chunks = group >> 4;
  const int groups = kF32BN >> gshift;
  for (int i = tid; i < groups * kNq; i += kBfConsumers) {
    const int k = i / kNq;
    const int q = i - k * kNq;
    float m = red[k * chunks * kNq + q];
    for (int c = 1; c < chunks; ++c) m = fmaxf(m, red[(k * chunks + c) * kNq + q]);
    if (q < nq) gmax[static_cast<long long>(q) * (n >> gshift) + (row0 >> gshift) + k] = m;
  }
  named_barrier(3, kBfConsumers);  // red is free for the next tile
}

// f32 passages at Q <= kF32SmallQMax (F32SmallTile): a persistent grid
// walks the 128-row passage tiles, the producer streams each tile's f32
// passage box and the queries' box (or parts) by TMA. Each stage, each
// thread reads its A values (rows 16 warp + g, + 8 of its warpgroup's 64,
// both k-steps); up to kF32SplitQMax the warpgroup (once its warps are
// past the products that read its next query buffer) splits the kNq query
// rows into it (bf16_split2: the arithmetic of bf16_query_parts, so the
// wrapper's parts above it) and releases the stage; then each k-step, the
// thread splits its values into
// the three parts' fragments and the warpgroup issues
// wgmma_f32_parts_rs_kstep (m64nkNq, the passage parts as A from
// registers and the query parts as B: the products of the Q > 64 tiles in
// the same order into the same two sums, so the same bits). The two
// k-steps' fragments alternate in f0 and f1, each kept (pin_fragment)
// until its products have landed, so the next k-step's split overlaps
// them. Epilogue from the registers: the sums added, then bf_small_block
// (kernel 2's scores by st.global, the group maxima of G = 8, 16 by
// shuffles), and for G >= 32 the block combines the warps' 16-row maxima
// (G / 16 of them a group) through shared memory.
template <bool kStore, int kNq>
__global__ void __launch_bounds__(kBfThreads, 1)
scores_groupmax_f32_small_q(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap p_map,
                            const __grid_constant__ CUtensorMap s_map,
                            float* __restrict__ scores, float* __restrict__ gmax, int nq, int n,
                            int d, int group) {
  using Tl = F32SmallTile<kNq>;
  constexpr int kRing = Tl::kRing;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  unsigned char* smem = f32_smem + ((1024u - (shared_addr(f32_smem) & 1023u)) & 1023u);
  unsigned char* qparts = smem + kRing * Tl::kStageBytes;
  float* red = reinterpret_cast<float*>(qparts + Tl::kPartsBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(qparts + Tl::kPartsBytes + Tl::kRedBytes);
  uint64_t* empty = full + kRing;
  const int tid = threadIdx.x;
  const int tiles = n / kF32BN;
  const int nk = (d + kF32K - 1) / kF32K;

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
          mbar_arrive_expect_tx(full + s, Tl::kStageBytes);
          tma_load_2d(st, &p_map, full + s, kc * kF32K, tile * kF32BN);
          if constexpr (Tl::kSplitQ) {
            tma_load_2d(st + Tl::kPBox, &q_map, full + s, kc * kF32K, 0);
          } else {
#pragma unroll
            for (int part = 0; part < 3; ++part)
              tma_load_3d(st + Tl::kPBox + part * Tl::kQPart, &q_map, full + s, kc * kF32K, 0,
                          part);
          }
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
  const int arow = kF32Rows * wg + 16 * warp + g;  // this thread's A rows: arow, arow + 8
  unsigned char* my_q = qparts + wg * 2 * Tl::kQBufBytes;  // (kSplitQ: its query buffers)
  uint32_t f0[3][4], f1[3][4];  // the two k-steps' A fragments, three parts each
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float big[kNq / 2], small[kNq / 2];
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % kRing;
      mbar_wait(full + s, (it / kRing) & 1);
      const unsigned char* st = smem + s * Tl::kStageBytes;
      float2 v0[4], v1[4];
      load_f32_fragment(st, arow, 0, t, v0);
      load_f32_fragment(st, arow, 1, t, v1);
      uint64_t db;  // the stage's query parts
      if constexpr (Tl::kSplitQ) {
        // every warp of the warpgroup is past the products of stage it - 2,
        // which read query buffer it & 1
        named_barrier(1 + wg, 128);
        unsigned char* qb = my_q + (it & 1) * Tl::kQBufBytes;
        for (int i = wtid; i < kNq * 8; i += 128)
          split_f32_chunk<Tl::kQPart>(st + Tl::kPBox, i >> 3, qb, i >> 3, i & 7);
        fence_shared_to_async();
        named_barrier(1 + wg, 128);
        if (lane == 0) mbar_arrive(empty + s);  // the stage is read: the producer may refill it
        db = wgmma_desc(shared_addr(qb), kF32PartRow);
      } else {
        db = wgmma_desc(shared_addr(st + Tl::kPBox), kF32PartRow);
      }
      split_f32_fragment(v0, f0);
      wgmma_fence();
      wgmma_f32_parts_rs_kstep<kNq, (Tl::kQPart >> 4), 0>(big, small, f0, db, kc == 0 ? 0 : 1);
      wgmma_commit();
      wgmma_wait<1>();  // the products of the k-step before, which read f1, have landed
      if constexpr (!Tl::kSplitQ) {  // ... so all of stage it - 1's: release it
        if (it > 0 && lane == 0) mbar_arrive(empty + (it - 1) % kRing);
      }
      pin_fragment(f1);
      split_f32_fragment(v1, f1);
      wgmma_fence();
      wgmma_f32_parts_rs_kstep<kNq, (Tl::kQPart >> 4), 2>(big, small, f1, db, 1);
      wgmma_commit();
      wgmma_wait<1>();  // f0's products have landed
      pin_fragment(f0);
    }
    wgmma_wait<0>();
    wgmma_fence_regs(big);
    wgmma_fence_regs(small);
#pragma unroll
    for (int i = 0; i < kNq / 2; ++i) big[i] = __fadd_rn(big[i], small[i]);
    const int c0 = tile * kF32BN + kF32Rows * wg;  // this warpgroup's first passage row
    bf_small_block<kNq, kStore>(big, scores, gmax, red + wg * 4 * kNq, nq, n, c0, warp, g, t,
                                group, gshift);
    if (group >= 32)  // G / 16 of the tile's 8 16-row chunks a group
      combine_chunk_maxima<kNq>(red, gmax, nq, n, tile * kF32BN, group, gshift, tid);
  }
}

// f32 passages at Q > kF32SmallQMax: a persistent grid walks the tiles of
// 128 queries x 128 passages, query tiles fastest (the blocks that share a
// passage tile run together and it comes from device memory once). Thread
// 256 (the producer warp's first lane) streams each stage's three
// query-part boxes [128][64 bytes] (a 3D map of [3, Q, D8]) and the f32
// passage box [128][128 bytes] by TMA into a ring of 4 stages of 40 KB
// that runs across tiles. The passages are A, as in the small-Q tiles:
// warpgroup w splits its 64 passage rows of each stage into one of two
// part buffers of its own, in turn ([64][64 bytes] a part), behind its own
// named barriers, and issues wgmma_f32_parts_stage with them as A and the
// stage's 128 query rows' parts as B (m64n128: the two sums are 128 f32
// registers a thread of the 168 that 288 threads leave). So each
// warpgroup's products wait on its own split alone: with the queries as A
// (the bf16 kernel's tile) both warpgroups need both halves of the split
// passages as B, and the barrier between them made both kernels slower on
// an H100. The same products in the same order into the
// same two sums as the small-Q tiles and pass B, so the same bits. A stage
// (its query parts are B) is released once the next stage's products are
// issued and its own have landed. Epilogue as the small-Q tiles' for the
// tile's queries m0..: the sums added, bf_small_block (kernel 2's scores
// by st.global, which on the card beat the bf16 kernel's TMA-store rounds
// here, and the group maxima of G = 8, 16), combine_chunk_maxima for G >=
// 32; pass A compiles the store out.
struct F32Tile {
  static constexpr int kNq = kF32BM;  // B's rows: the tile's queries
  static constexpr int kQPart = kNq * kF32PartRow;
  static constexpr int kPBoxAt = 3 * kQPart;
  static constexpr int kStageBytes = kPBoxAt + kF32BN * kF32BoxRow;
  static constexpr int kPPart = kF32Rows * kF32PartRow;
  static constexpr int kBufBytes = 3 * kPPart;
  static constexpr int kPartsBytes = 2 * 2 * kBufBytes;
  static constexpr int kRedBytes = 8 * kNq * 4;
  static constexpr int kFit =
      (kMaxSmem - 1024 - kPartsBytes - kRedBytes - 2 * 8 * kF32MaxStages) / kStageBytes;
  static constexpr int kRing = kFit < kF32MaxStages ? kFit : kF32MaxStages;
  static constexpr int kSmem =
      1024 + kRing * kStageBytes + kPartsBytes + kRedBytes + 2 * 8 * kRing;
  static_assert(kRing >= 3, "a ring of three stages at least");
  static_assert(kQPart % 1024 == 0 && kStageBytes % 1024 == 0 && kBufBytes % 1024 == 0,
                "1024-byte bases");
};

template <bool kStore>
__global__ void __launch_bounds__(kBfThreads, 1)
scores_groupmax_f32(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap p_map,
                    const __grid_constant__ CUtensorMap s_map, float* __restrict__ scores,
                    float* __restrict__ gmax, int nq, int n, int d, int group) {
  using Tl = F32Tile;
  constexpr int kNq = Tl::kNq;
  constexpr int kRing = Tl::kRing;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  unsigned char* smem = f32_smem + ((1024u - (shared_addr(f32_smem) & 1023u)) & 1023u);
  unsigned char* parts = smem + kRing * Tl::kStageBytes;
  float* red = reinterpret_cast<float*>(parts + Tl::kPartsBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(parts + Tl::kPartsBytes + Tl::kRedBytes);
  uint64_t* empty = full + kRing;
  const int tid = threadIdx.x;
  const int q_tiles = (nq + kF32BM - 1) / kF32BM;
  const int tiles = q_tiles * (n / kF32BN);
  const int nk = (d + kF32K - 1) / kF32K;

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
        const int m0 = (tile % q_tiles) * kF32BM;
        const int n0 = (tile / q_tiles) * kF32BN;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % kRing;
          if (it >= kRing) mbar_wait(empty + s, (it / kRing - 1) & 1);
          unsigned char* st = smem + s * Tl::kStageBytes;
          mbar_arrive_expect_tx(full + s, Tl::kStageBytes);
#pragma unroll
          for (int part = 0; part < 3; ++part)
            tma_load_3d(st + part * Tl::kQPart, &q_map, full + s, kc * kF32K, m0, part);
          tma_load_2d(st + Tl::kPBoxAt, &p_map, full + s, kc * kF32K, n0);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int lane = tid % 32;
  // (the part buffers' and stages' addresses are recomputed each stage: a
  // register fewer across the products kept kernel 2 from spilling)
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float big[kNq / 2], small[kNq / 2];
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % kRing;
      const int b = it & 1;
      mbar_wait(full + s, (it / kRing) & 1);
      // every warp of the warpgroup is past the products of stage it - 2,
      // which read buffer b
      named_barrier(1 + wg, 128);
      unsigned char* buf = parts + (2 * wg + b) * Tl::kBufBytes;
      const unsigned char* box = smem + s * Tl::kStageBytes + Tl::kPBoxAt;
#pragma unroll 1
      for (int i = wtid; i < kF32Rows * 8; i += 128)
        split_f32_chunk<Tl::kPPart>(box, kF32Rows * wg + (i >> 3), buf, i >> 3, i & 7);
      fence_shared_to_async();
      named_barrier(1 + wg, 128);
      wgmma_fence();
      wgmma_f32_parts_stage<kNq, (Tl::kQPart >> 4), (Tl::kPPart >> 4)>(
          big, small, wgmma_desc(shared_addr(parts) + (2 * wg + b) * Tl::kBufBytes, kF32PartRow),
          wgmma_desc(shared_addr(smem) + s * Tl::kStageBytes, kF32PartRow), kc == 0);
      wgmma_commit();
      if (kc > 0) {  // the previous stage's products have landed: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + (it - 1) % kRing);
      }
    }
    wgmma_wait<0>();
    wgmma_fence_regs(big);
    wgmma_fence_regs(small);
    if (lane == 0) mbar_arrive(empty + (it - 1) % kRing);
#pragma unroll
    for (int i = 0; i < kNq / 2; ++i) big[i] = __fadd_rn(big[i], small[i]);
    // the epilogue's values, from here on only (fewer registers live across
    // the products)
    const int warp = wtid / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int gshift = __ffs(group) - 1;
    const int m0 = (tile % q_tiles) * kF32BM;
    const int n0 = (tile / q_tiles) * kF32BN;
    float* tile_gmax = gmax + static_cast<long long>(m0) * (n >> gshift);
    float* tile_scores = kStore ? scores + static_cast<long long>(m0) * n : scores;
    bf_small_block<kNq, kStore>(big, tile_scores, tile_gmax, red + wg * 4 * kNq, nq - m0, n,
                                n0 + kF32Rows * wg, warp, g, t, group, gshift);
    if (group >= 32)  // G / 16 of the tile's 8 16-row chunks a group
      combine_chunk_maxima<kNq>(red, tile_gmax, nq - m0, n, n0, group, gshift, tid);
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
  int path;                 // kPathF32, kPathInt8 or kPathBf16
};
constexpr int kPathF32 = 0, kPathInt8 = 2, kPathBf16 = 3;

// The small-Q tiles' query bucket: Q rounded up to 8, 16, 32 or 64.
inline int small_q_bucket(int nq) { return nq <= 8 ? 8 : nq <= 16 ? 16 : nq <= 32 ? 32 : 64; }

// Every passage dtype takes its wgmma kernel at every Q: int8 one kernel;
// bf16 and f32 the small-Q tiles up to 64 queries (kBfSmallQMax,
// kF32SmallQMax; queries rounded up to 8, 16, 32 or 64), the query tiles
// above.
template <bool kStore>
Config config(int p_dtype, int nq) {
  if (p_dtype == 2) {
    return Config{kI8Threads, I8Tile<kStore>::kSmem, kI8BM,
                  (const void*)scores_groupmax_s8<kStore>, kPathInt8};
  }
  if (p_dtype == 1) {
    if (nq > kBfSmallQMax)
      return Config{kBfThreads, BfTile<kStore>::kSmem, kBfBM,
                    (const void*)scores_groupmax_bf16<kStore>, kPathBf16};
    switch (small_q_bucket(nq)) {
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
  if (nq > kF32SmallQMax)
    return Config{kBfThreads, F32Tile::kSmem, kF32BM, (const void*)scores_groupmax_f32<kStore>,
                  kPathF32};
  switch (small_q_bucket(nq)) {
    case 8: return Config{kBfThreads, F32SmallTile<8>::kSmem, 8,
                          (const void*)scores_groupmax_f32_small_q<kStore, 8>, kPathF32};
    case 16: return Config{kBfThreads, F32SmallTile<16>::kSmem, 16,
                           (const void*)scores_groupmax_f32_small_q<kStore, 16>, kPathF32};
    case 32: return Config{kBfThreads, F32SmallTile<32>::kSmem, 32,
                           (const void*)scores_groupmax_f32_small_q<kStore, 32>, kPathF32};
    default: return Config{kBfThreads, F32SmallTile<64>::kSmem, 64,
                           (const void*)scores_groupmax_f32_small_q<kStore, 64>, kPathF32};
  }
}

// Resident blocks an SM of cfg (after its shared-memory attribute is set).
cudaError_t blocks_per_sm(const Config& cfg, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(cfg.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cfg.fn, cfg.threads, cfg.smem);
}

// A persistent grid: one block an SM, no more blocks than tiles.
cudaError_t persistent_grid(const Config& cfg, long long tiles, int* grid) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = blocks_per_sm(cfg, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *grid = static_cast<int>(tiles < sms ? tiles : sms);
  return cudaSuccess;
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

// The bf16 and f32 kernels: maps of the queries (above the small-Q limit
// of bf16 and kF32SplitQMax of f32: their parts [3, Q, D] (bf16 passages;
// boxes of one part's 128 rows x 64 columns) or [3, Q, D8], D8 = D rounded
// up to 8 (f32 passages; 128 or kNq rows x 32 columns); else the f32 [Q,
// D], boxes of kNq rows x 32 f32) and the
// passages [N, D] (boxes of kBfBN or kF32BN rows) and, for bf16 kernel 2
// above the small-Q limit, of the f32 scores [Q, N] (boxes of [64
// rows][32 columns]).
template <bool kStore>
cudaError_t launch_parts(const Config& cfg, const void* q, const void* p, float* scores,
                         float* gmax, int nq, int n, int d, int group, bool f32, cudaStream_t s) {
  const bool small = nq <= (f32 ? kF32SmallQMax : kBfSmallQMax);
  const int bm = f32 ? kF32BM : kBfBM, bn = f32 ? kF32BN : kBfBN;
  alignas(64) CUtensorMap maps[3] = {};
  const bool f32_parts = f32 && nq > kF32SplitQMax;  // [3, Q, D8] from the wrapper
  const bool q_ok = f32_parts ? encode_parts_map(&maps[0], q, 3, (d + 7) / 8 * 8, nq,
                                                 small ? cfg.rows : bm, kF32K)
                    : small   ? encode_rows_map(&maps[0], q, 4, d, nq, cfg.rows)
                              : encode_parts_map(&maps[0], q, kBfParts, d, nq, bm);
  if (!q_ok || !encode_rows_map(&maps[1], p, f32 ? 4 : 2, d, n, bn) ||
      (kStore && !small && !f32 && !encode_rows_map(&maps[2], scores, 4, n, nq, kBfRows)))
    return cudaErrorInvalidValue;
  const long long tiles =
      static_cast<long long>(small ? 1 : (nq + bm - 1) / bm) * ((n + bn - 1) / bn);
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
  if (nq <= 0 || n <= 0 || d <= 0 || n % kRowTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (group != 8 && group != 16 && group != 32 && group != 64 && group != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p_dtype < 0 || p_dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = p_dtype == 0 ? 4 : p_dtype == 1 ? 8 : 16;
  if (d % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config<kStore>(p_dtype, nq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(scores);
  float* gf = static_cast<float*>(gmax);
  if (cfg.path == kPathInt8)
    return static_cast<int>(launch_s8<kStore>(cfg, q, p, sf, gf, nq, n, d, group, s));
  return static_cast<int>(
      launch_parts<kStore>(cfg, q, p, sf, gf, nq, n, d, group, cfg.path == kPathF32, s));
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

// q: for p_dtype 0 (float32 passages) at Q <= 16 and 1 (bfloat16) at Q <=
// 64 f32 [Q, D] row-major (the kernel splits them); above it the three
// bf16 parts of the f32 queries (ops/fused_search.py bf16_query_parts):
// [3, Q, D] for 1, [3, Q, D8] for 0 (D8: D rounded up to 8, zeros after
// D); int8 [Q, D] for
// 2 (int8, the int-valued queries of quantize_queries). p [N, D]
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
// takes it (padded to 16 bytes of P; every path takes any such d): out[0]
// threads a block, out[1] dynamic shared memory bytes, out[2] query rows a
// block (up to Q=64 on the f32 and bf16 paths: Q rounded up to 8, 16, 32
// or 64; else 128), out[3] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the shared-memory
// attribute is set), out[4] the path (0 the f32 six-part wgmma kernel, 2
// the int8 wgmma kernel, 3 the bf16 three-part wgmma kernel), out[5] the
// blocks an SM the persistent grid launches.
// Returns a cudaError_t.
extern "C" int convdr_scores_groupmax_config(int p_dtype, int nq, int d, int* out) {
  if (p_dtype < 0 || p_dtype > 2 || nq <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config<true>(p_dtype, nq);
  int blocks = 0;
  const cudaError_t err = blocks_per_sm(cfg, &blocks);
  out[0] = cfg.threads;
  out[1] = cfg.smem;
  out[2] = cfg.rows;
  out[3] = blocks;
  out[4] = cfg.path;
  out[5] = blocks < 1 ? blocks : 1;
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
