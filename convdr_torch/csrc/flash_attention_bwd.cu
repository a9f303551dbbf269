// Flash attention backward with segment-id masking, f32 and bf16, for Hopper
// (sm_90a).
//
// Replaces: the custom VJP behind convdr_tpu/models/attention.py:54,
// `flash_attention`, i.e. `_flash_attention_bwd` of
// jax.experimental.pallas.ops.tpu.flash_attention (jax 0.9.0), whose two
// Pallas TPU kernels are `_flash_attention_bwd_dkv` (pallas_call :1121) and
// `_flash_attention_bwd_dq` (pallas_call :1456).
//
// Computes, for S = scale * Q K^T under the forward's mask (query t sees key
// s iff seg[b, t] == seg[b, s]; rows past T masked) and the forward's
// per-row log-sum-exp `lse`:
//   P  = exp(S - lse),  D = rowsum(dO * O),  dP = dO V^T,  dS = P * (dP - D)
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K
// Layouts are the forward's: q/k/v/o/dO/dQ/dK/dV [B, T, H, D] contiguous and
// 16-byte aligned, seg [B, T] int32, lse [B, H, T] f32.
//
// Both dtypes share one structure:
// * D once: a pre-pass kernel (D / 8 lanes a row) writes D [B, H, T] f32
//   into the caller's scratch; the main kernel is its programmatic
//   dependent, so its prologue (barriers, tile plan, own operands) overlaps
//   the pre-pass and only the reads of D wait for it (griddepcontrol.wait).
//   As in Pallas, D is computed once, outside the products.
// * One launch, two block roles, the dK/dV blocks first (the heavier: four
//   products a tile against three), no atomics (two calls are
//   bit-identical): a block owns 64 rows (keys or queries) and walks the
//   planned 32-row tiles of the other side. The per-block tile plan of the
//   forward (flash_common.cuh) walks only tiles whose segment range meets
//   the block's rows; equality is symmetric, so dK/dV blocks plan their
//   query tiles with the same code.
// * The streamed tiles (Q, dO, lse, D and segment ids; or K, V and ids)
//   arrive by TMA (rank-4 tensor maps over [B, T, H, D], boxes of 32 rows:
//   rows past T arrive as zeros) into a ring under full mbarriers, each row's
//   lse, D and segment id by cp.async onto the same barrier. The gradients
//   leave through the own operands' shared memory by TMA stores.
// * S^T = K Q^T and dP^T = V dO^T (dQ blocks: S = Q K^T, dP = dO V^T) are
//   wgmma m64n32k16 with both operands in shared memory (K-major); P and dS
//   are formed in f32 in the accumulator registers, whose two 8-column
//   chunks are one k-step's A fragment (no shuffle), and enter dV += P^T dO,
//   dK += dS^T Q (dQ += dS K) as wgmma m64nDk16 with A from registers and
//   the streamed tile as an MN-major B (the descriptor's transpose bit).
//
// bf16 (training with bf16 compute): q, k, v, o, dO bf16, lse f32; dQ, dK,
// dV bf16. It rounds where the Pallas backward does: D = rowsum(o * dO) in
// f32 (flash_attention.py:273-274), P and dS = scale * P * (dP - D) rounded
// to bf16 before their products (:900, :918, :1258), every product
// accumulated in f32 and each gradient cast to bf16 once at the end
// (:937-938, :1283). Bound: 7 * D multiply-adds a pair on the bf16 tensor
// cores (989 TFLOP/s) against the bytes of eight bf16 [B, T, H, D]
// tensors; at the student's shape the bytes bound it, and a block's chain
// of latencies (loads, five dependent products, exponentials) is what
// takes the time. The design, for Hopper:
// * A block is one consumer warpgroup and one producer warp (160 threads).
//   The producer's lane 0 brings every tile in by TMA (box 1 x 32 x 1 x D),
//   swizzled by the row's width (128, 64, 32 bytes for D = 64, 32, 16),
//   into a ring of 4 stages with full and empty mbarriers; each of its 32
//   lanes copies one row's lse, D and segment id by cp.async, which arrives
//   on the stage's barrier when it lands, so the producer never waits on a
//   load.
// * P and dS are rounded to bf16 A fragments in place, and dV += P^T dO is
//   issued while dS is formed.
// * 32-row tiles keep a consumer's live registers (two [64][D] f32
//   accumulators, the 64 x 32 S and dP) within the 136 a thread that three
//   blocks an SM leave (ptxas: 128): the student's 384 blocks run in one
//   wave on 132 SMs. setmaxnreg, which moves registers between whole
//   warpgroups, has nothing to take from a single producer warp. Issuing
//   the next tile's S and dP before this tile's dV / dK have landed needs
//   more registers than that: ptxas then serializes the wgmma pipeline, and
//   it ran slower on the card (convdr_torch.scripts.attention_bwd_bench),
//   at three blocks an SM and at two.
//
// f32 (the f32 student's training): every tensor f32, on the tensor cores
// as six bf16 wgmma products of exact bf16 parts (the counterpart of the
// MXU's Precision.HIGHEST on f32 x f32; no TF32), the forward's arithmetic
// (flash_attention.cu). Bound: the function's five products in six parts,
// 60 * D operations a (query, key) pair in segment, at the bf16 peak (0.41
// of its 10 * D on the CUDA cores at 67 TFLOP/s, the floor of any design
// without the tensor cores), against the bytes of eight f32 [B, T, H, D]
// tensors; at the student's shape (B = 4, T = 256, H = 12, D = 64) the
// operations bound it. S and dP recomputed in the dQ blocks make seven
// products, 84 * D operations a pair.
// * The parts: q, k, v and dO split exactly into three bf16 parts each
//   (bf16_split2: ops/fused_search.py bf16_query_parts' parts bit for bit),
//   the block's own rows once from device memory, each streamed tile once
//   from the f32 boxes TMA brings (two boxes of 32 floats a row at D = 64,
//   under the 128-byte swizzle; one at D <= 32), by the whole warpgroup,
//   into part tiles in the bf16 path's layout, shared by every product that
//   reads them; no part goes to device memory.
// * S and dP: six products a k-step each, (1,1) into one f32 sum and the
//   five small ones into another, added rounded to nearest: the forward's
//   products in the forward's order of (query part, key part) (1,1), (2,1),
//   (1,2), (3,1), (2,2), (1,3) and its two sums. An output's bits depend on
//   its A row, its B row and the order of the products only (the wgmma
//   probe of scores_groupmax.cu), so S, and S^T = K Q^T in the dK/dV blocks
//   (each product's operands trading places), equals the forward's S bit
//   for bit: P = exp2(S scale log2(e) - lse log2(e)) is formed from the
//   scores the lse was taken over.
// * dV, dK, dQ: P and dS = P (dP - D), in f32, split into three parts in
//   registers, are the register A of six products a 16-row k-step against
//   the streamed tile's parts as an MN-major B, in the forward's P V order.
//   Each tile's (1,1) products go into a sum of their own and the rest into
//   another; the two are added, rounded to nearest, into IEEE f32 gradients
//   (a long one-signed sum added in the tensor cores truncates once a
//   product: for the forward's O that moved the f32 train step's gradients
//   1.8e-4 of scale from f64). dK and dQ are scaled at the end.
// * A block is one warpgroup (128 threads); its thread 0 issues the TMA
//   copies and warp 0 the metadata's, a ring of two f32 stages refilled when
//   a tile is done. The tile's sums take 64 registers a thread at D = 64,
//   and dV's are added into dV before dK's products start, so one set serves
//   both: about 180 live at the peak (two IEEE gradients, the tile's sums,
//   P's and dS's parts), within the 255 that two blocks an SM leave (108 KB
//   of shared memory each), which hide each other's waits (ptxas: 254 at
//   D = 64, no spills).
//   (On an H100, scripts/attention_bwd_bench.py: B=4 T=256 0.0598 ms on the
//   device against the FMA register-tile kernel it replaces, 0.0924; B=8
//   T=512 0.306 against 0.627; masked SDPA's backward 0.101 / 0.55; the
//   six-part bound 0.0097 / 0.075. Tried, not kept: splitting the next
//   tile's dO or V parts while dK or dQ runs: 0.0597 at B=4 T=256, and
//   0.304-0.309 against 0.306-0.307 at B=8 T=512, within the spread.)

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// both dtypes: the block's shape, the D pre-pass
// ---------------------------------------------------------------------------
constexpr int kWgRows = 64;  // rows a block owns: one wgmma M
constexpr int kWgTile = 32;  // rows of a streamed tile: the wgmma N of S, dP
constexpr int kRowDotThreads = 256;

// The low and high bf16 of a packed pair as f32 (exact).
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// o[0..7] . dout[0..7] in f32, one fmaf an element in order: a lane's
// 16-byte piece of a bf16 row, or two of an f32 row.
__device__ __forceinline__ float dot8(const __nv_bfloat16* o, const __nv_bfloat16* dout) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(o));
  const uint4 y = __ldg(reinterpret_cast<const uint4*>(dout));
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc = fmaf(bf16_lo(xs[e]), bf16_lo(ys[e]), acc);
    acc = fmaf(bf16_hi(xs[e]), bf16_hi(ys[e]), acc);
  }
  return acc;
}

__device__ __forceinline__ float dot8(const float* o, const float* dout) {
  const float4 x[2] = {__ldg(reinterpret_cast<const float4*>(o)),
                       __ldg(reinterpret_cast<const float4*>(o) + 1)};
  const float4 y[2] = {__ldg(reinterpret_cast<const float4*>(dout)),
                       __ldg(reinterpret_cast<const float4*>(dout) + 1)};
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    acc = fmaf(x[e].x, y[e].x, acc);
    acc = fmaf(x[e].y, y[e].y, acc);
    acc = fmaf(x[e].z, y[e].z, acc);
    acc = fmaf(x[e].w, y[e].w, acc);
  }
  return acc;
}

// The pre-pass: D[b, h, t] = sum over d of o[b, t, h, d] * dO[b, t, h, d]
// in f32, once for every row (bf16 or f32 operands): D / 8 lanes a row,
// eight elements a lane (a warp reads whole consecutive rows), summed over
// the row's lanes by shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(kRowDotThreads)
    row_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, int seq, int heads, long long rows) {
  constexpr int kLanes = D / 8;
  grid_launch_dependents();  // the main kernel's prologue may start
  const long long r = (static_cast<long long>(blockIdx.x) * kRowDotThreads + threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  float acc = r < rows ? dot8(o + r * D + 8 * part, dout + r * D + 8 * part) : 0.f;
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r >= rows || part != 0) return;
  const long long bt = r / heads;  // r = (b * T + t) * H + h
  const long long h = r - bt * heads;
  const long long b = bt / seq;
  const long long t = bt - b * seq;
  delta[(b * heads + h) * seq + t] = acc;
}

// ---------------------------------------------------------------------------
// bf16: wgmma over TMA tiles
// ---------------------------------------------------------------------------
constexpr int kWgStages = 4;                   // the ring of streamed tiles
constexpr int kWgConsumers = 128;              // one warpgroup
constexpr int kWgThreads = kWgConsumers + 32;  // and the producer warp
constexpr int kWgMinBlocks = 3;

struct WgArgs {
  const float* lse;
  const float* delta;  // D = rowsum(o * dO) [B, H, T] f32, from the pre-pass
  const int* seg;
  int seq, heads;
  float scale;
};

// Shared memory of a block (from a 1024-byte aligned base): the two own
// operands [kWgRows][D], the ring's stages of two streamed [kWgTile][D]
// tiles (all swizzled by TMA), each stage's metadata (lse, D, segment id of
// its rows), the barriers, the tile plan.
template <int D>
struct WgTile {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kOwnBytes = kWgRows * kRowBytes;
  static constexpr int kTileBytes = kWgTile * kRowBytes;
  static constexpr int kStagesOff = 2 * kOwnBytes;
  static constexpr int kMetaWords = 3 * kWgTile;
  static constexpr int kMetaOff = kStagesOff + kWgStages * 2 * kTileBytes;
  static constexpr int kBarOff = kMetaOff + kWgStages * kMetaWords * 4;
  static constexpr int kPlanOff = kBarOff + (2 * kWgStages + 1) * 8;
  static_assert(kOwnBytes % 1024 == 0 && kTileBytes % 1024 == 0, "tiles on 1024-byte bases");
};

// One block's gradients: kKV, dK and dV of keys [blk * 64, + 64) over the
// planned query tiles; else dQ of queries [blk * 64, + 64) over the planned
// key tiles. own1 / own2 map the block's operands (K, V or Q, dO), str1 /
// str2 the streamed ones (Q, dO or K, V), out1 / out2 its gradients (dK, dV
// or dQ). Threads 0-127 are the consumer warpgroup, 128-159 the producer
// warp.
template <int D, bool kKV>
__device__ __forceinline__ void wg_block(const CUtensorMap* own1, const CUtensorMap* own2,
                                         const CUtensorMap* str1, const CUtensorMap* str2,
                                         const CUtensorMap* out1, const CUtensorMap* out2,
                                         const WgArgs& a, int blk, unsigned char* smem) {
  using Tl = WgTile<D>;
  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = a.seq;
  const int* segb = a.seg + static_cast<long long>(b) * seq;
  const long long row_stats = (static_cast<long long>(b) * a.heads + h) * seq;
  const int r0 = blk * kWgRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tl::kBarOff);
  uint64_t* empty = full + kWgStages;
  uint64_t* own_full = empty + kWgStages;
  int* plan = reinterpret_cast<int*>(smem + Tl::kPlanOff);
  float* meta = reinterpret_cast<float*>(smem + Tl::kMetaOff);

  if (tid == kWgConsumers) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + s, 1 + 32);  // the TMA's bytes, then each lane's metadata
      mbar_init(empty + s, kWgConsumers);
    }
    mbar_init(own_full, 1);
    mbar_fence_init();
    // the own operands, while the block plans its tiles
    mbar_arrive_expect_tx(own_full, 2 * Tl::kOwnBytes);
#pragma unroll
    for (int part = 0; part < kWgRows / kWgTile; ++part) {
      const int row = r0 + part * kWgTile;
      tma_load_4d(smem + part * Tl::kTileBytes, own1, own_full, 0, h, row, b);
      tma_load_4d(smem + Tl::kOwnBytes + part * Tl::kTileBytes, own2, own_full, 0, h, row, b);
    }
  }
  // every thread (its barriers also publish the mbarriers' initialisation)
  const int n = plan_tiles<kWgRows, kWgTile, kWgThreads>(segb, seq, r0, plan);

  if (tid >= kWgConsumers) {  // the producer: streamed tiles and their metadata
    const int lane = tid - kWgConsumers;
    if constexpr (kKV) grid_dependency_wait();  // D of the pre-pass
    for (int idx = 0; idx < n; ++idx) {
      const int stage = idx % kWgStages;
      if (idx >= kWgStages) mbar_wait(empty + stage, (idx / kWgStages - 1) & 1);
      const int c0 = plan[idx] * kWgTile;
      unsigned char* st = smem + Tl::kStagesOff + stage * 2 * Tl::kTileBytes;
      if (lane == 0) {
        mbar_arrive_expect_tx(full + stage, 2 * Tl::kTileBytes);
        tma_load_4d(st, str1, full + stage, 0, h, c0, b);
        tma_load_4d(st + Tl::kTileBytes, str2, full + stage, 0, h, c0, b);
      }
      // the metadata of row c0 + lane by cp.async, which arrives when it has
      // landed (the producer never waits on a load); a row past T gets a
      // segment no row has
      float* m = meta + stage * Tl::kMetaWords;
      int* mseg = reinterpret_cast<int*>(m + 2 * kWgTile);
      const int row = c0 + lane;
      if (row < seq) {
        cp_async4(mseg + lane, segb + row);
        if constexpr (kKV) {
          cp_async4(m + lane, a.lse + row_stats + row);
          cp_async4(m + kWgTile + lane, a.delta + row_stats + row);
        }
        mbar_arrive_cp_async(full + stage);
      } else {
        mseg[lane] = kNoSegment;
        if constexpr (kKV) m[lane] = m[kWgTile + lane] = 0.f;
        mbar_arrive(full + stage);
      }
    }
    return;
  }

  // the consumer warpgroup: warp w owns block rows 16w + g and 16w + g + 8
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  int rows[2];
  bool live[2];
  int segr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = r0 + 16 * warp + g + 8 * r;
    live[r] = rows[r] < seq;
    segr[r] = live[r] ? segb[rows[r]] : kNoSegment + 1;  // a row past T sees nothing
  }
  // dQ blocks: their rows' lse (log2 domain) and D
  float lse2[2] = {0.f, 0.f};
  float drow[2] = {0.f, 0.f};
  if constexpr (!kKV) {
    grid_dependency_wait();
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (live[r]) {
        lse2[r] = a.lse[row_stats + rows[r]] * kLog2e;
        drow[r] = a.delta[row_stats + rows[r]];
      }
  }

  constexpr int kAcc = D / 2;  // a [64][D] f32 accumulator's registers a thread
  float acc1[kAcc];            // dV (dK/dV blocks) or dQ
  float acc2[kAcc];            // dK (dK/dV blocks)
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc1[i] = acc2[i] = 0.f;
  const float scale = a.scale;
  const float scale_log2 = scale * kLog2e;
  const uint32_t base = shared_addr(smem);
  const uint64_t own1_desc = wgmma_desc(base, Tl::kRowBytes);
  const uint64_t own2_desc = wgmma_desc(base + Tl::kOwnBytes, Tl::kRowBytes);
  constexpr uint32_t kStep = 16 * Tl::kRowBytes >> 4;  // 16 rows down, in descriptor units
  mbar_wait(own_full, 0);

  for (int idx = 0; idx < n; ++idx) {
    const int stage = idx % kWgStages;
    mbar_wait(full + stage, (idx / kWgStages) & 1);
    const uint32_t st = base + Tl::kStagesOff + stage * 2 * Tl::kTileBytes;
    const uint64_t str1_desc = wgmma_desc(st, Tl::kRowBytes);
    const uint64_t str2_desc = wgmma_desc(st + Tl::kTileBytes, Tl::kRowBytes);
    const float* m = meta + stage * Tl::kMetaWords;
    const int2* seg2 = reinterpret_cast<const int2*>(m + 2 * kWgTile);

    // S = own1 str1^T and dP = own2 str2^T (for dK/dV blocks the transposes
    // S^T and dP^T), 64 x 32 each, issued as two groups: k-steps of 16
    // columns, 32 bytes along the swizzled rows (the first overwrites)
    float s[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32(s, own1_desc + 2 * kk, str1_desc + 2 * kk, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32(dp, own2_desc + 2 * kk, str2_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_fence_regs(s);

    // P = exp(scale S - lse) where the segments match, else 0, in f32 (the
    // query's lse: per column for dK/dV blocks, per row for dQ blocks);
    // columns 8j + 2t and + 1 of a thread read as pairs. P and dS go to
    // registers of their own: only wgmma writes its accumulators, or ptxas
    // serializes the wgmma pipeline.
    float p[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * t;
      const int2 sc = seg2[col / 2];
      const float2 l2c = kKV ? reinterpret_cast<const float2*>(m)[col / 2] : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float l2 = kKV ? (e ? l2c.y : l2c.x) * kLog2e : lse2[r];
          p[i] = (e ? sc.y : sc.x) == segr[r] ? fast_exp2(fmaf(s[i], scale_log2, -l2)) : 0.f;
        }
    }
    // P rounded to bf16 as A fragments in registers: k-step kk is the
    // accumulator's columns 16kk..16kk+15, fragment register q the pair of
    // elements 8kk + 2q, + 1 (row 16w + g + 8 (q & 1), columns 8j + 2t, + 1
    // with j = 2kk + q / 2). dK/dV blocks issue dV += P^T dO with the
    // streamed dO as an MN-major B (16 rows a k-step) while dS is formed.
    if constexpr (kKV) {
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[kk][q] = pack_bf16(p[8 * kk + 2 * q], p[8 * kk + 2 * q + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_rs<D>(acc1, pa[kk], str2_desc + kk * kStep, 1);
      wgmma_commit();
      wgmma_wait<1>();  // dP (committed before dV)
    } else {
      wgmma_wait<0>();
    }
    // dS = (dP - D) P scale in f32, rounded to bf16 the same way
    wgmma_fence_regs(dp);
    uint32_t da[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kk + 2 * q;
        const float2 dd = kKV ? reinterpret_cast<const float2*>(m + kWgTile)[4 * (2 * kk + q / 2) + t]
                              : make_float2(drow[q & 1], drow[q & 1]);
        da[kk][q] = pack_bf16((dp[i] - dd.x) * p[i] * scale, (dp[i + 1] - dd.y) * p[i + 1] * scale);
      }
    // dK += dS^T Q (dK/dV blocks), or dQ += dS K
    float (&acc_ds)[kAcc] = kKV ? acc2 : acc1;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) wgmma_rs<D>(acc_ds, da[kk], str1_desc + kk * kStep, 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(acc1);
    if constexpr (kKV) wgmma_fence_regs(acc2);
    mbar_arrive(empty + stage);  // the stage's tiles and metadata are read
  }

  // each gradient cast to bf16 once, laid out in the own operands' shared
  // memory (free now) as TMA's swizzle wants it, and stored by TMA: rows
  // past T are not written
  auto stage_out = [&](unsigned char* dst, const float (&acc)[kAcc]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + swizzled_chunk_offset(row, j, Tl::kRowBytes) + 4 * t) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  };
  stage_out(smem, kKV ? acc2 : acc1);  // dK or dQ
  if constexpr (kKV) stage_out(smem + Tl::kOwnBytes, acc1);  // dV
  fence_shared_to_async();
  named_barrier(1, kWgConsumers);
  if (tid == 0) {
#pragma unroll
    for (int part = 0; part < kWgRows / kWgTile; ++part) {
      const int row = r0 + part * kWgTile;
      tma_store_4d(out1, smem + part * Tl::kTileBytes, 0, h, row, b);
      if constexpr (kKV) tma_store_4d(out2, smem + Tl::kOwnBytes + part * Tl::kTileBytes, 0, h, row, b);
    }
    tma_store_commit();
    tma_store_wait_all();
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, kWgMinBlocks)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap dq_map,
                           const __grid_constant__ CUtensorMap dk_map,
                           const __grid_constant__ CUtensorMap dv_map, const WgArgs a) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  // a 1024-byte aligned base: the 128-byte swizzle's atom
  unsigned char* smem = wg_smem + ((1024u - (shared_addr(wg_smem) & 1023u)) & 1023u);
  const int half = gridDim.x / 2;  // the dK/dV blocks come first
  if (blockIdx.x < half)
    wg_block<D, true>(&k_map, &v_map, &q_map, &do_map, &dk_map, &dv_map, a, blockIdx.x, smem);
  else
    wg_block<D, false>(&q_map, &do_map, &k_map, &v_map, &dq_map, nullptr, a, blockIdx.x - half,
                       smem);
}

// ---------------------------------------------------------------------------
// f32: six-part bf16 wgmma over TMA tiles
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 128;  // one warpgroup, which also issues the copies
constexpr int kF32Stages = 2;     // the ring of f32 streamed tiles
constexpr int kF32MinBlocks = 2;  // registers up to 255 a thread

struct F32Args {
  const float* q;  // the block's own rows are read from q, k, v, dout directly
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;  // D = rowsum(o * dO) [B, H, T] f32, from the pre-pass
  const int* seg;
  int seq, heads;
  float scale;
};

// Shared memory of a block (from a 1024-byte aligned base): the own
// operands' three bf16 part tiles each [kWgRows][D] (own1's, then own2's),
// the streamed operands' [kWgTile][D] part tiles (str1's, then str2's; all
// in the swizzle of the part row's width, as the bf16 path's tiles), the
// ring's stages of two f32 streamed tiles as TMA writes them (D / kBoxF
// boxes of kWgTile rows, each swizzled by its width), each stage's
// metadata (lse, D, segment id of its rows), the barriers, the tile plan.
// At the end the own part tiles hold the gradients in the f32 boxes' layout
// for the TMA stores.
template <int D>
struct F32Tile {
  static constexpr int kRowBytes = 2 * D;               // a bf16 part row
  static constexpr int kOwnPart = kWgRows * kRowBytes;  // a part tile of the own rows
  static constexpr int kStrPart = kWgTile * kRowBytes;  // a part tile of a streamed tile
  static constexpr int kBoxF = D < 32 ? D : 32;         // floats a TMA box row: 64 or 128 bytes
  static constexpr int kBox = kWgTile * kBoxF * 4;      // bytes a box
  static constexpr int kF32Tile = kWgTile * D * 4;      // an f32 streamed tile
  static constexpr int kStrOff = 6 * kOwnPart;
  static constexpr int kF32Off = kStrOff + 6 * kStrPart;
  static constexpr int kMetaWords = 3 * kWgTile;
  static constexpr int kMetaOff = kF32Off + kF32Stages * 2 * kF32Tile;
  static constexpr int kBarOff = kMetaOff + kF32Stages * kMetaWords * 4;
  static constexpr int kPlanOff = kBarOff + kF32Stages * 8;
  static_assert(kStrPart % 1024 == 0 && kBox % 1024 == 0 && kF32Off % 1024 == 0,
                "tiles on 1024-byte bases");
  static_assert(2 * kWgRows * D * 4 <= 6 * kOwnPart, "two gradients fit the own parts");
  // + 1024 bytes to align the base
  static int smem_bytes(int seq) {
    return 1024 + kPlanOff + (plan_bytes(seq, kWgTile) + 15) / 16 * 16;
  }
  // The byte offset of floats d..d+3 (d a multiple of 4) of row r of an f32
  // tile of kWgTile rows, or of a gradient's 64 rows as two such tiles
  __device__ static int f32_at(int r, int d) {
    return r / kWgTile * kF32Tile + d / kBoxF * kBox +
           swizzled_chunk_offset(r % kWgTile, d % kBoxF / 4, kBoxF * 4);
  }
};

// One k-step (16 of D, at descriptor offset kK) of the six-part product of
// the block's rows (A, part j at desc_a + j kA) and a streamed tile's (B,
// part i at desc_b + i kB): (1,1) into big, the five small products into
// small, in the forward's order of (query part, key part) (1,1), (2,1),
// (1,2), (3,1), (2,2), (1,3) (flash_attention.cu's issue_s_f32, the
// queries as A). kQA: the queries are A (dQ blocks, S = Q K^T: that order
// is wgmma_f32_parts_kstep's), else B (dK/dV blocks, S^T = K Q^T: each
// product's operands trade places). An output's bits depend on its A row,
// its B row and the order of the products only, so S^T is the forward's S
// bit for bit.
template <int kA, int kB, int kK, bool kQA>
__device__ __forceinline__ void s_kstep(float (&big)[16], float (&small)[16], uint64_t desc_a,
                                        uint64_t desc_b, int acc) {
  constexpr int kA1 = kQA ? kA : 0;  // the A step of the query's second part
  constexpr int kB1 = kQA ? 0 : kB;  // its B step
  constexpr int kA2 = kQA ? 0 : kA;  // the A step of the key's second part
  constexpr int kB2 = kQA ? kB : 0;
  wgmma_ss_at<32, kK, kK>(big, desc_a, desc_b, acc);                          // (1,1)
  wgmma_ss_at<32, kK + kA1, kK + kB1>(small, desc_a, desc_b, acc);            // (2,1)
  wgmma_ss_at<32, kK + kA2, kK + kB2>(small, desc_a, desc_b, 1);              // (1,2)
  wgmma_ss_at<32, kK + 2 * kA1, kK + 2 * kB1>(small, desc_a, desc_b, 1);      // (3,1)
  wgmma_ss_at<32, kK + kA, kK + kB>(small, desc_a, desc_b, 1);                // (2,2)
  wgmma_ss_at<32, kK + 2 * kA2, kK + 2 * kB2>(small, desc_a, desc_b, 1);      // (1,3)
}

// S (or dP) of the block's 64 rows and a 32-row tile: D / 16 k-steps, the
// first overwriting both sums; one commit group.
template <int D, int kA, int kB, bool kQA>
__device__ __forceinline__ void issue_s_parts(float (&big)[16], float (&small)[16],
                                              uint64_t desc_a, uint64_t desc_b) {
  wgmma_fence();
  s_kstep<kA, kB, 0, kQA>(big, small, desc_a, desc_b, 0);
  if constexpr (D >= 32) s_kstep<kA, kB, 2, kQA>(big, small, desc_a, desc_b, 1);
  if constexpr (D >= 64) {
    s_kstep<kA, kB, 4, kQA>(big, small, desc_a, desc_b, 1);
    s_kstep<kA, kB, 6, kQA>(big, small, desc_a, desc_b, 1);
  }
  wgmma_commit();
}

// One 16-row k-step (at descriptor offset kK) of a gradient's tile product:
// the six products of a register A's parts (pa[j]: P's or dS's part j) and
// a streamed tile's parts as an MN-major B (part i at desc_b + i kB), in
// the forward's P V order: (1,1) into big, then (1,2), (2,1), (1,3), (2,2),
// (3,1) into small.
template <int D, int kB, int kK>
__device__ __forceinline__ void rs_kstep(float (&big)[D / 2], float (&small)[D / 2],
                                         const uint32_t (&pa)[3][4], uint64_t desc_b, int acc) {
  wgmma_rs_kb_at<D, kK, 1>(big, pa[0], desc_b, acc);             // (1,1)
  wgmma_rs_kb_at<D, kK, 1>(small, pa[1], desc_b, acc);           // (1,2)
  wgmma_rs_kb_at<D, kK + kB, 1>(small, pa[0], desc_b, 1);        // (2,1)
  wgmma_rs_kb_at<D, kK, 1>(small, pa[2], desc_b, 1);             // (1,3)
  wgmma_rs_kb_at<D, kK + kB, 1>(small, pa[1], desc_b, 1);        // (2,2)
  wgmma_rs_kb_at<D, kK + 2 * kB, 1>(small, pa[0], desc_b, 1);    // (3,1)
}

// A tile's share of a gradient (64 x D): the tile's 32 rows as two k-steps,
// (1,1) into big and the rest into small, each overwritten; one commit
// group.
template <int D, int kB>
__device__ __forceinline__ void issue_grad_parts(float (&big)[D / 2], float (&small)[D / 2],
                                                 const uint32_t (&pa)[2][3][4], uint64_t desc_b) {
  constexpr int kStep = 16 * 2 * D >> 4;  // 16 rows down, in descriptor units
  wgmma_fence();
  rs_kstep<D, kB, 0>(big, small, pa[0], desc_b, 0);
  rs_kstep<D, kB, kStep>(big, small, pa[1], desc_b, 1);
  wgmma_commit();
}

// The f32 streamed tiles of a stage into their part tiles, the warpgroup's
// threads sharing the 2 x kWgTile x D/8 chunks.
template <int D>
__device__ __forceinline__ void split_stage(const unsigned char* f32, unsigned char* parts,
                                            int tid) {
  using Tl = F32Tile<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks a part row
  static_assert(2 * kWgTile * kChunks % kF32Threads == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < 2 * kWgTile * kChunks / kF32Threads; ++it) {
    const int i = tid + it * kF32Threads;
    const int op = i / (kWgTile * kChunks);
    const int r = i / kChunks % kWgTile;
    const int c = i % kChunks;
    const unsigned char* f = f32 + op * Tl::kF32Tile;
    store_parts<Tl::kRowBytes, Tl::kStrPart>(
        parts + op * 3 * Tl::kStrPart, r, c,
        *reinterpret_cast<const float4*>(f + Tl::f32_at(r, 8 * c)),
        *reinterpret_cast<const float4*>(f + Tl::f32_at(r, 8 * c + 4)));
  }
}

// A tile's two sums added, rounded to nearest, into an IEEE f32 gradient.
template <int N>
__device__ __forceinline__ void retire(float (&acc)[N], const float (&big)[N],
                                       const float (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], __fadd_rn(big[i], small[i]));
}

// One block's gradients: kKV, dK and dV of keys [blk * 64, + 64) over the
// planned query tiles; else dQ of queries [blk * 64, + 64) over the planned
// key tiles. own1 / own2 are the block's operands (K, V or Q, dO), str1 /
// str2 map the streamed ones (Q, dO or K, V), out1 / out2 its gradients (dK,
// dV or dQ). Thread 0 issues the TMA copies, warp 0 the metadata's.
template <int D, bool kKV>
__device__ __forceinline__ void f32_block(const float* own1, const float* own2,
                                          const CUtensorMap* str1, const CUtensorMap* str2,
                                          const CUtensorMap* out1, const CUtensorMap* out2,
                                          const F32Args& a, int blk, unsigned char* smem) {
  using Tl = F32Tile<D>;
  constexpr int kChunks = D / 8;
  constexpr int kAcc = D / 2;                 // a [64][D] f32 accumulator's registers a thread
  constexpr int kOwnP = Tl::kOwnPart >> 4;    // descriptor units
  constexpr int kStrP = Tl::kStrPart >> 4;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = a.seq;
  const int* segb = a.seg + static_cast<long long>(b) * seq;
  const long long row_stats = (static_cast<long long>(b) * a.heads + h) * seq;
  const long long tok = static_cast<long long>(a.heads) * D;  // floats a token
  const long long head0 = static_cast<long long>(b) * seq * tok + static_cast<long long>(h) * D;
  const int r0 = blk * kWgRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tl::kBarOff);
  int* plan = reinterpret_cast<int*>(smem + Tl::kPlanOff);
  float* meta = reinterpret_cast<float*>(smem + Tl::kMetaOff);

  if (tid == 0) {
    for (int s = 0; s < kF32Stages; ++s)
      mbar_init(full + s, 1 + 32);  // the TMA's bytes, then each lane's metadata
    mbar_fence_init();
  }
  // every thread (its barriers also publish the mbarriers' initialisation)
  const int n = plan_tiles<kWgRows, kWgTile, kF32Threads>(segb, seq, r0, plan);

  // Planned tile idx into its stage: the f32 tiles by TMA (thread 0; rows
  // past T arrive as zeros), its rows' metadata by cp.async (warp 0, a row a
  // lane), which arrives when it has landed; a row past T gets a segment no
  // row has.
  auto load_f32 = [&](int idx) {
    const int st = idx % kF32Stages;
    const int c0 = plan[idx] * kWgTile;
    unsigned char* f = smem + Tl::kF32Off + st * 2 * Tl::kF32Tile;
    mbar_arrive_expect_tx(full + st, 2 * Tl::kF32Tile);
#pragma unroll
    for (int c = 0; c < D / Tl::kBoxF; ++c) {
      tma_load_4d(f + c * Tl::kBox, str1, full + st, c * Tl::kBoxF, h, c0, b);
      tma_load_4d(f + Tl::kF32Tile + c * Tl::kBox, str2, full + st, c * Tl::kBoxF, h, c0, b);
    }
  };
  auto load_meta = [&](int idx) {
    const int st = idx % kF32Stages;
    float* m = meta + st * Tl::kMetaWords;
    int* mseg = reinterpret_cast<int*>(m + 2 * kWgTile);
    const int row = plan[idx] * kWgTile + lane;
    if (row < seq) {
      cp_async4(mseg + lane, segb + row);
      if constexpr (kKV) {
        cp_async4(m + lane, a.lse + row_stats + row);
        cp_async4(m + kWgTile + lane, a.delta + row_stats + row);
      }
      mbar_arrive_cp_async(full + st);
    } else {
      mseg[lane] = kNoSegment;
      if constexpr (kKV) m[lane] = m[kWgTile + lane] = 0.f;
      mbar_arrive(full + st);
    }
  };
  if (tid == 0)
    for (int idx = 0; idx < min(n, kF32Stages); ++idx) load_f32(idx);

  // the own rows' parts, while the first tiles load (rows past T as zeros)
#pragma unroll 1
  for (int i = tid; i < 2 * kWgRows * kChunks; i += kF32Threads) {
    const int op = i / (kWgRows * kChunks);
    const int row = i / kChunks % kWgRows;
    const int c = i % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = x;
    if (r0 + row < seq) {
      const float4* src =
          reinterpret_cast<const float4*>((op ? own2 : own1) + head0 + (r0 + row) * tok + 8 * c);
      x = src[0];
      y = src[1];
    }
    store_parts<Tl::kRowBytes, Tl::kOwnPart>(smem + op * 3 * Tl::kOwnPart, row, c, x, y);
  }
  fence_shared_to_async();  // before the products read them

  // warp w owns block rows 16w + g and 16w + g + 8
  const int g = lane / 4;
  const int t = lane % 4;
  int segr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * warp + g + 8 * r;
    segr[r] = row < seq ? segb[row] : kNoSegment + 1;  // a row past T sees nothing
  }
  // D of the pre-pass: the streamed queries' (dK/dV blocks, in the
  // metadata) or the own rows' (dQ blocks), with their lse (log2 domain)
  float lse2[2] = {0.f, 0.f};
  float drow[2] = {0.f, 0.f};
  if constexpr (kKV) {
    if (warp == 0) grid_dependency_wait();
  } else {
    grid_dependency_wait();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 16 * warp + g + 8 * r;
      if (row < seq) {
        lse2[r] = a.lse[row_stats + row] * kLog2e;
        drow[r] = a.delta[row_stats + row];
      }
    }
  }
  if (warp == 0)
    for (int idx = 0; idx < min(n, kF32Stages); ++idx) load_meta(idx);

  float acc1[kAcc];  // dV (dK/dV blocks) or dQ, in IEEE f32 sums
  float acc2[kAcc];  // dK (dK/dV blocks)
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc1[i] = acc2[i] = 0.f;
  const float scale_log2 = a.scale * kLog2e;
  const uint32_t base = shared_addr(smem);
  const uint64_t own1_desc = wgmma_desc(base, Tl::kRowBytes);
  const uint64_t own2_desc = wgmma_desc(base + 3 * Tl::kOwnPart, Tl::kRowBytes);
  const uint64_t str1_desc = wgmma_desc(base + Tl::kStrOff, Tl::kRowBytes);
  const uint64_t str2_desc = wgmma_desc(base + Tl::kStrOff + 3 * Tl::kStrPart, Tl::kRowBytes);

  // A tile: its f32 tiles split; S and dP from the parts; P and dS in f32
  // and split in registers; the gradients' tile products, each added into
  // its IEEE f32 sum once landed; the stage refilled with the tile
  // kF32Stages ahead.
  for (int idx = 0; idx < n; ++idx) {
    const int st = idx % kF32Stages;
    mbar_wait(full + st, (idx / kF32Stages) & 1);
    split_stage<D>(smem + Tl::kF32Off + st * 2 * Tl::kF32Tile, smem + Tl::kStrOff, tid);
    fence_shared_to_async();
    named_barrier(1, kF32Threads);  // every part is written

    // S = own1 str1^T and dP = own2 str2^T (for dK/dV blocks the transposes
    // S^T and dP^T), 64 x 32 each, as two commit groups
    float sb[16], ss[16], db[16], ds[16];
    issue_s_parts<D, kOwnP, kStrP, !kKV>(sb, ss, own1_desc, str1_desc);
    issue_s_parts<D, kOwnP, kStrP, !kKV>(db, ds, own2_desc, str2_desc);
    wgmma_wait<1>();
    wgmma_fence_regs(sb);
    wgmma_fence_regs(ss);

    // P = exp(scale S - lse) where the segments match, else 0, in f32 (the
    // query's lse: per column for dK/dV blocks, per row for dQ blocks);
    // element i = 4j + 2r + e is row 16w + g + 8r, column 8j + 2t + e
    const float* m = meta + st * Tl::kMetaWords;
    const int2* seg2 = reinterpret_cast<const int2*>(m + 2 * kWgTile);
    float p[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * t;
      const int2 sc = seg2[col / 2];
      const float2 l2c = kKV ? reinterpret_cast<const float2*>(m)[col / 2] : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float l2 = kKV ? (e ? l2c.y : l2c.x) * kLog2e : lse2[r];
          p[i] = (e ? sc.y : sc.x) == segr[r]
                     ? fast_exp2(fmaf(__fadd_rn(sb[i], ss[i]), scale_log2, -l2))
                     : 0.f;
        }
    }
    wgmma_wait<0>();
    wgmma_fence_regs(db);
    wgmma_fence_regs(ds);
    // dS = P (dP - D) in f32; P's and dS's three parts as A fragments:
    // k-step kk is the columns 16kk..16kk+15, register q the pair of
    // elements 8kk + 2q, + 1 (columns 8j + 2t, + 1 with j = 2kk + q / 2)
    uint32_t pa[2][3][4];
    uint32_t da[2][3][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kk + 2 * q;
        const float2 dd = kKV ? reinterpret_cast<const float2*>(m + kWgTile)[4 * (2 * kk + q / 2) + t]
                              : make_float2(drow[q & 1], drow[q & 1]);
        uint32_t w[3];
        bf16_split2(p[i] * (__fadd_rn(db[i], ds[i]) - dd.x),
                    p[i + 1] * (__fadd_rn(db[i + 1], ds[i + 1]) - dd.y), w);
#pragma unroll
        for (int part = 0; part < 3; ++part) da[kk][part][q] = w[part];
        if constexpr (kKV) {
          bf16_split2(p[i], p[i + 1], w);
#pragma unroll
          for (int part = 0; part < 3; ++part) pa[kk][part][q] = w[part];
        }
      }

    // the tile's gradient products: dV += P^T dO then dK += dS^T Q (dK/dV
    // blocks), or dQ += dS K, the streamed tile as an MN-major B; each
    // tile's (1,1) products in a sum of their own
    float tb[kAcc], ts[kAcc];
    if constexpr (kKV) {
      issue_grad_parts<D, kStrP>(tb, ts, pa, str2_desc);
      wgmma_wait<0>();
      pin_fragment(pa[0]);
      pin_fragment(pa[1]);
      wgmma_fence_regs(tb);
      wgmma_fence_regs(ts);
      retire(acc1, tb, ts);
    }
    issue_grad_parts<D, kStrP>(tb, ts, da, str1_desc);
    wgmma_wait<0>();
    pin_fragment(da[0]);
    pin_fragment(da[1]);
    wgmma_fence_regs(tb);
    wgmma_fence_regs(ts);
    retire(kKV ? acc2 : acc1, tb, ts);

    named_barrier(1, kF32Threads);  // every thread is done with the stage and the parts
    if (idx + kF32Stages < n) {
      if (tid == 0) load_f32(idx + kF32Stages);
      if (warp == 0) load_meta(idx + kF32Stages);
    }
  }

  // dK and dQ times the scale, laid out in the own parts' shared memory
  // (free now) as the f32 TMA boxes want it, and stored by TMA: rows past T
  // are not written
  auto stage_out = [&](unsigned char* dst, const float (&acc)[kAcc], float mul) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(dst + Tl::f32_at(row, col & ~3) + 4 * (col & 3)) =
            make_float2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
      }
    }
  };
  stage_out(smem, kKV ? acc2 : acc1, a.scale);  // dK or dQ
  if constexpr (kKV) stage_out(smem + 2 * Tl::kF32Tile, acc1, 1.f);  // dV
  fence_shared_to_async();
  named_barrier(1, kF32Threads);
  if (tid == 0) {
#pragma unroll
    for (int part = 0; part < kWgRows / kWgTile; ++part)
#pragma unroll
      for (int c = 0; c < D / Tl::kBoxF; ++c) {
        const int at = part * Tl::kF32Tile + c * Tl::kBox;
        tma_store_4d(out1, smem + at, c * Tl::kBoxF, h, r0 + part * kWgTile, b);
        if constexpr (kKV)
          tma_store_4d(out2, smem + 2 * Tl::kF32Tile + at, c * Tl::kBoxF, h, r0 + part * kWgTile, b);
      }
    tma_store_commit();
    tma_store_wait_all();
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks)
    flash_bwd_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap dq_map,
                         const __grid_constant__ CUtensorMap dk_map,
                         const __grid_constant__ CUtensorMap dv_map, const F32Args a) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  // a 1024-byte aligned base: the 128-byte swizzle's atom
  unsigned char* smem = f32_smem + ((1024u - (shared_addr(f32_smem) & 1023u)) & 1023u);
  const int half = gridDim.x / 2;  // the dK/dV blocks come first
  if (blockIdx.x < half)
    f32_block<D, true>(a.k, a.v, &q_map, &do_map, &dk_map, &dv_map, a, blockIdx.x, smem);
  else
    f32_block<D, false>(a.q, a.dout, &k_map, &v_map, &dq_map, nullptr, a, blockIdx.x - half,
                        smem);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Config {
  const void* fn;
  int smem;     // dynamic shared memory bytes
  int tile;     // rows of a streamed tile
  int threads;  // a block
};

template <int D>
Config config(int seq, int dtype) {
  if (dtype == 1)  // + 1024 bytes to align the base
    return Config{reinterpret_cast<const void*>(flash_bwd_wgmma_kernel<D>),
                  WgTile<D>::kPlanOff + (plan_bytes(seq, kWgTile) + 15) / 16 * 16 + 1024,
                  kWgTile, kWgThreads};
  return Config{reinterpret_cast<const void*>(flash_bwd_f32_kernel<D>),
                F32Tile<D>::smem_bytes(seq), kWgTile, kF32Threads};
}

Config config_for(int seq, int head_dim, int dtype) {
  switch (head_dim) {
    case 16: return config<16>(seq, dtype);
    case 32: return config<32>(seq, dtype);
    case 64: return config<64>(seq, dtype);
    default: return Config{nullptr, 0, 0, 0};
  }
}

// Launches above 48 KB of dynamic shared memory need the limit raised first.
cudaError_t allow_smem(const Config& cfg) {
  if (cfg.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(cfg.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
}

bool valid_args(int batch, int seq, int heads, int head_dim, int dtype) {
  return batch > 0 && seq > 0 && heads > 0 && batch <= 65535 && heads <= 65535 &&
         (seq + kWgRows - 1) / kWgRows <= (1 << 30) && (dtype == 0 || dtype == 1) &&
         (head_dim == 16 || head_dim == 32 || head_dim == 64);
}

template <typename T, int D>
cudaError_t launch_row_dot(const void* o, const void* dout, void* delta, int batch, int seq,
                           int heads, cudaStream_t st) {
  const long long rows = static_cast<long long>(batch) * seq * heads;
  constexpr int kRowsABlock = kRowDotThreads / (D / 8);
  row_dot_kernel<T, D><<<static_cast<unsigned>((rows + kRowsABlock - 1) / kRowsABlock),
                         kRowDotThreads, 0, st>>>(static_cast<const T*>(o),
                                                  static_cast<const T*>(dout),
                                                  static_cast<float*>(delta), seq, heads, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t row_dot_of(const void* o, const void* dout, void* delta, int batch, int seq,
                       int heads, int head_dim, cudaStream_t st) {
  switch (head_dim) {
    case 16: return launch_row_dot<T, 16>(o, dout, delta, batch, seq, heads, st);
    case 32: return launch_row_dot<T, 32>(o, dout, delta, batch, seq, heads, st);
    default: return launch_row_dot<T, 64>(o, dout, delta, batch, seq, heads, st);
  }
}

cudaError_t row_dot_for(const void* o, const void* dout, void* delta, int batch, int seq,
                        int heads, int head_dim, int dtype, cudaStream_t st) {
  return dtype == 1
             ? row_dot_of<__nv_bfloat16>(o, dout, delta, batch, seq, heads, head_dim, st)
             : row_dot_of<float>(o, dout, delta, batch, seq, heads, head_dim, st);
}

// Either backward: the tensor maps of q, k, v, dO, dQ, dK, dV (32-row
// boxes; f32 boxes of at most 32 floats), the D pre-pass, then the main
// kernel launched as its programmatic dependent (its prologue overlaps the
// pre-pass; it reads D after griddepcontrol.wait), one dK/dV and one dQ
// block per 64 rows, the dK/dV blocks first. args: the kernel's last
// parameter (WgArgs for bf16, F32Args for f32).
template <typename A>
cudaError_t launch_main(const Config& cfg, const void* const (&tensors)[7], const void* o,
                        void* delta, int batch, int seq, int heads, int head_dim, int dtype,
                        const A& args, cudaStream_t st) {
  CUtensorMap maps[7];
  for (int i = 0; i < 7; ++i)
    if (!encode_bthd_map(&maps[i], tensors[i], batch, seq, heads, head_dim, kWgTile, dtype == 0))
      return cudaErrorInvalidValue;
  cudaError_t err = row_dot_for(o, tensors[3], delta, batch, seq, heads, head_dim, dtype, st);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(2 * ((seq + kWgRows - 1) / kWgRows), heads, batch);
  lc.blockDim = dim3(cfg.threads);
  lc.dynamicSmemBytes = cfg.smem;
  lc.stream = st;
  lc.attrs = attr;
  lc.numAttrs = 1;
  using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                          CUtensorMap, CUtensorMap, A);
  return cudaLaunchKernelEx(&lc, reinterpret_cast<Kernel>(const_cast<void*>(cfg.fn)), maps[0],
                            maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], args);
}

}  // namespace

// dQ, dK, dV of one flash-attention call, head_dim 16, 32 or 64; dtype 0 =
// float32 (every tensor f32), 1 = bfloat16 (q, k, v, o, dout and the
// gradients bf16); o is the forward's output, lse its [B, H, T] f32
// log-sum-exp. delta is [B, H, T] f32 scratch the pre-pass fills with D =
// rowsum(o * dout) before the main kernel reads it. Returns a cudaError_t
// (0 = launched).
extern "C" int convdr_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          const void* seg, void* dq, void* dk, void* dv,
                                          void* delta, int batch, int seq, int heads,
                                          int head_dim, float scale, int dtype, void* stream) {
  if (!valid_args(batch, seq, heads, head_dim, dtype) || delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config_for(seq, head_dim, dtype);
  cudaError_t err = allow_smem(cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const tensors[7] = {q, k, v, dout, dq, dk, dv};
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const int* seg_i = static_cast<const int*>(seg);
  if (dtype == 1)
    return static_cast<int>(launch_main(cfg, tensors, o, delta, batch, seq, heads, head_dim,
                                        dtype, WgArgs{lse_f, delta_f, seg_i, seq, heads, scale},
                                        st));
  const F32Args args{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<const float*>(dout),
                     lse_f, delta_f, seg_i, seq, heads, scale};
  return static_cast<int>(
      launch_main(cfg, tensors, o, delta, batch, seq, heads, head_dim, dtype, args, st));
}

// The pre-pass alone: delta [B, H, T] f32 = rowsum(o * dout) of [B, T, H, D]
// o and dout (dtype as above). Returns a cudaError_t.
extern "C" int convdr_flash_attention_bwd_delta(const void* o, const void* dout, void* delta,
                                                int batch, int seq, int heads, int head_dim,
                                                int dtype, void* stream) {
  if (!valid_args(batch, seq, heads, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(row_dot_for(o, dout, delta, batch, seq, heads, head_dim, dtype,
                                      static_cast<cudaStream_t>(stream)));
}

// The launch configuration for a problem (dtype as above): out[0] threads a
// block, out[1] dynamic shared memory bytes, out[2] rows a block, out[3]
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// after the shared-memory attribute is set), out[4] rows a streamed tile.
// Returns a cudaError_t.
extern "C" int convdr_flash_attention_bwd_config(int batch, int seq, int heads, int head_dim,
                                                 int dtype, int* out) {
  if (!valid_args(batch, seq, heads, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config_for(seq, head_dim, dtype);
  cudaError_t err = allow_smem(cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cfg.fn, cfg.threads, cfg.smem);
  out[0] = cfg.threads;
  out[1] = cfg.smem;
  out[2] = kWgRows;
  out[3] = blocks;
  out[4] = cfg.tile;
  return static_cast<int>(err);
}
