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
// What bounds it on an H100: 5 * D FMAs per allowed (query, key) pair (S,
// dP, dV, dK, dQ) on the f32 CUDA cores (67 TFLOP/s; training keeps full
// f32 products, no TF32) against the bytes of eight [B, T, H, D] tensors;
// at the student's shape (B = 4, T = 256, H = 12, D = 64) the operations
// bound it. The FlashAttention-2 split recomputes S and dP in the dQ blocks,
// so the kernel does 7 * D FMAs a pair; in exchange nothing is reduced
// across blocks (no atomics: the gradients are bit-identical from call to
// call). Without tensor cores the FMA loops are bound by shared-memory
// reads and latency, which the design works against:
//
// * One launch, two block roles: the first half of the grid's x blocks
//   does dK/dV of 64 keys each, the second half dQ of 64 queries. The
//   heavier dK/dV blocks (4 products a tile against 3) are dispatched
//   first; on the card this order ran faster than blocks of the two roles
//   alternating, or the dQ blocks first. Each block of 128 threads
//   walks 32-row tiles of the other side; thread (ty, tx) owns block rows
//   ty + 16 i (i < 4) and tile rows 8 j + tx (j < 4), so S and dP are 4 x 4
//   register tiles, one exponential a pair, and a row's block values stay
//   in one warp.
// * Register-tiled products: S and dP read 8 16-byte shared loads per 64
//   FMAs. P and dS go to a shared buffer that only the writing warp reads
//   back (__syncwarp), then dV += P^T dO, dK += dS^T Q (dK/dV blocks) or
//   dQ += dS K (dQ blocks) accumulate 4 rows x D/8 columns a thread, 12
//   shared loads per 128 FMAs.
// * Tiles are unpadded and XOR-swizzled by 16-byte chunk (chunk c of row r
//   at c ^ swz(r)), so the 8 tile rows a quarter warp reads hit distinct
//   banks in both products; that keeps a block at ~75 KB of shared memory,
//   3 blocks (12 warps) an SM: the student's 384 blocks in one wave.
// * The streamed tiles (Q, dO, lse and segment ids; or K, V and ids) arrive
//   through a 2-stage cp.async ring, the next tile's copies in flight while
//   this one computes; the block's own rows are copied once.
// * The per-block tile plan of the forward (flash_common.cuh) walks only
//   tiles whose segment range meets the block's rows; equality is
//   symmetric, so dK/dV blocks plan their query tiles with the same code.
// * D = rowsum(dO * O) is computed in the kernel from the dO rows already in
//   shared memory: by dK/dV blocks for each streamed query tile (4 lanes a
//   row, O read from L2), by dQ blocks for their own rows (8 lanes a row, no
//   barrier). The wrapper launches this kernel and nothing else.
//
// bf16 (training with bf16 compute): q, k, v, o, dO bf16, lse f32; dQ, dK,
// dV bf16. It rounds where the Pallas backward does: D = rowsum(o * dO) in
// f32 (flash_attention.py:273-274), P and dS = scale * P * (dP - D) rounded
// to bf16 before their products (:900, :918, :1258), every product
// accumulated in f32 and each gradient cast to bf16 once at the end
// (:937-938, :1283). Bound: the same 7 * D multiply-adds a pair on the bf16
// tensor cores (989 TFLOP/s) against the bytes of eight bf16 [B, T, H, D]
// tensors; at the student's shape the bytes bound it, and a block's chain
// of latencies (loads, five dependent products, exponentials) is what
// takes the time. The design, for Hopper:
// * D once: a pre-pass kernel (a thread a row) writes D [B, H, T] f32 into
//   the caller's scratch; the main kernel is its programmatic dependent, so
//   its prologue (barriers, tile plan, own operands) overlaps the pre-pass
//   and only the reads of D wait for it (griddepcontrol.wait). As in
//   Pallas, D is computed once, outside the products.
// * The f32 kernel's block roles in one launch, the dK/dV blocks first, no
//   atomics (two calls are bit-identical): a block owns 64 rows (keys or
//   queries) and walks the planned 32-row tiles of the other side.
// * A block is one consumer warpgroup and one producer warp (160 threads).
//   The producer's lane 0 brings every tile in by TMA (rank-4 tensor maps
//   over [B, T, H, D], box 1 x 32 x 1 x D: rows past T arrive as zeros),
//   swizzled by the row's width (128, 64, 32 bytes for D = 64, 32, 16),
//   into a ring of 4 stages with full and empty mbarriers; each of its 32
//   lanes copies one row's lse, D and segment id by cp.async, which arrives
//   on the stage's barrier when it lands, so the producer never waits on a
//   load.
// * The consumers compute S^T = K Q^T and dP^T = V dO^T (dQ blocks: S =
//   Q K^T, dP = dO V^T) with wgmma m64n32k16, both operands in shared
//   memory (K-major), form P and dS in f32 in the accumulator registers,
//   round them to bf16 A fragments in place (the f32 accumulator of two
//   8-column chunks is one k-step's A fragment: no shuffle), and issue
//   dV += P^T dO (while dS is formed), dK += dS^T Q (dQ += dS K) as wgmma
//   m64nDk16 with A from registers and the streamed tile as an MN-major B
//   (the descriptor's transpose bit). The gradients leave through the own
//   operands' shared memory, laid out in TMA's swizzle, by TMA stores (the
//   fragments' own 4-byte global stores cut 16-byte row pieces and were
//   slower on the card).
// * 32-row tiles keep a consumer's live registers (two [64][D] f32
//   accumulators, the 64 x 32 S and dP) within the 136 a thread that three
//   blocks an SM leave (ptxas: 128): the student's 384 blocks run in one
//   wave on 132 SMs. setmaxnreg, which moves registers between whole
//   warpgroups, has nothing to take from a single producer warp. Issuing
//   the next tile's S and dP before this tile's dV / dK have landed needs
//   more registers than that: ptxas then serializes the wgmma pipeline, and
//   it ran slower on the card (convdr_torch.scripts.attention_bwd_bench),
//   at three blocks an SM and at two.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;       // 16 row groups x 8 lanes
constexpr int kRows = 64;           // rows a block owns: keys or queries
constexpr int kTile = 32;           // rows of a streamed tile
constexpr int kRM = 4;              // block rows a thread: ty + kRG * i
constexpr int kRG = kRows / kRM;    // row groups
constexpr int kTJ = kTile / 8;      // tile rows a thread: 8 * j + tx
constexpr int kPPitch = kTile + 8;  // floats a P / dS row (conflict-free stores)
constexpr int kMinBlocks = 3;

template <int D>
struct BwdTile {
  static constexpr int kChunks = D / 4;  // 16-byte chunks a row
  // swz(r) spreads the 8 rows a quarter warp reads over distinct banks: by
  // row at D >= 32, by pairs of rows at D = 16 (two rows a bank line)
  static constexpr int kSwzDiv = kChunks >= 8 ? 1 : 8 / kChunks;
  static constexpr int kSwzMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  static constexpr int kVec = D >= 32 ? 4 : 2;  // accumulated columns a load
  static constexpr int kOC = D / 8;             // accumulated columns a thread
  static constexpr int kOChunks = kOC / kVec;
  // a stage: two [kTile][D] tiles, then lse, segment ids and D of its rows
  static constexpr int kStageFloats = 2 * kTile * D + 3 * kTile;
  // the block's two [kRows][D] tiles, two stages, the P / dS buffer
  static constexpr int kFixedFloats = 2 * kRows * D + 2 * kStageFloats + kRows * kPPitch;
  static constexpr int kFixedBytes = 4 * kFixedFloats;

  __device__ static __forceinline__ int swz(int r) { return (r / kSwzDiv) & kSwzMask; }
  // the float offset of column col (within one 16-byte chunk and its
  // access) of row r in a swizzled [rows][D] tile
  __device__ static __forceinline__ int off(int r, int col) {
    return r * D + (((col >> 2) ^ swz(r)) << 2) + (col & 3);
  }
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;
  const int* seg;
  float* dq;
  float* dk;
  float* dv;
  int seq, heads;
  float scale;
};

template <int kVec>
__device__ __forceinline__ void load_vec(float* dst, const float* src);
template <>
__device__ __forceinline__ void load_vec<4>(float* dst, const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}
template <>
__device__ __forceinline__ void load_vec<2>(float* dst, const float* src) {
  const float2 x = *reinterpret_cast<const float2*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* dst, const float* src, float mul);
template <>
__device__ __forceinline__ void store_vec<4>(float* dst, const float* src, float mul) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(src[0] * mul, src[1] * mul, src[2] * mul, src[3] * mul);
}
template <>
__device__ __forceinline__ void store_vec<2>(float* dst, const float* src, float mul) {
  *reinterpret_cast<float2*>(dst) = make_float2(src[0] * mul, src[1] * mul);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
}

// Copies rows [r0, r0 + R) of one head of a [B, T, H, D] f32 operand into a
// swizzled shared tile (rows past T zero-filled).
template <int D, int R>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, long long base,
                                          long long tok, int r0, int seq) {
  using Tl = BwdTile<D>;
  constexpr int kC = Tl::kChunks;
  static_assert(R * kC % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < R * kC / kThreads; ++it) {
    const int c = threadIdx.x + it * kThreads;
    const int r = c / kC;
    const int ch = c % kC;
    const bool ok = r0 + r < seq;
    cp_async16(dst + Tl::off(r, 4 * ch), src + (ok ? base + (r0 + r) * tok + 4 * ch : 0), ok);
  }
}

// acc[i][j] += sum over d of a[ty + kRG i][d] * b[8 j + tx][d]: a is a
// block tile (rows broadcast within a quarter warp), b a streamed tile.
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[kRM][kTJ], const float* a,
                                             const float* b, int ty, int tx) {
  using Tl = BwdTile<D>;
  const int sa = Tl::swz(ty);  // = swz(ty + kRG i) for every i
  const int sb = Tl::swz(tx);  // = swz(8 j + tx) for every j
  const float* a_row = a + ty * D;
  const float* b_row = b + tx * D;
#pragma unroll 4
  for (int c = 0; c < Tl::kChunks; ++c) {
    float4 x[kRM], y[kTJ];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      x[i] = *reinterpret_cast<const float4*>(a_row + i * kRG * D + 4 * (c ^ sa));
#pragma unroll
    for (int j = 0; j < kTJ; ++j)
      y[j] = *reinterpret_cast<const float4*>(b_row + j * 8 * D + 4 * (c ^ sb));
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kTJ; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += sum over the tile's rows t of w[ty + kRG i][t] * x[t][col c],
// the thread's columns being tx * kVec + 8 kVec ch: w is the P / dS buffer
// (rows of this warp only), x a swizzled streamed tile.
template <int D>
__device__ __forceinline__ void tile_accumulate(float (&acc)[kRM][BwdTile<D>::kOC],
                                                const float* w, const float* x, int ty,
                                                int tx) {
  using Tl = BwdTile<D>;
  constexpr int kVec = Tl::kVec;
  const float* w_row = w + ty * kPPitch;
#pragma unroll 4
  for (int t0 = 0; t0 < kTile; t0 += 4) {
    float4 w4[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      w4[i] = *reinterpret_cast<const float4*>(w_row + i * kRG * kPPitch + t0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float xv[Tl::kOC];
#pragma unroll
      for (int ch = 0; ch < Tl::kOChunks; ++ch)
        load_vec<kVec>(xv + ch * kVec, x + Tl::off(t0 + e, tx * kVec + ch * 8 * kVec));
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float p = e == 0 ? w4[i].x : e == 1 ? w4[i].y : e == 2 ? w4[i].z : w4[i].w;
#pragma unroll
        for (int c = 0; c < Tl::kOC; ++c) acc[i][c] = fmaf(p, xv[c], acc[i][c]);
      }
    }
  }
}

// Writes rows ty + kRG i (those before T) of a gradient, times mul.
template <int D>
__device__ __forceinline__ void store_rows(float* g, const float (&acc)[kRM][BwdTile<D>::kOC],
                                           long long base, long long tok, int r0, int seq,
                                           int ty, int tx, float mul) {
  using Tl = BwdTile<D>;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = r0 + ty + kRG * i;
    if (row >= seq) continue;
#pragma unroll
    for (int ch = 0; ch < Tl::kOChunks; ++ch) {
      const int col = tx * Tl::kVec + ch * 8 * Tl::kVec;
      store_vec<Tl::kVec>(g + base + row * tok + col, acc[i] + ch * Tl::kVec, mul);
    }
  }
}

// dK and dV of keys [blk * kRows, + kRows), over the planned query tiles.
template <int D>
__device__ __forceinline__ void dkdv_block(const Args& a, int blk, float* smem, int* plan) {
  using Tl = BwdTile<D>;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tx = lane % 8;
  const int ty = (tid / 32) * 4 + lane / 8;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = a.seq;
  const long long tok = static_cast<long long>(a.heads) * D;
  const long long base = static_cast<long long>(b) * seq * tok + static_cast<long long>(h) * D;
  const int* segb = a.seg + static_cast<long long>(b) * seq;
  const long long row_stats = (static_cast<long long>(b) * a.heads + h) * seq;
  const int k0 = blk * kRows;
  float* ks = smem;
  float* vs = ks + kRows * D;
  float* stages = vs + kRows * D;
  float* pbuf = stages + 2 * Tl::kStageFloats;

  copy_rows<D, kRows>(ks, a.k, base, tok, k0, seq);
  copy_rows<D, kRows>(vs, a.v, base, tok, k0, seq);
  cp_async_commit();

  int segk[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int key = k0 + ty + kRG * i;
    segk[i] = key < seq ? segb[key] : kNoSegment + 1;  // a key past T sees nothing
  }

  auto load_tile = [&](int tile, int stage) {
    float* st = stages + stage * Tl::kStageFloats;
    const int q0 = tile * kTile;
    copy_rows<D, kTile>(st, a.q, base, tok, q0, seq);
    copy_rows<D, kTile>(st + kTile * D, a.dout, base, tok, q0, seq);
    float* lse_s = st + 2 * kTile * D;
    int* seg_s = reinterpret_cast<int*>(lse_s + kTile);
    if (tid < kTile) {
      const int qi = q0 + tid;
      if (qi < seq)
        cp_async4(lse_s + tid, a.lse + row_stats + qi);
      else
        lse_s[tid] = 0.f;
    } else if (tid < 2 * kTile) {
      const int c = tid - kTile;
      if (q0 + c < seq)
        cp_async4(seg_s + c, segb + q0 + c);
      else
        seg_s[c] = kNoSegment;
    }
  };

  const int n = plan_tiles<kRows, kTile, kThreads>(segb, seq, k0, plan);
  if (n > 0) load_tile(plan[0], 0);
  cp_async_commit();

  float dk[kRM][Tl::kOC], dv[kRM][Tl::kOC];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int c = 0; c < Tl::kOC; ++c) dk[i][c] = dv[i][c] = 0.f;
  const float scale_log2 = a.scale * kLog2e;
  float* p_row = pbuf + ty * kPPitch;  // row i at + i * kRG * kPPitch

  for (int idx = 0; idx < n; ++idx) {
    cp_async_wait_all();
    __syncthreads();  // tile idx landed; the other stage is free
    if (idx + 1 < n) load_tile(plan[idx + 1], (idx + 1) & 1);
    cp_async_commit();
    float* qs = stages + (idx & 1) * Tl::kStageFloats;
    const float* dos = qs + kTile * D;
    const float* lse_s = dos + kTile * D;
    const int* seg_s = reinterpret_cast<const int*>(lse_s + kTile);
    float* dl_s = qs + 2 * kTile * D + 2 * kTile;
    const int q0 = plan[idx] * kTile;

    {  // D of the tile's queries, 4 lanes a row: O from L2, dO in the stage
      const int r = tid / 4;
      const int part = tid % 4;
      const bool live = q0 + r < seq;
      const float* o_row = a.o + base + (live ? (q0 + r) * tok : 0);
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < Tl::kChunks / 4; ++m) {
        const int c = part + 4 * m;
        if (live)
          acc += dot4(__ldg(reinterpret_cast<const float4*>(o_row + 4 * c)),
                      *reinterpret_cast<const float4*>(dos + Tl::off(r, 4 * c)));
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) dl_s[r] = acc;
    }

    // S^T = K Q^T and dP^T = V dO^T: keys ty + kRG i, queries 8 j + tx
    float s[kRM][kTJ], dp[kRM][kTJ];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kTJ; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_product<D>(s, ks, qs, ty, tx);
    tile_product<D>(dp, vs, dos, ty, tx);
    __syncthreads();  // the tile's D is written

#pragma unroll
    for (int j = 0; j < kTJ; ++j) {
      const int t = 8 * j + tx;
      const float l2 = lse_s[t] * kLog2e;
      const float dt = dl_s[t];
      const int sq = seg_s[t];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float p = sq == segk[i] ? fast_exp2(fmaf(s[i][j], scale_log2, -l2)) : 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dt);
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kTJ; ++j) p_row[i * kRG * kPPitch + 8 * j + tx] = s[i][j];
    __syncwarp();
    tile_accumulate<D>(dv, pbuf, dos, ty, tx);  // dV += P^T dO
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kTJ; ++j) p_row[i * kRG * kPPitch + 8 * j + tx] = dp[i][j];
    __syncwarp();
    tile_accumulate<D>(dk, pbuf, qs, ty, tx);  // dK += dS^T Q (scaled at the end)
  }
  cp_async_wait_all();

  store_rows<D>(a.dk, dk, base, tok, k0, seq, ty, tx, a.scale);
  store_rows<D>(a.dv, dv, base, tok, k0, seq, ty, tx, 1.f);
}

// dQ of queries [blk * kRows, + kRows), over the planned key tiles.
template <int D>
__device__ __forceinline__ void dq_block(const Args& a, int blk, float* smem, int* plan) {
  using Tl = BwdTile<D>;
  constexpr int kVec = Tl::kVec;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tx = lane % 8;
  const int ty = (tid / 32) * 4 + lane / 8;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = a.seq;
  const long long tok = static_cast<long long>(a.heads) * D;
  const long long base = static_cast<long long>(b) * seq * tok + static_cast<long long>(h) * D;
  const int* segb = a.seg + static_cast<long long>(b) * seq;
  const long long row_stats = (static_cast<long long>(b) * a.heads + h) * seq;
  const int q0 = blk * kRows;
  float* qs = smem;
  float* dos = qs + kRows * D;
  float* stages = dos + kRows * D;
  float* pbuf = stages + 2 * Tl::kStageFloats;

  copy_rows<D, kRows>(qs, a.q, base, tok, q0, seq);
  copy_rows<D, kRows>(dos, a.dout, base, tok, q0, seq);
  cp_async_commit();

  // this thread's rows: segment and lse (log2 domain)
  int segq[kRM];
  float lse2[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = q0 + ty + kRG * i;
    const bool live = row < seq;
    segq[i] = live ? segb[row] : kNoSegment + 1;  // a query past T sees nothing
    lse2[i] = live ? a.lse[row_stats + row] * kLog2e : 0.f;
  }

  auto load_tile = [&](int tile, int stage) {
    float* st = stages + stage * Tl::kStageFloats;
    const int k0 = tile * kTile;
    copy_rows<D, kTile>(st, a.k, base, tok, k0, seq);
    copy_rows<D, kTile>(st + kTile * D, a.v, base, tok, k0, seq);
    int* seg_s = reinterpret_cast<int*>(st + 2 * kTile * D);
    if (tid < kTile) {
      if (k0 + tid < seq)
        cp_async4(seg_s + tid, segb + k0 + tid);
      else
        seg_s[tid] = kNoSegment;
    }
  };

  const int n = plan_tiles<kRows, kTile, kThreads>(segb, seq, q0, plan);
  if (n > 0) load_tile(plan[0], 0);
  cp_async_commit();

  float dq[kRM][Tl::kOC];
  float dl[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    dl[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Tl::kOC; ++c) dq[i][c] = 0.f;
  }
  const float scale_log2 = a.scale * kLog2e;
  float* p_row = pbuf + ty * kPPitch;

  for (int idx = 0; idx < n; ++idx) {
    cp_async_wait_all();
    __syncthreads();  // tile idx (and Q, dO) landed; the other stage is free
    if (idx == 0) {  // D of this thread's rows, summed over its row group's 8 lanes
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int row = q0 + ty + kRG * i;
        float xv[Tl::kOC], ov[Tl::kOC];
#pragma unroll
        for (int ch = 0; ch < Tl::kOChunks; ++ch) {
          const int col = tx * kVec + ch * 8 * kVec;
          load_vec<kVec>(xv + ch * kVec, dos + Tl::off(ty + kRG * i, col));
          load_vec<kVec>(ov + ch * kVec, a.o + base + (row < seq ? row * tok : 0) + col);
        }
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < Tl::kOC; ++c) acc = fmaf(ov[c], xv[c], acc);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        dl[i] = acc;
      }
    }
    if (idx + 1 < n) load_tile(plan[idx + 1], (idx + 1) & 1);
    cp_async_commit();
    const float* ks = stages + (idx & 1) * Tl::kStageFloats;
    const float* vs = ks + kTile * D;
    const int* seg_s = reinterpret_cast<const int*>(vs + kTile * D);

    // S = Q K^T and dP = dO V^T: queries ty + kRG i, keys 8 j + tx
    float s[kRM][kTJ], dp[kRM][kTJ];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kTJ; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_product<D>(s, qs, ks, ty, tx);
    tile_product<D>(dp, dos, vs, ty, tx);

#pragma unroll
    for (int j = 0; j < kTJ; ++j) {
      const int sk = seg_s[8 * j + tx];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float p = sk == segq[i] ? fast_exp2(fmaf(s[i][j], scale_log2, -lse2[i])) : 0.f;
        p_row[i * kRG * kPPitch + 8 * j + tx] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncwarp();
    tile_accumulate<D>(dq, pbuf, ks, ty, tx);  // dQ += dS K (scaled at the end)
  }
  cp_async_wait_all();

  store_rows<D>(a.dq, dq, base, tok, q0, seq, ty, tx, a.scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks) flash_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  int* plan = reinterpret_cast<int*>(smem + BwdTile<D>::kFixedFloats);
  const int half = gridDim.x / 2;  // the dK/dV blocks come first
  if (blockIdx.x < half)
    dkdv_block<D>(a, blockIdx.x, smem, plan);
  else
    dq_block<D>(a, blockIdx.x - half, smem, plan);
}

// ---------------------------------------------------------------------------
// bf16: wgmma over TMA tiles
// ---------------------------------------------------------------------------
constexpr int kWgRows = 64;                    // rows a block owns: one wgmma M
constexpr int kWgTile = 32;                    // rows of a streamed tile: the wgmma N of S, dP
constexpr int kWgStages = 4;                   // the ring of streamed tiles
constexpr int kWgConsumers = 128;              // one warpgroup
constexpr int kWgThreads = kWgConsumers + 32;  // and the producer warp
constexpr int kWgMinBlocks = 3;
constexpr int kRowDotThreads = 256;

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

// The low and high bf16 of a packed pair as f32 (exact).
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// The pre-pass: D[b, h, t] = sum over d of o[b, t, h, d] * dO[b, t, h, d]
// in f32, once for every row: D / 8 lanes a row, one 16-byte load of each
// operand a lane (a warp reads whole consecutive rows), summed over the
// row's lanes by shuffles.
template <int D>
__global__ void __launch_bounds__(kRowDotThreads)
    row_dot_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                   float* __restrict__ delta, int seq, int heads, long long rows) {
  constexpr int kLanes = D / 8;
  grid_launch_dependents();  // the main kernel's prologue may start
  const long long r = (static_cast<long long>(blockIdx.x) * kRowDotThreads + threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  float acc = 0.f;
  if (r < rows) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(o + r * D) + part);
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(dout + r * D) + part);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc = fmaf(bf16_lo(xs[e]), bf16_lo(ys[e]), acc);
      acc = fmaf(bf16_hi(xs[e]), bf16_hi(ys[e]), acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r >= rows || part != 0) return;
  const long long bt = r / heads;  // r = (b * T + t) * H + h
  const long long h = r - bt * heads;
  const long long b = bt / seq;
  const long long t = bt - b * seq;
  delta[(b * heads + h) * seq + t] = acc;
}

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
  return Config{reinterpret_cast<const void*>(flash_bwd_kernel<D>),
                BwdTile<D>::kFixedBytes + (plan_bytes(seq, kTile) + 15) / 16 * 16, kTile,
                kThreads};
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
         (seq + kRows - 1) / kRows <= (1 << 30) && (dtype == 0 || dtype == 1) &&
         (head_dim == 16 || head_dim == 32 || head_dim == 64);
}

template <int D>
cudaError_t launch_row_dot(const void* o, const void* dout, void* delta, int batch, int seq,
                           int heads, cudaStream_t st) {
  const long long rows = static_cast<long long>(batch) * seq * heads;
  constexpr int kRowsABlock = kRowDotThreads / (D / 8);
  row_dot_kernel<D><<<static_cast<unsigned>((rows + kRowsABlock - 1) / kRowsABlock),
                      kRowDotThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(o),
                                               static_cast<const __nv_bfloat16*>(dout),
                                               static_cast<float*>(delta), seq, heads, rows);
  return cudaGetLastError();
}

cudaError_t row_dot_for(const void* o, const void* dout, void* delta, int batch, int seq,
                        int heads, int head_dim, cudaStream_t st) {
  switch (head_dim) {
    case 16: return launch_row_dot<16>(o, dout, delta, batch, seq, heads, st);
    case 32: return launch_row_dot<32>(o, dout, delta, batch, seq, heads, st);
    default: return launch_row_dot<64>(o, dout, delta, batch, seq, heads, st);
  }
}

// The bf16 backward: the tensor maps, the D pre-pass, then the main kernel
// launched as its programmatic dependent (its prologue overlaps the
// pre-pass; it reads D after griddepcontrol.wait).
cudaError_t launch_bf16(const Config& cfg, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse, const void* seg,
                        void* delta, void* dq, void* dk, void* dv, int batch, int seq, int heads,
                        int head_dim, float scale, cudaStream_t st) {
  CUtensorMap maps[7];
  const void* base[7] = {q, k, v, dout, dq, dk, dv};
  for (int i = 0; i < 7; ++i)
    if (!encode_bthd_map(&maps[i], base[i], batch, seq, heads, head_dim, kWgTile))
      return cudaErrorInvalidValue;
  cudaError_t err = row_dot_for(o, dout, delta, batch, seq, heads, head_dim, st);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t lc = {};
  // one dK/dV and one dQ block per 64 rows, the dK/dV blocks first
  lc.gridDim = dim3(2 * ((seq + kWgRows - 1) / kWgRows), heads, batch);
  lc.blockDim = dim3(kWgThreads);
  lc.dynamicSmemBytes = cfg.smem;
  lc.stream = st;
  lc.attrs = attr;
  lc.numAttrs = 1;
  const WgArgs args{static_cast<const float*>(lse), static_cast<const float*>(delta),
                    static_cast<const int*>(seg), seq, heads, scale};
  using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                          CUtensorMap, CUtensorMap, WgArgs);
  return cudaLaunchKernelEx(&lc, reinterpret_cast<Kernel>(const_cast<void*>(cfg.fn)), maps[0],
                            maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], args);
}

}  // namespace

// dQ, dK, dV of one flash-attention call, head_dim 16, 32 or 64; dtype 0 =
// float32 (every tensor f32), 1 = bfloat16 (q, k, v, o, dout and the
// gradients bf16); o is the forward's output, lse its [B, H, T] f32
// log-sum-exp. delta is [B, H, T] f32 scratch the bf16 path fills with D =
// rowsum(o * dout) before its main kernel reads it (unused by f32; may be
// null there). Returns a cudaError_t (0 = launched).
extern "C" int convdr_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          const void* seg, void* dq, void* dk, void* dv,
                                          void* delta, int batch, int seq, int heads,
                                          int head_dim, float scale, int dtype, void* stream) {
  if (!valid_args(batch, seq, heads, head_dim, dtype) || (dtype == 1 && delta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config_for(seq, head_dim, dtype);
  cudaError_t err = allow_smem(cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(launch_bf16(cfg, q, k, v, o, dout, lse, seg, delta, dq, dk, dv,
                                        batch, seq, heads, head_dim, scale, st));
  // one dK/dV and one dQ block per 64 rows, the dK/dV blocks first
  const dim3 grid(2 * ((seq + kRows - 1) / kRows), heads, batch);
  const Args args{static_cast<const float*>(q),    static_cast<const float*>(k),
                  static_cast<const float*>(v),    static_cast<const float*>(o),
                  static_cast<const float*>(dout), static_cast<const float*>(lse),
                  static_cast<const int*>(seg),    static_cast<float*>(dq),
                  static_cast<float*>(dk),         static_cast<float*>(dv),
                  seq,                             heads,
                  scale};
  reinterpret_cast<void (*)(Args)>(const_cast<void*>(cfg.fn))
      <<<grid, kThreads, cfg.smem, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 pre-pass alone: delta [B, H, T] f32 = rowsum(o * dout) of bf16
// [B, T, H, D] o and dout. Returns a cudaError_t.
extern "C" int convdr_flash_attention_bwd_delta(const void* o, const void* dout, void* delta,
                                                int batch, int seq, int heads, int head_dim,
                                                void* stream) {
  if (!valid_args(batch, seq, heads, head_dim, 1)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(row_dot_for(o, dout, delta, batch, seq, heads, head_dim,
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
  out[2] = kRows;
  out[3] = blocks;
  out[4] = cfg.tile;
  return static_cast<int>(err);
}
