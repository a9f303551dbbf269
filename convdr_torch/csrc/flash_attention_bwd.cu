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
// tensors; at the student's shape the bytes bound it. The design keeps the
// f32 kernel's block roles, one launch and no atomics (two calls are
// bit-identical):
// * A block is 4 warps and 64 rows, each warp owning 16: its own rows' two
//   operands (K and V for dK/dV blocks, Q and dO for dQ blocks) live in
//   registers as `mma.sync` A fragments for the whole walk.
// * The other side streams through a 2-stage cp.async ring in 64-row tiles
//   (Q, dO, their lse, D and segment ids; or K, V and ids), rows padded by
//   16 bytes so `ldmatrix` reads are conflict-free.
// * Per tile a warp computes its 16 x 64 blocks of S and dP with m16n8k16
//   bf16 MMAs (B fragments by `ldmatrix` of the tile's rows), forms P and
//   dS in f32 registers, packs them to bf16 A fragments in place (the C
//   fragments of two 8-column tiles are one A fragment) and multiplies them
//   by the tile's rows read through `ldmatrix.trans`: dV += P^T dO and
//   dK += dS^T Q, or dQ += dS K. Nothing goes through shared memory but
//   the streamed tiles.
// * D of a streamed query tile is computed as the tile is issued (2 threads
//   a row, O and dO read from L2) into the stage; a dQ block computes its
//   own rows' D with two lanes a row and shuffles.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_common.cuh"

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
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;                 // 16 block rows each
constexpr int kMmaThreads = 32 * kMmaWarps;  // = kThreads
constexpr int kMmaRows = 16 * kMmaWarps;     // rows a block owns (= kRows)
constexpr int kMmaTile = 64;                 // rows of a streamed tile
static_assert(kMmaThreads == kThreads && kMmaRows == kRows, "one grid for both dtypes");

struct MmaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;
  const int* seg;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int seq, heads;
  float scale;
};

template <int D>
struct MmaBwdTile {
  static constexpr int kStride = D + 8;  // bf16 a shared row: 16 bytes pad
  static constexpr int kTileElems = kMmaTile * kStride;
  // a stage: two [kMmaTile][kStride] tiles, then lse, D and segment ids
  static constexpr int kStageBytes = 2 * kTileElems * 2 + 3 * kMmaTile * 4;
  static constexpr int kFixedBytes = 2 * kStageBytes;
};

// The low and high bf16 of a packed pair as f32 (exact).
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// The sum over columns [half * D/2, (half + 1) * D/2) of x[row] * y[row] in
// f32 (0 for a row past T): half of one row's D = rowsum(o * dO).
template <int D>
__device__ __forceinline__ float half_row_dot(const __nv_bfloat16* x, const __nv_bfloat16* y,
                                              long long base, long long tok, int row, int half,
                                              int seq) {
  float acc = 0.f;
  if (row >= seq) return acc;
  const long long off = base + row * tok + half * (D / 2);
  const uint4* xp = reinterpret_cast<const uint4*>(x + off);
  const uint4* yp = reinterpret_cast<const uint4*>(y + off);
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {  // 8 bf16 a 16-byte load
    const uint4 xa = __ldg(xp + c);
    const uint4 yb = __ldg(yp + c);
    const uint32_t xs[4] = {xa.x, xa.y, xa.z, xa.w};
    const uint32_t ys[4] = {yb.x, yb.y, yb.z, yb.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc = fmaf(bf16_lo(xs[e]), bf16_lo(ys[e]), acc);
      acc = fmaf(bf16_hi(xs[e]), bf16_hi(ys[e]), acc);
    }
  }
  return acc;
}

// One block's gradients: kKV, dK and dV of keys [blk * 64, + 64) over the
// planned query tiles; else dQ of queries [blk * 64, + 64) over the planned
// key tiles. Warp w owns block rows 16w..16w+15; in the mma fragments lane
// (g = lane / 4, t = lane % 4) holds rows g and g + 8 at columns 2t, 2t + 1.
template <int D, bool kKV>
__device__ __forceinline__ void mma_bwd_block(const MmaArgs& a, int blk, unsigned char* smem,
                                              int* plan) {
  using Tl = MmaBwdTile<D>;
  constexpr int kStride = Tl::kStride;
  constexpr int kChunks = D / 16;          // k-steps over D
  constexpr int kDTiles = D / 8;           // 8-wide column tiles of a gradient
  constexpr int kColTiles = kMmaTile / 8;  // 8-wide column tiles of S and dP
  constexpr int kVecPerRow = D / 8;        // 16-byte chunks a row
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int mi = lane / 8;  // the ldmatrix matrix this lane addresses
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = a.seq;
  const long long tok = static_cast<long long>(a.heads) * D;
  const long long base = static_cast<long long>(b) * seq * tok + static_cast<long long>(h) * D;
  const int* segb = a.seg + static_cast<long long>(b) * seq;
  const long long row_stats = (static_cast<long long>(b) * a.heads + h) * seq;
  const int r0 = blk * kMmaRows;
  // the block's own operands, and the streamed ones
  const __nv_bfloat16* own1 = kKV ? a.k : a.q;
  const __nv_bfloat16* own2 = kKV ? a.v : a.dout;
  const __nv_bfloat16* str1 = kKV ? a.q : a.k;
  const __nv_bfloat16* str2 = kKV ? a.dout : a.v;

  int rows[2];
  rows[0] = r0 + warp * 16 + g;
  rows[1] = rows[0] + 8;
  bool live[2];
  int segr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    live[r] = rows[r] < seq;
    segr[r] = live[r] ? segb[rows[r]] : kNoSegment + 1;  // a row past T sees nothing
  }
  // own rows as A fragments: f[c][0] (row g, cols 16c + 2t, +1), f[c][1]
  // (row g + 8), f[c][2] / f[c][3] the same rows at cols 16c + 8 + 2t
  uint32_t f1[kChunks][4], f2[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i & 1;
      const long long off = base + rows[r] * tok + 16 * c + 8 * (i >> 1) + 2 * t;
      f1[c][i] = live[r] ? ld_u32(own1 + off) : 0u;
      f2[c][i] = live[r] ? ld_u32(own2 + off) : 0u;
    }
  // dQ blocks: their rows' lse (log2 domain) and D, two lanes a row
  float lse2[2] = {0.f, 0.f};
  float drow[2] = {0.f, 0.f};
  if constexpr (!kKV) {
    float acc = half_row_dot<D>(a.o, a.dout, base, tok, r0 + warp * 16 + lane / 2, lane % 2, seq);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    drow[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    drow[1] = __shfl_sync(0xffffffffu, acc, 2 * (g + 8));
#pragma unroll
    for (int r = 0; r < 2; ++r) lse2[r] = live[r] ? a.lse[row_stats + rows[r]] * kLog2e : 0.f;
  }

  auto load_tile = [&](int tile, int stage) {
    __nv_bfloat16* t1 = reinterpret_cast<__nv_bfloat16*>(smem + stage * Tl::kStageBytes);
    __nv_bfloat16* t2 = t1 + Tl::kTileElems;
    float* lse_s = reinterpret_cast<float*>(t2 + Tl::kTileElems);
    float* d_s = lse_s + kMmaTile;
    int* seg_s = reinterpret_cast<int*>(d_s + kMmaTile);
    const int c0 = tile * kMmaTile;
    constexpr int kTotal = kMmaTile * kVecPerRow;
#pragma unroll
    for (int it = 0; it < (kTotal + kMmaThreads - 1) / kMmaThreads; ++it) {
      const int c = tid + it * kMmaThreads;
      if (kTotal % kMmaThreads != 0 && c >= kTotal) break;
      const int r = c / kVecPerRow;
      const int col = (c % kVecPerRow) * 8;
      const bool ok = c0 + r < seq;
      const long long off = ok ? base + (c0 + r) * tok + col : 0;
      cp_async16(t1 + r * kStride + col, str1 + off, ok);
      cp_async16(t2 + r * kStride + col, str2 + off, ok);
    }
    if (tid < kMmaTile) {
      if (c0 + tid < seq)
        cp_async4(seg_s + tid, segb + c0 + tid);
      else
        seg_s[tid] = kNoSegment;
    }
    if constexpr (kKV) {
      if (tid < kMmaTile) {
        if (c0 + tid < seq)
          cp_async4(lse_s + tid, a.lse + row_stats + c0 + tid);
        else
          lse_s[tid] = 0.f;
      }
      // D of the tile's queries, two threads a row
      float acc = half_row_dot<D>(a.o, a.dout, base, tok, c0 + tid / 2, tid % 2, seq);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (tid % 2 == 0) d_s[tid / 2] = acc;
    }
  };

  const int n = plan_tiles<kMmaRows, kMmaTile, kMmaThreads>(segb, seq, r0, plan);
  if (n > 0) load_tile(plan[0], 0);
  cp_async_commit();

  float acc1[kDTiles][4];  // dV (dK/dV blocks) or dQ
  float acc2[kDTiles][4];  // dK (dK/dV blocks)
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[j][i] = acc2[j][i] = 0.f;
  const float scale = a.scale;
  const float scale_log2 = scale * kLog2e;

  for (int idx = 0; idx < n; ++idx) {
    cp_async_wait_all();
    __syncthreads();  // tile idx landed; the other stage is free
    if (idx + 1 < n) load_tile(plan[idx + 1], (idx + 1) & 1);
    cp_async_commit();

    const unsigned char* st = smem + (idx & 1) * Tl::kStageBytes;
    const __nv_bfloat16* t1 = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* t2 = t1 + Tl::kTileElems;
    const float* lse_s = reinterpret_cast<const float*>(t2 + Tl::kTileElems);
    const float* d_s = lse_s + kMmaTile;
    const int* seg_s = reinterpret_cast<const int*>(d_s + kMmaTile);

    // S = own1 str1^T and dP = own2 str2^T (for dK/dV blocks the transposes
    // S^T and dP^T): s[j] holds the tile's columns 8j..8j+7; one x4
    // ldmatrix gives the B fragments of column tiles 2jp and 2jp + 1
    float s[kColTiles][4], dp[kColTiles][4];
#pragma unroll
    for (int j = 0; j < kColTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int jp = 0; jp < kColTiles / 2; ++jp) {
      const int roff = (16 * jp + 8 * (mi >> 1) + lane % 8) * kStride + 8 * (mi & 1);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        uint32_t bf[4];
        ldmatrix_x4(bf, t1 + roff + 16 * c);
        mma_bf16(s[2 * jp], f1[c], bf[0], bf[1]);
        mma_bf16(s[2 * jp + 1], f1[c], bf[2], bf[3]);
        ldmatrix_x4(bf, t2 + roff + 16 * c);
        mma_bf16(dp[2 * jp], f2[c], bf[0], bf[1]);
        mma_bf16(dp[2 * jp + 1], f2[c], bf[2], bf[3]);
      }
    }

    // P = exp(scale S - lse) where the segments match, else 0, and dS =
    // (dP - D) P scale, in f32 (the query's lse and D: per column for dK/dV
    // blocks, per row for dQ blocks)
#pragma unroll
    for (int j = 0; j < kColTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const int sc = seg_s[col];
        float l2c = 0.f, dc = 0.f;
        if constexpr (kKV) {
          l2c = lse_s[col] * kLog2e;
          dc = d_s[col];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 2 * r + e;
          const float l2 = kKV ? l2c : lse2[r];
          const float dd = kKV ? dc : drow[r];
          const float p = sc == segr[r] ? fast_exp2(fmaf(s[j][i], scale_log2, -l2)) : 0.f;
          s[j][i] = p;
          dp[j][i] = (dp[j][i] - dd) * p * scale;
        }
      }

    // dV += P^T dO and dK += dS^T Q (dK/dV blocks), or dQ += dS K: P and dS
    // as bf16 A fragments, 16 tile rows a k-step; the tile's rows (the
    // k-dimension) as B fragments through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < kColTiles / 2; ++kc) {
      uint32_t pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kc + (i >> 1);
        const int r = i & 1;
        pa[i] = pack_bf16(s[j][2 * r], s[j][2 * r + 1]);
        da[i] = pack_bf16(dp[j][2 * r], dp[j][2 * r + 1]);
      }
#pragma unroll
      for (int dpi = 0; dpi < kDTiles / 2; ++dpi) {
        // matrix i: tile rows 16kc + 8*(i&1) .., columns 16dpi + 8*(i>>1) ..;
        // registers 0/1 feed column tile 2dpi, 2/3 column tile 2dpi + 1
        const int toff = (16 * kc + 8 * (mi & 1) + lane % 8) * kStride + 16 * dpi + 8 * (mi >> 1);
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, t1 + toff);
        if constexpr (kKV) {
          mma_bf16(acc2[2 * dpi], da, bf[0], bf[1]);
          mma_bf16(acc2[2 * dpi + 1], da, bf[2], bf[3]);
          ldmatrix_x4_trans(bf, t2 + toff);
          mma_bf16(acc1[2 * dpi], pa, bf[0], bf[1]);
          mma_bf16(acc1[2 * dpi + 1], pa, bf[2], bf[3]);
        } else {
          mma_bf16(acc1[2 * dpi], da, bf[0], bf[1]);
          mma_bf16(acc1[2 * dpi + 1], da, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait_all();

  // each gradient cast to bf16 once
  auto store = [&](__nv_bfloat16* grad, const float (&acc)[kDTiles][4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      __nv_bfloat16* op = grad + base + rows[r] * tok + 2 * t;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j)
        *reinterpret_cast<uint32_t*>(op + 8 * j) = pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  };
  if constexpr (kKV) {
    store(a.dk, acc2);
    store(a.dv, acc1);
  } else {
    store(a.dq, acc1);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_mma_kernel(MmaArgs a) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  int* plan = reinterpret_cast<int*>(mma_smem + MmaBwdTile<D>::kFixedBytes);
  const int half = gridDim.x / 2;  // the dK/dV blocks come first
  if (blockIdx.x < half)
    mma_bwd_block<D, true>(a, blockIdx.x, mma_smem, plan);
  else
    mma_bwd_block<D, false>(a, blockIdx.x - half, mma_smem, plan);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Config {
  const void* fn;
  int smem;  // dynamic shared memory bytes
  int tile;  // rows of a streamed tile
};

template <int D>
Config config(int seq, int dtype) {
  if (dtype == 1)
    return Config{reinterpret_cast<const void*>(flash_bwd_mma_kernel<D>),
                  MmaBwdTile<D>::kFixedBytes + (plan_bytes(seq, kMmaTile) + 15) / 16 * 16,
                  kMmaTile};
  return Config{reinterpret_cast<const void*>(flash_bwd_kernel<D>),
                BwdTile<D>::kFixedBytes + (plan_bytes(seq, kTile) + 15) / 16 * 16, kTile};
}

Config config_for(int seq, int head_dim, int dtype) {
  switch (head_dim) {
    case 16: return config<16>(seq, dtype);
    case 32: return config<32>(seq, dtype);
    case 64: return config<64>(seq, dtype);
    default: return Config{nullptr, 0, 0};
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

}  // namespace

// dQ, dK, dV of one flash-attention call, head_dim 16, 32 or 64; dtype 0 =
// float32 (every tensor f32), 1 = bfloat16 (q, k, v, o, dout and the
// gradients bf16); o is the forward's output, lse its [B, H, T] f32
// log-sum-exp. Returns a cudaError_t (0 = launched).
extern "C" int convdr_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          const void* seg, void* dq, void* dk, void* dv,
                                          int batch, int seq, int heads, int head_dim,
                                          float scale, int dtype, void* stream) {
  if (!valid_args(batch, seq, heads, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config_for(seq, head_dim, dtype);
  cudaError_t err = allow_smem(cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one dK/dV and one dQ block per 64 rows, the dK/dV blocks first
  const dim3 grid(2 * ((seq + kRows - 1) / kRows), heads, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using B16 = __nv_bfloat16;
    const MmaArgs args{static_cast<const B16*>(q),     static_cast<const B16*>(k),
                       static_cast<const B16*>(v),     static_cast<const B16*>(o),
                       static_cast<const B16*>(dout),  static_cast<const float*>(lse),
                       static_cast<const int*>(seg),   static_cast<B16*>(dq),
                       static_cast<B16*>(dk),          static_cast<B16*>(dv),
                       seq,                            heads,
                       scale};
    reinterpret_cast<void (*)(MmaArgs)>(const_cast<void*>(cfg.fn))
        <<<grid, kMmaThreads, cfg.smem, st>>>(args);
  } else {
    const Args args{static_cast<const float*>(q),    static_cast<const float*>(k),
                    static_cast<const float*>(v),    static_cast<const float*>(o),
                    static_cast<const float*>(dout), static_cast<const float*>(lse),
                    static_cast<const int*>(seg),    static_cast<float*>(dq),
                    static_cast<float*>(dk),         static_cast<float*>(dv),
                    seq,                             heads,
                    scale};
    reinterpret_cast<void (*)(Args)>(const_cast<void*>(cfg.fn))
        <<<grid, kThreads, cfg.smem, st>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cfg.fn, kThreads, cfg.smem);
  out[0] = kThreads;
  out[1] = cfg.smem;
  out[2] = kRows;
  out[3] = blocks;
  out[4] = cfg.tile;
  return static_cast<int>(err);
}
