// Flash attention backward with segment-id masking, f32, for Hopper (sm_90a).
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

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

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
// launch
// ---------------------------------------------------------------------------
struct Config {
  void (*fn)(Args);
  int smem;  // dynamic shared memory bytes
};

template <int D>
Config config(int seq) {
  return Config{flash_bwd_kernel<D>,
                BwdTile<D>::kFixedBytes + (plan_bytes(seq, kTile) + 15) / 16 * 16};
}

Config config_for(int seq, int head_dim) {
  switch (head_dim) {
    case 16: return config<16>(seq);
    case 32: return config<32>(seq);
    case 64: return config<64>(seq);
    default: return Config{nullptr, 0};
  }
}

// Launches above 48 KB of dynamic shared memory need the limit raised first.
cudaError_t allow_smem(const Config& cfg) {
  if (cfg.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(cfg.fn),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
}

bool valid_args(int batch, int seq, int heads, int head_dim) {
  return batch > 0 && seq > 0 && heads > 0 && batch <= 65535 && heads <= 65535 &&
         (seq + kRows - 1) / kRows <= (1 << 30) &&
         (head_dim == 16 || head_dim == 32 || head_dim == 64);
}

}  // namespace

// dQ, dK, dV of one flash-attention call, f32, head_dim 16, 32 or 64; o is
// the forward's output, lse its [B, H, T] log-sum-exp. Returns a
// cudaError_t (0 = launched).
extern "C" int convdr_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          const void* seg, void* dq, void* dk, void* dv,
                                          int batch, int seq, int heads, int head_dim,
                                          float scale, void* stream) {
  if (!valid_args(batch, seq, heads, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config_for(seq, head_dim);
  cudaError_t err = allow_smem(cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args args{static_cast<const float*>(q),    static_cast<const float*>(k),
                  static_cast<const float*>(v),    static_cast<const float*>(o),
                  static_cast<const float*>(dout), static_cast<const float*>(lse),
                  static_cast<const int*>(seg),    static_cast<float*>(dq),
                  static_cast<float*>(dk),         static_cast<float*>(dv),
                  seq,                             heads,
                  scale};
  // one dK/dV and one dQ block per 64 rows, the dK/dV blocks first
  const dim3 grid(2 * ((seq + kRows - 1) / kRows), heads, batch);
  cfg.fn<<<grid, kThreads, cfg.smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration for a problem: out[0] threads a block, out[1]
// dynamic shared memory bytes, out[2] rows a block, out[3] resident blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the
// shared-memory attribute is set), out[4] rows a streamed tile. Returns a
// cudaError_t.
extern "C" int convdr_flash_attention_bwd_config(int batch, int seq, int heads, int head_dim,
                                                 int* out) {
  if (!valid_args(batch, seq, heads, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config_for(seq, head_dim);
  cudaError_t err = allow_smem(cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reinterpret_cast<const void*>(cfg.fn), kThreads, cfg.smem);
  out[0] = kThreads;
  out[1] = cfg.smem;
  out[2] = kRows;
  out[3] = blocks;
  out[4] = kTile;
  return static_cast<int>(err);
}
