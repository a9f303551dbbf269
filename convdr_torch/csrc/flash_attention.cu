// Flash attention forward with segment-id masking, for Hopper (sm_90a).
//
// Replaces: convdr_tpu/models/attention.py:54-92, `flash_attention`, which
// calls the Pallas TPU kernel jax.experimental.pallas.ops.tpu.flash_attention
// with SegmentIds(q=mask, kv=mask).
//
// Computes softmax(Q K^T / sqrt(d)) V where query t attends to key s iff
// seg[b, t] == seg[b, s] (the 0/1 attention mask used as segment ids): valid
// tokens see only valid tokens, pads see only pads, so an all-pad row stays
// finite. Layouts are the JAX package's public ones: q/k/v/out [B, T, H, D]
// contiguous and 16-byte aligned, seg [B, T] int32. Any T: keys past T are
// masked, queries past T write nothing. A row whose softmax sum stays 0
// writes 0 (no NaN).
//
// What bounds it on an H100: in bf16 the bytes of q, k, v and out (about
// 4*B*T*H*D elements) against 3.35 TB/s, the 4*B*H*D*pairs operations being
// far below the tensor-core roofline; in f32, which may not use TF32, the
// same operations on the CUDA cores (67 TFLOP/s). Only in-segment pairs
// count: a key tile whose segment range holds no query of the block is
// neither loaded nor multiplied.
//
// Both paths share the block's prologue and its load pipeline:
// * The tile plan. Each block scans its row's segment ids once: the
//   [min, max] segment range of every key tile, kept only if some live
//   query of the block has a segment in it. The kept tiles' indices go, in
//   order, to shared memory after the fixed buffers (one int a tile), so
//   the main loop walks only tiles it needs and knows the next one while
//   the current one computes.
// * K/V tiles and the tile's segment ids arrive by cp.async (16-byte .cg
//   copies, 4-byte .ca for the ids; K/V rows past T zero-filled, the ids of
//   keys past T set to a segment no query has), issued a tile ahead.
//
// * bf16 (the corpus encoder): tensor cores. A block is 4 warps and 64
//   queries, each warp owning 16 and holding their Q fragments and f32
//   output accumulators in registers; 64-key K/V tiles go through a 2-stage
//   ring, one barrier a tile (it publishes the tile that landed and frees
//   the other stage, into which the next tile's copies go before this one
//   computes). S = Q K^T and O += P V are `mma.sync` m16n8k16 bf16 with f32
//   accumulation; K fragments come through `ldmatrix`, V fragments through
//   `ldmatrix.trans`, from rows padded by 16 bytes (conflict-free). P enters
//   P V as three bf16 terms made by truncation (mask the low 16 bits,
//   subtract: exact), packed with one `prmt` each; the three hold all 24
//   bits of an f32 P, so the result is an f32-order rounding of the plain
//   f32 softmax before the final bf16 store. Past 8 tiles a row (T > 512)
//   the MMA accumulators are added into an IEEE f32 sum every 8 tiles
//   (kFlushTiles): accumulated in the tensor cores alone, T = 30000 missed
//   one bf16 ulp on the card. A warp skips a tile none of whose key
//   segments lies in its rows' segment range, and masks nothing where its
//   live rows and the tile's keys share one segment. (On the
//   card, 8-warp 128-query blocks were slower at every corpus rung, so was
//   a register cap of 128 above T = 64, where the kernel spills, and so
//   was skipping 16-key groups inside a tile.)
//   For bf16 training it also writes lse [B, H, T] f32 from the same
//   running max and sum that normalise out (the backward recomputes P
//   from it); out's arithmetic does not change with it, so the inference
//   path, which passes a null lse, keeps its bits.
// * f32 (the query encoder, training): two register-tiled products on the
//   CUDA cores, full f32, no TF32. A block of 128 threads owns 64 queries
//   and walks 32-key tiles: thread (ty, tx) holds 4 query rows (ty + 16i)
//   x 4 keys (8j + tx) of S and the same 4 rows x D/8 columns of O, so a
//   row's softmax statistics stay in the 8 lanes of one warp (shuffle
//   reductions) and the rescale is local. S reads Q and K k-contiguous as
//   copied (row pitch D+4 floats: the 8 key rows a phase reads hit
//   distinct banks, the Q rows are broadcasts). P goes to shared memory
//   (row pitch 40), read back only by its own warp; O += P V reads P as
//   broadcasts and V rows as contiguous 16-byte chunks. K and V
//   have one buffer each, staggered: V of this tile loads while S
//   computes, K of the next while P V computes (two barriers a tile, 44 KB,
//   three blocks an SM). Of the shapes timed on the card (64 or 32 keys,
//   32-128 queries, 4 or 8 rows a thread, a 2-stage ring) this one was the
//   fastest at both B=4 T=256 and B=40 T=512, so no shape depends on the
//   grid. For training it also writes each row's log-sum-exp of the scaled
//   scores, lse [B, H, T] f32, which the backward (flash_attention_bwd.cu)
//   uses to recompute P; inference passes a null lse (both dtypes).
//
// Both keep the online softmax in the log2 domain (scores scaled by
// log2(e)/sqrt(d) in the exponent's FFMA, ex2.approx) with f32 running max
// and sum per row.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaKeys = 64;  // keys per tile
// P enters P V as the sum of this many bf16 terms (8 more bits of P each).
// Two leave errors of about 2^-18 of the summed terms, more than one bf16
// ulp of an output near zero; three hold all 24 bits of P.
constexpr int kParts = 3;

constexpr int kMmaWarps = 4;  // 16 queries each
// The error of the tensor cores' f32 accumulation grows with the MMAs
// summed into one register (T = 30000 missed one bf16 ulp on the card).
// Past kFlushTiles tiles a row (T > 512) a warp adds its accumulators, in
// IEEE f32, into a copy in shared memory every kFlushTiles tiles and
// restarts them from 0.
constexpr int kFlushTiles = 8;

template <int D>
struct MmaTile {
  static constexpr int kStride = D + 8;  // bf16 a shared row: 16 bytes pad
  static constexpr int kStageBytes = 2 * kMmaKeys * kStride * 2 + kMmaKeys * 4;
  static constexpr int kFixedBytes = 2 * kStageBytes;
  static constexpr int kFlushBytes = D / 8 * 4 * 32 * kMmaWarps * 4;  // o a thread
  // the two stages, the plan (rounded to 16 bytes), the flush copy if used
  static int smem_bytes(int seq) {
    const int nt = (seq + kMmaKeys - 1) / kMmaKeys;
    return kFixedBytes + (4 * (nt + 1) + 15) / 16 * 16 + (nt > kFlushTiles ? kFlushBytes : 0);
  }
};

// The bf16 of x's top 16 bits (x truncated toward zero) in the low half
// and y's in the high half: the A-fragment order of (x, y).
__device__ __forceinline__ uint32_t pack_trunc(float x, float y) {
  return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}

// x less its bf16 truncation: exact in f32.
__device__ __forceinline__ float trunc_rest(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

template <int D, int kMinBlocks>
__global__ void __launch_bounds__(32 * kMmaWarps, kMinBlocks)
flash_fwd_mma_kernel(const void* __restrict__ q_, const void* __restrict__ k_,
                     const void* __restrict__ v_, const int* __restrict__ seg,
                     void* __restrict__ out_, float* __restrict__ lse,
                     int seq, int heads, float scale) {
  using Tile = MmaTile<D>;
  constexpr int kThreads = 32 * kMmaWarps;
  constexpr int kRows = 16 * kMmaWarps;
  constexpr int kStride = Tile::kStride;
  constexpr int kChunks = D / 16;  // k-steps of Q K^T
  constexpr int kDTiles = D / 8;   // 8-wide column tiles of O
  constexpr int kKeyTiles = kMmaKeys / 8;
  constexpr int kVecPerRow = D / 8;  // 16-byte chunks a K/V row
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(q_);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(k_);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(v_);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(out_);
  extern __shared__ __align__(16) unsigned char smem[];
  int* plan = reinterpret_cast<int*>(smem + Tile::kFixedBytes);
  const int nt = (seq + kMmaKeys - 1) / kMmaKeys;
  float* flushed_o = reinterpret_cast<float*>(
      smem + Tile::kFixedBytes + (4 * (nt + 1) + 15) / 16 * 16);  // [j*4+i][tid]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long tok = static_cast<long long>(heads) * D;
  const long long base = static_cast<long long>(b) * seq * tok +
                         static_cast<long long>(h) * D;
  const int* segb = seg + static_cast<long long>(b) * seq;
  const int q0 = blockIdx.x * kRows;

  int rows[2];
  rows[0] = q0 + warp * 16 + g;
  rows[1] = rows[0] + 8;
  bool live[2];
  int segq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    live[r] = rows[r] < seq;
    segq[r] = live[r] ? segb[rows[r]] : 0;
  }
  // Q as A fragments: a0 (row g, cols 2t..2t+1), a1 (row g+8), a2/a3 the
  // same rows at cols 8+2t.
  uint32_t qf[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i & 1;
      const int col = 16 * c + 8 * (i >> 1) + 2 * t;
      qf[c][i] = live[r] ? ld_u32(q + base + rows[r] * tok + col) : 0u;
    }
  }

  auto load_tile = [&](int tile, int stage) {
    unsigned char* st = smem + stage * Tile::kStageBytes;
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(st);
    __nv_bfloat16* vs = ks + kMmaKeys * kStride;
    int* sk = reinterpret_cast<int*>(vs + kMmaKeys * kStride);
    const int k0 = tile * kMmaKeys;
    constexpr int kTotal = kMmaKeys * kVecPerRow;
#pragma unroll
    for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
      const int c = tid + it * kThreads;
      if (kTotal % kThreads != 0 && c >= kTotal) break;
      const int r = c / kVecPerRow;
      const int col = (c % kVecPerRow) * 8;
      const bool ok = k0 + r < seq;
      const long long off = ok ? base + (k0 + r) * tok + col : 0;
      cp_async16(ks + r * kStride + col, k + off, ok);
      cp_async16(vs + r * kStride + col, v + off, ok);
    }
    if (tid < kMmaKeys) {
      if (k0 + tid < seq)
        cp_async4(sk + tid, segb + k0 + tid);
      else
        sk[tid] = kNoSegment;
    }
  };

  // the range of this warp's live row segments (empty: no live row)
  int wlo = INT_MAX;
  int whi = INT_MIN;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (live[r]) {
      wlo = min(wlo, segq[r]);
      whi = max(whi, segq[r]);
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, off));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, off));
  }

  const int n = plan_tiles<kRows, kMmaKeys, kThreads>(segb, seq, q0, plan);
  if (n > 0) load_tile(plan[0], 0);
  cp_async_commit();

  float o[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
  float l[2] = {0.f, 0.f};  // this thread's share of the running sum
  float since_flush[2] = {1.f, 1.f};  // product of the rescales since a flush
  int tiles = 0;                      // tiles accumulated since a flush
  bool flushed = false;
  const float scale_log2 = scale * kLog2e;
  const int mi = lane / 8;  // the ldmatrix matrix this lane addresses

  for (int idx = 0; idx < n; ++idx) {
    cp_async_wait_all();
    __syncthreads();  // tile idx landed; the other stage is free
    if (idx + 1 < n) load_tile(plan[idx + 1], (idx + 1) & 1);
    cp_async_commit();

    const unsigned char* st = smem + (idx & 1) * Tile::kStageBytes;
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* vs = ks + kMmaKeys * kStride;
    const int* sk = reinterpret_cast<const int*>(vs + kMmaKeys * kStride);

    // A warp none of whose rows' segment range holds a key's segment
    // skips the tile; one whose live rows and keys all share one segment
    // needs no mask.
    const int sa = sk[lane];
    const int sb = sk[lane + 32];
    if (!__any_sync(0xffffffffu, (sa >= wlo && sa <= whi) || (sb >= wlo && sb <= whi)))
      continue;
    const bool unmasked = wlo == whi && __all_sync(0xffffffffu, sa == wlo && sb == wlo);

    // S = Q K^T: tile j holds keys 8j..8j+7; s[j][0..1] are row g at keys
    // 8j+2t, 8j+2t+1 and s[j][2..3] the same keys for row g+8. One x4
    // ldmatrix gives the B fragments of key tiles 2jp and 2jp+1.
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int jp = 0; jp < kKeyTiles / 2; ++jp) {
      const __nv_bfloat16* kp =
          ks + (16 * jp + 8 * (mi >> 1) + lane % 8) * kStride + 8 * (mi & 1);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kp + 16 * c);
        mma_bf16(s[2 * jp], qf[c], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[c], kf[2], kf[3]);
      }
    }

    float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (unmasked) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) tile_max[i >> 1] = fmaxf(tile_max[i >> 1], s[j][i]);
    } else {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const int2 sg = *reinterpret_cast<const int2*>(sk + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const bool allowed = ((i & 1) ? sg.y : sg.x) == segq[r];
          s[j][i] = allowed ? s[j][i] : -CUDART_INF_F;  // raw: scale > 0
          tile_max[r] = fmaxf(tile_max[r], s[j][i]);
        }
      }
    }
    float base_max[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a quad hold one row between them
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m[r], tile_max[r] * scale_log2);
      // no allowed key yet: keep everything at 0 instead of exp(-inf + inf)
      base_max[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = fast_exp2(m[r] - base_max[r]);
      l[r] *= alpha;
      since_flush[r] *= alpha;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
      m[r] = m_new;
    }

    // O += P V, 16 keys per step: P's A fragment is the S fragments of key
    // tiles 2kc and 2kc+1, split into kParts truncated bf16 terms.
#pragma unroll
    for (int kc = 0; kc < kKeyTiles / 2; ++kc) {
      uint32_t pf[kParts][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kc + (i >> 1);
        const int r = i & 1;
        float p0 = fast_exp2(fmaf(s[j][2 * r], scale_log2, -base_max[r]));
        float p1 = fast_exp2(fmaf(s[j][2 * r + 1], scale_log2, -base_max[r]));
        l[r] += p0 + p1;
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          pf[part][i] = pack_trunc(p0, p1);
          if (part + 1 < kParts) {
            p0 = trunc_rest(p0);
            p1 = trunc_rest(p1);
          }
        }
      }
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        // matrix i of the x4 load: keys 16kc + 8*(i&1) .., columns
        // 16dp + 8*(i>>1) ..; registers 0/1 feed column tile 2dp, 2/3 2dp+1
        const __nv_bfloat16* vp =
            vs + (16 * kc + 8 * (mi & 1) + lane % 8) * kStride + 16 * dp + 8 * (mi >> 1);
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vp);
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          mma_bf16(o[2 * dp], pf[part], vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pf[part], vf[2], vf[3]);
        }
      }
    }
    if (++tiles == kFlushTiles && idx + 1 < n) {  // warp-uniform
#pragma unroll
      for (int j = 0; j < kDTiles; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* f = flushed_o + (j * 4 + i) * kThreads + tid;
          *f = flushed ? fmaf(*f, since_flush[i >> 1], o[j][i]) : o[j][i];
          o[j][i] = 0.f;
        }
      since_flush[0] = since_flush[1] = 1.f;
      tiles = 0;
      flushed = true;
    }
  }
  cp_async_wait_all();
  if (flushed) {
#pragma unroll
    for (int j = 0; j < kDTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[j][i] = fmaf(flushed_o[(j * 4 + i) * kThreads + tid], since_flush[i >> 1], o[j][i]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (!live[r]) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* op = out + base + rows[r] * tok + 2 * t;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      *reinterpret_cast<uint32_t*>(op + 8 * j) =
          pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
    // the running max and sum that made this row's out (a live row sees
    // its own key, so l > 0 and lse is finite); the flush rescales only o
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * heads + h) * seq + rows[r]] = m[r] * kLn2 + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// f32: register-tiled FMA on the CUDA cores
// ---------------------------------------------------------------------------
// A block: BQ queries, BK keys a tile, RM query rows a thread; shared
// memory holds Q, one K tile (+ its key ids), one V tile and P.
constexpr int kFmaBQ = 64;
constexpr int kFmaBK = 32;
constexpr int kFmaRM = 4;

template <int D>
struct FmaTile {
  static constexpr int kThreads = kFmaBQ / kFmaRM * 8;  // row groups x 8 lanes
  static constexpr int kRG = kFmaBQ / kFmaRM;  // row groups: rows ty + i*kRG
  static constexpr int kKJ = kFmaBK / 8;       // keys a thread: j*8 + tx
  static constexpr int kQPitch = D + 4;        // floats a Q or K row
  static constexpr int kPPitch = kFmaBK + 8;   // floats a P row
  static constexpr int kVec = D >= 32 ? 4 : 2;  // O columns a chunk
  static constexpr int kOC = D / 8;             // O columns a thread
  static constexpr int kQFloats = kFmaBQ * kQPitch;
  static constexpr int kKFloats = kFmaBK * kQPitch + kFmaBK;  // + key ids
  static constexpr int kVFloats = kFmaBK * D;
  static constexpr int kFixedBytes =
      4 * (kQFloats + kKFloats + kVFloats + kFmaBQ * kPPitch);
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

// Copies rows [r0, r0 + kRows) of one head of a [B, T, H, D] f32 operand
// (rows past T zero-filled) into shared memory at row pitch kPitch.
template <int D, int kRows, int kPitch, int kThreads>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long base, long long tok,
                                          int r0, int seq, int tid) {
  constexpr int kRowChunks = D / 4;  // 16-byte chunks a row
  static_assert(kRows * kRowChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < kRows * kRowChunks / kThreads; ++it) {
    const int c = tid + it * kThreads;
    const int r = c / kRowChunks;
    const int col = (c % kRowChunks) * 4;
    const bool ok = r0 + r < seq;
    cp_async16(dst + r * kPitch + col, src + (ok ? base + (r0 + r) * tok + col : 0), ok);
  }
}

template <int D>
__global__ void __launch_bounds__(FmaTile<D>::kThreads)
flash_fwd_fma_kernel(const void* __restrict__ q_, const void* __restrict__ k_,
                     const void* __restrict__ v_, const int* __restrict__ seg,
                     void* __restrict__ out_, float* __restrict__ lse,
                     int seq, int heads, float scale) {
  using Tile = FmaTile<D>;
  constexpr int BQ = kFmaBQ;
  constexpr int BK = kFmaBK;
  constexpr int RM = kFmaRM;
  constexpr int kThreads = Tile::kThreads;
  constexpr int kRG = Tile::kRG;
  constexpr int kKJ = Tile::kKJ;
  constexpr int kQPitch = Tile::kQPitch;
  constexpr int kPPitch = Tile::kPPitch;
  constexpr int kVec = Tile::kVec;
  constexpr int kOC = Tile::kOC;
  constexpr int kChunks = kOC / kVec;
  const float* q = static_cast<const float*>(q_);
  const float* k = static_cast<const float*>(k_);
  const float* v = static_cast<const float*>(v_);
  float* out = static_cast<float*>(out_);
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + Tile::kQFloats;    // K rows (pitch kQPitch), then key ids
  int* sk = reinterpret_cast<int*>(ks + BK * kQPitch);
  float* vs = ks + Tile::kKFloats;
  float* ps = vs + Tile::kVFloats;
  int* plan = reinterpret_cast<int*>(smem + Tile::kFixedBytes);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tx = lane % 8;
  const int ty = (tid / 32) * 4 + lane / 8;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long tok = static_cast<long long>(heads) * D;
  const long long base = static_cast<long long>(b) * seq * tok +
                         static_cast<long long>(h) * D;
  const int* segb = seg + static_cast<long long>(b) * seq;
  const int q0 = blockIdx.x * BQ;

  // Q once, in its own copy group, in flight while the plan is made
  copy_rows<D, BQ, kQPitch, kThreads>(qs, q, base, tok, q0, seq, tid);
  cp_async_commit();

  auto load_k = [&](int tile) {
    copy_rows<D, BK, kQPitch, kThreads>(ks, k, base, tok, tile * BK, seq, tid);
    for (int c = tid; c < BK; c += kThreads) {
      if (tile * BK + c < seq)
        cp_async4(sk + c, segb + tile * BK + c);
      else
        sk[c] = kNoSegment;
    }
  };
  auto load_v = [&](int tile) {
    copy_rows<D, BK, D, kThreads>(vs, v, base, tok, tile * BK, seq, tid);
  };

  int segq[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + i * kRG;
    segq[i] = row < seq ? segb[row] : 0;  // a row past T writes nothing
  }

  const int n = plan_tiles<BQ, BK, kThreads>(segb, seq, q0, plan);
  if (n > 0) load_k(plan[0]);
  cp_async_commit();

  float o[RM][kOC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < kOC; ++c) o[i][c] = 0.f;
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -CUDART_INF_F;  // running max, log2 domain
    l[i] = 0.f;            // this thread's share of the running sum
  }
  const float scale_log2 = scale * kLog2e;
  const float* q_row = qs + ty * kQPitch;   // row i at + i * kRG * kQPitch
  float* p_row = ps + ty * kPPitch;         // row i at + i * kRG * kPPitch

  // K and V have one buffer each, staggered: V of tile idx loads while S
  // computes, K of tile idx + 1 while P V computes
  for (int idx = 0; idx < n; ++idx) {
    cp_async_wait_all();
    __syncthreads();  // K of tile idx (and Q) landed; V's buffer is free
    load_v(plan[idx]);
    cp_async_commit();

    // S = Q K^T over d, 4 at a time: RM Q rows and kKJ K rows a step
    float s[RM][kKJ];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < kKJ; ++j) s[i][j] = 0.f;
    const float* k_row = ks + tx * kQPitch;  // key j at + j * 8 * kQPitch
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 a[RM];
      float4 bk[kKJ];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(q_row + i * kRG * kQPitch + d);
#pragma unroll
      for (int j = 0; j < kKJ; ++j)
        bk[j] = *reinterpret_cast<const float4*>(k_row + j * 8 * kQPitch + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < kKJ; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // mask, online softmax; P to shared memory (rows of this warp only)
    int segk[kKJ];
#pragma unroll
    for (int j = 0; j < kKJ; ++j) segk[j] = sk[j * 8 + tx];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        s[i][j] = segk[j] == segq[i] ? s[i][j] : -CUDART_INF_F;  // raw: scale > 0
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      // the 8 lanes of a row group hold the row between them
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 4));
      const float m_new = fmaxf(m[i], tile_max * scale_log2);
      // no allowed key yet: keep everything at 0 instead of exp(-inf + inf)
      const float base_max = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = fast_exp2(m[i] - base_max);
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kOC; ++c) o[i][c] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        const float p = fast_exp2(fmaf(s[i][j], scale_log2, -base_max));  // 0 if masked
        l[i] += p;
        p_row[i * kRG * kPPitch + j * 8 + tx] = p;
      }
    }
    cp_async_wait_all();
    __syncthreads();  // V landed; every warp is done with K (and wrote its P)
    if (idx + 1 < n) load_k(plan[idx + 1]);
    cp_async_commit();

    // O += P V over the tile's keys, 4 at a time
    const float* v_col = vs + tx * kVec;  // chunk ch at + ch * 8 * kVec
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        p4[i] = *reinterpret_cast<const float4*>(p_row + i * kRG * kPPitch + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[kOC];
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch)
          load_vec<kVec>(vv + ch * kVec, v_col + (kk + e) * D + ch * 8 * kVec);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = e == 0 ? p4[i].x : e == 1 ? p4[i].y : e == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < kOC; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    const int row = q0 + ty + i * kRG;
    if (row >= seq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* op = out + base + row * tok + tx * kVec;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      float* dst = op + ch * 8 * kVec;
      if constexpr (kVec == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(o[i][4 * ch] * inv, o[i][4 * ch + 1] * inv,
                        o[i][4 * ch + 2] * inv, o[i][4 * ch + 3] * inv);
      } else {
        *reinterpret_cast<float2*>(dst) =
            make_float2(o[i][2 * ch] * inv, o[i][2 * ch + 1] * inv);
      }
    }
    // a live row always sees its own key, so l > 0 and lse is finite
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * heads + h) * seq + row] =
          m[i] * kLn2 + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
using KernelFn = void (*)(const void*, const void*, const void*, const int*,
                          void*, float*, int, int, float);

struct Config {
  KernelFn fn;
  int threads, smem, rows, keys;  // block threads, dynamic bytes, BQ, BK
};

template <int D, int kMinBlocks>
Config mma_config(int seq) {
  return Config{flash_fwd_mma_kernel<D, kMinBlocks>, 32 * kMmaWarps,
                MmaTile<D>::smem_bytes(seq), 16 * kMmaWarps, kMmaKeys};
}

template <int D>
Config fma_config(int seq) {
  return Config{flash_fwd_fma_kernel<D>, FmaTile<D>::kThreads,
                FmaTile<D>::kFixedBytes + plan_bytes(seq, kFmaBK), kFmaBQ, kFmaBK};
}

// The kernel for a problem. bf16: registers capped for 4 blocks an SM at
// T <= 64 (one key tile: the faster there) and 3 above (the cap of 4 makes
// the kernel spill, slower at T >= 128 on the card).
template <int D>
Config choose(int seq, int dtype) {
  if (dtype == 1) return seq <= 64 ? mma_config<D, 4>(seq) : mma_config<D, 3>(seq);
  return fma_config<D>(seq);
}

Config config_for(int seq, int head_dim, int dtype) {
  switch (head_dim) {
    case 16: return choose<16>(seq, dtype);
    case 32: return choose<32>(seq, dtype);
    case 64: return choose<64>(seq, dtype);
    default: return Config{nullptr, 0, 0, 0, 0};
  }
}

// Launches above 48 KB of dynamic shared memory (the plan grows with T,
// and bf16 adds its flush copy past T = 512) need the limit raised first.
cudaError_t allow_smem(const Config& cfg) {
  if (cfg.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(cfg.fn),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
}

bool valid_args(int batch, int seq, int heads, int head_dim, int dtype) {
  return batch > 0 && seq > 0 && heads > 0 && batch <= 65535 && heads <= 65535 &&
         (dtype == 0 || dtype == 1) &&
         (head_dim == 16 || head_dim == 32 || head_dim == 64);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 16, 32 or 64. lse: null, or
// [B, H, T] f32 for the backward. Returns a cudaError_t (0 = launched).
extern "C" int convdr_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* seg,
                                          void* out, void* lse, int batch,
                                          int seq, int heads, int head_dim,
                                          float scale, int dtype,
                                          void* stream) {
  if (!valid_args(batch, seq, heads, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config_for(seq, head_dim, dtype);
  cudaError_t err = allow_smem(cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + cfg.rows - 1) / cfg.rows, heads, batch);
  cfg.fn<<<grid, cfg.threads, cfg.smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, static_cast<const int*>(seg), out, static_cast<float*>(lse), seq,
      heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration chosen for a problem: out[0] threads a block,
// out[1] dynamic shared memory bytes, out[2] query rows a block, out[3]
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// after the shared-memory attribute is set), out[4] keys a tile. Returns a
// cudaError_t.
extern "C" int convdr_flash_attention_fwd_config(int batch, int seq,
                                                 int heads, int head_dim,
                                                 int dtype, int* out) {
  if (!valid_args(batch, seq, heads, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config_for(seq, head_dim, dtype);
  cudaError_t err = allow_smem(cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reinterpret_cast<const void*>(cfg.fn), cfg.threads, cfg.smem);
  out[0] = cfg.threads;
  out[1] = cfg.smem;
  out[2] = cfg.rows;
  out[3] = blocks;
  out[4] = cfg.keys;
  return static_cast<int>(err);
}
