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
// 4*B*T*H*D elements) against 3.35 TB/s, the function's 4*B*H*D*pairs
// operations being below the tensor-core roofline (the kernel's own
// products are twice those, see below); in f32, which may not use TF32,
// the same operations on the CUDA cores (67 TFLOP/s). Only in-segment pairs
// count: a key tile whose segment range holds no query of the block is
// neither loaded nor multiplied.
//
// Every kernel here shares the block's prologue, the tile plan. Each block
// scans its row's segment ids once: the [min, max] segment range of every
// key tile, kept only if some live query of the block has a segment in
// it. The kept tiles' indices go, in order, to shared memory after the
// fixed buffers (one int a tile), so the main loop walks only tiles it
// needs. In the f32 64-row tile, K/V tiles and the tile's segment ids
// arrive by cp.async (16-byte .cg copies, 4-byte .ca for the ids; K/V rows
// past T zero-filled, the ids of keys past T set to a segment no query
// has), issued a tile ahead; the bf16 kernel and the f32 small grid take
// K/V by TMA.
//
// * bf16 (the corpus encoder): wgmma, for Hopper. A block is one
//   warpgroup that owns 64 queries. Its thread 0 issues Q once by TMA (a
//   4-D map over [B, T, H, D], a box of 64 rows, swizzled by the row's
//   width: 32, 64 or 128 bytes for D = 16, 32, 64; rows past T arrive as
//   zeros), and warp 0 each planned tile's 64-key K and V boxes into a
//   2-stage ring under full / empty mbarriers, its lanes copying the
//   tile's key ids by cp.async onto the same full barrier (keys past T are
//   masked by position); a stage is refilled, with the tile two ahead, as
//   soon as every warp is done with it. S = Q K^T is wgmma m64n64k16 with
//   both operands in shared memory, K-major (D/16 k-steps). Masking and
//   the online softmax work on the accumulator fragments in place, whose
//   layout keeps a row in the 4 lanes of a quad: the xor-1/2 row
//   reductions, fast_exp2, the base_max and all -inf rules are mma.sync's.
//   P enters O += P V as three bf16 terms made by truncation (mask the low
//   16 bits, subtract: exact), packed with one `prmt` each: the A operand
//   from registers (the packed S fragments are the A fragments), V from
//   shared memory as an MN-major B, the three parts of each 16-key k-step
//   in turn (12 products a tile; in this order the card gave the mma.sync
//   kernel's outputs, and a full bf16 train step its loss). The three hold
//   all 24 bits of an f32 P, so out is an f32-order rounding of the plain
//   f32 softmax before the final bf16 store (one bf16 ulp of the plain
//   version; rounding P to one bf16, as the Pallas kernel does, misses
//   that at about a fifth of the outputs). So the tensor cores do 8*H*D
//   operations a pair, twice the function's, and that is this design's
//   floor beside the bytes bound: at the corpus rungs the kernel is bound
//   by the tensor cores' rate on these m64n64 products, not by bytes.
//   Each tile runs S, softmax, P V in turn, with no other wgmma in flight
//   (no instruction but wgmma writes an accumulator while one is); what
//   hides the latencies is occupancy: the loop fits 128 registers, so
//   four blocks share an SM (which a producer warp of their own would cut
//   to three) and one block's softmax runs while another's products do.
//   A block skips a tile none of whose keys lies in its rows' segment
//   range, masks nothing where its live rows and the tile's keys share
//   one segment, and skips O's rescale in a warp whose rows kept their
//   max. Past 8 tiles a row (T > 512) the accumulators are added into an
//   IEEE f32 sum in shared memory every 8 tiles (kFlushTiles): accumulated
//   in the tensor cores alone, T = 30000 missed one bf16 ulp on the card.
//   out leaves through the Q tile by a TMA store; for bf16 training lse
//   [B, H, T] f32 comes from the same running max and sum that normalise
//   out (the backward recomputes P from it), and out's arithmetic does not
//   change with it, so the inference path, which passes a null lse, keeps
//   its bits. (On the card, scripts/attention_sweep.py and PERF.md: B=64
//   T=512 0.212 ms against the mma.sync kernel's 0.282. Slower, in scratch
//   variants not kept: a producer warp with three blocks an SM, 0.219; two
//   blocks an SM of one or two warpgroups, whose 168-register cap made
//   the loop spill, 0.37-0.41; issuing the next tile's S before this
//   tile's P V, the same; a persistent grid, 0.232, though faster at T <=
//   128; 3- and 4-stage rings, the same as 2.)
// * f32 (the query encoder, training): two register-tiled products on the
//   CUDA cores, full f32, no TF32, on one of two paths chosen by the grid.
//   For training it also writes each row's log-sum-exp of the scaled
//   scores, lse [B, H, T] f32, which the backward (flash_attention_bwd.cu)
//   uses to recompute P; inference passes a null lse (both dtypes).
//   What fixes a row's bits, on both paths: the 32-key tile; the 8 lanes
//   of one warp that hold the row, lane tx the keys 8j + tx; the order of
//   each lane's fmaf chains (S over d = 0..D-1, O over the tile's keys in
//   order, O's columns tx*kVec + 8*kVec*ch); the xor-1/2/4 shuffle sums;
//   fast_exp2 and the base_max rule; and the rounding that both kernels
//   write out with intrinsics rather than leave to the compiler's
//   contraction: l * alpha + p as one fmaf at a tile's first key, then
//   adds, and lse as __fmul_rn(m, ln2) and logf(l) rounded apart. Not the
//   rows a thread or a block holds: a tile that a block plans, or a warp
//   would walk, none of whose keys is in a row's segment leaves that row's
//   m, l and o as they were (alpha = ex2(0) = 1, p = ex2(-inf) = 0,
//   o + 0 * v = o, the sign of an exact zero aside), and a smaller block's
//   plan is a subset of the 64-row block's. So the two paths give the same out and lse bit for
//   bit, and the card tests hold them to that (torch.equal).
//   - The 64-row tile (grids of more than kSmallGridBlocks blocks). A
//     block of 128 threads owns 64 queries and walks 32-key tiles: thread
//     (ty, tx) holds 4 query rows (ty + 16i) x 4 keys (8j + tx) of S and
//     the same 4 rows x D/8 columns of O, so a row's softmax statistics
//     stay in the 8 lanes of one warp (shuffle reductions) and the
//     rescale is local. S reads Q and K k-contiguous as copied (row pitch
//     D+4 floats: the 8 key rows a phase reads hit distinct banks, the Q
//     rows are broadcasts). P goes to shared memory (row pitch 40), read
//     back only by its own warp; O += P V reads P as broadcasts and V rows
//     as contiguous 16-byte chunks. K and V have one buffer each,
//     staggered: V of this tile loads while S computes, K of the next
//     while P V computes (two barriers a tile, 44 KB, three blocks an SM).
//     Of the shapes timed on the card (64 or 32 keys, 32-128 queries, 4 or
//     8 rows a thread, a 2-stage ring) this one was the fastest at both
//     B=4 T=256 and B=40 T=512.
//   - The small grid (the serving encode's B=1 T=256: 48 tile blocks for
//     132 SMs; the teacher's targets, B=4 T=64). What is scarce there is
//     blocks in flight and copy latency. Blocks of 32 rows, 2 rows a
//     thread: 4 consumer warps and one producer warp. The producer's lane
//     0 issues each planned tile's K and V by TMA (a 4-D map over [B, T,
//     H, D]; two 32-float boxes a row under the 128-byte swizzle, so the 8
//     key rows a phase reads still hit distinct banks) into a 3-stage ring
//     under full / empty mbarriers, and its lanes copy the tile's key ids
//     beside them; each consumer warp releases a stage on its own, so the
//     loop has no block barrier, and a warp skips a tile none of whose
//     keys is in its rows' segment range. Q stays in registers. What
//     bounds it is shared-memory reads: the 4 row groups of a warp read the
//     same K and V, so an LDS.128 gives 128 useful bytes in 4 wavefronts,
//     and 2 rows a thread halve them per row. (On the card, PERF.md: 16-row
//     blocks, which fill all 132 SMs at the serving encode, ran 10% slower
//     there than 32-row ones; a cp.async ring of the same depth lost to
//     TMA at both the serving encode's and the teacher's shapes; 8-row
//     blocks and 1 row a thread were slower.)
//
// All keep the online softmax in the log2 domain (scores scaled by
// log2(e)/sqrt(d) in the exponent's FFMA, ex2.approx) with f32 running max
// and sum per row.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: wgmma over a TMA ring
// ---------------------------------------------------------------------------
constexpr int kWgKeys = 64;      // keys a tile: the N of S
constexpr int kWgRows = 64;      // query rows a block: one wgmma M
constexpr int kWgStages = 2;     // K/V ring depth
constexpr int kWgMinBlocks = 4;  // blocks an SM: registers capped at 128 a thread
// P enters P V as the sum of this many bf16 terms (8 more bits of P each).
// Two leave errors of about 2^-18 of the summed terms, more than one bf16
// ulp of an output near zero; three hold all 24 bits of P.
constexpr int kParts = 3;
// The error of the tensor cores' f32 accumulation grows with the products
// summed into one register (T = 30000 missed one bf16 ulp on the card with
// mma.sync). Past kFlushTiles tiles a row (T > 512) a thread adds its
// accumulators, in IEEE f32, into a copy in shared memory every kFlushTiles
// tiles and restarts them from 0.
constexpr int kFlushTiles = 8;

// Shared memory of a block (from a 1024-byte aligned base): the Q tile
// (then the out tile), the ring's stages of a K and a V tile (all [64][D]
// bf16, swizzled by TMA with the row's width), each stage's key ids, the
// barriers, the tile plan, and past kFlushTiles tiles the flush copy of
// every thread's O.
template <int D>
struct WgFwdTile {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kTileBytes = kWgKeys * kRowBytes;
  static constexpr int kThreads = 128;  // one warpgroup: 64 query rows
  static constexpr int kRingOff = kTileBytes;
  static constexpr int kIdsOff = kRingOff + kWgStages * 2 * kTileBytes;
  static constexpr int kBarOff = kIdsOff + kWgStages * kWgKeys * 4;
  static constexpr int kPlanOff = kBarOff + (2 * kWgStages + 1) * 8;
  static constexpr int kAcc = D / 2;  // O's f32 registers a thread
  static_assert(kTileBytes % 1024 == 0, "tiles on 1024-byte bases");
  __host__ __device__ static int flush_off(int seq) {
    return kPlanOff + (plan_bytes(seq, kWgKeys) + 15) / 16 * 16;
  }
  // + 1024 bytes to align the base
  static int smem_bytes(int seq) {
    const int nt = (seq + kWgKeys - 1) / kWgKeys;
    return 1024 + flush_off(seq) + (nt > kFlushTiles ? 4 * kAcc * kThreads : 0);
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

// S = Q K^T of 64 queries and a 64-key tile: D / 16 k-steps of 16 columns,
// 32 bytes along the swizzled rows of both operands; one commit group.
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[32], uint64_t q_desc, uint64_t k_desc) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, q_desc + 2 * kk, k_desc + 2 * kk, kk);
  wgmma_commit();
}

// O += P V: 4 k-steps of 16 keys, each P's kParts parts in turn (from
// registers; the mma.sync kernel's order, whose bits it kept on the card),
// V an MN-major B (16 rows down a k-step); one commit group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kParts][4][4],
                                         uint64_t v_desc) {
  constexpr uint32_t kStep = 16 * 2 * D >> 4;  // 16 rows down, in descriptor units
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int part = 0; part < kParts; ++part) wgmma_rs<D>(o, pa[part][kk], v_desc + kk * kStep, 1);
  wgmma_commit();
}

// One warpgroup owns 64 query rows; its warp 0 issues the copies. See
// the header for the design.
template <int D>
__global__ void __launch_bounds__(WgFwdTile<D>::kThreads, kWgMinBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap out_map, const int* __restrict__ seg,
                       float* __restrict__ lse, int seq, int heads, float scale) {
  using Tl = WgFwdTile<D>;
  constexpr int kAcc = Tl::kAcc;
  extern __shared__ __align__(16) unsigned char wf_smem[];
  unsigned char* smem = wf_smem + ((1024u - (shared_addr(wf_smem) & 1023u)) & 1023u);
  int* ids = reinterpret_cast<int*>(smem + Tl::kIdsOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tl::kBarOff);
  uint64_t* empty = full + kWgStages;
  uint64_t* q_full = empty + kWgStages;
  int* plan = reinterpret_cast<int*>(smem + Tl::kPlanOff);
  float* flushed_o = reinterpret_cast<float*>(smem + Tl::flush_off(seq));  // [i][tid]

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int* segb = seg + static_cast<long long>(b) * seq;
  const int q0 = blockIdx.x * kWgRows;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + s, 1 + 32);  // the TMA's bytes, then each lane's key ids
      mbar_init(empty + s, 4);      // each warp
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
    // the Q tile (rows past T arrive as zeros), while the block plans
    mbar_arrive_expect_tx(q_full, Tl::kTileBytes);
    tma_load_4d(smem, &q_map, q_full, 0, h, q0, b);
  }
  // every thread (its barriers also publish the mbarriers' initialisation)
  const int n = plan_tiles<kWgRows, kWgKeys, Tl::kThreads>(segb, seq, q0, plan);

  const int warp = tid / 32;
  const int lane = tid % 32;
  // Planned tile idx into its stage, by warp 0: lane 0 issues the K and V
  // boxes by TMA, each lane copies two key ids by cp.async, which arrives
  // when they have landed (keys past T are masked by position).
  auto load_tile = [&](int idx) {
    const int st = idx % kWgStages;
    const int k0 = plan[idx] * kWgKeys;
    if (lane == 0) {
      unsigned char* kv = smem + Tl::kRingOff + st * 2 * Tl::kTileBytes;
      mbar_arrive_expect_tx(full + st, 2 * Tl::kTileBytes);
      tma_load_4d(kv, &k_map, full + st, 0, h, k0, b);
      tma_load_4d(kv + Tl::kTileBytes, &v_map, full + st, 0, h, k0, b);
    }
    int* sk = ids + st * kWgKeys;
    if (k0 + lane < seq) cp_async4(sk + lane, segb + k0 + lane);
    if (k0 + lane + 32 < seq) cp_async4(sk + lane + 32, segb + k0 + lane + 32);
    mbar_arrive_cp_async(full + st);
  };
  if (warp == 0)
    for (int idx = 0; idx < min(n, kWgStages); ++idx) load_tile(idx);

  // warp w owns rows 16w + g and 16w + g + 8
  const int g = lane / 4;
  const int t = lane % 4;
  int rows[2];
  bool live[2];
  int segq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = q0 + 16 * warp + g + 8 * r;
    live[r] = rows[r] < seq;  // a row past T writes nothing
    segq[r] = live[r] ? segb[rows[r]] : 0;
  }
  // the range of the block's live row segments, which each warp reads
  // whole, so that every decision made from it is the same in the four
  int wlo = INT_MAX;
  int whi = INT_MIN;
#pragma unroll
  for (int c = lane; c < kWgRows; c += 32)
    if (q0 + c < seq) {
      wlo = min(wlo, segb[q0 + c]);
      whi = max(whi, segb[q0 + c]);
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, off));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, off));
  }

  const uint32_t base = shared_addr(smem);
  const uint64_t q_desc = wgmma_desc(base, Tl::kRowBytes);
  float o[kAcc];  // O, the accumulator fragments of [64][D]
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
  float l[2] = {0.f, 0.f};  // this thread's share of the running sum
  float since_flush[2] = {1.f, 1.f};  // product of the rescales since a flush
  int tiles = 0;                      // P V products in o since a flush
  bool flushed = false;
  const float scale_log2 = scale * kLog2e;
  mbar_wait(q_full, 0);

  // One tile at a time: S, the softmax in S's registers, P split, P V; the
  // stage is released when P V has landed. The other blocks of the SM keep
  // its tensor cores busy meanwhile.
  for (int idx = 0; idx < n; ++idx) {
    const int st = idx % kWgStages;
    mbar_wait(full + st, (idx / kWgStages) & 1);
    // A tile none of whose keys lies in the rows' segment range changes
    // none of them; one whose live rows and keys all share one segment
    // needs no mask.
    const int lim = seq - plan[idx] * kWgKeys;  // keys at or past lim are past T
    const int* sk = ids + st * kWgKeys;
    const int sa = lane < lim ? sk[lane] : kNoSegment;
    const int sb = lane + 32 < lim ? sk[lane + 32] : kNoSegment;
    // Each warp is done with the stage: then warp 0 refills it with the
    // tile kWgStages ahead.
    auto refill = [&]() {
      if (lane == 0) mbar_arrive(empty + st);
      if (warp == 0 && idx + kWgStages < n) {
        mbar_wait(empty + st, (idx / kWgStages) & 1);
        load_tile(idx + kWgStages);
      }
    };
    if (!__any_sync(0xffffffffu, (sa >= wlo && sa <= whi) || (sb >= wlo && sb <= whi))) {
      refill();
      continue;
    }
    const bool unmasked = wlo == whi && __all_sync(0xffffffffu, sa == wlo && sb == wlo);
    const uint32_t kv = base + Tl::kRingOff + st * 2 * Tl::kTileBytes;

    float s[32];  // S = Q K^T, then P in place
    issue_s<D>(s, q_desc, wgmma_desc(kv, Tl::kRowBytes));
    wgmma_wait<0>();
    wgmma_fence_regs(s);

    float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (unmasked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], s[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = 8 * j + 2 * t;
        int2 sg = *reinterpret_cast<const int2*>(sk + key);
        if (key >= lim) sg.x = kNoSegment;
        if (key + 1 >= lim) sg.y = kNoSegment;
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i) {
          const int r = (i >> 1) & 1;
          const bool allowed = ((i & 1) ? sg.y : sg.x) == segq[r];
          s[i] = allowed ? s[i] : -CUDART_INF_F;  // raw: scale > 0
          tile_max[r] = fmaxf(tile_max[r], s[i]);
        }
      }
    }
    float base_max[2];
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a quad hold one row between them
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m[r], tile_max[r] * scale_log2);
      // no allowed key yet: keep everything at 0 instead of exp(-inf + inf)
      base_max[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = fast_exp2(m[r] - base_max[r]);
      l[r] *= alpha[r];
      m[r] = m_new;
    }
    if (tiles == kFlushTiles) {  // warpgroup-uniform; this tile follows
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        float* f = flushed_o + i * Tl::kThreads + tid;
        *f = flushed ? fmaf(*f, since_flush[(i >> 1) & 1], o[i]) : o[i];
        o[i] = 0.f;
      }
      since_flush[0] = since_flush[1] = 1.f;
      tiles = 0;
      flushed = true;
    }
    // (a rescale by 1 changes nothing: a warp whose rows kept their max skips it)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) o[i] *= alpha[(i >> 1) & 1];
      since_flush[0] *= alpha[0];
      since_flush[1] *= alpha[1];
    }

    // P, and its A fragments: k-step kk is columns 16kk..16kk+15, register
    // q the pair s[8kk + 2q], s[8kk + 2q + 1], split into kParts truncated
    // terms
    uint32_t pa[kParts][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kk + 2 * q;
        const int r = q & 1;
        float x = fast_exp2(fmaf(s[i], scale_log2, -base_max[r]));  // 0 if masked
        float y = fast_exp2(fmaf(s[i + 1], scale_log2, -base_max[r]));
        l[r] += x + y;
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          pa[part][kk][q] = pack_trunc(x, y);
          if (part + 1 < kParts) {
            x = trunc_rest(x);
            y = trunc_rest(y);
          }
        }
      }
    issue_pv<D>(o, pa, wgmma_desc(kv + Tl::kTileBytes, Tl::kRowBytes));
    wgmma_wait<0>();
    wgmma_fence_regs(o);
    refill();
    ++tiles;
  }
  if (flushed) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      o[i] = fmaf(flushed_o[i * Tl::kThreads + tid], since_flush[(i >> 1) & 1], o[i]);
  }

  // out in bf16, laid out in the Q tile (every S has landed) as TMA's
  // swizzle wants it, and stored by TMA: rows past T are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(smem + swizzled_chunk_offset(row, j, Tl::kRowBytes) + 4 * t) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    // the running max and sum that made this row's out (a live row sees
    // its own key, so l > 0 and lse is finite), m * ln2 and logf(l)
    // rounded apart; the flush rescales only o
    if (lse != nullptr && t == 0 && live[r])
      lse[(static_cast<long long>(b) * heads + h) * seq + rows[r]] =
          __fadd_rn(__fmul_rn(m[r], kLn2), logf(l[r]));
  }
  fence_shared_to_async();
  named_barrier(1, Tl::kThreads);
  if (tid == 0) {
    tma_store_4d(&out_map, smem, 0, h, q0, b);
    tma_store_commit();
    tma_store_wait_read();
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
#pragma unroll
      for (int c = 0; c < kOC; ++c) o[i][c] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        const float p = fast_exp2(fmaf(s[i][j], scale_log2, -base_max));  // 0 if masked
        // l * alpha + p in one FFMA, then + p (both f32 paths, see the header)
        l[i] = j == 0 ? fmaf(l[i], alpha, p) : l[i] + p;
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
    // a live row always sees its own key, so l > 0 and lse is finite;
    // m * ln2 and logf(l) rounded apart (both f32 paths)
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * heads + h) * seq + row] =
          __fadd_rn(__fmul_rn(m[i], kLn2), logf(l[i]));
  }
}


// ---------------------------------------------------------------------------
// f32, small grids: few-row blocks over a K/V ring
// ---------------------------------------------------------------------------
// The tile path's grid, ceil(T / 64) * H * B, at or below which f32 takes
// this path: where it stopped winning on the card (scripts/attention_sweep.py;
// at 192 it lost or tied at all but one of the shapes timed).
constexpr int kSmallGridBlocks = 96;
constexpr int kSgRows = 32;          // query rows a block
constexpr int kSgRowsAThread = 2;
constexpr int kSgStages = 3;         // K/V ring depth

template <int D>
struct SgTile {
  static_assert(kFmaBK == 32, "a producer lane a key id");
  static constexpr int kRG = kSgRows / kSgRowsAThread;  // row groups: rows ty + i*kRG
  static constexpr int kConsumers = kRG * 8;            // row groups x 8 lanes
  static_assert(kConsumers % 32 == 0, "whole consumer warps");
  static constexpr int kThreads = kConsumers + 32;      // + the producer warp
  static_assert(kSgRowsAThread * D <= 128, "a thread's Q rows in registers");
  static constexpr int kBoxF = D < 32 ? D : 32;  // floats a TMA box row: 64 or 128 bytes
  static constexpr int kBox = kFmaBK * kBoxF;      // floats a TMA box
  // A stage holds the tile's K rows, then its V rows: D / kBoxF boxes of
  // [32 rows x kBoxF] each, swizzled.
  static constexpr int kKFloats = kFmaBK * D;
  static constexpr int kStageFloats = 2 * kKFloats;
  static constexpr int kPPitch = kFmaBK + 8;
  // 1024 bytes to align the ring (the swizzle's period), the ring, the key
  // ids of each stage, P, the full and empty barriers; then the plan
  static constexpr int kFixedBytes =
      1024 + 4 * (kSgStages * (kStageFloats + kFmaBK) + kSgRows * kPPitch) + 16 * kSgStages;
  static int smem_bytes(int seq) { return kFixedBytes + plan_bytes(seq, kFmaBK); }

  // The float offset of (row r, column c) of a K or V tile in a stage (c
  // a multiple of 2; 4 for K); `kv` 0 for K, 1 for V.
  __device__ __forceinline__ static int at(int kv, int r, int c) {
    const int w = c % kBoxF;
    const int xr = kBoxF == 32 ? (r & 7) : ((r >> 1) & 3);  // the 16-byte chunk's xor
    return kv * kKFloats + c / kBoxF * kBox + r * kBoxF + 4 * ((w >> 2) ^ xr) + (w & 3);
  }
};

// Kernel 1's f32 forward for small grids: each row's arithmetic is the
// tile kernel's (see the header), in blocks of kSgRows rows, kSgRowsAThread
// a thread. The last warp produces: lane 0 issues the K and V boxes of
// each planned tile by TMA into a ring of kSgStages stages, every lane
// copies one of the tile's key ids by cp.async (keys past T are masked by
// position), and the stage lands on its full barrier (lane 0's arrival
// with the boxes' bytes, one cp.async arrival a lane); each consumer warp
// releases a stage on its empty barrier when done with it. No block
// barrier in the loop: a warp's P goes through shared memory under
// __syncwarp only.
template <int D>
__global__ void __launch_bounds__(SgTile<D>::kThreads)
flash_fwd_small_kernel(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const float* __restrict__ q,
                       const int* __restrict__ seg, float* __restrict__ out,
                       float* __restrict__ lse, int seq, int heads, float scale) {
  using Tile = SgTile<D>;
  constexpr int BQ = kSgRows;
  constexpr int RM = kSgRowsAThread;
  constexpr int BK = kFmaBK;
  constexpr int kRG = Tile::kRG;
  constexpr int kKJ = BK / 8;  // keys a thread: j*8 + tx
  constexpr int kPPitch = Tile::kPPitch;
  constexpr int kVec = D >= 32 ? 4 : 2;  // O columns a chunk
  constexpr int kOC = D / 8;             // O columns a thread
  constexpr int kChunks = kOC / kVec;
  constexpr int kConsumers = Tile::kConsumers;
  extern __shared__ __align__(16) unsigned char sg_smem[];
  unsigned char* smem = sg_smem + ((1024u - (shared_addr(sg_smem) & 1023u)) & 1023u);
  float* ring = reinterpret_cast<float*>(smem);
  int* ids = reinterpret_cast<int*>(ring + kSgStages * Tile::kStageFloats);
  float* ps = reinterpret_cast<float*>(ids + kSgStages * BK);
  uint64_t* full = reinterpret_cast<uint64_t*>(ps + BQ * kPPitch);
  uint64_t* empty = full + kSgStages;
  int* plan = reinterpret_cast<int*>(empty + kSgStages);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long tok = static_cast<long long>(heads) * D;
  const long long base = static_cast<long long>(b) * seq * tok +
                         static_cast<long long>(h) * D;
  const int* segb = seg + static_cast<long long>(b) * seq;
  const int q0 = blockIdx.x * BQ;

  if (tid == 0) {
    for (int s = 0; s < kSgStages; ++s) {
      mbar_init(full + s, 33);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_fence_init();
  }
  const int n = plan_tiles<BQ, BK, Tile::kThreads>(segb, seq, q0, plan);  // barriers seen

  if (tid >= kConsumers) {  // the producer warp
    for (int idx = 0; idx < n; ++idx) {
      const int st = idx % kSgStages;
      if (idx >= kSgStages) mbar_wait(empty + st, (idx / kSgStages - 1) & 1);
      const int k0 = plan[idx] * BK;
      if (lane == 0) {
        mbar_arrive_expect_tx(full + st, Tile::kStageFloats * 4);
        float* kt = ring + st * Tile::kStageFloats;
#pragma unroll
        for (int c = 0; c < D / Tile::kBoxF; ++c) {
          tma_load_4d(kt + c * Tile::kBox, &k_map, full + st, c * Tile::kBoxF, h, k0, b);
          tma_load_4d(kt + Tile::kKFloats + c * Tile::kBox, &v_map, full + st,
                      c * Tile::kBoxF, h, k0, b);
        }
      }
      if (k0 + lane < seq) cp_async4(ids + st * BK + lane, segb + k0 + lane);
      mbar_arrive_cp_async(full + st);
    }
    return;
  }

  const int tx = lane % 8;
  const int ty = (tid / 32) * 4 + lane / 8;
  // the thread's Q rows in registers (the 8 lanes of a row read the same
  // addresses), and the range of the warp's live row segments
  int segq[RM];
  float4 qr[RM][D / 4];
  int wlo = INT_MAX;
  int whi = INT_MIN;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + i * kRG;
    const bool live = row < seq;  // a row past T writes nothing
    segq[i] = live ? segb[row] : 0;
    if (live) {
      wlo = min(wlo, segq[i]);
      whi = max(whi, segq[i]);
    }
    const float4* src = reinterpret_cast<const float4*>(q + base + (live ? row : 0) * tok);
#pragma unroll
    for (int c = 0; c < D / 4; ++c) qr[i][c] = live ? src[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, off));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, off));
  }
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
  float* p_row = ps + ty * kPPitch;  // row i at + i * kRG * kPPitch

  for (int idx = 0; idx < n; ++idx) {
    const int st = idx % kSgStages;
    mbar_wait(full + st, (idx / kSgStages) & 1);
    const float* kv = ring + st * Tile::kStageFloats;
    const int k0 = plan[idx] * BK;
    // A warp none of whose live rows' segment range holds a key's segment
    // skips the tile: for each of its rows the tile would change nothing.
    const int segl = k0 + lane < seq ? ids[st * BK + lane] : kNoSegment;
    if (!__any_sync(0xffffffffu, segl >= wlo && segl <= whi)) {
      if (lane == 0) mbar_arrive(empty + st);
      continue;
    }

    // S = Q K^T over d, 4 at a time: RM Q rows and kKJ K rows a step
    float s[RM][kKJ];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < kKJ; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 a[RM];
      float4 bk[kKJ];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = qr[i][d / 4];
#pragma unroll
      for (int j = 0; j < kKJ; ++j)
        bk[j] = *reinterpret_cast<const float4*>(kv + Tile::at(0, j * 8 + tx, d));
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
    for (int j = 0; j < kKJ; ++j)
      segk[j] = k0 + j * 8 + tx < seq ? ids[st * BK + j * 8 + tx] : kNoSegment;
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
#pragma unroll
      for (int c = 0; c < kOC; ++c) o[i][c] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        const float p = fast_exp2(fmaf(s[i][j], scale_log2, -base_max));  // 0 if masked
        // l * alpha + p in one FFMA, then + p, as in the tile kernel
        l[i] = j == 0 ? fmaf(l[i], alpha, p) : l[i] + p;
        p_row[i * kRG * kPPitch + j * 8 + tx] = p;
      }
    }
    __syncwarp();  // the warp's P written

    // O += P V over the tile's keys, 4 at a time
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
          load_vec<kVec>(vv + ch * kVec, kv + Tile::at(1, kk + e, tx * kVec + ch * 8 * kVec));
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = e == 0 ? p4[i].x : e == 1 ? p4[i].y : e == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < kOC; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
        }
      }
    }
    __syncwarp();  // the warp is done with the stage and with P
    if (lane == 0) mbar_arrive(empty + st);
  }

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
    // m * ln2 and logf(l) rounded apart, as in the tile kernel
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * heads + h) * seq + row] =
          __fadd_rn(__fmul_rn(m[i], kLn2), logf(l[i]));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// path: the bf16 wgmma kernel, the f32 64-row tile, the f32 small grid
constexpr int kPathWgmma = 0;
constexpr int kPathTile = 1;
constexpr int kPathSmall = 2;

struct Config {
  const void* fn;
  int threads, smem, rows, keys, path;  // block threads, dynamic bytes, BQ, BK, path
};

template <int D>
Config wgmma_config(int seq) {
  return Config{reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<D>), WgFwdTile<D>::kThreads,
                WgFwdTile<D>::smem_bytes(seq), kWgRows, kWgKeys, kPathWgmma};
}

template <int D>
Config fma_config(int seq) {
  return Config{reinterpret_cast<const void*>(flash_fwd_fma_kernel<D>), FmaTile<D>::kThreads,
                FmaTile<D>::kFixedBytes + plan_bytes(seq, kFmaBK), kFmaBQ, kFmaBK, kPathTile};
}

template <int D>
Config small_config(int seq) {
  return Config{reinterpret_cast<const void*>(flash_fwd_small_kernel<D>), SgTile<D>::kThreads,
                SgTile<D>::smem_bytes(seq), kSgRows, kFmaBK, kPathSmall};
}

// The kernel for a problem. bf16: the wgmma kernel. f32: the small-grid
// path while the tile path's grid is at most kSmallGridBlocks blocks.
template <int D>
Config choose(int batch, int seq, int heads, int dtype) {
  if (dtype == 1) return wgmma_config<D>(seq);
  const long long rows = static_cast<long long>(heads) * batch;
  if ((seq + kFmaBQ - 1) / kFmaBQ * rows > kSmallGridBlocks) return fma_config<D>(seq);
  return small_config<D>(seq);
}

Config config_for(int batch, int seq, int heads, int head_dim, int dtype) {
  switch (head_dim) {
    case 16: return choose<16>(batch, seq, heads, dtype);
    case 32: return choose<32>(batch, seq, heads, dtype);
    case 64: return choose<64>(batch, seq, heads, dtype);
    default: return Config{nullptr, 0, 0, 0, 0, 0};
  }
}

// Launches above 48 KB of dynamic shared memory (the plan grows with T,
// bf16 adds its flush copy past T = 512, the small-grid ring is ~56 KB at
// D = 64) need the limit raised first.
cudaError_t allow_smem(const Config& cfg) {
  if (cfg.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(cfg.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
}

bool valid_args(int batch, int seq, int heads, int head_dim, int dtype) {
  return batch > 0 && seq > 0 && heads > 0 && batch <= 65535 && heads <= 65535 &&
         (dtype == 0 || dtype == 1) &&
         (head_dim == 16 || head_dim == 32 || head_dim == 64);
}

// Launches cfg's kernel on a problem: the bf16 path with its Q, K, V and
// out tensor maps and the small-grid path with its K and V maps (encoded
// here, passed by value), the tile path with pointers. A map the driver
// refuses is an error, as a refused launch is.
cudaError_t launch_config(const Config& cfg, const void* q, const void* k, const void* v,
                          const int* seg, void* out, float* lse, int batch, int seq, int heads,
                          int head_dim, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(cfg);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + cfg.rows - 1) / cfg.rows, heads, batch);
  if (cfg.path == kPathTile) {
    void* args[] = {&q, &k, &v, &seg, &out, &lse, &seq, &heads, &scale};
    err = cudaLaunchKernel(cfg.fn, grid, dim3(cfg.threads), args, cfg.smem, stream);
  } else if (cfg.path == kPathWgmma) {
    alignas(64) CUtensorMap maps[4] = {};
    const void* bases[4] = {q, k, v, out};
    for (int i = 0; i < 4; ++i)
      if (!encode_bthd_map(&maps[i], bases[i], batch, seq, heads, head_dim, kWgKeys))
        return cudaErrorInvalidValue;
    void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &seg, &lse, &seq, &heads, &scale};
    err = cudaLaunchKernel(cfg.fn, grid, dim3(cfg.threads), args, cfg.smem, stream);
  } else {
    alignas(64) CUtensorMap maps[2] = {};
    if (!(encode_bthd_map(&maps[0], k, batch, seq, heads, head_dim, kFmaBK, true) &&
          encode_bthd_map(&maps[1], v, batch, seq, heads, head_dim, kFmaBK, true)))
      return cudaErrorInvalidValue;
    void* args[] = {&maps[0], &maps[1], &q, &seg, &out, &lse, &seq, &heads, &scale};
    err = cudaLaunchKernel(cfg.fn, grid, dim3(cfg.threads), args, cfg.smem, stream);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
  return static_cast<int>(launch_config(
      config_for(batch, seq, heads, head_dim, dtype), q, k, v, static_cast<const int*>(seg), out,
      static_cast<float*>(lse), batch, seq, heads, head_dim, scale,
      static_cast<cudaStream_t>(stream)));
}

// The launch configuration chosen for a problem: out[0] threads a block,
// out[1] dynamic shared memory bytes, out[2] query rows a block, out[3]
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// after the shared-memory attribute is set), out[4] keys a tile, out[5]
// the path (0 the bf16 wgmma kernel, 1 the f32 64-row tile, 2 the f32
// small grid). Returns a cudaError_t.
extern "C" int convdr_flash_attention_fwd_config(int batch, int seq,
                                                 int heads, int head_dim,
                                                 int dtype, int* out) {
  if (!valid_args(batch, seq, heads, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = config_for(batch, seq, heads, head_dim, dtype);
  cudaError_t err = allow_smem(cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cfg.fn, cfg.threads, cfg.smem);
  out[0] = cfg.threads;
  out[1] = cfg.smem;
  out[2] = cfg.rows;
  out[3] = blocks;
  out[4] = cfg.keys;
  out[5] = cfg.path;
  return static_cast<int>(err);
}

