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
// the kernel's six-part bf16 products, 24*B*H*D*pairs operations at the
// tensor cores' 989 TFLOP/s (0.41 of the function's 4*B*H*D*pairs on the
// CUDA cores at 67 TFLOP/s, the floor of any design without the tensor
// cores). Only in-segment pairs count: a key tile whose segment range
// holds no query of the block is neither loaded nor multiplied.
//
// Both kernels share the block's prologue, the tile plan. Each block scans
// its row's segment ids once: the [min, max] segment range of every key
// tile, kept only if some live query of the block has a segment in it. The
// kept tiles' indices go, in order, to shared memory after the fixed
// buffers (one int a tile), so the main loop walks only tiles it needs.
// K/V tiles arrive by TMA (a 4-D map over [B, T, H, D]; rows past T as
// zeros), the tile's key ids by cp.async beside them (keys past T are
// masked by position).
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
// * f32 (the query encoder, the student, the teacher's documents): the
//   tensor cores, as six bf16 wgmma products of exact bf16 parts (the
//   counterpart of the MXU's Precision.HIGHEST on f32 x f32; no TF32).
//   For training it also writes each row's log-sum-exp of the scaled
//   scores, lse [B, H, T] f32, which the backward (flash_attention_bwd.cu)
//   uses to recompute P; inference passes a null lse (both dtypes), and
//   out's arithmetic does not change with it.
//   - The parts: q, k, v each split exactly into three bf16 parts by
//     truncation (bf16_split2: ops/fused_search.py bf16_query_parts' parts
//     bit for bit), Q once a block from device memory, K and V from the
//     f32 tiles TMA brings (two boxes of 32 floats a row at D = 64, each
//     under the 128-byte swizzle), by every thread of the block, into part
//     tiles in the bf16 kernel's layout; no part goes to device memory.
//     S = Q K^T is six products a k-step of K's part i and Q's part j,
//     (1,1), (1,2), (2,1), (1,3), (2,2), (3,1) in that order (hopper.cuh's
//     wgmma_f32_parts_kstep with Q as its A; the dropped three are below
//     2^-20 of each product), both operands in shared
//     memory; (1,1) goes into one f32 sum and the five small ones into
//     another, added rounded to nearest (one sum for all six put lse 2.4e-5
//     from f64 on near-parallel rows, B=40 T=512, on the card: a long
//     one-signed sum takes a truncating tensor-core add a product). P, in
//     f32 as the softmax makes it, splits into three parts in registers,
//     the A operand of O += P V against V's parts as an MN-major B: six
//     products a 16-key k-step, (V_i, P_j) in the same order, (1,1) into
//     one sum of the tile's own and the five small ones into another; each
//     thread adds the two, rounded to nearest, into O in IEEE f32 (o alpha
//     + tile, one fmaf). Measured on the card (scripts/attention_sweep.py
//     --parts accuracy, on scratch trees of this source): O summed in the
//     tensor cores across all tiles was 2.9e-4 from f64 at T = 30000 on
//     near-parallel rows, 7.4e-5 with a (1,1) sum of its own; one sum a
//     tile held 1e-5, but its truncation (2.4e-6 of out on near-parallel
//     rows, one-signed) moved the f32 train step's query gradients 1.8e-4
//     of scale from f64, past the plain step's 1.5e-5 (chip_smoke.py's
//     check_train_step; the backward reads this out). The softmax is
//     the bf16 kernel's on S's fragments: the log2 domain, fast_exp2, the
//     base_max and -inf rules, the xor-1/2 row reductions; l alpha + p as
//     one fmaf at a row's first key of a tile, then adds key by key; lse
//     as __fmul_rn(m, ln2) and logf(l) rounded apart.
//   - The block: kWG warpgroups of 64 query rows (one wgmma M each) and
//     64-key tiles; warp 0 issues each planned tile's K and V boxes by TMA
//     onto two mbarriers and copies its key ids beside K's. A tile: S
//     from the parts, the softmax in S's registers, P split; a barrier;
//     P V; while P V computes, every thread splits the next tile's K and V
//     (V's parts double-buffered: this tile's P V reads the other set);
//     then O. No split between S's issue and its wait: ptxas 12.9 fails
//     (segfault) on that kernel. Two warpgroups (128 rows, 256 threads,
//     one block an SM) share each tile's split and take grids of more than
//     kSmallGridBlocks such blocks; below, one warpgroup of 64 rows doubles
//     the blocks (the serving encode's B=1 T=256: 48). A row's bits depend
//     on its q row, its keys and the k order only (the wgmma probe of
//     scores_groupmax.cu), and a tile a block plans none of whose keys is
//     in a row's segment leaves that row's m, l and o as they were (alpha
//     = 1, p = 0): so both block shapes give the same out and lse bit for
//     bit, and the card tests hold them to that (torch.equal).
// * bf16 causal, (192, 128) head dims (a decoder's latent attention,
//   convdr_flash_attention_causal_fwd): the bf16 kernel's design
//   over 64-column sub-tiles, a causal mask beside the segment rule; see
//   flash_fwd_causal_kernel.
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
// bf16 causal, query/key head dim 192 and value head dim 128: latent
// attention (DeepSeek-V2's MLA) as a decoder encodes a passage
// ---------------------------------------------------------------------------
// The bf16 kernel's design at wider heads, with a causal mask: query t sees
// key s iff s <= t and seg[b, t] == seg[b, s] (right padding keeps every
// valid token's keys valid; a pad sees the pads up to itself, so no row is
// empty). A row of Q or K is 384 bytes, more than one 128-byte swizzle
// atom, so every tile is held as 64-column sub-tiles of 128-byte rows
// (Q and K three, V and out two), each a box of its own under the 128-byte
// swizzle: S is the sum of three sub-tiles' Q K^T (4 k-steps each), P V
// two m64n64 products, one for each half of V's columns, with P's three
// truncated terms as the bf16 kernel has them. A block of 64 queries
// plans only the key tiles at or below its diagonal (tile index <=
// blockIdx.x: keys and queries are tiled alike) and masks by position only
// in the diagonal tile. O is 64 f32 registers a thread, so two blocks
// share an SM (the loop's registers are capped at 255).
constexpr int kCausalMinBlocks = 2;

struct CausalTile {
  static constexpr int kQkDim = 192;
  static constexpr int kVDim = 128;
  static constexpr int kSub = kWgKeys * 128;              // a [64][64] bf16 sub-tile
  static constexpr int kQkSubs = kQkDim / 64;             // 3
  static constexpr int kVSubs = kVDim / 64;               // 2
  static constexpr int kThreads = 128;                    // one warpgroup: 64 query rows
  static constexpr int kKBytes = kQkSubs * kSub;          // a K (or Q) tile
  static constexpr int kVBytes = kVSubs * kSub;           // a V (or out) tile
  static constexpr int kStage = kKBytes + kVBytes;
  static constexpr int kRingOff = kKBytes;                // after the Q tile
  static constexpr int kIdsOff = kRingOff + kWgStages * kStage;
  static constexpr int kBarOff = kIdsOff + kWgStages * kWgKeys * 4;
  static constexpr int kPlanOff = kBarOff + (2 * kWgStages + 1) * 8;
  static constexpr int kAcc = kVDim / 2;  // O's f32 registers a thread
  __host__ __device__ static int flush_off(int seq) {
    return kPlanOff + (plan_bytes(seq, kWgKeys) + 15) / 16 * 16;
  }
  static int smem_bytes(int seq) {
    const int nt = (seq + kWgKeys - 1) / kWgKeys;
    return 1024 + flush_off(seq) + (nt > kFlushTiles ? 4 * kAcc * kThreads : 0);
  }
};

__global__ void __launch_bounds__(CausalTile::kThreads, kCausalMinBlocks)
flash_fwd_causal_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap out_map,
                        const int* __restrict__ seg, int seq, float scale) {
  using Tl = CausalTile;
  constexpr int kAcc = Tl::kAcc;
  constexpr int kHalf = kAcc / 2;  // registers of one 64-column half of O
  extern __shared__ __align__(16) unsigned char cf_smem[];
  unsigned char* smem = cf_smem + ((1024u - (shared_addr(cf_smem) & 1023u)) & 1023u);
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
    mbar_arrive_expect_tx(q_full, Tl::kKBytes);
#pragma unroll
    for (int c = 0; c < Tl::kQkSubs; ++c)
      tma_load_4d(smem + c * Tl::kSub, &q_map, q_full, 64 * c, h, q0, b);
  }
  int n = plan_tiles<kWgRows, kWgKeys, Tl::kThreads>(segb, seq, q0, plan);
  // the plan is in order: the tiles past the block's diagonal go
  while (n > 0 && plan[n - 1] > static_cast<int>(blockIdx.x)) --n;

  const int warp = tid / 32;
  const int lane = tid % 32;
  auto load_tile = [&](int idx) {
    const int st = idx % kWgStages;
    const int k0 = plan[idx] * kWgKeys;
    if (lane == 0) {
      unsigned char* kv = smem + Tl::kRingOff + st * Tl::kStage;
      mbar_arrive_expect_tx(full + st, Tl::kStage);
#pragma unroll
      for (int c = 0; c < Tl::kQkSubs; ++c)
        tma_load_4d(kv + c * Tl::kSub, &k_map, full + st, 64 * c, h, k0, b);
#pragma unroll
      for (int c = 0; c < Tl::kVSubs; ++c)
        tma_load_4d(kv + Tl::kKBytes + c * Tl::kSub, &v_map, full + st, 64 * c, h, k0, b);
    }
    int* sk = ids + st * kWgKeys;
    if (k0 + lane < seq) cp_async4(sk + lane, segb + k0 + lane);
    if (k0 + lane + 32 < seq) cp_async4(sk + lane + 32, segb + k0 + lane + 32);
    mbar_arrive_cp_async(full + st);
  };
  if (warp == 0)
    for (int idx = 0; idx < min(n, kWgStages); ++idx) load_tile(idx);

  const int g = lane / 4;
  const int t = lane % 4;
  int rows[2];
  int segq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = q0 + 16 * warp + g + 8 * r;
    segq[r] = rows[r] < seq ? segb[rows[r]] : 0;
  }
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
  float o0[kHalf];  // O's columns 0..63, the accumulator fragments of [64][64]
  float o1[kHalf];  // and 64..127
#pragma unroll
  for (int i = 0; i < kHalf; ++i) o0[i] = o1[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float since_flush[2] = {1.f, 1.f};
  int tiles = 0;
  bool flushed = false;
  const float scale_log2 = scale * kLog2e;
  mbar_wait(q_full, 0);

  for (int idx = 0; idx < n; ++idx) {
    const int st = idx % kWgStages;
    mbar_wait(full + st, (idx / kWgStages) & 1);
    const int k0 = plan[idx] * kWgKeys;
    const int lim = seq - k0;
    const int* sk = ids + st * kWgKeys;
    const int sa = lane < lim ? sk[lane] : kNoSegment;
    const int sb = lane + 32 < lim ? sk[lane + 32] : kNoSegment;
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
    // below the diagonal tile every key precedes every row of the block
    const bool unmasked = plan[idx] < static_cast<int>(blockIdx.x) && wlo == whi &&
                          __all_sync(0xffffffffu, sa == wlo && sb == wlo);
    const uint32_t kv = base + Tl::kRingOff + st * Tl::kStage;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < Tl::kQkSubs; ++c) {
      const uint64_t qd = wgmma_desc(base + c * Tl::kSub, 128);
      const uint64_t kd = wgmma_desc(kv + c * Tl::kSub, 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(s, qd + 2 * kk, kd + 2 * kk, c + kk);
    }
    wgmma_commit();
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
          const int e = i & 1;
          const bool allowed = (e ? sg.y : sg.x) == segq[r] && k0 + key + e <= rows[r];
          s[i] = allowed ? s[i] : -CUDART_INF_F;
          tile_max[r] = fmaxf(tile_max[r], s[i]);
        }
      }
    }
    float base_max[2];
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m[r], tile_max[r] * scale_log2);
      base_max[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = fast_exp2(m[r] - base_max[r]);
      l[r] *= alpha[r];
      m[r] = m_new;
    }
    if (tiles == kFlushTiles) {
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        float* f0 = flushed_o + i * Tl::kThreads + tid;
        float* f1 = flushed_o + (kHalf + i) * Tl::kThreads + tid;
        *f0 = flushed ? fmaf(*f0, since_flush[(i >> 1) & 1], o0[i]) : o0[i];
        *f1 = flushed ? fmaf(*f1, since_flush[(i >> 1) & 1], o1[i]) : o1[i];
        o0[i] = o1[i] = 0.f;
      }
      since_flush[0] = since_flush[1] = 1.f;
      tiles = 0;
      flushed = true;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        o0[i] *= alpha[(i >> 1) & 1];
        o1[i] *= alpha[(i >> 1) & 1];
      }
      since_flush[0] *= alpha[0];
      since_flush[1] *= alpha[1];
    }

    uint32_t pa[kParts][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kk + 2 * q;
        const int r = q & 1;
        float x = fast_exp2(fmaf(s[i], scale_log2, -base_max[r]));
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
    // O += P V: each half of V's columns an MN-major B of 128-byte rows,
    // k-steps of 16 keys at +16 rows
    constexpr uint32_t kStep = 16 * 128 >> 4;
    const uint64_t v0 = wgmma_desc(kv + Tl::kKBytes, 128);
    const uint64_t v1 = wgmma_desc(kv + Tl::kKBytes + Tl::kSub, 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        wgmma_rs<64>(o0, pa[part][kk], v0 + kk * kStep, 1);
        wgmma_rs<64>(o1, pa[part][kk], v1 + kk * kStep, 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(o0);
    wgmma_fence_regs(o1);
    refill();
    ++tiles;
  }
  if (flushed) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      o0[i] = fmaf(flushed_o[i * Tl::kThreads + tid], since_flush[(i >> 1) & 1], o0[i]);
      o1[i] = fmaf(flushed_o[(kHalf + i) * Tl::kThreads + tid], since_flush[(i >> 1) & 1], o1[i]);
    }
  }

  // out in bf16 into the Q tile's first two sub-tiles, stored by TMA
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(smem + swizzled_chunk_offset(row, j, 128) + 4 * t) =
          pack_bf16(o0[4 * j + 2 * r] * inv, o0[4 * j + 2 * r + 1] * inv);
      *reinterpret_cast<uint32_t*>(smem + Tl::kSub + swizzled_chunk_offset(row, j, 128) + 4 * t) =
          pack_bf16(o1[4 * j + 2 * r] * inv, o1[4 * j + 2 * r + 1] * inv);
    }
  }
  fence_shared_to_async();
  named_barrier(1, Tl::kThreads);
  if (tid == 0) {
    tma_store_4d(&out_map, smem, 0, h, q0, b);
    tma_store_4d(&out_map, smem + Tl::kSub, 64, h, q0, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

// ---------------------------------------------------------------------------
// f32: six-part bf16 wgmma over a TMA ring
// ---------------------------------------------------------------------------
constexpr int kF32Keys = 64;  // keys a tile: the N of S
constexpr int kF32Rows = 64;  // query rows a warpgroup: one wgmma M
// The f32 blocks: one warpgroup of 64 query rows while the grid of 128-row
// blocks is at most this many (it fills under half the card's 132 SMs),
// two warpgroups of 64 above, which share each tile's split.
constexpr int kSmallGridBlocks = 64;

// Shared memory of a block (from a 1024-byte aligned base): each
// warpgroup's three Q part tiles, K's three part tiles, two sets of V's
// (the tile's and the next's; all [64][D] bf16 in the swizzle of the row's
// width, as the bf16 kernel's tiles), the f32 K and V tiles as TMA writes
// them (D / kBoxF boxes of 64 rows, each swizzled by its width), two
// tiles' key ids, the barriers, the tile plan.
template <int D, int kWG>
struct F32FwdTile {
  static constexpr int kThreads = 128 * kWG;  // kWG warpgroups of 64 query rows
  static constexpr int kRows = kF32Rows * kWG;
  static constexpr int kRowBytes = 2 * D;             // a row of a bf16 part tile
  static constexpr int kPart = kF32Keys * kRowBytes;  // a part tile
  static constexpr int kBoxF = D < 32 ? D : 32;       // floats a TMA box row: 64 or 128 bytes
  static constexpr int kBox = kF32Keys * kBoxF * 4;   // bytes a box
  static constexpr int kF32Tile = kF32Keys * D * 4;   // an f32 K or V tile
  static constexpr int kKOff = kWG * 3 * kPart;
  static constexpr int kVOff = kKOff + 3 * kPart;     // + (idx & 1) 3 kPart
  static constexpr int kKf = kVOff + 6 * kPart;
  static constexpr int kVf = kKf + kF32Tile;
  static constexpr int kIdsOff = kVf + kF32Tile;
  static constexpr int kBarOff = kIdsOff + 2 * kF32Keys * 4;
  static constexpr int kPlanOff = kBarOff + 2 * 8;
  static constexpr int kAcc = D / 2;  // O's f32 registers a thread
  static_assert(kPart % 1024 == 0 && kBox % 1024 == 0, "tiles on 1024-byte bases");
  static int smem_bytes(int seq) { return 1024 + kPlanOff + plan_bytes(seq, kF32Keys); }
  // The byte offset of floats d..d+3 (d a multiple of 4) of row r of an f32 tile
  __device__ static int f32_at(int r, int d) {
    return d / kBoxF * kBox + swizzled_chunk_offset(r, d % kBoxF / 4, kBoxF * 4);
  }
};

// Splits an f32 K or V tile into its three part tiles, the block's threads
// sharing its 64 x D/8 chunks.
template <int D, int kWG>
__device__ __forceinline__ void split_tile(const unsigned char* f32, unsigned char* parts,
                                           int tid) {
  using Tl = F32FwdTile<D, kWG>;
  constexpr int kChunks = D / 8;  // 16-byte chunks a part row
  constexpr int kTotal = kF32Keys * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + Tl::kThreads - 1) / Tl::kThreads; ++it) {
    const int i = tid + it * Tl::kThreads;
    if (kTotal % Tl::kThreads != 0 && i >= kTotal) break;
    const int r = i / kChunks;
    const int c = i % kChunks;
    store_parts<Tl::kRowBytes, Tl::kPart>(
        parts, r, c, *reinterpret_cast<const float4*>(f32 + Tl::f32_at(r, 8 * c)),
        *reinterpret_cast<const float4*>(f32 + Tl::f32_at(r, 8 * c + 4)));
  }
}

// S of 64 queries and a 64-key tile from the parts: D / 16 k-steps of
// wgmma_f32_parts_kstep, Q's part tiles as its A (at q_desc + (j - 1) kP)
// and K's as its B (k_desc + (i - 1) kP); one commit group. (1,1) goes
// into big and the five small products into small, so that the large
// running sum takes one truncating tensor-core add a k-step (one sum for
// all six put lse 2.4e-5 from f64 on near-parallel rows).
template <int D, int kP>
__device__ __forceinline__ void issue_s_f32(float (&big)[32], float (&small)[32],
                                            uint64_t q_desc, uint64_t k_desc) {
  wgmma_fence();
  wgmma_f32_parts_kstep<64, kP, kP, 0>(big, small, q_desc, k_desc, 0);
  if constexpr (D >= 32) wgmma_f32_parts_kstep<64, kP, kP, 2>(big, small, q_desc, k_desc, 1);
  if constexpr (D >= 64) {
    wgmma_f32_parts_kstep<64, kP, kP, 4>(big, small, q_desc, k_desc, 1);
    wgmma_f32_parts_kstep<64, kP, kP, 6>(big, small, q_desc, k_desc, 1);
  }
  wgmma_commit();
}

// A tile's O = P V from the parts: 4 k-steps of 16 keys, each the six
// products of V's part i (an MN-major B at v_desc + (i - 1) kP + the
// k-step's 16 rows) and P's part j (registers: pa[kk][j - 1]) in S's order,
// (1,1), (1,2), (2,1), (1,3), (2,2), (3,1); (1,1) into big and the five
// small ones into small, as S's, the first product of each overwriting it.
// One commit group.
template <int D, int kP>
__device__ __forceinline__ void issue_pv_f32(float (&big)[D / 2], float (&small)[D / 2],
                                             const uint32_t (&pa)[4][3][4], uint64_t v_desc) {
  constexpr uint32_t kStep = 16 * 2 * D >> 4;  // 16 rows down, in descriptor units
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t vd = v_desc + kk * kStep;
    const int acc = kk == 0 ? 0 : 1;
    wgmma_rs<D>(big, pa[kk][0], vd, acc);                // (1,1)
    wgmma_rs<D>(small, pa[kk][1], vd, acc);              // (1,2)
    wgmma_rs<D>(small, pa[kk][0], vd + kP, 1);           // (2,1)
    wgmma_rs<D>(small, pa[kk][2], vd, 1);                // (1,3)
    wgmma_rs<D>(small, pa[kk][1], vd + kP, 1);           // (2,2)
    wgmma_rs<D>(small, pa[kk][0], vd + 2 * kP, 1);       // (3,1)
  }
  wgmma_commit();
}

// kWG warpgroups each own 64 query rows; warp 0 issues the copies. See the
// header for the design. One block an SM at D = 64 (its shared memory),
// so registers up to 255 a thread.
template <int D, int kWG>
__global__ void __launch_bounds__(F32FwdTile<D, kWG>::kThreads, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const float* __restrict__ q,
                     const int* __restrict__ seg, float* __restrict__ out,
                     float* __restrict__ lse, int seq, int heads, float scale) {
  using Tl = F32FwdTile<D, kWG>;
  constexpr int kAcc = Tl::kAcc;
  constexpr int kP = Tl::kPart >> 4;  // a part tile, in descriptor units
  constexpr int kChunks = D / 8;      // 16-byte chunks a part row
  extern __shared__ __align__(16) unsigned char ff_smem[];
  unsigned char* smem = ff_smem + ((1024u - (shared_addr(ff_smem) & 1023u)) & 1023u);
  int* ids = reinterpret_cast<int*>(smem + Tl::kIdsOff);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + Tl::kBarOff);
  uint64_t* v_full = k_full + 1;
  int* plan = reinterpret_cast<int*>(smem + Tl::kPlanOff);

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int* segb = seg + static_cast<long long>(b) * seq;
  const int q0 = blockIdx.x * Tl::kRows;
  const long long tok = static_cast<long long>(heads) * D;  // floats a token
  const long long head0 = static_cast<long long>(b) * seq * tok + static_cast<long long>(h) * D;

  if (tid == 0) {
    mbar_init(k_full, 1 + 32);  // the TMA's bytes, then each lane's key ids
    mbar_init(v_full, 1);
    mbar_fence_init();
  }
  // every thread (its barriers also publish the mbarriers' initialisation)
  const int n = plan_tiles<Tl::kRows, kF32Keys, Tl::kThreads>(segb, seq, q0, plan);

  const int warp = tid / 32;
  const int lane = tid % 32;
  // Planned tile idx into the f32 tiles, by warp 0: lane 0 issues the K and
  // V boxes by TMA (K's onto k_full, V's onto v_full), each lane copies two
  // of the tile's key ids by cp.async into the id buffer of idx's parity,
  // arriving on k_full when they have landed (keys past T are masked by
  // position).
  auto load_tile = [&](int idx) {
    const int k0 = plan[idx] * kF32Keys;
    if (lane == 0) {
      mbar_arrive_expect_tx(k_full, Tl::kF32Tile);
      mbar_arrive_expect_tx(v_full, Tl::kF32Tile);
#pragma unroll
      for (int c = 0; c < D / Tl::kBoxF; ++c) {
        tma_load_4d(smem + Tl::kKf + c * Tl::kBox, &k_map, k_full, c * Tl::kBoxF, h, k0, b);
        tma_load_4d(smem + Tl::kVf + c * Tl::kBox, &v_map, v_full, c * Tl::kBoxF, h, k0, b);
      }
    }
    int* sk = ids + (idx & 1) * kF32Keys;
    if (k0 + lane < seq) cp_async4(sk + lane, segb + k0 + lane);
    if (k0 + lane + 32 < seq) cp_async4(sk + lane + 32, segb + k0 + lane + 32);
    mbar_arrive_cp_async(k_full);
  };
  // Tile idx's K and V parts, once its f32 tiles have landed: K's into the
  // one K set, V's into the set of idx's parity.
  auto split_kv = [&](int idx) {
    mbar_wait(k_full, idx & 1);
    split_tile<D, kWG>(smem + Tl::kKf, smem + Tl::kKOff, tid);
    mbar_wait(v_full, idx & 1);
    split_tile<D, kWG>(smem + Tl::kVf, smem + Tl::kVOff + (idx & 1) * 3 * Tl::kPart, tid);
    fence_shared_to_async();  // before the products read them
  };
  if (warp == 0 && n > 0) load_tile(0);

  // Q's parts, while the first tile loads: warpgroup w's 64 rows in its own
  // three part tiles (rows past T as zeros)
#pragma unroll 1
  for (int i = tid; i < Tl::kRows * kChunks; i += Tl::kThreads) {
    const int row = i / kChunks;
    const int c = i % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = x;
    if (q0 + row < seq) {
      const float4* src = reinterpret_cast<const float4*>(q + head0 + (q0 + row) * tok + 8 * c);
      x = src[0];
      y = src[1];
    }
    store_parts<Tl::kRowBytes, Tl::kPart>(smem + row / kF32Rows * 3 * Tl::kPart,
                                          row % kF32Rows, c, x, y);
  }

  // warp w of warpgroup wg owns rows 64wg + 16w + g and 64wg + 16w + g + 8
  const int wg = warp / 4;
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
  // whole, so that every decision made from it is the same in every warp
  int wlo = INT_MAX;
  int whi = INT_MIN;
#pragma unroll
  for (int c = lane; c < Tl::kRows; c += 32)
    if (q0 + c < seq) {
      wlo = min(wlo, segb[q0 + c]);
      whi = max(whi, segb[q0 + c]);
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, off));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, off));
  }

  fence_shared_to_async();  // Q's parts
  if (n > 0) split_kv(0);

  const uint32_t base = shared_addr(smem);
  const uint64_t q_desc = wgmma_desc(base + wg * 3 * Tl::kPart, Tl::kRowBytes);
  const uint64_t k_desc = wgmma_desc(base + Tl::kKOff, Tl::kRowBytes);
  float o[kAcc];  // O, the accumulator fragments of [64][D], in IEEE f32 sums
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
  float l[2] = {0.f, 0.f};  // this thread's share of the running sum
  const float scale_log2 = scale * kLog2e;

  // A tile: S from the parts, the softmax in S's registers, P split, P V,
  // and the next tile's K and V parts while P V computes.
  for (int idx = 0; idx < n; ++idx) {
    // this tile's parts are written and every warp is past the last tile's
    // P V: warp 0 loads the next tile into the f32 tiles
    named_barrier(1, Tl::kThreads);
    if (warp == 0 && idx + 1 < n) load_tile(idx + 1);
    const int lim = seq - plan[idx] * kF32Keys;  // keys at or past lim are past T
    const int* sk = ids + (idx & 1) * kF32Keys;
    const int sa = lane < lim ? sk[lane] : kNoSegment;
    const int sb = lane + 32 < lim ? sk[lane + 32] : kNoSegment;
    // a tile whose live rows and keys all share one segment needs no mask
    const bool unmasked = wlo == whi && __all_sync(0xffffffffu, sa == wlo && sb == wlo);

    float s[32];  // S = Q K^T, then P in place
    float s2[32];
    issue_s_f32<D, kP>(s, s2, q_desc, k_desc);
    wgmma_wait<0>();
    wgmma_fence_regs(s);
    wgmma_fence_regs(s2);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = __fadd_rn(s[i], s2[i]);

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
      m[r] = m_new;
    }

    // P, and the A fragments of its parts: k-step kk is keys 16kk..16kk+15,
    // register q the pair s[8kk + 2q], s[8kk + 2q + 1] (row q & 1); the
    // running sum takes l alpha + p as one fmaf at the row's first key of
    // the tile, then adds, key by key
    uint32_t pa[4][3][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kk + 2 * q;
        const int r = q & 1;
        const float x = fast_exp2(fmaf(s[i], scale_log2, -base_max[r]));  // 0 if masked
        const float y = fast_exp2(fmaf(s[i + 1], scale_log2, -base_max[r]));
        l[r] = kk == 0 && q < 2 ? fmaf(l[r], alpha[r], x) : l[r] + x;
        l[r] += y;
        uint32_t w[3];
        bf16_split2(x, y, w);
#pragma unroll
        for (int part = 0; part < 3; ++part) pa[kk][part][q] = w[part];
      }

    // every warp's S has landed: K's parts may be overwritten
    named_barrier(1, Tl::kThreads);
    float ot[kAcc];  // this tile's P V: the (1,1) products, the rest
    float ot2[kAcc];
    issue_pv_f32<D, kP>(ot, ot2, pa,
                        wgmma_desc(base + Tl::kVOff + (idx & 1) * 3 * Tl::kPart, Tl::kRowBytes));
    if (idx + 1 < n) split_kv(idx + 1);  // while P V computes
    wgmma_wait<0>();
    // the registers P V read stay unchanged until it has landed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin_fragment(pa[kk]);
    wgmma_fence_regs(ot);
    wgmma_fence_regs(ot2);
    // the tile's sums added, then into O, in IEEE f32
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      o[i] = fmaf(o[i], alpha[(i >> 1) & 1], __fadd_rn(ot[i], ot2[i]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (!live[r]) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    float* dst = out + head0 + rows[r] * tok + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    // the running max and sum that made this row's out (a live row sees
    // its own key, so l > 0 and lse is finite), m * ln2 and logf(l)
    // rounded apart
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * heads + h) * seq + rows[r]] =
          __fadd_rn(__fmul_rn(m[r], kLn2), logf(l[r]));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// path: the bf16 wgmma kernel, the f32 kernel with 128-row blocks, with 64-row blocks
constexpr int kPathWgmma = 0;
constexpr int kPathF32 = 1;
constexpr int kPathF32Small = 2;

struct Config {
  const void* fn;
  int threads, smem, rows, keys, path;  // block threads, dynamic bytes, query rows, keys a tile, path
};

template <int D>
Config wgmma_config(int seq) {
  return Config{reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<D>), WgFwdTile<D>::kThreads,
                WgFwdTile<D>::smem_bytes(seq), kWgRows, kWgKeys, kPathWgmma};
}

template <int D, int kWG>
Config f32_config(int seq) {
  using Tl = F32FwdTile<D, kWG>;
  return Config{reinterpret_cast<const void*>(flash_fwd_f32_kernel<D, kWG>), Tl::kThreads,
                Tl::smem_bytes(seq), Tl::kRows, kF32Keys, kWG == 2 ? kPathF32 : kPathF32Small};
}

// The kernel for a problem. bf16: the wgmma kernel. f32: 64-row blocks
// while the grid of 128-row blocks is at most kSmallGridBlocks, else 128-row
// blocks; each row's arithmetic is the same in both.
template <int D>
Config choose(int batch, int seq, int heads, int dtype) {
  if (dtype == 1) return wgmma_config<D>(seq);
  const long long rows = static_cast<long long>(heads) * batch;
  if ((seq + 2 * kF32Rows - 1) / (2 * kF32Rows) * rows > kSmallGridBlocks)
    return f32_config<D, 2>(seq);
  return f32_config<D, 1>(seq);
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
// bf16 adds its flush copy past T = 512, the f32 kernel holds 130-154 KB
// at D = 64) need the limit raised first.
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
// out tensor maps, the f32 paths with their K and V maps (encoded here,
// passed by value) and pointers to Q and out. A map the driver refuses is
// an error, as a refused launch is.
cudaError_t launch_config(const Config& cfg, const void* q, const void* k, const void* v,
                          const int* seg, void* out, float* lse, int batch, int seq, int heads,
                          int head_dim, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(cfg);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + cfg.rows - 1) / cfg.rows, heads, batch);
  if (cfg.path == kPathWgmma) {
    alignas(64) CUtensorMap maps[4] = {};
    const void* bases[4] = {q, k, v, out};
    for (int i = 0; i < 4; ++i)
      if (!encode_bthd_map(&maps[i], bases[i], batch, seq, heads, head_dim, kWgKeys))
        return cudaErrorInvalidValue;
    void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &seg, &lse, &seq, &heads, &scale};
    err = cudaLaunchKernel(cfg.fn, grid, dim3(cfg.threads), args, cfg.smem, stream);
  } else {
    alignas(64) CUtensorMap maps[2] = {};
    if (!(encode_bthd_map(&maps[0], k, batch, seq, heads, head_dim, kF32Keys, true) &&
          encode_bthd_map(&maps[1], v, batch, seq, heads, head_dim, kF32Keys, true)))
      return cudaErrorInvalidValue;
    void* args[] = {&maps[0], &maps[1], &q, &seg, &out, &lse, &seq, &heads, &scale};
    err = cudaLaunchKernel(cfg.fn, grid, dim3(cfg.threads), args, cfg.smem, stream);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The map of a contiguous [B, T, H, D] bf16 tensor whose box is `rows`
// consecutive t of one (b, h) and 64 columns of d (128 bytes, swizzled by
// 128 bytes): a row wider than one swizzle atom is loaded or stored as
// D / 64 boxes. Rows past T arrive as zeros and are not stored.
bool encode_bthd_cols_map(CUtensorMap* map, const void* base, int batch, int seq, int heads,
                          int head_dim, int rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t row = 2ull * head_dim;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {64u, 1u, static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_causal(const void* q, const void* k, const void* v, const int* seg, void* out,
                          int batch, int seq, int heads, float scale, cudaStream_t stream) {
  using Tl = CausalTile;
  const void* fn = reinterpret_cast<const void*>(flash_fwd_causal_kernel);
  const int smem = Tl::smem_bytes(seq);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  alignas(64) CUtensorMap maps[4] = {};
  const void* bases[4] = {q, k, v, out};
  const int dims[4] = {Tl::kQkDim, Tl::kQkDim, Tl::kVDim, Tl::kVDim};
  for (int i = 0; i < 4; ++i)
    if (!encode_bthd_cols_map(&maps[i], bases[i], batch, seq, heads, dims[i], kWgKeys))
      return cudaErrorInvalidValue;
  const dim3 grid((seq + kWgRows - 1) / kWgRows, heads, batch);
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &seg, &seq, &scale};
  err = cudaLaunchKernel(fn, grid, dim3(Tl::kThreads), args, smem, stream);
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


// The causal bf16 variant: q, k [B, T, H, 192], v and out [B, T, H, 128],
// bf16, contiguous and 16-byte aligned; seg [B, T] int32; query t sees key
// s iff s <= t and seg[b, t] == seg[b, s]; `scale` multiplies the scores
// inside the softmax. Returns a cudaError_t (0 = launched).
extern "C" int convdr_flash_attention_causal_fwd(const void* q, const void* k, const void* v,
                                                 const void* seg, void* out, int batch, int seq,
                                                 int heads, int qk_dim, int v_dim, float scale,
                                                 void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      qk_dim != CausalTile::kQkDim || v_dim != CausalTile::kVDim)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_causal(q, k, v, static_cast<const int*>(seg), out, batch, seq,
                                        heads, scale, static_cast<cudaStream_t>(stream)));
}
