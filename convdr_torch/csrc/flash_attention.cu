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
// What bounds it on an H100: at the encoder's shapes (T <= 512, D = 64) and
// in bf16 the least time is set by the bytes of q, k, v and out (about
// 4*B*T*H*D elements) against 3.35 TB/s; the 4*B*H*T*T*D operations are below
// the bf16 tensor-core roofline. In f32, which may not use TF32, the same
// operations on the CUDA cores (67 TFLOP/s) bound it instead. Two kernels,
// chosen by dtype:
//
// * bf16 (the corpus encoder): tensor cores. One block of 4 warps per
//   (64-query tile, head, batch row); each warp owns 16 queries, holding its
//   Q fragments and f32 output accumulators in registers. 64-key K/V tiles
//   are staged in shared memory with rows padded by 16 bytes (conflict-free
//   fragment reads); S = Q K^T and O += P V are `mma.sync` m16n8k16 bf16 with
//   f32 accumulation, V fragments come through `ldmatrix.trans`. P is split
//   into three bf16 terms (three products), so P V keeps all 24 bits of P:
//   the result stays within an f32-order rounding of the plain f32 softmax
//   before the final bf16 store. The online softmax keeps
//   f32 running max and sum per row. A tile whose key segment range no query
//   of the block falls in is not loaded (right-padded rows: valid queries
//   skip the pad tail, pads the valid head), and a warp none of whose rows
//   needs it skips the products.
// * f32 (the query encoder): f32 FMA on the CUDA cores, one thread per query
//   row, 32-key tiles staged in shared memory as f32 and read by all threads
//   at once (a broadcast); the tile's 32 scores accumulate as independent FMA
//   chains. Full f32 products, no TF32. For training it also writes each
//   row's log-sum-exp of the scaled scores, lse [B, H, T] f32, which the
//   backward (flash_attention_bwd.cu) uses to recompute P; inference passes
//   a null lse and the kernel writes nothing more.
//
// TMA, wgmma and pipelining of the tile loads are later work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // queries per block
constexpr int kMmaKeys = 64;              // keys per tile
// P enters P V as the sum of this many bf16 terms (8 more bits of P each).
// Two leave errors of about 2^-18 of the summed terms, more than one bf16
// ulp of an output near zero; three match the plain f32 softmax.
constexpr int kParts = 3;

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16x16, row-major fragment) * b (16x8, column fragment), f32 acc.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i, and each lane receives (row 2*(lane%4) and +1, col lane/4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ seg, __nv_bfloat16* __restrict__ out,
                     int seq, int heads, float scale) {
  constexpr int kStride = D + 8;  // bf16 per shared row: 16 bytes of padding
  constexpr int kChunks = D / 16;  // k-steps of Q K^T
  constexpr int kDTiles = D / 8;   // 8-wide column tiles of O
  constexpr int kKeyTiles = kMmaKeys / 8;
  constexpr int kVecPerRow = D / 8;  // 16-byte vectors per K/V row
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaKeys][kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaKeys][kStride];
  __shared__ int segk[kMmaKeys];
  __shared__ int seg_range[2][2];  // min/max over the tile's keys, per warp

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

  int rows[2];
  rows[0] = blockIdx.x * kMmaRows + warp * 16 + g;
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

  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
  float l[2] = {0.f, 0.f};  // this thread's share of the running sum
  const float scale_log2 = scale * kLog2e;

  for (int k0 = 0; k0 < seq; k0 += kMmaKeys) {
    __syncthreads();  // the previous tile is no longer read
    int lo = INT_MAX;
    int hi = INT_MIN;
    if (tid < kMmaKeys) {
      const int kr = k0 + tid;
      int s = 0;
      if (kr < seq) {
        s = segb[kr];
        lo = hi = s;
      }
      segk[tid] = s;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0 && warp < 2) {
      seg_range[warp][0] = lo;
      seg_range[warp][1] = hi;
    }
    __syncthreads();
    lo = min(seg_range[0][0], seg_range[1][0]);
    hi = max(seg_range[0][1], seg_range[1][1]);
    // A key can share this row's segment only if the segment lies in the
    // tile's range; a tile no row of the block can use is not loaded.
    bool need = false;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      need |= live[r] && segq[r] >= lo && segq[r] <= hi;
    const bool warp_needs = __any_sync(0xffffffffu, need);
    if (!__syncthreads_or(need)) continue;

    for (int i = tid; i < kMmaKeys * kVecPerRow; i += kMmaThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;
      if (k0 + r < seq) {
        const long long off = base + (k0 + r) * tok + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vv;
    }
    __syncthreads();
    if (!warp_needs) continue;

    // S = Q K^T: tile j holds keys 8j..8j+7; s[j][0..1] are row g at keys
    // 8j+2t, 8j+2t+1 and s[j][2..3] the same keys for row g+8.
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const __nv_bfloat16* kp = &ks[8 * j + g][16 * c + 2 * t];
        mma_bf16(s[j], qf[c], ld_u32(kp), ld_u32(kp + 8));
      }
    }

    float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 8 * j + 2 * t + (i & 1);
        const int r = i >> 1;
        const bool allowed = (k0 + key < seq) && (segk[key] == segq[r]);
        s[j][i] = allowed ? s[j][i] * scale_log2 : -CUDART_INF_F;
        tile_max[r] = fmaxf(tile_max[r], s[j][i]);
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
      const float m_new = fmaxf(m[r], tile_max[r]);
      // no allowed key yet: keep everything at 0 instead of exp(-inf + inf)
      base_max[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2f(m[r] - base_max[r]);
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
      m[r] = m_new;
    }

    // O += P V, 16 keys per step: P's A fragment is the S fragments of key
    // tiles 2kc and 2kc+1, split into kParts bf16 terms.
#pragma unroll
    for (int kc = 0; kc < kKeyTiles / 2; ++kc) {
      uint32_t pf[kParts][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kc + (i >> 1);
        const int r = i & 1;
        float p0 = exp2f(s[j][2 * r] - base_max[r]);
        float p1 = exp2f(s[j][2 * r + 1] - base_max[r]);
        l[r] += p0 + p1;
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
          const float2 back = __bfloat1622float2(h2);
          pf[part][i] = *reinterpret_cast<const uint32_t*>(&h2);
          p0 -= back.x;  // exact: the remainder of a round to nearest
          p1 -= back.y;
        }
      }
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        // matrix i of the x4 load: keys 16kc + 8*(i&1) .., columns
        // 16dp + 8*(i>>1) ..; registers 0/1 feed column tile 2dp, 2/3 2dp+1
        const int mi = lane / 8;
        const __nv_bfloat16* vp =
            &vs[16 * kc + 8 * (mi & 1) + lane % 8][16 * dp + 8 * (mi >> 1)];
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vp);
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          mma_bf16(o[2 * dp], pf[part], vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pf[part], vf[2], vf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (!live[r]) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* op = out + base + rows[r] * tok + 2 * t;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      *reinterpret_cast<uint32_t*>(op + 8 * n) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kFmaRows = 64;  // queries per block, one per thread
constexpr int kFmaKeys = 32;  // keys per tile

template <int D>
__global__ void __launch_bounds__(kFmaRows)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     float* __restrict__ out, float* __restrict__ lse,
                     int seq, int heads, float scale) {
  __shared__ __align__(16) float ks[kFmaKeys][D];
  __shared__ __align__(16) float vs[kFmaKeys][D];
  __shared__ int segk[kFmaKeys];
  constexpr int kVecPerRow = D / 4;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kFmaRows + tid;
  const bool live = row < seq;
  const long long tok = static_cast<long long>(heads) * D;
  const long long base = static_cast<long long>(b) * seq * tok +
                         static_cast<long long>(h) * D;

  float qr[D];
  float acc[D];
  int segq = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (live) {
    const float* qp = q + base + row * tok;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qp[d];
    segq = seg[static_cast<long long>(b) * seq + row];
  }
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kFmaKeys) {
    __syncthreads();  // the previous tile is no longer read
    if (tid < kFmaKeys) {
      const int kr = k0 + tid;
      segk[tid] = kr < seq ? seg[static_cast<long long>(b) * seq + kr] : 0;
    }
    __syncthreads();
    // A tile in which no key shares this query's segment changes nothing;
    // a tile no query of the block needs is not even loaded.
    bool any = false;
#pragma unroll
    for (int j = 0; j < kFmaKeys; ++j)
      any |= live && (k0 + j < seq) && (segk[j] == segq);
    if (!__syncthreads_or(any)) continue;

    for (int i = tid; i < kFmaKeys * kVecPerRow; i += kFmaRows) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 4;
      const int kr = k0 + r;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (kr < seq) {
        const long long off = base + kr * tok + c;
        kk = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(&ks[r][c]) = kk;
      *reinterpret_cast<float4*>(&vs[r][c]) = vv;
    }
    __syncthreads();
    if (!any) continue;

    // The outer loop runs over the head dimension, so the tile's keys
    // accumulate as independent FMA chains (one chain per key would
    // serialise on the FMA latency).
    float s[kFmaKeys];
#pragma unroll
    for (int j = 0; j < kFmaKeys; ++j) s[j] = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
#pragma unroll
      for (int j = 0; j < kFmaKeys; ++j) {
        const float4 kk = reinterpret_cast<const float4*>(ks[j])[d4];
        s[j] = fmaf(qr[4 * d4 + 0], kk.x, s[j]);
        s[j] = fmaf(qr[4 * d4 + 1], kk.y, s[j]);
        s[j] = fmaf(qr[4 * d4 + 2], kk.z, s[j]);
        s[j] = fmaf(qr[4 * d4 + 3], kk.w, s[j]);
      }
    }
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kFmaKeys; ++j) {
      const bool allowed = (k0 + j < seq) && (segk[j] == segq);
      s[j] = allowed ? s[j] * scale : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);  // finite: some key is allowed
    const float alpha = expf(m - m_new);      // 0 when m is still -inf
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kFmaKeys; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for masked keys
      l += p;
      const float4* vp = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vp[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }

  if (live) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* op = out + base + row * tok;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] * inv;
    // a live row always sees its own key, so l > 0 and lse is finite
    if (lse != nullptr)
      lse[(static_cast<long long>(b) * heads + h) * seq + row] = m + logf(l);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const void* seg,
            void* out, void* lse, int batch, int seq, int heads, float scale,
            int dtype, cudaStream_t stream) {
  const int* sg = static_cast<const int*>(seg);
  if (dtype == 1) {
    const dim3 grid((seq + kMmaRows - 1) / kMmaRows, heads, batch);
    flash_fwd_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), sg,
        static_cast<__nv_bfloat16*>(out), seq, heads, scale);
  } else {
    const dim3 grid((seq + kFmaRows - 1) / kFmaRows, heads, batch);
    flash_fwd_fma_kernel<D><<<grid, kFmaRows, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), sg, static_cast<float*>(out),
        static_cast<float*>(lse), seq, heads, scale);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 16, 32 or 64. lse: null, or
// [B, H, T] f32 for the backward (float32 only). Returns a cudaError_t
// (0 = launched).
extern "C" int convdr_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* seg,
                                          void* out, void* lse, int batch,
                                          int seq, int heads, int head_dim,
                                          float scale, int dtype,
                                          void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      launch<16>(q, k, v, seg, out, lse, batch, seq, heads, scale, dtype, s);
      break;
    case 32:
      launch<32>(q, k, v, seg, out, lse, batch, seq, heads, scale, dtype, s);
      break;
    case 64:
      launch<64>(q, k, v, seg, out, lse, batch, seq, heads, scale, dtype, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
