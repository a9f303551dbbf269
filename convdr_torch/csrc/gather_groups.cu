// Candidate group gather out of a score block, for Hopper (sm_90a).
//
// Replaces: convdr_tpu/ops/pallas_search.py:256-346, `dma_gather_groups`
// (kernel `_dma_gather_kernel` at :234-250), the JAX package's opt-in
// `gather="dma"` (ops/exact_search.py:182-200). Here it is the candidate
// gather of every exact search on the card.
//
// Computes out[q, j, c] = scores[q, g * G + c] for g = gsel[q, j]: the
// [Q, K, G] candidate groups of a [Q, B] f32 score block. The TPU kernel
// DMAs the containing (8, 128) tile of every candidate and slices the
// group out afterwards, because Mosaic cannot slice below that tiling;
// here any G that divides B works. A group id outside [0, B / G) yields
// NaN rather than a read outside the block.
//
// What bounds it on an H100: bytes. It moves Q * K * G * 4 bytes each way
// (13.2 MB in all at Q=512, K=101, G=32: ~4 us at 3.35 TB/s) plus the ids,
// and does no arithmetic. At that size what costs is latency: the id, then
// the group, are two dependent loads. So the main kernel:
//   * copies 16 bytes a lane (float4): a group of G floats is G/4 lanes.
//     Every G of the search (fused_search.GROUPS: 8 to 128) is a multiple
//     of 4 floats, G=8 being 32 bytes, so groups start on 16-byte
//     boundaries when the block's rows do;
//   * has one lane of each group load its id, turn it into the group's
//     offset (one 32-bit division by K a group, none by value), and hand
//     the offset to the group's other lanes by a warp shuffle: G/4 divides
//     32, so a warp's 32 consecutive vectors hold whole groups;
//   * gives each lane 4 vectors, 32 apart, whose id loads and then whose
//     16-byte loads are all issued before the first store, so ~50 KB are
//     in flight on each SM at the search's size.
// A `scores` view that is not 16-byte aligned, a G that is not a multiple
// of 4 or a G/4 that does not divide 32 takes the scalar kernel: one value
// a thread, the id loaded by each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 16-byte vectors a lane

// gv = G / 4 vectors a group, a power of two <= 32 (gv_shift its log2);
// b4 = B / 4 vectors a row. total_vec < 2^31.
template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_groups_vec_kernel(const float4* __restrict__ scores,
                         const I* __restrict__ gsel, float4* __restrict__ out,
                         unsigned int total_vec, int gv_shift, int b4, int k,
                         long long n_groups) {
  const int lane = threadIdx.x % 32;
  const unsigned int base =
      (blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * (32u * kVecs);
  const unsigned int gv_mask = (1u << gv_shift) - 1;
  const int c4 = static_cast<int>(lane & gv_mask);  // vector within group
  const int leader = lane - c4;
  long long off[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const unsigned int v = base + u * 32u + lane;
    off[u] = -1;
    if (c4 == 0 && v < total_vec) {
      const unsigned int slot = v >> gv_shift;  // q * k + j
      const long long g = static_cast<long long>(gsel[slot]);
      if (g >= 0 && g < n_groups)
        off[u] = static_cast<long long>(slot / k) * b4 + (g << gv_shift);
    }
  }
  float4 val[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const long long o = __shfl_sync(0xffffffffu, off[u], leader);
    const float nan = __int_as_float(0x7fc00000);
    val[u] = o >= 0 ? scores[o + c4] : make_float4(nan, nan, nan, nan);
  }
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const unsigned int v = base + u * 32u + lane;
    if (v < total_vec) out[v] = val[u];
  }
}

// The scalar path: one value a thread. N is the type of the flat element
// index: 32-bit when the output has fewer than 2^31 values.
template <typename I, typename N>
__global__ void __launch_bounds__(kThreads)
gather_groups_kernel(const float* __restrict__ scores,
                     const I* __restrict__ gsel, float* __restrict__ out,
                     N total, int b, int k, int group) {
  const long long n_groups = b / group;
  for (N i = blockIdx.x * static_cast<N>(kThreads) + threadIdx.x; i < total;
       i += static_cast<N>(gridDim.x) * kThreads) {
    const N slot = i / group;  // q * k + j
    const int c = static_cast<int>(i - slot * group);
    const long long g = static_cast<long long>(gsel[slot]);
    const long long row = slot / k;
    out[i] = (g >= 0 && g < n_groups)
                 ? scores[row * b + g * group + c]
                 : __int_as_float(0x7fc00000);
  }
}

// Which kernel a call takes and its grid.
struct Plan {
  bool vec;
  int blocks;
  int shift;  // log2(G / 4), vector path
};

Plan plan(const void* sc, const void* o, long long total, int group) {
  const int gv = group / 4;
  Plan pl{};
  pl.vec = group % 4 == 0 && (gv & (gv - 1)) == 0 && gv <= 32 &&
           reinterpret_cast<uintptr_t>(sc) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(o) % 16 == 0 && total < (1LL << 31);
  if (pl.vec) {
    const long long per_block = kThreads * kVecs * 4;  // values a block
    pl.blocks = static_cast<int>((total + per_block - 1) / per_block);
    while ((1 << pl.shift) < gv) ++pl.shift;
  } else {
    const long long want = (total + kThreads - 1) / kThreads;
    pl.blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  }
  return pl;
}

template <typename I>
void launch(const float* sc, const I* ids, float* o, long long total, int b,
            int k, int group, cudaStream_t s) {
  const Plan pl = plan(sc, o, total, group);
  if (pl.vec) {
    gather_groups_vec_kernel<I><<<pl.blocks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(sc), ids, reinterpret_cast<float4*>(o),
        static_cast<unsigned int>(total / 4), pl.shift, b / 4, k,
        static_cast<long long>(b / group));
  } else if (total < (1LL << 31)) {
    gather_groups_kernel<I, unsigned int><<<pl.blocks, kThreads, 0, s>>>(
        sc, ids, o, static_cast<unsigned int>(total), b, k, group);
  } else {
    gather_groups_kernel<I, long long><<<pl.blocks, kThreads, 0, s>>>(
        sc, ids, o, total, b, k, group);
  }
}

}  // namespace

// scores f32 [nq, b]; gsel [nq, k] (idx_bytes 4 = int32, 8 = int64);
// out f32 [nq, k, group]; b % group == 0. Returns a cudaError_t.
extern "C" int convdr_gather_groups(const void* scores, const void* gsel,
                                    void* out, int nq, int b, int k,
                                    int group, int idx_bytes, void* stream) {
  if (nq <= 0 || b <= 0 || k <= 0 || group <= 0 || b % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(nq) * k * group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scores);
  float* o = static_cast<float*>(out);
  if (idx_bytes == 4) {
    launch(sc, static_cast<const int*>(gsel), o, total, b, k, group, s);
  } else if (idx_bytes == 8) {
    launch(sc, static_cast<const long long*>(gsel), o, total, b, k, group, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch a call with these operands takes: out[0] 1 for the 16-byte
// vector kernel, 0 for the scalar one; out[1] threads a block; out[2]
// blocks; out[3] values a thread (the scalar kernel's grid strides).
extern "C" int convdr_gather_groups_config(const void* scores, const void* out,
                                           int nq, int b, int k, int group,
                                           int* cfg) {
  if (nq <= 0 || b <= 0 || k <= 0 || group <= 0 || b % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(nq) * k * group;
  const Plan pl = plan(scores, out, total, group);
  cfg[0] = pl.vec ? 1 : 0;
  cfg[1] = kThreads;
  cfg[2] = pl.blocks;
  cfg[3] = pl.vec ? kVecs * 4
                  : static_cast<int>((total + static_cast<long long>(pl.blocks) *
                                                  kThreads - 1) /
                                     (static_cast<long long>(pl.blocks) * kThreads));
  return 0;
}
