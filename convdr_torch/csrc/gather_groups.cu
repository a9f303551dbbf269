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
// here one thread copies one value, so neighbouring threads read the
// neighbouring values of one group and write them contiguously, and any G
// that divides B works. A group id outside [0, B / G) yields NaN rather
// than a read outside the block.
//
// What bounds it on an H100: bytes. It moves Q * K * G * 4 bytes each way
// (13.2 MB in all at Q=512, K=101, G=32: ~4 us at 3.35 TB/s) plus the ids, and
// does no arithmetic; at that size the launch and the latency of one
// dependent load (the id, then the group) dominate, which the grid-stride
// loop over ~1.6M values hides across 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// N is the type of the flat element index: 32-bit when the output has
// fewer than 2^31 values (the search's case), so the two divisions per
// value are not 64-bit ones.
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

template <typename I>
void launch(const float* sc, const I* ids, float* o, long long total, int b,
            int k, int group, int blocks, cudaStream_t s) {
  if (total < (1LL << 31)) {
    gather_groups_kernel<I, unsigned int><<<blocks, kThreads, 0, s>>>(
        sc, ids, o, static_cast<unsigned int>(total), b, k, group);
  } else {
    gather_groups_kernel<I, long long><<<blocks, kThreads, 0, s>>>(
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
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scores);
  float* o = static_cast<float*>(out);
  if (idx_bytes == 4) {
    launch(sc, static_cast<const int*>(gsel), o, total, b, k, group, blocks, s);
  } else if (idx_bytes == 8) {
    launch(sc, static_cast<const long long*>(gsel), o, total, b, k, group,
           blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
