// Pass B of the streaming exact search, for Hopper (sm_90a): the scores of
// the selected passage groups only.
//
// Replaces: convdr_tpu/ops/pallas_search.py:462-522,
// `extract_candidate_scores` (kernel `_extract_candidates_kernel` at
// :419-455). Pass A is convdr_streaming_groupmax in scores_groupmax.cu.
//
// Computes cand[s, r] = <q[s / kg], p[g * G + r]> for every slot
// s = query * kg + j of gsel [Q, kg] (g = gsel[query, j]) and r < G: the
// [Q, kg, G] scores of the groups each query selected, and nothing else.
// The TPU kernel recomputes whole passage tiles for every query tile and
// scatters the selected groups through a one-hot matmul; here only the
// selected rows are scored.
//
// Exactness: with f32 and bf16 passages each score is one sequential
// fmaf(q, p, acc) chain over k = 0..D-1 from 0, zero padding only after the
// last k, which is the order of every f32 and bf16 output of kernel 2
// (scores_groupmax.cu). With int8 passages the queries are the int-valued
// ones of quantize_queries, taken as int8 as kernel 2 takes them, and the
// sums are int32 dp4a sums: exact integers below 2^24 (D <= 1040), so equal
// to kernel 2's tensor-core integer sums whatever their order. So each
// candidate score is bit-identical to kernel 2's score of that (query, row),
// and pass A's group maxima are exactly the maxima of these scores: group
// pruning stays exact. Hence no split-K, no reordering of k and no
// tensor-core path for f32 or bf16 here.
//
// What bounds it on an H100: bytes. The selected groups' rows are read once
// (up to N * D * 4 bytes, 1.6 GB at N=524288, D=768 f32 when every group
// is picked: ~0.48 ms at 3.35 TB/s) and the [Q, kg, G] scores written once,
// against 2 * Q * kg * G * D operations (10.2 GFLOP at Q=512, kg=101,
// G=128: ~0.15 ms at 67 TFLOP/s f32): about 3 FMAs a byte. The design:
//   * A work list built on the device by a counting sort, with no host
//     sync: slots counted by group (atomics), one block scans the counts
//     into each group's first sorted slot and cuts each group into items
//     of at most kTM = 16 slots, and the slots are scattered into group
//     order. A group picked by many queries is split into several items,
//     which run side by side on neighbouring blocks and share its rows
//     through L2; a group nobody picked has no item and costs nothing.
//     Slot ids out of [0, n_groups) are left out (the public entry raises
//     on them afterwards), so nothing reads outside the passages.
//   * A persistent grid of as many blocks as fit on the SMs walks the item
//     list, whose length it reads on the device. A block's items and their
//     k-chunks form one sequence of steps, so the ring below runs on from
//     one item into the next without draining. The item being loaded and
//     the query row of each query chunk a thread copies sit in registers,
//     and the next item's descriptor is read an item ahead: no step waits
//     on a dependent load of the list (read every step, those loads made
//     the arithmetic alone about a quarter slower in a first version).
//   * A ring of 16-byte cp.async.cg copies: each stage holds the item's G
//     passage rows x one k-chunk (64 f32, 64 bf16 or 128 int8 k, raw,
//     widened in registers; 2, 3 and 2 stages) and its slots' query rows x
//     the same k-chunk, gathered by slot (int8 queries as int8).
//   * Register tiles: each of the 4 warps owns 4 slots and all G rows; a
//     lane owns 4 slots x G/32 rows (G >= 32), or 2 x 1 (G=16) or 1 x 1
//     (G=8). A warp whose slots are all padding skips the arithmetic: an
//     item of c slots costs FMAs for c rounded up to 4 and no bytes for the
//     rest (the Q=64 case has ~1.6 slots a picked group). At G=128 f32 a
//     lane reads 4 passage and 4 query 16-byte vectors from shared memory
//     per 64 FMAs; a quarter warp reads 8 consecutive rows, on distinct
//     banks, and query vectors are warp broadcasts. int8 takes 4 k a dp4a.
// Rows whose pitch is not a multiple of 16 bytes (D % 4 f32, D % 8 bf16,
// D % 16 int8), or operands that are not 16-byte aligned, take a scalar
// loader into the same ring (element loads, synchronous); the arithmetic
// is the same.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 16;                     // slots an item
constexpr int kWarpSlots = kTM / kWarps;    // 4 slots a warp
constexpr int kMaxDevices = 64;
constexpr int kListThreads = 256;           // count and scatter kernels
constexpr int kPlanThreads = 1024;          // the one-block scan

// ---------------------------------------------------------------------------
// the work list
// ---------------------------------------------------------------------------
// Workspace (int32): counts [n_groups] | cursor [n_groups] | slots [S] |
// items [max_items][3] | n_items [1], S = nq * kg.
struct Workspace {
  int* counts;
  int* cursor;
  int* slots;
  int* items;
  int* n_items;
};

Workspace carve(void* ws, int n_groups, long long s_total, int max_items) {
  int* w = static_cast<int*>(ws);
  Workspace out;
  out.counts = w;
  out.cursor = w + n_groups;
  out.slots = out.cursor + n_groups;
  out.items = out.slots + s_total;
  out.n_items = out.items + 3LL * max_items;
  return out;
}

template <typename I>
__global__ void __launch_bounds__(kListThreads)
count_groups_kernel(const I* __restrict__ gsel, int s_total, int n_groups,
                    int* __restrict__ counts) {
  for (int s = blockIdx.x * kListThreads + threadIdx.x; s < s_total;
       s += gridDim.x * kListThreads) {
    const long long g = static_cast<long long>(gsel[s]);
    if (g >= 0 && g < n_groups) atomicAdd(counts + g, 1);
  }
}

// Block-wide exclusive scan of one int a thread; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kPlanThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;  // inclusive sums of the warps
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[kPlanThreads / 32 - 1];
  __syncthreads();  // warp_sums is reused by the caller's next scan
  return before;
}

// One block: each thread takes a run of groups, the block scans the runs'
// slot and item counts, and each thread writes its groups' first sorted
// slot (cursor, for the scatter) and their items.
__global__ void __launch_bounds__(kPlanThreads)
plan_items_kernel(const int* __restrict__ counts, int n_groups,
                  int* __restrict__ cursor, int* __restrict__ items,
                  int* __restrict__ n_items) {
  __shared__ int warp_sums[32];
  const int per = (n_groups + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n_groups);
  const int hi = min(lo + per, n_groups);
  int slots = 0, its = 0;
  for (int g = lo; g < hi; ++g) {
    const int c = counts[g];
    slots += c;
    its += (c + kTM - 1) / kTM;
  }
  int total_slots, total_items;
  int slot = block_exclusive_scan(slots, warp_sums, &total_slots);
  int item = block_exclusive_scan(its, warp_sums, &total_items);
  for (int g = lo; g < hi; ++g) {
    const int c = counts[g];
    cursor[g] = slot;
    for (int first = 0; first < c; first += kTM, ++item) {
      items[3 * item] = g;
      items[3 * item + 1] = slot + first;
      items[3 * item + 2] = min(kTM, c - first);
    }
    slot += c;
  }
  if (threadIdx.x == 0) *n_items = total_items;
}

template <typename I>
__global__ void __launch_bounds__(kListThreads)
scatter_slots_kernel(const I* __restrict__ gsel, int s_total, int n_groups,
                     int* __restrict__ cursor, int* __restrict__ slots) {
  for (int s = blockIdx.x * kListThreads + threadIdx.x; s < s_total;
       s += gridDim.x * kListThreads) {
    const long long g = static_cast<long long>(gsel[s]);
    if (g >= 0 && g < n_groups) slots[atomicAdd(cursor + g, 1)] = s;
  }
}

template <typename I>
cudaError_t build_list(const I* gsel, const Workspace& w, int s_total,
                       int n_groups, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(w.counts, 0, sizeof(int) * n_groups, s);
  if (err != cudaSuccess) return err;
  const int want = (s_total + kListThreads - 1) / kListThreads;
  const int blocks = want < 1024 ? want : 1024;
  count_groups_kernel<I><<<blocks, kListThreads, 0, s>>>(gsel, s_total, n_groups,
                                                          w.counts);
  plan_items_kernel<<<1, kPlanThreads, 0, s>>>(w.counts, n_groups, w.cursor,
                                                w.items, w.n_items);
  scatter_slots_kernel<I><<<blocks, kListThreads, 0, s>>>(gsel, s_total, n_groups,
                                                           w.cursor, w.slots);
  return cudaGetLastError();
}

cudaError_t build_list_any(const void* gsel, int idx_bytes, const Workspace& w,
                           int s_total, int n_groups, cudaStream_t s) {
  if (idx_bytes == 4)
    return build_list(static_cast<const int*>(gsel), w, s_total, n_groups, s);
  if (idx_bytes == 8)
    return build_list(static_cast<const long long*>(gsel), w, s_total, n_groups, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the scoring kernel
// ---------------------------------------------------------------------------
// Per passage type: Q the query element type as the kernel takes it,
// elements a 16-byte vector of P, k a stage, the shared row pitches (in
// elements) of the passage and query tiles, and the ring's stages. Longer
// row chunks a stage (256 bytes of an f32 row, 128 of a bf16 or int8 row)
// read faster on the card than 128 or 64 bytes, even at 2 stages and 2
// blocks an SM; pitches of 272 and 144 bytes put the 8 rows a quarter warp
// reads on distinct banks.
template <typename P>
struct Tile;
template <>
struct Tile<float> {
  using Q = float;
  static constexpr int kVec = 4, kKC = 64, kPitch = 68, kQPitch = 68, kStages = 2;
};
template <>
struct Tile<__nv_bfloat16> {
  using Q = float;
  static constexpr int kVec = 8, kKC = 64, kPitch = 72, kQPitch = 68, kStages = 3;
};
template <>
struct Tile<signed char> {
  using Q = signed char;
  static constexpr int kVec = 16, kKC = 128, kPitch = 144, kQPitch = 144, kStages = 2;
};

// Elements 4j .. 4j+3 of a raw 16-byte vector of P, widened exactly.
__device__ __forceinline__ float4 widen(const uint4& v, int, float) {
  return make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                     __uint_as_float(v.z), __uint_as_float(v.w));
}
__device__ __forceinline__ float4 widen(const uint4& v, int j, __nv_bfloat16) {
  const uint32_t a = j == 0 ? v.x : v.z;
  const uint32_t b = j == 0 ? v.y : v.w;
  return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
}

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with pred false nothing is read and the
// 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename P, int G>
struct Shape {
  using T = Tile<P>;
  static constexpr int kRT = G >= 32 ? G / 32 : 1;  // rows a lane
  static constexpr int kLR = G / kRT;               // lanes along rows
  static constexpr int kSL = 32 / kLR;              // slot lanes a warp
  static constexpr int kTS = kWarpSlots / kSL;      // slots a lane
  static constexpr int kPBytes = G * T::kPitch * static_cast<int>(sizeof(P));
  static constexpr int kStageBytes =
      kPBytes + kTM * T::kQPitch * static_cast<int>(sizeof(typename T::Q));
  // the ring, then each stage's (first slot, slot count)
  static constexpr int kSmem = T::kStages * (kStageBytes + 2 * 4);
  static_assert(kTS >= 1 && kSL * kTS == kWarpSlots, "4 slots a warp");
  static_assert(kPBytes % 16 == 0 && kStageBytes % 16 == 0, "16-byte tiles");
};

// The query tile's 16-byte chunks (vector path): elements a chunk, chunks a
// row, and chunks a thread copies each stage.
template <typename P>
struct QueryChunks {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(typename Tile<P>::Q));
  static constexpr int kRow = Tile<P>::kKC / kVec;
  static constexpr int kPer = (kTM * kRow + kThreads - 1) / kThreads;
};

// An item as the load stream holds it: its group, first sorted slot and
// slot count, and the query row of each query chunk this thread copies
// (-1 for a padding slot), read once an item.
template <typename P>
struct Item {
  int g, first, cnt;
  long long qrow[QueryChunks<P>::kPer];
};

// One item's data for one k-chunk into ring stage `st`. Query rows of the
// item's padding slots are left as they are: their sums are never stored.
template <typename P, int G>
__device__ __forceinline__ void load_stage(
    unsigned char* st, const typename Tile<P>::Q* __restrict__ q,
    const P* __restrict__ p, const int* __restrict__ slots, const Item<P>& it,
    int k0, int d, int kg, bool vec, int tid) {
  using T = Tile<P>;
  using Q = typename T::Q;
  P* ps = reinterpret_cast<P*>(st);
  Q* qs = reinterpret_cast<Q*>(st + Shape<P, G>::kPBytes);
  const P* prow = p + static_cast<long long>(it.g) * G * d;
  if (vec) {
    constexpr int kCh = T::kKC / T::kVec;  // 16-byte chunks a passage row
    constexpr int kPer = (G * kCh + kThreads - 1) / kThreads;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kThreads;
      if (G * kCh % kThreads == 0 || c < G * kCh) {
        const int r = c / kCh;
        const int gk = k0 + (c % kCh) * T::kVec;
        const bool ok = gk < d;
        cp_async16(ps + r * T::kPitch + (c % kCh) * T::kVec,
                   ok ? prow + static_cast<long long>(r) * d + gk : p, ok);
      }
    }
    constexpr int kQVec = QueryChunks<P>::kVec;
    constexpr int kQCh = QueryChunks<P>::kRow;
#pragma unroll
    for (int i = 0; i < QueryChunks<P>::kPer; ++i) {
      const int c = tid + i * kThreads;
      if (it.qrow[i] >= 0) {
        const int gk = k0 + (c % kQCh) * kQVec;
        const bool ok = gk < d;
        cp_async16(qs + (c / kQCh) * T::kQPitch + (c % kQCh) * kQVec,
                   ok ? q + it.qrow[i] * d + gk : q, ok);
      }
    }
  } else {
    for (int c = tid; c < G * T::kKC; c += kThreads) {
      const int r = c / T::kKC;
      const int gk = k0 + c % T::kKC;
      ps[r * T::kPitch + c % T::kKC] =
          gk < d ? prow[static_cast<long long>(r) * d + gk] : zero<P>();
    }
    for (int c = tid; c < kTM * T::kKC; c += kThreads) {
      const int m = c / T::kKC;
      if (m < it.cnt) {
        const int gk = k0 + c % T::kKC;
        const long long row = slots[it.first + m] / kg;
        qs[m * T::kQPitch + c % T::kKC] = gk < d ? q[row * d + gk] : zero<Q>();
      }
    }
  }
}

// One stage's arithmetic for a lane's kTS x kRT tile: f32 FMAs in k order
// (f32, bf16), or dp4a int32 sums (int8).
template <typename P, int G, typename Acc>
__device__ __forceinline__ void compute_stage(
    const unsigned char* st, int lr, int m0,
    Acc (&acc)[Shape<P, G>::kTS][Shape<P, G>::kRT]) {
  using S = Shape<P, G>;
  using T = Tile<P>;
  using Q = typename T::Q;
  const P* ps = reinterpret_cast<const P*>(st);
  const Q* qs = reinterpret_cast<const Q*>(st + S::kPBytes);
#pragma unroll
  for (int kv = 0; kv < T::kKC; kv += T::kVec) {
    uint4 praw[S::kRT];
#pragma unroll
    for (int r = 0; r < S::kRT; ++r)
      praw[r] = *reinterpret_cast<const uint4*>(ps + (lr + S::kLR * r) * T::kPitch + kv);
    if constexpr (std::is_same<P, signed char>::value) {
      uint4 qraw[S::kTS];
#pragma unroll
      for (int s = 0; s < S::kTS; ++s)
        qraw[s] = *reinterpret_cast<const uint4*>(qs + (m0 + s) * T::kQPitch + kv);
#pragma unroll
      for (int s = 0; s < S::kTS; ++s)
#pragma unroll
        for (int r = 0; r < S::kRT; ++r) {
          int a = acc[s][r];
          a = __dp4a(static_cast<int>(qraw[s].x), static_cast<int>(praw[r].x), a);
          a = __dp4a(static_cast<int>(qraw[s].y), static_cast<int>(praw[r].y), a);
          a = __dp4a(static_cast<int>(qraw[s].z), static_cast<int>(praw[r].z), a);
          acc[s][r] = __dp4a(static_cast<int>(qraw[s].w), static_cast<int>(praw[r].w), a);
        }
    } else {
#pragma unroll
      for (int j = 0; j < T::kVec / 4; ++j) {
        float4 qv[S::kTS];
        float4 pv[S::kRT];
#pragma unroll
        for (int s = 0; s < S::kTS; ++s)
          qv[s] = *reinterpret_cast<const float4*>(qs + (m0 + s) * T::kQPitch + kv + 4 * j);
#pragma unroll
        for (int r = 0; r < S::kRT; ++r) pv[r] = widen(praw[r], j, P());
        // k = kv + 4j, +1, +2, +3 in order for every output
#pragma unroll
        for (int s = 0; s < S::kTS; ++s)
#pragma unroll
          for (int r = 0; r < S::kRT; ++r) acc[s][r] = fmaf(qv[s].x, pv[r].x, acc[s][r]);
#pragma unroll
        for (int s = 0; s < S::kTS; ++s)
#pragma unroll
          for (int r = 0; r < S::kRT; ++r) acc[s][r] = fmaf(qv[s].y, pv[r].y, acc[s][r]);
#pragma unroll
        for (int s = 0; s < S::kTS; ++s)
#pragma unroll
          for (int r = 0; r < S::kRT; ++r) acc[s][r] = fmaf(qv[s].z, pv[r].z, acc[s][r]);
#pragma unroll
        for (int s = 0; s < S::kTS; ++s)
#pragma unroll
          for (int r = 0; r < S::kRT; ++r) acc[s][r] = fmaf(qv[s].w, pv[r].w, acc[s][r]);
      }
    }
  }
}

template <typename P, int G>
__global__ void __launch_bounds__(kThreads)
extract_candidates_kernel(const typename Tile<P>::Q* __restrict__ q,
                          const P* __restrict__ p,
                          const int* __restrict__ slots,
                          const int* __restrict__ items,
                          const int* __restrict__ n_items_ptr,
                          float* __restrict__ cand, int d, int kg, int vec) {
  using T = Tile<P>;
  using S = Shape<P, G>;
  using Acc = typename std::conditional<std::is_same<P, signed char>::value, int,
                                        float>::type;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  int* header = reinterpret_cast<int*>(smem + kStages * S::kStageBytes);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int lr = lane % S::kLR;                             // first row
  const int m0 = (warp * S::kSL + lane / S::kLR) * S::kTS;  // first slot
  const int warp_m0 = warp * kWarpSlots;

  const int n_items = *n_items_ptr;
  const int nk = (d + T::kKC - 1) / T::kKC;
  const int bid = static_cast<int>(blockIdx.x);
  const int grid = static_cast<int>(gridDim.x);
  const int mine = n_items > bid ? (n_items - 1 - bid) / grid + 1 : 0;
  const int steps = mine * nk;

  // The load stream runs kStages - 1 steps ahead of the arithmetic. Its
  // item's descriptor and query rows sit in registers, and the next item's
  // descriptor is read a whole item ahead, so no step waits on them; each
  // stage carries (first, count) in `header` for the arithmetic.
  constexpr int kQCh = QueryChunks<P>::kRow;
  auto head = [&](int j, Item<P>& it) {
    const int* e = items + 3 * (bid + j * grid);
    it.g = e[0];
    it.first = e[1];
    it.cnt = e[2];
  };
  auto rows = [&](Item<P>& it) {
#pragma unroll
    for (int i = 0; i < QueryChunks<P>::kPer; ++i) {
      const int m = (tid + i * kThreads) / kQCh;
      it.qrow[i] = m < kTM && m < it.cnt ? slots[it.first + m] / kg : -1;
    }
  };
  Item<P> cur{}, nxt{};
  int lj = 0, lkc = 0;  // the load stream's item and k-chunk
  if (mine > 0) {
    head(0, cur);
    rows(cur);
  }
  if (mine > 1) head(1, nxt);
  auto load_next = [&](int stage) {
    load_stage<P, G>(smem + stage * S::kStageBytes, q, p, slots, cur, lkc * T::kKC,
                     d, kg, vec != 0, tid);
    if (tid == 0) {
      header[2 * stage] = cur.first;
      header[2 * stage + 1] = cur.cnt;
    }
    if (++lkc == nk) {
      lkc = 0;
      if (++lj < mine) {
        cur = nxt;
        rows(cur);
        if (lj + 1 < mine) head(lj + 1, nxt);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) load_next(t);
    cp_async_commit();
  }

  Acc acc[S::kTS][S::kRT];
  int out_slot[S::kTS];
  int kc = 0;  // the arithmetic's k-chunk
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed; stage t-1 is free for step t+2
    if (t + kStages - 1 < steps) load_next((t + kStages - 1) % kStages);
    cp_async_commit();

    const int stage = t % kStages;
    const int cnt = header[2 * stage + 1];
    if (kc == 0) {
#pragma unroll
      for (int s = 0; s < S::kTS; ++s) {
#pragma unroll
        for (int r = 0; r < S::kRT; ++r) acc[s][r] = Acc(0);
        // the output slots, read now and used after the item's last k-chunk
        out_slot[s] = m0 + s < cnt ? slots[header[2 * stage] + m0 + s] : -1;
      }
    }
    if (warp_m0 < cnt) {  // warp-uniform: skip a warp of padding slots
      compute_stage<P, G, Acc>(smem + stage * S::kStageBytes, lr, m0, acc);
      if (kc == nk - 1) {
#pragma unroll
        for (int s = 0; s < S::kTS; ++s) {
          if (out_slot[s] >= 0) {
            float* out = cand + static_cast<long long>(out_slot[s]) * G;
#pragma unroll
            for (int r = 0; r < S::kRT; ++r)
              out[lr + S::kLR * r] = static_cast<float>(acc[s][r]);
          }
        }
      }
    }
    if (++kc == nk) kc = 0;
  }
}

struct Config {
  int smem;
  int blocks_per_sm;
  int sms;
};

// The launch configuration of one instantiation on the current device; the
// shared-memory attribute is set and the occupancy read once a device.
template <typename P, int G>
cudaError_t config(Config* cfg) {
  static int per_sm[kMaxDevices];
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  cfg->smem = Shape<P, G>::kSmem;
  if (per_sm[dev] == 0) {
    auto fn = extract_candidates_kernel<P, G>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cfg->smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, cfg->smem);
    if (err != cudaSuccess) return err;
    if (n <= 0) return cudaErrorInvalidConfiguration;
    per_sm[dev] = n;
  }
  cfg->blocks_per_sm = per_sm[dev];
  cfg->sms = sms[dev];
  return cudaSuccess;
}

struct Args {
  const void* q;
  const void* p;
  Workspace w;
  float* cand;
  int max_items;
  int d;
  int kg;
  cudaStream_t s;
};

template <typename P, int G>
cudaError_t launch(const Args& a) {
  using Q = typename Tile<P>::Q;
  Config cfg;
  cudaError_t err = config<P, G>(&cfg);
  if (err != cudaSuccess) return err;
  const bool vec = a.d % Tile<P>::kVec == 0 &&
                   reinterpret_cast<uintptr_t>(a.q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.p) % 16 == 0;
  const long long fit = static_cast<long long>(cfg.sms) * cfg.blocks_per_sm;
  const int blocks = static_cast<int>(a.max_items < fit ? a.max_items : fit);
  extract_candidates_kernel<P, G><<<blocks, kThreads, cfg.smem, a.s>>>(
      static_cast<const Q*>(a.q), static_cast<const P*>(a.p), a.w.slots, a.w.items,
      a.w.n_items, a.cand, a.d, a.kg, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename P>
cudaError_t dispatch(int group, const Args& a) {
  switch (group) {
    case 8: return launch<P, 8>(a);
    case 16: return launch<P, 16>(a);
    case 32: return launch<P, 32>(a);
    case 64: return launch<P, 64>(a);
    case 128: return launch<P, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename P>
cudaError_t config_of(int group, Config* cfg) {
  switch (group) {
    case 8: return config<P, 8>(cfg);
    case 16: return config<P, 16>(cfg);
    case 32: return config<P, 32>(cfg);
    case 64: return config<P, 64>(cfg);
    case 128: return config<P, 128>(cfg);
    default: return cudaErrorInvalidValue;
  }
}

bool list_args_ok(int nq, int kg, int n_groups, int max_items) {
  const long long s_total = static_cast<long long>(nq) * kg;
  const long long bound = (s_total < n_groups ? s_total : n_groups) + s_total / kTM;
  return nq > 0 && kg > 0 && n_groups > 0 && s_total < (1LL << 31) &&
         max_items >= bound;
}

}  // namespace

// The work list alone, into `ws` (int32, 2 * n_groups + nq * kg +
// 3 * max_items + 1 values; layout in `carve`): gsel [nq, kg] (idx_bytes
// 4 = int32, 8 = int64); max_items >= min(n_groups, nq * kg) +
// nq * kg / 16. Returns a cudaError_t.
extern "C" int convdr_candidate_work_list(const void* gsel, int idx_bytes, void* ws,
                                          int nq, int kg, int n_groups,
                                          int max_items, void* stream) {
  if (!list_args_ok(nq, kg, n_groups, max_items))
    return static_cast<int>(cudaErrorInvalidValue);
  const Workspace w = carve(ws, n_groups, static_cast<long long>(nq) * kg, max_items);
  return static_cast<int>(build_list_any(gsel, idx_bytes, w, nq * kg, n_groups,
                                         static_cast<cudaStream_t>(stream)));
}

// The work list, then the scores: q [nq, d], f32 for p_dtype 0 (float32)
// and 1 (bfloat16), int8 for 2 (int8); p [n_groups * group, d]; gsel and
// ws as above; cand f32 [nq, kg, group]. group in {8, 16, 32, 64, 128}.
// Returns a cudaError_t (0 = launched).
extern "C" int convdr_extract_candidates(const void* q, const void* p,
                                         const void* gsel, int idx_bytes,
                                         void* ws, void* cand, int nq, int kg,
                                         int n_groups, int max_items, int d,
                                         int group, int p_dtype, void* stream) {
  if (!list_args_ok(nq, kg, n_groups, max_items) || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p_dtype < 0 || p_dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long s_total = static_cast<long long>(nq) * kg;
  const Args a{q, p, carve(ws, n_groups, s_total, max_items),
               static_cast<float*>(cand), max_items, d, kg,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = build_list_any(gsel, idx_bytes, a.w, static_cast<int>(s_total),
                                   n_groups, a.s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p_dtype == 0)
    err = dispatch<float>(group, a);
  else if (p_dtype == 1)
    err = dispatch<__nv_bfloat16>(group, a);
  else
    err = dispatch<signed char>(group, a);
  return static_cast<int>(err);
}

// The launch configuration for (p_dtype, group) on the current device:
// out[0] threads a block, out[1] dynamic shared memory bytes, out[2] slots
// an item, out[3] resident blocks an SM, out[4] SMs (the persistent grid is
// out[3] * out[4] blocks at most). Returns a cudaError_t.
extern "C" int convdr_extract_candidates_config(int p_dtype, int group, int* out) {
  Config cfg{};
  cudaError_t err;
  if (p_dtype == 0)
    err = config_of<float>(group, &cfg);
  else if (p_dtype == 1)
    err = config_of<__nv_bfloat16>(group, &cfg);
  else if (p_dtype == 2)
    err = config_of<signed char>(group, &cfg);
  else
    err = cudaErrorInvalidValue;
  out[0] = kThreads;
  out[1] = cfg.smem;
  out[2] = kTM;
  out[3] = cfg.blocks_per_sm;
  out[4] = cfg.sms;
  return static_cast<int>(err);
}
