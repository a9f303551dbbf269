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
// Exactness: with f32 passages each score is kernel 2's six-part wgmma
// product (scores_groupmax.cu): the queries and the passages split into
// three bf16 parts each in the kernel, as kernel 2 splits them (the
// arithmetic of ops/fused_search.py bf16_query_parts), and
// per k-step of 16 (from k = 0, zeros after D) the products (1,1) into one
// f32 sum and (1,2), (2,1), (1,3), (2,2), (3,1) into a second
// (hopper.cuh wgmma_f32_parts_stage), the two added round to nearest at
// the end. With bf16 passages the queries come as their three bf16 parts
// and each score is kernel 2's three-part wgmma product: k-steps of 16
// from k = 0 in stages of 64, parts 1, 2, 3 in turn each k-step, into one
// f32 accumulator (hopper.cuh wgmma_bf16_parts_stage). Either way an
// output's bits depend only on its rows and that order (kernel 2's probe),
// not on which operand is A. With int8 passages the queries are the
// int-valued ones of quantize_queries, taken as int8 as kernel 2 takes
// them, and the sums are int32 dp4a sums: exact integers below 2^24 (D <=
// 1040), so equal to kernel 2's tensor-core integer sums whatever their
// order. So each candidate score is bit-identical to kernel 2's score of
// that (query, row), and pass A's group maxima are exactly the maxima of
// these scores: group pruning stays exact. Hence no split-K and no
// reordering of k.
//
// What bounds it on an H100: bytes. The selected groups' rows are read once
// (up to N * D * 4 bytes, 1.6 GB at N=524288, D=768 f32 when every group
// is picked: ~0.48 ms at 3.35 TB/s) and the [Q, kg, G] scores written once,
// against 6 * 2 * Q * kg * G * D six-part operations (61 GFLOP at Q=512,
// kg=101, G=128: ~0.06 ms at the 989 TFLOP/s bf16 peak). The design:
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
//   * A ring of 16-byte cp.async.cg copies (f32: the passage rows by
//     TMA): each stage holds the item's G passage rows x one k-chunk and
//     its slots' query rows (or query-part rows) x the same k-chunk,
//     gathered by slot.
//   * f32 (extract_candidates_f32): a 3-stage ring on full barriers of
//     the slots' f32 query rows (cp.async) and the group's G f32 rows x 32
//     k (one TMA box); each thread reads its A values from the rows and
//     the block splits the query rows into a buffer of their parts, which
//     frees the stage for the next load at once; the
//     warpgroup issues m64n16k16 with the passage parts as A from
//     registers (a 64-row block at a time, split in each thread) and the
//     slots as N, so no tensor work is spent on padding slots (the slots
//     as M would compute 64 rows for 16) and no passage part goes through
//     shared memory.
//   * bf16 (extract_candidates_bf16): the same work list, item stream and
//     3-stage ring, each stage the slots' three query-part rows (parts at
//     tile rows 0, 16, 32: a product reads 64 rows from its part's first,
//     rows past the item's slots are never stored) and the group's G rows
//     x 64 k, 128-byte rows laid out as TMA's swizzle lays them; the
//     block's warpgroup issues m64nGk16 over them (slots as M, the G rows
//     as N) and warp 0 stores the item's rows 0..15.
//   * int8 register tiles (2 stages of 128 k): each of the 4 warps owns 4
//     slots and all G rows; a lane owns 4 slots x G/32 rows (G >= 32), or 2
//     x 1 (G=16) or 1 x 1 (G=8). A warp whose slots are all padding skips
//     the arithmetic: an item of c slots costs dp4a for c rounded up to 4
//     and no bytes for the rest. A lane reads 16-byte vectors of passage
//     and query rows from shared memory (pitches of 144 bytes put a
//     quarter warp's 8 rows on distinct banks; query vectors are warp
//     broadcasts), 4 k a dp4a.
// bf16 and int8 rows whose pitch is not a multiple of 16 bytes (D % 8,
// D % 16), or operands that are not 16-byte aligned, take a scalar loader
// into the same ring (element loads, synchronous); the arithmetic is the
// same. f32 takes 16-byte rows and bases alone (TMA): the wrapper pads D
// to 4 and copies an unaligned operand.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
// The int8 register tiles: Q the query element type as the kernel takes
// it, elements a 16-byte vector of P, k a stage, the shared row pitches
// (in elements) of the passage and query tiles, and the ring's stages.
// 128 bytes of a row a stage read faster on the card than 64, even at 2
// stages and 2 blocks an SM; a pitch of 144 bytes puts the 8 rows a
// quarter warp reads on distinct banks.
template <typename P>
struct Tile;
template <>
struct Tile<signed char> {
  using Q = signed char;
  static constexpr int kVec = 16, kKC = 128, kPitch = 144, kQPitch = 144, kStages = 2;
};

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}

// 16-byte global -> shared copy; with pred false nothing is read and the
// 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
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

// One stage's arithmetic for a lane's kTS x kRT tile: dp4a int32 sums.
template <typename P, int G>
__device__ __forceinline__ void compute_stage(const unsigned char* st, int lr, int m0,
                                              int (&acc)[Shape<P, G>::kTS][Shape<P, G>::kRT]) {
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

  int acc[S::kTS][S::kRT];
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
        for (int r = 0; r < S::kRT; ++r) acc[s][r] = 0;
        // the output slots, read now and used after the item's last k-chunk
        out_slot[s] = m0 + s < cnt ? slots[header[2 * stage] + m0 + s] : -1;
      }
    }
    if (warp_m0 < cnt) {  // warp-uniform: skip a warp of padding slots
      compute_stage<P, G>(smem + stage * S::kStageBytes, lr, m0, acc);
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

// ---------------------------------------------------------------------------
// the scoring kernel, bf16 passages: kernel 2's three-part wgmma product
// ---------------------------------------------------------------------------
constexpr int kBfStages = 3;
constexpr int kBfK = 64;                      // k a stage: one 128-byte swizzled row
constexpr int kBfRowBytes = 2 * kBfK;
constexpr int kBfPartRows = kTM;              // part p's slot rows at tile rows 16p..16p+15
constexpr int kBfARows = 2 * kBfPartRows + 64;  // part 3's product reads rows 32..95
constexpr int kBfABytes = kBfARows * kBfRowBytes;

// A stage: the three query-part rows ([kBfARows][128 bytes]), then the
// group's G passage rows ([G][128 bytes]), from a 1024-byte aligned base
// (+ 1024 to align it), then each stage's (first slot, slot count).
template <int G>
struct BfShape {
  static constexpr int kStageBytes = kBfABytes + G * kBfRowBytes;
  static constexpr int kSmem = 1024 + kBfStages * kStageBytes + kBfStages * 2 * 4;
  static_assert(kBfABytes % 1024 == 0 && kStageBytes % 1024 == 0, "1024-byte bases");
};

// An item as the bf16 load stream holds it: its group, first sorted slot
// and slot count, and the query row of the slot this thread copies
// (slot tid / 8; -1 for a padding slot).
struct BfItem {
  int g, first, cnt;
  long long qrow;
};

// One item's data for one k-chunk into ring stage `st` (k past D as
// zeros), in the layout of TMA's 128-byte swizzle: query part p's slot m at
// tile row 16p + m, passage row r at row r of the passage tile. The vector
// path copies 16-byte chunks by cp.async (thread tid: slot tid / 8, chunk
// tid % 8 of each part); the scalar path (D % 8, or operands not 16-byte
// aligned) stores elements. Rows of padding slots are left as they are:
// their sums are never stored.
template <int G>
__device__ __forceinline__ void load_stage_bf16(
    unsigned char* st, const __nv_bfloat16* __restrict__ qp, long long part_elems,
    const __nv_bfloat16* __restrict__ p, const int* __restrict__ slots, const BfItem& it,
    int k0, int d, int kg, bool vec, int tid) {
  unsigned char* ps = st + kBfABytes;
  const __nv_bfloat16* prow = p + static_cast<long long>(it.g) * G * d;
  if (vec) {
    const int ch = tid % 8;
    const int gk = k0 + 8 * ch;
    if (it.qrow >= 0) {
      const bool ok = gk < d;
#pragma unroll
      for (int part = 0; part < 3; ++part)
        cp_async16(st + swizzled_chunk_offset(kBfPartRows * part + tid / 8, ch, kBfRowBytes),
                   ok ? qp + part * part_elems + it.qrow * d + gk : qp, ok);
    }
    constexpr int kPer = (G * 8 + kThreads - 1) / kThreads;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kThreads;
      if (G * 8 % kThreads == 0 || c < G * 8) {
        const int r = c / 8;
        const int pk = k0 + 8 * (c % 8);
        const bool ok = pk < d;
        cp_async16(ps + swizzled_chunk_offset(r, c % 8, kBfRowBytes),
                   ok ? prow + static_cast<long long>(r) * d + pk : p, ok);
      }
    }
  } else {
    const __nv_bfloat16 z = __float2bfloat16(0.f);
    for (int c = tid; c < 3 * kTM * kBfK; c += kThreads) {
      const int part = c / (kTM * kBfK);
      const int m = (c / kBfK) % kTM;
      const int k = c % kBfK;
      if (m < it.cnt) {
        const long long row = slots[it.first + m] / kg;
        const int gk = k0 + k;
        *reinterpret_cast<__nv_bfloat16*>(
            st + swizzled_chunk_offset(kBfPartRows * part + m, k / 8, kBfRowBytes) + 2 * (k % 8)) =
            gk < d ? qp[part * part_elems + row * d + gk] : z;
      }
    }
    for (int c = tid; c < G * kBfK; c += kThreads) {
      const int r = c / kBfK;
      const int k = c % kBfK;
      const int gk = k0 + k;
      *reinterpret_cast<__nv_bfloat16*>(ps + swizzled_chunk_offset(r, k / 8, kBfRowBytes) +
                                        2 * (k % 8)) =
          gk < d ? prow[static_cast<long long>(r) * d + gk] : z;
    }
  }
}

// The int8 kernel's item stream and ring (kBfStages stages, the load
// stream kBfStages - 1 steps ahead), with each step's arithmetic one
// wgmma_bf16_parts_stage<G> of the block's warpgroup: A the stage's query
// parts (part p's descriptor at tile row 16p), B its G passage rows; the
// accumulator's rows 0..15 are the item's slots. A stage is refilled only
// after the products that read it have landed (wgmma_wait<1> after the
// next stage's are issued, then a barrier); at the item's last k-chunk
// warp 0 writes its slots' rows (row g and g + 8 of each lane, columns
// 8j + 2t + e).
template <int G>
__global__ void __launch_bounds__(kThreads)
extract_candidates_bf16(const __nv_bfloat16* __restrict__ qp, const __nv_bfloat16* __restrict__ p,
                        const int* __restrict__ slots, const int* __restrict__ items,
                        const int* __restrict__ n_items_ptr, float* __restrict__ cand, int nq,
                        int d, int kg, int vec) {
  using S = BfShape<G>;
  extern __shared__ __align__(16) unsigned char bf_smem[];
  unsigned char* smem = bf_smem + ((1024u - (shared_addr(bf_smem) & 1023u)) & 1023u);
  int* header = reinterpret_cast<int*>(smem + kBfStages * S::kStageBytes);
  const long long part_elems = static_cast<long long>(nq) * d;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g8 = lane / 4;
  const int t = lane % 4;

  const int n_items = *n_items_ptr;
  const int nk = (d + kBfK - 1) / kBfK;
  const int bid = static_cast<int>(blockIdx.x);
  const int grid = static_cast<int>(gridDim.x);
  const int mine = n_items > bid ? (n_items - 1 - bid) / grid + 1 : 0;
  const int steps = mine * nk;

  auto head = [&](int j, BfItem& it) {
    const int* e = items + 3 * (bid + j * grid);
    it.g = e[0];
    it.first = e[1];
    it.cnt = e[2];
  };
  auto rows = [&](BfItem& it) {
    const int m = tid / 8;
    it.qrow = m < it.cnt ? slots[it.first + m] / kg : -1;
  };
  BfItem cur{}, nxt{};
  int lj = 0, lkc = 0;  // the load stream's item and k-chunk
  if (mine > 0) {
    head(0, cur);
    rows(cur);
  }
  if (mine > 1) head(1, nxt);
  auto load_next = [&](int stage) {
    load_stage_bf16<G>(smem + stage * S::kStageBytes, qp, part_elems, p, slots, cur,
                       lkc * kBfK, d, kg, vec != 0, tid);
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
  for (int s = 0; s < kBfStages - 1; ++s) {
    if (s < steps) load_next(s);
    cp_async_commit();
  }

  const uint32_t base = shared_addr(smem);
  int step = 0;  // the arithmetic's step: (item, k-chunk) in order
  for (int j = 0; j < mine; ++j) {
    float acc[G / 2];
    int out_slot[2] = {-1, -1};
    for (int kc = 0; kc < nk; ++kc, ++step) {
      cp_async_wait<kBfStages - 2>();
      fence_shared_to_async();  // this thread's copies and stores, before the products read them
      __syncthreads();          // stage `step` landed for every thread
      const int stage = step % kBfStages;
      if (kc == 0 && warp == 0) {  // the output slots, used after the item's last k-chunk
        const int cnt = header[2 * stage + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (g8 + 8 * r < cnt) out_slot[r] = slots[header[2 * stage] + g8 + 8 * r];
      }
      const uint32_t st = base + stage * S::kStageBytes;
      wgmma_fence();
      wgmma_bf16_parts_stage<G, (kBfPartRows * kBfRowBytes >> 4), 0>(
          acc, wgmma_desc(st, kBfRowBytes), wgmma_desc(st + kBfABytes, kBfRowBytes), kc == 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products have landed
      __syncthreads();  // ... in every warp: its stage is free for step + 2
      if (step + kBfStages - 1 < steps) load_next((step + kBfStages - 1) % kBfStages);
      cp_async_commit();
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (out_slot[r] >= 0) {
          float* out = cand + static_cast<long long>(out_slot[r]) * G + 2 * t;
#pragma unroll
          for (int c = 0; c < G / 8; ++c)
            *reinterpret_cast<float2*>(out + 8 * c) =
                make_float2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the scoring kernel, f32 passages: kernel 2's six-part wgmma product
// ---------------------------------------------------------------------------
constexpr int kF32Stages = 3;
constexpr int kF32K = 32;                     // k a stage: a 128-byte f32 row, a 64-byte part row
constexpr int kF32PartRow = 2 * kF32K;
constexpr int kF32BoxRow = 4 * kF32K;
constexpr int kF32QPart = kTM * kF32PartRow;  // one query part's 16 slot rows
constexpr int kF32QRows = kTM * kF32BoxRow;   // the slots' f32 query rows of a stage

// A stage: the slots' f32 query rows ([16][128 bytes]), then the group's
// G f32 rows ([G][128 bytes], one TMA box), in the layout of TMA's
// 128-byte swizzle, from a 1024-byte aligned base. Then the query
// buffer: the three bf16 parts of a stage's query rows (part i's slot m at
// row m of [16][64 bytes], the 64-byte swizzle's layout, the parts 1 KB
// apart), split from the stage, which is then free; then each stage's
// full barrier and (first slot, slot count).
template <int G>
struct F32Shape {
  static constexpr int kBlocks = G > 64 ? G / 64 : 1;  // 64-row A blocks
  static constexpr int kStageBytes = kF32QRows + G * kF32BoxRow;
  static constexpr int kBufBytes = 3 * kF32QPart;
  static constexpr int kSmem =
      1024 + kF32Stages * kStageBytes + kBufBytes + kF32Stages * (8 + 2 * 4);
  static_assert(kStageBytes % 1024 == 0, "1024-byte bases");
};

// One item's data for one k-chunk into ring stage `st` (k past D as
// zeros), completing on the stage's full barrier: the group's G f32 rows
// by one TMA box (thread 0), and the f32 query rows of its slots by
// cp.async (thread tid: 16-byte chunk tid % 8 of slot tid / 8; a padding
// slot's row is left as it is, its sums never stored), each thread's
// arrival counted once its copies have landed.
template <int G>
__device__ __forceinline__ void load_stage_f32(unsigned char* st, uint64_t* full,
                                               const CUtensorMap* p_map,
                                               const float* __restrict__ q, const BfItem& it,
                                               int k0, int d, int tid) {
  if (tid == 0) {
    mbar_arrive_expect_tx(full, G * kF32BoxRow);
    tma_load_2d(st + kF32QRows, p_map, full, k0, it.g * G);
  }
  if (it.qrow >= 0) {
    const int ch = tid % 8;
    const int gk = k0 + 4 * ch;
    const bool ok = gk < d;
    cp_async16(st + swizzled_chunk_offset(tid / 8, ch, kF32BoxRow), ok ? q + it.qrow * d + gk : q,
               ok);
  }
  mbar_arrive_cp_async(full);
}

// This thread's A values of k-step kk for 64-row block `blk` (rows 64 blk
// + 16 warp + g, + 8) of a stage's G f32 rows (load_f32_fragment); rows
// past G (G < 64) read as zeros, their sums never stored.
template <int G>
__device__ __forceinline__ void load_rows_fragment(const unsigned char* rows, int blk, int warp,
                                                   int g, int t, int kk, float2 (&v)[4]) {
  const int r = 64 * blk + 16 * warp + g;
  if constexpr (G >= 64) {
    load_f32_fragment(rows, r, kk, t, v);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 8 * (i & 1);
      v[i] = row < G ? *reinterpret_cast<const float2*>(
                           rows + swizzled_chunk_offset(row, 4 * kk + 2 * (i >> 1) + (t >> 1), 128) +
                           8 * (t & 1))
                     : make_float2(0.f, 0.f);
    }
  }
}

// The bf16 kernel's item stream (kF32Stages stages, the load stream
// kF32Stages - 1 steps ahead), its stages loaded by TMA and cp.async onto
// full barriers (the group's rows as one [G][32 f32] box: what bounds pass
// B is bytes, and per-thread 16-byte copies of them kept the kernel at
// its FMA predecessor's rate). Each step every thread reads its A
// values (the passage rows 16 warp + g, + 8 of each 64-row block, both
// k-steps) and the block splits the stage's query rows into the query
// buffer (split_f32_chunk), which frees the stage: it is refilled
// at the next step's start, without waiting for any product. Then each
// k-step the thread splits its values into the three parts' fragments
// (split_f32_fragment; both the arithmetic of bf16_query_parts) and the
// warpgroup issues wgmma_f32_parts_rs_kstep for each block (m64n16, the
// passage parts as A from registers, the slots' query parts as B;
// G=128: two independent chains): kernel 2's products, order and two
// sums, with the roles its small-Q tiles give them, so the same bits. The
// k-steps' fragments are f0 and f1, each kept (pin_fragment) until the
// step's products have landed; the next step's loads and split then run
// while the other two blocks of the SM compute. At the item's last k-chunk
// every thread adds its two sums (round to nearest) and writes its rows
// of its slots 8j + 2t + e.
template <int G>
__global__ void __launch_bounds__(kThreads)
extract_candidates_f32(const __grid_constant__ CUtensorMap p_map, const float* __restrict__ q,
                       const int* __restrict__ slots, const int* __restrict__ items,
                       const int* __restrict__ n_items_ptr, float* __restrict__ cand, int d,
                       int kg) {
  using S = F32Shape<G>;
  constexpr int kB = S::kBlocks;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  unsigned char* smem = f32_smem + ((1024u - (shared_addr(f32_smem) & 1023u)) & 1023u);
  unsigned char* qbuf = smem + kF32Stages * S::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(qbuf + S::kBufBytes);
  int* header = reinterpret_cast<int*>(full + kF32Stages);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g8 = lane / 4;
  const int t = lane % 4;

  if (tid == 0) {
    for (int s = 0; s < kF32Stages; ++s) mbar_init(full + s, 1 + kThreads);  // TMA + each thread
    mbar_fence_init();
  }
  __syncthreads();

  const int n_items = *n_items_ptr;
  const int nk = (d + kF32K - 1) / kF32K;
  const int bid = static_cast<int>(blockIdx.x);
  const int grid = static_cast<int>(gridDim.x);
  const int mine = n_items > bid ? (n_items - 1 - bid) / grid + 1 : 0;
  const int steps = mine * nk;

  auto head = [&](int j, BfItem& it) {
    const int* e = items + 3 * (bid + j * grid);
    it.g = e[0];
    it.first = e[1];
    it.cnt = e[2];
  };
  auto rows = [&](BfItem& it) {  // the slot whose query chunk this thread copies
    const int m = tid / 8;
    it.qrow = m < it.cnt ? slots[it.first + m] / kg : -1;
  };
  BfItem cur{}, nxt{};
  int lj = 0, lkc = 0;  // the load stream's item and k-chunk
  if (mine > 0) {
    head(0, cur);
    rows(cur);
  }
  if (mine > 1) head(1, nxt);
  auto load_next = [&](int stage) {
    load_stage_f32<G>(smem + stage * S::kStageBytes, full + stage, &p_map, q, cur, lkc * kF32K, d,
                      tid);
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

  for (int s = 0; s < kF32Stages - 1 && s < steps; ++s) load_next(s);

  const uint64_t db = wgmma_desc(shared_addr(qbuf), kF32PartRow);
  uint32_t f0[kB][3][4], f1[kB][3][4];  // the two k-steps' A fragments
  int step = 0;  // the arithmetic's step: (item, k-chunk) in order
  for (int j = 0; j < mine; ++j) {
    float big[kB][kTM / 2], small[kB][kTM / 2];
    int out_slot[4] = {-1, -1, -1, -1};  // slots 8 (i / 2) + 2t + i % 2
    for (int kc = 0; kc < nk; ++kc, ++step) {
      const int stage = step % kF32Stages;
      mbar_wait(full + stage, (step / kF32Stages) & 1);  // stage `step` landed
      // every thread is done with the reads of step - 1 (its stage is free)
      // and past the wait for its products (the query buffer is)
      __syncthreads();
      if (step + kF32Stages - 1 < steps) load_next((step + kF32Stages - 1) % kF32Stages);
      if (kc == 0) {  // the output slots, used after the item's last k-chunk
        const int cnt = header[2 * stage + 1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = 8 * (i / 2) + 2 * t + i % 2;
          if (m < cnt) out_slot[i] = slots[header[2 * stage] + m];
        }
      }
      const unsigned char* st = smem + stage * S::kStageBytes;
      float2 v[kB][2][4];
#pragma unroll
      for (int b = 0; b < kB; ++b)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          load_rows_fragment<G>(st + kF32QRows, b, warp, g8, t, kk, v[b][kk]);
      split_f32_chunk<kF32QPart>(st, tid / 8, qbuf, tid / 8, tid % 8);  // 16 rows x 8 chunks
      fence_shared_to_async();  // the query parts, before the products read them
      __syncthreads();
#pragma unroll
      for (int b = 0; b < kB; ++b) split_f32_fragment(v[b][0], f0[b]);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < kB; ++b)
        wgmma_f32_parts_rs_kstep<kTM, (kF32QPart >> 4), 0>(big[b], small[b], f0[b], db,
                                                           kc == 0 ? 0 : 1);
      wgmma_commit();
#pragma unroll
      for (int b = 0; b < kB; ++b) split_f32_fragment(v[b][1], f1[b]);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < kB; ++b)
        wgmma_f32_parts_rs_kstep<kTM, (kF32QPart >> 4), 2>(big[b], small[b], f1[b], db, 1);
      wgmma_commit();
      // the step's products have landed (a wait for the first k-step's alone
      // let ptxas inject one at the next step's barrier wait, C7517); the
      // fragments they read are kept until here
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        pin_fragment(f0[b]);
        pin_fragment(f1[b]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      wgmma_fence_regs(big[b]);
      wgmma_fence_regs(small[b]);
    }
#pragma unroll
    for (int b = 0; b < kB; ++b)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 64 * b + 16 * warp + g8 + 8 * r;
        if (row < G) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int at = 4 * (i / 2) + 2 * r + i % 2;
            if (out_slot[i] >= 0)
              cand[static_cast<long long>(out_slot[i]) * G + row] =
                  __fadd_rn(big[b][at], small[b][at]);
          }
        }
      }
  }
}

struct Config {
  int smem;
  int blocks_per_sm;
  int sms;
};

// The kernel and dynamic shared memory of one instantiation.
template <typename P, int G>
const void* kernel_fn() {
  if constexpr (std::is_same<P, __nv_bfloat16>::value)
    return (const void*)extract_candidates_bf16<G>;
  else if constexpr (std::is_same<P, float>::value)
    return (const void*)extract_candidates_f32<G>;
  else
    return (const void*)extract_candidates_kernel<P, G>;
}
template <typename P, int G>
constexpr int kernel_smem() {
  if constexpr (std::is_same<P, __nv_bfloat16>::value)
    return BfShape<G>::kSmem;
  else if constexpr (std::is_same<P, float>::value)
    return F32Shape<G>::kSmem;
  else
    return Shape<P, G>::kSmem;
}

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
  cfg->smem = kernel_smem<P, G>();
  if (per_sm[dev] == 0) {
    const void* fn = kernel_fn<P, G>();
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cfg->smem);
    if (err == cudaSuccess && std::is_same<P, float>::value)  // as many blocks as fit
      err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
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
  int nq;
  int d;
  int kg;
  int n_rows;  // of the passages
  cudaStream_t s;
};

// The query element type a kernel takes, and the elements of a 16-byte
// vector of the rows its vector path copies.
template <typename P>
struct Operands {
  using Q = typename Tile<P>::Q;
  static constexpr int kVec = Tile<P>::kVec;
};
template <>
struct Operands<__nv_bfloat16> {
  using Q = __nv_bfloat16;  // the query parts
  static constexpr int kVec = 8;
};
template <>
struct Operands<float> {
  using Q = float;  // the kernel splits the queries
  static constexpr int kVec = 4;
};

template <typename P, int G>
cudaError_t launch(const Args& a) {
  using Q = typename Operands<P>::Q;
  constexpr int kVec = Operands<P>::kVec;
  Config cfg;
  cudaError_t err = config<P, G>(&cfg);
  if (err != cudaSuccess) return err;
  const bool vec = a.d % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(a.q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.p) % 16 == 0;
  const long long fit = static_cast<long long>(cfg.sms) * cfg.blocks_per_sm;
  const int blocks = static_cast<int>(a.max_items < fit ? a.max_items : fit);
  if constexpr (std::is_same<P, __nv_bfloat16>::value)
    extract_candidates_bf16<G><<<blocks, kThreads, cfg.smem, a.s>>>(
        static_cast<const Q*>(a.q), static_cast<const P*>(a.p), a.w.slots, a.w.items,
        a.w.n_items, a.cand, a.nq, a.d, a.kg, vec ? 1 : 0);
  else if constexpr (std::is_same<P, float>::value) {
    // the passages' [G][32 f32] boxes by TMA: 16-byte rows and base
    alignas(64) CUtensorMap p_map;
    if (!vec || !encode_rows_map(&p_map, a.p, 4, a.d, a.n_rows, G)) return cudaErrorInvalidValue;
    extract_candidates_f32<G><<<blocks, kThreads, cfg.smem, a.s>>>(
        p_map, static_cast<const Q*>(a.q), a.w.slots, a.w.items, a.w.n_items, a.cand, a.d,
        a.kg);
  } else
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

// The work list, then the scores: q f32 [nq, d] for p_dtype 0 (float32;
// the kernel splits them; d % 4 == 0 and both operands 16-byte aligned),
// the three bf16 parts [3, nq, d] of the f32 queries (ops/fused_search.py
// bf16_query_parts) for 1 (bfloat16), int8 [nq, d] for 2 (int8);
// p [n_groups * group, d]; gsel and
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
               static_cast<float*>(cand), max_items, nq, d, kg, n_groups * group,
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
