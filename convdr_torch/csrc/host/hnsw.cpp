// Compact HNSW (Malkov & Yashunin) approximate nearest-neighbor index, L2.
//
// Native-parity replacement for the reference's FAISS ``IndexHNSWFlat`` used
// by ``DenseHNSWFlatIndexer`` (reference utils/dpr_utils.py:156-221):
// L2-metric hierarchical small-world graph with efConstruction/efSearch and
// the store_n (M) degree bound. Inner-product search rides on top via the
// DPR aux-dimension trick applied by the Python wrapper.
//
// Build: single-threaded (deterministic) or multi-threaded via
// convdr_hnsw_add_parallel (hnswlib-style per-node locking; level draws
// stay sequential so thread count never changes the level assignment, but
// concurrent link order makes the GRAPH schedule-dependent — recall
// contracts hold, bit-identical graphs do not). Search: thread-safe
// concurrent on the const graph; convdr_hnsw_search_parallel fans a query
// batch over a thread pool.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct HnswIndex {
  int64_t dim;
  int64_t m;        // max degree on upper layers; 2m on layer 0
  int64_t ef_construction;
  int64_t ef_search;
  double level_mult;
  std::mt19937_64 rng;

  std::vector<float> data;              // [n, dim]
  std::vector<int> levels;              // per node
  // neighbors[l][node] -> adjacency (flat, capped)
  std::vector<std::vector<std::vector<int>>> neighbors;
  int entry_point = -1;
  int max_level = -1;

  // Per-node locks for the parallel build (hnswlib's link_list_locks_):
  // one mutex guards a node's adjacency on EVERY layer. Allocated between
  // batches (no threads in flight), untouched by the single-threaded path.
  std::unique_ptr<std::mutex[]> node_locks;
  int64_t node_locks_cap = 0;
  // Guards entry_point/max_level; held for a whole insertion only when the
  // new node raises max_level (rare: P ~ 1/m per level).
  std::mutex entry_mu;

  // Visited-set pool (hnswlib's VisitedListPool idea): a fresh O(n)
  // byte-array memset per beam search is amortized during build but costs
  // every QUERY an n-byte clear (38 MB per search_layer call at 38M
  // docs). Epoch-tagged u32 buffers reset by bumping a generation id;
  // the mutex only guards pool push/pop (ns per query), searches stay
  // safely concurrent because each call owns a buffer exclusively.
  struct Visited {
    std::vector<uint32_t> tags;
    uint32_t gen = 0;
  };
  mutable std::vector<std::unique_ptr<Visited>> visited_pool;
  mutable std::mutex pool_mu;

  std::unique_ptr<Visited> acquire_visited() const {
    std::unique_ptr<Visited> v;
    {
      std::lock_guard<std::mutex> lk(pool_mu);
      if (!visited_pool.empty()) {
        v = std::move(visited_pool.back());
        visited_pool.pop_back();
      }
    }
    if (!v) v = std::make_unique<Visited>();
    if ((int64_t)v->tags.size() < size()) v->tags.resize(size(), 0);
    if (++v->gen == 0) {  // generation wrap: clear once, restart at 1
      std::fill(v->tags.begin(), v->tags.end(), 0);
      v->gen = 1;
    }
    return v;
  }
  void release_visited(std::unique_ptr<Visited> v) const {
    std::lock_guard<std::mutex> lk(pool_mu);
    visited_pool.push_back(std::move(v));
  }

  int64_t size() const { return static_cast<int64_t>(levels.size()); }

  const float* vec(int id) const { return data.data() + id * dim; }

  float dist(const float* a, const float* b) const {
    // Four independent accumulators: a single-accumulator FP reduction
    // cannot be auto-vectorized without -ffast-math (reassociation), and
    // the build spends ~all its time here (768-d L2 per beam candidate).
    // The fixed lane order keeps results deterministic.
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    int64_t i = 0;
    for (; i + 4 <= dim; i += 4) {
      const float d0 = a[i] - b[i];
      const float d1 = a[i + 1] - b[i + 1];
      const float d2 = a[i + 2] - b[i + 2];
      const float d3 = a[i + 3] - b[i + 3];
      acc0 += d0 * d0;
      acc1 += d1 * d1;
      acc2 += d2 * d2;
      acc3 += d3 * d3;
    }
    for (; i < dim; ++i) {
      const float d = a[i] - b[i];
      acc0 += d * d;
    }
    return (acc0 + acc1) + (acc2 + acc3);
  }

  // Greedy descent on one layer toward q from start. ``locked`` copies
  // each adjacency under its node lock (build-time concurrent reads);
  // query-time traversal of the immutable graph passes false and stays
  // lock-free.
  int greedy(const float* q, int start, int layer, bool locked) const {
    int cur = start;
    float cur_d = dist(q, vec(cur));
    std::vector<int> snapshot;
    bool improved = true;
    while (improved) {
      improved = false;
      const std::vector<int>* adj = &neighbors[layer][cur];
      if (locked) {
        std::lock_guard<std::mutex> lk(node_locks[cur]);
        snapshot = *adj;  // copy out; distances computed unlocked
        adj = &snapshot;
      }
      for (int nb : *adj) {
        const float d = dist(q, vec(nb));
        if (d < cur_d) {
          cur_d = d;
          cur = nb;
          improved = true;
        }
      }
    }
    return cur;
  }

  // Beam search on a layer; returns up to ef closest (dist, id) pairs.
  // Visited tracking uses the epoch-tagged pool above (flat array, no
  // hash inserts, no per-call O(n) clear).
  std::vector<std::pair<float, int>> search_layer(
      const float* q, int start, int layer, int64_t ef, bool locked) const {
    using Pair = std::pair<float, int>;
    std::priority_queue<Pair> results;                         // max-heap
    std::priority_queue<Pair, std::vector<Pair>, std::greater<Pair>> cands;
    auto visited = acquire_visited();
    uint32_t* tags = visited->tags.data();
    const uint32_t gen = visited->gen;
    std::vector<int> snapshot;
    const float d0 = dist(q, vec(start));
    results.emplace(d0, start);
    cands.emplace(d0, start);
    tags[start] = gen;
    while (!cands.empty()) {
      auto [cd, c] = cands.top();
      if (cd > results.top().first && (int64_t)results.size() >= ef) break;
      cands.pop();
      const std::vector<int>* adj = &neighbors[layer][c];
      if (locked) {
        std::lock_guard<std::mutex> lk(node_locks[c]);
        snapshot = *adj;
        adj = &snapshot;
      }
      for (int nb : *adj) {
        if (tags[nb] == gen) continue;
        tags[nb] = gen;
        const float d = dist(q, vec(nb));
        if ((int64_t)results.size() < ef || d < results.top().first) {
          cands.emplace(d, nb);
          results.emplace(d, nb);
          if ((int64_t)results.size() > ef) results.pop();
        }
      }
    }
    release_visited(std::move(visited));
    std::vector<Pair> out;
    out.reserve(results.size());
    while (!results.empty()) {
      out.push_back(results.top());
      results.pop();
    }
    std::sort(out.begin(), out.end());  // ascending distance
    return out;
  }

  // Neighbor selection heuristic (Malkov & Yashunin Algorithm 4, the rule
  // FAISS/hnswlib use): scan candidates by ascending distance and keep e
  // only if it is closer to the node than to every already-kept neighbor.
  // Plain closest-M selection links each node only into its densest local
  // neighborhood; under clustered data the bidirectional-link pruning then
  // severs the rare inter-cluster edges and layer 0 fragments -- measured
  // as a recall plateau (0.82 at ef=1024 on 500-cluster data) that no ef
  // can recover. The diversity rule preserves those bridge edges.
  // Remaining capacity is backfilled with the nearest pruned candidates
  // (FAISS's keep-pruned-connections behavior) so degree stays full.
  static void select_heuristic(std::vector<std::pair<float, int>>& scored,
                               const HnswIndex& idx, int64_t max_degree,
                               std::vector<int>& out) {
    std::sort(scored.begin(), scored.end());  // ascending distance
    out.clear();
    std::vector<int> pruned;
    for (auto& [d, e] : scored) {
      if ((int64_t)out.size() >= max_degree) break;
      bool diverse = true;
      for (int kept : out) {
        if (idx.dist(idx.vec(e), idx.vec(kept)) < d) {
          diverse = false;
          break;
        }
      }
      if (diverse) {
        out.push_back(e);
      } else {
        pruned.push_back(e);
      }
    }
    for (int e : pruned) {
      if ((int64_t)out.size() >= max_degree) break;
      out.push_back(e);
    }
  }

  static void shrink(std::vector<int>& adj, const HnswIndex& idx, int node,
                     int64_t max_degree) {
    if ((int64_t)adj.size() <= max_degree) return;
    std::vector<std::pair<float, int>> scored;
    scored.reserve(adj.size());
    for (int nb : adj) scored.emplace_back(idx.dist(idx.vec(node), idx.vec(nb)), nb);
    select_heuristic(scored, idx, max_degree, adj);
  }

  // Reserve storage for ``n`` more nodes, drawing their levels from the
  // sequential RNG (thread count never changes level assignment), and
  // return the id of the first. Single-threaded: must not race any
  // in-flight insertions. After this, the new ids are visible via size()
  // but unreachable (empty adjacency, entry_point untouched) until linked.
  int reserve_batch(const float* vecs, int64_t n) {
    const int first = static_cast<int>(size());
    data.insert(data.end(), vecs, vecs + n * dim);
    std::uniform_real_distribution<double> unif(0.0, 1.0);
    int batch_max = -1;
    for (int64_t i = 0; i < n; ++i) {
      const int level = static_cast<int>(
          -std::log(std::max(unif(rng), 1e-12)) * level_mult);
      levels.push_back(level);
      batch_max = std::max(batch_max, level);
    }
    while ((int)neighbors.size() <= std::max(batch_max, max_level))
      neighbors.emplace_back();
    for (auto& layer : neighbors) layer.resize(size());
    if (node_locks_cap < size()) {
      int64_t cap = std::max<int64_t>(size(), node_locks_cap * 2);
      node_locks = std::make_unique<std::mutex[]>(cap);
      node_locks_cap = cap;
    }
    return first;
  }

  // Link a reserved node into the graph. ``locked`` = concurrent build:
  // adjacency reads/writes go through per-node locks and entry updates
  // through entry_mu; with false this is the original single-threaded
  // insertion (bit-identical graphs to the pre-parallel implementation).
  void link_node(int id, bool locked) {
    const float* v = vec(id);
    const int level = levels[id];
    std::unique_lock<std::mutex> entry_lk(entry_mu, std::defer_lock);
    int cur, top;
    if (locked) {
      entry_lk.lock();
      if (entry_point < 0) {
        entry_point = id;
        max_level = level;
        return;
      }
      cur = entry_point;
      top = max_level;
      // Raising max_level keeps the global lock for the whole insertion
      // (hnswlib's templock): concurrent inserts reading the entry point
      // serialize behind it, and no other path writes it meanwhile.
      if (level <= top) entry_lk.unlock();
    } else {
      if (entry_point < 0) {
        entry_point = id;
        max_level = level;
        return;
      }
      cur = entry_point;
      top = max_level;
    }
    for (int l = top; l > level; --l) cur = greedy(v, cur, l, locked);
    for (int l = std::min(level, top); l >= 0; --l) {
      auto cands = search_layer(v, cur, l, ef_construction, locked);
      const int64_t max_degree = (l == 0) ? 2 * m : m;
      // the new node links to a DIVERSE subset of the beam (cap m, as in
      // the paper -- layer 0 allows 2m only via later backlink growth)
      std::vector<int> adj;
      select_heuristic(cands, *this, m, adj);
      if (locked) {
        // A concurrent insert may have already backlinked into this
        // node's adjacency (it becomes reachable layer by layer as the
        // top-down pass publishes backlinks); merge rather than assign
        // so those edges survive.
        std::lock_guard<std::mutex> lk(node_locks[id]);
        std::vector<int>& own = neighbors[l][id];
        for (int e : adj) {
          if (std::find(own.begin(), own.end(), e) == own.end())
            own.push_back(e);
        }
        shrink(own, *this, id, max_degree);
      } else {
        neighbors[l][id] = adj;
      }
      for (int nb : adj) {
        if (locked) {
          std::lock_guard<std::mutex> lk(node_locks[nb]);
          neighbors[l][nb].push_back(id);
          shrink(neighbors[l][nb], *this, nb, max_degree);
        } else {
          neighbors[l][nb].push_back(id);
          shrink(neighbors[l][nb], *this, nb, max_degree);
        }
      }
      if (!cands.empty()) cur = cands.front().second;
    }
    if (level > top) {
      // entry_lk is held on the locked path (acquired above)
      max_level = level;
      entry_point = id;
    }
  }

  void add(const float* vecs, int64_t n) {
    const int first = reserve_batch(vecs, n);
    for (int64_t i = 0; i < n; ++i)
      link_node(first + static_cast<int>(i), /*locked=*/false);
  }

  void add_parallel(const float* vecs, int64_t n, int64_t num_threads) {
    if (num_threads <= 1 || n <= 1) {
      add(vecs, n);
      return;
    }
    const int first = reserve_batch(vecs, n);
    int64_t start = 0;
    if (entry_point < 0) {
      // seed the graph single-threaded so every worker has an entry point
      link_node(first, /*locked=*/false);
      start = 1;
    }
    std::atomic<int64_t> next(start);
    auto worker = [&]() {
      for (;;) {
        const int64_t i = next.fetch_add(1);
        if (i >= n) return;
        link_node(first + static_cast<int>(i), /*locked=*/true);
      }
    };
    std::vector<std::thread> pool;
    const int64_t t_count = std::min<int64_t>(num_threads, n - start);
    pool.reserve(t_count);
    for (int64_t t = 0; t < t_count; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }

  void search(const float* q, int64_t k, float* dists, int64_t* ids) const {
    if (entry_point < 0) {
      for (int64_t i = 0; i < k; ++i) {
        dists[i] = std::numeric_limits<float>::infinity();
        ids[i] = -1;
      }
      return;
    }
    int cur = entry_point;
    for (int l = max_level; l > 0; --l) cur = greedy(q, cur, l, false);
    auto found =
        search_layer(q, cur, 0, std::max<int64_t>(ef_search, k), false);
    for (int64_t i = 0; i < k; ++i) {
      if (i < (int64_t)found.size()) {
        dists[i] = found[i].first;
        ids[i] = found[i].second;
      } else {
        dists[i] = std::numeric_limits<float>::infinity();
        ids[i] = -1;
      }
    }
  }
};

}  // namespace

extern "C" {

void* convdr_hnsw_create(int64_t dim, int64_t m, int64_t ef_construction,
                         int64_t ef_search, uint64_t seed) {
  auto* idx = new HnswIndex();
  idx->dim = dim;
  idx->m = std::max<int64_t>(m, 2);
  idx->ef_construction = std::max<int64_t>(ef_construction, idx->m);
  idx->ef_search = std::max<int64_t>(ef_search, 1);
  idx->level_mult = 1.0 / std::log(static_cast<double>(idx->m));
  idx->rng.seed(seed);
  return idx;
}

void convdr_hnsw_free(void* handle) { delete static_cast<HnswIndex*>(handle); }

void convdr_hnsw_add(void* handle, const float* vecs, int64_t n) {
  static_cast<HnswIndex*>(handle)->add(vecs, n);
}

// Multi-threaded insertion. Same recall contract as convdr_hnsw_add; the
// exact graph depends on the interleaving (num_threads==1 is bit-identical
// to convdr_hnsw_add, including RNG state).
void convdr_hnsw_add_parallel(void* handle, const float* vecs, int64_t n,
                              int64_t num_threads) {
  static_cast<HnswIndex*>(handle)->add_parallel(vecs, n, num_threads);
}

int64_t convdr_hnsw_size(void* handle) {
  return static_cast<HnswIndex*>(handle)->size();
}

void convdr_hnsw_set_ef_search(void* handle, int64_t ef_search) {
  static_cast<HnswIndex*>(handle)->ef_search = std::max<int64_t>(ef_search, 1);
}

void convdr_hnsw_search(void* handle, const float* queries, int64_t nq,
                        int64_t k, float* dists, int64_t* ids) {
  auto* idx = static_cast<HnswIndex*>(handle);
  for (int64_t q = 0; q < nq; ++q) {
    idx->search(queries + q * idx->dim, k, dists + q * k, ids + q * k);
  }
}

// Query-batch fan-out over a thread pool. Per-query results are identical
// to convdr_hnsw_search at any thread count (queries are independent and
// the graph is immutable during search).
void convdr_hnsw_search_parallel(void* handle, const float* queries,
                                 int64_t nq, int64_t k, float* dists,
                                 int64_t* ids, int64_t num_threads) {
  auto* idx = static_cast<HnswIndex*>(handle);
  const int64_t t_count = std::max<int64_t>(std::min(num_threads, nq), 1);
  if (t_count == 1) {
    convdr_hnsw_search(handle, queries, nq, k, dists, ids);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t q = next.fetch_add(1);
      if (q >= nq) return;
      idx->search(queries + q * idx->dim, k, dists + q * k, ids + q * k);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(t_count);
  for (int64_t t = 0; t < t_count; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // extern "C"
