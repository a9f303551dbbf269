// convdr_native: host-side native runtime for the ConvDR-TPU framework.
//
// The reference consumed its native functionality through FAISS and NCCL
// binaries; the TPU compute path here is JAX/Pallas, and this library covers
// the host runtime around it (SURVEY.md §2.3 #4):
//
//   * raw embedding-block store: header + contiguous f32 rows + int64 ids,
//     written/read with large buffered IO and multithreaded pread -- replaces
//     pickled block files on the hot serving path (pickle copies through
//     Python objects; this streams straight into caller-provided buffers);
//   * token-cache split merge: streams worker split files, strips the 8-byte
//     big-endian pid prefix (reference record layout, data/tokenizing.py:116),
//     concatenates records, and returns the pid order for the offset maps;
//   * exact 2-pointer top-k merge of sorted-desc candidate lists (the
//     reference's Python merge, drivers/run_convdr_inference.py:210-229) for
//     host-side run merging.
//
// C ABI only; consumed from Python via ctypes (no pybind11 dependency).

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

static const uint64_t kMagic = 0x434E5642304B4C42ULL;  // "CNVB0KLB"

struct BlockHeader {
  uint64_t magic;
  int64_t rows;
  int64_t dim;
  // dtype code: 0 = float32 (original format; field was "reserved"),
  // 1 = bfloat16 (capacity mode, raw 2-byte elements),
  // 2 = int8 (SQ8 scalar quantization; scales live in the Python-side
  //     int8_scales.npy sidecar, ops/quant.py).
  int64_t dtype_code;
};

static int64_t convdr_elem_bytes(int64_t dtype_code) {
  return dtype_code == 2 ? 1 : dtype_code == 1 ? 2 : 4;
}

// ---------------------------------------------------------------------------
// Embedding block store
// ---------------------------------------------------------------------------
int convdr_write_block_ex(const char* path, const void* emb,
                          const int64_t* ids, int64_t rows, int64_t dim,
                          int64_t dtype_code) {
  if (dtype_code != 0 && dtype_code != 1 && dtype_code != 2) return 6;
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  BlockHeader hdr{kMagic, rows, dim, dtype_code};
  if (std::fwrite(&hdr, sizeof(hdr), 1, f) != 1) { std::fclose(f); return 2; }
  const size_t emb_bytes = static_cast<size_t>(rows) * dim *
                           static_cast<size_t>(convdr_elem_bytes(dtype_code));
  if (emb_bytes && std::fwrite(emb, 1, emb_bytes, f) != emb_bytes) {
    std::fclose(f);
    return 3;
  }
  const size_t id_count = static_cast<size_t>(rows);
  if (id_count && std::fwrite(ids, sizeof(int64_t), id_count, f) != id_count) {
    std::fclose(f);
    return 4;
  }
  return std::fclose(f) == 0 ? 0 : 5;
}

int convdr_write_block(const char* path, const float* emb, const int64_t* ids,
                       int64_t rows, int64_t dim) {
  return convdr_write_block_ex(path, emb, ids, rows, dim, 0);
}

int convdr_read_block_header_ex(const char* path, int64_t* rows, int64_t* dim,
                                int64_t* dtype_code) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  BlockHeader hdr;
  if (std::fread(&hdr, sizeof(hdr), 1, f) != 1 || hdr.magic != kMagic) {
    std::fclose(f);
    return 2;
  }
  *rows = hdr.rows;
  *dim = hdr.dim;
  *dtype_code = hdr.dtype_code;
  std::fclose(f);
  return 0;
}

int convdr_read_block_header(const char* path, int64_t* rows, int64_t* dim) {
  int64_t dtype_code = 0;
  return convdr_read_block_header_ex(path, rows, dim, &dtype_code);
}

// Multithreaded read of the embedding matrix + ids into caller buffers.
// The caller's buffer must match the header's dtype (checked).
int convdr_read_block_ex(const char* path, void* emb_out, int64_t* ids_out,
                         int64_t rows, int64_t dim, int64_t dtype_code,
                         int num_threads) {
  FILE* probe = std::fopen(path, "rb");
  if (!probe) return 1;
  BlockHeader hdr;
  if (std::fread(&hdr, sizeof(hdr), 1, probe) != 1 || hdr.magic != kMagic ||
      hdr.rows != rows || hdr.dim != dim || hdr.dtype_code != dtype_code) {
    std::fclose(probe);
    return 2;
  }
  std::fclose(probe);

  if (num_threads < 1) num_threads = 1;
  const int64_t emb_bytes = rows * dim * convdr_elem_bytes(dtype_code);
  const int64_t emb_off = sizeof(BlockHeader);
  std::atomic<int> err{0};

  auto read_range = [&](int64_t byte_start, int64_t byte_len, char* dst) {
    FILE* f = std::fopen(path, "rb");
    if (!f) { err.store(1); return; }
    if (std::fseek(f, static_cast<long>(byte_start), SEEK_SET) != 0) {
      err.store(2);
      std::fclose(f);
      return;
    }
    if (byte_len &&
        std::fread(dst, 1, static_cast<size_t>(byte_len), f) !=
            static_cast<size_t>(byte_len)) {
      err.store(3);
    }
    std::fclose(f);
  };

  std::vector<std::thread> workers;
  const int64_t chunk = (emb_bytes + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int64_t start = t * chunk;
    if (start >= emb_bytes) break;
    const int64_t len = std::min(chunk, emb_bytes - start);
    workers.emplace_back(read_range, emb_off + start, len,
                         reinterpret_cast<char*>(emb_out) + start);
  }
  for (auto& w : workers) w.join();
  if (err.load()) return err.load();

  read_range(emb_off + emb_bytes, rows * static_cast<int64_t>(sizeof(int64_t)),
             reinterpret_cast<char*>(ids_out));
  return err.load();
}

int convdr_read_block(const char* path, float* emb_out, int64_t* ids_out,
                      int64_t rows, int64_t dim, int num_threads) {
  return convdr_read_block_ex(path, emb_out, ids_out, rows, dim, 0,
                              num_threads);
}

// Candidate-proportional row gather: read only the listed rows from a flat
// row-major payload at `payload_off` inside `path` (a .cnb block past its
// 32-byte header, or a pickled numpy block past its located BINBYTES
// payload offset — retrieval/refine.py finds both). This is the disk-side
// half of FAISS IndexRefineFlat's random-access refine semantics
// (reference drivers/run_convdr_inference.py:353 reaches it through
// the faiss wheel): a rescore touches O(candidates) bytes, not O(corpus).
// Runs of consecutive row indices coalesce into single preads; the index
// list is split across threads. Thread-safe via pread (no shared offset).
int convdr_gather_rows(const char* path, int64_t payload_off,
                       int64_t row_bytes, const int64_t* row_idx, int64_t n,
                       void* out, int num_threads) {
  if (n == 0) return 0;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = static_cast<int>(n);
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return 1;
  std::atomic<int> err{0};

  auto gather_range = [&](int64_t lo, int64_t hi) {
    char* dst = reinterpret_cast<char*>(out) + lo * row_bytes;
    int64_t i = lo;
    while (i < hi && !err.load(std::memory_order_relaxed)) {
      int64_t run = 1;  // coalesce consecutive source rows into one pread
      while (i + run < hi && row_idx[i + run] == row_idx[i] + run) ++run;
      int64_t want = run * row_bytes;
      int64_t off = payload_off + row_idx[i] * row_bytes;
      char* p = dst;
      while (want > 0) {
        ssize_t got = ::pread(fd, p, static_cast<size_t>(want), off);
        if (got <= 0) { err.store(2); break; }
        p += got;
        off += got;
        want -= got;
      }
      dst += run * row_bytes;
      i += run;
    }
  };

  std::vector<std::thread> workers;
  const int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int t = 1; t < num_threads; ++t) {
    const int64_t lo = t * chunk;
    if (lo >= n) break;
    workers.emplace_back(gather_range, lo, std::min(n, lo + chunk));
  }
  gather_range(0, std::min(n, chunk));
  for (auto& w : workers) w.join();
  ::close(fd);
  return err.load();
}

// ---------------------------------------------------------------------------
// Token-cache split merge (reference layout: pid(8B BE) + len(4B BE) + ids)
// ---------------------------------------------------------------------------
int64_t convdr_merge_splits(const char** split_paths, int n_splits,
                            const char* out_path, int64_t record_bytes,
                            int64_t* pid_out, int64_t pid_capacity) {
  const int64_t full_record = 8 + record_bytes;
  FILE* out = std::fopen(out_path, "wb");
  if (!out) return -1;
  std::vector<char> buf(static_cast<size_t>(full_record));
  int64_t count = 0;
  for (int s = 0; s < n_splits; ++s) {
    FILE* in = std::fopen(split_paths[s], "rb");
    if (!in) { std::fclose(out); return -2; }
    while (true) {
      const size_t got = std::fread(buf.data(), 1, buf.size(), in);
      if (got == 0) break;
      if (got != buf.size()) { std::fclose(in); std::fclose(out); return -3; }
      if (count >= pid_capacity) { std::fclose(in); std::fclose(out); return -4; }
      uint64_t pid = 0;
      for (int b = 0; b < 8; ++b) {
        pid = (pid << 8) | static_cast<unsigned char>(buf[b]);
      }
      pid_out[count] = static_cast<int64_t>(pid);
      if (std::fwrite(buf.data() + 8, 1, static_cast<size_t>(record_bytes),
                      out) != static_cast<size_t>(record_bytes)) {
        std::fclose(in);
        std::fclose(out);
        return -5;
      }
      ++count;
    }
    std::fclose(in);
  }
  return std::fclose(out) == 0 ? count : -6;
}

// ---------------------------------------------------------------------------
// Exact 2-pointer top-k merge (sorted desc; list A wins ties)
// ---------------------------------------------------------------------------
void convdr_merge_topk(const float* sa, const int64_t* ia, const float* sb,
                       const int64_t* ib, int64_t nq, int64_t k, float* so,
                       int64_t* io) {
  for (int64_t q = 0; q < nq; ++q) {
    const float* ra_s = sa + q * k;
    const int64_t* ra_i = ia + q * k;
    const float* rb_s = sb + q * k;
    const int64_t* rb_i = ib + q * k;
    float* out_s = so + q * k;
    int64_t* out_i = io + q * k;
    int64_t p1 = 0, p2 = 0;
    for (int64_t o = 0; o < k; ++o) {
      if (p2 >= k || (p1 < k && ra_s[p1] >= rb_s[p2])) {
        out_s[o] = ra_s[p1];
        out_i[o] = ra_i[p1];
        ++p1;
      } else {
        out_s[o] = rb_s[p2];
        out_i[o] = rb_i[p2];
        ++p2;
      }
    }
  }
}

}  // extern "C"
