// Zstandard decoder (RFC 8878), written for the orbax checkpoint reader.
//
// The JAX package's checkpoints store every array as a zarr chunk that
// tensorstore compressed with zstd, inside OCDBT b-tree nodes that are
// zstd-compressed as well. This file decodes such frames with nothing but
// the C++ standard library:
//
//   * frames with and without a content size and window descriptor, the
//     dictionary id field (id 0 only), skippable frames, several frames
//     back to back;
//   * raw, RLE and compressed blocks;
//   * literals: raw, RLE, Huffman with one or four streams and treeless
//     (the previous block's Huffman table), Huffman weights given directly
//     or FSE-compressed;
//   * sequences with predefined, RLE, FSE-compressed and repeat tables and
//     the three repeat offsets;
//   * the content checksum (XXH64, low 32 bits), verified when present.
//
// Every bounds or format fault returns a negative error code (see
// zstd_error_name); nothing reads or writes outside the buffers it is given.
// The encoder (zstd_compress_raw) emits raw blocks only: a valid frame with
// its content size, which the checkpoint writer stores.
//
// The CRC-32C that OCDBT manifests and b-tree nodes end with is here too.
//
// C interface:
//   int64_t zstd_decompress(src, n, dst, cap)  -> bytes written or < 0
//   int64_t zstd_content_size(src, n)          -> size, -1 unknown, or < -1
//   int64_t zstd_compress_raw(src, n, dst, cap)-> bytes written or < 0
//   const char* zstd_error_name(code)
//   uint32_t convdr_crc32c(p, n, crc)

#include <cstdint>
#include <cstring>

namespace {

enum Err : int64_t {
  kUnknownSize = -1,
  kTruncated = -2,
  kBadMagic = -3,
  kReservedBit = -4,
  kDictionary = -5,
  kDstTooSmall = -6,
  kCorruptBlock = -7,
  kCorruptLiterals = -8,
  kCorruptHuffman = -9,
  kCorruptFse = -10,
  kCorruptSequences = -11,
  kBadOffset = -12,
  kChecksum = -13,
  kContentSize = -14,
  kNoPreviousTable = -15,
};

struct Fault {
  int64_t code;
};

[[noreturn]] void fail(int64_t code) { throw Fault{code}; }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, int64_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  while (p + 8 <= end) {
    h ^= xround(0, le64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(le32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- CRC-32C
struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int s = 1; s < 8; s++) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, int64_t n, uint32_t crc) {
  static const Crc32cTable tab;
  uint32_t c = ~crc;
  while (n >= 8) {
    uint64_t v = le64(p) ^ c;
    c = tab.t[7][v & 0xFF] ^ tab.t[6][(v >> 8) & 0xFF] ^ tab.t[5][(v >> 16) & 0xFF] ^
        tab.t[4][(v >> 24) & 0xFF] ^ tab.t[3][(v >> 32) & 0xFF] ^ tab.t[2][(v >> 40) & 0xFF] ^
        tab.t[1][(v >> 48) & 0xFF] ^ tab.t[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) c = (c >> 8) ^ tab.t[0][(c ^ *p++) & 0xFF];
  return ~c;
}

// ---------------------------------------------------------------- bit readers
// Backward bit stream (FSE, Huffman, sequences): the encoder appends fields
// LSB first; the decoder reads from the end. The last byte's highest set bit
// is padding. ``pos`` counts the bits not yet read; a field of n bits is bits
// [pos - n, pos) of the stream. Bits below the start read as zero, and
// ``pos`` may then go negative: the callers treat that as overflow.
struct BackBits {
  const uint8_t* p;
  int64_t len;
  int64_t pos;

  void init(const uint8_t* src, int64_t n, int64_t err) {
    if (n <= 0) fail(err);
    p = src;
    len = n;
    uint8_t last = src[n - 1];
    if (last == 0) fail(err);
    pos = (n - 1) * 8 + highbit(last);
  }
  // bits [start, start + n) of the stream for start >= 0, n <= 57
  inline uint64_t raw(int64_t start, int n) const {
    int64_t byte = start >> 3;
    int shift = int(start & 7);
    uint64_t v;
    if (byte + 8 <= len) {
      v = le64(p + byte);
    } else {
      v = 0;
      for (int64_t i = byte; i < len; i++) v |= uint64_t(p[i]) << (8 * (i - byte));
    }
    return (v >> shift) & ((n == 64) ? ~0ULL : ((1ULL << n) - 1));
  }
  inline uint64_t peek(int n) const {
    if (n == 0) return 0;
    if (pos >= 64) {  // the 8 bytes that end with bit pos - 1
      int64_t end = (pos + 7) >> 3;
      return (le64(p + end - 8) >> (pos - n - (end - 8) * 8)) & ((1ULL << n) - 1);
    }
    int64_t start = pos - n;
    if (start >= 0) return raw(start, n);
    if (pos <= 0) return 0;
    return raw(0, int(pos)) << (-start);
  }
  inline uint64_t read(int n) {
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }
};

// Forward bit reader for FSE table headers: fields LSB first.
struct FwdBits {
  const uint8_t* p;
  int64_t len;
  int64_t pos = 0;  // bits consumed
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++, pos++) {
      int64_t byte = pos >> 3;
      if (byte >= len) fail(kCorruptFse);
      v |= uint32_t((p[byte] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
  uint32_t peek(int n) const {
    FwdBits c = *this;
    uint32_t v = 0;
    for (int i = 0; i < n; i++, c.pos++) {
      int64_t byte = c.pos >> 3;
      uint32_t bit = byte < len ? (p[byte] >> (c.pos & 7)) & 1 : 0;
      v |= bit << i;
    }
    return v;
  }
};

// ---------------------------------------------------------------- FSE
struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = -1;  // -1: not set
  FseEntry e[1 << 9];
};

// Build a decoding table from normalized counts (-1 = "less than 1").
void fse_build(FseTable& t, const int16_t* norm, int nsym, int log) {
  int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      if (high < 0) fail(kCorruptFse);
      t.e[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, position = 0;
  for (int s = 0; s < nsym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      t.e[position].symbol = uint16_t(s);
      do {
        position = (position + step) & mask;
      } while (position > high);
    }
  }
  if (position != 0) fail(kCorruptFse);
  for (int u = 0; u < size; u++) {
    int s = t.e[u].symbol;
    uint32_t ns = next[s]++;
    if (ns == 0) fail(kCorruptFse);
    int nb = log - highbit(ns);
    t.e[u].nbits = uint8_t(nb);
    t.e[u].base = uint16_t((ns << nb) - size);
  }
  t.log = log;
}

// Read an FSE table description (normalized counts) at src; returns the
// bytes it took.
int64_t fse_read_ncount(FseTable& t, const uint8_t* src, int64_t n, int max_sym, int max_log) {
  FwdBits br{src, n};
  int log = int(br.read(4)) + 5;
  if (log > max_log) fail(kCorruptFse);
  int16_t norm[256];
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, sym = 0;
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      int n0 = sym;
      uint32_t rep;
      while ((rep = br.read(2)) == 3) n0 += 3;
      n0 += int(rep);
      if (n0 > max_sym) fail(kCorruptFse);
      while (sym < n0) norm[sym++] = 0;
      prev0 = false;
      continue;
    }
    if (sym > max_sym) fail(kCorruptFse);
    int maxv = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nbits - 1);
    if (int(low) < maxv) {
      count = int(low);
      br.read(nbits - 1);
    } else {
      count = int(br.peek(nbits) & (2 * threshold - 1));
      if (count >= threshold) count -= maxv;
      br.read(nbits);
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(kCorruptFse);
  fse_build(t, norm, sym, log);
  return (br.pos + 7) >> 3;
}

void fse_rle(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.e[0] = FseEntry{symbol, 0, 0};
}

// ---------------------------------------------------------------- Huffman
struct HufTable {
  int max_bits = 0;  // 0: no table yet
  uint16_t entry[1 << 11];  // symbol | bits << 8
};

// Decode the Huffman tree description at src; returns the bytes it took.
int64_t huf_read_table(HufTable& h, const uint8_t* src, int64_t n) {
  if (n < 1) fail(kCorruptHuffman);
  uint8_t weights[256];
  int nw = 0;
  int head = src[0];
  int64_t used;
  if (head >= 128) {
    nw = head - 127;
    used = 1 + (nw + 1) / 2;
    if (used > n) fail(kCorruptHuffman);
    for (int i = 0; i < nw; i++) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {
    used = 1 + head;
    if (used > n || head == 0) fail(kCorruptHuffman);
    FseTable t;
    int64_t hdr = fse_read_ncount(t, src + 1, head, 255, 6);
    if (hdr >= head) fail(kCorruptHuffman);
    BackBits bb;
    bb.init(src + 1 + hdr, head - hdr, kCorruptHuffman);
    uint32_t s1 = uint32_t(bb.read(t.log)), s2 = uint32_t(bb.read(t.log));
    if (bb.pos < 0) fail(kCorruptHuffman);
    for (;;) {
      if (nw > 253) fail(kCorruptHuffman);
      weights[nw++] = uint8_t(t.e[s1].symbol);
      s1 = t.e[s1].base + uint32_t(bb.read(t.e[s1].nbits));
      if (bb.pos < 0) {
        weights[nw++] = uint8_t(t.e[s2].symbol);
        break;
      }
      weights[nw++] = uint8_t(t.e[s2].symbol);
      s2 = t.e[s2].base + uint32_t(bb.read(t.e[s2].nbits));
      if (bb.pos < 0) {
        weights[nw++] = uint8_t(t.e[s1].symbol);
        break;
      }
    }
  }
  if (nw > 255) fail(kCorruptHuffman);
  uint32_t total = 0;
  for (int i = 0; i < nw; i++) {
    if (weights[i] > 11) fail(kCorruptHuffman);
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail(kCorruptHuffman);
  int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail(kCorruptHuffman);
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail(kCorruptHuffman);
  weights[nw++] = uint8_t(highbit(rest) + 1);
  // codes go to the lowest weights first, in symbol order within a weight
  uint32_t pos = 0;
  for (int w = 1; w <= max_bits; w++) {
    for (int s = 0; s < nw; s++) {
      if (weights[s] != w) continue;
      uint32_t span = 1u << (w - 1);
      if (pos + span > (1u << max_bits)) fail(kCorruptHuffman);
      uint16_t e = uint16_t(s | ((max_bits + 1 - w) << 8));
      for (uint32_t i = 0; i < span; i++) h.entry[pos + i] = e;
      pos += span;
    }
  }
  if (pos != (1u << max_bits)) fail(kCorruptHuffman);
  h.max_bits = max_bits;
  return used;
}

// One symbol: the next max_bits bits index the table.
inline void huf_symbol(const HufTable& h, BackBits& bb, uint8_t* out) {
  uint16_t e = h.entry[bb.peek(h.max_bits)];
  *out = uint8_t(e);
  bb.pos -= e >> 8;
}

// The same while at least 64 bits remain: no bounds branch.
inline void huf_symbol_fast(const HufTable& h, BackBits& bb, uint8_t* out) {
  int64_t end = (bb.pos + 7) >> 3;
  uint64_t v = le64(bb.p + end - 8) >> (bb.pos - h.max_bits - (end - 8) * 8);
  uint16_t e = h.entry[v & ((1u << h.max_bits) - 1)];
  *out = uint8_t(e);
  bb.pos -= e >> 8;
}

void huf_stream(const HufTable& h, const uint8_t* src, int64_t n, uint8_t* out, int64_t count) {
  BackBits bb;
  bb.init(src, n, kCorruptHuffman);
  int64_t i = 0;
  for (; i < count && bb.pos >= 64; i++) huf_symbol_fast(h, bb, out + i);
  for (; i < count; i++) huf_symbol(h, bb, out + i);
  if (bb.pos != 0) fail(kCorruptHuffman);
}

// Four streams decoded in lockstep (independent dependency chains): the
// first three give ``seg`` symbols each, the last ``last``.
void huf_4streams(const HufTable& h, const uint8_t* const* src, const int64_t* n, uint8_t* out,
                  int64_t seg, int64_t last) {
  BackBits b0, b1, b2, b3;
  b0.init(src[0], n[0], kCorruptHuffman);
  b1.init(src[1], n[1], kCorruptHuffman);
  b2.init(src[2], n[2], kCorruptHuffman);
  b3.init(src[3], n[3], kCorruptHuffman);
  uint8_t *o0 = out, *o1 = out + seg, *o2 = out + 2 * seg, *o3 = out + 3 * seg;
  int64_t i = 0;
  for (; i < last && b0.pos >= 64 && b1.pos >= 64 && b2.pos >= 64 && b3.pos >= 64; i++) {
    huf_symbol_fast(h, b0, o0 + i);
    huf_symbol_fast(h, b1, o1 + i);
    huf_symbol_fast(h, b2, o2 + i);
    huf_symbol_fast(h, b3, o3 + i);
  }
  for (; i < last; i++) {
    huf_symbol(h, b0, o0 + i);
    huf_symbol(h, b1, o1 + i);
    huf_symbol(h, b2, o2 + i);
    huf_symbol(h, b3, o3 + i);
  }
  for (; i < seg; i++) {
    huf_symbol(h, b0, o0 + i);
    huf_symbol(h, b1, o1 + i);
    huf_symbol(h, b2, o2 + i);
  }
  BackBits bb[4] = {b0, b1, b2, b3};
  for (int k = 0; k < 4; k++)
    if (bb[k].pos != 0) fail(kCorruptHuffman);
}

// ---------------------------------------------------------------- sequences
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,    4,    5,    6,     7,     8,     9,    10,   11,  12,  13,
                              14,   15,   16,   17,    18,    19,    20,   21,   22,  23,  24,
                              25,   26,   27,   28,    29,    30,    31,   32,   33,  34,  35,
                              37,   39,   41,   43,    47,    51,    59,   67,   83,  99,  131,
                              259,  515,  1027, 2051,  4099,  8195,  16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1,  1,  2,  2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3];
  uint8_t literals[1 << 17];
};

constexpr int64_t kBlockMax = 1 << 17;

// Read one sequence table (mode 0-3) at src; returns the bytes it took.
int64_t seq_table(FseTable& t, int mode, const int16_t* def, int ndef, int def_log, int max_sym,
                  int max_log, const uint8_t* src, int64_t n) {
  switch (mode) {
    case 0:
      fse_build(t, def, ndef, def_log);
      return 0;
    case 1:
      if (n < 1) fail(kCorruptSequences);
      if (src[0] > max_sym) fail(kCorruptSequences);
      fse_rle(t, src[0]);
      return 1;
    case 2:
      return fse_read_ncount(t, src, n, max_sym, max_log);
    default:
      if (t.log < 0) fail(kNoPreviousTable);
      return 0;
  }
}

// Decode one compressed block of ``n`` bytes into out[op...]; returns the
// new output position. Matches reach back to ``frame_start``, where the
// frame's output starts (no dictionary precedes it).
int64_t compressed_block(FrameState& st, const uint8_t* src, int64_t n, uint8_t* out, int64_t op,
                         int64_t cap, int64_t frame_start) {
  if (n < 1) fail(kCorruptBlock);
  // ---- literals
  int lt = src[0] & 3, sf = (src[0] >> 2) & 3;
  int64_t regen = 0, csize = 0, hdr = 0;
  int streams = 1;
  if (lt < 2) {
    if (sf == 0 || sf == 2) {
      hdr = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      hdr = 2;
      if (n < 2) fail(kCorruptLiterals);
      regen = (src[0] >> 4) + (int64_t(src[1]) << 4);
    } else {
      hdr = 3;
      if (n < 3) fail(kCorruptLiterals);
      regen = (src[0] >> 4) + (int64_t(src[1]) << 4) + (int64_t(src[2]) << 12);
    }
  } else {
    int bits;
    if (sf < 2) {
      hdr = 3;
      bits = 10;
      streams = sf == 0 ? 1 : 4;
    } else if (sf == 2) {
      hdr = 4;
      bits = 14;
      streams = 4;
    } else {
      hdr = 5;
      bits = 18;
      streams = 4;
    }
    if (n < hdr) fail(kCorruptLiterals);
    uint64_t v = 0;
    for (int i = 0; i < hdr; i++) v |= uint64_t(src[i]) << (8 * i);
    regen = int64_t((v >> 4) & ((1u << bits) - 1));
    csize = int64_t((v >> (4 + bits)) & ((1u << bits) - 1));
  }
  if (regen > kBlockMax) fail(kCorruptLiterals);
  const uint8_t* lit;
  int64_t ip = hdr;
  if (lt == 0) {
    if (ip + regen > n) fail(kCorruptLiterals);
    lit = src + ip;
    ip += regen;
  } else if (lt == 1) {
    if (ip + 1 > n) fail(kCorruptLiterals);
    std::memset(st.literals, src[ip], regen);
    lit = st.literals;
    ip += 1;
  } else {
    if (ip + csize > n) fail(kCorruptLiterals);
    const uint8_t* cs = src + ip;
    int64_t cn = csize;
    if (lt == 2) {
      int64_t t = huf_read_table(st.huf, cs, cn);
      cs += t;
      cn -= t;
    } else if (st.huf.max_bits == 0) {
      fail(kNoPreviousTable);
    }
    if (streams == 1) {
      huf_stream(st.huf, cs, cn, st.literals, regen);
    } else {
      if (cn < 6) fail(kCorruptLiterals);
      int64_t s1 = le16(cs), s2 = le16(cs + 2), s3 = le16(cs + 4);
      int64_t s4 = cn - 6 - s1 - s2 - s3;
      if (s4 < 1) fail(kCorruptLiterals);
      int64_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail(kCorruptLiterals);
      const uint8_t* p = cs + 6;
      const uint8_t* starts[4] = {p, p + s1, p + s1 + s2, p + s1 + s2 + s3};
      int64_t sizes[4] = {s1, s2, s3, s4};
      huf_4streams(st.huf, starts, sizes, st.literals, seg, regen - 3 * seg);
    }
    lit = st.literals;
    ip += csize;
  }
  // ---- sequences
  if (ip >= n) fail(kCorruptSequences);
  int64_t nseq;
  int b0 = src[ip];
  if (b0 < 128) {
    nseq = b0;
    ip += 1;
  } else if (b0 < 255) {
    if (ip + 2 > n) fail(kCorruptSequences);
    nseq = (int64_t(b0 - 128) << 8) + src[ip + 1];
    ip += 2;
  } else {
    if (ip + 3 > n) fail(kCorruptSequences);
    nseq = src[ip + 1] + (int64_t(src[ip + 2]) << 8) + 0x7F00;
    ip += 3;
  }
  const uint8_t* lit_end = lit + regen;
  if (nseq == 0) {
    if (ip != n) fail(kCorruptSequences);
    if (op + regen > cap) fail(kDstTooSmall);
    std::memcpy(out + op, lit, regen);
    return op + regen;
  }
  if (ip >= n) fail(kCorruptSequences);
  int modes = src[ip++];
  if (modes & 3) fail(kReservedBit);
  ip += seq_table(st.ll, modes >> 6, kLLDefault, 36, 6, 35, 9, src + ip, n - ip);
  if (ip > n) fail(kCorruptSequences);
  ip += seq_table(st.of, (modes >> 4) & 3, kOFDefault, 29, 5, 31, 8, src + ip, n - ip);
  if (ip > n) fail(kCorruptSequences);
  ip += seq_table(st.ml, (modes >> 2) & 3, kMLDefault, 53, 6, 52, 9, src + ip, n - ip);
  if (ip >= n) fail(kCorruptSequences);
  BackBits bb;
  bb.init(src + ip, n - ip, kCorruptSequences);
  uint32_t sll = uint32_t(bb.read(st.ll.log));
  uint32_t sof = uint32_t(bb.read(st.of.log));
  uint32_t sml = uint32_t(bb.read(st.ml.log));
  for (int64_t i = 0; i < nseq; i++) {
    int ofc = st.of.e[sof].symbol, llc = st.ll.e[sll].symbol, mlc = st.ml.e[sml].symbol;
    if (ofc > 31 || llc > 35 || mlc > 52) fail(kCorruptSequences);
    uint64_t ofv = (1ULL << ofc) + bb.read(ofc);
    uint64_t ml = kMLBase[mlc] + bb.read(kMLBits[mlc]);
    uint64_t ll = kLLBase[llc] + bb.read(kLLBits[llc]);
    if (bb.pos < 0) fail(kCorruptSequences);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      st.rep[2] = st.rep[1];
      st.rep[1] = st.rep[0];
      st.rep[0] = uint32_t(offset);
    } else {
      int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = st.rep[0];
      } else {
        offset = idx == 3 ? uint64_t(st.rep[0]) - 1 : st.rep[idx];
        if (offset == 0) fail(kBadOffset);
        if (idx != 1) st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = uint32_t(offset);
      }
    }
    if (ll > uint64_t(lit_end - lit)) fail(kCorruptSequences);
    if (uint64_t(op) + ll + ml > uint64_t(cap)) fail(kDstTooSmall);
    std::memcpy(out + op, lit, ll);
    lit += ll;
    op += int64_t(ll);
    if (offset > uint64_t(op - frame_start) || offset == 0) fail(kBadOffset);
    uint8_t* d = out + op;
    const uint8_t* s = d - offset;
    if (offset >= ml) {
      std::memcpy(d, s, ml);
    } else {
      for (uint64_t k = 0; k < ml; k++) d[k] = s[k];
    }
    op += int64_t(ml);
    if (i + 1 < nseq) {
      sll = st.ll.e[sll].base + uint32_t(bb.read(st.ll.e[sll].nbits));
      sml = st.ml.e[sml].base + uint32_t(bb.read(st.ml.e[sml].nbits));
      sof = st.of.e[sof].base + uint32_t(bb.read(st.of.e[sof].nbits));
      if (bb.pos < 0) fail(kCorruptSequences);
    }
  }
  if (bb.pos != 0) fail(kCorruptSequences);
  int64_t rest = lit_end - lit;
  if (op + rest > cap) fail(kDstTooSmall);
  std::memcpy(out + op, lit, rest);
  return op + rest;
}

constexpr uint32_t kMagic = 0xFD2FB528u;

struct Header {
  int64_t size;  // header bytes
  int64_t content;  // -1 unknown
  bool checksum;
};

Header frame_header(const uint8_t* src, int64_t n) {
  if (n < 5) fail(kTruncated);
  uint8_t fhd = src[4];
  int fcs_flag = fhd >> 6;
  bool single = (fhd >> 5) & 1;
  if (fhd & 8) fail(kReservedBit);
  int did_flag = fhd & 3;
  int64_t ip = 5;
  if (!single) ip += 1;  // window descriptor
  static const int kDid[4] = {0, 1, 2, 4};
  int did_bytes = kDid[did_flag];
  if (ip + did_bytes > n) fail(kTruncated);
  uint32_t did = 0;
  for (int i = 0; i < did_bytes; i++) did |= uint32_t(src[ip + i]) << (8 * i);
  if (did != 0) fail(kDictionary);
  ip += did_bytes;
  static const int kFcs[4] = {0, 2, 4, 8};
  int fcs_bytes = (fcs_flag == 0 && single) ? 1 : kFcs[fcs_flag];
  if (ip + fcs_bytes > n) fail(kTruncated);
  int64_t content = -1;
  if (fcs_bytes) {
    uint64_t v = 0;
    for (int i = 0; i < fcs_bytes; i++) v |= uint64_t(src[ip + i]) << (8 * i);
    if (fcs_bytes == 2) v += 256;
    if (v > uint64_t(INT64_MAX)) fail(kContentSize);
    content = int64_t(v);
  }
  ip += fcs_bytes;
  return Header{ip, content, bool((fhd >> 2) & 1)};
}

bool skippable(const uint8_t* src, int64_t n) {
  return n >= 4 && (le32(src) & 0xFFFFFFF0u) == 0x184D2A50u;
}

int64_t decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t ip = 0, op = 0;
  FrameState* st = nullptr;
  struct Free {
    FrameState*& p;
    ~Free() { delete p; }
  } guard{st};
  if (n == 0) fail(kTruncated);
  while (ip < n) {
    if (skippable(src + ip, n - ip)) {
      if (n - ip < 8) fail(kTruncated);
      int64_t sz = le32(src + ip + 4);
      if (sz > n - ip - 8) fail(kTruncated);
      ip += 8 + sz;
      continue;
    }
    if (n - ip < 4) fail(kTruncated);
    if (le32(src + ip) != kMagic) fail(kBadMagic);
    Header h = frame_header(src + ip, n - ip);
    ip += h.size;
    int64_t frame_start = op;
    if (!st) st = new FrameState;  // default-init: no zeroing of the buffers
    st->huf.max_bits = 0;
    st->ll.log = st->of.log = st->ml.log = -1;
    st->rep[0] = 1;
    st->rep[1] = 4;
    st->rep[2] = 8;
    for (;;) {
      if (n - ip < 3) fail(kTruncated);
      uint32_t bh = le24(src + ip);
      ip += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      int64_t size = bh >> 3;
      if (size > kBlockMax) fail(kCorruptBlock);
      if (type == 0) {
        if (size > n - ip) fail(kTruncated);
        if (op + size > cap) fail(kDstTooSmall);
        std::memcpy(dst + op, src + ip, size);
        ip += size;
        op += size;
      } else if (type == 1) {
        if (n - ip < 1) fail(kTruncated);
        if (op + size > cap) fail(kDstTooSmall);
        std::memset(dst + op, src[ip], size);
        ip += 1;
        op += size;
      } else if (type == 2) {
        if (size > n - ip) fail(kTruncated);
        op = compressed_block(*st, src + ip, size, dst, op, cap, frame_start);
        ip += size;
      } else {
        fail(kCorruptBlock);
      }
      if (last) break;
    }
    if (h.content >= 0 && op - frame_start != h.content) fail(kContentSize);
    if (h.checksum) {
      if (n - ip < 4) fail(kTruncated);
      uint32_t want = le32(src + ip);
      uint32_t got = uint32_t(xxh64(dst + frame_start, op - frame_start, 0));
      if (want != got) fail(kChecksum);
      ip += 4;
    }
  }
  return op;
}

}  // namespace

extern "C" {

int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  try {
    if (n < 0 || cap < 0) return kTruncated;
    return decompress(src, n, dst, cap);
  } catch (const Fault& f) {
    return f.code;
  } catch (...) {
    return kCorruptBlock;
  }
}

int64_t zstd_content_size(const uint8_t* src, int64_t n) {
  try {
    if (n < 4) return kTruncated;
    if (le32(src) != kMagic) return kBadMagic;
    return frame_header(src, n).content;
  } catch (const Fault& f) {
    return f.code;
  }
}

// One frame of raw blocks (at most 128 KiB each) with an 8-byte content
// size and a 128 KiB window; needs n + 14 + 3 * max(1, ceil(n / 128 KiB))
// bytes.
int64_t zstd_compress_raw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t nblocks = n == 0 ? 1 : (n + kBlockMax - 1) / kBlockMax;
  int64_t need = n + 14 + 3 * nblocks;
  if (n < 0 || cap < need) return kDstTooSmall;
  int64_t op = 0;
  uint32_t magic = kMagic;
  std::memcpy(dst, &magic, 4);
  dst[4] = 0xC0;  // 8-byte content size, window descriptor, no checksum
  dst[5] = (17 - 10) << 3;  // window 2^17
  uint64_t size = uint64_t(n);
  std::memcpy(dst + 6, &size, 8);
  op = 14;
  int64_t ip = 0;
  for (int64_t b = 0; b < nblocks; b++) {
    int64_t len = n - ip < kBlockMax ? n - ip : kBlockMax;
    uint32_t bh = uint32_t(len << 3) | (b + 1 == nblocks ? 1u : 0u);
    dst[op] = bh & 0xFF;
    dst[op + 1] = (bh >> 8) & 0xFF;
    dst[op + 2] = (bh >> 16) & 0xFF;
    std::memcpy(dst + op + 3, src + ip, len);
    op += 3 + len;
    ip += len;
  }
  return op;
}

const char* zstd_error_name(int64_t code) {
  switch (code) {
    case kUnknownSize: return "content_size_unknown";
    case kTruncated: return "truncated";
    case kBadMagic: return "bad_magic";
    case kReservedBit: return "reserved_bit_set";
    case kDictionary: return "dictionary_unsupported";
    case kDstTooSmall: return "dst_too_small";
    case kCorruptBlock: return "corrupt_block";
    case kCorruptLiterals: return "corrupt_literals";
    case kCorruptHuffman: return "corrupt_huffman";
    case kCorruptFse: return "corrupt_fse";
    case kCorruptSequences: return "corrupt_sequences";
    case kBadOffset: return "bad_offset";
    case kChecksum: return "checksum_mismatch";
    case kContentSize: return "content_size_mismatch";
    case kNoPreviousTable: return "no_previous_table";
    default: return "unknown_error";
  }
}

uint32_t convdr_crc32c(const uint8_t* p, int64_t n, uint32_t crc) { return crc32c(p, n, crc); }

}  // extern "C"
