// Host routines of the port's file readers and writers: the sequential
// byte walks of Parquet's formats, which no data-parallel pass can do.
//
//   snappy            raw block compress / decompress (page codec)
//   rle_decode32      RLE / bit-packed hybrid stream -> int32 (levels)
//   bitunpack32       little-endian bit-packed ints -> int32
//   rle_runs          the hybrid stream's run headers only, as flat run
//                     descriptors; the values expand on the device
//   rle_hybrid_encode the writer's greedy RLE / bit-pack encoder
//   byte_array_walk   PLAIN BYTE_ARRAY: the 4-byte lengths' pointer chase
//                     -> (start, length) of every value; the chars are
//                     gathered on the device
//   delta_binary_*    DELTA_BINARY_PACKED (decode of any width, encode)
//   xxhash64_*, sbbf_insert  split-block bloom filters
//   multibyte_split   record offsets of a text split at a delimiter
//   avro_decode_block one Avro block's records -> columnar buffers (rows
//                     are varint-delimited: a value-at-a-time walk)
//   orc_byte_rle_runs ORC byte RLE (and boolean RLE under it): the run
//                     headers only; the bytes expand on the device
//   orc_rle2_runs     ORC integer RLEv2: the headers of SHORT_REPEAT,
//                     DIRECT, PATCHED_BASE and DELTA runs as flat run
//                     descriptors plus the patch list; values expand on
//                     the device
//   orc_rle1_decode   ORC integer RLEv1 (varint literals: decoded here)
//   orc_*_encode      the ORC writer's RLEv1, RLEv2 and byte RLE
//
// A plain C interface (loaded with ctypes by cudf_tpu_torch/io/_native.py);
// every function returns a count >= 0 or a negative error code.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline bool read_uvarint(const uint8_t* p, int64_t n, int64_t& pos, uint64_t& out) {
  out = 0;
  int shift = 0;
  while (pos < n) {
    uint8_t b = p[pos++];
    if (shift < 64) out |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) return true;
    shift += 7;
  }
  return false;
}

inline void put_uvarint(std::vector<uint8_t>& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back(static_cast<uint8_t>(v) | 0x80);
    v >>= 7;
  }
  out.push_back(static_cast<uint8_t>(v));
}

inline uint64_t zigzag(int64_t v) {
  return (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
}

inline int bit_length(uint64_t x) { return x ? 64 - __builtin_clzll(x) : 0; }

inline uint64_t width_mask(int bw) { return bw >= 64 ? ~0ull : ((1ull << bw) - 1); }

// --------------------------------------------------------------- snappy
void emit_literal(std::vector<uint8_t>& out, const uint8_t* p, uint32_t len) {
  uint32_t l = len - 1;
  if (l < 60) {
    out.push_back(static_cast<uint8_t>(l << 2));
  } else if (l < (1u << 8)) {
    out.push_back(60 << 2);
    out.push_back(static_cast<uint8_t>(l));
  } else {
    out.push_back(61 << 2);
    out.push_back(static_cast<uint8_t>(l));
    out.push_back(static_cast<uint8_t>(l >> 8));
  }
  out.insert(out.end(), p, p + len);
}

void emit_copy(std::vector<uint8_t>& out, uint32_t offset, uint32_t len) {
  // long matches as <= 64-byte copies with 2-byte offsets
  while (len > 0) {
    uint32_t l = len < 64 ? len : 64;
    out.push_back(static_cast<uint8_t>(((l - 1) << 2) | 2));
    out.push_back(static_cast<uint8_t>(offset));
    out.push_back(static_cast<uint8_t>(offset >> 8));
    len -= l;
  }
}

}  // namespace

extern "C" {

// Greedy hash-table LZ77 over 64 KiB fragments: literals and 2-byte-offset
// copies only, which every snappy decoder accepts.  `out` holds at least
// io_snappy_max_compressed(n) bytes.
int64_t io_snappy_max_compressed(int64_t n) { return 32 + n + n / 6 + 16; }

int64_t io_snappy_compress(const uint8_t* in, int64_t n, uint8_t* out_buf) {
  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(n) / 2 + 16);
  put_uvarint(out, static_cast<uint64_t>(n));
  constexpr size_t kFragment = 1 << 16;
  constexpr uint32_t kHashBits = 14;
  std::vector<int32_t> table(1u << kHashBits);
  for (size_t base = 0; base < static_cast<size_t>(n); base += kFragment) {
    size_t end = std::min(base + kFragment, static_cast<size_t>(n));
    size_t len = end - base;
    const uint8_t* frag = in + base;
    if (len < 16) {
      emit_literal(out, frag, static_cast<uint32_t>(len));
      continue;
    }
    std::fill(table.begin(), table.end(), -1);
    size_t i = 0, lit_start = 0, limit = len - 4;
    while (i <= limit) {
      uint32_t w;
      std::memcpy(&w, frag + i, 4);
      uint32_t h = (w * 0x1e35a7bdu) >> (32 - kHashBits);
      int32_t cand = table[h];
      table[h] = static_cast<int32_t>(i);
      if (cand >= 0) {
        uint32_t cw;
        std::memcpy(&cw, frag + cand, 4);
        if (cw == w) {
          size_t m = 4;
          while (i + m < len && frag[cand + m] == frag[i + m]) ++m;
          if (i > lit_start)
            emit_literal(out, frag + lit_start, static_cast<uint32_t>(i - lit_start));
          emit_copy(out, static_cast<uint32_t>(i - cand), static_cast<uint32_t>(m));
          i += m;
          lit_start = i;
          continue;
        }
      }
      ++i;
    }
    if (lit_start < len)
      emit_literal(out, frag + lit_start, static_cast<uint32_t>(len - lit_start));
  }
  std::memcpy(out_buf, out.data(), out.size());
  return static_cast<int64_t>(out.size());
}

// The uncompressed length a snappy block declares (-1: a bad preamble).
int64_t io_snappy_uncompressed_length(const uint8_t* in, int64_t n) {
  int64_t pos = 0;
  uint64_t ulen;
  if (!read_uvarint(in, n, pos, ulen)) return -1;
  return static_cast<int64_t>(ulen);
}

// Decompress into `out` (capacity `cap`); the bytes written, or -1 for a
// block that overruns its input, -2 for a bad copy offset, -3 when `out`
// is too small.
int64_t io_snappy_decompress(const uint8_t* p, int64_t n, uint8_t* out, int64_t cap) {
  int64_t pos = 0;
  uint64_t ulen;
  if (!read_uvarint(p, n, pos, ulen)) return -1;
  if (static_cast<int64_t>(ulen) > cap) return -3;
  int64_t w = 0;
  const int64_t end = static_cast<int64_t>(ulen);
  while (pos < n && w < end) {
    uint8_t tag = p[pos++];
    uint32_t type = tag & 0x3;
    if (type == 0) {
      uint32_t len = (tag >> 2) + 1;
      if (len > 60) {
        uint32_t nb = len - 60;
        if (pos + nb > n) return -1;
        len = 0;
        for (uint32_t i = 0; i < nb; ++i) len |= static_cast<uint32_t>(p[pos++]) << (8 * i);
        len += 1;
      }
      if (pos + len > n || w + len > end) return -1;
      std::memcpy(out + w, p + pos, len);
      pos += len;
      w += len;
    } else {
      uint32_t len, offset;
      if (type == 1) {
        if (pos + 1 > n) return -1;
        len = ((tag >> 2) & 0x7) + 4;
        offset = (static_cast<uint32_t>(tag >> 5) << 8) | p[pos++];
      } else if (type == 2) {
        if (pos + 2 > n) return -1;
        len = (tag >> 2) + 1;
        offset = static_cast<uint32_t>(p[pos]) | (static_cast<uint32_t>(p[pos + 1]) << 8);
        pos += 2;
      } else {
        if (pos + 4 > n) return -1;
        len = (tag >> 2) + 1;
        offset = static_cast<uint32_t>(p[pos]) | (static_cast<uint32_t>(p[pos + 1]) << 8) |
                 (static_cast<uint32_t>(p[pos + 2]) << 16) |
                 (static_cast<uint32_t>(p[pos + 3]) << 24);
        pos += 4;
      }
      if (offset == 0 || offset > w) return -2;
      if (w + len > end) return -1;
      int64_t src = w - offset;
      if (offset >= len) {
        std::memcpy(out + w, out + src, len);
      } else {
        for (uint32_t i = 0; i < len; ++i) out[w + i] = out[src + i];  // overlapping
      }
      w += len;
    }
  }
  return w;
}

// ------------------------------------------------------- RLE / bit-pack
int64_t io_bitunpack32(const uint8_t* p, int64_t n, int32_t bw, int64_t count, int32_t* out) {
  if (bw < 0 || bw > 32) return -1;
  uint64_t acc = 0;
  int nbits = 0;
  int64_t byte = 0;
  const uint64_t mask = width_mask(bw);
  for (int64_t i = 0; i < count; ++i) {
    while (nbits < bw) {
      uint8_t b = byte < n ? p[byte] : 0;
      acc |= static_cast<uint64_t>(b) << nbits;
      nbits += 8;
      ++byte;
    }
    out[i] = static_cast<int32_t>(acc & mask);
    acc >>= bw;
    nbits -= bw;
  }
  return count;
}

// Exactly `count` values (zeros past the stream's end); the bytes consumed.
int64_t io_rle_decode32(const uint8_t* p, int64_t n, int32_t bw, int64_t count, int32_t* out) {
  if (bw < 0 || bw > 32) return -1;
  int64_t pos = 0, w = 0;
  const int byte_width = (bw + 7) / 8;
  const uint64_t mask = width_mask(bw);
  while (w < count && pos < n) {
    uint64_t header;
    if (!read_uvarint(p, n, pos, header)) break;
    if (header & 1) {
      uint64_t nvals = (header >> 1) * 8;
      uint64_t acc = 0;
      int nbits = 0;
      int64_t start = pos;
      for (uint64_t i = 0; i < nvals && w < count; ++i) {
        while (nbits < bw) {
          uint8_t b = pos < n ? p[pos] : 0;
          ++pos;
          acc |= static_cast<uint64_t>(b) << nbits;
          nbits += 8;
        }
        out[w++] = static_cast<int32_t>(acc & mask);
        acc >>= bw;
        nbits -= bw;
      }
      pos = start + static_cast<int64_t>((nvals * bw + 7) / 8);
    } else {
      uint64_t run = header >> 1;
      uint32_t v = 0;
      for (int b = 0; b < byte_width && pos < n; ++b) v |= static_cast<uint32_t>(p[pos++]) << (8 * b);
      for (uint64_t i = 0; i < run && w < count; ++i) out[w++] = static_cast<int32_t>(v);
    }
  }
  for (; w < count; ++w) out[w] = 0;
  return std::min(pos, n);
}

// Run descriptors of a hybrid stream: run r makes values [starts[r],
// starts[r] + lengths[r]); an RLE run repeats payload[r], a bit-packed run
// (packed[r] = 1) reads its values from bit payload[r] of the stream.
// Returns the number of runs, or -1 when more than max_runs.
int64_t io_rle_runs(const uint8_t* p, int64_t n, int32_t bw, int64_t count, int64_t* starts,
                    int64_t* lengths, int64_t* payload, uint8_t* packed, int64_t max_runs) {
  int64_t pos = 0, out = 0, r = 0;
  const int nbytes = (bw + 7) / 8;
  while (out < count && pos < n) {
    uint64_t header;
    if (!read_uvarint(p, n, pos, header)) break;
    if (r >= max_runs) return -1;
    int64_t k;
    if (header & 1) {
      int64_t groups = static_cast<int64_t>(header >> 1);
      k = std::min(groups * 8, count - out);
      packed[r] = 1;
      payload[r] = pos * 8;
      pos += (groups * 8 * bw + 7) / 8;
    } else {
      k = std::min(static_cast<int64_t>(header >> 1), count - out);
      int64_t v = 0;
      for (int b = 0; b < nbytes && pos < n; ++b) v |= static_cast<int64_t>(p[pos++]) << (8 * b);
      packed[r] = 0;
      payload[r] = v;
    }
    starts[r] = out;
    lengths[r] = k;
    ++r;
    out += k;
  }
  return r;
}

// The writer's greedy hybrid encoder: a run of >= 8 equal values that
// starts on a group boundary is an RLE run, every other value goes to
// bit-packed groups of 8 (flushed once 504 are pending; the last group is
// padded with zeros past the stream's count).  Returns the bytes written
// (`out` holds at least 5 * n + 64 bytes).
int64_t io_rle_hybrid_encode(const int32_t* values, int64_t n, int32_t bw, uint8_t* out_buf) {
  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(n) + 64);
  const int byte_width = (bw + 7) / 8;
  std::vector<uint32_t> pend;
  auto flush = [&](bool final) {
    if (final)
      while (pend.size() % 8) pend.push_back(0);
    size_t groups = pend.size() / 8;
    if (!groups) return;
    put_uvarint(out, (static_cast<uint64_t>(groups) << 1) | 1);
    uint64_t acc = 0;
    int nbits = 0;
    for (size_t i = 0; i < groups * 8; ++i) {
      acc |= static_cast<uint64_t>(pend[i]) << nbits;
      nbits += bw;
      while (nbits >= 8) {
        out.push_back(static_cast<uint8_t>(acc & 0xFF));
        acc >>= 8;
        nbits -= 8;
      }
    }
    if (nbits) out.push_back(static_cast<uint8_t>(acc & 0xFF));
    pend.erase(pend.begin(), pend.begin() + groups * 8);
  };
  int64_t i = 0;
  while (i < n) {
    int32_t v = values[i];
    int64_t j = i + 1;
    while (j < n && values[j] == v) ++j;
    int64_t run = j - i;
    if (run >= 8 && pend.size() % 8 == 0) {
      flush(false);
      put_uvarint(out, static_cast<uint64_t>(run) << 1);
      uint32_t u = static_cast<uint32_t>(v);
      for (int b = 0; b < byte_width; ++b) out.push_back(static_cast<uint8_t>(u >> (8 * b)));
    } else {
      for (int64_t k = i; k < j; ++k) pend.push_back(static_cast<uint32_t>(values[k]));
      if (pend.size() >= 504) flush(false);
    }
    i = j;
  }
  flush(true);
  std::memcpy(out_buf, out.data(), out.size());
  return static_cast<int64_t>(out.size());
}

// ------------------------------------------------------- BYTE_ARRAY walk
// PLAIN BYTE_ARRAY: `count` values of a 4-byte little-endian length and
// its bytes.  Fills each value's start and length; returns the bytes
// consumed, or -1 when a value overruns the buffer.
int64_t io_byte_array_walk(const uint8_t* p, int64_t n, int64_t count, int64_t* starts,
                           int64_t* lens) {
  int64_t pos = 0;
  for (int64_t i = 0; i < count; ++i) {
    if (pos + 4 > n) return -1;
    uint32_t len;
    std::memcpy(&len, p + pos, 4);
    pos += 4;
    if (pos + static_cast<int64_t>(len) > n) return -1;
    starts[i] = pos;
    lens[i] = len;
    pos += len;
  }
  return pos;
}

// ------------------------------------------------- DELTA_BINARY_PACKED
// Decode at most `count` values (count < 0: the header's total) of any
// delta width into out; *consumed gets the stream's length.  Returns the
// values written, or -1 for a truncated stream.
int64_t io_delta_binary_decode(const uint8_t* p, int64_t n, int64_t count, int64_t* out,
                               int64_t* consumed) {
  int64_t pos = 0;
  uint64_t bs, mbs, total, zz;
  if (!read_uvarint(p, n, pos, bs) || !read_uvarint(p, n, pos, mbs) ||
      !read_uvarint(p, n, pos, total) || !read_uvarint(p, n, pos, zz))
    return -1;
  if (mbs == 0 || bs % mbs) return -1;
  int64_t first = static_cast<int64_t>((zz >> 1) ^ (~(zz & 1) + 1));
  int64_t want = count < 0 ? static_cast<int64_t>(total)
                           : std::min(count, static_cast<int64_t>(total));
  int64_t vpm = static_cast<int64_t>(bs / mbs);
  int64_t ndeltas = total ? static_cast<int64_t>(total) - 1 : 0;
  int64_t w = 0;
  uint64_t cur = static_cast<uint64_t>(first);
  if (want > 0) out[w++] = first;
  int64_t done = 0;
  while (done < ndeltas) {
    uint64_t mz;
    if (!read_uvarint(p, n, pos, mz)) return -1;
    uint64_t min_delta = (mz >> 1) ^ (~(mz & 1) + 1);
    if (pos + static_cast<int64_t>(mbs) > n) return -1;
    const uint8_t* widths = p + pos;
    pos += static_cast<int64_t>(mbs);
    for (uint64_t m = 0; m < mbs && done < ndeltas; ++m) {
      int bw = widths[m];
      if (bw > 64) return -1;
      int64_t take = std::min(vpm, ndeltas - done);
      int64_t base = pos * 8;
      for (int64_t i = 0; i < take; ++i) {
        uint64_t d = 0;
        int64_t bitpos = base + i * bw;
        for (int got = 0; got < bw;) {
          int64_t byte = (bitpos + got) >> 3;
          int off = static_cast<int>((bitpos + got) & 7);
          int k = std::min(8 - off, bw - got);
          uint64_t bits = byte < n ? (p[byte] >> off) & ((1u << k) - 1) : 0;
          d |= bits << got;
          got += k;
        }
        cur += d + min_delta;
        if (w < want) out[w++] = static_cast<int64_t>(cur);
      }
      pos += (vpm * bw + 7) / 8;
      done += take;
    }
  }
  *consumed = std::min(pos, n);
  return w;
}

// The writer's DELTA_BINARY_PACKED encoding: blocks of 128 deltas in 4
// miniblocks of 32, a zigzag min delta a block and a bit width a
// miniblock (wrapping int64 arithmetic).  `out` holds at least
// 64 + (ceil(n / 128) + 1) * 1040 bytes.  Returns the bytes written.
int64_t io_delta_binary_encode(const int64_t* v, int64_t n, uint8_t* out_buf) {
  std::vector<uint8_t> out;
  put_uvarint(out, 128);
  put_uvarint(out, 4);
  put_uvarint(out, static_cast<uint64_t>(n));
  put_uvarint(out, zigzag(n ? v[0] : 0));
  if (n > 1) {
    int64_t nd = n - 1;
    std::vector<uint64_t> adj(128);
    uint8_t packed[4][256];
    for (int64_t b0 = 0; b0 < nd; b0 += 128) {
      int64_t len = std::min<int64_t>(128, nd - b0);
      int64_t md = 0;
      for (int64_t k = 0; k < len; ++k) {
        int64_t d = static_cast<int64_t>(static_cast<uint64_t>(v[b0 + k + 1]) -
                                         static_cast<uint64_t>(v[b0 + k]));
        if (k == 0 || d < md) md = d;
      }
      put_uvarint(out, zigzag(md));
      std::fill(adj.begin(), adj.end(), 0);
      for (int64_t k = 0; k < len; ++k) {
        uint64_t d = static_cast<uint64_t>(v[b0 + k + 1]) - static_cast<uint64_t>(v[b0 + k]);
        adj[k] = d - static_cast<uint64_t>(md);
      }
      int widths[4];
      for (int m = 0; m < 4; ++m) {
        widths[m] = 0;
        if (m * 32 >= len) continue;
        for (int i = 0; i < 32; ++i) widths[m] = std::max(widths[m], bit_length(adj[m * 32 + i]));
        std::memset(packed[m], 0, sizeof(packed[m]));
        int bw = widths[m];
        for (int i = 0; i < 32 && bw; ++i) {
          uint64_t x = adj[m * 32 + i];
          int64_t bitpos = static_cast<int64_t>(i) * bw;
          for (int got = 0; got < bw;) {
            int64_t byte = (bitpos + got) >> 3;
            int off = static_cast<int>((bitpos + got) & 7);
            int k = std::min(8 - off, bw - got);
            packed[m][byte] |= static_cast<uint8_t>(((x >> got) & ((1u << k) - 1)) << off);
            got += k;
          }
        }
      }
      for (int m = 0; m < 4; ++m) out.push_back(static_cast<uint8_t>(widths[m]));
      for (int m = 0; m < 4; ++m)
        if (widths[m]) out.insert(out.end(), packed[m], packed[m] + 4 * widths[m]);
    }
  }
  std::memcpy(out_buf, out.data(), out.size());
  return static_cast<int64_t>(out.size());
}

// -------------------------------------------------------------- XXH64
}  // extern "C"

namespace {
constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint64_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t round1(uint64_t acc, uint64_t k) { return rotl(acc + k * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* p, int64_t n, uint64_t seed) {
  int64_t pos = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (pos + 32 <= n) {
      v1 = round1(v1, rd64(p + pos));
      v2 = round1(v2, rd64(p + pos + 8));
      v3 = round1(v3, rd64(p + pos + 16));
      v4 = round1(v4, rd64(p + pos + 24));
      pos += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) {
      h ^= round1(0, v);
      h = h * P1 + P4;
    }
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(n);
  while (pos + 8 <= n) {
    h ^= round1(0, rd64(p + pos));
    h = rotl(h, 27) * P1 + P4;
    pos += 8;
  }
  if (pos + 4 <= n) {
    h ^= rd32(p + pos) * P1;
    h = rotl(h, 23) * P2 + P3;
    pos += 4;
  }
  while (pos < n) {
    h ^= p[pos] * P5;
    h = rotl(h, 11) * P1;
    ++pos;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

const uint32_t SALT[8] = {0x47B6137Bu, 0x44974D91u, 0x8824AD5Bu, 0xA2B7289Du,
                          0x705495C7u, 0x2DF1424Bu, 0x9EFC4947u, 0x5C6BFB31u};
}  // namespace

extern "C" {

// XXH64 (seed 0) of n fixed-width values of `width` bytes each.
void io_xxhash64_fixed(const uint8_t* data, int64_t n, int32_t width, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = xxh64(data + i * width, width, 0);
}

// XXH64 (seed 0) of n byte strings chars[offsets[i]:offsets[i + 1]].
void io_xxhash64_var(const uint8_t* chars, const int64_t* offsets, int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = xxh64(chars + offsets[i], offsets[i + 1] - offsets[i], 0);
}

// Insert hashes into a split-block bloom bitset (32-byte blocks of eight
// little-endian u32 words, Parquet's SBBF).
void io_sbbf_insert(uint8_t* bitset, int64_t nbytes, const uint64_t* hashes, int64_t n) {
  uint64_t blocks = static_cast<uint64_t>(nbytes / 32);
  if (!blocks) return;
  for (int64_t k = 0; k < n; ++k) {
    uint64_t h = hashes[k];
    uint64_t block = ((h >> 32) * blocks) >> 32;
    uint32_t x = static_cast<uint32_t>(h);
    for (int i = 0; i < 8; ++i) {
      uint32_t bit = (x * SALT[i]) >> 27;
      uint8_t* word = bitset + block * 32 + 4 * i;
      uint32_t w;
      std::memcpy(&w, word, 4);
      w |= 1u << bit;
      std::memcpy(word, &w, 4);
    }
  }
}

}  // extern "C"

// -------------------------------------------------------------- text
extern "C" {

// Record start offsets of p split at every delimiter (left to right, not
// overlapping): 0, the position after each delimiter, and n when the last
// record has none.  With out == nullptr it only counts.
int64_t io_multibyte_split(const uint8_t* p, int64_t n, const uint8_t* delim, int64_t dlen,
                           int64_t* out) {
  int64_t k = 0, last = 0;
  auto put = [&](int64_t v) {
    if (out) out[k] = v;
    ++k;
  };
  put(0);
  if (dlen == 1) {
    const uint8_t* q = p;
    const uint8_t* end = p + n;
    while (q < end && (q = static_cast<const uint8_t*>(std::memchr(q, delim[0], end - q)))) {
      ++q;
      last = q - p;
      put(last);
    }
  } else if (dlen > 1) {
    for (int64_t i = 0; i + dlen <= n;) {
      if (p[i] == delim[0] && std::memcmp(p + i, delim, dlen) == 0) {
        i += dlen;
        last = i;
        put(i);
      } else {
        ++i;
      }
    }
  }
  if (last != n) put(n);
  return k;
}

// -------------------------------------------------------------- Avro
// One decompressed Avro block of `count` records into columnar buffers.
// desc: int32 (kind, null_branch, extra) triples a field; kinds 0 boolean,
// 1 int, 2 long, 3 float, 4 double, 5 bytes, 6 string, 7 enum index,
// 8 null, 9 fixed (extra = its size); null_branch the union's null index
// or -1.  outs: three pointers a field.  Fixed-width kinds: (values,
// unused, valid) with values 1 (boolean), 4 (int, enum, float) or 8 bytes
// (long, double) a record, none for kind 8.  bytes/string/fixed: (offsets
// int64[count + 1], chars of at least n bytes, valid).  valid: one byte a
// record.  Returns 0, or -1 for a malformed block.
int64_t io_avro_decode_block(const uint8_t* p, int64_t n, int64_t count, const int32_t* desc,
                             int32_t nf, void** outs) {
  int64_t pos = 0;
  bool ok = true;
  auto zigzag = [&]() -> int64_t {
    uint64_t u;
    if (!read_uvarint(p, n, pos, u)) {
      ok = false;
      return 0;
    }
    return static_cast<int64_t>((u >> 1) ^ (~(u & 1) + 1));
  };
  std::vector<int64_t> clen(static_cast<size_t>(nf), 0);
  for (int f = 0; f < nf; ++f) {
    int kind = desc[3 * f];
    if (kind == 5 || kind == 6 || kind == 9) static_cast<int64_t*>(outs[3 * f])[0] = 0;
  }
  for (int64_t row = 0; row < count && ok; ++row) {
    for (int f = 0; f < nf && ok; ++f) {
      const int kind = desc[3 * f], nb = desc[3 * f + 1], extra = desc[3 * f + 2];
      bool isnull = kind == 8;
      if (nb >= 0) {
        int64_t br = zigzag();
        if (br == nb) isnull = true;
        else if (br != (nb ^ 1)) ok = false;
        if (!ok) break;
      }
      static_cast<uint8_t*>(outs[3 * f + 2])[row] = isnull ? 0 : 1;
      void* vals = outs[3 * f];
      switch (kind) {
        case 0: {
          uint8_t v = 0;
          if (!isnull) {
            if (pos + 1 > n) { ok = false; break; }
            v = p[pos++];
          }
          static_cast<uint8_t*>(vals)[row] = v;
          break;
        }
        case 1:
        case 7:
          static_cast<int32_t*>(vals)[row] = isnull ? 0 : static_cast<int32_t>(zigzag());
          break;
        case 2:
          static_cast<int64_t*>(vals)[row] = isnull ? 0 : zigzag();
          break;
        case 3:
        case 4: {
          const int size = kind == 3 ? 4 : 8;
          uint8_t* dst = static_cast<uint8_t*>(vals) + row * size;
          if (isnull) {
            std::memset(dst, 0, size);
          } else {
            if (pos + size > n) { ok = false; break; }
            std::memcpy(dst, p + pos, size);
            pos += size;
          }
          break;
        }
        case 5:
        case 6:
        case 9: {
          int64_t& c = clen[static_cast<size_t>(f)];
          if (!isnull) {
            int64_t len = kind == 9 ? extra : zigzag();
            if (!ok || len < 0 || pos + len > n) { ok = false; break; }
            std::memcpy(static_cast<uint8_t*>(outs[3 * f + 1]) + c, p + pos, len);
            pos += len;
            c += len;
          }
          static_cast<int64_t*>(vals)[row + 1] = c;
          break;
        }
        case 8:
          break;
        default:
          ok = false;
      }
    }
  }
  return ok ? 0 : -1;
}

// -------------------------------------------------------------- ORC
}  // extern "C"

namespace {
const int ORC_W5[32] = {1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                        17, 18, 19, 20, 21, 22, 23, 24, 26, 28, 30, 32, 40, 48, 56, 64};

inline int64_t unzigzag(uint64_t u) { return static_cast<int64_t>((u >> 1) ^ (~(u & 1) + 1)); }

// `width` (<= 64) bits big-endian from bit `bitpos`; bytes past n read as 0
inline uint64_t read_be_bits(const uint8_t* p, int64_t n, int64_t bitpos, int width) {
  uint64_t v = 0;
  for (int k = 0; k < width; ++k, ++bitpos) {
    int64_t byte = bitpos >> 3;
    uint64_t bit = byte < n ? (p[byte] >> (7 - (bitpos & 7))) & 1 : 0;
    v = (v << 1) | bit;
  }
  return v;
}

int closest_width(int bits) {
  bits = std::max(bits, 1);
  for (int c = 0; c < 32; ++c)
    if (ORC_W5[c] >= bits) return c;
  return 31;
}

void put_be_bits(std::vector<uint8_t>& out, const uint64_t* v, int64_t m, int width) {
  uint64_t acc = 0;  // pending bits, most significant first
  int nacc = 0;
  for (int64_t i = 0; i < m; ++i) {
    for (int k = width - 1; k >= 0; --k) {
      acc = (acc << 1) | ((v[i] >> k) & 1);
      if (++nacc == 8) {
        out.push_back(static_cast<uint8_t>(acc));
        acc = 0;
        nacc = 0;
      }
    }
  }
  if (nacc) out.push_back(static_cast<uint8_t>(acc << (8 - nacc)));
}

inline void put_vslong(std::vector<uint8_t>& out, int64_t v) { put_uvarint(out, zigzag(v)); }

// the literal groups of the byte and RLEv1 encoders: 1..128 values after
// a count byte of 256 - size
template <typename Emit>
void flush_literals(std::vector<uint8_t>& out, std::vector<int64_t>& lit, Emit emit) {
  for (size_t j = 0; j < lit.size(); j += 128) {
    size_t g = std::min<size_t>(128, lit.size() - j);
    out.push_back(static_cast<uint8_t>(256 - g));
    for (size_t k = 0; k < g; ++k) emit(lit[j + k]);
  }
  lit.clear();
}

// runs of 3..130 equal values (emit_run) and literals (emit_literal), the
// greedy grouping of the byte RLE and RLEv1 encoders
template <typename T, typename Run, typename Lit>
void greedy_runs(const T* v, int64_t n, std::vector<uint8_t>& out, Run emit_run, Lit emit_lit) {
  std::vector<int64_t> lit;
  int64_t i = 0;
  while (i < n) {
    int64_t j = i + 1;
    while (j < n && j - i < 130 && v[j] == v[i]) ++j;
    if (j - i >= 3) {
      flush_literals(out, lit, emit_lit);
      emit_run(j - i, static_cast<int64_t>(v[i]));
    } else {
      for (int64_t k = i; k < j; ++k) lit.push_back(static_cast<int64_t>(v[k]));
      if (lit.size() >= 128) flush_literals(out, lit, emit_lit);
    }
    i = j;
  }
  flush_literals(out, lit, emit_lit);
}
}  // namespace

extern "C" {

// ORC byte RLE headers for `count` output bytes (count < 0: the whole
// stream): run r makes bytes [start[r], start[r] + len[r]), copied from
// input byte payload[r] when literal[r], else the byte payload[r]
// repeated.  Returns the runs, -1 when the stream overruns its bytes or
// cap, -2 when it ends early.
int64_t io_orc_byte_rle_runs(const uint8_t* p, int64_t n, int64_t count, int64_t* start,
                             int64_t* len, uint8_t* literal, int64_t* payload, int64_t cap) {
  const bool whole = count < 0;
  if (whole) count = INT64_MAX;
  int64_t pos = 0, w = 0, r = 0;
  while (w < count && pos < n) {
    if (r >= cap) return -1;
    uint8_t h = p[pos++];
    int64_t m = h < 128 ? h + 3 : 256 - h;
    int64_t take = std::min(m, count - w);
    start[r] = w;
    len[r] = take;
    if (h < 128) {
      if (pos >= n) return -1;
      literal[r] = 0;
      payload[r] = p[pos++];
    } else {
      if (pos + take > n) return -1;
      literal[r] = 1;
      payload[r] = pos;
      pos += m;
    }
    w += take;
    ++r;
  }
  return w < count && !whole ? -2 : r;
}

// ORC integer RLEv2 headers for `count` values (count < 0: the whole
// stream).  runs: [cap, 7] int64 rows
// (start, n, kind, width, bitpos, base, delta0); kind 0 SHORT_REPEAT (the
// value in base), 1 DIRECT (n values of `width` bits big-endian at bit
// bitpos of the stream, zigzagged when signed), 2 DELTA (base, delta0,
// then n - 2 deltas of `width` bits at bitpos, or width 0: every step
// delta0), 3 PATCHED_BASE (base + n values of `width` bits at bitpos, with
// the patch list's high bits or-ed in).  Patches: the output position and
// the bits to or into it.  Returns the runs; -1 overrun, -2 early end.
int64_t io_orc_rle2_runs(const uint8_t* p, int64_t nbytes, int64_t count, int32_t is_signed,
                         int64_t* runs, int64_t cap, int64_t* patch_pos, int64_t* patch_val,
                         int64_t patch_cap, int64_t* n_patches) {
  const bool whole = count < 0;
  if (whole) count = INT64_MAX;
  int64_t pos = 0, w = 0, r = 0, np_ = 0;
  while (w < count && pos < nbytes) {
    if (r >= cap) return -1;
    const uint8_t b0 = p[pos];
    const int mode = b0 >> 6;
    int64_t* run = runs + 7 * r;
    int64_t n = 0, kind = 0, width = 0, bitpos = 0, base = 0, delta0 = 0;
    if (mode == 0) {
      const int bw = ((b0 >> 3) & 7) + 1;
      n = (b0 & 7) + 3;
      if (pos + 1 + bw > nbytes) return -1;
      uint64_t v = 0;
      for (int k = 0; k < bw; ++k) v = (v << 8) | p[pos + 1 + k];
      pos += 1 + bw;
      base = is_signed ? unzigzag(v) : static_cast<int64_t>(v);
    } else {
      if (pos + 2 > nbytes) return -1;
      n = ((static_cast<int64_t>(b0 & 1) << 8) | p[pos + 1]) + 1;
      const int code = (b0 >> 1) & 0x1F;
      if (mode == 1) {
        kind = 1;
        width = ORC_W5[code];
        pos += 2;
        bitpos = pos * 8;
        pos += (n * width + 7) / 8;
      } else if (mode == 3) {
        kind = 2;
        width = code == 0 ? 0 : ORC_W5[code];
        pos += 2;
        uint64_t u;
        if (!read_uvarint(p, nbytes, pos, u)) return -1;
        base = is_signed ? unzigzag(u) : static_cast<int64_t>(u);
        if (!read_uvarint(p, nbytes, pos, u)) return -1;
        delta0 = unzigzag(u);
        bitpos = pos * 8;
        if (n > 2 && width) pos += ((n - 2) * width + 7) / 8;
      } else {
        kind = 3;
        width = ORC_W5[code];
        if (pos + 4 > nbytes) return -1;
        const uint8_t b2 = p[pos + 2], b3 = p[pos + 3];
        const int bw = ((b2 >> 5) & 7) + 1;
        const int pw = ORC_W5[b2 & 0x1F];
        const int gapbits = ((b3 >> 5) & 7) + 1;
        const int pll = b3 & 0x1F;
        pos += 4;
        if (pos + bw > nbytes) return -1;
        uint64_t ub = 0;
        for (int k = 0; k < bw; ++k) ub = (ub << 8) | p[pos + k];
        pos += bw;
        const uint64_t sign = 1ull << (bw * 8 - 1);
        base = (ub & sign) ? -static_cast<int64_t>(ub & (sign - 1)) : static_cast<int64_t>(ub);
        bitpos = pos * 8;
        pos += (n * width + 7) / 8;
        const int eb = ORC_W5[closest_width(gapbits + pw)];  // getClosestFixedBits
        const int64_t take = std::min(n, count - w);
        int64_t idx = 0;
        for (int e = 0; e < pll; ++e) {
          uint64_t entry = read_be_bits(p, nbytes, pos * 8 + static_cast<int64_t>(e) * eb, eb);
          idx += static_cast<int64_t>(entry >> pw);
          uint64_t patch = entry & (pw >= 64 ? ~0ull : ((1ull << pw) - 1));
          if (idx < take && patch) {
            if (np_ >= patch_cap) return -1;
            patch_pos[np_] = w + idx;
            patch_val[np_] = static_cast<int64_t>(width >= 64 ? 0 : patch << width);
            ++np_;
          }
        }
        pos += (static_cast<int64_t>(pll) * eb + 7) / 8;
      }
    }
    if (pos > nbytes) return -1;
    run[0] = w;
    run[1] = std::min(n, count - w);
    run[2] = kind;
    run[3] = width;
    run[4] = bitpos;
    run[5] = base;
    run[6] = delta0;
    w += run[1];
    ++r;
  }
  *n_patches = np_;
  return w < count && !whole ? -2 : r;
}

// ORC integer RLEv1: runs (3..130 values, a signed byte step, a base
// varint) and literal groups of varints, decoded into out (count < 0:
// the whole stream; out == nullptr: only counted).  Returns the values,
// or -1 for a truncated stream.
int64_t io_orc_rle1_decode(const uint8_t* p, int64_t n, int64_t count, int32_t is_signed,
                           int64_t* out) {
  if (count < 0) count = INT64_MAX;
  int64_t pos = 0, w = 0;
  while (w < count && pos < n) {
    uint8_t h = p[pos++];
    uint64_t u;
    if (h < 128) {
      if (pos >= n) return -1;
      const int64_t step = static_cast<int8_t>(p[pos++]);
      if (!read_uvarint(p, n, pos, u)) return -1;
      const int64_t v = is_signed ? unzigzag(u) : static_cast<int64_t>(u);
      const int64_t m = std::min<int64_t>(h + 3, count - w);
      if (out)
        for (int64_t k = 0; k < m; ++k) out[w + k] = v + step * k;
      w += m;
    } else {
      const int64_t m = std::min<int64_t>(256 - h, count - w);
      for (int64_t k = 0; k < m; ++k) {
        if (!read_uvarint(p, n, pos, u)) return -1;
        if (out) out[w + k] = is_signed ? unzigzag(u) : static_cast<int64_t>(u);
      }
      w += m;
    }
  }
  return w;
}

// The ORC writer's RLEv2: maximal fixed-step segments of at least 6
// values become DELTA runs of <= 512 (width 0; SHORT_REPEAT for 6..10
// equal values), the rest DIRECT runs of <= 512 at the closest width,
// never leaving a one-value tail.  `out` holds 11 * n + 64 bytes.
int64_t io_orc_rle2_encode(const int64_t* v, int64_t n, int32_t is_signed, uint8_t* out_buf) {
  std::vector<uint8_t> out;
  if (n == 0) return 0;
  std::vector<uint64_t> uz(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i)
    uz[i] = is_signed ? zigzag(v[i]) : static_cast<uint64_t>(v[i]);
  auto emit_direct = [&](int64_t lo, int64_t hi) {
    while (lo < hi) {
      int64_t m = std::min<int64_t>(512, hi - lo);
      if (hi - lo - m == 1) --m;
      uint64_t mx = 0;
      for (int64_t k = lo; k < lo + m; ++k) mx = std::max(mx, uz[k]);
      const int code = closest_width(bit_length(mx));
      const int hdr = (1 << 14) | (code << 9) | static_cast<int>(m - 1);
      out.push_back(static_cast<uint8_t>(hdr >> 8));
      out.push_back(static_cast<uint8_t>(hdr & 0xFF));
      put_be_bits(out, uz.data() + lo, m, ORC_W5[code]);
      lo += m;
    }
  };
  auto emit_run = [&](int64_t lo, int64_t hi) {
    const int64_t d = static_cast<int64_t>(static_cast<uint64_t>(v[lo + 1]) -
                                           static_cast<uint64_t>(v[lo]));
    if (d == 0 && hi - lo >= 3 && hi - lo <= 10) {
      const uint64_t u = uz[lo];
      const int nb = std::max((bit_length(u) + 7) / 8, 1);
      out.push_back(static_cast<uint8_t>(((nb - 1) << 3) | (hi - lo - 3)));
      for (int k = nb - 1; k >= 0; --k) out.push_back(static_cast<uint8_t>(u >> (8 * k)));
      return;
    }
    while (lo < hi) {
      int64_t m = std::min<int64_t>(512, hi - lo);
      if (hi - lo - m == 1) --m;
      if (m < 2) {
        emit_direct(lo, hi);
        return;
      }
      const int hdr = (3 << 14) | static_cast<int>(m - 1);
      out.push_back(static_cast<uint8_t>(hdr >> 8));
      out.push_back(static_cast<uint8_t>(hdr & 0xFF));
      if (is_signed) put_vslong(out, v[lo]);
      else put_uvarint(out, static_cast<uint64_t>(v[lo]));
      put_vslong(out, d);
      lo += m;
    }
  };
  if (n == 1) {
    emit_direct(0, 1);
  } else {
    auto diff = [&](int64_t i) { return static_cast<uint64_t>(v[i + 1]) - static_cast<uint64_t>(v[i]); };
    int64_t cursor = 0, s = 0;
    for (int64_t i = 1; i <= n - 1; ++i) {
      if (i != n - 1 && diff(i) == diff(i - 1)) continue;
      const int64_t e = i;  // the segment holds values s..e
      if (e - s + 1 >= 6) {
        const int64_t rs = std::max(s, cursor);
        if (e + 1 - rs >= 6) {
          if (rs > cursor) emit_direct(cursor, rs);
          emit_run(rs, e + 1);
          cursor = e + 1;
        }
      }
      s = i;
    }
    if (cursor < n) emit_direct(cursor, n);
  }
  std::memcpy(out_buf, out.data(), out.size());
  return static_cast<int64_t>(out.size());
}

// The ORC writer's RLEv1 (runs of 3..130 equal values with step 0, then
// literal groups of <= 128 varints).  `out` holds 11 * n + 64 bytes.
int64_t io_orc_rle1_encode(const int64_t* v, int64_t n, int32_t is_signed, uint8_t* out_buf) {
  std::vector<uint8_t> out;
  auto put = [&](int64_t x) {
    if (is_signed) put_vslong(out, x);
    else put_uvarint(out, static_cast<uint64_t>(x));
  };
  greedy_runs(v, n, out, [&](int64_t run, int64_t x) {
    out.push_back(static_cast<uint8_t>(run - 3));
    out.push_back(0);
    put(x);
  }, put);
  std::memcpy(out_buf, out.data(), out.size());
  return static_cast<int64_t>(out.size());
}

// The ORC writer's byte RLE.  `out` holds n + n / 128 + 16 bytes.
int64_t io_orc_byte_rle_encode(const uint8_t* v, int64_t n, uint8_t* out_buf) {
  std::vector<uint8_t> out;
  greedy_runs(v, n, out, [&](int64_t run, int64_t x) {
    out.push_back(static_cast<uint8_t>(run - 3));
    out.push_back(static_cast<uint8_t>(x));
  }, [&](int64_t x) { out.push_back(static_cast<uint8_t>(x)); });
  std::memcpy(out_buf, out.data(), out.size());
  return static_cast<int64_t>(out.size());
}

}  // extern "C"
