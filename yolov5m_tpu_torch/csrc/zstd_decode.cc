// A zstd frame decoder (RFC 8878) that behaves as libzstd 1.5.7's
// ZSTD_decompressStream does under libtiff 4.7.1's ZSTDDecode loop: a
// fresh stream a chunk (ZSTDPreDecode's ZSTD_initDStream), the whole chunk
// as input and the chunk's decoded size as output, and the loop ends at a
// frame's end, at an error, when the output is full or when the input runs
// out. libtiff keeps the chunk only where the output is full and no error
// was raised. Where it refuses the chunk, it zeroes the output past the
// stream's output position, which an error leaves at 0 (the call returns
// before it moves): a chunk cut short keeps what was flushed, one that
// fails is all zeros.
//
// What the library does and this file follows:
// - the frame header (magic, descriptor, window, dictionary ID, content
//   size); a dictionary ID without a dictionary loaded is refused; legacy
//   frames (v0.5-v0.7 magic) go to the library's legacy streaming
//   decoders, which the second half of this file follows (v0.4 and older
//   are refused, as the library is built with legacy support down to
//   v0.5);
// - the single-pass shortcut: where the content size is known, fits the
//   output and the whole frame lies in the chunk, the frame is decoded
//   straight into the output (no window limit; where the library puts a
//   block's literals in the output past the block, as
//   ZSTD_allocateLiteralsBuffer may, the block must end before them);
// - otherwise the buffered stream: the window limit (2^27 + 1,
//   ZSTD_WINDOWLOG_LIMIT_DEFAULT), blocks decoded into the stream's own
//   ring buffer (ZSTD_decodingBufferSize_internal, restarted from its
//   start as ZSTD_decompressStream restarts it) and flushed to the output,
//   raw blocks streamed as their bytes arrive, at most one block decoded
//   past the one that fills the output;
// - raw, RLE and compressed blocks; raw, RLE, Huffman (one and four
//   streams) and treeless literals; predefined, RLE, FSE and repeat
//   sequence tables; repeat offsets; the content checksum (the low 32 bits
//   of XXH64); skippable frames;
// - the bit reader's arithmetic (BIT_DStream_t), so that a damaged stream
//   decodes to what the library decodes, and the Huffman decoders the
//   library picks (one or two symbols a lookup by HUF_selectDecoder; four
//   streams through its x86-64 loop, which reads a stream on past its
//   start and checks no stream's end).

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Fail {};

[[noreturn]] void fail() { throw Fail{}; }

inline uint32_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t rd24(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16);
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

constexpr uint32_t kMagic = 0xFD2FB528U;
constexpr uint32_t kSkippable = 0x184D2A50U;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0U;
constexpr size_t kBlockMax = 128 * 1024;
constexpr size_t kOverlength = 32;
constexpr uint64_t kUnknown = ~0ULL;
constexpr uint64_t kWindowLimit = (1ULL << 27) + 1;

// -- XXH64 --------------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t round64(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
inline uint64_t merge(uint64_t acc, uint64_t v) {
  acc ^= round64(0, v);
  return acc * P1 + P4;
}

struct Xxh64 {
  uint64_t v[4] = {P1 + P2, P2, 0, 0ULL - P1};
  uint64_t total = 0;
  uint8_t mem[32];
  size_t memsize = 0;

  void update(const uint8_t* p, size_t n) {
    total += n;
    if (memsize + n < 32) {
      std::memcpy(mem + memsize, p, n);
      memsize += n;
      return;
    }
    if (memsize) {
      std::memcpy(mem + memsize, p, 32 - memsize);
      for (int i = 0; i < 4; ++i) v[i] = round64(v[i], rd64(mem + 8 * i));
      p += 32 - memsize;
      n -= 32 - memsize;
      memsize = 0;
    }
    while (n >= 32) {
      for (int i = 0; i < 4; ++i) v[i] = round64(v[i], rd64(p + 8 * i));
      p += 32;
      n -= 32;
    }
    std::memcpy(mem, p, n);
    memsize = n;
  }

  uint64_t digest() const {
    uint64_t h;
    if (total >= 32) {
      h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
      for (int i = 0; i < 4; ++i) h = merge(h, v[i]);
    } else {
      h = v[2] + P5;
    }
    h += total;
    const uint8_t* p = mem;
    size_t n = memsize;
    while (n >= 8) {
      h ^= round64(0, rd64(p));
      h = rotl(h, 27) * P1 + P4;
      p += 8;
      n -= 8;
    }
    if (n >= 4) {
      h ^= static_cast<uint64_t>(rd32(p)) * P1;
      h = rotl(h, 23) * P2 + P3;
      p += 4;
      n -= 4;
    }
    while (n--) {
      h ^= (*p++) * P5;
      h = rotl(h, 11) * P1;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
  }
};

// -- the backward bit reader (bitstream.h) -------------------------------------

enum { kUnfinished = 0, kEndOfBuffer = 1, kCompleted = 2, kOverflow = 3 };

struct BitD {
  uint64_t c = 0;
  uint32_t consumed = 0;
  const uint8_t* ptr = nullptr;
  const uint8_t* start = nullptr;
  const uint8_t* limit = nullptr;
  bool overflowed = false;   // ptr moved to the library's zero-filled word

  // BIT_initDStream; false where the library returns an error
  bool init(const uint8_t* src, size_t n) {
    if (n < 1) {
      *this = BitD();
      return false;
    }
    start = src;
    limit = src + 8;
    overflowed = false;
    const uint8_t last = src[n - 1];
    if (n >= 8) {
      ptr = src + n - 8;
      c = rd64(ptr);
      consumed = last ? 8 - highbit(last) : 0;
      return last != 0;
    }
    ptr = src;
    c = 0;
    for (size_t i = 0; i < n; ++i) c |= static_cast<uint64_t>(src[i]) << (8 * i);
    consumed = last ? 8 - highbit(last) : 0;
    if (!last) return false;
    consumed += static_cast<uint32_t>(8 - n) * 8;
    return true;
  }
  // BIT_getMiddleBits through BIT_lookBits
  uint64_t look(uint32_t nb) const {
    const uint32_t s = (64 - consumed - nb) & 63;
    return (c >> s) & ((nb >= 64) ? ~0ULL : ((1ULL << nb) - 1));
  }
  uint64_t look_fast(uint32_t nb) const {
    return (c << (consumed & 63)) >> ((64 - nb) & 63);
  }
  uint64_t read(uint32_t nb) {
    const uint64_t v = look(nb);
    consumed += nb;
    return v;
  }
  uint64_t read_fast(uint32_t nb) {
    const uint64_t v = look_fast(nb);
    consumed += nb;
    return v;
  }
  int reload_internal() {
    ptr -= consumed >> 3;
    consumed &= 7;
    c = rd64(ptr);
    return kUnfinished;
  }
  int reload_fast() {
    if (overflowed || ptr < limit) return kOverflow;
    return reload_internal();
  }
  int reload() {
    if (consumed > 64) {
      overflowed = true;
      return kOverflow;
    }
    if (overflowed) return kOverflow;
    if (ptr >= limit) return reload_internal();
    if (ptr == start) return consumed < 64 ? kEndOfBuffer : kCompleted;
    uint32_t nbytes = consumed >> 3;
    int result = kUnfinished;
    if (ptr - nbytes < start) {
      nbytes = static_cast<uint32_t>(ptr - start);
      result = kEndOfBuffer;
    }
    ptr -= nbytes;
    consumed -= nbytes * 8;
    c = rd64(ptr);
    return result;
  }
  bool end() const { return !overflowed && ptr == start && consumed == 64; }
};

// -- FSE (entropy_common.c, fse_decompress.c) ---------------------------------

// FSE_readNCount: the header's length, or -1
int64_t read_ncount(int16_t* norm, unsigned* max_sv, unsigned* table_log,
                    const uint8_t* src, size_t n) {
  if (n < 8) {
    uint8_t buffer[8] = {0};
    std::memcpy(buffer, src, n);
    const int64_t got = read_ncount(norm, max_sv, table_log, buffer, 8);
    if (got < 0 || static_cast<size_t>(got) > n) return -1;
    return got;
  }
  const uint8_t* const istart = src;
  const uint8_t* const iend = src + n;
  const uint8_t* ip = src;
  const unsigned max_sv1 = *max_sv + 1;
  unsigned charnum = 0;
  bool previous0 = false;
  std::memset(norm, 0, max_sv1 * sizeof(int16_t));
  uint32_t bits = rd32(ip);
  int nb = (bits & 0xF) + 5;
  if (nb > 15) return -1;
  bits >>= 4;
  int count_bits = 4;
  *table_log = nb;
  int remaining = (1 << nb) + 1;
  int threshold = 1 << nb;
  nb++;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
      ip += count_bits >> 3;
      count_bits &= 7;
    } else {
      count_bits -= static_cast<int>(8 * (iend - 4 - ip));
      count_bits &= 31;
      ip = iend - 4;
    }
    bits = rd32(ip) >> count_bits;
  };
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~bits | 0x80000000U) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          count_bits -= static_cast<int>(8 * (iend - 7 - ip));
          count_bits &= 31;
          ip = iend - 4;
        }
        bits = rd32(ip) >> count_bits;
        repeats = __builtin_ctz(~bits | 0x80000000U) >> 1;
      }
      charnum += 3 * repeats;
      bits >>= 2 * repeats;
      count_bits += 2 * repeats;
      charnum += bits & 3;
      count_bits += 2;
      if (charnum >= max_sv1) break;
      advance();
    }
    {
      const int max = (2 * threshold - 1) - remaining;
      int count;
      if ((bits & (threshold - 1)) < static_cast<uint32_t>(max)) {
        count = bits & (threshold - 1);
        count_bits += nb - 1;
      } else {
        count = bits & (2 * threshold - 1);
        if (count >= threshold) count -= max;
        count_bits += nb;
      }
      count--;
      if (count >= 0) remaining -= count;
      else remaining += count;
      norm[charnum++] = static_cast<int16_t>(count);
      previous0 = !count;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nb = highbit(remaining) + 1;
        threshold = 1 << (nb - 1);
      }
      if (charnum >= max_sv1) break;
      advance();
    }
  }
  if (remaining != 1) return -1;
  if (charnum > max_sv1) return -1;
  if (count_bits > 32) return -1;
  *max_sv = charnum - 1;
  ip += (count_bits + 7) >> 3;
  return ip - istart;
}

// the spread of FSE_buildDTable_internal and ZSTD_buildFSETable: the
// symbol of each state, and the cells' next-state counters; false where
// the library's slow spread fails to come back to 0
bool spread(const int16_t* norm, unsigned max_sv, unsigned table_log,
            std::vector<uint8_t>& symbol, std::vector<uint16_t>& next,
            bool* fast_mode) {
  const uint32_t size = 1U << table_log;
  uint32_t high = size - 1;
  symbol.assign(size, 0);
  next.assign(max_sv + 1, 0);
  const int16_t large = static_cast<int16_t>(1 << (table_log - 1));
  *fast_mode = true;
  for (unsigned s = 0; s <= max_sv; ++s) {
    if (norm[s] == -1) {
      symbol[high--] = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      if (norm[s] >= large) *fast_mode = false;
      next[s] = static_cast<uint16_t>(norm[s]);
    }
  }
  const uint32_t mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
  uint32_t pos = 0;
  for (unsigned s = 0; s <= max_sv; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      symbol[pos] = static_cast<uint8_t>(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  return high != size - 1 ? pos == 0 : true;
}

struct FseCell {
  uint16_t state;
  uint8_t symbol, nbits;
};

struct FseTable {
  unsigned log = 0;
  bool fast = true;
  std::vector<FseCell> cells;
};

// FSE_buildDTable_internal
bool build_fse(FseTable& t, const int16_t* norm, unsigned max_sv,
               unsigned table_log) {
  if (max_sv > 255 || table_log > 12) return false;
  std::vector<uint8_t> symbol;
  std::vector<uint16_t> next;
  if (!spread(norm, max_sv, table_log, symbol, next, &t.fast)) return false;
  const uint32_t size = 1U << table_log;
  t.log = table_log;
  t.cells.resize(size);
  for (uint32_t u = 0; u < size; ++u) {
    const uint8_t s = symbol[u];
    const uint32_t ns = next[s]++;
    const uint8_t nbits = static_cast<uint8_t>(table_log - highbit(ns));
    t.cells[u] = {static_cast<uint16_t>((ns << nbits) - size), s, nbits};
  }
  return true;
}

// FSE_decompress_wksp_bmi2 for the Huffman weights (maxLog 6, the
// workspace of HUF_readStats_wksp); the symbols written, or -1
int64_t fse_decompress(uint8_t* dst, size_t cap, const uint8_t* src,
                       size_t n) {
  int16_t norm[256];
  unsigned max_sv = 255, table_log;
  const int64_t hsize = read_ncount(norm, &max_sv, &table_log, src, n);
  if (hsize < 0) return -1;
  if (table_log > 6) return -1;
  // FSE_DECOMPRESS_WKSP_SIZE(tableLog, maxSymbolValue) against the
  // workspace of FSE_DECOMPRESS_WKSP_SIZE_U32(6, HUF_TABLELOG_MAX - 1)
  auto wksp = [](unsigned log, unsigned sv) {
    const size_t dtable = 1 + (1U << log);
    const size_t build = (2 * (sv + 1) + (1U << log) + 8 + 3) / 4;
    return dtable + 1 + build + 256 / 2 + 1;
  };
  if (wksp(table_log, max_sv) > wksp(6, 11)) return -1;
  FseTable t;
  if (!build_fse(t, norm, max_sv, table_log)) return -1;
  src += hsize;
  n -= hsize;
  BitD bd;
  if (!bd.init(src, n)) return -1;
  uint8_t* op = dst;
  uint8_t* const omax = dst + cap;
  uint8_t* const olimit = omax - 3;
  uint32_t s1 = static_cast<uint32_t>(bd.read(t.log));
  bd.reload();
  uint32_t s2 = static_cast<uint32_t>(bd.read(t.log));
  bd.reload();
  if (bd.reload() == kOverflow) return -1;
  auto sym = [&](uint32_t& st) {
    const FseCell& cell = t.cells[st];
    const uint64_t low = t.fast ? bd.read_fast(cell.nbits) : bd.read(cell.nbits);
    st = cell.state + static_cast<uint32_t>(low);
    return cell.symbol;
  };
  for (; (bd.reload() == kUnfinished) & (op < olimit); op += 4) {
    op[0] = sym(s1);
    op[1] = sym(s2);
    op[2] = sym(s1);
    op[3] = sym(s2);
  }
  for (;;) {
    if (op > omax - 2) return -1;
    *op++ = sym(s1);
    if (bd.reload() == kOverflow) {
      *op++ = sym(s2);
      break;
    }
    if (op > omax - 2) return -1;
    *op++ = sym(s2);
    if (bd.reload() == kOverflow) {
      *op++ = sym(s1);
      break;
    }
  }
  return op - dst;
}

// -- Huffman (huf_decompress.c) -----------------------------------------------

// A DTable as HUF_readDTableX1_wksp or HUF_readDTableX2_wksp leaves it:
// type 0 (one symbol a lookup) or 1 (up to two), read log bits at a time
// (the code lengths' table log raised to HUF_DECODER_FAST_TABLELOG, 11).
struct HufTable {
  int type = 0;
  unsigned log = 0;
  std::vector<uint8_t> sym, nbits;           // one symbol a lookup
  std::vector<uint16_t> seq;                 // type 1: the lookup's symbols,
  std::vector<uint8_t> xbits, xlen;          // their bits and their count
};

// HUF_readStats, then the table of the given type; the header's length,
// or -1
int64_t read_huf(HufTable& t, const uint8_t* src, size_t n, int type) {
  uint8_t w[256 + 1];
  uint32_t rank[13] = {0};
  if (!n) return -1;
  size_t isize = src[0], osize;
  if (isize >= 128) {
    osize = isize - 127;
    isize = (osize + 1) / 2;
    if (isize + 1 > n) return -1;
    if (osize >= 256) return -1;
    for (size_t k = 0; k < osize; k += 2) {
      w[k] = src[1 + k / 2] >> 4;
      w[k + 1] = src[1 + k / 2] & 15;
    }
  } else {
    if (isize + 1 > n) return -1;
    const int64_t got = fse_decompress(w, 255, src + 1, isize);
    if (got < 0) return -1;
    osize = static_cast<size_t>(got);
  }
  uint32_t total = 0;
  for (size_t k = 0; k < osize; ++k) {
    if (w[k] > 12) return -1;
    rank[w[k]]++;
    total += (1U << w[k]) >> 1;
  }
  if (total == 0) return -1;
  const uint32_t log = highbit(total) + 1;
  if (log > 12) return -1;
  const uint32_t rest = (1U << log) - total;
  if ((1U << highbit(rest)) != rest) return -1;
  const uint32_t last = highbit(rest) + 1;
  w[osize] = static_cast<uint8_t>(last);
  rank[last]++;
  if (rank[1] < 2 || (rank[1] & 1)) return -1;
  const size_t nsym = osize + 1;
  // HUF_rescaleStats (X1) and X2's maxTableLog: at least 11 bits a lookup
  const uint32_t dlog = log < 11 ? 11 : log;
  const uint32_t scale = dlog - log;
  t.type = type;
  t.log = dlog;
  const uint32_t size = 1U << dlog;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  uint32_t pos = 0;
  for (uint32_t wt = 1; wt <= log; ++wt)
    for (size_t s = 0; s < nsym; ++s) {
      if (w[s] != wt) continue;
      const uint32_t len = 1U << (wt - 1 + scale);
      for (uint32_t k = 0; k < len; ++k) {
        t.sym[pos + k] = static_cast<uint8_t>(s);
        t.nbits[pos + k] = static_cast<uint8_t>(log + 1 - wt);
      }
      pos += len;
    }
  if (type == 1) {
    // HUF_fillDTableX2: a second symbol where its whole code fits the
    // lookup's bits after the first
    t.seq.assign(size, 0);
    t.xbits.assign(size, 0);
    t.xlen.assign(size, 0);
    for (uint32_t v = 0; v < size; ++v) {
      const uint32_t l1 = t.nbits[v];
      const uint32_t r = (v << l1) & (size - 1);
      const uint32_t l2 = t.nbits[r];
      if (l1 + l2 <= dlog) {
        t.seq[v] = static_cast<uint16_t>(t.sym[v] | (t.sym[r] << 8));
        t.xbits[v] = static_cast<uint8_t>(l1 + l2);
        t.xlen[v] = 2;
      } else {
        t.seq[v] = t.sym[v];
        t.xbits[v] = static_cast<uint8_t>(l1);
        t.xlen[v] = 1;
      }
    }
  }
  return static_cast<int64_t>(isize + 1);
}

inline uint8_t x1_sym(const HufTable& t, BitD& bd) {
  const uint64_t v = bd.look_fast(t.log);
  bd.consumed += t.nbits[v];
  return t.sym[v];
}

// HUF_decodeSymbolX2: two bytes written, the symbols decoded returned
inline uint32_t x2_sym(uint8_t* p, const HufTable& t, BitD& bd) {
  const uint64_t v = bd.look_fast(t.log);
  p[0] = static_cast<uint8_t>(t.seq[v]);
  p[1] = static_cast<uint8_t>(t.seq[v] >> 8);
  bd.consumed += t.xbits[v];
  return t.xlen[v];
}

// HUF_decodeStreamX1
void x1_stream(uint8_t* p, BitD& bd, uint8_t* pend, const HufTable& t) {
  if (pend - p > 3) {
    while ((bd.reload() == kUnfinished) & (p < pend - 3)) {
      p[0] = x1_sym(t, bd);
      p[1] = x1_sym(t, bd);
      p[2] = x1_sym(t, bd);
      p[3] = x1_sym(t, bd);
      p += 4;
    }
  } else {
    bd.reload();
  }
  while (p < pend) *p++ = x1_sym(t, bd);
}

// HUF_decodeStreamX2, HUF_decodeLastSymbolX2 at its end
void x2_stream(uint8_t* p, BitD& bd, uint8_t* pend, const HufTable& t) {
  if (pend - p >= 8) {
    if (t.log <= 11) {
      while ((bd.reload() == kUnfinished) & (p < pend - 9))
        for (int k = 0; k < 5; ++k) p += x2_sym(p, t, bd);
    } else {
      while ((bd.reload() == kUnfinished) & (p < pend - 7))
        for (int k = 0; k < 4; ++k) p += x2_sym(p, t, bd);
    }
  } else {
    bd.reload();
  }
  if (pend - p >= 2) {
    while ((bd.reload() == kUnfinished) & (p <= pend - 2)) p += x2_sym(p, t, bd);
    while (p <= pend - 2) p += x2_sym(p, t, bd);
  }
  if (p < pend) {
    const uint64_t v = bd.look_fast(t.log);
    p[0] = static_cast<uint8_t>(t.seq[v]);
    if (t.xlen[v] == 1) {
      bd.consumed += t.xbits[v];
    } else if (bd.consumed < 64) {
      bd.consumed += t.xbits[v];
      if (bd.consumed > 64) bd.consumed = 64;
    }
  }
}

void huf_stream(uint8_t* p, BitD& bd, uint8_t* pend, const HufTable& t) {
  if (t.type) x2_stream(p, bd, pend, t);
  else x1_stream(p, bd, pend, t);
}

// HUF_decompress1X1/1X2_usingDTable_internal
bool huf_1x(uint8_t* dst, size_t n, const uint8_t* src, size_t cn,
            const HufTable& t) {
  BitD bd;
  if (!bd.init(src, cn)) return false;
  huf_stream(dst, bd, dst + n, t);
  return bd.end();
}

// the four streams through HUF_decompress4X1/4X2_usingDTable_internal_fast
// (the library's x86-64 path: a loop of five lookups a stream while every
// stream has room, then each stream's tail read on down to the section's
// start, with no end-of-stream check); 1 kept, 0 refused, -1 not taken
int huf_4x_fast(uint8_t* dst, size_t n, const uint8_t* src, size_t cn,
                const HufTable& t) {
  if (n == 0) return -1;
  if (cn < 10) return 0;
  if (t.log != 11) return -1;
  const size_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  const size_t l4 = cn - (l1 + l2 + l3 + 6);
  const uint8_t* iend[4];
  iend[0] = src + 6;
  iend[1] = iend[0] + l1;
  iend[2] = iend[1] + l2;
  iend[3] = iend[2] + l3;
  if (l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8) return -1;
  if (l4 > cn) return 0;
  const uint8_t* ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8,
                          src + cn - 8};
  const size_t seg = (n + 3) / 4;
  uint8_t* op[4] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg};
  uint8_t* const oend = dst + n;
  if (op[3] >= oend) return -1;
  uint64_t bits[4];
  for (int k = 0; k < 4; ++k) {
    const uint8_t last = ip[k][7];
    const uint32_t used = last ? 8 - highbit(last) : 0;
    bits[k] = (rd64(ip[k]) | 1) << used;
  }
  const uint8_t* const ilowest = src;
  uint8_t* const ends[4] = {op[1], op[2], op[3], oend};
  auto reload = [&](int k) {
    const int ctz = __builtin_ctzll(bits[k]);
    ip[k] -= ctz >> 3;
    bits[k] = (rd64(ip[k]) | 1) << (ctz & 7);
  };
  for (;;) {
    size_t iters = static_cast<size_t>(ip[0] - ilowest) / 7;
    if (t.type == 0) {
      const size_t oiters = static_cast<size_t>(oend - op[3]) / 5;
      iters = iters < oiters ? iters : oiters;
    } else {
      for (int k = 0; k < 4; ++k) {
        const size_t oiters = static_cast<size_t>(ends[k] - op[k]) / 10;
        iters = iters < oiters ? iters : oiters;
      }
    }
    uint8_t* const olimit = op[3] + iters * 5;
    if (op[3] == olimit) break;
    bool crossed = false;
    for (int k = 1; k < 4; ++k) crossed |= ip[k] < ip[k - 1];
    if (crossed) break;
    do {
      if (t.type == 0) {
        for (int s = 0; s < 5; ++s)
          for (int k = 0; k < 4; ++k) {
            const uint32_t v = static_cast<uint32_t>(bits[k] >> 53);
            bits[k] <<= t.nbits[v];
            op[k][s] = t.sym[v];
          }
        for (int k = 0; k < 4; ++k) {
          op[k] += 5;
          reload(k);
        }
      } else {
        auto sym = [&](int k) {
          const uint32_t v = static_cast<uint32_t>(bits[k] >> 53);
          op[k][0] = static_cast<uint8_t>(t.seq[v]);
          op[k][1] = static_cast<uint8_t>(t.seq[v] >> 8);
          bits[k] <<= t.xbits[v];
          op[k] += t.xlen[v];
        };
        for (int s = 0; s < 5; ++s)
          for (int k = 0; k < 3; ++k) sym(k);
        sym(3);
        for (int k = 0; k < 4; ++k) {
          sym(3);
          reload(k);
        }
      }
    } while (op[3] < olimit);
  }
  uint8_t* seg_end = dst;
  for (int k = 0; k < 4; ++k) {
    if (seg <= static_cast<size_t>(oend - seg_end)) seg_end += seg;
    else seg_end = oend;
    if (op[k] > seg_end) return 0;
    if (ip[k] < iend[k] - 8) return 0;
    BitD bd;
    bd.c = rd64(ip[k]);
    bd.consumed = __builtin_ctzll(bits[k]);
    bd.start = ilowest;
    bd.limit = ilowest + 8;
    bd.ptr = ip[k];
    huf_stream(op[k], bd, seg_end, t);
  }
  return 1;
}

// HUF_decompress4X1/4X2_usingDTable_internal_body (the library's other
// path): lock-step loops, then each stream to its end, every stream checked
// at its end
bool huf_4x_body(uint8_t* dst, size_t n, const uint8_t* src, size_t cn,
                 const HufTable& t) {
  if (cn < 10 || n < 6) return false;
  const size_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  const size_t l4 = cn - (l1 + l2 + l3 + 6);
  const size_t seg = (n + 3) / 4;
  if (l4 > cn) return false;
  if (3 * seg > n) return false;
  const uint8_t* i1 = src + 6;
  BitD b[4];
  const uint8_t* starts[4] = {i1, i1 + l1, i1 + l1 + l2, i1 + l1 + l2 + l3};
  const size_t lens[4] = {l1, l2, l3, l4};
  for (int k = 0; k < 4; ++k)
    if (!b[k].init(starts[k], lens[k])) return false;
  uint8_t* op[4] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg};
  uint8_t* const oend = dst + n;
  if (static_cast<size_t>(oend - op[3]) >= 8) {
    bool going = true;
    if (t.type == 0) {
      uint8_t* const olimit = oend - 3;
      while (going && op[3] < olimit) {
        for (int r = 0; r < 4; ++r)
          for (int k = 0; k < 4; ++k) *op[k]++ = x1_sym(t, b[k]);
        for (int k = 0; k < 4; ++k)
          going &= b[k].reload_fast() == kUnfinished;
      }
    } else {
      uint8_t* const olimit = oend - 7;
      while (going && op[3] < olimit) {
        for (int k = 0; k < 4; ++k)
          for (int r = 0; r < 4; ++r) op[k] += x2_sym(op[k], t, b[k]);
        bool all = true;
        for (int k = 0; k < 4; ++k)
          all &= b[k].reload_fast() == kUnfinished;
        going = all;
      }
    }
  }
  if (op[0] > dst + seg || op[1] > dst + 2 * seg || op[2] > dst + 3 * seg)
    return false;
  huf_stream(op[0], b[0], dst + seg, t);
  huf_stream(op[1], b[1], dst + 2 * seg, t);
  huf_stream(op[2], b[2], dst + 3 * seg, t);
  huf_stream(op[3], b[3], oend, t);
  return b[0].end() && b[1].end() && b[2].end() && b[3].end();
}

bool huf_4x(uint8_t* dst, size_t n, const uint8_t* src, size_t cn,
            const HufTable& t) {
  const int fast = huf_4x_fast(dst, n, src, cn, t);
  if (fast >= 0) return fast == 1;
  return huf_4x_body(dst, n, src, cn, t);
}

// HUF_selectDecoder: 1 where the two-symbol table is expected to be faster
int select_decoder(size_t dst_size, size_t csize) {
  static const uint32_t times[16][2][2] = {
      {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},
      {{150, 216}, {381, 119}}, {{170, 205}, {514, 112}},
      {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}},
      {{221, 192}, {735, 107}}, {{256, 189}, {881, 106}},
      {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}},
      {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}},
      {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};
  const uint32_t q = csize >= dst_size
                         ? 15
                         : static_cast<uint32_t>(csize * 16 / dst_size);
  const uint32_t d256 = static_cast<uint32_t>(dst_size >> 8);
  const uint32_t t0 = times[q][0][0] + times[q][0][1] * d256;
  uint32_t t1 = times[q][1][0] + times[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// -- sequences (zstd_decompress_block.c) --------------------------------------

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10,  11,   12,   13,   14,    15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
    8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,   17,   18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28,  29,  30,  31,   32,   33,   34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 0x83, 0x103, 0x203, 0x403,
    0x803, 0x1003, 0x2003, 0x4003, 0x8003, 0x10003};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct SeqCell {
  uint16_t next;
  uint8_t add_bits, nbits;
  uint32_t base;
};

struct SeqTable {
  unsigned log = 0;
  std::vector<SeqCell> cells;
};

// a cell's base value and extra bits for symbol s of literal lengths
// (kind 0), match lengths (1) or offsets (2: OF_base, offset + 3 coded)
void set_symbol(SeqCell& c, unsigned s, int kind) {
  if (kind == 0) {
    c.base = kLLBase[s];
    c.add_bits = kLLBits[s];
  } else if (kind == 1) {
    c.base = kMLBase[s];
    c.add_bits = kMLBits[s];
  } else {
    c.base = s < 2 ? s : (1U << s) - 3;
    c.add_bits = static_cast<uint8_t>(s);
  }
}

void build_seq(SeqTable& t, const int16_t* norm, unsigned max_sv,
               unsigned table_log, int kind) {
  std::vector<uint8_t> symbol;
  std::vector<uint16_t> next;
  bool fast;
  spread(norm, max_sv, table_log, symbol, next, &fast);
  const uint32_t size = 1U << table_log;
  t.log = table_log;
  t.cells.resize(size);
  for (uint32_t u = 0; u < size; ++u) {
    const uint8_t s = symbol[u];
    const uint32_t ns = next[s]++;
    const uint8_t nbits = static_cast<uint8_t>(table_log - highbit(ns));
    SeqCell& c = t.cells[u];
    c.nbits = nbits;
    c.next = static_cast<uint16_t>((ns << nbits) - size);
    set_symbol(c, s, kind);
  }
}

struct Defaults {
  SeqTable ll, ml, of;
  Defaults() {
    build_seq(ll, kLLNorm, 35, 6, 0);
    build_seq(ml, kMLNorm, 52, 6, 1);
    build_seq(of, kOFNorm, 28, 5, 2);
  }
};

const Defaults& defaults() {
  static const Defaults d;
  return d;
}

// -- the decoder --------------------------------------------------------------

// a frame's parameters (ZSTD_frameHeader)
struct Frame {
  uint64_t fcs = kUnknown, window = 0;
  uint32_t block_max = 0, dict_id = 0;
  bool checksum = false, skippable = false;
};

struct Dctx : Frame {
  Xxh64 xxh;
  // entropy
  HufTable huf;
  bool huf_set = false;     // litEntropy
  bool fse_entropy = false;
  SeqTable ll_space, ml_space, of_space;
  const SeqTable *ll = nullptr, *ml = nullptr, *of = nullptr;
  uint32_t rep[3] = {1, 4, 8};
  // literals
  std::vector<uint8_t> lits;
  size_t lit_size = 0;
  // history (ZSTD_checkContinuity)
  const uint8_t* prefix = nullptr;
  const uint8_t* vstart = nullptr;
  const uint8_t* dict_end = nullptr;
  const uint8_t* prev_end = nullptr;

  void begin() {
    huf_set = fse_entropy = false;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
    prefix = vstart = dict_end = prev_end = nullptr;
    xxh = Xxh64();
  }

  void continuity(const uint8_t* dst, size_t cap) {
    if (dst != prev_end && cap > 0) {
      dict_end = prev_end;
      vstart = dst - (prev_end - prefix);
      prefix = dst;
      prev_end = dst;
    }
  }

  // ZSTD_decodeLiteralsBlock: the section's length, the literals in lits.
  // Where the library puts them in the output past the block
  // (ZSTD_allocateLiteralsBuffer's ZSTD_in_dst: one pass, with room to
  // spare), the block's sequences must end where they begin: *in_dst.
  size_t literals(const uint8_t* src, size_t n, size_t cap, bool streaming,
                  bool* in_dst) {
    if (n < 2) fail();
    const int type = src[0] & 3;
    const uint32_t lh = (src[0] >> 2) & 3;
    const size_t expected = cap < block_max ? cap : block_max;
    auto placed = [&](size_t lsize) {
      return !streaming && cap > block_max + 2 * kOverlength + lsize;
    };
    if (type == 2 || type == 3) {     // compressed, treeless
      if (type == 3 && !huf_set) fail();
      if (n < 5) fail();
      const uint32_t lhc = rd32(src);
      size_t hsize, lsize, csize;
      bool single = false;
      if (lh < 2) {
        single = lh == 0;
        hsize = 3;
        lsize = (lhc >> 4) & 0x3FF;
        csize = (lhc >> 14) & 0x3FF;
      } else if (lh == 2) {
        hsize = 4;
        lsize = (lhc >> 4) & 0x3FFF;
        csize = lhc >> 18;
      } else {
        hsize = 5;
        lsize = (lhc >> 4) & 0x3FFFF;
        csize = (lhc >> 22) + (static_cast<size_t>(src[4]) << 10);
      }
      if (lsize > block_max) fail();
      if (!single && lsize < 6) fail();
      if (csize + hsize > n) fail();
      if (expected < lsize) fail();
      *in_dst = placed(lsize);
      lits.resize(lsize + 16);
      uint8_t* out = lits.data();
      const uint8_t* hsrc = src + hsize;
      bool ok;
      if (type == 3) {
        ok = single ? huf_1x(out, lsize, hsrc, csize, huf)
                    : huf_4x(out, lsize, hsrc, csize, huf);
      } else if (single) {
        // HUF_decompress1X1_DCtx_wksp
        const int64_t th = read_huf(huf, hsrc, csize, 0);
        ok = th >= 0 && static_cast<size_t>(th) < csize &&
             huf_1x(out, lsize, hsrc + th, csize - th, huf);
      } else {
        // HUF_decompress4X_hufOnly_wksp
        ok = lsize != 0 && csize != 0;
        if (ok) {
          const int64_t th =
              read_huf(huf, hsrc, csize, select_decoder(lsize, csize));
          ok = th >= 0 && static_cast<size_t>(th) < csize &&
               huf_4x(out, lsize, hsrc + th, csize - th, huf);
        }
      }
      if (!ok) fail();
      lit_size = lsize;
      huf_set = true;
      return csize + hsize;
    }
    size_t hsize, lsize;
    if (lh == 0 || lh == 2) {
      hsize = 1;
      lsize = src[0] >> 3;
    } else if (lh == 1) {
      hsize = 2;
      if (type == 1 && n < 3) fail();
      lsize = rd16(src) >> 4;
    } else {
      hsize = 3;
      if (n < (type == 1 ? 4u : 3u)) fail();
      lsize = rd24(src) >> 4;
    }
    if (lsize > block_max) fail();
    if (expected < lsize) fail();
    *in_dst = placed(lsize);
    lit_size = lsize;
    if (type == 1) {                  // RLE
      lits.assign(lsize, src[hsize]);
      return hsize + 1;
    }
    if (hsize + lsize + kOverlength > n) {
      if (lsize + hsize > n) fail();
    } else {
      *in_dst = false;                // read where they lie in the block
    }
    lits.assign(src + hsize, src + hsize + lsize);
    return hsize + lsize;
  }

  // ZSTD_buildSeqTable
  size_t seq_table(SeqTable& space, const SeqTable*& ptr, int type,
                   unsigned max, unsigned max_log, const uint8_t* src,
                   size_t n, int kind, const SeqTable& def) {
    if (type == 1) {                         // RLE
      if (!n) fail();
      if (src[0] > max) fail();
      const unsigned s = src[0];
      space.log = 0;
      space.cells.assign(1, SeqCell{0, 0, 0, 0});
      set_symbol(space.cells[0], s, kind);
      ptr = &space;
      return 1;
    }
    if (type == 0) {
      ptr = &def;
      return 0;
    }
    if (type == 3) {
      if (!fse_entropy) fail();
      return 0;
    }
    int16_t norm[53];
    unsigned sv = max, log;
    const int64_t h = read_ncount(norm, &sv, &log, src, n);
    if (h < 0) fail();
    if (log > max_log) fail();
    build_seq(space, norm, sv, log, kind);
    ptr = &space;
    return static_cast<size_t>(h);
  }

  // ZSTD_decodeSeqHeaders
  size_t seq_headers(int* nseq, const uint8_t* src, size_t n) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    if (n < 1) fail();
    int nb = *ip++;
    if (nb > 0x7F) {
      if (nb == 0xFF) {
        if (ip + 2 > iend) fail();
        nb = rd16(ip) + 0x7F00;
        ip += 2;
      } else {
        if (ip >= iend) fail();
        nb = ((nb - 0x80) << 8) + *ip++;
      }
    }
    *nseq = nb;
    if (nb == 0) {
      if (ip != iend) fail();
      return ip - src;
    }
    if (ip + 1 > iend) fail();
    if (*ip & 3) fail();
    const int lt = *ip >> 6, ot = (*ip >> 4) & 3, mt = (*ip >> 2) & 3;
    ip++;
    const Defaults& d = defaults();
    ip += seq_table(ll_space, ll, lt, 35, 9, ip, iend - ip, 0, d.ll);
    ip += seq_table(of_space, of, ot, 31, 8, ip, iend - ip, 2, d.of);
    ip += seq_table(ml_space, ml, mt, 52, 9, ip, iend - ip, 1, d.ml);
    return ip - src;
  }

  size_t block(uint8_t* dst, size_t cap, const uint8_t* src, size_t n,
               bool streaming);
};

struct Seq {
  size_t lit, match, offset;
};

// ZSTD_execSequence and ZSTD_execSequenceEnd: their refusals (a sequence
// past the output, literals past the block's, an offset past the history)
// and their result. The library's wide copies also write past the
// sequence, into bytes a later sequence or block overwrites, and where a
// chunk fails libtiff zeroes them: plain copies give the same chunk.
size_t exec(uint8_t* op, uint8_t* const oend, Seq s, const uint8_t** lit,
            const uint8_t* const lit_limit, const uint8_t* prefix,
            const uint8_t* vstart, const uint8_t* dict_end) {
  const size_t total = s.lit + s.match;
  if (total > static_cast<size_t>(oend - op)) fail();
  if (s.lit > static_cast<size_t>(lit_limit - *lit)) fail();
  std::memmove(op, *lit, s.lit);
  op += s.lit;
  *lit += s.lit;
  size_t len = s.match;
  const uint8_t* match = op - s.offset;
  if (s.offset > static_cast<size_t>(op - prefix)) {
    // into the segment before the ring buffer restarted (extDict)
    if (s.offset > static_cast<size_t>(op - vstart)) fail();
    match = dict_end - (s.offset - static_cast<size_t>(op - prefix));
    const size_t first = static_cast<size_t>(dict_end - match) < len
                             ? static_cast<size_t>(dict_end - match)
                             : len;
    std::memmove(op, match, first);
    op += first;
    len -= first;
    match = prefix;
  }
  for (size_t i = 0; i < len; ++i) op[i] = match[i];   // may overlap
  return total;
}

size_t Dctx::block(uint8_t* dst, size_t cap, const uint8_t* src, size_t n,
                   bool streaming) {
  if (n > block_max) fail();
  bool in_dst = false;
  const size_t lh = literals(src, n, cap, streaming, &in_dst);
  const uint8_t* ip = src + lh;
  n -= lh;
  int nseq;
  const size_t sh = seq_headers(&nseq, ip, n);
  ip += sh;
  n -= sh;
  if (cap == 0 && nseq > 0) fail();
  uint8_t* const ostart = dst;
  uint8_t* const oend = dst + (in_dst ? block_max + kOverlength : cap);
  uint8_t* op = ostart;
  const uint8_t* lp = lits.data();
  const uint8_t* const lend = lp + lit_size;
  if (nseq) {
    fse_entropy = true;
    uint64_t prev[3] = {rep[0], rep[1], rep[2]};
    BitD bd;
    if (!bd.init(ip, n)) fail();
    uint32_t sll = static_cast<uint32_t>(bd.read(ll->log));
    bd.reload();
    uint32_t sof = static_cast<uint32_t>(bd.read(of->log));
    bd.reload();
    uint32_t sml = static_cast<uint32_t>(bd.read(ml->log));
    bd.reload();
    for (; nseq; --nseq) {
      const SeqCell& lc = ll->cells[sll];
      const SeqCell& mc = ml->cells[sml];
      const SeqCell& oc = of->cells[sof];
      Seq s{lc.base, mc.base, 0};
      const uint32_t llb = lc.add_bits, mlb = mc.add_bits, ofb = oc.add_bits;
      const uint32_t total_bits = llb + mlb + ofb;
      size_t offset;
      if (ofb > 1) {
        offset = oc.base + bd.read_fast(ofb);
        prev[2] = prev[1];
        prev[1] = prev[0];
        prev[0] = offset;
      } else {
        const uint32_t ll0 = lc.base == 0;
        if (ofb == 0) {
          offset = prev[ll0];
          prev[1] = prev[!ll0];
          prev[0] = offset;
        } else {
          offset = oc.base + ll0 + bd.read_fast(1);
          size_t temp = offset == 3 ? prev[0] - 1 : prev[offset];
          temp -= !temp;
          if (offset != 1) prev[2] = prev[1];
          prev[1] = prev[0];
          prev[0] = temp;
          offset = temp;
        }
      }
      // the library keeps the offset in a size_t and the history in U32s
      s.offset = offset;
      if (mlb > 0) s.match += bd.read_fast(mlb);
      if (total_bits >= 57 - (9 + 9 + 8)) bd.reload();
      if (llb > 0) s.lit += bd.read_fast(llb);
      if (nseq != 1) {
        sll = lc.next + static_cast<uint32_t>(bd.read(lc.nbits));
        sml = mc.next + static_cast<uint32_t>(bd.read(mc.nbits));
        sof = oc.next + static_cast<uint32_t>(bd.read(oc.nbits));
        bd.reload();
      }
      op += exec(op, oend, s, &lp, lend, prefix, vstart, dict_end);
    }
    if (!bd.end()) fail();
    rep[0] = static_cast<uint32_t>(prev[0]);
    rep[1] = static_cast<uint32_t>(prev[1]);
    rep[2] = static_cast<uint32_t>(prev[2]);
  }
  const size_t last = lend - lp;
  if (last > static_cast<size_t>(oend - op)) fail();
  if (op != nullptr) {
    std::memmove(op, lp, last);
    op += last;
  }
  return op - ostart;
}

struct Header {
  size_t size = 0;      // bytes, or the bytes still needed when short
  bool ok = false;      // parsed
  bool bad = false;     // refused
};

// ZSTD_getFrameHeader_advanced on n bytes
Header frame_header(Frame& d, const uint8_t* src, size_t n) {
  Header h;
  if (n < 5) {
    if (n > 0) {
      uint8_t buf[4];
      std::memcpy(buf, "\x28\xb5\x2f\xfd", 4);
      std::memcpy(buf, src, n < 4 ? n : 4);
      if (rd32(buf) != kMagic) {
        std::memcpy(buf, "\x50\x2a\x4d\x18", 4);
        std::memcpy(buf, src, n < 4 ? n : 4);
        if ((rd32(buf) & kSkippableMask) != kSkippable) {
          h.bad = true;
          return h;
        }
      }
    }
    h.size = 5;
    return h;
  }
  const uint32_t magic = rd32(src);
  if (magic != kMagic) {
    if ((magic & kSkippableMask) == kSkippable) {
      if (n < 8) {
        h.size = 8;
        return h;
      }
      d.fcs = rd32(src + 4);
      d.skippable = true;
      d.window = 0;
      d.block_max = 0;
      d.dict_id = magic - kSkippable;
      d.checksum = false;
      h.size = 8;
      h.ok = true;
      return h;
    }
    h.bad = true;
    return h;
  }
  const uint8_t fhd = src[4];
  const uint32_t did = fhd & 3, single = (fhd >> 5) & 1, fcs_id = fhd >> 6;
  static const size_t did_size[4] = {0, 1, 2, 4};
  static const size_t fcs_size[4] = {0, 2, 4, 8};
  const size_t fhsize =
      5 + !single + did_size[did] + fcs_size[fcs_id] + (single && !fcs_id);
  if (n < fhsize) {
    h.size = fhsize;
    return h;
  }
  if (fhd & 0x08) {
    h.bad = true;
    return h;
  }
  size_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    const uint8_t wl = src[pos++];
    const uint32_t wlog = (wl >> 3) + 10;
    if (wlog > 31) {
      h.bad = true;
      return h;
    }
    window = 1ULL << wlog;
    window += (window >> 3) * (wl & 7);
  }
  uint32_t dict_id = 0;
  if (did == 1) dict_id = src[pos];
  if (did == 2) dict_id = rd16(src + pos);
  if (did == 3) dict_id = rd32(src + pos);
  pos += did_size[did];
  uint64_t fcs = kUnknown;
  if (fcs_id == 0 && single) fcs = src[pos];
  if (fcs_id == 1) fcs = rd16(src + pos) + 256;
  if (fcs_id == 2) fcs = rd32(src + pos);
  if (fcs_id == 3) fcs = rd64(src + pos);
  if (single) window = fcs;
  d.fcs = fcs;
  d.window = window;
  d.block_max = static_cast<uint32_t>(window < kBlockMax ? window : kBlockMax);
  d.dict_id = dict_id;
  d.checksum = (fhd >> 2) & 1;
  d.skippable = false;
  h.size = fhsize;
  h.ok = true;
  return h;
}

// ZSTD_findFrameCompressedSize_advanced: the frame's bytes, or 0 (error)
size_t frame_size(const uint8_t* src, size_t n) {
  if (n >= 8 && (rd32(src) & kSkippableMask) == kSkippable) {
    const uint64_t s = static_cast<uint64_t>(rd32(src + 4)) + 8;
    return s <= n ? static_cast<size_t>(s) : 0;
  }
  Frame probe;
  const Header h = frame_header(probe, src, n);
  if (!h.ok) return 0;
  size_t pos = h.size, rest = n - h.size;
  for (;;) {
    if (rest < 3) return 0;
    const uint32_t bh = rd24(src + pos);
    const uint32_t type = (bh >> 1) & 3;
    if (type == 3) return 0;
    const size_t cb = type == 1 ? 1 : bh >> 3;
    if (3 + cb > rest) return 0;
    pos += 3 + cb;
    rest -= 3 + cb;
    if (bh & 1) break;
  }
  if (probe.checksum) {
    if (rest < 4) return 0;
    pos += 4;
  }
  return pos;
}

// the single-pass shortcut: ZSTD_decompressMultiFrame over one frame
void single_pass(Dctx& d, uint8_t* dst, size_t cap, const uint8_t* src,
                 size_t n) {
  d.begin();
  d.continuity(dst, cap);
  if (n < 6 + 3) fail();
  Frame tmp;
  const Header h = frame_header(tmp, src, n);
  if (!h.ok || n < h.size + 3) fail();
  frame_header(d, src, n);
  if (d.dict_id) fail();
  const uint8_t* ip = src + h.size;
  size_t rest = n - h.size;
  uint8_t* const ostart = dst;
  uint8_t* const oend = cap ? dst + cap : dst;
  uint8_t* op = dst;
  for (;;) {
    if (rest < 3) fail();
    const uint32_t bh = rd24(ip);
    const bool last = bh & 1;
    const uint32_t type = (bh >> 1) & 3;
    const size_t csize = type == 1 ? 1 : bh >> 3;
    if (type == 3) fail();
    ip += 3;
    rest -= 3;
    if (csize > rest) fail();
    size_t got;
    if (type == 2) {
      got = d.block(op, oend - op, ip, csize, false);
    } else if (type == 0) {
      if (csize > static_cast<size_t>(oend - op)) fail();
      std::memmove(op, ip, csize);
      got = csize;
    } else {
      const size_t rle = bh >> 3;
      if (rle > static_cast<size_t>(oend - op)) fail();
      std::memset(op, *ip, rle);
      got = rle;
    }
    if (d.checksum) d.xxh.update(op, got);
    op += got;
    ip += csize;
    rest -= csize;
    if (last) break;
  }
  if (d.fcs != kUnknown && static_cast<uint64_t>(op - ostart) != d.fcs) fail();
  if (d.checksum) {
    if (rest < 4) fail();
    if (rd32(ip) != static_cast<uint32_t>(d.xxh.digest())) fail();
  }
}

// ZSTD_decodingBufferSize_internal
size_t ring_size(uint64_t window, uint64_t fcs, size_t block_max) {
  size_t bs = window < kBlockMax ? static_cast<size_t>(window) : kBlockMax;
  if (block_max < bs) bs = block_max;
  const uint64_t need = window + 2 * bs + 2 * kOverlength;
  return static_cast<size_t>(fcs < need ? fcs : need);
}

// One ZSTD_decompressStream call on a fresh stream with the whole chunk
// (libtiff's loop never calls it twice: every return of the call leaves
// the input spent, the output full or the frame ended): the output
// position it reports. Throws Fail where it returns an error.
size_t stream_chunk(const uint8_t* src, size_t n, uint8_t* dst, size_t occ) {
  Dctx d;
  uint8_t* op = dst;
  uint8_t* const oend = dst + occ;
  // zdss_loadHeader (a legacy frame of five bytes or more has gone to the
  // legacy decoders before this; a shorter one is refused here)
  const Header h = frame_header(d, src, n);
  if (h.bad) fail();
  if (!h.ok) return 0;
  const uint8_t* ip = src + h.size;
  const uint8_t* const iend = src + n;
  if (d.fcs != kUnknown && !d.skippable && occ >= d.fcs) {
    const size_t csize = frame_size(src, n);
    if (csize && csize <= n) {
      single_pass(d, dst, occ, src, csize);
      return static_cast<size_t>(d.fcs);
    }
  }
  d.begin();
  if (d.skippable) return op - dst;    // skipped: nothing written
  if (d.dict_id) fail();                 // no dictionary loaded
  if (d.window < 1024) d.window = 1024;
  if (d.window > kWindowLimit) fail();
  const size_t ring = ring_size(d.window, d.fcs, d.block_max);
  // the buffer's bytes past where this chunk's output can reach are never
  // used: at most one block is decoded past a full output
  const size_t reach = occ + 2 * kBlockMax + 4 * kOverlength;
  const size_t used = ring < reach ? ring : reach;
  std::vector<uint8_t> buf(used + 2 * kOverlength);
  uint8_t* const out = buf.data();
  size_t out_start = 0;
  uint64_t decoded = 0;
  // zdss_flush of got bytes at out_start; false where the output is full
  auto flush = [&](size_t got) {
    const size_t room = oend - op;
    const size_t take = room < got ? room : got;
    std::memcpy(op, out + out_start, take);
    op += take;
    out_start += take;
    if (take < got) return false;
    if (ring < d.fcs && out_start + d.block_max > ring) out_start = 0;
    return true;
  };
  // ZSTDds_decompressLastBlock's end of frame
  auto frame_end = [&]() {
    if (d.fcs != kUnknown && decoded != d.fcs) fail();
  };
  for (;;) {
    if (iend - ip < 3) return op - dst;
    const uint32_t bh = rd24(ip);
    ip += 3;
    const bool last = bh & 1;
    const uint32_t type = (bh >> 1) & 3;
    if (type == 3) fail();
    const size_t csize = type == 1 ? 1 : bh >> 3;
    if (csize > d.block_max) fail();
    if (csize == 0) {
      if (last) break;                   // an empty last block
      continue;
    }
    if (type == 0) {
      // raw: streamed in pieces of what the input holds
      size_t left = csize;
      while (left) {
        if (ip == iend) return op - dst;
        const size_t avail = iend - ip;
        const size_t piece = avail < left ? avail : left;
        uint8_t* at = out + out_start;
        const size_t cap = ring - out_start;
        d.continuity(at, cap);
        if (piece > cap) fail();
        std::memmove(at, ip, piece);
        decoded += piece;
        if (d.checksum) d.xxh.update(at, piece);
        d.prev_end = at + piece;
        ip += piece;
        left -= piece;
        if (!left && last) frame_end();
        if (!flush(piece)) return occ;
      }
    } else {
      if (static_cast<size_t>(iend - ip) < csize) return op - dst;
      uint8_t* at = out + out_start;
      const size_t cap = ring - out_start;
      d.continuity(at, cap);
      size_t got;
      if (type == 2) {
        // a block that writes past the buffer's used part writes past its
        // block size too: refused either way
        const size_t room = used - out_start;
        got = d.block(at, cap < room ? cap : room, ip, csize, true);
      } else {
        got = bh >> 3;
        if (got > cap) fail();
        if (got > d.block_max) fail();
        std::memset(at, *ip, got);
      }
      if (got > d.block_max) fail();
      decoded += got;
      if (d.checksum) d.xxh.update(at, got);
      d.prev_end = at + got;
      ip += csize;
      if (last) frame_end();
      if (got && !flush(got)) return occ;
    }
    if (last) break;
  }
  if (d.checksum) {
    if (iend - ip < 4) return op - dst;
    if (rd32(ip) != static_cast<uint32_t>(d.xxh.digest())) fail();
  }
  return op - dst;
}


// -- legacy frames: zstd_v05.c, zstd_v06.c and zstd_v07.c ---------------------
//
// libzstd 1.5.7 (built with legacy support down to v0.5) hands a chunk that
// starts with the v0.5, v0.6 or v0.7 magic to that version's streaming
// decoder (ZBUFFv0x_decompressContinue), through ZSTD_decompressLegacyStream,
// with the whole chunk as input and the chunk's output. The legacy decoders
// are older code than the v1 decoder above: their own bit reader (reads past
// a stream's start see zeros), FSE and Huffman tables (the two-symbol table
// always at the table's full log, 12), readNCount, sequence formats and
// repeat offsets. What they share with the v1 decoder: the symbol spread of
// FSE tables, XXH64 and the byte readers.
//
// What the call leaves: the decoder decodes a block into its own buffer (a
// ring of the window and a block, restarted at its start where a block no
// longer fits) and copies it to the output; it stops where the output is
// full (after decoding one more block), where the input runs out or where
// the frame ends (an end block, or a block of size 0). On an error the
// library adds the whole output to the output position (the legacy call
// never reports how far it got), so libtiff zeroes nothing: the output keeps
// what was flushed and, past it, what it held. The stream's legacy context
// (its buffers' sizes) lives on from chunk to chunk of one image while the
// version stays.

namespace legacy {

constexpr uint32_t kMagic5 = 0xFD2FB525U, kMagic7 = 0xFD2FB527U;
constexpr size_t kBlock = 128 * 1024;
constexpr size_t kWild = 8;           // WILDCOPY_OVERLENGTH of all three

// BITv0x_DStream_t: the v1 reader (its start, its fast reads, its end)
// until a read passes the stream's start; then these readers shift zeros
// in where the v1 reader wraps, and a reload past the start leaves the
// pointer where it was
struct Bits : BitD {
  uint64_t look(uint32_t nb) const {
    return ((c << (consumed & 63)) >> 1) >> ((63 - nb) & 63);
  }
  uint64_t read(uint32_t nb) {
    const uint64_t v = look(nb);
    consumed += nb;
    return v;
  }
  int reload() {
    if (consumed > 64) return kOverflow;
    if (ptr >= limit) return reload_internal();
    if (ptr == start) return consumed < 64 ? kEndOfBuffer : kCompleted;
    uint32_t nbytes = consumed >> 3;
    int result = kUnfinished;
    if (ptr - nbytes < start) {
      nbytes = static_cast<uint32_t>(ptr - start);
      result = kEndOfBuffer;
    }
    ptr -= nbytes;
    consumed -= nbytes * 8;
    c = rd64(ptr);
    return result;
  }
};

// FSEv0x_readNCount: the header's length, or -1
int64_t read_ncount(int16_t* norm, unsigned* max_sv, unsigned* table_log,
                    const uint8_t* src, size_t n) {
  if (n < 4) return -1;
  const uint8_t* const iend = src + n;
  const uint8_t* ip = src;
  unsigned charnum = 0;
  bool previous0 = false;
  uint32_t bits = rd32(ip);
  int nb = (bits & 0xF) + 5;
  if (nb > 15) return -1;
  bits >>= 4;
  int count_bits = 4;
  *table_log = nb;
  int remaining = (1 << nb) + 1;
  int threshold = 1 << nb;
  nb++;
  while (remaining > 1 && charnum <= *max_sv) {
    if (previous0) {
      unsigned n0 = charnum;
      while ((bits & 0xFFFF) == 0xFFFF) {
        n0 += 24;
        if (ip < iend - 5) {
          ip += 2;
          bits = rd32(ip) >> count_bits;
        } else {
          bits >>= 16;
          count_bits += 16;
        }
      }
      while ((bits & 3) == 3) {
        n0 += 3;
        bits >>= 2;
        count_bits += 2;
      }
      n0 += bits & 3;
      count_bits += 2;
      if (n0 > *max_sv) return -1;
      while (charnum < n0) norm[charnum++] = 0;
      if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
        ip += count_bits >> 3;
        count_bits &= 7;
        bits = rd32(ip) >> count_bits;
      } else {
        bits >>= 2;
      }
    }
    {
      const int16_t max = static_cast<int16_t>((2 * threshold - 1) - remaining);
      int16_t count;
      if ((bits & (threshold - 1)) < static_cast<uint32_t>(max)) {
        count = static_cast<int16_t>(bits & (threshold - 1));
        count_bits += nb - 1;
      } else {
        count = static_cast<int16_t>(bits & (2 * threshold - 1));
        if (count >= threshold) count = static_cast<int16_t>(count - max);
        count_bits += nb;
      }
      count--;
      remaining -= count < 0 ? -count : count;
      norm[charnum++] = count;
      previous0 = !count;
      while (remaining < threshold && threshold > 1) {
        nb--;
        threshold >>= 1;
      }
      if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
        ip += count_bits >> 3;
        count_bits &= 7;
      } else {
        count_bits -= static_cast<int>(8 * (iend - 4 - ip));
        ip = iend - 4;
      }
      bits = rd32(ip) >> (count_bits & 31);
    }
  }
  if (remaining != 1) return -1;
  *max_sv = charnum - 1;
  ip += (count_bits + 7) >> 3;
  if (static_cast<size_t>(ip - src) > n) return -1;
  return ip - src;
}

// an FSE decoding table (FSEv0x_DTable): its log, fast mode and cells
struct Fse {
  unsigned log = 0;
  bool fast = true;
  std::vector<FseCell> cells = std::vector<FseCell>(1);
};

// FSEv0x_buildDTable: false on its errors (the table left as it was)
bool build(Fse& t, const int16_t* norm, unsigned max_sv, unsigned log) {
  if (max_sv > 255 || log > 12) return false;
  std::vector<uint8_t> symbol;
  std::vector<uint16_t> next;
  bool fast;
  if (!spread(norm, max_sv, log, symbol, next, &fast)) return false;
  const uint32_t size = 1U << log;
  t.log = log;
  t.fast = fast;
  t.cells.resize(size);
  for (uint32_t u = 0; u < size; ++u) {
    const uint8_t s = symbol[u];
    const uint32_t ns = next[s]++;
    const uint8_t nbits = static_cast<uint8_t>(log - highbit(ns));
    t.cells[u] = {static_cast<uint16_t>((ns << nbits) - size), s, nbits};
  }
  return true;
}

void build_rle(Fse& t, uint8_t symbol) {
  t.log = 0;
  t.fast = false;
  t.cells.assign(1, FseCell{0, symbol, 0});
}

// v0.5's FSEv05_buildDTable_raw: nbits read as the symbol itself
void build_raw(Fse& t, unsigned nbits) {
  const uint32_t size = 1U << nbits;
  t.log = nbits;
  t.fast = true;
  t.cells.resize(size);
  for (uint32_t u = 0; u < size; ++u)
    t.cells[u] = {0, static_cast<uint8_t>(u), static_cast<uint8_t>(nbits)};
}

struct State {
  uint32_t state = 0;
  const Fse* t = nullptr;
  void init(Bits& b, const Fse& table) {
    t = &table;
    state = static_cast<uint32_t>(b.read(table.log));
    b.reload();
  }
  uint8_t peek() const { return t->cells[state].symbol; }
  void update(Bits& b) {
    const FseCell& cell = t->cells[state];
    state = cell.state + static_cast<uint32_t>(b.read(cell.nbits));
  }
  uint8_t decode(Bits& b) {
    const FseCell& cell = t->cells[state];
    state = cell.state + static_cast<uint32_t>(b.read(cell.nbits));
    return cell.symbol;
  }
  uint8_t decode_fast(Bits& b) {
    const FseCell& cell = t->cells[state];
    state = cell.state + static_cast<uint32_t>(b.read_fast(cell.nbits));
    return cell.symbol;
  }
};

// FSEv0x_decompress (the Huffman weights): the symbols written, or -1.
// v0.6 and v0.7 stop where the stream overflows; v0.5's older loop stops
// where the stream ends, and keeps the symbols only where both states
// came back to 0 there.
int64_t fse_decompress(uint8_t* dst, size_t cap, const uint8_t* src,
                       size_t n, bool ends_at_zero) {
  if (n < 2) return -1;
  int16_t norm[256];
  unsigned max_sv = 255, log;
  const int64_t hsize = read_ncount(norm, &max_sv, &log, src, n);
  if (hsize < 0 || static_cast<size_t>(hsize) >= n) return -1;
  Fse t;
  if (!build(t, norm, max_sv, log)) return -1;
  Bits b;
  if (!b.init(src + hsize, n - hsize)) return -1;
  State s1, s2;
  s1.init(b, t);
  s2.init(b, t);
  const bool fast = t.fast;
  auto sym = [&](State& s) { return fast ? s.decode_fast(b) : s.decode(b); };
  uint8_t* op = dst;
  uint8_t* const omax = dst + cap;
  uint8_t* const olimit = omax - 3;
  for (; b.reload() == kUnfinished && op < olimit; op += 4) {
    op[0] = sym(s1);
    op[1] = sym(s2);
    op[2] = sym(s1);
    op[3] = sym(s2);
  }
  if (ends_at_zero) {
    for (;;) {
      if (b.reload() > kCompleted || op == omax ||
          (b.end() && (fast || s1.state == 0)))
        break;
      *op++ = sym(s1);
      if (b.reload() > kCompleted || op == omax ||
          (b.end() && (fast || s2.state == 0)))
        break;
      *op++ = sym(s2);
    }
    if (b.end() && s1.state == 0 && s2.state == 0) return op - dst;
    return -1;
  }
  for (;;) {
    if (op > omax - 2) return -1;
    *op++ = sym(s1);
    if (b.reload() == kOverflow) {
      *op++ = sym(s2);
      break;
    }
    if (op > omax - 2) return -1;
    *op++ = sym(s2);
    if (b.reload() == kOverflow) {
      *op++ = sym(s1);
      break;
    }
  }
  return op - dst;
}

// HUFv0x_readStats: the weights of nsym symbols (the last implied), their
// counts by weight, the table log; the header's length, or -1
int64_t read_stats(uint8_t* weight, uint32_t* rank, uint32_t* nsym,
                   uint32_t* table_log, const uint8_t* src, size_t n,
                   int version) {
  if (!n) return -1;
  size_t isize = src[0], osize;
  const uint8_t* ip = src;
  if (isize >= 128) {
    if (isize >= 242) {                 // every weight 1
      static const uint32_t l[14] = {1, 2, 3, 4, 7, 8, 15, 16, 31, 32, 63,
                                     64, 127, 128};
      osize = l[isize - 242];
      std::memset(weight, 1, 256);
      isize = 0;
    } else {                            // 4 bits a weight
      osize = isize - 127;
      isize = (osize + 1) / 2;
      if (isize + 1 > n) return -1;
      if (osize >= 256) return -1;
      ip += 1;
      for (size_t i = 0; i < osize; i += 2) {
        weight[i] = ip[i / 2] >> 4;
        weight[i + 1] = ip[i / 2] & 15;
      }
    }
  } else {
    if (isize + 1 > n) return -1;
    const int64_t got = fse_decompress(weight, 255, ip + 1, isize,
                                       version == 5);
    if (got < 0) return -1;
    osize = static_cast<size_t>(got);
  }
  std::memset(rank, 0, 17 * sizeof(uint32_t));
  uint32_t total = 0;
  for (size_t i = 0; i < osize; ++i) {
    if (weight[i] >= 16) return -1;
    rank[weight[i]]++;
    total += (1U << weight[i]) >> 1;
  }
  if (!total) return -1;
  const uint32_t log = highbit(total) + 1;
  if (log > 16) return -1;
  const uint32_t rest = (1U << log) - total;
  if ((1U << highbit(rest)) != rest) return -1;
  const uint32_t last = highbit(rest) + 1;
  weight[osize] = static_cast<uint8_t>(last);
  rank[last]++;
  if (rank[1] < 2 || (rank[1] & 1)) return -1;
  *nsym = static_cast<uint32_t>(osize + 1);
  *table_log = log;
  return static_cast<int64_t>(isize + 1);
}

// a Huffman table: type 0 (HUFv0x_DEltX2: one symbol, read at the code
// lengths' log) or 1 (HUFv0x_DEltX4: up to two, read at 12 bits)
struct Huf {
  int type = 0;
  uint32_t log = 0;
  std::vector<uint16_t> seq;            // X4: the symbols (LE), X2: symbol
  std::vector<uint8_t> nbits, length;
};

constexpr uint32_t kHufMaxLog = 12;     // HUFv0x_MAX_TABLELOG

// HUFv0x_readDTableX2 into a table of kHufMaxLog (v0.7's check allows one
// more, where its table overflows: refused here)
int64_t read_x2(Huf& t, const uint8_t* src, size_t n, int version) {
  uint8_t weight[257];
  uint32_t rank[17];
  uint32_t nsym, log;
  const int64_t isize = read_stats(weight, rank, &nsym, &log, src, n,
                                   version);
  if (isize < 0) return -1;
  if (log > kHufMaxLog) return -1;
  t.type = 0;
  t.log = log;
  t.seq.assign(1U << log, 0);
  t.nbits.assign(1U << log, 0);
  t.length.assign(1U << log, 1);
  uint32_t next = 0;
  for (uint32_t w = 1; w <= log; ++w) {
    const uint32_t cur = next;
    next += rank[w] << (w - 1);
    rank[w] = cur;
  }
  for (uint32_t s = 0; s < nsym; ++s) {
    const uint32_t w = weight[s];
    const uint32_t len = (1U << w) >> 1;
    for (uint32_t i = rank[w]; i < rank[w] + len; ++i) {
      t.seq[i] = static_cast<uint16_t>(s);
      t.nbits[i] = static_cast<uint8_t>(log + 1 - w);
    }
    rank[w] += len;
  }
  return isize;
}

struct Sorted {
  uint8_t symbol, weight;
};

// HUFv0x_fillDTableX4Level2
void fill_level2(Huf& t, uint32_t at, uint32_t size_log, uint32_t consumed,
                 const uint32_t* rank_origin, int min_weight,
                 const Sorted* sorted, uint32_t nsorted, uint32_t baseline,
                 uint16_t base_seq) {
  uint32_t rank[17];
  std::memcpy(rank, rank_origin, sizeof(rank));
  if (min_weight > 1) {
    const uint32_t skip = rank[min_weight];
    for (uint32_t i = 0; i < skip; ++i) {
      t.seq[at + i] = base_seq;
      t.nbits[at + i] = static_cast<uint8_t>(consumed);
      t.length[at + i] = 1;
    }
  }
  for (uint32_t s = 0; s < nsorted; ++s) {
    const uint32_t symbol = sorted[s].symbol, w = sorted[s].weight;
    const uint32_t nb = baseline - w;
    const uint32_t len = 1U << (size_log - nb);
    const uint32_t start = rank[w];
    for (uint32_t i = start; i < start + len; ++i) {
      t.seq[at + i] = static_cast<uint16_t>(base_seq + (symbol << 8));
      t.nbits[at + i] = static_cast<uint8_t>(nb + consumed);
      t.length[at + i] = 2;
    }
    rank[w] += len;
  }
}

// HUFv0x_readDTableX4 at kHufMaxLog
int64_t read_x4(Huf& t, const uint8_t* src, size_t n, int version) {
  uint8_t weight[257];
  uint32_t stats[17];
  uint32_t nsym, log;
  const int64_t isize = read_stats(weight, stats, &nsym, &log, src, n,
                                   version);
  if (isize < 0) return -1;
  const uint32_t mem = kHufMaxLog;
  if (log > mem) return -1;
  uint32_t max_w = log;
  while (stats[max_w] == 0) --max_w;
  uint32_t rank_start0[18] = {0};
  uint32_t* const rank_start = rank_start0 + 1;
  uint32_t next = 0;
  for (uint32_t w = 1; w <= max_w; ++w) {
    const uint32_t cur = next;
    next += stats[w];
    rank_start[w] = cur;
  }
  rank_start[0] = next;
  const uint32_t nsorted = next;
  Sorted sorted[257];
  for (uint32_t s = 0; s < nsym; ++s) {
    const uint32_t w = weight[s];
    const uint32_t r = rank_start[w]++;
    sorted[r] = {static_cast<uint8_t>(s), static_cast<uint8_t>(w)};
  }
  rank_start[0] = 0;
  uint32_t rank_val[16][17];
  std::memset(rank_val, 0, sizeof(rank_val));
  {
    const int rescale = static_cast<int>(mem - log) - 1;
    uint32_t next_val = 0;
    for (uint32_t w = 1; w <= max_w; ++w) {
      const uint32_t cur = next_val;
      next_val += stats[w] << (w + rescale);
      rank_val[0][w] = cur;
    }
    const uint32_t min_bits = log + 1 - max_w;
    for (uint32_t used = min_bits; used < mem - min_bits + 1; ++used)
      for (uint32_t w = 1; w <= max_w; ++w)
        rank_val[used][w] = rank_val[0][w] >> used;
  }
  t.type = 1;
  t.log = mem;
  t.seq.assign(1U << mem, 0);
  t.nbits.assign(1U << mem, 0);
  t.length.assign(1U << mem, 0);
  // HUFv0x_fillDTableX4
  const uint32_t baseline = log + 1;
  const int scale_log = static_cast<int>(baseline) - static_cast<int>(mem);
  const uint32_t min_bits = baseline - max_w;
  uint32_t rank[17];
  std::memcpy(rank, rank_val[0], sizeof(rank));
  for (uint32_t s = 0; s < nsorted; ++s) {
    const uint16_t symbol = sorted[s].symbol;
    const uint32_t w = sorted[s].weight;
    const uint32_t nb = baseline - w;
    const uint32_t start = rank[w];
    const uint32_t len = 1U << (mem - nb);
    if (mem - nb >= min_bits) {
      int min_weight = static_cast<int>(nb) + scale_log;
      if (min_weight < 1) min_weight = 1;
      const uint32_t sorted_rank = rank_start0[min_weight];
      fill_level2(t, start, mem - nb, nb, rank_val[nb], min_weight,
                  sorted + sorted_rank, nsorted - sorted_rank, baseline,
                  symbol);
    } else {
      for (uint32_t u = start; u < start + len; ++u) {
        t.seq[u] = symbol;
        t.nbits[u] = static_cast<uint8_t>(nb);
        t.length[u] = 1;
      }
    }
    rank[w] += len;
  }
  return isize;
}

// HUFv0x_decodeStreamX2/X4 from p to pend (offsets into out)
void stream_x2(uint8_t* out, ptrdiff_t p, Bits& b, ptrdiff_t pend,
               const Huf& t) {
  auto sym = [&]() {
    const size_t v = b.look_fast(t.log);
    out[p++] = static_cast<uint8_t>(t.seq[v]);
    b.consumed += t.nbits[v];
  };
  while (b.reload() == kUnfinished && p <= pend - 4) {
    sym();
    sym();
    sym();
    sym();
  }
  while (b.reload() == kUnfinished && p < pend) sym();
  while (p < pend) sym();
}

inline void x4_sym(uint8_t* out, ptrdiff_t& p, Bits& b, const Huf& t) {
  const size_t v = b.look_fast(t.log);
  out[p] = static_cast<uint8_t>(t.seq[v]);
  out[p + 1] = static_cast<uint8_t>(t.seq[v] >> 8);
  b.consumed += t.nbits[v];
  p += t.length[v];
}

void stream_x4(uint8_t* out, ptrdiff_t p, Bits& b, ptrdiff_t pend,
               const Huf& t) {
  while (b.reload() == kUnfinished && p < pend - 7) {
    x4_sym(out, p, b, t);
    x4_sym(out, p, b, t);
    x4_sym(out, p, b, t);
    x4_sym(out, p, b, t);
  }
  while (b.reload() == kUnfinished && p <= pend - 2) x4_sym(out, p, b, t);
  while (p <= pend - 2) x4_sym(out, p, b, t);
  if (p < pend) {                       // HUFv0x_decodeLastSymbolX4
    const size_t v = b.look_fast(t.log);
    out[p] = static_cast<uint8_t>(t.seq[v]);
    if (t.length[v] == 1) {
      b.consumed += t.nbits[v];
    } else if (b.consumed < 64) {
      b.consumed += t.nbits[v];
      if (b.consumed > 64) b.consumed = 64;
    }
  }
}

// HUFv0x_decompress1X2/1X4_usingDTable_internal
bool huf_1x(uint8_t* dst, size_t n, const uint8_t* src, size_t cn,
            const Huf& t) {
  Bits b;
  if (!b.init(src, cn)) return false;
  if (t.type == 0) stream_x2(dst, 0, b, static_cast<ptrdiff_t>(n), t);
  else stream_x4(dst, 0, b, static_cast<ptrdiff_t>(n), t);
  return b.end();
}

// HUFv0x_decompress4X2/4X4_usingDTable_internal. dst has room for n plus
// the lock-step loop's overshoot of one lookup.
bool huf_4x(uint8_t* dst, size_t n, const uint8_t* src, size_t cn,
            const Huf& t) {
  if (cn < 10) return false;
  const size_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  const size_t l4 = cn - (l1 + l2 + l3 + 6);
  if (l4 > cn) return false;
  const uint8_t* s1 = src + 6;
  const uint8_t* s2 = s1 + l1;
  const uint8_t* s3 = s2 + l2;
  const uint8_t* s4 = s3 + l3;
  Bits b[4];
  if (!b[0].init(s1, l1) || !b[1].init(s2, l2) || !b[2].init(s3, l3) ||
      !b[3].init(s4, l4))
    return false;
  const ptrdiff_t seg = static_cast<ptrdiff_t>((n + 3) / 4);
  const ptrdiff_t oend = static_cast<ptrdiff_t>(n);
  ptrdiff_t start[4] = {0, seg, 2 * seg, 3 * seg};
  ptrdiff_t op[4] = {0, seg, 2 * seg, 3 * seg};
  auto reload_all = [&]() {
    return b[0].reload() | b[1].reload() | b[2].reload() | b[3].reload();
  };
  int signal = reload_all();
  if (t.type == 0) {
    while (signal == kUnfinished && op[3] < oend - 7) {
      for (int r = 0; r < 4; ++r)
        for (int k = 0; k < 4; ++k) {
          const size_t v = b[k].look_fast(t.log);
          dst[op[k]++] = static_cast<uint8_t>(t.seq[v]);
          b[k].consumed += t.nbits[v];
        }
      signal = reload_all();
    }
  } else {
    while (signal == kUnfinished && op[3] < oend - 7) {
      for (int r = 0; r < 4; ++r)
        for (int k = 0; k < 4; ++k) {
          if (op[k] > oend) return false;   // written past the literals:
          x4_sym(dst, op[k], b[k], t);      // refused below in any case
        }
      signal = reload_all();
    }
  }
  if (op[0] > start[1] || op[1] > start[2] || op[2] > start[3]) return false;
  for (int k = 0; k < 4; ++k) {
    const ptrdiff_t pend = k < 3 ? start[k + 1] : oend;
    if (t.type == 0) stream_x2(dst, op[k], b[k], pend, t);
    else stream_x4(dst, op[k], b[k], pend, t);
  }
  return b[0].end() && b[1].end() && b[2].end() && b[3].end();
}

// HUFv0x_selectDecoder's timings (the same table in all three)
const uint32_t kAlgoTime[16][2][2] = {
    {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},
    {{38, 130}, {1313, 74}},  {{448, 128}, {1353, 74}},
    {{556, 128}, {1353, 74}}, {{714, 128}, {1418, 74}},
    {{883, 128}, {1437, 74}}, {{897, 128}, {1515, 75}},
    {{926, 128}, {1613, 75}}, {{947, 128}, {1729, 77}},
    {{1107, 128}, {2083, 81}}, {{1177, 128}, {2379, 87}},
    {{1242, 128}, {2415, 93}}, {{1349, 128}, {2644, 106}},
    {{1455, 128}, {2422, 124}}, {{722, 128}, {1891, 145}}};

// 1 where the two-symbol table is picked; v0.5 and v0.6 favour it by a
// sixteenth, v0.7 by an eighth
int select_x4(size_t dst_size, size_t csize, int version) {
  const uint32_t q = static_cast<uint32_t>(csize * 16 / dst_size);
  const uint32_t d256 = static_cast<uint32_t>(dst_size >> 8);
  const uint32_t t0 = kAlgoTime[q][0][0] + kAlgoTime[q][0][1] * d256;
  uint32_t t1 = kAlgoTime[q][1][0] + kAlgoTime[q][1][1] * d256;
  t1 += t1 >> (version == 7 ? 3 : 4);
  return t1 < t0;
}

// -- sequences ------------------------------------------------------------------

struct Seq3 {
  size_t lit, match, offset;
};

// the version's execSequence: its refusals, then the copy (the library's
// wide copies give the bytes of a copy done one byte at a time up to the
// sequence's end; what they write past it a later write replaces)
bool exec(uint8_t* op, uint8_t* const oend, Seq3 s, const uint8_t** lit,
          const uint8_t* lit_limit, const uint8_t* base, const uint8_t* vbase,
          const uint8_t* dict_end) {
  if (s.lit + kWild > static_cast<size_t>(oend - op)) return false;
  if (s.lit + s.match > static_cast<size_t>(oend - op)) return false;
  if (*lit > lit_limit || s.lit > static_cast<size_t>(lit_limit - *lit))
    return false;
  std::memmove(op, *lit, s.lit);
  op += s.lit;
  *lit += s.lit;
  size_t len = s.match;
  const uint8_t* match = op - s.offset;
  if (s.offset > static_cast<size_t>(op - base)) {
    if (s.offset > static_cast<size_t>(op - vbase)) return false;
    match = dict_end - (s.offset - static_cast<size_t>(op - base));
    if (match + len <= dict_end) {
      std::memmove(op, match, len);
      return true;
    }
    const size_t first = static_cast<size_t>(dict_end - match);
    std::memmove(op, match, first);
    op += first;
    len -= first;
    match = base;
  }
  for (size_t i = 0; i < len; ++i) op[i] = match[i];
  return true;
}

// v0.6 and v0.7 code lengths as v1 does (kLLBase, kLLBits, kMLBase,
// kMLBits: v0.6's match lengths are 3 less, MINMATCH added after) and have
// v1's predefined distributions (kLLNorm, kMLNorm, kOFNorm)

// -- the decoder of one version ------------------------------------------------

// ZSTDv06_frameHeaderSize and ZSTDv07_frameHeaderSize
size_t frame_header_size(int version, const uint8_t* src) {
  static const size_t fcs6[4] = {0, 1, 2, 8};
  static const size_t did[4] = {0, 1, 2, 4}, fcs[4] = {0, 2, 4, 8};
  const uint8_t fhd = src[4];
  if (version == 6) return 5 + fcs6[fhd >> 6];
  const bool single = (fhd >> 5) & 1;
  return 5 + !single + did[fhd & 3] + fcs[fhd >> 6] +
         (single && !fcs[fhd >> 6]);
}

enum Stage { kFrameHeader, kFrameHeader2, kBlockHeader, kBlockBody };

struct Dctx {
  int version;
  // ZSTDv0x_DCtx
  Stage stage = kFrameHeader;
  size_t expected = 5;
  int btype = 0;
  size_t header_size = 5;
  uint8_t header[18];
  const uint8_t* prev_end = nullptr;
  const uint8_t* base = nullptr;
  const uint8_t* vbase = nullptr;
  const uint8_t* dict_end = nullptr;
  Fse ll, of, ml;
  Huf huf;                              // v0.7's persistent table
  bool lit_entropy = false, fse_entropy = false;
  size_t rep[3] = {1, 4, 8};
  bool checksum = false;
  Xxh64 xxh;
  std::vector<uint8_t> lit_buf = std::vector<uint8_t>(kBlock + 2 * kWild + 8);
  const uint8_t* lit_ptr = nullptr;
  size_t lit_size = 0, lit_buf_size = 0;
  // the frame's parameters
  uint32_t window_log = 0;              // v0.5, v0.6
  uint64_t window = 0;                  // v0.7

  explicit Dctx(int v) : version(v) {}

  void continuity(const uint8_t* dst) {
    if (dst != prev_end) {
      dict_end = prev_end;
      vbase = dst - (prev_end - base);
      base = dst;
      prev_end = dst;
    }
  }

  void frame_params();
  size_t literals(const uint8_t* src, size_t n);
  size_t sequences(uint8_t* dst, size_t cap, const uint8_t* src, size_t n);
  size_t cont(uint8_t* dst, size_t cap, const uint8_t* src, size_t n);
};

// ZSTDv0x_decodeLiteralsBlock: the section's length
size_t Dctx::literals(const uint8_t* src, size_t n) {
  const size_t min_block = 3;           // MIN_CBLOCK_SIZE
  if (n < min_block) fail();
  uint8_t* const buf = lit_buf.data();
  switch (src[0] >> 6) {
    case 0: {                           // Huffman
      size_t lh = (src[0] >> 4) & 3, lsize, csize;
      bool single = false;
      if (n < 5) fail();
      if (lh < 2) {
        lh = 3;
        single = src[0] & 16;
        lsize = ((src[0] & 15) << 6) + (src[1] >> 2);
        csize = ((src[1] & 3) << 8) + src[2];
      } else if (lh == 2) {
        lh = 4;
        lsize = ((src[0] & 15) << 10) + (src[1] << 2) + (src[2] >> 6);
        csize = ((src[2] & 63) << 8) + src[3];
      } else {
        lh = 5;
        lsize = ((src[0] & 15) << 14) + (src[1] << 6) + (src[2] >> 2);
        csize = ((src[2] & 3) << 16) + (src[3] << 8) + src[4];
      }
      if (lsize > kBlock) fail();
      if (csize + lh > n) fail();
      const uint8_t* hs = src + lh;
      if (version == 7) {
        if (single) {
          const int64_t h = read_x2(huf, hs, csize, version);
          if (h < 0 || static_cast<size_t>(h) >= csize) fail();
          if (!huf_1x(buf, lsize, hs + h, csize - h, huf)) fail();
        } else {
          if (lsize == 0 || csize >= lsize || csize <= 1) fail();
          const int x4 = select_x4(lsize, csize, 7);
          const int64_t h = x4 ? read_x4(huf, hs, csize, version)
                               : read_x2(huf, hs, csize, version);
          if (h < 0 || static_cast<size_t>(h) >= csize) fail();
          if (!huf_4x(buf, lsize, hs + h, csize - h, huf)) fail();
        }
        lit_entropy = true;
      } else {
        Huf t;
        if (single) {
          const int64_t h = read_x2(t, hs, csize, version);
          if (h < 0 || static_cast<size_t>(h) >= csize) fail();
          if (!huf_1x(buf, lsize, hs + h, csize - h, t)) fail();
        } else {
          // HUFv05/06_decompress: v0.6 copies a section as long as its
          // literals, v0.5 refuses it; one byte is every literal
          if (lsize == 0) fail();
          if (version == 6 ? csize > lsize : csize >= lsize) fail();
          if (csize == lsize) {
            std::memcpy(buf, hs, lsize);
          } else if (csize == 1) {
            std::memset(buf, hs[0], lsize);
          } else {
            const int x4 = select_x4(lsize, csize, version);
            const int64_t h = x4 ? read_x4(t, hs, csize, version)
                                 : read_x2(t, hs, csize, version);
            if (h < 0 || static_cast<size_t>(h) >= csize) fail();
            if (!huf_4x(buf, lsize, hs + h, csize - h, t)) fail();
          }
        }
      }
      lit_ptr = buf;
      lit_size = lsize;
      lit_buf_size = lsize + kWild;
      std::memset(buf + lsize, 0, kWild);
      return csize + lh;
    }
    case 1: {                           // repeat the last Huffman table
      size_t lh = (src[0] >> 4) & 3;
      if (lh != 1) fail();
      if (version != 7 || !lit_entropy) fail();   // v0.5/6: a dictionary's
      if (huf.type != 1) fail();        // HUFv07_decompress1X4_usingDTable
      lh = 3;
      const size_t lsize = ((src[0] & 15) << 6) + (src[1] >> 2);
      const size_t csize = ((src[1] & 3) << 8) + src[2];
      if (csize + lh > n) fail();
      if (!huf_1x(buf, lsize, src + lh, csize, huf)) fail();
      lit_ptr = buf;
      lit_size = lsize;
      lit_buf_size = lsize + kWild;
      std::memset(buf + lsize, 0, kWild);
      return csize + lh;
    }
    case 2: {                           // raw
      size_t lh = (src[0] >> 4) & 3, lsize;
      if (lh < 2) {
        lh = 1;
        lsize = src[0] & 31;
      } else if (lh == 2) {
        lsize = ((src[0] & 15) << 8) + src[1];
      } else {
        lsize = ((src[0] & 15) << 16) + (src[1] << 8) + src[2];
      }
      if (lh + lsize + kWild > n) {
        if (lsize + lh > n) fail();
        std::memcpy(buf, src + lh, lsize);
        lit_ptr = buf;
        lit_size = lsize;
        lit_buf_size = lsize + kWild;
        std::memset(buf + lsize, 0, kWild);
        return lh + lsize;
      }
      lit_ptr = src + lh;               // read where they lie
      lit_size = lsize;
      lit_buf_size = n - lh;
      return lh + lsize;
    }
    default: {                          // RLE
      size_t lh = (src[0] >> 4) & 3, lsize;
      if (lh < 2) {
        lh = 1;
        lsize = src[0] & 31;
      } else if (lh == 2) {
        lsize = ((src[0] & 15) << 8) + src[1];
      } else {
        lsize = ((src[0] & 15) << 16) + (src[1] << 8) + src[2];
        if (n < 4) fail();
      }
      if (lsize > kBlock) fail();
      std::memset(buf, src[lh], lsize + kWild);
      lit_ptr = buf;
      lit_size = lsize;
      lit_buf_size = lsize + kWild;
      return lh + 1;
    }
  }
}

// ZSTDv06/07_buildSeqTable: the bytes its description took
size_t seq_table(Fse& t, uint32_t type, unsigned max, unsigned max_log,
                 const uint8_t* src, size_t n, const int16_t* def,
                 unsigned def_log, bool repeat) {
  switch (type) {
    case 1:                             // RLE
      if (!n) fail();
      if (src[0] > max) fail();
      build_rle(t, src[0]);
      return 1;
    case 0:                             // the predefined distribution
      build(t, def, max, def_log);
      return 0;
    case 2:                             // the last block's table
      if (!repeat) fail();
      return 0;
    default: {
      int16_t norm[64];
      unsigned log;
      const int64_t h = read_ncount(norm, &max, &log, src, n);
      if (h < 0) fail();
      if (log > max_log) fail();
      build(t, norm, max, log);         // its errors are not checked
      return static_cast<size_t>(h);
    }
  }
}

// v0.5's table of a kind: RLE, raw (nbits read as the symbol), repeat
// (a dictionary's) or FSE
void seq_table5(Fse& t, uint32_t type, unsigned max, unsigned max_log,
                unsigned raw_bits, const uint8_t*& ip, const uint8_t* iend,
                int kind) {
  switch (type) {
    case 1:
      if (kind && ip > iend - 2) fail();
      build_rle(t, kind == 1 ? (*ip++ & 31) : *ip++);
      return;
    case 0:
      build_raw(t, raw_bits);
      return;
    case 2:
      fail();
    default: {
      int16_t norm[128];
      unsigned log;
      const int64_t h = read_ncount(norm, &max, &log, ip, iend - ip);
      if (h < 0) fail();
      if (log > max_log) fail();
      ip += h;
      build(t, norm, max, log);
    }
  }
}

// ZSTDv0x_decompressSequences: the bytes written
size_t Dctx::sequences(uint8_t* dst, size_t cap, const uint8_t* src,
                       size_t n) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;
  const uint8_t* lit = lit_ptr;
  const uint8_t* const lit_end = lit_ptr + lit_size;
  // literals may run past their section (up to the buffer's end) until the
  // last ones are counted, except in v0.7
  const uint8_t* const lit_limit =
      version == 7 ? lit_end : lit_ptr + lit_buf_size - kWild;
  int nb_seq;
  const uint8_t* dumps = nullptr;
  const uint8_t* dumps_end = nullptr;
  if (version == 5) {
    if (n < 1) fail();                  // MIN_SEQUENCES_SIZE
    nb_seq = *ip++;
    if (nb_seq == 0) goto last;
    if (nb_seq >= 128) {
      if (ip >= iend) fail();
      nb_seq = ((nb_seq - 128) << 8) + *ip++;
    }
    if (ip >= iend) fail();
    const uint32_t lltype = *ip >> 6, oftype = (*ip >> 4) & 3,
                   mltype = (*ip >> 2) & 3;
    size_t dlen;
    if (*ip & 2) {
      if (ip + 3 > iend) fail();
      dlen = ip[2] + (ip[1] << 8);
      ip += 3;
    } else {
      if (ip + 2 > iend) fail();
      dlen = ip[1] + ((ip[0] & 1) << 8);
      ip += 2;
    }
    dumps = ip;
    ip += dlen;
    dumps_end = ip;
    if (ip > iend - 3) fail();
    seq_table5(ll, lltype, 63, 10, 6, ip, iend, 0);
    seq_table5(of, oftype, 31, 9, 5, ip, iend, 1);
    seq_table5(ml, mltype, 127, 10, 7, ip, iend, 2);
  } else {
    if (n < 1) fail();
    nb_seq = *ip++;
    if (!nb_seq) goto last;
    if (nb_seq > 0x7F) {
      if (nb_seq == 0xFF) {
        if (ip + 2 > iend) fail();
        nb_seq = rd16(ip) + 0x7F00;
        ip += 2;
      } else {
        if (ip >= iend) fail();
        nb_seq = ((nb_seq - 0x80) << 8) + *ip++;
      }
    }
    if (ip + 4 > iend) fail();
    const uint32_t lltype = *ip >> 6, oftype = (*ip >> 4) & 3,
                   mltype = (*ip >> 2) & 3;
    ip++;
    ip += seq_table(ll, lltype, 35, 9, ip, iend - ip, kLLNorm, 6,
                    fse_entropy);
    ip += seq_table(of, oftype, 28, 8, ip, iend - ip, kOFNorm, 5,
                    fse_entropy);
    ip += seq_table(ml, mltype, 52, 9, ip, iend - ip, kMLNorm, 6,
                    fse_entropy);
    if (version == 6) fse_entropy = false;
  }
  {
    Bits b;
    if (!b.init(ip, iend - ip)) fail();
    State sll, sof, sml;
    sll.init(b, ll);
    sof.init(b, of);
    sml.init(b, ml);
    size_t prev[3];
    for (int i = 0; i < 3; ++i) prev[i] = version == 7 ? rep[i] : 1;
    if (version == 7) fse_entropy = true;
    Seq3 s{0, 0, 1};                    // v0.5: the last sequence's
    size_t prev5 = 1;
    while (b.reload() <= kCompleted && nb_seq) {
      nb_seq--;
      if (version == 5) {
        size_t ll_len = sll.peek();
        const size_t prev_off = ll_len ? s.offset : prev5;
        if (ll_len == 63) {
          const uint32_t add = *dumps++;
          if (add < 255) {
            ll_len += add;
          } else if (dumps + 2 <= dumps_end) {
            ll_len = rd16(dumps);
            dumps += 2;
            if ((ll_len & 1) && dumps < dumps_end) {
              ll_len += static_cast<size_t>(*dumps) << 16;
              dumps += 1;
            }
            ll_len >>= 1;
          }
          if (dumps >= dumps_end) dumps = dumps_end - 1;
        }
        static const uint32_t prefix[32] = {
            1, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
            16384, 32768, 65536, 131072, 262144, 524288, 1048576, 2097152,
            4194304, 8388608, 16777216, 33554432, 1, 1, 1, 1, 1};
        const uint32_t code = sof.peek();
        const uint32_t nbits = code ? code - 1 : 0;
        size_t offset = prefix[code & 31] + b.read(nbits);
        if (code == 0) offset = prev_off;
        if (code | !ll_len) prev5 = s.offset;
        sof.update(b);
        sll.update(b);
        size_t ml_len = sml.decode(b);
        if (ml_len == 127) {
          const uint32_t add = dumps < dumps_end ? *dumps++ : 0;
          if (add < 255) {
            ml_len += add;
          } else if (dumps + 2 <= dumps_end) {
            ml_len = rd16(dumps);
            dumps += 2;
            if ((ml_len & 1) && dumps < dumps_end) {
              ml_len += static_cast<size_t>(*dumps) << 16;
              dumps += 1;
            }
            ml_len >>= 1;
          }
          if (dumps >= dumps_end) dumps = dumps_end - 1;
        }
        s = {ll_len, ml_len + 4, offset};
      } else {
        const uint32_t llc = sll.peek(), mlc = sml.peek(), ofc = sof.peek();
        const uint32_t llb = llc < 36 ? kLLBits[llc] : 0U;
        const uint32_t mlb = mlc < 53 ? kMLBits[mlc] : 0U;
        const uint32_t total = llb + mlb + ofc;
        size_t offset;
        if (version == 7) {
          static const uint32_t base7[29] = {
              0, 1, 1, 5, 0xD, 0x1D, 0x3D, 0x7D, 0xFD, 0x1FD, 0x3FD, 0x7FD,
              0xFFD, 0x1FFD, 0x3FFD, 0x7FFD, 0xFFFD, 0x1FFFD, 0x3FFFD,
              0x7FFFD, 0xFFFFD, 0x1FFFFD, 0x3FFFFD, 0x7FFFFD, 0xFFFFFD,
              0x1FFFFFD, 0x3FFFFFD, 0x7FFFFFD, 0xFFFFFFD};
          offset = ofc ? base7[ofc] + b.read(ofc) : 0;
          if (ofc <= 1) {
            if (llc == 0 && offset <= 1) offset = 1 - offset;
            if (offset) {
              const size_t temp = prev[offset];
              if (offset != 1) prev[2] = prev[1];
              prev[1] = prev[0];
              prev[0] = offset = temp;
            } else {
              offset = prev[0];
            }
          } else {
            prev[2] = prev[1];
            prev[1] = prev[0];
            prev[0] = offset;
          }
        } else {
          static const uint32_t base6[29] = {
              0, 1, 3, 7, 0xF, 0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF,
              0xFFF, 0x1FFF, 0x3FFF, 0x7FFF, 0xFFFF, 0x1FFFF, 0x3FFFF,
              0x7FFFF, 0xFFFFF, 0x1FFFFF, 0x3FFFFF, 0x7FFFFF, 0xFFFFFF,
              0x1FFFFFF, 0x3FFFFFF, 1, 1};
          offset = ofc ? base6[ofc] + b.read(ofc) : 0;
          if (offset < 3) {
            if (llc == 0 && offset <= 1) offset = 1 - offset;
            if (offset) {
              const size_t temp = prev[offset];
              if (offset != 1) prev[2] = prev[1];
              prev[1] = prev[0];
              prev[0] = offset = temp;
            } else {
              offset = prev[0];
            }
          } else {
            offset -= 2;
            prev[2] = prev[1];
            prev[1] = prev[0];
            prev[0] = offset;
          }
        }
        const size_t ml_len = (mlc < 53 ? kMLBase[mlc] : 0) +
                              (mlc > 31 ? b.read(mlb) : 0);
        const size_t ll_len = (llc < 36 ? kLLBase[llc] : 0) +
                              (llc > 15 ? b.read(llb) : 0);
        if (total > 64 - 7 - (9 + 9 + 8)) b.reload();
        sll.update(b);
        sml.update(b);
        sof.update(b);
        s = {ll_len, ml_len, offset};
      }
      if (!exec(op, oend, s, &lit, lit_limit, base, vbase, dict_end)) fail();
      op += s.lit + s.match;
    }
    if (nb_seq) fail();
    if (version == 7)
      for (int i = 0; i < 3; ++i) rep[i] = prev[i];
  }
last:
  if (lit > lit_end) fail();
  const size_t last = lit_end - lit;
  if (last > static_cast<size_t>(oend - op)) fail();
  std::memcpy(op, lit, last);
  op += last;
  return op - dst;
}

// ZSTDv0x_decompressContinue of n bytes (n == expected): what it wrote
size_t Dctx::cont(uint8_t* dst, size_t cap, const uint8_t* src, size_t n) {
  if (version == 5 || cap) continuity(dst);
  switch (stage) {
    case kFrameHeader:
      std::memcpy(header, src, 5);
      if (version != 5) {   // v0.5's one byte is read before the buffers
        header_size = frame_header_size(version, src);
        if (header_size > 5) {
          expected = header_size - 5;
          stage = kFrameHeader2;
          return 0;
        }
        frame_params();
      }
      expected = 3;
      stage = kBlockHeader;
      return 0;
    case kFrameHeader2:
      std::memcpy(header + 5, src, n);
      frame_params();
      expected = 3;
      stage = kBlockHeader;
      return 0;
    case kBlockHeader: {
      const int type = src[0] >> 6;
      const size_t csize = src[2] + (src[1] << 8) + ((src[0] & 7) << 16);
      if (type == 3) {
        if (version == 7 && checksum) {
          const uint32_t h = static_cast<uint32_t>(xxh.digest() >> 11) &
                             ((1U << 22) - 1);
          const uint32_t check = src[2] + (src[1] << 8) + ((src[0] & 0x3F) << 16);
          if (check != h) fail();
        }
        expected = 0;
        stage = kFrameHeader;
        return 0;
      }
      expected = type == 2 ? 1 : csize;
      btype = type;
      stage = kBlockBody;
      return 0;
    }
    default: {
      size_t got;
      if (btype == 0) {
        if (n >= kBlock) fail();
        const size_t lsize = literals(src, n);
        got = sequences(dst, cap, src + lsize, n - lsize);
      } else if (btype == 1) {
        if (n > cap) fail();
        std::memcpy(dst, src, n);
        got = n;
      } else {
        fail();                         // RLE: "not yet handled" streaming
      }
      stage = kBlockHeader;
      expected = 3;
      prev_end = dst + got;
      if (version == 7 && checksum) xxh.update(dst, got);
      return got;
    }
  }
}

// the frame header's parameters (ZSTDv06/07_decodeFrameHeader)
void Dctx::frame_params() {
  const uint8_t fhd = header[4];
  if (version == 6) {
    window_log = (fhd & 15) + 12;
    if (fhd & 0x20) fail();
    return;
  }
  size_t pos = 5;
  const bool single = (fhd >> 5) & 1;
  uint64_t w = 0;
  if (fhd & 0x08) fail();
  if (!single) {
    const uint8_t wl = header[pos++];
    const uint32_t log = (wl >> 3) + 10;
    if (log > 27) fail();
    w = 1ULL << log;
    w += (w >> 3) * (wl & 7);
  }
  uint32_t dict_id = 0;
  switch (fhd & 3) {
    case 1: dict_id = header[pos]; pos += 1; break;
    case 2: dict_id = rd16(header + pos); pos += 2; break;
    case 3: dict_id = rd32(header + pos); pos += 4; break;
    default: break;
  }
  uint64_t fcs = 0;
  switch (fhd >> 6) {
    case 0: if (single) fcs = header[pos]; break;
    case 1: fcs = rd16(header + pos) + 256; break;
    case 2: fcs = rd32(header + pos); break;
    default: fcs = rd64(header + pos); break;
  }
  if (!w) w = static_cast<uint32_t>(fcs);
  if (w > (1ULL << 27)) fail();
  window = w;
  checksum = (fhd >> 2) & 1;
  if (dict_id) fail();                  // no dictionary loaded
  if (checksum) xxh = Xxh64();
}

// calloc'd memory: the ring may be large, and only what is written is
// touched
struct Ring {
  uint8_t* p = nullptr;
  explicit Ring(size_t n) : p(static_cast<uint8_t*>(std::calloc(n + 64, 1))) {
    if (!p) fail();
  }
  ~Ring() { std::free(p); }
};

enum { kReturned = 0, kError = 1 };

// ZBUFFv0x_decompressContinue once, on a fresh frame, with the whole chunk
// and the whole output: kReturned (the output position in *pos) or kError
// (*pos: the bytes flushed before it). ctx: the stream's legacy context
// (version, input and output buffer sizes), updated.
int stream(int version, const uint8_t* src, size_t n, uint8_t* dst,
           size_t occ, int64_t* ctx, size_t* pos) {
  Dctx d(version);
  uint8_t* op = dst;
  uint8_t* const oend = dst + occ;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  *pos = 0;
  if (ctx[0] != version) {
    ctx[0] = version;
    ctx[1] = ctx[2] = 0;
  }
  size_t block_size, in_size, out_size;
  try {
    if (version == 5) {
      d.window_log = (src[4] & 15) + 11;
      if (src[4] >> 4) return kError;
      block_size = kBlock;
      in_size = kBlock;
      out_size = static_cast<size_t>(1) << d.window_log;
    } else {
      // the header loaded whole, then read and checked before the buffers
      const size_t fh = frame_header_size(version, src);
      if (n < fh) return kReturned;
      d.cont(nullptr, 0, src, 5);
      if (fh > 5) d.cont(nullptr, 0, src + 5, fh - 5);
      ip += fh;
      uint64_t window = version == 6 ? (1ULL << d.window_log) : d.window;
      if (window < 1024) window = 1024;
      block_size = static_cast<size_t>(window < kBlock ? window : kBlock);
      in_size = block_size;
      out_size = static_cast<size_t>(window) + block_size + 2 * kWild;
    }
  } catch (const Fail&) {
    return kError;
  }
  if (static_cast<size_t>(ctx[1]) > in_size) in_size = static_cast<size_t>(ctx[1]);
  if (static_cast<size_t>(ctx[2]) > out_size) out_size = static_cast<size_t>(ctx[2]);
  ctx[1] = static_cast<int64_t>(in_size);
  ctx[2] = static_cast<int64_t>(out_size);
  Ring ring(out_size);
  uint8_t* const out = ring.p;
  size_t out_start = 0;
  try {
    for (;;) {
      const size_t need = d.expected;
      if (need == 0) break;             // the frame's end
      if (static_cast<size_t>(iend - ip) >= need) {
        const size_t got = d.cont(out + out_start, out_size - out_start, ip,
                                  need);
        ip += need;
        if (!got) continue;
        const size_t room = oend - op;
        const size_t take = room < got ? room : got;
        std::memcpy(op, out + out_start, take);
        op += take;
        out_start += take;
        *pos = op - dst;
        if (take < got) break;          // the output is full
        if (out_start + block_size > out_size) out_start = 0;
        continue;
      }
      if (ip == iend) break;
      if (need > in_size) return kError;   // cannot be loaded
      break;                            // loaded in part: more input wanted
    }
  } catch (const Fail&) {
    return kError;
  }
  *pos = op - dst;
  return kReturned;
}

}  // namespace legacy

}  // namespace

extern "C" {

// One chunk of a ZSTD-compressed TIFF (compression 50000) as libtiff's
// ZSTDDecode decodes it into occ bytes at dst, the chunks of one image in
// turn on one stream: ctx, three int64 zeroed before an image's first
// chunk, carries the stream's legacy context. 1: kept; 0: refused, the
// bytes past the output position zeroed as ZSTDDecode zeroes them (past
// none, where a legacy decoder failed).
int zstd_tiff_chunk_in(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t occ, int64_t* ctx) {
  const size_t size = static_cast<size_t>(occ);
  size_t pos = 0;
  if (n >= 5) {
    // zdss_loadHeader: the v1 header refused, ZSTD_isLegacy of the chunk
    const uint32_t magic = rd32(src);
    if (magic >= legacy::kMagic5 && magic <= legacy::kMagic7) {
      const int version = static_cast<int>(magic - legacy::kMagic5) + 5;
      if (legacy::stream(version, src, static_cast<size_t>(n), dst, size,
                         ctx, &pos) == legacy::kError)
        return 0;
      if (pos == size) return 1;
      std::memset(dst + pos, 0, size - pos);
      return 0;
    }
  }
  try {
    pos = stream_chunk(src, static_cast<size_t>(n), dst, size);
  } catch (const Fail&) {
    pos = 0;
    std::memset(dst, 0, size);
    return 0;
  }
  if (pos == size) return 1;
  std::memset(dst + pos, 0, size - pos);
  return 0;
}

// One chunk on a fresh stream
int zstd_tiff_chunk(const uint8_t* src, int64_t n, uint8_t* dst,
                    int64_t occ) {
  int64_t ctx[3] = {0, 0, 0};
  return zstd_tiff_chunk_in(src, n, dst, occ, ctx);
}

}  // extern "C"
