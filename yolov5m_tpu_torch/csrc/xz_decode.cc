// An .xz decoder that behaves as liblzma 5.8.2's lzma_stream_decoder does
// under libtiff 4.7.1's LZMADecode loop: a fresh decoder a chunk (no
// memory limit, flags 0: no LZMA_CONCATENATED, checks verified, an
// unsupported check skipped), the whole chunk as input and the chunk's
// decoded size as output, lzma_code called until the output is full, the
// stream ends or an error is returned (lzma_code's LZMA_BUF_ERROR after two
// calls without progress among them). libtiff keeps the chunk where the
// output is full, whatever came after: a corrupt index, a bad check or a
// fault past the last byte it needed leave the image as it is. A refused
// chunk is zeroed past the output position lzma_code reports (LZMADecode
// zeroes it), which may be short of bytes a coder wrote (the BCJ filters'
// unfiltered tail) or past bytes it left unfiltered (an error on the
// filters' way out).
//
// The coders are liblzma's, called as liblzma calls them, since where a
// fault stops the output depends on how far each call runs: the stream
// decoder (header, block headers with their filter flags and CRC32), the
// block decoder (its size limits, padding and CRC32, CRC64 or SHA-256
// check), the filters ahead of LZMA2 (delta; BCJ for x86, PowerPC, IA-64,
// ARM, ARM-Thumb, SPARC, ARM64 and RISC-V through the simple coder and
// its buffer of unfiltered bytes), the LZ decoder's dictionary buffer (its
// size, wrap and resets), LZMA2's chunks (dictionary and state resets,
// properties, uncompressed chunks) and the LZMA decoder (which decodes one
// symbol past the end of its output window and holds it, and checks that
// the range coder ends at zero with each chunk). Nothing is written past
// the index: once it begins, the outcome is set.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

enum { kOk = 0, kEnd = 1, kError = 2, kDone = 3 };

constexpr uint64_t kUnknown = ~0ULL;
constexpr uint64_t kVliMax = ~0ULL >> 1;

inline uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
inline void wr32(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
  p[2] = static_cast<uint8_t>(v >> 16);
  p[3] = static_cast<uint8_t>(v >> 24);
}

size_t bufcpy(const uint8_t* in, size_t* in_pos, size_t in_size, uint8_t* out,
              size_t* out_pos, size_t out_size) {
  const size_t a = in_size - *in_pos, b = out_size - *out_pos;
  const size_t n = a < b ? a : b;
  if (n) std::memcpy(out + *out_pos, in + *in_pos, n);
  *in_pos += n;
  *out_pos += n;
  return n;
}

// -- checks -------------------------------------------------------------------

uint32_t crc32(const uint8_t* p, size_t n, uint32_t crc) {
  static uint32_t table[256];
  static bool ready = false;
  if (!ready) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t r = i;
      for (int k = 0; k < 8; ++k) r = (r >> 1) ^ (0xEDB88320U & (0U - (r & 1)));
      table[i] = r;
    }
    ready = true;
  }
  crc = ~crc;
  for (size_t i = 0; i < n; ++i) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

uint64_t crc64(const uint8_t* p, size_t n, uint64_t crc) {
  static uint64_t table[256];
  static bool ready = false;
  if (!ready) {
    for (uint64_t i = 0; i < 256; ++i) {
      uint64_t r = i;
      for (int k = 0; k < 8; ++k)
        r = (r >> 1) ^ (0xC96C5795D7870F42ULL & (0ULL - (r & 1)));
      table[i] = r;
    }
    ready = true;
  }
  crc = ~crc;
  for (size_t i = 0; i < n; ++i) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

struct Sha256 {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint8_t block[64];
  size_t used = 0;
  uint64_t total = 0;

  static uint32_t ror(uint32_t x, int r) { return (x >> r) | (x << (32 - r)); }
  void compress(const uint8_t* b) {
    static const uint32_t k[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
        0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
        0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
        0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
        0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
        0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
        0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
        0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
        0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; ++i)
      w[i] = (static_cast<uint32_t>(b[4 * i]) << 24) | (b[4 * i + 1] << 16) |
             (b[4 * i + 2] << 8) | b[4 * i + 3];
    for (int i = 16; i < 64; ++i) {
      const uint32_t s0 = ror(w[i - 15], 7) ^ ror(w[i - 15], 18) ^ (w[i - 15] >> 3);
      const uint32_t s1 = ror(w[i - 2], 17) ^ ror(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], bb = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; ++i) {
      const uint32_t s1 = ror(e, 6) ^ ror(e, 11) ^ ror(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t t1 = hh + s1 + ch + k[i] + w[i];
      const uint32_t s0 = ror(a, 2) ^ ror(a, 13) ^ ror(a, 22);
      const uint32_t mj = (a & bb) ^ (a & c) ^ (bb & c);
      const uint32_t t2 = s0 + mj;
      hh = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = bb;
      bb = a;
      a = t1 + t2;
    }
    h[0] += a;
    h[1] += bb;
    h[2] += c;
    h[3] += d;
    h[4] += e;
    h[5] += f;
    h[6] += g;
    h[7] += hh;
  }
  void update(const uint8_t* p, size_t n) {
    total += n;
    while (n) {
      const size_t take = 64 - used < n ? 64 - used : n;
      std::memcpy(block + used, p, take);
      used += take;
      p += take;
      n -= take;
      if (used == 64) {
        compress(block);
        used = 0;
      }
    }
  }
  void finish(uint8_t* out) {
    const uint64_t bits = total * 8;
    const uint8_t one = 0x80, zero = 0;
    update(&one, 1);
    while (used != 56) update(&zero, 1);
    uint8_t len[8];
    for (int i = 0; i < 8; ++i) len[i] = static_cast<uint8_t>(bits >> (56 - 8 * i));
    update(len, 8);
    for (int i = 0; i < 8; ++i) {
      out[4 * i] = static_cast<uint8_t>(h[i] >> 24);
      out[4 * i + 1] = static_cast<uint8_t>(h[i] >> 16);
      out[4 * i + 2] = static_cast<uint8_t>(h[i] >> 8);
      out[4 * i + 3] = static_cast<uint8_t>(h[i]);
    }
  }
};

size_t check_size(unsigned id) {
  static const uint8_t sizes[16] = {0, 4, 4, 4, 8, 8, 8, 16,
                                    16, 16, 32, 32, 32, 64, 64, 64};
  return sizes[id & 15];
}
bool check_supported(unsigned id) {
  return id == 0 || id == 1 || id == 4 || id == 10;
}

struct Check {
  unsigned id = 0;
  uint32_t c32 = 0;
  uint64_t c64 = 0;
  Sha256 sha;
  void update(const uint8_t* p, size_t n) {
    if (id == 1) c32 = crc32(p, n, c32);
    else if (id == 4) c64 = crc64(p, n, c64);
    else if (id == 10) sha.update(p, n);
  }
  void finish(uint8_t* out) {
    if (id == 1) wr32(out, c32);
    if (id == 4)
      for (int i = 0; i < 8; ++i) out[i] = static_cast<uint8_t>(c64 >> (8 * i));
    if (id == 10) sha.finish(out);
  }
};

// -- the LZ decoder's dictionary (lz_decoder.h) --------------------------------

constexpr size_t kRepeatMax = 288;
constexpr size_t kInitPos = 2 * kRepeatMax;

struct Dict {
  std::vector<uint8_t> buf;   // the first size bytes of it ever used
  size_t size = 0, pos = 0, full = 0, limit = 0;
  bool need_reset = false, has_wrapped = false;

  void reset() {
    pos = kInitPos;
    full = 0;
    buf[kInitPos - 1] = 0;
    has_wrapped = false;
    need_reset = false;
  }
  uint8_t get(uint32_t distance) const {
    return buf[pos - distance - 1 +
               (distance < pos ? 0 : size - kRepeatMax)];
  }
  void track() {
    if (!has_wrapped) full = pos - kInitPos;
  }
  bool put(uint8_t b, size_t lim) {       // dict_put_safe: true if no room
    if (pos == lim) return true;
    buf[pos++] = b;
    track();
    return false;
  }
  bool repeat(uint32_t distance, uint32_t* len, size_t lim) {
    const size_t avail = lim - pos;
    uint32_t left = static_cast<uint32_t>(avail < *len ? avail : *len);
    *len -= left;
    size_t back = pos - distance - 1;
    if (distance >= pos) back += size - kRepeatMax;
    if (distance < left) {
      do {
        buf[pos++] = buf[back++];
      } while (--left > 0);
    } else {
      std::memcpy(buf.data() + pos, buf.data() + back, left);
      pos += left;
    }
    track();
    return *len != 0;
  }
};

// -- the LZMA decoder (lzma_decoder.c) ------------------------------------------

struct Stall {};

struct Lzma {
  uint32_t lc = 0, lp = 0, pb = 0;
  std::vector<uint16_t> lit;
  uint16_t is_match[12][16], is_rep[12], is_rep0[12], is_rep1[12], is_rep2[12],
      is_rep0_long[12][16], dist_slot[4][64], pos_special[114], pos_align[16];
  struct Len {
    uint16_t choice, choice2, low[16][8], mid[16][8], high[256];
  } match_len, rep_len;
  uint32_t state = 0, rep0 = 0, rep1 = 0, rep2 = 0, rep3 = 0;
  uint32_t range = 0xFFFFFFFFU, code = 0, init_left = 5;
  int pending = 0;              // 1 literal, 2 short rep, 3 copy
  uint32_t pending_value = 0;
  uint64_t unc = kUnknown;      // the chunk's bytes still to decode
  // the input ran out inside a symbol: every byte up to the end is spent
  // (LZMA2 counts them against the chunk) and no more will come, since a
  // block's input never grows past where it first ended
  bool stalled = false;
  const uint8_t* in = nullptr;
  size_t* in_pos = nullptr;
  size_t in_size = 0;

  void reset(uint32_t lc_, uint32_t lp_, uint32_t pb_) {
    lc = lc_;
    lp = lp_;
    pb = pb_;
    lit.assign(static_cast<size_t>(0x300) << (lc + lp), 1024);
    auto fill = [](uint16_t* p, size_t n) {
      for (size_t i = 0; i < n; ++i) p[i] = 1024;
    };
    fill(&is_match[0][0], 12 * 16);
    fill(is_rep, 12);
    fill(is_rep0, 12);
    fill(is_rep1, 12);
    fill(is_rep2, 12);
    fill(&is_rep0_long[0][0], 12 * 16);
    fill(&dist_slot[0][0], 4 * 64);
    fill(pos_special, 114);
    fill(pos_align, 16);
    fill(reinterpret_cast<uint16_t*>(&match_len), sizeof(Len) / 2);
    fill(reinterpret_cast<uint16_t*>(&rep_len), sizeof(Len) / 2);
    state = rep0 = rep1 = rep2 = rep3 = 0;
    rc_reset();
    pending = 0;
  }
  void rc_reset() {
    range = 0xFFFFFFFFU;
    code = 0;
    init_left = 5;
  }

  void normalize() {
    if (range < (1U << 24)) {
      if (*in_pos == in_size) throw Stall{};
      range <<= 8;
      code = (code << 8) | in[(*in_pos)++];
    }
  }
  uint32_t bit(uint16_t& p) {
    normalize();
    const uint32_t bound = (range >> 11) * p;
    if (code < bound) {
      range = bound;
      p = static_cast<uint16_t>(p + ((2048 - p) >> 5));
      return 0;
    }
    range -= bound;
    code -= bound;
    p = static_cast<uint16_t>(p - (p >> 5));
    return 1;
  }
  uint32_t tree(uint16_t* probs, int bits) {
    uint32_t m = 1;
    for (int i = 0; i < bits; ++i) m = (m << 1) | bit(probs[m]);
    return m - (1U << bits);
  }
  uint32_t tree_rev(uint16_t* probs, int bits) {
    uint32_t m = 1, sym = 0;
    for (int i = 0; i < bits; ++i) {
      const uint32_t b = bit(probs[m]);
      m = (m << 1) | b;
      sym |= b << i;
    }
    return sym;
  }
  uint32_t direct(int bits) {
    uint32_t res = 0;
    for (int i = 0; i < bits; ++i) {
      normalize();
      range >>= 1;
      code -= range;
      const uint32_t t = 0U - (code >> 31);
      code += range & t;
      res = (res << 1) + (t + 1);
    }
    return res;
  }
  uint32_t length(Len& l, uint32_t pos_state) {
    if (!bit(l.choice)) return 2 + tree(l.low[pos_state], 3);
    if (!bit(l.choice2)) return 10 + tree(l.mid[pos_state], 3);
    return 18 + tree(l.high, 8);
  }

  // lzma_decode: kOk, kEnd (the chunk is done) or kError
  int decode(Dict& d, const uint8_t* in_, size_t* in_pos_, size_t in_size_) {
    in = in_;
    in_pos = in_pos_;
    in_size = in_size_;
    while (init_left > 0) {
      if (*in_pos == in_size) return kOk;
      if (init_left == 5 && in[*in_pos] != 0) return kError;
      code = (code << 8) | in[(*in_pos)++];
      --init_left;
    }
    if (stalled) return kOk;
    const size_t dict_start = d.pos;
    size_t limit = d.limit;
    bool might_finish = false;
    if (unc != kUnknown && unc <= limit - d.pos) {
      limit = d.pos + static_cast<size_t>(unc);
      might_finish = true;
    }
    int ret = kOk;
    const uint32_t pos_mask = (1U << pb) - 1;
    const uint32_t lp_mask = (1U << lp) - 1;
    // the symbol held from the last call
    if (pending == 1 || pending == 2) {
      const uint8_t b = pending == 1 ? static_cast<uint8_t>(pending_value)
                                     : d.get(rep0);
      if (d.put(b, limit)) goto out;
      pending = 0;
    } else if (pending == 3) {
      uint32_t len = pending_value;
      const bool more = d.repeat(rep0, &len, limit);
      pending_value = len;
      if (more) goto out;
      pending = 0;
    }
    for (;;) {
      if (might_finish && d.pos == limit) {
        try {
          normalize();
        } catch (const Stall&) {
          stalled = true;
          goto out;
        }
        ret = code == 0 ? kEnd : kError;
        goto out;
      }
      int kind = 0;     // 1 literal, 2 short rep, 3 match
      uint32_t value = 0;
      try {
        const uint32_t ps = static_cast<uint32_t>(d.pos) & pos_mask;
        if (!bit(is_match[state][ps])) {
          const uint8_t prev = d.buf[d.pos - 1];
          uint16_t* probs =
              lit.data() + 0x300 * (((static_cast<uint32_t>(d.pos) & lp_mask)
                                     << lc) +
                                    (prev >> (8 - lc)));
          uint32_t sym = 1;
          if (state < 7) {
            while (sym < 0x100) sym = (sym << 1) | bit(probs[sym]);
          } else {
            uint32_t match_byte = d.get(rep0);
            uint32_t offset = 0x100;
            while (sym < 0x100) {
              match_byte <<= 1;
              const uint32_t match_bit = match_byte & offset;
              const uint32_t b = bit(probs[offset + match_bit + sym]);
              sym = (sym << 1) | b;
              offset &= b ? match_bit : ~match_bit;
            }
          }
          state = state < 4 ? 0 : state < 10 ? state - 3 : state - 6;
          kind = 1;
          value = sym & 0xFF;
        } else if (!bit(is_rep[state])) {
          state = state < 7 ? 7 : 10;
          rep3 = rep2;
          rep2 = rep1;
          rep1 = rep0;
          const uint32_t len = length(match_len, ps);
          const uint32_t lps = len - 2 < 3 ? len - 2 : 3;
          const uint32_t slot = tree(dist_slot[lps], 6);
          uint32_t dist;
          if (slot < 4) {
            dist = slot;
          } else {
            const int nbits = static_cast<int>((slot >> 1) - 1);
            dist = (2 | (slot & 1)) << nbits;
            if (slot < 14) {
              dist += tree_rev(pos_special + dist - slot - 1, nbits);
            } else {
              dist += direct(nbits - 4) << 4;
              dist += tree_rev(pos_align, 4);
            }
          }
          rep0 = dist;
          kind = 3;
          value = len;
        } else {
          if (!(d.full > 0)) {
            ret = kError;
            kind = -1;
          } else if (!bit(is_rep0[state])) {
            if (!bit(is_rep0_long[state][ps])) {
              state = state < 7 ? 9 : 11;
              kind = 2;
            }
          } else {
            uint32_t dist;
            if (!bit(is_rep1[state])) {
              dist = rep1;
            } else {
              if (!bit(is_rep2[state])) {
                dist = rep2;
              } else {
                dist = rep3;
                rep3 = rep2;
              }
              rep2 = rep1;
            }
            rep1 = rep0;
            rep0 = dist;
          }
          if (kind == 0) {
            state = state < 7 ? 8 : 11;
            kind = 3;
            value = length(rep_len, ps);
          }
        }
      } catch (const Stall&) {
        stalled = true;
        goto out;
      }
      if (kind == -1) goto out;
      if (kind == 1) {
        if (d.put(static_cast<uint8_t>(value), limit)) {
          pending = 1;
          pending_value = value;
          goto out;
        }
      } else if (kind == 2) {
        if (d.put(d.get(rep0), limit)) {
          pending = 2;
          goto out;
        }
      } else {
        if (!(d.full > rep0)) {     // dict_is_distance_valid (EOPM too)
          ret = kError;
          goto out;
        }
        uint32_t len = value;
        if (d.repeat(rep0, &len, limit)) {
          pending = 3;
          pending_value = len;
          goto out;
        }
      }
    }
  out:
    if (unc != kUnknown) {
      unc -= d.pos - dict_start;
      if (unc == 0 && ret == kOk && pending) ret = kError;
    }
    if (ret == kEnd) {
      rc_reset();
      pending = 0;
    }
    return ret;
  }
};

// -- LZMA2 (lzma2_decoder.c) ---------------------------------------------------

struct Lzma2 {
  enum { kControl, kUnc1, kUnc2, kComp0, kComp1, kProps, kLzma, kCopy };
  int seq = kControl, next_seq = kControl;
  uint32_t unc_size = 0, comp_size = 0;
  bool need_props = true, need_dict_reset = true;
  uint32_t lc = 0, lp = 0, pb = 0;
  Lzma lzma;

  int decode(Dict& d, const uint8_t* in, size_t* in_pos, size_t in_size) {
    while (*in_pos < in_size || seq == kLzma) {
      switch (seq) {
        case kControl: {
          const uint32_t control = in[(*in_pos)++];
          if (control == 0) return kEnd;
          if (control >= 0xE0 || control == 1) {
            need_props = true;
            need_dict_reset = true;
          } else if (need_dict_reset) {
            return kError;
          }
          if (control >= 0x80) {
            unc_size = (control & 0x1F) << 16;
            seq = kUnc1;
            if (control >= 0xC0) {
              need_props = false;
              next_seq = kProps;
            } else if (need_props) {
              return kError;
            } else {
              next_seq = kLzma;
              if (control >= 0xA0) lzma.reset(lc, lp, pb);
            }
          } else {
            if (control > 2) return kError;
            seq = kComp0;
            next_seq = kCopy;
          }
          if (need_dict_reset) {
            need_dict_reset = false;
            d.need_reset = true;
            return kOk;
          }
          break;
        }
        case kUnc1:
          unc_size += static_cast<uint32_t>(in[(*in_pos)++]) << 8;
          seq = kUnc2;
          break;
        case kUnc2:
          unc_size += in[(*in_pos)++] + 1U;
          seq = kComp0;
          lzma.unc = unc_size;
          break;
        case kComp0:
          comp_size = static_cast<uint32_t>(in[(*in_pos)++]) << 8;
          seq = kComp1;
          break;
        case kComp1:
          comp_size += in[(*in_pos)++] + 1U;
          seq = next_seq;
          break;
        case kProps: {
          uint32_t b = in[(*in_pos)++];
          if (b > (4 * 5 + 4) * 9 + 8) return kError;
          pb = b / (9 * 5);
          b -= pb * 9 * 5;
          lp = b / 9;
          lc = b - lp * 9;
          if (lc + lp > 4) return kError;
          lzma.reset(lc, lp, pb);
          seq = kLzma;
          break;
        }
        case kLzma: {
          const size_t in_start = *in_pos;
          const int ret = lzma.decode(d, in, in_pos, in_size);
          const size_t used = *in_pos - in_start;
          if (used > comp_size) return kError;
          comp_size -= static_cast<uint32_t>(used);
          if (ret != kEnd) return ret;
          if (comp_size != 0) return kError;
          seq = kControl;
          break;
        }
        case kCopy: {
          // dict_write
          size_t end = in_size;
          if (end - *in_pos > comp_size) end = *in_pos + comp_size;
          const size_t before = *in_pos;
          bufcpy(in, in_pos, end, d.buf.data(), &d.pos, d.limit);
          comp_size -= static_cast<uint32_t>(*in_pos - before);
          d.track();
          if (comp_size != 0) return kOk;
          seq = kControl;
          break;
        }
      }
    }
    return kOk;
  }
};

// -- the filter chain ----------------------------------------------------------

struct Coder {
  virtual ~Coder() = default;
  virtual int code(const uint8_t* in, size_t* in_pos, size_t in_size,
                   uint8_t* out, size_t* out_pos, size_t out_size) = 0;
};

// lz_decoder.c: decode_buffer over LZMA2
struct LzCoder : Coder {
  Dict dict;
  Lzma2 lz;

  explicit LzCoder(uint64_t dict_size, size_t cap) {
    if (dict_size < 4096) dict_size = 4096;
    dict_size = (dict_size + 15) & ~uint64_t{15};
    const uint64_t size = dict_size + 2 * kRepeatMax;
    dict.size = static_cast<size_t>(size);
    // never more than can be written: the buffer past that is never used
    const uint64_t used = kInitPos + static_cast<uint64_t>(cap) + 1024;
    dict.buf.assign(static_cast<size_t>(size < used ? size : used), 0);
    dict.reset();
  }
  int code(const uint8_t* in, size_t* in_pos, size_t in_size, uint8_t* out,
           size_t* out_pos, size_t out_size) override {
    for (;;) {
      if (dict.pos == dict.size) {
        dict.pos = kRepeatMax;
        dict.has_wrapped = true;
        std::memcpy(dict.buf.data(), dict.buf.data() + dict.size - kRepeatMax,
                    kRepeatMax);
      }
      const size_t start = dict.pos;
      const size_t room = out_size - *out_pos;
      const size_t space = dict.size - dict.pos;
      dict.limit = dict.pos + (room < space ? room : space);
      if (dict.limit > dict.buf.size()) dict.limit = dict.buf.size();
      const int ret = lz.decode(dict, in, in_pos, in_size);
      const size_t n = dict.pos - start;
      if (n) std::memcpy(out + *out_pos, dict.buf.data() + start, n);
      *out_pos += n;
      if (dict.need_reset) {
        dict.reset();
        if (ret != kOk || *out_pos == out_size) return ret;
      } else if (ret != kOk || *out_pos == out_size || dict.pos < dict.size) {
        return ret;
      }
    }
  }
};

// delta_decoder.c
struct DeltaCoder : Coder {
  std::unique_ptr<Coder> next;
  size_t distance;
  uint8_t history[256] = {0};
  uint8_t pos = 0;

  int code(const uint8_t* in, size_t* in_pos, size_t in_size, uint8_t* out,
           size_t* out_pos, size_t out_size) override {
    const size_t start = *out_pos;
    const int ret = next->code(in, in_pos, in_size, out, out_pos, out_size);
    for (size_t i = start; i < *out_pos; ++i) {
      out[i] = static_cast<uint8_t>(out[i] + history[(distance + pos) & 0xFF]);
      history[pos-- & 0xFF] = out[i];
    }
    return ret;
  }
};

// simple/*.c, the decoders of the BCJ filters: the bytes filtered
using Filter = size_t (*)(uint32_t* st, uint32_t now_pos, uint8_t* buf,
                          size_t size);

inline bool test86(uint8_t b) { return ((b + 1) & 0xFE) == 0; }

size_t x86_filter(uint32_t* st, uint32_t now_pos, uint8_t* buf, size_t size) {
  static const uint32_t mask_to_bit[8] = {0, 1, 2, 2, 3, 3, 3, 3};
  uint32_t prev_mask = st[0], prev_pos = st[1];
  if (size < 5) return 0;
  if (now_pos - prev_pos > 5) prev_pos = now_pos - 5;
  const size_t limit = size - 5;
  size_t i = 0;
  while (i <= limit) {
    uint8_t b = buf[i];
    if (b != 0xE8 && b != 0xE9) {
      ++i;
      continue;
    }
    const uint32_t offset = now_pos + static_cast<uint32_t>(i) - prev_pos;
    prev_pos = now_pos + static_cast<uint32_t>(i);
    if (offset > 5) {
      prev_mask = 0;
    } else {
      for (uint32_t k = 0; k < offset; ++k) {
        prev_mask &= 0x77;
        prev_mask <<= 1;
      }
    }
    b = buf[i + 4];
    if (test86(b) && (prev_mask >> 1) <= 4 && (prev_mask >> 1) != 3) {
      uint32_t src = (static_cast<uint32_t>(b) << 24) | (buf[i + 3] << 16) |
                     (buf[i + 2] << 8) | buf[i + 1];
      uint32_t dest;
      for (;;) {
        dest = src - (now_pos + static_cast<uint32_t>(i) + 5);
        if (prev_mask == 0) break;
        const uint32_t k = mask_to_bit[prev_mask >> 1];
        b = static_cast<uint8_t>(dest >> (24 - k * 8));
        if (!test86(b)) break;
        src = dest ^ ((1U << (32 - k * 8)) - 1);
      }
      buf[i + 4] = static_cast<uint8_t>(~(((dest >> 24) & 1) - 1));
      buf[i + 3] = static_cast<uint8_t>(dest >> 16);
      buf[i + 2] = static_cast<uint8_t>(dest >> 8);
      buf[i + 1] = static_cast<uint8_t>(dest);
      i += 5;
      prev_mask = 0;
    } else {
      ++i;
      prev_mask |= 1;
      if (test86(b)) prev_mask |= 0x10;
    }
  }
  st[0] = prev_mask;
  st[1] = prev_pos;
  return i;
}

size_t powerpc_filter(uint32_t*, uint32_t now_pos, uint8_t* buf, size_t size) {
  size &= ~static_cast<size_t>(3);
  size_t i;
  for (i = 0; i < size; i += 4) {
    if ((buf[i] >> 2) == 0x12 && (buf[i + 3] & 3) == 1) {
      const uint32_t src = ((static_cast<uint32_t>(buf[i]) & 3) << 24) |
                           (buf[i + 1] << 16) | (buf[i + 2] << 8) |
                           (buf[i + 3] & ~3U);
      const uint32_t dest = src - (now_pos + static_cast<uint32_t>(i));
      buf[i] = static_cast<uint8_t>(0x48 | ((dest >> 24) & 0x03));
      buf[i + 1] = static_cast<uint8_t>(dest >> 16);
      buf[i + 2] = static_cast<uint8_t>(dest >> 8);
      buf[i + 3] = static_cast<uint8_t>((buf[i + 3] & 0x03) | dest);
    }
  }
  return i;
}

size_t ia64_filter(uint32_t*, uint32_t now_pos, uint8_t* buf, size_t size) {
  static const uint32_t branch[32] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                      0, 0, 0, 0, 0, 4, 4, 6, 6, 0, 0,
                                      7, 7, 4, 4, 0, 0, 4, 4, 0, 0};
  size &= ~static_cast<size_t>(15);
  size_t i;
  for (i = 0; i < size; i += 16) {
    const uint32_t mask = branch[buf[i] & 0x1F];
    uint32_t bit_pos = 5;
    for (size_t slot = 0; slot < 3; ++slot, bit_pos += 41) {
      if (((mask >> slot) & 1) == 0) continue;
      const size_t byte_pos = bit_pos >> 3;
      const uint32_t bit_res = bit_pos & 7;
      uint64_t instr = 0;
      for (size_t j = 0; j < 6; ++j)
        instr += static_cast<uint64_t>(buf[i + j + byte_pos]) << (8 * j);
      uint64_t norm = instr >> bit_res;
      if (((norm >> 37) & 0xF) == 0x5 && ((norm >> 9) & 0x7) == 0) {
        uint32_t src = static_cast<uint32_t>((norm >> 13) & 0xFFFFF);
        src |= ((norm >> 36) & 1) << 20;
        src <<= 4;
        uint32_t dest = src - (now_pos + static_cast<uint32_t>(i));
        dest >>= 4;
        norm &= ~(static_cast<uint64_t>(0x8FFFFF) << 13);
        norm |= static_cast<uint64_t>(dest & 0xFFFFF) << 13;
        norm |= static_cast<uint64_t>(dest & 0x100000) << (36 - 20);
        instr &= (1U << bit_res) - 1;
        instr |= norm << bit_res;
        for (size_t j = 0; j < 6; ++j)
          buf[i + j + byte_pos] = static_cast<uint8_t>(instr >> (8 * j));
      }
    }
  }
  return i;
}

size_t arm_filter(uint32_t*, uint32_t now_pos, uint8_t* buf, size_t size) {
  size &= ~static_cast<size_t>(3);
  size_t i;
  for (i = 0; i < size; i += 4) {
    if (buf[i + 3] == 0xEB) {
      uint32_t src = (static_cast<uint32_t>(buf[i + 2]) << 16) |
                     (buf[i + 1] << 8) | buf[i];
      src <<= 2;
      uint32_t dest = src - (now_pos + static_cast<uint32_t>(i) + 8);
      dest >>= 2;
      buf[i + 2] = static_cast<uint8_t>(dest >> 16);
      buf[i + 1] = static_cast<uint8_t>(dest >> 8);
      buf[i] = static_cast<uint8_t>(dest);
    }
  }
  return i;
}

size_t armthumb_filter(uint32_t*, uint32_t now_pos, uint8_t* buf,
                       size_t size) {
  if (size < 4) return 0;
  size -= 4;
  size_t i;
  for (i = 0; i <= size; i += 2) {
    if ((buf[i + 1] & 0xF8) == 0xF0 && (buf[i + 3] & 0xF8) == 0xF8) {
      uint32_t src = ((static_cast<uint32_t>(buf[i + 1]) & 7) << 19) |
                     (buf[i] << 11) | ((buf[i + 3] & 7) << 8) | buf[i + 2];
      src <<= 1;
      uint32_t dest = src - (now_pos + static_cast<uint32_t>(i) + 4);
      dest >>= 1;
      buf[i + 1] = static_cast<uint8_t>(0xF0 | ((dest >> 19) & 0x7));
      buf[i] = static_cast<uint8_t>(dest >> 11);
      buf[i + 3] = static_cast<uint8_t>(0xF8 | ((dest >> 8) & 0x7));
      buf[i + 2] = static_cast<uint8_t>(dest);
      i += 2;
    }
  }
  return i;
}

size_t sparc_filter(uint32_t*, uint32_t now_pos, uint8_t* buf, size_t size) {
  size &= ~static_cast<size_t>(3);
  size_t i;
  for (i = 0; i < size; i += 4) {
    if ((buf[i] == 0x40 && (buf[i + 1] & 0xC0) == 0x00) ||
        (buf[i] == 0x7F && (buf[i + 1] & 0xC0) == 0xC0)) {
      uint32_t src = (static_cast<uint32_t>(buf[i]) << 24) |
                     (buf[i + 1] << 16) | (buf[i + 2] << 8) | buf[i + 3];
      src <<= 2;
      uint32_t dest = src - (now_pos + static_cast<uint32_t>(i));
      dest >>= 2;
      dest = (((0U - ((dest >> 22) & 1)) << 22) & 0x3FFFFFFF) |
             (dest & 0x3FFFFF) | 0x40000000;
      buf[i] = static_cast<uint8_t>(dest >> 24);
      buf[i + 1] = static_cast<uint8_t>(dest >> 16);
      buf[i + 2] = static_cast<uint8_t>(dest >> 8);
      buf[i + 3] = static_cast<uint8_t>(dest);
    }
  }
  return i;
}

size_t arm64_filter(uint32_t*, uint32_t now_pos, uint8_t* buf, size_t size) {
  size &= ~static_cast<size_t>(3);
  size_t i;
  for (i = 0; i < size; i += 4) {
    uint32_t pc = now_pos + static_cast<uint32_t>(i);
    uint32_t instr = rd32(buf + i);
    if ((instr >> 26) == 0x25) {
      const uint32_t src = instr;
      instr = 0x94000000;
      pc >>= 2;
      pc = 0U - pc;
      instr |= (src + pc) & 0x03FFFFFF;
      wr32(buf + i, instr);
    } else if ((instr & 0x9F000000) == 0x90000000) {
      const uint32_t src = ((instr >> 29) & 3) | ((instr >> 3) & 0x001FFFFC);
      if ((src + 0x00020000) & 0x001C0000) continue;
      instr &= 0x9000001F;
      pc >>= 12;
      pc = 0U - pc;
      const uint32_t dest = src + pc;
      instr |= (dest & 3) << 29;
      instr |= (dest & 0x0003FFFC) << 3;
      instr |= (0U - (dest & 0x00020000)) & 0x00E00000;
      wr32(buf + i, instr);
    }
  }
  return i;
}

size_t riscv_filter(uint32_t*, uint32_t now_pos, uint8_t* buf, size_t size) {
  if (size < 8) return 0;
  size -= 8;
  size_t i;
  for (i = 0; i <= size; i += 2) {
    uint32_t inst = buf[i];
    if (inst == 0xEF) {
      const uint32_t b1 = buf[i + 1];
      if ((b1 & 0x0D) != 0) continue;
      const uint32_t b2 = buf[i + 2], b3 = buf[i + 3];
      const uint32_t pc = now_pos + static_cast<uint32_t>(i);
      uint32_t addr = ((b1 & 0xF0) << 13) | (b2 << 9) | (b3 << 1);
      addr -= pc;
      buf[i + 1] = static_cast<uint8_t>((b1 & 0x0F) | ((addr >> 8) & 0xF0));
      buf[i + 2] = static_cast<uint8_t>(((addr >> 16) & 0x0F) |
                                        ((addr >> 7) & 0x10) |
                                        ((addr << 4) & 0xE0));
      buf[i + 3] = static_cast<uint8_t>(((addr >> 4) & 0x7F) |
                                        ((addr >> 13) & 0x80));
      i += 4 - 2;
    } else if ((inst & 0x7F) == 0x17) {
      uint32_t inst2;
      inst |= static_cast<uint32_t>(buf[i + 1]) << 8;
      inst |= static_cast<uint32_t>(buf[i + 2]) << 16;
      inst |= static_cast<uint32_t>(buf[i + 3]) << 24;
      if (inst & 0xE80) {
        inst2 = rd32(buf + i + 4);
        if ((static_cast<uint32_t>(inst << 8) ^ (inst2 - 3)) & 0xF8003) {
          i += 6 - 2;
          continue;
        }
        uint32_t addr = inst & 0xFFFFF000;
        addr += inst2 >> 20;
        inst = 0x17 | (2 << 7) | (inst2 << 12);
        inst2 = addr;
      } else {
        const uint32_t inst2_rs1 = inst >> 27;
        if (static_cast<uint32_t>((inst - 0x3117) << 18) >=
            (inst2_rs1 & 0x1D)) {
          i += 4 - 2;
          continue;
        }
        uint32_t addr = (static_cast<uint32_t>(buf[i + 4]) << 24) |
                        (buf[i + 5] << 16) | (buf[i + 6] << 8) | buf[i + 7];
        addr -= now_pos + static_cast<uint32_t>(i);
        inst2 = (inst >> 12) | (addr << 20);
        inst = 0x17 | (inst2_rs1 << 7) | ((addr + 0x800) & 0xFFFFF000);
      }
      wr32(buf + i, inst);
      wr32(buf + i + 4, inst2);
      i += 8 - 2;
    }
  }
  return i;
}

// simple_coder.c
struct SimpleCoder : Coder {
  std::unique_ptr<Coder> next;
  Filter filter;
  uint32_t st[2] = {0, 0xFFFFFFFBU};   // x86's prev_mask and prev_pos
  uint32_t now_pos = 0;
  bool end_was_reached = false;
  size_t pos = 0, filtered = 0, size = 0, allocated = 0;
  std::vector<uint8_t> buffer;

  SimpleCoder(Filter f, size_t unfiltered_max, uint32_t start)
      : filter(f), now_pos(start), allocated(2 * unfiltered_max),
        buffer(2 * unfiltered_max) {}

  int copy_or_code(const uint8_t* in, size_t* in_pos, size_t in_size,
                   uint8_t* out, size_t* out_pos, size_t out_size) {
    const int ret = next->code(in, in_pos, in_size, out, out_pos, out_size);
    if (ret == kEnd) end_was_reached = true;
    else if (ret != kOk) return ret;
    return kOk;
  }
  size_t call_filter(uint8_t* b, size_t n) {
    const size_t done = filter(st, now_pos, b, n);
    now_pos += static_cast<uint32_t>(done);
    return done;
  }
  int code(const uint8_t* in, size_t* in_pos, size_t in_size, uint8_t* out,
           size_t* out_pos, size_t out_size) override {
    if (pos < filtered) {
      bufcpy(buffer.data(), &pos, filtered, out, out_pos, out_size);
      if (pos < filtered) return kOk;
      if (end_was_reached) return kEnd;
    }
    filtered = 0;
    const size_t out_avail = out_size - *out_pos;
    const size_t buf_avail = size - pos;
    if (out_avail > buf_avail || buf_avail == 0) {
      const size_t out_start = *out_pos;
      if (buf_avail > 0)
        std::memcpy(out + *out_pos, buffer.data() + pos, buf_avail);
      *out_pos += buf_avail;
      {
        const int ret = copy_or_code(in, in_pos, in_size, out, out_pos,
                                     out_size);
        if (ret != kOk) return ret;
      }
      const size_t n = *out_pos - out_start;
      const size_t done = n == 0 ? 0 : call_filter(out + out_start, n);
      const size_t unfiltered = n - done;
      pos = 0;
      size = unfiltered;
      if (end_was_reached) {
        size = 0;
      } else if (unfiltered > 0) {
        *out_pos -= unfiltered;
        std::memcpy(buffer.data(), out + *out_pos, unfiltered);
      }
    } else if (pos > 0) {
      std::memmove(buffer.data(), buffer.data() + pos, buf_avail);
      size -= pos;
      pos = 0;
    }
    if (size > 0) {
      {
        const int ret = copy_or_code(in, in_pos, in_size, buffer.data(),
                                     &size, allocated);
        if (ret != kOk) return ret;
      }
      filtered = call_filter(buffer.data(), size);
      if (end_was_reached) filtered = size;
      bufcpy(buffer.data(), &pos, filtered, out, out_pos, out_size);
    }
    if (end_was_reached && pos == size) return kEnd;
    return kOk;
  }
};

// -- the block (block_header_decoder.c, block_decoder.c) ----------------------

// lzma_vli_decode in single-call mode; false on error
bool vli(const uint8_t* in, size_t* in_pos, size_t in_size, uint64_t* v) {
  *v = 0;
  size_t n = 0;
  if (*in_pos >= in_size) return false;
  do {
    const uint8_t b = in[(*in_pos)++];
    *v += static_cast<uint64_t>(b & 0x7F) << (n * 7);
    ++n;
    if ((b & 0x80) == 0) return !(b == 0 && n > 1);
    if (n == 9) return false;
  } while (*in_pos < in_size);
  return false;
}

struct FilterSpec {
  uint64_t id;
  uint32_t arg;       // delta distance, BCJ start offset, LZMA2 dict size
};

struct Block {
  std::unique_ptr<Coder> chain;
  unsigned check_id = 0;
  size_t header_size = 0;
  uint64_t comp_decl = kUnknown, unc_decl = kUnknown;
  uint64_t comp_limit = 0, unc_limit = 0, comp = 0, unc = 0;
  int seq = 0;                  // 0 data, 1 padding, 2 check
  Check check;
  uint8_t raw_check[64];
  size_t check_pos = 0;

  // lzma_block_header_decode, the chain's validation and the block
  // decoder's initialization: false where liblzma refuses the header
  bool init(const uint8_t* h, size_t hsize, unsigned cid, size_t cap) {
    check_id = cid;
    header_size = hsize;
    const size_t n = hsize - 4;
    if (crc32(h, n, 0) != rd32(h + n)) return false;
    if (h[1] & 0x3C) return false;
    size_t p = 2;
    if (h[1] & 0x40) {
      if (!vli(h, &p, n, &comp_decl)) return false;
      if (comp_decl == 0 || comp_decl > kVliMax) return false;
      const uint64_t unpadded = comp_decl + hsize + check_size(cid);
      if (unpadded > (kVliMax & ~uint64_t{3})) return false;
    }
    if (h[1] & 0x80) {
      if (!vli(h, &p, n, &unc_decl)) return false;
    }
    std::vector<FilterSpec> filters;
    const size_t count = (h[1] & 3U) + 1;
    for (size_t k = 0; k < count; ++k) {
      uint64_t id, psize;
      if (!vli(h, &p, n, &id)) return false;
      if (id >= 0x4000000000000000ULL) return false;
      if (!vli(h, &p, n, &psize)) return false;
      if (n - p < psize) return false;
      const uint8_t* props = h + p;
      FilterSpec f{id, 0};
      if (id == 0x21) {                    // LZMA2
        if (psize != 1) return false;
        if (props[0] & 0xC0) return false;
        if (props[0] > 40) return false;
        f.arg = props[0] == 40 ? 0xFFFFFFFFU
                               : (2U | (props[0] & 1U)) << (props[0] / 2 + 11);
      } else if (id == 0x03) {             // delta
        if (psize != 1) return false;
        f.arg = props[0] + 1U;
      } else if (id >= 0x04 && id <= 0x0B) {   // BCJ
        if (psize != 0 && psize != 4) return false;
        f.arg = psize == 4 ? rd32(props) : 0;
      } else {
        // LZMA1 and filters liblzma does not decode: not read here
        return false;
      }
      p += static_cast<size_t>(psize);
      filters.push_back(f);
    }
    while (p < n)
      if (h[p++] != 0) return false;
    // validate_chain: LZMA2 last and only last
    for (size_t k = 0; k < filters.size(); ++k)
      if ((filters[k].id == 0x21) != (k + 1 == filters.size())) return false;
    // the chain, LZMA2 innermost
    std::unique_ptr<Coder> c(new LzCoder(filters.back().arg, cap));
    static const size_t unfiltered_max[12] = {0, 0, 0, 0, 5, 4, 16, 4,
                                              4, 4, 4, 8};
    static const Filter fns[12] = {nullptr,        nullptr,       nullptr,
                                   nullptr,        x86_filter,    powerpc_filter,
                                   ia64_filter,    arm_filter,    armthumb_filter,
                                   sparc_filter,   arm64_filter,  riscv_filter};
    static const uint32_t alignment[12] = {0, 0, 0, 0, 1, 4, 16, 4, 2, 4, 4, 2};
    for (size_t k = filters.size() - 1; k-- > 0;) {
      const FilterSpec& f = filters[k];
      if (f.id == 0x03) {
        auto* d = new DeltaCoder;
        d->distance = f.arg;
        d->next = std::move(c);
        c.reset(d);
      } else {
        if (f.arg % alignment[f.id]) return false;
        auto* s = new SimpleCoder(fns[f.id], unfiltered_max[f.id], f.arg);
        s->next = std::move(c);
        c.reset(s);
      }
    }
    chain = std::move(c);
    comp_limit = comp_decl == kUnknown
                     ? (kVliMax & ~uint64_t{3}) - hsize - check_size(cid)
                     : comp_decl;
    unc_limit = unc_decl == kUnknown ? kVliMax : unc_decl;
    check.id = check_supported(cid) ? cid : 0;
    return true;
  }

  int code(const uint8_t* in, size_t* in_pos, size_t in_size, uint8_t* out,
           size_t* out_pos, size_t out_size) {
    if (seq == 0) {
      const size_t in_start = *in_pos, out_start = *out_pos;
      const uint64_t in_room = comp_limit - comp, out_room = unc_limit - unc;
      const size_t in_stop =
          *in_pos + static_cast<size_t>(in_size - *in_pos < in_room
                                            ? in_size - *in_pos
                                            : in_room);
      const size_t out_stop =
          *out_pos + static_cast<size_t>(out_size - *out_pos < out_room
                                             ? out_size - *out_pos
                                             : out_room);
      const int ret =
          chain->code(in, in_pos, in_stop, out, out_pos, out_stop);
      comp += *in_pos - in_start;
      unc += *out_pos - out_start;
      if (ret == kOk) {
        const bool comp_done = comp == comp_decl;
        const bool unc_done = unc == unc_decl;
        if (comp_done && unc_done) return kError;
        if (comp_done && *out_pos < out_size) return kError;
        if (unc_done && *in_pos < in_size) return kError;
      }
      if (*out_pos > out_start)
        check.update(out + out_start, *out_pos - out_start);
      if (ret != kEnd) return ret;
      if ((comp_decl != kUnknown && comp_decl != comp) ||
          (unc_decl != kUnknown && unc_decl != unc))
        return kError;
      seq = 1;
    }
    if (seq == 1) {
      while (comp & 3) {
        if (*in_pos >= in_size) return kOk;
        ++comp;
        if (in[(*in_pos)++] != 0) return kError;
      }
      if (check_id == 0) return kEnd;
      check.finish(check_buf);
      seq = 2;
    }
    const size_t csize = check_size(check_id);
    bufcpy(in, in_pos, in_size, raw_check, &check_pos, csize);
    if (check_pos < csize) return kOk;
    if (check_supported(check_id) && std::memcmp(raw_check, check_buf, csize))
      return kError;
    return kEnd;
  }
  uint8_t check_buf[64] = {0};
};

// -- the stream (stream_decoder.c) ---------------------------------------------

struct Stream {
  int seq = 0;                  // 0 header, 1 block header, 2 block, 3 index
  uint8_t buf[1024];
  size_t pos = 0, header_size = 0, cap = 0;
  unsigned check_id = 0;
  std::unique_ptr<Block> block;

  int code(const uint8_t* in, size_t* in_pos, size_t in_size, uint8_t* out,
           size_t* out_pos, size_t out_size) {
    for (;;) {
      if (seq == 0) {
        bufcpy(in, in_pos, in_size, buf, &pos, 12);
        if (pos < 12) return kOk;
        pos = 0;
        static const uint8_t magic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
        if (std::memcmp(buf, magic, 6)) return kError;
        if (crc32(buf + 6, 2, 0) != rd32(buf + 8)) return kError;
        if (buf[6] != 0 || (buf[7] & 0xF0)) return kError;
        check_id = buf[7] & 0x0F;
        seq = 1;
      }
      if (seq == 1) {
        if (*in_pos >= in_size) return kOk;
        if (pos == 0) {
          if (in[*in_pos] == 0) {
            seq = 3;
            continue;
          }
          header_size = (in[*in_pos] + 1U) * 4;
        }
        bufcpy(in, in_pos, in_size, buf, &pos, header_size);
        if (pos < header_size) return kOk;
        pos = 0;
        block.reset(new Block);
        if (!block->init(buf, header_size, check_id, cap)) return kError;
        seq = 2;
      }
      if (seq == 2) {
        const int ret = block->code(in, in_pos, in_size, out, out_pos, out_size);
        if (ret != kEnd) return ret;
        seq = 1;
        continue;
      }
      return kDone;                 // the index: nothing more is written
    }
  }
};

// LZMADecode's loop over lzma_code
bool xz_chunk(const uint8_t* src, size_t n, uint8_t* dst, size_t occ) {
  Stream s;
  s.cap = occ;
  size_t in_pos = 0, out_pos = 0;
  bool allow_buf_error = false;
  while (out_pos < occ) {
    const size_t ip = in_pos, op = out_pos;
    int ret = s.code(src, &in_pos, n, dst, &out_pos, occ);
    if (ret == kOk) {
      if (in_pos == ip && out_pos == op) {
        if (allow_buf_error) break;
        allow_buf_error = true;
      } else {
        allow_buf_error = false;
      }
      continue;
    }
    break;
  }
  if (out_pos < occ) std::memset(dst + out_pos, 0, occ - out_pos);
  return out_pos == occ;
}

}  // namespace

extern "C" {

// One chunk of an LZMA-compressed TIFF (compression 34925) as libtiff's
// LZMADecode decodes it into occ bytes at dst. 1: kept; 0: refused, the
// bytes past the output position zeroed as LZMADecode zeroes them.
int xz_tiff_chunk(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ) {
  return xz_chunk(src, static_cast<size_t>(n), dst, static_cast<size_t>(occ))
             ? 1
             : 0;
}

}  // extern "C"
