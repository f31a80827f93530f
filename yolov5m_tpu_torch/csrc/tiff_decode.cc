// libtiff 4.7.1's side of a compressed TIFF for the yolov5m_tpu_torch data
// pipeline: what Pillow 12.1.0's TiffDecode.c gets back from
// TIFFReadEncodedStrip and TIFFReadEncodedTile, without libtiff.
//
// data/tiff.py reads libtiff's directory, picks the strips or tiles
// Pillow's loop reads (each with its offset, its byte count, already held
// to the file, and the bytes it decodes to), inflates deflate chunks with
// Python's zlib, and hands the list to tiff_decode_chunks, which for each
// chunk in turn, as TIFFFillStrip and the codec do:
//
//   - reverses the bits of each byte of the chunk for fill order 2;
//   - decodes it: PackBits (tif_packbits.c: a run cut at the end of the
//     output is discarded, a run past the end of the input ends the
//     chunk, output short of the chunk's size is refused) or LZW
//     (tif_lzw.c: codes MSB first with the early code-width change, and
//     the old-style LSB-first stream, "LZWDecodeCompat", which a chunk
//     that starts with 0x00 and an odd byte selects while no chunk before
//     it chose the new style; once chosen it decodes every later chunk);
//     deflate chunks arrive inflated and are copied;
//   - undoes the predictor row by row (tif_predict.c): horizontal
//     differencing at 8, 16 and 32 bits (16 and 32 swapped to the host's
//     order first), the floating-point predictor (bytes accumulated, then
//     the byte planes interleaved in the host's order);
//   - swaps 16-, 24-, 32- and 64-bit samples to the host's order where
//     no predictor did (the post-decode swab).
//
// Each chunk lands at out + i * stride. It returns 0, or -1 - i for the
// first chunk i that libtiff refuses: the whole image is then refused, as
// Pillow refuses it. Pure C++ without shared state.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBitsMin = 9, kBitsMax = 12;
constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kCsize = (1 << kBitsMax) - 1 + 1024;  // MAXCODE(12) + 1024

inline int maxcode(int n) { return (1 << n) - 1; }

struct Code {
  int next;          // index of the prefix entry, -1 for none
  uint16_t length;   // string length, this token included
  uint8_t firstchar;
  uint8_t value;
};

// tif_packbits.c:PackBitsDecode
bool packbits(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ) {
  while (cc > 0 && occ > 0) {
    int64_t n = static_cast<int8_t>(*bp++);
    cc--;
    if (n < 0) {
      if (n == -128) continue;
      n = -n + 1;
      if (occ < n) n = occ;
      if (cc == 0) break;
      occ -= n;
      const uint8_t b = *bp++;
      cc--;
      std::memset(op, b, static_cast<size_t>(n));
      op += n;
    } else {
      if (occ < n + 1) n = occ - 1;
      if (cc < n + 1) break;
      ++n;
      std::memcpy(op, bp, static_cast<size_t>(n));
      op += n;
      occ -= n;
      bp += n;
      cc -= n;
    }
  }
  return occ == 0;
}

// Writes the first occ bytes of entry c's string (or all of it) at op.
void emit(const std::vector<Code>& tab, int c, uint8_t* op, int64_t occ) {
  int64_t len = tab[c].length;
  while (len > occ) {            // keep the prefix that fits
    c = tab[c].next;
    len--;
  }
  for (int64_t i = len - 1; i >= 0; --i) {
    op[i] = tab[c].value;
    c = tab[c].next;
  }
}

void reset_literals(std::vector<Code>& tab) {
  for (int i = 0; i < 256; ++i)
    tab[i] = Code{-1, 1, static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  tab[kClear] = tab[kEoi] = Code{-1, 0, 0, 0};
}

// tif_lzw.c:LZWDecode, one call for the whole chunk: MSB-first codes,
// the code width grows one code early; the stream must start with a
// clear code and may not use a code not yet in the table.
bool lzw_new(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ,
             std::vector<Code>& tab) {
  reset_literals(tab);
  int64_t bitsleft = cc * 8;
  uint64_t nextdata = 0;
  int nextbits = 0, nbits = kBitsMin;
  int free_ent = -1;             // dec_codetab - 1: nothing may be added
  int maxcode_ent = maxcode(kBitsMin) - 1;
  int oldcode = -2;              // &code_clear
  auto get = [&](int& code) -> bool {
    while (nextbits < nbits) {
      if (bitsleft < 8) return false;
      nextdata = (nextdata << 8) | *bp++;
      bitsleft -= 8;
      nextbits += 8;
    }
    nextbits -= nbits;
    code = static_cast<int>((nextdata >> nextbits) & maxcode(nbits));
    return true;
  };
  auto add = [&](uint8_t value) {
    Code& e = tab[free_ent];
    e.next = oldcode;
    e.firstchar = tab[oldcode].firstchar;
    e.length = static_cast<uint16_t>(tab[oldcode].length + 1);
    e.value = value;
    if (++free_ent > maxcode_ent) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode_ent = maxcode(nbits) - 1;
      if (free_ent >= kCsize) free_ent = -1;
    }
  };
  while (occ > 0) {
    int code;
    if (!get(code)) return false;                 // no EOI
    if (code == kClear) {
      free_ent = kFirst;
      nbits = kBitsMin;
      maxcode_ent = maxcode(kBitsMin) - 1;
      do {
        if (!get(code)) return false;
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kEoi) return false;
      *op++ = static_cast<uint8_t>(code);
      occ--;
      oldcode = code;
      continue;
    }
    if (code == kEoi) break;
    if (code < 256) {
      if (free_ent < 0 || code > free_ent || oldcode < 0) return false;
      add(static_cast<uint8_t>(code));
      oldcode = code;
      *op++ = static_cast<uint8_t>(code);
      occ--;
      continue;
    }
    if (free_ent < 0 || code > free_ent || oldcode < 0) return false;
    const uint8_t value = code == free_ent ? tab[oldcode].firstchar
                                           : tab[code].firstchar;
    add(value);
    oldcode = code;
    const int64_t len = tab[code].length;
    emit(tab, code, op, occ);
    const int64_t n = len < occ ? len : occ;
    op += n;
    occ -= n;
  }
  return occ == 0;
}

// tif_lzw.c:LZWDecodeCompat: LSB-first codes, the width grows when the
// table passes the largest code of the width; an undefined code is refused
// by its zero length.
bool lzw_compat(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ,
                std::vector<Code>& tab) {
  reset_literals(tab);
  for (int i = kFirst; i < kCsize; ++i) tab[i] = Code{-1, 0, 0, 0};
  int64_t bitsleft = cc * 8;
  uint64_t nextdata = 0;
  int nextbits = 0, nbits = kBitsMin;
  int free_ent = -1, maxcode_ent = maxcode(kBitsMin);
  int oldcode = -2;
  auto get = [&](int& code) -> bool {
    if (bitsleft < nbits) return false;
    nextdata |= static_cast<uint64_t>(*bp++) << nextbits;
    nextbits += 8;
    if (nextbits < nbits) {
      nextdata |= static_cast<uint64_t>(*bp++) << nextbits;
      nextbits += 8;
    }
    code = static_cast<int>(nextdata & maxcode(nbits));
    nextdata >>= nbits;
    nextbits -= nbits;
    bitsleft -= nbits;
    return true;
  };
  while (occ > 0) {
    int code;
    if (!get(code)) break;                        // warned, not refused
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int i = kFirst; i < kCsize; ++i) tab[i] = Code{-1, 0, 0, 0};
        nbits = kBitsMin;
        maxcode_ent = maxcode(kBitsMin);
        if (!get(code)) return false;
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return false;
      *op++ = static_cast<uint8_t>(code);
      occ--;
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kCsize || oldcode < 0) return false;
    Code& e = tab[free_ent];
    e.next = oldcode;
    e.firstchar = tab[oldcode].firstchar;
    e.length = static_cast<uint16_t>(tab[oldcode].length + 1);
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxcode_ent) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode_ent = maxcode(nbits);
    }
    oldcode = code;
    if (code >= 256) {
      if (tab[code].length == 0) return false;
      const int64_t len = tab[code].length;
      emit(tab, code, op, occ);
      const int64_t n = len < occ ? len : occ;
      op += n;
      occ -= n;
    } else {
      *op++ = static_cast<uint8_t>(code);
      occ--;
    }
  }
  return occ == 0;
}

uint8_t reversed(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

void swab(uint8_t* p, int64_t n, int width) {
  for (int64_t i = 0; i + width <= n; i += width)
    for (int a = 0, b = width - 1; a < b; ++a, --b) {
      const uint8_t t = p[i + a];
      p[i + a] = p[i + b];
      p[i + b] = t;
    }
}

// tif_predict.c: horAcc8/16/32 (swabHorAcc16/32) and fpAcc, on one row
bool predict_row(uint8_t* row, int64_t cc, int predictor, int bps,
                 int stride, bool swap, std::vector<uint8_t>& tmp) {
  if (predictor == 2) {
    const int width = bps / 8;
    if (cc % (static_cast<int64_t>(width) * stride) != 0) return false;
    if (swap && width > 1) swab(row, cc, width);
    const int64_t n = cc / width;
    if (width == 1) {
      for (int64_t i = stride; i < n; ++i)
        row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
    } else if (width == 2) {
      uint16_t* w = reinterpret_cast<uint16_t*>(row);
      for (int64_t i = stride; i < n; ++i)
        w[i] = static_cast<uint16_t>(w[i] + w[i - stride]);
    } else {
      uint32_t* w = reinterpret_cast<uint32_t*>(row);
      for (int64_t i = stride; i < n; ++i) w[i] += w[i - stride];
    }
    return true;
  }
  // predictor 3
  const int64_t width = bps / 8;
  if (cc % (width * stride) != 0) return false;
  for (int64_t i = stride; i < cc; ++i)
    row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
  tmp.assign(row, row + cc);
  const int64_t wc = cc / width;
  for (int64_t c = 0; c < wc; ++c)
    for (int64_t b = 0; b < width; ++b)
      row[width * c + b] = tmp[(width - b - 1) * wc + c];   // little-endian
  return true;
}

}  // namespace

extern "C" {

// codec: 5 LZW, 32773 PackBits, 8 an inflated chunk (copied). predictor
// 1, 2 or 3 with bps and the accumulation stride (samples a pixel, 1 when
// planar); rowsize: bytes a row (TIFFScanlineSize or TIFFTileRowSize).
// swap: the file's byte order is not the host's; reverse: fill order 2.
int64_t tiff_decode_chunks(const uint8_t* data, const int64_t* offsets,
                           const int64_t* counts, const int64_t* occs,
                           int64_t n, uint8_t* out, int64_t stride,
                           int codec, int predictor, int bps, int spp_stride,
                           int64_t rowsize, int swap, int reverse) {
  std::vector<Code> tab(kCsize);
  std::vector<uint8_t> raw, tmp;
  int compat = -1;     // LZW: -1 until a chunk picks the style
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* src = data + offsets[i];
    const int64_t cc = counts[i], occ = occs[i];
    uint8_t* op = out + i * stride;
    if (reverse && codec != 8) {
      raw.resize(static_cast<size_t>(cc));
      for (int64_t j = 0; j < cc; ++j) raw[j] = reversed(src[j]);
      src = raw.data();
    }
    bool ok;
    if (codec == 32773) {
      ok = packbits(src, cc, op, occ);
    } else if (codec == 5) {
      const bool old = cc >= 2 && src[0] == 0 && (src[1] & 1);
      if (old && compat < 0) compat = 1;
      else if (!old && compat < 0) compat = 0;
      ok = compat ? lzw_compat(src, cc, op, occ, tab)
                  : lzw_new(src, cc, op, occ, tab);
    } else {
      ok = cc >= occ;
      if (ok) std::memcpy(op, src, static_cast<size_t>(occ));
    }
    if (!ok) return -1 - i;
    if (predictor == 2 || predictor == 3) {
      if (rowsize <= 0 || occ % rowsize != 0) return -1 - i;
      for (int64_t r = 0; r < occ; r += rowsize)
        if (!predict_row(op + r, rowsize, predictor, bps, spp_stride,
                         swap != 0, tmp))
          return -1 - i;
    } else if (swap && (bps == 16 || bps == 24 || bps == 32 || bps == 64)) {
      swab(op, occ, bps / 8);
    }
  }
  return 0;
}

}  // extern "C"
