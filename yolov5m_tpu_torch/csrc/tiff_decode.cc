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
//
// YCbCr that Pillow reads through libtiff's TIFFRGBAImage (every YCbCr
// file but JPEG in one plane) ends in tif_getimage.c's putters and
// tif_color.c's conversion: tiff_ycbcr_tables is TIFFYCbCrToRGBInit (in
// float, FP contraction off, as libtiff's C computes it),
// tiff_ycbcr_put the putters of packed sampling blocks (1x1, 1x2, 2x1,
// 2x2, 4x1, 4x2, 4x4) and tiff_ycbcr_put_separate putseparate8bitYCbCr11
// tile, each with its raster and input pointers' arithmetic (the skews of
// a flipped raster and of a clipped tile), held to the buffers given.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#pragma GCC optimize("fp-contract=off")

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

// csrc/zstd_decode.cc and csrc/xz_decode.cc: libtiff's ZSTDDecode and
// LZMADecode of one chunk (1 kept, 0 refused: the bytes past what the
// library reports written zeroed, as libtiff zeroes them)
int zstd_tiff_chunk_in(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t occ, int64_t* ctx);
int xz_tiff_chunk(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ);

// codec: 5 LZW, 32773 PackBits, 50000 ZSTD, 34925 LZMA, 8 an inflated
// chunk (copied). predictor
// 1, 2 or 3 with bps and the accumulation stride (samples a pixel, 1 when
// planar); rowsize: bytes a row (TIFFScanlineSize or TIFFTileRowSize).
// swap: the file's byte order is not the host's; reverse: fill order 2.
// status: null, or where every chunk is decoded whatever the others do
// (TIFFRGBAImage reads on past a failure), 0 or 1 (refused: the bytes
// the codec wrote are kept, neither predictor nor swab applied) a chunk.
int64_t tiff_decode_chunks(const uint8_t* data, const int64_t* offsets,
                           const int64_t* counts, const int64_t* occs,
                           int64_t n, uint8_t* out, int64_t stride,
                           int codec, int predictor, int bps, int spp_stride,
                           int64_t rowsize, int swap, int reverse,
                           int64_t* status) {
  std::vector<Code> tab(kCsize);
  std::vector<uint8_t> raw, tmp;
  int compat = -1;     // LZW: -1 until a chunk picks the style
  int64_t zstd_ctx[3] = {0, 0, 0};   // ZSTD: the stream's legacy context
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
    } else if (codec == 50000) {
      ok = zstd_tiff_chunk_in(src, cc, op, occ, zstd_ctx) == 1;
    } else if (codec == 34925) {
      ok = xz_tiff_chunk(src, cc, op, occ) == 1;
    } else {
      ok = cc >= occ;
      if (ok) std::memcpy(op, src, static_cast<size_t>(occ));
    }
    if (ok && (predictor == 2 || predictor == 3)) {
      ok = rowsize > 0 && occ % rowsize == 0;
      for (int64_t r = 0; ok && r < occ; r += rowsize)
        ok = predict_row(op + r, rowsize, predictor, bps, spp_stride,
                         swap != 0, tmp);
    } else if (ok && swap &&
               (bps == 16 || bps == 24 || bps == 32 || bps == 64)) {
      swab(op, occ, bps / 8);
    }
    if (status) {
      status[i] = ok ? 0 : 1;
    } else if (!ok) {
      return -1 - i;
    }
  }
  return 0;
}

// TIFFYCbCrToRGBInit (tif_color.c) from YCbCrCoefficients and
// ReferenceBlackWhite into five tables of 256: Cr_r, Cb_b, Cr_g, Cb_g, Y.
// Returns -1 where initYCbCrConversion refuses the values (a NaN
// coefficient, green near 0, a reference value out of range).
int tiff_ycbcr_tables(const float* luma, const float* refbw, int32_t* tabs) {
  if (std::isnan(luma[0]) || std::isnan(luma[1]) ||
      std::fabs(luma[1] - 0.0) < 0.0000001 || std::isnan(luma[2]))
    return -1;
  for (int i = 0; i < 6; ++i)
    if (!(refbw[i] > static_cast<float>(-0x7FFFFFFF + 128) &&
          refbw[i] < static_cast<float>(0x7FFFFFFF)))
      return -1;
  auto clamp = [](float f, float lo, float hi) {
    return f < lo ? lo : f > hi ? hi : f;
  };
  auto fix = [](float x) {
    return static_cast<int32_t>(x * static_cast<float>(1L << 16) + 0.5);
  };
  // Code2V, then CLAMPw to +-128 * 32 and the cast
  auto code2v = [](int c, float rb, float rw, int cr) {
    const float den = (rw - rb != 0) ? (rw - rb) : 1;
    const float v = (static_cast<float>(c - static_cast<int32_t>(rb)) *
                     static_cast<float>(cr)) / den;
    const float lo = -128.0F * 32, hi = 128.0F * 32;
    return static_cast<int32_t>(v < lo ? lo : v > hi ? hi : v);
  };
  const float f1 = 2 - 2 * luma[0];
  const int32_t d1 = fix(clamp(f1, 0.0F, 2.0F));
  const float f2 = luma[0] * f1 / luma[1];
  const int32_t d2 = -fix(clamp(f2, 0.0F, 2.0F));
  const float f3 = 2 - 2 * luma[2];
  const int32_t d3 = fix(clamp(f3, 0.0F, 2.0F));
  const float f4 = luma[2] * f3 / luma[1];
  const int32_t d4 = -fix(clamp(f4, 0.0F, 2.0F));
  int32_t* cr_r = tabs;
  int32_t* cb_b = tabs + 256;
  int32_t* cr_g = tabs + 512;
  int32_t* cb_g = tabs + 768;
  int32_t* y_tab = tabs + 1024;
  const int32_t half = 1 << 15;
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    const int32_t cr = code2v(x, refbw[4] - 128.0F, refbw[5] - 128.0F, 127);
    const int32_t cb = code2v(x, refbw[2] - 128.0F, refbw[3] - 128.0F, 127);
    cr_r[i] = (d1 * cr + half) >> 16;
    cb_b[i] = (d3 * cb + half) >> 16;
    cr_g[i] = d2 * cr;
    cb_g[i] = d4 * cb + half;
    y_tab[i] = code2v(x + 128, refbw[0], refbw[1], 255);
  }
  return 0;
}

}  // extern "C"

namespace {

struct OutOfRange {};

// a raster of RGBA pixels and a run of input bytes, indexed as
// tif_getimage.c moves its pointers, each access held to the buffer
struct Putter {
  const int32_t* tabs;
  uint8_t* raster;
  int64_t npix;
  const uint8_t* in;
  int64_t nin;

  int at(int64_t i) const {
    if (i < 0 || i >= nin) throw OutOfRange();
    return in[i];
  }
  // TIFFYCbCrtoRGB into pixel cp (R, G, B, A 255: PACK's bytes)
  void put(int64_t cp, int y, int cb, int cr) const {
    if (cp < 0 || cp >= npix) throw OutOfRange();
    const int32_t* t = tabs;
    y = y > 255 ? 255 : y;
    const int32_t yv = t[1024 + y];
    auto c = [](int32_t v) { return v < 0 ? 0 : v > 255 ? 255 : v; };
    uint8_t* p = raster + cp * 4;
    p[0] = static_cast<uint8_t>(c(yv + t[cr]));
    p[1] = static_cast<uint8_t>(
        c(yv + static_cast<int>((t[768 + cb] + t[512 + cr]) >> 16)));
    p[2] = static_cast<uint8_t>(c(yv + t[256 + cb]));
    p[3] = 255;
  }
};

// The contiguous putters of tif_getimage.c: putcontig8bitYCbCr{44,42,41,
// 22,21,12,11}tile. cp: the raster index of the block's first pixel; pp:
// the input index.
void put_contig(const Putter& p, int hs, int vs, int64_t cp, int w, int h,
                int fromskew, int toskew, int64_t pp) {
  auto px = [&](int64_t c, int64_t yi, int64_t cbi) {
    p.put(c, p.at(yi), p.at(cbi), p.at(cbi + 1));
  };
  const int code = hs << 4 | vs;
  if (code == 0x44 || code == 0x42) {
    const int rows = vs;                          // 4 or 2
    const int blk = 4 * rows + 2;
    int64_t cps[4];
    cps[0] = cp;
    for (int r = 1; r < rows; ++r) cps[r] = cps[r - 1] + w + toskew;
    const int64_t incr = (rows - 1) * int64_t{w} + rows * int64_t{toskew};
    // both skip whole blocks of 4 x 2 (libtiff's 44 putter too: a tile
    // clipped on the right reads its next block rows short)
    fromskew = (fromskew / 4) * (4 * 2 + 2);
    if ((h % rows) == 0 && (w & 3) == 0) {
      for (; h >= rows; h -= rows) {
        int x = w >> 2;
        do {
          for (int r = 0; r < rows; ++r)
            for (int k = 0; k < 4; ++k)
              px(cps[r] + k, pp + r * 4 + k, pp + 4 * rows);
          for (int r = 0; r < rows; ++r) cps[r] += 4;
          pp += blk;
        } while (--x);
        for (int r = 0; r < rows; ++r) cps[r] += incr;
        pp += fromskew;
      }
    } else {
      while (h > 0) {
        for (int x = w; x > 0;) {
          const int nx = x < 4 ? x : 4, ny = h < rows ? h : rows;
          for (int k = nx - 1; k >= 0; --k)
            for (int r = ny - 1; r >= 0; --r)
              px(cps[r] + k, pp + r * 4 + k, pp + 4 * rows);
          if (x < 4) {
            for (int r = 0; r < rows; ++r) cps[r] += x;
            x = 0;
          } else {
            for (int r = 0; r < rows; ++r) cps[r] += 4;
            x -= 4;
          }
          pp += blk;
        }
        if (h <= rows) break;
        h -= rows;
        for (int r = 0; r < rows; ++r) cps[r] += incr;
        pp += fromskew;
      }
    }
  } else if (code == 0x41 || code == 0x21) {
    const int n = hs;                             // 4 or 2
    fromskew = (fromskew / n) * (n + 2);
    do {
      for (int x = w / n; x > 0; --x) {
        for (int k = 0; k < n; ++k) px(cp + k, pp + k, pp + n);
        cp += n;
        pp += n + 2;
      }
      if (w % n) {
        for (int k = w % n - 1; k >= 0; --k) px(cp + k, pp + k, pp + n);
        cp += w % n;
        pp += n + 2;
      }
      cp += toskew;
      pp += fromskew;
    } while (--h);
  } else if (code == 0x22) {
    const int64_t incr = 2 * int64_t{toskew} + w;
    fromskew = (fromskew / 2) * 6;
    int64_t cp2 = cp + w + toskew;
    while (h >= 2) {
      int x = w;
      while (x >= 2) {
        px(cp, pp, pp + 4);
        px(cp + 1, pp + 1, pp + 4);
        px(cp2, pp + 2, pp + 4);
        px(cp2 + 1, pp + 3, pp + 4);
        cp += 2;
        cp2 += 2;
        pp += 6;
        x -= 2;
      }
      if (x == 1) {
        px(cp, pp, pp + 4);
        px(cp2, pp + 2, pp + 4);
        cp++;
        cp2++;
        pp += 6;
      }
      cp += incr;
      cp2 += incr;
      pp += fromskew;
      h -= 2;
    }
    if (h == 1) {
      int x = w;
      while (x >= 2) {
        px(cp, pp, pp + 4);
        px(cp + 1, pp + 1, pp + 4);
        cp += 2;
        pp += 6;
        x -= 2;
      }
      if (x == 1) px(cp, pp, pp + 4);
    }
  } else if (code == 0x12) {
    const int64_t incr = 2 * int64_t{toskew} + w;
    fromskew = fromskew * 4;
    int64_t cp2 = cp + w + toskew;
    while (h >= 2) {
      int x = w;
      do {
        px(cp, pp, pp + 2);
        px(cp2, pp + 1, pp + 2);
        cp++;
        cp2++;
        pp += 4;
      } while (--x);
      cp += incr;
      cp2 += incr;
      pp += fromskew;
      h -= 2;
    }
    if (h == 1) {
      int x = w;
      do {
        px(cp, pp, pp + 2);
        cp++;
        pp += 4;
      } while (--x);
    }
  } else {                                        // 0x11
    fromskew = fromskew * 3;
    do {
      int x = w;
      do {
        px(cp++, pp, pp + 1);
        pp += 3;
      } while (--x);
      cp += toskew;
      pp += fromskew;
    } while (--h);
  }
}

}  // namespace

extern "C" {

// One call of a contiguous putter (hs, vs: the subsampling) on raster
// (npix RGBA pixels) from in (nin bytes), as tif_getimage.c's gtStrip/
// TileContig calls it: the block's first pixel cp, w x h pixels, the
// skews. Returns 0, or -1 where it would read or write past the buffers
// (libtiff does not check; Pillow's result would be undefined).
int tiff_ycbcr_put(const int32_t* tabs, uint8_t* raster, int64_t npix,
                   int64_t cp, int w, int h, int fromskew, int toskew,
                   const uint8_t* in, int64_t nin, int hs, int vs) {
  if (w <= 0 || h <= 0) return 0;
  try {
    put_contig(Putter{tabs, raster, npix, in, nin}, hs, vs, cp, w, h,
               fromskew, toskew, 0);
  } catch (const OutOfRange&) {
    return -1;
  }
  return 0;
}

// putseparate8bitYCbCr11tile: Y, Cb and Cr from three planes of nin bytes
// each (r, g, b in libtiff's names), skewed alike.
int tiff_ycbcr_put_separate(const int32_t* tabs, uint8_t* raster,
                            int64_t npix, int64_t cp, int w, int h,
                            int fromskew, int toskew, const uint8_t* y,
                            const uint8_t* cb, const uint8_t* cr,
                            int64_t nin) {
  if (w <= 0 || h <= 0) return 0;
  Putter p{tabs, raster, npix, y, nin};
  Putter pb{tabs, raster, npix, cb, nin};
  Putter pr{tabs, raster, npix, cr, nin};
  try {
    int64_t i = 0;
    for (; h > 0; --h) {
      int x = w;
      do {
        p.put(cp++, p.at(i), pb.at(i), pr.at(i));
        ++i;
      } while (--x);
      i += fromskew;
      cp += toskew;
    }
  } catch (const OutOfRange&) {
    return -1;
  }
  return 0;
}

}  // extern "C"
