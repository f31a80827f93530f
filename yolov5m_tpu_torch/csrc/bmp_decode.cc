// BMP decode for the yolov5m_tpu_torch data pipeline: the pixels that
// np.asarray(Image.open(f).convert("RGB")) gives with Pillow 12.1.0
// (BmpImagePlugin and its decoders), without Pillow.
//
// What Pillow's open reads (BmpImageFile._bitmap): the 14-byte file header
// ("BM", the data offset), the info header by its size (12: OS/2 core, 16-bit
// width and height, palette entries of 3 bytes; 40, 52, 56, 64, 108, 124:
// BITMAPINFOHEADER to V5, 32-bit width, height negative (top-down) only where
// its top byte is FF, entries of 4 bytes), the colour count (0: 2^bits),
// BI_BITFIELDS masks (in the header from size 52, the alpha mask from 56;
// after a 40-byte header, three read from the file), and the palette. The
// pixel data starts at the header's offset, or past a palette of 4-byte
// entries where the offset points just after the info header.
//
//   bits 1, 4, 8   palette indices; a palette whose entries are a grey ramp
//                  (0 and 255 for two colours) is dropped: the image is
//                  "1" (two colours, one bit a pixel, 0 or 255) or "L" (a
//                  byte a pixel), read with the header's row stride
//   bits 16        BGR;15 (5-5-5), or with BI_BITFIELDS 5-6-5 or 5-5-5;
//                  each field scaled as v * 255 / (2^n - 1)
//   bits 24, 32    BGR, BGRX; with BI_BITFIELDS the byte orders Pillow
//                  lists (alpha dropped)
//   RLE8, RLE4     Pillow's BmpRleDecoder: runs clipped to the row, end of
//                  line padding the row with index 0, delta skipping two
//                  bytes more than it reads, absolute runs (RLE4: count / 2
//                  bytes) aligned to an even file position, then read as
//                  one index a byte
//
// Refused (nonzero), where Pillow's open or load fails: a bad signature or
// header size, a size of 0 or past Pillow's decompression-bomb limit, bits
// or compressions and bitfield layouts it does not list, a palette of
// more than 256 entries (or a colour count of 0 or above 65536), a row
// stride shorter than the rows it reads, pixel data cut short, RLE data
// that ends before the image is whole, RLE on other images than "P" and
// "L". Palette indices past the palette read black.
//
// data/native.py builds it into the port's host library and calls it
// through ctypes; pure C++ without shared state.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int64_t kMaxPixels = 2 * 89478485;   // 2 * Image.MAX_IMAGE_PIXELS

inline uint32_t le16(const uint8_t* p) { return p[0] | p[1] << 8; }
inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

// how Pillow unpacks a row ("rawmode") and what mode the image has
enum Raw { kP1, kP4, kP8, kBit1, kL8, kBGR15, kBGR16, kBGR, k32 };

struct Bmp {
  int64_t w = 0, h = 0;
  int direction = -1;            // -1: the first row in the file is the last
  Raw raw = kP8;
  int order[3] = {2, 1, 0};      // k32: the bytes of R, G and B
  bool rle = false, rle4 = false;
  int64_t offset = 0;            // the pixel data
  int64_t stride = 0;            // the header's row size, 4-byte aligned
  int64_t palette_size = 0;      // entries; rgb of each in palette
  uint8_t palette[256 * 3] = {};
};

// BmpImageFile._open and _bitmap; false where they fail
bool parse(const uint8_t* buf, int64_t len, Bmp* b) {
  if (len < 18 || buf[0] != 'B' || buf[1] != 'M') return false;
  int64_t offset = le32(buf + 10);
  const int64_t hs = le32(buf + 14);
  if (hs < 4 || 14 + hs > len) return false;   // _safe_read of the header
  const uint8_t* hd = buf + 18;
  const int64_t hlen = hs - 4;
  int64_t pos = 14 + hs;
  int bits, pad;
  uint32_t compression = 0, colors = 0;
  uint32_t masks[4] = {0, 0, 0, 0};
  if (hs == 12) {
    b->w = le16(hd);
    b->h = le16(hd + 2);
    bits = le16(hd + 6);
    pad = 3;
  } else if (hs == 40 || hs == 52 || hs == 56 || hs == 64 || hs == 108 ||
             hs == 124) {
    const bool flip = hd[7] == 0xFF;
    b->direction = flip ? 1 : -1;
    b->w = le32(hd);
    b->h = flip ? (int64_t{1} << 32) - le32(hd + 4) : le32(hd + 4);
    bits = le16(hd + 10);
    compression = le32(hd + 12);
    colors = le32(hd + 28);
    pad = 4;
    if (compression == 3) {
      if (hlen >= 48) {
        for (int i = 0; i < (hlen >= 52 ? 4 : 3); ++i)
          masks[i] = le32(hd + 36 + 4 * i);
      } else {
        if (pos + 12 > len) return false;       // i32(read(4)) of too little
        for (int i = 0; i < 3; ++i) masks[i] = le32(buf + pos + 4 * i);
        pos += 12;
      }
    }
  } else {
    return false;                               // unsupported header type
  }
  if (b->w <= 0 || b->h <= 0 || b->w > kMaxPixels ||
      b->h > kMaxPixels / b->w)
    return false;                               // size 0, or a bomb
  if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 &&
      bits != 32)
    return false;                               // unsupported pixel depth
  const int64_t ncolors = colors ? colors : int64_t{1} << bits;
  if (offset == 14 + hs && bits <= 8) offset += 4 * ncolors;
  b->raw = bits == 1 ? kP1 : bits == 4 ? kP4 : bits == 8 ? kP8
         : bits == 16 ? kBGR15 : bits == 24 ? kBGR : k32;
  if (compression == 3) {
    const uint32_t m0 = masks[0], m1 = masks[1], m2 = masks[2],
                   m3 = masks[3];
    auto is = [&](uint32_t r, uint32_t g, uint32_t bl, uint32_t a) {
      return m0 == r && m1 == g && m2 == bl && m3 == a;
    };
    auto is3 = [&](uint32_t r, uint32_t g, uint32_t bl) {
      return m0 == r && m1 == g && m2 == bl;
    };
    auto order = [&](int r, int g, int bl) {
      b->order[0] = r;
      b->order[1] = g;
      b->order[2] = bl;
    };
    if (bits == 32) {
      if (is(0xFF0000, 0xFF00, 0xFF, 0) || is(0xFF0000, 0xFF00, 0xFF,
                                              0xFF000000) || is(0, 0, 0, 0))
        order(2, 1, 0);                         // BGRX, BGRA
      else if (is(0xFF000000, 0xFF0000, 0xFF00, 0) ||
               is(0xFF000000, 0xFF0000, 0xFF00, 0xFF))
        order(3, 2, 1);                         // XBGR, ABGR
      else if (is(0xFF000000, 0xFF00, 0xFF, 0) ||
               is(0xFF000000, 0xFF00, 0xFF, 0xFF0000))
        order(3, 1, 0);                         // BGXR, BGAR
      else if (is(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
        order(0, 1, 2);                         // RGBA
      else
        return false;
    } else if (bits == 24) {
      if (!is3(0xFF0000, 0xFF00, 0xFF)) return false;
    } else if (bits == 16) {
      if (is3(0xF800, 0x7E0, 0x1F))
        b->raw = kBGR16;
      else if (!is3(0x7C00, 0x3E0, 0x1F))
        return false;
    } else {
      return false;                             // bitfields layout
    }
  } else if (compression == 1 || compression == 2) {
    b->rle = true;
    b->rle4 = compression == 2;
  } else if (compression != 0) {
    return false;                               // unsupported compression
  }
  if (bits <= 8) {
    if (ncolors <= 0 || ncolors > 65536) return false;
    const int64_t want = pad * ncolors;
    const int64_t got = std::min<int64_t>(want, std::max<int64_t>(len - pos, 0));
    const uint8_t* pal = buf + pos;
    pos += got;
    bool gray = true;
    for (int64_t i = 0; i < ncolors && gray; ++i) {
      const int v = ncolors == 2 ? (i ? 255 : 0) : static_cast<int>(i & 255);
      // the slice palette[i * pad : i * pad + 3] against three bytes v
      if (i * pad + 3 > got) {
        gray = false;
      } else {
        const uint8_t* e = pal + i * pad;
        gray = e[0] == v && e[1] == v && e[2] == v;
      }
    }
    if (gray) {
      b->raw = ncolors == 2 ? kBit1 : kL8;
    } else {
      const int64_t entries = got / pad;        // putpalette's count
      b->palette_size = entries;                // load fails past 256
      for (int64_t i = 0; i < std::min<int64_t>(entries, 256); ++i) {
        b->palette[3 * i] = pal[i * pad + 2];
        b->palette[3 * i + 1] = pal[i * pad + 1];
        b->palette[3 * i + 2] = pal[i * pad];
      }
    }
  }
  b->offset = offset ? offset : pos;
  b->stride = ((b->w * bits + 31) >> 3) & ~int64_t{3};
  return true;
}

int raw_bits(Raw r) {
  switch (r) {
    case kP1: case kBit1: return 1;
    case kP4: return 4;
    case kP8: case kL8: return 8;
    case kBGR15: case kBGR16: return 16;
    case kBGR: return 24;
    case k32: return 32;
  }
  return 8;
}

// one row in Pillow's rawmode to RGB, as convert("RGB") leaves it
void unpack_row(const Bmp& b, const uint8_t* in, int64_t w, uint8_t* out) {
  auto index = [&](int v, uint8_t* o) {
    if (b.raw == kL8 || b.raw == kBit1) {
      o[0] = o[1] = o[2] = static_cast<uint8_t>(v);
    } else if (v < b.palette_size) {
      std::memcpy(o, b.palette + 3 * v, 3);
    } else {
      o[0] = o[1] = o[2] = 0;
    }
  };
  for (int64_t x = 0; x < w; ++x) {
    uint8_t* o = out + 3 * x;
    switch (b.raw) {
      case kP1:
        index(in[x >> 3] >> (7 - (x & 7)) & 1, o);
        break;
      case kBit1:
        index(in[x >> 3] >> (7 - (x & 7)) & 1 ? 255 : 0, o);
        break;
      case kP4:
        index(x & 1 ? in[x >> 1] & 15 : in[x >> 1] >> 4, o);
        break;
      case kP8:
      case kL8:
        index(in[x], o);
        break;
      case kBGR15:
      case kBGR16: {
        const int p = in[2 * x] | in[2 * x + 1] << 8;
        if (b.raw == kBGR15) {
          o[0] = static_cast<uint8_t>((p >> 10 & 31) * 255 / 31);
          o[1] = static_cast<uint8_t>((p >> 5 & 31) * 255 / 31);
        } else {
          o[0] = static_cast<uint8_t>((p >> 11 & 31) * 255 / 31);
          o[1] = static_cast<uint8_t>((p >> 5 & 63) * 255 / 63);
        }
        o[2] = static_cast<uint8_t>((p & 31) * 255 / 31);
        break;
      }
      case kBGR:
        o[0] = in[3 * x + 2];
        o[1] = in[3 * x + 1];
        o[2] = in[3 * x];
        break;
      case k32:
        for (int c = 0; c < 3; ++c) o[c] = in[4 * x + b.order[c]];
        break;
    }
  }
}

// BmpRleDecoder.decode: the indices, a byte each, in file row order; false
// where Pillow fails ("not enough image data", a delta cut short)
bool rle_indices(const uint8_t* buf, int64_t len, const Bmp& b,
                 std::vector<uint8_t>* data) {
  const int64_t w = b.w, need = b.w * b.h;
  int64_t pos = b.offset, x = 0;
  auto read = [&](int64_t n) {                 // what fd.read(n) returns
    const int64_t start = std::min(pos, len);
    const int64_t got = std::max<int64_t>(std::min(len - start, n), 0);
    pos += n > 0 ? got : 0;
    return std::make_pair(buf + start, got);
  };
  while (static_cast<int64_t>(data->size()) < need) {
    auto px = read(1);
    auto by = read(1);
    if (!px.second || !by.second) break;
    int64_t n = px.first[0];
    const int byte = by.first[0];
    if (n) {                                    // encoded mode
      if (x + n > w) n = std::max<int64_t>(0, w - x);
      for (int64_t i = 0; i < n; ++i)
        data->push_back(static_cast<uint8_t>(
            b.rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte));
      x += n;
    } else if (byte == 0) {                     // end of line
      while (data->size() % w) data->push_back(0);
      x = 0;
    } else if (byte == 1) {                     // end of bitmap
      break;
    } else if (byte == 2) {                     // delta
      if (read(2).second < 2) break;
      auto d = read(2);
      if (d.second < 2) return false;           // unpacking fails
      data->resize(data->size() + d.first[0] + d.first[1] * w, 0);
      x = static_cast<int64_t>(data->size()) % w;
    } else {                                    // absolute mode
      const int64_t count = b.rle4 ? byte / 2 : byte;
      auto run = read(count);
      for (int64_t i = 0; i < run.second; ++i) {
        const int v = run.first[i];
        if (b.rle4) {
          data->push_back(static_cast<uint8_t>(v >> 4));
          data->push_back(static_cast<uint8_t>(v & 15));
        } else {
          data->push_back(static_cast<uint8_t>(v));
        }
      }
      if (run.second < count) break;
      x += byte;
      if (pos % 2) ++pos;                       // fd.seek(1, SEEK_CUR)
    }
  }
  return static_cast<int64_t>(data->size()) >= need;
}

}  // namespace

extern "C" {

// (h, w) as Pillow's Image.open(...).size reads them; 0 on success, 1
// where Pillow's open fails.
int bmp_dims(const uint8_t* buf, int64_t len, int* h, int* w) {
  Bmp b;
  if (!parse(buf, len, &b)) return 1;
  *h = static_cast<int>(b.h);
  *w = static_cast<int>(b.w);
  return 0;
}

// A BMP into a preallocated (h, w, 3) RGB uint8 array: Pillow's
// Image.open(...).convert("RGB"). Returns 0 on success, 2 where (h, w) is
// not the file's size, 1 where Pillow fails.
int decode_bmp_u8(const uint8_t* buf, int64_t len, uint8_t* out, int h,
                  int w) {
  Bmp b;
  if (!parse(buf, len, &b)) return 1;
  if (b.h != h || b.w != w) return 2;
  if (b.palette_size > 256) return 1;           // "invalid palette size"
  auto row_of = [&](int64_t i) {               // the i-th row in the file
    return b.direction < 0 ? b.h - 1 - i : i;
  };
  if (b.rle) {
    if (b.raw == kBit1 || raw_bits(b.raw) > 8) return 1;   // no "P" unpacker
    std::vector<uint8_t> data;
    if (!rle_indices(buf, len, b, &data)) return 1;
    Bmp p = b;
    p.raw = b.raw == kL8 ? kL8 : kP8;
    for (int64_t i = 0; i < b.h; ++i)
      unpack_row(p, data.data() + i * b.w, b.w, out + row_of(i) * b.w * 3);
    return 0;
  }
  const int64_t bytes = (raw_bits(b.raw) * b.w + 7) / 8;
  if (bytes > b.stride) return 1;               // IMAGING_CODEC_CONFIG
  // the last row needs its bytes, not its padding
  if (b.offset > len || (len - b.offset) < (b.h - 1) * b.stride + bytes)
    return 1;                                   // image file is truncated
  for (int64_t i = 0; i < b.h; ++i)
    unpack_row(b, buf + b.offset + i * b.stride, b.w,
               out + row_of(i) * b.w * 3);
  return 0;
}

}  // extern "C"
