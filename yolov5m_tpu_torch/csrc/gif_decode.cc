// GIF decode for the yolov5m_tpu_torch data pipeline: the first frame as
// np.asarray(Image.open(f).convert("RGB")) gives it with Pillow 12.1.0
// (GifImagePlugin and its LZW decoder, GifDecode.c), without Pillow.
//
// What Pillow's open reads (GifImageFile._open, _seek(0)): the logical
// screen and its global colour table, then the blocks up to the first
// image descriptor: extensions (a graphic control extension's transparent
// index is kept, a comment's blocks are skipped by their lengths, every
// other extension's first block read and the rest skipped), stray bytes
// skipped one at a time. A colour table that is the grey ramp (entry i
// equal to (i, i, i) throughout) is no palette; the frame's indices are
// read through its local table, or where that is none or a ramp through
// the global one, or where that too is none as grey levels. The image
// grows to hold a frame that passes the screen's edge.
//
// The frame's pixels: the image is first filled with the transparent index
// (0 without one), then the frame is decoded into its rectangle: LZW codes
// of the minimum code size plus one bit, read LSB first from data sub-
// blocks, each begun only when all of it is there; the table grows to 4096
// codes and the code size to 12 bits; a clear code resets both; a code past
// the next free one, or the first after a clear past the clear code, is an
// error; the code equal to the next free one repeats the last string and
// its first byte. Rows fill left to right and wrap to the next row
// (interlaced: every 8th from 0, every 8th from 4, every 4th from 2, every
// 2nd from 1); the decode ends where the last row is complete. At an end
// code before that, Pillow's loader reads on (in reads of 64 KiB from the
// frame's data) and refuses the image where the file has no more; given
// more, the decoder reads the bytes after the end code as more codes.
//
// convert("RGB"): a "P" frame's indices through its colour table (entries
// past the table read black), an "L" frame's as grey; transparency
// dropped.
//
// Refused (nonzero), where Pillow's open or load fails: no GIF87a/GIF89a
// signature, a header, extension or descriptor cut short, no image
// descriptor, a size of 0 or past the decompression-bomb limit, a minimum
// code size above 12, LZW errors, data that ends before the frame is whole.
//
// data/native.py builds it into the port's host library and calls it
// through ctypes; pure C++ without shared state.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kMaxPixels = 2 * 89478485;   // 2 * Image.MAX_IMAGE_PIXELS
constexpr int kTable = 4096, kBuffer = 4096;
constexpr int64_t kRead = 65536;               // ImageFile's decodermaxblock

inline int le16(const uint8_t* p) { return p[0] | p[1] << 8; }

struct Gif {
  int64_t w = 0, h = 0;                         // the image
  int x0 = 0, y0 = 0, fw = 0, fh = 0;           // the frame's rectangle
  bool interlace = false;
  int bits = 0;                                 // LZW minimum code size
  int transparency = -1;
  bool palette = false;                         // "P" (else "L")
  int palette_size = 0;
  uint8_t rgb[256 * 3] = {};
  int64_t offset = 0;                           // the first data sub-block
};

// file reads as Python's fp.read(n): what is there, up to n bytes
struct Reader {
  const uint8_t* buf;
  int64_t len, pos = 0;
  int64_t read(int64_t n, const uint8_t** p) {
    const int64_t start = std::min(pos, len);
    const int64_t got = std::max<int64_t>(std::min(n, len - start), 0);
    *p = buf + start;
    pos = start + got;
    return got;
  }
  // GifImageFile.data: a sub-block, or none at a terminator or the end
  bool data(const uint8_t** p, int64_t* n) {
    const uint8_t* s;
    if (read(1, &s) == 0 || s[0] == 0) return false;
    *n = read(s[0], p);
    return true;
  }
};

// _is_palette_needed, with the IndexError its chained comparison raises
// on a table cut short (-1)
int palette_needed(const uint8_t* p, int64_t n) {
  for (int64_t i = 0; i < n; i += 3) {
    if (i / 3 != p[i]) return 1;
    if (i + 1 >= n) return -1;
    if (p[i] != p[i + 1]) return 1;
    if (i + 2 >= n) return -1;
    if (p[i + 1] != p[i + 2]) return 1;
  }
  return 0;
}

void set_palette(Gif* g, const uint8_t* p, int64_t n) {
  g->palette = true;
  g->palette_size = static_cast<int>(std::min<int64_t>(n / 3, 256));
  std::memcpy(g->rgb, p, g->palette_size * 3);
}

bool parse(const uint8_t* buf, int64_t len, Gif* g) {
  Reader r{buf, len};
  const uint8_t* s;
  const int64_t n = r.read(13, &s);
  if (n < 11 || (std::memcmp(s, "GIF87a", 6) && std::memcmp(s, "GIF89a", 6)))
    return false;
  g->w = le16(s + 6);
  g->h = le16(s + 8);
  const int flags = s[10];
  if (flags & 128) {
    if (n < 12) return false;                   // s[11], the background
    const uint8_t* p;
    const int64_t np = r.read(int64_t{3} << ((flags & 7) + 1), &p);
    const int need = palette_needed(p, np);
    if (need < 0) return false;
    if (need) set_palette(g, p, np);
  }
  if (r.read(1, &s) == 0 || s[0] == ';') return false;   // no frame
  bool found = false, first = true;
  while (!found) {
    if (!first && r.read(1, &s) == 0) break;
    first = false;
    const int c = s[0];
    if (c == ';') break;
    if (c == '!') {
      const uint8_t* label;
      if (r.read(1, &label) == 0) return false;           // s[0] of b""
      const uint8_t* block;
      int64_t bn;
      const bool has = r.data(&block, &bn);
      if (label[0] == 249 && has) {
        if (bn < 1) return false;
        if (block[0] & 1) {
          if (bn < 4) return false;
          g->transparency = block[3];
        }
        if (bn < 3) return false;                        // i16(block, 1)
      } else if (label[0] == 254) {
        bool more = has;
        while (more) more = r.data(&block, &bn);
        continue;
      } else if (label[0] == 255 && has && bn >= 11 &&
                 std::memcmp(block, "NETSCAPE2.0", 11) == 0) {
        r.data(&block, &bn);                             // the loop count
      }
      while (r.data(&block, &bn)) {
      }
    } else if (c == ',') {
      const uint8_t* d;
      const int64_t dn = r.read(9, &d);
      if (dn < 9) return false;
      g->x0 = le16(d);
      g->y0 = le16(d + 2);
      g->fw = le16(d + 4);
      g->fh = le16(d + 6);
      const int64_t x1 = g->x0 + g->fw, y1 = g->y0 + g->fh;
      if (x1 > g->w || y1 > g->h) {
        g->w = std::max(x1, g->w);
        g->h = std::max(y1, g->h);
        if (g->w * g->h > kMaxPixels) return false;
      }
      const int dflags = d[8];
      g->interlace = dflags & 64;
      if (dflags & 128) {
        const uint8_t* p;
        const int64_t np = r.read(int64_t{3} << ((dflags & 7) + 1), &p);
        const int need = palette_needed(p, np);
        if (need < 0) return false;
        // a local grey ramp makes the frame "L", but the global table is
        // still the image's palette, which load() puts on the "L" image,
        // and convert("RGB") reads the indices through it
        if (need) set_palette(g, p, np);
      }
      const uint8_t* b;
      if (r.read(1, &b) == 0) return false;
      g->bits = b[0];
      g->offset = r.pos;
      found = true;
    }
  }
  if (!found) return false;                     // "image not found"
  return g->w > 0 && g->h > 0 && g->w * g->h <= kMaxPixels;
}

// GifDecode.c over the file from the frame's first sub-block; false where
// it fails or the data ends before the frame is whole
bool lzw(const uint8_t* buf, int64_t len, const Gif& g, uint8_t* im) {
  if (g.bits > 12 || g.fw <= 0 || g.fh <= 0) return false;
  const int clear = 1 << g.bits, end = clear + 1;
  int next = 0, codesize = 0, codemask = 0;
  int interlace = g.interlace ? 1 : 0, step = g.interlace ? 8 : 1;
  int x = 0, y = 0;
  int64_t pos = g.offset;
  // Pillow's load feeds the decoder reads of 64 KiB from the frame's data
  int64_t fed = std::min(len, g.offset + kRead);
  auto feed = [&]() {
    if (fed >= len) return false;               // "image file is truncated"
    fed = std::min(len, fed + kRead);
    return true;
  };
  int blocksize = 0, bitcount = 0;
  uint32_t bitbuffer = 0;
  int state = 1, lastcode = 0;
  uint8_t lastdata = 0;
  std::vector<uint8_t> data(kTable), buffer(kBuffer);
  std::vector<int> link(kTable);
  int bufferindex = kBuffer;
  uint8_t* out = im + (g.y0 * g.w + g.x0);
  // NEWLINE: false where the frame is whole
  auto newline = [&]() {
    x = 0;
    y += step;
    while (y >= g.fh) {
      if (interlace == 1) {
        y = 4;
        interlace = 2;
      } else if (interlace == 2) {
        step = 4;
        y = 2;
        interlace = 3;
      } else if (interlace == 3) {
        step = 2;
        y = 1;
        interlace = 0;
      } else {
        return false;
      }
    }
    out = im + ((g.y0 + y) * g.w + g.x0);
    return true;
  };
  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = g.bits + 1;
      codemask = (1 << codesize) - 1;
      bufferindex = kBuffer;
      state = 2;
    }
    const uint8_t* p;
    int i;
    if (bufferindex < kBuffer) {
      i = kBuffer - bufferindex;
      p = &buffer[bufferindex];
      bufferindex = kBuffer;
    } else {
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= static_cast<uint32_t>(buf[pos++]) << bitcount;
          bitcount += 8;
          --blocksize;
        } else {
          // a sub-block is begun only when all of it was fed
          if (pos >= fed || fed - pos < buf[pos] + 1) {
            if (!feed()) return false;
            continue;
          }
          blocksize = buf[pos++];
        }
      }
      int c = static_cast<int>(bitbuffer & codemask);
      bitbuffer >>= codesize;
      bitcount -= codesize;
      if (c == clear) {
        if (state != 2) state = 1;
        continue;
      }
      // the decoder returns at an end code: load reads on, and refuses the
      // image where the file has no more to read
      if (c == end) {
        if (!feed()) return false;
        continue;
      }
      i = 1;
      p = &lastdata;
      if (state == 2) {
        if (c > clear) return false;
        lastdata = static_cast<uint8_t>(c);
        lastcode = c;
        state = 3;
      } else {
        const int thiscode = c;
        if (c > next) return false;
        if (c == next) {
          if (bufferindex <= 0) return false;
          buffer[--bufferindex] = lastdata;
          c = lastcode;
        }
        while (c >= clear) {
          if (bufferindex <= 0 || c >= kTable) return false;
          buffer[--bufferindex] = data[c];
          c = link[c];
        }
        lastdata = static_cast<uint8_t>(c);
        if (next < kTable) {
          data[next] = static_cast<uint8_t>(c);
          link[next] = lastcode;
          if (next == codemask && codesize < 12) {
            ++codesize;
            codemask = (1 << codesize) - 1;
          }
          ++next;
        }
        lastcode = thiscode;
      }
    }
    if (y >= g.fh) return false;                // IMAGING_CODEC_OVERRUN
    for (int k = 0; k < i; ++k) {
      *out++ = p[k];
      if (++x >= g.fw && !newline()) return true;
    }
  }
}

}  // namespace

extern "C" {

// (h, w) as Pillow's Image.open(...).size reads them; 0 on success, 1
// where Pillow's open fails.
int gif_dims(const uint8_t* buf, int64_t len, int* h, int* w) {
  Gif g;
  if (!parse(buf, len, &g)) return 1;
  *h = static_cast<int>(g.h);
  *w = static_cast<int>(g.w);
  return 0;
}

// A GIF's first frame into a preallocated (h, w, 3) RGB uint8 array:
// Pillow's Image.open(...).convert("RGB"). Returns 0 on success, 2 where
// (h, w) is not the image's size, 1 where Pillow fails.
int decode_gif_u8(const uint8_t* buf, int64_t len, uint8_t* out, int h,
                  int w) {
  Gif g;
  if (!parse(buf, len, &g)) return 1;
  if (g.h != h || g.w != w) return 2;
  std::vector<uint8_t> im(static_cast<size_t>(g.w * g.h),
                          static_cast<uint8_t>(g.transparency < 0
                                                   ? 0
                                                   : g.transparency));
  if (!lzw(buf, len, g, im.data())) return 1;
  for (int64_t k = 0; k < g.w * g.h; ++k) {
    const int v = im[k];
    uint8_t* o = out + 3 * k;
    if (!g.palette) {
      o[0] = o[1] = o[2] = static_cast<uint8_t>(v);
    } else if (v < g.palette_size) {
      std::memcpy(o, g.rgb + 3 * v, 3);
    } else {
      o[0] = o[1] = o[2] = 0;
    }
  }
  return 0;
}

}  // extern "C"
