// The byte loops of Pillow 12.1.0's raster decoders for the
// yolov5m_tpu_torch data pipeline (data/raster.py holds the plugins' open
// and tile set-up, and unpacks what these loops give):
//
//   pcx_rows      PcxDecode.c: a byte with its top two bits set is a run
//                 (count in its low six bits) of the next byte, any other
//                 is a literal; a run past the row's buffer sets the
//                 overrun error and stops copying, the decode goes on; a
//                 full row moves its planes together where they are wider
//                 than the unpacker reads them (1-bit planes of P;2L and
//                 P;4L: bits planes of (width + 7) / 8 bytes; others:
//                 bytes / width bands of width bytes).
//   tga_rle_rows  TgaRleDecode.c: a run (top bit) repeats one pixel and
//                 may not pass the row's end (overrun); a literal may, its
//                 rest starting the next rows.
//   sgi_rle       SgiRleDecode.c: the whole file read at once, the offset
//                 and length tables after the 512-byte header, each row of
//                 each channel expanded from its offset (1 or 2 bytes an
//                 atom); a row whose chunk count ends on a nonzero atom
//                 stops the image quietly (the rows left stay 0); a count
//                 past 2^31 is negative and expands nothing (the row keeps
//                 the buffer's last contents).
//   msp_rows      MspImagePlugin's MspDecoder: the row map, then each
//                 row's runs and literals, all rows one stream.
//   qoi_decode    QoiImagePlugin's QoiDecoder (Python in Pillow).
//   xbm_rows      XbmDecode.c: each "x" starts two hex digits (a byte,
//                 bits least significant first); other bytes are skipped.
//   bit_decode    BitDecode.c as ImImagePlugin sets it for "L*n" images:
//                 n-bit values (n from 1 to 31) packed least significant
//                 first, bottom row first, to float32; a row starts on a
//                 byte, whose bits are ORed over what the last row left in
//                 the bit buffer.
//
// Each returns 0 where the image is whole, 1 where the data ran out first
// ("image file is truncated"), 2 where the decoder sets an error. Pure
// C++ without shared state, called through ctypes by data/raster.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Rows of `bytes` bytes each (the decoder's buffer after the plane move),
// top row first, into out (ysize * bytes). bits: the unpacker's bits a
// pixel.
int pcx_rows(const uint8_t* buf, int64_t len, int64_t pos, int64_t xsize,
             int64_t ysize, int64_t bits, int64_t bytes, uint8_t* out) {
  if ((xsize * bits + 7) / 8 > bytes) return 2;
  std::vector<uint8_t> row(bytes, 0);
  int64_t x = 0, y = 0;
  bool overrun = false;
  while (y < ysize) {
    if (pos >= len) return 1;
    const uint8_t b = buf[pos];
    if ((b & 0xC0) == 0xC0) {
      if (pos + 1 >= len) return 1;
      int n = b & 0x3F;
      while (n > 0) {
        if (x >= bytes) {
          overrun = true;
          break;
        }
        row[x++] = buf[pos + 1];
        --n;
      }
      pos += 2;
    } else {
      row[x++] = b;
      ++pos;
    }
    if (x >= bytes) {
      // 1-bit planes (P;2L, P;4L) are bits planes of (xsize + 7) / 8
      // bytes; other rows bytes / xsize bands of xsize
      int64_t width = xsize, bands, stride = 0;
      if (bits == 2 || bits == 4) {
        width = (xsize + 7) / 8;
        bands = bits;
        stride = bytes / bits;
      } else {
        bands = bytes / xsize;
        if (bands) stride = bytes / bands;
      }
      if (stride > width)
        for (int64_t i = 1; i < bands; ++i)
          std::memmove(&row[i * width], &row[i * stride], width);
      std::memcpy(out + y * bytes, row.data(), bytes);
      x = 0;
      ++y;
    }
  }
  return overrun ? 2 : 0;
}

// Rows of row_bytes each in the order they are decoded into out (ysize *
// row_bytes); depth: bytes a pixel (depth / 8 of the header's bits).
int tga_rle_rows(const uint8_t* buf, int64_t len, int64_t pos, int64_t ysize,
                 int64_t depth, int64_t row_bytes, uint8_t* out) {
  std::vector<uint8_t> row(row_bytes, 0);
  int64_t x = 0, y = 0;
  while (true) {
    if (pos >= len) return 1;
    const uint8_t* ptr = buf + pos;
    const int64_t bytes = len - pos;
    int64_t n = depth * ((ptr[0] & 0x7F) + 1), extra = 0;
    if (ptr[0] & 0x80) {
      if (bytes < 1 + depth) return 1;
      if (x + n > row_bytes) return 2;
      for (int64_t i = 0; i < n; i += depth)
        std::memcpy(&row[x + i], ptr + 1, depth);
      pos += 1 + depth;
    } else {
      if (bytes < 1 + n) return 1;
      if (x + n > row_bytes) {
        extra = n;
        n = row_bytes - x;
        extra -= n;
      }
      std::memcpy(&row[x], ptr + 1, n);
      pos += 1 + depth * ((ptr[0] & 0x7F) + 1);
    }
    while (true) {
      x += n;
      if (x >= row_bytes) {
        std::memcpy(out + y * row_bytes, row.data(), row_bytes);
        x = 0;
        if (++y >= ysize) return 0;
      }
      if (extra == 0 || x > 0) break;
      n = std::min(extra, row_bytes);
      std::memcpy(&row[x], buf + pos - extra, n);
      extra -= n;
    }
  }
}

// Into out, (ysize, xsize * bands * bpc) zeroed by the caller, the top row
// first; ystep -1: the file's first row is the image's last.
int sgi_rle(const uint8_t* file, int64_t len, int64_t xsize, int64_t ysize,
            int64_t bands, int64_t bpc, int ystep, uint8_t* out) {
  const int64_t bufsize = len - 512;
  const int64_t tablen = bands * ysize;
  if (bufsize < 8 * tablen) return 2;
  const uint8_t* ptr = file + 512;
  const uint8_t* end = ptr + bufsize - 1;   // the buffer's last byte
  auto be32 = [](const uint8_t* p) {
    return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 |
           uint32_t(p[3]);
  };
  std::vector<uint8_t> row(xsize * bands * 2, 0);
  int64_t y = ystep < 0 ? ysize - 1 : 0;
  const int64_t step = ystep < 0 ? -1 : 1;
  for (int64_t r = 0; r < ysize; ++r, y += step) {
    for (int64_t c = 0; c < bands; ++c) {
      uint32_t off = be32(ptr + 4 * (r + c * ysize));
      // the length passes to expandrow as an int: past 2^31 it is
      // negative, and the row expands nothing
      const int32_t n0 = static_cast<int32_t>(
          be32(ptr + 4 * tablen + 4 * (r + c * ysize)));
      if (off < 512) return 2;
      off -= 512;
      const uint8_t* src = ptr + off;
      int64_t x = 0;
      int status = 0;
      if (bpc == 1) {
        uint8_t* dest = &row[c];
        for (int64_t n = n0; n > 0; --n) {
          if (src > end) { status = -1; break; }
          uint8_t pixel = *src++;
          if (n == 1 && pixel != 0) { status = 1; break; }
          uint8_t count = pixel & 0x7F;
          if (!count) break;
          if (x + count > xsize) { status = -1; break; }
          x += count;
          if (pixel & 0x80) {
            if (src + count > end) { status = -1; break; }
            while (count--) {
              *dest = *src++;
              dest += bands;
            }
          } else {
            if (src > end) { status = -1; break; }
            pixel = *src++;
            while (count--) {
              *dest = pixel;
              dest += bands;
            }
          }
        }
      } else {
        uint8_t* dest = &row[c * 2];
        for (int64_t n = n0; n > 0; --n) {
          if (src + 1 > end) { status = -1; break; }
          uint8_t pixel = src[1];
          src += 2;
          if (n == 1 && pixel != 0) { status = 1; break; }
          uint8_t count = pixel & 0x7F;
          if (!count) break;
          if (x + count > xsize) { status = -1; break; }
          x += count;
          if (pixel & 0x80) {
            if (src + 2 * count > end) { status = -1; break; }
            while (count--) {
              std::memcpy(dest, src, 2);
              src += 2;
              dest += bands * 2;
            }
          } else {
            if (src + 2 > end) { status = -1; break; }
            while (count--) {
              std::memcpy(dest, src, 2);
              dest += bands * 2;
            }
            src += 2;
          }
        }
      }
      if (status == -1) return 2;
      if (status == 1) return 0;
    }
    std::memcpy(out + y * xsize * bands * bpc, row.data(),
                xsize * bands * bpc);
  }
  return 0;
}

// The decoded stream of an MSP version 2 file into out (capacity cap);
// its length, or -1 where Pillow raises (a row map or row cut short, a
// run cut short).
int64_t msp_rows(const uint8_t* buf, int64_t len, int64_t xsize,
                 int64_t ysize, uint8_t* out, int64_t cap) {
  const int64_t blank = (xsize + 7) / 8;
  if (32 + 2 * ysize > len) return -1;
  int64_t at = 32 + 2 * ysize, n = 0;
  auto put = [&](const uint8_t* p, int64_t k, int v) {
    for (int64_t i = 0; i < k; ++i, ++n)
      if (n < cap) out[n] = p ? p[i] : static_cast<uint8_t>(v);
  };
  for (int64_t r = 0; r < ysize; ++r) {
    const int64_t rowlen = buf[32 + 2 * r] | buf[33 + 2 * r] << 8;
    if (rowlen == 0) {
      put(nullptr, blank, 0xFF);
      continue;
    }
    if (at + rowlen > len) return -1;
    const uint8_t* row = buf + at;
    at += rowlen;
    int64_t idx = 0;
    while (idx < rowlen) {
      const int runtype = row[idx++];
      if (runtype == 0) {
        if (idx + 2 > rowlen) return -1;
        put(nullptr, row[idx], row[idx + 1]);
        idx += 2;
      } else {
        put(row + idx, std::max<int64_t>(0, std::min<int64_t>(
                                                runtype, rowlen - idx)), 0);
        idx += runtype;
      }
    }
  }
  return n;
}

// bands 3 or 4 bytes a pixel into out (xsize * ysize * bands); 0, or 1
// where Pillow's decoder raises (the file ends inside an op).
int qoi_decode(const uint8_t* buf, int64_t len, int64_t pos, int64_t xsize,
               int64_t ysize, int bands, uint8_t* out) {
  uint8_t seen[64][4];
  bool have[64] = {};
  uint8_t prev[4] = {0, 0, 0, 255};
  const int64_t dest = xsize * ysize * bands;
  int64_t n = 0;
  auto emit = [&](const uint8_t* v) {
    for (int c = 0; c < bands; ++c, ++n)
      if (n < dest) out[n] = v[c];
  };
  while (n < dest) {
    if (pos >= len) return 1;
    const int byte = buf[pos++];
    uint8_t v[4];
    if (byte == 0xFE) {
      if (pos + 3 > len) return 1;
      v[0] = buf[pos];
      v[1] = buf[pos + 1];
      v[2] = buf[pos + 2];
      v[3] = prev[3];
      pos += 3;
    } else if (byte == 0xFF) {
      if (pos + 4 > len) return 1;
      std::memcpy(v, buf + pos, 4);
      pos += 4;
    } else {
      const int op = byte >> 6;
      if (op == 0) {
        const int i = byte & 63;
        if (have[i]) {
          std::memcpy(v, seen[i], 4);
        } else {
          v[0] = v[1] = v[2] = v[3] = 0;
        }
      } else if (op == 1) {
        v[0] = static_cast<uint8_t>(prev[0] + ((byte >> 4) & 3) - 2);
        v[1] = static_cast<uint8_t>(prev[1] + ((byte >> 2) & 3) - 2);
        v[2] = static_cast<uint8_t>(prev[2] + (byte & 3) - 2);
        v[3] = prev[3];
      } else if (op == 2) {
        if (pos >= len) return 1;
        const int second = buf[pos++];
        const int dg = (byte & 63) - 32;
        v[0] = static_cast<uint8_t>(prev[0] + dg + ((second >> 4) & 15) - 8);
        v[1] = static_cast<uint8_t>(prev[1] + dg);
        v[2] = static_cast<uint8_t>(prev[2] + dg + (second & 15) - 8);
        v[3] = prev[3];
      } else {
        for (int k = (byte & 63) + 1; k > 0; --k) emit(prev);
        continue;
      }
    }
    std::memcpy(prev, v, 4);
    const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(seen[h], v, 4);
    have[h] = true;
    emit(v);
  }
  return 0;
}

// Rows of (xsize + 7) / 8 bytes, top row first, into out.
int xbm_rows(const uint8_t* buf, int64_t len, int64_t pos, int64_t xsize,
             int64_t ysize, uint8_t* out) {
  const int64_t bytes = (xsize + 7) / 8, need = bytes * ysize;
  auto hex = [](int v) {
    return v >= '0' && v <= '9' ? v - '0'
         : v >= 'a' && v <= 'f' ? v - 'a' + 10
         : v >= 'A' && v <= 'F' ? v - 'A' + 10 : 0;
  };
  int64_t n = 0;
  while (n < need) {
    while (pos < len && buf[pos] != 'x') ++pos;
    if (len - pos < 3) return 1;
    out[n++] = static_cast<uint8_t>((hex(buf[pos + 1]) << 4) +
                                    hex(buf[pos + 2]));
    pos += 3;
  }
  return 0;
}

// n-bit values into out (ysize, xsize) float32, top row first.
int bit_decode(const uint8_t* buf, int64_t len, int64_t pos, int64_t xsize,
               int64_t ysize, int bits, float* out) {
  if (bits < 1 || bits >= 32) return 2;
  const uint64_t mask = (uint64_t{1} << bits) - 1;
  uint64_t buffer = 0;
  int count = 0;
  int64_t x = 0, y = ysize - 1;
  for (; pos < len; ++pos) {
    const uint8_t byte = buf[pos];
    buffer |= uint64_t{byte} << count;
    count += 8;
    while (count >= bits) {
      const uint64_t data = buffer & mask;
      if (count > 32)
        buffer = byte >> (8 - (count - bits));
      else
        buffer >>= bits;
      count -= bits;
      out[y * xsize + x] = static_cast<float>(data);
      if (++x >= xsize) {
        if (--y < 0) return 0;
        x = 0;
        count = 0;                    // the bits left stay in the buffer
      }
    }
  }
  return 1;
}

}  // extern "C"
