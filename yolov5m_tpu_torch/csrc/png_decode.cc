// PNG decode for the yolov5m_tpu_torch data pipeline: the pixels that
// np.asarray(Image.open(f).convert("RGB")) gives with Pillow, without
// Pillow or libpng.
//
// Four calls, with the inflate between them done by the caller (Python's
// zlib module, in data/native.py, which feeds it the image stream as Pillow
// does: chunk by chunk, 64 KiB at most at a time, and stops where the
// image is whole):
//
//   png_header  the signature and every chunk before the first IDAT, each
//               checked against its CRC as Pillow checks them; fills the
//               image's geometry and palette; -1 where Pillow's open fails.
//   png_idat    where the data of the run of IDAT chunks that starts there
//               lies (their CRCs are not read, as Pillow does not read
//               them; a chunk cut short gives what it holds).
//   png_tail    the chunks after the one where the image became whole, which
//               Pillow reads through to IEND: one cut short fails.
//   png_to_rgb  the inflated scanlines: the five filter types, Adam7
//               interlace, bit depths 1/2/4/8/16 of colour types 0, 2, 3, 4
//               and 6, converted to RGB by Pillow's rules: 16-bit samples
//               keep their high byte, except 16-bit grey, whose value is
//               clamped to 255; 1-, 2- and 4-bit grey scale by 255, 85 and
//               17; palette indices past the palette read black; alpha and
//               tRNS are dropped.
//
// data/native.py builds it into one library with preprocess.cc,
// jpeg_decode.cc and augment.cc and calls it through ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

enum Info { kH, kW, kDepth, kType, kInterlace, kPaletteSize, kInfoSize };

struct CrcTable {
  uint32_t v[256];
  CrcTable() {
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xedb88320u ^ (c >> 1) : c >> 1;
      v[n] = c;
    }
  }
};

uint32_t crc32(const uint8_t* p, int64_t n) {
  static const CrcTable table;
  uint32_t c = 0xffffffffu;
  for (int64_t i = 0; i < n; ++i) c = table.v[(c ^ p[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}

// a chunk type is four ASCII letters, digits or '_' (Pillow's test)
inline bool is_cid(const uint8_t* p) {
  for (int i = 0; i < 4; ++i) {
    const uint8_t c = p[i];
    if (!((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
          (c >= '0' && c <= '9') || c == '_'))
      return false;
  }
  return true;
}

inline bool valid_mode(int depth, int type) {
  switch (type) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

inline int channels(int type) {
  return type == 2 ? 3 : type == 4 ? 2 : type == 6 ? 4 : 1;
}

// Adam7: start and step of each pass, rows and columns
constexpr int kPassX0[7] = {0, 4, 0, 2, 0, 1, 0};
constexpr int kPassY0[7] = {0, 0, 4, 0, 2, 0, 1};
constexpr int kPassDX[7] = {8, 8, 4, 4, 2, 2, 1};
constexpr int kPassDY[7] = {8, 8, 8, 4, 4, 2, 2};

inline int64_t row_bytes(int64_t w, int depth, int type) {
  return (w * depth * channels(type) + 7) / 8;
}

inline int pass_size(int n, int start, int step) {
  return n > start ? (n - start + step - 1) / step : 0;
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// Undo one row's filter in place; prev is the unfiltered row above (zeros
// for a pass's first row). false for an unknown filter type.
bool unfilter(uint8_t type, uint8_t* row, const uint8_t* prev, int64_t n,
              int bpp) {
  switch (type) {
    case 0: return true;
    case 1:
      for (int64_t i = bpp; i < n; ++i) row[i] += row[i - bpp];
      return true;
    case 2:
      for (int64_t i = 0; i < n; ++i) row[i] += prev[i];
      return true;
    case 3:
      for (int64_t i = 0; i < n; ++i)
        row[i] += static_cast<uint8_t>(
            ((i >= bpp ? row[i - bpp] : 0) + prev[i]) >> 1);
      return true;
    case 4:
      for (int64_t i = 0; i < n; ++i)
        row[i] += paeth(i >= bpp ? row[i - bpp] : 0, prev[i],
                        i >= bpp ? prev[i - bpp] : 0);
      return true;
    default: return false;
  }
}

// sample j of an unfiltered row (depth < 8: packed, most significant first)
inline int sample(const uint8_t* row, int64_t j, int depth) {
  switch (depth) {
    case 8: return row[j];
    case 16: return row[2 * j] << 8 | row[2 * j + 1];
    default: {
      const int64_t bit = j * depth;
      return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
    }
  }
}

// one unfiltered row of `n` pixels to RGB at out, every `step` pixels
void row_to_rgb(const uint8_t* row, int64_t n, const int32_t* info,
                const uint8_t* palette, uint8_t* out, int64_t step) {
  const int depth = info[kDepth], type = info[kType];
  const int cn = channels(type);
  for (int64_t x = 0; x < n; ++x, out += 3 * step) {
    if (type == 3) {
      const int i = sample(row, x, depth);
      if (i < info[kPaletteSize]) {
        std::memcpy(out, palette + 3 * i, 3);
      } else {
        out[0] = out[1] = out[2] = 0;
      }
      continue;
    }
    if (type == 0 || type == 4) {
      int v = sample(row, x * cn, depth);
      switch (depth) {
        case 1: v *= 255; break;
        case 2: v *= 85; break;
        case 4: v *= 17; break;
        case 16: v = type == 0 ? (v > 255 ? 255 : v) : v >> 8; break;
        default: break;
      }
      out[0] = out[1] = out[2] = static_cast<uint8_t>(v);
      continue;
    }
    for (int c = 0; c < 3; ++c) {
      const int v = sample(row, x * cn + c, depth);
      out[c] = static_cast<uint8_t>(depth == 16 ? v >> 8 : v);
    }
  }
}

}  // namespace

extern "C" {

// Read the signature and the chunks before the first IDAT. info gets
// (h, w, bit depth, colour type, interlace, palette entries); palette
// (768 bytes) the PLTE entries of an indexed image. Returns the offset of
// the first IDAT chunk (or of an IEND before it), or -1 where Pillow fails
// to open the file: no signature, a chunk header that is cut or not a
// chunk type, a chunk or CRC cut short, a CRC that differs, an IHDR
// shorter than 13 bytes, a filter method other than 0, a bit depth and
// colour type Pillow does not know, an empty size, or no IHDR.
int64_t png_header(const uint8_t* buf, int64_t n, int32_t* info,
                   uint8_t* palette) {
  if (n < 8 || std::memcmp(buf, kSignature, 8) != 0) return -1;
  bool have_ihdr = false;
  info[kPaletteSize] = 0;
  int64_t pos = 8;
  while (true) {
    if (n - pos < 8) return -1;
    const int64_t length = be32(buf + pos);
    const uint8_t* cid = buf + pos + 4;
    if (!is_cid(cid)) return -1;
    // Pillow's open stops at the first IDAT, or at an IEND before it
    // (whose image then has no data)
    if (!std::memcmp(cid, "IDAT", 4) || !std::memcmp(cid, "IEND", 4))
      return have_ihdr ? pos : -1;
    const uint8_t* data = buf + pos + 8;
    if (n - pos - 8 < length + 4) return -1;
    if (crc32(cid, length + 4) != be32(data + length)) return -1;
    if (!std::memcmp(cid, "IHDR", 4)) {
      if (length < 13) return -1;
      const uint32_t w = be32(data), h = be32(data + 4);
      const int depth = data[8], type = data[9];
      if (data[11] != 0) return -1;
      if (valid_mode(depth, type)) {
        if (w == 0 || h == 0 || w > 0x7fffffffu || h > 0x7fffffffu)
          return -1;
        info[kW] = static_cast<int32_t>(w);
        info[kH] = static_cast<int32_t>(h);
        info[kDepth] = depth;
        info[kType] = type;
        have_ihdr = true;
      } else {
        have_ihdr = false;
      }
      info[kInterlace] = data[12] != 0;
    } else if (!std::memcmp(cid, "PLTE", 4) && have_ihdr &&
               info[kType] == 3) {
      const int entries = static_cast<int>(length / 3 > 256 ? 256
                                                            : length / 3);
      std::memcpy(palette, data, 3 * entries);
      info[kPaletteSize] = entries;
    }
    pos += 12 + length;
  }
}

// (h, w) of a PNG from its header, 0; -1 where png_header fails.
int png_dims(const uint8_t* buf, int64_t n, int* h, int* w) {
  int32_t info[kInfoSize];
  uint8_t palette[768];
  if (png_header(buf, n, info, palette) < 0) return -1;
  *h = info[kH];
  *w = info[kW];
  return 0;
}

// The run of IDAT chunks from offset pos: for each chunk, the offset of
// its data, the bytes of it in the buffer and its declared length (three
// int64 each, in spans: room for (n - pos) / 12 + 1 chunks). Returns the
// number of chunks; the run ends at a chunk of another type or at a chunk
// cut short (the last one given).
int64_t png_idat(const uint8_t* buf, int64_t n, int64_t pos, int64_t* spans) {
  int64_t count = 0;
  while (n - pos >= 8 && !std::memcmp(buf + pos + 4, "IDAT", 4)) {
    const int64_t length = be32(buf + pos);
    const int64_t have = n - pos - 8 < length ? n - pos - 8 : length;
    spans[3 * count] = pos + 8;
    spans[3 * count + 1] = have;
    spans[3 * count + 2] = length;
    ++count;
    if (have < length) break;
    pos += 12 + length;
  }
  return count;
}

// Whether the chunks from offset pos on read as Pillow reads them once the
// image is whole: 0 up to IEND, the end of the buffer or a header that is
// not a chunk's, -1 at a chunk cut short (or an IHDR under 13 bytes) before
// them. Their CRCs are not read.
int png_tail(const uint8_t* buf, int64_t n, int64_t pos) {
  while (n - pos >= 8 && is_cid(buf + pos + 4) &&
         std::memcmp(buf + pos + 4, "IEND", 4) != 0) {
    const int64_t length = be32(buf + pos);
    if (n - pos - 8 < length) return -1;
    if (!std::memcmp(buf + pos + 4, "IHDR", 4) && length < 13) return -1;
    pos += 12 + length;
  }
  return 0;
}

// Bytes of inflated scanlines (filter bytes included) the image needs.
int64_t png_raw_size(const int32_t* info) {
  const int64_t w = info[kW], h = info[kH];
  if (!info[kInterlace]) return h * (1 + row_bytes(w, info[kDepth], info[kType]));
  int64_t total = 0;
  for (int p = 0; p < 7; ++p) {
    const int64_t pw = pass_size(static_cast<int>(w), kPassX0[p], kPassDX[p]);
    const int64_t ph = pass_size(static_cast<int>(h), kPassY0[p], kPassDY[p]);
    if (pw && ph) total += ph * (1 + row_bytes(pw, info[kDepth], info[kType]));
  }
  return total;
}

// Unfilter the inflated scanlines raw (png_raw_size bytes) into RGB out
// (h, w, 3). Returns 0, or -1 on a filter type above 4.
int png_to_rgb(uint8_t* raw, const int32_t* info, const uint8_t* palette,
               uint8_t* out) {
  const int depth = info[kDepth], type = info[kType];
  const int bpp = (depth * channels(type) + 7) / 8;
  const int64_t w = info[kW], h = info[kH];
  const int passes = info[kInterlace] ? 7 : 1;
  std::vector<uint8_t> zeros(row_bytes(w, depth, type), 0);
  for (int p = 0; p < passes; ++p) {
    const int x0 = passes == 1 ? 0 : kPassX0[p];
    const int y0 = passes == 1 ? 0 : kPassY0[p];
    const int dx = passes == 1 ? 1 : kPassDX[p];
    const int dy = passes == 1 ? 1 : kPassDY[p];
    const int64_t pw = pass_size(static_cast<int>(w), x0, dx);
    const int64_t ph = pass_size(static_cast<int>(h), y0, dy);
    if (!pw || !ph) continue;
    const int64_t rb = row_bytes(pw, depth, type);
    const uint8_t* prev = zeros.data();
    for (int64_t r = 0; r < ph; ++r) {
      uint8_t* row = raw + 1;
      if (!unfilter(raw[0], row, prev, rb, bpp)) return -1;
      row_to_rgb(row, pw, info, palette,
                 out + ((y0 + r * dy) * w + x0) * 3, dx);
      prev = row;
      raw += 1 + rb;
    }
  }
  return 0;
}

}  // extern "C"
