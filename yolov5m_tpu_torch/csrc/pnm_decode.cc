// The token scan of plain PGM and PPM (P2, P3) for the yolov5m_tpu_torch
// data pipeline: the inner loop of Pillow 12.1.0's ppm_plain decoder
// (PpmImagePlugin.PpmPlainDecoder._decode_blocks), without Pillow.
//
// data/pnm.py keeps the rest of that decoder in Python, as Pillow has it:
// the file read in 1 MiB blocks, the comments of each block removed, and a
// block's last token held back for the next block where the block does
// not end in whitespace. It hands this scan one block so prepared, which
// is empty or ends in whitespace, and the count of values the image still
// needs. Pillow's loop over the block's tokens (bytes.split(): runs of
// bytes other than space, \t, \n, \v, \f, \r) stops once the image is
// whole, so only those tokens are read:
//
//   a token longer than 10 bytes               refused (-1)
//   int(token) above maxval                    refused (-2)
//   a token of other bytes than 0-9            -3: data/pnm.py reads the
//                                              block with Python's int,
//                                              which takes a sign and
//                                              underscores
//
// It returns the count of values written to out, at most need.
//
// data/native.py builds it into the port's host library and calls it
// through ctypes; pure C++ without shared state.

#include <cstdint>

namespace {

inline bool is_space(uint8_t c) { return c == ' ' || (c >= 9 && c <= 13); }

constexpr int kMaxToken = 10;

}  // namespace

extern "C" {

int64_t pnm_plain_tokens(const uint8_t* body, int64_t n, int64_t need,
                         int64_t maxval, int32_t* out) {
  int64_t count = 0, i = 0;
  while (count < need) {
    while (i < n && is_space(body[i])) ++i;
    if (i >= n) break;
    const int64_t start = i;
    int64_t value = 0;
    bool digits = true;
    for (; i < n && !is_space(body[i]); ++i) {
      if (i - start >= kMaxToken) return -1;
      const unsigned d = static_cast<unsigned>(body[i]) - '0';
      if (d > 9)
        digits = false;
      else
        value = value * 10 + d;
    }
    if (!digits) return -3;
    if (value > maxval) return -2;
    out[count++] = static_cast<int32_t>(value);
  }
  return count;
}

}  // extern "C"
