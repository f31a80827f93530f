// WebP decode for the yolov5m_tpu_torch data pipeline: the first frame as
// np.asarray(Image.open(f).convert("RGB")) gives it with Pillow 12.1.0 over
// the libwebp 1.6.0 it bundles, without Pillow or libwebp.
//
// What Pillow does: its open hands the whole file to WebPAnimDecoderNew
// (animated or not), which first runs WebPGetFeatures on the file, then
// WebPDemux (the whole RIFF must be there; bytes past the RIFF size are
// ignored), and Pillow then refuses a canvas past its decompression-bomb
// limit; its load asks WebPAnimDecoderGetNext for frame 1, which zero-fills
// the canvas (RGBA, not premultiplied) and decodes the frame's ALPH and
// VP8/VP8L chunks (from the ALPH chunk's header to the end of the image
// chunk with its padding byte) at the frame's offset; convert("RGB") drops
// alpha. This file follows those calls (libwebp's demux.c, webp_dec.c,
// vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c, dsp/dec.c, io_dec.c,
// dsp/upsampling.c, yuv.h, vp8l_dec.c, huffman_utils.c, dsp/lossless.c,
// alpha_dec.c, dsp/filters.c, anim_decode.c), so that it refuses what they
// refuse and computes what they compute, bit for bit:
//
// - the container: chunk sizes against the RIFF size, padding, VP8X's flags
//   and canvas, ANIM before ANMF, each frame inside the canvas (exactly the
//   canvas for a still image), alpha before the image, no partial frame;
// - VP8 (RFC 6386 as libwebp decodes it): the boolean decoder, whose end of
//   data is an error where a macroblock or a row of modes reads past it;
//   segments, the quantizer tables with libwebp's y2 and uv clamps, 1-8
//   token partitions, coefficient probabilities, intra prediction with its
//   127/129 borders and the top-right pixels of a macroblock replicated
//   down its rightmost 4x4 blocks, the inverse WHT and DCT in libwebp's
//   operation order (int16 coefficients; the DCT where libwebp runs its
//   SSE2 version in that version's wrapping 16-bit lanes, as x86 Pillow
//   decodes), the simple and normal loop
//   filters in macroblock order; then libwebp's fancy upsampler (the
//   diagonal averages on packed u | v << 16) and its 14-bit YUV -> RGB;
// - VP8L (RFC 9649): prefix codes (simple, normal, one symbol), LZ77 with
//   the 120 plane codes, the colour cache, meta prefix codes, the four
//   transforms, with libwebp's bit reader (its 64-bit window and its end of
//   stream, which is an error for the image and, for alpha decoded through
//   the palette's 8-bit path, only before the last pixel);
// - ALPH: raw or VP8L-coded, with the horizontal, vertical and gradient
//   unfilters; its values are dropped, but a bad alpha stream fails the
//   whole decode, as in libwebp.
//
// data/native.py builds it into the port's host library and calls it
// through ctypes; pure C++ without shared state.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kMaxPixels = 2 * 89478485;   // 2 * Image.MAX_IMAGE_PIXELS
constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;
constexpr uint64_t kMaxImageArea = 1ull << 32;

inline uint32_t le16(const uint8_t* p) { return p[0] | p[1] << 8; }
inline uint32_t le24(const uint8_t* p) { return le16(p) | p[2] << 16; }
inline uint32_t le32(const uint8_t* p) {
  return le16(p) | (uint32_t)le16(p + 2) << 16;
}
inline bool tag(const uint8_t* p, const char* t) { return !memcmp(p, t, 4); }

// libwebp's tables: quant_dec.c, tree_dec.c, vp8l_dec.c
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7,
                                          8, 9, 10, 11, 12, 13, 14, 15};

// -- the bitstream headers: webp_dec.c's ParseHeadersInternal ----------------

enum { kOk = 0, kNotEnoughData = 1, kBitstreamError = 2, kUnsupported = 3 };

struct Headers {
  int width = 0, height = 0;
  bool lossless = false;
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  const uint8_t* payload = nullptr;   // after the VP8/VP8L chunk header
  size_t payload_size = 0;            // to the end of the buffer
};

bool vp8_get_info(const uint8_t* d, size_t size, size_t chunk_size, int* w,
                  int* h) {
  if (size < 10 || !(d[3] == 0x9d && d[4] == 0x01 && d[5] == 0x2a))
    return false;
  const uint32_t bits = d[0] | d[1] << 8 | d[2] << 16;
  const int ww = le16(d + 6) & 0x3fff, hh = le16(d + 8) & 0x3fff;
  if (bits & 1) return false;                          // not a key frame
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size)
    return false;
  if (ww == 0 || hh == 0) return false;
  *w = ww;
  *h = hh;
  return true;
}

bool vp8l_check_signature(const uint8_t* d, size_t size) {
  return size >= 5 && d[0] == 0x2f && (d[4] >> 5) == 0;
}

bool vp8l_get_info(const uint8_t* d, size_t size, int* w, int* h) {
  if (!vp8l_check_signature(d, size)) return false;
  const uint64_t v = (uint64_t)le32(d) | (uint64_t)d[4] << 32;
  *w = (int)((v >> 8) & 0x3fff) + 1;
  *h = (int)((v >> 22) & 0x3fff) + 1;
  return ((v >> 37) & 7) == 0;
}

// decode: WebPParseHeaders (all data there, the frame's own headers);
// otherwise WebPGetFeatures
int parse_headers(const uint8_t* data, size_t size, bool decode, Headers* hd) {
  if (size < 12) return kNotEnoughData;
  size_t riff_size = 0;
  if (tag(data, "RIFF")) {
    if (!tag(data + 8, "WEBP")) return kBitstreamError;
    const uint32_t s = le32(data + 4);
    if (s < 12 || s > kMaxChunkPayload) return kBitstreamError;
    if (decode && s > size - 8) return kNotEnoughData;
    riff_size = s;
    data += 12;
    size -= 12;
  }
  const bool found_riff = riff_size > 0;
  bool found_vp8x = false;
  int canvas_w = 0, canvas_h = 0;
  uint32_t flags = 0;
  if (size < 8) return kNotEnoughData;
  if (tag(data, "VP8X")) {
    if (le32(data + 4) != 10) return kBitstreamError;
    if (size < 18) return kNotEnoughData;
    flags = le32(data + 8);
    const uint64_t w = 1 + le24(data + 12), h = 1 + le24(data + 15);
    if (w * h >= kMaxImageArea) return kBitstreamError;
    canvas_w = (int)w;
    canvas_h = (int)h;
    data += 18;
    size -= 18;
    found_vp8x = true;
  }
  const bool animation = flags & 2;
  if (!found_riff && found_vp8x) return kBitstreamError;
  hd->width = canvas_w;
  hd->height = canvas_h;
  int status = kOk;
  int image_w = canvas_w, image_h = canvas_h;
  do {
    if (found_vp8x && animation && !decode) break;
    if (size < 4) { status = kNotEnoughData; break; }
    if ((found_riff && found_vp8x) ||
        (!found_riff && !found_vp8x && tag(data, "ALPH"))) {
      // ParseOptionalChunks
      uint32_t total = 4 + 8 + 10;
      for (;;) {
        if (size < 8) { status = kNotEnoughData; break; }
        const uint32_t chunk = le32(data + 4);
        if (chunk > kMaxChunkPayload) return kBitstreamError;
        const uint32_t disk = (8 + chunk + 1) & ~1u;
        total += disk;
        if (riff_size > 0 && total > riff_size) return kBitstreamError;
        if (tag(data, "VP8 ") || tag(data, "VP8L")) break;
        if (size < disk) { status = kNotEnoughData; break; }
        if (tag(data, "ALPH")) {
          hd->alpha = data + 8;
          hd->alpha_size = chunk;
        }
        data += disk;
        size -= disk;
      }
      if (status != kOk) break;
    }
    // ParseVP8Header
    if (size < 8) { status = kNotEnoughData; break; }
    size_t compressed;
    bool lossless;
    if (tag(data, "VP8 ") || tag(data, "VP8L")) {
      const uint32_t s = le32(data + 4);
      if (riff_size >= 12 && s > riff_size - 12) return kBitstreamError;
      if (decode && s > size - 8) { status = kNotEnoughData; break; }
      compressed = s;
      lossless = tag(data, "VP8L");
      data += 8;
      size -= 8;
    } else {
      lossless = vp8l_check_signature(data, size);
      compressed = size;
    }
    if (compressed > kMaxChunkPayload) return kBitstreamError;
    if (!lossless) {
      if (size < 10) { status = kNotEnoughData; break; }
      if (!vp8_get_info(data, size, compressed, &image_w, &image_h))
        return kBitstreamError;
    } else {
      if (size < 5) { status = kNotEnoughData; break; }
      if (!vp8l_get_info(data, size, &image_w, &image_h))
        return kBitstreamError;
    }
    if (found_vp8x && (canvas_w != image_w || canvas_h != image_h))
      return kBitstreamError;
    hd->lossless = lossless;
    hd->payload = data;
    hd->payload_size = size;
  } while (false);
  if (status == kOk || (status == kNotEnoughData && found_vp8x && !decode)) {
    hd->width = image_w;
    hd->height = image_h;
    if (decode && animation) return kUnsupported;
    return kOk;
  }
  return status;
}

// -- the demuxer: demux.c, for a whole file (WebPDemux) -----------------------

enum { kParseOk, kParseNeedMore, kParseError };
enum { kStateParsingHeader = 0, kStateParsedHeader = 1, kStateDone = 2 };

struct Chunk {
  size_t offset = 0, size = 0;
};

struct Frame {
  int x = 0, y = 0, w = 0, h = 0, num = 0;
  bool complete = false;
  Chunk image, alpha;
};

struct Demux {
  const uint8_t* buf = nullptr;
  size_t start = 0, end = 0, riff_end = 0, buf_size = 0;
  bool ext = false;
  uint32_t flags = 0;
  int64_t canvas_w = -1, canvas_h = -1;
  int state = kStateParsingHeader, num_frames = 0;
  std::vector<Frame> frames;

  size_t avail() const { return end - start; }
  bool size_invalid(size_t n) const { return n > riff_end - start; }
  uint32_t read32() { start += 4; return le32(buf + start - 4); }
  uint32_t read24() { start += 3; return le24(buf + start - 3); }
  uint8_t read8() { return buf[start++]; }

  bool add_frame(const Frame& f) {
    if (!frames.empty() && !frames.back().complete) return false;
    frames.push_back(f);
    return true;
  }

  int store_frame(int frame_num, uint32_t min_size, Frame* frame) {
    int alpha_chunks = 0, image_chunks = 0;
    if (avail() < 8 || avail() < min_size) return kParseNeedMore;
    int status = kParseOk;
    bool done = false;
    do {
      const size_t chunk_start = start;
      const uint8_t* fourcc = buf + start;
      start += 4;
      const uint32_t payload = read32();
      if (payload > kMaxChunkPayload) return kParseError;
      const uint32_t padded = payload + (payload & 1);
      const size_t available = std::min<size_t>(padded, avail());
      const size_t chunk_size = 8 + available;
      if (size_invalid(padded)) return kParseError;
      if (padded > avail()) status = kParseNeedMore;
      const bool vp8l = tag(fourcc, "VP8L");
      if (tag(fourcc, "ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        frame->alpha = {chunk_start, chunk_size};
        frame->num = frame_num;
        start += available;
      } else if ((vp8l || tag(fourcc, "VP8 ")) && !tag(fourcc, "ALPH")) {
        if (vp8l && alpha_chunks > 0) return kParseError;
        if (image_chunks > 0) {
          start -= 8;
          done = true;
        } else {
          Headers hd;
          const int s = parse_headers(buf + chunk_start, chunk_size, false,
                                      &hd);
          if (status == kParseNeedMore && s == kNotEnoughData)
            return kParseNeedMore;
          if (s != kOk) return kParseError;
          ++image_chunks;
          frame->image = {chunk_start, chunk_size};
          frame->w = hd.width;
          frame->h = hd.height;
          frame->num = frame_num;
          frame->complete = status == kParseOk;
          start += available;
        }
      } else {
        start -= 8;
        done = true;
      }
      if (start == riff_end) {
        done = true;
      } else if (avail() < 8) {
        status = kParseNeedMore;
      }
    } while (!done && status == kParseOk);
    return status;
  }

  int parse_single_image() {
    if (!frames.empty()) return kParseError;
    if (size_invalid(8)) return kParseError;
    if (avail() < 8) return kParseNeedMore;
    Frame frame;
    int status = store_frame(1, 0, &frame);
    if (status != kParseError) {
      if (!(flags & 0x10) && frame.alpha.size > 0) frame.alpha = Chunk();
      if (!ext && frame.w > 0 && frame.h > 0) {
        state = kStateParsedHeader;
        canvas_w = frame.w;
        canvas_h = frame.h;
      }
      if (!add_frame(frame)) {
        status = kParseError;
      } else {
        num_frames = 1;
      }
    }
    return status;
  }

  int parse_animation_frame(uint32_t frame_chunk_size) {
    const bool animation = flags & 2;
    const uint32_t anmf_payload = frame_chunk_size - 16;
    if (size_invalid(16)) return kParseError;
    if (frame_chunk_size < 16) return kParseError;
    if (avail() < 16) return kParseNeedMore;
    Frame frame;
    frame.x = 2 * (int)read24();
    frame.y = 2 * (int)read24();
    frame.w = 1 + (int)read24();
    frame.h = 1 + (int)read24();
    read24();                                   // duration
    read8();                                    // dispose, blend
    if ((uint64_t)frame.w * frame.h >= kMaxImageArea) return kParseError;
    const size_t before = start;
    int status = store_frame(num_frames + 1, anmf_payload, &frame);
    if (status != kParseError && start - before > anmf_payload)
      status = kParseError;
    if (status != kParseError && animation && frame.num > 0) {
      if (add_frame(frame)) {
        ++num_frames;
      } else {
        status = kParseError;
      }
    }
    return status;
  }

  int parse_vp8x_chunks() {
    const bool animation = flags & 2;
    int anim_chunks = 0, status = kParseOk;
    do {
      const uint8_t* fourcc = buf + start;
      start += 4;
      const uint32_t chunk = read32();
      if (chunk > kMaxChunkPayload) return kParseError;
      const uint32_t padded = chunk + (chunk & 1);
      if (size_invalid(padded)) return kParseError;
      if (tag(fourcc, "VP8X")) return kParseError;
      if (tag(fourcc, "ALPH") || tag(fourcc, "VP8 ") || tag(fourcc, "VP8L")) {
        if (anim_chunks > 0 || animation) return kParseError;
        start -= 8;
        status = parse_single_image();
      } else if (tag(fourcc, "ANIM") && anim_chunks == 0) {
        if (padded < 6) return kParseError;
        if (avail() < padded) {
          status = kParseNeedMore;
        } else {
          ++anim_chunks;
          start += padded;               // background colour, loop count
        }
      } else if (tag(fourcc, "ANMF")) {
        if (anim_chunks == 0) return kParseError;
        status = parse_animation_frame(padded);
      } else {
        if (tag(fourcc, "ANIM") && padded < 6) return kParseError;
        if (padded <= avail()) {
          start += padded;
        } else {
          status = kParseNeedMore;
        }
      }
      if (start == riff_end) break;
      if (avail() < 8) status = kParseNeedMore;
    } while (status == kParseOk);
    return status;
  }

  int parse_vp8x() {
    if (avail() < 8) return kParseNeedMore;
    ext = true;
    start += 4;
    uint32_t size = read32();
    if (size > kMaxChunkPayload || size < 10) return kParseError;
    size += size & 1;
    if (size_invalid(size)) return kParseError;
    if (avail() < size) return kParseNeedMore;
    flags = read8();
    start += 3;
    canvas_w = 1 + (int64_t)read24();
    canvas_h = 1 + (int64_t)read24();
    if ((uint64_t)(canvas_w * canvas_h) >= kMaxImageArea) return kParseError;
    start += size - 10;
    state = kStateParsedHeader;
    if (size_invalid(8)) return kParseError;
    if (avail() < 8) return kParseNeedMore;
    return parse_vp8x_chunks();
  }

  bool valid_simple() const {
    if (state == kStateParsingHeader) return true;
    if (canvas_w <= 0 || canvas_h <= 0) return false;
    if (state == kStateDone && frames.empty()) return false;
    return frames[0].w > 0 && frames[0].h > 0;
  }

  bool valid_extended() const {
    const bool animation = flags & 2;
    if (state == kStateParsingHeader) return true;
    if (canvas_w <= 0 || canvas_h <= 0) return false;
    if (state == kStateDone && frames.empty()) return false;
    if (flags & ~0x3eu) return false;
    for (size_t i = 0; i < frames.size(); ++i) {
      const Frame& f = frames[i];
      if (!animation && f.num > 1) return false;
      if (f.complete) {
        if (f.alpha.size == 0 && f.image.size == 0) return false;
        if (f.alpha.size > 0 && f.alpha.offset > f.image.offset) return false;
        if (f.w <= 0 || f.h <= 0) return false;
      } else {
        if (state == kStateDone) return false;
        if (f.alpha.size > 0 && f.image.size > 0 &&
            f.alpha.offset > f.image.offset)
          return false;
        if (i + 1 < frames.size()) return false;
      }
      if (f.w > 0 && f.h > 0) {
        if (!animation) {
          if (f.x != 0 || f.y != 0 || f.w != canvas_w || f.h != canvas_h)
            return false;
        } else if (f.x < 0 || f.y < 0 || f.w + f.x > canvas_w ||
                   f.h + f.y > canvas_h) {
          return false;
        }
      }
    }
    return true;
  }

  // WebPDemux on the whole of data: false where it gives NULL
  bool parse(const uint8_t* data, size_t size) {
    buf = data;
    end = buf_size = size;
    // ReadHeader
    if (size < 20) return false;
    if (!tag(data, "RIFF") || !tag(data + 8, "WEBP")) return false;
    const uint32_t riff_size = le32(data + 4);
    // a RIFF size too small for a chunk: WebPDemux tries the bytes as a raw
    // VP8/VP8L stream, which WebPGetFeatures refuses for a RIFF file
    if (riff_size < 8 || riff_size > kMaxChunkPayload) return false;
    riff_end = (size_t)riff_size + 8;
    if (buf_size > riff_end) buf_size = end = riff_end;
    start = 12;
    if (buf_size < riff_end) return false;       // partial: refused
    int status = kParseError;
    bool simple = false;
    const uint8_t* id = buf + start;
    if (tag(id, "VP8 ") || tag(id, "VP8L")) {
      simple = true;
      status = parse_single_image();
    } else if (tag(id, "VP8X")) {
      status = parse_vp8x();
    } else {
      return false;
    }
    if (status == kParseOk) state = kStateDone;
    if (status == kParseNeedMore) status = kParseError;
    if (status != kParseError && !(simple ? valid_simple() : valid_extended()))
      status = kParseError;
    return status != kParseError;
  }
};

// WebPAnimDecoderNew and Pillow's open: the canvas, or false where it fails
bool open_webp(const uint8_t* data, size_t size, Demux* dmux) {
  Headers hd;
  if (parse_headers(data, size, false, &hd) != kOk) return false;
  if (!dmux->parse(data, size)) return false;
  return dmux->canvas_w * dmux->canvas_h <= kMaxPixels;
}

// -- VP8: the boolean decoder (bit_reader_utils.c, bit_reader_inl_utils.h) --
//
// Loads a byte at a time where libwebp loads 56 bits: the bits each call
// sees, and the call at which the end of data is flagged, are the same.

struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;                // range - 1
  int bits = -8;                       // bits left past the 8-bit window
  bool eof = false;

  void init(const uint8_t* p, size_t n) {
    buf = p;
    end = p + n;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = *buf++ | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  // VP8GetSigned: a sign at probability 1/2, shift always 1
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  int get_value(int n) {
    int v = 0;
    while (n-- > 0) v |= get_bit(0x80) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = get_value(n);
    return get_bit(0x80) ? -v : v;
  }
};

// -- VP8: prediction, transforms, loop filter (dsp/dec.c) --------------------

constexpr int BPS = 32;
constexpr int kYOff = BPS * 1 + 8, kUOff = kYOff + BPS * 16 + BPS,
              kVOff = kUOff + 16, kYuvSize = BPS * 17 + BPS * 9;

enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

inline uint8_t clip8b(int v) { return !(v & ~0xff) ? v : v < 0 ? 0 : 255; }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    const int base = dst[-1] - top[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8b(top[x] + base);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

// 16x16 luma (size 16) and 8x8 chroma (size 8)
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 5 : 4;
  int dc;
  switch (mode) {
    case B_DC:
      dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, size, dc >> shift);
      break;
    case DC_NOTOP:
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> (shift - 1));
      break;
    case DC_NOLEFT:
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, dc >> (shift - 1));
      break;
    case DC_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case B_HE:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1],
                                            size);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3],
            E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, dc >> 3, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t vals[4] = {(uint8_t)avg3(X, A, B), (uint8_t)avg3(A, B, C),
                               (uint8_t)avg3(B, C, D), (uint8_t)avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE:
      memset(dst, avg3(X, I, J), 4);
      memset(dst + BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}

#undef DST

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne_C, in int; its DC-only and AC3 shortcuts (which libwebp
// runs in C for blocks whose only coefficients are 0, 1 and 4) compute the
// same pixels
void transform(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8b(dst[0] + ((a + d) >> 3));
    dst[1] = clip8b(dst[1] + ((b + c) >> 3));
    dst[2] = clip8b(dst[2] + ((b - c) >> 3));
    dst[3] = clip8b(dst[3] + ((a - d) >> 3));
  }
}

inline int16_t w16(int v) { return (int16_t)v; }
inline int16_t mulhi(int16_t v, int k) { return (int16_t)((v * k) >> 16); }
inline int16_t mul_c(int16_t c1, int16_t c3) {       // MUL2(c1) - MUL1(c3)
  return w16(w16(c1 - c3) + w16(mulhi(c1, -30068) - mulhi(c3, 20091)));
}
inline int16_t mul_d(int16_t c1, int16_t c3) {       // MUL1(c1) + MUL2(c3)
  return w16(w16(c1 + c3) + w16(mulhi(c1, 20091) + mulhi(c3, -30068)));
}

// Transform_SSE2, which libwebp runs on x86 for every other block: the same
// passes in 16-bit lanes that wrap, where the C's ints do not (they differ
// only on coefficients no encoder writes)
void transform_sse2(const int16_t* in, uint8_t* dst) {
  int16_t C[16], *tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int16_t a = w16(in[0] + in[8]), b = w16(in[0] - in[8]);
    const int16_t c = mul_c(in[4], in[12]), d = mul_d(in[4], in[12]);
    tmp[0] = w16(a + d);
    tmp[1] = w16(b + c);
    tmp[2] = w16(b - c);
    tmp[3] = w16(a - d);
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
    const int16_t dc = w16(tmp[0] + 4);
    const int16_t a = w16(dc + tmp[8]), b = w16(dc - tmp[8]);
    const int16_t c = mul_c(tmp[4], tmp[12]), d = mul_d(tmp[4], tmp[12]);
    dst[0] = clip8b(dst[0] + (w16(a + d) >> 3));
    dst[1] = clip8b(dst[1] + (w16(b + c) >> 3));
    dst[2] = clip8b(dst[2] + (w16(b - c) >> 3));
    dst[3] = clip8b(dst[3] + (w16(a - d) >> 3));
  }
}

// DoTransform: the 2-bit code of a block's coefficients (3: beyond the
// first three in zigzag order; 2: the first three; 1: DC only; 0: none)
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3:
      transform_sse2(src, dst);
      break;
    case 2:
    case 1:
      transform(src, dst);
      break;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
  }
}

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8b(p0 + a2);
  p[0] = clip8b(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8b(p1 + a3);
  p[-step] = clip8b(p0 + a2);
  p[0] = clip8b(q0 - a1);
  p[step] = clip8b(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
            a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8b(p2 + a3);
  p[-2 * step] = clip8b(p1 + a2);
  p[-step] = clip8b(p0 + a1);
  p[0] = clip8b(q0 - a1);
  p[step] = clip8b(q1 - a2);
  p[2 * step] = clip8b(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// SimpleVFilter16 (hstride = stride, vstride = 1) and SimpleHFilter16
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

// FilterLoop26 (macroblock edges, six taps) and FilterLoop24 (inner edges)
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  for (; size > 0; --size, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) {
      do_filter2(p, hstride);
    } else if (edge) {
      do_filter6(p, hstride);
    } else {
      do_filter4(p, hstride);
    }
  }
}

// -- VP8: the frame (vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c) --------

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4 = 0, imodes[16] = {}, uvmode = 0, segment = 0, skip = 0;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

class VP8Decoder {
 public:
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  std::vector<uint8_t> y, u, v;        // mb_w * 16 wide, mb_w * 8 wide
  int y_stride = 0, uv_stride = 0;

  // VP8GetHeaders and VP8Decode on one frame's VP8 payload; false where
  // libwebp's decode fails
  bool decode(const uint8_t* buf, size_t size) {
    if (size < 4) return false;
    const uint32_t bits = buf[0] | buf[1] << 8 | buf[2] << 16;
    if (bits & 1) return false;                       // not a key frame
    if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1)) return false;
    const uint32_t partition_length = bits >> 5;
    buf += 3;
    size -= 3;
    if (size < 7) return false;
    if (!(buf[0] == 0x9d && buf[1] == 0x01 && buf[2] == 0x2a)) return false;
    width = le16(buf + 3) & 0x3fff;
    height = le16(buf + 5) & 0x3fff;
    buf += 7;
    size -= 7;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    if (partition_length > size) return false;
    br_.init(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br_.get_value(1);                                  // colour space
    br_.get_value(1);                                  // clamping type
    if (!parse_segment_header() || !parse_filter_header()) return false;
    if (!parse_partitions(buf, size)) return false;
    parse_quant();
    br_.get_value(1);                                  // update_proba
    parse_proba();
    precompute_filter_strengths();
    return decode_frame();
  }

 private:
  BoolReader br_, parts_[8];
  int num_parts_m1_ = 0;
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {}, filter_strength_[4] = {};
  uint8_t seg_proba_[3] = {255, 255, 255};
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {}, mode_lf_delta_[4] = {};
  QuantMatrix dqm_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  FInfo fstrengths_[4][2];
  std::vector<FInfo> finfo_;

  bool parse_segment_header() {
    use_segment_ = br_.get_value(1);
    if (use_segment_) {
      update_map_ = br_.get_value(1);
      if (br_.get_value(1)) {
        absolute_delta_ = br_.get_value(1);
        for (int s = 0; s < 4; ++s)
          quantizer_[s] = br_.get_value(1) ? br_.get_signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength_[s] = br_.get_value(1) ? br_.get_signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s)
          seg_proba_[s] = br_.get_value(1) ? br_.get_value(8) : 255;
    } else {
      update_map_ = false;
    }
    return !br_.eof;
  }

  bool parse_filter_header() {
    simple_ = br_.get_value(1);
    level_ = br_.get_value(6);
    sharpness_ = br_.get_value(3);
    use_lf_delta_ = br_.get_value(1);
    if (use_lf_delta_ && br_.get_value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br_.get_value(1)) ref_lf_delta_[i] = br_.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.get_value(1)) mode_lf_delta_[i] = br_.get_signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    return !br_.eof;
  }

  bool parse_partitions(const uint8_t* buf, size_t size) {
    const uint8_t* sz = buf;
    const uint8_t* buf_end = buf + size;
    num_parts_m1_ = (1 << br_.get_value(2)) - 1;
    const size_t last = num_parts_m1_;
    if (size < 3 * last) return false;
    const uint8_t* part_start = buf + last * 3;
    size_t left = size - last * 3;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = le24(sz);
      if (psize > left) psize = left;
      parts_[p].init(part_start, psize);
      part_start += psize;
      left -= psize;
    }
    parts_[last].init(part_start, left);
    return part_start < buf_end;
  }

  static int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

  void parse_quant() {
    const int base_q0 = br_.get_value(7);
    int dq[5];
    for (int i = 0; i < 5; ++i)
      dq[i] = br_.get_value(1) ? br_.get_signed_value(4) : 0;
    const int dqy1_dc = dq[0], dqy2_dc = dq[1], dqy2_ac = dq[2],
              dquv_dc = dq[3], dquv_ac = dq[4];
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i] + (absolute_delta_ ? 0 : base_q0);
      } else if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      QuantMatrix& m = dqm_[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void parse_proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = br_.get_bit(kCoeffsUpdateProba[t][b][c][p])
                                     ? br_.get_value(8)
                                     : kCoeffsProba0[t][b][c][p];
    use_skip_proba_ = br_.get_value(1);
    if (use_skip_proba_) skip_p_ = br_.get_value(8);
  }

  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) {
        base = filter_strength_[s] + (absolute_delta_ ? 0 : level_);
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  // per row / per column state
  std::vector<MBData> row_;
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4] = {};
  struct NZ {
    uint8_t nz = 0, nz_dc = 0;
  };
  std::vector<NZ> nz_top_;
  NZ nz_left_;
  struct Top {
    uint8_t y[16], u[8], v[8];
  };
  std::vector<Top> yuv_t_;
  uint8_t yuv_b_[kYuvSize];

  void parse_intra_mode(int mb_x) {
    uint8_t* const top = &intra_t_[4 * mb_x];
    uint8_t* const left = intra_l_;
    MBData& b = row_[mb_x];
    if (update_map_) {
      b.segment = !br_.get_bit(seg_proba_[0])
                      ? br_.get_bit(seg_proba_[1])
                      : br_.get_bit(seg_proba_[2]) + 2;
    } else {
      b.segment = 0;
    }
    if (use_skip_proba_) b.skip = br_.get_bit(skip_p_);
    b.is_i4x4 = !br_.get_bit(145);
    if (!b.is_i4x4) {
      const int ymode = br_.get_bit(156) ? (br_.get_bit(128) ? B_TM : B_HE)
                                         : (br_.get_bit(163) ? B_VE : B_DC);
      b.imodes[0] = ymode;
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* const prob = kBModesProba[top[x]][ymode];
          ymode = !br_.get_bit(prob[0])   ? B_DC
                  : !br_.get_bit(prob[1]) ? B_TM
                  : !br_.get_bit(prob[2]) ? B_VE
                  : !br_.get_bit(prob[3])
                      ? (!br_.get_bit(prob[4])   ? B_HE
                         : !br_.get_bit(prob[5]) ? B_RD
                                                 : B_VR)
                      : (!br_.get_bit(prob[6])   ? B_LD
                         : !br_.get_bit(prob[7]) ? B_VL
                         : !br_.get_bit(prob[8]) ? B_HD
                                                 : B_HU);
          top[x] = ymode;
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[y] = ymode;
      }
    }
    b.uvmode = !br_.get_bit(142)   ? B_DC
               : !br_.get_bit(114) ? B_VE
               : br_.get_bit(183)  ? B_TM
                                   : B_HE;
  }

  int get_large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.get_bit(p[3])) {
      v = !br.get_bit(p[4]) ? 2 : 3 + br.get_bit(p[5]);
    } else if (!br.get_bit(p[6])) {
      if (!br.get_bit(p[7])) {
        v = 5 + br.get_bit(159);
      } else {
        v = 7 + 2 * br.get_bit(165);
        v += br.get_bit(145);
      }
    } else {
      const int bit1 = br.get_bit(p[8]);
      const int bit0 = br.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
        v += v + br.get_bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  int get_coeffs(BoolReader& br, int t, int ctx, const int* dq, int n,
                 int16_t* out) {
    const uint8_t* p = proba_[t][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.get_bit(p[0])) return n;
      while (!br.get_bit(p[1])) {
        p = proba_[t][kBands[++n]][0];
        if (n == 16) return 16;
      }
      const uint8_t(*p_ctx)[11] = proba_[t][kBands[n + 1]];
      int v;
      if (!br.get_bit(p[2])) {
        v = 1;
        p = p_ctx[1];
      } else {
        v = get_large_value(br, p);
        p = p_ctx[2];
      }
      out[kZigzag[n]] = (int16_t)(br.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
    return nz_coeffs;
  }

  // ParseResiduals: true where every coefficient is zero
  bool parse_residuals(int mb_x, BoolReader& br) {
    NZ& mb = nz_top_[mb_x];
    NZ& left = nz_left_;
    MBData& block = row_[mb_x];
    const QuantMatrix& q = dqm_[block.segment];
    int16_t* dst = block.coeffs;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    memset(dst, 0, sizeof(block.coeffs));
    int first, ac_type;
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb.nz_dc + left.nz_dc;
      const int nz = get_coeffs(br, 1, ctx, q.y2, 0, dc);
      mb.nz_dc = left.nz_dc = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (l << 7);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = mb.nz >> (4 + ch);
      lnz = left.nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (l << 3);
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    mb.nz = (uint8_t)out_t_nz;
    left.nz = (uint8_t)out_l_nz;
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  bool decode_mb(int mb_x, int mb_y, BoolReader& br) {
    MBData& block = row_[mb_x];
    int skip = use_skip_proba_ ? block.skip : 0;
    if (!skip) {
      skip = parse_residuals(mb_x, br);
    } else {
      nz_left_.nz = nz_top_[mb_x].nz = 0;
      if (!block.is_i4x4) nz_left_.nz_dc = nz_top_[mb_x].nz_dc = 0;
      block.non_zero_y = 0;
      block.non_zero_uv = 0;
    }
    if (filter_type_ > 0) {
      FInfo& f = finfo_[(size_t)mb_y * mb_w + mb_x];
      f = fstrengths_[block.segment][block.is_i4x4];
      f.inner |= !skip;
    }
    return !br.eof;
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC) {
      if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return mb_y == 0 ? DC_NOTOP : B_DC;
    }
    return mode;
  }

  void reconstruct_row(int mb_y) {
    uint8_t* const y_dst = yuv_b_ + kYOff;
    uint8_t* const u_dst = yuv_b_ + kUOff;
    uint8_t* const v_dst = yuv_b_ + kVOff;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData& block = row_[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j)
          memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      Top* const top_yuv = &yuv_t_[mb_x];
      const int16_t* const coeffs = block.coeffs;
      uint32_t bits = block.non_zero_y;
      if (mb_y > 0) {
        memcpy(y_dst - BPS, top_yuv[0].y, 16);
        memcpy(u_dst - BPS, top_yuv[0].u, 8);
        memcpy(v_dst - BPS, top_yuv[0].v, 8);
      }
      if (block.is_i4x4) {
        uint8_t* const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {
            memset(top_right, top_yuv[0].y[15], 4);
          } else {
            memcpy(top_right, top_yuv[1].y, 4);
          }
        }
        // the top-right pixels, replicated down the rightmost 4x4 blocks
        for (int k = 1; k <= 3; ++k)
          memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, block.imodes[n]);
          do_transform(bits, coeffs + n * 16, dst);
        }
      } else {
        predict_block(y_dst, 16, check_mode(mb_x, mb_y, block.imodes[0]));
        for (int n = 0; bits != 0 && n < 16; ++n, bits <<= 2)
          do_transform(bits, coeffs + n * 16,
                       y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      const uint32_t bits_uv = block.non_zero_uv;
      const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
      predict_block(u_dst, 8, uv_mode);
      predict_block(v_dst, 8, uv_mode);
      // DoUVTransform: any AC in a plane, Transform_SSE2 on its four
      // blocks; DC only, TransformDC in C
      for (int c = 0; c < 2; ++c) {
        const uint32_t plane = (bits_uv >> (8 * c)) & 0xff;
        if (!plane) continue;
        uint8_t* const dst = c ? v_dst : u_dst;
        const int16_t* const src = coeffs + (16 + 4 * c) * 16;
        for (int n = 0; n < 4; ++n)
          (plane & 0xaa ? transform_sse2 : transform)(
              src + n * 16, dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
      }
      if (mb_y < mb_h - 1) {
        memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
        memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
        memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
      }
      uint8_t* const y_out = &y[(size_t)mb_y * 16 * y_stride + mb_x * 16];
      uint8_t* const u_out = &u[(size_t)mb_y * 8 * uv_stride + mb_x * 8];
      uint8_t* const v_out = &v[(size_t)mb_y * 8 * uv_stride + mb_x * 8];
      for (int j = 0; j < 16; ++j)
        memcpy(y_out + j * y_stride, y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(u_out + j * uv_stride, u_dst + j * BPS, 8);
        memcpy(v_out + j * uv_stride, v_dst + j * BPS, 8);
      }
    }
  }

  void do_filter(int mb_x, int mb_y) {
    const FInfo& f = finfo_[(size_t)mb_y * mb_w + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* const yd = &y[(size_t)mb_y * 16 * y_stride + mb_x * 16];
    const int ys = y_stride;
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_filter(yd, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_filter(yd, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k)
          simple_filter(yd + 4 * k * ys, ys, 1, limit);
      return;
    }
    const int us = uv_stride, il = f.ilevel, ht = f.hev_thresh;
    uint8_t* const ud = &u[(size_t)mb_y * 8 * us + mb_x * 8];
    uint8_t* const vd = &v[(size_t)mb_y * 8 * us + mb_x * 8];
    if (mb_x > 0) {
      filter_loop(yd, 1, ys, 16, limit + 4, il, ht, true);
      filter_loop(ud, 1, us, 8, limit + 4, il, ht, true);
      filter_loop(vd, 1, us, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        filter_loop(yd + 4 * k, 1, ys, 16, limit, il, ht, false);
      filter_loop(ud + 4, 1, us, 8, limit, il, ht, false);
      filter_loop(vd + 4, 1, us, 8, limit, il, ht, false);
    }
    if (mb_y > 0) {
      filter_loop(yd, ys, 1, 16, limit + 4, il, ht, true);
      filter_loop(ud, us, 1, 8, limit + 4, il, ht, true);
      filter_loop(vd, us, 1, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        filter_loop(yd + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
      filter_loop(ud + 4 * us, us, 1, 8, limit, il, ht, false);
      filter_loop(vd + 4 * us, us, 1, 8, limit, il, ht, false);
    }
  }

  bool decode_frame() {
    y_stride = mb_w * 16;
    uv_stride = mb_w * 8;
    y.assign((size_t)y_stride * mb_h * 16, 0);
    u.assign((size_t)uv_stride * mb_h * 8, 0);
    v.assign((size_t)uv_stride * mb_h * 8, 0);
    row_.assign(mb_w, MBData());
    intra_t_.assign(4 * (size_t)mb_w, B_DC);
    memset(intra_l_, B_DC, 4);
    nz_top_.assign(mb_w, NZ());
    nz_left_ = NZ();
    yuv_t_.assign(mb_w, Top());
    memset(yuv_b_, 0, sizeof(yuv_b_));
    if (filter_type_ > 0) finfo_.assign((size_t)mb_w * mb_h, FInfo());
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      BoolReader& token_br = parts_[mb_y & num_parts_m1_];
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(mb_x);
      if (br_.eof) return false;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        if (!decode_mb(mb_x, mb_y, token_br)) return false;
      nz_left_ = NZ();
      memset(intra_l_, B_DC, 4);
      reconstruct_row(mb_y);
    }
    // the loop filter in macroblock order: it reads and writes only the
    // planes, which prediction never reads (it takes its samples unfiltered)
    if (filter_type_ > 0)
      for (int mb_y = 0; mb_y < mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) do_filter(mb_x, mb_y);
    return true;
  }
};

// -- YUV 4:2:0 -> RGB: libwebp's fancy upsampler (dsp/upsampling.c, yuv.h) --

inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t clip_yuv(int v) {
  return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255;
}

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = clip_yuv(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = clip_yuv(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) +
                    8708);
  rgb[2] = clip_yuv(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

inline void emit(int y, uint32_t uv, uint8_t* dst) {
  yuv_to_rgb(y, uv & 0xff, uv >> 16, dst);
}

// UpsampleRgbaLinePair, into `step` bytes a pixel; bottom_y may be null
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len, int step) {
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = top_u[0] | top_v[0] << 16;
  uint32_t l_uv = cur_u[0] | cur_v[0] << 16;
  emit(top_y[0], (3 * tl_uv + l_uv + 0x00020002u) >> 2, top_dst);
  if (bottom_y)
    emit(bottom_y[0], (3 * l_uv + tl_uv + 0x00020002u) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = top_u[x] | top_v[x] << 16;
    const uint32_t uv = cur_u[x] | cur_v[x] << 16;
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    emit(top_y[2 * x - 1], (diag_12 + tl_uv) >> 1,
         top_dst + (2 * x - 1) * step);
    emit(top_y[2 * x], (diag_03 + t_uv) >> 1, top_dst + 2 * x * step);
    if (bottom_y) {
      emit(bottom_y[2 * x - 1], (diag_03 + l_uv) >> 1,
           bottom_dst + (2 * x - 1) * step);
      emit(bottom_y[2 * x], (diag_12 + uv) >> 1, bottom_dst + 2 * x * step);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    emit(top_y[len - 1], (3 * tl_uv + l_uv + 0x00020002u) >> 2,
         top_dst + (len - 1) * step);
    if (bottom_y)
      emit(bottom_y[len - 1], (3 * l_uv + tl_uv + 0x00020002u) >> 2,
           bottom_dst + (len - 1) * step);
  }
}

// EmitFancyRGB over the whole frame: the first row, then pairs of rows
// between two chroma rows, then (even heights) the last row, each edge row
// with its chroma row mirrored
void yuv_to_rgb_frame(const VP8Decoder& d, uint8_t* out, int64_t stride,
                      int step) {
  const int w = d.width, h = d.height;
  const uint8_t* Y = d.y.data();
  const uint8_t* U = d.u.data();
  const uint8_t* V = d.v.data();
  const int ys = d.y_stride, uvs = d.uv_stride;
  upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w, step);
  for (int k = 1; 2 * k < h; ++k) {
    const uint8_t* tu = U + (size_t)(k - 1) * uvs;
    const uint8_t* tv = V + (size_t)(k - 1) * uvs;
    upsample_pair(Y + (size_t)(2 * k - 1) * ys, Y + (size_t)2 * k * ys, tu, tv,
                  tu + uvs, tv + uvs, out + (2 * k - 1) * stride,
                  out + 2 * k * stride, w, step);
  }
  if (h > 1 && !(h & 1)) {
    const uint8_t* cu = U + (size_t)(h / 2 - 1) * uvs;
    const uint8_t* cv = V + (size_t)(h / 2 - 1) * uvs;
    upsample_pair(Y + (size_t)(h - 1) * ys, nullptr, cu, cv, cu, cv,
                  out + (h - 1) * stride, nullptr, w, step);
  }
}

// -- VP8L: the bit reader (bit_reader_utils.c) --------------------------------

struct LBitReader {
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  uint64_t val = 0;
  int bit_pos = 0;
  bool eos = false;

  void init(const uint8_t* p, size_t n) {
    buf = p;
    len = n;
    val = 0;
    bit_pos = 0;
    eos = false;
    const size_t k = std::min<size_t>(n, 8);
    for (size_t i = 0; i < k; ++i) val |= (uint64_t)p[i] << (8 * i);
    pos = k;
  }
  bool end_of_stream() const { return eos || (pos == len && bit_pos > 64); }
  void set_end_of_stream() {
    eos = true;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= (uint64_t)buf[pos] << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (end_of_stream()) set_end_of_stream();
  }
  uint32_t prefetch() const { return (uint32_t)(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end_of_stream();
    return 0;
  }
  void fill() {
    if (bit_pos < 32) return;
    if (pos + 8 < len) {
      val >>= 32;
      bit_pos -= 32;
      val |= (uint64_t)le32(buf + pos) << 32;
      pos += 4;
    } else {
      shift_bytes();
    }
  }
};

// -- VP8L: prefix codes (huffman_utils.c) -------------------------------------
//
// Canonical codes read first bit first from the LSB-first stream. A root
// table decodes codes of up to 8 bits; a longer one reads its first 8 bits
// from the first look and the rest from a second look 8 bits on, as
// libwebp's two-level table does.

struct PrefixCode {
  int root[256];                      // (length << 16) | symbol, -1: longer
  int count[16] = {}, first[16] = {}, offset[16] = {};
  std::vector<uint16_t> sorted;
  int max_len = 0;

  // VP8LBuildHuffmanTable's checks: false where it returns 0
  bool build(const int* lengths, int n) {
    int num = 0;
    memset(count, 0, sizeof(count));
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      ++count[lengths[s]];
    }
    if (count[0] == n) return false;
    for (int l = 1; l < 16; ++l) num += count[l];
    sorted.assign(num, 0);
    int off = 0;
    for (int l = 1; l < 16; ++l) {
      offset[l] = off;
      off += count[l];
    }
    int fill_at[16];
    memcpy(fill_at, offset, sizeof(fill_at));
    for (int s = 0; s < n; ++s)
      if (lengths[s] > 0) sorted[fill_at[lengths[s]]++] = (uint16_t)s;
    if (num == 1) {                   // one symbol: read with zero bits
      max_len = 0;
      for (int i = 0; i < 256; ++i) root[i] = sorted[0];
      return true;
    }
    int num_nodes = 1, num_open = 1;
    for (int l = 1; l < 16; ++l) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= count[l];
      if (num_open < 0) return false;
    }
    if (num_nodes != 2 * num - 1) return false;
    int code = 0;
    max_len = 0;
    for (int i = 0; i < 256; ++i) root[i] = -1;
    for (int l = 1; l < 16; ++l) {
      first[l] = code;
      for (int k = 0; k < count[l]; ++k, ++code) {
        max_len = l;
        if (l > 8) continue;
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((code >> (l - 1 - b)) & 1) << b;
        for (int r = rev; r < 256; r += 1 << l)
          root[r] = l << 16 | sorted[offset[l] + k];
      }
      code <<= 1;
    }
    return true;
  }

  int read(LBitReader& br) const {
    uint32_t v = br.prefetch();
    const int e = root[v & 0xff];
    if (e >= 0) {
      br.bit_pos += e >> 16;
      return e & 0xffff;
    }
    br.bit_pos += 8;
    const uint32_t v2 = br.prefetch();
    int c = 0;
    for (int l = 1; l <= 15; ++l) {
      const int bit = l <= 8 ? (v >> (l - 1)) & 1 : (v2 >> (l - 9)) & 1;
      c = (c << 1) | bit;
      if (l > 8 && c >= first[l] && c - first[l] < count[l]) {
        br.bit_pos += l - 8;
        return sorted[offset[l] + c - first[l]];
      }
    }
    return 0;                         // not reached for a complete code
  }
};

constexpr int kLiteral = 256, kLengthCodes = 24, kDistanceCodes = 40;
const int kAlphabetSize[5] = {kLiteral + kLengthCodes, kLiteral, kLiteral,
                              kLiteral, kDistanceCodes};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };

struct HTreeGroup {
  PrefixCode codes[5];
};

struct LTransform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

// the entropy coding of one image: colour cache, meta codes, code groups
struct LMeta {
  int cache_bits = 0, huff_bits = 0, huff_xsize = 0;
  std::vector<uint32_t> huff_image;
  std::vector<HTreeGroup> groups;
  std::vector<char> used;             // where libwebp keeps only used groups
};

class VP8LDecoder {
 public:
  LBitReader br;
  LTransform transforms[4];
  int num_transforms = 0;

  // DecodeImageStream: a level-0 image gives its entropy coding in meta and
  // its coded width in xsize; a sub-image is decoded into data
  bool image_stream(int xsize, int ysize, bool level0,
                    std::vector<uint32_t>* data, LMeta* meta, int* coded_w) {
    int tx = xsize;
    if (level0)
      while (br.read(1))
        if (!read_transform(&tx, ysize)) return false;
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) return false;
    }
    LMeta local;
    LMeta& m = level0 ? *meta : local;
    if (!read_huffman_codes(tx, ysize, cache_bits, level0, &m)) return false;
    m.cache_bits = cache_bits;
    m.huff_xsize = subsample(tx, m.huff_bits);
    if (level0) {
      *coded_w = tx;
      return true;
    }
    data->assign((size_t)tx * ysize, 0);
    return decode_image_data(data->data(), tx, ysize, m) && !br.eos;
  }

  // DecodeImageData: false where libwebp's fails (an LZ77 copy out of the
  // image, a bad code, the stream read past its end)
  bool decode_image_data(uint32_t* data, int w, int h, const LMeta& m) {
    const int64_t total = (int64_t)w * h;
    const int cache_size = m.cache_bits > 0 ? 1 << m.cache_bits : 0;
    std::vector<uint32_t> cache(cache_size, 0);
    const int cache_shift = 32 - m.cache_bits;
    auto insert = [&](uint32_t argb) {
      if (cache_size) cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
    };
    int64_t pos = 0;
    int col = 0, row = 0;
    while (pos < total) {
      const HTreeGroup& g = group(m, col, row);
      br.fill();
      const int code = g.codes[GREEN].read(br);
      if (br.end_of_stream()) break;
      if (code < kLiteral) {
        const int red = g.codes[RED].read(br);
        br.fill();
        const int blue = g.codes[BLUE].read(br);
        const int alpha = g.codes[ALPHA].read(br);
        if (br.end_of_stream()) break;
        data[pos] = (uint32_t)alpha << 24 | red << 16 | code << 8 | blue;
        insert(data[pos]);
        ++pos;
        if (++col >= w) {
          col = 0;
          ++row;
        }
      } else if (code < kLiteral + kLengthCodes) {
        const int length = copy_distance(code - kLiteral);
        const int dist_symbol = g.codes[DIST].read(br);
        br.fill();
        const int dist = plane_code_to_distance(w, copy_distance(dist_symbol));
        if (br.end_of_stream()) break;
        if (pos < dist || total - pos < length) return false;
        for (int i = 0; i < length; ++i, ++pos) {
          data[pos] = data[pos - dist];
          insert(data[pos]);
        }
        col += length;
        while (col >= w) {
          col -= w;
          ++row;
        }
      } else if (code < kLiteral + kLengthCodes + cache_size) {
        data[pos] = cache[code - kLiteral - kLengthCodes];
        insert(data[pos]);
        ++pos;
        if (++col >= w) {
          col = 0;
          ++row;
        }
      } else {
        return false;
      }
    }
    br.eos = br.end_of_stream();
    return !br.eos;
  }

  // DecodeAlphaData, the 8-bit path of alpha coded through a palette alone:
  // green only, and the end of the stream is an error only before the last
  // pixel
  bool decode_alpha_data(uint32_t* data, int w, int h, const LMeta& m) {
    const int64_t total = (int64_t)w * h;
    int64_t pos = 0;
    int col = 0, row = 0;
    while (!br.eos && pos < total) {
      const HTreeGroup& g = group(m, col, row);
      br.fill();
      const int code = g.codes[GREEN].read(br);
      if (code < kLiteral) {
        data[pos++] = (uint32_t)code << 8;
        if (++col >= w) {
          col = 0;
          ++row;
        }
      } else if (code < kLiteral + kLengthCodes) {
        const int length = copy_distance(code - kLiteral);
        const int dist_symbol = g.codes[DIST].read(br);
        br.fill();
        const int dist = plane_code_to_distance(w, copy_distance(dist_symbol));
        if (!(pos >= dist && total - pos >= length)) return false;
        for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
        col += length;
        while (col >= w) {
          col -= w;
          ++row;
        }
      } else {
        return false;
      }
      br.eos = br.end_of_stream();
    }
    br.eos = br.end_of_stream();
    return !(br.eos && pos < total);
  }

  // the inverse transforms, last read first: the coded image becomes the
  // ARGB image (colour indexing widens it)
  void inverse_transforms(std::vector<uint32_t>* pixels) {
    for (int n = num_transforms - 1; n >= 0; --n) {
      const LTransform& t = transforms[n];
      std::vector<uint32_t>& p = *pixels;
      switch (t.type) {
        case 2:                                       // subtract green
          for (uint32_t& a : p) {
            const uint32_t g = (a >> 8) & 0xff;
            a = (a & 0xff00ff00u) | (((a & 0x00ff00ffu) + (g << 16 | g)) &
                                     0x00ff00ffu);
          }
          break;
        case 0:
          predictor_inverse(t, p.data());
          break;
        case 1:
          cross_color_inverse(t, p.data());
          break;
        case 3:
          *pixels = color_index_inverse(t, p);
          break;
      }
    }
  }

 private:
  unsigned seen_ = 0;

  static const HTreeGroup& group(const LMeta& m, int col, int row) {
    if (m.huff_bits == 0) return m.groups[0];
    return m.groups[m.huff_image[(size_t)m.huff_xsize * (row >> m.huff_bits) +
                                 (col >> m.huff_bits)]];
  }

  int copy_distance(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + br.read(extra) + 1;
  }

  static int plane_code_to_distance(int xsize, int plane_code) {
    if (plane_code > 120) return plane_code - 120;
    const int dist_code = kCodeToPlane[plane_code - 1];
    const int yoffset = dist_code >> 4, xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
  }

  bool read_transform(int* xsize, int ysize) {
    LTransform& t = transforms[num_transforms];
    const int type = br.read(2);
    if (seen_ & (1u << type)) return false;
    seen_ |= 1u << type;
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    ++num_transforms;
    switch (type) {
      case 0:
      case 1:
        t.bits = br.read(3) + 2;
        return image_stream(subsample(t.xsize, t.bits),
                            subsample(t.ysize, t.bits), false, &t.data,
                            nullptr, nullptr);
      case 3: {
        const int num_colors = br.read(8) + 1;
        const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                         : num_colors > 2 ? 2 : 3;
        *xsize = subsample(t.xsize, bits);
        t.bits = bits;
        if (!image_stream(num_colors, 1, false, &t.data, nullptr, nullptr))
          return false;
        // ExpandColorMap: deltas summed a byte at a time, then zeros
        std::vector<uint32_t> map(1u << (8 >> bits), 0);
        std::vector<uint8_t> bytes(4 * map.size(), 0);
        memcpy(bytes.data(), t.data.data(), 4);
        const uint8_t* in = (const uint8_t*)t.data.data();
        for (int i = 4; i < 4 * num_colors; ++i)
          bytes[i] = (uint8_t)(in[i] + bytes[i - 4]);
        memcpy(map.data(), bytes.data(), 4 * map.size());
        t.data.swap(map);
        return true;
      }
      default:
        return true;
    }
  }

  bool read_code_lengths(const int* cl_lengths, int num_symbols,
                         int* lengths) {
    PrefixCode table;
    if (!table.build(cl_lengths, 19)) return false;
    int max_symbol;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(length_nbits);
      if (max_symbol > num_symbols) return false;
    } else {
      max_symbol = num_symbols;
    }
    int symbol = 0, prev_len = 8;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      br.fill();
      const int code_len = table.read(br);
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len != 0) prev_len = code_len;
      } else {
        const int slot = code_len - 16;
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat = br.read(kExtra[slot]) + kOffset[slot];
        if (symbol + repeat > num_symbols) return false;
        const int length = code_len == 16 ? prev_len : 0;
        while (repeat-- > 0) lengths[symbol++] = length;
      }
    }
    return true;
  }

  bool read_huffman_code(int alphabet_size, int* lengths, PrefixCode* code) {
    memset(lengths, 0, alphabet_size * sizeof(*lengths));
    bool ok;
    if (br.read(1)) {                                  // simple code
      const int num_symbols = br.read(1) + 1;
      const int first_len_code = br.read(1);
      lengths[br.read(first_len_code == 0 ? 1 : 8)] = 1;
      if (num_symbols == 2) lengths[br.read(8)] = 1;
      ok = true;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i)
        cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
      ok = read_code_lengths(cl_lengths, alphabet_size, lengths);
    }
    ok = ok && !br.eos;
    return ok && code->build(lengths, alphabet_size);
  }

  bool read_huffman_codes(int xsize, int ysize, int cache_bits,
                          bool allow_recursion, LMeta* m) {
    int num_groups_max = 1;
    m->huff_bits = 0;
    if (allow_recursion && br.read(1)) {
      const int bits = 2 + br.read(3);
      std::vector<uint32_t> image;
      if (!image_stream(subsample(xsize, bits), subsample(ysize, bits), false,
                        &image, nullptr, nullptr))
        return false;
      m->huff_bits = bits;
      for (uint32_t& g : image) {
        g = (g >> 8) & 0xffff;
        if ((int)g >= num_groups_max) num_groups_max = g + 1;
      }
      // more groups than 1000 or than pixels: libwebp remaps the used ones
      // and checks, but does not keep, the others
      if (num_groups_max > 1000 || num_groups_max > (int64_t)xsize * ysize) {
        m->used.assign(num_groups_max, 0);
        for (uint32_t g : image) m->used[g] = 1;
      }
      m->huff_image.swap(image);
    }
    if (br.eos) return false;
    // every group up to the largest index is read and checked, used or not
    const int max_alphabet = kAlphabetSize[0] + (cache_bits > 0 ? 1 << cache_bits
                                                                 : 0);
    std::vector<int> lengths(std::max(max_alphabet, 256) + 1, 0);
    m->groups.assign(num_groups_max, HTreeGroup());
    for (int i = 0; i < num_groups_max; ++i) {
      for (int j = 0; j < 5; ++j) {
        int alphabet = kAlphabetSize[j];
        if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
        if (!read_huffman_code(alphabet, lengths.data(),
                               &m->groups[i].codes[j]))
          return false;
      }
    }
    return true;
  }

  static uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
  static uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static int clip255(uint32_t a) { return a < 256 ? (int)a : (int)(~a >> 24); }
  static int sub3(int a, int b, int c) {
    return std::abs(b - c) - std::abs(a - c);
  }
  static uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
    const int pa_minus_pb =
        sub3(a >> 24, b >> 24, c >> 24) +
        sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
        sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
        sub3(a & 0xff, b & 0xff, c & 0xff);
    return pa_minus_pb <= 0 ? a : b;
  }
  static uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
      out |= (uint32_t)clip255(((c0 >> s) & 0xff) + ((c1 >> s) & 0xff) -
                               ((c2 >> s) & 0xff))
             << s;
    return out;
  }
  static uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    const uint32_t ave = average2(c0, c1);
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
      out |= (uint32_t)clip255((uint32_t)(a + (a - b) / 2)) << s;
    }
    return out;
  }

  static uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
    switch (mode) {
      case 1: return left;
      case 2: return top[0];
      case 3: return top[1];
      case 4: return top[-1];
      case 5: return average2(average2(left, top[1]), top[0]);
      case 6: return average2(left, top[-1]);
      case 7: return average2(left, top[0]);
      case 8: return average2(top[-1], top[0]);
      case 9: return average2(top[0], top[1]);
      case 10:
        return average2(average2(left, top[-1]), average2(top[0], top[1]));
      case 11: return select(top[0], left, top[-1]);
      case 12: return add_sub_full(left, top[0], top[-1]);
      case 13: return add_sub_half(left, top[0], top[-1]);
      default: return 0xff000000u;              // 0, and 14, 15
    }
  }

  static void predictor_inverse(const LTransform& t, uint32_t* p) {
    const int w = t.xsize, h = t.ysize;
    p[0] = add_pixels(p[0], 0xff000000u);
    for (int x = 1; x < w; ++x) p[x] = add_pixels(p[x], p[x - 1]);
    const int tiles_per_row = subsample(w, t.bits);
    for (int y = 1; y < h; ++y) {
      uint32_t* out = p + (size_t)y * w;
      const uint32_t* top = out - w;
      const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) *
                                                  tiles_per_row;
      out[0] = add_pixels(out[0], top[0]);
      for (int x = 1; x < w; ++x) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        out[x] = add_pixels(out[x], predict(mode, out[x - 1], top + x));
      }
    }
  }

  static int delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

  static void cross_color_inverse(const LTransform& t, uint32_t* p) {
    const int w = t.xsize, h = t.ysize;
    const int tiles_per_row = subsample(w, t.bits);
    for (int y = 0; y < h; ++y) {
      const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) *
                                                  tiles_per_row;
      for (int x = 0; x < w; ++x) {
        const uint32_t code = codes[x >> t.bits];
        const int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)(code >> 8),
                     r2b = (int8_t)(code >> 16);
        uint32_t& argb = p[(size_t)y * w + x];
        const int8_t green = (int8_t)(argb >> 8);
        int new_red = (argb >> 16) & 0xff, new_blue = argb & 0xff;
        new_red += delta(g2r, green);
        new_red &= 0xff;
        new_blue += delta(g2b, green);
        new_blue += delta(r2b, (int8_t)new_red);
        new_blue &= 0xff;
        argb = (argb & 0xff00ff00u) | new_red << 16 | new_blue;
      }
    }
  }

  static std::vector<uint32_t> color_index_inverse(
      const LTransform& t, const std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    const int packed_w = subsample(w, t.bits);
    const int bits_per_pixel = 8 >> t.bits;
    const int count_mask = (1 << t.bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    std::vector<uint32_t> out((size_t)w * h);
    for (int y = 0; y < h; ++y) {
      const uint32_t* src = in.data() + (size_t)y * packed_w;
      uint32_t* dst = out.data() + (size_t)y * w;
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & bit_mask];
        packed >>= bits_per_pixel;
      }
    }
    return out;
  }
};

// a VP8L stream with its header: ARGB, or false where libwebp fails
bool decode_vp8l(const uint8_t* data, size_t size, int* w, int* h,
                 std::vector<uint32_t>* argb) {
  VP8LDecoder dec;
  dec.br.init(data, size);
  if (dec.br.read(8) != 0x2f) return false;
  *w = (int)dec.br.read(14) + 1;
  *h = (int)dec.br.read(14) + 1;
  dec.br.read(1);
  if (dec.br.read(3) != 0 || dec.br.eos) return false;
  LMeta meta;
  int coded_w = 0;
  if (!dec.image_stream(*w, *h, true, nullptr, &meta, &coded_w)) return false;
  argb->assign((size_t)coded_w * *h, 0);
  if (!dec.decode_image_data(argb->data(), coded_w, *h, meta)) return false;
  dec.inverse_transforms(argb);
  return true;
}

// -- ALPH (alpha_dec.c, dsp/filters.c) ---------------------------------------

void unfilter(int filter, const uint8_t* prev, uint8_t* row, int width) {
  if (filter == 0) return;
  if (filter == 1 || prev == nullptr) {                 // horizontal
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) pred = row[i] = (uint8_t)(pred + row[i]);
  } else if (filter == 2) {                             // vertical
    for (int i = 0; i < width; ++i) row[i] = (uint8_t)(prev[i] + row[i]);
  } else {                                              // gradient
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      left = (uint8_t)(row[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
      top_left = top;
      row[i] = left;
    }
  }
}

// the alpha plane of a w x h VP8 frame, or false where libwebp fails it
bool decode_alpha(const uint8_t* data, size_t size, int w, int h,
                  std::vector<uint8_t>* alpha) {
  if (size <= 1) return false;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre_processing = (data[0] >> 4) & 3, reserved = data[0] >> 6;
  if (method > 1 || pre_processing > 1 || reserved != 0) return false;
  const size_t n = (size_t)w * h;
  alpha->assign(n, 0);
  if (method == 0) {
    if (size - 1 < n) return false;
    memcpy(alpha->data(), data + 1, n);
  } else {
    VP8LDecoder dec;
    dec.br.init(data + 1, size - 1);
    LMeta meta;
    int coded_w = 0;
    if (!dec.image_stream(w, h, true, nullptr, &meta, &coded_w)) return false;
    bool trivial = meta.cache_bits == 0;
    for (size_t i = 0; i < meta.groups.size(); ++i)
      if (meta.used.empty() || meta.used[i])
        for (int j : {RED, BLUE, ALPHA})
          trivial &= meta.groups[i].codes[j].max_len == 0;
    std::vector<uint32_t> argb((size_t)coded_w * h, 0);
    const bool eight_bit = dec.num_transforms == 1 &&
                           dec.transforms[0].type == 3 && trivial;
    if (!(eight_bit ? dec.decode_alpha_data(argb.data(), coded_w, h, meta)
                    : dec.decode_image_data(argb.data(), coded_w, h, meta)))
      return false;
    dec.inverse_transforms(&argb);
    for (size_t i = 0; i < n; ++i) (*alpha)[i] = (argb[i] >> 8) & 0xff;
  }
  for (int y = 0; y < h; ++y)
    unfilter(filter, y ? &(*alpha)[(size_t)(y - 1) * w] : nullptr,
             &(*alpha)[(size_t)y * w], w);
  return true;
}

// -- the first frame, into the canvas (anim_decode.c, WebPDecode) ------------

// channels 3: RGB; 4: RGBA, not premultiplied (alpha 255 without ALPH)
bool decode_frame(const uint8_t* frag, size_t size, uint8_t* out,
                  int64_t stride, int channels) {
  Headers features, hd;
  if (parse_headers(frag, size, false, &features) != kOk) return false;
  if (parse_headers(frag, size, true, &hd) != kOk) return false;
  if (hd.lossless) {
    int w, h;
    std::vector<uint32_t> argb;
    if (!decode_vp8l(hd.payload, hd.payload_size, &w, &h, &argb)) return false;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t a = argb[(size_t)y * w + x];
        uint8_t* p = out + y * stride + channels * x;
        p[0] = (a >> 16) & 0xff;
        p[1] = (a >> 8) & 0xff;
        p[2] = a & 0xff;
        if (channels == 4) p[3] = a >> 24;
      }
    return true;
  }
  VP8Decoder vp8;
  if (!vp8.decode(hd.payload, hd.payload_size)) return false;
  std::vector<uint8_t> alpha;
  if (hd.alpha != nullptr &&
      !decode_alpha(hd.alpha, hd.alpha_size, vp8.width, vp8.height, &alpha))
    return false;
  yuv_to_rgb_frame(vp8, out, stride, channels);
  if (channels == 4)
    for (int y = 0; y < vp8.height; ++y)
      for (int x = 0; x < vp8.width; ++x)
        out[y * stride + 4 * x + 3] =
            alpha.empty() ? 255 : alpha[(size_t)y * vp8.width + x];
  return true;
}

}  // namespace

extern "C" {

// (h, w) of the canvas as Pillow's open reports it; nonzero where it fails
int webp_dims(const uint8_t* data, int64_t len, int* h, int* w) {
  Demux dmux;
  if (len < 16 || !open_webp(data, (size_t)len, &dmux)) return 1;
  *h = (int)dmux.canvas_h;
  *w = (int)dmux.canvas_w;
  return 0;
}

}  // extern "C"

namespace {

int decode_canvas(const uint8_t* data, int64_t len, uint8_t* out, int h,
                  int w, int channels) {
  Demux dmux;
  if (len < 16 || !open_webp(data, (size_t)len, &dmux)) return 1;
  if (dmux.canvas_h != h || dmux.canvas_w != w) return 1;
  memset(out, 0, (size_t)h * w * channels);
  const Frame& f = dmux.frames[0];
  size_t start = f.image.offset, size = f.image.size;
  if (f.alpha.size > 0) {
    const size_t inter = f.image.offset > 0
                             ? f.image.offset - (f.alpha.offset + f.alpha.size)
                             : 0;
    start = f.alpha.offset;
    size += f.alpha.size + inter;
  }
  const int64_t stride = (int64_t)w * channels;
  return decode_frame(data + start, size,
                      out + f.y * stride + f.x * channels, stride, channels)
             ? 0
             : 1;
}

}  // namespace

extern "C" {

// The first frame on its zeroed canvas as (h, w, 3) RGB into out; nonzero
// where Pillow's open or load fails
int decode_webp_u8(const uint8_t* data, int64_t len, uint8_t* out, int h,
                   int w) {
  return decode_canvas(data, len, out, h, w, 3);
}

// The same as (h, w, 4) RGBA, as Pillow's convert("RGBA") of a file with
// alpha gives it (alpha decoded, not premultiplied; the canvas transparent)
int decode_webp_rgba_u8(const uint8_t* data, int64_t len, uint8_t* out, int h,
                        int w) {
  return decode_canvas(data, len, out, h, w, 4);
}

}  // extern "C"
