// JPEG decoder of the yolov5m_tpu_torch host library: baseline, extended
// sequential, progressive and lossless JPEG, Huffman or arithmetic coded,
// 8-bit samples (and 12-bit in mode 2), one, three or four components (any
// count up to ten in mode 2), decoded to interleaved RGB uint8 (mode 2: the
// TIFF's samples), in one of three modes.
//
// Mode 0 computes what libjpeg-turbo 2.1's default decompression of a
// memory buffer computes (JDCT_ISLOW, fancy upsampling, out_color_space
// JCS_RGB, no scaling, block smoothing on), bit for bit, so that a machine
// without libjpeg decodes a file to the pixels the JAX package's libjpeg
// call gives (libjpeg-turbo 2.1, its SIMD build, on x86-64). Mode 1
// computes Pillow 12.1.0's Image.open(...).convert("RGB") over the
// libjpeg-turbo 3.1.3 it bundles, which the JAX package calls where its
// libjpeg refuses a file (and detect --img for every file): mode 0's
// decode, and also four-component files (CMYK and YCCK, see cmyk_row),
// 8-bit lossless frames (SOF3, see decode_lossless_scan), 3.1's block
// smoothing window (see smooth_idct), and a file cut before its image is
// whole refused (see byte()); under the jpegmode "CMYK" that BLP1's
// JPEG sets (the C entry points' mode 3), a YCCK frame's components are
// read as CMYK, unconverted. Written from ITU T.81 and libjpeg's
// documented arithmetic:
//
//  * Input: the buffer followed by an endless run of FF D9 pairs, the fake
//    EOI a memory source supplies past its end. Markers are read, and
//    refused, as libjpeg's marker reader reads them: fill bytes FF..FF,
//    garbage before a marker skipped, APP0 (JFIF) and APP14 (Adobe)
//    examined, every other APPn and COM skipped by their length.
//  * Huffman data: a 64-bit bit buffer filled to 57 bits; FF 00 is a data
//    byte FF; at a marker the bits run out and zero bits are fed. The MCU
//    that consumes the first such bit is decoded from them, and the rest of
//    its restart interval is left all zero (pixels 128), as libjpeg does.
//    A restart marker out of order is resynchronised as libjpeg does.
//  * Arithmetic data (T.81 Annex D, F.1.4.4, G.1.3; DAC conditioning,
//    default L 0, U 1, Kx 5): a byte at a time; at a marker zero bytes are
//    fed and the decoding goes on from them. A magnitude or a run that
//    overflows ends the decoding of its restart interval, as in libjpeg.
//  * Coefficients of every scan go into one whole-image buffer a
//    component; the progressive decoders (DC and AC, first and refine,
//    EOB runs) refine it in place, and keep the precision each scan left
//    a coefficient at (libjpeg's coef_bits).
//  * Block smoothing of a progressive file (libjpeg-turbo's 5x5 window,
//    see smooth_idct): coefficients 1-9 not yet known exactly are
//    estimated from the DC values around, as libjpeg does at the end of
//    input, including for a complete file whose AC bands stop short of
//    Al 0.
//  * IDCT: the islow integer IDCT (CONST_BITS 13, PASS1_BITS 2) in the
//    16-bit lanes of libjpeg-turbo's SIMD version, whose outputs saturate
//    where the C version's range-limit table wraps (see idct_islow).
//  * Upsampling per component: a copy at full size; the h2v1 and h2v2
//    triangle filters where the downsampled width is above 2, else
//    replication; the h1v2 triangle filter; replication for any other
//    integral ratio, and for every ratio of a lossless frame. Rows above
//    the first and below the last repeat them.
//  * YCbCr -> RGB in libjpeg's 16-bit fixed point; grayscale copied to
//    three channels; Adobe RGB copied.
//
// Refused (nonzero return), where libjpeg-turbo refuses them too:
// hierarchical frames and arithmetic lossless ones (SOF11), precision
// other than 8 (12 is read in mode 2 only: Pillow's JPEG plugin refuses
// it), component counts other than 1 and 3 (and 4 in mode 1),
// fractional sampling ratios; in mode 0 lossless frames; in mode 1 a
// lossless frame whose colour space needs converting (YCbCr, YCCK) or a
// component no scan sent. Nothing that libjpeg-turbo decodes is refused.
//
// Mode 2 is libtiff 4.7.1's JPEG codec (tif_jpeg.c) over the same
// libjpeg-turbo 3.1.3, as Pillow's TIFF decoder drives it: a JPEGTables
// stream read first, then each strip's or tile's abbreviated stream, the
// Huffman and quantization tables carried from one stream to the next as
// libjpeg keeps them; the colour space taken from the TIFF (YCbCr -> RGB
// where JPEGCOLORMODE_RGB is set, else JCS_UNKNOWN: the components as
// stored), JFIF and Adobe markers ignored; JPEGPreDecode's checks; the
// data past the end of a chunk a fake EOI as libtiff's source supplies it
// (see tiff_jpeg_chunks). At precision 12 (libtiff opens such JPEG as grey
// only) the frame goes through libjpeg-turbo's 12-bit decompressor: the
// same entropy decoding, 16-bit quantization tables dequantized unsigned,
// jidctint.c's IDCT in C (see idct_islow12), and libtiff's JPEGDecode
// packs each pair of samples in three bytes (see output12). The same
// decoder also runs under libtiff's old-style JPEG codec (see OJpeg).
//
// Pure C++ on one thread, no global state: callers decode several buffers
// at once from threads without the GIL.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

namespace {

// zigzag position -> natural (row-major) position; 16 extra entries so
// that a corrupt run past the band's end writes position 63
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// T.81 Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) packed
// as libjpeg's arithmetic decoder reads it: Qe << 16 | NMPS << 8 | SWITCH
// << 7 | NLPS. Entry 113 is the fixed estimate of one half (T.851) that
// signs and refinement bits are coded with.
constexpr uint32_t qe(uint32_t q, uint32_t nlps, uint32_t nmps, uint32_t sw) {
  return q << 16 | nmps << 8 | sw << 7 | nlps;
}
constexpr uint32_t kQe[114] = {
    qe(0x5a1d, 1, 1, 1),     qe(0x2586, 14, 2, 0),    qe(0x1114, 16, 3, 0),
    qe(0x080b, 18, 4, 0),    qe(0x03d8, 20, 5, 0),    qe(0x01da, 23, 6, 0),
    qe(0x00e5, 25, 7, 0),    qe(0x006f, 28, 8, 0),    qe(0x0036, 30, 9, 0),
    qe(0x001a, 33, 10, 0),   qe(0x000d, 35, 11, 0),   qe(0x0006, 9, 12, 0),
    qe(0x0003, 10, 13, 0),   qe(0x0001, 12, 13, 0),   qe(0x5a7f, 15, 15, 1),
    qe(0x3f25, 36, 16, 0),   qe(0x2cf2, 38, 17, 0),   qe(0x207c, 39, 18, 0),
    qe(0x17b9, 40, 19, 0),   qe(0x1182, 42, 20, 0),   qe(0x0cef, 43, 21, 0),
    qe(0x09a1, 45, 22, 0),   qe(0x072f, 46, 23, 0),   qe(0x055c, 48, 24, 0),
    qe(0x0406, 49, 25, 0),   qe(0x0303, 51, 26, 0),   qe(0x0240, 52, 27, 0),
    qe(0x01b1, 54, 28, 0),   qe(0x0144, 56, 29, 0),   qe(0x00f5, 57, 30, 0),
    qe(0x00b7, 59, 31, 0),   qe(0x008a, 60, 32, 0),   qe(0x0068, 62, 33, 0),
    qe(0x004e, 63, 34, 0),   qe(0x003b, 32, 35, 0),   qe(0x002c, 33, 9, 0),
    qe(0x5ae1, 37, 37, 1),   qe(0x484c, 64, 38, 0),   qe(0x3a0d, 65, 39, 0),
    qe(0x2ef1, 67, 40, 0),   qe(0x261f, 68, 41, 0),   qe(0x1f33, 69, 42, 0),
    qe(0x19a8, 70, 43, 0),   qe(0x1518, 72, 44, 0),   qe(0x1177, 73, 45, 0),
    qe(0x0e74, 74, 46, 0),   qe(0x0bfb, 75, 47, 0),   qe(0x09f8, 77, 48, 0),
    qe(0x0861, 78, 49, 0),   qe(0x0706, 79, 50, 0),   qe(0x05cd, 48, 51, 0),
    qe(0x04de, 50, 52, 0),   qe(0x040f, 50, 53, 0),   qe(0x0363, 51, 54, 0),
    qe(0x02d4, 52, 55, 0),   qe(0x025c, 53, 56, 0),   qe(0x01f8, 54, 57, 0),
    qe(0x01a4, 55, 58, 0),   qe(0x0160, 56, 59, 0),   qe(0x0125, 57, 60, 0),
    qe(0x00f6, 58, 61, 0),   qe(0x00cb, 59, 62, 0),   qe(0x00ab, 61, 63, 0),
    qe(0x008f, 61, 32, 0),   qe(0x5b12, 65, 65, 1),   qe(0x4d04, 80, 66, 0),
    qe(0x412c, 81, 67, 0),   qe(0x37d8, 82, 68, 0),   qe(0x2fe8, 83, 69, 0),
    qe(0x293c, 84, 70, 0),   qe(0x2379, 86, 71, 0),   qe(0x1edf, 87, 72, 0),
    qe(0x1aa9, 87, 73, 0),   qe(0x174e, 72, 74, 0),   qe(0x1424, 72, 75, 0),
    qe(0x119c, 74, 76, 0),   qe(0x0f6b, 74, 77, 0),   qe(0x0d51, 75, 78, 0),
    qe(0x0bb6, 77, 79, 0),   qe(0x0a40, 77, 48, 0),   qe(0x5832, 80, 81, 1),
    qe(0x4d1c, 88, 82, 0),   qe(0x438e, 89, 83, 0),   qe(0x3bdd, 90, 84, 0),
    qe(0x34ee, 91, 85, 0),   qe(0x2eae, 92, 86, 0),   qe(0x299a, 93, 87, 0),
    qe(0x2516, 86, 71, 0),   qe(0x5570, 88, 89, 1),   qe(0x4ca9, 95, 90, 0),
    qe(0x44d9, 96, 91, 0),   qe(0x3e22, 97, 92, 0),   qe(0x3824, 99, 93, 0),
    qe(0x32b4, 99, 94, 0),   qe(0x2e17, 93, 86, 0),   qe(0x56a8, 95, 96, 1),
    qe(0x4f46, 101, 97, 0),  qe(0x47e5, 102, 98, 0),  qe(0x41cf, 103, 99, 0),
    qe(0x3c3d, 104, 100, 0), qe(0x375e, 99, 93, 0),   qe(0x5231, 105, 102, 0),
    qe(0x4c0f, 106, 103, 0), qe(0x4639, 107, 104, 0), qe(0x415e, 103, 99, 0),
    qe(0x5627, 105, 106, 1), qe(0x50e7, 108, 107, 0), qe(0x4b85, 109, 103, 0),
    qe(0x5597, 110, 109, 0), qe(0x504f, 111, 107, 0), qe(0x5a10, 110, 111, 1),
    qe(0x5522, 112, 109, 0), qe(0x59eb, 112, 111, 1), qe(0x5a1d, 113, 113, 0)};
constexpr int kFixedBin = 113;

// libjpeg-turbo's block smoothing (jdcoefct.c): estimates of zigzag
// coefficients 0-9 (natural positions kSmoothPos) from the quantized DC
// values of a 5x5 window of blocks, the block in its middle. Each row of
// weights runs over the window's rows from two above to two below, each
// left to right. kSmoothDc holds the kernels used while no AC of the
// component is known (DC estimated too), kSmoothAc those used after
// (zigzag 1-5 only).
constexpr int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
constexpr int16_t kSmoothDc[10][25] = {
    {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8,
     -6, 6, 42, 6, -6, -2, -6, -8, -6, -2},
    {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3,
     -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
    {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0,
     1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
    {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0,
     0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
    {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0,
     0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
    {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1,
     0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0,
     0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0,
     0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0,
     0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0,
     0, -1, -2, -1, 0, 0, 0, 0, 0, 0}};
constexpr int16_t kSmoothAc[6][25] = {
    {},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0,
     0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
    {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0,
     0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
    {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0,
     1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};

// markers
constexpr int kSOF0 = 0xC0, kSOF1 = 0xC1, kSOF2 = 0xC2, kSOF3 = 0xC3,
              kSOF9 = 0xC9,
              kSOF10 = 0xCA, kDHT = 0xC4, kDAC = 0xCC, kRST0 = 0xD0,
              kRST7 = 0xD7, kSOI = 0xD8, kEOI = 0xD9, kSOS = 0xDA,
              kDQT = 0xDB, kDNL = 0xDC, kDRI = 0xDD, kAPP0 = 0xE0,
              kAPP14 = 0xEE, kAPP15 = 0xEF, kCOM = 0xFE, kTEM = 0x01;

constexpr int kMaxDimension = 65500;   // JPEG_MAX_DIMENSION
constexpr int kMaxComponents = 10;
constexpr int kMaxBlocksInMCU = 10;
constexpr int kFillBits = 57;          // a 64-bit buffer less 7

struct Refused {};                     // what libjpeg would stop on

[[noreturn]] void refuse() { throw Refused(); }

// the standard tables of T.81 K.3, which libjpeg-turbo puts in slots 0
// and 1 of a sequential file that defines none there (Motion JPEG)
constexpr uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
constexpr uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kStdAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// YCbCr -> RGB in libjpeg's 16-bit fixed point: FIX(x) = x * 2^16
// rounded; R and B add FIX(1.402) Cr and FIX(1.772) Cb rounded, G adds
// -FIX(0.34414) Cb - FIX(0.71414) Cr rounded once (libjpeg keeps these
// products in tables; computed here, the loop vectorises)
constexpr int32_t fix16(double x) {
  return static_cast<int32_t>(x * 65536 + 0.5);
}
constexpr int32_t kCrR = fix16(1.40200), kCbB = fix16(1.77200),
                  kCrG = fix16(0.71414), kCbG = fix16(0.34414),
                  kHalf16 = 1 << 15;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(std::min(std::max(v, 0), 255));
}

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

// a Huffman table ready to decode: the canonical code's largest value a
// length, the offset from a code to its symbol's index, and an 8-bit
// lookahead (length << 8 | symbol, length 9 for codes longer than 8)
struct HuffDecoder {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t lookup[256];
  uint8_t vals[256];
};

// dc: a DC table (symbols up to 15), or with lossless a lossless one (up
// to 16, the difference 32768)
void build_decoder(const HuffSpec& spec, bool dc, HuffDecoder* d,
                   bool lossless = false) {
  if (!spec.defined) refuse();
  int sizes[257];
  uint32_t codes[257];
  int n = 0;
  for (int len = 1; len <= 16; ++len) {
    if (n + spec.bits[len] > 256) refuse();
    for (int i = 0; i < spec.bits[len]; ++i) sizes[n++] = len;
  }
  sizes[n] = 0;
  uint32_t code = 0;
  int len = sizes[0];
  for (int p = 0; sizes[p];) {
    while (sizes[p] == len) codes[p++] = code++;
    // no code may be all ones
    if (code >= (uint32_t{1} << len)) refuse();
    code <<= 1;
    ++len;
  }
  for (int l = 1, p = 0; l <= 16; ++l) {
    if (spec.bits[l]) {
      d->valoffset[l] = p - static_cast<int32_t>(codes[p]);
      p += spec.bits[l];
      d->maxcode[l] = static_cast<int32_t>(codes[p - 1]);
    } else {
      d->maxcode[l] = -1;
    }
  }
  d->valoffset[17] = 0;
  d->maxcode[17] = 0xFFFFF;   // ends the bit-by-bit search
  for (int i = 0; i < 256; ++i) d->lookup[i] = 9 << 8;
  for (int l = 1, p = 0; l <= 16; ++l) {
    for (int i = 0; i < spec.bits[l]; ++i, ++p) {
      if (l > 8) continue;
      const int first = static_cast<int>(codes[p]) << (8 - l);
      for (int k = 0; k < (1 << (8 - l)); ++k)
        d->lookup[first + k] = static_cast<uint16_t>(l << 8 | spec.vals[p]);
    }
  }
  std::memcpy(d->vals, spec.vals, sizeof(d->vals));
  if (dc) {
    for (int i = 0; i < n; ++i)
      if (spec.vals[i] > (lossless ? 16 : 15)) refuse();
  }
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + static_cast<int>(~0u << s) + 1 : v;
}

enum class Upsample { kFull, kH2V1, kH2V1Box, kH1V2, kH2V2, kH2V2Box, kInt };

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;                 // table selectors of the latest scan
  int width_in_blocks = 0, height_in_blocks = 0;
  int dw = 0, dh = 0;                 // downsampled size in samples
  int bw = 0, bh = 0;                 // coefficient blocks, padded to h, v
  bool latched = false;
  int16_t quant[64] = {};             // natural order, latched at 1st scan
  int32_t quant32[64] = {};           // the same, unsigned (12-bit IDCT)
  // progressive: the Al of the latest scan that sent each zigzag
  // position, -1 before any (libjpeg's coef_bits), and the same before
  // this component's latest scan; what smoothing reads of both, latched
  // as the input ends ([0] now, [1] before the latest scan)
  int bits[64] = {}, prev_bits[64] = {};
  int latch[2][10] = {};
  std::vector<int16_t> coef;          // bh x bw blocks of 64 (multi-scan)
  Upsample up = Upsample::kFull;
  int hx = 1, vx = 1;                 // replication factors (kInt)
  size_t stride = 0;                  // bw * 8
  std::unique_ptr<uint8_t[]> plane;   // (bh * 8) x stride samples
  std::unique_ptr<uint16_t[]> plane16;  // the same at precision 12
  int16_t* block(int row, int col) {
    return coef.data() + (static_cast<size_t>(row) * bw + col) * 64;
  }
  // where block (row, col) goes through the IDCT
  uint8_t* samples(int row, int col) {
    return plane.get() + stride * row * 8 + col * 8;
  }
  uint16_t* samples16(int row, int col) {
    return plane16.get() + stride * row * 8 + col * 8;
  }
};

// What a decode computes: libjpeg-turbo 2.1's default decode of a memory
// buffer, Pillow 12.1.0's Image.open(...).convert("RGB") over the
// libjpeg-turbo 3.1.3 it bundles, or libtiff 4.7.1's JPEG codec over it
// kPillowCmyk: kPillow under a jpegmode of "CMYK" (BLP1's JPEG): a
// four-component frame is CMYK whatever its Adobe transform says
enum class Mode { kTurbo21, kPillow, kPillowCmyk, kTiff, kOJpeg };

// the tables libjpeg keeps from one stream to the next (JPOOL_PERMANENT)
struct Tables {
  HuffSpec dc[4], ac[4];
  uint16_t quant[4][64] = {};
  bool quant_defined[4] = {};
};

class Decoder {
 public:
  Decoder(const uint8_t* buf, int64_t len, Mode mode = Mode::kTurbo21,
          Tables* shared = nullptr)
      : buf_(buf),
        len_(len),
        turbo3_(mode != Mode::kTurbo21),
        suspend_(mode == Mode::kPillow || mode == Mode::kPillowCmyk),
        cmyk_(mode == Mode::kPillowCmyk),
        tiff_(mode == Mode::kTiff || mode == Mode::kOJpeg),
        ojpeg_(mode == Mode::kOJpeg),
        t_(shared ? *shared : own_) {}

  // a JPEGTables stream: markers up to EOI (jpeg_read_header's
  // JPEG_HEADER_TABLES_ONLY); an image in it is refused ("Bogus
  // JPEGTables field")
  void read_tables() {
    if (read_markers() != kEOI) refuse();
  }

  // JPEGPreDecode's checks of a strip or tile against the TIFF: the
  // segment's size (a smaller image is decoded, a larger one refused but
  // for the last strip of the same width), the component count, the
  // precision, component 0's sampling factors (h, v) and the others' 1x1;
  // then the colour space: YCbCr -> RGB, or the components as stored
  void tiff_checks(int seg_w, int seg_h, bool last_strip, int ncomp,
                   int bps, int h, int v, bool rgb) {
    const bool taller_last = width_ == seg_w && height_ > seg_h && last_strip;
    if (!taller_last && (width_ > seg_w || height_ > seg_h)) refuse();
    if (static_cast<int>(comps_.size()) != ncomp) refuse();
    if (precision_ != bps) refuse();
    if (comps_[0].h != h || comps_[0].v != v) refuse();
    for (size_t i = 1; i < comps_.size(); ++i)
      if (comps_[i].h != 1 || comps_[i].v != 1) refuse();
    tiff_rgb_ = rgb;
  }

  // what JPEGDecode writes of the strip: rows scanlines (at most the
  // image's height) of width * components samples, stride apart. What
  // follows a single scan is never read so as to fail: libtiff ignores a
  // failure of jpeg_finish_decompress (its CALLJPEG returns -1, true).
  void decode_tiff(uint8_t* out, int64_t stride, int rows) {
    start_decompress();
    for (;;) {
      if (lossless_) {
        decode_lossless_scan();
      } else {
        decode_scan();
      }
      if (!multiple_scans_) break;
      if (read_markers() == kEOI) break;
    }
    output(out, stride, rows);
  }

  // the markers up to the first SOS and the frame's checks: what
  // jpeg_read_header does
  void read_header() {
    if (len_ <= 0) refuse();
    if (read_markers() != kSOS) refuse();  // tables only, or no SOS
    initial_setup();
  }

  int height() const { return height_; }
  int width() const { return width_; }

  // -- libtiff's old-style JPEG codec (tif_ojpeg.c, see OJpeg) -------------
  // jpeg_read_header and jpeg_start_decompress of the stream the codec
  // writes: raw_data_out (the components at their sampled sizes), or
  // scanlines of the components as stored (JCS_UNKNOWN), upsampled.
  // fail_at_end: the source fails past its end (its fill_input_buffer
  // has no more data), else fake EOIs follow.
  void ojpeg_start(bool fail_at_end) {
    fail_past_end_ = fail_at_end;
    read_header();
    tiff_rgb_ = false;
    start_decompress();
    if (multiple_scans_ || lossless_) refuse();  // a single sequential scan
    start_scan();                 // latch_quant_tables, the Huffman tables
  }
  // the scan's MCUs, as far as the data goes: the iMCU rows decoded
  // whole before the source failed (every one where it did not)
  int ojpeg_decode() {
    try {
      decode_scan(false);
      return mcu_rows_;
    } catch (const Refused&) {
      return imcu_done_;
    }
  }
  int imcu_rows() const { return mcu_rows_; }
  int max_h() const { return max_h_; }
  int max_v() const { return max_v_; }
  // the output row whose row group needs iMCU row k decoded: libjpeg's
  // context main controller (h2v2 and h1v2 fancy upsampling) holds back
  // an iMCU row's last row group until the next iMCU row is decoded
  int ojpeg_row_needs(int y) const {
    const int rows = 8 * max_v_;
    int k = y / rows;
    bool context = false;
    for (const Component& c : comps_)
      context = context || c.up == Upsample::kH2V2 || c.up == Upsample::kH1V2;
    if (context && (y % rows) / max_v_ == 7 && k + 1 < mcu_rows_) ++k;
    return k;
  }
  // jpeg_read_scanlines' row y: the components as stored, upsampled
  void ojpeg_row(int y, uint8_t* o, uint8_t* bufs) const {
    const int n = static_cast<int>(comps_.size());
    for (int i = 0; i < n; ++i) {
      const uint8_t* r = upsample_row(
          comps_[i], y, bufs + static_cast<size_t>(i) * (width_ + 16));
      for (int x = 0; x < width_; ++x) o[n * x + i] = r[x];
    }
  }
  // jpeg_read_raw_data's iMCU row k into the sample rows of each
  // component (bufs[i], linelen[i] apart): the blocks decompress_onepass
  // writes, those of the last iMCU row below the image left as they were
  void ojpeg_raw(int k, uint8_t* const* bufs, const int64_t* linelen) const {
    for (size_t i = 0; i < comps_.size(); ++i) {
      const Component& c = comps_[i];
      const int last = c.height_in_blocks % c.v ? c.height_in_blocks % c.v
                                                : c.v;
      for (int br = 0; br < c.v; ++br) {
        if (k == mcu_rows_ - 1 && br >= last) break;
        for (int line = 0; line < 8; ++line) {
          const uint8_t* src = c.plane.get() + c.stride * ((k * c.v + br) * 8 +
                                                           line);
          std::memcpy(bufs[i] + (br * 8 + line) * linelen[i], src,
                      static_cast<size_t>(c.width_in_blocks) * 8);
        }
      }
    }
  }

  void decode(uint8_t* out) {
    start_decompress();
    for (;;) {
      if (lossless_) {
        decode_lossless_scan();
      } else {
        decode_scan();
      }
      // a single scan is whole once its last MCU is decoded: Pillow takes
      // the image though the rest of the file is cut (libjpeg suspends in
      // jpeg_finish_decompress, after the last row)
      if (!multiple_scans_) complete_ = true;
      if (read_markers() == kEOI) break;
      if (!multiple_scans_) refuse();   // a second SOS where none can be
    }
    output(out, int64_t{width_} * 3, height_);
  }

 private:
  // -- input ----------------------------------------------------------------
  // Past the end, libjpeg's memory source feeds FF D9 pairs (a fake EOI).
  // Pillow's source suspends instead, and at the end of the file Pillow
  // refuses the image ("image file is truncated") unless it is already
  // whole: a single scan once its last MCU is decoded, several scans once
  // EOI is read. (libjpeg-turbo's Huffman decoder also has a fast path,
  // which reads ahead otherwise, but only while 512 bytes a block are left
  // in the data; on every cut tried, its read position had met the slow
  // path's before the end, so only the slow path, mcu_sequential, is
  // followed.)
  int byte() {
    const int64_t p = pos_++;
    if (p < len_) return buf_[p];
    if (suspend_ && !complete_) refuse();
    if (fail_past_end_) refuse();
    return ((p - len_) & 1) ? kEOI : 0xFF;
  }
  int two_bytes() {
    const int hi = byte();
    return hi << 8 | byte();
  }
  // a skip past the end lands in the fake EOIs (libtiff's source starts a
  // fresh FF D9 there instead; the marker search reads EOI either way)
  void skip(int64_t n) {
    if (ojpeg_) refuse();         // its skip_input_data is an error
    if (n > 0) pos_ += n;
  }

  // -- markers --------------------------------------------------------------
  void next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();      // garbage before a marker
      do c = byte(); while (c == 0xFF);  // fill bytes
      if (c != 0) {
        unread_marker_ = c;
        return;
      }
      // FF 00 outside entropy data: skipped as garbage
    }
  }

  // markers until SOS (kSOS) or EOI (kEOI)
  int read_markers() {
    for (;;) {
      if (unread_marker_ == 0) {
        if (!saw_soi_) {
          if (byte() != 0xFF || byte() != kSOI) refuse();
          unread_marker_ = kSOI;
        } else {
          next_marker();
        }
      }
      const int m = unread_marker_;
      if (m == kSOI) {
        get_soi();
      } else if (m == kSOF0 || m == kSOF1) {
        get_sof(false, false);
      } else if (m == kSOF2) {
        get_sof(true, false);
      } else if (m == kSOF3 && turbo3_) {
        get_sof(false, false);            // lossless: libjpeg-turbo 3
        lossless_ = true;
      } else if (m == kSOF9) {
        get_sof(false, true);
      } else if (m == kSOF10) {
        get_sof(true, true);
      } else if ((m >= 0xC3 && m <= 0xCF) && m != kDHT && m != kDAC) {
        refuse();             // hierarchical, JPG, SOF11, 13-15; SOF3
                              // before libjpeg-turbo 3
      } else if (m == kSOS) {
        get_sos();
        unread_marker_ = 0;
        return kSOS;
      } else if (m == kEOI) {
        unread_marker_ = 0;
        return kEOI;
      } else if (m == kDAC) {
        get_dac();
      } else if (m == kDHT) {
        get_dht();
      } else if (m == kDQT) {
        get_dqt();
      } else if (m == kDRI) {
        get_dri();
      } else if (m == kAPP0 || m == kAPP14) {
        get_app(m);
      } else if ((m > kAPP0 && m <= kAPP15) || m == kCOM || m == kDNL) {
        skip(two_bytes() - 2);
      } else if ((m >= kRST0 && m <= kRST7) || m == kTEM) {
        // no parameters
      } else {
        refuse();             // unknown marker
      }
      unread_marker_ = 0;
    }
  }

  void get_soi() {
    if (saw_soi_) refuse();
    restart_interval_ = 0;
    for (int t = 0; t < 16; ++t) {
      dc_l_[t] = 0;
      dc_u_[t] = 1;
      ac_k_[t] = 5;
    }
    saw_jfif_ = saw_adobe_ = false;
    adobe_transform_ = 0;
    saw_soi_ = true;
  }

  void get_sof(bool progressive, bool arithmetic) {
    if (saw_sof_) refuse();
    progressive_ = progressive;
    arithmetic_ = arithmetic;
    int length = two_bytes();
    precision_ = byte();
    height_ = two_bytes();
    width_ = two_bytes();
    const int n = byte();
    length -= 8;
    if (height_ == 0 || width_ == 0 || n == 0) refuse();
    if (length != n * 3) refuse();
    comps_.clear();
    comps_.resize(n);
    for (Component& c : comps_) {
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4 & 15;
      c.v = hv & 15;
      c.tq = byte();
    }
    saw_sof_ = true;
  }

  void get_sos() {
    if (!saw_sof_) refuse();
    const int length = two_bytes();
    const int n = byte();
    if (length != n * 2 + 6 || n < 1 || n > 4) refuse();
    scan_n_ = n;
    for (int& s : scan_) s = -1;
    const int searchable = std::min<int>(comps_.size(), 4);
    for (int i = 0; i < n; ++i) {
      const int cc = byte(), tables = byte();
      int found = -1;
      // libjpeg-turbo matches the id among the first four components and
      // skips component ci when scan slot ci is taken (this refuses a
      // repeated id, and some reorderings)
      for (int ci = 0; ci < searchable && found < 0; ++ci)
        if (comps_[ci].id == cc && scan_[ci] < 0) found = ci;
      if (found < 0) refuse();
      for (int j = 0; j < i; ++j)
        if (scan_[j] == found) refuse();
      scan_[i] = found;
      comps_[found].td = tables >> 4 & 15;
      comps_[found].ta = tables & 15;
    }
    ss_ = byte();
    se_ = byte();
    const int a = byte();
    ah_ = a >> 4 & 15;
    al_ = a & 15;
    next_restart_num_ = 0;
    ++scan_number_;
  }

  void get_dht() {
    int length = two_bytes() - 2;
    while (length > 16) {
      int index = byte();
      HuffSpec spec;
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        spec.bits[l] = static_cast<uint8_t>(byte());
        count += spec.bits[l];
      }
      length -= 17;
      if (count > 256 || count > length) refuse();
      for (int i = 0; i < count; ++i)
        spec.vals[i] = static_cast<uint8_t>(byte());
      length -= count;
      HuffSpec* slots = t_.dc;
      if (index & 0x10) {
        index -= 0x10;
        slots = t_.ac;
      }
      if (index >= 4) refuse();
      spec.defined = true;
      slots[index] = spec;
    }
    if (length != 0) refuse();
  }

  void get_dqt() {
    int length = two_bytes() - 2;
    while (length > 0) {
      int n = byte();
      const int precision = n >> 4;
      n &= 15;
      if (n >= 4) refuse();
      for (int i = 0; i < 64; ++i)
        t_.quant[n][kNatural[i]] =
            static_cast<uint16_t>(precision ? two_bytes() : byte());
      t_.quant_defined[n] = true;
      length -= precision ? 129 : 65;
    }
    if (length != 0) refuse();
  }

  void get_dri() {
    if (two_bytes() != 4) refuse();
    restart_interval_ = two_bytes();
  }

  void get_dac() {
    int length = two_bytes() - 2;
    while (length > 0) {
      const int index = byte(), value = byte();
      length -= 2;
      if (index >= 32) refuse();
      if (index >= 16) {
        ac_k_[index - 16] = static_cast<uint8_t>(value);
      } else {
        dc_l_[index] = static_cast<uint8_t>(value & 15);
        dc_u_[index] = static_cast<uint8_t>(value >> 4);
        if (dc_l_[index] > dc_u_[index]) refuse();
      }
    }
    if (length != 0) refuse();
  }

  // APP0 and APP14: the first 14 bytes examined, the rest skipped
  void get_app(int marker) {
    int length = two_bytes() - 2;
    const int n = length >= 14 ? 14 : length > 0 ? length : 0;
    uint8_t b[14];
    for (int i = 0; i < n; ++i) b[i] = static_cast<uint8_t>(byte());
    length -= n;
    if (marker == kAPP0 && n >= 14 && std::memcmp(b, "JFIF", 5) == 0)
      saw_jfif_ = true;
    if (marker == kAPP14 && n >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      saw_adobe_ = true;
      adobe_transform_ = b[11];
    }
    skip(length);
  }

  // -- frame ----------------------------------------------------------------
  void initial_setup() {
    if (height_ > kMaxDimension || width_ > kMaxDimension) refuse();
    // 12-bit frames in libtiff's codec only (jpeg12_read_scanlines)
    if (precision_ != 8 && !(tiff_ && precision_ == 12)) refuse();
    p12_ = precision_ == 12;
    if (static_cast<int>(comps_.size()) > kMaxComponents) refuse();
    max_h_ = max_v_ = 1;
    for (const Component& c : comps_) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) refuse();
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    auto up = [](int64_t a, int64_t b) {
      return static_cast<int>((a + b - 1) / b);
    };
    // a lossless frame's "blocks" are single samples
    const int block = lossless_ ? 1 : 8;
    for (Component& c : comps_) {
      c.width_in_blocks = up(int64_t{width_} * c.h, max_h_ * block);
      c.height_in_blocks = up(int64_t{height_} * c.v, max_v_ * block);
      c.dw = up(int64_t{width_} * c.h, max_h_);
      c.dh = up(int64_t{height_} * c.v, max_v_);
    }
    mcus_per_row_ = up(width_, max_h_ * block);
    mcu_rows_ = up(height_, max_v_ * block);
    multiple_scans_ =
        scan_n_ < static_cast<int>(comps_.size()) || progressive_;
  }

  // what jpeg_start_decompress checks and sets up for RGB output
  void start_decompress() {
    const int n = static_cast<int>(comps_.size());
    if (tiff_) {
      color_ = tiff_rgb_ ? kYCC : kUnknown;   // JCS_UNKNOWN: as stored
      if (tiff_rgb_ && n != 3) refuse();      // JERR_BAD_J_COLORSPACE
    } else if (n == 1) {
      color_ = kGray;
    } else if (n == 4 && turbo3_) {
      // jdapimin.c's default_decompress_parms: Adobe transform 0 is CMYK,
      // any other YCCK; no Adobe marker, CMYK
      color_ = saw_adobe_ && adobe_transform_ != 0 && !cmyk_ ? kYCCK : kCMYK;
    } else if (n == 3) {
      if (saw_jfif_) {
        color_ = kYCC;
      } else if (saw_adobe_) {
        color_ = adobe_transform_ == 0 ? kRGB : kYCC;
      } else if (comps_[0].id == 'R' && comps_[1].id == 'G' &&
                 comps_[2].id == 'B') {
        color_ = kRGB;
      } else {
        color_ = kYCC;        // ids 1, 2, 3 or unknown: YCbCr
      }
    } else {
      refuse();               // CMYK and YCCK before libjpeg-turbo 3 (no
                              // conversion to RGB), and 2 or 5+ components
    }
    // libjpeg-turbo 3 converts no colour space of a lossless frame but to
    // itself (JERR_CONVERSION_NOTIMPL)
    if (lossless_ && (color_ == kYCC || color_ == kYCCK)) refuse();
    const int block = lossless_ ? 1 : 8;
    for (Component& c : comps_) {
      const bool wide = c.dw > 2;
      if (c.h == max_h_ && c.v == max_v_) {
        c.up = Upsample::kFull;
      } else if (lossless_) {
        // no fancy upsampling where the "DCT" size is 1: every ratio
        // replicates, or is refused where it is not integral
        if (max_h_ % c.h != 0 || max_v_ % c.v != 0) refuse();
        c.up = Upsample::kInt;
        c.hx = max_h_ / c.h;
        c.vx = max_v_ / c.v;
      } else if (c.h * 2 == max_h_ && c.v == max_v_) {
        c.up = wide ? Upsample::kH2V1 : Upsample::kH2V1Box;
      } else if (c.h == max_h_ && c.v * 2 == max_v_) {
        c.up = Upsample::kH1V2;
      } else if (c.h * 2 == max_h_ && c.v * 2 == max_v_) {
        c.up = wide ? Upsample::kH2V2 : Upsample::kH2V2Box;
      } else if (max_h_ % c.h == 0 && max_v_ % c.v == 0) {
        c.up = Upsample::kInt;
        c.hx = max_h_ / c.h;
        c.vx = max_v_ / c.v;
      } else {
        refuse();             // fractional sampling ratio
      }
      c.bw = (c.width_in_blocks + c.h - 1) / c.h * c.h;
      c.bh = (c.height_in_blocks + c.v - 1) / c.v * c.v;
      c.stride = static_cast<size_t>(c.bw) * block;
      if (p12_) {
        // libtiff opens 12-bit JPEG as grey only: one component at full
        // size, as stored (other layouts never reach the codec)
        if (c.up != Upsample::kFull || color_ != kUnknown) refuse();
        c.plane16.reset(new uint16_t[c.stride * c.bh * block]);
      } else {
        c.plane.reset(new uint8_t[c.stride * c.bh * block]);
      }
      if (lossless_) continue;
      if (multiple_scans_)
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      std::fill(c.bits, c.bits + 64, -1);
    }
    // the standard tables where a sequential Huffman file defines none
    // (jinit_huff_decoder's std_huff_tables); a lossless file gets none
    if (!progressive_ && !arithmetic_ && !lossless_) {
      const uint8_t* std_vals[4] = {kStdDcVals, kStdAcLuma, kStdDcVals,
                                    kStdAcChroma};
      for (int t = 0; t < 4; ++t) {
        HuffSpec& spec = (t & 1 ? t_.ac : t_.dc)[t >> 1];
        if (spec.defined) continue;
        std::memcpy(spec.bits, kStdBits[t], 17);
        int count = 0;
        for (int l = 1; l <= 16; ++l) count += kStdBits[t][l];
        std::memset(spec.vals, 0, sizeof(spec.vals));
        std::memcpy(spec.vals, std_vals[t], count);
        spec.defined = true;
      }
    }
  }

  // -- scans ----------------------------------------------------------------
  void start_scan() {
    // the MCU's blocks
    mcu_blocks_ = 0;
    if (scan_n_ == 1) {
      member_[mcu_blocks_++] = 0;
    } else {
      for (int i = 0; i < scan_n_; ++i) {
        const Component& c = comps_[scan_[i]];
        if (mcu_blocks_ + c.h * c.v > kMaxBlocksInMCU) refuse();
        for (int k = 0; k < c.h * c.v; ++k) member_[mcu_blocks_++] = i;
      }
    }
    // each component keeps the quantization table of its first scan
    for (int i = 0; i < scan_n_; ++i) {
      Component& c = comps_[scan_[i]];
      if (c.latched) continue;
      if (c.tq >= 4 || !t_.quant_defined[c.tq]) refuse();
      for (int k = 0; k < 64; ++k) {
        c.quant[k] = static_cast<int16_t>(t_.quant[c.tq][k]);
        c.quant32[k] = t_.quant[c.tq][k];
      }
      c.latched = true;
    }
    if (progressive_) {
      const bool dc = ss_ == 0;
      bool bad = false;
      if (dc) {
        bad = se_ != 0;
      } else {
        bad = ss_ > se_ || se_ >= 64 || scan_n_ != 1;
      }
      if (ah_ != 0 && al_ != ah_ - 1) bad = true;
      if (al_ > 13) bad = true;
      if (bad) refuse();
      for (int i = 0; i < scan_n_; ++i) {
        Component& c = comps_[scan_[i]];
        for (int k = std::min(ss_, 1); k <= std::max(se_, 9); ++k)
          c.prev_bits[k] = scan_number_ > 1 ? c.bits[k] : 0;
        for (int k = ss_; k <= se_; ++k) c.bits[k] = al_;
      }
      for (int i = 0; i < scan_n_ && !arithmetic_; ++i) {
        const Component& c = comps_[scan_[i]];
        if (dc) {
          if (ah_ == 0) {
            if (c.td >= 4) refuse();
            build_decoder(t_.dc[c.td], true, &dc_dec_[i]);
          }
        } else {
          if (c.ta >= 4) refuse();
          build_decoder(t_.ac[c.ta], false, &ac_dec_[i]);
        }
      }
    } else {
      for (int i = 0; i < scan_n_ && !arithmetic_; ++i) {
        const Component& c = comps_[scan_[i]];
        if (c.td >= 4 || c.ta >= 4) refuse();
        build_decoder(t_.dc[c.td], true, &dc_dec_[i]);
        build_decoder(t_.ac[c.ta], false, &ac_dec_[i]);
      }
    }
    for (int& p : dc_pred_) p = 0;
    bits_left_ = 0;
    bit_buffer_ = 0;
    insufficient_ = false;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    if (arithmetic_) reset_arith();
  }

  // A file of one scan: each MCU is decoded into zeroed blocks and those
  // inside the image go through the IDCT at once, as libjpeg's one-pass
  // coefficient controller does. A file of several scans collects every
  // scan in the coefficient buffers, and output() runs the IDCT.
  void decode_scan(bool start = true) {
    if (start) start_scan();
    imcu_done_ = 0;
    const bool direct = !multiple_scans_;
    alignas(16) int16_t local[kMaxBlocksInMCU][64];
    int16_t* blocks[kMaxBlocksInMCU];
    Component* owner[kMaxBlocksInMCU];
    int rows[kMaxBlocksInMCU], cols[kMaxBlocksInMCU];
    // n blocks in iMCU row imcu_row; the last iMCU row whose MCUs were
    // started with data left is what smoothing reads
    auto mcu = [&](int n, int imcu_row) {
      for (int b = 0; b < n; ++b)
        blocks[b] = direct ? local[b] : owner[b]->block(rows[b], cols[b]);
      if (direct) std::memset(local, 0, sizeof(local[0]) * n);
      if (!insufficient_) last_good_row_ = imcu_row;
      decode_mcu(blocks);
      if (!direct) return;
      for (int b = 0; b < n; ++b) {
        Component& c = *owner[b];
        if (rows[b] < c.height_in_blocks && cols[b] < c.width_in_blocks)
          idct(c, local[b], rows[b], cols[b]);
      }
    };
    if (scan_n_ == 1) {
      Component& c = comps_[scan_[0]];
      owner[0] = &c;
      for (int row = 0; row < c.height_in_blocks; ++row) {
        for (int col = 0; col < c.width_in_blocks; ++col) {
          rows[0] = row;
          cols[0] = col;
          mcu(1, row / c.v);
        }
        if ((row + 1) % c.v == 0) ++imcu_done_;
      }
    } else {
      for (int my = 0; my < mcu_rows_; ++my) {
        for (int mx = 0; mx < mcus_per_row_; ++mx) {
          int b = 0;
          for (int i = 0; i < scan_n_; ++i) {
            Component& c = comps_[scan_[i]];
            for (int y = 0; y < c.v; ++y) {
              for (int x = 0; x < c.h; ++x, ++b) {
                owner[b] = &c;
                rows[b] = my * c.v + y;
                cols[b] = mx * c.h + x;
              }
            }
          }
          mcu(b, my);
        }
        imcu_done_ = my + 1;
      }
    }
  }

  // -- lossless scans (T.81 Annex H; libjpeg-turbo 3's jdlhuff.c,
  // jddiffct.c and jdlossls.c) ---------------------------------------------
  // Each MCU row's differences are decoded, then each iMCU row is
  // undifferenced row by row: the first row of the scan, and the first
  // row of an iMCU row in which a restart marker was read or the data had
  // run out, with the horizontal predictor from 2^(P - Pt - 1); the first
  // sample of any other row from the one above; the rest with the scan's
  // predictor (Ss), all modulo 2^16, then shifted left by Pt (Al) into 8
  // bits. Where the data ran out, an MCU row's differences are all zero.
  void decode_lossless_scan() {
    if (ss_ < 1 || ss_ > 7 || se_ != 0 || ah_ != 0 || al_ >= precision_)
      refuse();
    mcu_blocks_ = 0;
    for (int i = 0; i < scan_n_; ++i) {
      Component& c = comps_[scan_[i]];
      const int nb = scan_n_ == 1 ? 1 : c.h * c.v;
      if (mcu_blocks_ + nb > kMaxBlocksInMCU) refuse();
      mcu_blocks_ += nb;
      if (c.td >= 4) refuse();
      build_decoder(t_.dc[c.td], true, &dc_dec_[i], true);
      c.latched = true;
    }
    bits_left_ = 0;
    bit_buffer_ = 0;
    insufficient_ = false;
    const bool inter = scan_n_ > 1;
    const int per_row =
        inter ? mcus_per_row_ : comps_[scan_[0]].width_in_blocks;
    if (restart_interval_ % per_row) refuse();   // whole MCU rows only
    const int restart_rows = restart_interval_ / per_row;
    restarts_to_go_ = restart_rows;
    // each scan component's differences for an iMCU row, and its last
    // undifferenced row
    std::vector<int32_t> diff[4];
    std::vector<uint16_t> above[4];
    int width[4];
    for (int i = 0; i < scan_n_; ++i) {
      const Component& c = comps_[scan_[i]];
      width[i] = inter ? per_row * c.h : per_row;
      diff[i].assign(static_cast<size_t>(width[i]) * c.v, 0);
      above[i].assign(c.width_in_blocks, 0);
    }
    auto rows_in = [&](const Component& c, bool last) {
      const int r = c.height_in_blocks % c.v;
      return last && r ? r : c.v;
    };
    bool reset = true;
    for (int r = 0; r < mcu_rows_; ++r) {
      const bool last = r == mcu_rows_ - 1;
      const int mcu_rows = inter ? 1 : rows_in(comps_[scan_[0]], last);
      for (int y = 0; y < mcu_rows; ++y) {
        if (restart_interval_ && restarts_to_go_ == 0) {
          bits_left_ = 0;
          read_restart_marker();
          if (unread_marker_ == 0) insufficient_ = false;
          restarts_to_go_ = restart_rows;
          reset = true;
        }
        if (insufficient_) {
          reset = true;
          for (int i = 0; i < scan_n_; ++i) {
            const Component& c = comps_[scan_[i]];
            for (int yy = inter ? 0 : y; yy < (inter ? c.v : y + 1); ++yy)
              std::fill_n(diff[i].begin() + static_cast<size_t>(yy) *
                                                width[i], width[i], 0);
          }
        } else {
          for (int mx = 0; mx < per_row; ++mx) {
            for (int i = 0; i < scan_n_; ++i) {
              const Component& c = comps_[scan_[i]];
              const int rows = inter ? c.v : 1, cols = inter ? c.h : 1;
              for (int yy = 0; yy < rows; ++yy) {
                int32_t* d = diff[i].data() +
                             static_cast<size_t>(inter ? yy : y) * width[i] +
                             mx * cols;
                for (int xx = 0; xx < cols; ++xx) {
                  int sz = decode_huffman(dc_dec_[i]);
                  d[xx] = sz == 0    ? 0
                          : sz == 16 ? 32768
                                     : extend(get_bits(sz), sz);
                }
              }
            }
          }
        }
        if (restart_interval_) --restarts_to_go_;
      }
      for (int i = 0; i < scan_n_; ++i) {
        Component& c = comps_[scan_[i]];
        const int n = rows_in(c, last), w = c.width_in_blocks;
        for (int y = 0; y < n; ++y) {
          const int32_t* d = diff[i].data() + static_cast<size_t>(y) * width[i];
          uint16_t* up = above[i].data();
          uint8_t* out = p12_ ? nullptr
                              : c.plane.get() + c.stride * (r * c.v + y);
          int ra;
          if (y == 0 && reset) {
            ra = (d[0] + (1 << (precision_ - al_ - 1))) & 0xFFFF;
            up[0] = static_cast<uint16_t>(ra);
            for (int x = 1; x < w; ++x)
              up[x] = static_cast<uint16_t>(ra = (d[x] + ra) & 0xFFFF);
          } else {
            int rb = up[0], rc;
            ra = (d[0] + rb) & 0xFFFF;
            up[0] = static_cast<uint16_t>(ra);
            for (int x = 1; x < w; ++x) {
              rc = rb;
              rb = up[x];
              int p;
              switch (ss_) {
                case 1: p = ra; break;
                case 2: p = rb; break;
                case 3: p = rc; break;
                case 4: p = ra + rb - rc; break;
                case 5: p = ra + ((rb - rc) >> 1); break;
                case 6: p = rb + ((ra - rc) >> 1); break;
                default: p = (ra + rb) >> 1; break;
              }
              up[x] = static_cast<uint16_t>(ra = (d[x] + p) & 0xFFFF);
            }
          }
          if (p12_) {
            uint16_t* out16 = c.plane16.get() + c.stride * (r * c.v + y);
            for (int x = 0; x < w; ++x)
              out16[x] = static_cast<uint16_t>(up[x] << al_);
            continue;
          }
          for (int x = 0; x < w; ++x)
            out[x] = static_cast<uint8_t>(up[x] << al_);
        }
      }
      reset = false;
    }
  }

  void decode_mcu(int16_t** blocks) {
    if (arithmetic_) {
      arith_mcu(blocks);
      return;
    }
    if (restart_interval_ && restarts_to_go_ == 0) process_restart();
    if (!progressive_) {
      if (!insufficient_) mcu_sequential(blocks);
    } else if (ss_ == 0) {
      if (ah_ == 0) {
        if (!insufficient_) mcu_dc_first(blocks);
      } else {
        mcu_dc_refine(blocks);  // zero bits change nothing here
      }
    } else if (!insufficient_) {
      if (ah_ == 0) {
        mcu_ac_first(blocks[0]);
      } else {
        mcu_ac_refine(blocks[0]);
      }
    }
    if (restart_interval_) --restarts_to_go_;
  }

  void process_restart() {
    bits_left_ = 0;
    read_restart_marker();
    for (int& p : dc_pred_) p = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    // left set when the next segment is empty (stopped at a marker)
    if (unread_marker_ == 0) insufficient_ = false;
  }

  void read_restart_marker() {
    if (unread_marker_ == 0) next_marker();
    if (unread_marker_ == kRST0 + next_restart_num_) {
      unread_marker_ = 0;
    } else {
      if (ojpeg_) refuse();       // its resync_to_restart is an error
      resync_to_restart(next_restart_num_);
    }
    next_restart_num_ = (next_restart_num_ + 1) & 7;
  }

  // a marker other than the expected RSTn: libjpeg's recovery. Discard it
  // and resume, scan on to the next marker, or leave it for an empty
  // segment
  void resync_to_restart(int desired) {
    int marker = unread_marker_;
    for (;;) {
      int action;
      if (marker < kSOF0) {
        action = 2;
      } else if (marker < kRST0 || marker > kRST7) {
        action = 3;
      } else if (marker == kRST0 + ((desired + 1) & 7) ||
                 marker == kRST0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == kRST0 + ((desired - 1) & 7) ||
                 marker == kRST0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        unread_marker_ = 0;
        return;
      }
      if (action == 3) return;
      next_marker();
      marker = unread_marker_;
    }
  }

  // -- bits -----------------------------------------------------------------
  // top the buffer up to kFillBits from the entropy data; at a marker, or
  // with one already read, feed zero bits where nbits are not there
  void fill(int nbits) {
    if (unread_marker_ == 0) {
      while (bits_left_ < kFillBits) {
        int c = byte();
        if (c == 0xFF) {
          do c = byte(); while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;           // stuffed: a data byte FF
          } else {
            unread_marker_ = c;
            break;
          }
        }
        bit_buffer_ = bit_buffer_ << 8 | static_cast<uint64_t>(c);
        bits_left_ += 8;
      }
      if (unread_marker_ == 0) return;
    }
    if (nbits > bits_left_) {
      insufficient_ = true;     // premature end of data
      bit_buffer_ <<= kFillBits - bits_left_;
      bits_left_ = kFillBits;
    }
  }

  int get_bits(int n) {
    if (bits_left_ < n) fill(n);
    bits_left_ -= n;
    return static_cast<int>((bit_buffer_ >> bits_left_) &
                            ((uint64_t{1} << n) - 1));
  }

  int decode_huffman(const HuffDecoder& d) {
    int len;
    if (bits_left_ < 8) fill(0);
    if (bits_left_ >= 8) {
      const int e = d.lookup[(bit_buffer_ >> (bits_left_ - 8)) & 0xFF];
      len = e >> 8;
      if (len <= 8) {
        bits_left_ -= len;
        return e & 0xFF;
      }
    } else {
      len = 1;                  // near a marker: bit by bit
    }
    int32_t code = get_bits(len);
    while (code > d.maxcode[len]) {
      code = code << 1 | get_bits(1);
      ++len;
    }
    if (len > 16) return 0;     // not a code: a zero, as libjpeg fakes
    return d.vals[(code + d.valoffset[len]) & 0xFF];
  }

  // -- MCU decoders ---------------------------------------------------------
  void mcu_sequential(int16_t** blocks) {
    for (int b = 0; b < mcu_blocks_; ++b) {
      const int i = member_[b];
      int16_t* blk = blocks[b];
      int s = decode_huffman(dc_dec_[i]);
      if (s) s = extend(get_bits(s), s);
      dc_pred_[i] = static_cast<int32_t>(static_cast<uint32_t>(dc_pred_[i]) +
                                         static_cast<uint32_t>(s));
      blk[0] = static_cast<int16_t>(dc_pred_[i]);
      const HuffDecoder& ac = ac_dec_[i];
      for (int k = 1; k < 64; ++k) {
        s = decode_huffman(ac);
        const int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(extend(get_bits(s), s));
        } else {
          if (r != 15) break;   // EOB
          k += 15;              // ZRL
        }
      }
    }
  }

  void mcu_dc_first(int16_t** blocks) {
    for (int b = 0; b < mcu_blocks_; ++b) {
      const int i = member_[b];
      int s = decode_huffman(dc_dec_[i]);
      if (s) s = extend(get_bits(s), s);
      const int64_t sum = int64_t{dc_pred_[i]} + s;
      if (sum > INT32_MAX || sum < INT32_MIN) refuse();
      dc_pred_[i] = static_cast<int32_t>(sum);
      blocks[b][0] = static_cast<int16_t>(static_cast<uint32_t>(sum) << al_);
    }
  }

  void mcu_dc_refine(int16_t** blocks) {
    const int p1 = 1 << al_;
    for (int b = 0; b < mcu_blocks_; ++b)
      if (get_bits(1)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
  }

  void mcu_ac_first(int16_t* blk) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const HuffDecoder& ac = ac_dec_[0];
    for (int k = ss_; k <= se_; ++k) {
      int s = decode_huffman(ac);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        s = extend(get_bits(s), s);
        blk[kNatural[k]] =
            static_cast<int16_t>(static_cast<uint32_t>(s) << al_);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        --eobrun_;
        break;
      }
    }
  }

  void mcu_ac_refine(int16_t* blk) {
    const int p1 = 1 << al_;
    const int m1 = -p1;
    const HuffDecoder& ac = ac_dec_[0];
    int k = ss_;
    // a correction bit for a coefficient already nonzero
    auto correct = [&](int16_t* coef) {
      if (get_bits(1) && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    };
    if (eobrun_ == 0) {
      for (; k <= se_; ++k) {
        int s = decode_huffman(ac);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;   // a size other than 1 is read as 1
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          break;
        }
        // skip the already-nonzero coefficients (correcting each) and r
        // zero ones, to the zero that becomes s
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se_);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --eobrun_;
    }
  }


  // -- arithmetic decoding (T.81 Annex D, F.1.4.4 and G.1.3, with the
  // registers and fault handling of libjpeg's jdarith.c) -------------------
  // Past a marker, or the end of the buffer, zero bytes are fed and the
  // decoding goes on from them. A magnitude or a run that overflows stops
  // the decoding of the restart interval (ct_ -1); its MCUs keep what they
  // hold.

  // the statistics of the scan's tables, the registers and the DC state,
  // as at the start of a scan and after each restart marker
  void reset_arith() {
    for (int i = 0; i < scan_n_; ++i) {
      const Component& c = comps_[scan_[i]];
      if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
        std::memset(dc_stats_[c.td], 0, sizeof(dc_stats_[0]));
        dc_pred_[i] = 0;
        dc_context_[i] = 0;
      }
      if (!progressive_ || ss_ != 0)
        std::memset(ac_stats_[c.ta], 0, sizeof(ac_stats_[0]));
    }
    c_ = 0;
    a_ = 0;
    ct_ = -16;                  // two bytes are read into C first
  }

  // one binary decision in context *st (D.2.4-D.2.6): C keeps the base of
  // the interval above ct_ bits of input not yet shifted in
  int arith_decode(uint8_t* st) {
    while (a_ < 0x8000) {
      if (--ct_ < 0) {
        int data = 0;
        if (unread_marker_ == 0) {
          data = byte();
          if (data == 0xFF) {
            do data = byte(); while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;      // stuffed
            } else {
              unread_marker_ = data;
              data = 0;
            }
          }
        }
        c_ = c_ << 8 | data;
        if ((ct_ += 8) < 0 && ++ct_ == 0) a_ = 0x8000;
      }
      a_ <<= 1;
    }
    int sv = *st;
    const uint32_t e = kQe[sv & 0x7F];
    const int nl = e & 0xFF, nm = e >> 8 & 0xFF;
    const int64_t q = e >> 16;
    a_ -= q;
    const int64_t t = a_ << ct_;
    // below t: the MPS, unless A fell under Qe (a conditional exchange);
    // at or above t: the LPS, with the same exchange
    if (c_ >= t) {
      c_ -= t;
      if (a_ < q) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
      a_ = q;
    } else if (a_ < 0x8000) {
      if (a_ < q) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void arith_mcu(int16_t** blocks) {
    if (restart_interval_) {
      if (restarts_to_go_ == 0) {
        read_restart_marker();
        reset_arith();
        restarts_to_go_ = restart_interval_;
      }
      --restarts_to_go_;
    }
    if (progressive_ && ss_ == 0 && ah_ != 0) {
      // a DC correction bit a block, at a fixed probability
      const int p1 = 1 << al_;
      for (int b = 0; b < mcu_blocks_; ++b)
        if (arith_decode(&fixed_bin_))
          blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
      return;
    }
    if (ct_ == -1) return;
    if (!progressive_) {
      for (int b = 0; b < mcu_blocks_; ++b) {
        const int i = member_[b];
        const Component& c = comps_[scan_[i]];
        if (!arith_dc(i, c.td)) return;
        blocks[b][0] = static_cast<int16_t>(dc_pred_[i]);
        if (!arith_ac(blocks[b], c.ta, 1, 63, 0)) return;
      }
    } else if (ss_ == 0) {
      for (int b = 0; b < mcu_blocks_; ++b) {
        const int i = member_[b];
        if (!arith_dc(i, comps_[scan_[i]].td)) return;
        blocks[b][0] = static_cast<int16_t>(
            static_cast<uint32_t>(dc_pred_[i]) << al_);
      }
    } else if (ah_ == 0) {
      arith_ac(blocks[0], comps_[scan_[0]].ta, ss_, se_, al_);
    } else {
      arith_ac_refine(blocks[0], comps_[scan_[0]].ta);
    }
  }

  // component i's DC difference into dc_pred_[i] (F.19-F.24), with the
  // conditioning of the next one from L and U (F.1.4.4.1.2)
  bool arith_dc(int i, int tbl) {
    uint8_t* stats = dc_stats_[tbl];
    uint8_t* st = stats + dc_context_[i];
    if (arith_decode(st) == 0) {
      dc_context_[i] = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m) {
      st = stats + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ct_ = -1;
          return false;
        }
        ++st;
      }
    }
    if (m < (1 << dc_l_[tbl]) >> 1)
      dc_context_[i] = 0;
    else if (m > (1 << dc_u_[tbl]) >> 1)
      dc_context_[i] = 12 + sign * 4;
    else
      dc_context_[i] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    dc_pred_[i] = (dc_pred_[i] + (sign ? -v : v)) & 0xFFFF;
    return true;
  }

  // the AC coefficients ss..se of a block, each scaled by 1 << al (F.20)
  bool arith_ac(int16_t* blk, int tbl, int ss, int se, int al) {
    uint8_t* stats = ac_stats_[tbl];
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (arith_decode(st)) break;          // EOB
      while (arith_decode(st + 1) == 0) {   // a zero
        st += 3;
        if (++k > se) {
          ct_ = -1;
          return false;
        }
      }
      const int sign = arith_decode(&fixed_bin_);
      st += 2;
      int m = arith_decode(st);
      if (m && arith_decode(st)) {
        m <<= 1;
        st = stats + (k <= ac_k_[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ct_ = -1;
            return false;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      blk[kNatural[k]] = static_cast<int16_t>(
          static_cast<uint32_t>(sign ? -v : v) << al);
    }
    return true;
  }

  // a correction bit for each coefficient already nonzero, a new +-1 << Al
  // for each that becomes nonzero (G.1.3.3)
  void arith_ac_refine(int16_t* blk, int tbl) {
    uint8_t* stats = ac_stats_[tbl];
    const int p1 = 1 << al_, m1 = -p1;
    int kex = se_;              // the previous stage's end of block
    while (kex > 0 && blk[kNatural[kex]] == 0) --kex;
    for (int k = ss_; k <= se_; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;   // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (arith_decode(st + 2))
            *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {
          *coef = static_cast<int16_t>(arith_decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se_) {
          ct_ = -1;
          return;
        }
      }
    }
  }

  // -- output ---------------------------------------------------------------
  // the islow IDCT of one block into 8 rows of 8 samples, as libjpeg-turbo
  // computes it with its SIMD code (what its x86-64 and Arm builds run):
  // the integer LL&M IDCT of the C version (CONST_BITS 13, PASS1_BITS 2)
  // in 16-bit lanes. Dequantized coefficients keep their low 16 bits, the
  // sums in0 + in4, in0 - in4, in7 + in3 and in5 + in1 wrap at 16 bits,
  // the products and the rest of the sums at 32, pass 1 saturates its
  // outputs to 16 bits and pass 2 to 8 (signed) before the +128. Where no
  // AC row holds a nonzero coefficient, pass 1 takes row 0 shifted left by
  // PASS1_BITS, in 16 bits. Inside the range of valid data all of this is
  // the C version's arithmetic; it differs (saturating where C's range
  // limit wraps) only on coefficients no encoder writes, such as a block
  // decoded from the zero bits past a premature end of data.
  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                         int stride) {
    constexpr int kConst = 13, kPass1 = 2;
    // the products of the C version, folded into pairs as multiply-adds
    constexpr int32_t F0_541 = 4433, F0_765 = 6270, F1_847 = 15137,
                      F0_298 = 2446, F0_390 = 3196, F0_899 = 7373,
                      F1_175 = 9633, F1_501 = 12299, F1_961 = 16069,
                      F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
    // eight 8-point IDCTs side by side: d[k][lane] in, o[k][lane] out,
    // the sums before descaling (a loop over lanes that vectorises)
    auto dct8 = [](const int16_t (&d)[8][8], uint32_t (&o)[8][8]) {
      for (int l = 0; l < 8; ++l) {
        const int32_t d0 = d[0][l], d1 = d[1][l], d2 = d[2][l], d3 = d[3][l],
                      d4 = d[4][l], d5 = d[5][l], d6 = d[6][l], d7 = d[7][l];
        const uint32_t t0 = static_cast<uint32_t>(
            int32_t{static_cast<int16_t>(d0 + d4)}) << kConst;
        const uint32_t t1 = static_cast<uint32_t>(
            int32_t{static_cast<int16_t>(d0 - d4)}) << kConst;
        const uint32_t t3 = static_cast<uint32_t>(d2 * (F0_541 + F0_765) +
                                                  d6 * F0_541);
        const uint32_t t2 = static_cast<uint32_t>(d2 * F0_541 +
                                                  d6 * (F0_541 - F1_847));
        const uint32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2,
                       t12 = t1 - t2;
        const int32_t z3 = static_cast<int16_t>(d7 + d3),
                      z4 = static_cast<int16_t>(d5 + d1);
        const uint32_t z3p = static_cast<uint32_t>(z3 * (F1_175 - F1_961) +
                                                   z4 * F1_175);
        const uint32_t z4p = static_cast<uint32_t>(z3 * F1_175 +
                                                   z4 * (F1_175 - F0_390));
        const uint32_t o0 = static_cast<uint32_t>(
            d7 * (F0_298 - F0_899) + d1 * -F0_899) + z3p;
        const uint32_t o3 = static_cast<uint32_t>(
            d7 * -F0_899 + d1 * (F1_501 - F0_899)) + z4p;
        const uint32_t o1 = static_cast<uint32_t>(
            d5 * (F2_053 - F2_562) + d3 * -F2_562) + z4p;
        const uint32_t o2 = static_cast<uint32_t>(
            d5 * -F2_562 + d3 * (F3_072 - F2_562)) + z3p;
        o[0][l] = t10 + o3;
        o[7][l] = t10 - o3;
        o[1][l] = t11 + o2;
        o[6][l] = t11 - o2;
        o[2][l] = t12 + o1;
        o[5][l] = t12 - o1;
        o[3][l] = t13 + o0;
        o[4][l] = t13 - o0;
      }
    };
    auto descale = [](uint32_t x, int n) {
      return static_cast<int32_t>(x + (uint32_t{1} << (n - 1))) >> n;
    };
    // pass 1, the columns: d[k][col] is row k of the dequantized block;
    // the result is kept transposed, ws[col][row], for pass 2's lanes
    int16_t d[8][8], ws[8][8];
    uint32_t o[8][8];
    bool ac_rows_zero = true;
    for (int k = 8; k < 64 && ac_rows_zero; ++k) ac_rows_zero = in[k] == 0;
    if (ac_rows_zero) {
      for (int col = 0; col < 8; ++col) {
        const int16_t v = static_cast<int16_t>(
            static_cast<int16_t>(in[col] * q[col]) * (1 << kPass1));
        for (int r = 0; r < 8; ++r) ws[col][r] = v;
      }
    } else {
      for (int k = 0; k < 64; ++k)
        d[k >> 3][k & 7] = static_cast<int16_t>(in[k] * q[k]);
      dct8(d, o);
      for (int r = 0; r < 8; ++r) {
        for (int col = 0; col < 8; ++col) {
          const int32_t v = descale(o[r][col], kConst - kPass1);
          ws[col][r] = static_cast<int16_t>(std::min(std::max(v, -32768),
                                                     32767));
        }
      }
    }
    // pass 2, the rows side by side: ws[k][row] is frequency k of a row
    dct8(ws, o);
    for (int row = 0; row < 8; ++row) {
      uint8_t* dst = out + static_cast<size_t>(row) * stride;
      for (int k = 0; k < 8; ++k) {
        const int32_t v = descale(o[k][row], kConst + kPass1 + 3);
        dst[k] = static_cast<uint8_t>(std::min(std::max(v, -128), 127) +
                                      128);
      }
    }
  }

  // the IDCT of one block of component c into its plane at (row, col)
  void idct(Component& c, const int16_t* in, int row, int col) {
    if (p12_) {
      idct_islow12(in, c.quant32, c.samples16(row, col),
                   static_cast<int>(c.stride));
    } else {
      idct_islow(in, c.quant, c.samples(row, col),
                 static_cast<int>(c.stride));
    }
  }

  // libjpeg-turbo's 12-bit islow IDCT: jidctint.c in C (no SIMD version
  // exists at this precision), PASS1_BITS 1, products and sums in 64 bits
  // (JLONG), the coefficients dequantized by the unsigned table in 64
  // bits, pass 1's outputs kept as int (the low 32 bits), and each output
  // looked up in the range-limit table: its low 14 bits as a signed
  // value, plus CENTERJSAMPLE 2048, held to 0..MAXJSAMPLE 4095 (values
  // past the table's span wrap).
  static void idct_islow12(const int16_t* in, const int32_t* q,
                           uint16_t* out, int stride) {
    constexpr int kConst = 13, kPass1 = 1;
    constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                      F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                      F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                      F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
    auto descale = [](int64_t x, int n) {
      return (x + (int64_t{1} << (n - 1))) >> n;
    };
    // the even and odd parts of one 8-point IDCT: o[k] before descaling
    auto dct8 = [](const int64_t (&d)[8], int64_t (&o)[8]) {
      int64_t z2 = d[2], z3 = d[6];
      int64_t z1 = (z2 + z3) * F0_541;
      const int64_t tmp2e = z1 + z3 * -F1_847, tmp3e = z1 + z2 * F0_765;
      const int64_t tmp0e = (d[0] + d[4]) * (int64_t{1} << kConst);
      const int64_t tmp1e = (d[0] - d[4]) * (int64_t{1} << kConst);
      const int64_t t10 = tmp0e + tmp3e, t13 = tmp0e - tmp3e,
                    t11 = tmp1e + tmp2e, t12 = tmp1e - tmp2e;
      int64_t t0 = d[7], t1 = d[5], t2 = d[3], t3 = d[1];
      z1 = t0 + t3;
      z2 = t1 + t2;
      z3 = t0 + t2;
      int64_t z4 = t1 + t3;
      const int64_t z5 = (z3 + z4) * F1_175;
      t0 *= F0_298;
      t1 *= F2_053;
      t2 *= F3_072;
      t3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      t0 += z1 + z3;
      t1 += z2 + z4;
      t2 += z2 + z3;
      t3 += z1 + z4;
      o[0] = t10 + t3;
      o[7] = t10 - t3;
      o[1] = t11 + t2;
      o[6] = t11 - t2;
      o[2] = t12 + t1;
      o[5] = t12 - t1;
      o[3] = t13 + t0;
      o[4] = t13 - t0;
    };
    auto limit = [](int64_t v) {
      int32_t x = static_cast<int32_t>(v) & 16383;
      if (x >= 8192) x -= 16384;
      return static_cast<uint16_t>(std::min(std::max(x + 2048, 0), 4095));
    };
    int32_t ws[64];                     // ws[row * 8 + col]
    int64_t d[8], o[8];
    for (int col = 0; col < 8; ++col) {
      bool ac_zero = true;
      for (int r = 1; r < 8 && ac_zero; ++r) ac_zero = in[r * 8 + col] == 0;
      if (ac_zero) {
        const int32_t dc = static_cast<int32_t>(
            int64_t{in[col]} * q[col] * (int64_t{1} << kPass1));
        for (int r = 0; r < 8; ++r) ws[r * 8 + col] = dc;
        continue;
      }
      for (int r = 0; r < 8; ++r)
        d[r] = int64_t{in[r * 8 + col]} * q[r * 8 + col];
      dct8(d, o);
      for (int r = 0; r < 8; ++r)
        ws[r * 8 + col] = static_cast<int32_t>(descale(o[r], kConst - kPass1));
    }
    for (int row = 0; row < 8; ++row) {
      const int32_t* w = ws + row * 8;
      uint16_t* dst = out + static_cast<size_t>(row) * stride;
      bool ac_zero = true;
      for (int k = 1; k < 8 && ac_zero; ++k) ac_zero = w[k] == 0;
      if (ac_zero) {
        const uint16_t v = limit(descale(w[0], kPass1 + 3));
        for (int k = 0; k < 8; ++k) dst[k] = v;
        continue;
      }
      for (int k = 0; k < 8; ++k) d[k] = w[k];
      dct8(d, o);
      for (int k = 0; k < 8; ++k)
        dst[k] = limit(descale(o[k], kConst + kPass1 + 3));
    }
  }

  // nrows rows of 12-bit samples as libtiff's JPEGDecode packs what
  // jpeg12_read_scanlines gives: the components interleaved, each pair of
  // samples in three bytes (the first's high eight bits; its low four and
  // the second's high four; the second's low eight), an odd last sample
  // not written (the buffer keeps what it held there)
  void output12(uint8_t* out, int64_t stride, int nrows) {
    const int n = static_cast<int>(comps_.size());
    std::vector<uint16_t> line(static_cast<size_t>(width_) * n);
    const int64_t pairs = int64_t{width_} * n / 2;
    for (int y = 0; y < nrows; ++y) {
      for (int i = 0; i < n; ++i) {
        const Component& c = comps_[i];
        const uint16_t* r = c.plane16.get() + c.stride * y;
        for (int x = 0; x < width_; ++x)
          line[static_cast<size_t>(x) * n + i] = r[x];
      }
      uint8_t* o = out + static_cast<size_t>(y) * stride;
      for (int64_t p = 0; p < pairs; ++p) {
        const int a = line[2 * p], b = line[2 * p + 1];
        o[3 * p] = static_cast<uint8_t>((a & 0xff0) >> 4);
        o[3 * p + 1] = static_cast<uint8_t>((a & 0xf) << 4 | (b & 0xf00) >> 8);
        o[3 * p + 2] = static_cast<uint8_t>(b & 0xff);
      }
    }
  }

  // one upsampled row of component c, for output row y, in dst (at least
  // width_ + 2 samples, apart from the planes); returns where it lies
  const uint8_t* upsample_row(const Component& c, int y,
                              uint8_t* __restrict dst) const {
    auto row = [&](int r) {
      return c.plane.get() + c.stride * std::min(std::max(r, 0), c.dh - 1);
    };
    const int n = c.dw;
    switch (c.up) {
      case Upsample::kFull:
        return row(y);
      case Upsample::kH2V1: {
        const uint8_t* __restrict in = row(y);
        dst[0] = in[0];
        dst[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int i = 1; i < n - 1; ++i) {
          const int v = in[i] * 3;
          dst[2 * i] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
          dst[2 * i + 1] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
        }
        dst[2 * n - 2] =
            static_cast<uint8_t>((in[n - 1] * 3 + in[n - 2] + 1) >> 2);
        dst[2 * n - 1] = in[n - 1];
        return dst;
      }
      case Upsample::kH2V1Box:
      case Upsample::kH2V2Box: {
        const uint8_t* __restrict in =
            row(c.up == Upsample::kH2V1Box ? y : y >> 1);
        for (int i = 0; i < n; ++i) dst[2 * i] = dst[2 * i + 1] = in[i];
        return dst;
      }
      case Upsample::kH1V2: {
        const int r = y >> 1;
        const bool below = y & 1;
        const uint8_t* __restrict near = row(r);
        const uint8_t* __restrict far = row(below ? r + 1 : r - 1);
        const int bias = below ? 2 : 1;
        for (int i = 0; i < n; ++i)
          dst[i] = static_cast<uint8_t>((near[i] * 3 + far[i] + bias) >> 2);
        return dst;
      }
      case Upsample::kH2V2: {
        const int r = y >> 1;
        const uint8_t* __restrict near = row(r);
        const uint8_t* __restrict far = row(y & 1 ? r + 1 : r - 1);
        auto sum = [&](int i) { return near[i] * 3 + far[i]; };
        int last = sum(0), cur = last, next = sum(1);
        dst[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
        dst[1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
        for (int i = 1; i < n - 1; ++i) {
          last = cur;
          cur = next;
          next = sum(i + 1);
          dst[2 * i] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
          dst[2 * i + 1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
        }
        last = cur;
        cur = next;
        dst[2 * n - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
        dst[2 * n - 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
        return dst;
      }
      case Upsample::kInt: {
        const uint8_t* __restrict in = row(y / c.vx);
        const int w = width_, hx = c.hx;
        for (int x = 0; x < w; ++x) dst[x] = in[x / hx];
        return dst;
      }
    }
    return dst;
  }

  // whether libjpeg smooths the blocks of this file (smoothing_ok): it is
  // progressive, every component's quantizers of zigzag 0-9 are nonzero
  // and its DC was sent, and some component's zigzag 1-9 are not known
  // exactly. Latches the precision the blocks are smoothed with.
  bool smoothing_ok() {
    if (!progressive_) return false;
    bool useful = false;
    for (Component& c : comps_) {
      if (!c.latched) return false;
      for (int pos : kSmoothPos)
        if (c.quant[pos] == 0) return false;
      if (c.bits[0] < 0) return false;
      c.latch[0][0] = c.bits[0];
      for (int k = 1; k < 10; ++k) {
        c.latch[1][k] = scan_number_ > 1 ? c.prev_bits[k] : -1;
        c.latch[0][k] = c.bits[k];
        useful = useful || c.bits[k] != 0;
      }
    }
    return useful;
  }

  // the IDCT of component c's blocks, each smoothed first as libjpeg-turbo
  // 2.1 does (decompress_smooth_data): a coefficient of zigzag 1-9 still
  // zero whose precision is not exact is estimated from the DC values of
  // the 5x5 blocks around, clamped below 1 << Al; while no AC of the
  // component is known the DC is estimated too. iMCU rows after the last
  // one decoded with data left read the precision before the component's
  // latest scan. Near the edges the window's rows and columns are filled
  // as libjpeg's conditions and column registers fill them, which is not
  // always the nearest block: the rows two away are clipped by iMCU row
  // (with v 2 they repeat the adjacent row throughout the second and the
  // second-to-last iMCU rows), and in a component two blocks wide the
  // columns right of the second block, and two right of the first, hold
  // the first block's DC. libjpeg-turbo 3.1 (mode 1, its window read off
  // Pillow's output block row by block row) takes the nearest column, and
  // the rows two away by block row: two up where there are two rows
  // above, except in a last iMCU row that is the second and holds one
  // block row; two down within the padded rows (the dummy blocks of an
  // interleaved scan included, zero where no scan sent them), or within
  // the real ones in the last iMCU row.
  void smooth_idct(Component& c) {
    const int last_row = mcu_rows_ - 1, last_col = c.width_in_blocks - 1;
    const int64_t q00 = static_cast<uint16_t>(c.quant[0]);
    alignas(16) int16_t ws[64];
    int dc[5][5];               // the window's DC values
    // Q00 * the weighted window over (Q << 8), rounded half away from
    // zero, its magnitude below 1 << al where al > 0
    auto estimate = [&](const int16_t* w, int64_t q, int al) {
      int64_t num = 0;
      for (int i = 0; i < 25; ++i) num += w[i] * dc[i / 5][i % 5];
      num *= q00;
      int pred = static_cast<int>(
          ((q << 7) + (num < 0 ? -num : num)) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      return static_cast<int16_t>(num < 0 ? -pred : pred);
    };
    for (int r = 0; r <= last_row; ++r) {
      int block_rows = c.v;
      if (r == last_row && c.height_in_blocks % c.v)
        block_rows = c.height_in_blocks % c.v;
      const int* bits = c.latch[r > last_good_row_ ? 1 : 0];
      bool change_dc = true;
      for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
      const int n_ac = change_dc ? 9 : 5;
      for (int br = 0; br < block_rows; ++br) {
        const int row = r * c.v + br;
        const int up = br > 0 || r > 0 ? row - 1 : row;
        const int down = br < block_rows - 1 || r < last_row ? row + 1 : row;
        int up2 = br > 1 || r > 1 ? row - 2 : up;
        int down2 = br < block_rows - 2 || r + 1 < last_row ? row + 2 : down;
        if (turbo3_) {
          up2 = row > 1 && (r != 1 || block_rows > 1) ? row - 2 : up;
          down2 = row + 2 < (r < last_row ? c.bh : c.height_in_blocks)
                      ? row + 2
                      : down;
        }
        const int16_t* rows[5] = {c.block(up2, 0), c.block(up, 0),
                                  c.block(row, 0), c.block(down, 0),
                                  c.block(down2, 0)};
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) dc[i][j] = rows[i][0];
        for (int col = 0; col <= last_col; ++col) {
          std::memcpy(ws, c.block(row, col), sizeof(ws));
          if (turbo3_) {
            // the nearest block, as the rows
            for (int j = 0; j < 5; ++j) {
              const int k = std::min(std::max(col + j - 2, 0), last_col);
              for (int i = 0; i < 5; ++i) dc[i][j] = rows[i][k * 64];
            }
          } else {
            if (col == 0 && col < last_col)
              for (int i = 0; i < 5; ++i) dc[i][3] = rows[i][64];
            if (col + 1 < last_col)
              for (int i = 0; i < 5; ++i) dc[i][4] = rows[i][(col + 2) * 64];
          }
          for (int z = 1; z <= n_ac; ++z) {
            const int pos = kSmoothPos[z], al = bits[z];
            if (al == 0 || ws[pos] != 0) continue;
            ws[pos] = estimate(change_dc ? kSmoothDc[z] : kSmoothAc[z],
                               static_cast<uint16_t>(c.quant[pos]), al);
          }
          if (change_dc) ws[0] = estimate(kSmoothDc[0], q00, 0);
          idct(c, ws, row, col);
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 4; ++j) dc[i][j] = dc[i][j + 1];
        }
      }
    }
  }

  // nrows output rows, stride apart: RGB, or in TIFF mode the components
  // as stored (JCS_UNKNOWN), interleaved
  void output(uint8_t* out, int64_t stride, int nrows) {
    const bool smooth = multiple_scans_ && !lossless_ && smoothing_ok();
    for (Component& c : comps_) {
      if (lossless_) {              // the scans filled the planes
        // libjpeg keeps a lossless image in sample arrays it does not
        // zero: reading one no scan wrote is an error
        if (!c.latched) refuse();
        continue;
      }
      if (!multiple_scans_) break;  // the scan filled the planes
      if (!c.latched) {             // in no scan: its blocks are all zero
        if (p12_) {
          std::fill_n(c.plane16.get(), c.stride * c.bh * 8, 2048);
        } else {
          std::memset(c.plane.get(), 128, c.stride * c.bh * 8);
        }
        continue;
      }
      if (smooth) {
        smooth_idct(c);
      } else {
        for (int row = 0; row < c.height_in_blocks; ++row)
          for (int col = 0; col < c.width_in_blocks; ++col)
            idct(c, c.block(row, col), row, col);
      }
      std::vector<int16_t>().swap(c.coef);
    }
    const int n = static_cast<int>(comps_.size());
    if (p12_) {
      output12(out, stride, nrows);
      return;
    }
    std::vector<uint8_t> bufs(static_cast<size_t>(n) * (width_ + 16));
    for (int y = 0; y < nrows; ++y) {
      const uint8_t* rows[kMaxComponents];
      for (int i = 0; i < n; ++i)
        rows[i] = upsample_row(comps_[i], y,
                               bufs.data() + static_cast<size_t>(i) *
                                                 (width_ + 16));
      // locals and __restrict: stores through uint8_t* may otherwise
      // alias every member and table the loop reads
      const int w = width_;
      uint8_t* __restrict o = out + static_cast<size_t>(y) * stride;
      if (color_ == kUnknown) {
        for (int i = 0; i < n; ++i) {
          const uint8_t* __restrict r = rows[i];
          for (int x = 0; x < w; ++x) o[n * x + i] = r[x];
        }
        continue;
      }
      const uint8_t* __restrict r0 = rows[0];
      if (color_ == kGray) {
        for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] =
            o[3 * x + 2] = r0[x];
        continue;
      }
      const uint8_t* __restrict r1 = rows[1];
      const uint8_t* __restrict r2 = rows[2];
      if (color_ == kCMYK || color_ == kYCCK) {
        cmyk_row(r0, r1, r2, rows[3], o, w, color_ == kYCCK);
        continue;
      }
      if (color_ == kRGB) {
        for (int x = 0; x < w; ++x) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        continue;
      }
      for (int x = 0; x < w; ++x) {
        const int yy = r0[x], cb = r1[x] - 128, cr = r2[x] - 128;
        o[3 * x] = clamp255(yy + ((kCrR * cr + kHalf16) >> 16));
        o[3 * x + 1] =
            clamp255(yy + ((kHalf16 - kCbG * cb - kCrG * cr) >> 16));
        o[3 * x + 2] = clamp255(yy + ((kCbB * cb + kHalf16) >> 16));
      }
    }
  }

  // One row of a four-component file to Pillow's RGB: libjpeg's CMYK
  // output (YCCK first converted as jdcolor.c's ycck_cmyk_convert: 255
  // less each RGB of the YCbCr, clamped), read by Pillow as inverted
  // ("CMYK;I"), then Pillow's CMYK -> RGB: each channel 255 - k less
  // MULDIV255(c, 255 - k), with MULDIV255(a, b) = (t + (t >> 8)) >> 8,
  // t = a * b + 128.
  static void cmyk_row(const uint8_t* __restrict p0,
                       const uint8_t* __restrict p1,
                       const uint8_t* __restrict p2,
                       const uint8_t* __restrict p3, uint8_t* __restrict o,
                       int w, bool ycck) {
    auto rgb = [](int c, int k) {     // libjpeg's c and k: Pillow's 255 - c
      const int t = (255 - c) * k + 128;
      return static_cast<uint8_t>(k - (((t >> 8) + t) >> 8));
    };
    for (int x = 0; x < w; ++x) {
      int c = p0[x], m = p1[x], yy = p2[x];
      const int k = p3[x];
      if (ycck) {
        const int y = c, cb = m - 128, cr = yy - 128;
        c = clamp255(255 - (y + ((kCrR * cr + kHalf16) >> 16)));
        m = clamp255(255 - (y + ((kHalf16 - kCbG * cb - kCrG * cr) >> 16)));
        yy = clamp255(255 - (y + ((kCbB * cb + kHalf16) >> 16)));
      }
      o[3 * x] = rgb(c, k);
      o[3 * x + 1] = rgb(m, k);
      o[3 * x + 2] = rgb(yy, k);
    }
  }

  enum Color { kGray, kYCC, kRGB, kCMYK, kYCCK, kUnknown };

  const uint8_t* buf_;
  int64_t len_;
  bool turbo3_;                 // libjpeg-turbo 3.1's decode (modes 1, 2)
  bool suspend_;                // Pillow's source: a cut image refused
  bool cmyk_;                   // jpeg_color_space set to JCS_CMYK
  bool tiff_;                   // libtiff's codec: the colour space set
  bool ojpeg_;                  // libtiff's old-style codec's source
  bool tiff_rgb_ = false;
  bool complete_ = false;       // the image is whole (Pillow keeps it)
  bool lossless_ = false;
  bool p12_ = false;            // a 12-bit frame (libtiff's codec only)
  bool fail_past_end_ = false;  // the source fails past its end
  int imcu_done_ = 0;           // iMCU rows of the single scan decoded
  int64_t pos_ = 0;
  int unread_marker_ = 0;
  bool saw_soi_ = false, saw_sof_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  int restart_interval_ = 0, restarts_to_go_ = 0, next_restart_num_ = 0;
  Tables own_;
  Tables& t_;
  // frame
  bool progressive_ = false, arithmetic_ = false, multiple_scans_ = false;
  int precision_ = 0, height_ = 0, width_ = 0, max_h_ = 1, max_v_ = 1;
  int mcus_per_row_ = 0, mcu_rows_ = 0;
  std::vector<Component> comps_;
  Color color_ = kYCC;
  // scan
  int scan_n_ = 0, scan_[4] = {-1, -1, -1, -1};
  int ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
  int mcu_blocks_ = 0, member_[kMaxBlocksInMCU] = {};
  HuffDecoder dc_dec_[4], ac_dec_[4];
  int32_t dc_pred_[4] = {};
  int eobrun_ = 0;
  bool insufficient_ = false;
  uint64_t bit_buffer_ = 0;
  int bits_left_ = 0;
  int scan_number_ = 0, last_good_row_ = 0;
  // arithmetic coding: conditioning (DAC), statistics, registers
  uint8_t dc_l_[16] = {}, dc_u_[16] = {}, ac_k_[16] = {};
  uint8_t dc_stats_[16][64] = {}, ac_stats_[16][256] = {};
  uint8_t fixed_bin_ = kFixedBin;
  int dc_context_[4] = {};
  int64_t c_ = 0, a_ = 0;
  int ct_ = 0;
};

// -- libtiff 4.7.1's old-style JPEG codec (tif_ojpeg.c) -----------------
// Compression 6: the TIFF holds no JPEG streams of its own, but the
// pieces of one. OJpeg reads its header, as OJPEGReadHeaderInfoSec does,
// from the stream at JPEGInterchangeFormat and on into the strips (or
// tiles) in turn, or, where no SOF is found there, builds it from the
// JPEGQTables, JPEGDCTables and JPEGACTables tags. It then writes the
// stream libjpeg reads (OJPEGWriteStream): SOI, the tables, DRI, SOF and
// SOS as kept, then the bytes after the SOS read on through the strips,
// an RST marker after each strip but the last, and EOI; where the strips
// run out first the source fails. The whole image (one plane) is one
// JPEG frame, one strile wide; each strip or tile is the next rows of it.
// Its sessions (OJPEGPreDecode, OJPEGDecode, OJPEGPostDecode) are
// followed read by read: a session decodes forward, skipping the striles
// not asked for, and starts again from the SOS where a read goes back or
// to another plane. YCbCr in one plane (three samples) comes out as
// libjpeg's raw data, repacked into libtiff's sampling blocks
// (OJPEGDecodeRaw); other files as scanlines of the components as stored
// (OJPEGDecodeScanlines).

// the parameters tiff_ojpeg_* take (int64 each): the file's size, the
// tags as libtiff's directory holds them (0 where not set), the strile
// geometry
enum OjParam {
  kOjFileSize, kOjJif, kOjJifLength, kOjQ, kOjDc = kOjQ + 3,
  kOjAc = kOjDc + 3, kOjRestart = kOjAc + 3, kOjWidth, kOjLength, kOjTiled,
  kOjStrileWidth, kOjStrileLength, kOjSpp, kOjPlanar, kOjPhotometric,
  kOjSubH, kOjSubV, kOjStripsPerImage, kOjStrileArrays,
  kOjParams
};

class OJpeg {
 public:
  OJpeg(const uint8_t* data, const int64_t* p, const int64_t* offsets,
        const int64_t* counts, int64_t nstriles)
      : data_(data), offsets_(offsets), counts_(counts), nstriles_(nstriles) {
    file_size_ = static_cast<uint64_t>(p[kOjFileSize]);
    jif_ = static_cast<uint64_t>(p[kOjJif]);
    jif_length_ = static_cast<uint64_t>(p[kOjJifLength]);
    for (int i = 0; i < 3; ++i) {
      q_off_[i] = static_cast<uint64_t>(p[kOjQ + i]);
      dc_off_[i] = static_cast<uint64_t>(p[kOjDc + i]);
      ac_off_[i] = static_cast<uint64_t>(p[kOjAc + i]);
    }
    restart_interval_ = static_cast<uint16_t>(p[kOjRestart]);
    image_width_ = static_cast<uint32_t>(p[kOjWidth]);
    image_length_ = static_cast<uint32_t>(p[kOjLength]);
    tiled_ = p[kOjTiled] != 0;
    tag_strile_width_ = static_cast<uint32_t>(p[kOjStrileWidth]);
    tag_strile_length_ = static_cast<uint32_t>(p[kOjStrileLength]);
    td_spp_ = static_cast<int>(p[kOjSpp]);
    planar_ = static_cast<int>(p[kOjPlanar]);
    photometric_ = static_cast<int>(p[kOjPhotometric]);
    hor_ = static_cast<uint8_t>(p[kOjSubH]);
    ver_ = static_cast<uint8_t>(p[kOjSubV]);
    strips_per_image_ = static_cast<uint32_t>(p[kOjStripsPerImage]);
    strile_arrays_ = p[kOjStrileArrays] != 0;
  }

  // OJPEGSubsamplingCorrect: the subsampling TIFFGetField reports, read
  // from the first SOF where the file is YCbCr (or ITU L*a*b*) of three
  // samples; (1, 1) where libjpeg is to upsample inside
  void subsampling_correct() {
    if (correct_done_) return;
    if (td_spp_ != 3 || (photometric_ != 6 && photometric_ != 10)) {
      hor_ = ver_ = 1;
      force_ = false;
    } else {
      correct_ = true;
      read_header_info_sec();
      if (force_) hor_ = ver_ = 1;
      correct_ = false;
    }
    correct_done_ = true;
  }
  int hor() const { return hor_; }
  int ver() const { return ver_; }

  // TIFFReadEncodedStrip/Tile of strile m (plane s) into buf, cc bytes:
  // 0 decoded; 1 the decode failed (OJPEGDecode zeroes cc bytes); 2
  // OJPEGPreDecode failed (TIFFFillStrip fails: cc bytes zeroed)
  int read(uint32_t m, int s, uint8_t* buf, int64_t cc) {
    if (!pre_decode(m, s)) {
      std::memset(buf, 0, static_cast<size_t>(cc));
      return 2;
    }
    if (!decode(buf, cc)) {
      std::memset(buf, 0, static_cast<size_t>(cc));
      return 1;
    }
    // OJPEGPostDecode: a whole strile was read
    ++write_curstrile_;
    if (write_curstrile_ % strips_per_image_ == 0) {
      session_abort();
      writeheader_done_ = false;
    }
    return 0;
  }

 private:
  enum Source { kNotSetYet, kJif, kStrile, kEof };
  struct SosEnd {
    bool log = false;
    Source source = kNotSetYet;
    uint32_t next_strile = 0;
    uint64_t file_pos = 0, file_togo = 0;
  };

  // -- the input buffer (OJPEGReadBufferFill and its readers) --------------
  // in_buffer: the bytes of the current source not yet read, from pos_
  bool buffer_fill() {
    for (;;) {
      if (file_togo_ != 0) {
        cur_ = file_pos_;
        togo_ = file_togo_;
        file_pos_ += file_togo_;
        file_togo_ = 0;
        return true;
      }
      switch (source_) {
        case kNotSetYet:
          if (jif_ != 0) {
            file_pos_ = jif_;
            file_togo_ = jif_length_;
          }
          source_ = kJif;
          break;
        case kJif:
          source_ = kStrile;
          break;
        case kStrile:
          if (next_strile_ == nstriles_) {
            source_ = kEof;
          } else {
            // a strile array the directory lacks: its read fails
            if (!strile_arrays_) return false;
            file_pos_ = static_cast<uint64_t>(offsets_[next_strile_]);
            if (file_pos_ != 0) {
              const uint64_t count =
                  static_cast<uint64_t>(counts_[next_strile_]);
              if (file_pos_ >= file_size_) {
                file_pos_ = 0;
              } else if (count == 0) {
                file_togo_ = file_size_ - file_pos_;
              } else {
                file_togo_ = count;
                if (file_pos_ + file_togo_ > file_size_ ||
                    file_pos_ > UINT64_MAX - file_togo_)
                  file_togo_ = file_size_ - file_pos_;
              }
            }
            ++next_strile_;
          }
          break;
        default:
          return false;
      }
    }
  }
  bool read_byte(uint8_t* b) {
    if (togo_ == 0 && !buffer_fill()) return false;
    *b = data_[cur_++];
    --togo_;
    return true;
  }
  bool peek_byte(uint8_t* b) {
    if (togo_ == 0 && !buffer_fill()) return false;
    *b = data_[cur_];
    return true;
  }
  bool read_word(uint16_t* w) {
    uint8_t a, b;
    if (!read_byte(&a) || !read_byte(&b)) return false;
    *w = static_cast<uint16_t>(a << 8 | b);
    return true;
  }
  bool read_block(uint16_t len, uint8_t* mem) {
    while (len > 0) {
      if (togo_ == 0 && !buffer_fill()) return false;
      const uint16_t n = static_cast<uint16_t>(std::min<uint64_t>(len, togo_));
      std::memcpy(mem, data_ + cur_, n);
      cur_ += n;
      togo_ -= n;
      len = static_cast<uint16_t>(len - n);
      mem += n;
    }
    return true;
  }
  // a skip stops at the end of the current source
  void read_skip(uint16_t len) {
    uint64_t n = std::min<uint64_t>(len, togo_);
    cur_ += n;
    togo_ -= n;
    uint64_t m = len - n;
    if (m > 0) {
      m = std::min(m, file_togo_);
      file_pos_ += m;
      file_togo_ -= m;
    }
  }
  // the position after the bytes read: the in_buffer's unread bytes put
  // back into the file's
  void save(SosEnd* e) const {
    e->log = true;
    e->source = source_;
    e->next_strile = next_strile_;
    e->file_pos = file_pos_ - togo_;
    e->file_togo = file_togo_ + togo_;
  }
  void restore(const SosEnd& e) {
    source_ = e.source;
    next_strile_ = e.next_strile;
    file_pos_ = e.file_pos;
    file_togo_ = e.file_togo;
    togo_ = 0;
  }

  // -- the header (OJPEGReadHeaderInfo and OJPEGReadHeaderInfoSec*) --------
  bool read_header_info() {
    strile_width_ = tiled_ ? tag_strile_width_ : image_width_;
    if (tiled_) {
      strile_length_ = tag_strile_length_;
      strile_length_total_ =
          strile_length_ ? static_cast<uint32_t>(
                               (uint64_t{image_length_} + strile_length_ - 1) /
                               strile_length_ * strile_length_)
                         : 0;
    } else {
      strile_length_ = tag_strile_length_;
      if (strile_length_ == UINT32_MAX) strile_length_ = image_length_;
      strile_length_total_ = image_length_;
    }
    if (td_spp_ == 1) {
      spp_ = 1;
      spp_per_plane_ = 1;
      hor_ = ver_ = 1;
    } else {
      if (td_spp_ != 3) return false;
      spp_ = 3;
      spp_per_plane_ = planar_ == 1 ? 3 : 1;
    }
    plane_offset_ = 0;
    if (strile_length_ < image_length_) {
      if ((hor_ != 1 && hor_ != 2 && hor_ != 4) ||
          (ver_ != 1 && ver_ != 2 && ver_ != 4))
        return false;
      if (strile_length_ % (ver_ * 8) != 0) return false;
      restart_interval_ = static_cast<uint16_t>(
          (uint64_t{strile_width_} + hor_ * 8 - 1) / (hor_ * 8) *
          (strile_length_ / (ver_ * 8)));
    }
    if (!read_header_info_sec()) return false;
    save(&sos_end_[0]);
    readheader_done_ = true;
    return true;
  }

  bool read_header_info_sec() {
    if (jif_ != 0) {
      if (jif_ >= file_size_) {
        jif_ = jif_length_ = 0;
      } else if (jif_length_ == 0 || jif_ > UINT64_MAX - jif_length_ ||
                 jif_ + jif_length_ > file_size_) {
        jif_length_ = file_size_ - jif_;
      }
    }
    source_ = kNotSetYet;
    next_strile_ = 0;
    file_togo_ = 0;
    togo_ = 0;
    uint8_t m;
    do {
      if (!peek_byte(&m)) return false;
      if (m != 255) break;
      ++cur_;
      --togo_;
      do {
        if (!read_byte(&m)) return false;
      } while (m == 255);
      switch (m) {
        case kSOI:
          break;
        case kDRI:
          if (!stream_dri()) return false;
          break;
        case kDQT:
          if (!stream_dqt()) return false;
          break;
        case kDHT:
          if (!stream_dht()) return false;
          break;
        case kSOF0:
        case kSOF1:
        case kSOF3:
          if (!stream_sof(m)) return false;
          if (correct_) return true;
          break;
        case kSOS:
          if (correct_) return true;
          if (!stream_sos()) return false;
          break;
        default:
          if (m == kCOM || (m >= kAPP0 && m <= kAPP15)) {
            uint16_t n;
            if (!read_word(&n) || n < 2) return false;
            if (n > 2) read_skip(static_cast<uint16_t>(n - 2));
            break;
          }
          return false;   // "Unknown marker type"
      }
    } while (m != kSOS);
    if (correct_) return true;
    if (!sof_log_) {
      if (!tables_q()) return false;
      sof_marker_ = kSOF0;
      for (int o = 0; o < spp_; ++o) sof_c_[o] = static_cast<uint8_t>(o);
      sof_hv_[0] = static_cast<uint8_t>(hor_ << 4 | ver_);
      for (int o = 1; o < spp_; ++o) sof_hv_[o] = 17;
      sof_x_ = strile_width_;
      sof_y_ = strile_length_total_;
      sof_log_ = true;
      if (!tables_huff(false) || !tables_huff(true)) return false;
      for (int o = 1; o < spp_; ++o) sos_cs_[o] = static_cast<uint8_t>(o);
    }
    return true;
  }

  bool stream_dri() {
    uint16_t m;
    if (!read_word(&m) || m != 4 || !read_word(&m)) return false;
    restart_interval_ = m;
    return true;
  }

  bool stream_dqt() {
    uint16_t m;
    if (!read_word(&m) || m <= 2) return false;
    if (correct_) {
      read_skip(static_cast<uint16_t>(m - 2));
      return true;
    }
    m = static_cast<uint16_t>(m - 2);
    do {
      if (m < 65) return false;
      std::vector<uint8_t> nb = {0xFF, kDQT, 0, 67};
      nb.resize(69);
      if (!read_block(65, nb.data() + 4)) return false;
      const int o = nb[4] & 15;
      if (o > 3) return false;
      qtable_[o] = std::move(nb);
      m = static_cast<uint16_t>(m - 65);
    } while (m > 0);
    return true;
  }

  bool stream_dht() {
    uint16_t m;
    if (!read_word(&m) || m <= 2) return false;
    if (correct_) {
      read_skip(static_cast<uint16_t>(m - 2));
      return true;
    }
    std::vector<uint8_t> nb = {0xFF, kDHT, static_cast<uint8_t>(m >> 8),
                               static_cast<uint8_t>(m & 255)};
    nb.resize(static_cast<size_t>(m) + 2);
    if (!read_block(static_cast<uint16_t>(m - 2), nb.data() + 4)) return false;
    int o = nb[4];
    if ((o & 240) == 0) {
      if (o > 3) return false;
      dctable_[o] = std::move(nb);
    } else {
      if ((o & 240) != 16) return false;
      o &= 15;
      if (o > 3) return false;
      actable_[o] = std::move(nb);
    }
    return true;
  }

  bool stream_sof(int marker) {
    if (sof_log_) return false;
    if (!correct_) sof_marker_ = marker;
    uint16_t m;
    if (!read_word(&m) || m < 11) return false;
    m = static_cast<uint16_t>(m - 8);
    if (m % 3 != 0) return false;
    const int n = m / 3;
    if (!correct_ && n != spp_) return false;
    uint8_t o;
    if (!read_byte(&o) || o != 8) return false;
    if (correct_) {
      read_skip(4);
    } else {
      uint16_t p;
      if (!read_word(&p)) return false;
      if (p < image_length_ && p < strile_length_total_) return false;
      sof_y_ = p;
      if (!read_word(&p)) return false;
      if (p < image_width_ && p < strile_width_) return false;
      if (p > strile_width_) return false;
      sof_x_ = p;
    }
    if (!read_byte(&o) || o != n) return false;
    for (int q = 0; q < n; ++q) {
      if (!read_byte(&o)) return false;
      if (!correct_) sof_c_[q] = o;
      if (!read_byte(&o)) return false;
      if (correct_) {
        if (q == 0) {
          hor_ = static_cast<uint8_t>(o >> 4);
          ver_ = static_cast<uint8_t>(o & 15);
          if ((hor_ != 1 && hor_ != 2 && hor_ != 4) ||
              (ver_ != 1 && ver_ != 2 && ver_ != 4))
            force_ = true;
        } else if (o != 17) {
          force_ = true;
        }
      } else {
        sof_hv_[q] = o;
        if (!force_) {
          if (q == 0 ? o != (hor_ << 4 | ver_) : o != 17) return false;
        }
      }
      if (!read_byte(&o)) return false;
      if (!correct_) sof_tq_[q] = o;
    }
    if (!correct_) sof_log_ = true;
    return true;
  }

  bool stream_sos() {
    if (!sof_log_) return false;
    uint16_t m;
    if (!read_word(&m) || m != 6 + spp_per_plane_ * 2) return false;
    uint8_t n;
    if (!read_byte(&n) || n != spp_per_plane_) return false;
    for (int o = 0; o < spp_per_plane_; ++o) {
      if (!read_byte(&n)) return false;
      sos_cs_[plane_offset_ + o] = n;
      if (!read_byte(&n)) return false;
      sos_tda_[plane_offset_ + o] = n;
    }
    read_skip(3);
    return true;
  }

  // the file's bytes [at, at + n), where they all lie in it
  bool file_read(uint64_t at, uint64_t n, uint8_t* out) const {
    if (at > file_size_ || n > file_size_ - at) return false;
    std::memcpy(out, data_ + at, n);
    return true;
  }

  // OJPEGReadHeaderInfoSecTablesQTable
  bool tables_q() {
    if (q_off_[0] == 0) return false;
    for (int m = 0; m < spp_; ++m) {
      if (q_off_[m] != 0 && (m == 0 || q_off_[m] != q_off_[m - 1])) {
        for (int n = 0; n < m - 1; ++n)
          if (q_off_[m] == q_off_[n]) return false;
        std::vector<uint8_t> ob = {0xFF, kDQT, 0, 67, static_cast<uint8_t>(m)};
        ob.resize(69);
        if (!file_read(q_off_[m], 64, ob.data() + 5)) return false;
        qtable_[m] = std::move(ob);
        sof_tq_[m] = static_cast<uint8_t>(m);
      } else {
        sof_tq_[m] = sof_tq_[m - 1];
      }
    }
    return true;
  }

  // OJPEGReadHeaderInfoSecTablesDcTable and AcTable
  bool tables_huff(bool ac) {
    const uint64_t* off = ac ? ac_off_ : dc_off_;
    if (off[0] == 0) return false;
    for (int m = 0; m < spp_; ++m) {
      if (off[m] != 0 && (m == 0 || off[m] != off[m - 1])) {
        for (int n = 0; n < m - 1; ++n)
          if (off[m] == off[n]) return false;
        uint8_t o[16];
        if (!file_read(off[m], 16, o)) return false;
        uint32_t q = 0;
        for (int n = 0; n < 16; ++n) q += o[n];
        std::vector<uint8_t> rb = {0xFF, kDHT,
                                   static_cast<uint8_t>((19 + q) >> 8 & 255),
                                   static_cast<uint8_t>((19 + q) & 255),
                                   static_cast<uint8_t>(ac ? 16 | m : m)};
        rb.insert(rb.end(), o, o + 16);
        rb.resize(21 + q);
        if (!file_read(off[m] + 16, q, rb.data() + 21)) return false;
        if (ac) {
          actable_[m] = std::move(rb);
          sos_tda_[m] = static_cast<uint8_t>(sos_tda_[m] | m);
        } else {
          dctable_[m] = std::move(rb);
          sos_tda_[m] = static_cast<uint8_t>(m << 4);
        }
      } else if (ac) {
        sos_tda_[m] =
            static_cast<uint8_t>(sos_tda_[m] | (sos_tda_[m - 1] & 15));
      } else {
        sos_tda_[m] = sos_tda_[m - 1];
      }
    }
    return true;
  }

  // OJPEGReadSecondarySos: plane s's SOS, found by scanning on from the
  // previous plane's
  bool read_secondary_sos(int s) {
    plane_offset_ = s - 1;
    while (!sos_end_[plane_offset_].log) --plane_offset_;
    restore(sos_end_[plane_offset_]);
    while (plane_offset_ < s) {
      uint8_t m;
      for (;;) {
        if (!read_byte(&m)) return false;
        if (m == 255) {
          do {
            if (!read_byte(&m)) return false;
          } while (m == 255);
          if (m == kSOS) break;
        }
      }
      ++plane_offset_;
      if (!stream_sos()) return false;
      save(&sos_end_[plane_offset_]);
    }
    return true;
  }

  // -- sessions (OJPEGPreDecode, OJPEGWriteHeaderInfo, OJPEGWriteStream) ---
  bool pre_decode(uint32_t m, int s) {
    subsampling_correct();
    if (!readheader_done_ && !read_header_info()) return false;
    if (s > 2) return false;
    if (!sos_end_[s].log && !read_secondary_sos(s)) {
      // the scan read the input buffer the open session's libjpeg reads
      // on from to its end: that session gets no more data
      if (writeheader_done_) starve();
      return false;
    }
    if (writeheader_done_ && (write_cursample_ != s || write_curstrile_ > m)) {
      session_abort();
      writeheader_done_ = false;
    }
    if (!writeheader_done_) {
      plane_offset_ = s;
      write_cursample_ = s;
      write_curstrile_ = static_cast<uint32_t>(s) * strips_per_image_;
      restore(sos_end_[s]);
      if (!write_header_info()) return false;
    }
    state_ = 0;
    while (write_curstrile_ < m) {
      if (raw_) {
        if (!skip_raw()) return false;
      } else {
        for (uint32_t k = 0; k < lines_per_strile_; ++k)
          if (!read_scanline(nullptr)) return false;
      }
      ++write_curstrile_;
    }
    return true;
  }

  void session_abort() {
    session_active_ = false;
    dec_.reset();
  }

  // the open session reads no more input: what libjpeg has decoded stays
  // (the raw rows read, the scanlines of the iMCU row it holds), the rest
  // fails
  void starve() {
    const int held = raw_ ? next_imcu_
                          : (scanline_ + 8 * dec_->max_v() - 1) /
                                (8 * dec_->max_v());
    good_rows_ = std::min(good_rows_, held);
  }

  // the stream OJPEGWriteStream feeds libjpeg from the SOS on; fail_at_end:
  // the strips ran out before the last one (OJPEGReadBufferFill fails)
  std::vector<uint8_t> write_stream(bool* fail_at_end) {
    std::vector<uint8_t> out = {0xFF, kSOI};
    for (const auto* tabs : {&qtable_, &dctable_, &actable_})
      for (const std::vector<uint8_t>& t : *tabs)
        out.insert(out.end(), t.begin(), t.end());
    if (restart_interval_ != 0) {
      const uint8_t dri[6] = {0xFF, kDRI, 0, 4,
                              static_cast<uint8_t>(restart_interval_ >> 8),
                              static_cast<uint8_t>(restart_interval_ & 255)};
      out.insert(out.end(), dri, dri + 6);
    }
    const int n = spp_per_plane_, pso = plane_offset_;
    out.insert(out.end(), {0xFF, static_cast<uint8_t>(sof_marker_), 0,
                           static_cast<uint8_t>(8 + n * 3), 8,
                           static_cast<uint8_t>(sof_y_ >> 8 & 255),
                           static_cast<uint8_t>(sof_y_ & 255),
                           static_cast<uint8_t>(sof_x_ >> 8 & 255),
                           static_cast<uint8_t>(sof_x_ & 255),
                           static_cast<uint8_t>(n)});
    for (int m = 0; m < n; ++m)
      out.insert(out.end(), {sof_c_[pso + m], sof_hv_[pso + m],
                             sof_tq_[pso + m]});
    out.insert(out.end(), {0xFF, kSOS, 0, static_cast<uint8_t>(6 + n * 2),
                           static_cast<uint8_t>(n)});
    for (int m = 0; m < n; ++m)
      out.insert(out.end(), {sos_cs_[pso + m], sos_tda_[pso + m]});
    out.insert(out.end(), {0, 63, 0});
    // the compressed data (OJPEGWriteStreamCompressed, Rst, Eoi)
    int restart_index = 0;
    *fail_at_end = false;
    for (;;) {
      if (togo_ == 0 && !buffer_fill()) {
        *fail_at_end = true;
        break;
      }
      out.insert(out.end(), data_ + cur_, data_ + cur_ + togo_);
      cur_ += togo_;
      togo_ = 0;
      if (file_togo_ != 0) continue;
      if (source_ == kStrile) {
        if (next_strile_ < nstriles_) {
          out.insert(out.end(), {0xFF, static_cast<uint8_t>(kRST0 +
                                                            restart_index)});
          restart_index = (restart_index + 1) & 7;
          continue;
        }
        out.insert(out.end(), {0xFF, kEOI});
        break;
      }
      if (source_ == kEof) {
        out.insert(out.end(), {0xFF, kEOI});
        break;
      }
    }
    return out;
  }

  bool write_header_info() {
    if (session_active_) return false;   // a failed session is not retried
    bool fail_at_end;
    stream_ = write_stream(&fail_at_end);
    session_active_ = true;
    raw_ = !force_ && spp_per_plane_ > 1;
    dec_.reset(new Decoder(stream_.data(), static_cast<int64_t>(stream_.size()),
                           Mode::kOJpeg));
    try {
      if (raw_) {
        if (hor_ == 0 || ver_ == 0) return false;
        if (!convert_log_) {
          ylinelen_ = (int64_t{strile_width_} + hor_ * 8 - 1) / (hor_ * 8) *
                      hor_ * 8;
          clinelen_ = ylinelen_ / hor_;
          // calloc'd once for the file, not zeroed again
          ybuf_.assign(static_cast<size_t>(ylinelen_) * ver_ * 8, 0);
          cbuf_.assign(static_cast<size_t>(clinelen_) * 8 * 2, 0);
          clinelenout_ = strile_width_ / hor_ + (strile_width_ % hor_ != 0);
          bytes_per_line_ = clinelenout_ * (hor_ * ver_ + 2);
          lines_per_strile_ = strile_length_ / ver_ +
                              (strile_length_ % ver_ != 0);
          error_in_raw_ = false;
          convert_log_ = true;
        }
      } else {
        bytes_per_line_ = int64_t{spp_per_plane_} * strile_width_;
        lines_per_strile_ = strile_length_;
      }
      dec_->ojpeg_start(fail_at_end);
    } catch (const Refused&) {
      return false;
    } catch (const std::bad_alloc&) {
      return false;
    }
    if (static_cast<uint32_t>(dec_->width()) != strile_width_) return false;
    if (dec_->max_h() != hor_ || dec_->max_v() != ver_) return false;
    try {
      good_rows_ = dec_->ojpeg_decode();
    } catch (const std::bad_alloc&) {
      good_rows_ = 0;
    }
    next_imcu_ = 0;
    scanline_ = 0;
    writeheader_done_ = true;
    return true;
  }

  // jpeg_read_raw_data of the next iMCU row: past the image's last it
  // reads nothing (a warning), the buffers left as they were
  bool read_raw() {
    if (next_imcu_ >= dec_->imcu_rows()) return true;
    if (next_imcu_ >= good_rows_) return false;
    uint8_t* bufs[3] = {ybuf_.data(), cbuf_.data(),
                        cbuf_.data() + clinelen_ * 8};
    const int64_t linelen[3] = {ylinelen_, clinelen_, clinelen_};
    dec_->ojpeg_raw(next_imcu_, bufs, linelen);
    ++next_imcu_;
    return true;
  }

  // jpeg_read_scanlines of one row into dst (nullptr: a skip buffer);
  // past the image's last row it writes nothing
  bool read_scanline(uint8_t* dst) {
    if (scanline_ >= dec_->height()) return true;
    if (dec_->ojpeg_row_needs(scanline_) >= good_rows_) return false;
    std::vector<uint8_t>& bufs = row_bufs_;
    bufs.resize(static_cast<size_t>(spp_per_plane_) * (dec_->width() + 16));
    if (dst) {
      dec_->ojpeg_row(scanline_, dst, bufs.data());
    }
    ++scanline_;
    return true;
  }

  // OJPEGPreDecodeSkipRaw
  bool skip_raw() {
    uint32_t m = lines_per_strile_;
    if (state_ != 0) {
      if (8 - state_ >= m) {
        state_ += m;
        if (state_ == 8) state_ = 0;
        return true;
      }
      m -= 8 - state_;
      state_ = 0;
      error_in_raw_ = false;
    }
    while (m >= 8) {
      if (!read_raw()) return false;
      m -= 8;
    }
    if (m > 0) {
      if (!read_raw()) return false;
      state_ = m;
    }
    return true;
  }

  // OJPEGDecode: OJPEGDecodeRaw or OJPEGDecodeScanlines
  bool decode(uint8_t* buf, int64_t cc) {
    if (!session_active_) return false;
    if (raw_ && error_in_raw_) return false;
    if (bytes_per_line_ == 0 || cc % bytes_per_line_ != 0) return false;
    uint8_t* p = buf;
    for (int64_t left = cc; left > 0; left -= bytes_per_line_) {
      if (!raw_) {
        if (!read_scanline(p)) return false;
        p += bytes_per_line_;
        continue;
      }
      if (state_ == 0 && !read_raw()) {
        error_in_raw_ = true;
        return false;
      }
      const uint8_t* oy = ybuf_.data() + state_ * ver_ * ylinelen_;
      const uint8_t* ocb = cbuf_.data() + state_ * clinelen_;
      const uint8_t* ocr = cbuf_.data() + clinelen_ * 8 + state_ * clinelen_;
      uint8_t* o = p;
      for (int64_t q = 0; q < clinelenout_; ++q) {
        const uint8_t* r = oy;
        for (int sy = 0; sy < ver_; ++sy) {
          for (int sx = 0; sx < hor_; ++sx) *o++ = *r++;
          r += ylinelen_ - hor_;
        }
        oy += hor_;
        *o++ = *ocb++;
        *o++ = *ocr++;
      }
      if (++state_ == 8) state_ = 0;
      p += bytes_per_line_;
    }
    return true;
  }

  // the file
  const uint8_t* data_;
  const int64_t* offsets_;
  const int64_t* counts_;
  int64_t nstriles_;
  uint64_t file_size_ = 0, jif_ = 0, jif_length_ = 0;
  uint64_t q_off_[3] = {}, dc_off_[3] = {}, ac_off_[3] = {};
  uint32_t image_width_ = 0, image_length_ = 0;
  bool tiled_ = false;
  uint32_t tag_strile_width_ = 0, tag_strile_length_ = 0;
  int td_spp_ = 0, planar_ = 1, photometric_ = 0;
  uint32_t strips_per_image_ = 1;
  bool strile_arrays_ = true;
  // OJPEGState
  bool force_ = false, correct_ = false;
  bool correct_done_ = false, readheader_done_ = false;
  uint8_t hor_ = 2, ver_ = 2;
  uint16_t restart_interval_ = 0;
  uint32_t strile_width_ = 0, strile_length_ = 0, strile_length_total_ = 0;
  int spp_ = 0, spp_per_plane_ = 0, plane_offset_ = 0;
  bool sof_log_ = false;
  int sof_marker_ = 0;
  uint8_t sof_c_[3] = {}, sof_hv_[3] = {}, sof_tq_[3] = {};
  uint8_t sos_cs_[3] = {}, sos_tda_[3] = {};
  uint32_t sof_x_ = 0, sof_y_ = 0;
  std::vector<uint8_t> qtable_[4], dctable_[4], actable_[4];
  SosEnd sos_end_[3];
  // the input buffer
  Source source_ = kNotSetYet;
  uint32_t next_strile_ = 0;
  uint64_t file_pos_ = 0, file_togo_ = 0, cur_ = 0, togo_ = 0;
  // the session
  bool writeheader_done_ = false, session_active_ = false;
  int write_cursample_ = 0;
  uint32_t write_curstrile_ = 0;
  std::vector<uint8_t> stream_;
  std::unique_ptr<Decoder> dec_;
  bool raw_ = false, error_in_raw_ = false, convert_log_ = false;
  int good_rows_ = 0, next_imcu_ = 0, scanline_ = 0;
  uint32_t state_ = 0, lines_per_strile_ = 0;
  int64_t ylinelen_ = 0, clinelen_ = 0, clinelenout_ = 0, bytes_per_line_ = 0;
  std::vector<uint8_t> ybuf_, cbuf_, row_bufs_;
};

Mode api_mode(int mode) {
  return mode == 0 ? Mode::kTurbo21
                   : mode == 3 ? Mode::kPillowCmyk : Mode::kPillow;
}

}  // namespace

extern "C" {

// (h, w) from a JPEG's headers, read as far as its first scan. Returns 0
// on success, nonzero where libjpeg's jpeg_read_header stops. mode 0 is
// libjpeg-turbo 2.1, mode 1 libjpeg-turbo 3.1.3 (lossless frames read).
int jpeg_dims_mode(const uint8_t* buf, int64_t len, int* h, int* w,
                   int mode) {
  try {
    Decoder d(buf, len, api_mode(mode));
    d.read_header();
    *h = d.height();
    *w = d.width();
    return 0;
  } catch (const Refused&) {
    return 1;
  } catch (const std::bad_alloc&) {
    return 1;
  }
}

int jpeg_dims(const uint8_t* buf, int64_t len, int* h, int* w) {
  return jpeg_dims_mode(buf, len, h, w, 0);
}

// Decode a JPEG buffer into a preallocated (h, w, 3) RGB uint8 array:
// mode 0 as libjpeg-turbo 2.1's default decode, mode 1 as Pillow 12.1.0's
// Image.open(...).convert("RGB") over libjpeg-turbo 3.1.3 (CMYK, YCCK and
// lossless frames decoded, a file cut before the image is whole refused),
// mode 3 as mode 1 with JpegImageFile's tile set to jpegmode "CMYK", as
// BLP1's JPEG sets it: a YCCK frame's components read as CMYK, unconverted.
// Returns 0 on success, 2 where (h, w) is not the file's size, 1 on any
// other failure. Pure C++ with no shared state: callers run it from
// threads without the GIL.
int decode_jpeg_u8_mode(const uint8_t* buf, int64_t len, uint8_t* out, int h,
                        int w, int mode) {
  try {
    Decoder d(buf, len, api_mode(mode));
    d.read_header();
    if (d.height() != h || d.width() != w) return 2;
    d.decode(out);
    return 0;
  } catch (const Refused&) {
    return 1;
  } catch (const std::bad_alloc&) {
    return 1;
  }
}

int decode_jpeg_u8(const uint8_t* buf, int64_t len, uint8_t* out, int h,
                   int w) {
  return decode_jpeg_u8_mode(buf, len, out, h, w, 0);
}

// The JPEG strips or tiles of a TIFF as libtiff 4.7.1's tif_jpeg.c decodes
// them for TIFFReadEncodedStrip/Tile, in the order given: tables (the
// JPEGTables field, tables_len < 0 where it is not set) read first, and a
// failure there fails every chunk; then chunk i (counts[i] bytes at data +
// offsets[i]) checked against segs[3 i ..] (segment width, height, the
// last strip: JPEGPreDecode) and min(occs[i] / bytesperline, its height)
// rows written at out + i * stride, bytesperline apart. Before it, slot i
// takes a copy of slot chain_from[i] where that is not -1: the buffer
// libtiff decodes into keeps what an earlier chunk left where this one
// writes nothing. ncomp: the components expected; bps: the precision; h,
// v: component 0's sampling factors; rgb: YCbCr -> RGB. info[3 i ..]:
// the status (0 decoded; 1 refused: libtiff's TIFFFillStrip fails),
// the rows written and their bytes. A chunk refused is zeroed over
// occs[i] bytes, as TIFFReadEncodedStrip zeroes it.
void tiff_jpeg_chunks(const uint8_t* data, const uint8_t* tables,
                      int64_t tables_len, const int64_t* offsets,
                      const int64_t* counts, const int64_t* occs,
                      const int32_t* segs, const int64_t* chain_from,
                      int64_t n, uint8_t* out, int64_t stride,
                      int64_t bytesperline, int ncomp, int bps, int h, int v,
                      int rgb, int32_t* info) {
  Tables tables_state;
  bool tables_ok = true;
  if (tables_len >= 0) {
    try {
      Decoder t(tables, tables_len, Mode::kTiff, &tables_state);
      t.read_tables();
    } catch (const Refused&) {
      tables_ok = false;
    } catch (const std::bad_alloc&) {
      tables_ok = false;
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    if (chain_from[i] >= 0)
      std::memcpy(out + i * stride, out + chain_from[i] * stride,
                  static_cast<size_t>(stride));
    int32_t* inf = info + 3 * i;
    inf[0] = 1;
    inf[1] = inf[2] = 0;
    if (!tables_ok) continue;
    try {
      Decoder d(data + offsets[i], counts[i], Mode::kTiff, &tables_state);
      d.read_header();
      d.tiff_checks(segs[3 * i], segs[3 * i + 1], segs[3 * i + 2] != 0,
                    ncomp, bps, h, v, rgb != 0);
      const int64_t rows =
          std::min<int64_t>(occs[i] / bytesperline, d.height());
      inf[1] = static_cast<int32_t>(rows);
      inf[2] = d.width() * (rgb ? 3 : ncomp);
      d.decode_tiff(out + i * stride, bytesperline, static_cast<int>(rows));
      inf[0] = 0;
    } catch (const Refused&) {
    } catch (const std::bad_alloc&) {
    }
    if (inf[0] == 1) {                  // TIFFReadEncodedStrip zeroes it
      inf[1] = 0;
      std::memset(out + i * stride, 0, static_cast<size_t>(occs[i]));
    }
  }
}

}  // extern "C"

extern "C" {

// The subsampling libtiff 4.7.1 reports for a file under Compression 6
// (OJPEGSubsamplingCorrect): hv[0], hv[1]. params: OjParam's values;
// offsets, counts: the strile arrays (nstriles each).
void tiff_ojpeg_subsampling(const uint8_t* data, const int64_t* params,
                            const int64_t* offsets, const int64_t* counts,
                            int64_t nstriles, int32_t* hv) {
  OJpeg oj(data, params, offsets, counts, nstriles);
  oj.subsampling_correct();
  hv[0] = oj.hor();
  hv[1] = oj.ver();
}

// TIFFReadEncodedStrip/Tile of a file under Compression 6 as libtiff
// 4.7.1's old-style JPEG codec reads it, read after read on one handle:
// read k (reads[3 k ..]: strile, plane, bytes) into out + k * stride,
// which first takes a copy of slot chain_from[k] where that is not -1.
// status[k]: 0 decoded, 1 the decode failed, 2 TIFFFillStrip failed
// (OJPEGPreDecode); the slot zeroed over its bytes where it failed.
void tiff_ojpeg_reads(const uint8_t* data, const int64_t* params,
                      const int64_t* offsets, const int64_t* counts,
                      int64_t nstriles, const int64_t* reads,
                      const int64_t* chain_from, int64_t nreads,
                      uint8_t* out, int64_t stride, int32_t* status) {
  OJpeg oj(data, params, offsets, counts, nstriles);
  for (int64_t k = 0; k < nreads; ++k) {
    if (chain_from[k] >= 0)
      std::memcpy(out + k * stride, out + chain_from[k] * stride,
                  static_cast<size_t>(stride));
    try {
      status[k] = oj.read(static_cast<uint32_t>(reads[3 * k]),
                          static_cast<int>(reads[3 * k + 1]),
                          out + k * stride, reads[3 * k + 2]);
    } catch (const std::bad_alloc&) {
      std::memset(out + k * stride, 0, static_cast<size_t>(reads[3 * k + 2]));
      status[k] = 2;
    }
  }
}

}  // extern "C"
