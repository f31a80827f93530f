// The block decoders of Pillow 12.1.0's DDS, FTEX and BLP plugins for the
// yolov5m_tpu_torch data pipeline (data/bcn.py holds the plugins' opens
// and loads, and converts what these loops give):
//
//   bcn_decode  BcnDecode.c, Pillow's "bcn" decoder, for n 1 to 7: BC1
//               (DXT1), BC2 (DXT3), BC3 (DXT5), BC4, BC5 (unsigned, or
//               signed as Pillow maps it: each endpoint + 128, then the
//               unsigned palette), BC6H (unsigned and signed: endpoints
//               unquantized, lerped in integers, scaled by 31/64 or 31/32
//               into half-float bits, then clamped to [0, 1] and
//               truncated to 8 bits) and BC7 (its eight modes; a first
//               byte of 0 is opaque black). 4x4 blocks left to right, top to
//               bottom; the parts of edge blocks past the image are
//               dropped. Colour bytes of BC2 and BC3 always take the four
//               colour palette; BC1's takes the three colour one where
//               its first colour is not above its second.
//   dds_rgb     DdsImagePlugin's DdsRgbDecoder (Python in Pillow): pixels
//               of bitcount / 8 bytes, little-endian, each masked field
//               shifted down and scaled as int(v / (mask >> shift) * 255)
//               in double; a read past the file's end is the value 0.
//   blp_dxt     BlpImagePlugin's decode_dxt1, decode_dxt3 and decode_dxt5
//               (Python in Pillow): 5:6:5 colours shifted up without
//               copying their top bits into the low ones, integer
//               palettes of their own, each block row's four pixel rows
//               the padded width long, one after another; 3 bytes a pixel
//               for DXT1 without alpha, 4 for DXT1 with it, and for DXT3
//               and DXT5 always.
//
// Each returns 0 where the image is whole and 1 where the data ran out
// first ("image file is truncated"). Pure C++ without shared state, called
// through ctypes by data/bcn.py.

#include <cstdint>
#include <cstring>

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

int get_bit(const uint8_t* s, int bit) { return (s[bit >> 3] >> (bit & 7)) & 1; }

// count (0-8) bits from bit on, least significant first; s holds a block
// and a zero byte past it
int get_bits(const uint8_t* s, int bit, int count) {
  if (!count) return 0;
  const int by = bit >> 3;
  bit &= 7;
  const int x = s[by] | (s[by + 1] << 8);
  return (x >> bit) & ((1 << count) - 1);
}

// -- BC1-BC5 -----------------------------------------------------------------

Rgba decode_565(uint16_t x) {
  int r = (x & 0xf800) >> 8;
  r |= r >> 5;
  int g = (x & 0x7e0) >> 3;
  g |= g >> 6;
  int b = (x & 0x1f) << 3;
  b |= b >> 5;
  return {static_cast<uint8_t>(r), static_cast<uint8_t>(g),
          static_cast<uint8_t>(b), 0xff};
}

void bc1_color(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  const uint16_t c0 = src[0] | (src[1] << 8), c1 = src[2] | (src[3] << 8);
  const uint32_t lut = src[4] | (src[5] << 8) | (src[6] << 16) |
                       (static_cast<uint32_t>(src[7]) << 24);
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  const int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {static_cast<uint8_t>((2 * r0 + r1) / 3),
            static_cast<uint8_t>((2 * g0 + g1) / 3),
            static_cast<uint8_t>((2 * b0 + b1) / 3), 0xff};
    p[3] = {static_cast<uint8_t>((r0 + 2 * r1) / 3),
            static_cast<uint8_t>((g0 + 2 * g1) / 3),
            static_cast<uint8_t>((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = {static_cast<uint8_t>((r0 + r1) / 2),
            static_cast<uint8_t>((g0 + g1) / 2),
            static_cast<uint8_t>((b0 + b1) / 2), 0xff};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; ++n) dst[n] = p[3 & (lut >> (2 * n))];
}

// BC3's alpha block (BC4's grey, BC5's red and green): eight values of
// its two endpoints; signed: each endpoint + 128
void bc3_alpha(uint8_t* dst, int stride, const uint8_t* src, bool sign) {
  int a0 = src[0], a1 = src[1];
  if (sign) {
    a0 = static_cast<int8_t>(src[0]) + 128;
    a1 = static_cast<int8_t>(src[1]) + 128;
  }
  uint8_t a[8];
  a[0] = static_cast<uint8_t>(a0);
  a[1] = static_cast<uint8_t>(a1);
  if (a0 > a1) {
    for (int k = 1; k <= 6; ++k)
      a[k + 1] = static_cast<uint8_t>(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k <= 4; ++k)
      a[k + 1] = static_cast<uint8_t>(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  const int lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
  const int lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
  for (int n = 0; n < 8; ++n) dst[stride * n] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; ++n)
    dst[stride * (8 + n)] = a[7 & (lut2 >> (3 * n))];
}

void bc2_alpha(Rgba* col, const uint8_t* src) {
  for (int n = 0; n < 16; ++n) {
    const int av = 0xf & (src[n >> 1] >> (4 * (n & 1)));
    col[n].a = static_cast<uint8_t>((av << 4) | av);
  }
}

// -- BC7 ---------------------------------------------------------------------

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};

const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// the partitions: bit n (2 subsets) or bits 2n, 2n + 1 (3) give pixel n's
// subset
const uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};

const uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};

// the anchor pixels: subset 1 of two (kAnchor2), subsets 1 and 2 of three
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                               34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

int subset(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kPartition2[partition] >> n);
  if (ns == 3) return 3 & (kPartition3[partition] >> (2 * n));
  return 0;
}

// an endpoint of bits bits widened to 8 by copying its top bits down
uint8_t expand(int x, int bits) {
  x <<= 8 - bits;
  return static_cast<uint8_t>(x | (x >> bits));
}

uint8_t lerp(int e0, int e1, int s) {
  return static_cast<uint8_t>((e0 * (64 - s) + e1 * s + 32) >> 6);
}

void decode_bc7(Rgba* col, const uint8_t* src) {
  if (src[0] == 0) {               // no mode bit: opaque black
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 0xff};
    return;
  }
  int m = 0;
  while (!(src[0] & (1 << m))) ++m;
  const Bc7Mode& info = kBc7Modes[m];
  int bit = m + 1;
  const int partition = get_bits(src, bit, info.pb);
  bit += info.pb;
  const int rotation = get_bits(src, bit, info.rb);
  bit += info.rb;
  const int index_sel = get_bits(src, bit, info.isb);
  bit += info.isb;
  const int numep = info.ns * 2;
  int ep[6][4];
  int cb = info.cb, ab = info.ab;
  for (int c = 0; c < 3; ++c) {
    for (int i = 0; i < numep; ++i) {
      ep[i][c] = get_bits(src, bit, cb);
      bit += cb;
    }
  }
  for (int i = 0; i < numep; ++i) {
    ep[i][3] = ab ? get_bits(src, bit, ab) : 0xff;
    bit += ab;
  }
  if (info.epb || info.spb) {
    for (int i = 0; i < numep; ++i) {
      const int p = get_bit(src, bit + (info.epb ? i : i / 2));
      for (int c = 0; c < 3; ++c) ep[i][c] = (ep[i][c] << 1) | p;
      if (ab) ep[i][3] = (ep[i][3] << 1) | p;
    }
    bit += info.epb ? numep : numep / 2;
    ++cb;
    if (ab) ++ab;
  }
  for (int i = 0; i < numep; ++i) {
    for (int c = 0; c < 3; ++c) ep[i][c] = expand(ep[i][c], cb);
    if (ab) ep[i][3] = expand(ep[i][3], ab);
  }
  const uint8_t* cw = weights(info.ib);
  const uint8_t* aw = weights(ab && info.ib2 ? info.ib2 : info.ib);
  int cibit = bit;
  int aibit = cibit + 16 * info.ib - info.ns;
  for (int i = 0; i < 16; ++i) {
    const int s = subset(info.ns, partition, i) * 2;
    int ib = info.ib;
    if (i == 0 || (info.ns == 2 && i == kAnchor2[partition]) ||
        (info.ns == 3 && (i == kAnchor3a[partition] ||
                          i == kAnchor3b[partition])))
      --ib;
    const int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    int wc = cw[i0], wa = cw[i0];
    if (ab && info.ib2) {
      const int ib2 = info.ib2 - (i == 0);
      const int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel) {
        wc = aw[i1];
      } else {
        wa = aw[i1];
      }
    }
    const int* e0 = ep[s];
    const int* e1 = ep[s + 1];
    Rgba p = {lerp(e0[0], e1[0], wc), lerp(e0[1], e1[1], wc),
              lerp(e0[2], e1[2], wc), lerp(e0[3], e1[3], wa)};
    uint8_t t = p.a;
    switch (rotation) {
      case 1: p.a = p.r; p.r = t; break;
      case 2: p.a = p.g; p.g = t; break;
      case 3: p.a = p.b; p.b = t; break;
    }
    col[i] = p;
  }
}

// -- BC6H --------------------------------------------------------------------

struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;
};

const Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},  {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},  {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10},
    {1, 1, 0, 11, 9, 9, 9}, {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// The endpoint bits of each mode in stream order (BC6H's layout table), as
// endpoint * 16 + bit: endpoints 0-2 are w's red, green and blue, 3-5 x's,
// 6-8 y's, 9-11 z's. The two-bit modes' bits start at bit 2, the others'
// at bit 5.
const uint8_t kBc6Bits[14][75] = {
    {116, 132, 180, 0,   1,   2,   3,   4,   5,   6,   7,   8,   9,
     16,  17,  18,  19,  20,  21,  22,  23,  24,  25,  32,  33,  34,
     35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  52,  164,
     112, 113, 114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162,
     163, 80,  81,  82,  83,  84,  177, 128, 129, 130, 131, 96,  97,
     98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0,   1,   2,   3,   4,   5,   6,   176, 177, 132,
     16,  17,  18,  19,  20,  21,  22,  133, 178, 116, 32,  33,  34,
     35,  36,  37,  38,  179, 181, 180, 48,  49,  50,  51,  52,  53,
     112, 113, 114, 115, 64,  65,  66,  67,  68,  69,  160, 161, 162,
     163, 80,  81,  82,  83,  84,  85,  128, 129, 130, 131, 96,  97,
     98,  99,  100, 101, 144, 145, 146, 147, 148, 149},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,
     19,  20,  21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,
     38,  39,  40,  41,  48,  49,  50,  51,  52,  10,  112, 113, 114,
     115, 64,  65,  66,  67,  26,  176, 160, 161, 162, 163, 80,  81,
     82,  83,  42,  177, 128, 129, 130, 131, 96,  97,  98,  99,  100,
     178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,
     19,  20,  21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,
     38,  39,  40,  41,  48,  49,  50,  51,  10,  164, 112, 113, 114,
     115, 64,  65,  66,  67,  68,  26,  160, 161, 162, 163, 80,  81,
     82,  83,  42,  177, 128, 129, 130, 131, 96,  97,  98,  99,  176,
     178, 144, 145, 146, 147, 116, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,
     19,  20,  21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,
     38,  39,  40,  41,  48,  49,  50,  51,  10,  132, 112, 113, 114,
     115, 64,  65,  66,  67,  26,  176, 160, 161, 162, 163, 80,  81,
     82,  83,  84,  42,  128, 129, 130, 131, 96,  97,  98,  99,  177,
     178, 144, 145, 146, 147, 180, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   132, 16,  17,  18,
     19,  20,  21,  22,  23,  24,  116, 32,  33,  34,  35,  36,  37,
     38,  39,  40,  180, 48,  49,  50,  51,  52,  164, 112, 113, 114,
     115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,
     82,  83,  84,  177, 128, 129, 130, 131, 96,  97,  98,  99,  100,
     178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   164, 132, 16,  17,  18,
     19,  20,  21,  22,  23,  178, 116, 32,  33,  34,  35,  36,  37,
     38,  39,  179, 180, 48,  49,  50,  51,  52,  53,  112, 113, 114,
     115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,
     82,  83,  84,  177, 128, 129, 130, 131, 96,  97,  98,  99,  100,
     101, 144, 145, 146, 147, 148, 149},
    {0,   1,   2,   3,   4,   5,   6,   7,   176, 132, 16,  17,  18,
     19,  20,  21,  22,  23,  117, 116, 32,  33,  34,  35,  36,  37,
     38,  39,  165, 180, 48,  49,  50,  51,  52,  164, 112, 113, 114,
     115, 64,  65,  66,  67,  68,  69,  160, 161, 162, 163, 80,  81,
     82,  83,  84,  177, 128, 129, 130, 131, 96,  97,  98,  99,  100,
     178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   177, 132, 16,  17,  18,
     19,  20,  21,  22,  23,  133, 116, 32,  33,  34,  35,  36,  37,
     38,  39,  181, 180, 48,  49,  50,  51,  52,  164, 112, 113, 114,
     115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,
     82,  83,  84,  85,  128, 129, 130, 131, 96,  97,  98,  99,  100,
     178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   164, 176, 177, 132, 16,  17,  18,
     19,  20,  21,  117, 133, 178, 116, 32,  33,  34,  35,  36,  37,
     165, 179, 181, 180, 48,  49,  50,  51,  52,  53,  112, 113, 114,
     115, 64,  65,  66,  67,  68,  69,  160, 161, 162, 163, 80,  81,
     82,  83,  84,  85,  128, 129, 130, 131, 96,  97,  98,  99,  100,
     101, 144, 145, 146, 147, 148, 149},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20,
     21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
     48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68,
     69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20,
     21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
     48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68,
     69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20,
     21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
     48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68,
     69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20,
     21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
     48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31,
     30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42}};

uint16_t sign_extend(uint16_t v, int prec) {
  int x = v;
  if (x & (1 << (prec - 1))) x |= -(1 << prec);
  return static_cast<uint16_t>(x);
}

int unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    const int x = v;
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == (1 << prec) - 1) return 0xffff;
    return ((x << 16) + 0x8000) >> prec;
  }
  int x = static_cast<int16_t>(v);
  if (prec >= 16) return x;
  const bool negative = x < 0;
  if (negative) x = -x;
  if (x != 0) {
    if (x >= (1 << (prec - 1)) - 1) {
      x = 0x7fff;
    } else {
      x = ((x << 15) + 0x4000) >> (prec - 1);
    }
  }
  return negative ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = static_cast<uint32_t>(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= static_cast<uint32_t>(h & 0x8000) << 16;
  return o.f;
}

float finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return half_to_float(static_cast<uint16_t>(0x8000 | ((-v) * 31 / 32)));
    return half_to_float(static_cast<uint16_t>(v * 31 / 32));
  }
  return half_to_float(static_cast<uint16_t>(v * 31 / 64));
}

uint8_t clamp8(float v) {
  if (v < 0.0f) return 0;
  if (v > 1.0f) return 255;
  return static_cast<uint8_t>(v * 255.0f);
}

void bc6_lerp(Rgba* col, const int* e0, const int* e1, int s, bool sign) {
  const int t = 64 - s;
  col->r = clamp8(finalize((e0[0] * t + e1[0] * s) >> 6, sign));
  col->g = clamp8(finalize((e0[1] * t + e1[1] * s) >> 6, sign));
  col->b = clamp8(finalize((e0[2] * t + e1[2] * s) >> 6, sign));
}

void decode_bc6(Rgba* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 0x1f;
  int bit = 5, epbits = 75, ib = 3;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {                // a reserved mode: all zero
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 0};
    return;
  }
  const Bc6Mode& info = kBc6Modes[mode];
  uint16_t ep[12] = {};
  for (int i = 0; i < epbits; ++i) {
    const int d = kBc6Bits[mode][i];
    ep[d >> 4] |= static_cast<uint16_t>(get_bit(src, bit + i) << (d & 15));
  }
  bit += epbits;
  const int partition = get_bits(src, bit, info.pb);
  bit += info.pb;
  const int numep = info.ns == 2 ? 12 : 6;
  const int mask = (1 << info.epb) - 1;
  if (sign) {
    for (int i = 0; i < 3; ++i) ep[i] = sign_extend(ep[i], info.epb);
  }
  if (sign || info.tr) {
    for (int i = 3; i < numep; i += 3) {
      ep[i] = sign_extend(ep[i], info.rb);
      ep[i + 1] = sign_extend(ep[i + 1], info.gb);
      ep[i + 2] = sign_extend(ep[i + 2], info.bb);
    }
  }
  if (info.tr) {
    for (int i = 3; i < numep; ++i)
      ep[i] = static_cast<uint16_t>((ep[i] + ep[i % 3]) & mask);
  }
  int ueps[12];
  for (int i = 0; i < numep; ++i) ueps[i] = unquantize(ep[i], info.epb, sign);
  const uint8_t* cw = weights(ib);
  for (int i = 0; i < 16; ++i) {
    const int s = subset(info.ns, partition, i) * 6;
    int bits = ib;
    if (i == 0 || (info.ns == 2 && i == kAnchor2[partition])) --bits;
    const int i0 = get_bits(src, bit, bits);
    bit += bits;
    bc6_lerp(&col[i], &ueps[s], &ueps[s + 3], cw[i0], sign);
  }
}

}  // namespace

extern "C" {

// w x h pixels of Pillow's "bcn" decoder n (1-7; sign for BC5S and BC6HS)
// from the blocks at buf, into out (h, w, channels): the first channels
// (1-4) of RGBA, BC4's grey the first.
int bcn_decode(const uint8_t* buf, int64_t len, int64_t w, int64_t h, int n,
               int sign, int channels, uint8_t* out) {
  const int64_t size = (n == 1 || n == 4) ? 8 : 16;
  const int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
  if (len < bw * bh * size) return 1;
  uint8_t block[17];
  Rgba col[16];
  for (int64_t by = 0; by < bh; ++by) {
    for (int64_t bx = 0; bx < bw; ++bx) {
      std::memcpy(block, buf + (by * bw + bx) * size, size);
      block[size] = 0;
      std::memset(col, 0, sizeof(col));
      switch (n) {
        case 1: bc1_color(col, block, false); break;
        case 2:
          bc1_color(col, block + 8, true);
          bc2_alpha(col, block);
          break;
        case 3:
          bc1_color(col, block + 8, true);
          bc3_alpha(&col[0].a, 4, block, false);
          break;
        case 4: bc3_alpha(&col[0].r, 4, block, false); break;
        case 5:
          bc3_alpha(&col[0].r, 4, block, sign);
          bc3_alpha(&col[0].g, 4, block + 8, sign);
          if (sign) {
            for (Rgba& c : col) c.b = 128;
          }
          break;
        case 6: decode_bc6(col, block, sign); break;
        default: decode_bc7(col, block); break;
      }
      for (int j = 0; j < 4; ++j) {
        const int64_t y = by * 4 + j;
        if (y >= h) break;
        for (int i = 0; i < 4; ++i) {
          const int64_t x = bx * 4 + i;
          if (x >= w) break;
          std::memcpy(out + channels * (y * w + x), &col[4 * j + i],
                      channels);
        }
      }
    }
  }
  return 0;
}

// DdsRgbDecoder: w x h pixels of bytecount bytes each from buf (len bytes
// after the header), nmasks (3 or 4) masks, into out (h, w, 4).
int dds_rgb(const uint8_t* buf, int64_t len, int64_t w, int64_t h,
            int64_t bytecount, const uint32_t* masks, int nmasks,
            uint8_t* out) {
  int shift[4];
  uint32_t total[4];
  for (int k = 0; k < nmasks; ++k) {
    shift[k] = 0;
    if (masks[k]) {
      while (!((masks[k] >> shift[k]) & 1)) ++shift[k];
    }
    total[k] = masks[k] >> shift[k];
  }
  const int64_t npx = w * h;
  const int64_t take = bytecount < 4 ? bytecount : 4;
  for (int64_t i = 0; i < npx; ++i) {
    uint32_t value = 0;
    const int64_t at = i * bytecount;
    for (int64_t k = 0; k < take && at + k < len; ++k)
      value |= static_cast<uint32_t>(buf[at + k]) << (8 * k);
    for (int k = 0; k < nmasks; ++k) {
      const uint32_t v = (value & masks[k]) >> shift[k];
      out[4 * i + k] = total[k] ? static_cast<uint8_t>(static_cast<int>(
                                      static_cast<double>(v) / total[k] * 255))
                                : 0;
    }
  }
  return 0;
}

// BLP2's decode_dxt1 (enc 0; alpha: 4 bytes a pixel, else 3), decode_dxt3
// (enc 1) and decode_dxt5 (enc 7): the raw stream of (h + 3) / 4 block
// rows of (w + 3) / 4 blocks, each block row's four pixel rows in turn,
// into out; 1 where buf holds fewer bytes.
int blp_dxt(const uint8_t* buf, int64_t len, int64_t w, int64_t h, int enc,
            int alpha, uint8_t* out) {
  const int64_t size = enc == 0 ? 8 : 16;
  const int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
  if (len < bw * bh * size) return 1;
  const int bpp = (enc == 0 && !alpha) ? 3 : 4;
  const int64_t row = bw * 4 * bpp;
  for (int64_t by = 0; by < bh; ++by) {
    for (int64_t bx = 0; bx < bw; ++bx) {
      const uint8_t* b = buf + (by * bw + bx) * size;
      const uint8_t* c = enc == 0 ? b : b + 8;
      const int color0 = c[0] | (c[1] << 8), color1 = c[2] | (c[3] << 8);
      const uint32_t code = c[4] | (c[5] << 8) | (c[6] << 16) |
                            (static_cast<uint32_t>(c[7]) << 24);
      const int r0 = ((color0 >> 11) & 0x1f) << 3, g0 = ((color0 >> 5) & 0x3f) << 2,
                b0 = (color0 & 0x1f) << 3;
      const int r1 = ((color1 >> 11) & 0x1f) << 3, g1 = ((color1 >> 5) & 0x3f) << 2,
                b1 = (color1 & 0x1f) << 3;
      const uint64_t alphabits =
          enc == 7 ? (static_cast<uint64_t>(b[2]) | static_cast<uint64_t>(b[3]) << 8 |
                      static_cast<uint64_t>(b[4]) << 16 |
                      static_cast<uint64_t>(b[5]) << 24 |
                      static_cast<uint64_t>(b[6]) << 32 |
                      static_cast<uint64_t>(b[7]) << 40)
                   : 0;
      const int a0 = b[0], a1 = b[1];
      for (int j = 0; j < 4; ++j) {
        uint8_t* o = out + (by * 4 + j) * row + bx * 4 * bpp;
        for (int i = 0; i < 4; ++i, o += bpp) {
          const int k = 4 * j + i;
          const int cc = (code >> (2 * k)) & 3;
          int r, g, bl, a = 0xff;
          if (cc == 0) {
            r = r0; g = g0; bl = b0;
          } else if (cc == 1) {
            r = r1; g = g1; bl = b1;
          } else if (enc != 0 || color0 > color1) {
            const int x0 = cc == 2 ? 2 : 1, x1 = 3 - x0;
            r = (x0 * r0 + x1 * r1) / 3;
            g = (x0 * g0 + x1 * g1) / 3;
            bl = (x0 * b0 + x1 * b1) / 3;
          } else if (cc == 2) {
            r = (r0 + r1) / 2; g = (g0 + g1) / 2; bl = (b0 + b1) / 2;
          } else {
            r = g = bl = a = 0;
          }
          if (enc == 1) {
            const int nib = (b[k / 2] >> (4 * (k & 1))) & 0xf;
            a = nib * 17;
          } else if (enc == 7) {
            const int ac = static_cast<int>((alphabits >> (3 * k)) & 7);
            if (ac == 0) {
              a = a0;
            } else if (ac == 1) {
              a = a1;
            } else if (a0 > a1) {
              a = ((8 - ac) * a0 + (ac - 1) * a1) / 7;
            } else if (ac == 6) {
              a = 0;
            } else if (ac == 7) {
              a = 0xff;
            } else {
              a = ((6 - ac) * a0 + (ac - 1) * a1) / 5;
            }
          }
          o[0] = static_cast<uint8_t>(r);
          o[1] = static_cast<uint8_t>(g);
          o[2] = static_cast<uint8_t>(bl);
          if (bpp == 4) o[3] = static_cast<uint8_t>(a);
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
