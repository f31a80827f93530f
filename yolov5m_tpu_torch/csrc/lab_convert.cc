// Pillow 12.1.0's convert("RGB") of a LAB image: a LittleCMS 2 transform
// (PIL/Image.py: ImageCms.buildTransform from createProfile("LAB"), lcms's
// cmsCreateLab2Profile(NULL), to createProfile("sRGB"), its
// cmsCreate_sRGBProfile(), intent 0, flags 0), input PT_LabV2 of three
// bytes and an extra one, output TYPE_RGBA_8.
//
// An 8-bit transform is never evaluated on the float pipeline it is made
// of: lcms's optimizer (OptimizeByResampling) samples the pipeline at the
// nodes of a 33x33x33 grid into a 16-bit table, and each pixel is the
// table's tetrahedral interpolation (TetrahedralInterp16) at the pixel's
// bytes widened to 16 bits (x * 257), narrowed back to 8 bits. The
// pipeline, once lcms has dropped the Lab profile's identity table and its
// V2/V4 scalings (which cancel), is:
// - Lab2XYZ: the node's 16-bit values over 65535 as floats, L = v * 100,
//   a and b = v * 255 - 128, CIE's Lab to XYZ under D50, over lcms's
//   largest encodable XYZ, rounded to float;
// - the sRGB profile's matrix inverted (its colorants: the Rec. 709
//   primaries and D65 white, Bradford-adapted to D50, in double, as
//   cmsCreateRGBProfile computes them), times that largest XYZ, summed in
//   double, rounded to float;
// - the inverse of sRGB's parametric curve (type 4) per channel, in double
//   with libm's pow, rounded to float;
// - each output times 65535 to 16 bits by _cmsQuickSaturateWord.
// The white-point fix-up lcms applies after sampling leaves this table as
// it is: Lab's white (0xFFFF, 0x8080, 0x8080) is not a node of it.

#pragma GCC optimize("fp-contract=off")

#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>

namespace {

struct Mat {
  double v[3][3];
};

// _cmsMAT3inverse
Mat inverse(const Mat& a) {
  const double c0 = a.v[1][1] * a.v[2][2] - a.v[1][2] * a.v[2][1];
  const double c1 = -a.v[1][0] * a.v[2][2] + a.v[1][2] * a.v[2][0];
  const double c2 = a.v[1][0] * a.v[2][1] - a.v[1][1] * a.v[2][0];
  const double det = a.v[0][0] * c0 + a.v[0][1] * c1 + a.v[0][2] * c2;
  Mat b;
  b.v[0][0] = c0 / det;
  b.v[0][1] = (a.v[0][2] * a.v[2][1] - a.v[0][1] * a.v[2][2]) / det;
  b.v[0][2] = (a.v[0][1] * a.v[1][2] - a.v[0][2] * a.v[1][1]) / det;
  b.v[1][0] = c1 / det;
  b.v[1][1] = (a.v[0][0] * a.v[2][2] - a.v[0][2] * a.v[2][0]) / det;
  b.v[1][2] = (a.v[0][2] * a.v[1][0] - a.v[0][0] * a.v[1][2]) / det;
  b.v[2][0] = c2 / det;
  b.v[2][1] = (a.v[0][1] * a.v[2][0] - a.v[0][0] * a.v[2][1]) / det;
  b.v[2][2] = (a.v[0][0] * a.v[1][1] - a.v[0][1] * a.v[1][0]) / det;
  return b;
}

// _cmsMAT3per: a * b
Mat times(const Mat& a, const Mat& b) {
  Mat r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.v[i][j] = a.v[i][0] * b.v[0][j] + a.v[i][1] * b.v[1][j] +
                  a.v[i][2] * b.v[2][j];
  return r;
}

// _cmsMAT3eval: a * v
void eval(double* r, const Mat& a, const double* v) {
  for (int i = 0; i < 3; ++i)
    r[i] = a.v[i][0] * v[0] + a.v[i][1] * v[1] + a.v[i][2] * v[2];
}

constexpr double kD50[3] = {0.9642, 1.0, 0.8249};
constexpr double kMaxXYZ = 1.0 + 32767.0 / 32768.0;  // MAX_ENCODEABLE_XYZ

// cmsCreateRGBProfile's colorants of sRGB (_cmsBuildRGB2XYZtransferMatrix
// and _cmsAdaptMatrixToD50 with Bradford's cone matrix)
Mat srgb_colorants() {
  const double xn = 0.3127, yn = 0.3290;
  const double xr = 0.6400, yr = 0.3300, xg = 0.3000, yg = 0.6000,
               xb = 0.1500, yb = 0.0600;
  const Mat primaries = {{{xr, xg, xb},
                          {yr, yg, yb},
                          {(1 - xr - yr), (1 - xg - yg), (1 - xb - yb)}}};
  const Mat inv = inverse(primaries);
  const double white[3] = {xn / yn, 1.0, (1.0 - xn - yn) / yn};
  double coef[3];
  eval(coef, inv, white);
  const Mat r = {{{coef[0] * xr, coef[1] * xg, coef[2] * xb},
                  {coef[0] * yr, coef[1] * yg, coef[2] * yb},
                  {coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
                   coef[2] * (1.0 - xb - yb)}}};
  // cmsxyY2XYZ of the white at Y = 1, then ComputeChromaticAdaptation
  const double dn[3] = {(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0};
  const Mat bradford = {{{0.8951, 0.2664, -0.1614},
                         {-0.7502, 1.7135, 0.0367},
                         {0.0389, -0.0685, 1.0296}}};
  const Mat bradford_inv = inverse(bradford);
  double src[3], dst[3];
  eval(src, bradford, dn);
  eval(dst, bradford, kD50);
  const Mat cone = {{{dst[0] / src[0], 0.0, 0.0},
                     {0.0, dst[1] / src[1], 0.0},
                     {0.0, 0.0, dst[2] / src[2]}}};
  const Mat adapt = times(bradford_inv, times(cone, bradford));
  return times(adapt, r);
}

// _cmsQuickSaturateWord (lcms's fast floor: the value rounded to 1/65536,
// then floored)
uint16_t saturate_word(double d) {
  d += 0.5;
  if (d <= 0) return 0;
  if (d >= 65535.0) return 0xffff;
  union {
    double val;
    int32_t halves[2];
  } temp;
  temp.val = (d - 32767.0) + 68719476736.0 * 1.5;
  return static_cast<uint16_t>((temp.halves[0] >> 16) + 32767);
}

// cmsLab2XYZ's f^-1
double f_1(double t) {
  const double limit = 24.0 / 116.0;
  if (t <= limit) return (108.0 / 841.0) * (t - (16.0 / 116.0));
  return t * t * t;
}

// the inverse of sRGB's type-4 curve (DefaultEvalParametricFn, type -4)
double inverse_srgb(double r) {
  const double g = 2.4, a = 1. / 1.055, b = 0.055 / 1.055, c = 1. / 12.92,
               d = 0.04045;
  const double e = a * d + b;
  const double disc = e < 0 ? 0 : std::pow(e, g);
  if (r >= disc) return (std::pow(r, 1.0 / g) - b) / a;
  return r / c;
}

constexpr int kGrid = 33;

}  // namespace

extern "C" {

// The 33^3 x 3 table lcms samples (L slowest, then a, then b; R, G, B
// a node), into table.
void lcms_lab_clut(uint16_t* table) {
  const Mat inv = inverse(srgb_colorants());
  double m[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) m[i][j] = inv.v[i][j] * kMaxXYZ;
  uint16_t node[kGrid];
  for (int i = 0; i < kGrid; ++i)           // _cmsQuantizeVal
    node[i] = saturate_word(static_cast<double>(i) * 65535. / (kGrid - 1));
  for (int il = 0; il < kGrid; ++il)
    for (int ia = 0; ia < kGrid; ++ia)
      for (int ib = 0; ib < kGrid; ++ib) {
        // XFormSampler16: 16 bits to float
        const float in[3] = {static_cast<float>(node[il] / 65535.0),
                             static_cast<float>(node[ia] / 65535.0),
                             static_cast<float>(node[ib] / 65535.0)};
        // EvaluateLab2XYZ
        const double l = in[0] * 100.0, a = in[1] * 255.0 - 128.0,
                     b = in[2] * 255.0 - 128.0;
        const double y = (l + 16.0) / 116.0;
        const double x = y + 0.002 * a;
        const double z = y - 0.005 * b;
        const float xyz[3] = {
            static_cast<float>(f_1(x) * kD50[0] / kMaxXYZ),
            static_cast<float>(f_1(y) * kD50[1] / kMaxXYZ),
            static_cast<float>(f_1(z) * kD50[2] / kMaxXYZ)};
        uint16_t* out = table + ((il * kGrid + ia) * kGrid + ib) * 3;
        for (int i = 0; i < 3; ++i) {
          double tmp = 0;                   // EvaluateMatrix
          for (int j = 0; j < 3; ++j) tmp += xyz[j] * m[i][j];
          const float rgb = static_cast<float>(tmp);
          const float v = static_cast<float>(inverse_srgb(rgb));
          out[i] = saturate_word(v * 65535.0);
        }
      }
}

// n pixels of Pillow's LAB storage (4 bytes a pixel: L, a + 128, b + 128,
// unused) to RGB (3 bytes a pixel) through table: TetrahedralInterp16 of
// the bytes times 257, then FROM_16_TO_8.
void lcms_lab_to_rgb(const uint8_t* lab, int64_t n, const uint16_t* table,
                     uint8_t* rgb) {
  constexpr int32_t opta[3] = {kGrid * kGrid * 3, kGrid * 3, 3};
  for (int64_t p = 0; p < n; ++p) {
    int32_t r[3], step[3];
    int32_t base = 0;
    for (int k = 0; k < 3; ++k) {
      const int32_t in = lab[4 * p + k] * 257;
      const int32_t a = in * (kGrid - 1);
      const int32_t f = a + (a + 0x7fff) / 0xffff;   // _cmsToFixedDomain
      base += opta[k] * (f >> 16);
      r[k] = f & 0xffff;
      step[k] = in == 0xffff ? 0 : opta[k];
    }
    // the tetrahedron: the axes added in order of their remainders
    int o0 = 0, o1 = 1, o2 = 2;
    if (r[o1] > r[o0]) std::swap(o0, o1);
    if (r[o2] > r[o1]) std::swap(o1, o2);
    if (r[o1] > r[o0]) std::swap(o0, o1);
    const uint16_t* t = table + base;
    const int32_t s1 = step[o0], s2 = s1 + step[o1], s3 = s2 + step[o2];
    for (int ch = 0; ch < 3; ++ch) {
      const int32_t c0 = t[ch];
      int32_t c[3];
      c[o0] = t[s1 + ch] - c0;
      c[o1] = t[s2 + ch] - t[s1 + ch];
      c[o2] = t[s3 + ch] - t[s2 + ch];
      // in 32 bits, wrapping as the library's int arithmetic does
      const uint32_t sum = static_cast<uint32_t>(c[0]) * static_cast<uint32_t>(r[0]) +
                           static_cast<uint32_t>(c[1]) * static_cast<uint32_t>(r[1]) +
                           static_cast<uint32_t>(c[2]) * static_cast<uint32_t>(r[2]) +
                           0x8001U;
      const int32_t rest = static_cast<int32_t>(sum);
      const int32_t add = static_cast<int32_t>(
          static_cast<uint32_t>(rest) + static_cast<uint32_t>(rest >> 16)) >> 16;
      const uint16_t v = static_cast<uint16_t>(static_cast<uint16_t>(c0) + add);
      rgb[3 * p + ch] = static_cast<uint8_t>(
          ((static_cast<uint32_t>(v) * 65281U + 8388608U) >> 24) & 0xFFU);
    }
  }
}

}  // extern "C"
