// Host image ops of the training augmentation, for the yolov5m_tpu_torch
// data pipeline: the OpenCV calls that the JAX package's
// yolov5m_tpu/data/augment.py makes, written out so that the port needs no
// cv2 on any machine.
//
//   warp_affine_linear_f32   cv2.warpAffine(img_f32, M, (w, h), INTER_LINEAR,
//                            borderValue=0)        Rotate
//   box_blur_f32             cv2.blur(img_f32, (k, k)), reflect-101 border
//   rgb_to_hsv_u8            cv2.cvtColor(u8, COLOR_RGB2HSV), hue 0..180
//   hsv_to_rgb_u8            cv2.cvtColor(u8, COLOR_HSV2RGB)
//   rgb_to_lab_u8            cv2.cvtColor(u8, COLOR_RGB2LAB)
//   lab_to_rgb_u8            cv2.cvtColor(u8, COLOR_LAB2RGB)
//   clahe_u8                 cv2.createCLAHE(clip, (tx, ty)).apply(L)
//   downscale2x_linear_f32   cv2.resize(img_f32, (w/2, h/2), INTER_LINEAR)
//
// Each follows OpenCV 5.0's arithmetic step by step (its rounding, its order
// of float operations, the fused multiply-adds its vector code makes), as
// read from the outputs of that build; the test suite holds every op against
// cv2 (tests/test_torch_cv_ops.py), bitwise, the colour conversions over
// all 2^24 inputs.
//
// The file turns off floating-point contraction for itself, so that every
// fused multiply-add is one that is written as fmaf(), on any host and with
// any -march: a build on another machine rounds alike. data/native.py
// builds it into one library with preprocess.cc, jpeg_decode.cc and
// png_decode.cc. Every function is single-threaded: the loader's threads
// call it at once through ctypes, which releases the GIL.

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// cvRound: round half to even (the default rounding mode)
inline int round_even(double v) { return static_cast<int>(std::lrint(v)); }

inline uint8_t sat_u8(int v) {
  return static_cast<uint8_t>(std::min(255, std::max(0, v)));
}

// reflect-101 index into [0, n): ... 2 1 | 0 1 2 ... n-1 | n-2 ...
inline int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * (n - 1) - i;
  return i;
}

// -- rotate -----------------------------------------------------------------

// OpenCV's float warpAffine maps coordinates in float: the vector loop
// (8 lanes, two registers: 16 pixels a step) takes sx = fma(M0, x,
// float(y * M1) + M2); the pixels after the last full step take
// sx = fma(x, M0, y * M1) + M2. Both interpolate with fused lerps.
constexpr int kWarpStep = 16;

inline float warp_px(const float* src, int h, int w, int ix, int iy, int c) {
  if (ix < 0 || iy < 0 || ix >= w || iy >= h) return 0.0f;
  return src[(static_cast<int64_t>(iy) * w + ix) * 3 + c];
}

// -- colour tables ----------------------------------------------------------

constexpr int kHsvShift = 12;
constexpr int kHsvStep = 32;   // pixels a step of OpenCV's HSV -> RGB loop

struct HsvTables {
  int sdiv[256];
  int hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = round_even((255 << kHsvShift) / (1.0 * i));
      hdiv[i] = round_even((180 << kHsvShift) / (6.0 * i));
    }
  }
};

const HsvTables& hsv_tables() {
  static const HsvTables t;
  return t;
}

// sRGB <-> Lab, 8 bits (OpenCV's integer tables): the sRGB gamma at
// 255 * 8 steps, the cube root over x in [0, 1.5) at 2040ths in Q15, and
// the inverse gamma over 4096 steps.
constexpr int kLabShift = 12;
constexpr int kLabShift2 = 15;
constexpr int kGammaSteps = 255 * 8;
constexpr int kCbrtSize = 3072;
constexpr int kInvGammaSize = 4096;
constexpr int kBase = 1 << 14;
constexpr int kMinAB = -8145;
constexpr int kMaxAB = 26871;

// sRGB -> XYZ and XYZ -> sRGB, D65 white point (OpenCV's constants)
constexpr double kRgb2Xyz[9] = {0.412453, 0.357580, 0.180423,
                                0.212671, 0.715160, 0.072169,
                                0.019334, 0.119193, 0.950227};
constexpr double kXyz2Rgb[9] = {3.240479, -1.53715, -0.498535,
                                -0.969256, 1.875991, 0.041556,
                                0.055648, -0.204043, 1.057311};
constexpr double kD65[3] = {0.950456, 1.0, 1.088754};

inline int descale(int v, int n) { return (v + (1 << (n - 1))) >> n; }

double srgb_gamma(double x) {
  return x <= 0.04045 ? x / 12.92 : std::pow((x + 0.055) / 1.055, 2.4);
}

double srgb_inv_gamma(double x) {
  return x <= 0.0031308 ? x * 12.92 : 1.055 * std::pow(x, 1.0 / 2.4) - 0.055;
}

// the cube root rounded toward zero to float, as OpenCV's software float
// cbrt gives it
float cbrt_toward_zero(float x) {
  const double c = std::cbrt(static_cast<double>(x));
  float f = static_cast<float>(c);
  if (static_cast<double>(f) > c) f = std::nextafter(f, 0.0f);
  return f;
}

struct LabTables {
  int gamma[256];
  int cbrt[kCbrtSize];
  int inv_gamma[kInvGammaSize];
  int y_of_l[256];
  int fy_of_l[256];
  int xz_of_f[kMaxAB - kMinAB];
  int to_lab[9];
  int to_rgb[9];

  LabTables() {
    for (int i = 0; i < 256; ++i)
      gamma[i] = round_even(kGammaSteps * srgb_gamma(i / 255.0));
    // computed in single precision: x, the linear branch as one fused
    // multiply-add, the cube root rounded toward zero
    const float scale = 1.0f / static_cast<float>(kGammaSteps);
    const float lthresh = 216.0f / 24389.0f;
    const float lscale = 841.0f / 108.0f;
    const float lbias = 16.0f / 116.0f;
    for (int i = 0; i < kCbrtSize; ++i) {
      const float x = scale * static_cast<float>(i);
      const float f = x < lthresh ? std::fmaf(x, lscale, lbias)
                                  : cbrt_toward_zero(x);
      cbrt[i] = std::min(65535, round_even(
          static_cast<float>(1 << kLabShift2) * f));
    }
    for (int i = 0; i < kInvGammaSize; ++i)
      inv_gamma[i] = round_even(
          255.0 * srgb_inv_gamma(static_cast<double>(i) / kInvGammaSize));
    for (int i = 0; i < 256; ++i) {
      if (i <= 20) {
        y_of_l[i] = round_even(static_cast<float>(i * kBase * 20 * 9) /
                               static_cast<float>(17 * 29 * 29 * 29));
        fy_of_l[i] = round_even(
            static_cast<float>(kBase) *
            (16.0f / 116.0f + static_cast<float>(i * 5) /
                                  static_cast<float>(3 * 17 * 29)));
      } else {
        const float fy = static_cast<float>(i * 100 * kBase) /
                             static_cast<float>(255 * 116) +
                         static_cast<float>(16 * kBase) / 116.0f;
        fy_of_l[i] = round_even(fy);
        y_of_l[i] = round_even(fy * fy * fy /
                               static_cast<float>(kBase * kBase));
      }
    }
    for (int i = kMinAB; i < kMaxAB; ++i) {
      int v;
      if (i <= 3390) {
        v = i * 108 / 841 - kBase * 16 / 116 * 108 / 841;
      } else {
        // the cube in Q14, truncated twice
        const int64_t sq = static_cast<int64_t>(i) * i >> 14;
        v = static_cast<int>(sq * i >> 14);
      }
      xz_of_f[i - kMinAB] = v;
    }
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        to_lab[r * 3 + c] = round_even((1 << kLabShift) *
                                       kRgb2Xyz[r * 3 + c] / kD65[r]);
        to_rgb[r * 3 + c] = round_even((1 << kLabShift) *
                                       kXyz2Rgb[r * 3 + c] * kD65[c]);
      }
  }
};

const LabTables& lab_tables() {
  static const LabTables t;
  return t;
}

}  // namespace

extern "C" {

// Rotate: img (h, w, 3) float32 through the forward 2x3 affine matrix m
// (row-major doubles, as cv2.getRotationMatrix2D gives it) into dst
// (dh, dw, 3); bilinear, pixels outside the source are 0.
void warp_affine_linear_f32(const float* src, int h, int w, const double* m,
                            float* dst, int dh, int dw) {
  // invert the matrix in double, as cv2.warpAffine does
  double im[6] = {m[0], m[1], m[2], m[3], m[4], m[5]};
  double d = im[0] * im[4] - im[1] * im[3];
  d = d != 0 ? 1.0 / d : 0.0;
  const double a11 = im[4] * d, a22 = im[0] * d;
  im[0] = a11;
  im[1] *= -d;
  im[3] *= -d;
  im[4] = a22;
  const double b1 = -im[0] * im[2] - im[1] * im[5];
  const double b2 = -im[3] * im[2] - im[4] * im[5];
  im[2] = b1;
  im[5] = b2;
  float mf[6];
  for (int i = 0; i < 6; ++i) mf[i] = static_cast<float>(im[i]);

  const int vec_end = dw - dw % kWarpStep;
  for (int y = 0; y < dh; ++y) {
    const float fy = static_cast<float>(y);
    const float row_x = fy * mf[1] + mf[2];
    const float row_y = fy * mf[4] + mf[5];
    const float tail_x = fy * mf[1];
    const float tail_y = fy * mf[4];
    float* out = dst + static_cast<int64_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x, out += 3) {
      const float fx = static_cast<float>(x);
      float sx, sy;
      if (x < vec_end) {
        sx = std::fmaf(mf[0], fx, row_x);
        sy = std::fmaf(mf[3], fx, row_y);
      } else {
        sx = std::fmaf(fx, mf[0], tail_x) + mf[2];
        sy = std::fmaf(fx, mf[3], tail_y) + mf[5];
      }
      const float flx = std::floor(sx), fly = std::floor(sy);
      // far outside: the border value (also keeps the int casts in range)
      if (!(flx >= -1.0f && flx <= static_cast<float>(w - 1) &&
            fly >= -1.0f && fly <= static_cast<float>(h - 1))) {
        out[0] = out[1] = out[2] = 0.0f;
        continue;
      }
      const int ix = static_cast<int>(flx), iy = static_cast<int>(fly);
      const float alpha = sx - flx, beta = sy - fly;
      for (int c = 0; c < 3; ++c) {
        const float p00 = warp_px(src, h, w, ix, iy, c);
        const float p01 = warp_px(src, h, w, ix + 1, iy, c);
        const float p10 = warp_px(src, h, w, ix, iy + 1, c);
        const float p11 = warp_px(src, h, w, ix + 1, iy + 1, c);
        const float top = std::fmaf(alpha, p01 - p00, p00);
        const float bot = std::fmaf(alpha, p11 - p10, p10);
        out[c] = std::fmaf(beta, bot - top, top);
      }
    }
  }
}

// Box blur with a k x k window (k odd) of an (h, w, 3) float32 image,
// reflect-101 border: row sums in double (k <= 5 summed directly, wider
// windows as a running sum), then a running column sum in double, scaled
// by 1 / k^2 and rounded to float.
void box_blur_f32(const float* src, int h, int w, int k, float* dst) {
  if (h <= 0 || w <= 0) return;
  const int r = k / 2;
  const int hp = h + 2 * r;
  std::vector<double> rows(static_cast<size_t>(hp) * w * 3);
  std::vector<int> xi(w + 2 * r);
  for (int i = 0; i < w + 2 * r; ++i) xi[i] = reflect101(i - r, w);
  std::vector<double> line(static_cast<size_t>(w + 2 * r) * 3);
  for (int yy = 0; yy < hp; ++yy) {
    const float* s = src + static_cast<int64_t>(reflect101(yy - r, h)) * w * 3;
    for (int i = 0; i < w + 2 * r; ++i)
      for (int c = 0; c < 3; ++c) line[i * 3 + c] = s[xi[i] * 3 + c];
    double* d = rows.data() + static_cast<size_t>(yy) * w * 3;
    for (int c = 0; c < 3; ++c) {
      if (k <= 5) {
        for (int x = 0; x < w; ++x) {
          double acc = line[x * 3 + c];
          for (int j = 1; j < k; ++j) acc = acc + line[(x + j) * 3 + c];
          d[x * 3 + c] = acc;
        }
      } else {
        double acc = 0.0;
        for (int j = 0; j < k; ++j) acc += line[j * 3 + c];
        d[c] = acc;
        for (int x = 1; x < w; ++x) {
          acc += line[(x + k - 1) * 3 + c] - line[(x - 1) * 3 + c];
          d[x * 3 + c] = acc;
        }
      }
    }
  }
  const double scale = 1.0 / (k * k);
  const size_t n = static_cast<size_t>(w) * 3;
  std::vector<double> sum(n, 0.0);
  for (int j = 0; j < k - 1; ++j)
    for (size_t i = 0; i < n; ++i) sum[i] += rows[j * n + i];
  for (int y = 0; y < h; ++y) {
    const double* add = rows.data() + (y + k - 1) * n;
    const double* sub = rows.data() + y * n;
    float* out = dst + y * n;
    for (size_t i = 0; i < n; ++i) {
      const double s0 = sum[i] + add[i];
      out[i] = static_cast<float>(s0 * scale);
      sum[i] = s0 - sub[i];
    }
  }
}

// The colour conversions take an image of rows x cols pixels.

// RGB -> HSV, hue in 0..180 (OpenCV's fixed point).
void rgb_to_hsv_u8(const uint8_t* src, int64_t rows, int cols,
                   uint8_t* dst) {
  const int64_t n = rows * cols;
  const HsvTables& t = hsv_tables();
  const int half = 1 << (kHsvShift - 1);
  for (int64_t i = 0; i < n; ++i, src += 3, dst += 3) {
    const int r = src[0], g = src[1], b = src[2];
    const int v = std::max(std::max(r, g), b);
    const int vmin = std::min(std::min(r, g), b);
    const int diff = v - vmin;
    const int s = (diff * t.sdiv[v] + half) >> kHsvShift;
    int h = v == r ? g - b : v == g ? b - r + 2 * diff : r - g + 4 * diff;
    h = (h * t.hdiv[diff] + half) >> kHsvShift;
    h += h < 0 ? 180 : 0;
    dst[0] = sat_u8(h);
    dst[1] = static_cast<uint8_t>(s);
    dst[2] = static_cast<uint8_t>(v);
  }
}

// HSV (hue 0..180) -> RGB: OpenCV's float sectors and fused multiply-adds. Each row goes in steps of
// 32 pixels, whose results OpenCV's vector code truncates, and a tail of
// cols % 32 pixels, whose results its scalar code rounds.
void hsv_to_rgb_u8(const uint8_t* src, int64_t rows, int cols, uint8_t* dst) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = 6.0f / 180;
  const float inv255 = 1.0f / 255.0f;
  const int vec_end = cols - cols % kHsvStep;
  for (int64_t y = 0; y < rows; ++y)
    for (int x = 0; x < cols; ++x, src += 3, dst += 3) {
      float h = static_cast<float>(src[0]) * hscale;
      const float s = static_cast<float>(src[1]) * inv255;
      const float v = static_cast<float>(src[2]) * inv255;
      h = std::fmod(h, 6.0f);
      int sector = static_cast<int>(std::floor(h));
      h -= static_cast<float>(sector);
      if (sector < 0 || sector >= 6) sector = 0;
      const float tab[4] = {v, v * (1.0f - s), v * std::fmaf(-s, h, 1.0f),
                            v * std::fmaf(-s, 1.0f - h, 1.0f)};
      const float rgb[3] = {tab[sector_data[sector][2]] * 255.0f,
                            tab[sector_data[sector][1]] * 255.0f,
                            tab[sector_data[sector][0]] * 255.0f};
      for (int c = 0; c < 3; ++c)
        dst[c] = sat_u8(x < vec_end ? static_cast<int>(rgb[c])
                                    : static_cast<int>(std::lrintf(rgb[c])));
    }
}

// sRGB -> Lab (L * 255 / 100, a + 128, b + 128).
void rgb_to_lab_u8(const uint8_t* src, int64_t rows, int cols,
                   uint8_t* dst) {
  const int64_t n = rows * cols;
  const LabTables& t = lab_tables();
  const int* c = t.to_lab;
  const int lscale = (116 * 255 + 50) / 100;
  const int lshift = -((16 * 255 * (1 << kLabShift2) + 50) / 100);
  for (int64_t i = 0; i < n; ++i, src += 3, dst += 3) {
    const int r = t.gamma[src[0]], g = t.gamma[src[1]], b = t.gamma[src[2]];
    const int fx = t.cbrt[descale(r * c[0] + g * c[1] + b * c[2], kLabShift)];
    const int fy = t.cbrt[descale(r * c[3] + g * c[4] + b * c[5], kLabShift)];
    const int fz = t.cbrt[descale(r * c[6] + g * c[7] + b * c[8], kLabShift)];
    const int l = descale(lscale * fy + lshift, kLabShift2);
    const int a = descale(500 * (fx - fy) + 128 * (1 << kLabShift2),
                          kLabShift2);
    const int bb = descale(200 * (fy - fz) + 128 * (1 << kLabShift2),
                           kLabShift2);
    dst[0] = sat_u8(l);
    dst[1] = sat_u8(a);
    dst[2] = sat_u8(bb);
  }
}

// Lab -> sRGB through OpenCV's integer tables.
void lab_to_rgb_u8(const uint8_t* src, int64_t rows, int cols,
                   uint8_t* dst) {
  const int64_t n = rows * cols;
  const LabTables& t = lab_tables();
  const int* c = t.to_rgb;
  const int shift = kLabShift + 14 - 12;
  for (int64_t i = 0; i < n; ++i, src += 3, dst += 3) {
    const int y = t.y_of_l[src[0]];
    const int ify = t.fy_of_l[src[0]];
    const int adiv = ((5 * src[1] * 53687 + (1 << 7)) >> 13) - 128 * kBase / 500;
    const int bdiv = ((src[2] * 41943 + (1 << 4)) >> 9) - 128 * kBase / 200 + 1;
    const int x = t.xz_of_f[ify + adiv - kMinAB];
    const int z = t.xz_of_f[ify - bdiv - kMinAB];
    for (int ch = 0; ch < 3; ++ch) {
      int v = descale(c[ch * 3] * x + c[ch * 3 + 1] * y + c[ch * 3 + 2] * z,
                      shift);
      v = std::max(0, std::min(kInvGammaSize - 1, v));
      dst[ch] = static_cast<uint8_t>(t.inv_gamma[v]);
    }
  }
}

// Contrast-limited adaptive histogram equalization of an (h, w) uint8
// plane over tiles_x x tiles_y tiles. Where h or w is not a multiple of
// the tile count, the plane is extended (reflect-101) on the bottom and the
// right by tiles - (size % tiles) rows and columns, in both directions.
void clahe_u8(const uint8_t* src, int h, int w, double clip_limit,
              int tiles_x, int tiles_y, uint8_t* dst) {
  if (h <= 0 || w <= 0) return;
  const bool exact = h % tiles_y == 0 && w % tiles_x == 0;
  const int he = exact ? h : h + tiles_y - h % tiles_y;
  const int we = exact ? w : w + tiles_x - w % tiles_x;
  const int th = he / tiles_y, tw = we / tiles_x;
  const int area = th * tw;
  const float lut_scale = static_cast<float>(255) / area;
  int limit = 0;
  if (clip_limit > 0.0) {
    limit = static_cast<int>(clip_limit * area / 256);
    limit = std::max(limit, 1);
  }
  std::vector<int> xi(we), yi(he);
  for (int i = 0; i < we; ++i) xi[i] = reflect101(i, w);
  for (int i = 0; i < he; ++i) yi[i] = reflect101(i, h);
  std::vector<uint8_t> lut(static_cast<size_t>(tiles_x) * tiles_y * 256);
  int hist[256];
  for (int ty = 0; ty < tiles_y; ++ty)
    for (int tx = 0; tx < tiles_x; ++tx) {
      std::fill(hist, hist + 256, 0);
      for (int y = ty * th; y < (ty + 1) * th; ++y) {
        const uint8_t* row = src + static_cast<int64_t>(yi[y]) * w;
        for (int x = tx * tw; x < (tx + 1) * tw; ++x) ++hist[row[xi[x]]];
      }
      if (limit > 0) {
        int clipped = 0;
        for (int i = 0; i < 256; ++i)
          if (hist[i] > limit) {
            clipped += hist[i] - limit;
            hist[i] = limit;
          }
        const int batch = clipped / 256;
        int residual = clipped - batch * 256;
        for (int i = 0; i < 256; ++i) hist[i] += batch;
        if (residual != 0) {
          const int step = std::max(256 / residual, 1);
          for (int i = 0; i < 256 && residual > 0; i += step, --residual)
            ++hist[i];
        }
      }
      uint8_t* tl = lut.data() + (static_cast<size_t>(ty) * tiles_x + tx) * 256;
      int sum = 0;
      for (int i = 0; i < 256; ++i) {
        sum += hist[i];
        tl[i] = sat_u8(static_cast<int>(std::lrintf(
            static_cast<float>(sum) * lut_scale)));
      }
    }
  const float inv_tw = 1.0f / tw, inv_th = 1.0f / th;
  std::vector<int> ind1(w), ind2(w);
  std::vector<float> xa(w), xa1(w);
  for (int x = 0; x < w; ++x) {
    const float txf = static_cast<float>(x) * inv_tw - 0.5f;
    const int tx1 = static_cast<int>(std::floor(txf));
    xa[x] = txf - static_cast<float>(tx1);
    xa1[x] = 1.0f - xa[x];
    ind1[x] = std::max(tx1, 0) * 256;
    ind2[x] = std::min(tx1 + 1, tiles_x - 1) * 256;
  }
  for (int y = 0; y < h; ++y) {
    const float tyf = static_cast<float>(y) * inv_th - 0.5f;
    const int ty1 = static_cast<int>(std::floor(tyf));
    const float ya = tyf - static_cast<float>(ty1), ya1 = 1.0f - ya;
    const uint8_t* lut1 = lut.data() + static_cast<size_t>(
        std::max(ty1, 0)) * tiles_x * 256;
    const uint8_t* lut2 = lut.data() + static_cast<size_t>(
        std::min(ty1 + 1, tiles_y - 1)) * tiles_x * 256;
    const uint8_t* row = src + static_cast<int64_t>(y) * w;
    uint8_t* out = dst + static_cast<int64_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      const int v = row[x];
      const float res =
          (lut1[ind1[x] + v] * xa1[x] + lut1[ind2[x] + v] * xa[x]) * ya1 +
          (lut2[ind1[x] + v] * xa1[x] + lut2[ind2[x] + v] * xa[x]) * ya;
      out[x] = sat_u8(static_cast<int>(std::lrintf(res)));
    }
  }
}

// Halve an (h, w, 3) float32 image (h, w even) by bilinear resize at
// exactly 0.5: each output pixel lerps its 2x2 block, rows first.
void downscale2x_linear_f32(const float* src, int h, int w, float* dst) {
  const int dh = h / 2, dw = w / 2;
  const int64_t stride = static_cast<int64_t>(w) * 3;
  for (int y = 0; y < dh; ++y) {
    const float* r0 = src + 2 * y * stride;
    const float* r1 = r0 + stride;
    float* out = dst + static_cast<int64_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x)
      for (int c = 0; c < 3; ++c) {
        const int i = 6 * x + c;
        const float top = r0[i] + (r0[i + 3] - r0[i]) * 0.5f;
        const float bot = r1[i] + (r1[i + 3] - r1[i]) * 0.5f;
        out[3 * x + c] = top + (bot - top) * 0.5f;
      }
  }
}

}  // extern "C"
