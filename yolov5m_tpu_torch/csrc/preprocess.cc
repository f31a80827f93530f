// Native host-side image preprocessing for the yolov5m_tpu_torch data
// pipeline: the port's own copy of yolov5m_tpu/_native_src/preprocess.cc,
// less its libjpeg decode (the port decodes JPEG with its own
// jpeg_decode.cc, built into the same library).
//
// Bilinear resize with half-pixel centers (OpenCV INTER_LINEAR semantics),
// letterbox padding and a u8 -> f32 normalize, multithreaded with OpenMP,
// behind a C ABI for ctypes. data/native.py builds it at first use with the
// JAX package's Makefile flags (-O3 -march=native -fPIC -fopenmp -Wall
// -Wextra, -shared), so its resize is the same code built the same way.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline float lerp(float a, float b, float t) { return a + t * (b - a); }

}  // namespace

extern "C" {

// Bilinear resize, uint8 HWC interleaved. Half-pixel-center sampling matches
// OpenCV INTER_LINEAR (and torch align_corners=False).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int ch,
                        uint8_t* dst, int dh, int dw) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;

#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * scale_y - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float ty = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * scale_x - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(sw - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float tx = fx - x0;
      const uint8_t* r0 = src + (static_cast<int64_t>(y0) * sw + x0) * ch;
      const uint8_t* r1 = src + (static_cast<int64_t>(y0) * sw + x1) * ch;
      const uint8_t* r2 = src + (static_cast<int64_t>(y1) * sw + x0) * ch;
      const uint8_t* r3 = src + (static_cast<int64_t>(y1) * sw + x1) * ch;
      uint8_t* out = dst + (static_cast<int64_t>(y) * dw + x) * ch;
      for (int c = 0; c < ch; ++c) {
        const float top = lerp(r0[c], r1[c], tx);
        const float bot = lerp(r2[c], r3[c], tx);
        out[c] = static_cast<uint8_t>(lerp(top, bot, ty) + 0.5f);
      }
    }
  }
}

// Letterbox: copy src into dst (pre-sized dh x dw) at offset (top, left),
// filling the border with `fill` (reference letterbox uses 114,
// utils/utils.py:119).
void letterbox_u8(const uint8_t* src, int sh, int sw, int ch,
                  uint8_t* dst, int dh, int dw, int top, int left,
                  uint8_t fill) {
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    uint8_t* row = dst + static_cast<int64_t>(y) * dw * ch;
    if (y < top || y >= top + sh) {
      std::memset(row, fill, static_cast<size_t>(dw) * ch);
      continue;
    }
    std::memset(row, fill, static_cast<size_t>(left) * ch);
    std::memcpy(row + static_cast<size_t>(left) * ch,
                src + static_cast<int64_t>(y - top) * sw * ch,
                static_cast<size_t>(sw) * ch);
    const int right_start = left + sw;
    std::memset(row + static_cast<size_t>(right_start) * ch, fill,
                static_cast<size_t>(dw - right_start) * ch);
  }
}

// Batched normalize: uint8 HWC → float32 HWC / 255, fused with optional
// letterbox already applied. Saves a numpy pass per batch.
void normalize_u8_to_f32(const uint8_t* src, float* dst, int64_t n) {
  constexpr float kInv = 1.0f / 255.0f;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * kInv;
}

}  // extern "C"
