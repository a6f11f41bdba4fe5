// Host-side image ops of the port's input pipeline: the port's own copy of
// the JAX package's native host ops, with the same numerics, built by
// margipose_tpu_torch/ops/_build.py with the same g++ flags so both
// libraries give the same bits.
//
// The reference feeds its GPU from PIL/Pillow-SIMD running in DataLoader
// worker processes (reference: src/margipose/data/__init__.py:97-108,193-199
// — affine warp + four separate colour-enhance passes per example). This
// library fuses the whole host-side per-example transform into one C++ pass:
//
//   uint8 RGB source
//     -> inverse-affine bilinear warp (PIL AFFINE semantics: sample at
//        A^-1 @ (x+.5, y+.5) - .5, zero fill outside)
//     -> brightness/contrast/saturation/hue jitter
//        (PIL ImageEnhance order and ITU-R 601-2 luma)
//     -> optional ImageNet normalisation straight to float32 HWC
//
// Exposed as a plain C ABI consumed via ctypes (margipose_tpu_torch/native.py);
// no Python.h dependency. Build: g++ -O3 -fPIC -shared -std=c++17.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr float kLumaR = 299.0f / 1000.0f;
constexpr float kLumaG = 587.0f / 1000.0f;
constexpr float kLumaB = 114.0f / 1000.0f;

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Bilinear sample of channel c at continuous index (sx, sy); zero outside.
inline float sample_bilinear(const uint8_t* src, int sh, int sw, float sx,
                             float sy, int c) {
  const int x0 = static_cast<int>(std::floor(sx));
  const int y0 = static_cast<int>(std::floor(sy));
  const float fx = sx - x0;
  const float fy = sy - y0;
  float acc = 0.0f;
  for (int dy = 0; dy < 2; ++dy) {
    const int y = y0 + dy;
    if (y < 0 || y >= sh) continue;
    const float wy = dy ? fy : 1.0f - fy;
    for (int dx = 0; dx < 2; ++dx) {
      const int x = x0 + dx;
      if (x < 0 || x >= sw) continue;
      const float wx = dx ? fx : 1.0f - fx;
      acc += wy * wx * src[(y * sw + x) * 3 + c];
    }
  }
  return acc;
}

// RGB [0,1] -> HSV [0,1] and back (matches ops/image.py conventions).
inline void rgb_to_hsv(float r, float g, float b, float* h, float* s,
                       float* v) {
  const float maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
  const float minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
  *v = maxc;
  const float span = maxc - minc;
  *s = maxc > 0.0f ? span / maxc : 0.0f;
  if (span <= 0.0f) {
    *h = 0.0f;
    return;
  }
  float hh;
  if (maxc == r) {
    hh = (g - b) / span;
  } else if (maxc == g) {
    hh = 2.0f + (b - r) / span;
  } else {
    hh = 4.0f + (r - g) / span;
  }
  hh /= 6.0f;
  *h = hh - std::floor(hh);
}

inline void hsv_to_rgb(float h, float s, float v, float* r, float* g,
                       float* b) {
  const float h6 = h * 6.0f;
  const int i = static_cast<int>(std::floor(h6)) % 6;
  const float f = h6 - std::floor(h6);
  const float p = v * (1.0f - s);
  const float q = v * (1.0f - s * f);
  const float t = v * (1.0f - s * (1.0f - f));
  switch (i < 0 ? i + 6 : i) {
    case 0: *r = v; *g = t; *b = p; break;
    case 1: *r = q; *g = v; *b = p; break;
    case 2: *r = p; *g = v; *b = t; break;
    case 3: *r = p; *g = q; *b = v; break;
    case 4: *r = t; *g = p; *b = v; break;
    default: *r = v; *g = p; *b = q; break;
  }
}

}  // namespace

extern "C" {

// Warp an RGB uint8 image with the inverse affine (input<-output, PIL
// 6-coeff order a,b,c,d,e,f: xin = a*xo + b*yo + c). Output uint8 RGB.
int mp_warp_rgb_u8(const uint8_t* src, int sh, int sw, const float* inv6,
                   uint8_t* dst, int oh, int ow) {
  if (!src || !dst || !inv6 || sh <= 0 || sw <= 0 || oh <= 0 || ow <= 0)
    return -1;
  const float a = inv6[0], b = inv6[1], c = inv6[2];
  const float d = inv6[3], e = inv6[4], f = inv6[5];
  for (int y = 0; y < oh; ++y) {
    const float yo = y + 0.5f;
    for (int x = 0; x < ow; ++x) {
      const float xo = x + 0.5f;
      const float sx = a * xo + b * yo + c - 0.5f;
      const float sy = d * xo + e * yo + f - 0.5f;
      uint8_t* out = dst + (y * ow + x) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        const float v = sample_bilinear(src, sh, sw, sx, sy, ch);
        out[ch] = static_cast<uint8_t>(clampf(v + 0.5f, 0.0f, 255.0f));
      }
    }
  }
  return 0;
}

// Fused warp + colour jitter (+ optional normalisation).
//
//   src:        uint8 RGB, sh x sw
//   inv6:       input<-output affine, PIL coefficient order
//   brightness/contrast/saturation: PIL ImageEnhance factors (1 = identity)
//   hue:        shift in [-0.5, 0.5] (0 = identity)
//   mean3/std3: per-channel normalisation in [0,1] units; pass NULL/NULL to
//               emit un-normalised [0,1] floats
//   dst:        float32 HWC, oh x ow x 3
int mp_warp_colour_norm(const uint8_t* src, int sh, int sw, const float* inv6,
                        float brightness, float contrast, float saturation,
                        float hue, const float* mean3, const float* std3,
                        float* dst, int oh, int ow) {
  if (!src || !dst || !inv6 || sh <= 0 || sw <= 0 || oh <= 0 || ow <= 0)
    return -1;
  const float a = inv6[0], b = inv6[1], c = inv6[2];
  const float d = inv6[3], e = inv6[4], f = inv6[5];
  const int n = oh * ow;

  // Pass 1: warp + brightness into dst (as [0,1] floats); accumulate the
  // grayscale mean needed by the contrast blend (PIL computes it on the
  // uint8-rounded brightness output; we stay in float — within test
  // tolerance of the PIL path).
  double gray_sum = 0.0;
  for (int y = 0; y < oh; ++y) {
    const float yo = y + 0.5f;
    for (int x = 0; x < ow; ++x) {
      const float xo = x + 0.5f;
      const float sx = a * xo + b * yo + c - 0.5f;
      const float sy = d * xo + e * yo + f - 0.5f;
      float* out = dst + (y * ow + x) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        const float v =
            sample_bilinear(src, sh, sw, sx, sy, ch) * (1.0f / 255.0f);
        out[ch] = clampf(v * brightness, 0.0f, 1.0f);
      }
      gray_sum += kLumaR * out[0] + kLumaG * out[1] + kLumaB * out[2];
    }
  }
  const float gray_mean = static_cast<float>(gray_sum / n);

  // Pass 2: contrast, saturation, hue, normalise.
  const bool do_hue = hue > 1e-8f || hue < -1e-8f;
  for (int i = 0; i < n; ++i) {
    float* px = dst + i * 3;
    float r = px[0], g = px[1], bl = px[2];

    r = gray_mean + (r - gray_mean) * contrast;
    g = gray_mean + (g - gray_mean) * contrast;
    bl = gray_mean + (bl - gray_mean) * contrast;

    const float gray = kLumaR * r + kLumaG * g + kLumaB * bl;
    r = gray + (r - gray) * saturation;
    g = gray + (g - gray) * saturation;
    bl = gray + (bl - gray) * saturation;

    r = clampf(r, 0.0f, 1.0f);
    g = clampf(g, 0.0f, 1.0f);
    bl = clampf(bl, 0.0f, 1.0f);

    if (do_hue) {
      float h, s, v;
      rgb_to_hsv(r, g, bl, &h, &s, &v);
      h += hue;
      h -= std::floor(h);
      hsv_to_rgb(h, s, v, &r, &g, &bl);
    }

    if (mean3 && std3) {
      px[0] = (r - mean3[0]) / std3[0];
      px[1] = (g - mean3[1]) / std3[1];
      px[2] = (bl - mean3[2]) / std3[2];
    } else {
      px[0] = r;
      px[1] = g;
      px[2] = bl;
    }
  }
  return 0;
}

// Composite: out = fg where mask else bg (PIL Image.composite semantics with
// a soft L-mode mask: linear blend by mask/255). All RGB uint8, same size.
int mp_composite_u8(const uint8_t* fg, const uint8_t* bg, const uint8_t* mask,
                    uint8_t* dst, int h, int w) {
  if (!fg || !bg || !mask || !dst || h <= 0 || w <= 0) return -1;
  const int n = h * w;
  for (int i = 0; i < n; ++i) {
    const float m = mask[i] * (1.0f / 255.0f);
    for (int ch = 0; ch < 3; ++ch) {
      const float v = fg[i * 3 + ch] * m + bg[i * 3 + ch] * (1.0f - m);
      dst[i * 3 + ch] = static_cast<uint8_t>(clampf(v + 0.5f, 0.0f, 255.0f));
    }
  }
  return 0;
}

int mp_version() { return 1; }

}  // extern "C"
