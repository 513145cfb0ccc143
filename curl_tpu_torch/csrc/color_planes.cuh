// Per-pixel color conversions for the fused tri-space kernel.
//
// Device versions of curl_tpu_torch/ops/color_planes.py, which is the plain
// torch form of the same arithmetic. Every constant is the float rounding of
// the double constant the Python code writes, the `maximum(x, 1e-4)` clamps
// guard every power, `branch` is the branchless `lo*c + hi*(1-c)` blend, the
// reciprocal guard treats |d| <= 1e-10 as zero, and channels tied for the
// maximum add their hue terms. Built without fast math: powf, expf and the
// divisions are the IEEE-accurate versions.
#pragma once

namespace curl_planes {

constexpr double kEps = 6.0 / 29.0;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float branch(bool cond, float lo, float hi) {
  const float c = cond ? 1.0f : 0.0f;
  return lo * c + hi * (1.0f - c);
}

__device__ __forceinline__ float srgb_linearize(float x) {
  return branch(x <= 0.04045f, x / 12.92f,
                powf((fmaxf(x, 1e-4f) + 0.055f) / 1.055f, 2.4f));
}

__device__ __forceinline__ float srgb_encode(float x) {
  return branch(x <= 0.0031308f, x * 12.92f,
                powf(fmaxf(x, 1e-4f), static_cast<float>(1.0 / 2.4)) * 1.055f - 0.055f);
}

__device__ __forceinline__ float lab_f(float t) {
  return branch(t <= static_cast<float>(kEps * kEps * kEps),
                t / static_cast<float>(3.0 * kEps * kEps) + static_cast<float>(4.0 / 29.0),
                powf(fmaxf(t, 1e-4f), static_cast<float>(1.0 / 3.0)));
}

__device__ __forceinline__ float lab_finv(float t) {
  return branch(t <= static_cast<float>(kEps),
                static_cast<float>(3.0 * kEps * kEps) * (t - static_cast<float>(4.0 / 29.0)),
                powf(fmaxf(t, 1e-4f), 3.0f));
}

// sRGB -> renormalized CIELab (L/100, (a/110+1)/2, (b/110+1)/2).
__device__ __forceinline__ void lab_from_rgb(float r, float g, float b,
                                             float& l_out, float& a_out, float& b_out) {
  r = srgb_linearize(r);
  g = srgb_linearize(g);
  b = srgb_linearize(b);
  float x = r * 0.412453f + g * 0.357580f + b * 0.180423f;
  float y = r * 0.212671f + g * 0.715160f + b * 0.072169f;
  float z = r * 0.019334f + g * 0.119193f + b * 0.950227f;
  x = x / 0.950456f;
  y = y / 1.0f;
  z = z / 1.088754f;
  const float fx = lab_f(x), fy = lab_f(y), fz = lab_f(z);
  const float l_ = 116.0f * fy - 16.0f;
  const float a_ = 500.0f * (fx - fy);
  const float b_ = 200.0f * (fy - fz);
  l_out = l_ / 100.0f;
  a_out = (a_ / 110.0f + 1.0f) / 2.0f;
  b_out = (b_ / 110.0f + 1.0f) / 2.0f;
}

// Renormalized CIELab -> sRGB.
__device__ __forceinline__ void rgb_from_lab(float l_, float a_, float b_,
                                             float& r_out, float& g_out, float& b_out) {
  l_ = l_ * 100.0f;
  a_ = (a_ * 2.0f - 1.0f) * 110.0f;
  b_ = (b_ * 2.0f - 1.0f) * 110.0f;
  const float fy = (l_ + 16.0f) / 116.0f;
  const float fx = fy + a_ / 500.0f;
  const float fz = fy - b_ / 200.0f;
  const float x = lab_finv(fx) * 0.950456f;
  const float y = lab_finv(fy) * 1.0f;
  const float z = lab_finv(fz) * 1.088754f;
  const float r = x * 3.2404542f + y * -1.5371385f + z * -0.4985314f;
  const float g = x * -0.9692660f + y * 1.8760108f + z * 0.0415560f;
  const float b = x * 0.0556434f + y * -0.2040259f + z * 1.0572252f;
  r_out = srgb_encode(r);
  g_out = srgb_encode(g);
  b_out = srgb_encode(b);
}

__device__ __forceinline__ float safe_recip(float x) {
  return fabsf(x) > 1e-10f ? 1.0f / x : 0.0f;
}

// RGB -> HSV with every channel clamped to [1e-9, 1].
__device__ __forceinline__ void hsv_from_rgb(float r, float g, float b,
                                             float& h_out, float& s_out, float& v_out) {
  r = clampf(r, 1e-9f, 1.0f);
  g = clampf(g, 1e-9f, 1.0f);
  b = clampf(b, 1e-9f, 1.0f);
  const float mx = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float df = mx + (-1.0f) * mn;
  const float df_inv = safe_recip(df);
  float hue = 0.0f;
  if (!(df <= 1e-10f)) {
    // Additive ties: every channel equal to the maximum adds its term.
    hue = ((g - b) * df_inv) * (r == mx ? 1.0f : 0.0f)
        + (2.0f + (b - r) * df_inv) * (g == mx ? 1.0f : 0.0f)
        + (4.0f + (r - g) * df_inv) * (b == mx ? 1.0f : 0.0f);
  }
  hue = hue * 60.0f;
  hue = (hue < 0.0f ? 1.0f : 0.0f) * (hue + 360.0f) + (hue >= 0.0f ? 1.0f : 0.0f) * hue;
  hue = hue / 360.0f;
  const float mx_inv = safe_recip(mx);
  const float sat = mx <= 1e-10f ? 0.0f : (mx > 1e-10f ? 1.0f : 0.0f) * (df * mx_inv);
  h_out = clampf(hue, 1e-9f, 1.0f);
  s_out = clampf(sat, 1e-9f, 1.0f);
  v_out = clampf(mx, 1e-9f, 1.0f);
}

__device__ __forceinline__ float hue_ramp(float h360, float theta, float width) {
  return clampf(h360 - theta, 0.0f, width);
}

// HSV -> RGB by clamped hue ramps, inputs and outputs clamped to [0, 1].
__device__ __forceinline__ void rgb_from_hsv(float h, float s, float v,
                                             float& r_out, float& g_out, float& b_out) {
  h = clampf(h, 0.0f, 1.0f);
  s = clampf(s, 0.0f, 1.0f);
  v = clampf(v, 0.0f, 1.0f);
  const float h360 = h * 360.0f;
  const float vmin = v * (1.0f - s);
  const float m_dn = (vmin - v) / 60.0f;
  const float r = v + hue_ramp(h360, 60.0f, 60.0f) * m_dn
                + hue_ramp(h360, 240.0f, 60.0f) * (-1.0f * m_dn);
  const float m_up = (v - vmin) / 60.0f;
  const float g = vmin + hue_ramp(h360, 0.0f, 60.0f) * m_up
                + hue_ramp(h360, 180.0f, 60.0f) * (-1.0f * m_up);
  const float b = vmin + hue_ramp(h360, 120.0f, 60.0f) * m_up
                + hue_ramp(h360, 300.0f, 60.0f) * (-1.0f * m_up);
  r_out = clampf(r, 0.0f, 1.0f);
  g_out = clampf(g, 0.0f, 1.0f);
  b_out = clampf(b, 0.0f, 1.0f);
}

}  // namespace curl_planes
