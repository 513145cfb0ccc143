// Per-pixel color conversions for the fused kernels K1 and K2.
//
// Device versions of curl_tpu_torch/ops/color_planes.py, which is the plain
// torch form of the same arithmetic. Every constant is the float rounding of
// the double constant the Python code writes, the `maximum(x, 1e-4)` clamps
// guard every power, `branch` is the branchless `lo*c + hi*(1-c)` blend, the
// reciprocal guard treats |d| <= 1e-10 as zero, and channels tied for the
// maximum add their hue terms.
//
// The primitives, each in the cheapest form that keeps the kernels'
// contracts:
//   div<D>(x)       x / D::c, for the constant divisors D listed below;
//   recip(x)        1 / x (safe_recip);
//   srgb_pow(u)     u^2.4 (srgb_linearize);
//   srgb_root(x)    x^(1/2.4) (srgb_encode);
//   cube(t)         t^3 (lab_finv);
//   cube_root(t)    t^(1/3) (lab_f);
//   sigmoid(x)      1 / (1 + e^-x) (K1's polynomial outputs).
// Worst errors in ulps of the float32 nearest float64 of the exact
// function, over every float32 of the primitive's domain, from the
// per-function check on the card (csrc/color_math_check.cu,
// ops/kernels/color_math.py; NVIDIA H100 80GB HBM3), beside the IEEE forms
// (IEEE division, powf, expf) that check holds them to:
//   div        q = x * r; e = fma(-q, c, x); q = fma(e, r, q), with r = 1/c
//              rounded to float once, at compile time (Markstein's
//              correction: with r correctly rounded, q is the correctly
//              rounded quotient while the residual e is exact). An integer
//              c leaves no bit of q * c below 2^-149, so e is exact for
//              every normal quotient. For the other c it underflows for |x|
//              below ~2^-103, so there x below 2^-64 is scaled by 2^64 first
//              and the quotient back (two predicated multiplies). Bitwise
//              IEEE x / c for every float32 x whose quotient is normal
//              (0.5 ulp), with no FCHK, MUFU or slow path.
//   recip      __frcp_rn(x): the correctly rounded 1/x, bitwise IEEE.
//   sigmoid    __frcp_rn(1 + expf(-x)): bitwise IEEE's 1 / (1 + expf(-x)),
//              3.43 ulp where the sigmoid is normal.
//   srgb_pow   ex2.approx(2.4f * lg2.approx(u)) on the special-function
//              unit, u in [0.0522, 2] (srgb_linearize clamps u >= 0.0522):
//              19.8 ulp, 1.6e-6 absolute (powf 0.90 ulp).
//   srgb_root  ex2.approx(float(1/2.4) * lg2.approx(x)), x in [1e-4, 8]:
//              7.4 ulp, 4.2e-7 absolute (powf 0.91 ulp).
//   cube       t * t * t, t in [1e-4, 2]: 1.29 ulp (powf 0.90).
//   cube_root  cbrtf(t), t in [1e-4, 2]: 1.16 ulp (powf(t, float(1/3))
//              2.01).
// Neither power domain holds a zero, a subnormal, an infinity or a NaN, so
// the flush-to-zero MUFU forms need no special cases. The ulps of the four
// inexact primitives are this card's records (its MUFU's and libdevice's),
// not limits of the design, and may differ on another GPU; what the design
// holds to are the kernels' contracts against their plain versions (K1
// within 2e-4 in fp32, K2's flip share), which chip_smoke.py and the card
// tests check. The bitwise forms hold on any card. The build uses no fast
// math.
#pragma once

#include <cuda_runtime.h>

namespace curl_planes {

constexpr double kEps = 6.0 / 29.0;

// The constant divisors of the conversions, c in each. `div` multiplies by
// the float reciprocal 1/c it rounds at compile time. The divisors' list, in
// this order, is the check library's and tests/test_torch_color_math.py
// parses it.
struct By12_92 { static constexpr float c = 12.92f; };
struct By1_055 { static constexpr float c = 1.055f; };
struct ByWhiteX { static constexpr float c = 0.950456f; };
struct ByWhiteZ { static constexpr float c = 1.088754f; };
struct By3Eps2 { static constexpr float c = static_cast<float>(3.0 * kEps * kEps); };
struct By100 { static constexpr float c = 100.0f; };
struct By110 { static constexpr float c = 110.0f; };
struct By116 { static constexpr float c = 116.0f; };
struct By500 { static constexpr float c = 500.0f; };
struct By200 { static constexpr float c = 200.0f; };
struct By60 { static constexpr float c = 60.0f; };
struct By360 { static constexpr float c = 360.0f; };
struct By255 { static constexpr float c = 255.0f; };

template <class... D> struct Divisors {};
using AllDivisors = Divisors<By12_92, By1_055, ByWhiteX, ByWhiteZ, By3Eps2, By100, By110,
                             By116, By500, By200, By60, By360, By255>;

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x / D::c.
template <class D> __device__ __forceinline__ float div(float x) {
  constexpr float r = 1.0f / D::c;
  if constexpr (D::c == static_cast<float>(static_cast<long long>(D::c))) {
    const float q = x * r;
    return fmaf(fmaf(-q, D::c, x), r, q);
  } else {
    const bool tiny = fabsf(x) < 0x1p-64f;
    const float xs = tiny ? x * 0x1p64f : x;
    const float q = xs * r;
    const float quotient = fmaf(fmaf(-q, D::c, xs), r, q);
    return tiny ? quotient * 0x1p-64f : quotient;
  }
}

__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }

__device__ __forceinline__ float srgb_pow(float u) { return ex2_approx(2.4f * lg2_approx(u)); }

__device__ __forceinline__ float srgb_root(float x) {
  return ex2_approx(static_cast<float>(1.0 / 2.4) * lg2_approx(x));
}

__device__ __forceinline__ float cube(float t) { return t * t * t; }

__device__ __forceinline__ float cube_root(float t) { return cbrtf(t); }

__device__ __forceinline__ float sigmoid(float x) { return __frcp_rn(1.0f + expf(-x)); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float branch(bool cond, float lo, float hi) {
  const float c = cond ? 1.0f : 0.0f;
  return lo * c + hi * (1.0f - c);
}

__device__ __forceinline__ float srgb_linearize(float x) {
  return branch(x <= 0.04045f, div<By12_92>(x),
                srgb_pow(div<By1_055>(fmaxf(x, 1e-4f) + 0.055f)));
}

__device__ __forceinline__ float srgb_encode(float x) {
  return branch(x <= 0.0031308f, x * 12.92f, srgb_root(fmaxf(x, 1e-4f)) * 1.055f - 0.055f);
}

__device__ __forceinline__ float lab_f(float t) {
  return branch(t <= static_cast<float>(kEps * kEps * kEps),
                div<By3Eps2>(t) + static_cast<float>(4.0 / 29.0),
                cube_root(fmaxf(t, 1e-4f)));
}

__device__ __forceinline__ float lab_finv(float t) {
  return branch(t <= static_cast<float>(kEps),
                static_cast<float>(3.0 * kEps * kEps) * (t - static_cast<float>(4.0 / 29.0)),
                cube(fmaxf(t, 1e-4f)));
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
  x = div<ByWhiteX>(x);
  y = y / 1.0f;
  z = div<ByWhiteZ>(z);
  const float fx = lab_f(x), fy = lab_f(y), fz = lab_f(z);
  const float l_ = 116.0f * fy - 16.0f;
  const float a_ = 500.0f * (fx - fy);
  const float b_ = 200.0f * (fy - fz);
  l_out = div<By100>(l_);
  a_out = (div<By110>(a_) + 1.0f) / 2.0f;
  b_out = (div<By110>(b_) + 1.0f) / 2.0f;
}

// rgb_from_lab's intermediates, which K1's backward (trispace_backward.cu)
// reads for its vector-Jacobian product: the arguments of lab_finv and the
// linear RGB that srgb_encode takes.
struct LabState {
  float fx, fy, fz;
  float lin[3];
};

// Renormalized CIELab -> sRGB, its intermediates kept in `st`.
__device__ __forceinline__ void rgb_from_lab_state(float l_, float a_, float b_, LabState& st,
                                                   float& r_out, float& g_out, float& b_out) {
  l_ = l_ * 100.0f;
  a_ = (a_ * 2.0f - 1.0f) * 110.0f;
  b_ = (b_ * 2.0f - 1.0f) * 110.0f;
  st.fy = div<By116>(l_ + 16.0f);
  st.fx = st.fy + div<By500>(a_);
  st.fz = st.fy - div<By200>(b_);
  const float x = lab_finv(st.fx) * 0.950456f;
  const float y = lab_finv(st.fy) * 1.0f;
  const float z = lab_finv(st.fz) * 1.088754f;
  st.lin[0] = x * 3.2404542f + y * -1.5371385f + z * -0.4985314f;
  st.lin[1] = x * -0.9692660f + y * 1.8760108f + z * 0.0415560f;
  st.lin[2] = x * 0.0556434f + y * -0.2040259f + z * 1.0572252f;
  r_out = srgb_encode(st.lin[0]);
  g_out = srgb_encode(st.lin[1]);
  b_out = srgb_encode(st.lin[2]);
}

// Renormalized CIELab -> sRGB.
__device__ __forceinline__ void rgb_from_lab(float l_, float a_, float b_,
                                             float& r_out, float& g_out, float& b_out) {
  LabState st;
  rgb_from_lab_state(l_, a_, b_, st, r_out, g_out, b_out);
}

__device__ __forceinline__ float safe_recip(float x) {
  return fabsf(x) > 1e-10f ? recip(x) : 0.0f;
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
  hue = div<By360>(hue);
  const float mx_inv = safe_recip(mx);
  const float sat = mx <= 1e-10f ? 0.0f : (mx > 1e-10f ? 1.0f : 0.0f) * (df * mx_inv);
  h_out = clampf(hue, 1e-9f, 1.0f);
  s_out = clampf(sat, 1e-9f, 1.0f);
  v_out = clampf(mx, 1e-9f, 1.0f);
}

__device__ __forceinline__ float hue_ramp(float h360, float theta, float width) {
  return clampf(h360 - theta, 0.0f, width);
}

// rgb_from_hsv's terms before its output clip, which K1's backward reads:
// the clamped inputs, h in degrees, the ramps' floor and slopes, the six
// hue ramps and the unclipped r, g, b.
struct HsvRamps {
  float h, s, v, h360, vmin, m_dn, m_up;
  float p0, p60, p120, p180, p240, p300;
  float r, g, b;
};

__device__ __forceinline__ HsvRamps hsv_ramps(float h, float s, float v) {
  HsvRamps t;
  t.h = clampf(h, 0.0f, 1.0f);
  t.s = clampf(s, 0.0f, 1.0f);
  t.v = clampf(v, 0.0f, 1.0f);
  t.h360 = t.h * 360.0f;
  t.vmin = t.v * (1.0f - t.s);
  t.m_dn = div<By60>(t.vmin - t.v);
  t.p60 = hue_ramp(t.h360, 60.0f, 60.0f);
  t.p240 = hue_ramp(t.h360, 240.0f, 60.0f);
  t.r = t.v + t.p60 * t.m_dn + t.p240 * (-1.0f * t.m_dn);
  t.m_up = div<By60>(t.v - t.vmin);
  t.p0 = hue_ramp(t.h360, 0.0f, 60.0f);
  t.p180 = hue_ramp(t.h360, 180.0f, 60.0f);
  t.g = t.vmin + t.p0 * t.m_up + t.p180 * (-1.0f * t.m_up);
  t.p120 = hue_ramp(t.h360, 120.0f, 60.0f);
  t.p300 = hue_ramp(t.h360, 300.0f, 60.0f);
  t.b = t.vmin + t.p120 * t.m_up + t.p300 * (-1.0f * t.m_up);
  return t;
}

// HSV -> RGB by clamped hue ramps, inputs and outputs clamped to [0, 1].
__device__ __forceinline__ void rgb_from_hsv(float h, float s, float v,
                                             float& r_out, float& g_out, float& b_out) {
  const HsvRamps t = hsv_ramps(h, s, v);
  r_out = clampf(t.r, 0.0f, 1.0f);
  g_out = clampf(t.g, 0.0f, 1.0f);
  b_out = clampf(t.b, 0.0f, 1.0f);
}

}  // namespace curl_planes
