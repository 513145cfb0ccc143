// Per-pixel color conversions for the fused kernels K1 and K2.
//
// Device versions of curl_tpu_torch/ops/color_planes.py, which is the plain
// torch form of the same arithmetic. Every constant is the float rounding of
// the double constant the Python code writes, the `maximum(x, 1e-4)` clamps
// guard every power, `branch` is the branchless `lo*c + hi*(1-c)` blend, the
// reciprocal guard treats |d| <= 1e-10 as zero, and channels tied for the
// maximum add their hue terms.
//
// Math policies. Each conversion is written once over a policy P, which
// supplies the primitives:
//   div<P, D>(x)    x / D::c, for the constant divisors D listed below;
//   P::recip(x)     1 / x (safe_recip);
//   P::srgb_pow(u)  u^2.4 (srgb_linearize);
//   P::srgb_root(x) x^(1/2.4) (srgb_encode);
//   P::cube(t)      t^3 (lab_finv);
//   P::cbrt(t)      t^(1/3) (lab_f);
//   P::sigmoid(x)   1 / (1 + e^-x) (K1's polynomial outputs).
// An instance fixes its policy at build time: K1's in its generated header
// (ops/kernels/poly_tables.py MATH), K2's by its knot counts
// (curve_kernel.cu).
//
// Ieee keeps the first designs' bodies: IEEE powf, expf and divisions, as
// the build uses no fast math. Long dependent sequences: each powf is a few
// dozen instructions of double-float log and exp, each division an FCHK
// with a branch around its slow path, and `branch` computes both sides, so
// all 12 powf run at every pixel.
//
// Lean gives each primitive the cheapest form that keeps the kernels'
// contracts. Worst errors in ulps of the float32 nearest float64 of the
// exact function, over every float32 of the primitive's domain, from the
// per-function check on the card (csrc/color_math_check.cu,
// ops/kernels/color_math.py; NVIDIA H100 80GB HBM3), Ieee's beside:
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
//   recip      __frcp_rn(x): the correctly rounded 1/x, bitwise Ieee.
//   sigmoid    __frcp_rn(1 + expf(-x)): bitwise Ieee, 3.43 ulp where the
//              sigmoid is normal.
//   srgb_pow   ex2.approx(2.4f * lg2.approx(u)) on the special-function
//              unit, u in [0.0522, 2] (srgb_linearize clamps u >= 0.0522):
//              19.8 ulp, 1.6e-6 absolute (Ieee 0.90 ulp).
//   srgb_root  ex2.approx(float(1/2.4) * lg2.approx(x)), x in [1e-4, 8]:
//              7.4 ulp, 4.2e-7 absolute (Ieee 0.91 ulp).
//   cube       t * t * t, t in [1e-4, 2]: 1.29 ulp (Ieee powf 0.90).
//   cbrt       cbrtf(t), t in [1e-4, 2]: 1.16 ulp (Ieee powf(t, float(1/3))
//              2.01).
// Neither power domain holds a zero, a subnormal, an infinity or a NaN, so
// the flush-to-zero MUFU forms need no special cases. The ulps of the four
// inexact primitives are this card's records (its MUFU's and libdevice's),
// not limits of the design, and may differ on another GPU; what the design
// holds to are the kernels' contracts against their plain versions (K1
// within 2e-4 in fp32, K2's flip share), which chip_smoke.py and the card
// tests check. The bitwise forms hold on any card.
#pragma once

#include <cuda_runtime.h>

namespace curl_planes {

constexpr double kEps = 6.0 / 29.0;

// The constant divisors of the conversions, c in each. Lean divides by the
// float reciprocal 1/c it rounds at compile time. The divisors' list, in
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

struct Ieee {
  template <class D> static __device__ __forceinline__ float div(float x) { return x / D::c; }
  static __device__ __forceinline__ float recip(float x) { return 1.0f / x; }
  static __device__ __forceinline__ float srgb_pow(float u) { return powf(u, 2.4f); }
  static __device__ __forceinline__ float srgb_root(float x) {
    return powf(x, static_cast<float>(1.0 / 2.4));
  }
  static __device__ __forceinline__ float cube(float t) { return powf(t, 3.0f); }
  static __device__ __forceinline__ float cbrt(float t) {
    return powf(t, static_cast<float>(1.0 / 3.0));
  }
  static __device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
};

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

struct Lean {
  template <class D> static __device__ __forceinline__ float div(float x) {
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
  static __device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }
  static __device__ __forceinline__ float srgb_pow(float u) {
    return ex2_approx(2.4f * lg2_approx(u));
  }
  static __device__ __forceinline__ float srgb_root(float x) {
    return ex2_approx(static_cast<float>(1.0 / 2.4) * lg2_approx(x));
  }
  static __device__ __forceinline__ float cube(float t) { return t * t * t; }
  static __device__ __forceinline__ float cbrt(float t) { return cbrtf(t); }
  static __device__ __forceinline__ float sigmoid(float x) {
    return __frcp_rn(1.0f + expf(-x));
  }
};

// x / D::c under policy P.
template <class P, class D> __device__ __forceinline__ float div(float x) {
  return P::template div<D>(x);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float branch(bool cond, float lo, float hi) {
  const float c = cond ? 1.0f : 0.0f;
  return lo * c + hi * (1.0f - c);
}

template <class P> __device__ __forceinline__ float srgb_linearize(float x) {
  return branch(x <= 0.04045f, div<P, By12_92>(x),
                P::srgb_pow(div<P, By1_055>(fmaxf(x, 1e-4f) + 0.055f)));
}

template <class P> __device__ __forceinline__ float srgb_encode(float x) {
  return branch(x <= 0.0031308f, x * 12.92f, P::srgb_root(fmaxf(x, 1e-4f)) * 1.055f - 0.055f);
}

template <class P> __device__ __forceinline__ float lab_f(float t) {
  return branch(t <= static_cast<float>(kEps * kEps * kEps),
                div<P, By3Eps2>(t) + static_cast<float>(4.0 / 29.0),
                P::cbrt(fmaxf(t, 1e-4f)));
}

template <class P> __device__ __forceinline__ float lab_finv(float t) {
  return branch(t <= static_cast<float>(kEps),
                static_cast<float>(3.0 * kEps * kEps) * (t - static_cast<float>(4.0 / 29.0)),
                P::cube(fmaxf(t, 1e-4f)));
}

// sRGB -> renormalized CIELab (L/100, (a/110+1)/2, (b/110+1)/2).
template <class P>
__device__ __forceinline__ void lab_from_rgb(float r, float g, float b,
                                             float& l_out, float& a_out, float& b_out) {
  r = srgb_linearize<P>(r);
  g = srgb_linearize<P>(g);
  b = srgb_linearize<P>(b);
  float x = r * 0.412453f + g * 0.357580f + b * 0.180423f;
  float y = r * 0.212671f + g * 0.715160f + b * 0.072169f;
  float z = r * 0.019334f + g * 0.119193f + b * 0.950227f;
  x = div<P, ByWhiteX>(x);
  y = y / 1.0f;
  z = div<P, ByWhiteZ>(z);
  const float fx = lab_f<P>(x), fy = lab_f<P>(y), fz = lab_f<P>(z);
  const float l_ = 116.0f * fy - 16.0f;
  const float a_ = 500.0f * (fx - fy);
  const float b_ = 200.0f * (fy - fz);
  l_out = div<P, By100>(l_);
  a_out = (div<P, By110>(a_) + 1.0f) / 2.0f;
  b_out = (div<P, By110>(b_) + 1.0f) / 2.0f;
}

// Renormalized CIELab -> sRGB.
template <class P>
__device__ __forceinline__ void rgb_from_lab(float l_, float a_, float b_,
                                             float& r_out, float& g_out, float& b_out) {
  l_ = l_ * 100.0f;
  a_ = (a_ * 2.0f - 1.0f) * 110.0f;
  b_ = (b_ * 2.0f - 1.0f) * 110.0f;
  const float fy = div<P, By116>(l_ + 16.0f);
  const float fx = fy + div<P, By500>(a_);
  const float fz = fy - div<P, By200>(b_);
  const float x = lab_finv<P>(fx) * 0.950456f;
  const float y = lab_finv<P>(fy) * 1.0f;
  const float z = lab_finv<P>(fz) * 1.088754f;
  const float r = x * 3.2404542f + y * -1.5371385f + z * -0.4985314f;
  const float g = x * -0.9692660f + y * 1.8760108f + z * 0.0415560f;
  const float b = x * 0.0556434f + y * -0.2040259f + z * 1.0572252f;
  r_out = srgb_encode<P>(r);
  g_out = srgb_encode<P>(g);
  b_out = srgb_encode<P>(b);
}

template <class P> __device__ __forceinline__ float safe_recip(float x) {
  return fabsf(x) > 1e-10f ? P::recip(x) : 0.0f;
}

// RGB -> HSV with every channel clamped to [1e-9, 1].
template <class P>
__device__ __forceinline__ void hsv_from_rgb(float r, float g, float b,
                                             float& h_out, float& s_out, float& v_out) {
  r = clampf(r, 1e-9f, 1.0f);
  g = clampf(g, 1e-9f, 1.0f);
  b = clampf(b, 1e-9f, 1.0f);
  const float mx = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float df = mx + (-1.0f) * mn;
  const float df_inv = safe_recip<P>(df);
  float hue = 0.0f;
  if (!(df <= 1e-10f)) {
    // Additive ties: every channel equal to the maximum adds its term.
    hue = ((g - b) * df_inv) * (r == mx ? 1.0f : 0.0f)
        + (2.0f + (b - r) * df_inv) * (g == mx ? 1.0f : 0.0f)
        + (4.0f + (r - g) * df_inv) * (b == mx ? 1.0f : 0.0f);
  }
  hue = hue * 60.0f;
  hue = (hue < 0.0f ? 1.0f : 0.0f) * (hue + 360.0f) + (hue >= 0.0f ? 1.0f : 0.0f) * hue;
  hue = div<P, By360>(hue);
  const float mx_inv = safe_recip<P>(mx);
  const float sat = mx <= 1e-10f ? 0.0f : (mx > 1e-10f ? 1.0f : 0.0f) * (df * mx_inv);
  h_out = clampf(hue, 1e-9f, 1.0f);
  s_out = clampf(sat, 1e-9f, 1.0f);
  v_out = clampf(mx, 1e-9f, 1.0f);
}

__device__ __forceinline__ float hue_ramp(float h360, float theta, float width) {
  return clampf(h360 - theta, 0.0f, width);
}

// HSV -> RGB by clamped hue ramps, inputs and outputs clamped to [0, 1].
template <class P>
__device__ __forceinline__ void rgb_from_hsv(float h, float s, float v,
                                             float& r_out, float& g_out, float& b_out) {
  h = clampf(h, 0.0f, 1.0f);
  s = clampf(s, 0.0f, 1.0f);
  v = clampf(v, 0.0f, 1.0f);
  const float h360 = h * 360.0f;
  const float vmin = v * (1.0f - s);
  const float m_dn = div<P, By60>(vmin - v);
  const float r = v + hue_ramp(h360, 60.0f, 60.0f) * m_dn
                + hue_ramp(h360, 240.0f, 60.0f) * (-1.0f * m_dn);
  const float m_up = div<P, By60>(v - vmin);
  const float g = vmin + hue_ramp(h360, 0.0f, 60.0f) * m_up
                + hue_ramp(h360, 180.0f, 60.0f) * (-1.0f * m_up);
  const float b = vmin + hue_ramp(h360, 120.0f, 60.0f) * m_up
                + hue_ramp(h360, 300.0f, 60.0f) * (-1.0f * m_up);
  r_out = clampf(r, 0.0f, 1.0f);
  g_out = clampf(g, 0.0f, 1.0f);
  b_out = clampf(b, 0.0f, 1.0f);
}

}  // namespace curl_planes
