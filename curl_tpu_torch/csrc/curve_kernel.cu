// Fused knot-curve pass (kernel K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// curl_tpu/ops/pallas/curve_kernel.py::_make_kernel(k_lab, k_rgb, k_hsv, out_dtype).kernel.
// Per pixel, in the order of that kernel:
//   RGB -> Lab, 3 Lab curves (L->L, a->a, b->b), x mask;
//   Lab -> RGB, 3 RGB curves (R->R, G->G, B->B), x mask;
//   RGB -> HSV, 4 HSV curves (H->H, H->S, S->S, V->V), x mask;
//   HSV -> RGB is the residual; out = clip(img + residual, 0, 1) * mask.
// A curve scales its output plane by c0 + sum_j slope_j * clip(n_seg*x - j, 0, 1),
// accumulated from c0 in j order, with x the driving plane and n_seg = K-1
// of its own group; then all three planes are clipped to [0, 1]. The HSV
// wiring is sequential: the H->S curve reads the H that H->H has already
// scaled and clipped. Nothing but the image, the mask, the knots and the
// output touches device memory.
//
// Knot counts: the (16, 16, 16) default (the 48/48/64 split of CurlCurveNet)
// is a template instance with every segment loop fully unrolled. Any other
// counts with 2 <= K <= kMaxKnots per group run the runtime-loop instance.
//
// What bounds it: by the TPU kernel's own cost estimate, 480 FLOP per pixel
// at the default counts; at 1080p batch 8 (16,588,800 px) that is 7.96
// GFLOP, 0.119 ms at 67 TFLOP/s fp32. It moves 28 B per pixel in fp32 (img
// 12, mask 4, out 12), 464.5 MB, 0.139 ms at 3.35 TB/s: on paper it is bound
// by bytes (0.139 ms fp32). With bf16 storage, 232 MB take 0.069 ms and the
// operations bound it at 0.119 ms.
//
// What really holds it back: the estimate leaves out the 12 IEEE powf of
// the Lab round trip (sRGB linearize and encode, the Lab f and its inverse),
// each a few dozen instructions, and counts a clamped ramp as 2 FLOP. So this
// simple kernel is expected to be bound by instruction issue, at roughly
// 1,300-1,600 instructions per pixel, well above either bound.
//
// What this design does about that: nothing yet. One thread per pixel, the
// ten curves' slopes and c0 staged in shared memory per block (10 x 15
// floats at the default, read as broadcasts), the ramps unrolled. Later
// work: an O(1) knot lookup (floor(n_seg*x) picks the segment; the scale is
// a prefix sum of slopes plus one partial ramp) in place of the 15-ramp
// sum, and a mask that is never materialized when it is all ones.
//
// Layout: NHWC img and out (3 consecutive values per pixel) and the
// (B, H, W, 1) mask, read directly. Grid: x covers the pixels of one image
// in blocks of kThreads, y is the image index. Flat offsets are int64. One
// launch covers any batch and resolution; the curve pass has no
// coordinates, so no row-band offsets are needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "color_planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCurves = 10;
constexpr int kMaxKnots = 65;
constexpr int kMaxSeg = kMaxKnots - 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// c0 + sum_j slope[j] * clip(n_seg * p - j, 0, 1). NSEG > 0 fixes the
// segment count at compile time; NSEG == 0 reads it from n_seg.
template <int NSEG>
__device__ __forceinline__ float curve_scale(float p, const float* slope, float c0,
                                             int n_seg) {
  float scale = c0;
  if constexpr (NSEG > 0) {
    const float x = static_cast<float>(NSEG) * p;
#pragma unroll
    for (int j = 0; j < NSEG; ++j) {
      scale += slope[j] * curl_planes::clampf(x - static_cast<float>(j), 0.0f, 1.0f);
    }
  } else {
    const float x = static_cast<float>(n_seg) * p;
    for (int j = 0; j < n_seg; ++j) {
      scale += slope[j] * curl_planes::clampf(x - static_cast<float>(j), 0.0f, 1.0f);
    }
  }
  return scale;
}

// Scale plane OUT by the curve driven by plane DRIVE, then clip all three.
template <int NSEG, int DRIVE, int OUT>
__device__ __forceinline__ void apply_curve(float (&pl)[3], const float* slope, float c0,
                                            int n_seg) {
  pl[OUT] *= curve_scale<NSEG>(pl[DRIVE], slope, c0, n_seg);
#pragma unroll
  for (int c = 0; c < 3; ++c) pl[c] = curl_planes::clampf(pl[c], 0.0f, 1.0f);
}

// KL, KR, KH: knots per curve of each group; all 0 selects the runtime
// counts k_lab, k_rgb, k_hsv.
template <typename T, int KL, int KR, int KH>
__global__ void __launch_bounds__(kThreads)
curve_enhance_kernel(const T* __restrict__ img, const T* __restrict__ mask,
                     const float* __restrict__ slopes, const float* __restrict__ c0,
                     T* __restrict__ out, long long pixels, int k_lab, int k_rgb,
                     int k_hsv) {
  constexpr bool kFixed = KL > 0;
  constexpr int kStaticSeg =
      kFixed ? ((KL > KR ? (KL > KH ? KL : KH) : (KR > KH ? KR : KH)) - 1) : kMaxSeg;
  __shared__ float s_slope[kCurves * kStaticSeg];
  __shared__ float s_c0[kCurves];

  const int n_lab = kFixed ? KL - 1 : k_lab - 1;
  const int n_rgb = kFixed ? KR - 1 : k_rgb - 1;
  const int n_hsv = kFixed ? KH - 1 : k_hsv - 1;
  const int seg = kFixed ? kStaticSeg : max(n_lab, max(n_rgb, n_hsv));

  // Stage this image's (10, seg) slopes and 10 c0 values.
  const long long image = blockIdx.y;
  const float* src = slopes + image * (kCurves * seg);
  for (int i = threadIdx.x; i < kCurves * seg; i += blockDim.x) s_slope[i] = src[i];
  if (threadIdx.x < kCurves) s_c0[threadIdx.x] = c0[image * kCurves + threadIdx.x];
  __syncthreads();

  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= pixels) return;
  const long long px = image * pixels + p;
  const long long off = px * 3;
  const float r = to_float(img[off]);
  const float g = to_float(img[off + 1]);
  const float b = to_float(img[off + 2]);
  const float m = to_float(mask[px]);

  constexpr int NL = kFixed ? KL - 1 : 0;
  constexpr int NR = kFixed ? KR - 1 : 0;
  constexpr int NH = kFixed ? KH - 1 : 0;
  const float* sl = s_slope;
  float pl[3];

  // Lab curves.
  curl_planes::lab_from_rgb(r, g, b, pl[0], pl[1], pl[2]);
  apply_curve<NL, 0, 0>(pl, sl + 0 * seg, s_c0[0], n_lab);
  apply_curve<NL, 1, 1>(pl, sl + 1 * seg, s_c0[1], n_lab);
  apply_curve<NL, 2, 2>(pl, sl + 2 * seg, s_c0[2], n_lab);
#pragma unroll
  for (int c = 0; c < 3; ++c) pl[c] *= m;

  // RGB curves.
  curl_planes::rgb_from_lab(pl[0], pl[1], pl[2], pl[0], pl[1], pl[2]);
  apply_curve<NR, 0, 0>(pl, sl + 3 * seg, s_c0[3], n_rgb);
  apply_curve<NR, 1, 1>(pl, sl + 4 * seg, s_c0[4], n_rgb);
  apply_curve<NR, 2, 2>(pl, sl + 5 * seg, s_c0[5], n_rgb);
#pragma unroll
  for (int c = 0; c < 3; ++c) pl[c] *= m;

  // HSV curves: H->H, H->S, S->S, V->V.
  curl_planes::hsv_from_rgb(pl[0], pl[1], pl[2], pl[0], pl[1], pl[2]);
  apply_curve<NH, 0, 0>(pl, sl + 6 * seg, s_c0[6], n_hsv);
  apply_curve<NH, 0, 1>(pl, sl + 7 * seg, s_c0[7], n_hsv);
  apply_curve<NH, 1, 1>(pl, sl + 8 * seg, s_c0[8], n_hsv);
  apply_curve<NH, 2, 2>(pl, sl + 9 * seg, s_c0[9], n_hsv);
#pragma unroll
  for (int c = 0; c < 3; ++c) pl[c] *= m;

  // Residual and composite.
  float res0, res1, res2;
  curl_planes::rgb_from_hsv(pl[0], pl[1], pl[2], res0, res1, res2);
  out[off] = from_float<T>(curl_planes::clampf(r + res0, 0.0f, 1.0f) * m);
  out[off + 1] = from_float<T>(curl_planes::clampf(g + res1, 0.0f, 1.0f) * m);
  out[off + 2] = from_float<T>(curl_planes::clampf(b + res2, 0.0f, 1.0f) * m);
}

template <typename T>
cudaError_t launch(const void* img, const void* mask, const void* slopes, const void* c0,
                   void* out, long long batch, long long pixels, int k_lab, int k_rgb,
                   int k_hsv, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((pixels + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  const T* i = static_cast<const T*>(img);
  const T* mk = static_cast<const T*>(mask);
  const float* s = static_cast<const float*>(slopes);
  const float* c = static_cast<const float*>(c0);
  T* o = static_cast<T*>(out);
  if (k_lab == 16 && k_rgb == 16 && k_hsv == 16) {
    curve_enhance_kernel<T, 16, 16, 16><<<grid, kThreads, 0, stream>>>(
        i, mk, s, c, o, pixels, k_lab, k_rgb, k_hsv);
  } else {
    curve_enhance_kernel<T, 0, 0, 0><<<grid, kThreads, 0, stream>>>(
        i, mk, s, c, o, pixels, k_lab, k_rgb, k_hsv);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img/out: (batch, pixels, 3) contiguous and mask: (batch, pixels, 1)
// contiguous, all float32 (bf16 == 0) or all bfloat16 (bf16 == 1).
// slopes: (batch, 10, S) contiguous float32, zero-padded, with
// S = max(k_lab, k_rgb, k_hsv) - 1; c0: (batch, 10) float32. Each k in
// 2..65. Launches on `stream` without synchronizing; returns
// cudaGetLastError() after the launch.
int curl_curve_enhance(const void* img, const void* mask, const void* slopes, const void* c0,
                       void* out, long long batch, long long pixels, int k_lab, int k_rgb,
                       int k_hsv, int bf16, void* stream) {
  const bool bad_k = k_lab < 2 || k_rgb < 2 || k_hsv < 2 || k_lab > kMaxKnots ||
                     k_rgb > kMaxKnots || k_hsv > kMaxKnots;
  if (batch <= 0 || batch > 65535 || pixels <= 0 || bad_k ||
      (pixels + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(img, mask, slopes, c0, out, batch, pixels, k_lab, k_rgb,
                                   k_hsv, s)
           : launch<float>(img, mask, slopes, c0, out, batch, pixels, k_lab, k_rgb, k_hsv, s);
  return static_cast<int>(err);
}

const char* curl_curve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
