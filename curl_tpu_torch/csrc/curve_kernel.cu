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
// with x the driving plane and n_seg = K-1 of its own group; then all three
// planes are clipped to [0, 1], with slope_j = k[j+1] - k[j] and c0 = k[0] of
// the curve's exponentiated knots k. The HSV wiring is sequential: the H->S
// curve reads the H that H->H has already scaled and clipped. Nothing but the
// image, the mask, the knots and the output touches device memory.
//
// What bounds it: on paper, bytes. Without a mask it moves 24 B/px in fp32
// (img 12, out 12), 398 MB or 0.119 ms at 1080p batch 8 on 3.35 TB/s, 12 B/px
// with bf16 storage and 6 B/px on the u8 wire; with the O(1) lookup it does
// some 360 fp32 operations per pixel (0.089 ms). In practice it is bound by
// instruction issue: with the first, IEEE color math the 12 powf of the Lab
// round trip were a few dozen instructions each, and with ~20 IEEE
// divisions by constants they were most of what a pixel issued (the ten
// O(1) lookups are ~150 of its ~1,960). A 15-ramp sum per curve (about 600
// instructions a pixel) took the same time in bf16 as in fp32.
//
// What this design does about it:
// - The knots as they come. The block's prologue stages this image's
//   exponentiated knots and forms each slope s_j = k[j+1] - k[j] and c0 =
//   k[0] itself, with the fp32 subtraction of the plain version's
//   `prepare_knots`, so the host issues no work per curve.
// - O(1) knot lookup. The prologue builds, one thread per curve, the
//   prefix table P[j] = c0 + s_0 + ... + s_(j-1), summed in that order in fp32
//   with plain adds, and stores (P[j], s_j) as a float2. A curve is then
//   s = n_seg * p, j = clamp(floor(s), 0, n_seg - 1),
//   scale = fmaf(s_j, clamp(s - j, 0, 1), P[j]):
//   one shared load and a handful of instructions instead of 15 ramps. The
//   ramp sum was c0 plus fmaf(s_j, 1, .) for the full ramps, one partial FFMA
//   and fmaf(s_j, 0, .) for the rest, so the result is bit-identical to it,
//   below 0, above 1 and on a knot included. Each curve's table is padded to
//   16 entries (128 B) at the default counts and aligned, so a warp's
//   data-dependent reads hit 32 distinct banks or broadcast.
// - No materialized mask. The HAS_MASK = false instance reads no mask and
//   multiplies by nothing, which is bitwise the same as an all-ones mask.
// - The lean color math (color_planes.cuh): constant divisions as
//   corrected-reciprocal products (bitwise IEEE), the sRGB powers on the
//   special-function unit, t*t*t and cbrtf for the cube and cube root: a
//   fraction of the IEEE forms' instructions a pixel.
// - The u8 wire fused: a uint8 image is read as x / 255 (curl_planes::div,
//   bitwise IEEE's), a uint8 mask as its value, and
//   the output leaves as (uint8)min(max(v*255, 0), 255), the floor quantize
//   of ops/wire.py, bit for bit. The build uses no fast math.
//
// Knot counts: the (16, 16, 16) default (the 48/48/64 split of CurlCurveNet)
// is a template instance with compile-time segment counts. Any other
// counts, K >= 2 a group, run the runtime-count instance through the same
// lookup. Both keep their tables in dynamic shared memory sized from the
// longest curve (shared_bytes; opted in above 48 KB). The prologue sums S
// prefixes serially, so a block covers `chunks` runs of 256 pixels (the
// wrapper's block_chunks: 4 at 16 knots, where at one run a block the
// prologues took about a tenth of the kernel's time; ceil(S / 16) from 66
// knots on) to spread that cost over more pixels.
//
// Layout: NHWC img and out (3 consecutive values per pixel) and the
// (B, H, W, 1) mask, read directly. Grid: x covers the pixels of one image
// in blocks of kThreads x chunks, y is the image index. Flat offsets are
// int64. Any batch (past 65,535 images, in launches of that many) and
// resolution; the curve pass has no coordinates, so no row-band offsets are
// needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "color_planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCurves = 10;
constexpr int kMaxGridY = 65535;
constexpr int kStaticSharedBytes = 48 * 1024;  // above this only by opt-in

// Storage <-> fp32. uint8 is the u8 wire: an image is x / 255 in and
// floor-quantized out; a mask is its value.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(uint8_t x) {
  return curl_planes::div<curl_planes::By255>(static_cast<float>(x));
}
__device__ __forceinline__ float mask_value(float x) { return x; }
__device__ __forceinline__ float mask_value(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float mask_value(uint8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ uint8_t from_float<uint8_t>(float x) {
  return static_cast<uint8_t>(fminf(fmaxf(x * 255.0f, 0.0f), 255.0f));
}

// c0 + sum_j slope_j * clip(n_seg * p - j, 0, 1) by the prefix table `tab`
// of (P[j], slope_j). NSEG > 0 fixes the segment count at compile time;
// NSEG == 0 reads it from n_seg.
template <int NSEG>
__device__ __forceinline__ float curve_scale(float p, const float2* tab, int n_seg) {
  const int n = NSEG > 0 ? NSEG : n_seg;
  const float s = static_cast<float>(n) * p;
  // fmaxf first, so a NaN plane picks segment 0 as the ramp sum does.
  const int j = static_cast<int>(fminf(fmaxf(floorf(s), 0.0f), static_cast<float>(n - 1)));
  const float2 e = tab[j];
  return fmaf(e.y, curl_planes::clampf(s - static_cast<float>(j), 0.0f, 1.0f), e.x);
}

// Scale plane OUT by the curve driven by plane DRIVE, then clip all three.
template <int NSEG, int DRIVE, int OUT>
__device__ __forceinline__ void apply_curve(float (&pl)[3], const float2* tab, int n_seg) {
  pl[OUT] *= curve_scale<NSEG>(pl[DRIVE], tab, n_seg);
#pragma unroll
  for (int c = 0; c < 3; ++c) pl[c] = curl_planes::clampf(pl[c], 0.0f, 1.0f);
}

template <bool HAS_MASK>
__device__ __forceinline__ void apply_mask(float (&pl)[3], float m) {
  if constexpr (HAS_MASK) {
#pragma unroll
    for (int c = 0; c < 3; ++c) pl[c] *= m;
  }
}

// One pixel: the ten curves, the residual and the composite. t holds the
// ten prefix tables, `stride` entries apart.
template <typename T, bool HAS_MASK, int NL, int NR, int NH>
__device__ __forceinline__ void enhance_pixel(const T* __restrict__ img,
                                              const T* __restrict__ mask, T* __restrict__ out,
                                              long long px, const float2* t, int stride,
                                              int n_lab, int n_rgb, int n_hsv) {
  const long long off = px * 3;
  const float r = to_float(img[off]);
  const float g = to_float(img[off + 1]);
  const float b = to_float(img[off + 2]);
  const float m = HAS_MASK ? mask_value(mask[px]) : 1.0f;
  float pl[3];

  // Lab curves.
  curl_planes::lab_from_rgb(r, g, b, pl[0], pl[1], pl[2]);
  apply_curve<NL, 0, 0>(pl, t + 0 * stride, n_lab);
  apply_curve<NL, 1, 1>(pl, t + 1 * stride, n_lab);
  apply_curve<NL, 2, 2>(pl, t + 2 * stride, n_lab);
  apply_mask<HAS_MASK>(pl, m);

  // RGB curves.
  curl_planes::rgb_from_lab(pl[0], pl[1], pl[2], pl[0], pl[1], pl[2]);
  apply_curve<NR, 0, 0>(pl, t + 3 * stride, n_rgb);
  apply_curve<NR, 1, 1>(pl, t + 4 * stride, n_rgb);
  apply_curve<NR, 2, 2>(pl, t + 5 * stride, n_rgb);
  apply_mask<HAS_MASK>(pl, m);

  // HSV curves: H->H, H->S, S->S, V->V.
  curl_planes::hsv_from_rgb(pl[0], pl[1], pl[2], pl[0], pl[1], pl[2]);
  apply_curve<NH, 0, 0>(pl, t + 6 * stride, n_hsv);
  apply_curve<NH, 0, 1>(pl, t + 7 * stride, n_hsv);
  apply_curve<NH, 1, 1>(pl, t + 8 * stride, n_hsv);
  apply_curve<NH, 2, 2>(pl, t + 9 * stride, n_hsv);
  apply_mask<HAS_MASK>(pl, m);

  // Residual and composite.
  float res[3];
  curl_planes::rgb_from_hsv(pl[0], pl[1], pl[2], res[0], res[1], res[2]);
  const float in[3] = {r, g, b};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = curl_planes::clampf(in[c] + res[c], 0.0f, 1.0f);
    if constexpr (HAS_MASK) v *= m;
    out[off + c] = from_float<T>(v);
  }
}

// Table entries a curve of `seg` segments takes: a multiple of 16, so each
// curve's table starts on a 128 B boundary and a warp's data-dependent
// reads hit distinct banks or broadcast.
__host__ __device__ constexpr int table_stride(int seg) { return (seg + 15) / 16 * 16; }

// Dynamic shared memory of a block: the ten tables of float2 (P[j], s_j) and
// the staged knots, at most 10 x (S + 1) floats: 10 x S x 12 B and a little
// more (1,880 B at 16 knots, 30,760 B at 257).
__host__ __device__ constexpr int shared_bytes(int seg) {
  return kCurves * (table_stride(seg) * 8 + seg * 4 + 4);
}

// The first of curve `curve`'s knots among the staged knots: the Lab stack
// (3 x k_lab), then the RGB (3 x k_rgb) and the HSV (4 x k_hsv) ones.
__device__ __forceinline__ int knot_base(int curve, int k_lab, int k_rgb, int k_hsv) {
  return curve < 3 ? curve * k_lab
       : curve < 6 ? 3 * k_lab + (curve - 3) * k_rgb
                   : 3 * (k_lab + k_rgb) + (curve - 6) * k_hsv;
}

// A curve's prefix table from its n + 1 knots k: (P[j], s_j) with s_j =
// k[j+1] - k[j] and P[j] = k[0] + s_0 + ... + s_(j-1), summed in j order in
// fp32. The knots and the table never overlap.
__device__ __forceinline__ void prefix_table(const float* __restrict__ k,
                                             float2* __restrict__ tab, int n) {
  float knot = k[0];
  float prefix = knot;
  for (int j = 0; j < n; ++j) {
    const float next = k[j + 1];
    const float s = next - knot;
    tab[j] = make_float2(prefix, s);
    prefix = prefix + s;
    knot = next;
  }
}

// KL, KR, KH: knots per curve of each group; all 0 selects the runtime
// counts k_lab, k_rgb, k_hsv. HAS_MASK = false reads no mask (all ones).
// knots_*: this launch's first image's (B, n, K) exponentiated knot stacks.
// A block covers `chunks` runs of kThreads pixels of one image, so its
// prologue is paid once per chunks x 256 pixels.
template <typename T, bool HAS_MASK, int KL, int KR, int KH>
__global__ void __launch_bounds__(kThreads)
curve_enhance_kernel(const T* __restrict__ img, const T* __restrict__ mask,
                     const float* __restrict__ knots_lab, const float* __restrict__ knots_rgb,
                     const float* __restrict__ knots_hsv, T* __restrict__ out,
                     long long pixels, int k_lab, int k_rgb, int k_hsv, int chunks) {
  constexpr bool kFixed = KL > 0;
  if constexpr (kFixed) {
    k_lab = KL;
    k_rgb = KR;
    k_hsv = KH;
  }
  const int n_lab = k_lab - 1, n_rgb = k_rgb - 1, n_hsv = k_hsv - 1;
  constexpr int kStaticSeg = (KL > KR ? (KL > KH ? KL : KH) : (KR > KH ? KR : KH)) - 1;
  const int seg = kFixed ? kStaticSeg : max(n_lab, max(n_rgb, n_hsv));

  // shared_bytes(seg) of dynamic shared memory: the ten prefix tables,
  // `stride` entries apart, then the staged knots.
  extern __shared__ __align__(128) float2 s_tab[];
  const int stride = table_stride(seg);
  float* s_knots = reinterpret_cast<float*>(s_tab + kCurves * stride);

  // Prologue: stage this image's knots with the whole block, then one
  // thread per curve forms its slopes and sums its prefix table.
  const long long image = blockIdx.y;
  const int n3_lab = 3 * k_lab, n3_rgb = 3 * k_rgb, n4_hsv = 4 * k_hsv;
  const float* src_lab = knots_lab + image * n3_lab;
  const float* src_rgb = knots_rgb + image * n3_rgb;
  const float* src_hsv = knots_hsv + image * n4_hsv;
  for (int i = threadIdx.x; i < n3_lab; i += kThreads) s_knots[i] = src_lab[i];
  for (int i = threadIdx.x; i < n3_rgb; i += kThreads) s_knots[n3_lab + i] = src_rgb[i];
  for (int i = threadIdx.x; i < n4_hsv; i += kThreads) {
    s_knots[n3_lab + n3_rgb + i] = src_hsv[i];
  }
  __syncthreads();
  if (threadIdx.x < kCurves) {
    const int curve = threadIdx.x;
    prefix_table(s_knots + knot_base(curve, k_lab, k_rgb, k_hsv), s_tab + curve * stride,
                 curve < 3 ? n_lab : (curve < 6 ? n_rgb : n_hsv));
  }
  __syncthreads();

  constexpr int NL = kFixed ? KL - 1 : 0;
  constexpr int NR = kFixed ? KR - 1 : 0;
  constexpr int NH = kFixed ? KH - 1 : 0;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * chunks + threadIdx.x;
  for (int c = 0; c < chunks; ++c) {
    const long long p = first + static_cast<long long>(c) * kThreads;
    if (p >= pixels) return;
    enhance_pixel<T, HAS_MASK, NL, NR, NH>(img, mask, out, image * pixels + p, s_tab, stride,
                                           n_lab, n_rgb, n_hsv);
  }
}

// grid.y (images) takes at most 65,535: a larger batch launches in chunks
// of images, each from its first image.
template <typename T, bool HAS_MASK>
cudaError_t launch(const void* img, const void* mask, const float* knots_lab,
                   const float* knots_rgb, const float* knots_hsv, void* out, long long batch,
                   long long pixels, int k_lab, int k_rgb, int k_hsv, int chunks,
                   cudaStream_t stream) {
  const bool fixed = k_lab == 16 && k_rgb == 16 && k_hsv == 16;
  const int seg = (k_lab > k_rgb ? (k_lab > k_hsv ? k_lab : k_hsv)
                                 : (k_rgb > k_hsv ? k_rgb : k_hsv)) - 1;
  const auto kernel = fixed ? &curve_enhance_kernel<T, HAS_MASK, 16, 16, 16>
                            : &curve_enhance_kernel<T, HAS_MASK, 0, 0, 0>;
  const int bytes = shared_bytes(seg);
  if (bytes > kStaticSharedBytes) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const long long per_block = static_cast<long long>(kThreads) * chunks;
  const unsigned blocks_x = static_cast<unsigned>((pixels + per_block - 1) / per_block);
  for (long long i0 = 0; i0 < batch; i0 += kMaxGridY) {
    const long long nb = batch - i0 < kMaxGridY ? batch - i0 : kMaxGridY;
    const long long first = i0 * pixels;
    kernel<<<dim3(blocks_x, static_cast<unsigned>(nb)), kThreads, bytes, stream>>>(
        static_cast<const T*>(img) + first * 3,
        mask == nullptr ? nullptr : static_cast<const T*>(mask) + first,
        knots_lab + i0 * 3 * k_lab, knots_rgb + i0 * 3 * k_rgb, knots_hsv + i0 * 4 * k_hsv,
        static_cast<T*>(out) + first * 3, pixels, k_lab, k_rgb, k_hsv, chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* img, const void* mask, const float* knots_lab,
                     const float* knots_rgb, const float* knots_hsv, void* out,
                     long long batch, long long pixels, int k_lab, int k_rgb, int k_hsv,
                     int chunks, cudaStream_t stream) {
  return mask != nullptr
      ? launch<T, true>(img, mask, knots_lab, knots_rgb, knots_hsv, out, batch, pixels, k_lab,
                        k_rgb, k_hsv, chunks, stream)
      : launch<T, false>(img, mask, knots_lab, knots_rgb, knots_hsv, out, batch, pixels, k_lab,
                         k_rgb, k_hsv, chunks, stream);
}

}  // namespace

extern "C" {

// img/out: (batch, pixels, 3) contiguous and mask: (batch, pixels, 1)
// contiguous or null (all ones), all float32 (dtype == 0), all bfloat16
// (dtype == 1) or all uint8 (dtype == 2, the u8 wire). knots_lab,
// knots_rgb, knots_hsv: the exponentiated knot stacks (batch, 3, k_lab),
// (batch, 3, k_rgb) and (batch, 4, k_hsv), contiguous float32. Each k >= 2;
// chunks >= 1 runs of kThreads pixels a block. Launches on `stream` without
// synchronizing; returns the first error of a launch (or of the
// shared-memory opt-in), else cudaSuccess.
int curl_curve_enhance(const void* img, const void* mask, const void* knots_lab,
                       const void* knots_rgb, const void* knots_hsv, void* out,
                       long long batch, long long pixels, int k_lab, int k_rgb, int k_hsv,
                       int chunks, int dtype, void* stream) {
  if (batch <= 0 || pixels <= 0 || k_lab < 2 || k_rgb < 2 || k_hsv < 2 || chunks < 1 ||
      dtype < 0 || dtype > 2 || (pixels + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* kl = static_cast<const float*>(knots_lab);
  const auto* kr = static_cast<const float*>(knots_rgb);
  const auto* kh = static_cast<const float*>(knots_hsv);
  cudaError_t err;
  if (dtype == 2) {
    err = dispatch<uint8_t>(img, mask, kl, kr, kh, out, batch, pixels, k_lab, k_rgb, k_hsv,
                            chunks, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(img, mask, kl, kr, kh, out, batch, pixels, k_lab, k_rgb,
                                  k_hsv, chunks, s);
  } else {
    err = dispatch<float>(img, mask, kl, kr, kh, out, batch, pixels, k_lab, k_rgb, k_hsv,
                          chunks, s);
  }
  return static_cast<int>(err);
}

const char* curl_curve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
