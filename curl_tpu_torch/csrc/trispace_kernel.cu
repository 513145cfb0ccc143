// Fused tri-space polynomial residual (kernel K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// curl_tpu/ops/pallas/trispace_kernel.py::_make_kernel(...).kernel.
// Per pixel: RGB -> Lab and RGB -> HSV; the normalized coordinates
// x = col/total_w and y = (row+row0)/total_h; for each of the three spaces the
// degree-4 polynomial by the incremental monomial chain, contracted with that
// image's 3 x N coefficients; a sigmoid; Lab/HSV -> RGB; and the residual
// sum of 2(sigma - 0.5). With COMPOSITE it writes clip(img + residual, 0, 1)
// instead of the residual. The monomials live in registers only; nothing but
// the image, the coefficients and the output touches device memory.
//
// What bounds it: instruction issue and latency, not memory. It moves 24 B/px
// in fp32 (12 with bf16 storage, 6 on the u8 wire) against thousands of
// instructions per pixel, far above the card's fp32 ridge of ~20 FLOP/B. The
// unfolded chain over (c1, c2, c3, x, y) costs per space 125 FMUL, 378 FFMA
// and 126 shared-memory float4 broadcasts, ~1,900 instructions per pixel
// over the three spaces. The color math costs about as much again and does
// not shrink: 12 IEEE powf, ~21 IEEE divisions by constants and 9 sigmoids
// per pixel, long dependent sequences whose latency needs many warps to
// hide.
//
// What this design does about it:
// - Per-row y-fold (spatial instance). y is constant along a row, and every
//   block lies in one row (grid = column blocks x rows x images). The block's
//   prologue folds each space's 126 coefficients into the 70 of a degree-4
//   polynomial in (c1, c2, c3, x): c'_q = sum_e c_(q,e) * y^e, by Horner in
//   fp32, with the map kFoldY generated from poly.monomial_powers. Each pixel
//   then runs the 4-variable chain kChain4: 69 FMUL + 210 FFMA + 70 LDS.128
//   per space. The fold reorders the sums, so results are not bit-identical
//   to the unfolded chain (they agree to ~1e-6).
// - Two pixels per thread (kPix = 2), kThreads apart so that loads stay
//   coalesced: each coefficient broadcast from shared memory feeds 6 FFMA
//   instead of 3, which halves the shared loads per pixel.
// - Occupancy before reuse. The color math's dependent sequences need many
//   warps to hide their latency. __launch_bounds__(512, 2) holds the kernel
//   to 64 registers, so two blocks of 16 warps share an SM; the second
//   pixel's monomials then spill ~200 B to L1, which costs less than the
//   warps it buys. A block covers 1,024 pixels of a row, so its prologue
//   (staging, fold, two barriers) is paid once per 1,024 pixels. These
//   settings were the fastest of a one-time sweep on the card against one
//   pixel a thread, 256- and 1,024-thread blocks and no register cap
//   (PERF.md).
// - The u8 wire fused: a uint8 image is read and normalized as x / 255.0f
//   (IEEE division), and the composite leaves as (uint8)min(max(v*255, 0),
//   255), the floor quantize of ops/wire.py, bit for bit. The build uses no
//   fast math.
// Tensor cores are not used. TF32 mma keeps ~10 mantissa bits, which breaks
// the 2e-4 fp32 parity contract; the 3xTF32 split that restores it costs two
// instructions per A element, ~540 warp-instructions per space per 32 pixels
// against ~630 here, and needs the per-pixel monomials staged through shared
// memory first.
//
// Layout: NHWC in and out (3 consecutive values per pixel), read directly.
// Grid: x covers a row in blocks of kThreads * kPix pixels, y is the row, z
// the image. Flat offsets are int64 (8K x batch 32 x 3 exceeds 2^31). One
// launch covers any batch and resolution up to 65,535 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "color_planes.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kPix = 2;          // pixels per thread
constexpr int kMinBlocks = 2;    // blocks per SM that __launch_bounds__ sizes registers for
constexpr int kBlockPixels = kThreads * kPix;
constexpr int kMaxGridYZ = 65535;
constexpr int kSpatialRaw = 126;  // monomials of degree <= 4 in (c1, c2, c3, x, y)

// (parent, var) plan of poly.monomial_chain(4, 4) over (c1, c2, c3, x): the
// folded spatial basis.
constexpr int kChain4[69][2] = {
    {0, 0}, {0, 1}, {0, 2}, {0, 3}, {1, 0}, {2, 0}, {3, 0}, {4, 0}, {2, 1}, {3, 1},
    {4, 1}, {3, 2}, {4, 2}, {4, 3}, {5, 0}, {6, 0}, {7, 0}, {8, 0}, {9, 0}, {10, 0},
    {11, 0}, {12, 0}, {13, 0}, {14, 0}, {9, 1}, {10, 1}, {11, 1}, {12, 1}, {13, 1}, {14, 1},
    {12, 2}, {13, 2}, {14, 2}, {14, 3}, {15, 0}, {16, 0}, {17, 0}, {18, 0}, {19, 0}, {20, 0},
    {21, 0}, {22, 0}, {23, 0}, {24, 0}, {25, 0}, {26, 0}, {27, 0}, {28, 0}, {29, 0}, {30, 0},
    {31, 0}, {32, 0}, {33, 0}, {34, 0}, {25, 1}, {26, 1}, {27, 1}, {28, 1}, {29, 1}, {30, 1},
    {31, 1}, {32, 1}, {33, 1}, {34, 1}, {31, 2}, {32, 2}, {33, 2}, {34, 2}, {34, 3},
};

// (parent, var) plan of poly.monomial_chain(4, 3), the non-spatial basis.
constexpr int kChain3[34][2] = {
    {0, 0}, {0, 1}, {0, 2}, {1, 0}, {2, 0}, {3, 0}, {2, 1}, {3, 1}, {3, 2}, {4, 0},
    {5, 0}, {6, 0}, {7, 0}, {8, 0}, {9, 0}, {7, 1}, {8, 1}, {9, 1}, {9, 2}, {10, 0},
    {11, 0}, {12, 0}, {13, 0}, {14, 0}, {15, 0}, {16, 0}, {17, 0}, {18, 0}, {19, 0}, {16, 1},
    {17, 1}, {18, 1}, {19, 1}, {19, 2},
};

// The y-fold: kFoldY[q][e] is the index in poly.monomial_powers(4, 5) of
// monomial q of poly.monomial_powers(4, 4) times y^e, or -1 past degree 4.
// The prologue's threads read different rows of it, so it lives in global
// memory (cached in L1): constant memory serializes such reads.
__device__ const int8_t kFoldY[70][5] = {
    {0, 5, 20, 55, 125}, {1, 10, 35, 90, -1}, {2, 14, 45, 110, -1}, {3, 17, 51, 120, -1}, {4, 19, 54, 124, -1},
    {6, 25, 70, -1, -1}, {7, 29, 80, -1, -1}, {8, 32, 86, -1, -1}, {9, 34, 89, -1, -1}, {11, 39, 100, -1, -1},
    {12, 42, 106, -1, -1}, {13, 44, 109, -1, -1}, {15, 48, 116, -1, -1}, {16, 50, 119, -1, -1}, {18, 53, 123, -1, -1},
    {21, 60, -1, -1, -1}, {22, 64, -1, -1, -1}, {23, 67, -1, -1, -1}, {24, 69, -1, -1, -1}, {26, 74, -1, -1, -1},
    {27, 77, -1, -1, -1}, {28, 79, -1, -1, -1}, {30, 83, -1, -1, -1}, {31, 85, -1, -1, -1}, {33, 88, -1, -1, -1},
    {36, 94, -1, -1, -1}, {37, 97, -1, -1, -1}, {38, 99, -1, -1, -1}, {40, 103, -1, -1, -1}, {41, 105, -1, -1, -1},
    {43, 108, -1, -1, -1}, {46, 113, -1, -1, -1}, {47, 115, -1, -1, -1}, {49, 118, -1, -1, -1}, {52, 122, -1, -1, -1},
    {56, -1, -1, -1, -1}, {57, -1, -1, -1, -1}, {58, -1, -1, -1, -1}, {59, -1, -1, -1, -1}, {61, -1, -1, -1, -1},
    {62, -1, -1, -1, -1}, {63, -1, -1, -1, -1}, {65, -1, -1, -1, -1}, {66, -1, -1, -1, -1}, {68, -1, -1, -1, -1},
    {71, -1, -1, -1, -1}, {72, -1, -1, -1, -1}, {73, -1, -1, -1, -1}, {75, -1, -1, -1, -1}, {76, -1, -1, -1, -1},
    {78, -1, -1, -1, -1}, {81, -1, -1, -1, -1}, {82, -1, -1, -1, -1}, {84, -1, -1, -1, -1}, {87, -1, -1, -1, -1},
    {91, -1, -1, -1, -1}, {92, -1, -1, -1, -1}, {93, -1, -1, -1, -1}, {95, -1, -1, -1, -1}, {96, -1, -1, -1, -1},
    {98, -1, -1, -1, -1}, {101, -1, -1, -1, -1}, {102, -1, -1, -1, -1}, {104, -1, -1, -1, -1}, {107, -1, -1, -1, -1},
    {111, -1, -1, -1, -1}, {112, -1, -1, -1, -1}, {114, -1, -1, -1, -1}, {117, -1, -1, -1, -1}, {121, -1, -1, -1, -1},
};

// Number of monomials of degree <= 4 in NV variables.
template <int NV> struct NumCoeffs;
template <> struct NumCoeffs<4> { static constexpr int value = 70; };
template <> struct NumCoeffs<3> { static constexpr int value = 35; };

// Step K of the chain as compile-time scalars, usable in device code.
template <int NV, int K> struct ChainStep;
template <int K> struct ChainStep<4, K> {
  static constexpr int parent = kChain4[K][0];
  static constexpr int var = kChain4[K][1];
};
template <int K> struct ChainStep<3, K> {
  static constexpr int parent = kChain3[K][0];
  static constexpr int var = kChain3[K][1];
};

// One chain step for the thread's kPix pixels: one float4 broadcast, 3 * kPix
// FFMA.
template <int NV, int N, int K>
__device__ __forceinline__ void chain_step(float (&m)[kPix][N], const float (&v)[kPix][NV],
                                           const float4* c, float (&a)[kPix][3]) {
  const float4 ck = c[K + 1];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const float mk = m[p][ChainStep<NV, K>::parent] * v[p][ChainStep<NV, K>::var];
    m[p][K + 1] = mk;
    a[p][0] = fmaf(ck.x, mk, a[p][0]);
    a[p][1] = fmaf(ck.y, mk, a[p][1]);
    a[p][2] = fmaf(ck.z, mk, a[p][2]);
  }
}

template <int NV, int N, int... K>
__device__ __forceinline__ void chain_eval_impl(const float (&v)[kPix][NV], const float4* c,
                                                float (&a)[kPix][3],
                                                std::integer_sequence<int, K...>) {
  float m[kPix][N];
  // The constant term first, then each monomial as it is formed: the
  // accumulation order of the reference chain.
  const float4 c0 = c[0];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    m[p][0] = 1.0f;
    a[p][0] = c0.x;
    a[p][1] = c0.y;
    a[p][2] = c0.z;
  }
  (chain_step<NV, N, K>(m, v, c, a), ...);
}

// Three polynomial outputs per pixel over the NV variables; c points at this
// space's N float4 coefficients (x, y, z = output channels 0, 1, 2).
template <int NV>
__device__ __forceinline__ void chain_eval(const float (&v)[kPix][NV], const float4* c,
                                           float (&a)[kPix][3]) {
  constexpr int N = NumCoeffs<NV>::value;
  chain_eval_impl<NV, N>(v, c, a, std::make_integer_sequence<int, N - 1>{});
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Storage <-> fp32. uint8 is the u8 wire: x / 255 in, floor-quantized out.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(uint8_t x) { return static_cast<float>(x) / 255.0f; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ uint8_t from_float<uint8_t>(float x) {
  return static_cast<uint8_t>(fminf(fmaxf(x * 255.0f, 0.0f), 255.0f));
}

template <typename T, bool SPATIAL, bool COMPOSITE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trispace_residual_kernel(const T* __restrict__ img, const float4* __restrict__ coef,
                         T* __restrict__ out, int height, int width, int row0, int total_h,
                         int total_w) {
  constexpr int NV = SPATIAL ? 4 : 3;  // chain variables: (c1, c2, c3[, x])
  constexpr int N = NumCoeffs<NV>::value;
  constexpr int kRaw = SPATIAL ? kSpatialRaw : N;  // coefficients per space in `coef`
  __shared__ float4 s_coef[3 * N];

  const int row = blockIdx.y;
  const long long image = blockIdx.z;
  const float4* src = coef + image * (3 * kRaw);
  if constexpr (SPATIAL) {
    // Stage the image's 3 x 126 coefficients, then fold this row's y into
    // 3 x 70: c'_q = ((c_(q,4) y + c_(q,3)) y + ...) y + c_(q,0).
    __shared__ float4 s_raw[3 * kSpatialRaw];
    for (int i = threadIdx.x; i < 3 * kSpatialRaw; i += kThreads) s_raw[i] = src[i];
    __syncthreads();
    const float y = static_cast<float>(row + row0) / static_cast<float>(total_h);
    for (int i = threadIdx.x; i < 3 * N; i += kThreads) {
      const int space = i / N;
      const int q = i - space * N;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int e = 4; e >= 0; --e) {
        const int k = kFoldY[q][e];
        if (k >= 0) {
          const float4 c = s_raw[space * kSpatialRaw + k];
          acc.x = fmaf(acc.x, y, c.x);
          acc.y = fmaf(acc.y, y, c.y);
          acc.z = fmaf(acc.z, y, c.z);
        }
      }
      s_coef[i] = acc;
    }
  } else {
    for (int i = threadIdx.x; i < 3 * N; i += kThreads) s_coef[i] = src[i];
  }
  __syncthreads();

  const int col0 = blockIdx.x * kBlockPixels + threadIdx.x;
  if (col0 >= width) return;
  const long long row_px = (image * height + row) * static_cast<long long>(width);

  // This thread's pixels: columns col0, col0 + kThreads, ...; a pixel past
  // the row's end computes on zeros and is not stored.
  float rgb[kPix][3];
  bool live[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int col = col0 + p * kThreads;
    live[p] = col < width;
    const long long off = (row_px + col) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[p][c] = live[p] ? to_float(img[off + c]) : 0.0f;
  }

  float v[kPix][NV];
  if constexpr (SPATIAL) {
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      v[p][3] = static_cast<float>(col0 + p * kThreads) / static_cast<float>(total_w);
    }
  }

  float res[kPix][3];
  float o[kPix][3];

  // RGB space.
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
#pragma unroll
    for (int c = 0; c < 3; ++c) v[p][c] = rgb[p][c];
  }
  chain_eval<NV>(v, s_coef, o);
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
#pragma unroll
    for (int c = 0; c < 3; ++c) res[p][c] = 0.0f + 2.0f * (sigmoid(o[p][c]) - 0.5f);
  }

  // Lab space.
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    curl_planes::lab_from_rgb(rgb[p][0], rgb[p][1], rgb[p][2], v[p][0], v[p][1], v[p][2]);
  }
  chain_eval<NV>(v, s_coef + N, o);
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    float q0, q1, q2;
    curl_planes::rgb_from_lab(sigmoid(o[p][0]), sigmoid(o[p][1]), sigmoid(o[p][2]), q0, q1, q2);
    res[p][0] += 2.0f * (q0 - 0.5f);
    res[p][1] += 2.0f * (q1 - 0.5f);
    res[p][2] += 2.0f * (q2 - 0.5f);
  }

  // HSV space.
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    curl_planes::hsv_from_rgb(rgb[p][0], rgb[p][1], rgb[p][2], v[p][0], v[p][1], v[p][2]);
  }
  chain_eval<NV>(v, s_coef + 2 * N, o);
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    float q0, q1, q2;
    curl_planes::rgb_from_hsv(sigmoid(o[p][0]), sigmoid(o[p][1]), sigmoid(o[p][2]), q0, q1, q2);
    res[p][0] += 2.0f * (q0 - 0.5f);
    res[p][1] += 2.0f * (q1 - 0.5f);
    res[p][2] += 2.0f * (q2 - 0.5f);
  }

#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    if (!live[p]) continue;
    const long long off = (row_px + col0 + p * kThreads) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float r = res[p][c];
      if constexpr (COMPOSITE) r = curl_planes::clampf(rgb[p][c] + r, 0.0f, 1.0f);
      out[off + c] = from_float<T>(r);
    }
  }
}

template <typename T, bool SPATIAL, bool COMPOSITE>
cudaError_t launch(const void* img, const void* coef, void* out, int batch, int height,
                   int width, int row0, int total_h, int total_w, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((width + kBlockPixels - 1) / kBlockPixels),
                  static_cast<unsigned>(height), static_cast<unsigned>(batch));
  trispace_residual_kernel<T, SPATIAL, COMPOSITE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const float4*>(coef), static_cast<T*>(out),
      height, width, row0, total_h, total_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int spatial, int composite, const void* img, const void* coef,
                     void* out, int batch, int height, int width, int row0, int total_h,
                     int total_w, cudaStream_t stream) {
  if (spatial) {
    return composite
        ? launch<T, true, true>(img, coef, out, batch, height, width, row0, total_h, total_w, stream)
        : launch<T, true, false>(img, coef, out, batch, height, width, row0, total_h, total_w, stream);
  }
  return composite
      ? launch<T, false, true>(img, coef, out, batch, height, width, row0, total_h, total_w, stream)
      : launch<T, false, false>(img, coef, out, batch, height, width, row0, total_h, total_w, stream);
}

}  // namespace

extern "C" {

// img/out: (batch, height, width, 3) contiguous, float32 (dtype == 0),
// bfloat16 (dtype == 1) or uint8 (dtype == 2, the u8 wire: composite only).
// coef: (batch, 3, N, 4) contiguous float32, N = 126 when spatial else 35,
// the 4th lane unused. Launches on `stream` without synchronizing; returns
// cudaGetLastError() after the launch.
int curl_trispace_residual(const void* img, const void* coef, void* out, long long batch,
                           long long height, long long width, int row0, int total_h,
                           int total_w, int spatial, int composite, int dtype,
                           void* stream) {
  if (batch <= 0 || batch > kMaxGridYZ || height <= 0 || height > kMaxGridYZ || width <= 0 ||
      width > 0x7fffffff - kBlockPixels || total_h <= 0 || total_w <= 0 ||
      (dtype == 2 && !composite) || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(batch), h = static_cast<int>(height);
  const int w = static_cast<int>(width);
  cudaError_t err;
  if (dtype == 2) {
    err = spatial
        ? launch<uint8_t, true, true>(img, coef, out, b, h, w, row0, total_h, total_w, s)
        : launch<uint8_t, false, true>(img, coef, out, b, h, w, row0, total_h, total_w, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(spatial, composite, img, coef, out, b, h, w, row0, total_h,
                                  total_w, s);
  } else {
    err = dispatch<float>(spatial, composite, img, coef, out, b, h, w, row0, total_h, total_w, s);
  }
  return static_cast<int>(err);
}

const char* curl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
