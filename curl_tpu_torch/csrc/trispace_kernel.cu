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
// What bounds it: about 3.2k fp32 FLOP per pixel by the TPU kernel's own cost
// estimate (3 * (7N + 200) at N = 126), so about 6.6 GFLOP per 1080p image,
// against 24 B/px of fp32 traffic (12 B/px with bf16 storage): some 130 FLOP
// per byte, far above the card's fp32 ridge of about 20. It is bound by the
// fp32 FMA rate, not by memory.
//
// What this simple design does about that: nothing yet. One thread per
// pixel, the chain fully unrolled from constexpr tables so that every
// monomial index is a compile-time register, one FMA per coefficient, and
// each monomial's three coefficients read from shared memory as one float4
// broadcast. wgmma does not apply to an N = 3 contraction; making the kernel
// faster is later work.
//
// Layout: NHWC in and out (3 consecutive values per pixel), read directly.
// Grid: x covers the pixels of one image in blocks of kThreads, y is the
// image index. Flat offsets are int64 (8K x batch 32 x 3 exceeds 2^31). One
// launch covers any batch and resolution.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <utility>

#include "color_planes.cuh"

namespace {

constexpr int kThreads = 256;

// (parent, var) plan of poly.monomial_chain(4, 5): m[k+1] = m[parent] * v[var].
constexpr int kChain5[125][2] = {
    {0, 0}, {0, 1}, {0, 2}, {0, 3}, {0, 4}, {1, 0}, {2, 0}, {3, 0}, {4, 0}, {5, 0},
    {2, 1}, {3, 1}, {4, 1}, {5, 1}, {3, 2}, {4, 2}, {5, 2}, {4, 3}, {5, 3}, {5, 4},
    {6, 0}, {7, 0}, {8, 0}, {9, 0}, {10, 0}, {11, 0}, {12, 0}, {13, 0}, {14, 0}, {15, 0},
    {16, 0}, {17, 0}, {18, 0}, {19, 0}, {20, 0}, {11, 1}, {12, 1}, {13, 1}, {14, 1}, {15, 1},
    {16, 1}, {17, 1}, {18, 1}, {19, 1}, {20, 1}, {15, 2}, {16, 2}, {17, 2}, {18, 2}, {19, 2},
    {20, 2}, {18, 3}, {19, 3}, {20, 3}, {20, 4}, {21, 0}, {22, 0}, {23, 0}, {24, 0}, {25, 0},
    {26, 0}, {27, 0}, {28, 0}, {29, 0}, {30, 0}, {31, 0}, {32, 0}, {33, 0}, {34, 0}, {35, 0},
    {36, 0}, {37, 0}, {38, 0}, {39, 0}, {40, 0}, {41, 0}, {42, 0}, {43, 0}, {44, 0}, {45, 0},
    {46, 0}, {47, 0}, {48, 0}, {49, 0}, {50, 0}, {51, 0}, {52, 0}, {53, 0}, {54, 0}, {55, 0},
    {36, 1}, {37, 1}, {38, 1}, {39, 1}, {40, 1}, {41, 1}, {42, 1}, {43, 1}, {44, 1}, {45, 1},
    {46, 1}, {47, 1}, {48, 1}, {49, 1}, {50, 1}, {51, 1}, {52, 1}, {53, 1}, {54, 1}, {55, 1},
    {46, 2}, {47, 2}, {48, 2}, {49, 2}, {50, 2}, {51, 2}, {52, 2}, {53, 2}, {54, 2}, {55, 2},
    {52, 3}, {53, 3}, {54, 3}, {55, 3}, {55, 4},
};

// (parent, var) plan of poly.monomial_chain(4, 3), the non-spatial basis.
constexpr int kChain3[34][2] = {
    {0, 0}, {0, 1}, {0, 2}, {1, 0}, {2, 0}, {3, 0}, {2, 1}, {3, 1}, {3, 2}, {4, 0},
    {5, 0}, {6, 0}, {7, 0}, {8, 0}, {9, 0}, {7, 1}, {8, 1}, {9, 1}, {9, 2}, {10, 0},
    {11, 0}, {12, 0}, {13, 0}, {14, 0}, {15, 0}, {16, 0}, {17, 0}, {18, 0}, {19, 0}, {16, 1},
    {17, 1}, {18, 1}, {19, 1}, {19, 2},
};

// Number of monomials of degree <= 4 in NV variables.
template <int NV> struct NumCoeffs;
template <> struct NumCoeffs<5> { static constexpr int value = 126; };
template <> struct NumCoeffs<3> { static constexpr int value = 35; };

// Step K of the chain as compile-time scalars, usable in device code.
template <int NV, int K> struct ChainStep;
template <int K> struct ChainStep<5, K> {
  static constexpr int parent = kChain5[K][0];
  static constexpr int var = kChain5[K][1];
};
template <int K> struct ChainStep<3, K> {
  static constexpr int parent = kChain3[K][0];
  static constexpr int var = kChain3[K][1];
};

template <int NV, int N, int K>
__device__ __forceinline__ void chain_step(float (&m)[N], const float (&v)[NV],
                                           const float4* c, float& a0, float& a1,
                                           float& a2) {
  const float mk = m[ChainStep<NV, K>::parent] * v[ChainStep<NV, K>::var];
  m[K + 1] = mk;
  const float4 ck = c[K + 1];
  a0 = fmaf(ck.x, mk, a0);
  a1 = fmaf(ck.y, mk, a1);
  a2 = fmaf(ck.z, mk, a2);
}

template <int NV, int N, int... K>
__device__ __forceinline__ void chain_eval_impl(const float (&v)[NV], const float4* c,
                                                float& a0, float& a1, float& a2,
                                                std::integer_sequence<int, K...>) {
  float m[N];
  m[0] = 1.0f;
  // The constant term first, then each monomial as it is formed: the
  // accumulation order of the reference chain.
  const float4 c0 = c[0];
  a0 = c0.x;
  a1 = c0.y;
  a2 = c0.z;
  (chain_step<NV, N, K>(m, v, c, a0, a1, a2), ...);
}

// Three polynomial outputs over the NV variables; c points at this space's
// N float4 coefficients (x, y, z = output channels 0, 1, 2).
template <int NV>
__device__ __forceinline__ void chain_eval(const float (&v)[NV], const float4* c,
                                           float& a0, float& a1, float& a2) {
  constexpr int N = NumCoeffs<NV>::value;
  chain_eval_impl<NV, N>(v, c, a0, a1, a2, std::make_integer_sequence<int, N - 1>{});
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, bool SPATIAL, bool COMPOSITE>
__global__ void __launch_bounds__(kThreads)
trispace_residual_kernel(const T* __restrict__ img, const float4* __restrict__ coef,
                         T* __restrict__ out, long long pixels, int width, int row0,
                         int total_h, int total_w) {
  constexpr int NV = SPATIAL ? 5 : 3;
  constexpr int N = NumCoeffs<NV>::value;
  __shared__ float4 s_coef[3 * N];

  // Stage this image's 9 x N coefficients, laid out (space, k, channel).
  const long long image = blockIdx.y;
  const float4* src = coef + image * (3 * N);
  for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) s_coef[i] = src[i];
  __syncthreads();

  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= pixels) return;
  const long long off = (image * pixels + p) * 3;
  const float r = to_float(img[off]);
  const float g = to_float(img[off + 1]);
  const float b = to_float(img[off + 2]);

  float v[NV];
  if constexpr (SPATIAL) {
    const long long row = p / width;
    const long long col = p - row * width;
    v[3] = static_cast<float>(col) / static_cast<float>(total_w);
    v[4] = static_cast<float>(row + row0) / static_cast<float>(total_h);
  }

  float res0 = 0.0f, res1 = 0.0f, res2 = 0.0f;
  float o0, o1, o2;

  // RGB space.
  v[0] = r;
  v[1] = g;
  v[2] = b;
  chain_eval<NV>(v, s_coef, o0, o1, o2);
  res0 += 2.0f * (sigmoid(o0) - 0.5f);
  res1 += 2.0f * (sigmoid(o1) - 0.5f);
  res2 += 2.0f * (sigmoid(o2) - 0.5f);

  // Lab space.
  curl_planes::lab_from_rgb(r, g, b, v[0], v[1], v[2]);
  chain_eval<NV>(v, s_coef + N, o0, o1, o2);
  curl_planes::rgb_from_lab(sigmoid(o0), sigmoid(o1), sigmoid(o2), o0, o1, o2);
  res0 += 2.0f * (o0 - 0.5f);
  res1 += 2.0f * (o1 - 0.5f);
  res2 += 2.0f * (o2 - 0.5f);

  // HSV space.
  curl_planes::hsv_from_rgb(r, g, b, v[0], v[1], v[2]);
  chain_eval<NV>(v, s_coef + 2 * N, o0, o1, o2);
  curl_planes::rgb_from_hsv(sigmoid(o0), sigmoid(o1), sigmoid(o2), o0, o1, o2);
  res0 += 2.0f * (o0 - 0.5f);
  res1 += 2.0f * (o1 - 0.5f);
  res2 += 2.0f * (o2 - 0.5f);

  if constexpr (COMPOSITE) {
    res0 = curl_planes::clampf(r + res0, 0.0f, 1.0f);
    res1 = curl_planes::clampf(g + res1, 0.0f, 1.0f);
    res2 = curl_planes::clampf(b + res2, 0.0f, 1.0f);
  }
  out[off] = from_float<T>(res0);
  out[off + 1] = from_float<T>(res1);
  out[off + 2] = from_float<T>(res2);
}

template <typename T, bool SPATIAL, bool COMPOSITE>
cudaError_t launch(const void* img, const void* coef, void* out, long long batch,
                   long long pixels, int width, int row0, int total_h, int total_w,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((pixels + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  trispace_residual_kernel<T, SPATIAL, COMPOSITE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const float4*>(coef), static_cast<T*>(out),
      pixels, width, row0, total_h, total_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int spatial, int composite, const void* img, const void* coef,
                     void* out, long long batch, long long pixels, int width, int row0,
                     int total_h, int total_w, cudaStream_t stream) {
  if (spatial) {
    return composite
        ? launch<T, true, true>(img, coef, out, batch, pixels, width, row0, total_h, total_w, stream)
        : launch<T, true, false>(img, coef, out, batch, pixels, width, row0, total_h, total_w, stream);
  }
  return composite
      ? launch<T, false, true>(img, coef, out, batch, pixels, width, row0, total_h, total_w, stream)
      : launch<T, false, false>(img, coef, out, batch, pixels, width, row0, total_h, total_w, stream);
}

}  // namespace

extern "C" {

// img/out: (batch, height, width, 3) contiguous, float32 (bf16 == 0) or
// bfloat16 (bf16 == 1). coef: (batch, 3, N, 4) contiguous float32, N = 126
// when spatial else 35, the 4th lane unused. Launches on `stream` without
// synchronizing; returns cudaGetLastError() after the launch.
int curl_trispace_residual(const void* img, const void* coef, void* out, long long batch,
                           long long height, long long width, int row0, int total_h,
                           int total_w, int spatial, int composite, int bf16,
                           void* stream) {
  if (batch <= 0 || batch > 65535 || height <= 0 || width <= 0 || width > 0x7fffffff ||
      total_h <= 0 || total_w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pixels = height * width;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(width);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(spatial, composite, img, coef, out, batch, pixels, w,
                                     row0, total_h, total_w, s)
           : dispatch<float>(spatial, composite, img, coef, out, batch, pixels, w, row0,
                             total_h, total_w, s);
  return static_cast<int>(err);
}

const char* curl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
