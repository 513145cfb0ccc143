// Fused tri-space polynomial residual (kernel K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// curl_tpu/ops/pallas/trispace_kernel.py::_make_kernel(...).kernel.
// Per pixel: RGB -> Lab and RGB -> HSV; the normalized coordinates
// x = col/total_w and y = (row+row0)/total_h; for each of the three spaces the
// degree-D polynomial by the incremental monomial chain, contracted with that
// image's 3 x N coefficients; a sigmoid; Lab/HSV -> RGB; and the residual
// sum of 2(sigma - 0.5). With COMPOSITE it writes clip(img + residual, 0, 1)
// instead of the residual. The monomials live in registers only; nothing but
// the image, the coefficients and the output touches device memory.
//
// The degree is a compile-time constant: trispace_tables.h, generated by
// ops/kernels/poly_tables.py from ops/poly.py, holds D, the chain plans, the
// fold map, the coefficient counts and the launch shape, and each degree is
// a library of its own. The numbers below are degree 4's.
//
// What bounds it: instruction issue and latency, not memory. It moves 24 B/px
// in fp32 (12 with bf16 storage, 6 on the u8 wire) against thousands of
// instructions per pixel, far above the card's fp32 ridge of ~20 FLOP/B. The
// unfolded chain over (c1, c2, c3, x, y) costs per space 125 FMUL, 378 FFMA
// and 126 shared-memory float4 broadcasts, ~1,900 instructions per pixel
// over the three spaces. The color math (color_planes.cuh) adds a few
// hundred a pixel that do not shrink with the degree: 12 sRGB and Lab
// powers, ~21 divisions by constants and 9 sigmoids. Its first form, with
// IEEE powf and divisions, cost about as much as the degree-4 chain again,
// in long dependent sequences whose latency needs many warps to hide; the
// lean form (corrected-reciprocal constant divisions, bitwise IEEE; the sRGB
// powers on the special-function unit; t*t*t and cbrtf for the cube and
// cube root) is a fraction of that at every degree.
//
// What this design does about it:
// - Per-row y-fold (spatial instance). y is constant along a row, and every
//   block lies in one row (grid = column blocks x rows x images). The block's
//   prologue folds each space's C(D+5, 5) coefficients (126) into the
//   C(D+4, 4) (70) of a degree-D polynomial in (c1, c2, c3, x):
//   c'_q = sum_e c_(q,e) * y^e, by Horner in fp32, with the map kFoldY. Each
//   pixel then runs the 4-variable chain kChain4: 69 FMUL + 210 FFMA + 70
//   LDS.128 per space. The fold reorders the sums, so results are not
//   bit-identical to the unfolded chain (they agree to ~1e-6).
// - Two pixels per thread (kPix = 2), kThreads apart so that loads stay
//   coalesced: each coefficient broadcast from shared memory feeds 6 FFMA
//   instead of 3, which halves the shared loads per pixel. At degrees 1 and
//   2, whose chains are short, four pixels a thread (a block of 2,048
//   pixels) were faster in fp32 and u8 both (poly_tables.LAUNCH).
// - Occupancy before reuse. The color math's dependent sequences need many
//   warps to hide their latency. __launch_bounds__(512, 2) holds the kernel
//   to 64 registers, so two blocks of 16 warps share an SM. A block covers
//   1,024 pixels of a row, so its prologue (staging, fold, two barriers) is
//   paid once per 1,024 pixels. These settings were the fastest of one-time
//   sweeps on the card at every degree against one pixel a thread, 256- and
//   1,024-thread blocks and no register cap (PERF.md).
// - The chain's order (poly_tables.ORDER). Degrees 1-3 run the graded
//   order of ops/poly.py, in which every monomial of degree D - 1 stays
//   live until its last child is formed: C(D+2, 3) a pixel over (c1, c2,
//   c3, x), 20 at D = 4, 35 at 5 and 56 at 6 (40, 70 and 112 floats for two
//   pixels); in that order degree 4 needed a 96-120 B stack at 64
//   registers, and degrees 5 and 6 128 registers a thread, 16 warps an SM.
//   From degree 4 on the header lists the steps depth first: each monomial
//   is formed as the same parent x var, and its subtree is walked before
//   the parent's next child, so at most min(D, 4) monomials are live a
//   pixel and those degrees fit in 64 registers. The FMUL and FFMA counts
//   do not change; the sums are taken in the order of formation, so
//   results differ from the graded chain's in the last bits only.
// - The u8 wire fused: a uint8 image is read and normalized as x / 255
//   (curl_planes::div, bitwise IEEE's), and the composite
//   leaves as (uint8)min(max(v*255, 0), 255), the floor quantize of
//   ops/wire.py, bit for bit. The build uses no fast math.
// Tensor cores are not used. TF32 mma keeps ~10 mantissa bits, which breaks
// the 2e-4 fp32 parity contract; the 3xTF32 split that restores it costs two
// instructions per A element, ~540 warp-instructions per space per 32 pixels
// against ~630 here, and needs the per-pixel monomials staged through shared
// memory first.
//
// Layout: NHWC in and out (3 consecutive values per pixel), read directly.
// Grid: x covers a row in blocks of kThreads * kPix pixels, y is the row, z
// the image. Flat offsets are int64 (8K x batch 32 x 3 exceeds 2^31). Any
// batch and height: past 65,535 rows or images the launch is split in
// chunks of the grid (launch below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "color_planes.cuh"
#include "trispace_tables.h"  // generated for one degree by ops/kernels/poly_tables.py

namespace {

constexpr int kBlockPixels = kThreads * kPix;
constexpr int kMaxGridYZ = 65535;
constexpr int kStaticSharedBytes = 48 * 1024;  // above this only by opt-in

using curl_planes::sigmoid;

// Number of monomials of degree <= kDegree in NV variables.
template <int NV> struct NumCoeffs;
template <> struct NumCoeffs<4> { static constexpr int value = kFolded; };
template <> struct NumCoeffs<3> { static constexpr int value = kPlain; };

// Step K of the chain as compile-time scalars, usable in device code: it
// forms monomial `target` (a graded index) as monomial `parent` times
// variable `var`.
template <int NV, int K> struct ChainStep;
template <int K> struct ChainStep<4, K> {
  static constexpr int parent = kChain4[K][0];
  static constexpr int var = kChain4[K][1];
  static constexpr int target = kTarget4[K];
};
template <int K> struct ChainStep<3, K> {
  static constexpr int parent = kChain3[K][0];
  static constexpr int var = kChain3[K][1];
  static constexpr int target = kTarget3[K];
};

// One chain step for the thread's kPix pixels: one float4 broadcast, 3 * kPix
// FFMA. `m` is indexed by graded index; the indices are compile-time, so it
// lives in registers, and a monomial's register is free after its last
// child is formed.
template <int NV, int N, int K>
__device__ __forceinline__ void chain_step(float (&m)[kPix][N], const float (&v)[kPix][NV],
                                           const float4* c, float (&a)[kPix][3]) {
  using S = ChainStep<NV, K>;
  const float4 ck = c[S::target];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const float mk = m[p][S::parent] * v[p][S::var];
    m[p][S::target] = mk;
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
  // accumulation order of the reference chain in the graded order, the
  // chain's own in the depth-first one.
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

// Storage <-> fp32. uint8 is the u8 wire: x / 255 in, floor-quantized out.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(uint8_t x) {
  return curl_planes::div<curl_planes::By255>(static_cast<float>(x));
}

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
  // Dynamic shared memory (shared_bytes): the 3 x N coefficients the pixels
  // read, then, spatial only, the image's 3 x kSpatialRaw staged for the fold.
  extern __shared__ float4 s_shared[];
  float4* s_coef = s_shared;

  const int row = blockIdx.y;
  const long long image = blockIdx.z;
  const float4* src = coef + image * (3 * kRaw);
  if constexpr (SPATIAL) {
    // Stage the image's 3 x kSpatialRaw coefficients, then fold this row's y
    // into 3 x kFolded: c'_q = ((c_(q,D) y + c_(q,D-1)) y + ...) y + c_(q,0).
    float4* s_raw = s_shared + 3 * N;
    for (int i = threadIdx.x; i < 3 * kSpatialRaw; i += kThreads) s_raw[i] = src[i];
    __syncthreads();
    const float y = static_cast<float>(row + row0) / static_cast<float>(total_h);
    for (int i = threadIdx.x; i < 3 * N; i += kThreads) {
      const int space = i / N;
      const int q = i - space * N;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int e = kDegree; e >= 0; --e) {
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
    curl_planes::rgb_from_lab(sigmoid(o[p][0]), sigmoid(o[p][1]), sigmoid(o[p][2]), q0,
                              q1, q2);
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
    curl_planes::rgb_from_hsv(sigmoid(o[p][0]), sigmoid(o[p][1]), sigmoid(o[p][2]), q0,
                              q1, q2);
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

// Bytes of dynamic shared memory an instance stages: 3 x N coefficients,
// plus 3 x kSpatialRaw raw ones when spatial (9,408 B at degree 4, 32,256 B
// at degree 6).
template <bool SPATIAL>
constexpr int shared_bytes() {
  return static_cast<int>(sizeof(float4)) *
         (3 * NumCoeffs<SPATIAL ? 4 : 3>::value + (SPATIAL ? 3 * kSpatialRaw : 0));
}

// grid.y (rows) and grid.z (images) take at most 65,535 each: a larger
// batch or height launches in chunks, each from its first image and row,
// with row0 advanced by the chunk's first row, so the kernel sees what one
// launch would.
template <typename T, bool SPATIAL, bool COMPOSITE>
cudaError_t launch(const void* img, const void* coef, void* out, long long batch,
                   long long height, int width, int row0, int total_h, int total_w,
                   cudaStream_t stream) {
  constexpr int kRaw = SPATIAL ? kSpatialRaw : NumCoeffs<3>::value;
  constexpr int kBytes = shared_bytes<SPATIAL>();
  const auto kernel = &trispace_residual_kernel<T, SPATIAL, COMPOSITE>;
  if (kBytes > kStaticSharedBytes) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks_x = static_cast<unsigned>((width + kBlockPixels - 1) / kBlockPixels);
  for (long long i0 = 0; i0 < batch; i0 += kMaxGridYZ) {
    const long long nb = batch - i0 < kMaxGridYZ ? batch - i0 : kMaxGridYZ;
    for (long long r0 = 0; r0 < height; r0 += kMaxGridYZ) {
      const long long nr = height - r0 < kMaxGridYZ ? height - r0 : kMaxGridYZ;
      const long long first = (i0 * height + r0) * width * 3;
      kernel<<<dim3(blocks_x, static_cast<unsigned>(nr), static_cast<unsigned>(nb)), kThreads,
               kBytes, stream>>>(
          static_cast<const T*>(img) + first, static_cast<const float4*>(coef) + i0 * 3 * kRaw,
          static_cast<T*>(out) + first, static_cast<int>(height), width,
          row0 + static_cast<int>(r0), total_h, total_w);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(int spatial, int composite, const void* img, const void* coef,
                     void* out, long long batch, long long height, int width, int row0,
                     int total_h, int total_w, cudaStream_t stream) {
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
// coef: (batch, 3, N, 4) contiguous float32, N = kSpatialRaw when spatial
// else kPlain (126 and 35 at degree 4), the 4th lane unused. Launches on
// `stream` without synchronizing; returns the first error of a launch (or
// of the shared-memory opt-in), else cudaSuccess.
int curl_trispace_residual(const void* img, const void* coef, void* out, long long batch,
                           long long height, long long width, int row0, int total_h,
                           int total_w, int spatial, int composite, int dtype,
                           void* stream) {
  if (batch <= 0 || height <= 0 || height > 0x7fffffff || width <= 0 ||
      width > 0x7fffffff - kBlockPixels || total_h <= 0 || total_w <= 0 ||
      (dtype == 2 && !composite) || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(width);
  cudaError_t err;
  if (dtype == 2) {
    err = spatial
        ? launch<uint8_t, true, true>(img, coef, out, batch, height, w, row0, total_h, total_w, s)
        : launch<uint8_t, false, true>(img, coef, out, batch, height, w, row0, total_h, total_w, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(spatial, composite, img, coef, out, batch, height, w, row0,
                                  total_h, total_w, s);
  } else {
    err = dispatch<float>(spatial, composite, img, coef, out, batch, height, w, row0, total_h,
                          total_w, s);
  }
  return static_cast<int>(err);
}

// The polynomial degree this library was built for.
int curl_trispace_degree() { return kDegree; }

const char* curl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
