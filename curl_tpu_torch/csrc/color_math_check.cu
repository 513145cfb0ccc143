// Per-function check of the color math primitives of color_planes.cuh.
//
// Each primitive of the Lean and the Ieee policy (the constant divisions,
// recip, sigmoid, the two sRGB powers, cube, cube root) is evaluated on every
// float32 of a range of bit patterns and compared with float64 of the
// function it computes: x / c, 1 / x, 1 / (1 + e^-x), u^2.4f and x^(1/2.4)
// with the kernels' float exponents, t^3, and the cube root. The largest
// absolute error, the largest error in ulps of the float32 nearest the
// reference, the count of inputs where Lean and Ieee differ in any bit, and
// the count of inputs checked are reduced on the card. Divisions and recip
// count only inputs whose quotient is a normal float32, sigmoid only inputs
// whose sigmoid is.
//
// Not a kernel of any path: ops/kernels/color_math.py builds it with
// build.py and drives it for tools/kernel_probe.py and tests/test_torch_cuda.py.
// Reductions are per warp by shuffles, then one 64-bit atomicMax or atomicAdd
// per warp (errors as the bits of non-negative doubles, so a NaN error ranks
// above every number).

#include <cuda_runtime.h>

#include <cstdint>

#include "color_planes.cuh"

namespace {

using curl_planes::Ieee;
using curl_planes::Lean;

constexpr int kThreads = 256;
constexpr int kBlocks = 132 * 16;
constexpr double kFloatMin = 1.1754943508222875e-38;  // 2^-126
constexpr double kFloatMax = 3.4028234663852886e38;

// Primitive codes of curl_color_math_check; kDivision + i is divisor i of
// curl_planes::AllDivisors.
enum Primitive : int {
  kRecip = 0, kSigmoid = 1, kSrgbPow = 2, kSrgbRoot = 3, kCube = 4, kCbrt = 5, kDivision = 16,
};

__device__ __forceinline__ bool normal(double y) {
  return fabs(y) >= kFloatMin && fabs(y) <= kFloatMax;
}

// The spacing of float32 at the float32 nearest y.
__device__ __forceinline__ double ulp_at(double y) {
  const float f = static_cast<float>(fabs(y));
  if (f < static_cast<float>(kFloatMin)) return 1.401298464324817e-45;  // 2^-149
  int e;
  frexp(static_cast<double>(f), &e);  // f = m 2^e, m in [0.5, 1)
  return ldexp(1.0, e - 24);
}

// Each check: false to skip x; else the Lean and Ieee values and the float64
// reference.
template <class D> struct DivisionCheck {
  __device__ bool operator()(float x, float& lean, float& ieee, double& ref) const {
    ieee = curl_planes::div<Ieee, D>(x);
    if (!normal(ieee)) return false;
    lean = curl_planes::div<Lean, D>(x);
    ref = static_cast<double>(x) / static_cast<double>(D::c);
    return true;
  }
};

struct RecipCheck {
  __device__ bool operator()(float x, float& lean, float& ieee, double& ref) const {
    ieee = Ieee::recip(x);
    if (!normal(ieee)) return false;
    lean = Lean::recip(x);
    ref = 1.0 / static_cast<double>(x);
    return true;
  }
};

// Below x ~ -87.3 the sigmoid is subnormal, and from ~-88.7 on expf(-x)
// overflows in both policies and the result is 0: those x are skipped.
struct SigmoidCheck {
  __device__ bool operator()(float x, float& lean, float& ieee, double& ref) const {
    ref = 1.0 / (1.0 + exp(-static_cast<double>(x)));
    if (!isfinite(x) || !normal(ref)) return false;
    lean = Lean::sigmoid(x);
    ieee = Ieee::sigmoid(x);
    return true;
  }
};

struct SrgbPowCheck {
  __device__ bool operator()(float u, float& lean, float& ieee, double& ref) const {
    lean = Lean::srgb_pow(u);
    ieee = Ieee::srgb_pow(u);
    ref = pow(static_cast<double>(u), static_cast<double>(2.4f));
    return true;
  }
};

struct SrgbRootCheck {
  __device__ bool operator()(float x, float& lean, float& ieee, double& ref) const {
    lean = Lean::srgb_root(x);
    ieee = Ieee::srgb_root(x);
    ref = pow(static_cast<double>(x), static_cast<double>(static_cast<float>(1.0 / 2.4)));
    return true;
  }
};

struct CubeCheck {
  __device__ bool operator()(float t, float& lean, float& ieee, double& ref) const {
    lean = Lean::cube(t);
    ieee = Ieee::cube(t);
    const double d = t;
    ref = d * d * d;
    return true;
  }
};

struct CbrtCheck {
  __device__ bool operator()(float t, float& lean, float& ieee, double& ref) const {
    lean = Lean::cbrt(t);
    ieee = Ieee::cbrt(t);
    ref = cbrt(static_cast<double>(t));
    return true;
  }
};

// out: Lean's max abs and max ulp error (double bits), Ieee's, the count of
// inputs where the two differ, the count checked.
constexpr int kOut = 6;

__device__ __forceinline__ unsigned long long error_bits(double err) {
  return static_cast<unsigned long long>(__double_as_longlong(fabs(err)));
}

template <class F>
__global__ void __launch_bounds__(kThreads)
check_kernel(F check, uint32_t first, unsigned long long count, unsigned long long* out) {
  unsigned long long acc[kOut] = {0, 0, 0, 0, 0, 0};
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (unsigned long long i = static_cast<unsigned long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < count; i += stride) {
    const float x = __uint_as_float(first + static_cast<uint32_t>(i));
    float lean, ieee;
    double ref;
    if (!check(x, lean, ieee, ref)) continue;
    const double ulp = ulp_at(ref);
    const double lean_err = static_cast<double>(lean) - ref;
    const double ieee_err = static_cast<double>(ieee) - ref;
    acc[0] = max(acc[0], error_bits(lean_err));
    acc[1] = max(acc[1], error_bits(lean_err / ulp));
    acc[2] = max(acc[2], error_bits(ieee_err));
    acc[3] = max(acc[3], error_bits(ieee_err / ulp));
    acc[4] += __float_as_uint(lean) != __float_as_uint(ieee);
    acc[5] += 1;
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    for (int offset = 16; offset > 0; offset /= 2) {
      const unsigned long long other = __shfl_down_sync(0xffffffffu, acc[k], offset);
      acc[k] = k < 4 ? max(acc[k], other) : acc[k] + other;
    }
  }
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      if (k < 4) {
        atomicMax(out + k, acc[k]);
      } else {
        atomicAdd(out + k, acc[k]);
      }
    }
  }
}

template <class F>
cudaError_t launch(uint32_t first, unsigned long long count, unsigned long long* out,
                   cudaStream_t stream) {
  check_kernel<F><<<kBlocks, kThreads, 0, stream>>>(F{}, first, count, out);
  return cudaGetLastError();
}

template <class... D>
cudaError_t launch_division(int index, curl_planes::Divisors<D...>, uint32_t first,
                            unsigned long long count, unsigned long long* out,
                            cudaStream_t stream) {
  int k = 0;
  cudaError_t err = cudaErrorInvalidValue;
  ((k++ == index ? (err = launch<DivisionCheck<D>>(first, count, out, stream), 0) : 0), ...);
  return err;
}

template <class... D> constexpr int divisor_count(curl_planes::Divisors<D...>) {
  return sizeof...(D);
}

template <class... D> float divisor_value(int index, curl_planes::Divisors<D...>) {
  const float values[] = {D::c...};
  return values[index];
}

}  // namespace

extern "C" {

// Checks `primitive` (kRecip ... kCbrt, or kDivision + i) on the float32s
// whose bits are first, first + 1, ..., first + count - 1 (count <= 2^32),
// into `out`: 6 unsigned 64-bit words on the device, zeroed by the caller.
// Launches on `stream` without synchronizing; returns the launch's error.
int curl_color_math_check(int primitive, unsigned int first, unsigned long long count,
                          void* out, void* stream) {
  auto* o = static_cast<unsigned long long*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (count == 0 || count > (1ull << 32) || first + (count - 1) > 0xffffffffull) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (primitive) {
    case kRecip: err = launch<RecipCheck>(first, count, o, s); break;
    case kSigmoid: err = launch<SigmoidCheck>(first, count, o, s); break;
    case kSrgbPow: err = launch<SrgbPowCheck>(first, count, o, s); break;
    case kSrgbRoot: err = launch<SrgbRootCheck>(first, count, o, s); break;
    case kCube: err = launch<CubeCheck>(first, count, o, s); break;
    case kCbrt: err = launch<CbrtCheck>(first, count, o, s); break;
    default:
      err = launch_division(primitive - kDivision, curl_planes::AllDivisors{}, first, count, o,
                            s);
  }
  return static_cast<int>(err);
}

// The constant divisors of curl_planes::AllDivisors, in its order.
int curl_color_math_divisors() { return divisor_count(curl_planes::AllDivisors{}); }

float curl_color_math_divisor(int index) {
  return divisor_value(index, curl_planes::AllDivisors{});
}

const char* curl_color_math_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
