// K1's backward to the coefficients, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package has no backward Pallas kernel: its
// custom VJP differentiates the XLA version of the residual
// (curl_tpu/ops/pallas/trispace_kernel.py:279, `_fused_vjp_bwd`). The port
// first did the same in plain torch, recomputing the residual and running
// autograd through it: thousands of small launches a training step. This
// kernel computes the three coefficient stacks' gradients of
// `ops/kernels/trispace_kernel.py::fused_trispace_residual_reference` in one
// pass over the pixels and a short second pass over the rows. The image's
// gradient is not computed here: training never asks for it.
//
// Per pixel it recomputes what K1's forward computes, with the forward's
// color math (color_planes.cuh): the Lab and HSV planes, x = col/total_w,
// each space's pre-sigmoid z by the folded chain of trispace_tables.h,
// s = sigmoid(z), the back-conversions (color_planes.cuh's
// rgb_from_lab_state and hsv_ramps, the forward's own arithmetic, keep the
// terms their vector-Jacobian products read) and the residual, then pulls
// the upstream gradient back through composite's clip, the residual's
// factor 2, the vector-Jacobian products of rgb_from_lab and rgb_from_hsv
// and s(1 - s), to nine values g, one per (space, channel). Each
// clip and floor passes half the gradient at an exact bound (the port's tie
// rule, ops/color_planes.py), and each branch the gradient of the branch it
// took, as autograd does through the plain version. The gradient of
// coefficient (space, channel, k) is the sum over pixels of g * m_k, m_k the
// k-th monomial of (c1, c2, c3, x, y).
//
// What bounds it: operations. At degree 4 the pixel's forward is K1's ~2,067
// FLOP, its backward color math ~200, and the products with the monomials
// 9 x (69 + 70) multiplies and FMAs: ~3,500 FLOP a pixel, 7.3 GFLOP at batch
// 32 of 256x256 (0.11 ms at 67 TFLOP/s); it reads 24 B a pixel in fp32
// (image and gradient), far below the ridge.
//
// What this design does about it:
// - The transpose of the forward's y-fold. y is constant along a row, so the
//   sums are taken over the C(D+4, 4) monomials of (c1, c2, c3, x) (70) a
//   row, and only the row sums are expanded by powers of y into the
//   C(D+5, 5) (126) coefficients, in the second pass, by kUnfoldY
//   (trispace_backward_tables.h). A pixel costs 9 x (69 FMUL + 70 FFMA), not
//   9 x (125 + 126).
// - Sums in registers. A block has 9 warps, one per (space, channel). It
//   takes 4 rows at a time in tiles of 4 x 256 pixels: all 288 threads
//   compute the tile's g and color planes into shared memory (phase 1); then
//   each warp walks its pair's chain over the tile, 8 lanes a row, 32
//   pixels a lane, each lane holding the 70 sums of its pixels in registers
//   (phase 2). A row is reduced once, over its 8 lanes by shuffles, after
//   its last tile. Past 72 monomials (degree 5 on) the sums are taken in
//   passes over ranges of the monomials, the chain recomputed in each.
//   Registers before occupancy: one block an SM, up to 168 registers a
//   thread, was 10% faster at batch 32 of 256x256 than two blocks at 96
//   registers with 150-170 B of spills, and twice as fast as three at 72
//   (PERF.md).
// - Deterministic: no atomics. Each row's 9 x C(D+4, 4) sums go to a
//   scratch tensor, and the second pass sums them over the rows in a fixed
//   order; the same inputs give the same bits.
// - fp32 FFMA throughout, no tensor cores: the training recipe states
//   float32 with TF32 off.
//
// Layout: image and gradient NHWC, float32 or bfloat16; coefficients the
// forward's packed (B, 3, N, 4) float4s; the output (3, B, 3, N) float32,
// one (B, 3, N) stack a space. Grid: x the tile of 4 rows, y the image;
// past 65,535 images the launch is split in chunks (curl_trispace_backward).
// Shared memory: 192 x C(D+4, 4) + 77,056 B (90 KB at degree 4); past
// degree 9 that exceeds the 227 KB a block may have, and the wrapper refuses
// the degree (trispace_kernel.py, check_backward_supported).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "color_planes.cuh"
#include "trispace_backward_tables.h"  // generated by ops/kernels/poly_tables.py
#include "trispace_tables.h"           // the forward's: chains, fold, counts

namespace {

constexpr int kPairs = 9;                                   // (space, channel)
constexpr int kBwdThreads = 32 * kPairs;                    // one warp a pair
constexpr int kTileRows = 4;
constexpr int kTileCols = 256;
constexpr int kTilePixels = kTileRows * kTileCols;
constexpr int kLanesPerRow = 32 / kTileRows;                // 8
constexpr int kColsPerLane = kTileCols / kLanesPerRow;      // 32
// A plane's row stride in shared memory: the 4 rows a warp reads land 8
// banks apart, so its 32 lanes read 32 banks.
constexpr int kRowStride = kTileCols + 8;
constexpr int kPlaneFloats = kTileRows * kRowStride;
constexpr int kMaxAcc = 72;   // sums a lane holds in registers in one pass
constexpr int kSumChunk = 64;  // rows summed apart before they are added up
constexpr int kExpandThreads = 128;
constexpr int kMaxGridY = 65535;

using curl_planes::clampf;
using curl_planes::sigmoid;

template <int NV> struct NumCoeffs;
template <> struct NumCoeffs<4> { static constexpr int value = kFolded; };
template <> struct NumCoeffs<3> { static constexpr int value = kPlain; };

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

// The forward's chain for one pixel: z = sum_k c_k m_k for three channels,
// the constant first and each monomial as it is formed.
template <int NV, int N, int K>
__device__ __forceinline__ void eval_step(float (&m)[N], const float (&v)[NV], const float4* c,
                                          float (&z)[3]) {
  using S = ChainStep<NV, K>;
  const float4 ck = c[S::target];
  const float mk = m[S::parent] * v[S::var];
  m[S::target] = mk;
  z[0] = fmaf(ck.x, mk, z[0]);
  z[1] = fmaf(ck.y, mk, z[1]);
  z[2] = fmaf(ck.z, mk, z[2]);
}

template <int NV, int N, int... K>
__device__ __forceinline__ void eval_chain(const float (&v)[NV], const float4* c, float (&z)[3],
                                           std::integer_sequence<int, K...>) {
  float m[N];
  m[0] = 1.0f;
  const float4 c0 = c[0];
  z[0] = c0.x;
  z[1] = c0.y;
  z[2] = c0.z;
  (eval_step<NV, N, K>(m, v, c, z), ...);
}

// The backward's chain for one pixel: acc[k - LO] += g * m_k for the
// monomials k in [LO, HI). The monomials outside the range that no monomial
// in it descends from are dead code.
template <int NV, int N, int LO, int HI, int K>
__device__ __forceinline__ void acc_step(float (&m)[N], const float (&v)[NV], float g,
                                         float (&acc)[HI - LO]) {
  using S = ChainStep<NV, K>;
  const float mk = m[S::parent] * v[S::var];
  m[S::target] = mk;
  if constexpr (S::target >= LO && S::target < HI) {
    acc[S::target - LO] = fmaf(g, mk, acc[S::target - LO]);
  }
}

template <int NV, int N, int LO, int HI, int... K>
__device__ __forceinline__ void acc_chain(const float (&v)[NV], float g, float (&acc)[HI - LO],
                                          std::integer_sequence<int, K...>) {
  float m[N];
  m[0] = 1.0f;
  if constexpr (LO == 0) acc[0] += g;
  (acc_step<NV, N, LO, HI, K>(m, v, g, acc), ...);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The tie rule's factor: 1 inside [lo, hi], 1/2 at a bound, 0 outside.
__device__ __forceinline__ float tie(float x, float lo, float hi) {
  return (x < lo || x > hi) ? 0.0f : ((x == lo || x == hi) ? 0.5f : 1.0f);
}

// d srgb_encode(x) / dx: the branch taken's derivative. The root's branch
// is taken above 0.0031308, where floor_at(x, 1e-4) passes all of it:
// 1.055 * x^(1/2.4 - 1) / 2.4, as root / x.
__device__ __forceinline__ float srgb_encode_grad(float x) {
  if (x <= 0.0031308f) return 12.92f;
  const float xf = fmaxf(x, 1e-4f);
  return 1.055f * (static_cast<float>(1.0 / 2.4) * (curl_planes::srgb_root(xf) / xf));
}

// d lab_finv(t) / dt: 3 eps^2 on the linear branch, 3 t^2 on the cube's
// (taken above eps, where floor_at passes all of it).
__device__ __forceinline__ float lab_finv_grad(float t) {
  if (t <= static_cast<float>(curl_planes::kEps)) {
    return static_cast<float>(3.0 * curl_planes::kEps * curl_planes::kEps);
  }
  return 3.0f * (t * t);
}

// The vector-Jacobian product of rgb_from_lab with the upstream d: its
// gradient over the three inputs, in place.
__device__ __forceinline__ void rgb_from_lab_vjp(const curl_planes::LabState& st,
                                                 float (&d)[3]) {
  const float dr = d[0] * srgb_encode_grad(st.lin[0]);
  const float dg = d[1] * srgb_encode_grad(st.lin[1]);
  const float db = d[2] * srgb_encode_grad(st.lin[2]);
  const float dx = dr * 3.2404542f + dg * -0.9692660f + db * 0.0556434f;
  const float dy = dr * -1.5371385f + dg * 1.8760108f + db * -0.2040259f;
  const float dz = dr * -0.4985314f + dg * 0.0415560f + db * 1.0572252f;
  const float dfx = dx * 0.950456f * lab_finv_grad(st.fx);
  const float dfz = dz * 1.088754f * lab_finv_grad(st.fz);
  const float dfy = dy * lab_finv_grad(st.fy) + dfx + dfz;
  d[0] = curl_planes::div<curl_planes::By116>(dfy) * 100.0f;
  d[1] = curl_planes::div<curl_planes::By500>(dfx) * 110.0f * 2.0f;
  d[2] = -curl_planes::div<curl_planes::By200>(dfz) * 110.0f * 2.0f;
}

// The vector-Jacobian product of rgb_from_hsv at (h_in, s_in, v_in), its
// terms `t` (hsv_ramps of the same), in place.
__device__ __forceinline__ void rgb_from_hsv_vjp(const curl_planes::HsvRamps& t, float h_in,
                                                 float s_in, float v_in, float (&d)[3]) {
  using curl_planes::By60;
  using curl_planes::div;
  const float dr = d[0] * tie(t.r, 0.0f, 1.0f);
  const float dg = d[1] * tie(t.g, 0.0f, 1.0f);
  const float db = d[2] * tie(t.b, 0.0f, 1.0f);
  const float dm_dn = dr * t.p60 - dr * t.p240;
  const float dm_up = dg * t.p0 - dg * t.p180 + db * t.p120 - db * t.p300;
  const float dh360 = dr * t.m_dn * tie(t.h360 - 60.0f, 0.0f, 60.0f)
                    - dr * t.m_dn * tie(t.h360 - 240.0f, 0.0f, 60.0f)
                    + dg * t.m_up * tie(t.h360 - 0.0f, 0.0f, 60.0f)
                    - dg * t.m_up * tie(t.h360 - 180.0f, 0.0f, 60.0f)
                    + db * t.m_up * tie(t.h360 - 120.0f, 0.0f, 60.0f)
                    - db * t.m_up * tie(t.h360 - 300.0f, 0.0f, 60.0f);
  const float dvmin = dg + db + div<By60>(dm_dn) - div<By60>(dm_up);
  const float dv = dr - div<By60>(dm_dn) + div<By60>(dm_up) + dvmin * (1.0f - t.s);
  const float ds = -(dvmin * t.v);
  d[0] = dh360 * 360.0f * tie(h_in, 0.0f, 1.0f);
  d[1] = ds * tie(s_in, 0.0f, 1.0f);
  d[2] = dv * tie(v_in, 0.0f, 1.0f);
}

// Dynamic shared memory of an instance, in bytes: the folded coefficients
// of the tile's rows (one set when not spatial), the nine color planes and
// the nine g of the tile, and the tile's x coordinates.
template <bool SPATIAL>
constexpr int shared_bytes() {
  constexpr int n = NumCoeffs<SPATIAL ? 4 : 3>::value;
  return static_cast<int>(sizeof(float4)) * (SPATIAL ? kTileRows : 1) * 3 * n +
         static_cast<int>(sizeof(float)) * (2 * kPairs * kPlaneFloats + kTileCols);
}

// Phase 2 for the monomials [LO, HI): over the row's column tiles, each
// lane's sums of g * m_k in registers; then the row's 8 lanes reduced and
// its first lane writes them to `sums`. Phase 1 is run for a column tile
// unless it is the tile already in shared memory.
template <bool SPATIAL, int LO, int HI, class Phase1>
__device__ __forceinline__ void row_sums(const Phase1& phase1, int col_tiles, bool first_pass,
                                         const float* s_plane, const float* s_grad,
                                         const float* s_x, float* sums, bool row_live) {
  constexpr int NV = SPATIAL ? 4 : 3;
  constexpr int N = NumCoeffs<NV>::value;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int space = warp / 3;
  const int r = lane / kLanesPerRow;
  const int j = lane % kLanesPerRow;
  const float* p0 = s_plane + (3 * space) * kPlaneFloats + r * kRowStride;
  const float* p1 = p0 + kPlaneFloats;
  const float* p2 = p1 + kPlaneFloats;
  const float* pg = s_grad + warp * kPlaneFloats + r * kRowStride;
  float acc[HI - LO];
#pragma unroll
  for (int k = 0; k < HI - LO; ++k) acc[k] = 0.0f;
  for (int t = 0; t < col_tiles; ++t) {
    if (col_tiles > 1 || first_pass) {
      __syncthreads();  // the previous tile's readers are done
      phase1(t);
      __syncthreads();
    }
#pragma unroll 1
    for (int i = 0; i < kColsPerLane; ++i) {
      const int c = j + i * kLanesPerRow;
      float v[NV];
      v[0] = p0[c];
      v[1] = p1[c];
      v[2] = p2[c];
      if constexpr (SPATIAL) v[3] = s_x[c];
      acc_chain<NV, N, LO, HI>(v, pg[c], acc, std::make_integer_sequence<int, N - 1>{});
    }
  }
#pragma unroll
  for (int k = 0; k < HI - LO; ++k) {
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off /= 2) {
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
  }
  if (j == 0 && row_live) {
#pragma unroll
    for (int k = 0; k < HI - LO; ++k) sums[warp * N + LO + k] = acc[k];
  }
}

// Every pass of row_sums, over the monomials [P * PER, min((P + 1) * PER, N)).
template <bool SPATIAL, int N, int PER, class Phase1, int... P>
__device__ __forceinline__ void passes(std::integer_sequence<int, P...>, const Phase1& phase1,
                                       int col_tiles, const float* s_plane, const float* s_grad,
                                       const float* s_x, float* sums, bool row_live) {
  (row_sums<SPATIAL, P * PER, ((P + 1) * PER < N ? (P + 1) * PER : N)>(
       phase1, col_tiles, P == 0, s_plane, s_grad, s_x, sums, row_live),
   ...);
}

template <typename T, bool SPATIAL, bool COMPOSITE>
__global__ void __launch_bounds__(kBwdThreads, 1)
trispace_backward_kernel(const T* __restrict__ img, const T* __restrict__ grad,
                         const float4* __restrict__ coef, float* __restrict__ rowsum,
                         int height, int width, int row0, int total_h, int total_w) {
  constexpr int NV = SPATIAL ? 4 : 3;
  constexpr int N = NumCoeffs<NV>::value;
  constexpr int kRaw = SPATIAL ? kSpatialRaw : N;
  constexpr int kPasses = (N + kMaxAcc - 1) / kMaxAcc;
  constexpr int kPerPass = (N + kPasses - 1) / kPasses;
  extern __shared__ float4 s_shared[];
  float4* s_coef = s_shared;
  float* s_plane = reinterpret_cast<float*>(s_coef + (SPATIAL ? kTileRows : 1) * 3 * N);
  float* s_grad = s_plane + kPairs * kPlaneFloats;
  float* s_x = s_grad + kPairs * kPlaneFloats;

  const int tile_row0 = blockIdx.x * kTileRows;
  const long long image = blockIdx.y;
  const float4* src = coef + image * (3 * kRaw);
  if constexpr (SPATIAL) {
    // Each row's fold, as the forward's prologue forms it:
    // c'_q = ((c_(q,D) y + c_(q,D-1)) y + ...) y + c_(q,0).
    for (int i = threadIdx.x; i < kTileRows * 3 * N; i += kBwdThreads) {
      const int r = i / (3 * N);
      const int space = (i - r * 3 * N) / N;
      const int q = i - r * 3 * N - space * N;
      const float y = static_cast<float>(tile_row0 + r + row0) / static_cast<float>(total_h);
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int e = kDegree; e >= 0; --e) {
        const int k = kFoldY[q][e];
        if (k >= 0) {
          const float4 c = src[space * kRaw + k];
          acc.x = fmaf(acc.x, y, c.x);
          acc.y = fmaf(acc.y, y, c.y);
          acc.z = fmaf(acc.z, y, c.z);
        }
      }
      s_coef[i] = acc;
    }
  } else {
    for (int i = threadIdx.x; i < 3 * N; i += kBwdThreads) s_coef[i] = src[i];
  }

  // Phase 1 for column tile t: each pixel's nine color planes and nine g
  // into shared memory (zeros past the image's edge, which add nothing).
  const auto phase1 = [&](int t) {
    const int col0 = t * kTileCols;
    for (int c = threadIdx.x; c < kTileCols; c += kBwdThreads) {
      s_x[c] = static_cast<float>(col0 + c) / static_cast<float>(total_w);
    }
    for (int px = threadIdx.x; px < kTilePixels; px += kBwdThreads) {
      const int r = px / kTileCols;
      const int c = px - r * kTileCols;
      const int row = tile_row0 + r;
      const int col = col0 + c;
      const int at = r * kRowStride + c;
      if (row >= height || col >= width) {
#pragma unroll
        for (int k = 0; k < kPairs; ++k) {
          s_plane[k * kPlaneFloats + at] = 0.0f;
          s_grad[k * kPlaneFloats + at] = 0.0f;
        }
        continue;
      }
      const long long off = ((image * height + row) * static_cast<long long>(width) + col) * 3;
      float pl[kPairs];
#pragma unroll
      for (int k = 0; k < 3; ++k) pl[k] = to_float(img[off + k]);
      curl_planes::lab_from_rgb(pl[0], pl[1], pl[2], pl[3], pl[4], pl[5]);
      curl_planes::hsv_from_rgb(pl[0], pl[1], pl[2], pl[6], pl[7], pl[8]);
      const float x = static_cast<float>(col) / static_cast<float>(total_w);
      const float4* rc = s_coef + (SPATIAL ? r * 3 * N : 0);
      float s[3][3];
#pragma unroll
      for (int sp = 0; sp < 3; ++sp) {
        float v[NV];
        v[0] = pl[3 * sp];
        v[1] = pl[3 * sp + 1];
        v[2] = pl[3 * sp + 2];
        if constexpr (SPATIAL) v[3] = x;
        float z[3];
        eval_chain<NV, N>(v, rc + sp * N, z, std::make_integer_sequence<int, N - 1>{});
#pragma unroll
        for (int k = 0; k < 3; ++k) s[sp][k] = sigmoid(z[k]);
      }
      // The upstream gradient on the residual: through the composite's
      // clip of img + residual (the residual as the forward sums it), then
      // the factor 2 of each 2 (o - 0.5).
      float d[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = to_float(grad[off + k]);
      curl_planes::LabState lab;
      float o1[3];
      curl_planes::rgb_from_lab_state(s[1][0], s[1][1], s[1][2], lab, o1[0], o1[1], o1[2]);
      if constexpr (COMPOSITE) {
        float o2[3];
        curl_planes::rgb_from_hsv(s[2][0], s[2][1], s[2][2], o2[0], o2[1], o2[2]);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float res = 0.0f + 2.0f * (s[0][k] - 0.5f);
          res += 2.0f * (o1[k] - 0.5f);
          res += 2.0f * (o2[k] - 0.5f);
          d[k] *= tie(pl[k] + res, 0.0f, 1.0f);
        }
      }
      float dl[3], dh[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        d[k] *= 2.0f;
        dl[k] = d[k];
        dh[k] = d[k];
      }
      rgb_from_lab_vjp(lab, dl);
      rgb_from_hsv_vjp(curl_planes::hsv_ramps(s[2][0], s[2][1], s[2][2]), s[2][0], s[2][1],
                       s[2][2], dh);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float g[3] = {d[k], dl[k], dh[k]};
#pragma unroll
        for (int sp = 0; sp < 3; ++sp) {
          s_grad[(3 * sp + k) * kPlaneFloats + at] = (g[sp] * (1.0f - s[sp][k])) * s[sp][k];
        }
      }
#pragma unroll
      for (int k = 0; k < kPairs; ++k) s_plane[k * kPlaneFloats + at] = pl[k];
    }
  };

  const int col_tiles = (width + kTileCols - 1) / kTileCols;
  const int row = tile_row0 + (threadIdx.x % 32) / kLanesPerRow;
  float* sums = rowsum + (image * height + row) * static_cast<long long>(kPairs * N);
  const bool row_live = row < height;
  passes<SPATIAL, N, kPerPass>(std::make_integer_sequence<int, kPasses>{}, phase1, col_tiles,
                               s_plane, s_grad, s_x, sums, row_live);
}

// The second pass: coefficient gradient j of pair (space, channel) of one
// image is sum over rows of y^e * rowsum[row][pair][q], (q, e) = kUnfoldY[j]
// (spatial) or (j, 0), summed in row order, kSumChunk rows at a time, the
// chunks' sums added with Neumaier's compensation (tens of thousands of
// rows add up to no more rounding than a few chunks).
template <bool SPATIAL>
__global__ void __launch_bounds__(kExpandThreads)
trispace_backward_expand(const float* __restrict__ rowsum, float* __restrict__ out,
                         long long batch, long long image0, int height, int row0,
                         int total_h) {
  constexpr int N = NumCoeffs<SPATIAL ? 4 : 3>::value;
  constexpr int kRaw = SPATIAL ? kSpatialRaw : N;
  const int i = blockIdx.x * kExpandThreads + threadIdx.x;
  if (i >= kPairs * kRaw) return;
  const int pair = i / kRaw;
  const int j = i - pair * kRaw;
  const int q = SPATIAL ? kUnfoldY[j][0] : j;
  const int e = SPATIAL ? kUnfoldY[j][1] : 0;
  const long long image = blockIdx.y;
  const float* src = rowsum + image * height * static_cast<long long>(kPairs * N) + pair * N + q;
  float total = 0.0f, lost = 0.0f;
  for (int r0 = 0; r0 < height; r0 += kSumChunk) {
    const int r1 = r0 + kSumChunk < height ? r0 + kSumChunk : height;
    float part = 0.0f;
    for (int r = r0; r < r1; ++r) {
      float ye = 1.0f;
      if (SPATIAL && e > 0) {
        const float y = static_cast<float>(r + row0) / static_cast<float>(total_h);
        for (int k = 0; k < e; ++k) ye *= y;
      }
      part = fmaf(ye, src[r * static_cast<long long>(kPairs * N)], part);
    }
    const float sum = total + part;
    lost += fabsf(total) >= fabsf(part) ? (total - sum) + part : (part - sum) + total;
    total = sum;
  }
  const int space = pair / 3;
  const int channel = pair - space * 3;
  out[((space * batch + image0 + image) * 3 + channel) * kRaw + j] = total + lost;
}

template <typename T, bool SPATIAL, bool COMPOSITE>
cudaError_t launch(const void* img, const void* grad, const void* coef, float* rowsum,
                   float* out, long long batch, int height, int width, int row0, int total_h,
                   int total_w, cudaStream_t stream) {
  constexpr int N = NumCoeffs<SPATIAL ? 4 : 3>::value;
  constexpr int kRaw = SPATIAL ? kSpatialRaw : N;
  constexpr int kBytes = shared_bytes<SPATIAL>();
  const auto kernel = &trispace_backward_kernel<T, SPATIAL, COMPOSITE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>((height + kTileRows - 1) / kTileRows);
  const unsigned expand_blocks = (kPairs * kRaw + kExpandThreads - 1) / kExpandThreads;
  for (long long i0 = 0; i0 < batch; i0 += kMaxGridY) {
    const long long nb = batch - i0 < kMaxGridY ? batch - i0 : kMaxGridY;
    const long long first = i0 * height * static_cast<long long>(width) * 3;
    kernel<<<dim3(tiles, static_cast<unsigned>(nb)), kBwdThreads, kBytes, stream>>>(
        static_cast<const T*>(img) + first, static_cast<const T*>(grad) + first,
        static_cast<const float4*>(coef) + i0 * 3 * kRaw, rowsum, height, width, row0,
        total_h, total_w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    trispace_backward_expand<SPATIAL>
        <<<dim3(expand_blocks, static_cast<unsigned>(nb)), kExpandThreads, 0, stream>>>(
            rowsum, out, batch, i0, height, row0, total_h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(int spatial, int composite, const void* img, const void* grad,
                     const void* coef, float* rowsum, float* out, long long batch, int height,
                     int width, int row0, int total_h, int total_w, cudaStream_t stream) {
  if (spatial) {
    return composite ? launch<T, true, true>(img, grad, coef, rowsum, out, batch, height, width,
                                             row0, total_h, total_w, stream)
                     : launch<T, true, false>(img, grad, coef, rowsum, out, batch, height,
                                              width, row0, total_h, total_w, stream);
  }
  return composite ? launch<T, false, true>(img, grad, coef, rowsum, out, batch, height, width,
                                            row0, total_h, total_w, stream)
                   : launch<T, false, false>(img, grad, coef, rowsum, out, batch, height, width,
                                             row0, total_h, total_w, stream);
}

}  // namespace

extern "C" {

// img, grad: (batch, height, width, 3) contiguous, float32 (dtype == 0) or
// bfloat16 (dtype == 1). coef: the forward's (batch, 3, N, 4) float32
// (N = kSpatialRaw when spatial, else kPlain). rowsum: scratch of
// batch * height * 9 * C(D+4, 4) floats (C(D+3, 3) when not spatial), every
// one written before it is read. out: (3, batch, 3, N) float32, the
// gradients of the three coefficient stacks. Launches on `stream` without
// synchronizing; returns the first error, else cudaSuccess.
int curl_trispace_backward(const void* img, const void* grad, const void* coef, void* rowsum,
                           void* out, long long batch, long long height, long long width,
                           int row0, int total_h, int total_w, int spatial, int composite,
                           int dtype, void* stream) {
  if (batch <= 0 || height <= 0 || height > 0x7fffffff - kTileRows || width <= 0 ||
      width > 0x7fffffff - kTileCols || total_h <= 0 || total_w <= 0 || dtype < 0 ||
      dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sums = static_cast<float*>(rowsum);
  float* o = static_cast<float*>(out);
  const int h = static_cast<int>(height);
  const int w = static_cast<int>(width);
  const cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(spatial, composite, img, grad, coef, sums, o, batch,
                                           h, w, row0, total_h, total_w, s)
                 : dispatch<float>(spatial, composite, img, grad, coef, sums, o, batch, h, w,
                                   row0, total_h, total_w, s);
  return static_cast<int>(err);
}

// The polynomial degree this library was built for.
int curl_trispace_backward_degree() { return kDegree; }

// The scratch's floats a row: 9 x the monomials a pixel's chain forms.
int curl_trispace_backward_row_floats(int spatial) {
  return kPairs * (spatial ? kFolded : kPlain);
}

const char* curl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
