// Fused GEM E-step for I = 2 channels, rank-1 sources with real
// (instantaneous) mixing: CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pyfasst_tpu/ops/pallas_estep.py::_make_kernel
// (launched by pallas_estep, pallas_estep.py:379) in its variant
// ranks=(1, ..., 1), real_cov=True, ns_inj=False, with its flags
// fast_recip (variant e: the three reciprocals through recip.cuh's
// approximate reciprocal and Newton step) and no_ll (variant f: log det
// Sigma_x left out of the loglik sum), both uniform per launch. It
// computes, in one pass over each (f, n) bin:
//   - the spatial invariants from the mixing columns: packed R_j, tr R_j and
//     the Lagrange cross terms X_jk (estep.cross_terms);
//   - the subtract-free det Sigma_x = s^2 + s sum_j v_j trR_j
//     + 1/2 sum_jk v_j v_k X_jk (estep.stable_mixture_det);
//   - y = Sigma_x^-1 x and w_j = A_j^H y;
//   - the leave-one-out Woodbury posterior 1 / (1 + v_j A_j^H S_j^-1 A_j);
//   - xi_j, written per bin;
//   - the frame-reduced Txs, Tss, T4, T7 and loglik.
//
// Design. The Pallas kernel sums the frame reductions by revisiting output
// blocks across a grid that runs in order; GPU blocks run in no order, so
// here one thread block owns one (b, f) row of the plane and its threads
// stride over the N frames. Each thread keeps its partial frame sums in
// registers; the block reduces them with warp shuffles and shared memory in
// a fixed order, so results are the same from run to run (no atomics).
// Neighbouring threads handle neighbouring frames, so every load of x4 and
// v and every store of xi is coalesced. The loop bound replaces the Pallas
// ragged-edge select: no thread reads past N.
//
// Numerics follow the Pallas forms: exact IEEE divides (1.0f / x; with
// fast_recip the Pallas _recip at its three sites) and logf,
// coef = 1 / (1 + v M00). Build without --use_fast_math: sigma reaches
// ~3e-6 of the mean power, and approximate divides, flushed denormals or
// __logf would move the statistics. Build with --fmad=false: y = adj x / det
// cancels in some bins, and a product fused into an FMA rounds differently
// there from the plain version (measured 3.7e-4 relative on xi at the bench
// shapes with contraction on); without it the exact zeros of X_jj (rank 1)
// and Im Tss_jj also hold.
//
// What bounds it on an H100: per bin it reads x4 (16 B) and v (4 B per
// source) and writes xi (4 B per source), about 32 B for J = 2, against
// ~150 flops. At the bench shapes (B = 8, F = 513, N = 863: 3.5 M bins)
// that is ~113 MB per E-step, so it is bound by memory bandwidth, not by
// compute. Making it fast is later work.
//
// Layouts (float32, contiguous):
//   x4    (B, 4, F, N)   [Re x0, Im x0, Re x1, Im x1]
//   v     (B, J, F, N)   source PSDs
//   A     (B, J, F, 2)   real mixing column [a0, a1] per source, frequency
//   sigma (B, F)         annealed noise PSD
// Outputs (the Pallas kernel's packed layout, with the clip axis):
//   xi    (B, J, F, N)   max(xi, eps)
//   txs   (B, J, F, 4)   sum_n v_j [x0 w_j*, x1 w_j*] as (re, im, re, im)
//   tss   (B, J, J, F, 2) sum_n v_j v_k w_j w_k*  (re, im)
//   t4    (B, J, F, 4)   [sum_n v_j / (1 + v_j M00), 0, 0, 0]
//   t7    (B, J, J, F, 2) sum_n v_j v_k A_j^T Sigma_x^-1 A_k (re, 0); 0 on j == k
//   ll    (B, F)         sum_n log det Sigma_x + x^H Sigma_x^-1 x

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "recip.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Accumulator slots of one (b, f) row.
template <int J>
struct Slots {
  static constexpr int LL = 0;
  static constexpr int TXS = 1;                  // 4 per source
  static constexpr int TSS = TXS + 4 * J;        // 2 per (j, k)
  static constexpr int T4 = TSS + 2 * J * J;     // 1 per source
  static constexpr int T7 = T4 + J;              // 1 per (j, k); j == k unused
  static constexpr int COUNT = T7 + J * J;
};

// Per-row spatial invariants, derived from the mixing columns.
template <int J>
struct RowConst {
  float a0[J], a1[J];        // real mixing column
  float Ra[J], Rd[J], Rb[J]; // packed R_j = a a^T
  float trR[J];
  float Xc[J][J];            // (a0_j a1_k - a1_j a0_k)^2
  float sig;
};

template <int J>
__device__ __forceinline__ void row_constants(RowConst<J>& c,
                                              const float* __restrict__ Arow,
                                              size_t a_stride, float sig) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    c.a0[j] = Arow[j * a_stride + 0];
    c.a1[j] = Arow[j * a_stride + 1];
    c.Ra[j] = c.a0[j] * c.a0[j];
    c.Rd[j] = c.a1[j] * c.a1[j];
    c.Rb[j] = c.a0[j] * c.a1[j];
    c.trR[j] = c.Ra[j] + c.Rd[j];
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < J; ++k) {
      const float t = c.a0[j] * c.a1[k] - c.a1[j] * c.a0[k];
      c.Xc[j][k] = t * t;
    }
  }
  c.sig = sig;
}

// One (f, n) bin: returns xi_j through xi_out and adds the bin's terms to
// the frame sums in acc.
template <int J>
__device__ __forceinline__ void bin_update(const RowConst<J>& c,
                                           float x0r, float x0i,
                                           float x1r, float x1i,
                                           const float (&v)[J], float eps,
                                           bool fast, bool no_ll,
                                           float (&xi_out)[J],
                                           float (&acc)[Slots<J>::COUNT]) {
  using S = Slots<J>;
  const float sig = c.sig;

  // Sigma_x = sig I + sum_j v_j R_j and its subtract-free determinant
  float sa = 0.f, sd = 0.f, sb = 0.f, lin = 0.f, quad = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    sa += v[j] * c.Ra[j];
    sd += v[j] * c.Rd[j];
    sb += v[j] * c.Rb[j];
    lin += v[j] * c.trR[j];
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < J; ++k) quad += v[j] * v[k] * c.Xc[j][k];
  }
  const float a = sig + sa;
  const float d = sig + sd;
  const float b = sb;
  const float det = sig * sig + sig * lin + 0.5f * quad;
  const float rinv = pyfasst::recip(det, fast);

  // y = Sigma_x^-1 x through the adjugate [d, -b; -b, a]
  const float y0r = rinv * (d * x0r - b * x1r);
  const float y0i = rinv * (d * x0i - b * x1i);
  const float y1r = rinv * (a * x1r - b * x0r);
  const float y1i = rinv * (a * x1i - b * x0i);
  const float tr = fmaxf((x0r * y0r + x0i * y0i) + (x1r * y1r + x1i * y1i),
                         0.0f);
  acc[S::LL] += no_ll ? tr : logf(det) + tr;

  // w_j = A_j^T y and Sigma_x^-1 A_j
  float wr[J], wi[J], u0[J], u1[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    wr[j] = c.a0[j] * y0r + c.a1[j] * y1r;
    wi[j] = c.a0[j] * y0i + c.a1[j] * y1i;
    u0[j] = rinv * (d * c.a0[j] - b * c.a1[j]);
    u1[j] = rinv * (a * c.a1[j] - b * c.a0[j]);
  }

#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float trCR = wr[j] * wr[j] + wi[j] * wi[j];
    // leave-one-out S_j = sig I + sum_{k != j} v_k R_k, subtract-free det
    float la = 0.f, ld = 0.f, lb = 0.f, llin = 0.f, lquad = 0.f;
#pragma unroll
    for (int k = 0; k < J; ++k) {
      if (k == j) continue;
      la += v[k] * c.Ra[k];
      ld += v[k] * c.Rd[k];
      lb += v[k] * c.Rb[k];
      llin += v[k] * c.trR[k];
    }
#pragma unroll
    for (int k = 0; k < J; ++k) {
#pragma unroll
      for (int l = 0; l < J; ++l) {
        if (k == j || l == j) continue;
        lquad += v[k] * v[l] * c.Xc[k][l];
      }
    }
    const float aS = sig + la;
    const float dS = sig + ld;
    const float detS = sig * sig + sig * llin + 0.5f * lquad;
    const float rinvS = pyfasst::recip(detS, fast);
    const float z0 = rinvS * (dS * c.a0[j] - lb * c.a1[j]);
    const float z1 = rinvS * (aS * c.a1[j] - lb * c.a0[j]);
    const float M00 = c.a0[j] * z0 + c.a1[j] * z1;
    const float den = 1.0f + v[j] * M00;
    const float coef = pyfasst::recip(den, fast);
    acc[S::T4 + j] += v[j] / den;
    xi_out[j] = fmaxf(v[j] * v[j] * trCR + v[j] * coef, eps);

    // Txs_j: v_j [x0 conj(w_j), x1 conj(w_j)]
    const float p0r = x0r * wr[j] + x0i * wi[j];
    const float p0i = x0i * wr[j] - x0r * wi[j];
    const float p1r = x1r * wr[j] + x1i * wi[j];
    const float p1i = x1i * wr[j] - x1r * wi[j];
    acc[S::TXS + 4 * j + 0] += v[j] * p0r;
    acc[S::TXS + 4 * j + 1] += v[j] * p0i;
    acc[S::TXS + 4 * j + 2] += v[j] * p1r;
    acc[S::TXS + 4 * j + 3] += v[j] * p1i;
  }

#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < J; ++k) {
      const float vv = v[j] * v[k];
      const float re = wr[j] * wr[k] + wi[j] * wi[k];
      const float im = wi[j] * wr[k] - wr[j] * wi[k];
      acc[S::TSS + 2 * (j * J + k) + 0] += vv * re;
      acc[S::TSS + 2 * (j * J + k) + 1] += vv * im;
      if (k != j) {
        const float m = c.a0[j] * u0[k] + c.a1[j] * u1[k];
        acc[S::T7 + j * J + k] += vv * m;
      }
    }
  }
}

template <int J>
__global__ void __launch_bounds__(kThreads)
estep_r1_real_kernel(const float* __restrict__ x4, const float* __restrict__ v,
                     const float* __restrict__ A,
                     const float* __restrict__ sigma, float* __restrict__ xi,
                     float* __restrict__ txs, float* __restrict__ tss,
                     float* __restrict__ t4, float* __restrict__ t7,
                     float* __restrict__ ll, int F, int N, float eps,
                     bool fast, bool no_ll) {
  using S = Slots<J>;
  const int row = blockIdx.x;            // b * F + f
  const int b = row / F;
  const int f = row - b * F;
  const size_t FN = (size_t)F * N;

  RowConst<J> c;
  row_constants<J>(c, A + ((size_t)b * J * F + f) * 2, (size_t)F * 2,
                   sigma[row]);

  const float* xrow = x4 + (size_t)b * 4 * FN + (size_t)f * N;
  const float* vrow = v + (size_t)b * J * FN + (size_t)f * N;
  float* xirow = xi + (size_t)b * J * FN + (size_t)f * N;

  float acc[S::COUNT];
#pragma unroll
  for (int i = 0; i < S::COUNT; ++i) acc[i] = 0.f;

  for (int n = threadIdx.x; n < N; n += kThreads) {
    float vn[J], xin[J];
#pragma unroll
    for (int j = 0; j < J; ++j) vn[j] = vrow[j * FN + n];
    bin_update<J>(c, xrow[n], xrow[FN + n], xrow[2 * FN + n],
                  xrow[3 * FN + n], vn, eps, fast, no_ll, xin, acc);
#pragma unroll
    for (int j = 0; j < J; ++j) xirow[j * FN + n] = xin[j];
  }

  // Block reduction in a fixed order: shuffle tree within each warp, then
  // the warps' partials in warp order.
  __shared__ float red[kWarps][S::COUNT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < S::COUNT; ++i) {
    float s = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S::COUNT; i += kThreads) {
    float s = red[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][i];
    red[0][i] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const float* r = red[0];
  ll[row] = r[S::LL];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const size_t o = (((size_t)b * J + j) * F + f) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) txs[o + q] = r[S::TXS + 4 * j + q];
    t4[o + 0] = r[S::T4 + j];
    t4[o + 1] = 0.f;
    t4[o + 2] = 0.f;
    t4[o + 3] = 0.f;
#pragma unroll
    for (int k = 0; k < J; ++k) {
      const size_t p = ((((size_t)b * J + j) * J + k) * F + f) * 2;
      tss[p + 0] = r[S::TSS + 2 * (j * J + k) + 0];
      tss[p + 1] = r[S::TSS + 2 * (j * J + k) + 1];
      t7[p + 0] = (j == k) ? 0.f : r[S::T7 + j * J + k];
      t7[p + 1] = 0.f;
    }
  }
}

template <int J>
cudaError_t launch(const float* x4, const float* v, const float* A,
                   const float* sigma, float* xi, float* txs, float* tss,
                   float* t4, float* t7, float* ll, int B, int F, int N,
                   float eps, bool fast, bool no_ll, cudaStream_t stream) {
  estep_r1_real_kernel<J><<<B * F, kThreads, 0, stream>>>(
      x4, v, A, sigma, xi, txs, tss, t4, t7, ll, F, N, eps, fast, no_ll);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes (ops/cuda_estep.py). Launches on
// `stream`, does not synchronise, allocates nothing. Returns a cudaError_t:
// 0 when the launch was accepted.
extern "C" int pyfasst_estep_r1_real(const float* x4, const float* v,
                                     const float* A, const float* sigma,
                                     float* xi, float* txs, float* tss,
                                     float* t4, float* t7, float* ll, int B,
                                     int J, int F, int N, float eps,
                                     int fast_recip, int no_ll,
                                     void* stream) {
  if (B <= 0 || F <= 0 || N <= 0 || (long long)B * F > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fast = fast_recip != 0, nl = no_ll != 0;
  switch (J) {
    case 2:
      return (int)launch<2>(x4, v, A, sigma, xi, txs, tss, t4, t7, ll, B, F,
                            N, eps, fast, nl, s);
    case 3:
      return (int)launch<3>(x4, v, A, sigma, xi, txs, tss, t4, t7, ll, B, F,
                            N, eps, fast, nl, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
