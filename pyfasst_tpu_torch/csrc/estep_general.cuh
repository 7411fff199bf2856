// Fused GEM E-step for I = 2 channels, any ranks in {1, 2} per source,
// real or complex mixing, with or without 'ann_ns_inj' noise injection:
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pyfasst_tpu/ops/pallas_estep.py::_make_kernel
// (launched by pallas_estep, pallas_estep.py:379) in its variants
//   b  real_cov=False      complex (convolutive) mixing,
//   c  ranks (2, ...) and mixed ranks (1, 2, ...),
//   d  ns_inj=True         (pallas_estep.py:235-237, 252-255, 313-315,
//                           332-337),
// and their combinations, each with the flags of
//   e  fast_recip=True     the four reciprocals (:223, :268, :285, :295)
//                          through recip.cuh's approximate reciprocal and
//                          one Newton step,
//   f  no_ll=True          log det Sigma_x left out of the loglik (:239),
// which are runtime flags, uniform per launch (no divergence, no more
// instantiations). Variant a (ranks all 1, real mixing, no ns_inj) keeps
// its own kernel, estep.cu. Per (f, n) bin it computes what
// _make_kernel computes: the spatial invariants of the mixing columns
// (packed R_j, tr R_j, the Lagrange cross terms X_jk); the subtract-free
// det Sigma_x; y = Sigma_x^-1 x; w_jr = A_jr^H y and Sigma_x^-1 A_jr; the
// leave-one-out Woodbury posterior through S_j = sigma I + sum_{k!=j} v_k
// R_k (a scalar 1 / (1 + v M00) for rank 1, the closed-form inverse of
// G = I + v M with dG = max(g00 g11 - |g01|^2, 1) for rank 2); xi_j; and
// the frame-reduced Txs, Tss, T4, T7 and loglik, with the ns_inj
// corrections sigma Sigma_x^-1 A when asked.
//
// Design. As in estep.cu, one thread block owns one (b, f) row of the
// plane and its threads stride over the N frames (coalesced loads of x4
// and v, stores of xi; the loop bound masks the ragged edge). What differs
// is where the frame sums live. J = 4 rank 2 needs 225 of them (ll 1,
// Txs 32, Tss 80, T4 16, T7 96), past the 255-register limit before any
// temporary, so each thread keeps its partial sums in its own column of
// shared memory, acc[slot * kGenThreads + thread]: no two threads touch a
// word, consecutive threads hit consecutive banks, and 128 threads of
// J = 4 rank 2 hold 115 KB (dynamic shared memory, opted in above 48 KB).
// Only j <= k of Tss is summed: Tss_kj = Tss_jk^H holds bit for bit,
// since both are formed from the same products; T7 has no such exact
// symmetry and is summed for every j != k. The row's mixing columns and
// their invariants are computed once per block into shared memory. The
// block reduction sums each slot's 128 columns in a fixed order (four
// strided reads per lane, then a shuffle tree), so results are the same
// from run to run: no atomics.
//
// Numerics follow the Pallas forms term by term: the subtract-free dets of
// Sigma_x and of each S_j, the rank-2 dG clamp and coef = (g00 + g11)/dG,
// xi / rank, exact IEEE divides and logf; built with --fmad=false (see
// estep.cu) so that every product rounds as in the plain version. With
// real mixing (REAL) the imaginary parts of the mixing columns and of
// everything derived from them are zero; `if constexpr (REAL)` drops that
// arithmetic, as the Pallas symbolic-zero algebra does.
//
// What bounds it on an H100: per bin it reads x4 (16 B) and v (4 B per
// source) and writes xi (4 B per source), against ~500 (J = 3, rank 1) to
// ~2500 (J = 4, rank 2, ns_inj) flops and one shared-memory read-modify-
// write per frame sum; the rank-2 cases are bound by issue and by the
// occupancy that their shared memory allows (one block per SM for J = 4
// rank 2), not by device memory. Making it fast is later work.
//
// Layouts (float32, contiguous), with the clip axis B; Rmax = max rank:
//   x4    (B, 4, F, N)        [Re x0, Im x0, Re x1, Im x1]
//   v     (B, J, F, N)        source PSDs
//   A4    (B, J, F, 4 Rmax)   per column r: [Re A0r, Im A0r, Re A1r, Im A1r],
//                             zero past the source's rank
//   sigma (B, F)              annealed noise PSD
// Outputs (pallas_estep's packed layout; blocks indexed by the actual ranks
// and zero-padded):
//   xi    (B, J, F, N)            max(xi / rank, eps)
//   txs   (B, J, F, 4 Rmax)       column r: sum_n v_j [x0 w*, x1 w*] (re, im)
//   tss   (B, J, J, F, 2 Rmax^2)  (r Rk + s): sum_n v_j v_k w_jr w_ks*
//   t4    (B, J, F, 4)            rank 1: [sum v/(1 + v M00), 0, 0, 0];
//                                 rank 2: sum v G^-1 packed [00, 11, 01]
//   t7    (B, J, J, F, 2 Rmax^2)  sum_n v_j v_k A_jr^H Sigma_x^-1 A_ks;
//                                 0 on j == k
//   ll    (B, F)                  sum_n log det Sigma_x + tr(Sigma_x^-1 R_xx)
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "recip.cuh"

namespace pyfasst_general {

constexpr int kGenThreads = 128;
constexpr int kGenWarps = kGenThreads / 32;

struct cf {
  float re, im;
};

// conj(a) * y, written as the Pallas _cmul(_cconj(a), y) rounds it. With
// REAL, a is a real mixing-derived value (a.im == 0).
template <bool REAL>
__device__ __forceinline__ cf cmul_conj(cf a, cf y) {
  if constexpr (REAL) return cf{a.re * y.re, a.re * y.im};
  return cf{a.re * y.re + a.im * y.im, a.re * y.im - a.im * y.re};
}

__device__ __forceinline__ float cabs2(cf a) {
  return a.re * a.re + a.im * a.im;
}

// Sigma^-1 (u0, u1) through the adjugate [d, -b; -conj(b), a] of a packed
// 2x2 Hermitian [a, d, b] whose reciprocal det is rinv.
template <bool REAL>
__device__ __forceinline__ void herm_apply(float a, float d, cf b, float rinv,
                                           cf u0, cf u1, cf& y0, cf& y1) {
  cf bu1, cbu0;  // b u1 and conj(b) u0
  if constexpr (REAL) {
    bu1 = cf{b.re * u1.re, b.re * u1.im};
    cbu0 = cf{b.re * u0.re, b.re * u0.im};
  } else {
    bu1 = cf{b.re * u1.re - b.im * u1.im, b.re * u1.im + b.im * u1.re};
    cbu0 = cf{b.re * u0.re + b.im * u0.im, b.re * u0.im - b.im * u0.re};
  }
  y0 = cf{rinv * (d * u0.re - bu1.re), rinv * (d * u0.im - bu1.im)};
  y1 = cf{rinv * (a * u1.re - cbu0.re), rinv * (a * u1.im - cbu0.im)};
}

// Accumulator slots of one (b, f) row.
template <int J, int R>
struct Slots {
  static constexpr int PAIRS = J * (J + 1) / 2;   // Tss, j <= k
  static constexpr int OFFD = J * (J - 1);        // T7, j != k
  static constexpr int NT4 = (R == 1) ? 1 : 4;
  static constexpr int LL = 0;
  static constexpr int TXS = 1;                       // (j, r): 4 each
  static constexpr int T4 = TXS + J * R * 4;          // j: NT4 each
  static constexpr int TSS = T4 + J * NT4;            // (pair, r, s): 2 each
  static constexpr int T7 = TSS + PAIRS * R * R * 2;  // (j != k, r, s): 2 each
  static constexpr int COUNT = T7 + OFFD * R * R * 2;
  __device__ static constexpr int pair(int j, int k) {  // j <= k
    return j * J - j * (j - 1) / 2 + (k - j);
  }
  __device__ static constexpr int offd(int j, int k) {  // j != k
    return j * (J - 1) + (k < j ? k : k - 1);
  }
};

// Per-row spatial invariants, derived from the mixing columns.
template <int J, int R>
struct Row {
  cf A[J][R][2];  // A_j[:, r] = (A0, A1)
  float Ra[J], Rd[J], trR[J];
  cf Rb[J];
  float Xc[J][J];
  float sig;
};

template <int J, int R, bool REAL>
__device__ __forceinline__ void row_constants(Row<J, R>& c,
                                              const float* __restrict__ A4,
                                              size_t a_stride,
                                              const int (&rk)[J], float sig) {
  for (int j = 0; j < J; ++j) {
    for (int r = 0; r < R; ++r) {
      const float* a = A4 + j * a_stride + 4 * r;
      c.A[j][r][0] = cf{a[0], REAL ? 0.f : a[1]};
      c.A[j][r][1] = cf{a[2], REAL ? 0.f : a[3]};
    }
  }
  for (int j = 0; j < J; ++j) {
    float ra = 0.f, rd = 0.f;
    cf rb{0.f, 0.f};
    for (int r = 0; r < rk[j]; ++r) {
      const cf a0 = c.A[j][r][0], a1 = c.A[j][r][1];
      ra += cabs2(a0);
      rd += cabs2(a1);
      // a0 conj(a1)
      rb.re += a0.re * a1.re + a0.im * a1.im;
      rb.im += a0.im * a1.re - a0.re * a1.im;
    }
    c.Ra[j] = ra;
    c.Rd[j] = rd;
    c.Rb[j] = rb;
    c.trR[j] = ra + rd;
  }
  for (int j = 0; j < J; ++j) {
    for (int k = 0; k < J; ++k) {
      float x = 0.f;
      for (int r = 0; r < rk[j]; ++r) {
        for (int s = 0; s < rk[k]; ++s) {
          const cf p = c.A[j][r][0], q = c.A[k][s][1];
          const cf u = c.A[j][r][1], w = c.A[k][s][0];
          // A_j[0,r] A_k[1,s] - A_j[1,r] A_k[0,s]
          const cf t{
              (p.re * q.re - p.im * q.im) - (u.re * w.re - u.im * w.im),
              (p.re * q.im + p.im * q.re) - (u.re * w.im + u.im * w.re)};
          x += cabs2(t);
        }
      }
      c.Xc[j][k] = x;
    }
  }
  c.sig = sig;
}

struct Args {
  const float* x4;
  const float* v;
  const float* A4;
  const float* sigma;
  float* xi;
  float* txs;
  float* tss;
  float* t4;
  float* t7;
  float* ll;
  int F, N, rank_mask;
  float eps;
  bool fast_recip, no_ll;
};

template <int J, int R, bool REAL, bool NS>
__global__ void __launch_bounds__(kGenThreads) estep_general_kernel(Args g) {
  using S = Slots<J, R>;
  extern __shared__ float acc_sm[];  // S::COUNT x kGenThreads
  __shared__ Row<J, R> c;
  __shared__ float red[S::COUNT];

  const int F = g.F, N = g.N;
  const int row = blockIdx.x;  // b * F + f
  const int b = row / F;
  const int f = row - b * F;
  const size_t FN = (size_t)F * N;
  const int tid = threadIdx.x;

  int rk[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    rk[j] = (R == 2 && ((g.rank_mask >> j) & 1)) ? 2 : 1;

  if (tid == 0)
    row_constants<J, R, REAL>(c, g.A4 + ((size_t)b * J * F + f) * 4 * R,
                              (size_t)F * 4 * R, rk, g.sigma[row]);
  float* acc = acc_sm + tid;
  for (int s = 0; s < S::COUNT; ++s) acc[s * kGenThreads] = 0.f;
  __syncthreads();

  const float* xrow = g.x4 + (size_t)b * 4 * FN + (size_t)f * N;
  const float* vrow = g.v + (size_t)b * J * FN + (size_t)f * N;
  float* xirow = g.xi + (size_t)b * J * FN + (size_t)f * N;
  const float sig = c.sig;
  const float eps = g.eps;
  const bool fast = g.fast_recip;

  for (int n = tid; n < N; n += kGenThreads) {
    const cf x0{xrow[n], xrow[FN + n]};
    const cf x1{xrow[2 * FN + n], xrow[3 * FN + n]};
    float v[J];
#pragma unroll
    for (int j = 0; j < J; ++j) v[j] = vrow[j * FN + n];

    // Sigma_x = sig I + sum_j v_j R_j and its subtract-free determinant
    float sa = 0.f, sd = 0.f, lin = 0.f, quad = 0.f;
    cf sb{0.f, 0.f};
#pragma unroll
    for (int j = 0; j < J; ++j) {
      sa += v[j] * c.Ra[j];
      sd += v[j] * c.Rd[j];
      sb.re += v[j] * c.Rb[j].re;
      if constexpr (!REAL) sb.im += v[j] * c.Rb[j].im;
      lin += v[j] * c.trR[j];
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int k = 0; k < J; ++k) quad += v[j] * v[k] * c.Xc[j][k];
    }
    const float a = sig + sa;
    const float d = sig + sd;
    const float det = sig * sig + sig * lin + 0.5f * quad;
    const float rinv = pyfasst::recip(det, fast);

    cf y0, y1;
    herm_apply<REAL>(a, d, sb, rinv, x0, x1, y0, y1);
    float tr = fmaxf((x0.re * y0.re + x0.im * y0.im)
                     + (x1.re * y1.re + x1.im * y1.im), 0.0f);
    if constexpr (NS) tr = tr + sig * (a + d) * rinv;
    acc[S::LL * kGenThreads] += g.no_ll ? tr : logf(det) + tr;

    // w_jr = A_jr^H y and z_jr = Sigma_x^-1 A_jr
    cf w[J][R], z[J][R][2];
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rk[j]) continue;
        const cf p = cmul_conj<REAL>(c.A[j][r][0], y0);
        const cf q = cmul_conj<REAL>(c.A[j][r][1], y1);
        w[j][r] = cf{p.re + q.re, p.im + q.im};
        herm_apply<REAL>(a, d, sb, rinv, c.A[j][r][0], c.A[j][r][1],
                         z[j][r][0], z[j][r][1]);
      }
    }

#pragma unroll
    for (int j = 0; j < J; ++j) {
      float trCR = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rk[j]) trCR += cabs2(w[j][r]);
      if constexpr (NS) {
        float zz = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < rk[j]) zz += cabs2(z[j][r][0]) + cabs2(z[j][r][1]);
        trCR = trCR + sig * zz;
      }

      // leave-one-out S_j = sig I + sum_{k != j} v_k R_k, subtract-free det
      float la = 0.f, ld = 0.f, llin = 0.f, lquad = 0.f;
      cf lb{0.f, 0.f};
#pragma unroll
      for (int k = 0; k < J; ++k) {
        if (k == j) continue;
        la += v[k] * c.Ra[k];
        ld += v[k] * c.Rd[k];
        lb.re += v[k] * c.Rb[k].re;
        if constexpr (!REAL) lb.im += v[k] * c.Rb[k].im;
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

      // M_rs = A_jr^H S_j^-1 A_js
      cf sj[R][2];
#pragma unroll
      for (int s = 0; s < R; ++s)
        if (s < rk[j])
          herm_apply<REAL>(aS, dS, lb, rinvS, c.A[j][s][0], c.A[j][s][1],
                           sj[s][0], sj[s][1]);
      auto M = [&](int r, int s) {
        const cf p = cmul_conj<REAL>(c.A[j][r][0], sj[s][0]);
        const cf q = cmul_conj<REAL>(c.A[j][r][1], sj[s][1]);
        return cf{p.re + q.re, p.im + q.im};
      };

      const float vj = v[j];
      float coef;
      if (R == 1 || rk[j] == 1) {
        const float den = 1.0f + vj * M(0, 0).re;
        coef = pyfasst::recip(den, fast);
        acc[(S::T4 + j * S::NT4) * kGenThreads] += vj / den;
      } else {
        const cf m01 = M(0, 1);
        const float g00 = 1.0f + vj * M(0, 0).re;
        const float g11 = 1.0f + vj * M(1, 1).re;
        const cf g01{vj * m01.re, REAL ? 0.f : vj * m01.im};
        float gg = g01.re * g01.re;
        if constexpr (!REAL) gg += g01.im * g01.im;
        const float dG = fmaxf(g00 * g11 - gg, 1.0f);
        const float rG = pyfasst::recip(dG, fast);
        coef = (g00 + g11) * rG;
        float* t4a = acc + (S::T4 + j * S::NT4) * kGenThreads;
        t4a[0] += vj * g11 * rG;
        t4a[kGenThreads] += vj * g00 * rG;
        t4a[2 * kGenThreads] += -vj * g01.re * rG;
        if constexpr (!REAL) t4a[3 * kGenThreads] += -vj * g01.im * rG;
      }
      xirow[j * FN + n] =
          fmaxf((vj * vj * trCR + vj * coef) / (float)rk[j], eps);

      // Txs_j: per column r, v_j [x0 conj(w_jr), x1 conj(w_jr)]
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rk[j]) continue;
        const cf wr = w[j][r];
        cf p0{x0.re * wr.re + x0.im * wr.im, x0.im * wr.re - x0.re * wr.im};
        cf p1{x1.re * wr.re + x1.im * wr.im, x1.im * wr.re - x1.re * wr.im};
        if constexpr (NS) {
          p0 = cf{p0.re + sig * z[j][r][0].re, p0.im + sig * z[j][r][0].im};
          p1 = cf{p1.re + sig * z[j][r][1].re, p1.im + sig * z[j][r][1].im};
        }
        float* t = acc + (S::TXS + (j * R + r) * 4) * kGenThreads;
        t[0] += vj * p0.re;
        t[kGenThreads] += vj * p0.im;
        t[2 * kGenThreads] += vj * p1.re;
        t[3 * kGenThreads] += vj * p1.im;
      }
    }

    // Tss (j <= k) and T7 (j != k)
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int k = 0; k < J; ++k) {
        const float vv = v[j] * v[k];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int s = 0; s < R; ++s) {
            if (r >= rk[j] || s >= rk[k]) continue;
            if (j <= k) {
              const cf wj = w[j][r], wk = w[k][s];
              cf pr{wj.re * wk.re + wj.im * wk.im,
                    wj.im * wk.re - wj.re * wk.im};
              if constexpr (NS) {
                const cf a0 = z[j][r][0], b0 = z[k][s][0];
                const cf a1 = z[j][r][1], b1 = z[k][s][1];
                const cf zc{(a0.re * b0.re + a0.im * b0.im)
                                + (a1.re * b1.re + a1.im * b1.im),
                            (a0.re * b0.im - a0.im * b0.re)
                                + (a1.re * b1.im - a1.im * b1.re)};
                pr = cf{pr.re + sig * zc.re, pr.im + sig * zc.im};
              }
              const int slot =
                  S::TSS + (S::pair(j, k) * R * R + r * R + s) * 2;
              float* t = acc + slot * kGenThreads;
              t[0] += vv * pr.re;
              t[kGenThreads] += vv * pr.im;
            }
            if (j != k) {
              const cf p = cmul_conj<REAL>(c.A[j][r][0], z[k][s][0]);
              const cf q = cmul_conj<REAL>(c.A[j][r][1], z[k][s][1]);
              const int slot =
                  S::T7 + (S::offd(j, k) * R * R + r * R + s) * 2;
              float* t = acc + slot * kGenThreads;
              t[0] += vv * (p.re + q.re);
              if constexpr (!REAL) t[kGenThreads] += vv * (p.im + q.im);
            }
          }
        }
      }
    }
  }

  // Block reduction in a fixed order: each slot's columns summed by one
  // warp (four strided reads per lane, then a shuffle tree).
  __syncthreads();
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int s = warp; s < S::COUNT; s += kGenWarps) {
    const float* col = acc_sm + s * kGenThreads;
    float t = col[lane];
#pragma unroll
    for (int i = 1; i < kGenThreads / 32; ++i) t += col[lane + 32 * i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_down_sync(0xffffffffu, t, off);
    if (lane == 0) red[s] = t;
  }
  __syncthreads();

  // Write the packed outputs, zero-padded past each source's rank.
  if (tid == 0) g.ll[row] = red[S::LL];
  if (tid < J) {
    const int j = tid;
    const size_t o = (((size_t)b * J + j) * F + f);
    float* tx = g.txs + o * 4 * R;
    for (int r = 0; r < R; ++r)
      for (int q = 0; q < 4; ++q)
        tx[4 * r + q] = (r < rk[j]) ? red[S::TXS + (j * R + r) * 4 + q] : 0.f;
    float* t4o = g.t4 + o * 4;
    for (int q = 0; q < 4; ++q)
      t4o[q] = (rk[j] == 1) ? (q == 0 ? red[S::T4 + j * S::NT4] : 0.f)
                            : red[S::T4 + j * S::NT4 + q];
  }
  if (tid >= 32 && tid < 32 + J * J) {
    const int j = (tid - 32) / J, k = (tid - 32) - j * J;
    const size_t o = ((((size_t)b * J + j) * J + k) * F + f) * 2 * R * R;
    float* ts = g.tss + o;
    float* t7o = g.t7 + o;
    for (int i = 0; i < 2 * R * R; ++i) {
      ts[i] = 0.f;
      t7o[i] = 0.f;
    }
    for (int r = 0; r < rk[j]; ++r) {
      for (int s = 0; s < rk[k]; ++s) {
        const int i = 2 * (r * rk[k] + s);
        if (j <= k) {
          const int p = S::TSS + (S::pair(j, k) * R * R + r * R + s) * 2;
          ts[i] = red[p];
          ts[i + 1] = red[p + 1];
        } else {  // Tss_jk = Tss_kj^H
          const int p = S::TSS + (S::pair(k, j) * R * R + s * R + r) * 2;
          ts[i] = red[p];
          ts[i + 1] = -red[p + 1];
        }
        if (j != k) {
          const int p = S::T7 + (S::offd(j, k) * R * R + r * R + s) * 2;
          t7o[i] = red[p];
          t7o[i + 1] = REAL ? 0.f : red[p + 1];
        }
      }
    }
  }
}

template <int J, int R, bool REAL, bool NS>
cudaError_t launch(const Args& g, int B, cudaStream_t stream) {
  constexpr size_t smem =
      (size_t)Slots<J, R>::COUNT * kGenThreads * sizeof(float);
  auto kernel = estep_general_kernel<J, R, REAL, NS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B * g.F, kGenThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

template <int J>
int entry(const float* x4, const float* v, const float* A4,
          const float* sigma, float* xi, float* txs, float* tss, float* t4,
          float* t7, float* ll, int B, int F, int N, int rank_mask,
          int rmax, int real_cov, int ns_inj, float eps, int fast_recip,
          int no_ll, void* stream) {
  if (B <= 0 || F <= 0 || N <= 0 || (long long)B * F > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Args g{x4, v, A4, sigma, xi, txs, tss, t4, t7, ll, F, N, rank_mask,
               eps, fast_recip != 0, no_ll != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool re = real_cov != 0, ns = ns_inj != 0;
  if (rmax == 1) {
    if (re) return (int)(ns ? launch<J, 1, true, true>(g, B, s)
                            : launch<J, 1, true, false>(g, B, s));
    return (int)(ns ? launch<J, 1, false, true>(g, B, s)
                    : launch<J, 1, false, false>(g, B, s));
  }
  if (rmax == 2) {
    if (re) return (int)(ns ? launch<J, 2, true, true>(g, B, s)
                            : launch<J, 2, true, false>(g, B, s));
    return (int)(ns ? launch<J, 2, false, true>(g, B, s)
                    : launch<J, 2, false, false>(g, B, s));
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace pyfasst_general

// C entry point for J sources, bound with ctypes (ops/cuda_estep.py).
// Launches on `stream`, does not synchronise, allocates nothing. Returns a
// cudaError_t: 0 when the launch was accepted.
#define PYFASST_ESTEP_GENERAL_ENTRY(J)                                        \
  extern "C" int pyfasst_estep_j##J(                                          \
      const float* x4, const float* v, const float* A4, const float* sigma,   \
      float* xi, float* txs, float* tss, float* t4, float* t7, float* ll,     \
      int B, int F, int N, int rank_mask, int rmax, int real_cov, int ns_inj, \
      float eps, int fast_recip, int no_ll, void* stream) {                   \
    return pyfasst_general::entry<J>(x4, v, A4, sigma, xi, txs, tss, t4, t7,  \
                                     ll, B, F, N, rank_mask, rmax, real_cov,  \
                                     ns_inj, eps, fast_recip, no_ll, stream); \
  }
