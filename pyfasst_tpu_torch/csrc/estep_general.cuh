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
// Design. One block of four warps owns one (b, f) row of the plane; its
// warps take the row's tiles of 32 frames in turn (warp w: tiles w, w + 4,
// ...), lane = frame: each lane loads its frame's x4 and v (coalesced),
// computes Sigma_x, y, w_jr, z_jr = Sigma_x^-1 A_jr, the leave-one-out
// posterior and xi (stored), and forms its frame's terms of the row's frame
// sums by the formulas of the Pallas kernel. Where the sums live depends on
// how many there are (Slots::COUNT, Plan::REG):
//   - up to kRegSums = 40 (J <= 3 at rank 1): in registers, each lane its
//     own running sums over its frames, and the next tile's x4 and v are
//     loaded while this one is computed. At the end of the row the lanes'
//     sums go through the warp's tile (below) once, lanes in order.
//   - more (J = 4 at rank 2, and every J >= 5: 224 sums at J = 4 rank 2,
//     T4 16, Txs 32, Tss 80, T7 96; 832 at J = 8 rank 2, T4 32, Txs 64,
//     Tss 288, T7 448): through the warp's tile in shared memory, 32 sums at
//     a time. w_jr and z_jr go into a per-warp buffer (feature-major, lane
//     = frame) as phase 1 forms them; then, chunk by chunk, each lane forms
//     its frame's products for the chunk's 32 sums from the buffer and
//     stores them in tile[sum][frame] (row stride 33 words: conflict-free
//     both ways), and lane = sum adds its row of the tile, frames in order,
//     to a register. The T4 terms go straight into the first chunk's rows.
// So each frame sum lives in registers (one per lane per chunk in the
// tiled case: 7 at J = 4 rank 2, 26 at J = 8 rank 2), and shared memory
// sees one store and one load per product, with no read-modify-write. A
// block holds 17 KB of tiles, static, and 3 KB of buffer per source and
// rank, dynamic (up to 48 KB at J = 8 rank 2; the runtime is asked once
// per instantiation for what passes its 48 KB default);
// __launch_bounds__(128, 4) holds a thread to 128 registers, so up to four
// blocks (16 warps) fit on an SM, with 16 B of spill at J = 4 rank 2; at
// J >= 7 rank 2 shared memory holds an SM to three blocks, and
// __launch_bounds__(128, 3) lets a thread have 168 registers
// (chip_smoke.py phase 1 prints each instantiation's resident warps,
// registers, local and shared bytes). J runs from 2 to 8: the T4 sums of
// every source lie in the first chunk of 32 (J * 4 at rank 2). The
// loglik's per-lane sums end in a shuffle tree. At the end of the row the
// four warps' sums are added in warp order through shared memory: a fixed
// order, no atomics, the same results from run to run. The row's mixing
// columns and their invariants are computed once per block into shared
// memory, spread over the threads (one (source, column, channel) entry per
// thread, then one R_j or X_jk per thread). Ragged edges: a lane past N
// loads nothing (a select gives 0) and stores no xi; its loglik term and,
// in registers, its sums' terms are selected to 0, and a tile's sums stop
// at its last frame. Only j <= k of Tss is summed: Tss_kj = Tss_jk^H holds
// bit for bit, since both are formed from the same products; T7 has no
// such exact symmetry and is summed for every j != k.
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
// source) and writes xi (4 B per source), against ~800 (J = 3, rank 1) to
// ~4,400 (J = 4, rank 2, ns_inj) float32 operations counted in its plain
// version, so the rank-2 cases are bound by operations, and with
// --fmad=false each multiply and add issues on its own: half the card's
// FMA rate is open to them. On top of those come the exact divides, logf,
// the selects and the shared-memory traffic of the sums, so the kernel is
// bound by instruction issue; at J = 4 rank 2 it runs at about twice the
// time that the operations alone would take at that half rate (PERF.md).
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

constexpr int kGenWarps = 4;
constexpr int kGenThreads = 32 * kGenWarps;
constexpr int kRegSums = 40;      // at most this many sums: in registers
constexpr int kTile = 32;         // frames per warp tile, sums per chunk
constexpr int kTileStride = kTile + 1;

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

// Frame sums of one (b, f) row (the loglik is summed apart, per lane).
template <int J, int R>
struct Slots {
  static constexpr int PAIRS = J * (J + 1) / 2;   // Tss, j <= k
  static constexpr int OFFD = J * (J - 1);        // T7, j != k
  static constexpr int NT4 = (R == 1) ? 1 : 4;
  static constexpr int T4 = 0;                        // j: NT4 each
  static constexpr int TXS = T4 + J * NT4;            // (j, r): 4 each
  static constexpr int TSS = TXS + J * R * 4;         // (pair, r, s): 2 each
  static constexpr int T7 = TSS + PAIRS * R * R * 2;  // (j != k, r, s): 2 each
  static constexpr int COUNT = T7 + OFFD * R * R * 2;
  static constexpr int LL = COUNT;                    // in the block's sums
  static constexpr int CHUNKS = (COUNT + kTile - 1) / kTile;
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

// The row's invariants, spread over the block: one (j, r, channel) entry
// of the mixing columns per thread, then one R_j or one X_jk per thread.
// Ends with the block synchronised.
template <int J, int R, bool REAL>
__device__ __forceinline__ void row_constants(Row<J, R>& c,
                                              const float* __restrict__ A4,
                                              size_t a_stride,
                                              const int (&rk)[J], float sig,
                                              int tid) {
  if (tid < J * R * 2) {
    const int j = tid / (2 * R), r = (tid / 2) % R, ch = tid % 2;
    const float* a = A4 + j * a_stride + 4 * r + 2 * ch;
    c.A[j][r][ch] = cf{a[0], REAL ? 0.f : a[1]};
  }
  if (tid == 0) c.sig = sig;
  __syncthreads();
  if (tid < J) {
    const int j = tid;
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
  } else if (tid < J + J * J) {
    const int j = (tid - J) / J, k = (tid - J) % J;
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
  __syncthreads();
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

// How a row's frame sums are kept (see the head of this file).
template <int J, int R>
struct Plan {
  using S = Slots<J, R>;
  // each lane keeps all of the row's sums for its frames in registers
  static constexpr bool REG = S::COUNT <= kRegSums;
  // otherwise w_jr and z_jr go through a per-warp buffer, feature-major
  static constexpr int NF = REG ? 1 : 6 * J * R;
  static constexpr int W = 0;          // w_jr: 2 words at 2 (j R + r)
  static constexpr int Z = 2 * J * R;  // z_jr: 4 words at Z + 4 (j R + r)
};

// Resident blocks per SM asked of ptxas: four (at most 128 registers a
// thread), or three where the block's shared memory (tiles and w/z
// buffers, past 56 KB: J >= 7 at rank 2) already holds the SM to three,
// which leaves a thread 168 registers instead of spilling.
template <int J, int R>
constexpr int kGenMinBlocks =
    kGenWarps * (Plan<J, R>::NF * kTile + kTile * kTileStride) * 4 >
            56 * 1024
        ? 3
        : 4;

template <int J, int R, bool REAL, bool NS>
__global__ void __launch_bounds__(kGenThreads, kGenMinBlocks<J, R>)
    estep_general_kernel(Args g) {
  using S = Slots<J, R>;
  using P = Plan<J, R>;
  __shared__ Row<J, R> c;
  // the warps' tiles; at the end of the row, the warps' sums
  __shared__ float tiles[kGenWarps][kTile * kTileStride];
  // the warps' w/z buffers, [kGenWarps][P::NF * kTile] (dynamic: 48 KB at
  // J = 8 rank 2, beside the tiles, past the 48 KB of static memory)
  extern __shared__ __align__(16) float feats[];
  static_assert(kGenWarps * (S::COUNT + 1) <= kGenWarps * kTile * kTileStride,
                "the block's sums must fit in the tiles");
  static_assert(J * S::NT4 <= kTile, "T4 must lie in the first chunk");
  static_assert(J * R * 2 <= kGenThreads && J + J * J <= kGenThreads &&
                    32 + J * J <= kGenThreads,
                "one thread per mixing entry, invariant and output block");

  const int F = g.F, N = g.N;
  const int row = blockIdx.x;  // b * F + f
  const int b = row / F;
  const int f = row - b * F;
  const size_t FN = (size_t)F * N;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int rk[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    rk[j] = (R == 2 && ((g.rank_mask >> j) & 1)) ? 2 : 1;

  row_constants<J, R, REAL>(c, g.A4 + ((size_t)b * J * F + f) * 4 * R,
                            (size_t)F * 4 * R, rk, g.sigma[row], tid);

  const float* xrow = g.x4 + (size_t)b * 4 * FN + (size_t)f * N;
  const float* vrow = g.v + (size_t)b * J * FN + (size_t)f * N;
  float* xirow = g.xi + (size_t)b * J * FN + (size_t)f * N;
  float* tile = tiles[warp];
  float* feat = feats + warp * P::NF * kTile;
  const float sig = c.sig;
  const float eps = g.eps;
  const bool fast = g.fast_recip;

  // Moves 32 sums at a time from the lanes into registers of lane = sum:
  // emit(in_chunk, put) puts each sum's value of this lane's frame into
  // the tile; then each lane adds the first `count` frames of its row of
  // the tile, in order, to acc[chunk].
  float acc[S::CHUNKS];
#pragma unroll
  for (int ch = 0; ch < S::CHUNKS; ++ch) acc[ch] = 0.f;
  auto flush = [&](auto&& emit, int count) {
#pragma unroll
    for (int ch = 0; ch < S::CHUNKS; ++ch) {
      const int lo = ch * kTile;
      emit([&](int slot, int n) { return slot < lo + kTile && slot + n > lo; },
           [&](int slot, float val) {
             if (slot >= lo && slot < lo + kTile)
               tile[(slot - lo) * kTileStride + lane] = val;
           });
      __syncwarp();
      if (ch + 1 < S::CHUNKS || lane < S::COUNT - lo) {
        const float* col = tile + lane * kTileStride;
        float t = acc[ch];
#pragma unroll 8
        for (int m = 0; m < count; ++m) t += col[m];
        acc[ch] = t;
      }
      __syncwarp();
    }
  };

  float racc[P::REG ? S::COUNT : 1];  // REG: lane = frame, its frame sums
#pragma unroll
  for (int s = 0; s < (P::REG ? S::COUNT : 1); ++s) racc[s] = 0.f;
  float ll_acc = 0.f;                 // lane = frame: its loglik terms

  // REG: the next tile's x4 and v are loaded while this one is computed
  float px[4], pv[J];
  if constexpr (P::REG) {
    const int n = warp * kTile + lane;
    const bool valid = n < N;
#pragma unroll
    for (int q = 0; q < 4; ++q) px[q] = valid ? xrow[q * FN + n] : 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) pv[j] = valid ? vrow[j * FN + n] : 0.f;
  }

  for (int n0 = warp * kTile; n0 < N; n0 += kGenThreads) {
    const int n = n0 + lane;
    const bool valid = n < N;

    // -- phase 1, lane = frame ------------------------------------------------
    cf x0, x1;
    float v[J];
    if constexpr (P::REG) {
      x0 = cf{px[0], px[1]};
      x1 = cf{px[2], px[3]};
#pragma unroll
      for (int j = 0; j < J; ++j) v[j] = pv[j];
      const int nn = n + kGenThreads;
      const bool vn = nn < N;
#pragma unroll
      for (int q = 0; q < 4; ++q) px[q] = vn ? xrow[q * FN + nn] : 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) pv[j] = vn ? vrow[j * FN + nn] : 0.f;
    } else {
      x0 = cf{valid ? xrow[n] : 0.f, valid ? xrow[FN + n] : 0.f};
      x1 = cf{valid ? xrow[2 * FN + n] : 0.f, valid ? xrow[3 * FN + n] : 0.f};
#pragma unroll
      for (int j = 0; j < J; ++j) v[j] = valid ? vrow[j * FN + n] : 0.f;
    }

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
    const float llt = g.no_ll ? tr : logf(det) + tr;
    ll_acc += valid ? llt : 0.f;

    // per source: w_jr = A_jr^H y and z_jr = Sigma_x^-1 A_jr (zero past the
    // rank), kept for phase 2 in registers (REG) or in the warp's buffer
    cf w[P::REG ? J : 1][R], z[P::REG ? J : 1][R][2];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      cf wj[R], zj[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        wj[r] = cf{0.f, 0.f};
        zj[r][0] = zj[r][1] = cf{0.f, 0.f};
        if (r < rk[j]) {
          const cf p = cmul_conj<REAL>(c.A[j][r][0], y0);
          const cf q = cmul_conj<REAL>(c.A[j][r][1], y1);
          wj[r] = cf{p.re + q.re, p.im + q.im};
          herm_apply<REAL>(a, d, sb, rinv, c.A[j][r][0], c.A[j][r][1],
                           zj[r][0], zj[r][1]);
        }
        if constexpr (P::REG) {
          w[j][r] = wj[r];
          z[j][r][0] = zj[r][0];
          z[j][r][1] = zj[r][1];
        } else {
          float* fw = feat + (P::W + 2 * (j * R + r)) * kTile + lane;
          fw[0] = wj[r].re;
          fw[kTile] = wj[r].im;
          float* fz = feat + (P::Z + 4 * (j * R + r)) * kTile + lane;
          fz[0] = zj[r][0].re;
          fz[kTile] = zj[r][0].im;
          fz[2 * kTile] = zj[r][1].re;
          fz[3 * kTile] = zj[r][1].im;
        }
      }

      float trCR = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rk[j]) trCR += cabs2(wj[r]);
      if constexpr (NS) {
        float zz = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < rk[j]) zz += cabs2(zj[r][0]) + cabs2(zj[r][1]);
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

      // the T4 terms: 1 / den for rank 1, v G^-1 for rank 2
      const float vj = v[j];
      float coef = 0.f;
      float t4[S::NT4];
      bool rank1 = true;
      if constexpr (R == 2) rank1 = rk[j] == 1;
      if (rank1) {
        const float den = 1.0f + vj * M(0, 0).re;
        coef = pyfasst::recip(den, fast);
        t4[0] = vj / den;
#pragma unroll
        for (int q = 1; q < S::NT4; ++q) t4[q] = 0.f;
      } else if constexpr (R == 2) {
        const cf m01 = M(0, 1);
        const float g00 = 1.0f + vj * M(0, 0).re;
        const float g11 = 1.0f + vj * M(1, 1).re;
        const cf g01{vj * m01.re, REAL ? 0.f : vj * m01.im};
        float gg = g01.re * g01.re;
        if constexpr (!REAL) gg += g01.im * g01.im;
        const float dG = fmaxf(g00 * g11 - gg, 1.0f);
        const float rG = pyfasst::recip(dG, fast);
        coef = (g00 + g11) * rG;
        t4[0] = vj * g11 * rG;
        t4[1] = vj * g00 * rG;
        t4[2] = -vj * g01.re * rG;
        t4[3] = REAL ? 0.f : -vj * g01.im * rG;
      }
#pragma unroll
      for (int q = 0; q < S::NT4; ++q) {
        const int slot = S::T4 + j * S::NT4 + q;
        if constexpr (P::REG)
          racc[slot] += valid ? t4[q] : 0.f;
        else  // the first chunk's rows of the tile
          tile[slot * kTileStride + lane] = t4[q];
      }
      if (valid)
        xirow[j * FN + n] =
            fmaxf((vj * vj * trCR + vj * coef) / (float)rk[j], eps);
    }

    // -- phase 2: the products of the frame sums ------------------------------
    // W(j, r), Z(j, r, channel): this frame's w_jr and z_jr
    auto W = [&](int j, int r) -> cf {
      if constexpr (P::REG) return w[j][r];
      const float* p = feat + (P::W + 2 * (j * R + r)) * kTile + lane;
      return cf{p[0], p[kTile]};
    };
    auto Z = [&](int j, int r, int ch) -> cf {
      if constexpr (P::REG) return z[j][r][ch];
      const float* p = feat + (P::Z + 4 * (j * R + r) + 2 * ch) * kTile + lane;
      return cf{p[0], p[kTile]};
    };
    auto emit = [&](auto&& in_chunk, auto&& put) {
      // Txs_j: per column r, v_j [x0 conj(w_jr), x1 conj(w_jr)]
#pragma unroll
      for (int j = 0; j < J; ++j) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int slot = S::TXS + (j * R + r) * 4;
          if (!in_chunk(slot, 4)) continue;
          const bool on = r < rk[j];
          const cf wr = W(j, r);
          cf p0{x0.re * wr.re + x0.im * wr.im, x0.im * wr.re - x0.re * wr.im};
          cf p1{x1.re * wr.re + x1.im * wr.im, x1.im * wr.re - x1.re * wr.im};
          if constexpr (NS) {
            const cf z0 = Z(j, r, 0), z1 = Z(j, r, 1);
            p0 = cf{p0.re + sig * z0.re, p0.im + sig * z0.im};
            p1 = cf{p1.re + sig * z1.re, p1.im + sig * z1.im};
          }
          const float vj = v[j];
          put(slot, on ? vj * p0.re : 0.f);
          put(slot + 1, on ? vj * p0.im : 0.f);
          put(slot + 2, on ? vj * p1.re : 0.f);
          put(slot + 3, on ? vj * p1.im : 0.f);
        }
      }
      // Tss (j <= k) and T7 (j != k)
#pragma unroll
      for (int j = 0; j < J; ++j) {
#pragma unroll
        for (int k = 0; k < J; ++k) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int s = 0; s < R; ++s) {
              const bool on = r < rk[j] && s < rk[k];
              if (j <= k) {
                const int slot =
                    S::TSS + (S::pair(j, k) * R * R + r * R + s) * 2;
                if (in_chunk(slot, 2)) {
                  const float vv = v[j] * v[k];
                  const cf wj = W(j, r), wk = W(k, s);
                  cf pr{wj.re * wk.re + wj.im * wk.im,
                        wj.im * wk.re - wj.re * wk.im};
                  if constexpr (NS) {
                    const cf a0 = Z(j, r, 0), b0 = Z(k, s, 0);
                    const cf a1 = Z(j, r, 1), b1 = Z(k, s, 1);
                    const cf zc{(a0.re * b0.re + a0.im * b0.im)
                                    + (a1.re * b1.re + a1.im * b1.im),
                                (a0.re * b0.im - a0.im * b0.re)
                                    + (a1.re * b1.im - a1.im * b1.re)};
                    pr = cf{pr.re + sig * zc.re, pr.im + sig * zc.im};
                  }
                  put(slot, on ? vv * pr.re : 0.f);
                  put(slot + 1, on ? vv * pr.im : 0.f);
                }
              }
              if (j != k) {
                const int slot =
                    S::T7 + (S::offd(j, k) * R * R + r * R + s) * 2;
                if (in_chunk(slot, 2)) {
                  const float vv = v[j] * v[k];
                  const cf p = cmul_conj<REAL>(c.A[j][r][0], Z(k, s, 0));
                  const cf q = cmul_conj<REAL>(c.A[j][r][1], Z(k, s, 1));
                  put(slot, on ? vv * (p.re + q.re) : 0.f);
                  put(slot + 1, (on && !REAL) ? vv * (p.im + q.im) : 0.f);
                }
              }
            }
          }
        }
      }
    };
    if constexpr (P::REG) {
      emit([](int, int) { return true; },
           [&](int slot, float val) { racc[slot] += valid ? val : 0.f; });
    } else {
      // Each lane reads back only its own features; the barrier keeps the
      // compiler from carrying phase 1's registers into phase 2, which is
      // what holds J = 4 rank 2 to 128 registers without spill.
      __syncwarp();
      flush(emit, min(kTile, N - n0));
    }
  }

  if constexpr (P::REG) {  // the lanes' sums, added over the lanes in order
    flush([&](auto&& in_chunk, auto&& put) {
#pragma unroll
      for (int s = 0; s < S::COUNT; ++s) put(s, racc[s]);
    }, kTile);
  }

  // The warp's loglik, a shuffle tree; then the warps' sums in warp order.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ll_acc += __shfl_down_sync(0xffffffffu, ll_acc, off);
  __syncthreads();  // every warp is done with its tile
  constexpr int RW = S::COUNT + 1;
  float* red = &tiles[0][0];  // [kGenWarps][RW]
#pragma unroll
  for (int ch = 0; ch < S::CHUNKS; ++ch)
    if (ch * kTile + lane < S::COUNT)
      red[warp * RW + ch * kTile + lane] = acc[ch];
  if (lane == 0) red[warp * RW + S::LL] = ll_acc;
  __syncthreads();
  for (int s = tid; s < RW; s += kGenThreads) {
    float t = red[s];
#pragma unroll
    for (int w2 = 1; w2 < kGenWarps; ++w2) t += red[w2 * RW + s];
    red[s] = t;
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

using Kernel = void (*)(Args);

// The dynamic shared bytes of one instantiation: the warps' w/z buffers.
template <int J, int R>
constexpr size_t feat_bytes() {
  return (size_t)kGenWarps * Plan<J, R>::NF * kTile * sizeof(float);
}

// An instantiation and its launch's dynamic shared bytes.
struct Pick {
  Kernel kernel;
  size_t smem;
};

template <int J, int R, bool REAL, bool NS>
Pick pick_one() {
  return Pick{&estep_general_kernel<J, R, REAL, NS>, feat_bytes<J, R>()};
}

// The instantiation that rmax, real_cov and ns_inj name, allowed its
// dynamic shared bytes (asked of the runtime once per instantiation where
// the block passes 48 KB); a null kernel for no rank it is built for, or
// with the runtime's error.
template <int J>
Pick pick(int rmax, int real_cov, int ns_inj, cudaError_t* err) {
  const bool re = real_cov != 0, ns = ns_inj != 0;
  Pick p{nullptr, 0};
  if (rmax == 1) {
    if (re) p = ns ? pick_one<J, 1, true, true>() : pick_one<J, 1, true, false>();
    else p = ns ? pick_one<J, 1, false, true>() : pick_one<J, 1, false, false>();
  } else if (rmax == 2) {
    if (re) p = ns ? pick_one<J, 2, true, true>() : pick_one<J, 2, true, false>();
    else p = ns ? pick_one<J, 2, false, true>() : pick_one<J, 2, false, false>();
  }
  *err = p.kernel ? cudaSuccess : cudaErrorInvalidValue;
  if (!p.kernel) return p;
  static bool allowed[2][2][2];  // [rmax - 1][real_cov][ns_inj]
  bool& done = allowed[rmax - 1][re][ns];
  if (!done) {
    cudaFuncAttributes attr;
    *err = cudaFuncGetAttributes(&attr, p.kernel);
    if (*err == cudaSuccess && attr.sharedSizeBytes + p.smem > 48 * 1024)
      *err = cudaFuncSetAttribute(p.kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)p.smem);
    done = *err == cudaSuccess;
  }
  if (*err != cudaSuccess) p.kernel = nullptr;
  return p;
}

template <int J>
int entry(const float* x4, const float* v, const float* A4,
          const float* sigma, float* xi, float* txs, float* tss, float* t4,
          float* t7, float* ll, int B, int F, int N, int rank_mask,
          int rmax, int real_cov, int ns_inj, float eps, int fast_recip,
          int no_ll, void* stream) {
  if (B <= 0 || F <= 0 || N <= 0 || (long long)B * F > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const Pick p = pick<J>(rmax, real_cov, ns_inj, &e);
  if (!p.kernel) return (int)e;
  const Kernel kernel = p.kernel;
  const Args g{x4, v, A4, sigma, xi, txs, tss, t4, t7, ll, F, N, rank_mask,
               eps, fast_recip != 0, no_ll != 0};
  kernel<<<B * F, kGenThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

// Resident warps per SM, registers, local (spill) bytes and shared bytes
// (static and dynamic) of one instantiation, as the runtime reports them.
template <int J>
int entry_info(int rmax, int real_cov, int ns_inj, int* out) {
  cudaError_t e;
  const Pick p = pick<J>(rmax, real_cov, ns_inj, &e);
  if (!p.kernel) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, p.kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.kernel,
                                                    kGenThreads, p.smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks * kGenWarps;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)(attr.sharedSizeBytes + p.smem);
  return 0;
}

}  // namespace pyfasst_general

// C entry points for J sources, bound with ctypes (ops/cuda_estep.py,
// ops/_build.py). The E-step launches on `stream`, does not synchronise,
// allocates nothing. The info call writes [resident warps per SM,
// registers per thread, local bytes per thread, shared bytes per block,
// static and dynamic] of the instantiation that rmax, real_cov and ns_inj
// name. Each returns a cudaError_t: 0 on success.
#define PYFASST_ESTEP_GENERAL_ENTRY(J)                                        \
  extern "C" int pyfasst_estep_j##J(                                          \
      const float* x4, const float* v, const float* A4, const float* sigma,   \
      float* xi, float* txs, float* tss, float* t4, float* t7, float* ll,     \
      int B, int F, int N, int rank_mask, int rmax, int real_cov, int ns_inj, \
      float eps, int fast_recip, int no_ll, void* stream) {                   \
    return pyfasst_general::entry<J>(x4, v, A4, sigma, xi, txs, tss, t4, t7,  \
                                     ll, B, F, N, rank_mask, rmax, real_cov,  \
                                     ns_inj, eps, fast_recip, no_ll, stream); \
  }                                                                           \
  extern "C" int pyfasst_estep_j##J##_info(int rmax, int real_cov,            \
                                           int ns_inj, int* out) {            \
    return pyfasst_general::entry_info<J>(rmax, real_cov, ns_inj, out);       \
  }
