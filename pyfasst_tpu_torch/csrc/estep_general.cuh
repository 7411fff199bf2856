// Fused GEM E-step for I = 2 channels, any ranks in {1, 2} per source,
// real or complex mixing, with or without 'ann_ns_inj' noise injection:
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pyfasst_tpu/ops/pallas_estep.py::_make_kernel
// (body :108, launched by pallas_estep at :449) in its variants
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
// its own kernel, estep.cu, at J = 2 and 3. Per (f, n) bin it computes
// what _make_kernel computes: the spatial invariants of the mixing columns
// (packed R_j, tr R_j, the Lagrange cross terms X_jk); the subtract-free
// det Sigma_x; y = Sigma_x^-1 x; w_jr = A_jr^H y and z_jr = Sigma_x^-1
// A_jr; the leave-one-out Woodbury posterior through S_j = sigma I +
// sum_{k!=j} v_k R_k (a scalar 1 / (1 + v M00) for rank 1, the closed-form
// inverse of G = I + v M with dG = max(g00 g11 - |g01|^2, 1) for rank 2);
// xi_j; and the frame-reduced Txs, Tss, T4, T7 and loglik, with the ns_inj
// corrections sigma Sigma_x^-1 A when asked. The TPU kernel forms each
// frame sum as a frame-axis sum of its tile (rsum, pallas_estep.py:159-163,
// :286-303, :308-359), which these kernels contract over the row's frames.
//
// One block of four warps owns one (b, f) row of the plane: GPU blocks run
// in no order, so the row's frame sums never leave the block. Three
// designs, by how many sums a row has (Slots::COUNT) and by J:
//
// REG (estep_reg_kernel; up to kRegSums = 40: J <= 3 at rank 1). The warps
// take the row's tiles of 32 frames in turn, lane = frame; each lane keeps
// every sum of its frames in registers, and the next tile's x4 and v are
// loaded while this one is computed. At the end of the row the lanes' sums
// go through the warp's 32 x 33 tile once, lanes in order.
//
// FRAMES (estep_frames_kernel; every other instantiation up to J = 8, and
// past it where WIDE is not the faster: wide_lanes). The block takes the
// row's tiles of kFrames = 128 frames.
//   Phase 1, thread = frame, is the Pallas arithmetic term by term
//   (frame_terms: REG's, the leave-one-out sums per source): it writes the
//   frame's features into the block's tile in shared memory, feature-major
//   with frames contiguous: x (4 words), then per source j a block of v_j,
//   w_jr (2 R words), z_jr (4 R, or 2 R with real mixing) and the T4 terms
//   (1 or 4), padded to an odd length (Feats). A frame past N writes
//   zeros, so it adds nothing to any sum.
//   Phase 2: each frame sum is owned by one thread for the whole row. The
//   sums fall into owners of three roles: Tss_jk (j <= k, all r, s: v_j,
//   v_k, w_j, w_k), T7_jk (j != k, all r, s: v_j, v_k, z_k, and A_j in
//   registers) and source j's Txs and T4 (v_j, x, w_j, its T4 terms). A
//   role cuts the block into kFrames / L groups of L lanes (Split picks L
//   per role and instantiation, below); lane u of a group owns owners u,
//   u + L, ... (its slots) over its group's share of the tile's quads of
//   four frames, split evenly over the groups in every tile, the last,
//   ragged one too, so no group idles while another has a full share. Per four
//   frames a thread loads each operand of its owner once, as a float4, and
//   forms all of the owner's products from them, in the Pallas forms.
//   Ownership is a function of the thread index alone, fixed for the row:
//   slots unrolled at compile time, no runtime slot test, no array indexed
//   at run time. The next tile's x4 and v load while T7 and the sources'
//   sums run.
//   Sums in two levels: an owner adds its frames in order into a tile
//   partial, then the partial into its running total (a register). At the
//   end of the row the groups' totals are added in group order, and the
//   loglik (each thread over its frames, a shuffle tree, then the warps in
//   order) as in REG: fixed orders, no atomics, the same bits from run to
//   run.
// Split weighs each role's idle lanes against its set-up per owner, from
// issue slots per frame and per owner (Role), within kTotRegs running
// totals a thread, so no J needs a limit of its own. Busy share of phase 2 (owners x quads over threads x
// the quads of the busiest thread), by role Tss / T7 / source: J = 5 94 /
// 83 / 62% (15, 20 and 5 lanes), J = 6 88 / 94 / 75%, J = 7 88 / 95 / 88%
// (ranks 1 and 2 alike, one slot each); J = 8 real rank 1 and rank 2 90 /
// 88 / 100% (two Tss slots of 18 lanes, 56, 8), complex rank 1 90 / 100 /
// 100% (seven T7 slots of 8 lanes). Shared memory is the tile, (4 + J
// blocks) x 132 words: at J = 8 rank 2, 140 x 528 B = 72 KB, three
// blocks (12 warps) to an SM; at J = 16 276 x 528 B = 146 KB, one block.
//
// WIDE (estep_wide_kernel; J = 9 to 16, the last J instantiated here,
// csrc/estep_j16.cu; past it csrc/estep_many.cu takes J at run time),
// where it is the faster (wide_lanes). What bounds FRAMES there (PERF.md,
// row 1g'', tools/wide_probe.py): phase 1 is at its FADD count already
// (nvcc forms each product (v_k v_l) X_kl once and adds it to every
// leave-one-out sum that takes it) and issues at ~full rate where 16
// warps share an SM, but its 6 J leave-one-out sums live beside phase 2's
// totals (spills at J = 12-16 rank 1; 255 registers at complex rank 1 J =
// 16), and the tile with its T4 rows outgrows shared memory at rank 2
// (146 KB at J = 16: one block, four warps an SM, 62% of the time in
// phase 1). WIDE keeps FRAMES' block, roles and Split, and:
//   - The T4 terms leave the tile: each lane keeps its frame's, and after
//     the tile's sources every shuffle tree runs at once into the warp's
//     totals (shared memory, tile order; the warps of a half added in warp
//     order at the end of the row).
//   - The tile holds u_jr = v_j w_jr and y_jr = v_j z_jr beside v_j, so a
//     frame sum is a plain product of tile words (wide_tss, wide_txs), and
//     T7_jk = A_j^H sum_n v_j y_ks: its frame sums are 2 R W words an
//     owner (wide_t7: 4 R W operations a frame against t7_item's R^2 x
//     18), A_j^H applied once at the end of the row.
//   - G lanes a frame in phase 1 (wide_lanes: 1 or 2). G = 2: tiles of 64
//     frames, lane h = tid / 64 (a warp pair) owning the leave-one-out sums
//     of sources h JH .. (JH = ceil(J / 2)), each warp running code
//     specialised for its half (wide_terms: every term of Sigma_x's sums
//     formed once and added to Sigma_x's sum and to the half's own sums,
//     in the plain version's order); each lane forms Sigma_x whole (3 J^2
//     + 10 J more instructions a frame). At J = 16 complex rank 2 the tile
//     is 212 x 272 B = 58 KB, three blocks (12 warps) an SM. G = 1: a
//     thread a frame over FRAMES' 128-frame tiles.
//   Busy share of phase 2 by role Tss / T7 / source (tools/wide_probe.py
//   shares): J = 9 complex rank 1 94 / 90 / 75% (15, 18 and 9 lanes),
//   complex rank 2 94 / 82 / 75%; J = 10 complex rank 2 86 / 94 / 83% (55,
//   30, 10); J = 12 real rank 1 98 / 82 / 75%, complex rank 1 89 / 92 /
//   75%, complex rank 2 89 / 69 / 75%; J = 16 rank 1 94 / 94 / 100% (nine
//   Tss slots of 16 lanes, two T7 slots of 128, 16), complex rank 2 (G =
//   2, 16 quads a tile) 71 / 94 / 100% (46, 128, 16). Real mixing at
//   rank 1 up to J = 11 and at rank 2 up to J = 10, and ns_inj at complex
//   rank 2 J = 11, keep FRAMES (PERF.md).
//
// Numerics follow the Pallas forms term by term: the subtract-free dets of
// Sigma_x and of each S_j, the rank-2 dG clamp and coef = (g00 + g11)/dG,
// xi / rank, exact IEEE divides and logf; built with --fmad=false (see
// estep.cu) so that every product rounds as in the plain version; xi has
// no sum in it and keeps the plain version's bits. In REG and FRAMES each
// product is formed as the Pallas kernel forms it (vv = v_j v_k, then vv *
// pr); only the order of the frame sums is the kernel's own. WIDE forms
// its frame sums' products from the scaled features u, y (and T7 as A^H
// times a sum): other roundings, within the same bars. With real mixing
// (REAL) the imaginary parts of the mixing columns and of z are zero; `if
// constexpr (REAL)` drops that arithmetic, as the Pallas symbolic-zero
// algebra does.
// Only j <= k of Tss is summed: Tss_kj = Tss_jk^H holds bit for bit, since
// both are written from the same sums; T7 has no such exact symmetry and
// is summed for every j != k.
//
// What bounds it on an H100: per bin it reads x4 (16 B) and v (4 B per
// source) and writes xi (4 B per source), against ~930 (J = 5, real rank
// 1), ~5,500 (J = 8, rank 2) and ~19,000 (J = 16, rank 2) float32
// operations the function needs (chip_smoke.general_ops: the plain
// version's, with the frame sums formed as WIDE forms them): bound by
// operations, and with --fmad=false each multiply and add issues on its
// own, so the yardstick is the floor at half the card's FMA rate. On top
// of the operations come the exact divides, logf, the loads of phase 2 and
// its idle lanes: the kernel is bound by instruction issue
// (kernel_sass.py); at J = 8 rank 2 FRAMES runs at ~2.6x that floor; at
// J = 16 complex rank 2 FRAMES took 6.3x (255 registers, one block an
// SM), WIDE 2.9x, real rank 1 2.0x (PERF.md, row 1g'').
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

#include <type_traits>

#include "recip.cuh"

namespace pyfasst_general {

constexpr int kGenWarps = 4;
constexpr int kGenThreads = 32 * kGenWarps;
constexpr int kRegSums = 40;      // at most this many sums: REG
constexpr int kTile = 32;         // REG: frames per warp tile
constexpr int kTileStride = kTile + 1;
constexpr int kFrames = kGenThreads;      // FRAMES: frames per tile
// words per feature row of the tile: 16-byte rows whose starts step by one
// 16-byte bank group (132 / 4 = 33 is odd), so eight lanes loading a float4
// of eight features with distinct indices mod 8 hit distinct banks
constexpr int kFeatStride = kFrames + 4;
constexpr int kTotRegs = 48;      // FRAMES: running totals a thread keeps
constexpr int kSmemPerSM = 228 * 1024;    // an H100 SM's shared memory

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

// Frame sums of one (b, f) row, in the order the outputs are read from
// (the loglik is summed apart).
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
  static constexpr bool REG = COUNT <= kRegSums;
  __device__ static constexpr int pair(int j, int k) {  // j <= k
    return j * J - j * (j - 1) / 2 + (k - j);
  }
  __device__ static constexpr int offd(int j, int k) {  // j != k
    return j * (J - 1) + (k < j ? k : k - 1);
  }
};

// The sources' ranks, from the launch's rank mask (bit j: source j has
// rank 2); computed where read, so no array of them is indexed at run time.
template <int J, int R>
struct Ranks {
  int mask;
  __device__ int operator[](int j) const {
    return (R == 2 && ((mask >> j) & 1)) ? 2 : 1;
  }
};

// Per-row spatial invariants, derived from the mixing columns.
template <int J, int R>
struct __align__(16) Row {
  cf A[J][R][2];  // A_j[:, r] = (A0, A1)
  float Ra[J], Rd[J], trR[J];
  cf Rb[J];
  float Xc[J][J];
  float sig;
};

// The row's invariants, spread over the block: one (j, r, channel) entry
// of the mixing columns per thread, then the J R_j and J^2 X_jk, item t
// to thread t (past J = 10, t mod kGenThreads, in turns; rk[j]: source
// j's rank). Ends with the block synchronised.
template <int J, int R, bool REAL, class Rk>
__device__ __forceinline__ void row_constants(Row<J, R>& c,
                                              const float* __restrict__ A4,
                                              size_t a_stride, const Rk& rk,
                                              float sig, int tid) {
  if (tid < J * R * 2) {
    const int j = tid / (2 * R), r = (tid / 2) % R, ch = tid % 2;
    const float* a = A4 + j * a_stride + 4 * r + 2 * ch;
    c.A[j][r][ch] = cf{a[0], REAL ? 0.f : a[1]};
  }
  if (tid == 0) c.sig = sig;
  __syncthreads();
  auto source = [&](int j) {  // R_j, tr R_j
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
  };
  auto cross = [&](int jk) {  // X_jk
    const int j = jk / J, k = jk % J;
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
  };
  if constexpr (J + J * J <= kGenThreads) {
    if (tid < J)
      source(tid);
    else if (tid < J + J * J)
      cross(tid - J);
  } else {
    for (int t = tid; t < J + J * J; t += kGenThreads) {
      if (t < J)
        source(t);
      else
        cross(t - J);
    }
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

template <int J, int R, bool REAL, bool NS>
struct Split;  // FRAMES' choices per instantiation (below)

// Source j of one frame from its leave-one-out sums (la, ld, lbr, lbi,
// llin, lquad) and the frame's Sigma_x = [a, d, sb] (1 / det = rinv) and y:
// w_jr = A_jr^H y and z_jr = Sigma_x^-1 A_jr (zero past the rank rkj), S_j's
// subtract-free det, the posterior and the T4 terms (1 / den for rank 1,
// v G^-1 for rank 2); returns xi_j, floored at eps.
template <int J, int R, bool REAL, bool NS>
__device__ __forceinline__ float source_post(
    const Row<J, R>& c, int j, int rkj, float vj, float sig, float a,
    float d, cf sb, float rinv, cf y0, cf y1, float la, float ld, float lbr,
    float lbi, float llin, float lquad, bool fast, float eps, cf (&wj)[R],
    cf (&zj)[R][2], float (&t4)[Slots<J, R>::NT4]) {
  constexpr int NT4 = Slots<J, R>::NT4;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wj[r] = cf{0.f, 0.f};
    zj[r][0] = zj[r][1] = cf{0.f, 0.f};
    if (r < rkj) {
      const cf p = cmul_conj<REAL>(c.A[j][r][0], y0);
      const cf q = cmul_conj<REAL>(c.A[j][r][1], y1);
      wj[r] = cf{p.re + q.re, p.im + q.im};
      herm_apply<REAL>(a, d, sb, rinv, c.A[j][r][0], c.A[j][r][1], zj[r][0],
                       zj[r][1]);
    }
  }

  float trCR = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < rkj) trCR += cabs2(wj[r]);
  if constexpr (NS) {
    float zz = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < rkj) zz += cabs2(zj[r][0]) + cabs2(zj[r][1]);
    trCR = trCR + sig * zz;
  }

  // S_j's subtract-free det
  const cf lb{lbr, REAL ? 0.f : lbi};
  const float aS = sig + la;
  const float dS = sig + ld;
  const float detS = sig * sig + sig * llin + 0.5f * lquad;
  const float rinvS = pyfasst::recip(detS, fast);

  // M_rs = A_jr^H S_j^-1 A_js
  cf sj[R][2];
#pragma unroll
  for (int s = 0; s < R; ++s)
    if (s < rkj)
      herm_apply<REAL>(aS, dS, lb, rinvS, c.A[j][s][0], c.A[j][s][1],
                       sj[s][0], sj[s][1]);
  auto M = [&](int r, int s) {
    const cf p = cmul_conj<REAL>(c.A[j][r][0], sj[s][0]);
    const cf q = cmul_conj<REAL>(c.A[j][r][1], sj[s][1]);
    return cf{p.re + q.re, p.im + q.im};
  };

  // the T4 terms: 1 / den for rank 1, v G^-1 for rank 2
  float coef = 0.f;
  bool rank1 = true;
  if constexpr (R == 2) rank1 = rkj == 1;
  if (rank1) {
    const float den = 1.0f + vj * M(0, 0).re;
    coef = pyfasst::recip(den, fast);
    t4[0] = vj / den;
#pragma unroll
    for (int q = 1; q < NT4; ++q) t4[q] = 0.f;
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
  return fmaxf((vj * vj * trCR + vj * coef) / (float)rkj, eps);
}

// Phase 1 for one frame (x0, x1; v): Sigma_x, its subtract-free det, y, the
// loglik term (returned), and per source j: w_jr = A_jr^H y and z_jr =
// Sigma_x^-1 A_jr (zero past the rank), the leave-one-out posterior, the
// T4 terms (1 / den for rank 1, v G^-1 for rank 2) and xi, stored at
// xi[j FN] where valid. out(j, w_j, z_j, t4_j) takes source j's features.
template <int J, int R, bool REAL, bool NS, class Out>
__device__ __forceinline__ float frame_terms(
    const Row<J, R>& c, Ranks<J, R> rk, cf x0, cf x1, const float (&v)[J],
    float sig, float eps, bool fast, bool no_ll, bool valid, float* xi,
    size_t FN, Out&& out) {
  constexpr int NT4 = Slots<J, R>::NT4;
  // Sigma_x = sig I + sum_k v_k R_k and its subtract-free determinant, and
  // for every source j the leave-one-out S_j = sig I + sum_{k != j} v_k
  // R_k, summed per source as the Pallas kernel writes them
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
  float la[J], ld[J], lbr[J], lbi[J], llin[J], lquad[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    la[j] = ld[j] = lbr[j] = lbi[j] = llin[j] = lquad[j] = 0.f;
#pragma unroll
    for (int k = 0; k < J; ++k) {
      if (k == j) continue;
      la[j] += v[k] * c.Ra[k];
      ld[j] += v[k] * c.Rd[k];
      lbr[j] += v[k] * c.Rb[k].re;
      if constexpr (!REAL) lbi[j] += v[k] * c.Rb[k].im;
      llin[j] += v[k] * c.trR[k];
    }
#pragma unroll
    for (int k = 0; k < J; ++k) {
#pragma unroll
      for (int l = 0; l < J; ++l) {
        if (k == j || l == j) continue;
        lquad[j] += v[k] * v[l] * c.Xc[k][l];
      }
    }
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
  const float llt = no_ll ? tr : logf(det) + tr;

#pragma unroll
  for (int j = 0; j < J; ++j) {
    cf wj[R], zj[R][2];
    float t4[NT4];
    const float xij = source_post<J, R, REAL, NS>(
        c, j, rk[j], v[j], sig, a, d, sb, rinv, y0, y1, la[j], ld[j], lbr[j],
        lbi[j], llin[j], lquad[j], fast, eps, wj, zj, t4);
    out(j, wj, zj, t4);
    if (valid) xi[j * FN] = xij;
  }
  return llt;
}

// The packed outputs of one row from its totals `red` (Slots order, the
// loglik at Slots::LL), zero-padded past each source's rank (rk[j]:
// source j's rank): thread j < J writes source j's Txs and T4, and the
// (j, k) blocks of Tss and T7, jk = j J + k, go to thread 32 + jk (past
// J = 9, 32 + jk mod kGenThreads, in turns: the first warp's other work
// is the Txs).
template <int J, int R, bool REAL, class Rk>
__device__ __forceinline__ void write_outputs(const Args& g, const float* red,
                                              const Rk& rk, int b, int f,
                                              int row, int tid) {
  using S = Slots<J, R>;
  const int F = g.F;
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
  auto block = [&](int jk) {
    const int j = jk / J, k = jk - j * J;
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
  };
  if constexpr (32 + J * J <= kGenThreads) {
    if (tid >= 32 && tid < 32 + J * J) block(tid - 32);
  } else {
    for (int jk = (tid + kGenThreads - 32) % kGenThreads; jk < J * J;
         jk += kGenThreads)
      block(jk);
  }
}

// -- REG -------------------------------------------------------------------

template <int J, int R, bool REAL, bool NS>
__global__ void __launch_bounds__(kGenThreads, 4)
    estep_reg_kernel(Args g) {
  using S = Slots<J, R>;
  __shared__ Row<J, R> c;
  // the warps' tiles; at the end of the row, the warps' sums
  __shared__ float tiles[kGenWarps][kTile * kTileStride];
  static_assert(S::REG && kGenWarps * (S::COUNT + 1) <=
                              kGenWarps * kTile * kTileStride,
                "REG: a frame's sums in registers, the block's in the tiles");
  static_assert(J * R * 2 <= kGenThreads && J <= 32,
                "one thread per mixing entry and per source's Txs");

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
  const float sig = c.sig;
  const float eps = g.eps;
  const bool fast = g.fast_recip;

  // Moves the lanes' sums into registers of lane = sum, 32 at a time:
  // emit(in_chunk, put) puts each of this lane's sums into the tile; then
  // each lane adds the first `count` lanes' values of its row of the
  // tile, in order, to acc[chunk]. At the end of the row only.
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

  float racc[S::COUNT];  // lane = frame, its frame sums
#pragma unroll
  for (int s = 0; s < S::COUNT; ++s) racc[s] = 0.f;
  float ll_acc = 0.f;    // lane = frame: its loglik terms

  // the next tile's x4 and v are loaded while this one is computed
  float px[4], pv[J];
  {
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
    {
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
    // rank), kept for phase 2 in registers
    cf w[J][R], z[J][R][2];
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
        {
          w[j][r] = wj[r];
          z[j][r][0] = zj[r][0];
          z[j][r][1] = zj[r][1];
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
        racc[slot] += valid ? t4[q] : 0.f;
      }
      if (valid)
        xirow[j * FN + n] =
            fmaxf((vj * vj * trCR + vj * coef) / (float)rk[j], eps);
    }

    // -- phase 2: the products of the frame sums ------------------------------
    // W(j, r), Z(j, r, channel): this frame's w_jr and z_jr
    auto W = [&](int j, int r) -> cf { return w[j][r]; };
    auto Z = [&](int j, int r, int ch) -> cf { return z[j][r][ch]; };
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
    emit([](int, int) { return true; },
         [&](int slot, float val) { racc[slot] += valid ? val : 0.f; });
  }

  // the lanes' sums, added over the lanes in order
  flush([&](auto&& in_chunk, auto&& put) {
#pragma unroll
    for (int s = 0; s < S::COUNT; ++s) put(s, racc[s]);
  }, kTile);

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

  write_outputs<J, R, REAL>(g, red, rk, b, f, row, tid);
}

// -- FRAMES ----------------------------------------------------------------

// The tile's feature rows (see the head of this file).
template <int J, int R, bool REAL>
struct Feats {
  static constexpr int NT4 = Slots<J, R>::NT4;
  static constexpr int ZW = REAL ? 2 : 4;  // words of one z_jr
  static constexpr int X = 0;              // x0.re x0.im x1.re x1.im
  // within a source's block
  static constexpr int V = 0;
  static constexpr int W = 1;              // w_jr: re at W + 2 r, im + 1
  static constexpr int Z = W + 2 * R;      // z_jr channel ch: zre, zim
  static constexpr int T4 = Z + ZW * R;
  static constexpr int BLK = (T4 + NT4) | 1;  // odd: see kFeatStride
  static constexpr int COUNT = 4 + J * BLK;
  __host__ __device__ static constexpr int blk(int j) { return 4 + j * BLK; }
  __host__ __device__ static constexpr int zre(int r, int ch) {
    return Z + ZW * r + (REAL ? ch : 2 * ch);
  }
  __host__ __device__ static constexpr int zim(int r, int ch) {
    return Z + 4 * r + 2 * ch + 1;  // complex mixing only
  }
};

struct Role {
  int owners, sums, per_frame, per_item;
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Issue slots a thread spends on role r per whole tile of `frames` frames
// with groups of L lanes: kGenThreads / L groups share the tile's quads of
// frames.
constexpr long role_cost(Role r, int L, int frames) {
  const int quads = ceil_div(frames / 4, kGenThreads / L);
  return (long)ceil_div(r.owners, L) * (4 * quads * r.per_frame + r.per_item);
}

// Lanes per group: for each count of slots a thread takes, the narrowest
// group (most groups); at least 8 lanes where a thread takes several
// slots, 4 where one slot holds every owner of the role (narrower groups
// cost more in set-up and bank conflicts than their idle lanes save).
constexpr int kMinLanes = 8, kMinLanesOneSlot = 4;

constexpr int lanes_for(int owners, int slots) {
  const int low = slots == 1 ? kMinLanesOneSlot : kMinLanes;
  const int L = ceil_div(owners, slots);
  return L < low ? low : L > kFrames ? kFrames : L;
}

// Lanes per group of the three roles, packed 8 bits each: the choice that
// costs the fewest issue slots per tile of `frames` frames within `budget`
// running totals a thread (past it, the fewest totals).
constexpr int choose_lanes(Role a, Role b, Role c, int budget,
                           int frames = kFrames) {
  long best = -1;
  int pick = 0, fewest = 1 << 30, least = 0;
  for (int sa = 1; sa <= ceil_div(a.owners, kMinLanes); ++sa)
    for (int sb = 1; sb <= ceil_div(b.owners, kMinLanes); ++sb)
      for (int sc = 1; sc <= ceil_div(c.owners, kMinLanes); ++sc) {
        const int la = lanes_for(a.owners, sa), lb = lanes_for(b.owners, sb),
                  lc = lanes_for(c.owners, sc);
        const int regs = ceil_div(a.owners, la) * a.sums +
                         ceil_div(b.owners, lb) * b.sums +
                         ceil_div(c.owners, lc) * c.sums;
        const long cost = role_cost(a, la, frames) +
                          role_cost(b, lb, frames) + role_cost(c, lc, frames);
        const int lanes = la | lb << 8 | lc << 16;
        if (regs <= budget && (best < 0 || cost < best)) {
          best = cost;
          pick = lanes;
        }
        if (regs < fewest) {
          fewest = regs;
          least = lanes;
        }
      }
  return best < 0 ? least : pick;
}

// Phase 2's roles: Tss (j <= k), T7 (j != k) and the sources' Txs with T4.
// Per role: owners, sums per owner, and its issue slots per frame
// (products, one float4 load of each operand per four frames, the loop)
// and per owner and tile (its address, constants, partial and total).
template <int J, int R, bool REAL, bool NS>
struct Split {
  using FT = Feats<J, R, REAL>;
  static constexpr int NT4 = FT::NT4, ZW = FT::ZW;
  static constexpr Role TSS{
      J * (J + 1) / 2, 2 * R * R,
      1 + R * R * (10 + (NS ? (REAL ? 5 : 18) : 0)) +
          (2 + 4 * R + (NS ? 2 * R * ZW : 0) + 3) / 4 + 1,
      24 + 2 * R * R};
  static constexpr Role T7{
      J * (J - 1), R * R * (REAL ? 1 : 2),
      1 + R * R * (REAL ? 5 : 18) + (2 + R * ZW + 3) / 4 + 1,
      24 + R * R * (REAL ? 1 : 2) + R};
  static constexpr Role SRC{
      J, 4 * R + NT4,
      R * (20 + (NS ? (REAL ? 4 : 8) : 0)) + NT4 +
          (5 + 2 * R + (NS ? R * ZW : 0) + NT4 + 3) / 4 + 1,
      24 + 4 * R + NT4};
  static constexpr int LANES = choose_lanes(TSS, T7, SRC, kTotRegs);
  // device code reads these scalars: owners, sums per owner, lanes per
  // group and slots (owners a thread takes) of each role
  static constexpr int O_TSS = TSS.owners, O_T7 = T7.owners,
                       O_SRC = SRC.owners;
  static constexpr int U_TSS = TSS.sums, U_T7 = T7.sums, U_SRC = SRC.sums;
  static constexpr int L_TSS = LANES & 255, L_T7 = (LANES >> 8) & 255,
                       L_SRC = LANES >> 16;
  static constexpr int N_TSS = ceil_div(O_TSS, L_TSS);
  static constexpr int N_T7 = ceil_div(O_T7, L_T7);
  static constexpr int N_SRC = ceil_div(O_SRC, L_SRC);
  // the threads' totals at the end of the row: [total][thread]
  static constexpr int TOT_TSS = 0;
  static constexpr int TOT_T7 = TOT_TSS + N_TSS * U_TSS;
  static constexpr int TOT_SRC = TOT_T7 + N_T7 * U_T7;
  static constexpr int TOTS = TOT_SRC + N_SRC * U_SRC;
  // the row's sums in Slots order, after them
  static constexpr int RED = TOTS * kGenThreads;
  static constexpr int TILE = FT::COUNT * kFeatStride;
  static constexpr int SUMS = RED + Slots<J, R>::COUNT + 1;
  static constexpr size_t BYTES =
      (size_t)(TILE > SUMS ? TILE : SUMS) * sizeof(float);
  // resident blocks per SM asked of ptxas: four (128 registers a thread:
  // one wave of B = 1, F = 513 rows), or as many as shared memory holds
  // (three at J >= 7 rank 2: 168 registers); two (255) for ns_inj at rank
  // 2 past J = 4, which spills at three (ptxas; no path runs it); three
  // past J = 9 (rank 1 spills 16-512 B at four from J = 10 on)
  static constexpr int BLOCKS_BY_SMEM =
      kSmemPerSM / (int)(BYTES + sizeof(Row<J, R>) + 1024);
  static constexpr int BLOCKS = NS && R == 2 && J > 4 ? 2 : J > 9 ? 3 : 4;
  static constexpr int MIN_BLOCKS =
      BLOCKS_BY_SMEM < BLOCKS ? BLOCKS_BY_SMEM : BLOCKS;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// Tss_jk, every (r, s), over nq quads of frames from pa (source j's
// block) and pb (source k's), added to tot as one tile partial. Operands
// load per column r and s (w_ks again for each r; under ns_inj a barrier
// between the columns keeps them from being carried: registers). ST: the
// tile's words per feature row (estep_many.cu stages narrower tiles).
template <int J, int R, bool REAL, bool NS, int ST = kFeatStride>
__device__ __forceinline__ void tss_item(const float* pa, const float* pb,
                                         int nq, float sig,
                                         float (&tot)[2 * R * R]) {
  using FT = Feats<J, R, REAL>;
  constexpr int S = ST;
  constexpr int ZN = NS ? (REAL ? 1 : 2) : 0;  // words of a z channel
  float tp[2 * R * R];
#pragma unroll
  for (int i = 0; i < 2 * R * R; ++i) tp[i] = 0.f;
#pragma unroll 1
  for (int q = 0; q < nq; ++q, pa += 4, pb += 4) {
    const float4 vj = ld4(pa + FT::V * S), vk = ld4(pb + FT::V * S);
    float vv[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) vv[f] = at(vj, f) * at(vk, f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (NS && R > 1) asm volatile("" ::: "memory");
      const float4 wj0 = ld4(pa + (FT::W + 2 * r) * S),
                   wj1 = ld4(pa + (FT::W + 2 * r + 1) * S);
      float4 zj[2][2];  // [ch][re, im]
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int p = 0; p < ZN; ++p)
          zj[ch][p] = ld4(pa + (p ? FT::zim(r, ch) : FT::zre(r, ch)) * S);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const float4 wk0 = ld4(pb + (FT::W + 2 * s) * S),
                     wk1 = ld4(pb + (FT::W + 2 * s + 1) * S);
        float4 zk[2][2];
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
#pragma unroll
          for (int p = 0; p < ZN; ++p)
            zk[ch][p] = ld4(pb + (p ? FT::zim(s, ch) : FT::zre(s, ch)) * S);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const cf a{at(wj0, f), at(wj1, f)}, b{at(wk0, f), at(wk1, f)};
          cf pr{a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im};
          if constexpr (NS) {
            const float a0r = at(zj[0][0], f), b0r = at(zk[0][0], f);
            const float a1r = at(zj[1][0], f), b1r = at(zk[1][0], f);
            if constexpr (REAL) {
              pr.re = pr.re + sig * (a0r * b0r + a1r * b1r);
            } else {
              const float a0i = at(zj[0][1], f), b0i = at(zk[0][1], f);
              const float a1i = at(zj[1][1], f), b1i = at(zk[1][1], f);
              const cf zc{(a0r * b0r + a0i * b0i) + (a1r * b1r + a1i * b1i),
                          (a0r * b0i - a0i * b0r) + (a1r * b1i - a1i * b1r)};
              pr = cf{pr.re + sig * zc.re, pr.im + sig * zc.im};
            }
          }
          tp[2 * (r * R + s)] += vv[f] * pr.re;
          tp[2 * (r * R + s) + 1] += vv[f] * pr.im;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2 * R * R; ++i) tot[i] += tp[i];
}

// T7_jk, every (r, s): v_j v_k A_jr^H z_ks over nq quads of frames from pa
// (source j's block: v_j) and pb (source k's: v_k, z_k); A = &c.A[j].
template <int J, int R, bool REAL, int ST = kFeatStride>
__device__ __forceinline__ void t7_item(const float* pa, const float* pb,
                                        const cf (&A)[R][2], int nq,
                                        float (&tot)[R * R * (REAL ? 1 : 2)]) {
  using FT = Feats<J, R, REAL>;
  constexpr int S = ST;
  constexpr int W = REAL ? 1 : 2;
  cf a[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r][0] = A[r][0];
    a[r][1] = A[r][1];
  }
  float tp[R * R * W];
#pragma unroll
  for (int i = 0; i < R * R * W; ++i) tp[i] = 0.f;
#pragma unroll 1
  for (int q = 0; q < nq; ++q, pa += 4, pb += 4) {
    const float4 vj = ld4(pa + FT::V * S), vk = ld4(pb + FT::V * S);
    float4 z[R][2][W];  // [s][ch][re, im]
#pragma unroll
    for (int s = 0; s < R; ++s)
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        z[s][ch][0] = ld4(pb + FT::zre(s, ch) * S);
        if constexpr (!REAL) z[s][ch][W - 1] = ld4(pb + FT::zim(s, ch) * S);
      }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float vv = at(vj, f) * at(vk, f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const cf z0{at(z[s][0][0], f), REAL ? 0.f : at(z[s][0][W - 1], f)};
          const cf z1{at(z[s][1][0], f), REAL ? 0.f : at(z[s][1][W - 1], f)};
          if constexpr (REAL) {
            tp[r * R + s] += vv * (a[r][0].re * z0.re + a[r][1].re * z1.re);
          } else {
            const cf p = cmul_conj<false>(a[r][0], z0);
            const cf u = cmul_conj<false>(a[r][1], z1);
            tp[2 * (r * R + s)] += vv * (p.re + u.re);
            tp[2 * (r * R + s) + 1] += vv * (p.im + u.im);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R * R * W; ++i) tot[i] += tp[i];
}

// Source j's Txs (4 words per column r) and T4 (NT4 words after them) over
// nq quads of frames from pa (its block) and px (the frames' x). Operands
// load per column r.
template <int J, int R, bool REAL, bool NS, int ST = kFeatStride>
__device__ __forceinline__ void src_item(const float* pa, const float* px,
                                         int nq, float sig,
                                         float (&tot)[4 * R +
                                                      Slots<J, R>::NT4]) {
  using FT = Feats<J, R, REAL>;
  constexpr int S = ST;
  constexpr int NT4 = FT::NT4;
  constexpr int ZN = NS ? (REAL ? 1 : 2) : 0;  // words of a z channel
  float tp[4 * R + NT4];
#pragma unroll
  for (int i = 0; i < 4 * R + NT4; ++i) tp[i] = 0.f;
#pragma unroll 1
  for (int q = 0; q < nq; ++q, pa += 4, px += 4) {
    const float4 vj = ld4(pa + FT::V * S);
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(px + (FT::X + i) * S);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (NS && R > 1) asm volatile("" ::: "memory");
      const float4 w0 = ld4(pa + (FT::W + 2 * r) * S),
                   w1 = ld4(pa + (FT::W + 2 * r + 1) * S);
      float4 z[2][2];  // [ch][re, im]
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int p = 0; p < ZN; ++p)
          z[ch][p] = ld4(pa + (p ? FT::zim(r, ch) : FT::zre(r, ch)) * S);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float v = at(vj, f);
        const cf x0{at(x[0], f), at(x[1], f)}, x1{at(x[2], f), at(x[3], f)};
        const cf wr{at(w0, f), at(w1, f)};
        cf p0{x0.re * wr.re + x0.im * wr.im, x0.im * wr.re - x0.re * wr.im};
        cf p1{x1.re * wr.re + x1.im * wr.im, x1.im * wr.re - x1.re * wr.im};
        if constexpr (NS) {
          p0.re = p0.re + sig * at(z[0][0], f);
          p1.re = p1.re + sig * at(z[1][0], f);
          if constexpr (!REAL) {
            p0.im = p0.im + sig * at(z[0][1], f);
            p1.im = p1.im + sig * at(z[1][1], f);
          }
        }
        tp[4 * r] += v * p0.re;
        tp[4 * r + 1] += v * p0.im;
        tp[4 * r + 2] += v * p1.re;
        tp[4 * r + 3] += v * p1.im;
      }
    }
#pragma unroll
    for (int i = 0; i < NT4; ++i) {
      const float4 t = ld4(pa + (FT::T4 + i) * S);
#pragma unroll
      for (int f = 0; f < 4; ++f) tp[4 * R + i] += at(t, f);
    }
  }
#pragma unroll
  for (int i = 0; i < 4 * R + NT4; ++i) tot[i] += tp[i];
}

template <int J, int R, bool REAL, bool NS>
__global__ void __launch_bounds__(kGenThreads, Split<J, R, REAL, NS>::MIN_BLOCKS)
    estep_frames_kernel(Args g) {
  using S = Slots<J, R>;
  using FT = Feats<J, R, REAL>;
  using SP = Split<J, R, REAL, NS>;
  constexpr int ST = kFeatStride;
  constexpr int W7 = REAL ? 1 : 2;
  __shared__ Row<J, R> c;
  // phase 2's owners: j | k << 8, Tss (Slots::pair order) then T7 (offd)
  __shared__ unsigned short own[S::PAIRS + S::OFFD];
  __shared__ float llw[kGenWarps];
  // the tile's features [FT::COUNT][kFeatStride]; at the end of the row,
  // the threads' totals [SP::TOTS][kGenThreads] and the row's sums
  extern __shared__ __align__(16) float feats[];
  static_assert(!S::REG && SP::MIN_BLOCKS >= 1 &&
                    SP::BYTES + sizeof(Row<J, R>) <= 227 * 1024 &&
                    J * R * 2 <= kGenThreads && J <= 32,
                "FRAMES: the tile and the row's constants in one block's "
                "shared memory; one thread per mixing entry and per "
                "source's Txs");

  const int F = g.F, N = g.N;
  const int row = blockIdx.x;  // b * F + f
  const int b = row / F;
  const int f = row - b * F;
  const size_t FN = (size_t)F * N;
  const int tid = threadIdx.x;

  const Ranks<J, R> rk{g.rank_mask};

  for (int o = tid; o < S::PAIRS + S::OFFD; o += kGenThreads) {
    int j = 0, k = 0;
    if (o < S::PAIRS) {  // j <= k, row-major
      int m = o;
      while (m >= J - j) m -= J - j++;
      k = j + m;
    } else {
      const int m = o - S::PAIRS;
      j = m / (J - 1);
      k = m % (J - 1);
      k += k >= j;
    }
    own[o] = (unsigned short)(j | k << 8);
  }
  // the first tile's x4 and v, loaded while the row's constants are built
  const float* xrow = g.x4 + (size_t)b * 4 * FN + (size_t)f * N;
  const float* vrow = g.v + (size_t)b * J * FN + (size_t)f * N;
  float px[4], pv[J];
  {
    const bool valid = tid < N;
#pragma unroll
    for (int q = 0; q < 4; ++q) px[q] = valid ? xrow[q * FN + tid] : 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) pv[j] = valid ? vrow[j * FN + tid] : 0.f;
  }
  row_constants<J, R, REAL>(c, g.A4 + ((size_t)b * J * F + f) * 4 * R,
                            (size_t)F * 4 * R, rk, g.sigma[row], tid);

  float* xirow = g.xi + (size_t)b * J * FN + (size_t)f * N;
  const float sig = c.sig;
  const float eps = g.eps;
  const bool fast = g.fast_recip;

  float tot_tss[SP::N_TSS][2 * R * R], tot_t7[SP::N_T7][R * R * W7],
      tot_src[SP::N_SRC][4 * R + FT::NT4];
#pragma unroll
  for (int i = 0; i < SP::N_TSS; ++i)
#pragma unroll
    for (int s = 0; s < 2 * R * R; ++s) tot_tss[i][s] = 0.f;
#pragma unroll
  for (int i = 0; i < SP::N_T7; ++i)
#pragma unroll
    for (int s = 0; s < R * R * W7; ++s) tot_t7[i][s] = 0.f;
#pragma unroll
  for (int i = 0; i < SP::N_SRC; ++i)
#pragma unroll
    for (int s = 0; s < 4 * R + FT::NT4; ++s) tot_src[i][s] = 0.f;
  float ll_acc = 0.f;  // thread = frame: its loglik terms

  // the next tile's x4 and v, loaded while this one is computed

  float* col = feats + tid;  // this thread's frame of the tile
  for (int n0 = 0; n0 < N; n0 += kFrames) {
    const int n = n0 + tid;
    const bool valid = n < N;

    // -- phase 1, thread = frame ----------------------------------------------
    const cf x0{px[0], px[1]}, x1{px[2], px[3]};
    float v[J];
#pragma unroll
    for (int j = 0; j < J; ++j) v[j] = pv[j];

    if (valid) {
      col[(FT::X + 0) * ST] = x0.re;
      col[(FT::X + 1) * ST] = x0.im;
      col[(FT::X + 2) * ST] = x1.re;
      col[(FT::X + 3) * ST] = x1.im;
#pragma unroll
      for (int j = 0; j < J; ++j) col[(FT::blk(j) + FT::V) * ST] = v[j];
      ll_acc += frame_terms<J, R, REAL, NS>(
          c, rk, x0, x1, v, sig, eps, fast, g.no_ll, true, xirow + n, FN,
          [&](int j, const cf(&wj)[R], const cf(&zj)[R][2],
              const float(&t4)[S::NT4]) {
            float* p = col + FT::blk(j) * ST;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              p[(FT::W + 2 * r) * ST] = wj[r].re;
              p[(FT::W + 2 * r + 1) * ST] = wj[r].im;
#pragma unroll
              for (int ch = 0; ch < 2; ++ch) {
                p[FT::zre(r, ch) * ST] = zj[r][ch].re;
                if constexpr (!REAL) p[FT::zim(r, ch) * ST] = zj[r][ch].im;
              }
            }
#pragma unroll
            for (int q = 0; q < S::NT4; ++q) p[(FT::T4 + q) * ST] = t4[q];
          });
    } else {  // a frame past N: every feature 0, so it adds nothing
#pragma unroll 4
      for (int e = 0; e < FT::COUNT; ++e) col[e * ST] = 0.f;
    }
    __syncthreads();

    // -- phase 2, each thread its owners over its group's frames --------------
    // the tile's quads of frames, shared evenly by a role's kFrames / L
    // groups (in the last, ragged tile too)
    const int quads = (min(kFrames, N - n0) + 3) >> 2;
    auto span = [&](int L, int& q0) {
      const int per = (quads + kFrames / L - 1) / (kFrames / L);
      q0 = tid / L * per;
      return min(per, quads - q0);
    };
#pragma unroll
    for (int i = 0; i < SP::N_TSS; ++i) {
      constexpr int L = SP::L_TSS;
      const int o = i * L + tid % L;
      int q0;
      const int nq = span(L, q0), f0 = 4 * q0;
      if (o < SP::O_TSS && nq > 0) {
        const int jk = own[o];
        tss_item<J, R, REAL, NS>(feats + FT::blk(jk & 255) * ST + f0,
                                 feats + FT::blk(jk >> 8) * ST + f0, nq, sig,
                                 tot_tss[i]);
      }
    }
    // the next tile's x4 and v load while T7 and the sources' sums run
    {
      const int nn = n + kFrames;
      const bool vn = nn < N;
#pragma unroll
      for (int q = 0; q < 4; ++q) px[q] = vn ? xrow[q * FN + nn] : 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) pv[j] = vn ? vrow[j * FN + nn] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < SP::N_T7; ++i) {
      constexpr int L = SP::L_T7;
      const int o = i * L + tid % L;
      int q0;
      const int nq = span(L, q0), f0 = 4 * q0;
      if (o < SP::O_T7 && nq > 0) {
        const int jk = own[S::PAIRS + o], j = jk & 255;
        t7_item<J, R, REAL>(feats + FT::blk(j) * ST + f0,
                            feats + FT::blk(jk >> 8) * ST + f0, c.A[j], nq,
                            tot_t7[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < SP::N_SRC; ++i) {
      constexpr int L = SP::L_SRC;
      const int o = i * L + tid % L;
      int q0;
      const int nq = span(L, q0), f0 = 4 * q0;
      if (o < SP::O_SRC && nq > 0)
        src_item<J, R, REAL, NS>(feats + FT::blk(o) * ST + f0,
                                 feats + FT::X * ST + f0, nq, sig,
                                 tot_src[i]);
    }
    __syncthreads();  // the tile is free for the next one's features
  }

  // -- the row's sums ----------------------------------------------------------
  // Each thread's totals, [total][thread]; the warps' loglik, a shuffle tree.
#pragma unroll
  for (int i = 0; i < SP::N_TSS; ++i)
#pragma unroll
    for (int s = 0; s < 2 * R * R; ++s)
      feats[(SP::TOT_TSS + i * SP::U_TSS + s) * kGenThreads + tid] =
          tot_tss[i][s];
#pragma unroll
  for (int i = 0; i < SP::N_T7; ++i)
#pragma unroll
    for (int s = 0; s < R * R * W7; ++s)
      feats[(SP::TOT_T7 + i * SP::U_T7 + s) * kGenThreads + tid] =
          tot_t7[i][s];
#pragma unroll
  for (int i = 0; i < SP::N_SRC; ++i)
#pragma unroll
    for (int s = 0; s < 4 * R + FT::NT4; ++s)
      feats[(SP::TOT_SRC + i * SP::U_SRC + s) * kGenThreads + tid] =
          tot_src[i][s];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ll_acc += __shfl_down_sync(0xffffffffu, ll_acc, off);
  if ((tid & 31) == 0) llw[tid >> 5] = ll_acc;
  __syncthreads();

  // Sum s of owner o of a role: its groups' totals, in group order (a
  // loop of known length, so the loads issue ahead of the adds).
  auto total = [&](auto lanes, int base, int sums, int o, int s) {
    constexpr int L = decltype(lanes)::value;
    const float* p = feats + (base + (o / L) * sums + s) * kGenThreads +
                     o % L;
    float t = p[0];
#pragma unroll
    for (int g0 = L; g0 < kGenThreads / L * L; g0 += L) t += p[g0];
    return t;
  };
  using LTss = std::integral_constant<int, SP::L_TSS>;
  using LT7 = std::integral_constant<int, SP::L_T7>;
  using LSrc = std::integral_constant<int, SP::L_SRC>;
  float* red = feats + SP::RED;  // the row's sums, Slots order
  for (int s = tid; s <= S::COUNT; s += kGenThreads) {
    float t;
    if (s == S::LL) {
      t = llw[0];
#pragma unroll
      for (int w2 = 1; w2 < kGenWarps; ++w2) t += llw[w2];
    } else if (s < S::TXS) {  // T4: after the source's Txs
      const int j = (s - S::T4) / S::NT4;
      t = total(LSrc(), SP::TOT_SRC, SP::U_SRC, j,
                4 * R + (s - S::T4) % S::NT4);
    } else if (s < S::TSS) {
      const int j = (s - S::TXS) / (4 * R);
      t = total(LSrc(), SP::TOT_SRC, SP::U_SRC, j, (s - S::TXS) % (4 * R));
    } else if (s < S::T7) {
      const int o = (s - S::TSS) / (2 * R * R);
      t = total(LTss(), SP::TOT_TSS, SP::U_TSS, o,
                (s - S::TSS) % (2 * R * R));
    } else {
      const int o = (s - S::T7) / (2 * R * R), e = (s - S::T7) % (2 * R * R);
      t = (REAL && (e & 1)) ? 0.f
                            : total(LT7(), SP::TOT_T7, SP::U_T7, o,
                                    REAL ? e >> 1 : e);
    }
    red[s] = t;
  }
  __syncthreads();
  write_outputs<J, R, REAL>(g, red, rk, b, f, row, tid);
}

// -- WIDE ------------------------------------------------------------------

// Lanes a frame in the WIDE kernel's phase 1 (J >= 9), by measured speed
// (PERF.md, row 1g''; kernel_compare.py, FRAMES and both forms in turns
// at (8, J, 513, 863)): 0 keeps the FRAMES kernel where it wins by more
// than the run-to-run spread, at real mixing and few sources (rank 1 up
// to J = 11, rank 2 up to J = 10); G = 2 lanes each own the leave-one-out
// sums of about J / 2 sources, so a lane's registers and the tile's
// shared memory halve: faster at rank 2 from J = 13 (complex) and at J =
// 16 (real). ns_inj follows the instantiation without it, but at complex
// rank 2 J = 11, where WIDE read 1.124x FRAMES' time (0.958x without
// ns_inj; one kernel_compare.py call of two rounds).
constexpr int wide_lanes(int J, int R, bool REAL, bool NS) {
  if (J < 9 || (REAL && J <= (R == 1 ? 11 : 10))) return 0;
  if (NS && R == 2 && !REAL && J == 11) return 0;
  return R == 2 && J >= (REAL ? 16 : 13) ? 2 : 1;
}

// The WIDE kernel's choices per instantiation: a tile of TF = kGenThreads /
// G frames, lane h of a frame (h = tid / TF, the same in a warp) owning
// sources h JH .. min(J, (h + 1) JH) - 1; the tile's feature rows: x (4),
// then per source v, w_jr and z_jr (BLK rows, odd: see kFeatStride; the T4
// terms are summed in phase 1), TF + 4 words a row (an odd number of 16-
// byte groups); phase 2's roles split as FRAMES' are (Split), over the
// tile's TF / 4 quads.
template <int J, int R, bool REAL, bool NS>
struct Wide {
  using FT = Feats<J, R, REAL>;
  using SP = Split<J, R, REAL, NS>;
  static constexpr int G = wide_lanes(J, R, REAL, NS);
  static constexpr int TF = kGenThreads / (G > 0 ? G : 1);
  static constexpr int ST = TF + 4;
  static constexpr int JH = (J + G - 1) / (G > 0 ? G : 1);
  static constexpr int NT4 = FT::NT4, ZW = FT::ZW;
  static constexpr int BLK = FT::T4;
  static constexpr int ROWS = 4 + J * BLK;
  __host__ __device__ static constexpr int blk(int j) { return 4 + j * BLK; }
  // the roles on the tile's scaled features (wide_tss, wide_t7,
  // wide_txs): Tss without its v_j v_k, T7's frame sums of v_j y_ks (2 R
  // W7 words an owner), Txs without its v_j and the T4 terms
  static constexpr int W7 = REAL ? 1 : 2;
  static constexpr Role TSS{
      J * (J + 1) / 2, 2 * R * R,
      R * R * (8 + (NS ? (REAL ? 5 : 18) : 0)) +
          (4 * R + (NS ? 2 * R * ZW : 0) + 3) / 4 + 1,
      24 + 2 * R * R};
  static constexpr Role T7{J * (J - 1), 2 * R * W7,
                           4 * R * W7 + (1 + 2 * R * W7 + 3) / 4 + 1,
                           24 + 2 * R * W7};
  static constexpr Role SRC{
      J, 4 * R,
      R * (16 + (NS ? (REAL ? 4 : 8) : 0)) +
          (4 + 2 * R + (NS ? R * ZW : 0) + 3) / 4 + 1,
      24 + 4 * R};
  static constexpr int LANES = choose_lanes(TSS, T7, SRC, kTotRegs, TF);
  static constexpr int O_TSS = SP::O_TSS, O_T7 = SP::O_T7, O_SRC = J;
  static constexpr int U_TSS = 2 * R * R, U_T7 = 2 * R * W7, U_SRC = 4 * R;
  static constexpr int L_TSS = LANES & 255, L_T7 = (LANES >> 8) & 255,
                       L_SRC = LANES >> 16;
  static constexpr int N_TSS = ceil_div(O_TSS, L_TSS);
  static constexpr int N_T7 = ceil_div(O_T7, L_T7);
  static constexpr int N_SRC = ceil_div(O_SRC, L_SRC);
  static constexpr int TOT_TSS = 0;
  static constexpr int TOT_T7 = TOT_TSS + N_TSS * U_TSS;
  static constexpr int TOT_SRC = TOT_T7 + N_T7 * U_T7;
  static constexpr int TOTS = TOT_SRC + N_SRC * U_SRC;
  static constexpr int RED = TOTS * kGenThreads;
  static constexpr int TILE = ROWS * ST;
  static constexpr int SUMS = RED + Slots<J, R>::COUNT + 1;
  static constexpr size_t BYTES =
      (size_t)(TILE > SUMS ? TILE : SUMS) * sizeof(float);
  // the static shared memory: the row's constants, the owners, the warps'
  // loglik and T4 totals
  static constexpr size_t STATIC =
      sizeof(Row<J, R>) + 2 * (SP::O_TSS + SP::O_T7) +
      4 * kGenWarps * (1 + JH * NT4);
  // resident blocks per SM asked of ptxas: three (168 registers), two (255)
  // for ns_inj at rank 2, four (128) at rank 1 up to J = 10, where a lane
  // fits 128 registers without spill (complex rank 1 at J = 9: 0.937x the
  // FRAMES kernel's time at four, 1.013x at three, each in its own call),
  // or as many as shared memory holds
  static constexpr int BLOCKS_BY_SMEM =
      kSmemPerSM / (int)(BYTES + STATIC + 1024);
  static constexpr int BLOCKS = NS && R == 2 ? 2 : R == 1 && J <= 10 ? 4 : 3;
  static constexpr int MIN_BLOCKS =
      BLOCKS_BY_SMEM < BLOCKS ? BLOCKS_BY_SMEM : BLOCKS;
};

// Phase 2's roles of the WIDE kernel. Its tile holds, per source j and
// frame, v_j, u_jr = v_j w_jr and y_jr = v_j z_jr (Feats' rows V, W, Z):
// each frame sum is then a plain product of tile words. Tss_jk (r, s) =
// sum_n u_jr conj(u_ks) (+ sig y_jr^H y_ks with ns_inj), over nq quads of
// frames from pa (source j's block) and pb (source k's), into tot.
template <int J, int R, bool REAL, bool NS, int ST>
__device__ __forceinline__ void wide_tss(const float* pa, const float* pb,
                                         int nq, float sig,
                                         float (&tot)[2 * R * R]) {
  using FT = Feats<J, R, REAL>;
  constexpr int ZN = NS ? (REAL ? 1 : 2) : 0;  // words of a y channel
  float tp[2 * R * R];
#pragma unroll
  for (int i = 0; i < 2 * R * R; ++i) tp[i] = 0.f;
#pragma unroll 1
  for (int q = 0; q < nq; ++q, pa += 4, pb += 4) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (NS && R > 1) asm volatile("" ::: "memory");
      const float4 uj0 = ld4(pa + (FT::W + 2 * r) * ST),
                   uj1 = ld4(pa + (FT::W + 2 * r + 1) * ST);
      float4 yj[2][2];  // [ch][re, im]
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int p = 0; p < ZN; ++p)
          yj[ch][p] = ld4(pa + (p ? FT::zim(r, ch) : FT::zre(r, ch)) * ST);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const float4 uk0 = ld4(pb + (FT::W + 2 * s) * ST),
                     uk1 = ld4(pb + (FT::W + 2 * s + 1) * ST);
        float4 yk[2][2];
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
#pragma unroll
          for (int p = 0; p < ZN; ++p)
            yk[ch][p] = ld4(pb + (p ? FT::zim(s, ch) : FT::zre(s, ch)) * ST);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const cf a{at(uj0, f), at(uj1, f)}, b{at(uk0, f), at(uk1, f)};
          cf pr{a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im};
          if constexpr (NS) {
            const float a0r = at(yj[0][0], f), b0r = at(yk[0][0], f);
            const float a1r = at(yj[1][0], f), b1r = at(yk[1][0], f);
            if constexpr (REAL) {
              pr.re = pr.re + sig * (a0r * b0r + a1r * b1r);
            } else {
              const float a0i = at(yj[0][1], f), b0i = at(yk[0][1], f);
              const float a1i = at(yj[1][1], f), b1i = at(yk[1][1], f);
              const cf zc{(a0r * b0r + a0i * b0i) + (a1r * b1r + a1i * b1i),
                          (a0r * b0i - a0i * b0r) + (a1r * b1i - a1i * b1r)};
              pr = cf{pr.re + sig * zc.re, pr.im + sig * zc.im};
            }
          }
          tp[2 * (r * R + s)] += pr.re;
          tp[2 * (r * R + s) + 1] += pr.im;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2 * R * R; ++i) tot[i] += tp[i];
}

// The frame sums behind T7_jk: sum_n v_j y_ks (per column s and channel,
// re and im; re alone with real mixing), from pa (source j's block: v_j)
// and pb (source k's: y_k). T7_jk (r, s) = A_jr^H times them, once at the
// end of the row: 2 R W words a frame instead of R^2 times v_j v_k A_jr^H
// z_ks (t7_item).
template <int J, int R, bool REAL, int ST>
__device__ __forceinline__ void wide_t7(const float* pa, const float* pb,
                                        int nq,
                                        float (&tot)[2 * R * (REAL ? 1 : 2)]) {
  using FT = Feats<J, R, REAL>;
  constexpr int W = REAL ? 1 : 2;
  float tp[2 * R * W];
#pragma unroll
  for (int i = 0; i < 2 * R * W; ++i) tp[i] = 0.f;
#pragma unroll 1
  for (int q = 0; q < nq; ++q, pa += 4, pb += 4) {
    const float4 vj = ld4(pa + FT::V * ST);
    float4 y[R][2][W];  // [s][ch][re, im]
#pragma unroll
    for (int s = 0; s < R; ++s)
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        y[s][ch][0] = ld4(pb + FT::zre(s, ch) * ST);
        if constexpr (!REAL) y[s][ch][W - 1] = ld4(pb + FT::zim(s, ch) * ST);
      }
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int s = 0; s < R; ++s)
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
#pragma unroll
          for (int p = 0; p < W; ++p)
            tp[(s * 2 + ch) * W + p] += at(vj, f) * at(y[s][ch][p], f);
  }
#pragma unroll
  for (int i = 0; i < 2 * R * W; ++i) tot[i] += tp[i];
}

// Source j's Txs (4 words per column r): sum_n [x0 conj(u_jr), x1
// conj(u_jr)] (+ sig y_jr with ns_inj), from pa (its block) and px (the
// frames' x).
template <int J, int R, bool REAL, bool NS, int ST>
__device__ __forceinline__ void wide_txs(const float* pa, const float* px,
                                         int nq, float sig,
                                         float (&tot)[4 * R]) {
  using FT = Feats<J, R, REAL>;
  constexpr int ZN = NS ? (REAL ? 1 : 2) : 0;
  float tp[4 * R];
#pragma unroll
  for (int i = 0; i < 4 * R; ++i) tp[i] = 0.f;
#pragma unroll 1
  for (int q = 0; q < nq; ++q, pa += 4, px += 4) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(px + (FT::X + i) * ST);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (NS && R > 1) asm volatile("" ::: "memory");
      const float4 u0 = ld4(pa + (FT::W + 2 * r) * ST),
                   u1 = ld4(pa + (FT::W + 2 * r + 1) * ST);
      float4 y[2][2];  // [ch][re, im]
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int p = 0; p < ZN; ++p)
          y[ch][p] = ld4(pa + (p ? FT::zim(r, ch) : FT::zre(r, ch)) * ST);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const cf x0{at(x[0], f), at(x[1], f)}, x1{at(x[2], f), at(x[3], f)};
        const cf ur{at(u0, f), at(u1, f)};
        cf p0{x0.re * ur.re + x0.im * ur.im, x0.im * ur.re - x0.re * ur.im};
        cf p1{x1.re * ur.re + x1.im * ur.im, x1.im * ur.re - x1.re * ur.im};
        if constexpr (NS) {
          p0.re = p0.re + sig * at(y[0][0], f);
          p1.re = p1.re + sig * at(y[1][0], f);
          if constexpr (!REAL) {
            p0.im = p0.im + sig * at(y[0][1], f);
            p1.im = p1.im + sig * at(y[1][1], f);
          }
        }
        tp[4 * r] += p0.re;
        tp[4 * r + 1] += p0.im;
        tp[4 * r + 2] += p1.re;
        tp[4 * r + 3] += p1.im;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4 * R; ++i) tot[i] += tp[i];
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;  // lane 0's is the warp's sum
}

// Phase 1 of the WIDE kernel for one frame and the JN sources J0 .. J0 + JN
// - 1 of its lane: frame_terms' arithmetic, with each term of Sigma_x's
// sums (v_k R_k, and the products (v_k v_l) X_kl) formed once and added to
// Sigma_x's sum and to the leave-one-out sums of the lane's sources that
// take it, each sum in the plain version's order (k, then l). Stores xi;
// out(u, j, w_j, z_j, t4_j) takes source j = J0 + u's features. Returns
// the frame's loglik term.
template <int J, int R, bool REAL, bool NS, int J0, int JN, class Out>
__device__ __forceinline__ float wide_terms(
    const Row<J, R>& c, Ranks<J, R> rk, cf x0, cf x1, const float (&v)[J],
    float sig, float eps, bool fast, bool no_ll, float* xi, size_t FN,
    Out&& out) {
  constexpr int NT4 = Slots<J, R>::NT4;
  float sa = 0.f, sd = 0.f, lin = 0.f, quad = 0.f;
  cf sb{0.f, 0.f};
  float la[JN], ld[JN], lbr[JN], lbi[JN], llin[JN], lq[JN];
#pragma unroll
  for (int u = 0; u < JN; ++u)
    la[u] = ld[u] = lbr[u] = lbi[u] = llin[u] = lq[u] = 0.f;
#pragma unroll
  for (int k = 0; k < J; ++k) {
    const float ta = v[k] * c.Ra[k], td = v[k] * c.Rd[k];
    const float tbr = v[k] * c.Rb[k].re, tl = v[k] * c.trR[k];
    const float tbi = REAL ? 0.f : v[k] * c.Rb[k].im;
    sa += ta;
    sd += td;
    sb.re += tbr;
    if constexpr (!REAL) sb.im += tbi;
    lin += tl;
#pragma unroll
    for (int u = 0; u < JN; ++u) {
      if (J0 + u == k) continue;
      la[u] += ta;
      ld[u] += td;
      lbr[u] += tbr;
      if constexpr (!REAL) lbi[u] += tbi;
      llin[u] += tl;
    }
  }
#pragma unroll
  for (int k = 0; k < J; ++k) {
#pragma unroll
    for (int l = 0; l < J; ++l) {
      const float p = v[k] * v[l] * c.Xc[k][l];
      quad += p;
#pragma unroll
      for (int u = 0; u < JN; ++u)
        if (J0 + u != k && J0 + u != l) lq[u] += p;
    }
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
  const float llt = no_ll ? tr : logf(det) + tr;

#pragma unroll
  for (int u = 0; u < JN; ++u) {
    const int j = J0 + u;
    cf wj[R], zj[R][2];
    float t4[NT4];
    const float xij = source_post<J, R, REAL, NS>(
        c, j, rk[j], v[j], sig, a, d, sb, rinv, y0, y1, la[u], ld[u], lbr[u],
        lbi[u], llin[u], lq[u], fast, eps, wj, zj, t4);
    out(u, j, wj, zj, t4);
    xi[j * FN] = xij;
  }
  return llt;
}

// One block of four warps owns one (b, f) row, as in FRAMES, over tiles of
// TF = 128 / G frames (Wide). Phase 1, G lanes a frame, each its sources'
// part of the arithmetic (wide_terms); the lanes of one half of the
// sources are whole warps, so each warp runs code specialised for its
// half. A frame past N writes zeros, so it adds nothing to any sum. The
// T4 terms of a tile go through shuffle trees, all at once after the
// sources, into the warp's totals (shared memory; in tile order). Phase 2
// is FRAMES' over the tile's quads; at the end of the row the T4 totals of
// the warps of a half are added in warp order.
template <int J, int R, bool REAL, bool NS>
__global__ void __launch_bounds__(kGenThreads, Wide<J, R, REAL, NS>::MIN_BLOCKS)
    estep_wide_kernel(Args g) {
  using S = Slots<J, R>;
  using FT = Feats<J, R, REAL>;
  using WP = Wide<J, R, REAL, NS>;
  constexpr int ST = WP::ST, TF = WP::TF, JH = WP::JH, NT4 = S::NT4;
  constexpr int W7 = REAL ? 1 : 2;
  __shared__ Row<J, R> c;
  // phase 2's owners: j | k << 8, Tss (Slots::pair order) then T7 (offd)
  __shared__ unsigned short own[S::PAIRS + S::OFFD];
  __shared__ float llw[kGenWarps];
  __shared__ float t4w[kGenWarps][JH * NT4];  // the warps' T4 totals
  // the tile's features [WP::ROWS][ST]; at the end of the row, the
  // threads' totals [WP::TOTS][kGenThreads] and the row's sums
  extern __shared__ __align__(16) float feats[];
  static_assert(!S::REG && WP::G >= 1 && WP::G <= 2 && WP::MIN_BLOCKS >= 1 &&
                    TF % 32 == 0 && J * R * 2 <= kGenThreads && J <= 32,
                "WIDE: whole warps a half; one thread per mixing entry and "
                "per source's Txs");

  const int F = g.F, N = g.N;
  const int row = blockIdx.x;  // b * F + f
  const int b = row / F;
  const int f = row - b * F;
  const size_t FN = (size_t)F * N;
  const int tid = threadIdx.x;
  const int fr = tid % TF, h = tid / TF;  // this lane's frame, its half
  const int lane = tid & 31, warp = tid >> 5;

  const Ranks<J, R> rk{g.rank_mask};

  for (int o = tid; o < S::PAIRS + S::OFFD; o += kGenThreads) {
    int j = 0, k = 0;
    if (o < S::PAIRS) {  // j <= k, row-major
      int m = o;
      while (m >= J - j) m -= J - j++;
      k = j + m;
    } else {
      const int m = o - S::PAIRS;
      j = m / (J - 1);
      k = m % (J - 1);
      k += k >= j;
    }
    own[o] = (unsigned short)(j | k << 8);
  }
  for (int i = tid; i < kGenWarps * JH * NT4; i += kGenThreads)
    (&t4w[0][0])[i] = 0.f;
  // the first tile's x4 and v, loaded while the row's constants are built
  const float* xrow = g.x4 + (size_t)b * 4 * FN + (size_t)f * N;
  const float* vrow = g.v + (size_t)b * J * FN + (size_t)f * N;
  float px[4], pv[J];
  {
    const bool valid = fr < N;
#pragma unroll
    for (int q = 0; q < 4; ++q) px[q] = valid ? xrow[q * FN + fr] : 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) pv[j] = valid ? vrow[j * FN + fr] : 0.f;
  }
  row_constants<J, R, REAL>(c, g.A4 + ((size_t)b * J * F + f) * 4 * R,
                            (size_t)F * 4 * R, rk, g.sigma[row], tid);

  float* xirow = g.xi + (size_t)b * J * FN + (size_t)f * N;
  const float sig = c.sig;
  const float eps = g.eps;
  const bool fast = g.fast_recip;

  float tot_tss[WP::N_TSS][2 * R * R], tot_t7[WP::N_T7][2 * R * W7],
      tot_src[WP::N_SRC][4 * R];
#pragma unroll
  for (int i = 0; i < WP::N_TSS; ++i)
#pragma unroll
    for (int s = 0; s < 2 * R * R; ++s) tot_tss[i][s] = 0.f;
#pragma unroll
  for (int i = 0; i < WP::N_T7; ++i)
#pragma unroll
    for (int s = 0; s < 2 * R * W7; ++s) tot_t7[i][s] = 0.f;
#pragma unroll
  for (int i = 0; i < WP::N_SRC; ++i)
#pragma unroll
    for (int s = 0; s < 4 * R; ++s) tot_src[i][s] = 0.f;
  float ll_acc = 0.f;  // lanes of half 0: their frames' loglik terms

  float* col = feats + fr;  // this lane's frame of the tile
  for (int n0 = 0; n0 < N; n0 += TF) {
    const int n = n0 + fr;
    const bool valid = n < N;

    // -- phase 1, G lanes a frame -------------------------------------------
    const cf x0{px[0], px[1]}, x1{px[2], px[3]};
    float v[J];
#pragma unroll
    for (int j = 0; j < J; ++j) v[j] = pv[j];
    auto phase1 = [&](auto half) {
      constexpr int J0 = decltype(half)::value * JH;
      constexpr int JN = J - J0 < JH ? J - J0 : JH;
      float t4v[JN][NT4];  // the lane's T4 terms of the tile's frame
      if (valid) {
        if constexpr (J0 == 0) {
          col[(FT::X + 0) * ST] = x0.re;
          col[(FT::X + 1) * ST] = x0.im;
          col[(FT::X + 2) * ST] = x1.re;
          col[(FT::X + 3) * ST] = x1.im;
        }
        const float llt = wide_terms<J, R, REAL, NS, J0, JN>(
            c, rk, x0, x1, v, sig, eps, fast, g.no_ll, xirow + n, FN,
            [&](int u, int j, const cf(&wj)[R], const cf(&zj)[R][2],
                const float(&t4)[NT4]) {
              float* p = col + WP::blk(j) * ST;
              const float vj = v[j];
              p[FT::V * ST] = vj;
#pragma unroll
              for (int r = 0; r < R; ++r) {  // u_jr = v_j w_jr, y = v_j z
                p[(FT::W + 2 * r) * ST] = vj * wj[r].re;
                p[(FT::W + 2 * r + 1) * ST] = vj * wj[r].im;
#pragma unroll
                for (int ch = 0; ch < 2; ++ch) {
                  p[FT::zre(r, ch) * ST] = vj * zj[r][ch].re;
                  if constexpr (!REAL)
                    p[FT::zim(r, ch) * ST] = vj * zj[r][ch].im;
                }
              }
#pragma unroll
              for (int q = 0; q < NT4; ++q) t4v[u][q] = t4[q];
            });
        if constexpr (J0 == 0) ll_acc += llt;
      } else {  // a frame past N: its features 0, so it adds nothing
        if constexpr (J0 == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) col[(FT::X + e) * ST] = 0.f;
        }
#pragma unroll 1
        for (int e = WP::blk(J0); e < WP::blk(J0 + JN); ++e) col[e * ST] = 0.f;
#pragma unroll
        for (int u = 0; u < JN; ++u)
#pragma unroll
          for (int q = 0; q < NT4; ++q) t4v[u][q] = 0.f;
      }
      // the warp's sums of the T4 terms, every shuffle tree at once, into
      // the warp's totals
#pragma unroll
      for (int u = 0; u < JN; ++u)
#pragma unroll
        for (int q = 0; q < NT4; ++q) t4v[u][q] = warp_sum(t4v[u][q]);
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < JN; ++u)
#pragma unroll
          for (int q = 0; q < NT4; ++q) t4w[warp][u * NT4 + q] += t4v[u][q];
      }
    };
    if constexpr (WP::G == 1) {
      phase1(std::integral_constant<int, 0>());
    } else {
      if (h == 0)
        phase1(std::integral_constant<int, 0>());
      else
        phase1(std::integral_constant<int, 1>());
    }
    __syncthreads();

    // -- phase 2, each thread its owners over its group's frames --------------
    const int quads = (min(TF, N - n0) + 3) >> 2;
    auto span = [&](int L, int& q0) {
      const int per = (quads + kGenThreads / L - 1) / (kGenThreads / L);
      q0 = tid / L * per;
      return min(per, quads - q0);
    };
#pragma unroll
    for (int i = 0; i < WP::N_TSS; ++i) {
      constexpr int L = WP::L_TSS;
      const int o = i * L + tid % L;
      int q0;
      const int nq = span(L, q0), f0 = 4 * q0;
      if (o < WP::O_TSS && nq > 0) {
        const int jk = own[o];
        wide_tss<J, R, REAL, NS, ST>(feats + WP::blk(jk & 255) * ST + f0,
                                     feats + WP::blk(jk >> 8) * ST + f0, nq,
                                     sig, tot_tss[i]);
      }
    }
    // the next tile's x4 and v load while T7 and the sources' sums run
    {
      const int nn = n + TF;
      const bool vn = nn < N;
#pragma unroll
      for (int q = 0; q < 4; ++q) px[q] = vn ? xrow[q * FN + nn] : 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) pv[j] = vn ? vrow[j * FN + nn] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < WP::N_T7; ++i) {
      constexpr int L = WP::L_T7;
      const int o = i * L + tid % L;
      int q0;
      const int nq = span(L, q0), f0 = 4 * q0;
      if (o < WP::O_T7 && nq > 0) {
        const int jk = own[S::PAIRS + o];
        wide_t7<J, R, REAL, ST>(feats + WP::blk(jk & 255) * ST + f0,
                                feats + WP::blk(jk >> 8) * ST + f0, nq,
                                tot_t7[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < WP::N_SRC; ++i) {
      constexpr int L = WP::L_SRC;
      const int o = i * L + tid % L;
      int q0;
      const int nq = span(L, q0), f0 = 4 * q0;
      if (o < WP::O_SRC && nq > 0)
        wide_txs<J, R, REAL, NS, ST>(feats + WP::blk(o) * ST + f0,
                                     feats + FT::X * ST + f0, nq, sig,
                                     tot_src[i]);
    }
    __syncthreads();  // the tile is free for the next one's features
  }

  // -- the row's sums ----------------------------------------------------------
#pragma unroll
  for (int i = 0; i < WP::N_TSS; ++i)
#pragma unroll
    for (int s = 0; s < 2 * R * R; ++s)
      feats[(WP::TOT_TSS + i * WP::U_TSS + s) * kGenThreads + tid] =
          tot_tss[i][s];
#pragma unroll
  for (int i = 0; i < WP::N_T7; ++i)
#pragma unroll
    for (int s = 0; s < 2 * R * W7; ++s)
      feats[(WP::TOT_T7 + i * WP::U_T7 + s) * kGenThreads + tid] =
          tot_t7[i][s];
#pragma unroll
  for (int i = 0; i < WP::N_SRC; ++i)
#pragma unroll
    for (int s = 0; s < 4 * R; ++s)
      feats[(WP::TOT_SRC + i * WP::U_SRC + s) * kGenThreads + tid] =
          tot_src[i][s];
  ll_acc = warp_sum(ll_acc);
  if (lane == 0) llw[warp] = ll_acc;
  __syncthreads();

  auto total = [&](auto lanes, int base, int sums, int o, int s) {
    constexpr int L = decltype(lanes)::value;
    const float* p = feats + (base + (o / L) * sums + s) * kGenThreads +
                     o % L;
    float t = p[0];
#pragma unroll
    for (int g0 = L; g0 < kGenThreads / L * L; g0 += L) t += p[g0];
    return t;
  };
  using LTss = std::integral_constant<int, WP::L_TSS>;
  using LT7 = std::integral_constant<int, WP::L_T7>;
  using LSrc = std::integral_constant<int, WP::L_SRC>;
  constexpr int WH = kGenWarps / WP::G;  // warps a half
  float* red = feats + WP::RED;  // the row's sums, Slots order
  for (int s = tid; s <= S::COUNT; s += kGenThreads) {
    float t;
    if (s == S::LL) {
      t = llw[0];
#pragma unroll
      for (int w2 = 1; w2 < kGenWarps; ++w2) t += llw[w2];
    } else if (s < S::TXS) {  // T4: the warps of source j's half in order
      const int j = (s - S::T4) / NT4, q = (s - S::T4) % NT4;
      const int w0 = j / JH * WH, e = (j % JH) * NT4 + q;
      t = t4w[w0][e];
#pragma unroll
      for (int w2 = 1; w2 < WH; ++w2) t += t4w[w0 + w2][e];
    } else if (s < S::TSS) {
      const int j = (s - S::TXS) / (4 * R);
      t = total(LSrc(), WP::TOT_SRC, WP::U_SRC, j, (s - S::TXS) % (4 * R));
    } else if (s < S::T7) {
      const int o = (s - S::TSS) / (2 * R * R);
      t = total(LTss(), WP::TOT_TSS, WP::U_TSS, o,
                (s - S::TSS) % (2 * R * R));
    } else {  // T7_jk (r, s) = A_jr^H sum_n v_j y_ks
      const int o = (s - S::T7) / (2 * R * R), e = (s - S::T7) % (2 * R * R);
      const int r = (e >> 1) / R, sk = (e >> 1) % R, j = own[S::PAIRS + o] & 255;
      auto zs = [&](int ch, int p) {
        return total(LT7(), WP::TOT_T7, WP::U_T7, o, (sk * 2 + ch) * W7 + p);
      };
      if constexpr (REAL) {
        t = (e & 1) ? 0.f
                    : c.A[j][r][0].re * zs(0, 0) + c.A[j][r][1].re * zs(1, 0);
      } else {
        const cf p = cmul_conj<false>(c.A[j][r][0], cf{zs(0, 0), zs(0, 1)});
        const cf u = cmul_conj<false>(c.A[j][r][1], cf{zs(1, 0), zs(1, 1)});
        t = (e & 1) ? p.im + u.im : p.re + u.re;
      }
    }
    red[s] = t;
  }
  __syncthreads();
  write_outputs<J, R, REAL>(g, red, rk, b, f, row, tid);
}

using Kernel = void (*)(Args);

// An instantiation and its launch's dynamic shared bytes.
struct Pick {
  Kernel kernel;
  size_t smem;
};

template <int J, int R, bool REAL, bool NS>
Pick pick_one() {
  if constexpr (Slots<J, R>::REG)
    return Pick{&estep_reg_kernel<J, R, REAL, NS>, 0};
  else if constexpr (Wide<J, R, REAL, NS>::G > 0)
    return Pick{&estep_wide_kernel<J, R, REAL, NS>,
                Wide<J, R, REAL, NS>::BYTES};
  else
    return Pick{&estep_frames_kernel<J, R, REAL, NS>,
                Split<J, R, REAL, NS>::BYTES};
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
