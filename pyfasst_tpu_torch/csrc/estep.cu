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
// What bounds it on an H100: per bin it reads x4 (16 B) and v (4 B per
// source) and writes xi (4 B per source), 32 B at J = 2: at the bench
// shapes (B = 8, F = 513, N = 863: 3.5 M bins, 113 MB) ~34 us at
// 3.35 TB/s, and memory bounds it on paper. In fact the instruction stream
// does: built with --fmad=false, one tile of 32 bins is ~500 machine
// instructions of a warp at J = 2 (kernel_sass.py: 152 multiplies, 92
// adds, seven exact divides and a logf at ~8 each with a branch to their
// slow path, 6 loads, 2 stores, ~110 of addresses, moves and branches),
// 110,808 tiles: 105 K issue cycles of each of the card's 528 schedulers,
// 53-60 us at 1.98-1.75 GHz. The kernel runs within a few us of that
// (PERF.md), so what is left to it is to issue fewer instructions: the
// design keeps loads in flight and the schedulers full, and carries no
// sum, term or barrier it can do without.
//
// Design. The Pallas kernel sums the frame reductions by revisiting output
// blocks across a grid that runs in order; GPU blocks run in no order, so
// here one block of four warps owns one (b, f) row of the plane. Its warps
// take the row's tiles of 32 frames in turn (warp w: tiles w, w + 4, ...),
// lane = frame, so every load of x4 and v and every store of xi is
// coalesced, and no lane reads or writes past N (a lane past N asks for
// nothing and skips its bin).
//   - Loads in flight: a lane asks for the 4 + J words of its next kDepth
//     tiles before it works on the current one, so a warp always has
//     kDepth x (4 + J) x 128 B on their way: at J = 2 and 28 resident warps
//     21 KB per SM per tile of depth. The row's mixing columns and sigma
//     (2J + 1 words, the same for every lane: one broadcast load each) are
//     asked for after the first tiles, in the same round trip, and each
//     lane forms the row's invariants from them in registers.
//   - Only the distinct frame sums are carried: Txs (4J), T4 (J), Re Tss_jk
//     for j <= k, Im Tss_jk for j < k, and T7_jk for j != k: 16 at J = 2
//     and 30 at J = 3, beside the loglik (the outputs hold 22 and 42).
//     Tss_kj = conj(Tss_jk) and Im Tss_jj = 0 hold bit for bit, since both
//     sides are formed from the same rounded products, so the mirrored
//     words are written from the carried sums (0 - Im for the conjugate,
//     which keeps +0 where the sum is +0). T7_jk and T7_kj agree in exact
//     arithmetic only (the Pallas kernel sums each on its own), so both
//     are carried.
//   - Each lane keeps its sums over its frames in registers. At the end of
//     the row a warp adds them over its lanes by a halving butterfly: at
//     the step of lane distance 16 the lower half-warp keeps the first half
//     of the sums and the upper half the second, each adding its partner's,
//     and so on at 8, 4, 2, 1. That is one balanced shuffle tree per sum, in
//     a fixed order (the pairing of __shfl_down's tree), in 16 + 8 + 4 + 2
//     + 1 shuffles instead of 5 per sum; sum s ends in lane s (32 sums) or
//     lanes 2s, 2s + 1 (16 sums).
//   - The four warps' totals meet in shared memory behind the kernel's one
//     barrier; then thread t forms output word t of the row (the warps
//     added in warp order) and writes it: 33 words at J = 2, 61 at J = 3,
//     one thread each, the zeros of the packed layout included.
//   - Few rows (the ERBlet plane: B F = 48 rows of N = 98304 frames): a
//     launch of one block per row would leave most of the card's warp
//     schedulers without a warp, each warp walking hundreds of tiles in
//     series. Below kSplitBlocks<J> / 2 rows, each row's frames are cut
//     into S = kSplitBlocks<J> / (B F) segments of whole 128-frame groups,
//     at least kSegGroups groups each (plan_segments; only the last
//     segment is ragged), one block each (grid.y), so the launch still
//     fits one wave of resident blocks. A segment's block runs the loop,
//     butterfly and warp sums above over its frames and writes its totals
//     to a scratch buffer the wrapper allocates; a second kernel
//     (sum_segments_kernel) adds the segments in index order and writes
//     the row's words as above. The plan is a function of (B F, N, J)
//     only, never of the card, so the order of every sum and the bits are
//     the same on any card; at S = 1 the one-pass kernel runs, and its
//     sums keep their order. At erblet48 (S = 19: 912 blocks) the split
//     takes the kernel from 0.476 to 0.080 ms on an H100 (PERF.md).
//   - The sums of Sigma_x and of each S_j start from their first term, and
//     X_jj, exactly 0 at rank 1, is left out of the quadratic terms (at
//     J = 2 the leave-one-out det has none): the values of sums that start
//     from 0 and add it, since x + 0 = x, in ~30 fewer instructions a bin.
//   No atomics: results are the same from run to run.
//   __launch_bounds__(128, 7) at J = 2 holds a thread to 72 registers, so
//   seven blocks (28 warps) are resident per SM, without spill;
//   chip_smoke.py phase 1 prints what the runtime reports.
//
// Numerics follow the Pallas forms: exact IEEE divides (1.0f / x; with
// fast_recip the Pallas _recip at its three sites) and logf,
// coef = 1 / (1 + v M00). Build without --use_fast_math: sigma reaches
// ~3e-6 of the mean power, and approximate divides, flushed denormals or
// __logf would move the statistics. Build with --fmad=false: y = adj x / det
// cancels in some bins, and a product fused into an FMA rounds differently
// there from the plain version (measured 3.7e-4 relative on xi at the bench
// shapes with contraction on); without it the exact zeros of X_jj (rank 1)
// and Im Tss_jj also hold. xi has no sum in it: it equals the plain
// version's bit for bit on the card.
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

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;  // frames per warp tile: lane = frame
constexpr int kDepth = 1;  // tiles a lane has asked for ahead of its own

// Resident blocks per SM asked of ptxas: 7 (at most 72 registers) at J = 2.
template <int J>
constexpr int kMinBlocks = J == 2 ? 7 : 4;

// Blocks of one wave on an H100 (132 SMs, kMinBlocks<J> resident on
// each): a launch of fewer rows than half this splits its rows' frames,
// into segments of at least kSegGroups groups of kThreads frames (a split
// of short rows costs more in its second pass than it saves: 0.0055 ->
// 0.0072 ms on an H100 at 257 rows of 3 groups, kernel_compare.py).
template <int J>
constexpr int kSplitBlocks = kMinBlocks<J> * 132;
constexpr int kSegGroups = 8;
constexpr int kSumThreads = 64;  // the second pass: one block a row

constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }
constexpr int log2_of(int p) { return p <= 1 ? 0 : 1 + log2_of(p / 2); }

// The distinct frame sums of one (b, f) row.
template <int J>
struct Slots {
  static constexpr int TXS = 0;                        // 4 per source
  static constexpr int T4 = TXS + 4 * J;               // 1 per source
  static constexpr int TSR = T4 + J;                   // Re Tss_jk, j <= k
  static constexpr int TSI = TSR + J * (J + 1) / 2;    // Im Tss_jk, j < k
  static constexpr int T7 = TSI + J * (J - 1) / 2;     // T7_jk, j != k
  static constexpr int COUNT = T7 + J * (J - 1);
  static constexpr int P = pow2_ceil(COUNT);  // sums the butterfly folds
  static_assert(P <= 32, "the butterfly folds at most one sum per lane");
  static constexpr bool LL_IN = COUNT < P;  // a free slot for the loglik
  static constexpr int LL = COUNT;            // its place in the block's sums
  static constexpr int SHIFT = 5 - log2_of(P);  // sum s ends in lane s << SHIFT
  // output words of a row: ll, txs, t4, tss, t7
  static constexpr int NOUT = 1 + 8 * J + 4 * J * J;
  __device__ static constexpr int pair(int j, int k) {   // j <= k
    return j * J - j * (j - 1) / 2 + (k - j);
  }
  __device__ static constexpr int upper(int j, int k) {  // j < k
    return j * J - j * (j + 1) / 2 + (k - j - 1);
  }
  __device__ static constexpr int offd(int j, int k) {   // j != k
    return j * (J - 1) + (k < j ? k : k - 1);
  }
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
// the frame sums in acc and to the loglik sum ll.
template <int J>
__device__ __forceinline__ void bin_update(const RowConst<J>& c,
                                           float x0r, float x0i,
                                           float x1r, float x1i,
                                           const float (&v)[J], float eps,
                                           bool fast, bool no_ll,
                                           float (&xi_out)[J],
                                           float (&acc)[Slots<J>::P],
                                           float& ll) {
  using S = Slots<J>;
  const float sig = c.sig;

  // Sigma_x = sig I + sum_j v_j R_j and its subtract-free determinant. The
  // sums start from their first term and leave out X_jj, which is exactly 0
  // at rank 1: the same values as sums that start from 0 and add it, in
  // fewer instructions.
  float sa = v[0] * c.Ra[0], sd = v[0] * c.Rd[0], sb = v[0] * c.Rb[0];
  float lin = v[0] * c.trR[0], quad = v[0] * v[1] * c.Xc[0][1];
#pragma unroll
  for (int j = 1; j < J; ++j) {
    sa += v[j] * c.Ra[j];
    sd += v[j] * c.Rd[j];
    sb += v[j] * c.Rb[j];
    lin += v[j] * c.trR[j];
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < J; ++k)
      if (k != j && (j > 0 || k > 1)) quad += v[j] * v[k] * c.Xc[j][k];
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
  ll += no_ll ? tr : logf(det) + tr;

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
    // (sums from their first term, k = k0; no X_kk; no quadratic term at
    // J = 2, where one source is left)
    const int k0 = j == 0 ? 1 : 0;
    float la = v[k0] * c.Ra[k0], ld = v[k0] * c.Rd[k0];
    float lb = v[k0] * c.Rb[k0], llin = v[k0] * c.trR[k0];
#pragma unroll
    for (int k = 0; k < J; ++k) {
      if (k == j || k == k0) continue;
      la += v[k] * c.Ra[k];
      ld += v[k] * c.Rd[k];
      lb += v[k] * c.Rb[k];
      llin += v[k] * c.trR[k];
    }
    float detS = sig * sig + sig * llin;
    if constexpr (J > 2) {
      float lquad = 0.f;
#pragma unroll
      for (int k = 0; k < J; ++k) {
#pragma unroll
        for (int l = 0; l < J; ++l) {
          if (k == j || l == j || k == l) continue;
          lquad += v[k] * v[l] * c.Xc[k][l];
        }
      }
      detS = detS + 0.5f * lquad;
    }
    const float aS = sig + la;
    const float dS = sig + ld;
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

  // Tss_jk for j <= k (Im only for j < k) and T7_jk for j != k
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < J; ++k) {
      const float vv = v[j] * v[k];
      if (k >= j) {
        const float re = wr[j] * wr[k] + wi[j] * wi[k];
        acc[S::TSR + S::pair(j, k)] += vv * re;
      }
      if (k > j) {
        const float im = wi[j] * wr[k] - wr[j] * wi[k];
        acc[S::TSI + S::upper(j, k)] += vv * im;
      }
      if (k != j) {
        const float m = c.a0[j] * u0[k] + c.a1[j] * u1[k];
        acc[S::T7 + S::offd(j, k)] += vv * m;
      }
    }
  }
}

// The warp's sum of each of a's first C entries over the lanes, by halving:
// at lane distance OFF the lanes with that bit clear keep the first half of
// the entries and the others the second half, each adding its partner's;
// once one entry is left, the remaining distances add it plainly. Entry s of
// P ends in a[0] of the lanes s << (5 - log2 P) and above.
template <int C, int OFF, int P>
__device__ __forceinline__ void fold(float (&a)[P], int lane) {
  if constexpr (OFF > 0) {
    if constexpr (C > 1) {
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < C / 2; ++i) {
        const float keep = up ? a[i + C / 2] : a[i];
        const float send = up ? a[i] : a[i + C / 2];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      fold<C / 2, OFF / 2, P>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], OFF);
      fold<1, OFF / 2, P>(a, lane);
    }
  }
}

// Output word t of row `row` = b F + f from the row's totals total(s)
// (Slots order, the loglik at Slots::LL): ll, then txs, t4, tss and t7 in
// their packed layouts.
template <int J, class Total>
__device__ __forceinline__ void write_word(int t, const Total& total, int b,
                                           int f, int row, int F,
                                           float* __restrict__ txs,
                                           float* __restrict__ tss,
                                           float* __restrict__ t4,
                                           float* __restrict__ t7,
                                           float* __restrict__ ll) {
  using S = Slots<J>;
  int i = t - 1;
  if (t == 0) {
    ll[row] = total(S::LL);
  } else if (i < 8 * J) {  // txs, then t4: 4 words per source
    const bool is_t4 = i >= 4 * J;
    if (is_t4) i -= 4 * J;
    const int j = i >> 2, q = i & 3;
    const size_t o = (((size_t)b * J + j) * F + f) * 4 + q;
    if (is_t4)
      t4[o] = q == 0 ? total(S::T4 + j) : 0.f;
    else
      txs[o] = total(S::TXS + i);
  } else {                 // tss, then t7: (re, im) per (j, k)
    i -= 8 * J;
    const bool is_t7 = i >= 2 * J * J;
    if (is_t7) i -= 2 * J * J;
    const int jk = i >> 1, im = i & 1;
    const int j = jk / J, k = jk - j * J;
    const size_t o = ((((size_t)b * J + j) * J + k) * F + f) * 2 + im;
    if (is_t7) {
      t7[o] = (im == 0 && j != k) ? total(S::T7 + S::offd(j, k)) : 0.f;
    } else if (im == 0) {
      tss[o] = total(S::TSR + (j <= k ? S::pair(j, k) : S::pair(k, j)));
    } else if (j == k) {
      tss[o] = 0.f;
    } else if (j < k) {
      tss[o] = total(S::TSI + S::upper(j, k));
    } else {               // Tss_jk = conj(Tss_kj)
      tss[o] = 0.f - total(S::TSI + S::upper(k, j));
    }
  }
}

// One block per (row, segment): SPLIT = false takes the whole row (grid.x
// = B F) and writes its words; SPLIT = true the frames [y seg, (y + 1) seg)
// of its row (grid (B F, S)), and writes the segment's totals, Slots order
// with the loglik last, to ws[(row S + y) (COUNT + 1) + s].
template <int J, bool SPLIT>
__global__ void __launch_bounds__(kThreads, kMinBlocks<J>)
estep_r1_real_kernel(const float* __restrict__ x4, const float* __restrict__ v,
                     const float* __restrict__ A,
                     const float* __restrict__ sigma, float* __restrict__ xi,
                     float* __restrict__ txs, float* __restrict__ tss,
                     float* __restrict__ t4, float* __restrict__ t7,
                     float* __restrict__ ll, float* __restrict__ ws, int F,
                     int N, int seg, float eps, bool fast, bool no_ll) {
  using S = Slots<J>;
  __shared__ float red[kWarps][S::COUNT + 1];  // the warps' sums, ll last

  const int row = blockIdx.x;            // b * F + f
  const int b = row / F;
  const int f = row - b * F;
  const size_t FN = (size_t)F * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this block's frames [lo, hi): the row, or one segment of it
  const int lo = SPLIT ? (int)blockIdx.y * seg : 0;
  const int hi = SPLIT ? min(N, lo + seg) : N;

  const float* xrow = x4 + (size_t)b * 4 * FN + (size_t)f * N;
  const float* vrow = v + (size_t)b * J * FN + (size_t)f * N;
  float* xirow = xi + (size_t)b * J * FN + (size_t)f * N;

  // The lane's next kDepth frames, asked for ahead of their turn.
  float px[kDepth][4], pv[kDepth][J];
  auto ask = [&](int d, int n) {
    const bool in = n < hi;
#pragma unroll
    for (int q = 0; q < 4; ++q) px[d][q] = in ? xrow[q * FN + n] : 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) pv[d][j] = in ? vrow[j * FN + n] : 0.f;
  };
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    ask(d, lo + warp * kTile + d * kThreads + lane);

  RowConst<J> c;
  row_constants<J>(c, A + ((size_t)b * J * F + f) * 2, (size_t)F * 2,
                   sigma[row]);

  float acc[S::P];
#pragma unroll
  for (int i = 0; i < S::P; ++i) acc[i] = 0.f;
  float ll_sum = 0.f;

  for (int n0 = lo + warp * kTile; n0 < hi; n0 += kDepth * kThreads) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int n = n0 + d * kThreads + lane;
      float x[4], vn[J], xin[J];
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = px[d][q];
#pragma unroll
      for (int j = 0; j < J; ++j) vn[j] = pv[d][j];
      ask(d, n + kDepth * kThreads);
      if (n < hi) {
        bin_update<J>(c, x[0], x[1], x[2], x[3], vn, eps, fast, no_ll, xin,
                      acc, ll_sum);
#pragma unroll
        for (int j = 0; j < J; ++j) xirow[j * FN + n] = xin[j];
      }
    }
  }

  // The warp's sums over its lanes, then the four warps' in shared memory.
  // The loglik rides in the butterfly where that has a free slot.
  if constexpr (S::LL_IN) acc[S::LL_IN ? S::LL : 0] = ll_sum;
  fold<S::P, 16, S::P>(acc, lane);
  if ((lane & ((1 << S::SHIFT) - 1)) == 0 &&
      (lane >> S::SHIFT) < S::COUNT + (S::LL_IN ? 1 : 0))
    red[warp][lane >> S::SHIFT] = acc[0];
  if constexpr (!S::LL_IN) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ll_sum += __shfl_xor_sync(0xffffffffu, ll_sum, off);
    if (lane == 0) red[warp][S::LL] = ll_sum;
  }
  __syncthreads();

  // Sum s of the block: the warps added in warp order.
  auto total = [&](int s) {
    float t = red[0][s];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += red[w][s];
    return t;
  };
  if constexpr (SPLIT) {
    float* out = ws + ((size_t)row * gridDim.y + blockIdx.y) * (S::COUNT + 1);
    for (int s = threadIdx.x; s <= S::COUNT; s += kThreads) out[s] = total(s);
  } else {
    for (int t = threadIdx.x; t < S::NOUT; t += kThreads)
      write_word<J>(t, total, b, f, row, F, txs, tss, t4, t7, ll);
  }
}

// The second pass of a split launch: row blockIdx.x's sums, its S
// segments' totals added in segment order, then its words as the one-pass
// kernel writes them.
template <int J>
__global__ void __launch_bounds__(kSumThreads)
sum_segments_kernel(const float* __restrict__ ws, float* __restrict__ txs,
                    float* __restrict__ tss, float* __restrict__ t4,
                    float* __restrict__ t7, float* __restrict__ ll, int F,
                    int S) {
  constexpr int C = Slots<J>::COUNT + 1;
  __shared__ float sums[C];
  const int row = blockIdx.x;
  const int b = row / F;
  const int f = row - b * F;
  const float* in = ws + (size_t)row * S * C;
  for (int s = threadIdx.x; s < C; s += kSumThreads) {
    float t = in[s];
    for (int g = 1; g < S; ++g) t += in[g * C + s];
    sums[s] = t;
  }
  __syncthreads();
  auto total = [&](int s) { return sums[s]; };
  for (int t = threadIdx.x; t < Slots<J>::NOUT; t += kSumThreads)
    write_word<J>(t, total, b, f, row, F, txs, tss, t4, t7, ll);
}

// Segments of each row's N frames for a launch of `rows` = B F rows at J
// sources: S = kSplitBlocks<J> / rows, at most one per kSegGroups groups
// of kThreads frames and at least 1, each of *seg frames (whole groups;
// the last ragged). A function of (rows, N, J) alone.
template <int J>
int plan_segments(long long rows, int N, int* seg) {
  const int groups = (N + kThreads - 1) / kThreads;
  long long S = kSplitBlocks<J> / rows;
  if (S > groups / kSegGroups) S = groups / kSegGroups;
  if (S < 1) S = 1;
  const int per = (int)((groups + S - 1) / S);
  *seg = per * kThreads;
  return (groups + per - 1) / per;
}

template <int J>
cudaError_t launch(const float* x4, const float* v, const float* A,
                   const float* sigma, float* xi, float* txs, float* tss,
                   float* t4, float* t7, float* ll, float* ws, int B, int F,
                   int N, float eps, bool fast, bool no_ll,
                   cudaStream_t stream) {
  const int rows = B * F;
  int seg;
  const int S = plan_segments<J>(rows, N, &seg);
  if (S == 1) {
    estep_r1_real_kernel<J, false><<<rows, kThreads, 0, stream>>>(
        x4, v, A, sigma, xi, txs, tss, t4, t7, ll, ws, F, N, N, eps, fast,
        no_ll);
    return cudaGetLastError();
  }
  if (ws == nullptr) return cudaErrorInvalidValue;
  estep_r1_real_kernel<J, true><<<dim3(rows, S), kThreads, 0, stream>>>(
      x4, v, A, sigma, xi, txs, tss, t4, t7, ll, ws, F, N, seg, eps, fast,
      no_ll);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_segments_kernel<J><<<rows, kSumThreads, 0, stream>>>(ws, txs, tss, t4,
                                                           t7, ll, F, S);
  return cudaGetLastError();
}

// [resident warps per SM, registers per thread, local bytes per thread,
// static shared bytes per block] of estep_r1_real_kernel<J>.
template <int J>
cudaError_t info(int* out) {
  auto kernel = estep_r1_real_kernel<J, false>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                    0);
  if (e != cudaSuccess) return e;
  out[0] = blocks * kWarps;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)attr.sharedSizeBytes;
  return cudaSuccess;
}

}  // namespace

// C entry points, bound with ctypes (ops/cuda_estep.py, ops/_build.py). The
// E-step launches on `stream`, does not synchronise, allocates nothing: a
// launch that splits its rows' frames needs `ws`, the number of floats
// pyfasst_estep_r1_real_workspace gives (null where that is 0), and
// pyfasst_estep_r1_real_segments gives its S. The info call writes the
// one-pass kernel's occupancy and resources for J sources. The launch and
// the info call return a cudaError_t: 0 on success.
extern "C" int pyfasst_estep_r1_real(const float* x4, const float* v,
                                     const float* A, const float* sigma,
                                     float* xi, float* txs, float* tss,
                                     float* t4, float* t7, float* ll,
                                     float* ws, int B, int J, int F, int N,
                                     float eps, int fast_recip, int no_ll,
                                     void* stream) {
  if (B <= 0 || F <= 0 || N <= 0 || (long long)B * F > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fast = fast_recip != 0, nl = no_ll != 0;
  switch (J) {
    case 2:
      return (int)launch<2>(x4, v, A, sigma, xi, txs, tss, t4, t7, ll, ws, B,
                            F, N, eps, fast, nl, s);
    case 3:
      return (int)launch<3>(x4, v, A, sigma, xi, txs, tss, t4, t7, ll, ws, B,
                            F, N, eps, fast, nl, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Segments S of each row at this shape (1: no split); -1 for a shape the
// kernel refuses.
extern "C" int pyfasst_estep_r1_real_segments(int B, int J, int F, int N) {
  if (B <= 0 || F <= 0 || N <= 0 || (long long)B * F > 2147483647LL)
    return -1;
  int seg;
  switch (J) {
    case 2:
      return plan_segments<2>((long long)B * F, N, &seg);
    case 3:
      return plan_segments<3>((long long)B * F, N, &seg);
    default:
      return -1;
  }
}

// Floats of scratch the launch at this shape needs: B F x S x (its sums
// and the loglik), 0 unsplit; -1 for a shape the kernel refuses.
extern "C" long long pyfasst_estep_r1_real_workspace(int B, int J, int F,
                                                     int N) {
  const int S = pyfasst_estep_r1_real_segments(B, J, F, N);
  if (S < 0) return -1;
  const int sums = J == 2 ? Slots<2>::COUNT + 1 : Slots<3>::COUNT + 1;
  return S == 1 ? 0 : (long long)B * F * S * sums;
}

extern "C" int pyfasst_estep_r1_real_info(int J, int* out) {
  switch (J) {
    case 2:
      return (int)info<2>(out);
    case 3:
      return (int)info<3>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
