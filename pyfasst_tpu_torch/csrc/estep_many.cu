// Fused GEM E-step for I = 2 channels at J >= 17 sources, J an argument of
// the launch: CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pyfasst_tpu/ops/pallas_estep.py::_make_kernel
// (body :108, launched by pallas_estep at :449) at the source counts past
// estep_general.cuh's compile-time instantiations (J = 2 to 16), in every
// variant that file takes: a's model (real rank-1 mixing), b (complex
// mixing), c (rank 2, mixed ranks), d ('ann_ns_inj'), each with the flags e
// (fast_recip) and f (no_ll). Per (f, n) bin it computes what
// estep_general.cuh computes, in the same forms term by term (see that
// file's head): the subtract-free dets of Sigma_x and of each leave-one-out
// S_j, the rank-2 dG clamp with coef = (g00 + g11) / dG, exact IEEE divides
// and logf, built with --fmad=false; xi has no sum in it and keeps the
// plain version's bits. Nothing of size J lives in registers: J is read at
// run time, so one build serves every J (the ranks travel as a bit mask of
// kMaxSources bits).
//
// Three kernels a call, the frames in chunks of C (a multiple of 32, set by
// (J, F, N, rank, mixing) alone: a clip's features of a chunk take at most
// kChunkBytes of scratch, which the caller allocates; each chunk costs the
// sums kernel a pass over its owners' outputs, so chunks are large: 32 MiB
// took J = 20 rank 2 at (8, 513, 863) 27 chunks and 31.6 ms, 256 MiB 3 and
// 20.1 ms, PERF.md):
//   consts_kernel, one block a (b, f) row, once a call: the row's mixing
//     columns, R_j, tr R_j and the J x J cross terms X_jk into the scratch,
//     and the sources' ranks.
//   frames_kernel, thread = frame, per chunk: Sigma_x, its det, y, the
//     loglik term; per source, in runs of kJC sources, the leave-one-out
//     sums of S_j (each in the order the plain version adds them, which
//     makes the quadratic one O(J^2) a source and O(J^3) a frame, as in the
//     Pallas kernel), then w_jr, z_jr, the posterior, the T4 terms and xi,
//     stored at once; and the frame's features (x and the loglik term, then
//     per source v_j, w_jr, z_jr and the T4 terms, estep_general.cuh's Feats
//     order) into the scratch, feature-major, the chunk's frames
//     contiguous. A frame past N writes zeros: it adds nothing to any sum.
//   sums_kernel, per chunk: every frame sum of the row. The sources fall in
//     tiles of kTileSrc; one block owns one (row, pair of tiles a <= b):
//     Tss_jk (j in a, k in b, j <= k), T7_jk and T7_kj, and on a diagonal
//     pair the tile's Txs and T4 (the first also the loglik): one owner a
//     thread, two where a pair has more owners than threads. The block
//     stages the two tiles' features kFramesT frames at a time in shared
//     memory; each owner adds its products over those frames in order into
//     a partial (estep_general.cuh's tss_item, t7_item, src_item), then the
//     partial into its total. At the chunk's end the owner adds its total
//     to its output words (the first chunk stores it), and at the last one
//     writes the zero padding, Tss_kj = Tss_jk^H and the zero T7_jj.
// Fixed orders over frames and chunks, one owner a word, no atomics: two
// runs give the same bits. Only j <= k of Tss is summed; T7 for every
// j != k.
//
// What bounds it on an H100: per bin it reads x4 (16 B) and v (4 B a
// source) and writes xi (4 B a source), against O(J^3) float32 operations
// a frame in the leave-one-out dets (the plain version's count): bound by
// operations; with --fmad=false the floor is the card's FMA rate halved.
// The leave-one-out loop forms each product (v_k v_l) X_kl once for kJC
// sources' sums; v and X_kl are loads that the L1 serves (no shared memory
// in that kernel, so no limit on J from it). The scratch (features of a
// chunk, the row constants) is written once and read by the sums kernel
// once per pair of tiles a source is in (ceil(J / kTileSrc) times).
//
// Layouts as estep_general.cuh's (B, J, F, N) inputs and packed outputs.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "estep_general.cuh"
#include "recip.cuh"

namespace pyfasst_many {

using pyfasst_general::cabs2;
using pyfasst_general::cf;
using pyfasst_general::cmul_conj;
using pyfasst_general::Feats;
using pyfasst_general::herm_apply;

constexpr int kThreads = 128;
constexpr int kJC = 8;           // frames_kernel: sources a leave-one-out run
constexpr int kTileSrc = 8;      // sums_kernel: sources a tile
constexpr int kFramesT = 32;     // sums_kernel: frames staged a turn
// words per staged feature row: 16-byte rows whose starts step by an odd
// number of 16-byte groups, so a quarter-warp's float4 loads of distinct
// rows fall in distinct banks
constexpr int kStride = kFramesT + 4;
constexpr int kSlots = 2;        // sums_kernel: owners a thread, at most
constexpr int kRankWords = 64;
constexpr int kMaxSources = 64 * kRankWords;
constexpr long long kChunkBytes = 256ll << 20;  // a clip's features a chunk

static_assert(3 * kTileSrc * kTileSrc <= kSlots * kThreads,
              "an off-diagonal pair's owners in kSlots per thread");
static_assert(kFramesT % 32 == 0, "a chunk is whole warps of frames");

template <int I>
using IC = std::integral_constant<int, I>;

// fn(IC<I>()), ..., fn(IC<N - 1>()): an index known at compile time
template <int I, int N, class Fn>
__device__ __forceinline__ void static_for(Fn&& fn) {
  if constexpr (I < N) {
    fn(IC<I>());
    static_for<I + 1, N>(fn);
  }
}

// A frame's features: x0.re x0.im x1.re x1.im and the loglik term, then
// per source a block of Feats' rows (v_j, w_jr, z_jr, the T4 terms).
template <int R, bool REAL>
struct ManyFeats {
  using FT = Feats<1, R, REAL>;
  static constexpr int NT4 = FT::NT4;
  static constexpr int BLK = FT::T4 + NT4;
  static constexpr int LL = 4;
  static constexpr int XW = 5;
  __host__ __device__ static constexpr int count(int J) {
    return XW + J * BLK;
  }
};

// A row's constants in the scratch, in words: mixing columns (j, r, ch)
// as (re, im), R_j's entries, tr R_j, X_jk; padded to whole float4s.
struct Layout {
  int RA, RD, RBR, RBI, TRR, XC, words;
  __host__ __device__ Layout(int J, int R)
      : RA(4 * R * J), RD(RA + J), RBR(RD + J), RBI(RBR + J), TRR(RBI + J),
        XC(TRR + J), words((XC + J * J + 3) & ~3) {}
};

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
  int* ranks;      // scratch: the sources' ranks (J words)
  float* consts;   // scratch: the rows' constants (CW words a row)
  float* feats;    // scratch: the chunk's features (NF x C words a row)
  int B, J, F, N;
  int C, c0;       // frames a chunk; this chunk's first frame
  int NF, CW, NT;  // features a frame; constants a row; source tiles
  float eps;
  int fast_recip, no_ll, first, last;
};

struct RankBits {
  unsigned long long w[kRankWords];  // bit j: source j has rank 2
};

// -- consts_kernel -----------------------------------------------------------

template <int R, bool REAL>
__global__ void __launch_bounds__(kThreads) consts_kernel(Args g,
                                                          RankBits bits) {
  __shared__ int rks[kMaxSources];
  const int J = g.J, F = g.F, tid = threadIdx.x;
  const long long row = blockIdx.x;  // b * F + f
  const int b = (int)(row / F), f = (int)(row - (long long)b * F);
  for (int j = tid; j < J; j += kThreads) {
    unsigned long long w = 0;
#pragma unroll
    for (int i = 0; i < kRankWords; ++i)  // indices known at compile time
      if (i == (j >> 6)) w = bits.w[i];
    rks[j] = (R == 2 && ((w >> (j & 63)) & 1ull)) ? 2 : 1;
    if (row == 0) g.ranks[j] = rks[j];
  }
  __syncthreads();
  const Layout L(J, R);
  float* cs = g.consts + (size_t)row * g.CW;
  const float* A4 = g.A4 + ((size_t)b * J * F + f) * 4 * R;
  const size_t as = (size_t)F * 4 * R;
  auto col = [&](int j, int r, int ch) {
    const float* a = A4 + j * as + 4 * r + 2 * ch;
    return cf{a[0], REAL ? 0.f : a[1]};
  };
  for (int t = tid; t < J * R * 2; t += kThreads) {
    const cf a = col(t / (2 * R), (t / 2) % R, t % 2);
    cs[2 * t] = a.re;
    cs[2 * t + 1] = a.im;
  }
  // R_j and tr R_j, then X_jk, as estep_general.cuh's row_constants
  for (int j = tid; j < J; j += kThreads) {
    float ra = 0.f, rd = 0.f;
    cf rb{0.f, 0.f};
    for (int r = 0; r < rks[j]; ++r) {
      const cf a0 = col(j, r, 0), a1 = col(j, r, 1);
      ra += cabs2(a0);
      rd += cabs2(a1);
      // a0 conj(a1)
      rb.re += a0.re * a1.re + a0.im * a1.im;
      rb.im += a0.im * a1.re - a0.re * a1.im;
    }
    cs[L.RA + j] = ra;
    cs[L.RD + j] = rd;
    cs[L.RBR + j] = rb.re;
    cs[L.RBI + j] = rb.im;
    cs[L.TRR + j] = ra + rd;
  }
  for (int jk = tid; jk < J * J; jk += kThreads) {
    const int j = jk / J, k = jk - j * J;
    float x = 0.f;
    for (int r = 0; r < rks[j]; ++r) {
      for (int s = 0; s < rks[k]; ++s) {
        const cf p = col(j, r, 0), q = col(k, s, 1);
        const cf u = col(j, r, 1), w = col(k, s, 0);
        // A_j[0,r] A_k[1,s] - A_j[1,r] A_k[0,s]
        const cf t{
            (p.re * q.re - p.im * q.im) - (u.re * w.re - u.im * w.im),
            (p.re * q.im + p.im * q.re) - (u.re * w.im + u.im * w.re)};
        x += cabs2(t);
      }
    }
    cs[L.XC + jk] = x;
  }
}

// -- frames_kernel -----------------------------------------------------------

template <int R, bool REAL, bool NS>
__global__ void __launch_bounds__(kThreads, 4) frames_kernel(Args g) {
  using MF = ManyFeats<R, REAL>;
  using FT = typename MF::FT;
  constexpr int NT4 = MF::NT4;
  const int J = g.J, F = g.F, N = g.N, C = g.C;
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int per_row = C / 32;  // warps a row of the chunk
  if (warp >= (long long)g.B * F * per_row) return;  // no barrier here
  const long long row = warp / per_row;
  const int nl = (int)(warp - row * per_row) * 32 + lane;
  const int n = g.c0 + nl;
  float* feat = g.feats + (size_t)row * g.NF * C + nl;  // feature e: e C
  if (n >= N) {  // a frame past N: every feature 0, so it adds nothing
    for (int e = 0; e < g.NF; ++e) feat[(size_t)e * C] = 0.f;
    return;
  }
  const int b = (int)(row / F), f = (int)(row - (long long)b * F);
  const size_t FN = (size_t)F * N;
  const size_t at = (size_t)f * N + n;
  const float* vp = g.v + (size_t)b * J * FN + at;
  const float* xp = g.x4 + (size_t)b * 4 * FN + at;
  float* xip = g.xi + (size_t)b * J * FN + at;
  const Layout L(J, R);
  const float* cs = g.consts + (size_t)row * g.CW;
  const float *Ra = cs + L.RA, *Rd = cs + L.RD, *Rbr = cs + L.RBR,
              *Rbi = cs + L.RBI, *trR = cs + L.TRR, *Xc = cs + L.XC;
  const int* rk = g.ranks;
  auto V = [&](int j) { return vp[(size_t)j * FN]; };
  const float sig = g.sigma[row];
  const bool fast = g.fast_recip != 0;

  // Sigma_x = sig I + sum_j v_j R_j and its subtract-free determinant
  const cf x0{xp[0], xp[FN]}, x1{xp[2 * FN], xp[3 * FN]};
  float sa = 0.f, sd = 0.f, lin = 0.f, quad = 0.f;
  cf sb{0.f, 0.f};
  for (int j = 0; j < J; ++j) {
    const float vj = V(j);
    sa += vj * Ra[j];
    sd += vj * Rd[j];
    sb.re += vj * Rbr[j];
    if constexpr (!REAL) sb.im += vj * Rbi[j];
    lin += vj * trR[j];
  }
  for (int j = 0; j < J; ++j) {
    const float vj = V(j);
    const float* xr = Xc + (size_t)j * J;
#pragma unroll 4
    for (int k = 0; k < J; ++k) quad += vj * V(k) * xr[k];
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
  feat[0] = x0.re;
  feat[(size_t)C] = x0.im;
  feat[(size_t)2 * C] = x1.re;
  feat[(size_t)3 * C] = x1.im;
  feat[(size_t)MF::LL * C] = g.no_ll ? tr : logf(det) + tr;

  // Source j from its leave-one-out sums: w_jr = A_jr^H y, z_jr =
  // Sigma_x^-1 A_jr (zero past the rank), S_j's subtract-free det, the
  // posterior, the T4 terms and xi; its features into the scratch.
  auto finish = [&](int j, float la, float ld, float lbr, float lbi,
                    float llin, float lquad) {
    const int rkj = rk[j];
    cf A[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const float* p = cs + 2 * ((j * R + r) * 2 + ch);
        A[r][ch] = cf{p[0], p[1]};
      }
    cf wj[R], zj[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wj[r] = cf{0.f, 0.f};
      zj[r][0] = zj[r][1] = cf{0.f, 0.f};
      if (r < rkj) {
        const cf p = cmul_conj<REAL>(A[r][0], y0);
        const cf q = cmul_conj<REAL>(A[r][1], y1);
        wj[r] = cf{p.re + q.re, p.im + q.im};
        herm_apply<REAL>(a, d, sb, rinv, A[r][0], A[r][1], zj[r][0],
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
    for (int s = 0; s < R; ++s) {
      sj[s][0] = sj[s][1] = cf{0.f, 0.f};
      if (s < rkj)
        herm_apply<REAL>(aS, dS, lb, rinvS, A[s][0], A[s][1], sj[s][0],
                         sj[s][1]);
    }
    auto M = [&](int r, int s) {
      const cf p = cmul_conj<REAL>(A[r][0], sj[s][0]);
      const cf q = cmul_conj<REAL>(A[r][1], sj[s][1]);
      return cf{p.re + q.re, p.im + q.im};
    };

    // the T4 terms: 1 / den for rank 1, v G^-1 for rank 2
    const float vj = V(j);
    float coef = 0.f;
    float t4[NT4];
    if (R == 1 || rkj == 1) {
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
    xip[(size_t)j * FN] =
        fmaxf((vj * vj * trCR + vj * coef) / (float)rkj, g.eps);
    float* p = feat + (size_t)MF::count(j) * C;  // source j's block
    p[(size_t)FT::V * C] = vj;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[(size_t)(FT::W + 2 * r) * C] = wj[r].re;
      p[(size_t)(FT::W + 2 * r + 1) * C] = wj[r].im;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        p[(size_t)FT::zre(r, ch) * C] = zj[r][ch].re;
        if constexpr (!REAL) p[(size_t)FT::zim(r, ch) * C] = zj[r][ch].im;
      }
    }
#pragma unroll
    for (int q = 0; q < NT4; ++q) p[(size_t)(FT::T4 + q) * C] = t4[q];
  };

  // The leave-one-out S_j = sig I + sum_{k != j} v_k R_k of kJC sources
  // j0 .. j0 + kJC - 1 at once, each sum in the plain version's order (k,
  // then l, ascending; the source's own row and column left out): a term
  // is formed once and added to the run's sums that take it. The k and l
  // inside the run are unrolled, so which sum leaves a term out is known
  // at compile time: no select, no runtime test per term.
  for (int j0 = 0; j0 < J; j0 += kJC) {
    float la[kJC], ld[kJC], lbr[kJC], lbi[kJC], llin[kJC], lq[kJC];
#pragma unroll
    for (int u = 0; u < kJC; ++u)
      la[u] = ld[u] = lbr[u] = lbi[u] = llin[u] = lq[u] = 0.f;
    const int hi = min(j0 + kJC, J);
    // row k of the sums (kk: k - j0 when k is in the run, else -1)
    auto row_k = [&](int k, auto kk) {
      constexpr int K = decltype(kk)::value;
      const float vk = V(k);
      const float ta = vk * Ra[k], td = vk * Rd[k], tbr = vk * Rbr[k],
                  tl = vk * trR[k];
      [[maybe_unused]] const float tbi = REAL ? 0.f : vk * Rbi[k];
      static_for<0, kJC>([&](auto u) {
        constexpr int U = decltype(u)::value;
        if constexpr (U != K) {
          la[U] += ta;
          ld[U] += td;
          lbr[U] += tbr;
          if constexpr (!REAL) lbi[U] += tbi;
          llin[U] += tl;
        }
      });
      const float* xr = Xc + (size_t)k * J;
      auto term = [&](int l, auto ll) {
        constexpr int LI = decltype(ll)::value;
        const float q = vk * V(l) * xr[l];
        static_for<0, kJC>([&](auto u) {
          constexpr int U = decltype(u)::value;
          if constexpr (U != K && U != LI) lq[U] += q;
        });
      };
      for (int l = 0; l < j0; ++l) term(l, IC<-1>());
      static_for<0, kJC>([&](auto li) {
        if (j0 + decltype(li)::value < J) term(j0 + decltype(li)::value, li);
      });
      for (int l = hi; l < J; ++l) term(l, IC<-1>());
    };
    for (int k = 0; k < j0; ++k) row_k(k, IC<-1>());
    static_for<0, kJC>([&](auto ki) {
      if (j0 + decltype(ki)::value < J) row_k(j0 + decltype(ki)::value, ki);
    });
    for (int k = hi; k < J; ++k) row_k(k, IC<-1>());
    static_for<0, kJC>([&](auto u) {
      constexpr int U = decltype(u)::value;
      if (j0 + U < J)
        finish(j0 + U, la[U], ld[U], lbr[U], lbi[U], llin[U], lq[U]);
    });
  }
}

// -- sums_kernel -------------------------------------------------------------

enum Role { kNone, kTss, kT7, kSrc, kLL };

template <int R, bool REAL, bool NS>
__global__ void __launch_bounds__(kThreads, 4) sums_kernel(Args g) {
  using MF = ManyFeats<R, REAL>;
  constexpr int BLK = MF::BLK, NT4 = MF::NT4, W7 = REAL ? 1 : 2;
  constexpr int ROWS = MF::XW + 2 * kTileSrc * BLK;
  constexpr int NTSS = 2 * R * R, NT7 = R * R * W7, NSRC = 4 * R + NT4;
  // the two tiles' features of kFramesT frames: x and the loglik term,
  // then tile a's sources, then tile b's, Feats' rows each
  __align__(16) __shared__ float tile[ROWS * kStride];
  const int J = g.J, F = g.F, C = g.C, NT = g.NT, tid = threadIdx.x;
  const int pairs = NT * (NT + 1) / 2;
  const long long row = blockIdx.x / pairs;  // b * F + f
  int p = (int)(blockIdx.x - row * pairs);
  int ta = 0;  // the pair (ta, tb), ta <= tb, row-major
  while (p >= NT - ta) p -= NT - ta++;
  const int tb = ta + p;
  const int a0 = ta * kTileSrc, b0 = tb * kTileSrc;
  const int nA = min(kTileSrc, J - a0);
  const int nB = ta == tb ? 0 : min(kTileSrc, J - b0);
  auto blk = [&](int j) {  // source j's rows in the tile
    const int u = (j >= a0 && j < a0 + nA) ? j - a0 : nA + j - b0;
    return tile + (MF::XW + u * BLK) * kStride;
  };
  // Owner i of the pair: (role, j, k). Off the diagonal: Tss_jk, T7_jk
  // (j in a, k in b), T7_kj; on it: Tss_jk (j <= k), T7_jk (j != k), the
  // sources' Txs and T4, and in the first pair the loglik.
  auto owner = [&](int i, int& j, int& k) -> int {
    j = k = a0;
    if (ta < tb) {
      const int m = nA * nB;
      if (i < 2 * m) {
        const int e = i % m;
        j = a0 + e / nB;
        k = b0 + e % nB;
        return i < m ? kTss : kT7;
      }
      if (i < 3 * m) {
        j = b0 + (i - 2 * m) / nA;
        k = a0 + (i - 2 * m) % nA;
        return kT7;
      }
      return kNone;
    }
    const int m = nA * (nA + 1) / 2;
    if (i < m) {
      int u = 0;
      while (i >= nA - u) i -= nA - u++;
      j = a0 + u;
      k = j + i;
      return kTss;
    }
    i -= m;
    if (i < nA * (nA - 1)) {
      j = a0 + i / (nA - 1);
      const int e = i % (nA - 1);
      k = a0 + e + (e >= j - a0);
      return kT7;
    }
    i -= nA * (nA - 1);
    if (i < nA) {
      j = k = a0 + i;
      return kSrc;
    }
    return (i == nA && ta == 0) ? kLL : kNone;
  };
  // each owner's totals, in the item functions' order (a slot's role
  // takes the first NTSS, NT7, NSRC or 1 of them)
  int role[kSlots], js[kSlots], ks[kSlots];
  float tot[kSlots][NSRC];
  static_assert(NSRC >= NTSS && NSRC >= NT7, "the largest owner first");
  const float* cs = g.consts + (size_t)row * g.CW;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    role[s] = owner(tid + s * kThreads, js[s], ks[s]);
#pragma unroll
    for (int i = 0; i < NSRC; ++i) tot[s][i] = 0.f;
  }
  const float sig = g.sigma[row];

  const int nvalid = min(C, g.N - g.c0);
  const int rows = MF::XW + (nA + nB) * BLK;
  const float* src = g.feats + (size_t)row * g.NF * C;
  constexpr int Q = kFramesT / 4;  // float4s of a staged row
  for (int t0 = 0; t0 < nvalid; t0 += kFramesT) {
    __syncthreads();  // every owner is done with the last turn's frames
    for (int lr = tid / Q; lr < rows; lr += kThreads / Q) {
      int e = lr;  // the row's feature in the scratch
      if (lr >= MF::XW) {
        const int u = (lr - MF::XW) / BLK;
        e = MF::XW + (u < nA ? a0 + u : b0 + u - nA) * BLK +
            (lr - MF::XW - u * BLK);
      }
      const int q = 4 * (tid % Q);
      *reinterpret_cast<float4*>(tile + lr * kStride + q) =
          *reinterpret_cast<const float4*>(src + (size_t)e * C + t0 + q);
    }
    __syncthreads();
    const int nq = (min(kFramesT, nvalid - t0) + 3) >> 2;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      switch (role[s]) {
        case kTss:
          pyfasst_general::tss_item<1, R, REAL, NS, kStride>(
              blk(js[s]), blk(ks[s]), nq, sig,
              *reinterpret_cast<float(*)[NTSS]>(tot[s]));
          break;
        case kT7:  // A_j from the row's constants: cf [R][2] at 4 R j
          pyfasst_general::t7_item<1, R, REAL, kStride>(
              blk(js[s]), blk(ks[s]),
              *reinterpret_cast<const cf(*)[R][2]>(cs + 4 * R * js[s]), nq,
              *reinterpret_cast<float(*)[NT7]>(tot[s]));
          break;
        case kSrc:
          pyfasst_general::src_item<1, R, REAL, NS, kStride>(
              blk(js[s]), tile, nq, sig, tot[s]);
          break;
        case kLL: {
          float tp = 0.f;
          for (int m = 0; m < 4 * nq; ++m) tp += tile[MF::LL * kStride + m];
          tot[s][0] += tp;
          break;
        }
        default:
          break;
      }
    }
  }

  // The chunk's totals into the outputs: stored by the first chunk, added
  // by the others; zero padding (past a source's rank), Tss_kj =
  // Tss_jk^H and the zero T7_jj at the last.
  const int b = (int)(row / F), f = (int)(row - (long long)b * F);
  const bool first = g.first != 0, last = g.last != 0;
  auto acc = [&](float* o, float t) { *o = first ? t : *o + t; };
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = js[s], k = ks[s];
    const int rj = g.ranks[j], rkk = g.ranks[k];
    const size_t jk = (((size_t)b * J + j) * J + k) * F + f;
    if (role[s] == kTss || role[s] == kT7) {
      float* o = (role[s] == kTss ? g.tss : g.t7) + jk * 2 * R * R;
      float out[2 * R * R];
#pragma unroll
      for (int i = 0; i < 2 * R * R; ++i) out[i] = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (r >= rj || q >= rkk) continue;
          const int i = 2 * (r * rkk + q);
          out[i] = o[i];
          out[i + 1] = o[i + 1];
          if (role[s] == kTss) {
            acc(&out[i], tot[s][2 * (r * R + q)]);
            acc(&out[i + 1], tot[s][2 * (r * R + q) + 1]);
          } else {
            acc(&out[i], tot[s][W7 * (r * R + q)]);
            if constexpr (REAL)
              out[i + 1] = 0.f;
            else
              acc(&out[i + 1], tot[s][2 * (r * R + q) + 1]);
          }
        }
#pragma unroll
      for (int i = 0; i < 2 * R * R; ++i) o[i] = out[i];
      if (role[s] == kTss && last) {
        // Tss_kj = Tss_jk^H: entry (r, q) of the (k, j) block from entry
        // (q, r) of this one; on the diagonal, the zero T7_jj
        float* m = j < k ? g.tss + ((((size_t)b * J + k) * J + j) * F + f) *
                                       2 * R * R
                         : g.t7 + jk * 2 * R * R;
        float mir[2 * R * R];
#pragma unroll
        for (int i = 0; i < 2 * R * R; ++i) mir[i] = 0.f;
        if (j < k) {
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int q = 0; q < R; ++q) {
              if (r >= rkk || q >= rj) continue;
              const int i = 2 * (r * rj + q), from = 2 * (q * rkk + r);
              mir[i] = out[from];
              mir[i + 1] = -out[from + 1];
            }
        }
#pragma unroll
        for (int i = 0; i < 2 * R * R; ++i) m[i] = mir[i];
      }
    } else if (role[s] == kSrc) {
      const size_t o = ((size_t)b * J + j) * F + f;
      float* tx = g.txs + o * 4 * R;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (r < rj)
            acc(&tx[4 * r + q], tot[s][4 * r + q]);
          else
            tx[4 * r + q] = 0.f;
        }
      float* t4o = g.t4 + o * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < (rj == 1 ? 1 : NT4))
          acc(&t4o[q], tot[s][4 * R + q]);
        else
          t4o[q] = 0.f;
      }
    } else if (role[s] == kLL) {
      acc(&g.ll[row], tot[s][0]);
    }
  }
}

// -- the launch ----------------------------------------------------------------

struct Plan {
  int C, chunks, NF, CW, NT;
  long long words;  // scratch: ranks, the rows' constants, a chunk's features
};

// The chunk and the scratch for (B, J, F, N) at Rmax R, real or complex
// mixing; chunks = 0 for a shape the launch cannot take.
inline Plan make_plan(int B, int J, int F, int N, int R, bool real) {
  Plan p{0, 0, 0, 0, 0, 0};
  if (B <= 0 || J <= 0 || F <= 0 || N <= 0 || J > kMaxSources ||
      (R != 1 && R != 2))
    return p;
  const int blk = R == 1 ? (real ? ManyFeats<1, true>::BLK
                                 : ManyFeats<1, false>::BLK)
                         : (real ? ManyFeats<2, true>::BLK
                                 : ManyFeats<2, false>::BLK);
  p.NF = ManyFeats<1, true>::XW + J * blk;
  p.CW = Layout(J, R).words;
  p.NT = (J + kTileSrc - 1) / kTileSrc;
  const long long whole = ((long long)N + 31) / 32 * 32;
  long long c = kChunkBytes / ((long long)F * p.NF * 4) / 32 * 32;
  c = c < 32 ? 32 : c > whole ? whole : c;
  p.C = (int)c;
  p.chunks = (int)((N + c - 1) / c);
  const long long rows = (long long)B * F;
  if (rows * (p.NT * (p.NT + 1) / 2) > INT_MAX ||
      rows * (c / 32) > (long long)INT_MAX * (kThreads / 32) ||
      rows > INT_MAX) {
    p.chunks = 0;
    return p;
  }
  p.words = ((J + 3) & ~3) + rows * p.CW + rows * p.NF * c;
  return p;
}

template <int R, bool REAL, bool NS>
int launch(Args g, const RankBits& bits, const Plan& p, cudaStream_t st) {
  const long long rows = (long long)g.B * g.F;
  consts_kernel<R, REAL><<<(unsigned)rows, kThreads, 0, st>>>(g, bits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned frame_blocks =
      (unsigned)((rows * (p.C / 32) + kThreads / 32 - 1) / (kThreads / 32));
  const unsigned sum_blocks = (unsigned)(rows * (p.NT * (p.NT + 1) / 2));
  for (int c = 0; c < p.chunks; ++c) {
    g.c0 = c * p.C;
    g.first = c == 0;
    g.last = c + 1 == p.chunks;
    frames_kernel<R, REAL, NS><<<frame_blocks, kThreads, 0, st>>>(g);
    sums_kernel<R, REAL, NS><<<sum_blocks, kThreads, 0, st>>>(g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The frames (which 0) or sums (1) kernel of an instantiation
template <int R, bool REAL, bool NS>
const void* kernel_of(int which) {
  return which == 0 ? (const void*)&frames_kernel<R, REAL, NS>
                    : (const void*)&sums_kernel<R, REAL, NS>;
}

template <class Fn>
int dispatch(int rmax, int real_cov, int ns_inj, Fn&& fn) {
  const bool re = real_cov != 0, ns = ns_inj != 0;
  if (rmax == 1) {
    if (re) return ns ? fn(IC<1>(), std::true_type(), std::true_type())
                      : fn(IC<1>(), std::true_type(), std::false_type());
    return ns ? fn(IC<1>(), std::false_type(), std::true_type())
              : fn(IC<1>(), std::false_type(), std::false_type());
  }
  if (rmax == 2) {
    if (re) return ns ? fn(IC<2>(), std::true_type(), std::true_type())
                      : fn(IC<2>(), std::true_type(), std::false_type());
    return ns ? fn(IC<2>(), std::false_type(), std::true_type())
              : fn(IC<2>(), std::false_type(), std::false_type());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace pyfasst_many

// C entry points, bound with ctypes (ops/cuda_estep.py, ops/_build.py).
// pyfasst_estep_many launches on `stream`, does not synchronise, allocates
// nothing: `ws` is the scratch of pyfasst_estep_many_workspace words (a
// float32 buffer), `ranks` the J sources' ranks (host memory, each 1 or
// 2, at most rmax). Returns a cudaError_t: 0 on success.
extern "C" int pyfasst_estep_many(
    const float* x4, const float* v, const float* A4, const float* sigma,
    float* xi, float* txs, float* tss, float* t4, float* t7, float* ll,
    float* ws, int B, int J, int F, int N, const int* ranks, int rmax,
    int real_cov, int ns_inj, float eps, int fast_recip, int no_ll,
    void* stream) {
  using namespace pyfasst_many;
  const Plan p = make_plan(B, J, F, N, rmax, real_cov != 0);
  if (p.chunks == 0 || ws == nullptr) return (int)cudaErrorInvalidValue;
  RankBits bits{};
  for (int j = 0; j < J; ++j) {
    if (ranks[j] < 1 || ranks[j] > rmax) return (int)cudaErrorInvalidValue;
    if (ranks[j] == 2) bits.w[j >> 6] |= 1ull << (j & 63);
  }
  const long long rows = (long long)B * F;
  Args g{x4, v, A4, sigma, xi, txs, tss, t4, t7, ll,
         reinterpret_cast<int*>(ws), ws + ((J + 3) & ~3),
         ws + ((J + 3) & ~3) + rows * p.CW,
         B, J, F, N, p.C, 0, p.NF, p.CW, p.NT, eps, fast_recip != 0,
         no_ll != 0, 1, 1};
  return dispatch(rmax, real_cov, ns_inj, [&](auto r, auto re, auto ns) {
    return launch<decltype(r)::value, decltype(re)::value,
                  decltype(ns)::value>(g, bits, p,
                                       static_cast<cudaStream_t>(stream));
  });
}

// Words of float32 scratch a launch at this shape takes; -1 for a shape it
// cannot take.
extern "C" long long pyfasst_estep_many_workspace(int B, int J, int F, int N,
                                                  int rmax, int real_cov) {
  const pyfasst_many::Plan p =
      pyfasst_many::make_plan(B, J, F, N, rmax, real_cov != 0);
  return p.chunks ? p.words : -1;
}

// Frames a chunk (C) at this shape, a clip's B alone not counting; -1 for
// a shape the launch cannot take.
extern "C" int pyfasst_estep_many_chunk(int J, int F, int N, int rmax,
                                        int real_cov) {
  const pyfasst_many::Plan p =
      pyfasst_many::make_plan(1, J, F, N, rmax, real_cov != 0);
  return p.chunks ? p.C : -1;
}

// Resident warps per SM, registers, local (spill) bytes and shared bytes of
// the frames (which 0) or sums (1) kernel of the instantiation rmax,
// real_cov and ns_inj name, as the runtime reports them.
extern "C" int pyfasst_estep_many_info(int which, int rmax, int real_cov,
                                       int ns_inj, int* out) {
  using namespace pyfasst_many;
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  return dispatch(rmax, real_cov, ns_inj, [&](auto r, auto re, auto ns) {
    const void* k = kernel_of<decltype(r)::value, decltype(re)::value,
                              decltype(ns)::value>(which);
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, k);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                      0);
    if (e != cudaSuccess) return (int)e;
    out[0] = blocks * (kThreads / 32);
    out[1] = attr.numRegs;
    out[2] = (int)attr.localSizeBytes;
    out[3] = (int)attr.sharedSizeBytes;
    return 0;
  });
}
