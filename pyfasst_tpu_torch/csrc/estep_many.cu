// Fused GEM E-step for I = 2 channels at J >= 17 sources (and J = 1), J an
// argument of the launch: CUDA C++ for sm_90a.
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
// Two routes, chosen by the shape alone (fused_plan: J, the largest rank,
// real or complex mixing):
//
// FUSED (J whose block's shared memory lets two blocks share an SM,
// kFusedSmem: J <= 60 at real rank 1, 51 at complex rank 1, 37 at real
// rank 2 (mixed ranks count as rank 2), 30 at complex rank 2; J = 1 too;
// faster than the chunked route at every J measured there but J = 24 and
// 32 at real rank 2: PERF.md row 1g'''). One block of four
// warps takes a segment of one (b, f) row's tiles of kTileF = 32 frames
// and keeps everything of a tile in shared memory:
//   once a block: the sources' ranks, the row's constants (mixing
//     columns, R_j, tr R_j, X_jk in rows of Jx = J rounded up to 8 words,
//     read as float4 broadcasts) and the table of the row's frame-sum
//     owners;
//   per tile: x and v of its 32 frames staged into the feature rows
//     (zeros past N); then lane = frame, four roles that turn with the
//     tile. Role 0 forms Sigma_x, its det, y and the loglik term (Sigma_x's
//     terms to shared memory, the loglik through a shuffle tree into its
//     total), while the others form the leave-one-out sums of their first
//     run of kJC = 8 sources (run r is role (r + 1) mod 4's); after one
//     barrier each finishes its runs: per source w_jr, z_jr, the
//     posterior, xi (stored at once), the T4 terms (a shuffle tree into
//     their totals) and the features w_jr, z_jr into the tile's rows. The
//     leave-one-out loop reads v_l and X_kl from shared memory, in the
//     plain version's order; one code path serves every row and source.
//     After a barrier the block's threads own the row's frame sums: Tss_jk
//     (j <= k), T7_jk (j != k) and each source's Txs, one owner a thread
//     at a time, each adding the tile's frames in frame order
//     (estep_general.cuh's tss_item, t7_item and its src_item without T4)
//     into its running total in shared memory; a warp's owners are mostly
//     of one j, so j's rows are broadcast reads.
//   At the segment's end the totals are the row's outputs (one segment) or
//   go to a partial in the scratch, (row, segment)-major; then
//   segments_kernel adds a row's partials in segment order and writes its
//   packed outputs. The segments (S a row, whole tiles each) come from
//   (B F, N) alone, so the order of every sum, and so the bits, are the
//   same on any card. No features reach device memory: the scratch is the
//   partials, B F S sums words (5.5 MB at (1, 20, 513, 863)), none at S = 1.
//   What holds it (PERF.md, row 1g'''): the leave-one-out loop's shape (a
//   shared-memory v, two FMULs and eight FADDs a term) issues ~2 FADDs a
//   cycle and SM on this card, half the FP32 rate; phase 2's float4 reads
//   of distinct rows; past ~76 KB of shared memory (complex rank 2 from J
//   = 24) two blocks an SM, too few warps to hide latency.
//
// CHUNKED (every other J, up to kMaxSources). Three kernels a call, the
// frames in chunks of C (a multiple of 32, set by (J, F, N, rank, mixing)
// alone: a clip's features of a chunk take at most kChunkBytes of scratch,
// which the caller allocates):
//   consts_kernel, one block a (b, f) row, once a call: the row's
//     constants into the scratch, and the sources' ranks.
//   frames_kernel, thread = frame, per chunk: as the fused route's phase
//     1, v and X_kl loaded through the L1, the features into the scratch,
//     feature-major, the chunk's frames contiguous (zeros past N).
//   sums_kernel, per chunk: one block owns one (row, pair of tiles of
//     kTileSrc sources a <= b): Tss_jk (j in a, k in b, j <= k), T7_jk and
//     T7_kj, and on a diagonal pair the tile's Txs and T4 (the first also
//     the loglik), staging the two tiles' features kFramesT frames at a
//     time; each owner adds its chunk's total to its output words.
// Fixed orders over frames, tiles, segments and chunks, one owner a word,
// no atomics: two runs give the same bits. Only j <= k of Tss is summed;
// T7 for every j != k.
//
// What bounds it on an H100: per bin it reads x4 (16 B) and v (4 B a
// source) and writes xi (4 B a source), against O(J^3) float32 operations
// a frame in the leave-one-out dets (each product once): bound by
// operations; with --fmad=false the floor is the card's FMA rate halved.
// The leave-one-out loop forms each product (v_k v_l) X_kl once for kJC
// sources' sums and adds it to each of them: its FADDs are the floor.
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
using pyfasst_general::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kJC = 8;           // sources a leave-one-out run
constexpr int kRankWords = 64;
constexpr int kMaxSources = 64 * kRankWords;
// the fused route
constexpr int kTileF = 32;       // frames a tile: lane = frame
// words a staged feature row: 16-byte rows whose starts step by an odd
// number of 16-byte groups, so a quarter-warp's float4 loads of distinct
// rows (odd steps apart) fall in distinct banks
constexpr int kFST = kTileF + 4;
constexpr int kSX = 9;           // Sigma_x's terms a frame: a d b y0 y1, rinv
constexpr int kFusedMaxJ = 128;
// a block's shared memory, at most: two blocks an SM (228 KB a Hopper SM,
// 1 KB of it reserved a block). Past it, at one block of four warps an
// SM, the chunked route is the faster (PERF.md row 1g''': 1.28x at J = 32
// complex rank 2, 1.17x at J = 40 real rank 2), so this bound sets the
// routes' crossover
constexpr long long kFusedSmem = 233472 / 2 - 1024;
constexpr long long kSegTarget = 2048;    // blocks a launch aims at
constexpr int kSegMinTiles = 4;           // tiles a segment, at least
// the chunked route
constexpr int kTileSrc = 8;      // sums_kernel: sources a tile
constexpr int kFramesT = 32;     // sums_kernel: frames staged a turn
constexpr int kStride = kFramesT + 4;
constexpr int kSlots = 2;        // sums_kernel: owners a thread, at most
constexpr long long kChunkBytes = 256ll << 20;  // a clip's features a chunk

static_assert(3 * kTileSrc * kTileSrc <= kSlots * kThreads,
              "an off-diagonal pair's owners in kSlots per thread");
static_assert(kFramesT % 32 == 0, "a chunk is whole warps of frames");
static_assert(kFusedMaxJ <= 0xffff, "owners' (j, k) in 16 bits each");

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

struct RankBits {
  unsigned long long w[kRankWords];  // bit j: source j has rank 2
};

// Source j's rank from the launch's bit mask, read with indices known at
// compile time (a mask indexed at run time would be copied to every
// thread's local memory).
template <int R>
__device__ __forceinline__ int rank_of(const RankBits& bits, int j) {
  unsigned long long w = 0;
#pragma unroll
  for (int i = 0; i < kRankWords; ++i)
    if (i == (j >> 6)) w = bits.w[i];
  return (R == 2 && ((w >> (j & 63)) & 1ull)) ? 2 : 1;
}

// A row's constants, in words: mixing columns (j, r, ch) as (re, im), R_j's
// entries, tr R_j, X_jk in rows of xs words; padded to whole float4s.
struct Layout {
  int RA, RD, RBR, RBI, TRR, XC, xs, words;
  __host__ __device__ Layout(int J, int R, int xs_)
      : RA(4 * R * J), RD(RA + J), RBR(RD + J), RBI(RBR + J), TRR(RBI + J),
        XC((TRR + J + 3) & ~3), xs(xs_), words((XC + J * xs_ + 3) & ~3) {}
};

// The row's constants into cs (laid out as L) from the mixing columns A4 at
// (b, f) (source stride as), as estep_general.cuh's row_constants: thread
// tid of nthr takes items in turn; X_jk past k = J is 0. No barrier.
template <int R, bool REAL>
__device__ void row_consts(float* cs, const Layout& L,
                           const float* __restrict__ A4, size_t as,
                           const int* rk, int J, int tid, int nthr) {
  auto col = [&](int j, int r, int ch) {
    const float* a = A4 + j * as + 4 * r + 2 * ch;
    return cf{a[0], REAL ? 0.f : a[1]};
  };
  for (int t = tid; t < J * R * 2; t += nthr) {
    const cf a = col(t / (2 * R), (t / 2) % R, t % 2);
    cs[2 * t] = a.re;
    cs[2 * t + 1] = a.im;
  }
  for (int j = tid; j < J; j += nthr) {
    float ra = 0.f, rd = 0.f;
    cf rb{0.f, 0.f};
    for (int r = 0; r < rk[j]; ++r) {
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
  for (int jk = tid; jk < J * L.xs; jk += nthr) {
    const int j = jk / L.xs, k = jk - j * L.xs;
    float x = 0.f;
    if (k < J) {
      for (int r = 0; r < rk[j]; ++r) {
        for (int s = 0; s < rk[k]; ++s) {
          const cf p = col(j, r, 0), q = col(k, s, 1);
          const cf u = col(j, r, 1), w = col(k, s, 0);
          // A_j[0,r] A_k[1,s] - A_j[1,r] A_k[0,s]
          const cf t{
              (p.re * q.re - p.im * q.im) - (u.re * w.re - u.im * w.im),
              (p.re * q.im + p.im * q.re) - (u.re * w.im + u.im * w.re)};
          x += cabs2(t);
        }
      }
    }
    cs[L.XC + jk] = x;
  }
}

// Source j from its leave-one-out sums (la, ld, lb, llin, lq) and the
// frame's Sigma_x = [a, d, sb] (1 / det = rinv) and y: w_jr = A_jr^H y,
// z_jr = Sigma_x^-1 A_jr (zero past the rank rkj), S_j's subtract-free
// det, the posterior and the T4 terms (1 / den for rank 1, v G^-1 for rank
// 2); returns xi_j. Aj: the source's mixing columns, cf [R][2].
template <int R, bool REAL, bool NS>
__device__ __forceinline__ float source_terms(
    const float* Aj, int rkj, float vj, float sig, float a, float d, cf sb,
    float rinv, cf y0, cf y1, float la, float ld, float lbr, float lbi,
    float llin, float lquad, bool fast, float eps, cf (&wj)[R],
    cf (&zj)[R][2], float (&t4)[R == 1 ? 1 : 4]) {
  constexpr int NT4 = R == 1 ? 1 : 4;
  cf A[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const float* p = Aj + 2 * (r * 2 + ch);
      A[r][ch] = cf{p[0], p[1]};
    }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wj[r] = cf{0.f, 0.f};
    zj[r][0] = zj[r][1] = cf{0.f, 0.f};
    if (r < rkj) {
      const cf p = cmul_conj<REAL>(A[r][0], y0);
      const cf q = cmul_conj<REAL>(A[r][1], y1);
      wj[r] = cf{p.re + q.re, p.im + q.im};
      herm_apply<REAL>(a, d, sb, rinv, A[r][0], A[r][1], zj[r][0], zj[r][1]);
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

  float coef = 0.f;
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
  return fmaxf((vj * vj * trCR + vj * coef) / (float)rkj, eps);
}

// The leave-one-out sums of a run of kJC sources.
struct Run {
  float la[kJC], ld[kJC], lbr[kJC], lbi[kJC], llin[kJC], lq[kJC];
};

// -- the fused route ----------------------------------------------------------

// A row's frame sums at J sources (rmax R, real or complex mixing), in
// words: T4 (J x NT4), Txs (J x R x 4), Tss (j <= k, row-major: 2 R^2
// each), T7 (j != k: W7 R^2 each), the loglik. And the block's shared
// memory, in words: the tile's feature rows (x, then per source v, w_jr,
// z_jr: Feats' rows up to its T4 terms, kFST words each), Sigma_x's terms
// (kSX rows of kTileF), the row's constants (Layout, X rows of Jx), the
// totals, the owner table (Tss then T7 owners, j | k << 16) and the ranks.
struct Fused {
  int J, BLK, NT4, W7, Jx;
  int T4, TXS, TSS, T7, LL, COUNT, PAIRS, OFFD;
  int FEAT, SX, CS, TOT, OWN, RK, words;
  __host__ __device__ Fused(int J_, int R, bool real)
      : J(J_), BLK(1 + 2 * R + (real ? 2 : 4) * R), NT4(R == 1 ? 1 : 4),
        W7(real ? 1 : 2), Jx((J_ + 7) & ~7), T4(0), TXS(J_ * NT4),
        TSS(TXS + 4 * R * J_), T7(TSS + J_ * (J_ + 1) * R * R),
        LL(T7 + J_ * (J_ - 1) * R * R * W7), COUNT(LL + 1),
        PAIRS(J_ * (J_ + 1) / 2), OFFD(J_ * (J_ - 1)), FEAT(0),
        SX((4 + J_ * BLK) * kFST), CS(SX + kSX * kTileF),
        TOT(CS + Layout(J_, R, Jx).words), OWN(TOT + ((COUNT + 3) & ~3)),
        RK(OWN + PAIRS + OFFD), words(RK + J_) {}
  __host__ __device__ int pair(int j, int k) const {  // j <= k
    return j * J - j * (j - 1) / 2 + (k - j);
  }
  __host__ __device__ int offd(int j, int k) const {  // j != k
    return j * (J - 1) + (k < j ? k : k - 1);
  }
};

struct FArgs {
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
  float* part;     // scratch: (B F, S, COUNT) partial sums, where S > 1
  int B, J, F, N;
  int S, per;      // segments a row; tiles a segment
  float eps;
  int fast_recip, no_ll;
};

// Source j's Txs (4 words per column r) over nq quads of frames from pa
// (its block of feature rows) and px (the frames' x): estep_general.cuh's
// src_item without the T4 terms, which the fused route sums in phase 1.
template <int R, bool REAL, bool NS>
__device__ __forceinline__ void txs_item(const float* pa, const float* px,
                                         int nq, float sig,
                                         float (&tot)[4 * R]) {
  using FT = Feats<1, R, REAL>;
  using pyfasst_general::at;
  using pyfasst_general::ld4;
  constexpr int S = kFST;
  constexpr int ZN = NS ? (REAL ? 1 : 2) : 0;  // words of a z channel
  float tp[4 * R];
#pragma unroll
  for (int i = 0; i < 4 * R; ++i) tp[i] = 0.f;
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
  }
#pragma unroll
  for (int i = 0; i < 4 * R; ++i) tot[i] += tp[i];
}

// The packed outputs of row (b, f) from its sums (tot(s): word s in Fused's
// order), zero-padded past each source's rank: Txs and T4 by source, the
// (j, k) blocks of Tss (Tss_kj = Tss_jk^H from the same words) and T7
// (zero on j == k), thread tid of kThreads taking items in turn.
template <int R, bool REAL, class Tot>
__device__ void write_row(const FArgs& g, const Fused& L, const Tot& tot,
                          const int* rk, int b, int f, long long row,
                          int tid) {
  const int J = L.J, F = g.F, NT4 = L.NT4, W7 = L.W7;
  if (tid == 0) g.ll[row] = tot(L.LL);
  for (int j = tid; j < J; j += kThreads) {
    const size_t o = ((size_t)b * J + j) * F + f;
    float* tx = g.txs + o * 4 * R;
    for (int r = 0; r < R; ++r)
      for (int q = 0; q < 4; ++q)
        tx[4 * r + q] = r < rk[j] ? tot(L.TXS + (j * R + r) * 4 + q) : 0.f;
    float* t4o = g.t4 + o * 4;
    for (int q = 0; q < 4; ++q)
      t4o[q] = q < (rk[j] == 1 ? 1 : NT4) ? tot(L.T4 + j * NT4 + q) : 0.f;
  }
  for (int jk = tid; jk < J * J; jk += kThreads) {
    const int j = jk / J, k = jk - j * J, rj = rk[j], rkk = rk[k];
    const size_t o = ((((size_t)b * J + j) * J + k) * F + f) * 2 * R * R;
    // word i of the (j, k) block: entry (r, s) = (e / rkk, e % rkk) of
    // the actual ranks, e = i / 2; zero past them
#pragma unroll
    for (int i = 0; i < 2 * R * R; ++i) {
      const int e = i >> 1, r = e / rkk, s = e - r * rkk, im = i & 1;
      float ts = 0.f, tz = 0.f;
      if (r < rj) {
        if (j <= k) {
          ts = tot(L.TSS + (L.pair(j, k) * R * R + r * R + s) * 2 + im);
        } else {  // Tss_jk = Tss_kj^H
          const float t =
              tot(L.TSS + (L.pair(k, j) * R * R + s * R + r) * 2 + im);
          ts = im ? -t : t;
        }
        if (j != k && !(REAL && im))
          tz = tot(L.T7 + (L.offd(j, k) * R * R + r * R + s) * W7 + im);
      }
      g.tss[o + i] = ts;
      g.t7[o + i] = tz;
    }
  }
}

// Resident blocks an SM asked of ptxas: four (128 registers a thread) at
// real rank 1; three (168) where complex mixing or rank 2 hold more of a
// run's sums and a source's terms at once (at four they spill 40-528 B)
template <int R, bool REAL>
constexpr int kFusedBlocks = R == 1 && REAL ? 4 : 3;

template <int R, bool REAL, bool NS>
__global__ void __launch_bounds__(kThreads, (kFusedBlocks<R, REAL>))
    fused_kernel(FArgs g, RankBits bits) {
  using FT = Feats<1, R, REAL>;
  constexpr int BLK = FT::T4;  // a source's feature rows: v, w_jr, z_jr
  constexpr int NT4 = FT::NT4;
  constexpr int VS = BLK * kFST;  // words from one source's v to the next
  extern __shared__ __align__(16) float sm[];
  const int J = g.J, F = g.F, N = g.N, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const Fused L(J, R, REAL);
  const Layout C(J, R, L.Jx);
  const long long row = blockIdx.x / g.S;  // b * F + f
  const int seg = (int)(blockIdx.x - row * g.S);
  const int b = (int)(row / F), f = (int)(row - (long long)b * F);
  float* feats = sm + L.FEAT;
  float* sxs = sm + L.SX;
  float* cs = sm + L.CS;
  float* tot = sm + L.TOT;
  int* own = reinterpret_cast<int*>(sm + L.OWN);
  int* rk = reinterpret_cast<int*>(sm + L.RK);
  const float *Ra = cs + C.RA, *Rd = cs + C.RD, *Rbr = cs + C.RBR,
              *Rbi = cs + C.RBI, *trR = cs + C.TRR, *X = cs + C.XC;
  const int Jx = L.Jx;

  // once a block: ranks, the row's constants, owners, zero totals
  for (int j = tid; j < J; j += kThreads) rk[j] = rank_of<R>(bits, j);
  for (int s = tid; s < L.COUNT; s += kThreads) tot[s] = 0.f;
  for (int jk = tid; jk < J * J; jk += kThreads) {
    const int j = jk / J, k = jk - j * J;
    if (j <= k) own[L.pair(j, k)] = j | k << 16;
    if (j != k) own[L.PAIRS + L.offd(j, k)] = j | k << 16;
  }
  __syncthreads();
  row_consts<R, REAL>(cs, C, g.A4 + ((size_t)b * J * F + f) * 4 * R,
                      (size_t)F * 4 * R, rk, J, tid, kThreads);

  const size_t FN = (size_t)F * N;
  const float sig = g.sigma[row];
  const bool fast = g.fast_recip != 0;
  const float* xrow = g.x4 + (size_t)b * 4 * FN + (size_t)f * N;
  const float* vrow = g.v + (size_t)b * J * FN + (size_t)f * N;
  float* xirow = g.xi + (size_t)b * J * FN + (size_t)f * N;
  const float* vcol = feats + 4 * kFST + lane;  // this lane's v_j: j VS
  auto V = [&](int j) { return vcol[j * VS]; };
  const int runs = (J + kJC - 1) / kJC;
  const int tiles = (N + kTileF - 1) / kTileF;
  const int t_hi = min(tiles, (seg + 1) * g.per);

  for (int t = seg * g.per; t < t_hi; ++t) {
    const int n0 = t * kTileF, n = n0 + lane;
    const bool valid = n < N;
    // x and v of the tile's frames into their rows (zeros past N)
    __syncthreads();  // the last tile's owners are done with the rows
    for (int e = tid; e < (4 + J) * kTileF; e += kThreads) {
      const int r = e / kTileF, fr = e - r * kTileF, nn = n0 + fr;
      float val = 0.f;
      if (nn < N)
        val = r < 4 ? xrow[r * FN + nn] : vrow[(size_t)(r - 4) * FN + nn];
      feats[(r < 4 ? r : 4 + (r - 4) * BLK) * kFST + fr] = val;
    }
    __syncthreads();

    // -- phase 1, lane = frame ----------------------------------------------
    // The leave-one-out S_j = sig I + sum_{k != j} v_k R_k of kJC sources
    // j0 .. j0 + kJC - 1 at once, each sum in the plain version's order (k,
    // then l, ascending; the source's own row and column left out): a term
    // is formed once and added to the run's sums that take it. One code
    // path for every row k: where k is in the run (K = k - j0), source K's
    // quadratic sum is saved before the row and put back after it, and a
    // branch on K, one a value, leaves its linear sums out; the l inside
    // the run are unrolled, so which sum leaves a column out is known at
    // compile time.
    auto accumulate = [&](int j0, Run& s) {
#pragma unroll
      for (int u = 0; u < kJC; ++u)
        s.la[u] = s.ld[u] = s.lbr[u] = s.lbi[u] = s.llin[u] = s.lq[u] = 0.f;
      const int hi = min(j0 + kJC, J);
      for (int k = 0; k < J; ++k) {
        const int K = k - j0;
        const bool in = K >= 0 && K < kJC;
        const float vk = V(k);
        const float ta = vk * Ra[k], td = vk * Rd[k], tbr = vk * Rbr[k],
                    tl = vk * trR[k];
        [[maybe_unused]] const float tbi = REAL ? 0.f : vk * Rbi[k];
        // the linear sums of the run's sources but K (K known at compile
        // time in each branch)
        auto linear = [&](auto kk) {
          static_for<0, kJC>([&](auto u) {
            constexpr int U = decltype(u)::value;
            if constexpr (U != std::decay_t<decltype(kk)>::value) {
              s.la[U] += ta;
              s.ld[U] += td;
              s.lbr[U] += tbr;
              if constexpr (!REAL) s.lbi[U] += tbi;
              s.llin[U] += tl;
            }
          });
        };
        float saved = 0.f;
        if (in) {
          static_for<0, kJC>([&](auto kk) {
            if (K == decltype(kk)::value) {
              saved = s.lq[decltype(kk)::value];
              linear(kk);
            }
          });
        } else {
          linear(IC<-1>());
        }
        const float* xr = X + k * Jx;
        auto add = [&](float q, auto ll) {
          constexpr int LI = decltype(ll)::value;
          static_for<0, kJC>([&](auto u) {
            constexpr int U = decltype(u)::value;
            if constexpr (U != LI) s.lq[U] += q;
          });
        };
        // l outside the run, four at a time: X_kl as a float4 broadcast
        auto outside = [&](int lo, int end) {
          int l = lo;
          for (; l + 4 <= end; l += 4) {
            const float4 x = *reinterpret_cast<const float4*>(xr + l);
            const float v0 = V(l), v1 = V(l + 1), v2 = V(l + 2),
                        v3 = V(l + 3);
            add(vk * v0 * x.x, IC<-1>());
            add(vk * v1 * x.y, IC<-1>());
            add(vk * v2 * x.z, IC<-1>());
            add(vk * v3 * x.w, IC<-1>());
          }
          for (; l < end; ++l) add(vk * V(l) * xr[l], IC<-1>());
        };
        outside(0, j0);
        static_for<0, kJC>([&](auto li) {
          constexpr int LI = decltype(li)::value;
          if (j0 + LI < J) add(vk * V(j0 + LI) * xr[j0 + LI], li);
        });
        outside(hi, J);
        if (in) {
          static_for<0, kJC>([&](auto u) {
            constexpr int U = decltype(u)::value;
            if (U == K) s.lq[U] = saved;
          });
        }
      }
    };

    // Sigma_x = sig I + sum_j v_j R_j, its subtract-free determinant, y and
    // the loglik term (role 0): its terms into sxs, the loglik into its
    // total
    auto sigma_x = [&]() {
      const cf x0{feats[0 * kFST + lane], feats[1 * kFST + lane]};
      const cf x1{feats[2 * kFST + lane], feats[3 * kFST + lane]};
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
        const float* xr = X + j * Jx;
        int k = 0;
        for (; k + 4 <= J; k += 4) {
          const float4 x = *reinterpret_cast<const float4*>(xr + k);
          quad += vj * V(k) * x.x;
          quad += vj * V(k + 1) * x.y;
          quad += vj * V(k + 2) * x.z;
          quad += vj * V(k + 3) * x.w;
        }
        for (; k < J; ++k) quad += vj * V(k) * xr[k];
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
      const float terms[kSX] = {a, d, sb.re, sb.im, rinv,
                                y0.re, y0.im, y1.re, y1.im};
#pragma unroll
      for (int q = 0; q < kSX; ++q) sxs[q * kTileF + lane] = terms[q];
      const float llt = warp_sum(valid ? (g.no_ll ? tr : logf(det) + tr)
                                       : 0.f);
      if (lane == 0) tot[L.LL] += llt;
    };

    // sources j0 .. of a run from its sums: xi, the features, the T4 terms
    // (one code path: source j's sums picked from the run's)
    auto finish = [&](int j0, const Run& s) {
      const float a = sxs[0 * kTileF + lane], d = sxs[1 * kTileF + lane];
      const cf sb{sxs[2 * kTileF + lane], sxs[3 * kTileF + lane]};
      const float rinv = sxs[4 * kTileF + lane];
      const cf y0{sxs[5 * kTileF + lane], sxs[6 * kTileF + lane]};
      const cf y1{sxs[7 * kTileF + lane], sxs[8 * kTileF + lane]};
      const int hi = min(j0 + kJC, J);
      for (int j = j0; j < hi; ++j) {
        float la = 0.f, ld = 0.f, lbr = 0.f, lbi = 0.f, llin = 0.f, lq = 0.f;
        static_for<0, kJC>([&](auto u) {
          constexpr int U = decltype(u)::value;
          if (j - j0 == U) {
            la = s.la[U];
            ld = s.ld[U];
            lbr = s.lbr[U];
            lbi = s.lbi[U];
            llin = s.llin[U];
            lq = s.lq[U];
          }
        });
        const float vj = V(j);
        cf wj[R], zj[R][2];
        float t4[NT4];
        const float xi = source_terms<R, REAL, NS>(
            cs + 4 * R * j, rk[j], vj, sig, a, d, sb, rinv, y0, y1, la, ld,
            lbr, lbi, llin, lq, fast, g.eps, wj, zj, t4);
        if (valid) xirow[(size_t)j * FN + n] = xi;
        float* p = feats + (4 + j * BLK) * kFST + lane;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          p[(FT::W + 2 * r) * kFST] = valid ? wj[r].re : 0.f;
          p[(FT::W + 2 * r + 1) * kFST] = valid ? wj[r].im : 0.f;
#pragma unroll
          for (int ch = 0; ch < 2; ++ch) {
            p[FT::zre(r, ch) * kFST] = valid ? zj[r][ch].re : 0.f;
            if constexpr (!REAL)
              p[FT::zim(r, ch) * kFST] = valid ? zj[r][ch].im : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < NT4; ++q) {
          const float sum = warp_sum(valid ? t4[q] : 0.f);
          if (lane == 0) tot[L.T4 + j * NT4 + q] += sum;
        }
      }
    };

    // run r is role (r + 1) % kWarps's; role 0 forms Sigma_x first, the
    // others their first run's sums meanwhile. A warp's role turns with the
    // tile, so each warp, and each of the SM's schedulers, takes the light
    // one in turn
    const int role = (warp + t) % kWarps;
    Run s;
    int r = role == 0 ? kWarps - 1 : role - 1;
    bool ahead = role != 0 && r < runs;
    if (role == 0)
      sigma_x();
    else if (ahead)
      accumulate(r * kJC, s);
    __syncthreads();  // Sigma_x's terms
    for (; r < runs; r += kWarps) {
      if (!ahead) accumulate(r * kJC, s);
      ahead = false;
      finish(r * kJC, s);
    }
    __syncthreads();  // the tile's features

    // -- phase 2: the tile's frames into the row's sums -----------------------
    // owner o: Tss (o < PAIRS), T7 (then OFFD of them) from the table, then
    // source o - PAIRS - OFFD's Txs; its tile partial into its total. The
    // owners of a warp are mostly of one j, whose rows they read as
    // broadcasts
    const int nq = (min(kTileF, N - n0) + 3) >> 2;
    for (int o = tid; o < L.PAIRS + L.OFFD + J; o += kThreads) {
      if (o < L.PAIRS + L.OFFD) {
        const int jk = own[o], j = jk & 0xffff, k = jk >> 16;
        const float* pa = feats + (4 + j * BLK) * kFST;
        const float* pb = feats + (4 + k * BLK) * kFST;
        if (o < L.PAIRS) {
          float t[2 * R * R] = {};
          pyfasst_general::tss_item<1, R, REAL, NS, kFST>(pa, pb, nq, sig,
                                                          t);
          float* to = tot + L.TSS + o * 2 * R * R;
#pragma unroll
          for (int i = 0; i < 2 * R * R; ++i) to[i] += t[i];
        } else {
          constexpr int W = R * R * (REAL ? 1 : 2);
          float t[W] = {};
          pyfasst_general::t7_item<1, R, REAL, kFST>(
              pa, pb, *reinterpret_cast<const cf(*)[R][2]>(cs + 4 * R * j),
              nq, t);
          float* to = tot + L.T7 + (o - L.PAIRS) * W;
#pragma unroll
          for (int i = 0; i < W; ++i) to[i] += t[i];
        }
      } else {
        const int j = o - L.PAIRS - L.OFFD;
        float t[4 * R] = {};
        txs_item<R, REAL, NS>(feats + (4 + j * BLK) * kFST, feats, nq, sig,
                              t);
        float* to = tot + L.TXS + j * 4 * R;
#pragma unroll
        for (int i = 0; i < 4 * R; ++i) to[i] += t[i];
      }
    }
  }
  __syncthreads();  // every total of the segment

  if (g.S == 1) {
    write_row<R, REAL>(g, L, [&](int s) { return tot[s]; }, rk, b, f, row,
                       tid);
  } else {
    float* out = g.part + (size_t)blockIdx.x * L.COUNT;
    for (int s = tid; s < L.COUNT; s += kThreads) out[s] = tot[s];
  }
}

// A split launch's second pass: row blockIdx.x's sums, its S segments'
// partials added in segment order, written as fused_kernel writes them.
template <int R, bool REAL>
__global__ void __launch_bounds__(kThreads)
    segments_kernel(FArgs g, RankBits bits) {
  __shared__ int rk[kFusedMaxJ];
  const int J = g.J, F = g.F;
  const Fused L(J, R, REAL);
  const long long row = blockIdx.x;
  const int b = (int)(row / F), f = (int)(row - (long long)b * F);
  for (int j = threadIdx.x; j < J; j += kThreads) rk[j] = rank_of<R>(bits, j);
  __syncthreads();
  const float* in = g.part + (size_t)row * g.S * L.COUNT;
  write_row<R, REAL>(g, L, [&](int s) {
    float t = in[s];
    for (int q = 1; q < g.S; ++q) t += in[(size_t)q * L.COUNT + s];
    return t;
  }, rk, b, f, row, threadIdx.x);
}

struct FusedPlan {
  int tiles, S, per;
  long long blocks, words;  // words: the partials' scratch (0 at S = 1)
  size_t smem;
};

// The fused route's plan for (B, J, F, N) at Rmax R, real or complex
// mixing: false where the route does not take the shape (J past
// kFusedMaxJ, a block past kFusedSmem, a grid past 2^31
// blocks). S = kSegTarget / (B F) segments a row, at most one per
// kSegMinTiles tiles and at least 1, each of `per` whole tiles (the last
// ragged): a function of (B F, N) alone.
inline bool fused_plan(int B, int J, int F, int N, int R, bool real,
                       FusedPlan* p) {
  if (B <= 0 || J <= 0 || F <= 0 || N <= 0 || J > kFusedMaxJ ||
      (R != 1 && R != 2))
    return false;
  const Fused L(J, R, real);
  p->smem = (size_t)L.words * sizeof(float);
  if ((long long)p->smem > kFusedSmem) return false;
  const long long rows = (long long)B * F;
  p->tiles = (N + kTileF - 1) / kTileF;
  long long S = kSegTarget / rows;
  if (S > p->tiles / kSegMinTiles) S = p->tiles / kSegMinTiles;
  if (S < 1) S = 1;
  p->per = (int)((p->tiles + S - 1) / S);
  p->S = (p->tiles + p->per - 1) / p->per;
  p->blocks = rows * p->S;
  p->words = p->S > 1 ? p->blocks * L.COUNT : 0;
  return p->blocks <= INT_MAX;
}

// Allows fused_kernel's instantiation every block's dynamic shared bytes a
// plan can ask (kFusedSmem), once per process.
template <int R, bool REAL, bool NS>
cudaError_t allow_fused() {
  static const cudaError_t e = cudaFuncSetAttribute(
      fused_kernel<R, REAL, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFusedSmem);
  return e;
}

template <int R, bool REAL, bool NS>
int launch_fused(FArgs g, const RankBits& bits, const FusedPlan& p,
                 cudaStream_t st) {
  cudaError_t e = allow_fused<R, REAL, NS>();
  if (e != cudaSuccess) return (int)e;
  auto kernel = fused_kernel<R, REAL, NS>;
  kernel<<<(unsigned)p.blocks, kThreads, p.smem, st>>>(g, bits);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.S == 1) return (int)e;
  segments_kernel<R, REAL><<<(unsigned)(p.blocks / p.S), kThreads, 0, st>>>(
      g, bits);
  return (int)cudaGetLastError();
}

// -- the chunked route --------------------------------------------------------

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

template <int R, bool REAL>
__global__ void __launch_bounds__(kThreads) consts_kernel(Args g,
                                                          RankBits bits) {
  __shared__ int rks[kMaxSources];
  const int J = g.J, F = g.F, tid = threadIdx.x;
  const long long row = blockIdx.x;  // b * F + f
  const int b = (int)(row / F), f = (int)(row - (long long)b * F);
  for (int j = tid; j < J; j += kThreads) {
    rks[j] = rank_of<R>(bits, j);
    if (row == 0) g.ranks[j] = rks[j];
  }
  __syncthreads();
  row_consts<R, REAL>(g.consts + (size_t)row * g.CW, Layout(J, R, J),
                      g.A4 + ((size_t)b * J * F + f) * 4 * R,
                      (size_t)F * 4 * R, rks, J, tid, kThreads);
}

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
  const Layout L(J, R, J);
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

  // source j: source_terms, xi, its features into the scratch
  auto finish = [&](int j, const Run& s, int u) {
    const float vj = V(j);
    cf wj[R], zj[R][2];
    float t4[NT4];
    xip[(size_t)j * FN] = source_terms<R, REAL, NS>(
        cs + 4 * R * j, rk[j], vj, sig, a, d, sb, rinv, y0, y1, s.la[u],
        s.ld[u], s.lbr[u], s.lbi[u], s.llin[u], s.lq[u], fast, g.eps, wj, zj,
        t4);
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

  // The leave-one-out sums of runs of kJC sources (as fused_kernel's
  // accumulate), v and X_kl loaded through the L1.
  for (int j0 = 0; j0 < J; j0 += kJC) {
    Run s;
#pragma unroll
    for (int u = 0; u < kJC; ++u)
      s.la[u] = s.ld[u] = s.lbr[u] = s.lbi[u] = s.llin[u] = s.lq[u] = 0.f;
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
          s.la[U] += ta;
          s.ld[U] += td;
          s.lbr[U] += tbr;
          if constexpr (!REAL) s.lbi[U] += tbi;
          s.llin[U] += tl;
        }
      });
      const float* xr = Xc + (size_t)k * J;
      auto term = [&](int l, auto ll) {
        constexpr int LI = decltype(ll)::value;
        const float q = vk * V(l) * xr[l];
        static_for<0, kJC>([&](auto u) {
          constexpr int U = decltype(u)::value;
          if constexpr (U != K && U != LI) s.lq[U] += q;
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
      if (j0 + U < J) finish(j0 + U, s, U);
    });
  }
}

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
  p.CW = Layout(J, R, J).words;
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

// -- the launch ----------------------------------------------------------------

// The chunked route's frames (which 0) or sums (1) kernel, the fused
// kernel (2) or the segments' second pass (3) of an instantiation
template <int R, bool REAL, bool NS>
const void* kernel_of(int which) {
  switch (which) {
    case 0:
      return (const void*)&frames_kernel<R, REAL, NS>;
    case 1:
      return (const void*)&sums_kernel<R, REAL, NS>;
    case 2:
      return (const void*)&fused_kernel<R, REAL, NS>;
    default:
      return (const void*)&segments_kernel<R, REAL>;
  }
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
// float32 buffer; null where that is 0), `ranks` the J sources' ranks
// (host memory, each 1 or 2, at most rmax). Returns a cudaError_t: 0 on
// success.
extern "C" int pyfasst_estep_many(
    const float* x4, const float* v, const float* A4, const float* sigma,
    float* xi, float* txs, float* tss, float* t4, float* t7, float* ll,
    float* ws, int B, int J, int F, int N, const int* ranks, int rmax,
    int real_cov, int ns_inj, float eps, int fast_recip, int no_ll,
    void* stream) {
  using namespace pyfasst_many;
  if (B <= 0 || J <= 0 || J > kMaxSources) return (int)cudaErrorInvalidValue;
  RankBits bits{};
  for (int j = 0; j < J; ++j) {
    if (ranks[j] < 1 || ranks[j] > rmax) return (int)cudaErrorInvalidValue;
    if (ranks[j] == 2) bits.w[j >> 6] |= 1ull << (j & 63);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FusedPlan fp;
  if (fused_plan(B, J, F, N, rmax, real_cov != 0, &fp)) {
    if (fp.words > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
    const FArgs g{x4, v, A4, sigma, xi, txs, tss, t4, t7, ll, ws, B, J, F, N,
                  fp.S, fp.per, eps, fast_recip != 0, no_ll != 0};
    return dispatch(rmax, real_cov, ns_inj, [&](auto r, auto re, auto ns) {
      return launch_fused<decltype(r)::value, decltype(re)::value,
                          decltype(ns)::value>(g, bits, fp, st);
    });
  }
  const Plan p = make_plan(B, J, F, N, rmax, real_cov != 0);
  if (p.chunks == 0 || ws == nullptr) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * F;
  Args g{x4, v, A4, sigma, xi, txs, tss, t4, t7, ll,
         reinterpret_cast<int*>(ws), ws + ((J + 3) & ~3),
         ws + ((J + 3) & ~3) + rows * p.CW,
         B, J, F, N, p.C, 0, p.NF, p.CW, p.NT, eps, fast_recip != 0,
         no_ll != 0, 1, 1};
  return dispatch(rmax, real_cov, ns_inj, [&](auto r, auto re, auto ns) {
    return launch<decltype(r)::value, decltype(re)::value,
                  decltype(ns)::value>(g, bits, p, st);
  });
}

// Words of float32 scratch a launch at this shape takes (0: none); -1 for
// a shape it cannot take.
extern "C" long long pyfasst_estep_many_workspace(int B, int J, int F, int N,
                                                  int rmax, int real_cov) {
  using namespace pyfasst_many;
  FusedPlan fp;
  if (fused_plan(B, J, F, N, rmax, real_cov != 0, &fp)) return fp.words;
  const Plan p = make_plan(B, J, F, N, rmax, real_cov != 0);
  return p.chunks ? p.words : -1;
}

// The launch's plan at this shape, into out[6]: route (0 fused, 1
// chunked), frames a tile (fused) or a chunk, segments a row or chunks,
// tiles a segment (fused; 0 chunked), blocks of the fused kernel (or of
// the chunked route's frames kernel), dynamic shared bytes a fused block
// (0 chunked). Returns 0, or cudaErrorInvalidValue for a shape the launch
// cannot take.
extern "C" int pyfasst_estep_many_plan(int B, int J, int F, int N, int rmax,
                                       int real_cov, long long* out) {
  using namespace pyfasst_many;
  FusedPlan fp;
  if (fused_plan(B, J, F, N, rmax, real_cov != 0, &fp)) {
    const long long v[6] = {0, kTileF, fp.S, fp.per, fp.blocks,
                            (long long)fp.smem};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
    return 0;
  }
  const Plan p = make_plan(B, J, F, N, rmax, real_cov != 0);
  if (p.chunks == 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * F;
  const long long v[6] = {1, p.C, p.chunks, 0,
                          (rows * (p.C / 32) + kWarps - 1) / kWarps, 0};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// Resident warps per SM, registers, local (spill) bytes and shared bytes
// (static and, for the fused kernel at J sources, dynamic) of the chunked
// route's frames (which 0) or sums (1) kernel, the fused kernel (2) or the
// segments' second pass (3) of the instantiation rmax, real_cov and ns_inj
// name, as the runtime reports them.
extern "C" int pyfasst_estep_many_info(int which, int J, int rmax,
                                       int real_cov, int ns_inj, int* out) {
  using namespace pyfasst_many;
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  if (which == 2) {
    FusedPlan fp;
    if (!fused_plan(1, J, 1, 1, rmax, real_cov != 0, &fp))
      return (int)cudaErrorInvalidValue;
    smem = fp.smem;
  }
  return dispatch(rmax, real_cov, ns_inj, [&](auto r, auto re, auto ns) {
    constexpr int R = decltype(r)::value;
    constexpr bool REAL = decltype(re)::value, NS = decltype(ns)::value;
    const void* k = kernel_of<R, REAL, NS>(which);
    cudaError_t e = which == 2 ? allow_fused<R, REAL, NS>() : cudaSuccess;
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, k);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    out[0] = blocks * kWarps;
    out[1] = attr.numRegs;
    out[2] = (int)attr.localSizeBytes;
    out[3] = (int)(attr.sharedSizeBytes + smem);
    return 0;
  });
}
