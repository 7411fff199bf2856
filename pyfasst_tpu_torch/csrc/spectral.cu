// Fused spectral M-step statistics of the plain two-factor IS-NMF chains:
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernels pyfasst_tpu/ops/pallas_spectral.py::
// _make_fb_kernel (launched by fb_stats, pallas_spectral.py:117) and
// ::_make_tw_kernel (launched by tw_stats, :155). For every clip b and
// source j, with V = FB TW rebuilt on the fly and Vc = max(V, vfloor):
//   fb_stats   num = (xi / Vc^2) TW^T,  den = (1 / Vc) TW^T   (F, K),
//              summed over frames: the FB update's statistics;
//   tw_stats   num = FB^T (xi / Vc^2),  den = FB^T (1 / Vc)   (K, N),
//              summed over frequencies, with the UPDATED FB: the TW
//              update's statistics.
// Neither writes an (F, N) plane: V, Vc, xi / Vc^2 and 1 / Vc live in
// registers (or, past K = 32, in a tile of shared memory), and each kernel
// reads xi once.
//
// Design, K <= 32 (past 32: the tiled kernel, "K > kMaxK" below).
//   fb_stats: one block per (b, j) and tile of kFbRows = 8 frequency rows,
//     one warp per row. TW is the operand every row of a (b, j) shares, so
//     the block stages it in shared memory, kFbFrames = 128 frames at a
//     time, with cp.async (__pipeline_memcpy_async) into two buffers, and
//     each warp stages its own row of xi beside it: the next stage's copies
//     are in flight while the warps work on this one. Lanes read the stage
//     on consecutive frames (consecutive banks). Each lane keeps its row's
//     K values of FB and its 2K partial sums in registers (K <= 32: at most
//     64 sums; ptxas' report in chip_smoke.py phase 1 says whether any
//     spill); a row ends with one shuffle tree in its warp, and lane 0
//     writes it. No block-wide reduction, and TW is read from L2 once per
//     8 rows instead of once per row.
//   tw_stats: one block of eight warps per (b, j) and strip of kTwStrip =
//     16 frames: a lane is one frame of a half-warp, and the block's 16
//     half-warps walk the frequency axis, half-warp p the rows p, p + 16, ...
//     Each lane keeps its frame's K values of TW and its 2K partial sums in
//     registers. FB of the (b, j) is staged into shared memory once (F x
//     KMAX words, dynamic: 16 KB at F = 513, K = 8; longer axes in chunks of
//     66 KB), behind the only barrier before the walk; a row's K words are
//     read as 16-byte broadcasts. A lane asks for its next kTwDepth = 8 rows
//     of xi (register prefetch, the row test in a select and not around the
//     load) before it works on the 8 it holds, so a warp always has 8 x
//     128 B on their way: 24 KB per SM at 24 resident warps, against the
//     ~17 KB that 3.35 TB/s needs at 0.7 us of latency. Whole batches of 128
//     rows run without row tests; the ragged last one tests each row.
//     Strips of 16 frames make 54 x 16 = 864 blocks of 8 warps at the bench
//     shape, three resident per SM: an SM takes 6 or 7 of them in turn, 7%
//     above an even split, where strips of 32 frames gave 432 blocks, 4 on
//     some SMs against an even 3.27. At B = 1 (108 blocks)
//     the 16 walkers shorten each walk to 33 rows, which is what the time
//     goes with there. __launch_bounds__(256, 3) at KMAX = 8: 80 registers,
//     no spill, 24 resident warps per SM (chip_smoke.py phase 1 prints it).
//     At the end the odd half-warp's sums go onto the even one's (one
//     shuffle), then the eight warps' sums are added in warp order in shared
//     memory (over the staged FB, behind a barrier). The TPU kernel writes
//     one partial (K, N) block per frequency block and XLA sums them
//     (pallas_spectral.py:21-27), because its sequential grid cannot
//     revisit a (K, N) block between frequency blocks; here one fixed-order
//     sum over f per frame replaces them, with no partials buffer and no
//     second launch.
//   No atomics: the results are the same from run to run. The dots are
//   plain fp32 multiply-adds in order k = 0 .. K-1 (no tensor cores, no
//   TF32), and the build's --fmad=false rounds each product on its own.
//   Divides are exact (1 / Vc, xi / (Vc Vc)), as in the Pallas kernels.
//
// Ragged edges: frames past N are never written. In fb_stats they read
// nothing (the copy zero-fills TW, and a select gives x, 1 / Vc and
// xi / Vc^2 of 0); in tw_stats such a lane holds TW of 0, reads its
// row's last frame and adds to sums that nothing reads. Frequency rows
// past F are never visited or written (fb_stats: the warp of such a row
// only helps stage TW; tw_stats: a select keeps the load inside the plane
// and a uniform test skips the row).
//
// What bounds it on an H100: each kernel reads xi once, 4 B per
// (b, j, f, n), and FB, TW and its outputs, which are K / N and K / F of
// that: at B = 8, J = 2, F = 513, N = 863, K = 8, 28.3 MB of xi and under
// 1 MB else, ~8.7 us at 3.35 TB/s; against ~6K + 5 flops per element,
// 0.38 GFLOP, ~5.6 us at 67 TFLOP/s, or ~11 us at the 33.5 Tops/s that
// separate multiplies and adds (--fmad=false) can issue. Memory bounds it
// on paper; the instruction stream is nearer to what bounds it in fact: a
// row of a warp (32 elements) is ~92 machine instructions in tw_stats
// (kernel_sass.py: 25 multiplies, 24 adds, two exact divides of ~10 each
// with a branch to their slow path, two 16-byte shared loads, moves and
// address arithmetic), 221,616 rows: 39 K issue cycles of each of the
// card's 528 schedulers, 20-22 us at 1.98-1.75 GHz, before the staging and
// the reductions. PERF.md holds the measured times and the constants tried
// (kernel_compare.py's variants).
//
// Layouts (float32, contiguous), BJ = B * J:
//   xi     (BJ, F, N)   posterior PSDs
//   FB     (BJ, F, K)   frequency basis
//   TW     (BJ, K, N)   time weights
//   vfloor (BJ)         floor of V, per clip and source
// Outputs:
//   fb_stats: num, den (BJ, F, K)
//   tw_stats: num, den (BJ, K, N)

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxK = 32;

constexpr int kFbRows = 8;      // frequency rows per block, one warp each
constexpr int kFbThreads = 32 * kFbRows;
constexpr int kFbFrames = 128;  // frames per shared-memory stage

constexpr int kTwWarps = 8;
constexpr int kTwThreads = 32 * kTwWarps;
constexpr int kTwStrip = 16;  // frames per block: half a warp (or 32: one)
static_assert(kTwStrip == 16 || kTwStrip == 32, "a warp is 1 or 2 strips");
// The strip's walkers, a half-warp (or warp) each: walker p takes the rows
// p, p + kTwPhases, ... of the frequency axis.
constexpr int kTwPhases = kTwWarps * (32 / kTwStrip);
constexpr int kTwDepth = 8;   // rows of xi a lane has asked for
constexpr int kTwBatch = kTwPhases * kTwDepth;  // rows per block and batch
constexpr int kTwChunkBytes = 66 * 1024;  // FB in shared memory at a time

// Resident warps per SM asked of ptxas: 24 (at most 80 registers) at
// KMAX = 8, where a lane holds 24 values of TW and sums; 16 and 8 above.
template <int KMAX>
constexpr int kTwMinBlocks =
    (KMAX <= 8 ? 24 : KMAX <= 16 ? 16 : 8) / kTwWarps;

template <int KMAX>
__global__ void __launch_bounds__(kFbThreads)
fb_stats_kernel(const float* __restrict__ xi, const float* __restrict__ FB,
                const float* __restrict__ TW,
                const float* __restrict__ vfloor, float* __restrict__ num,
                float* __restrict__ den, int F, int N, int K) {
  __shared__ float tws[2][KMAX][kFbFrames];
  __shared__ float xis[2][kFbRows][kFbFrames];

  const int bj = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.x * kFbRows + warp;
  const bool live = f < F;  // uniform across the warp
  const size_t row = (size_t)bj * F + (live ? f : 0);
  const float* xrow = xi + row * N;
  const float* tw = TW + (size_t)bj * K * N;
  const float vf = vfloor[bj];

  float w[KMAX], an[KMAX], ad[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    w[k] = (live && k < K) ? FB[row * K + k] : 0.f;
    an[k] = 0.f;
    ad[k] = 0.f;
  }

  // Stage frames n0 .. n0 + kFbFrames - 1 into buffer `buf`, zero past N:
  // the K rows of TW, spread over the block's threads, and each warp's row
  // of xi.
  auto stage = [&](int n0, int buf) {
    for (int i = threadIdx.x; i < K * kFbFrames; i += kFbThreads) {
      const int k = i / kFbFrames, m = i - k * kFbFrames;
      const bool in = n0 + m < N;
      __pipeline_memcpy_async(&tws[buf][k][m],
                              tw + (size_t)k * N + (in ? n0 + m : 0),
                              sizeof(float), in ? 0 : sizeof(float));
    }
#pragma unroll
    for (int i = 0; i < kFbFrames / 32; ++i) {
      const int m = lane + 32 * i;
      const bool in = live && n0 + m < N;
      __pipeline_memcpy_async(&xis[buf][warp][m], xrow + (in ? n0 + m : 0),
                              sizeof(float), in ? 0 : sizeof(float));
    }
    __pipeline_commit();
  };

  const int stages = (N + kFbFrames - 1) / kFbFrames;
  stage(0, 0);
  for (int t = 0; t < stages; ++t) {
    const int n0 = t * kFbFrames;
    if (t + 1 < stages) {
      stage(n0 + kFbFrames, (t + 1) & 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // stage t is in shared memory for every warp
    if (live) {
      const float(*h)[kFbFrames] = tws[t & 1];
      const float* xs = xis[t & 1][warp];
#pragma unroll
      for (int i = 0; i < kFbFrames / 32; ++i) {
        const int m = lane + 32 * i;
        const bool valid = n0 + m < N;
        const float x = valid ? xs[m] : 0.f;
        float V = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k < K) V += w[k] * h[k][m];
        const float Vc = fmaxf(V, vf);
        const float d = valid ? 1.0f / Vc : 0.f;
        const float q = valid ? x / (Vc * Vc) : 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k < K) {
            an[k] += q * h[k][m];
            ad[k] += d * h[k][m];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with buffer t & 1
  }

  // The row's sums: a shuffle tree in its warp, in a fixed order.
  if (!live) return;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) continue;
    float sn = an[k], sd = ad[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sn += __shfl_down_sync(0xffffffffu, sn, off);
      sd += __shfl_down_sync(0xffffffffu, sd, off);
    }
    if (lane == 0) {
      num[row * K + k] = sn;
      den[row * K + k] = sd;
    }
  }
}

// a * b + c of tw_stats' sums, the product rounded on its own, as
// --fmad=false builds it: the one place where kernel_compare.py's FMA
// diagnostic changes them.
__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return a * b + c;
}

// One frequency row of one frame: V from the row's K words of FB (`w`, in
// shared memory: every lane of a half-warp reads the same words, a
// broadcast) and the frame's TW, then the row's terms of the 2K sums.
// Words past K are zero in both, and add zero.
template <int KMAX>
__device__ __forceinline__ void tw_row(const float* __restrict__ w, float x,
                                       float vf, const float (&h)[KMAX],
                                       float (&an)[KMAX], float (&ad)[KMAX]) {
  float fb[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; k += 4) {
    const float4 t = *reinterpret_cast<const float4*>(w + k);
    fb[k] = t.x;
    fb[k + 1] = t.y;
    fb[k + 2] = t.z;
    fb[k + 3] = t.w;
  }
  float V = fb[0] * h[0];
#pragma unroll
  for (int k = 1; k < KMAX; ++k) V = mul_add(fb[k], h[k], V);
  const float Vc = fmaxf(V, vf);
  const float d = 1.0f / Vc;
  const float q = x / (Vc * Vc);
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    an[k] = mul_add(fb[k], q, an[k]);
    ad[k] = mul_add(fb[k], d, ad[k]);
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kTwThreads, kTwMinBlocks<KMAX>)
tw_stats_kernel(const float* __restrict__ xi, const float* __restrict__ FB,
                const float* __restrict__ TW,
                const float* __restrict__ vfloor, float* __restrict__ num,
                float* __restrict__ den, int F, int N, int K, int chunk) {
  // `chunk` rows of FB, [row][KMAX]; at the end the warps' sums,
  // [kTwWarps][2K][kTwStrip]
  extern __shared__ __align__(16) float smem[];

  const int bj = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = lane % kTwStrip;
  const int phase = warp * (32 / kTwStrip) + lane / kTwStrip;
  const int n = blockIdx.x * kTwStrip + col;
  const bool valid = n < N;
  // a lane past N reads its strip's last frame and is never written
  const float* xcol = xi + (size_t)bj * F * N + (valid ? n : N - 1);
  const float* fb = FB + (size_t)bj * F * K;
  const float vf = vfloor[bj];

  float h[KMAX], an[KMAX], ad[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    h[k] = (valid && k < K) ? TW[((size_t)bj * K + k) * N + n] : 0.f;
    an[k] = 0.f;
    ad[k] = 0.f;
  }

  for (int f0 = 0; f0 < F; f0 += chunk) {
    const int rows = min(chunk, F - f0);
    // A batch is kTwDepth rows per half-warp, kTwBatch of the chunk: rows
    // r = batch * kTwBatch + phase + kTwPhases * u. A lane asks for its next
    // batch of xi before it works on this one.
    const int batches = (rows + kTwBatch - 1) / kTwBatch;
    float px[kTwDepth];
    auto ask = [&](int batch) {
#pragma unroll
      for (int u = 0; u < kTwDepth; ++u) {
        const int r = batch * kTwBatch + phase + kTwPhases * u;
        px[u] = r < rows ? xcol[(size_t)(f0 + r) * N] : 0.f;
      }
    };
    ask(0);

    // The chunk of FB, zero past K; the first batch of xi is on its way.
    for (int i = threadIdx.x; i < rows * KMAX; i += kTwThreads) {
      const int r = i / KMAX, k = i - r * KMAX;
      const bool in = k < K;
      __pipeline_memcpy_async(&smem[i],
                              fb + (size_t)(f0 + r) * K + (in ? k : 0),
                              sizeof(float), in ? 0 : sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();  // the chunk is in shared memory for every warp

    for (int batch = 0; batch < batches; ++batch) {
      float x[kTwDepth];
#pragma unroll
      for (int u = 0; u < kTwDepth; ++u) x[u] = px[u];
      if (batch + 1 < batches) ask(batch + 1);
      const int r0 = batch * kTwBatch + phase;
      if ((batch + 1) * kTwBatch <= rows) {  // a whole batch: no row tests
#pragma unroll
        for (int u = 0; u < kTwDepth; ++u)
          tw_row<KMAX>(smem + (r0 + kTwPhases * u) * KMAX, x[u], vf, h, an,
                       ad);
      } else {                               // the chunk's ragged end
#pragma unroll
        for (int u = 0; u < kTwDepth; ++u)
          if (r0 + kTwPhases * u < rows)
            tw_row<KMAX>(smem + (r0 + kTwPhases * u) * KMAX, x[u], vf, h, an,
                         ad);
      }
    }
    __syncthreads();  // every warp is done with the chunk
  }

  // The odd half-warp's sums onto the even one's, then the warps' sums in
  // warp order: column (warp, slot) per frame of the strip.
  float* red = smem;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) continue;  // uniform
    float sn = an[k], sd = ad[k];
    if constexpr (kTwStrip < 32) {
      sn += __shfl_down_sync(0xffffffffu, sn, kTwStrip);
      sd += __shfl_down_sync(0xffffffffu, sd, kTwStrip);
    }
    if (lane < kTwStrip) {
      red[((size_t)warp * 2 * K + k) * kTwStrip + lane] = sn;
      red[((size_t)warp * 2 * K + K + k) * kTwStrip + lane] = sd;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * K * kTwStrip; i += kTwThreads) {
    const int s = i / kTwStrip, m = i - s * kTwStrip;
    float t = red[i];
#pragma unroll
    for (int w2 = 1; w2 < kTwWarps; ++w2)
      t += red[((size_t)w2 * 2 * K + s) * kTwStrip + m];
    const int nn = blockIdx.x * kTwStrip + m;
    if (nn < N) {
      const bool is_num = s < K;
      const int k = is_num ? s : s - K;
      (is_num ? num : den)[((size_t)bj * K + k) * N + nn] = t;
    }
  }
}

template <int KMAX>
cudaError_t launch_fb(const float* xi, const float* FB, const float* TW,
                      const float* vfloor, float* num, float* den, int BJ,
                      int F, int N, int K, cudaStream_t stream) {
  const dim3 grid((F + kFbRows - 1) / kFbRows, BJ);
  fb_stats_kernel<KMAX><<<grid, kFbThreads, 0, stream>>>(
      xi, FB, TW, vfloor, num, den, F, N, K);
  return cudaGetLastError();
}

// [resident warps per SM, registers per thread, local bytes per thread,
// static shared bytes per block] of fb_stats_kernel<KMAX>.
template <int KMAX>
cudaError_t info_fb(int* out) {
  auto kernel = fb_stats_kernel<KMAX>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kFbThreads, 0);
  if (e != cudaSuccess) return e;
  out[0] = blocks * kFbRows;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)attr.sharedSizeBytes;
  return cudaSuccess;
}

// Rows of FB per chunk and the launch's dynamic shared bytes (the chunk,
// or the warps' sums where those are larger); asks for more than 48 KB.
template <int KMAX>
cudaError_t plan_tw(int F, int K, int* chunk, size_t* smem) {
  const int rows = kTwChunkBytes / (KMAX * (int)sizeof(float));
  *chunk = F < rows ? F : rows;
  const size_t words_fb = (size_t)*chunk * KMAX;
  const size_t words_red = (size_t)kTwWarps * 2 * K * kTwStrip;
  *smem = (words_fb > words_red ? words_fb : words_red) * sizeof(float);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(tw_stats_kernel<KMAX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <int KMAX>
cudaError_t launch_tw(const float* xi, const float* FB, const float* TW,
                      const float* vfloor, float* num, float* den, int BJ,
                      int F, int N, int K, cudaStream_t stream) {
  int chunk;
  size_t smem;
  const cudaError_t e = plan_tw<KMAX>(F, K, &chunk, &smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kTwStrip - 1) / kTwStrip, BJ);
  tw_stats_kernel<KMAX><<<grid, kTwThreads, smem, stream>>>(
      xi, FB, TW, vfloor, num, den, F, N, K, chunk);
  return cudaGetLastError();
}

// As info_fb, of tw_stats_kernel<KMAX> at F rows of rank K; the shared
// bytes are the launch's dynamic ones.
template <int KMAX>
cudaError_t info_tw(int F, int K, int* out) {
  int chunk;
  size_t smem;
  cudaError_t e = plan_tw<KMAX>(F, K, &chunk, &smem);
  if (e != cudaSuccess) return e;
  auto kernel = tw_stats_kernel<KMAX>;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kTwThreads, smem);
  if (e != cudaSuccess) return e;
  out[0] = blocks * kTwWarps;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)(attr.sharedSizeBytes + smem);
  return cudaSuccess;
}

// -- K > kMaxK: V once per tile over all K, contracted in register tiles -----
//
// Past 32 components a thread cannot hold its row's or frame's 2K sums, so
// the two statistics are taken as the TPU kernel takes them
// (pallas_spectral.py:55-113): per tile, one product forms V, one
// elementwise pass forms q = xi / Vc^2 and d = 1 / Vc, and a second product
// contracts them; V is formed once per (row, frame) and launch, at any K.
// One kernel body serves both statistics. In its terms a block owns
// kXRows output rows r and walks the contracted axis c in tiles of kXCols:
//   fb_stats  r = f, c = n:  num(r, k) = sum_c q(r, c) TW(k, c)
//   tw_stats  r = n, c = f:  num(r, k) = sum_c q(c, r) FB(c, k)
// with the row factor P(r, k) (FB, or TW transposed) and the contracted
// factor C(c, k) (TW transposed, or FB) staged in shared memory as
// Pt[k][r] and Ct[k][c], so that both products read 16-byte vectors.
// Per tile of a block of 128 threads (four warps):
//   1. V (16 x 64) = P Ct: each thread a 2 x 4 register tile, k unrolled
//      over the compile-time chunk KCH, one float2 of Pt and one float4 of
//      Ct per k for 16 operations (kernel_sass.py: 151 instructions per
//      eight k, 128 of them multiplies and adds).
//   2. Vc = max(V, vfloor), d = 1 / Vc and q = xi / (Vc Vc) with exact
//      divides, in registers; a select puts 0 past the ragged edges. q
//      overwrites the staged xi in place, d goes to its own buffer.
//   3. num += q Ct^T and den += d Ct^T over the tile: each thread owns one
//      row and KPT components (k = g, g + 8, ...), reads a float4 of q, of d
//      and of each component's Ct row per four positions: 2 + KPT vector
//      loads for 32 KPT operations (286 instructions per eight positions
//      at KPT 8, 256 of them multiplies and adds). The sums run in order
//      within the tile
//      and are added to the thread's totals in tile order: two levels, 64
//      terms and then the tiles, never one serial sum over the whole axis.
// The next tile's xi, Ct (and, past the register budget, Pt) are in flight
// by cp.async (__pipeline_memcpy_async) in a second buffer while this one
// is worked on: two barriers per tile. A warp stages whole rows of device
// memory, 32 consecutive words a copy. K up to kXChunk = 64 is one chunk:
// KPT = ceil(K / 8) in {5, 6, 7, 8} (K = 40 is KPT 5 with no padding),
// totals in registers, P staged once per block. Past 64 (the register
// budget) the kernel takes the components in chunks of 64, each tile in
// 2 NC stages (NC = ceil(K / 64)): NC stages of P and Ct accumulate V over
// the chunks, then NC stages of Ct contract q and d into each chunk's
// sums; a thread's totals then live in the output (or its split's
// scratch), in device memory, read and written only by that thread, once
// per tile. Shared memory does not grow with K (52-56 KB at KCH = 64,
// 37 KB at 40); 90-114 registers, no spill, 16-20 resident warps per SM
// (chip_smoke.py phase 1 prints them).
// Enough blocks: a launch with fewer than kXSplitBlocks blocks (four per
// SM of the H100's 132) cuts the contracted axis into S segments of whole
// tiles (grid.z); each writes its sums to a scratch buffer the wrapper
// allocates, and sum_splits adds them in segment order. At the bench shape
// (B = 8, F = 513, N = 863) fb_stats has 16 x 33 = 528 blocks and tw_stats
// 16 x 54 = 864, no split; at B = 1 they split 7 and 5 ways.
// What bounds it on an H100: 6K + 5 operations per (b, j, f, n) against
// 16 bytes (xi read once; FB, TW and the outputs are K / N and K / F of
// it): at K = 40, 64, 1.73 and 2.76 Gop at the bench shape, 52 and 82 us
// at the 33.5 Tops/s the card issues without FMA (--fmad=false), against
// 8.7 us of memory: compute-bound; the no-FMA floor is the yardstick. The
// design's answer is the issue count: V formed once, register tiles over
// 16-byte shared loads, no serial chain on K: ~4,400 instructions per
// thread and tile for 3,112 operations at K = 64 (1.4 per operation, the
// q and d step's divides and the staging included), issued at ~95% of the
// schedulers' rate (PERF.md holds the times).
// No atomics, no tensor cores, fixed orders: the same bits on every run.

constexpr int kXRows = 16;              // output rows per block
constexpr int kXCols = 64;              // contracted positions per tile
constexpr int kXPad = kXCols + 4;       // row stride of the [.][c] buffers
constexpr int kXThreads = 128;
constexpr int kXGroups = 8;             // component groups: k = g + 8 j
constexpr int kXChunk = 64;             // components per chunk past 64
constexpr int kXSplitBlocks = 4 * 132;  // blocks below which c is split
constexpr int kSumThreads = 256;
constexpr int kXCopyUnroll = 8;         // unrolling of the staging loops
constexpr int kXVUnroll = 8;            // of V's loop over k
constexpr int kXSumUnroll = 2;          // of the contraction's loop
constexpr int kXMinBlocks = 4;          // resident blocks asked of ptxas
// V phase: thread (tid / 8, tid % 8) holds positions 4 (tid / 8) .. +3 of
// rows 2 (tid % 8), +1; a warp covers 16 positions of all 16 rows
static_assert(kXRows == 2 * 8 && kXCols == 4 * (kXThreads / 8),
              "the V tile is 8 x 16 register tiles of 2 x 4");
static_assert(kXRows * kXGroups == kXThreads,
              "the contraction gives each thread one row");
static_assert(kXThreads == 128 && kXCols == 64 && kXRows == 16,
              "staging: four warps, two words of 64 per lane and row");

// Shared floats of one instantiation: Pt (two buffers past the register
// budget), Ct in two buffers, xi (then q) in two, d.
constexpr size_t tile_smem(int kch, bool wide) {
  return ((wide ? 2 : 1) * (size_t)kch * kXRows + 2 * (size_t)kch * kXPad +
          3 * (size_t)kXRows * kXPad) * sizeof(float);
}

// Segments of the contracted axis (Cn positions) for a launch of BJ x
// ceil(Rn / kXRows) blocks, and the whole tiles each segment takes.
int plan_split(int BJ, int Rn, int Cn, int* tiles_per_seg) {
  const int tiles = (Cn + kXCols - 1) / kXCols;
  const long long blocks = (long long)BJ * ((Rn + kXRows - 1) / kXRows);
  int S = blocks >= kXSplitBlocks
              ? 1
              : (int)((kXSplitBlocks + blocks - 1) / blocks);
  S = min(S, tiles);
  *tiles_per_seg = (tiles + S - 1) / S;
  return (tiles + *tiles_per_seg - 1) / *tiles_per_seg;
}

template <bool kTw, int KPT, bool kWide>
__global__ void __launch_bounds__(kXThreads, kXMinBlocks)
stats_tile_kernel(const float* __restrict__ xi, const float* __restrict__ FB,
                  const float* __restrict__ TW,
                  const float* __restrict__ vfloor, float* __restrict__ num,
                  float* __restrict__ den, int F, int N, int K,
                  int tiles_per_seg, size_t seg_stride) {
  constexpr int KCH = kXGroups * KPT;
  static_assert(!kWide || KCH == kXChunk, "chunks of kXChunk components");
  // Pt [kWide ? 2 : 1][KCH][kXRows]; Ct [2][KCH][kXPad];
  // Xs [2][kXRows][kXPad] (xi, then q in place); Ds [kXRows][kXPad]
  extern __shared__ __align__(16) float smem[];
  float* Pt = smem;
  float* Ct = Pt + (kWide ? 2 : 1) * KCH * kXRows;
  float* Xs = Ct + 2 * KCH * kXPad;
  float* Ds = Xs + 2 * kXRows * kXPad;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bj = blockIdx.y;
  const int Rn = kTw ? N : F, Cn = kTw ? F : N;
  const int r0 = blockIdx.x * kXRows;
  const int rv = min(kXRows, Rn - r0);
  const int tile0 = blockIdx.z * tiles_per_seg;
  const int ntiles = min(tiles_per_seg, (Cn + kXCols - 1) / kXCols - tile0);
  const int NC = kWide ? (K + KCH - 1) / KCH : 1;
  const int per_tile = kWide ? 2 * NC : 1;  // stages per tile
  const int nstages = ntiles * per_tile;
  const float* xb = xi + (size_t)bj * F * N;
  const float* fbb = FB + (size_t)bj * F * K;
  const float* twb = TW + (size_t)bj * K * N;
  // P(r, k) = Pb[r Prs + k Pks], C(c, k) = Cb[c K + k] (tw_stats) or
  // Cb[k N + c] (fb_stats), the outputs' (r, k) at r Ors + k Oks
  const float* Pb = kTw ? twb : fbb;
  const float* Cb = kTw ? fbb : twb;
  const size_t Prs = kTw ? 1 : K, Pks = kTw ? N : 1;
  const size_t Ors = kTw ? 1 : K, Oks = kTw ? N : 1;
  const size_t out0 = (size_t)bj * Rn * K;
  float* numd = num + blockIdx.z * seg_stride;
  float* dend = den + blockIdx.z * seg_stride;
  const float vf = vfloor[bj];

  // Stage s's copies in one cp.async group: the tile's xi at its first
  // stage, P at the first (or a V stage's chunk), Ct of the stage's chunk.
  // Consecutive threads copy consecutive words of device memory. Only P is
  // zero past its edges (K, and the block's rows): a word of xi or Ct past
  // an edge is read from the edge itself, a finite input, and never
  // counts: step 2's select gives q = d = 0 there, and a component past K
  // meets P = 0 in V and is never written.
  auto issue = [&](int s) {
    const int tile = s / per_tile, p = s - tile * per_tile, buf = s & 1;
    const int c0 = (tile0 + tile) * kXCols;
    const int tv = min(kXCols, Cn - c0);
    auto cp = [](float* dst, const float* src) {
      __pipeline_memcpy_async(dst, src, sizeof(float));
    };
    if (p == 0) {
      float* dst = Xs + (tile & 1) * kXRows * kXPad;
      if constexpr (!kTw) {  // warp w: rows w, w + 4, ... (f), 64 frames
        const int ca = c0 + min(lane, tv - 1);
        const int cb = c0 + min(lane + 32, tv - 1);
#pragma unroll
        for (int m = 0; m < kXRows / 4; ++m) {
          const int r = warp + 4 * m;
          const float* row = xb + (size_t)(r0 + min(r, rv - 1)) * N;
          cp(dst + r * kXPad + lane, row + ca);
          cp(dst + r * kXPad + lane + 32, row + cb);
        }
      } else {  // a half-warp per row f of the tile, its 16 frames
        const int r = lane % kXRows, rr = r0 + min(r, rv - 1);
#pragma unroll
        for (int m = 0; m < kXCols / 8; ++m) {
          const int c = 2 * warp + 8 * m + lane / kXRows;
          cp(dst + r * kXPad + c, xb + (size_t)(c0 + min(c, tv - 1)) * N + rr);
        }
      }
    }
    const int kc = (kWide ? (p < NC ? p : p - NC) : 0) * KCH;
    if (kWide ? p < NC : s == 0) {
      float* dst = Pt + (kWide ? buf : 0) * KCH * kXRows;
#pragma unroll kXCopyUnroll
      for (int m = 0; m < KCH * kXRows / kXThreads; ++m) {
        const int i = tid + m * kXThreads;
        const int r = kTw ? i % kXRows : i / KCH;
        const int k = kTw ? i / kXRows : i % KCH;
        const bool in = r < rv && kc + k < K;
        __pipeline_memcpy_async(
            dst + k * kXRows + r,
            Pb + (in ? (r0 + r) * Prs + (kc + k) * Pks : 0), sizeof(float),
            in ? 0 : sizeof(float));
      }
    }
    float* dst = Ct + buf * KCH * kXPad;
    if constexpr (!kTw) {  // warp w: rows k = w, w + 4, ... of TW, 64 frames
      const int ca = c0 + min(lane, tv - 1);
      const int cb = c0 + min(lane + 32, tv - 1);
#pragma unroll kXCopyUnroll
      for (int m = 0; m < KCH / 4; ++m) {
        const int k = warp + 4 * m;
        const float* row = Cb + (size_t)min(kc + k, K - 1) * N;
        cp(dst + k * kXPad + lane, row + ca);
        cp(dst + k * kXPad + lane + 32, row + cb);
      }
    } else {  // warp w: rows f = w, w + 4, ... of FB, KCH components
      const int ka = min(kc + lane, K - 1), kb = min(kc + lane + 32, K - 1);
#pragma unroll kXCopyUnroll
      for (int m = 0; m < kXCols / 4; ++m) {
        const int c = warp + 4 * m;
        const float* row = Cb + (size_t)(c0 + min(c, tv - 1)) * K;
        cp(dst + lane * kXPad + c, row + ka);
        if (lane + 32 < KCH) cp(dst + (lane + 32) * kXPad + c, row + kb);
      }
    }
    __pipeline_commit();
  };

  const int vr = (tid % 8) * 2, vc = (tid / 8) * 4;  // the V register tile
  const int cr = kTw ? tid % kXRows : tid / kXGroups;   // contraction row
  const int g = kTw ? tid / kXRows : tid % kXGroups;    // component group
  float v[2][4];
  float tn[KPT], td[KPT];  // totals (registers up to the register budget)
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    tn[j] = 0.f;
    td[j] = 0.f;
  }

  issue(0);
  for (int s = 0; s < nstages; ++s) {
    __pipeline_wait_prior(0);
    __syncthreads();  // stage s landed everywhere; stage s - 1 is done
    if (s + 1 < nstages) issue(s + 1);
    const int tile = s / per_tile, p = s - tile * per_tile, buf = s & 1;
    const int c0 = (tile0 + tile) * kXCols;
    const int tv = min(kXCols, Cn - c0);
    float* xq = Xs + (tile & 1) * kXRows * kXPad;
    const float* ct = Ct + buf * KCH * kXPad;

    if (!kWide || p < NC) {  // V over this stage's chunk of components
      if (p == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
      }
      if (vc < tv) {  // a register tile past the tile's end stays idle
        const float* pt = Pt + (kWide ? buf : 0) * KCH * kXRows + vr;
#pragma unroll kXVUnroll
        for (int k = 0; k < KCH; ++k) {
          const float2 a = *reinterpret_cast<const float2*>(pt + k * kXRows);
          const float4 b = *reinterpret_cast<const float4*>(ct + k * kXPad +
                                                            vc);
          v[0][0] = v[0][0] + a.x * b.x;
          v[0][1] = v[0][1] + a.x * b.y;
          v[0][2] = v[0][2] + a.x * b.z;
          v[0][3] = v[0][3] + a.x * b.w;
          v[1][0] = v[1][0] + a.y * b.x;
          v[1][1] = v[1][1] + a.y * b.y;
          v[1][2] = v[1][2] + a.y * b.z;
          v[1][3] = v[1][3] + a.y * b.w;
        }
      }
      if (!kWide || p == NC - 1) {  // V is whole: q and d
        if (vc < tv) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float* xr = xq + (vr + i) * kXPad + vc;
            float* dr = Ds + (vr + i) * kXPad + vc;
            const float4 x4 = *reinterpret_cast<const float4*>(xr);
            const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
            float q[4], d[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool ok = vr + i < rv && vc + j < tv;
              const float Vc = fmaxf(v[i][j], vf);
              d[j] = ok ? 1.0f / Vc : 0.f;
              q[j] = ok ? xs[j] / (Vc * Vc) : 0.f;
            }
            *reinterpret_cast<float4*>(xr) = make_float4(q[0], q[1], q[2],
                                                         q[3]);
            *reinterpret_cast<float4*>(dr) = make_float4(d[0], d[1], d[2],
                                                         d[3]);
          }
        }
        if (!kWide) __syncthreads();  // q and d are in shared memory
      }
    }

    if (!kWide || p >= NC) {  // q and d against this stage's chunk of Ct
      const int kc = (kWide ? p - NC : 0) * KCH;
      const int r = r0 + cr;
      float pn[KPT], pd[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        pn[j] = 0.f;
        pd[j] = 0.f;
      }
      const float* qr = xq + cr * kXPad;
      const float* dr = Ds + cr * kXPad;
      const float* cg = ct + g * kXPad;
      const int tend = (tv + 3) & ~3;  // q and d are 0 from tv on
#pragma unroll kXSumUnroll
      for (int c = 0; c < tend; c += 4) {
        const float4 q = *reinterpret_cast<const float4*>(qr + c);
        const float4 d = *reinterpret_cast<const float4*>(dr + c);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const float4 h = *reinterpret_cast<const float4*>(
              cg + kXGroups * j * kXPad + c);
          pn[j] = pn[j] + q.x * h.x;
          pn[j] = pn[j] + q.y * h.y;
          pn[j] = pn[j] + q.z * h.z;
          pn[j] = pn[j] + q.w * h.w;
          pd[j] = pd[j] + d.x * h.x;
          pd[j] = pd[j] + d.y * h.y;
          pd[j] = pd[j] + d.z * h.z;
          pd[j] = pd[j] + d.w * h.w;
        }
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        if constexpr (kWide) {  // past the budget: totals in the output
          const int k = kc + g + kXGroups * j;
          if (r < Rn && k < K) {
            const size_t o = out0 + r * Ors + k * Oks;
            numd[o] = (tile > 0 ? numd[o] : 0.f) + pn[j];
            dend[o] = (tile > 0 ? dend[o] : 0.f) + pd[j];
          }
        } else {
          tn[j] = tn[j] + pn[j];
          td[j] = td[j] + pd[j];
        }
      }
    }
  }

  if constexpr (!kWide) {
    const int r = r0 + cr;
    if (r < Rn) {
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int k = g + kXGroups * j;
        if (k < K) {
          numd[out0 + r * Ors + k * Oks] = tn[j];
          dend[out0 + r * Ors + k * Oks] = td[j];
        }
      }
    }
  }
}

// num (den) = the sum over S segments of the scratch's, in segment order:
// ws holds [S][2][total] (each segment's num, then its den).
__global__ void __launch_bounds__(kSumThreads)
sum_splits_kernel(const float* __restrict__ ws, float* __restrict__ num,
                  float* __restrict__ den, size_t total, int S) {
  const size_t step = (size_t)gridDim.x * kSumThreads;
  for (size_t i = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
       i < 2 * total; i += step) {
    float t = ws[i];
    for (int s = 1; s < S; ++s) t += ws[(size_t)s * 2 * total + i];
    if (i < total)
      num[i] = t;
    else
      den[i - total] = t;
  }
}

// A kernel's dynamic shared bytes, allowed past the 48 KB default.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Floats of scratch a launch needs: S x 2 x (B J x rows x K), 0 unsplit.
size_t tile_workspace(bool tw, int BJ, int F, int N, int K) {
  int tps;
  const int Rn = tw ? N : F, Cn = tw ? F : N;
  const int S = plan_split(BJ, Rn, Cn, &tps);
  return S > 1 ? (size_t)S * 2 * BJ * Rn * K : 0;
}

template <bool kTw, int KPT, bool kWide>
cudaError_t launch_tile(const float* xi, const float* FB, const float* TW,
                        const float* vfloor, float* num, float* den,
                        float* ws, int BJ, int F, int N, int K,
                        cudaStream_t stream) {
  auto kernel = stats_tile_kernel<kTw, KPT, kWide>;
  const size_t smem = tile_smem(kXGroups * KPT, kWide);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int Rn = kTw ? N : F, Cn = kTw ? F : N;
  int tps;
  const int S = plan_split(BJ, Rn, Cn, &tps);
  if (S > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const size_t total = (size_t)BJ * Rn * K;
  const dim3 grid((Rn + kXRows - 1) / kXRows, BJ, S);
  if (S == 1) {
    kernel<<<grid, kXThreads, smem, stream>>>(xi, FB, TW, vfloor, num, den,
                                              F, N, K, tps, 0);
    return cudaGetLastError();
  }
  kernel<<<grid, kXThreads, smem, stream>>>(xi, FB, TW, vfloor, ws,
                                            ws + total, F, N, K, tps,
                                            2 * total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t want = (2 * total + kSumThreads - 1) / kSumThreads;
  const int blocks = (int)(want < 1056 ? want : 1056);
  sum_splits_kernel<<<blocks, kSumThreads, 0, stream>>>(ws, num, den, total,
                                                        S);
  return cudaGetLastError();
}

template <bool kTw>
cudaError_t launch_wide(const float* xi, const float* FB, const float* TW,
                        const float* vfloor, float* num, float* den,
                        float* ws, int BJ, int F, int N, int K,
                        cudaStream_t s) {
  if (K <= 40)
    return launch_tile<kTw, 5, false>(xi, FB, TW, vfloor, num, den, ws, BJ,
                                      F, N, K, s);
  if (K <= 48)
    return launch_tile<kTw, 6, false>(xi, FB, TW, vfloor, num, den, ws, BJ,
                                      F, N, K, s);
  if (K <= 56)
    return launch_tile<kTw, 7, false>(xi, FB, TW, vfloor, num, den, ws, BJ,
                                      F, N, K, s);
  if (K <= kXChunk)
    return launch_tile<kTw, 8, false>(xi, FB, TW, vfloor, num, den, ws, BJ,
                                      F, N, K, s);
  return launch_tile<kTw, 8, true>(xi, FB, TW, vfloor, num, den, ws, BJ, F,
                                   N, K, s);
}

// [resident warps per SM, registers per thread, local bytes per thread,
// shared bytes per block (static and dynamic)] of one instantiation.
template <bool kTw, int KPT, bool kWide>
cudaError_t info_tile(int* out) {
  auto kernel = stats_tile_kernel<kTw, KPT, kWide>;
  const size_t smem = tile_smem(kXGroups * KPT, kWide);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kXThreads, smem);
  if (e != cudaSuccess) return e;
  out[0] = blocks * kXThreads / 32;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)(attr.sharedSizeBytes + smem);
  return cudaSuccess;
}

template <bool kTw>
cudaError_t info_wide(int K, int* out) {
  if (K <= 40) return info_tile<kTw, 5, false>(out);
  if (K <= 48) return info_tile<kTw, 6, false>(out);
  if (K <= 56) return info_tile<kTw, 7, false>(out);
  if (K <= kXChunk) return info_tile<kTw, 8, false>(out);
  return info_tile<kTw, 8, true>(out);
}

// Grid y is B J in every launch of this file (at most 65535); grid z, the
// segments, is at most kXSplitBlocks; offsets are size_t.
bool bad_shape(int B, int J, int F, int N, int K) {
  return B <= 0 || J <= 0 || F <= 0 || N <= 0 || K <= 0 ||
         (long long)B * J > 65535LL;
}

}  // namespace

// C entry points, bound with ctypes (ops/cuda_spectral.py, ops/_build.py).
// Each kernel launches on `stream`, does not synchronise and allocates
// nothing: a launch that splits the contracted axis needs `ws`, the number
// of floats pyfasst_*_workspace gives (null where that is 0). The info
// calls write a kernel's occupancy and resources for the KMAX that K takes,
// or for the tiled kernel's instantiation above kMaxK (tw_stats: at F
// rows). Each returns a cudaError_t: 0 on success.
extern "C" int pyfasst_fb_stats(const float* xi, const float* FB,
                                const float* TW, const float* vfloor,
                                float* num, float* den, float* ws, int B,
                                int J, int F, int N, int K, void* stream) {
  if (bad_shape(B, J, F, N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BJ = B * J;
  if (K <= 8)
    return (int)launch_fb<8>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
  if (K <= 16)
    return (int)launch_fb<16>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
  if (K <= kMaxK)
    return (int)launch_fb<32>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
  return (int)launch_wide<false>(xi, FB, TW, vfloor, num, den, ws, BJ, F, N,
                                 K, s);
}

extern "C" int pyfasst_tw_stats(const float* xi, const float* FB,
                                const float* TW, const float* vfloor,
                                float* num, float* den, float* ws, int B,
                                int J, int F, int N, int K, void* stream) {
  if (bad_shape(B, J, F, N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BJ = B * J;
  if (K <= 8)
    return (int)launch_tw<8>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
  if (K <= 16)
    return (int)launch_tw<16>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
  if (K <= kMaxK)
    return (int)launch_tw<32>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
  return (int)launch_wide<true>(xi, FB, TW, vfloor, num, den, ws, BJ, F, N,
                                K, s);
}

// Floats of scratch the launch at this shape needs; -1 for a shape the
// kernels refuse.
extern "C" long long pyfasst_fb_stats_workspace(int B, int J, int F, int N,
                                                int K) {
  if (bad_shape(B, J, F, N, K)) return -1;
  return K <= kMaxK ? 0 : (long long)tile_workspace(false, B * J, F, N, K);
}

extern "C" long long pyfasst_tw_stats_workspace(int B, int J, int F, int N,
                                                int K) {
  if (bad_shape(B, J, F, N, K)) return -1;
  return K <= kMaxK ? 0 : (long long)tile_workspace(true, B * J, F, N, K);
}

extern "C" int pyfasst_tw_stats_info(int K, int F, int* out) {
  if (K <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (K <= 8) return (int)info_tw<8>(F, K, out);
  if (K <= 16) return (int)info_tw<16>(F, K, out);
  if (K <= kMaxK) return (int)info_tw<32>(F, K, out);
  return (int)info_wide<true>(K, out);
}

extern "C" int pyfasst_fb_stats_info(int K, int* out) {
  if (K <= 0) return (int)cudaErrorInvalidValue;
  if (K <= 8) return (int)info_fb<8>(out);
  if (K <= 16) return (int)info_fb<16>(out);
  if (K <= kMaxK) return (int)info_fb<32>(out);
  return (int)info_wide<false>(K, out);
}
