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
// registers, and each kernel reads xi once.
//
// Design.
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

bool bad_shape(int B, int J, int F, int N, int K) {
  return B <= 0 || J <= 0 || F <= 0 || N <= 0 || K <= 0 || K > kMaxK ||
         (long long)B * J * F > 2147483647LL || (long long)B * J > 65535LL;
}

}  // namespace

// C entry points, bound with ctypes (ops/cuda_spectral.py, ops/_build.py).
// Each kernel launches on `stream`, does not synchronise and allocates
// nothing; the info calls write a kernel's occupancy and resources for the
// KMAX that K takes (tw_stats: at F rows). Each returns a cudaError_t: 0 on
// success.
extern "C" int pyfasst_fb_stats(const float* xi, const float* FB,
                                const float* TW, const float* vfloor,
                                float* num, float* den, int B, int J, int F,
                                int N, int K, void* stream) {
  if (bad_shape(B, J, F, N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BJ = B * J;
  if (K <= 8)
    return (int)launch_fb<8>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
  if (K <= 16)
    return (int)launch_fb<16>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
  return (int)launch_fb<32>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
}

extern "C" int pyfasst_tw_stats(const float* xi, const float* FB,
                                const float* TW, const float* vfloor,
                                float* num, float* den, int B, int J, int F,
                                int N, int K, void* stream) {
  if (bad_shape(B, J, F, N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BJ = B * J;
  if (K <= 8)
    return (int)launch_tw<8>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
  if (K <= 16)
    return (int)launch_tw<16>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
  return (int)launch_tw<32>(xi, FB, TW, vfloor, num, den, BJ, F, N, K, s);
}

extern "C" int pyfasst_tw_stats_info(int K, int F, int* out) {
  if (K <= 0 || K > kMaxK || F <= 0) return (int)cudaErrorInvalidValue;
  if (K <= 8) return (int)info_tw<8>(F, K, out);
  if (K <= 16) return (int)info_tw<16>(F, K, out);
  return (int)info_tw<32>(F, K, out);
}

extern "C" int pyfasst_fb_stats_info(int K, int* out) {
  if (K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (K <= 8) return (int)info_fb<8>(out);
  if (K <= 16) return (int)info_fb<16>(out);
  return (int)info_fb<32>(out);
}
