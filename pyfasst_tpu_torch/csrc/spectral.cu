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
//   tw_stats: one block per (b, j) and strip of 32 frames; lane = frame,
//     warp = every kTwWarps-th frequency. Each thread keeps its frame's K
//     values of TW and its 2K partial sums in registers; FB goes through
//     shared memory, kTwRows rows at a time, every lane reading the same
//     word (a broadcast). The warps' sums are then added in warp order in
//     shared memory. The TPU kernel writes one partial (K, N) block per
//     frequency block and XLA sums them (pallas_spectral.py:21-27), because
//     its sequential grid cannot revisit a (K, N) block between frequency
//     blocks; here one fixed-order sum over f per frame replaces them, with
//     no partials buffer.
//   No atomics: the results are the same from run to run. The dots are
//   plain fp32 multiply-adds in order k = 0 .. K-1 (no tensor cores, no
//   TF32), and the build's --fmad=false rounds each product on its own.
//   Divides are exact (1 / Vc, xi / (Vc Vc)), as in the Pallas kernels.
//
// Ragged edges: frames past N read nothing (fb_stats: the copy zero-fills
// TW and a select gives x, 1 / Vc and xi / Vc^2 of 0; tw_stats: a select
// gives 0) and are never written; frequency rows past F are never
// visited or written (fb_stats: the warp of such a row only helps stage TW)
// and their FB tile rows are selected to 0 (tw_stats).
//
// What bounds it on an H100: each kernel reads xi once, 4 B per
// (b, j, f, n), and FB, TW and its outputs, which are K / N and K / F of
// that: at B = 8, J = 2, F = 513, N = 863, K = 8, 28.3 MB of xi and under
// 1 MB else, ~8.7 us at 3.35 TB/s; against ~6K + 5 flops per element,
// 0.38 GFLOP, ~5.6 us at 67 TFLOP/s, or ~11 us at the 33.5 Tops/s that
// separate multiplies and adds (--fmad=false) can issue. Memory bounds it
// on paper. fb_stats runs at ~5x that bound (PERF.md). More TW reuse does
// little: 16 rows per block ran 2% faster at the bench shape, while 4 rows
// and 64-frame stages ran 13% slower (kernel_compare.py's variants), so
// the exact divides' dependent chains and the two barriers per stage are
// the suspects; the card's machine has no profiler that could split them.
// tw_stats keeps the design of its first port.
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
constexpr int kTwRows = 32;  // rows of FB per shared-memory tile

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

template <int KMAX>
__global__ void __launch_bounds__(kTwThreads)
tw_stats_kernel(const float* __restrict__ xi, const float* __restrict__ FB,
                const float* __restrict__ TW,
                const float* __restrict__ vfloor, float* __restrict__ num,
                float* __restrict__ den, int F, int N, int K) {
  extern __shared__ float red[];  // [kTwWarps][2K][32]
  __shared__ float fbt[kTwRows][KMAX];

  const int bj = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const bool valid = n < N;
  const size_t xoff = (size_t)bj * F * N + (valid ? n : 0);
  const float* fb = FB + (size_t)bj * F * K;
  const float vf = vfloor[bj];

  float h[KMAX], an[KMAX], ad[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    h[k] = (valid && k < K) ? TW[((size_t)bj * K + k) * N + n] : 0.f;
    an[k] = 0.f;
    ad[k] = 0.f;
  }

  for (int f0 = 0; f0 < F; f0 += kTwRows) {
    for (int i = threadIdx.x; i < kTwRows * KMAX; i += kTwThreads) {
      const int r = i / KMAX, k = i - r * KMAX;
      fbt[r][k] = (f0 + r < F && k < K) ? fb[(size_t)(f0 + r) * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTwRows / kTwWarps; ++i) {
      const int r = warp + kTwWarps * i;
      const int f = f0 + r;
      if (f < F) {  // uniform across the warp
        float V = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k < K) V += fbt[r][k] * h[k];
        const float Vc = fmaxf(V, vf);
        const float d = 1.0f / Vc;
        const float x = valid ? xi[xoff + (size_t)f * N] : 0.f;
        const float q = x / (Vc * Vc);
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k < K) {
            an[k] += fbt[r][k] * q;
            ad[k] += fbt[r][k] * d;
          }
        }
      }
    }
    __syncthreads();
  }

  // The warps' sums, added in warp order: column (warp, slot) per lane.
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) continue;
    red[((size_t)warp * 2 * K + k) * 32 + lane] = an[k];
    red[((size_t)warp * 2 * K + K + k) * 32 + lane] = ad[k];
  }
  __syncthreads();
  for (int s = warp; s < 2 * K; s += kTwWarps) {
    float t = red[(size_t)s * 32 + lane];
#pragma unroll
    for (int w2 = 1; w2 < kTwWarps; ++w2)
      t += red[((size_t)w2 * 2 * K + s) * 32 + lane];
    if (valid) {
      const bool is_num = s < K;
      const int k = is_num ? s : s - K;
      (is_num ? num : den)[((size_t)bj * K + k) * N + n] = t;
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

template <int KMAX>
cudaError_t launch_tw(const float* xi, const float* FB, const float* TW,
                      const float* vfloor, float* num, float* den, int BJ,
                      int F, int N, int K, cudaStream_t stream) {
  const size_t smem = (size_t)kTwWarps * 2 * K * 32 * sizeof(float);
  auto kernel = tw_stats_kernel<KMAX>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + 31) / 32, BJ);
  kernel<<<grid, kTwThreads, smem, stream>>>(xi, FB, TW, vfloor, num, den,
                                             F, N, K);
  return cudaGetLastError();
}

bool bad_shape(int B, int J, int F, int N, int K) {
  return B <= 0 || J <= 0 || F <= 0 || N <= 0 || K <= 0 || K > kMaxK ||
         (long long)B * J * F > 2147483647LL || (long long)B * J > 65535LL;
}

}  // namespace

// C entry points, bound with ctypes (ops/cuda_spectral.py, ops/_build.py).
// Each kernel launches on `stream`, does not synchronise and allocates
// nothing; the info call writes fb_stats' occupancy and resources for the
// KMAX that K takes. Each returns a cudaError_t: 0 on success.
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

extern "C" int pyfasst_fb_stats_info(int K, int* out) {
  if (K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (K <= 8) return (int)info_fb<8>(out);
  if (K <= 16) return (int)info_fb<16>(out);
  return (int)info_fb<32>(out);
}
