// A stand-in for <cuda_runtime.h> that lets g++ compile the package's CUDA
// sources for the CPU, to rehearse their indexing, masking and barriers
// where there is no nvcc and no card (tests/test_torch_csrc_shim.py).
//
// One block runs at a time, each of its threads a std::thread: __syncthreads
// and __syncwarp are std::barriers, warp shuffles go through a slot per
// thread between two warp barriers, __shared__ is a static, and cp.async
// copies at once (so a missing wait does not show here). The test rewrites
// `kernel<<<grid, block, smem, stream>>>(args);` to shim::launch(...) and
// `extern __shared__` arrays to shim::dynamic_shared() in a scratch copy of
// the sources. Nothing here measures anything: the card's compiler, its
// memory model and its timing are only on the card.
#pragma once

#include <math.h>
#include <stddef.h>
#include <string.h>

#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __global__ static
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) alignas(n)
#define __launch_bounds__(...)

struct uint3 {
  unsigned x, y, z;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
struct cudaFuncAttributes {
  int numRegs = 0;
  size_t localSizeBytes = 0, sharedSizeBytes = 0;
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class T>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* attr, T*) {
  *attr = cudaFuncAttributes();
  return cudaSuccess;
}
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, T*, int,
                                                          size_t) {
  *blocks = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

namespace shim {

struct Block {
  explicit Block(int threads) : all(threads), slots(threads) {
    for (int w = 0; w < threads / 32; ++w)
      warps.push_back(std::make_unique<std::barrier<>>(32));
  }
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<float> slots;  // one per thread, for the shuffles
};

inline Block* block = nullptr;
inline void* dynamic = nullptr;
inline thread_local int tid = 0;

inline float* dynamic_shared() { return static_cast<float*>(dynamic); }

inline float shuffle(float v, int src_lane) {
  Block& b = *block;
  std::barrier<>& warp = *b.warps[tid / 32];
  b.slots[tid] = v;
  warp.arrive_and_wait();
  const float got = b.slots[(tid & ~31) | src_lane];
  warp.arrive_and_wait();
  return got;
}

// Runs body() once per thread of every block of the grid, one block at a
// time; the block's thread count must be a multiple of 32.
template <class Body>
void launch(dim3 grid, dim3 blk, size_t smem, cudaStream_t, Body&& body) {
  const int threads = (int)(blk.x * blk.y * blk.z);
  Block state(threads);
  std::vector<float4> buffer(smem / sizeof(float4) + 1);
  block = &state;
  dynamic = buffer.data();
  std::barrier<> turn(threads);
  auto worker = [&](int t) {
    tid = t;
    threadIdx = uint3{t % blk.x, (t / blk.x) % blk.y, t / (blk.x * blk.y)};
    blockDim = blk;
    gridDim = grid;
    for (unsigned z = 0; z < grid.z; ++z)
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          blockIdx = uint3{x, y, z};
          body();
          turn.arrive_and_wait();
        }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker, t);
  for (std::thread& th : pool) th.join();
  block = nullptr;
  dynamic = nullptr;
}

}  // namespace shim

inline void __syncthreads() { shim::block->all.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  shim::block->warps[shim::tid / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  return shim::shuffle(v, (shim::tid & 31) ^ lane_mask);
}
inline float __shfl_down_sync(unsigned, float v, int delta) {
  const int lane = shim::tid & 31;
  return shim::shuffle(v, lane + delta < 32 ? lane + delta : lane);
}
