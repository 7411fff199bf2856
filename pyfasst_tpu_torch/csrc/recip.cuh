// The E-step kernels' reciprocal, exact or fast (kernel 1 variant e).
#pragma once

#include <cuda_runtime.h>

namespace pyfasst {

// 1 / x. With `fast` (GEMConfig.fast_recip; pallas_estep.py:114-124
// _recip): the hardware's approximate reciprocal, rcp.approx.f32 (at most
// 1 ulp from 1 / x on sm_90, denormals kept), refined by one Newton step
// r (2 - x r), the function the TPU kernel computes from its ~2^-8
// estimate. Without it: the exact IEEE divide. `fast` is uniform per
// launch, so the branch never diverges.
__device__ __forceinline__ float recip(float x, bool fast) {
  if (!fast) return 1.0f / x;
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r * (2.0f - x * r);
}

}  // namespace pyfasst
