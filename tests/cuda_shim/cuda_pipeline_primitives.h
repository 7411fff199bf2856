// cp.async for the CPU rehearsal (see cuda_runtime.h here): the copy is
// made at once, the last `zfill` bytes as zeros; commit and wait do nothing.
#pragma once

#include <stddef.h>
#include <string.h>

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t zfill = 0) {
  memcpy(dst, src, size - zfill);
  memset(static_cast<char*>(dst) + (size - zfill), 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
