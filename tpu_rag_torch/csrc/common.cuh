// Shared helpers of the tpu_rag_torch kernel libraries.
//
// Each library has a plain C interface loaded with ctypes (see _build.py):
// every entry returns cudaGetLastError() after its launch, and
// tr_error_string turns such a code into CUDA's message.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype codes shared with the Python wrappers
enum TrDtype { TR_F32 = 0, TR_BF16 = 1, TR_I8 = 2 };

__host__ __device__ inline size_t tr_align128(size_t x) { return (x + 127) & ~size_t(127); }
