// Shared helpers of the tpu_rag_torch kernel libraries.
//
// Each library has a plain C interface loaded with ctypes (see _build.py):
// every entry returns cudaGetLastError() after its launch, and
// tr_error_string turns such a code into CUDA's message.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "layout.h"  // the dtype codes, tr_align128 and the kernels' layouts

extern "C" const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
