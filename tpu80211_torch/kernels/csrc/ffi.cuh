// The host glue every kernel library shares (bound by kernels/_ffi.py).
//
// Each library's launch exports take the pointer table and its length
// first and the CUDA stream last, and return a CUDA error code; its
// attributes exports fill an int array through `occupancy`.  The one
// export that names an error code is ffi_error_string, here: every source
// includes this header once, and each builds to a library of its own.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace ffi {

// A kernel's registers and local (spill) bytes a thread, shared bytes a
// block (static, plus `smem` dynamic) and resident blocks of `threads` per
// SM on the current card, into out[0..3].
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  out[3] = blocks;
  return err;
}

}  // namespace ffi

extern "C" const char* ffi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
