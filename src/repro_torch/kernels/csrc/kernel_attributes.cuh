// What the compiler and the card give a kernel, for the wrappers' resource
// reports (kernels/build.py::kernel_attributes reads out[] in this order).
#pragma once

#include <cuda_runtime.h>

namespace fpps {

constexpr int kAttributeCount = 6;

// For the kernel `func` (a __global__ function's host address) launched
// with `threads` threads a block and no dynamic shared memory, on the
// current device: out[0] registers a thread, out[1] local (spill) bytes a
// thread, out[2] static shared bytes a block, out[3] the most threads a
// block may have, out[4] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[5] the most resident
// threads per SM. Returns a cudaError_t (0 on success).
inline int kernel_attributes(const void* func, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, func);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, func, threads,
                                                      0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0;
  int per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  out[4] = blocks;
  out[5] = per_sm;
  return 0;
}

}  // namespace fpps
