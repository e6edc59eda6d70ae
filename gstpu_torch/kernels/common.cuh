// Shared by every kernel library of the port (one .cu per library).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Text of a cudaError_t returned by an entry point.
extern "C" const char* gstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Blocks of 256 threads covering `n` items, one item per thread.
constexpr int kThreads = 256;
inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}
