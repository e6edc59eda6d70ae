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

// Exact integer <-> f32 forms on the FP32 pipe, in place of the
// quarter-rate conversion instructions: 2^23 + v has v in its low
// mantissa bits for 0 <= v < 2^23.
constexpr float kTwo23 = 8388608.0f;
__device__ __forceinline__ float u32_to_f32(uint32_t v) {  // v < 2^23
  return __uint_as_float(0x4B000000u | v) - kTwo23;
}
// floor(x) for 0 <= x < 2^23, in the low bits of the result: the sum
// rounded toward zero drops x's fraction.
__device__ __forceinline__ uint32_t floor_bits(float x) {
  return __float_as_uint(__fadd_rz(x, kTwo23)) - 0x4B000000u;
}

constexpr int kThreads = 256;

// A frame of npix pixels of `pixel_bytes` bytes, cut for 16-byte
// access: pixels [0, head) and [head + nvec * per_vec, npix) go one at
// a time, the nvec 16-byte vectors between them whole. With no
// vectors (3-byte pixels, or in and out not equally aligned) every
// pixel goes one at a time.
struct Split {
  long long head, nvec;
};
inline Split split_frame(const void* in, const void* out, long long npix,
                         int pixel_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(in);
  const uintptr_t b = reinterpret_cast<uintptr_t>(out);
  if (16 % pixel_bytes || a % pixel_bytes || (a - b) % 16) return {0, 0};
  const long long per_vec = 16 / pixel_bytes;
  long long head = static_cast<long long>((16 - a % 16) % 16) / pixel_bytes;
  if (head > npix) head = npix;
  return {head, (npix - head) / per_vec};
}

// Blocks for a grid-stride kernel of kThreads threads: as many as the
// card holds at once, no more than `work` items need.
template <auto Kernel>
unsigned int grid_for(long long work) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads,
                                                  0);
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (work + kThreads - 1) / kThreads;
  const long long full = static_cast<long long>(sms) * per_sm;
  return static_cast<unsigned int>(need < full ? (need > 0 ? need : 1)
                                               : full);
}

// Runs f on the 16-byte vectors [0, nvec) of `in`, writing `out`, in a
// grid-stride loop that whole warps go round together, so that f may
// shuffle between lanes: a lane past the end runs f on a zero vector
// and stores nothing. Each lane loads its next vector before it runs f
// on the current one. `in` may equal `out`: a lane reads its vector
// before it writes it.
template <typename F>
__device__ __forceinline__ void for_each_vector(const uint4* in, uint4* out,
                                                long long nvec, F f) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x % 32;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint4 cur = i < nvec ? in[i] : uint4{};
  for (; i - lane < nvec; i += stride) {
    const uint4 next = i + stride < nvec ? in[i + stride] : uint4{};
    const uint4 q = f(cur);
    if (i < nvec) out[i] = q;
    cur = next;
  }
}

// Runs f(p) on each pixel p that split_frame left to go one at a time,
// grid-stride.
template <typename F>
__device__ __forceinline__ void for_each_single(long long npix, Split s,
                                                int per_vec, F f) {
  const long long body = s.nvec * per_vec;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k =
           static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < npix - body; k += stride)
    f(k < s.head ? k : k + body);
}
