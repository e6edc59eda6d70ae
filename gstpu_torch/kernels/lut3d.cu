// lut3d_trilinear: colorlut's trilinear 3D LUT over u8 or u16 pixels.
//
// Replaces the Pallas kernel _lut_kernel of gstpu/ops/lut_pallas.py.
// That kernel recast the interpolation as a bf16 hat-weight matrix
// product to feed the TPU's matrix unit; Hopper needs no such detour,
// so one thread takes one pixel and does the exact 8-tap f32 gather of
// gstpu/ops/lut.py (apply_lut_3d), with its lerp order. The same
// kernel serves RGBA64 frames, where bf16 weights would cost ~100 LSBs.
//
// Bound: bytes. A 4K RGBA frame is 33 MB read and 33 MB written; the
// table (33^3 x 3 f32 = 431 KB) is too large for shared memory and is
// read through L2 with __ldg, where it stays resident. No texture
// filtering: its 8-bit fractional weights would cost the exact match.
//
// Numerics follow the XLA CPU compilation of apply_lut_3d bit for bit:
// XLA folds x / max * scale into x * (scale * (1/max)), which the
// caller passes as k; the domain affine, the seven lerps and the final
// x * max + 0.5 are contracted to FMA. Build with -fmad=false.
#include "common.cuh"

namespace {

struct Domain {
  float k[3];       // scale * (1 / max_val), rounded to f32
  float offset[3];
};

template <typename T>
struct Vec4;
template <>
struct Vec4<uint8_t> { using type = uchar4; };
template <>
struct Vec4<uint16_t> { using type = ushort4; };

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fmaf_rn(b - a, t, a);
}

template <typename T, int C>
__global__ void lut3d_kernel(const T* in, T* out, long long npix,
                             const float* __restrict__ table, int n,
                             Domain d, float max_val) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  T px[C];
  if constexpr (C == 4) {
    const auto q = reinterpret_cast<const typename Vec4<T>::type*>(in)[i];
    px[0] = q.x; px[1] = q.y; px[2] = q.z; px[3] = q.w;
  } else {
    for (int c = 0; c < C; ++c) px[c] = in[i * C + c];
  }

  const float last = static_cast<float>(n - 1);
  int i0[3], i1[3];
  float t[3];
  for (int c = 0; c < 3; ++c) {
    const float xyz =
        clamp01(__fmaf_rn(static_cast<float>(px[c]), d.k[c], d.offset[c])) *
        last;
    const int f = static_cast<int>(floorf(xyz));
    i0[c] = min(max(f, 0), n - 1);
    i1[c] = min(i0[c] + 1, n - 1);
    t[c] = xyz - static_cast<float>(i0[c]);
  }
  // table[z][y][x][3] with x = red, y = green, z = blue
  auto at = [&](int x, int y, int z, int c) {
    return __ldg(table + ((static_cast<long long>(z) * n + y) * n + x) * 3 + c);
  };
  for (int c = 0; c < 3; ++c) {
    const float c00 = lerp(at(i0[0], i0[1], i0[2], c),
                           at(i1[0], i0[1], i0[2], c), t[0]);
    const float c10 = lerp(at(i0[0], i1[1], i0[2], c),
                           at(i1[0], i1[1], i0[2], c), t[0]);
    const float c01 = lerp(at(i0[0], i0[1], i1[2], c),
                           at(i1[0], i0[1], i1[2], c), t[0]);
    const float c11 = lerp(at(i0[0], i1[1], i1[2], c),
                           at(i1[0], i1[1], i1[2], c), t[0]);
    const float c0 = lerp(c00, c10, t[1]);
    const float c1 = lerp(c01, c11, t[1]);
    const float res = lerp(c0, c1, t[2]);
    px[c] = static_cast<T>(
        __float2uint_rz(floorf(__fmaf_rn(clamp01(res), max_val, 0.5f))));
  }

  if constexpr (C == 4) {
    typename Vec4<T>::type q;
    q.x = px[0]; q.y = px[1]; q.z = px[2]; q.w = px[3];
    reinterpret_cast<typename Vec4<T>::type*>(out)[i] = q;
  } else {
    for (int c = 0; c < C; ++c) out[i * C + c] = px[c];
  }
}

template <typename T>
int launch(const void* in, void* out, long long npix, int channels,
           const float* table, int n, const Domain& d, float max_val,
           void* stream) {
  if (npix <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const T*>(in);
  auto* dst = static_cast<T*>(out);
  if (channels == 4) {
    lut3d_kernel<T, 4><<<blocks_for(npix), kThreads, 0, s>>>(
        src, dst, npix, table, n, d, max_val);
  } else if (channels == 3) {
    lut3d_kernel<T, 3><<<blocks_for(npix), kThreads, 0, s>>>(
        src, dst, npix, table, n, d, max_val);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// in/out: npix pixels of `channels` (3 or 4) values, aligned to a
// whole pixel for 4; table: (n, n, n, 3) f32 indexed [b][g][r].
// Returns the launch's cudaError_t.
extern "C" int lut3d_trilinear_u8(const void* in, void* out, long long npix,
                                  int channels, const float* table, int n,
                                  float k0, float k1, float k2, float o0,
                                  float o1, float o2, void* stream) {
  const Domain d{{k0, k1, k2}, {o0, o1, o2}};
  return launch<uint8_t>(in, out, npix, channels, table, n, d, 255.0f,
                         stream);
}

extern "C" int lut3d_trilinear_u16(const void* in, void* out,
                                   long long npix, int channels,
                                   const float* table, int n, float k0,
                                   float k1, float k2, float o0, float o1,
                                   float o2, void* stream) {
  const Domain d{{k0, k1, k2}, {o0, o1, o2}};
  return launch<uint16_t>(in, out, npix, channels, table, n, d, 65535.0f,
                          stream);
}
