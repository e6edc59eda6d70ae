// lut3d_trilinear: colorlut's trilinear 3D LUT over u8 or u16 pixels.
//
// Replaces the Pallas kernel _lut_kernel of gstpu/ops/lut_pallas.py.
// That kernel recast the interpolation as a bf16 hat-weight matrix
// product to feed the TPU's matrix unit; Hopper needs no such detour,
// so each pixel does the exact 8-tap f32 gather of gstpu/ops/lut.py
// (apply_lut_3d), with its lerp order. The same kernel serves RGBA64
// frames, where bf16 weights would cost ~100 LSBs.
//
// Bound: the frame's bytes in theory (a 4K RGBA frame is 33 MB read and
// 33 MB written, the 33^3 table 431 KB); in practice the gathers. A
// graded frame's corners scatter over a table too large for L1 or
// shared memory, so the corners come from L2 one 32-byte sector at a
// time, and the sectors a pixel asks for set the time. The design cuts
// them from ~10 to 3:
// - the table comes packed by corners (ops/lut.py, pack_lut_3d):
//   (n, n, n, 24) f32, entry [z][y][x] = for each channel its 8
//   corners (x fastest, then y, then z) with the upper index of each
//   axis clamped at n - 1. A pixel's corners are one 96-byte entry, a
//   channel's eight one sector: the same 8 values, clamp and lerp order
//   as the unpacked table, so the same bits. No texture filtering: its
//   8-bit fractional weights would cost the exact match.
// - the two lanes of a pair load the two halves of each sector in the
//   same instruction, so the L1 asks L2 for the sector once: a pixel
//   costs each lane 3 16-byte loads. Even lanes interpolate the z0
//   plane, odd lanes the z1 plane, of both lanes' pixels; one shuffle
//   per channel hands each lane the other plane of its own pixel.
// - the frame moves 16 bytes a lane (4 RGBA8 or 2 RGBA64 pixels) in a
//   grid-stride loop over a grid the card holds at once; the unaligned
//   head and tail of a frame and 3-channel frames go one pixel a lane,
//   without pairs.
// - no conversion instruction: u8/u16 -> f32, the floor and the final
//   rounding use the exact FP32-pipe forms of common.cuh.
//
// Numerics follow the XLA CPU compilation of apply_lut_3d bit for bit:
// XLA folds x / max * scale into x * (scale * (1/max)), which the
// caller passes as k; the domain affine, the seven lerps and the final
// x * max + 0.5 are contracted to FMA. Build with -fmad=false.
#include "common.cuh"

namespace {

constexpr int kEntry = 24;  // floats per packed entry: 3 channels x 8

struct Domain {
  float k[3];       // scale * (1 / max_val), rounded to f32
  float offset[3];
};

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fmaf_rn(b - a, t, a);
}

// The bilinear step in one z plane: corners (x0, y0), (x1, y0), (x0,
// y1), (x1, y1) in that order.
__device__ __forceinline__ float plane(float4 q, float tx, float ty) {
  return lerp(lerp(q.x, q.y, tx), lerp(q.z, q.w, tx), ty);
}

struct Ctx {
  const float4* table;  // packed, (n, n, n, 24) f32 as float4s
  int n;
  Domain d;
  float max_val;
};

// A pixel's place in the table: its entry, in float4s, and the weights
// of the upper corners.
struct Cell {
  int e;
  float t[3];
};

__device__ __forceinline__ Cell locate(const Ctx& c, uint32_t v0, uint32_t v1,
                                       uint32_t v2) {
  const uint32_t v[3] = {v0, v1, v2};
  Cell cell;
  int i0[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    // clamp01(v * k + offset) * (n - 1), its floor i0 (<= n - 1) and
    // the weight of the upper corner
    const float xyz = clamp01(__fmaf_rn(u32_to_f32(v[ch]), c.d.k[ch],
                                        c.d.offset[ch])) *
                      static_cast<float>(c.n - 1);
    i0[ch] = min(static_cast<int>(floor_bits(xyz)), c.n - 1);
    cell.t[ch] = xyz - u32_to_f32(i0[ch]);
  }
  cell.e = ((i0[2] * c.n + i0[1]) * c.n + i0[0]) * (kEntry / 4);
  return cell;
}

// floor(res * max + 0.5) in [0, max]
__device__ __forceinline__ uint32_t finish(const Ctx& c, float res) {
  return floor_bits(__fmaf_rn(clamp01(res), c.max_val, 0.5f));
}

// One pixel by one lane: its entry's 6 float4s.
__device__ __forceinline__ void lut_pixel(const Ctx& c, uint32_t v0,
                                          uint32_t v1, uint32_t v2,
                                          uint32_t o[3]) {
  const Cell cell = locate(c, v0, v1, v2);
  float4 q[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) q[j] = __ldg(c.table + cell.e + j);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float c0 = plane(q[2 * ch], cell.t[0], cell.t[1]);
    const float c1 = plane(q[2 * ch + 1], cell.t[0], cell.t[1]);
    o[ch] = finish(c, lerp(c0, c1, cell.t[2]));
  }
}

// One pixel per lane by a lane pair: `odd` is the lane's place in the
// pair, which fixes its z plane. Every lane of the warp must call it.
__device__ __forceinline__ void lut_pixel_paired(const Ctx& c, bool odd,
                                                 uint32_t v0, uint32_t v1,
                                                 uint32_t v2, uint32_t o[3]) {
  const Cell mine = locate(c, v0, v1, v2);
  const int e_x = __shfl_xor_sync(0xffffffffu, mine.e, 1);
  const float tx_x = __shfl_xor_sync(0xffffffffu, mine.t[0], 1);
  const float ty_x = __shfl_xor_sync(0xffffffffu, mine.t[1], 1);
  // the even lane's pixel, then the odd lane's; this lane's half of
  // each sector
  const float4* ea = c.table + (odd ? e_x : mine.e) + odd;
  const float4* eb = c.table + (odd ? mine.e : e_x) + odd;
  float4 qa[3], qb[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) qa[ch] = __ldg(ea + 2 * ch);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) qb[ch] = __ldg(eb + 2 * ch);
  const float txa = odd ? tx_x : mine.t[0], tya = odd ? ty_x : mine.t[1];
  const float txb = odd ? mine.t[0] : tx_x, tyb = odd ? mine.t[1] : ty_x;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float ra = plane(qa[ch], txa, tya);  // the even lane's pixel
    const float rb = plane(qb[ch], txb, tyb);  // the odd lane's pixel
    // each lane sends the plane its partner's pixel needs
    const float got = __shfl_xor_sync(0xffffffffu, odd ? ra : rb, 1);
    const float c0 = odd ? got : ra, c1 = odd ? rb : got;
    o[ch] = finish(c, lerp(c0, c1, mine.t[2]));
  }
}

template <typename T>
__device__ __forceinline__ uint4 lut_vector(const Ctx& c, bool odd, uint4 q);

// 4 RGBA8 pixels, one 32-bit word each
template <>
__device__ __forceinline__ uint4 lut_vector<uint8_t>(const Ctx& c, bool odd,
                                                     uint4 q) {
  uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    uint32_t o[3];
    lut_pixel_paired(c, odd, w[p] & 0xffu, (w[p] >> 8) & 0xffu,
                     (w[p] >> 16) & 0xffu, o);
    w[p] = o[0] | (o[1] << 8) | (o[2] << 16) | (w[p] & 0xff000000u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 2 RGBA64 pixels, two 32-bit words each
template <>
__device__ __forceinline__ uint4 lut_vector<uint16_t>(const Ctx& c, bool odd,
                                                      uint4 q) {
  uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t rg = w[2 * p], ba = w[2 * p + 1];
    uint32_t o[3];
    lut_pixel_paired(c, odd, rg & 0xffffu, rg >> 16, ba & 0xffffu, o);
    w[2 * p] = o[0] | (o[1] << 16);
    w[2 * p + 1] = o[2] | (ba & 0xffff0000u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    lut3d_kernel(const T* in, T* out, long long npix, Split s,
                 const float4* __restrict__ table, int n, Domain d,
                 float max_val) {
  const Ctx c{table, n, d, max_val};
  if constexpr (C == 4) {
    const bool odd = threadIdx.x & 1;
    for_each_vector(reinterpret_cast<const uint4*>(in + s.head * C),
                    reinterpret_cast<uint4*>(out + s.head * C), s.nvec,
                    [&](uint4 q) { return lut_vector<T>(c, odd, q); });
  }
  for_each_single(npix, s, C == 4 ? 16 / (4 * sizeof(T)) : 1,
                  [&](long long p) {
                    const T* px = in + p * C;
                    uint32_t o[3];
                    lut_pixel(c, px[0], px[1], px[2], o);
                    T* dst = out + p * C;
                    if constexpr (C == 4) dst[3] = px[3];
                    dst[0] = o[0];
                    dst[1] = o[1];
                    dst[2] = o[2];
                  });
}

template <typename T, int C>
int launch_one(const T* in, T* out, long long npix, const float4* table,
               int n, const Domain& d, float max_val, cudaStream_t stream) {
  const Split s = C == 4 ? split_frame(in, out, npix, C * sizeof(T))
                         : Split{0, 0};
  const long long body = s.nvec * (16 / (C * sizeof(T)));
  const long long work = s.nvec > npix - body ? s.nvec : npix - body;
  lut3d_kernel<T, C><<<grid_for<lut3d_kernel<T, C>>(work), kThreads, 0,
                       stream>>>(in, out, npix, s, table, n, d, max_val);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, long long npix, int channels,
           const float* table, int n, const Domain& d, float max_val,
           void* stream) {
  if (npix <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const T*>(in);
  auto* dst = static_cast<T*>(out);
  const auto* t = reinterpret_cast<const float4*>(table);
  if (channels == 4)
    return launch_one<T, 4>(src, dst, npix, t, n, d, max_val, s);
  if (channels == 3)
    return launch_one<T, 3>(src, dst, npix, t, n, d, max_val, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// in/out: npix pixels of `channels` (3 or 4) values, aligned to a
// whole pixel for 4; table: the (n, n, n, 24) f32 corner-packed table,
// 16-byte aligned (32-byte for one sector per channel). Returns the
// launch's cudaError_t.
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
