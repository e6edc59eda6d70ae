// kweight_energies: the loudness measurement's K-weighting, from the
// interleaved f64 input to the energy of every 100 ms frame and
// channel, with both biquads' DF2T states carried.
//
// Replaces gstpu/ops/biquad.py::make_block_biquad (B4) as
// gstpu_torch/ops/loudnorm_dev.py::_make_measure composes it: the
// shelving and the high-pass stage in the exact block state-space form
// (L = 64), the squares, and the halving-tree sum of each frame. The
// eager form takes ~1,226 launches a call; this takes one.
//
// Bit for bit with that composition. Every multiply and add rounds on
// its own (__dmul_rn, __dadd_rn; built with -fmad=false besides), in
// its order:
// - a block's increment u = sum_j W[j] x[j] is the halving tree over
//   its 64 products; a frame's energy the halving tree over its
//   squares, padded with zeros to 32,768 (a 64-block is an aligned
//   subtree, so the frame's tree is the tree over its 300 block sums
//   padded to 512; the zeros add exactly as the plain form adds them);
// - output i of a block accumulates h[m] x[i-1-m] over ascending m onto
//   b0 x[i], then adds s0 O0[i], then s1 O1[i];
// - the block states follow associative_scan's odd/even recursion over
//   all n / 64 blocks of the call. That recursion gives block k the
//   left fold, largest first, of the aligned power-of-two nodes that
//   make up [0, k + 1), each node the balanced tree of its halves. The
//   maps' matrices are the same in every lane, so a node's matrix
//   depends on its level alone: the wrapper tabulates them. A CTA
//   builds the nodes ending in its frame in shared memory, and carries
//   from frame to frame the nodes that make up the blocks done so far
//   (one a level), so frames stream through it, any number of them.
//
// Bound, at 768 lanes (1,536 rows of 19,200 samples, one call): the
// input is 236 MB, 0.070 ms at 3.35 TB/s. The exact order admits no
// FMA and no tensor core: ~147 f64 operations a sample (the in-block
// FIR 63 a stage, the rest ~10 a stage and 2 for the energy), 4.33
// GFLOP, which is 0.127 ms at 34 TFLOP/s counted with FMAs as two, and
// 0.255 ms at the 17 T unfused operations a second the f64 pipe
// issues. So the pipe bounds it, and the design spends nothing else:
// - the frame comes into shared memory twenty loads a thread in flight
//   (cp.async copies measured no faster);
// - one CTA a row (lane, channel), one thread a 64-block of the frame:
//   the thread runs its block's FIR from its row of the frame in shared
//   memory, eight outputs at a time, each loaded sample feeding eight
//   multiply-adds, h[m] a broadcast; the output overwrites the input in
//   place, from the last group of eight down;
// - the next stage's increments (stage 1) or the block's energy (stage
//   2) come out of the same registers as each group of eight is done;
// - the scans run in shared memory, one level a step;
// - only the energies and the final states go back to device memory.
// 1,536 CTAs of 320 threads at ~181 KB of shared memory each fill the
// 132 SMs one CTA an SM, 11.6 waves. The callers' n: one frame (19,200)
// from make_steps (the inner step's meas_in and meas_out, the prime's
// 30 meas_in) and make_final_step; make_meter_step's x is a DeviceContext
// block, a multiple of the frame (30 frames in a priming fire). Any
// multiple of the frame fits; the wrapper refuses every other n.
#include "common.cuh"

namespace {

constexpr int kL = 64;            // block length
constexpr int kFB = 300;          // blocks in a 100 ms frame
constexpr int kFrame = kL * kFB;  // 19,200
constexpr int kT = 320;           // threads: a thread a block, whole warps
constexpr int kRow = kL + 1;      // a block's shared row, in doubles
constexpr int kLevels = 32;       // scan node levels tabulated

// One stage's coefficients, as the wrapper packs them (doubles):
// make_block_biquad's b0, h, O, W and M = A^L, and the matrix of a scan
// node of each level (level 0 is M).
struct Stage {
  double b0;
  double h[kL - 1];
  double O0[kL], O1[kL], W0[kL], W1[kL];
  double M[4];
  double node[kLevels][4];
};
static_assert(sizeof(Stage) == 452 * sizeof(double), "table layout");

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}

// The affine map x -> m x + v applied after `acc`: v' = m acc + v.
__device__ __forceinline__ double2 fold(const double* m, double2 acc,
                                        double2 v) {
  return make_double2(add(add(mul(m[0], acc.x), mul(m[1], acc.y)), v.x),
                      add(add(mul(m[2], acc.x), mul(m[3], acc.y)), v.y));
}

__device__ __forceinline__ double tree8(const double* p) {
  return add(add(add(p[0], p[1]), add(p[2], p[3])),
             add(add(p[4], p[5]), add(p[6], p[7])));
}

struct Shared {
  Stage stage[2];
  double2 node[kFB];        // slot k: the highest node ending at block k
  double2 state[2][kFB + 1];  // [0]: entering the frame; [k + 1]: after k
  double2 carry[2][kLevels];  // the nodes of the blocks before the frame
  double energy[kFB];
  double x[kFB * kRow];     // the frame, a row a block; then stage 1's output
};

// A block's increment sum_j W[j] x[j], as the halving tree.
__device__ __forceinline__ double2 increment(const double* X, const Stage& t) {
  double p0[8], p1[8];
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    double a[8], b[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      a[r] = mul(X[8 * g + r], t.W0[8 * g + r]);
      b[r] = mul(X[8 * g + r], t.W1[8 * g + r]);
    }
    p0[g] = tree8(a);
    p1[g] = tree8(b);
  }
  return make_double2(tree8(p0), tree8(p1));
}

// Stage t over the thread's block X, entering state s. The first stage
// writes its output over X and returns the second stage's increment
// (`next`'s W); the second returns the block's energy in .x.
template <bool kFirst>
__device__ __forceinline__ double2 filter(double* X, const Stage& t,
                                          double2 s, const Stage& next) {
  double p0[8], p1[8];
#pragma unroll
  for (int g = 7; g >= 0; --g) {
    const int i0 = 8 * g;
    double acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = mul(t.b0, X[i0 + r]);
    // xb[q] = x[i0 - 8 - mb + q]: step mb + k of output i0 + r reads
    // x[i0 + r - 1 - mb - k] = xb[7 - k + r]
    double xb[15];
#pragma unroll
    for (int q = 8; q < 15; ++q) xb[q] = X[i0 - 8 + q];
#pragma unroll 1
    for (int mb = 0; mb < i0; mb += 8) {
#pragma unroll
      for (int q = 0; q < 8; ++q) xb[q] = X[i0 - 8 - mb + q];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const double hv = t.h[mb + k];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r] = add(acc[r], mul(hv, xb[7 - k + r]));
      }
#pragma unroll
      for (int q = 0; q < 7; ++q) xb[q + 8] = xb[q];
    }
    // m = i0 + d reaches output i0 + r for r > d, at x[r - 1 - d];
    // xb[8 + p] holds x[p] for p < 7
#pragma unroll
    for (int d = 0; d < 7; ++d) {
      const double hv = t.h[i0 + d];
#pragma unroll
      for (int r = d + 1; r < 8; ++r)
        acc[r] = add(acc[r], mul(hv, xb[8 + r - 1 - d]));
    }
    double a[8], b[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      double y = add(acc[r], mul(s.x, t.O0[i0 + r]));
      y = add(y, mul(s.y, t.O1[i0 + r]));
      if constexpr (kFirst) {
        X[i0 + r] = y;
        a[r] = mul(y, next.W0[i0 + r]);
        b[r] = mul(y, next.W1[i0 + r]);
      } else {
        a[r] = mul(y, y);
      }
    }
    p0[g] = tree8(a);
    if constexpr (kFirst) p1[g] = tree8(b);
  }
  if constexpr (kFirst) return make_double2(tree8(p0), tree8(p1));
  return make_double2(tree8(p0), 0.0);
}

// The block states of the frame's blocks [P, P + kFB), from the leaves
// in sh.node: state[k + 1] after block P + k. Carries the frame's nodes
// on. Every thread calls it; it starts and ends with a barrier.
__device__ void scan(Shared& sh, const Stage& t, double2* state,
                     double2* carry, long long P) {
  const int k = threadIdx.x;
  __syncthreads();
  // up: a node of level j ending at e (exclusive) from its halves; the
  // right half ends at e too, and its slot takes the node
  for (int j = 1; (1LL << j) <= P + kFB; ++j) {
    const long long w = 1LL << j;
    const long long q = P / w + 1 + k;
    if (q <= (P + kFB) / w) {
      const long long e = q * w, le = e - w / 2;
      const double2 left = le > P ? sh.node[le - 1 - P] : carry[j - 1];
      sh.node[e - 1 - P] = fold(t.node[j - 1], left, sh.node[e - 1 - P]);
    }
    __syncthreads();
  }
  // down: block P + k's state is the fold of the nodes of [0, P + k + 1)
  if (k < kFB) {
    const long long Q = P + k + 1;
    int j = 63 - __clzll(Q);
    const long long e0 = (Q >> j) << j;
    double2 acc = e0 > P ? sh.node[e0 - 1 - P] : carry[j];
    for (--j; j >= 0; --j) {
      if (!((Q >> j) & 1)) continue;
      const long long e = (Q >> j) << j;
      acc = fold(t.node[j], acc, e > P ? sh.node[e - 1 - P] : carry[j]);
    }
    state[k + 1] = acc;
  }
  __syncthreads();
  // the nodes of [0, P + kFB) that end in this frame
  const long long P2 = P + kFB;
  if (k < kLevels && ((P2 >> k) & 1) && ((P2 >> k) << k) > P)
    carry[k] = sh.node[((P2 >> k) << k) - 1 - P];
  __syncthreads();
}

__global__ void __launch_bounds__(kT, 1)
    kweight_kernel(const double* __restrict__ x, long long row_stride, int C,
                   long long nsub, const double* __restrict__ z1,
                   const double* __restrict__ z2,
                   const double* __restrict__ tables,
                   double* __restrict__ z1_out, double* __restrict__ z2_out,
                   double* __restrict__ e) {
  extern __shared__ double4 raw[];
  Shared& sh = *reinterpret_cast<Shared*>(raw);
  const int k = threadIdx.x;
  const long long row = blockIdx.x;
  const long long b = row / C;
  const int c = static_cast<int>(row % C);
  {
    double* dst = reinterpret_cast<double*>(sh.stage);
    for (int i = k; i < static_cast<int>(sizeof(sh.stage) / sizeof(double));
         i += kT)
      dst[i] = tables[i];
  }
  if (k == 0) {
    sh.state[0][0] = make_double2(z1[2 * row], z1[2 * row + 1]);
    sh.state[1][0] = make_double2(z2[2 * row], z2[2 * row + 1]);
  }
  // (the first frame's barrier publishes the tables and states too)
  const Stage& s1 = sh.stage[0];
  const Stage& s2 = sh.stage[1];
  const double* xr = x + b * row_stride + c;
  double* X = sh.x + k * kRow;
  for (long long f = 0; f < nsub; ++f) {
    const long long P = f * kFB;
    const double* src = xr + f * kFrame * C;
#pragma unroll 20
    for (int i = k; i < kFrame; i += kT)
      sh.x[(i / kL) * kRow + i % kL] = __ldg(src + static_cast<long long>(i) * C);
    __syncthreads();
    if (k < kFB) {
      double2 u = increment(X, s1);
      if (P == 0 && k == 0) {   // the entering state, folded into block 0
        const double2 z = sh.state[0][0];
        u.x = add(u.x, add(mul(s1.M[0], z.x), mul(s1.M[1], z.y)));
        u.y = add(u.y, add(mul(s1.M[2], z.x), mul(s1.M[3], z.y)));
      }
      sh.node[k] = u;
    }
    scan(sh, s1, sh.state[0], sh.carry[0], P);
    if (k < kFB) {
      double2 u = filter<true>(X, s1, sh.state[0][k], s2);
      if (P == 0 && k == 0) {
        const double2 z = sh.state[1][0];
        u.x = add(u.x, add(mul(s2.M[0], z.x), mul(s2.M[1], z.y)));
        u.y = add(u.y, add(mul(s2.M[2], z.x), mul(s2.M[3], z.y)));
      }
      sh.node[k] = u;
    }
    scan(sh, s2, sh.state[1], sh.carry[1], P);
    if (k < kFB) sh.energy[k] = filter<false>(X, s2, sh.state[1][k], s2).x;
    __syncthreads();
    if (k < 32) {  // the 300 block sums padded to 512: 16 a lane
      double v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        v[i] = 16 * k + i < kFB ? sh.energy[16 * k + i] : 0.0;
      double sum = add(tree8(v), tree8(v + 8));
#pragma unroll
      for (int off = 1; off < 32; off *= 2)
        sum = add(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      if (k == 0) {
        e[(b * nsub + f) * C + c] = sum;
        sh.state[0][0] = sh.state[0][kFB];
        sh.state[1][0] = sh.state[1][kFB];
      }
    }
    __syncthreads();
  }
  if (k == 0) {
    z1_out[2 * row] = sh.state[0][0].x;
    z1_out[2 * row + 1] = sh.state[0][0].y;
    z2_out[2 * row] = sh.state[1][0].x;
    z2_out[2 * row + 1] = sh.state[1][0].y;
  }
}

}  // namespace

// x: `lanes` rows of n * C interleaved f64 samples, lane b at x + b *
// row_stride; n = nsub frames of 19,200. z1, z2: (lanes * C, 2)
// entering states of the two stages; tables: the wrapper's 2 x 452
// doubles. Writes z1_out, z2_out (lanes * C, 2) and e (lanes, nsub, C).
// Returns the launch's cudaError_t.
extern "C" int kweight_energies(const double* x, long long row_stride,
                                int lanes, int C, long long nsub,
                                const double* z1, const double* z2,
                                const double* tables, double* z1_out,
                                double* z2_out, double* e, void* stream) {
  if (lanes <= 0 || C <= 0 || nsub <= 0 || lanes > 0x7fffffff / C)
    return cudaErrorInvalidValue;
  const int bytes = static_cast<int>(sizeof(Shared));
  cudaError_t err = cudaFuncSetAttribute(
      kweight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kweight_kernel<<<lanes * C, kT, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, row_stride, C, nsub, z1, z2, tables, z1_out, z2_out, e);
  return cudaGetLastError();
}
