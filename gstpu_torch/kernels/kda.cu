// kda_recurrence: Kimi Delta Attention's gated delta rule over a run of
// tokens, for every (row, head), with the 128 x 128 f32 state held on
// chip from the first token to the last.
//
// Replaces no TPU kernel: the JAX package has no linear attention. The
// port's plain form is gstpu_torch/ops/kda.py::kda_recurrence_plain, a
// loop of torch ops a token; this kernel computes the same steps in the
// same order, per token and head (S is K x V, K = V = 128):
//   S <- Diag(exp g) S;  u = v - S^T k;  S <- S + (beta k) u^T;
//   o = S^T (scale q).
// It serves prefill (a row's run of `lens[row]` tokens from a zero
// state, `fresh`) and decode (one token a row from the state it is
// given). The state is read at most once and written once per call.
//
// One CTA of 512 threads a (row, head). Warp w holds the columns
// 8w .. 8w + 7 of S; in a warp, lane l holds column 8w + (l & 7) in the
// rows 32 (l >> 3) .. 32 (l >> 3) + 31: 32 registers of state a thread.
// A sum over the rows (S^T k, S^T q) is 32 products in a thread and two
// xor shuffles across the warp's four row slabs, which leave the same
// value in the four lanes (f32 addition commutes). A quarter-warp reads
// one slab, so its float4 reads of the token's vectors from shared
// memory are one broadcast each. The token's q, k, v, g and beta come
// into shared memory one token ahead (double buffered): a thread loads
// one of the 512 values of the next token into a register before it
// computes the current one, and stores it after, so one __syncthreads
// a token suffices.
//
// Bound, at the cell's prefill (128 rows x ~1,020 tokens x 32 heads):
// per token and head ~7 x 128^2 = 115k f32 operations against 2.5 KB of
// inputs and output, so the card's f32 rate outside the tensor cores
// (67 TFLOP/s) bounds it, not its bytes. The recurrence is serial in
// the tokens: a CTA's time is its row's length times the latency of one
// token's step, and 4,096 CTAs fill the 132 SMs in ~31 waves. At decode
// (one token) the state's read and write, 128 KB a (row, head), bound
// it: 0.54 GB a layer at 128 rows.
//
// Built with -fmad=false: the products that are fused are written as
// __fmaf_rn (the sums over rows and the rank-1 update); the decay, the
// scale and beta's product are plain products.
#include "common.cuh"

namespace {

constexpr int kD = 128;      // key = value width of a head
constexpr int kT = 512;      // threads
constexpr int kRows = 32;    // rows of S a thread holds
constexpr unsigned kAll = 0xffffffffu;
enum { E = 0, K = 1, BK = 2, Q = 3, V = 4, kVecs = 5 };

struct Args {
  const float* q;
  const float* k;
  const float* v;
  long long qkv_row, qkv_tok;  // strides (elements) of q, k and v
  const float* g;
  long long g_row, g_tok;
  const float* beta;
  long long b_row, b_tok;
  float* o;
  long long o_row, o_tok;
  float* state;                // (rows, H, K, V) contiguous
  const int* lens;
  int L, H, fresh;
  float scale;
};

__device__ __forceinline__ float row_sum(float a) {
  a += __shfl_xor_sync(kAll, a, 8);
  a += __shfl_xor_sync(kAll, a, 16);
  return a;
}

__global__ void __launch_bounds__(kT) kda_kernel(const Args a) {
  __shared__ __align__(16) float buf[2][kVecs][kD];
  const int row = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int col = (tid >> 5) * 8 + (lane & 7);
  const int slab = (lane >> 3) * kRows;
  const int len = min(max(a.lens[row], 0), a.L);
  float* S = a.state + (static_cast<long long>(row) * a.H + h) * kD * kD;

  float s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    s[r] = a.fresh ? 0.0f : S[(slab + r) * kD + col];

  // the loader: thread tid brings element tid & 127 of q (tid < 128),
  // k with beta k, v, or exp(g) (tid >= 384)
  const int which = tid >> 7, i = tid & 127;
  const float* src;
  long long row_off, tok;
  if (which == 3) {
    src = a.g + h * kD + i;
    row_off = row * a.g_row;
    tok = a.g_tok;
  } else {
    src = (which == 0 ? a.q : which == 1 ? a.k : a.v) + h * kD + i;
    row_off = row * a.qkv_row;
    tok = a.qkv_tok;
  }
  src += row_off;
  const float* bsrc = a.beta + row * a.b_row + h;
  auto fetch = [&](int t, float& x, float& b) {
    x = __ldg(src + t * tok);
    if (which == 1) b = __ldg(bsrc + t * a.b_tok);
  };
  auto stage = [&](int t, float x, float b) {
    float* dst = buf[t & 1][0];
    if (which == 0) {
      dst[Q * kD + i] = x * a.scale;
    } else if (which == 1) {
      dst[K * kD + i] = x;
      dst[BK * kD + i] = b * x;
    } else if (which == 2) {
      dst[V * kD + i] = x;
    } else {
      dst[E * kD + i] = expf(x);
    }
  };

  float x = 0.0f, b = 0.0f;
  if (len > 0) {
    fetch(0, x, b);
    stage(0, x, b);
  }
  __syncthreads();
  float* out = a.o + row * a.o_row + h * kD + col;
  for (int t = 0; t < len; ++t) {
    const bool next = t + 1 < len;
    if (next) fetch(t + 1, x, b);
    const float(*cur)[kD] = buf[t & 1];
    const float4* e4 = reinterpret_cast<const float4*>(cur[E] + slab);
    const float4* k4 = reinterpret_cast<const float4*>(cur[K] + slab);
    // the decay, then S^T k
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < kRows / 4; ++m) {
      const float4 e = e4[m], kk = k4[m];
      s[4 * m] = s[4 * m] * e.x;
      acc = __fmaf_rn(s[4 * m], kk.x, acc);
      s[4 * m + 1] = s[4 * m + 1] * e.y;
      acc = __fmaf_rn(s[4 * m + 1], kk.y, acc);
      s[4 * m + 2] = s[4 * m + 2] * e.z;
      acc = __fmaf_rn(s[4 * m + 2], kk.z, acc);
      s[4 * m + 3] = s[4 * m + 3] * e.w;
      acc = __fmaf_rn(s[4 * m + 3], kk.w, acc);
    }
    const float u = cur[V][col] - row_sum(acc);
    // the rank-1 update, then S^T q
    const float4* bk4 = reinterpret_cast<const float4*>(cur[BK] + slab);
    const float4* q4 = reinterpret_cast<const float4*>(cur[Q] + slab);
    acc = 0.0f;
#pragma unroll
    for (int m = 0; m < kRows / 4; ++m) {
      const float4 bk = bk4[m], qq = q4[m];
      s[4 * m] = __fmaf_rn(bk.x, u, s[4 * m]);
      acc = __fmaf_rn(s[4 * m], qq.x, acc);
      s[4 * m + 1] = __fmaf_rn(bk.y, u, s[4 * m + 1]);
      acc = __fmaf_rn(s[4 * m + 1], qq.y, acc);
      s[4 * m + 2] = __fmaf_rn(bk.z, u, s[4 * m + 2]);
      acc = __fmaf_rn(s[4 * m + 2], qq.z, acc);
      s[4 * m + 3] = __fmaf_rn(bk.w, u, s[4 * m + 3]);
      acc = __fmaf_rn(s[4 * m + 3], qq.w, acc);
    }
    acc = row_sum(acc);
    if (slab == 0) out[t * a.o_tok] = acc;
    if (next) stage(t + 1, x, b);
    __syncthreads();
  }
  // a padded position's output is 0
  for (int t = len; t < a.L; ++t)
    if (slab == 0) out[t * a.o_tok] = 0.0f;

#pragma unroll
  for (int r = 0; r < kRows; ++r) S[(slab + r) * kD + col] = s[r];
}

}  // namespace

// q, k, v, g: (rows, L, H, 128) f32, head and element strides 128 and 1,
// row and token strides given; beta (rows, L, H) f32, head stride 1; o
// (rows, L, H, 128) f32, written for every position (0 past a row's
// length); state (rows, H, 128, 128) f32 contiguous, read unless
// `fresh` (a zero state) and written after each row's lens[row] tokens.
// Returns the launch's cudaError_t.
extern "C" int kda_recurrence(
    const float* q, const float* k, const float* v, long long qkv_row,
    long long qkv_tok, const float* g, long long g_row, long long g_tok,
    const float* beta, long long b_row, long long b_tok, float* o,
    long long o_row, long long o_tok, float* state, const int* lens,
    int rows, int L, int H, float scale, int fresh, void* stream) {
  if (rows < 0 || L < 0 || H <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const Args a{q,     k,     v,     qkv_row, qkv_tok, g,     g_row,
               g_tok, beta,  b_row, b_tok,   o,       o_row, o_tok,
               state, lens,  L,     H,       fresh,   scale};
  kda_kernel<<<rows * H, kT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
