// limiter_frame: the true-peak limiter over the next nb samples of every
// lane's limiter window, in one launch: the candidate peaks, the
// segment machine, the envelope, its product with the window's head
// and the clip.
//
// Replaces the jit B5 gstpu/ops/loudnorm_dev.py::_limiter_frame (a
// lax.while_loop), which the port ran as a Python loop of ~200 torch
// ops an iteration that asked the card before each iteration whether
// any lane was short of nb: a host wait an iteration. Here nothing
// waits and the iterations run on the card.
//
// Bit for bit with loudnorm_dev._limiter_frame_plain on a CUDA tensor.
// Every multiply, add and divide rounds on its own (__dmul_rn,
// __dadd_rn, __ddiv_rn; built with -fmad=false besides), in the plain
// form's order. The plain form divides by a Python number, env / 1919
// and env / 19199, as a product with the number's reciprocal (what
// PyTorch does on CUDA); the wrapper passes those reciprocals. Its
// `tp / pv` is reciprocal(pv) * tp (torch's __rtruediv__).
//
// One CTA a lane, three phases:
// 1. The candidate peaks of detect_peak as a bitmask in shared memory,
//    bit p for position p of [0, NPEAK): per channel prev <= this >=
//    next, this > tp and each of p+2..p+11 <= this; a position hits if
//    any channel does. Tiles of the |x| window with a 12-sample halo
//    come into shared memory, each warp tests 32 positions at a time
//    and one ballot gives a word.
// 2. Warp 0 runs the segment machine, `body` line for line as scalar
//    code (its lanes hold the same state), until smp >= nb. detect(smp)
//    is the first set bit in (smp + LOOKAHEAD, nb + LOOKAHEAD): the
//    warp reads 32 words at a time and a ballot finds the first that
//    is not zero. Each iteration appends its linear and its constant
//    range, where not empty, to a list in shared memory; when the list
//    is full, and when the machine is done, every thread writes the
//    listed ranges into the frame's gain G in shared memory (1 where no
//    range covers a sample). An iteration writes only inside [smp, its
//    new smp) and smp never falls, so the ranges are disjoint and each
//    sample takes the one range that covers it, as the plain form's
//    two torch.wheres an iteration leave it. Not every iteration
//    advances smp, but at most three in a row leave it where it is
//    (the order test shows it over seeded random frames): a frame of
//    nb samples takes at most 4 nb iterations. A sustained plateau
//    above the ceiling (every position a peak) takes about nb. Past
//    4 nb + 4 iterations the machine stops: only a state outside the
//    machine's (an attack counter past ATTACK, a state number past
//    REL) gets there, where the plain form would loop for ever.
// 3. Every thread writes the new window, its head lim * G and then the
//    untouched tail (the caller's window is not changed), and the
//    clipped head.
//
// Bound, at 768 lanes of 2 channels: the window read once (40,320 x 2
// doubles a lane) and the new window and the output written (40,320 x 2
// and 19,200 x 2): 1.23 GB, 0.37 ms at 3.35 TB/s. The peak test's
// ~30 f64 compares a position are ~1 GFLOP in all, far under the
// bytes. The design spends the bytes once: phase 1 reads the |x|
// window, phase 3 reads the head again (mostly from L2) and the tail.
// The segment machine is serial, a few microseconds a lane for the few
// iterations of a frame of programme audio; CTAs of other lanes keep
// the SM's memory traffic going meanwhile only where two fit: the gain
// takes 150 KB of shared memory, so one CTA an SM, 768 CTAs in 5.8
// waves.
#include "common.cuh"

namespace {

constexpr int kFrame = 19200;
constexpr int kLookahead = 1920;
constexpr int kAttack = 1920;
constexpr int kRelease = 19200;
constexpr int kLim = 2 * kFrame + kLookahead;     // window samples
constexpr int kAbsw = kFrame + kLookahead + 12;   // |x| samples read
constexpr int kNpeak = kFrame + kLookahead + 1;   // candidate positions
constexpr int kWords = (kNpeak + 31) / 32;
constexpr int kT = 512;
constexpr int kWarps = kT / 32;
constexpr int kSegs = 128;
constexpr unsigned kAll = 0xffffffffu;
enum { OUT = 0, ATT = 1, SUS = 2, REL = 3 };

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double quot(double a, double b) {
  return __ddiv_rn(a, b);
}
// torch's clamp: NaN passes through
__device__ __forceinline__ double clamp(double v, double lo, double hi) {
  return isnan(v) ? v : fmin(fmax(v, lo), hi);
}

// One range [start, end) of the gain: g(i) = base - ((t0 + (i - ref)) /
// denom) * diff where linear, else g(i) = base.
struct Seg {
  int start, end, ref, linear;
  double t0, denom, diff, base;
};

struct Shared {
  double G[kFrame];           // phase 1: the |x| tiles; then the gain
  unsigned mask[kWords + 3];
  Seg seg[kSegs];
  int nseg, done;
};

__global__ void __launch_bounds__(kT, 1)
    limiter_kernel(const double* __restrict__ lim, long long row_stride,
                   int C, int nb, double tp, double inv_attack,
                   double inv_release, const double* __restrict__ gr0_in,
                   const double* __restrict__ gr1_in,
                   const int* __restrict__ ls_in,
                   const int* __restrict__ env_in,
                   const int* __restrict__ sus_in,
                   double* __restrict__ lim_out, double* __restrict__ out,
                   double* __restrict__ gr0_out,
                   double* __restrict__ gr1_out, int* __restrict__ ls_out,
                   int* __restrict__ env_out, int* __restrict__ sus_out,
                   int* __restrict__ iters_out) {
  extern __shared__ double4 raw[];
  Shared& sh = *reinterpret_cast<Shared*>(raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long b = blockIdx.x;
  const double* x = lim + b * row_stride;

  // 1. the candidate peaks, a tile of TP positions at a time: row c of
  // the tile holds |x| of channel c at positions p0 - 1 .. p0 + TP + 11
  {
    const int TP = (kFrame / C - 13) / 32 * 32;
    const int W = TP + 13;
    double* A = sh.G;
    for (int p0 = 0; p0 < kNpeak; p0 += TP) {
      const long long first = static_cast<long long>(p0 - 1) * C;
      for (int i = tid; i < W * C; i += kT) {
        const long long k = first + i;
        const double v = k >= 0 && k < static_cast<long long>(kAbsw) * C
                             ? fabs(__ldg(x + k)) : 0.0;
        A[(i % C) * W + i / C] = v;
      }
      __syncthreads();
      for (int w = warp; w < TP / 32; w += kWarps) {
        const int p = p0 + 32 * w + lane;
        bool hit = false;
        if (p >= 1 && p < kNpeak) {
          const int j = p - p0 + 1;
          for (int c = 0; c < C; ++c) {
            const double* r = A + c * W + j;
            const double t = r[0];
            bool ok = r[-1] <= t && t >= r[1] && t > tp;
#pragma unroll
            for (int k = 2; k < 12; ++k) ok = ok && r[k] <= t;
            hit = hit || ok;
          }
        }
        const unsigned word = __ballot_sync(kAll, hit);
        const int wi = p0 / 32 + w;
        if (lane == 0 && wi < kWords) sh.mask[wi] = word;
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < kFrame; i += kT) sh.G[i] = 1.0;

  // 2. the segment machine in warp 0, its ranges written by every thread
  double gr0 = gr0_in[b], gr1 = gr1_in[b];
  int ls = ls_in[b], env = env_in[b], sus = sus_in[b], smp = 0, iters = 0;
  const int cap = 4 * nb + 4;
  for (;;) {
    if (warp == 0) {
      int n = 0;
      while (smp < nb && n + 2 <= kSegs && iters < cap &&
             ls >= OUT && ls <= REL) {
        // detect(smp): the first peak q in (smp + LOOKAHEAD, nb + LOOKAHEAD)
        const int lo = smp + kLookahead + 1, hi = nb + kLookahead;
        int q = -1;
        if (lo < hi) {
          const int wl = lo >> 5, wh = (hi - 1) >> 5;
          for (int w0 = wl; w0 <= wh; w0 += 32) {
            const int w = w0 + lane;
            unsigned m = 0;
            if (w <= wh) {
              m = sh.mask[w];
              if (w == wl) m &= kAll << (lo & 31);
              if (w == wh) {
                const int bits = hi - 32 * w;
                if (bits < 32) m &= (1u << bits) - 1u;
              }
            }
            const unsigned any = __ballot_sync(kAll, m != 0);
            if (any) {
              const int l = __ffs(any) - 1;
              const unsigned mw = __shfl_sync(kAll, m, l);
              q = 32 * (w0 + l) + __ffs(mw) - 1;
              break;
            }
          }
        }
        const bool found = q >= 0;
        // jnp.argmax of an all-false mask is 0
        const int np_smp = (found ? q : 0) - kLookahead;
        double pv = 1.0;
        if (found) {  // V[q]: the channels' amax, NaN propagating
          pv = fabs(x[static_cast<long long>(q) * C]);
          for (int c = 1; c < C; ++c) {
            const double v = fabs(x[static_cast<long long>(q) * C + c]);
            if (!isnan(pv) && (isnan(v) || v > pv)) pv = v;
          }
        }
        // tp / where(found, pv, 1.0): reciprocal(.) * tp
        const double gnew = mul(quot(1.0, pv), tp);
        const double envf = static_cast<double>(env);

        int n_ls = ls, n_env = env, n_sus = sus, n_smp = smp;
        double n_gr0 = gr0, n_gr1 = gr1;
        int lin_start = 0, lin_len = 0, const_start = 0, const_len = 0;
        double lin_denom = kAttack - 1.0, lin_diff = sub(gr0, gr1);
        if (ls == OUT) {
          n_smp = found ? smp + kLookahead + np_smp - smp - kAttack : nb;
          if (found) {
            n_ls = ATT;
            n_env = 0;
            n_sus = -1;
            n_gr0 = 1.0;
            n_gr1 = gnew;
          }
        } else if (ls == ATT) {
          int k = min(kAttack - env, nb - smp);
          if (found) k = min(k, np_smp - smp);
          k = max(k, 0);
          lin_start = smp;
          lin_len = k;
          const int smp1 = smp + k, env1 = env + k;
          const double env1f = static_cast<double>(env1);
          const_start = smp1;
          const_len = found ? np_smp - smp1 : 0;
          const int smp2 = found ? np_smp : smp1;
          const bool lower = found && gnew < gr1;
          const double current =
              sub(gr0, mul(mul(env1f, inv_attack), sub(gr0, gr1)));
          const double old_slope = -sub(gr0, gr1);
          const double new_slope = -sub(current, gnew);
          const bool steeper = new_slope <= old_slope;
          const double safe = old_slope != 0.0 ? old_slope : 1.0;
          double new_end = quot(sub(gnew, gr0), safe);
          if (!isnan(new_end)) new_end = fmax(new_end, 1.0);
          const double new_start = sub(new_end, 1.0);
          const double sh_gr0 = add(gr0, mul(new_start, old_slope));
          const double cur_pos = clamp(quot(sub(current, sh_gr0), safe),
                                       0.0, 1.0);
          const int sh_env = static_cast<int>(mul(kAttack - 1.0, cur_pos));
          if (lower) {
            n_gr0 = steeper ? current : sh_gr0;
            n_gr1 = gnew;
            n_env = steeper ? 0 : sh_env;
            n_sus = steeper ? -1 : sh_env;
            n_ls = ATT;
          } else {
            n_env = env1;
            if (found && env1 < kAttack) n_sus = env1;
            if (env1 == kAttack && smp2 < nb) n_ls = SUS;
          }
          n_smp = smp2;
        } else if (ls == SUS) {
          const int sc = found ? np_smp - smp : sus;
          const bool have = found || sus >= 0;
          const int s = max(min(sc, nb - smp), 0);
          const_start = smp;
          const_len = have ? s : 0;
          n_smp = have ? smp + s : smp;
          const bool s_lower = found && gnew < gr1;
          n_gr0 = s_lower ? gr1 : (have ? gr0 : gr1);
          n_gr1 = s_lower ? gnew : (have ? gr1 : 1.0);
          const int sus_dec = sus - s;
          n_sus = have ? (found ? (s_lower ? -1 : kLookahead)
                                : (sus_dec == 0 ? -1 : sus_dec))
                       : sus;
          n_env = (s_lower || !have) ? 0 : env;
          n_ls = s_lower ? ATT : (have ? ls : REL);
        } else {  // REL
          const double r_current =
              sub(gr0, mul(mul(envf, inv_release), sub(gr1, gr0)));
          const bool r_lower = found && gnew < r_current;
          const_start = smp;
          const_len = r_lower ? max(np_smp - smp, 0) : 0;
          const int rk = max(min(kRelease - env, nb - smp), 0);
          lin_start = smp;
          lin_len = found ? 0 : rk;
          lin_denom = kRelease - 1.0;
          lin_diff = sub(gr1, gr0);
          n_smp = r_lower ? np_smp : (found ? smp : smp + rk);
          n_env = r_lower ? 0 : (found ? env : env + rk);
          n_gr0 = r_lower ? r_current : gr0;
          n_gr1 = r_lower ? gnew : (found ? r_current : gr1);
          n_ls = r_lower ? ATT : (found ? SUS : (smp + rk < nb ? OUT : ls));
          n_sus = r_lower ? -1 : sus;
        }
        // the iteration's ranges, clipped to the frame; a linear range
        // keeps the iteration's gr0, a constant one its gr1
        const int l0 = max(lin_start, 0), l1 = min(lin_start + lin_len, kFrame);
        if (l1 > l0) {
          if (lane == 0)
            sh.seg[n] = Seg{l0, l1, lin_start, 1, envf, lin_denom, lin_diff,
                            gr0};
          ++n;
        }
        const int c0 = max(const_start, 0);
        const int c1 = min(const_start + const_len, kFrame);
        if (c1 > c0) {
          if (lane == 0) sh.seg[n] = Seg{c0, c1, c0, 0, 0.0, 1.0, 0.0, gr1};
          ++n;
        }
        gr0 = n_gr0;
        gr1 = n_gr1;
        ls = n_ls;
        env = n_env;
        sus = n_sus;
        smp = n_smp;
        ++iters;
      }
      if (lane == 0) {
        sh.nseg = n;
        sh.done = !(smp < nb && iters < cap && ls >= OUT && ls <= REL);
      }
    }
    __syncthreads();
    const int nseg = sh.nseg;
    const bool done = sh.done;
    for (int s = 0; s < nseg; ++s) {
      const Seg g = sh.seg[s];
      for (int i = g.start + tid; i < g.end; i += kT) {
        double v = g.base;
        if (g.linear) {
          const double t =
              quot(add(g.t0, static_cast<double>(i - g.ref)), g.denom);
          v = sub(g.base, mul(t, g.diff));
        }
        sh.G[i] = v;
      }
    }
    __syncthreads();
    if (done) break;
  }
  if (tid == 0) {
    gr0_out[b] = gr0;
    gr1_out[b] = gr1;
    ls_out[b] = ls;
    env_out[b] = env;
    sus_out[b] = sus;
    iters_out[b] = iters;
  }

  // 3. the new window (head, then the tail) and the clipped head
  double* y = lim_out + b * static_cast<long long>(kLim) * C;
  double* o = out + b * static_cast<long long>(kFrame) * C;
  const int head = kFrame * C, all = kLim * C;
#pragma unroll 4
  for (int i = tid; i < head; i += kT) {
    const double h = mul(__ldg(x + i), sh.G[i / C]);
    y[i] = h;
    o[i] = clamp(h, -tp, tp);
  }
#pragma unroll 4
  for (int i = head + tid; i < all; i += kT) y[i] = __ldg(x + i);
}

}  // namespace

// lim: `lanes` rows of the limiter window, (2 FRAME + LOOKAHEAD) * C
// interleaved f64 samples, lane b at lim + b * row_stride; gr0, gr1
// (f64), lstate, env_cnt, sus (int32): (lanes,) states; 0 <= nb <=
// FRAME, C <= 64; tp the ceiling, inv_attack and inv_release 1 / (ATTACK - 1)
// and 1 / (RELEASE - 1). Writes lim_out (lanes, LIM * C) and out (lanes,
// FRAME * C), both contiguous, the states after the frame and each
// lane's iterations. Returns the launch's cudaError_t.
extern "C" int limiter_frame(const double* lim, long long row_stride,
                             int lanes, int C, int nb, double tp,
                             double inv_attack, double inv_release,
                             const double* gr0, const double* gr1,
                             const int* lstate, const int* env_cnt,
                             const int* sus, double* lim_out, double* out,
                             double* gr0_out, double* gr1_out, int* ls_out,
                             int* env_out, int* sus_out, int* iters,
                             void* stream) {
  if (lanes < 0 || C <= 0 || C > 64 || nb < 0 || nb > kFrame)
    return cudaErrorInvalidValue;
  if (lanes == 0) return cudaSuccess;
  const int bytes = static_cast<int>(sizeof(Shared));
  cudaError_t err = cudaFuncSetAttribute(
      limiter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  limiter_kernel<<<lanes, kT, bytes, static_cast<cudaStream_t>(stream)>>>(
      lim, row_stride, C, nb, tp, inv_attack, inv_release, gr0, gr1, lstate,
      env_cnt, sus, lim_out, out, gr0_out, gr1_out, ls_out, env_out, sus_out,
      iters);
  return cudaGetLastError();
}
