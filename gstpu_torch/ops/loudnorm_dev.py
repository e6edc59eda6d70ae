"""Device-resident audioloudnorm on tensors: the EBU R 128 streaming
normalizer (reference audio/audiofx/src/audioloudnorm/imp.rs) batched
over (B, frame, channels) blocks.

The port of gstpu/ops/loudnorm_dev.py, with the same names, state keys
and control flow: the gain state machine is carried state, the
true-peak limiter a batched segment machine, the K-weighting the exact
block state-space biquads of gstpu_torch.ops.biquad.

What differs from the JAX module, and why:
* the limiter's `lax.while_loop` (`_limiter_frame`) is, on the CPU,
  a Python loop that asks once per iteration whether any stream is
  still short of the frame's end (`_limiter_frame_plain`; the host
  waits for that answer in a span `limiter.wait`), and on the card one
  launch of the hand-written kernel kernels/limiter.cu, which runs the
  segment machine there and returns the plain form's bits without a
  host wait (the counters `limiter.iterations` and
  `limiter.kernel_frames`, gstpu_torch.utils.tracing). The fixed-trip
  scans are Python loops;
* `nsub_in`, `nsub_out` and `gidx` are the same for every stream; JAX
  holds them as device scalars, the port as host ints, so the
  `lax.cond`s on them (`nsub >= 4`, the final step's `k < 29`) cost no
  device round trip. `state_from_numpy` / `state_to_numpy` convert a
  JAX state and back;
* every multiply and add rounds on its own (XLA contracts to FMA), so
  samples agree with gstpu to an ulp, not bitwise. No sum has a
  batch-dependent order (fixed-order loops and `_tree_sum_last`), so
  batch lanes are bitwise independent;
* the measurement's K-weighting (`kweight`) takes the plain form on the
  CPU, make_block_biquad's shifted-add FIR with the squares and
  `_tree_sum_last`, and the hand-written kernel kernels/kweight.cu on
  the card, which returns the same bits in one launch.

prev_smp note: the reference tracks prev_smp across detect_peak
calls, but its only read feeds the candidate at scan position 0,
which is unconditionally discarded (`n > 0` requirement,
imp.rs:1441-1470); it is dead for detection and not carried here.
"""

from __future__ import annotations

import ctypes
import math
import threading
from collections import deque
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from gstpu_torch.kernels import CudaKernel, stream_handle
from gstpu_torch.ops.biquad import (_tree_sum_last, biquad_coeffs_highpass,
                                    biquad_coeffs_shelving,
                                    block_biquad_tables, make_block_biquad)
from gstpu_torch.utils.tracing import count, recording, span

F64 = torch.float64
I32 = torch.int32

# reference imp.rs:207-214 (192 kHz)
RATE = 192_000
FRAME = 19_200                 # 100 ms
LOOKAHEAD = 1_920              # limiter lookahead, 10 ms
ATTACK = 1_920                 # limiter attack window
RELEASE = 19_200               # limiter release window
GAIN_LOOKAHEAD = 30 * FRAME    # 3 s
LIM = 2 * FRAME + LOOKAHEAD    # limiter window samples
ABSW = FRAME + LOOKAHEAD + 12  # |.| window needed per limiter frame
NPEAK = FRAME + LOOKAHEAD + 1  # candidate positions [0, NPEAK)

OUT, ATT, SUS, REL = 0, 1, 2, 3

# 10^((-70 + 0.691) / 10): absolute gate block energy (BS.1770)
ABS_THRESHOLD_ENERGY = 10.0 ** ((-70.0 + 0.691) / 10.0)
REL_GATE_FACTOR = 10.0 ** (-10.0 / 10.0)

# the state entries that are host ints in the port (device scalars in
# gstpu): the same for every stream
HOST_INTS = ("nsub_in", "nsub_out", "gidx")

# inner_step's stages, in order: each runs in a span `chain.<stage>`
STEP_STAGES = ("meas_in", "fill", "limiter", "meas_out", "gain")


def _gaussian_weights() -> np.ndarray:
    """21-tap gaussian, sigma 3.5, normalized (imp.rs:1893-1914)."""
    sigma = 3.5
    x = np.arange(21, dtype=np.float64) - 10.0
    w = (1.0 / (sigma * np.sqrt(2.0 * np.pi))) * np.exp(
        -(x ** 2) / (2 * sigma ** 2))
    return w / w.sum()


def _channel_weights(channels: int) -> np.ndarray:
    w = np.ones(channels)
    if channels > 3:
        w[3] = 0.0
        for i in range(4, min(channels, 6)):
            w[i] = 1.41
    return w


@dataclass(frozen=True)
class LoudnormParams:
    channels: int = 2
    loudness_target: float = -24.0
    loudness_range_target: float = 7.0
    max_true_peak: float = -2.0
    max_blocks: int = 4096      # the gating history's first width
    # (409.6 s); it doubles before it could fill, so that no block is
    # dropped: the host element's history is unbounded too.

    @property
    def target_tp(self) -> float:
        return 10.0 ** (self.max_true_peak / 20.0)


def init_state(params: LoudnormParams, batch: int, offset_db: float = 0.0,
               device="cuda") -> dict:
    """Fresh state for `batch` streams on `device`. offset_db is a
    runtime value (state["offset"])."""
    C = params.channels
    f64 = dict(dtype=F64, device=device)
    i32 = dict(dtype=I32, device=device)

    def z(*s):
        return torch.zeros(s, **f64)

    return dict(
        # input measurement (two cascaded K-weighting biquads)
        z_in1=z(batch * C, 2), z_in2=z(batch * C, 2),
        ring_in=z(batch, 30, C), nsub_in=0,
        blocks=z(batch, params.max_blocks),
        bcount=torch.zeros(batch, **i32),
        speak=z(batch, C),
        # output measurement
        z_out1=z(batch * C, 2), z_out2=z(batch * C, 2),
        ring_out=z(batch, 30, C), nsub_out=0,
        # gain machine (imp.rs State)
        delta=z(batch, 30), gidx=1,
        prev_delta=z(batch),
        above=torch.zeros(batch, dtype=torch.bool, device=device),
        offset=torch.full((batch,), 10.0 ** (offset_db / 20.0), **f64),
        # limiter
        lim=z(batch, LIM * C),
        gr0=z(batch), gr1=z(batch),
        lstate=torch.full((batch,), OUT, **i32),
        env_cnt=torch.zeros(batch, **i32),
        sus=torch.full((batch,), -1, **i32),
        # 3 s gain-lookahead delay line (linear, newest at the end)
        dbuf=z(batch, GAIN_LOOKAHEAD * C),
    )


def state_from_numpy(d: dict, device="cuda") -> dict:
    """A state from numpy leaves (gstpu's state with each leaf taken
    through np.asarray, or `state_to_numpy`'s result), key by key, on
    `device`."""
    st = {}
    for k, v in d.items():
        if k in HOST_INTS:
            st[k] = int(np.asarray(v))
        else:
            st[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return st


def state_to_numpy(st: dict) -> dict:
    """The state as numpy leaves, with gstpu's dtypes: each host int as
    a 0-d int32 array, each tensor copied to the host."""
    return {k: (np.asarray(v, np.int32) if k in HOST_INTS
                else v.cpu().numpy())
            for k, v in st.items()}


# ---------------------------------------------------------------------------
# measurement core
# ---------------------------------------------------------------------------

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KWEIGHT_KERNEL = CudaKernel("kweight_energies", "kweight.cu", {
    "kweight_energies": [_P, _LL, _I, _I, _LL, _P, _P, _P, _P, _P, _P,
                         _P]})
KWEIGHT_L = 64                 # the block biquads' block length
KWEIGHT_LEVELS = 32            # scan node levels in the kernel's table


@lru_cache(maxsize=None)
def _kweight_biquads() -> tuple:
    return tuple(make_block_biquad(*coeffs(RATE), L=KWEIGHT_L)
                 for coeffs in (biquad_coeffs_shelving,
                                biquad_coeffs_highpass))


def _scan_node_matrices(M: np.ndarray) -> list:
    """The matrix of a node of each level of associative_scan's odd/even
    recursion over maps that all carry M: level 0 is M, level j the
    composition of two level j-1 nodes, rounded as _affine_combine
    rounds it."""
    out = [tuple(float(v) for v in M.reshape(4))]
    for _ in range(1, KWEIGHT_LEVELS):
        m00, m01, m10, m11 = out[-1]
        out.append((m00 * m00 + m01 * m10, m00 * m01 + m01 * m11,
                    m10 * m00 + m11 * m10, m10 * m01 + m11 * m11))
    return out


@lru_cache(maxsize=None)
def _kweight_table(device: torch.device) -> torch.Tensor:
    """kweight.cu's coefficient table on `device`: per stage b0, h, O's
    columns, W's columns, M and the scan node matrices (452 f64)."""
    parts = []
    for coeffs in (biquad_coeffs_shelving, biquad_coeffs_highpass):
        b0, h, O, W, M = block_biquad_tables(*coeffs(RATE), KWEIGHT_L)
        parts += [[b0], h, O[:, 0], O[:, 1], W[:, 0], W[:, 1],
                  M.reshape(4), np.ravel(_scan_node_matrices(M))]
    return torch.as_tensor(np.concatenate(parts), dtype=F64, device=device)


def kweight_plain(z1, z2, x_flat, C: int):
    """The measurement's K-weighting as torch ops: both block biquads,
    the squares and a `_tree_sum_last` over each FRAME."""
    bq1, bq2 = _kweight_biquads()
    B = x_flat.shape[0]
    n = x_flat.shape[1] // C
    xc = x_flat.reshape(B, n, C)
    xt = xc.permute(0, 2, 1).reshape(B * C, n)
    y, z1 = bq1(xt, z1)
    y, z2 = bq2(y, z2)
    sq = (y * y).reshape(B, C, n // FRAME, FRAME)
    e = _tree_sum_last(sq)                          # (B, C, nsub)
    return z1, z2, e.permute(0, 2, 1)               # (B, nsub, C)


def kweight_kernel(z1, z2, x_flat, C: int):
    """kweight_plain's result from one launch of kernels/kweight.cu, on
    CUDA tensors that `kweight` has checked."""
    B, N = x_flat.shape
    nsub = N // (FRAME * C)
    dev = x_flat.device
    z1o, z2o = torch.empty_like(z1), torch.empty_like(z2)
    e = torch.empty((B, nsub, C), dtype=F64, device=dev)
    # the limiter's library builds beside this one: the first frame
    # (the prime's) runs the measurement first
    LIMITER_KERNEL.start_build()
    KWEIGHT_KERNEL.launch(
        "kweight_energies", x_flat.data_ptr(), x_flat.stride(0), B, C,
        nsub, z1.data_ptr(), z2.data_ptr(), _kweight_table(dev).data_ptr(),
        z1o.data_ptr(), z2o.data_ptr(), e.data_ptr(), stream_handle(dev))
    return z1o, z2o, e


def kweight(z1, z2, x_flat, C: int):
    """The K-weighted energy of every FRAME of every channel.

    x_flat: (B, n*C) interleaved f64, n a multiple of FRAME, each row's
    samples contiguous (rows may be strided); z1, z2: (B*C, 2)
    contiguous f64 DF2T states of the shelving and the high-pass stage.
    -> (z1, z2, energies (B, n//FRAME, C)). The plain form for a CPU
    tensor, the kernel for a CUDA one: the same bits."""
    dev = x_flat.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"kweight: no route for {dev}")
    if x_flat.dtype != F64 or x_flat.dim() != 2 \
            or x_flat.stride(-1) != 1:
        raise ValueError("kweight: x must be (B, n*C) f64 with each row's "
                         f"samples contiguous, got {x_flat.dtype} "
                         f"{tuple(x_flat.shape)} strides {x_flat.stride()}")
    B, N = x_flat.shape
    if B < 1 or N < 1 or N % (FRAME * C):
        raise ValueError(f"kweight: {N} samples a row is not a whole "
                         f"number of {C}-channel frames of {FRAME}")
    for name, z in (("z1", z1), ("z2", z2)):
        if z.dtype != F64 or z.shape != (B * C, 2) \
                or not z.is_contiguous() or z.device != dev:
            raise ValueError(f"kweight: {name} must be a contiguous "
                             f"({B * C}, 2) f64 tensor on {dev}, got "
                             f"{z.dtype} {tuple(z.shape)} on {z.device}")
    if dev.type == "cpu":
        return kweight_plain(z1, z2, x_flat, C)
    return kweight_kernel(z1, z2, x_flat, C)


def _make_measure(params: LoudnormParams):
    C = params.channels
    wts = [float(w) for w in _channel_weights(C)]

    def measure(z1, z2, x_flat):
        """x_flat: (B, n*C) interleaved f64, n a multiple of FRAME.
        -> (z1, z2, subblock energies (B, n//FRAME, C))."""
        return kweight(z1, z2, x_flat, C)

    def window_energy(ring, n_sub: int):
        """Last n_sub subblocks of the 30-ring (oldest-first), per
        reference _window_energy: zero slots pad short histories."""
        w = ring[:, 30 - n_sub:, :]
        per_channel = torch.zeros_like(w[:, 0, :])
        for i in range(n_sub):                      # defined order
            per_channel = per_channel + w[:, i, :]
        per_channel = per_channel / (n_sub * FRAME)
        e = torch.zeros_like(per_channel[:, 0])
        for c in range(C):                          # defined order
            e = e + wts[c] * per_channel[:, c]
        return e

    return measure, window_energy


def _loudness(e):
    """-0.691 + 10 log10(e), -inf for e <= 0."""
    safe = torch.where(e > 0.0, e, 1.0)
    return torch.where(e > 0.0, -0.691 + 10.0 * torch.log10(safe),
                       -math.inf)


def _gating_append(blocks, bcount, e, held: int):
    """Append 400 ms block energy e (B,) where above the absolute
    gate (imp.rs via ebur128 I-mode). `held` is the most blocks a
    stream can hold after this append (one a measured frame from the
    fourth on): the history doubles in width before it could fill. The
    new columns are zeros past every stream's blocks, which the tree
    sums of `_global_and_threshold` add as exactly as their own zero
    padding, so the gating reads as if the history had been that wide
    from the start. (gstpu's core drops blocks past max_blocks.)"""
    while blocks.shape[1] < held:
        blocks = torch.cat([blocks, torch.zeros_like(blocks)], dim=1)
    maxb = blocks.shape[1]
    ok = (e > ABS_THRESHOLD_ENERGY) & (bcount < maxb)
    pos = bcount.clamp(0, maxb - 1)
    slots = torch.arange(maxb, device=blocks.device)
    onehot = (slots[None, :] == pos[:, None]) & ok[:, None]
    blocks = torch.where(onehot, e[:, None], blocks)
    return blocks, bcount + ok.to(I32)


def _global_and_threshold(blocks, bcount):
    """(gated 'integrated' loudness, relative threshold)."""
    cnt = bcount.to(F64)
    total = _tree_sum_last(blocks)
    mean1 = torch.where(bcount > 0,
                        total / torch.where(cnt > 0, cnt, 1.0), 0.0)
    rel_th = torch.where(bcount > 0, _loudness(mean1) - 10.0, -70.0)
    gate = mean1 * REL_GATE_FACTOR
    sel = blocks > gate[:, None]
    gcnt = _tree_sum_last(sel.to(F64))
    gsum = _tree_sum_last(torch.where(sel, blocks, 0.0))
    gmean = torch.where(gcnt > 0,
                        gsum / torch.where(gcnt > 0, gcnt, 1.0), 0.0)
    global_ = torch.where((bcount > 0) & (gcnt > 0), _loudness(gmean),
                          -math.inf)
    return global_, rel_th


# ---------------------------------------------------------------------------
# gain machine
# ---------------------------------------------------------------------------

_GW = [float(w) for w in _gaussian_weights()]


def _gaussian_filter(delta, gidx: int):
    """imp.rs:1893-1914 / element gaussian_filter(index)."""
    idx = gidx - 10 if gidx > 10 else gidx + 20
    doubled = torch.cat([delta, delta], dim=1)
    d = doubled[:, idx:idx + 21]
    acc = _GW[0] * d[:, 0]
    for i in range(1, 21):                          # defined order
        acc = acc + _GW[i] * d[:, i]
    return acc


def _update_gain(params: LoudnormParams, st, window_energy, st_out):
    """process_update_gain_inner_frame (imp.rs:532-610).  st_out is
    the output-chain short-term loudness (only read while a stream is
    below threshold)."""
    shortterm = _loudness(window_energy(st["ring_in"], 30))
    global_, rel_th = _global_and_threshold(st["blocks"], st["bcount"])

    above = st["above"]
    grow = (~above) & (shortterm > -70.0)
    prev_delta = torch.where(grow, st["prev_delta"] * 1.0058,
                             st["prev_delta"])
    above = above | ((~above) & (st_out >= params.loudness_target))

    use_prev = ((shortterm < rel_th) | (shortterm <= -70.0) | (~above))
    diff = shortterm - global_
    half_lra = params.loudness_range_target / 2.0
    one = torch.ones_like(diff)
    env_global = torch.where(
        diff.abs() < half_lra, diff,
        torch.where(half_lra * diff < 0.0, -one, one))
    env_short = params.loudness_target - shortterm
    dv = torch.pow(10.0, (env_global + env_short) / 20.0)
    new_entry = torch.where(use_prev, prev_delta, dv)

    gidx = st["gidx"]
    delta = st["delta"].clone()
    delta[:, gidx] = new_entry
    return dict(st, delta=delta, prev_delta=new_entry, above=above,
                gidx=(gidx + 1) % 30)


# ---------------------------------------------------------------------------
# limiter (imp.rs:845-1437) — batched segment state machine
# ---------------------------------------------------------------------------

def _limiter_frame_plain(params: LoudnormParams, lim, gr0, gr1, lstate,
                         env_cnt, sus, nb: int):
    """Run the true-peak limiter over the next nb samples of the
    linear limiter window `lim` ((B, LIM*C), newest at the end), as
    torch ops: the segment loop steps every lane until the slowest is
    done, the host waiting for the card's answer before each iteration.
    Returns (lim with envelopes applied, clipped out (B, FRAME*C),
    gr0, gr1, lstate, env_cnt, sus)."""
    C = params.channels
    tp = params.target_tp
    B = lim.shape[0]
    dev = lim.device

    a = lim[:, :ABSW * C].abs().reshape(B, ABSW, C)
    V = a.amax(dim=2)                                # (B, ABSW)
    # candidate peaks at positions p in [1, NPEAK) (detect_peak):
    # prev <= this >= next, this > tp, and the 10 samples at p+2..p+11
    # must not exceed this (per channel; row hits if any channel)
    this = a[:, 1:NPEAK, :]
    prev = a[:, 0:NPEAK - 1, :]
    nxt = a[:, 2:NPEAK + 1, :]
    fut = this
    for i in range(2, 12):
        fut = torch.maximum(fut, a[:, 1 + i:NPEAK + i, :])
    okc = (prev <= this) & (this >= nxt) & (this > tp) & (fut <= this)
    hit = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                     okc.any(dim=2)], dim=1)

    iota = torch.arange(NPEAK, dtype=I32, device=dev)
    if64 = torch.arange(FRAME, dtype=F64, device=dev)
    ii32 = torch.arange(FRAME, dtype=I32, device=dev)

    def detect(smp):
        """First peak in the window scanned from smp: positions
        q in (smp + LOOKAHEAD, nb + LOOKAHEAD)."""
        m = hit & (iota[None, :] > (smp + LOOKAHEAD)[:, None]) \
            & (iota[None, :] < (nb + LOOKAHEAD))
        found = m.any(dim=1)
        # first maximal index of the mask, as jnp.argmax gives it
        q = m.to(torch.uint8).argmax(dim=1)
        pv = V.gather(1, q[:, None])[:, 0]
        np_smp = q.to(I32) - LOOKAHEAD               # peak pos - 10ms
        return found, np_smp, pv

    def body(G, gr0, gr1, ls, env, sus, smp):
        active = smp < nb
        found, np_smp, pv = detect(smp)
        found = found & active
        gnew = tp / torch.where(found, pv, 1.0)
        envf = env.to(F64)
        is_out = active & (ls == OUT)
        is_att = active & (ls == ATT)
        is_sus = active & (ls == SUS)
        is_rel = active & (ls == REL)
        zero = torch.zeros_like(smp)
        minus1 = torch.full_like(smp, -1)

        # ---- OUT (imp.rs:1338 _limiter_out) --------------------------
        o_smp = torch.where(found, smp + LOOKAHEAD + np_smp - smp
                            - ATTACK, nb)
        o_ls = torch.where(found, ATT, ls)
        o_env = torch.where(found, 0, env)
        o_sus = torch.where(found, -1, sus)
        o_gr0 = torch.where(found, 1.0, gr0)
        o_gr1 = torch.where(found, gnew, gr1)

        # ---- ATTACK ---------------------------------------------------
        k = torch.minimum(ATTACK - env, nb - smp)
        k = torch.where(found, torch.minimum(k, np_smp - smp), k)
        k = k.clamp(min=0)
        a_lin_len = k
        a_lin_t0 = envf
        a_lin_diff = gr0 - gr1
        smp1 = smp + k
        env1 = env + k
        env1f = env1.to(F64)
        # found: sustain-fill to the attack start point, then peak calc
        a_const_start = smp1
        a_const_len = torch.where(found, np_smp - smp1, 0)
        smp2 = torch.where(found, np_smp, smp1)
        lower = found & (gnew < gr1)
        current = gr0 - (env1f / (ATTACK - 1.0)) * (gr0 - gr1)
        old_slope = -(gr0 - gr1)
        new_slope = -(current - gnew)
        steeper = new_slope <= old_slope
        # steeper: restart attack from current; shallower: re-anchor
        safe_slope = torch.where(old_slope != 0.0, old_slope, 1.0)
        new_end = ((gnew - gr0) / safe_slope).clamp(min=1.0)
        new_start = new_end - 1.0
        sh_gr0 = gr0 + new_start * old_slope
        cur_pos = ((current - sh_gr0) / safe_slope).clamp(0.0, 1.0)
        sh_env = ((ATTACK - 1.0) * cur_pos).to(I32)
        a_gr0 = torch.where(lower, torch.where(steeper, current, sh_gr0),
                            gr0)
        a_gr1 = torch.where(lower, gnew, gr1)
        a_env = torch.where(lower, torch.where(steeper, 0, sh_env), env1)
        a_sus = torch.where(
            lower, torch.where(steeper, -1, sh_env),
            torch.where(found & (env1 < ATTACK), env1, sus))
        # non-early-exit tail: attack window complete -> sustain
        tail = ~lower & (env1 == ATTACK) & (smp2 < nb)
        a_ls = torch.where(lower, ATT, torch.where(tail, SUS, ls))

        # ---- SUSTAIN --------------------------------------------------
        sc = torch.where(found, np_smp - smp, sus)
        have = found | (sus >= 0)
        s = torch.minimum(sc, nb - smp).clamp(min=0)
        s_const_len = torch.where(have, s, 0)
        s_smp = torch.where(have, smp + s, smp)
        s_lower = found & (gnew < gr1)
        s_gr0 = torch.where(s_lower, gr1, torch.where(have, gr0, gr1))
        s_gr1 = torch.where(s_lower, gnew, torch.where(have, gr1, 1.0))
        sus_dec = sus - s
        s_sus = torch.where(
            have,
            torch.where(found,
                        torch.where(s_lower, minus1, LOOKAHEAD),
                        torch.where(sus_dec == 0, -1, sus_dec)),
            sus)
        s_env = torch.where(s_lower | ~have, 0, env)
        s_ls = torch.where(s_lower, ATT, torch.where(have, ls, REL))

        # ---- RELEASE --------------------------------------------------
        r_current = gr0 - (envf / (RELEASE - 1.0)) * (gr1 - gr0)
        r_lower = found & (gnew < r_current)
        pd = np_smp - smp
        r_const_len = torch.where(r_lower, pd.clamp(min=0), 0)
        rk = torch.minimum(RELEASE - env, nb - smp).clamp(min=0)
        r_lin_len = torch.where(found, 0, rk)
        r_smp = torch.where(r_lower, np_smp,
                            torch.where(found, smp, smp + rk))
        r_env = torch.where(r_lower, 0, torch.where(found, env, env + rk))
        r_gr0 = torch.where(r_lower, r_current, gr0)
        r_gr1 = torch.where(r_lower, gnew,
                            torch.where(found, r_current, gr1))
        r_ls = torch.where(
            r_lower, ATT,
            torch.where(found, SUS,
                        torch.where(smp + rk < nb, OUT, ls)))
        r_sus = torch.where(r_lower, -1, sus)

        # ---- select by state -----------------------------------------
        def sel(o, at, su, re, base):
            x = torch.where(is_out, o, base)
            x = torch.where(is_att, at, x)
            x = torch.where(is_sus, su, x)
            return torch.where(is_rel, re, x)

        lin_start = sel(zero, smp, zero, smp, zero)
        lin_len = sel(zero, torch.where(is_att, a_lin_len, 0), zero,
                      r_lin_len, zero)
        lin_t0 = sel(envf, a_lin_t0, envf, envf, envf)
        lin_denom = torch.where(is_rel, torch.full_like(envf, RELEASE - 1.0),
                                ATTACK - 1.0)
        lin_diff = torch.where(is_rel, gr1 - gr0, a_lin_diff)
        const_start = sel(zero, a_const_start, smp, smp, zero)
        const_len = sel(zero, a_const_len, s_const_len, r_const_len,
                        zero)

        n_gr0 = sel(o_gr0, a_gr0, s_gr0, r_gr0, gr0)
        n_gr1 = sel(o_gr1, a_gr1, s_gr1, r_gr1, gr1)
        n_ls = sel(o_ls, a_ls, s_ls, r_ls, ls)
        n_env = sel(o_env, a_env, s_env, r_env, env)
        n_sus = sel(o_sus, a_sus, s_sus, r_sus, sus)
        n_smp = sel(o_smp, smp2, s_smp, r_smp, smp)

        # ---- envelope writes into G (disjoint ranges; assignment) ----
        ls_f = lin_start.to(F64)
        t = (lin_t0[:, None] + (if64[None, :] - ls_f[:, None])) \
            / lin_denom[:, None]
        lin_vals = gr0[:, None] - t * lin_diff[:, None]
        lmask = (ii32[None, :] >= lin_start[:, None]) \
            & (ii32[None, :] < (lin_start + lin_len)[:, None])
        G = torch.where(lmask, lin_vals, G)
        cmask = (ii32[None, :] >= const_start[:, None]) \
            & (ii32[None, :] < (const_start + const_len)[:, None])
        G = torch.where(cmask, gr1[:, None], G)

        return G, n_gr0, n_gr1, n_ls, n_env, n_sus, n_smp

    def short(smp) -> bool:
        """Whether any stream is short of nb: the host waits for the
        card's answer."""
        with span("limiter.wait"):
            return bool((smp < nb).any())

    G = torch.ones((B, FRAME), dtype=F64, device=dev)
    smp = torch.zeros(B, dtype=I32, device=dev)
    # the loop steps every stream until the slowest one is done; a
    # stream that is done keeps its state (every select falls through)
    while short(smp):
        G, gr0, gr1, lstate, env_cnt, sus, smp = body(
            G, gr0, gr1, lstate, env_cnt, sus, smp)
        count("limiter.iterations")

    genv = G[:, :, None].expand(B, FRAME, C).reshape(B, FRAME * C)
    head = lim[:, :FRAME * C] * genv
    lim = torch.cat([head, lim[:, FRAME * C:]], dim=1)
    out = head.clamp(-tp, tp)
    return lim, out, gr0, gr1, lstate, env_cnt, sus


LIMITER_KERNEL = CudaKernel("limiter_frame", "limiter.cu", {
    "limiter_frame": [_P, _LL, _I, _I, _I, ctypes.c_double, ctypes.c_double,
                      ctypes.c_double, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _P]})
LIMITER_MAX_CHANNELS = 64
# the frames whose iteration counts are on their way to the host:
# (event, pinned (B,) int32), oldest first
_iterations_due: deque = deque()
_iterations_lock = threading.Lock()


def count_limiter_iterations(wait: bool = False) -> None:
    """Add to the counter `limiter.iterations` the slowest lane's
    iterations of each kernel frame whose counts have reached the host;
    with `wait`, wait for every frame's."""
    with _iterations_lock:
        while _iterations_due:
            ev, counts = _iterations_due[0]
            if not wait and not ev.query():
                return
            ev.synchronize()
            _iterations_due.popleft()
            count("limiter.iterations", int(counts.max()))


def _limiter_frame_kernel(params: LoudnormParams, lim, gr0, gr1, lstate,
                          env_cnt, sus, nb: int):
    """_limiter_frame_plain's result from one launch of
    kernels/limiter.cu, on CUDA tensors that `_limiter_frame` has
    checked. Counts `limiter.kernel_frames`; where a tracer records, the
    frame's iterations go to the host without blocking and reach
    `limiter.iterations` at a later frame's call (or
    `count_limiter_iterations`)."""
    B, C, dev = lim.shape[0], params.channels, lim.device
    f64, i32 = dict(dtype=F64, device=dev), dict(dtype=I32, device=dev)
    lim_out = torch.empty((B, LIM * C), **f64)
    out = torch.empty((B, FRAME * C), **f64)
    gr0o, gr1o = torch.empty(B, **f64), torch.empty(B, **f64)
    lso, envo, suso, iters = (torch.empty(B, **i32) for _ in range(4))
    LIMITER_KERNEL.launch(
        "limiter_frame", lim.data_ptr(), lim.stride(0), B, C, nb,
        params.target_tp, 1.0 / (ATTACK - 1.0), 1.0 / (RELEASE - 1.0),
        gr0.data_ptr(), gr1.data_ptr(), lstate.data_ptr(),
        env_cnt.data_ptr(), sus.data_ptr(), lim_out.data_ptr(),
        out.data_ptr(), gr0o.data_ptr(), gr1o.data_ptr(), lso.data_ptr(),
        envo.data_ptr(), suso.data_ptr(), iters.data_ptr(),
        stream_handle(dev))
    count("limiter.kernel_frames")
    if recording():
        host = torch.empty(B, dtype=I32, pin_memory=True)
        host.copy_(iters, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        with _iterations_lock:
            _iterations_due.append((ev, host))
    if _iterations_due:
        count_limiter_iterations()
    return lim_out, out, gr0o, gr1o, lso, envo, suso


def _limiter_frame(params: LoudnormParams, lim, gr0, gr1, lstate,
                   env_cnt, sus, nb: int):
    """The true-peak limiter over the next nb samples of the limiter
    window (imp.rs:845-1437). lim: (B, LIM*C) f64, each row's samples
    contiguous; gr0, gr1: (B,) f64; lstate, env_cnt, sus: (B,) int32;
    0 <= nb <= FRAME. Returns (lim with envelopes applied, clipped out
    (B, FRAME*C), gr0, gr1, lstate, env_cnt, sus); the inputs are not
    changed. The plain form for a CPU tensor, the kernel for a CUDA
    one: the same bits."""
    dev = lim.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"_limiter_frame: no route for {dev}")
    C = params.channels
    B = lim.shape[0]
    if lim.dtype != F64 or lim.shape != (B, LIM * C) \
            or lim.stride(-1) != 1 or not 1 <= C <= LIMITER_MAX_CHANNELS:
        raise ValueError(f"_limiter_frame: lim must be ({B}, {LIM * C}) "
                         f"f64 with each row's samples contiguous and at "
                         f"most {LIMITER_MAX_CHANNELS} channels, got "
                         f"{lim.dtype} {tuple(lim.shape)} strides "
                         f"{lim.stride()}")
    if not 0 <= nb <= FRAME:
        raise ValueError(f"_limiter_frame: nb {nb} outside [0, {FRAME}]")
    for name, v, dt in (("gr0", gr0, F64), ("gr1", gr1, F64),
                        ("lstate", lstate, I32), ("env_cnt", env_cnt, I32),
                        ("sus", sus, I32)):
        if v.dtype != dt or v.shape != (B,) or not v.is_contiguous() \
                or v.device != dev:
            raise ValueError(f"_limiter_frame: {name} must be a contiguous "
                             f"({B},) {dt} tensor on {dev}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if dev.type == "cpu":
        return _limiter_frame_plain(params, lim, gr0, gr1, lstate, env_cnt,
                                    sus, nb)
    return _limiter_frame_kernel(params, lim, gr0, gr1, lstate, env_cnt,
                                 sus, nb)


def _limiter_first_special(params: LoudnormParams, lim, gr1, lstate, sus):
    """true_peak_limiter_first_frame (imp.rs:845-880): signed max over
    the first LOOKAHEAD+1 samples; prime SUSTAIN if above target."""
    C = params.channels
    seg = lim[:, :(LOOKAHEAD + 1) * C]
    # reference quirk (imp.rs:845-880, mirrored by the numpy element):
    # `if abs(s) > max_ { max_ = s }` keeps the SIGNED value, so a
    # negative interim maximum is displaced by the very next sample.
    # Not expressible as argmax — fold in order, once per stream start.
    mx = torch.zeros(seg.shape[0], dtype=seg.dtype, device=seg.device)
    for j in range(seg.shape[1]):
        s = seg[:, j]
        mx = torch.where(s.abs() > mx, s, mx)
    over = mx > params.target_tp
    lstate = torch.where(over, SUS, lstate)
    sus = torch.where(over, LOOKAHEAD, sus)
    gr1 = torch.where(over,
                      params.target_tp / torch.where(over, mx, 1.0), gr1)
    return gr1, lstate, sus


# ---------------------------------------------------------------------------
# frame steps
# ---------------------------------------------------------------------------

def _fill(st, C: int, fs: int):
    """The limiter window's next FRAME samples: the 100 ms of the delay
    line due at the limiter, times the gain interpolated over
    arange(FRAME) / fs, zeroed past fs (process_fill_inner_frame,
    imp.rs:447-530, and fill_final). Returns the new `lim`."""
    dev = st["dbuf"].device
    gain = _gaussian_filter(st["delta"], (st["gidx"] + 10) % 30)
    gain_next = _gaussian_filter(st["delta"], (st["gidx"] + 11) % 30)
    frac = torch.arange(FRAME, dtype=F64, device=dev) / max(fs, 1)
    gains = (gain[:, None] + frac[None, :]
             * (gain_next - gain)[:, None]) * st["offset"][:, None]
    read = st["dbuf"][:, LIM * C:(LIM + FRAME) * C]
    B = read.shape[0]
    filled = read.reshape(B, FRAME, C) * gains[:, :, None]
    if fs < FRAME:
        valid = torch.arange(FRAME, device=dev) < fs
        filled = filled * valid[None, :, None]
    return torch.cat([st["lim"][:, FRAME * C:],
                      filled.reshape(B, FRAME * C)], dim=1)


def _shift_in(dbuf, new):
    """Drop new.shape[1] samples from the front of the delay line and
    append `new`."""
    return torch.cat([dbuf[:, new.shape[1]:], new], dim=1)


def _meas_out(measure, st, out):
    """The output chain's measurement of `out` into the 30-ring."""
    z1, z2, e = measure(st["z_out1"], st["z_out2"], out)
    ring = st["ring_out"]
    for k in range(e.shape[1]):
        ring = torch.cat([ring[:, 1:, :], e[:, k:k + 1, :]], dim=1)
    return dict(st, z_out1=z1, z_out2=z2, ring_out=ring,
                nsub_out=st["nsub_out"] + e.shape[1])


def _run_limiter(params: LoudnormParams, st, nb: int):
    lim, out, gr0, gr1, ls, env, sus = _limiter_frame(
        params, st["lim"], st["gr0"], st["gr1"], st["lstate"],
        st["env_cnt"], st["sus"], nb)
    return dict(st, lim=lim, gr0=gr0, gr1=gr1, lstate=ls, env_cnt=env,
                sus=sus), out


def _gain_update(params: LoudnormParams, window_energy, st):
    st_out = _loudness(window_energy(st["ring_out"], 30))
    return _update_gain(params, st, window_energy, st_out)


@lru_cache(maxsize=None)
def make_final_step(params: LoudnormParams):
    """EOS drain (process_final_frame, imp.rs:612-668 + the FINAL
    branch of the drain loop): consume the trailing partial frame and
    emit the whole 3 s gain-lookahead tail through the limiter with
    continuing gain updates.

    final(st, src (B, FRAME*C) zero-padded, n_valid int) ->
        (st, out (B, 30*FRAME*C) zero-padded, out_valid int)
    with out_valid = 29*FRAME + n_valid samples per channel.

    The incomplete input 100 ms block updates no input measurement
    state (ebur128's complete-block semantics): the input chain is
    never read again after FINAL.
    """
    C = params.channels
    measure, window_energy = _make_measure(params)

    def final(st, src, n_valid: int):
        n = int(n_valid)
        # fill_inner for the trailing n input samples plus fill_final(n,
        # FRAME) completing the first drain frame: both parts use
        # arange(FRAME)/FRAME with the same gain pair, so one fill
        # covers them
        st = dict(st, lim=_fill(st, C, FRAME),
                  dbuf=_shift_in(st["dbuf"], src))
        outs = []
        for k in range(30):
            st, dst = _run_limiter(params, st, n if k == 29 else FRAME)
            outs.append(dst)
            if k < 29:
                # between frames (not after the last): measure + gain
                # + the next fill, fill_final(0, fs)
                st = _meas_out(measure, st, dst)
                st = _gain_update(params, window_energy, st)
                fs = n if k == 28 else FRAME
                st = dict(st, lim=_fill(st, C, fs),
                          dbuf=_shift_in(st["dbuf"], torch.zeros_like(
                              st["dbuf"][:, :FRAME * C])))
        return st, torch.cat(outs, dim=1), 29 * FRAME + n

    return final


@lru_cache(maxsize=None)
def make_meter_step(params: LoudnormParams):
    """Standalone ebur128level stage (reference audio/audiofx/src/
    ebur128level/imp.rs metering modes M/S/I/sample-peak): a
    passthrough step returning (state, x, aux) with aux =
    dict(momentary, shortterm, global_, relative_threshold (B,) LUFS;
    speak (B, C) linear). x may be any multiple of FRAME*C."""
    C = params.channels
    measure, window_energy = _make_measure(params)

    def meter_step(st, x):
        z1, z2, e = measure(st["z_in1"], st["z_in2"], x)
        ring, nsub = st["ring_in"], st["nsub_in"]
        blocks, bcount = st["blocks"], st["bcount"]
        for k in range(e.shape[1]):
            ring = torch.cat([ring[:, 1:, :], e[:, k:k + 1, :]], dim=1)
            nsub = nsub + 1
            if nsub >= 4:
                blocks, bcount = _gating_append(blocks, bcount,
                                                window_energy(ring, 4),
                                                nsub - 3)
        speak = torch.maximum(
            st["speak"], x.reshape(x.shape[0], -1, C).abs().amax(dim=1))
        global_, rel_th = _global_and_threshold(blocks, bcount)
        aux = dict(
            momentary=_loudness(window_energy(ring, 4)),
            shortterm=_loudness(window_energy(ring, 30)),
            global_=global_, relative_threshold=rel_th, speak=speak)
        st = dict(st, z_in1=z1, z_in2=z2, ring_in=ring, nsub_in=nsub,
                  blocks=blocks, bcount=bcount, speak=speak)
        return st, x, aux

    return meter_step


def init_meter_state(params: LoudnormParams, batch: int,
                     device="cuda") -> dict:
    C = params.channels
    f64 = dict(dtype=F64, device=device)

    def z(*s):
        return torch.zeros(s, **f64)

    return dict(z_in1=z(batch * C, 2), z_in2=z(batch * C, 2),
                ring_in=z(batch, 30, C), nsub_in=0,
                blocks=z(batch, params.max_blocks),
                bcount=torch.zeros(batch, dtype=I32, device=device),
                speak=z(batch, C))


@lru_cache(maxsize=None)
def make_steps(params: LoudnormParams, with_meter: bool = False):
    """Returns (first_step, inner_step):

    first_step(state, src (B, GAIN_LOOKAHEAD*C)) -> (state, out
      (B, FRAME*C))  — the 3 s priming frame (process_first_frame).
    inner_step(state, src (B, FRAME*C)) -> (state, out (B, FRAME*C))
      — the steady-state 100 ms frame (process_inner_frame).

    src is interleaved f64; the steps run on its device. inner_step
    runs each of its stages (STEP_STAGES) in a device span
    `chain.<stage>` (gstpu_torch.utils.tracing).

    with_meter=True fuses a downstream `ebur128level` into the step:
    the output measurement runs unconditionally (it is the meter, one
    shared K-weighting pass) and both steps return (state, out,
    meters) with meters = dict(momentary, shortterm (B,) LUFS of the
    output).
    """
    C = params.channels
    measure, window_energy = _make_measure(params)

    def meas_in_frame(st, src):
        """One 100 ms frame into the input measurement state."""
        z1, z2, e = measure(st["z_in1"], st["z_in2"], src)
        ring = torch.cat([st["ring_in"][:, 1:, :], e[:, 0:1, :]], dim=1)
        nsub = st["nsub_in"] + 1
        blocks, bcount = st["blocks"], st["bcount"]
        if nsub >= 4:
            blocks, bcount = _gating_append(blocks, bcount,
                                            window_energy(ring, 4),
                                            nsub - 3)
        speak = torch.maximum(
            st["speak"],
            src.reshape(src.shape[0], -1, C).abs().amax(dim=1))
        return dict(st, z_in1=z1, z_in2=z2, ring_in=ring, nsub_in=nsub,
                    blocks=blocks, bcount=bcount, speak=speak)

    def _out_meters(st):
        return dict(
            momentary=_loudness(window_energy(st["ring_out"], 4)),
            shortterm=_loudness(window_energy(st["ring_out"], 30)))

    def first_step(st, src):
        """process_first_frame (imp.rs:368-442)."""
        B = src.shape[0]
        # 3 s of input as 30 100 ms frames (bounds the biquad working
        # set to one frame)
        for k in range(30):
            st = meas_in_frame(st, src[:, k * FRAME * C:(k + 1) * FRAME * C])
        shortterm = _loudness(window_energy(st["ring_in"], 30))
        above = shortterm >= -70.0
        env_short = torch.where(above, params.loudness_target - shortterm,
                                0.0)
        d0 = torch.pow(10.0, env_short / 20.0)
        delta = d0[:, None].repeat(1, 30)
        prev_delta = delta[:, 1].clone()         # delta[index], index=1
        # delay line primed with the whole 3 s (a copy: the caller keeps
        # its tensor); limiter window gets the first LIM samples scaled
        # by prev_delta * offset
        dbuf = src.clone()
        lim = dbuf[:, :LIM * C] * (prev_delta * st["offset"])[:, None]
        st = dict(st, above=above, delta=delta, prev_delta=prev_delta,
                  dbuf=dbuf, lim=lim)
        gr1, lstate, sus = _limiter_first_special(
            params, st["lim"], st["gr1"], st["lstate"], st["sus"])
        st = dict(st, gr1=gr1, lstate=lstate, sus=sus)
        st, out = _run_limiter(params, st, FRAME)
        st = _meas_out(measure, st, out)
        # dbuf stays the full 3 s: the linear-model invariant is
        # "read at offset LIM, shift by FRAME per inner fill", which
        # reproduces numpy's buf_index = LIM*C ring pointer exactly.
        if with_meter:
            # fused ebur128level must meter the priming frame too
            return st, out, _out_meters(st)
        return st, out

    def inner_step(st, src):
        """process_inner_frame (imp.rs:447-530 + 532-610)."""
        with span("chain.meas_in", device=True):
            st = meas_in_frame(st, src)
        with span("chain.fill", device=True):
            st = dict(st, lim=_fill(st, C, FRAME),
                      dbuf=_shift_in(st["dbuf"], src))
        with span("chain.limiter", device=True):
            st, out = _run_limiter(params, st, FRAME)
        with span("chain.meas_out", device=True):
            if with_meter:
                # fused ebur128level: the output chain is the meter
                st2 = _meas_out(measure, st, out)
                meters = _out_meters(st2)
            elif bool((~st["above"]).any()):
                st2 = _meas_out(measure, st, out)
            else:
                st2 = st
        with span("chain.gain", device=True):
            st2 = _gain_update(params, window_energy, st2)
        if with_meter:
            return st2, out, meters
        return st2, out

    return first_step, inner_step
