"""Fused device pipelines: whole element chains as one step function.

The port of gstpu/parallel/chains.py. The hand-fused flagship chain
(`make_audiofx_exact_chain`): rsaudioecho -> audioloudnorm ->
ebur128level at 192 kHz F64, batched over streams on one device, the
state a dict carried across blocks. The loudnorm stage is
gstpu_torch.ops.loudnorm_dev, the meter fused into its output
measurement (one shared K-weighting pass); echo is the exact f64
segment kernel of gstpu_torch.ops.echo.

`make_audiofx_chain` is gstpu's lighter chain: echo, then a loudness
measurement through an FIR approximation of the K-weighting evaluated
by overlap-save rFFT (gstpu_torch.ops.fftconv), a one-pole gain toward
a target and a tanh ceiling.
"""

from __future__ import annotations

import numpy as np
import torch

from gstpu_torch.core.device import default_device
from gstpu_torch.ops import loudnorm_dev
from gstpu_torch.ops.biquad import (_tree_sum_last, biquad_coeffs_highpass,
                                    biquad_coeffs_shelving)
from gstpu_torch.ops.echo import echo_block, make_state
from gstpu_torch.ops.fftconv import next_pow2, ols_block
from gstpu_torch.ops.loudnorm_dev import (FRAME, GAIN_LOOKAHEAD,
                                          STEP_STAGES, LoudnormParams,
                                          init_state, make_steps)

# the stages of the chain's step, in order, as it names them to `mark`
STAGES = ("echo",) + STEP_STAGES


def kweight_fir(rate: int, taps: int = 511) -> np.ndarray:
    """FIR approximation of the K-weighting pre-filter: impulse
    response of the two cascaded biquads, Hann-tapered. Accurate to
    <0.1 dB above ~80 Hz (the truncated tail only affects the deep
    low end)."""
    from scipy.signal import lfilter
    b1, a1 = biquad_coeffs_shelving(rate)
    b2, a2 = biquad_coeffs_highpass(rate)
    imp = np.zeros(taps)
    imp[0] = 1.0
    h = lfilter(b2, a2, lfilter(b1, a1, imp))
    fade = np.ones(taps)
    fade[taps // 2:] = np.hanning(taps)[taps // 2:] * 2
    fade = np.clip(fade, 0, 1)
    return (h * fade).astype(np.float32)


def make_audiofx_exact_chain(channels: int = 2, echo_delay: int = 48_000,
                             max_delay: int = 48_000):
    """The BASELINE audiofx chain rsaudioecho -> audioloudnorm ->
    ebur128level at 192 kHz F64, batched over streams.

    Returns (prime, step, init, n_prime, n_step):
      init(batch, device="cuda") -> state
      prime(state, x (B, 30*19200*C), intensity, feedback)
          -> (state, first out (B, 19200*C))
      step(state, x (B, 19200*C), intensity, feedback, mark=None)
          -> (state, out, meters{momentary, shortterm} (B,) LUFS)
    The steps run on the device of the state and x; intensity and
    feedback are Python floats. step calls mark(stage) after each of
    its STAGES where mark is given.
    echo_delay/max_delay are in flattened (interleaved) samples.
    """
    params = LoudnormParams(channels=channels)
    first_step, inner_step = make_steps(params, with_meter=True)
    C = channels

    def init(batch: int, device="cuda"):
        return dict(tail=make_state((batch,), max_delay, device=device),
                    ln=init_state(params, batch, device=device))

    def prime(state, x, intensity, feedback):
        tail, y = echo_block(state["tail"], x, intensity, feedback,
                             delay=echo_delay)
        ln, out, _meters = first_step(state["ln"], y)
        return dict(tail=tail, ln=ln), out

    def step(state, x, intensity, feedback, mark=None):
        tail, y = echo_block(state["tail"], x, intensity, feedback,
                             delay=echo_delay)
        if mark is not None:
            mark("echo")
        ln, out, meters = inner_step(state["ln"], y, mark=mark)
        return dict(tail=tail, ln=ln), out, meters

    n_prime = GAIN_LOOKAHEAD * C
    n_step = FRAME * C
    return prime, step, init, n_prime, n_step


def make_audiofx_chain(rate: int, delay_samples: int, tail_samples: int,
                       block: int = 48000):
    """Returns (step, init_state) for the fused audiofx chain over
    (B, N) blocks of mono-flattened samples.

    step(state, x, intensity, feedback, target_rms) ->
        (state, out, loudness_db)
    on the device of the state and x; intensity, feedback and
    target_rms are Python floats. The state is gstpu's tuple
    (tail (B, S) f64, hist (B, L-1) f32, smooth_gain (B,) f32);
    init_state(batch) puts it on default_device().

    Each lane's energy is a `_tree_sum_last` over its samples, so the
    lanes stay bitwise independent of one another wherever the FFT is;
    the FFTs (cuFFT, the CPU's) round otherwise than XLA's, so the step
    agrees with gstpu to f32 ulps, not bitwise.
    """
    fir = kweight_fir(rate)
    L = fir.shape[0]
    nfft = next_pow2(block + L - 1)
    fir_f_host = torch.fft.rfft(torch.from_numpy(fir), n=nfft)
    fir_f: dict[torch.device, torch.Tensor] = {}

    def step(state, x, intensity, feedback, target_rms):
        tail, hist, smooth_gain = state
        dev = x.device
        if dev not in fir_f:
            fir_f[dev] = fir_f_host.to(dev)
        # 1) echo (ring-delay feedback, exact f64 internals)
        tail, y = echo_block(tail, x, intensity, feedback,
                             delay=delay_samples)
        # 2) K-weighted energy via batched overlap-save rFFT conv
        hist, k = ols_block(hist, y.to(torch.float32), fir_f[dev],
                            ir_len=L)
        # both divisions divide by a device tensor, so they are IEEE
        # divisions on every device: torch takes a CUDA division by a
        # number, and `number / tensor` anywhere, as a reciprocal product
        sq = _tree_sum_last(k * k)
        energy = sq / torch.full_like(sq, k.shape[-1])
        loudness_db = -0.691 + 10.0 * torch.log10(energy + 1e-12)
        # 3) loudness-driven gain with one-pole smoothing (per stream)
        want = torch.full_like(energy, target_rms) \
            / torch.sqrt(energy + 1e-12)
        smooth_gain = 0.9 * smooth_gain + 0.1 * want
        y = y * smooth_gain[..., None]
        # 4) soft ceiling (smooth true-peak limiter stand-in)
        y = torch.tanh(y)
        return (tail, hist, smooth_gain), y.to(x.dtype), loudness_db

    def init_state(batch: int):
        dev = default_device()
        return (make_state((batch,), tail_samples, device=dev),
                torch.zeros((batch, L - 1), dtype=torch.float32,
                            device=dev),
                torch.ones(batch, dtype=torch.float32, device=dev))

    return step, init_state


def state_from_numpy(d, device="cuda"):
    """A chain's state from numpy leaves (gstpu's chain state with each
    leaf taken through np.asarray), on `device`: the exact chain's dict,
    or make_audiofx_chain's tuple."""
    if isinstance(d, tuple):
        return tuple(torch.from_numpy(np.array(a, copy=True)).to(device)
                     for a in d)
    return dict(tail=torch.from_numpy(np.array(d["tail"], copy=True))
                .to(device),
                ln=loudnorm_dev.state_from_numpy(d["ln"], device))


def state_to_numpy(st):
    """A chain's state as numpy leaves with gstpu's dtypes."""
    if isinstance(st, tuple):
        return tuple(a.cpu().numpy() for a in st)
    return dict(tail=st["tail"].cpu().numpy(),
                ln=loudnorm_dev.state_to_numpy(st["ln"]))
