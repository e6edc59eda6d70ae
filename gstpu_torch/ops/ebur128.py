"""EBU R 128 / ITU BS.1770 loudness measurement (ebur128 crate
equivalent).

Streaming meter with the same query surface the reference elements use
(audio/audiofx/src/audioloudnorm/imp.rs:124-148, ebur128level/imp.rs):
momentary (400 ms), short-term (3 s), gated integrated loudness,
relative threshold, loudness range (EBU Tech 3342), sample peak and
true peak (polyphase-oversampled).

The host meter of the port, a numpy copy of gstpu's (gstpu/ops/ebur128.py)
so that the host `audioloudnorm` and `ebur128level` give gstpu's samples
and messages bit for bit.

Internals: K-weighting via two biquads (`biquad_reference`, scipy's
lfilter), energies accumulated in 100 ms sub-blocks so every loudness
query is a cheap window sum. Gating stores exact block energies (the
reference's HISTOGRAM mode quantizes to bins; both are well inside the
+-0.1 LU conformance tolerance of EBU Tech 3341).
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np

from gstpu_torch.ops.biquad import (biquad_coeffs_highpass,
                                    biquad_coeffs_shelving, biquad_reference)

# 10^((-70 + 0.691) / 10): absolute gate block energy
ABS_THRESHOLD_ENERGY = 10.0 ** ((-70.0 + 0.691) / 10.0)
MINUS_INF = float("-inf")


def _channel_weights(channels: int) -> np.ndarray:
    """BS.1770 channel weights: L/R/C 1.0, LFE 0.0, surrounds 1.41
    (default layout assumption for >3 channels: L R C LFE Ls Rs ...)."""
    w = np.ones(channels)
    if channels > 3:
        w[3] = 0.0
        for i in range(4, min(channels, 6)):
            w[i] = 1.41
    return w


def _loudness_from_energy(e: float) -> float:
    if e <= 0.0:
        return MINUS_INF
    return -0.691 + 10.0 * math.log10(e)


def _true_peak_taps(factor: int, taps: int = 49) -> np.ndarray:
    """Windowed-sinc interpolation filter (half-band-ish low-pass at
    the original Nyquist), 49 taps like the reference's interpolator."""
    n = np.arange(taps, dtype=np.float64)
    center = (taps - 1) / 2.0
    x = (n - center) / factor
    sinc = np.sinc(x)
    window = np.hanning(taps)
    h = sinc * window
    return h


class EbuR128:
    """Streaming EBU R 128 state for one stream."""

    def __init__(self, channels: int, rate: int,
                 modes: frozenset = frozenset(("I", "S", "M", "LRA",
                                               "sample_peak", "true_peak"))):
        if rate % 10 != 0:
            raise ValueError(f"rate {rate} not divisible by 10 "
                             "(100 ms sub-blocks)")
        self.channels = channels
        self.rate = rate
        self.modes = frozenset(modes)
        self.weights = _channel_weights(channels)
        self._b1, self._a1 = biquad_coeffs_shelving(rate)
        self._b2, self._a2 = biquad_coeffs_highpass(rate)
        self.spb = rate // 10  # samples per 100 ms sub-block
        if rate < 96000:
            self._tp_factor = 4
        elif rate < 192000:
            self._tp_factor = 2
        else:
            self._tp_factor = 1
        self._tp_taps = (_true_peak_taps(self._tp_factor)
                         if self._tp_factor > 1 else None)
        self.reset()

    def reset(self) -> None:
        self._z1 = np.zeros((self.channels, 2))
        self._z2 = np.zeros((self.channels, 2))
        # per-channel energy sums of completed 100 ms sub-blocks
        self._subblocks: deque[np.ndarray] = deque(maxlen=30)
        self._partial = np.zeros(self.channels)
        self._partial_count = 0
        self._block_energies: list[float] = []   # 400 ms gating blocks
        self._st_energies: list[float] = []      # 3 s blocks for LRA
        self._n_subblocks = 0
        self._sample_peak = np.zeros(self.channels)
        self._true_peak = np.zeros(self.channels)
        self._tp_tail = np.zeros((self.channels,
                                  (len(self._tp_taps) - 1)
                                  if self._tp_taps is not None else 0))

    # -- feeding -------------------------------------------------------
    def add_frames(self, frames: np.ndarray) -> None:
        """frames: (N, channels) float64 interleaved view."""
        frames = np.asarray(frames, dtype=np.float64)
        if frames.ndim == 1:
            frames = frames.reshape(-1, self.channels)
        if frames.shape[0] == 0:
            return
        x = frames.T  # (channels, N)

        if "sample_peak" in self.modes:
            np.maximum(self._sample_peak, np.abs(x).max(axis=1),
                       out=self._sample_peak)
        if "true_peak" in self.modes:
            self._update_true_peak(x)

        y, self._z1 = biquad_reference(x, self._b1, self._a1, self._z1)
        y, self._z2 = biquad_reference(y, self._b2, self._a2, self._z2)
        sq = y * y

        # fill sub-blocks
        n = sq.shape[1]
        off = 0
        while off < n:
            take = min(self.spb - self._partial_count, n - off)
            self._partial += sq[:, off:off + take].sum(axis=1)
            self._partial_count += take
            off += take
            if self._partial_count == self.spb:
                self._finish_subblock()

    def _finish_subblock(self) -> None:
        self._subblocks.append(self._partial)
        self._partial = np.zeros(self.channels)
        self._partial_count = 0
        self._n_subblocks += 1
        if "I" in self.modes and self._n_subblocks >= 4:
            e = self._window_energy(4)
            if e > ABS_THRESHOLD_ENERGY:
                self._block_energies.append(e)
        if "LRA" in self.modes and self._n_subblocks >= 30:
            e = self._window_energy(30)
            if e > ABS_THRESHOLD_ENERGY:
                self._st_energies.append(e)

    def _window_energy(self, n_sub: int) -> float:
        """Energy over the last n_sub sub-blocks; windows shorter than
        n_sub are zero-padded (libebur128's ring starts zeroed)."""
        blocks = list(self._subblocks)[-n_sub:]
        per_channel = np.sum(blocks, axis=0) / (n_sub * self.spb)
        return float(np.dot(self.weights, per_channel))

    def _update_true_peak(self, x: np.ndarray) -> None:
        if self._tp_factor == 1:
            np.maximum(self._true_peak, np.abs(x).max(axis=1),
                       out=self._true_peak)
            return
        taps = self._tp_taps
        full = np.concatenate([self._tp_tail, x], axis=1)
        self._tp_tail = full[:, -(len(taps) - 1):]
        for p in range(self._tp_factor):
            # polyphase: phase-p sub-filter applied at input rate
            h = taps[p::self._tp_factor]
            for c in range(self.channels):
                v = np.convolve(full[c], h, mode="valid")
                if v.size:
                    self._true_peak[c] = max(self._true_peak[c],
                                             float(np.abs(v).max()))

    # -- queries -------------------------------------------------------
    def loudness_momentary(self) -> float:
        if self._n_subblocks < 4:
            return MINUS_INF
        return _loudness_from_energy(self._window_energy(4))

    def loudness_shortterm(self) -> float:
        if self._n_subblocks == 0:
            return MINUS_INF
        return _loudness_from_energy(self._window_energy(30))

    def loudness_global(self) -> float:
        if not self._block_energies:
            return MINUS_INF
        e = np.asarray(self._block_energies)
        mean1 = e.mean()
        rel_gate = mean1 * 10.0 ** (-10.0 / 10.0)
        gated = e[e > rel_gate]
        if gated.size == 0:
            return MINUS_INF
        return _loudness_from_energy(float(gated.mean()))

    def relative_threshold(self) -> float:
        if not self._block_energies:
            return -70.0
        mean1 = float(np.mean(self._block_energies))
        return _loudness_from_energy(mean1) - 10.0

    def loudness_range(self) -> float:
        if not self._st_energies:
            return 0.0
        e = np.asarray(self._st_energies)
        # relative gate: -20 LU below the mean of abs-gated blocks
        rel_gate = e.mean() * 10.0 ** (-20.0 / 10.0)
        gated = np.sort(e[e > rel_gate])
        if gated.size < 2:
            return 0.0
        lo = gated[int(round(0.10 * (gated.size - 1)))]
        hi = gated[int(round(0.95 * (gated.size - 1)))]
        return 10.0 * math.log10(hi / lo)

    def sample_peak(self, channel: int) -> float:
        return float(self._sample_peak[channel])

    def true_peak(self, channel: int) -> float:
        return float(max(self._true_peak[channel],
                         self._sample_peak[channel]
                         if "sample_peak" in self.modes else
                         self._true_peak[channel]))
