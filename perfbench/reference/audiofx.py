"""Plain reference of the flagship audio chain, `rsaudioecho !
audioloudnorm ! ebur128level`, one stream at a time in NumPy.

It imports nothing of the program. The loudness normalizer and the meter
are a frozen copy of the host engine of the upstream element
(gst-plugins-rs audio/audiofx/src/audioloudnorm/imp.rs, as ported to
NumPy beside the CUDA port: the limiter's per-sample loops vectorised
per segment, the K-weighting in scipy's lfilter), reduced to what a
stream that never ends needs (no EOS drain, no first-frame-is-last).
The echo is the ring-buffer recurrence of audioecho/imp.rs written per
segment of at most one delay.

Every sample buffer, filter state and filter coefficient is held in
`dtype`: float64 is the reference, float32 its control (the nearest
precision below the configuration's F64).
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np
from scipy.signal import lfilter

GAIN_LOOKAHEAD = 3 * 192_000       # 3 s
FRAME_SIZE = 19_200                # 100 ms
LIMITER_ATTACK_WINDOW = 1_920      # 10 ms
LIMITER_RELEASE_WINDOW = 19_200    # 100 ms
LIMITER_LOOKAHEAD = 1_920          # 10 ms

OUT, ATTACK, SUSTAIN, RELEASE = range(4)
FIRST, INNER = range(2)


def biquad_coeffs_shelving(rate: int):
    """BS.1770 stage-1 shelving filter (libebur128's constants)."""
    f0 = 1681.974450955533
    G = 3.999843853973347
    Q = 0.7071752369554196
    K = np.tan(np.pi * f0 / rate)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b = np.array([(Vh + Vb * K / Q + K * K) / a0,
                  2.0 * (K * K - Vh) / a0,
                  (Vh - Vb * K / Q + K * K) / a0])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                  (1.0 - K / Q + K * K) / a0])
    return b, a


def biquad_coeffs_highpass(rate: int):
    """BS.1770 stage-2 high-pass (RLB weighting)."""
    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = np.tan(np.pi * f0 / rate)
    a0 = 1.0 + K / Q + K * K
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                  (1.0 - K / Q + K * K) / a0])
    b = np.array([1.0, -2.0, 1.0])
    return b, a



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


class EbuR128:
    """Streaming EBU R 128 state for one stream (the ebur128 crate's
    momentary, short-term and gated integrated loudness): K-weighting by
    two biquads, energies kept in 100 ms sub-blocks. `gated` keeps the
    400 ms blocks for the integrated loudness."""

    def __init__(self, channels: int, rate: int, gated: bool, dtype):
        if rate % 10 != 0:
            raise ValueError(f"rate {rate} not divisible by 10 "
                             "(100 ms sub-blocks)")
        self.channels = channels
        self.gated = gated
        self.dt = np.dtype(dtype)
        self.weights = _channel_weights(channels)
        self._b1, self._a1 = (c.astype(self.dt)
                              for c in biquad_coeffs_shelving(rate))
        self._b2, self._a2 = (c.astype(self.dt)
                              for c in biquad_coeffs_highpass(rate))
        self.spb = rate // 10  # samples per 100 ms sub-block
        self._z1 = np.zeros((channels, 2), self.dt)
        self._z2 = np.zeros((channels, 2), self.dt)
        # per-channel energy sums of completed 100 ms sub-blocks
        self._subblocks: deque[np.ndarray] = deque(maxlen=30)
        self._partial = np.zeros(channels, self.dt)
        self._partial_count = 0
        self._block_energies: list[float] = []   # 400 ms gating blocks
        self._n_subblocks = 0

    def add_frames(self, frames: np.ndarray) -> None:
        """frames: (N, channels) interleaved."""
        x = np.asarray(frames, dtype=self.dt).reshape(
            -1, self.channels).T
        y, self._z1 = lfilter(self._b1, self._a1, x, axis=-1, zi=self._z1)
        y, self._z2 = lfilter(self._b2, self._a2, y, axis=-1, zi=self._z2)
        sq = y * y
        n, off = sq.shape[1], 0
        while off < n:
            take = min(self.spb - self._partial_count, n - off)
            self._partial += sq[:, off:off + take].sum(axis=1)
            self._partial_count += take
            off += take
            if self._partial_count == self.spb:
                self._finish_subblock()

    def _finish_subblock(self) -> None:
        self._subblocks.append(self._partial)
        self._partial = np.zeros(self.channels, self.dt)
        self._partial_count = 0
        self._n_subblocks += 1
        if self.gated and self._n_subblocks >= 4:
            e = self._window_energy(4)
            if e > ABS_THRESHOLD_ENERGY:
                self._block_energies.append(e)

    def _window_energy(self, n_sub: int) -> float:
        """Energy over the last n_sub sub-blocks; windows shorter than
        n_sub are zero-padded (libebur128's ring starts zeroed)."""
        blocks = list(self._subblocks)[-n_sub:]
        per_channel = np.sum(blocks, axis=0) / (n_sub * self.spb)
        return float(np.dot(self.weights, per_channel))

    def loudness_momentary(self) -> float:
        # libebur128's ring starts zeroed, so the first 300 ms read a
        # zero-padded window, as the card's fused meter does (the host
        # engine this file copies reads -inf there)
        if self._n_subblocks == 0:
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
        rel_gate = e.mean() * 10.0 ** (-10.0 / 10.0)
        gated = e[e > rel_gate]
        if gated.size == 0:
            return MINUS_INF
        return _loudness_from_energy(float(gated.mean()))

    def relative_threshold(self) -> float:
        if not self._block_energies:
            return -70.0
        mean1 = float(np.mean(self._block_energies))
        return _loudness_from_energy(mean1) - 10.0


def _gaussian_weights() -> np.ndarray:
    """21-tap gaussian, sigma 3.5, normalized (imp.rs:1893-1914)."""
    sigma = 3.5
    x = np.arange(21, dtype=np.float64) - 10.0
    w = (1.0 / (sigma * np.sqrt(2.0 * np.pi))) * np.exp(-(x ** 2)
                                                        / (2 * sigma ** 2))
    return w / w.sum()


class LoudNorm:
    """One stream's audioloudnorm state (imp.rs:76-198), every sample
    buffer in `dtype`."""

    def __init__(self, settings: dict, channels: int, rate: int, dtype):
        ch = channels
        self.channels = ch
        self.dt = np.dtype(dtype)
        dt = self.dt

        self.offset = 10.0 ** (settings["offset_db"] / 20.0)
        self.target_i = settings["loudness_target"]
        self.target_lra = settings["loudness_range_target"]
        self.target_tp = 10.0 ** (settings["max_true_peak"] / 20.0)

        self.buf = np.zeros(GAIN_LOOKAHEAD * ch, dt)
        self.buf_index = 0
        self.prev_buf_index = 0

        self.weights = _gaussian_weights().astype(dt)
        self.delta = np.zeros(30, dt)
        self.index = 1
        self.prev_delta = 0.0

        self.gain_reduction = [0.0, 0.0]
        self.limiter_buf = np.zeros((2 * FRAME_SIZE + LIMITER_LOOKAHEAD) * ch,
                                    dt)
        self.limiter_buf_index = 0
        self.prev_smp = np.zeros(ch, dt)
        self.limiter_state = OUT
        self.env_cnt = 0
        self.sustain_cnt: int | None = None

        self.frame_type = FIRST
        self.above_threshold = False

        self.r128_in = EbuR128(ch, rate, True, dt)
        self.r128_out = EbuR128(ch, rate, False, dt)

    # -- ring helpers --------------------------------------------------
    def _lim_idx(self, start_smp: int, count_samples: int) -> np.ndarray:
        ch = self.channels
        base = self.limiter_buf_index + start_smp * ch
        return (base + np.arange(count_samples * ch)) % self.limiter_buf.size

    def _apply_env(self, start_smp: int, envs: np.ndarray) -> None:
        """Multiply limiter_buf samples [start_smp, start_smp+len(envs))
        (relative to limiter_buf_index) by per-sample envelope."""
        if envs.size == 0:
            return
        idx = self._lim_idx(start_smp, envs.size)
        self.limiter_buf[idx] *= np.repeat(envs, self.channels)

    def _lim_window_abs(self, start_smp: int, count: int) -> np.ndarray:
        """(count, channels) |samples| starting at start_smp relative to
        limiter_buf_index (circular read)."""
        idx = self._lim_idx(start_smp, count)
        return np.abs(self.limiter_buf[idx]).reshape(count, self.channels)

    # -- gain computation ----------------------------------------------
    def gaussian_filter(self, index: int) -> float:
        idx = index - 10 if index > 10 else index + 20
        d = np.concatenate([self.delta[idx:], self.delta])[:21]
        return float(np.dot(self.weights, d))

    # -- frame fill ------------------------------------------------------
    def process_fill_inner_frame(self, src: np.ndarray) -> None:
        """imp.rs:447-530: write 100 ms of new input into buf, move the
        gain-corrected 100 ms read window into limiter_buf."""
        ch = self.channels
        gain = self.gaussian_filter((self.index + 10) % 30)
        gain_next = self.gaussian_filter((self.index + 11) % 30)
        n = src.size // ch

        ramp = np.arange(n, dtype=self.dt) / FRAME_SIZE
        gains = (gain + ramp * (gain_next - gain)) \
            * self.offset

        read_idx = (self.buf_index + np.arange(n * ch)) % self.buf.size
        write_idx = (self.prev_buf_index + np.arange(n * ch)) % self.buf.size
        lim_idx = self._lim_idx(0, n)

        self.limiter_buf[lim_idx] = self.buf[read_idx] * np.repeat(gains, ch)
        self.buf[write_idx] = src

        self.limiter_buf_index = (self.limiter_buf_index + n * ch) \
            % self.limiter_buf.size
        self.prev_buf_index = (self.prev_buf_index + n * ch) % self.buf.size
        self.buf_index = (self.buf_index + n * ch) % self.buf.size

    def process_update_gain_inner_frame(self) -> None:
        """imp.rs:532-610: compute delta[index] from measurements."""
        global_ = self.r128_in.loudness_global()
        shortterm = self.r128_in.loudness_shortterm()
        relative_threshold = self.r128_in.relative_threshold()

        if not self.above_threshold:
            if shortterm > -70.0:
                self.prev_delta *= 1.0058
            shortterm_out = self.r128_out.loudness_shortterm()
            if shortterm_out >= self.target_i:
                self.above_threshold = True

        if shortterm < relative_threshold or shortterm <= -70.0 \
                or not self.above_threshold:
            self.delta[self.index] = self.prev_delta
        else:
            if abs(shortterm - global_) < (self.target_lra / 2.0):
                env_global = shortterm - global_
            elif (self.target_lra / 2.0) * (shortterm - global_) < 0.0:
                env_global = -1.0
            else:
                env_global = 1.0
            env_shortterm = self.target_i - shortterm
            self.delta[self.index] = 10.0 ** ((env_global + env_shortterm)
                                              / 20.0)

        self.prev_delta = self.delta[self.index]
        self.index = (self.index + 1) % 30

    # -- peak detection (imp.rs:1403-1527) -------------------------------
    def detect_peak(self, offset: int, samples: int):
        """Find the first true peak >= target_tp at least LOOKAHEAD
        ahead; returns (peak_delta, peak_value) or None. Vectorized
        over the scan window; mirrors per-channel prev_smp updates."""
        if samples <= 0:
            return None
        ch = self.channels
        # window of |samples| starting LOOKAHEAD after offset, plus 12
        # extra for the lookahead validation
        win = self._lim_window_abs(offset + LIMITER_LOOKAHEAD, samples + 12)
        this = win[:samples]                      # (n, ch)
        nxt = win[1:samples + 1]
        prev = np.empty_like(this)
        prev[0] = self.prev_smp
        prev[1:] = this[:-1]

        cand = (prev <= this) & (this >= nxt) & (this > self.target_tp)
        cand[0] = False  # n > 0 requirement
        if cand.any():
            # 12-sample check: none of samples n+2..n+11 may exceed this
            future_max = np.zeros_like(this)
            for i in range(2, 12):
                future_max = np.maximum(future_max, win[i:i + samples])
            ok = cand & (future_max <= this)
            hits = np.nonzero(ok.any(axis=1))[0]
            if hits.size:
                n = int(hits[0])
                max_peak = float(this[n].max())
                self.prev_smp = this[n].copy()
                return n, max_peak
        # no detection: prev_smp ends at the last scanned sample
        self.prev_smp = this[-1].copy()
        return None

    # -- limiter (imp.rs:845-1400) ---------------------------------------
    def true_peak_limiter_first_frame(self) -> None:
        ch = self.channels
        assert self.limiter_buf_index == 0
        seg = self.limiter_buf[:(LIMITER_LOOKAHEAD + 1) * ch]
        max_ = 0.0
        for s in seg:
            if abs(s) > max_:
                max_ = s  # NB: reference keeps the signed value
        self.prev_smp = np.abs(
            self.limiter_buf[LIMITER_LOOKAHEAD * ch:
                             (LIMITER_LOOKAHEAD + 1) * ch]).copy()
        if max_ > self.target_tp:
            self.limiter_state = SUSTAIN
            self.sustain_cnt = LIMITER_LOOKAHEAD
            self.gain_reduction[1] = self.target_tp / max_

    def _limiter_out(self, smp_cnt: int, nb_samples: int) -> int:
        peak = self.detect_peak(smp_cnt, nb_samples - smp_cnt)
        if peak is not None:
            peak_delta, peak_value = peak
            self.limiter_state = ATTACK
            self.env_cnt = 0
            self.sustain_cnt = None
            self.gain_reduction[0] = 1.0
            self.gain_reduction[1] = self.target_tp / peak_value
            smp_cnt += LIMITER_LOOKAHEAD + peak_delta - LIMITER_ATTACK_WINDOW
        else:
            smp_cnt = nb_samples
        return smp_cnt

    def _limiter_attack(self, smp_cnt: int, nb_samples: int) -> int:
        gr = self.gain_reduction
        peak = self.detect_peak(smp_cnt, nb_samples - smp_cnt)
        new_peak_smp = smp_cnt + peak[0] if peak is not None else None

        # vectorized version of the env while-loop
        k = min(LIMITER_ATTACK_WINDOW - self.env_cnt, nb_samples - smp_cnt)
        if new_peak_smp is not None:
            k = min(k, new_peak_smp - smp_cnt)
        if k > 0:
            t = (self.env_cnt + np.arange(k, dtype=self.dt)) \
                / (LIMITER_ATTACK_WINDOW - 1.0)
            envs = gr[0] - t * (gr[0] - gr[1])
            self._apply_env(smp_cnt, envs)
            smp_cnt += k
            self.env_cnt += k

        if new_peak_smp is not None:
            assert smp_cnt < nb_samples
            if smp_cnt < new_peak_smp:
                # sustain with target reduction until 10ms before peak
                self._apply_env(smp_cnt,
                                np.full(new_peak_smp - smp_cnt, gr[1],
                                        self.dt))
                smp_cnt = new_peak_smp
            assert smp_cnt < nb_samples

            peak_value = peak[1]
            gain_reduction = self.target_tp / peak_value
            if gain_reduction < gr[1]:
                current = gr[0] - (self.env_cnt
                                   / (LIMITER_ATTACK_WINDOW - 1.0)) \
                    * (gr[0] - gr[1])
                old_slope = -(gr[0] - gr[1])
                new_slope = -(current - gain_reduction)
                if new_slope <= old_slope:
                    self.limiter_state = ATTACK
                    gr[0] = current
                    gr[1] = gain_reduction
                    self.env_cnt = 0
                    self.sustain_cnt = None
                else:
                    new_end = max((gain_reduction - gr[0]) / old_slope, 1.0)
                    new_start = new_end - 1.0
                    gr[0] = gr[0] + new_start * old_slope
                    gr[1] = gain_reduction
                    cur_pos = (current - gr[0]) / old_slope
                    cur_pos = min(max(cur_pos, 0.0), 1.0)
                    self.env_cnt = int((LIMITER_ATTACK_WINDOW - 1.0)
                                       * cur_pos)
                    self.sustain_cnt = self.env_cnt
                return smp_cnt
            else:
                if self.env_cnt < LIMITER_ATTACK_WINDOW:
                    self.sustain_cnt = self.env_cnt

        if self.env_cnt == LIMITER_ATTACK_WINDOW and smp_cnt < nb_samples:
            self.limiter_state = SUSTAIN
        return smp_cnt

    def _limiter_sustain(self, smp_cnt: int, nb_samples: int) -> int:
        gr = self.gain_reduction
        peak = self.detect_peak(smp_cnt, nb_samples - smp_cnt)
        sustain_cnt = peak[0] if peak is not None else self.sustain_cnt

        if sustain_cnt is not None:
            s = min(sustain_cnt, nb_samples - smp_cnt)
            if s > 0:
                self._apply_env(smp_cnt, np.full(s, gr[1], self.dt))
                smp_cnt += s
            if peak is not None:
                peak_value = peak[1]
                gain_reduction = self.target_tp / peak_value
                if gain_reduction < gr[1]:
                    self.limiter_state = ATTACK
                    self.env_cnt = 0
                    self.sustain_cnt = None
                    gr[0] = gr[1]
                    gr[1] = gain_reduction
                else:
                    self.sustain_cnt = LIMITER_LOOKAHEAD
            elif self.sustain_cnt is not None:
                self.sustain_cnt -= s
                if self.sustain_cnt == 0:
                    self.sustain_cnt = None
        else:
            self.limiter_state = RELEASE
            gr[0] = gr[1]
            gr[1] = 1.0
            self.env_cnt = 0
        return smp_cnt

    def _limiter_release(self, smp_cnt: int, nb_samples: int) -> int:
        gr = self.gain_reduction
        peak = self.detect_peak(smp_cnt, nb_samples - smp_cnt)
        if peak is not None:
            peak_delta, peak_value = peak
            gain_reduction = self.target_tp / peak_value
            # NB: reference formula (imp.rs:1238-1240) uses
            # (gr[1]-gr[0]) here — envelope *descends* during release;
            # mirrored bug-for-bug for parity.
            current = gr[0] - (self.env_cnt
                               / (LIMITER_RELEASE_WINDOW - 1.0)) \
                * (gr[1] - gr[0])
            if gain_reduction < current:
                assert smp_cnt + peak_delta < nb_samples
                if peak_delta > 0:
                    self._apply_env(smp_cnt,
                                    np.full(peak_delta, gr[1], self.dt))
                    smp_cnt += peak_delta
                self.limiter_state = ATTACK
                self.env_cnt = 0
                self.sustain_cnt = None
                gr[0] = current
                gr[1] = gain_reduction
            else:
                gr[1] = current
                self.limiter_state = SUSTAIN
            return smp_cnt

        k = min(LIMITER_RELEASE_WINDOW - self.env_cnt, nb_samples - smp_cnt)
        if k > 0:
            t = (self.env_cnt + np.arange(k, dtype=self.dt)) \
                / (LIMITER_RELEASE_WINDOW - 1.0)
            envs = gr[0] - t * (gr[1] - gr[0])   # reference formula
            self._apply_env(smp_cnt, envs)
            smp_cnt += k
            self.env_cnt += k
        if smp_cnt < nb_samples:
            self.limiter_state = OUT
        return smp_cnt

    def true_peak_limiter(self, nb_samples: int) -> np.ndarray:
        """Run the limiter over the next nb_samples of limiter_buf and
        return them (clamped), imp.rs:1338-1400."""
        if self.frame_type == FIRST:
            self.true_peak_limiter_first_frame()

        smp_cnt = 0
        while smp_cnt < nb_samples:
            if self.limiter_state == OUT:
                smp_cnt = self._limiter_out(smp_cnt, nb_samples)
            elif self.limiter_state == ATTACK:
                smp_cnt = self._limiter_attack(smp_cnt, nb_samples)
            elif self.limiter_state == SUSTAIN:
                smp_cnt = self._limiter_sustain(smp_cnt, nb_samples)
            else:
                smp_cnt = self._limiter_release(smp_cnt, nb_samples)

        idx = self._lim_idx(0, nb_samples)
        out = self.limiter_buf[idx].copy()
        np.clip(out, -self.target_tp, self.target_tp, out=out)
        return out

    # -- frame processing -------------------------------------------------
    def process_first_frame(self, src: np.ndarray):
        self.buf[:] = src
        shortterm = self.r128_in.loudness_shortterm()
        if shortterm < -70.0:
            self.above_threshold = False
            env_shortterm = 0.0
        else:
            self.above_threshold = True
            env_shortterm = self.target_i - shortterm
        self.delta[:] = 10.0 ** (env_shortterm / 20.0)
        self.prev_delta = self.delta[self.index]

        n_lim = self.limiter_buf.size
        self.limiter_buf[:] = self.buf[:n_lim] * self.prev_delta \
            * self.offset
        self.buf_index = n_lim
        self.limiter_buf_index = 0

        out = self.true_peak_limiter(FRAME_SIZE)
        self.r128_out.add_frames(out.reshape(-1, self.channels))

        self.current_samples_per_frame = FRAME_SIZE
        self.frame_type = INNER
        return out

    def process_inner_frame(self, src: np.ndarray):
        self.process_fill_inner_frame(src)
        out = self.true_peak_limiter(FRAME_SIZE)
        self.r128_out.add_frames(out.reshape(-1, self.channels))
        self.process_update_gain_inner_frame()
        return out


class Echo:
    """audioecho's ring (imp.rs:69-86) over flattened interleaved
    samples: e = written[i - D]; out = in + intensity * e;
    written = in + feedback * e; the last `max_delay` written samples
    kept, silence before the first."""

    def __init__(self, delay: int, max_delay: int, intensity: float,
                 feedback: float, dtype):
        if not max_delay >= delay >= 1:
            raise ValueError("echo needs max_delay >= delay >= 1")
        self.dt = np.dtype(dtype)
        self.delay = delay
        self.intensity = self.dt.type(intensity)
        self.feedback = self.dt.type(feedback)
        self.hist = np.zeros(max_delay, self.dt)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, self.dt)
        D, S = self.delay, self.hist.size
        hist, outs, off = self.hist, [], 0
        while off < x.size:
            n = min(D, x.size - off)
            seg = x[off:off + n]
            e = hist[hist.size - D:hist.size - D + n]
            outs.append(seg + self.intensity * e)
            hist = np.concatenate([hist, seg + self.feedback * e])[-S:]
            off += n
        self.hist = hist
        return np.concatenate(outs)


class Chain:
    """One stream through echo, loudness normalizer and meter.

    `prime` takes the first 3 s (the gain look-ahead) and returns the
    first 100 ms out; each `step` takes 100 ms and returns it out with
    the meter's momentary and short-term loudness (LUFS) after it."""

    def __init__(self, cfg: dict, dtype=np.float64):
        rate, ch = cfg["rate"], cfg["channels"]
        if rate != 192_000:
            raise ValueError("audioloudnorm takes 192 kHz only")
        echo, ln = cfg["echo"], cfg["loudnorm"]
        delay = round(echo["delay_s"] * rate) * ch
        self.echo = Echo(delay, round(echo["max_delay_s"] * rate) * ch,
                         echo["intensity"], echo["feedback"], dtype)
        self.ln = LoudNorm(ln, ch, rate, dtype)
        self.meter = EbuR128(ch, rate, False, dtype)
        self.channels = ch

    def _out(self, y: np.ndarray) -> np.ndarray:
        self.ln.r128_in.add_frames(y.reshape(-1, self.channels))
        return y

    def prime(self, x: np.ndarray) -> np.ndarray:
        y = self._out(self.echo(x))
        out = self.ln.process_first_frame(y)
        self.meter.add_frames(out.reshape(-1, self.channels))
        return out

    def step(self, x: np.ndarray) -> tuple:
        y = self._out(self.echo(x))
        out = self.ln.process_inner_frame(y)
        self.meter.add_frames(out.reshape(-1, self.channels))
        return (out, self.meter.loudness_momentary(),
                self.meter.loudness_shortterm())
