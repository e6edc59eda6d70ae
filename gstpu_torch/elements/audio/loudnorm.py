"""audioloudnorm + ebur128level: EBU R 128 loudness stack.

The port of gstpu/elements/audio/loudnorm.py. audioloudnorm is a
faithful re-implementation of the reference's streaming loudness
normalizer (audio/audiofx/src/audioloudnorm/imp.rs, itself a port of
ffmpeg af_loudnorm): F64 @ 192 kHz, 100 ms frames with a 3 s gain
lookahead, per-frame gains from short-term/global loudness smoothed by a
21-tap Gaussian, and a per-sample true-peak limiter state machine
(Out/Attack/Sustain/Release). ebur128level is the passthrough loudness
meter (audio/audiofx/src/ebur128level/imp.rs) posting `ebur128-level`
element messages per interval.

Without `context` both elements run on the host, a numpy copy of
gstpu's host path (the limiter's per-sample loops vectorized into
per-segment numpy ops; measurement by gstpu_torch.ops.ebur128), so they
give gstpu's samples and messages bit for bit; a tensor buffer is read
to the host once. With `context` they are stages of a DeviceContext
chain running gstpu_torch.ops.loudnorm_dev batched over streams, the
meter fused into the normalizer's output measurement where its modes
allow.
"""

from __future__ import annotations

import numpy as np

from gstpu_torch.core.adapter import SampleAdapter
from gstpu_torch.core.audio import AudioInfo, audio_caps
from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.device import default_device
from gstpu_torch.core.element import (Element, FlowReturn, Pad,
                                      PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.event import (CapsEvent, EosEvent, Event,
                                    FlushStopEvent, SegmentEvent)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.query import LatencyQuery
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.ops.ebur128 import EbuR128
from gstpu_torch.ops.loudnorm_dev import (HOST_INTS, LoudnormParams,
                                          init_meter_state, init_state,
                                          make_final_step, make_meter_step,
                                          make_steps)
from gstpu_torch.runtime.device_batch import (DeviceContext, DeviceRow,
                                              _is_device)

SECOND = 1_000_000_000

# Gain analysis parameters (reference imp.rs:207-214)
GAIN_LOOKAHEAD = 3 * 192_000       # 3 s
FRAME_SIZE = 19_200                # 100 ms
# Limiter parameters
LIMITER_ATTACK_WINDOW = 1_920      # 10 ms
LIMITER_RELEASE_WINDOW = 19_200    # 100 ms
LIMITER_LOOKAHEAD = 1_920          # 10 ms

OUT, ATTACK, SUSTAIN, RELEASE = range(4)
FIRST, INNER, FINAL, LINEAR = range(4)


def _gaussian_weights() -> np.ndarray:
    """21-tap gaussian, sigma 3.5, normalized (imp.rs:1893-1914)."""
    sigma = 3.5
    x = np.arange(21, dtype=np.float64) - 10.0
    w = (1.0 / (sigma * np.sqrt(2.0 * np.pi))) * np.exp(-(x ** 2)
                                                        / (2 * sigma ** 2))
    return w / w.sum()


class _LoudNormState:
    """Port of the reference State (imp.rs:76-198)."""

    def __init__(self, settings: dict, info: AudioInfo):
        self.info = info
        ch = info.channels
        self.channels = ch
        self.adapter = SampleAdapter(info.rate)
        self.current_samples_per_frame = GAIN_LOOKAHEAD

        self.offset = 10.0 ** (settings["offset"] / 20.0)
        self.target_i = settings["loudness_target"]
        self.target_lra = settings["loudness_range_target"]
        self.target_tp = 10.0 ** (settings["max_true_peak"] / 20.0)

        self.buf = np.zeros(GAIN_LOOKAHEAD * ch)
        self.buf_index = 0
        self.prev_buf_index = 0

        self.weights = _gaussian_weights()
        self.delta = np.zeros(30)
        self.index = 1
        self.prev_delta = 0.0

        self.gain_reduction = [0.0, 0.0]
        self.limiter_buf = np.zeros((2 * FRAME_SIZE + LIMITER_LOOKAHEAD) * ch)
        self.limiter_buf_index = 0
        self.prev_smp = np.zeros(ch)
        self.limiter_state = OUT
        self.env_cnt = 0
        self.sustain_cnt: int | None = None

        self.frame_type = FIRST
        self.above_threshold = False

        modes = frozenset(("I", "S", "LRA", "sample_peak"))
        self.r128_in = EbuR128(ch, info.rate, modes)
        self.r128_out = EbuR128(ch, info.rate, modes)

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

        gains = (gain + (np.arange(n) / FRAME_SIZE) * (gain_next - gain)) \
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

    def process_fill_final_frame(self, idx: int, num_samples: int) -> None:
        """imp.rs:612-668: like fill_inner but reads only (no new
        input), for draining."""
        ch = self.channels
        gain = self.gaussian_filter((self.index + 10) % 30)
        gain_next = self.gaussian_filter((self.index + 11) % 30)
        n = num_samples - idx
        if n <= 0:
            return
        gains = (gain + (np.arange(idx, num_samples) / num_samples)
                 * (gain_next - gain)) * self.offset
        read_idx = (self.buf_index + np.arange(n * ch)) % self.buf.size
        lim_idx = self._lim_idx(0, n)
        self.limiter_buf[lim_idx] = self.buf[read_idx] * np.repeat(gains, ch)
        self.limiter_buf_index = (self.limiter_buf_index + n * ch) \
            % self.limiter_buf.size
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
            t = (self.env_cnt + np.arange(k)) / (LIMITER_ATTACK_WINDOW - 1.0)
            envs = gr[0] - t * (gr[0] - gr[1])
            self._apply_env(smp_cnt, envs)
            smp_cnt += k
            self.env_cnt += k

        if new_peak_smp is not None:
            assert smp_cnt < nb_samples
            if smp_cnt < new_peak_smp:
                # sustain with target reduction until 10ms before peak
                self._apply_env(smp_cnt,
                                np.full(new_peak_smp - smp_cnt, gr[1]))
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
                self._apply_env(smp_cnt, np.full(s, gr[1]))
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
                    self._apply_env(smp_cnt, np.full(peak_delta, gr[1]))
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
            t = (self.env_cnt + np.arange(k)) / (LIMITER_RELEASE_WINDOW - 1.0)
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
    def process_first_frame_is_last(self) -> None:
        global_ = self.r128_in.loudness_global()
        true_peak = max((self.r128_in.sample_peak(c)
                         for c in range(self.channels)), default=0.0)
        # IEEE semantics like the Rust reference (imp.rs:322-353):
        # silence gives global=-inf -> offset=inf, offset_tp=nan,
        # nan<target is false -> target/0 = inf; inf * silence = nan
        # never escapes because the gated output is still silence-only
        # in practice (0 * finite offsets); we keep the same arithmetic.
        with np.errstate(divide="ignore", invalid="ignore"):
            offset = np.float64(10.0) ** ((self.target_i - global_) / 20.0)
            offset_tp = np.float64(true_peak) * offset
            self.offset = float(offset) if offset_tp < self.target_tp \
                else float(np.float64(self.target_tp)
                           / np.float64(true_peak))
        self.frame_type = LINEAR

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
        return out, 0  # pts delta handled by caller

    def process_inner_frame(self, src: np.ndarray):
        self.process_fill_inner_frame(src)
        out = self.true_peak_limiter(FRAME_SIZE)
        self.r128_out.add_frames(out.reshape(-1, self.channels))
        self.process_update_gain_inner_frame()
        return out

    def process_final_frame(self, src: np.ndarray):
        ch = self.channels
        num_samples = src.size // ch
        self.process_fill_inner_frame(src)
        if num_samples != FRAME_SIZE:
            self.process_fill_final_frame(num_samples, FRAME_SIZE)
        out_num_samples = 30 * FRAME_SIZE - (FRAME_SIZE - num_samples)
        out = np.empty(out_num_samples * ch)
        smp_cnt = 0
        while smp_cnt < out_num_samples:
            frame_size = min(out_num_samples - smp_cnt, FRAME_SIZE)
            dst = self.true_peak_limiter(frame_size)
            out[smp_cnt * ch:(smp_cnt + frame_size) * ch] = dst
            smp_cnt += frame_size
            if smp_cnt == out_num_samples:
                break
            self.r128_out.add_frames(dst.reshape(-1, ch))
            self.process_update_gain_inner_frame()
            next_frame_size = min(out_num_samples - smp_cnt, FRAME_SIZE)
            self.process_fill_final_frame(0, next_frame_size)
            if next_frame_size < FRAME_SIZE:
                self.limiter_buf_index = (
                    self.limiter_buf_index
                    + (FRAME_SIZE - next_frame_size) * ch) \
                    % self.limiter_buf.size
        return out

    def process_linear_frame(self, src: np.ndarray):
        out = src * self.offset
        self.r128_out.add_frames(out.reshape(-1, self.channels))
        return out

    def process(self, src: np.ndarray, pts):
        """Returns (out_flat, out_pts)."""
        self.r128_in.add_frames(src.reshape(-1, self.channels))

        if self.frame_type == FIRST and \
                (src.size // self.channels) < self.current_samples_per_frame:
            self.process_first_frame_is_last()

        ft = self.frame_type
        if ft == FIRST:
            out, _ = self.process_first_frame(src)
            out_pts = pts
        elif ft == INNER:
            out = self.process_inner_frame(src)
            out_pts = None if pts is None \
                else pts + 100 * SECOND // 1000 - 3 * SECOND
        elif ft == FINAL:
            out = self.process_final_frame(src)
            out_pts = None if pts is None \
                else pts + 100 * SECOND // 1000 - 3 * SECOND
        else:  # LINEAR
            out = self.process_linear_frame(src)
            out_pts = pts
        return out, out_pts


_LOUDNORM_CAPS = Caps.from_string(
    "audio/x-raw, format=F64LE, rate=192000, channels=[1,64], "
    "layout=interleaved")

# the loudnorm_dev state entries held per stream as (C, 2) and stepped as
# (B*C, 2): the biquad states
_Z_KEYS = ("z_in1", "z_in2", "z_out1", "z_out2")


def _unbatched(st: dict) -> dict:
    """A batch-of-1 loudnorm_dev state as one stream's, for a context
    member: every tensor's row 0, the biquad states kept (C, 2), the
    host ints as they are."""
    return {k: v if k in HOST_INTS or k in _Z_KEYS else v[0]
            for k, v in st.items()}


def _rebatch(C: int, fn):
    """A loudnorm_dev step over the context's stacked states: the biquad
    states come stacked (B, C, 2) and the step takes them (B*C, 2)."""
    def wrapped(st, x, *unis):
        B = x.shape[0]
        st = {k: v.reshape(B * C, 2) if k in _Z_KEYS else v
              for k, v in st.items()}
        res = fn(st, x)
        st2 = {k: v.reshape(B, C, 2) if k in _Z_KEYS else v
               for k, v in res[0].items()}
        return (st2,) + tuple(res[1:])
    return wrapped


@register_element("audioloudnorm", Rank.NONE)
class AudioLoudNorm(Element):
    """EBU R 128 streaming loudness normalizer
    (reference audio/audiofx/src/audioloudnorm/imp.rs)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    _LOUDNORM_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    _LOUDNORM_CAPS.copy()),
    ]

    loudness_target = Property(float, default=-24.0, minimum=-70.0,
                               maximum=-5.0, mutable=Mutability.READY,
                               blurb="Loudness target in LUFS")
    loudness_range_target = Property(float, default=7.0, minimum=1.0,
                                     maximum=20.0, mutable=Mutability.READY)
    max_true_peak = Property(float, default=-2.0, minimum=-9.0, maximum=0.0,
                             mutable=Mutability.READY)
    offset = Property(float, default=0.0, minimum=-99.0, maximum=99.0,
                      mutable=Mutability.READY)
    context = Property(str, default=None, mutable=Mutability.READY,
                       blurb="DeviceContext name: run the device "
                             "loudnorm core (ops/loudnorm_dev) batched "
                             "with other members / fused with linked "
                             "chain members")
    context_block = Property(int, default=None, minimum=64,
                             mutable=Mutability.READY,
                             blurb="Batch block in flattened samples "
                                   "(default FRAME*channels)")
    device_gating_blocks = Property(
        int, default=4096, minimum=16, mutable=Mutability.READY,
        blurb="Device-core gated-loudness history capacity in 400 ms "
              "blocks (409.6 s default; the host path is unbounded)")

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.srcpad = self.static_pad("src")
        self.sinkpad.chain_function = self._sink_chain
        self.sinkpad.event_function = self._sink_event
        self.srcpad.query_function = self._src_query
        self._state: _LoudNormState | None = None
        self._ctx = None
        self._info: AudioInfo | None = None
        self._device = None

    def _settings(self) -> dict:
        return dict(loudness_target=self.loudness_target,
                    loudness_range_target=self.loudness_range_target,
                    max_true_peak=self.max_true_peak, offset=self.offset)

    # -- DeviceContext contract (runtime/device_batch.py) ---------------
    # The device core is gstpu_torch/ops/loudnorm_dev, the same math as
    # this element's host path (control-flow-exact vs the reference,
    # imp.rs:845-1437). In context mode the element is a chain stage:
    # 100 ms inner steps after a 3 s priming frame.
    def start(self) -> bool:
        self._device = default_device()
        if self.context:
            self._ctx = DeviceContext.acquire(self.context,
                                              self.context_block)
            self._ctx.add_member(self)
        return True

    def stop(self) -> bool:
        """Leave the context, where the element is a member, and drop
        the host state."""
        if self._ctx is not None:
            self._ctx.remove_member(self)
            self._ctx = None
        self._state = None
        return True

    def device_batch_spec(self) -> dict:
        C = self._info.channels
        params = LoudnormParams(
            channels=C,
            loudness_target=self.loudness_target,
            loudness_range_target=self.loudness_range_target,
            max_true_peak=self.max_true_peak,
            max_blocks=self.device_gating_blocks)
        first_step, inner_step = make_steps(params)
        final_core = make_final_step(params)
        offset_db, device = self.offset, self._device

        def init_nobatch():
            return _unbatched(init_state(params, 1, offset_db=offset_db,
                                         device=device))

        def final(st, x, n_flat: int):
            st2, out, out_valid = _rebatch(
                C, lambda s, y: final_core(s, y, n_flat // C))(st, x)
            return st2, out, out_valid * C     # back to flat

        def fuse_next(next_spec: dict) -> dict | None:
            """Chain fusion: a directly-downstream ebur128level that only
            needs momentary/short-term is THIS element's own output
            measurement; the gain machine already K-weights the output
            (loudnorm_dev `_meas_out`), so the meter rides the same
            biquads instead of running the reference's second full
            chain (audio/audiofx/src/ebur128level/imp.rs:296-455). The
            state layout is unchanged (with_meter reuses ring_out), so
            checkpoints do not depend on fusion."""
            nkey = next_spec.get("key")
            if not (isinstance(nkey, tuple)
                    and nkey[0] == "ebur128level"
                    and next_spec.get("meter_fusable")):
                return None
            if nkey[1].channels != params.channels:
                return None
            f_first, f_inner = make_steps(params, with_meter=True)
            return dict(
                key=("audioloudnorm+ebur128level", params, nkey),
                step=_rebatch(C, f_inner),
                prime=_rebatch(C, f_first),
                prime_blocks=30,
                final=final,
                init_state=init_nobatch,
                uniforms=lambda: (),
                compute_dtype=np.float64)

        return dict(
            key=("audioloudnorm", params),
            step=_rebatch(C, inner_step),
            prime=_rebatch(C, first_step),
            prime_blocks=30,
            final=final,
            init_state=init_nobatch,
            uniforms=lambda: (),
            fuse_next=fuse_next,
            compute_dtype=np.float64)

    def make_batch_buffer(self, flat, pts, dur) -> Buffer:
        if isinstance(flat, DeviceRow):
            return Buffer(flat, pts=pts, duration=dur)
        return Buffer(np.asarray(flat).reshape(-1, self._info.channels),
                      pts=pts, duration=dur)

    # -- dataflow ------------------------------------------------------
    def _sink_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._ctx is not None:
            # chain-head submission (standalone context member); when an
            # upstream element of the same context feeds this one, data
            # enters at THAT head and this pad carries only events
            info = self._info
            data = buf.data if _is_device(buf.data) \
                else info.view(buf).astype(np.float64).reshape(-1)
            self._ctx.submit(self, data, buf.pts,
                             info.rate * info.channels)
            return FlowReturn.OK
        st = self._state
        if st is None:
            return FlowReturn.NOT_NEGOTIATED
        outbufs = []
        if buf.has_flag(BufferFlags.DISCONT):
            drained = self._drain()
            if drained is not None:
                outbufs.append(drained)
            self._state = st = _LoudNormState(self._settings(), st.info)
        # a tensor payload is read to the host once, here
        st.adapter.push(st.info.view(buf).astype(np.float64), pts=buf.pts)
        outbufs.extend(self._drain_full_frames())
        for b in outbufs:
            ret = self.srcpad.push(b)
            if not ret.is_ok:
                return ret
        return FlowReturn.OK

    def _make_outbuf(self, out_flat: np.ndarray, pts) -> Buffer:
        st = self._state
        samples = out_flat.reshape(-1, st.channels)
        dur = samples.shape[0] * SECOND // st.info.rate
        return Buffer(samples, pts=pts, duration=dur)

    def _drain_full_frames(self) -> list[Buffer]:
        st = self._state
        out = []
        while st.adapter.available() >= st.current_samples_per_frame:
            frames, pts, _ = st.adapter.take_pts(st.current_samples_per_frame)
            out_flat, out_pts = st.process(frames.reshape(-1), pts)
            out.append(self._make_outbuf(out_flat, out_pts))
        return out

    def _drain(self) -> Buffer | None:
        st = self._state
        if st is None:
            return None
        avail = st.adapter.available()
        pts = st.adapter.pts
        src = (st.adapter.take(avail).reshape(-1) if avail
               else np.empty(0))
        if st.current_samples_per_frame == FRAME_SIZE:
            st.frame_type = FINAL
        elif src.size == 0:
            return None
        out_flat, out_pts = st.process(src, pts)
        return self._make_outbuf(out_flat, out_pts)

    # -- events --------------------------------------------------------
    def _sink_event(self, pad: Pad, ev: Event) -> bool:
        if self._ctx is not None:
            if isinstance(ev, CapsEvent):
                self._info = AudioInfo.from_caps(ev.caps)
                if self._info.rate != 192_000:
                    self.post_error("audioloudnorm requires 192 kHz")
                    return False
                want = FRAME_SIZE * self._info.channels
                if self._ctx.block != want:
                    raise ValueError(
                        f"audioloudnorm needs context-block={want} "
                        f"(100 ms of flattened samples), context "
                        f"{self._ctx.name!r} has {self._ctx.block}: "
                        f"set context-block={want} on every chain "
                        f"member")
                self._ctx.finalize_member(self)
            elif isinstance(ev, EosEvent):
                # drain this chain if we are its head (mid-chain
                # members were already drained when their head was)
                for b in self._ctx.flush_member(self):
                    self.srcpad.push(b)
            return self.srcpad.push_event(ev)
        if isinstance(ev, CapsEvent):
            info = AudioInfo.from_caps(ev.caps)
            outbuf = self._drain()
            self._state = _LoudNormState(self._settings(), info)
            if outbuf is not None:
                self.srcpad.push(outbuf)
            return self.srcpad.push_event(ev)
        if isinstance(ev, (EosEvent, SegmentEvent)):
            # reference drains + resets on Segment as well as EOS
            # (imp.rs:1620+ EventView::Eos | EventView::Segment)
            outbuf = self._drain()
            if outbuf is not None:
                self.srcpad.push(outbuf)
            if self._state is not None:
                self._state = _LoudNormState(self._settings(),
                                             self._state.info)
            return self.srcpad.push_event(ev)
        if isinstance(ev, FlushStopEvent):
            if self._state is not None:
                self._state = _LoudNormState(self._settings(),
                                             self._state.info)
            return self.srcpad.push_event(ev)
        return self.srcpad.push_event(ev)

    def _src_query(self, pad: Pad, q) -> bool:
        if isinstance(q, LatencyQuery):
            # 3 s gain lookahead (reference imp.rs:1676-1684)
            self.sinkpad.query(q)
            q.add(3 * SECOND, 3 * SECOND)
            return True
        return self.default_pad_query(pad, q)


# ---------------------------------------------------------------------------
# ebur128level
# ---------------------------------------------------------------------------

_LEVEL_CAPS = audio_caps(formats=("F64LE", "F32LE", "S32LE", "S16LE"))

ALL_MODES = ("momentary", "short-term", "global", "loudness-range",
             "sample-peak", "true-peak")


@register_element("ebur128level", Rank.NONE)
class EbuR128Level(BaseTransform):
    """Passthrough loudness meter posting `ebur128-level` bus messages
    (reference audio/audiofx/src/ebur128level/imp.rs:296-455)."""

    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    _LEVEL_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    _LEVEL_CAPS.copy()),
    ]

    mode = Property(str, default="all", mutable=Mutability.READY,
                    blurb="Comma-separated modes or 'all'")
    post_messages = Property(bool, default=True, mutable=Mutability.PLAYING)
    interval = Property(int, default=SECOND, minimum=1,
                        mutable=Mutability.READY,
                        blurb="Message interval (ns)")
    context = Property(str, default=None, mutable=Mutability.READY,
                       blurb="DeviceContext name: meter on device, "
                             "batched/fused with chain members "
                             "(modes momentary/short-term/global/"
                             "sample-peak)")
    context_block = Property(int, default=None, minimum=64,
                             mutable=Mutability.READY)
    device_gating_blocks = Property(int, default=4096, minimum=16,
                                    mutable=Mutability.READY)

    # modes the device meter stage supports (LRA percentile history and
    # 4x-oversampled true peak stay host-side)
    _DEVICE_MODES = frozenset(("momentary", "short-term", "global",
                               "sample-peak"))

    def __init__(self, name=None):
        super().__init__(name)
        self._meter: EbuR128 | None = None
        self._info: AudioInfo | None = None
        self._interval_frames = 0
        self._interval_remaining = 0
        self._num_frames = 0
        self._ctx = None
        self._device = None

    def _modes(self) -> tuple[str, ...]:
        if self.mode == "all":
            return ALL_MODES
        return tuple(m.strip() for m in self.mode.split(","))

    def start(self) -> bool:
        self._device = default_device()
        if self.context:
            bad = set(self._modes()) - self._DEVICE_MODES
            if bad:
                raise ValueError(
                    f"ebur128level context mode supports "
                    f"{sorted(self._DEVICE_MODES)}; unsupported: "
                    f"{sorted(bad)} (unset `context` for the host "
                    f"meter)")
            self._ctx = DeviceContext.acquire(self.context,
                                              self.context_block)
            self._ctx.add_member(self)
        return True

    def stop(self) -> bool:
        if self._ctx is not None:
            self._ctx.remove_member(self)
            self._ctx = None
        return True

    def set_caps(self, incaps: Caps, outcaps: Caps) -> bool:
        self._info = AudioInfo.from_caps(incaps)
        if self._ctx is not None:
            if self._info.rate != 192_000:
                self.post_error("ebur128level device metering runs at "
                                "192 kHz (the loudnorm-chain rate)")
                return False
            self._interval_frames = (self.interval * self._info.rate) \
                // SECOND
            self._interval_remaining = self._interval_frames
            self._num_frames = 0
            self._ctx.finalize_member(self)
            return True
        m = set()
        for mm in self._modes():
            m.add({"momentary": "M", "short-term": "S", "global": "I",
                   "loudness-range": "LRA", "sample-peak": "sample_peak",
                   "true-peak": "true_peak"}.get(mm, mm))
        self._meter = EbuR128(self._info.channels, self._info.rate,
                              frozenset(m))
        self._interval_frames = (self.interval * self._info.rate) // SECOND
        self._interval_remaining = self._interval_frames
        self._num_frames = 0
        return True

    # -- DeviceContext contract -----------------------------------------
    def device_batch_spec(self) -> dict:
        C = self._info.channels
        params = LoudnormParams(channels=C,
                                max_blocks=self.device_gating_blocks)
        meter = make_meter_step(params)
        device = self._device

        def init_nobatch():
            return _unbatched(init_meter_state(params, 1, device=device))

        # fusable into an upstream audioloudnorm stage iff the modes it
        # must post are covered by the gain machine's own output
        # measurement ring (momentary/short-term); global / sample-peak
        # need the standalone meter's gating-block and peak state
        fusable = set(self._modes()) <= {"momentary", "short-term"}
        return dict(key=("ebur128level", params), step=_rebatch(C, meter),
                    init_state=init_nobatch, uniforms=lambda: (),
                    wide_ok=True, meter_fusable=fusable,
                    compute_dtype=np.float64)

    def make_batch_buffer(self, flat, pts, dur) -> Buffer:
        if isinstance(flat, DeviceRow):
            return Buffer(flat, pts=pts, duration=dur)
        return Buffer(np.asarray(flat).reshape(-1, self._info.channels),
                      pts=pts, duration=dur)

    def consume_batch_aux(self, aux, lane: int, pts,
                          out_n: int | None = None) -> None:
        """Per-fire meter values from the device stage (an AuxView:
        every leaf reaches the host on the first read); post
        `ebur128-level` messages at interval boundaries (the interval is
        block-quantized in context mode)."""
        # frames covered by this fire, from the fire's actual output
        # size: a priming fire covers prime_blocks (30x) blocks
        if out_n is None:
            out_n = self._ctx.block
        block_frames = out_n // self._info.channels
        self._num_frames += block_frames
        self._interval_remaining -= block_frames
        if self._interval_remaining > 0:
            return
        self._interval_remaining = self._interval_frames
        if not self.post_messages:
            return
        modes = self._modes()
        fields = {"timestamp": pts}
        if "momentary" in modes:
            fields["momentary-loudness"] = float(aux["momentary"][lane])
        if "short-term" in modes:
            fields["shortterm-loudness"] = float(aux["shortterm"][lane])
        if "global" in modes:
            fields["global-loudness"] = float(aux["global_"][lane])
            fields["relative-threshold"] = float(
                aux["relative_threshold"][lane])
        if "sample-peak" in modes:
            fields["sample-peak"] = tuple(aux["speak"][lane].tolist())
        self.post_element_message("ebur128-level", **fields)

    def transform_ip_context(self, buf: Buffer):
        info = self._info
        data = buf.data if _is_device(buf.data) \
            else info.view(buf).astype(np.float64).reshape(-1)
        self._ctx.submit(self, data, buf.pts,
                         info.rate * info.channels)
        return []

    def drain(self) -> list[Buffer]:
        if self._ctx is not None:
            return self._ctx.flush_member(self)
        return []

    def _to_float(self, arr: np.ndarray) -> np.ndarray:
        if arr.dtype.kind == "f":
            return arr.astype(np.float64)
        scale = float(2 ** (8 * arr.dtype.itemsize - 1))
        return arr.astype(np.float64) / scale

    def transform_ip(self, buf: Buffer):
        if self._ctx is not None:
            return self.transform_ip_context(buf)
        info, meter = self._info, self._meter
        frames = self._to_float(info.view(buf))
        pts = buf.pts
        off = 0
        n = frames.shape[0]
        while off < n:
            take = min(self._interval_remaining, n - off)
            meter.add_frames(frames[off:off + take])
            self._interval_remaining -= take
            self._num_frames += take
            off += take
            if self._interval_remaining == 0:
                self._interval_remaining = self._interval_frames
                if self.post_messages:
                    ts = None if pts is None else \
                        pts + (off * SECOND) // info.rate
                    self._post_level_message(ts)

    def _post_level_message(self, timestamp) -> None:
        meter = self._meter
        fields = {"timestamp": timestamp}
        modes = self._modes()
        if "momentary" in modes:
            fields["momentary-loudness"] = meter.loudness_momentary()
        if "short-term" in modes:
            fields["shortterm-loudness"] = meter.loudness_shortterm()
        if "global" in modes:
            fields["global-loudness"] = meter.loudness_global()
            fields["relative-threshold"] = meter.relative_threshold()
        if "loudness-range" in modes:
            fields["loudness-range"] = meter.loudness_range()
        if "sample-peak" in modes:
            fields["sample-peak"] = tuple(
                meter.sample_peak(c) for c in range(self._info.channels))
        if "true-peak" in modes:
            fields["true-peak"] = tuple(
                meter.true_peak(c) for c in range(self._info.channels))
        self.post_element_message("ebur128-level", **fields)
