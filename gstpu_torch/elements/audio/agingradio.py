"""rsagingradio: "old radio" audio degradation effect.

Rebuilds the reference agingradio (audio/audiofx/src/agingradio/
imp.rs): white noise of configurable amplitude, random clicks,
lowpass filtering, bit quantization, cubic-curve distortion — as one
vectorized block transform (lowpass via the associative-scan biquad).

The port's copy of gstpu/elements/audio/agingradio.py, as it stands:
host numpy and scipy; a tensor payload (the echo's output on the card)
is read through `AudioInfo.view`, and a numpy array is written back.
"""

from __future__ import annotations

import numpy as np

from gstpu_torch.core.audio import AudioInfo, audio_caps
from gstpu_torch.core.base import AudioFilter
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.ops.biquad import biquad_reference


def _lowpass_coeffs(freq: float, rate: int):
    """2nd-order Butterworth-ish lowpass biquad (RBJ cookbook)."""
    w0 = 2 * np.pi * freq / rate
    q = 0.7071
    alpha = np.sin(w0) / (2 * q)
    cosw = np.cos(w0)
    b = np.array([(1 - cosw) / 2, 1 - cosw, (1 - cosw) / 2])
    a = np.array([1 + alpha, -2 * cosw, 1 - alpha])
    return b / a[0], a / a[0]


_CAPS = audio_caps(formats=("F32LE", "F64LE"))


@register_element("rsagingradio", Rank.NONE)
class AgingRadio(AudioFilter):
    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    _CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    _CAPS.copy()),
    ]

    white_noise_ampl = Property(float, default=0.011, minimum=0.0,
                                maximum=1.0, mutable=Mutability.PLAYING)
    clicks_prob = Property(float, default=1.0 / 100000.0, minimum=0.0,
                           maximum=1.0, mutable=Mutability.PLAYING)
    lowpass_freq = Property(int, default=2000, minimum=1,
                            mutable=Mutability.READY)
    bits_to_quantize = Property(float, default=4.0, minimum=1.0,
                                maximum=32.0, mutable=Mutability.PLAYING)
    cubic_curve_distortion = Property(float, default=1.0, minimum=0.0,
                                      mutable=Mutability.PLAYING)
    cubic_curve_passes = Property(int, default=3, minimum=0,
                                  mutable=Mutability.PLAYING)
    seed = Property(int, default=0xA61E, mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._zi = None
        self._coeffs = None
        self._rng = None

    def setup(self, info: AudioInfo) -> bool:
        self._coeffs = _lowpass_coeffs(
            min(self.lowpass_freq, info.rate // 2 - 1), info.rate)
        self._zi = np.zeros((info.channels, 2))
        self._rng = np.random.default_rng(self.seed)
        return True

    def transform_ip(self, buf: Buffer) -> None:
        info = self.audio_info
        x = info.view(buf).astype(np.float64)   # (n, ch)
        n, ch = x.shape
        # white noise + clicks
        x = x + self._rng.uniform(-1, 1, x.shape) * self.white_noise_ampl
        clicks = self._rng.random((n, 1)) < self.clicks_prob
        x = np.where(clicks, 0.9, x)
        # lowpass (streaming biquad, state carried across buffers)
        b, a = self._coeffs
        y, self._zi = biquad_reference(np.clip(x.T, -1, 1), b, a,
                                       self._zi)
        x = y.T
        # quantization noise
        levels = 2.0 ** self.bits_to_quantize
        x = np.round(x * levels) / levels
        # cubic curve distortion passes: soften towards cubic curve
        d = self.cubic_curve_distortion
        for _ in range(self.cubic_curve_passes):
            x = (1 - d) * x + d * (1.5 * x - 0.5 * x ** 3)
        buf.data = np.clip(x, -1, 1).astype(info.dtype)

    def flush(self) -> None:
        if self._zi is not None:
            self._zi[:] = 0
