"""audiotestsrc / videotestsrc: deterministic synthetic sources.

The reference's test pipelines are built on these (C core elements;
threadshare re-implements ts-audiotestsrc,
generic/threadshare/src/audiotestsrc/). Determinism matters: exactness
tests compare our DSP output against golden vectors computed from the
same source samples.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from gstpu_torch.core.audio import AUDIO_FORMATS, AudioInfo, audio_caps, frames_to_ns
from gstpu_torch.core.base import PushSrc
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, Structure
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import ALL_VIDEO_FORMATS, VideoInfo, video_caps

WAVES = ("sine", "square", "saw", "triangle", "silence", "white-noise",
         "ticks")


@register_element("audiotestsrc", Rank.NONE)
class AudioTestSrc(PushSrc):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                                 audio_caps())]

    wave = Property(str, default="sine", enum_values=WAVES,
                    mutable=Mutability.PLAYING)
    freq = Property(float, default=440.0, minimum=0.0,
                    mutable=Mutability.PLAYING)
    volume = Property(float, default=0.8, minimum=0.0, maximum=1.0,
                      mutable=Mutability.PLAYING)
    num_buffers = Property(int, default=-1, minimum=-1)
    samplesperbuffer = Property(int, default=1024, minimum=1)
    seed = Property(int, default=0x12345678)
    is_live_p = Property(bool, default=False)
    tick_interval = Property(int, default=1_000_000_000, minimum=1,
                             blurb="Tick distance for wave=ticks (ns)")
    sine_periods_per_tick = Property(int, default=10, minimum=1)

    def __init__(self, name=None):
        super().__init__(name)
        self._info: AudioInfo | None = None
        self._sample_offset = 0
        self._buffers_sent = 0
        self._rng: np.random.Generator | None = None

    def fixate(self, caps: Caps) -> Caps:
        # prefer F32LE 48kHz stereo like the C element defaults
        def fix(s: Structure) -> Structure:
            near = Structure("audio/x-raw", format="F32LE", rate=48000,
                             channels=2, layout="interleaved")
            return s.fixate(near)
        if caps.is_any():
            caps = self.srcpad.pad_template_caps()
        return Caps([fix(caps[0])])

    def set_caps(self, caps: Caps) -> bool:
        self._info = AudioInfo.from_caps(caps)
        self._sample_offset = 0
        self._buffers_sent = 0
        self._rng = np.random.default_rng(self.seed)
        return True

    def _generate(self, n: int) -> np.ndarray:
        info = self._info
        t = (np.arange(self._sample_offset, self._sample_offset + n,
                       dtype=np.float64) / info.rate)
        w = self.wave
        if w == "sine":
            mono = np.sin(2 * np.pi * self.freq * t)
        elif w == "square":
            mono = np.sign(np.sin(2 * np.pi * self.freq * t))
        elif w == "saw":
            ph = (self.freq * t) % 1.0
            mono = 2.0 * ph - 1.0
        elif w == "triangle":
            ph = (self.freq * t) % 1.0
            mono = 4.0 * np.abs(ph - 0.5) - 1.0
        elif w == "silence":
            mono = np.zeros_like(t)
        elif w == "white-noise":
            mono = self._rng.uniform(-1.0, 1.0, size=n)
        elif w == "ticks":
            # sine bursts of sine-periods-per-tick periods every
            # tick-interval (C audiotestsrc semantics)
            mono = np.zeros_like(t)
            tick_period = max(1, (self.tick_interval * info.rate)
                              // 1_000_000_000)
            tick_len = max(1, int(round(self.sine_periods_per_tick
                                        * info.rate / self.freq)))
            pos = np.arange(self._sample_offset, self._sample_offset + n)
            idx = np.nonzero((pos % tick_period) < tick_len)[0]
            mono[idx] = np.sin(2 * np.pi * self.freq * t[idx])
        else:
            raise ValueError(f"unknown wave {w!r}")
        mono = (self.volume * mono)
        frames = np.repeat(mono[:, None], info.channels, axis=1)
        dt = info.dtype
        if dt.kind == "f":
            return frames.astype(dt)
        # integer formats: scale to full range (wire sample width, so
        # packed 24-bit scales to 2^23, not the i4 working dtype)
        scale = float(2 ** (8 * info.sample_size - 1) - 1)
        return np.clip(np.round(frames * scale),
                       -scale - 1, scale).astype(dt)

    def create(self) -> Buffer | None:
        if 0 <= self.num_buffers <= self._buffers_sent:
            return None
        info = self._info
        n = self.samplesperbuffer
        frames = self._generate(n)
        pts = frames_to_ns(self._sample_offset, info.rate)
        dur = frames_to_ns(self._sample_offset + n, info.rate) - pts
        if info.packed24:
            buf = info.make_buffer(frames, pts=pts, duration=dur)
        else:
            buf = Buffer(frames, pts=pts, duration=dur)
        buf.offset = self._sample_offset
        buf.offset_end = self._sample_offset + n
        self._sample_offset += n
        self._buffers_sent += 1
        return buf


PATTERNS = ("smpte", "snow", "black", "white", "red", "green", "blue",
            "checkers", "gradient", "ball")

_SMPTE_COLORS = np.array([
    [191, 191, 191], [191, 191, 0], [0, 191, 191], [0, 191, 0],
    [191, 0, 191], [191, 0, 0], [0, 0, 191],
], dtype=np.uint8)


@register_element("videotestsrc", Rank.NONE)
class VideoTestSrc(PushSrc):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                                 video_caps())]

    pattern = Property(str, default="smpte", enum_values=PATTERNS,
                       mutable=Mutability.PLAYING)
    num_buffers = Property(int, default=-1, minimum=-1)
    seed = Property(int, default=0xBADC0FFE)

    def __init__(self, name=None):
        super().__init__(name)
        self._info: VideoInfo | None = None
        self._frame_count = 0
        self._rng: np.random.Generator | None = None

    def fixate(self, caps: Caps) -> Caps:
        near = Structure("video/x-raw", format="RGBA", width=320, height=240,
                         framerate=Fraction(30, 1))
        if caps.is_any():
            caps = self.srcpad.pad_template_caps()
        return Caps([caps[0].fixate(near)])

    def set_caps(self, caps: Caps) -> bool:
        self._info = VideoInfo.from_caps(caps)
        self._frame_count = 0
        self._rng = np.random.default_rng(self.seed)
        return True

    def _rgb_frame(self) -> np.ndarray:
        info = self._info
        h, w = info.height, info.width
        p = self.pattern
        if p == "smpte":
            bars = np.repeat(_SMPTE_COLORS,
                             -(-w // len(_SMPTE_COLORS)), axis=0)[:w]
            rgb = np.broadcast_to(bars[None, :, :], (h, w, 3)).copy()
        elif p == "snow":
            rgb = self._rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        elif p == "black":
            rgb = np.zeros((h, w, 3), np.uint8)
        elif p == "white":
            rgb = np.full((h, w, 3), 255, np.uint8)
        elif p in ("red", "green", "blue"):
            rgb = np.zeros((h, w, 3), np.uint8)
            rgb[..., ("red", "green", "blue").index(p)] = 255
        elif p == "checkers":
            yy, xx = np.mgrid[0:h, 0:w]
            c = (((yy // 8) + (xx // 8)) % 2 * 255).astype(np.uint8)
            rgb = np.stack([c, c, c], axis=-1)
        elif p == "gradient":
            xx = np.linspace(0, 255, w, dtype=np.uint8)
            yy = np.linspace(0, 255, h, dtype=np.uint8)
            rgb = np.stack([np.broadcast_to(xx[None, :], (h, w)),
                            np.broadcast_to(yy[:, None], (h, w)),
                            np.full((h, w), (self._frame_count * 4) % 256,
                                    np.uint8)], axis=-1)
        elif p == "ball":
            t = self._frame_count / 30.0
            cy = int(h / 2 + (h / 3) * np.sin(2 * np.pi * t))
            cx = int(w / 2 + (w / 3) * np.cos(2 * np.pi * t))
            yy, xx = np.mgrid[0:h, 0:w]
            d = ((yy - cy) ** 2 + (xx - cx) ** 2) < (min(h, w) // 10) ** 2
            rgb = np.zeros((h, w, 3), np.uint8)
            rgb[d] = (255, 255, 255)
        else:
            raise ValueError(f"unknown pattern {p!r}")
        return rgb

    def _pack(self, rgb: np.ndarray) -> np.ndarray:
        fmt = self._info.format
        h, w = rgb.shape[:2]
        if fmt == "RGB":
            return rgb
        if fmt == "BGR":
            return rgb[..., ::-1]
        if fmt in ("RGBA", "RGBx"):
            a = np.full((h, w, 1), 255, np.uint8)
            return np.concatenate([rgb, a], axis=-1)
        if fmt in ("BGRA", "BGRx"):
            a = np.full((h, w, 1), 255, np.uint8)
            return np.concatenate([rgb[..., ::-1], a], axis=-1)
        if fmt in ("ARGB", "xRGB"):
            a = np.full((h, w, 1), 255, np.uint8)
            return np.concatenate([a, rgb], axis=-1)
        if fmt in ("ABGR", "xBGR"):
            a = np.full((h, w, 1), 255, np.uint8)
            return np.concatenate([a, rgb[..., ::-1]], axis=-1)
        if fmt == "GRAY8":
            y = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                 + 0.114 * rgb[..., 2])
            return y.astype(np.uint8)[..., None]
        if fmt == "I420":
            return _rgb_to_i420(rgb)
        raise ValueError(f"videotestsrc: unsupported format {fmt}")

    def create(self) -> Buffer | None:
        if 0 <= self.num_buffers <= self._frame_count:
            return None
        info = self._info
        frame = self._pack(self._rgb_frame())
        dur = info.frame_duration
        pts = self._frame_count * dur
        buf = Buffer(np.ascontiguousarray(frame).reshape(-1), pts=pts,
                     duration=dur)
        buf.offset = self._frame_count
        self._frame_count += 1
        return buf


def _rgb_to_i420(rgb: np.ndarray) -> np.ndarray:
    """BT.601 full-range RGB→I420 (matches videotestsrc-ish output
    closely enough for frame-exact tests against our own golden)."""
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    h, w = rgb.shape[:2]
    y8 = np.clip(np.round(y), 0, 255).astype(np.uint8)
    # 2x2 average subsample (pad odd dims)
    hp, wp = -(-h // 2) * 2, -(-w // 2) * 2
    up = np.zeros((hp, wp), np.float32)
    vp = np.zeros((hp, wp), np.float32)
    up[:h, :w], vp[:h, :w] = u, v
    if h < hp:
        up[h:], vp[h:] = up[h - 1:h], vp[h - 1:h]
    if w < wp:
        up[:, w:], vp[:, w:] = up[:, w - 1:w], vp[:, w - 1:w]
    u4 = up.reshape(hp // 2, 2, wp // 2, 2).mean(axis=(1, 3))
    v4 = vp.reshape(hp // 2, 2, wp // 2, 2).mean(axis=(1, 3))
    u8 = np.clip(np.round(u4), 0, 255).astype(np.uint8)
    v8 = np.clip(np.round(v4), 0, 255).astype(np.uint8)
    return np.concatenate([y8.reshape(-1), u8.reshape(-1), v8.reshape(-1)])
