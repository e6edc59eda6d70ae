"""audioconvert / audioresample / audiomixer: core audio plumbing.

The reference relies on GStreamer's C core for these (SURVEY.md §2.1 —
part of the capability surface our standalone framework must provide).
audioconvert: dtype + channel-count conversion; audioresample:
streaming polyphase-windowed-sinc rate conversion; audiomixer: N->1
additive mixing on an Aggregator.

The port's copy of gstpu/elements/audio/convert.py: numpy on the host,
as there; a tensor payload is read through `Buffer.array` (downloaded).
"""

from __future__ import annotations

import numpy as np

from gstpu_torch.core.adapter import SampleAdapter
from gstpu_torch.core.audio import (ALL_AUDIO_FORMATS, AUDIO_FORMATS,
                                    AudioInfo, audio_caps, unpack_s24)
from gstpu_torch.core.base import Aggregator, AggregatorPad, BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, IntRange, Structure
from gstpu_torch.core.element import (FlowReturn, PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000


def _to_float(arr: np.ndarray, fmt: str) -> np.ndarray:
    if fmt in ("S24BE", "S24LE"):
        return unpack_s24(arr.tobytes(), fmt).astype(np.float64) \
            / float(1 << 23)
    dt = AUDIO_FORMATS[fmt]
    x = arr.view(dt).astype(np.float64)
    if dt.kind == "f":
        return x
    scale = float(2 ** (8 * dt.itemsize - 1))
    if fmt == "U8":
        return (x - 128.0) / 128.0
    return x / scale


def _from_float(x: np.ndarray, fmt: str) -> np.ndarray:
    if fmt in ("S24BE", "S24LE"):
        # logical int32 samples; AudioInfo.make_buffer packs to 3B
        scale = float(1 << 23)
        return np.clip(np.round(x * scale), -scale, scale - 1) \
            .astype(np.int32)
    dt = AUDIO_FORMATS[fmt]
    if dt.kind == "f":
        return x.astype(dt)
    if fmt == "U8":
        return np.clip(np.round(x * 128.0 + 128.0), 0, 255).astype(dt)
    scale = float(2 ** (8 * dt.itemsize - 1))
    return np.clip(np.round(x * scale), -scale, scale - 1).astype(dt)


@register_element("audioconvert", Rank.PRIMARY)
class AudioConvert(BaseTransform):
    """Format + channel conversion (mono<->stereo downmix/upmix)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    audio_caps()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    audio_caps()),
    ]

    def transform_caps(self, direction, caps, filter):
        def repl(s: Structure):
            if s.name != "audio/x-raw":
                return None
            s["format"] = AnyList(ALL_AUDIO_FORMATS)
            s["channels"] = IntRange(1, 64)
            return s
        out = caps.map_structures(repl)
        if filter is not None:
            out = filter.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        near = caps[0] if len(caps) else None
        return Caps([othercaps[0].fixate(near)])

    def transform(self, buf: Buffer) -> Buffer:
        in_info = AudioInfo.from_caps(self.in_caps)
        out_info = AudioInfo.from_caps(self.out_caps)
        x = _to_float(buf.array.reshape(-1), in_info.format) \
            .reshape(-1, in_info.channels)
        ci, co = in_info.channels, out_info.channels
        if ci != co:
            if co == 1:
                x = x.mean(axis=1, keepdims=True)
            elif ci == 1:
                x = np.repeat(x, co, axis=1)
            elif co < ci:
                x = x[:, :co]
            else:
                x = np.concatenate(
                    [x, np.zeros((x.shape[0], co - ci))], axis=1)
        return out_info.make_buffer(_from_float(x, out_info.format),
                                    pts=buf.pts)


@register_element("audioresample", Rank.PRIMARY)
class AudioResample(BaseTransform):
    """Streaming rate converter: windowed-sinc polyphase with carried
    history (no block-boundary glitches)."""

    TAPS_PER_PHASE = 16

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    audio_caps(formats=("F64LE", "F32LE", "S16LE"))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    audio_caps(formats=("F64LE", "F32LE", "S16LE"))),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._hist: np.ndarray | None = None
        self._t_next = 0.0      # next output time in input-sample units
        self._in_count = 0
        self._out_count = 0

    def transform_caps(self, direction, caps, filter):
        def repl(s: Structure):
            if s.name != "audio/x-raw":
                return None
            s["rate"] = IntRange(1, 2**31 - 1)
            return s
        out = caps.map_structures(repl)
        if filter is not None:
            out = filter.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        near = caps[0] if len(caps) else None
        return Caps([othercaps[0].fixate(near)])

    def set_caps(self, incaps, outcaps) -> bool:
        self._in_info = AudioInfo.from_caps(incaps)
        self._out_info = AudioInfo.from_caps(outcaps)
        half = self.TAPS_PER_PHASE // 2
        self._hist = np.zeros((2 * half, self._in_info.channels))
        self._t_next = 0.0
        self._in_count = 0
        self._out_count = 0
        return True

    def transform(self, buf: Buffer) -> Buffer | None:
        in_info, out_info = self._in_info, self._out_info
        x = _to_float(buf.array.reshape(-1), in_info.format) \
            .reshape(-1, in_info.channels)
        if in_info.rate == out_info.rate:
            return out_info.make_buffer(
                _from_float(x, out_info.format), pts=buf.pts)
        half = self.TAPS_PER_PHASE // 2
        full = np.concatenate([self._hist, x])
        ratio = in_info.rate / out_info.rate
        # output times (in input-sample units, absolute)
        start = self._in_count - half  # center of oldest usable sample
        n_in_total = self._in_count + x.shape[0]
        outs = []
        t = self._t_next
        cutoff = min(1.0, 1.0 / ratio)
        while t <= n_in_total - half - 1:
            # window of 2*half samples centered near t
            base = int(np.floor(t)) - half + 1
            idx0 = base - (self._in_count - self._hist.shape[0])
            win = full[idx0: idx0 + 2 * half]
            k = np.arange(base, base + 2 * half)
            h = np.sinc((k - t) * cutoff) * np.hanning(2 * half)
            h /= max(h.sum(), 1e-9)  # unity DC gain
            outs.append((win * h[:, None]).sum(axis=0))
            t += ratio
        self._t_next = t
        self._in_count = n_in_total
        keep = 2 * half
        self._hist = full[-keep:]
        if not outs:
            return None
        y = np.stack(outs)
        pts = self._out_count * SECOND // out_info.rate
        self._out_count += y.shape[0]
        return out_info.make_buffer(_from_float(y, out_info.format),
                                    pts=pts)


@register_element("audiomixer", Rank.PRIMARY)
class AudioMixer(Aggregator):
    """N->1 additive mixer (the reference test pipelines use the C
    audiomixer; same role here). All inputs must share caps; mixes
    aligned fixed-size output blocks."""

    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    audio_caps()),
        PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST,
                    audio_caps()),
    ]

    output_buffer_duration = Property(int, default=10_000_000, minimum=1,
                                      mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._info: AudioInfo | None = None
        self._adapters: dict[str, SampleAdapter] = {}
        self._out_frames = 0

    def negotiate_src_caps(self) -> Caps | None:
        for p in self.agg_sink_pads():
            if p.current_caps is not None:
                self._info = AudioInfo.from_caps(p.current_caps)
                return p.current_caps
        return None

    def _block_frames(self) -> int:
        return max(1, (self.output_buffer_duration * self._info.rate)
                   // SECOND)

    def aggregate(self, timeout: bool) -> FlowReturn:
        if self._info is None:
            self.negotiate_src_caps()
            if self._info is None:
                return FlowReturn.OK
        for p in self.agg_sink_pads():
            ad = self._adapters.setdefault(
                p.name, SampleAdapter(self._info.rate))
            while True:
                buf = p.pop_buffer()
                if buf is None:
                    break
                ad.push(self._info.view(buf).copy())
        n = self._block_frames()
        ret = FlowReturn.OK
        while all(ad.available() >= n or p.pad_eos
                  for p, ad in ((p, self._adapters[p.name])
                                for p in self.agg_sink_pads())) \
                and any(ad.available() >= n
                        for ad in self._adapters.values()):
            mixed = np.zeros((n, self._info.channels), np.float64)
            for ad in self._adapters.values():
                take = min(n, ad.available())
                if take:
                    chunk = ad.take(take).astype(np.float64)
                    mixed[:take] += chunk
            pts = self._out_frames * SECOND // self._info.rate
            self._out_frames += n
            out = self._info.make_buffer(
                mixed.astype(self._info.dtype), pts=pts)
            ret = self.srcpad.push(out)
            if not ret.is_ok:
                return ret
        return ret

    def drain(self) -> None:
        if self._info is None:
            return
        self.aggregate(timeout=False)
        remaining = max((ad.available()
                         for ad in self._adapters.values()), default=0)
        if remaining:
            mixed = np.zeros((remaining, self._info.channels), np.float64)
            for ad in self._adapters.values():
                take = ad.available()
                if take:
                    mixed[:take] += ad.take(take).astype(np.float64)
            pts = self._out_frames * SECOND // self._info.rate
            self._out_frames += remaining
            self.srcpad.push(self._info.make_buffer(
                mixed.astype(self._info.dtype), pts=pts))
