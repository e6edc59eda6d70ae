"""Reference-exact element names + small fill-in elements.

The reference registers several elements under names this codebase
implemented with equivalents (rsidentity vs identity, ts-* threadshare
variants whose cooperative-scheduler behavior IS this runtime's
default, imagersdec vs imagedecoder...).  This module registers those
exact names as aliases so gst-launch lines written for the reference
work unchanged, and adds the remaining small utility elements
(rssinesrc, rsrgb2gray, rsprogressbin, ts-input-selector,
ts-clocksync, ts-rtpdtmfsrc, quinnroqmux/demux).

The port's copy of gstpu/elements/generic/aliases.py. The port's
`burn-yoloxinference` is registered by its analytics module itself.
"""

from __future__ import annotations

import numpy as np

from gstpu_torch.core.base import BaseTransform, PushSrc
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowReturn, Pad,
                                      PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.event import Event
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.registry import _registry as _REG
from gstpu_torch.core.video import video_caps


def _alias(new: str, existing: str) -> None:
    cls, rank = _REG[existing]
    if new not in _REG:
        # subclass so register_element's ELEMENT_NAME assignment does
        # not rename instances of the original factory
        sub = type(cls.__name__ + "Alias", (cls,), {})
        register_element(new, rank)(sub)


for _new, _old in (
        ("rsidentity", "identity"),
        ("rsfilesrc", "filesrc"), ("rsfilesink", "filesink"),
        ("udpsrc2", "udpsrc"),
        ("imagersdec", "imagedecoder"),
        ("imagersoverlay", "imageoverlay"),
        ("rtponvifmetadatapay", "onvifmetadatapay"),
        ("rtponvifmetadatadepay", "onvifmetadatadepay"),
        ("deflatecompress", "flatecompress"),
        ("deflatedecompress", "flatedecompress"),
        ("zlibcompress", "flatecompress"),
        ("zlibdecompress", "flatedecompress"),
        # threadshare names: the cooperative scheduler is this
        # runtime's default execution model (SURVEY §2.4)
        ("ts-queue", "queue"), ("ts-appsrc", "appsrc"),
        ("ts-audiotestsrc", "audiotestsrc"),
        ("ts-udpsrc", "udpsrc"), ("ts-udpsink", "udpsink"),
        ("ts-tcpclientsrc", "tcpclientsrc"),
        ("ts-intersink", "intersink"), ("ts-intersrc", "intersrc"),
        ("ts-proxysink", "intersink"), ("ts-proxysrc", "intersrc"),
        # reference factory-name variants of elements we register
        # under their family names
        ("agingradio", "rsagingradio"),
        ("rtpav1pay", "rtpav1pay2"),
        ("rtpav1depay", "rtpav1depay2"),
        ("rtpsmpte291pay", "rtpsmpte291pay2"),
        ("rtpsmpte291depay", "rtpsmpte291depay2"),
        ("llamacpp-texttransform", "llamatexttransform"),
):
    _alias(_new, _old)


@register_element("rssinesrc", Rank.NONE)
class RsSineSrc(PushSrc):
    """Pure sine source (reference tutorial rssinesrc)."""

    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS,
                                 Caps.new("audio/x-raw",
                                          format="F32LE",
                                          layout="interleaved"))]

    freq = Property(float, default=440.0, minimum=1.0,
                    mutable=Mutability.PLAYING)
    volume = Property(float, default=0.8, minimum=0.0, maximum=10.0,
                      mutable=Mutability.PLAYING)
    rate = Property(int, default=48000, minimum=1,
                    mutable=Mutability.READY)
    samples_per_buffer = Property(int, default=1024, minimum=1,
                                  mutable=Mutability.READY)
    num_buffers = Property(int, default=-1, minimum=-1,
                           mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._n = 0
        self._sent = 0

    def negotiate(self) -> Caps:
        return Caps.new("audio/x-raw", format="F32LE", rate=self.rate,
                        channels=1, layout="interleaved")

    def create(self) -> Buffer | None:
        if 0 <= self.num_buffers <= self._sent:
            return None
        spb = self.samples_per_buffer
        t = (np.arange(spb) + self._n) / self.rate
        samples = (self.volume
                   * np.sin(2 * np.pi * self.freq * t)
                   ).astype(np.float32)
        buf = Buffer(samples, pts=self._n * 10**9 // self.rate,
                     duration=spb * 10**9 // self.rate)
        self._n += spb
        self._sent += 1
        return buf


@register_element("rsrgb2gray", Rank.NONE)
class RsRgb2Gray(BaseTransform):
    """RGB -> GRAY8 via BT.709 luma (reference tutorial rsrgb2gray
    with its invert/shift properties)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("RGB", "RGBA"))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("GRAY8",))),
    ]

    invert = Property(bool, default=False, mutable=Mutability.PLAYING)
    shift = Property(int, default=0, minimum=0, maximum=255,
                     mutable=Mutability.PLAYING)

    def transform_caps(self, direction, caps, filter):
        if direction is PadDirection.SINK:
            out = []
            for s in caps:
                s2 = s.copy()
                s2["format"] = "GRAY8"
                out.append(s2)
            out = Caps(out)
        else:
            out = self.sinkpad.pad_template_caps().copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> Buffer:
        from gstpu_torch.core.video import VideoInfo
        info = VideoInfo.from_caps(self.in_caps)
        rgb = info.view(buf)[..., :3].astype(np.float32)
        gray = (rgb @ np.array([0.2126, 0.7152, 0.0722], np.float32))
        gray = np.clip(gray + self.shift, 0, 255).astype(np.uint8)
        if self.invert:
            gray = 255 - gray
        return Buffer(gray, pts=buf.pts, duration=buf.duration)


@register_element("rsprogressbin", Rank.NONE)
class RsProgressBin(BaseTransform):
    """Passthrough posting `progress` element messages as the stream
    position advances (reference tutorial progressbin)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.any()),
    ]
    IN_PLACE = True

    def __init__(self, name=None):
        super().__init__(name)
        self._last_s = -1

    def transform_ip(self, buf: Buffer) -> None:
        if buf.pts is None:
            return
        s = buf.pts // 10**9
        if s != self._last_s:
            self._last_s = s
            self.post_element_message("progress", position=buf.pts)


@register_element("ts-clocksync", Rank.NONE)
class TsClockSync(BaseTransform):
    requires_clock = True
    """Passthrough that (optionally) waits for running time before
    forwarding (reference generic/threadshare ts-clocksync)."""

    PAD_TEMPLATES = RsProgressBin.PAD_TEMPLATES
    IN_PLACE = True

    sync = Property(bool, default=True, mutable=Mutability.PLAYING)

    def transform_ip(self, buf: Buffer) -> None:
        if self.sync and buf.pts is not None and \
                self.clock is not None:
            target = self.base_time + buf.pts
            if self.clock.time() < target:
                self.clock.wait_until(target)


@register_element("ts-input-selector", Rank.NONE)
class TsInputSelector(Element):
    """N:1 stream selector (reference ts-input-selector): buffers
    from the active pad pass, others drop."""

    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("sink_%u", PadDirection.SINK,
                    PadPresence.REQUEST, Caps.any()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self.srcpad = self.static_pad("src")
        self.active_pad: str | None = None

    def new_request_pad(self, pad: Pad) -> None:
        if self.active_pad is None:
            self.active_pad = pad.name
        pad.chain_function = self._chain
        pad.event_function = self._event

    def set_active(self, name: str) -> None:
        if name not in self.pads:
            raise ValueError(f"no pad {name!r}")
        self.active_pad = name

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if pad.name != self.active_pad:
            return FlowReturn.OK
        return self.srcpad.push(buf)

    def _event(self, pad: Pad, ev: Event) -> bool:
        if pad.name != self.active_pad:
            return True
        return self.srcpad.push_event(ev)


_RTP_CAPS = Caps.new("application/x-rtp")


@register_element("quinnroqmux", Rank.NONE)
class QuinnRoqMux(BaseTransform):
    """RTP -> RoQ datagram framing (flow-id varint prefix; the QUIC
    transport itself is the env boundary — see gstpu/net/roq.py)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    _RTP_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("application/x-roq")),
    ]

    flow_id = Property(int, default=0, minimum=0,
                       mutable=Mutability.READY)

    def transform_caps(self, direction, caps, filter):
        out = (Caps.new("application/x-roq")
               if direction is PadDirection.SINK
               else _RTP_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> Buffer:
        from gstpu_torch.net.roq import mux_datagram
        return Buffer(mux_datagram(self.flow_id, buf.to_bytes()),
                      pts=buf.pts, duration=buf.duration)


@register_element("quinnroqdemux", Rank.NONE)
class QuinnRoqDemux(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("application/x-roq")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    _RTP_CAPS.copy()),
    ]

    def transform_caps(self, direction, caps, filter):
        out = (_RTP_CAPS if direction is PadDirection.SINK
               else Caps.new("application/x-roq")).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> Buffer:
        from gstpu_torch.net.roq import demux_datagram
        flow, pkt = demux_datagram(buf.to_bytes())
        out = Buffer(pkt, pts=buf.pts, duration=buf.duration)
        out.offset = flow
        return out


@register_element("ts-rtpdtmfsrc", Rank.NONE)
class TsRtpDtmfSrc(PushSrc):
    """RFC 4733 DTMF named-event RTP source (reference
    generic/threadshare ts-rtpdtmfsrc): each queued tone produces a
    run of event packets (E bit on the last, marker on the first)."""

    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS,
                                 Caps.new("application/x-rtp"))]

    tones = Property(str, default="", mutable=Mutability.READY,
                     blurb="DTMF digits to send, e.g. '1800#'")
    pt = Property(int, default=101, minimum=96, maximum=127,
                  mutable=Mutability.READY)
    ssrc = Property(int, default=0x0D7F, minimum=0,
                    mutable=Mutability.READY)
    tone_duration_ms = Property(int, default=200, minimum=40,
                                mutable=Mutability.READY)
    packet_ms = Property(int, default=40, minimum=10,
                         mutable=Mutability.READY)

    _EVENTS = {**{str(d): d for d in range(10)},
               "*": 10, "#": 11,
               **{c: 12 + i for i, c in enumerate("ABCD")}}

    def __init__(self, name=None):
        super().__init__(name)
        self._queue: list[tuple[int, int, bool, bool]] = []
        self._seq = 0
        self._built = False

    def negotiate(self) -> Caps:
        return Caps.new("application/x-rtp", media="audio",
                        payload=self.pt, **{"clock-rate": 8000,
                                            "encoding-name":
                                            "TELEPHONE-EVENT"})

    def _build(self) -> None:
        ts = 0
        per = max(self.tone_duration_ms // self.packet_ms, 1)
        for ch in self.tones:
            ev = self._EVENTS.get(ch.upper())
            if ev is None:
                continue
            for i in range(per):
                dur = (i + 1) * self.packet_ms * 8  # 8kHz units
                self._queue.append((ev, ts, i == 0, i == per - 1,
                                    dur))
            ts += self.tone_duration_ms * 8
        self._built = True

    def create(self) -> Buffer | None:
        from gstpu_torch.net.rtp.packet import RtpPacket
        if not self._built:
            self._build()
        if not self._queue:
            return None
        ev, ts, first, last, dur = self._queue.pop(0)
        payload = bytes([ev, (0x80 if last else 0) | 10,  # E | volume
                         dur >> 8 & 0xFF, dur & 0xFF])
        pkt = RtpPacket(payload_type=self.pt, seqnum=self._seq,
                        timestamp=ts, ssrc=self.ssrc,
                        payload=payload, marker=first)
        self._seq = (self._seq + 1) & 0xFFFF
        return Buffer(pkt.to_bytes(),
                      pts=ts * 10**9 // 8000,
                      duration=self.packet_ms * 10**6)
