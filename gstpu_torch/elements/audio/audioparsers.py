"""ac4parse / s302mparse: audio frame parsers
(reference audio/audioparsers: Dolby AC-4 sync framing and SMPTE 302M
PCM-in-AES3 header parsing + caps fixing).

The port's copy of gstpu/elements/audio/audioparsers.py, as it
stands."""

from __future__ import annotations

from gstpu_torch.core.adapter import ByteAdapter
from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.event import CapsEvent
from gstpu_torch.core.registry import Rank, register_element

AC4_SYNC_NO_CRC = 0xAC40
AC4_SYNC_WITH_CRC = 0xAC41
MIN_AC4_FRAME = 8


@register_element("ac4parse", Rank.PRIMARY)
class Ac4Parse(BaseTransform):
    """Finds AC-4 sync frames in a byte stream and emits one buffer
    per frame with framed caps."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("audio/x-ac4")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("audio/x-ac4", framed=True)),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._adapter = ByteAdapter()
        self._caps_sent = False

    def _negotiate(self, incaps):
        self.in_caps = incaps
        return True

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        self._adapter.push(buf.to_bytes())
        out = []
        while True:
            frame = self._pop_frame()
            if frame is None:
                break
            out.append(frame)
        return out or None

    def _pop_frame(self) -> Buffer | None:
        a = self._adapter
        # resync: scan for the syncword
        while a.available() >= 2:
            head = a.peek(2)
            sync = (head[0] << 8) | head[1]
            if sync in (AC4_SYNC_NO_CRC, AC4_SYNC_WITH_CRC):
                break
            a.flush(1)
        if a.available() < MIN_AC4_FRAME:
            return None
        head = a.peek(7)
        sync = (head[0] << 8) | head[1]
        crc = sync == AC4_SYNC_WITH_CRC
        frame_size = (head[2] << 8) | head[3]
        hdr = 4
        if frame_size == 0xFFFF:  # extended 24-bit size follows
            frame_size = (head[4] << 16) | (head[5] << 8) | head[6]
            hdr = 7
        total = hdr + frame_size + (2 if crc else 0)
        if a.available() < total:
            return None
        if not self._caps_sent:
            self.srcpad.push_event(CapsEvent(
                Caps.new("audio/x-ac4", framed=True)))
            self._caps_sent = True
        return Buffer(a.take(total))


@register_element("s302mparse", Rank.PRIMARY)
class S302mParse(BaseTransform):
    """Parses the SMPTE 302M AES3 header, fixing channel-count caps
    (reference s302mparse: 16-bit packet size, 2-bit channel count,
    2-bit bits-per-sample)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("audio/x-smpte-302m")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("audio/x-smpte-302m", parsed=True)),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._last_caps: Caps | None = None

    def _negotiate(self, incaps):
        self.in_caps = incaps
        return True

    def transform(self, buf: Buffer) -> Buffer | None:
        data = buf.to_bytes()
        if len(data) < 4:
            self.post_error("s302mparse: buffer smaller than AES3 header")
            raise FlowError(FlowReturn.ERROR)
        header = int.from_bytes(data[:4], "big")
        audio_packet_size = header >> 16
        channels = {0: 2, 1: 4, 2: 6, 3: 8}[(header >> 14) & 0b11]
        bits = {0: 16, 1: 20, 2: 24}.get((header >> 4) & 0b11)
        if bits is None:
            self.post_error("s302mparse: reserved bits-per-sample")
            raise FlowError(FlowReturn.ERROR)
        if len(data) - 4 < audio_packet_size:
            self.post_error("s302mparse: truncated AES3 packet")
            raise FlowError(FlowReturn.ERROR)
        caps = Caps.new("audio/x-smpte-302m", parsed=True,
                        channels=channels, rate=48000,
                        depth=bits)
        if caps != self._last_caps:
            self._last_caps = caps
            self.srcpad.push_event(CapsEvent(caps))
        return Buffer(data, pts=buf.pts, duration=buf.duration,
                      flags=buf.flags)
