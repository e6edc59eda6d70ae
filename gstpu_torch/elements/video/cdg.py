"""cdgparse / cdgdec: CD+G karaoke graphics elements
(reference video/cdg).

The port's copy of gstpu/elements/video/cdg.py, as it stands."""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from gstpu_torch.codecs.cdg import (HEIGHT, PACKET_SIZE, PACKETS_PER_SECOND,
                                    WIDTH, CdgDecoder)
from gstpu_torch.core.adapter import ByteAdapter
from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (PadDirection, PadPresence, PadTemplate)
from gstpu_torch.core.event import CapsEvent
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import VideoInfo

SECOND = 1_000_000_000
CDG_CAPS = Caps.new("video/x-cdg")


@register_element("cdgparse", Rank.PRIMARY)
class CdgParse(BaseTransform):
    """Splits a raw CD+G stream into timestamped 24-byte packets."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    CDG_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("video/x-cdg", parsed=True)),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._adapter = ByteAdapter()
        self._n = 0
        self._caps_sent = False

    def _negotiate(self, incaps):
        self.in_caps = incaps
        return True

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        self._adapter.push(buf.to_bytes())
        out = []
        while self._adapter.available() >= PACKET_SIZE:
            if not self._caps_sent:
                self.srcpad.push_event(CapsEvent(
                    Caps.new("video/x-cdg", parsed=True)))
                self._caps_sent = True
            pts = self._n * SECOND // PACKETS_PER_SECOND
            out.append(Buffer(self._adapter.take(PACKET_SIZE), pts=pts,
                              duration=SECOND // PACKETS_PER_SECOND))
            self._n += 1
        return out or None


@register_element("cdgdec", Rank.PRIMARY)
class CdgDec(BaseTransform):
    """Decodes CD+G packets into RGB video frames (one frame whenever
    the screen content changes)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps([CDG_CAPS[0].copy()])),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("video/x-raw", format="RGB", width=WIDTH,
                             height=HEIGHT)),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._dec = CdgDecoder()
        self._info = VideoInfo("RGB", WIDTH, HEIGHT,
                               Fraction(PACKETS_PER_SECOND, 1))
        self._caps_sent = False

    def _negotiate(self, incaps):
        self.in_caps = incaps
        return True

    def transform(self, buf: Buffer) -> Buffer | None:
        changed = self._dec.push_packet(buf.to_bytes())
        if not changed:
            return None
        if not self._caps_sent:
            self.srcpad.push_event(CapsEvent(self._info.to_caps()))
            self._caps_sent = True
        frame = self._dec.render_rgb()
        return self._info.make_buffer(frame.reshape(-1), pts=buf.pts)

    def flush(self) -> None:
        self._dec = CdgDecoder()
