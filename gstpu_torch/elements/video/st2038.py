"""cctost2038anc / st2038anctocc: closed captions <-> SMPTE ST-2038.

Rebuilds the reference converters (video/closedcaption/src/
cctost2038anc/imp.rs, st2038anctocc/imp.rs): CDP (DID/SDID 0x61/0x01)
or s334-1a CEA-608 (0x61/0x02) caption buffers are wrapped into / out
of ST-2038 ancillary-data packets; unknown ANC services and 0xFF
stuffing are skipped.

The port's copy of gstpu/elements/video/st2038.py, as it stands:
`st2038combiner` attaches metas and hands the video payload, a tensor
included, on unread.
"""

from __future__ import annotations

from gstpu_torch.codecs.st2038 import build_anc, iter_anc
from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, Structure
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.event import CapsEvent
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

ST2038_CAPS = Caps.new("meta/x-st-2038")
CDP_CAPS = Caps.new("closedcaption/x-cea-708", format="cdp")
S334_CAPS = Caps.new("closedcaption/x-cea-608", format="s334-1a")
CC_CAPS = Caps(list(CDP_CAPS) + list(S334_CAPS))


@register_element("cctost2038anc", Rank.NONE)
class CcToSt2038Anc(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    CC_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    ST2038_CAPS.copy()),
    ]

    c_not_y_channel = Property(bool, default=False,
                               mutable=Mutability.READY)
    line_number = Property(int, default=9, minimum=0, maximum=2047,
                           mutable=Mutability.READY)
    horizontal_offset = Property(int, default=0, minimum=0,
                                 maximum=4095, mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._sdid = 0x01

    def transform_caps(self, direction, caps, filter):
        out = (ST2038_CAPS if direction is PadDirection.SINK
               else CC_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def set_caps(self, incaps, outcaps) -> bool:
        self._sdid = (0x01 if incaps[0].name == "closedcaption/x-cea-708"
                      else 0x02)
        return True

    def transform(self, buf: Buffer) -> Buffer:
        anc = build_anc(0x61, self._sdid, buf.to_bytes(),
                        c_not_y=self.c_not_y_channel,
                        line_number=self.line_number,
                        horizontal_offset=self.horizontal_offset)
        return Buffer(anc, pts=buf.pts, duration=buf.duration)


@register_element("st2038anctocc", Rank.NONE)
class St2038AncToCc(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    ST2038_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    CC_CAPS.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._out_caps_sent = False

    def transform_caps(self, direction, caps, filter):
        out = (CC_CAPS if direction is PadDirection.SINK
               else ST2038_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        out = []
        for hdr, payload in iter_anc(buf.to_bytes()):
            if hdr.did != 0x61 or hdr.sdid not in (0x01, 0x02):
                continue                     # imp.rs:91 service filter
            if not self._out_caps_sent:
                caps = CDP_CAPS if hdr.sdid == 0x01 else S334_CAPS
                self.srcpad.push_event(CapsEvent(caps.copy()))
                self._out_caps_sent = True
            out.append(Buffer(payload, pts=buf.pts,
                              duration=buf.duration))
        return out or None


class St2038Meta:
    """ANC packets attached to video buffers (gst AncillaryMeta
    analogue; reference st2038combiner/extractor move these)."""

    def __init__(self, data: bytes):
        self.data = data

    def copy(self):
        return St2038Meta(self.data)


@register_element("st2038combiner", Rank.NONE)
class St2038Combiner(BaseTransform):
    """Attaches a held ST-2038 stream's packets to passing video
    frames as St2038Meta (reference st2038combiner aggregates video +
    anc; here the anc stream arrives via push_anc()/a linked feeder
    onto the `anc` pad)."""

    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("anc", PadDirection.SINK, PadPresence.REQUEST,
                    ST2038_CAPS.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._pending: list[tuple[int, bytes]] = []

    def request_pad(self, name=None):
        from gstpu_torch.core.element import Pad
        pad = Pad("anc", PadDirection.SINK, self.PAD_TEMPLATES[2],
                  self)
        self.add_pad(pad)
        pad.chain_function = self._anc_chain
        pad.event_function = lambda p, e: True
        return pad

    def _anc_chain(self, pad, buf):
        from gstpu_torch.core.element import FlowReturn
        self._pending.append((buf.pts or 0, buf.to_bytes()))
        return FlowReturn.OK

    def transform_ip(self, buf: Buffer) -> None:
        end = (buf.pts or 0) + (buf.duration or 0)
        keep = []
        for pts, data in self._pending:
            if pts < end or end <= (buf.pts or 0):
                buf.add_meta(St2038Meta(data))
            else:
                keep.append((pts, data))
        self._pending = keep


@register_element("st2038extractor", Rank.NONE)
class St2038Extractor(BaseTransform):
    """Strips St2038Meta back onto a sometimes `anc` pad."""

    IN_PLACE = False
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("anc", PadDirection.SRC, PadPresence.SOMETIMES,
                    ST2038_CAPS.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._anc_pad = None

    def _ensure_pad(self):
        if self._anc_pad is not None:
            return self._anc_pad
        from gstpu_torch.core.element import Pad
        from gstpu_torch.core.event import (CapsEvent, Segment, SegmentEvent,
                                            StreamStartEvent)
        pad = Pad("anc", PadDirection.SRC, self.PAD_TEMPLATES[2],
                  self)
        self.add_pad(pad)
        pad.push_event(StreamStartEvent(f"{self.name}/anc"))
        pad.push_event(CapsEvent(Caps.new("meta/x-st-2038")))
        pad.push_event(SegmentEvent(Segment()))
        self._anc_pad = pad
        return pad

    def transform(self, buf: Buffer) -> Buffer:
        keep = []
        for m in buf.metas:
            if isinstance(m, St2038Meta):
                pad = self._ensure_pad()
                if pad.is_linked():
                    pad.push(Buffer(m.data, pts=buf.pts,
                                    duration=buf.duration))
            else:
                keep.append(m)
        out = buf.copy()
        out.metas = keep
        return out
