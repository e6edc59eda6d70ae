"""cccombiner / ccextractor: move captions between a stream and
VideoCaptionMeta.

The reference transcriberbin (video/closedcaption/src/transcriberbin)
builds on GStreamer's cccombiner to attach transcriber-produced
CEA-608 onto video frames; this provides that combiner (video pad +
caption pad -> video with VideoCaptionMeta, captions matched to the
frame whose [pts, pts+duration) interval contains them) and the
inverse extractor.

The port's copy of gstpu/elements/video/cccombiner.py, as it stands:
metas only: the video payload, a tensor included, is handed on unread.
"""

from __future__ import annotations

from gstpu_torch.core.base import Aggregator, BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, Structure
from gstpu_torch.core.element import (FlowReturn, PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import VideoCaptionMeta, video_caps

CC_CAPS = Caps([
    Structure("closedcaption/x-cea-608",
              format=AnyList(("raw", "s334-1a"))),
    Structure("closedcaption/x-cea-708",
              format=AnyList(("cc_data", "cdp"))),
])

_CAPTION_TYPES = {
    ("closedcaption/x-cea-608", "raw"): "cea608-raw",
    ("closedcaption/x-cea-608", "s334-1a"): "cea608-s334-1a",
    ("closedcaption/x-cea-708", "cc_data"): "cea708-raw",
    ("closedcaption/x-cea-708", "cdp"): "cea708-cdp",
}


@register_element("cccombiner", Rank.NONE)
class CcCombiner(Aggregator):
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps()),
        PadTemplate("sink", PadDirection.SINK, PadPresence.REQUEST,
                    video_caps()),
        PadTemplate("caption_%u", PadDirection.SINK,
                    PadPresence.REQUEST, CC_CAPS.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._video_pad = None
        self._caption_pads: list = []
        self._pending_captions: list[tuple[int, str, bytes]] = []

    def request_pad(self, name=None):
        from gstpu_torch.core.base import AggregatorPad
        if name == "sink" or (name is None and self._video_pad is
                              None):
            tmpl, n = self.PAD_TEMPLATES[1], "sink"
        else:
            tmpl = self.PAD_TEMPLATES[2]
            i = 0
            n = name
            while n is None or n in self.pads:
                n = f"caption_{i}"
                i += 1
        pad = AggregatorPad(n, tmpl, self)
        self.add_pad(pad)
        self.new_request_pad(pad)
        return pad

    def new_request_pad(self, pad) -> None:
        if pad.name == "sink":
            self._video_pad = pad
        else:
            self._caption_pads.append(pad)

    def negotiate_src_caps(self) -> Caps | None:
        if self._video_pad is None or \
                self._video_pad.current_caps is None:
            return None
        return self._video_pad.current_caps.copy()

    def _caption_type(self, pad) -> str:
        s = pad.current_caps[0]
        return _CAPTION_TYPES[(s.name, s.get("format", "raw"))]

    def aggregate(self, timeout: bool) -> FlowReturn:
        if self._video_pad is None:
            return FlowReturn.OK
        # drain caption pads into the pending list
        for cp in self._caption_pads:
            while True:
                cb = cp.peek_buffer()
                if cb is None:
                    break
                cp.pop_buffer()
                self._pending_captions.append(
                    (cb.pts or 0, self._caption_type(cp),
                     cb.to_bytes()))
        buf = self._video_pad.peek_buffer()
        if buf is None:
            return FlowReturn.OK
        # wait until caption pads have advanced past this frame (or
        # reached EOS) so late captions can't be missed
        end = (buf.pts or 0) + (buf.duration or 0)
        for cp in self._caption_pads:
            if not cp.is_eos() and cp.peek_buffer() is None and \
                    not timeout:
                return FlowReturn.OK
        self._video_pad.pop_buffer()
        out = buf.copy()
        remaining = []
        for pts, ctype, data in self._pending_captions:
            if pts < end or end <= (buf.pts or 0):
                out.add_meta(VideoCaptionMeta(ctype, data))
            else:
                remaining.append((pts, ctype, data))
        self._pending_captions = remaining
        return self.srcpad.push(out)


@register_element("ccextractor", Rank.NONE)
class CcExtractor(BaseTransform):
    """Strips VideoCaptionMetas off video buffers and exposes the
    first caption stream on a sometimes pad (gst ccextractor
    analogue, used opposite cccombiner)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps()),
        PadTemplate("caption", PadDirection.SRC,
                    PadPresence.SOMETIMES, CC_CAPS.copy()),
    ]

    IN_PLACE = False

    def __init__(self, name=None):
        super().__init__(name)
        self._cc_pad = None

    def _ensure_cc_pad(self, ctype: str):
        if self._cc_pad is not None:
            return self._cc_pad
        from gstpu_torch.core.element import Pad
        from gstpu_torch.core.event import (CapsEvent, Segment, SegmentEvent,
                                            StreamStartEvent)
        pad = Pad("caption", PadDirection.SRC, self.PAD_TEMPLATES[2],
                  self)
        self.add_pad(pad)
        name, fmt = {
            "cea608-raw": ("closedcaption/x-cea-608", "raw"),
            "cea608-s334-1a": ("closedcaption/x-cea-608", "s334-1a"),
            "cea708-raw": ("closedcaption/x-cea-708", "cc_data"),
            "cea708-cdp": ("closedcaption/x-cea-708", "cdp"),
        }[ctype]
        pad.push_event(StreamStartEvent(f"{self.name}/caption"))
        pad.push_event(CapsEvent(Caps.new(name, format=fmt)))
        pad.push_event(SegmentEvent(Segment()))
        self._cc_pad = pad
        return pad

    def transform(self, buf: Buffer) -> Buffer:
        keep = []
        for m in buf.metas:
            if isinstance(m, VideoCaptionMeta):
                pad = self._ensure_cc_pad(m.caption_type)
                if pad.is_linked():
                    pad.push(Buffer(m.data, pts=buf.pts,
                                    duration=buf.duration))
            else:
                keep.append(m)
        out = buf.copy()
        out.metas = keep
        return out
