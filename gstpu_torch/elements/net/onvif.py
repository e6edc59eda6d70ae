"""onvifmetadatapay / onvifmetadatadepay: ONVIF XML metadata over RTP
(reference net/onvif: VND.ONVIF.METADATA payload; XML documents may
span packets, the RTP marker closes a document).

The port's copy of gstpu/elements/net/onvif.py, as it stands.
"""

from __future__ import annotations

from gstpu_torch.core.base import Aggregator, BaseTransform, VideoFilter
from gstpu_torch.core.buffer import Buffer, Meta
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import video_caps
from gstpu_torch.net.rtp.basepay import RtpBaseDepay2, RtpBasePay2, rtp_caps
from gstpu_torch.net.rtp.packet import RtpPacket


class OnvifXMLFrameMeta(Meta):
    """Marks buffers carrying one complete ONVIF XML document
    (reference net/onvif/src/lib.rs:129)."""

    def __init__(self, complete: bool = True):
        self.complete = complete


ONVIF_META_CAPS = Caps.new("application/x-onvif-metadata",
                           encoding="utf8")


def _tmpl(name, d, caps):
    return PadTemplate(name, d, PadPresence.ALWAYS, caps)


@register_element("onvifmetadatapay", Rank.PRIMARY)
class OnvifMetadataPay(RtpBasePay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, ONVIF_META_CAPS.copy()),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("VND.ONVIF.METADATA", clock_rate=90000,
                       media="application")),
    ]


@register_element("onvifmetadatadepay", Rank.PRIMARY)
class OnvifMetadataDepay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              rtp_caps("VND.ONVIF.METADATA", clock_rate=90000,
                       media="application")),
        _tmpl("src", PadDirection.SRC, ONVIF_META_CAPS.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._frags: list[bytes] = []
        self._doc_pts = None

    def depay_src_caps(self, incaps):
        return ONVIF_META_CAPS.copy()

    def handle_packet(self, pkt: RtpPacket, buf: Buffer) -> None:
        if not self._frags:
            self._doc_pts = self.pts_for(pkt)
        self._frags.append(pkt.payload)
        if pkt.marker:
            doc = b"".join(self._frags)
            self._frags = []
            self.queue_buffer(doc, pts=self._doc_pts)
            self._pending[-1].add_meta(OnvifXMLFrameMeta(True))


ONVIF_SCHEMA = "http://www.onvif.org/ver10/schema"


def _parse_utc(ts: str) -> int:
    """RFC 3339 -> ns since epoch."""
    from datetime import datetime
    dt = datetime.fromisoformat(ts.replace("Z", "+00:00"))
    return int(dt.timestamp() * 1_000_000_000)


def iterate_video_analytics_frames(xml_bytes: bytes):
    """(utc_ns, frame_element) for every tt:Frame under
    tt:VideoAnalytics (reference net/onvif/src/lib.rs:72)."""
    import xml.etree.ElementTree as ET
    root = ET.fromstring(xml_bytes)
    va = root.find(f"{{{ONVIF_SCHEMA}}}VideoAnalytics")
    if va is None:
        return
    for el in va:
        if el.tag != f"{{{ONVIF_SCHEMA}}}Frame":
            continue
        ts = el.get("UtcTime")
        if ts is None:
            raise ValueError("Frame element has no UtcTime attribute")
        yield _parse_utc(ts), el


@register_element("onvifmetadataparse", Rank.PRIMARY)
class OnvifMetadataParse(BaseTransform):
    """Retimes ONVIF metadata by the Frame UtcTime attributes
    (reference net/onvif/src/onvifmetadataparse/imp.rs): the first
    frame pins a UTC<->pts mapping; frames queue by UTC tick and are
    emitted, one tt:MetadataStream document per tick, once newer data
    has arrived past the max-lateness window (or at EOS)."""

    max_lateness = Property(int, default=200_000_000, minimum=0,
                            mutable=Mutability.READY,
                            blurb="Queue window in ns (imp.rs:72)")

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, ONVIF_META_CAPS.copy()),
        _tmpl("src", PadDirection.SRC,
              Caps.new("application/x-onvif-metadata",
                       parsed=True, encoding="utf8")),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._mapping: tuple[int, int] | None = None   # (utc0, pts0)
        self._queued: dict[int, list] = {}

    def transform_caps(self, direction, caps, filter):
        out = (self.srcpad if direction is PadDirection.SINK
               else self.sinkpad).pad_template_caps().copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def _utc_to_pts(self, utc: int) -> int:
        utc0, pts0 = self._mapping
        return max(0, pts0 + utc - utc0)

    def _emit(self, utc: int) -> Buffer:
        import xml.etree.ElementTree as ET
        ET.register_namespace("tt", ONVIF_SCHEMA)
        root = ET.Element(f"{{{ONVIF_SCHEMA}}}MetadataStream")
        va = ET.SubElement(root, f"{{{ONVIF_SCHEMA}}}VideoAnalytics")
        va.extend(self._queued.pop(utc))
        return Buffer(ET.tostring(root), pts=self._utc_to_pts(utc))

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        try:
            frames = list(iterate_video_analytics_frames(buf.to_bytes()))
        except Exception as e:
            self.post_error(f"onvifmetadataparse: bad XML: {e}")
            from gstpu_torch.core.element import FlowError, FlowReturn
            raise FlowError(FlowReturn.ERROR)
        for utc, el in frames:
            if self._mapping is None:
                self._mapping = (utc, buf.pts or 0)
            self._queued.setdefault(utc, []).append(el)
        if not self._queued:
            return None
        newest = max(self._queued)
        ready = sorted(u for u in self._queued
                       if newest - u > self.max_lateness)
        return [self._emit(u) for u in ready] or None

    def drain(self) -> list[Buffer]:
        return [self._emit(u) for u in sorted(self._queued)]


class OnvifMetadataFrameMeta(Meta):
    """A complete ONVIF XML document attached to a media buffer
    (reference onvifmetadatacombiner attaches the meta buffers)."""

    def __init__(self, data: bytes, pts: int | None = None):
        self.data = data
        self.pts = pts

    def copy(self):
        return OnvifMetadataFrameMeta(self.data, self.pts)


@register_element("onvifmetadatacombiner", Rank.NONE)
class OnvifMetadataCombiner(Aggregator):
    """Pairs a media stream with parsed ONVIF metadata documents:
    every metadata buffer whose pts falls within a media buffer's
    interval is attached as OnvifMetadataFrameMeta (reference
    net/onvif/src/onvifmetadatacombiner/imp.rs)."""

    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("media", PadDirection.SINK, PadPresence.REQUEST,
                    Caps.any()),
        PadTemplate("meta", PadDirection.SINK, PadPresence.REQUEST,
                    Caps.new("application/x-onvif-metadata")),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._media_pad = None
        self._meta_pad = None
        self._pending: list[tuple[int, bytes]] = []

    def request_pad(self, name=None):
        from gstpu_torch.core.base import AggregatorPad
        if name == "meta" or (name is None and
                              self._media_pad is not None):
            tmpl, n = self.PAD_TEMPLATES[2], "meta"
        else:
            tmpl, n = self.PAD_TEMPLATES[1], "media"
        pad = AggregatorPad(n, tmpl, self)
        self.add_pad(pad)
        if n == "media":
            self._media_pad = pad
        else:
            self._meta_pad = pad
        return pad

    def negotiate_src_caps(self):
        if self._media_pad is None or \
                self._media_pad.current_caps is None:
            return None
        return self._media_pad.current_caps.copy()

    def aggregate(self, timeout: bool) -> FlowReturn:
        from gstpu_torch.core.element import FlowReturn
        if self._media_pad is None:
            return FlowReturn.OK
        if self._meta_pad is not None:
            while True:
                mb = self._meta_pad.pop_buffer()
                if mb is None:
                    break
                self._pending.append((mb.pts or 0, mb.to_bytes()))
        buf = self._media_pad.peek_buffer()
        if buf is None:
            return FlowReturn.OK
        if self._meta_pad is not None and not self._meta_pad.is_eos() \
                and self._meta_pad.peek_buffer() is None and \
                not timeout:
            return FlowReturn.OK
        self._media_pad.pop_buffer()
        end = (buf.pts or 0) + (buf.duration or 0)
        out = buf.copy()
        remaining = []
        for pts, data in self._pending:
            if pts < end or end <= (buf.pts or 0):
                out.add_meta(OnvifMetadataFrameMeta(data, pts))
            else:
                remaining.append((pts, data))
        self._pending = remaining
        return self.srcpad.push(out)


@register_element("onvifmetadataoverlay", Rank.NONE)
class OnvifMetadataOverlay(VideoFilter):
    """Draws Object bounding boxes from attached ONVIF metadata onto
    frames (reference net/onvif/src/onvifmetadataoverlay/imp.rs:684:
    boxes are normalized [-1, 1], x_pix = (1 + left) * W/2, y flipped).
    """

    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGB"))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGB"))),
    ]

    def _boxes(self, xml_bytes: bytes):
        import xml.etree.ElementTree as ET
        root = ET.fromstring(xml_bytes)
        for bbox in root.iter(f"{{{ONVIF_SCHEMA}}}BoundingBox"):
            try:
                yield (float(bbox.get("left")),
                       float(bbox.get("top")),
                       float(bbox.get("right")),
                       float(bbox.get("bottom")))
            except (TypeError, ValueError):
                continue

    def transform_ip(self, buf) -> None:
        import numpy as np
        metas = [m for m in buf.metas
                 if isinstance(m, OnvifMetadataFrameMeta)]
        if not metas:
            return
        info = self.video_info
        frame = info.view(buf).copy()
        W, H = info.width, info.height
        for m in metas:
            for left, top, right, bottom in self._boxes(m.data):
                x1 = int((1.0 + left) * W / 2)
                x2 = int((1.0 + right) * W / 2)
                y1 = int((1.0 - top) * H / 2)
                y2 = int((1.0 - bottom) * H / 2)
                x1, x2 = sorted((max(0, min(W - 1, x1)),
                                 max(0, min(W - 1, x2))))
                y1, y2 = sorted((max(0, min(H - 1, y1)),
                                 max(0, min(H - 1, y2))))
                color = (255, 255, 0)
                for t in range(2):          # 2px outline
                    frame[y1 + t, x1:x2 + 1, :3] = color
                    frame[max(y2 - t, 0), x1:x2 + 1, :3] = color
                    frame[y1:y2 + 1, x1 + t, :3] = color
                    frame[y1:y2 + 1, max(x2 - t, 0), :3] = color
        buf.data = frame


@register_element("onvifmetadataextractor", Rank.NONE)
class OnvifMetadataExtractor(BaseTransform):
    """Inverse of the combiner: strips OnvifMetadataFrameMeta back
    onto a sometimes `meta` pad (reference onvifmetadataextractor)."""

    IN_PLACE = False
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("meta", PadDirection.SRC, PadPresence.SOMETIMES,
                    ONVIF_META_CAPS.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._meta_pad = None

    def _ensure_meta_pad(self):
        if self._meta_pad is not None:
            return self._meta_pad
        from gstpu_torch.core.element import Pad, PadDirection
        from gstpu_torch.core.event import (CapsEvent, Segment, SegmentEvent,
                                            StreamStartEvent)
        pad = Pad("meta", PadDirection.SRC, self.PAD_TEMPLATES[2],
                  self)
        self.add_pad(pad)
        pad.push_event(StreamStartEvent(f"{self.name}/meta"))
        pad.push_event(CapsEvent(ONVIF_META_CAPS.copy()))
        pad.push_event(SegmentEvent(Segment()))
        self._meta_pad = pad
        return pad

    def transform(self, buf):
        keep = []
        for m in buf.metas:
            if isinstance(m, OnvifMetadataFrameMeta):
                pad = self._ensure_meta_pad()
                if pad.is_linked():
                    pad.push(Buffer(m.data, pts=m.pts
                                    if m.pts is not None else buf.pts))
            else:
                keep.append(m)
        out = buf.copy()
        out.metas = keep
        return out
