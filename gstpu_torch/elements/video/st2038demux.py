"""st2038ancdemux / st2038ancmux: split/merge ST-2038 ANC streams.

Rebuilds the reference pair (video/closedcaption/src/st2038ancdemux/
imp.rs, st2038ancmux/imp.rs): the demux keeps an always `src` pad with
the combined stream (re-aligned to one packet per buffer) and adds a
sometimes pad `anc_%02x_%02x_at_%u_%u` per (DID, SDID, line,
horizontal offset) seen; the mux aggregates several ANC streams back
into one, ordered by timestamp.

The port's copy of gstpu/elements/video/st2038demux.py, as it stands.
"""

from __future__ import annotations

from gstpu_torch.codecs.st2038 import iter_anc
from gstpu_torch.core.base import Aggregator
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, Structure
from gstpu_torch.core.element import (Element, FlowReturn, Pad, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.event import (CapsEvent, EosEvent, Event, Segment,
                                    SegmentEvent, StreamStartEvent)
from gstpu_torch.core.registry import Rank, register_element

ST2038_ANY = Caps([Structure("meta/x-st-2038")])
ST2038_ALIGNED = Caps.new("meta/x-st-2038", alignment="packet")


@register_element("st2038ancdemux", Rank.NONE)
class St2038AncDemux(Element):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    ST2038_ANY.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    ST2038_ALIGNED.copy()),
        PadTemplate("anc_%02x_%02x_at_%u_%u", PadDirection.SRC,
                    PadPresence.SOMETIMES, ST2038_ANY.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.srcpad = self.static_pad("src")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._streams: dict[tuple, Pad] = {}

    def _stream_pad(self, hdr) -> Pad:
        key = (hdr.did, hdr.sdid, hdr.line_number,
               hdr.horizontal_offset)
        pad = self._streams.get(key)
        if pad is None:
            name = (f"anc_{hdr.did:02x}_{hdr.sdid:02x}_at_"
                    f"{hdr.line_number}_{hdr.horizontal_offset}")
            pad = Pad(name, PadDirection.SRC, self.PAD_TEMPLATES[2],
                      self)
            self.add_pad(pad)
            pad.push_event(StreamStartEvent(f"{self.name}/{name}"))
            pad.push_event(CapsEvent(ST2038_ALIGNED.copy()))
            pad.push_event(SegmentEvent(Segment()))
            self._streams[key] = pad
        return pad

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        data = buf.to_bytes()
        for hdr, _payload in iter_anc(data):
            pkt = data[:hdr.len]
            data = data[hdr.len:]
            out = Buffer(pkt, pts=buf.pts, duration=buf.duration)
            sp = self._stream_pad(hdr)
            if sp.is_linked():
                sp.push(out.copy())
            if self.srcpad.is_linked():
                ret = self.srcpad.push(out)
                if ret is not FlowReturn.OK:
                    return ret
        return FlowReturn.OK

    def _event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, CapsEvent):
            return self.srcpad.push_event(
                CapsEvent(ST2038_ALIGNED.copy()))
        ok = self.srcpad.push_event(ev)
        for sp in self._streams.values():
            if isinstance(ev, EosEvent) and sp.is_linked():
                sp.push_event(EosEvent())
        return ok


@register_element("st2038ancmux", Rank.NONE)
class St2038AncMux(Aggregator):
    PAD_TEMPLATES = [
        PadTemplate("sink_%u", PadDirection.SINK,
                    PadPresence.REQUEST, ST2038_ANY.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    ST2038_ANY.copy()),
    ]

    def negotiate_src_caps(self) -> Caps:
        return Caps.new("meta/x-st-2038", alignment="frame")

    def aggregate(self, timeout: bool) -> FlowReturn:
        """Merge the earliest-timestamp buffers across pads into one
        frame-aligned buffer once every pad has data or is EOS."""
        pads = self.agg_sink_pads()
        if not all(p.peek_buffer() or p.is_eos() for p in pads):
            return FlowReturn.OK
        ready = [p for p in pads if p.peek_buffer()]
        if not ready:
            return FlowReturn.OK
        t = min((p.peek_buffer().pts or 0) for p in ready)
        parts = [p.pop_buffer() for p in ready
                 if (p.peek_buffer().pts or 0) == t]
        merged = b"".join(b.to_bytes() for b in parts)
        return self.srcpad.push(Buffer(merged, pts=t,
                                       duration=parts[0].duration))
