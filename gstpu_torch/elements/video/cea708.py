"""cea608tocea708: wrap CEA-608 pairs into CEA-708 cc_data or CDP.

Rebuilds the reference cea608tocea708 (video/closedcaption/src/
cea608tocea708/imp.rs: sink closedcaption/x-cea-608 format=raw or
s334-1a, src closedcaption/x-cea-708 format=cc_data).  This element
additionally negotiates format=cdp on the src side, producing full
SMPTE 334-2 CDP packets (sequence counter + checksum) sized to the
frame rate — the form mccenc and cea708mux consume.

The port's copy of gstpu/elements/video/cea708.py, as it stands.
"""

from __future__ import annotations

from fractions import Fraction

from gstpu_torch.codecs.cea708 import (CC_COUNT, CDP_RATES, Cdp, build_cdp,
                                       cc_data_from_608, pad_cc_data)
from gstpu_torch.core.base import Aggregator, BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, Structure
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.registry import Rank, register_element

C608_CAPS = Caps([Structure("closedcaption/x-cea-608",
                            format=AnyList(("raw", "s334-1a")))])
C708_CAPS = Caps([Structure("closedcaption/x-cea-708",
                            format=AnyList(("cc_data", "cdp")))])


@register_element("cea608tocea708", Rank.NONE)
class Cea608ToCea708(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    C608_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    C708_CAPS.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._s334 = False
        self._cdp = False
        self._rate_code = 0x4
        self._seq = 0

    def transform_caps(self, direction, caps, filter):
        out = (C708_CAPS if direction is PadDirection.SINK
               else C608_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def set_caps(self, incaps, outcaps) -> bool:
        self._s334 = incaps[0].get("format") == "s334-1a"
        self._cdp = outcaps[0].get("format") == "cdp"
        fr = incaps[0].get("framerate")
        if fr is not None:
            self._rate_code = CDP_RATES.get(Fraction(fr), 0x4)
        return True

    def _pairs(self, data: bytes) -> list[tuple[int, bytes]]:
        """(field, pair) tuples; s334-1a carries a field byte per pair
        (imp.rs:514), raw is all field 0."""
        out = []
        if self._s334:
            for i in range(0, len(data) - 2, 3):
                field = 0 if data[i] & 0x80 else 1
                out.append((field, data[i + 1:i + 3]))
        else:
            for i in range(0, len(data) - 1, 2):
                out.append((0, data[i:i + 2]))
        return out

    def transform(self, buf: Buffer) -> Buffer:
        cc = b"".join(cc_data_from_608([p], field_=f)
                      for f, p in self._pairs(buf.to_bytes()))
        if self._cdp:
            cc = pad_cc_data(cc, CC_COUNT[self._rate_code])
            out = build_cdp(Cdp(rate_code=self._rate_code,
                                sequence=self._seq, cc_data=cc))
            self._seq = (self._seq + 1) & 0xFFFF
        else:
            out = cc
        return Buffer(out, pts=buf.pts, duration=buf.duration)


CDP_ONLY = Caps.new("closedcaption/x-cea-708", format="cdp")


@register_element("cdpserviceinject", Rank.NONE)
class CdpServiceInject(BaseTransform):
    """Injects caption service descriptors into CDP packets
    (reference video/closedcaption/src/cdpserviceinject/imp.rs:123:
    positive service numbers are CEA-708 services with easy-reader /
    wide-aspect-ratio flags, -1..-4 select CEA-608 channels CC1-CC4;
    languages are 3-letter ISO 639.2/B codes)."""

    IN_PLACE = False
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    CDP_ONLY.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    CDP_ONLY.copy()),
    ]

    from gstpu_torch.core.props import Mutability, Property
    services = Property(object, default=None,
                        mutable=Mutability.PLAYING,
                        blurb="list of dicts: service, language, "
                              "easy_reader, wide_aspect_ratio")

    def transform(self, buf):
        from gstpu_torch.codecs.cea708 import build_cdp, parse_cdp
        if not self.services:
            return buf
        cdp = parse_cdp(buf.to_bytes())
        cdp.services = list(self.services)
        return Buffer(build_cdp(cdp), pts=buf.pts,
                      duration=buf.duration)


@register_element("cea708mux", Rank.NONE)
class Cea708Mux(Aggregator):
    """Merges several CEA-708 streams into one CDP sequence
    (reference video/closedcaption/src/cea708mux/imp.rs): each input's
    DTVCC service blocks are re-muxed into a single packet per output
    frame (per-pad `service-N` remapping via pad order when services
    collide is the caller's job — colliding service numbers keep the
    first pad's blocks, like the reference's discarded_services).
    608 pairs pass through from the first pad carrying any.
    """

    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("closedcaption/x-cea-708", format="cdp")),
        PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST,
                    Caps([Structure("closedcaption/x-cea-708",
                                    format=AnyList(("cdp",
                                                    "cc_data")))])),
    ]

    from gstpu_torch.core.props import Mutability, Property
    framerate_code = Property(int, default=0x4, minimum=1, maximum=8,
                              mutable=Mutability.READY,
                              blurb="CDP frame rate code (0x4=29.97)")

    def __init__(self, name=None):
        super().__init__(name)
        self._seq = 0
        self._dtvcc_seq = 0

    def negotiate_src_caps(self):
        return Caps.new("closedcaption/x-cea-708", format="cdp")

    def _cc_data_of(self, pad, buf) -> bytes:
        if pad.current_caps[0].get("format") == "cdp":
            from gstpu_torch.codecs.cea708 import parse_cdp
            return parse_cdp(buf.to_bytes()).cc_data
        return buf.to_bytes()

    def aggregate(self, timeout: bool) -> FlowReturn:
        from gstpu_torch.codecs.cea708 import (CC_COUNT, Cdp, build_cdp,
                                               build_dtvcc, cc_data_from_608,
                                               ccdata_split, dtvcc_to_ccdata,
                                               pad_cc_data, parse_dtvcc)
        pads = self.agg_sink_pads()
        if not pads or not all(p.peek_buffer() or p.is_eos()
                               for p in pads):
            return FlowReturn.OK
        ready = [p for p in pads if p.peek_buffer()]
        if not ready:
            return FlowReturn.OK
        pts = min((p.peek_buffer().pts or 0) for p in ready)
        blocks: list[tuple[int, bytes]] = []
        seen: set[int] = set()
        pairs_out: list[tuple[int, bytes]] = []
        have_608 = False
        for p in ready:
            if (p.peek_buffer().pts or 0) != pts:
                continue
            buf = p.pop_buffer()
            pairs, pkts = ccdata_split(self._cc_data_of(p, buf))
            if pairs and not have_608:
                pairs_out = pairs
                have_608 = True
            for pkt in pkts:
                _seq, blks = parse_dtvcc(pkt)
                for svc, data in blks:
                    if svc in seen:
                        continue           # first pad wins
                    seen.add(svc)
                    blocks.append((svc, data))
        cc = b"".join(cc_data_from_608([pr], field_=f)
                      for f, pr in pairs_out)
        if blocks:
            pkt = build_dtvcc(self._dtvcc_seq, blocks)
            self._dtvcc_seq = (self._dtvcc_seq + 1) & 0x3
            cc += dtvcc_to_ccdata(pkt)
        cc = pad_cc_data(cc, CC_COUNT[self.framerate_code])
        out = build_cdp(Cdp(rate_code=self.framerate_code,
                            sequence=self._seq, cc_data=cc))
        self._seq = (self._seq + 1) & 0xFFFF
        return self.srcpad.push(Buffer(out, pts=pts))


@register_element("tttocea708", Rank.NONE)
class TtToCea708(BaseTransform):
    """Timed text -> CEA-708 cc_data carrying one service block per
    buffer (reference tttocea708; the minimal Service text form this
    framework's cea708overlay/service_block_text understands: a
    define-window command, the G0 text, ETX)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("text/x-raw", format="utf8")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("closedcaption/x-cea-708",
                             format="cc_data")),
    ]

    service = Property(int, default=1, minimum=1, maximum=63,
                       mutable=Mutability.READY)
    service_number = Property(
        int, default=0, minimum=0, maximum=63,
        mutable=Mutability.READY,
        blurb="DTVCC service number (reference service-number); "
              "0 = use the older 'service' property")
    cea608_channel = Property(
        int, default=0, minimum=0, maximum=4,
        mutable=Mutability.READY,
        blurb="Also write CEA-608 compatibility bytes on this "
              "channel; 0 = disabled (reference cea608-channel — "
              "like the reference, only channels 1 and 3 are "
              "supported)")
    origin_row = Property(int, default=-1, minimum=-1, maximum=74,
                          mutable=Mutability.PLAYING,
                          blurb="DefineWindow anchor row; -1 = "
                                "automatic (reference origin-row)")
    origin_column = Property(int, default=0, minimum=0, maximum=209,
                             mutable=Mutability.PLAYING,
                             blurb="DefineWindow anchor column "
                                   "(reference origin-column)")
    roll_up_rows = Property(int, default=0, minimum=0, maximum=15,
                            mutable=Mutability.PLAYING,
                            blurb="Window row count in roll-up mode; "
                                  "0 = single-row default "
                                  "(reference roll-up-rows)")
    roll_up_timeout = Property(
        int, default=0, minimum=0, mutable=Mutability.PLAYING,
        blurb="Delete the caption windows after this much ns "
              "without new text; 0 = never (reference "
              "roll-up-timeout; applied on the next buffer, as on "
              "tttocea608)")

    def __init__(self, name=None):
        super().__init__(name)
        self._seq = 0
        self._last_text_pts = None
        self._608 = None

    def transform_caps(self, direction, caps, filter):
        out = (Caps.new("closedcaption/x-cea-708", format="cc_data")
               if direction is PadDirection.SINK
               else Caps.new("text/x-raw", format="utf8")).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def _define_window(self) -> bytes:
        """DefineWindow0 with the configured anchor/rows (CEA-708
        §8.4.4): visible, priority 3, absolute anchor at
        origin-row/column, roll-up-rows rows, 31 columns."""
        av = self.origin_row if self.origin_row >= 0 else 74
        rows = max(0, (self.roll_up_rows or 1) - 1)
        return bytes([
            0x98,
            0x20 | 0x03,                 # visible, priority 3
            av & 0x7F,                   # absolute, anchor vertical
            self.origin_column & 0xFF,   # anchor horizontal
            (6 << 4) | rows,             # anchor point 6 (bottom
                                         # left), row count
            31,                          # column count
            0x00])                       # default window/pen style

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        from gstpu_torch.codecs.cea708 import (build_dtvcc, cc_triplet,
                                               dtvcc_to_ccdata)
        text = buf.to_bytes().decode("utf-8", "replace")
        svc = self.service_number or self.service
        stale = (self.roll_up_timeout and buf.pts is not None
                 and self._last_text_pts is not None
                 and buf.pts - self._last_text_pts
                 > self.roll_up_timeout)
        self._last_text_pts = buf.pts
        payload = (self._define_window()
                   + text.encode("ascii", "replace")
                   .replace(b"\n", b"\x0d") + b"\x03")
        if stale:
            payload = b"\x8c\xff" + payload   # DeleteWindows(all)
        out = []
        # service blocks carry at most 31 bytes: split long text
        for i in range(0, len(payload), 31):
            pkt = build_dtvcc(self._seq, [(svc, payload[i:i + 31])])
            self._seq = (self._seq + 1) & 0x3
            cc = dtvcc_to_ccdata(pkt)
            if i == 0 and self.cea608_channel in (1, 3):
                # 608 compatibility bytes lead the cc_data (field 1;
                # channels 2/4 are unsupported like the reference)
                if self._608 is None:
                    from gstpu_torch.codecs.cea608 import Cea608Encoder
                    self._608 = Cea608Encoder()
                pairs = self._608.encode_rollup(text, rows=2)
                if stale:
                    pairs = self._608.encode_clear() + pairs
                cc = b"".join(cc_triplet(pr[0], pr[1], 0)
                              for pr in pairs) + cc
            out.append(Buffer(cc, pts=buf.pts,
                              duration=buf.duration))
        return out or None
