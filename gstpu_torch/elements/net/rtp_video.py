"""VP8/VP9 RTP payloaders/depayloaders
(reference net/rtp/src/{vp8,vp9}; RFC 7741 + VP9 payload draft).
Frames fragment over MTU with begin/end markers; depayloaders
reassemble until the RTP marker bit.

The port's copy of gstpu/elements/net/rtp_video.py, as it stands.
"""

from __future__ import annotations

from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import video_caps
from gstpu_torch.net.rtp.basepay import RtpBaseDepay2, RtpBasePay2, rtp_caps
from gstpu_torch.net.rtp.packet import RtpPacket


def _tmpl(name, d, caps):
    return PadTemplate(name, d, PadPresence.ALWAYS, caps)


@register_element("rtpvp8pay2", Rank.SECONDARY)
class RtpVp8Pay(RtpBasePay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, Caps.new("video/x-vp8")),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("VP8", clock_rate=90000, media="video")),
    ]

    def handle_buffer(self, buf: Buffer) -> None:
        data = buf.to_bytes()
        rtp_ts = self.rtp_timestamp_for(buf)
        max_payload = self.mtu - 12 - 1
        chunks = [data[i:i + max_payload]
                  for i in range(0, len(data), max_payload)] or [b""]
        for i, c in enumerate(chunks):
            # RFC 7741 minimal descriptor: S bit on the first fragment
            desc = bytes([0x10 if i == 0 else 0x00])
            self.queue_packet(desc + c, marker=(i == len(chunks) - 1),
                              rtp_ts=rtp_ts, pts=buf.pts)


@register_element("rtpvp8depay2", Rank.SECONDARY)
class RtpVp8Depay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, rtp_caps("VP8",
                                                  clock_rate=90000,
                                                  media="video")),
        _tmpl("src", PadDirection.SRC, Caps.new("video/x-vp8")),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._frags: list[bytes] = []
        self._frame_pts = None

    def depay_src_caps(self, incaps):
        return Caps.new("video/x-vp8")

    @staticmethod
    def _strip_descriptor(payload: bytes) -> bytes:
        if not payload:
            return b""
        off = 1
        b0 = payload[0]
        if b0 & 0x80:  # X: extended control bits
            x = payload[off]
            off += 1
            if x & 0x80:  # I: PictureID (1-2 bytes)
                off += 2 if payload[off] & 0x80 else 1
            if x & 0x40:  # L: TL0PICIDX
                off += 1
            if x & 0x30:  # T/K
                off += 1
        return payload[off:]

    def handle_packet(self, pkt: RtpPacket, buf: Buffer) -> None:
        payload = self._strip_descriptor(pkt.payload)
        if pkt.payload and (pkt.payload[0] & 0x10) and self._frags:
            self._frags = []  # new partition start: drop stale frags
        if not self._frags:
            self._frame_pts = self.pts_for(pkt)
        self._frags.append(payload)
        if pkt.marker:
            frame = b"".join(self._frags)
            self._frags = []
            out = Buffer(frame, pts=self._frame_pts)
            # VP8 keyframe: lowest bit of first byte == 0
            if frame and (frame[0] & 0x01):
                out.set_flag(BufferFlags.DELTA_UNIT)
            self.queue_buffer(out.data, pts=out.pts)
            if out.has_flag(BufferFlags.DELTA_UNIT):
                self._pending[-1].set_flag(BufferFlags.DELTA_UNIT)


@register_element("rtpvp9pay2", Rank.SECONDARY)
class RtpVp9Pay(RtpBasePay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, Caps.new("video/x-vp9")),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("VP9", clock_rate=90000, media="video")),
    ]

    def handle_buffer(self, buf: Buffer) -> None:
        data = buf.to_bytes()
        rtp_ts = self.rtp_timestamp_for(buf)
        max_payload = self.mtu - 12 - 1
        chunks = [data[i:i + max_payload]
                  for i in range(0, len(data), max_payload)] or [b""]
        last = len(chunks) - 1
        for i, c in enumerate(chunks):
            # VP9 payload descriptor: B (bit 3) begin, E (bit 2) end
            desc = (0x08 if i == 0 else 0) | (0x04 if i == last else 0)
            if not buf.is_keyframe():
                desc |= 0x40  # P: inter-picture predicted
            self.queue_packet(bytes([desc]) + c, marker=(i == last),
                              rtp_ts=rtp_ts, pts=buf.pts)


@register_element("rtpvp9depay2", Rank.SECONDARY)
class RtpVp9Depay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, rtp_caps("VP9",
                                                  clock_rate=90000,
                                                  media="video")),
        _tmpl("src", PadDirection.SRC, Caps.new("video/x-vp9")),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._frags: list[bytes] = []
        self._frame_pts = None
        self._delta = False

    def depay_src_caps(self, incaps):
        return Caps.new("video/x-vp9")

    @staticmethod
    def _strip_descriptor(payload: bytes) -> tuple[bytes, int]:
        if not payload:
            return b"", 0
        b0 = payload[0]
        off = 1
        if b0 & 0x80:  # I: picture ID
            off += 2 if payload[off] & 0x80 else 1
        if b0 & 0x20:  # L: layer indices
            off += 1
            if not (b0 & 0x10):  # no F (flexible): TL0PICIDX present
                off += 1
        return payload[off:], b0

    def handle_packet(self, pkt: RtpPacket, buf: Buffer) -> None:
        payload, b0 = self._strip_descriptor(pkt.payload)
        if b0 & 0x08 and self._frags:
            self._frags = []
        if not self._frags:
            self._frame_pts = self.pts_for(pkt)
            self._delta = bool(b0 & 0x40)
        self._frags.append(payload)
        if pkt.marker or (b0 & 0x04):
            frame = b"".join(self._frags)
            self._frags = []
            self.queue_buffer(frame, pts=self._frame_pts)
            if self._delta:
                self._pending[-1].set_flag(BufferFlags.DELTA_UNIT)


# -- AV1 (RFC 9628) -------------------------------------------------------

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_TILE_LIST = 8


def leb128_encode(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def leb128_decode(data: bytes, pos: int = 0) -> tuple[int, int]:
    v = shift = 0
    while True:
        b = data[pos]
        v |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return v, pos
        shift += 7


def parse_obus(data: bytes):
    """(obu_type, element_bytes) for a sized obu-stream; the element
    keeps its header but has_size_field cleared (RFC 9628 4.4 — RTP
    carries OBUs without internal size fields)."""
    pos = 0
    while pos < len(data):
        hdr = data[pos]
        otype = hdr >> 3 & 0x0F
        ext = bool(hdr & 0x04)
        if not hdr & 0x02:
            raise ValueError("obu without size field in obu-stream")
        hlen = 2 if ext else 1
        size, after = leb128_decode(data, pos + hlen)
        body = data[after:after + size]
        element = bytes([hdr & ~0x02]) \
            + data[pos + 1:pos + hlen] + body
        yield otype, element
        pos = after + size


@register_element("rtpav1pay2", Rank.SECONDARY)
class RtpAv1Pay(RtpBasePay2):
    """RFC 9628 (reference net/rtp/src/av1/pay): 1-byte aggregation
    header Z|Y|W|N, leb128-prefixed OBU elements (last unprefixed when
    W=count<=3), temporal delimiters and tile lists dropped, large
    OBUs fragmented with Z/Y continuation bits."""

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              Caps.new("video/x-av1",
                       **{"stream-format": "obu-stream"})),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("AV1", clock_rate=90000, media="video")),
    ]

    def handle_buffer(self, buf) -> None:
        obus = [el for t, el in parse_obus(buf.to_bytes())
                if t not in (OBU_TEMPORAL_DELIMITER, OBU_TILE_LIST)]
        if not obus:
            return
        rtp_ts = self.rtp_timestamp_for(buf)
        n_bit = any(t == OBU_SEQUENCE_HEADER
                    for t, _ in parse_obus(buf.to_bytes()))
        room = self.mtu - 12 - 1
        packets: list[tuple[int, int, list[bytes]]] = []  # z, y, els
        z = 0
        els: list[bytes] = []
        used = 0
        for obu in obus:
            data = obu
            while True:
                need = len(leb128_encode(len(data))) + len(data)
                if used + need <= room:
                    els.append(data)
                    used += need
                    break
                space = room - used - 2    # leb128 of a fragment fits
                if space < 8 and els:      # flush and retry
                    packets.append((z, 0, els))
                    z = 0
                    els, used = [], 0
                    continue
                frag, data = data[:max(space, 1)], data[max(space, 1):]
                els.append(frag)
                packets.append((z, 1, els))
                z = 1
                els, used = [], 0
        if els:
            packets.append((z, 0, els))
        for pi, (pz, py, pels) in enumerate(packets):
            w = len(pels) if len(pels) <= 3 else 0
            hdr = (pz << 7 | py << 6 | w << 4
                   | (1 if n_bit and pi == 0 else 0) << 3)
            body = b""
            for j, el in enumerate(pels):
                last = j == len(pels) - 1
                if w and last:
                    body += el
                else:
                    body += leb128_encode(len(el)) + el
            self.queue_packet(bytes([hdr]) + body,
                              marker=(pi == len(packets) - 1),
                              rtp_ts=rtp_ts, pts=buf.pts)


@register_element("rtpav1depay2", Rank.SECONDARY)
class RtpAv1Depay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              rtp_caps("AV1", clock_rate=90000, media="video")),
        _tmpl("src", PadDirection.SRC,
              Caps.new("video/x-av1",
                       **{"stream-format": "obu-stream"})),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._frag = b""
        self._tu: list[bytes] = []         # complete OBU elements
        self._tu_pts = None

    def depay_src_caps(self, incaps):
        return Caps.new("video/x-av1",
                        **{"stream-format": "obu-stream",
                           "alignment": "tu"})

    @staticmethod
    def _resize(element: bytes) -> bytes:
        """Re-add the has_size_field and leb128 size."""
        hdr = element[0] | 0x02
        ext = bool(element[0] & 0x04)
        hlen = 2 if ext else 1
        body = element[hlen:]
        return (bytes([hdr]) + element[1:hlen]
                + leb128_encode(len(body)) + body)

    def handle_packet(self, pkt, buf) -> None:
        data = pkt.payload
        if not data:
            return
        z, y = data[0] >> 7 & 1, data[0] >> 6 & 1
        w = data[0] >> 4 & 0x3
        pos = 1
        els = []
        count = 0
        while pos < len(data):
            count += 1
            if w and count == w:
                els.append(data[pos:])
                pos = len(data)
            else:
                ln, pos = leb128_decode(data, pos)
                els.append(data[pos:pos + ln])
                pos += ln
        if not els:
            return
        if self._tu_pts is None:
            self._tu_pts = self.pts_for(pkt)
        for i, el in enumerate(els):
            first, last = i == 0, i == len(els) - 1
            if first and z:
                self._frag += el
                if not (last and y):
                    self._tu.append(self._frag)
                    self._frag = b""
            elif last and y:
                self._frag += el
            else:
                self._tu.append(el)
        if pkt.marker:
            if self._frag:                 # truncated fragment: drop
                self._frag = b""
            out = b"\x12\x00"              # temporal delimiter
            out += b"".join(self._resize(el) for el in self._tu
                            if el)
            self.queue_buffer(out, pts=self._tu_pts)
            self._tu = []
            self._tu_pts = None


# -- raw video (RFC 4175) --------------------------------------------------

_VRAW_PGROUP = {"RGB": 3, "RGBA": 4, "BGR": 3, "BGRA": 4, "GRAY8": 1}
_VRAW_SAMPLING = {"RGB": "RGB", "RGBA": "RGBA", "BGR": "BGR",
                  "BGRA": "BGRA", "GRAY8": "GRAYSCALE"}


@register_element("rtpvrawpay2", Rank.SECONDARY)
class RtpVRawPay(RtpBasePay2):
    """RFC 4175: 2-byte extended seqnum + per-line headers
    (Length, F|LineNo, C|Offset) + pixel data (reference
    net/rtp/src/raw_video/pay)."""

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              video_caps(formats=tuple(_VRAW_PGROUP))),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("RAW", clock_rate=90000, media="video")),
    ]

    def set_sink_caps(self, caps) -> bool:
        from gstpu_torch.core.video import VideoInfo
        self._info = VideoInfo.from_caps(caps)
        return True

    def transform_caps(self, direction, caps, filter):
        out = super().transform_caps(direction, caps, filter)
        if direction is PadDirection.SINK and caps.is_fixed():
            s = caps[0]
            for st in out:
                st["sampling"] = _VRAW_SAMPLING[s["format"]]
                st["width"] = str(s["width"])
                st["height"] = str(s["height"])
                st["depth"] = "8"
        return out

    def handle_buffer(self, buf) -> None:
        info = self._info
        pg = _VRAW_PGROUP[info.format]
        stride = info.width * pg
        data = buf.to_bytes()
        rtp_ts = self.rtp_timestamp_for(buf)
        room = self.mtu - 12 - 2
        line = 0
        off_px = 0
        while line < info.height:
            # build one packet: as many (partial) lines as fit
            hdrs = []
            chunks = []
            used = 2
            while line < info.height:
                remain_px = info.width - off_px
                avail = room - used - 6
                if avail < pg:
                    break
                take_px = min(remain_px, avail // pg)
                cont = not (take_px == remain_px
                            and line == info.height - 1)
                hdrs.append((take_px * pg, line, off_px))
                chunks.append(
                    data[line * stride + off_px * pg:
                         line * stride + (off_px + take_px) * pg])
                used += 6 + take_px * pg
                off_px += take_px
                if off_px >= info.width:
                    off_px = 0
                    line += 1
            payload = b"\x00\x00"          # extended seqnum
            for i, (ln, lno, ofs) in enumerate(hdrs):
                c = 0x8000 if i < len(hdrs) - 1 else 0
                payload += (ln.to_bytes(2, "big")
                            + lno.to_bytes(2, "big")
                            + (c | ofs).to_bytes(2, "big"))
            payload += b"".join(chunks)
            last = line >= info.height
            self.queue_packet(payload, marker=last, rtp_ts=rtp_ts,
                              pts=buf.pts)


@register_element("rtpvrawdepay2", Rank.SECONDARY)
class RtpVRawDepay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              rtp_caps("RAW", clock_rate=90000, media="video")),
        _tmpl("src", PadDirection.SRC,
              video_caps(formats=tuple(_VRAW_PGROUP))),
    ]

    def depay_src_caps(self, incaps):
        s = incaps[0]
        fmt = next(k for k, v in _VRAW_SAMPLING.items()
                   if v == s.get("sampling", "RGB"))
        self._w = int(s["width"])
        self._h = int(s["height"])
        self._pg = _VRAW_PGROUP[fmt]
        self._frame = bytearray(self._w * self._h * self._pg)
        from fractions import Fraction
        return Caps.new("video/x-raw", format=fmt, width=self._w,
                        height=self._h, framerate=Fraction(30, 1))

    def __init__(self, name=None):
        super().__init__(name)
        self._frame_pts = None

    def handle_packet(self, pkt, buf) -> None:
        data = pkt.payload
        pos = 2
        hdrs = []
        while pos + 6 <= len(data):
            ln = int.from_bytes(data[pos:pos + 2], "big")
            lno = int.from_bytes(data[pos + 2:pos + 4], "big") & 0x7FFF
            word = int.from_bytes(data[pos + 4:pos + 6], "big")
            cont = bool(word & 0x8000)
            hdrs.append((ln, lno, word & 0x7FFF))
            pos += 6
            if not cont:
                break
        if self._frame_pts is None:
            self._frame_pts = self.pts_for(pkt)
        stride = self._w * self._pg
        for ln, lno, ofs in hdrs:
            start = lno * stride + ofs * self._pg
            self._frame[start:start + ln] = data[pos:pos + ln]
            pos += ln
        if pkt.marker:
            self.queue_buffer(bytes(self._frame),
                              pts=self._frame_pts)
            self._frame = bytearray(len(self._frame))
            self._frame_pts = None
