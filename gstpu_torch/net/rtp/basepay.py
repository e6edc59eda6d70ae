"""RtpBasePay2 / RtpBaseDepay2: in-repo payloader base classes.

Rebuilds the reference's own RTP base classes (net/rtp/src/basepay/
mod.rs:128-254, basedepay/mod.rs:122-230): seqnum/extended-timestamp
handling, MTU fragmentation hooks, discont handling. Subclasses
implement handle_buffer / handle_packet.

The port's copy of gstpu/net/rtp/basepay.py, as it stands.
"""

from __future__ import annotations

import random

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.caps import Caps, IntRange, Structure
from gstpu_torch.core.element import PadDirection
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.net.rtp.packet import RtpPacket, RtpParseError

SECOND = 1_000_000_000


def rtp_caps(encoding_name: str | None = None, clock_rate=None,
             payload=None, **extra) -> Caps:
    s = Structure("application/x-rtp")
    s["media"] = extra.pop("media", None) or "audio"
    if encoding_name is not None:
        s["encoding-name"] = encoding_name
    s["clock-rate"] = clock_rate if clock_rate is not None \
        else IntRange(1, 2**31 - 1)
    s["payload"] = payload if payload is not None else IntRange(0, 127)
    for k, v in extra.items():
        if v is not None:
            s[k] = v
    return Caps([s])


class RtpBasePay2(BaseTransform):
    """Raw media in, application/x-rtp packets out."""

    DEFAULT_PT = 96
    ENCODING_NAME = "X-GST"
    MEDIA = "audio"

    pt = Property(int, default=96, minimum=0, maximum=127,
                  mutable=Mutability.READY)
    ssrc = Property(int, default=-1, minimum=-1,
                    mutable=Mutability.READY,
                    blurb="-1 = random")
    mtu = Property(int, default=1400, minimum=28,
                   mutable=Mutability.PLAYING)
    seqnum_offset = Property(int, default=-1, minimum=-1,
                             mutable=Mutability.READY)
    timestamp_offset = Property(int, default=-1, minimum=-1,
                                mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._ssrc = None
        self._seqnum = None
        self._ts_offset = None
        self.clock_rate = 0
        self._pending: list[Buffer] = []

    def start(self) -> bool:
        rng = random.SystemRandom()  # RFC 3550: random SSRC/offsets
        self._ssrc = self.ssrc if self.ssrc >= 0 \
            else rng.getrandbits(32)
        self._seqnum = self.seqnum_offset if self.seqnum_offset >= 0 \
            else rng.getrandbits(16)
        self._ts_offset = self.timestamp_offset \
            if self.timestamp_offset >= 0 else rng.getrandbits(32)
        return True

    # negotiation: subclass provides src caps via pay_src_caps()
    def transform_caps(self, direction, caps, filter):
        if direction is PadDirection.SINK:
            out = self.srcpad.pad_template_caps().copy()
            for s in out:
                s["payload"] = self.pt
        else:
            out = self.sinkpad.pad_template_caps().copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def set_caps(self, incaps, outcaps) -> bool:
        s = outcaps[0]
        self.clock_rate = int(s["clock-rate"])
        return self.set_sink_caps(incaps)

    def set_sink_caps(self, caps: Caps) -> bool:
        return True

    def rtp_timestamp_for(self, buf: Buffer) -> int:
        if buf.pts is None:
            return self._ts_offset
        return (self._ts_offset
                + (buf.pts * self.clock_rate // SECOND)) & 0xFFFFFFFF

    def queue_packet(self, payload: bytes, *, marker: bool = False,
                     rtp_ts: int | None = None,
                     pts: int | None = None) -> None:
        """Subclasses call this from handle_buffer per packet."""
        pkt = RtpPacket(payload_type=self.pt, seqnum=self._seqnum,
                        timestamp=rtp_ts if rtp_ts is not None else 0,
                        ssrc=self._ssrc, payload=payload, marker=marker)
        self._seqnum = (self._seqnum + 1) & 0xFFFF
        self._pending.append(Buffer(pkt.to_bytes(), pts=pts))

    def transform(self, buf: Buffer):
        self._pending = []
        self.handle_buffer(buf)
        out, self._pending = self._pending, []
        return out or None

    def handle_buffer(self, buf: Buffer) -> None:
        """Default: fragment the payload over MTU-sized packets,
        marker on the last."""
        data = buf.to_bytes()
        rtp_ts = self.rtp_timestamp_for(buf)
        max_payload = self.mtu - 12
        chunks = [data[i:i + max_payload]
                  for i in range(0, len(data), max_payload)] or [b""]
        for i, c in enumerate(chunks):
            self.queue_packet(c, marker=(i == len(chunks) - 1),
                              rtp_ts=rtp_ts, pts=buf.pts)


class RtpBaseDepay2(BaseTransform):
    """application/x-rtp in, raw media out."""

    def __init__(self, name=None):
        super().__init__(name)
        self.clock_rate = 0
        self._pending: list[Buffer] = []
        self._ext_rtptime: int | None = None
        self._ts_base: int | None = None

    def transform_caps(self, direction, caps, filter):
        from gstpu_torch.core.element import PadDirection
        out = (self.sinkpad if direction is PadDirection.SRC
               else self.srcpad).pad_template_caps().copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def set_caps(self, incaps, outcaps) -> bool:
        s = incaps[0]
        self.clock_rate = int(s.get("clock-rate", 0) or 0)
        return self.set_rtp_caps(incaps)

    def set_rtp_caps(self, caps: Caps) -> bool:
        return True

    def _negotiate(self, incaps):
        # depayloaders fix their own output caps in set_caps
        self.in_caps = incaps
        out = self.depay_src_caps(incaps)
        if out is None:
            return False
        self.out_caps = out
        ok = self.set_caps(incaps, out)
        if ok:
            from gstpu_torch.core.event import CapsEvent
            self.srcpad.push_event(CapsEvent(out))
        return ok

    def depay_src_caps(self, incaps: Caps) -> Caps | None:
        """Subclass: produce fixed output caps from the rtp caps."""
        raise NotImplementedError

    def _extend_rtptime(self, rtptime: int) -> int:
        if self._ext_rtptime is None:
            self._ext_rtptime = 0x100000000 | rtptime
        else:
            delta = ((rtptime - (self._ext_rtptime & 0xFFFFFFFF)
                      + 0x80000000) % 0x100000000) - 0x80000000
            self._ext_rtptime += delta
        return self._ext_rtptime

    def pts_for(self, pkt: RtpPacket) -> int | None:
        if not self.clock_rate:
            return None
        ext = self._extend_rtptime(pkt.timestamp)
        if self._ts_base is None:
            self._ts_base = ext
        return (ext - self._ts_base) * SECOND // self.clock_rate

    def queue_buffer(self, data, *, pts: int | None = None,
                     duration: int | None = None) -> None:
        self._pending.append(Buffer(data, pts=pts, duration=duration))

    def transform(self, buf: Buffer):
        try:
            pkt = RtpPacket.parse(buf.to_bytes())
        except RtpParseError as e:
            self.post_error(f"bad RTP packet: {e}")
            return None
        self._pending = []
        self.handle_packet(pkt, buf)
        out, self._pending = self._pending, []
        return out or None

    def handle_packet(self, pkt: RtpPacket, buf: Buffer) -> None:
        self.queue_buffer(pkt.payload, pts=self.pts_for(pkt))
