"""RTP (RFC 3550) and RTCP packet parsing/building.

Pure byte codecs (no IO, no clocks) — the foundation of the sans-IO
session design retained from the reference
(net/rtp/src/rtpbin2/session.rs architecture).

The port's copy of gstpu/net/rtp/packet.py, as it stands.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

RTP_VERSION = 2


class RtpParseError(ValueError):
    pass


@dataclass
class RtpPacket:
    payload_type: int
    seqnum: int
    timestamp: int
    ssrc: int
    payload: bytes = b""
    marker: bool = False
    csrcs: tuple[int, ...] = ()
    extension: tuple[int, bytes] | None = None  # (profile, data)
    padding: int = 0

    def to_bytes(self) -> bytes:
        b0 = (RTP_VERSION << 6) | (0x20 if self.padding else 0) \
            | (0x10 if self.extension else 0) | len(self.csrcs)
        b1 = (0x80 if self.marker else 0) | (self.payload_type & 0x7F)
        out = [struct.pack(">BBHII", b0, b1, self.seqnum & 0xFFFF,
                           self.timestamp & 0xFFFFFFFF, self.ssrc)]
        for c in self.csrcs:
            out.append(struct.pack(">I", c))
        if self.extension is not None:
            profile, data = self.extension
            if len(data) % 4:
                data = data + b"\x00" * (4 - len(data) % 4)
            out.append(struct.pack(">HH", profile, len(data) // 4))
            out.append(data)
        out.append(self.payload)
        if self.padding:
            out.append(b"\x00" * (self.padding - 1)
                       + bytes([self.padding]))
        return b"".join(out)

    @staticmethod
    def parse(data: bytes) -> "RtpPacket":
        if len(data) < 12:
            raise RtpParseError(f"short RTP packet: {len(data)}")
        b0, b1, seq, ts, ssrc = struct.unpack_from(">BBHII", data)
        if b0 >> 6 != RTP_VERSION:
            raise RtpParseError(f"bad RTP version {b0 >> 6}")
        cc = b0 & 0x0F
        off = 12
        if len(data) < off + 4 * cc:
            raise RtpParseError("truncated CSRC list")
        csrcs = struct.unpack_from(f">{cc}I", data, off) if cc else ()
        off += 4 * cc
        extension = None
        if b0 & 0x10:
            if len(data) < off + 4:
                raise RtpParseError("truncated extension header")
            profile, words = struct.unpack_from(">HH", data, off)
            off += 4
            if len(data) < off + 4 * words:
                raise RtpParseError("truncated extension data")
            extension = (profile, data[off:off + 4 * words])
            off += 4 * words
        end = len(data)
        padding = 0
        if b0 & 0x20:
            padding = data[-1]
            if padding == 0 or padding > end - off:
                raise RtpParseError("bad padding")
            end -= padding
        return RtpPacket(payload_type=b1 & 0x7F, seqnum=seq, timestamp=ts,
                         ssrc=ssrc, payload=data[off:end],
                         marker=bool(b1 & 0x80), csrcs=tuple(csrcs),
                         extension=extension, padding=padding)


# ---------------------------------------------------------------------------
# RTCP
# ---------------------------------------------------------------------------

RTCP_SR = 200
RTCP_RR = 201
RTCP_SDES = 202
RTCP_BYE = 203
RTCP_RTPFB = 205
RTCP_APP = 204


@dataclass
class ReportBlock:
    ssrc: int
    fraction_lost: int
    cumulative_lost: int
    ext_highest_seq: int
    jitter: int
    last_sr: int
    delay_since_last_sr: int

    def to_bytes(self) -> bytes:
        lost = self.cumulative_lost & 0xFFFFFF
        return struct.pack(">IIIIII", self.ssrc,
                           ((self.fraction_lost & 0xFF) << 24) | lost,
                           self.ext_highest_seq & 0xFFFFFFFF,
                           self.jitter & 0xFFFFFFFF, self.last_sr,
                           self.delay_since_last_sr)

    @staticmethod
    def parse(data: bytes, off: int) -> "ReportBlock":
        ssrc, fl, seq, jit, lsr, dlsr = struct.unpack_from(">IIIIII",
                                                           data, off)
        cum = fl & 0xFFFFFF
        if cum & 0x800000:
            cum -= 0x1000000
        return ReportBlock(ssrc, fl >> 24, cum, seq, jit, lsr, dlsr)


@dataclass
class SenderReport:
    ssrc: int
    ntp_timestamp: int      # 64-bit NTP
    rtp_timestamp: int
    packet_count: int
    octet_count: int
    reports: list[ReportBlock] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        body = struct.pack(">IQIII", self.ssrc, self.ntp_timestamp,
                           self.rtp_timestamp & 0xFFFFFFFF,
                           self.packet_count & 0xFFFFFFFF,
                           self.octet_count & 0xFFFFFFFF)
        body += b"".join(r.to_bytes() for r in self.reports)
        return _rtcp_header(RTCP_SR, len(self.reports), body) + body


@dataclass
class ReceiverReport:
    ssrc: int
    reports: list[ReportBlock] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        body = struct.pack(">I", self.ssrc)
        body += b"".join(r.to_bytes() for r in self.reports)
        return _rtcp_header(RTCP_RR, len(self.reports), body) + body


@dataclass
class Sdes:
    chunks: list[tuple[int, list[tuple[int, bytes]]]] \
        = field(default_factory=list)  # (ssrc, [(type, value)])

    CNAME = 1
    NAME = 2
    TOOL = 6

    def to_bytes(self) -> bytes:
        body = b""
        for ssrc, items in self.chunks:
            chunk = struct.pack(">I", ssrc)
            for t, v in items:
                chunk += bytes([t, len(v)]) + v
            chunk += b"\x00"
            while len(chunk) % 4:
                chunk += b"\x00"
            body += chunk
        return _rtcp_header(RTCP_SDES, len(self.chunks), body) + body


@dataclass
class Bye:
    ssrcs: list[int] = field(default_factory=list)
    reason: bytes = b""

    def to_bytes(self) -> bytes:
        body = b"".join(struct.pack(">I", s) for s in self.ssrcs)
        if self.reason:
            r = bytes([len(self.reason)]) + self.reason
            while len(r) % 4:
                r += b"\x00"
            body += r
        return _rtcp_header(RTCP_BYE, len(self.ssrcs), body) + body


@dataclass
class GenericNack:
    """RTCP transport-layer feedback Generic NACK (RFC 4585 §6.2.1,
    PT=205 FMT=1): the receiver's list of lost RTP sequence numbers,
    packed as PID + 16-bit following-loss bitmask FCI entries.  The
    retransmission request driving RFC 4588 RTX."""

    sender_ssrc: int
    media_ssrc: int
    lost: list[int] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        fci = b""
        seqs = sorted({s & 0xFFFF for s in self.lost})
        i = 0
        while i < len(seqs):
            pid = seqs[i]
            blp = 0
            j = i + 1
            while j < len(seqs) and 0 < seqs[j] - pid <= 16:
                blp |= 1 << (seqs[j] - pid - 1)
                j += 1
            fci += struct.pack(">HH", pid, blp)
            i = j
        body = struct.pack(">II", self.sender_ssrc,
                           self.media_ssrc) + fci
        return _rtcp_header(RTCP_RTPFB, 1, body) + body


def _rtcp_header(pt: int, count: int, body: bytes) -> bytes:
    length = (len(body) + 4) // 4 - 1
    return struct.pack(">BBH", (RTP_VERSION << 6) | (count & 0x1F), pt,
                       length)


def parse_rtcp(data: bytes) -> list:
    """Parse a compound RTCP packet into typed packets."""
    out = []
    off = 0
    while off + 4 <= len(data):
        b0, pt, length = struct.unpack_from(">BBH", data, off)
        if b0 >> 6 != RTP_VERSION:
            raise RtpParseError(f"bad RTCP version at offset {off}")
        count = b0 & 0x1F
        size = (length + 1) * 4
        if off + size > len(data):
            raise RtpParseError(
                f"truncated RTCP at offset {off}: claims {size} bytes, "
                f"{len(data) - off} available")
        body = data[off + 4: off + size]
        if pt == RTCP_SR:
            if len(body) < 24 + 24 * count:
                raise RtpParseError("truncated SR")
            ssrc, ntp, rtp_ts, pc, oc = struct.unpack_from(">IQIII", body)
            reports = [ReportBlock.parse(body, 24 + i * 24)
                       for i in range(count)]
            out.append(SenderReport(ssrc, ntp, rtp_ts, pc, oc, reports))
        elif pt == RTCP_RR:
            if len(body) < 4 + 24 * count:
                raise RtpParseError("truncated RR")
            (ssrc,) = struct.unpack_from(">I", body)
            reports = [ReportBlock.parse(body, 4 + i * 24)
                       for i in range(count)]
            out.append(ReceiverReport(ssrc, reports))
        elif pt == RTCP_SDES:
            chunks = []
            p = 0
            for _ in range(count):
                if p + 4 > len(body):
                    raise RtpParseError("truncated SDES")
                (ssrc,) = struct.unpack_from(">I", body, p)
                p += 4
                items = []
                while p < len(body) and body[p] != 0:
                    if p + 2 > len(body) \
                            or p + 2 + body[p + 1] > len(body):
                        raise RtpParseError("truncated SDES item")
                    t, ln = body[p], body[p + 1]
                    items.append((t, body[p + 2:p + 2 + ln]))
                    p += 2 + ln
                p += 1
                while p % 4:
                    p += 1
                chunks.append((ssrc, items))
            out.append(Sdes(chunks))
        elif pt == RTCP_RTPFB and count == 1:   # FMT=1: Generic NACK
            if len(body) < 8:
                raise RtpParseError("truncated NACK")
            sender, media = struct.unpack_from(">II", body)
            lost: list[int] = []
            for p in range(8, len(body) - 3, 4):
                pid, blp = struct.unpack_from(">HH", body, p)
                lost.append(pid)
                for b in range(16):
                    if blp & (1 << b):
                        lost.append((pid + b + 1) & 0xFFFF)
            out.append(GenericNack(sender, media, lost))
        elif pt == RTCP_BYE:
            if len(body) < 4 * count:
                raise RtpParseError("truncated BYE")
            ssrcs = [struct.unpack_from(">I", body, 4 * i)[0]
                     for i in range(count)]
            reason = b""
            if len(body) > 4 * count:
                ln = body[4 * count]
                reason = body[4 * count + 1:4 * count + 1 + ln]
            out.append(Bye(ssrcs, reason))
        off += size
    return out


def ntp_from_ns(t_ns: int) -> int:
    """Unix-epoch ns -> 64-bit NTP timestamp."""
    NTP_OFFSET = 2208988800  # seconds 1900 -> 1970
    secs, rem = divmod(t_ns, 1_000_000_000)
    frac = (rem << 32) // 1_000_000_000
    return ((secs + NTP_OFFSET) << 32) | frac


def ns_from_ntp(ntp: int) -> int:
    NTP_OFFSET = 2208988800
    secs = (ntp >> 32) - NTP_OFFSET
    frac = ntp & 0xFFFFFFFF
    return secs * 1_000_000_000 + (frac * 1_000_000_000 >> 32)
