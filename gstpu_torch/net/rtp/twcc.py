"""Transport-wide congestion control (TWCC) wire format
(draft-holmer-rmcat-transport-wide-cc-extensions-01 — the format the
reference's rtpgccbwe consumes from webrtcbin, net/rtp/src/gcc/
imp.rs:7,329-503):

* RTP header extension: a transport-wide 16-bit sequence number the
  sender stamps on every packet.
* RTCP transport feedback message (PT=205 RTPFB, FMT=15): base seq,
  packet status chunks (run-length / 2-bit status vector), reference
  time in 64 ms units, receive deltas in 250 µs (small) or 250 µs
  signed 16-bit (large) resolution.

Sans-IO: TwccReceiver records arrivals and builds feedback packets;
TwccSender stamps outgoing seqnums and turns parsed feedback into the
PacketFeedback list gstpu.net.rtp.gcc consumes.

The port's copy of gstpu/net/rtp/twcc.py, as it stands.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

SECOND = 1_000_000_000
DELTA_UNIT_NS = 250_000              # 250 us
REF_UNIT_NS = 64_000_000             # 64 ms

# packet status symbols
NOT_RECEIVED = 0
RECEIVED_SMALL = 1                   # delta fits u8
RECEIVED_LARGE = 2                   # delta needs s16


class TwccError(ValueError):
    pass


@dataclass
class _Arrival:
    seq: int
    recv_time: int                   # ns


class TwccReceiver:
    """Receive side: record (transport seq, arrival ns), emit RTCP
    transport-feedback packets."""

    def __init__(self, sender_ssrc: int = 1, media_ssrc: int = 0):
        self.sender_ssrc = sender_ssrc
        self.media_ssrc = media_ssrc
        self._arrivals: dict[int, int] = {}
        self._base: int | None = None
        self._fb_count = 0

    def record(self, seq: int, recv_time_ns: int) -> None:
        seq &= 0xFFFF
        self._arrivals[seq] = recv_time_ns
        if self._base is None:
            self._base = seq

    def build_feedback(self) -> bytes | None:
        """One feedback packet covering everything recorded; clears
        the window."""
        if not self._arrivals:
            return None
        seqs = sorted(self._arrivals)
        base = seqs[0]
        count = seqs[-1] - base + 1
        if count > 0x7FFF:
            raise TwccError("feedback window too wide")
        ref_time_units = self._arrivals[base] // REF_UNIT_NS
        ref_ns = ref_time_units * REF_UNIT_NS

        symbols: list[int] = []
        deltas: list[tuple[int, int]] = []   # (symbol, delta units)
        prev_ns = ref_ns
        for seq in range(base, base + count):
            t = self._arrivals.get(seq & 0xFFFF)
            if t is None:
                symbols.append(NOT_RECEIVED)
                continue
            delta_units = round((t - prev_ns) / DELTA_UNIT_NS)
            if 0 <= delta_units <= 0xFF:
                sym = RECEIVED_SMALL
            elif -0x8000 <= delta_units <= 0x7FFF:
                sym = RECEIVED_LARGE
            else:
                raise TwccError(f"delta out of range: {delta_units}")
            symbols.append(sym)
            deltas.append((sym, delta_units))
            prev_ns = prev_ns + delta_units * DELTA_UNIT_NS

        # status chunks: 2-bit status vector, 7 symbols per chunk
        chunks = b""
        for i in range(0, len(symbols), 7):
            group = symbols[i:i + 7] + [0] * (7 - len(symbols[i:i + 7]))
            word = 0x8000 | 0x4000       # vector chunk, 2-bit symbols
            for j, sym in enumerate(group):
                word |= sym << (12 - 2 * j)
            chunks += struct.pack(">H", word)

        payload = struct.pack(">IIHH", self.sender_ssrc,
                              self.media_ssrc, base, count)
        payload += struct.pack(">I",
                               ((ref_time_units & 0xFFFFFF) << 8)
                               | (self._fb_count & 0xFF))
        payload += chunks
        for sym, d in deltas:
            if sym == RECEIVED_SMALL:
                payload += struct.pack(">B", d)
            else:
                payload += struct.pack(">h", d)
        pad = (-len(payload)) % 4
        payload += bytes(pad)
        length_words = len(payload) // 4 + 1
        hdr = struct.pack(">BBH", 0x80 | 15, 205, length_words)
        self._fb_count = (self._fb_count + 1) & 0xFF
        self._arrivals.clear()
        self._base = None
        return hdr + payload


def parse_feedback(data: bytes) -> list[tuple[int, int | None]]:
    """-> [(seq, recv_time_ns | None)] for every covered packet.
    recv times are absolute (reference time + cumulative deltas)."""
    if len(data) < 20:
        raise TwccError("short transport feedback")
    v_fmt, pt, _length = struct.unpack_from(">BBH", data, 0)
    if pt != 205 or (v_fmt & 0x1F) != 15:
        raise TwccError(f"not transport feedback (pt={pt}, "
                        f"fmt={v_fmt & 0x1F})")
    _sender, _media, base, count = struct.unpack_from(">IIHH", data, 4)
    word, = struct.unpack_from(">I", data, 16)
    ref_time_units = word >> 8
    if ref_time_units & 0x800000:        # sign-extend 24-bit
        ref_time_units -= 1 << 24
    pos = 20

    symbols: list[int] = []
    while len(symbols) < count:
        if pos + 2 > len(data):
            raise TwccError("truncated status chunks")
        chunk, = struct.unpack_from(">H", data, pos)
        pos += 2
        if chunk & 0x8000:               # status vector
            if chunk & 0x4000:           # 2-bit symbols, 7 per chunk
                for j in range(7):
                    symbols.append((chunk >> (12 - 2 * j)) & 0x3)
            else:                        # 1-bit symbols, 14 per chunk
                for j in range(14):
                    symbols.append(RECEIVED_SMALL
                                   if (chunk >> (13 - j)) & 1
                                   else NOT_RECEIVED)
        else:                            # run length
            sym = (chunk >> 13) & 0x3
            run = chunk & 0x1FFF
            symbols.extend([sym] * run)
    symbols = symbols[:count]

    out: list[tuple[int, int | None]] = []
    t_ns = ref_time_units * REF_UNIT_NS
    for i, sym in enumerate(symbols):
        seq = (base + i) & 0xFFFF
        if sym == NOT_RECEIVED:
            out.append((seq, None))
            continue
        if sym == RECEIVED_SMALL:
            if pos + 1 > len(data):
                raise TwccError("truncated deltas")
            d, = struct.unpack_from(">B", data, pos)
            pos += 1
        else:
            if pos + 2 > len(data):
                raise TwccError("truncated deltas")
            d, = struct.unpack_from(">h", data, pos)
            pos += 2
        t_ns += d * DELTA_UNIT_NS
        out.append((seq, t_ns))
    return out


class TwccSender:
    """Send side: stamp transport-wide seqnums, remember send times,
    convert parsed feedback into gcc PacketFeedback."""

    def __init__(self):
        self.next_seq = 0
        self._sent: dict[int, tuple[int, int]] = {}  # seq->(ns,size)

    def stamp(self, send_time_ns: int, size: int) -> int:
        seq = self.next_seq & 0xFFFF
        self.next_seq = (self.next_seq + 1) & 0xFFFF
        self._sent[seq] = (send_time_ns, size)
        if len(self._sent) > 4096:
            self._sent.pop(min(self._sent))
        return seq

    def on_feedback(self, data: bytes):
        """-> list[gstpu.net.rtp.gcc.PacketFeedback] for received
        packets covered by this feedback."""
        from gstpu_torch.net.rtp.gcc import PacketFeedback
        out = []
        for seq, recv_ns in parse_feedback(data):
            if recv_ns is None:
                continue
            sent = self._sent.pop(seq, None)
            if sent is None:
                continue
            out.append(PacketFeedback(send_time=sent[0],
                                      recv_time=recv_ns,
                                      size=sent[1]))
        return out
