"""Sans-IO RTP-over-QUIC (RoQ) framing, draft-ietf-avtcore-rtp-over-quic.

Rebuilds the framing layer of the reference quinnroqmux/quinnroqdemux
(net/quinn/src/quinnroqmux/imp.rs): datagram flows prepend a QUIC
varint flow-id to every RTP packet (imp.rs:421); stream flows send
the flow-id varint once, then varint-length-prefixed RTP packets
(imp.rs:486-531).  No QUIC transport here — callers own the sockets
(the env has no QUIC stack; see PARITY.md).

The port's copy of gstpu/net/roq.py, as it stands.
"""

from __future__ import annotations

# -- RFC 9000 variable-length integers ----------------------------------

def varint_size(v: int) -> int:
    if v < 1 << 6:
        return 1
    if v < 1 << 14:
        return 2
    if v < 1 << 30:
        return 4
    if v < 1 << 62:
        return 8
    raise ValueError("varint out of range")


def encode_varint(v: int) -> bytes:
    n = varint_size(v)
    prefix = {1: 0x00, 2: 0x40, 4: 0x80, 8: 0xC0}[n]
    out = v.to_bytes(n, "big")
    return bytes([out[0] | prefix]) + out[1:]


def decode_varint(data: bytes, pos: int = 0) -> tuple[int, int]:
    """-> (value, new_pos)."""
    first = data[pos]
    n = 1 << (first >> 6)
    if pos + n > len(data):
        raise ValueError("truncated varint")
    v = first & 0x3F
    for i in range(1, n):
        v = v << 8 | data[pos + i]
    return v, pos + n


# -- datagram mode --------------------------------------------------------

def mux_datagram(flow_id: int, rtp_packet: bytes) -> bytes:
    return encode_varint(flow_id) + rtp_packet


def demux_datagram(datagram: bytes) -> tuple[int, bytes]:
    flow_id, pos = decode_varint(datagram)
    return flow_id, datagram[pos:]


# -- stream mode ----------------------------------------------------------

class RoqStreamMux:
    """One QUIC stream carrying one flow: flow-id varint first, then
    length-prefixed packets."""

    def __init__(self, flow_id: int):
        self.flow_id = flow_id
        self._flow_id_sent = False

    def frame(self, rtp_packet: bytes) -> bytes:
        out = b""
        if not self._flow_id_sent:
            out += encode_varint(self.flow_id)
            self._flow_id_sent = True
        return out + encode_varint(len(rtp_packet)) + rtp_packet


class RoqStreamParser:
    """Incremental parser for the receive side of a stream flow."""

    def __init__(self):
        self.flow_id: int | None = None
        self._buf = b""

    def push(self, data: bytes) -> list[bytes]:
        """Feed stream bytes; returns complete RTP packets."""
        self._buf += data
        out = []
        pos = 0
        try:
            if self.flow_id is None:
                self.flow_id, pos = decode_varint(self._buf, pos)
            while pos < len(self._buf):
                length, after = decode_varint(self._buf, pos)
                if after + length > len(self._buf):
                    break
                out.append(self._buf[after:after + length])
                pos = after + length
        except (ValueError, IndexError):
            pass                          # wait for more bytes
        self._buf = self._buf[pos:]
        return out
