"""Sans-IO SCTP association + WebRTC data channels (DCEP).

Rebuilds the data-channel plane the reference gets from str0m /
the C webrtcbin's sctp stack (reference webrtcbin2 TODO notes it;
webrtcsink uses data channels for control):

* RFC 4960 subset: common header with CRC32c, INIT/INIT-ACK with
  state cookie, COOKIE-ECHO/COOKIE-ACK, DATA with TSN + per-stream
  ordering and B/E fragment reassembly, immediate SACK, ABORT,
  HEARTBEAT echo.
* RFC 8831/8832: DATA_CHANNEL_OPEN/ACK on PPID 50; string messages
  PPID 51, binary PPID 53. The DTLS client uses even stream ids,
  the server odd (RFC 8832 §6).

Sans-IO like the rest of gstpu's stack: handle_packet(bytes),
poll_transmit() -> bytes | None, .events list; rides inside DTLS
application-data records (RFC 8261) in WebRtcTransport.

The port's copy of gstpu/net/webrtc/sctp.py, as it stands.
"""

from __future__ import annotations

import os
import struct

# chunk types
CT_DATA = 0
CT_INIT = 1
CT_INIT_ACK = 2
CT_SACK = 3
CT_HEARTBEAT = 4
CT_HEARTBEAT_ACK = 5
CT_ABORT = 6
CT_COOKIE_ECHO = 10
CT_COOKIE_ACK = 11

PPID_DCEP = 50
PPID_STRING = 51
PPID_BINARY = 53

DCEP_OPEN = 0x03
DCEP_ACK = 0x02


class SctpError(ValueError):
    pass


# RFC 1982 serial-number arithmetic on 32-bit TSNs (RFC 4960 §1.6):
# plain integer compares break when the randomly-seeded TSN wraps.

def tsn_lt(a: int, b: int) -> bool:
    return 0 < ((b - a) & 0xFFFFFFFF) < 0x80000000


def tsn_lte(a: int, b: int) -> bool:
    return a == b or tsn_lt(a, b)


# ---------------------------------------------------------------------------
# CRC32c (Castagnoli), table-based — SCTP checksum (RFC 4960 App. B)
# ---------------------------------------------------------------------------

def _make_crc32c_table() -> list[int]:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _pad4(b: bytes) -> bytes:
    return b + bytes(-len(b) % 4)


class _Channel:
    def __init__(self, sid: int, label: str):
        self.sid = sid
        self.label = label
        self.open = False


class SctpAssociation:
    """One SCTP endpoint (client initiates)."""

    def __init__(self, *, client: bool, port: int = 5000):
        self.is_client = client
        self.port = port
        self.established = False
        self.events: list[tuple] = []
        self.channels: dict[int, _Channel] = {}
        self._outbox: list[bytes] = []
        self._my_vtag = struct.unpack(">I", os.urandom(4))[0] or 1
        self._peer_vtag = 0
        self._next_tsn = struct.unpack(">I", os.urandom(4))[0]
        self._cum_tsn: int | None = None       # last in-order peer TSN
        # tsn -> (flags, sid, ssn, ppid, payload); delivery is gated on
        # cumulative-TSN absorption, never on arrival order
        self._out_of_order: dict[int, tuple] = {}
        self._next_sid = 0 if client else 1
        self._next_ssn: dict[int, int] = {}
        # (sid, ssn) -> ordered fragment payloads of one user message
        self._reasm: dict[tuple[int, int], list[bytes]] = {}
        self._reasm_ppid: dict[tuple[int, int], int] = {}
        self._cookie_secret = os.urandom(8)
        # tsn -> DATA chunk bytes, held until the peer's SACK covers
        self._unacked: dict[int, bytes] = {}

    # -- wire helpers -----------------------------------------------------
    def _packet(self, chunks: bytes, vtag: int | None = None) -> bytes:
        hdr = struct.pack(">HHI", self.port, self.port,
                          self._peer_vtag if vtag is None else vtag)
        pkt = bytearray(hdr + struct.pack(">I", 0) + chunks)
        struct.pack_into("<I", pkt, 8, crc32c(bytes(pkt)))
        return bytes(pkt)

    def _chunk(self, ctype: int, flags: int, value: bytes) -> bytes:
        return _pad4(struct.pack(">BBH", ctype, flags,
                                 4 + len(value)) + value)

    def _send(self, chunks: bytes, vtag: int | None = None) -> None:
        self._outbox.append(self._packet(chunks, vtag))

    def poll_transmit(self) -> bytes | None:
        if self._outbox:
            return self._outbox.pop(0)
        return None

    # -- association bring-up --------------------------------------------
    def connect(self) -> None:
        assert self.is_client
        init = struct.pack(">IIHHI", self._my_vtag, 1 << 16, 16, 16,
                           self._next_tsn)
        # INIT carries vtag 0 in the common header
        self._send(self._chunk(CT_INIT, 0, init), vtag=0)

    def create_channel(self, label: str,
                       protocol: str = "") -> int:
        sid = self._next_sid
        self._next_sid += 2
        ch = _Channel(sid, label)
        self.channels[sid] = ch
        lab, proto = label.encode(), protocol.encode()
        body = struct.pack(">BBHIHH", DCEP_OPEN, 0x00, 0, 0,
                           len(lab), len(proto)) + lab + proto
        self._send_data(sid, PPID_DCEP, body)
        return sid

    def send(self, sid: int, data: bytes, *,
             binary: bool = True) -> None:
        if sid not in self.channels or not self.channels[sid].open:
            raise SctpError(f"channel {sid} not open")
        self._send_data(sid, PPID_BINARY if binary else PPID_STRING,
                        data)

    _FRAG = 1200          # payload bytes per DATA chunk

    def _send_data(self, sid: int, ppid: int, payload: bytes) -> None:
        ssn = self._next_ssn.get(sid, 0)
        self._next_ssn[sid] = (ssn + 1) & 0xFFFF
        pieces = [payload[i:i + self._FRAG]
                  for i in range(0, len(payload), self._FRAG)] \
            or [b""]
        last = len(pieces) - 1
        for i, piece in enumerate(pieces):
            flags = (0x02 if i == 0 else 0) | (0x01 if i == last
                                               else 0)
            tsn = self._next_tsn
            self._next_tsn = (self._next_tsn + 1) & 0xFFFFFFFF
            value = struct.pack(">IHHI", tsn, sid, ssn, ppid) + piece
            chunk = self._chunk(CT_DATA, flags, value)
            self._unacked[tsn] = chunk
            if len(self._unacked) > 4096:
                self._unacked.pop(min(self._unacked))
            self._send(chunk)

    def on_timeout(self) -> None:
        """Probe timeout: resend every DATA chunk not yet covered by
        a SACK (mirrors the QUIC endpoint's PTO; the receiver's TSN
        dedup makes spurious retransmissions harmless)."""
        if not self._unacked or not self.established:
            return
        for tsn in sorted(self._unacked):
            self._send(self._unacked[tsn])

    # -- receive ----------------------------------------------------------
    def handle_packet(self, data: bytes) -> None:
        if len(data) < 16:
            raise SctpError("short SCTP packet")
        sport, dport, vtag = struct.unpack_from(">HHI", data, 0)
        want_crc, = struct.unpack_from("<I", data, 8)
        zeroed = bytearray(data)
        struct.pack_into(">I", zeroed, 8, 0)
        if crc32c(bytes(zeroed)) != want_crc:
            raise SctpError("CRC32c mismatch")
        # RFC 4960 §8.5: except INIT (vtag 0), the verification tag
        # must match ours — spoofed packets are discarded
        is_init = len(data) >= 13 and data[12] == CT_INIT
        if not is_init and vtag != self._my_vtag:
            raise SctpError("verification tag mismatch")
        pos = 12
        while pos + 4 <= len(data):
            ctype, flags, clen = struct.unpack_from(">BBH", data, pos)
            if clen < 4:
                raise SctpError("bad chunk length")
            value = data[pos + 4:pos + clen]
            pos += (clen + 3) & ~3
            self._handle_chunk(ctype, flags, value)

    def _handle_chunk(self, ctype: int, flags: int,
                      value: bytes) -> None:
        if ctype == CT_INIT:
            (peer_tag, _rwnd, _no, _ni,
             peer_tsn) = struct.unpack_from(">IIHHI", value, 0)
            self._peer_vtag = peer_tag
            self._cum_tsn = (peer_tsn - 1) & 0xFFFFFFFF
            ack = struct.pack(">IIHHI", self._my_vtag, 1 << 16, 16,
                              16, self._next_tsn)
            cookie = os.urandom(16)     # stateful endpoint: opaque
            ack += struct.pack(">HH", 7, 4 + len(cookie)) + cookie
            self._send(self._chunk(CT_INIT_ACK, 0, ack))
        elif ctype == CT_INIT_ACK:
            (peer_tag, _rwnd, _no, _ni,
             peer_tsn) = struct.unpack_from(">IIHHI", value, 0)
            self._peer_vtag = peer_tag
            self._cum_tsn = (peer_tsn - 1) & 0xFFFFFFFF
            # extract the state cookie (param type 7) and echo it
            pos = 16
            cookie = b""
            while pos + 4 <= len(value):
                ptype, plen = struct.unpack_from(">HH", value, pos)
                if ptype == 7:
                    cookie = value[pos + 4:pos + plen]
                pos += (plen + 3) & ~3
            self._send(self._chunk(CT_COOKIE_ECHO, 0, cookie))
        elif ctype == CT_COOKIE_ECHO:
            self._send(self._chunk(CT_COOKIE_ACK, 0, b""))
            self._set_established()
        elif ctype == CT_COOKIE_ACK:
            self._set_established()
        elif ctype == CT_DATA:
            self._handle_data(flags, value)
        elif ctype == CT_SACK:
            cum_tsn, = struct.unpack_from(">I", value, 0)
            for tsn in [t for t in self._unacked
                        if tsn_lte(t, cum_tsn)]:
                del self._unacked[tsn]
        elif ctype == CT_HEARTBEAT:
            self._send(self._chunk(CT_HEARTBEAT_ACK, 0, value))
        elif ctype == CT_ABORT:
            self.established = False
            self.events.append(("closed",))

    def _set_established(self) -> None:
        if not self.established:
            self.established = True
            self.events.append(("established",))

    _OOO_CAP = 8192       # out-of-order buffer bound (peer OOM guard)

    def _handle_data(self, flags: int, value: bytes) -> None:
        tsn, sid, ssn, ppid = struct.unpack_from(">IHHI", value, 0)
        payload = value[12:]
        if self._cum_tsn is None:
            # DATA before INIT/INIT-ACK seeded the TSN base: seeding
            # from an arbitrary (possibly reordered) first-seen TSN
            # would permanently mark earlier TSNs duplicate — drop and
            # rely on the peer's retransmission after establishment
            return
        if tsn_lte(tsn, self._cum_tsn) or tsn in self._out_of_order:
            # duplicate (spurious retransmission): re-SACK, don't
            # re-deliver
            self._send_sack()
            return
        # buffer, then absorb strictly in TSN order — out-of-order
        # chunks are never delivered on arrival (fragments of one
        # message must reassemble in TSN order, RFC 4960 §6.9)
        self._out_of_order[tsn] = (flags, sid, ssn, ppid, payload)
        if len(self._out_of_order) > self._OOO_CAP:
            # drop the chunk serially furthest from cum_tsn
            far = max(self._out_of_order,
                      key=lambda t: (t - self._cum_tsn) & 0xFFFFFFFF)
            self._out_of_order.pop(far)
        while ((self._cum_tsn + 1) & 0xFFFFFFFF) in self._out_of_order:
            self._cum_tsn = (self._cum_tsn + 1) & 0xFFFFFFFF
            self._absorb(*self._out_of_order.pop(self._cum_tsn))
        self._send_sack()

    def _send_sack(self) -> None:
        sack = struct.pack(">IIHH", self._cum_tsn, 1 << 16, 0, 0)
        self._send(self._chunk(CT_SACK, 0, sack))

    def _absorb(self, flags: int, sid: int, ssn: int, ppid: int,
                payload: bytes) -> None:
        """Process one DATA chunk in cumulative TSN order."""
        begin, end = flags & 0x02, flags & 0x01
        if begin and end:
            self._deliver(sid, ppid, payload)
            return
        key = (sid, ssn)
        if begin:
            self._reasm[key] = [payload]
            self._reasm_ppid[key] = ppid
            return
        frags = self._reasm.get(key)
        if frags is None:
            return              # middle/end without a begin: drop
        frags.append(payload)
        if end:
            ppid0 = self._reasm_ppid.pop(key, ppid)
            self._deliver(sid, ppid0, b"".join(self._reasm.pop(key)))

    def _deliver(self, sid: int, ppid: int, payload: bytes) -> None:
        if ppid == PPID_DCEP:
            if payload and payload[0] == DCEP_OPEN:
                _t, _ct, _prio, _rel, lab_len, proto_len = \
                    struct.unpack_from(">BBHIHH", payload, 0)
                label = payload[12:12 + lab_len].decode()
                ch = _Channel(sid, label)
                ch.open = True
                self.channels[sid] = ch
                self._send_data(sid, PPID_DCEP, bytes([DCEP_ACK]))
                self.events.append(("channel-open", sid, label))
            elif payload and payload[0] == DCEP_ACK:
                ch = self.channels.get(sid)
                if ch is not None and not ch.open:
                    ch.open = True
                    self.events.append(("channel-open", sid,
                                        ch.label))
            return
        self.events.append(("message", sid, ppid, payload))
