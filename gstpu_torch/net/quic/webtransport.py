"""WebTransport over HTTP/3 (RFC 9220 / draft-ietf-webtrans-http3),
the session layer the reference's quinnwtsrc/quinnwtsink elements
speak (net/quinn/src/quinnwtsink/imp.rs, quinnwtsrc/imp.rs — there
via the web-transport-quinn crate).

Scope: the H3 subset WebTransport needs on top of gstpu's QUIC —
control streams carrying SETTINGS (ENABLE_CONNECT_PROTOCOL,
H3_DATAGRAM, ENABLE_WEBTRANSPORT), the extended CONNECT handshake
with QPACK literal-only field lines (RFC 9204 §4.5.6 — no dynamic
table, which QPACK explicitly permits), WT datagrams (quarter-
stream-id prefix, RFC 9297) and WT uni/bidi streams (stream type
0x54 / frame type 0x41 + session id).

Sans-IO like the rest of the stack: wrap a QuicConnection, call
pump() after the transport moves, read .session_ready / .events.

The port's copy of gstpu/net/quic/webtransport.py, as it stands.
"""

from __future__ import annotations

from gstpu_torch.net.quic.connection import QuicConnection
from gstpu_torch.net.quic.packet import QuicError, decode_varint, \
    encode_varint

# H3 frame types
H3_DATA = 0x00
H3_HEADERS = 0x01
H3_SETTINGS = 0x04

# H3 uni-stream types
H3_STREAM_CONTROL = 0x00
H3_STREAM_QPACK_ENC = 0x02
H3_STREAM_QPACK_DEC = 0x03
WT_STREAM_UNI = 0x54

WT_FRAME_BIDI = 0x41

# SETTINGS identifiers
SETTINGS_ENABLE_CONNECT_PROTOCOL = 0x08
SETTINGS_H3_DATAGRAM = 0x33
SETTINGS_ENABLE_WEBTRANSPORT = 0x2B603742
SETTINGS_WT_MAX_SESSIONS = 0xC671706A


class WtError(QuicError):
    pass


# ---------------------------------------------------------------------------
# QPACK (literal-only subset, RFC 9204)
# ---------------------------------------------------------------------------

def _qpack_int(value: int, prefix_bits: int, first_byte: int) -> bytes:
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first_byte | value])
    out = bytearray([first_byte | limit])
    value -= limit
    while value >= 0x80:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.append(value)
    return bytes(out)


def _qpack_read_int(data: bytes, pos: int, prefix_bits: int) \
        -> tuple[int, int]:
    if pos >= len(data):
        raise WtError("truncated QPACK integer")
    limit = (1 << prefix_bits) - 1
    v = data[pos] & limit
    pos += 1
    if v < limit:
        return v, pos
    shift = 0
    while True:
        if pos >= len(data) or shift > 62:
            raise WtError("truncated QPACK integer")
        b = data[pos]
        pos += 1
        v += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, pos


def qpack_encode(fields: list[tuple[str, str]]) -> bytes:
    """Encoded field section, literal-name literal-value only
    (RFC 9204 §4.5.6; required-insert-count=0, base=0)."""
    out = bytearray(b"\x00\x00")
    for name, value in fields:
        n, v = name.encode(), value.encode()
        # 001 N=0 H=0 + 3-bit name length
        out += _qpack_int(len(n), 3, 0x20)
        out += n
        out += _qpack_int(len(v), 7, 0x00)
        out += v
    return bytes(out)


def qpack_decode(data: bytes) -> list[tuple[str, str]]:
    fields = []
    pos = 2                              # insert count + base (0,0)
    while pos < len(data):
        b = data[pos]
        if b & 0xE0 == 0x20:             # literal w/ literal name
            if b & 0x08:
                raise WtError("huffman QPACK not supported")
            nlen, pos = _qpack_read_int(data, pos, 3)
            if pos + nlen > len(data):
                raise WtError("truncated QPACK name")
            name = data[pos:pos + nlen].decode()
            pos += nlen
            if pos >= len(data):
                raise WtError("truncated QPACK field")
            if data[pos] & 0x80:
                raise WtError("huffman QPACK not supported")
            vlen, pos = _qpack_read_int(data, pos, 7)
            if pos + vlen > len(data):
                raise WtError("truncated QPACK value")
            value = data[pos:pos + vlen].decode()
            pos += vlen
            fields.append((name, value))
        else:
            raise WtError(f"unsupported QPACK encoding {b:#x}")
    return fields


def _h3_frame(ftype: int, payload: bytes) -> bytes:
    return encode_varint(ftype) + encode_varint(len(payload)) + payload


def _settings_payload() -> bytes:
    out = b""
    for k, v in ((SETTINGS_ENABLE_CONNECT_PROTOCOL, 1),
                 (SETTINGS_H3_DATAGRAM, 1),
                 (SETTINGS_ENABLE_WEBTRANSPORT, 1),
                 (SETTINGS_WT_MAX_SESSIONS, 1)):
        out += encode_varint(k) + encode_varint(v)
    return out


class WebTransportSession:
    """One WT session over a QuicConnection.

    Drive: call pump() whenever the underlying connection may have
    produced events; it consumes conn.events() and refills .events
    with ("wt-datagram", bytes) / ("wt-stream", stream_id, bytes, fin)
    tuples once .session_ready.
    """

    def __init__(self, conn: QuicConnection, *,
                 authority: str = "localhost",
                 path: str = "/gstpu"):
        self.conn = conn
        self.authority = authority
        self.path = path
        self.session_ready = False
        self.session_id: int | None = None
        self.events: list[tuple] = []
        self._rx: dict[int, bytearray] = {}
        self._peer_settings: dict[int, int] | None = None
        self._started = False
        self._uni_types: dict[int, int | None] = {}

    # -- startup ----------------------------------------------------------
    def start(self) -> None:
        """Send the control stream; client also sends CONNECT."""
        if self._started:
            return
        self._started = True
        ctrl = self.conn.open_uni_stream()
        self.conn.send_stream(
            ctrl, encode_varint(H3_STREAM_CONTROL)
            + _h3_frame(H3_SETTINGS, _settings_payload()))
        if self.conn.is_client:
            sid = self.conn.open_stream()
            self.session_id = sid
            headers = qpack_encode([
                (":method", "CONNECT"),
                (":protocol", "webtransport"),
                (":scheme", "https"),
                (":authority", self.authority),
                (":path", self.path),
            ])
            self.conn.send_stream(sid, _h3_frame(H3_HEADERS, headers))

    # -- sending ----------------------------------------------------------
    def send_datagram(self, data: bytes) -> None:
        if not self.session_ready:
            raise WtError("session not ready")
        # RFC 9297: quarter stream id prefix
        self.conn.send_datagram(
            encode_varint(self.session_id // 4) + data)

    def open_wt_uni_stream(self) -> int:
        sid = self.conn.open_uni_stream()
        self.conn.send_stream(
            sid, encode_varint(WT_STREAM_UNI)
            + encode_varint(self.session_id))
        return sid

    def send_stream(self, sid: int, data: bytes,
                    fin: bool = False) -> None:
        self.conn.send_stream(sid, data, fin=fin)

    # -- receiving ----------------------------------------------------------
    def pump(self) -> None:
        for ev in self.conn.events():
            kind = ev[0]
            if kind == "stream":
                _, sid, data, fin = ev
                self._on_stream(sid, data, fin)
            elif kind == "datagram":
                self._on_datagram(ev[1])
            elif kind == "closed":
                self.events.append(ev)

    def _on_datagram(self, data: bytes) -> None:
        qsid, pos = decode_varint(data, 0)
        if self.session_id is not None \
                and qsid == self.session_id // 4:
            self.events.append(("wt-datagram", data[pos:]))

    def _on_stream(self, sid: int, data: bytes, fin: bool) -> None:
        buf = self._rx.setdefault(sid, bytearray())
        buf += data
        if sid % 4 >= 2:                 # peer uni stream
            self._on_uni(sid, buf, fin)
        else:
            self._on_bidi(sid, buf, fin)

    def _on_uni(self, sid: int, buf: bytearray, fin: bool) -> None:
        if sid not in self._uni_types:
            try:
                stype, pos = decode_varint(bytes(buf), 0)
            except QuicError:
                return
            self._uni_types[sid] = stype
            del buf[:pos]
            if stype == WT_STREAM_UNI:
                # session id follows
                ssid, pos = decode_varint(bytes(buf), 0)
                del buf[:pos]
        stype = self._uni_types[sid]
        if stype == H3_STREAM_CONTROL:
            self._parse_control(buf)
        elif stype == WT_STREAM_UNI:
            if buf or fin:
                self.events.append(("wt-stream", sid, bytes(buf),
                                    fin))
                del buf[:]
        # QPACK enc/dec streams: ignored (static-only)

    def _parse_control(self, buf: bytearray) -> None:
        while True:
            try:
                ftype, pos = decode_varint(bytes(buf), 0)
                flen, pos = decode_varint(bytes(buf), pos)
            except QuicError:
                return
            if len(buf) < pos + flen:
                return
            payload = bytes(buf[pos:pos + flen])
            del buf[:pos + flen]
            if ftype == H3_SETTINGS:
                st, p = {}, 0
                while p < len(payload):
                    k, p = decode_varint(payload, p)
                    v, p = decode_varint(payload, p)
                    st[k] = v
                self._peer_settings = st
                if not st.get(SETTINGS_ENABLE_WEBTRANSPORT):
                    raise WtError("peer does not enable WebTransport")

    def _on_bidi(self, sid: int, buf: bytearray, fin: bool) -> None:
        if not self.session_ready:
            # expect HEADERS (CONNECT request or response)
            try:
                ftype, pos = decode_varint(bytes(buf), 0)
                flen, pos = decode_varint(bytes(buf), pos)
            except QuicError:
                return
            if len(buf) < pos + flen:
                return
            payload = bytes(buf[pos:pos + flen])
            del buf[:pos + flen]
            if ftype != H3_HEADERS:
                raise WtError(f"expected HEADERS, got {ftype:#x}")
            fields = dict(qpack_decode(payload))
            if self.conn.is_client:
                if fields.get(":status") != "200":
                    raise WtError(
                        f"CONNECT rejected: {fields.get(':status')}")
                self.session_ready = True
                self.events.append(("wt-session",))
            else:
                if fields.get(":method") != "CONNECT" \
                        or fields.get(":protocol") != "webtransport":
                    raise WtError("not a WebTransport CONNECT")
                self.session_id = sid
                resp = qpack_encode([(":status", "200")])
                self.conn.send_stream(sid, _h3_frame(H3_HEADERS, resp))
                self.session_ready = True
                self.events.append(("wt-session",))
            return
        # session bidi stream data after CONNECT: WT bidi frames
        if sid == self.session_id:
            return                       # capsules: out of scope
        while True:
            if getattr(self, "_bidi_session_seen_%d" % sid, False):
                break
            try:
                ftype, pos = decode_varint(bytes(buf), 0)
            except QuicError:
                return
            if ftype == WT_FRAME_BIDI:
                _ssid, pos2 = decode_varint(bytes(buf), pos)
                del buf[:pos2]
                setattr(self, "_bidi_session_seen_%d" % sid, True)
            break
        if buf or fin:
            self.events.append(("wt-stream", sid, bytes(buf), fin))
            del buf[:]
