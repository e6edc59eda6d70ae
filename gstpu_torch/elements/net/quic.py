"""quinnquicsrc / quinnquicsink: QUIC transport elements over the
sans-IO QUIC v1 stack (gstpu/net/quic/).

Rebuilds the reference's quinn crate transport elements
(net/quinn/src/quinnquicsink/imp.rs, quinnquicsrc/imp.rs): a sink
sends buffers over one QUIC connection as DATAGRAM frames
(use-datagram=true, RFC 9221) or as one length-delimited stream; the
src is the mirror. Roles: the sink defaults to the QUIC client and
the src to the server (matching the reference's default
server/client split), switchable via the `role` property.

Certificate trust is fingerprint-pinned (webrtc-style), matching the
reference's secure-connection properties (certificate-file /
private-key-file / secure-connection); full webpki chains are out of
scope in this environment.

The port's copy of gstpu/elements/net/quic.py, as it stands.
"""

from __future__ import annotations

import socket
import time

from gstpu_torch.core.base import BaseSink, PushSrc
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element


class _Endpoint:
    """One UDP socket + one QuicConnection, pumped cooperatively."""

    def __init__(self, conn, sock: socket.socket,
                 peer: tuple[str, int] | None):
        self.conn = conn
        self.sock = sock
        self.peer = peer

    def pump(self) -> None:
        # outbound first (handshake flights), then inbound
        while (d := self.conn.poll_transmit()) is not None:
            if self.peer is not None:
                self.sock.sendto(d, self.peer)
        for _ in range(64):
            try:
                data, addr = self.sock.recvfrom(65536)
            except BlockingIOError:
                break
            except OSError:
                break
            if self.peer is None:
                self.peer = addr
            self.conn.handle_datagram(data)
        while (d := self.conn.poll_transmit()) is not None:
            if self.peer is not None:
                self.sock.sendto(d, self.peer)

    def wait_connected(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        next_pto = time.monotonic() + 0.2
        while time.monotonic() < deadline:
            self.pump()
            if self.conn.connected:
                return True
            if time.monotonic() >= next_pto:
                # handshake datagram lost: probe-retransmit
                self.conn.on_timeout()
                next_pto = time.monotonic() + 0.2
            time.sleep(0.002)
        return self.conn.connected

    def close(self) -> None:
        try:
            self.conn.close()
            self.pump()
        except Exception:
            pass
        self.sock.close()


def _make_endpoint(*, client: bool, address: str, port: int,
                   bind_port: int = 0,
                   remote_fingerprint: str | None = None,
                   certificate=None, alpn: str = "gstpu-quic") \
        -> _Endpoint:
    from gstpu_torch.net.quic.connection import QuicConnection
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:                        # burst tolerance (kernel may clamp)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                        4 << 20)
    except OSError:
        pass
    if client:
        sock.bind(("0.0.0.0", 0))
        peer = (address, port)
    else:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((address, bind_port if bind_port else port))
        peer = None
    sock.setblocking(False)
    conn = QuicConnection(client=client, alpn=alpn,
                          certificate=certificate,
                          remote_fingerprint=remote_fingerprint)
    ep = _Endpoint(conn, sock, peer)
    if client:
        conn.connect()
        ep.pump()
    return ep


def _load_cert_files(cert_file: str | None,
                     key_file: str | None):
    """PEM certificate-file/private-key-file -> the (key, cert) pair
    the TLS 1.3 layer takes (reference quinn certificate-file /
    private-key-file; None = per-connection self-signed)."""
    if not (cert_file and key_file):
        return None
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization
    key = serialization.load_pem_private_key(
        open(key_file, "rb").read(), password=None)
    cert = x509.load_pem_x509_certificate(
        open(cert_file, "rb").read())
    return key, cert


@register_element("quinnquicsink", Rank.NONE)
class QuinnQuicSink(BaseSink):
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS, Caps.any())]

    address = Property(str, default="127.0.0.1",
                       mutable=Mutability.READY)
    port = Property(int, default=5006, minimum=0, maximum=65535,
                    mutable=Mutability.READY)
    role = Property(str, default="client", mutable=Mutability.READY,
                    blurb="client|server")
    use_datagram = Property(bool, default=False,
                            mutable=Mutability.READY)
    certificate_fingerprint = Property(
        str, default=None, mutable=Mutability.READY,
        blurb="pin the peer certificate (sha-256 hex)")
    certificate_file = Property(
        str, default="", mutable=Mutability.READY,
        blurb="PEM certificate presented to the peer (reference "
              "certificate-file); empty = per-connection self-signed")
    private_key_file = Property(
        str, default="", mutable=Mutability.READY,
        blurb="PEM private key for certificate-file")
    secure_connection = Property(
        bool, default=True, mutable=Mutability.READY,
        blurb="Verify the peer certificate (reference "
              "secure-connection). Trust here is sha-256 pinning via "
              "certificate-fingerprint (no webpki root store in this "
              "environment — disclosed boundary); false = accept any "
              "peer even when a pin is configured")
    alpn = Property(str, default="gstpu-quic",
                    mutable=Mutability.READY)
    timeout = Property(float, default=5.0, minimum=0.0)

    def __init__(self, name=None):
        super().__init__(name)
        self._ep: _Endpoint | None = None
        self._stream_id: int | None = None
        self._mux_streams: dict[int, int] = {}   # flow id -> QUIC sid
        self.sent = 0

    def start(self) -> bool:
        self._ep = _make_endpoint(
            client=self.role == "client", address=self.address,
            port=self.port,
            remote_fingerprint=(self.certificate_fingerprint
                                if self.secure_connection else None),
            certificate=_load_cert_files(self.certificate_file,
                                         self.private_key_file),
            alpn=self.alpn)
        return True

    @property
    def local_fingerprint(self) -> str:
        return self._ep.conn.tls.local_fingerprint

    def stop(self) -> bool:
        if self._ep:
            self._ep.close()
            self._ep = None
        return True

    def render(self, buf: Buffer):
        ep = self._ep
        if not ep.conn.connected \
                and not ep.wait_connected(self.timeout):
            raise FlowError(FlowReturn.ERROR,
                            "QUIC handshake timed out")
        data = buf.to_bytes()
        meta = buf.get_meta(QuinnQuicMeta)
        if self.use_datagram or (meta is not None
                                 and meta.is_datagram):
            ep.conn.send_datagram(data)
        else:
            from gstpu_torch.net.quic.packet import encode_varint
            if meta is not None:
                # quinnquicmux tagged the buffer: route per stream id
                sid = self._mux_streams.get(meta.stream_id)
                if sid is None:
                    sid = ep.conn.open_stream()
                    self._mux_streams[meta.stream_id] = sid
            else:
                if self._stream_id is None:
                    self._stream_id = ep.conn.open_stream()
                sid = self._stream_id
            # length-delimited so the src can re-frame buffers
            ep.conn.send_stream(sid, encode_varint(len(data)) + data)
        ep.pump()
        self.sent += 1
        return FlowReturn.OK

    def on_eos(self):
        ep = self._ep
        if ep is not None and ep.conn.connected:
            if not self.use_datagram and self._stream_id is not None:
                ep.conn.send_stream(self._stream_id, b"", fin=True)
            # reliable drain: probe-retransmit until everything is
            # acked (datagrams are fire-and-forget by design)
            deadline = time.monotonic() + self.timeout
            next_pto = time.monotonic() + 0.05
            while time.monotonic() < deadline:
                ep.pump()
                if not any(sp.unacked
                           for sp in ep.conn._spaces.values()):
                    break
                if time.monotonic() >= next_pto:
                    ep.conn.on_timeout()
                    next_pto = time.monotonic() + 0.05
                time.sleep(0.002)


@register_element("quinnquicsrc", Rank.NONE)
class QuinnQuicSrc(PushSrc):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS, Caps.any())]

    address = Property(str, default="0.0.0.0",
                       mutable=Mutability.READY)
    port = Property(int, default=5006, minimum=0, maximum=65535,
                    mutable=Mutability.READY)
    role = Property(str, default="server", mutable=Mutability.READY)
    caps = Property(Caps, default=None, mutable=Mutability.READY)
    certificate_fingerprint = Property(str, default=None,
                                       mutable=Mutability.READY)
    certificate_file = Property(
        str, default="", mutable=Mutability.READY,
        blurb="PEM certificate presented to the peer (reference "
              "certificate-file); empty = per-connection self-signed")
    private_key_file = Property(
        str, default="", mutable=Mutability.READY,
        blurb="PEM private key for certificate-file")
    secure_connection = Property(
        bool, default=True, mutable=Mutability.READY,
        blurb="Verify the peer via certificate-fingerprint pinning "
              "(reference secure-connection; boundary as on "
              "quinnquicsink); false = accept any peer")
    alpn = Property(str, default="gstpu-quic",
                    mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._ep: _Endpoint | None = None
        self._queue: list[tuple[bytes, int | None]] = []
        self._stream_bufs: dict[int, bytearray] = {}
        self._fins: set[int] = set()
        self._closed = False
        self.is_live = True

    def start(self) -> bool:
        self._ep = _make_endpoint(
            client=self.role == "client", address=self.address,
            port=self.port,
            remote_fingerprint=(self.certificate_fingerprint
                                if self.secure_connection else None),
            certificate=_load_cert_files(self.certificate_file,
                                         self.private_key_file),
            alpn=self.alpn)
        return True

    @property
    def local_fingerprint(self) -> str:
        return self._ep.conn.tls.local_fingerprint

    @property
    def bound_port(self) -> int:
        return self._ep.sock.getsockname()[1] if self._ep else 0

    def stop(self) -> bool:
        if self._ep:
            self._ep.close()
            self._ep = None
        return True

    def negotiate(self) -> Caps:
        return self.caps if self.caps is not None \
            else Caps.new("application/octet-stream")

    def _drain_stream_buf(self, sid: int) -> None:
        from gstpu_torch.net.quic.packet import QuicError, decode_varint
        buf = self._stream_bufs[sid]
        while buf:
            try:
                ln, pos = decode_varint(bytes(buf), 0)
            except QuicError:
                return
            if len(buf) < pos + ln:
                return
            self._queue.append((bytes(buf[pos:pos + ln]), sid))
            del buf[:pos + ln]

    def create(self) -> Buffer | None:
        ep = self._ep
        ep.pump()
        for ev in ep.conn.events():
            kind = ev[0]
            if kind == "datagram":
                self._queue.append((ev[1], None))
            elif kind == "stream":
                _, sid, data, fin = ev
                self._stream_bufs.setdefault(sid, bytearray()) \
                    .extend(data)
                self._drain_stream_buf(sid)
                if fin:
                    self._fins.add(sid)
            elif kind == "closed":
                self._closed = True
        if self._queue:
            data, sid = self._queue.pop(0)
            buf = Buffer(data)
            if self.clock is not None:
                buf.pts = self.running_time()
            # tag so quinnquicdemux can fan flows back out
            buf.add_meta(QuinnQuicMeta(
                sid if sid is not None else 0, sid is None))
            return buf
        if self._closed or (self._fins
                            and self._fins >= set(self._stream_bufs)):
            return None                      # EOS
        raise FlowError(FlowReturn.FLUSHING, "no QUIC data yet")


# ---------------------------------------------------------------------------
# stream multiplexing (quinnquicmux / quinnquicdemux)
# ---------------------------------------------------------------------------

from gstpu_torch.core.buffer import Meta  # noqa: E402
from gstpu_torch.core.element import (Element, Pad,  # noqa: E402
                                      PadPresence as _PP)
from gstpu_torch.core.event import (CapsEvent, Event, Segment,  # noqa: E402
                                    SegmentEvent, StreamStartEvent)


class QuinnQuicMeta(Meta):
    """Buffer meta naming the QUIC stream (or datagram flow) a buffer
    belongs to (reference net/quinn/src/quinnquicmeta)."""

    def __init__(self, stream_id: int, is_datagram: bool = False):
        self.stream_id = stream_id
        self.is_datagram = is_datagram


@register_element("quinnquicmux", Rank.NONE)
class QuinnQuicMux(Element):
    """Multiplex N inputs onto one QUIC-bound output: each `stream_%u`
    request pad tags its buffers with a QuinnQuicMeta carrying the pad's
    stream id, the `datagram` pad tags is_datagram (reference
    net/quinn/src/quinnquicmux/imp.rs:163-372)."""

    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("application/x-quinn")),
        PadTemplate("stream_%u", PadDirection.SINK, _PP.REQUEST,
                    Caps.any()),
        PadTemplate("datagram", PadDirection.SINK, _PP.REQUEST,
                    Caps.any()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self.srcpad = self.static_pad("src")
        self._next_stream = 0
        self._started = False

    def request_pad(self, name=None):
        if name == "datagram":
            tmpl = self.PAD_TEMPLATES[2]
            pad = Pad("datagram", PadDirection.SINK, tmpl, self)
            pad.quic_stream_id = 0
            pad.quic_datagram = True
        else:
            tmpl = self.PAD_TEMPLATES[1]
            if name and name.startswith("stream_"):
                sid = int(name.split("_", 1)[1])
            else:
                sid = self._next_stream
            self._next_stream = max(self._next_stream, sid + 1)
            pad = Pad(f"stream_{sid}", PadDirection.SINK, tmpl, self)
            pad.quic_stream_id = sid
            pad.quic_datagram = False
        pad.chain_function = self._chain
        pad.event_function = self._event
        self.add_pad(pad)
        return pad

    def _ensure_started(self):
        if not self._started:
            self._started = True
            self.srcpad.push_event(StreamStartEvent(self.name))
            self.srcpad.push_event(
                CapsEvent(Caps.new("application/x-quinn")))
            self.srcpad.push_event(SegmentEvent(Segment()))

    def _chain(self, pad: Pad, buf: Buffer):
        self._ensure_started()
        buf.add_meta(QuinnQuicMeta(pad.quic_stream_id,
                                   pad.quic_datagram))
        return self.srcpad.push(buf)

    def _event(self, pad: Pad, ev: Event) -> bool:
        from gstpu_torch.core.event import EosEvent
        if isinstance(ev, EosEvent):
            # EOS once every sink pad saw EOS
            pad.quic_eos = True
            if all(getattr(p, "quic_eos", False)
                   for p in self.sink_pads()):
                return self.srcpad.push_event(ev)
            return True
        if ev.serialized:
            return True                 # per-pad caps/segment stay local
        return self.srcpad.push_event(ev)


@register_element("quinnquicdemux", Rank.NONE)
class QuinnQuicDemux(Element):
    """Demultiplex a QUIC-tagged stream: one sometimes src pad per
    stream id (`stream_%u`) plus a `datagram` pad (reference
    net/quinn/src/quinnquicdemux/imp.rs)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("stream_%u", PadDirection.SRC, _PP.SOMETIMES,
                    Caps.any()),
        PadTemplate("datagram", PadDirection.SRC, _PP.SOMETIMES,
                    Caps.any()),
    ]
    SIGNALS = ("pad-added",)

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._pads: dict[tuple[bool, int], Pad] = {}

    def _out_pad(self, is_datagram: bool, sid: int) -> Pad:
        key = (is_datagram, sid)
        pad = self._pads.get(key)
        if pad is None:
            name = "datagram" if is_datagram else f"stream_{sid}"
            tmpl = self.PAD_TEMPLATES[2 if is_datagram else 1]
            pad = Pad(name, PadDirection.SRC, tmpl, self)
            self.add_pad(pad)
            self._pads[key] = pad
            self.emit("pad-added", pad)
            pad.push_event(StreamStartEvent(f"{self.name}/{name}"))
            pad.push_event(CapsEvent(Caps.new(
                "application/octet-stream")))
            pad.push_event(SegmentEvent(Segment()))
        return pad

    def _chain(self, pad: Pad, buf: Buffer):
        meta = buf.get_meta(QuinnQuicMeta)
        if meta is None:
            out = self._out_pad(False, 0)
        else:
            out = self._out_pad(meta.is_datagram, meta.stream_id)
        return out.push(buf)

    def _event(self, pad: Pad, ev: Event) -> bool:
        from gstpu_torch.core.event import EosEvent
        if isinstance(ev, EosEvent):
            ok = True
            for p in self._pads.values():
                ok = p.push_event(ev) and ok
            return ok
        if ev.serialized:
            return True
        ok = True
        for p in self._pads.values():
            ok = p.push_event(ev) and ok
        return ok


# ---------------------------------------------------------------------------
# WebTransport elements (quinnwtserversink/quinnwtsink,
# quinnwtclientsrc/quinnwtsrc)
# ---------------------------------------------------------------------------

class _WtEndpoint(_Endpoint):
    """Endpoint whose connection carries a WebTransport session."""

    def __init__(self, conn, sock, peer, *, authority, path):
        super().__init__(conn, sock, peer)
        from gstpu_torch.net.quic.webtransport import WebTransportSession
        self.wt = WebTransportSession(conn, authority=authority,
                                      path=path)

    def pump(self) -> None:
        super().pump()
        self.wt.pump()
        super().pump()                   # flush WT responses

    def wait_session(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.pump()
            if self.wt.session_ready:
                return True
            time.sleep(0.002)
        return self.wt.session_ready


def _make_wt_endpoint(*, client: bool, address: str, port: int,
                      remote_fingerprint=None, authority="localhost",
                      path="/gstpu") -> _WtEndpoint:
    from gstpu_torch.net.quic.connection import QuicConnection
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    if client:
        sock.bind(("0.0.0.0", 0))
        peer = (address, port)
    else:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((address, port))
        peer = None
    sock.setblocking(False)
    conn = QuicConnection(client=client, alpn="h3",
                          remote_fingerprint=remote_fingerprint)
    ep = _WtEndpoint(conn, sock, peer, authority=authority, path=path)
    ep.wt.start()                        # queue control stream (+CONNECT)
    if client:
        conn.connect()
        ep.pump()
    return ep


@register_element("quinnwtserversink", Rank.NONE)
@register_element("quinnwtsink", Rank.NONE)
class QuinnWtSink(BaseSink):
    """WebTransport server sink: accepts one WT session and sends
    each buffer as a WT datagram (use-datagram=true) or over one WT
    uni stream, length-delimited (reference
    net/quinn/src/quinnwtsink/imp.rs; registered as both quinnwtsink
    and quinnwtserversink, mod.rs:34-44)."""

    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS, Caps.any())]

    address = Property(str, default="0.0.0.0",
                       mutable=Mutability.READY)
    port = Property(int, default=5008, minimum=0, maximum=65535,
                    mutable=Mutability.READY)
    use_datagram = Property(bool, default=False,
                            mutable=Mutability.READY)
    timeout = Property(float, default=5.0, minimum=0.0)

    def __init__(self, name=None):
        super().__init__(name)
        self._ep: _WtEndpoint | None = None
        self._wt_stream: int | None = None
        self.sent = 0

    def start(self) -> bool:
        self._ep = _make_wt_endpoint(
            client=False, address=self.address, port=self.port)
        return True

    @property
    def local_fingerprint(self) -> str:
        return self._ep.conn.tls.local_fingerprint

    @property
    def bound_port(self) -> int:
        return self._ep.sock.getsockname()[1] if self._ep else 0

    def stop(self) -> bool:
        if self._ep:
            self._ep.close()
            self._ep = None
        return True

    def render(self, buf: Buffer):
        ep = self._ep
        if not ep.wt.session_ready \
                and not ep.wait_session(self.timeout):
            raise FlowError(FlowReturn.ERROR,
                            "no WebTransport session")
        data = buf.to_bytes()
        if self.use_datagram:
            ep.wt.send_datagram(data)
        else:
            from gstpu_torch.net.quic.packet import encode_varint
            if self._wt_stream is None:
                self._wt_stream = ep.wt.open_wt_uni_stream()
            ep.wt.send_stream(self._wt_stream,
                              encode_varint(len(data)) + data)
        ep.pump()
        self.sent += 1
        return FlowReturn.OK

    def on_eos(self):
        ep = self._ep
        if ep is not None and self._wt_stream is not None:
            ep.wt.send_stream(self._wt_stream, b"", fin=True)
            ep.pump()


@register_element("quinnwtclientsrc", Rank.NONE)
@register_element("quinnwtsrc", Rank.NONE)
class QuinnWtSrc(PushSrc):
    """WebTransport client source: connects, performs the extended
    CONNECT, and yields WT datagrams / uni-stream buffers (reference
    net/quinn/src/quinnwtsrc/imp.rs; quinnwtsrc + quinnwtclientsrc)."""

    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS, Caps.any())]

    address = Property(str, default="127.0.0.1",
                       mutable=Mutability.READY)
    port = Property(int, default=5008, minimum=0, maximum=65535,
                    mutable=Mutability.READY)
    url_path = Property(str, default="/gstpu",
                        mutable=Mutability.READY)
    caps = Property(Caps, default=None, mutable=Mutability.READY)
    certificate_fingerprint = Property(str, default=None,
                                       mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._ep: _WtEndpoint | None = None
        self._queue: list[bytes] = []
        self._stream_buf = bytearray()
        self._fin = False
        self.is_live = True

    def start(self) -> bool:
        self._ep = _make_wt_endpoint(
            client=True, address=self.address, port=self.port,
            remote_fingerprint=self.certificate_fingerprint,
            path=self.url_path)
        return True

    def stop(self) -> bool:
        if self._ep:
            self._ep.close()
            self._ep = None
        return True

    def negotiate(self) -> Caps:
        return self.caps if self.caps is not None \
            else Caps.new("application/octet-stream")

    def _drain_stream_buf(self) -> None:
        from gstpu_torch.net.quic.packet import QuicError, decode_varint
        while self._stream_buf:
            try:
                ln, pos = decode_varint(bytes(self._stream_buf), 0)
            except QuicError:
                return
            if len(self._stream_buf) < pos + ln:
                return
            self._queue.append(bytes(self._stream_buf[pos:pos + ln]))
            del self._stream_buf[:pos + ln]

    def create(self) -> Buffer | None:
        ep = self._ep
        ep.pump()
        for ev in ep.wt.events:
            kind = ev[0]
            if kind == "wt-datagram":
                self._queue.append(ev[1])
            elif kind == "wt-stream":
                _, _sid, data, fin = ev
                self._stream_buf += data
                self._drain_stream_buf()
                if fin:
                    self._fin = True
            elif kind == "closed":
                self._fin = True
        ep.wt.events.clear()
        if self._queue:
            buf = Buffer(self._queue.pop(0))
            if self.clock is not None:
                buf.pts = self.running_time()
            return buf
        if self._fin:
            return None
        raise FlowError(FlowReturn.FLUSHING, "no WT data yet")
