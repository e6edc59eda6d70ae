"""rtspsrc2: RTSP 1.0 client source (TCP-interleaved or UDP
transport).

Rebuilds the reference's RTSP client rewrite (net/rtsp rtspsrc2)
control-protocol core: OPTIONS/DESCRIBE (SDP parse) /SETUP/PLAY over
one TCP connection with RTP delivered as RFC 2326 §10.12 interleaved
frames ('$' channel len payload), pushed as application/x-rtp buffers.
UDP transport and seeking are round-2 items; the protocol state
machine and SDP track selection live here.

The port's copy of gstpu/elements/net/rtsp.py, as it stands.
"""

from __future__ import annotations

import socket
from urllib.parse import urlparse

from gstpu_torch.core.base import PushSrc
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps, Structure
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element


def parse_sdp_media(sdp: str) -> list[dict]:
    """Extract media sections: kind, payload type, encoding, control."""
    out = []
    cur: dict | None = None
    for line in sdp.splitlines():
        line = line.strip()
        if line.startswith("m="):
            parts = line[2:].split()
            cur = {"kind": parts[0], "payload": int(parts[3])
                   if len(parts) > 3 else 96, "control": "",
                   "encoding": "", "clock-rate": 90000}
            out.append(cur)
        elif cur is not None and line.startswith("a=rtpmap:"):
            _, enc = line.split(":", 1)[1].split(" ", 1)
            name, _, rest = enc.partition("/")
            cur["encoding"] = name
            if rest:
                cur["clock-rate"] = int(rest.split("/")[0])
        elif cur is not None and line.startswith("a=control:"):
            cur["control"] = line.split(":", 1)[1]
    return out


class RtspConnection:
    """Blocking RTSP control connection + interleaved data demux.

    Authentication (reference rtspsrc2 0.15.3 feature set): URL
    userinfo credentials drive automatic Basic and Digest
    (RFC 7616, MD5) retries on 401."""

    def __init__(self, url: str, timeout: float = 5.0):
        self.url = url
        u = urlparse(url)
        self.username = u.username
        self.password = u.password
        if u.username:
            # strip userinfo from the request URL
            netloc = u.hostname + (f":{u.port}" if u.port else "")
            self.url = u._replace(netloc=netloc).geturl()
        self.sock = socket.create_connection(
            (u.hostname, u.port or 554), timeout=timeout)
        self._cseq = 0
        self._buf = b""
        self.session: str | None = None
        self._auth_header: str | None = None
        self._digest_challenge: dict | None = None
        # interleaved frames that arrive while waiting for a control
        # response are queued, not dropped (keep-alive/seek must not
        # eat media)
        from collections import deque
        self._pending_frames: deque = deque()

    def _authorization(self, method: str, url: str) -> str | None:
        if self._digest_challenge is not None:
            import hashlib
            ch = self._digest_challenge
            realm, nonce = ch.get("realm", ""), ch.get("nonce", "")
            ha1 = hashlib.md5(
                f"{self.username}:{realm}:{self.password}"
                .encode()).hexdigest()
            ha2 = hashlib.md5(f"{method}:{url}".encode()).hexdigest()
            resp = hashlib.md5(
                f"{ha1}:{nonce}:{ha2}".encode()).hexdigest()
            return (f'Digest username="{self.username}", '
                    f'realm="{realm}", nonce="{nonce}", '
                    f'uri="{url}", response="{resp}"')
        return self._auth_header

    def _parse_challenge(self, www: str) -> None:
        if www.lower().startswith("basic"):
            import base64
            tok = base64.b64encode(
                f"{self.username}:{self.password}".encode()).decode()
            self._auth_header = f"Basic {tok}"
            self._digest_challenge = None
        elif www.lower().startswith("digest"):
            fields = {}
            for part in www[7:].split(","):
                k, _, v = part.strip().partition("=")
                fields[k.lower()] = v.strip('"')
            self._digest_challenge = fields

    def request(self, method: str, url: str | None = None,
                headers: dict | None = None) -> tuple[int, dict, bytes]:
        status, rhdrs, body = self._request_once(method, url, headers)
        if status == 401 and self.username \
                and "www-authenticate" in rhdrs:
            self._parse_challenge(rhdrs["www-authenticate"])
            status, rhdrs, body = self._request_once(method, url,
                                                     headers)
        return status, rhdrs, body

    def _request_once(self, method: str, url: str | None = None,
                      headers: dict | None = None) \
            -> tuple[int, dict, bytes]:
        self._cseq += 1
        target = url or self.url
        lines = [f"{method} {target} RTSP/1.0",
                 f"CSeq: {self._cseq}"]
        auth = self._authorization(method, target) \
            if self.username else None
        if auth:
            lines.append(f"Authorization: {auth}")
        if self.session:
            lines.append(f"Session: {self.session}")
        for k, v in (headers or {}).items():
            lines.append(f"{k}: {v}")
        self.sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        return self._read_response()

    def _fill(self) -> None:
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("RTSP connection closed")
        self._buf += chunk

    def _read_response(self) -> tuple[int, dict, bytes]:
        # responses may be interleaved with data frames; skip data
        while True:
            if self._buf[:1] == b"$":
                self._skip_data_frame()
                continue
            if b"\r\n\r\n" in self._buf:
                break
            self._fill()
        head, self._buf = self._buf.split(b"\r\n\r\n", 1)
        lines = head.decode("latin1").split("\r\n")
        status = int(lines[0].split()[1])
        headers = {}
        for line in lines[1:]:
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        n = int(headers.get("content-length", 0))
        while len(self._buf) < n:
            self._fill()
        body, self._buf = self._buf[:n], self._buf[n:]
        if "session" in headers:
            self.session = headers["session"].split(";")[0]
        return status, headers, body

    def _skip_data_frame(self) -> None:
        while len(self._buf) < 4:
            self._fill()
        ch = self._buf[1]
        n = int.from_bytes(self._buf[2:4], "big")
        while len(self._buf) < 4 + n:
            self._fill()
        self._pending_frames.append((ch, self._buf[4:4 + n]))
        self._buf = self._buf[4 + n:]

    def read_data_frame(self, blocking: bool) -> tuple[int, bytes] | None:
        """Next interleaved frame (channel, payload), or None."""
        if self._pending_frames:
            return self._pending_frames.popleft()
        while True:
            if len(self._buf) >= 4 and self._buf[:1] == b"$":
                ch = self._buf[1]
                n = int.from_bytes(self._buf[2:4], "big")
                if len(self._buf) >= 4 + n:
                    payload = self._buf[4:4 + n]
                    self._buf = self._buf[4 + n:]
                    return ch, payload
            elif self._buf and self._buf[:1] != b"$":
                # unexpected control data mid-stream: drop a byte
                self._buf = self._buf[1:]
                continue
            if not blocking:
                try:
                    self.sock.setblocking(False)
                    self._fill()
                except (BlockingIOError, ConnectionError):
                    return None
                finally:
                    self.sock.setblocking(True)
            else:
                self._fill()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


@register_element("rtspsrc2", Rank.PRIMARY)
class RtspSrc(PushSrc):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS,
                                 Caps.new("application/x-rtp"))]

    location = Property(str, default=None, mutable=Mutability.READY,
                        blurb="rtsp:// URL")
    timeout_s = Property(float, default=5.0, minimum=0.1)
    keep_alive_interval = Property(
        float, default=30.0, minimum=0.0,
        blurb="seconds between session keep-alive requests "
              "(GET_PARAMETER; 0 disables — reference rtspsrc2 "
              "0.15.3 keep-alive support)")
    protocols = Property(str, default="tcp", mutable=Mutability.READY,
                         enum_values=("tcp", "udp"),
                         blurb="Transport: tcp (interleaved) or udp "
                               "(RTP/AVP with client_port)")
    latency = Property(int, default=200, minimum=0,
                       mutable=Mutability.READY,
                       blurb="Jitterbuffer depth in ms announced to "
                             "latency queries (reference latency, "
                             "default 200)")
    timeout = Property(int, default=0, minimum=0,
                       mutable=Mutability.READY,
                       blurb="Network-activity timeout in ns "
                             "(reference timeout, default 5 s "
                             "there); 0 = use timeout-s")
    receive_mtu = Property(int, default=1508, minimum=576,
                           mutable=Mutability.READY,
                           blurb="Receive buffer size for UDP RTP "
                                 "reads (reference receive-mtu, "
                                 "default 1508)")
    port_start = Property(int, default=0, minimum=0, maximum=65535,
                          mutable=Mutability.READY,
                          blurb="First client port to try for the "
                                "RTP/RTCP UDP pair; 0 = kernel-"
                                "chosen (reference port-start)")

    def __init__(self, name=None):
        super().__init__(name)
        self._conn: RtspConnection | None = None
        self._media: dict | None = None
        self._rtp_sock = None
        self._rtcp_sock = None
        self._rtcp_peer = None          # (host, port) in UDP mode
        self._session = None            # gstpu_torch.net.rtp Session (RTCP)
        self._control: str | None = None
        self._seek_base_ns = 0
        self.is_live = True

    # -- RTCP (reference net/rtsp: interleaved RTCP channels, SR sync,
    # RR receiver reports) ------------------------------------------------
    def add_latency(self, q) -> None:
        # the configured jitterbuffer depth rides latency queries
        # (reference rtspsrc2 latency property, default 200 ms)
        q.add(self.latency * 1_000_000, self.latency * 1_000_000)

    def _now(self) -> int:
        import time as _t
        return _t.monotonic_ns()

    def _handle_rtcp(self, data: bytes) -> None:
        from gstpu_torch.net.rtp.session import Session
        if self._session is None:
            self._session = Session(cname="gstpu-rtspsrc2@localhost")
        now = self._now()
        events = self._session.handle_rtcp_recv(data, now)
        for ev in events:
            if ev[0] == "sr":
                mapping = self._session.ntp_rtp_mapping(ev[1])
                if mapping is not None:
                    self.post_element_message(
                        "rtspsrc2-sr", ssrc=ev[1], ntp_ns=mapping[0],
                        rtp_ts=mapping[1])
                # answer sender reports promptly with a receiver
                # report so the server sees our reception stats
                self._send_rr(now)

    def _send_rr(self, now: int) -> None:
        if self._session is None:
            return
        self._session._next_rtcp_time = now  # report due immediately
        out = self._session.poll_rtcp_send(now)
        if not out:
            return
        try:
            if self._rtcp_sock is not None and self._rtcp_peer:
                self._rtcp_sock.sendto(out, self._rtcp_peer)
            elif self._conn is not None:
                frame = b"$\x01" + len(out).to_bytes(2, "big") + out
                self._conn.sock.sendall(frame)
        except OSError:
            pass

    def _track_rtp(self, payload: bytes) -> None:
        from gstpu_torch.net.rtp.packet import RtpPacket, RtpParseError
        from gstpu_torch.net.rtp.session import Session
        if self._session is None:
            self._session = Session(cname="gstpu-rtspsrc2@localhost")
            if self._media:
                self._session.set_pt_clock_rate(
                    self._media.get("payload", 96),
                    self._media.get("clock-rate", 90000))
        try:
            pkt = RtpPacket.parse(payload)
        except RtpParseError:
            return
        self._session.handle_recv(pkt, self._now())

    # -- seek (PAUSE + PLAY with Range, RFC 2326 §10.5/12.29) -------------
    def seek(self, position_ns: int) -> bool:
        """Reposition the stream: PAUSE then PLAY with
        `Range: npt=<pos>-`; flushes downstream and opens a new
        segment at the target position."""
        if self._conn is None:
            return False
        from gstpu_torch.core.event import (FlushStartEvent, FlushStopEvent,
                                            Segment, SegmentEvent)
        try:
            status, _, _ = self._conn.request("PAUSE")
            if status not in (200, 405):   # 405: server never pauses
                return False
            npt = position_ns / 1_000_000_000
            status, _, _ = self._conn.request(
                "PLAY", headers={"Range": f"npt={npt:.3f}-"})
            if status != 200:
                return False
        except (OSError, ConnectionError) as e:
            self.post_error(f"rtspsrc2: seek failed: {e}")
            return False
        self.srcpad.push_event(FlushStartEvent())
        self.srcpad.push_event(FlushStopEvent())
        seg = Segment()
        seg.start = position_ns
        seg.time = position_ns
        seg.position = position_ns
        self.srcpad.push_event(SegmentEvent(seg))
        self._seek_base_ns = position_ns
        return True

    def _src_event(self, pad, ev) -> bool:
        from gstpu_torch.core.event import SeekEvent
        if isinstance(ev, SeekEvent):
            return self.seek(ev.start)
        return True

    def start(self) -> bool:
        if not self.location:
            self.post_error("rtspsrc2: no location")
            return False
        try:
            tmo = (self.timeout / 1e9) if self.timeout \
                else self.timeout_s
            c = RtspConnection(self.location, tmo)
            status, _, _ = c.request("OPTIONS")
            if status != 200:
                raise ConnectionError(f"OPTIONS -> {status}")
            status, hdrs, body = c.request(
                "DESCRIBE", headers={"Accept": "application/sdp"})
            if status != 200:
                raise ConnectionError(f"DESCRIBE -> {status}")
            media = parse_sdp_media(body.decode())
            if not media:
                raise ConnectionError("no media in SDP")
            self._media = media[0]
            control = self._media["control"] or self.location
            if not control.startswith("rtsp"):
                control = self.location.rstrip("/") + "/" + control
            if self.protocols == "udp":
                import socket as _socket

                def _bind_pair():
                    """RTP on an even port, RTCP adjacent — scanning
                    up from port-start when set (reference
                    port-start; 0 = kernel-chosen pair)."""
                    if not self.port_start:
                        a = _socket.socket(_socket.AF_INET,
                                           _socket.SOCK_DGRAM)
                        a.bind(("127.0.0.1", 0))
                        b = _socket.socket(_socket.AF_INET,
                                           _socket.SOCK_DGRAM)
                        b.bind(("127.0.0.1", 0))
                        return a, b
                    start = self.port_start + (self.port_start & 1)
                    for base in range(start, 65534, 2):
                        a = _socket.socket(_socket.AF_INET,
                                           _socket.SOCK_DGRAM)
                        b = _socket.socket(_socket.AF_INET,
                                           _socket.SOCK_DGRAM)
                        try:
                            a.bind(("127.0.0.1", base))
                            b.bind(("127.0.0.1", base + 1))
                            return a, b
                        except OSError:
                            a.close()
                            b.close()
                    raise ConnectionError("no free RTP/RTCP port "
                                          "pair above port-start")
                self._rtp_sock, self._rtcp_sock = _bind_pair()
                self._rtp_sock.setblocking(False)
                self._rtcp_sock.setblocking(False)
                rtp_port = self._rtp_sock.getsockname()[1]
                rtcp_port = self._rtcp_sock.getsockname()[1]
                transport = (f"RTP/AVP;unicast;client_port="
                             f"{rtp_port}-{rtcp_port}")
            else:
                transport = "RTP/AVP/TCP;unicast;interleaved=0-1"
            status, hdrs, _ = c.request(
                "SETUP", url=control,
                headers={"Transport": transport})
            if status != 200:
                raise ConnectionError(f"SETUP -> {status}")
            # server_port from the Transport response -> RTCP peer
            t = hdrs.get("transport", "")
            for part in t.split(";"):
                if part.strip().startswith("server_port="):
                    ports = part.split("=", 1)[1].split("-")
                    if len(ports) == 2:
                        host = urlparse(self.location).hostname
                        self._rtcp_peer = (host, int(ports[1]))
            status, _, _ = c.request("PLAY")
            if status != 200:
                raise ConnectionError(f"PLAY -> {status}")
            self._conn = c
            self._control = control
            self.srcpad.event_function = self._src_event
            return True
        except (OSError, ConnectionError) as e:
            self.post_error(f"rtspsrc2: {e}")
            return False

    def stop(self) -> bool:
        for sock in (self._rtp_sock, self._rtcp_sock):
            if sock is not None:
                sock.close()
        self._rtp_sock = self._rtcp_sock = None
        if self._conn:
            try:
                self._conn.request("TEARDOWN")
            except (OSError, ConnectionError):
                pass
            self._conn.close()
            self._conn = None
        return True

    def negotiate(self) -> Caps:
        m = self._media or {}
        s = Structure("application/x-rtp",
                      media=m.get("kind", "video"),
                      payload=m.get("payload", 96))
        if m.get("encoding"):
            s["encoding-name"] = m["encoding"]
        s["clock-rate"] = m.get("clock-rate", 90000)
        return Caps([s])

    def _maybe_keep_alive(self) -> None:
        if not self.keep_alive_interval or self._conn is None:
            return
        import time as _time
        now = _time.monotonic()
        last = getattr(self, "_last_keepalive", None)
        if last is None:
            self._last_keepalive = now
            return
        if now - last < self.keep_alive_interval:
            return
        self._last_keepalive = now
        try:
            # GET_PARAMETER with no body is the standard ping; some
            # servers only accept OPTIONS — fall back on error status
            status, _, _ = self._conn.request("GET_PARAMETER")
            if status >= 400:
                self._conn.request("OPTIONS")
        except (ConnectionError, OSError):
            pass

    def create(self) -> Buffer | None:
        self._maybe_keep_alive()
        if self._rtp_sock is not None:
            if self._rtcp_sock is not None:
                try:
                    rtcp, _ = self._rtcp_sock.recvfrom(
                        max(self.receive_mtu, 1508))
                    self._handle_rtcp(rtcp)
                except BlockingIOError:
                    pass
            try:
                payload, _addr = self._rtp_sock.recvfrom(
                    self.receive_mtu)
            except BlockingIOError:
                raise FlowError(FlowReturn.FLUSHING, "no datagram yet")
            self._track_rtp(payload)
            buf = Buffer(payload)
            if self.clock is not None:
                buf.pts = self.running_time()
            return buf
        try:
            frame = self._conn.read_data_frame(blocking=False)
        except ConnectionError:
            return None  # EOS
        if frame is None:
            raise FlowError(FlowReturn.FLUSHING, "no frame yet")
        ch, payload = frame
        if ch != 0:   # RTCP channel
            self._handle_rtcp(payload)
            raise FlowError(FlowReturn.FLUSHING, "rtcp frame")
        self._track_rtp(payload)
        buf = Buffer(payload)
        if self.clock is not None:
            buf.pts = self.running_time()
        return buf
