"""WebSocket client (RFC 6455) over the frame codec in
gstpu/net/webrtc/signalling.py — the client side the cloud-service
elements (speechmatics, deepgram) speak. Client→server frames are
masked as the RFC requires; wss:// wraps the socket in TLS (system
trust by default, or a caller-provided SSLContext for pinned /
self-signed deployments like webrtcsink's embedded TLS signalling
server).

The port's copy of gstpu/net/ws.py, as it stands.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import urllib.parse


class WsError(ConnectionError):
    pass


def _masked_send(conn: socket.socket, payload: bytes,
                 opcode: int) -> None:
    mask = os.urandom(4)
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([0x80 | n])
    elif n < 65536:
        header += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        header += bytes([0x80 | 127]) + struct.pack(">Q", n)
    masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    conn.sendall(header + mask + masked)


class WsClient:
    """Blocking WebSocket client with poll-style receive."""

    def __init__(self, url: str, *,
                 headers: dict[str, str] | None = None,
                 timeout: float = 10.0,
                 ssl_ctx=None):
        """ssl_ctx: an ssl.SSLContext for wss:// URLs (pass one with
        the deployment's CA, or ssl.create_default_context() for
        system trust); a wss URL with no context gets the default
        system-trust context."""
        u = urllib.parse.urlsplit(url)
        if u.scheme not in ("ws", "wss"):
            raise WsError(f"unsupported scheme '{u.scheme}'")
        port = u.port or (443 if u.scheme == "wss" else 80)
        self.conn = socket.create_connection((u.hostname, port),
                                             timeout=timeout)
        if u.scheme == "wss":
            import ssl as _ssl
            if ssl_ctx is None:
                ssl_ctx = _ssl.create_default_context()
            self.conn = ssl_ctx.wrap_socket(
                self.conn, server_hostname=u.hostname)
        key = base64.b64encode(os.urandom(16)).decode()
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        req = [f"GET {path} HTTP/1.1", f"Host: {u.netloc}",
               "Upgrade: websocket", "Connection: Upgrade",
               f"Sec-WebSocket-Key: {key}",
               "Sec-WebSocket-Version: 13"]
        for k, v in (headers or {}).items():
            req.append(f"{k}: {v}")
        self.conn.sendall(("\r\n".join(req) + "\r\n\r\n").encode())
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = self.conn.recv(1)
            if not chunk:
                raise WsError("connection closed during handshake")
            data += chunk
        status = data.split(b"\r\n", 1)[0]
        if b"101" not in status:
            raise WsError(f"handshake rejected: {status.decode()}")
        # RFC 6455 4.1: the server must echo SHA1(key + GUID)
        want = base64.b64encode(hashlib.sha1(
            (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11")
            .encode()).digest()).decode()
        accept = None
        for line in data.decode("latin1").split("\r\n"):
            if line.lower().startswith("sec-websocket-accept:"):
                accept = line.split(":", 1)[1].strip()
        if accept != want:
            raise WsError("bad Sec-WebSocket-Accept")

    def send_text(self, text: str) -> None:
        _masked_send(self.conn, text.encode(), 1)

    def send_binary(self, data: bytes) -> None:
        _masked_send(self.conn, data, 2)

    def recv(self, timeout: float | None = None) -> bytes | None:
        """One message payload; None on close; raises socket.timeout
        when `timeout` elapses with no data."""
        from gstpu_torch.net.webrtc.signalling import ws_recv
        self.conn.settimeout(timeout)
        return ws_recv(self.conn)

    def poll(self, timeout: float = 0.0) -> bytes | None:
        """Non/short-blocking receive: None when nothing is ready."""
        import select
        ready, _, _ = select.select([self.conn], [], [], timeout)
        if not ready:
            return None
        try:
            return self.recv(1.0)       # frame is arriving: finish it
        except (TimeoutError, socket.timeout, BlockingIOError):
            return None

    def close(self) -> None:
        try:
            _masked_send(self.conn, b"", 8)
        except OSError:
            pass
        self.conn.close()
