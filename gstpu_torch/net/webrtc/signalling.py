"""WebRTC signalling: wire protocol + session server.

Rebuilds the reference's JSON signalling protocol
(net/webrtc/protocol/src/lib.rs:18-173 — wire-compatible camelCase
tagged messages) and the signalling server's session logic
(net/webrtc/signalling/src/server, handlers): peers register roles
(producer/consumer/listener), consumers start sessions with producers,
SDP/ICE messages forward between session peers, listeners get
peer-status updates.

The Server core is transport-agnostic (sans-IO: handle_connect /
handle_message / handle_disconnect return outgoing (peer_id, message)
pairs); `serve_websocket` puts it behind a minimal RFC 6455 WebSocket
front end for browser/JS-SDK clients.

The port's copy of gstpu/net/webrtc/signalling.py, with one departure:
`SignallingClient.stop` ends its reader thread before it closes the
socket. gstpu's closes the socket under a reader that may still be
inside a read; a TLS socket's reads go to the descriptor's number, so
that reader can take the bytes, even the handshake, of whichever socket
is opened next under the same number.
"""

from __future__ import annotations

import base64
import hashlib
import itertools
import json
import socket
import struct
import threading
from dataclasses import dataclass, field
from typing import Any

# -- wire protocol helpers (reference-compatible shapes) -----------------


def welcome(peer_id: str) -> dict:
    return {"type": "welcome", "peerId": peer_id}


def peer_status(roles: list[str], peer_id: str | None = None,
                meta: Any = None) -> dict:
    msg = {"type": "peerStatusChanged", "roles": roles, "meta": meta}
    if peer_id is not None:
        msg["peerId"] = peer_id
    return msg


def start_session(peer_id: str, session_id: str,
                  offer: str | None = None) -> dict:
    return {"type": "startSession", "peerId": peer_id,
            "sessionId": session_id, "offer": offer}


def session_started(peer_id: str, session_id: str) -> dict:
    return {"type": "sessionStarted", "peerId": peer_id,
            "sessionId": session_id}


def end_session(session_id: str) -> dict:
    return {"type": "endSession", "sessionId": session_id}


def peer_sdp(session_id: str, kind: str, sdp: str) -> dict:
    return {"type": "peer", "sessionId": session_id,
            "sdp": {"type": kind, "sdp": sdp}}


def peer_ice(session_id: str, candidate: str, mline: int) -> dict:
    return {"type": "peer", "sessionId": session_id,
            "ice": {"candidate": candidate, "sdpMLineIndex": mline}}


def error(details: str) -> dict:
    return {"type": "error", "details": details}


@dataclass
class _Peer:
    peer_id: str
    roles: list[str] = field(default_factory=list)
    meta: Any = None


@dataclass
class _Session:
    session_id: str
    producer: str
    consumer: str


class Server:
    """Sans-IO signalling session server."""

    def __init__(self):
        self._peers: dict[str, _Peer] = {}
        self._sessions: dict[str, _Session] = {}
        self._ids = itertools.count(1)

    # -- lifecycle -------------------------------------------------------
    def handle_connect(self) -> tuple[str, list[tuple[str, dict]]]:
        peer_id = f"peer-{next(self._ids)}"
        self._peers[peer_id] = _Peer(peer_id)
        return peer_id, [(peer_id, welcome(peer_id))]

    def handle_disconnect(self, peer_id: str) -> list[tuple[str, dict]]:
        out = []
        self._peers.pop(peer_id, None)
        for sid, s in list(self._sessions.items()):
            if peer_id in (s.producer, s.consumer):
                other = s.consumer if peer_id == s.producer else s.producer
                if other in self._peers:
                    out.append((other, end_session(sid)))
                del self._sessions[sid]
        out.extend(self._broadcast_status(peer_id, []))
        return out

    # -- message handling --------------------------------------------------
    def handle_message(self, peer_id: str, msg: dict) \
            -> list[tuple[str, dict]]:
        peer = self._peers.get(peer_id)
        if peer is None:
            return []
        t = msg.get("type")
        if t == "setPeerStatus":
            peer.roles = list(msg.get("roles", []))
            peer.meta = msg.get("meta")
            out = [(peer_id, peer_status(peer.roles, peer_id,
                                         peer.meta))]
            out.extend(self._broadcast_status(peer_id, peer.roles))
            return out
        if t == "list":
            producers = [{"id": p.peer_id, "meta": p.meta}
                         for p in self._peers.values()
                         if "producer" in p.roles]
            return [(peer_id, {"type": "list", "producers": producers})]
        if t == "startSession":
            target = msg.get("peerId")
            if target not in self._peers:
                return [(peer_id, error(f"no such peer {target!r}"))]
            session_id = f"session-{next(self._ids)}"
            self._sessions[session_id] = _Session(session_id, target,
                                                  peer_id)
            offer = msg.get("offer")
            return [
                (peer_id, session_started(target, session_id)),
                (target, start_session(peer_id, session_id, offer)),
            ]
        if t == "peer":
            sid = msg.get("sessionId")
            s = self._sessions.get(sid)
            if s is None:
                return [(peer_id, error(f"no such session {sid!r}"))]
            other = s.consumer if peer_id == s.producer else s.producer
            fwd = dict(msg)
            return [(other, fwd)]
        if t == "endSession":
            sid = msg.get("sessionId")
            s = self._sessions.pop(sid, None)
            if s is None:
                return [(peer_id, error(f"no such session {sid!r}"))]
            other = s.consumer if peer_id == s.producer else s.producer
            return [(other, end_session(sid))]
        return [(peer_id, error(f"unknown message type {t!r}"))]

    def _broadcast_status(self, about: str, roles: list[str]) \
            -> list[tuple[str, dict]]:
        return [(p.peer_id, peer_status(roles, about))
                for p in self._peers.values()
                if "listener" in p.roles and p.peer_id != about]


# -- minimal RFC 6455 WebSocket transport ----------------------------------

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_accept(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()


def ws_handshake(conn: socket.socket) -> bool:
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = conn.recv(4096)
        if not chunk:
            return False
        data += chunk
    key = None
    for line in data.decode("latin1").split("\r\n"):
        if line.lower().startswith("sec-websocket-key:"):
            key = line.split(":", 1)[1].strip()
    if key is None:
        return False
    conn.sendall(
        b"HTTP/1.1 101 Switching Protocols\r\n"
        b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
        b"Sec-WebSocket-Accept: " + _ws_accept(key).encode()
        + b"\r\n\r\n")
    return True


def ws_send(conn: socket.socket, payload: bytes,
            opcode: int = 1) -> None:
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < 65536:
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    conn.sendall(header + payload)


def ws_recv(conn: socket.socket) -> bytes | None:
    def read_exact(n):
        buf = b""
        while len(buf) < n:
            c = conn.recv(n - len(buf))
            if not c:
                return None
            buf += c
        return buf

    hdr = read_exact(2)
    if hdr is None:
        return None
    opcode = hdr[0] & 0x0F
    masked = hdr[1] & 0x80
    n = hdr[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", read_exact(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", read_exact(8))[0]
    mask = read_exact(4) if masked else b"\x00" * 4
    data = read_exact(n)
    if data is None:
        return None
    if masked:
        data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
    if opcode == 8:  # close
        return None
    return data


class SignallingServer:
    """WebSocket signalling server (the reference's standalone
    signalling binary, net/webrtc/signalling)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 cert: str | None = None, key: str | None = None):
        """cert/key: PEM file paths; both set -> the websocket
        listens over TLS (wss://), matching the reference signalling
        binary's --cert/--cert-password TLS mode and webrtcsink's
        signalling-server-cert/-key properties."""
        self.core = Server()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._conns: dict[str, socket.socket] = {}
        self._lock = threading.Lock()
        self._running = False
        self._ssl_ctx = None
        if cert and key:
            import ssl
            self._ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._ssl_ctx.load_cert_chain(cert, key)
        self.scheme = "wss" if self._ssl_ctx else "ws"

    def start(self) -> None:
        self._running = True
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def stop(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass

    def _dispatch(self, msgs: list[tuple[str, dict]]) -> None:
        with self._lock:
            for target, msg in msgs:
                conn = self._conns.get(target)
                if conn is not None:
                    try:
                        ws_send(conn, json.dumps(msg).encode())
                    except OSError:
                        pass

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._client_loop, args=(conn,),
                             daemon=True).start()

    def _client_loop(self, conn: socket.socket) -> None:
        if self._ssl_ctx is not None:
            try:
                conn = self._ssl_ctx.wrap_socket(conn,
                                                 server_side=True)
            except OSError:
                conn.close()
                return
        if not ws_handshake(conn):
            conn.close()
            return
        with self._lock:
            peer_id, msgs = self.core.handle_connect()
            self._conns[peer_id] = conn
        self._dispatch(msgs)
        try:
            while self._running:
                data = ws_recv(conn)
                if data is None:
                    break
                try:
                    msg = json.loads(data)
                except json.JSONDecodeError:
                    self._dispatch([(peer_id,
                                     error("invalid JSON"))])
                    continue
                with self._lock:
                    out = self.core.handle_message(peer_id, msg)
                self._dispatch(out)
        finally:
            with self._lock:
                self._conns.pop(peer_id, None)
                out = self.core.handle_disconnect(peer_id)
            self._dispatch(out)
            conn.close()


class SignallingClient:
    """Live signalling binding: connects an element's sans-IO
    signalling surface (`signalling_connect` / `handle_signalling`)
    to a signalling server over WebSocket — the signaller object
    every reference webrtcsink/webrtcsrc owns
    (net/webrtc/src/signaller/imp.rs `uri` property).

    A reader thread turns incoming JSON into handler calls and sends
    each returned message back; `send` lets the element originate
    messages (e.g. endSession)."""

    def __init__(self, uri: str, element, ssl_ctx=None):
        self.uri = uri
        self.element = element
        self.ssl_ctx = ssl_ctx      # for wss:// with a pinned cert
        self.connected = threading.Event()
        self._ws = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def start(self) -> None:
        from gstpu_torch.net.ws import WsClient
        self._ws = WsClient(self.uri, ssl_ctx=self.ssl_ctx)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def send(self, msg: dict) -> None:
        with self._lock:
            if self._ws is not None:
                self._ws.send_text(json.dumps(msg))

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            ws, self._ws = self._ws, None
        if ws is None:
            return
        # the reader ends at its next poll, before the descriptor is
        # freed for the next socket to take
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=2.0)
        ws.close()

    def _run(self) -> None:
        import socket as _socket
        ws = self._ws
        first = True
        try:
            while not self._stop.is_set():
                try:
                    data = ws.recv(timeout=0.25)
                except (TimeoutError, _socket.timeout):
                    continue
                except OSError:
                    break
                if data is None:
                    break
                try:
                    msg = json.loads(data)
                except json.JSONDecodeError:
                    continue
                if first and msg.get("type") == "welcome":
                    first = False
                    replies = self.element.signalling_connect(msg)
                    self.connected.set()
                else:
                    replies = self.element.handle_signalling(msg)
                for r in replies or []:
                    self.send(r)
        finally:
            self.connected.set()
            if hasattr(self.element, "post_element_message"):
                self.element.post_element_message(
                    "signalling-closed", uri=self.uri)
