"""uepswebrtcsink: Unreal Engine Pixel Streaming producer
(reference net/webrtc/src/ue_ps_signaller/{imp.rs,protocol.rs}):
connects to the UE signalling server, identifies as a streamer
(identify -> endpointId -> endpointIdConfirm), then serves players —
playerConnected starts a session and sends an SDP offer, answer and
iceCandidate messages flow back, ping is answered with pong.

Media machinery is webrtcsink's; tested against an in-process mock
signalling server.

The port's copy of gstpu/elements/net/ueps.py, as it stands.
"""

from __future__ import annotations

import json
import threading

from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.elements.net.webrtcsink import WebRtcSink


@register_element("uepswebrtcsink", Rank.NONE)
class UePsWebRtcSink(WebRtcSink):
    uri = Property(str, default=None, mutable=Mutability.READY,
                   blurb="ws:// UE signalling (cirrus) server")
    streamer_id = Property(str, default="gstpu-streamer",
                           mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._ws = None
        self._thread: threading.Thread | None = None
        self._running = False
        self.identified = False
        self.players: dict[str, str] = {}   # playerId -> session id

    # -- lifecycle -----------------------------------------------------
    def ready_to_paused(self) -> bool:
        if self.uri:
            from gstpu_torch.net.ws import WsClient
            try:
                self._ws = WsClient(self.uri)
            except Exception as e:
                self.post_error(f"uepswebrtcsink: connect: {e}")
                return False
            self._running = True
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True)
            self._thread.start()
        return super().ready_to_paused()

    def paused_to_ready(self) -> bool:
        self._running = False
        if self._ws is not None:
            self._ws.close()
            self._ws = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        return super().paused_to_ready()

    # -- protocol ------------------------------------------------------
    def _send(self, msg: dict) -> None:
        self._ws.send_text(json.dumps(msg))

    def _loop(self) -> None:
        while self._running:
            try:
                raw = self._ws.recv(0.5)
            except (TimeoutError, OSError):
                continue
            if raw is None:
                return
            try:
                msg = json.loads(raw)
            except json.JSONDecodeError:
                continue
            try:
                self._handle(msg)
            except Exception as e:
                self.post_error(f"uepswebrtcsink: {e}")

    def _handle(self, msg: dict) -> None:
        t = msg.get("type")
        if t == "config":
            pass                           # peerConnectionOptions
        elif t == "identify":
            self._send({"type": "endpointId",
                        "id": self.streamer_id,
                        "protocolVersion": "1.1.0"})
        elif t == "endpointIdConfirm":
            self.identified = True
        elif t == "playerConnected":
            pid = str(msg.get("playerId"))
            sid = f"ueps-{pid}"
            self.players[pid] = sid
            self.handle_signalling({"type": "startSession",
                                    "sessionId": sid,
                                    "peerId": pid})
            self._send({"type": "offer", "playerId": pid,
                        "sdp": self._offer_sdp(sid)})
        elif t == "answer":
            pid = str(msg.get("playerId"))
            sid = self.players.get(pid)
            if sid is not None:
                self.handle_signalling(
                    {"type": "peer", "sessionId": sid,
                     "sdp": {"type": "answer",
                             "sdp": msg.get("sdp", "")}})
        elif t == "iceCandidate":
            pass                           # candidates ride the SDP
        elif t == "playerDisconnected":
            pid = str(msg.get("playerId"))
            sid = self.players.pop(pid, None)
            if sid is not None:
                self.handle_signalling({"type": "endSession",
                                        "sessionId": sid})
        elif t == "ping":
            self._send({"type": "pong", "time": msg.get("time", 0)})
