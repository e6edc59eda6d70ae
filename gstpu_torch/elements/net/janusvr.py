"""janusvrwebrtcsink / janusvrwebrtcsrc: Janus VideoRoom signalling
(reference net/webrtc/src/janusvr_signaller/imp.rs): the Janus
gateway's JSON-over-WebSocket API — create session, attach to
janus.plugin.videoroom, join as publisher/subscriber, publish with a
JSEP offer, keepalive, detach/destroy.

The media machinery is webrtcsink/webrtcsrc's (encoders, payloaders,
GCC, optional live ICE+DTLS+SRTP transport); only the signalling
plane differs. Tested against an in-process mock Janus; a real
gateway needs network (ws:// to it works as-is).

The port's copy of gstpu/elements/net/janusvr.py, as it stands.
"""

from __future__ import annotations

import json

from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.elements.net.webrtcsink import WebRtcSink, WebRtcSrc


class JanusError(ConnectionError):
    pass


class _JanusSession:
    """Blocking Janus control-channel client."""

    def __init__(self, url: str, *, timeout: float = 5.0):
        from gstpu_torch.net.ws import WsClient
        self.ws = WsClient(
            url, headers={"Sec-WebSocket-Protocol": "janus-protocol"},
            timeout=timeout)
        self.timeout = timeout
        self._tx = 0
        self.session_id = None
        self.handle_id = None

    def _txn(self) -> str:
        self._tx += 1
        return f"gstpu-{self._tx}"

    def _send(self, msg: dict) -> str:
        t = self._txn()
        msg["transaction"] = t
        if self.session_id is not None and "session_id" not in msg:
            msg["session_id"] = self.session_id
        self.ws.send_text(json.dumps(msg))
        return t

    def _wait(self, txn: str, *, want=("success", "event")) -> dict:
        for _ in range(200):
            raw = self.ws.recv(self.timeout)
            if raw is None:
                raise JanusError("janus connection closed")
            msg = json.loads(raw)
            if msg.get("janus") == "error":
                err = msg.get("error", {})
                raise JanusError(
                    f"janus error {err.get('code')}: "
                    f"{err.get('reason')}")
            if msg.get("transaction") == txn \
                    and msg.get("janus") in want:
                return msg
            # acks / unrelated events: keep draining
        raise JanusError("no janus reply")

    def create(self) -> None:
        t = self._send({"janus": "create"})
        self.session_id = self._wait(t)["data"]["id"]

    def attach(self, plugin="janus.plugin.videoroom") -> None:
        t = self._send({"janus": "attach", "plugin": plugin})
        self.handle_id = self._wait(t)["data"]["id"]

    def message(self, body: dict, jsep: dict | None = None) -> dict:
        msg = {"janus": "message", "handle_id": self.handle_id,
               "body": body}
        if jsep is not None:
            msg["jsep"] = jsep
        t = self._send(msg)
        return self._wait(t)

    def trickle(self, candidate: dict | None) -> None:
        self._send({"janus": "trickle",
                    "handle_id": self.handle_id,
                    "candidate": candidate
                    if candidate is not None
                    else {"completed": True}})

    def keepalive(self) -> None:
        self._send({"janus": "keepalive"})

    def close(self) -> None:
        try:
            if self.handle_id is not None:
                self._send({"janus": "detach",
                            "handle_id": self.handle_id})
            if self.session_id is not None:
                self._send({"janus": "destroy"})
        except OSError:
            pass
        self.ws.close()


class _JanusProps:
    janus_endpoint = Property(str, default=None,
                              mutable=Mutability.READY,
                              blurb="ws://janus:8188/janus")
    room_id = Property(int, default=1234, mutable=Mutability.READY)
    feed_id = Property(int, default=0, mutable=Mutability.READY,
                       blurb="publisher feed id (0 = let the room "
                             "assign one)")
    secret = Property(str, default=None, mutable=Mutability.READY)


@register_element("janusvrwebrtcsink", Rank.NONE)
class JanusVrWebRtcSink(_JanusProps, WebRtcSink):
    """Publish into a Janus VideoRoom. The publish flow runs when
    the first sink pad receives caps (the offer needs the m-lines,
    like the reference's codec-discovery-then-negotiate order)."""

    def __init__(self, name=None):
        super().__init__(name)
        self._janus: _JanusSession | None = None
        self.published_feed: int | None = None

    # hook the caps arrival (WebRtcSink wires pad events to _event)
    def _event(self, pad, ev):
        ret = super()._event(pad, ev)
        from gstpu_torch.core.event import CapsEvent
        if isinstance(ev, CapsEvent) and self.janus_endpoint \
                and self._janus is None:
            try:
                self._connect_and_publish()
            except (JanusError, ConnectionError, OSError) as e:
                self.post_error(f"janusvrwebrtcsink: {e}")
        return ret

    def _connect_and_publish(self) -> None:
        self._janus = _JanusSession(self.janus_endpoint)
        self._janus.create()
        self._janus.attach()
        join = {"request": "join", "ptype": "publisher",
                "room": self.room_id,
                "display": self.display_name}
        if self.feed_id:
            join["id"] = self.feed_id
        if self.secret:
            join["pin"] = self.secret
        ev = self._janus.message(join)
        data = ev.get("plugindata", {}).get("data", {})
        if data.get("videoroom") != "joined":
            raise JanusError(f"join refused: {data}")
        self.published_feed = data.get("id")
        # local session drives the media path; Janus is the peer
        sid = f"janus-{self.published_feed}"
        self.handle_signalling({"type": "startSession",
                                "sessionId": sid,
                                "peerId": "janus"})
        offer = self._offer_sdp(sid)
        ev = self._janus.message({"request": "publish"},
                                 jsep={"type": "offer", "sdp": offer})
        jsep = ev.get("jsep")
        if not jsep or jsep.get("type") != "answer":
            raise JanusError("no JSEP answer from janus")
        self.handle_signalling({"type": "peer", "sessionId": sid,
                                "sdp": jsep})
        self._janus.trickle(None)       # candidates ride the SDP
        self.post_element_message("janus-published",
                                  room=self.room_id,
                                  feed=self.published_feed)

    def paused_to_ready(self) -> bool:
        if self._janus is not None:
            self._janus.close()
            self._janus = None
        return super().paused_to_ready()


@register_element("janusvrwebrtcsrc", Rank.NONE)
class JanusVrWebRtcSrc(_JanusProps, WebRtcSrc):
    """Subscribe to a Janus VideoRoom feed: join as subscriber,
    answer the gateway's JSEP offer, then receive media through
    webrtcsrc's session machinery."""

    def __init__(self, name=None):
        super().__init__(name)
        self._janus: _JanusSession | None = None
        self.subscribed = False

    def connect_janus(self) -> None:
        """Join + subscribe (call after setting properties; tests
        and applications drive this explicitly, matching the
        signaller object's start())."""
        self._janus = _JanusSession(self.janus_endpoint)
        self._janus.create()
        self._janus.attach()
        ev = self._janus.message({
            "request": "join", "ptype": "subscriber",
            "room": self.room_id, "feed": self.feed_id})
        jsep = ev.get("jsep")
        if not jsep or jsep.get("type") != "offer":
            raise JanusError("no subscriber offer from janus")
        answer = self._answer_for_offer(jsep["sdp"])
        ev = self._janus.message({"request": "start"},
                                 jsep={"type": "answer",
                                       "sdp": answer})
        self.subscribed = True

    def _answer_for_offer(self, offer_sdp: str) -> str:
        lines = ["v=0", "o=- 0 0 IN IP4 127.0.0.1", "s=gstpu",
                 "t=0 0"]
        for line in offer_sdp.splitlines():
            if line.startswith("m="):
                lines.append(line.strip())
                lines.append("a=recvonly")
            elif line.startswith("a=rtpmap"):
                lines.append(line.strip())
        return "\r\n".join(lines) + "\r\n"

    def paused_to_ready(self) -> bool:
        if self._janus is not None:
            self._janus.close()
            self._janus = None
        return super().paused_to_ready()
