"""awskvswebrtcsink: AWS Kinesis Video Streams WebRTC master
(reference net/webrtc/src/aws_kvs_signaller/imp.rs): discovers the
signalling channel (describeSignalingChannel /
getSignalingChannelEndpoint on the kinesisvideo API, SigV4-signed),
connects to the WSS endpoint as master with a SigV4 query-presigned
URL carrying X-Amz-ChannelARN, then serves viewers — SDP_OFFER
(base64 JSON messagePayload, senderClientId) starts a session and is
answered with SDP_ANSWER; ICE candidates ride the SDP here.

Media machinery is webrtcsink's. Tested against an in-process mock
of both the HTTP API and the signalling WebSocket.

The port's copy of gstpu/elements/net/awskvs.py, as it stands.
"""

from __future__ import annotations

import base64
import json
import threading

from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.elements.net.webrtcsink import WebRtcSink


@register_element("awskvswebrtcsink", Rank.NONE)
class AwsKvsWebRtcSink(WebRtcSink):
    channel_name = Property(str, default=None,
                            mutable=Mutability.READY)
    region = Property(str, default="us-east-1",
                      mutable=Mutability.READY)
    access_key = Property(str, default=None, mutable=Mutability.READY)
    secret_access_key = Property(str, default=None,
                                 mutable=Mutability.READY)
    session_token = Property(str, default=None,
                             mutable=Mutability.READY)
    api_endpoint = Property(str, default=None,
                            mutable=Mutability.READY,
                            blurb="kinesisvideo API override "
                                  "(mock/compatible stores)")
    request_timeout = Property(float, default=15.0, minimum=0.0)

    def __init__(self, name=None):
        super().__init__(name)
        self._ws = None
        self._thread = None
        self._running = False
        self.channel_arn: str | None = None
        self.viewers: dict[str, str] = {}

    # -- kinesisvideo control-plane API ---------------------------------
    def _api_post(self, path: str, body: dict) -> dict:
        import urllib.request

        from gstpu_torch.net.aws.sigv4 import sign_request
        base = self.api_endpoint or \
            f"https://kinesisvideo.{self.region}.amazonaws.com"
        url = base.rstrip("/") + path
        payload = json.dumps(body).encode()
        hdrs = sign_request(
            method="POST", url=url, region=self.region,
            service="kinesisvideo",
            access_key=self.access_key or "",
            secret_key=self.secret_access_key or "",
            session_token=self.session_token,
            headers={"content-type": "application/json"},
            payload=payload)
        req = urllib.request.Request(url, data=payload,
                                     method="POST", headers=hdrs)
        with urllib.request.urlopen(
                req, timeout=self.request_timeout) as r:
            return json.loads(r.read())

    def _discover(self) -> str:
        desc = self._api_post("/describeSignalingChannel",
                              {"ChannelName": self.channel_name})
        self.channel_arn = desc["ChannelInfo"]["ChannelARN"]
        eps = self._api_post(
            "/getSignalingChannelEndpoint",
            {"ChannelARN": self.channel_arn,
             "SingleMasterChannelEndpointConfiguration":
                 {"Protocols": ["WSS"], "Role": "MASTER"}})
        for ep in eps["ResourceEndpointList"]:
            if ep["Protocol"] == "WSS":
                return ep["ResourceEndpoint"]
        raise ConnectionError("no WSS endpoint for channel")

    # -- lifecycle -------------------------------------------------------
    def ready_to_paused(self) -> bool:
        if self.channel_name:
            try:
                self._connect()
            except Exception as e:
                self.post_error(f"awskvswebrtcsink: {e}")
                return False
        return super().ready_to_paused()

    def _connect(self) -> None:
        from gstpu_torch.net.aws.sigv4 import presign_url
        from gstpu_torch.net.ws import WsClient
        wss = self._discover()
        signed = presign_url(
            method="GET",
            url=f"{wss}/?X-Amz-ChannelARN={self.channel_arn}",
            region=self.region, service="kinesisvideo",
            access_key=self.access_key or "",
            secret_key=self.secret_access_key or "",
            session_token=self.session_token)
        self._ws = WsClient(signed)
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        daemon=True)
        self._thread.start()

    def paused_to_ready(self) -> bool:
        self._running = False
        if self._ws is not None:
            self._ws.close()
            self._ws = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        return super().paused_to_ready()

    # -- signalling ------------------------------------------------------
    def _loop(self) -> None:
        while self._running:
            try:
                raw = self._ws.recv(0.5)
            except (TimeoutError, OSError):
                continue
            if raw is None:
                return
            try:
                self._handle(json.loads(raw))
            except Exception as e:
                self.post_error(f"awskvswebrtcsink: {e}")

    def _handle(self, msg: dict) -> None:
        action = msg.get("messageType") or msg.get("action")
        sender = msg.get("senderClientId", "viewer")
        payload = {}
        if msg.get("messagePayload"):
            payload = json.loads(
                base64.b64decode(msg["messagePayload"]))
        if action == "SDP_OFFER":
            sid = f"kvs-{sender}"
            self.viewers[sender] = sid
            self.handle_signalling({"type": "startSession",
                                    "sessionId": sid,
                                    "peerId": sender})
            answer = self._answer_sdp(sid, payload.get("sdp", ""))
            self._ws.send_text(json.dumps({
                "action": "SDP_ANSWER",
                "recipientClientId": sender,
                "messagePayload": base64.b64encode(json.dumps(
                    {"type": "answer", "sdp": answer}).encode())
                .decode()}))
        elif action == "ICE_CANDIDATE":
            pass                        # candidates ride the SDP

    def _answer_sdp(self, sid: str, offer_sdp: str) -> str:
        # answer with our media description; transport lines from the
        # session's ICE/DTLS context when enabled
        return self._offer_sdp(sid)
