"""Sans-IO WHIP/WHEP HTTP signalling (draft-ietf-wish-whip / -whep).

Rebuilds the protocol layer of the reference whip/whep signallers
(net/webrtc/src/whip_signaller/imp.rs): the client POSTs an SDP offer
(`application/sdp`) to the endpoint and receives 201 Created with a
`Location` resource URL and the SDP answer; trickle ICE goes out as
PATCH (`application/trickle-ice-sdpfrag`) and teardown as DELETE on
the resource URL.  Redirects (307/308) re-POST to the new location
(imp.rs:325).  No sockets here: callers shuttle HttpRequest /
HttpResponse records over whatever transport they own.

The port's copy of gstpu/net/webrtc/whip.py, as it stands.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field

CONTENT_SDP = "application/sdp"
CONTENT_TRICKLE = "application/trickle-ice-sdpfrag"


@dataclass
class HttpRequest:
    method: str
    url: str
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""


@dataclass
class HttpResponse:
    status: int
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""


def _get_header(headers: dict[str, str], name: str) -> str | None:
    for k, v in headers.items():
        if k.lower() == name.lower():
            return v
    return None


class WhipClientSession:
    """Drives one WHIP (publish) or WHEP (consume) resource."""

    MAX_REDIRECTS = 5

    def __init__(self, endpoint: str, auth_token: str | None = None):
        self.endpoint = endpoint
        self.auth_token = auth_token
        self.state = "idle"         # idle/posted/active/terminated
        self.resource_url: str | None = None
        self.answer_sdp: str | None = None
        self.ice_servers: list[str] = []
        self._redirects = 0

    def _headers(self, content_type: str) -> dict[str, str]:
        h = {"Content-Type": content_type}
        if self.auth_token:
            h["Authorization"] = f"Bearer {self.auth_token}"
        return h

    def post_offer(self, offer_sdp: str) -> HttpRequest:
        if self.state not in ("idle",):
            raise RuntimeError(f"cannot POST in state {self.state}")
        self.state = "posted"
        self._offer = offer_sdp
        return HttpRequest("POST", self.endpoint,
                           self._headers(CONTENT_SDP),
                           offer_sdp.encode())

    def handle_response(self, resp: HttpResponse) -> HttpRequest | None:
        """Feed the response to the last request.  Returns a follow-up
        request (redirect re-POST) or None when settled."""
        if self.state != "posted":
            raise RuntimeError(f"unexpected response in {self.state}")
        if resp.status in (307, 308):
            self._redirects += 1
            if self._redirects > self.MAX_REDIRECTS:
                self.state = "failed"
                raise RuntimeError("too many redirects")
            loc = _get_header(resp.headers, "Location")
            if not loc:
                self.state = "failed"
                raise RuntimeError("redirect without Location")
            self.endpoint = loc
            self.state = "idle"
            return self.post_offer(self._offer)
        if resp.status != 201:
            self.state = "failed"
            raise RuntimeError(f"WHIP endpoint returned {resp.status}")
        loc = _get_header(resp.headers, "Location")
        if not loc:
            self.state = "failed"
            raise RuntimeError("Location header field should be "
                               "present for WHIP resource URL")
        self.resource_url = loc
        self.answer_sdp = resp.body.decode()
        for k, v in resp.headers.items():
            if k.lower() == "link" and "ice-server" in v:
                self.ice_servers.append(v)
        self.state = "active"
        return None

    def trickle(self, sdpfrag: str) -> HttpRequest:
        if self.state != "active":
            raise RuntimeError("no active resource to PATCH")
        return HttpRequest("PATCH", self.resource_url,
                           self._headers(CONTENT_TRICKLE),
                           sdpfrag.encode())

    def teardown(self) -> HttpRequest:
        if self.resource_url is None:
            raise RuntimeError("no resource to DELETE")
        self.state = "terminated"
        h = {}
        if self.auth_token:
            h["Authorization"] = f"Bearer {self.auth_token}"
        return HttpRequest("DELETE", self.resource_url, h)


class WhipServer:
    """Sans-IO WHIP/WHEP endpoint (the whipserversrc counterpart).

    `answer_fn(session_id, offer_sdp) -> answer_sdp` supplies the
    media-layer answer.
    """

    def __init__(self, answer_fn, *, endpoint_path: str = "/whip",
                 resource_path: str = "/whip/resource"):
        self.answer_fn = answer_fn
        self.endpoint_path = endpoint_path.rstrip("/")
        self.resource_path = resource_path.rstrip("/")
        self.sessions: dict[str, dict] = {}

    def handle_request(self, req: HttpRequest) -> HttpResponse:
        path = req.url.split("?")[0]
        if req.method == "OPTIONS" and path == self.endpoint_path:
            return HttpResponse(204, {"Accept-Post": CONTENT_SDP})
        if req.method == "POST" and path == self.endpoint_path:
            ctype = _get_header(req.headers, "Content-Type") or ""
            if ctype.split(";")[0].strip() != CONTENT_SDP:
                return HttpResponse(415)
            sid = secrets.token_hex(8)
            offer = req.body.decode()
            answer = self.answer_fn(sid, offer)
            self.sessions[sid] = {"offer": offer, "answer": answer,
                                  "candidates": []}
            return HttpResponse(
                201,
                {"Location": f"{self.resource_path}/{sid}",
                 "Content-Type": CONTENT_SDP},
                answer.encode())
        if path.startswith(self.resource_path + "/"):
            sid = path[len(self.resource_path) + 1:]
            sess = self.sessions.get(sid)
            if sess is None:
                return HttpResponse(404)
            if req.method == "PATCH":
                ctype = _get_header(req.headers, "Content-Type") or ""
                if ctype.split(";")[0].strip() != CONTENT_TRICKLE:
                    return HttpResponse(415)
                sess["candidates"].append(req.body.decode())
                return HttpResponse(204)
            if req.method == "DELETE":
                del self.sessions[sid]
                return HttpResponse(200)
            return HttpResponse(405, {"Allow": "PATCH, DELETE"})
        return HttpResponse(404)


# WHEP shares the exact HTTP state machine; only the media direction
# differs (the POSTer consumes instead of publishing).
WhepClientSession = WhipClientSession


class WhepServer(WhipServer):
    def __init__(self, answer_fn, *, endpoint_path: str = "/whep",
                 resource_path: str = "/whep/resource"):
        super().__init__(answer_fn, endpoint_path=endpoint_path,
                         resource_path=resource_path)
