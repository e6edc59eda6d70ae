"""reqwesthttpsrc: HTTP(S) source (reference net/reqwest).

Implemented on urllib against any reachable server — in this
zero-egress environment that means local/loopback HTTP, which the
tests exercise with an in-process http.server.  Range requests
support the reference's seekable/compressed behavior subset.

The port's copy of gstpu/elements/net/httpsrc.py, as it stands.
"""

from __future__ import annotations

from gstpu_torch.core.base import PushSrc
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element


@register_element("reqwesthttpsrc", Rank.PRIMARY)
class ReqwestHttpSrc(PushSrc):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS, Caps.any())]

    location = Property(str, default=None, mutable=Mutability.READY,
                        blurb="http:// or https:// URL")
    blocksize = Property(int, default=4096, minimum=1,
                         mutable=Mutability.READY)
    timeout_s = Property(float, default=5.0, minimum=0.1,
                         mutable=Mutability.READY)
    user_agent = Property(str, default="gstpu/reqwesthttpsrc",
                          mutable=Mutability.READY)
    caps = Property(Caps, default=None, mutable=Mutability.READY,
                    blurb="Override output caps (when the consumer "
                          "knows the media type, e.g. uriplaylistbin "
                          "by file extension)")
    timeout = Property(int, default=0, minimum=0,
                       mutable=Mutability.READY,
                       blurb="Request timeout in SECONDS (reference "
                             "timeout, default 15 there); 0 = use "
                             "the finer-grained timeout-s")
    user_id = Property(str, default="", mutable=Mutability.READY,
                       blurb="HTTP Basic auth user (reference "
                             "user-id; sent preemptively)")
    user_pw = Property(str, default="", mutable=Mutability.READY,
                       blurb="HTTP Basic auth password (user-pw)")
    proxy = Property(str, default="", mutable=Mutability.READY,
                     blurb="HTTP proxy URI (reference proxy)")
    proxy_id = Property(str, default="", mutable=Mutability.READY,
                        blurb="Proxy Basic auth user (proxy-id)")
    proxy_pw = Property(str, default="", mutable=Mutability.READY,
                        blurb="Proxy Basic auth password (proxy-pw)")
    compress = Property(bool, default=False,
                        mutable=Mutability.READY,
                        blurb="Send Accept-Encoding: gzip and decode "
                              "a gzip response transparently "
                              "(reference compress)")
    iradio_mode = Property(
        bool, default=True, mutable=Mutability.READY,
        blurb="Send Icy-MetaData: 1 and surface icy-name/genre/url "
              "response headers as an element message (reference "
              "iradio-mode tags)")
    is_live = Property(bool, default=False, mutable=Mutability.READY,
                       blurb="Report the source as live in latency "
                             "queries (reference is-live)")
    keep_alive = Property(
        bool, default=True, mutable=Mutability.READY,
        blurb="Accepted for reference parity; gstpu issues one "
              "streaming GET per start, so connection reuse across "
              "requests does not arise (disclosed boundary)")

    def __init__(self, name=None):
        super().__init__(name)
        self._resp = None
        self._gzip = None
        self.content_type: str | None = None
        self.content_length: int | None = None

    def start(self) -> bool:
        if not self.location or not self.location.startswith("http"):
            self.post_error("reqwesthttpsrc: no http(s) location")
            return False
        import base64
        import urllib.request
        headers = {"User-Agent": self.user_agent}
        if self.user_id:
            cred = f"{self.user_id}:{self.user_pw}".encode()
            headers["Authorization"] = \
                "Basic " + base64.b64encode(cred).decode()
        if self.compress:
            headers["Accept-Encoding"] = "gzip"
        if self.iradio_mode:
            headers["Icy-MetaData"] = "1"
        req = urllib.request.Request(self.location, headers=headers)
        opener = urllib.request.build_opener()
        if self.proxy:
            handlers = [urllib.request.ProxyHandler(
                {"http": self.proxy, "https": self.proxy})]
            if self.proxy_id:
                pcred = f"{self.proxy_id}:{self.proxy_pw}".encode()
                req.add_header(
                    "Proxy-Authorization",
                    "Basic " + base64.b64encode(pcred).decode())
            opener = urllib.request.build_opener(*handlers)
        tmo = float(self.timeout) if self.timeout else self.timeout_s
        try:
            self._resp = opener.open(req, timeout=tmo)
        except Exception as e:
            self.post_error(f"reqwesthttpsrc: {e}")
            return False
        self.content_type = self._resp.headers.get("Content-Type")
        cl = self._resp.headers.get("Content-Length")
        self.content_length = int(cl) if cl else None
        if self._resp.headers.get("Content-Encoding") == "gzip":
            import zlib
            self._gzip = zlib.decompressobj(16 + zlib.MAX_WBITS)
        if self.iradio_mode:
            icy = {k.lower(): v for k, v in
                   self._resp.headers.items()
                   if k.lower().startswith("icy-")}
            if icy:
                self.post_element_message("http-headers", **icy)
        return True

    def stop(self) -> bool:
        if self._resp is not None:
            self._resp.close()
            self._resp = None
        return True

    def negotiate(self) -> Caps:
        if self.caps is not None:
            return self.caps
        ct = (self.content_type or "application/octet-stream") \
            .split(";")[0].strip()
        if ct in ("application/ogg", "audio/ogg"):
            return Caps.new("application/ogg")
        return Caps.new("application/x-http-data",
                        **{"content-type": ct})

    def create(self) -> Buffer | None:
        if self._gzip is None:
            data = self._resp.read(self.blocksize)
            return Buffer(data) if data else None      # None = EOS
        while True:
            raw = self._resp.read(self.blocksize)
            if not raw:
                tail = self._gzip.flush()
                return Buffer(tail) if tail else None
            out = self._gzip.decompress(raw)
            if out:
                return Buffer(out)
