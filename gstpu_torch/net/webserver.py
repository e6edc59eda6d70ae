"""Embedded static web server (reference webrtcsink run-web-server,
net/webrtc/src/webrtcsink/imp.rs:2620-2700: a warp `fs::dir` route,
optional URL path prefix, optional TLS).  Serves the configured
directory — in the reference's deployment story that is the
gstwebrtc-api bundle next to the signalling server, so a browser can
load the player page straight from the producing element.

The port's copy of gstpu/net/webserver.py, as it stands.
"""

from __future__ import annotations

import threading
from functools import partial
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit


class _PrefixedHandler(SimpleHTTPRequestHandler):
    """SimpleHTTPRequestHandler bound to a directory, optionally
    mounted under a single path segment (reference web-server-path:
    `warp::path(path).and(fs::dir(...))`)."""

    prefix: str | None = None

    def translate_path(self, path: str) -> str:
        if self.prefix:
            want = "/" + self.prefix
            if path == want:
                path = "/"
            elif path.startswith(want + "/"):
                path = path[len(want):]
            else:
                # out of mount: resolve to a path that cannot exist
                return ""
        return super().translate_path(path)

    def log_message(self, fmt, *args):       # quiet: bus, not stderr
        pass


class StaticWebServer:
    def __init__(self, host_addr: str = "http://127.0.0.1:8080",
                 directory: str = ".", path: str | None = None,
                 cert: str | None = None, key: str | None = None):
        u = urlsplit(host_addr)
        host = u.hostname or "127.0.0.1"
        port = u.port if u.port is not None else \
            (443 if u.scheme == "https" else 80)
        # mount prefix rides a class attribute: the partial only
        # forwards constructor kwargs SimpleHTTPRequestHandler knows
        self._handler_cls = type("Handler", (_PrefixedHandler,),
                                 {"prefix": (path or None)})
        self._httpd = ThreadingHTTPServer(
            (host, port),
            partial(self._handler_cls, directory=directory))
        self.tls = False
        if cert and key:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert, key)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True)
            self.tls = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"webserver-{self.port}", daemon=True)

    @property
    def uri(self) -> str:
        scheme = "https" if self.tls else "http"
        suffix = f"/{self._handler_cls.prefix}" \
            if self._handler_cls.prefix else ""
        return f"{scheme}://{self.host}:{self.port}{suffix}"

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
