"""tcpclientsrc / tcpserversink (reference threadshare
ts-tcpclientsrc + core tcp elements): non-blocking sockets on the
cooperative scheduler.

The port's copy of gstpu/elements/net/tcp.py, as it stands.
"""

from __future__ import annotations

import socket

from gstpu_torch.core.base import BaseSink, PushSrc
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element


@register_element("tcpclientsrc", Rank.NONE)
class TcpClientSrc(PushSrc):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS, Caps.any())]

    host = Property(str, default="127.0.0.1", mutable=Mutability.READY)
    port = Property(int, default=4953, minimum=0, maximum=65535,
                    mutable=Mutability.READY)
    blocksize = Property(int, default=4096, minimum=1)
    caps = Property(Caps, default=None, mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._sock: socket.socket | None = None
        self.is_live = True

    def start(self) -> bool:
        try:
            self._sock = socket.create_connection((self.host, self.port),
                                                  timeout=5)
        except OSError as e:
            self.post_error(f"tcpclientsrc: connect failed: {e}")
            return False
        self._sock.setblocking(False)
        return True

    def stop(self) -> bool:
        if self._sock:
            self._sock.close()
            self._sock = None
        return True

    def negotiate(self) -> Caps:
        return self.caps if self.caps is not None \
            else Caps.new("application/octet-stream")

    def create(self) -> Buffer | None:
        try:
            data = self._sock.recv(self.blocksize)
        except BlockingIOError:
            raise FlowError(FlowReturn.FLUSHING, "no data")
        if not data:
            return None  # connection closed -> EOS
        buf = Buffer(data)
        if self.clock is not None:
            buf.pts = self.running_time()
        return buf


@register_element("tcpserversink", Rank.NONE)
class TcpServerSink(BaseSink):
    """Accepts clients and fans buffers out to all of them."""

    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS, Caps.any())]

    host = Property(str, default="127.0.0.1", mutable=Mutability.READY)
    port = Property(int, default=0, minimum=0, maximum=65535,
                    mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._srv: socket.socket | None = None
        self._clients: list[socket.socket] = []

    @property
    def bound_port(self) -> int:
        return self._srv.getsockname()[1] if self._srv else 0

    def start(self) -> bool:
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.host, self.port))
        self._srv.listen(16)
        self._srv.setblocking(False)
        return True

    def stop(self) -> bool:
        for c in self._clients:
            c.close()
        self._clients = []
        if self._srv:
            self._srv.close()
            self._srv = None
        return True

    def _accept_pending(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except (BlockingIOError, OSError):
                return
            conn.setblocking(True)
            self._clients.append(conn)

    def render(self, buf: Buffer):
        self._accept_pending()
        data = buf.to_bytes()
        dead = []
        for c in self._clients:
            try:
                c.sendall(data)
            except OSError:
                dead.append(c)
        for c in dead:
            self._clients.remove(c)
            c.close()
        return FlowReturn.OK
