"""udpsrc / udpsink: socket elements (reference net/udp rsudp +
threadshare ts-udpsrc/sink). Non-blocking sockets polled from the
cooperative scheduler loop — the threadshare model without per-element
threads.

The port's copy of gstpu/elements/net/udp.py, as it stands.
"""

from __future__ import annotations

import socket

from gstpu_torch.core.base import BaseSink, PushSrc
from gstpu_torch.core.buffer import Buffer, NetAddressMeta
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element


@register_element("udpsrc", Rank.NONE)
class UdpSrc(PushSrc):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS, Caps.any())]

    address = Property(str, default="0.0.0.0", mutable=Mutability.READY)
    port = Property(int, default=5004, minimum=0, maximum=65535,
                    mutable=Mutability.READY)
    caps = Property(Caps, default=None, mutable=Mutability.READY)
    buffer_size = Property(int, default=65536, minimum=1)
    context = Property(str, default=None, mutable=Mutability.READY,
                       blurb="Shared scheduling context: elements with "
                             "the same name run epoll-driven on ONE "
                             "context thread (ts-udpsrc semantics, "
                             "threadshare runtime/mod.rs)")
    context_wait = Property(int, default=0, minimum=0, maximum=1000,
                            mutable=Mutability.READY,
                            blurb="Context throttle period (ms)")
    uri = Property(str, default="", mutable=Mutability.READY,
                   blurb="udp://address:port shorthand for "
                         "address+port (reference uri)")
    auto_multicast = Property(
        bool, default=True, mutable=Mutability.READY,
        blurb="Join the multicast group automatically when address "
              "is a multicast address (reference auto-multicast)")
    multicast_iface = Property(
        str, default="", mutable=Mutability.READY,
        blurb="Interface (name or address) for the multicast join; "
              "empty = default (reference multicast-iface — an "
              "address form binds IP_ADD_MEMBERSHIP's imr_interface)")
    loop = Property(bool, default=True, mutable=Mutability.READY,
                    blurb="IP_MULTICAST_LOOP: receive our own "
                          "multicast sends (reference loop)")
    reuse = Property(bool, default=True, mutable=Mutability.READY,
                     blurb="SO_REUSEADDR on the bound socket "
                           "(reference reuse)")
    skip_first_bytes = Property(
        int, default=0, minimum=0, mutable=Mutability.READY,
        blurb="Strip this many bytes from the front of every "
              "datagram (reference skip-first-bytes)")
    mtu = Property(int, default=0, minimum=0, maximum=65535,
                   mutable=Mutability.READY,
                   blurb="Expected datagram size for the receive "
                         "batching (reference mtu, default 1492 "
                         "there with auto-grow; gstpu's recvmmsg "
                         "stride is fixed, so 0 = use buffer-size "
                         "and never truncate)")

    def __init__(self, name=None):
        super().__init__(name)
        self._sock: socket.socket | None = None
        self._rx_queue = __import__("collections").deque()
        self.is_live = True

    def iterate_tasks(self):
        tasks = super().iterate_tasks()
        if self.context and tasks and self._sock is not None:
            t = tasks[0]
            t.context_name = self.context
            t.context_wait = self.context_wait / 1000.0
            t.watch_sock = self._sock
        return tasks

    def start(self) -> bool:
        if self.uri:
            from urllib.parse import urlsplit
            u = urlsplit(self.uri)
            if u.scheme != "udp" or u.port is None:
                self.post_error(f"udpsrc: bad uri {self.uri!r}")
                return False
            self.address = u.hostname or "0.0.0.0"
            self.port = u.port
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if self.port != 0 and self.reuse:
            # REUSEADDR on an ephemeral bind lets the kernel hand the
            # SAME port to two sockets (datagrams then reach only one)
            self._sock.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        addr = self.address
        is_mcast = False
        try:
            first = int(addr.split(".")[0])
            is_mcast = 224 <= first <= 239
        except ValueError:
            pass
        # a multicast group must be joined on the wildcard bind
        self._sock.bind(("" if is_mcast else addr, self.port))
        if is_mcast and self.auto_multicast:
            import struct as _struct
            iface = self.multicast_iface or "0.0.0.0"
            try:
                socket.inet_aton(iface)
            except OSError:
                # interface NAME: resolve to its first IPv4 address
                try:
                    import fcntl
                    ifr = fcntl.ioctl(
                        self._sock.fileno(), 0x8915,     # SIOCGIFADDR
                        _struct.pack("256s", iface.encode()[:15]))
                    iface = socket.inet_ntoa(ifr[20:24])
                except OSError:
                    iface = "0.0.0.0"
            mreq = socket.inet_aton(addr) + socket.inet_aton(iface)
            self._sock.setsockopt(socket.IPPROTO_IP,
                                  socket.IP_ADD_MEMBERSHIP, mreq)
            self._sock.setsockopt(socket.IPPROTO_IP,
                                  socket.IP_MULTICAST_LOOP,
                                  int(self.loop))
        self._sock.setblocking(False)
        return True

    @property
    def bound_port(self) -> int:
        return self._sock.getsockname()[1] if self._sock else 0

    def stop(self) -> bool:
        if self._sock:
            self._sock.close()
            self._sock = None
        return True

    def negotiate(self) -> Caps:
        return self.caps if self.caps is not None \
            else Caps.new("application/octet-stream")

    def create(self) -> Buffer | None:
        # drain a whole batch per wakeup through the native
        # recvmmsg path (media plane in C++, SURVEY §2.9); queued
        # packets are handed out one per create()
        if not self._rx_queue:
            from gstpu_torch.native_net import recv_batch
            stride = min(self.mtu or self.buffer_size, 65536)
            msgs = max(1, min(64, 131072 // stride))
            self._rx_queue.extend(
                recv_batch(self._sock, msgs, stride))
        if not self._rx_queue:
            raise FlowError(FlowReturn.FLUSHING, "no datagram")
        data, addr = self._rx_queue.popleft()
        if self.skip_first_bytes:
            data = data[self.skip_first_bytes:]
        buf = Buffer(data)
        if self.clock is not None:
            buf.pts = self.running_time()
        buf.add_meta(NetAddressMeta(addr))
        return buf


@register_element("udpsink", Rank.NONE)
class UdpSink(BaseSink):
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS, Caps.any())]

    host = Property(str, default="127.0.0.1", mutable=Mutability.PLAYING)
    port = Property(int, default=5004, minimum=0, maximum=65535,
                    mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self._sock: socket.socket | None = None
        self.sent = 0

    def start(self) -> bool:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        return True

    def stop(self) -> bool:
        if self._sock:
            self._sock.close()
            self._sock = None
        return True

    def render(self, buf: Buffer):
        self._sock.sendto(buf.to_bytes(), (self.host, self.port))
        self.sent += 1
        return FlowReturn.OK
