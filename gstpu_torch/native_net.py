"""ctypes bridge to the native media-plane IO (native/gstpu_net.cpp).

Batched UDP datagram IO: one call drains/fills a whole recvmmsg/
sendmmsg batch, which is the compiled hot path the reference keeps in
its threadshare runtime (SURVEY.md §2.9). Falls back to per-packet
Python socket calls when the .so is missing.

The port's copy of gstpu/native_net.py. The library is built by
`gstpu_torch.native.build_library` into `build/torch_ext/`, not by
`make -C native` into the checkout, and its two functions have their
ctypes `argtypes` declared.
"""

from __future__ import annotations

import ctypes
import socket

import numpy as np

from gstpu_torch.native import build_library

_LIB = None
_TRIED = False

MAX_BATCH = 256
DGRAM_STRIDE = 2048


def load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = build_library("gstpu_net.cpp")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i = ctypes.c_int
    lib.gstpu_net_recvmmsg.argtypes = (i, u8p, i, i, i32p, u32p, u16p)
    lib.gstpu_net_recvmmsg.restype = i
    lib.gstpu_net_sendmmsg.argtypes = (i, u8p, i, i32p, u32p, u16p, i)
    lib.gstpu_net_sendmmsg.restype = i
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


def recv_batch(sock: socket.socket, max_msgs: int = 64,
               stride: int = DGRAM_STRIDE) -> list[tuple[bytes, tuple]]:
    """Drain up to max_msgs datagrams in one native call (or a Python
    loop fallback). Non-blocking; returns [] when empty. `stride` is
    the per-datagram capacity (larger datagrams truncate)."""
    lib = load()
    if lib is None:
        out = []
        for _ in range(max_msgs):
            try:
                data, addr = sock.recvfrom(stride)
            except (BlockingIOError, InterruptedError):
                break
            out.append((data, addr))
        return out
    max_msgs = min(max_msgs, MAX_BATCH)
    buf = np.empty(max_msgs * stride, np.uint8)
    lengths = np.empty(max_msgs, np.int32)
    addrs = np.empty(max_msgs, np.uint32)
    ports = np.empty(max_msgs, np.uint16)
    n = lib.gstpu_net_recvmmsg(
        sock.fileno(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        stride, max_msgs,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        addrs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ports.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if n <= 0:
        return []
    out = []
    for i in range(n):
        data = bytes(buf[i * stride:i * stride + int(lengths[i])])
        # addrs holds s_addr bytes in memory order (network order)
        host = socket.inet_ntoa(int(addrs[i]).to_bytes(4, "little"))
        out.append((data, (host, int(ports[i]))))
    return out


def send_batch(sock: socket.socket,
               packets: list[tuple[bytes, tuple]]) -> int:
    """Send a batch of (data, (host, port)) datagrams; returns the
    number sent."""
    lib = load()
    if lib is None:
        sent = 0
        for data, addr in packets:
            try:
                sock.sendto(data, addr)
                sent += 1
            except (BlockingIOError, InterruptedError):
                break
        return sent
    total = 0
    for off in range(0, len(packets), MAX_BATCH):
        chunk = packets[off:off + MAX_BATCH]
        n = len(chunk)
        buf = np.zeros(n * DGRAM_STRIDE, np.uint8)
        lengths = np.empty(n, np.int32)
        addrs = np.empty(n, np.uint32)
        ports = np.empty(n, np.uint16)
        for i, (data, (host, port)) in enumerate(chunk):
            ln = min(len(data), DGRAM_STRIDE)
            buf[i * DGRAM_STRIDE:i * DGRAM_STRIDE + ln] = \
                np.frombuffer(data[:ln], np.uint8)
            lengths[i] = ln
            addrs[i] = int.from_bytes(socket.inet_aton(host),
                                      "little")
            ports[i] = port
        sent = lib.gstpu_net_sendmmsg(
            sock.fileno(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            DGRAM_STRIDE,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            addrs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ports.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            n)
        if sent < 0:
            break
        total += sent
        if sent < n:
            break
    return total
