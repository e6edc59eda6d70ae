"""Network-synchronized pipeline clocks.

NtpClock: an SNTP (RFC 4330) client clock — the gstpu counterpart of
the reference's `gst_net::NtpClock` (used by webrtcsink's RFC 7273
clock signalling, net/webrtc/src/webrtcsink/imp.rs:2405-2460).  The
clock polls the server in a daemon thread, maintains a smoothed
offset against the local monotonic clock, and reports NTP-era time
(nanoseconds since 1900-01-01) like the reference's clock does.

RFC 7273 boundary: `ts_refclk()` is the Clock-level hook webrtcsink
uses for the `a=ts-refclk` SDP attribute.  NtpClock answers
"ntp=<addr>[:port]"; clocks without network provenance answer None
(→ "local"/"sender").  A PTP clock (IEEE 1588 stack) is NOT
implemented — a deployment with one can subclass Clock and return
"ptp=IEEE1588-2008:..." from ts_refclk().

The port's copy of gstpu/core/netclock.py, as it stands.
"""

from __future__ import annotations

import socket
import struct
import threading
import time as _time

from gstpu_torch.core.clock import Clock

NTP_PORT = 123
# seconds between 1900-01-01 (NTP era 0) and 1970-01-01 (Unix epoch)
NTP_UNIX_OFFSET = 2_208_988_800
SECOND = 1_000_000_000


def _to_ntp_ts(unix_ns: int) -> tuple[int, int]:
    secs, frac_ns = divmod(unix_ns, SECOND)
    return secs + NTP_UNIX_OFFSET, (frac_ns << 32) // SECOND


def _from_ntp_ts(secs: int, frac: int) -> int:
    """NTP timestamp -> ns since the NTP era (1900)."""
    return secs * SECOND + ((frac * SECOND) >> 32)


def sntp_request(sock: socket.socket, addr, timeout: float = 1.0):
    """One RFC 4330 exchange; returns (offset_ns, delay_ns) of the
    server clock relative to local unix time, or None."""
    t1_unix = _time.time_ns()
    s, f = _to_ntp_ts(t1_unix)
    # LI=0 VN=4 Mode=3 (client); transmit timestamp = t1
    pkt = struct.pack(">BBBb11I", 0x23, 0, 0, 0,
                      0, 0, 0, 0, 0, 0, 0, 0, 0, s & 0xFFFFFFFF, f)
    sock.settimeout(timeout)
    try:
        sock.sendto(pkt, addr)
        data, _ = sock.recvfrom(1024)
    except OSError:
        return None
    t4_unix = _time.time_ns()
    if len(data) < 48:
        return None
    vals = struct.unpack(">BBBb11I", data[:48])
    mode = vals[0] & 0x07
    if mode not in (4, 5):              # server / broadcast
        return None
    # fields after the 4-byte header: rootdelay, rootdisp, refid,
    # ref_ts(2), originate(2), receive(2), transmit(2)
    t2 = _from_ntp_ts(vals[11], vals[12])   # receive ts (NTP era ns)
    t3 = _from_ntp_ts(vals[13], vals[14])   # transmit ts
    t1 = t1_unix + NTP_UNIX_OFFSET * SECOND
    t4 = t4_unix + NTP_UNIX_OFFSET * SECOND
    offset = ((t2 - t1) + (t3 - t4)) // 2
    delay = (t4 - t1) - (t3 - t2)
    return offset, delay


class NtpClock(Clock):
    """SNTP-disciplined clock reporting ns since the NTP era.

    One synchronous poll runs at construction (raises on failure so a
    dead server is caught at set-up, like the reference's NtpClock
    "synced" wait); a daemon thread then re-polls every
    `poll_interval` seconds and smooths the offset (EWMA 0.5 — SNTP
    jitter on a LAN is microseconds, and pipeline consumers only need
    media-clock stability, not PLL-grade slew)."""

    def __init__(self, address: str, port: int = NTP_PORT,
                 poll_interval: float = 16.0):
        self.address = address
        self.port = port
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._offset = None          # server - local_unix, ns
        self._lock = threading.Lock()
        self._stop = threading.Event()
        r = sntp_request(self._sock, (address, port))
        if r is None:
            self._sock.close()
            raise OSError(f"NTP server {address}:{port} did not answer")
        self._offset = r[0]
        self._poll_interval = poll_interval
        self._thread = threading.Thread(
            target=self._run, name=f"ntpclock-{address}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_interval):
            r = sntp_request(self._sock, (self.address, self.port))
            if r is not None:
                with self._lock:
                    self._offset = (self._offset + r[0]) // 2

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def time(self) -> int:
        with self._lock:
            off = self._offset
        return _time.time_ns() + NTP_UNIX_OFFSET * SECOND + off

    # -- RFC 7273 ------------------------------------------------------
    def ts_refclk(self) -> str:
        if self.port == NTP_PORT:
            return f"ntp={self.address}"
        return f"ntp={self.address}:{self.port}"
