"""RFC 9002 loss recovery & congestion control for the QUIC stack.

The reference gets this machinery from quinn-proto
(net/quinn/Cargo.toml); rebuilt here sans-IO: time is an injected
monotonic-seconds value, so tests drive loss/recovery
deterministically (VERDICT r2 item 4).

* RttEstimator — §5: min/latest/smoothed RTT + rttvar, PTO period
  with exponential backoff.
* NewReno — §7: slow start, congestion avoidance, one congestion
  event per recovery period, persistent-congestion-free minimum
  window; plus a simple cwnd/srtt pacing rate.
* RangeSet — received packet-number interval tracking so ACK frames
  report real holes (an ACK claiming lost packets were received
  would defeat recovery entirely).

The port's copy of gstpu/net/quic/recovery.py, as it stands.
"""

from __future__ import annotations

from dataclasses import dataclass

GRANULARITY = 0.001          # kGranularity, seconds
MAX_ACK_DELAY = 0.025
PACKET_THRESHOLD = 3         # kPacketThreshold (§6.1.1)
TIME_THRESHOLD = 9 / 8       # kTimeThreshold (§6.1.2)
MAX_DATAGRAM = 1200
INITIAL_WINDOW = 10 * MAX_DATAGRAM
MIN_WINDOW = 2 * MAX_DATAGRAM


class RttEstimator:
    """§5.3 smoothed RTT / RTT variance."""

    def __init__(self):
        self.latest = 0.0
        self.min_rtt = float("inf")
        self.smoothed: float | None = None
        self.rttvar = 0.0

    def update(self, latest: float, ack_delay: float = 0.0) -> None:
        latest = max(latest, GRANULARITY)
        self.latest = latest
        self.min_rtt = min(self.min_rtt, latest)
        if self.smoothed is None:
            self.smoothed = latest
            self.rttvar = latest / 2
            return
        adjusted = latest
        if latest >= self.min_rtt + ack_delay:
            adjusted = latest - ack_delay
        self.rttvar = 0.75 * self.rttvar \
            + 0.25 * abs(self.smoothed - adjusted)
        self.smoothed = 0.875 * self.smoothed + 0.125 * adjusted

    def pto(self) -> float:
        """Base probe timeout period (§6.2.1), before backoff."""
        if self.smoothed is None:
            return 2 * 0.333             # kInitialRtt-based default
        return self.smoothed + max(4 * self.rttvar, GRANULARITY) \
            + MAX_ACK_DELAY

    def loss_delay(self) -> float:
        """Time-threshold loss delay (§6.1.2)."""
        if self.smoothed is None:
            return 2 * 0.333
        return max(TIME_THRESHOLD * max(self.latest, self.smoothed),
                   GRANULARITY)


class NewReno:
    """§7 congestion controller."""

    def __init__(self):
        self.cwnd = INITIAL_WINDOW
        self.ssthresh = float("inf")
        self.bytes_in_flight = 0
        self.recovery_start = -1.0

    def on_sent(self, size: int) -> None:
        self.bytes_in_flight += size

    def can_send(self, size: int) -> bool:
        return self.bytes_in_flight + size <= self.cwnd

    def on_acked(self, size: int, time_sent: float) -> None:
        self.bytes_in_flight = max(0, self.bytes_in_flight - size)
        if time_sent <= self.recovery_start:
            return                       # recovery period: no growth
        if self.cwnd < self.ssthresh:
            self.cwnd += size            # slow start
        else:
            self.cwnd += MAX_DATAGRAM * size / self.cwnd

    def on_lost(self, size: int, time_sent: float, now: float) -> None:
        self.bytes_in_flight = max(0, self.bytes_in_flight - size)
        self.on_congestion_event(time_sent, now)

    def on_congestion_event(self, time_sent: float,
                            now: float) -> None:
        if time_sent <= self.recovery_start:
            return                       # one event per period (§7.3.1)
        self.recovery_start = now
        self.ssthresh = max(self.cwnd / 2, MIN_WINDOW)
        self.cwnd = self.ssthresh

    def pacing_interval(self, rtt: RttEstimator) -> float:
        """Seconds between datagrams at ~1.25x cwnd/srtt (§7.7)."""
        srtt = rtt.smoothed if rtt.smoothed is not None else 0.333
        rate = 1.25 * self.cwnd / max(srtt, GRANULARITY)
        return MAX_DATAGRAM / max(rate, 1.0)


@dataclass
class SentPacket:
    pn: int
    frames: bytes                # ack-eliciting frames to retransmit
    time_sent: float
    size: int
    ack_eliciting: bool


class RangeSet:
    """Merged, sorted received-pn intervals for honest ACK frames.

    Bounded: only the newest MAX_RANGES intervals are kept (ACK
    frames report at most 32 anyway), so permanent holes on a
    long-lived lossy connection cannot grow the list without bound."""

    MAX_RANGES = 64

    def __init__(self):
        self._ranges: list[list[int]] = []   # [lo, hi] ascending

    def add(self, pn: int) -> None:
        rs = self._ranges
        import bisect
        i = bisect.bisect_left([r[0] for r in rs], pn)
        # merge with predecessor / successor
        if i > 0 and rs[i - 1][1] + 1 >= pn:
            if pn > rs[i - 1][1]:
                rs[i - 1][1] = pn
                if i < len(rs) and rs[i][0] <= pn + 1:
                    rs[i - 1][1] = max(rs[i - 1][1], rs[i][1])
                    rs.pop(i)
            return
        if i < len(rs) and rs[i][0] <= pn + 1:
            rs[i][0] = min(rs[i][0], pn)
            rs[i][1] = max(rs[i][1], pn)
            return
        rs.insert(i, [pn, pn])
        if len(rs) > self.MAX_RANGES:
            del rs[0]                    # oldest pns age out

    def __contains__(self, pn: int) -> bool:
        return any(lo <= pn <= hi for lo, hi in self._ranges)

    def descending(self) -> list[tuple[int, int]]:
        return [(lo, hi) for lo, hi in reversed(self._ranges)]

    @property
    def largest(self) -> int:
        return self._ranges[-1][1] if self._ranges else -1
