"""Google Congestion Control bandwidth estimation (sans-IO core).

Rebuilds the reference rtpgccbwe's estimator
(net/rtp/src/gcc/imp.rs: delay-based trendline/Kalman estimator over
TWCC feedback + loss-based controller + AIMD rate control) as a pure
state machine fed with per-packet (send_time, recv_time, size)
feedback — no sockets, no clocks, fully testable (§5.8 sans-IO
discipline).

The port's copy of gstpu/net/rtp/gcc.py, as it stands.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field

SECOND = 1_000_000_000
BURST_INTERVAL = 5_000_000  # 5 ms packet grouping like webrtc


class Usage(enum.Enum):
    NORMAL = "normal"
    OVER = "overusing"
    UNDER = "underusing"


class RateState(enum.Enum):
    INCREASE = "increase"
    HOLD = "hold"
    DECREASE = "decrease"


@dataclass
class PacketFeedback:
    send_time: int   # ns
    recv_time: int   # ns
    size: int        # bytes


@dataclass
class _Group:
    first_send: int
    last_send: int
    first_recv: int
    last_recv: int
    size: int


class TrendlineEstimator:
    """Linear-regression slope of smoothed one-way delay gradient
    (webrtc's trendline filter)."""

    WINDOW = 20
    SMOOTHING = 0.9
    GAIN = 4.0

    def __init__(self):
        self._history: list[tuple[float, float]] = []
        self._acc_delay = 0.0
        self._smoothed = 0.0
        self._first_arrival: int | None = None

    def update(self, delta_ms: float, arrival: int) -> float:
        if self._first_arrival is None:
            self._first_arrival = arrival
        self._acc_delay += delta_ms
        self._smoothed = (self.SMOOTHING * self._smoothed
                          + (1 - self.SMOOTHING) * self._acc_delay)
        t = (arrival - self._first_arrival) / 1e6  # ms
        self._history.append((t, self._smoothed))
        if len(self._history) > self.WINDOW:
            self._history.pop(0)
        if len(self._history) < 2:
            return 0.0
        xs = [h[0] for h in self._history]
        ys = [h[1] for h in self._history]
        mx = sum(xs) / len(xs)
        my = sum(ys) / len(ys)
        num = sum((x - mx) * (y - my) for x, y in self._history)
        den = sum((x - mx) ** 2 for x in xs)
        slope = num / den if den else 0.0
        return slope * self.GAIN * min(len(self._history), 60)


class OveruseDetector:
    """Adaptive-threshold overuse detection (webrtc K_u/K_d)."""

    K_U = 0.01
    K_D = 0.00018

    def __init__(self):
        self.threshold = 12.5
        self._last_update: int | None = None

    def detect(self, trend_ms: float, now: int) -> Usage:
        if self._last_update is None:
            self._last_update = now
        dt_ms = min((now - self._last_update) / 1e6, 100.0)
        self._last_update = now
        if abs(trend_ms) < self.threshold + 15:
            k = self.K_D if abs(trend_ms) < self.threshold else self.K_U
            self.threshold += k * (abs(trend_ms) - self.threshold) * dt_ms
            self.threshold = min(max(self.threshold, 6.0), 600.0)
        if trend_ms > self.threshold:
            return Usage.OVER
        if trend_ms < -self.threshold:
            return Usage.UNDER
        return Usage.NORMAL


class GccEstimator:
    """Combined delay + loss controller with AIMD rate shaping."""

    def __init__(self, start_bitrate: int = 1_000_000,
                 min_bitrate: int = 100_000,
                 max_bitrate: int = 50_000_000):
        self.bitrate = start_bitrate
        self.min_bitrate = min_bitrate
        self.max_bitrate = max_bitrate
        self.state = RateState.INCREASE
        self._trend = TrendlineEstimator()
        self._detector = OveruseDetector()
        self._cur_group: _Group | None = None
        self._prev_group: _Group | None = None
        self._recv_window: list[tuple[int, int]] = []  # (recv, size)
        self.last_usage = Usage.NORMAL

    # -- feedback ingestion ---------------------------------------------
    def process_feedback(self, packets: list[PacketFeedback]) -> int:
        """Feed one TWCC feedback batch; returns the new bitrate."""
        lost = sum(1 for p in packets if p.recv_time < 0)
        received = [p for p in packets if p.recv_time >= 0]
        loss = lost / max(len(packets), 1)
        now = received[-1].recv_time if received else 0
        for p in received:
            self._recv_window.append((p.recv_time, p.size))
            self._group_packet(p)
        self._recv_window = [(t, s) for t, s in self._recv_window
                             if now - t <= SECOND]
        # rate adjustments once per feedback batch (webrtc adjusts per
        # feedback interval, not per packet group)
        self._apply_delay(self.last_usage)
        self._apply_loss(loss)
        return self.bitrate

    def _group_packet(self, p: PacketFeedback) -> None:
        g = self._cur_group
        if g is None or p.send_time - g.first_send > BURST_INTERVAL:
            if g is not None and self._prev_group is not None:
                self._inter_group(self._prev_group, g)
            self._prev_group = self._cur_group
            self._cur_group = _Group(p.send_time, p.send_time,
                                     p.recv_time, p.recv_time, p.size)
        else:
            g.last_send = max(g.last_send, p.send_time)
            g.last_recv = max(g.last_recv, p.recv_time)
            g.size += p.size

    def _inter_group(self, prev: _Group, cur: _Group) -> None:
        send_delta = (cur.last_send - prev.last_send) / 1e6
        recv_delta = (cur.last_recv - prev.last_recv) / 1e6
        delta = recv_delta - send_delta  # delay gradient (ms)
        trend = self._trend.update(delta, cur.last_recv)
        self.last_usage = self._detector.detect(trend, cur.last_recv)

    # -- rate control -----------------------------------------------------
    def _receive_rate(self) -> int | None:
        if len(self._recv_window) < 2:
            return None
        t0 = min(t for t, _ in self._recv_window)
        t1 = max(t for t, _ in self._recv_window)
        if t1 <= t0:
            return None
        total = sum(s for _, s in self._recv_window)
        return int(total * 8 * SECOND / (t1 - t0))

    def _apply_delay(self, usage: Usage) -> None:
        if usage is Usage.OVER:
            self.state = RateState.DECREASE
            rr = self._receive_rate()
            base = rr if rr is not None else self.bitrate
            self.bitrate = max(int(0.85 * base), self.min_bitrate)
        elif usage is Usage.NORMAL:
            if self.state is RateState.DECREASE:
                self.state = RateState.HOLD
            elif self.state is RateState.HOLD:
                self.state = RateState.INCREASE
            if self.state is RateState.INCREASE:
                self.bitrate = min(int(self.bitrate * 1.05),
                                   self.max_bitrate)
        else:  # UNDER: queues draining, hold
            self.state = RateState.HOLD

    def _apply_loss(self, loss: float) -> None:
        if loss > 0.10:
            self.bitrate = max(int(self.bitrate * (1 - 0.5 * loss)),
                               self.min_bitrate)
        elif loss < 0.02 and self.state is RateState.INCREASE:
            self.bitrate = min(int(self.bitrate * 1.02),
                               self.max_bitrate)
