"""Clock and time: nanosecond integer timestamps, pipeline clocks.

Mirrors GstClock semantics the reference's live elements depend on
(reference utils/livesync/src/livesync/imp.rs:148-210 running-time math;
net/mpegtslive PCR-slaved clock): times are int nanoseconds, NONE is
represented as Python None.
"""

from __future__ import annotations

import threading
import time as _time

ClockTime = int  # nanoseconds; None == CLOCK_TIME_NONE

NSECOND: ClockTime = 1
USECOND: ClockTime = 1_000
MSECOND: ClockTime = 1_000_000
SECOND: ClockTime = 1_000_000_000


def format_time(t: ClockTime | None) -> str:
    if t is None:
        return "--:--:--.---------"
    s, ns = divmod(t, SECOND)
    m, s = divmod(s, 60)
    h, m = divmod(m, 60)
    return f"{h}:{m:02d}:{s:02d}.{ns:09d}"


class Clock:
    """Abstract monotonic clock."""

    def time(self) -> ClockTime:
        raise NotImplementedError

    def ts_refclk(self) -> str | None:
        """RFC 7273 reference-clock description ("ntp=...",
        "ptp=IEEE1588-2008:...") for clocks with network provenance;
        None means no traceable reference (SDP signals
        ts-refclk:local / mediaclk:sender).  Used by webrtcsink's
        do-clock-signalling (reference webrtcsink/imp.rs:2405)."""
        return None

    def wait_until(self, t: ClockTime) -> None:
        """Block until clock reaches t (best effort)."""
        while True:
            now = self.time()
            if now >= t:
                return
            self._sleep(t - now)

    def _sleep(self, dt: ClockTime) -> None:
        _time.sleep(dt / SECOND)


class SystemClock(Clock):
    """Monotonic OS clock (the default pipeline clock)."""

    _instance = None

    def __init__(self):
        self._epoch = _time.monotonic_ns()

    @classmethod
    def obtain(cls) -> "SystemClock":
        if cls._instance is None:
            cls._instance = SystemClock()
        return cls._instance

    def time(self) -> ClockTime:
        return _time.monotonic_ns() - self._epoch


class TestClock(Clock):
    """Manually-advanced clock for deterministic tests.

    Analogue of gst_check's test clock used by harness-driven tests
    (reference audio/hrtf/tests/hrtfrender.rs uses no clock; timeout
    aggregation tests need one).
    """

    def __init__(self, start: ClockTime = 0):
        self._now = start
        self._cond = threading.Condition()

    def time(self) -> ClockTime:
        with self._cond:
            return self._now

    def advance(self, dt: ClockTime) -> None:
        with self._cond:
            self._now += dt
            self._cond.notify_all()

    def set_time(self, t: ClockTime) -> None:
        with self._cond:
            self._now = max(self._now, t)
            self._cond.notify_all()

    def wait_until(self, t: ClockTime) -> None:
        with self._cond:
            while self._now < t:
                self._cond.wait()

    def _sleep(self, dt: ClockTime) -> None:  # pragma: no cover
        raise RuntimeError("TestClock cannot sleep; advance() it instead")
