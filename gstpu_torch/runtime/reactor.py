"""IO reactor + timer wheel for the cooperative scheduler.

The analogue of the reference threadshare executor's reactor
(generic/threadshare/src/runtime/executor/reactor.rs — epoll/kqueue
backends) and timers (executor/timer.rs): one selector + one timer
heap per Context, so hundreds of socket elements share one OS thread
that sleeps in epoll until a socket is readable or a timer is due —
no busy polling.  A socketpair waker lets other threads (or timer
arming) interrupt a blocking poll, like the reference's waker fd.
"""

from __future__ import annotations

import heapq
import itertools
import selectors
import socket
import threading
import time
from typing import Callable

from gstpu_torch.utils.log import debug_category

CAT = debug_category("reactor")


class Timer:
    """Cancellable timer handle (reference timer.rs Oneshot/Interval)."""

    __slots__ = ("deadline", "interval", "callback", "cancelled")

    def __init__(self, deadline: float, callback: Callable[[], None],
                 interval: float | None = None):
        self.deadline = deadline
        self.callback = callback
        self.interval = interval
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class Reactor:
    def __init__(self):
        self._sel = selectors.DefaultSelector()
        self._timers: list[tuple[float, int, Timer]] = []
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._pending: list[tuple[str, object, object]] = []
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)

    # -- IO ---------------------------------------------------------------
    # (un)registration is queued and applied on the polling thread:
    # selectors are not safe against concurrent register-vs-select
    # (the reference reactor has the same single-thread ownership).
    def register_read(self, sock, callback: Callable[[], None]) -> None:
        with self._lock:
            self._pending.append(("reg", sock, callback))
        self.wake()

    def unregister(self, sock) -> None:
        with self._lock:
            self._pending.append(("unreg", sock, None))
        self.wake()

    def _apply_pending(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for op, sock, cb in pending:
            try:
                if op == "reg":
                    self._sel.register(sock, selectors.EVENT_READ, cb)
                else:
                    self._sel.unregister(sock)
            except (KeyError, ValueError, OSError):
                pass

    # -- timers -------------------------------------------------------------
    def add_timer(self, delay: float, callback: Callable[[], None],
                  interval: float | None = None) -> Timer:
        t = Timer(time.monotonic() + delay, callback, interval)
        with self._lock:
            heapq.heappush(self._timers, (t.deadline, next(self._seq), t))
        self.wake()
        return t

    def next_deadline(self) -> float | None:
        with self._lock:
            while self._timers and self._timers[0][2].cancelled:
                heapq.heappop(self._timers)
            return self._timers[0][0] if self._timers else None

    # -- polling ------------------------------------------------------------
    def wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    def poll(self, max_wait: float) -> bool:
        """Wait up to max_wait for IO or timers; dispatch callbacks.
        Returns True if anything ran."""
        self._apply_pending()
        nd = self.next_deadline()
        timeout = max_wait
        if nd is not None:
            timeout = max(0.0, min(max_wait, nd - time.monotonic()))
        ran = False
        for key, _ in self._sel.select(timeout):
            if key.fileobj is self._wake_r:
                try:
                    while self._wake_r.recv(4096):
                        pass
                except BlockingIOError:
                    pass
                continue
            if key.data is not None:
                key.data()
                ran = True
        now = time.monotonic()
        due = []
        with self._lock:
            while self._timers and self._timers[0][0] <= now:
                _, _, t = heapq.heappop(self._timers)
                if not t.cancelled:
                    due.append(t)
        for t in due:
            t.callback()
            ran = True
            if t.interval is not None and not t.cancelled:
                t.deadline = now + t.interval
                with self._lock:
                    heapq.heappush(self._timers,
                                   (t.deadline, next(self._seq), t))
        return ran

    def close(self) -> None:
        try:
            self._sel.close()
        except Exception:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except Exception:
                pass
