"""Sans-IO jitterbuffer: reorder + dejitter state machine.

Retains the reference design (net/rtp/src/rtpbin2/jitterbuffer.rs:
27-259): a pure queue_packet/poll API with injected times — reordering
by extended seqnum, latency-deadline scheduling, duplicate/late
classification — testable without sockets or clocks.

The port's copy of gstpu/net/rtp/jitterbuffer.py, as it stands.
"""

from __future__ import annotations

import enum
import heapq
from dataclasses import dataclass

SECOND = 1_000_000_000


class QueueResult(enum.Enum):
    QUEUED = "queued"
    LATE = "late"
    DUPLICATE = "duplicate"


class PollOutcome(enum.Enum):
    FORWARD = "forward"
    TIMEOUT = "timeout"   # nothing due yet; wait until .time
    EMPTY = "empty"


@dataclass
class PollResult:
    outcome: PollOutcome
    id: int | None = None          # for FORWARD
    time: int | None = None        # for TIMEOUT
    lost_seqnums: tuple[int, ...] = ()


class JitterBuffer:
    """Schedules packets for output at arrival_pts + latency, in
    extended-seqnum order."""

    def __init__(self, latency: int = 200 * 1_000_000):
        self.latency = latency
        self._heap: list[tuple[int, int]] = []  # (ext_seq, id)
        self._items: dict[int, tuple[int, int]] = {}  # id -> (ext_seq, deadline)
        self._next_id = 0
        self._next_ext_seq: int | None = None
        self._max_queued_ext_seq: int | None = None
        self._flushing = False

    # -- seqnum extension ----------------------------------------------
    def _extend(self, seq: int) -> int:
        ref = self._max_queued_ext_seq
        if ref is None:
            return 0x10000 | seq  # bias away from 0 for late math
        delta = (seq - (ref & 0xFFFF) + 0x8000) % 0x10000 - 0x8000
        return ref + delta

    # -- API -----------------------------------------------------------
    def queue_packet(self, seqnum: int, now: int) \
            -> tuple[QueueResult, int | None]:
        if self._flushing:
            return QueueResult.LATE, None
        ext = self._extend(seqnum)
        if self._next_ext_seq is not None and ext < self._next_ext_seq:
            return QueueResult.LATE, None
        if any(e == ext for e, _ in self._heap):
            return QueueResult.DUPLICATE, None
        pid = self._next_id
        self._next_id += 1
        deadline = now + self.latency
        heapq.heappush(self._heap, (ext, pid))
        self._items[pid] = (ext, deadline)
        if self._max_queued_ext_seq is None \
                or ext > self._max_queued_ext_seq:
            self._max_queued_ext_seq = ext
        return QueueResult.QUEUED, pid

    def poll(self, now: int) -> PollResult:
        if not self._heap:
            return PollResult(PollOutcome.EMPTY)
        ext, pid = self._heap[0]
        _, deadline = self._items[pid]
        if deadline <= now:
            heapq.heappop(self._heap)
            del self._items[pid]
            lost = ()
            if self._next_ext_seq is not None and ext > self._next_ext_seq:
                base = self._next_ext_seq & 0xFFFF
                lost = tuple((base + i) & 0xFFFF
                             for i in range(ext - self._next_ext_seq))
            self._next_ext_seq = ext + 1
            return PollResult(PollOutcome.FORWARD, id=pid,
                              lost_seqnums=lost)
        if self._next_ext_seq is not None and ext == self._next_ext_seq:
            # contiguous head: no need to wait for the dejitter deadline
            heapq.heappop(self._heap)
            del self._items[pid]
            self._next_ext_seq = ext + 1
            return PollResult(PollOutcome.FORWARD, id=pid)
        return PollResult(PollOutcome.TIMEOUT, time=deadline)

    def flush(self) -> list[int]:
        """Release everything (EOS): ids in order."""
        out = []
        while self._heap:
            _, pid = heapq.heappop(self._heap)
            del self._items[pid]
            out.append(pid)
        return out

    def clear(self) -> None:
        self._heap.clear()
        self._items.clear()
        self._next_ext_seq = None
        self._max_queued_ext_seq = None

    def num_queued(self) -> int:
        return len(self._heap)
