"""The measured window of a closed loop, shared by every driver.

The driver pushes work while `running()`, and after each push hands the
push times and a device marker to `pushed()`, which keeps at most
`in_flight` markers outstanding: it waits for the oldest, so a slow
device slows the pushes. With `--trace 1` the profiler covers the first
`trace_seconds` of the window, from and to an idle device; host spans
and latencies are read outside that part. `Reservoir` keeps the seeded
sample of outputs that the check compares.
"""

from __future__ import annotations

import random
from collections import deque

import torch

from perfbench.timing import DeviceClock, Spans, Trace, now, phase


class Window:
    def __init__(self, cell, rec, spans: Spans, in_flight: int):
        self.cell, self.rec, self.spans = cell, rec, spans
        self.clock = DeviceClock(cell.device)
        self.in_flight = in_flight
        self.queue: deque = deque()
        # the profiler traces the card only: a CPU run keeps its spans
        self.tracer = Trace(cell.device, spans) \
            if cell.trace and self.clock.cuda else None
        self.trace_end = None

    def open(self) -> None:
        """Close set-up: anchor the clock, start the profiler where the
        run traces, and open the window."""
        phase("warm-up")
        if self.tracer is not None:
            self.tracer.warm()
            phase("profiler")
        self.clock.start()
        rec = self.rec
        rec.setup_s = now() - self.cell.born
        if self.tracer is not None:
            self.tracer.start()
            self.trace_end = self.tracer.t0 + self.cell.traffic[
                "trace_seconds"]
        t0 = now()
        rec.window = (t0, t0 + self.cell.seconds)

    def running(self) -> bool:
        t = now()
        if self.trace_end is not None and t >= self.trace_end:
            self._stop_trace()
        return t < self.rec.window[1]

    def _stop_trace(self) -> None:
        self.trace_end = None
        self.tracer.stop()
        rec = self.rec
        rec.traced = (self.tracer.t0, self.tracer.t1)
        rec.trace_buffers = sum(1 for p in rec.push + [
            p for ps, _ in self.queue for p in ps]
            if rec.traced[0] <= p < rec.traced[1])

    def pushed(self, pushes: list, mark) -> None:
        """Buffers pushed at `pushes` whose outputs are complete when
        `mark` is; wait for the oldest while `in_flight` are
        outstanding."""
        self.queue.append((pushes, mark))
        while len(self.queue) >= self.in_flight:
            self._retire()

    def _retire(self) -> None:
        pushes, mark = self.queue.popleft()
        done = self.clock.wait(mark)
        self.rec.push.extend(pushes)
        self.rec.done.extend([done] * len(pushes))

    def close(self) -> None:
        """Wait for what is in flight; read the memory peak."""
        while self.queue:
            self._retire()
        if self.trace_end is not None:
            self._stop_trace()
        self.clock.sync()
        if self.tracer is not None:
            self.rec.trace = self.tracer.summarise()
        self.rec.spans = {k: (v, self.spans.calls[k])
                          for k, v in self.spans.seconds.items()}
        if self.clock.cuda:
            self.rec.memory_peak_bytes = torch.cuda.max_memory_allocated(
                self.clock.device)


class Reservoir:
    """A uniform sample of at most `size` of the offers, drawn from the
    seed: `items` holds (key, value) pairs. An offer passes a function
    that makes its value, called only for an offer that is kept."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items: list = []
        self.seen = 0
        self.rng = random.Random(seed)

    def offer(self, key, make) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append((key, make()))
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.items[j] = (key, make())
