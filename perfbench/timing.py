"""Clocks, spans and the profiler's reading, shared by every driver.

* `DeviceClock` maps a CUDA event onto the host's `perf_counter`: one
  anchor event is recorded on an idle stream, and an event's host time is
  the anchor's plus the device's elapsed time between them. A buffer is
  complete when an event recorded after its output is done on the device,
  whenever the host happens to look.
* `Spans` adds up host seconds by name around the calls into the program,
  outermost calls only for names marked `outer`, and counts them. Only a
  traced run reads them; an untraced run's spans do nothing, so the
  end-to-end metrics carry no instrumentation.
* `phase` marks the end of each stage of set-up, which `run.py` prints.
* `Trace` runs `torch.profiler` (device activity only, so the host runs
  near its untraced speed) over a part of the window and reduces it to
  device busy time, kernels and copies by name, and idle gaps by the host
  span they fall in; the spans of that part are kept as intervals and
  put on the profiler's clock (the wall clock) by one offset.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

now = time.perf_counter

PHASES: list = []


def phase(name: str) -> None:
    """Mark the end of a stage of set-up (host time)."""
    PHASES.append((name, now()))


class DeviceClock:
    """Host times of CUDA events, from one anchor (CUDA only)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._pool: list = []
        self.anchor = None
        self.t_anchor = 0.0

    def start(self) -> None:
        """Anchor on an idle device: everything enqueued has finished."""
        if not self.cuda:
            return
        torch.cuda.synchronize(self.device)
        self.anchor = torch.cuda.Event(enable_timing=True)
        self.anchor.record()
        self.anchor.synchronize()
        self.t_anchor = now()

    def mark(self):
        """A marker after all work enqueued so far: a timing event on the
        current stream, or on a CPU run the host time itself (the work
        is done when the call returns)."""
        if not self.cuda:
            return now()
        ev = self._pool.pop() if self._pool else \
            torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> float:
        """Wait until `mark` is done; its host time. The event goes back
        to the pool."""
        if not self.cuda:
            return mark
        mark.synchronize()
        t = self.t_anchor + self.anchor.elapsed_time(mark) * 1e-3
        self._pool.append(mark)
        return t

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)


_NOTHING = nullcontext()


class Spans:
    """Host seconds and calls by span name. Names in `outer` count only
    their outermost call, so a method that calls itself, or a set of
    methods that call one another under one name, count once."""

    def __init__(self, outer=(), enabled: bool = True):
        self.enabled = enabled
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.outer = set(outer)
        self._depth: dict[str, int] = defaultdict(int)
        self.on = True           # off while the profiler traces
        self.intervals: list = []  # (start, end, name) while it does

    def span(self, name: str):
        if not self.enabled:
            return _NOTHING
        return self._span(name)

    @contextmanager
    def _span(self, name: str):
        if not self.on:
            t0 = now()
            try:
                yield
            finally:
                self.intervals.append((t0, now(), name))
            return
        nested = name in self.outer and self._depth[name] > 0
        self._depth[name] += 1
        t0 = now()
        try:
            yield
        finally:
            self._depth[name] -= 1
            if not nested:
                self.seconds[name] += now() - t0
                self.calls[name] += 1

    def wrap(self, obj, method: str, name: str) -> None:
        """Time `obj.method` under `name` on this instance only."""
        if not self.enabled:
            return
        fn = getattr(obj, method)

        def timed(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        setattr(obj, method, timed)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class Trace:
    """torch.profiler over a sub-window that starts and ends on an idle
    device, so every operation of the buffers pushed inside it is in it."""

    def __init__(self, device, spans: Spans):
        self.device = torch.device(device)
        self.spans = spans
        self.prof = None
        self.t0 = self.t1 = 0.0

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        takes seconds."""
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.spans.on = False
        self.t0 = now()
        self.wall = time.time() - now()   # perf_counter -> wall clock

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.t1 = now()
        self.prof.__exit__(None, None, None)
        self.spans.on = True

    def summarise(self) -> dict:
        """Reduce the trace (after the window: it takes seconds)."""
        host = [((a + self.wall) * 1e6, (b + self.wall) * 1e6, n)
                for a, b, n in self.spans.intervals]
        out = summarise(self.prof, host, self.t1 - self.t0)
        self.prof = None
        return out


def _device_ops(prof) -> list:
    """(name, start_us, end_us) of every operation the profiler saw run
    on the card, on the wall clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA \
                or e.is_user_annotation():
            continue
        start = e.start_ns() / 1e3 if hasattr(e, "start_ns") \
            else float(e.start_us())
        dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") \
            else float(e.duration_us())
        if dur > 0:
            out.append((e.name(), start, start + dur))
    return out


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def short(name: str, n: int = 96) -> str:
    """A kernel's name without `void` and PyTorch's namespaces, cut to
    n characters."""
    name = name.removeprefix("void ")
    for ns in ("at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(ns, "")
    return name[:n]


def summarise(prof, host: list, window_s: float) -> dict:
    """Device busy seconds (the union of every kernel, copy and set on
    the card), kernel launches, device seconds by operation, and the
    idle gaps between device operations summed by the innermost host
    span (start_us, end_us, name) they fall in ("harness" outside every
    span)."""
    dev = _device_ops(prof)
    ops: dict[str, float] = defaultdict(float)
    launches = 0
    for n, a, b in dev:
        ops[n] += (b - a) * 1e-6
        if not _is_copy(n):
            launches += 1
    busy = _union([(a, b) for _, a, b in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    host = sorted(host)
    gaps: dict[str, float] = defaultdict(float)
    starts = np.array([h[0] for h in host]) if host else np.zeros(0)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        owner = "harness"
        # the innermost span holding the gap's middle: the latest
        # starting one that has not ended
        i = int(np.searchsorted(starts, mid)) - 1
        while i >= 0:
            a, b, n = host[i]
            if b >= mid:
                owner = n
                break
            i -= 1
            if mid - a > 5.0e6:
                break
        gaps[owner] += (s1 - e0) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top = [(short(n), v) for n, v in top]
    return dict(busy_s=busy_s, window_s=window_s, launches=launches,
                device_s=sum(ops.values()),
                breakdown=dict(
                    device_ops=[[n, s] for n, s in top],
                    idle_gaps=[[n, s] for n, s in sorted(
                        gaps.items(), key=lambda kv: -kv[1])[:10]]))
