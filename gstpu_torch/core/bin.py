"""Bin and Pipeline: element containers and the top-level driver.

Rebuilds GstBin/GstPipeline semantics (SURVEY.md §1 L1): a Bin
aggregates children and forwards state changes sink-first on upward
transitions; a Pipeline owns the Bus, selects a clock, distributes
base-time, and drives dataflow through the cooperative scheduler
(gstpu_torch.runtime.scheduler) instead of per-element OS threads — the
threadshare model (§2.8 P2) promoted to the default.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional

from gstpu_torch.core.clock import Clock, SystemClock
from gstpu_torch.core.element import (Bus, Element, Message, MessageType, State,
                                StateChangeReturn)
from gstpu_torch.core.query import LatencyQuery
from gstpu_torch.runtime.scheduler import Context, Task, TaskState
from gstpu_torch.utils.log import debug_category

CAT = debug_category("pipeline")


class Bin(Element):
    def __init__(self, name: str | None = None):
        super().__init__(name)
        self.children: list[Element] = []

    def add(self, *elements: Element) -> None:
        for el in elements:
            el.parent = self
            self.children.append(el)

    def remove(self, el: Element) -> None:
        if el in self.children:
            el.parent = None
            self.children.remove(el)

    def get_by_name(self, name: str) -> Element | None:
        for el in self.children:
            if el.name == name:
                return el
            if isinstance(el, Bin):
                found = el.get_by_name(name)
                if found is not None:
                    return found
        return None

    def iterate_elements(self) -> Iterable[Element]:
        for el in self.children:
            yield el
            if isinstance(el, Bin):
                yield from el.iterate_elements()

    def _children_sorted_for(self, upward: bool) -> list[Element]:
        """Sinks first for upward transitions (GStreamer rule), sources
        first for downward."""
        def is_sink(el: Element) -> bool:
            return not el.src_pads() and bool(el.sink_pads())
        ordered = sorted(self.children, key=lambda e: (not is_sink(e)))
        return ordered if upward else list(reversed(ordered))

    def change_state(self, old: State, new: State) -> StateChangeReturn:
        upward = new > old
        ret = StateChangeReturn.SUCCESS
        for el in self._children_sorted_for(upward):
            el.clock = el.clock or self.clock
            el.base_time = self.base_time
            r = el.set_state(new)
            if r is StateChangeReturn.FAILURE:
                return r
            if r is StateChangeReturn.NO_PREROLL:
                ret = r
        r = super().change_state(old, new)
        if r is StateChangeReturn.FAILURE:
            return r
        return ret


class Pipeline(Bin):
    """Top-level bin with bus, clock and scheduler."""

    def __init__(self, name: str | None = None):
        super().__init__(name)
        self.bus = Bus()
        self.clock = SystemClock.obtain()
        self._forced_clock: Clock | None = None
        self._ctx: Context | None = None
        self._run_thread: threading.Thread | None = None
        self._eos_seen = False
        self._error_seen: Message | None = None
        self.bus.add_sync_handler(self._on_msg)

    def use_clock(self, clock: Clock | None) -> None:
        """Force a clock onto the pipeline (GStreamer
        gst_pipeline_use_clock): with one set, sinks sync even in
        non-live pipelines."""
        self._forced_clock = clock

    def _is_live(self) -> bool:
        """Live if any element declares itself live or clock-driven
        (sources with is_live/is-live-p; livesync/clocksync-style
        elements set requires_clock)."""
        for el in self.iterate_elements():
            if getattr(el, "is_live", False) \
                    or getattr(el, "is_live_p", False) \
                    or getattr(el, "requires_clock", False):
                return True
        return False

    def _on_msg(self, msg: Message) -> None:
        if msg.type is MessageType.EOS:
            self._eos_seen = True
        elif msg.type is MessageType.ERROR:
            self._error_seen = msg

    # -- state --------------------------------------------------------
    def set_state(self, target: State) -> StateChangeReturn:
        if target > State.READY and self.state <= State.READY:
            # clock selection: live pipelines (or a forced clock) get
            # the system clock; offline pipelines run unclocked so
            # sync=true sinks don't throttle batch processing
            if self._forced_clock is not None:
                self.clock = self._forced_clock
            elif self._is_live():
                self.clock = SystemClock.obtain()
            else:
                self.clock = None
            self.base_time = self.clock.time() if self.clock else 0
        r = super().set_state(target)
        if target is State.PLAYING and r is not StateChangeReturn.FAILURE:
            self._collect_tasks()
        if target <= State.READY:
            self._ctx = None
            for ctx, t in getattr(self, "_shared_tasks", []):
                t.stop()
                ctx.remove_task(t)
            self._shared_tasks = []
        return r

    def _collect_tasks(self) -> None:
        ctx = Context(f"pipeline-{self.name}")
        self._shared_tasks = []
        for el in self.iterate_elements():
            for t in el.iterate_tasks():
                t.prepare()
                t.start()
                cname = getattr(t, "context_name", None)
                if cname:
                    # threadshare model: the element's task runs on a
                    # SHARED named context thread (one thread per
                    # context, epoll-driven), not the pipeline loop
                    shared = Context.acquire(
                        cname, getattr(t, "context_wait", 0.0),
                        threaded=True)
                    shared.add_task(t)
                    sock = getattr(t, "watch_sock", None)
                    if sock is not None:
                        shared.watch_fd(t, sock)
                    self._shared_tasks.append((shared, t))
                else:
                    ctx.add_task(t)
        self._ctx = ctx

    # -- dataflow driving --------------------------------------------
    def iterate(self) -> bool:
        """Run one scheduler round; returns True if work was done."""
        if self._ctx is None:
            return False
        return self._ctx.iterate()

    def run(self, timeout: float | None = 60.0) -> None:
        """Drive dataflow until EOS or error (non-live pipelines)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._eos_seen and self._error_seen is None:
            worked = self.iterate()
            if not worked:
                if self._ctx is None or not self._ctx.tasks:
                    break
                active = [t for t in self._ctx.tasks
                          if t.state is TaskState.STARTED]
                if not active:
                    break
                time.sleep(0.001)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"pipeline {self.name} run timed out")
        if self._error_seen is not None:
            raise RuntimeError(f"pipeline error: {self._error_seen}")

    def run_async(self) -> threading.Thread:
        t = threading.Thread(target=self.run, kwargs={"timeout": None},
                             daemon=True)
        t.start()
        self._run_thread = t
        return t

    # -- queries ------------------------------------------------------
    def query_latency(self) -> LatencyQuery:
        q = LatencyQuery()
        for el in self.iterate_elements():
            if el.sink_pads() and not el.src_pads():  # a sink
                for p in el.sink_pads():
                    if p.peer is not None:
                        p.query(q)
        return q
