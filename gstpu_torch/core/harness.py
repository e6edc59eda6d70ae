"""Harness: single-element test rig with manual push/pull.

Rebuilds gst_check::Harness as used by reference element tests
(audio/hrtf/tests/hrtfrender.rs:29-60; the RTP payloader loopback
tests): wraps one element with probe src/sink pads, lets tests set
caps, push buffers/events, and pull the element's output.
"""

from __future__ import annotations

from collections import deque

from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps, parse_caps
from gstpu_torch.core.element import (Element, FlowReturn, Pad, PadDirection,
                                PadTemplate, PadPresence)
from gstpu_torch.core.event import (CapsEvent, EosEvent, Event, Segment,
                              SegmentEvent, StreamStartEvent)
from gstpu_torch.core.query import LatencyQuery
from gstpu_torch.core.registry import make


class Harness:
    def __init__(self, element: Element | str, sink_pad: str = "sink",
                 src_pad: str = "src"):
        if isinstance(element, str):
            element = make(element)
        self.element = element
        from gstpu_torch.core.element import Bus
        self.bus = Bus()
        self.element.bus = self.bus

        self.buffers: deque[Buffer] = deque()
        self.events: deque[Event] = deque()
        self.eos = False

        # feed pad (our src → element sink)
        el_sink = element.static_pad(sink_pad)
        self.srcpad: Pad | None = None
        if el_sink is not None:
            self.srcpad = Pad("harness-src", PadDirection.SRC,
                              PadTemplate("src", PadDirection.SRC,
                                          PadPresence.ALWAYS, Caps.any()))
            self.srcpad.query_function = self._upstream_query
            self.srcpad.link(el_sink)

        # capture pad (element src → our sink)
        el_src = element.static_pad(src_pad)
        self.sinkpad: Pad | None = None
        if el_src is not None:
            self.sinkpad = Pad("harness-sink", PadDirection.SINK,
                               PadTemplate("sink", PadDirection.SINK,
                                           PadPresence.ALWAYS, Caps.any()))
            self.sinkpad.chain_function = self._capture
            self.sinkpad.event_function = self._capture_event
            el_src.link(self.sinkpad)

        self._stream_started = False
        # elements expect to be started
        from gstpu_torch.core.element import State
        self.element.set_state(State.PLAYING)

    def _upstream_query(self, pad: Pad, q) -> bool:
        """Answer queries the element sends upstream (gst_check's
        harness acts as a well-behaved non-live source)."""
        if isinstance(q, LatencyQuery):
            q.live = False
            return True
        from gstpu_torch.core.query import CapsQuery
        if isinstance(q, CapsQuery):
            q.caps = q.filter if q.filter is not None else Caps.any()
            return True
        return False

    def _capture(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self.buffers.append(buf)
        return FlowReturn.OK

    def _capture_event(self, pad: Pad, ev: Event) -> bool:
        self.events.append(ev)
        if isinstance(ev, EosEvent):
            self.eos = True
        return True

    # -- driving --------------------------------------------------------
    def set_caps(self, caps: Caps | str) -> None:
        if isinstance(caps, str):
            caps = parse_caps(caps)
        if not self._stream_started:
            self.srcpad.push_event(StreamStartEvent("harness/stream-0"))
            self._stream_started = True
        self.srcpad.push_event(CapsEvent(caps))
        self.srcpad.push_event(SegmentEvent(Segment()))

    def push(self, buf: Buffer) -> FlowReturn:
        return self.srcpad.push(buf)

    def push_event(self, ev: Event) -> bool:
        return self.srcpad.push_event(ev)

    def push_eos(self) -> bool:
        return self.srcpad.push_event(EosEvent())

    # -- pulling ----------------------------------------------------------
    def pull(self) -> Buffer:
        if not self.buffers:
            raise AssertionError("harness: no buffer to pull")
        return self.buffers.popleft()

    def try_pull(self) -> Buffer | None:
        return self.buffers.popleft() if self.buffers else None

    def pull_all(self) -> list[Buffer]:
        out = list(self.buffers)
        self.buffers.clear()
        return out

    def pull_event(self) -> Event | None:
        return self.events.popleft() if self.events else None

    def output_caps(self) -> Caps | None:
        src = self.sinkpad
        return src.current_caps if src else None

    def query_latency(self) -> LatencyQuery:
        q = LatencyQuery()
        el_src = self.sinkpad.peer if self.sinkpad else None
        if el_src is not None and el_src.query_function is not None:
            el_src.query_function(el_src, q)
        elif el_src is not None and el_src.element is not None:
            el_src.element.default_pad_query(el_src, q)
        return q

    def teardown(self) -> None:
        from gstpu_torch.core.element import State
        self.element.set_state(State.NULL)
