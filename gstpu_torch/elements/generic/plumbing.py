"""streamgrouper, originalbuffersave/restore, gopbuffer, inter
sink/src — the reference generic/ plumbing elements.

The port's copy of gstpu/elements/generic/plumbing.py: no element here
reads the payload; `originalbuffersave`'s deep copy of a tensor is a
`clone()` on its device. One departure: `intersrc` reads its EOS flag
before its queue, where gstpu's reads the queue first and can end the
stream before the last buffer when the producer runs on another thread.
"""

from __future__ import annotations

import threading
from collections import deque

from gstpu_torch.core.base import BaseSink, BaseTransform, PushSrc
from gstpu_torch.core.buffer import Buffer, BufferFlags, OriginalBufferMeta
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowError, FlowReturn, Pad,
                                      PadDirection, PadPresence, PadTemplate)
from gstpu_torch.core.event import (CapsEvent, CustomEvent, EosEvent, Event,
                                    GapEvent, StreamStartEvent, TagEvent)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.runtime.scheduler import Task, TaskResult

SECOND = 1_000_000_000


def _tmpl(name, direction, caps=None):
    return PadTemplate(name, direction, PadPresence.ALWAYS,
                       caps or Caps.any())


@register_element("streamgrouper", Rank.NONE)
class StreamGrouper(BaseTransform):
    """Rewrites stream-start events so all streams passing through
    share one group id (generic/streamgrouper/src/streamgrouper/
    imp.rs:22-24)."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    _shared_group_id = 1

    def transform(self, buf: Buffer) -> Buffer:
        return buf

    def sink_event(self, ev: Event) -> bool:
        if isinstance(ev, StreamStartEvent):
            new = StreamStartEvent(ev.stream_id,
                                   group_id=StreamGrouper._shared_group_id)
            return self.srcpad.push_event(new)
        return False


@register_element("originalbuffersave", Rank.NONE)
class OriginalBufferSave(BaseTransform):
    """Stashes the incoming buffer + caps as a meta so a downstream
    originalbufferrestore can undo lossy transforms
    (generic/originalbuffer/src/originalbuffersave/imp.rs)."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    def transform(self, buf: Buffer) -> Buffer:
        out = buf.copy()
        if out.get_meta(OriginalBufferMeta) is None:
            out.add_meta(OriginalBufferMeta(buf.copy(deep=True),
                                            self.in_caps))
        return out


@register_element("originalbufferrestore", Rank.NONE)
class OriginalBufferRestore(BaseTransform):
    """Restores the buffer saved by originalbuffersave."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    def transform(self, buf: Buffer) -> Buffer:
        meta = buf.get_meta(OriginalBufferMeta)
        if meta is None or meta.original is None:
            return buf
        orig = meta.original.copy()
        orig.pts = buf.pts
        if meta.caps is not None and meta.caps != self.out_caps:
            self.srcpad.push_event(CapsEvent(meta.caps))
            self.out_caps = meta.caps
        return orig


@register_element("gopbuffer", Rank.NONE)
class GopBuffer(Element):
    """Buffers at least `minimum-duration` of closed GOPs, forwarding
    only complete GOPs delayed by that window — keyframe-aligned late
    recording (generic/gopbuffer/src/gopbuffer/imp.rs)."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    minimum_duration = Property(int, default=1 * SECOND, minimum=0,
                                mutable=Mutability.READY,
                                blurb="Minimum GOP window to retain (ns)")
    max_size_time = Property(int, default=0, minimum=0,
                             mutable=Mutability.READY,
                             blurb="Maximum duration to store; older "
                                   "GOPs are discarded once exceeded "
                                   "(0 = disabled, reference "
                                   "max-size-time)")

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.srcpad = self.static_pad("src")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._gops: deque[list[Buffer]] = deque()
        self._current: list[Buffer] = []

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if buf.is_keyframe() and self._current:
            self._gops.append(self._current)
            self._current = []
        self._current.append(buf)
        # max-size-time: a bounded recorder discards its oldest
        # complete GOPs instead of growing without limit
        while self.max_size_time and len(self._gops) > 1 \
                and self._window_duration() > self.max_size_time:
            self._gops.popleft()
        return self._maybe_push()

    def _window_duration(self) -> int:
        first = last = None
        for gop in self._gops:
            for b in gop:
                if b.pts is None:
                    continue
                first = b.pts if first is None else min(first, b.pts)
                last = b.pts if last is None else max(last, b.pts)
        if first is None or last is None:
            return 0
        return last - first

    def _maybe_push(self) -> FlowReturn:
        # push oldest complete GOPs while the retained window exceeds
        # minimum-duration
        while len(self._gops) > 1 and \
                self._window_duration() > self.minimum_duration:
            for b in self._gops.popleft():
                ret = self.srcpad.push(b)
                if not ret.is_ok:
                    return ret
        return FlowReturn.OK

    def _event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, EosEvent):
            if self._current:
                self._gops.append(self._current)
                self._current = []
            for gop in self._gops:
                for b in gop:
                    self.srcpad.push(b)
            self._gops.clear()
        return self.srcpad.push_event(ev)


# ---------------------------------------------------------------------------
# inter: cross-pipeline (same process) bridge
# ---------------------------------------------------------------------------

class _ProducerRegistry:
    """producer-name -> StreamProducer (gst_utils::StreamProducer
    analogue: appsink->appsrc forwarding, generic/inter/src/)."""

    _lock = threading.Lock()
    _producers: dict[str, "_Producer"] = {}

    @classmethod
    def get(cls, name: str) -> "_Producer":
        with cls._lock:
            p = cls._producers.get(name)
            if p is None:
                p = cls._producers[name] = _Producer(name)
            return p


class _Producer:
    def __init__(self, name: str):
        self.name = name
        self.caps: Caps | None = None
        self.consumers: list["InterSrc"] = []
        self.sinks: list["InterSink"] = []
        self.lock = threading.Lock()

    def push(self, buf: Buffer, caps: Caps | None) -> None:
        with self.lock:
            self.caps = caps or self.caps
            for c in list(self.consumers):
                c._enqueue(buf, self.caps)

    def eos(self) -> None:
        with self.lock:
            for c in list(self.consumers):
                c._enqueue_eos()

    def forward_event(self, ev) -> None:
        with self.lock:
            for c in list(self.consumers):
                c._enqueue_event(ev)

    def upstream_event(self, ev) -> bool:
        """Consumer -> producer direction (intersrc event-types)."""
        ok = False
        with self.lock:
            sinks = list(getattr(self, "sinks", []))
        for s in sinks:
            pad = getattr(s, "sinkpad", None)
            if pad is not None:
                ok = pad.push_event(ev) or ok
        return ok


@register_element("intersink", Rank.NONE)
class InterSink(BaseSink):
    """Feeds buffers to same-process intersrc elements by producer
    name (generic/inter/src/sink)."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK)]

    producer_name = Property(str, default="default",
                             mutable=Mutability.READY)
    event_types = Property(
        str, default="eos", mutable=Mutability.PLAYING,
        blurb="Comma-separated downstream event types forwarded to "
              "the consumers (reference event-types array; names: "
              "eos, tag, custom-downstream, gap)")

    _EVENT_NAMES = {"eos": EosEvent, "tag": TagEvent,
                    "custom-downstream": CustomEvent, "gap": GapEvent}

    def start(self) -> bool:
        pr = _ProducerRegistry.get(self.producer_name)
        with pr.lock:
            pr.sinks.append(self)
        return True

    def stop(self) -> bool:
        pr = _ProducerRegistry.get(self.producer_name)
        with pr.lock:
            if self in pr.sinks:
                pr.sinks.remove(self)
        return True

    def render(self, buf: Buffer):
        _ProducerRegistry.get(self.producer_name).push(buf, self.caps)
        return FlowReturn.OK

    def _event(self, pad, ev: Event) -> bool:
        wanted = {n.strip() for n in self.event_types.split(",") if n}
        for name, cls in self._EVENT_NAMES.items():
            if name != "eos" and name in wanted \
                    and isinstance(ev, cls):
                _ProducerRegistry.get(
                    self.producer_name).forward_event(ev)
                break
        return super()._event(pad, ev)

    def on_eos(self) -> None:
        wanted = {n.strip() for n in self.event_types.split(",") if n}
        if "eos" in wanted:
            _ProducerRegistry.get(self.producer_name).eos()


@register_element("intersrc", Rank.NONE)
class InterSrc(PushSrc):
    """Receives buffers from a named intersink producer."""

    PAD_TEMPLATES = [_tmpl("src", PadDirection.SRC)]

    producer_name = Property(str, default="default",
                             mutable=Mutability.READY)
    max_buffers = Property(
        int, default=0, minimum=0, mutable=Mutability.PLAYING,
        blurb="Queue bound in buffers; oldest dropped when exceeded "
              "(0 = unlimited, reference max-buffers)")
    max_bytes = Property(
        int, default=0, minimum=0, mutable=Mutability.PLAYING,
        blurb="Queue bound in bytes (0 = unlimited)")
    max_time = Property(
        int, default=0, minimum=0, mutable=Mutability.PLAYING,
        blurb="Queue bound in ns of buffer pts span (0 = unlimited)")
    event_types = Property(
        str, default="", mutable=Mutability.PLAYING,
        blurb="Comma-separated UPSTREAM event types forwarded to the "
              "producer's intersink pipeline (reference event-types; "
              "names: custom-upstream, qos, navigation)")

    def __init__(self, name=None):
        super().__init__(name)
        self._q: deque = deque()
        self._caps: Caps | None = None
        self._eos = False
        self._pending_events: deque = deque()
        self.srcpad.event_function = self._upstream_event

    def _upstream_event(self, pad, ev) -> bool:
        from gstpu_torch.core.event import (CustomEvent, NavigationEvent,
                                            QosEvent)
        names = {"custom-upstream": CustomEvent, "qos": QosEvent,
                 "navigation": NavigationEvent}
        wanted = {n.strip() for n in self.event_types.split(",") if n}
        for name, cls in names.items():
            if name in wanted and isinstance(ev, cls):
                return _ProducerRegistry.get(
                    self.producer_name).upstream_event(ev)
        return False

    def start(self) -> bool:
        p = _ProducerRegistry.get(self.producer_name)
        with p.lock:
            p.consumers.append(self)
        return True

    def stop(self) -> bool:
        p = _ProducerRegistry.get(self.producer_name)
        with p.lock:
            if self in p.consumers:
                p.consumers.remove(self)
        return True

    def _enqueue(self, buf: Buffer, caps: Caps | None) -> None:
        self._q.append((buf, caps))
        self._enforce_bounds()

    def _enforce_bounds(self) -> None:
        """Leaky live bridge: drop OLDEST queued buffers beyond the
        configured bounds (reference StreamProducer consumer queue)."""
        if self.max_buffers:
            while len(self._q) > self.max_buffers:
                self._q.popleft()
        if self.max_bytes:
            while len(self._q) > 1 and sum(
                    b.size for b, _ in self._q) > self.max_bytes:
                self._q.popleft()
        if self.max_time:
            while len(self._q) > 1:
                first, last = self._q[0][0].pts, self._q[-1][0].pts
                if first is None or last is None \
                        or last - first <= self.max_time:
                    break
                self._q.popleft()

    def _enqueue_event(self, ev) -> None:
        self._pending_events.append(ev)

    def _enqueue_eos(self) -> None:
        self._eos = True

    def negotiate(self) -> Caps:
        return self._caps or Caps.new("application/x-inter-pending")

    def create(self) -> Buffer | None:
        # read the EOS flag before the queue: the producer's thread may
        # queue its last buffer and flag EOS between the two reads
        eos = self._eos
        if not self._q:
            if eos:
                return None
            raise FlowError(FlowReturn.FLUSHING, "intersrc starved")
        while self._pending_events:
            self.srcpad.push_event(self._pending_events.popleft())
        buf, caps = self._q.popleft()
        if caps is not None and caps != self._caps:
            self._caps = caps
            self.srcpad.push_event(CapsEvent(caps))
        return buf
