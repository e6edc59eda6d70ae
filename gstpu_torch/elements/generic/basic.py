"""Basic plumbing: capsfilter, identity, fakesink, fakesrc, queue, tee.

These are the core-element equivalents every reference test pipeline
leans on (e.g. audio/audiofx/tests use audiotestsrc ! ... ! appsink;
queue/tee are the pipeline-parallelism primitives of SURVEY.md §2.8 P1).
"""

from __future__ import annotations

from collections import deque

from gstpu_torch.core.base import BaseSink, BaseTransform, PushSrc
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowReturn, Pad, PadDirection,
                                PadPresence, PadTemplate)
from gstpu_torch.core.event import EosEvent, Event
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.runtime.scheduler import Task, TaskResult


def _tmpl(name, direction, caps=None, presence=PadPresence.ALWAYS):
    return PadTemplate(name, direction, presence, caps or Caps.any())


@register_element("capsfilter", Rank.NONE)
class CapsFilter(BaseTransform):
    """Constrains negotiation to its `caps` property."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    caps = Property(Caps, default=None, blurb="Allowed caps",
                    mutable=Mutability.PLAYING)

    def transform_caps(self, direction, caps, filter):
        allowed = self.caps if self.caps is not None else Caps.any()
        out = caps.intersect(allowed)
        if filter is not None:
            out = out.intersect(filter)
        return out

    def transform(self, buf: Buffer):
        return buf


@register_element("identity", Rank.NONE)
class Identity(BaseTransform):
    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    silent = Property(bool, default=True, mutable=Mutability.PLAYING)
    drop_probability = Property(float, default=0.0, minimum=0.0, maximum=1.0,
                                mutable=Mutability.PLAYING,
                                blurb="Randomly drop buffers (fault injection)")
    SIGNALS = ("handoff",)

    def __init__(self, name=None):
        super().__init__(name)
        self._rng_state = 0x2545F4914F6CDD1D

    def transform(self, buf: Buffer):
        self.emit("handoff", buf)
        if self.drop_probability > 0.0:
            # xorshift for deterministic, clock-free fault injection
            x = self._rng_state
            x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
            x ^= x >> 7
            x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF
            self._rng_state = x
            if (x / 2**64) < self.drop_probability:
                return None
        return buf


@register_element("fakesink", Rank.NONE)
class FakeSink(BaseSink):
    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK)]

    SIGNALS = ("handoff",)
    signal_handoffs = Property(bool, default=False,
                               mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self.last_buffer: Buffer | None = None

    def render(self, buf: Buffer):
        self.last_buffer = buf
        if self.signal_handoffs:
            self.emit("handoff", buf)
        return FlowReturn.OK


@register_element("queue", Rank.NONE)
class Queue(Element):
    """Decoupling queue: buffers upstream pushes, drains them from its
    own scheduler task (the pipeline-parallelism boundary, reference
    generic/threadshare/src/queue/imp.rs)."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    max_size_buffers = Property(int, default=200, minimum=0,
                                mutable=Mutability.PLAYING,
                                blurb="0 = unbounded")
    leaky = Property(str, default="downstream",
                     enum_values=("no", "upstream", "downstream"),
                     mutable=Mutability.READY,
                     blurb="Full-queue policy; 'no' drains synchronously"
                           " (the cooperative scheduler cannot block)")

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.srcpad = self.static_pad("src")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._q: deque = deque()
        self._n_buffers = 0  # events in _q don't count against the cap
        self._eos_pending = False
        self.dropped = 0

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        limit = self.max_size_buffers
        if limit and self._n_buffers >= limit:
            if self.leaky == "upstream":
                self.dropped += 1
                return FlowReturn.OK       # drop the new buffer
            if self.leaky == "downstream":
                # drop the oldest BUFFER (never queued events)
                for item in list(self._q):
                    if isinstance(item, Buffer):
                        self._q.remove(item)
                        self._n_buffers -= 1
                        self.dropped += 1
                        break
            else:  # "no": drain in-line (single-threaded: can't block)
                while limit and self._n_buffers >= limit:
                    if self._iterate() is TaskResult.ERROR:
                        return FlowReturn.ERROR
        self._q.append(buf)
        self._n_buffers += 1
        return FlowReturn.OK

    def _event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, EosEvent):
            self._q.append(ev)
            return True
        if ev.serialized:
            self._q.append(ev)
            return True
        return self.srcpad.push_event(ev)

    def iterate_tasks(self):
        return (Task(self.name, self._iterate),)

    def _iterate(self) -> TaskResult:
        if not self._q:
            return TaskResult.IDLE
        item = self._q.popleft()
        if isinstance(item, Buffer):
            self._n_buffers -= 1
        if isinstance(item, EosEvent):
            self.srcpad.push_event(item)
            return TaskResult.EOS
        if isinstance(item, Event):
            self.srcpad.push_event(item)
            return TaskResult.CONTINUE
        ret = self.srcpad.push(item)
        if ret is FlowReturn.EOS:
            return TaskResult.EOS
        if not ret.is_ok:
            return TaskResult.ERROR
        return TaskResult.CONTINUE


@register_element("tee", Rank.NONE)
class Tee(Element):
    """1→N fan-out."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src_%u", PadDirection.SRC,
                           presence=PadPresence.REQUEST)]

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        ret = FlowReturn.NOT_LINKED
        for sp in self.src_pads():
            r = sp.push(buf)
            if r.is_ok:
                ret = r
            elif r is not FlowReturn.NOT_LINKED:
                return r
        return ret

    def _event(self, pad: Pad, ev: Event) -> bool:
        ok = False
        for sp in self.src_pads():
            ok = sp.push_event(ev) or ok
        return ok

    def link(self, downstream: Element) -> Element:
        pad = self.request_pad()
        for tp in downstream.sink_pads():
            if not tp.is_linked():
                pad.link(tp)
                return downstream
        raise RuntimeError(f"cannot link {self.name} -> {downstream.name}")
