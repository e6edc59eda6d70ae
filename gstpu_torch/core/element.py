"""Element / Pad / Bus: the dataflow object model.

Rebuilds the GStreamer element contract every reference plugin is
written against (SURVEY.md §1 L1/L2): elements own typed pads; pads
link, negotiate caps, and carry buffers (chain), events and queries;
elements walk the NULL→READY→PAUSED→PLAYING state machine and post
messages on the pipeline bus. Dispatch that in the reference crosses
C core vtables (tutorial/src/rgb2gray/imp.rs chain→transform) is plain
method dispatch here.
"""

from __future__ import annotations

import enum
import itertools
import queue as _queue
import threading
import traceback
from typing import Any, Callable, Iterable, Optional

from gstpu_torch.core.buffer import Buffer, BufferList
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.clock import Clock
from gstpu_torch.core.event import (CapsEvent, EosEvent, Event, FlushStartEvent,
                              FlushStopEvent, SegmentEvent, StreamStartEvent)
from gstpu_torch.core.props import HasProperties, Mutability, Property
from gstpu_torch.core.query import AcceptCapsQuery, CapsQuery, Query
from gstpu_torch.utils.log import debug_category

CAT = debug_category("element")


class State(enum.IntEnum):
    NULL = 0
    READY = 1
    PAUSED = 2
    PLAYING = 3


class StateChangeReturn(enum.Enum):
    SUCCESS = "success"
    ASYNC = "async"
    NO_PREROLL = "no-preroll"
    FAILURE = "failure"


class FlowReturn(enum.Enum):
    OK = "ok"
    NOT_LINKED = "not-linked"
    FLUSHING = "flushing"
    EOS = "eos"
    NOT_NEGOTIATED = "not-negotiated"
    NOT_SUPPORTED = "not-supported"
    ERROR = "error"

    @property
    def is_ok(self) -> bool:
        return self is FlowReturn.OK


class FlowError(Exception):
    """Raised by element code to abort dataflow with a FlowReturn."""

    def __init__(self, ret: FlowReturn, msg: str = ""):
        super().__init__(msg or ret.value)
        self.ret = ret


class PadDirection(enum.Enum):
    SRC = "src"
    SINK = "sink"


class PadPresence(enum.Enum):
    ALWAYS = "always"
    SOMETIMES = "sometimes"
    REQUEST = "request"


class PadTemplate:
    def __init__(self, name_template: str, direction: PadDirection,
                 presence: PadPresence, caps: Caps):
        self.name_template = name_template
        self.direction = direction
        self.presence = presence
        self.caps = caps


class Pad:
    """A directed connection point carrying buffers/events/queries.

    Sticky events (stream-start, caps, segment, tags, EOS) are stored on
    the src pad and replayed to a newly-linked or data-receiving peer,
    matching GStreamer sticky-event semantics the reference relies on
    (e.g. streamgrouper rewrites sticky stream-start events,
    generic/streamgrouper/src/streamgrouper/imp.rs:22-24).
    """

    _STICKY_ORDER = (StreamStartEvent, CapsEvent, SegmentEvent)

    def __init__(self, name: str, direction: PadDirection,
                 template: PadTemplate | None = None,
                 element: "Element | None" = None):
        self.name = name
        self.direction = direction
        self.template = template
        self.element = element
        self.peer: Pad | None = None
        self.current_caps: Caps | None = None
        self.sticky_events: dict[type, Event] = {}
        self.flushing = False
        self.eos = False
        # handler hooks (set by element/base class)
        self.chain_function: Callable[[Pad, Buffer], FlowReturn] | None = None
        self.chain_list_function: Callable[[Pad, BufferList], FlowReturn] | None = None
        self.event_function: Callable[[Pad, Event], bool] | None = None
        self.query_function: Callable[[Pad, Query], bool] | None = None
        # pull-mode scheduling (GStreamer getrange): src pads that can
        # serve random access set this to (pad, offset, size) -> bytes
        self.get_range_function: \
            Callable[["Pad", int, int], bytes] | None = None
        # probes: callables (pad, item) -> "ok"|"drop"|"remove"
        self._probes: list[Callable] = []

    # -- linking ------------------------------------------------------
    def link(self, sink: "Pad") -> None:
        if self.direction is not PadDirection.SRC \
                or sink.direction is not PadDirection.SINK:
            raise ValueError(f"link needs src→sink, got {self}→{sink}")
        if self.peer is not None or sink.peer is not None:
            raise RuntimeError(f"pad already linked: {self} or {sink}")
        tcaps_src = self.pad_template_caps()
        tcaps_sink = sink.pad_template_caps()
        if not tcaps_src.can_intersect(tcaps_sink):
            raise RuntimeError(
                f"cannot link {self}: template caps do not intersect:\n"
                f"  src:  {tcaps_src!r}\n  sink: {tcaps_sink!r}")
        self.peer = sink
        sink.peer = self

    def unlink(self) -> None:
        if self.peer is not None:
            self.peer.peer = None
            self.peer = None

    def is_linked(self) -> bool:
        return self.peer is not None

    def pad_template_caps(self) -> Caps:
        return self.template.caps if self.template else Caps.any()

    # -- probes -------------------------------------------------------
    def add_probe(self, fn: Callable) -> Callable:
        self._probes.append(fn)
        return fn

    def remove_probe(self, fn: Callable) -> None:
        if fn in self._probes:
            self._probes.remove(fn)

    def _run_probes(self, item) -> bool:
        """Returns False if the item should be dropped."""
        for fn in list(self._probes):
            r = fn(self, item)
            if r == "drop":
                return False
            if r == "remove":
                self._probes.remove(fn)
        return True

    # -- dataflow (src side) ------------------------------------------
    # -- pull-mode scheduling (getrange) --------------------------------
    def pull_range(self, offset: int, size: int) -> bytes:
        """Pull `size` bytes at `offset` from the linked src pad
        (GStreamer gst_pad_pull_range; reference pull-mode elements:
        sodium decrypter, flvdemux pull mode). Returns fewer bytes at
        end-of-stream; raises FlowError otherwise."""
        assert self.direction is PadDirection.SINK, \
            "pull_range on src pad"
        peer = self.peer
        if peer is None or peer.get_range_function is None:
            raise FlowError(FlowReturn.NOT_SUPPORTED,
                            "upstream has no getrange support")
        return peer.get_range_function(peer, offset, size)

    @property
    def can_pull(self) -> bool:
        """Whether the linked peer supports pull scheduling."""
        return (self.direction is PadDirection.SINK
                and self.peer is not None
                and self.peer.get_range_function is not None)

    def push(self, buf: Buffer) -> FlowReturn:
        assert self.direction is PadDirection.SRC, "push on sink pad"
        if self.flushing:
            return FlowReturn.FLUSHING
        if not self._run_probes(buf):
            return FlowReturn.OK
        peer = self.peer
        if peer is None:
            return FlowReturn.NOT_LINKED
        self._forward_stickies(peer)
        from gstpu_torch.utils import tracing
        if tracing.has_hooks("pad-push-pre") \
                or tracing.has_hooks("pad-push-post"):
            tracing.dispatch("pad-push-pre", self, buf)
            ret = peer.chain(buf)
            tracing.dispatch("pad-push-post", self, buf)
            return ret
        return peer.chain(buf)

    def push_list(self, buflist: BufferList) -> FlowReturn:
        assert self.direction is PadDirection.SRC
        if self.flushing:
            return FlowReturn.FLUSHING
        peer = self.peer
        if peer is None:
            return FlowReturn.NOT_LINKED
        self._forward_stickies(peer)
        if peer.chain_list_function is not None:
            return peer.chain_list_function(peer, buflist)
        for b in buflist:
            ret = peer.chain(b)
            if not ret.is_ok:
                return ret
        return FlowReturn.OK

    def push_event(self, ev: Event) -> bool:
        """Push an event downstream (src pad) or upstream (sink pad)."""
        if ev.sticky and self.direction is PadDirection.SRC:
            self.sticky_events[type(ev)] = ev
            if isinstance(ev, CapsEvent):
                self.current_caps = ev.caps
            if isinstance(ev, EosEvent):
                self.eos = True
        if not self._run_probes(ev):
            return True
        peer = self.peer
        if peer is None:
            return False
        if self.direction is PadDirection.SRC and ev.sticky:
            # send pending stickies in canonical order first
            self._forward_stickies(peer, upto=type(ev))
        return peer.send_event(ev)

    def _forward_stickies(self, peer: "Pad", upto: type | None = None) -> None:
        for cls in self._STICKY_ORDER:
            if cls is upto:
                break
            ev = self.sticky_events.get(cls)
            if ev is not None and peer._last_sticky.get(cls) is not ev:
                peer._last_sticky[cls] = ev
                peer.send_event(ev)
        if upto is not None and upto in self.sticky_events:
            peer._last_sticky[upto] = self.sticky_events[upto]

    def query(self, q: Query) -> bool:
        """Send a query to the peer."""
        peer = self.peer
        if peer is None:
            return False
        if peer.query_function is not None:
            return peer.query_function(peer, q)
        if peer.element is not None:
            return peer.element.default_pad_query(peer, q)
        return False

    # -- dataflow (sink side, called by peer) -------------------------
    @property
    def _last_sticky(self) -> dict:
        d = getattr(self, "_last_sticky_d", None)
        if d is None:
            d = {}
            object.__setattr__(self, "_last_sticky_d", d)
        return d

    def chain(self, buf: Buffer) -> FlowReturn:
        assert self.direction is PadDirection.SINK, "chain on src pad"
        if self.flushing:
            return FlowReturn.FLUSHING
        if self.eos:
            return FlowReturn.EOS
        if not self._run_probes(buf):
            return FlowReturn.OK
        if self.chain_function is None:
            return FlowReturn.NOT_LINKED
        try:
            return self.chain_function(self, buf)
        except FlowError as e:
            return e.ret

    def send_event(self, ev: Event) -> bool:
        if isinstance(ev, FlushStartEvent):
            self.flushing = True
        elif isinstance(ev, FlushStopEvent):
            self.flushing = False
            self.eos = False
        elif isinstance(ev, EosEvent) and self.direction is PadDirection.SINK:
            self.eos = True
        if ev.sticky and self.direction is PadDirection.SINK:
            self.sticky_events[type(ev)] = ev
            if isinstance(ev, CapsEvent):
                self.current_caps = ev.caps
        if not self._run_probes(ev):
            return True
        if self.event_function is not None:
            return self.event_function(self, ev)
        if self.element is not None:
            return self.element.default_pad_event(self, ev)
        return False

    def get_sticky(self, cls: type) -> Event | None:
        return self.sticky_events.get(cls)

    def caps(self) -> Caps | None:
        return self.current_caps

    def peer_query_caps(self, filter: Caps | None = None) -> Caps:
        q = CapsQuery(filter)
        if self.query(q) and q.caps is not None:
            return q.caps
        base = self.peer.pad_template_caps() if self.peer else Caps.any()
        return base.intersect(filter) if filter is not None else base

    def query_caps(self, filter: Caps | None = None) -> Caps:
        q = CapsQuery(filter)
        handled = (self.query_function(self, q) if self.query_function
                   else (self.element.default_pad_query(self, q)
                         if self.element else False))
        if handled and q.caps is not None:
            return q.caps
        base = self.pad_template_caps()
        return base.intersect(filter) if filter is not None else base

    def __repr__(self):
        el = self.element.name if self.element else "?"
        return f"<Pad {el}:{self.name} {self.direction.value}>"


# ---------------------------------------------------------------------------
# Messages / Bus
# ---------------------------------------------------------------------------

class MessageType(enum.Enum):
    EOS = "eos"
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"
    ELEMENT = "element"       # structured element message (metrics channel)
    STATE_CHANGED = "state-changed"
    APPLICATION = "application"
    LATENCY = "latency"
    BUFFERING = "buffering"
    QOS = "qos"


class Message:
    def __init__(self, mtype: MessageType, src: "Element | None" = None,
                 **fields: Any):
        self.type = mtype
        self.src = src
        self.fields = fields

    def __getattr__(self, k):
        try:
            return self.__dict__["fields"][k]
        except KeyError:
            raise AttributeError(k)

    def __repr__(self):
        s = self.src.name if self.src else "?"
        return f"<Message {self.type.value} from {s} {self.fields}>"


class Bus:
    """Thread-safe message channel from elements to the application
    (the reference's metrics channel, SURVEY.md §5.5)."""

    def __init__(self):
        self._q: _queue.Queue[Message] = _queue.Queue()
        self._sync_handlers: list[Callable[[Message], None]] = []

    def post(self, msg: Message) -> None:
        for h in list(self._sync_handlers):
            h(msg)
        self._q.put(msg)

    def add_sync_handler(self, fn: Callable[[Message], None]) -> None:
        self._sync_handlers.append(fn)

    def pop(self, timeout: float | None = 0) -> Message | None:
        try:
            if timeout == 0:
                return self._q.get_nowait()
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def pop_filtered(self, *types: MessageType,
                     timeout: float | None = 0) -> Message | None:
        """Pop the next message of one of the given types (discards
        non-matching messages, like gst_bus_timed_pop_filtered)."""
        import time
        deadline = None if timeout is None else time.monotonic() + (timeout or 0)
        while True:
            remaining = None if deadline is None else max(0, deadline - time.monotonic())
            msg = self.pop(timeout=remaining)
            if msg is None:
                return None
            if msg.type in types:
                return msg

    def drain(self) -> list[Message]:
        out = []
        while True:
            m = self.pop()
            if m is None:
                return out
            out.append(m)


# ---------------------------------------------------------------------------
# Element
# ---------------------------------------------------------------------------

_elem_counter = itertools.count(0)


class Element(HasProperties):
    """Base element: pads + properties + state machine + messages.

    Subclasses declare:
      ELEMENT_NAME     factory name ("rsaudioecho")
      ELEMENT_METADATA dict(long_name=, klass=, description=, author=)
      PAD_TEMPLATES    list[PadTemplate]
    and override state hooks / pad functions.
    """

    ELEMENT_NAME: str = ""
    ELEMENT_METADATA: dict = {}
    PAD_TEMPLATES: list[PadTemplate] = []

    SIGNALS: tuple[str, ...] = ()

    def __init__(self, name: str | None = None):
        super().__init__()
        self.name = name or f"{self.ELEMENT_NAME or type(self).__name__.lower()}{next(_elem_counter)}"
        self.pads: dict[str, Pad] = {}
        self.state = State.NULL
        self.pending_state: State | None = None
        self.bus: Bus | None = None
        self.clock: Clock | None = None
        self.base_time: int = 0
        self.parent: "Element | None" = None
        self.is_live = False
        self._signal_handlers: dict[str, list[Callable]] = {}
        self._state_lock = threading.RLock()
        for tmpl in self.PAD_TEMPLATES:
            if tmpl.presence is PadPresence.ALWAYS:
                self.add_pad(Pad(tmpl.name_template, tmpl.direction, tmpl,
                                 self))

    # -- pads ---------------------------------------------------------
    def add_pad(self, pad: Pad) -> Pad:
        pad.element = self
        self.pads[pad.name] = pad
        return pad

    def remove_pad(self, pad: Pad) -> None:
        pad.unlink()
        self.pads.pop(pad.name, None)

    def static_pad(self, name: str) -> Pad | None:
        return self.pads.get(name)

    def request_pad(self, name: str | None = None) -> Pad:
        """Request a pad from a REQUEST template (e.g. aggregator
        sink_%u)."""
        for tmpl in self.PAD_TEMPLATES:
            if tmpl.presence is not PadPresence.REQUEST:
                continue
            if name is not None and "%" in tmpl.name_template:
                prefix = tmpl.name_template.split("%")[0]
                if not name.startswith(prefix):
                    continue
            n = name
            if n is None:
                i = 0
                while True:
                    n = tmpl.name_template.replace("%u", str(i)).replace("%d", str(i))
                    if n not in self.pads:
                        break
                    i += 1
            if n in self.pads:
                raise RuntimeError(f"pad {n} already exists on {self.name}")
            pad = Pad(n, tmpl.direction, tmpl, self)
            self.add_pad(pad)
            self.new_request_pad(pad)
            return pad
        raise RuntimeError(f"{self.name}: no REQUEST pad template for {name!r}")

    def new_request_pad(self, pad: Pad) -> None:
        """Hook: a request pad was created."""

    def release_request_pad(self, pad: Pad) -> None:
        self.remove_pad(pad)

    def src_pads(self) -> list[Pad]:
        return [p for p in self.pads.values()
                if p.direction is PadDirection.SRC]

    def sink_pads(self) -> list[Pad]:
        return [p for p in self.pads.values()
                if p.direction is PadDirection.SINK]

    def link(self, downstream: "Element") -> "Element":
        """Link first unlinked src pad to downstream's first unlinked
        sink pad (gst_element_link)."""
        for sp in self.src_pads():
            if not sp.is_linked():
                for tp in downstream.sink_pads():
                    if not tp.is_linked():
                        sp.link(tp)
                        return downstream
                # allow requesting a sink pad
                try:
                    tp = downstream.request_pad()
                    sp.link(tp)
                    return downstream
                except RuntimeError:
                    break
        raise RuntimeError(f"cannot link {self.name} -> {downstream.name}")

    # -- properties ---------------------------------------------------
    def _check_mutability(self, prop: Property) -> None:
        if prop.mutable is Mutability.PLAYING:
            return
        limit = {Mutability.NULL: State.NULL, Mutability.READY: State.READY,
                 Mutability.PAUSED: State.PAUSED}[prop.mutable]
        if self.state > limit:
            raise PermissionError(
                f"{self.name}: property {prop.name!r} only mutable at "
                f"{limit.name} or below (state is {self.state.name})")

    # -- signals ------------------------------------------------------
    def connect(self, signal: str, handler: Callable) -> None:
        if signal.startswith("notify::"):
            self.connect_notify(signal[len("notify::"):], handler)
            return
        if signal not in self.SIGNALS:
            raise KeyError(f"{type(self).__name__} has no signal {signal!r}")
        self._signal_handlers.setdefault(signal, []).append(handler)

    def emit(self, signal: str, *args) -> Any:
        ret = None
        for h in self._signal_handlers.get(signal, []):
            ret = h(self, *args)
        return ret

    # -- messages -----------------------------------------------------
    def post_message(self, msg: Message) -> None:
        msg.src = msg.src or self
        target = self
        while target.parent is not None:
            target = target.parent
        if target.bus is not None:
            target.bus.post(msg)
        elif self.bus is not None:
            self.bus.post(msg)

    def post_error(self, text: str, debug: str = "") -> None:
        CAT.error("%s: %s %s", self.name, text, debug)
        self.post_message(Message(MessageType.ERROR, self, text=text,
                                  debug=debug or traceback.format_exc()))

    def post_warning(self, text: str, debug: str = "") -> None:
        CAT.warning("%s: %s %s", self.name, text, debug)
        self.post_message(Message(MessageType.WARNING, self, text=text,
                                  debug=debug))

    def post_element_message(self, name: str, **fields) -> None:
        self.post_message(Message(MessageType.ELEMENT, self,
                                  name=name, **fields))

    # -- state machine ------------------------------------------------
    def set_state(self, target: State) -> StateChangeReturn:
        with self._state_lock:
            ret = StateChangeReturn.SUCCESS
            while self.state != target:
                step = 1 if target > self.state else -1
                nxt = State(self.state + step)
                r = self.change_state(self.state, nxt)
                if r is StateChangeReturn.FAILURE:
                    return r
                if r is StateChangeReturn.NO_PREROLL:
                    ret = r
                old, self.state = self.state, nxt
                self.post_message(Message(MessageType.STATE_CHANGED, self,
                                          old=old, new=nxt))
            return ret

    def change_state(self, old: State, new: State) -> StateChangeReturn:
        """Per-transition hook. Subclasses/base classes override and
        must chain up."""
        try:
            if (old, new) == (State.NULL, State.READY):
                if not self.start():
                    return StateChangeReturn.FAILURE
            elif (old, new) == (State.READY, State.PAUSED):
                if not self.ready_to_paused():
                    return StateChangeReturn.FAILURE
                if self.is_live:
                    return StateChangeReturn.NO_PREROLL
            elif (old, new) == (State.PAUSED, State.PLAYING):
                if not self.paused_to_playing():
                    return StateChangeReturn.FAILURE
            elif (old, new) == (State.PLAYING, State.PAUSED):
                if not self.playing_to_paused():
                    return StateChangeReturn.FAILURE
            elif (old, new) == (State.PAUSED, State.READY):
                if not self.paused_to_ready():
                    return StateChangeReturn.FAILURE
            elif (old, new) == (State.READY, State.NULL):
                if not self.stop():
                    return StateChangeReturn.FAILURE
        except Exception as e:  # element code raised
            self.post_error(f"state change {old.name}->{new.name} failed: {e}")
            return StateChangeReturn.FAILURE
        return StateChangeReturn.SUCCESS

    # state hooks ------------------------------------------------------
    def start(self) -> bool:
        return True

    def ready_to_paused(self) -> bool:
        return True

    def paused_to_playing(self) -> bool:
        return True

    def playing_to_paused(self) -> bool:
        return True

    def paused_to_ready(self) -> bool:
        return True

    def stop(self) -> bool:
        return True

    # -- default pad handlers -----------------------------------------
    def default_pad_event(self, pad: Pad, ev: Event) -> bool:
        """Forward the event through the element (sink→all srcs,
        src→all sinks)."""
        if pad.direction is PadDirection.SINK:
            targets = self.src_pads()
        else:
            targets = self.sink_pads()
        ok = True
        for t in targets:
            if t.direction is PadDirection.SRC:
                ok = t.push_event(ev) and ok
            elif t.peer is not None:
                ok = t.peer.push_event(ev) and ok
        return ok

    def default_pad_query(self, pad: Pad, q: Query) -> bool:
        if isinstance(q, CapsQuery):
            base = pad.pad_template_caps()
            q.caps = base.intersect(q.filter) if q.filter is not None else base
            return True
        if isinstance(q, AcceptCapsQuery):
            q.accepted = q.caps.can_intersect(pad.pad_template_caps())
            return True
        # forward other queries through the element
        if pad.direction is PadDirection.SINK:
            for sp in self.src_pads():
                if sp.query(q):
                    return True
        else:
            for sp in self.sink_pads():
                if sp.peer is not None and sp.peer.element is not None:
                    peer_el = sp.peer.element
                    src_of_peer = sp.peer
                    if src_of_peer.query_function:
                        if src_of_peer.query_function(src_of_peer, q):
                            return True
                    elif peer_el.default_pad_query(src_of_peer, q):
                        return True
        return False

    # -- misc ---------------------------------------------------------
    def running_time(self) -> int | None:
        if self.clock is None:
            return None
        return self.clock.time() - self.base_time

    def iterate_tasks(self) -> Iterable:
        """Tasks this element contributes to the pipeline scheduler
        (sources and queue-like elements override)."""
        return ()

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r} {self.state.name}>"
