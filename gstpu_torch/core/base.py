"""Base classes: the L2 layer every element subclasses.

Rebuilds the GStreamer base-class contracts the reference plugins are
written against (SURVEY.md §1 L2): BaseTransform's negotiation +
in-place/copy transform (reference tutorial/src/rgb2gray/imp.rs),
PushSrc's create loop, BaseSink's render/EOS handling, AudioFilter /
VideoFilter conveniences, Aggregator's N→1 timeout-driven muxing
(mux/isobmff fmp4mux), and decoder/encoder shells.
"""

from __future__ import annotations

from typing import Optional

from gstpu_torch.core.audio import AudioInfo, audio_caps
from gstpu_torch.core.buffer import Buffer, BufferList
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowError, FlowReturn, Message,
                                MessageType, Pad, PadDirection, PadPresence,
                                PadTemplate, State)
from gstpu_torch.core.event import (CapsEvent, EosEvent, Event, FlushStopEvent,
                              GapEvent, Segment, SegmentEvent,
                              StreamStartEvent)
from gstpu_torch.core.props import Property
from gstpu_torch.core.query import (AcceptCapsQuery, CapsQuery, LatencyQuery,
                              Query)
from gstpu_torch.core.video import VideoInfo, video_caps
from gstpu_torch.runtime.scheduler import Task, TaskResult
from gstpu_torch.utils.log import debug_category

CAT = debug_category("base")


# ---------------------------------------------------------------------------
# BaseTransform
# ---------------------------------------------------------------------------

class BaseTransform(Element):
    """1-in/1-out transform with caps negotiation.

    Subclass hooks (mirroring BaseTransformImpl):
      transform_caps(direction, caps, filter) -> Caps
      set_caps(incaps, outcaps) -> bool
      transform(inbuf) -> Buffer            (copy mode)
      transform_ip(buf) -> None             (in-place mode)
      sink_event(event) -> bool
      query hooks via src_query/sink_query
    Set IN_PLACE=True for in-place elements (reference audioecho
    AlwaysInPlace, audio/audiofx/src/audioecho/imp.rs:199-227).
    Set PASSTHROUGH_ON_SAME_CAPS for meters (ebur128level).
    """

    IN_PLACE = False
    PASSTHROUGH_ON_SAME_CAPS = False

    def __init__(self, name: str | None = None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.srcpad = self.static_pad("src")
        assert self.sinkpad is not None and self.srcpad is not None, \
            f"{type(self).__name__} needs 'sink' and 'src' ALWAYS templates"
        self.sinkpad.chain_function = self._sink_chain
        self.sinkpad.event_function = self._sink_event
        self.sinkpad.query_function = self._sink_query
        self.srcpad.query_function = self._src_query
        self.passthrough = False
        self.in_caps: Caps | None = None
        self.out_caps: Caps | None = None
        self.segment = Segment()

    # -- negotiation ----------------------------------------------------
    def transform_caps(self, direction: PadDirection, caps: Caps,
                       filter: Caps | None) -> Caps:
        """Default: same-caps transform, constrained by own templates."""
        if direction is PadDirection.SINK:
            out = caps.intersect(self.srcpad.pad_template_caps())
        else:
            out = caps.intersect(self.sinkpad.pad_template_caps())
        if filter is not None:
            out = out.intersect(filter)
        return out

    def fixate_caps(self, direction: PadDirection, caps: Caps,
                    othercaps: Caps) -> Caps:
        return othercaps.fixate(near=caps)

    def set_caps(self, incaps: Caps, outcaps: Caps) -> bool:
        return True

    def _negotiate(self, incaps: Caps) -> bool:
        filter = (self.srcpad.peer_query_caps()
                  if self.srcpad.is_linked() else None)
        othercaps = self.transform_caps(PadDirection.SINK, incaps, filter)
        if othercaps.is_empty():
            self.post_error(f"could not negotiate: {incaps!r} -> EMPTY "
                            f"(filter {filter!r})")
            return False
        if not othercaps.is_fixed():
            othercaps = self.fixate_caps(PadDirection.SINK, incaps, othercaps)
        self.in_caps, self.out_caps = incaps, othercaps
        self.passthrough = (self.PASSTHROUGH_ON_SAME_CAPS
                            and incaps == othercaps)
        if not self.set_caps(incaps, othercaps):
            return False
        self.srcpad.push_event(CapsEvent(othercaps))
        return True

    # -- dataflow -------------------------------------------------------
    def _sink_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self.in_caps is None:
            return FlowReturn.NOT_NEGOTIATED
        if self.passthrough:
            return self.srcpad.push(buf)
        try:
            if self.IN_PLACE:
                buf = buf.copy(deep=False)
                out = self.transform_ip(buf)
                out = buf if out is None else out
            else:
                out = self.transform(buf)
        except FlowError as e:
            return e.ret
        except Exception as e:
            self.post_error(f"transform failed: {e}")
            return FlowReturn.ERROR
        if out is None:
            return FlowReturn.OK  # dropped (e.g. aggregating)
        if isinstance(out, BufferList):
            return self.srcpad.push_list(out)
        if isinstance(out, list):
            for b in out:
                ret = self.srcpad.push(b)
                if not ret.is_ok:
                    return ret
            return FlowReturn.OK
        return self.srcpad.push(out)

    def transform(self, buf: Buffer) -> Buffer | list | None:
        raise NotImplementedError

    def transform_ip(self, buf: Buffer) -> None:
        raise NotImplementedError

    # -- events/queries ---------------------------------------------------
    def sink_event(self, event: Event) -> bool:
        """Subclass hook; return False to use default forwarding."""
        return False

    def _sink_event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, CapsEvent):
            return self._negotiate(ev.caps)
        if isinstance(ev, SegmentEvent):
            self.segment = ev.segment
        if self.sink_event(ev):
            return True
        if isinstance(ev, EosEvent):
            drained = self.drain()
            if drained:
                for b in drained:
                    self.srcpad.push(b)
        if isinstance(ev, FlushStopEvent):
            self.flush()
        return self.srcpad.push_event(ev)

    def drain(self) -> list[Buffer]:
        """Subclass hook: emit buffered tail at EOS."""
        return []

    def flush(self) -> None:
        """Subclass hook: drop internal state on flush."""

    def _sink_query(self, pad: Pad, q: Query) -> bool:
        if isinstance(q, CapsQuery):
            peer = (self.srcpad.peer_query_caps()
                    if self.srcpad.is_linked() else None)
            caps = (self.transform_caps(PadDirection.SRC, peer, None)
                    if peer is not None else self.sinkpad.pad_template_caps())
            caps = caps.intersect(self.sinkpad.pad_template_caps())
            q.caps = caps.intersect(q.filter) if q.filter else caps
            return True
        if isinstance(q, AcceptCapsQuery):
            q.accepted = q.caps.can_intersect(self.sinkpad.pad_template_caps())
            return True
        if isinstance(q, LatencyQuery):
            if self.srcpad.query(q):
                self.add_latency(q)
                return True
            return False
        return self.default_pad_query(pad, q)

    def _src_query(self, pad: Pad, q: Query) -> bool:
        if isinstance(q, CapsQuery):
            peer = (self.sinkpad.peer_query_caps()
                    if self.sinkpad.is_linked() else None)
            caps = (self.transform_caps(PadDirection.SINK, peer, None)
                    if peer is not None else self.srcpad.pad_template_caps())
            caps = caps.intersect(self.srcpad.pad_template_caps())
            q.caps = caps.intersect(q.filter) if q.filter else caps
            return True
        if isinstance(q, LatencyQuery):
            if self.sinkpad.query(q):
                self.add_latency(q)
                return True
            return False
        return self.default_pad_query(pad, q)

    def add_latency(self, q: LatencyQuery) -> None:
        """Subclass hook: accumulate this element's latency
        (reference audiornnoise latency query imp.rs:362-380)."""


class AudioFilter(BaseTransform):
    """BaseTransform negotiating audio/x-raw; calls setup(AudioInfo)."""

    ALLOWED_FORMATS: tuple[str, ...] | None = None  # None = all

    def __init__(self, name: str | None = None):
        super().__init__(name)
        self.audio_info: AudioInfo | None = None

    def set_caps(self, incaps: Caps, outcaps: Caps) -> bool:
        self.audio_info = AudioInfo.from_caps(incaps)
        return self.setup(self.audio_info)

    def setup(self, info: AudioInfo) -> bool:
        return True


class VideoFilter(BaseTransform):
    """BaseTransform negotiating video/x-raw; calls set_info()."""

    def __init__(self, name: str | None = None):
        super().__init__(name)
        self.video_info: VideoInfo | None = None
        self.out_video_info: VideoInfo | None = None

    def set_caps(self, incaps: Caps, outcaps: Caps) -> bool:
        self.video_info = VideoInfo.from_caps(incaps)
        self.out_video_info = VideoInfo.from_caps(outcaps)
        return self.set_info(self.video_info, self.out_video_info)

    def set_info(self, in_info: VideoInfo, out_info: VideoInfo) -> bool:
        return True


# ---------------------------------------------------------------------------
# BaseSrc / PushSrc
# ---------------------------------------------------------------------------

class PushSrc(Element):
    """Source driving a scheduler task that calls create().

    create() returns a Buffer, None (EOS) or raises FlowError.
    Subclasses set self.is_live for live sources.
    """

    def __init__(self, name: str | None = None):
        super().__init__(name)
        self.srcpad = self.static_pad("src")
        assert self.srcpad is not None
        self.srcpad.query_function = self._src_query
        self._stream_started = False
        self._task = Task(self.name, self._iterate)
        self.segment = Segment()

    # -- negotiation ----------------------------------------------------
    def negotiate(self) -> Caps | None:
        tmpl = self.srcpad.pad_template_caps()
        peer = self.srcpad.peer_query_caps(tmpl)
        caps = peer if not peer.is_any() else tmpl
        if caps.is_empty():
            self.post_error(f"source negotiation failed: {tmpl!r} vs peer")
            return None
        caps = self.fixate(caps)
        return caps

    def fixate(self, caps: Caps) -> Caps:
        return caps.fixate()

    def set_caps(self, caps: Caps) -> bool:
        return True

    # -- task -----------------------------------------------------------
    def iterate_tasks(self):
        if getattr(self.srcpad, "pull_mode_active", False):
            return ()     # downstream pulls; no streaming task
        if self.srcpad.is_linked():
            self._task = Task(self.name, self._iterate)
            self._stream_started = False
            return (self._task,)
        return ()

    def _iterate(self) -> TaskResult:
        if not self._stream_started:
            caps = self.negotiate()
            if caps is None:
                return TaskResult.ERROR
            if not self.set_caps(caps):
                return TaskResult.ERROR
            self.srcpad.push_event(StreamStartEvent(f"{self.name}/stream-0"))
            self.srcpad.push_event(CapsEvent(caps))
            self.srcpad.push_event(SegmentEvent(self.segment))
            self._stream_started = True
        try:
            buf = self.create()
        except FlowError as e:
            if e.ret is FlowReturn.EOS:
                self.srcpad.push_event(EosEvent())
                return TaskResult.EOS
            if e.ret is FlowReturn.FLUSHING:
                return TaskResult.IDLE  # starved (live source): retry
            self.post_error(f"create failed: {e}")
            return TaskResult.ERROR
        if buf is None:
            self.srcpad.push_event(EosEvent())
            return TaskResult.EOS
        ret = self.srcpad.push(buf)
        if ret is FlowReturn.EOS:
            self.srcpad.push_event(EosEvent())
            return TaskResult.EOS
        if ret is FlowReturn.FLUSHING:
            return TaskResult.PAUSE
        if not ret.is_ok:
            self.post_error(f"push failed: {ret}")
            return TaskResult.ERROR
        return TaskResult.CONTINUE

    def create(self) -> Buffer | None:
        raise NotImplementedError

    def _src_query(self, pad: Pad, q: Query) -> bool:
        if isinstance(q, LatencyQuery):
            q.live = self.is_live
            return True
        return self.default_pad_query(pad, q)


# ---------------------------------------------------------------------------
# BaseSink
# ---------------------------------------------------------------------------

class BaseSink(Element):
    """Sink: render() per buffer, posts EOS message on EOS event.

    `sync` defaults TRUE like GStreamer's basesink: with a pipeline
    clock, rendering waits for the buffer's running time.  Non-live
    pipelines run WITHOUT a clock by default in gstpu (Pipeline only
    selects one when an element is live or `use_clock()` forces it),
    so offline pipelines process as fast as possible while live ones
    render on schedule (reference livesync/imp.rs:148-210 relies on
    exactly this sink behavior).
    """

    sync = Property(bool, default=True,
                    blurb="Render at the buffer running time against "
                          "the pipeline clock")
    max_lateness = Property(int, default=-1, minimum=-1,
                            blurb="Drop buffers arriving later than "
                                  "this (ns) past their running "
                                  "time; -1 renders them anyway")

    def __init__(self, name: str | None = None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        assert self.sinkpad is not None
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self.caps: Caps | None = None
        self.segment = Segment()
        self.rendered = 0
        self.dropped = 0
        self.last_lateness: int | None = None

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self.sync and self.clock is not None and buf.pts is not None:
            rt = self.segment.to_running_time(buf.pts)
            if rt is not None:
                self.clock.wait_until(self.base_time + rt)
                self.last_lateness = (self.clock.time()
                                      - self.base_time - rt)
                if 0 <= self.max_lateness < self.last_lateness:
                    self.dropped += 1
                    return FlowReturn.OK
        try:
            ret = self.render(buf)
        except FlowError as e:
            return e.ret
        self.rendered += 1
        return ret if ret is not None else FlowReturn.OK

    def render(self, buf: Buffer) -> FlowReturn | None:
        raise NotImplementedError

    def _event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, CapsEvent):
            self.caps = ev.caps
            self.on_caps(ev.caps)
        elif isinstance(ev, SegmentEvent):
            self.segment = ev.segment
        elif isinstance(ev, EosEvent):
            self.on_eos()
            self.post_message(Message(MessageType.EOS, self))
        return True

    def on_caps(self, caps: Caps) -> None:
        pass

    def on_eos(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Aggregator
# ---------------------------------------------------------------------------

class AggregatorPad(Pad):
    def __init__(self, name: str, template: PadTemplate,
                 element: "Aggregator"):
        super().__init__(name, PadDirection.SINK, template, element)
        self.queue: list[Buffer] = []
        self.pad_eos = False
        self.pad_segment = Segment()
        self.chain_function = self._agg_chain
        self.event_function = self._agg_event

    def _agg_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self.queue.append(buf)
        agg: Aggregator = self.element  # type: ignore
        return agg._maybe_aggregate()

    def _agg_event(self, pad: Pad, ev: Event) -> bool:
        agg: Aggregator = self.element  # type: ignore
        if isinstance(ev, CapsEvent):
            self.current_caps = ev.caps
            agg.pad_caps_changed(self, ev.caps)
            return True
        if isinstance(ev, SegmentEvent):
            self.pad_segment = ev.segment
            return True
        if isinstance(ev, EosEvent):
            self.pad_eos = True
            agg._maybe_aggregate()
            agg._maybe_eos()
            return True
        if isinstance(ev, (StreamStartEvent,)):
            return True
        return agg.default_pad_event(pad, ev)

    def peek_buffer(self) -> Buffer | None:
        return self.queue[0] if self.queue else None

    def pop_buffer(self) -> Buffer | None:
        return self.queue.pop(0) if self.queue else None

    def is_eos(self) -> bool:
        return self.pad_eos and not self.queue


class Aggregator(Element):
    """N-sink → 1-src synchronized muxing base
    (reference fmp4mux aggregate(), SURVEY.md §3.4).

    Simplified semantics: aggregate() is called whenever every non-EOS
    sink pad has at least one queued buffer (or at EOS). Subclasses pop
    from pads and push on self.srcpad.

    Live muxing (reference fmp4mux latency handling / GstAggregator
    force-live): with `force-live=true` and a pipeline clock, a timer
    task calls aggregate(timeout=True) once `latency` ns of running
    time pass without all pads delivering — starving inputs can't
    stall the mux.  `min-upstream-latency` is added to latency
    queries like the reference property.
    """

    force_live = Property(bool, default=False,
                          blurb="Aggregate on the clock even when "
                                "pads starve (needs a live pipeline "
                                "clock)")
    latency = Property(int, default=0, minimum=0,
                       blurb="Max running-time wait for lagging pads "
                             "before a timeout aggregate (ns)")
    min_upstream_latency = Property(int, default=0, minimum=0,
                                    blurb="Floor reported for "
                                          "upstream latency (ns)")

    def __init__(self, name: str | None = None):
        super().__init__(name)
        self.srcpad = self.static_pad("src")
        assert self.srcpad is not None
        self._src_started = False
        self._sent_eos = False
        self._last_agg_rt: int | None = None

    def iterate_tasks(self):
        if not self.force_live:
            return ()
        return (Task(f"{self.name}-agg-timeout", self._timeout_tick),)

    def _timeout_tick(self) -> TaskResult:
        if self.clock is None or self._sent_eos:
            return TaskResult.IDLE
        now_rt = self.clock.time() - self.base_time
        if self._last_agg_rt is None:
            self._last_agg_rt = now_rt
            return TaskResult.IDLE
        if now_rt - self._last_agg_rt < max(self.latency, 1):
            return TaskResult.IDLE
        pads = self.agg_sink_pads()
        if pads and any(p.queue for p in pads) and not self._ready():
            # some pads starve past the deadline: timeout aggregate
            self._ensure_src_stream()
            self._last_agg_rt = now_rt
            self.aggregate(timeout=True)
            return TaskResult.CONTINUE
        return TaskResult.IDLE

    def add_latency(self, q) -> None:
        if self.min_upstream_latency:
            q.add(self.min_upstream_latency, self.min_upstream_latency)
        if self.force_live:
            q.live = True

    def request_pad(self, name: str | None = None) -> Pad:
        for tmpl in self.PAD_TEMPLATES:
            if tmpl.presence is PadPresence.REQUEST \
                    and tmpl.direction is PadDirection.SINK:
                i = 0
                n = name
                if n is None:
                    while True:
                        n = tmpl.name_template.replace("%u", str(i))
                        if n not in self.pads:
                            break
                        i += 1
                pad = AggregatorPad(n, tmpl, self)
                self.add_pad(pad)
                self.new_request_pad(pad)
                return pad
        raise RuntimeError(f"{self.name}: no sink REQUEST template")

    def agg_sink_pads(self) -> list[AggregatorPad]:
        return [p for p in self.pads.values() if isinstance(p, AggregatorPad)]

    def _ready(self) -> bool:
        pads = self.agg_sink_pads()
        if not pads:
            return False
        return all(p.queue or p.pad_eos for p in pads)

    def _ensure_src_stream(self) -> None:
        if not self._src_started:
            self.srcpad.push_event(StreamStartEvent(f"{self.name}/src"))
            caps = self.negotiate_src_caps()
            if caps is not None:
                self.srcpad.push_event(CapsEvent(caps))
            self.srcpad.push_event(SegmentEvent(Segment()))
            self._src_started = True

    def negotiate_src_caps(self) -> Caps | None:
        """Subclass hook: produce src caps once inputs are known."""
        return None

    def _maybe_aggregate(self) -> FlowReturn:
        ret = FlowReturn.OK
        while self._ready() and not all(p.is_eos()
                                        for p in self.agg_sink_pads()):
            self._ensure_src_stream()
            queued_before = sum(len(p.queue)
                                for p in self.agg_sink_pads())
            ret = self.aggregate(timeout=False)
            if self.clock is not None:
                self._last_agg_rt = self.clock.time() - self.base_time
            if not ret.is_ok:
                return ret
            queued_after = sum(len(p.queue) for p in self.agg_sink_pads())
            if queued_after >= queued_before:
                break  # no progress (waiting for more data/caps)
        return ret

    def _maybe_eos(self) -> None:
        if self._sent_eos:
            return
        if all(p.is_eos() for p in self.agg_sink_pads()):
            self._ensure_src_stream()
            self.drain()
            self._sent_eos = True
            self.srcpad.push_event(EosEvent())

    def aggregate(self, timeout: bool) -> FlowReturn:
        raise NotImplementedError

    def drain(self) -> None:
        """Subclass hook: final flush at EOS."""

    def pad_caps_changed(self, pad: AggregatorPad, caps: Caps) -> None:
        pass


# ---------------------------------------------------------------------------
# Decoder/Encoder shells
# ---------------------------------------------------------------------------

class AudioDecoder(BaseTransform):
    """Audio decoder base: packets in, raw audio out
    (reference claxondec/lewtondec AudioDecoder subclassing).

    Subclasses implement handle_frame(data: bytes, buf) and call
    finish_frame(samples_ndarray)."""

    def __init__(self, name: str | None = None):
        super().__init__(name)
        self.output_info: AudioInfo | None = None
        self._pending_out: list[Buffer] = []
        self._next_pts: int | None = None

    def transform_caps(self, direction, caps, filter):
        """Decoders change caps class entirely: answer with the
        opposite pad's template (a sink query about raw-audio
        downstream constraints must not empty the compressed side)."""
        out = (self.srcpad if direction is PadDirection.SINK
               else self.sinkpad).pad_template_caps().copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def set_output_format(self, info: AudioInfo) -> None:
        self.output_info = info
        self.out_caps = info.to_caps()
        self.srcpad.push_event(CapsEvent(self.out_caps))

    def _negotiate(self, incaps: Caps) -> bool:
        # decoders fix output caps themselves in handle_frame/set_format
        self.in_caps = incaps
        return self.set_format(incaps)

    def set_format(self, caps: Caps) -> bool:
        return True

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        self._pending_out = []
        self.handle_frame(buf)
        out, self._pending_out = self._pending_out, []
        return out or None

    def handle_frame(self, buf: Buffer) -> None:
        raise NotImplementedError

    def finish_frame(self, samples, pts: int | None = None) -> None:
        assert self.output_info is not None, "call set_output_format first"
        if pts is None:
            pts = self._next_pts
        b = self.output_info.make_buffer(samples, pts=pts)
        if pts is not None and b.duration is not None:
            self._next_pts = pts + b.duration
        self._pending_out.append(b)


class VideoDecoder(AudioDecoder):
    """Video decoder base (dav1ddec/ffv1dec/gifdec analogue)."""

    def __init__(self, name: str | None = None):
        super().__init__(name)
        self.video_output_info: VideoInfo | None = None

    def set_video_output_format(self, info: VideoInfo) -> None:
        self.video_output_info = info
        self.out_caps = info.to_caps()
        self.srcpad.push_event(CapsEvent(self.out_caps))

    def finish_video_frame(self, frame, pts: int | None = None) -> None:
        assert self.video_output_info is not None
        b = self.video_output_info.make_buffer(frame, pts=pts)
        self._pending_out.append(b)
