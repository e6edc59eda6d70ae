"""fallbackswitch, livesync, togglerecord: stream supervisors.

Rebuilds the reference failure-handling elements (SURVEY.md §5.3):
fallbackswitch's per-pad health timeout auto-failover
(utils/fallbackswitch/src/fallbackswitch/imp.rs:56-126), livesync's
gap filling with repeated frames/silence (utils/livesync), and
togglerecord's keyframe-aligned record gating with contiguous output
timestamps (utils/togglerecord/src/togglerecord/imp.rs:113-165).

The port's copy of gstpu/elements/utils_/supervise.py: buffers, tensors
included, are forwarded or copied shallowly, never read.
"""

from __future__ import annotations

import numpy as np

from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowReturn, Message, MessageType,
                                      Pad, PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.event import (CapsEvent, EosEvent, Event, GapEvent,
                                    Segment, SegmentEvent, StreamStartEvent)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.runtime.scheduler import Task, TaskResult

SECOND = 1_000_000_000


def _tmpl(name, direction, presence=PadPresence.ALWAYS):
    return PadTemplate(name, direction, presence, Caps.any())


class _SwitchPad(Pad):
    def __init__(self, name, template, element):
        super().__init__(name, PadDirection.SINK, template, element)
        self.priority = 0
        self.last_activity: int | None = None
        self.chain_function = self._sw_chain
        self.event_function = self._sw_event

    def _sw_chain(self, pad, buf):
        return self.element._pad_chain(self, buf)  # type: ignore

    def _sw_event(self, pad, ev):
        return self.element._pad_event(self, ev)  # type: ignore


@register_element("fallbackswitch", Rank.NONE)
class FallbackSwitch(Element):
    """Auto-failover N->1 selector: forwards the highest-priority pad
    that produced data within `timeout`; switches to a lower-priority
    pad when the active one stalls, and back when it recovers
    (immediate-fallback semantics via the property)."""

    PAD_TEMPLATES = [
        _tmpl("src", PadDirection.SRC),
        _tmpl("sink_%u", PadDirection.SINK, PadPresence.REQUEST),
    ]

    timeout = Property(int, default=5 * SECOND, minimum=1,
                       mutable=Mutability.PLAYING)
    immediate_fallback = Property(bool, default=False,
                                  mutable=Mutability.READY)

    SIGNALS = ("active-pad-changed",)

    def __init__(self, name=None):
        super().__init__(name)
        self.srcpad = self.static_pad("src")
        self.active_pad: _SwitchPad | None = None
        self._src_started = False

    def request_pad(self, name=None) -> Pad:
        tmpl = self.PAD_TEMPLATES[1]
        i = 0
        n = name
        if n is None:
            while True:
                n = f"sink_{i}"
                if n not in self.pads:
                    break
                i += 1
        pad = _SwitchPad(n, tmpl, self)
        pad.priority = len([p for p in self.pads.values()
                            if isinstance(p, _SwitchPad)])
        self.add_pad(pad)
        return pad

    def _now(self) -> int:
        return (self.clock.time() - self.base_time) if self.clock else 0

    def _switch_pads(self) -> list[_SwitchPad]:
        return sorted((p for p in self.pads.values()
                       if isinstance(p, _SwitchPad)),
                      key=lambda p: p.priority)

    def _select(self, now: int) -> _SwitchPad | None:
        """Highest priority pad that is healthy (produced data within
        timeout)."""
        for p in self._switch_pads():
            if p.last_activity is not None \
                    and now - p.last_activity <= self.timeout:
                return p
        if self.immediate_fallback:
            for p in self._switch_pads():
                if p.last_activity is not None:
                    return p
        return None

    def _pad_chain(self, pad: _SwitchPad, buf: Buffer) -> FlowReturn:
        now = self._now()
        pad.last_activity = now
        best = self._select(now)
        if best is not None and best is not pad:
            return FlowReturn.OK  # a healthier, higher-priority pad wins
        if self.active_pad is not pad:
            self.active_pad = pad
            self.emit("active-pad-changed", pad)
            self.post_element_message("fallbackswitch-active-pad",
                                      pad=pad.name)
            caps = pad.get_sticky(CapsEvent)
            if caps is not None:
                self.srcpad.push_event(caps)
        if not self._src_started:
            self.srcpad.push_event(StreamStartEvent(f"{self.name}/src"))
            caps = pad.get_sticky(CapsEvent)
            if caps is not None:
                self.srcpad.push_event(caps)
            self.srcpad.push_event(SegmentEvent(Segment()))
            self._src_started = True
        return self.srcpad.push(buf)

    def _pad_event(self, pad: _SwitchPad, ev: Event) -> bool:
        if isinstance(ev, EosEvent):
            others = [p for p in self._switch_pads() if p is not pad]
            if all(p.eos for p in others):
                return self.srcpad.push_event(ev)
            return True
        if ev.sticky:
            return True  # replayed when the pad becomes active
        if pad is self.active_pad:
            return self.srcpad.push_event(ev)
        return True


@register_element("livesync", Rank.NONE)
class LiveSync(Element):
    requires_clock = True        # live element: pipeline selects a clock

    """Converts bursty/gappy input into gapless output by repeating the
    last buffer (or pushing silence) once per frame duration when the
    input stalls (reference utils/livesync/src/livesync/imp.rs:11-67).
    Driven by a scheduler task + the pipeline clock."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    latency = Property(int, default=0, minimum=0,
                       mutable=Mutability.READY)
    duration = Property(int, default=SECOND // 30, minimum=1,
                        mutable=Mutability.READY,
                        blurb="Output frame duration when repeating (ns)")
    late_threshold = Property(
        int, default=2 * SECOND, minimum=-1,
        mutable=Mutability.PLAYING,
        blurb="Max ns spent dropping/repeating before ONE late input "
              "buffer is accepted to re-anchor the timeline; -1 = "
              "never accept late buffers (reference late-threshold, "
              "default 2 s)")
    single_segment = Property(
        bool, default=False, mutable=Mutability.READY,
        blurb="Eat follow-up segment events so downstream sees one "
              "segment (reference single-segment; output timestamps "
              "are kept monotone either way)")
    sync = Property(
        bool, default=True, mutable=Mutability.PLAYING,
        blurb="true = a stalled input earns its repeat only after a "
              "full extra frame duration on the clock (reference "
              "sync=true clock pacing); false = the repeat fires as "
              "soon as the frame deadline passes")
    silent = Property(
        bool, default=True, mutable=Mutability.PLAYING,
        blurb="Suppress property notifications for the in/drop/out/"
              "duplicate counters (reference silent)")
    in_ = Property(int, default=0, writable=False,
                   blurb="Input buffer count (reference 'in')")
    drop = Property(int, default=0, writable=False,
                    blurb="Dropped (late) buffer count")
    out = Property(int, default=0, writable=False,
                   blurb="Output buffer count")
    duplicate = Property(int, default=0, writable=False,
                         blurb="Repeated buffer count")

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.srcpad = self.static_pad("src")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._last: Buffer | None = None
        self._next_pts: int | None = None
        self._eos = False
        self._late_acc = 0          # ns spent late since last accept
        self._segment_seen = False
        self.dropped = 0
        self.duplicated = 0

    def _bump(self, name: str) -> None:
        v = self._prop_values.get(name, 0) + 1
        self._prop_values[name] = v
        if not self.silent:
            for h in self._notify_handlers.get(name, []):
                h(self, v)

    def _chain(self, pad, buf: Buffer) -> FlowReturn:
        self._bump("in_")
        dur = buf.duration if buf.duration is not None else self.duration
        if self._next_pts is not None and buf.pts is not None \
                and buf.pts < self._next_pts:
            lt = self.late_threshold
            if lt < 0 or self._late_acc < lt:
                self.dropped += 1
                self._bump("drop")
                self._late_acc += dur
                return FlowReturn.OK  # behind schedule: drop
            # accept ONE late buffer to re-anchor (reference
            # late-threshold semantics)
            self._late_acc = 0
        else:
            self._late_acc = 0
        self._last = buf
        self._next_pts = (buf.pts if buf.pts is not None
                          else (self._next_pts or 0)) + dur
        self._bump("out")
        return self.srcpad.push(buf)

    def _event(self, pad, ev: Event) -> bool:
        if isinstance(ev, EosEvent):
            self._eos = True
        if isinstance(ev, GapEvent):
            self._fill_until(ev.pts + (ev.duration or 0))
            return True
        from gstpu_torch.core.event import SegmentEvent
        if isinstance(ev, SegmentEvent) and self.single_segment:
            if self._segment_seen:
                return True          # eaten: one segment downstream
            self._segment_seen = True
        return self.srcpad.push_event(ev)

    def _fill_until(self, target_pts: int) -> None:
        while self._last is not None and self._next_pts is not None \
                and self._next_pts < target_pts:
            self._push_repeat()

    def _push_repeat(self) -> None:
        rep = self._last.copy()
        rep.pts = self._next_pts
        rep.duration = self._last.duration or self.duration
        rep.set_flag(BufferFlags.GAP)
        self.duplicated += 1
        self._bump("duplicate")
        self._bump("out")
        self._next_pts += rep.duration
        self.srcpad.push(rep)

    def iterate_tasks(self):
        return (Task(f"{self.name}-fill", self._iterate),)

    def _iterate(self) -> TaskResult:
        if self._eos:
            return TaskResult.EOS
        if self.clock is None or self._last is None \
                or self._next_pts is None:
            return TaskResult.IDLE
        now = self.clock.time() - self.base_time
        deadline = self._next_pts
        if self.sync:
            # clock pacing: allow a full extra frame before repeating
            deadline += self._last.duration or self.duration
        if now >= deadline:
            self._push_repeat()
            return TaskResult.CONTINUE
        return TaskResult.IDLE


@register_element("togglerecord", Rank.NONE)
class ToggleRecord(Element):
    """Record gate: while `record` is true, forwards buffers starting
    at a keyframe, rewriting timestamps so recorded segments are
    contiguous (reference utils/togglerecord imp.rs:113-165)."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    record = Property(bool, default=False, mutable=Mutability.PLAYING)
    is_live = Property(bool, default=False, mutable=Mutability.READY)
    recording = Property(bool, default=False, writable=False,
                         blurb="Whether recording is currently "
                               "taking place (reference read-only "
                               "'recording': record=true engages "
                               "only at the next keyframe)")

    SIGNALS = ("recording-changed",)

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.srcpad = self.static_pad("src")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._recording = False
        self._waiting_keyframe = False
        self._offset = 0             # subtracted from input pts
        self._last_out_end: int = 0  # end ts of last recorded buffer
        self._segment_start: int | None = None

    def _set_recording(self, on: bool) -> None:
        """Flip the internal state, the read-only 'recording'
        property (with notify) and the recording-changed signal."""
        self._recording = on
        self._prop_values["recording"] = on
        for h in self._notify_handlers.get("recording", []):
            h(self, on)
        self.emit("recording-changed", on)

    def _chain(self, pad, buf: Buffer) -> FlowReturn:
        want = self.record
        if want and not self._recording:
            self._waiting_keyframe = True
            self._set_recording(True)
        elif not want and self._recording:
            self._segment_start = None
            self._set_recording(False)

        if not self._recording:
            return FlowReturn.OK
        if self._waiting_keyframe:
            if not buf.is_keyframe():
                return FlowReturn.OK
            self._waiting_keyframe = False
            if buf.pts is not None:
                self._offset = buf.pts - self._last_out_end
                self._segment_start = buf.pts
        out = buf.copy()
        if out.pts is not None:
            out.pts -= self._offset
            self._last_out_end = out.pts + (out.duration or 0)
        return self.srcpad.push(out)

    def _event(self, pad, ev: Event) -> bool:
        return self.srcpad.push_event(ev)
