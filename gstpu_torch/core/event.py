"""Events: serialized in-band control flow, and the Segment.

Rebuilds the event set every reference element handles
(SURVEY.md §2.1; e.g. audio/audiofx/src/audioloudnorm/imp.rs:1588-1695
sink_event handling of Caps/Eos/FlushStop/Segment).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any

from gstpu_torch.core.caps import Caps

_seq = itertools.count(1)


@dataclass
class Segment:
    """Playback segment: maps buffer timestamps to running time."""

    fmt: str = "time"
    rate: float = 1.0
    start: int = 0
    stop: int | None = None
    time: int = 0
    base: int = 0
    position: int = 0

    def to_running_time(self, ts: int | None) -> int | None:
        if ts is None:
            return None
        if self.stop is not None and ts > self.stop:
            ts = self.stop
        if ts < self.start:
            return None
        return self.base + int((ts - self.start) / abs(self.rate))

    def copy(self) -> "Segment":
        return Segment(self.fmt, self.rate, self.start, self.stop,
                       self.time, self.base, self.position)


class Event:
    """Base event. `serialized` events travel with the data stream."""

    serialized = True
    sticky = False

    def __init__(self):
        self.seqnum = next(_seq)

    def __repr__(self):
        return f"<{type(self).__name__} seq={self.seqnum}>"


class StreamStartEvent(Event):
    sticky = True

    def __init__(self, stream_id: str, group_id: int | None = None):
        super().__init__()
        self.stream_id = stream_id
        self.group_id = group_id


class CapsEvent(Event):
    sticky = True

    def __init__(self, caps: Caps):
        super().__init__()
        if not caps.is_fixed():
            raise ValueError(f"caps event needs fixed caps, got {caps!r}")
        self.caps = caps

    def __repr__(self):
        return f"<CapsEvent {self.caps!r}>"


class SegmentEvent(Event):
    sticky = True

    def __init__(self, segment: Segment):
        super().__init__()
        self.segment = segment


class EosEvent(Event):
    sticky = True


class GapEvent(Event):
    """Announces a timestamp range with no data
    (reference livesync consumes/produces these)."""

    def __init__(self, pts: int, duration: int | None = None):
        super().__init__()
        self.pts = pts
        self.duration = duration


class FlushStartEvent(Event):
    serialized = False


class FlushStopEvent(Event):
    def __init__(self, reset_time: bool = True):
        super().__init__()
        self.reset_time = reset_time


class TagEvent(Event):
    sticky = True

    def __init__(self, tags: dict[str, Any]):
        super().__init__()
        self.tags = dict(tags)


@dataclass
class _CustomPayload:
    name: str
    fields: dict[str, Any] = field(default_factory=dict)


class CustomEvent(Event):
    """Application/element-defined event (GstStructure payload)."""

    def __init__(self, name: str, serialized: bool = True, **fields: Any):
        super().__init__()
        self.name = name
        self.serialized = serialized
        self.fields = fields


class NavigationEvent(Event):
    """Upstream navigation event (GstNavigation): user input (mouse/
    key) travelling from a consumer/sink back toward the producing
    source.  `structure` carries the GstNavigation fields (event,
    x, y, button, key, delta_x, delta_y, modifier_state, ...).
    Reference: webrtcsink's enable-data-channel-navigation turns
    consumer input-channel messages into these
    (net/webrtc/src/webrtcsink/imp.rs:433-471)."""

    serialized = False

    def __init__(self, **structure: Any):
        super().__init__()
        self.structure = structure

    @property
    def nav_type(self) -> str | None:
        return self.structure.get("event")

    def __repr__(self):
        return (f"<NavigationEvent {self.structure.get('event')} "
                f"seq={self.seqnum}>")


class LatencyEvent(Event):
    """Upstream latency configuration event."""

    serialized = False

    def __init__(self, latency: int):
        super().__init__()
        self.latency = latency


class QosEvent(Event):
    serialized = False

    def __init__(self, proportion: float, diff: int, timestamp: int):
        super().__init__()
        self.proportion = proportion
        self.diff = diff
        self.timestamp = timestamp


class SeekEvent(Event):
    serialized = False

    def __init__(self, rate: float = 1.0, start: int = 0,
                 stop: int | None = None, flush: bool = True):
        super().__init__()
        self.rate = rate
        self.start = start
        self.stop = stop
        self.flush = flush
