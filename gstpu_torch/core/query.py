"""Queries: synchronous introspection flowing against/with dataflow.

Rebuilds the query surface the reference's elements answer — latency
(audio/audiofx/src/audiornnoise/imp.rs:362-380 adds its block latency),
caps, position/duration, scheduling.
"""

from __future__ import annotations

from typing import Any

from gstpu_torch.core.caps import Caps


class Query:
    """Base query; handlers fill in result fields and return True."""

    def __repr__(self):
        return f"<{type(self).__name__} {self.__dict__}>"


class LatencyQuery(Query):
    def __init__(self):
        self.live = False
        self.min_latency = 0
        self.max_latency: int | None = None

    def add(self, min_inc: int, max_inc: int | None = 0) -> None:
        """Accumulate this element's latency contribution."""
        self.min_latency += min_inc
        if self.max_latency is not None:
            self.max_latency = (None if max_inc is None
                                else self.max_latency + max_inc)


class PositionQuery(Query):
    def __init__(self, fmt: str = "time"):
        self.fmt = fmt
        self.position: int | None = None


class DurationQuery(Query):
    def __init__(self, fmt: str = "time"):
        self.fmt = fmt
        self.duration: int | None = None


class CapsQuery(Query):
    def __init__(self, filter: Caps | None = None):
        self.filter = filter
        self.caps: Caps | None = None


class AcceptCapsQuery(Query):
    def __init__(self, caps: Caps):
        self.caps = caps
        self.accepted = False


class SchedulingQuery(Query):
    def __init__(self):
        self.modes: list[str] = ["push"]
        self.seekable = False


class SeekingQuery(Query):
    def __init__(self, fmt: str = "time"):
        self.fmt = fmt
        self.seekable = False
        self.start: int = 0
        self.stop: int | None = None


class CustomQuery(Query):
    def __init__(self, name: str, **fields: Any):
        self.name = name
        self.fields = fields
        self.result: Any = None
