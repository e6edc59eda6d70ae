"""Buffer: the unit of dataflow.

Rebuilds GstBuffer as used throughout the reference (SURVEY.md §2.1):
timestamped payload (PTS/DTS/duration in ns), flags, and an open-ended
meta list (the extension point behind FMP4KeyframeMeta, NetAddressMeta,
OnvifXMLFrameMeta etc., reference mux/isobmff/src/isobmff/mod.rs:122-124,
generic/threadshare/src/udpsrc/imp.rs:642).

The payload may live on the host (bytes / numpy array) or be a torch
tensor on any device. `Buffer.array` exposes a zero-copy numpy view
where possible — the analogue of the reference's buf.map_readable()/
map_writable() (audio/audiofx/src/audioecho/imp.rs:212); a device
tensor is downloaded explicitly.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch


class BufferFlags(enum.IntFlag):
    NONE = 0
    LIVE = 1 << 4
    DECODE_ONLY = 1 << 5
    DISCONT = 1 << 6
    RESYNC = 1 << 7
    CORRUPTED = 1 << 8
    MARKER = 1 << 9
    HEADER = 1 << 10
    GAP = 1 << 11
    DROPPABLE = 1 << 12
    DELTA_UNIT = 1 << 13  # not a keyframe (reference gopbuffer keys on this)
    TAG_MEMORY = 1 << 14
    SYNC_AFTER = 1 << 15


@dataclass
class Meta:
    """Base class for buffer metadata; subclass per meta type."""

    def copy(self) -> "Meta":
        return self


@dataclass
class ReferenceTimestampMeta(Meta):
    reference: str = ""
    timestamp: int | None = None
    duration: int | None = None


@dataclass
class NetAddressMeta(Meta):
    """Sender address on buffers from network sources
    (reference generic/threadshare/src/udpsrc/imp.rs:642)."""
    addr: tuple[str, int] = ("", 0)


@dataclass
class VideoTimeCodeMeta(Meta):
    """SMPTE timecode attached to a video frame (reference
    GstVideoTimeCodeMeta; webrtcsink forward-metas serializes it over
    the control data channel, net/webrtc/src/utils.rs:1419-1430)."""
    hours: int = 0
    minutes: int = 0
    seconds: int = 0
    frames: int = 0
    fps: tuple = (30, 1)
    drop_frame: bool = False
    field_count: int = 0
    latest_daily_jam: str | None = None    # ISO 8601 or None

    def time_since_daily_jam(self) -> int:
        """ns since the daily jam (dedup key, like the reference's
        VideoTimeCode::time_since_daily_jam)."""
        n, d = self.fps
        frames = ((self.hours * 60 + self.minutes) * 60
                  + self.seconds) * n // d + self.frames
        return frames * 1_000_000_000 * d // max(n, 1)


@dataclass
class OriginalBufferMeta(Meta):
    """Stashes the pre-transform buffer so it can be restored later
    (reference generic/originalbuffer/src/originalbuffermeta.rs)."""
    original: "Buffer | None" = None
    caps: Any = None


class Buffer:
    """Refcount-free (GC'd) buffer with timestamps, flags and metas."""

    __slots__ = ("data", "pts", "dts", "duration", "offset", "offset_end",
                 "flags", "metas")

    def __init__(self, data: Any = b"", *, pts: int | None = None,
                 dts: int | None = None, duration: int | None = None,
                 offset: int | None = None, offset_end: int | None = None,
                 flags: BufferFlags = BufferFlags.NONE,
                 metas: list[Meta] | None = None):
        self.data = data
        self.pts = pts
        self.dts = dts
        self.duration = duration
        self.offset = offset
        self.offset_end = offset_end
        self.flags = flags
        self.metas = metas if metas is not None else []

    # -- payload access ------------------------------------------------
    @property
    def array(self) -> np.ndarray:
        """Zero-copy numpy view of the payload (device tensors are
        downloaded)."""
        d = self.data
        if isinstance(d, np.ndarray):
            return d
        if isinstance(d, (bytes, bytearray, memoryview)):
            return np.frombuffer(d, dtype=np.uint8)
        if isinstance(d, torch.Tensor):
            return d.detach().cpu().numpy()
        return np.asarray(d)

    @property
    def size(self) -> int:
        d = self.data
        if isinstance(d, (bytes, bytearray, memoryview)):
            return len(d)
        # tensors expose nbytes without a transfer — np.asarray here
        # would download the payload just to size it
        nbytes = getattr(d, "nbytes", None)
        if nbytes is not None:
            return int(nbytes)
        return int(np.asarray(d).nbytes) if d is not None else 0

    def to_bytes(self) -> bytes:
        d = self.data
        if isinstance(d, bytes):
            return d
        if isinstance(d, (bytearray, memoryview)):
            return bytes(d)
        return self.array.tobytes()

    # -- flags ----------------------------------------------------------
    def has_flag(self, f: BufferFlags) -> bool:
        return bool(self.flags & f)

    def set_flag(self, f: BufferFlags) -> None:
        self.flags |= f

    def unset_flag(self, f: BufferFlags) -> None:
        self.flags &= ~f

    def is_keyframe(self) -> bool:
        return not self.has_flag(BufferFlags.DELTA_UNIT)

    # -- metas ----------------------------------------------------------
    def add_meta(self, m: Meta) -> None:
        self.metas.append(m)

    def get_meta(self, cls: type) -> Meta | None:
        for m in self.metas:
            if isinstance(m, cls):
                return m
        return None

    def iter_meta(self, cls: type):
        for m in self.metas:
            if isinstance(m, cls):
                yield m

    def copy(self, deep: bool = False) -> "Buffer":
        data = self.data
        if deep and isinstance(data, np.ndarray):
            data = data.copy()
        elif deep and isinstance(data, torch.Tensor):
            data = data.clone()
        elif deep and isinstance(data, (bytearray, memoryview)):
            data = bytes(data)
        return Buffer(data, pts=self.pts, dts=self.dts,
                      duration=self.duration, offset=self.offset,
                      offset_end=self.offset_end, flags=self.flags,
                      metas=[m.copy() for m in self.metas])

    def __repr__(self):
        from gstpu_torch.core.clock import format_time
        return (f"<Buffer {self.size}B pts={format_time(self.pts)} "
                f"dur={format_time(self.duration)} flags={self.flags!r}>")


@dataclass
class BufferList:
    """Ordered group of buffers pushed as one unit
    (reference fmp4mux pushes header+data as BufferList,
    mux/isobmff/src/isobmff/fmp4mux/imp.rs:4050)."""

    buffers: list[Buffer] = field(default_factory=list)

    def __iter__(self):
        return iter(self.buffers)

    def __len__(self):
        return len(self.buffers)
