"""Adapter: re-block arbitrary input buffers into kernel-native sizes.

Rebuilds gst_base::UniqueAdapter usage (reference
audio/audiofx/src/audiornnoise/imp.rs:99-101 and §5.7: every windowed
DSP element re-blocks input to its fixed frame size). The port's copy
of gstpu/core/adapter.py: the host audioloudnorm re-blocks its input
into 100 ms frames with it.

Two flavors: ByteAdapter (raw bytes) and SampleAdapter (ndarray rows,
e.g. audio frames), both tracking the PTS of the front of the queue.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class ByteAdapter:
    def __init__(self):
        self._chunks: deque[bytes] = deque()
        self._size = 0
        self.pts: int | None = None
        self._front_offset = 0

    def push(self, data: bytes, pts: int | None = None) -> None:
        if pts is not None and self._size == 0:
            self.pts = pts
            self._front_offset = 0
        self._chunks.append(bytes(data))
        self._size += len(data)

    def available(self) -> int:
        return self._size

    def peek(self, n: int) -> bytes:
        if n > self._size:
            raise ValueError("not enough data")
        out, need = [], n
        for c in self._chunks:
            take = min(len(c), need)
            out.append(c[:take])
            need -= take
            if need == 0:
                break
        return b"".join(out)

    def take(self, n: int) -> bytes:
        out = self.peek(n)
        self.flush(n)
        return out

    def flush(self, n: int) -> None:
        if n > self._size:
            raise ValueError("not enough data")
        self._size -= n
        while n:
            c = self._chunks[0]
            if len(c) <= n:
                n -= len(c)
                self._chunks.popleft()
            else:
                self._chunks[0] = c[n:]
                n = 0

    def clear(self) -> None:
        self._chunks.clear()
        self._size = 0
        self.pts = None


class SampleAdapter:
    """Queue of (frames, channels) float blocks with frame-accurate PTS.

    pts tracks the timestamp of the first queued frame, advanced by
    rate when frames are taken.
    """

    def __init__(self, rate: int):
        self.rate = rate
        self._chunks: deque[np.ndarray] = deque()
        self._frames = 0
        self.pts: int | None = None
        self._consumed_frames = 0
        self._base_pts: int | None = None

    def push(self, samples: np.ndarray, pts: int | None = None) -> None:
        if self._frames == 0 and pts is not None:
            self._base_pts = pts
            self._consumed_frames = 0
            self.pts = pts
        self._chunks.append(samples)
        self._frames += samples.shape[0]

    def available(self) -> int:
        return self._frames

    def take(self, n: int) -> np.ndarray:
        if n > self._frames:
            raise ValueError(f"need {n} frames, have {self._frames}")
        parts, need = [], n
        while need:
            c = self._chunks[0]
            if c.shape[0] <= need:
                parts.append(c)
                need -= c.shape[0]
                self._chunks.popleft()
            else:
                parts.append(c[:need])
                self._chunks[0] = c[need:]
                need = 0
        self._frames -= n
        self._consumed_frames += n
        if self._base_pts is not None:
            self.pts = self._base_pts + (self._consumed_frames
                                         * 1_000_000_000) // self.rate
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def take_pts(self, n: int) -> tuple[np.ndarray, int | None, int]:
        """Take n frames, returning (samples, pts_of_block, duration)."""
        pts = self.pts
        out = self.take(n)
        dur = (n * 1_000_000_000) // self.rate
        return out, pts, dur

    def clear(self) -> None:
        self._chunks.clear()
        self._frames = 0
        self.pts = None
        self._base_pts = None
