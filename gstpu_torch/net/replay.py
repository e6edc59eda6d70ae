"""Sliding anti-replay window (RFC 3711 §3.3.2 / RFC 4303 §3.4.3).

A bitmask of `size` indices below the highest authenticated index.
Shared by the SRTP/SRTCP contexts (per-SSRC / per-session) and the
DTLS record layer (per-epoch) — replaces the clear()-when-full sets
that periodically re-enabled replay of every previously seen index.

Call ``is_replay(idx)`` before the (cheap-reject) auth check and
``accept(idx)`` only after authentication succeeds, so a forged
packet can never block the genuine one.

The port's copy of gstpu/net/replay.py, as it stands.
"""

from __future__ import annotations


class ReplayWindow:
    def __init__(self, size: int = 128):
        self.size = size
        self.highest = -1          # highest accepted index
        self._mask = 0             # bit d set = (highest - d) seen

    def is_replay(self, idx: int) -> bool:
        if idx > self.highest:
            return False
        d = self.highest - idx
        if d >= self.size:
            return True            # older than the window: reject
        return bool(self._mask >> d & 1)

    def accept(self, idx: int) -> None:
        if idx > self.highest:
            shift = idx - self.highest
            self._mask = ((self._mask << min(shift, self.size)) | 1) \
                & ((1 << self.size) - 1)
            self.highest = idx
        else:
            d = self.highest - idx
            if d < self.size:
                self._mask |= 1 << d
