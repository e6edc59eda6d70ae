"""sccparse / sccenc: Scenarist Closed Caption file format.

Rebuilds the reference's SCC elements (video/closedcaption
scc_parse/scc_enc): the text format is a "Scenarist_SCC V1.0" header
followed by `HH:MM:SS:FF<TAB>xxxx xxxx ...` lines of CEA-608 byte
pairs; ':' timecodes are non-drop 30 fps, ';' drop-frame 29.97.

The port's copy of gstpu/elements/video/scc.py, as it stands.
"""

from __future__ import annotations

import re

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000
CC_CAPS = Caps.new("closedcaption/x-cea-608", format="raw")
SCC_CAPS = Caps.new("application/x-scc")

_TC_RE = re.compile(r"^(\d{2}):(\d{2}):(\d{2})([:;])(\d{2})$")


def timecode_to_ns(tc: str) -> int:
    m = _TC_RE.match(tc)
    if not m:
        raise ValueError(f"bad SCC timecode {tc!r}")
    h, mi, s, sep, f = (int(m.group(1)), int(m.group(2)),
                        int(m.group(3)), m.group(4), int(m.group(5)))
    if sep == ";":
        # drop-frame 29.97: count frames with the drop pattern
        total_min = h * 60 + mi
        frames = ((h * 3600 + mi * 60 + s) * 30 + f
                  - 2 * (total_min - total_min // 10))
        return frames * SECOND * 1001 // 30000
    frames = (h * 3600 + mi * 60 + s) * 30 + f
    return frames * SECOND // 30


def ns_to_timecode(t: int) -> str:
    frames = t * 30 // SECOND
    f = frames % 30
    s = (frames // 30) % 60
    mi = (frames // 1800) % 60
    h = frames // 108000
    return f"{h:02d}:{mi:02d}:{s:02d}:{f:02d}"


@register_element("sccparse", Rank.PRIMARY)
class SccParse(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    SCC_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    CC_CAPS.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._acc = ""
        self._header_seen = False

    def transform_caps(self, direction, caps, filter):
        out = (CC_CAPS if direction is PadDirection.SINK
               else SCC_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        self._acc += buf.to_bytes().decode("utf-8", "replace")
        lines = self._acc.split("\n")
        self._acc = lines.pop()
        out = []
        for line in lines:
            out.extend(self._parse_line(line.strip()))
        return out or None

    def _parse_line(self, line: str) -> list[Buffer]:
        if not line:
            return []
        if not self._header_seen:
            if not line.startswith("Scenarist_SCC"):
                self.post_error(f"sccparse: bad header {line!r}")
                raise FlowError(FlowReturn.ERROR)
            self._header_seen = True
            return []
        if "\t" not in line and " " not in line:
            return []
        sep = "\t" if "\t" in line else " "
        tc, _, rest = line.partition(sep)
        pts = timecode_to_ns(tc.strip())
        field_dur = SECOND * 1001 // 30000
        out = []
        for i, word in enumerate(rest.split()):
            if len(word) != 4:
                continue
            pair = bytes.fromhex(word)
            out.append(Buffer(pair, pts=pts + i * field_dur,
                              duration=field_dur))
        return out

    def drain(self) -> list[Buffer]:
        if not self._acc.strip():
            return []
        out = self._parse_line(self._acc.strip())
        self._acc = ""
        return out


@register_element("sccenc", Rank.PRIMARY)
class SccEnc(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    CC_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    SCC_CAPS.copy()),
    ]

    # pairs closer together than this merge into one SCC line
    line_gap = Property(int, default=SECOND // 10, minimum=0,
                        mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._header_sent = False
        self._line_pts: int | None = None
        self._line_pairs: list[bytes] = []

    def transform_caps(self, direction, caps, filter):
        out = (SCC_CAPS if direction is PadDirection.SINK
               else CC_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def _flush_line(self) -> Buffer | None:
        if not self._line_pairs:
            return None
        words = " ".join(p.hex() for p in self._line_pairs)
        line = f"{ns_to_timecode(self._line_pts)}\t{words}\n\n"
        self._line_pairs = []
        self._line_pts = None
        return Buffer(line.encode())

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        out = []
        if not self._header_sent:
            out.append(Buffer(b"Scenarist_SCC V1.0\n\n"))
            self._header_sent = True
        pts = buf.pts or 0
        if self._line_pts is not None and \
                pts - self._line_pts > self.line_gap:
            flushed = self._flush_line()
            if flushed is not None:
                out.append(flushed)
        if self._line_pts is None:
            self._line_pts = pts
        self._line_pairs.append(buf.to_bytes()[:2])
        return out or None

    def drain(self) -> list[Buffer]:
        b = self._flush_line()
        return [b] if b is not None else []
