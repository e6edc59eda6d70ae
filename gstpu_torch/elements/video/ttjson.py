"""cea608tojson / jsontovtt: caption JSON interchange.

Rebuilds the reference's JSON caption path (video/closedcaption/src/
cea608tojson/imp.rs, jsontovtt/imp.rs, schema in ttutils.rs): CEA-608
pairs decode to `{"lines": [{"chunks": [{"style", "underline",
"text"}], ...}], "mode", "clear"}` documents on application/x-json
caps; jsontovtt turns those timed documents into WebVTT cues.

The port's copy of gstpu/elements/video/ttjson.py, as it stands.
"""

from __future__ import annotations

import json

from gstpu_torch.codecs.cea608 import Cea608Decoder
from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000

C608_CAPS = Caps.new("closedcaption/x-cea-608", format="raw")
JSON_CAPS = Caps.new("application/x-json", format="cea608")
VTT_CAPS = Caps.new("text/vtt")


def lines_to_json(text: str, *, mode: str = "PopOn",
                  clear: bool | None = None) -> bytes:
    doc = {"lines": [{"column": None, "row": None,
                      "chunks": [{"style": "White", "underline": False,
                                  "text": ln}],
                      "carriage_return": None}
                     for ln in text.split("\n") if ln],
           "mode": mode, "clear": clear}
    return json.dumps(doc).encode()


@register_element("cea608tojson", Rank.NONE)
class Cea608ToJson(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    C608_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    JSON_CAPS.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._dec = Cea608Decoder()

    def transform_caps(self, direction, caps, filter):
        out = (JSON_CAPS if direction is PadDirection.SINK
               else C608_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        out = []
        data = buf.to_bytes()
        for i in range(0, len(data) - 1, 2):
            text = self._dec.push_pair(data[i:i + 2])
            if text:
                out.append(Buffer(lines_to_json(text), pts=buf.pts,
                                  duration=buf.duration))
        return out or None


@register_element("jsontovtt", Rank.NONE)
class JsonToVtt(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    JSON_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    VTT_CAPS.copy()),
    ]

    # a cue with no successor ends after this much time
    default_duration = Property(int, default=2 * SECOND, minimum=1,
                                mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._header_sent = False
        self._open: tuple[int, str] | None = None   # (pts, text)

    def transform_caps(self, direction, caps, filter):
        out = (VTT_CAPS if direction is PadDirection.SINK
               else JSON_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    @staticmethod
    def _ts(t: int) -> str:
        ms = t // 1_000_000
        return (f"{ms // 3600000:02d}:{ms // 60000 % 60:02d}:"
                f"{ms // 1000 % 60:02d}.{ms % 1000:03d}")

    def _cue(self, start: int, end: int, text: str) -> Buffer:
        s = f"{self._ts(start)} --> {self._ts(end)}\n{text}\n\n"
        return Buffer(s.encode(), pts=start, duration=end - start)

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        out = []
        if not self._header_sent:
            out.append(Buffer(b"WEBVTT\n\n", pts=buf.pts))
            self._header_sent = True
        doc = json.loads(buf.to_bytes().decode())
        text = "\n".join("".join(c["text"] for c in ln["chunks"])
                         for ln in doc.get("lines", []))
        pts = buf.pts or 0
        if self._open is not None:
            start, prev = self._open
            out.append(self._cue(start, pts, prev))
            self._open = None
        if text and not doc.get("clear"):
            self._open = (pts, text)
        return out or None

    def drain(self) -> list[Buffer]:
        if self._open is None:
            return []
        start, text = self._open
        self._open = None
        return [self._cue(start, start + self.default_duration, text)]


@register_element("tttojson", Rank.NONE)
class TtToJson(BaseTransform):
    """Timed text -> Lines JSON documents (reference tttojson uses
    the same ttutils schema as cea608tojson)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("text/x-raw", format="utf8")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    JSON_CAPS.copy()),
    ]

    mode = Property(str, default="RollUp2",
                    enum_values=("PopOn", "PaintOn", "RollUp2",
                                 "RollUp3", "RollUp4"),
                    mutable=Mutability.READY)

    def transform_caps(self, direction, caps, filter):
        out = (JSON_CAPS if direction is PadDirection.SINK
               else Caps.new("text/x-raw", format="utf8")).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> Buffer:
        text = buf.to_bytes().decode("utf-8", "replace")
        return Buffer(lines_to_json(text, mode=self.mode),
                      pts=buf.pts, duration=buf.duration)
