"""regex, textwrap, jsongstenc/jsongstparse, textaccumulate, textahead
(reference text/regex, text/wrap, text/json, text/accumulate,
text/ahead).

The port's copy of gstpu/elements/text/textelements.py, as it stands.
"""

from __future__ import annotations

import json
import re
import textwrap as _tw

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer, Meta
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowReturn, PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.event import Event, GapEvent
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000

TEXT_CAPS = Caps.new("text/x-raw", format="utf8")
JSON_CAPS = Caps.new("application/x-json")


def _tmpl(name, d, caps):
    return PadTemplate(name, d, PadPresence.ALWAYS, caps.copy())


@register_element("regex", Rank.NONE)
class RegexElement(BaseTransform):
    """Regex replacement on utf8 text buffers (reference text/regex).
    `commands` is a list of dicts {"operation": "replace-all",
    "pattern": ..., "replacement": ...}."""

    IN_PLACE = True
    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK, TEXT_CAPS),
                     _tmpl("src", PadDirection.SRC, TEXT_CAPS)]

    commands = Property(list, default=None, mutable=Mutability.PLAYING)

    def transform_ip(self, buf: Buffer) -> None:
        text = buf.to_bytes().decode("utf-8")
        for cmd in (self.commands or []):
            op = cmd.get("operation", "replace-all")
            pat = cmd.get("pattern", "")
            if op == "replace-all":
                text = re.sub(pat, cmd.get("replacement", ""), text)
        buf.data = text.encode("utf-8")


@register_element("textwrap", Rank.NONE)
class TextWrap(BaseTransform):
    """Line wrapping (reference text/wrap: wrap/hyphenation)."""

    IN_PLACE = True
    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK, TEXT_CAPS),
                     _tmpl("src", PadDirection.SRC, TEXT_CAPS)]

    columns = Property(int, default=32, minimum=1,
                       mutable=Mutability.PLAYING)
    lines = Property(int, default=0, minimum=0,
                     mutable=Mutability.PLAYING,
                     blurb="Split output every N lines (0 = one buffer)")

    def transform_ip(self, buf: Buffer) -> Buffer | None:
        text = buf.to_bytes().decode("utf-8")
        wrapped = _tw.fill(text, width=self.columns)
        if self.lines > 0:
            all_lines = wrapped.splitlines()
            chunks = ["\n".join(all_lines[i:i + self.lines])
                      for i in range(0, len(all_lines), self.lines)]
            n = max(len(chunks), 1)
            out = []
            dur = (buf.duration // n) if buf.duration else None
            for i, c in enumerate(chunks):
                pts = None if buf.pts is None else buf.pts + i * (dur or 0)
                out.append(Buffer(c.encode(), pts=pts, duration=dur))
            return out  # type: ignore[return-value]
        buf.data = wrapped.encode("utf-8")
        return None


@register_element("jsongstenc", Rank.NONE)
class JsonGstEnc(BaseTransform):
    """Wraps timed buffers into newline-delimited JSON records
    (reference text/json jsongstenc)."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK, TEXT_CAPS),
                     _tmpl("src", PadDirection.SRC, JSON_CAPS)]

    def transform_caps(self, direction, caps, filter):
        out = (JSON_CAPS if direction is PadDirection.SINK
               else TEXT_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> Buffer:
        rec = {"pts": buf.pts, "duration": buf.duration,
               "lines": buf.to_bytes().decode("utf-8").splitlines()}
        return Buffer((json.dumps(rec) + "\n").encode(), pts=buf.pts,
                      duration=buf.duration)


@register_element("jsongstparse", Rank.NONE)
class JsonGstParse(BaseTransform):
    """Parses ndjson records back into timed text buffers."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK, JSON_CAPS),
                     _tmpl("src", PadDirection.SRC, TEXT_CAPS)]

    def transform_caps(self, direction, caps, filter):
        out = (TEXT_CAPS if direction is PadDirection.SINK
               else JSON_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def __init__(self, name=None):
        super().__init__(name)
        self._partial = b""

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        data = self._partial + buf.to_bytes()
        lines = data.split(b"\n")
        self._partial = lines.pop()
        out = []
        for line in lines:
            if not line.strip():
                continue
            rec = json.loads(line)
            out.append(Buffer("\n".join(rec["lines"]).encode(),
                              pts=rec.get("pts"),
                              duration=rec.get("duration")))
        return out or None


class TextAccumulateSentenceMeta(Meta):
    """Marks buffers completing a sentence (reference
    text/accumulate/src/lib.rs:26)."""

    def __init__(self, complete: bool):
        self.complete = complete


@register_element("textaccumulate", Rank.NONE)
class TextAccumulate(BaseTransform):
    """Rolling accumulation of partial text (captioning UX, reference
    text/accumulate): emits the growing line, restarting after
    sentence-final punctuation."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK, TEXT_CAPS),
                     _tmpl("src", PadDirection.SRC, TEXT_CAPS)]

    drain_on_final_punctuation = Property(bool, default=True,
                                          mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self._acc: list[str] = []

    def transform(self, buf: Buffer) -> Buffer:
        text = buf.to_bytes().decode("utf-8").strip()
        self._acc.append(text)
        joined = " ".join(t for t in self._acc if t)
        complete = bool(re.search(r"[.!?]\s*$", joined))
        out = Buffer(joined.encode(), pts=buf.pts, duration=buf.duration)
        out.add_meta(TextAccumulateSentenceMeta(complete))
        if complete and self.drain_on_final_punctuation:
            self._acc = []
        return out

    def flush(self) -> None:
        self._acc = []


@register_element("textahead", Rank.NONE)
class TextAhead(BaseTransform):
    """Shows current + upcoming text buffers (karaoke lookahead,
    reference text/ahead). Delays output by `n-ahead` buffers."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK, TEXT_CAPS),
                     _tmpl("src", PadDirection.SRC, TEXT_CAPS)]

    n_ahead = Property(int, default=1, minimum=0,
                       mutable=Mutability.READY)
    separator = Property(str, default="\n", mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self._window: list[Buffer] = []

    def transform(self, buf: Buffer) -> Buffer | None:
        self._window.append(buf)
        if len(self._window) < self.n_ahead + 1:
            return None
        cur = self._window.pop(0)
        texts = [cur.to_bytes().decode("utf-8")] + \
            [b.to_bytes().decode("utf-8") for b in self._window]
        return Buffer(self.separator.join(texts).encode(),
                      pts=cur.pts, duration=cur.duration)

    def drain(self) -> list[Buffer]:
        out = []
        while self._window:
            cur = self._window.pop(0)
            texts = [cur.to_bytes().decode("utf-8")] + \
                [b.to_bytes().decode("utf-8") for b in self._window]
            out.append(Buffer(self.separator.join(texts).encode(),
                              pts=cur.pts, duration=cur.duration))
        return out
