"""gst-launch pipeline description parser.

Rebuilds gst::parse::launch (used pervasively by reference tests, e.g.
audio/audiofx/tests/audioloudnorm.rs:41-58) over our registry:

    parse_launch("audiotestsrc num-buffers=10 ! rsaudioecho delay=250000000 "
                 "! appsink name=sink")

Supports: `elem prop=val ... ! elem2`, caps filters between elements
("audio/x-raw, rate=48000" inserts a capsfilter), element naming
(`name=x`) and branch references (`x. ! elem`), quoted values.
"""

from __future__ import annotations

import re
import shlex
from fractions import Fraction

from gstpu_torch.core.bin import Pipeline
from gstpu_torch.core.caps import Caps, parse_caps
from gstpu_torch.core.element import Element
from gstpu_torch.core.registry import make


def _parse_prop_value(v: str):
    if re.fullmatch(r"-?\d+", v):
        return int(v)
    if re.fullmatch(r"-?\d+\.\d*([eE]-?\d+)?", v):
        return float(v)
    if re.fullmatch(r"-?\d+/\d+", v):
        n, d = v.split("/")
        return Fraction(int(n), int(d))
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _split_toplevel(s: str) -> list[str]:
    """Split on '!' at top level (not inside quotes)."""
    parts, cur, q = [], [], None
    for ch in s:
        if q:
            cur.append(ch)
            if ch == q:
                q = None
        elif ch in "\"'":
            q = ch
            cur.append(ch)
        elif ch == "!":
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur).strip())
    return [p for p in parts if p]


_CAPS_HINT = re.compile(r"^[a-zA-Z0-9-]+/[a-zA-Z0-9+.-]+")


def parse_launch(description: str, pipeline: Pipeline | None = None) -> Pipeline:
    pipeline = pipeline or Pipeline()
    named: dict[str, Element] = {el.name: el
                                 for el in pipeline.iterate_elements()}
    last: Element | None = None

    segments = _split_toplevel(description)
    pending_caps: Caps | None = None
    for seg in segments:
        # branch reference "name."
        m = re.fullmatch(r"([A-Za-z_][\w-]*)\.\s*", seg)
        if m:
            name = m.group(1)
            if name not in named:
                raise ValueError(f"parse: unknown element reference {name!r}")
            last = named[name]
            continue
        # caps filter segment
        if _CAPS_HINT.match(seg) and "=" not in seg.split(",")[0]:
            pending_caps = parse_caps(seg)
            cf = make("capsfilter")
            cf.set_property("caps", pending_caps)
            pipeline.add(cf)
            if last is not None:
                last.link(cf)
            last = cf
            pending_caps = None
            continue
        # element [prop=value ...]
        try:
            tokens = shlex.split(seg)
        except ValueError as e:
            raise ValueError(f"parse error in {seg!r}: {e}")
        if not tokens:
            continue
        factory = tokens[0]
        el_name = None
        props = {}
        for tok in tokens[1:]:
            if "=" not in tok:
                raise ValueError(f"parse: expected prop=value, got {tok!r}")
            k, v = tok.split("=", 1)
            if k == "name":
                el_name = v
            elif k == "caps":
                props[k] = parse_caps(v.strip('"'))
            else:
                props[k] = _parse_prop_value(v)
        el = make(factory, element_name=el_name)
        for k, v in props.items():
            el.set_property(k, v)
        pipeline.add(el)
        named[el.name] = el
        if last is not None:
            last.link(el)
        last = el
    return pipeline
