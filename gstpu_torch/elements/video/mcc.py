"""mccparse / mccenc: MacCaption (.mcc) ancillary-data transfer files.

Rebuilds the reference's MCC elements (video/closedcaption
mcc_parse/parser.rs, mcc_enc/imp.rs): the text format is a
"File Format=MacCaption_MCC V1.0/V2.0" preamble, UUID / Creation /
"Time Code Rate=NN[DF]" metadata, then `HH:MM:SS:FF<TAB><payload>`
caption lines.  The payload is hex pairs with single-letter aliases
for common runs (mcc_parse/parser.rs:124-210); decoded bytes are one
SMPTE 291 ANC packet: DID SDID DC data... checksum.  DID/SDID 0x61/
0x01 is a CEA-708 CDP, 0x61/0x02 raw CEA-608 (mcc_parse/imp.rs:38).

The port's copy of gstpu/elements/video/mcc.py, as it stands.
"""

from __future__ import annotations

import re
import uuid as _uuid

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.event import CapsEvent
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000

MCC_CAPS = Caps.new("application/x-mcc")
CDP_CAPS = Caps.new("closedcaption/x-cea-708", format="cdp")
C608_CAPS = Caps.new("closedcaption/x-cea-608", format="raw")

# alias -> expansion (mcc_parse/parser.rs:130-198); kept longest-first
# so the encoder's greedy match mirrors mcc_enc/imp.rs:163 exactly.
_ALIASES: list[tuple[str, bytes]] = (
    [(chr(ord("G") + n - 1), bytes([0xFA, 0x00, 0x00]) * n)
     for n in range(9, 0, -1)]        # O..G = 9..1 x FA0000
    + [("P", bytes([0xFB, 0x80, 0x80])),
       ("Q", bytes([0xFC, 0x80, 0x80])),
       ("R", bytes([0xFD, 0x80, 0x80])),
       ("U", bytes([0xE1, 0x00, 0x00, 0x00])),
       ("S", bytes([0x96, 0x69])),
       ("T", bytes([0x61, 0x01])),
       ("Z", bytes([0x00]))])
_DECODE = {c: b for c, b in _ALIASES}


def decode_mcc_payload(text: str) -> bytes:
    out = bytearray()
    i = 0
    while i < len(text):
        c = text[i]
        if c in _DECODE:
            out += _DECODE[c]
            i += 1
        else:
            out.append(int(text[i:i + 2], 16))
            i += 2
    return bytes(out)


def encode_mcc_payload(data: bytes) -> str:
    out = []
    i = 0
    while i < len(data):
        for c, pat in _ALIASES:
            if data.startswith(pat, i):
                out.append(c)
                i += len(pat)
                break
        else:
            out.append(f"{data[i]:02X}")
            i += 1
    return "".join(out)


_TC_RE = re.compile(r"^(\d{2}):(\d{2}):(\d{2})[:;.,](\d{2})(?:\.\d)?$")
_RATE_RE = re.compile(r"^Time Code Rate=(\d+)(DF)?", re.IGNORECASE)


def mcc_timecode_to_ns(tc: str, fps: int, drop: bool) -> int:
    m = _TC_RE.match(tc.strip())
    if not m:
        raise ValueError(f"bad MCC timecode {tc!r}")
    h, mi, s, f = (int(g) for g in m.groups())
    if drop:
        # 2 frames dropped per minute except every 10th (SMPTE DF),
        # scaled for 60DF (4 per minute)
        per_min = 2 * (fps // 30)
        total_min = h * 60 + mi
        frames = ((h * 3600 + mi * 60 + s) * fps + f
                  - per_min * (total_min - total_min // 10))
        return frames * SECOND * 1001 // (fps * 1000)
    frames = (h * 3600 + mi * 60 + s) * fps + f
    return frames * SECOND // fps


def ns_to_mcc_timecode(t: int, fps: int, drop: bool) -> str:
    if drop:
        # invert the DF mapping frame-count-first
        # round-half-up: pts values come from the floored frame->ns
        # mapping above, so flooring here would land one frame early
        frames = (t * fps * 1000 + (1001 * SECOND) // 2) \
            // (1001 * SECOND)
        per_min = 2 * (fps // 30)
        fpm = fps * 60
        # fixed-point search for the wall-clock minute this frame
        # count lands in, then re-add the dropped frame numbers
        total_min = 0
        while True:
            dropped = per_min * (total_min - total_min // 10)
            nxt = (frames + dropped) // fpm
            if nxt == total_min:
                break
            total_min = nxt
        frames += per_min * (total_min - total_min // 10)
        sep = ";"
    else:
        frames = (t * fps + SECOND // 2) // SECOND
        sep = ":"
    f = frames % fps
    s = (frames // fps) % 60
    mi = (frames // (fps * 60)) % 60
    h = frames // (fps * 3600)
    return f"{h:02d}:{mi:02d}:{s:02d}{sep}{f:02d}"


@register_element("mccparse", Rank.PRIMARY)
class MccParse(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    MCC_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps(list(CDP_CAPS) + list(C608_CAPS))),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._acc = ""
        self._header_seen = False
        self._fps = 30
        self._drop = False
        self._out_caps_sent = False

    def transform_caps(self, direction, caps, filter):
        out = (Caps(list(CDP_CAPS) + list(C608_CAPS))
               if direction is PadDirection.SINK else MCC_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        self._acc += buf.to_bytes().decode("utf-8", "replace")
        lines = self._acc.replace("\r\n", "\n").split("\n")
        self._acc = lines.pop()
        out = []
        for line in lines:
            out.extend(self._parse_line(line.rstrip()))
        return out or None

    def _parse_line(self, line: str) -> list[Buffer]:
        if not line or line.startswith("//"):
            return []
        if not self._header_seen:
            if not line.startswith("File Format=MacCaption_MCC"):
                self.post_error(f"mccparse: bad header {line!r}")
                raise FlowError(FlowReturn.ERROR)
            self._header_seen = True
            return []
        m = _RATE_RE.match(line)
        if m:
            self._fps = int(m.group(1))
            self._drop = m.group(2) is not None
            if self._drop:
                self._fps = {29: 30, 59: 60}.get(self._fps, self._fps)
            return []
        if "=" in line.split("\t")[0] and "\t" not in line:
            return []  # UUID= / Creation xx= metadata
        if "\t" not in line:
            return []
        tc, _, payload = line.partition("\t")
        try:
            data = decode_mcc_payload(payload.strip())
        except ValueError:
            self.post_error(f"mccparse: invalid payload item in "
                            f"{payload.strip()[:32]!r}")
            raise FlowError(FlowReturn.ERROR)
        if len(data) < 3:
            return []
        did, sdid, dc = data[0], data[1], data[2]
        if (did, sdid) not in ((0x61, 0x01), (0x61, 0x02)):
            return []  # unknown ANC service: skipped like imp.rs:417
        if not self._out_caps_sent:
            caps = CDP_CAPS if sdid == 0x01 else C608_CAPS
            self.srcpad.push_event(CapsEvent(caps.copy()))
            self._out_caps_sent = True
        pts = mcc_timecode_to_ns(tc, self._fps, self._drop)
        dur = SECOND * (1001 if self._drop else 1000) \
            // (self._fps * 1000)
        return [Buffer(data[3:3 + dc], pts=pts, duration=dur)]

    def drain(self) -> list[Buffer]:
        if not self._acc.strip():
            return []
        out = self._parse_line(self._acc.rstrip())
        self._acc = ""
        return out


@register_element("mccenc", Rank.PRIMARY)
class MccEnc(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps(list(CDP_CAPS) + list(C608_CAPS))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    MCC_CAPS.copy()),
    ]

    uuid = Property(str, default=None, mutable=Mutability.READY,
                    blurb="UUID for the output file (random if unset)")
    fps = Property(int, default=30, minimum=1,
                   mutable=Mutability.READY,
                   blurb="Time Code Rate (24/25/30/50/60)")
    drop_frame = Property(bool, default=False,
                          mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._header_sent = False
        self._is_608 = False

    def transform_caps(self, direction, caps, filter):
        out = (MCC_CAPS.copy() if direction is PadDirection.SINK
               else Caps(list(CDP_CAPS) + list(C608_CAPS)))
        if filter is not None:
            out = filter.intersect(out)
        return out

    def set_caps(self, incaps, outcaps) -> bool:
        self._is_608 = incaps[0].name == "closedcaption/x-cea-608"
        return True

    def _headers(self) -> bytes:
        uid = self.uuid or str(_uuid.uuid4()).upper()
        rate = (f"{self.fps}DF" if self.drop_frame else f"{self.fps}")
        lines = ["File Format=MacCaption_MCC V1.0", "",
                 f"UUID={uid}",
                 "Creation Program=gstpu",
                 f"Time Code Rate={rate}", ""]
        return ("\r\n".join(lines) + "\r\n").encode()

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        out = []
        if not self._header_sent:
            out.append(Buffer(self._headers()))
            self._header_sent = True
        data = buf.to_bytes()
        if len(data) >= 256:
            self.post_error(f"mccenc: too big buffer: {len(data)}")
            raise FlowError(FlowReturn.ERROR)
        tc = ns_to_mcc_timecode(buf.pts or 0, self.fps, self.drop_frame)
        # DID/SDID/DC prefix; 608 written as plain hex like
        # mcc_enc/imp.rs:355 ("6102{len}"), CDP via the T alias
        prefix = (f"6102{len(data):02X}" if self._is_608
                  else f"T{len(data):02X}")
        # checksum over the payload bytes only, matching
        # mcc_enc/imp.rs:364 (DID/SDID/DC are not summed there)
        csum = sum(data) & 0xFF
        tail = "Z" if csum == 0 else f"{csum:02X}"
        line = f"{tc}\t{prefix}{encode_mcc_payload(data)}{tail}\r\n"
        out.append(Buffer(line.encode()))
        return out
