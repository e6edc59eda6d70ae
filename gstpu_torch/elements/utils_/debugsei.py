"""debugseimetainserter: injects debug payloads as H.26x unregistered
SEI NALs (reference utils/debugseimetainserter).

The port's copy of gstpu/elements/utils_/debugsei.py: host code.
"""

from __future__ import annotations

import uuid as _uuid

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps, Structure
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

DEFAULT_UUID = _uuid.UUID("dbe0cae2-1f11-47b1-8f3e-9f7d3290e967")


def _emulation_prevent(data: bytes) -> bytes:
    """Insert 0x03 after any 00 00 before 00/01/02/03 (Annex-B)."""
    out = bytearray()
    zeros = 0
    for b in data:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def build_sei_unregistered(payload: bytes, h265: bool = False,
                           uid: bytes = DEFAULT_UUID.bytes) -> bytes:
    """Annex-B SEI NAL with one user_data_unregistered message."""
    body = uid + payload
    msg = bytes([5])                       # payloadType 5
    n = len(body)
    while n >= 255:
        msg += bytes([255])
        n -= 255
    msg += bytes([n]) + body + b"\x80"     # rbsp trailing bits
    if h265:
        header = bytes([0x4E, 0x01])       # PREFIX_SEI, layer0, tid1
    else:
        header = bytes([0x06])             # nal_unit_type 6
    return b"\x00\x00\x00\x01" + header + _emulation_prevent(msg)


def parse_sei_unregistered(nal_stream: bytes) -> list[bytes]:
    """Extract user_data_unregistered payloads from Annex-B data
    (for tests/inspection; skips emulation prevention)."""
    out = []
    i = 0
    data = nal_stream
    while True:
        idx = data.find(b"\x00\x00\x01", i)
        if idx < 0:
            break
        start = idx + 3
        end = data.find(b"\x00\x00\x01", start)
        end = len(data) if end < 0 else (end - 1 if data[end - 1] == 0
                                         else end)
        nal = data[start:end]
        i = start
        if not nal:
            continue
        t264 = nal[0] & 0x1F
        t265 = (nal[0] >> 1) & 0x3F
        if t264 == 6:
            rbsp, off = _strip_emulation(nal[1:]), 0
        elif t265 == 39:
            rbsp, off = _strip_emulation(nal[2:]), 0
        else:
            continue
        if len(rbsp) < 2 or rbsp[0] != 5:
            continue
        off = 1
        size = 0
        while off < len(rbsp) and rbsp[off] == 255:
            size += 255
            off += 1
        size += rbsp[off]
        off += 1
        body = rbsp[off:off + size]
        if len(body) >= 16:
            out.append(body[16:])  # strip uuid
    return out


def _strip_emulation(data: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(data):
        b = data[i]
        if zeros >= 2 and b == 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


_H26X_CAPS = Caps([Structure("video/x-h264", **{"stream-format":
                                                "byte-stream"}),
                   Structure("video/x-h265", **{"stream-format":
                                                "byte-stream"})])


@register_element("debugseimetainserter", Rank.NONE)
class DebugSeiMetaInserter(BaseTransform):
    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    _H26X_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    _H26X_CAPS.copy()),
    ]

    payload = Property(bytes, default=b"", mutable=Mutability.PLAYING,
                       blurb="Debug payload to inject per buffer")

    def transform_ip(self, buf: Buffer) -> None:
        h265 = self.in_caps[0].name == "video/x-h265"
        sei = build_sei_unregistered(self.payload or b"", h265=h265)
        buf.data = sei + buf.to_bytes()
