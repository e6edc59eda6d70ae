"""Ogg container parsing (RFC 3533).

Backs the lewtondec element (the reference decodes Ogg/Vorbis via the
lewton crate): page capture, CRC check, lacing-value packet assembly
including packets continued across pages, and granule positions for
duration/trim.

The port's copy of gstpu/codecs/ogg.py: the standard library, as there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

_CRC_TABLE: list[int] | None = None


def ogg_crc(data: bytes) -> int:
    """CRC-32 poly 0x04C11DB7, init 0, no reflection, no final xor."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tbl = []
        for i in range(256):
            c = i << 24
            for _ in range(8):
                c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 \
                    else c << 1
            tbl.append(c & 0xFFFFFFFF)
        _CRC_TABLE = tbl
    crc = 0
    for b in data:
        crc = ((crc << 8) ^ _CRC_TABLE[(crc >> 24) ^ b]) & 0xFFFFFFFF
    return crc


@dataclass
class OggPage:
    header_type: int
    granulepos: int
    serial: int
    page_seq: int
    segments: list[bytes]
    continued: bool
    last_complete: bool         # final lacing value < 255 ends a packet

    @property
    def bos(self) -> bool:
        return bool(self.header_type & 0x02)

    @property
    def eos(self) -> bool:
        return bool(self.header_type & 0x04)


def parse_pages(data: bytes, *, check_crc: bool = True):
    """Yield OggPage objects from a byte stream."""
    pos = 0
    while True:
        idx = data.find(b"OggS", pos)
        if idx < 0:
            return
        if idx + 27 > len(data):
            return
        h = data[idx:idx + 27]
        if h[4] != 0:
            raise ValueError(f"unsupported ogg version {h[4]}")
        n_segs = h[26]
        lacing = data[idx + 27:idx + 27 + n_segs]
        if len(lacing) < n_segs:
            return
        body_len = sum(lacing)
        start = idx + 27 + n_segs
        if start + body_len > len(data):
            return
        page_bytes = data[idx:start + body_len]
        if check_crc:
            crc = int.from_bytes(h[22:26], "little")
            zeroed = bytearray(page_bytes)
            zeroed[22:26] = b"\x00" * 4
            if ogg_crc(bytes(zeroed)) != crc:
                raise ValueError(f"ogg page crc mismatch at {idx}")
        segments = []
        off = start
        seg = b""
        for lv in lacing:
            seg += data[off:off + lv]
            off += lv
            if lv < 255:
                segments.append(seg)
                seg = b""
        last_complete = True
        if seg:
            segments.append(seg)
            last_complete = False
        yield OggPage(
            header_type=h[5],
            granulepos=int.from_bytes(h[6:14], "little", signed=True),
            serial=int.from_bytes(h[14:18], "little"),
            page_seq=int.from_bytes(h[18:22], "little"),
            segments=segments, continued=bool(h[5] & 0x01),
            last_complete=last_complete)
        pos = start + body_len


def packets_of(data: bytes, serial: int | None = None):
    """Assemble (packet_bytes, granulepos_of_its_page) across pages.

    granulepos is that of the page on which the packet *ends* (-1 when
    the page carries no completed packet boundary information).
    """
    partial = b""
    for page in parse_pages(data):
        if serial is not None and page.serial != serial:
            continue
        segs = list(page.segments)
        if page.continued and segs:
            partial += segs.pop(0)
            if page.last_complete or len(segs) > 0:
                yield partial, page.granulepos
                partial = b""
            # else: still continuing into the next page
        for i, s in enumerate(segs):
            if i == len(segs) - 1 and not page.last_complete:
                partial += s
            else:
                yield s, page.granulepos
    if partial:
        yield partial, -1
