"""SMPTE ST-2038 ancillary-data packet codec (10-bit words in a
bitstream).

Rebuilds the reference st2038anc_utils.rs: 6 zero bits, c_not_y flag,
11-bit line number, 12-bit horizontal offset, then 10-bit
parity-extended DID/SDID/DC/UDW words and the ST-291 section 6.7
checksum (9-bit sum, b9 = NOT b8), padded to a byte with one bits.

The port's copy of gstpu/codecs/st2038.py, as it stands.
"""

from __future__ import annotations

from dataclasses import dataclass


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0            # in bits

    def read(self, n: int) -> int:
        if self.pos + n > len(self.data) * 8:
            raise ValueError("st2038: truncated bitstream")
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = v << 1 | (byte >> (7 - (self.pos & 7))) & 1
            self.pos += 1
        return v


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, v: int, n: int) -> None:
        self.acc = self.acc << n | (v & (1 << n) - 1)
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append(self.acc >> self.nbits & 0xFF)

    def align_with_ones(self) -> bytes:
        if self.nbits:
            self.write((1 << (8 - self.nbits)) - 1, 8 - self.nbits)
        return bytes(self.out)


def _parity10(v: int) -> int:
    """Even parity -> b8=1; odd -> b9=1 (st2038anc_utils.rs:75)."""
    return (0x100 if bin(v).count("1") % 2 == 0 else 0x200) | v


@dataclass
class AncDataHeader:
    c_not_y: bool
    line_number: int
    horizontal_offset: int
    did: int
    sdid: int
    data_count: int
    checksum: int
    len: int                    # whole packet length in bytes


def parse_anc(data: bytes) -> tuple[AncDataHeader, bytes]:
    """One ANC packet from the start of `data` -> (header, payload)."""
    r = _BitReader(data)
    if r.read(6) != 0:
        raise ValueError("st2038: zero bits not zero")
    c_not_y = bool(r.read(1))
    line = r.read(11)
    hoff = r.read(12)
    did = r.read(10) & 0xFF
    sdid = r.read(10) & 0xFF
    dc = r.read(10) & 0xFF
    payload = bytes(r.read(10) & 0xFF for _ in range(dc))
    checksum = r.read(10)
    while r.pos % 8:
        if r.read(1) != 1:
            raise ValueError("st2038: alignment bits are not ones")
    hdr = AncDataHeader(c_not_y, line, hoff, did, sdid, dc, checksum,
                        r.pos // 8)
    return hdr, payload


def iter_anc(data: bytes):
    """All ANC packets in a buffer; 0xFF bytes are stuffing."""
    pos = 0
    while pos < len(data):
        if data[pos] == 0xFF:
            break
        hdr, payload = parse_anc(data[pos:])
        yield hdr, payload
        pos += hdr.len


def build_anc(did: int, sdid: int, payload: bytes, *,
              c_not_y: bool = False, line_number: int = 0,
              horizontal_offset: int = 0) -> bytes:
    if len(payload) > 255:
        raise ValueError("st2038: payload must be <256 bytes")
    w = _BitWriter()
    w.write(0, 6)
    w.write(1 if c_not_y else 0, 1)
    w.write(line_number, 11)
    w.write(horizontal_offset, 12)
    checksum = 0
    for word in (_parity10(did), _parity10(sdid),
                 _parity10(len(payload))):
        w.write(word, 10)
        checksum += word & 0x1FF
    for b in payload:
        word = _parity10(b)
        w.write(word, 10)
        checksum += word & 0x1FF
    checksum &= 0x1FF
    checksum |= (~(checksum >> 8) & 1) << 9
    w.write(checksum, 10)
    return w.align_with_ones()
