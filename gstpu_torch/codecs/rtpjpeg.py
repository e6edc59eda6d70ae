"""RFC 2435 JPEG-over-RTP header machinery.

Rebuilds the reference net/rtp/src/jpeg codec logic: the payloader
strips a baseline JFIF down to its entropy-coded scan plus quant
tables (sent in the first fragment, Q=255) and an 8-byte main header;
the depayloader regenerates SOI/DQT/SOF0/DHT/SOS around the scan
using the standard JPEG Annex K Huffman tables that RFC 2435
Appendix B hardcodes.

The port's copy of gstpu/codecs/rtpjpeg.py, as it stands.
"""

from __future__ import annotations

from dataclasses import dataclass

# JPEG Annex K / RFC 2435 Appendix B standard Huffman tables
LUM_DC_CODELENS = bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0,
                         0])
LUM_DC_SYMBOLS = bytes(range(12))
CHM_DC_CODELENS = bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0,
                         0])
CHM_DC_SYMBOLS = bytes(range(12))
LUM_AC_CODELENS = bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1,
                         0x7D])
LUM_AC_SYMBOLS = bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
    0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
CHM_AC_CODELENS = bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2,
                         0x77])
CHM_AC_SYMBOLS = bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
    0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
    0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
    0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
    0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


@dataclass
class JpegInfo:
    width: int
    height: int
    jpeg_type: int              # 0 = 4:2:2, 1 = 4:2:0
    qtables: list[bytes]        # 64-byte zigzag tables
    scan: bytes                 # entropy-coded data (to EOI)
    restart_interval: int = 0


def parse_jpeg(data: bytes) -> JpegInfo:
    """Walk baseline JFIF markers (reference jpeg/pay parsing)."""
    if data[:2] != b"\xFF\xD8":
        raise ValueError("not a JPEG (no SOI)")
    pos = 2
    qtables: dict[int, bytes] = {}
    width = height = 0
    jpeg_type = 0
    dri = 0
    while pos < len(data) - 1:
        if data[pos] != 0xFF:
            raise ValueError(f"marker expected at {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        seglen = data[pos] << 8 | data[pos + 1]
        seg = data[pos + 2:pos + seglen]
        if marker == 0xDB:                     # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 0x0F
                n = 64 * (2 if pq else 1)
                if pq:
                    raise ValueError("16-bit qtables unsupported "
                                     "(RFC 2435 sends 8-bit)")
                qtables[tq] = seg[i + 1:i + 1 + n]
                i += 1 + n
        elif marker == 0xC0:                   # SOF0 baseline
            height = seg[1] << 8 | seg[2]
            width = seg[3] << 8 | seg[4]
            ncomp = seg[5]
            if ncomp != 3:
                raise ValueError("only YCbCr 3-component supported")
            sampling = seg[7]                  # component 0 h|v
            jpeg_type = 1 if sampling == 0x22 else 0
            if sampling not in (0x21, 0x22):
                raise ValueError(f"unsupported sampling "
                                 f"{sampling:#x} (need 4:2:2/4:2:0)")
        elif marker in (0xC1, 0xC2, 0xC3):
            raise ValueError("only baseline SOF0 supported")
        elif marker == 0xDD:                   # DRI
            dri = seg[0] << 8 | seg[1]
        elif marker == 0xDA:                   # SOS: scan follows
            scan_start = pos + seglen
            end = data.rfind(b"\xFF\xD9")
            scan = data[scan_start:end if end > scan_start
                        else len(data)]
            tables = [qtables.get(i, qtables.get(0, bytes(64)))
                      for i in sorted(qtables) or [0]]
            return JpegInfo(width, height, jpeg_type, tables, scan,
                            dri)
        pos += seglen
    raise ValueError("no SOS marker found")


def _dht(codelens: bytes, symbols: bytes, cls: int, tid: int) -> bytes:
    body = bytes([cls << 4 | tid]) + codelens + symbols
    return b"\xFF\xC4" + (len(body) + 2).to_bytes(2, "big") + body


def make_headers(info: JpegInfo) -> bytes:
    """Regenerate the JFIF headers (RFC 2435 Appendix B MakeHeaders)."""
    out = bytearray(b"\xFF\xD8")
    for i, qt in enumerate(info.qtables[:2]):
        out += b"\xFF\xDB" + (67).to_bytes(2, "big") + bytes([i]) + qt
    if info.restart_interval:
        out += b"\xFF\xDD\x00\x04" \
            + info.restart_interval.to_bytes(2, "big")
    samp = 0x22 if info.jpeg_type & 0x3F == 1 else 0x21
    cq = 1 if len(info.qtables) > 1 else 0    # chroma quant table
    sof = (b"\x08" + info.height.to_bytes(2, "big")
           + info.width.to_bytes(2, "big") + b"\x03"
           + bytes([1, samp, 0]) + bytes([2, 0x11, cq])
           + bytes([3, 0x11, cq]))
    out += b"\xFF\xC0" + (len(sof) + 2).to_bytes(2, "big") + sof
    out += _dht(LUM_DC_CODELENS, LUM_DC_SYMBOLS, 0, 0)
    out += _dht(LUM_AC_CODELENS, LUM_AC_SYMBOLS, 1, 0)
    out += _dht(CHM_DC_CODELENS, CHM_DC_SYMBOLS, 0, 1)
    out += _dht(CHM_AC_CODELENS, CHM_AC_SYMBOLS, 1, 1)
    sos = (b"\x03" + bytes([1, 0x00]) + bytes([2, 0x11])
           + bytes([3, 0x11]) + b"\x00\x3F\x00")
    out += b"\xFF\xDA" + (len(sos) + 2).to_bytes(2, "big") + sos
    return bytes(out)


def reassemble_jpeg(info: JpegInfo) -> bytes:
    return make_headers(info) + info.scan + b"\xFF\xD9"
