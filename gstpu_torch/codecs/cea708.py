"""CEA-708 cc_data / CDP (SMPTE 334-2) packet codec.

Rebuilds the reference's CDP handling (video/closedcaption/src/
ccutils.rs extract_cdp, cea608tocea708/imp.rs cc_data writer): cc_data
is a sequence of 3-byte triplets (marker|valid|type, byte0, byte1);
a CDP wraps cc_data with the 0x9669 header, frame-rate code, flags,
sequence counter and a zero-sum checksum footer.

The port's copy of gstpu/codecs/cea708.py, as it stands.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction

# cdp_frame_rate codes (SMPTE 334-2 table 2) and the per-frame
# cc_count that fills the 9.6 kbit/s caption channel at that rate
CDP_RATES: dict[Fraction, int] = {
    Fraction(24000, 1001): 0x1, Fraction(24): 0x2, Fraction(25): 0x3,
    Fraction(30000, 1001): 0x4, Fraction(30): 0x5, Fraction(50): 0x6,
    Fraction(60000, 1001): 0x7, Fraction(60): 0x8,
}
CC_COUNT = {0x1: 25, 0x2: 25, 0x3: 24, 0x4: 20, 0x5: 20, 0x6: 12,
            0x7: 10, 0x8: 10}

# cc_type values inside a triplet
CC_608_FIELD1 = 0x0
CC_608_FIELD2 = 0x1
CC_708_DATA = 0x2
CC_708_START = 0x3


def cc_triplet(byte0: int, byte1: int, cc_type: int,
               valid: bool = True) -> bytes:
    return bytes([0xF8 | (0x04 if valid else 0) | cc_type,
                  byte0, byte1])


def cc_data_from_608(pairs: list[bytes], field_: int = 0) -> bytes:
    t = CC_608_FIELD1 if field_ == 0 else CC_608_FIELD2
    return b"".join(cc_triplet(p[0], p[1], t) for p in pairs)


def pad_cc_data(cc_data: bytes, cc_count: int) -> bytes:
    """Pad with invalid-608 triplets (0xFA 00 00 — the runs that MCC
    aliases as G..O)."""
    n = cc_count - len(cc_data) // 3
    if n < 0:
        raise ValueError(f"cc_data exceeds cc_count={cc_count}")
    return cc_data + bytes([0xFA, 0x00, 0x00]) * n


def extract_cea608(cc_data: bytes) -> tuple[list[bytes], list[bytes]]:
    """Valid 608 pairs per field from a cc_data triplet run."""
    f0, f1 = [], []
    for i in range(0, len(cc_data) - 2, 3):
        hdr = cc_data[i]
        if not hdr & 0x04:
            continue  # cc_valid unset (padding)
        t = hdr & 0x03
        if t == CC_608_FIELD1:
            f0.append(cc_data[i + 1:i + 3])
        elif t == CC_608_FIELD2:
            f1.append(cc_data[i + 1:i + 3])
    return f0, f1


@dataclass
class Cdp:
    rate_code: int = 0x4
    sequence: int = 0
    cc_data: bytes = b""
    timecode: tuple[int, int, int, int] | None = None  # h, m, s, f
    service_active: bool = True
    services: list | None = None           # svc_info entries


def build_cdp(cdp: Cdp) -> bytes:
    flags = 0x40 | 0x01                    # ccdata_present | reserved
    if cdp.timecode is not None:
        flags |= 0x80
    if cdp.services:
        flags |= 0x20 | 0x10 | 0x04        # present | start | complete
    if cdp.service_active:
        flags |= 0x02
    body = bytearray([cdp.rate_code << 4 | 0x0F, flags,
                      cdp.sequence >> 8 & 0xFF, cdp.sequence & 0xFF])
    if cdp.timecode is not None:
        h, m, s, f = cdp.timecode
        body += bytes([0x71,
                       0xC0 | (h // 10) << 4 | h % 10,
                       0x80 | (m // 10) << 4 | m % 10,
                       0x80 | (s // 10) << 4 | s % 10,
                       0x80 | (f // 10) << 4 | f % 10])
    cc_count = len(cdp.cc_data) // 3
    body += bytes([0x72, 0xE0 | cc_count]) + cdp.cc_data
    if cdp.services:
        body += build_svc_info(cdp.services)
    body += bytes([0x74, cdp.sequence >> 8 & 0xFF,
                   cdp.sequence & 0xFF])
    total = len(body) + 3                  # + magic(2) + length(1)
    pkt = bytearray([0x96, 0x69, total + 1]) + body
    checksum = (256 - sum(pkt) % 256) % 256
    pkt.append(checksum)
    assert sum(pkt) % 256 == 0
    return bytes(pkt)


def parse_cdp(data: bytes) -> Cdp:
    """Mirror of ccutils.rs:27 extract_cdp validation order."""
    if len(data) < 11:
        raise ValueError(f"cdp packet too short {len(data)}")
    if data[0] != 0x96 or data[1] != 0x69:
        raise ValueError("cdp packet does not start with 0x9669")
    if data[2] != len(data):
        raise ValueError(f"advertised cdp length {data[2]} != "
                         f"{len(data)}")
    if sum(data) % 256 != 0:
        raise ValueError("cdp checksum mismatch")
    rate_code = data[3] >> 4
    flags = data[4]
    seq = data[5] << 8 | data[6]
    pos = 7
    tc = None
    if flags & 0x80:
        if len(data) < pos + 5:
            raise ValueError("cdp signals a timecode but is too short")
        if data[pos] != 0x71:
            raise ValueError("bad time_code_section id")
        def bcd(b, mask):
            return ((b & mask) >> 4) * 10 + (b & 0x0F)
        tc = (bcd(data[pos + 1], 0x30), bcd(data[pos + 2], 0x70),
              bcd(data[pos + 3], 0x70), bcd(data[pos + 4], 0x30))
        pos += 5
    cc_data = b""
    if flags & 0x40:
        if len(data) < pos + 2:
            raise ValueError("cdp signals cc_data but is too short")
        if data[pos] != 0x72:
            raise ValueError("ccp is missing start code 0x72")
        cnt = data[pos + 1]
        if cnt & 0xE0 != 0xE0:
            raise ValueError(f"reserved bits are not 0xe0, found "
                             f"{cnt & 0xE0:02x}")
        cnt &= 0x1F
        pos += 2
        if len(data) < pos + 3 * cnt:
            raise ValueError("cc_data truncated")
        cc_data = data[pos:pos + 3 * cnt]
        pos += 3 * cnt
    services = None
    if flags & 0x20:
        if pos >= len(data) or data[pos] != 0x73:
            raise ValueError("cdp signals svc_info but 0x73 missing")
        services, used = parse_svc_info(data[pos:])
        pos += used
    return Cdp(rate_code=rate_code, sequence=seq, cc_data=cc_data,
               timecode=tc, service_active=bool(flags & 0x02),
               services=services)


# -- ccsvcinfo_section (SMPTE 334-2 / CEA-708 service descriptors) -----

def build_svc_info(services: list[dict], *, start: bool = True,
                   change: bool = False, complete: bool = True) -> bytes:
    """0x73 section.  Each service dict: service (1..63 for 708,
    -1..-4 for 608 channels CC1-CC4), language (3-letter ISO 639.2),
    easy_reader / wide_aspect_ratio (708 only)."""
    if not 0 < len(services) <= 15:
        raise ValueError("1..15 services per svc_info section")
    out = bytearray([0x73,
                     0x80 | (0x40 if start else 0)
                     | (0x20 if change else 0)
                     | (0x10 if complete else 0) | len(services)])
    for s in services:
        sid = int(s["service"])
        lang = s["language"].encode()[:3].ljust(3, b" ")
        if sid == 0 or not -4 <= sid <= 63:
            raise ValueError(f"invalid service id {sid}")
        csn = sid if sid > 0 else 0
        out.append(0xE0 | (csn & 0x1F))
        out += lang
        if sid > 0:                      # digital (708) service
            b3 = 0xC0 | (sid & 0x3F)
            b4 = ((0x80 if s.get("easy_reader") else 0)
                  | (0x40 if s.get("wide_aspect_ratio") else 0) | 0x3F)
        else:                            # 608 channel CC1..CC4
            b3 = 0x00 | ((-sid - 1) & 0x03)
            b4 = 0x3F
        out += bytes([b3, b4, 0xFF])
    return bytes(out)


def parse_svc_info(data: bytes) -> tuple[list[dict], int]:
    """-> (services, bytes consumed); data starts at the 0x73 id."""
    if data[0] != 0x73:
        raise ValueError("not a ccsvcinfo section")
    count = data[1] & 0x0F
    services = []
    pos = 2
    for _ in range(count):
        lang = data[pos + 1:pos + 4].decode("ascii", "replace").strip()
        b3, b4 = data[pos + 4], data[pos + 5]
        if b3 & 0x80:                    # digital_cc
            services.append({"service": b3 & 0x3F, "language": lang,
                             "easy_reader": bool(b4 & 0x80),
                             "wide_aspect_ratio": bool(b4 & 0x40)})
        else:
            services.append({"service": -((b3 & 0x03) + 1),
                             "language": lang})
        pos += 7
    return services, pos


# -- DTVCC packets and service blocks (CEA-708 6.2/6.3) ----------------

def ccdata_split(cc_data: bytes):
    """cc_data triplets -> (608 field pairs list, DTVCC packets list).

    A CC_708_START triplet begins a packet; CC_708_DATA triplets
    continue it (the reference's cea708mux feeds these into
    cea708_types' CCDataParser)."""
    pairs = []
    packets = []
    cur = None
    for i in range(0, len(cc_data) - 2, 3):
        hdr = cc_data[i]
        if not hdr & 0x04:
            continue
        t = hdr & 0x03
        two = cc_data[i + 1:i + 3]
        if t in (CC_608_FIELD1, CC_608_FIELD2):
            pairs.append((t, two))
        elif t == CC_708_START:
            if cur:
                packets.append(bytes(cur))
            cur = bytearray(two)
        elif t == CC_708_DATA and cur is not None:
            cur += two
    if cur:
        packets.append(bytes(cur))
    return pairs, packets


def dtvcc_to_ccdata(packet: bytes) -> bytes:
    """DTVCC packet bytes -> cc_data triplets (START + DATA)."""
    if len(packet) % 2:
        packet += b"\x00"
    out = b""
    for i in range(0, len(packet), 2):
        t = CC_708_START if i == 0 else CC_708_DATA
        out += cc_triplet(packet[i], packet[i + 1], t)
    return out


def parse_dtvcc(packet: bytes) -> tuple[int, list[tuple[int, bytes]]]:
    """-> (sequence_no, [(service_no, block_data), ...]).

    byte0: seq(2) | packet_size_code(6); total packet length is
    packet_size_code*2 (128 when 0).  Service block header:
    service_number(3) | block_size(5); service 7 = extended header.
    """
    seq = packet[0] >> 6
    size = (packet[0] & 0x3F) * 2 or 128
    data = packet[1:size]
    blocks = []
    pos = 0
    while pos < len(data):
        hdr = data[pos]
        if hdr == 0:
            break                           # padding
        svc = hdr >> 5
        blen = hdr & 0x1F
        pos += 1
        if svc == 7:                        # extended service number
            svc = data[pos] & 0x3F
            pos += 1
        blocks.append((svc, data[pos:pos + blen]))
        pos += blen
    return seq, blocks


def build_dtvcc(seq: int, blocks: list[tuple[int, bytes]]) -> bytes:
    body = bytearray()
    for svc, data in blocks:
        if not 0 < svc <= 63 or len(data) > 31:
            raise ValueError(f"bad service block ({svc}, "
                             f"{len(data)} bytes)")
        if svc <= 6:
            body.append(svc << 5 | len(data))
        else:
            body.append(7 << 5 | len(data))
            body.append(svc)
        body += data
    total = 1 + len(body)
    if total % 2:
        body.append(0)
        total += 1
    size_code = (total // 2) % 64
    return bytes([(seq & 0x3) << 6 | size_code]) + bytes(body)


# C1 window-command operand lengths (CEA-708 table 17): used to skip
# formatting commands when extracting bare service text
_C1_LENGTHS = {**{c: 0 for c in range(0x80, 0x88)},   # CW0-7
               0x88: 1, 0x89: 1, 0x8A: 1, 0x8B: 1, 0x8C: 1,
               0x8D: 1, 0x8E: 0, 0x8F: 0,
               0x90: 2, 0x91: 3, 0x92: 2, 0x97: 4,
               **{c: 6 for c in range(0x98, 0xA0)}}   # DF0-7


def service_block_text(data: bytes) -> str:
    """Printable text from one service block: G0 passthrough, CR ->
    newline, C1 window/pen commands skipped, ETX ignored."""
    out = []
    i = 0
    while i < len(data):
        b = data[i]
        if 0x20 <= b <= 0x7F:
            out.append(chr(b) if b != 0x7F else "♪")
            i += 1
        elif b == 0x0D:
            out.append("\n")
            i += 1
        elif b in (0x00, 0x03, 0x08, 0x0C, 0x0E):  # NUL/ETX/BS/FF/HCR
            i += 1
        elif b == 0x10:                    # EXT1: skip one code
            i += 2
        elif 0x80 <= b <= 0x9F:
            i += 1 + _C1_LENGTHS.get(b, 0)
        else:
            i += 1
    return "".join(out)
