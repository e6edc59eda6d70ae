"""MPEG-TS packet/section parsing + PCR wraparound handling.

Rebuilds the parsing core of the reference net/mpegtslive crate
(src/mpegtslive/imp.rs): 188-byte packet headers, adaptation fields
with PCR (33-bit 90kHz base x 300 + 9-bit extension = 27MHz),
PAT/PMT sections, and the MpegTsPcr wraparound tracker with its 15s
discontinuity tolerance (imp.rs:77-121).

The port's copy of gstpu/codecs/mpegts.py: the standard library, as
there.
"""

from __future__ import annotations

from dataclasses import dataclass

TS_PACKET_SIZE = 188
SYNC_BYTE = 0x47

PCR_MAX = (1 << 33) * 300 - 1
PCR_RATE = 27_000_000


@dataclass(frozen=True)
class MpegTsPcr:
    value: int          # raw 27MHz units, < PCR_MAX+1
    wraparound: int = 0

    @staticmethod
    def new(value: int) -> "MpegTsPcr":
        return MpegTsPcr(value % (PCR_MAX + 1), value // (PCR_MAX + 1))

    @staticmethod
    def new_with_reference(value: int,
                           ref: "MpegTsPcr") -> "MpegTsPcr | None":
        """Track wraparound relative to the last seen PCR; None on a
        discontinuity >15s (imp.rs:77)."""
        value %= PCR_MAX + 1
        tol = 15 * PCR_RATE
        if abs(value - ref.value) <= tol:
            return MpegTsPcr(value, ref.wraparound)
        if abs(value + PCR_MAX + 1 - ref.value) <= tol:
            return MpegTsPcr(value, ref.wraparound + 1)
        if abs(value - (ref.value + PCR_MAX + 1)) <= tol:
            return MpegTsPcr(value, ref.wraparound - 1)
        return None

    def to_units(self) -> int:
        return self.wraparound * (PCR_MAX + 1) + self.value

    def to_ns(self) -> int:
        return self.to_units() * 1000 // 27


@dataclass
class TsHeader:
    pid: int
    pusi: bool
    afc: int
    cc: int
    tei: bool = False


def parse_ts_packet(pkt: bytes):
    """-> (TsHeader, adaptation dict | None, payload bytes | None)."""
    if len(pkt) != TS_PACKET_SIZE or pkt[0] != SYNC_BYTE:
        raise ValueError("not a TS packet")
    hdr = TsHeader(pid=(pkt[1] & 0x1F) << 8 | pkt[2],
                   pusi=bool(pkt[1] & 0x40),
                   afc=(pkt[3] >> 4) & 0x3,
                   cc=pkt[3] & 0x0F,
                   tei=bool(pkt[1] & 0x80))
    pos = 4
    adaptation = None
    if hdr.afc & 0x2:
        alen = pkt[pos]
        pos += 1
        if alen > 183:
            raise ValueError("too long adaptation field")
        adaptation = {"discontinuity": False, "pcr": None}
        if alen >= 1:
            flags = pkt[pos]
            adaptation["discontinuity"] = bool(flags & 0x80)
            if flags & 0x10 and alen >= 7:     # PCR flag
                b = pkt[pos + 1:pos + 7]
                base = (b[0] << 25 | b[1] << 17 | b[2] << 9 |
                        b[3] << 1 | b[4] >> 7)
                ext = (b[4] & 0x01) << 8 | b[5]
                adaptation["pcr"] = base * 300 + ext
        pos += alen
    payload = pkt[pos:] if hdr.afc & 0x1 else None
    return hdr, adaptation, payload


def build_ts_packet(pid: int, *, payload: bytes = b"", pusi: bool =
                    False, cc: int = 0, pcr: int | None = None) -> bytes:
    """Test/mux helper: one packet, stuffing via adaptation field."""
    if len(payload) > 184 or (pcr is not None and len(payload) > 176):
        raise ValueError("payload exceeds one TS packet")
    hdr = bytearray([SYNC_BYTE,
                     (0x40 if pusi else 0) | pid >> 8, pid & 0xFF, 0])
    need_af = pcr is not None or len(payload) < 184
    af = b""
    if need_af:
        af_len = TS_PACKET_SIZE - 4 - 1 - len(payload)
        if af_len == 0:
            af = bytes([0])
        else:
            body = bytearray([0x10 if pcr is not None else 0x00])
            if pcr is not None:
                base, ext = divmod(pcr, 300)
                body += bytes([base >> 25 & 0xFF, base >> 17 & 0xFF,
                               base >> 9 & 0xFF, base >> 1 & 0xFF,
                               (base & 1) << 7 | 0x7E | ext >> 8,
                               ext & 0xFF])
            af = bytes([af_len]) + bytes(body).ljust(af_len, b"\xFF")
    hdr[3] = ((0x20 if need_af else 0)
              | (0x10 if payload else 0) | (cc & 0x0F))
    pkt = bytes(hdr) + af + payload
    assert len(pkt) == TS_PACKET_SIZE
    return pkt


def parse_pat(section: bytes) -> dict[int, int]:
    """program_number -> PMT pid (table_id 0x00)."""
    if section[0] != 0x00:
        raise ValueError(f"not a PAT section: table {section[0]:#x}")
    length = (section[1] & 0x0F) << 8 | section[2]
    body = section[3:3 + length]
    programs = {}
    for i in range(5, len(body) - 4, 4):   # skip syntax hdr, stop @CRC
        prog = body[i] << 8 | body[i + 1]
        pid = (body[i + 2] & 0x1F) << 8 | body[i + 3]
        if prog != 0:
            programs[prog] = pid
    return programs


@dataclass
class Pmt:
    pcr_pid: int
    streams: list[tuple[int, int]]       # (stream_type, elementary_pid)


def parse_pmt(section: bytes) -> Pmt:
    if section[0] != 0x02:
        raise ValueError(f"not a PMT section: table {section[0]:#x}")
    length = (section[1] & 0x0F) << 8 | section[2]
    body = section[3:3 + length]
    pcr_pid = (body[5] & 0x1F) << 8 | body[6]
    pinfo_len = (body[7] & 0x0F) << 8 | body[8]
    streams = []
    i = 9 + pinfo_len
    while i < len(body) - 4:             # stop before CRC32
        stype = body[i]
        epid = (body[i + 1] & 0x1F) << 8 | body[i + 2]
        es_len = (body[i + 3] & 0x0F) << 8 | body[i + 4]
        streams.append((stype, epid))
        i += 5 + es_len
    return Pmt(pcr_pid=pcr_pid, streams=streams)


def section_from_payload(payload: bytes) -> bytes:
    """Apply the pointer_field of a PUSI packet (single-packet
    sections, the common case for PAT/PMT)."""
    ptr = payload[0]
    return payload[1 + ptr:]


class PcrSlavedClock:
    """Clock calibrated from (internal, external) PCR observations —
    the analogue of the reference's slaved external SystemClock
    (imp.rs:696, store_observation).  adjust() maps internal master
    time onto the PCR timeline with a windowed linear fit."""

    WINDOW = 32

    def __init__(self, master):
        self.master = master
        self._obs: list[tuple[int, int]] = []
        # calibration: external = (internal - ci) * num/den + ce
        self._ci = 0
        self._ce = 0
        self._num = 1
        self._den = 1

    def add_observation(self, internal: int, external: int) -> None:
        self._obs.append((internal, external))
        if len(self._obs) > self.WINDOW:
            self._obs.pop(0)
        i0, e0 = self._obs[0]
        if len(self._obs) >= 2:
            i1, e1 = self._obs[-1]
            if i1 != i0:
                self._ci, self._ce = i0, e0
                self._num, self._den = e1 - e0, i1 - i0
                return
        self._ci, self._ce, self._num, self._den = i0, e0, 1, 1

    def reset(self) -> None:
        self._obs.clear()

    @property
    def n_observations(self) -> int:
        return len(self._obs)

    def adjust(self, internal: int) -> int:
        return (internal - self._ci) * self._num // self._den + self._ce

    def time(self) -> int:
        return self.adjust(self.master.time())


# -- section builders (PAT/PMT with MPEG-2 CRC32) -----------------------

_CRC_TABLE = None


def crc32_mpeg2(data: bytes) -> int:
    """CRC-32/MPEG-2: poly 0x04C11DB7, init 0xFFFFFFFF, no reflection,
    no final xor (ISO 13818-1 Annex A)."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tbl = []
        for i in range(256):
            c = i << 24
            for _ in range(8):
                c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 \
                    else (c << 1)
            tbl.append(c & 0xFFFFFFFF)
        _CRC_TABLE = tbl
    crc = 0xFFFFFFFF
    for b in data:
        crc = ((crc << 8) ^ _CRC_TABLE[(crc >> 24) ^ b]) & 0xFFFFFFFF
    return crc


def _section(table_id: int, body: bytes) -> bytes:
    length = len(body) + 4                    # + CRC32
    head = bytes([table_id, 0xB0 | length >> 8, length & 0xFF]) + body
    return head + crc32_mpeg2(head).to_bytes(4, "big")


def build_pat(programs: dict[int, int], tsid: int = 1,
              version: int = 0) -> bytes:
    body = bytearray([tsid >> 8, tsid & 0xFF,
                      0xC1 | (version & 0x1F) << 1, 0, 0])
    for prog, pid in programs.items():
        body += bytes([prog >> 8, prog & 0xFF,
                       0xE0 | pid >> 8, pid & 0xFF])
    return _section(0x00, bytes(body))


def build_pmt(pmt_prog: int, pcr_pid: int,
              streams: list[tuple[int, int]],
              version: int = 0) -> bytes:
    body = bytearray([pmt_prog >> 8, pmt_prog & 0xFF,
                      0xC1 | (version & 0x1F) << 1, 0, 0,
                      0xE0 | pcr_pid >> 8, pcr_pid & 0xFF,
                      0xF0, 0x00])
    for stype, epid in streams:
        body += bytes([stype, 0xE0 | epid >> 8, epid & 0xFF,
                       0xF0, 0x00])
    return _section(0x02, bytes(body))


def build_pes(stream_id: int, payload: bytes,
              pts_90k: int | None = None) -> bytes:
    """PES packet; video (0xE0..) gets unbounded length 0."""
    hdr = bytearray()
    flags2 = 0
    if pts_90k is not None:
        flags2 = 0x80
        p = pts_90k & (1 << 33) - 1
        hdr += bytes([0x21 | (p >> 29 & 0x0E),
                      p >> 22 & 0xFF, 0x01 | (p >> 14 & 0xFE),
                      p >> 7 & 0xFF, 0x01 | (p << 1 & 0xFE)])
    body = bytes([0x80, flags2, len(hdr)]) + hdr + payload
    length = 0 if 0xE0 <= stream_id <= 0xEF else min(len(body), 0xFFFF)
    return (b"\x00\x00\x01" + bytes([stream_id])
            + length.to_bytes(2, "big") + body)
