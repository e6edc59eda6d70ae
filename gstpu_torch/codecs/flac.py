"""FLAC decoder (and a verbatim encoder for tests/tools).

Re-implements the subset of FLAC needed by the claxondec element
(reference audio/claxon/src/claxondec/imp.rs + the claxon crate):
STREAMINFO parsing, frame sync, all subframe types (constant, verbatim,
fixed 0-4, LPC), rice/rice2 partitioned residuals, wasted bits, stereo
decorrelation (L/S, R/S, M/S), CRC-8/16 validation.

The port's copy of gstpu/codecs/flac.py: numpy and the standard library,
as there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 \
                else (crc << 1) & 0xFF
    return crc


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


class BitReader:
    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits

    def read(self, n: int) -> int:
        out = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            out = (out << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        n = 0
        while self.read(1) == 0:
            n += 1
        return n

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3


@dataclass
class StreamInfo:
    min_block: int
    max_block: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int

    @staticmethod
    def parse(block: bytes) -> "StreamInfo":
        br = BitReader(block)
        min_block = br.read(16)
        max_block = br.read(16)
        br.read(24)  # min frame size
        br.read(24)  # max frame size
        rate = br.read(20)
        channels = br.read(3) + 1
        bps = br.read(5) + 1
        total = br.read(36)
        return StreamInfo(min_block, max_block, rate, channels, bps,
                          total)

    def to_bytes(self) -> bytes:
        out = bytearray()
        bits = [(self.min_block, 16), (self.max_block, 16), (0, 24),
                (0, 24), (self.sample_rate, 20), (self.channels - 1, 3),
                (self.bits_per_sample - 1, 5), (self.total_samples, 36)]
        acc, nacc = 0, 0
        for v, n in bits:
            acc = (acc << n) | (v & ((1 << n) - 1))
            nacc += n
        total_bits = nacc
        out += acc.to_bytes(total_bits // 8, "big")
        out += b"\x00" * 16  # md5 unset
        return bytes(out)


_BLOCKSIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
               8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
               13: 8192, 14: 16384, 15: 32768}
_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
          7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_BPS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1],
                4: [4, -6, 4, -1]}


def _read_utf8_number(br: BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    v = b0 & (mask - 1)
    for _ in range(n):
        v = (v << 6) | (br.read(8) & 0x3F)
    return v


def _decode_residual(br: BitReader, blocksize: int, order: int) \
        -> list[int]:
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual method")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    po = br.read(4)
    out: list[int] = []
    n_parts = 1 << po
    part_len = blocksize >> po
    for p in range(n_parts):
        n = part_len - (order if p == 0 else 0)
        param = br.read(param_bits)
        if param == escape:
            raw = br.read(5)
            for _ in range(n):
                out.append(br.read_signed(raw) if raw else 0)
        else:
            for _ in range(n):
                q = br.read_unary()
                v = (q << param) | br.read(param)
                out.append((v >> 1) ^ -(v & 1))  # zigzag
    return out


def _decode_subframe(br: BitReader, blocksize: int, bps: int) \
        -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("invalid subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
        bps -= wasted
    if stype == 0:       # constant
        v = br.read_signed(bps)
        samples = np.full(blocksize, v, np.int64)
    elif stype == 1:     # verbatim
        samples = np.array([br.read_signed(bps)
                            for _ in range(blocksize)], np.int64)
    elif 8 <= stype <= 12:  # fixed, order stype-8
        order = stype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        resid = _decode_residual(br, blocksize, order)
        samples = np.empty(blocksize, np.int64)
        samples[:order] = warm
        coefs = _FIXED_COEFS[order]
        for i in range(order, blocksize):
            pred = sum(c * samples[i - 1 - j]
                       for j, c in enumerate(coefs))
            samples[i] = resid[i - order] + pred
    elif stype >= 32:    # LPC, order stype-31
        order = stype - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("invalid qlp precision")
        shift = br.read_signed(5)
        coefs = [br.read_signed(precision) for _ in range(order)]
        resid = _decode_residual(br, blocksize, order)
        samples = np.empty(blocksize, np.int64)
        samples[:order] = warm
        for i in range(order, blocksize):
            acc = sum(c * int(samples[i - 1 - j])
                      for j, c in enumerate(coefs))
            samples[i] = resid[i - order] + (acc >> shift)
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        samples = samples << wasted
    return samples


@dataclass
class Frame:
    samples: np.ndarray   # (n, channels) int32
    sample_rate: int
    bits_per_sample: int
    frame_number: int


def decode_frame(data: bytes, streaminfo: StreamInfo | None,
                 offset: int = 0) -> tuple[Frame, int]:
    """Decode one frame starting at byte offset; returns
    (frame, next_offset)."""
    br = BitReader(data, offset * 8)
    start_byte = offset
    sync = br.read(14)
    if sync != 0x3FFE:
        raise ValueError(f"bad frame sync {sync:#x}")
    br.read(1)  # reserved
    br.read(1)  # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    bps_code = br.read(3)
    br.read(1)
    frame_number = _read_utf8_number(br)
    if bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    elif bs_code in _BLOCKSIZES:
        blocksize = _BLOCKSIZES[bs_code]
    else:
        raise ValueError("reserved blocksize code")
    if sr_code == 0:
        if streaminfo is None:
            raise ValueError("need STREAMINFO for sample rate")
        rate = streaminfo.sample_rate
    elif sr_code == 12:
        rate = br.read(8) * 1000
    elif sr_code == 13:
        rate = br.read(16)
    elif sr_code == 14:
        rate = br.read(16) * 10
    elif sr_code in _RATES:
        rate = _RATES[sr_code]
    else:
        raise ValueError("bad sample rate code")
    if bps_code == 0:
        if streaminfo is None:
            raise ValueError("need STREAMINFO for bps")
        bps = streaminfo.bits_per_sample
    elif bps_code in _BPS:
        bps = _BPS[bps_code]
    else:
        raise ValueError("bad bps code")
    # header CRC-8
    hdr_end = br.byte_pos() + (1 if br.pos & 7 else 0)
    crc_read = br.read(8)
    if crc8(data[start_byte:hdr_end]) != crc_read:
        raise ValueError("frame header CRC mismatch")

    if ch_code < 8:
        channels = ch_code + 1
        subs = [_decode_subframe(br, blocksize, bps)
                for _ in range(channels)]
        chans = subs
    else:
        # stereo decorrelation; side channel gets +1 bit
        if ch_code == 8:      # left/side
            left = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            chans = [left, left - side]
        elif ch_code == 9:    # right/side
            side = _decode_subframe(br, blocksize, bps + 1)
            right = _decode_subframe(br, blocksize, bps)
            chans = [side + right, right]
        elif ch_code == 10:   # mid/side
            mid = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            m2 = (mid << 1) | (side & 1)
            chans = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError("reserved channel assignment")
    br.align()
    frame_crc_end = br.byte_pos()
    crc_read = br.read(16)
    if crc16(data[start_byte:frame_crc_end]) != crc_read:
        raise ValueError("frame CRC-16 mismatch")
    samples = np.stack(chans, axis=1).astype(np.int32)
    return (Frame(samples, rate, bps, frame_number), br.byte_pos())


class FlacStreamDecoder:
    """Streaming decoder: feed bytes, pop decoded frames."""

    def __init__(self):
        self._buf = bytearray()
        self.streaminfo: StreamInfo | None = None
        self._header_done = False

    def push(self, data: bytes) -> None:
        self._buf.extend(data)

    def poll(self) -> Frame | None:
        if not self._header_done:
            if not self._parse_header():
                return None
        if len(self._buf) < 16:
            return None
        try:
            frame, consumed = decode_frame(bytes(self._buf),
                                           self.streaminfo)
        except IndexError:
            # ran off the buffer: incomplete trailing frame, wait
            return None
        except ValueError as e:
            # corrupt data (bad sync/CRC/reserved codes): error out
            # rather than stalling forever on the same bytes
            raise ValueError(f"corrupt FLAC frame: {e}") from e
        del self._buf[:consumed]
        return frame

    def _parse_header(self) -> bool:
        if len(self._buf) < 4:
            return False
        if self._buf[:4] != b"fLaC":
            raise ValueError("not a FLAC stream")
        pos = 4
        while True:
            if len(self._buf) < pos + 4:
                return False
            last = bool(self._buf[pos] & 0x80)
            btype = self._buf[pos] & 0x7F
            size = int.from_bytes(self._buf[pos + 1:pos + 4], "big")
            if len(self._buf) < pos + 4 + size:
                return False
            if btype == 0:
                self.streaminfo = StreamInfo.parse(
                    bytes(self._buf[pos + 4:pos + 4 + size]))
            pos += 4 + size
            if last:
                break
        del self._buf[:pos]
        self._header_done = True
        return True


# ---------------------------------------------------------------------------
# verbatim encoder (tests/tools)
# ---------------------------------------------------------------------------

class BitWriter:
    def __init__(self):
        self.acc = 0
        self.nbits = 0
        self.out = bytearray()

    def write(self, v: int, n: int) -> None:
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        return bytes(self.out)


def encode_verbatim(samples: np.ndarray, rate: int, bps: int = 16) \
        -> bytes:
    """Full FLAC stream with verbatim subframes (valid, uncompressed)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape
    blocksize = 4096
    si = StreamInfo(min(blocksize, n), blocksize, rate, channels, bps, n)
    out = bytearray(b"fLaC")
    info = si.to_bytes()
    out += bytes([0x80]) + len(info).to_bytes(3, "big") + info
    frame_no = 0
    for off in range(0, n, blocksize):
        block = samples[off:off + blocksize]
        bs = block.shape[0]
        w = BitWriter()
        w.write(0x3FFE, 14)
        w.write(0, 1)
        w.write(0, 1)          # fixed blocksize strategy
        w.write(7, 4)          # blocksize: 16-bit follows
        w.write(13, 4)         # sample rate: 16-bit Hz follows
        w.write(channels - 1, 4)
        w.write(4, 3)          # 16 bps
        w.write(0, 1)
        # utf8 frame number (support 0..127 for tests)
        assert frame_no < 128
        w.write(frame_no, 8)
        w.write(bs - 1, 16)
        w.write(rate, 16)
        hdr = w.bytes()
        assert w.nbits == 0
        w.write(crc8(hdr), 8)
        for c in range(channels):
            w.write(0, 1)
            w.write(1, 6)      # verbatim
            w.write(0, 1)      # no wasted bits
            for s in block[:, c]:
                w.write(int(s) & 0xFFFF, 16)
        w.align()
        body = w.bytes()
        w.write(crc16(body), 16)
        out += w.bytes()
        frame_no += 1
    return bytes(out)
