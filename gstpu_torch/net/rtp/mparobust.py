"""RFC 5219 MPEG Audio Robust (ADU) depayload core.

Sans-IO machinery for rtpmparobustdepay2, rebuilding what the
reference implements in net/rtp/src/mparobust/ (mpeg_audio_utils.rs,
depay/frames.rs, depay/deint_buf.rs): MPEG audio header parsing, the
ADU model (backpointer into the layer-III bit reservoir), dummy-ADU
insertion on loss, deinterleaving, and the ADU->MP3 frame conversion
from RFC 5219 Appendix A.2/B.2.

The port's copy of gstpu/net/rtp/mparobust.py, as it stands.
"""

from __future__ import annotations

from dataclasses import dataclass

SECOND = 1_000_000_000


# ---------------------------------------------------------------------------
# MPEG audio frame header (reference mpeg_audio_utils.rs)
# ---------------------------------------------------------------------------

_BITRATES = {
    (1, 1): [0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352,
             384, 416, 448],
    (1, 2): [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
             320, 384],
    (1, 3): [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
             256, 320],
    (2, 1): [0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192,
             224, 256],
    (2, 2): [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
             160],
}

_RATES = {1: (44100, 48000, 32000), 2: (22050, 24000, 16000),
          3: (11025, 12000, 8000)}


@dataclass
class FrameHeader:
    sample_rate: int
    channels: int
    layer: int
    version: int       # 1, 2, or 3 (= MPEG 2.5)
    frame_len: int
    samples_per_frame: int

    def same_format(self, other: "FrameHeader") -> bool:
        return (self.sample_rate == other.sample_rate
                and self.channels == other.channels
                and self.layer == other.layer
                and self.version == other.version)


def peek_frame_header(data: bytes) -> FrameHeader | None:
    if len(data) < 4:
        return None
    if (data[0] != 0xFF) or (data[1] & 0xE0) != 0xE0:
        return None
    version = {0b00: 3, 0b10: 2, 0b11: 1}.get((data[1] >> 3) & 0b11)
    layer = {0b01: 3, 0b10: 2, 0b11: 1}.get((data[1] >> 1) & 0b11)
    if version is None or layer is None:
        return None
    lsf = 1 if version > 1 else 0
    bitrate_idx = data[2] >> 4
    if bitrate_idx == 0b1111:
        return None
    table = _BITRATES.get((1, layer) if version == 1
                          else (2, 1) if layer == 1 else (2, 2))
    bitrate = table[bitrate_idx] * 1000
    freq_idx = (data[2] >> 2) & 0b11
    if freq_idx == 0b11:
        return None
    sample_rate = _RATES[version][freq_idx]
    channels = 1 if ((data[3] >> 6) & 0b11) == 0b11 else 2
    if bitrate:
        padding = (data[2] >> 1) & 1
        if layer == 1:
            frame_len = 4 * ((bitrate * 12) // sample_rate + padding)
        elif layer == 2:
            frame_len = (bitrate * 144) // sample_rate + padding
        else:
            frame_len = (bitrate * 144) // (sample_rate << lsf) + padding
    else:
        # free-format: look for the next matching sync header
        frame_len = len(data)
        for i in range(3, len(data) - 3):
            w = data[i:i + 4]
            if (w[0] == 0xFF and w[1] == data[1]
                    and (w[2] & 0xFD) == (data[2] & 0xFD)
                    and w[3] == data[3]):
                frame_len = i
                break
    if layer == 1:
        spf = 384
    elif layer == 2:
        spf = 1152
    else:
        spf = 1152 if version == 1 else 576
    return FrameHeader(sample_rate, channels, layer, version,
                       frame_len, spf)


# ---------------------------------------------------------------------------
# bit-level IO for the dummy-ADU side-info rewrite
# ---------------------------------------------------------------------------

class _BitReader:
    def __init__(self, data: bytes):
        self._d, self.pos = data, 0

    def read(self, n: int) -> int:
        out = 0
        for _ in range(n):
            if self.pos >= len(self._d) * 8:
                raise EOFError
            byte = self._d[self.pos >> 3]
            out = (out << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return out

    def at_end(self) -> bool:
        return self.pos >= len(self._d) * 8


class _BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def write(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def to_bytes(self) -> bytes:
        while len(self._bits) % 8:
            self._bits.append(0)
        out = bytearray()
        for i in range(0, len(self._bits), 8):
            b = 0
            for bit in self._bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


# ---------------------------------------------------------------------------
# ADU (reference depay/frames.rs)
# ---------------------------------------------------------------------------

@dataclass
class Adu:
    header: FrameHeader
    buf: bytes                    # header + side info + ADU data
    header_side_info_len: int
    backpointer: int              # main_data_begin
    data_len: int
    mp3_frame_data_capacity: int
    mp3_frame_data_len: int       # data this ADU contributes beyond bp
    interleave_index: int = 0
    interleave_cycle: int = 0
    is_dummy: bool = False
    is_discont: bool = False

    @staticmethod
    def parse(raw: bytes) -> "Adu | None":
        """Parse one unparsed ADU; raw[0]/raw[1] still hold the
        interleaving sequence number in place of the sync word."""
        if len(raw) <= 4:
            return None
        idx, cycle = raw[0], (raw[1] & 0xE0) >> 5
        buf = bytearray(raw)
        buf[0] = 0xFF
        buf[1] |= 0xE0
        buf = bytes(buf)
        header = peek_frame_header(buf)
        if header is None:
            return None
        if header.version == 1 and header.channels == 2:
            side = 32
        elif (header.version == 1 and header.channels == 1) \
                or (header.version > 1 and header.channels == 2):
            side = 17
        else:
            side = 9
        crc = buf[1] & 0x01
        if crc == 0:
            side += 2
        hsi = 4 + side
        if hsi > len(buf):
            return None
        data_len = len(buf) - hsi
        if header.layer == 3:
            # side info (and so main_data_begin) starts after the
            # optional 2-byte CRC
            si = 6 if crc == 0 else 4
            if len(buf) <= si + 2:
                return None
            if header.version > 1:      # lsf: 8-bit main_data_begin
                bp = buf[si]
            else:                       # 9-bit
                bp = ((buf[si] << 8) | buf[si + 1]) >> 7
            frame_data_len = max(0, data_len - bp)
        else:
            bp, frame_data_len = 0, data_len
        capacity = header.frame_len - hsi
        if capacity <= 0:
            # crafted/corrupt header (e.g. free-format with the next
            # sync inside the side info): no room for any data —
            # dropping it also guards the dummy-insertion loop
            return None
        return Adu(header, buf, hsi, bp, data_len,
                   capacity, frame_data_len,
                   interleave_index=idx, interleave_cycle=cycle)

    @property
    def data(self) -> bytes:
        return self.buf[self.header_side_info_len:]

    def to_dummy(self, is_first: bool, prev_adu_end: int) -> "Adu | None":
        """RFC 5219 A.2 insertDummyADUsIfNecessary: same header, the
        backpointer set to prevADUend, all part2_3_length fields 0."""
        assert self.header.layer == 3
        hsi = self.buf[:self.header_side_info_len]
        r = _BitReader(hsi)
        w = _BitWriter()
        try:
            w.write(r.read(16) | 0x01, 16)       # header, CRC unset
            w.write(r.read(16), 16)
            if (hsi[1] & 0x01) == 0:
                r.read(16)                        # skip original CRC
            lsf = self.header.version > 1
            if lsf:
                w.write(prev_adu_end, 8)
                r.read(8)
                priv = 2 if self.header.channels == 2 else 1
                w.write(r.read(priv), priv)
                granules = 1
            else:
                w.write(prev_adu_end, 9)
                r.read(9)
                priv = 3 if self.header.channels == 2 else 5
                w.write(r.read(priv), priv)
                for _ in range(self.header.channels):
                    w.write(r.read(4), 4)         # scfsi
                granules = 2
            for _ in range(granules):
                for _ in range(self.header.channels):
                    w.write(0, 12)                # part2_3_length := 0
                    r.read(12)
                    w.write(r.read(17), 17)       # big_values+global_gain
                    n = 9 if lsf else 4
                    w.write(r.read(n), n)         # scalefac_compress
                    split = r.read(1)
                    w.write(split, 1)
                    n = (2 + 1 + 10 + 9) if split else (15 + 4 + 3)
                    w.write(r.read(n), n)
                    if not lsf:
                        w.write(r.read(1), 1)     # preflag
                    w.write(r.read(2), 2)         # scalefac_scale+count1
            while not r.at_end():
                w.write(r.read(1), 1)
        except EOFError:
            return None
        return Adu(self.header, w.to_bytes(), self.header_side_info_len,
                   prev_adu_end, 0, self.mp3_frame_data_capacity, 0,
                   is_dummy=True, is_discont=is_first)


# ---------------------------------------------------------------------------
# MP3 frame assembly (reference depay/frames.rs PartialMp3Frame/AduQueue)
# ---------------------------------------------------------------------------

@dataclass
class Mp3Frame:
    data: bytes
    header: FrameHeader
    is_filler: bool
    is_discont: bool

    @property
    def duration_ns(self) -> int:
        return (self.header.samples_per_frame * SECOND
                // self.header.sample_rate)


class _PartialFrame:
    def __init__(self, adu: Adu):
        self.header = adu.header
        self.is_filler = adu.is_dummy
        self.is_discont = adu.is_discont
        self.data_capacity = adu.mp3_frame_data_capacity
        if adu.backpointer == 0 or adu.data_len == 0:
            self.buf = bytearray(adu.buf)
            self.data_offset = adu.data_len
        else:
            self.buf = bytearray(adu.buf[:adu.header_side_info_len])
            if adu.mp3_frame_data_len > 0:
                self.buf += adu.data[adu.backpointer:]
            self.data_offset = adu.mp3_frame_data_len

    def append_data(self, data: bytes, to_offset: int) -> None:
        self.buf += bytes(to_offset - self.data_offset)
        self.buf += data
        self.data_offset = to_offset + len(data)

    def terminate(self) -> Mp3Frame:
        if len(self.buf) < self.header.frame_len:
            self.buf += bytes(self.header.frame_len - len(self.buf))
        else:
            # corrupt ADU carrying more payload than its header's
            # frame length: truncate instead of crashing
            self.buf = self.buf[:self.header.frame_len]
        return Mp3Frame(bytes(self.buf), self.header, self.is_filler,
                        self.is_discont)


class AduQueue:
    """ADU -> MP3 frame conversion, RFC 5219 Appendix A.2."""

    def __init__(self):
        self._adus: list[Adu] = []

    def flush(self) -> None:
        self._adus = []

    def push_adus(self, adus: list[Adu]) -> list[Mp3Frame]:
        frames: list[Mp3Frame] = []
        for adu in adus:
            if adu.header.layer != 3:
                # no bit reservoir: pass through as-is
                frames.append(_PartialFrame(adu).terminate())
                continue
            if adu.is_discont:
                self._drain_into(frames)
            self._enqueue(adu)
            while self._adus:
                front_cap = self._adus[0].mp3_frame_data_capacity
                can_generate = False
                frame_off = 0
                for cur in self._adus:
                    end = (frame_off - cur.backpointer
                           + cur.mp3_frame_data_len)
                    if end >= front_cap:
                        can_generate = True
                        break
                    frame_off += cur.mp3_frame_data_capacity
                if not can_generate:
                    break
                f = self._generate()
                if f is not None:
                    frames.append(f)
        return frames

    def drain(self) -> list[Mp3Frame]:
        frames: list[Mp3Frame] = []
        self._drain_into(frames)
        return frames

    def _drain_into(self, frames: list[Mp3Frame]) -> None:
        while self._adus:
            f = self._generate()
            if f is not None:
                frames.append(f)

    def _enqueue(self, adu: Adu) -> None:
        if self._adus:
            prev = self._adus[-1]
            prev_end = max(0, (prev.mp3_frame_data_capacity
                               + prev.backpointer) - prev.data_len)
        else:
            prev_end = 0
        is_first = True
        inserted = 0
        while adu.backpointer > prev_end:
            if adu.mp3_frame_data_capacity <= 0 or inserted >= 64:
                return                 # cannot converge: drop the ADU
            dummy = adu.to_dummy(is_first, prev_end)
            if dummy is None:
                return
            self._adus.append(dummy)
            inserted += 1
            prev_end += adu.mp3_frame_data_capacity
            if is_first:
                adu.is_discont = False
                is_first = False
        self._adus.append(adu)

    def _generate(self) -> Mp3Frame | None:
        """RFC 5219 A.2 generateFrameFromHeadADU."""
        if not self._adus:
            return None
        front = self._adus.pop(0)
        frame = _PartialFrame(front)
        to_offset = frame.data_offset
        frame_offset = frame.data_capacity
        for cur in self._adus:
            if frame.data_offset >= frame.data_capacity:
                break
            start = frame_offset - cur.backpointer
            if start > frame.data_capacity:
                break
            if cur.data_len > 0:
                end = min(start + cur.data_len, frame.data_capacity)
                if start <= to_offset:
                    from_off = to_offset - start
                    if from_off >= min(cur.backpointer, cur.data_len):
                        frame_offset += cur.mp3_frame_data_capacity
                        continue
                    start = to_offset
                    if end < start:
                        end = start
                else:
                    to_offset = start
                    from_off = 0
                used = end - start
                frame.append_data(cur.data[from_off:from_off + used],
                                  to_offset)
                to_offset = frame.data_offset
            frame_offset += cur.mp3_frame_data_capacity
        return frame.terminate()


class DeinterleavingBuffer:
    """RFC 5219 §7 / Appendix B.2 deinterleaving
    (reference depay/deint_buf.rs)."""

    def __init__(self):
        self._adus: dict[int, Adu] = {}
        self._last_inserted: tuple[int, int] | None = None
        self._last_popped: tuple[int, int] | None = None

    def flush(self) -> None:
        self._adus = {}
        self._last_inserted = None
        self._last_popped = None

    def _pop_ready(self, out: list[Adu]) -> None:
        for idx in sorted(self._adus):
            adu = self._adus[idx]
            isn = (adu.interleave_index, adu.interleave_cycle)
            lp = self._last_popped
            if lp is None:
                discont = True
            elif isn == (255, 7) and lp == isn:
                # (255, 7) = a real sync word in place of the isn,
                # i.e. interleaving not used
                discont = False                  # not interleaved
            elif lp[1] == isn[1]:
                discont = lp[0] + 1 != isn[0]
            else:
                expected_cycle = lp[1] + 1 if lp[1] < 7 else 0
                discont = (expected_cycle != isn[1]) or isn[0] != 0
            if discont:
                adu.is_discont = True
            self._last_popped = isn
            out.append(adu)
        self._adus = {}

    def push(self, adu: Adu) -> list[Adu]:
        """Insert one ADU; returns ADUs that became ready in order."""
        ready: list[Adu] = []
        isn = (adu.interleave_index, adu.interleave_cycle)
        li = self._last_inserted
        if li is not None and (isn[1] != li[1] or isn[0] == li[0]):
            # new interleave cycle (or no interleaving): release all
            self._pop_ready(ready)
        self._last_inserted = isn
        self._adus[isn[0]] = adu
        return ready

    def drain(self) -> list[Adu]:
        out: list[Adu] = []
        self._pop_ready(out)
        return out
