"""CEA-608 closed-caption byte-pair codec (pop-on mode subset).

Re-implements the core of the reference's cea608 utilities
(video/closedcaption/src/cea608utils.rs): odd-parity byte pairs, the
basic character set, preamble address codes (PAC) and the control codes
used by pop-on captioning (RCL/ENM/EOC/EDM), plus an encoder/decoder
pair used by tttocea608 / cea608tott.

The port's copy of gstpu/codecs/cea608.py, as it stands.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# control codes (channel 1): (0x14, cc)
RCL = 0x20   # resume caption loading (pop-on)
BS_ = 0x21   # backspace
EDM = 0x2C   # erase displayed memory
CR_ = 0x2D   # carriage return (roll-up)
ENM = 0x2E   # erase non-displayed memory
EOC = 0x2F   # end of caption (flip memories)

# CEA-608 basic charset deviations from ASCII
_SPECIAL_TO_CHAR = {0x2A: "á", 0x5C: "é", 0x5E: "í", 0x5F: "ó",
                    0x60: "ú", 0x7B: "ç", 0x7C: "÷", 0x7D: "Ñ",
                    0x7E: "ñ", 0x7F: "█"}
_CHAR_TO_BYTE = {v: k for k, v in _SPECIAL_TO_CHAR.items()}


def odd_parity(b: int) -> int:
    ones = bin(b & 0x7F).count("1")
    return (b & 0x7F) | (0x80 if ones % 2 == 0 else 0)


def strip_parity(b: int) -> int | None:
    """Return the 7-bit value, or None if parity is invalid."""
    if bin(b).count("1") % 2 == 1:
        return b & 0x7F
    return None


def char_to_608(ch: str) -> int | None:
    if ch in _CHAR_TO_BYTE:
        return _CHAR_TO_BYTE[ch]
    o = ord(ch)
    if 0x20 <= o <= 0x7F and o not in _SPECIAL_TO_CHAR:
        return o
    return None


def byte_to_char(b: int) -> str:
    if b in _SPECIAL_TO_CHAR:
        return _SPECIAL_TO_CHAR[b]
    return chr(b)


def pac(row: int, column: int = 0, underline: bool = False) \
        -> tuple[int, int]:
    """Preamble address code for channel 1 (white, given row/indent)."""
    row_codes = [(0x11, 0x40), (0x11, 0x60), (0x12, 0x40), (0x12, 0x60),
                 (0x15, 0x40), (0x15, 0x60), (0x16, 0x40), (0x16, 0x60),
                 (0x17, 0x40), (0x17, 0x60), (0x10, 0x40), (0x13, 0x40),
                 (0x13, 0x60), (0x14, 0x40), (0x14, 0x60)]
    b1, b2 = row_codes[max(0, min(row, 14))]
    indent = min(column // 4, 7)
    b2 |= (0x10 | (indent << 1)) if indent else 0x00
    if underline:
        b2 |= 0x01
    return b1, b2


def control(cc: int) -> tuple[int, int]:
    return 0x14, cc


@dataclass
class Cea608Encoder:
    """Pop-on caption encoder: text in, byte pairs out (2 bytes per
    output slot, one slot per video field)."""

    def encode_popon(self, text: str, row: int = 14,
                     column: int = 0) -> list[bytes]:
        pairs: list[tuple[int, int]] = [control(RCL), control(ENM)]
        for li, line in enumerate(text.splitlines() or [""]):
            pairs.append(pac(min(row - (len(text.splitlines() or [""]))
                                 + 1 + li, 14), column))
            buf: list[int] = []
            for ch in line:
                b = char_to_608(ch)
                if b is None:
                    b = 0x20
                buf.append(b)
                if len(buf) == 2:
                    pairs.append((buf[0], buf[1]))
                    buf = []
            if buf:
                pairs.append((buf[0], 0x00))
        pairs.append(control(EOC))
        pairs.append(control(EDM))  # pre-clear for the next caption
        return [bytes([odd_parity(a), odd_parity(b)]) for a, b in pairs]

    def encode_clear(self) -> list[bytes]:
        return [bytes([odd_parity(0x14), odd_parity(EDM)])]

    def encode_rollup(self, text: str, rows: int = 2,
                      base_row: int = 14,
                      column: int = 0) -> list[bytes]:
        """Roll-up caption encoding (reference tttocea608 roll-up
        modes): RUx + CR scrolls, then a PAC at the base row and the
        new line's text."""
        ru = {2: 0x25, 3: 0x26, 4: 0x27}[max(2, min(rows, 4))]
        pairs: list[tuple[int, int]] = []
        for line in text.splitlines() or [""]:
            pairs.append(control(ru))
            pairs.append(control(CR_))
            pairs.append(pac(base_row, column))
            buf: list[int] = []
            for ch in line:
                b = char_to_608(ch)
                if b is None:
                    b = 0x20
                buf.append(b)
                if len(buf) == 2:
                    pairs.append((buf[0], buf[1]))
                    buf = []
            if buf:
                pairs.append((buf[0], 0x00))
        return [bytes([odd_parity(a), odd_parity(b)])
                for a, b in pairs]


@dataclass
class Cea608Decoder:
    """Byte-pair decoder: accumulates pop-on captions, yields the
    displayed text at EOC."""

    _building: list[str] = field(default_factory=list)
    _line: list[str] = field(default_factory=list)
    _displayed: str | None = None
    _last_pair: tuple[int, int] | None = None

    def push_pair(self, data: bytes) -> str | None:
        """Feed one 2-byte pair; returns newly displayed text at EOC."""
        if len(data) < 2:
            return None
        a, b = strip_parity(data[0]), strip_parity(data[1])
        if a is None or b is None:
            return None
        # control-code doubling: a repeated CONTROL pair is ignored
        # (0x10-0x1F first byte only — printable pairs may repeat)
        if (a, b) == self._last_pair and 0x10 <= a <= 0x1F:
            self._last_pair = None
            return None
        self._last_pair = (a, b)
        if a == 0x14 and 0x20 <= b <= 0x2F:
            return self._control(b)
        if 0x10 <= a <= 0x17:  # PAC / midrow: starts a new line
            if self._line:
                self._building.append("".join(self._line))
                self._line = []
            return None
        out = None
        for byte in (a, b):
            if byte >= 0x20:
                self._line.append(byte_to_char(byte))
        return out

    def _control(self, cc: int) -> str | None:
        if cc == RCL:
            self._building = []
            self._line = []
        elif cc == ENM:
            self._building = []
            self._line = []
        elif cc == BS_:
            if self._line:
                self._line.pop()
        elif cc == EOC:
            if self._line:
                self._building.append("".join(self._line))
                self._line = []
            self._displayed = "\n".join(self._building)
            self._building = []
            return self._displayed
        elif cc == EDM:
            self._displayed = None
        return None
