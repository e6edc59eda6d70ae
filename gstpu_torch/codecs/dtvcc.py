"""CEA-708 DTVCC service decoder: the full window/pen state machine.

Rebuilds the reference's 708 caption model (video/closedcaption/src/
cea708utils.rs, ~1.5k LoC): 8 windows per service with define/clear/
display/hide/toggle/delete lifecycles, pen location/attributes/color,
window attributes (justify, print/scroll direction, wordwrap), the
C0/C1/G0/G1 + EXT1 (C2/G2/C3/G3) code space, carriage-return
scrolling and anchor-point geometry.  `Service708.feed()` consumes
service-block payloads (gstpu_torch.codecs.cea708.parse_dtvcc yields them)
and maintains renderable character grids; cea708overlay draws every
visible window.

Bit layouts follow CEA-708-D §8.10 (DefineWindow), §8.11 (SetWindow
Attributes), §8.12-8.14 (SetPenAttributes/Color/Location).

The port's copy of gstpu/codecs/dtvcc.py, as it stands.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# C1 opcodes
CW0 = 0x80           # ..0x87: set current window
CLW, DSW, HDW, TGW, DLW = 0x88, 0x89, 0x8A, 0x8B, 0x8C
DLY, DLC, RST = 0x8D, 0x8E, 0x8F
SPA, SPC, SPL, SWA = 0x90, 0x91, 0x92, 0x97
DF0 = 0x98           # ..0x9F: define window

# G2 mappings reachable via EXT1 (CEA-708 table 27, common subset)
G2 = {0x20: "℠", 0x21: " ", 0x25: "…", 0x2A: "Š",
      0x2C: "Œ", 0x30: "█", 0x31: "‘", 0x32: "’",
      0x33: "“", 0x34: "”", 0x35: "•", 0x39: "™",
      0x3A: "š", 0x3C: "œ", 0x3D: "℠", 0x3F: "Ÿ",
      0x76: "⅛", 0x77: "⅜", 0x78: "⅝", 0x79: "⅞",
      0x7A: "│", 0x7B: "┐", 0x7C: "└", 0x7D: "─",
      0x7E: "┘", 0x7F: "┌"}


@dataclass
class Pen:
    row: int = 0
    col: int = 0
    size: int = 1            # 0 small 1 standard 2 large
    italics: bool = False
    underline: bool = False
    fg: int = 0x3F           # 2:2:2 RGB white
    bg: int = 0x00
    fg_opacity: int = 0
    bg_opacity: int = 0


@dataclass
class Window:
    defined: bool = False
    visible: bool = False
    priority: int = 3
    relative: bool = False
    anchor_v: int = 0
    anchor_h: int = 0
    anchor_point: int = 0
    rows: int = 1
    cols: int = 32
    row_lock: bool = False
    col_lock: bool = False
    justify: int = 0         # 0 left 1 right 2 center 3 full
    print_dir: int = 0       # 0 LTR
    scroll_dir: int = 3      # 3 bottom-to-top (default caption style)
    wordwrap: bool = False
    fill_color: int = 0
    fill_opacity: int = 0
    pen: Pen = field(default_factory=Pen)
    grid: list = field(default_factory=list)   # rows of [char]
    attrs_grid: list = field(default_factory=list)

    def resize(self):
        self.grid = [[" "] * self.cols for _ in range(self.rows)]
        self.attrs_grid = [[None] * self.cols for _ in range(self.rows)]

    def clear(self):
        for r in self.grid:
            for i in range(len(r)):
                r[i] = " "
        for r in self.attrs_grid:
            for i in range(len(r)):
                r[i] = None

    def text_rows(self) -> list[str]:
        return ["".join(r).rstrip() for r in self.grid]

    def text(self) -> str:
        rows = self.text_rows()
        while rows and not rows[0]:
            rows.pop(0)
        while rows and not rows[-1]:
            rows.pop()
        return "\n".join(rows)


class Service708:
    """One DTVCC service interpreter (reference Cea708ServiceState)."""

    def __init__(self):
        self.windows = [Window() for _ in range(8)]
        self.current = 0
        self.updated = False

    # -- helpers ---------------------------------------------------------
    @property
    def win(self) -> Window:
        return self.windows[self.current]

    def _put(self, ch: str) -> None:
        w = self.win
        if not w.defined:
            # decoder tolerance: text before any DefineWindow lands in
            # a default visible bottom window (sloppy streams do this)
            w.defined = True
            w.visible = True
            w.rows, w.cols = 2, 32
            w.anchor_point, w.anchor_v, w.anchor_h = 8, 74, 105
            w.resize()
        if w.pen.col >= w.cols:
            if w.wordwrap or True:
                # implicit CR at row end (printable overflow)
                self._carriage_return()
        if w.pen.row < w.rows and w.pen.col < w.cols:
            w.grid[w.pen.row][w.pen.col] = ch
            w.attrs_grid[w.pen.row][w.pen.col] = (
                w.pen.fg, w.pen.bg, w.pen.italics, w.pen.underline)
            w.pen.col += 1
            self.updated = True

    def _carriage_return(self) -> None:
        w = self.win
        w.pen.col = 0
        if w.scroll_dir == 3:            # bottom-to-top
            if w.pen.row + 1 < w.rows:
                w.pen.row += 1
            else:
                w.grid.pop(0)
                w.grid.append([" "] * w.cols)
                w.attrs_grid.pop(0)
                w.attrs_grid.append([None] * w.cols)
        else:                            # top-to-bottom and others
            if w.pen.row + 1 < w.rows:
                w.pen.row += 1
            else:
                w.grid.pop()
                w.grid.insert(0, [" "] * w.cols)
                w.attrs_grid.pop()
                w.attrs_grid.insert(0, [None] * w.cols)
        self.updated = True

    # -- command interpretation -------------------------------------------
    def feed(self, data: bytes) -> None:
        i = 0
        n = len(data)
        while i < n:
            b = data[i]
            if b == 0x00 or b == 0x03:           # NUL / ETX
                i += 1
            elif b == 0x08:                       # BS
                w = self.win
                if w.pen.col > 0:
                    w.pen.col -= 1
                    if w.defined:
                        w.grid[w.pen.row][w.pen.col] = " "
                i += 1
                self.updated = True
            elif b == 0x0C:                       # FF: clear + home
                w = self.win
                if w.defined:
                    w.clear()
                w.pen.row = w.pen.col = 0
                i += 1
                self.updated = True
            elif b == 0x0D:                       # CR
                self._carriage_return()
                i += 1
            elif b == 0x0E:                       # HCR: erase row
                w = self.win
                w.pen.col = 0
                if w.defined and w.pen.row < w.rows:
                    for c in range(w.cols):
                        w.grid[w.pen.row][c] = " "
                i += 1
                self.updated = True
            elif b == 0x10:                       # EXT1
                i += 1
                if i < n:
                    e = data[i]
                    if 0x20 <= e <= 0x7F:         # G2
                        self._put(G2.get(e, "_"))
                        i += 1
                    elif 0x80 <= e <= 0x9F:       # C2/C3 skip w/ len
                        if e <= 0x87:
                            i += 1
                        elif e <= 0x8F:
                            i += 2
                        elif e <= 0x97:
                            i += 3
                        else:
                            i += 4
                    else:                         # G3
                        self._put("™" if e == 0xA0 else "_")
                        i += 1
            elif b < 0x20:
                i += 1
            elif b <= 0x7F:                       # G0
                self._put("♪" if b == 0x7F else chr(b))
                i += 1
            elif b <= 0x9F:                       # C1
                i = self._c1(data, i)
            else:                                 # G1 Latin-1
                self._put(bytes([b]).decode("latin-1"))
                i += 1

    def _c1(self, data: bytes, i: int) -> int:
        b = data[i]
        if CW0 <= b <= 0x87:                      # CurrentWindow
            self.current = b - CW0
            return i + 1
        if b in (CLW, DSW, HDW, TGW, DLW):
            bitmap = data[i + 1] if i + 1 < len(data) else 0
            for k in range(8):
                if not bitmap & (1 << k):
                    continue
                w = self.windows[k]
                if b == CLW:
                    w.clear()
                elif b == DSW:
                    w.visible = True
                elif b == HDW:
                    w.visible = False
                elif b == TGW:
                    w.visible = not w.visible
                elif b == DLW:
                    self.windows[k] = Window()
            self.updated = True
            return i + 2
        if b == DLY:
            return i + 2                          # delay: ignored
        if b == DLC:
            return i + 1
        if b == RST:
            self.__init__()
            return i + 1
        if b == SPA:                              # CEA-708 §8.12
            if i + 2 < len(data):
                p = self.win.pen
                b1, b2 = data[i + 1], data[i + 2]
                p.size = b1 & 0x3
                p.italics = bool(b2 & 0x80)
                p.underline = bool(b2 & 0x40)
            self.updated = True
            return i + 3
        if b == SPC:                              # §8.13
            if i + 3 < len(data):
                p = self.win.pen
                b1, b2 = data[i + 1], data[i + 2]
                p.fg_opacity = b1 >> 6
                p.fg = b1 & 0x3F
                p.bg_opacity = b2 >> 6
                p.bg = b2 & 0x3F
            self.updated = True
            return i + 4
        if b == SPL:                              # §8.14
            if i + 2 < len(data):
                w = self.win
                w.pen.row = min(data[i + 1] & 0x0F, max(w.rows - 1, 0))
                w.pen.col = min(data[i + 2] & 0x3F, max(w.cols - 1, 0))
            return i + 3
        if b == SWA:                              # §8.11
            if i + 4 < len(data):
                w = self.win
                b1, b2, b3, _b4 = data[i + 1:i + 5]
                w.fill_opacity = b1 >> 6
                w.fill_color = b1 & 0x3F
                w.wordwrap = bool(b3 & 0x40)
                w.print_dir = (b3 >> 4) & 0x3
                w.scroll_dir = (b3 >> 2) & 0x3
                w.justify = b3 & 0x3
            self.updated = True
            return i + 5
        if DF0 <= b <= 0x9F:                      # DefineWindow §8.10
            if i + 6 < len(data):
                idx = b - DF0
                w = self.windows[idx]
                b1, b2, b3, b4, b5, b6 = data[i + 1:i + 7]
                was = (w.defined, w.rows, w.cols)
                w.visible = bool(b1 & 0x20)
                w.row_lock = bool(b1 & 0x10)
                w.col_lock = bool(b1 & 0x08)
                w.priority = b1 & 0x7
                w.relative = bool(b2 & 0x80)
                w.anchor_v = b2 & 0x7F
                w.anchor_h = b3
                w.anchor_point = b4 >> 4
                w.rows = (b4 & 0x0F) + 1
                w.cols = (b5 & 0x3F) + 1
                # b6: window style(3)/pen style(3) — defaults kept
                if was != (True, w.rows, w.cols):
                    w.resize()
                    w.pen = Pen()
                w.defined = True
                self.current = idx
                self.updated = True
            return i + 7
        return i + 1                              # unknown C1


class DtvccDecoder:
    """Multi-service DTVCC decoder fed with cc_data triplets or DTVCC
    packets; exposes per-service Service708 states."""

    def __init__(self):
        self.services: dict[int, Service708] = {}
        self._packet = bytearray()

    def service(self, n: int) -> Service708:
        if n not in self.services:
            self.services[n] = Service708()
        return self.services[n]

    def feed_cc_data(self, cc_data: bytes) -> None:
        """cc_data triplets (marker|type byte, b1, b2): reassemble
        DTVCC packets from type 3 (start) / type 2 (continue)."""
        for off in range(0, len(cc_data) - 2, 3):
            byte0, b1, b2 = cc_data[off:off + 3]
            if not byte0 & 0x04:                 # cc_valid
                continue
            t = byte0 & 0x3
            if t == 3:                           # packet start
                self._flush_packet()
                self._packet = bytearray([b1, b2])
            elif t == 2 and self._packet:        # packet data
                self._packet += bytes([b1, b2])
        self._flush_packet()

    def _flush_packet(self) -> None:
        if not self._packet:
            return
        from gstpu_torch.codecs.cea708 import parse_dtvcc
        try:
            _seq, blocks = parse_dtvcc(bytes(self._packet))
        except Exception:
            self._packet = bytearray()
            return
        for svc, payload in blocks:
            self.service(svc).feed(payload)
        self._packet = bytearray()

    def visible_windows(self, svc: int = 1):
        """[(Window, text)] for the service's visible windows, by
        priority."""
        s = self.services.get(svc)
        if s is None:
            return []
        wins = [(w, w.text()) for w in s.windows
                if w.defined and w.visible and w.text()]
        wins.sort(key=lambda t: t[0].priority)
        return wins
