"""CD+G (karaoke graphics) decoder core.

Re-implements the CD+G subcode decoder behind the reference cdgdec
(video/cdg, cdg + cdg_renderer crates): 24-byte subcode packets
driving a 300x216 indexed-color screen (6x12 tiles, 16-color table,
scrolling, XOR tiles).

The port's copy of gstpu/codecs/cdg.py, as it stands.
"""

from __future__ import annotations

import numpy as np

PACKET_SIZE = 24
WIDTH, HEIGHT = 300, 216
TILE_W, TILE_H = 6, 12
PACKETS_PER_SECOND = 300

CMD_CDG = 9
INSN_MEMORY_PRESET = 1
INSN_BORDER_PRESET = 2
INSN_TILE_NORMAL = 6
INSN_SCROLL_PRESET = 20
INSN_SCROLL_COPY = 24
INSN_TRANSPARENT = 28
INSN_COLORS_LOW = 30
INSN_COLORS_HIGH = 31
INSN_TILE_XOR = 38


class CdgDecoder:
    """Stateful screen; feed 24-byte packets, returns True when the
    visible screen changed."""

    def __init__(self):
        self.screen = np.zeros((HEIGHT, WIDTH), np.uint8)
        self.palette = np.zeros((16, 3), np.uint8)
        self.border_color = 0

    def push_packet(self, pkt: bytes) -> bool:
        if len(pkt) < PACKET_SIZE or (pkt[0] & 0x3F) != CMD_CDG:
            return False
        insn = pkt[1] & 0x3F
        data = bytes(b & 0x3F for b in pkt[4:20])
        if insn == INSN_MEMORY_PRESET:
            if data[1] & 0x0F:  # repeat packet: already applied
                return False
            self.screen[:] = data[0] & 0x0F
            return True
        if insn == INSN_BORDER_PRESET:
            self.border_color = data[0] & 0x0F
            return True
        if insn in (INSN_TILE_NORMAL, INSN_TILE_XOR):
            return self._tile(data, xor=insn == INSN_TILE_XOR)
        if insn in (INSN_COLORS_LOW, INSN_COLORS_HIGH):
            base = 0 if insn == INSN_COLORS_LOW else 8
            for i in range(8):
                b0, b1 = data[2 * i], data[2 * i + 1]
                r = (b0 >> 2) & 0x0F
                g = ((b0 & 0x03) << 2) | ((b1 >> 4) & 0x03)
                b = b1 & 0x0F
                self.palette[base + i] = (r * 17, g * 17, b * 17)
            return True
        if insn in (INSN_SCROLL_PRESET, INSN_SCROLL_COPY):
            return self._scroll(data, copy=insn == INSN_SCROLL_COPY)
        return False

    def _tile(self, data: bytes, xor: bool) -> bool:
        c0 = data[0] & 0x0F
        c1 = data[1] & 0x0F
        row = (data[2] & 0x1F) * TILE_H
        col = (data[3] & 0x3F) * TILE_W
        if row + TILE_H > HEIGHT or col + TILE_W > WIDTH:
            return False
        bits = np.unpackbits(
            np.frombuffer(data[4:16], np.uint8).reshape(-1, 1),
            axis=1)[:, 2:8]  # low 6 bits of each row byte
        tile = np.where(bits == 1, c1, c0).astype(np.uint8)
        region = self.screen[row:row + TILE_H, col:col + TILE_W]
        if xor:
            region ^= tile
        else:
            region[:] = tile
        return True

    def _scroll(self, data: bytes, copy: bool) -> bool:
        color = data[0] & 0x0F
        h_cmd, h_off = (data[1] >> 4) & 0x03, data[1] & 0x07
        v_cmd, v_off = (data[2] >> 4) & 0x03, data[2] & 0x0F
        dx = {0: 0, 1: -TILE_W, 2: TILE_W}.get(h_cmd, 0)
        dy = {0: 0, 1: -TILE_H, 2: TILE_H}.get(v_cmd, 0)
        if dx == 0 and dy == 0:
            return False
        s = np.roll(self.screen, (dy, dx), axis=(0, 1))
        if not copy:  # preset: fill the wrapped-in region with color
            if dy > 0:
                s[:dy, :] = color
            elif dy < 0:
                s[dy:, :] = color
            if dx > 0:
                s[:, :dx] = color
            elif dx < 0:
                s[:, dx:] = color
        self.screen = s
        return True

    def render_rgb(self) -> np.ndarray:
        """(216, 300, 3) RGB frame of the current screen."""
        return self.palette[self.screen]
