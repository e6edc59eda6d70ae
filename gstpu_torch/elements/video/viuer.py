"""viuersink: render video frames into the terminal.

Rebuilds the reference video/viuer viuersink (the viuer crate prints
frames with ANSI half-block cells, optionally kitty/iTerm/sixel
protocols). The ANSI truecolor half-block renderer — two vertical
pixels per character cell via '▀' with independent fg/bg colors — is
implemented here directly; kitty/iTerm/sixel remain env-gated (no
such terminal attached). Output goes to a configurable stream/file
so tests can assert the escape sequences.

The port's copy of gstpu/elements/video/viuer.py, as it stands.
"""

from __future__ import annotations

import sys

import numpy as np

from gstpu_torch.core.base import BaseSink
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowReturn, PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import VideoInfo, video_caps

UPPER_HALF = "▀"


def render_ansi_halfblocks(rgb: np.ndarray) -> str:
    """(H, W, 3) uint8 -> ANSI truecolor half-block art (the viuer
    crate's default printer): each character covers two rows, fg =
    upper pixel, bg = lower pixel."""
    h, w = rgb.shape[:2]
    if h % 2:
        rgb = np.concatenate([rgb, np.zeros((1, w, 3), np.uint8)])
        h += 1
    top = rgb[0::2]
    bot = rgb[1::2]
    lines = []
    for y in range(h // 2):
        cells = []
        for x in range(w):
            tr, tg, tb = (int(v) for v in top[y, x])
            br, bg_, bb = (int(v) for v in bot[y, x])
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg_};{bb}m{UPPER_HALF}")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines) + "\n"


@register_element("viuersink", Rank.NONE)
class ViuerSink(BaseSink):
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS,
                                 video_caps(formats=("RGB", "RGBA",
                                                     "GRAY8", "I420")))]

    width = Property(int, default=80, minimum=1, maximum=1024,
                     mutable=Mutability.READY,
                     blurb="Terminal cells across (reference width)")
    height = Property(int, default=0, minimum=0, maximum=1024,
                      mutable=Mutability.READY,
                      blurb="Terminal rows (0 = keep aspect)")
    truecolor = Property(bool, default=True, mutable=Mutability.READY)
    file = Property(str, default=None, mutable=Mutability.READY,
                    blurb="Write frames here instead of stdout "
                          "(tests; the reference prints to the tty)")

    def __init__(self, name=None):
        super().__init__(name)
        self._out = None
        self._info: VideoInfo | None = None

    def start(self) -> bool:
        self._out = open(self.file, "w") if self.file else sys.stdout
        return True

    def stop(self) -> bool:
        if self._out is not None and self._out is not sys.stdout:
            self._out.close()
        self._out = None
        return True

    def on_caps(self, caps: Caps) -> None:
        self._info = VideoInfo.from_caps(caps)

    def _to_rgb(self, buf: Buffer) -> np.ndarray:
        from gstpu_torch.elements.video.convert import _to_rgb
        return _to_rgb(self._info, buf)

    def render(self, buf: Buffer):
        if self._info is None:
            return FlowReturn.OK
        rgb = self._to_rgb(buf)
        h, w = rgb.shape[:2]
        tw = min(self.width, 1024)
        # 2 pixels per cell row; keep aspect unless height forced
        th = self.height * 2 if self.height \
            else max(2, round(h * tw / w / 2) * 2)
        ys = (np.linspace(0, h - 1, th)).astype(int)
        xs = (np.linspace(0, w - 1, tw)).astype(int)
        small = rgb[ys][:, xs]
        self._out.write("\x1b[H" if self._out is sys.stdout else "")
        self._out.write(render_ansi_halfblocks(small))
        self._out.flush()
        return FlowReturn.OK
