"""compositor / skiacompositor: N video inputs alpha-blended onto a
canvas.

The port of gstpu's compositor (gstpu/elements/video/compositor.py):
the same pads and properties, with the canvas a u8 tensor on the
device. The background is made once per size and uploaded; each layer
is blended into its region of the canvas in place by `_blend`, torch
ops that build the f32 arithmetic XLA compiles gstpu's jitted blend to
on the CPU:

    la  = a * f32(alpha * f32(1/255))      (XLA folds the scalar first)
    out = region * (1 - la) + rgb * la     (one product fused: an FMA)

then round half to even, clip and cast. Each pad's frame becomes RGB
by videoconvert's arithmetic in torch ops (`to_rgb_tensor`) where it
lies, a host frame after one upload. The optimised HLO is the same
for every shape, but LLVM contracts the sum into an FMA with the layer's
product where the layer is a region of the canvas (the in-place
dynamic-update-slice loop) and with the canvas's product where the layer
covers the whole canvas (a plain elementwise loop); tests/
test_torch_compositor.py holds both forms against gstpu. The FMA is done
exactly in f64 and rounded once to f32 (`ops.fma_f32`). A pad with its
own width/height is resized by videoscale's `_resize` (linear) on the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from gstpu_torch.core.base import Aggregator, AggregatorPad
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.device import default_device
from gstpu_torch.core.element import (FlowReturn, PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import VideoInfo, video_caps
from gstpu_torch.elements.video.convert import to_rgb_tensor
from gstpu_torch.elements.video.scale import _resize
from gstpu_torch.ops import fma_f32

SECOND = 1_000_000_000
_INV_255 = np.float32(1.0) / np.float32(255.0)


def _blend(canvas: torch.Tensor, layer_rgba: torch.Tensor, y0: int, x0: int,
           alpha: float) -> torch.Tensor:
    """Alpha-blend one (h, w, 4) u8 RGBA layer onto the (H, W, 3) u8
    canvas at (y0, x0), in place; returns the canvas."""
    h, w = layer_rgba.shape[:2]
    region = canvas[y0:y0 + h, x0:x0 + w]
    scale = float(np.float32(alpha) * _INV_255)
    la = layer_rgba[..., 3:4].to(torch.float32) * scale
    keep = 1.0 - la
    bg, fg = region.to(torch.float32), layer_rgba[..., :3].to(torch.float32)
    if (h, w) == tuple(canvas.shape[:2]):
        out = fma_f32(bg, keep, fg * la)
    else:
        out = fma_f32(fg, la, bg * keep)
    region.copy_(torch.clamp(torch.round(out), 0, 255).to(canvas.dtype))
    return canvas


class CompositorPad(AggregatorPad):
    """Sink pad with placement properties (reference compositor pad:
    xpos/ypos/width/height/alpha)."""

    def __init__(self, name, template, element):
        super().__init__(name, template, element)
        self.xpos = 0
        self.ypos = 0
        self.width = 0        # 0 = native
        self.height = 0
        self.alpha = 1.0


@register_element("compositor", Rank.NONE)
class Compositor(Aggregator):
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("RGB",))),
        PadTemplate("sink_%u", PadDirection.SINK,
                    PadPresence.REQUEST,
                    video_caps(formats=("RGB", "RGBA", "GRAY8",
                                        "I420"))),
    ]
    PAD_CLASS = CompositorPad

    background = Property(str, default="black",
                          mutable=Mutability.READY,
                          enum_values=("black", "white", "checker",
                                       "transparent"),
                          blurb="Canvas fill (reference background)")
    width = Property(int, default=0, minimum=0, maximum=16384,
                     mutable=Mutability.READY,
                     blurb="Output width (0 = max of inputs)")
    height = Property(int, default=0, minimum=0, maximum=16384,
                      mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._out_info: VideoInfo | None = None
        self._frame_n = 0
        self._bg: tuple | None = None      # (key, canvas tensor)

    def request_pad(self, name=None):
        n = sum(1 for p in self.pads.values()
                if p.direction is PadDirection.SINK)
        pad = CompositorPad(f"sink_{n}", self.PAD_TEMPLATES[1], self)
        self.add_pad(pad)
        return pad

    # -- canvas ----------------------------------------------------------
    def _canvas_size(self) -> tuple[int, int]:
        if self.width and self.height:
            return self.width, self.height
        w = h = 0
        for pad in self.agg_sink_pads():
            if pad.current_caps is None:
                continue
            s = pad.current_caps[0]
            pw = int(pad.width or s.get("width", 0))
            ph = int(pad.height or s.get("height", 0))
            w = max(w, pad.xpos + pw)
            h = max(h, pad.ypos + ph)
        return (self.width or w), (self.height or h)

    def _background(self, w: int, h: int) -> np.ndarray:
        if self.background == "white":
            return np.full((h, w, 3), 255, np.uint8)
        if self.background == "checker":
            yy, xx = np.mgrid[0:h, 0:w]
            cells = ((yy // 8 + xx // 8) % 2) * 64 + 96
            return np.repeat(cells[..., None], 3, -1).astype(np.uint8)
        return np.zeros((h, w, 3), np.uint8)   # black / transparent

    def _canvas(self, w: int, h: int, device) -> torch.Tensor:
        """A fresh canvas: a copy of the background, uploaded once per
        size."""
        key = (w, h, self.background, str(device))
        if self._bg is None or self._bg[0] != key:
            self._bg = (key, torch.from_numpy(self._background(w, h))
                        .to(device))
        return self._bg[1].clone()

    def negotiate_src_caps(self) -> Caps:
        w, h = self._canvas_size()
        return Caps.new("video/x-raw", format="RGB", width=w,
                        height=h)

    # -- aggregation --------------------------------------------------------
    def aggregate(self, timeout: bool) -> FlowReturn:
        pads = [p for p in self.agg_sink_pads()]
        if not pads or any(p.current_caps is None for p in pads):
            return FlowReturn.OK
        # one frame per pad per output frame
        bufs = {}
        for p in pads:
            b = p.pop_buffer()
            if b is not None:
                bufs[p.name] = (p, b)
        if not bufs:
            return FlowReturn.OK
        w, h = self._canvas_size()
        if self._out_info is None:
            self._out_info = VideoInfo("RGB", w, h)
        dev = default_device()
        canvas = self._canvas(w, h, dev)
        pts = None
        for p, b in bufs.values():
            if pts is None:
                pts = b.pts
            info = VideoInfo.from_caps(p.current_caps)
            rgb = to_rgb_tensor(info, b, dev).to(dev)
            if (p.width and p.width != info.width) or \
                    (p.height and p.height != info.height):
                tw = p.width or info.width
                th = p.height or info.height
                rgb = _resize(rgb, th, tw, "linear")
            lh, lw = rgb.shape[:2]
            # clip the layer to the canvas
            x0, y0 = max(0, p.xpos), max(0, p.ypos)
            if x0 >= w or y0 >= h:
                continue
            lw = min(lw, w - x0)
            lh = min(lh, h - y0)
            rgba = torch.cat(
                [rgb[:lh, :lw],
                 torch.full((lh, lw, 1), 255, dtype=torch.uint8,
                            device=dev)], dim=-1)
            canvas = _blend(canvas, rgba, y0, x0, p.alpha)
        out = Buffer(canvas, pts=pts, duration=SECOND // 30)
        self._frame_n += 1
        return self.srcpad.push(out)

    def drain(self) -> None:
        self.aggregate(timeout=False)


@register_element("skiacompositor", Rank.NONE)
class SkiaCompositor(Compositor):
    """Reference-exact name alias: the skia raster library is
    env-gated, the compositing runs as the torch ops above."""
