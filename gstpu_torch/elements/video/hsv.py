"""hsvfilter: per-pixel HSV adjust of packed RGB-family video.

The port of gstpu's hsvfilter (gstpu/elements/video/hsv.py) on
tensors: a host frame is uploaded once to the device, the frame is
processed where it lies (the CUDA kernel on a CUDA tensor, the plain
version on a CPU tensor), and the result stays a tensor in `buf.data`.
"""

from __future__ import annotations

import torch

from gstpu_torch.core.base import VideoFilter
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.device import default_device
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import video_caps
from gstpu_torch.ops.hsv import hsv_filter_frame

# channel layout: (color offsets (r,g,b), alpha offset or None)
_LAYOUTS = {
    "RGB": ((0, 1, 2), None), "BGR": ((2, 1, 0), None),
    "RGBx": ((0, 1, 2), None), "BGRx": ((2, 1, 0), None),
    "RGBA": ((0, 1, 2), 3), "BGRA": ((2, 1, 0), 3),
    "xRGB": ((1, 2, 3), None), "xBGR": ((3, 2, 1), None),
    "ARGB": ((1, 2, 3), 0), "ABGR": ((3, 2, 1), 0),
}

_FILTER_FORMATS = tuple(_LAYOUTS)


@register_element("hsvfilter", Rank.NONE)
class HsvFilter(VideoFilter):
    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=_FILTER_FORMATS)),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=_FILTER_FORMATS)),
    ]

    hue_shift = Property(float, default=0.0, mutable=Mutability.PLAYING,
                         blurb="Hue shift in degrees")
    saturation_mul = Property(float, default=1.0,
                              mutable=Mutability.PLAYING)
    saturation_off = Property(float, default=0.0,
                              mutable=Mutability.PLAYING)
    value_mul = Property(float, default=1.0, mutable=Mutability.PLAYING)
    value_off = Property(float, default=0.0, mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self._device: torch.device | None = None

    def start(self) -> bool:
        self._device = default_device()
        return True

    def transform_ip(self, buf: Buffer) -> None:
        info = self.video_info
        frame = info.tensor(buf, self._device)
        # a frame uploaded just now is ours to overwrite; a tensor that
        # came in, or a CPU tensor sharing the host array, is not
        owned = frame.device.type == "cuda" \
            and not isinstance(buf.data, torch.Tensor)
        (r, g, b), _ = _LAYOUTS[info.format]
        buf.data = hsv_filter_frame(
            frame, (r, g, b), self.hue_shift, self.saturation_mul,
            self.saturation_off, self.value_mul, self.value_off,
            out=frame if owned else None)
