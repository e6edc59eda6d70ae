"""videoconvert: raw video format conversion (core plumbing the
reference gets from GStreamer's C videoconvert; needed for standalone
pipelines here). Packed RGB family <-> I420 <-> GRAY8, BT.601
full-range like gstpu's videotestsrc.

The port's copy of gstpu's host element (gstpu/elements/video/
convert.py): numpy on the host, as there; a tensor payload is read
through `Buffer.array`. `to_rgb_tensor` is `_to_rgb` in torch ops on the
frame's device, the same f32 arithmetic and bytes, for the compositor's
layers."""

from __future__ import annotations

import numpy as np
import torch

from gstpu_torch.core.base import VideoFilter
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, Structure
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import (PACKED_FORMATS, VideoInfo, video_caps)
from gstpu_torch.elements.generic.testsrc import _rgb_to_i420
from gstpu_torch.elements.video.scale import i420_planes, payload_bytes

_FORMATS = ("RGBA", "BGRA", "ARGB", "ABGR", "RGBx", "BGRx", "xRGB",
            "xBGR", "RGB", "BGR", "GRAY8", "I420")

_RGB_ORDER = {
    "RGBA": (0, 1, 2), "BGRA": (2, 1, 0), "ARGB": (1, 2, 3),
    "ABGR": (3, 2, 1), "RGBx": (0, 1, 2), "BGRx": (2, 1, 0),
    "xRGB": (1, 2, 3), "xBGR": (3, 2, 1), "RGB": (0, 1, 2),
    "BGR": (2, 1, 0),
}


def _to_rgb(info: VideoInfo, buf: Buffer) -> np.ndarray:
    """Any supported format -> (H, W, 3) RGB uint8."""
    fmt = info.format
    if fmt in _RGB_ORDER:
        frame = info.view(buf)
        r, g, b = _RGB_ORDER[fmt]
        return np.stack([frame[..., r], frame[..., g], frame[..., b]],
                        axis=-1)
    if fmt == "GRAY8":
        y = info.view(buf)[..., 0]
        return np.repeat(y[..., None], 3, axis=-1)
    if fmt == "I420":
        y, u, v = info.planes(buf)
        h, w = info.height, info.width
        uf = np.repeat(np.repeat(u, 2, 0), 2, 1)[:h, :w] \
            .astype(np.float32) - 128.0
        vf = np.repeat(np.repeat(v, 2, 0), 2, 1)[:h, :w] \
            .astype(np.float32) - 128.0
        yf = y.astype(np.float32)
        r = yf + 1.402 * vf
        g = yf - 0.344136 * uf - 0.714136 * vf
        b = yf + 1.772 * uf
        return np.clip(np.stack([r, g, b], -1), 0, 255) \
            .round().astype(np.uint8)
    raise ValueError(f"videoconvert: cannot read {fmt}")


def to_rgb_tensor(info: VideoInfo, buf: Buffer, device) -> torch.Tensor:
    """`_to_rgb` as torch ops where the frame lies (a host frame after one
    upload to `device`): (H, W, 3) u8, the same bytes."""
    fmt, h, w = info.format, info.height, info.width
    if fmt in _RGB_ORDER:
        frame = payload_bytes(buf, device).reshape(h, w, PACKED_FORMATS[fmt])
        return frame[..., list(_RGB_ORDER[fmt])]
    if fmt == "GRAY8":
        return payload_bytes(buf, device).reshape(h, w, 1).repeat(1, 1, 3)
    if fmt == "I420":
        y, u, v = i420_planes(info, buf, device)

        def chroma(p):
            return p.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w] \
                .to(torch.float32) - 128.0
        uf, vf = chroma(u), chroma(v)
        yf = y.to(torch.float32)
        # f32 products with the f32-rounded constants, as numpy's
        r = yf + vf * 1.402
        g = yf - uf * 0.344136 - vf * 0.714136
        b = yf + uf * 1.772
        return torch.round(torch.clamp(torch.stack([r, g, b], -1), 0, 255)) \
            .to(torch.uint8)
    raise ValueError(f"videoconvert: cannot read {fmt}")


def _from_rgb(rgb: np.ndarray, fmt: str) -> np.ndarray:
    h, w = rgb.shape[:2]
    if fmt in _RGB_ORDER:
        n = PACKED_FORMATS[fmt]
        out = np.full((h, w, n), 255, np.uint8)
        r, g, b = _RGB_ORDER[fmt]
        out[..., r], out[..., g], out[..., b] = (rgb[..., 0], rgb[..., 1],
                                                 rgb[..., 2])
        return out.reshape(-1)
    if fmt == "GRAY8":
        y = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
             + 0.114 * rgb[..., 2])
        return y.round().astype(np.uint8).reshape(-1)
    if fmt == "I420":
        return _rgb_to_i420(rgb)
    raise ValueError(f"videoconvert: cannot write {fmt}")


@register_element("videoconvert", Rank.PRIMARY)
class VideoConvert(VideoFilter):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=_FORMATS)),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=_FORMATS)),
    ]

    def transform_caps(self, direction, caps, filter):
        def repl(s: Structure):
            if s.name != "video/x-raw":
                return None
            s["format"] = AnyList(_FORMATS)
            return s
        out = caps.map_structures(repl)
        if filter is not None:
            out = filter.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        near = caps[0] if len(caps) else None
        return Caps([othercaps[0].fixate(near)])

    def transform(self, buf: Buffer) -> Buffer:
        if self.video_info.format == self.out_video_info.format:
            return buf
        rgb = _to_rgb(self.video_info, buf)
        out = _from_rgb(rgb, self.out_video_info.format)
        return self.out_video_info.make_buffer(out, pts=buf.pts,
                                               duration=buf.duration)
