"""Video format descriptors (gst-video VideoInfo analogue).

Typed view of "video/x-raw" caps for VideoFilter-style elements
(reference video/hsv, video/colorlut negotiate RGBA/RGBx/I420 etc.).
Planar layouts carry per-plane shapes so kernels can view each plane
as an ndarray without copying; packed frames also as a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, FractionRange, IntRange, Structure

# format -> (n_components_per_pixel_plane0, planes description)
# packed RGB formats: one plane, N bytes/pixel; planar YUV: list of
# (width_div, height_div, components)
PACKED_FORMATS = {
    "RGBA": 4, "BGRA": 4, "ARGB": 4, "ABGR": 4,
    "RGBx": 4, "BGRx": 4, "xRGB": 4, "xBGR": 4,
    "RGB": 3, "BGR": 3,
    "GRAY8": 1,
    "RGBA64LE": 4, "RGBA64BE": 4,
}
# 16-bit packed formats: numpy dtype per component
PACKED_16 = {"RGBA64LE": "<u2", "RGBA64BE": ">u2"}
PLANAR_FORMATS = {
    # name: [(w_div, h_div)] per plane
    "I420": [(1, 1), (2, 2), (2, 2)],
    "YV12": [(1, 1), (2, 2), (2, 2)],
    "NV12": [(1, 1), (2, 2)],  # second plane interleaved UV (w_div applies per component pair)
    "GRAY16_LE": [(1, 1)],
}

ALL_VIDEO_FORMATS = tuple(PACKED_FORMATS) + tuple(PLANAR_FORMATS)


def video_caps(formats=None, width=None, height=None,
               framerate=None) -> Caps:
    st = Structure("video/x-raw")
    if formats is None:
        st["format"] = AnyList(ALL_VIDEO_FORMATS)
    elif isinstance(formats, str):
        st["format"] = formats
    else:
        st["format"] = AnyList(tuple(formats)) if len(formats) > 1 else formats[0]
    st["width"] = width if width is not None else IntRange(1, 2**31 - 1)
    st["height"] = height if height is not None else IntRange(1, 2**31 - 1)
    st["framerate"] = (framerate if framerate is not None
                       else FractionRange(Fraction(0), Fraction(2**31 - 1)))
    return Caps([st])


@dataclass
class VideoInfo:
    format: str
    width: int
    height: int
    framerate: Fraction = Fraction(30, 1)

    @staticmethod
    def from_caps(caps: Caps) -> "VideoInfo":
        if not caps.is_fixed():
            raise ValueError(f"VideoInfo needs fixed caps: {caps!r}")
        s = caps[0]
        if s.name != "video/x-raw":
            raise ValueError(f"not raw video caps: {caps!r}")
        fr = s.get("framerate", Fraction(30, 1))
        return VideoInfo(format=s["format"], width=int(s["width"]),
                         height=int(s["height"]), framerate=Fraction(fr))

    def to_caps(self) -> Caps:
        return Caps.new("video/x-raw", format=self.format, width=self.width,
                        height=self.height, framerate=self.framerate)

    @property
    def is_packed(self) -> bool:
        return self.format in PACKED_FORMATS

    @property
    def pixel_stride(self) -> int:
        return PACKED_FORMATS[self.format]

    @property
    def size(self) -> int:
        """Total bytes of one frame."""
        if self.is_packed:
            bpc = 2 if self.format in PACKED_16 else 1
            return self.width * self.height \
                * PACKED_FORMATS[self.format] * bpc
        total = 0
        for i, (wd, hd) in enumerate(PLANAR_FORMATS[self.format]):
            w = -(-self.width // wd)
            h = -(-self.height // hd)
            comp = 2 if (self.format == "NV12" and i == 1) else 1
            bpp = 2 if self.format == "GRAY16_LE" else 1
            total += w * h * comp * bpp
        return total

    @property
    def frame_duration(self) -> int:
        if self.framerate == 0:
            return 0
        return int(1_000_000_000 * self.framerate.denominator
                   / self.framerate.numerator)

    # -- views ----------------------------------------------------------
    def view(self, buf: Buffer) -> np.ndarray:
        """Packed formats: (H, W, C) zero-copy view."""
        if not self.is_packed:
            raise ValueError(f"view() is for packed formats, not {self.format}")
        c = PACKED_FORMATS[self.format]
        arr = buf.array
        if arr.dtype != np.uint8:
            arr = arr.view(np.uint8)
        if self.format in PACKED_16:
            arr = arr.view(PACKED_16[self.format])
        return arr.reshape(self.height, self.width, c)

    def tensor(self, buf: Buffer, device) -> torch.Tensor:
        """Packed formats: (H, W, C) tensor of the payload. A tensor
        payload is reshaped where it lies, without a transfer; a host
        payload is uploaded once to `device`. 16-bit formats come as
        uint16 in native byte order of the stored bytes, so RGBA64BE
        values arrive byte-swapped on a little-endian host."""
        if not self.is_packed:
            raise ValueError(f"tensor() is for packed formats, not "
                             f"{self.format}")
        shape = (self.height, self.width, PACKED_FORMATS[self.format])
        dtype = torch.uint16 if self.format in PACKED_16 else torch.uint8
        d = buf.data
        if isinstance(d, torch.Tensor):
            if d.dtype != dtype:
                d = d.contiguous().view(torch.uint8).view(dtype)
            return d.reshape(shape)
        arr = buf.array
        if arr.dtype != np.uint8:
            arr = arr.view(np.uint8)
        if dtype is torch.uint16:
            arr = arr.view(np.uint16)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr.reshape(shape)).to(device)

    def planes(self, buf: Buffer) -> list[np.ndarray]:
        """Planar formats: list of per-plane views."""
        if self.is_packed:
            return [self.view(buf)]
        arr = buf.array
        if arr.dtype != np.uint8:
            arr = arr.view(np.uint8)
        arr = arr.reshape(-1)
        out, off = [], 0
        for i, (wd, hd) in enumerate(PLANAR_FORMATS[self.format]):
            w = -(-self.width // wd)
            h = -(-self.height // hd)
            comp = 2 if (self.format == "NV12" and i == 1) else 1
            if self.format == "GRAY16_LE":
                n = w * h * 2
                out.append(arr[off:off + n].view("<u2").reshape(h, w))
            else:
                n = w * h * comp
                out.append(arr[off:off + n].reshape(h, w * comp))
            off += n
        return out

    def make_buffer(self, frame: np.ndarray, *, pts: int | None = None,
                    duration: int | None = None) -> Buffer:
        if self.format in PACKED_16:
            frame = np.ascontiguousarray(
                np.asarray(frame).astype(PACKED_16[self.format],
                                         copy=False))
        else:
            frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if duration is None:
            duration = self.frame_duration
        return Buffer(frame, pts=pts, duration=duration)


class VideoCaptionMeta:
    """Closed captions attached to video frames (gst_video
    VideoCaptionMeta analogue; reference cea608overlay/imp.rs:264
    iterates these). caption_type: 'cea608-raw', 'cea608-s334-1a',
    'cea708-raw' (cc_data), 'cea708-cdp'."""

    def __init__(self, caption_type: str, data: bytes):
        self.caption_type = caption_type
        self.data = data

    def copy(self):
        return VideoCaptionMeta(self.caption_type, self.data)
