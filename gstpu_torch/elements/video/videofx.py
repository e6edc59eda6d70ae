"""roundedcorners, colordetect, videocompare
(reference video/videofx crate).

The port's copy of gstpu/elements/video/videofx.py, as it stands:
host numpy; a tensor payload is read through `Buffer.array` or
`VideoInfo.view`. Importing it adds A420 to the port's
`core.video` formats, as gstpu's does to gstpu's.
"""

from __future__ import annotations

from collections import deque
from fractions import Fraction

import numpy as np

from gstpu_torch.core.base import BaseTransform, VideoFilter
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, Structure
from gstpu_torch.core.element import (Element, FlowReturn, Pad,
                                      PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import VideoInfo, video_caps

SECOND = 1_000_000_000


# ---------------------------------------------------------------------------
# roundedcorners
# ---------------------------------------------------------------------------

@register_element("roundedcorners", Rank.NONE)
class RoundedCorners(VideoFilter):
    """Adds rounded-corner transparency: I420 in, A420 (I420 + alpha
    plane) out (reference videofx/src/border/imp.rs:345-561). With
    border-radius-px=0 the alpha plane is fully opaque."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats="I420")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("I420", "A420"))),
    ]

    border_radius_px = Property(int, default=0, minimum=0,
                                mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self._alpha: np.ndarray | None = None
        self._alpha_radius = None

    def transform_caps(self, direction, caps, filter):
        def repl(s: Structure):
            if s.name != "video/x-raw":
                return None
            s["format"] = ("A420" if direction is PadDirection.SINK
                           else "I420")
            return s
        out = caps.map_structures(repl)
        if filter is not None:
            out = filter.intersect(out)
        return out

    def _mask(self, w: int, h: int, r: int) -> np.ndarray:
        if self._alpha is not None and self._alpha_radius == r \
                and self._alpha.shape == (h, w):
            return self._alpha
        alpha = np.full((h, w), 255, np.uint8)
        if r > 0:
            yy, xx = np.mgrid[0:r, 0:r]
            # distance from the corner-circle center
            d2 = (r - 1 - xx) ** 2 + (r - 1 - yy) ** 2
            corner = np.where(d2 <= (r - 1) ** 2, 255, 0).astype(np.uint8)
            alpha[:r, :r] = corner
            alpha[:r, w - r:] = corner[:, ::-1]
            alpha[h - r:, :r] = corner[::-1, :]
            alpha[h - r:, w - r:] = corner[::-1, ::-1]
        self._alpha = alpha
        self._alpha_radius = r
        return alpha

    def transform(self, buf: Buffer) -> Buffer:
        info = self.video_info
        alpha = self._mask(info.width, info.height, self.border_radius_px)
        data = np.concatenate([buf.array.reshape(-1).view(np.uint8),
                               alpha.reshape(-1)])
        out = Buffer(data, pts=buf.pts, dts=buf.dts,
                     duration=buf.duration, flags=buf.flags)
        return out


# A420 isn't in core video formats yet: register it as planar I420+A
from gstpu_torch.core import video as _video  # noqa: E402

if "A420" not in _video.PLANAR_FORMATS:
    _video.PLANAR_FORMATS["A420"] = [(1, 1), (2, 2), (2, 2), (1, 1)]
    _video.ALL_VIDEO_FORMATS = (tuple(_video.PACKED_FORMATS)
                                + tuple(_video.PLANAR_FORMATS))


# ---------------------------------------------------------------------------
# colordetect
# ---------------------------------------------------------------------------

_CSS_BASIC_COLORS = {
    "black": (0, 0, 0), "silver": (192, 192, 192), "gray": (128, 128, 128),
    "white": (255, 255, 255), "maroon": (128, 0, 0), "red": (255, 0, 0),
    "purple": (128, 0, 128), "fuchsia": (255, 0, 255),
    "green": (0, 128, 0), "lime": (0, 255, 0), "olive": (128, 128, 0),
    "yellow": (255, 255, 0), "navy": (0, 0, 128), "blue": (0, 0, 255),
    "teal": (0, 128, 128), "aqua": (0, 255, 255),
}


def median_cut_palette(pixels: np.ndarray, max_colors: int) -> np.ndarray:
    """color-thief-style median cut quantization: (N, 3) -> (k, 3)."""
    boxes = [pixels]
    while len(boxes) < max_colors:
        boxes.sort(key=lambda b: -b.shape[0])
        box = boxes.pop(0)
        if box.shape[0] < 2:
            boxes.append(box)
            break
        ranges = box.max(axis=0).astype(int) - box.min(axis=0).astype(int)
        axis = int(np.argmax(ranges))
        order = np.argsort(box[:, axis], kind="stable")
        half = box.shape[0] // 2
        boxes += [box[order[:half]], box[order[half:]]]
    boxes.sort(key=lambda b: -b.shape[0])
    return np.array([b.mean(axis=0).round().astype(np.uint8)
                     for b in boxes if b.shape[0]])


def nearest_color_name(rgb) -> str:
    best, bd = "black", 1 << 30
    for name, c in _CSS_BASIC_COLORS.items():
        d = sum((int(a) - int(b)) ** 2 for a, b in zip(rgb, c))
        if d < bd:
            best, bd = name, d
    return best


@register_element("colordetect", Rank.NONE)
class ColorDetect(VideoFilter):
    """Passthrough dominant-color detector posting a `colordetect`
    element message when the dominant color changes
    (videofx/src/colordetect/imp.rs:68-103)."""

    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGBx", "RGB"))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGBx", "RGB"))),
    ]

    quality = Property(int, default=10, minimum=1, maximum=10,
                       mutable=Mutability.PLAYING,
                       blurb="Subsampling step (1 = every pixel)")
    max_colors = Property(int, default=2, minimum=1, maximum=16,
                          mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self._current: str | None = None

    def transform_ip(self, buf: Buffer) -> None:
        info = self.video_info
        frame = info.view(buf)
        pix = frame[..., :3].reshape(-1, 3)[::self.quality]
        palette = median_cut_palette(pix, self.max_colors)
        name = nearest_color_name(palette[0])
        if name != self._current:
            self._current = name
            self.post_element_message(
                "colordetect", dominant_color=name,
                palette=[tuple(int(v) for v in c) for c in palette])


# ---------------------------------------------------------------------------
# videocompare
# ---------------------------------------------------------------------------

def blockhash(frame_rgb: np.ndarray, bits: int = 16) -> np.ndarray:
    """Blockhash-style perceptual hash: bits x bits mean-threshold
    bitmap of the luma plane."""
    h, w = frame_rgb.shape[:2]
    y = (0.299 * frame_rgb[..., 0] + 0.587 * frame_rgb[..., 1]
         + 0.114 * frame_rgb[..., 2])
    bh = h // bits * bits
    bw = w // bits * bits
    blocks = y[:bh, :bw].reshape(bits, bh // bits, bits,
                                 bw // bits).mean(axis=(1, 3))
    return (blocks > np.median(blocks)).reshape(-1)


def hash_distance(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.count_nonzero(a != b)) / a.size


def dssim(a: np.ndarray, b: np.ndarray) -> float:
    """Structural dissimilarity on luma (1 - SSIM) / 2."""
    ya = (0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]) / 255
    yb = (0.299 * b[..., 0] + 0.587 * b[..., 1] + 0.114 * b[..., 2]) / 255
    mu_a, mu_b = ya.mean(), yb.mean()
    va, vb = ya.var(), yb.var()
    cov = ((ya - mu_a) * (yb - mu_b)).mean()
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) \
        / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    return (1.0 - float(ssim)) / 2.0


@register_element("videocompare", Rank.NONE)
class VideoCompare(Element):
    """Compares frames of two streams; when the distance between the
    reference pad frame and a secondary pad frame is within
    max-dist-threshold, posts a `videocompare` element message
    (videofx/src/videocompare/imp.rs). Passthrough on the reference
    stream."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGB", "RGBx"))),
        PadTemplate("sink_secondary", PadDirection.SINK,
                    PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGB", "RGBx"))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGB", "RGBx"))),
    ]

    hash_algo = Property(str, default="blockhash",
                         enum_values=("blockhash", "dssim"),
                         mutable=Mutability.READY)
    max_dist_threshold = Property(float, default=0.0, minimum=0.0,
                                  mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.secpad = self.static_pad("sink_secondary")
        self.srcpad = self.static_pad("src")
        self.sinkpad.chain_function = self._chain_ref
        self.secpad.chain_function = self._chain_sec
        self.secpad.event_function = lambda pad, ev: True
        self._sec_frames: deque[tuple[np.ndarray, int | None]] = deque(
            maxlen=8)
        self._info: VideoInfo | None = None
        self._sec_info: VideoInfo | None = None

    def _frame(self, info: VideoInfo, buf: Buffer) -> np.ndarray:
        return info.view(buf)[..., :3]

    def _chain_ref(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._info is None and pad.current_caps is not None:
            self._info = VideoInfo.from_caps(pad.current_caps)
        if self._info is not None and self._sec_frames:
            ref = self._frame(self._info, buf)
            for sec, sec_pts in list(self._sec_frames):
                if self.hash_algo == "dssim":
                    if ref.shape != sec.shape:
                        continue
                    d = dssim(ref, sec)
                else:
                    d = hash_distance(blockhash(ref), blockhash(sec))
                if d <= self.max_dist_threshold:
                    self.post_element_message(
                        "videocompare", distance=d, pts=buf.pts,
                        secondary_pts=sec_pts)
                    break
        return self.srcpad.push(buf)

    def _chain_sec(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._sec_info is None and pad.current_caps is not None:
            self._sec_info = VideoInfo.from_caps(pad.current_caps)
        if self._sec_info is not None:
            self._sec_frames.append(
                (self._frame(self._sec_info, buf).copy(), buf.pts))
        return FlowReturn.OK
