"""Image codec elements: rspngenc, gifenc/gifdec, imagedecoder,
imageoverlay, rswebpdec.

Rebuilds the reference's image crates (video/png rspngenc, video/gif,
video/image imagedecoder+imageoverlay, video/webp rswebpdec) on PIL —
the native codec dependency of this environment (the reference links
the png/gif/image Rust crates and libwebp).

The port's copy of gstpu/elements/video/image.py, as it stands: PIL
on the host; a tensor payload is read through `VideoInfo.view`.
"""

from __future__ import annotations

import io

import numpy as np

from gstpu_torch.core.base import BaseTransform, VideoFilter
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, Structure
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import VideoInfo, video_caps

SECOND = 1_000_000_000


def _pil():
    from PIL import Image
    return Image


@register_element("rspngenc", Rank.PRIMARY)
class PngEnc(BaseTransform):
    """PNG encoder (reference video/png rspngenc)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGB", "GRAY8"))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("image/png")),
    ]

    compression_level = Property(int, default=6, minimum=0, maximum=9,
                                 mutable=Mutability.READY)

    def transform_caps(self, direction, caps, filter):
        if direction is PadDirection.SINK:
            out = Caps.new("image/png")
            for s in caps:
                for k in ("width", "height", "framerate"):
                    if k in s:
                        out[0][k] = s[k]
        else:
            out = self.sinkpad.pad_template_caps().copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> Buffer:
        info = VideoInfo.from_caps(self.in_caps)
        frame = info.view(buf)
        mode = {"RGBA": "RGBA", "RGB": "RGB", "GRAY8": "L"}[info.format]
        img = _pil().fromarray(frame if mode != "L" else frame[..., 0],
                               mode)
        out = io.BytesIO()
        img.save(out, format="PNG",
                 compress_level=self.compression_level)
        return Buffer(out.getvalue(), pts=buf.pts, duration=buf.duration)


@register_element("imagedecoder", Rank.PRIMARY)
class ImageDecoder(BaseTransform):
    """Still image decoder: png/jpeg/gif/webp/bmp -> RGBA frames
    (reference video/image imagedecoder)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps([Structure("image/png"), Structure("image/jpeg"),
                          Structure("image/gif"), Structure("image/webp"),
                          Structure("image/bmp")])),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats="RGBA")),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._acc = b""
        self._out_info: VideoInfo | None = None

    def _negotiate(self, incaps):
        self.in_caps = incaps
        return True

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        # images may arrive in chunks (e.g. filesrc); accumulate and
        # decode at EOS or when a full image parses
        self._acc += buf.to_bytes()
        try:
            img = _pil().open(io.BytesIO(self._acc))
            img.load()
        except Exception:
            return None
        return self._emit(img, buf.pts)

    def _emit(self, img, pts) -> list[Buffer]:
        from gstpu_torch.core.event import CapsEvent
        rgba = np.asarray(img.convert("RGBA"))
        info = VideoInfo("RGBA", rgba.shape[1], rgba.shape[0])
        if self._out_info is None or \
                (info.width, info.height) != (self._out_info.width,
                                              self._out_info.height):
            self._out_info = info
            self.srcpad.push_event(CapsEvent(info.to_caps()))
        self._acc = b""
        return [info.make_buffer(rgba.reshape(-1), pts=pts or 0)]

    def drain(self) -> list[Buffer]:
        if not self._acc:
            return []
        try:
            img = _pil().open(io.BytesIO(self._acc))
            img.load()
        except Exception:
            return []
        return self._emit(img, 0)


@register_element("gifenc", Rank.PRIMARY)
class GifEnc(BaseTransform):
    """Animated GIF encoder (reference video/gif gifenc): collects
    frames, emits one GIF at EOS."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGB"))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("image/gif")),
    ]

    repeat = Property(int, default=0, minimum=-1,
                      mutable=Mutability.READY,
                      blurb="-1 once, 0 forever, n repeats")

    def __init__(self, name=None):
        super().__init__(name)
        self._frames = []
        self._durations = []

    def transform_caps(self, direction, caps, filter):
        out = (Caps.new("image/gif") if direction is PadDirection.SINK
               else self.sinkpad.pad_template_caps().copy())
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> None:
        info = VideoInfo.from_caps(self.in_caps)
        frame = info.view(buf)
        mode = "RGBA" if info.format == "RGBA" else "RGB"
        self._frames.append(_pil().fromarray(frame, mode))
        dur_ms = (buf.duration or info.frame_duration) // 1_000_000
        self._durations.append(max(int(dur_ms), 10))
        return None

    def drain(self) -> list[Buffer]:
        if not self._frames:
            return []
        out = io.BytesIO()
        kwargs = dict(format="GIF", save_all=True,
                      append_images=self._frames[1:],
                      duration=self._durations)
        if self.repeat >= 0:
            kwargs["loop"] = self.repeat
        self._frames[0].save(out, **kwargs)
        self._frames = []
        return [Buffer(out.getvalue(), pts=0)]


@register_element("gifdec", Rank.PRIMARY)
class GifDec(BaseTransform):
    """Animated GIF decoder (reference video/gif gifdec)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("image/gif")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats="RGBA")),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._acc = b""

    def _negotiate(self, incaps):
        self.in_caps = incaps
        return True

    def transform(self, buf: Buffer) -> None:
        self._acc += buf.to_bytes()
        return None

    def drain(self) -> list[Buffer]:
        if not self._acc:
            return []
        from gstpu_torch.core.event import CapsEvent
        img = _pil().open(io.BytesIO(self._acc))
        out = []
        pts = 0
        info = None
        for i in range(getattr(img, "n_frames", 1)):
            img.seek(i)
            rgba = np.asarray(img.convert("RGBA"))
            if info is None:
                info = VideoInfo("RGBA", rgba.shape[1], rgba.shape[0])
                self.srcpad.push_event(CapsEvent(info.to_caps()))
            dur = int(img.info.get("duration", 100)) * 1_000_000
            out.append(info.make_buffer(rgba.reshape(-1), pts=pts,
                                        duration=dur))
            pts += dur
        self._acc = b""
        return out


@register_element("rswebpdec", Rank.PRIMARY)
class WebpDec(GifDec):
    """Animated WebP decoder (reference video/webp rswebpdec)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("image/webp")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats="RGBA")),
    ]


@register_element("imageoverlay", Rank.NONE)
class ImageOverlay(VideoFilter):
    """Composites a still image onto video frames
    (reference video/image imageoverlay)."""

    IN_PLACE = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGB"))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("RGBA", "RGB"))),
    ]

    location = Property(str, default=None, mutable=Mutability.READY)
    offset_x = Property(int, default=0, minimum=0,
                        mutable=Mutability.PLAYING)
    offset_y = Property(int, default=0, minimum=0,
                        mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self._overlay: np.ndarray | None = None

    def start(self) -> bool:
        if not self.location:
            self.post_error("imageoverlay: no location set")
            return False
        img = _pil().open(self.location).convert("RGBA")
        self._overlay = np.asarray(img)
        return True

    def transform_ip(self, buf: Buffer) -> None:
        info = self.video_info
        frame = info.view(buf).copy()
        ov = self._overlay
        x0, y0 = self.offset_x, self.offset_y
        h = min(ov.shape[0], info.height - y0)
        w = min(ov.shape[1], info.width - x0)
        if h <= 0 or w <= 0:
            return
        region = frame[y0:y0 + h, x0:x0 + w, :3].astype(np.float32)
        src = ov[:h, :w]
        alpha = src[..., 3:4].astype(np.float32) / 255.0
        blended = src[..., :3] * alpha + region * (1 - alpha)
        frame[y0:y0 + h, x0:x0 + w, :3] = blended.round().astype(np.uint8)
        buf.data = frame
