"""hsvfilter / hsvdetector: per-pixel HSV video elements.

The port of gstpu's hsvfilter (gstpu/elements/video/hsv.py) on
tensors: a host frame is uploaded once to the device, the frame is
processed where it lies (the CUDA kernel on a CUDA tensor, the plain
version on a CPU tensor), and the result stays a tensor in `buf.data`.
With `context` set, the element joins that DeviceContext: the frames of
every member stream run as one (B, H, W, C) batch, one kernel launch a
fire where the five uniforms are the same in every lane.

hsvdetector keys the pixels inside an HSV window into the alpha of an
alpha-capable output format (gstpu's hsvdetector); its match is torch
ops on the frame's device, and with `context` set the (B, H, W, C)
batch runs as one set of those ops a fire.
"""

from __future__ import annotations

import numpy as np
import torch

from gstpu_torch.core.base import VideoFilter
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.device import default_device
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.caps import AnyList, Structure
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import video_caps
from gstpu_torch.ops.hsv import hsv_detect_frame, hsv_filter_frame
from gstpu_torch.runtime.device_batch import (DeviceContext, DeviceRow,
                                              _is_device)

# channel layout: (color offsets (r,g,b), alpha offset or None)
_LAYOUTS = {
    "RGB": ((0, 1, 2), None), "BGR": ((2, 1, 0), None),
    "RGBx": ((0, 1, 2), None), "BGRx": ((2, 1, 0), None),
    "RGBA": ((0, 1, 2), 3), "BGRA": ((2, 1, 0), 3),
    "xRGB": ((1, 2, 3), None), "xBGR": ((3, 2, 1), None),
    "ARGB": ((1, 2, 3), 0), "ABGR": ((3, 2, 1), 0),
}

_FILTER_FORMATS = tuple(_LAYOUTS)
_DETECTOR_OUT_FORMATS = ("RGBA", "BGRA", "ARGB", "ABGR")


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
    context = Property(str, default=None, mutable=Mutability.READY,
                       blurb="DeviceContext name: N video streams "
                             "sharing it run as ONE batched frame "
                             "step (like rsaudioecho)")
    fps = Property(int, default=30, minimum=1,
                   mutable=Mutability.READY,
                   blurb="frame rate used for batched pts spacing")

    def __init__(self, name=None):
        super().__init__(name)
        self._device: torch.device | None = None
        self._ctx = None

    def start(self) -> bool:
        self._device = default_device()
        if self.context:
            # block is finalized once caps arrive (one frame)
            self._ctx = DeviceContext.acquire(self.context, block=0)
            self._ctx.add_member(self)
        return True

    def stop(self) -> bool:
        if self._ctx is not None:
            self._ctx.remove_member(self)
            self._ctx = None
        return super().stop()

    def set_info(self, in_info, out_info) -> bool:
        if self._ctx is not None:
            nflat = in_info.height * in_info.width \
                * len(in_info.format.replace("x", "A"))
            if self._ctx.block in (0, nflat):
                self._ctx.block = nflat
            elif self._ctx.block != nflat:
                self.post_error("hsvfilter: context members must "
                                "share the frame geometry")
                return False
            self._ctx.finalize_member(self)
        return True

    # -- DeviceContext contract ------------------------------------------
    def device_batch_spec(self) -> dict:
        info = self.video_info
        H, W = info.height, info.width
        C = len(info.format)
        rgb, _ = _LAYOUTS[info.format]

        def step(states, x, *unis):
            # x is (B, H, W, C) in the frame's native layout (the spec's
            # sample_shape); the wrapper takes (..., C), so lane-uniform
            # parameters are ONE launch over the whole batch, out of
            # place (x may be the caller's bank)
            if not any(isinstance(u, torch.Tensor) for u in unis):
                return states, hsv_filter_frame(x, rgb, *unis)
            # parameters that differ across lanes: one launch a lane
            cols = [u[:, 0].tolist() if isinstance(u, torch.Tensor)
                    else [u] * x.shape[0] for u in unis]
            return states, torch.stack(
                [hsv_filter_frame(x[i], rgb, *p)
                 for i, p in enumerate(zip(*cols))])

        return dict(key=("hsvfilter", H, W, info.format),
                    step=step,
                    sample_shape=(H, W, C),
                    init_state=lambda: (),
                    uniforms=lambda: (self.hue_shift,
                                      self.saturation_mul,
                                      self.saturation_off,
                                      self.value_mul,
                                      self.value_off),
                    compute_dtype=np.uint8)

    def make_batch_buffer(self, flat, pts, dur) -> Buffer:
        if isinstance(flat, DeviceRow):
            return Buffer(flat, pts=pts, duration=dur)
        return self.video_info.make_buffer(flat, pts=pts,
                                           duration=dur)

    def drain(self) -> list:
        if self._ctx is not None:
            return self._ctx.flush_member(self)
        return []

    def transform_ip(self, buf: Buffer):
        info = self.video_info
        if self._ctx is not None:
            # one frame per batch row; fps drives the pts spacing
            n = info.height * info.width * len(info.format)
            data = buf.data if _is_device(buf.data) \
                else info.view(buf).reshape(-1)
            self._ctx.submit(self, data, buf.pts, n * self.fps,
                             metas=buf.metas)
            return []                 # outputs flow from the batch
        frame = info.tensor(buf, self._device)
        # a frame uploaded just now is ours to overwrite; a tensor that
        # came in, or a CPU tensor sharing the host array, is not
        owned = frame.device.type == "cuda" \
            and not isinstance(buf.data, torch.Tensor)
        rgb, _ = _LAYOUTS[info.format]
        buf.data = hsv_filter_frame(
            frame, rgb, self.hue_shift, self.saturation_mul,
            self.saturation_off, self.value_mul, self.value_off,
            out=frame if owned else None)


@register_element("hsvdetector", Rank.NONE)
class HsvDetector(VideoFilter):
    """Keys pixels matching an HSV window into the output alpha."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=_FILTER_FORMATS)),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=_DETECTOR_OUT_FORMATS)),
    ]

    hue_ref = Property(float, default=0.0, mutable=Mutability.PLAYING)
    hue_var = Property(float, default=10.0, minimum=0.0, maximum=180.0,
                       mutable=Mutability.PLAYING)
    saturation_ref = Property(float, default=0.0, mutable=Mutability.PLAYING)
    saturation_var = Property(float, default=0.15, minimum=0.0, maximum=1.0,
                              mutable=Mutability.PLAYING)
    value_ref = Property(float, default=0.0, mutable=Mutability.PLAYING)
    value_var = Property(float, default=0.3, minimum=0.0, maximum=1.0,
                         mutable=Mutability.PLAYING)
    context = Property(str, default=None, mutable=Mutability.READY,
                       blurb="DeviceContext name for batched frame "
                             "dispatch across streams")
    fps = Property(int, default=30, minimum=1,
                   mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._device: torch.device | None = None
        self._ctx = None

    def start(self) -> bool:
        self._device = default_device()
        if self.context:
            self._ctx = DeviceContext.acquire(self.context, block=0)
            self._ctx.add_member(self)
        return True

    def stop(self) -> bool:
        if self._ctx is not None:
            self._ctx.remove_member(self)
            self._ctx = None
        return super().stop()

    def set_info(self, in_info, out_info) -> bool:
        if self._ctx is not None:
            if len(in_info.format) != 4:
                # 3ch->4ch would change the row size mid-batch
                self.post_error("hsvdetector: context batching needs "
                                "a 4-channel input format")
                return False
            nflat = in_info.height * in_info.width \
                * len(in_info.format)
            if self._ctx.block in (0, nflat):
                self._ctx.block = nflat
            elif self._ctx.block != nflat:
                self.post_error("hsvdetector: context members must "
                                "share frame geometry")
                return False
            self._ctx.finalize_member(self)
        return True

    def _indices(self) -> tuple:
        rgb, _ = _LAYOUTS[self.video_info.format]
        (ro, go, bo), ao = _LAYOUTS[self.out_video_info.format]
        return rgb, (ro, go, bo, ao)

    def _uniforms(self) -> tuple:
        return (self.hue_ref, self.hue_var, self.saturation_ref,
                self.saturation_var, self.value_ref, self.value_var)

    # -- DeviceContext contract ------------------------------------------
    def device_batch_spec(self) -> dict:
        in_info, out_info = self.video_info, self.out_video_info
        H, W = in_info.height, in_info.width
        rgb, out_idx = self._indices()

        def step(states, x, *unis):
            # (B, H, W, C_in) native in -> (B, H, W, 4) native out; one
            # set of ops over the batch, a uniform that differs across
            # lanes a (B, 1) tensor
            return states, hsv_detect_frame(x, rgb, out_idx, *unis)

        return dict(key=("hsvdetector", H, W, in_info.format,
                         out_info.format),
                    step=step,
                    sample_shape=(H, W, len(in_info.format)),
                    init_state=lambda: (),
                    uniforms=self._uniforms,
                    compute_dtype=np.uint8)

    def make_batch_buffer(self, flat, pts, dur) -> Buffer:
        if isinstance(flat, DeviceRow):
            return Buffer(flat, pts=pts, duration=dur)
        return self.out_video_info.make_buffer(flat, pts=pts,
                                               duration=dur)

    def drain(self) -> list:
        if self._ctx is not None:
            return self._ctx.flush_member(self)
        return []

    def transform_caps(self, direction, caps, filter):
        def repl(s: Structure) -> Structure | None:
            if s.name != "video/x-raw":
                return None
            if direction is PadDirection.SINK:
                s["format"] = AnyList(_DETECTOR_OUT_FORMATS)
            else:
                s["format"] = AnyList(_FILTER_FORMATS)
            return s
        out = caps.map_structures(repl)
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer):
        info = self.video_info
        if self._ctx is not None:
            n = info.height * info.width * len(info.format)
            data = buf.data if _is_device(buf.data) \
                else info.view(buf).reshape(-1)
            self._ctx.submit(self, data, buf.pts, n * self.fps)
            return []                 # outputs flow from the batch
        frame = info.tensor(buf, self._device)
        rgb, out_idx = self._indices()
        return Buffer(hsv_detect_frame(frame, rgb, out_idx,
                                       *self._uniforms()),
                      pts=buf.pts, duration=buf.duration)
