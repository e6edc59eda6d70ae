"""colorlut: .cube 1D/3D color-LUT video filter.

The port of gstpu's colorlut (gstpu/elements/video/colorlut.py) on
tensors: a host frame is uploaded once to the device, a 3D LUT runs the
CUDA kernel on a CUDA tensor (the plain version on a CPU tensor), a 1D
LUT runs as tensor code, and the result stays a tensor. With `context`
set, the frames of every member stream with the same LUT run as one
batch: one launch over (B*H, W, C), as gstpu's batched spec does.
The graded buffer carries the input's metas, batched or not, as a
reference base transform copies them (gstpu's colorlut drops them, so
an `originalbuffersave` before it is lost there).
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from gstpu_torch.core.base import VideoFilter
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.device import default_device
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import PACKED_16, video_caps
from gstpu_torch.ops.lut import (DeviceLut, apply_lut_1d, apply_lut_3d,
                                 lut_from_numpy, parse_cube)
from gstpu_torch.runtime.device_batch import (DeviceContext, DeviceRow,
                                              _is_device)

_FORMATS = ("RGBA", "RGBA64LE", "RGBA64BE")
# the 16-bit format whose stored byte order is not the host's
_SWAPPED = "RGBA64BE" if sys.byteorder == "little" else "RGBA64LE"


def _byteswap16(t: torch.Tensor) -> torch.Tensor:
    """Swap the bytes of every uint16 in t, on t's device."""
    return (t.view(torch.uint8).reshape(*t.shape, 2).flip(-1)
            .contiguous().view(torch.uint16).reshape(t.shape))


@register_element("colorlut", Rank.NONE)
class ColorLut(VideoFilter):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=_FORMATS)),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=_FORMATS)),
    ]

    location = Property(str, default=None, mutable=Mutability.READY,
                        blurb="Path to the .cube LUT file")
    context = Property(str, default=None, mutable=Mutability.READY,
                       blurb="DeviceContext name: N video streams "
                             "with the SAME LUT run as one batched "
                             "frame step")
    fps = Property(int, default=30, minimum=1,
                   mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._lut: DeviceLut | None = None
        self._device: torch.device | None = None
        self._ctx = None

    def set_lut(self, lut) -> None:
        """Programmatic LUT injection (tests, in-memory LUTs): a
        DeviceLut from lut_from_numpy, or a parsed CubeLut (its table
        moves to the element's device when the element starts)."""
        if not isinstance(lut, DeviceLut):
            lut = lut_from_numpy(
                lut.table_3d if lut.is_3d else lut.table_1d,
                lut.domain_scale, lut.domain_offset, "cpu")
        self._lut = lut

    def start(self) -> bool:
        self._device = default_device()
        if self.location:
            with open(self.location) as f:
                self.set_lut(parse_cube(f.read()))
        if self._lut is None:
            self.post_error("colorlut: no LUT configured "
                            "(set `location` to a .cube file)")
            return False
        # the table, and for 3D its packed form, move once per start
        self._lut = self._lut.to(self._device)
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
            if in_info.format.startswith("RGBA64"):
                self.post_error("colorlut: context batching is for "
                                "8-bit formats")
                return False
            nflat = in_info.height * in_info.width \
                * len(in_info.format)
            if self._ctx.block in (0, nflat):
                self._ctx.block = nflat
            elif self._ctx.block != nflat:
                self.post_error("colorlut: context members must "
                                "share the frame geometry")
                return False
            self._ctx.finalize_member(self)
        return True

    # -- DeviceContext contract ------------------------------------------
    def device_batch_spec(self) -> dict:
        info = self.video_info
        H, W = info.height, info.width
        C = len(info.format)
        lut = self._lut
        lut_id = hashlib.sha1(
            lut.table.cpu().numpy().tobytes()).hexdigest()[:12]

        def step(states, x, *_unused):
            # x is (B, H, W, C) in the frame's native layout; the
            # (B*H, W, C) merge of adjacent dims is free, and the kernel
            # runs over all frames in ONE launch
            B = x.shape[0]
            pix = x.reshape(B * H, W, C)
            if lut.is_3d:
                out = apply_lut_3d(pix, lut.table, lut.domain_scale,
                                   lut.domain_offset, max_val=255,
                                   packed=lut.packed)
            else:
                out = apply_lut_1d(pix, lut.table, lut.domain_scale,
                                   lut.domain_offset, max_val=255)
            return states, out.reshape(B, H, W, C)

        return dict(key=("colorlut", H, W, info.format, lut_id),
                    step=step,
                    sample_shape=(H, W, C),
                    init_state=lambda: (),
                    uniforms=lambda: (),
                    compute_dtype=np.uint8)

    def make_batch_buffer(self, flat, pts, dur):
        if isinstance(flat, DeviceRow):
            return Buffer(flat, pts=pts, duration=dur)
        return self.video_info.make_buffer(flat, pts=pts,
                                           duration=dur)

    def drain(self) -> list:
        if self._ctx is not None:
            return self._ctx.flush_member(self)
        return []

    def transform(self, buf: Buffer):
        info = self.video_info
        if self._ctx is not None:
            n = info.height * info.width * len(info.format)
            data = buf.data if _is_device(buf.data) \
                else np.asarray(info.view(buf)).reshape(-1)
            self._ctx.submit(self, data, buf.pts, n * self.fps,
                             metas=buf.metas)
            return []                 # outputs flow from the batch
        frame = info.tensor(buf, self._device)
        swap = info.format == _SWAPPED
        if swap:
            frame = _byteswap16(frame)
        lut = self._lut
        max_val = 65535 if info.format in PACKED_16 else 255
        if lut.is_3d:
            out = apply_lut_3d(frame, lut.table, lut.domain_scale,
                               lut.domain_offset, max_val=max_val,
                               packed=lut.packed)
        else:
            out = apply_lut_1d(frame, lut.table, lut.domain_scale,
                               lut.domain_offset, max_val=max_val)
        if swap:
            out = _byteswap16(out)
        return Buffer(out, pts=buf.pts, duration=buf.duration,
                      metas=[m.copy() for m in buf.metas])
