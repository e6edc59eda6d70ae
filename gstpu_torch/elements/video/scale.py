"""videoscale: raw video resizing.

The port of gstpu's videoscale (gstpu/elements/video/scale.py). gstpu
resamples with jax.image.resize in f32, then rounds half to even, clips
and casts to u8; `_resize` builds the same arithmetic in torch ops on
the frame's device:

- linear: one f32 weight matrix per resized axis, as jax's
  `compute_weight_mat` builds it with `antialias=True` (a triangle
  widened by 1/scale when downscaling, each column normalised by its
  sum), then one matmul per axis in the order jax's einsum picks, in
  f32 with TF32 off (`tf32_off`, counted across threads). The matrices
  are made on the host in f32 and cached per (in, out, device), so the
  card and the CPU contract the same weights. They are not XLA's to the bit (its fused loop
  contracts some products into FMAs, differently at different sizes),
  and cuBLAS/MKL sum in another order than XLA's dots, so a byte at a .5
  tie can round the other way: linear is within 1 LSB of gstpu.
- nearest: jax's index `floor((i + 0.5) * m / n)` as XLA on the CPU
  compiles it: the division by the constant n becomes a product with
  f32(1/n), folded with m into one f32 constant f32(m * f32(1/n)).

I420 goes plane by plane with chroma at ((oh+1)//2, (ow+1)//2). The
16-bit formats are read in their byte order, as gstpu's `>u2`/`<u2`
view reads them, and gstpu's u8 result is written back widened into the
format's 16-bit layout. A host frame is uploaded once to the default
device; a tensor frame is resized where it lies, and the output is a
tensor in `buf.data`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from gstpu_torch.core.base import VideoFilter
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps, IntRange, Structure
from gstpu_torch.core.device import default_device, tf32_off
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import (PACKED_16, PACKED_FORMATS, VideoInfo,
                                    video_caps)
from gstpu_torch.runtime.device_batch import DeviceRow

_FORMATS = tuple(PACKED_FORMATS) + ("I420",)
_F32_EPS = float(np.finfo(np.float32).eps)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def linear_weights(m: int, n: int) -> torch.Tensor:
    """jax's compute_weight_mat(m, n, n / m, 0, triangle, antialias)
    as f32 torch ops on the host: (m, n)."""
    inv = np.float32(1.0 / (n / m))           # f32(1 / scale)
    kernel_scale = max(inv, np.float32(1.0))
    sample_f = (torch.arange(n, dtype=torch.float32) + _f32(0.5)) \
        * _f32(inv) - _f32(0.5)
    # x / kernel_scale is a product with the f32 reciprocal under XLA
    dist = (sample_f[None, :] - torch.arange(m, dtype=torch.float32)[:, None]
            ).abs() * (_f32(1.0) / _f32(kernel_scale))
    w = torch.clamp(_f32(1.0) - dist.abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, _f32(1.0)),
                    _f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, _f32(0.0))


def nearest_indices(m: int, n: int) -> torch.Tensor:
    """jax's nearest source index for each of n outputs from m inputs,
    with XLA's constant folding: floor((i + 0.5) * f32(m * f32(1/n)))."""
    scale = np.float32(np.float32(m) * (np.float32(1.0) / np.float32(n)))
    i = torch.arange(n, dtype=torch.float32) + _f32(0.5)
    return torch.floor(i * _f32(scale)).to(torch.int64)


@lru_cache(maxsize=64)
def _on_device(make, m: int, n: int, device: torch.device) -> torch.Tensor:
    """make(m, n), built once on the host and kept on `device`."""
    return make(m, n).to(device)


def _contract(x: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """x (H, W, C) f32 with `axis` (0 or 1) contracted against w (in,
    out): out[o] = sum_i w[i, o] x[i]."""
    xm = x.movedim(axis, 0)
    y = (w.t() @ xm.reshape(xm.shape[0], -1)).reshape(
        (w.shape[1],) + xm.shape[1:])
    return y.movedim(0, axis)


def _resize(img: torch.Tensor, oh: int, ow: int, method: str) -> torch.Tensor:
    """(H, W, C) u8 -> (oh, ow, C) u8 on img's device, as gstpu's
    `_resize` (jax.image.resize in f32, round half to even, clip)."""
    H, W = img.shape[:2]
    dev = img.device
    if method == "nearest":
        out = img
        if oh != H:
            out = out.index_select(0, _on_device(nearest_indices, H, oh,
                                                 dev))
        if ow != W:
            out = out.index_select(1, _on_device(nearest_indices, W, ow,
                                                 dev))
        if out.dtype != torch.uint8:        # gstpu clips every method
            out = out.to(torch.int32).clamp(0, 255).to(torch.uint8)
        return out.contiguous()
    x = img.to(torch.float32)
    axes = [a for a, (m, n) in enumerate(((H, oh), (W, ow))) if m != n]
    if len(axes) == 2:
        # jax's einsum contracts the cheaper axis first; on a tie, H
        C = x.shape[2]
        h_first = oh * H * W * C + ow * W * oh * C
        w_first = ow * W * H * C + oh * H * ow * C
        if w_first < h_first:
            axes = [1, 0]
    with tf32_off():
        for a in axes:
            m, n = ((H, oh), (W, ow))[a]
            x = _contract(x, _on_device(linear_weights, m, n, dev), a)
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def frame_tensor(buf: Buffer):
    """The payload as a tensor where it is one (a tensor or a DeviceRow),
    else None."""
    d = buf.data
    if isinstance(d, DeviceRow):
        return d.tensor()
    return d if isinstance(d, torch.Tensor) else None


def payload_bytes(buf: Buffer, device) -> torch.Tensor:
    """The payload's bytes as a flat u8 tensor: a tensor payload where it
    lies, a host payload after one upload to `device`."""
    flat = frame_tensor(buf)
    if flat is None:
        arr = buf.array.view(np.uint8).reshape(-1)
        flat = torch.from_numpy(arr if arr.flags.writeable
                                else arr.copy()).to(device)
    return flat.reshape(-1).view(torch.uint8)


def i420_planes(info: VideoInfo, buf: Buffer, device) -> list:
    """The Y, U and V planes of an I420 frame as (h, w) u8 tensors, cut
    from a tensor payload where it lies or from the host payload after
    one upload."""
    flat = payload_bytes(buf, device)
    w, h = info.width, info.height
    cw, ch = -(-w // 2), -(-h // 2)
    return [flat[:w * h].reshape(h, w),
            flat[w * h:w * h + cw * ch].reshape(ch, cw),
            flat[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw)]


def _byte_order(fmt: str) -> tuple[int, int]:
    """(low, high) byte of a 16-bit component in `fmt`'s layout."""
    return (1, 0) if fmt == "RGBA64BE" else (0, 1)


def packed16_values(info: VideoInfo, buf: Buffer, device) -> torch.Tensor:
    """A 16-bit packed frame as (H, W, C) int32 values, read in the
    format's byte order."""
    b = payload_bytes(buf, device).reshape(
        info.height, info.width, PACKED_FORMATS[info.format], 2)
    lo, hi = _byte_order(info.format)
    return b[..., hi].to(torch.int32) * 256 + b[..., lo].to(torch.int32)


def widen16(data: torch.Tensor, fmt: str) -> torch.Tensor:
    """u8 values as the flat bytes of `fmt`'s 16-bit components."""
    out = torch.zeros(data.shape + (2,), dtype=torch.uint8,
                      device=data.device)
    out[..., _byte_order(fmt)[0]] = data
    return out.reshape(-1)


@register_element("videoscale", Rank.PRIMARY)
class VideoScale(VideoFilter):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=_FORMATS)),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=_FORMATS)),
    ]

    method = Property(str, default="bilinear", mutable=Mutability.READY,
                      blurb="nearest|bilinear")

    def __init__(self, name=None):
        super().__init__(name)
        self._device: torch.device | None = None

    def start(self) -> bool:
        self._device = default_device()
        return True

    def transform_caps(self, direction, caps, filter):
        def repl(s: Structure):
            if s.name != "video/x-raw":
                return None
            s = s.copy()
            s["width"] = IntRange(1, 2147483647)
            s["height"] = IntRange(1, 2147483647)
            return s
        out = caps.map_structures(repl)
        if filter is not None:
            out = filter.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        near = caps[0] if len(caps) else None
        return Caps([othercaps[0].fixate(near)])

    def transform(self, buf: Buffer) -> Buffer:
        ii, oo = self.video_info, self.out_video_info
        if (ii.width, ii.height) == (oo.width, oo.height):
            return buf
        m = "nearest" if self.method == "nearest" else "linear"
        if ii.format == "I420":
            y, u, v = i420_planes(ii, buf, self._device)
            ch, cw = (oo.height + 1) // 2, (oo.width + 1) // 2
            data = torch.cat([
                _resize(y[..., None], oo.height, oo.width, m).reshape(-1),
                _resize(u[..., None], ch, cw, m).reshape(-1),
                _resize(v[..., None], ch, cw, m).reshape(-1)])
        elif ii.format in PACKED_16:
            # gstpu's u8 result widened into the 16-bit layout
            data = widen16(_resize(packed16_values(ii, buf, self._device),
                                   oo.height, oo.width, m), oo.format)
        else:
            frame = frame_tensor(buf)
            frame = ii.tensor(buf, self._device) if frame is None \
                else frame.reshape(ii.height, ii.width, -1)
            data = _resize(frame, oo.height, oo.width, m)
        return Buffer(data, pts=buf.pts, duration=buf.duration)
