"""FFV1's prediction, context and residual fields as torch ops.

The port of gstpu/ops/ffv1_pred.py. FFV1 is lossless, so the decoder's
reconstruction equals the source and every neighbour a sample's context
and prediction depend on is known up front: the whole per-frame field
(3-gradient quantised context, median prediction, folded residual) is
elementwise integer work on the device, and only the sequential adaptive
range coding stays on the host (native/gstpu_ffv1.cpp through
gstpu_torch.native_ffv1).

gstpu lowers FFV1's quant tables, where they are monotone staircases over
the signed byte difference, to a static sum of compares, which on its
device was cheaper than a 256-entry gather. On the H100 the gather takes
fewer kernels and less device time, and it serves every table, so the
port has that form alone. Both are integer and exact: the gather equals
gstpu's staircase and gather forms and the numpy spec model
(gstpu_torch.codecs.ffv1.predict_plane) bit for bit on every device.

Every function runs on the device of its input and returns tensors there
without a sync: contexts as int16 (they are at most 10 bits, so the
values equal gstpu's uint16 field) and residuals as int8. `to_numpy`
gives the host arrays gstpu's functions give.
"""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(t: torch.Tensor, dtype) -> np.ndarray:
    """A field tensor as the host array gstpu's functions return
    (contexts as uint16, residuals as int8, packed bytes as uint8)."""
    return t.cpu().numpy().astype(dtype, copy=False)


def pack_ctx_hi4(ctx: torch.Tensor) -> tuple:
    """Split a context field into the 2.25-bytes/px hop layout used by
    fe_encode_packed: (ctx & 0xFF uint8 (H, W), the high 2 bits packed
    4 to a byte, uint8 (H, ceil(W/4)))."""
    ctx = ctx.to(torch.int32)
    lo = (ctx & 0xFF).to(torch.uint8)
    hi = ctx >> 8
    pad = (-ctx.shape[-1]) % 4
    if pad:
        hi = torch.cat([hi, hi.new_zeros(*hi.shape[:-1], pad)], -1)
    h4 = hi.reshape(*hi.shape[:-1], -1, 4)
    hip = (h4[..., 0] | (h4[..., 1] << 2) | (h4[..., 2] << 4)
           | (h4[..., 3] << 6)).to(torch.uint8)
    return lo, hip


def _neighbors(p: torch.Tensor) -> tuple:
    """(..., H, W) int32 -> (L, T, LT, RT) with FFV1's border rules.

    Border rules pinned against libavcodec (see codecs/ffv1.py):
    row 0 has t=tl=tr=0; l(0)=t(0); tl(0) = first sample two rows up;
    tr(last col) = t(last col)."""
    h = p.shape[-2]
    z = p.new_zeros(*p.shape[:-2], 2, p.shape[-1])
    up = torch.cat([z[..., :1, :], p], -2)[..., :h, :]       # p[y-1, x]
    up2 = torch.cat([z, p], -2)[..., :h, :]                  # p[y-2, x]
    RT = torch.cat([up[..., 1:], up[..., -1:]], -1)
    L = torch.cat([up[..., :1], p[..., :-1]], -1)            # l(0) = t(0)
    LT = torch.cat([up2[..., :1], up[..., :-1]], -1)         # tl(0) 2 up
    return L, up, LT, RT


def _fields_from_ctx(p, ctx, L, T, LT, bits: int) -> tuple:
    grad = L + T - LT
    pred = torch.maximum(torch.minimum(L, T),
                         torch.minimum(torch.maximum(L, T), grad))
    diff = p - pred
    diff = torch.where(ctx < 0, -diff, diff)
    diff = ((diff + (1 << (bits - 1))) & ((1 << bits) - 1)) \
        - (1 << (bits - 1))
    return ctx.abs().to(torch.int16), diff.to(torch.int8)


def predict_fields_gather(plane: torch.Tensor, q0: torch.Tensor,
                          q1: torch.Tensor, q2: torch.Tensor,
                          bits: int = 8):
    """(..., H, W) uint8 planes -> (ctx int16 >= 0, diff int8
    sign-folded) for any quant tables (q* int32 (256,) tensors on the
    plane's device). Leading dims are a batch."""
    p = plane.to(torch.int32)
    L, T, LT, RT = _neighbors(p)
    ctx = (q0[((L - LT) & 0xFF).long()] + q1[((LT - T) & 0xFF).long()]
           + q2[((T - RT) & 0xFF).long()])
    return _fields_from_ctx(p, ctx, L, T, LT, bits)


def _i420_planes(flat: torch.Tensor, w: int, h: int) -> list:
    cw, ch = -(-w // 2), -(-h // 2)
    return [flat[:w * h].reshape(h, w),
            flat[w * h:w * h + cw * ch].reshape(ch, cw),
            flat[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw)]


def _i420_gather(flat: torch.Tensor, q0, q1, q2, w: int, h: int,
                 bits: int = 8) -> torch.Tensor:
    """A whole flat I420 frame: all three planes' folded residuals as
    ONE (n,) int8 tensor, one download a frame."""
    return torch.cat([predict_fields_gather(p, q0, q1, q2, bits=bits)[1]
                      .reshape(-1) for p in _i420_planes(flat, w, h)])


class Predictor:
    """The ffv1enc element's device pass for one set of quant tables.

    Host planes are uploaded once to `device`; tensors are processed
    where they lie. The `dispatch*` methods return device tensors
    without a sync."""

    def __init__(self, quant, device):
        self.device = torch.device(device)
        self._q_host = [torch.as_tensor(np.asarray(t, np.int32))
                        for t in quant[:3]]
        self._q: dict = {}

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.ascontiguousarray(x, np.uint8)) \
            .to(self.device)

    def tables(self, device: torch.device) -> list:
        """The three quant tables as int32 tensors on `device`."""
        if device not in self._q:
            self._q[device] = [q.to(device) for q in self._q_host]
        return self._q[device]

    def _fields(self, plane: torch.Tensor) -> tuple:
        return predict_fields_gather(plane, *self.tables(plane.device))

    def __call__(self, plane) -> tuple:
        ctx, diff = self._fields(self._tensor(plane))
        return to_numpy(ctx, np.uint16), to_numpy(diff, np.int8)

    def dispatch(self, plane) -> tuple:
        """(ctx, diff) device tensors; download them with `to_numpy`
        (e.g. from a download thread) so the transfer overlaps the host
        range coder working on the previous frame."""
        return self._fields(self._tensor(plane))

    def dispatch_packed(self, plane) -> tuple:
        """The 2.25-bytes/px packed field layout (diff, ctx_lo,
        ctx_hi4) for fe_encode_packed."""
        ctx, diff = self._fields(self._tensor(plane))
        return (diff, *pack_ctx_hi4(ctx))

    def dispatch_diff(self, plane) -> torch.Tensor:
        """The 1-byte/px hop: the folded residual only;
        fe_encode_from_plane re-derives contexts from the host-resident
        source plane."""
        return self._fields(self._tensor(plane))[1]

    def dispatch_diff_i420(self, flat, w: int, h: int) -> torch.Tensor:
        """A whole flat I420 frame (a device tensor, or host bytes) to
        one residual pass: one (n,) int8 download for all three
        planes."""
        flat = self._tensor(flat).reshape(-1)
        return _i420_gather(flat, *self.tables(flat.device), w=w, h=h)

    def batched(self, planes) -> tuple:
        """(B, H, W) planes -> (ctx uint16, diff int8) host arrays."""
        ctx, diff = self._fields(self._tensor(planes))
        return to_numpy(ctx, np.uint16), to_numpy(diff, np.int8)
