"""hsvfilter's per-pixel HSV adjust and hsvdetector's HSV key on tensors.

`hsv_filter_frame` runs on a frame's tensor where it lies: on a CUDA
tensor it launches the hand-written kernel `hsv_filter_u8`
(kernels/hsv_filter.cu, the port of the Pallas kernels in
gstpu/ops/hsv_pallas.py), on a CPU tensor the plain version
`hsv_filter_frame_ref`.

The plain version reproduces gstpu/ops/hsv.py (hsv_filter_frame) as the
XLA CPU compiler runs it, bit for bit over all 2^24 colours:
- XLA turns `x / 255.0` and `h / 60.0` into multiplications by the f32
  reciprocal, which differ from IEEE division for some inputs;
- it contracts the S and V affine adjusts `mul * x + off` into FMA,
  done here by `fma_f32`;
- `jnp.mod` is C fmod plus a sign fix, exact; `torch.remainder` is a
  different function, so `_floor_mod` uses `torch.fmod`.

hsvdetector (`hsv_detect`, `hsv_detect_frame`) reaches no Pallas kernel in
gstpu: its port is torch ops on the same RGB->HSV planes
(`_rgb_planes_to_hsv`), which run on the device of the frame.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gstpu_torch.kernels import CudaKernel, stream_handle
from gstpu_torch.ops import empty_like_skewed, fma_f32

EPSILON = 1e-5
_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_INV_60 = float(np.float32(1.0) / np.float32(60.0))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
HSV_KERNEL = CudaKernel("hsv_filter_u8", "hsv_filter.cu", {
    "hsv_filter_u8": [_P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                      _F, _F, _F, _F, _F, _P],
    # a check of the kernel's division, run by chip_smoke.py
    "hsv_div_rn_mismatches": [_P, _I, _P, _I, _P, _P],
})


def _f32(x: float) -> float:
    """A uniform as the f32 value the kernels receive."""
    return float(np.float32(x))


def _floor_mod(a: torch.Tensor, m: float) -> torch.Tensor:
    """jnp.mod for a positive modulus: fmod (exact) plus the sign fix."""
    r = torch.fmod(a, m)
    return torch.where(r < 0.0, r + m, r)


def _rgb_planes_to_hsv(r_u8: torch.Tensor, g_u8: torch.Tensor,
                       b_u8: torch.Tensor) -> tuple:
    """The f32 (h, s, v) planes of three u8 colour planes
    (gstpu/ops/hsv.py _rgb_planes_to_hsv, as XLA's CPU code runs it)."""
    r, g, b = (c.to(torch.float32) * _INV_255 for c in (r_u8, g_u8, b_u8))
    value = torch.maximum(torch.maximum(r, g), b)
    chroma = value - torch.minimum(torch.minimum(r, g), b)
    safe = torch.where(chroma == 0.0, 1.0, chroma)
    zero = torch.zeros_like(value)
    hue = torch.where(
        chroma == 0.0, zero,
        torch.where((value - r).abs() < EPSILON, 60.0 * ((g - b) / safe),
                    torch.where((value - g).abs() < EPSILON,
                                60.0 * (2.0 + (b - r) / safe),
                                torch.where((value - b).abs() < EPSILON,
                                            60.0 * (4.0 + (r - g) / safe),
                                            zero))))
    hue = _floor_mod(torch.where(hue < 0.0, hue + 360.0, hue), 360.0)
    sat = torch.where(value == 0.0, zero,
                      chroma / torch.where(value == 0.0, 1.0, value))
    return hue, sat.clamp(0.0, 1.0), value.clamp(0.0, 1.0)


def hsv_filter_frame_ref(frame: torch.Tensor, rgb_idx: tuple,
                         hue_shift: float, sat_mul: float, sat_off: float,
                         val_mul: float, val_off: float) -> torch.Tensor:
    """Plain version: (..., C) uint8 frame in its native channel order;
    the planes at rgb_idx go through the HSV adjust, the rest pass
    through. Returns a new tensor."""
    hue_shift, sat_mul, sat_off, val_mul, val_off = map(
        _f32, (hue_shift, sat_mul, sat_off, val_mul, val_off))
    ri, gi, bi = rgb_idx
    hue, sat, value = _rgb_planes_to_hsv(frame[..., ri], frame[..., gi],
                                         frame[..., bi])
    zero = torch.zeros_like(value)

    h = _floor_mod(hue + hue_shift, 360.0)
    h = torch.where(h < 0.0, h + 360.0, h)
    s = fma_f32(sat, sat_mul, sat_off).clamp(0.0, 1.0)
    v = fma_f32(value, val_mul, val_off).clamp(0.0, 1.0)

    c = v * s
    hp = h * _INV_60
    x = c * (1.0 - (_floor_mod(hp, 2.0) - 1.0).abs())
    m = v - c
    table = [(c, x, zero), (x, c, zero), (zero, c, x),
             (zero, x, c), (x, zero, c), (c, zero, x)]
    out = frame.clone()
    for comp, idx in enumerate((ri, gi, bi)):
        o = zero
        for i in reversed(range(6)):
            o = torch.where(hp <= i + 1.0, table[i][comp], o)
        o = torch.where(hp < 0.0, zero, o)
        out[..., idx] = ((o + m) * 255.0).clamp(0.0, 255.0).to(torch.uint8)
    return out


def hsv_filter_frame(frame: torch.Tensor, rgb_idx: tuple, hue_shift: float,
                     sat_mul: float, sat_off: float, val_mul: float,
                     val_off: float, out: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """hsvfilter on a (..., C) uint8 frame, C = 3 or 4: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor. `out` (CUDA
    only) may be `frame` itself for an in-place run."""
    if frame.device.type == "cpu":
        if out is not None:
            raise ValueError("hsv_filter_frame: `out` is for CUDA frames")
        return hsv_filter_frame_ref(frame, rgb_idx, hue_shift, sat_mul,
                                    sat_off, val_mul, val_off)
    if frame.device.type != "cuda":
        raise ValueError(f"hsv_filter_frame: no kernel for {frame.device}")
    C = frame.shape[-1]
    if frame.dtype != torch.uint8 or C not in (3, 4) \
            or not frame.is_contiguous() \
            or not all(0 <= i < C for i in rgb_idx):
        raise ValueError("hsv_filter_frame: needs a contiguous (..., 3|4) "
                         f"uint8 frame, got {frame.dtype} "
                         f"{tuple(frame.shape)} rgb_idx={rgb_idx}")
    if out is None:
        out = empty_like_skewed(frame)
    elif out.shape != frame.shape or out.dtype != frame.dtype \
            or out.device != frame.device or not out.is_contiguous():
        raise ValueError("hsv_filter_frame: `out` must match `frame`")
    if C == 4 and (frame.data_ptr() % 4 or out.data_ptr() % 4):
        raise ValueError("hsv_filter_frame: RGBA frames must be 4-byte "
                         "aligned")
    ri, gi, bi = rgb_idx
    HSV_KERNEL.launch(
        "hsv_filter_u8", frame.data_ptr(), out.data_ptr(),
        frame.numel() // C, C, ri, gi, bi, _f32(hue_shift), _f32(sat_mul),
        _f32(sat_off), _f32(val_mul), _f32(val_off),
        stream_handle(frame.device))
    return out


def _uniform(u, ndim: int):
    """A detector uniform as the f32 value gstpu casts it to: a float,
    or a (B, 1) tensor of per-lane values shaped to broadcast against
    (B, ...) planes of `ndim` dims."""
    if isinstance(u, torch.Tensor):
        return u.to(torch.float32).reshape(-1, *(1,) * (ndim - 1))
    return _f32(u)


def _hsv_match(h, s, v, hue_ref, hue_var, sat_ref, sat_var, val_ref,
               val_var) -> torch.Tensor:
    """The boolean HSV-window match on (h, s, v) planes
    (gstpu/ops/hsv.py _hsv_match): `180 - hue_ref` is one f32 value, as
    XLA computes it, before it is added to the plane."""
    hue_ref, hue_var, sat_ref, sat_var, val_ref, val_var = (
        _uniform(u, h.dim()) for u in
        (hue_ref, hue_var, sat_ref, sat_var, val_ref, val_var))
    if isinstance(hue_ref, torch.Tensor):
        offset = 180.0 - hue_ref
    else:
        offset = _f32(np.float32(180.0) - np.float32(hue_ref))
    shifted = h + offset
    shifted = _floor_mod(torch.where(shifted < 0.0, shifted + 360.0,
                                     shifted), 360.0)
    return (((shifted - 180.0).abs() <= hue_var)
            & ((s - sat_ref).abs() <= sat_var)
            & ((v - val_ref).abs() <= val_var))


def hsv_detect(rgb: torch.Tensor, hue_ref, hue_var, sat_ref, sat_var,
               val_ref, val_var) -> torch.Tensor:
    """hsvdetector's match mask of a (..., 3) uint8 RGB frame: 255 where
    the pixel lies in the HSV key window (circular hue), else 0."""
    match = _hsv_match(*_rgb_planes_to_hsv(rgb[..., 0], rgb[..., 1],
                                           rgb[..., 2]),
                       hue_ref, hue_var, sat_ref, sat_var, val_ref, val_var)
    return match.to(torch.uint8) * 255


def hsv_detect_frame(frame: torch.Tensor, rgb_idx: tuple, out_idx: tuple,
                     hue_ref, hue_var, sat_ref, sat_var, val_ref,
                     val_var) -> torch.Tensor:
    """hsvdetector on a (..., C) uint8 frame in its native channel order:
    the planes at rgb_idx feed the window match, and the (..., 4) output
    holds them at out_idx = (r, g, b, alpha) with the mask as alpha.
    Torch ops on the frame's device. Each uniform is a float, or a
    (B, 1) tensor of per-lane values for a (B, H, W, C) batch."""
    ri, gi, bi = rgb_idx
    rgb = (frame[..., ri], frame[..., gi], frame[..., bi])
    match = _hsv_match(*_rgb_planes_to_hsv(*rgb), hue_ref, hue_var,
                       sat_ref, sat_var, val_ref, val_var)
    chans: list = [None] * 4
    ro, go, bo, ao = out_idx
    chans[ro], chans[go], chans[bo] = rgb
    chans[ao] = match.to(torch.uint8) * 255
    return torch.stack(chans, -1)
