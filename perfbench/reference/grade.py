"""Plain reference of the 4K grade, `hsvfilter ! colorlut`, on tensors.

It imports nothing of the program. It follows the JAX package's
arithmetic as its CPU compilation runs it, which the port's kernels
match bit for bit: `x / 255` and `h / 60` as products with the f32
reciprocal, the S and V adjusts, the LUT domain, the lerps and the final
rounding as fused multiply-adds (one rounding), `jnp.mod` as fmod with a
sign fix. The colour table is read directly, (N, N, N, 3) indexed
[b, g, r] (gst-plugins-rs video/hsv and the .cube layout).

`dt` is the float type of the arithmetic: float32 is the reference,
bfloat16 its control (the nearest precision below the configuration's
f32). A fused multiply-add is computed in float64 and rounded once to
`dt`.
"""

from __future__ import annotations

import numpy as np
import torch

EPSILON = 1e-5


def _fma(a: torch.Tensor, b, c, dt) -> torch.Tensor:
    return (a.double() * b + c).to(dt)


def _inv(x: float, dt) -> float:
    """1 / x rounded to `dt`, as a Python float."""
    return float(torch.tensor(1.0, dtype=dt) / torch.tensor(x, dtype=dt))


def _as(x: float, dt) -> float:
    return float(torch.tensor(x, dtype=dt))


def _floor_mod(a: torch.Tensor, m: float) -> torch.Tensor:
    r = torch.fmod(a, m)
    return torch.where(r < 0.0, r + m, r)


def hsv_filter(frame: torch.Tensor, hue_shift: float, sat_mul: float,
               sat_off: float, val_mul: float, val_off: float,
               dt=torch.float32) -> torch.Tensor:
    """(..., 4) uint8 RGBA: RGB through the HSV adjust, alpha passed."""
    hue_shift, sat_mul, sat_off, val_mul, val_off = (
        _as(v, dt) for v in (hue_shift, sat_mul, sat_off, val_mul, val_off))
    inv255, inv60 = _inv(255.0, dt), _inv(60.0, dt)
    r, g, b = (frame[..., i].to(dt) * inv255 for i in range(3))
    value = torch.maximum(torch.maximum(r, g), b)
    chroma = value - torch.minimum(torch.minimum(r, g), b)
    safe = torch.where(chroma == 0.0, 1.0, chroma).to(dt)
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
                      chroma / torch.where(value == 0.0, 1.0, value).to(dt))
    sat, value = sat.clamp(0.0, 1.0), value.clamp(0.0, 1.0)

    h = _floor_mod(hue + hue_shift, 360.0)
    h = torch.where(h < 0.0, h + 360.0, h)
    s = _fma(sat, sat_mul, sat_off, dt).clamp(0.0, 1.0)
    v = _fma(value, val_mul, val_off, dt).clamp(0.0, 1.0)
    c = v * s
    hp = h * inv60
    x = c * (1.0 - (_floor_mod(hp, 2.0) - 1.0).abs())
    m = v - c
    table = [(c, x, zero), (x, c, zero), (zero, c, x),
             (zero, x, c), (x, zero, c), (c, zero, x)]
    out = frame.clone()
    for comp in range(3):
        o = zero
        for i in reversed(range(6)):
            o = torch.where(hp <= i + 1.0, table[i][comp], o)
        o = torch.where(hp < 0.0, zero, o)
        out[..., comp] = ((o + m) * 255.0).clamp(0.0, 255.0).to(torch.uint8)
    return out


def lut_3d(pix: torch.Tensor, table: torch.Tensor, scale, offset,
           dt=torch.float32) -> torch.Tensor:
    """(..., 4) uint8 through a trilinear 3D LUT, alpha passed. table:
    (N, N, N, 3) f32 indexed [b, g, r]; scale, offset: the (3,) domain."""
    n = table.shape[0]
    table = table.to(dt)
    k = (np.asarray(scale, np.float32)
         * (np.float32(1.0) / np.float32(255.0))).astype(np.float32)
    k = torch.from_numpy(k).to(pix.device).to(dt)
    off = torch.as_tensor(np.asarray(offset, np.float32),
                          device=pix.device).to(dt)
    xyz = _fma(pix[..., :3].to(dt), k, off, dt).clamp(0.0, 1.0) * (n - 1.0)
    i0 = torch.floor(xyz).to(torch.int64).clamp(0, n - 1)
    i1 = (i0 + 1).clamp(max=n - 1)
    t = xyz - i0.to(dt)
    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]

    def at(xi, yi, zi):
        return table[zi, yi, xi]

    def lerp(a, b, w):
        return _fma(b - a, w, a, dt)

    c0 = lerp(lerp(at(x0, y0, z0), at(x1, y0, z0), tx),
              lerp(at(x0, y1, z0), at(x1, y1, z0), tx), ty)
    c1 = lerp(lerp(at(x0, y0, z1), at(x1, y0, z1), tx),
              lerp(at(x0, y1, z1), at(x1, y1, z1), tx), ty)
    res = lerp(c0, c1, tz).clamp(0.0, 1.0)
    out = torch.floor(_fma(res, 255.0, 0.5, dt)).to(pix.dtype)
    return torch.cat([out, pix[..., 3:]], dim=-1)


def grade(frame: torch.Tensor, cfg: dict, table: torch.Tensor,
          dt=torch.float32) -> torch.Tensor:
    """The configuration's whole chain on one frame."""
    h = cfg["hsv"]
    mid = hsv_filter(frame, h["hue_shift"], h["saturation_mul"],
                     h["saturation_off"], h["value_mul"], h["value_off"], dt)
    lut = cfg["lut"]
    return lut_3d(mid, table, lut["domain_scale"], lut["domain_offset"], dt)
