"""colorlut's LUTs on tensors, and the .cube parser.

`apply_lut_3d` runs where the frame lies: on a CUDA tensor it launches
the hand-written kernel `lut3d_trilinear` (kernels/lut3d.cu, the port
of the Pallas kernel in gstpu/ops/lut_pallas.py) on the table's packed
form (`pack_lut_3d`, built once per LUT with its `DeviceLut`), on a
CPU tensor the plain version `apply_lut_3d_ref`.
`apply_lut_3d_packed_ref` is the kernel's addressing of the packed
table in tensor code. `apply_lut_1d` has no kernel, as the JAX package
has none: it is plain tensor code on either device.

The plain versions reproduce gstpu/ops/lut.py (apply_lut_3d,
apply_lut_1d) as the XLA CPU compiler runs them, bit for bit: XLA folds
`x / max_val * scale` into `x * (scale * (1 / max_val))`, and contracts
the domain affine, the lerps `a + (b - a) * t` and the final
`x * max_val + 0.5` into FMA, done here by `fma_f32`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from gstpu_torch.kernels import CudaKernel, stream_handle
from gstpu_torch.ops import empty_like_skewed, fma_f32


@dataclass
class CubeLut:
    """Parsed .cube LUT. 1D: tables (3, N); 3D: table (N, N, N, 3)
    indexed [b, g, r] (red fastest in the file)."""

    domain_scale: np.ndarray  # (3,)
    domain_offset: np.ndarray  # (3,)
    table_1d: np.ndarray | None = None
    table_3d: np.ndarray | None = None

    @property
    def is_3d(self) -> bool:
        return self.table_3d is not None

    @property
    def size(self) -> int:
        return (self.table_3d.shape[0] if self.is_3d
                else self.table_1d.shape[1])


class CubeParseError(ValueError):
    pass


def parse_cube(text: str) -> CubeLut:
    """Parse Adobe .cube text (parser.rs:57-110 semantics)."""
    domain_min = np.zeros(3, np.float32)
    domain_max = np.ones(3, np.float32)
    size_1d = None
    size_3d = None
    values: list[list[float]] = []

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0].upper()
        if key == "TITLE":
            continue
        if key == "LUT_1D_SIZE":
            size_1d = int(parts[1])
        elif key == "LUT_3D_SIZE":
            size_3d = int(parts[1])
        elif key == "DOMAIN_MIN":
            domain_min = np.array([float(v) for v in parts[1:4]], np.float32)
        elif key == "DOMAIN_MAX":
            domain_max = np.array([float(v) for v in parts[1:4]], np.float32)
        else:
            try:
                values.append([float(v) for v in parts[:3]])
            except ValueError:
                raise CubeParseError(f"bad LUT line: {line!r}")

    if (size_1d is None) == (size_3d is None):
        raise CubeParseError("need exactly one of LUT_1D_SIZE/LUT_3D_SIZE")
    data = np.asarray(values, np.float32)
    rng = domain_max - domain_min
    if np.any(rng <= 0):
        raise CubeParseError("invalid domain")
    scale = 1.0 / rng
    offset = -domain_min / rng
    if size_1d is not None:
        if data.shape != (size_1d, 3):
            raise CubeParseError(
                f"expected {size_1d} 1D entries, got {data.shape[0]}")
        return CubeLut(scale, offset, table_1d=data.T.copy())
    n = size_3d
    if data.shape != (n ** 3, 3):
        raise CubeParseError(
            f"expected {n**3} 3D entries, got {data.shape[0]}")
    # file order: red fastest -> reshape to [b, g, r, 3]
    return CubeLut(scale, offset, table_3d=data.reshape(n, n, n, 3))


def identity_lut(size: int = 2, three_d: bool = True) -> CubeLut:
    g = np.linspace(0.0, 1.0, size, dtype=np.float32)
    if not three_d:
        return CubeLut(np.ones(3, np.float32), np.zeros(3, np.float32),
                       table_1d=np.stack([g, g, g]))
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")
    table = np.stack([r, gg, b], axis=-1).astype(np.float32)
    return CubeLut(np.ones(3, np.float32), np.zeros(3, np.float32),
                   table_3d=table)


def pack_lut_3d(table: torch.Tensor) -> torch.Tensor:
    """The kernel's corner-packed table, on `table`'s device: (N, N, N,
    24) f32, entry [z, y, x] = for each channel c the 8 corners
    table[z + dz, y + dy, x + dx, c], dx fastest, then dy, then dz,
    each upper index clamped at N - 1. A pixel's 8 corners are then one
    96-byte entry, 3 memory sectors when the tensor is 32-byte aligned,
    as PyTorch's allocators align it."""
    n = table.shape[0]
    lo = torch.arange(n, device=table.device)
    hi = (lo + 1).clamp(max=n - 1)
    corners = [table[z][:, y][:, :, x]
               for z in (lo, hi) for y in (lo, hi) for x in (lo, hi)]
    return torch.stack(corners, dim=-1).reshape(n, n, n, 24).contiguous()


@dataclass
class DeviceLut:
    """A LUT ready for the frame path: the table as an f32 tensor on
    its device, (N, N, N, 3) for 3D or (3, N) for 1D, and for 3D its
    packed form (pack_lut_3d), built once beside it for the kernel; the
    domain stays on the host as (3,) f32 arrays, passed to kernels by
    value."""

    table: torch.Tensor
    domain_scale: np.ndarray
    domain_offset: np.ndarray
    packed: torch.Tensor | None = field(init=False)

    def __post_init__(self):
        self.domain_scale = np.asarray(self.domain_scale,
                                       np.float32).reshape(3)
        self.domain_offset = np.asarray(self.domain_offset,
                                        np.float32).reshape(3)
        self.packed = pack_lut_3d(self.table) if self.is_3d else None

    @property
    def is_3d(self) -> bool:
        return self.table.dim() == 4

    def to(self, device) -> DeviceLut:
        """This LUT on `device`: itself if it is there, else a copy
        whose packed table is built there."""
        device = torch.device(device)
        here = self.table.device
        if here == device or (device.index is None
                              and here.type == device.type):
            return self
        return DeviceLut(self.table.to(device), self.domain_scale,
                         self.domain_offset)


def lut_from_numpy(table: np.ndarray, domain_scale, domain_offset,
                   device) -> DeviceLut:
    """Carry a LUT's arrays (a CubeLut's table_3d or table_1d and its
    domain, from this package or the JAX one) onto `device`."""
    table = np.asarray(table, np.float32)
    n = table.shape[-1] if table.ndim == 2 else table.shape[0]
    if table.shape not in ((n, n, n, 3), (3, n)):
        raise ValueError(f"LUT table must be (N, N, N, 3) or (3, N), "
                         f"got {table.shape}")
    return DeviceLut(
        torch.from_numpy(np.ascontiguousarray(table)).to(device),
        domain_scale, domain_offset)


def _lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return fma_f32(b - a, t, a)


def _domain_k(scale: np.ndarray, max_val: int) -> np.ndarray:
    """scale * (1 / max_val) in f32: XLA's fold of `x / max * scale`."""
    return (np.asarray(scale, np.float32)
            * (np.float32(1.0) / np.float32(max_val))).astype(np.float32)


def _normalise(pix: torch.Tensor, scale, offset, max_val: int
               ) -> torch.Tensor:
    """(..., 3) pixel values -> domain coordinates clipped to [0, 1]."""
    k = torch.from_numpy(_domain_k(scale, max_val)).to(pix.device)
    off = torch.as_tensor(np.asarray(offset, np.float32), device=pix.device)
    return fma_f32(pix[..., :3].to(torch.float32), k, off).clamp(0.0, 1.0)


def _finish(res: torch.Tensor, pix: torch.Tensor, max_val: int
            ) -> torch.Tensor:
    """Round [0, 1] results to pixel values; channels past 3 pass."""
    out = torch.floor(fma_f32(res.clamp(0.0, 1.0), float(max_val), 0.5))
    out = out.to(pix.dtype)
    if pix.shape[-1] > 3:
        out = torch.cat([out, pix[..., 3:]], dim=-1)
    return out


def apply_lut_1d(pix: torch.Tensor, table: torch.Tensor, scale, offset, *,
                 max_val: int = 255) -> torch.Tensor:
    """pix: (..., C>=3) uint; per-channel linear interpolation
    (imp.rs:482-492). Alpha (channel 3+) passes through."""
    n = table.shape[1]
    x = _normalise(pix, scale, offset, max_val) * (n - 1.0)
    x0 = torch.floor(x).to(torch.int64).clamp(0, n - 1)
    x1 = (x0 + 1).clamp(max=n - 1)
    t = x - x0.to(torch.float32)
    res = torch.stack([_lerp(table[c][x0[..., c]], table[c][x1[..., c]],
                             t[..., c]) for c in range(3)], dim=-1)
    return _finish(res, pix, max_val)


def apply_lut_3d_ref(pix: torch.Tensor, table: torch.Tensor, scale, offset,
                     *, max_val: int = 255) -> torch.Tensor:
    """Plain version: pix (..., C>=3) uint; trilinear 3D LUT sampling
    (imp.rs:493-527). table: (N, N, N, 3) indexed [b, g, r]."""
    n = table.shape[0]
    xyz = _normalise(pix, scale, offset, max_val) * (n - 1.0)
    i0 = torch.floor(xyz).to(torch.int64).clamp(0, n - 1)
    i1 = (i0 + 1).clamp(max=n - 1)
    t = xyz - i0.to(torch.float32)
    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]

    def at(xi, yi, zi):
        return table[zi, yi, xi]  # [b, g, r] layout

    c00 = _lerp(at(x0, y0, z0), at(x1, y0, z0), tx)
    c10 = _lerp(at(x0, y1, z0), at(x1, y1, z0), tx)
    c01 = _lerp(at(x0, y0, z1), at(x1, y0, z1), tx)
    c11 = _lerp(at(x0, y1, z1), at(x1, y1, z1), tx)
    c0 = _lerp(c00, c10, ty)
    c1 = _lerp(c01, c11, ty)
    return _finish(_lerp(c0, c1, tz), pix, max_val)


def apply_lut_3d_packed_ref(pix: torch.Tensor, packed: torch.Tensor, scale,
                            offset, *, max_val: int = 255) -> torch.Tensor:
    """The kernel's addressing of the packed table (pack_lut_3d) in
    plain tensor code, for the tests and chip_smoke.py: the entry at
    flat float offset ((z0 * N + y0) * N + x0) * 24 holds channel c's
    corner (dx, dy, dz) at + c * 8 + dz * 4 + dy * 2 + dx; the upper
    indices x1, y1, z1 are never read."""
    n = packed.shape[0]
    flat = packed.reshape(-1)
    lanes = torch.arange(3, device=pix.device) * 8
    xyz = _normalise(pix, scale, offset, max_val) * (n - 1.0)
    i0 = torch.floor(xyz).to(torch.int64).clamp(0, n - 1)
    t = xyz - i0.to(torch.float32)
    x0, y0, z0 = i0.unbind(-1)
    e = (((z0 * n + y0) * n + x0) * 24).unsqueeze(-1) + lanes

    def corner(dx, dy, dz):
        return flat[e + dz * 4 + dy * 2 + dx]

    tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]
    c00 = _lerp(corner(0, 0, 0), corner(1, 0, 0), tx)
    c10 = _lerp(corner(0, 1, 0), corner(1, 1, 0), tx)
    c01 = _lerp(corner(0, 0, 1), corner(1, 0, 1), tx)
    c11 = _lerp(corner(0, 1, 1), corner(1, 1, 1), tx)
    c0 = _lerp(c00, c10, ty)
    c1 = _lerp(c01, c11, ty)
    return _finish(_lerp(c0, c1, tz), pix, max_val)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LUT_ARGS = [_P, _P, ctypes.c_longlong, _I, _P, _I,
             _F, _F, _F, _F, _F, _F, _P]
LUT_KERNEL = CudaKernel("lut3d_trilinear", "lut3d.cu", {
    "lut3d_trilinear_u8": _LUT_ARGS,
    "lut3d_trilinear_u16": _LUT_ARGS,
})
_LUT_SYMBOLS = {torch.uint8: ("lut3d_trilinear_u8", 255),
                torch.uint16: ("lut3d_trilinear_u16", 65535)}


def apply_lut_3d(pix: torch.Tensor, table: torch.Tensor, scale, offset, *,
                 max_val: int = 255, packed: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Trilinear 3D LUT on a (..., C) uint8 or uint16 frame, C = 3 or 4:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor. scale/offset: the (3,) f32 domain, on the host. The kernel
    reads `packed`, the table's pack_lut_3d (DeviceLut.packed), which
    a CUDA frame needs: it is built once per LUT, never here."""
    if pix.device.type == "cpu":
        return apply_lut_3d_ref(pix, table, scale, offset, max_val=max_val)
    if pix.device.type != "cuda":
        raise ValueError(f"apply_lut_3d: no kernel for {pix.device}")
    C = pix.shape[-1]
    if pix.dtype not in _LUT_SYMBOLS or C not in (3, 4) \
            or not pix.is_contiguous():
        raise ValueError("apply_lut_3d: needs a contiguous (..., 3|4) "
                         f"uint8/uint16 frame, got {pix.dtype} "
                         f"{tuple(pix.shape)}")
    symbol, kernel_max = _LUT_SYMBOLS[pix.dtype]
    if max_val != kernel_max:
        raise ValueError(f"apply_lut_3d: max_val {max_val} for {pix.dtype}")
    n = table.shape[0]
    if packed is None or packed.shape != (n, n, n, 24) \
            or packed.dtype != torch.float32 \
            or packed.device != pix.device or not packed.is_contiguous() \
            or packed.data_ptr() % 16:
        raise ValueError("apply_lut_3d: a CUDA frame needs `packed`, the "
                         "table's pack_lut_3d: a contiguous, 16-byte "
                         "aligned (N, N, N, 24) f32 tensor on the frame's "
                         "device")
    if C == 4 and pix.data_ptr() % (4 * pix.element_size()):
        raise ValueError("apply_lut_3d: 4-channel frames must be aligned "
                         "to a whole pixel")
    k = _domain_k(scale, max_val)
    off = np.asarray(offset, np.float32)
    out = empty_like_skewed(pix)
    LUT_KERNEL.launch(symbol, pix.data_ptr(), out.data_ptr(),
                      pix.numel() // C, C, packed.data_ptr(), n,
                      *map(float, k), *map(float, off),
                      stream_handle(pix.device))
    return out
