"""Build the repository's native host libraries for the port.

The C++ sources stay in the top-level `native/` directory, where gstpu
builds them with `native/Makefile`. The port compiles them itself at
first use, with `g++` and the Makefile's CXXFLAGS, into
`build/torch_ext/` beside its CUDA kernels, so neither `make` nor a
prebuilt library in the checkout is needed. It leaves out the Makefile's
`-march=native` for the FFV1 coder: the flags stay portable, so a
library built on one host loads on another, and the bitstream does not
depend on them. A library is named by a hash of its source and flags,
and written under a temporary name and renamed, so that processes
building at once never load a half-written file.

After `build_library` comes the port's copy of gstpu/native.py's bindings:
`native/gstpu_native.cpp` (G.711 tables, CRC32/32C) through ctypes,
with gstpu's numpy tables where the library cannot be built, as in
gstpu, which builds it with `make -C native`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import zlib
from pathlib import Path

import numpy as np

from gstpu_torch.kernels import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-Wall", "-std=c++17")


def build_library(source: str, libs: tuple = ()) -> Path | None:
    """`native/<source>` built into a shared library; its path, or None
    when the compiler is missing or refuses the source (a library it
    links against is absent)."""
    src = NATIVE_DIR / source
    h = hashlib.sha1(" ".join((*CXXFLAGS, *libs)).encode())
    h.update(src.read_bytes())
    lib = BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, "-o", str(tmp), str(src), *libs]
    try:
        r = subprocess.run(cmd, capture_output=True)
    except OSError:                        # no compiler
        return None
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


# ---------------------------------------------------------------------------
# the runtime library: G.711 and CRC
# ---------------------------------------------------------------------------

_LIB = None


def load():
    """Load (building it at first use) the native runtime library;
    returns the ctypes handle or None."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build_library("gstpu_native.cpp")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    p, n = ctypes.c_void_p, ctypes.c_size_t
    for fn in ("gstpu_alaw_encode", "gstpu_alaw_decode",
               "gstpu_mulaw_encode", "gstpu_mulaw_decode"):
        getattr(lib, fn).argtypes = (p, p, n)
        getattr(lib, fn).restype = None
    for fn in ("gstpu_crc32", "gstpu_crc32c"):
        getattr(lib, fn).argtypes = (p, n, ctypes.c_uint32)
        getattr(lib, fn).restype = ctypes.c_uint32
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


def _np_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _alaw_tables():
    """Decode table from the canonical G.711 segment algorithm
    (mirrors native/gstpu_native.cpp alaw_to_linear)."""
    dec = np.zeros(256, np.int16)
    for a0 in range(256):
        a = a0 ^ 0x55
        t = (a & 0x0F) << 4
        seg = (a & 0x70) >> 4
        if seg == 0:
            t += 8
        elif seg == 1:
            t += 0x108
        else:
            t = (t + 0x108) << (seg - 1)
        dec[a0] = t if (a & 0x80) else -t
    return dec


def _mulaw_tables():
    dec = np.zeros(256, np.int16)
    for u0 in range(256):
        u = (~u0) & 0xFF
        t = ((u & 0x0F) << 3) + 0x84
        t <<= (u & 0x70) >> 4
        t -= 0x84
        dec[u0] = -t if (u & 0x80) else t
    return dec


_ALAW_DEC = _alaw_tables()
_MULAW_DEC = _mulaw_tables()
_ALAW_ENC_LUT = None
_MULAW_ENC_LUT = None


def _build_enc_lut(law: str) -> np.ndarray:
    """Exact 16-bit -> code LUT from the segment algorithm (bit-
    identical to the native encoders)."""
    pcm = np.arange(-32768, 32768, dtype=np.int32)
    if law == "alaw":
        v = pcm >> 3
        mask = np.where(v >= 0, 0xD5, 0x55).astype(np.int32)
        v = np.where(v >= 0, v, -v - 1)
        ends = np.array([0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF,
                         0xFFF])
        seg = np.searchsorted(ends, v, side="left")
        shift = np.where(seg < 2, 1, seg)
        aval = (np.minimum(seg, 7) << 4) | ((v >> shift) & 0x0F)
        aval = np.where(seg >= 8, 0x7F, aval)
        return ((aval ^ mask) & 0xFF).astype(np.uint8)
    v = pcm >> 2
    mask = np.where(v < 0, 0x7F, 0xFF).astype(np.int32)
    v = np.abs(v)
    v = np.minimum(v, 8159) + 33
    ends = np.array([0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF,
                     0x1FFF])
    seg = np.searchsorted(ends, v, side="left")
    uval = (np.minimum(seg, 7) << 4) | ((v >> (np.minimum(seg, 7) + 1))
                                        & 0x0F)
    uval = np.where(seg >= 8, 0x7F, uval)
    return ((uval ^ mask) & 0xFF).astype(np.uint8)


def alaw_encode(pcm: np.ndarray) -> np.ndarray:
    pcm = np.ascontiguousarray(pcm, np.int16)
    out = np.empty(pcm.size, np.uint8)
    lib = load()
    if lib is not None:
        lib.gstpu_alaw_encode(_np_ptr(pcm), _np_ptr(out), pcm.size)
        return out
    global _ALAW_ENC_LUT
    if _ALAW_ENC_LUT is None:
        _ALAW_ENC_LUT = _build_enc_lut("alaw")
    return _ALAW_ENC_LUT[pcm.astype(np.int32) + 32768]


def alaw_decode(codes: np.ndarray) -> np.ndarray:
    codes = np.ascontiguousarray(codes, np.uint8)
    lib = load()
    if lib is not None:
        out = np.empty(codes.size, np.int16)
        lib.gstpu_alaw_decode(_np_ptr(codes), _np_ptr(out), codes.size)
        return out
    return _ALAW_DEC[codes]


def mulaw_encode(pcm: np.ndarray) -> np.ndarray:
    pcm = np.ascontiguousarray(pcm, np.int16)
    lib = load()
    if lib is not None:
        out = np.empty(pcm.size, np.uint8)
        lib.gstpu_mulaw_encode(_np_ptr(pcm), _np_ptr(out), pcm.size)
        return out
    global _MULAW_ENC_LUT
    if _MULAW_ENC_LUT is None:
        _MULAW_ENC_LUT = _build_enc_lut("mulaw")
    return _MULAW_ENC_LUT[pcm.astype(np.int32) + 32768]


def mulaw_decode(codes: np.ndarray) -> np.ndarray:
    codes = np.ascontiguousarray(codes, np.uint8)
    lib = load()
    if lib is not None:
        out = np.empty(codes.size, np.int16)
        lib.gstpu_mulaw_decode(_np_ptr(codes), _np_ptr(out), codes.size)
        return out
    return _MULAW_DEC[codes]


def crc32(data: bytes, seed: int = 0) -> int:
    lib = load()
    if lib is not None:
        buf = np.frombuffer(data, np.uint8)
        return int(lib.gstpu_crc32(_np_ptr(buf), buf.size, seed))
    return zlib.crc32(data, seed)


_CRC32C_TABLE = None


def crc32c(data: bytes, seed: int = 0) -> int:
    lib = load()
    if lib is not None:
        buf = np.frombuffer(data, np.uint8)
        return int(lib.gstpu_crc32c(_np_ptr(buf), buf.size, seed))
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    c = seed ^ 0xFFFFFFFF
    for b in data:
        c = _CRC32C_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF
