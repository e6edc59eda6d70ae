"""Audio format descriptors (gst-audio AudioInfo analogue).

The typed view of "audio/x-raw" caps that AudioFilter-style elements
negotiate (reference audio/audiofx/src/audioecho/imp.rs caps F32/F64;
audioloudnorm requires F64 interleaved @192kHz, imp.rs:1846-1871).
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, IntRange, Structure

AUDIO_FORMATS: dict[str, np.dtype] = {
    "F64LE": np.dtype("<f8"),
    "F32LE": np.dtype("<f4"),
    "S32LE": np.dtype("<i4"),
    "S16LE": np.dtype("<i2"),
    "F64BE": np.dtype(">f8"),
    "F32BE": np.dtype(">f4"),
    "S32BE": np.dtype(">i4"),
    "S16BE": np.dtype(">i2"),
    "U8": np.dtype("u1"),
    "S8": np.dtype("i1"),
}

# the formats a tensor holds as they are (little-endian host)
TENSOR_DTYPES: dict[str, torch.dtype] = {
    "F64LE": torch.float64,
    "F32LE": torch.float32,
    "S32LE": torch.int32,
    "S16LE": torch.int16,
    "U8": torch.uint8,
    "S8": torch.int8,
}

# Packed 24-bit (3 bytes/sample on the wire, gst-audio S24BE/S24LE
# semantics — the RTP L24 linear-audio payload format, RFC 3551 §4.5.10).
# The logical working dtype is i4 (sign-extended); pack/unpack below.
PACKED_24_FORMATS = ("S24BE", "S24LE")

ALL_AUDIO_FORMATS = tuple(AUDIO_FORMATS) + PACKED_24_FORMATS


def unpack_s24(data: bytes | np.ndarray, fmt: str) -> np.ndarray:
    """Packed 3-byte samples -> sign-extended int32 (1-D)."""
    raw = np.frombuffer(data, np.uint8) if isinstance(data, bytes) \
        else np.asarray(data, np.uint8).reshape(-1)
    raw = raw.reshape(-1, 3).astype(np.int32)
    hi, mid, lo = ((raw[:, 0], raw[:, 1], raw[:, 2])
                   if fmt == "S24BE" else
                   (raw[:, 2], raw[:, 1], raw[:, 0]))
    v = (hi << 16) | (mid << 8) | lo
    return v - ((v & 0x800000) << 1)     # sign extend


def pack_s24(samples: np.ndarray, fmt: str) -> np.ndarray:
    """int32 logical samples -> packed 3-byte rows (uint8, 1-D)."""
    v = np.asarray(samples, np.int64).reshape(-1) & 0xFFFFFF
    out = np.empty((v.size, 3), np.uint8)
    hi, mid, lo = v >> 16, (v >> 8) & 0xFF, v & 0xFF
    if fmt == "S24BE":
        out[:, 0], out[:, 1], out[:, 2] = hi, mid, lo
    else:
        out[:, 0], out[:, 1], out[:, 2] = lo, mid, hi
    return out.reshape(-1)


def audio_caps(formats=None, rate=None, channels=None,
               layout: str = "interleaved") -> Caps:
    """Build audio/x-raw caps with optional constraints."""
    st = Structure("audio/x-raw")
    if formats is None:
        st["format"] = AnyList(ALL_AUDIO_FORMATS)
    elif isinstance(formats, str):
        st["format"] = formats
    else:
        st["format"] = AnyList(tuple(formats)) if len(formats) > 1 else formats[0]
    st["rate"] = rate if rate is not None else IntRange(1, 2**31 - 1)
    st["channels"] = channels if channels is not None else IntRange(1, 2**31 - 1)
    st["layout"] = layout
    return Caps([st])


@dataclass
class AudioInfo:
    format: str
    rate: int
    channels: int
    layout: str = "interleaved"

    @property
    def packed24(self) -> bool:
        return self.format in PACKED_24_FORMATS

    @property
    def dtype(self) -> np.dtype:
        """Logical working dtype (i4 for packed 24-bit)."""
        if self.packed24:
            return np.dtype(np.int32)
        return AUDIO_FORMATS[self.format]

    @property
    def sample_size(self) -> int:
        """Bytes per sample on the wire (3 for packed 24-bit)."""
        return 3 if self.packed24 else self.dtype.itemsize

    @property
    def bpf(self) -> int:
        """Bytes per frame (all channels of one sample instant)."""
        return self.sample_size * self.channels

    @staticmethod
    def from_caps(caps: Caps) -> "AudioInfo":
        if not caps.is_fixed():
            raise ValueError(f"AudioInfo needs fixed caps: {caps!r}")
        s = caps[0]
        if s.name != "audio/x-raw":
            raise ValueError(f"not raw audio caps: {caps!r}")
        return AudioInfo(format=s["format"], rate=int(s["rate"]),
                         channels=int(s["channels"]),
                         layout=s.get("layout", "interleaved"))

    def to_caps(self) -> Caps:
        return Caps.new("audio/x-raw", format=self.format, rate=self.rate,
                        channels=self.channels, layout=self.layout)

    # -- buffer <-> ndarray views --------------------------------------
    def view(self, buf: Buffer) -> np.ndarray:
        """(frames, channels) view of an interleaved buffer.

        Zero-copy except for packed 24-bit formats, which are
        unpacked to sign-extended int32 (a copy)."""
        arr = buf.array
        if self.packed24:
            return unpack_s24(arr.tobytes() if arr.dtype != np.uint8
                              else arr, self.format) \
                .reshape(-1, self.channels)
        if arr.dtype != self.dtype:
            arr = arr.view(self.dtype)
        return arr.reshape(-1, self.channels)

    def tensor(self, buf: Buffer, device) -> torch.Tensor:
        """(frames, channels) tensor of an interleaved buffer. A tensor
        payload is reshaped where it lies, without a transfer; a host
        payload is uploaded once to `device`. Only the formats of
        TENSOR_DTYPES have a tensor form."""
        dtype = TENSOR_DTYPES.get(self.format)
        if dtype is None:
            raise ValueError(f"tensor() has no form for {self.format}")
        d = buf.data
        if isinstance(d, torch.Tensor):
            if d.dtype != dtype:
                d = d.contiguous().view(torch.uint8).view(dtype)
            return d.reshape(-1, self.channels)
        arr = self.view(buf)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr).to(device)

    def make_buffer(self, samples: np.ndarray, *, pts: int | None = None,
                    duration: int | None = None) -> Buffer:
        if self.packed24:
            samples = np.asarray(samples)
            if samples.ndim == 1:
                samples = samples.reshape(-1, self.channels)
            n = samples.shape[0]
            if duration is None:
                duration = frames_to_ns(n, self.rate)
            return Buffer(pack_s24(samples, self.format), pts=pts,
                          duration=duration)
        samples = np.ascontiguousarray(samples, dtype=self.dtype)
        if samples.ndim == 1:
            samples = samples.reshape(-1, self.channels)
        n = samples.shape[0]
        if duration is None:
            duration = frames_to_ns(n, self.rate)
        return Buffer(samples, pts=pts, duration=duration)


def frames_to_ns(n: int, rate: int) -> int:
    return (n * 1_000_000_000) // rate


def ns_to_frames(t: int, rate: int) -> int:
    return (t * rate) // 1_000_000_000
