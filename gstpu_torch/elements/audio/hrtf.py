"""hrtfrender / sofalizer: binaural rendering elements.

The port of gstpu/elements/audio/hrtf.py, which rebuilds the reference
audio/hrtf crate (src/hrtf/imp.rs, src/sofa/imp.rs): N input channels
are virtual sources rendered to stereo by convolving each channel with a
direction-dependent head-related impulse response. The per-channel block
FFT convolution of the reference (hrtf crate block 512 / interpolation
steps 8; sofar partitioned FIR) runs here as one batched overlap-save
rFFT over all channels (gstpu_torch.ops.fftconv, torch.fft on
default_device()) — the reference's rayon channel parallelism
(imp.rs:237-243) becomes a batch axis. The sphere and SOFA handling
and the direction sampling are gstpu's numpy code as it stands; the
convolution runs in the dtypes gstpu computes (f32 FFTs, the
hrtfrender gains and channel sum and the sofalizer crossfade in f64).
Output buffers are host arrays, as in gstpu.

HRIR sphere format: the binary `.hrir` format of the hrtf crate
(magic "HRIR", rate, length, vertex/index tables, per-vertex L/R IRs);
SOFA files are read via h5py (Data.IR / SourcePosition conventions),
imported only when one is read or written.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from gstpu_torch.core.adapter import SampleAdapter
from gstpu_torch.core.audio import AudioInfo, audio_caps
from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, IntRange, Structure
from gstpu_torch.core.device import default_device
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.query import LatencyQuery
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.ops.fftconv import (next_pow2, ols_block, upc_block,
                                     upc_init, upc_ir_rfft)

SECOND = 1_000_000_000


def _dev_rfft(irs_real: np.ndarray, nfft: int) -> torch.Tensor:
    """rfft of real IRs, rounded to f32 and computed on
    default_device() (the element's DSP is f32)."""
    a = torch.from_numpy(np.asarray(irs_real, np.float32))
    return torch.fft.rfft(a.to(default_device()), n=nfft, dim=-1)


def _upload(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """A host array on default_device() in `dtype`."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(
        device=default_device(), dtype=dtype)


# ---------------------------------------------------------------------------
# HRIR sphere (.hrir) loading + direction sampling
# ---------------------------------------------------------------------------

class HrirSphere:
    """Triangulated sphere of HRIR pairs (hrtf-crate .hrir format)."""

    def __init__(self, vertices: np.ndarray, indices: np.ndarray,
                 left: np.ndarray, right: np.ndarray, rate: int):
        self.vertices = vertices      # (V, 3)
        self.indices = indices.reshape(-1, 3)  # (F, 3)
        self.left = left              # (V, L)
        self.right = right            # (V, L)
        self.rate = rate

    @property
    def ir_len(self) -> int:
        return self.left.shape[1]

    @staticmethod
    def from_bytes(data: bytes) -> "HrirSphere":
        if data[:4] != b"HRIR":
            raise ValueError("not an HRIR sphere file")
        rate, length, vertex_count, index_count = struct.unpack_from(
            "<IIII", data, 4)
        off = 20
        indices = np.frombuffer(data, "<u4", index_count, off)
        off += 4 * index_count
        verts = np.empty((vertex_count, 3), np.float32)
        left = np.empty((vertex_count, length), np.float32)
        right = np.empty((vertex_count, length), np.float32)
        for v in range(vertex_count):
            verts[v] = np.frombuffer(data, "<f4", 3, off)
            off += 12
            left[v] = np.frombuffer(data, "<f4", length, off)
            off += 4 * length
            right[v] = np.frombuffer(data, "<f4", length, off)
            off += 4 * length
        return HrirSphere(verts, indices, left, right, rate)

    @staticmethod
    def to_bytes(vertices, indices, left, right, rate) -> bytes:
        """Serializer (tests/tools generate synthetic spheres)."""
        out = [b"HRIR", struct.pack("<IIII", rate, left.shape[1],
                                    len(vertices), indices.size)]
        out.append(np.asarray(indices, "<u4").tobytes())
        for v in range(len(vertices)):
            out.append(np.asarray(vertices[v], "<f4").tobytes())
            out.append(np.asarray(left[v], "<f4").tobytes())
            out.append(np.asarray(right[v], "<f4").tobytes())
        return b"".join(out)

    def sample(self, direction: np.ndarray) -> np.ndarray:
        """IR pair for a direction: barycentric blend of the
        intersected face's vertex IRs (hrtf-crate sampling), nearest
        vertex as fallback. Returns (2, L)."""
        d = np.asarray(direction, np.float64)
        n = np.linalg.norm(d)
        if n < 1e-9:
            d = np.array([0.0, 0.0, 1.0])
        else:
            d = d / n
        for face in self.indices:
            a, b, c = (self.vertices[face[0]], self.vertices[face[1]],
                       self.vertices[face[2]])
            w = _ray_triangle_barycentric(d, a, b, c)
            if w is not None:
                l_ = (w[0] * self.left[face[0]] + w[1] * self.left[face[1]]
                      + w[2] * self.left[face[2]])
                r_ = (w[0] * self.right[face[0]]
                      + w[1] * self.right[face[1]]
                      + w[2] * self.right[face[2]])
                return np.stack([l_, r_])
        dots = self.vertices @ d
        v = int(np.argmax(dots))
        return np.stack([self.left[v], self.right[v]])


def _ray_triangle_barycentric(d, a, b, c):
    """Intersect ray (origin, direction d) with triangle abc; return
    barycentric weights or None."""
    eps = 1e-9
    e1, e2 = b - a, c - a
    p = np.cross(d, e2)
    det = float(e1 @ p)
    if abs(det) < eps:
        return None
    inv = 1.0 / det
    t = -a
    u = float(t @ p) * inv
    if u < -1e-6 or u > 1 + 1e-6:
        return None
    q = np.cross(t, e1)
    v = float(d @ q) * inv
    if v < -1e-6 or u + v > 1 + 1e-6:
        return None
    dist = float(e2 @ q) * inv
    if dist <= 0:
        return None
    return np.array([1.0 - u - v, u, v])


# ---------------------------------------------------------------------------
# hrtfrender
# ---------------------------------------------------------------------------

def _hrtf_sink_caps() -> Caps:
    return audio_caps(formats="F32LE")


def _hrtf_src_caps() -> Caps:
    return audio_caps(formats="F32LE", channels=2)


@register_element("hrtfrender", Rank.NONE)
class HrtfRender(BaseTransform):
    """N-channel -> stereo binaural renderer
    (reference audio/hrtf/src/hrtf/imp.rs)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    _hrtf_sink_caps()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    _hrtf_src_caps()),
    ]

    hrir_location = Property(str, default=None, mutable=Mutability.READY,
                             blurb="Path to .hrir sphere file")
    hrir_raw = Property(bytes, default=None, mutable=Mutability.READY)
    interpolation_steps = Property(int, default=8, minimum=1,
                                   mutable=Mutability.READY)
    block_length = Property(int, default=512, minimum=1,
                            mutable=Mutability.READY)
    # list of dicts: {"x":..,"y":..,"z":..,"distance-gain":..} per input
    # channel (reference spatial-objects GstStructure array)
    spatial_objects = Property(list, default=None,
                               mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self._sphere: HrirSphere | None = None
        self._adapter: SampleAdapter | None = None
        self._hist = None           # (C, 2, L-1) overlap history
        self._ir_f = None           # (C, 2, F) current IR rffts
        self._prev_dirs = None      # (C, 3)
        self._prev_gains = None     # (C,)
        self._in_info: AudioInfo | None = None

    # -- negotiation ---------------------------------------------------
    def transform_caps(self, direction, caps, filter):
        def repl(s: Structure):
            if s.name != "audio/x-raw":
                return None
            if direction is PadDirection.SINK:
                s["channels"] = 2
            else:
                n = len(self.spatial_objects) if self.spatial_objects \
                    else IntRange(1, 64)
                s["channels"] = n
            return s
        out = caps.map_structures(repl)
        if filter is not None:
            out = filter.intersect(out)
        return out

    def _load_sphere(self) -> bool:
        if self.hrir_raw is not None:
            self._sphere = HrirSphere.from_bytes(self.hrir_raw)
        elif self.hrir_location:
            with open(self.hrir_location, "rb") as f:
                self._sphere = HrirSphere.from_bytes(f.read())
        else:
            self.post_error("hrtfrender: no HRIR sphere configured")
            return False
        return True

    def start(self) -> bool:
        return self._load_sphere()

    def _objects(self, channels: int):
        objs = self.spatial_objects or []
        if len(objs) != channels:
            raise ValueError(
                f"hrtfrender: {channels} channels need {channels} "
                f"spatial-objects, have {len(objs)}")
        dirs = np.array([[o.get("x", 0.0), o.get("y", 0.0),
                          o.get("z", 1.0)] for o in objs])
        gains = np.array([o.get("distance-gain", 1.0) for o in objs])
        return dirs, gains

    def set_caps(self, incaps, outcaps) -> bool:
        self._in_info = AudioInfo.from_caps(incaps)
        C = self._in_info.channels
        if self.block_length % self.interpolation_steps != 0:
            self.post_error("hrtfrender: block-length must be divisible "
                            "by interpolation-steps")
            return False
        try:
            dirs, gains = self._objects(C)
        except ValueError as e:
            self.post_error(str(e))
            return False
        L = self._sphere.ir_len
        self._adapter = SampleAdapter(self._in_info.rate)
        self._hist = torch.zeros((C, 1, L - 1), dtype=torch.float32,
                                 device=default_device())
        self._prev_dirs, self._prev_gains = dirs, gains
        self._refresh_irs(dirs)
        return True

    def _refresh_irs(self, dirs) -> None:
        sub = self.block_length // self.interpolation_steps
        irs = np.stack([self._sphere.sample(d) for d in dirs])  # (C,2,L)
        nfft = next_pow2(max(sub, 1) + self._sphere.ir_len - 1)
        self._ir_f = _dev_rfft(irs, nfft)

    # -- processing ----------------------------------------------------
    def transform(self, buf: Buffer) -> list[Buffer] | None:
        info = self._in_info
        self._adapter.push(info.view(buf).astype(np.float32), pts=buf.pts)
        out = []
        blk = self.block_length
        while self._adapter.available() >= blk:
            frames, pts, dur = self._adapter.take_pts(blk)
            out.append(self._process_block(frames, pts))
        return out or None

    def _process_block(self, frames: np.ndarray, pts) -> Buffer:
        C = frames.shape[1]
        L = self._sphere.ir_len
        steps = self.interpolation_steps
        sub = self.block_length // steps
        x = _upload(frames.T[:, None, :])  # (C, 1, N)

        new_dirs, new_gains = self._objects(C)
        changed = not (np.array_equal(new_dirs, self._prev_dirs)
                       and np.array_equal(new_gains, self._prev_gains))

        segs = []
        for k in range(steps):
            t = (k + 1) / steps
            if changed:
                dirs_k = self._prev_dirs + t * (new_dirs - self._prev_dirs)
                self._refresh_irs(dirs_k)
            gains_k = self._prev_gains + t * (new_gains - self._prev_gains) \
                if changed else self._prev_gains
            seg = x[..., k * sub:(k + 1) * sub]
            self._hist, y = ols_block(self._hist, seg, self._ir_f,
                                      ir_len=L)
            # y: (C, 2, sub); apply per-channel gains, sum channels
            y = y * _upload(gains_k, torch.float64)[:, None, None]
            segs.append(torch.sum(y, dim=0))
        if changed:
            self._prev_dirs, self._prev_gains = new_dirs, new_gains
        stereo = torch.cat(segs, dim=-1).T  # (N, 2)
        out_info = AudioInfo("F32LE", self._in_info.rate, 2)
        return out_info.make_buffer(
            stereo.to(torch.float32).cpu().numpy(), pts=pts)

    def drain(self) -> list[Buffer]:
        """Pad the tail block with zeros and emit the remainder
        (reference drains on EOS, imp.rs:286-330)."""
        if self._adapter is None:
            return []
        avail = self._adapter.available()
        if avail == 0:
            return []
        blk = self.block_length
        frames, pts, _ = self._adapter.take_pts(avail)
        pad = np.zeros((blk - avail, frames.shape[1]), np.float32)
        full = np.concatenate([frames.astype(np.float32), pad])
        b = self._process_block(full, pts)
        n_keep = avail
        arr = b.array.reshape(-1, 2)[:n_keep]
        out_info = AudioInfo("F32LE", self._in_info.rate, 2)
        return [out_info.make_buffer(arr, pts=pts)]

    def flush(self) -> None:
        if self._adapter is not None:
            self._adapter.clear()
        if self._hist is not None:
            self._hist = torch.zeros_like(self._hist)

    def add_latency(self, q: LatencyQuery) -> None:
        if self._in_info is not None:
            block_ns = self.block_length * SECOND // self._in_info.rate
            q.add(block_ns, block_ns)


# ---------------------------------------------------------------------------
# sofalizer
# ---------------------------------------------------------------------------

# standard virtual speaker azimuths (degrees, 0 = front, + = left) per
# channel count — mirrors the reference's channel position handling
# (src/spatial.rs)
_LAYOUT_AZIMUTHS = {
    1: [0.0],
    2: [30.0, -30.0],
    4: [45.0, -45.0, 135.0, -135.0],
    6: [30.0, -30.0, 0.0, 0.0, 110.0, -110.0],
    8: [30.0, -30.0, 0.0, 0.0, 110.0, -110.0, 90.0, -90.0],
}


def load_sofa(path: str):
    """Read Data.IR + SourcePosition from a SOFA (HDF5) file.
    Returns (positions (M, 3 [azi°, ele°, dist]), irs (M, 2, N), rate)."""
    import h5py
    with h5py.File(path, "r") as f:
        irs = np.asarray(f["Data.IR"])          # (M, R, N)
        pos = np.asarray(f["SourcePosition"])   # (M, 3)
        rate_ds = f["Data.SamplingRate"]
        rate = int(np.asarray(rate_ds).reshape(-1)[0])
    if irs.ndim != 3 or irs.shape[1] < 2:
        raise ValueError(f"unsupported SOFA IR shape {irs.shape}")
    return pos, irs[:, :2, :], rate


def write_sofa(path: str, positions, irs, rate) -> None:
    """Minimal SOFA writer for tests/tools."""
    import h5py
    with h5py.File(path, "w") as f:
        f.create_dataset("Data.IR", data=np.asarray(irs, np.float64))
        f.create_dataset("SourcePosition",
                         data=np.asarray(positions, np.float64))
        f.create_dataset("Data.SamplingRate", data=np.array([rate],
                                                            np.float64))


def _sph_to_vec(azi_deg: float, ele_deg: float) -> np.ndarray:
    a, e = np.radians(azi_deg), np.radians(ele_deg)
    return np.array([np.cos(e) * np.sin(a), np.sin(e),
                     np.cos(e) * np.cos(a)])


@register_element("sofalizer", Rank.NONE)
class Sofalizer(BaseTransform):
    """SOFA-file binaural renderer with listener rotation
    (reference audio/hrtf/src/sofa/imp.rs: uniformly partitioned FIR
    at partition-length taps — imp.rs:37-44, 776-797 — dynamic filter
    re-selection with crossfade on rotation). The convolution is true
    UPC (gstpu_torch.ops.fftconv.upc_block): each partition-length
    output sub-block depends only on input up to its own end, matching
    the reference's 64-sample algorithmic granularity."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    _hrtf_sink_caps()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    _hrtf_src_caps()),
    ]

    sofa_location = Property(str, default=None, mutable=Mutability.READY)
    block_length = Property(int, default=256, minimum=16,
                            mutable=Mutability.READY)
    partition_length = Property(
        int, default=64, minimum=1, mutable=Mutability.READY,
        blurb="partition size for uniformly partitioned convolution "
              "algorithm")
    rotation_yaw = Property(float, default=0.0, mutable=Mutability.PLAYING,
                            blurb="Listener yaw in degrees")
    rotation_pitch = Property(float, default=0.0,
                              mutable=Mutability.PLAYING)
    gain = Property(float, default=1.0, minimum=0.0,
                    mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self._positions = None   # (M, 3) spherical
        self._pos_vecs = None    # (M, 3) unit vectors
        self._irs = None         # (M, 2, N)
        self._rate = None
        self._adapter: SampleAdapter | None = None
        self._in_info: AudioInfo | None = None
        self._state = None       # (fdl, prev) UPC carried state
        self._h_f = None         # (C, 2, K, F) partitioned IR spectra
        self._cur_sel = None
        self._fade_from = None   # previous h_f during crossfade

    def transform_caps(self, direction, caps, filter):
        def repl(s: Structure):
            if s.name != "audio/x-raw":
                return None
            if direction is PadDirection.SINK:
                s["channels"] = 2
            else:
                s["channels"] = AnyList(tuple(_LAYOUT_AZIMUTHS))
            return s
        out = caps.map_structures(repl)
        if filter is not None:
            out = filter.intersect(out)
        return out

    def start(self) -> bool:
        if not self.sofa_location:
            self.post_error("sofalizer: no sofa-location set")
            return False
        self._positions, self._irs, self._rate = load_sofa(
            self.sofa_location)
        azi = np.radians(self._positions[:, 0])
        ele = np.radians(self._positions[:, 1])
        self._pos_vecs = np.stack([np.cos(ele) * np.sin(azi), np.sin(ele),
                                   np.cos(ele) * np.cos(azi)], axis=1)
        return True

    def _select_irs(self, channels: int) -> np.ndarray:
        """Nearest measurement per virtual speaker after listener
        rotation; returns indices (C,)."""
        azimuths = _LAYOUT_AZIMUTHS.get(channels)
        if azimuths is None:
            azimuths = list(np.linspace(-90, 90, channels))
        sel = []
        for az in azimuths:
            v = _sph_to_vec(az - self.rotation_yaw, -self.rotation_pitch)
            sel.append(int(np.argmax(self._pos_vecs @ v)))
        return np.asarray(sel)

    def set_caps(self, incaps, outcaps) -> bool:
        self._in_info = AudioInfo.from_caps(incaps)
        C = self._in_info.channels
        L = self._irs.shape[-1]
        P = self.partition_length
        if self.block_length % P != 0:
            # reference imp.rs:779-783
            self.post_error("sofalizer: Block Length is not multiple "
                            "of Partition Length")
            return False
        self._adapter = SampleAdapter(self._in_info.rate)
        self._state = upc_init((C, 1), L, P, device=default_device())
        self._cur_sel = self._select_irs(C)
        self._h_f = upc_ir_rfft(_upload(self._irs[self._cur_sel]),
                                part_len=P)
        self._fade_from = None
        return True

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        info = self._in_info
        self._adapter.push(info.view(buf).astype(np.float32), pts=buf.pts)
        out = []
        while self._adapter.available() >= self.block_length:
            frames, pts, _ = self._adapter.take_pts(self.block_length)
            out.append(self._process_block(frames, pts))
        return out or None

    def _process_block(self, frames: np.ndarray, pts) -> Buffer:
        C = frames.shape[1]
        P = self.partition_length
        sel = self._select_irs(C)
        if not np.array_equal(sel, self._cur_sel):
            self._fade_from = self._h_f
            self._cur_sel = sel
            self._h_f = upc_ir_rfft(_upload(self._irs[sel]), part_len=P)
        x = _upload(frames.T[:, None, :])
        if self._fade_from is not None:
            # crossfade: render with both filter sets, blend linearly
            # over the block (reference update_filters crossfade)
            state0 = self._state
            _, y_old = upc_block(state0, x, self._fade_from, part_len=P)
            self._state, y_new = upc_block(state0, x, self._h_f,
                                           part_len=P)
            ramp = torch.linspace(0.0, 1.0, y_new.shape[-1],
                                  dtype=torch.float64, device=x.device)
            y = y_old * (1 - ramp) + y_new * ramp
            self._fade_from = None
        else:
            self._state, y = upc_block(self._state, x, self._h_f,
                                       part_len=P)
        # the gain rounded to f32, as gstpu's jnp.float32(gain)
        stereo = torch.sum(y, dim=0).T * float(np.float32(self.gain))
        out_info = AudioInfo("F32LE", self._in_info.rate, 2)
        return out_info.make_buffer(
            stereo.to(torch.float32).cpu().numpy(), pts=pts)

    def drain(self) -> list[Buffer]:
        if self._adapter is None or self._adapter.available() == 0:
            return []
        avail = self._adapter.available()
        frames, pts, _ = self._adapter.take_pts(avail)
        pad = np.zeros((self.block_length - avail, frames.shape[1]),
                       np.float32)
        b = self._process_block(
            np.concatenate([frames.astype(np.float32), pad]), pts)
        arr = b.array.reshape(-1, 2)[:avail]
        out_info = AudioInfo("F32LE", self._in_info.rate, 2)
        return [out_info.make_buffer(arr, pts=pts)]

    def add_latency(self, q: LatencyQuery) -> None:
        if self._in_info is not None:
            block_ns = self.block_length * SECOND // self._in_info.rate
            q.add(block_ns, block_ns)
