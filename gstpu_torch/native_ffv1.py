"""ctypes bindings for the FFV1 entropy backend (native/gstpu_ffv1.cpp).

`NativeFrameCoder` is the host half of the device-split `ffv1enc`
encoder: the device computes each frame's (context, folded-residual)
fields (gstpu_torch/ops/ffv1_pred.py) and this coder performs the
sequential adaptive range coding.  Output is byte-identical to the
pure-Python spec model (gstpu_torch.codecs.ffv1.ModelEncoder) —
asserted in tests/test_torch_ffv1.py.  The port's copy of
gstpu/native_ffv1.py: the same source and ctypes signatures, the
library built by gstpu_torch.native into build/torch_ext/.

Reference parity: the reference ships only a decoder wrap
(video/ffv1/src/ffv1dec/imp.rs); the encoder is gstpu's own.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gstpu_torch.native import build_library

_LIB = None


def load() -> ctypes.CDLL | None:
    """Load (building on demand) the FFV1 coder; None if no toolchain."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build_library("gstpu_ffv1.cpp")
    if path is None:
        return None
    try:
        L = ctypes.CDLL(str(path))
    except OSError:
        return None
    L.fe_new.restype = ctypes.c_void_p
    L.fe_new.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    L.fe_free.argtypes = [ctypes.c_void_p]
    L.fe_encode.restype = ctypes.c_long
    L.fe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    L.fe_encode_packed.restype = ctypes.c_long
    L.fe_encode_packed.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    L.fe_encode_from_plane.restype = ctypes.c_long
    L.fe_encode_from_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    L.fe_encode_from_diff.restype = ctypes.c_long
    L.fe_encode_from_diff.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    _LIB = L
    return L


def available() -> bool:
    return load() is not None


class NativeFrameCoder:
    """Adaptive range coding of precomputed (ctx, diff) frame fields.

    Owns the persistent per-context coder states (two banks: luma and
    shared-chroma), matching ModelEncoder's inter-frame behavior.
    """

    def __init__(self, params):
        L = load()
        if L is None:
            raise RuntimeError("ffv1 native coder unavailable")
        self._L = L
        q = np.zeros((5, 256), np.int32)
        for i, t in enumerate(params.quant):
            q[i] = np.asarray(t, np.int32)
        self._q = np.ascontiguousarray(q)
        self._h = L.fe_new(
            params.bits, 1 if params.chroma_planes else 0,
            params.log2_h, params.log2_v,
            self._q.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            params.context_count)
        if not self._h:
            raise RuntimeError("fe_new failed")

    def encode(self, key: bool, ctx_planes, diff_planes) -> bytes:
        """ctx/diff: lists of per-plane arrays (any shape; flattened in
        raster order).  Returns the frame bitstream."""
        ctx = np.ascontiguousarray(
            np.concatenate([np.asarray(c, np.uint16).ravel()
                            for c in ctx_planes]))
        diff = np.ascontiguousarray(
            np.concatenate([np.asarray(d, np.int8).ravel()
                            for d in diff_planes]))
        px = np.ascontiguousarray(np.asarray(
            [np.asarray(c).size for c in ctx_planes],
            dtype=np.dtype(ctypes.c_long)))
        cap = ctx.size * 2 + 4096
        out = np.empty(cap, np.uint8)
        n = self._L.fe_encode(
            self._h, 1 if key else 0, len(ctx_planes),
            ctx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            diff.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            px.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            if -n > cap:  # retry with the exact needed size
                cap = -n
                out = np.empty(cap, np.uint8)
                n = self._L.fe_encode(
                    self._h, 1 if key else 0, len(ctx_planes),
                    ctx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                    diff.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    px.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    cap)
            if n < 0:
                raise ValueError("ffv1 native encode failed")
        return out[:n].tobytes()

    def encode_packed(self, key: bool, fields) -> bytes:
        """fields: per-plane (diff int8 (h,w), lo uint8 (h,w),
        hi4 uint8 (h, ceil(w/4))) triples from
        ops.ffv1_pred.Predictor.dispatch_packed — 2.25 bytes/px off
        the device.
        Byte-identical output to encode() on the unpacked
        equivalents."""
        diff = np.ascontiguousarray(np.concatenate(
            [np.asarray(d, np.int8).ravel() for d, _, _ in fields]))
        lo = np.ascontiguousarray(np.concatenate(
            [np.asarray(l, np.uint8).ravel() for _, l, _ in fields]))
        hi4 = np.ascontiguousarray(np.concatenate(
            [np.asarray(h4, np.uint8).ravel() for _, _, h4 in fields]))
        clong = np.dtype(ctypes.c_long)
        pw = np.ascontiguousarray(np.asarray(
            [np.asarray(d).shape[1] for d, _, _ in fields], clong))
        ph = np.ascontiguousarray(np.asarray(
            [np.asarray(d).shape[0] for d, _, _ in fields], clong))
        cap = diff.size * 2 + 4096
        for _ in range(2):
            out = np.empty(cap, np.uint8)
            n = self._L.fe_encode_packed(
                self._h, 1 if key else 0, len(fields),
                diff.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                hi4.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                pw.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                ph.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
            if n >= 0:
                return out[:n].tobytes()
            if -n <= cap:
                break
            cap = -n
        raise ValueError("ffv1 native encode failed")

    def encode_from_plane(self, key: bool, planes, diffs) -> bytes:
        """The 1-byte/px hop: `planes` are the SOURCE (h, w) uint8
        planes (host-resident anyway), `diffs` the device-computed
        folded residuals (int8, same shapes); the 3-gradient context
        is re-derived inline in the native scan.  Byte-identical
        output to encode_packed on the device context fields."""
        pl = np.ascontiguousarray(np.concatenate(
            [np.asarray(p, np.uint8).ravel() for p in planes]))
        diff = np.ascontiguousarray(np.concatenate(
            [np.asarray(d, np.int8).ravel() for d in diffs]))
        clong = np.dtype(ctypes.c_long)
        pw = np.ascontiguousarray(np.asarray(
            [np.asarray(p).shape[1] for p in planes], clong))
        ph = np.ascontiguousarray(np.asarray(
            [np.asarray(p).shape[0] for p in planes], clong))
        cap = diff.size * 2 + 4096
        for _ in range(2):
            out = np.empty(cap, np.uint8)
            n = self._L.fe_encode_from_plane(
                self._h, 1 if key else 0, len(planes),
                pl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                diff.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                pw.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                ph.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
            if n >= 0:
                return out[:n].tobytes()
            if -n <= cap:
                break
            cap = -n
        raise ValueError("ffv1 native encode failed")

    def encode_from_diff(self, key: bool, diffs) -> bytes:
        """The zero-upload hop for DEVICE-RESIDENT sources: `diffs`
        are the device-computed folded residuals (int8 (h, w) per
        plane) — the ONLY data that crosses the device->host link;
        the native scan reconstructs the source plane inline from
        them (FFV1 is lossless, RFC 9043 §3.8) and derives contexts
        from the reconstruction.  Byte-identical output to
        encode_from_plane on the true source."""
        diff = np.ascontiguousarray(np.concatenate(
            [np.asarray(d, np.int8).ravel() for d in diffs]))
        clong = np.dtype(ctypes.c_long)
        pw = np.ascontiguousarray(np.asarray(
            [np.asarray(d).shape[1] for d in diffs], clong))
        ph = np.ascontiguousarray(np.asarray(
            [np.asarray(d).shape[0] for d in diffs], clong))
        cap = diff.size * 2 + 4096
        for _ in range(2):
            out = np.empty(cap, np.uint8)
            n = self._L.fe_encode_from_diff(
                self._h, 1 if key else 0, len(diffs),
                diff.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                pw.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                ph.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
            if n >= 0:
                return out[:n].tobytes()
            if -n <= cap:
                break
            cap = -n
        raise ValueError("ffv1 native encode failed")

    def close(self):
        if self._h:
            self._L.fe_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
