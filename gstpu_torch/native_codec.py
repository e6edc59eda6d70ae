"""ctypes bindings for the native codec shim (native/gstpu_codec.cpp).

NativeEncoder/NativeDecoder wrap libavcodec engines through a stable
mini-ABI — the same architecture as the reference's codec elements
(dav1ddec wraps libdav1d, rav1enc wraps rav1e, ffv1dec the ffv1
decoder; video/{dav1d,rav1e,ffv1}).  Frames cross the boundary as
tightly packed I420 bytes.  The port's copy of gstpu/native_codec.py:
the same source and ctypes signatures, the library built by
gstpu_torch.native into build/torch_ext/ and linked against libavcodec
and libavutil; `load()` returns None where they are missing.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gstpu_torch.native import build_library

_LIB = None


def load() -> ctypes.CDLL | None:
    """Load (building on demand) the codec shim; None if unavailable
    (no toolchain / no libavcodec)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build_library("gstpu_codec.cpp", libs=("-lavcodec", "-lavutil"))
    if path is None:
        return None
    try:
        L = ctypes.CDLL(str(path))
    except OSError:
        return None
    L.gc_encoder_open.restype = ctypes.c_void_p
    L.gc_encoder_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 5 \
        + [ctypes.c_char_p]
    L.gc_encoder_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int64]
    L.gc_encoder_finish.argtypes = [ctypes.c_void_p]
    L.gc_encoder_packet.restype = ctypes.c_long
    L.gc_encoder_packet.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
    L.gc_encoder_close.argtypes = [ctypes.c_void_p]
    L.gc_decoder_open.restype = ctypes.c_void_p
    L.gc_decoder_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_long, ctypes.c_int,
                                  ctypes.c_int]
    try:
        L.gc_decoder_open2.restype = ctypes.c_void_p
        L.gc_decoder_open2.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
    except AttributeError:
        pass                    # older shim build without options
    L.gc_decoder_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_long, ctypes.c_int64]
    L.gc_decoder_finish.argtypes = [ctypes.c_void_p]
    L.gc_decoder_frame.restype = ctypes.c_long
    L.gc_decoder_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)]
    L.gc_decoder_close.argtypes = [ctypes.c_void_p]
    _LIB = L
    return L


class NativeEncoder:
    def __init__(self, codec: str, width: int, height: int,
                 fps=(30, 1), opts: dict | None = None):
        L = load()
        if L is None:
            raise RuntimeError("native codec shim unavailable")
        optstr = "\n".join(f"{k}={v}" for k, v in (opts or {}).items())
        self._L = L
        self._h = L.gc_encoder_open(codec.encode(), width, height, 0,
                                    fps[0], fps[1], optstr.encode())
        if not self._h:
            raise RuntimeError(f"encoder {codec!r} failed to open "
                               f"(opts {opts!r})")

    def send(self, i420: np.ndarray | bytes, pts: int) -> list:
        data = i420.tobytes() if isinstance(i420, np.ndarray) else i420
        self._L.gc_encoder_send(self._h, data, pts)
        return self._pull()

    def finish(self) -> list:
        self._L.gc_encoder_finish(self._h)
        return self._pull()

    def _pull(self):
        out = []
        while True:
            n = self._L.gc_encoder_packet(self._h, None, 0, None, None)
            if n <= 0:
                break
            buf = ctypes.create_string_buffer(n)
            pts = ctypes.c_int64()
            key = ctypes.c_int()
            self._L.gc_encoder_packet(self._h, buf, n,
                                      ctypes.byref(pts),
                                      ctypes.byref(key))
            out.append((buf.raw, pts.value, bool(key.value)))
        return out

    def close(self):
        if self._h:
            self._L.gc_encoder_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeDecoder:
    def __init__(self, codec: str, extradata: bytes = b"",
                 width: int = 0, height: int = 0,
                 options: dict | None = None):
        """options: decoder AVOptions as {name: value} — e.g.
        libdav1d's filmgrain/max_frame_delay/threads; unknown names
        are ignored by the shim so callers can pass
        version-dependent knobs safely."""
        L = load()
        if L is None:
            raise RuntimeError("native codec shim unavailable")
        self._L = L
        if options and hasattr(L, "gc_decoder_open2"):
            optstr = ",".join(f"{k}={v}" for k, v in options.items())
            self._h = L.gc_decoder_open2(
                codec.encode(), extradata or None, len(extradata),
                width, height, optstr.encode())
        else:
            self._h = L.gc_decoder_open(
                codec.encode(), extradata or None, len(extradata),
                width, height)
        if not self._h:
            raise RuntimeError(f"decoder {codec!r} failed to open")

    def send(self, packet: bytes, pts: int = 0) -> list:
        self._L.gc_decoder_send(self._h, packet, len(packet), pts)
        return self._pull()

    def finish(self) -> list:
        self._L.gc_decoder_finish(self._h)
        return self._pull()

    def _pull(self):
        out = []
        while True:
            w = ctypes.c_int()
            h = ctypes.c_int()
            f = ctypes.c_int()
            pts = ctypes.c_int64()
            n = self._L.gc_decoder_frame(self._h, None, 0,
                                         ctypes.byref(w),
                                         ctypes.byref(h),
                                         ctypes.byref(f), None)
            if n <= 0:
                break
            buf = ctypes.create_string_buffer(n)
            n2 = self._L.gc_decoder_frame(self._h, buf, n,
                                          ctypes.byref(w),
                                          ctypes.byref(h),
                                          ctypes.byref(f),
                                          ctypes.byref(pts))
            if n2 <= 0:
                break
            out.append((np.frombuffer(buf.raw, np.uint8), w.value,
                        h.value, f.value, pts.value))
        return out

    def close(self):
        if self._h:
            self._L.gc_decoder_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _bind_audio(L: ctypes.CDLL) -> None:
    if getattr(L, "_audio_bound", False):
        return
    L.ga_encoder_open.restype = ctypes.c_void_p
    L.ga_encoder_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    L.ga_encoder_extradata.restype = ctypes.c_long
    L.ga_encoder_extradata.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_long]
    L.ga_encoder_send.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int64]
    L.ga_encoder_finish.argtypes = [ctypes.c_void_p]
    L.ga_encoder_packet.restype = ctypes.c_long
    L.ga_encoder_packet.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
    L.ga_encoder_close.argtypes = [ctypes.c_void_p]
    L.ga_decoder_open.restype = ctypes.c_void_p
    L.ga_decoder_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_char_p,
                                  ctypes.c_long]
    L.ga_decoder_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_long, ctypes.c_int64]
    L.ga_decoder_finish.argtypes = [ctypes.c_void_p]
    L.ga_decoder_frame.restype = ctypes.c_long
    L.ga_decoder_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)]
    L.ga_decoder_close.argtypes = [ctypes.c_void_p]
    L._audio_bound = True


class NativeAudioEncoder:
    """Audio encoder over the shim; interleaved f32 in, packets out.

    `frame_size` (samples per channel the engine wants per send; 0 =
    any) is fixed after open — callers re-block with an adapter, the
    reference's pattern (SURVEY.md §5.7)."""

    def __init__(self, codec: str, rate: int, channels: int,
                 bitrate: int = 0, opts: dict | None = None):
        L = load()
        if L is None:
            raise RuntimeError("native codec shim unavailable")
        _bind_audio(L)
        optstr = "\n".join(f"{k}={v}" for k, v in (opts or {}).items())
        fs = ctypes.c_int()
        self._L = L
        self._channels = channels
        self._h = L.ga_encoder_open(codec.encode(), rate, channels,
                                    bitrate, optstr.encode(),
                                    ctypes.byref(fs))
        if not self._h:
            raise RuntimeError(f"audio encoder {codec!r} failed to open")
        self.frame_size = fs.value

    @property
    def extradata(self) -> bytes:
        n = self._L.ga_encoder_extradata(self._h, None, 0)
        if n <= 0:
            return b""
        buf = ctypes.create_string_buffer(n)
        self._L.ga_encoder_extradata(self._h, buf, n)
        return buf.raw

    def send(self, samples: np.ndarray, pts: int) -> list:
        """samples: f32 (nsamples, channels) or interleaved flat."""
        arr = np.ascontiguousarray(samples, dtype=np.float32)
        ns = arr.size // self._channels
        r = self._L.ga_encoder_send(
            self._h, arr.ctypes.data_as(ctypes.c_void_p), ns, pts)
        if r < 0:
            raise RuntimeError(f"audio encoder send failed ({r})")
        return self._pull()

    def finish(self) -> list:
        self._L.ga_encoder_finish(self._h)
        return self._pull()

    def _pull(self):
        out = []
        while True:
            n = self._L.ga_encoder_packet(self._h, None, 0, None, None)
            if n <= 0:
                break
            buf = ctypes.create_string_buffer(n)
            pts = ctypes.c_int64()
            dur = ctypes.c_int()
            self._L.ga_encoder_packet(self._h, buf, n,
                                      ctypes.byref(pts),
                                      ctypes.byref(dur))
            out.append((buf.raw, pts.value, dur.value))
        return out

    def close(self):
        if self._h:
            self._L.ga_encoder_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeAudioDecoder:
    """Audio decoder over the shim; packets in, interleaved f32 out."""

    def __init__(self, codec: str, rate: int = 0, channels: int = 0,
                 extradata: bytes = b""):
        L = load()
        if L is None:
            raise RuntimeError("native codec shim unavailable")
        _bind_audio(L)
        self._L = L
        self._h = L.ga_decoder_open(codec.encode(), rate, channels,
                                    extradata or None, len(extradata))
        if not self._h:
            raise RuntimeError(f"audio decoder {codec!r} failed to open")

    def send(self, packet: bytes, pts: int = 0) -> list:
        self._L.ga_decoder_send(self._h, packet, len(packet), pts)
        return self._pull()

    def finish(self) -> list:
        self._L.ga_decoder_finish(self._h)
        return self._pull()

    def _pull(self):
        out = []
        while True:
            ns = ctypes.c_int()
            ch = ctypes.c_int()
            rate = ctypes.c_int()
            pts = ctypes.c_int64()
            n = self._L.ga_decoder_frame(self._h, None, 0,
                                         ctypes.byref(ns),
                                         ctypes.byref(ch),
                                         ctypes.byref(rate), None)
            if n == 0:
                break
            if n < 0:
                continue        # unsupported format frame dropped
            arr = np.empty(n, np.float32)
            n2 = self._L.ga_decoder_frame(
                self._h, arr.ctypes.data_as(ctypes.c_void_p), n,
                ctypes.byref(ns), ctypes.byref(ch), ctypes.byref(rate),
                ctypes.byref(pts))
            if n2 <= 0:
                break
            out.append((arr.reshape(ns.value, ch.value), rate.value,
                        pts.value))
        return out

    def close(self):
        if self._h:
            self._L.ga_decoder_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def available(codec: str, encoder: bool = True) -> bool:
    L = load()
    if L is None:
        return False
    try:
        if encoder:
            e = NativeEncoder(codec, 64, 64)
            e.close()
        else:
            # dims: ffv1 carries no size in-band and refuses to open
            # without them; other codecs ignore the hint
            d = NativeDecoder(codec, width=64, height=48)
            d.close()
        return True
    except RuntimeError:
        return False
