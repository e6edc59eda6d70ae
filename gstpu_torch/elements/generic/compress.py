"""flatecompress/flatedecompress (+ gated brotli pair).

Rebuilds the reference generic/compress crate: whole-buffer lossless
(de)compression where the compressed caps carry the original caps in an
`original-caps` field (compress_caps_helper.rs semantics). zlib/deflate
via the standard library; the brotli elements register but error at
startup if no brotli backend exists in the environment.

The port's copy of gstpu/elements/generic/compress.py: host code: the
compressors read the payload through `Buffer.to_bytes()`, one download
of a tensor a buffer.
"""

from __future__ import annotations

import zlib

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps, Structure
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

ZLIB_CAPS = "application/x-zlib-compressed"
DEFLATE_CAPS = "application/x-deflate-compressed"
BROTLI_CAPS = "application/x-brotli-compressed"


def _compressed_tmpl(*names: str) -> Caps:
    return Caps([Structure(n) for n in names])


class _CompressBase(BaseTransform):
    """Sink->Src wraps caps into original-caps; Src->Sink recovers."""

    MEDIA_TYPES: tuple[str, ...] = ()

    def transform_caps(self, direction, caps, filter):
        if direction is PadDirection.SINK:
            out = Caps([Structure(n, **{"original-caps": caps.copy()})
                        for n in self.MEDIA_TYPES])
        else:
            recovered = Caps.empty()
            for s in caps:
                oc = s.get("original-caps")
                if isinstance(oc, Caps):
                    recovered = recovered.append(oc)
            out = recovered if not recovered.is_empty() else Caps.any()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        # nested original-caps need not be fixed; pick first structure
        s = othercaps[0].copy()
        oc = s.get("original-caps")
        if isinstance(oc, Caps) and not oc.is_fixed() and len(oc):
            s["original-caps"] = Caps([oc[0].fixate()])
        return Caps([s])


class _DecompressBase(BaseTransform):
    MEDIA_TYPES: tuple[str, ...] = ()

    def transform_caps(self, direction, caps, filter):
        if direction is PadDirection.SINK:
            recovered = Caps.empty()
            for s in caps:
                oc = s.get("original-caps")
                if isinstance(oc, Caps):
                    recovered = recovered.append(oc)
            out = recovered if not recovered.is_empty() else Caps.any()
        else:
            out = Caps([Structure(n, **{"original-caps": caps.copy()})
                        for n in self.MEDIA_TYPES])
        if filter is not None:
            out = filter.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        return Caps([othercaps[0].copy()])


def _flate_tmpls(direction_in_raw: bool):
    raw = Caps.any()
    comp = _compressed_tmpl(ZLIB_CAPS, DEFLATE_CAPS)
    if direction_in_raw:
        return [PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                            raw),
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                            comp)]
    return [PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                        comp),
            PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, raw)]


@register_element("flatecompress", Rank.NONE)
class FlateCompress(_CompressBase):
    MEDIA_TYPES = (ZLIB_CAPS, DEFLATE_CAPS)
    PAD_TEMPLATES = _flate_tmpls(True)

    level = Property(int, default=6, minimum=0, maximum=9,
                     mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._c = None

    def set_caps(self, incaps, outcaps) -> bool:
        zlib_header = outcaps[0].name == ZLIB_CAPS
        wbits = 15 if zlib_header else -15
        self._c = zlib.compressobj(self.level, zlib.DEFLATED, wbits)
        return True

    def transform(self, buf: Buffer) -> Buffer:
        data = self._c.compress(buf.to_bytes())
        data += self._c.flush(zlib.Z_SYNC_FLUSH)
        return Buffer(data, pts=buf.pts, dts=buf.dts,
                      duration=buf.duration, flags=buf.flags)

    def drain(self):
        if self._c is None:
            return []
        tail = self._c.flush(zlib.Z_FINISH)
        self._c = None
        return [Buffer(tail)] if tail else []


@register_element("flatedecompress", Rank.NONE)
class FlateDecompress(_DecompressBase):
    MEDIA_TYPES = (ZLIB_CAPS, DEFLATE_CAPS)
    PAD_TEMPLATES = _flate_tmpls(False)

    def __init__(self, name=None):
        super().__init__(name)
        self._d = None

    def set_caps(self, incaps, outcaps) -> bool:
        zlib_header = incaps[0].name == ZLIB_CAPS
        self._d = zlib.decompressobj(15 if zlib_header else -15)
        return True

    def transform(self, buf: Buffer) -> Buffer:
        try:
            data = self._d.decompress(buf.to_bytes())
        except zlib.error as e:
            self.post_error(f"decompression failed: {e}")
            raise FlowError(FlowReturn.ERROR)
        return Buffer(data, pts=buf.pts, dts=buf.dts,
                      duration=buf.duration, flags=buf.flags)

    def drain(self):
        if self._d is None:
            return []
        tail = self._d.flush()
        self._d = None
        return [Buffer(tail)] if tail else []


def _brotli_backend():
    """Best available full-entropy brotli backend, or None.

    Order: python `brotli` module, then the in-image C libraries
    (libbrotlienc/libbrotlidec via gstpu_torch/codecs/brotli_ctypes.py —
    same wrap-the-system-lib architecture as the sodium elements).
    """
    try:
        import brotli
        return brotli
    except ImportError:
        pass
    from gstpu_torch.codecs import brotli_ctypes
    if brotli_ctypes.available():
        return brotli_ctypes
    return None


@register_element("brotlicompress", Rank.NONE)
class BrotliCompress(_CompressBase):
    """Brotli compressor. Entropy-codes at the configured quality via
    the python brotli module or the in-image libbrotlienc (RFC 7932
    conformant, static dictionary included); with neither backend it
    emits RFC 7932 stored-mode streams
    (gstpu_torch/codecs/brotli_rfc7932.py) — still conformant output any
    brotli decoder accepts."""

    MEDIA_TYPES = (BROTLI_CAPS,)
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    _compressed_tmpl(BROTLI_CAPS)),
    ]

    quality = Property(int, default=11, minimum=0, maximum=11,
                       mutable=Mutability.READY)

    def transform(self, buf: Buffer) -> Buffer:
        backend = _brotli_backend()
        if backend is not None:
            data = backend.compress(buf.to_bytes(),
                                    quality=self.quality)
        else:
            from gstpu_torch.codecs.brotli_rfc7932 import compress_stored
            data = compress_stored(buf.to_bytes())
        return Buffer(data, pts=buf.pts, duration=buf.duration)


@register_element("brotlidecompress", Rank.NONE)
class BrotliDecompress(_DecompressBase):
    """Brotli decompressor. Decodes any RFC 7932 stream via the
    python brotli module or the in-image libbrotlidec; with neither
    backend the from-spec RFC 7932 decoder handles stored-mode /
    metadata metablocks and errors clearly on prefix-coded ones
    (their decode needs the Appendix A static dictionary)."""

    MEDIA_TYPES = (BROTLI_CAPS,)
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    _compressed_tmpl(BROTLI_CAPS)),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.any()),
    ]

    def transform(self, buf: Buffer) -> Buffer:
        backend = _brotli_backend()
        if backend is not None:
            try:
                data = backend.decompress(buf.to_bytes())
            except Exception as e:
                self.post_error(f"brotlidecompress: {e}")
                raise FlowError(FlowReturn.ERROR)
        else:
            from gstpu_torch.codecs.brotli_rfc7932 import (BrotliError,
                                                           decompress)
            try:
                data = decompress(buf.to_bytes())
            except BrotliError as e:
                self.post_error(f"brotlidecompress: {e}")
                raise FlowError(FlowReturn.ERROR)
        return Buffer(data, pts=buf.pts, duration=buf.duration)
