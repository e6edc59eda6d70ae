"""ctypes bindings for the in-image libbrotlienc/libbrotlidec.

Same architecture ruling as `gstpu/net/sodium` (wire-compatible via
the system C library): the reference's generic/compress crate wraps
the brotli engine as a library (reference
generic/gtp/../compress/src/lib.rs uses the `brotli` crate); gstpu
wraps the equivalent C library shipped in this image
(libbrotlienc.so.1 / libbrotlidec.so.1, RFC 7932 conformant,
static-dictionary included).  Falls back cleanly when the libraries
are absent — `available()` gates everything.

The port's copy of gstpu/codecs/brotli_ctypes.py:
libbrotlienc/libbrotlidec through ctypes.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

_enc: Optional[ctypes.CDLL] = None
_dec: Optional[ctypes.CDLL] = None
_tried = False

BROTLI_DECODER_RESULT_ERROR = 0
BROTLI_DECODER_RESULT_SUCCESS = 1
BROTLI_DECODER_RESULT_NEEDS_MORE_INPUT = 2
BROTLI_DECODER_RESULT_NEEDS_MORE_OUTPUT = 3


def _load() -> None:
    global _enc, _dec, _tried
    if _tried:
        return
    _tried = True
    for name in ("libbrotlienc.so.1", "libbrotlienc.so",
                 ctypes.util.find_library("brotlienc")):
        if not name:
            continue
        try:
            _enc = ctypes.CDLL(name)
            break
        except OSError:
            continue
    for name in ("libbrotlidec.so.1", "libbrotlidec.so",
                 ctypes.util.find_library("brotlidec")):
        if not name:
            continue
        try:
            _dec = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if _enc is not None:
        _enc.BrotliEncoderCompress.restype = ctypes.c_int
        _enc.BrotliEncoderCompress.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_size_t, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
        _enc.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
        _enc.BrotliEncoderMaxCompressedSize.argtypes = [ctypes.c_size_t]
    if _dec is not None:
        _dec.BrotliDecoderCreateInstance.restype = ctypes.c_void_p
        _dec.BrotliDecoderCreateInstance.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _dec.BrotliDecoderDestroyInstance.argtypes = [ctypes.c_void_p]
        _dec.BrotliDecoderDecompressStream.restype = ctypes.c_int
        _dec.BrotliDecoderDecompressStream.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_size_t)]


def available() -> bool:
    _load()
    return _enc is not None and _dec is not None


def compress(data: bytes, quality: int = 11, lgwin: int = 22) -> bytes:
    """One-shot RFC 7932 compression (mode GENERIC)."""
    _load()
    assert _enc is not None
    max_out = _enc.BrotliEncoderMaxCompressedSize(len(data)) or (
        len(data) + 1024)
    out = ctypes.create_string_buffer(max_out)
    out_len = ctypes.c_size_t(max_out)
    ok = _enc.BrotliEncoderCompress(
        max(0, min(11, quality)), max(10, min(24, lgwin)), 0,
        len(data), data, ctypes.byref(out_len), out)
    if not ok:
        raise RuntimeError("BrotliEncoderCompress failed")
    return out.raw[:out_len.value]


def decompress(data: bytes) -> bytes:
    """Streaming decode with a growing output buffer (the one-shot
    BrotliDecoderDecompress needs the decoded size up front)."""
    _load()
    assert _dec is not None
    st = _dec.BrotliDecoderCreateInstance(None, None, None)
    if not st:
        raise RuntimeError("BrotliDecoderCreateInstance failed")
    try:
        inbuf = (ctypes.c_ubyte * max(1, len(data))).from_buffer_copy(
            data or b"\x00")
        next_in = ctypes.cast(inbuf, ctypes.POINTER(ctypes.c_ubyte))
        avail_in = ctypes.c_size_t(len(data))
        chunks: list[bytes] = []
        while True:
            chunk = (ctypes.c_ubyte * 65536)()
            next_out = ctypes.cast(chunk, ctypes.POINTER(ctypes.c_ubyte))
            avail_out = ctypes.c_size_t(len(chunk))
            res = _dec.BrotliDecoderDecompressStream(
                st, ctypes.byref(avail_in), ctypes.byref(next_in),
                ctypes.byref(avail_out), ctypes.byref(next_out), None)
            produced = len(chunk) - avail_out.value
            if produced:
                chunks.append(bytes(chunk[:produced]))
            if res == BROTLI_DECODER_RESULT_SUCCESS:
                return b"".join(chunks)
            if res == BROTLI_DECODER_RESULT_NEEDS_MORE_OUTPUT:
                continue
            if res == BROTLI_DECODER_RESULT_NEEDS_MORE_INPUT:
                raise ValueError("truncated brotli stream")
            raise ValueError("corrupt brotli stream")
    finally:
        _dec.BrotliDecoderDestroyInstance(st)
