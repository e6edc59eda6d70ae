"""Brotli (RFC 7932) stream framing — stored-mode subset, from spec.

The reference's brotlicompress/brotlidecompress wrap the brotli C
library (generic/compress/src/brotli*). This environment has no
brotli module, so gstpu implements the RFC 7932 container itself:

* encoder: emits ISUNCOMPRESSED metablocks (§9.2) — a fully
  conformant brotli stream that ANY standard brotli decoder accepts
  (compression ratio 1.0; callers wanting entropy coding pair it
  with flatecompress).
* decoder: window bits, empty/metadata blocks, and uncompressed
  metablocks. Compressed (prefix-coded) metablocks raise a clear
  error — decoding those requires the 122 KB static dictionary
  (Appendix A), which is literal data that cannot be derived from
  spec text and is not present in this image.

Bit order is LSB-first within bytes (§1.5.1).

The port's copy of gstpu/codecs/brotli_rfc7932.py: stored-mode brotli,
used where no library backend loads.
"""

from __future__ import annotations


class BrotliError(ValueError):
    pass


class _BitWriter:
    def __init__(self) -> None:
        self.out = bytearray()
        self._acc = 0
        self._n = 0

    def write(self, value: int, bits: int) -> None:
        self._acc |= (value & ((1 << bits) - 1)) << self._n
        self._n += bits
        while self._n >= 8:
            self.out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._n -= 8

    def align(self) -> None:
        if self._n:
            self.out.append(self._acc & 0xFF)
            self._acc = 0
            self._n = 0

    def bytes_out(self) -> bytes:
        self.align()
        return bytes(self.out)


class _BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0                     # bit position

    def read(self, bits: int) -> int:
        v = 0
        for i in range(bits):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise BrotliError("truncated brotli stream")
            bit = (self.data[byte] >> (self.pos & 7)) & 1
            v |= bit << i
            self.pos += 1
        return v

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def read_bytes(self, n: int) -> bytes:
        assert self.pos % 8 == 0
        start = self.pos >> 3
        if start + n > len(self.data):
            raise BrotliError("truncated uncompressed metablock")
        self.pos += n * 8
        return self.data[start:start + n]

    @property
    def exhausted(self) -> bool:
        return self.pos >> 3 >= len(self.data)


_MAX_MLEN = (1 << 24)                    # max metablock payload


def compress_stored(data: bytes) -> bytes:
    """RFC 7932 stream of uncompressed metablocks + empty last block."""
    w = _BitWriter()
    w.write(0, 1)                        # WBITS = 16 (§9.1)
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + _MAX_MLEN]
        pos += len(chunk)
        mlen = len(chunk) - 1
        w.write(0, 1)                    # ISLAST = 0
        if mlen < 1 << 16:
            w.write(0, 2)                # MNIBBLES = 4
            w.write(mlen, 16)
        elif mlen < 1 << 20:
            w.write(1, 2)                # MNIBBLES = 5
            w.write(mlen, 20)
        else:
            w.write(2, 2)                # MNIBBLES = 6
            w.write(mlen, 24)
        w.write(1, 1)                    # ISUNCOMPRESSED
        w.align()
        w.out += chunk
    w.write(1, 1)                        # ISLAST
    w.write(1, 1)                        # ISLASTEMPTY
    return w.bytes_out()


def _read_wbits(r: _BitReader) -> int:
    if r.read(1) == 0:
        return 16
    n = r.read(3)
    if n != 0:
        return 17 + n
    m = r.read(3)
    if m == 0:
        return 17
    if m == 1:
        raise BrotliError("invalid WBITS pattern")
    return 8 + m


def decompress(data: bytes) -> bytes:
    """Decode the stored-mode subset; reject prefix-coded blocks."""
    r = _BitReader(data)
    wbits = _read_wbits(r)
    if not 10 <= wbits <= 24:
        raise BrotliError(f"window bits {wbits} out of range")
    out = bytearray()
    while True:
        islast = r.read(1)
        if islast:
            if r.read(1):                # ISLASTEMPTY
                return bytes(out)
        nibcode = r.read(2)
        if nibcode == 3:                 # metadata block (§9.2)
            if islast:
                raise BrotliError("metadata block flagged last")
            if r.read(1):
                raise BrotliError("reserved bit set")
            skipbytes = r.read(2)
            skiplen = 0
            if skipbytes:
                skiplen = r.read(skipbytes * 8)
                if skipbytes > 1 and skiplen >> ((skipbytes - 1) * 8) \
                        == 0:
                    raise BrotliError("non-minimal MSKIPLEN")
                skiplen += 1
            r.align()
            r.read_bytes(skiplen)
            continue
        nibbles = 4 + nibcode
        mlen = r.read(nibbles * 4) + 1
        if nibbles > 4 and (mlen - 1) >> ((nibbles - 1) * 4) == 0:
            raise BrotliError("non-minimal MLEN encoding")
        if not islast and r.read(1):     # ISUNCOMPRESSED
            r.align()
            out += r.read_bytes(mlen)
            continue
        raise BrotliError(
            "prefix-coded brotli metablock: full entropy decode "
            "requires the RFC 7932 Appendix A static dictionary, "
            "which is literal data unavailable in this environment")
