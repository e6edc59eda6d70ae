"""sodiumencrypter / sodiumdecrypter: libsodium crypto_box streams.

Rebuilds the reference generic/sodium elements WIRE-COMPATIBLY
(generic/sodium/src/{encrypter,decrypter}/imp.rs + lib.rs): the
stream is

    b"gst-sodium10" | nonce (24B) | block_size (u32 LE)
    crypto_box_easy(block, nonce + i) per block_size chunk

using Curve25519 + XSalsa20-Poly1305 (crypto_box precomputed with
receiver public key x sender secret key), the nonce incremented
little-endian per block, the final short block flushed at EOS.
libsodium itself does the crypto, loaded via ctypes
(libsodium.so.23 ships in this image).

The decrypter serves BOTH scheduling modes like the reference
(decrypter/imp.rs:412-511): push mode (chunked adapter) and pull
mode — `pull_range(offset, size)` maps plaintext offsets to chunk
indices, pulls only those chunks upstream, decrypts each with
nonce = initial_nonce + chunk_index, and slices the request out.

The port's copy of gstpu/elements/generic/sodium.py: host code: the
encrypter reads the payload through `Buffer.to_bytes()`, one download of
a tensor a buffer.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

MAGIC = b"gst-sodium10"          # reference lib.rs TYPEFIND_HEADER
NONCE_BYTES = 24
MAC_BYTES = 16
HEADER_SIZE = len(MAGIC) + NONCE_BYTES + 4
ENC_CAPS = Caps.new("application/x-sodium-encrypted-stream")


def _load_sodium():
    for name in ("libsodium.so.23", "libsodium.so",
                 ctypes.util.find_library("sodium")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            lib.sodium_init()
            return lib
        except OSError:
            continue
    return None


_SODIUM = _load_sodium()


def sodium_available() -> bool:
    return _SODIUM is not None


def generate_keypair() -> tuple[bytes, bytes]:
    """(public, secret) Curve25519 keypair."""
    pk = ctypes.create_string_buffer(32)
    sk = ctypes.create_string_buffer(32)
    _SODIUM.crypto_box_keypair(pk, sk)
    return pk.raw, sk.raw


class _BoxState:
    """Precomputed crypto_box with an LE-incrementing nonce
    (reference encrypter/imp.rs State)."""

    def __init__(self, receiver_pk: bytes, sender_sk: bytes,
                 nonce: bytes):
        self.k = ctypes.create_string_buffer(32)
        rc = _SODIUM.crypto_box_beforenm(self.k, receiver_pk,
                                         sender_sk)
        if rc != 0:
            raise ValueError("crypto_box_beforenm failed (bad keys?)")
        self.nonce = ctypes.create_string_buffer(nonce, NONCE_BYTES)

    def _bump(self) -> None:
        _SODIUM.sodium_increment(self.nonce, NONCE_BYTES)

    def seal(self, message: bytes) -> bytes:
        out = ctypes.create_string_buffer(len(message) + MAC_BYTES)
        _SODIUM.crypto_box_easy_afternm(
            out, message, ctypes.c_ulonglong(len(message)),
            self.nonce, self.k)
        self._bump()
        return out.raw

    def open(self, sealed: bytes) -> bytes | None:
        if len(sealed) < MAC_BYTES:
            return None
        out = ctypes.create_string_buffer(len(sealed) - MAC_BYTES)
        rc = _SODIUM.crypto_box_open_easy_afternm(
            out, sealed, ctypes.c_ulonglong(len(sealed)),
            self.nonce, self.k)
        self._bump()
        if rc != 0:
            return None
        return out.raw

    def open_at(self, sealed: bytes, nonce: bytes) -> bytes | None:
        """Random-access decrypt with an explicit nonce (pull mode);
        does not touch the streaming nonce."""
        if len(sealed) < MAC_BYTES:
            return None
        out = ctypes.create_string_buffer(len(sealed) - MAC_BYTES)
        rc = _SODIUM.crypto_box_open_easy_afternm(
            out, sealed, ctypes.c_ulonglong(len(sealed)),
            ctypes.create_string_buffer(nonce, NONCE_BYTES), self.k)
        if rc != 0:
            return None
        return out.raw


def _nonce_add(nonce: bytes, i: int) -> bytes:
    """initial_nonce + i with libsodium's little-endian increment
    semantics."""
    v = (int.from_bytes(nonce, "little") + i) % (1 << (8 * NONCE_BYTES))
    return v.to_bytes(NONCE_BYTES, "little")


class _SodiumBase(BaseTransform):
    receiver_key = Property(bytes, default=None,
                            mutable=Mutability.READY,
                            blurb="32-byte Curve25519 public key of "
                                  "the receiver")
    sender_key = Property(bytes, default=None,
                          mutable=Mutability.READY,
                          blurb="32-byte Curve25519 secret key of "
                                "the sender")

    def _check_env(self) -> bool:
        if _SODIUM is None:
            self.post_error(f"{self.ELEMENT_NAME}: libsodium not "
                            "available")
            return False
        for k, n in ((self.receiver_key, "receiver-key"),
                     (self.sender_key, "sender-key")):
            if not k or len(k) != 32:
                self.post_error(f"{self.ELEMENT_NAME}: {n} must be "
                                "32 bytes")
                return False
        return True


@register_element("sodiumencrypter", Rank.NONE)
class SodiumEncrypter(_SodiumBase):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    ENC_CAPS.copy()),
    ]

    block_size = Property(int, default=32768, minimum=1,
                          maximum=0xFFFFFFFF,
                          mutable=Mutability.READY)
    nonce = Property(bytes, default=None, mutable=Mutability.READY,
                     blurb="24-byte initial nonce (random if unset; "
                           "settable for deterministic tests like "
                           "GST_SODIUM_ENCRYPT_NONCE)")

    def __init__(self, name=None):
        super().__init__(name)
        self._state: _BoxState | None = None
        self._acc = bytearray()
        self._header_sent = False

    def transform_caps(self, direction, caps, filter):
        out = ENC_CAPS.copy() if direction is PadDirection.SINK \
            else Caps.any()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def start(self) -> bool:
        if not self._check_env():
            return False
        import os
        initial = self.nonce or os.urandom(NONCE_BYTES)
        if len(initial) != NONCE_BYTES:
            self.post_error("sodiumencrypter: nonce must be 24 bytes")
            return False
        self._initial_nonce = initial
        try:
            self._state = _BoxState(self.receiver_key,
                                    self.sender_key, initial)
        except ValueError as e:
            self.post_error(f"sodiumencrypter: {e}")
            return False
        self._acc = bytearray()
        self._header_sent = False
        return True

    def _emit(self, final: bool) -> list[Buffer]:
        out = []
        if not self._header_sent:
            hdr = (MAGIC + self._initial_nonce
                   + struct.pack("<I", self.block_size))
            out.append(Buffer(hdr))
            self._header_sent = True
        bs = self.block_size
        while len(self._acc) >= bs:
            block, self._acc = bytes(self._acc[:bs]), self._acc[bs:]
            out.append(Buffer(self._state.seal(block)))
        if final and self._acc:
            out.append(Buffer(self._state.seal(bytes(self._acc))))
            self._acc = bytearray()
        return out

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        self._acc.extend(buf.to_bytes())
        return self._emit(final=False) or None

    def drain(self) -> list[Buffer]:
        if self._state is None:
            return []
        return self._emit(final=True)


@register_element("sodiumdecrypter", Rank.NONE)
class SodiumDecrypter(_SodiumBase):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    ENC_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.any()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._state: _BoxState | None = None
        self._block_size = None
        self._acc = bytearray()

    def transform_caps(self, direction, caps, filter):
        out = Caps.new("application/octet-stream") \
            if direction is PadDirection.SINK else ENC_CAPS.copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def start(self) -> bool:
        if not self._check_env():
            return False
        self._state = None
        self._block_size = None
        self._acc = bytearray()
        return True

    def _decrypt_available(self, final: bool) -> list[Buffer]:
        out = []
        chunk = self._block_size + MAC_BYTES
        while len(self._acc) >= chunk or (final and self._acc):
            n = min(chunk, len(self._acc))
            sealed, self._acc = bytes(self._acc[:n]), self._acc[n:]
            pt = self._state.open(sealed)
            if pt is None:
                self.post_error("sodiumdecrypter: authentication "
                                "failed")
                raise FlowError(FlowReturn.ERROR)
            out.append(Buffer(pt))
        return out

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        self._acc.extend(buf.to_bytes())
        if self._state is None:
            if len(self._acc) < HEADER_SIZE:
                return None
            if bytes(self._acc[:len(MAGIC)]) != MAGIC:
                self.post_error("sodiumdecrypter: bad stream magic")
                raise FlowError(FlowReturn.ERROR)
            nonce = bytes(self._acc[len(MAGIC):len(MAGIC)
                                    + NONCE_BYTES])
            self._block_size, = struct.unpack_from(
                "<I", self._acc, len(MAGIC) + NONCE_BYTES)
            try:
                # decrypter precomputes sender PUBLIC x receiver
                # SECRET (reference decrypter/imp.rs:85)
                self._state = _BoxState(self.sender_key,
                                        self.receiver_key, nonce)
            except ValueError as e:
                self.post_error(f"sodiumdecrypter: {e}")
                raise FlowError(FlowReturn.ERROR)
            del self._acc[:HEADER_SIZE]
        # only full blocks mid-stream; the tail comes out on EOS
        return self._decrypt_available(final=False) or None

    def drain(self) -> list[Buffer]:
        if self._state is None or not self._acc:
            return []
        return self._decrypt_available(final=True)

    # -- pull mode (reference decrypter/imp.rs:412-511) -----------------
    def _pull_header(self) -> None:
        if self._state is not None:
            return
        hdr = self.sinkpad.pull_range(0, HEADER_SIZE)
        if len(hdr) < HEADER_SIZE or hdr[:len(MAGIC)] != MAGIC:
            raise FlowError(FlowReturn.ERROR,
                            "sodiumdecrypter: bad stream header")
        self._initial_nonce = hdr[len(MAGIC):len(MAGIC) + NONCE_BYTES]
        self._block_size, = struct.unpack_from(
            "<I", hdr, len(MAGIC) + NONCE_BYTES)
        self._state = _BoxState(self.sender_key, self.receiver_key,
                                self._initial_nonce)

    def plaintext_size(self) -> int:
        """Total decrypted size, derived from the upstream byte size
        (needed to answer duration/seek queries in pull mode)."""
        self._pull_header()
        src = self.sinkpad.peer.element
        total = getattr(src, "size", 0) - HEADER_SIZE
        chunk = self._block_size + MAC_BYTES
        n_full, rem = divmod(total, chunk)
        out = n_full * self._block_size
        if rem:
            out += rem - MAC_BYTES
        return out

    def pull_range(self, offset: int, size: int) -> bytes:
        """Random access into the plaintext: pulls only the chunks
        covering [offset, offset+size), decrypts each with
        nonce = initial_nonce + chunk_index."""
        self._pull_header()
        bs = self._block_size
        chunk = bs + MAC_BYTES
        first = offset // bs
        last = (offset + size - 1) // bs if size else first
        enc = self.sinkpad.pull_range(
            HEADER_SIZE + first * chunk, (last - first + 1) * chunk)
        out = bytearray()
        for i in range(first, last + 1):
            sealed = enc[(i - first) * chunk:(i - first + 1) * chunk]
            if not sealed:
                break
            pt = self._state.open_at(sealed,
                                     _nonce_add(self._initial_nonce, i))
            if pt is None:
                raise FlowError(FlowReturn.ERROR,
                                "sodiumdecrypter: authentication "
                                f"failed at chunk {i}")
            out += pt
        start = offset - first * bs
        return bytes(out[start:start + size])

    def ready_to_paused(self) -> bool:
        # expose getrange downstream when upstream supports it
        if self.sinkpad.can_pull:
            self.static_pad("src").get_range_function = \
                lambda pad, off, size: self.pull_range(off, size)
        return super().ready_to_paused()
