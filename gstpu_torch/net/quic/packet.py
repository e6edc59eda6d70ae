"""QUIC v1 wire format: varints, packet headers, packet protection
(RFC 9000 §16-17, RFC 9001 §5).

Keys: initial secrets derive from the client's DCID with the v1 salt;
handshake/application keys come from the TLS 1.3 secrets. Payload
protection is AES-128-GCM, header protection AES-128-ECB over a
sample of the ciphertext.

The port's copy of gstpu/net/quic/packet.py, as it stands.
"""

from __future__ import annotations

import hashlib
import hmac
import struct
from dataclasses import dataclass, field

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

QUIC_V1 = 0x00000001
INITIAL_SALT_V1 = bytes.fromhex(
    "38762cf7f55934b34d179ae6a4c80cadccbb7f0a")

# long header packet types (v1)
PT_INITIAL = 0
PT_0RTT = 1
PT_HANDSHAKE = 2
PT_RETRY = 3


class QuicError(Exception):
    pass


# ---------------------------------------------------------------------------
# varints (RFC 9000 §16)
# ---------------------------------------------------------------------------

def encode_varint(v: int) -> bytes:
    if v < 0x40:
        return bytes([v])
    if v < 0x4000:
        return struct.pack(">H", 0x4000 | v)
    if v < 0x40000000:
        return struct.pack(">I", 0x80000000 | v)
    if v < 0x4000000000000000:
        return struct.pack(">Q", 0xC000000000000000 | v)
    raise QuicError("varint too large")


def decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    if pos >= len(data):
        raise QuicError("varint truncated")
    first = data[pos]
    length = 1 << (first >> 6)
    if pos + length > len(data):
        raise QuicError("varint truncated")
    v = first & 0x3F
    for i in range(1, length):
        v = (v << 8) | data[pos + i]
    return v, pos + length


# ---------------------------------------------------------------------------
# HKDF (RFC 5869 / TLS 1.3 labels)
# ---------------------------------------------------------------------------

def hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, ikm, hashlib.sha256).digest()


def hkdf_expand(prk: bytes, info: bytes, n: int) -> bytes:
    out, t, i = b"", b"", 1
    while len(out) < n:
        t = hmac.new(prk, t + info + bytes([i]),
                     hashlib.sha256).digest()
        out += t
        i += 1
    return out[:n]


def hkdf_expand_label(secret: bytes, label: bytes, context: bytes,
                      n: int) -> bytes:
    full = b"tls13 " + label
    info = (struct.pack(">H", n) + bytes([len(full)]) + full
            + bytes([len(context)]) + context)
    return hkdf_expand(secret, info, n)


# ---------------------------------------------------------------------------
# per-level protection keys
# ---------------------------------------------------------------------------

@dataclass
class DirectionKeys:
    key: bytes
    iv: bytes
    hp: bytes

    @staticmethod
    def from_secret(secret: bytes) -> "DirectionKeys":
        return DirectionKeys(
            hkdf_expand_label(secret, b"quic key", b"", 16),
            hkdf_expand_label(secret, b"quic iv", b"", 12),
            hkdf_expand_label(secret, b"quic hp", b"", 16))


def initial_keys(dcid: bytes, is_client: bool) \
        -> tuple[DirectionKeys, DirectionKeys]:
    """(write_keys, read_keys) for the Initial space (RFC 9001 §5.2)."""
    initial = hkdf_extract(INITIAL_SALT_V1, dcid)
    client = hkdf_expand_label(initial, b"client in", b"", 32)
    server = hkdf_expand_label(initial, b"server in", b"", 32)
    ck, sk = (DirectionKeys.from_secret(client),
              DirectionKeys.from_secret(server))
    return (ck, sk) if is_client else (sk, ck)


def _hp_mask(hp_key: bytes, sample: bytes) -> bytes:
    enc = Cipher(algorithms.AES(hp_key), modes.ECB()).encryptor()
    return enc.update(sample) + enc.finalize()


def _nonce(iv: bytes, pn: int) -> bytes:
    return bytes(a ^ b for a, b in zip(iv, pn.to_bytes(12, "big")))


# ---------------------------------------------------------------------------
# packet build/parse
# ---------------------------------------------------------------------------

@dataclass
class PlainPacket:
    is_long: bool
    ptype: int               # PT_* for long; ignored for short
    dcid: bytes
    scid: bytes              # long header only
    pn: int
    payload: bytes
    token: bytes = b""       # Initial only
    key_phase: int = 0


def _encode_pn(pn: int) -> bytes:
    # fixed 4-byte packet numbers keep decode trivial (legal per RFC)
    return struct.pack(">I", pn & 0xFFFFFFFF)


def build_packet(p: PlainPacket, keys: DirectionKeys) -> bytes:
    pn_bytes = _encode_pn(p.pn)
    if p.is_long:
        first = 0xC0 | (p.ptype << 4) | (len(pn_bytes) - 1)
        hdr = bytes([first]) + struct.pack(">I", QUIC_V1)
        hdr += bytes([len(p.dcid)]) + p.dcid
        hdr += bytes([len(p.scid)]) + p.scid
        if p.ptype == PT_INITIAL:
            hdr += encode_varint(len(p.token)) + p.token
        length = len(pn_bytes) + len(p.payload) + 16
        hdr += encode_varint(length)
    else:
        first = 0x40 | (p.key_phase << 2) | (len(pn_bytes) - 1)
        hdr = bytes([first]) + p.dcid
    pn_off = len(hdr)
    header = hdr + pn_bytes
    ct = AESGCM(keys.key).encrypt(_nonce(keys.iv, p.pn), p.payload,
                                  header)
    pkt = bytearray(header + ct)
    # header protection: sample starts 4 bytes after the pn offset
    sample = bytes(pkt[pn_off + 4:pn_off + 20])
    mask = _hp_mask(keys.hp, sample)
    pkt[0] ^= mask[0] & (0x0F if p.is_long else 0x1F)
    for i in range(len(pn_bytes)):
        pkt[pn_off + i] ^= mask[1 + i]
    return bytes(pkt)


def parse_long_header(data: bytes) -> tuple[int, bytes, bytes, int]:
    """-> (ptype, dcid, scid, pos_after_scid). Raises on garbage."""
    if len(data) < 7 or not data[0] & 0x80:
        raise QuicError("not a long header")
    version, = struct.unpack_from(">I", data, 1)
    if version != QUIC_V1:
        raise QuicError(f"unsupported version {version:#x}")
    ptype = (data[0] >> 4) & 0x3
    pos = 5
    dlen = data[pos]; pos += 1
    dcid = data[pos:pos + dlen]; pos += dlen
    slen = data[pos]; pos += 1
    scid = data[pos:pos + slen]; pos += slen
    if len(dcid) != dlen or len(scid) != slen:
        raise QuicError("truncated header")
    return ptype, dcid, scid, pos


def unprotect_packet(data: bytes, pos_hint: int, keys: DirectionKeys,
                     is_long: bool, dcid_len: int = 8) \
        -> tuple[PlainPacket, int]:
    """Unprotect one packet starting at offset 0 of `data`.
    Returns (packet, total_length_consumed)."""
    if is_long:
        ptype, dcid, scid, pos = parse_long_header(data)
        token = b""
        if ptype == PT_INITIAL:
            tlen, pos = decode_varint(data, pos)
            token = data[pos:pos + tlen]
            pos += tlen
        length, pos = decode_varint(data, pos)
        pn_off = pos
        end = pn_off + length
    else:
        ptype = -1
        dcid = data[1:1 + dcid_len]
        scid = b""
        token = b""
        pn_off = 1 + dcid_len
        end = len(data)
    if end > len(data) or pn_off + 20 > len(data):
        raise QuicError("truncated packet")
    buf = bytearray(data[:end])
    sample = bytes(buf[pn_off + 4:pn_off + 20])
    mask = _hp_mask(keys.hp, sample)
    buf[0] ^= mask[0] & (0x0F if is_long else 0x1F)
    pn_len = (buf[0] & 0x03) + 1
    for i in range(pn_len):
        buf[pn_off + i] ^= mask[1 + i]
    pn = int.from_bytes(buf[pn_off:pn_off + pn_len], "big")
    header = bytes(buf[:pn_off + pn_len])
    ct = bytes(buf[pn_off + pn_len:end])
    try:
        payload = AESGCM(keys.key).decrypt(_nonce(keys.iv, pn), ct,
                                           header)
    except Exception as e:
        raise QuicError("packet authentication failed") from e
    key_phase = (buf[0] >> 2) & 1 if not is_long else 0
    return (PlainPacket(is_long, ptype, dcid, scid, pn, payload,
                        token, key_phase), end)
