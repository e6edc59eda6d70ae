"""STUN message codec (RFC 5389) with the ICE attributes (RFC 8445).

Sans-IO building block for the webrtc data plane: the reference gets
this from str0m inside webrtcbin2 (net/webrtc/src/webrtcbin2); here
it is rebuilt from the RFCs. Covers BINDING request/success/error,
MESSAGE-INTEGRITY (HMAC-SHA1 with the adjusted-length rule),
FINGERPRINT (CRC32 xor 0x5354554e), XOR-MAPPED-ADDRESS, and the ICE
connectivity-check attributes.

The port's copy of gstpu/net/webrtc/stun.py, as it stands.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct
import zlib
from dataclasses import dataclass, field

MAGIC_COOKIE = 0x2112A442

# message types (method BINDING = 0x001)
BINDING_REQUEST = 0x0001
BINDING_SUCCESS = 0x0101
BINDING_ERROR = 0x0111
BINDING_INDICATION = 0x0011

# attribute types
ATTR_MAPPED_ADDRESS = 0x0001
ATTR_USERNAME = 0x0006
ATTR_MESSAGE_INTEGRITY = 0x0008
ATTR_ERROR_CODE = 0x0009
ATTR_UNKNOWN_ATTRIBUTES = 0x000A
ATTR_XOR_MAPPED_ADDRESS = 0x0020
ATTR_PRIORITY = 0x0024
ATTR_USE_CANDIDATE = 0x0025
ATTR_SOFTWARE = 0x8022
ATTR_FINGERPRINT = 0x8028
ATTR_ICE_CONTROLLED = 0x8029
ATTR_ICE_CONTROLLING = 0x802A

FINGERPRINT_XOR = 0x5354554E


class StunError(ValueError):
    pass


def _pad4(n: int) -> int:
    return (4 - n % 4) % 4


def xor_address(addr: tuple[str, int],
                transaction_id: bytes) -> bytes:
    """XOR-MAPPED-ADDRESS value for IPv4 (RFC 5389 §15.2)."""
    host, port = addr
    xport = port ^ (MAGIC_COOKIE >> 16)
    raw = bytes(int(x) for x in host.split("."))
    xaddr = bytes(b ^ m for b, m in
                  zip(raw, struct.pack(">I", MAGIC_COOKIE)))
    return struct.pack(">BBH", 0, 0x01, xport) + xaddr


def unxor_address(value: bytes,
                  transaction_id: bytes) -> tuple[str, int]:
    fam = value[1]
    if fam != 0x01:
        raise StunError("only IPv4 XOR-MAPPED-ADDRESS supported")
    xport, = struct.unpack_from(">H", value, 2)
    port = xport ^ (MAGIC_COOKIE >> 16)
    xaddr = value[4:8]
    raw = bytes(b ^ m for b, m in
                zip(xaddr, struct.pack(">I", MAGIC_COOKIE)))
    return ".".join(str(b) for b in raw), port


@dataclass
class StunMessage:
    msg_type: int
    transaction_id: bytes = field(
        default_factory=lambda: os.urandom(12))
    attributes: list[tuple[int, bytes]] = field(default_factory=list)

    # -- building ---------------------------------------------------------
    def add(self, attr_type: int, value: bytes) -> "StunMessage":
        self.attributes.append((attr_type, value))
        return self

    def add_username(self, username: str) -> "StunMessage":
        return self.add(ATTR_USERNAME, username.encode())

    def add_priority(self, priority: int) -> "StunMessage":
        return self.add(ATTR_PRIORITY, struct.pack(">I", priority))

    def add_xor_mapped_address(self, addr) -> "StunMessage":
        return self.add(ATTR_XOR_MAPPED_ADDRESS,
                        xor_address(addr, self.transaction_id))

    def add_error(self, code: int, reason: str) -> "StunMessage":
        return self.add(ATTR_ERROR_CODE,
                        struct.pack(">HBB", 0, code // 100,
                                    code % 100) + reason.encode())

    def get(self, attr_type: int) -> bytes | None:
        for t, v in self.attributes:
            if t == attr_type:
                return v
        return None

    # -- serialization ------------------------------------------------------
    def _encode(self, attributes) -> bytes:
        body = b""
        for t, v in attributes:
            body += struct.pack(">HH", t, len(v)) + v
            body += b"\x00" * _pad4(len(v))
        return (struct.pack(">HHI", self.msg_type, len(body),
                            MAGIC_COOKIE)
                + self.transaction_id + body)

    def to_bytes(self, integrity_key: bytes | None = None,
                 fingerprint: bool = True) -> bytes:
        attrs = list(self.attributes)
        if integrity_key is not None:
            # the length field counts through the MI attribute
            # (RFC 5389 §15.4): encode with a placeholder first
            placeholder = attrs + [(ATTR_MESSAGE_INTEGRITY,
                                    bytes(20))]
            data = self._encode(placeholder)
            mac = hmac.new(integrity_key, data[:-24],
                           hashlib.sha1).digest()
            attrs.append((ATTR_MESSAGE_INTEGRITY, mac))
        if fingerprint:
            placeholder = attrs + [(ATTR_FINGERPRINT, bytes(4))]
            data = self._encode(placeholder)
            crc = (zlib.crc32(data[:-8]) ^ FINGERPRINT_XOR) \
                & 0xFFFFFFFF
            attrs.append((ATTR_FINGERPRINT, struct.pack(">I", crc)))
        return self._encode(attrs)

    # -- parsing -----------------------------------------------------------
    @staticmethod
    def parse(data: bytes) -> "StunMessage":
        if len(data) < 20:
            raise StunError("short STUN message")
        msg_type, length, cookie = struct.unpack_from(">HHI", data)
        if cookie != MAGIC_COOKIE:
            raise StunError("bad magic cookie")
        if msg_type & 0xC000:
            raise StunError("not a STUN message type")
        if len(data) < 20 + length:
            raise StunError("truncated STUN message")
        tid = data[8:20]
        attrs = []
        pos = 20
        end = 20 + length
        while pos + 4 <= end:
            t, ln = struct.unpack_from(">HH", data, pos)
            v = data[pos + 4:pos + 4 + ln]
            if len(v) < ln:
                raise StunError("truncated attribute")
            attrs.append((t, v))
            pos += 4 + ln + _pad4(ln)
        return StunMessage(msg_type, tid, attrs)

    def verify_integrity(self, key: bytes, data: bytes) -> bool:
        """Verify MESSAGE-INTEGRITY over the original wire bytes."""
        mi = self.get(ATTR_MESSAGE_INTEGRITY)
        if mi is None:
            return False
        # find the MI attribute's offset in the wire data
        pos = 20
        length, = struct.unpack_from(">H", data, 2)
        end = 20 + length
        while pos + 4 <= end:
            t, ln = struct.unpack_from(">HH", data, pos)
            if t == ATTR_MESSAGE_INTEGRITY:
                # length field must count through this attribute
                adjusted = struct.pack(">H", pos + 24 - 20)
                msg = data[:2] + adjusted + data[4:pos]
                mac = hmac.new(key, msg, hashlib.sha1).digest()
                return hmac.compare_digest(mac, mi)
            pos += 4 + ln + _pad4(ln)
        return False

    def verify_fingerprint(self, data: bytes) -> bool:
        fp = self.get(ATTR_FINGERPRINT)
        if fp is None:
            return False
        pos = 20
        length, = struct.unpack_from(">H", data, 2)
        end = 20 + length
        while pos + 4 <= end:
            t, ln = struct.unpack_from(">HH", data, pos)
            if t == ATTR_FINGERPRINT:
                adjusted = struct.pack(">H", pos + 8 - 20)
                msg = data[:2] + adjusted + data[4:pos]
                crc = (zlib.crc32(msg) ^ FINGERPRINT_XOR) & 0xFFFFFFFF
                return struct.unpack(">I", fp)[0] == crc
            pos += 4 + ln + _pad4(ln)
        return False


def is_stun(data: bytes) -> bool:
    """Demux helper (RFC 7983): STUN starts with 0b00 and the magic
    cookie."""
    return (len(data) >= 20 and data[0] < 4
            and struct.unpack_from(">I", data, 4)[0] == MAGIC_COOKIE)
