"""AWS eventstream binary framing (the vnd.amazon.eventstream
encoding the Transcribe streaming API speaks; the reference consumes
it through the AWS SDK — net/aws/src/transcriber/):

    [4B total length][4B headers length][4B prelude CRC32]
    [headers: 1B name-len, name, 1B type(7=string), 2B value-len,
     value]...
    [payload][4B message CRC32]

All integers big-endian; CRCs are zlib.crc32.

The port's copy of gstpu/net/aws/eventstream.py, as it stands.
"""

from __future__ import annotations

import struct
import zlib


class EventStreamError(ValueError):
    pass


def encode_message(headers: dict[str, str], payload: bytes) -> bytes:
    hdr = b""
    for name, value in headers.items():
        n, v = name.encode(), value.encode()
        hdr += bytes([len(n)]) + n + bytes([7]) \
            + struct.pack(">H", len(v)) + v
    total = 12 + len(hdr) + len(payload) + 4
    prelude = struct.pack(">II", total, len(hdr))
    prelude_crc = struct.pack(">I", zlib.crc32(prelude))
    body = prelude + prelude_crc + hdr + payload
    return body + struct.pack(">I", zlib.crc32(body))


def decode_message(data: bytes, pos: int = 0) \
        -> tuple[dict[str, str], bytes, int]:
    """-> (headers, payload, new_pos). Raises on truncation/CRC."""
    if pos + 16 > len(data):
        raise EventStreamError("truncated prelude")
    total, hlen = struct.unpack_from(">II", data, pos)
    prelude_crc, = struct.unpack_from(">I", data, pos + 8)
    if zlib.crc32(data[pos:pos + 8]) != prelude_crc:
        raise EventStreamError("prelude CRC mismatch")
    if pos + total > len(data):
        raise EventStreamError("truncated message")
    end = pos + total
    msg_crc, = struct.unpack_from(">I", data, end - 4)
    if zlib.crc32(data[pos:end - 4]) != msg_crc:
        raise EventStreamError("message CRC mismatch")
    headers: dict[str, str] = {}
    p = pos + 12
    hend = p + hlen
    while p < hend:
        nlen = data[p]
        p += 1
        name = data[p:p + nlen].decode()
        p += nlen
        htype = data[p]
        p += 1
        if htype != 7:
            raise EventStreamError(f"unsupported header type {htype}")
        vlen, = struct.unpack_from(">H", data, p)
        p += 2
        headers[name] = data[p:p + vlen].decode()
        p += vlen
    payload = data[hend:end - 4]
    return headers, payload, end
