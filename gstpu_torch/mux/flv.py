"""FLV container parsing/writing.

Parser for the flvdemux element (reference mux/flavors rsflvdemux,
which uses the nom-based `flavors` parser crate); the writer exists
for tests/tools (round-trip strategy like the reference's mux tests).

The port's copy of gstpu/mux/flv.py: the standard library, as there.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

TAG_AUDIO = 8
TAG_VIDEO = 9
TAG_SCRIPT = 18

AUDIO_FORMATS = {
    0: ("audio/x-raw", "LPCM"), 1: ("audio/x-adpcm", "ADPCM"),
    2: ("audio/mpeg", "MP3"), 3: ("audio/x-raw", "LPCM-LE"),
    7: ("audio/x-alaw", "G711A"), 8: ("audio/x-mulaw", "G711U"),
    10: ("audio/mpeg4-aac", "AAC"), 11: ("audio/x-speex", "Speex"),
}
VIDEO_CODECS = {
    2: "video/x-flash-video",      # Sorenson H.263
    3: "video/x-flash-screen",
    4: "video/x-vp6-flash",
    5: "video/x-vp6-alpha",
    7: "video/x-h264",
}
AUDIO_RATES = {0: 5512, 1: 11025, 2: 22050, 3: 44100}


@dataclass
class FlvTag:
    tag_type: int
    timestamp_ms: int
    data: bytes

    # audio fields
    @property
    def sound_format(self) -> int:
        return self.data[0] >> 4 if self.data else 0

    @property
    def sound_rate(self) -> int:
        return AUDIO_RATES[(self.data[0] >> 2) & 3]

    @property
    def sound_channels(self) -> int:
        return 2 if (self.data[0] & 1) else 1

    @property
    def audio_payload(self) -> bytes:
        # AAC has an extra AACPacketType byte
        return self.data[2:] if self.sound_format == 10 else self.data[1:]

    # video fields
    @property
    def frame_type(self) -> int:
        return self.data[0] >> 4 if self.data else 0

    @property
    def video_codec(self) -> int:
        return self.data[0] & 0x0F if self.data else 0

    @property
    def is_keyframe(self) -> bool:
        return self.frame_type == 1

    @property
    def video_payload(self) -> bytes:
        # AVC has AVCPacketType u8 + composition time s24
        return self.data[5:] if self.video_codec == 7 else self.data[1:]

    @property
    def avc_packet_type(self) -> int | None:
        return self.data[1] if self.video_codec == 7 else None


class FlvParser:
    """Streaming FLV parser: feed bytes, pop tags."""

    def __init__(self):
        self._buf = bytearray()
        self._header_parsed = False
        self.has_audio = False
        self.has_video = False

    def push(self, data: bytes) -> None:
        self._buf.extend(data)

    def poll(self) -> FlvTag | None:
        if not self._header_parsed:
            if len(self._buf) < 9:
                return None
            if self._buf[:3] != b"FLV":
                raise ValueError("not an FLV stream")
            flags = self._buf[4]
            self.has_audio = bool(flags & 4)
            self.has_video = bool(flags & 1)
            offset, = struct.unpack_from(">I", self._buf, 5)
            del self._buf[:offset]
            self._header_parsed = True
        # prevTagSize u32 + tag header 11
        if len(self._buf) < 15:
            return None
        tag_type = self._buf[4]
        size = int.from_bytes(self._buf[5:8], "big")
        ts = int.from_bytes(self._buf[8:11], "big") \
            | (self._buf[11] << 24)
        if len(self._buf) < 15 + size:
            return None
        data = bytes(self._buf[15:15 + size])
        del self._buf[:15 + size]
        return FlvTag(tag_type, ts, data)


class FlvWriter:
    """Minimal FLV writer (tests/tools)."""

    def __init__(self, has_audio=True, has_video=True):
        flags = (4 if has_audio else 0) | (1 if has_video else 0)
        self.data = bytearray(b"FLV\x01" + bytes([flags])
                              + struct.pack(">I", 9))

    def _tag(self, tag_type: int, ts_ms: int, body: bytes) -> None:
        self.data += struct.pack(">I", 0)  # prevTagSize (lazy: zero)
        self.data += bytes([tag_type]) + len(body).to_bytes(3, "big") \
            + (ts_ms & 0xFFFFFF).to_bytes(3, "big") \
            + bytes([(ts_ms >> 24) & 0xFF]) + b"\x00\x00\x00" + body

    def audio_tag(self, ts_ms: int, payload: bytes, sound_format=2,
                  rate_idx=3, stereo=True) -> None:
        hdr = bytes([(sound_format << 4) | (rate_idx << 2) | 2
                     | (1 if stereo else 0)])
        self._tag(TAG_AUDIO, ts_ms, hdr + payload)

    def video_tag(self, ts_ms: int, payload: bytes, codec=7,
                  keyframe=True, avc_packet_type=1) -> None:
        hdr = bytes([((1 if keyframe else 2) << 4) | codec])
        if codec == 7:
            hdr += bytes([avc_packet_type]) + b"\x00\x00\x00"
        self._tag(TAG_VIDEO, ts_ms, hdr + payload)

    def to_bytes(self) -> bytes:
        return bytes(self.data)
