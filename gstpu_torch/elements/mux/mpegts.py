"""mpegtsmux (minimal) + hlssink3: MPEG-TS HLS segments.

The reference hlssink3 (net/hlssink3/src/hlssink3/imp.rs:110) wraps an
external `mpegtsmux` and writes keyframe-aligned .ts segments plus the
media playlist.  This module provides both halves: a minimal
single-program TS muxer (PAT/PMT with MPEG-2 CRC32, PES with PTS,
PCR on the video pid, per-pid continuity counters) and the segment
sink.

The port's copy of gstpu/elements/mux/mpegts.py: host code, as there;
payloads are read through `Buffer.to_bytes()`.
"""

from __future__ import annotations

import os

from gstpu_torch.codecs.mpegts import (TS_PACKET_SIZE, build_pat, build_pes,
                                       build_pmt, build_ts_packet)
from gstpu_torch.core.base import Aggregator, BaseSink
from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.caps import AnyList, Caps, Structure
from gstpu_torch.core.element import (FlowReturn, PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000

# caps name -> (stream_type, PES stream_id)
_TS_STREAM_TYPES = {
    "video/x-h264": (0x1B, 0xE0),
    "video/x-h265": (0x24, 0xE0),
    "audio/mpeg": (0x0F, 0xC0),        # AAC ADTS
    "audio/x-ac3": (0x81, 0xBD),
    "meta/x-klv": (0x06, 0xBD),
}

_MUX_SINK = Caps([Structure(n) for n in _TS_STREAM_TYPES])
_TS_SRC = Caps.new("video/mpegts", systemstream=True, packetsize=188)


@register_element("mpegtsmux", Rank.SECONDARY)
class MpegTsMux(Aggregator):
    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    _TS_SRC.copy()),
        PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST,
                    _MUX_SINK.copy()),
    ]

    program_number = Property(int, default=1, minimum=1,
                              mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._pids: dict[str, int] = {}
        self._types: dict[str, tuple[int, int]] = {}
        self._cc: dict[int, int] = {}
        self._pcr_pid: int | None = None
        self._tables: bytes | None = None

    def negotiate_src_caps(self) -> Caps:
        return _TS_SRC.copy()

    def _setup(self) -> bool:
        pads = self.agg_sink_pads()
        if not pads or any(p.current_caps is None for p in pads):
            return False
        streams = []
        for i, pad in enumerate(sorted(pads, key=lambda p: p.name)):
            name = pad.current_caps[0].name
            pid = 0x100 + i
            self._pids[pad.name] = pid
            self._types[pad.name] = _TS_STREAM_TYPES[name]
            streams.append((_TS_STREAM_TYPES[name][0], pid))
            if self._pcr_pid is None and name.startswith("video/"):
                self._pcr_pid = pid
        if self._pcr_pid is None:
            self._pcr_pid = next(iter(self._pids.values()))
        pmt_pid = 0x020
        pat = build_pat({self.program_number: pmt_pid})
        pmt = build_pmt(self.program_number, self._pcr_pid, streams)
        self._tables = (
            self._packetize(0x0000, b"\x00" + pat, table=True)
            + self._packetize(pmt_pid, b"\x00" + pmt, table=True))
        return True

    def _packetize(self, pid: int, data: bytes, *, table: bool = False,
                   pcr: int | None = None) -> bytes:
        out = b""
        first = True
        while data or first:
            chunk_max = 184 - (8 if pcr is not None and first else 0)
            chunk, data = data[:chunk_max], data[chunk_max:]
            cc = self._cc.get(pid, 0)
            out += build_ts_packet(pid, payload=chunk, pusi=first,
                                   cc=cc,
                                   pcr=pcr if first else None)
            self._cc[pid] = (cc + 1) & 0x0F
            first = False
        return out

    def aggregate(self, timeout: bool) -> FlowReturn:
        if self._tables is None and not self._setup():
            return FlowReturn.OK
        for pad in self.agg_sink_pads():
            while True:
                buf = pad.pop_buffer()
                if buf is None:
                    break
                pid = self._pids[pad.name]
                _stype, stream_id = self._types[pad.name]
                pts = buf.pts or 0
                pts90k = pts * 90000 // SECOND + 63000  # decode delay
                pes = build_pes(stream_id, buf.to_bytes(), pts90k)
                key = not buf.has_flag(BufferFlags.DELTA_UNIT)
                out = b""
                if key and pid == self._pcr_pid:
                    out += self._tables       # tables at every keyframe
                pcr = (pts90k - 9000) * 300 if pid == self._pcr_pid \
                    else None
                out += self._packetize(pid, pes, pcr=max(0, pcr)
                                       if pcr is not None else None)
                ob = Buffer(out, pts=buf.pts, duration=buf.duration)
                if not key:
                    ob.set_flag(BufferFlags.DELTA_UNIT)
                ret = self.srcpad.push(ob)
                if ret is not FlowReturn.OK:
                    return ret
        return FlowReturn.OK


@register_element("hlssink3", Rank.NONE)
class HlsSink3(BaseSink):
    """Keyframe-aligned .ts segment writer + media playlist
    (reference net/hlssink3/src/hlssink3/imp.rs)."""

    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS, _TS_SRC.copy())]

    location = Property(str, default="segment%05d.ts",
                        mutable=Mutability.READY)
    playlist_location = Property(str, default="playlist.m3u8",
                                 mutable=Mutability.READY)
    target_duration = Property(int, default=15, minimum=1,
                               mutable=Mutability.READY)
    playlist_length = Property(int, default=5, minimum=0,
                               mutable=Mutability.READY)
    max_files = Property(int, default=10, minimum=0,
                         mutable=Mutability.READY)
    i_frames_only = Property(
        bool, default=False, mutable=Mutability.READY,
        blurb="Every buffer starts a segment of exactly one "
              "keyframe and the playlist is tagged "
              "EXT-X-I-FRAMES-ONLY (reference i-frames-only)")
    send_keyframe_requests = Property(
        bool, default=True, mutable=Mutability.READY,
        blurb="Send an upstream GstForceKeyUnit event when a "
              "segment boundary is due (reference "
              "send-keyframe-requests)")

    def __init__(self, name=None):
        super().__init__(name)
        self._acc = b""
        self._seg_start_pts: int | None = None
        self._last_pts: int | None = None
        self._seg_index = 0
        self._media_sequence = 0
        self._segments: list[tuple[str, float]] = []

    def _seg_name(self) -> str:
        if "%" in self.location:
            return self.location % self._seg_index
        return f"{self.location}{self._seg_index}"

    def _close_segment(self) -> None:
        if not self._acc:
            return
        name = self._seg_name()
        with open(name, "wb") as f:
            f.write(self._acc)
        dur = ((self._last_pts or 0) - (self._seg_start_pts or 0)) \
            / SECOND or float(self.target_duration)
        self._segments.append((name, max(dur, 0.001)))
        self._seg_index += 1
        self._acc = b""
        self._seg_start_pts = None
        if self.playlist_length and \
                len(self._segments) > self.playlist_length:
            old, _ = self._segments.pop(0)
            self._media_sequence += 1
            if self.max_files and \
                    self._seg_index - self._media_sequence \
                    < self.max_files:
                try:
                    os.unlink(old)
                except OSError:
                    pass
        self._write_playlist(ended=False)

    def render(self, buf: Buffer):
        pts = buf.pts
        key = not buf.has_flag(BufferFlags.DELTA_UNIT)
        if self.i_frames_only:
            if not key:
                return FlowReturn.OK        # i-frames-only drops deltas
            if self._acc:
                self._close_segment()
        elif (key and self._acc and pts is not None
                and self._seg_start_pts is not None
                and pts - self._seg_start_pts
                >= self.target_duration * SECOND):
            self._close_segment()
        elif (self.send_keyframe_requests and not key
                and pts is not None
                and self._seg_start_pts is not None
                and pts - self._seg_start_pts
                >= self.target_duration * SECOND):
            # boundary due but no keyframe yet: ask upstream
            from gstpu_torch.core.event import CustomEvent
            self.sinkpad.push_event(CustomEvent(
                {"name": "GstForceKeyUnit", "all-headers": True}))
        if self._seg_start_pts is None and pts is not None:
            self._seg_start_pts = pts
        if pts is not None:
            self._last_pts = pts + (buf.duration or 0)
        self._acc += buf.to_bytes()
        return FlowReturn.OK

    def _write_playlist(self, ended: bool) -> None:
        lines = ["#EXTM3U", "#EXT-X-VERSION:3",
                 *(["#EXT-X-I-FRAMES-ONLY"]
                   if self.i_frames_only else []),
                 f"#EXT-X-TARGETDURATION:{self.target_duration}",
                 f"#EXT-X-MEDIA-SEQUENCE:{self._media_sequence}"]
        for name, dur in self._segments:
            lines.append(f"#EXTINF:{dur:.3f},")
            lines.append(os.path.basename(name))
        if ended:
            lines.append("#EXT-X-ENDLIST")
        with open(self.playlist_location, "w") as f:
            f.write("\n".join(lines) + "\n")

    def on_eos(self) -> None:
        self._close_segment()
        self._write_playlist(ended=True)
