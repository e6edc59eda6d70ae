"""hlscmafsink: HLS segmenter/playlist writer for CMAF fragments.

Rebuilds the reference hlssink3 crate's CMAF path
(net/hlssink3 hlscmafsink): the HEADER buffer from cmafmux becomes the
init segment (#EXT-X-MAP), every following fragment becomes a .m4s
segment file, and the media playlist is rewritten per segment with a
sliding window (playlist-length) like the m3u8-rs-based writer.

The port's copy of gstpu/elements/net/hls.py, as it stands.
"""

from __future__ import annotations

import os

from gstpu_torch.core.base import BaseSink
from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowReturn, Message,
                                      MessageType, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.event import EosEvent
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000


@register_element("hlscmafsink", Rank.NONE)
class HlsCmafSink(BaseSink):
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS,
                                 Caps.new("video/quicktime"))]

    location = Property(str, default="segment%05d.m4s",
                        mutable=Mutability.READY,
                        blurb="Segment filename template")
    init_location = Property(str, default="init.mp4",
                             mutable=Mutability.READY)
    playlist_location = Property(str, default="playlist.m3u8",
                                 mutable=Mutability.READY)
    target_duration = Property(int, default=6, minimum=1,
                               mutable=Mutability.READY,
                               blurb="EXT-X-TARGETDURATION (s)")
    playlist_length = Property(int, default=0, minimum=0,
                               mutable=Mutability.READY,
                               blurb="Sliding window size (0 = all)")
    i_frames_only = Property(
        bool, default=False, mutable=Mutability.READY,
        blurb="Each segment is a single keyframe: tag the playlist "
              "EXT-X-I-FRAMES-ONLY (reference i-frames-only)")
    send_keyframe_requests = Property(
        bool, default=True, mutable=Mutability.READY,
        blurb="Send upstream force-keyframe events at segment "
              "boundaries so the encoder aligns (reference "
              "send-keyframe-requests)")

    def __init__(self, name=None):
        super().__init__(name)
        self._segments: list[tuple[str, float]] = []
        self._seg_index = 0
        self._media_sequence = 0
        self._have_init = False
        self._pending: list[bytes] = []
        self._pending_pts: int | None = None
        self._last_pts: int | None = None

    # -- storage hooks (awss3hlssink overrides; default = local fs) ----
    def _store(self, path: str, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)

    def _delete(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def render(self, buf: Buffer):
        data = buf.to_bytes()
        if buf.has_flag(BufferFlags.HEADER) and not self._have_init:
            self._store(self.init_location, data)
            self._have_init = True
            return FlowReturn.OK
        # each fragment buffer becomes one segment
        dur = (buf.duration / SECOND) if buf.duration \
            else float(self.target_duration)
        name = self.location % self._seg_index \
            if "%" in self.location else f"{self.location}{self._seg_index}"
        self._store(name, data)
        self._seg_index += 1
        self._segments.append((name, dur))
        if self.playlist_length and \
                len(self._segments) > self.playlist_length:
            old, _ = self._segments.pop(0)
            self._media_sequence += 1
            self._delete(old)
        self._write_playlist(ended=False)
        if self.send_keyframe_requests:
            # ask the encoder for a keyframe at the next boundary
            # (the reference forwards GstForceKeyUnit upstream)
            from gstpu_torch.core.event import CustomEvent
            self.sinkpad.push_event(CustomEvent(
                {"name": "GstForceKeyUnit", "all-headers": True}))
        return FlowReturn.OK

    def _write_playlist(self, ended: bool) -> None:
        lines = ["#EXTM3U", "#EXT-X-VERSION:7",
                 f"#EXT-X-TARGETDURATION:{self.target_duration}",
                 f"#EXT-X-MEDIA-SEQUENCE:{self._media_sequence}",
                 *(["#EXT-X-I-FRAMES-ONLY"]
                   if self.i_frames_only else []),
                 f'#EXT-X-MAP:URI="{os.path.basename(self.init_location)}"']
        for name, dur in self._segments:
            lines.append(f"#EXTINF:{dur:.3f},")
            lines.append(os.path.basename(name))
        if ended:
            lines.append("#EXT-X-ENDLIST")
        self._store(self.playlist_location,
                    ("\n".join(lines) + "\n").encode())

    def on_eos(self) -> None:
        self._write_playlist(ended=True)


@register_element("hlsmultivariantsink", Rank.NONE)
class HlsMultivariantSink(Element):
    """Multivariant (master) HLS playlist sink.

    Rebuilds the reference net/hlsmultivariantsink (imp.rs): each
    request pad is configured with either a *variant* (uri, bandwidth,
    codecs, is-i-frame -> EXT-X-STREAM-INF / EXT-X-I-FRAME-STREAM-INF)
    or an *alternate rendition* (media_type, uri, group_id, name,
    language, default, autoselect, forced -> EXT-X-MEDIA).  Each pad
    feeds an internal hlscmafsink that writes that rendition's media
    playlist + segments; this element owns only the multivariant
    playlist.  Non-muxed renditions only, like the reference
    (imp.rs:166 keeps rendition URIs required for the same reason).
    """

    PAD_TEMPLATES = [PadTemplate("sink_%u", PadDirection.SINK,
                                 PadPresence.REQUEST,
                                 Caps.new("video/quicktime"))]

    playlist_location = Property(str, default="multivariant.m3u8",
                                 mutable=Mutability.READY,
                                 blurb="Multivariant playlist path")
    target_duration = Property(int, default=6, minimum=1,
                               mutable=Mutability.READY)
    playlist_length = Property(int, default=0, minimum=0,
                               mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._pads: dict[str, dict] = {}     # pad name -> settings
        self._children: dict[str, HlsCmafSink] = {}
        self._eos: set[str] = set()
        self._wrote_master = False

    # -- pad configuration --------------------------------------------
    def request_pad_with_settings(self, *, variant: dict | None = None,
                                  rendition: dict | None = None):
        pad = self.request_pad()
        self.configure_pad(pad, variant=variant, rendition=rendition)
        return pad

    def configure_pad(self, pad, *, variant: dict | None = None,
                      rendition: dict | None = None) -> None:
        if (variant is None) == (rendition is None):
            raise ValueError("pad needs exactly one of variant= / "
                             "rendition=")
        settings = dict(variant) if variant else dict(rendition)
        settings["_kind"] = "variant" if variant else "rendition"
        if "uri" not in settings:
            raise ValueError("uri is required")
        if variant and "bandwidth" not in settings:
            raise ValueError("variant requires bandwidth")
        if rendition:
            for k in ("group_id", "name"):
                if k not in settings:
                    raise ValueError(f"rendition requires {k}")
        self._pads[pad.name] = settings
        child = HlsCmafSink(f"{self.name}-{pad.name}")
        root = os.path.dirname(self.playlist_location)
        uri = settings["uri"]
        stem = os.path.splitext(uri)[0]
        child.set_property("playlist_location", os.path.join(root, uri))
        child.set_property("init_location",
                           os.path.join(root, f"{stem}_init.mp4"))
        child.set_property("location",
                           os.path.join(root, f"{stem}_%05d.m4s"))
        child.set_property("target_duration", self.target_duration)
        child.set_property("playlist_length", self.playlist_length)
        self._children[pad.name] = child

    def new_request_pad(self, pad) -> None:
        pad.chain_function = self._chain
        pad.event_function = self._event

    # -- dataflow ------------------------------------------------------
    def _require_config(self, pad) -> HlsCmafSink:
        child = self._children.get(pad.name)
        if child is None:
            raise RuntimeError(f"{self.name}.{pad.name}: pad not "
                               "configured (call configure_pad first)")
        return child

    def _chain(self, pad, buf) -> FlowReturn:
        child = self._require_config(pad)
        if not self._wrote_master:
            self._write_master()
        return child.render(buf)

    def _event(self, pad, ev) -> bool:
        if isinstance(ev, EosEvent):
            child = self._require_config(pad)
            child.on_eos()
            self._eos.add(pad.name)
            if self._eos >= set(self._children):
                self.post_message(Message(MessageType.EOS, self))
        return True

    # -- multivariant playlist ------------------------------------------
    @staticmethod
    def _yn(v: bool) -> str:
        return "YES" if v else "NO"

    def _write_master(self) -> None:
        lines = ["#EXTM3U", "#EXT-X-VERSION:6"]
        audio_groups: list[str] = []
        for s in self._pads.values():
            if s["_kind"] != "rendition":
                continue
            mtype = str(s.get("media_type", "audio")).upper()
            if mtype == "AUDIO" and s["group_id"] not in audio_groups:
                audio_groups.append(s["group_id"])
            attrs = [f"TYPE={mtype}", f'GROUP-ID="{s["group_id"]}"',
                     f'NAME="{s["name"]}"']
            if s.get("language"):
                attrs.append(f'LANGUAGE="{s["language"]}"')
            attrs.append(f"DEFAULT={self._yn(s.get('default', False))}")
            attrs.append(
                f"AUTOSELECT={self._yn(s.get('autoselect', False))}")
            if s.get("forced"):
                attrs.append("FORCED=YES")
            attrs.append(f'URI="{s["uri"]}"')
            lines.append("#EXT-X-MEDIA:" + ",".join(attrs))
        for s in self._pads.values():
            if s["_kind"] != "variant":
                continue
            attrs = [f"BANDWIDTH={int(s['bandwidth'])}"]
            if s.get("codecs"):
                attrs.append(f'CODECS="{s["codecs"]}"')
            if s.get("is_i_frame"):
                attrs.append(f'URI="{s["uri"]}"')
                lines.append("#EXT-X-I-FRAME-STREAM-INF:"
                             + ",".join(attrs))
            else:
                if audio_groups:
                    attrs.append(f'AUDIO="{s.get("audio", audio_groups[0])}"')
                lines.append("#EXT-X-STREAM-INF:" + ",".join(attrs))
                lines.append(s["uri"])
        with open(self.playlist_location, "w") as f:
            f.write("\n".join(lines) + "\n")
        self._wrote_master = True


@register_element("hlswebvttsink", Rank.NONE)
class HlsWebVttSink(BaseSink):
    """WebVTT subtitle segments + media playlist for HLS (reference
    net/hlssink3/src/hlswebvttsink: each segment is a standalone
    WEBVTT document with an X-TIMESTAMP-MAP header; cues land in the
    segment containing their start time)."""

    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS,
                                 Caps.new("text/vtt"))]

    location = Property(str, default="segment%05d.vtt",
                        mutable=Mutability.READY)
    playlist_location = Property(str, default="subtitles.m3u8",
                                 mutable=Mutability.READY)
    target_duration = Property(int, default=6, minimum=1,
                               mutable=Mutability.READY)
    playlist_length = Property(int, default=0, minimum=0,
                               mutable=Mutability.READY)
    write_timestamp_map = Property(bool, default=True,
                                   mutable=Mutability.READY)
    # 90kHz offset for the MPEGTS side of X-TIMESTAMP-MAP (reference
    # default: one hour)
    mpegts_time_offset = Property(int, default=60 * 60 * 90000,
                                  minimum=0, mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._cues: list[str] = []
        self._seg_start: int | None = None
        self._seg_index = 0
        self._media_sequence = 0
        self._segments: list[tuple[str, float]] = []

    def _store(self, path: str, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)

    def _header(self) -> str:
        hdr = "WEBVTT"
        if self.write_timestamp_map:
            off = self.mpegts_time_offset
            hdr += (f"\nX-TIMESTAMP-MAP=MPEGTS:{off},"
                    "LOCAL:00:00:00.000")
        return hdr + "\n\n"

    def _close_segment(self, end_pts: int) -> None:
        if self._seg_start is None:
            return
        name = self.location % self._seg_index \
            if "%" in self.location else f"{self.location}" \
            f"{self._seg_index}"
        with open(name, "w") as f:
            f.write(self._header() + "".join(self._cues))
        dur = max((end_pts - self._seg_start) / SECOND, 0.001)
        self._segments.append((name, dur))
        self._seg_index += 1
        self._cues = []
        self._seg_start = None
        if self.playlist_length and \
                len(self._segments) > self.playlist_length:
            old, _ = self._segments.pop(0)
            self._media_sequence += 1
            try:
                os.unlink(old)
            except OSError:
                pass
        self._write_playlist(ended=False)

    def render(self, buf: Buffer):
        text = buf.to_bytes().decode()
        if text.startswith("WEBVTT"):
            return FlowReturn.OK          # header handled per segment
        pts = buf.pts or 0
        if self._seg_start is not None and \
                pts - self._seg_start >= self.target_duration * SECOND:
            self._close_segment(pts)
        if self._seg_start is None:
            self._seg_start = pts
        self._cues.append(text)
        return FlowReturn.OK

    def _write_playlist(self, ended: bool) -> None:
        lines = ["#EXTM3U", "#EXT-X-VERSION:3",
                 f"#EXT-X-TARGETDURATION:{self.target_duration}",
                 f"#EXT-X-MEDIA-SEQUENCE:{self._media_sequence}"]
        for name, dur in self._segments:
            lines.append(f"#EXTINF:{dur:.3f},")
            lines.append(os.path.basename(name))
        if ended:
            lines.append("#EXT-X-ENDLIST")
        self._store(self.playlist_location,
                    ("\n".join(lines) + "\n").encode())

    def on_eos(self) -> None:
        if self._cues:
            last = self._seg_start or 0
            self._close_segment(last + self.target_duration * SECOND)
        self._write_playlist(ended=True)
