"""rsflvdemux: FLV demuxer element
(reference mux/flavors/src/flvdemux/imp.rs, push mode).

The port's copy of gstpu/elements/mux/flvdemux.py, as it stands."""

from __future__ import annotations

from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowReturn, Pad, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.event import (CapsEvent, EosEvent, Event, Segment,
                                    SegmentEvent, StreamStartEvent)
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.mux.flv import (AUDIO_FORMATS, TAG_AUDIO, TAG_SCRIPT,
                                 TAG_VIDEO, VIDEO_CODECS, FlvParser, FlvTag)

MSECOND = 1_000_000


@register_element("rsflvdemux", Rank.PRIMARY)
class FlvDemux(Element):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("video/x-flv")),
        PadTemplate("audio", PadDirection.SRC, PadPresence.SOMETIMES,
                    Caps.any()),
        PadTemplate("video", PadDirection.SRC, PadPresence.SOMETIMES,
                    Caps.any()),
    ]

    SIGNALS = ("pad-added",)

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._parser = FlvParser()
        self._audio_pad: Pad | None = None
        self._video_pad: Pad | None = None
        self._avc_codec_data: bytes | None = None

    def _ensure_pad(self, kind: str, caps: Caps) -> Pad:
        existing = self._audio_pad if kind == "audio" else self._video_pad
        if existing is not None:
            return existing
        tmpl = next(t for t in self.PAD_TEMPLATES
                    if t.name_template == kind)
        pad = Pad(kind, PadDirection.SRC, tmpl, self)
        self.add_pad(pad)
        if kind == "audio":
            self._audio_pad = pad
        else:
            self._video_pad = pad
        self.emit("pad-added", pad)
        pad.push_event(StreamStartEvent(f"{self.name}/{kind}"))
        pad.push_event(CapsEvent(caps))
        pad.push_event(SegmentEvent(Segment()))
        return pad

    def _audio_caps(self, tag: FlvTag) -> Caps:
        name, _ = AUDIO_FORMATS.get(tag.sound_format,
                                    ("audio/x-flv-unknown", "?"))
        return Caps.new(name, rate=tag.sound_rate,
                        channels=tag.sound_channels)

    def _video_caps(self, tag: FlvTag) -> Caps:
        name = VIDEO_CODECS.get(tag.video_codec, "video/x-flv-unknown")
        if tag.video_codec == 7 and self._avc_codec_data:
            return Caps.new(name, stream_format="avc",
                            codec_data=self._avc_codec_data.hex())
        return Caps.new(name)

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        try:
            self._parser.push(buf.to_bytes())
            while True:
                tag = self._parser.poll()
                if tag is None:
                    break
                ret = self._handle_tag(tag)
                if not ret.is_ok:
                    return ret
        except ValueError as e:
            self.post_error(f"flvdemux: {e}")
            return FlowReturn.ERROR
        return FlowReturn.OK

    def _handle_tag(self, tag: FlvTag) -> FlowReturn:
        if tag.tag_type == TAG_SCRIPT:
            return FlowReturn.OK  # metadata: ignored for now
        if tag.tag_type == TAG_AUDIO:
            if not tag.data:
                return FlowReturn.OK
            pad = self._ensure_pad("audio", self._audio_caps(tag))
            out = Buffer(tag.audio_payload,
                         pts=tag.timestamp_ms * MSECOND)
            return pad.push(out)
        if tag.tag_type == TAG_VIDEO:
            if not tag.data:
                return FlowReturn.OK
            if tag.video_codec == 7 and tag.avc_packet_type == 0:
                # AVC sequence header = codec_data; (re)announce caps
                self._avc_codec_data = tag.video_payload
                if self._video_pad is not None:
                    self._video_pad.push_event(
                        CapsEvent(self._video_caps(tag)))
                return FlowReturn.OK
            pad = self._ensure_pad("video", self._video_caps(tag))
            out = Buffer(tag.video_payload,
                         pts=tag.timestamp_ms * MSECOND)
            if not tag.is_keyframe:
                out.set_flag(BufferFlags.DELTA_UNIT)
            return pad.push(out)
        return FlowReturn.OK

    def _event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, EosEvent):
            ok = True
            for p in (self._audio_pad, self._video_pad):
                if p is not None:
                    ok = p.push_event(EosEvent()) and ok
            return ok
        if isinstance(ev, (CapsEvent, StreamStartEvent, SegmentEvent)):
            return True  # we produce our own on the src pads
        return self.default_pad_event(pad, ev)

    # -- pull-mode scheduling + seeking (reference flvdemux/imp.rs:
    # "pull or push mode") --------------------------------------------

    _PULL_CHUNK = 65536

    pull_mode = True   # prefer pull scheduling when upstream can

    def ready_to_paused(self) -> bool:
        # pad activation (GStreamer activate_mode): claim PULL when
        # upstream serves getrange; the peer's push task stands down
        self._pull_active = bool(self.pull_mode
                                 and self.sinkpad.can_pull)
        if self._pull_active:
            self.sinkpad.peer.pull_mode_active = True
            self._pull_offset = 0
            self._keyframe_index = []     # (ts_ns, byte_offset)
            self._pull_eos = False
            self._parser = FlvParser()
        return True

    def iterate_tasks(self):
        from gstpu_torch.runtime.scheduler import Task
        if getattr(self, "_pull_active", False):
            return (Task(self.name, self._pull_iterate),)
        return ()

    def _pull_iterate(self):
        from gstpu_torch.runtime.scheduler import TaskResult
        if self._pull_eos:
            return TaskResult.EOS
        try:
            data = self.sinkpad.pull_range(self._pull_offset,
                                           self._PULL_CHUNK)
        except Exception as e:
            self.post_error(f"flvdemux: pull failed: {e}")
            return TaskResult.ERROR
        if not data:
            self._pull_eos = True
            for p in (self._audio_pad, self._video_pad):
                if p is not None:
                    p.push_event(EosEvent())
            return TaskResult.EOS
        self._pull_offset += len(data)
        self._parser.push(data)
        try:
            while True:
                before = len(self._parser._buf)
                tag = self._parser.poll()
                if tag is None:
                    break
                consumed = before - len(self._parser._buf)
                tag_off = (self._pull_offset
                           - len(self._parser._buf) - consumed)
                if tag.tag_type == TAG_VIDEO and tag.data \
                        and tag.is_keyframe \
                        and not (tag.video_codec == 7
                                 and tag.avc_packet_type == 0):
                    # codec-config tags are not seek targets
                    self._keyframe_index.append(
                        (tag.timestamp_ms * MSECOND, tag_off))
                ret = self._handle_tag(tag)
                if not ret.is_ok:
                    return TaskResult.ERROR
        except ValueError as e:
            self.post_error(f"flvdemux: {e}")
            return TaskResult.ERROR
        return TaskResult.CONTINUE

    def seek(self, time_ns: int) -> bool:
        """Seek to the keyframe at/before time_ns (pull mode only;
        reference pull-mode flvdemux seeks the same way)."""
        if not self.sinkpad.can_pull:
            return False
        from gstpu_torch.core.event import FlushStartEvent, FlushStopEvent
        target = (0, 0)
        for ts, off in getattr(self, "_keyframe_index", []):
            if ts <= time_ns:
                target = (ts, off)
            else:
                break
        self._pull_offset = target[1]
        if target == (0, 0):
            self._parser = FlvParser()
        else:
            self._parser._buf = bytearray()  # header state survives
        self._pull_eos = False
        seg = Segment()
        seg.start = target[0]
        for p in (self._audio_pad, self._video_pad):
            if p is not None:
                p.push_event(FlushStartEvent())
                p.push_event(FlushStopEvent())
                p.push_event(SegmentEvent(seg))
        return True

