"""claxondec: FLAC audio decoder element
(reference audio/claxon/src/claxondec/imp.rs, AudioDecoder subclass:
STREAMINFO from caps/stream, per-frame decode, width handling).

The port's copy of gstpu/elements/audio/claxon.py, as it stands."""

from __future__ import annotations

import numpy as np

from gstpu_torch.core.audio import AudioInfo
from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.event import CapsEvent
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.codecs.flac import FlacStreamDecoder

SECOND = 1_000_000_000


@register_element("claxondec", Rank.PRIMARY)
class ClaxonDec(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("audio/x-flac")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.from_string("audio/x-raw, format={S16LE,S32LE}, "
                                     "rate=[1,655350], channels=[1,8], "
                                     "layout=interleaved")),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._dec = FlacStreamDecoder()
        self._out_info: AudioInfo | None = None
        self._sample_pos = 0

    def _negotiate(self, incaps):
        self.in_caps = incaps
        return True

    def _ensure_out_caps(self, frame) -> AudioInfo:
        fmt = "S32LE" if frame.bits_per_sample > 16 else "S16LE"
        info = AudioInfo(fmt, frame.sample_rate,
                         frame.samples.shape[1])
        if self._out_info is None or info != self._out_info:
            self._out_info = info
            self.out_caps = info.to_caps()
            self.srcpad.push_event(CapsEvent(self.out_caps))
        return info

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        try:
            self._dec.push(buf.to_bytes())
        except ValueError as e:
            self.post_error(f"claxondec: {e}")
            raise FlowError(FlowReturn.ERROR)
        out = []
        while True:
            try:
                frame = self._dec.poll()
            except ValueError as e:
                self.post_error(f"claxondec: {e}")
                raise FlowError(FlowReturn.ERROR)
            if frame is None:
                break
            info = self._ensure_out_caps(frame)
            samples = frame.samples
            # widen to container width (claxon imp.rs sample widening)
            if info.format == "S16LE":
                data = samples.astype(np.int16)
            else:
                data = samples.astype(np.int32)
            pts = self._sample_pos * SECOND // frame.sample_rate
            self._sample_pos += samples.shape[0]
            out.append(info.make_buffer(data, pts=pts))
        return out or None

    def flush(self) -> None:
        self._dec = FlacStreamDecoder()
        self._sample_pos = 0
