"""opusenc / opusdec: Opus audio codec elements over the in-image
libopus (through the native codec shim, native/gstpu_codec.cpp).

The reference's webrtcsink leans on the ecosystem opusenc element as
its canonical audio codec (net/webrtc/src/webrtcsink/imp.rs:106-346
codec registry names OPUS first); these elements fill that role for
gstpu with the reference-style property surface (bitrate, audio-type,
frame-size, inband-fec, packet-loss-percentage, dtx, complexity).

Samples cross the shim as interleaved f32; input re-blocking to the
engine's frame size uses the adapter pattern (SURVEY.md §5.7).

The port's copy of gstpu/elements/audio/opus.py, as it stands: the
port's codec shim, on the host.
"""

from __future__ import annotations

import numpy as np

from gstpu_torch.core.audio import AudioInfo, audio_caps
from gstpu_torch.core.base import AudioDecoder, BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, IntRange, Structure
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000
OPUS_RATES = (48000, 24000, 16000, 12000, 8000)


def _opus_caps() -> Caps:
    return Caps([Structure("audio/x-opus",
                           rate=AnyList(OPUS_RATES),
                           channels=IntRange(1, 8))])


@register_element("opusenc", Rank.PRIMARY)
class OpusEnc(BaseTransform):
    """Opus encoder (fills the ecosystem opusenc slot the reference's
    webrtcsink codec registry expects)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    audio_caps(formats=("F32LE", "S16LE"),
                               rate=AnyList(OPUS_RATES),
                               channels=IntRange(1, 8))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    _opus_caps()),
    ]

    bitrate = Property(int, default=64000, minimum=4000, maximum=650000,
                       mutable=Mutability.PLAYING,
                       blurb="Target bitrate (bps)")
    audio_type = Property(str, default="generic",
                          mutable=Mutability.READY,
                          blurb="generic|voice (maps to the engine's "
                                "audio/voip application)")
    frame_size = Property(int, default=20, mutable=Mutability.READY,
                          blurb="Frame duration ms (2=2.5, 5, 10, 20, "
                                "40, 60)")
    complexity = Property(int, default=10, minimum=0, maximum=10,
                          mutable=Mutability.READY)
    inband_fec = Property(bool, default=False,
                          mutable=Mutability.PLAYING)
    packet_loss_percentage = Property(int, default=0, minimum=0,
                                      maximum=100,
                                      mutable=Mutability.PLAYING)
    dtx = Property(bool, default=False, mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._enc = None
        self._info: AudioInfo | None = None
        self._tail = np.zeros((0, 1), np.float32)
        self._sample_pos = 0
        self._base_pts = None

    def transform_caps(self, direction, caps, filter):
        if caps.is_any():
            out = (self.srcpad if direction is PadDirection.SINK
                   else self.sinkpad).pad_template_caps().copy()
        else:
            structs = []
            for s in caps:
                if direction is PadDirection.SINK:
                    st = Structure("audio/x-opus")
                else:
                    st = Structure("audio/x-raw",
                                   format=AnyList(("F32LE", "S16LE")),
                                   layout="interleaved")
                for k in ("rate", "channels"):
                    if k in s:
                        st[k] = s[k]
                structs.append(st)
            out = Caps(structs)
        if filter is not None:
            out = filter.intersect(out)
        return out

    def _open(self) -> bool:
        from gstpu_torch.native_codec import NativeAudioEncoder
        self._enc = None
        info = self._info
        opts = {
            "application": ("voip" if self.audio_type == "voice"
                            else "audio"),
            "frame_duration": 2.5 if self.frame_size == 2
            else float(self.frame_size),
            "fec": int(self.inband_fec),
            "packet_loss": self.packet_loss_percentage,
            "compression_level": self.complexity,
        }
        if self.dtx:
            opts["dtx"] = 1
        try:
            self._enc = NativeAudioEncoder("libopus", info.rate,
                                           info.channels,
                                           bitrate=self.bitrate,
                                           opts=opts)
        except RuntimeError as e:
            self.post_error(f"opusenc: {e}")
            return False
        return True

    def set_caps(self, incaps, outcaps) -> bool:
        self._info = AudioInfo.from_caps(incaps)
        self._tail = np.zeros((0, self._info.channels), np.float32)
        self._sample_pos = 0
        self._base_pts = None
        if not self._open():
            return False
        # fix the src caps to the negotiated stream parameters
        self.out_caps = Caps.new("audio/x-opus", rate=self._info.rate,
                                 channels=self._info.channels,
                                 channel_mapping_family=0)
        return True

    def reconfigure_bitrate(self, bps: int) -> list[Buffer]:
        """Unified live-bitrate hook (webrtcsink congestion control);
        drains the engine and reopens it at the new rate."""
        self.bitrate = max(4000, min(650000, bps))
        if self._enc is None:
            return []
        out = self._flush_engine()
        self._enc.close()
        self._enc = None
        self._open()                # error posted on failure
        return out

    def _to_f32(self, buf: Buffer) -> np.ndarray:
        info = self._info
        if info.format == "S16LE":
            arr = (np.frombuffer(buf.to_bytes(), "<i2")
                   .astype(np.float32) / 32768.0)
        else:
            arr = np.frombuffer(buf.to_bytes(), "<f4").astype(np.float32)
        return arr.reshape(-1, info.channels)

    def _emit(self, pkts) -> list[Buffer]:
        info = self._info
        out = []
        for data, pts_s, dur_s in pkts:
            pts = None
            base = self._base_pts or 0
            if pts_s >= 0:
                pts = base + pts_s * SECOND // info.rate
            dur = dur_s * SECOND // info.rate if dur_s > 0 else None
            out.append(Buffer(data, pts=pts, duration=dur))
        return out

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        if self._enc is None:       # live reopen failed; error posted
            return None
        if self._base_pts is None and buf.pts is not None:
            self._base_pts = buf.pts
        samples = np.concatenate([self._tail, self._to_f32(buf)])
        fs = self._enc.frame_size or len(samples)
        pkts = []
        pos = 0
        while len(samples) - pos >= fs:
            pkts += self._enc.send(samples[pos:pos + fs],
                                   self._sample_pos)
            self._sample_pos += fs
            pos += fs
        self._tail = samples[pos:]
        return self._emit(pkts) or None

    def _flush_engine(self) -> list[Buffer]:
        pkts = []
        if len(self._tail):
            # pad the tail to a full engine frame with silence
            fs = self._enc.frame_size or len(self._tail)
            pad = np.zeros((fs - len(self._tail),
                            self._info.channels), np.float32)
            pkts += self._enc.send(np.concatenate([self._tail, pad]),
                                   self._sample_pos)
            self._sample_pos += fs
            self._tail = self._tail[:0]
        pkts += self._enc.finish()
        return self._emit(pkts)

    def drain(self) -> list[Buffer]:
        if self._enc is None:
            return []
        return self._flush_engine()

    def stop(self) -> bool:
        if self._enc is not None:
            self._enc.close()
            self._enc = None
        return True


@register_element("opusdec", Rank.PRIMARY)
class OpusDec(AudioDecoder):
    """Opus decoder over libopus (ecosystem opusdec slot)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    _opus_caps()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    audio_caps(formats=("F32LE",),
                               rate=AnyList(OPUS_RATES))),
    ]

    plc = Property(bool, default=False, mutable=Mutability.PLAYING,
                   blurb="Packet-loss concealment on gaps")
    use_inband_fec = Property(bool, default=False,
                              mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._dec = None
        self._rate = 48000
        self._channels = 2

    def set_format(self, caps) -> bool:
        from gstpu_torch.native_codec import NativeAudioDecoder
        s = caps[0]
        self._rate = int(s.get("rate", 48000) or 48000)
        if self._rate not in OPUS_RATES:
            self._rate = 48000
        self._channels = int(s.get("channels", 2) or 2)
        try:
            self._dec = NativeAudioDecoder("libopus", self._rate,
                                           self._channels)
        except RuntimeError as e:
            self.post_error(f"opusdec: {e}")
            return False
        return True

    def handle_frame(self, buf: Buffer) -> None:
        if self._dec is None:
            return
        pts_s = -1
        if buf.pts is not None:
            pts_s = buf.pts * self._rate // SECOND
        for samples, rate, pts in self._dec.send(buf.to_bytes(), pts_s):
            if self.output_info is None or \
                    self.output_info.rate != rate or \
                    self.output_info.channels != samples.shape[1]:
                self.set_output_format(
                    AudioInfo("F32LE", rate, samples.shape[1]))
            out_pts = pts * SECOND // rate if pts >= 0 else None
            self.finish_frame(samples.reshape(-1), pts=out_pts)

    def drain(self) -> list[Buffer]:
        if self._dec is None:
            return []
        self._pending_out = []
        for samples, rate, pts in self._dec.finish():
            if self.output_info is None:
                self.set_output_format(
                    AudioInfo("F32LE", rate, samples.shape[1]))
            self.finish_frame(samples.reshape(-1))
        out, self._pending_out = self._pending_out, []
        return out

    def stop(self) -> bool:
        if self._dec is not None:
            self._dec.close()
            self._dec = None
        return True
