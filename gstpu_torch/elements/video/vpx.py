"""vp8enc / vp9enc / vp8dec / vp9dec: VPx codec elements over the
in-image libvpx (through the native codec shim's libavcodec engines).

The reference's webrtcsink codec registry names VP8/VP9 as its
canonical WebRTC video codecs (net/webrtc/src/webrtcsink/imp.rs:
106-346) and leans on the ecosystem vpx elements to produce them;
these elements fill that slot for gstpu with the reference-style
property surface (target-bitrate, end-usage, cpu-used, deadline,
keyframe-max-dist, error-resilient, min/max quantizer).

The port's copy of gstpu/elements/video/vpx.py, as it stands: the
port's codec shim, on the host.
"""

from __future__ import annotations

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.video import VideoInfo, video_caps
from gstpu_torch.elements.video.av1 import _AvDecoderBase


class _VpxEnc(BaseTransform):
    """Shared VPx encode loop (I420 frames in, packets out)."""

    ENGINE = ""            # libavcodec encoder name
    MEDIA = ""             # output caps name

    target_bitrate = Property(int, default=256000, minimum=0,
                              mutable=Mutability.PLAYING,
                              blurb="Target bitrate (bps); 0 = "
                                    "constant-quality mode")
    end_usage = Property(str, default="vbr", mutable=Mutability.READY,
                         blurb="vbr|cbr|cq rate-control mode")
    cpu_used = Property(int, default=0, minimum=-16, maximum=16,
                        mutable=Mutability.READY)
    deadline = Property(int, default=1, minimum=0,
                        mutable=Mutability.READY,
                        blurb="Encode deadline: 0 = best quality, "
                              "1 = realtime, else good (usec budget "
                              "semantics of the vpx API)")
    keyframe_max_dist = Property(int, default=128, minimum=1,
                                 mutable=Mutability.READY)
    error_resilient = Property(bool, default=False,
                               mutable=Mutability.READY)
    min_quantizer = Property(int, default=4, minimum=0, maximum=63,
                             mutable=Mutability.READY)
    max_quantizer = Property(int, default=63, minimum=0, maximum=63,
                             mutable=Mutability.READY)
    cq_level = Property(int, default=25, minimum=0, maximum=63,
                        mutable=Mutability.READY,
                        blurb="Constant-quality level (crf) used when "
                              "target-bitrate is 0 or end-usage=cq")
    threads = Property(int, default=0, minimum=0, maximum=64,
                       mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._enc = None
        self._info: VideoInfo | None = None
        self._frame_n = 0

    def transform_caps(self, direction, caps, filter):
        if direction is PadDirection.SINK:
            out = Caps.new(self.MEDIA)
            for s in caps:
                for k in ("width", "height", "framerate"):
                    if k in s:
                        out[0][k] = s[k]
        else:
            out = self.sinkpad.pad_template_caps().copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def _open(self) -> bool:
        from gstpu_torch.native_codec import NativeEncoder
        info = self._info
        fr = info.framerate
        fps = ((fr.numerator, fr.denominator)
               if fr and fr.numerator else (30, 1))
        opts = {
            "deadline": {0: "best", 1: "realtime"}.get(
                self.deadline, "good"),
            "cpu-used": self.cpu_used,
            "g": self.keyframe_max_dist,
            "qmin": self.min_quantizer,
            "qmax": self.max_quantizer,
            "threads": self.threads or 1,
        }
        if self.target_bitrate > 0 and self.end_usage != "cq":
            opts["b"] = self.target_bitrate
            if self.end_usage == "cbr":
                opts["minrate"] = self.target_bitrate
                opts["maxrate"] = self.target_bitrate
        else:
            opts["crf"] = self.cq_level
            opts["b"] = 0
        if self.error_resilient:
            opts["error-resilient"] = "+default"
        try:
            self._enc = NativeEncoder(self.ENGINE, info.width,
                                      info.height, fps, opts)
        except RuntimeError as e:
            self.post_error(f"{self.name}: {e}")
            return False
        return True

    def set_caps(self, incaps, outcaps) -> bool:
        self._info = VideoInfo.from_caps(incaps)
        self._frame_n = 0
        return self._open()

    def reconfigure_bitrate(self, bps: int) -> list[Buffer]:
        """Unified live-bitrate hook (reference VideoEncoder wrapper,
        webrtcsink/imp.rs:1368-1405 sets vpx target-bitrate at
        runtime): drain the engine and reopen at the new rate; the
        next frame starts at a fresh keyframe."""
        self.target_bitrate = bps
        if self._enc is None or self._info is None:
            return []
        out = self._emit(self._enc.finish())
        self._enc.close()
        self._enc = None
        if not self._open():
            return out
        return out

    def _emit(self, pkts) -> list[Buffer]:
        info = self._info
        out = []
        for data, pts_n, key in pkts:
            pts = (pts_n * info.frame_duration
                   if info.frame_duration else None)
            b = Buffer(data, pts=pts, duration=info.frame_duration)
            if not key:
                b.set_flag(BufferFlags.DELTA_UNIT)
            out.append(b)
        return out

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        if self._enc is None:       # live reopen failed; error posted
            return None
        pkts = self._enc.send(buf.to_bytes(), self._frame_n)
        self._frame_n += 1
        return self._emit(pkts) or None

    def drain(self) -> list[Buffer]:
        if self._enc is None:
            return []
        return self._emit(self._enc.finish())

    def stop(self) -> bool:
        if self._enc is not None:
            self._enc.close()
            self._enc = None
        return True


@register_element("vp8enc", Rank.PRIMARY)
class Vp8Enc(_VpxEnc):
    """VP8 encoder over libvpx."""

    ENGINE = "libvpx"
    MEDIA = "video/x-vp8"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("I420",))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("video/x-vp8")),
    ]


@register_element("vp9enc", Rank.PRIMARY)
class Vp9Enc(_VpxEnc):
    """VP9 encoder over libvpx."""

    ENGINE = "libvpx-vp9"
    MEDIA = "video/x-vp9"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("I420",))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("video/x-vp9")),
    ]


@register_element("vp8dec", Rank.PRIMARY)
class Vp8Dec(_AvDecoderBase):
    """VP8 decoder (libavcodec native vp8 engine)."""

    CODEC = "vp8"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("video/x-vp8")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("I420",))),
    ]


@register_element("vp9dec", Rank.PRIMARY)
class Vp9Dec(_AvDecoderBase):
    """VP9 decoder (libavcodec native vp9 engine)."""

    CODEC = "vp9"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("video/x-vp9")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("I420",))),
    ]
