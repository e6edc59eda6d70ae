"""rav1enc / dav1ddec / ffv1dec: the native codec tier.

Rebuilds the reference's heavy codec elements with the SAME
architecture — each wraps a native engine through the codec shim
(native/gstpu_codec.cpp):

* rav1enc  — AV1 encoder around the rav1e engine
  (video/rav1e/src/rav1enc/imp.rs:91-200 property surface: speed
  preset, quantizer, bitrate, key-frame interval, tiles, low latency)
* dav1ddec — AV1 decoder around libdav1d
  (video/dav1d/src/dav1ddec/imp.rs)
* ffv1dec  — FFV1 lossless decoder (video/ffv1/src/ffv1dec/imp.rs)

`ffv1enc` goes beyond the reference (which ships no FFV1 encoder):
gstpu's own RFC 9043 encoder with the codec-internal compute split
SURVEY.md §2.8 P4 calls for — per-frame prediction/context/residual
fields on the device (gstpu_torch/ops/ffv1_pred.py), adaptive range
coding in native C++ (native/gstpu_ffv1.cpp).

The port of gstpu/elements/video/av1.py: the host parts are copied as
they stand, and the device legs are torch ops on `default_device()` —
`rav1enc device-transform=true` and `rc-mode=device`
(gstpu_torch/ops/av1_intra.py) and `ffv1enc`'s field pass, which takes a
CUDA tensor or a `DeviceRow` as device-resident input. The bitstreams
equal gstpu's (tests/test_torch_ffv1.py, tests/test_torch_av1.py).
"""

from __future__ import annotations

import numpy as np
import torch

from gstpu_torch.core.base import BaseTransform, VideoDecoder
from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.core.device import default_device
from gstpu_torch.core.video import VideoInfo, video_caps
from gstpu_torch.ops.ffv1_pred import to_numpy

SECOND = 1_000_000_000


def _planes_to_i420(info: VideoInfo, buf: Buffer) -> bytes:
    return buf.to_bytes()          # gstpu I420 buffers are packed


@register_element("rav1enc", Rank.PRIMARY)
class Rav1Enc(BaseTransform):
    """AV1 encoder (reference video/rav1e rav1enc)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("I420",))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("video/x-av1")),
    ]

    # property surface per rav1enc/imp.rs:91-200
    speed_preset = Property(int, default=6, minimum=0, maximum=10,
                            mutable=Mutability.READY,
                            blurb="rav1e speed preset (10 fastest)")
    engine = Property(str, default="rav1e", mutable=Mutability.READY,
                      enum_values=("rav1e", "svt", "aom"),
                      blurb="AV1 engine: 'rav1e' (reference parity), "
                            "'svt' (SVT-AV1, realtime-class), 'aom' "
                            "(libaom realtime mode)")
    quantizer = Property(int, default=100, minimum=0, maximum=255,
                         mutable=Mutability.READY)
    bitrate = Property(int, default=0, minimum=0,
                       mutable=Mutability.PLAYING,
                       blurb="Target bitrate (bps); 0 = quantizer mode")
    max_key_frame_interval = Property(int, default=240, minimum=1,
                                      mutable=Mutability.READY)
    low_latency = Property(bool, default=False,
                           mutable=Mutability.READY)
    tile_cols = Property(int, default=0, minimum=0, maximum=64,
                         mutable=Mutability.READY)
    tile_rows = Property(int, default=0, minimum=0, maximum=64,
                         mutable=Mutability.READY)
    tiles = Property(int, default=0, minimum=0, maximum=4096,
                     mutable=Mutability.READY,
                     blurb="Total tile count hint (reference tiles; "
                           "rav1e splits automatically — prefer "
                           "tile-cols/tile-rows on svt/aom)")
    error_resilient = Property(bool, default=False,
                               mutable=Mutability.READY)
    min_key_frame_interval = Property(
        int, default=12, minimum=0, mutable=Mutability.READY,
        blurb="Min key frame interval (reference default 12)")
    switch_frame_interval = Property(
        int, default=0, minimum=0, mutable=Mutability.READY,
        blurb="S-frame interval; 0 = none (reference "
              "switch-frame-interval; rav1e engine only)")
    min_quantizer = Property(
        int, default=0, minimum=0, maximum=255,
        mutable=Mutability.READY,
        blurb="Floor quantizer (reference min-quantizer; maps to "
              "qmin/min-qp on aom/svt)")
    rdo_lookahead_frames = Property(
        int, default=-1, minimum=-1, mutable=Mutability.READY,
        blurb="RDO lookahead; -1 = engine default (reference "
              "rdo-lookahead-frames; low-latency caps it at 1)")
    reservoir_frame_delay = Property(
        int, default=-(2 ** 31), mutable=Mutability.READY,
        blurb="Rate-control reservoir depth in frames; INT32_MIN = "
              "engine default (reference reservoir-frame-delay; "
              "rav1e engine only)")
    threads = Property(
        int, default=0, minimum=0, maximum=256,
        mutable=Mutability.READY,
        blurb="Worker threads; 0 = automatic (reference threads — "
              "this container schedules one host core, so automatic "
              "resolves low)")
    rc_mode = Property(str, default="engine", mutable=Mutability.READY,
                       enum_values=("engine", "device"),
                       blurb="'engine' = the engine's own rate "
                             "control; 'device' = device intra analysis "
                             "(ops/av1_intra.py) picks the quantizer "
                             "closed-loop against `bitrate`. The "
                             "proxy model is INTRA rate: all-intra "
                             "and short-GOP streams converge tightly "
                             "(tests/test_av1_device_rc.py); for "
                             "long-GOP highly-predictable content "
                             "the bits live almost entirely in "
                             "keyframes and the achievable rate is "
                             "content-limited below some targets")
    rc_interval = Property(int, default=8, minimum=1, maximum=600,
                           mutable=Mutability.READY,
                           blurb="Frames between device rate-control "
                                 "analyses (amortizes the frame "
                                 "upload)")
    device_transform = Property(
        bool, default=False, mutable=Mutability.READY,
        blurb="Restricted device-intra profile: the device performs mode "
              "decision, 8x8 DCT, quantization and reconstruction for "
              "every block (ops/av1_intra.py make_intra_transform); "
              "the engine encodes the device reconstruction LOSSLESSLY "
              "(libaom lossless=1) as the entropy/bitstream layer, so "
              "the emitted AV1 bits decode under libdav1d to exactly "
              "the device transform+quant output. With bitrate > 0 the "
              "device qstep is steered closed-loop from observed bits; "
              "else `quantizer` fixes it.")

    def __init__(self, name=None):
        super().__init__(name)
        self._enc = None
        self._info = None
        self._engine_active = "rav1e"
        self._frame_n = 0
        self._analyze = None
        self._rc = None
        self._rc_bits = 0           # bits since last OBSERVED decision
        self._rc_pkts = 0           # packets emitted in that span
        self._rc_frames = 0         # frames sent in that span
        self._rc_forced_err = None  # |log err| when a ±1 was forced
        self._rc_limited = False    # content-limited latch
        self._rc_crf = None
        self._rc_pending = None     # in-flight device curve
        self._xform = None          # device-transform encode pass
        self._qrc = None            # qstep closed loop
        self._qstep = 4.0

    def transform_caps(self, direction, caps, filter):
        if direction is PadDirection.SINK:
            out = Caps.new("video/x-av1")
            for s in caps:
                for k in ("width", "height", "framerate"):
                    if k in s:
                        out[0][k] = s[k]
        else:
            out = self.sinkpad.pad_template_caps().copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def set_caps(self, incaps, outcaps) -> bool:
        from gstpu_torch.native_codec import NativeEncoder
        self._info = VideoInfo.from_caps(incaps)
        fr = self._info.framerate
        fps = ((fr.numerator, fr.denominator)
               if fr and fr.numerator else (30, 1))
        self._fps = fps
        # engine actually driving this open: resolved fresh from the
        # property on every renegotiation so a transient fallback
        # (svt refusing a sub-64px mitigation downscale) doesn't
        # stick once the caps recover
        self._engine_active = self.engine
        self._analyze = self._rc = self._rc_pending = None
        self._xform = self._qrc = None
        if self.device_transform:
            from gstpu_torch.ops.av1_intra import (QstepRateControl,
                                             make_intra_transform)
            self._xform = make_intra_transform(self._info.height,
                                               self._info.width,
                                               default_device())
            if self.bitrate > 0:
                self._qrc = QstepRateControl(self.bitrate,
                                             fps[0] / fps[1])
                self._qstep = self._qrc.qstep
            else:
                # quantizer (0-255) -> crf (0-63) -> qstep, the same
                # exponential family DeviceRateControl uses
                crf = min(63, self.quantizer // 4)
                self._qstep = 0.125 * 2.0 ** (crf / 6.0)
            if not self._open_engine():
                return False
            self._frame_n = 0
            return True
        if self.rc_mode == "device":
            if self.bitrate <= 0:
                self.post_error("rav1enc: rc-mode=device needs "
                                "bitrate > 0")
                return False
            from gstpu_torch.ops.av1_intra import (DeviceRateControl,
                                             make_intra_analyzer)
            try:
                self._analyze = make_intra_analyzer(
                    self._info.height, self._info.width, default_device())
            except ValueError as e:
                self.post_error(f"rav1enc: {e}")
                return False
            self._rc = DeviceRateControl(self.bitrate,
                                         fps[0] / fps[1])
            self._rc_crf = 32
            self._rc_bits = 0
            self._rc_pkts = 0
            self._rc_frames = 0
            self._rc_forced_err = None
            self._rc_limited = False
        if not self._open_engine():
            return False
        self._frame_n = 0
        return True

    def _open_engine(self) -> bool:
        from gstpu_torch.native_codec import NativeEncoder
        codec, opts = self._engine_opts()
        try:
            self._enc = NativeEncoder(codec, self._info.width,
                                      self._info.height, self._fps,
                                      opts)
        except RuntimeError as e:
            if self._engine_active != "rav1e":
                # engine limits (SVT-AV1 refuses frames < 64x64 —
                # webrtcsink's downscale mitigation can go below
                # that); fall back to the reference-parity engine,
                # which encodes any size, rather than erroring out
                # of a live session.  Transient: the next caps
                # renegotiation re-resolves from the property.
                self.post_warning(
                    f"rav1enc: {self._engine_active} refused "
                    f"{self._info.width}x{self._info.height} "
                    f"({e}); falling back to rav1e")
                self._engine_active = "rav1e"
                return self._open_engine()
            self.post_error(f"rav1enc: {e}")
            return False
        return True

    def _engine_opts(self):
        """Map the rav1e-shaped property surface onto the selected
        engine.  'svt' and 'aom' exist because this container's single
        host core caps rav1e ~2 fps at 1080p all-intra; SVT-AV1's
        high presets and libaom's realtime usage are the in-image
        engines built for that regime (both produce conformant AV1 —
        verified under libdav1d in tests/test_av1_codecs.py)."""
        if self._xform is not None:
            # device-transform mode: every lossy decision was already
            # made on the device; libaom in lossless mode is purely the
            # entropy/bitstream layer (recipe verified bit-exact under
            # libdav1d in tests/test_av1_device_transform.py)
            return "libaom-av1", {
                "crf": 0, "b": 0, "cpu-used": 8, "usage": "good",
                "lag-in-frames": 0, "g": self.max_key_frame_interval,
                "threads": 1, "aom-params": "lossless=1"}
        speed = self.speed_preset
        if self._rc is not None:
            # device rate control owns the rate: engine runs in
            # constant-quality mode at the device-picked quantizer
            bitrate, quantizer = 0, self._rc_crf * 4
        else:
            bitrate, quantizer = self.bitrate, self.quantizer
        if self._engine_active == "svt":
            import os
            os.environ.setdefault("SVT_LOG", "1")   # errors only
            # rav1e speed 0-10 -> svt preset 0-13
            opts = {"preset": min(13, round(speed * 1.3)),
                    "g": self.max_key_frame_interval}
            # one logical processor on this 1-core box unless the
            # threads property asks for more
            params = [f"lp={self.threads or 1}"]
            if self.min_quantizer:
                params.append(f"min-qp={min(63, self.min_quantizer // 4)}")
            if self._rc is not None:
                # device rc observes output bits closed-loop; cut the
                # engine's ~17-frame internal pipeline so observations
                # track decisions
                params.append("lookahead=0")
                params.append("pred-struct=1")
            if self.low_latency:
                params.append("pred-struct=1")  # low-delay
            if bitrate > 0:
                opts["b"] = bitrate
                params.append("rc=2")           # CBR needs pred-struct
                params.append("pred-struct=1")
            else:
                # rav1e qp 0-255 -> crf 0-63
                opts["crf"] = min(63, quantizer // 4)
            if self.tile_cols:
                params.append(f"tile-columns={self.tile_cols}")
            if self.tile_rows:
                params.append(f"tile-rows={self.tile_rows}")
            opts["svtav1-params"] = ":".join(params)
            return "libsvtav1", opts
        if self._engine_active == "aom":
            realtime = speed >= 7
            # realtime usage unlocks cpu-used 9-10 (libaom 3.6: range
            # is [0..10] for AOM_USAGE_REALTIME); ffmpeg's AVOption
            # caps at 8, so the top speeds ride aom-params instead.
            # rav1e speed 7..10 maps onto that range — the
            # single-host-core regime BASELINE config #5 lives in
            # (cpu-used=10 measures 41 fps 1080p30 on this box's one
            # core at working quality, PSNR ~36 dB @ 1.3 Mbps)
            cpu = min(10, speed) if realtime else min(8, speed)
            opts = {"cpu-used": min(8, cpu),
                    "usage": "realtime" if realtime else "good",
                    # realtime usage requires zero lookahead
                    "lag-in-frames": (0 if realtime or self.low_latency
                                      else 8),
                    "g": self.max_key_frame_interval,
                    "keyint_min": self.min_key_frame_interval,
                    "threads": self.threads or 1}
            if self.min_quantizer:
                opts["qmin"] = min(63, self.min_quantizer // 4)
            if cpu > 8:
                opts["aom-params"] = f"cpu-used={cpu}"
            if bitrate > 0:
                opts["b"] = bitrate
            else:
                opts["crf"] = min(63, quantizer // 4)
                opts["b"] = 0               # constant-quality mode
            if self.error_resilient:
                opts["error-resilience"] = "default"
            if self.tile_cols:
                opts["tile-columns"] = self.tile_cols
            if self.tile_rows:
                opts["tile-rows"] = self.tile_rows
            return "libaom-av1", opts
        params = []
        if self.low_latency:
            # rav1e still queues its rdo lookahead even with
            # low_latency; cap it so packets stream out frame-by-frame
            # (needed by the webrtcsink live path) — an explicit
            # rdo-lookahead-frames property wins below
            params.append("low_latency=true")
            if self.rdo_lookahead_frames < 0:
                params.append("rdo_lookahead_frames=1")
        if self.rdo_lookahead_frames >= 0:
            params.append(
                f"rdo_lookahead_frames={self.rdo_lookahead_frames}")
        if self.error_resilient:
            params.append("error_resilient=true")
        if self.min_key_frame_interval != 12:
            params.append(
                f"min_key_frame_interval={self.min_key_frame_interval}")
        if self.switch_frame_interval:
            params.append(
                f"switch_frame_interval={self.switch_frame_interval}")
        if self.min_quantizer:
            params.append(f"min_quantizer={self.min_quantizer}")
        if self.reservoir_frame_delay != -(2 ** 31):
            params.append(
                f"reservoir_frame_delay={self.reservoir_frame_delay}")
        if self.tiles:
            params.append(f"tiles={self.tiles}")
        opts = {
            "speed": speed,
            "g": self.max_key_frame_interval,
            # 0 = automatic; 8 was the measured sweet spot for
            # rav1e's internal pools on this box
            "threads": self.threads or 8,
        }
        if params:
            opts["rav1e-params"] = ":".join(params)
        if bitrate > 0:
            opts["b"] = bitrate
        else:
            opts["qp"] = quantizer
        if self.tile_cols:
            opts["tile-columns"] = self.tile_cols
        if self.tile_rows:
            opts["tile-rows"] = self.tile_rows
        return "librav1e", opts

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

    def reconfigure_bitrate(self, bps: int) -> list[Buffer]:
        """Live bitrate change (webrtcsink congestion control; the
        reference sets rav1enc's bitrate property at runtime,
        webrtcsink/imp.rs:1400-1402). Drains the engine and restarts
        it at the new rate — the next frame opens a fresh keyframe +
        sequence header, which is a valid AV1 stream continuation."""
        self.bitrate = bps
        if self._enc is None or self._info is None:
            return []
        out = self._emit(self._enc.finish())
        self._enc.close()
        self._enc = None
        if not self.set_caps(self._info.to_caps(), None):
            return out
        return out

    def _rc_tick(self, buf: Buffer) -> list[Buffer]:
        """Device rate-control step, every rc-interval frames: settle
        the in-flight analysis (dispatched one interval ago, so the
        device worked while the host encoded), steer the engine, and
        dispatch this frame's analysis.  An engine restart opens on a
        keyframe — the same valid-continuation semantics as
        reconfigure_bitrate."""
        drained: list[Buffer] = []
        if self._rc_pending is not None:
            curve, frames = self._rc_pending
            curve = curve.cpu().numpy()
            self._rc_frames += frames
            # engines with internal frame lag (libaom alt-ref groups,
            # post-restart buffering) emit packets in BURSTS: a
            # 30-frame window can see ~0 packets and the next one a
            # double helping.  Deciding on a starved window crashes
            # the EWMA scale (observed 0.71 -> 0.17 and a parked 0.59x
            # rate) — accumulate bits/frames until the span has
            # emitted a representative packet count, then observe.
            if self._rc_pkts >= max(1, self._rc_frames // 2):
                actual_pf = self._rc_bits / max(self._rc_frames, 1)
                # the bits just measured were produced at the crf IN
                # FORCE; scale the proxy model against that crf's own
                # curve point (av1_intra.DeviceRateControl.proxy_at)
                self._rc.observe(actual_pf,
                                 self._rc.proxy_at(curve,
                                                   self._rc_crf))
                crf = self._rc.pick(curve)
                self._rc_bits = 0
                self._rc_pkts = 0
                self._rc_frames = 0
                # restart hygiene vs steady-state accuracy: the >=2
                # deadband avoids engine-restart churn near target
                # (each restart opens on a keyframe); a ±1 move is
                # still taken when the MEASURED rate is parked more
                # than a full quantizer step off target — with the
                # unbiased proxy bookkeeping above that is a rare
                # recovery path, not the steady state.  If a forced
                # move did NOT move the rate toward target, the rate
                # is CONTENT-limited (e.g. long-GOP inter frames cost
                # ~nothing and only keyframes carry bits — the intra
                # proxy cannot buy bits the content won't spend):
                # latch the forcing off until the ratio shifts, or
                # every decision would churn an engine restart.
                import math
                err = abs(math.log(max(actual_pf, 1.0)
                                   / self._rc.target))
                if self._rc_forced_err is not None:
                    if err > self._rc_forced_err - 0.05:
                        self._rc_limited = True
                    self._rc_forced_err = None
                if self._rc_limited and err <= 0.20:
                    self._rc_limited = False    # back in reach
                off_band = err > 0.20 and not self._rc_limited
                if crf != self._rc_crf \
                        and (abs(crf - self._rc_crf) >= 2 or off_band):
                    if abs(crf - self._rc_crf) == 1:
                        self._rc_forced_err = err
                    self._rc_crf = crf
                    pkts = self._enc.finish()
                    # drained bits belong to the span that just
                    # opened — they leave the element now
                    # (unaccounted bits would make observe()
                    # under-report and the loop overshoot)
                    self._rc_bits += sum(len(d) * 8
                                         for d, _, _ in pkts)
                    self._rc_pkts += len(pkts)
                    drained = self._emit(pkts)
                    self._enc.close()
                    self._enc = None
                    if not self._open_engine():
                        return drained
        y = np.ascontiguousarray(self._info.planes(buf)[0])
        # the curve stays a device tensor until the next tick
        self._rc_pending = (self._analyze(y)[0], self.rc_interval)
        return drained

    def _device_transform_frame(self, buf: Buffer) -> list[Buffer] | None:
        """device-transform=true path: the device performs mode
        decision + 8x8 DCT + quantization + reconstruction of all three
        planes, uploaded once; the reconstruction comes back in one
        download and the lossless engine entropy-codes it.
        With bitrate > 0 the observed output bits steer the device
        qstep closed-loop (QstepRateControl)."""
        y, u, v = (np.ascontiguousarray(p, np.uint8)
                   for p in self._info.planes(buf))
        ry, ru, rv, _bits = self._xform(y, u, v,
                                        np.float32(self._qstep))
        rec = torch.cat([ry.reshape(-1), ru.reshape(-1),
                         rv.reshape(-1)]).cpu().numpy().tobytes()
        pkts = self._enc.send(rec, self._frame_n)
        self._frame_n += 1
        if self._qrc is not None and pkts:
            nbits = sum(len(d) * 8 for d, _, _ in pkts)
            self._qstep = self._qrc.observe(nbits / len(pkts))
        return self._emit(pkts) or None

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        if self._xform is not None:
            if self._enc is None:
                return None
            return self._device_transform_frame(buf)
        out: list[Buffer] = []
        if self._rc is not None and \
                self._frame_n % self.rc_interval == 0:
            out += self._rc_tick(buf)
        if self._enc is None:       # live reopen failed; error posted
            return out or None
        pkts = self._enc.send(_planes_to_i420(self._info, buf),
                              self._frame_n)
        self._frame_n += 1
        if self._rc is not None:
            self._rc_bits += sum(len(d) * 8 for d, _, _ in pkts)
            self._rc_pkts += len(pkts)
        return (out + self._emit(pkts)) or None

    def drain(self) -> list[Buffer]:
        if self._enc is None:
            return []
        return self._emit(self._enc.finish())

    def stop(self) -> bool:
        if self._enc is not None:
            self._enc.close()
            self._enc = None
        return True


class _AvDecoderBase(VideoDecoder):
    """Shared packet->I420 decode loop."""

    CODEC = ""
    NEEDS_DIMS = False

    def decoder_options(self) -> dict:
        """Per-element decoder AVOptions (subclass hook)."""
        return {}

    def __init__(self, name=None):
        super().__init__(name)
        self._dec = None
        self._in_info: VideoInfo | None = None

    def set_format(self, caps) -> bool:
        from gstpu_torch.native_codec import NativeDecoder
        s = caps[0]
        w = s.get("width", 0) or 0
        h = s.get("height", 0) or 0
        if self.NEEDS_DIMS and not (w and h):
            self.post_error(f"{self.CODEC}dec: caps need width/height")
            return False
        try:
            self._dec = NativeDecoder(self.CODEC, width=w, height=h,
                                      options=self.decoder_options())
        except RuntimeError as e:
            self.post_error(f"{self.CODEC} decoder: {e}")
            return False
        self._fr = s.get("framerate")
        self._pkt_n = 0
        return True

    def _emit_frames(self, frames) -> None:
        for data, w, h, fmt, pts_n in frames:
            if fmt != 0:
                self.post_error(f"{self.CODEC} decoder: unsupported "
                                f"output format {fmt}")
                continue
            if self.video_output_info is None or \
                    self.video_output_info.width != w or \
                    self.video_output_info.height != h:
                self.set_video_output_format(
                    VideoInfo("I420", w, h,
                              framerate=self._fr or VideoInfo("I420", w, h).framerate))
            dur = self.video_output_info.frame_duration
            pts = pts_n * dur if dur else None
            self.finish_video_frame(data, pts=pts)

    def handle_frame(self, buf: Buffer) -> None:
        if self._dec is None:
            return
        self._emit_frames(self._dec.send(buf.to_bytes(), self._pkt_n))
        self._pkt_n += 1

    def drain(self) -> list[Buffer]:
        if self._dec is None:
            return []
        self._pending_out = []
        self._emit_frames(self._dec.finish())
        out, self._pending_out = self._pending_out, []
        return out

    def stop(self) -> bool:
        if self._dec is not None:
            self._dec.close()
            self._dec = None
        return True


@register_element("dav1ddec", Rank.PRIMARY)
class Dav1dDec(_AvDecoderBase):
    """AV1 decoder around libdav1d (reference video/dav1d)."""

    CODEC = "libdav1d"
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("video/x-av1")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("I420",))),
    ]

    apply_grain = Property(
        bool, default=True, mutable=Mutability.READY,
        blurb="Synthesize film grain when the bitstream carries it "
              "(reference apply-grain; libdav1d 'filmgrain')")
    max_frame_delay = Property(
        int, default=-1, minimum=-1, mutable=Mutability.READY,
        blurb="Frames dav1d may buffer internally; -1 = automatic "
              "(reference max-frame-delay)")
    n_threads = Property(
        int, default=0, minimum=0, maximum=256,
        mutable=Mutability.READY,
        blurb="Decoder threads; 0 = automatic (reference n-threads). "
              "inloop-filters is NOT exposed: the in-image libavcodec "
              "libdav1d wrapper has no such option")

    def decoder_options(self) -> dict:
        opts = {"filmgrain": int(self.apply_grain)}
        if self.max_frame_delay >= 0:
            opts["max_frame_delay"] = self.max_frame_delay
        if self.n_threads:
            opts["threads"] = self.n_threads
        return opts


@register_element("ffv1enc", Rank.PRIMARY)
class Ffv1Enc(BaseTransform):
    """FFV1 lossless encoder — gstpu's own device-split engine (the
    reference has no FFV1 encoder; its video/ffv1 crate is
    decode-only).  Per-frame context/residual fields compute on the
    device in one fused pass; the sequential adaptive range coding
    runs in native C++ (pure-Python spec-model fallback when no
    toolchain, for host frames on a CPU-configured port only).  The two halves are pipelined one frame deep: while
    the host range-codes frame N-1, the device computes and downloads
    frame N's fields (a download worker thread materializes them), so
    the single host core spends its cycles only on entropy coding.
    Output decodes bit-exactly under libavcodec AND under this repo's
    ffv1dec."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    video_caps(formats=("I420",))),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("video/x-ffv1")),
    ]

    gop = Property(int, default=1, minimum=1, maximum=600,
                   mutable=Mutability.READY,
                   blurb="Keyframe interval (1 = all-intra, the "
                         "archival norm; context states persist "
                         "across intra-coded inter frames)")
    hop = Property(str, default="diff", mutable=Mutability.READY,
                   enum_values=("diff", "packed"),
                   blurb="device->host field layout: 'diff' ships "
                         "1 B/px (residuals only; contexts re-derived "
                         "in the native scan from the host-resident "
                         "source), 'packed' ships 2.25 B/px "
                         "(precomputed context fields; zero host "
                         "context work).  Identical bitstreams.")

    def __init__(self, name=None):
        super().__init__(name)
        self._info = None
        self._params = None
        self._pred = None
        self._coder = None      # native C++ coder, or None
        self._model = None      # pure-Python fallback
        self._frame_n = 0
        self._dl = None         # download worker (1 thread)
        self._pending = None    # (fields_future, key, pts, duration)

    def transform_caps(self, direction, caps, filter):
        if direction is PadDirection.SINK:
            out = Caps.new("video/x-ffv1")
            for s in caps:
                for k in ("width", "height", "framerate"):
                    if k in s:
                        out[0][k] = s[k]
        else:
            out = self.sinkpad.pad_template_caps().copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def set_caps(self, incaps, outcaps) -> bool:
        from gstpu_torch.codecs import ffv1
        from gstpu_torch.ops.ffv1_pred import Predictor
        self._info = VideoInfo.from_caps(incaps)
        self._params = ffv1.Params(self._info.width, self._info.height)
        device = default_device()
        self._pred = Predictor(self._params.quant, device)
        self._coder = None
        self._model = None
        try:
            from gstpu_torch.native_ffv1 import NativeFrameCoder
            self._coder = NativeFrameCoder(self._params)
            from concurrent.futures import ThreadPoolExecutor
            self._dl = ThreadPoolExecutor(1)
        except (RuntimeError, OSError):
            # the spec model is gstpu's host fallback: it runs on host
            # frames alone, so a port set up for a device refuses it
            if device.type != "cpu":
                self.post_error(
                    f"ffv1enc: the native FFV1 coder did not build "
                    f"(g++ on native/gstpu_ffv1.cpp); the spec-model "
                    f"fallback runs only on the CPU, not on {device}")
                return False
            self._model = ffv1.ModelEncoder(self._params, gop=self.gop)
        self._frame_n = 0
        self._pending = None
        return True

    @staticmethod
    def _materialize(dev_fields):
        return [(to_numpy(d, np.int8), to_numpy(lo, np.uint8),
                 to_numpy(h4, np.uint8)) for d, lo, h4 in dev_fields]

    @staticmethod
    def _materialize_diff(dev_diffs):
        return [to_numpy(d, np.int8) for d in dev_diffs]

    def _split_i420(self, flat: np.ndarray):
        info = self._info
        w, h = info.width, info.height
        cw, ch = -(-w // 2), -(-h // 2)
        return [flat[:w * h].reshape(h, w),
                flat[w * h:w * h + cw * ch].reshape(ch, cw),
                flat[w * h + cw * ch:].reshape(ch, cw)]

    def _code(self, frame) -> Buffer:
        fut, key, pts, duration, planes, mode = frame
        if mode == "dev":
            data = self._coder.encode_from_diff(
                key, self._split_i420(fut.result()[0]))
        elif mode == "packed":
            data = self._coder.encode_packed(key, fut.result())
        else:
            data = self._coder.encode_from_plane(key, planes,
                                                 fut.result())
        out = Buffer(data, pts=pts, duration=duration)
        if not key:
            out.set_flag(BufferFlags.DELTA_UNIT)
        return out

    @staticmethod
    def _device_resident(data) -> bool:
        from gstpu_torch.runtime.device_batch import DeviceRow
        return (isinstance(data, (torch.Tensor, DeviceRow))
                and data.device.type != "cpu")

    def _device_flat(self, data):
        """If the payload is DEVICE-RESIDENT (a CUDA tensor or a
        DeviceRow from an upstream device chain), return it as a flat
        device view WITHOUT a host transfer; else None (a CPU tensor or
        host memory takes the host route).  Device input takes the
        zero-upload path: only the 1 B/px residual field ever crosses
        the link — one field pass and one download per frame — and the
        native coder reconstructs the source from it
        (fe_encode_from_diff)."""
        from gstpu_torch.runtime.device_batch import DeviceRow
        if isinstance(data, DeviceRow):
            data = data.tensor()
        elif not (isinstance(data, torch.Tensor)
                  and data.device.type == "cuda"):
            return None
        flat = data.reshape(-1)
        if flat.dtype != torch.uint8:
            raise ValueError("device ffv1enc input must be uint8 I420")
        return flat

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        if self._coder is not None:
            key = (self._frame_n % self.gop) == 0
            self._frame_n += 1
            dev_flat = self._device_flat(buf.data)
            if dev_flat is not None:
                host, mode = None, "dev"
                dev = [self._pred.dispatch_diff_i420(
                    dev_flat, self._info.width, self._info.height)]
                fut = self._dl.submit(self._materialize_diff, dev)
            elif self.hop == "diff":
                planes = self._info.planes(buf)
                host, mode = [np.ascontiguousarray(p, np.uint8)
                              for p in planes], "plane"
                dev = [self._pred.dispatch_diff(p) for p in host]
                fut = self._dl.submit(self._materialize_diff, dev)
            else:
                planes = self._info.planes(buf)
                host, mode = None, "packed"
                dev = [self._pred.dispatch_packed(p) for p in planes]
                fut = self._dl.submit(self._materialize, dev)
            prev = self._pending
            self._pending = (fut, key, buf.pts, buf.duration, host,
                             mode)
            return [self._code(prev)] if prev is not None else []
        if self._device_resident(buf.data):
            raise RuntimeError("ffv1enc: device-resident input needs the "
                               "native FFV1 coder; the spec model takes "
                               "host frames only")
        data, key = self._model.encode(list(self._info.planes(buf)))
        self._frame_n += 1
        out = Buffer(data, pts=buf.pts, duration=buf.duration)
        if not key:
            out.set_flag(BufferFlags.DELTA_UNIT)
        return [out]

    def drain(self) -> list[Buffer]:
        if self._coder is not None and self._pending is not None:
            prev, self._pending = self._pending, None
            return [self._code(prev)]
        return []

    def stop(self) -> bool:
        if self._dl is not None:
            self._dl.shutdown(wait=True)
            self._dl = None
        self._pending = None
        if self._coder is not None:
            self._coder.close()
            self._coder = None
        self._model = None
        return True


@register_element("ffv1dec", Rank.PRIMARY)
class Ffv1Dec(_AvDecoderBase):
    """FFV1 lossless decoder (reference video/ffv1 ffv1dec)."""

    CODEC = "ffv1"
    NEEDS_DIMS = True
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("video/x-ffv1")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps(formats=("I420",))),
    ]
