"""audiornnoise: frame-based noise suppression element.

The port of gstpu/elements/audio/rnnoise.py, which rebuilds the
reference element (audio/audiofx/src/audiornnoise/imp.rs): F32 @ 48 kHz,
480-sample frames, one denoiser state per channel, max-over-channels VAD
gating (frames below voice-activity-threshold are muted), AudioLevelMeta
on output, EOS drain with zero-padding.

Engines (gstpu_torch.ops.rnnoise): `spectral` (the default without
weights) and `host` (the GRU from model-location, the default with
weights) run the numpy DenoiseState on the host, as in gstpu; `device`
runs the GRU through TorchGruModel on default_device(), one call per
frame and channel. With `context` set, the element joins that
DeviceContext (gstpu_torch.runtime.device_batch): its streams run
batched as one make_device_gru_denoiser step (weights set) or one
make_device_denoiser step (spectral gate) per block round, on the
device the rows lie on.
"""

from __future__ import annotations

import numpy as np
import torch

from gstpu_torch.core.adapter import SampleAdapter
from gstpu_torch.core.audio import AudioInfo, audio_caps
from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer, Meta
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.device import default_device
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.query import LatencyQuery
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.ops.rnnoise import (FRAME_SIZE, DenoiseState, GruModel,
                                     TorchGruModel, make_device_denoiser,
                                     make_device_gru_denoiser)
from gstpu_torch.runtime.device_batch import (DeviceContext, DeviceRow,
                                              _is_device)

SECOND = 1_000_000_000


class AudioLevelMeta(Meta):
    """gst_audio AudioLevelMeta analogue (level dB u8, voice flag)."""

    def __init__(self, level: int, has_voice: bool):
        self.level = level
        self.has_voice = has_voice


_CAPS = audio_caps(formats="F32LE", rate=48000)


@register_element("audiornnoise", Rank.NONE)
class AudioRNNoise(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    _CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    _CAPS.copy()),
    ]

    voice_activity_threshold = Property(
        float, default=0.0, minimum=0.0, maximum=1.0,
        mutable=Mutability.PLAYING,
        blurb="Frames with VAD below this are muted")
    model_location = Property(str, default=None, mutable=Mutability.READY,
                              blurb="Optional .npz RNNoise weight file")
    engine = Property(str, default="auto", mutable=Mutability.READY,
                      enum_values=("auto", "device", "host", "spectral"),
                      blurb="'auto' (host GRU when weights are set, else "
                            "spectral gate), 'device', 'host', "
                            "'spectral'")
    context = Property(
        str, default=None, mutable=Mutability.READY,
        blurb="DeviceContext name: batch the denoiser with the other "
              "members' streams")
    context_block = Property(
        int, default=None, minimum=480, mutable=Mutability.READY,
        blurb="Flat samples per dispatch (multiple of 480*channels; "
              "default 10 frames)")
    precision = Property(
        str, default="f64", mutable=Mutability.READY,
        enum_values=("f64", "f32"),
        blurb="Device compute precision for the batched GRU chain: f64 "
              "matches the host oracle tightly; f32 is the reference "
              "RNNoise pipeline's own precision")

    def __init__(self, name=None):
        super().__init__(name)
        self._denoisers: list[DenoiseState] = []
        self._adapter: SampleAdapter | None = None
        self._info: AudioInfo | None = None
        self._ctx = None

    # -- state ---------------------------------------------------------
    def start(self) -> bool:
        self._ctx = None
        if self.context:
            self._ctx = DeviceContext.acquire(self.context,
                                              self.context_block)
            self._ctx.add_member(self)
        return True

    def stop(self) -> bool:
        if self._ctx is not None:
            self._ctx.remove_member(self)
            self._ctx = None
        return True

    def set_caps(self, incaps: Caps, outcaps: Caps) -> bool:
        self._info = AudioInfo.from_caps(incaps)
        if self._ctx is not None:
            return self._join_context()
        self._denoisers = []
        eng = self.engine
        if eng == "auto":
            # host GRU: per-frame streaming dispatch; the device engine
            # pays a transfer per 10 ms frame unless batched
            eng = "host" if self.model_location else "spectral"
        if eng != "spectral" and not self.model_location:
            self.post_error("audiornnoise: GRU engine needs "
                            "model-location (.npz weights)")
            return False
        for _ in range(self._info.channels):
            if eng == "spectral":
                model = None
            elif eng == "host":
                model = GruModel.load(self.model_location)
            else:
                model = TorchGruModel.load(self.model_location,
                                           device=default_device())
            self._denoisers.append(DenoiseState(model))
        self._adapter = SampleAdapter(self._info.rate)
        return True

    def _join_context(self) -> bool:
        C = self._info.channels
        if self.engine == "host":
            self.post_error("audiornnoise: context mode batches on "
                            "device (engine=host is the streaming path)")
            return False
        unit = FRAME_SIZE * C
        if self._ctx.block % unit:
            self.post_error(f"audiornnoise: context-block must be a "
                            f"multiple of {unit} (480 samples x {C} ch)")
            return False
        self._ctx.finalize_member(self)
        return True

    # -- host processing -----------------------------------------------
    def transform(self, buf: Buffer) -> list[Buffer] | None:
        info = self._info
        if self._ctx is not None:
            data = buf.data if _is_device(buf.data) \
                else info.view(buf).astype(np.float64).reshape(-1)
            self._ctx.submit(self, data, buf.pts, info.rate * info.channels)
            return None                 # outputs flow from the batch
        self._adapter.push(info.view(buf).astype(np.float32), pts=buf.pts)
        avail = self._adapter.available()
        n_frames = avail // FRAME_SIZE
        if n_frames == 0:
            return None
        samples, pts, dur = self._adapter.take_pts(n_frames * FRAME_SIZE)
        return [self._process(samples, pts)]

    def _process(self, samples: np.ndarray, pts) -> Buffer:
        info = self._info
        ch = info.channels
        out = np.empty_like(samples)
        has_voice = False
        for off in range(0, samples.shape[0], FRAME_SIZE):
            frame = samples[off:off + FRAME_SIZE]
            vad = 0.0
            outs = []
            for c in range(ch):
                y, v = self._denoisers[c].process_frame(
                    frame[:, c] * 32767.0)
                outs.append(y / 32767.0)
                vad = max(vad, v)
            if vad < self.voice_activity_threshold:
                out[off:off + FRAME_SIZE] = 0.0
            else:
                if vad >= 0.98:
                    has_voice = True
                out[off:off + FRAME_SIZE] = np.stack(outs, axis=1)
        rms = float(np.sum(out * out))
        level = int(np.clip(-20.0 * np.log10(rms + np.finfo(np.float32).eps),
                            0.0, 255.0))
        b = info.make_buffer(out.astype(np.float32), pts=pts)
        b.add_meta(AudioLevelMeta(level, has_voice))
        return b

    def drain(self) -> list[Buffer]:
        if self._ctx is not None:
            return self._ctx.flush_member(self)
        if self._adapter is None:
            return []
        avail = self._adapter.available()
        if avail == 0:
            return []
        samples, pts, _ = self._adapter.take_pts(avail)
        pad = np.zeros((FRAME_SIZE - (avail % FRAME_SIZE) if
                        avail % FRAME_SIZE else 0,
                        self._info.channels), np.float32)
        full = np.concatenate([samples.astype(np.float32), pad])
        b = self._process(full, pts)
        # reference drains padded full frames (generate_output keeps
        # whole frames); emit only the real samples
        arr = b.array.reshape(-1, self._info.channels)[:avail]
        out = self._info.make_buffer(arr, pts=pts)
        out.metas = b.metas
        return [out]

    def flush(self) -> None:
        if self._adapter is not None:
            self._adapter.clear()
        for d in self._denoisers:
            d.reset()

    def add_latency(self, q: LatencyQuery) -> None:
        # one 480-sample frame at 48 kHz = 10 ms (the reference computes
        # this with integer division and adds 0 — imp.rs:377-379; we
        # report the true value)
        q.add(FRAME_SIZE * SECOND // 48000, FRAME_SIZE * SECOND // 48000)

    # -- DeviceContext contract (runtime/device_batch.py) ---------------
    def device_batch_spec(self) -> dict:
        C = self._info.channels
        frames = self._ctx.block // (FRAME_SIZE * C)
        if self.model_location and self.engine != "spectral":
            # the full RNNoise GRU chain on the device (STFT + 42-feature
            # frontend + GRU stack + iSTFT), batched across streams
            dt = torch.float32 if self.precision == "f32" else torch.float64
            step, init = make_device_gru_denoiser(
                dict(np.load(self.model_location)),
                frames_per_block=frames, dtype=dt)
            key = ("audiornnoise-gru", C, frames, self.precision,
                   self.model_location)
        else:
            dt = torch.float64
            step, init = make_device_denoiser(frames_per_block=frames)
            key = ("audiornnoise", C, frames)
        device = default_device()

        def spec_step(st, x, thr):
            B = x.shape[0]
            # (B, n*C) interleaved -> (B*C, n)
            n = x.shape[1] // C
            xc = x.reshape(B, n, C).permute(0, 2, 1).reshape(B * C, n)
            flat = {k: v.reshape((B * C,) + v.shape[2:])
                    for k, v in st.items()}
            flat, out, vads = step(flat, xc * 32767.0)
            out = out / 32767.0
            F = vads.shape[1]
            # stream VAD = max over channels, per frame; mute frames
            # below threshold (host _process semantics)
            vmax = torch.amax(vads.reshape(B, C, F), dim=1)     # (B, F)
            mute = (vmax < thr)[:, :, None]                     # (B,F,1)
            o = out.reshape(B, C, F, FRAME_SIZE)
            o = torch.where(mute[:, None], 0.0, o)
            o = o.permute(0, 2, 3, 1).reshape(B, -1)
            st2 = {k: v.reshape((B, C) + v.shape[1:])
                   for k, v in flat.items()}
            return st2, o, dict(vad=torch.amax(vmax, dim=1))

        return dict(key=key,
                    step=spec_step,
                    # leading dim = channels
                    init_state=lambda: init(C, device),
                    uniforms=lambda: (self.voice_activity_threshold,),
                    compute_dtype=np.float32 if dt == torch.float32
                    else np.float64)

    def make_batch_buffer(self, flat, pts, dur) -> Buffer:
        if isinstance(flat, DeviceRow):
            return Buffer(flat, pts=pts, duration=dur)
        return self._info.make_buffer(
            np.asarray(flat, np.float32).reshape(-1, self._info.channels),
            pts=pts, duration=dur)
