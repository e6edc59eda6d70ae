"""demucs: music source separation with per-stem request pads.

Rebuilds the reference demucs element (audio/demucs/src/demucs/
imp.rs:10-57), which embeds CPython+PyTorch via pyo3 and calls the
pip `demucs` package.  Here torch is first-class: the element runs

  * the pip `demucs` pretrained pipeline when the package is
    importable (model property = model name, reference default
    "htdemucs"), or
  * any TorchScript module from `model-location` with the demucs
    tensor contract: (1, channels, T) f32 in, (1, n_stems, channels,
    T) out — the weight-loading contract for offline environments
    where the pip package/weights are absent.

Stems flow out of request pads src_vocals / src_drums / src_bass /
src_other (reference: per-stem request src pads); unrequested stems
are dropped.  Audio is accumulated into `segment`-second chunks
(reference splits with overlap inside the demucs package; chunking
here is plain concatenation, documented).

The port's copy of gstpu/elements/audio/demucs.py, with the model on
the port's default device (`gstpu_torch.init`): the module is moved
there when it is loaded, each segment is uploaded and separated there
with TF32 off, and the stems come back to the host as gstpu's F32
buffers. Its pads take one or two channels as a range, so that
`audioconvert ! audioresample` can negotiate with it.
"""

from __future__ import annotations

import numpy as np

from gstpu_torch.core.adapter import SampleAdapter
from gstpu_torch.core.audio import AudioInfo, audio_caps
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps, IntRange
from gstpu_torch.core.element import (Element, FlowReturn, Pad, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.event import CapsEvent, EosEvent, Event, SegmentEvent, \
    StreamStartEvent
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000
STEMS = ("drums", "bass", "other", "vocals")   # demucs order

# channels as a range: gstpu's (1, 2) is a plain tuple, which intersects
# with no caps but its own, so only an element with ANY caps could link
# to demucs or negotiate with it
_CAPS = audio_caps(formats="F32LE", rate=44100, channels=IntRange(1, 2))


@register_element("demucs", Rank.NONE)
class Demucs(Element):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    _CAPS.copy()),
        PadTemplate("src_%s", PadDirection.SRC, PadPresence.REQUEST,
                    _CAPS.copy()),
    ]

    model = Property(str, default="htdemucs", mutable=Mutability.READY,
                     blurb="demucs pretrained model name (pip package)")
    model_location = Property(str, default=None,
                              mutable=Mutability.READY,
                              blurb="TorchScript module path "
                                    "((1,C,T)->(1,4,C,T) contract)")
    segment = Property(float, default=5.0, minimum=0.1, maximum=30.0,
                       mutable=Mutability.READY,
                       blurb="Chunk length in seconds")

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._stem_pads: dict[str, Pad] = {}
        self._adapter: SampleAdapter | None = None
        self._info: AudioInfo | None = None
        self._model = None
        self._started: set[str] = set()

    # -- request pads -----------------------------------------------------
    def new_request_pad(self, pad: Pad) -> None:
        stem = pad.name.removeprefix("src_")
        if stem not in STEMS:
            raise ValueError(f"demucs: unknown stem pad {pad.name!r}; "
                             f"use src_<{'|'.join(STEMS)}>")
        self._stem_pads[stem] = pad

    # -- model ------------------------------------------------------------
    def _load_model(self) -> bool:
        import torch
        from gstpu_torch.core.device import default_device
        if self.model_location:
            self._model = torch.jit.load(self.model_location).to(
                default_device())
            return True
        try:
            from demucs.pretrained import get_model
            self._model = get_model(self.model).to(default_device())
            return True
        except Exception as e:
            self.post_error(
                f"demucs: pip package/weights unavailable ({e}); set "
                f"model-location to a TorchScript module")
            return False

    # -- dataflow ---------------------------------------------------------
    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._info is None:
            return FlowReturn.NOT_NEGOTIATED
        self._adapter.push(self._info.view(buf).astype(np.float32),
                           pts=buf.pts)
        chunk = int(self.segment * self._info.rate)
        while self._adapter.available() >= chunk:
            samples, pts, _ = self._adapter.take_pts(chunk)
            ret = self._separate(samples, pts)
            if not ret.is_ok:
                return ret
        return FlowReturn.OK

    def _separate(self, samples: np.ndarray, pts) -> FlowReturn:
        import torch
        from gstpu_torch.core.device import default_device, tf32_off
        wav = torch.from_numpy(np.ascontiguousarray(samples.T))[None].to(
            default_device())                          # (1, C, T)
        with torch.no_grad(), tf32_off():
            stems = self._model(wav)                   # (1, S, C, T)
        stems = stems[0].cpu().numpy()
        dur = samples.shape[0] * SECOND // self._info.rate
        for i, stem in enumerate(STEMS[:stems.shape[0]]):
            p = self._stem_pads.get(stem)
            if p is None or not p.is_linked():
                continue
            if stem not in self._started:
                p.push_event(StreamStartEvent(
                    f"{self.name}/{stem}"))
                p.push_event(CapsEvent(self._info.to_caps()))
                p.push_event(SegmentEvent(self.segment_ev))
                self._started.add(stem)
            out = np.ascontiguousarray(stems[i].T)     # (T, C)
            r = p.push(Buffer(out.astype(np.float32), pts=pts,
                              duration=dur))
            if not r.is_ok:
                return r
        return FlowReturn.OK

    def _event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, CapsEvent):
            self._info = AudioInfo.from_caps(ev.caps)
            self._adapter = SampleAdapter(self._info.rate)
            if self._model is None and not self._load_model():
                return False
            return True
        if isinstance(ev, SegmentEvent):
            self.segment_ev = ev.segment
            return True
        if isinstance(ev, EosEvent):
            if self._adapter is not None and self._adapter.available():
                samples, pts, _ = self._adapter.take_pts(
                    self._adapter.available())
                self._separate(samples, pts)
            ok = True
            for p in self._stem_pads.values():
                if p.is_linked():
                    ok = p.push_event(ev) and ok
            return ok
        for p in self._stem_pads.values():
            if p.is_linked():
                p.push_event(ev)
        return True
