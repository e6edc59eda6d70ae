"""whispertranscriber: speech-to-text on Whisper.

Rebuilds the reference audio/whisper whispertranscriber
(src/whispertranscriber/imp.rs): 16 kHz mono F32 audio is chunked
(chunk-duration, default 4 s) and each chunk transcribed to timed
text/x-raw buffers. The reference embeds whisper.cpp with a
model-path property; here the engine is Hugging Face transformers'
Whisper (baked into this image), loading `model-path` strictly
locally (local_files_only — the zero-egress gate is fetching
published weights, not the element). Tests run the real transformers
pipeline with a tiny randomly-initialized Whisper config.

The port's copy of gstpu/elements/audio/whisper.py, with the model and
its input features on the port's default device (`gstpu_torch.init`),
run there with TF32 off; the processor stays on the host.
"""

from __future__ import annotations

import numpy as np

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

RATE = 16_000
SECOND = 1_000_000_000

SINK_CAPS = Caps.new("audio/x-raw", format="F32LE", rate=RATE,
                     channels=1)
SRC_CAPS = Caps.new("text/x-raw", format="utf8")


class TransformersWhisper:
    """Engine on transformers' WhisperForConditionalGeneration."""

    def __init__(self, model_path: str, language: str | None,
                 translate: bool):
        import torch  # noqa: F401  (transformers needs it anyway)
        from transformers import (WhisperForConditionalGeneration,
                                  WhisperProcessor)

        from gstpu_torch.core.device import default_device
        self.processor = WhisperProcessor.from_pretrained(
            model_path, local_files_only=True)
        self.device = default_device()
        self.model = WhisperForConditionalGeneration.from_pretrained(
            model_path, local_files_only=True).eval().to(self.device)
        self.language = language
        self.task = "translate" if translate else "transcribe"

    def transcribe(self, samples: np.ndarray) -> str:
        import torch

        from gstpu_torch.core.device import tf32_off
        feats = self.processor(samples, sampling_rate=RATE,
                               return_tensors="pt").input_features
        kwargs = {}
        if self.language:
            kwargs["language"] = self.language
            kwargs["task"] = self.task
        with torch.no_grad(), tf32_off():
            ids = self.model.generate(feats.to(self.device),
                                      max_new_tokens=64, **kwargs)
        return self.processor.batch_decode(
            ids.cpu(), skip_special_tokens=True)[0].strip()


@register_element("whispertranscriber", Rank.NONE)
class WhisperTranscriber(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    SINK_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    SRC_CAPS.copy()),
    ]

    model_path = Property(str, default=None, mutable=Mutability.READY,
                          blurb="Local Whisper model directory "
                                "(transformers format; loaded with "
                                "local_files_only)")
    chunk_duration = Property(int, default=4000, minimum=100,
                              maximum=30000,
                              mutable=Mutability.READY,
                              blurb="Transcription chunk (ms), "
                                    "reference chunk-duration")
    language = Property(str, default=None, mutable=Mutability.READY)
    translate = Property(bool, default=False,
                         mutable=Mutability.READY,
                         blurb="Translate to English instead of "
                               "transcribing")

    # test/applications hook: a callable np.float32[n] -> str used
    # instead of loading model_path
    engine = None

    def __init__(self, name=None):
        super().__init__(name)
        self._acc = np.zeros(0, np.float32)
        self._chunk_start_ns: int | None = None

    def transform_caps(self, direction, caps, filter):
        out = (SRC_CAPS if direction is PadDirection.SINK
               else SINK_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def start(self) -> bool:
        if self.engine is None:
            if not self.model_path:
                self.post_error("whispertranscriber: no model-path "
                                "set and no engine injected")
                return False
            try:
                eng = TransformersWhisper(self.model_path,
                                          self.language,
                                          self.translate)
                self.engine = eng.transcribe
            except Exception as e:
                self.post_error(f"whispertranscriber: cannot load "
                                f"{self.model_path!r}: {e}")
                return False
        self._acc = np.zeros(0, np.float32)
        self._chunk_start_ns = None
        return True

    def _chunk_samples(self) -> int:
        return RATE * self.chunk_duration // 1000

    def _emit(self, samples: np.ndarray, start_ns: int) -> Buffer | None:
        try:
            text = self.engine(samples)
        except Exception as e:
            self.post_error(f"whispertranscriber: engine failed: {e}")
            return None
        dur = len(samples) * SECOND // RATE
        return Buffer(text.encode("utf-8"), pts=start_ns,
                      duration=dur)

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        samples = np.frombuffer(bytes(buf.to_bytes()), np.float32)
        if self._chunk_start_ns is None:
            self._chunk_start_ns = buf.pts or 0
        self._acc = np.concatenate([self._acc, samples])
        out = []
        n = self._chunk_samples()
        while len(self._acc) >= n:
            chunk, self._acc = self._acc[:n], self._acc[n:]
            b = self._emit(chunk, self._chunk_start_ns)
            self._chunk_start_ns += n * SECOND // RATE
            if b is not None and b.to_bytes():
                out.append(b)
        return out or None

    def drain(self) -> list[Buffer]:
        if len(self._acc) == 0 or self._chunk_start_ns is None:
            return []
        b = self._emit(self._acc, self._chunk_start_ns)
        self._acc = np.zeros(0, np.float32)
        return [b] if b is not None and b.to_bytes() else []
