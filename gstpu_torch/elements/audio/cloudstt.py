"""Cloud speech-to-text elements speaking the REAL wire protocols:

* speechmaticstranscriber — Speechmatics Realtime API v2
  (reference audio/speechmatics/src/transcriber/imp.rs:219-236,
  1081-1310): StartRecognition/AudioAdded/AddTranscript/
  AddPartialTranscript/EndOfStream/EndOfTranscript JSON over
  WebSocket, binary audio frames in between.
* deepgramtranscriber — Deepgram streaming listen API
  (reference net/deepgram/src/transcriber/): Token-auth WebSocket,
  binary audio, {"type":"Results"} JSON with
  channel.alternatives[0].transcript, CloseStream at EOS.

Both run the protocol over gstpu's WsClient (gstpu/net/ws.py)
against any ws:// endpoint — tests use in-process mock servers; the
real services need wss:// + network + credentials (the env gate is
TLS/egress, not the protocol).

The port's copy of gstpu/elements/audio/cloudstt.py, as it stands.
"""

from __future__ import annotations

import json

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000
SINK_CAPS = Caps.new("audio/x-raw", format="S16LE", rate=16000,
                     channels=1, layout="interleaved")
SRC_CAPS = Caps.new("text/x-raw", format="utf8")


class _CloudSttBase(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    SINK_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    SRC_CAPS.copy()),
    ]

    url = Property(str, default=None, mutable=Mutability.READY,
                   blurb="ws:// endpoint (real service is wss://; "
                         "TLS/egress is the env gate)")
    api_key = Property(str, default=None, mutable=Mutability.READY)
    latency = Property(int, default=8 * SECOND, minimum=0,
                       blurb="transcript latency budget (ns)")
    lateness = Property(int, default=0, minimum=0,
                        mutable=Mutability.READY,
                        blurb="Milliseconds added to every output "
                              "timestamp (reference lateness)")
    max_observed_delay = Property(
        int, default=0, writable=False,
        blurb="Max ns observed between sending audio and receiving "
              "its transcript item (reference read-only "
              "max-observed-delay)")

    def __init__(self, name=None):
        super().__init__(name)
        self._ws = None
        self._audio_sent_ns = 0

    def _observe_delay(self, item_end_s: float) -> None:
        delay = self._audio_sent_ns - int(item_end_s * SECOND)
        if delay > self._prop_values.get("max_observed_delay", 0):
            self._prop_values["max_observed_delay"] = delay

    def transform_caps(self, direction, caps, filter):
        out = SRC_CAPS.copy() if direction is PadDirection.SINK \
            else SINK_CAPS.copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    # subclasses implement:
    def _connect(self) -> None:
        raise NotImplementedError

    def _send_audio(self, data: bytes) -> None:
        raise NotImplementedError

    def _finish(self) -> list[Buffer]:
        raise NotImplementedError

    def _poll_messages(self, timeout: float = 0.0) -> list[Buffer]:
        raise NotImplementedError

    def start(self) -> bool:
        if not self.url:
            self.post_error(f"{self.ELEMENT_NAME}: no url set")
            return False
        try:
            self._connect()
        except Exception as e:
            self.post_error(f"{self.ELEMENT_NAME}: connect "
                            f"failed: {e}")
            return False
        return True

    def stop(self) -> bool:
        if self._ws is not None:
            self._ws.close()
            self._ws = None
        return True

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        try:
            data = buf.to_bytes()
            self._send_audio(data)
            # 16 kHz s16 mono: track how much audio time was sent
            # (feeds the max-observed-delay read-only property)
            self._audio_sent_ns += len(data) * SECOND // 32000
            out = self._poll_messages(0.0)
        except Exception as e:
            self.post_error(f"{self.ELEMENT_NAME}: {e}")
            raise FlowError(FlowReturn.ERROR)
        return out or None

    def drain(self) -> list[Buffer]:
        if self._ws is None:
            return []
        try:
            return self._finish()
        except Exception as e:
            self.post_error(f"{self.ELEMENT_NAME}: drain: {e}")
            return []

    @staticmethod
    def _text_buffer(text: str, start_s: float,
                     end_s: float) -> Buffer:
        b = Buffer(text.encode())
        b.pts = int(start_s * SECOND)
        b.duration = max(int((end_s - start_s) * SECOND), 0)
        return b

    def _emit_text(self, text: str, start_s: float,
                   end_s: float) -> Buffer:
        """_text_buffer + lateness shift + delay accounting."""
        self._observe_delay(end_s)
        b = self._text_buffer(text, start_s, end_s)
        if self.lateness:
            b.pts += self.lateness * 1_000_000
        return b


@register_element("speechmaticstranscriber", Rank.NONE)
class SpeechmaticsTranscriber(_CloudSttBase):
    """Speechmatics RT API v2 transcriber."""

    language = Property(str, default="en", mutable=Mutability.READY)
    enable_partials = Property(bool, default=False,
                               mutable=Mutability.READY)
    max_delay = Property(float, default=0.0, minimum=0.0,
                         blurb="transcription_config.max_delay (s); "
                               "0 = service default")
    language_code = Property(str, default="",
                             mutable=Mutability.READY,
                             blurb="Overrides 'language' when set "
                                   "(reference language-code)")
    additional_vocabulary = Property(
        str, default="", mutable=Mutability.READY,
        blurb="Comma-separated words sent as "
              "transcription_config.additional_vocab (reference "
              "additional-vocabulary)")
    diarization = Property(str, default="none",
                           enum_values=("none", "speaker"),
                           mutable=Mutability.READY,
                           blurb="transcription_config.diarization")
    max_speakers = Property(int, default=50, minimum=2, maximum=100,
                            mutable=Mutability.READY,
                            blurb="speaker_diarization_config."
                                  "max_speakers (with "
                                  "diarization=speaker)")
    labeled_speakers = Property(
        str, default="", mutable=Mutability.READY,
        blurb="JSON array for speaker_diarization_config.speakers "
              "(reference labeled-speakers)")
    remove_disfluencies = Property(
        bool, default=False, mutable=Mutability.READY,
        blurb="transcript_filtering_config.remove_disfluencies")
    mask_profanities = Property(
        bool, default=False, mutable=Mutability.READY,
        blurb="Replace alternatives tagged profanity with asterisks "
              "(reference mask-profanities — applied to results, "
              "not a wire option)")
    audio_event_types = Property(
        str, default="", mutable=Mutability.READY,
        blurb="Comma-separated audio_events_config.types (reference "
              "audio-event-types); events surface as "
              "speechmatics-audio-event messages")

    def __init__(self, name=None):
        super().__init__(name)
        self._seq = 0

    def _connect(self) -> None:
        from gstpu_torch.net.ws import WsClient
        headers = {}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        self._ws = WsClient(self.url, headers=headers)
        self._seq = 0
        cfg = {"language": self.language_code or self.language,
               "enable_partials": self.enable_partials}
        if self.max_delay:
            cfg["max_delay"] = self.max_delay
        if self.additional_vocabulary:
            cfg["additional_vocab"] = [
                {"content": w.strip()}
                for w in self.additional_vocabulary.split(",")
                if w.strip()]
        cfg["diarization"] = self.diarization
        if self.diarization == "speaker":
            sd = {"max_speakers": self.max_speakers, "speakers": []}
            if self.labeled_speakers:
                sd["speakers"] = json.loads(self.labeled_speakers)
            cfg["speaker_diarization_config"] = sd
        cfg["transcript_filtering_config"] = {
            "remove_disfluencies": self.remove_disfluencies}
        start = {
            "message": "StartRecognition",
            "audio_format": {"type": "raw",
                             "encoding": "pcm_s16le",
                             "sample_rate": 16000},
            "transcription_config": cfg,
        }
        if self.audio_event_types:
            start["audio_events_config"] = {
                "types": [t.strip() for t in
                          self.audio_event_types.split(",")
                          if t.strip()]}
        self._ws.send_text(json.dumps(start))
        # wait for RecognitionStarted
        deadline_msgs = 50
        while deadline_msgs:
            raw = self._ws.recv(5.0)
            if raw is None:
                raise ConnectionError("closed before "
                                      "RecognitionStarted")
            msg = json.loads(raw)
            m = msg.get("message")
            if m == "RecognitionStarted":
                return
            if m == "Error":
                raise ConnectionError(msg.get("reason", "error"))
            deadline_msgs -= 1
        raise ConnectionError("no RecognitionStarted")

    def _send_audio(self, data: bytes) -> None:
        self._ws.send_binary(data)
        self._seq += 1

    def _handle(self, msg: dict, out: list[Buffer]) -> bool:
        """-> True when EndOfTranscript arrives."""
        m = msg.get("message")
        if m in ("AudioEventStarted", "AudioEventEnded"):
            ev = msg.get("event", {})
            self.post_element_message(
                "speechmatics-audio-event", phase=m,
                type=ev.get("type", ""),
                time=ev.get("start_time", ev.get("end_time", 0.0)))
            return False
        if m == "AddTranscript" or (m == "AddPartialTranscript"
                                    and self.enable_partials):
            if self.mask_profanities:
                for r in msg.get("results", []):
                    for alt in r.get("alternatives", []):
                        if "profanity" in alt.get("tags", []):
                            alt["content"] = "*" * len(
                                alt.get("content", ""))
            meta = msg.get("metadata", {})
            text = meta.get("transcript", "")
            if not text and msg.get("results"):
                text = " ".join(
                    r["alternatives"][0]["content"]
                    for r in msg["results"] if r.get("alternatives"))
            if text.strip():
                out.append(self._text_buffer(
                    text.strip(), meta.get("start_time", 0.0),
                    meta.get("end_time", 0.0)))
        elif m == "Error":
            raise ConnectionError(msg.get("reason", "service error"))
        return m == "EndOfTranscript"

    def _poll_messages(self, timeout: float = 0.0) -> list[Buffer]:
        out: list[Buffer] = []
        while True:
            raw = self._ws.poll(timeout)
            if raw is None:
                return out
            self._handle(json.loads(raw), out)
            timeout = 0.0

    def _finish(self) -> list[Buffer]:
        self._ws.send_text(json.dumps({
            "message": "EndOfStream", "last_seq_no": self._seq}))
        out: list[Buffer] = []
        for _ in range(1000):
            raw = self._ws.recv(5.0)
            if raw is None:
                break
            if self._handle(json.loads(raw), out):
                break
        return out


@register_element("deepgramtranscriber", Rank.NONE)
class DeepgramTranscriber(_CloudSttBase):
    """Deepgram streaming listen API transcriber."""

    language = Property(str, default="en", mutable=Mutability.READY)
    language_code = Property(str, default="",
                             mutable=Mutability.READY,
                             blurb="Overrides 'language' when set "
                                   "(reference language-code)")
    model = Property(str, default="nova-2", mutable=Mutability.READY)
    interim_results = Property(bool, default=False,
                               mutable=Mutability.READY)
    diarization = Property(bool, default=False,
                           mutable=Mutability.READY,
                           blurb="Request speaker diarization "
                                 "(reference diarization -> the "
                                 "listen API's diarize flag)")
    interim_timing_threshold = Property(
        int, default=0, minimum=0, mutable=Mutability.READY,
        blurb="Suppress interim results until their end time "
              "advances by this many ns over the last emitted one "
              "(reference interim-timing-threshold)")

    def _connect(self) -> None:
        from gstpu_torch.net.ws import WsClient
        import urllib.parse
        self._last_interim_end = -1
        q = urllib.parse.urlencode({
            "encoding": "linear16", "sample_rate": 16000,
            "channels": 1,
            "language": self.language_code or self.language,
            "model": self.model,
            **({"diarize": "true"} if self.diarization else {}),
            "interim_results":
                "true" if self.interim_results else "false"})
        sep = "&" if "?" in self.url else "?"
        headers = {}
        if self.api_key:
            headers["Authorization"] = f"Token {self.api_key}"
        self._ws = WsClient(f"{self.url}{sep}{q}", headers=headers)

    def _send_audio(self, data: bytes) -> None:
        self._ws.send_binary(data)

    def _handle(self, msg: dict, out: list[Buffer]) -> bool:
        if msg.get("type") == "Results":
            alts = msg.get("channel", {}).get("alternatives", [])
            text = alts[0].get("transcript", "") if alts else ""
            final = msg.get("is_final", True)
            if text.strip() and (final or self.interim_results):
                start = msg.get("start", 0.0)
                end = start + msg.get("duration", 0.0)
                if not final and self.interim_timing_threshold:
                    # rate-limit interim churn (reference
                    # interim-timing-threshold)
                    if int(end * SECOND) - self._last_interim_end \
                            < self.interim_timing_threshold:
                        return False
                    self._last_interim_end = int(end * SECOND)
                out.append(self._emit_text(text.strip(), start, end))
        return msg.get("type") == "Metadata" \
            and msg.get("transaction_key") == "closed"

    def _poll_messages(self, timeout: float = 0.0) -> list[Buffer]:
        out: list[Buffer] = []
        while True:
            raw = self._ws.poll(timeout)
            if raw is None:
                return out
            self._handle(json.loads(raw), out)
            timeout = 0.0

    def _finish(self) -> list[Buffer]:
        self._ws.send_text(json.dumps({"type": "CloseStream"}))
        out: list[Buffer] = []
        for _ in range(1000):
            raw = self._ws.recv(5.0)
            if raw is None:
                break
            if self._handle(json.loads(raw), out):
                break
        return out
