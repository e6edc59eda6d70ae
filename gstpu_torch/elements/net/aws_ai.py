"""awspolly / awstranslate: AWS AI service elements over gstpu's
SigV4 stack (reference net/aws/src/polly/imp.rs, translate/imp.rs —
there via the AWS SDK; here the REST protocols directly):

* awspolly: text/x-raw (or application/ssml+xml) buffers ->
  SynthesizeSpeech (POST /v1/speech, OutputFormat=pcm) -> S16LE mono
  audio buffers at `sample-rate`.
* awstranslate: text/x-raw -> TranslateText
  (X-Amz-Target AWSShineFrontendService_20170701.TranslateText) ->
  translated text buffers, timestamps preserved (slots into
  translationbin like the reference).

`endpoint-uri` points at any compatible endpoint — tests run mocks
that verify the SigV4 signature; real AWS needs network+credentials.

The port's copy of gstpu/elements/net/aws_ai.py, as it stands.
"""

from __future__ import annotations

import json
import urllib.request

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.elements.net.aws import _S3Mixin

TEXT_CAPS = Caps.new("text/x-raw", format="utf8")


class _AwsAiBase(_S3Mixin, BaseTransform):
    region = Property(str, default="us-west-2",
                      mutable=Mutability.READY)

    def _post(self, *, service: str, url: str, body: bytes,
              headers: dict[str, str] | None = None) -> bytes:
        from gstpu_torch.net.aws.sigv4 import sign_request
        hdrs = sign_request(
            method="POST", url=url, region=self.region,
            service=service, access_key=self.access_key or "",
            secret_key=self.secret_access_key or "",
            session_token=self.session_token,
            headers=headers, payload=body)
        req = urllib.request.Request(url, data=body, method="POST",
                                     headers=hdrs)
        try:
            with urllib.request.urlopen(
                    req, timeout=self.request_timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:200]
            raise ConnectionError(
                f"{service} HTTP {e.code}: {detail}") from e

    def _endpoint(self, service: str) -> str:
        if self.endpoint_uri:
            return self.endpoint_uri.rstrip("/")
        return f"https://{service}.{self.region}.amazonaws.com"


@register_element("awspolly", Rank.NONE)
class AwsPolly(_AwsAiBase):
    """Text -> speech via Polly SynthesizeSpeech (PCM output)."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps([TEXT_CAPS[0].copy(),
                          __import__("gstpu_torch.core.caps",
                                     fromlist=["Structure"])
                          .Structure("application/ssml+xml")])),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("audio/x-raw", format="S16LE",
                             channels=1)),
    ]

    voice_id = Property(str, default="Joanna",
                        mutable=Mutability.READY)
    engine = Property(str, default="neural",
                      enum_values=("standard", "neural", "long-form",
                                   "generative"),
                      mutable=Mutability.READY)
    sample_rate = Property(int, default=16000,
                           enum_values=(8000, 16000),
                           mutable=Mutability.READY)
    lexicon_names = Property(str, default=None,
                             mutable=Mutability.READY,
                             blurb="comma-separated lexicon names")

    def __init__(self, name=None):
        super().__init__(name)
        self._ssml = False

    def transform_caps(self, direction, caps, filter):
        if direction is PadDirection.SINK:
            out = Caps.new("audio/x-raw", format="S16LE", channels=1,
                           rate=self.sample_rate, layout="interleaved")
        else:
            out = self.sinkpad.pad_template_caps().copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def set_caps(self, incaps, outcaps) -> bool:
        self._ssml = incaps[0].name == "application/ssml+xml"
        return True

    def transform(self, buf: Buffer) -> Buffer | None:
        text = buf.to_bytes().decode()
        if not text.strip():
            return None
        body = {"Engine": self.engine, "OutputFormat": "pcm",
                "SampleRate": str(self.sample_rate),
                "Text": text,
                "TextType": "ssml" if self._ssml else "text",
                "VoiceId": self.voice_id}
        if self.lexicon_names:
            body["LexiconNames"] = self.lexicon_names.split(",")
        try:
            pcm = self._post(
                service="polly",
                url=self._endpoint("polly") + "/v1/speech",
                body=json.dumps(body).encode(),
                headers={"content-type": "application/json"})
        except ConnectionError as e:
            self.post_error(f"awspolly: {e}")
            raise FlowError(FlowReturn.ERROR)
        out = Buffer(pcm, pts=buf.pts)
        out.duration = (len(pcm) // 2) * 10**9 // self.sample_rate
        return out


@register_element("awstranslate", Rank.NONE)
class AwsTranslate(_AwsAiBase):
    """Text -> translated text via TranslateText."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    TEXT_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    TEXT_CAPS.copy()),
    ]

    input_language_code = Property(str, default="en",
                                   mutable=Mutability.READY)
    output_language_code = Property(str, default="es",
                                    mutable=Mutability.READY)
    brevity_on = Property(bool, default=False,
                          mutable=Mutability.READY)

    def transform_caps(self, direction, caps, filter):
        out = TEXT_CAPS.copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> Buffer | None:
        text = buf.to_bytes().decode()
        if not text.strip():
            return None
        body = {"Text": text,
                "SourceLanguageCode": self.input_language_code,
                "TargetLanguageCode": self.output_language_code}
        if self.brevity_on:
            body["Settings"] = {"Brevity": "ON"}
        try:
            resp = self._post(
                service="translate",
                url=self._endpoint("translate") + "/",
                body=json.dumps(body).encode(),
                headers={"content-type":
                         "application/x-amz-json-1.1",
                         "x-amz-target":
                         "AWSShineFrontendService_20170701"
                         ".TranslateText"})
        except ConnectionError as e:
            self.post_error(f"awstranslate: {e}")
            raise FlowError(FlowReturn.ERROR)
        translated = json.loads(resp).get("TranslatedText", "")
        return Buffer(translated.encode(), pts=buf.pts,
                      duration=buf.duration)
