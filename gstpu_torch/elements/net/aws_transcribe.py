"""awstranscriber / awstranscriber2 / awstranscribeparse: AWS
Transcribe elements over the real wire formats.

* awstranscriber(2): the Transcribe STREAMING protocol — a SigV4
  query-presigned WebSocket carrying vnd.amazon.eventstream frames
  (gstpu/net/aws/eventstream.py): AudioEvent messages up,
  TranscriptEvent JSON down (reference net/aws/src/transcriber/ via
  the SDK's HTTP/2 eventstream; the WS flavor carries the identical
  framing).
* awstranscribeparse: parses a BATCH transcription job's JSON output
  into timed text buffers + gap events (reference
  net/aws/src/transcribe_parse/imp.rs:121-200: pronunciation items
  carry start/end times, punctuation attaches at the last pts).

The port's copy of gstpu/elements/net/aws_transcribe.py, as it stands.
"""

from __future__ import annotations

import json

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowError, FlowReturn, Pad,
                                      PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.event import EosEvent, Event, GapEvent
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000
TEXT_CAPS = Caps.new("text/x-raw", format="utf8")


@register_element("awstranscriber2", Rank.NONE)
@register_element("awstranscriber", Rank.NONE)
class AwsTranscriber(BaseTransform):
    """Streaming speech-to-text via the Transcribe eventstream
    WebSocket."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("audio/x-raw", format="S16LE",
                             rate=16000, channels=1,
                             layout="interleaved")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    TEXT_CAPS.copy()),
    ]

    access_key = Property(str, default=None, mutable=Mutability.READY)
    secret_access_key = Property(str, default=None,
                                 mutable=Mutability.READY)
    session_token = Property(str, default=None,
                             mutable=Mutability.READY)
    region = Property(str, default="us-east-1",
                      mutable=Mutability.READY)
    language_code = Property(str, default="en-US",
                             mutable=Mutability.READY)
    endpoint_uri = Property(str, default=None,
                            mutable=Mutability.READY,
                            blurb="ws:// override (real endpoint is "
                                  "wss://transcribestreaming."
                                  "<region>.amazonaws.com:8443)")
    show_partial = Property(bool, default=False,
                            mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._ws = None
        self._rx = bytearray()

    def transform_caps(self, direction, caps, filter):
        out = (TEXT_CAPS if direction is PadDirection.SINK
               else self.PAD_TEMPLATES[0].caps).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def start(self) -> bool:
        from gstpu_torch.net.aws.sigv4 import presign_url
        from gstpu_torch.net.ws import WsClient
        base = self.endpoint_uri or (
            f"wss://transcribestreaming.{self.region}"
            ".amazonaws.com:8443")
        url = (f"{base}/stream-transcription-websocket"
               f"?language-code={self.language_code}"
               "&media-encoding=pcm&sample-rate=16000")
        signed = presign_url(
            method="GET", url=url, region=self.region,
            service="transcribe", access_key=self.access_key or "",
            secret_key=self.secret_access_key or "",
            session_token=self.session_token)
        try:
            self._ws = WsClient(signed)
        except Exception as e:
            self.post_error(f"{self.ELEMENT_NAME}: connect: {e}")
            return False
        self._rx = bytearray()
        return True

    def stop(self) -> bool:
        if self._ws is not None:
            self._ws.close()
            self._ws = None
        return True

    def _audio_event(self, pcm: bytes) -> bytes:
        from gstpu_torch.net.aws.eventstream import encode_message
        return encode_message(
            {":message-type": "event",
             ":event-type": "AudioEvent",
             ":content-type": "application/octet-stream"}, pcm)

    def _drain_events(self, out: list[Buffer],
                      timeout: float = 0.0) -> bool:
        """Poll WS frames; returns True on stream end."""
        from gstpu_torch.net.aws.eventstream import decode_message
        while True:
            raw = self._ws.poll(timeout)
            if raw is None:
                return False
            timeout = 0.0
            headers, payload, _ = decode_message(raw)
            mtype = headers.get(":message-type")
            if mtype == "exception":
                raise FlowError(
                    FlowReturn.ERROR,
                    f"transcribe exception: "
                    f"{payload.decode(errors='replace')[:200]}")
            if headers.get(":event-type") != "TranscriptEvent":
                continue
            doc = json.loads(payload)
            for res in doc.get("Transcript", {}).get("Results", []):
                if res.get("IsPartial") and not self.show_partial:
                    continue
                alts = res.get("Alternatives", [])
                text = alts[0].get("Transcript", "") if alts else ""
                if not text.strip():
                    continue
                b = Buffer(text.strip().encode())
                b.pts = int(res.get("StartTime", 0.0) * SECOND)
                b.duration = max(int(
                    (res.get("EndTime", 0.0)
                     - res.get("StartTime", 0.0)) * SECOND), 0)
                out.append(b)

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        out: list[Buffer] = []
        try:
            self._ws.send_binary(self._audio_event(buf.to_bytes()))
            self._drain_events(out)
        except FlowError:
            raise
        except Exception as e:
            self.post_error(f"{self.ELEMENT_NAME}: {e}")
            raise FlowError(FlowReturn.ERROR)
        return out or None

    def drain(self) -> list[Buffer]:
        if self._ws is None:
            return []
        out: list[Buffer] = []
        try:
            # empty AudioEvent = end of stream
            self._ws.send_binary(self._audio_event(b""))
            for _ in range(200):
                before = len(out)
                raw_none = self._drain_events(out, timeout=1.0)
                if raw_none or len(out) == before:
                    break
        except Exception as e:
            self.post_error(f"{self.ELEMENT_NAME}: drain: {e}")
        return out


@register_element("awstranscribeparse", Rank.NONE)
class AwsTranscribeParse(Element):
    """Batch transcript JSON -> timed text buffers + gaps."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("application/x-json")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    TEXT_CAPS.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.srcpad = self.static_pad("src")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self._acc = bytearray()
        self._started = False

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self._acc += buf.to_bytes()
        return FlowReturn.OK

    def _ensure_started(self) -> None:
        if self._started:
            return
        self._started = True
        from gstpu_torch.core.event import (CapsEvent, Segment,
                                            SegmentEvent, StreamStartEvent)
        self.srcpad.push_event(StreamStartEvent(self.name))
        self.srcpad.push_event(CapsEvent(TEXT_CAPS.copy()))
        self.srcpad.push_event(SegmentEvent(Segment()))

    def _sink_event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, EosEvent):
            try:
                self._parse_and_push()
            except (json.JSONDecodeError, KeyError, ValueError) as e:
                self.post_error(f"awstranscribeparse: unexpected "
                                f"transcription format: {e}")
                return False
            return self.srcpad.push_event(ev)
        if ev.serialized:
            return True
        return self.srcpad.push_event(ev)

    def _parse_and_push(self) -> None:
        self._ensure_started()
        doc = json.loads(bytes(self._acc).decode())
        last_pts = 0
        for item in doc["results"]["items"]:
            alts = item.get("alternatives", [])
            if not alts:
                continue
            content = alts[0]["content"]
            if item.get("type") == "punctuation":
                b = Buffer(content.encode(), pts=last_pts, duration=0)
                self.srcpad.push(b)
                continue
            start = int(float(item["start_time"]) * SECOND)
            end = int(float(item["end_time"]) * SECOND)
            if start > last_pts:
                self.srcpad.push_event(
                    GapEvent(last_pts, start - last_pts))
            b = Buffer(content.encode(), pts=start,
                       duration=max(end - start, 0))
            self.srcpad.push(b)
            last_pts = end
