"""oggdemux + lewtondec: Ogg Vorbis playback.

Rebuilds the reference lewtondec (audio/lewton/src/lewtondec: an
AudioDecoder wrapping the lewton crate) on gstpu_torch/codecs/vorbis.py,
plus the minimal single-stream Ogg demuxer the reference gets from
GStreamer core.  lewtondec consumes audio/x-vorbis packets (3 headers
first), emits interleaved F32LE, and uses the Ogg granule position
(carried on Buffer.offset) to clip the stream tail.

The port's copy of gstpu/elements/audio/lewton.py: host code, as there.
"""

from __future__ import annotations

import numpy as np

from gstpu_torch.codecs.ogg import parse_pages
from gstpu_torch.core.audio import AudioInfo
from gstpu_torch.core.base import AudioDecoder, BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.registry import Rank, register_element


@register_element("oggdemux", Rank.PRIMARY)
class OggDemux(BaseTransform):
    """Single-logical-stream Ogg demuxer: packets of the first BOS
    stream come out as buffers, page granulepos on Buffer.offset."""

    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("application/ogg")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("audio/x-vorbis")),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._acc = b""
        self._serial = None
        self._partial = b""
        self._consumed = 0

    def transform_caps(self, direction, caps, filter):
        out = (Caps.new("audio/x-vorbis")
               if direction is PadDirection.SINK
               else Caps.new("application/ogg")).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> list[Buffer] | None:
        self._acc += buf.to_bytes()
        out = []
        consumed = 0
        for page in parse_pages(self._acc):
            # advance the consumption cursor over this page
            hdr = self._acc.find(b"OggS", consumed)
            n_segs = self._acc[hdr + 26]
            body = sum(self._acc[hdr + 27:hdr + 27 + n_segs])
            consumed = hdr + 27 + n_segs + body
            if self._serial is None and page.bos:
                self._serial = page.serial
            if page.serial != self._serial:
                continue
            segs = list(page.segments)
            if page.continued and segs:
                self._partial += segs.pop(0)
                if page.last_complete or segs:
                    out.append(Buffer(self._partial,
                                      offset=page.granulepos))
                    self._partial = b""
            for i, s in enumerate(segs):
                if i == len(segs) - 1 and not page.last_complete:
                    self._partial += s
                else:
                    out.append(Buffer(s, offset=page.granulepos))
        self._acc = self._acc[consumed:]
        return out or None


@register_element("lewtondec", Rank.PRIMARY)
class LewtonDec(AudioDecoder):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.new("audio/x-vorbis")),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("audio/x-raw", format="F32LE")),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        from gstpu_torch.codecs.vorbis import VorbisDecoder
        self._dec = VorbisDecoder()
        self._n_hdr = 0
        self._emitted = 0
        self._skip = None
        self._granule = -1

    def handle_frame(self, buf: Buffer) -> None:
        pkt = buf.to_bytes()
        if self._n_hdr < 3:
            self._dec.header_packet(pkt)
            self._n_hdr += 1
            if self._n_hdr == 3:
                self.set_output_format(AudioInfo(
                    format="F32LE", rate=self._dec.rate,
                    channels=self._dec.channels,
                    layout="interleaved"))
                self._next_pts = 0
            return
        self._dec.decode(pkt)
        if buf.offset is not None and buf.offset >= 0:
            self._granule = max(self._granule, buf.offset)
        self._drain_ready(final=False)

    def _drain_ready(self, final: bool) -> None:
        dec = self._dec
        if self._skip is None:
            if getattr(dec, "_first_n", None) is None:
                return
            self._skip = dec._first_n // 2
        parts = list(dec._out)
        dec._out = []
        if final and dec._buf is not None:
            parts.append(dec._buf)
            dec._buf = None
        if not parts:
            return
        pcm = np.concatenate(parts, axis=1)
        if self._skip:
            cut = min(self._skip, pcm.shape[1])
            pcm = pcm[:, cut:]
            self._skip -= cut
        if final and self._granule >= 0:
            room = self._granule - self._emitted
            pcm = pcm[:, :max(room, 0)]
        if pcm.shape[1] == 0:
            return
        self._emitted += pcm.shape[1]
        self.finish_frame(np.ascontiguousarray(pcm.T))

    def drain(self) -> list[Buffer]:
        self._pending_out = []
        self._drain_ready(final=True)
        out, self._pending_out = self._pending_out, []
        return out
