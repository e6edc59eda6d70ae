"""alawenc/alawdec/mulawenc/mulawdec: G.711 transcoding elements.

Companions to the RTP PCMA/PCMU payloaders (the reference relies on
the C alaw/mulaw plugins for these); the transcode tables run in the
native library (native/gstpu_native.cpp) with numpy fallbacks.

The port's copy of gstpu/elements/audio/g711.py, as it stands: host
numpy and the port's `native` library; a tensor payload is read
through `Buffer.array`.
"""

from __future__ import annotations

import numpy as np

from gstpu_torch import native
from gstpu_torch.core.audio import AudioInfo, audio_caps
from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps, IntRange, Structure
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.registry import Rank, register_element


def _law_caps(name: str) -> Caps:
    return Caps([Structure(name, rate=IntRange(1, 2**31 - 1),
                           channels=IntRange(1, 64))])


def _make_pair(law: str, caps_name: str, enc_fn, dec_fn):
    class Enc(BaseTransform):
        PAD_TEMPLATES = [
            PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                        audio_caps(formats="S16LE")),
            PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                        _law_caps(caps_name)),
        ]

        def transform_caps(self, direction, caps, filter):
            if caps.is_any():
                out = (self.srcpad if direction is PadDirection.SINK
                       else self.sinkpad).pad_template_caps().copy()
            else:
                structs = []
                for s in caps:
                    if direction is PadDirection.SINK:
                        st = Structure(caps_name)
                    else:
                        st = Structure("audio/x-raw", format="S16LE",
                                       layout="interleaved")
                    for k in ("rate", "channels"):
                        if k in s:
                            st[k] = s[k]
                    structs.append(st)
                out = Caps(structs)
            if filter is not None:
                out = filter.intersect(out)
            return out

        def transform(self, buf: Buffer) -> Buffer:
            pcm = buf.array.view(np.int16)
            return Buffer(enc_fn(pcm), pts=buf.pts, dts=buf.dts,
                          duration=buf.duration, flags=buf.flags)

    class Dec(Enc):
        PAD_TEMPLATES = [
            PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                        _law_caps(caps_name)),
            PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                        audio_caps(formats="S16LE")),
        ]

        def transform_caps(self, direction, caps, filter):
            if caps.is_any():
                out = (self.srcpad if direction is PadDirection.SINK
                       else self.sinkpad).pad_template_caps().copy()
            else:
                structs = []
                for s in caps:
                    if direction is PadDirection.SINK:
                        st = Structure("audio/x-raw", format="S16LE",
                                       layout="interleaved")
                    else:
                        st = Structure(caps_name)
                    for k in ("rate", "channels"):
                        if k in s:
                            st[k] = s[k]
                    structs.append(st)
                out = Caps(structs)
            if filter is not None:
                out = filter.intersect(out)
            return out

        def transform(self, buf: Buffer) -> Buffer:
            codes = buf.array.view(np.uint8)
            return Buffer(dec_fn(codes), pts=buf.pts, dts=buf.dts,
                          duration=buf.duration, flags=buf.flags)

    Enc.__name__ = f"{law.title()}Enc"
    Dec.__name__ = f"{law.title()}Dec"
    register_element(f"{law}enc", Rank.PRIMARY)(Enc)
    register_element(f"{law}dec", Rank.PRIMARY)(Dec)
    return Enc, Dec


_make_pair("alaw", "audio/x-alaw", native.alaw_encode, native.alaw_decode)
_make_pair("mulaw", "audio/x-mulaw", native.mulaw_encode,
           native.mulaw_decode)
