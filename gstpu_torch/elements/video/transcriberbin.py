"""transcriberbin: wire a speech transcriber into a caption path.

Rebuilds the reference transcriberbin's topology (video/closedcaption/
src/transcriberbin/imp.rs): audio tees into a pluggable transcriber
(any element description producing text/x-raw), whose transcript runs
through tttocea608 into cccombiner's caption pad; video flows through
cccombiner so frames leave with VideoCaptionMeta attached.  With no
transcriber configured (the reference's cloud transcribers need
credentials/egress) the bin degrades to passthrough, matching the
reference's error fallback (imp.rs:284).

The port's copy of gstpu/elements/video/transcriberbin.py: the video
payload, a tensor included, is handed on unread.
"""

from __future__ import annotations

from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowReturn, Pad, PadDirection,
                                      PadPresence, PadTemplate, State)
from gstpu_torch.core.event import Event
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, make, register_element
from gstpu_torch.core.video import video_caps


def _cap_pad(name, chain, event):
    p = Pad(name, PadDirection.SINK,
            PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                        Caps.any()))
    p.chain_function = chain
    p.event_function = event
    return p


@register_element("transcriberbin", Rank.NONE)
class TranscriberBin(Element):
    PAD_TEMPLATES = [
        PadTemplate("sink_video", PadDirection.SINK,
                    PadPresence.ALWAYS, video_caps()),
        PadTemplate("sink_audio", PadDirection.SINK,
                    PadPresence.ALWAYS, Caps.new("audio/x-raw")),
        PadTemplate("src_video", PadDirection.SRC, PadPresence.ALWAYS,
                    video_caps()),
        PadTemplate("src_audio", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("audio/x-raw")),
    ]

    transcriber = Property(str, default=None,
                           mutable=Mutability.PLAYING,
                           blurb="Transcriber element description "
                                 "(audio in, text/x-raw out); setting "
                                 "it at PLAYING swaps the transcriber "
                                 "live (reference transcriberbin "
                                 "relinks at runtime)")
    latency = Property(int, default=1000, minimum=0, maximum=60_000,
                       mutable=Mutability.READY,
                       blurb="Transcription latency (ms) announced on "
                             "the video path: how long cccombiner "
                             "may wait for captions (reference "
                             "`latency`)")
    translate_latency = Property(int, default=500, minimum=0,
                                 maximum=60_000,
                                 mutable=Mutability.READY,
                                 blurb="Extra latency (ms) when "
                                       "translators are configured "
                                       "(reference translate-latency)")
    passthrough = Property(bool, default=False,
                           mutable=Mutability.PLAYING,
                           blurb="Bypass captioning live (the "
                                 "reference toggles this at PLAYING)")
    mux_method = Property(str, default="cea608",
                          mutable=Mutability.READY,
                          enum_values=("cea608", "cea708"),
                          blurb="Caption format: CEA-608 pairs or "
                                "CEA-708 cc_data with DTVCC services "
                                "(reference mux-method)")
    mode = Property(str, default="pop-on", mutable=Mutability.READY,
                    enum_values=("pop-on", "roll-up2", "roll-up3",
                                 "roll-up4"))
    caption_source = Property(str, default="both",
                              mutable=Mutability.PLAYING,
                              enum_values=("both", "transcription",
                                           "inband"),
                              blurb="Keep inband captions, "
                                    "transcription, or both "
                                    "(reference caption-source)")
    translation_languages = Property(
        object, default=None, mutable=Mutability.READY,
        blurb="dict language -> CEA-708 service number; with "
              "mux-method=cea708 each language becomes its own DTVCC "
              "service (reference translation-languages)")
    translators = Property(
        object, default=None, mutable=Mutability.READY,
        blurb="dict language -> translator element description "
              "(text/x-raw in/out); languages without one carry the "
              "untranslated transcript (cloud translators are the "
              "env gate)")

    def __init__(self, name=None):
        super().__init__(name)
        self._vsink = self.static_pad("sink_video")
        self._asink = self.static_pad("sink_audio")
        self._vsrc = self.static_pad("src_video")
        self._asrc = self.static_pad("src_audio")
        self._vsink.chain_function = self._video_chain
        self._vsink.event_function = self._video_event
        self._asink.chain_function = self._audio_chain
        self._asink.event_function = self._audio_event
        self._trans = None
        self._combiner = None
        self._children: list = []
        self._active = False
        self._audio_stream_events: list[Event] = []
        self._video_stream_events: list[Event] = []
        self._vsrc.query_function = self._latency_query
        self._asrc.query_function = self._latency_query
        self.connect_notify("transcriber", self._on_transcriber_set)

    # -- latency -----------------------------------------------------------
    def _latency_query(self, pad: Pad, q) -> bool:
        from gstpu_torch.core.query import LatencyQuery
        sink = self._vsink if pad is self._vsrc else self._asink
        if isinstance(q, LatencyQuery):
            if not sink.query(q):
                return False
            if self._active and not self.passthrough:
                ms = self.latency
                if self.translators:
                    ms += self.translate_latency
                ns = ms * 1_000_000
                q.add(ns, ns)   # the combiner genuinely waits this long
            return True
        return sink.query(q)

    # -- live transcriber swap ---------------------------------------------
    def _on_transcriber_set(self, _obj, _value) -> None:
        """Reference behavior: setting `transcriber` at PLAYING tears
        the old transcription subtree down and relinks a fresh one
        without interrupting the audio/video flow; the recorded audio
        stream events (stream-start/caps/segment) replay into the new
        transcriber so it negotiates mid-stream."""
        if not getattr(self, "_started", False):
            return                  # not started yet: start() wires it
        if self._active:
            # drain the old subtree: audio EOS first so the last
            # transcript reaches the combiner, then video EOS so
            # pending frames flush out with their captions
            from gstpu_torch.core.event import EosEvent
            self._afeed.push_event(EosEvent())
            self._vfeed.push_event(EosEvent())
        self.stop()
        if not self.start():
            self.post_error("transcriberbin: live transcriber swap "
                            "failed")
            return
        if self._active:
            for ev in self._audio_stream_events:
                self._afeed.push_event(ev)
            for ev in self._video_stream_events:
                self._vfeed.push_event(ev)

    # -- wiring ----------------------------------------------------------
    def _feeder(self, name, target):
        f = Pad(name, PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC,
                            PadPresence.ALWAYS, Caps.any()))
        f.link(target)
        return f

    def _child(self, el):
        el.bus = self.bus
        el.clock = self.clock
        self._children.append(el)
        return el

    def _build_caption_path(self):
        """transcriber output -> caption stream for the combiner.
        cea608 single language: tttocea608.  cea608 with
        translation-languages mapping to cc1/cc3: tee -> per-channel
        [translator ->] tttocea608 -> cea608mux (the reference's 608
        channel routing, transcriberbin/imp.rs:77-109, cea608mux at
        :2495).  cea708: tee -> per-language [translator ->]
        tttocea708(service N) -> cea708mux."""
        if self.mux_method == "cea608":
            langs = dict(self.translation_languages or {})
            if not langs:
                self._ttto = self._child(make("tttocea608",
                                              mode=self.mode))
                self._trans.src_pads()[0].link(
                    self._ttto.static_pad("sink"))
                return self._ttto.static_pad("src")
            # per-language 608 channel routing (primary -> cc1)
            chans = {"primary": "cc1"}
            chans.update(langs)
            bad = [c for c in chans.values() if c not in ("cc1", "cc3")]
            if bad:
                raise ValueError(
                    f"cea608 channels must be cc1/cc3, got {bad} "
                    f"(reference imp.rs:85)")
            tee = self._child(make("tee"))
            self._trans.src_pads()[0].link(tee.static_pad("sink"))
            mux = self._child(make("cea608mux"))
            translators = self.translators or {}
            for lang, chan in sorted(chans.items(),
                                     key=lambda kv: kv[1]):
                src = tee.request_pad()
                desc = translators.get(lang)
                if desc and lang != "primary":
                    from gstpu_torch.elements.utils_.fallbacksrc import \
                        _make_from_desc
                    tr = self._child(_make_from_desc(desc))
                    src.link(tr.static_pad("sink"))
                    src = tr.src_pads()[0]
                ttto = self._child(make("tttocea608", mode=self.mode))
                src.link(ttto.static_pad("sink"))
                ttto.static_pad("src").link(
                    mux.request_pad(f"sink_{chan}"))
            self._ttto = mux
            return mux.static_pad("src")
        # cea708: primary service 1 + one service per language
        langs = {"primary": 1}
        if self.translation_languages:
            langs.update(self.translation_languages)
        tee = self._child(make("tee"))
        self._trans.src_pads()[0].link(tee.static_pad("sink"))
        mux = self._child(make("cea708mux"))
        translators = self.translators or {}
        for lang, service in sorted(langs.items(),
                                    key=lambda kv: kv[1]):
            src = tee.request_pad()
            desc = translators.get(lang)
            if desc and lang != "primary":
                from gstpu_torch.elements.utils_.fallbacksrc import \
                    _make_from_desc
                tr = self._child(_make_from_desc(desc))
                src.link(tr.static_pad("sink"))
                src = tr.src_pads()[0]
            ttto = self._child(make("tttocea708", service=service))
            src.link(ttto.static_pad("sink"))
            ttto.static_pad("src").link(mux.request_pad())
        self._ttto = mux
        return mux.static_pad("src")

    def start(self) -> bool:
        self._started = True
        if not self.transcriber:
            self._active = False
            return True
        from gstpu_torch.elements.utils_.fallbacksrc import _make_from_desc
        try:
            self._trans = self._child(_make_from_desc(self.transcriber))
        except Exception as e:
            self.post_error(f"transcriberbin: cannot make transcriber "
                            f"{self.transcriber!r}: {e}")
            return False
        self._combiner = self._child(make("cccombiner"))
        self._afeed = self._feeder("afeed",
                                   self._trans.static_pad("sink"))
        caption_src = self._build_caption_path()
        self._vfeed = self._feeder("vfeed",
                                   self._combiner.request_pad("sink"))
        caption_src.link(self._combiner.request_pad())  # caption pad
        cap = _cap_pad("combined",
                       lambda p, b: self._vsrc.push(b),
                       lambda p, e: True)
        self._combiner.static_pad("src").link(cap)
        for el in self._children:
            el.set_state(State.PLAYING)
        self._active = True
        return True

    def stop(self) -> bool:
        for el in self._children:
            el.set_state(State.NULL)
        self._children = []
        self._active = False
        self._started = False
        return True

    # -- dataflow ---------------------------------------------------------
    def _strip_inband(self, buf: Buffer) -> Buffer:
        from gstpu_torch.core.video import VideoCaptionMeta
        if buf.get_meta(VideoCaptionMeta) is None:
            return buf
        out = buf.copy()
        out.metas = [m for m in out.metas
                     if not isinstance(m, VideoCaptionMeta)]
        return out

    def _video_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self.caption_source == "transcription":
            buf = self._strip_inband(buf)
        if not self._active or self.passthrough:
            return self._vsrc.push(buf)
        if self.caption_source == "inband":
            # keep upstream captions, skip the transcription combiner
            return self._vsrc.push(buf)
        return self._vfeed.push(buf)

    def _video_event(self, pad: Pad, ev: Event) -> bool:
        if ev.sticky:
            self._video_stream_events = [
                e for e in self._video_stream_events
                if type(e) is not type(ev)] + [ev]
        ok = True
        if self._active and not self.passthrough:
            ok = self._vfeed.push_event(ev)
        # the src pad needs stream events even while combining is off
        ok = self._vsrc.push_event(ev) and ok
        return ok

    def _audio_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._active:
            self._afeed.push(buf.copy())
        return self._asrc.push(buf)

    def _audio_event(self, pad: Pad, ev: Event) -> bool:
        # remember the sticky stream events so a live transcriber swap
        # can replay them into the fresh subtree
        if ev.sticky:
            self._audio_stream_events = [
                e for e in self._audio_stream_events
                if type(e) is not type(ev)] + [ev]
        if self._active:
            self._afeed.push_event(ev)
        return self._asrc.push_event(ev)


@register_element("translationbin", Rank.NONE)
class TranslationBin(TranscriberBin):
    """transcriberbin with a translation stage: the transcript runs
    through a pluggable `translator` element (text/x-raw in and out)
    before caption encoding (reference translationbin wires cloud
    translators; any local element description works here)."""

    translator = Property(str, default=None, mutable=Mutability.READY,
                          blurb="Translator element description "
                                "(text/x-raw in/out)")

    def start(self) -> bool:
        if not super().start():
            return False
        if not self._active or not self.translator:
            return True
        if self.mux_method != "cea608":
            # with cea708 muxing, per-language translators belong in
            # `translators` (they feed distinct DTVCC services)
            self.post_error("translationbin: use translators= with "
                            "mux-method=cea708")
            return False
        from gstpu_torch.elements.utils_.fallbacksrc import _make_from_desc
        try:
            trans = _make_from_desc(self.translator)
        except Exception as e:
            self.post_error(f"translationbin: bad translator: {e}")
            return False
        trans.bus = self.bus
        trans.set_state(State.PLAYING)
        # splice: transcriber -> translator -> tttocea608
        self._trans.src_pads()[0].unlink()
        self._trans.src_pads()[0].link(trans.static_pad("sink"))
        trans.src_pads()[0].link(self._ttto.static_pad("sink"))
        self._translator = trans
        return True

    def stop(self) -> bool:
        tr = getattr(self, "_translator", None)
        if tr is not None:
            tr.set_state(State.NULL)
        return super().stop()
