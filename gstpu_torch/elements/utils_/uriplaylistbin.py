"""uriplaylistbin: gapless playlist playback.

Rebuilds the reference utils/uriplaylistbin (gapless playlist over
uridecodebin3). Here, file: URIs are resolved to filesrc + a decoder
chosen by extension (.flac -> claxondec, .flv -> rsflvdemux, images ->
imagedecoder, raw/scc passthrough); each item's timestamps are rebased
onto the running end of the previous item for gapless output.

The port's copy of gstpu/elements/utils_/uriplaylistbin.py: the items'
buffers pass unread.
"""

from __future__ import annotations

from urllib.parse import unquote, urlparse

from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowReturn, Pad, PadDirection,
                                      PadPresence, PadTemplate, State)
from gstpu_torch.core.event import (CapsEvent, EosEvent, Event, Segment,
                                    SegmentEvent, StreamStartEvent)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, make, register_element
from gstpu_torch.runtime.scheduler import Task, TaskResult

_DECODERS = {
    ".flac": "claxondec",
    ".png": "imagedecoder",
    ".jpg": "imagedecoder",
    ".gif": "gifdec",
}
_SINK_CAPS_FOR = {
    ".flac": "audio/x-flac",
    ".png": "image/png",
    ".jpg": "image/jpeg",
    ".gif": "image/gif",
}


@register_element("uriplaylistbin", Rank.NONE)
class UriPlaylistBin(Element):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS, Caps.any())]

    uris = Property(list, default=None, mutable=Mutability.READY)
    iterations = Property(int, default=1, minimum=0,
                          mutable=Mutability.READY,
                          blurb="0 = loop forever")

    SIGNALS = ("about-to-finish",)

    def __init__(self, name=None):
        super().__init__(name)
        self.srcpad = self.static_pad("src")
        self._chain: list[Element] = []
        self._cap: Pad | None = None
        self._item = 0
        self._iteration = 0
        self._base_offset = 0       # pts rebase for gapless output
        self._item_end = 0
        self._started = False
        self._caps_sent: Caps | None = None

    def _build_item(self, uri: str) -> bool:
        u = urlparse(uri)
        if u.scheme in ("http", "https"):
            # http(s) items route through reqwesthttpsrc, like the
            # reference's uridecodebin3 source selection
            path = unquote(u.path)
            src = make("reqwesthttpsrc", location=uri)
        elif u.scheme in ("file", ""):
            path = unquote(u.path)
            src = make("filesrc", location=path)
        else:
            self.post_error(f"uriplaylistbin: unsupported scheme "
                            f"{u.scheme!r}")
            return False
        ext = "." + path.rsplit(".", 1)[-1].lower()
        chain = [src]
        if ext in _DECODERS:
            from gstpu_torch.core.caps import parse_caps
            if u.scheme in ("http", "https"):
                # the http source doesn't typefind; stamp the caps
                # the extension implies
                src.set_property("caps",
                                 parse_caps(_SINK_CAPS_FOR[ext]))
            cf = make("capsfilter")
            cf.set_property("caps", parse_caps(_SINK_CAPS_FOR[ext]))
            dec = make(_DECODERS[ext])
            src.link(cf)
            cf.link(dec)
            chain += [cf, dec]
        cap = Pad("cap", PadDirection.SINK,
                  PadTemplate("sink", PadDirection.SINK,
                              PadPresence.ALWAYS, Caps.any()))
        cap.chain_function = self._on_buffer
        cap.event_function = self._on_event
        chain[-1].src_pads()[0].link(cap)
        for el in chain:
            el.clock = self.clock
            el.bus = self.bus
            if el.set_state(State.PLAYING).value == "failure":
                return False
        self._chain = chain
        self._cap = cap
        self._tasks = []
        for el in chain:
            for t in el.iterate_tasks():
                t.prepare()
                t.start()
                self._tasks.append(t)
        return True

    def _teardown_item(self) -> None:
        for el in self._chain:
            el.set_state(State.NULL)
        self._chain = []
        self._tasks = []

    def _on_buffer(self, pad: Pad, buf: Buffer) -> FlowReturn:
        out = buf.copy()
        if out.pts is not None:
            out.pts += self._base_offset
            self._item_end = max(self._item_end,
                                 out.pts + (out.duration or 0))
        return self.srcpad.push(out)

    def _on_event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, CapsEvent):
            if self._caps_sent != ev.caps:
                self._caps_sent = ev.caps
                return self.srcpad.push_event(ev)
            return True
        if isinstance(ev, EosEvent):
            return True  # item done: the task advances the playlist
        if isinstance(ev, (StreamStartEvent, SegmentEvent)):
            return True
        return self.srcpad.push_event(ev)

    def start(self) -> bool:
        if not self.uris:
            self.post_error("uriplaylistbin: no uris set")
            return False
        return True

    def stop(self) -> bool:
        self._teardown_item()
        return True

    def iterate_tasks(self):
        return (Task(self.name, self._iterate),)

    def _iterate(self) -> TaskResult:
        if not self._started:
            self.srcpad.push_event(StreamStartEvent(f"{self.name}/src"))
            self.srcpad.push_event(SegmentEvent(Segment()))
            self._started = True
            if not self._build_item(self.uris[0]):
                return TaskResult.ERROR
        worked = False
        item_eos = self._cap is not None and self._cap.peer is not None \
            and self._cap.peer.eos
        for t in list(self._tasks):
            r = t.run_once()
            if r is TaskResult.CONTINUE:
                worked = True
            elif r is TaskResult.ERROR:
                return TaskResult.ERROR
        if not worked and all(
                t.state.value in ("eos", "stopped", "error")
                for t in self._tasks):
            # current item finished: advance gaplessly
            self._teardown_item()
            self._item += 1
            self._base_offset = self._item_end
            if self._item >= len(self.uris):
                self._iteration += 1
                if self.iterations and self._iteration >= self.iterations:
                    self.srcpad.push_event(EosEvent())
                    return TaskResult.EOS
                self._item = 0
            if self._item == len(self.uris) - 1:
                self.emit("about-to-finish")
            if not self._build_item(self.uris[self._item]):
                return TaskResult.ERROR
            return TaskResult.CONTINUE
        return TaskResult.CONTINUE if worked else TaskResult.IDLE
