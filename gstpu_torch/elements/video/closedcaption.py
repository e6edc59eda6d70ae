"""tttocea608 / cea608tott / ccdetect: closed-caption elements.

The first slice of the reference's closedcaption stack
(video/closedcaption: tttocea608, cea608tott, ccdetect) built on
gstpu_torch.codecs.cea608. Caps: closedcaption/x-cea-608, format=raw, one
2-byte pair per buffer (field rate pacing handled by pts spacing).

The port's copy of gstpu/elements/video/closedcaption.py, as it stands.
"""

from __future__ import annotations

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowReturn, Pad, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.codecs.cea608 import Cea608Decoder, Cea608Encoder

SECOND = 1_000_000_000

CC_CAPS = Caps.new("closedcaption/x-cea-608", format="raw")
TEXT_CAPS = Caps.new("text/x-raw", format="utf8")


def _tmpl(name, d, caps):
    return PadTemplate(name, d, PadPresence.ALWAYS, caps.copy())


@register_element("tttocea608", Rank.NONE)
class TtToCea608(BaseTransform):
    """Timed text -> CEA-608 pop-on byte pairs
    (reference video/closedcaption tttocea608)."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK, TEXT_CAPS),
                     _tmpl("src", PadDirection.SRC, CC_CAPS)]

    framerate_num = Property(int, default=30, minimum=1,
                             mutable=Mutability.READY)
    mode = Property(str, default="pop-on", mutable=Mutability.READY,
                    enum_values=("pop-on", "roll-up2", "roll-up3",
                                 "roll-up4"),
                    blurb="Caption mode (reference tttocea608 mode)")
    origin_row = Property(int, default=-1, minimum=-1, maximum=14,
                          mutable=Mutability.PLAYING,
                          blurb="Base caption row; -1 = automatic "
                                "(bottom) — reference origin-row")
    origin_column = Property(int, default=0, minimum=0, maximum=31,
                             mutable=Mutability.PLAYING,
                             blurb="Caption indent column (PAC "
                                   "indent steps of 4) — reference "
                                   "origin-column")
    roll_up_timeout = Property(
        int, default=0, minimum=0, mutable=Mutability.PLAYING,
        blurb="Erase display memory after this much ns without new "
              "text in roll-up mode; 0 = never (reference "
              "roll-up-timeout, erased via the gap/next-buffer "
              "path in this cooperative runtime)")

    def __init__(self, name=None):
        super().__init__(name)
        self._enc = Cea608Encoder()
        self._last_text_pts: int | None = None

    def transform_caps(self, direction, caps, filter):
        out = (CC_CAPS if direction is PadDirection.SINK
               else TEXT_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> list[Buffer]:
        text = buf.to_bytes().decode("utf-8")
        row = self.origin_row if self.origin_row >= 0 else 14
        col = self.origin_column
        pairs = []
        if self.mode.startswith("roll-up"):
            if self.roll_up_timeout and buf.pts is not None \
                    and self._last_text_pts is not None \
                    and buf.pts - self._last_text_pts \
                    > self.roll_up_timeout:
                # reference roll-up-timeout: stale display memory is
                # erased before the new text
                pairs.extend(self._enc.encode_clear())
            pairs.extend(self._enc.encode_rollup(
                text, rows=int(self.mode[-1]), base_row=row,
                column=col))
        else:
            pairs.extend(self._enc.encode_popon(text, row=row,
                                                column=col))
        self._last_text_pts = buf.pts
        field_dur = SECOND // (self.framerate_num or 30)
        base = buf.pts if buf.pts is not None else 0
        out = []
        for i, pair in enumerate(pairs):
            out.append(Buffer(pair, pts=base + i * field_dur,
                              duration=field_dur))
        return out


@register_element("cea608tott", Rank.NONE)
class Cea608ToTt(BaseTransform):
    """CEA-608 byte pairs -> timed text
    (reference video/closedcaption cea608tott)."""

    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK, CC_CAPS),
                     _tmpl("src", PadDirection.SRC, TEXT_CAPS)]

    def __init__(self, name=None):
        super().__init__(name)
        self._dec = Cea608Decoder()

    def transform_caps(self, direction, caps, filter):
        out = (TEXT_CAPS if direction is PadDirection.SINK
               else CC_CAPS).copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def transform(self, buf: Buffer) -> Buffer | None:
        text = self._dec.push_pair(buf.to_bytes())
        if text is None:
            return None
        return Buffer(text.encode("utf-8"), pts=buf.pts)

    def flush(self) -> None:
        self._dec = Cea608Decoder()


@register_element("ccdetect", Rank.NONE)
class CcDetect(BaseTransform):
    """Passthrough detector posting cc608/cc708 presence changes
    (reference video/closedcaption ccdetect)."""

    IN_PLACE = True
    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK, CC_CAPS),
                     _tmpl("src", PadDirection.SRC, CC_CAPS)]

    window = Property(int, default=10 * SECOND, minimum=0,
                      mutable=Mutability.PLAYING,
                      blurb="Silence window before cc considered absent")

    def __init__(self, name=None):
        super().__init__(name)
        self._present = None
        self._last_active_pts = None

    def transform_ip(self, buf: Buffer) -> None:
        from gstpu_torch.codecs.cea608 import strip_parity
        data = buf.to_bytes()
        active = len(data) >= 2 and any(
            (strip_parity(b) or 0) >= 0x10 for b in data[:2])
        if active:
            self._last_active_pts = buf.pts
        present = active or (
            self._last_active_pts is not None and buf.pts is not None
            and buf.pts - self._last_active_pts <= self.window)
        if present != self._present:
            self._present = present
            self.post_element_message("ccdetect", cc608=present)


@register_element("cea608mux", Rank.NONE)
class Cea608Mux(Element):
    """Mux cc1 (field 1) and cc3 (field 2) CEA-608 pair streams into
    one s334-1a stream.

    The reference transcriberbin relies on the C `cea608mux` for its
    cea608 mux-method with per-language channel routing
    (transcriberbin/imp.rs:2495, channels cc1/cc3 at :77-109); this is
    that element's role rebuilt: pts-ordered merge, each pair tagged
    with its field byte (0x80 = field 1/cc1, 0x00 = field 2/cc3 —
    the convention gstpu's cea608tocea708 parses)."""

    PAD_TEMPLATES = [
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.new("closedcaption/x-cea-608",
                             format="s334-1a")),
        PadTemplate("sink_%s", PadDirection.SINK, PadPresence.REQUEST,
                    CC_CAPS.copy()),
    ]

    _FIELD_BYTE = {"cc1": 0x80, "cc3": 0x00}

    def __init__(self, name=None):
        super().__init__(name)
        self.srcpad = self.static_pad("src")
        self._queues: dict[str, list] = {}
        self._eos: set[str] = set()
        self._sent_stream_start = False

    def request_pad(self, name: str | None = None) -> Pad:
        chan = (name or f"sink_cc{1 + 2 * len(self._queues)}") \
            .removeprefix("sink_")
        if chan not in self._FIELD_BYTE:
            raise ValueError(f"cea608mux: channel {chan!r} (valid: "
                             f"cc1, cc3)")
        pad = Pad(f"sink_{chan}", PadDirection.SINK,
                  self.PAD_TEMPLATES[1], element=self)
        self._queues[chan] = []
        pad.chain_function = \
            lambda p, b, c=chan: self._chain(c, b)
        pad.event_function = \
            lambda p, e, c=chan: self._event(c, e)
        self.add_pad(pad)
        return pad

    def _chain(self, chan: str, buf: Buffer) -> FlowReturn:
        self._queues[chan].append(buf)
        self._drain(False)
        return FlowReturn.OK

    def _event(self, chan: str, ev) -> bool:
        from gstpu_torch.core.event import (CapsEvent, EosEvent,
                                            SegmentEvent, StreamStartEvent)
        if isinstance(ev, EosEvent):
            self._eos.add(chan)
            self._drain(True)
            if self._eos >= set(self._queues):
                return self.srcpad.push_event(ev)
            return True
        if isinstance(ev, (CapsEvent, StreamStartEvent, SegmentEvent)):
            if self._sent_stream_start:
                return True             # one output stream
            if isinstance(ev, CapsEvent):
                self._sent_stream_start = True
                from gstpu_torch.core.event import CapsEvent as _CE
                return self.srcpad.push_event(_CE(Caps.new(
                    "closedcaption/x-cea-608", format="s334-1a")))
            return self.srcpad.push_event(ev)
        return self.srcpad.push_event(ev)

    def _drain(self, force: bool) -> None:
        """pts-ordered merge: pop from whichever channel is earliest
        while every non-EOS channel has data (or force at EOS)."""
        while True:
            heads = [(q[0].pts if q[0].pts is not None else 0, c)
                     for c, q in self._queues.items() if q]
            waiting = [c for c, q in self._queues.items()
                       if not q and c not in self._eos]
            if not heads or (waiting and not force):
                return
            _, chan = min(heads)
            buf = self._queues[chan].pop(0)
            pairs = buf.to_bytes()
            fb = self._FIELD_BYTE[chan]
            out = b"".join(bytes((fb,)) + pairs[i:i + 2]
                           for i in range(0, len(pairs) - 1, 2))
            self.srcpad.push(Buffer(out, pts=buf.pts,
                                    duration=buf.duration))
