"""fallbacksrc: self-healing supervisory source.

Rebuilds the reference fallbacksrc
(utils/fallbackswitch/src/fallbacksrc/imp.rs:41-224): wraps a primary
source element and an optional fallback source; monitors dataflow
health, switches to the fallback when the primary stalls or errors,
and retries the primary with a restart timeout. Exposes `statistics`
like the reference's property.

In this framework sources are wrapped directly (the reference wraps
URIs via uridecodebin): set `source` / `fallback-source` to element
factory strings parsed like gst-launch fragments (e.g.
"audiotestsrc freq=440").

The port's copy of gstpu/elements/utils_/fallbacksrc.py: its http branch
runs the port's `reqwesthttpsrc`.
"""

from __future__ import annotations

import shlex

from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Bus, Element, FlowReturn, Message,
                                      MessageType, Pad, PadDirection,
                                      PadPresence, PadTemplate, State)
from gstpu_torch.core.event import (CapsEvent, EosEvent, Event, Segment,
                                    SegmentEvent, StreamStartEvent)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, make, register_element
from gstpu_torch.runtime.scheduler import Task, TaskResult

SECOND = 1_000_000_000


def _make_from_desc(desc: str):
    parts = shlex.split(desc)
    el = make(parts[0])
    for tok in parts[1:]:
        k, _, v = tok.partition("=")
        from gstpu_torch.core.parse import _parse_prop_value
        el.set_property(k, _parse_prop_value(v))
    return el


_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".gif", ".webp", ".bmp")


@register_element("fallbacksrc", Rank.NONE)
class FallbackSrc(Element):
    """Retry reasons and statistics fields mirror the reference
    (fallbacksrc/mod.rs:18-24 RetryReason, imp.rs:41-79 Stats): an
    image fallback-uri builds an internal still-image loop source
    (the reference's imagefreeze path, imp.rs:2084-2095); children
    run on a PRIVATE bus so their errors/EOS/buffering are handled by
    the supervisor instead of failing the pipeline."""

    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS, Caps.any())]

    source = Property(str, default=None, mutable=Mutability.READY,
                      blurb="Primary source description")
    fallback_source = Property(str, default=None,
                               mutable=Mutability.READY)
    uri = Property(str, default=None, mutable=Mutability.READY,
                   blurb="Primary as a URI (file:/http(s):), like the "
                         "reference's uri property; overrides source")
    fallback_uri = Property(str, default=None,
                            mutable=Mutability.READY)
    timeout = Property(int, default=5 * SECOND, minimum=1,
                       mutable=Mutability.READY,
                       blurb="Stall timeout before failover (ns)")
    restart_timeout = Property(int, default=5 * SECOND, minimum=0,
                               mutable=Mutability.READY,
                               blurb="Primary retry interval (ns)")
    retry_timeout = Property(int, default=60 * SECOND, minimum=0,
                             mutable=Mutability.READY,
                             blurb="Give up retrying the primary "
                                   "after this long (0 = forever)")
    restart_on_eos = Property(bool, default=False,
                              mutable=Mutability.READY,
                              blurb="Restart the primary on EOS "
                                    "instead of ending the stream")
    immediate_fallback = Property(bool, default=False,
                                  mutable=Mutability.READY,
                                  blurb="Start on the fallback until "
                                        "the primary produces")
    enable_dummy = Property(bool, default=False,
                            mutable=Mutability.READY,
                            blurb="Synthesize a dummy fallback "
                                  "(videotestsrc black / silence) "
                                  "when none is configured")
    manual_unblock = Property(bool, default=False,
                              mutable=Mutability.READY,
                              blurb="Hold output until unblock() "
                                    "(reference manual-unblock + "
                                    "unblock signal)")
    enable_video = Property(
        bool, default=True, mutable=Mutability.READY,
        blurb="Video is expected: enable-dummy synthesizes black "
              "video while no real fallback exists (reference "
              "enable-video; gstpu's fallbacksrc is single-stream, "
              "so this selects what the dummy produces rather than "
              "adding a second pad)")
    enable_audio = Property(
        bool, default=True, mutable=Mutability.READY,
        blurb="Audio is expected: with enable-video off, "
              "enable-dummy synthesizes silence instead of black "
              "video (reference enable-audio; single-stream note as "
              "on enable-video)")
    buffer_duration = Property(
        int, default=-1, minimum=-1, mutable=Mutability.READY,
        blurb="Buffer duration (ns) handed to child sources that "
              "expose a buffer-duration property; -1 = their "
              "default (reference buffer-duration)")
    min_latency = Property(
        int, default=0, minimum=0, mutable=Mutability.READY,
        blurb="Extra latency granted to the PRIMARY before a stall "
              "fails it over — for main sources inherently slower "
              "than the fallback (reference min-latency)")

    SIGNALS = ("status-changed", "unblock")

    def __init__(self, name=None):
        super().__init__(name)
        self.srcpad = self.static_pad("src")
        self._primary: Element | None = None
        self._fallback: Element | None = None
        self._active: Element | None = None
        self._capture: Pad | None = None
        self._last_buffer_time: int | None = None
        self._primary_failed_at: int | None = None
        self.stats = {"num-retry": 0, "num-fallback-retry": 0,
                      "last-retry-reason": "none",
                      "last-fallback-retry-reason": "none",
                      "buffering-percent": 100,
                      "fallback-buffering-percent": 100,
                      "num-fallback-switches": 0,
                      "using-fallback": False,
                      "last-retry-time": None}
        self._blocked = False
        self._first_failed_at: int | None = None
        self._child_bus: Bus | None = None
        self._status = "stopped"
        self.connect("unblock", lambda *a: self.unblock())

    # -- statistics property (reference imp.rs:41-79 Stats) -------------
    @property
    def statistics(self) -> dict:
        return dict(self.stats)

    @property
    def status(self) -> str:
        """stopped | buffering | retrying | running (reference
        GstFallbackSourceStatus)."""
        if self._active is None:
            return "stopped"
        if self._active is self._fallback \
                and self._primary_failed_at is not None:
            return "retrying"
        pct = self.stats["fallback-buffering-percent"] \
            if self._active is self._fallback \
            else self.stats["buffering-percent"]
        return "buffering" if pct < 100 else "running"

    def _now(self) -> int:
        return (self.clock.time() - self.base_time) if self.clock else 0

    def _wire(self, el: Element) -> None:
        cap = Pad("cap", PadDirection.SINK,
                  PadTemplate("sink", PadDirection.SINK,
                              PadPresence.ALWAYS, Caps.any()))
        cap.chain_function = self._on_child_buffer
        cap.event_function = self._on_child_event
        for sp in el.src_pads():
            if not sp.is_linked():
                sp.link(cap)
                break
        self._capture = cap

    def unblock(self) -> None:
        """Release output held by manual-unblock (reference's unblock
        action signal)."""
        self._blocked = False

    def _on_child_buffer(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self._last_buffer_time = self._now()
        if self._blocked:
            return FlowReturn.OK           # held until unblock()
        return self.srcpad.push(buf)

    def _on_child_event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, EosEvent) and self._active is self._primary:
            if self.restart_on_eos:
                # reference restart-on-eos: loop the primary
                self._count_retry("eos")
                self._primary = self._make_primary()
                self._activate(self._primary)
                return True
            if self._fallback is not None:
                # primary ended unexpectedly: fail over instead of EOS
                self._fail_primary("eos")
                return True
        return self.srcpad.push_event(ev)

    def _count_retry(self, reason: str) -> None:
        if self._active is self._fallback:
            self.stats["num-fallback-retry"] += 1
            self.stats["last-fallback-retry-reason"] = reason
        else:
            self.stats["num-retry"] += 1
            self.stats["last-retry-reason"] = reason

    # -- source construction ------------------------------------------------
    @staticmethod
    def _desc_for_uri(uri: str) -> str:
        from urllib.parse import urlparse
        u = urlparse(uri)
        if u.scheme in ("http", "https"):
            return f"reqwesthttpsrc location={uri}"
        return f"filesrc location={u.path or uri}"

    def _make_primary(self) -> Element:
        if self.uri:
            return _make_from_desc(self._desc_for_uri(self.uri))
        return _make_from_desc(self.source)

    def _make_fallback(self) -> Element | None:
        if self.fallback_uri:
            from urllib.parse import urlparse
            path = urlparse(self.fallback_uri).path or self.fallback_uri
            if path.lower().endswith(_IMAGE_EXTS):
                # reference: an image fallback-uri becomes an
                # imagefreeze loop (imp.rs:2084-2095, is_image)
                return _ImageLoopSrc.from_file(path)
            return _make_from_desc(self._desc_for_uri(
                self.fallback_uri))
        if self.fallback_source:
            return _make_from_desc(self.fallback_source)
        if self.enable_dummy:
            # reference enable-dummy: synthesized signal — black
            # video when video is enabled, else silence
            if self.enable_video:
                return _make_from_desc("videotestsrc pattern=black")
            if self.enable_audio:
                return _make_from_desc("audiotestsrc wave=silence")
        return None

    def start(self) -> bool:
        if not self.source and not self.uri:
            self.post_error("fallbacksrc: no source configured")
            return False
        self._blocked = bool(self.manual_unblock)
        self._primary = self._make_primary()
        self._fallback = self._make_fallback()
        if self.buffer_duration >= 0:
            for child in (self._primary, self._fallback):
                if child is None:
                    continue
                try:        # children that buffer honor the budget
                    child.set_property("buffer-duration",
                                       self.buffer_duration)
                except (KeyError, PermissionError):
                    pass
        if self.immediate_fallback and self._fallback is not None:
            # reference immediate-fallback: output the fallback until
            # the primary actually produces
            self._primary_failed_at = self._now()
            self._activate(self._fallback)
        else:
            self._activate(self._primary)
        return True

    def _activate(self, el: Element) -> None:
        if self._active is not None:
            for sp in self._active.src_pads():
                sp.unlink()
            self._active.set_state(State.NULL)
        el.clock = self.clock
        el.base_time = self.base_time
        # children post to a PRIVATE bus: their errors/EOS/buffering
        # are supervision input, not application-facing failures
        self._child_bus = Bus()
        el.bus = self._child_bus
        self._wire(el)
        el.set_state(State.PLAYING)
        self._active = el
        # drive the child's tasks from our supervision task so that
        # runtime failovers keep flowing without rewiring the scheduler
        self._child_tasks = []
        for t in el.iterate_tasks():
            t.prepare()
            t.start()
            self._child_tasks.append(t)
        self._last_buffer_time = self._now()
        self.stats["using-fallback"] = el is self._fallback
        self.emit("status-changed",
                  "fallback" if el is self._fallback else "primary")
        self.post_element_message(
            "fallbacksrc-status",
            using_fallback=self.stats["using-fallback"])

    def _fail_primary(self, reason: str = "error") -> None:
        self._primary_failed_at = self._now()
        self.stats["last-retry-reason"] = reason
        if self._fallback is not None:
            self.stats["num-fallback-switches"] += 1
            self._activate(self._fallback)

    def stop(self) -> bool:
        for el in (self._primary, self._fallback):
            if el is not None:
                el.set_state(State.NULL)
        self._active = None
        return True

    # -- supervision ----------------------------------------------------
    def iterate_tasks(self):
        return (Task(f"{self.name}-supervise", self._supervise),)

    def _supervise(self) -> TaskResult:
        worked = False
        for t in list(getattr(self, "_child_tasks", [])):
            r = t.run_once()
            if r is TaskResult.CONTINUE:
                worked = True
        self._drain_child_bus()
        now = self._now()
        if self._active is self._primary \
                and self._last_buffer_time is not None \
                and now - self._last_buffer_time \
                > self.timeout + self.min_latency \
                and self._fallback is not None:
            # min-latency grants an inherently-slower primary extra
            # headroom before failover (reference min-latency)
            self._fail_primary("timeout")
            return TaskResult.CONTINUE
        if self._active is self._fallback \
                and self._primary_failed_at is not None \
                and self.restart_timeout \
                and now - self._primary_failed_at > self.restart_timeout:
            if self._first_failed_at is None:
                self._first_failed_at = self._primary_failed_at
            if self.retry_timeout \
                    and now - self._first_failed_at > self.retry_timeout:
                # reference retry-timeout: stop retrying, stay on
                # the fallback for good
                self._primary_failed_at = None
                self.post_element_message("fallbacksrc-retry-exhausted")
                return TaskResult.CONTINUE
            # retry the primary
            self.stats["num-retry"] += 1
            self.stats["last-retry-time"] = now
            self._primary = self._make_primary()
            self._primary_failed_at = None
            self._activate(self._primary)
            return TaskResult.CONTINUE
        return TaskResult.CONTINUE if worked else TaskResult.IDLE

    def _drain_child_bus(self) -> None:
        """Supervision input: the reference watches its internal
        source bin's bus for Error/Buffering (imp.rs:1098,
        handle_buffering :3013)."""
        bus = self._child_bus
        if bus is None:
            return
        while (m := bus.pop()) is not None:
            if m.type is MessageType.ERROR:
                if self._active is self._primary:
                    self._fail_primary("error")
                else:
                    # fallback itself failed: rebuild it
                    self.stats["num-fallback-retry"] += 1
                    self.stats["last-fallback-retry-reason"] = "error"
                    self._fallback = self._make_fallback()
                    if self._fallback is not None:
                        self._activate(self._fallback)
            elif m.type is MessageType.BUFFERING:
                pct = int(m.fields.get("percent", 100))
                key = "fallback-buffering-percent" \
                    if self._active is self._fallback \
                    else "buffering-percent"
                self.stats[key] = pct
                if pct == 100:
                    # a fully-buffered source counts as producing
                    self._last_buffer_time = self._now()
            else:
                # metrics and warnings flow through to the app
                if self.bus is not None and m.type in (
                        MessageType.ELEMENT, MessageType.WARNING,
                        MessageType.INFO):
                    self.bus.post(m)


class _ImageLoopSrc(Element):
    """Internal still-image loop source (the reference builds
    imagefreeze into its fallback branch for image URIs)."""

    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS, Caps.any())]

    framerate = 30

    @classmethod
    def from_file(cls, path: str) -> "_ImageLoopSrc":
        from PIL import Image
        import numpy as np
        img = Image.open(path).convert("RGBA")
        el = cls()
        el._frame = np.asarray(img, dtype=np.uint8)
        return el

    def __init__(self, name=None):
        super().__init__(name)
        self.srcpad = self.static_pad("src")
        self._frame = None
        self._n = 0
        self._started = False

    def iterate_tasks(self):
        return (Task(f"{self.name}-imageloop", self._produce),)

    def _produce(self) -> TaskResult:
        if self._frame is None:
            return TaskResult.IDLE
        if not self._started:
            from gstpu_torch.core.caps import Caps as _C
            h, w = self._frame.shape[:2]
            self.srcpad.push_event(StreamStartEvent("imageloop"))
            self.srcpad.push_event(CapsEvent(_C.new(
                "video/x-raw", format="RGBA", width=w, height=h,
                framerate=(self.framerate, 1))))
            self.srcpad.push_event(SegmentEvent(Segment()))
            self._started = True
        pts = self._n * SECOND // self.framerate
        self._n += 1
        self.srcpad.push(Buffer(self._frame, pts=pts,
                                duration=SECOND // self.framerate))
        return TaskResult.CONTINUE
