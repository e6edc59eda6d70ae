"""appsrc / appsink: application ↔ pipeline data exchange.

Rebuilds gst-app's AppSrc/AppSink, the capture mechanism every
reference test uses (audio/audiofx/tests/audioloudnorm.rs appsink
callbacks; gst_utils::StreamProducer is appsink→appsrc forwarding).
"""

from __future__ import annotations

from collections import deque
from typing import Callable

from gstpu_torch.core.base import BaseSink, PushSrc
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowError, FlowReturn, PadDirection,
                                PadPresence, PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element


@register_element("appsrc", Rank.NONE)
class AppSrc(PushSrc):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS, Caps.any())]

    caps = Property(Caps, default=None, mutable=Mutability.PLAYING)
    block = Property(bool, default=False)
    is_live_prop = Property(bool, default=False)

    def __init__(self, name=None):
        super().__init__(name)
        self._q: deque = deque()
        self._eos = False

    def push_buffer(self, buf: Buffer) -> None:
        self._q.append(buf)

    def end_of_stream(self) -> None:
        self._eos = True

    def negotiate(self):
        if self.caps is not None:
            return self.caps
        return super().negotiate()

    def create(self) -> Buffer | None:
        if self._q:
            return self._q.popleft()
        if self._eos:
            return None
        raise FlowError(FlowReturn.FLUSHING, "appsrc starved")


@register_element("appsink", Rank.NONE)
class AppSink(BaseSink):
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS, Caps.any())]

    SIGNALS = ("new-sample", "eos")
    emit_signals = Property(bool, default=False, mutable=Mutability.PLAYING)

    def __init__(self, name=None):
        super().__init__(name)
        self.samples: deque[Buffer] = deque()
        self.is_eos = False
        self.new_sample_callback: Callable[[Buffer, Caps | None], None] | None = None

    def render(self, buf: Buffer):
        self.samples.append(buf)
        if self.new_sample_callback is not None:
            self.new_sample_callback(buf, self.caps)
        if self.emit_signals:
            self.emit("new-sample", buf)
        return FlowReturn.OK

    def on_eos(self) -> None:
        self.is_eos = True
        if self.emit_signals:
            self.emit("eos")

    def pull_sample(self) -> Buffer | None:
        return self.samples.popleft() if self.samples else None

    def pull_all(self) -> list[Buffer]:
        out = list(self.samples)
        self.samples.clear()
        return out
