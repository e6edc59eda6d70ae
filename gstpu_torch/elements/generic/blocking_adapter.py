"""ts-blocking-adapter: hand serialized items to a dedicated src
thread so a blocking downstream (clock-sync sink, bounded blocking
queue) cannot stall the shared cooperative context.

Rebuilds the reference's threadshare blocking adapter
(generic/threadshare/src/blocking_adapter/imp.rs): the sink pad
forwards buffers/serialized events to the src-pad task thread through
a rendezvous channel, which applies backpressure to upstream while
letting other tasks on the shared context keep running.

The port's copy of gstpu/elements/generic/blocking_adapter.py: the
buffer, a tensor included, is handed to the src thread unread.
"""

from __future__ import annotations

import queue
import threading

from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowReturn, Pad,
                                      PadDirection, PadPresence, PadTemplate)
from gstpu_torch.core.event import EosEvent, Event
from gstpu_torch.core.registry import Rank, register_element

_STOP = object()


@register_element("ts-blocking-adapter", Rank.NONE)
class TsBlockingAdapter(Element):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    Caps.any()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    Caps.any()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self.sinkpad = self.static_pad("sink")
        self.srcpad = self.static_pad("src")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        # rendezvous: capacity 1 so upstream feels downstream pressure
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._thread: threading.Thread | None = None
        self._flow = FlowReturn.OK

    # -- lifecycle ------------------------------------------------------
    def ready_to_paused(self) -> bool:
        self._flow = FlowReturn.OK
        self._thread = threading.Thread(target=self._loop,
                                        name=f"{self.name}-src",
                                        daemon=True)
        self._thread.start()
        return True

    def paused_to_ready(self) -> bool:
        if self._thread is not None:
            try:
                self._q.put(_STOP, timeout=5)
            except queue.Full:
                pass                      # downstream wedged: detach
            self._thread.join(timeout=5)
            self._thread = None
        # drop anything left queued
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        return True

    # -- sink side (cooperative context) ---------------------------------
    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._flow is not FlowReturn.OK:
            return self._flow
        if self._thread is None:
            return FlowReturn.FLUSHING
        self._q.put(buf)
        return FlowReturn.OK

    def _event(self, pad: Pad, ev: Event) -> bool:
        if ev.serialized and self._thread is not None:
            self._q.put(ev)
            return True
        return self.srcpad.push_event(ev)

    # -- src side (dedicated thread; may block on downstream) ------------
    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            if isinstance(item, Buffer):
                ret = self.srcpad.push(item)
                if ret not in (FlowReturn.OK, FlowReturn.FLUSHING):
                    self._flow = ret
            else:
                self.srcpad.push_event(item)
                if isinstance(item, EosEvent):
                    return
