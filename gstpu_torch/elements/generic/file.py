"""rsfilesrc / rsfilesink: file I/O elements.

Rebuilds the reference's Rust file elements
(generic/file/src/{filesrc,filesink}, 935 LoC): chunked reads with
offset tracking, buffered writes.

The port's copy of gstpu/elements/generic/file.py: reads payloads
through `Buffer.to_bytes()`, so a tensor payload is downloaded before it
is written.
"""

from __future__ import annotations

from gstpu_torch.core.base import BaseSink, PushSrc
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (FlowReturn, PadDirection, PadPresence,
                                      PadTemplate)
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element


@register_element("filesrc", Rank.PRIMARY)
class FileSrc(PushSrc):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                                 Caps.any())]

    location = Property(str, default=None, mutable=Mutability.READY)
    blocksize = Property(int, default=64 * 1024, minimum=1)

    def __init__(self, name=None):
        super().__init__(name)
        self._f = None
        self._offset = 0

    def negotiate(self) -> Caps:
        # typefind-lite: adopt downstream's preferred caps when it has
        # an opinion (e.g. `filesrc ! audio/x-flac ! claxondec`)
        peer = self.srcpad.peer_query_caps()
        if not peer.is_any() and not peer.is_empty():
            return peer.fixate()
        return Caps.new("application/octet-stream")

    def start(self) -> bool:
        if not self.location:
            self.post_error("filesrc: no location set")
            return False
        self._f = open(self.location, "rb")
        self._offset = 0
        # pull-mode scheduling: files are random-access
        self.srcpad.get_range_function = self._get_range
        return True

    def _get_range(self, pad, offset: int, size: int) -> bytes:
        import os
        fd = self._f.fileno()
        return os.pread(fd, size, offset)

    @property
    def size(self) -> int:
        import os
        return os.fstat(self._f.fileno()).st_size if self._f else 0

    def stop(self) -> bool:
        if self._f:
            self._f.close()
            self._f = None
        return True

    def create(self) -> Buffer | None:
        data = self._f.read(self.blocksize)
        if not data:
            return None
        buf = Buffer(data, offset=self._offset,
                     offset_end=self._offset + len(data))
        self._offset += len(data)
        return buf


@register_element("filesink", Rank.PRIMARY)
class FileSink(BaseSink):
    PAD_TEMPLATES = [PadTemplate("sink", PadDirection.SINK,
                                 PadPresence.ALWAYS, Caps.any())]

    location = Property(str, default=None, mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self._f = None

    def start(self) -> bool:
        if not self.location:
            self.post_error("filesink: no location set")
            return False
        self._f = open(self.location, "wb")
        return True

    def stop(self) -> bool:
        if self._f:
            self._f.close()
            self._f = None
        return True

    def render(self, buf: Buffer):
        self._f.write(buf.to_bytes())
        return FlowReturn.OK

    def _event(self, pad, ev):
        # a bytes-format segment repositions the write offset, which is
        # how fmp4mux's header-update-mode=rewrite overwrites the moov
        # at EOS (GStreamer filesink semantics)
        from gstpu_torch.core.event import SegmentEvent
        if isinstance(ev, SegmentEvent) and ev.segment.fmt == "bytes" \
                and self._f is not None:
            self._f.seek(ev.segment.start)
            return True
        return super()._event(pad, ev)

    def on_eos(self) -> None:
        if self._f:
            self._f.flush()
