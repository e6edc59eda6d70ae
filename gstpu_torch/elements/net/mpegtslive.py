"""mpegtslivesrc: wrap a live MPEG-TS source and slave a clock to its
PCR.

Rebuilds the reference net/mpegtslive crate (src/mpegtslive/imp.rs):
a child source (udpsrc/srtsrc there; any description here) produces a
raw TS byte stream; this element scans packets, follows PAT -> first
program's PMT -> pcr_pid, feeds every PCR on that pid as an
(internal, external) observation into a slaved clock, and rewrites
buffer timestamps through that calibration (imp.rs:705 chain).
Discontinuities >15s in PCR or >1s vs the current calibration reset
the observation base and flag DISCONT.

The port's copy of gstpu/elements/net/mpegtslive.py, as it stands.
"""

from __future__ import annotations

from gstpu_torch.codecs.mpegts import (SYNC_BYTE, TS_PACKET_SIZE, MpegTsPcr,
                                       PcrSlavedClock, parse_pat, parse_pmt,
                                       parse_ts_packet, section_from_payload)
from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import (Element, FlowReturn, Pad, PadDirection,
                                      PadPresence, PadTemplate, State)
from gstpu_torch.core.event import Event
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

SECOND = 1_000_000_000


@register_element("mpegtslivesrc", Rank.NONE)
class MpegTsLiveSrc(Element):
    PAD_TEMPLATES = [PadTemplate("src", PadDirection.SRC,
                                 PadPresence.ALWAYS,
                                 Caps.new("video/mpegts"))]

    source = Property(str, default=None, mutable=Mutability.READY,
                      blurb="Child source description "
                            "(e.g. 'udpsrc port=5004')")
    window_size = Property(int, default=32, minimum=2,
                           mutable=Mutability.READY,
                           blurb="PCR observations kept for slaving")

    def __init__(self, name=None):
        super().__init__(name)
        self.srcpad = self.static_pad("src")
        self._child: Element | None = None
        self._child_tasks = []
        self.external_clock: PcrSlavedClock | None = None
        self._pmt_pid: int | None = None
        self._pcr_pid: int | None = None
        self._base_pcr: MpegTsPcr | None = None
        self._base_external: int | None = None
        self._last_pcr: MpegTsPcr | None = None
        self._discont_pending = False

    def provide_clock(self):
        return self.external_clock

    # -- child wiring (fallbacksrc pattern) ------------------------------
    def start(self) -> bool:
        if not self.source:
            self.post_error("mpegtslivesrc: no source configured")
            return False
        from gstpu_torch.elements.utils_.fallbacksrc import _make_from_desc
        self.external_clock = PcrSlavedClock(self.clock)
        self.external_clock.WINDOW = self.window_size
        self._child = _make_from_desc(self.source)
        self._child.clock = self.clock
        self._child.base_time = self.base_time
        self._child.bus = self.bus
        cap = Pad("cap", PadDirection.SINK,
                  PadTemplate("sink", PadDirection.SINK,
                              PadPresence.ALWAYS,
                              Caps.new("video/mpegts")))
        cap.chain_function = self._on_child_buffer
        cap.event_function = self._on_child_event
        for sp in self._child.src_pads():
            if not sp.is_linked():
                sp.link(cap)
                break
        self._child.set_state(State.PLAYING)
        self._child_tasks = []
        for t in self._child.iterate_tasks():
            t.prepare()
            t.start()
            self._child_tasks.append(t)
        return True

    def stop(self) -> bool:
        if self._child is not None:
            self._child.set_state(State.NULL)
            self._child = None
        return True

    def iterate_tasks(self):
        from gstpu_torch.runtime.scheduler import Task, TaskResult

        def drive() -> TaskResult:
            worked = False
            for t in list(self._child_tasks):
                r = t.run_once()
                if r is TaskResult.CONTINUE:
                    worked = True
            return TaskResult.CONTINUE if worked else TaskResult.IDLE

        return (Task(f"{self.name}-drive", drive),)

    # -- TS parsing ------------------------------------------------------
    def _on_child_event(self, pad: Pad, ev: Event) -> bool:
        return self.srcpad.push_event(ev)

    def _on_child_buffer(self, pad: Pad, buf: Buffer) -> FlowReturn:
        data = buf.to_bytes()
        pos = data.find(bytes([SYNC_BYTE]))
        if pos >= 0:
            monotonic = None
            if buf.pts is not None:
                monotonic = buf.pts + self.base_time
            for off in range(pos, len(data) - TS_PACKET_SIZE + 1,
                             TS_PACKET_SIZE):
                try:
                    self._handle_packet(
                        data[off:off + TS_PACKET_SIZE], monotonic)
                except ValueError:
                    continue
        if buf.pts is not None:
            adj = self.external_clock.adjust(buf.pts + self.base_time)
            buf.pts = max(0, adj - self.base_time)
            buf.dts = buf.pts
        if self._discont_pending:
            buf.set_flag(BufferFlags.DISCONT)
            self._discont_pending = False
        return self.srcpad.push(buf)

    def _handle_packet(self, pkt: bytes, monotonic: int | None) -> None:
        hdr, adaptation, payload = parse_ts_packet(pkt)
        if adaptation and adaptation["discontinuity"]:
            self._reset_observations()
        if (adaptation and adaptation["pcr"] is not None
                and hdr.pid == self._pcr_pid and monotonic is not None):
            self._store_observation(adaptation["pcr"], monotonic)
        if payload is None or not hdr.pusi:
            return
        if hdr.pid == 0x0000:
            programs = parse_pat(section_from_payload(payload))
            if programs:
                self._pmt_pid = next(iter(programs.values()))
        elif hdr.pid == self._pmt_pid:
            pmt = parse_pmt(section_from_payload(payload))
            self._pcr_pid = pmt.pcr_pid

    def _reset_observations(self) -> None:
        self._base_pcr = None
        self._base_external = None
        self._last_pcr = None
        self.external_clock.reset()
        self._discont_pending = True

    def _store_observation(self, pcr_units: int, internal: int) -> None:
        """imp.rs:269 store_observation: external = pcr - base_pcr +
        base_external, with wraparound tracking and sanity bounds."""
        clk = self.external_clock
        if self._base_pcr is None:
            self._base_pcr = MpegTsPcr.new(pcr_units)
            self._last_pcr = self._base_pcr
            self._base_external = clk.adjust(internal)
            clk.add_observation(internal, self._base_external)
            return
        pcr = MpegTsPcr.new_with_reference(pcr_units, self._last_pcr)
        if pcr is not None:
            external = (pcr.to_ns() - self._base_pcr.to_ns()
                        + self._base_external)
            if abs(clk.adjust(internal) - external) >= SECOND:
                pcr = None               # >1s off calibration: discont
        if pcr is None:
            self._reset_observations()
            self._base_pcr = MpegTsPcr.new(pcr_units)
            self._last_pcr = self._base_pcr
            self._base_external = internal
            clk.add_observation(internal, internal)
            return
        self._last_pcr = pcr
        clk.add_observation(
            internal, pcr.to_ns() - self._base_pcr.to_ns()
            + self._base_external)
