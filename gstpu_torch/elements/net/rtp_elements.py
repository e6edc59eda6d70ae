"""RTP elements: payloader/depayloader pairs + rtpsend/rtprecv.

Payload pairs follow the reference naming (net/rtp/src/lib.rs):
rtppcmupay2/rtppcmudepay2, rtppcmapay2/rtppcmadepay2, rtpL8/L16pay2...,
rtpopuspay2/rtpopusdepay2, rtpklvpay2/rtpklvdepay2. rtpsend/rtprecv
wrap the sans-IO Session (+ per-SSRC jitterbuffer on receive) like the
reference rtpbin2 elements, driven by pipeline dataflow instead of a
tokio runtime.

The port's copy of gstpu/elements/net/rtp_elements.py, as it stands.
"""

from __future__ import annotations

from collections import deque

from gstpu_torch.core.audio import audio_caps
from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import AnyList, Caps, IntRange, Structure
from gstpu_torch.core.element import (Element, FlowReturn, Pad, PadDirection,
                                      PadPresence, PadTemplate)
from gstpu_torch.core.event import EosEvent, Event
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.net.rtp.basepay import (RtpBaseDepay2, RtpBasePay2, rtp_caps)
from gstpu_torch.net.rtp.jitterbuffer import (JitterBuffer, PollOutcome,
                                              QueueResult)
from gstpu_torch.net.rtp.packet import RtpPacket
from gstpu_torch.net.rtp.session import RecvReply, SendReply, Session
from gstpu_torch.utils.log import debug_category

CAT = debug_category("rtp")

SECOND = 1_000_000_000


def _tmpl(name, direction, caps):
    return PadTemplate(name, direction, PadPresence.ALWAYS, caps)


# ---------------------------------------------------------------------------
# G.711 PCMA/PCMU
# ---------------------------------------------------------------------------

def _pcmau_pair(law: str, pt: int, media_caps_name: str):
    enc = "PCMA" if law == "alaw" else "PCMU"

    @register_element(f"rtppcm{'a' if law == 'alaw' else 'u'}pay2",
                      Rank.SECONDARY)
    class Pay(RtpBasePay2):
        PAD_TEMPLATES = [
            _tmpl("sink", PadDirection.SINK,
                  Caps.new(media_caps_name, rate=8000, channels=1)),
            _tmpl("src", PadDirection.SRC,
                  rtp_caps(enc, clock_rate=8000, payload=pt)),
        ]
        pt_default = pt

        def __init__(self, name=None):
            super().__init__(name)
            self._prop_values["pt"] = pt

    Pay.__name__ = f"RtpPcm{law.title()}Pay"

    @register_element(f"rtppcm{'a' if law == 'alaw' else 'u'}depay2",
                      Rank.SECONDARY)
    class Depay(RtpBaseDepay2):
        PAD_TEMPLATES = [
            _tmpl("sink", PadDirection.SINK, rtp_caps(enc,
                                                      clock_rate=8000)),
            _tmpl("src", PadDirection.SRC,
                  Caps.new(media_caps_name, rate=8000, channels=1)),
        ]

        def depay_src_caps(self, incaps):
            return Caps.new(media_caps_name, rate=8000, channels=1)

    Depay.__name__ = f"RtpPcm{law.title()}Depay"
    return Pay, Depay


_pcmau_pair("alaw", 8, "audio/x-alaw")
_pcmau_pair("mulaw", 0, "audio/x-mulaw")


# ---------------------------------------------------------------------------
# Linear audio L8/L16/L24
# ---------------------------------------------------------------------------

def _linear_pair(bits: int, fmt: str):
    enc = f"L{bits}"

    @register_element(f"rtpL{bits}pay2", Rank.SECONDARY)
    class Pay(RtpBasePay2):
        PAD_TEMPLATES = [
            _tmpl("sink", PadDirection.SINK, audio_caps(formats=fmt)),
            _tmpl("src", PadDirection.SRC,
                  rtp_caps(enc, **{"encoding-params": None})),
        ]

        _bpf = bits // 8        # frame size; * channels in set caps

        def set_sink_caps(self, caps) -> bool:
            s = caps[0]
            self._bpf = (bits // 8) * int(s.get("channels", 1))
            return True

        def handle_buffer(self, buf) -> None:
            """MTU-fragment on FRAME boundaries with the RTP
            timestamp advancing per packet (reference
            linear_audio/pay/imp.rs: each packet's ts covers the
            frames it carries)."""
            data = buf.to_bytes()
            rtp_ts = self.rtp_timestamp_for(buf)
            frames_per_pkt = max(1, (self.mtu - 12) // self._bpf)
            step = frames_per_pkt * self._bpf
            chunks = [data[i:i + step]
                      for i in range(0, len(data), step)] or [b""]
            for i, c in enumerate(chunks):
                self.queue_packet(
                    c, marker=(i == len(chunks) - 1),
                    rtp_ts=(rtp_ts + i * frames_per_pkt) & 0xFFFFFFFF,
                    pts=buf.pts)

        def transform_caps(self, direction, caps, filter):
            if direction is PadDirection.SINK:
                out = []
                for s in caps:
                    st = Structure("application/x-rtp", media="audio")
                    st["encoding-name"] = enc
                    st["payload"] = self.pt
                    st["clock-rate"] = s.get("rate",
                                             IntRange(1, 2**31 - 1))
                    ch = s.get("channels")
                    if ch is not None:
                        st["channels"] = ch
                    out.append(st)
                out = Caps(out)
            else:
                out = self.sinkpad.pad_template_caps().copy()
            if filter is not None:
                out = filter.intersect(out)
            return out

    Pay.__name__ = f"RtpL{bits}Pay"

    @register_element(f"rtpL{bits}depay2", Rank.SECONDARY)
    class Depay(RtpBaseDepay2):
        PAD_TEMPLATES = [
            _tmpl("sink", PadDirection.SINK, rtp_caps(enc)),
            _tmpl("src", PadDirection.SRC, audio_caps(formats=fmt)),
        ]

        def depay_src_caps(self, incaps):
            s = incaps[0]
            return Caps.new("audio/x-raw", format=fmt,
                            rate=int(s["clock-rate"]),
                            channels=int(s.get("channels", 1)),
                            layout="interleaved")

    Depay.__name__ = f"RtpL{bits}Depay"


_linear_pair(8, "U8")
_linear_pair(16, "S16BE")
# RFC 3551 §4.5.10 L24: packed S24BE linear audio (reference registers
# L8/L16/L24 — net/rtp/src/linear_audio/pay/mod.rs:59-62)
_linear_pair(24, "S24BE")


# ---------------------------------------------------------------------------
# Opus
# ---------------------------------------------------------------------------

@register_element("rtpopuspay2", Rank.SECONDARY)
class RtpOpusPay(RtpBasePay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, Caps.new("audio/x-opus")),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("OPUS", clock_rate=48000)),
    ]


@register_element("rtpopusdepay2", Rank.SECONDARY)
class RtpOpusDepay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, rtp_caps("OPUS",
                                                  clock_rate=48000)),
        _tmpl("src", PadDirection.SRC, Caps.new("audio/x-opus")),
    ]

    def depay_src_caps(self, incaps):
        return Caps.new("audio/x-opus", rate=48000,
                        channels=int(incaps[0].get("channels", 2)))


# ---------------------------------------------------------------------------
# KLV metadata (SMPTE 336M)
# ---------------------------------------------------------------------------

@register_element("rtpklvpay2", Rank.SECONDARY)
class RtpKlvPay(RtpBasePay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, Caps.new("meta/x-klv",
                                                  parsed=True)),
        _tmpl("src", PadDirection.SRC, rtp_caps("SMPTE336M")),
    ]
    MEDIA = "application"


@register_element("rtpklvdepay2", Rank.SECONDARY)
class RtpKlvDepay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, rtp_caps("SMPTE336M")),
        _tmpl("src", PadDirection.SRC, Caps.new("meta/x-klv",
                                                parsed=True)),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._accum: list[bytes] = []
        self._accum_pts = None

    def depay_src_caps(self, incaps):
        return Caps.new("meta/x-klv", parsed=True)

    def handle_packet(self, pkt: RtpPacket, buf: Buffer) -> None:
        # KLV units may span packets; marker closes a unit
        if not self._accum:
            self._accum_pts = self.pts_for(pkt)
        self._accum.append(pkt.payload)
        if pkt.marker:
            self.queue_buffer(b"".join(self._accum),
                              pts=self._accum_pts)
            self._accum = []


# ---------------------------------------------------------------------------
# rtpsend / rtprecv
# ---------------------------------------------------------------------------

_RTP_ANY = Caps.new("application/x-rtp")
_RTCP_CAPS = Caps.new("application/x-rtcp")


@register_element("rtpsend", Rank.NONE)
class RtpSend(Element):
    """Session-managed send path: rtp in -> rtp out + rtcp out
    (reference net/rtp/src/rtpbin2 rtpsend)."""

    PAD_TEMPLATES = [
        _tmpl("rtp_sink", PadDirection.SINK, _RTP_ANY.copy()),
        _tmpl("rtp_src", PadDirection.SRC, _RTP_ANY.copy()),
        _tmpl("rtcp_src", PadDirection.SRC, _RTCP_CAPS.copy()),
    ]

    rtcp_interval = Property(int, default=5 * SECOND, minimum=SECOND,
                             mutable=Mutability.READY)

    def __init__(self, name=None):
        super().__init__(name)
        self.session = Session()
        self.sinkpad = self.static_pad("rtp_sink")
        self.rtppad = self.static_pad("rtp_src")
        self.rtcppad = self.static_pad("rtcp_src")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._rtcp_started = False

    def start(self) -> bool:
        self.session.rtcp_interval = self.rtcp_interval
        return True

    def _now(self) -> int:
        return self.running_time() or 0

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        try:
            pkt = RtpPacket.parse(buf.to_bytes())
        except Exception as e:
            self.post_error(f"rtpsend: bad packet: {e}")
            return FlowReturn.ERROR
        now = self._now()
        reply = self.session.handle_send(pkt, now)
        if reply is SendReply.NEW_SSRC:
            reply = self.session.handle_send(pkt, now)
        if reply in (SendReply.DROP, SendReply.SSRC_COLLISION):
            if reply is SendReply.SSRC_COLLISION:
                # RFC 3550 never forwards a colliding SSRC
                self.post_element_message("rtpsend-ssrc-collision",
                                          ssrc=pkt.ssrc)
            return FlowReturn.OK
        ret = self.rtppad.push(buf)
        self._maybe_send_rtcp(now)
        return ret

    def _maybe_send_rtcp(self, now: int) -> None:
        data = self.session.poll_rtcp_send(now)
        if data and self.rtcppad.is_linked():
            if not self._rtcp_started:
                from gstpu_torch.core.event import (CapsEvent, SegmentEvent,
                                                    Segment, StreamStartEvent)
                self.rtcppad.push_event(StreamStartEvent(f"{self.name}/rtcp"))
                self.rtcppad.push_event(CapsEvent(_RTCP_CAPS.copy()))
                self.rtcppad.push_event(SegmentEvent(Segment()))
                self._rtcp_started = True
            self.rtcppad.push(Buffer(data))

    def _event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, EosEvent):
            bye = self.session.bye()
            if bye and self.rtcppad.is_linked() and self._rtcp_started:
                self.rtcppad.push(Buffer(bye))
        return self.default_pad_event(pad, ev)


@register_element("rtprecv", Rank.NONE)
class RtpRecv(Element):
    """Session-managed receive path with per-SSRC jitterbuffer
    (reference rtprecv)."""

    PAD_TEMPLATES = [
        _tmpl("rtp_sink", PadDirection.SINK, _RTP_ANY.copy()),
        _tmpl("rtcp_sink", PadDirection.SINK, _RTCP_CAPS.copy()),
        _tmpl("rtp_src", PadDirection.SRC, _RTP_ANY.copy()),
    ]

    latency = Property(int, default=200_000_000, minimum=0,
                       mutable=Mutability.READY, blurb="Jitterbuffer ns")

    def __init__(self, name=None):
        super().__init__(name)
        self.session = Session()
        self.sinkpad = self.static_pad("rtp_sink")
        self.rtcpsink = self.static_pad("rtcp_sink")
        self.srcpad = self.static_pad("rtp_src")
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self.rtcpsink.chain_function = self._rtcp_chain
        self.rtcpsink.event_function = lambda pad, ev: True
        self._jb: dict[int, JitterBuffer] = {}
        # held buffers keyed per SSRC (jitterbuffer packet ids are
        # only unique within one JitterBuffer instance)
        self._held: dict[int, dict[int, Buffer]] = {}

    def _now(self) -> int:
        return self.running_time() or 0

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        try:
            pkt = RtpPacket.parse(buf.to_bytes())
        except Exception as e:
            self.post_error(f"rtprecv: bad packet: {e}")
            return FlowReturn.ERROR
        now = self._now()
        reply = self.session.handle_recv(pkt, now)
        if reply is RecvReply.NEW_SSRC:
            reply = self.session.handle_recv(pkt, now)
        if reply is RecvReply.DROP:
            return FlowReturn.OK
        jb = self._jb.get(pkt.ssrc)
        if jb is None:
            jb = self._jb[pkt.ssrc] = JitterBuffer(self.latency)
            self._held[pkt.ssrc] = {}
        res, pid = jb.queue_packet(pkt.seqnum, now)
        if res is QueueResult.QUEUED:
            self._held[pkt.ssrc][pid] = buf
        return self._drain(pkt.ssrc, jb, now)

    def _drain(self, ssrc: int, jb: JitterBuffer, now: int) -> FlowReturn:
        held = self._held[ssrc]
        while True:
            r = jb.poll(now)
            if r.outcome is PollOutcome.FORWARD:
                buf = held.pop(r.id)
                ret = self.srcpad.push(buf)
                if not ret.is_ok:
                    return ret
            else:
                return FlowReturn.OK

    def _rtcp_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        try:
            self.session.handle_rtcp_recv(buf.to_bytes(), self._now())
        except Exception as e:
            # malformed RTCP from a remote peer must not kill dataflow
            CAT.warning("%s: dropping malformed RTCP: %s", self.name, e)
        return FlowReturn.OK

    def _event(self, pad: Pad, ev: Event) -> bool:
        if isinstance(ev, EosEvent):
            for ssrc, jb in self._jb.items():
                held = self._held[ssrc]
                for pid in jb.flush():
                    self.srcpad.push(held.pop(pid))
        return self.default_pad_event(pad, ev)


# -- MP2T (MPEG-TS over RTP, RFC 2250) --------------------------------

_MP2T_MEDIA = Caps([Structure("video/mpegts",
                              **{"packetsize":
                                 AnyList((188, 192, 204, 208)),
                                 "systemstream": True})])


@register_element("rtpmp2tpay2", Rank.SECONDARY)
class RtpMp2tPay(RtpBasePay2):
    """Aggregates whole TS packets into RTP payloads (reference
    net/rtp/src/mp2t/pay/imp.rs: 7x188=1316 typical, static PT 33)."""

    DEFAULT_PT = 33

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, _MP2T_MEDIA.copy()),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("MP2T", clock_rate=90000, media="video",
                       payload=33)),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self.pt = 33
        self._packet_size = 188
        self._acc = b""

    def set_sink_caps(self, caps) -> bool:
        self._packet_size = int(caps[0].get("packetsize", 188) or 188)
        return True

    def handle_buffer(self, buf) -> None:
        self._acc += buf.to_bytes()
        n_fit = max(1, (self.mtu - 12) // self._packet_size)
        chunk = n_fit * self._packet_size
        rtp_ts = self.rtp_timestamp_for(buf)
        while len(self._acc) >= chunk:
            self.queue_packet(self._acc[:chunk], rtp_ts=rtp_ts,
                              pts=buf.pts)
            self._acc = self._acc[chunk:]

    def drain(self):
        if not self._acc:
            return []
        pkt = self._acc
        self._acc = b""
        self._pending = []
        self.queue_packet(pkt, marker=True)
        out, self._pending = self._pending, []
        return out


@register_element("rtpmp2tdepay2", Rank.SECONDARY)
class RtpMp2tDepay(RtpBaseDepay2):
    """Validates sync bytes and passes whole TS packets through
    (reference net/rtp/src/mp2t/depay/imp.rs)."""

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              rtp_caps("MP2T", clock_rate=90000, media="video",
                       payload=33)),
        _tmpl("src", PadDirection.SRC, _MP2T_MEDIA.copy()),
    ]

    skip_first_bytes = Property(int, default=0, minimum=0,
                                mutable=Mutability.READY)

    def depay_src_caps(self, incaps):
        return Caps.new("video/mpegts", packetsize=188,
                        systemstream=True)

    def handle_packet(self, pkt, buf) -> None:
        data = pkt.payload[self.skip_first_bytes:]
        if not data or data[0] != 0x47 or len(data) % 188:
            # resync on packet-size multiples of the sync byte
            pos = data.find(b"\x47")
            if pos < 0:
                return
            data = data[pos:len(data) - (len(data) - pos) % 188]
            if not data:
                return
        self.queue_buffer(data, pts=self.pts_for(pkt))


# -- AC-3 (RFC 4184) ----------------------------------------------------

_AC3_MEDIA = Caps([Structure("audio/x-ac3",
                             **{"framed": True,
                                "rate": AnyList((32000, 44100, 48000))})])


@register_element("rtpac3pay2", Rank.SECONDARY)
class RtpAc3Pay(RtpBasePay2):
    """RFC 4184: 2-byte payload header (MBZ|FT, NF).  Whole framed
    buffers go out FT=0 NF=1; oversized frames fragment with FT=1
    (initial, >=5/8 of the frame) / FT=3 (non-initial), NF = number
    of fragments (reference net/rtp/src/ac3/pay/imp.rs:512)."""

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, _AC3_MEDIA.copy()),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("AC3", media="audio")),
    ]

    def set_sink_caps(self, caps) -> bool:
        # RTP clock rate is the audio sample rate for AC3
        self.clock_rate = int(caps[0].get("rate", 48000) or 48000)
        return True

    def transform_caps(self, direction, caps, filter):
        out = super().transform_caps(direction, caps, filter)
        if direction is PadDirection.SINK and caps.is_fixed():
            rate = caps[0].get("rate")
            if rate is not None:
                for s in out:
                    s["clock-rate"] = int(rate)
        return out

    def handle_buffer(self, buf) -> None:
        data = buf.to_bytes()
        rtp_ts = self.rtp_timestamp_for(buf)
        room = self.mtu - 12 - 2
        if len(data) <= room:
            self.queue_packet(bytes([0, 1]) + data, marker=True,
                              rtp_ts=rtp_ts, pts=buf.pts)
            return
        chunks = [data[i:i + room] for i in range(0, len(data), room)]
        n = len(chunks)
        for i, c in enumerate(chunks):
            ft = 1 if i == 0 else 3
            self.queue_packet(bytes([ft, n]) + c,
                              marker=(i == n - 1), rtp_ts=rtp_ts,
                              pts=buf.pts)


@register_element("rtpac3depay2", Rank.SECONDARY)
class RtpAc3Depay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, rtp_caps("AC3", media="audio")),
        _tmpl("src", PadDirection.SRC, _AC3_MEDIA.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._frag: list[bytes] = []
        self._frag_pts = None

    def depay_src_caps(self, incaps):
        rate = int(incaps[0].get("clock-rate", 48000) or 48000)
        return Caps.new("audio/x-ac3", framed=True, rate=rate)

    def handle_packet(self, pkt, buf) -> None:
        data = pkt.payload
        if len(data) < 3:
            return
        ft = data[0] & 0x03
        body = data[2:]
        if ft == 0:
            self.queue_buffer(body, pts=self.pts_for(pkt))
            return
        if ft == 1 or ft == 2 or not self._frag:
            self._frag = []
            self._frag_pts = self.pts_for(pkt)
        self._frag.append(body)
        if pkt.marker:
            self.queue_buffer(b"".join(self._frag), pts=self._frag_pts)
            self._frag = []


# -- MPEG audio (RFC 2250) ----------------------------------------------

_MPA_MEDIA = Caps([Structure("audio/mpeg", mpegversion=1)])


@register_element("rtpmpapay2", Rank.SECONDARY)
class RtpMpaPay(RtpBasePay2):
    """RFC 2250 audio: 4-byte header (2 MBZ, 2 fragmentation offset),
    static PT 14, 90kHz clock (reference net/rtp/src/mpa/pay)."""

    DEFAULT_PT = 14

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, _MPA_MEDIA.copy()),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("MPA", clock_rate=90000, media="audio")),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self.pt = 14

    def handle_buffer(self, buf) -> None:
        data = buf.to_bytes()
        rtp_ts = self.rtp_timestamp_for(buf)
        room = self.mtu - 12 - 4
        off = 0
        while off < len(data) or not off:
            chunk = data[off:off + room]
            hdr = bytes([0, 0, off >> 8 & 0xFF, off & 0xFF])
            last = off + room >= len(data)
            self.queue_packet(hdr + chunk, marker=last, rtp_ts=rtp_ts,
                              pts=buf.pts)
            off += room
            if last:
                break


@register_element("rtpmpadepay2", Rank.SECONDARY)
class RtpMpaDepay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              rtp_caps("MPA", clock_rate=90000, media="audio")),
        _tmpl("src", PadDirection.SRC, _MPA_MEDIA.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._frag: list[bytes] = []
        self._frag_pts = None

    def depay_src_caps(self, incaps):
        return Caps.new("audio/mpeg", mpegversion=1)

    def handle_packet(self, pkt, buf) -> None:
        data = pkt.payload
        if len(data) < 5:
            return
        frag_offset = data[2] << 8 | data[3]
        if frag_offset == 0:
            self._frag = []
            self._frag_pts = self.pts_for(pkt)
        self._frag.append(data[4:])
        if pkt.marker:
            self.queue_buffer(b"".join(self._frag), pts=self._frag_pts)
            self._frag = []


@register_element("rtpmparobustdepay2", Rank.SECONDARY)
class RtpMpaRobustDepay(RtpBaseDepay2):
    """MPEG Audio Robust (ADU) depayloader, RFC 5219.

    Rebuilds reference net/rtp/src/mparobust/depay/imp.rs: parses ADU
    descriptors (1/2-byte, C/T bits), reassembles fragmented ADUs,
    deinterleaves (RFC 5219 §7), and converts ADUs back to MP3 frames
    with dummy-ADU insertion on loss (Appendix A.2)."""

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              rtp_caps("MPA-ROBUST", clock_rate=90000, media="audio")),
        _tmpl("src", PadDirection.SRC,
              Caps([Structure("audio/mpeg", mpegversion=1, parsed=True)])),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        from gstpu_torch.net.rtp.mparobust import AduQueue, DeinterleavingBuffer
        self._deint = DeinterleavingBuffer()
        self._queue = AduQueue()
        self._acc: bytearray | None = None   # fragmented-ADU accumulator
        self._acc_size = 0
        self._needs_discont = True
        self._next_pts: int | None = None

    def depay_src_caps(self, incaps):
        return Caps.new("audio/mpeg", mpegversion=1, parsed=True)

    def _emit(self, frames) -> None:
        for f in frames:
            pts = self._next_pts
            if pts is not None:
                self._next_pts = pts + f.duration_ns
            self.queue_buffer(f.data, pts=pts, duration=f.duration_ns)

    def handle_packet(self, pkt, buf) -> None:
        from gstpu_torch.net.rtp.mparobust import Adu
        if self._next_pts is None:
            self._next_pts = self.pts_for(pkt)
        data = pkt.payload
        ready = []
        idx = 0
        while data:
            cont = bool(data[0] & 0x80)
            if data[0] & 0x40:                  # 2-byte, 14-bit size
                if len(data) < 3:
                    self._needs_discont = True
                    return
                total, off = ((data[0] & 0x3F) << 8) | data[1], 2
            else:                                # 1-byte, 6-bit size
                if len(data) < 2:
                    self._needs_discont = True
                    return
                total, off = data[0] & 0x3F, 1
            if cont:
                # continuation fragment: must be packet-initial
                if idx != 0 or self._acc is None:
                    self._needs_discont = True
                    self._acc = None
                    return
                self._acc += data[off:]
                data = b""
                if len(self._acc) < self._acc_size:
                    return                      # more fragments pending
                raw, self._acc = bytes(self._acc[:self._acc_size]), None
            elif total > len(data) - off:
                # first fragment of an oversized ADU
                self._acc = bytearray(data[off:])
                self._acc_size = total
                return
            else:
                raw = data[off:off + total]
                data = data[off + total:]
            adu = Adu.parse(raw)
            if adu is None:
                self._needs_discont = True
                return
            if self._needs_discont:
                adu.is_discont = True
                self._needs_discont = False
            ready.extend(self._deint.push(adu))
            idx += 1
        if ready:
            self._emit(self._queue.push_adus(ready))

    def drain(self):
        self._pending = []
        left = self._deint.drain()
        if left:
            self._emit(self._queue.push_adus(left))
        self._emit(self._queue.drain())
        out, self._pending = self._pending, []
        return out


# -- MPEG-4 generic (RFC 3640, AAC-hbr) -----------------------------------

_MP4G_MEDIA = Caps([Structure("audio/mpeg", mpegversion=4,
                              **{"stream-format": "raw"})])


@register_element("rtpmp4gpay2", Rank.SECONDARY)
class RtpMp4gPay(RtpBasePay2):
    """RFC 3640 AAC-hbr (reference net/rtp/src/mp4g/pay): AU-headers
    section (16-bit bit length, then size<<indexlen|index per AU)
    followed by the AU; oversized AUs fragment with the marker on the
    final fragment only."""

    SIZE_LEN = 13
    INDEX_LEN = 3

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, _MP4G_MEDIA.copy()),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("MPEG4-GENERIC", media="audio",
                       mode="AAC-hbr", sizelength="13",
                       indexlength="3", indexdeltalength="3")),
    ]

    def set_sink_caps(self, caps) -> bool:
        self.clock_rate = int(caps[0].get("rate", 90000) or 90000)
        return True

    def transform_caps(self, direction, caps, filter):
        out = super().transform_caps(direction, caps, filter)
        if direction is PadDirection.SINK and caps.is_fixed():
            rate = caps[0].get("rate")
            if rate is not None:
                for s in out:
                    s["clock-rate"] = int(rate)
        return out

    def _au_header(self, size: int, index: int = 0) -> bytes:
        bits = self.SIZE_LEN + self.INDEX_LEN   # 16 for AAC-hbr
        v = size << self.INDEX_LEN | index
        return bits.to_bytes(2, "big") + v.to_bytes(2, "big")

    def handle_buffer(self, buf) -> None:
        data = buf.to_bytes()
        rtp_ts = self.rtp_timestamp_for(buf)
        room = self.mtu - 12 - 4            # headers-length + 1 header
        if len(data) <= room:
            self.queue_packet(self._au_header(len(data)) + data,
                              marker=True, rtp_ts=rtp_ts, pts=buf.pts)
            return
        chunks = [data[i:i + room] for i in range(0, len(data), room)]
        for i, c in enumerate(chunks):
            # fragments carry the ORIGINAL AU size (RFC 3640 3.3.6)
            self.queue_packet(self._au_header(len(data)) + c,
                              marker=(i == len(chunks) - 1),
                              rtp_ts=rtp_ts, pts=buf.pts)


@register_element("rtpmp4gdepay2", Rank.SECONDARY)
class RtpMp4gDepay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              rtp_caps("MPEG4-GENERIC", media="audio",
                       mode="AAC-hbr")),
        _tmpl("src", PadDirection.SRC, _MP4G_MEDIA.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._size_len = 13
        self._index_len = 3
        self._frag: list[bytes] = []
        self._frag_size = 0
        self._frag_pts = None

    def set_rtp_caps(self, caps) -> bool:
        s = caps[0]
        self._size_len = int(s.get("sizelength", 13) or 13)
        self._index_len = int(s.get("indexlength", 3) or 3)
        return True

    def depay_src_caps(self, incaps):
        rate = int(incaps[0].get("clock-rate", 90000) or 90000)
        return Caps.new("audio/mpeg", mpegversion=4, rate=rate,
                        **{"stream-format": "raw"})

    def handle_packet(self, pkt, buf) -> None:
        data = pkt.payload
        if len(data) < 2:
            return
        hdr_bits = data[0] << 8 | data[1]
        n_hdr_bytes = (hdr_bits + 7) // 8
        per_au = self._size_len + self._index_len
        aus = []
        bitpos = 0
        hdrs = data[2:2 + n_hdr_bytes]
        while bitpos + per_au <= hdr_bits:
            v = 0
            for b in range(per_au):
                byte = hdrs[(bitpos + b) >> 3]
                v = v << 1 | (byte >> (7 - ((bitpos + b) & 7))) & 1
            aus.append(v >> self._index_len)
            bitpos += per_au
        pos = 2 + n_hdr_bytes
        pts = self.pts_for(pkt)
        for size in aus:
            chunk = data[pos:pos + size]
            pos += len(chunk)
            if len(chunk) == size and not self._frag:
                self.queue_buffer(chunk, pts=pts)
            else:                       # fragmented AU
                if not self._frag:
                    self._frag_size = size
                    self._frag_pts = pts
                self._frag.append(chunk)
                joined = b"".join(self._frag)
                if pkt.marker and len(joined) >= self._frag_size:
                    self.queue_buffer(joined[:self._frag_size],
                                      pts=self._frag_pts)
                    self._frag = []


# -- SMPTE ST-291 ancillary data (RFC 8331) -------------------------------

_ST2038_MEDIA = Caps([Structure("meta/x-st-2038", alignment="frame")])


@register_element("rtpsmpte291pay2", Rank.SECONDARY)
class RtpSmpte291Pay(RtpBasePay2):
    """RFC 8331 (reference net/rtp/src/smpte291/pay): 8-byte header
    (extended seqnum hi16, length, ANC_count, F+reserved) then each
    ST-2038 packet rewritten as C/line/hoffset/S/StreamNum + 10-bit
    DID/SDID/DC/UDW/checksum words, padded to 32-bit boundaries."""

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, _ST2038_MEDIA.copy()),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("SMPTE291", clock_rate=90000, media="video")),
    ]

    def handle_buffer(self, buf) -> None:
        from gstpu_torch.codecs.st2038 import _BitWriter, iter_anc

        rtp_ts = self.rtp_timestamp_for(buf)
        w = _BitWriter()
        count = 0
        # high 16 bits of the RFC 8331 extended sequence number:
        # counts 16-bit seqnum wraps since start
        ext_hi = getattr(self, "_ext_hi", 0)
        header = bytes([ext_hi >> 8, ext_hi & 0xFF, 0, 0, 0, 0, 0, 0])
        for hdr, payload in iter_anc(buf.to_bytes()):
            w.write(1 if hdr.c_not_y else 0, 1)
            w.write(hdr.line_number, 11)
            w.write(hdr.horizontal_offset, 12)
            w.write(0, 1)                      # S
            w.write(0, 7)                      # StreamNum
            from gstpu_torch.codecs.st2038 import _parity10
            for word in (_parity10(hdr.did), _parity10(hdr.sdid),
                         _parity10(hdr.data_count)):
                w.write(word, 10)
            for b in payload:
                w.write(_parity10(b), 10)
            w.write(hdr.checksum, 10)
            while (len(w.out) * 8 + w.nbits) % 32:
                w.write(0, 1)                  # word_align (RFC 8331)
            count += 1
        body = w.align_with_ones()
        pkt = bytearray(header) + body
        pkt[2:4] = len(body).to_bytes(2, "big")
        pkt[4] = count
        self.queue_packet(bytes(pkt), marker=True, rtp_ts=rtp_ts,
                          pts=buf.pts)
        if self._seqnum == 0:            # queue_packet wrapped 0xFFFF->0
            self._ext_hi = (ext_hi + 1) & 0xFFFF


@register_element("rtpsmpte291depay2", Rank.SECONDARY)
class RtpSmpte291Depay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              rtp_caps("SMPTE291", clock_rate=90000, media="video")),
        _tmpl("src", PadDirection.SRC, _ST2038_MEDIA.copy()),
    ]

    def depay_src_caps(self, incaps):
        return Caps.new("meta/x-st-2038", alignment="frame")

    def handle_packet(self, pkt, buf) -> None:
        from gstpu_torch.codecs.st2038 import _BitReader, build_anc
        data = pkt.payload
        if len(data) < 8:
            return
        anc_count = data[4]
        r = _BitReader(data[8:])
        pts = self.pts_for(pkt)
        for _ in range(anc_count):
            c_not_y = bool(r.read(1))
            line = r.read(11)
            hoff = r.read(12)
            r.read(8)                          # S + StreamNum
            did = r.read(10) & 0xFF
            sdid = r.read(10) & 0xFF
            dc = r.read(10) & 0xFF
            payload = bytes(r.read(10) & 0xFF for _ in range(dc))
            r.read(10)                         # checksum (rebuilt)
            while r.pos % 32:
                r.read(1)                      # word_align
            self.queue_buffer(
                build_anc(did, sdid, payload, c_not_y=c_not_y,
                          line_number=line, horizontal_offset=hoff),
                pts=pts)


# -- JPEG (RFC 2435) ------------------------------------------------------

@register_element("rtpjpegpay2", Rank.SECONDARY)
class RtpJpegPay(RtpBasePay2):
    """RFC 2435: strips the JFIF container, sends 8-byte main headers
    (type-specific, 24-bit fragment offset, type, Q, width/8,
    height/8) + the entropy scan; quant tables ride the first
    fragment as Q=255 (reference net/rtp/src/jpeg/pay)."""

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, Caps.new("image/jpeg")),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("JPEG", clock_rate=90000, media="video",
                       payload=26)),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self.pt = 26

    def handle_buffer(self, buf) -> None:
        from gstpu_torch.codecs.rtpjpeg import parse_jpeg
        try:
            info = parse_jpeg(buf.to_bytes())
        except ValueError as e:
            self.post_error(f"rtpjpegpay: {e}")
            from gstpu_torch.core.element import FlowError
            raise FlowError(FlowReturn.ERROR)
        rtp_ts = self.rtp_timestamp_for(buf)
        qdata = b"".join(info.qtables)
        qhdr = bytes([0, 0]) + len(qdata).to_bytes(2, "big") + qdata
        scan = info.scan
        off = 0
        room = self.mtu - 12 - 8
        while off < len(scan) or off == 0:
            hdr = (bytes([0]) + off.to_bytes(3, "big")
                   + bytes([info.jpeg_type, 255,
                            (info.width + 7) // 8,
                            (info.height + 7) // 8]))
            extra = qhdr if off == 0 else b""
            chunk = scan[off:off + room - len(extra)]
            last = off + len(chunk) >= len(scan)
            self.queue_packet(hdr + extra + chunk, marker=last,
                              rtp_ts=rtp_ts, pts=buf.pts)
            off += len(chunk)
            if last:
                break


@register_element("rtpjpegdepay2", Rank.SECONDARY)
class RtpJpegDepay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              rtp_caps("JPEG", clock_rate=90000, media="video")),
        _tmpl("src", PadDirection.SRC, Caps.new("image/jpeg")),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._frags: dict[int, bytes] = {}
        self._info = None
        self._pts = None

    def depay_src_caps(self, incaps):
        return Caps.new("image/jpeg", parsed=True)

    def handle_packet(self, pkt, buf) -> None:
        from gstpu_torch.codecs.rtpjpeg import JpegInfo, reassemble_jpeg
        data = pkt.payload
        if len(data) < 8:
            return
        off = int.from_bytes(data[1:4], "big")
        jtype, q, w8, h8 = data[4], data[5], data[6], data[7]
        pos = 8
        if off == 0:
            qtables = []
            if q >= 128 and len(data) >= 12:
                qlen = int.from_bytes(data[10:12], "big")
                qdata = data[12:12 + qlen]
                qtables = [qdata[i:i + 64]
                           for i in range(0, len(qdata), 64)]
                pos = 12 + qlen
            self._info = JpegInfo(w8 * 8, h8 * 8, jtype & 0x3F,
                                  qtables, b"")
            self._frags = {}
            self._pts = self.pts_for(pkt)
        if self._info is None:
            return                          # mid-frame join: wait
        self._frags[off] = data[pos:]
        if pkt.marker:
            scan = b"".join(self._frags[k]
                            for k in sorted(self._frags))
            self._info.scan = scan
            self.queue_buffer(reassemble_jpeg(self._info),
                              pts=self._pts)
            self._info = None
            self._frags = {}


# -- AMR-NB / AMR-WB (RFC 4867, octet-aligned) ----------------------------

# core frame bytes per frame type (ETSI TS 126 101 / 126 201)
_AMR_NB_SIZES = (12, 13, 15, 17, 19, 20, 26, 31, 5)
_AMR_WB_SIZES = (17, 23, 32, 36, 40, 46, 50, 58, 60, 5)


def _amr_pair(wb: bool):
    enc = "AMR-WB" if wb else "AMR"
    media = "audio/AMR-WB" if wb else "audio/AMR"
    rate = 16000 if wb else 8000
    sizes = _AMR_WB_SIZES if wb else _AMR_NB_SIZES
    suffix = "wb" if wb else ""

    @register_element(f"rtpamr{suffix}pay2", Rank.SECONDARY)
    class Pay(RtpBasePay2):
        """Octet-aligned RFC 4867: CMR octet, then one TOC octet per
        frame (F|FT|Q), then the core frames (reference
        net/rtp/src/amr/pay prefers octet-align=1)."""

        PAD_TEMPLATES = [
            _tmpl("sink", PadDirection.SINK, Caps.new(media)),
            _tmpl("src", PadDirection.SRC,
                  rtp_caps(enc, clock_rate=rate, media="audio",
                           **{"octet-align": "1"})),
        ]

        def handle_buffer(self, buf) -> None:
            data = buf.to_bytes()
            # split the buffer into frames via the FT in each TOC-less
            # AMR file-storage frame header octet
            frames = []
            pos = 0
            while pos < len(data):
                ft = data[pos] >> 3 & 0x0F
                if ft >= len(sizes):
                    break
                n = sizes[ft]
                frames.append((ft, bool(data[pos] & 0x04),
                               data[pos + 1:pos + 1 + n]))
                pos += 1 + n
            if not frames:
                return
            toc = bytes(((0x80 if i < len(frames) - 1 else 0)
                         | ft << 3 | (0x04 if q else 0))
                        for i, (ft, q, _) in enumerate(frames))
            body = b"".join(f for _, _, f in frames)
            self.queue_packet(b"\xF0" + toc + body, marker=True,
                              rtp_ts=self.rtp_timestamp_for(buf),
                              pts=buf.pts)

    Pay.__name__ = f"RtpAmr{'Wb' if wb else ''}Pay"

    @register_element(f"rtpamr{suffix}depay2", Rank.SECONDARY)
    class Depay(RtpBaseDepay2):
        PAD_TEMPLATES = [
            _tmpl("sink", PadDirection.SINK,
                  rtp_caps(enc, clock_rate=rate, media="audio")),
            _tmpl("src", PadDirection.SRC, Caps.new(media)),
        ]

        def depay_src_caps(self, incaps):
            if incaps[0].get("octet-align") != "1":
                self.post_error(f"rtpamr{suffix}depay2: only "
                                "octet-aligned mode supported")
                return None
            return Caps.new(media, rate=rate, channels=1)

        def handle_packet(self, pkt, buf) -> None:
            data = pkt.payload
            if len(data) < 2:
                return
            tocs = []
            pos = 1                         # skip CMR
            while pos < len(data):
                tocs.append(data[pos])
                follow = data[pos] & 0x80
                pos += 1
                if not follow:
                    break
            out = b""
            for t in tocs:
                ft = t >> 3 & 0x0F
                if ft >= len(sizes):
                    return                  # malformed
                n = sizes[ft]
                out += bytes([t & 0x7C]) + data[pos:pos + n]
                pos += n
            self.queue_buffer(out, pts=self.pts_for(pkt))

    Depay.__name__ = f"RtpAmr{'Wb' if wb else ''}Depay"


_amr_pair(False)
_amr_pair(True)


# -- MPEG-1/2 video (RFC 2250) --------------------------------------------

_MPV_MEDIA = Caps([Structure("video/mpeg",
                             mpegversion=AnyList((1, 2)),
                             systemstream=False)])


@register_element("rtpmpvpay2", Rank.SECONDARY)
class RtpMpvPay(RtpBasePay2):
    """RFC 2250 section 3.4: 4-byte MPEG video-specific header
    (TR and picture-type fields zeroed like the reference's simple
    payloader path), static PT 32, marker at frame end."""

    DEFAULT_PT = 32

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, _MPV_MEDIA.copy()),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("MPV", clock_rate=90000, media="video",
                       payload=32)),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self.pt = 32

    def handle_buffer(self, buf) -> None:
        data = buf.to_bytes()
        rtp_ts = self.rtp_timestamp_for(buf)
        room = self.mtu - 12 - 4
        off = 0
        while off < len(data) or not off:
            chunk = data[off:off + room]
            last = off + room >= len(data)
            # B (beginning-of-slice) on the first fragment, E (end)
            # on the last; other header fields zero
            hdr = bytes([0, 0,
                         (0x10 if off == 0 else 0)
                         | (0x08 if last else 0), 0])
            self.queue_packet(hdr + chunk, marker=last, rtp_ts=rtp_ts,
                              pts=buf.pts)
            off += room
            if last:
                break


@register_element("rtpmpvdepay2", Rank.SECONDARY)
class RtpMpvDepay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              rtp_caps("MPV", clock_rate=90000, media="video",
                       payload=32)),
        _tmpl("src", PadDirection.SRC, _MPV_MEDIA.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._frag: list[bytes] = []
        self._frag_pts = None

    def depay_src_caps(self, incaps):
        return Caps.new("video/mpeg", mpegversion=2,
                        systemstream=False)

    def handle_packet(self, pkt, buf) -> None:
        data = pkt.payload
        if len(data) < 5:
            return
        hdr_len = 4
        if data[2] & 0x04:                  # T bit: MPEG-2 extension
            hdr_len = 8
        if not self._frag:
            self._frag_pts = self.pts_for(pkt)
        self._frag.append(data[hdr_len:])
        if pkt.marker:
            self.queue_buffer(b"".join(self._frag),
                              pts=self._frag_pts)
            self._frag = []


# -- MPEG-4 audio LATM (RFC 3016) -----------------------------------------

_MP4A_MEDIA = Caps([Structure("audio/mpeg", mpegversion=4,
                              **{"stream-format": "raw"})])


@register_element("rtpmp4apay2", Rank.SECONDARY)
class RtpMp4aPay(RtpBasePay2):
    """RFC 3016 MP4A-LATM with muxConfigPresent=0: each packet is one
    audioMuxElement = 0xFF-run length prefix + the raw AAC frame;
    fragments continue with the marker on the final one (reference
    net/rtp/src/mp4a/pay)."""

    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK, _MP4A_MEDIA.copy()),
        _tmpl("src", PadDirection.SRC,
              rtp_caps("MP4A-LATM", media="audio",
                       cpresent="0")),
    ]

    def set_sink_caps(self, caps) -> bool:
        self.clock_rate = int(caps[0].get("rate", 90000) or 90000)
        self._config = caps[0].get("codec_data") or ""
        return True

    def transform_caps(self, direction, caps, filter):
        out = super().transform_caps(direction, caps, filter)
        if direction is PadDirection.SINK and caps.is_fixed():
            s = caps[0]
            rate = s.get("rate")
            for st in out:
                if rate is not None:
                    st["clock-rate"] = int(rate)
                cfg = s.get("codec_data")
                if cfg:
                    st["config"] = cfg if isinstance(cfg, str) \
                        else bytes(cfg).hex()
        return out

    def handle_buffer(self, buf) -> None:
        data = buf.to_bytes()
        n = len(data)
        prefix = b"\xff" * (n // 255) + bytes([n % 255])
        payload = prefix + data
        rtp_ts = self.rtp_timestamp_for(buf)
        room = self.mtu - 12
        chunks = [payload[i:i + room]
                  for i in range(0, len(payload), room)] or [b""]
        for i, c in enumerate(chunks):
            self.queue_packet(c, marker=(i == len(chunks) - 1),
                              rtp_ts=rtp_ts, pts=buf.pts)


@register_element("rtpmp4adepay2", Rank.SECONDARY)
class RtpMp4aDepay(RtpBaseDepay2):
    PAD_TEMPLATES = [
        _tmpl("sink", PadDirection.SINK,
              rtp_caps("MP4A-LATM", media="audio")),
        _tmpl("src", PadDirection.SRC, _MP4A_MEDIA.copy()),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._frags: list[bytes] = []
        self._frag_pts = None

    def depay_src_caps(self, incaps):
        s = incaps[0]
        rate = int(s.get("clock-rate", 90000) or 90000)
        kw = {"stream-format": "raw"}
        cfg = s.get("config")
        if cfg:
            kw["codec_data"] = cfg
        return Caps.new("audio/mpeg", mpegversion=4, rate=rate, **kw)

    def handle_packet(self, pkt, buf) -> None:
        if not self._frags:
            self._frag_pts = self.pts_for(pkt)
        self._frags.append(pkt.payload)
        if not pkt.marker:
            return
        data = b"".join(self._frags)
        self._frags = []
        pos = 0
        n = 0
        while pos < len(data):
            n += data[pos]
            if data[pos] != 0xFF:
                pos += 1
                break
            pos += 1
        self.queue_buffer(data[pos:pos + n], pts=self._frag_pts)
