"""Sans-IO RTP session state machine.

Retains the reference rtpbin2 architecture verbatim at the design
level (net/rtp/src/rtpbin2/session.rs:71-412: pure handle_send /
handle_recv / poll_rtcp functions with injected timestamps — no
sockets, no clocks), with our own implementation: per-SSRC source
accounting (RFC 3550 appendix A: seqnum cycles, jitter, loss
fraction), RTCP SR/RR/SDES/BYE scheduling, inter-stream sync data from
SR NTP<->RTP mappings.

The port's copy of gstpu/net/rtp/session.py, as it stands.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from gstpu_torch.net.rtp.packet import (Bye, ReceiverReport, ReportBlock,
                                        RtpPacket, Sdes, SenderReport, ntp_from_ns,
                                        parse_rtcp)

SECOND = 1_000_000_000
RTCP_MIN_INTERVAL = 5 * SECOND
SOURCE_TIMEOUT_INTERVALS = 5


class RecvReply(enum.Enum):
    NEW_SSRC = "new-ssrc"      # call again
    PASSTHROUGH = "passthrough"
    DROP = "drop"
    IGNORE = "ignore"


class SendReply(enum.Enum):
    NEW_SSRC = "new-ssrc"
    PASSTHROUGH = "passthrough"
    DROP = "drop"
    SSRC_COLLISION = "ssrc-collision"


@dataclass
class LocalSender:
    ssrc: int
    payload_type: int
    clock_rate: int = 0
    packet_count: int = 0
    octet_count: int = 0
    last_rtp_ts: int = 0
    last_send_time: int | None = None


@dataclass
class RemoteSource:
    ssrc: int
    payload_type: int
    clock_rate: int = 0
    probation: int = 0
    base_seq: int = 0
    max_seq: int = 0
    cycles: int = 0
    received: int = 0
    expected_prior: int = 0
    received_prior: int = 0
    jitter: float = 0.0
    last_transit: int | None = None
    last_activity: int | None = None
    last_sr_ntp: int | None = None
    last_sr_rtp: int | None = None
    last_sr_recv_time: int | None = None
    byed: bool = False

    @property
    def ext_highest_seq(self) -> int:
        return (self.cycles << 16) | self.max_seq

    def init_seq(self, seq: int) -> None:
        self.base_seq = seq
        self.max_seq = seq
        self.cycles = 0
        self.received = 1

    def update_seq(self, seq: int) -> bool:
        """Returns False if the packet looks bogus/duplicated-late."""
        udelta = (seq - self.max_seq) & 0xFFFF
        MAX_DROPOUT = 3000
        MAX_MISORDER = 100
        if udelta < MAX_DROPOUT:
            if seq < self.max_seq:
                self.cycles += 1
            self.max_seq = seq
        elif udelta <= 0xFFFF - MAX_MISORDER:
            # large jump: restart sequence accounting
            self.init_seq(seq)
            return True
        self.received += 1
        return True

    def update_jitter(self, rtp_ts: int, now: int) -> None:
        if not self.clock_rate:
            return
        arrival_rtp = now * self.clock_rate // SECOND
        transit = arrival_rtp - rtp_ts
        if self.last_transit is not None:
            d = abs(transit - self.last_transit)
            self.jitter += (d - self.jitter) / 16.0
        self.last_transit = transit

    def report_block(self, now: int) -> ReportBlock:
        expected = self.ext_highest_seq - self.base_seq + 1
        lost = expected - self.received
        exp_int = expected - self.expected_prior
        rec_int = self.received - self.received_prior
        self.expected_prior = expected
        self.received_prior = self.received
        lost_int = exp_int - rec_int
        fraction = 0
        if exp_int > 0 and lost_int > 0:
            fraction = min(255, (lost_int << 8) // exp_int)
        lsr = 0
        dlsr = 0
        if self.last_sr_ntp is not None:
            lsr = (self.last_sr_ntp >> 16) & 0xFFFFFFFF
            dlsr = int((now - self.last_sr_recv_time) * 65536 // SECOND)
        return ReportBlock(self.ssrc, fraction, max(lost, 0),
                           self.ext_highest_seq, int(self.jitter),
                           lsr, dlsr)


class Session:
    """One RTP session (one media stream family, N SSRCs)."""

    def __init__(self, cname: str = "gstpu@localhost"):
        self.cname = cname.encode()
        self.local_senders: dict[int, LocalSender] = {}
        self.remote_sources: dict[int, RemoteSource] = {}
        self.pt_clock_rates: dict[int, int] = {}
        self._next_rtcp_time: int | None = None
        self._last_rtcp_time: int | None = None
        self.rtcp_interval = RTCP_MIN_INTERVAL

    # -- configuration -------------------------------------------------
    def set_pt_clock_rate(self, pt: int, clock_rate: int) -> None:
        self.pt_clock_rates[pt] = clock_rate

    # -- send path -----------------------------------------------------
    def handle_send(self, packet: RtpPacket, now: int) -> SendReply:
        if packet.ssrc in self.remote_sources:
            return SendReply.SSRC_COLLISION
        s = self.local_senders.get(packet.ssrc)
        if s is None:
            self.local_senders[packet.ssrc] = LocalSender(
                packet.ssrc, packet.payload_type,
                self.pt_clock_rates.get(packet.payload_type, 0))
            return SendReply.NEW_SSRC
        s.packet_count += 1
        s.octet_count += len(packet.payload)
        s.last_rtp_ts = packet.timestamp
        s.last_send_time = now
        if self._next_rtcp_time is None:
            self._next_rtcp_time = now + self.rtcp_interval
        return SendReply.PASSTHROUGH

    # -- receive path --------------------------------------------------
    def handle_recv(self, packet: RtpPacket, now: int) -> RecvReply:
        src = self.remote_sources.get(packet.ssrc)
        if src is None:
            src = RemoteSource(packet.ssrc, packet.payload_type,
                               self.pt_clock_rates.get(
                                   packet.payload_type, 0))
            src.init_seq(packet.seqnum)
            src.last_activity = now
            self.remote_sources[packet.ssrc] = src
            if self._next_rtcp_time is None:
                self._next_rtcp_time = now + self.rtcp_interval
            return RecvReply.NEW_SSRC
        src.last_activity = now
        if not src.update_seq(packet.seqnum):
            return RecvReply.DROP
        src.update_jitter(packet.timestamp, now)
        return RecvReply.PASSTHROUGH

    def handle_rtcp_recv(self, data: bytes, now: int) -> list:
        """Returns a list of (kind, payload) events:
        ("bye", ssrc), ("sr", ssrc), ("sdes", ssrc, items)."""
        events = []
        for p in parse_rtcp(data):
            if isinstance(p, SenderReport):
                src = self.remote_sources.get(p.ssrc)
                if src is None:
                    src = RemoteSource(p.ssrc, 0)
                    src.init_seq(0)
                    self.remote_sources[p.ssrc] = src
                src.last_sr_ntp = p.ntp_timestamp
                src.last_sr_rtp = p.rtp_timestamp
                src.last_sr_recv_time = now
                src.last_activity = now
                events.append(("sr", p.ssrc))
            elif isinstance(p, Bye):
                for ssrc in p.ssrcs:
                    src = self.remote_sources.get(ssrc)
                    if src is not None:
                        src.byed = True
                        events.append(("bye", ssrc))
            elif isinstance(p, Sdes):
                for ssrc, items in p.chunks:
                    events.append(("sdes", ssrc, items))
            elif isinstance(p, ReceiverReport):
                events.append(("rr", p.ssrc))
        return events

    # -- RTCP generation -----------------------------------------------
    def poll_rtcp_send_timeout(self, now: int) -> int | None:
        return self._next_rtcp_time

    def poll_rtcp_send(self, now: int, unix_now: int | None = None) \
            -> bytes | None:
        """If an RTCP report is due, build the compound packet
        (SR-or-RR + SDES) and reschedule."""
        if self._next_rtcp_time is None or now < self._next_rtcp_time:
            return None
        self._next_rtcp_time = now + self.rtcp_interval
        self._last_rtcp_time = now
        unix_now = unix_now if unix_now is not None else now

        reports = [src.report_block(now)
                   for src in self.remote_sources.values()
                   if not src.byed and src.received > 0]

        out = b""
        sdes_ssrcs = []
        senders = [s for s in self.local_senders.values()
                   if s.last_send_time is not None]
        if senders:
            for i, s in enumerate(senders):
                rtp_now = s.last_rtp_ts
                if s.clock_rate and s.last_send_time is not None:
                    rtp_now += (now - s.last_send_time) * s.clock_rate \
                        // SECOND
                sr = SenderReport(s.ssrc, ntp_from_ns(unix_now), rtp_now,
                                  s.packet_count, s.octet_count,
                                  reports if i == 0 else [])
                out += sr.to_bytes()
                sdes_ssrcs.append(s.ssrc)
        else:
            ssrc = next(iter(self.local_senders), 0) or 0
            out += ReceiverReport(ssrc, reports).to_bytes()
            sdes_ssrcs.append(ssrc)

        sdes = Sdes([(s, [(Sdes.CNAME, self.cname)])
                     for s in sdes_ssrcs])
        out += sdes.to_bytes()
        return out

    def bye(self, reason: bytes = b"") -> bytes:
        ssrcs = list(self.local_senders)
        return Bye(ssrcs, reason).to_bytes() if ssrcs else b""

    # -- housekeeping --------------------------------------------------
    def timed_out_sources(self, now: int) -> list[int]:
        limit = SOURCE_TIMEOUT_INTERVALS * self.rtcp_interval
        out = [ssrc for ssrc, s in self.remote_sources.items()
               if s.last_activity is not None
               and now - s.last_activity > limit]
        for ssrc in out:
            del self.remote_sources[ssrc]
        return out

    # -- A/V sync (reference rtpbin2/sync.rs) ---------------------------
    def ntp_rtp_mapping(self, ssrc: int) -> tuple[int, int] | None:
        """Latest SR (ntp_ns, rtp_ts) pair for inter-stream sync."""
        src = self.remote_sources.get(ssrc)
        if src is None or src.last_sr_ntp is None:
            return None
        from gstpu_torch.net.rtp.packet import ns_from_ntp
        return ns_from_ntp(src.last_sr_ntp), src.last_sr_rtp
