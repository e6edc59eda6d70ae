"""WebRtcTransport: the sans-IO composition of ICE + DTLS + SRTP.

This is the role str0m plays inside the reference's webrtcbin2
(net/webrtc/src/webrtcbin2): one object that owns the connectivity
checks, the DTLS-SRTP handshake, and the RTP protection for a single
bundled transport, driven entirely by the element layer's sockets.

Demux follows RFC 7983: first byte 0..3 = STUN, 20..63 = DTLS,
128..191 = RTP/RTCP.

The port's copy of gstpu/net/webrtc/transport.py, as it stands.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from gstpu_torch.net.srtp import SrtcpContext, SrtpContext
from gstpu_torch.net.webrtc.dtls import DtlsEndpoint, fingerprint
from gstpu_torch.net.webrtc.ice import Addr, Candidate, IceAgent

_RTCP_PTS = set(range(64, 96))  # RTCP packet types 192..223 & 0x7F… n/a


@dataclass
class RemoteDescription:
    ufrag: str
    pwd: str
    fingerprint: str
    candidates: list[Candidate] = field(default_factory=list)


class WebRtcTransport:
    """One bundled ICE/DTLS/SRTP transport.

    Driving contract:
    - add_local_candidate(), local_description()
    - set_remote_description(RemoteDescription)
    - handle_packet(datagram, src) -> ("rtp"|"rtcp", bytes) | None
    - send_rtp(packet) queues a protected datagram
    - poll_transmit() -> (datagram, addr) | None
    - .connected after ICE + DTLS complete
    """

    def __init__(self, *, controlling: bool, certificate=None,
                 ice_lite: bool = False):
        self.ice = IceAgent(lite=ice_lite, controlling=controlling)
        # WebRTC convention: the controlling/offering side is the
        # DTLS client when it sends `a=setup:active`
        self.dtls = DtlsEndpoint(client=controlling,
                                 certificate=certificate)
        self.controlling = controlling
        self._srtp_tx: SrtpContext | None = None
        self._srtp_rx: SrtpContext | None = None
        self._srtcp_tx: SrtcpContext | None = None
        self._srtcp_rx: SrtcpContext | None = None
        self._dtls_started = False
        self._remote: RemoteDescription | None = None
        self.sctp = None                  # SctpAssociation when enabled

    # -- signalling ------------------------------------------------------
    def add_local_candidate(self, cand: Candidate) -> None:
        self.ice.add_local_candidate(cand)

    def local_description(self) -> dict:
        """The transport attributes for the SDP (m-line level)."""
        return {
            "ice-ufrag": self.ice.local_ufrag,
            "ice-pwd": self.ice.local_pwd,
            "fingerprint": self.dtls.local_fingerprint,
            "setup": "active" if self.controlling else "passive",
            "candidates": [c.to_sdp()
                           for c in self.ice.local_candidates],
        }

    def set_remote_description(self, remote: RemoteDescription) -> None:
        self._remote = remote
        self.ice.set_remote_credentials(remote.ufrag, remote.pwd)
        self.dtls.remote_fingerprint = remote.fingerprint
        for c in remote.candidates:
            self.ice.add_remote_candidate(c)
        if self.controlling:
            self.ice.start_checks()

    # -- state -----------------------------------------------------------
    @property
    def ice_connected(self) -> bool:
        return self.ice.selected is not None

    @property
    def connected(self) -> bool:
        return self.ice_connected and self.dtls.connected

    @property
    def peer_addr(self) -> Addr | None:
        sel = self.ice.selected
        return sel.remote.addr if sel else None

    # -- dataflow ----------------------------------------------------------
    def _after_ice(self) -> None:
        if self.controlling and not self._dtls_started:
            self._dtls_started = True
            self.dtls.handshake()

    def _after_dtls(self) -> None:
        if self._srtp_tx is not None:
            self._pump_sctp()
            return
        keys = self.dtls.srtp_keys
        is_client = self.dtls.is_client
        k, s = keys.send_key_salt(is_client)
        self._srtp_tx = SrtpContext(k, s)
        self._srtcp_tx = SrtcpContext(k, s)
        k, s = keys.recv_key_salt(is_client)
        self._srtp_rx = SrtpContext(k, s)
        self._srtcp_rx = SrtcpContext(k, s)
        if self.sctp is not None and self.dtls.is_client:
            self.sctp.connect()
            self._pump_sctp()

    # -- data channels (SCTP over DTLS, RFC 8261/8831) -------------------
    def enable_data_channels(self) -> None:
        """Attach an SCTP association riding DTLS application data;
        channels appear in .sctp.events after .connected."""
        if self.sctp is None:
            from gstpu_torch.net.webrtc.sctp import SctpAssociation
            self.sctp = SctpAssociation(client=self.dtls.is_client)

    def create_data_channel(self, label: str) -> int:
        assert self.sctp is not None, "enable_data_channels() first"
        sid = self.sctp.create_channel(label)
        self._pump_sctp()
        return sid

    def send_data(self, sid: int, data: bytes, *,
                  binary: bool = True) -> None:
        self.sctp.send(sid, data, binary=binary)
        self._pump_sctp()

    def _pump_sctp(self) -> None:
        if self.sctp is None or not self.dtls.connected:
            return
        for pkt in self.dtls.app_inbox:
            self.sctp.handle_packet(pkt)
        self.dtls.app_inbox.clear()
        while (out := self.sctp.poll_transmit()) is not None:
            self.dtls.send_application(out)

    def handle_packet(self, data: bytes,
                      src: Addr) -> tuple[str, bytes] | None:
        if not data:
            return None
        b0 = data[0]
        if b0 < 4:
            if self.ice.handle_packet(data, src):
                for ev in self.ice.events():
                    if ev[0] == "connected":
                        self._after_ice()
                return None
        if 20 <= b0 <= 63:
            self.dtls.handle_packet(data)
            if self.dtls.connected:
                self._after_dtls()
            return None
        if 128 <= b0 <= 191 and self._srtp_rx is not None:
            # RFC 5761 demux: RTCP packet types 192..223 in byte 1
            if 192 <= data[1] <= 223:
                try:
                    return ("rtcp", self._srtcp_rx.unprotect(data))
                except ValueError:
                    return None         # forged/replayed SRTCP
            plain = self._srtp_rx.unprotect(data)
            if plain is not None:
                return ("rtp", plain)
        return None

    def send_rtcp(self, packet: bytes) -> bool:
        """Protect + queue an RTCP packet (RFC 5761 muxed on the
        same transport; SRTCP per RFC 3711 §3.4)."""
        if self._srtcp_tx is None or self.peer_addr is None:
            return False
        self._outbox_media = getattr(self, "_outbox_media", [])
        self._outbox_media.append(
            (self._srtcp_tx.protect(packet), self.peer_addr))
        return True

    def send_rtp(self, packet: bytes) -> bool:
        if self._srtp_tx is None or self.peer_addr is None:
            return False
        self._outbox_media = getattr(self, "_outbox_media", [])
        self._outbox_media.append(
            (self._srtp_tx.protect(packet), self.peer_addr))
        return True

    def poll_transmit(self) -> tuple[bytes, Addr] | None:
        t = self.ice.poll_transmit()
        if t is not None:
            return t
        if self.ice_connected:
            d = self.dtls.poll_transmit()
            if d is not None:
                return (d, self.peer_addr)
            if self.dtls.connected:
                self._after_dtls()
        media = getattr(self, "_outbox_media", None)
        if media:
            return media.pop(0)
        return None


# ---------------------------------------------------------------------------
# SDP plumbing (the a= attributes webrtcsink/webrtcsrc exchange)
# ---------------------------------------------------------------------------

def sdp_transport_lines(tr: WebRtcTransport) -> list[str]:
    d = tr.local_description()
    lines = [f"a=ice-ufrag:{d['ice-ufrag']}",
             f"a=ice-pwd:{d['ice-pwd']}",
             f"a=fingerprint:{d['fingerprint']}",
             f"a=setup:{d['setup']}"]
    lines += [f"a={c}" for c in d["candidates"]]
    return lines


def parse_sdp_transport(sdp: str) -> RemoteDescription | None:
    ufrag = pwd = fp = None
    cands = []
    for raw in sdp.splitlines():
        line = raw.strip()
        if line.startswith("a=ice-ufrag:"):
            ufrag = line.split(":", 1)[1]
        elif line.startswith("a=ice-pwd:"):
            pwd = line.split(":", 1)[1]
        elif line.startswith("a=fingerprint:"):
            fp = line.split(":", 1)[1]
        elif line.startswith("a=candidate:"):
            try:
                cands.append(Candidate.parse(line))
            except ValueError:
                continue
    if ufrag is None or pwd is None or fp is None:
        return None
    return RemoteDescription(ufrag, pwd, fp, cands)
