"""Sans-IO ICE agent (RFC 8445, lite + full-controlling modes).

The reference's webrtcbin2 gets ICE from str0m; this rebuilds the
connectivity-check machinery over gstpu.net.webrtc.stun: candidate
lines, short-term-credential binding checks, role/nomination, and a
poll-based driving model (handle_packet / poll_transmit) so the
element layer owns the sockets.

The port's copy of gstpu/net/webrtc/ice.py, as it stands.
"""

from __future__ import annotations

import hashlib
import os
import struct
from dataclasses import dataclass, field

from gstpu_torch.net.webrtc.stun import (ATTR_ICE_CONTROLLED,
                                         ATTR_ICE_CONTROLLING, ATTR_PRIORITY,
                                         ATTR_USE_CANDIDATE, ATTR_USERNAME,
                                         ATTR_XOR_MAPPED_ADDRESS,
                                         BINDING_ERROR, BINDING_REQUEST,
                                         BINDING_SUCCESS, StunError,
                                         StunMessage, is_stun,
                                         unxor_address)

Addr = tuple[str, int]


@dataclass
class Candidate:
    foundation: str
    component: int
    transport: str      # "udp"
    priority: int
    address: str
    port: int
    typ: str            # host | srflx | relay

    @property
    def addr(self) -> Addr:
        return (self.address, self.port)

    def to_sdp(self) -> str:
        return (f"candidate:{self.foundation} {self.component} "
                f"{self.transport} {self.priority} {self.address} "
                f"{self.port} typ {self.typ}")

    @staticmethod
    def parse(line: str) -> "Candidate":
        line = line.strip()
        if line.startswith("a="):
            line = line[2:]
        if line.startswith("candidate:"):
            line = line[len("candidate:"):]
        parts = line.split()
        if len(parts) < 8 or parts[6] != "typ":
            raise ValueError(f"bad candidate line: {line!r}")
        return Candidate(parts[0], int(parts[1]), parts[2].lower(),
                         int(parts[3]), parts[4], int(parts[5]),
                         parts[7])


def gather_srflx(sock, server: Addr, timeout: float = 0.5,
                 retries: int = 3) -> Candidate | None:
    """One classic STUN Binding round toward a STUN server (RFC
    8489): the XOR-MAPPED-ADDRESS of the response becomes a
    server-reflexive candidate (RFC 8445 §5.1.1.2; the reference's
    stun-server property feeds webrtcbin the same way).  Blocking but
    bounded (retries x timeout); the socket's blocking state is
    restored.  Returns None when the server never answers."""
    import select

    from gstpu_torch.net.webrtc.stun import (ATTR_XOR_MAPPED_ADDRESS,
                                             BINDING_SUCCESS, StunMessage,
                                             is_stun, unxor_address)
    req = StunMessage(BINDING_REQUEST)
    data = req.to_bytes()
    blocking = sock.getblocking()
    sock.setblocking(False)
    try:
        for _ in range(max(1, retries)):
            sock.sendto(data, server)
            r, _w, _x = select.select([sock], [], [], timeout)
            if not r:
                continue
            try:
                resp, src = sock.recvfrom(2048)
            except OSError:
                continue
            if src != server or not is_stun(resp):
                continue
            try:
                msg = StunMessage.parse(resp)
            except Exception:
                continue
            if msg.msg_type != BINDING_SUCCESS \
                    or msg.transaction_id != req.transaction_id:
                continue
            xma = msg.get(ATTR_XOR_MAPPED_ADDRESS)
            if xma is None:
                continue
            addr, port = unxor_address(xma, msg.transaction_id)
            # srflx type preference 110 (RFC 8445 §5.1.2.1 formula)
            return Candidate(f"srflx{port}", 1, "udp",
                             (110 << 24) | (65535 << 8) | 255,
                             addr, port, "srflx")
    finally:
        sock.setblocking(blocking)
    return None


def host_candidate(address: str, port: int,
                   component: int = 1) -> Candidate:
    """Host candidate with the RFC 8445 §5.1.2.1 priority formula."""
    type_pref = 126
    local_pref = 65535
    prio = ((type_pref << 24) | (local_pref << 8)
            | (256 - component))
    foundation = hashlib.sha1(
        f"host/udp/{address}".encode()).hexdigest()[:8]
    return Candidate(foundation, component, "udp", prio, address,
                     port, "host")


def relay_candidate(address: str, port: int,
                    component: int = 1) -> Candidate:
    """Relayed candidate (TURN allocation) — RFC 8445 type
    preference 0: lowest priority, used only when direct and
    reflexive paths fail."""
    type_pref = 0
    local_pref = 65535
    prio = ((type_pref << 24) | (local_pref << 8)
            | (256 - component))
    foundation = hashlib.sha1(
        f"relay/udp/{address}".encode()).hexdigest()[:8]
    return Candidate(foundation, component, "udp", prio, address,
                     port, "relay")


@dataclass
class CandidatePair:
    local: Candidate
    remote: Candidate
    state: str = "waiting"    # waiting|in-progress|succeeded|failed
    nominated: bool = False


class IceAgent:
    """One ICE agent for one component.

    Sans-IO driving contract:
    - feed incoming datagrams through handle_packet(data, src_addr)
    - drain outgoing datagrams from poll_transmit()
    - events() yields ("connected", pair) / ("failed",) transitions
    """

    def __init__(self, *, lite: bool = False, controlling: bool = False,
                 ufrag: str | None = None, pwd: str | None = None):
        self.lite = lite
        self.controlling = controlling and not lite
        self.local_ufrag = ufrag or os.urandom(3).hex()
        self.local_pwd = pwd or os.urandom(12).hex()
        self.remote_ufrag: str | None = None
        self.remote_pwd: str | None = None
        self.local_candidates: list[Candidate] = []
        self.remote_candidates: list[Candidate] = []
        self.pairs: list[CandidatePair] = []
        self.selected: CandidatePair | None = None
        self.tiebreaker = struct.unpack(">Q", os.urandom(8))[0]
        self._outbox: list[tuple[bytes, Addr]] = []
        self._events: list[tuple] = []
        self._pending: dict[bytes, CandidatePair] = {}

    # -- configuration -----------------------------------------------------
    def add_local_candidate(self, cand: Candidate) -> None:
        self.local_candidates.append(cand)
        self._form_pairs()

    def set_remote_credentials(self, ufrag: str, pwd: str) -> None:
        self.remote_ufrag = ufrag
        self.remote_pwd = pwd

    def add_remote_candidate(self, cand: Candidate) -> None:
        self.remote_candidates.append(cand)
        self._form_pairs()

    def _form_pairs(self) -> None:
        seen = {(id(p.local), id(p.remote)) for p in self.pairs}
        for lc in self.local_candidates:
            for rc in self.remote_candidates:
                if lc.component != rc.component:
                    continue
                if (id(lc), id(rc)) in seen:
                    continue
                self.pairs.append(CandidatePair(lc, rc))
        # RFC 8445 pair priority ordering (simplified: remote prio)
        self.pairs.sort(key=lambda p: -(p.local.priority
                                        + p.remote.priority))

    # -- sans-IO surface -----------------------------------------------------
    def poll_transmit(self) -> tuple[bytes, Addr] | None:
        if self._outbox:
            return self._outbox.pop(0)
        return None

    def events(self) -> list[tuple]:
        out, self._events = self._events, []
        return out

    # -- checks (controlling side) -------------------------------------------
    def start_checks(self) -> None:
        """Issue binding requests on all waiting pairs (full agent);
        an ICE-lite agent never initiates (RFC 8445 §2.5)."""
        if self.lite or self.remote_pwd is None:
            return
        for pair in self.pairs:
            if pair.state != "waiting":
                continue
            pair.state = "in-progress"
            msg = StunMessage(BINDING_REQUEST)
            msg.add_username(f"{self.remote_ufrag}:{self.local_ufrag}")
            msg.add_priority(pair.local.priority)
            if self.controlling:
                msg.add(ATTR_ICE_CONTROLLING,
                        struct.pack(">Q", self.tiebreaker))
                msg.add(ATTR_USE_CANDIDATE, b"")  # aggressive nomination
            else:
                msg.add(ATTR_ICE_CONTROLLED,
                        struct.pack(">Q", self.tiebreaker))
            data = msg.to_bytes(self.remote_pwd.encode())
            self._pending[msg.transaction_id] = pair
            self._outbox.append((data, pair.remote.addr))

    # -- packet ingestion ------------------------------------------------------
    def handle_packet(self, data: bytes, src: Addr) -> bool:
        """Returns True if the datagram was consumed as STUN.
        Malformed attribute contents are dropped, never raised."""
        if not is_stun(data):
            return False
        try:
            msg = StunMessage.parse(data)
            if msg.msg_type == BINDING_REQUEST:
                self._handle_request(msg, data, src)
            elif msg.msg_type == BINDING_SUCCESS:
                self._handle_success(msg, data, src)
            elif msg.msg_type == BINDING_ERROR:
                self._handle_error(msg, data)
        except (StunError, struct.error, IndexError, ValueError):
            pass                      # malformed STUN: drop
        return True

    def _handle_error(self, msg: StunMessage, data: bytes) -> None:
        pair = self._pending.get(msg.transaction_id)
        if pair is None:
            return
        # only authenticated error responses may fail a pair —
        # unauthenticated BINDING_ERROR is trivially spoofable
        if not (self.remote_pwd
                and msg.verify_integrity(self.remote_pwd.encode(),
                                         data)):
            return
        self._pending.pop(msg.transaction_id, None)
        pair.state = "failed"
        if all(p.state == "failed" for p in self.pairs):
            self._events.append(("failed",))

    def _handle_request(self, msg: StunMessage, data: bytes,
                        src: Addr) -> None:
        # short-term credentials: USERNAME = local:remote,
        # MESSAGE-INTEGRITY keyed with OUR password
        username = msg.get(ATTR_USERNAME)
        ok = (username is not None
              and username.decode("latin1")
              .startswith(self.local_ufrag + ":")
              and msg.verify_integrity(self.local_pwd.encode(), data))
        if not ok:
            err = StunMessage(BINDING_ERROR, msg.transaction_id)
            err.add_error(401, "Unauthorized")
            self._outbox.append((err.to_bytes(), src))
            return
        resp = StunMessage(BINDING_SUCCESS, msg.transaction_id)
        resp.add_xor_mapped_address(src)
        self._outbox.append(
            (resp.to_bytes(self.local_pwd.encode()), src))
        # peer-reflexive discovery + nomination (lite agents accept
        # the controlling side's USE-CANDIDATE)
        pair = self._pair_for_remote(src, msg)
        if msg.get(ATTR_USE_CANDIDATE) is not None and pair:
            pair.state = "succeeded"
            pair.nominated = True
            if self.selected is None:
                self.selected = pair
                self._events.append(("connected", pair))

    def _handle_success(self, msg: StunMessage, data: bytes,
                        src: Addr) -> None:
        pair = self._pending.pop(msg.transaction_id, None)
        if pair is None:
            return
        if self.remote_pwd and not msg.verify_integrity(
                self.remote_pwd.encode(), data):
            pair.state = "failed"
            return
        xma = msg.get(ATTR_XOR_MAPPED_ADDRESS)
        if xma is not None:
            unxor_address(xma, msg.transaction_id)  # validates shape
        pair.state = "succeeded"
        if self.controlling:
            pair.nominated = True
        if pair.nominated and self.selected is None:
            self.selected = pair
            self._events.append(("connected", pair))

    def _pair_for_remote(self, src: Addr, msg: StunMessage):
        for pair in self.pairs:
            if pair.remote.addr == src:
                return pair
        # peer-reflexive: learn the candidate from the request
        prio_attr = msg.get(ATTR_PRIORITY)
        prio = struct.unpack(">I", prio_attr)[0] if prio_attr \
            else 0
        cand = Candidate("prflx", 1, "udp", prio, src[0], src[1],
                         "prflx")
        self.remote_candidates.append(cand)
        self._form_pairs()
        for pair in self.pairs:
            if pair.remote.addr == src:
                return pair
        return None
