"""QUIC v1 connection (RFC 9000): packet spaces, frames, and the TLS
handshake driving key installation.

Sans-IO: handle_datagram(bytes, now) ingests, poll_transmit() drains
datagrams, events() yields ("stream", id, data, fin) /
("datagram", data) / ("connected",) / ("closed", code). Streams and
DATAGRAM frames (RFC 9221) are exposed for the quinn elements.

Loss recovery & congestion control are RFC 9002 (gstpu/net/quic/
recovery.py — the machinery the reference delegates to quinn-proto):
RTT estimation from ack-eliciting ACKs, packet- and time-threshold
loss detection with retransmission, PTO with exponential backoff
(on_timeout(now) / poll_timeout()), NewReno cwnd gating of 1-RTT
sends with an advisory pacing interval, and honest multi-range ACK
frames built from the real received-pn interval set.  Time is an
injected monotonic-seconds value (wall-clock when omitted), so lossy
paths are testable deterministically.

The port's copy of gstpu/net/quic/connection.py, as it stands.
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass, field

from gstpu_torch.net.quic import tls13
from gstpu_torch.net.quic.recovery import (NewReno, RangeSet, RttEstimator,
                                           SentPacket)
from gstpu_torch.net.quic.packet import (PT_HANDSHAKE, PT_INITIAL,
                                         DirectionKeys, PlainPacket,
                                         QuicError, build_packet,
                                         decode_varint, encode_varint,
                                         initial_keys, unprotect_packet)

# frame types
F_PADDING = 0x00
F_PING = 0x01
F_ACK = 0x02
F_CRYPTO = 0x06
F_NEW_TOKEN = 0x07
F_STREAM_BASE = 0x08          # 0x08..0x0f
F_MAX_DATA = 0x10
F_MAX_STREAM_DATA = 0x11
F_CONNECTION_CLOSE = 0x1C
F_CONNECTION_CLOSE_APP = 0x1D
F_HANDSHAKE_DONE = 0x1E
F_DATAGRAM = 0x30             # 0x30 (no len) / 0x31 (with len)

_SPACES = (tls13.INITIAL, tls13.HANDSHAKE, tls13.APPLICATION)


@dataclass
class _Space:
    write: DirectionKeys | None = None
    read: DirectionKeys | None = None
    next_pn: int = 0
    largest_recv: int = -1
    pending: list[bytes] = field(default_factory=list)  # frames out
    # pn -> SentPacket, for loss detection + retransmission
    unacked: dict[int, SentPacket] = field(default_factory=dict)
    recv: RangeSet = field(default_factory=RangeSet)
    last_eliciting: float | None = None


def _keys_from_secret(secret: bytes) -> DirectionKeys:
    return DirectionKeys.from_secret(secret)


class QuicConnection:
    """One QUIC connection endpoint."""

    def __init__(self, *, client: bool, alpn: str = "gstpu-quic",
                 certificate=None,
                 remote_fingerprint: str | None = None):
        self.is_client = client
        self.local_cid = os.urandom(8)
        self.remote_cid = os.urandom(8)   # client: provisional DCID
        self.connected = False
        self.closed: int | None = None
        self.tls = tls13.Tls13Machine(
            client=client, alpn=alpn, certificate=certificate,
            remote_fingerprint=remote_fingerprint)
        self._spaces = {lvl: _Space() for lvl in _SPACES}
        self.rtt = RttEstimator()
        self.cc = NewReno()
        self._pto_count = 0
        self._events: list[tuple] = []
        self._outbox: list[bytes] = []
        self._streams_rx: dict[int, bytearray] = {}
        self._next_stream_id = 0 if client else 1
        self._handshake_done_sent = False
        if client:
            w, r = initial_keys(self.remote_cid, True)
            sp = self._spaces[tls13.INITIAL]
            sp.write, sp.read = w, r
            self._initial_dcid = self.remote_cid

    # -- public API -----------------------------------------------------
    def connect(self) -> None:
        assert self.is_client
        self.tls.start()
        self._pump_tls()
        self._flush()

    def events(self) -> list[tuple]:
        out, self._events = self._events, []
        return out

    def poll_transmit(self) -> bytes | None:
        if self._outbox:
            return self._outbox.pop(0)
        return None

    def open_stream(self) -> int:
        sid = self._next_stream_id
        self._next_stream_id += 4        # bidi, our side
        return sid

    def open_uni_stream(self) -> int:
        sid = getattr(self, "_next_uni_id",
                      2 if self.is_client else 3)
        self._next_uni_id = sid + 4
        return sid

    def send_stream(self, stream_id: int, data: bytes,
                    fin: bool = False) -> None:
        """Queue one STREAM frame (offset accumulates per stream)."""
        offs = getattr(self, "_tx_offsets", None)
        if offs is None:
            offs = self._tx_offsets = {}
        off = offs.get(stream_id, 0)
        ftype = F_STREAM_BASE | 0x04 | 0x02 | (0x01 if fin else 0)
        frame = (bytes([ftype]) + encode_varint(stream_id)
                 + encode_varint(off) + encode_varint(len(data))
                 + data)
        offs[stream_id] = off + len(data)
        self._spaces[tls13.APPLICATION].pending.append(frame)
        self._flush()

    def send_datagram(self, data: bytes) -> None:
        frame = bytes([F_DATAGRAM | 1]) + encode_varint(len(data)) \
            + data
        self._spaces[tls13.APPLICATION].pending.append(frame)
        self._flush()

    def close(self, code: int = 0) -> None:
        frame = (bytes([F_CONNECTION_CLOSE_APP]) + encode_varint(code)
                 + encode_varint(0))
        self._spaces[tls13.APPLICATION].pending.append(frame)
        self._flush()
        self.closed = code

    def on_timeout(self, now: float | None = None) -> None:
        """Probe timeout (RFC 9002 §6.2): with `now`, fire only once
        poll_timeout() has expired and back the PTO off exponentially;
        without it (legacy callers / tests), probe immediately.  The
        probe retransmits outstanding ack-eliciting frames; the
        receiver's offset/pn dedup makes spurious copies harmless."""
        if now is not None:
            dl = self.poll_timeout()
            if dl is None or now < dl:
                return
        self._pto_count = min(self._pto_count + 1, 10)
        probed = False
        for level in _SPACES:
            sp = self._spaces[level]
            if not sp.unacked or sp.write is None:
                continue
            frames, sp.unacked = dict(sp.unacked), {}
            for pkt in frames.values():
                self.cc.bytes_in_flight = max(
                    0, self.cc.bytes_in_flight - pkt.size)
            for pn in sorted(frames):
                sp.pending.append(frames[pn].frames)
            probed = True
        if not probed and self.connected and now is not None:
            # timer-driven with nothing outstanding: PING probe
            # (§6.2.4); legacy immediate calls stay retransmit-only
            self._spaces[tls13.APPLICATION].pending.append(
                bytes([F_PING]))
        self._flush(now)

    def poll_timeout(self) -> float | None:
        """Next PTO deadline (monotonic seconds), or None when no
        ack-eliciting data is outstanding."""
        last = [sp.last_eliciting for sp in self._spaces.values()
                if sp.unacked and sp.last_eliciting is not None]
        if not last:
            return None
        return min(last) + self.rtt.pto() * (2 ** self._pto_count)

    def pacing_interval(self) -> float:
        """Advisory inter-datagram send spacing (RFC 9002 §7.7)."""
        return self.cc.pacing_interval(self.rtt)

    # -- TLS plumbing ------------------------------------------------------
    def _pump_tls(self) -> None:
        for level, msg in self.tls.outputs:
            frame = (bytes([F_CRYPTO])
                     + encode_varint(self._crypto_off(level))
                     + encode_varint(len(msg)) + msg)
            self._bump_crypto_off(level, len(msg))
            self._spaces[level].pending.append(frame)
        self.tls.outputs = []
        self._install_keys()

    def _crypto_off(self, level: int) -> int:
        offs = getattr(self, "_crypto_offsets", None)
        if offs is None:
            offs = self._crypto_offsets = {lvl: 0 for lvl in _SPACES}
        return offs[level]

    def _bump_crypto_off(self, level: int, n: int) -> None:
        self._crypto_offsets[level] += n

    def _install_keys(self) -> None:
        if self.tls.hs_secrets is not None:
            sp = self._spaces[tls13.HANDSHAKE]
            if sp.write is None:
                c, s = self.tls.hs_secrets
                mine, theirs = (c, s) if self.is_client else (s, c)
                sp.write = _keys_from_secret(mine)
                sp.read = _keys_from_secret(theirs)
        if self.tls.ap_secrets is not None:
            sp = self._spaces[tls13.APPLICATION]
            if sp.write is None:
                c, s = self.tls.ap_secrets
                mine, theirs = (c, s) if self.is_client else (s, c)
                sp.write = _keys_from_secret(mine)
                sp.read = _keys_from_secret(theirs)
        if self.tls.complete and not self.connected:
            self.connected = True
            self._events.append(("connected",))
            if not self.is_client and not self._handshake_done_sent:
                self._handshake_done_sent = True
                self._spaces[tls13.APPLICATION].pending.append(
                    bytes([F_HANDSHAKE_DONE]))

    # -- receive ----------------------------------------------------------
    def handle_datagram(self, data: bytes,
                        now: float | None = None) -> None:
        now = _time.monotonic() if now is None else now
        pos = 0
        while pos < len(data):
            chunk = data[pos:]
            if not chunk or chunk[0] == 0:
                break                       # padding tail
            try:
                consumed = self._handle_packet(chunk, now)
            except QuicError:
                if pos == 0:
                    raise
                break                       # bad coalesced tail: drop
            if consumed <= 0:
                break
            pos += consumed
        self._pump_tls()
        self._flush(now)

    def _handle_packet(self, data: bytes, now: float) -> int:
        if data[0] & 0x80:                  # long header
            ptype = (data[0] >> 4) & 0x3
            if ptype == PT_INITIAL:
                level = tls13.INITIAL
                if not self.is_client \
                        and self._spaces[level].read is None:
                    # derive initial keys from the client's DCID
                    _, _, _, _ = 0, 0, 0, 0
                    from gstpu_torch.net.quic.packet import parse_long_header
                    _, dcid, scid, _ = parse_long_header(data)
                    w, r = initial_keys(dcid, False)
                    sp = self._spaces[level]
                    sp.write, sp.read = w, r
                    self.remote_cid = scid
            elif ptype == PT_HANDSHAKE:
                level = tls13.HANDSHAKE
            else:
                raise QuicError(f"unsupported packet type {ptype}")
            sp = self._spaces[level]
            if sp.read is None:
                # keys not installed yet (the packet carrying them was
                # lost/reordered): drop; the peer's PTO retransmits
                return 0
            pkt, consumed = unprotect_packet(data, 0, sp.read,
                                             is_long=True)
            if self.is_client and level == tls13.INITIAL:
                # adopt the server's chosen CID
                self.remote_cid = pkt.scid
        else:
            level = tls13.APPLICATION
            sp = self._spaces[level]
            if sp.read is None:
                return 0          # 1-RTT before keys: drop, see above
            pkt, consumed = unprotect_packet(
                data, 0, sp.read, is_long=False,
                dcid_len=len(self.local_cid))
        sp = self._spaces[level]
        sp.largest_recv = max(sp.largest_recv, pkt.pn)
        sp.recv.add(pkt.pn)
        eliciting = self._handle_frames(level, pkt.payload, now)
        # only ack-eliciting packets get an ACK (RFC 9002 §2) — acking
        # pure-ACK packets would ping-pong forever
        if eliciting:
            sp.pending.append(self._ack_frame(sp))
        return consumed

    def _ack_frame(self, sp: _Space) -> bytes:
        """Honest multi-range ACK from the received-pn set: holes
        stay holes so the peer's loss detection can work."""
        ranges = sp.recv.descending()[:32]
        if not ranges:
            return (bytes([F_ACK]) + encode_varint(0)
                    + encode_varint(0) + encode_varint(0)
                    + encode_varint(0))
        lo0, hi0 = ranges[0]
        out = (bytes([F_ACK]) + encode_varint(hi0)
               + encode_varint(0)                    # delay
               + encode_varint(len(ranges) - 1)
               + encode_varint(hi0 - lo0))           # first range
        prev_lo = lo0
        for lo, hi in ranges[1:]:
            out += encode_varint(prev_lo - hi - 2)   # gap
            out += encode_varint(hi - lo)            # range length
            prev_lo = lo
        return out

    def _deliver_stream(self, sid: int, off: int, data: bytes,
                        fin: bool) -> None:
        """Offset-ordered delivery: duplicates (e.g. from a spurious
        probe retransmission) are dropped, out-of-order segments are
        buffered until the gap fills."""
        st = self._streams_rx.setdefault(
            sid, {"next": 0, "ooo": {}, "fin_at": None})
        if fin:
            st["fin_at"] = off + len(data)
        end = off + len(data)
        if end <= st["next"] and not (fin and end == st["next"]):
            return                       # pure duplicate
        if off > st["next"]:
            if len(st["ooo"]) < 4096:    # bound: drop beyond window
                st["ooo"][off] = data    # hole before this segment
            return
        if off < st["next"]:             # partial overlap: trim
            data = data[st["next"] - off:]
        st["next"] = end if end > st["next"] else st["next"]
        emit_fin = st["fin_at"] == st["next"]
        if data or emit_fin:
            self._events.append(("stream", sid, data, emit_fin))
        # drain any now-contiguous buffered segments
        while st["ooo"]:
            nxt = st["ooo"].pop(st["next"], None)
            if nxt is None:
                # also allow overlapping buffered segments
                cand = [o for o in st["ooo"] if o < st["next"]]
                if not cand:
                    break
                o = cand[0]
                seg = st["ooo"].pop(o)
                nxt = seg[st["next"] - o:] \
                    if o + len(seg) > st["next"] else b""
            st["next"] += len(nxt)
            emit_fin = st["fin_at"] == st["next"]
            if nxt or emit_fin:
                self._events.append(("stream", sid, nxt, emit_fin))

    def _handle_frames(self, level: int, payload: bytes,
                       now: float | None = None) -> bool:
        """Process frames; return True if any was ack-eliciting."""
        eliciting = False
        pos = 0
        while pos < len(payload):
            ftype = payload[pos]
            pos += 1
            if ftype == F_PADDING:
                continue
            if ftype == F_PING:
                eliciting = True
                continue
            if ftype in (F_ACK, F_ACK | 1):
                largest, pos = decode_varint(payload, pos)
                delay, pos = decode_varint(payload, pos)
                nrange, pos = decode_varint(payload, pos)
                first, pos = decode_varint(payload, pos)
                # keep peer-controlled ranges as [lo, hi] intervals —
                # never materialize them (a hostile first_range of
                # ~2^62 must not allocate)
                acked = [(largest - first, largest)]
                hi = largest - first
                for _ in range(nrange):
                    gap, pos = decode_varint(payload, pos)
                    rlen, pos = decode_varint(payload, pos)
                    hi = hi - gap - 2
                    acked.append((hi - rlen, hi))
                    hi -= rlen
                if ftype & 1:                       # ECN counts
                    for _ in range(3):
                        _, pos = decode_varint(payload, pos)
                self._on_ack(level, acked, largest,
                             _time.monotonic() if now is None else now)
                continue
            if ftype == F_CRYPTO:
                eliciting = True
                off, pos = decode_varint(payload, pos)
                ln, pos = decode_varint(payload, pos)
                self.tls.feed(level, payload[pos:pos + ln])
                pos += ln
                continue
            if F_STREAM_BASE <= ftype <= 0x0F:
                eliciting = True
                sid, pos = decode_varint(payload, pos)
                off = 0
                if ftype & 0x04:
                    off, pos = decode_varint(payload, pos)
                if ftype & 0x02:
                    ln, pos = decode_varint(payload, pos)
                else:
                    ln = len(payload) - pos
                data = payload[pos:pos + ln]
                pos += ln
                fin = bool(ftype & 0x01)
                self._deliver_stream(sid, off, data, fin)
                continue
            if ftype in (F_DATAGRAM, F_DATAGRAM | 1):
                eliciting = True
                if ftype & 1:
                    ln, pos = decode_varint(payload, pos)
                else:
                    ln = len(payload) - pos
                self._events.append(("datagram",
                                     payload[pos:pos + ln]))
                pos += ln
                continue
            if ftype in (F_CONNECTION_CLOSE, F_CONNECTION_CLOSE_APP):
                code, pos = decode_varint(payload, pos)
                if ftype == F_CONNECTION_CLOSE:
                    _, pos = decode_varint(payload, pos)  # frame type
                rlen, pos = decode_varint(payload, pos)
                pos += rlen
                self.closed = code
                self._events.append(("closed", code))
                continue
            if ftype == F_HANDSHAKE_DONE:
                eliciting = True
                continue
            if ftype in (F_MAX_DATA, F_MAX_STREAM_DATA):
                eliciting = True
                _, pos = decode_varint(payload, pos)
                if ftype == F_MAX_STREAM_DATA:
                    _, pos = decode_varint(payload, pos)
                continue
            raise QuicError(f"unhandled frame type {ftype:#x}")
        return eliciting

    def _on_ack(self, level: int, acked: list, largest: int,
                now: float) -> None:
        """RFC 9002 §5/§6: RTT sample from the largest newly-acked
        ack-eliciting packet, cwnd growth, then packet- and
        time-threshold loss detection with retransmission.

        `acked` is a list of [lo, hi] packet-number intervals; the
        intersection with our own sent-packet space bounds the work
        regardless of what the peer claims."""
        sp = self._spaces[level]
        newly = sorted(pn for pn in sp.unacked
                       if any(lo <= pn <= hi for lo, hi in acked))
        if not newly:
            return
        top = newly[-1]
        if top == largest and sp.unacked[top].ack_eliciting:
            self.rtt.update(max(now - sp.unacked[top].time_sent, 0.0))
        for pn in newly:
            pkt = sp.unacked.pop(pn)
            if pkt.ack_eliciting:
                self.cc.on_acked(pkt.size, pkt.time_sent)
        self._pto_count = 0
        # loss detection on remaining outstanding packets
        delay = self.rtt.loss_delay()
        # both thresholds apply only to packets sent prior to the
        # largest newly-acked one (RFC 9002 §6.1) — newer packets must
        # not be aged out under delayed ACKs
        lost = [pn for pn, pkt in sp.unacked.items()
                if pn <= top and (pn <= top - 3
                                  or pkt.time_sent <= now - delay)]
        for pn in sorted(lost):
            pkt = sp.unacked.pop(pn)
            self.cc.on_lost(pkt.size, pkt.time_sent, now)
            sp.pending.append(pkt.frames)        # retransmit
        if sp.unacked:
            sp.last_eliciting = max(p.time_sent
                                    for p in sp.unacked.values())

    # -- send -------------------------------------------------------------
    _MAX_PAYLOAD = 1160       # frames per datagram (QUIC overhead out)

    def _flush(self, now: float | None = None) -> None:
        now = _time.monotonic() if now is None else now
        for level in _SPACES:
            sp = self._spaces[level]
            while sp.pending and sp.write is not None:
                # pack whole frames up to the datagram budget (an
                # oversized single frame ships alone); never split a
                # frame across packets
                batch, size = [], 0
                while sp.pending:
                    f = sp.pending[0]
                    if batch and size + len(f) > self._MAX_PAYLOAD:
                        break
                    batch.append(sp.pending.pop(0))
                    size += len(f)
                    if size > self._MAX_PAYLOAD:
                        break
                payload = b"".join(batch)
                # remember ack-eliciting frames for loss recovery
                eliciting = b"".join(
                    f for f in batch
                    if f and f[0] not in (F_PADDING, F_ACK, F_ACK | 1))
                if level == tls13.APPLICATION and eliciting \
                        and not self.cc.can_send(len(payload) + 32):
                    # cwnd-blocked: requeue and retry on the next ack
                    sp.pending = batch + sp.pending
                    break
                # AEAD sampling needs >= 4 bytes past the pn: pad tiny
                # payloads
                if len(payload) < 4:
                    payload += bytes(4 - len(payload))
                if level == tls13.INITIAL:
                    pkt = PlainPacket(True, PT_INITIAL, self.remote_cid,
                                      self.local_cid, sp.next_pn,
                                      payload)
                elif level == tls13.HANDSHAKE:
                    pkt = PlainPacket(True, PT_HANDSHAKE,
                                      self.remote_cid, self.local_cid,
                                      sp.next_pn, payload)
                else:
                    pkt = PlainPacket(False, -1, self.remote_cid, b"",
                                      sp.next_pn, payload)
                sp.next_pn += 1
                out = build_packet(pkt, sp.write)
                if eliciting:
                    sp.unacked[pkt.pn] = SentPacket(
                        pn=pkt.pn, frames=eliciting, time_sent=now,
                        size=len(out), ack_eliciting=True)
                    sp.last_eliciting = now
                    self.cc.on_sent(len(out))
                    if len(sp.unacked) > 4096:      # bound the buffer
                        oldest = min(sp.unacked)
                        dropped = sp.unacked.pop(oldest)
                        self.cc.bytes_in_flight = max(
                            0, self.cc.bytes_in_flight - dropped.size)
                if self.is_client and level == tls13.INITIAL \
                        and len(out) < 1200:
                    # RFC 9000 §14.1: client Initial datagrams padded
                    out += bytes(1200 - len(out))
                self._outbox.append(out)
