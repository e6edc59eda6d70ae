"""The port's QUIC v1 stack, its quinn and WebTransport elements, RoQ
framing, DTLS and the anti-replay window against gstpu's, on the CPU.

Twins of all of tests/test_quic.py, tests/test_replay.py, the DTLS-only
cases of tests/test_dtls.py and the QUIC and QPACK cases of
tests/test_parser_robustness.py. Each twin is the gstpu test's body run
once with gstpu's names and once with the port's: it keeps the test's
own assertions and returns what it saw, and the two packages'
observations must be equal. What is drawn at random in both packages
(connection IDs, ECDHE keys, self-signed certificates, so every byte on
the wire after the first Initial's header) is left out of the
observations; the decrypted stream and datagram payloads, frame
contents, congestion windows and every RFC 9001 vector are compared.
Where gstpu's test waits on wall time with a 5 s deadline, the twin
waits for the same condition with a deadline that only a fault reaches.
Then the wire across packages (gstpu's quinnquicsink into the port's
quinnquicsrc and the reverse), the pinned stall of a STREAM frame larger
than the congestion window, and phase 18c's strings of `chip_smoke.py`
at 64x48 in both packages.
"""

import importlib
import random
import struct
import time

import numpy as np
import pytest

import chip_smoke
import gstpu
import gstpu_torch
from test_torch_captions import NAMES, Pkg
from torch_session import torch_test_limit  # noqa: F401

LIMIT = 60.0
W, H = 64, 48


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU."""
    gstpu.init()
    gstpu_torch.init(device="cpu")


class QPkg(Pkg):
    """Pkg with the QUIC, RoQ, DTLS and replay names."""

    def __init__(self, name: str):
        super().__init__(name)
        self.conn = self.mod("net.quic.connection")
        self.QuicConnection = self.conn.QuicConnection
        self.packet = self.mod("net.quic.packet")
        self.QuicError = self.packet.QuicError
        self.recovery = self.mod("net.quic.recovery")
        self.tls13 = self.mod("net.quic.tls13")
        self.wt = self.mod("net.quic.webtransport")
        self.roq = self.mod("net.roq")
        self.dtls = self.mod("net.webrtc.dtls")
        self.ReplayWindow = self.mod("net.replay").ReplayWindow


def _both(body):
    ref, port = (body(QPkg(name)) for name in NAMES)
    assert port == ref
    return port


def _wait(cond, *steps):
    """Run `steps` until `cond()` holds; a deadline only a fault reaches."""
    deadline = time.monotonic() + LIMIT
    while not cond():
        assert time.monotonic() < deadline, "the condition never held"
        for step in steps:
            step()
        time.sleep(0.002)


def _src_tasks(src):
    def step():
        for task in src.iterate_tasks():
            task.iterate()
    return step


# ---------------------------------------------------------------------------
# packet layer (tests/test_quic.py:24,32,46)
# ---------------------------------------------------------------------------

def test_varint_roundtrip():
    def body(P):
        out = []
        for v in (0, 1, 63, 64, 16383, 16384, 2**30 - 1, 2**30,
                  2**62 - 1):
            enc = P.packet.encode_varint(v)
            dec, pos = P.packet.decode_varint(enc, 0)
            assert dec == v and pos == len(enc)
            out.append(enc)
        return out
    _both(body)


def test_rfc9001_appendix_a_initial_keys():
    def body(P):
        dcid = bytes.fromhex("8394c8f03e515708")
        write, read = P.packet.initial_keys(dcid, is_client=True)
        assert write.key == bytes.fromhex(
            "1f369613dd76d5467730efcbe3b1a22d")
        assert write.iv == bytes.fromhex("fa044b2f42a3fd3b46fb255c")
        assert write.hp == bytes.fromhex(
            "9f50449e04a0e810283a1e9933adedd2")
        assert read.key == bytes.fromhex(
            "cf3a5331653c364c88f0f379b6067e37")
        assert read.iv == bytes.fromhex("0ac1493ca1905853b0bba03e")
        assert read.hp == bytes.fromhex(
            "c206b8d9b9f0f37644430b490eeaa314")
        return [(k.key, k.iv, k.hp) for k in (write, read)]
    _both(body)


def test_rfc9001_appendix_a2_client_initial_packet():
    def body(P):
        dcid = bytes.fromhex("8394c8f03e515708")
        write, _ = P.packet.initial_keys(dcid, is_client=True)
        crypto = bytes.fromhex(
            "060040f1010000ed0303ebf8fa56f12939b9584a3896472ec40bb863cfd3e868"
            "04fe3a47f06a2b69484c00000413011302010000c000000010000e00000b6578"
            "616d706c652e636f6dff01000100000a00080006001d00170018001000070005"
            "04616c706e000500050100000000003300260024001d00209370b2c9caa47fba"
            "baf4559fedba753de171fa71f50f1ce15d43e994ec74d748002b000302030400"
            "0d0010000e0403050306030203080408050806002d00020101001c0002400100"
            "3900320408ffffffffffffffff05048000ffff07048000ffff08011001048000"
            "75300901100f088394c8f03e51570806048000ffff")
        payload = crypto + bytes(1162 - len(crypto))
        pkt = P.packet.build_packet(
            P.packet.PlainPacket(True, P.packet.PT_INITIAL, dcid, b"", 2,
                                 payload), write)
        expect_start = bytes.fromhex(
            "c000000001088394c8f03e5157080000449e7b9aec34d1b1c98dd7689fb8ec11"
            "d242b123dc9bd8bab936b47d92ec356c0bab7df5976d27cd449f63300099f399"
            "1c260ec4c60d17b31f8429157bb35a1282a643a8d2262cad67500cadb8e7378c"
            "8eb7539ec4d4905fed1bee1fc8aafba17c750e2c7ace01e6005f80fcb7df6212")
        assert pkt[:len(expect_start)] == expect_start
        assert len(pkt) == 1200
        return pkt
    _both(body)


# ---------------------------------------------------------------------------
# connection layer, sans-IO loopback (tests/test_quic.py:91-154,326-375,
# 499-526, 585-780)
# ---------------------------------------------------------------------------

def _pump(a, b, rounds=30):
    for _ in range(rounds):
        moved = False
        while (d := a.poll_transmit()) is not None:
            b.handle_datagram(d)
            moved = True
        while (d := b.poll_transmit()) is not None:
            a.handle_datagram(d)
            moved = True
        if not moved:
            return


def _pair(P, **kw):
    srv = P.QuicConnection(client=False, **kw)
    cli = P.QuicConnection(client=True, **kw)
    cli.connect()
    _pump(cli, srv)
    return cli, srv


def test_quic_handshake_loopback():
    def body(P):
        srv = P.QuicConnection(client=False)
        cli = P.QuicConnection(
            client=True, remote_fingerprint=srv.tls.local_fingerprint)
        cli.connect()
        _pump(cli, srv)
        assert cli.connected and srv.connected
        evs = cli.events(), srv.events()
        assert ("connected",) in evs[0]
        assert ("connected",) in evs[1]
        return evs
    _both(body)


def test_quic_stream_and_datagram_transfer():
    def body(P):
        cli, srv = _pair(P)
        sid = cli.open_stream()
        cli.send_stream(sid, b"part one ")
        cli.send_stream(sid, b"part two", fin=True)
        cli.send_datagram(b"dgram payload")
        _pump(cli, srv)
        evs = srv.events()
        stream_data = b"".join(e[2] for e in evs if e[0] == "stream")
        fins = [e[3] for e in evs if e[0] == "stream"]
        assert stream_data == b"part one part two"
        assert fins[-1] is True
        assert ("datagram", b"dgram payload") in evs
        ssid = srv.open_stream()
        srv.send_stream(ssid, b"server speaks", fin=True)
        _pump(cli, srv)
        back = cli.events()
        assert any(e[0] == "stream" and e[2] == b"server speaks"
                   for e in back)
        return sid, ssid, evs, back
    _both(body)


def test_quic_fingerprint_mismatch_rejected():
    def body(P):
        srv = P.QuicConnection(client=False)
        cli = P.QuicConnection(client=True, remote_fingerprint="00" * 32)
        cli.connect()
        with pytest.raises(P.QuicError) as e:
            _pump(cli, srv)
        assert not cli.connected
        return str(e.value)
    _both(body)


def test_quic_corrupt_packet_rejected():
    def body(P):
        srv = P.QuicConnection(client=False)
        cli = P.QuicConnection(client=True)
        cli.connect()
        pkt = bytearray(cli.poll_transmit())
        pkt[60] ^= 0xFF
        with pytest.raises(P.QuicError) as e:
            srv.handle_datagram(bytes(pkt))
        assert not srv.connected
        return str(e.value)
    _both(body)


def test_quic_alpn_and_transport_params_surface():
    def body(P):
        cli, srv = _pair(P, alpn="roq")
        assert cli.connected
        assert cli.tls.peer_cert is not None
        return cli.connected, srv.connected, type(cli.tls.peer_cert).__name__
    _both(body)


def test_quic_retransmit_on_timeout():
    def body(P):
        cli, srv = _pair(P)
        assert cli.connected
        sid = cli.open_stream()
        cli.send_stream(sid, b"will be lost")
        lost = cli.poll_transmit()
        assert lost is not None
        first = srv.events()
        assert not any(e[0] == "stream" for e in first)
        cli.on_timeout()
        _pump(cli, srv)
        evs = srv.events()
        assert any(e[0] == "stream" and e[2] == b"will be lost"
                   for e in evs)
        cli.on_timeout()
        out = cli.poll_transmit()
        assert out is None
        return first, evs
    _both(body)


def test_quic_duplicate_and_reordered_stream_segments():
    def body(P):
        cli, srv = _pair(P)
        sid = cli.open_stream()
        cli.send_stream(sid, b"AAAA")
        p1 = cli.poll_transmit()
        cli.send_stream(sid, b"BBBB", fin=True)
        p2 = cli.poll_transmit()
        srv.handle_datagram(p2)
        early = srv.events()
        assert not any(e[0] == "stream" for e in early)
        srv.handle_datagram(p1)
        evs = [e for e in srv.events() if e[0] == "stream"]
        assert b"".join(e[2] for e in evs) == b"AAAABBBB"
        assert evs[-1][3] is True
        srv.handle_datagram(p1)
        dup = srv.events()
        assert not any(e[0] == "stream" and e[2] for e in dup)
        return early, evs, dup
    _both(body)


def test_quic_sustained_load_soak():
    def body(P):
        cli, srv = _pair(P)
        sid = cli.open_stream()
        total = 0
        received = bytearray()
        for i in range(2000):
            payload = bytes([i & 0xFF]) * 50
            cli.send_stream(sid, payload)
            total += len(payload)
            if i % 20 == 19:
                _pump(cli, srv)
                for e in srv.events():
                    if e[0] == "stream":
                        received += e[2]
        _pump(cli, srv)
        for e in srv.events():
            if e[0] == "stream":
                received += e[2]
        assert len(received) == total
        app = cli._spaces[max(cli._spaces)]
        assert len(app.unacked) < 64
        return bytes(received)
    _both(body)


def _lossy_pump(cli, srv, *, loss, rng, t, dt=0.005):
    for src, dst in ((cli, srv), (srv, cli)):
        while (d := src.poll_transmit()) is not None:
            if rng.random() < loss:
                continue
            dst.handle_datagram(d, now=t)
    t += dt
    cli.on_timeout(t)
    srv.on_timeout(t)
    return t


def test_quic_lossy_link_stream_converges():
    """The handshake's flights differ in length by a byte or two from run
    to run (DER signatures), so the loss draws fall on other datagrams in
    each run: the bytes delivered are compared, not the rounds taken."""
    def body(P):
        rng = random.Random(42)
        srv = P.QuicConnection(client=False)
        cli = P.QuicConnection(client=True)
        cli.connect()
        t = 0.0
        for _ in range(1000):
            t = _lossy_pump(cli, srv, loss=0.05, rng=rng, t=t)
            if cli.connected and srv.connected:
                break
        assert cli.connected and srv.connected
        sid = cli.open_stream()
        total, chunk, sent, rounds, stalled = 200_000, 1000, 0, 0, 0
        got = bytearray()
        while len(got) < total and rounds < 4000:
            while sent < total and len(cli._spaces[2].pending) < 64:
                n = min(chunk, total - sent)
                cli.send_stream(sid, bytes([sent // chunk % 256]) * n,
                                fin=(sent + n == total))
                sent += n
            before = len(got)
            t = _lossy_pump(cli, srv, loss=0.05, rng=rng, t=t)
            for e in srv.events():
                if e[0] == "stream" and e[1] == sid:
                    got.extend(e[2])
            stalled = stalled + 1 if len(got) == before else 0
            assert stalled < 600, f"stalled at {len(got)}/{total}"
            rounds += 1
        assert len(got) == total, (len(got), total, rounds)
        for i in range(0, total, chunk):
            assert got[i] == (i // chunk) % 256
        assert cli.rtt.smoothed is not None
        assert cli.cc.cwnd >= P.recovery.MIN_WINDOW
        assert rounds < 2000, rounds
        return bytes(got)
    _both(body)


def test_quic_rtt_estimator_and_pto_backoff():
    def body(P):
        r = P.recovery.RttEstimator()
        r.update(0.100)
        assert abs(r.smoothed - 0.100) < 1e-9
        assert abs(r.rttvar - 0.050) < 1e-9
        r.update(0.120)
        assert 0.100 < r.smoothed < 0.120
        assert r.min_rtt == 0.100
        pto0 = r.pto()
        assert pto0 > r.smoothed
        srv = P.QuicConnection(client=False)
        cli = P.QuicConnection(client=True)
        cli.connect()
        t = 0.0
        rng = random.Random(1)
        for _ in range(30):
            t = _lossy_pump(cli, srv, loss=0.0, rng=rng, t=t)
            if cli.connected:
                break
        sid = cli.open_stream()
        cli.send_stream(sid, b"x" * 100)
        cli.poll_transmit()
        d1 = cli.poll_timeout()
        assert d1 is not None
        cli.on_timeout(d1 + 0.001)
        while cli.poll_transmit() is not None:
            pass
        d2 = cli.poll_timeout()
        assert d2 is not None and d2 > d1
        return (r.smoothed, r.rttvar, r.min_rtt, pto0, cli._pto_count,
                cli.rtt.smoothed, cli.rtt.rttvar)
    _both(body)


def test_quic_newreno_congestion_events():
    def body(P):
        rec = P.recovery
        cc = rec.NewReno()
        assert cc.cwnd == rec.INITIAL_WINDOW
        cc.on_sent(1200)
        cc.on_acked(1200, time_sent=1.0)
        assert cc.cwnd == rec.INITIAL_WINDOW + 1200
        w = cc.cwnd
        cc.on_lost(1200, time_sent=2.0, now=3.0)
        assert cc.cwnd == max(w / 2, rec.MIN_WINDOW)
        w2 = cc.cwnd
        cc.on_lost(1200, time_sent=2.5, now=3.1)
        assert cc.cwnd == w2
        cc.on_lost(1200, time_sent=4.0, now=4.2)
        assert cc.cwnd == max(w2 / 2, rec.MIN_WINDOW)
        return (rec.INITIAL_WINDOW, rec.MIN_WINDOW, w, w2, cc.cwnd,
                cc.bytes_in_flight)
    _both(body)


def test_quic_ack_frames_report_holes():
    def body(P):
        cli, srv = _pair(P)
        sid = cli.open_stream()
        cli.send_stream(sid, b"a" * 50)
        d1 = cli.poll_transmit()
        cli.send_stream(sid, b"b" * 50)
        cli.poll_transmit()                 # lost
        cli.send_stream(sid, b"c" * 50)
        d3 = cli.poll_transmit()
        srv.handle_datagram(d1, now=1.0)
        srv.handle_datagram(d3, now=1.1)
        ranges = srv._spaces[2].recv.descending()
        assert len(ranges) >= 2
        return ranges, [e for e in srv.events() if e[0] == "stream"]
    _both(body)


def test_quic_hostile_ack_range_does_not_allocate():
    def body(P):
        cli, srv = _pair(P)
        assert cli.connected
        sid = cli.open_stream()
        cli.send_stream(sid, b"x" * 100)
        cli.poll_transmit()
        huge = 2 ** 61
        ev = P.packet.encode_varint
        frame = bytes([0x02]) + ev(huge) + ev(0) + ev(0) + ev(huge)
        t0 = time.time()
        cli._handle_frames(P.tls13.APPLICATION, frame)
        assert time.time() - t0 < 0.5
        sid2 = cli.open_stream()
        cli.send_stream(sid2, b"still alive")
        _pump(cli, srv)
        evs = srv.events()
        assert any(e[0] == "stream" and e[2] == b"still alive"
                   for e in evs)
        return sorted(cli._spaces[P.tls13.APPLICATION].unacked), evs
    _both(body)


def test_quic_time_threshold_spares_packets_after_largest_acked():
    def body(P):
        cli, srv = _pair(P)
        sp = cli._spaces[P.tls13.APPLICATION]
        sid = cli.open_stream()
        cli.send_stream(sid, b"old")
        cli.poll_transmit()
        first = sorted(sp.unacked)[-1]
        cli.send_stream(sid, b"newer")
        cli.poll_transmit()
        newer = [p for p in sorted(sp.unacked) if p > first]
        assert newer
        cli._on_ack(P.tls13.APPLICATION, [(first, first)], first,
                    time.monotonic() + 60.0)
        assert all(p in sp.unacked for p in newer)
        return first, newer, sorted(sp.unacked)
    _both(body)


def test_quic_rangeset_bounded_on_permanent_holes():
    def body(P):
        RangeSet = P.recovery.RangeSet
        rs = RangeSet()
        for pn in range(0, 10_000, 2):
            rs.add(pn)
        assert len(rs._ranges) <= RangeSet.MAX_RANGES
        assert rs.largest == 9998
        assert 9998 in rs and 9996 in rs
        return [tuple(r) for r in rs._ranges], rs.descending()
    _both(body)


def test_stream_buffer_above_cwnd_never_leaves():
    """gstpu's behaviour, kept: `send_stream` queues one STREAM frame and
    `_flush` never splits one, so a frame larger than the congestion
    window is requeued to wait for an ack that nothing in flight will
    bring. A 5,000 B buffer arrives in one datagram; a 70,000 B one sends
    no datagram in either package within 100 pump rounds."""
    def body(P):
        cli, srv = _pair(P)
        sid = cli.open_stream()
        cli.send_stream(sid, b"s" * 5000)
        small = []
        while (d := cli.poll_transmit()) is not None:
            small.append(len(d))
            srv.handle_datagram(d)
        _pump(cli, srv)
        got = b"".join(e[2] for e in srv.events() if e[0] == "stream")
        assert got == b"s" * 5000 and len(small) == 1
        cwnd = cli.cc.cwnd
        assert 70_000 > cwnd
        cli.send_stream(sid, b"L" * 70_000)
        left = 0
        for _ in range(100):
            while (d := cli.poll_transmit()) is not None:
                left += 1
                srv.handle_datagram(d)
            while (d := srv.poll_transmit()) is not None:
                cli.handle_datagram(d)
        assert left == 0
        assert not [e for e in srv.events() if e[0] == "stream"]
        pending = cli._spaces[P.tls13.APPLICATION].pending
        assert len(pending) == 1 and len(pending[0]) > 70_000
        return small, cwnd, cli.cc.cwnd, left, len(pending[0])
    obs = _both(body)
    assert obs[0] == [5034]


# ---------------------------------------------------------------------------
# elements (tests/test_quic.py:161-316, 377-566, 782-855)
# ---------------------------------------------------------------------------

def _connect(sink, src):
    _wait(lambda: sink._ep.conn.connected, sink._ep.pump, _src_tasks(src))


def _run_quic_pipeline(P, use_datagram):
    src = P.make("quinnquicsrc")
    src.port = 0
    src.set_state(P.State.READY)
    assert src.bound_port > 0
    sink = P.make("quinnquicsink")
    sink.address = "127.0.0.1"
    sink.port = src.bound_port
    sink.use_datagram = use_datagram
    sink.certificate_fingerprint = src.local_fingerprint
    h = P.Harness(sink)
    h.set_caps("application/x-test")
    out = P.parse_launch("appsink name=out").get_by_name("out")
    src.pads["src"].link(out.pads["sink"])
    src.set_state(P.State.PLAYING)
    out.set_state(P.State.PLAYING)
    _connect(sink, src)
    sent = [bytes([i]) * (40 + i) for i in range(5)]
    for data in sent:
        h.push(P.Buffer(data))
    _wait(lambda: len(out.samples) >= len(sent), _src_tasks(src))
    got = [b.to_bytes() for b in out.samples]
    assert got == sent
    metas = [(m.stream_id, m.is_datagram) for b in out.samples
             for m in b.metas]
    h.teardown()
    src.set_state(P.State.NULL)
    return got, metas, sink.sent


@pytest.mark.parametrize("use_datagram", [False, True],
                         ids=["stream_mode", "datagram_mode"])
def test_quinnquic_elements(use_datagram):
    _both(lambda P: _run_quic_pipeline(P, use_datagram))


def test_quinnquicmux_demux_roundtrip():
    def body(P):
        mux = P.make("quinnquicmux")
        demux = P.make("quinnquicdemux")
        mux.pads["src"].link(demux.pads["sink"])
        s0 = mux.request_pad("stream_0")
        s1 = mux.request_pad("stream_1")
        dg = mux.request_pad("datagram")
        outputs = {}

        def on_pad_added(element, pad):
            sink = P.make("appsink")
            outputs[pad.name] = sink
            sink.set_state(P.State.PLAYING)
            pad.link(sink.pads["sink"])

        demux.connect("pad-added", on_pad_added)
        for el in (mux, demux):
            el.set_state(P.State.PLAYING)
        for pad, tag in ((s0, b"a"), (s1, b"b"), (dg, b"d")):
            pad.push_event(P.ev.StreamStartEvent("t"))
            pad.push_event(P.ev.CapsEvent(P.Caps.new("application/x-test")))
            pad.push_event(P.ev.SegmentEvent(P.ev.Segment()))
            for i in range(3):
                pad.chain_function(pad, P.Buffer(tag + bytes([i])))
        got = {k: [b.to_bytes() for b in s.samples]
               for k, s in outputs.items()}
        assert got["stream_0"] == [b"a\x00", b"a\x01", b"a\x02"]
        assert got["stream_1"] == [b"b\x00", b"b\x01", b"b\x02"]
        assert got["datagram"] == [b"d\x00", b"d\x01", b"d\x02"]
        return got, {k: repr(s.caps) for k, s in outputs.items()}
    _both(body)


def _run_wt_pipeline(P, use_datagram):
    sink = P.make("quinnwtserversink")
    sink.port = 0
    sink.use_datagram = use_datagram
    h = P.Harness(sink)
    h.set_caps("application/x-test")
    assert sink.bound_port > 0
    src = P.make("quinnwtsrc")
    src.address = "127.0.0.1"
    src.port = sink.bound_port
    src.certificate_fingerprint = sink.local_fingerprint
    out = P.parse_launch("appsink name=out").get_by_name("out")
    src.set_state(P.State.READY)
    src.pads["src"].link(out.pads["sink"])
    src.set_state(P.State.PLAYING)
    out.set_state(P.State.PLAYING)
    _wait(lambda: sink._ep.wt.session_ready, sink._ep.pump,
          _src_tasks(src))
    sent = [bytes([i]) * (30 + i) for i in range(4)]
    for data in sent:
        h.push(P.Buffer(data))
    _wait(lambda: len(out.samples) >= len(sent), _src_tasks(src),
          sink._ep.pump)
    got = [b.to_bytes() for b in out.samples]
    assert got == sent
    h.teardown()
    src.set_state(P.State.NULL)
    return got, sink.sent


@pytest.mark.parametrize("use_datagram", [False, True],
                         ids=["stream_mode", "datagram_mode"])
def test_webtransport_elements(use_datagram):
    _both(lambda P: _run_wt_pipeline(P, use_datagram))


def test_webtransport_qpack_roundtrip():
    def body(P):
        fields = [(":method", "CONNECT"), (":protocol", "webtransport"),
                  (":authority", "a" * 300), (":path", "/x")]
        enc = P.wt.qpack_encode(fields)
        assert P.wt.qpack_decode(enc) == fields
        return enc
    _both(body)


def test_quinn_mux_over_wire_to_demux():
    def body(P):
        src = P.make("quinnquicsrc")
        src.port = 0
        src.set_state(P.State.READY)
        sink = P.make("quinnquicsink")
        sink.address, sink.port = "127.0.0.1", src.bound_port
        sink.certificate_fingerprint = src.local_fingerprint
        mux = P.make("quinnquicmux")
        mux.pads["src"].link(sink.pads["sink"])
        s0 = mux.request_pad("stream_0")
        s1 = mux.request_pad("stream_1")
        dg = mux.request_pad("datagram")
        for el in (mux, sink):
            el.set_state(P.State.PLAYING)
        demux = P.make("quinnquicdemux")
        src.pads["src"].link(demux.pads["sink"])
        outputs = {}

        def on_pad_added(element, pad):
            s = P.make("appsink")
            s.set_state(P.State.PLAYING)
            pad.link(s.pads["sink"])
            outputs[pad.name] = s

        demux.connect("pad-added", on_pad_added)
        src.set_state(P.State.PLAYING)
        demux.set_state(P.State.PLAYING)
        _connect(sink, src)
        for pad, payloads in ((s0, [b"a0", b"a1"]), (s1, [b"b0"]),
                              (dg, [b"d0"])):
            pad.send_event(P.ev.StreamStartEvent("t"))
            pad.send_event(P.ev.CapsEvent(P.Caps.new("application/x-test")))
            pad.send_event(P.ev.SegmentEvent(P.ev.Segment()))
            for d in payloads:
                pad.chain_function(pad, P.Buffer(d))
        _wait(lambda: sum(len(s.samples) for s in outputs.values()) >= 4,
              sink._ep.pump, _src_tasks(src))
        got = {name: [b.to_bytes() for b in s.samples]
               for name, s in outputs.items()}
        stream_pads = sorted(n for n in got if n.startswith("stream_"))
        assert len(stream_pads) == 2
        assert sorted(map(tuple, (got[n] for n in stream_pads))) \
            == [(b"a0", b"a1"), (b"b0",)]
        assert got.get("datagram") == [b"d0"]
        src.set_state(P.State.NULL)
        sink.set_state(P.State.NULL)
        return got
    _both(body)


def test_roq_rides_real_quic_datagrams():
    def body(P):
        src = P.make("quinnquicsrc")
        src.port = 0
        src.set_state(P.State.READY)
        sink = P.make("quinnquicsink")
        sink.address, sink.port = "127.0.0.1", src.bound_port
        sink.use_datagram = True
        sink.certificate_fingerprint = src.local_fingerprint
        h = P.Harness(sink)
        h.set_caps("application/x-roq")
        out = P.parse_launch("appsink name=out").get_by_name("out")
        src.pads["src"].link(out.pads["sink"])
        src.set_state(P.State.PLAYING)
        out.set_state(P.State.PLAYING)
        _connect(sink, src)
        rtp = b"\x80\x60\x00\x01" + b"\x00" * 8 + b"payload"
        wire = [P.roq.mux_datagram(flow, rtp) for flow in (0, 7, 300)]
        for d in wire:
            h.push(P.Buffer(d))
        _wait(lambda: len(out.samples) >= 3, _src_tasks(src))
        got = [P.roq.demux_datagram(b.to_bytes()) for b in out.samples]
        assert sorted(f for f, _ in got) == [0, 7, 300]
        assert all(p == rtp for _, p in got)
        h.teardown()
        src.set_state(P.State.NULL)
        return wire, got
    _both(body)


def test_quinnquic_reverse_roles():
    def body(P):
        sink = P.make("quinnquicsink")
        sink.role = "server"
        sink.address, sink.port = "127.0.0.1", 0
        h = P.Harness(sink)
        h.set_caps("application/x-test")
        port = sink._ep.sock.getsockname()[1]
        src = P.make("quinnquicsrc")
        src.role = "client"
        src.address, src.port = "127.0.0.1", port
        out = P.parse_launch("appsink name=out").get_by_name("out")
        src.set_state(P.State.READY)
        src.pads["src"].link(out.pads["sink"])
        src.set_state(P.State.PLAYING)
        out.set_state(P.State.PLAYING)
        _connect(sink, src)
        h.push(P.Buffer(b"server-to-client"))
        _wait(lambda: out.samples, sink._ep.pump, _src_tasks(src))
        got = [b.to_bytes() for b in out.samples]
        assert got == [b"server-to-client"]
        h.teardown()
        src.set_state(P.State.NULL)
        return got
    _both(body)


def _pinned_connect(P, src, sink):
    h = P.Harness(sink)
    h.set_caps("application/x-test")
    out = P.parse_launch("appsink name=out").get_by_name("out")
    src.pads["src"].link(out.pads["sink"])
    src.set_state(P.State.PLAYING)
    out.set_state(P.State.PLAYING)
    _connect(sink, src)
    connected = sink._ep.conn.connected
    h.teardown()
    src.set_state(P.State.NULL)
    return connected


def test_quinnquic_certificate_file_identity(tmp_path):
    """One PEM identity, written once, served by each package's src: the
    fingerprints both present are the file's, and equal."""
    from cryptography.hazmat.primitives import serialization
    key, cert = QPkg("gstpu").dtls.generate_certificate("quinn-file-test")
    cp, kp = tmp_path / "c.pem", tmp_path / "k.pem"
    cp.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    kp.write_bytes(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))

    def body(P):
        pin = P.dtls.fingerprint(cert).split(" ", 1)[1] \
            .replace(":", "").lower()
        src = P.make("quinnquicsrc", certificate_file=str(cp),
                     private_key_file=str(kp))
        src.port = 0
        src.set_state(P.State.READY)
        fp = src.local_fingerprint
        assert fp.replace(":", "").lower().endswith(pin[-16:])
        sink = P.make("quinnquicsink")
        sink.address = "127.0.0.1"
        sink.port = src.bound_port
        sink.certificate_fingerprint = fp
        assert _pinned_connect(P, src, sink)
        return pin, fp
    _both(body)


def test_quinnquic_secure_connection_false_skips_pin():
    def body(P):
        src = P.make("quinnquicsrc")
        src.port = 0
        src.set_state(P.State.READY)
        sink = P.make("quinnquicsink", secure_connection=False)
        sink.address = "127.0.0.1"
        sink.port = src.bound_port
        sink.certificate_fingerprint = "00" * 32
        return _pinned_connect(P, src, sink)
    assert _both(body) is True


# ---------------------------------------------------------------------------
# the wire across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sender,receiver", [NAMES, NAMES[::-1]],
                         ids=["gstpu_to_port", "port_to_gstpu"])
@pytest.mark.parametrize("use_datagram", [False, True],
                         ids=["stream", "datagram"])
def test_quic_wire_across_packages(sender, receiver, use_datagram):
    """One package's quinnquicsink into the other's quinnquicsrc: the
    handshake completes and every buffer arrives, in order."""
    S, R = QPkg(sender), QPkg(receiver)
    src = R.make("quinnquicsrc")
    src.port = 0
    src.set_state(R.State.READY)
    sink = S.make("quinnquicsink")
    sink.address, sink.port = "127.0.0.1", src.bound_port
    sink.use_datagram = use_datagram
    sink.certificate_fingerprint = src.local_fingerprint
    h = S.Harness(sink)
    h.set_caps("application/x-test")
    out = R.parse_launch("appsink name=out").get_by_name("out")
    src.pads["src"].link(out.pads["sink"])
    src.set_state(R.State.PLAYING)
    out.set_state(R.State.PLAYING)
    _connect(sink, src)
    sent = [bytes([i]) * (100 + 37 * i) for i in range(12)]
    for data in sent:
        h.push(S.Buffer(data))
    _wait(lambda: len(out.samples) >= len(sent), sink._ep.pump,
          _src_tasks(src))
    assert [b.to_bytes() for b in out.samples] == sent
    h.teardown()
    src.set_state(R.State.NULL)


# ---------------------------------------------------------------------------
# adversarial input (tests/test_parser_robustness.py:19,51)
# ---------------------------------------------------------------------------

def _garbage(seed, n=256):
    rng = random.Random(seed)
    return bytes(rng.randrange(256) for _ in range(rng.randrange(n)))


def test_quic_packet_parser_rejects_garbage():
    def body(P):
        srv = P.QuicConnection(client=False)
        out = []
        for seed in range(200):
            try:
                srv.handle_datagram(_garbage(seed))
                out.append(None)
            except P.QuicError as e:
                out.append(str(e))
        return out, srv.connected
    _both(body)


def test_qpack_rejects_garbage():
    def body(P):
        out = []
        for seed in range(200):
            try:
                out.append(P.wt.qpack_decode(_garbage(seed, 64)))
            except P.wt.WtError as e:
                out.append(("WtError", str(e)))
            except UnicodeDecodeError as e:
                out.append(("UnicodeDecodeError", e.reason))
        return out
    _both(body)


# ---------------------------------------------------------------------------
# the anti-replay window (tests/test_replay.py)
# ---------------------------------------------------------------------------

def test_window_basics():
    def body(P):
        w = P.ReplayWindow(size=64)
        seen = [w.is_replay(0)]
        assert not seen[-1]
        w.accept(0)
        assert w.is_replay(0)
        assert not w.is_replay(5)
        w.accept(5)
        assert w.is_replay(5) and w.is_replay(0)
        assert not w.is_replay(3)
        w.accept(3)
        assert w.is_replay(3)
        w.accept(200)
        assert w.is_replay(100)
        assert not w.is_replay(199)
        return [w.is_replay(i) for i in range(260)]
    _both(body)


def test_window_large_jump():
    def body(P):
        w = P.ReplayWindow(size=64)
        w.accept(10)
        w.accept(10_000_000)
        assert w.is_replay(10) and w.is_replay(9_999_000)
        assert not w.is_replay(9_999_990)
        return [w.is_replay(i) for i in range(9_999_900, 10_000_100)]
    _both(body)


def _rtp(seq, ssrc=0x1234, payload=b"\xAB" * 32):
    return struct.pack(">BBHII", 0x80, 96, seq, 1000 + seq,
                       ssrc) + payload


def _srtp(body):
    """The SRTP twins run each package's own SrtpContext/SrtcpContext
    (gstpu_torch.net.srtp uses the port's ReplayWindow), and what each
    packet met must be equal."""
    obs = []
    for name in NAMES:
        P = QPkg(name)
        srtp = P.mod("net.srtp")
        assert srtp.ReplayWindow is P.ReplayWindow
        obs.append(body(srtp))
    assert obs[1] == obs[0]
    return obs[1]


def _unprotect(rx, pkt):
    try:
        return rx.unprotect(pkt)
    except ValueError as e:
        return str(e)


def test_srtp_replay_rejected():
    def body(srtp):
        key, salt = b"\x01" * 16, b"\x02" * 14
        tx, rx = srtp.SrtpContext(key, salt), srtp.SrtpContext(key, salt)
        pkt = tx.protect(_rtp(100))
        out = [rx.unprotect(pkt)]
        assert out[0][:12] == _rtp(100)[:12]
        out.append(_unprotect(rx, pkt))
        assert "replay" in out[-1]
        out += [rx.unprotect(tx.protect(_rtp(s))) for s in range(101, 140)]
        out.append(_unprotect(rx, pkt))
        assert "replay" in out[-1]
        return out
    _srtp(body)


def test_srtp_out_of_order_ok_but_replay_caught():
    def body(srtp):
        key, salt = b"\x03" * 16, b"\x04" * 14
        tx, rx = srtp.SrtpContext(key, salt), srtp.SrtpContext(key, salt)
        pkts = [tx.protect(_rtp(s)) for s in range(50, 60)]
        out = [rx.unprotect(pkts[5]), rx.unprotect(pkts[2]),
               _unprotect(rx, pkts[2])]
        assert "replay" in out[-1]
        return out
    _srtp(body)


def test_srtp_forged_packet_does_not_poison_window():
    def body(srtp):
        key, salt = b"\x05" * 16, b"\x06" * 14
        tx, rx = srtp.SrtpContext(key, salt), srtp.SrtpContext(key, salt)
        good = tx.protect(_rtp(7))
        forged = good[:-1] + bytes([good[-1] ^ 1])
        out = [_unprotect(rx, forged)]
        assert "auth" in out[0]
        out.append(rx.unprotect(good))
        assert out[-1][:12] == _rtp(7)[:12]
        return out
    _srtp(body)


def test_srtcp_replay_rejected_even_after_many():
    def body(srtp):
        key, salt = b"\x07" * 16, b"\x08" * 14
        tx, rx = srtp.SrtcpContext(key, salt), srtp.SrtcpContext(key, salt)
        rtcp = struct.pack(">BBHI", 0x80, 200, 6, 0x99) + b"\x00" * 20
        first = tx.protect(rtcp)
        out = [rx.unprotect(first)]
        assert out[0] == rtcp
        out += [rx.unprotect(tx.protect(rtcp)) for _ in range(300)]
        out.append(_unprotect(rx, first))
        assert "replay" in out[-1]
        return out
    _srtp(body)


# ---------------------------------------------------------------------------
# DTLS 1.2 (tests/test_dtls.py:32,54,67,82,334,359,381)
# ---------------------------------------------------------------------------

def _dtls_pump(client, server, max_iters=30):
    for _ in range(max_iters):
        moved = False
        while (d := client.poll_transmit()) is not None:
            server.handle_packet(d)
            moved = True
        while (d := server.poll_transmit()) is not None:
            client.handle_packet(d)
            moved = True
        if not moved:
            break


def test_handshake_derives_matching_srtp_keys():
    def body(P):
        d = P.dtls
        ccert = d.generate_certificate("client")
        scert = d.generate_certificate("server")
        client = d.DtlsEndpoint(client=True, certificate=ccert,
                                remote_fingerprint=d.fingerprint(scert[1]))
        server = d.DtlsEndpoint(client=False, certificate=scert,
                                remote_fingerprint=d.fingerprint(ccert[1]))
        client.handshake()
        _dtls_pump(client, server)
        assert client.connected and server.connected
        assert client.srtp_profile == server.srtp_profile == 0x0001
        ck, sk = client.srtp_keys, server.srtp_keys
        assert ck == sk
        assert ck.send_key_salt(True) == sk.recv_key_salt(False)
        assert sk.send_key_salt(False) == ck.recv_key_salt(True)
        assert len(ck.client_key) == 16 and len(ck.client_salt) == 14
        assert client.peer_cert is not None
        assert server.peer_cert is not None
        # the peers' certificates are the ones each side was given
        assert d.fingerprint(client.peer_cert) == d.fingerprint(scert[1])
        return client.srtp_profile, len(ck.server_key), len(ck.server_salt)
    _both(body)


def test_fingerprint_pinning_rejects_wrong_cert():
    def body(P):
        d = P.dtls
        ccert = d.generate_certificate("client")
        scert = d.generate_certificate("server")
        other = d.generate_certificate("mallory")
        client = d.DtlsEndpoint(client=True, certificate=ccert,
                                remote_fingerprint=d.fingerprint(other[1]))
        server = d.DtlsEndpoint(client=False, certificate=scert)
        client.handshake()
        with pytest.raises(d.DtlsError, match="fingerprint") as e:
            _dtls_pump(client, server)
        assert not client.connected
        return str(e.value).split(":")[0]
    _both(body)


def test_cookie_exchange_happens():
    def body(P):
        client = P.dtls.DtlsEndpoint(client=True)
        server = P.dtls.DtlsEndpoint(client=False)
        client.handshake()
        server.handle_packet(client.poll_transmit())
        hvr = server.poll_transmit()
        assert hvr[0] == 22 and hvr[13] == 3
        assert not server.connected
        client.handle_packet(hvr)
        _dtls_pump(client, server)
        assert client.connected and server.connected
        return hvr[:14], len(hvr)
    _both(body)


def _tamper_finished(P, rounds):
    """gstpu's loop: the client's and server's flights exchanged for
    `rounds` steps, the client's first datagram whose first record is of
    epoch 1 (the encrypted Finished) sent with its last byte flipped.
    Raises what the server raised, or AssertionError when no such
    datagram came within `rounds` steps."""
    client = P.dtls.DtlsEndpoint(client=True)
    server = P.dtls.DtlsEndpoint(client=False)
    client.handshake()
    for _ in range(rounds):
        d = client.poll_transmit()
        if d is None:
            d2 = server.poll_transmit()
            if d2 is None:
                break
            client.handle_packet(d2)
            continue
        if d[0] == 22 and d[3:5] == b"\x00\x01":
            bad = bytearray(d)
            bad[-1] ^= 0xFF
            server.handle_packet(bytes(bad))
        else:
            server.handle_packet(d)
    raise AssertionError("corruption was not detected")


def test_tampered_finished_fails():
    """gstpu's test as it stands: its ten steps end before the client
    sends its Finished (the thirteenth datagram), so the exception it
    expects is its own AssertionError in both packages (ROADMAP.md,
    Queue C); test_tampered_finished_is_detected reaches the Finished."""
    def body(P):
        client_server = []
        with pytest.raises(Exception) as e:
            _tamper_finished(P, 10)
        client_server.append((type(e.value).__name__, str(e.value)))
        return client_server
    _both(body)


def test_tampered_finished_is_detected():
    """The same tampering with steps enough to reach the Finished: the
    server rejects the record in both packages and does not connect."""
    def body(P):
        with pytest.raises(P.dtls.DtlsError, match="InvalidTag") as e:
            _tamper_finished(P, 40)
        return str(e.value)
    _both(body)


def test_forged_finished_without_key_exchange_rejected():
    def body(P):
        import hashlib
        server = P.dtls.DtlsEndpoint(client=False)
        verify = P.dtls._prf(b"", b"client finished",
                             hashlib.sha256(b"").digest(), 12)
        msg = (bytes([20]) + len(verify).to_bytes(3, "big")
               + struct.pack(">H", 0) + (0).to_bytes(3, "big")
               + len(verify).to_bytes(3, "big") + verify)
        rec = (struct.pack(">BHH", 22, 0xFEFD, 0) + (0).to_bytes(6, "big")
               + struct.pack(">H", len(msg)) + msg)
        with pytest.raises(P.dtls.DtlsError) as e:
            server.handle_packet(rec)
        assert not server.connected
        assert server.srtp_keys is None
        return verify, str(e.value)
    _both(body)


def test_client_skipping_certificate_rejected():
    def body(P):
        client = P.dtls.DtlsEndpoint(client=True)
        server = P.dtls.DtlsEndpoint(client=False)
        orig = client._dispatch_client

        def no_cert(ht, body, raw):
            if ht == 13:
                client._transcript += raw
                return
            return orig(ht, body, raw)
        client._dispatch_client = no_cert
        client.handshake()
        with pytest.raises(P.dtls.DtlsError, match="certificate") as e:
            _dtls_pump(client, server)
        assert not server.connected
        return str(e.value)
    _both(body)


def test_garbage_datagrams_raise_dtlserror_only():
    def body(P):
        server = P.dtls.DtlsEndpoint(client=False)
        bad = [
            b"\x16\xfe\xfd" + bytes(20),
            struct.pack(">BHH", 22, 0xFEFD, 0) + bytes(6)
            + struct.pack(">H", 60)
            + bytes([1]) + (48).to_bytes(3, "big") + bytes(8)
            + struct.pack(">H", 0xFEFD) + bytes(32) + b"\x00"
            + bytes([8]) + b"badcooki" + b"\x00\x02\xc0\x2b\x01\x00",
            struct.pack(">BHH", 21, 0xFEFD, 0) + bytes(6)
            + struct.pack(">H", 2) + b"\x02\x28",
        ]
        out = []
        for dgram in bad:
            try:
                server.handle_packet(dgram)
                out.append(None)
            except P.dtls.DtlsError as e:
                out.append(str(e))
        assert not server.connected
        return out
    _both(body)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 18c at 64x48 and 0.25 s of audio, both packages
# ---------------------------------------------------------------------------

@pytest.fixture
def cube(tmp_path):
    path = tmp_path / "g.cube"
    chip_smoke.write_cube(path, np.random.default_rng(18), n=9)
    return path


def _direct(mod, n, cube):
    src, grade = chip_smoke.grade_strings(W, H, n, cube)
    return [b.to_bytes() for b in chip_smoke.run_string(
        mod, "cpu", f"{src} ! {grade} ! appsink name=out", ("out",))[2]["out"]]


def test_phase18_roq(cube):
    """18c's datagram leg at 64x48: in both packages the frames that
    crossed QUIC as RoQ datagrams are the direct string's, no RTP packet
    is lost or reordered and QUIC declared none lost; the port's
    payloader reads each frame once and no other new element reads one."""
    from test_torch_net import _as_port
    n = chip_smoke.QUIC_FRAMES
    seen = {}
    for name in NAMES:
        mod = _as_port(name)
        want = _direct(mod, n, cube)
        with chip_smoke.ArrayCalls() as calls:
            res = chip_smoke.roq_grade(mod, "cpu", W, H, n, cube)
        assert res["frames"] == want
        assert res["lost"] == 0 and res["in_order"]
        assert res["quic"]["lost"] == 0 and res["quic"]["ptos"] == 0
        seen[name] = res["frames"], res["seqnums"], calls
    assert seen["gstpu"][:2] == seen["gstpu_torch"][:2]
    calls = seen["gstpu_torch"][2]
    assert chip_smoke.new_reads(calls, ("pay", "roq", "quic", "src", "roqd",
                                        "depay", "out")) == {"pay": n}


def test_phase18_streams(cube):
    """18c's stream leg at 64x48 and 0.25 s: each of the two QUIC streams
    carries, in order, the packets its payloader sent, and both packages
    send the same packets."""
    from test_torch_net import _as_port
    seen = {}
    for name in NAMES:
        res = chip_smoke.quic_streams(_as_port(name), "cpu", W, H,
                                      chip_smoke.QUIC_STREAM_FRAMES, cube,
                                      0.25)
        got = sorted(map(tuple, res["streams"].values()))
        assert got == sorted([tuple(res["phone"]), tuple(res["video"])])
        assert len(res["phone"]) == 13
        seen[name] = res["phone"], res["video"]
    assert seen["gstpu"] == seen["gstpu_torch"]


def test_phase18_webtransport():
    """18c's WebTransport leg at 0.25 s: both packages decode the same
    2,000 samples, and those are what alawdec makes of what alawenc
    wrote."""
    from test_torch_net import _as_port
    seen = {name: chip_smoke.wt_phone(_as_port(name), "cpu", 0.25)
            for name in NAMES}
    port = seen["gstpu_torch"]
    assert len(port["samples"]) == 2 * 2000
    assert port["samples"] == seen["gstpu"]["samples"]
    assert port["phone"] == seen["gstpu"]["phone"]
    pk = importlib.import_module("gstpu_torch.net.rtp.packet")
    alaw = b"".join(pk.RtpPacket.parse(x).payload for x in port["phone"])
    assert port["samples"] == gstpu_torch.native.alaw_decode(np.frombuffer(
        alaw, np.uint8)).astype("<i2").tobytes()
