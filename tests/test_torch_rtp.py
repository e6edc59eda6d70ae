"""The port's RTP stack, RTP payloaders, ONVIF metadata elements, FEC and
GCC against gstpu's, on the CPU.

Twins of tests/test_rtp.py, test_mparobust.py, test_raptorq.py, the RTP
cases of test_review_regressions.py, the VP8/VP9 payloader cases of
test_rtp_video_aging.py, the PCMA loopback of test_native_g711.py, the
GCC half of test_sodium_gcc.py, the ONVIF cases of test_cccombiner.py and
the SMPTE 291 case of test_st2038.py. Each twin is the gstpu test's body
run once with gstpu's names and once with the port's: it keeps the test's
own assertions and returns what it saw (packets, bytes, pts, flags,
metas, caps, messages, state), and the two packages' observations must be
equal. This is host code in both packages, so nothing here has a
tolerance. The payloaders draw their SSRC and offsets from
`random.SystemRandom`; each body's run draws them from one generator
seeded alike for both packages.
"""

import random
import struct

import numpy as np
import pytest

import gstpu
import gstpu_torch
from test_torch_captions import NAMES, Pkg, _bufs, _capture, _feeder, \
    _plain, _start
from torch_session import torch_test_limit  # noqa: F401

SECOND = 10 ** 9
SEED = 20261017


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU."""
    gstpu.init()
    gstpu_torch.init(device="cpu")


class _SeededRandom:
    """Stands in for the `random` module of a package's basepay: every
    `SystemRandom()` is one generator, seeded with SEED."""

    def __init__(self):
        self._rng = random.Random(SEED)

    def SystemRandom(self):
        return self._rng


class RPkg(Pkg):
    """Pkg with the RTP names."""

    def __init__(self, name: str):
        super().__init__(name)
        pk = self.mod("net.rtp.packet")
        self.RtpPacket = pk.RtpPacket
        self.pk = pk
        self.jb = self.mod("net.rtp.jitterbuffer")
        self.session = self.mod("net.rtp.session")


def _both(body):
    """`body` run with gstpu's names and with the port's, each with the
    payloaders' random draws seeded alike: the observations must be
    equal. Returns the port's."""
    obs = []
    for name in NAMES:
        basepay = __import__(f"{name}.net.rtp.basepay",
                             fromlist=["random"])
        saved = basepay.random
        basepay.random = _SeededRandom()
        try:
            obs.append(body(RPkg(name)))
        finally:
            basepay.random = saved
    assert obs[1] == obs[0]
    return obs[1]


def _launch_run(P, launch, sink="sink"):
    p = P.parse_launch(launch)
    out = p.get_by_name(sink)
    p.set_state(P.State.PLAYING)
    p.run()
    bufs = out.pull_all()
    res = repr(out.caps), _bufs(bufs)
    return p, out, bufs, res


# ---------------------------------------------------------------------------
# packet codecs (tests/test_rtp.py)
# ---------------------------------------------------------------------------

def test_rtp_roundtrip_basic():
    def body(P):
        p = P.RtpPacket(payload_type=96, seqnum=1234, timestamp=567890,
                        ssrc=0xDEADBEEF, payload=b"hello", marker=True)
        q = P.RtpPacket.parse(p.to_bytes())
        assert q == p
        return p.to_bytes(), _plain(q)
    _both(body)


def test_rtp_roundtrip_fancy():
    def body(P):
        p = P.RtpPacket(payload_type=127, seqnum=65535, timestamp=2**32 - 1,
                        ssrc=1, payload=b"x" * 100, csrcs=(7, 8, 9),
                        extension=(0xBEDE, b"\x10\x22\x00\x00"))
        q = P.RtpPacket.parse(p.to_bytes())
        assert q.csrcs == (7, 8, 9)
        assert q.extension == (0xBEDE, b"\x10\x22\x00\x00")
        assert q.payload == p.payload
        return p.to_bytes(), _plain(q)
    _both(body)


def test_rtp_parse_errors():
    def body(P):
        errs = []
        for data in (b"\x00" * 12, b"\x80\x60"):
            with pytest.raises(ValueError) as e:
                P.RtpPacket.parse(data)
            errs.append((type(e.value).__name__, str(e.value)))
        return errs
    _both(body)


def test_rtcp_compound_roundtrip():
    def body(P):
        pk = P.pk
        sr = pk.SenderReport(ssrc=42, ntp_timestamp=pk.ntp_from_ns(
            1_700_000_000 * SECOND), rtp_timestamp=8000, packet_count=10,
            octet_count=999)
        sdes = pk.Sdes([(42, [(pk.Sdes.CNAME, b"a@b")])])
        bye = pk.Bye([42], b"done")
        data = sr.to_bytes() + sdes.to_bytes() + bye.to_bytes()
        pkts = pk.parse_rtcp(data)
        assert isinstance(pkts[0], pk.SenderReport)
        assert pkts[0].packet_count == 10
        assert isinstance(pkts[1], pk.Sdes)
        assert pkts[1].chunks[0][1][0] == (pk.Sdes.CNAME, b"a@b")
        assert isinstance(pkts[2], pk.Bye)
        assert pkts[2].ssrcs == [42] and pkts[2].reason == b"done"
        return data, [(type(x).__name__, _plain(x)) for x in pkts]
    _both(body)


def test_ntp_conversion_roundtrip():
    def body(P):
        t = 1_700_000_123_456_789_000
        ntp = P.pk.ntp_from_ns(t)
        assert abs(P.pk.ns_from_ntp(ntp) - t) < 2
        return ntp, P.pk.ns_from_ntp(ntp)
    _both(body)


# ---------------------------------------------------------------------------
# session (sans-IO, injected time)
# ---------------------------------------------------------------------------

def _spkt(P, seq, ts=0, ssrc=0x1111, pt=96, payload=b"p"):
    return P.RtpPacket(payload_type=pt, seqnum=seq, timestamp=ts, ssrc=ssrc,
                       payload=payload)


def _rtcp(P, data):
    return [(type(x).__name__, _plain(x)) for x in P.pk.parse_rtcp(data)]


def test_session_send_recv_flow():
    def body(P):
        S = P.session
        s = S.Session()
        r = [s.handle_send(_spkt(P, 0), 0), s.handle_send(_spkt(P, 0), 0),
             s.handle_recv(_spkt(P, 10, ssrc=0x2222), 0),
             s.handle_recv(_spkt(P, 11, ssrc=0x2222), 0),
             s.handle_send(_spkt(P, 5, ssrc=0x2222), 0)]
        assert r == [S.SendReply.NEW_SSRC, S.SendReply.PASSTHROUGH,
                     S.RecvReply.NEW_SSRC, S.RecvReply.PASSTHROUGH,
                     S.SendReply.SSRC_COLLISION]
        return _plain(r)
    _both(body)


def test_session_rtcp_sr_generation():
    def body(P):
        s = P.session.Session()
        s.set_pt_clock_rate(96, 48000)
        s.handle_send(_spkt(P, 0, ts=0), 0)
        for i in range(10):
            s.handle_send(_spkt(P, i, ts=i * 480), i * 10_000_000)
        assert s.poll_rtcp_send(SECOND) is None
        data = s.poll_rtcp_send(6 * SECOND, unix_now=1_700_000_000 * SECOND)
        assert data is not None
        pkts = P.pk.parse_rtcp(data)
        assert isinstance(pkts[0], P.pk.SenderReport)
        assert pkts[0].packet_count == 10
        assert isinstance(pkts[1], P.pk.Sdes)
        assert s.poll_rtcp_send(6 * SECOND + 1) is None
        # the SSRC is the first packet's, the rest is deterministic
        return _rtcp(P, data)
    _both(body)


def test_session_rr_loss_reporting():
    def body(P):
        s = P.session.Session()
        s.set_pt_clock_rate(96, 8000)
        now = 0
        for seq in [0, 1, 2, 3, 4, 8, 9]:
            s.handle_recv(_spkt(P, seq, ts=seq * 160, ssrc=0x3333), now)
            now += 20_000_000
        data = s.poll_rtcp_send(10 * SECOND)
        rr = P.pk.parse_rtcp(data)[0]
        assert isinstance(rr, P.pk.ReceiverReport)
        blk = rr.reports[0]
        assert blk.ssrc == 0x3333
        assert blk.cumulative_lost == 3
        assert blk.ext_highest_seq == 9
        # the receiver's own SSRC is drawn at random: compare the blocks
        return _plain(rr.reports), _rtcp(P, data)[1:]
    _both(body)


def test_session_bye_and_timeout():
    def body(P):
        s = P.session.Session()
        s.handle_recv(_spkt(P, 0, ssrc=7), 0)
        evs = s.handle_rtcp_recv(P.pk.Bye([7], b"bye").to_bytes(), SECOND)
        assert ("bye", 7) in evs
        s2 = P.session.Session()
        s2.handle_recv(_spkt(P, 0, ssrc=9), 0)
        out = s2.timed_out_sources(100 * SECOND)
        assert out == [9]
        assert 9 not in s2.remote_sources
        return _plain(evs), out
    _both(body)


def test_session_sr_sync_mapping():
    def body(P):
        s = P.session.Session()
        sr = P.pk.SenderReport(ssrc=5, ntp_timestamp=P.pk.ntp_from_ns(
            1000 * SECOND), rtp_timestamp=90000, packet_count=1,
            octet_count=10)
        s.handle_rtcp_recv(sr.to_bytes(), 0)
        ntp_ns, rtp = s.ntp_rtp_mapping(5)
        assert rtp == 90000
        assert abs(ntp_ns - 1000 * SECOND) < 2
        return ntp_ns, rtp
    _both(body)


# ---------------------------------------------------------------------------
# jitterbuffer
# ---------------------------------------------------------------------------

def _drain_forward(P, jb, now):
    out = []
    while True:
        r = jb.poll(now)
        if r.outcome is not P.jb.PollOutcome.FORWARD:
            return out, _plain(r)
        out.append(_plain(r))


def test_jitterbuffer_reorders():
    def body(P):
        jb = P.jb.JitterBuffer(latency=100)
        ids = {}
        for seq in (0, 2, 1):
            res, pid = jb.queue_packet(seq, now=0)
            assert res is P.jb.QueueResult.QUEUED
            ids[seq] = pid
        fwd, last = _drain_forward(P, jb, 200)
        assert [r["id"] for r in fwd] == [ids[0], ids[1], ids[2]]
        return ids, fwd, last
    _both(body)


def test_jitterbuffer_duplicate_late():
    def body(P):
        QR = P.jb.QueueResult
        jb = P.jb.JitterBuffer(latency=100)
        a = jb.queue_packet(0, 0)
        res, _ = jb.queue_packet(0, 0)
        assert res is QR.DUPLICATE
        r = jb.poll(200)
        assert r.outcome is P.jb.PollOutcome.FORWARD
        late, _ = jb.queue_packet(0, 300)
        assert late is QR.LATE
        return _plain((a, res, r, late))
    _both(body)


def test_jitterbuffer_timeout_then_contiguous_flow():
    def body(P):
        jb = P.jb.JitterBuffer(latency=100)
        _, p0 = jb.queue_packet(0, now=0)
        r = jb.poll(50)
        assert r.outcome is P.jb.PollOutcome.TIMEOUT and r.time == 100
        r0 = jb.poll(100)
        assert r0.id == p0
        _, p1 = jb.queue_packet(1, now=110)
        r1 = jb.poll(111)
        assert r1.id == p1
        return _plain((r, r0, r1))
    _both(body)


def test_jitterbuffer_loss_reported():
    def body(P):
        jb = P.jb.JitterBuffer(latency=10)
        jb.queue_packet(0, 0)
        r0 = jb.poll(20)
        assert r0.outcome is P.jb.PollOutcome.FORWARD
        jb.queue_packet(3, 30)
        r = jb.poll(50)
        assert r.outcome is P.jb.PollOutcome.FORWARD
        assert r.lost_seqnums == (1, 2)
        return _plain((r0, r))
    _both(body)


def test_jitterbuffer_seqnum_wraparound():
    def body(P):
        jb = P.jb.JitterBuffer(latency=10)
        ids = []
        for seq in (65534, 65535, 0, 1):
            res, pid = jb.queue_packet(seq, 0)
            assert res is P.jb.QueueResult.QUEUED
            ids.append(pid)
        fwd, last = _drain_forward(P, jb, 100)
        assert [r["id"] for r in fwd] == ids
        return ids, fwd, last
    _both(body)


def test_jitterbuffer_lost_seqnums_wrap():
    """tests/test_review_regressions.py:79."""
    def body(P):
        jb = P.jb.JitterBuffer(latency=0)
        jb.queue_packet(65533, 0)
        r0 = jb.poll(1)
        assert r0.outcome is P.jb.PollOutcome.FORWARD
        jb.queue_packet(2, 10)
        r = jb.poll(20)
        assert r.outcome is P.jb.PollOutcome.FORWARD
        assert r.lost_seqnums == (65534, 65535, 0, 1)
        return _plain((r0, r))
    _both(body)


# ---------------------------------------------------------------------------
# pay/depay loopbacks
# ---------------------------------------------------------------------------

def test_l16_pay_depay_loopback():
    def body(P):
        p, sink, bufs, res = _launch_run(
            P, "audiotestsrc num-buffers=10 samplesperbuffer=160 "
               "! audio/x-raw, format=S16BE, rate=8000, channels=1 "
               "! rtpL16pay2 ! rtpL16depay2 ! appsink name=sink")
        assert sum(b.size for b in bufs) == 10 * 160 * 2
        s = sink.caps[0]
        assert s.name == "audio/x-raw" and s["format"] == "S16BE"
        assert s["rate"] == 8000
        p.set_state(P.State.NULL)
        return res
    _both(body)


def test_opus_pay_depay_pts():
    def body(P):
        h = P.Harness("rtpopuspay2")
        h.set_caps("audio/x-opus, rate=48000, channels=2")
        for i in range(3):
            h.push(P.Buffer(bytes([i] * 50), pts=i * 20_000_000))
        bufs = h.pull_all()
        pkts = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert [p.seqnum for p in pkts] == \
            [(pkts[0].seqnum + i) & 0xFFFF for i in range(3)]
        assert (pkts[1].timestamp - pkts[0].timestamp) & 0xFFFFFFFF == 960
        h.teardown()
        return _bufs(bufs), [_plain(p) for p in pkts]
    _both(body)


def test_rtpsend_rtprecv_loop():
    def body(P):
        p, _, bufs, res = _launch_run(
            P, "audiotestsrc num-buffers=20 samplesperbuffer=160 "
               "! audio/x-raw, format=S16BE, rate=8000, channels=1 "
               "! rtpL16pay2 ! rtpsend name=send ! rtprecv name=recv "
               "latency=0 ! rtpL16depay2 ! appsink name=sink")
        assert sum(b.size for b in bufs) == 20 * 160 * 2
        recv = p.get_by_name("recv")
        assert len(recv.session.remote_sources) == 1
        sources = sorted(recv.session.remote_sources)
        p.set_state(P.State.NULL)
        return res, sources
    _both(body)


def _drive_until(p, cond, limit=60.0):
    """Iterate `p` until `cond()` holds; fails after `limit` seconds,
    which only a fault reaches (loopback delivery happens inside the
    sender's `sendto`)."""
    import time
    deadline = time.monotonic() + limit
    while not cond():
        if not p.iterate():
            assert time.monotonic() < deadline, "no datagram arrived"
            time.sleep(0.001)


def test_udp_roundtrip_localhost():
    def body(P):
        recv = P.parse_launch("udpsrc name=src port=0 ! appsink name=sink")
        src = recv.get_by_name("src")
        sink = recv.get_by_name("sink")
        recv.set_state(P.State.PLAYING)
        port = src.bound_port
        assert port > 0
        send = P.parse_launch(
            f"audiotestsrc num-buffers=5 samplesperbuffer=100 "
            f"! audio/x-raw, format=S16LE, rate=8000, "
            f"channels=1 ! udpsink host=127.0.0.1 port={port}")
        send.set_state(P.State.PLAYING)
        send.run()
        _drive_until(recv, lambda: len(sink.samples) >= 5)
        assert len(sink.samples) == 5
        NetAddressMeta = P.mod("core.buffer").NetAddressMeta
        metas = [b.get_meta(NetAddressMeta) for b in sink.samples]
        assert all(m is not None and m.addr[0] == "127.0.0.1"
                   for m in metas)
        data = [b.to_bytes() for b in sink.pull_all()]
        send.set_state(P.State.NULL)
        recv.set_state(P.State.NULL)
        # the sender's port is the kernel's choice
        return data, [m.addr[0] for m in metas]
    _both(body)


def _onvif_doc():
    return (b"<?xml version='1.0'?><tt:MetadataStream "
            b"xmlns:tt='http://www.onvif.org/ver10/schema'>"
            + b"<tt:Event>" + b"x" * 3000 + b"</tt:Event>"
            b"</tt:MetadataStream>")


def test_onvif_metadata_pay_depay():
    def body(P):
        onvif = P.mod("elements.net.onvif")
        xml = _onvif_doc()
        p = P.parse_launch("appsrc name=src "
                           "! application/x-onvif-metadata, encoding=utf8 "
                           "! onvifmetadatapay mtu=500 ! onvifmetadatadepay "
                           "! appsink name=sink")
        src, sink = p.get_by_name("src"), p.get_by_name("sink")
        src.set_property("caps", P.parse_caps(
            "application/x-onvif-metadata, encoding=utf8"))
        p.set_state(P.State.PLAYING)
        src.push_buffer(P.Buffer(xml, pts=0))
        src.end_of_stream()
        p.run()
        out = sink.pull_all()
        assert len(out) == 1
        assert out[0].to_bytes() == xml
        assert out[0].get_meta(onvif.OnvifXMLFrameMeta) is not None
        p.set_state(P.State.NULL)
        return repr(sink.caps), _bufs(out)
    _both(body)


def _harness_pay(P, factory, caps, pushes, eos=False, **props):
    pay = P.Harness(P.make(factory, **props))
    pay.set_caps(caps)
    for data, pts in pushes:
        pay.push(P.Buffer(data, pts=pts))
    if eos:
        pay.push_eos()
    pkts = pay.pull_all()
    caps_out = repr(pay.element.srcpad.caps())
    pay.teardown()
    return pkts, caps_out


def _harness_depay(P, factory, caps, pkts):
    depay = P.Harness(P.make(factory))
    depay.set_caps(caps)
    for p in pkts:
        depay.push(P.Buffer(p.to_bytes()))
    outs = depay.pull_all()
    caps_out = depay.element.srcpad.caps()
    depay.teardown()
    return outs, caps_out


_FIXED = dict(ssrc=1, seqnum_offset=0, timestamp_offset=0)


def test_rtp_mp2t_roundtrip():
    def body(P):
        build_ts_packet = P.mod("codecs.mpegts").build_ts_packet
        ts = b"".join(build_ts_packet(0x100, payload=bytes([i]) * 184,
                                      pusi=True, cc=i) for i in range(9))
        pkts, pcaps = _harness_pay(
            P, "rtpmp2tpay2", "video/mpegts, packetsize=188, "
            "systemstream=true", [(ts, 0)], eos=True, mtu=1400, ssrc=7,
            seqnum_offset=0, timestamp_offset=0)
        assert len(pkts) == 2
        p0 = P.RtpPacket.parse(pkts[0].to_bytes())
        assert p0.payload_type == 33
        assert len(p0.payload) == 7 * 188
        assert p0.payload[0] == 0x47
        outs, caps = _harness_depay(
            P, "rtpmp2tdepay2", "application/x-rtp, media=video, "
            "encoding-name=MP2T, clock-rate=90000, payload=33", pkts)
        assert b"".join(b.to_bytes() for b in outs) == ts
        assert caps[0]["packetsize"] == 188
        return _bufs(pkts), pcaps, _bufs(outs), repr(caps)
    _both(body)


def test_rtp_mp2t_depay_resync():
    def body(P):
        build_ts_packet = P.mod("codecs.mpegts").build_ts_packet
        good = build_ts_packet(0x30, payload=b"x" * 184, pusi=True)
        pkt = P.RtpPacket(payload_type=33, seqnum=1, timestamp=0, ssrc=1,
                          payload=b"\x00\x00\x00" + good)
        outs, caps = _harness_depay(
            P, "rtpmp2tdepay2", "application/x-rtp, media=video, "
            "encoding-name=MP2T, clock-rate=90000, payload=33", [pkt])
        assert len(outs) == 1 and outs[0].to_bytes() == good
        return _bufs(outs), repr(caps)
    _both(body)


def test_rtp_ac3_whole_and_fragmented():
    def body(P):
        small = b"\x0b\x77" + bytes(30)
        big = b"\x0b\x77" + bytes(300)
        bufs, pcaps = _harness_pay(
            P, "rtpac3pay2", "audio/x-ac3, framed=true, rate=48000",
            [(small, 0), (big, 10**6)], mtu=100, **_FIXED)
        pkts = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert pkts[0].payload[:2] == bytes([0, 1])
        assert pkts[0].payload[2:] == small and pkts[0].marker
        frags = pkts[1:]
        assert frags[0].payload[0] == 1
        assert all(p.payload[0] == 3 for p in frags[1:])
        assert all(p.payload[1] == len(frags) for p in frags)
        assert frags[-1].marker
        outs, caps = _harness_depay(
            P, "rtpac3depay2", "application/x-rtp, media=audio, "
            "encoding-name=AC3, clock-rate=48000", pkts)
        assert [o.to_bytes() for o in outs] == [small, big]
        assert caps[0]["rate"] == 48000
        return _bufs(bufs), pcaps, _bufs(outs), repr(caps)
    _both(body)


def test_rtp_mpa_roundtrip():
    def body(P):
        frame = bytes(range(100))
        bufs, pcaps = _harness_pay(P, "rtpmpapay2", "audio/mpeg, "
                                   "mpegversion=1", [(frame, 0)], mtu=60,
                                   **_FIXED)
        pkts = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert all(p.payload_type == 14 for p in pkts)
        assert len(pkts) == 3
        assert pkts[1].payload[2:4] == (44).to_bytes(2, "big")
        outs, caps = _harness_depay(
            P, "rtpmpadepay2", "application/x-rtp, media=audio, "
            "encoding-name=MPA, clock-rate=90000, payload=14", pkts)
        assert len(outs) == 1 and outs[0].to_bytes() == frame
        return _bufs(bufs), pcaps, _bufs(outs), repr(caps)
    _both(body)


def test_rtp_mp4g_aac_hbr_roundtrip():
    def body(P):
        small, big = bytes(range(50)), bytes(200)
        bufs, pcaps = _harness_pay(
            P, "rtpmp4gpay2", "audio/mpeg, mpegversion=4, stream-format=raw,"
            " rate=44100", [(small, 0), (big, 10**6)], mtu=100, **_FIXED)
        pkts = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert pkts[0].payload[:2] == (16).to_bytes(2, "big")
        assert pkts[0].payload[2] << 8 | pkts[0].payload[3] == 50 << 3
        assert pkts[0].marker
        assert not pkts[1].marker and pkts[-1].marker
        outs, caps = _harness_depay(
            P, "rtpmp4gdepay2", "application/x-rtp, media=audio, "
            "encoding-name=MPEG4-GENERIC, mode=AAC-hbr, clock-rate=44100, "
            "sizelength=13, indexlength=3, indexdeltalength=3, payload=96",
            pkts)
        assert [o.to_bytes() for o in outs] == [small, big]
        assert caps[0]["mpegversion"] == 4 and caps[0]["rate"] == 44100
        return _bufs(bufs), pcaps, _bufs(outs), repr(caps)
    _both(body)


def test_onvif_metadata_parse_retime_and_group():
    NS = "http://www.onvif.org/ver10/schema"

    def doc(*utcs):
        frames = "".join(
            f'<tt:Frame UtcTime="{u}"><tt:Object ObjectId="1"/>'
            f"</tt:Frame>" for u in utcs)
        return (f'<tt:MetadataStream xmlns:tt="{NS}">'
                f"<tt:VideoAnalytics>{frames}</tt:VideoAnalytics>"
                f"</tt:MetadataStream>").encode()

    def body(P):
        onvif = P.mod("elements.net.onvif")
        h = P.Harness(P.make("onvifmetadataparse", max_lateness=0))
        h.set_caps("application/x-onvif-metadata, encoding=utf8")
        h.push(P.Buffer(doc("2026-01-01T00:00:01.000Z",
                            "2026-01-01T00:00:00.000Z"), pts=10**9))
        h.push(P.Buffer(doc("2026-01-01T00:00:02.000Z"), pts=3 * 10**9))
        h.push_eos()
        outs = h.pull_all()
        assert len(outs) == 3
        assert [o.pts for o in outs] == sorted(o.pts for o in outs)
        assert outs[1].pts - outs[0].pts == 10**9
        parsed = list(onvif.iterate_video_analytics_frames(
            outs[0].to_bytes()))
        assert len(parsed) == 1
        h.teardown()
        import xml.etree.ElementTree as ET
        return _bufs(outs), [(t, ET.tostring(f)) for t, f in parsed]
    _both(body)


def test_onvif_metadata_parse_bad_xml_errors():
    def body(P):
        h = P.Harness(P.make("onvifmetadataparse"))
        h.set_caps("application/x-onvif-metadata, encoding=utf8")
        r = h.push(P.Buffer(b"<not-xml"))
        assert r is P.FlowReturn.ERROR
        h.teardown()
        return r.name
    _both(body)


def _jpeg(rng_seed, shape, **save):
    import io
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(rng_seed)
    img = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8),
                          "RGB")
    b = io.BytesIO()
    img.save(b, "JPEG", **save)
    return b.getvalue()


def test_rtp_jpeg_roundtrip_decodes_pixel_exact():
    import io
    jpeg = _jpeg(3, (48, 64, 3), quality=75)
    Image = pytest.importorskip("PIL.Image")

    def body(P):
        bufs, pcaps = _harness_pay(P, "rtpjpegpay2", "image/jpeg",
                                   [(jpeg, 0)], mtu=400, **_FIXED)
        pkts = [P.RtpPacket.parse(x.to_bytes()) for x in bufs]
        assert len(pkts) > 1
        assert pkts[0].payload_type == 26
        assert pkts[0].payload[5] == 255
        assert pkts[0].payload[6] == 64 // 8
        assert pkts[-1].marker
        outs, caps = _harness_depay(
            P, "rtpjpegdepay2", "application/x-rtp, media=video, "
            "encoding-name=JPEG, clock-rate=90000, payload=26", pkts)
        assert len(outs) == 1
        orig = np.asarray(Image.open(io.BytesIO(jpeg)))
        back = np.asarray(Image.open(io.BytesIO(outs[0].to_bytes())))
        assert (orig == back).all()
        return _bufs(bufs), pcaps, _bufs(outs), repr(caps)
    _both(body)


def test_rtp_jpeg_depay_midstream_join():
    import io
    jpeg = _jpeg(4, (16, 16, 3))
    Image = pytest.importorskip("PIL.Image")

    def body(P):
        bufs, _ = _harness_pay(P, "rtpjpegpay2", "image/jpeg",
                               [(jpeg, 0), (jpeg, 10**9 // 30)], mtu=200,
                               **_FIXED)
        depay = P.Harness(P.make("rtpjpegdepay2"))
        depay.set_caps("application/x-rtp, media=video, "
                       "encoding-name=JPEG, clock-rate=90000, payload=26")
        for p in bufs[1:]:
            depay.push(p)
        outs = depay.pull_all()
        assert len(outs) == 1
        Image.open(io.BytesIO(outs[0].to_bytes())).load()
        depay.teardown()
        return _bufs(bufs), _bufs(outs)
    _both(body)


def _av1_obu(P, otype, body):
    leb128_encode = P.mod("elements.net.rtp_video").leb128_encode
    return bytes([otype << 3 | 0x02]) + leb128_encode(len(body)) + body


def test_rtp_av1_roundtrip():
    def body(P):
        rv = P.mod("elements.net.rtp_video")
        tu = (_av1_obu(P, 2, b"") + _av1_obu(P, 1, bytes(range(20)))
              + _av1_obu(P, 6, bytes(600)))
        bufs, pcaps = _harness_pay(P, "rtpav1pay2", "video/x-av1, "
                                   "stream-format=obu-stream", [(tu, 0)],
                                   mtu=200, **_FIXED)
        pkts = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert len(pkts) > 1
        assert pkts[0].payload[0] & 0x08
        assert not pkts[0].payload[0] & 0x80
        assert pkts[1].payload[0] & 0x80
        assert pkts[-1].marker
        outs, caps = _harness_depay(
            P, "rtpav1depay2", "application/x-rtp, media=video, "
            "encoding-name=AV1, clock-rate=90000, payload=96", pkts)
        assert len(outs) == 1
        got = list(rv.parse_obus(outs[0].to_bytes()))
        assert [t for t, _ in got] == [2, 1, 6]
        assert got[1][1][1:] == bytes(range(20))
        assert got[2][1][1:] == bytes(600)
        return _bufs(bufs), pcaps, _bufs(outs), repr(caps), got
    _both(body)


def test_rtp_av1_small_tu_single_packet():
    def body(P):
        rv = P.mod("elements.net.rtp_video")
        tu = _av1_obu(P, 6, b"tiny-frame")
        bufs, _ = _harness_pay(P, "rtpav1pay2", "video/x-av1, "
                               "stream-format=obu-stream", [(tu, 0)],
                               **_FIXED)
        assert len(bufs) == 1
        p = P.RtpPacket.parse(bufs[0].to_bytes())
        assert p.payload[0] >> 4 & 3 == 1
        assert not p.payload[0] & 0x08
        outs, _ = _harness_depay(
            P, "rtpav1depay2", "application/x-rtp, media=video, "
            "encoding-name=AV1, clock-rate=90000, payload=96", [p])
        types = [t for t, _ in rv.parse_obus(outs[0].to_bytes())]
        assert types == [2, 6]
        return _bufs(bufs), _bufs(outs)
    _both(body)


@pytest.mark.parametrize("wb", [False, True])
def test_rtp_amr_octet_aligned_roundtrip(wb):
    def body(P):
        re_ = P.mod("elements.net.rtp_elements")
        sizes = re_._AMR_WB_SIZES if wb else re_._AMR_NB_SIZES
        sfx = "wb" if wb else ""
        rate = 16000 if wb else 8000
        fr = b""
        for ft in (0, 7):
            fr += bytes([ft << 3 | 0x04]) + bytes(range(sizes[ft]))
        bufs, pcaps = _harness_pay(P, f"rtpamr{sfx}pay2",
                                   "audio/AMR-WB" if wb else "audio/AMR",
                                   [(fr, 0)], **_FIXED)
        assert len(bufs) == 1
        p = P.RtpPacket.parse(bufs[0].to_bytes())
        assert p.payload[0] == 0xF0
        assert p.payload[1] & 0x80
        assert not p.payload[2] & 0x80
        outs, caps = _harness_depay(
            P, f"rtpamr{sfx}depay2", f"application/x-rtp, media=audio, "
            f"encoding-name={'AMR-WB' if wb else 'AMR'}, clock-rate={rate},"
            f" octet-align=(string)1, payload=96", [p])
        assert len(outs) == 1 and outs[0].to_bytes() == fr
        return _bufs(bufs), pcaps, _bufs(outs), repr(caps)
    _both(body)


def test_rtp_mpv_roundtrip():
    def body(P):
        frame = b"\x00\x00\x01\xb3" + bytes(500)
        bufs, pcaps = _harness_pay(P, "rtpmpvpay2", "video/mpeg, "
                                   "mpegversion=2, systemstream=false",
                                   [(frame, 0)], mtu=200, **_FIXED)
        pkts = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert len(pkts) == 3 and all(p.payload_type == 32 for p in pkts)
        assert pkts[0].payload[2] & 0x10
        assert pkts[-1].payload[2] & 0x08 and pkts[-1].marker
        outs, caps = _harness_depay(
            P, "rtpmpvdepay2", "application/x-rtp, media=video, "
            "encoding-name=MPV, clock-rate=90000, payload=32", pkts)
        assert len(outs) == 1 and outs[0].to_bytes() == frame
        return _bufs(bufs), pcaps, _bufs(outs), repr(caps)
    _both(body)


def test_rtp_vraw_roundtrip():
    frame = np.random.default_rng(5).integers(0, 256, (16, 64, 3),
                                              dtype=np.uint8)

    def body(P):
        vi = P.VideoInfo("RGB", 64, 16)
        pay = P.Harness(P.make("rtpvrawpay2", mtu=400, **_FIXED))
        pay.set_caps("video/x-raw, format=RGB, width=64, height=16, "
                     "framerate=30/1")
        pay.push(vi.make_buffer(frame.copy(), pts=0))
        pkts = pay.pull_all()
        assert len(pkts) > 1
        p0 = P.RtpPacket.parse(pkts[0].to_bytes())
        assert int.from_bytes(p0.payload[2:4], "big") > 0
        assert P.RtpPacket.parse(pkts[-1].to_bytes()).marker
        pcaps = repr(pay.element.srcpad.caps())
        pay.teardown()
        depay = P.Harness(P.make("rtpvrawdepay2"))
        depay.set_caps("application/x-rtp, media=video, encoding-name=RAW,"
                       " clock-rate=90000, payload=96, sampling=RGB, "
                       "width=(string)64, height=(string)16, "
                       "depth=(string)8")
        for p in pkts:
            depay.push(p)
        outs = depay.pull_all()
        assert len(outs) == 1
        caps = depay.element.srcpad.caps()
        back = P.VideoInfo.from_caps(caps).view(outs[0])
        assert (back == frame).all()
        depay.teardown()
        return _bufs(pkts), pcaps, _bufs(outs), repr(caps)
    _both(body)


def test_rtp_mp4a_latm_roundtrip():
    def body(P):
        small, big = bytes(range(60)), bytes(300)
        bufs, pcaps = _harness_pay(
            P, "rtpmp4apay2", "audio/mpeg, mpegversion=4, stream-format=raw,"
            " rate=44100, codec_data=(string)1210",
            [(small, 0), (big, 10**6)], mtu=120, **_FIXED)
        pkts = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert pkts[0].payload[0] == 60
        assert pkts[1].payload[0] == 0xFF
        assert pkts[1].payload[1] == 45
        outs, caps = _harness_depay(
            P, "rtpmp4adepay2", "application/x-rtp, media=audio, "
            "encoding-name=MP4A-LATM, clock-rate=44100, "
            "config=(string)1210, payload=96", pkts)
        assert [o.to_bytes() for o in outs] == [small, big]
        assert caps[0]["rate"] == 44100 and caps[0]["codec_data"] == "1210"
        return _bufs(bufs), pcaps, _bufs(outs), repr(caps)
    _both(body)


def test_l24_pay_depay_loopback():
    def body(P):
        p, sink, bufs, res = _launch_run(
            P, "audiotestsrc num-buffers=10 samplesperbuffer=160 "
               "! audio/x-raw, format=S24BE, rate=8000, channels=2 "
               "! rtpL24pay2 ! rtpL24depay2 ! appsink name=sink")
        assert sum(b.size for b in bufs) == 10 * 160 * 2 * 3
        s = sink.caps[0]
        assert s.name == "audio/x-raw" and s["format"] == "S24BE"
        assert s["rate"] == 8000 and s["channels"] == 2
        p.set_state(P.State.NULL)
        return res
    _both(body)


def test_l24_pay_seqnum_and_ts():
    def body(P):
        h = P.Harness("rtpL24pay2")
        h.set_caps("audio/x-raw, format=S24BE, rate=48000, channels=1, "
                   "layout=interleaved")
        for i in range(3):
            h.push(P.Buffer(bytes(400 * 3), pts=i * 10_000_000))
        bufs = h.pull_all()
        pkts = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert [p.seqnum for p in pkts] == \
            [(pkts[0].seqnum + i) & 0xFFFF for i in range(3)]
        assert (pkts[1].timestamp - pkts[0].timestamp) & 0xFFFFFFFF == 480
        assert all(len(p.payload) == 400 * 3 for p in pkts)
        h.teardown()
        return _bufs(bufs)
    _both(body)


def test_l24_mtu_fragmentation_frame_aligned():
    def body(P):
        h = P.Harness("rtpL24pay2")
        h.set_caps("audio/x-raw, format=S24BE, rate=48000, channels=2, "
                   "layout=interleaved")
        bpf = 6
        h.push(P.Buffer(bytes(480 * bpf), pts=0))
        bufs = h.pull_all()
        pkts = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert len(pkts) > 1
        frames_per_pkt = (1400 - 12) // bpf
        for p in pkts[:-1]:
            assert len(p.payload) == frames_per_pkt * bpf
            assert not p.marker
        assert pkts[-1].marker
        assert sum(len(p.payload) for p in pkts) == 480 * bpf
        assert (pkts[1].timestamp - pkts[0].timestamp) & 0xFFFFFFFF \
            == frames_per_pkt
        h.teardown()
        return _bufs(bufs)
    _both(body)


def test_s24_pack_unpack_roundtrip():
    def body(P):
        audio = P.mod("core.audio")
        vals = np.array([0, 1, -1, 0x7FFFFF, -0x800000, 12345, -54321],
                        np.int32)
        out = []
        for fmt in ("S24BE", "S24LE"):
            packed = audio.pack_s24(vals, fmt)
            assert packed.size == vals.size * 3
            back = audio.unpack_s24(packed.tobytes(), fmt)
            assert np.array_equal(back, vals)
            out.append((packed.tobytes(), back.tolist()))
        assert audio.pack_s24(np.array([0x123456]), "S24BE").tobytes() == \
            b"\x12\x34\x56"
        assert audio.pack_s24(np.array([0x123456]), "S24LE").tobytes() == \
            b"\x56\x34\x12"
        return out
    _both(body)


def test_audioconvert_s16_to_s24be():
    def body(P):
        p, sink, bufs, res = _launch_run(
            P, "audiotestsrc num-buffers=4 samplesperbuffer=100 "
               "! audio/x-raw, format=S16LE, rate=8000, channels=1 "
               "! audioconvert ! audio/x-raw, format=S24BE, rate=8000, "
               "channels=1 ! appsink name=sink")
        assert sum(b.size for b in bufs) == 4 * 100 * 3
        info = P.mod("core.audio").AudioInfo.from_caps(sink.caps)
        x = np.concatenate([info.view(b)[:, 0] for b in bufs])
        assert np.abs(x).max() > 0.5 * (1 << 23)
        p.set_state(P.State.NULL)
        return res, x.tolist()
    _both(body)


# ---------------------------------------------------------------------------
# rtpmparobustdepay2 (tests/test_mparobust.py)
# ---------------------------------------------------------------------------

HDR23 = bytes([0x94, 0x00])
CAPACITY = 348
HSI = 36


def side_info(backpointer: int) -> bytes:
    si = bytearray(32)
    si[0] = backpointer >> 1
    si[1] = (backpointer & 1) << 7
    return bytes(si)


def adu_bytes(data: bytes, backpointer: int = 0, index: int = 0xFF,
              cycle: int = 7) -> bytes:
    b1 = (cycle << 5) | 0x1B
    return bytes([index, b1]) + HDR23 + side_info(backpointer) + data


def descriptor(size: int, cont: bool = False, two_byte: bool = True):
    if two_byte:
        return bytes([(0x80 if cont else 0) | 0x40 | (size >> 8),
                      size & 0xFF])
    return bytes([(0x80 if cont else 0) | size])


def rtp(payload: bytes, seq: int, ts: int = 0, pt: int = 96) -> bytes:
    return struct.pack(">BBHII", 0x80, pt, seq, ts, 0x1234) + payload


class Rig:
    """tests/test_mparobust.py's Rig on one package's names."""

    def __init__(self, P):
        self.P = P
        self.el = P.make("rtpmparobustdepay2")
        self.out = _capture(P, self.el.static_pad("src"))
        self.el.set_state(P.el.State.PLAYING)
        self.feeder = _feeder(P)
        self.feeder.link(self.el.static_pad("sink"))
        _start(P, self.feeder, "application/x-rtp, media=audio, "
               "clock-rate=90000, encoding-name=MPA-ROBUST")
        self.seq = 0

    def push(self, payload: bytes):
        self.feeder.push(self.P.Buffer(rtp(payload, self.seq)))
        self.seq += 1

    def eos(self):
        self.feeder.push_event(self.P.ev.EosEvent())

    def frames(self):
        return [b.to_bytes() for b in self.out]


def _rig_twin(run):
    """`run(rig)` on each package's Rig: its frames and buffers equal."""
    def body(P):
        rig = Rig(P)
        run(rig)
        return _bufs(rig.out)
    return _both(body)


def test_simple_full_adu_roundtrip():
    data = bytes(range(256)) + bytes(CAPACITY - 256)

    def run(rig):
        adu = adu_bytes(data)
        rig.push(descriptor(len(adu)) + adu)
        rig.eos()
        frames = rig.frames()
        assert len(frames) == 1
        f = frames[0]
        assert len(f) == 384
        assert f[:2] == b"\xff\xfb"
        assert f[2:4] == HDR23
        assert f[HSI:] == data
    _rig_twin(run)


def test_bit_reservoir_reassembly():
    A, B = bytes([1]) * 100, bytes([2]) * 300
    C, D = bytes([3]) * 200, bytes([4]) * 100

    def run(rig):
        payload = b""
        for data, bp in ((A, 0), (B, 248), (C, 296), (D, 444)):
            adu = adu_bytes(data, bp)
            payload += descriptor(len(adu)) + adu
        rig.push(payload)
        rig.eos()
        frames = rig.frames()
        assert len(frames) == 4
        assert all(len(f) == 384 for f in frames)
        assert frames[0][HSI:] == A + B[:248]
        assert frames[1][HSI:] == B[248:] + C + D[:96]
        assert frames[2][HSI:] == D[96:] + bytes(CAPACITY - 4)
        assert frames[3][HSI:] == bytes(CAPACITY)
        assert frames[1][4] == 248 >> 1
    _rig_twin(run)


def test_fragmented_adu():
    data = bytes([7]) * CAPACITY

    def run(rig):
        adu = adu_bytes(data)
        part1, part2 = adu[:200], adu[200:]
        rig.push(descriptor(len(adu)) + part1)
        assert rig.frames() == []
        rig.push(descriptor(len(adu), cont=True) + part2)
        rig.eos()
        frames = rig.frames()
        assert len(frames) == 1
        assert frames[0][HSI:] == data
    _rig_twin(run)


def test_one_byte_descriptor():
    data = bytes([9]) * 20

    def run(rig):
        adu = adu_bytes(data)
        assert len(adu) < 64
        rig.push(descriptor(len(adu), two_byte=False) + adu)
        rig.eos()
        frames = rig.frames()
        assert len(frames) == 1
        assert frames[0][HSI:HSI + 20] == data
        assert frames[0][HSI + 20:] == bytes(CAPACITY - 20)
    _rig_twin(run)


def test_deinterleaving_restores_order():
    d0, d1, d2 = (bytes([v]) * CAPACITY for v in (10, 11, 12))

    def run(rig):
        for idx, data in ((1, d1), (0, d0)):
            adu = adu_bytes(data, index=idx, cycle=0)
            rig.push(descriptor(len(adu)) + adu)
        assert rig.frames() == []
        adu = adu_bytes(d2, index=0, cycle=1)
        rig.push(descriptor(len(adu)) + adu)
        rig.eos()
        frames = rig.frames()
        assert len(frames) == 3
        assert [f[HSI:] for f in frames] == [d0, d1, d2]
    _rig_twin(run)


def test_dummy_adu_on_loss():
    data = bytes([5]) * 200

    def run(rig):
        adu = adu_bytes(data, backpointer=100)
        rig.push(descriptor(len(adu)) + adu)
        rig.eos()
        frames = rig.frames()
        assert len(frames) == 2
        filler = frames[0]
        assert len(filler) == 384
        assert (((filler[4] << 8) | filler[5]) >> 7) == 0
        assert filler[HSI:HSI + 248] == bytes(248)
        assert filler[HSI + 248:] == data[:100]
        real = frames[1]
        assert real[HSI:HSI + 100] == data[100:]
        assert real[HSI + 100:] == bytes(CAPACITY - 100)
    _rig_twin(run)


def test_mparobust_pipeline_parse_launch():
    """tests/test_mparobust.py::test_pipeline_parse_launch."""
    data = bytes([3]) * CAPACITY

    def body(P):
        p = P.parse_launch("appsrc name=src caps=\"application/x-rtp, "
                           "media=audio, clock-rate=90000, "
                           "encoding-name=MPA-ROBUST\" ! "
                           "rtpmparobustdepay2 ! appsink name=out")
        src, out = p.get_by_name("src"), p.get_by_name("out")
        p.set_state(P.State.PLAYING)
        adu = adu_bytes(data)
        src.push_buffer(P.Buffer(rtp(descriptor(len(adu)) + adu, 0)))
        src.end_of_stream()
        p.run()
        bufs = out.pull_all()
        assert len(bufs) == 1
        assert bufs[0].to_bytes()[HSI:] == data
        assert "parsed=true" in str(out.caps).replace(" ", "").lower() \
            or out.caps[0].get("parsed") in (True, "true", 1)
        p.set_state(P.State.NULL)
        return repr(out.caps), _bufs(bufs)
    _both(body)


def test_crc_protected_backpointer_offset():
    def body(P):
        Adu = P.mod("net.rtp.mparobust").Adu
        si = bytearray(32)
        bp = 100
        si[0] = bp >> 1
        si[1] = (bp & 1) << 7
        raw = (bytes([0xFF, 0xFA, 0x94, 0x00]) + b"\xde\xad"
               + bytes(si) + bytes([7]) * 50)
        adu = Adu.parse(raw)
        assert adu is not None
        assert adu.backpointer == 100
        assert adu.header_side_info_len == 4 + 32 + 2
        return _plain(adu)
    _both(body)


def test_oversized_adu_payload_truncates_not_crashes():
    data = bytes([9]) * (CAPACITY + 500)

    def run(rig):
        adu = adu_bytes(data)
        rig.push(descriptor(len(adu)) + adu)
        rig.eos()
        frames = rig.frames()
        assert frames and all(len(f) == 384 for f in frames)
    _rig_twin(run)


def test_zero_capacity_adu_dropped():
    head = bytes([0xFF, 0xFB, 0x04, 0x00])
    raw = head + bytes(32) + head + bytes(20)

    def body(P):
        adu = P.mod("net.rtp.mparobust").Adu.parse(raw)
        rig = Rig(P)
        rig.push(descriptor(len(raw)) + raw)
        rig.eos()
        return (None if adu is None else _plain(adu)), _bufs(rig.out)
    _both(body)


# ---------------------------------------------------------------------------
# raptorqenc/raptorqdec (tests/test_raptorq.py)
# ---------------------------------------------------------------------------

def _fec_rtp(P, seq, body):
    return P.RtpPacket(payload_type=96, seqnum=seq, timestamp=seq * 90,
                       ssrc=42, payload=body).to_bytes()


def _run_chain(P, drop, k=4, r=2, n=8):
    """n source packets through raptorqenc, source seqnums in `drop`
    dropped, through raptorqdec: the packets in, those out, the wire and
    the decoder's stats."""
    enc = P.Harness(P.make("raptorqenc", symbols_per_block=k,
                           repair_packets=r))
    enc.set_caps("application/x-rtp")
    pkts_in = [_fec_rtp(P, 100 + i, bytes([i]) * (10 + i)) for i in range(n)]
    for p in pkts_in:
        enc.push(P.Buffer(p))
    enc.push_eos()
    wire = [b.to_bytes() for b in enc.pull_all()]
    enc.teardown()
    dec = P.Harness(P.make("raptorqdec"))
    dec.set_caps("application/x-rtp")
    for w in wire:
        pkt = P.RtpPacket.parse(w)
        if pkt.payload_type != 97 and pkt.seqnum in drop:
            continue
        dec.push(P.Buffer(w))
    dec.push_eos()
    out = [b.to_bytes() for b in dec.pull_all()]
    stats = dict(dec.element.stats)
    dec.teardown()
    return pkts_in, out, wire, stats


def _chain_twin(drop, check, unrecovered):
    """_run_chain in both packages: the same packets out, the same wire,
    the same recovered count. gstpu's decoder also counts as unrecovered
    each block it opened anew for a repair packet after handing the block
    on; the port's counts only the blocks it could not recover
    (`unrecovered`)."""
    stats = {}

    def body(P):
        pkts, out, wire, stats[P.name] = _run_chain(P, drop)
        check(pkts, out)
        return out, wire, stats[P.name]["recovered"]
    _both(body)
    assert stats["gstpu_torch"]["unrecovered"] == unrecovered
    assert stats["gstpu"]["unrecovered"] >= unrecovered


def test_no_loss_passthrough():
    def check(pkts, out):
        assert out == pkts
    _chain_twin(set(), check, 0)


def test_recovers_dropped_packets():
    def check(pkts, out):
        assert out == pkts
    _chain_twin({101, 103, 105}, check, 0)


def test_unrecoverable_block_flushes_remainder():
    def check(pkts, out):
        assert pkts[3] in out
        assert all(p in out for p in pkts[4:])
        assert len(out) == 5
    _chain_twin({100, 101, 102}, check, 1)


def test_raptorqdec_ignores_repair_after_its_block():
    """The port's departure: on a live stream (no EOS), a block handed on
    before its last repair packet arrives does not hold back the blocks
    after it. gstpu's decoder opens the block anew for that repair packet
    and hands nothing more on until EOS."""
    seen = {}
    for name in NAMES:
        P = RPkg(name)
        enc = P.Harness(P.make("raptorqenc", symbols_per_block=4,
                               repair_packets=2))
        enc.set_caps("application/x-rtp")
        src = [_fec_rtp(P, 100 + i, bytes([i]) * (10 + i))
               for i in range(12)]
        for x in src:
            enc.push(P.Buffer(x))
        wire = [b.to_bytes() for b in enc.pull_all()]
        enc.teardown()
        dec = P.Harness(P.make("raptorqdec"))
        dec.set_caps("application/x-rtp")
        for w in wire:
            pkt = P.RtpPacket.parse(w)
            if pkt.payload_type == 97 or pkt.seqnum != 101:
                dec.push(P.Buffer(w))
        seen[name] = [b.to_bytes() for b in dec.pull_all()], \
            dict(dec.element.stats), src
        dec.teardown()
    out, stats, src = seen["gstpu_torch"]
    assert out == src and stats == {"recovered": 1, "unrecovered": 0}
    assert seen["gstpu"][0] == src[:4]


def test_repair_packet_shape():
    def body(P):
        enc = P.Harness(P.make("raptorqenc", symbols_per_block=2,
                               repair_packets=1, repair_pt=111))
        enc.set_caps("application/x-rtp")
        enc.push(P.Buffer(_fec_rtp(P, 7, b"aa")))
        enc.push(P.Buffer(_fec_rtp(P, 8, b"bbbb")))
        bufs = enc.pull_all()
        outs = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert [p.payload_type for p in outs] == [96, 96, 111]
        rep = outs[2].payload
        assert int.from_bytes(rep[:2], "big") == 7
        assert rep[2] == 2 and rep[3] == 2
        enc.teardown()
        return _bufs(bufs)
    _both(body)


def test_fec_recovers_every_erasure_pattern():
    """Every way of losing up to r of k + r symbols of a seeded block is
    recovered, by both packages' codes to the same bytes; r + 1 losses
    are refused. The GF(256) arithmetic is checked against a carry-less
    multiply reduced by the polynomial 0x11D over all 2^16 pairs."""
    import itertools
    rng = np.random.default_rng(SEED)
    k, r = 5, 3
    source = [rng.integers(0, 256, 37, np.uint8).tobytes()
              for _ in range(k)]

    def clmul(a, b):
        p = 0
        for i in range(8):
            if b >> i & 1:
                p ^= a << i
        for i in range(15, 7, -1):
            if p >> i & 1:
                p ^= 0x11D << (i - 8)
        return p

    def body(P):
        fec = P.mod("net.fec")
        table = [[fec.gf_mul(a, b) for b in range(256)] for a in range(256)]
        assert table == [[clmul(a, b) for b in range(256)]
                         for a in range(256)]
        assert all(fec.gf_mul(a, fec.gf_inv(a)) == 1 for a in range(1, 256))
        repair = fec.encode_repair(source, r)
        symbols = dict(enumerate(source + repair))
        for lost in itertools.chain.from_iterable(
                itertools.combinations(range(k + r), m)
                for m in range(r + 1)):
            got = fec.decode_block(k, {i: s for i, s in symbols.items()
                                       if i not in lost})
            assert got == source, lost
        refused = 0
        for lost in itertools.combinations(range(k + r), r + 1):
            with pytest.raises(ValueError):
                fec.decode_block(k, {i: s for i, s in symbols.items()
                                     if i not in lost})
            refused += 1
        return repair, refused
    _both(body)


# ---------------------------------------------------------------------------
# the RTP cases of tests/test_review_regressions.py
# ---------------------------------------------------------------------------

def test_rtprecv_multiple_ssrcs_dont_collide():
    def body(P):
        recv = P.make("rtprecv", latency=0)
        h = P.Harness(recv, sink_pad="rtp_sink", src_pad="rtp_src")
        h.set_caps("application/x-rtp")
        payloads = {}
        for ssrc in (0xAAAA, 0xBBBB):
            for seq in range(3):
                pl = bytes([ssrc & 0xFF, seq]) * 5
                payloads[(ssrc, seq)] = pl
                pkt = P.RtpPacket(payload_type=96, seqnum=seq,
                                  timestamp=seq * 160, ssrc=ssrc, payload=pl)
                h.push(P.Buffer(pkt.to_bytes()))
        bufs = h.pull_all()
        outs = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert len(outs) == 6
        for p in outs:
            assert p.payload == payloads[(p.ssrc, p.seqnum)]
        h.teardown()
        return [b.to_bytes() for b in bufs]
    _both(body)


def test_rtprecv_survives_malformed_rtcp():
    def body(P):
        recv = P.make("rtprecv", latency=0)
        h = P.Harness(recv, sink_pad="rtp_sink", src_pad="rtp_src")
        feeder = _feeder(P)
        feeder.link(recv.static_pad("rtcp_sink"))
        r0 = feeder.push(P.Buffer(b"\x80\xc8\x00\xff" + b"\x00" * 8))
        assert r0.is_ok
        h.set_caps("application/x-rtp")
        pkt = P.RtpPacket(payload_type=96, seqnum=0, timestamp=0, ssrc=1,
                          payload=b"x")
        r1 = h.push(P.Buffer(pkt.to_bytes()))
        assert r1.is_ok
        out = [b.to_bytes() for b in h.pull_all()]
        h.teardown()
        return r0.name, r1.name, out
    _both(body)


def test_rtpsend_ssrc_collision_drops():
    def body(P):
        send = P.make("rtpsend")
        h = P.Harness(send, sink_pad="rtp_sink", src_pad="rtp_src")
        h.set_caps("application/x-rtp")
        send.session.handle_recv(
            P.RtpPacket(payload_type=96, seqnum=0, timestamp=0, ssrc=7,
                        payload=b"r"), 0)
        pkt = P.RtpPacket(payload_type=96, seqnum=1, timestamp=10, ssrc=7,
                          payload=b"x")
        r = h.push(P.Buffer(pkt.to_bytes()))
        assert r.is_ok
        assert not h.buffers
        msgs = [m for m in h.bus.drain()
                if m.type is P.el.MessageType.ELEMENT]
        assert msgs and msgs[0].name == "rtpsend-ssrc-collision"
        h.teardown()
        return r.name, [(m.name, _plain(m.fields)) for m in msgs]
    _both(body)


def test_basepay_random_ssrcs_differ():
    """Eight payloaders draw eight SSRCs; under the seeded draws both
    packages draw the same eight."""
    def body(P):
        ssrcs = []
        for _ in range(8):
            el = P.make("rtpopuspay2")
            el.set_state(P.el.State.READY)
            ssrcs.append(el._ssrc)
            el.set_state(P.el.State.NULL)
        assert len(set(ssrcs)) >= 7
        return ssrcs
    _both(body)


def test_basepay_draws_from_system_random():
    """Outside the seeded twins the draws are the operating system's: two
    payloaders of the port started alike draw different SSRCs."""
    ssrcs = set()
    for _ in range(8):
        el = gstpu_torch.core.registry.make("rtpopuspay2")
        el.set_state(gstpu_torch.State.READY)
        ssrcs.add(el._ssrc)
        el.set_state(gstpu_torch.State.NULL)
    assert len(ssrcs) >= 7


# ---------------------------------------------------------------------------
# VP8/VP9 (tests/test_rtp_video_aging.py), PCMA (test_native_g711.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["vp8", "vp9"])
def test_vpx_pay_depay_loopback(codec):
    rng = np.random.default_rng(5)
    frames = [bytes([0x00]) + rng.bytes(500 + 100 * i) for i in range(4)]

    def body(P):
        p = P.parse_launch(f"appsrc name=src ! video/x-{codec} ! "
                           f"rtp{codec}pay2 mtu=200 ! rtp{codec}depay2 ! "
                           f"appsink name=sink")
        src, sink = p.get_by_name("src"), p.get_by_name("sink")
        src.set_property("caps", P.parse_caps(f"video/x-{codec}"))
        p.set_state(P.State.PLAYING)
        for i, f in enumerate(frames):
            src.push_buffer(P.Buffer(f, pts=i * 33_000_000))
        src.end_of_stream()
        p.run()
        out = sink.pull_all()
        assert [b.to_bytes() for b in out] == frames
        assert out[1].pts - out[0].pts == 33_000_000
        p.set_state(P.State.NULL)
        return repr(sink.caps), _bufs(out), [int(b.flags) for b in out]
    _both(body)


def test_vp8_fragments_over_mtu():
    def body(P):
        h = P.Harness(P.make("rtpvp8pay2", mtu=100))
        h.set_caps("video/x-vp8")
        h.push(P.Buffer(bytes(500), pts=0))
        bufs = h.pull_all()
        pkts = [P.RtpPacket.parse(b.to_bytes()) for b in bufs]
        assert len(pkts) > 4
        assert pkts[0].payload[0] & 0x10
        assert not (pkts[1].payload[0] & 0x10)
        assert pkts[-1].marker and not pkts[0].marker
        h.teardown()
        return _bufs(bufs)
    _both(body)


def test_g711_elements_rtp_roundtrip():
    def body(P):
        p, sink, bufs, res = _launch_run(
            P, "audiotestsrc num-buffers=10 samplesperbuffer=160 freq=400 "
               "! audio/x-raw, format=S16LE, rate=8000, channels=1 "
               "! alawenc ! rtppcmapay2 ! rtppcmadepay2 ! alawdec "
               "! appsink name=sink")
        assert sum(b.size for b in bufs) == 10 * 160 * 2
        info = P.mod("core.audio").AudioInfo.from_caps(sink.caps)
        assert info.format == "S16LE" and info.rate == 8000
        out = np.concatenate([info.view(b) for b in bufs])[:, 0]
        t = np.arange(out.size) / 8000
        corr = np.corrcoef(out.astype(np.float64),
                           np.sin(2 * np.pi * 400 * t))[0, 1]
        assert corr > 0.98
        p.set_state(P.State.NULL)
        return res, float(corr)
    _both(body)


# ---------------------------------------------------------------------------
# GCC (the GCC half of tests/test_sodium_gcc.py)
# ---------------------------------------------------------------------------

def _feedback(P, start_ns, n, interval_ns, size, extra_delay_per_pkt=0,
              base_delay=10**6):
    PacketFeedback = P.mod("net.rtp.gcc").PacketFeedback
    out = []
    for i in range(n):
        send = start_ns + i * interval_ns
        recv = send + base_delay + i * extra_delay_per_pkt
        out.append(PacketFeedback(send, recv, size))
    return out


def _gcc_state(est):
    return (est.bitrate, est.last_usage.name, est.state.name)


def test_gcc_increases_when_clean():
    def body(P):
        gcc = P.mod("net.rtp.gcc")
        est = gcc.GccEstimator(start_bitrate=1_000_000)
        t, seen = 0, []
        for _ in range(20):
            est.process_feedback(_feedback(P, t, 20, 10 * 10**6, 1200))
            t += 20 * 10 * 10**6
            seen.append(_gcc_state(est))
        assert est.bitrate > 1_000_000
        assert est.last_usage is gcc.Usage.NORMAL
        return seen
    _both(body)


def test_gcc_backs_off_on_growing_delay():
    def body(P):
        gcc = P.mod("net.rtp.gcc")
        est = gcc.GccEstimator(start_bitrate=5_000_000)
        t, k, seen = 0, 0, []
        for _ in range(10):
            est.process_feedback(_feedback(
                P, t, 20, 10 * 10**6, 1200, extra_delay_per_pkt=3 * 10**6,
                base_delay=10**6 + k * 3 * 10**6))
            t += 20 * 10 * 10**6
            k += 20
            seen.append(_gcc_state(est))
        assert est.last_usage is gcc.Usage.OVER
        assert est.bitrate < 5_000_000
        assert est.state is gcc.RateState.DECREASE
        return seen
    _both(body)


def test_gcc_loss_controller():
    def body(P):
        gcc = P.mod("net.rtp.gcc")
        est = gcc.GccEstimator(start_bitrate=2_000_000)
        fb = _feedback(P, 0, 100, 10**7, 1200)
        for i in range(0, 100, 3):
            fb[i] = gcc.PacketFeedback(fb[i].send_time, -1, 1200)
        est.process_feedback(fb)
        assert est.bitrate < 2_000_000
        return _gcc_state(est)
    _both(body)


def test_gcc_element_messages():
    def body(P):
        el = P.make("rtpgccbwe")
        h = P.Harness(el)
        h.set_caps("application/x-rtp")
        h.push(P.Buffer(b"\x80\x60" + bytes(10)))
        assert len(h.buffers) == 1
        el.feed_feedback(_feedback(P, 0, 20, 10**7, 1200,
                                   extra_delay_per_pkt=3 * 10**6))
        msgs = [m for m in h.bus.drain()
                if m.type is P.el.MessageType.ELEMENT]
        assert msgs and "estimated_bitrate" in msgs[0].fields
        out = _bufs(h.pull_all())
        h.teardown()
        return out, [(m.name, _plain(m.fields)) for m in msgs]
    _both(body)


# ---------------------------------------------------------------------------
# ONVIF (tests/test_cccombiner.py), SMPTE 291 (tests/test_st2038.py)
# ---------------------------------------------------------------------------

def test_onvifmetadatacombiner():
    def body(P):
        onvif = P.mod("elements.net.onvif")
        cb = P.make("onvifmetadatacombiner")
        out = _capture(P, cb.static_pad("src"))
        mcaps = ("video/x-raw, format=RGBA, width=4, height=4, "
                 "framerate=30/1")
        mf = _feeder(P)
        mf.link(cb.request_pad("media"))
        _start(P, mf, mcaps)
        xf = _feeder(P)
        xf.link(cb.request_pad("meta"))
        _start(P, xf, "application/x-onvif-metadata, encoding=utf8")
        xf.push(P.Buffer(b"<tt:MetadataStream/>", pts=10_000_000))
        xf.push_event(P.ev.EosEvent())
        vi = P.VideoInfo("RGBA", 4, 4)
        mf.push(vi.make_buffer(np.zeros((4, 4, 4), np.uint8), pts=0))
        mf.push_event(P.ev.EosEvent())
        assert len(out) == 1
        metas = [m for m in out[0].metas
                 if isinstance(m, onvif.OnvifMetadataFrameMeta)]
        assert metas and metas[0].data == b"<tt:MetadataStream/>"
        assert metas[0].pts == 10_000_000
        return _bufs(out)
    _both(body)


def test_onvif_overlay_and_extractor():
    def body(P):
        onvif = P.mod("elements.net.onvif")
        Meta = onvif.OnvifMetadataFrameMeta
        xml = (f'<tt:MetadataStream xmlns:tt="{onvif.ONVIF_SCHEMA}">'
               f'<tt:VideoAnalytics><tt:Frame UtcTime="2026-01-01T00:00:00Z">'
               f'<tt:Object ObjectId="1"><tt:Appearance><tt:Shape>'
               f'<tt:BoundingBox left="-0.5" top="0.5" right="0.5" '
               f'bottom="-0.5"/></tt:Shape></tt:Appearance></tt:Object>'
               f'</tt:Frame></tt:VideoAnalytics></tt:MetadataStream>'
               ).encode()
        caps = "video/x-raw, format=RGBA, width=80, height=60, framerate=30/1"
        vi = P.VideoInfo("RGBA", 80, 60)
        h = P.Harness(P.make("onvifmetadataoverlay"))
        h.set_caps(caps)
        b = vi.make_buffer(np.zeros((60, 80, 4), np.uint8), pts=0)
        b.add_meta(Meta(xml, 0))
        h.push(b)
        drawn = h.pull()
        out = vi.view(drawn)
        assert tuple(out[15, 40, :3]) == (255, 255, 0)
        assert tuple(out[30, 20, :3]) == (255, 255, 0)
        assert tuple(out[30, 40, :3]) == (0, 0, 0)
        h.teardown()
        ex = P.make("onvifmetadataextractor")
        h2 = P.Harness(ex)
        h2.set_caps(caps)
        b2 = vi.make_buffer(np.zeros((60, 80, 4), np.uint8), pts=5)
        b2.add_meta(Meta(xml, 123))
        h2.push(b2)
        got = _capture(P, ex.static_pad("meta"))
        b3 = vi.make_buffer(np.zeros((60, 80, 4), np.uint8), pts=6)
        b3.add_meta(Meta(b"<x/>", 456))
        h2.push(b3)
        assert [g.to_bytes() for g in got] == [b"<x/>"]
        assert got[0].pts == 456
        passed = h2.pull_all()
        assert all(not v.metas for v in passed)
        h2.teardown()
        return _bufs([drawn]), _bufs(got), _bufs(passed)
    _both(body)


def test_rtp_smpte291_roundtrip():
    def body(P):
        st = P.mod("codecs.st2038")
        anc_in = (st.build_anc(0x61, 0x01, bytes(range(20)), line_number=9,
                               horizontal_offset=5) +
                  st.build_anc(0x61, 0x02, b"\x94\x2c", c_not_y=True,
                               line_number=11))
        bufs, pcaps = _harness_pay(P, "rtpsmpte291pay2", "meta/x-st-2038, "
                                   "alignment=frame", [(anc_in, 0)],
                                   **_FIXED)
        assert len(bufs) == 1
        p = P.RtpPacket.parse(bufs[0].to_bytes())
        assert p.marker
        assert p.payload[4] == 2
        assert int.from_bytes(p.payload[2:4], "big") == len(p.payload) - 8
        assert len(p.payload) % 4 == 0
        outs, caps = _harness_depay(
            P, "rtpsmpte291depay2", "application/x-rtp, media=video, "
            "clock-rate=90000, encoding-name=SMPTE291, payload=96", [p])
        assert b"".join(o.to_bytes() for o in outs) == anc_in
        hdrs = [st.parse_anc(o.to_bytes())[0] for o in outs]
        assert [x.sdid for x in hdrs] == [0x01, 0x02]
        assert hdrs[1].c_not_y and hdrs[1].line_number == 11
        return _bufs(bufs), pcaps, _bufs(outs), repr(caps), _plain(hdrs)
    _both(body)
