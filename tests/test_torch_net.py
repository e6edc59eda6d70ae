"""The port's socket elements (UDP, TCP, RTSP), mpegtslivesrc and batched
datagram IO against gstpu's, on the CPU.

Twins of tests/test_tcp_rtsp.py (its canned RTSP servers copied here),
test_mpegtslive.py, the native UDP cases of test_generic_elements.py,
the ts-udpsrc and multicast cases of test_threadshare.py and the live UDP
case of test_live_clock.py. Each twin is the gstpu test's body run once
with gstpu's names and once with the port's: it keeps the test's own
assertions and returns what it saw, and the two packages' observations
must be equal; nothing has a tolerance. Every socket binds port 0 and
reads the port it got. Where gstpu's test waits on wall time the twin
waits for what it needs: datagrams on the loopback are queued by the
sender's `sendto`, so a receiver driven until it has them needs no
deadline but a generous one that only a fault reaches; the live UDP case
runs its receiver under a TestClock stepped one buffer at a time. Then
phase 17's strings of `chip_smoke.py` at 64x48 in both packages, with the
port's `Buffer.array` calls counted by element.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
import gstpu
import gstpu_torch
from test_torch_captions import NAMES, Pkg, _bufs, _plain

SECOND = 10 ** 9
LIMIT = 60.0          # seconds; reached only by a fault

SDP = """v=0
o=- 0 0 IN IP4 127.0.0.1
s=test
m=audio 0 RTP/AVP 96
a=rtpmap:96 L16/8000
a=control:streamid=0
"""


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU in one torch
    thread (test_torch_streams.py says why)."""
    gstpu.init()
    gstpu_torch.init(device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class NPkg(Pkg):
    """Pkg with the RTP packet names."""

    def __init__(self, name: str):
        super().__init__(name)
        self.pk = self.mod("net.rtp.packet")
        self.RtpPacket = self.pk.RtpPacket


def _both(body):
    ref, port = (body(NPkg(name)) for name in NAMES)
    assert port == ref
    return port


def _drive_until(p, cond, limit=LIMIT):
    """Iterate `p` until `cond()` holds."""
    deadline = time.monotonic() + limit
    while not cond():
        if not p.iterate():
            assert time.monotonic() < deadline, "nothing arrived"
            time.sleep(0.001)


def _wait(cond, limit=LIMIT):
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, "the condition never held"
        time.sleep(0.002)


def _seqs(P, bufs):
    return [P.RtpPacket.parse(b.to_bytes()).seqnum for b in bufs]


# ---------------------------------------------------------------------------
# RTSP and TCP (tests/test_tcp_rtsp.py)
# ---------------------------------------------------------------------------

def _answer(method, lines, session, transport):
    extra, body = "", b""
    if method == "DESCRIBE":
        body = SDP.encode()
        extra = ("Content-Type: application/sdp\r\n"
                 f"Content-Length: {len(body)}\r\n")
    elif method == "SETUP":
        extra = f"Session: {session}\r\nTransport: {transport}\r\n"
    elif method in ("PLAY", "PAUSE"):
        extra = f"Session: {session}\r\n"
    return extra, body


def _request(buf, conn):
    """The next request's method, lines and CSeq, and the rest of the
    buffer; None at the end of the connection."""
    while b"\r\n\r\n" not in buf:
        chunk = conn.recv(4096)
        if not chunk:
            return None
        buf += chunk
    req, buf = buf.split(b"\r\n\r\n", 1)
    lines = req.decode().split("\r\n")
    cseq = next(line.split(":")[1].strip() for line in lines
                if line.lower().startswith("cseq"))
    return lines[0].split()[0], lines, cseq, buf


class MiniRtspServer:
    """Canned RTSP server: answers the control protocol, then streams N
    interleaved RTP packets (gstpu's packet codec: the peer, not the code
    under test)."""

    def __init__(self, n_packets=5):
        from gstpu.net.rtp.packet import RtpPacket
        self.RtpPacket = RtpPacket
        self.n_packets = n_packets
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        threading.Thread(target=self._run, daemon=True).start()

    def _packet(self, i, ts=None):
        """RTP packet i (seqnum i, 20 bytes of i), at `ts` or i * 160."""
        return self.RtpPacket(payload_type=96, seqnum=i,
                              timestamp=i * 160 if ts is None else ts,
                              ssrc=0xABCD, payload=bytes([i]) * 20).to_bytes()

    def _run(self):
        conn, _ = self._srv.accept()
        conn.settimeout(10)
        buf, playing = b"", False
        while not playing:
            method, lines, cseq, buf = _request(buf, conn)
            extra, body = _answer(method, lines, "12345678",
                                  "RTP/AVP/TCP;unicast;interleaved=0-1")
            playing = method == "PLAY"
            conn.sendall((f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n"
                          f"{extra}\r\n").encode() + body)
        for i in range(self.n_packets):
            data = self._packet(i)
            conn.sendall(b"$\x00" + len(data).to_bytes(2, "big") + data)
        time.sleep(0.2)
        conn.close()

    def stop(self):
        self._srv.close()


class MiniRtspUdpServer(MiniRtspServer):
    """Variant honoring client_port: streams RTP over UDP after PLAY."""

    def _run(self):
        conn, _ = self._srv.accept()
        conn.settimeout(10)
        buf, playing, client_rtp = b"", False, None
        while not playing:
            method, lines, cseq, buf = _request(buf, conn)
            transport = ""
            if method == "SETUP":
                tline = next(line for line in lines
                             if line.lower().startswith("transport"))
                assert "RTP/AVP;unicast;client_port=" in tline
                ports = tline.split("client_port=")[1].split(";")[0]
                client_rtp = int(ports.split("-")[0])
                transport = (f"RTP/AVP;unicast;client_port={ports};"
                             f"server_port=5000-5001")
            extra, body = _answer(method, lines, "1", transport)
            playing = method == "PLAY"
            conn.sendall((f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n"
                          f"{extra}\r\n").encode() + body)
        out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(self.n_packets):
            out.sendto(self._packet(i), ("127.0.0.1", client_rtp))
        out.close()
        time.sleep(0.2)
        conn.close()


class RtcpSeekRtspServer(MiniRtspServer):
    """Interleaved server that sends an RTCP SR before the RTP, reads back
    a receiver report on channel 1, and honors PAUSE + PLAY with a Range
    header by jumping the sequence numbers."""

    def __init__(self, n_packets=5):
        self.got_rr = threading.Event()
        self.rr_packets = []
        self.got_range = threading.Event()
        self.range_value = None
        super().__init__(n_packets)

    def _serve_control(self, conn, buf):
        playing = False
        while not playing:
            req = _request(buf, conn)
            if req is None:
                return None, buf
            method, lines, cseq, buf = req
            extra, body = _answer(method, lines, "77",
                                  "RTP/AVP/TCP;unicast;interleaved=0-1")
            if method == "PLAY":
                rng = [line for line in lines
                       if line.lower().startswith("range")]
                if rng:
                    self.range_value = rng[0].split(":", 1)[1].strip()
                    self.got_range.set()
                playing = True
            conn.sendall((f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n"
                          f"{extra}\r\n").encode() + body)
        return True, buf

    def _run(self):
        from gstpu.net.rtp.packet import SenderReport, parse_rtcp
        conn, _ = self._srv.accept()
        conn.settimeout(10)
        ok, buf = self._serve_control(conn, b"")
        if not ok:
            return
        sr = SenderReport(0xABCD, (3_900_000_000 << 32), 800, 10,
                          2000).to_bytes()
        conn.sendall(b"$\x01" + len(sr).to_bytes(2, "big") + sr)
        for i in range(self.n_packets):
            data = self._packet(i)
            conn.sendall(b"$\x00" + len(data).to_bytes(2, "big") + data)
        conn.sendall(b"$\x01" + len(sr).to_bytes(2, "big") + sr)
        deadline = time.monotonic() + 8
        while not self.got_rr.is_set() and time.monotonic() < deadline:
            try:
                while len(buf) < 4 or (buf[0:1] == b"$" and len(buf) <
                                       4 + int.from_bytes(buf[2:4], "big")):
                    chunk = conn.recv(4096)
                    if not chunk:
                        return
                    buf += chunk
            except socket.timeout:
                break
            if buf[0:1] == b"$":
                n = int.from_bytes(buf[2:4], "big")
                ch, payload, buf = buf[1], buf[4:4 + n], buf[4 + n:]
                if ch == 1:
                    pkts = parse_rtcp(payload)
                    if any(getattr(x, "reports", None)
                           and x.reports[0].ext_highest_seq >= 4
                           for x in pkts):
                        self.rr_packets = pkts
                        self.got_rr.set()
            else:
                if b"\r\n\r\n" not in buf:
                    continue
                ok, buf = self._serve_control(conn, buf)
                if not ok:
                    return
                for i in range(3):
                    d = self._packet(100 + i, ts=40000 + i * 160)
                    conn.sendall(b"$\x00" + len(d).to_bytes(2, "big") + d)
        time.sleep(0.3)
        conn.close()


class AuthRtspServer(MiniRtspServer):
    """Challenges with Digest, accepts a correct response."""

    REALM, NONCE = "gstpu-test", "abc123nonce"

    def __init__(self):
        self.requests = []
        super().__init__()

    def _run(self):
        import hashlib
        conn, _ = self._srv.accept()
        conn.settimeout(5)
        buf = b""
        authed = False
        while True:
            while b"\r\n\r\n" not in buf:
                chunk = conn.recv(4096)
                if not chunk:
                    return
                buf += chunk
            head, buf = buf.split(b"\r\n\r\n", 1)
            lines = head.decode().split("\r\n")
            method = lines[0].split()[0]
            hdrs = {line.split(":")[0].lower(): line.partition(":")[2].strip()
                    for line in lines[1:] if ":" in line}
            cseq = hdrs.get("cseq", "1")
            self.requests.append((method, hdrs))
            if not authed:
                auth = hdrs.get("authorization", "")
                ok = False
                if auth.startswith("Digest"):
                    fields = {}
                    for part in auth[7:].split(","):
                        k, _, v = part.strip().partition("=")
                        fields[k.lower()] = v.strip('"')
                    ha1 = hashlib.md5(
                        f"user:{self.REALM}:pw".encode()).hexdigest()
                    ha2 = hashlib.md5(f"{method}:{fields.get('uri')}"
                                      .encode()).hexdigest()
                    want = hashlib.md5(f"{ha1}:{self.NONCE}:{ha2}"
                                       .encode()).hexdigest()
                    ok = fields.get("response") == want
                if not ok:
                    conn.sendall(
                        (f"RTSP/1.0 401 Unauthorized\r\nCSeq: {cseq}\r\n"
                         f'WWW-Authenticate: Digest realm="{self.REALM}", '
                         f'nonce="{self.NONCE}"\r\n\r\n').encode())
                    continue
                authed = True
            conn.sendall((f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n"
                          f"Public: OPTIONS, DESCRIBE\r\n\r\n").encode())
            if method == "OPTIONS" and authed:
                return


def test_parse_sdp():
    def body(P):
        media = P.mod("elements.net.rtsp").parse_sdp_media(SDP)
        assert len(media) == 1
        m = media[0]
        assert m["kind"] == "audio" and m["payload"] == 96
        assert m["encoding"] == "L16" and m["clock-rate"] == 8000
        assert m["control"] == "streamid=0"
        return _plain(media)
    _both(body)


def test_rtspsrc2_receives_rtp():
    def body(P):
        srv = MiniRtspServer(n_packets=5)
        p = P.parse_launch(f"rtspsrc2 location=rtsp://127.0.0.1:{srv.port}/s"
                           " ! appsink name=sink")
        sink = p.get_by_name("sink")
        p.set_state(P.State.PLAYING)
        _drive_until(p, lambda: len(sink.samples) >= 5)
        assert len(sink.samples) == 5
        s = sink.caps[0]
        assert s.name == "application/x-rtp"
        assert s["encoding-name"] == "L16" and s["clock-rate"] == 8000
        bufs = sink.pull_all()
        assert _seqs(P, bufs) == [0, 1, 2, 3, 4]
        p.set_state(P.State.NULL)
        srv.stop()
        return repr(sink.caps), [b.to_bytes() for b in bufs]
    _both(body)


def test_rtspsrc2_connection_refused():
    def body(P):
        el = P.make("rtspsrc2", location="rtsp://127.0.0.1:1/s",
                    timeout_s=0.5)
        r = el.set_state(P.State.READY)
        assert r is P.el.StateChangeReturn.FAILURE
        return r.name
    _both(body)


def test_tcp_client_server_roundtrip():
    def body(P):
        sink_el = P.make("tcpserversink")
        sink_el.set_state(P.el.State.READY)
        port = sink_el.bound_port
        assert port > 0
        recv = P.parse_launch(f"tcpclientsrc port={port} ! appsink name=out")
        out = recv.get_by_name("out")
        recv.set_state(P.State.PLAYING)
        # the server accepts the client when the first buffer comes
        h = P.Harness(sink_el)
        h.set_caps("application/x-test")
        total = b""
        for i in range(5):
            data = bytes([i]) * 100
            h.push(P.Buffer(data))
            total += data

        def got():
            return b"".join(b.to_bytes() for b in out.samples)
        _drive_until(recv, lambda: len(got()) >= len(total))
        assert got() == total
        recv.set_state(P.State.NULL)
        h.teardown()
        return got()
    _both(body)


def test_rtspsrc2_udp_transport():
    def body(P):
        srv = MiniRtspUdpServer(n_packets=5)
        p = P.parse_launch(f"rtspsrc2 location=rtsp://127.0.0.1:{srv.port}/s"
                           f" protocols=udp ! appsink name=sink")
        sink = p.get_by_name("sink")
        p.set_state(P.State.PLAYING)
        _drive_until(p, lambda: len(sink.samples) >= 5)
        p.set_state(P.State.NULL)
        srv.stop()
        bufs = list(sink.samples)[:5]
        assert _seqs(P, bufs) == list(range(5))
        assert sink.caps[0]["encoding-name"] == "L16"
        return repr(sink.caps), [b.to_bytes() for b in bufs]
    _both(body)


def test_rtspsrc2_rtcp_sr_and_rr():
    def body(P):
        srv = RtcpSeekRtspServer(n_packets=5)
        p = P.parse_launch(f"rtspsrc2 location=rtsp://127.0.0.1:{srv.port}/s"
                           " name=src ! appsink name=sink")
        sink, src = p.get_by_name("sink"), p.get_by_name("src")
        p.set_state(P.State.PLAYING)
        _drive_until(p, lambda: len(sink.samples) >= 5
                     and srv.got_rr.is_set())
        p.set_state(P.State.NULL)
        srv.stop()
        assert src._session is not None
        mapping = src._session.ntp_rtp_mapping(0xABCD)
        assert mapping is not None
        rr = next(x for x in srv.rr_packets
                  if type(x).__name__ == "ReceiverReport")
        assert rr.reports and rr.reports[0].ssrc == 0xABCD
        assert rr.reports[0].ext_highest_seq >= 4
        # the delay since the SR and the jitter are wall-clock readings
        blk = rr.reports[0]
        return ([b.to_bytes() for b in list(sink.samples)[:5]], mapping,
                (blk.ssrc, blk.ext_highest_seq, blk.cumulative_lost))
    _both(body)


def test_rtspsrc2_seek_sends_range():
    def body(P):
        srv = RtcpSeekRtspServer(n_packets=3)
        p = P.parse_launch(f"rtspsrc2 location=rtsp://127.0.0.1:{srv.port}/s"
                           " name=src ! appsink name=sink")
        sink, src = p.get_by_name("sink"), p.get_by_name("src")
        p.set_state(P.State.PLAYING)
        _drive_until(p, lambda: len(sink.samples) >= 3)
        assert src.seek(5_000_000_000)
        assert srv.got_range.wait(LIMIT)
        assert srv.range_value == "npt=5.000-"
        _drive_until(p, lambda: len(sink.samples) >= 6)
        p.set_state(P.State.NULL)
        srv.stop()
        seqs = _seqs(P, sink.pull_all())
        assert any(q >= 100 for q in seqs)
        return srv.range_value, seqs
    _both(body)


def test_rtsp_digest_authentication():
    def body(P):
        srv = AuthRtspServer()
        c = P.mod("elements.net.rtsp").RtspConnection(
            f"rtsp://user:pw@127.0.0.1:{srv.port}/s")
        status, hdrs, _ = c.request("OPTIONS")
        assert status == 200
        methods = [m for m, h in srv.requests]
        assert methods == ["OPTIONS", "OPTIONS"]
        auth = srv.requests[1][1]["authorization"]
        assert auth.startswith("Digest")
        # the digest covers the URI, which holds the server's port:
        # recompute it as the server checks it
        import hashlib
        uri = f"rtsp://127.0.0.1:{srv.port}/s"
        ha1 = hashlib.md5(b"user:gstpu-test:pw").hexdigest()
        ha2 = hashlib.md5(f"OPTIONS:{uri}".encode()).hexdigest()
        want = hashlib.md5(f"{ha1}:abc123nonce:{ha2}".encode()).hexdigest()
        assert auth == (f'Digest username="user", realm="gstpu-test", '
                        f'nonce="abc123nonce", uri="{uri}", '
                        f'response="{want}"')
        head = auth.split(", response=")[0]
        return status, _plain(hdrs), methods, head.replace(str(srv.port),
                                                           "PORT")
    _both(body)


def test_control_response_does_not_eat_interleaved_media():
    def body(P):
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)

        def run():
            conn, _ = srv.accept()
            data = b""
            while b"\r\n\r\n" not in data:
                data += conn.recv(4096)
            frame = b"$" + bytes([0]) + (5).to_bytes(2, "big") + b"MEDIA"
            conn.sendall(frame + b"RTSP/1.0 200 OK\r\nCSeq: 1\r\n\r\n")
            time.sleep(0.5)
            conn.close()

        threading.Thread(target=run, daemon=True).start()
        c = P.mod("elements.net.rtsp").RtspConnection(
            f"rtsp://127.0.0.1:{srv.getsockname()[1]}/s", timeout=5)
        status, _, _ = c.request("OPTIONS")
        assert status == 200
        got = c.read_data_frame(blocking=False)
        assert got == (0, b"MEDIA")
        srv.close()
        return status, got
    _both(body)


def test_rtspsrc2_port_start_and_latency_query():
    def body(P):
        src = P.make("rtspsrc2", protocols="udp", port_start=40000,
                     latency=350, receive_mtu=2048)
        q = P.mod("core.query").LatencyQuery()
        src.add_latency(q)
        assert q.min_latency == 350 * 1_000_000
        assert src.port_start == 40000 and src.receive_mtu == 2048
        return q.min_latency, q.max_latency, q.live
    _both(body)


def test_rtspsrc2_udp_port_start_respected():
    def body(P):
        srv = MiniRtspUdpServer(n_packets=3)
        p = P.parse_launch(f"rtspsrc2 location=rtsp://127.0.0.1:{srv.port}/s"
                           f" protocols=udp port-start=41000 name=r ! "
                           f"appsink name=sink")
        sink, r = p.get_by_name("sink"), p.get_by_name("r")
        p.set_state(P.State.PLAYING)
        _drive_until(p, lambda: len(sink.samples) >= 3)
        rtp_port = r._rtp_sock.getsockname()[1]
        rtcp_port = r._rtcp_sock.getsockname()[1]
        p.set_state(P.State.NULL)
        srv.stop()
        assert rtp_port >= 41000 and rtp_port % 2 == 0
        assert rtcp_port == rtp_port + 1
        # which free pair it found depends on the other processes
        return [b.to_bytes() for b in list(sink.samples)[:3]]
    _both(body)


# ---------------------------------------------------------------------------
# MPEG-TS and mpegtslivesrc (tests/test_mpegtslive.py)
# ---------------------------------------------------------------------------

def test_pcr_wraparound_tracking():
    def body(P):
        ts = P.mod("codecs.mpegts")
        MpegTsPcr, PCR_MAX, PCR_RATE = ts.MpegTsPcr, ts.PCR_MAX, ts.PCR_RATE
        near_max = MpegTsPcr.new(PCR_MAX - PCR_RATE)
        after = MpegTsPcr.new_with_reference(5 * PCR_RATE, near_max)
        assert after is not None and after.wraparound == 1
        assert after.to_units() == (PCR_MAX + 1) + 5 * PCR_RATE
        back = MpegTsPcr.new_with_reference(PCR_MAX - PCR_RATE, after)
        assert back is not None and back.wraparound == 0
        assert MpegTsPcr.new_with_reference(100 * PCR_RATE, near_max) \
            is None
        return _plain((near_max, after, back))
    _both(body)


def test_packet_roundtrip_with_pcr():
    def body(P):
        ts = P.mod("codecs.mpegts")
        pcr = 1234567 * 300 + 89
        pkt = ts.build_ts_packet(0x1FF, pcr=pcr, payload=b"xy", cc=5)
        hdr, af, payload = ts.parse_ts_packet(pkt)
        assert hdr.pid == 0x1FF and hdr.cc == 5 and not hdr.pusi
        assert af["pcr"] == pcr
        assert payload == b"xy"
        with pytest.raises(ValueError):
            ts.parse_ts_packet(b"\x00" * 188)
        return pkt, _plain(hdr), _plain(af), payload
    _both(body)


def _section(table_id: int, body: bytes) -> bytes:
    length = len(body) + 4
    return (bytes([table_id, 0xB0 | length >> 8, length & 0xFF])
            + body + bytes(4))


def _pat(pmt_pid: int) -> bytes:
    body = bytes([0, 1, 0xC1, 0, 0, 0x00, 0x01,
                  0xE0 | pmt_pid >> 8, pmt_pid & 0xFF])
    return b"\x00" + _section(0x00, body)


def _pmt(pcr_pid: int, es_pid: int) -> bytes:
    body = bytes([0, 1, 0xC1, 0, 0, 0xE0 | pcr_pid >> 8, pcr_pid & 0xFF,
                  0xF0, 0x00, 0x1B, 0xE0 | es_pid >> 8, es_pid & 0xFF,
                  0xF0, 0x00])
    return b"\x00" + _section(0x02, body)


def test_pat_pmt_parse():
    def body(P):
        ts = P.mod("codecs.mpegts")
        pat = ts.parse_pat(ts.section_from_payload(_pat(0x100)))
        assert pat == {1: 0x100}
        pmt = ts.parse_pmt(ts.section_from_payload(_pmt(0x1FF, 0x201)))
        assert pmt.pcr_pid == 0x1FF
        assert pmt.streams == [(0x1B, 0x201)]
        return pat, _plain(pmt)
    _both(body)


def _start_livesrc(P):
    clock = P.mod("core.clock").TestClock()
    el = P.make("mpegtslivesrc", source="appsrc")
    el.clock = clock
    el.base_time = 0
    el.set_state(P.State.PLAYING)
    task = el.iterate_tasks()[0]
    task.prepare()
    task.start()
    from test_torch_captions import _capture
    out = _capture(P, el.static_pad("src"))
    return el, clock, task, out


def _feed(P, el, task):
    def feed(ts_bytes, pts):
        el._child.push_buffer(P.Buffer(ts_bytes, pts=pts))
        for _ in range(4):
            task.run_once()
    return feed


def test_livesrc_slaves_clock_to_pcr():
    def body(P):
        build = P.mod("codecs.mpegts").build_ts_packet
        PCR_RATE = P.mod("codecs.mpegts").PCR_RATE
        el, clock, task, out = _start_livesrc(P)
        feed = _feed(P, el, task)
        feed(build(0, payload=_pat(0x100), pusi=True), 0)
        feed(build(0x100, payload=_pmt(0x1FF, 0x201), pusi=True), 1_000_000)
        assert el._pcr_pid == 0x1FF
        for i in range(20):
            feed(build(0x1FF, pcr=i * 101 * PCR_RATE // 1000),
                 i * SECOND // 10)
        ext = el.external_clock
        assert ext.n_observations >= 20
        assert out[-1].pts == ext.adjust(19 * SECOND // 10)
        d = ext.adjust(3 * SECOND) - ext.adjust(2 * SECOND)
        assert abs(d - SECOND * 101 // 100) < SECOND // 1000
        el.set_state(P.State.NULL)
        return _bufs(out), [int(b.flags) for b in out], d
    _both(body)


def test_livesrc_discont_resets():
    def body(P):
        build = P.mod("codecs.mpegts").build_ts_packet
        PCR_RATE = P.mod("codecs.mpegts").PCR_RATE
        el, clock, task, out = _start_livesrc(P)
        feed = _feed(P, el, task)
        feed(build(0, payload=_pat(0x100), pusi=True), 0)
        feed(build(0x100, payload=_pmt(0x1FF, 0x201), pusi=True), 0)
        feed(build(0x1FF, pcr=0), 0)
        feed(build(0x1FF, pcr=PCR_RATE), SECOND)
        n = el.external_clock.n_observations
        feed(build(0x1FF, pcr=100 * PCR_RATE), 2 * SECOND)
        BufferFlags = P.mod("core.buffer").BufferFlags
        assert el.external_clock.n_observations < n + 1
        assert out[-1].has_flag(BufferFlags.DISCONT)
        el.set_state(P.State.NULL)
        return _bufs(out), [int(b.flags) for b in out], n
    _both(body)


def test_livesrc_requires_source():
    def body(P):
        r = P.make("mpegtslivesrc").set_state(P.State.READY)
        assert r is P.el.StateChangeReturn.FAILURE
        return r.name
    _both(body)


# ---------------------------------------------------------------------------
# batched datagram IO (tests/test_generic_elements.py)
# ---------------------------------------------------------------------------

def test_native_net_batched_udp():
    def body(P):
        nn = P.mod("native_net")
        assert nn.available()
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        rx.setblocking(False)
        port = rx.getsockname()[1]
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        pkts = [(bytes([i]) * (5 + i), ("127.0.0.1", port))
                for i in range(40)]
        assert nn.send_batch(tx, pkts) == 40
        got = []
        while True:
            batch = nn.recv_batch(rx, 64)
            if not batch:
                break
            got.extend(batch)
        assert [g[0] for g in got] == [p[0] for p in pkts]
        rx.close()
        tx.close()
        return [g[0] for g in got]
    _both(body)


def test_native_net_builds_outside_the_checkout():
    """The port builds native/gstpu_net.cpp into build/torch_ext/ and
    writes nothing into native/."""
    from gstpu_torch import native_net
    from gstpu_torch.kernels import BUILD_DIR
    before = sorted(p.name for p in native_net.build_library.__globals__[
        "NATIVE_DIR"].iterdir())
    lib = native_net.load()
    assert lib is not None
    assert str(lib._name).startswith(str(BUILD_DIR))
    after = sorted(p.name for p in native_net.build_library.__globals__[
        "NATIVE_DIR"].iterdir())
    assert after == before


def test_native_net_python_fallback(monkeypatch):
    """Where no library can be built, recv_batch and send_batch take
    gstpu's per-packet socket calls, with the same datagrams."""
    from gstpu_torch import native_net
    monkeypatch.setattr(native_net, "load", lambda: None)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.setblocking(False)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    pkts = [(bytes([i]) * (3 + i), rx.getsockname()) for i in range(10)]
    assert native_net.send_batch(tx, pkts) == 10
    got = native_net.recv_batch(rx, 64)
    assert [g[0] for g in got] == [p[0] for p in pkts]
    assert native_net.recv_batch(rx, 64) == []
    rx.close()
    tx.close()


def test_udpsrc_batch_drain():
    def body(P):
        p = P.parse_launch("udpsrc port=0 name=src ! appsink name=sink")
        src, sink = p.get_by_name("src"), p.get_by_name("sink")
        p.set_state(P.State.PLAYING)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(30):
            tx.sendto(bytes([i]) * 12, ("127.0.0.1", src.bound_port))
        _drive_until(p, lambda: len(sink.samples) >= 30)
        p.set_state(P.State.NULL)
        tx.close()
        assert len(sink.samples) == 30
        assert sink.samples[5].to_bytes() == bytes([5]) * 12
        return [b.to_bytes() for b in sink.samples]
    _both(body)


# ---------------------------------------------------------------------------
# ts-udpsrc and multicast (tests/test_threadshare.py), live UDP
# (tests/test_live_clock.py)
# ---------------------------------------------------------------------------

def test_ts_udpsrc_500_streams_one_thread():
    n_streams, n_packets = 500, 5

    def body(P):
        Context = P.mod("runtime.scheduler").Context
        Context.release("io-soak")
        threads_before = threading.active_count()
        pipes = []
        for _ in range(n_streams):
            p = P.parse_launch("ts-udpsrc address=127.0.0.1 port=0 "
                               "context=io-soak context-wait=10 ! "
                               "appsink name=sink")
            p.set_state(P.State.PLAYING)
            pipes.append(p)
        assert threading.active_count() <= threads_before + 1
        ports = [next(el for el in p.iterate_elements()
                      if getattr(el, "bound_port", 0)).bound_port
                 for p in pipes]
        assert all(ports)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for k in range(n_packets):
            for i, port in enumerate(ports):
                tx.sendto(f"pkt-{i}-{k}".encode(), ("127.0.0.1", port))
        tx.close()
        sinks = [p.get_by_name("sink") for p in pipes]
        _wait(lambda: all(len(s.samples) >= n_packets for s in sinks))
        assert threading.active_count() <= threads_before + 1
        got = [sorted(b.to_bytes() for b in s.pull_all()) for s in sinks]
        for i, g in enumerate(got):
            assert g == sorted(f"pkt-{i}-{k}".encode()
                               for k in range(n_packets))
        for p in pipes:
            p.set_state(P.State.NULL)
        Context.release("io-soak")
        return got
    _both(body)


def test_ts_udpsrc_live_delivery_on_the_context_thread():
    """tests/test_threadshare.py::test_ts_udpsrc_live_latency without its
    100 ms wall-clock bound: a datagram sent to an idle context reaches
    the appsink without anyone driving the pipeline, pushed from the
    context's own thread."""
    def body(P):
        Context = P.mod("runtime.scheduler").Context
        Context.release("io-live")
        p = P.parse_launch("ts-udpsrc address=127.0.0.1 port=0 "
                           "context=io-live ! appsink name=sink")
        sink = p.get_by_name("sink")
        arrived, threads = threading.Event(), []
        chain = sink.sinkpad.chain_function

        def record(pad, buf):
            threads.append(threading.current_thread().name)
            ret = chain(pad, buf)
            arrived.set()
            return ret
        sink.sinkpad.chain_function = record
        p.set_state(P.State.PLAYING)
        src = next(el for el in p.iterate_elements()
                   if hasattr(el, "bound_port"))
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        tx.sendto(b"live", ("127.0.0.1", src.bound_port))
        tx.close()
        assert arrived.wait(LIMIT)
        data = [b.to_bytes() for b in sink.pull_all()]
        assert data == [b"live"]
        p.set_state(P.State.NULL)
        Context.release("io-live")
        assert threads and threads[0].endswith("io-live")
        return data, threads
    _both(body)


def test_udpsrc_multicast_loopback_and_knobs():
    group = "239.255.42.42"

    def body(P):
        src = P.make("udpsrc", uri=f"udp://{group}:0", skip_first_bytes=4)
        assert src.set_state(P.State.READY)
        port = src.bound_port
        assert port > 0 and src.address == group
        src.set_state(P.State.PLAYING)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
        tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        tx.sendto(b"HDR!payload", (group, port))
        got = []
        deadline = time.monotonic() + LIMIT
        while not got:
            try:
                got.append(src.create())
            except P.el.FlowError:
                assert time.monotonic() < deadline
                time.sleep(0.002)
        tx.close()
        src.set_state(P.State.NULL)
        assert got[0].to_bytes() == b"payload"
        return got[0].to_bytes(), src.address
    _both(body)


def test_live_udp_livesync_renders_on_schedule():
    """tests/test_live_clock.py's live udpsrc -> livesync -> sync sink,
    the receiver under a TestClock stepped 50 ms a datagram: each buffer
    renders at its running time, none is late, none repeated."""
    def body(P):
        clock = P.mod("core.clock").TestClock()
        recv = P.parse_launch("udpsrc name=src port=0 "
                              'caps="audio/x-raw, format=S16LE, rate=8000, '
                              'channels=1" ! '
                              "livesync name=ls duration=50000000 ! "
                              "fakesink name=sink")
        recv.use_clock(clock)
        src, ls = recv.get_by_name("src"), recv.get_by_name("ls")
        sink = recv.get_by_name("sink")
        recv.set_state(P.State.PLAYING)
        assert recv.clock is clock
        send = P.parse_launch(
            f"audiotestsrc num-buffers=6 samplesperbuffer=400 "
            f"is-live-p=true ! audio/x-raw, format=S16LE, rate=8000, "
            f"channels=1 ! udpsink host=127.0.0.1 port={src.bound_port}")
        send.set_state(P.State.PLAYING)
        send.run()
        lateness = []
        for _ in range(6):
            clock.advance(50_000_000)
            n = sink.rendered
            _drive_until(recv, lambda: sink.rendered > n)
            lateness.append(sink.last_lateness)
        assert sink.rendered >= 4
        assert sink.last_lateness is not None
        assert sink.last_lateness < 500_000_000
        counts = (sink.rendered, ls.dropped, ls.duplicated)
        send.set_state(P.State.NULL)
        recv.set_state(P.State.NULL)
        assert counts == (6, 0, 0) and lateness == [0] * 6
        return counts, lateness
    _both(body)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 17 at 64x48 and 0.25 s of audio, both packages
# ---------------------------------------------------------------------------

def _as_port(name):
    """A package with the port's entry point: gstpu's init() takes no
    device."""
    if name == "gstpu_torch":
        return gstpu_torch
    import types
    return types.SimpleNamespace(
        __name__="gstpu", init=lambda device=None: gstpu.init(),
        parse_launch=gstpu.parse_launch, State=gstpu.State,
        Buffer=gstpu.Buffer)


@pytest.fixture
def cube(tmp_path):
    path = tmp_path / "g.cube"
    chip_smoke.write_cube(path, np.random.default_rng(17), n=9)
    return path


def _direct(mod, n, cube):
    src, grade = chip_smoke.grade_strings(64, 48, n, cube)
    return chip_smoke.run_string(mod, "cpu", f"{src} ! {grade} ! appsink "
                                 f"name=out", ("out",))[2]["out"]


def test_phase17_telephony():
    """17a at 0.25 s: the same A-law bytes and the same datagrams (seeded
    drops included) in both packages; in the port every dropped source
    packet comes back out of raptorqdec, the payloads into the
    depayloader are what alawenc wrote, and the native recvmmsg path
    received every datagram. gstpu's raptorqdec holds back the blocks
    after one it reopens (the port's departure); here the block it
    reopens is the last, so its samples are the port's."""
    seen = {name: chip_smoke.telephony_rtp(_as_port(name), "cpu", 0.25)
            for name in NAMES}
    ref, port = seen["gstpu"], seen["gstpu_torch"]
    assert port["alaw"] == ref["alaw"] and port["sent"] == ref["sent"]
    assert port["counts"] == ref["counts"] and port["counts"]["dropped"]
    assert port["recovered"] == port["sent"]
    assert port["stats"] == {"recovered": port["counts"]["dropped"],
                             "unrecovered": 0}
    assert port["payloads"] == port["alaw"]
    assert len(port["samples"]) == 2 * 2000
    assert port["samples"] == ref["samples"]
    assert port["native"] == {"built": True, "calls": port["native"]["calls"],
                              "datagrams": port["counts"]["sent"]}
    alawdec = gstpu_torch.native.alaw_decode
    assert port["samples"] == alawdec(np.frombuffer(
        port["alaw"], np.uint8)).astype("<i2").tobytes()


def test_phase17_raw_video(cube):
    """17b at 64x48: in both packages the frames received over UDP are the
    direct string's, with no packet lost; the port's payloader reads each
    frame once and no other new element reads one."""
    seen = {}
    for name in NAMES:
        mod = _as_port(name)
        want = [b.to_bytes() for b in _direct(mod, chip_smoke.RTP_FRAMES,
                                              cube)]
        with chip_smoke.ArrayCalls() as calls:
            res = chip_smoke.vraw_rtp(mod, "cpu", 64, 48,
                                      chip_smoke.RTP_FRAMES, cube)
        assert res["frames"] == want
        assert res["lost"] == 0 and res["in_order"]
        assert res["native"]["datagrams"] == res["counts"]["sent"]
        seen[name] = res["frames"], res["seqnums"], calls
    assert seen["gstpu"][:2] == seen["gstpu_torch"][:2]
    calls = seen["gstpu_torch"][2]
    assert chip_smoke.new_reads(calls, ("pay", "udp", "src", "depay",
                                        "out")) == {"pay": 4}
    assert calls.tensor_calls == {"pay": 4}


def test_phase17_onvif(cube):
    """17c at 64x48: both packages give the same frames and metas, fed the
    grade and fed its frames as host arrays; the port's overlay reads the
    two boxed frames only and hands the others on as the tensors that
    went in."""
    n = chip_smoke.ONVIF_FRAMES
    docs = chip_smoke.onvif_docs(np.random.default_rng(17))
    seen = {}
    for name in NAMES:
        mod = _as_port(name)
        frames = _direct(mod, n, cube)
        host = chip_smoke.onvif_grade(mod, "cpu", 64, 48, n, cube, docs,
                                      frames)
        with chip_smoke.ArrayCalls() as calls:
            res = chip_smoke.onvif_grade(mod, "cpu", 64, 48, n, cube, docs)
        got = [chip_smoke.buffer_record(b) for b in res["out"]]
        assert got == [chip_smoke.buffer_record(b) for b in host["out"]]
        assert [len(b.metas) for b in res["out"]] == \
            [int(k in chip_smoke.ONVIF_BOXES) for k in range(n)]
        seen[name] = got, res, calls
    assert seen["gstpu"][0] == seen["gstpu_torch"][0]
    _, res, calls = seen["gstpu_torch"]
    boxed = chip_smoke.ONVIF_BOXES
    assert chip_smoke.new_reads(calls, ("msrc", "opay", "odepay", "parse",
                                        "comb", "ov", "out")) \
        == {"ov": len(boxed)}
    assert [calls.of("ov", res["out"][k].pts) for k in boxed] == [1, 1]
    for k, (b, f) in enumerate(zip(res["out"], res["in"])):
        assert (b.data is f.data) == (k not in boxed)
        assert isinstance(b.data, torch.Tensor) == (k not in boxed)


def test_phase17_tcp(cube):
    """17d at 64x48: the bytes tcpclientsrc reads are the direct string's
    frames in both packages; the port's tcpserversink reads each frame
    once."""
    seen = {}
    for name in NAMES:
        mod = _as_port(name)
        want = b"".join(b.to_bytes() for b in _direct(
            mod, chip_smoke.RTP_FRAMES, cube))
        with chip_smoke.ArrayCalls() as calls:
            got = chip_smoke.tcp_grade(mod, "cpu", 64, 48,
                                       chip_smoke.RTP_FRAMES, cube)["bytes"]
        assert got == want
        seen[name] = got, calls
    assert seen["gstpu"][0] == seen["gstpu_torch"][0]
    assert chip_smoke.new_reads(seen["gstpu_torch"][1],
                                ("tcp", "src", "out")) == {"tcp": 4}
