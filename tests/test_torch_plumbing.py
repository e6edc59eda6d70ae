"""The port's plumbing, compression, sodium, blocking adapter and alias
modules against gstpu's, on the CPU.

Twins of the plumbing and compression cases of tests/test_generic_
elements.py, the sodium half of test_sodium_gcc.py, test_aliases.py (the
names the port registers; its RoQ and HTTP cases wait for their
elements), and test_threadshare.py's reactor, context-timer and blocking-
adapter cases. Each twin is the gstpu test's body run once with gstpu's
names and once with the port's (`test_torch_captions.Pkg`): it keeps the
test's assertions and returns what it saw, and the two packages'
observations must be equal. This is host code in both packages, so
nothing here has a tolerance. The blocking adapter's twin holds it to its
contract with events instead of gstpu's 15 ms wall-clock bound. Then the
strings of `chip_smoke.py`'s phases 16a and 16c at 64x48 in both
packages, with the port's `Buffer.array` calls counted by element.
"""

import ctypes
import socket
import threading
import types

import numpy as np
import pytest
import torch

import chip_smoke
import gstpu
import gstpu_torch
from test_torch_captions import NAMES, Pkg, _both, _bufs, _plain
from torch_session import torch_test_limit  # noqa: F401

SECOND = 10 ** 9


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU."""
    gstpu.init()
    gstpu_torch.init(device="cpu")


def _pad(P, direction):
    tmpl = P.el.PadTemplate("src" if direction == "src" else "sink",
                            getattr(P.el.PadDirection, direction.upper()),
                            P.el.PadPresence.ALWAYS, P.Caps.any())
    return P.el.Pad("f" if direction == "src" else "cap", tmpl.direction,
                    tmpl)


def _capture_into(P, srcpad, out):
    sink = _pad(P, "sink")
    sink.chain_function = lambda p, b: (out.append(b), P.FlowReturn.OK)[1]
    sink.event_function = lambda p, e: True
    srcpad.link(sink)


def _run(P, launch, sink="sink"):
    p = P.parse_launch(launch)
    out = p.get_by_name(sink)
    p.set_state(P.State.PLAYING)
    p.run()
    bufs = out.pull_all()
    res = repr(out.caps), _bufs(bufs)
    p.set_state(P.State.NULL)
    return res, bufs


def _seeded(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


# ---------------------------------------------------------------------------
# compress and plumbing (tests/test_generic_elements.py)
# ---------------------------------------------------------------------------

def test_flate_roundtrip_pipeline():
    def body(P):
        (caps, bufs), raw = _run(P, "audiotestsrc num-buffers=10 ! audio/x-raw,"
                                    " format=S16LE, rate=8000, channels=1 ! "
                                    "flatecompress ! flatedecompress ! "
                                    "appsink name=sink")
        assert caps.startswith("audio/x-raw") and "8000" in caps
        assert sum(b.size for b in raw) == 10 * 1024 * 2
        return caps, bufs
    _both(body)


def test_flate_compressed_caps_carry_original():
    def body(P):
        p = P.parse_launch("audiotestsrc num-buffers=2 ! audio/x-raw, "
                           "format=S16LE, rate=8000, channels=1 ! "
                           "flatecompress ! appsink name=sink")
        sink = p.get_by_name("sink")
        p.set_state(P.State.PLAYING)
        p.run()
        s = sink.caps[0]
        assert s.name in ("application/x-zlib-compressed",
                          "application/x-deflate-compressed")
        oc = s["original-caps"]
        assert isinstance(oc, P.Caps) and oc[0].name == "audio/x-raw"
        import zlib
        raw = b"".join(b.to_bytes() for b in sink.pull_all())
        out = zlib.decompressobj().decompress(raw)
        assert len(out) > 0
        p.set_state(P.State.NULL)
        return s.name, repr(oc), raw, out
    _both(body)


def test_originalbuffer_save_restore():
    def body(P):
        p = P.parse_launch("appsrc name=src ! originalbuffersave ! identity "
                           "! originalbufferrestore ! appsink name=sink")
        src, sink = p.get_by_name("src"), p.get_by_name("sink")
        src.set_property("caps", P.Caps.new("application/x-test"))
        p.set_state(P.State.PLAYING)
        original = np.arange(100, dtype=np.uint8)
        src.push_buffer(P.Buffer(original.copy(), pts=123))
        src.end_of_stream()
        p.run()
        out = sink.pull_all()[0]
        np.testing.assert_array_equal(out.array, original)
        assert out.pts == 123
        p.set_state(P.State.NULL)
        return out.to_bytes(), out.pts
    _both(body)


def test_gopbuffer_delays_and_flushes():
    def body(P):
        h = P.Harness(P.make("gopbuffer", minimum_duration=SECOND))
        h.set_caps("video/x-h264-ish")
        held = []
        for i in range(12):
            b = P.Buffer(bytes([i]), pts=i * SECOND // 2)
            if i % 4 != 0:
                b.set_flag(P.mod("core.buffer").BufferFlags.DELTA_UNIT)
            h.push(b)
            held.append(len(h.buffers))
        assert held[-1] < 12
        h.push_eos()
        assert len(h.buffers) == 12
        outs = h.pull_all()
        assert [b.to_bytes()[0] for b in outs] == list(range(12))
        h.teardown()
        return held, _bufs(outs), [int(b.flags) for b in outs]
    _both(body)


def test_inter_pipeline_bridge():
    def body(P):
        p1 = P.parse_launch("audiotestsrc num-buffers=5 ! audio/x-raw, "
                            "format=F32LE, rate=8000, channels=1 ! "
                            "intersink producer-name=t1")
        p2 = P.parse_launch("intersrc producer-name=t1 ! appsink name=sink")
        sink = p2.get_by_name("sink")
        p2.set_state(P.State.PLAYING)
        p1.set_state(P.State.PLAYING)
        p1.run()
        p2.run(timeout=5)
        bufs = sink.pull_all()
        assert len(bufs) == 5
        assert sink.caps[0].name == "audio/x-raw"
        p1.set_state(P.State.NULL)
        p2.set_state(P.State.NULL)
        return repr(sink.caps), _bufs(bufs)
    _both(body)


def test_streamgrouper_rewrites_group():
    def body(P):
        h = P.Harness("streamgrouper")
        h.set_caps("application/x-test")
        evs = [e for e in h.events if isinstance(e, P.ev.StreamStartEvent)]
        assert evs and evs[0].group_id == 1
        h.teardown()
        return [(e.stream_id, e.group_id) for e in evs]
    _both(body)


# ---------------------------------------------------------------------------
# brotli (RFC 7932 stored mode and the libbrotli backend)
# ---------------------------------------------------------------------------

def _brotli_ctypes(P):
    lib = P.mod("codecs.brotli_ctypes")
    if not lib.available():
        pytest.skip("libbrotli not on this machine")
    return lib


def test_brotli_known_empty_streams():
    def body(P):
        dec = P.mod("codecs.brotli_rfc7932").decompress
        assert dec(b"\x3b") == b"" and dec(b"\x06") == b""
        return dec(b"\x3b"), dec(b"\x06")
    _both(body)


def test_brotli_stored_roundtrip():
    """gstpu's test draws 70,000 random bytes; the twin seeds them."""
    def body(P):
        m = P.mod("codecs.brotli_rfc7932")
        encs = []
        for payload in (b"", b"x", b"hello brotli" * 100,
                        _seeded(70_000, 1)):
            enc = m.compress_stored(payload)
            assert m.decompress(enc) == payload
            encs.append(enc)
        return encs
    _both(body)


def test_brotli_rejects_prefix_coded_blocks():
    def body(P):
        m = P.mod("codecs.brotli_rfc7932")
        w = m._BitWriter()
        w.write(0, 1), w.write(1, 1), w.write(0, 1)
        w.write(0, 2), w.write(0, 16), w.write(0, 8)
        with pytest.raises(m.BrotliError, match="dictionary") as e:
            m.decompress(w.bytes_out())
        return w.bytes_out(), str(e.value)
    _both(body)


def test_brotli_elements_pipeline_roundtrip():
    def body(P):
        p = P.parse_launch("appsrc name=in caps=application/x-test ! "
                           "brotlicompress ! brotlidecompress ! "
                           "appsink name=out")
        src, out = p.get_by_name("in"), p.get_by_name("out")
        p.set_state(P.State.PLAYING)
        payloads = [b"one", b"two" * 500, b"\x00" * 4096]
        for d in payloads:
            src.push_buffer(P.Buffer(d))
        src.end_of_stream()
        p.run()
        assert [b.to_bytes() for b in out.samples] == payloads
        p.set_state(P.State.NULL)
        return _bufs(out.samples)
    _both(body)


def test_brotli_ctypes_backend_roundtrip():
    """gstpu's test draws 70,000 random bytes; the twin seeds them."""
    def body(P):
        lib = _brotli_ctypes(P)
        encs = []
        for payload in (b"", b"x", b"hello brotli " * 400,
                        _seeded(70_000, 2)):
            enc = lib.compress(payload, quality=9)
            assert lib.decompress(enc) == payload
            encs.append(enc)
        big = b"the quick brown fox " * 2000
        assert len(lib.compress(big)) < len(big) // 10
        return encs, lib.compress(big)
    _both(body)


def test_brotli_stored_mode_accepted_by_libbrotli():
    def body(P):
        lib = _brotli_ctypes(P)
        stored = P.mod("codecs.brotli_rfc7932").compress_stored
        outs = []
        for payload in (b"", b"y", b"stored" * 333, _seeded(66_000, 3)):
            outs.append(lib.decompress(stored(payload)))
            assert outs[-1] == payload
        return outs
    _both(body)


def test_brotli_elements_use_entropy_backend():
    def body(P):
        lib = _brotli_ctypes(P)
        p = P.parse_launch("appsrc name=in caps=application/x-test ! "
                           "brotlicompress quality=9 ! appsink name=mid")
        src, mid = p.get_by_name("in"), p.get_by_name("mid")
        p.set_state(P.State.PLAYING)
        payload = b"abcdefgh" * 8192
        src.push_buffer(P.Buffer(payload))
        src.end_of_stream()
        p.run()
        wire = [b.to_bytes() for b in mid.samples]
        assert sum(len(w) for w in wire) < len(payload) // 20
        p.set_state(P.State.NULL)
        assert b"".join(lib.decompress(w) for w in wire) == payload
        return wire
    _both(body)


# ---------------------------------------------------------------------------
# gopbuffer and the inter bridge's bounds (round-5 property parity)
# ---------------------------------------------------------------------------

def test_gopbuffer_max_size_time_discards_oldest():
    def body(P):
        flags = P.mod("core.buffer").BufferFlags
        gb = P.make("gopbuffer", minimum_duration=10 * SECOND,
                    max_size_time=2 * SECOND)
        out = []
        _capture_into(P, gb.static_pad("src"), out)
        feed = _pad(P, "src")
        feed.link(gb.static_pad("sink"))
        gb.set_state(P.State.PLAYING)
        for i in range(6):
            feed.push(P.Buffer(bytes([i]), pts=i * SECOND))
            d = P.Buffer(bytes([i, i]), pts=i * SECOND + SECOND // 2)
            d.set_flag(flags.DELTA_UNIT)
            feed.push(d)
        feed.push_event(P.ev.EosEvent())
        starts = [b.pts // SECOND for b in out
                  if not b.has_flag(flags.DELTA_UNIT)]
        assert starts and len(starts) <= 3 and starts[-1] == 5
        assert 0 not in starts and 1 not in starts
        return _bufs(out), [int(b.flags) for b in out]
    _both(body)


def test_intersrc_queue_bounds_drop_oldest():
    def body(P):
        sink = P.make("intersink", producer_name="bnd")
        src = P.make("intersrc", producer_name="bnd", max_buffers=3)
        src.set_state(P.State.PLAYING)
        sink.set_state(P.State.PLAYING)
        for i in range(10):
            sink.render(P.Buffer(bytes([i]), pts=i * SECOND))
        assert len(src._q) == 3
        got = [(b.to_bytes(), b.pts) for b, _ in src._q]
        assert [x for x, _ in got] == [b"\x07", b"\x08", b"\x09"]
        src.set_state(P.State.NULL)
        sink.set_state(P.State.NULL)
        return got
    _both(body)


def test_intersink_event_types_forwarding():
    def body(P):
        sink = P.make("intersink", producer_name="evt",
                      event_types="eos,custom-downstream")
        src = P.make("intersrc", producer_name="evt")
        src.set_state(P.State.PLAYING)
        sink.set_state(P.State.PLAYING)
        ev = P.ev.CustomEvent({"name": "marker", "x": 1})
        sink._event(sink.sinkpad, ev)
        assert list(src._pending_events) == [ev]
        src.set_state(P.State.NULL)
        sink.set_state(P.State.NULL)
        # not the seqnum: a per-process counter of events
        return [(type(e).__name__, e.name, e.serialized, e.fields)
                for e in src._pending_events]
    _both(body)


def test_intersrc_takes_the_last_buffer_before_eos():
    """The port's `intersrc` reads its EOS flag before its queue: a buffer
    queued by the producer's thread between the two reads still goes out
    (gstpu's reads the queue first, and then its EOS flag ends the stream
    with that buffer left queued)."""
    P = Pkg("gstpu_torch")
    src = P.make("intersrc", producer_name="race")
    src.set_state(P.State.PLAYING)

    class Queue(list):
        def __bool__(self):
            # the producer's thread runs between the consumer's reads
            if len(self) == 0 and not src._eos:
                self.append((P.Buffer(b"last", pts=0), None))
                src._eos = True
                return False
            return len(self) > 0

        def popleft(self):
            return self.pop(0)

    src._q = Queue()
    with pytest.raises(P.el.FlowError):
        src.create()
    assert src.create().to_bytes() == b"last"
    assert src.create() is None
    src.set_state(P.State.NULL)


# ---------------------------------------------------------------------------
# sodium (the sodium half of tests/test_sodium_gcc.py)
# ---------------------------------------------------------------------------

def _keys(P, *who):
    """Fixed Curve25519 pairs (public, secret) in place of gstpu's random
    ones, so that both packages seal alike."""
    if not P.mod("elements.generic.sodium").sodium_available():
        pytest.skip("libsodium not on this machine")
    return chip_smoke.sodium_keys(_as_port(P.name), *who)


def _sealed(P, rpk, ssk, payload, block_size):
    h = P.Harness(P.make("sodiumencrypter", receiver_key=rpk, sender_key=ssk,
                         nonce=bytes(24), block_size=block_size))
    h.set_caps("application/x-test")
    h.push(P.Buffer(payload))
    h.push_eos()
    ct = b"".join(b.to_bytes() for b in h.pull_all())
    h.teardown()
    return ct


def test_sodium_roundtrip_pipeline():
    def body(P):
        (rpk, rsk), (spk, ssk) = _keys(P, "r", "s")
        p = P.parse_launch("appsrc name=src ! sodiumencrypter name=enc ! "
                           "sodiumdecrypter name=dec ! appsink name=sink")
        enc, dec = p.get_by_name("enc"), p.get_by_name("dec")
        enc.receiver_key, enc.sender_key = rpk, ssk
        enc.block_size = 64
        dec.receiver_key, dec.sender_key = rsk, spk
        src, sink = p.get_by_name("src"), p.get_by_name("sink")
        src.caps = P.parse_caps("application/x-test")
        p.set_state(P.State.PLAYING)
        payload = bytes(range(256)) * 3
        src.push_buffer(P.Buffer(payload))
        src.end_of_stream()
        p.run()
        outs = sink.pull_all()
        assert b"".join(b.to_bytes() for b in outs) == payload
        assert sink.is_eos
        p.set_state(P.State.NULL)
        return _bufs(outs)
    _both(body)


def test_sodium_wire_format_matches_reference():
    def body(P):
        (rpk, rsk), (spk, ssk) = _keys(P, "r", "s")
        sodium = P.mod("elements.generic.sodium")
        nonce0 = bytes(range(24))
        h = P.Harness(P.make("sodiumencrypter", receiver_key=rpk,
                             sender_key=ssk, nonce=nonce0, block_size=8))
        h.set_caps("application/x-test")
        h.push(P.Buffer(b"0123456789abcdef"))
        h.push_eos()
        data = b"".join(b.to_bytes() for b in h.pull_all())
        h.teardown()
        assert data[:12] == b"gst-sodium10" and data[12:36] == nonce0
        assert data[36:40] == (8).to_bytes(4, "little")
        blocks = data[40:]
        assert len(blocks) == 2 * (8 + sodium.MAC_BYTES)

        def open_direct(sealed, nonce):
            out = ctypes.create_string_buffer(len(sealed) - sodium.MAC_BYTES)
            assert sodium._SODIUM.crypto_box_open_easy(
                out, sealed, ctypes.c_ulonglong(len(sealed)), nonce,
                spk, rsk) == 0
            return out.raw
        n1 = bytearray(nonce0)
        n1[0] += 1
        assert open_direct(blocks[:24], nonce0) == b"01234567"
        assert open_direct(blocks[24:], bytes(n1)) == b"89abcdef"
        return data
    _both(body)


def test_sodium_wrong_key_fails():
    def body(P):
        (rpk, rsk), (spk, ssk), (wpk, wsk) = _keys(P, "r", "s", "w")
        ct = _sealed(P, rpk, ssk, bytes(32), 16)
        h = P.Harness(P.make("sodiumdecrypter", receiver_key=wsk,
                             sender_key=spk))
        h.set_caps("application/x-sodium-encrypted-stream")
        ret = h.push(P.Buffer(ct))
        assert ret == P.FlowReturn.ERROR and not h.buffers
        h.teardown()
        return ct, ret.name
    _both(body)


def test_sodium_tamper_detected():
    def body(P):
        (rpk, rsk), (spk, ssk) = _keys(P, "r", "s")
        ct = bytearray(_sealed(P, rpk, ssk, bytes(32), 16))
        ct[45] ^= 0xFF
        h = P.Harness(P.make("sodiumdecrypter", receiver_key=rsk,
                             sender_key=spk))
        h.set_caps("application/x-sodium-encrypted-stream")
        ret = h.push(P.Buffer(bytes(ct)))
        assert ret == P.FlowReturn.ERROR and not h.buffers
        h.teardown()
        return bytes(ct), ret.name
    _both(body)


def test_sodium_pull_mode_random_access(tmp_path):
    def body(P):
        (rpk, rsk), (spk, ssk) = _keys(P, "r", "s")
        payload = bytes((i * 7 + 3) & 0xFF for i in range(10_000))
        enc_file = tmp_path / f"{P.name}.bin"
        p = P.parse_launch("appsrc name=src ! sodiumencrypter name=enc ! "
                           f"filesink location={enc_file}")
        enc = p.get_by_name("enc")
        enc.receiver_key, enc.sender_key = rpk, ssk
        enc.block_size, enc.nonce = 512, bytes(24)
        src = p.get_by_name("src")
        src.caps = P.parse_caps("application/x-test")
        p.set_state(P.State.PLAYING)
        src.push_buffer(P.Buffer(payload))
        src.end_of_stream()
        p.run()
        p.set_state(P.State.NULL)
        fsrc = P.make("filesrc")
        fsrc.location = str(enc_file)
        dec = P.make("sodiumdecrypter")
        dec.receiver_key, dec.sender_key = rsk, spk
        fsrc.pads["src"].link(dec.pads["sink"])
        fsrc.set_state(P.State.READY)
        dec.set_state(P.State.PAUSED)
        assert dec.plaintext_size() == len(payload)
        got = []
        for off, size in ((0, 16), (500, 40), (511, 2), (512, 512),
                          (1000, 3000), (9990, 10), (9990, 100), (4096, 1)):
            got.append(dec.pull_range(off, size))
            assert got[-1] == payload[off:off + size], (off, size)
        probe = dec.pads["src"].get_range_function
        assert probe(dec.pads["src"], 100, 50) == payload[100:150]
        raw = bytearray(enc_file.read_bytes())
        raw[60] ^= 0xFF
        enc_file.write_bytes(bytes(raw))
        fsrc.set_state(P.State.NULL)
        fsrc.set_state(P.State.READY)
        with pytest.raises(Exception) as e:
            dec.pull_range(0, 16)
        return enc_file.read_bytes(), got, type(e.value).__name__
    _both(body)


# ---------------------------------------------------------------------------
# reference names and the fill-in elements (tests/test_aliases.py)
# ---------------------------------------------------------------------------

ALIASES = ("rsidentity", "rsfilesrc", "rsfilesink", "imagersdec",
           "imagersoverlay", "deflatecompress", "deflatedecompress",
           "zlibcompress", "zlibdecompress", "ts-queue", "ts-appsrc",
           "ts-audiotestsrc", "ts-intersink", "ts-intersrc", "ts-proxysink",
           "ts-proxysrc", "agingradio", "udpsrc2", "rtponvifmetadatapay",
           "rtponvifmetadatadepay", "ts-udpsrc", "ts-udpsink",
           "ts-tcpclientsrc", "rtpav1pay", "rtpav1depay", "rtpsmpte291pay",
           "rtpsmpte291depay")


def test_reference_names_resolve():
    """gstpu's names, restricted to those whose targets the port
    registers: each resolves to a subclass of the same target under the
    same rank."""
    def body(P):
        reg = P.mod("core.registry")
        fs = set(reg.list_factories())
        for name in ALIASES + ("rssinesrc", "rsrgb2gray", "rsprogressbin",
                               "ts-clocksync", "ts-input-selector",
                               "ts-rtpdtmfsrc"):
            assert name in fs, name
        return [(n, reg.element_factory(n).__mro__[1].ELEMENT_NAME,
                 reg.element_rank(n).name) for n in ALIASES]
    _both(body)


def test_rssinesrc_pipeline():
    def body(P):
        info_cls = P.mod("core.audio").AudioInfo
        p = P.parse_launch("rssinesrc num-buffers=4 freq=1000 volume=0.5 ! "
                           "appsink name=out")
        out = p.get_by_name("out")
        p.set_state(P.State.PLAYING)
        p.run()
        info = info_cls.from_caps(out.caps)
        assert info.rate == 48000 and info.format == "F32LE"
        bufs = out.pull_all()
        samples = np.concatenate([info.view(b)[:, 0] for b in bufs])
        assert len(samples) == 4096 and abs(samples.max() - 0.5) < 0.01
        spec = np.abs(np.fft.rfft(samples))
        assert abs(np.argmax(spec) * 48000 / len(samples) - 1000) < 24
        return repr(out.caps), _bufs(bufs)
    _both(body)


def test_rsrgb2gray():
    def body(P):
        (caps, bufs), raw = _run(P, "videotestsrc num-buffers=1 pattern=white"
                                    " ! video/x-raw, format=RGB, width=8, "
                                    "height=8, framerate=30/1 ! rsrgb2gray "
                                    "invert=true ! appsink name=out", "out")
        assert "GRAY8" in caps and (raw[0].array == 0).all()
        return caps, bufs
    _both(body)


def test_input_selector_switch():
    def body(P):
        sel = P.make("ts-input-selector")
        out = []
        _capture_into(P, sel.static_pad("src"), out)
        feeders = []
        for _ in range(2):
            f = _pad(P, "src")
            f.link(sel.request_pad())
            f.push_event(P.ev.StreamStartEvent("s"))
            f.push_event(P.ev.CapsEvent(P.parse_caps("x/y")))
            f.push_event(P.ev.SegmentEvent(P.ev.Segment()))
            feeders.append(f)
        feeders[0].push(P.Buffer(b"a0"))
        feeders[1].push(P.Buffer(b"b0"))
        sel.set_active("sink_1")
        feeders[0].push(P.Buffer(b"a1"))
        feeders[1].push(P.Buffer(b"b1"))
        assert [b.to_bytes() for b in out] == [b"a0", b"b1"]
        return _bufs(out)
    _both(body)


def test_progressbin_messages():
    def body(P):
        p = P.parse_launch("audiotestsrc num-buffers=30 samplesperbuffer=4800"
                           " ! rsprogressbin ! fakesink")
        p.set_state(P.State.PLAYING)
        p.run()
        msgs = [_plain(m.fields) for m in p.bus.drain()
                if m.type.name == "ELEMENT"
                and m.fields.get("name") == "progress"]
        assert len(msgs) >= 2
        p.set_state(P.State.NULL)
        return msgs
    _both(body)


def test_rtpdtmfsrc_events():
    def body(P):
        RtpPacket = P.mod("net.rtp.packet").RtpPacket
        (caps, bufs), raw = _run(P, "ts-rtpdtmfsrc tones=1# tone_duration_ms=80"
                                    " packet_ms=40 ! appsink name=out", "out")
        pkts = [RtpPacket.parse(b.to_bytes()) for b in raw]
        assert len(pkts) == 4
        assert pkts[0].marker and not pkts[1].marker
        assert pkts[0].payload[0] == 1 and pkts[2].payload[0] == 11
        assert pkts[1].payload[1] & 0x80
        assert [q.seqnum for q in pkts] == [0, 1, 2, 3]
        return caps, bufs
    _both(body)


# ---------------------------------------------------------------------------
# the threadshare runtime (tests/test_threadshare.py)
# ---------------------------------------------------------------------------

def test_reactor_io_wakeup():
    def body(P):
        r = P.mod("runtime.reactor").Reactor()
        a, b = socket.socketpair()
        a.setblocking(False)
        got, woke = [], threading.Event()

        def on_read():
            got.append(a.recv(100))
            woke.set()
        r.register_read(a, on_read)
        idle = r.poll(0.01)
        assert idle is False
        b.send(b"ping")
        for _ in range(300):
            if r.poll(0.05) or got:
                break
        assert got == [b"ping"]
        r.unregister(a)
        a.close(), b.close(), r.close()
        return idle, got
    _both(body)


def test_context_timer_api():
    def body(P):
        sched = P.mod("runtime.scheduler")
        sched.Context.release("io-timer")
        ctx = sched.Context.acquire("io-timer", threaded=True)
        fired = threading.Event()
        ctx.add_timer(0.02, fired.set)
        ctx.add_task(sched.Task("idle", lambda: sched.TaskResult.IDLE))
        ok = fired.wait(5.0)
        assert ok
        sched.Context.release("io-timer")
        return ok
    _both(body)


def test_blocking_adapter_decouples_blocking_sink():
    """gstpu's test lets downstream sleep 20 ms and asserts the first push
    returns within 15 ms. The twin blocks downstream on an event: the
    first push returns, within a generous 2 s, while the adapter's thread
    is still held downstream; released, every buffer arrives in order."""
    def body(P):
        h = P.Harness(P.make("ts-blocking-adapter"))
        entered, release = threading.Event(), threading.Event()
        done, all_done = [], threading.Event()
        orig = h.sinkpad.chain_function

        def blocking_chain(pad, buf):
            entered.set()
            assert release.wait(30)
            done.append(buf.to_bytes())
            if len(done) == 5:
                all_done.set()
            return orig(pad, buf)
        h.sinkpad.chain_function = blocking_chain
        h.set_caps("application/x-test")
        rets = []
        first = threading.Thread(target=lambda: rets.append(
            h.push(P.Buffer(b"a"))))
        first.start()
        first.join(2.0)
        returned = not first.is_alive()
        assert returned and not release.is_set()
        assert entered.wait(2.0)          # downstream holds the adapter
        release.set()
        for i in range(4):
            rets.append(h.push(P.Buffer(bytes([i]))))
        assert all_done.wait(30)
        assert done == [b"a", b"\x00", b"\x01", b"\x02", b"\x03"]
        h.push_event(P.ev.EosEvent())
        h.teardown()
        return returned, [r.name for r in rets], done
    _both(body)


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 16a and 16c at 64x48, both packages
# ---------------------------------------------------------------------------

def _as_port(name):
    """A package with the port's entry point: gstpu's init() takes no
    device."""
    if name == "gstpu_torch":
        return gstpu_torch
    return types.SimpleNamespace(
        __name__="gstpu", init=lambda device=None: gstpu.init(),
        parse_launch=gstpu.parse_launch, State=gstpu.State,
        Buffer=gstpu.Buffer)


def _frames(bufs):
    return [(np.asarray(b.array).tobytes(), b.pts) for b in bufs]


@pytest.fixture
def cube(tmp_path):
    path = tmp_path / "g.cube"
    chip_smoke.write_cube(path, np.random.default_rng(16), n=9)
    return path


@pytest.mark.parametrize("name", ["intersink ! intersrc",
                                  "ts-blocking-adapter ! ts-queue"])
def test_phase16_bridges(name, cube):
    """16a's bridges at 64x48: in both packages the frames out of the
    bridge are the direct string's; the port's bridge elements call
    `Buffer.array` on no frame and hand on the grade's tensors."""
    strings = chip_smoke.plumbing_strings(64, 48, chip_smoke.PLUMBING_FRAMES,
                                          cube)
    launch, consumer, names = strings[name]
    seen = {}
    for pkg in NAMES:
        mod = _as_port(pkg)
        direct = chip_smoke.run_plumbing(mod, "cpu", strings["direct"][0])[2]
        with chip_smoke.ArrayCalls() as calls:
            out = chip_smoke.run_plumbing(mod, "cpu", launch, consumer)[2]
        assert _frames(out) == _frames(direct)
        seen[pkg] = out, calls
    assert _frames(seen["gstpu"][0]) == _frames(seen["gstpu_torch"][0])
    out, calls = seen["gstpu_torch"]
    assert len(out) == chip_smoke.PLUMBING_FRAMES
    assert all(isinstance(b.data, torch.Tensor) for b in out)
    assert not any(calls.by_element().get(n, 0) for n in names)



def test_phase16_save_restore(cube):
    """16a's `originalbuffersave ! hsvfilter ! colorlut !
    originalbufferrestore` at 64x48. The port's colorlut carries its
    input's metas, so the restore gives back the source's frames, fed
    videotestsrc's host arrays and fed tensors (then as copies of the
    tensors that came in), without a `Buffer.array` call by either
    element. gstpu's colorlut drops the metas: there the restore has
    nothing to restore and hands the graded frames on."""
    strings = chip_smoke.plumbing_strings(64, 48, chip_smoke.PLUMBING_FRAMES,
                                          cube)
    save = "originalbuffersave ! ... ! originalbufferrestore"
    fed = "appsrc ! " + save
    ref = {pkg: {k: chip_smoke.run_plumbing(_as_port(pkg), "cpu",
                                            strings[k][0])[2]
                 for k in ("direct", "source", save)} for pkg in NAMES}
    assert _frames(ref["gstpu"]["source"]) \
        == _frames(ref["gstpu_torch"]["source"])
    assert _frames(ref["gstpu"][save]) == _frames(ref["gstpu"]["direct"])
    assert _frames(ref["gstpu_torch"][save]) \
        == _frames(ref["gstpu_torch"]["source"])
    feed = [gstpu_torch.Buffer(torch.from_numpy(b.data.copy()), pts=b.pts,
                               duration=b.duration)
            for b in ref["gstpu_torch"]["source"]]
    with chip_smoke.ArrayCalls() as calls:
        out = chip_smoke.run_plumbing(gstpu_torch, "cpu", strings[fed][0],
                                      frames=feed)[2]
    assert _frames(out) == _frames(feed)
    assert all(b.data is not f.data and isinstance(b.data, torch.Tensor)
               for b, f in zip(out, feed))
    assert not any(calls.by_element().get(n, 0) for n in ("save", "restore"))
    # batched in a DeviceContext: with the whole grade in it (the chain's
    # head is hsvfilter) and with colorlut alone in it, the metas reach
    # the restore all the same
    string = strings[save][0]
    for hsv_ctx, lut_ctx in (("context=save16a", "context=save16a"),
                             ("", "context=save16b")):
        batched = string.replace("name=hsv", f"name=hsv {hsv_ctx}").replace(
            "name=lut", f"name=lut {lut_ctx}")
        assert f"name=lut {lut_ctx}" in batched
        with chip_smoke.ArrayCalls() as calls:
            out = chip_smoke.run_plumbing(gstpu_torch, "cpu", batched)[2]
        assert _frames(out) == _frames(ref["gstpu_torch"]["source"])
        assert not any(calls.by_element().get(n, 0)
                       for n in ("save", "restore"))


@pytest.mark.parametrize("name", ["flatecompress ! flatedecompress",
                                  "brotlicompress ! brotlidecompress",
                                  "sodiumencrypter ! sodiumdecrypter"])
def test_phase16_host_consumers(name, cube):
    """16c's strings at 64x48: the encoded stream and the round trip equal
    in both packages and equal to the encoder fed the direct string's
    frames as host arrays; the port's encoder calls `Buffer.array` once a
    frame, its decoder never."""
    missing = chip_smoke.host_libraries(gstpu_torch).get(name)
    if missing:
        pytest.skip(f"{missing} not on this machine")
    n = chip_smoke.PLUMBING_HOST_FRAMES
    launch, fed = chip_smoke.host_consumer_strings(64, 48, n, cube)[name]
    src, grade = chip_smoke.grade_strings(64, 48, n, cube)
    seen = {}
    for pkg in NAMES:
        mod = _as_port(pkg)
        P = Pkg(pkg)
        frames = chip_smoke.run_plumbing(mod, "cpu",
                                         f"{src} ! {grade} ! appsink "
                                         f"name=out")[2]
        p = P.parse_launch(launch)
        chip_smoke.keyed(mod, p)
        p.set_state(P.State.PLAYING)
        with chip_smoke.ArrayCalls() as calls:
            p.run()
        mid, out = (p.get_by_name(s).pull_all() for s in ("mid", "out"))
        p.set_state(P.State.NULL)
        q = P.parse_launch(fed)
        chip_smoke.keyed(mod, q)
        q.set_state(P.State.PLAYING)
        for b in frames:
            q.get_by_name("src").push_buffer(P.Buffer(
                np.asarray(b.array), pts=b.pts, duration=b.duration))
        q.get_by_name("src").end_of_stream()
        q.run()
        host = q.get_by_name("mid").pull_all()
        q.set_state(P.State.NULL)
        assert _bufs(mid) == _bufs(host)
        assert b"".join(b.to_bytes() for b in out) \
            == b"".join(np.asarray(b.array).tobytes() for b in frames)
        seen[pkg] = _bufs(mid), _bufs(out), calls, frames
    assert seen["gstpu"][:2] == seen["gstpu_torch"][:2]
    calls, frames = seen["gstpu_torch"][2:]
    assert [calls.of("enc", b.pts) for b in frames] == [1] * n
    assert calls.by_element().get("dec", 0) == 0
