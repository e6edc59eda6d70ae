"""The port's closed-caption and SMPTE ST 2038 modules against gstpu's,
on the CPU.

Twins of tests/test_cea608.py, test_cea708.py, test_dtvcc.py,
test_ccoverlay.py, test_scc.py, test_mcc.py, test_ttjson.py,
test_st2038.py (all but its RTP SMPTE 291 case), the caption cases of
test_cccombiner.py and the CEA-608 case of test_review_regressions.py.
Each twin is the gstpu test's body run once with gstpu's names and once
with the port's: it keeps the test's own assertions and returns what it
saw (bytes, pts, durations, metas, caps, decoder state, bus messages),
and the two packages' observations must be equal. These modules are
host code in both packages, so nothing here has a tolerance. The strings
of `chip_smoke.py`'s phase 15 run here at a small size, and the port's
combiners and overlays are held to the downloads they make of a tensor
payload.
"""

import dataclasses
import enum
import importlib

import numpy as np
import pytest
import torch

import chip_smoke
import gstpu
import gstpu_torch
from torch_session import torch_test_limit  # noqa: F401

NAMES = ("gstpu", "gstpu_torch")
SECOND = 10 ** 9
HSV = "hue_shift=12 saturation_mul=1.1 value_mul=0.9 value_off=0.02"


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU."""
    gstpu.init()
    gstpu_torch.init(device="cpu")


class Pkg:
    """One package's names, as the gstpu tests import them."""

    def __init__(self, name: str):
        self.name = name
        self.pkg = pkg = importlib.import_module(name)
        self.Buffer, self.Caps = pkg.Buffer, pkg.Caps
        self.FlowReturn, self.State = pkg.FlowReturn, pkg.State
        self.parse_launch = pkg.parse_launch
        self.make = self.mod("core.registry").make
        self.Harness = self.mod("core.harness").Harness
        self.parse_caps = self.mod("core.caps").parse_caps
        self.el = self.mod("core.element")
        self.ev = self.mod("core.event")
        video = self.mod("core.video")
        self.VideoInfo = video.VideoInfo
        self.VideoCaptionMeta = video.VideoCaptionMeta

    def mod(self, path: str):
        return importlib.import_module(f"{self.name}.{path}")


def _both(body):
    """`body` run with gstpu's names and with the port's: the
    observations must be equal. Returns the port's."""
    ref, port = (body(Pkg(name)) for name in NAMES)
    assert port == ref
    return port


def _plain(v):
    """A value with the package taken out: enums by name, dataclasses as
    dicts, containers element by element."""
    if isinstance(v, enum.Enum):
        return v.name
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _plain(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


def _meta(m):
    return type(m).__name__, _plain(dict(vars(m)))


def _buf(b):
    return (b.to_bytes(), b.pts, b.duration, [_meta(m) for m in b.metas])


def _bufs(bufs):
    return [_buf(b) for b in bufs]


def _msgs(P, bus):
    """Element messages with their fields, errors and warnings by text:
    element names and tracebacks differ between the packages."""
    out = []
    for m in bus.drain():
        if m.type is P.el.MessageType.ELEMENT:
            out.append(("element", _plain(m.fields)))
        elif m.type in (P.el.MessageType.ERROR, P.el.MessageType.WARNING):
            out.append((m.type.value, m.fields.get("text")))
    return out


def _feeder(P):
    return P.el.Pad("f", P.el.PadDirection.SRC,
                    P.el.PadTemplate("src", P.el.PadDirection.SRC,
                                     P.el.PadPresence.ALWAYS, P.Caps.any()))


def _start(P, f, caps):
    f.push_event(P.ev.StreamStartEvent("s"))
    f.push_event(P.ev.CapsEvent(P.parse_caps(caps)))
    f.push_event(P.ev.SegmentEvent(P.ev.Segment()))


def _capture(P, srcpad):
    out = []
    s = P.el.Pad("c", P.el.PadDirection.SINK,
                 P.el.PadTemplate("sink", P.el.PadDirection.SINK,
                                  P.el.PadPresence.ALWAYS, P.Caps.any()))
    s.chain_function = lambda p, b: (out.append(b), P.FlowReturn.OK)[1]
    s.event_function = lambda p, e: True
    srcpad.link(s)
    return out


def _appsrc_run(P, launch, pushes, sink="sink"):
    """A launch string whose appsrc `src` is fed `pushes` (payload, pts,
    duration) and then EOS: the appsink's caps and buffers, and the
    pipeline's messages."""
    p = P.parse_launch(launch)
    src, out = p.get_by_name("src"), p.get_by_name(sink)
    p.set_state(P.State.PLAYING)
    for data, pts, dur in pushes:
        src.push_buffer(P.Buffer(data, pts=pts, duration=dur))
    src.end_of_stream()
    p.run()
    res = (repr(out.caps), _bufs(out.pull_all()), _msgs(P, p.bus))
    p.set_state(P.State.NULL)
    return res


def _decode_all(dec, pairs):
    outs = [dec.push_pair(pair) for pair in pairs]
    return outs, next((r for r in reversed(outs) if r is not None), None)


# ---------------------------------------------------------------------------
# CEA-608 codec and elements (tests/test_cea608.py)
# ---------------------------------------------------------------------------

def test_parity():
    def body(P):
        c = P.mod("codecs.cea608")
        assert c.odd_parity(0x20) == 0x20
        assert c.odd_parity(0x41) == 0xC1
        for v in range(128):
            p = c.odd_parity(v)
            assert bin(p).count("1") % 2 == 1
            assert c.strip_parity(p) == v
        assert c.strip_parity(c.odd_parity(0x41) ^ 0x01) is None
        return ([c.odd_parity(v) for v in range(128)],
                [c.strip_parity(x) for x in range(256)])
    _both(body)


@pytest.mark.parametrize("text", [
    "HELLO WORLD",        # test_encode_decode_roundtrip
    "CAFé ñ\nSECOND",     # test_multiline_and_special_chars
    "llll",               # test_review_regressions.py:68
])
def test_encode_decode_roundtrip(text):
    def body(P):
        c = P.mod("codecs.cea608")
        pairs = c.Cea608Encoder().encode_popon(text)
        outs, last = _decode_all(c.Cea608Decoder(), pairs)
        assert last == text
        return pairs, outs
    _both(body)


def test_tt_cea608_tt_pipeline():
    def body(P):
        p = P.parse_launch("appsrc name=src ! text/x-raw, format=utf8 ! "
                           "tttocea608 ! cea608tott ! appsink name=sink")
        src, sink = p.get_by_name("src"), p.get_by_name("sink")
        src.set_property("caps", P.parse_caps("text/x-raw, format=utf8"))
        p.set_state(P.State.PLAYING)
        src.push_buffer(P.Buffer(b"FIRST CAPTION", pts=0))
        src.push_buffer(P.Buffer(b"SECOND ONE", pts=10 ** 9))
        src.end_of_stream()
        p.run()
        bufs = sink.pull_all()
        assert [b.to_bytes().decode() for b in bufs] == ["FIRST CAPTION",
                                                         "SECOND ONE"]
        res = repr(sink.caps), _bufs(bufs), _msgs(P, p.bus)
        p.set_state(P.State.NULL)
        return res
    _both(body)


def test_ccdetect_posts_presence():
    def body(P):
        h = P.Harness(P.make("ccdetect", window=0))
        h.set_caps("closedcaption/x-cea-608, format=raw")
        pairs = P.mod("codecs.cea608").Cea608Encoder().encode_popon("HI")
        for pair in pairs:
            h.push(P.Buffer(pair, pts=0))
        msgs = _msgs(P, h.bus)
        assert msgs and msgs[0][1]["cc608"] is True
        res = msgs, _bufs(h.pull_all())
        h.teardown()
        return res
    _both(body)


def test_tttocea608_origin_and_rollup_timeout():
    def body(P):
        c = P.mod("codecs.cea608")
        h = P.Harness(P.make("tttocea608", mode="roll-up2", origin_row=8,
                             origin_column=8, roll_up_timeout=500_000_000))
        h.set_caps("text/x-raw, format=utf8")
        h.push(P.Buffer(b"hello", pts=0))
        out1 = h.pull_all()
        want_pac = bytes(c.odd_parity(x) for x in c.pac(8, 8))
        assert any(b.to_bytes() == want_pac for b in out1)
        edm = bytes([c.odd_parity(0x14), c.odd_parity(c.EDM)])
        assert not any(b.to_bytes() == edm for b in out1)
        h.push(P.Buffer(b"again", pts=2_000_000_000))
        out2 = h.pull_all()
        assert out2[0].to_bytes() == edm
        h.teardown()
        return _bufs(out1), _bufs(out2)
    _both(body)


# ---------------------------------------------------------------------------
# CEA-708 CDP codec and elements (tests/test_cea708.py)
# ---------------------------------------------------------------------------

def test_cdp_roundtrip():
    def body(P):
        c = P.mod("codecs.cea708")
        cc = c.pad_cc_data(c.cc_data_from_608([b"\x94\x2c", b"\x94\x2f"]),
                           20)
        pkt = c.build_cdp(c.Cdp(rate_code=0x4, sequence=0x1234, cc_data=cc,
                                timecode=(1, 2, 3, 4)))
        assert pkt[:2] == b"\x96\x69"
        assert sum(pkt) % 256 == 0
        back = c.parse_cdp(pkt)
        assert (back.sequence, back.rate_code) == (0x1234, 0x4)
        assert back.timecode == (1, 2, 3, 4)
        assert back.cc_data == cc
        f0, f1 = c.extract_cea608(back.cc_data)
        assert f0 == [b"\x94\x2c", b"\x94\x2f"] and f1 == []
        return pkt, _plain(back), (f0, f1)
    _both(body)


def test_cdp_parse_rejects_corruption():
    def body(P):
        c = P.mod("codecs.cea708")
        pkt = bytearray(c.build_cdp(c.Cdp(cc_data=c.pad_cc_data(b"", 20))))
        bad = bytearray(pkt)
        bad[10] ^= 0xFF
        errors = []
        for data, match in ((b"\x00" + bytes(pkt[1:]), "0x9669"),
                            (bytes(bad), "checksum"),
                            (pkt[:8], "too short")):
            with pytest.raises(ValueError, match=match) as e:
                c.parse_cdp(data)
            errors.append(str(e.value))
        return bytes(pkt), errors
    _both(body)


def test_cc_count_budget():
    def body(P):
        c = P.mod("codecs.cea708")
        out = {}
        for rate, cnt in c.CC_COUNT.items():
            cc = c.pad_cc_data(c.cc_data_from_608([b"\x80\x80"]), cnt)
            assert len(cc) == 3 * cnt
            out[rate] = cc
        with pytest.raises(ValueError) as e:
            c.pad_cc_data(b"\xfc\x80\x80" * 21, 20)
        return out, str(e.value), dict(c.CDP_RATES)
    _both(body)


def _harness_run(P, factory, caps, pushes, eos=False, **props):
    h = P.Harness(P.make(factory, **props))
    h.set_caps(caps)
    for data, pts in pushes:
        h.push(P.Buffer(data, pts=pts))
    if eos:
        h.push_eos()
    out = h.pull_all()
    res = _bufs(out), _msgs(P, h.bus)
    h.teardown()
    return res


def test_element_cc_data():
    def body(P):
        bufs, msgs = _harness_run(P, "cea608tocea708",
                                  "closedcaption/x-cea-608, format=raw",
                                  [(b"\x94\x2c", 7)])
        assert bufs[0][0] == b"\xfc\x94\x2c" and bufs[0][1] == 7
        return bufs, msgs
    _both(body)


def test_element_cdp_with_framerate():
    def body(P):
        c = P.mod("codecs.cea708")
        bufs, msgs = _harness_run(
            P, "cea608tocea708",
            "closedcaption/x-cea-608, format=raw, framerate=25/1",
            [(b"\x94\x2c", None), (b"\x20\x20", None)])
        a, b = bufs[0][0], bufs[1][0]
        if a[:2] == b"\x96\x69":
            cdp0, cdp1 = c.parse_cdp(a), c.parse_cdp(b)
            assert cdp1.sequence == cdp0.sequence + 1
            assert len(cdp0.cc_data) == 3 * c.CC_COUNT[0x3]
            assert c.extract_cea608(cdp0.cc_data)[0] == [b"\x94\x2c"]
        return bufs, msgs
    _both(body)


def test_element_cdp_negotiated_downstream():
    def body(P):
        c = P.mod("codecs.cea708")
        res = _appsrc_run(
            P, "appsrc name=src caps=\"closedcaption/x-cea-608, format=raw, "
               "framerate=30000/1001\" ! cea608tocea708 ! "
               "closedcaption/x-cea-708, format=cdp ! appsink name=sink",
            [(b"\x94\x2c", None, None)])
        cdp = c.parse_cdp(res[1][0][0])
        assert cdp.rate_code == 0x4 and len(cdp.cc_data) == 3 * 20
        assert c.extract_cea608(cdp.cc_data)[0] == [b"\x94\x2c"]
        return res
    _both(body)


def test_element_s334_field2():
    def body(P):
        bufs, msgs = _harness_run(P, "cea608tocea708",
                                  "closedcaption/x-cea-608, format=s334-1a",
                                  [(b"\x80\x94\x2c\x00\x15\x2c", None)])
        assert bufs[0][0] == b"\xfc\x94\x2c\xfd\x15\x2c"
        return bufs, msgs
    _both(body)


def test_svc_info_roundtrip_in_cdp():
    def body(P):
        c = P.mod("codecs.cea708")
        svcs = [{"service": 1, "language": "eng", "easy_reader": False,
                 "wide_aspect_ratio": True},
                {"service": -2, "language": "spa"}]
        pkt = c.build_cdp(c.Cdp(cc_data=c.pad_cc_data(b"", 20),
                                services=svcs))
        assert sum(pkt) % 256 == 0
        assert c.parse_cdp(pkt).services == svcs
        return pkt
    _both(body)


def test_cdpserviceinject_element():
    def body(P):
        c = P.mod("codecs.cea708")
        el = P.make("cdpserviceinject")
        el.set_property("services", [{"service": 3, "language": "fra"}])
        h = P.Harness(el)
        h.set_caps("closedcaption/x-cea-708, format=cdp")
        plain = c.build_cdp(c.Cdp(sequence=5,
                                  cc_data=c.pad_cc_data(b"\xfc\x94\x2c", 20)))
        h.push(P.Buffer(plain, pts=9))
        out = h.pull()
        cdp = c.parse_cdp(out.to_bytes())
        assert cdp.services == [{"service": 3, "language": "fra",
                                 "easy_reader": False,
                                 "wide_aspect_ratio": False}]
        assert cdp.sequence == 5 and out.pts == 9
        assert c.extract_cea608(cdp.cc_data)[0] == [b"\x94\x2c"]
        h.teardown()
        return _buf(out)
    _both(body)


def test_cea708mux_merges_services():
    def body(P):
        c = P.mod("codecs.cea708")
        mx = P.make("cea708mux", framerate_code=0x3)
        out = _capture(P, mx.static_pad("src"))
        feeders = []
        for _ in range(2):
            f = _feeder(P)
            f.link(mx.request_pad())
            _start(P, f, "closedcaption/x-cea-708, format=cc_data")
            feeders.append(f)
        cc0 = (c.cc_data_from_608([b"\x94\x2c"])
               + c.dtvcc_to_ccdata(c.build_dtvcc(0, [(1, b"one")])))
        cc1 = c.dtvcc_to_ccdata(c.build_dtvcc(0, [(2, b"two"),
                                                  (1, b"conflict")]))
        feeders[0].push(P.Buffer(cc0, pts=0))
        feeders[1].push(P.Buffer(cc1, pts=0))
        assert len(out) == 1
        cdp = c.parse_cdp(out[0].to_bytes())
        assert len(cdp.cc_data) == 3 * 24
        assert c.extract_cea608(cdp.cc_data)[0] == [b"\x94\x2c"]
        _, pkts = c.ccdata_split(cdp.cc_data)
        assert len(pkts) == 1
        assert c.parse_dtvcc(pkts[0])[1] == [(1, b"one"), (2, b"two")]
        for f in feeders:
            f.push_event(P.ev.EosEvent())
        return _bufs(out)
    _both(body)


def test_tttocea708_roundtrips_via_overlay_extractor():
    def body(P):
        c = P.mod("codecs.cea708")
        res = _appsrc_run(P, 'appsrc name=src caps="text/x-raw, '
                             'format=utf8" ! tttocea708 service=3 ! '
                             'appsink name=sink',
                          [(b"HELLO 708", 0, None)])
        cc = b"".join(b[0] for b in res[1])
        texts = []
        for pkt in c.ccdata_split(cc)[1]:
            for svc, data in c.parse_dtvcc(pkt)[1]:
                assert svc == 3
                texts.append(c.service_block_text(data))
        assert "".join(texts) == "HELLO 708"
        return res
    _both(body)


def test_tttocea708_knobs_and_608_compat():
    def body(P):
        c = P.mod("codecs.cea708")
        bufs, msgs = _harness_run(P, "tttocea708", "text/x-raw, format=utf8",
                                  [(b"hi", 0)], service_number=3,
                                  cea608_channel=1, origin_row=10,
                                  origin_column=20, roll_up_rows=4)
        cc = bufs[0][0]
        trips = [cc[i:i + 3] for i in range(0, len(cc), 3)]
        kinds = [t[0] & 0x03 for t in trips]
        assert 0 in kinds and 3 in kinds
        dtv = b"".join(t[1:] for t in trips if t[0] & 0x03 in (2, 3))
        _seq, blocks = c.parse_dtvcc(dtv)
        assert blocks and blocks[0][0] == 3
        win = blocks[0][1]
        assert win[0] == 0x98 and (win[2], win[3]) == (10, 20)
        assert (win[4] & 0x0F) == 3
        return bufs, msgs
    _both(body)


# ---------------------------------------------------------------------------
# CEA-708 DTVCC state machine (tests/test_dtvcc.py)
# ---------------------------------------------------------------------------

def define_window(d, idx=0, visible=True, anchor_v=74, anchor_h=105,
                  anchor_point=8, rows=2, cols=31):
    return bytes([d.DF0 + idx, (0x20 if visible else 0) | 0x3,
                  anchor_v & 0x7F, anchor_h & 0xFF,
                  (anchor_point << 4) | (rows - 1), cols - 1, 0x11])


def _service(P, feeds, check):
    """A `Service708` fed `feeds` (callables of the dtvcc module giving
    bytes) in turn, `check` called after each with the service: the
    windows after every feed, as data."""
    d = P.mod("codecs.dtvcc")
    s = d.Service708()
    states = []
    for k, feed in enumerate(feeds):
        s.feed(feed(d))
        check(k, s)
        states.append([_plain(w) for w in s.windows])
    return states


def test_define_write_read_back():
    def check(k, s):
        w = s.windows[0]
        assert w.defined and w.visible and (w.rows, w.cols) == (2, 20)
        assert w.text() == "HELLO" and (w.pen.row, w.pen.col) == (0, 5)
    _both(lambda P: _service(P, [
        lambda d: define_window(d, 0, rows=2, cols=20) + b"HELLO"], check))


def test_carriage_return_and_rollup_scroll():
    def check(k, s):
        if k == 1:
            assert s.windows[0].text_rows()[:2] == ["TWO", "TRE"]
    _both(lambda P: _service(P, [
        lambda d: define_window(d, 0, rows=2, cols=10),
        lambda d: b"ONE\rTWO\rTRE"], check))


def test_pen_location_spl():
    def check(k, s):
        if k == 1:
            assert s.windows[0].grid[2][5] == "X"
    _both(lambda P: _service(P, [
        lambda d: define_window(d, 0, rows=4, cols=16),
        lambda d: bytes([d.SPL, 2, 5]) + b"X"], check))


def test_multi_window():
    def check(k, s):
        w0, w1 = s.windows[0], s.windows[1]
        if k == 3:
            assert (w0.text(), w1.text()) == ("TOP", "BOTTOM")
        elif k == 4:
            assert not w0.visible and w1.visible
        elif k == 5:
            assert w0.visible and not w1.visible
        elif k == 6:
            assert (w0.text(), w1.text()) == ("", "BOTTOM")
        elif k == 7:
            assert not w1.defined
    _both(lambda P: _service(P, [
        lambda d: define_window(d, 0, rows=1, cols=10, anchor_point=0),
        lambda d: b"TOP",
        lambda d: define_window(d, 1, rows=1, cols=10, anchor_point=8),
        lambda d: b"BOTTOM",
        lambda d: bytes([d.HDW, 0b01]),
        lambda d: bytes([d.TGW, 0b11]),
        lambda d: bytes([d.CLW, 0b01]),
        lambda d: bytes([d.DLW, 0b10])], check))


def test_backspace_ff_hcr_reset():
    def check(k, s):
        w = s.windows[0]
        want = {1: "AB", 2: "", 3: "Z"}
        if k in want:
            assert w.text() == want[k]
        if k == 2:
            assert (w.pen.row, w.pen.col) == (0, 0)
        if k == 4:
            assert not w.defined
    _both(lambda P: _service(P, [
        lambda d: define_window(d, 0, rows=2, cols=10),
        lambda d: b"ABC\x08", lambda d: b"\x0C", lambda d: b"XY\x0EZ",
        lambda d: bytes([d.RST])], check))


def test_window_attributes_swa():
    def check(k, s):
        w = s.windows[0]
        if k == 1:
            assert (w.fill_opacity, w.fill_color) == (3, 2)
            assert w.wordwrap and w.scroll_dir == 1 and w.justify == 2
            assert w.print_dir == 0
    _both(lambda P: _service(P, [
        lambda d: define_window(d, 0),
        lambda d: bytes([d.SWA, 0b11_000010, 0, 0b0_1_00_01_10, 0])], check))


def test_g1_and_ext1_g2():
    def check(k, s):
        if k == 2:
            assert s.windows[0].text() == "CAFÉ…"
    _both(lambda P: _service(P, [
        lambda d: define_window(d, 0, cols=12),
        lambda d: "CAF".encode("latin-1") + bytes([0xC9]),
        lambda d: bytes([0x10, 0x25])], check))


def _cc_data_for(P, blocks):
    c = P.mod("codecs.cea708")
    pkt = c.build_dtvcc(0, blocks)
    if len(pkt) % 2:
        pkt += b"\x00"
    return b"".join(c.cc_triplet(pkt[k], pkt[k + 1], 3 if k == 0 else 2)
                    for k in range(0, len(pkt), 2))


def test_decoder_packet_reassembly_from_cc_data():
    def body(P):
        d = P.mod("codecs.dtvcc")
        dec = d.DtvccDecoder()
        payload = define_window(d, 0, rows=1, cols=16) + b"HI 708"
        cc = _cc_data_for(P, [(1, payload)])
        dec.feed_cc_data(cc)
        wins = dec.visible_windows(1)
        assert len(wins) == 1 and wins[0][1] == "HI 708"
        return cc, [(_plain(w), t) for w, t in wins]
    _both(body)


def test_overlay_renders_multiwindow_anchored():
    pytest.importorskip("PIL.Image")

    def body(P):
        d = P.mod("codecs.dtvcc")
        h = P.Harness(P.make("cea708overlay"))
        h.set_caps("video/x-raw, format=RGB, width=320, height=180")
        vi = P.VideoInfo("RGB", 320, 180)
        payload = (define_window(d, 0, rows=1, cols=8, anchor_point=0,
                                 anchor_v=0, anchor_h=0) + b"UP" +
                   define_window(d, 1, rows=1, cols=8, anchor_point=8,
                                 anchor_v=74, anchor_h=209) + b"DOWN")
        buf = vi.make_buffer(np.zeros((180, 320, 3), np.uint8))
        buf.add_meta(P.VideoCaptionMeta("cea708-raw",
                                        _cc_data_for(P, [(1, payload)])))
        h.push(buf)
        out = h.pull()
        frame = vi.view(out)
        assert frame[:30, :80].sum() > 0 and frame[-30:, -80:].sum() > 0
        assert frame[80:100, 140:180].sum() == 0
        h.teardown()
        return _buf(out)
    _both(body)


# ---------------------------------------------------------------------------
# cea608overlay / cea708overlay (tests/test_ccoverlay.py)
# ---------------------------------------------------------------------------

def _overlay_run(P, factory, metas, n_frames=1, size=(160, 120), val=0,
                 **props):
    """`n_frames` RGBA frames of `val` through the overlay, `metas`
    (caption type, data) on the first: each output buffer."""
    w, h_ = size
    vi = P.VideoInfo("RGBA", w, h_)
    h = P.Harness(P.make(factory, **props))
    h.set_caps(f"video/x-raw, format=RGBA, width={w}, height={h_}, "
               f"framerate=30/1")
    outs = []
    for i in range(n_frames):
        b = vi.make_buffer(np.full((h_, w, 4), val, np.uint8))
        if i == 0:
            for kind, data in metas:
                b.add_meta(P.VideoCaptionMeta(kind, data))
        h.push(b)
        outs.append(h.pull())
    frames = [vi.view(o).copy() for o in outs]
    res = _bufs(outs)
    h.teardown()
    return frames, res


def test_overlay_renders_after_eoc():
    pytest.importorskip("PIL.Image")

    def body(P):
        pairs = P.mod("codecs.cea608").Cea608Encoder().encode_popon("HI")
        (f1, f2), res = _overlay_run(P, "cea608overlay",
                                     [("cea608-raw", b"".join(pairs))], 2,
                                     black_background=True)
        assert f1.any() and f1[:40].sum() == 0
        assert (f1[60:, :, :3] >= 200).any()
        assert (f2 == f1).all()
        return res
    _both(body)


def test_overlay_no_caption_passthrough():
    def body(P):
        (f,), res = _overlay_run(P, "cea608overlay", [], size=(64, 48),
                                 val=7)
        assert (f == 7).all()
        return res
    _both(body)


def test_overlay_cea708_raw_meta():
    pytest.importorskip("PIL.Image")

    def body(P):
        pairs = P.mod("codecs.cea608").Cea608Encoder().encode_popon("X")
        cc = P.mod("codecs.cea708").cc_data_from_608(pairs)
        (f,), res = _overlay_run(P, "cea608overlay", [("cea708-raw", cc)])
        assert f.any()
        return res
    _both(body)


def test_cea708_overlay_service_text():
    pytest.importorskip("PIL.Image")

    def body(P):
        c = P.mod("codecs.cea708")
        data = b"\x98" + bytes(6) + b"HI\x0dTHERE\x03"
        assert c.service_block_text(data) == "HI\nTHERE"
        cc = c.dtvcc_to_ccdata(c.build_dtvcc(0, [(1, b"WRONG"),
                                                 (2, b"RIGHT\x03")]))
        (f,), res = _overlay_run(P, "cea708overlay", [("cea708-raw", cc)],
                                 service=2, black_background=True)
        assert f.any()
        return res
    _both(body)


# ---------------------------------------------------------------------------
# cccombiner / ccextractor / cea608mux (tests/test_cccombiner.py)
# ---------------------------------------------------------------------------

def _combiner(P, vcaps, factory="cccombiner", overlay=None):
    """`factory` with a video feeder and a caption feeder started, its
    output captured (through `overlay` where one is named)."""
    cb = P.make(factory, element_name="comb")
    src = cb.static_pad("src")
    if overlay is not None:
        ov = P.make(overlay, element_name="ov")
        src.link(ov.static_pad("sink"))
        src = ov.static_pad("src")
    out = _capture(P, src)
    vf = _feeder(P)
    vf.link(cb.request_pad("sink"))
    _start(P, vf, vcaps)
    cf = _feeder(P)
    cf.link(cb.request_pad())
    _start(P, cf, "closedcaption/x-cea-608, format=raw")
    return vf, cf, out


def test_cccombiner_attaches_metas_by_interval():
    def body(P):
        vf, cf, out = _combiner(P, "video/x-raw, format=RGBA, width=4, "
                                   "height=4, framerate=30/1")
        vi = P.VideoInfo("RGBA", 4, 4)
        cf.push(P.Buffer(b"\x94\x2c", pts=5_000_000))
        cf.push(P.Buffer(b"\x94\x2f", pts=70_000_000))
        for i in range(3):
            vf.push(vi.make_buffer(np.zeros((4, 4, 4), np.uint8),
                                   pts=i * SECOND // 30))
        cf.push_event(P.ev.EosEvent())
        vf.push_event(P.ev.EosEvent())
        metas = [[m for m in b.metas if isinstance(m, P.VideoCaptionMeta)]
                 for b in out]
        assert [len(m) for m in metas] == [1, 0, 1]
        assert metas[0][0].data == b"\x94\x2c"
        assert metas[0][0].caption_type == "cea608-raw"
        assert metas[2][0].data == b"\x94\x2f"
        return _bufs(out)
    _both(body)


def test_ccextractor_splits_back():
    def body(P):
        ex = P.make("ccextractor")
        h = P.Harness(ex)
        h.set_caps("video/x-raw, format=RGBA, width=4, height=4, "
                   "framerate=30/1")
        vi = P.VideoInfo("RGBA", 4, 4)
        b = vi.make_buffer(np.zeros((4, 4, 4), np.uint8), pts=7)
        b.add_meta(P.VideoCaptionMeta("cea608-raw", b"\xaa\xbb"))
        h.push(b)
        cap = ex.static_pad("caption")
        assert cap is not None
        cc_out = _capture(P, cap)
        b2 = vi.make_buffer(np.zeros((4, 4, 4), np.uint8), pts=40)
        b2.add_meta(P.VideoCaptionMeta("cea608-raw", b"\x94\x2f"))
        h.push(b2)
        assert [c.to_bytes() for c in cc_out] == [b"\x94\x2f"]
        vids = h.pull_all()
        assert all(not any(isinstance(m, P.VideoCaptionMeta)
                           for m in v.metas) for v in vids)
        h.teardown()
        return _bufs(cc_out), _bufs(vids), repr(cap.caps())
    _both(body)


def test_combine_then_overlay_chain():
    pytest.importorskip("PIL.Image")

    def body(P):
        vf, cf, out = _combiner(P, "video/x-raw, format=RGBA, width=160, "
                                   "height=120, framerate=30/1",
                                overlay="cea608overlay")
        vi = P.VideoInfo("RGBA", 160, 120)
        pairs = P.mod("codecs.cea608").Cea608Encoder().encode_popon("OK")
        for i, pair in enumerate(pairs):
            cf.push(P.Buffer(pair, pts=i))
        cf.push_event(P.ev.EosEvent())
        vf.push(vi.make_buffer(np.zeros((120, 160, 4), np.uint8), pts=0))
        vf.push_event(P.ev.EosEvent())
        assert len(out) == 1 and vi.view(out[0]).any()
        return _bufs(out)
    _both(body)


def test_tttocea608_rollup_mode():
    def body(P):
        odd = P.mod("codecs.cea608").odd_parity
        h = P.Harness(P.make("tttocea608", mode="roll-up2"))
        h.set_caps("text/x-raw, format=utf8")
        h.push(P.Buffer(b"NEWS LINE", pts=0, duration=SECOND))
        out = h.pull_all()
        h.teardown()
        assert out[0].to_bytes() == bytes([odd(0x14), odd(0x25)])
        assert out[1].to_bytes() == bytes([odd(0x14), odd(0x2D)])
        return _bufs(out)
    _both(body)


def test_cea608mux_pts_ordered_merge():
    def body(P):
        mux = P.make("cea608mux")
        got = _capture(P, mux.static_pad("src"))
        mux.set_state(P.State.PLAYING)
        p1 = mux.request_pad("sink_cc1")
        p3 = mux.request_pad("sink_cc3")
        feeders = []
        for p in (p1, p3):
            f = _feeder(P)
            f.link(p)
            _start(P, f, "closedcaption/x-cea-608, format=raw")
            feeders.append(f)
        p3.chain(P.Buffer(b"\x14\x2c", pts=2 * SECOND))
        p1.chain(P.Buffer(b"\x94\x2c", pts=1 * SECOND))
        p1.chain(P.Buffer(b"\x94\xae", pts=3 * SECOND))
        for f in feeders:
            f.push_event(P.ev.EosEvent())
        assert [b.pts for b in got] == [SECOND, 2 * SECOND, 3 * SECOND]
        assert got[0].to_bytes()[0] & 0x80
        assert not got[1].to_bytes()[0] & 0x80
        assert got[0].to_bytes()[1:3] == b"\x94\x2c"
        return _bufs(got), sorted(mux.pads)
    _both(body)


# ---------------------------------------------------------------------------
# Scenarist SCC files (tests/test_scc.py)
# ---------------------------------------------------------------------------

def test_timecode_conversion():
    def body(P):
        s = P.mod("elements.video.scc")
        assert s.timecode_to_ns("00:00:01:00") == SECOND
        assert s.timecode_to_ns("01:00:00:00") == 3600 * SECOND
        assert s.timecode_to_ns("00:00:00:15") == SECOND // 2
        assert s.ns_to_timecode(SECOND) == "00:00:01:00"
        df = s.timecode_to_ns("00:01:00;02")
        assert abs(df - 60 * SECOND) < 75_000_000
        rng = np.random.default_rng(11)
        ns = [int(v) for v in rng.integers(0, 7200 * SECOND, 50)]
        return df, [s.ns_to_timecode(v) for v in ns], \
            [s.timecode_to_ns(s.ns_to_timecode(v)) for v in ns]
    _both(body)


def test_scc_parse_pipeline(tmp_path):
    f = tmp_path / "t.scc"
    f.write_text("Scenarist_SCC V1.0\n\n"
                 "00:00:01:00\t9420 94ae 9452 c8c9 942f\n\n"
                 "00:00:03:00\t942c\n")

    def body(P):
        p = P.parse_launch(f"filesrc location={f} ! application/x-scc ! "
                           "sccparse ! appsink name=sink")
        sink = p.get_by_name("sink")
        p.set_state(P.State.PLAYING)
        p.run()
        bufs = sink.pull_all()
        assert len(bufs) == 6 and bufs[0].to_bytes() == bytes.fromhex("9420")
        assert (bufs[0].pts, bufs[5].pts) == (SECOND, 3 * SECOND)
        assert sink.caps[0].name == "closedcaption/x-cea-608"
        res = repr(sink.caps), _bufs(bufs), _msgs(P, p.bus)
        p.set_state(P.State.NULL)
        return res
    _both(body)


def test_scc_roundtrip_with_cea608():
    def body(P):
        res = _appsrc_run(P, "appsrc name=src caps=\"text/x-raw, "
                             "format=utf8\" ! tttocea608 ! sccenc ! "
                             "sccparse ! cea608tott ! appsink name=sink",
                          [(b"ROUND TRIP", SECOND, None)])
        assert [b[0].decode() for b in res[1]] == ["ROUND TRIP"]
        return res
    _both(body)


def _failing_run(P, launch):
    p = P.parse_launch(launch)
    p.set_state(P.State.PLAYING)
    with pytest.raises(RuntimeError, match="pipeline error"):
        p.run()
    msgs = _msgs(P, p.bus)
    assert msgs and msgs[0][0] == "error"
    p.set_state(P.State.NULL)
    return msgs


def test_scc_bad_header_errors(tmp_path):
    f = tmp_path / "bad.scc"
    f.write_text("NOT AN SCC FILE\n00:00:01:00\t9420\n")
    _both(lambda P: _failing_run(P, f"filesrc location={f} ! "
                                    f"application/x-scc ! sccparse ! "
                                    f"fakesink"))


# ---------------------------------------------------------------------------
# MacCaption MCC files (tests/test_mcc.py)
# ---------------------------------------------------------------------------

def test_alias_table_roundtrip():
    def body(P):
        m = P.mod("elements.video.mcc")
        for text, raw in (("G", b"\xfa\x00\x00"), ("O", b"\xfa\x00\x00" * 9),
                          ("P", b"\xfb\x80\x80"), ("Q", b"\xfc\x80\x80"),
                          ("R", b"\xfd\x80\x80"), ("S", b"\x96\x69"),
                          ("T", b"\x61\x01"), ("U", b"\xe1\x00\x00\x00"),
                          ("Z", b"\x00"), ("4A", b"\x4a")):
            assert m.decode_mcc_payload(text) == raw
            assert m.encode_mcc_payload(raw) == text
        assert m.encode_mcc_payload(b"\xfa\x00\x00" * 10) == "OG"
        assert m.decode_mcc_payload("OG") == b"\xfa\x00\x00" * 10
        rng = np.random.default_rng(12)
        raw = bytes(rng.choice([0x00, 0x4a, 0x61, 0x01, 0x80, 0x96, 0x69,
                                0xe1, 0xfa, 0xfb, 0xfc, 0xfd], 400)
                    .astype(np.uint8))
        text = m.encode_mcc_payload(raw)
        assert m.decode_mcc_payload(text) == raw
        return text
    _both(body)


def test_timecode_drop_frame_roundtrip():
    def body(P):
        m = P.mod("elements.video.mcc")
        out = []
        for tc in ("00:00:59;29", "00:01:00;02", "00:09:59;29",
                   "00:10:00;00", "01:23:45;17"):
            ns = m.mcc_timecode_to_ns(tc, 30, True)
            assert m.ns_to_mcc_timecode(ns, 30, True) == tc
            out.append(ns)
        assert m.mcc_timecode_to_ns("00:00:01:00", 25, False) == SECOND
        return out
    _both(body)


def _mcc_file(payload_lines):
    return ("File Format=MacCaption_MCC V1.0\r\n\r\n"
            "// comment line\r\n"
            "UUID=X\r\nCreation Program=test\r\n"
            "Time Code Rate=30DF\r\n\r\n"
            + "".join(payload_lines))


def test_mccparse_cdp(tmp_path):
    from gstpu_torch.elements.video.mcc import (encode_mcc_payload,
                                                mcc_timecode_to_ns)
    cdp = bytes([0x96, 0x69] + list(range(10)))
    f = tmp_path / "a.mcc"
    f.write_text(_mcc_file(["00:00:01;00\tT" + f"{len(cdp):02X}"
                            + encode_mcc_payload(cdp)
                            + f"{sum(cdp) & 0xFF:02X}\r\n"]))

    def body(P):
        p = P.parse_launch(f"filesrc location={f} ! application/x-mcc ! "
                           f"mccparse ! appsink name=out")
        out = p.get_by_name("out")
        p.set_state(P.State.PLAYING)
        p.run()
        bufs = out.pull_all()
        assert out.caps[0].name == "closedcaption/x-cea-708"
        assert out.caps[0]["format"] == "cdp"
        assert len(bufs) == 1 and bufs[0].to_bytes() == cdp
        assert bufs[0].pts == mcc_timecode_to_ns("00:00:01;00", 30, True)
        res = repr(out.caps), _bufs(bufs), _msgs(P, p.bus)
        p.set_state(P.State.NULL)
        return res
    _both(body)


def test_mccparse_bad_header_errors(tmp_path):
    f = tmp_path / "bad.mcc"
    f.write_text("Scenarist_SCC V1.0\n")
    _both(lambda P: _failing_run(P, f"filesrc location={f} ! "
                                    f"application/x-mcc ! mccparse ! "
                                    f"fakesink"))


def test_mcc_enc_parse_roundtrip():
    def body(P):
        payloads = [bytes([0x96, 0x69, i, 0xFA, 0x00, 0x00])
                    for i in range(3)]
        h = P.Harness(P.make("mccenc", uuid="0", fps=30, drop_frame=True))
        h.set_caps("closedcaption/x-cea-708, format=cdp")
        for i, pl in enumerate(payloads):
            h.push(P.Buffer(pl, pts=i * SECOND * 1001 // 30000))
        enc = h.pull_all()
        text = b"".join(b.to_bytes() for b in enc).decode()
        assert text.startswith("File Format=MacCaption_MCC V1.0\r\n")
        assert "Time Code Rate=30DF" in text and "\tT06" in text
        h.teardown()
        h2 = P.Harness(P.make("mccparse"))
        h2.set_caps("application/x-mcc")
        h2.push(P.Buffer(text.encode()))
        h2.push_eos()
        outs = h2.pull_all()
        assert [b.to_bytes() for b in outs] == payloads
        assert outs[1].pts == SECOND * 1001 // 30000
        h2.teardown()
        return _bufs(enc), _bufs(outs)
    _both(body)


def test_mcc_enc_608_prefix():
    def body(P):
        bufs, msgs = _harness_run(P, "mccenc",
                                  "closedcaption/x-cea-608, format=raw",
                                  [(b"\x94\x2c", 0)], uuid="0")
        text = b"".join(b[0] for b in bufs).decode()
        assert "\t6102" in text and "T" not in text.split("\t")[-1][:1]
        return bufs, msgs
    _both(body)


# ---------------------------------------------------------------------------
# caption JSON and WebVTT (tests/test_ttjson.py)
# ---------------------------------------------------------------------------

def test_cea608tojson_popon():
    def body(P):
        import json
        pairs = P.mod("codecs.cea608").Cea608Encoder().encode_popon("HELLO")
        h = P.Harness(P.make("cea608tojson"))
        h.set_caps("closedcaption/x-cea-608, format=raw")
        for i, p in enumerate(pairs):
            h.push(P.Buffer(p, pts=i * 33_000_000))
        outs = h.pull_all()
        assert len(outs) == 1
        doc = json.loads(outs[0].to_bytes())
        assert doc["mode"] == "PopOn"
        chunk = doc["lines"][0]["chunks"][0]
        assert (chunk["text"], chunk["style"]) == ("HELLO", "White")
        h.teardown()
        return _bufs(outs)
    _both(body)


def test_jsontovtt_cues():
    def body(P):
        lines_to_json = P.mod("elements.video.ttjson").lines_to_json
        h = P.Harness(P.make("jsontovtt", default_duration=SECOND))
        h.set_caps("application/x-json, format=cea608")
        h.push(P.Buffer(lines_to_json("FIRST"), pts=SECOND))
        h.push(P.Buffer(lines_to_json("SECOND\nLINE2"), pts=3 * SECOND))
        h.push_eos()
        outs = h.pull_all()
        text = b"".join(b.to_bytes() for b in outs).decode()
        assert text.startswith("WEBVTT\n\n")
        assert "00:00:01.000 --> 00:00:03.000\nFIRST\n" in text
        assert "00:00:03.000 --> 00:00:04.000\nSECOND\nLINE2\n" in text
        h.teardown()
        return _bufs(outs)
    _both(body)


def test_full_608_to_vtt_pipeline():
    def body(P):
        pairs = P.mod("codecs.cea608").Cea608Encoder().encode_popon(
            "VTT TEST")
        res = _appsrc_run(P, 'appsrc name=src caps="closedcaption/x-cea-608,'
                             ' format=raw" ! cea608tojson ! jsontovtt ! '
                             'appsink name=sink',
                          [(pair, i * 33_000_000, None)
                           for i, pair in enumerate(pairs)])
        text = b"".join(b[0] for b in res[1]).decode()
        assert "WEBVTT" in text and "VTT TEST" in text and "-->" in text
        return res
    _both(body)


# ---------------------------------------------------------------------------
# SMPTE ST 2038 (tests/test_st2038.py, all but its RTP SMPTE 291 case)
# ---------------------------------------------------------------------------

def test_anc_roundtrip():
    def body(P):
        s = P.mod("codecs.st2038")
        anc = s.build_anc(0x61, 0x01, bytes(range(17)), line_number=9,
                          horizontal_offset=123)
        hdr, back = s.parse_anc(anc)
        assert (hdr.did, hdr.sdid, hdr.data_count) == (0x61, 0x01, 17)
        assert (hdr.line_number, hdr.horizontal_offset) == (9, 123)
        assert back == bytes(range(17))
        assert (hdr.checksum >> 9) & 1 == (~(hdr.checksum >> 8)) & 1
        return anc, _plain(hdr)
    _both(body)


def test_anc_multiple_packets_and_stuffing():
    def body(P):
        s = P.mod("codecs.st2038")
        data = (s.build_anc(0x61, 0x01, b"one")
                + s.build_anc(0x45, 0x01, b"other-service")
                + s.build_anc(0x61, 0x02, b"two") + b"\xff\xff\xff")
        got = [(h.did, h.sdid, p) for h, p in s.iter_anc(data)]
        assert got == [(0x61, 0x01, b"one"), (0x45, 0x01, b"other-service"),
                       (0x61, 0x02, b"two")]
        return data, [(_plain(h), p) for h, p in s.iter_anc(data)]
    _both(body)


def test_anc_rejects_garbage():
    def body(P):
        s = P.mod("codecs.st2038")
        errors = []
        with pytest.raises(ValueError) as e:
            s.parse_anc(b"\xc0\x00\x00\x00\x00\x00")
        errors.append(str(e.value))
        with pytest.raises(ValueError) as e:
            s.build_anc(0x61, 0x01, bytes(256))
        errors.append(str(e.value))
        return errors
    _both(body)


def test_cc_to_anc_to_cc_roundtrip():
    def body(P):
        c, s = P.mod("codecs.cea708"), P.mod("codecs.st2038")
        cdp = c.build_cdp(c.Cdp(cc_data=c.pad_cc_data(b"\xfc\x94\x2c", 20)))
        to_anc = P.Harness(P.make("cctost2038anc", line_number=11))
        to_anc.set_caps("closedcaption/x-cea-708, format=cdp")
        to_anc.push(P.Buffer(cdp, pts=42))
        anc_buf = to_anc.pull()
        hdr, payload = s.parse_anc(anc_buf.to_bytes())
        assert (hdr.did, hdr.sdid, hdr.line_number) == (0x61, 0x01, 11)
        assert payload == cdp
        to_anc.teardown()
        back = P.Harness(P.make("st2038anctocc"))
        back.set_caps("meta/x-st-2038")
        back.push(anc_buf)
        out = back.pull()
        assert out.to_bytes() == cdp and out.pts == 42
        caps = back.element.srcpad.caps()
        assert caps[0].name == "closedcaption/x-cea-708"
        back.teardown()
        return _buf(anc_buf), _buf(out), repr(caps)
    _both(body)


def test_anctocc_skips_foreign_services():
    def body(P):
        s = P.mod("codecs.st2038")
        data = (s.build_anc(0x41, 0x05, b"vanc-timecode")
                + s.build_anc(0x61, 0x02, b"\x80\x94\x2c"))
        bufs, msgs = _harness_run(P, "st2038anctocc", "meta/x-st-2038",
                                  [(data, None)])
        assert len(bufs) == 1 and bufs[0][0] == b"\x80\x94\x2c"
        return bufs, msgs
    _both(body)


def test_st2038_demux_splits_streams():
    def body(P):
        s = P.mod("codecs.st2038")
        dm = P.make("st2038ancdemux")
        combined = _capture(P, dm.static_pad("src"))
        f = _feeder(P)
        f.link(dm.static_pad("sink"))
        _start(P, f, "meta/x-st-2038")
        a = s.build_anc(0x61, 0x01, b"cdp", line_number=9)
        b = s.build_anc(0x45, 0x05, b"tc", line_number=12)
        f.push(P.Buffer(a + b, pts=5))
        assert [x.to_bytes() for x in combined] == [a, b]
        names = sorted(p for p in dm.pads if p.startswith("anc_"))
        assert names == ["anc_45_05_at_12_0", "anc_61_01_at_9_0"]
        got = _capture(P, dm.static_pad("anc_61_01_at_9_0"))
        f.push(P.Buffer(a, pts=6))
        assert [x.to_bytes() for x in got] == [a]
        return _bufs(combined), names, _bufs(got)
    _both(body)


def test_st2038_mux_merges_by_timestamp():
    def body(P):
        s = P.mod("codecs.st2038")
        mx = P.make("st2038ancmux")
        out = _capture(P, mx.static_pad("src"))
        feeders = []
        for _ in range(2):
            f = _feeder(P)
            f.link(mx.request_pad())
            _start(P, f, "meta/x-st-2038")
            feeders.append(f)
        a = s.build_anc(0x61, 0x01, b"one")
        b = s.build_anc(0x61, 0x02, b"two")
        feeders[0].push(P.Buffer(a, pts=0))
        feeders[1].push(P.Buffer(b, pts=0))
        assert out and out[0].to_bytes() == a + b
        for f in feeders:
            f.push_event(P.ev.EosEvent())
        return _bufs(out)
    _both(body)


def test_st2038_combiner_extractor_meta_path():
    def body(P):
        s = P.mod("codecs.st2038")
        St2038Meta = P.mod("elements.video.st2038").St2038Meta
        anc = s.build_anc(0x61, 0x01, b"cdp-bytes")
        cb = P.make("st2038combiner")
        h = P.Harness(cb)
        h.set_caps("video/x-raw, format=RGBA, width=4, height=4, "
                   "framerate=30/1")
        feeder = _feeder(P)
        feeder.link(cb.request_pad())
        _start(P, feeder, "meta/x-st-2038")
        feeder.push(P.Buffer(anc, pts=5))
        vi = P.VideoInfo("RGBA", 4, 4)
        h.push(vi.make_buffer(np.zeros((4, 4, 4), np.uint8), pts=0))
        out = h.pull()
        metas = [m for m in out.metas if isinstance(m, St2038Meta)]
        assert metas and metas[0].data == anc
        combined = _buf(out)
        h.teardown()
        ex = P.make("st2038extractor")
        h2 = P.Harness(ex)
        h2.set_caps("video/x-raw, format=RGBA, width=4, height=4, "
                    "framerate=30/1")
        h2.push(out)
        got = _capture(P, ex.static_pad("anc"))
        b2 = vi.make_buffer(np.zeros((4, 4, 4), np.uint8), pts=40)
        b2.add_meta(St2038Meta(anc))
        h2.push(b2)
        assert [g.to_bytes() for g in got] == [anc]
        vids = h2.pull_all()
        assert all(not v.metas for v in vids)
        h2.teardown()
        return combined, _bufs(got), _bufs(vids)
    _both(body)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 15a strings at 64x48; the port's tensor payloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,texts", [
    ("608", chip_smoke.CAPTIONS_608), ("708", chip_smoke.CAPTIONS_708),
    ("st2038", chip_smoke.CAPTIONS_708)])
def test_phase15_strings(kind, texts, tmp_path, monkeypatch):
    """Phase 15a's strings as chip_smoke.py builds them, at 64x48 through
    gstpu and through the port on the CPU: every output's bytes, times
    and metas and the element messages equal. The port's combiner calls
    `Buffer.array` on no frame and its overlay once on each frame whose
    metas put a caption on it; those leave it as host arrays, the others
    as the tensors the grade made."""
    if kind != "st2038":
        pytest.importorskip("PIL.Image")
    monkeypatch.setattr(chip_smoke, "EDGE_W", 64)
    monkeypatch.setattr(chip_smoke, "EDGE_H", 48)
    cube = tmp_path / "g.cube"
    chip_smoke.write_cube(cube, np.random.default_rng(15), n=9)
    sinks = ("out", "cc") if kind == "st2038" else ("out",)
    port = {}

    def body(P):
        launch, build, feed = chip_smoke.caption_string(
            P.pkg, kind, cube, chip_smoke.CAPTION_FRAMES, texts)
        p = P.parse_launch(launch)
        build(p)
        p.set_state(P.State.PLAYING)
        feed(p)
        with chip_smoke.ArrayCalls() as calls:
            p.run()
        out = {s: p.get_by_name(s).pull_all() for s in sinks}
        res = ({s: _bufs(b) for s, b in out.items()}, _msgs(P, p.bus))
        p.set_state(P.State.NULL)
        port.update(out=out, calls=calls)
        return res
    _both(body)
    out, calls = port["out"], port["calls"]
    frames = out["out"]
    assert len(frames) == chip_smoke.CAPTION_FRAMES
    assert calls.by_element().get("comb", 0) == 0
    kinds = [type(b.data).__name__ for b in frames]
    if kind == "st2038":
        assert len(out["cc"]) == len(texts) and kinds == ["Tensor"] * 16
        return
    strips = chip_smoke.strip_frames(kind, frames)
    assert any(strips) and not all(strips)
    assert [calls.of("ov", b.pts) for b in frames] == [int(s) for s in strips]
    assert kinds == ["ndarray" if s else "Tensor" for s in strips]


def _tensor_frames(n, w=160, h=120):
    rng = np.random.default_rng(16)
    return [torch.from_numpy(rng.integers(0, 256, (h, w, 4), np.uint8))
            for _ in range(n)]


def test_cccombiner_overlay_downloads():
    """The port's `cccombiner ! cea608overlay` on tensor payloads: the
    combiner reads no payload and hands each tensor on as it came; the
    overlay reads a frame (a download on a card) only where a caption
    strip is drawn, and then hands on the drawn host frame."""
    pytest.importorskip("PIL.Image")
    P = Pkg("gstpu_torch")
    vf, cf, out = _combiner(P, "video/x-raw, format=RGBA, width=160, "
                               "height=120, framerate=30/1",
                            overlay="cea608overlay")
    pairs = P.mod("codecs.cea608").Cea608Encoder().encode_popon("ON")
    dur = SECOND // 30
    for i, pair in enumerate(pairs):
        cf.push(P.Buffer(pair, pts=(2 + i) * dur))
    cf.push_event(P.ev.EosEvent())
    frames = _tensor_frames(12)
    with chip_smoke.ArrayCalls() as calls:
        for i, f in enumerate(frames):
            vf.push(P.Buffer(f, pts=i * dur, duration=dur))
        vf.push_event(P.ev.EosEvent())
    strips = chip_smoke.strip_frames("608", out)
    assert strips == [False] * 6 + [True] * 6
    assert calls.tensor_calls == {"ov": 6}
    assert [calls.of("ov", b.pts) for b in out] == [int(s) for s in strips]
    for b, f, s in zip(out, frames, strips):
        assert (b.data is f) != s
        assert isinstance(b.data, np.ndarray) == s


def test_combiners_hand_the_tensor_on_unread():
    """`cccombiner` and `st2038combiner` on the port, fed tensors: each
    output buffer holds the very tensor that came in, with its metas,
    and neither element calls `Buffer.array`."""
    P = Pkg("gstpu_torch")
    s = P.mod("codecs.st2038")
    dur = SECOND // 30
    frames = _tensor_frames(3, 4, 4)
    vcaps = "video/x-raw, format=RGBA, width=4, height=4, framerate=30/1"
    with chip_smoke.ArrayCalls() as calls:
        vf, cf, out = _combiner(P, vcaps)
        cf.push(P.Buffer(b"\x94\x2c", pts=dur))
        cf.push_event(P.ev.EosEvent())
        for i, f in enumerate(frames):
            vf.push(P.Buffer(f, pts=i * dur, duration=dur))
        vf.push_event(P.ev.EosEvent())
        cb = P.make("st2038combiner")
        h = P.Harness(cb)
        h.set_caps(vcaps)
        feeder = _feeder(P)
        feeder.link(cb.request_pad())
        _start(P, feeder, "meta/x-st-2038")
        anc = s.build_anc(0x61, 0x01, b"cdp-bytes")
        feeder.push(P.Buffer(anc, pts=2 * dur))
        for i, f in enumerate(frames):
            h.push(P.Buffer(f, pts=i * dur, duration=dur))
        anc_out = h.pull_all()
        h.teardown()
    assert calls.counts == {}
    for got in (out, anc_out):
        assert len(got) == len(frames)
        assert all(b.data is f for b, f in zip(got, frames))
    assert [[_meta(m) for m in b.metas] for b in out] == [
        [], [("VideoCaptionMeta", {"caption_type": "cea608-raw",
                                   "data": b"\x94\x2c"})], []]
    assert [[_meta(m) for m in b.metas] for b in anc_out] == [
        [], [], [("St2038Meta", {"data": anc})]]
