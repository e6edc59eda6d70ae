"""The port's supervisors, fallbacksrc, uriplaylistbin, debugsei and
transcriberbin against gstpu's, on the CPU.

Twins of every case of tests/test_supervise.py (its tracer cases on the
port's utils/tracing.py) and tests/test_fallbacksrc.py, the transcriberbin
and translationbin cases of test_cccombiner.py and the uriplaylistbin
cases of test_dash_playlist.py. Each twin is the gstpu test's body run once
with gstpu's names and once with the port's (`test_torch_captions.Pkg`): it
keeps the test's assertions and returns what it saw, and the two
packages' observations must be equal. Host code in both packages, so no
tolerance; timings, element names and host addresses, which differ from
run to run, are left out of what is compared. Then `chip_smoke.py`'s
phase 16b at 64x48 in both packages.
"""

import json
import re
import time
import types

import numpy as np
import pytest

import chip_smoke
import gstpu
import gstpu_torch
from test_torch_captions import (NAMES, Pkg, _both, _bufs, _capture, _feeder,
                                 _meta, _msgs, _start)
from torch_session import torch_test_limit  # noqa: F401

SECOND = 10 ** 9


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU."""
    gstpu.init()
    gstpu_torch.init(device="cpu")


def _no_digits(text):
    """Element names carry a per-package instance counter."""
    return re.sub(r"\d+", "#", text)


# ---------------------------------------------------------------------------
# fallbackswitch, livesync, togglerecord (tests/test_supervise.py)
# ---------------------------------------------------------------------------

def test_fallbackswitch_failover_and_recovery():
    def body(P):
        clock = P.mod("core.clock").TestClock()
        sw = P.make("fallbackswitch", timeout=SECOND)
        sw.clock, sw.base_time = clock, 0
        out = _capture(P, sw.static_pad("src"))
        main, backup = _feeder(P), _feeder(P)
        main.link(sw.request_pad())
        backup.link(sw.request_pad())
        _start(P, main, "application/x-test")
        _start(P, backup, "application/x-test")
        sw.set_state(P.State.PLAYING)
        main.push(P.Buffer(b"m0"))
        backup.push(P.Buffer(b"b0"))
        assert [b.to_bytes() for b in out] == [b"m0"]
        clock.advance(2 * SECOND)
        backup.push(P.Buffer(b"b1"))
        assert out[-1].to_bytes() == b"b1"
        main.push(P.Buffer(b"m1"))
        backup.push(P.Buffer(b"b2"))
        assert [b.to_bytes() for b in out] == [b"m0", b"b1", b"m1"]
        sw.set_state(P.State.NULL)
        return _bufs(out), sw.active_pad.name
    _both(body)


def test_fallbackswitch_posts_switch_message():
    def body(P):
        clock = P.mod("core.clock").TestClock()
        sw = P.make("fallbackswitch", timeout=SECOND)
        sw.clock, sw.bus = clock, P.el.Bus()
        out = _capture(P, sw.static_pad("src"))
        main, backup = _feeder(P), _feeder(P)
        main.link(sw.request_pad())
        backup.link(sw.request_pad())
        _start(P, main, "application/x-test")
        _start(P, backup, "application/x-test")
        main.push(P.Buffer(b"x"))
        clock.advance(3 * SECOND)
        backup.push(P.Buffer(b"y"))
        msgs = _msgs(P, sw.bus)
        assert [f["pad"] for _, f in msgs] == ["sink_0", "sink_1"]
        return msgs, _bufs(out)
    _both(body)


def test_livesync_fills_gap_event():
    def body(P):
        h = P.Harness(P.make("livesync", duration=40_000_000))
        h.set_caps("video/x-test")
        h.push(P.Buffer(b"f0", pts=0, duration=40_000_000))
        h.push_event(P.ev.GapEvent(40_000_000, 160_000_000))
        outs = h.pull_all()
        assert [o.pts for o in outs] == [0, 40_000_000, 80_000_000,
                                         120_000_000, 160_000_000]
        gap = P.mod("core.buffer").BufferFlags.GAP
        assert all(o.has_flag(gap) for o in outs[1:])
        assert h.element.duplicated == 4
        h.teardown()
        return _bufs(outs), [int(o.flags) for o in outs]
    _both(body)


def test_livesync_clock_driven_repeat():
    def body(P):
        clock = P.mod("core.clock").TestClock()
        ls = P.make("livesync", duration=10_000_000)
        ls.clock = clock
        out = _capture(P, ls.static_pad("src"))
        feed = _feeder(P)
        feed.link(ls.static_pad("sink"))
        _start(P, feed, "application/x-test")
        feed.push(P.Buffer(b"x", pts=0, duration=10_000_000))
        t = list(ls.iterate_tasks())[0]
        t.prepare()
        t.start()
        clock.advance(35_000_000)
        runs = 0
        while t.run_once().value == "continue":
            runs += 1
        assert len(out) >= 3 and out[1].pts == 10_000_000
        return _bufs(out), runs
    _both(body)


def test_livesync_drops_late():
    def body(P):
        h = P.Harness(P.make("livesync", duration=10))
        h.set_caps("x/y")
        h.push(P.Buffer(b"a", pts=100, duration=10))
        h.push(P.Buffer(b"b", pts=50, duration=10))
        outs = h.pull_all()
        assert len(outs) == 1 and h.element.dropped == 1
        h.teardown()
        return _bufs(outs)
    _both(body)


def test_togglerecord_keyframe_aligned_contiguous():
    def body(P):
        flags = P.mod("core.buffer").BufferFlags
        el = P.make("togglerecord")
        h = P.Harness(el)
        h.set_caps("video/x-test")
        MS = 1_000_000

        def frame(i, kf):
            b = P.Buffer(bytes([i]), pts=i * 10 * MS, duration=10 * MS)
            if not kf:
                b.set_flag(flags.DELTA_UNIT)
            return b
        for i in range(4):
            h.push(frame(i, kf=(i % 3 == 0)))
        assert not h.buffers
        el.set_property("record", True)
        h.push(frame(4, kf=False))
        h.push(frame(5, kf=False))
        assert not h.buffers
        for i in range(6, 10):
            h.push(frame(i, kf=(i == 6)))
        outs = h.pull_all()
        assert [b.to_bytes()[0] for b in outs] == [6, 7, 8, 9]
        assert [b.pts for b in outs] == [0, 10 * MS, 20 * MS, 30 * MS]
        el.set_property("record", False)
        h.push(frame(10, kf=True))
        el.set_property("record", True)
        h.push(frame(20, kf=True))
        out2 = h.pull()
        assert out2.pts == 40 * MS
        h.teardown()
        return _bufs(outs), _bufs([out2])
    _both(body)


def test_livesync_counters_and_late_threshold():
    def body(P):
        ls = P.make("livesync", duration=SECOND // 10,
                    late_threshold=2 * SECOND // 10)
        out = _capture(P, ls.static_pad("src"))
        feed = _feeder(P)
        feed.link(ls.static_pad("sink"))
        _start(P, feed, "application/x-test")
        ls.set_state(P.State.PLAYING)
        for data in (b"a", b"late1", b"late2", b"late3"):
            feed.push(P.Buffer(data, pts=0, duration=SECOND // 10))
        assert [b.to_bytes() for b in out] == [b"a", b"late3"]
        counts = [ls.get_property(n) for n in ("in", "drop", "out")]
        assert counts == [4, 2, 2]
        feed.push_event(P.ev.GapEvent(pts=SECOND // 10,
                                      duration=3 * SECOND // 10))
        after = [ls.get_property(n) for n in ("duplicate", "out")]
        assert after[0] >= 1 and after[1] > 2
        return _bufs(out), counts, after
    _both(body)


def test_livesync_late_threshold_never():
    def body(P):
        ls = P.make("livesync", duration=SECOND // 10, late_threshold=-1)
        out = _capture(P, ls.static_pad("src"))
        feed = _feeder(P)
        feed.link(ls.static_pad("sink"))
        _start(P, feed, "application/x-test")
        ls.set_state(P.State.PLAYING)
        feed.push(P.Buffer(b"a", pts=0, duration=SECOND // 10))
        for _ in range(50):
            feed.push(P.Buffer(b"late", pts=0, duration=SECOND // 10))
        assert [b.to_bytes() for b in out] == [b"a"]
        assert ls.get_property("drop") == 50
        return _bufs(out), ls.get_property("drop")
    _both(body)


def test_livesync_single_segment_eats_followups():
    def body(P):
        ls = P.make("livesync", single_segment=True)
        events = []
        sink = P.el.Pad("cap", P.el.PadDirection.SINK, P.el.PadTemplate(
            "sink", P.el.PadDirection.SINK, P.el.PadPresence.ALWAYS,
            P.Caps.any()))
        sink.chain_function = lambda pad, b: P.FlowReturn.OK
        sink.event_function = lambda pad, ev: (events.append(ev), True)[1]
        ls.static_pad("src").link(sink)
        feed = _feeder(P)
        feed.link(ls.static_pad("sink"))
        ls.set_state(P.State.PLAYING)
        feed.push_event(P.ev.StreamStartEvent("s"))
        for _ in range(3):
            feed.push_event(P.ev.SegmentEvent(P.ev.Segment()))
        segs = [e for e in events if isinstance(e, P.ev.SegmentEvent)]
        assert len(segs) == 1
        return [type(e).__name__ for e in events]
    _both(body)


def test_togglerecord_recording_readonly_property():
    def body(P):
        tr = P.make("togglerecord")
        out = _capture(P, tr.static_pad("src"))
        feed = _feeder(P)
        feed.link(tr.static_pad("sink"))
        _start(P, feed, "application/x-test")
        tr.set_state(P.State.PLAYING)
        assert tr.get_property("recording") is False
        with pytest.raises(PermissionError):
            tr.set_property("recording", True)
        notified = []
        tr.connect_notify("recording", lambda el, v: notified.append(v))
        tr.record = True
        feed.push(P.Buffer(b"k", pts=0, duration=SECOND // 30))
        assert tr.get_property("recording") is True and notified == [True]
        tr.record = False
        feed.push(P.Buffer(b"x", pts=SECOND // 30, duration=SECOND // 30))
        assert tr.get_property("recording") is False
        assert out and out[0].to_bytes() == b"k"
        return _bufs(out), notified
    _both(body)


def test_fallbacksrc_dummy_respects_enable_flags():
    def body(P):
        src = P.make("fallbacksrc", source="audiotestsrc wave=silence",
                     enable_dummy=True, enable_video=False)
        fb = src._make_fallback()
        assert fb is not None
        assert "audiotestsrc" in type(fb).__name__.lower() \
            or fb.list_properties().get("wave") is not None
        src2 = P.make("fallbacksrc", source="audiotestsrc",
                      enable_dummy=True)
        fb2 = src2._make_fallback()
        assert fb2 is not None and fb2 is not fb
        assert fb2.list_properties().get("pattern") is not None
        return fb.ELEMENT_NAME, fb2.ELEMENT_NAME
    _both(body)


# ---------------------------------------------------------------------------
# tracers and debugsei (tests/test_supervise.py)
# ---------------------------------------------------------------------------

def test_tracers_pad_push_timings(tmp_path):
    def body(P):
        tr = P.mod("utils.tracing")
        f = tmp_path / f"{P.name}.csv"
        t = tr.PadPushTimings(file=str(f))
        t.install()
        try:
            p = P.parse_launch("audiotestsrc num-buffers=3 ! fakesink")
            p.set_state(P.State.PLAYING)
            p.run()
            p.set_state(P.State.NULL)
            tr.flush_all()
            lines = f.read_text().strip().splitlines()
            assert lines[0] == "time,pad,duration_ns"
            assert len(lines) >= 4 and "audiotestsrc" in lines[1]
        finally:
            t.uninstall()
        return lines[0], [_no_digits(x.split(",")[1]) for x in lines[1:]]
    _both(body)


def test_tracer_env_activation(tmp_path, monkeypatch):
    def body(P):
        tr = P.mod("utils.tracing")
        f = tmp_path / f"{P.name}.csv"
        monkeypatch.setenv("GSTPU_TRACERS",
                           f"queue-levels(file={f});memory-tracer"
                           f"(file={tmp_path / (P.name + '-mem.csv')})")
        tracers = tr.init_from_env()
        try:
            assert len(tracers) == 2
            p = P.parse_launch("audiotestsrc num-buffers=3 ! queue ! "
                               "fakesink")
            p.set_state(P.State.PLAYING)
            p.run()
            p.set_state(P.State.NULL)
            tr.flush_all()
            lines = f.read_text().count("\n")
            assert lines >= 2
        finally:
            for t in tracers:
                t.uninstall()
        return [type(t).__name__ for t in tracers], lines
    _both(body)


def test_pipeline_snapshot_dot():
    def body(P):
        p = P.parse_launch("audiotestsrc num-buffers=1 ! identity ! "
                           "fakesink")
        dot = P.mod("utils.tracing").pipeline_snapshot(p)
        assert dot.startswith("digraph")
        assert "audiotestsrc" in dot and "->" in dot
        p.set_state(P.State.NULL)
        return _no_digits(dot)
    _both(body)


def test_debugsei_inserter_roundtrip():
    def body(P):
        sei = P.mod("elements.utils_.debugsei")
        h = P.Harness(P.make("debugseimetainserter", payload=b"frame-info-42"))
        h.set_caps("video/x-h264, stream-format=byte-stream")
        h.push(P.Buffer(b"\x00\x00\x00\x01\x65rest-of-frame"))
        out = h.pull().to_bytes()
        assert out.endswith(b"rest-of-frame")
        assert sei.parse_sei_unregistered(out) == [b"frame-info-42"]
        h.teardown()
        return out
    _both(body)


def test_debugsei_emulation_prevention():
    def body(P):
        sei = P.mod("elements.utils_.debugsei")
        tricky = b"\x00\x00\x00\x00\x01\x02"
        nal = sei.build_sei_unregistered(tricky)
        assert b"\x00\x00\x01" not in nal[4:]
        assert sei.parse_sei_unregistered(nal) == [tricky]
        return nal, sei.build_sei_unregistered(tricky, h265=True)
    _both(body)


def test_chrome_tracer(tmp_path):
    def body(P):
        tr = P.mod("utils.tracing")
        f = tmp_path / f"{P.name}.json"
        t = tr.ChromeTracer(file=str(f))
        t.install()
        try:
            p = P.parse_launch("audiotestsrc num-buffers=3 ! identity ! "
                               "fakesink")
            p.set_state(P.State.PLAYING)
            p.run()
            p.set_state(P.State.NULL)
            tr.flush_all()
            evs = json.loads(f.read_text())["traceEvents"]
            assert evs and all(e["ph"] == "X" and e["dur"] >= 0 for e in evs)
            assert any(e["name"].startswith("audiotestsrc") for e in evs)
        finally:
            t.uninstall()
        return [(_no_digits(e["name"]), e["ph"]) for e in evs]
    _both(body)


# ---------------------------------------------------------------------------
# fallbacksrc (tests/test_fallbacksrc.py)
# ---------------------------------------------------------------------------

def test_fallbacksrc_failover_and_retry():
    def body(P):
        clock = P.mod("core.clock").TestClock()
        fs = P.make("fallbacksrc",
                    source="audiotestsrc num-buffers=3 samplesperbuffer=100",
                    fallback_source="audiotestsrc wave=silence "
                                    "samplesperbuffer=100",
                    timeout=SECOND, restart_timeout=2 * SECOND)
        fs.clock = clock
        out = _capture(P, fs.static_pad("src"))
        fs.bus = P.el.Bus()
        assert fs.set_state(P.State.PLAYING).value != "failure"
        task = list(fs.iterate_tasks())[0]
        task.prepare()
        task.start()
        for _ in range(10):
            task.run_once()
        assert fs.stats["using-fallback"] is True
        assert fs.stats["num-fallback-switches"] == 1
        n_after_switch = len(out)
        task.run_once()
        assert len(out) > n_after_switch
        clock.advance(3 * SECOND)
        for _ in range(3):
            task.run_once()
        assert fs.stats["num-retry"] == 1
        assert fs.stats["using-fallback"] is False
        msgs = _msgs(P, fs.bus)
        assert any(f.get("using_fallback") for _, f in msgs)
        fs.set_state(P.State.NULL)
        return _bufs(out), n_after_switch, fs.statistics, msgs
    _both(body)


def test_fallbacksrc_requires_source():
    def body(P):
        fs = P.make("fallbacksrc")
        ret = fs.set_state(P.State.READY)
        assert ret is P.el.StateChangeReturn.FAILURE
        return ret.name
    _both(body)


def test_fallbacksrc_uri_and_dummy(tmp_path):
    def body(P):
        f = tmp_path / "clip.bin"
        f.write_bytes(bytes(range(64)))
        p = P.parse_launch("fallbacksrc name=fb ! appsink name=sink")
        fb = p.get_by_name("fb")
        fb.uri = f"file://{f}"
        sink = p.get_by_name("sink")
        p.set_state(P.State.PLAYING)
        p.run(timeout=20)
        outs = sink.pull_all()
        assert b"".join(b.to_bytes() for b in outs) == bytes(range(64))
        p.set_state(P.State.NULL)
        return _bufs(outs)
    _both(body)


def test_fallbacksrc_immediate_fallback():
    """The primary is `udpsrc port=0`, a source nobody sends to. The 5 s
    deadline only bounds a hang."""
    def body(P):
        p = P.parse_launch("fallbacksrc name=fb ! appsink name=sink")
        fb = p.get_by_name("fb")
        fb.source = "udpsrc port=0"
        fb.fallback_source = "audiotestsrc samplesperbuffer=64"
        fb.immediate_fallback = True
        fb.restart_timeout = 10 ** 12
        sink = p.get_by_name("sink")
        p.set_state(P.State.PLAYING)
        deadline = time.monotonic() + 5
        while not sink.samples and time.monotonic() < deadline:
            p.iterate()
            time.sleep(0.001)
        assert sink.samples and fb.statistics["using-fallback"]
        first = sink.samples[0]
        p.set_state(P.State.NULL)
        return first.to_bytes(), first.pts, fb.statistics["using-fallback"]
    _both(body)


def test_fallbacksrc_manual_unblock():
    def body(P):
        p = P.parse_launch("fallbacksrc name=fb ! appsink name=sink")
        fb = p.get_by_name("fb")
        fb.source = "audiotestsrc samplesperbuffer=64"
        fb.manual_unblock = True
        sink = p.get_by_name("sink")
        p.set_state(P.State.PLAYING)
        for _ in range(50):
            p.iterate()
        held = len(sink.samples)
        assert not held
        fb.emit("unblock")
        deadline = time.monotonic() + 5
        while not sink.samples and time.monotonic() < deadline:
            p.iterate()
            time.sleep(0.001)
        assert sink.samples
        first = sink.samples[0]
        p.set_state(P.State.NULL)
        return held, first.to_bytes(), first.pts
    _both(body)


def _supervised(P, **props):
    fs = P.make("fallbacksrc", **props)
    fs.bus = P.el.Bus()
    fs.clock = P.mod("core.clock").SystemClock()
    fs.base_time = fs.clock.time()
    return fs


def test_fallbacksrc_child_error_caught_and_reasons():
    def body(P):
        fs = _supervised(P, source="audiotestsrc samplesperbuffer=64",
                         fallback_source="audiotestsrc freq=200 "
                                         "samplesperbuffer=64",
                         timeout=10_000_000_000)
        sink = P.make("fakesink")
        fs.static_pad("src").link(sink.static_pad("sink"))
        sink.set_state(P.State.PLAYING)
        assert fs.start()
        tasks = list(fs.iterate_tasks())
        for t in tasks:
            t.prepare()
            t.start()
        for _ in range(5):
            tasks[0].run_once()
        fs._child_bus.post(P.el.Message(P.el.MessageType.ERROR,
                                        src=fs._primary, text="boom"))
        for _ in range(5):
            tasks[0].run_once()
        assert fs.stats["using-fallback"] is True
        assert fs.stats["last-retry-reason"] == "error"
        assert fs.status in ("retrying", "running")
        msgs = _msgs(P, fs.bus)
        assert not [m for m in msgs if m[0] == "error"]
        fs.stop()
        return fs.stats["last-retry-reason"], fs.status, msgs
    _both(body)


def test_fallbacksrc_buffering_percent_tracked():
    def body(P):
        fs = _supervised(P, source="audiotestsrc samplesperbuffer=64")
        sink = P.make("fakesink")
        fs.static_pad("src").link(sink.static_pad("sink"))
        sink.set_state(P.State.PLAYING)
        assert fs.start()
        tasks = list(fs.iterate_tasks())
        for t in tasks:
            t.prepare()
            t.start()
        seen = []
        for pct in (37, 100):
            fs._child_bus.post(P.el.Message(P.el.MessageType.BUFFERING,
                                            src=fs._primary, percent=pct))
            tasks[0].run_once()
            seen.append((fs.stats["buffering-percent"], fs.status))
        assert seen[0] == (37, "buffering") and seen[1][0] == 100
        fs.stop()
        return seen
    _both(body)


def test_fallbacksrc_image_fallback(tmp_path):
    image = pytest.importorskip("PIL.Image")
    img = tmp_path / "slate.png"
    image.fromarray(np.full((8, 12, 4), [10, 200, 30, 255], np.uint8),
                    "RGBA").save(img)

    def body(P):
        fs = _supervised(P, source="audiotestsrc samplesperbuffer=64",
                         fallback_uri=f"file://{img}",
                         immediate_fallback=True)
        got = []
        cap = P.el.Pad("sink", P.el.PadDirection.SINK, P.el.PadTemplate(
            "sink", P.el.PadDirection.SINK, P.el.PadPresence.ALWAYS,
            P.Caps.any()))
        cap.chain_function = lambda p, b: (got.append(b), P.FlowReturn.OK)[1]
        fs.static_pad("src").link(cap)
        assert fs.start()
        tasks = list(fs.iterate_tasks())
        for t in tasks:
            t.prepare()
            t.start()
        for _ in range(6):
            tasks[0].run_once()
        assert len(got) >= 3
        frame = got[0].array.reshape(8, 12, 4)
        assert (frame[0, 0] == [10, 200, 30, 255]).all()
        assert got[1].pts > got[0].pts
        fs.stop()
        return _bufs(got)
    _both(body)


# ---------------------------------------------------------------------------
# uriplaylistbin (tests/test_dash_playlist.py)
# ---------------------------------------------------------------------------

def _flac(P, path, pcm, rate):
    path.write_bytes(P.mod("codecs.flac").encode_verbatim(pcm, rate, 16))
    return f"file://{path}"


def test_uriplaylistbin_gapless(tmp_path):
    def body(P):
        rate = 8000
        files = [_flac(P, tmp_path / f"{P.name}{k}.flac",
                       (np.ones((rate, 1)) * 1000 * k).astype(np.int16), rate)
                 for k in (1, 2)]
        p = P.parse_launch("uriplaylistbin name=pl ! appsink name=sink")
        p.get_by_name("pl").set_property("uris", files)
        sink = p.get_by_name("sink")
        p.set_state(P.State.PLAYING)
        p.run(timeout=60)
        bufs = sink.pull_all()
        assert sink.is_eos
        info = P.mod("core.audio").AudioInfo.from_caps(sink.caps)
        assert sum(info.view(b).shape[0] for b in bufs) == 2 * rate
        pts = [b.pts for b in bufs]
        assert pts == sorted(pts) and pts[0] == 0
        mid = next(i for i, b in enumerate(bufs)
                   if info.view(b)[0, 0] == 2000)
        assert abs(bufs[mid].pts - SECOND) < 2_000_000
        p.set_state(P.State.NULL)
        return repr(sink.caps), _bufs(bufs)
    _both(body)


def test_uriplaylistbin_loops(tmp_path):
    def body(P):
        rate = 8000
        uri = _flac(P, tmp_path / f"{P.name}.flac",
                    np.zeros((rate // 2, 1), np.int16), rate)
        p = P.parse_launch("uriplaylistbin name=pl ! appsink name=sink")
        p.get_by_name("pl").set_property("uris", [uri])
        p.get_by_name("pl").set_property("iterations", 3)
        sink = p.get_by_name("sink")
        p.set_state(P.State.PLAYING)
        p.run(timeout=60)
        bufs = sink.pull_all()
        info = P.mod("core.audio").AudioInfo.from_caps(sink.caps)
        assert sum(info.view(b).shape[0] for b in bufs) == 3 * rate // 2
        p.set_state(P.State.NULL)
        return _bufs(bufs)
    _both(body)


# ---------------------------------------------------------------------------
# transcriberbin and translationbin (tests/test_cccombiner.py)
# ---------------------------------------------------------------------------

def _text_transform(P, reply):
    """A text/x-raw element whose output is `reply(input bytes)`."""
    base, el = P.mod("core.base"), P.el
    text = P.Caps.new("text/x-raw", format="utf8")

    class Text(base.BaseTransform):
        PAD_TEMPLATES = [
            el.PadTemplate("sink", el.PadDirection.SINK,
                           el.PadPresence.ALWAYS, text.copy()),
            el.PadTemplate("src", el.PadDirection.SRC,
                           el.PadPresence.ALWAYS, text.copy())]

        def transform_caps(self, direction, caps, filter):
            out = P.Caps.new("text/x-raw", format="utf8")
            return filter.intersect(out) if filter is not None else out

        def transform(self, buf):
            return P.Buffer(reply(buf.to_bytes()), pts=buf.pts,
                            duration=buf.duration)
    return Text


def _transcriber(P, word):
    base, el = P.mod("core.base"), P.el

    class Transcriber(base.BaseTransform):
        PAD_TEMPLATES = [
            el.PadTemplate("sink", el.PadDirection.SINK,
                           el.PadPresence.ALWAYS, P.Caps.new("audio/x-raw")),
            el.PadTemplate("src", el.PadDirection.SRC, el.PadPresence.ALWAYS,
                           P.Caps.new("text/x-raw", format="utf8"))]

        def transform_caps(self, direction, caps, filter):
            out = (P.Caps.new("text/x-raw", format="utf8")
                   if direction is el.PadDirection.SINK
                   else P.Caps.new("audio/x-raw"))
            return filter.intersect(out) if filter is not None else out

        def transform(self, buf):
            return P.Buffer(word, pts=buf.pts, duration=buf.duration)
    return Transcriber


@pytest.fixture
def mocks():
    """gstpu's test elements (a transcriber that says HELLO, one that says
    WORLD, a translator that says HOLA, one that upper-cases and adds -FR)
    in both registries, taken out again afterwards so that no other test
    counts them."""
    added = []
    for name in NAMES:
        P = Pkg(name)
        reg = P.mod("core.registry")
        for factory, cls in (
                ("mocktranscriber", _transcriber(P, b"HELLO")),
                ("mockworld", _transcriber(P, b"WORLD")),
                ("mocktranslator", _text_transform(P, lambda b: b"HOLA")),
                ("mockupper", _text_transform(P, lambda b: b.upper()
                                              + b"-FR"))):
            if factory not in reg._registry:
                reg.register_element(factory, reg.Rank.NONE)(cls)
                added.append((reg._registry, factory))
    yield
    for registry, factory in added:
        registry.pop(factory, None)


ACAPS = "audio/x-raw, format=S16LE, rate=48000, channels=1"
VCAPS = "video/x-raw, format=RGBA, width=4, height=4, framerate=30/1"


def _frame(P, pts, *metas):
    b = P.VideoInfo("RGBA", 4, 4).make_buffer(np.zeros((4, 4, 4), np.uint8),
                                              pts=pts, duration=SECOND)
    for m in metas:
        b.add_meta(m)
    return b


def _wired(P, tb):
    vout = _capture(P, tb.static_pad("src_video"))
    aout = _capture(P, tb.static_pad("src_audio"))
    tb.set_state(P.State.PLAYING)
    af, vf = _feeder(P), _feeder(P)
    af.link(tb.static_pad("sink_audio"))
    vf.link(tb.static_pad("sink_video"))
    _start(P, af, ACAPS)
    _start(P, vf, VCAPS)
    return af, vf, aout, vout


def _run_tb(P, tb, n_audio=1, n_video=1):
    af, vf, aout, vout = _wired(P, tb)
    for i in range(n_audio):
        af.push(P.Buffer(bytes(96), pts=i * SECOND, duration=SECOND))
    af.push_event(P.ev.EosEvent())
    for i in range(n_video):
        vf.push(_frame(P, i * SECOND))
    vf.push_event(P.ev.EosEvent())
    return aout, vout


def _captions(P, buf):
    return [m for m in buf.metas if isinstance(m, P.VideoCaptionMeta)]


def _608_text(P, buf):
    dec = P.mod("codecs.cea608").Cea608Decoder()
    text = None
    for m in _captions(P, buf):
        text = dec.push_pair(m.data) or text
    return text


def _seen(P, aout, vout):
    return _bufs(aout), [(b.pts, [_meta(m) for m in b.metas]) for b in vout]


def test_transcriberbin_with_mock_transcriber(mocks):
    def body(P):
        tb = P.make("transcriberbin", transcriber="mocktranscriber")
        aout, vout = _run_tb(P, tb)
        assert len(aout) == 1 and len(vout) == 1
        assert _captions(P, vout[0])
        assert _608_text(P, vout[0]) == "HELLO"
        return _seen(P, aout, vout)
    _both(body)


def test_transcriberbin_passthrough_without_transcriber():
    def body(P):
        tb = P.make("transcriberbin")
        vout = _capture(P, tb.static_pad("src_video"))
        tb.set_state(P.State.PLAYING)
        vf = _feeder(P)
        vf.link(tb.static_pad("sink_video"))
        _start(P, vf, VCAPS)
        vf.push(P.Buffer(bytes(64), pts=0))
        assert len(vout) == 1 and not vout[0].metas
        return _bufs(vout)
    _both(body)


def test_translationbin_splices_translator(mocks):
    def body(P):
        tb = P.make("translationbin", transcriber="mocktranscriber",
                    translator="mocktranslator")
        aout, vout = _run_tb(P, tb)
        assert _608_text(P, vout[0]) == "HOLA"
        tb.set_state(P.State.NULL)
        return _seen(P, aout, vout)
    _both(body)


def test_transcriberbin_cea708_translation_services(mocks):
    def body(P):
        tb = P.make("transcriberbin", transcriber="mocktranscriber",
                    mux_method="cea708")
        tb.translation_languages = {"fr": 2}
        tb.translators = {"fr": "mockupper"}
        aout, vout = _run_tb(P, tb)
        assert len(vout) == 1 and _captions(P, vout[0])
        c = P.mod("codecs.cea708")
        texts = {}
        _, packets = c.ccdata_split(b"".join(m.data for m in
                                             _captions(P, vout[0])))
        for pkt in packets:
            for svc, payload in c.parse_dtvcc(pkt)[1]:
                t = c.service_block_text(payload)
                if t:
                    texts[svc] = texts.get(svc, "") + t
        assert texts.get(1) == "HELLO" and texts.get(2) == "HELLO-FR"
        return _seen(P, aout, vout), texts
    _both(body)


def test_transcriberbin_live_passthrough_toggle(mocks):
    def body(P):
        tb = P.make("transcriberbin", transcriber="mocktranscriber")
        tb.passthrough = True
        aout, vout = _run_tb(P, tb)
        assert len(vout) == 1 and not _captions(P, vout[0])
        return _seen(P, aout, vout)
    _both(body)


def test_transcriberbin_caption_source_inband(mocks):
    def body(P):
        seen = []
        for source, keep_inband, expect_transcript in (
                ("inband", True, False), ("transcription", False, True)):
            tb = P.make("transcriberbin", transcriber="mocktranscriber",
                        caption_source=source)
            af, vf, aout, vout = _wired(P, tb)
            af.push(P.Buffer(bytes(96), pts=0, duration=SECOND))
            af.push_event(P.ev.EosEvent())
            vf.push(_frame(P, 0, P.VideoCaptionMeta("cea608-raw",
                                                    b"\xaa\xbb")))
            vf.push_event(P.ev.EosEvent())
            assert len(vout) == 1
            metas = _captions(P, vout[0])
            inband = [m for m in metas if m.data == b"\xaa\xbb"]
            assert bool(inband) == keep_inband, source
            assert bool([m for m in metas if m.data != b"\xaa\xbb"]) \
                == expect_transcript, source
            seen.append(_seen(P, aout, vout))
        return seen
    _both(body)


def test_transcriberbin_cea608_channel_routing(mocks):
    def body(P):
        tb = P.make("transcriberbin", transcriber="mocktranscriber",
                    mux_method="cea608")
        tb.translation_languages = {"fr": "cc3"}
        tb.translators = {"fr": "mockupper"}
        aout, vout = _run_tb(P, tb)
        metas = _captions(P, vout[0])
        assert len(vout) == 1 and metas
        assert metas[0].caption_type == "cea608-s334-1a"
        cea608 = P.mod("codecs.cea608")
        decs = {0: cea608.Cea608Decoder(), 1: cea608.Cea608Decoder()}
        texts = {0: None, 1: None}
        for m in metas:
            d = m.data
            for i in range(0, len(d) - 2, 3):
                field = 0 if d[i] & 0x80 else 1
                t = decs[field].push_pair(d[i + 1:i + 3])
                if t:
                    texts[field] = t
        assert texts == {0: "HELLO", 1: "HELLO-FR"}
        return _seen(P, aout, vout)
    _both(body)


def test_transcriberbin_live_transcriber_swap(mocks):
    def body(P):
        tb = P.make("transcriberbin", transcriber="mocktranscriber")
        af, vf, aout, vout = _wired(P, tb)

        def one_frame(i):
            af.push(P.Buffer(bytes(96), pts=i * SECOND, duration=SECOND))
            vf.push(_frame(P, i * SECOND))
        one_frame(0)
        tb.transcriber = "mockworld"
        one_frame(1)
        af.push_event(P.ev.EosEvent())
        vf.push_event(P.ev.EosEvent())
        assert len(vout) == 2
        assert [_608_text(P, b) for b in vout] == ["HELLO", "WORLD"]
        tb.set_state(P.State.NULL)
        return _seen(P, aout, vout)
    _both(body)


def test_transcriberbin_latency_query(mocks):
    def body(P):
        tb = P.make("transcriberbin", transcriber="mocktranscriber",
                    latency=1500)
        _capture(P, tb.static_pad("src_video"))
        _capture(P, tb.static_pad("src_audio"))
        tb.set_state(P.State.PLAYING)
        af, vf = _feeder(P), _feeder(P)
        af.link(tb.static_pad("sink_audio"))
        vf.link(tb.static_pad("sink_video"))
        vf.query_function = lambda p, q: True
        LatencyQuery = P.mod("core.query").LatencyQuery
        pad = tb.static_pad("src_video")
        lat = []
        for passthrough in (False, True):
            tb.passthrough = passthrough
            q = LatencyQuery()
            assert pad.query_function(pad, q)
            lat.append((q.min_latency, q.max_latency))
        assert [x for x, _ in lat] == [1_500_000_000, 0]
        tb.set_state(P.State.NULL)
        return lat
    _both(body)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 16b at 64x48, both packages
# ---------------------------------------------------------------------------

def test_phase16_supervisors(tmp_path):
    """16b's stepped sequences at 64x48: the outputs (source, input index,
    pts, flags) and the switch's messages equal in both packages and are
    the sequence the phase expects; every output holds the very payload
    that came in, the main frames the grade's tensors on the port; neither
    supervisor calls `Buffer.array`."""
    cube = tmp_path / "g.cube"
    chip_smoke.write_cube(cube, np.random.default_rng(16), n=9)
    ref = chip_smoke.supervise_run(types.SimpleNamespace(
        __name__="gstpu", init=lambda device=None: gstpu.init(),
        parse_launch=gstpu.parse_launch, State=gstpu.State), "cpu", 64, 48,
        cube)
    with chip_smoke.ArrayCalls() as calls:
        port = chip_smoke.supervise_run(gstpu_torch, "cpu", 64, 48, cube)
    dur = SECOND // 30
    switch = port["fallbackswitch"]
    assert switch["records"] == ref["fallbackswitch"]["records"]
    assert switch["messages"] == ref["fallbackswitch"]["messages"] \
        == ["sink_0", "sink_1", "sink_0"]
    assert [(s, i) for s, i, _, _ in switch["records"]] == \
        [("main", i) for i in range(6)] + [("backup", i) for i in range(6, 10)] \
        + [("main", i) for i in range(6, 16)]
    record = port["togglerecord"]["records"]
    assert record == ref["togglerecord"]["records"]
    assert [(i, pts) for _, i, pts, _ in record] == [
        (i, k * dur) for k, i in enumerate([4, 5, 6, 7, 8, 12, 13, 14, 15])]
    kinds = {(r[0], k) for name in ("fallbackswitch", "togglerecord")
             for r, k in zip(port[name]["records"], port[name]["payloads"])}
    assert kinds == {("main", "tensor on cpu"), ("backup", "ndarray")}
    assert calls.by_element().get("sw", 0) == 0
    assert calls.by_element().get("tr", 0) == 0
