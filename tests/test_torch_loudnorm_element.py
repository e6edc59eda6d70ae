"""The port's host `audioloudnorm` and `ebur128level` elements (no
`context`) and its `EbuR128` meter against gstpu's, on the CPU.

The host path is a numpy copy of gstpu's, so the same launch strings
give the same samples, timestamps and level-message fields bit for bit.
Twins of tests/test_loudnorm.py (the reference scenarios: output at -24
LUFS within 1 LU, sample peak <= -2 dBFS, every sample kept, <= 1 ns
timestamp drift; the vectorized state against the literal
transcription) and tests/test_ebur128level.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.core.element import MessageType as JaxMessageType
from gstpu.ops.ebur128 import EbuR128 as JaxEbuR128
from gstpu_torch.core.audio import AudioInfo
from gstpu_torch.core.element import MessageType
from gstpu_torch.core.query import LatencyQuery
from gstpu_torch.elements.audio.loudnorm import _LoudNormState
from gstpu_torch.ops.ebur128 import EbuR128
from gstpu_torch.runtime.device_batch import DeviceContext

RATE = 192_000
NEG_INF = float("-inf")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    gstpu_torch.init(device="cpu")


def _ticks(n, periods_per_tick, tick_interval_s=4.0, freq=440.0):
    t = np.arange(n) / RATE
    sig = np.sin(2 * np.pi * freq * t)
    tick_period = int(tick_interval_s * RATE)
    tick_len = int(round(periods_per_tick * RATE / freq))
    mask = (np.arange(n) % tick_period) < tick_len
    return sig * mask


def _limiter_mix(periods_per_tick):
    def mix(n):
        t = np.arange(n) / RATE
        quiet = 0.05 * np.sin(2 * np.pi * 440.0 * t)
        return quiet + 0.8 * _ticks(n, periods_per_tick=periods_per_tick)
    return mix


def _run(pkg, src_desc, num_buffers, samples_per_buffer, channels,
         mix_signal=None, as_tensor=False):
    """The scenario's pipeline in `pkg`: (output buffers, sink EOS)."""
    fmt = f"audio/x-raw, format=F64LE, rate={RATE}, channels={channels}"
    if mix_signal is None:
        p = pkg.parse_launch(
            f"audiotestsrc {src_desc} num-buffers={num_buffers} "
            f"samplesperbuffer={samples_per_buffer} ! {fmt} "
            f"! audioloudnorm ! appsink name=sink")
    else:
        p = pkg.parse_launch(f'appsrc name=src caps="{fmt}" ! '
                             f'audioloudnorm ! appsink name=sink')
        src = p.get_by_name("src")
        n = num_buffers * samples_per_buffer
        total = mix_signal(n)
        for off in range(0, n, samples_per_buffer):
            chunk = np.repeat(total[off:off + samples_per_buffer, None],
                              channels, axis=1)
            if as_tensor:
                chunk = torch.from_numpy(chunk)
            src.push_buffer(pkg.Buffer(chunk, pts=off * 1_000_000_000
                                       // RATE))
        src.end_of_stream()
    sink = p.get_by_name("sink")
    p.set_state(pkg.State.PLAYING)
    p.run(timeout=600)
    bufs = sink.pull_all()
    eos = sink.is_eos
    p.set_state(pkg.State.NULL)
    return bufs, eos


SCENARIOS = {
    "basic": ("wave=sine", 530, 1920, 1, -24.0, None, 1.0),
    "basic_white_noise": ("wave=white-noise", 530, 1920, 1, -24.0, None,
                          1.0),
    "remaining_at_eos": ("wave=sine", 1000, 1024, 1, -24.0, None, 1.0),
    "short_input": ("wave=sine", 100, 1024, 1, -24.0, None, 1.0),
    "basic_two_channels": ("wave=sine", 530, 1920, 2, -24.0, None, 1.0),
    "silence": ("wave=silence", 1000, 1024, 1, NEG_INF, None, 1.0),
    "quiet": ("wave=sine volume=0.5", 1000, 1024, 1, -24.0, None, 1.0),
    "very_quiet": ("wave=sine volume=0.1", 1000, 1024, 1, -24.0, None, 1.0),
    "very_very_quiet": ("wave=sine volume=0.01", 1000, 1024, 1, -24.0, None,
                        1.0),
    "below_threshold": ("wave=sine volume=0.00045", 1000, 1024, 1, NEG_INF,
                        None, 1.0),
    "limiter": ("", 1000, 1024, 1, -24.0, _limiter_mix(1), 1.0),
    # tolerance 1.2 as gstpu's test: the synthetic tick mix measures
    # -25.07, not the C audiotestsrc's ticks
    "limiter_on_first_frame": ("", 1000, 1024, 1, -24.0, _limiter_mix(10),
                               1.2),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_loudnorm_scenario_matches_gstpu(name):
    desc, nbuf, spb, ch, expected, mix, tol = SCENARIOS[name]
    bufs, eos = _run(gstpu_torch, desc, nbuf, spb, ch, mix)
    jbufs, jeos = _run(gstpu, desc, nbuf, spb, ch, mix)
    assert eos and jeos
    assert [b.pts for b in bufs] == [b.pts for b in jbufs]
    info = AudioInfo(format="F64LE", rate=RATE, channels=ch)
    out = [info.view(b) for b in bufs]
    for a, b in zip(out, jbufs):
        np.testing.assert_array_equal(a, np.asarray(b.array).reshape(a.shape))
    # the reference's own checks, on the port's output
    meter = EbuR128(ch, RATE, frozenset(("I", "sample_peak")))
    num_samples, expected_ts = 0, 0
    for b, frames in zip(bufs, out):
        assert abs(b.pts - expected_ts) <= 1
        num_samples += frames.shape[0]
        meter.add_frames(frames)
        expected_ts += frames.shape[0] * 1_000_000_000 // RATE
    assert num_samples == nbuf * spb
    loudness = meter.loudness_global()
    if expected == NEG_INF:
        assert loudness == NEG_INF
    else:
        assert abs(loudness - expected) < tol, loudness
    for c in range(ch):
        assert 20 * np.log10(max(meter.sample_peak(c), 1e-12)) \
            <= -2.0 + 1e-6


def test_loudnorm_reads_tensor_buffers_once():
    """A tensor payload reaches the host path as its numpy twin: the
    same samples as host buffers, bit for bit."""
    args = ("", 400, 1024, 1, -24.0, _limiter_mix(10))
    host, _ = _run(gstpu_torch, *args[:4], mix_signal=args[5])
    tens, _ = _run(gstpu_torch, *args[:4], mix_signal=args[5],
                   as_tensor=True)
    assert len(host) == len(tens) > 0
    for a, b in zip(host, tens):
        assert a.pts == b.pts
        np.testing.assert_array_equal(np.asarray(a.array),
                                      np.asarray(b.array))


def test_latency_reported():
    """The 3 s gain lookahead, answered on the src pad as gstpu's
    harness asks it (its query function, the element unlinked)."""
    el = gstpu_torch.make("audioloudnorm")
    q = LatencyQuery()
    assert el.srcpad.query_function(el.srcpad, q)
    assert q.min_latency == 3 * 1_000_000_000


def test_vectorized_matches_literal():
    """The port's host state is sample-identical to the literal
    per-sample transcription of the reference algorithm."""
    sys.path.insert(0, os.path.dirname(__file__))
    from literal_loudnorm import LiteralState

    n = int(3.5 * RATE)
    x = _limiter_mix(10)(n)
    lit = LiteralState(1)
    vec = _LoudNormState(dict(loudness_target=-24.0,
                              loudness_range_target=7.0,
                              max_true_peak=-2.0, offset=0.0),
                         AudioInfo("F64LE", RATE, 1))
    off = 0
    while n - off >= vec.current_samples_per_frame:
        take = vec.current_samples_per_frame
        src = x[off:off + take]
        ov, _ = vec.process(src, 0)
        np.testing.assert_array_equal(ov, lit.process(src))
        off += take


def test_stop_leaves_the_context():
    """One `stop` for both paths: a context member leaves its context
    (gstpu's second `stop` definition shadows the first, so its
    element never does) and the host state is dropped."""
    DeviceContext.release("ln-stop")
    el = gstpu_torch.make("audioloudnorm", context="ln-stop")
    el.set_state(gstpu_torch.State.READY)
    ctx = DeviceContext.acquire("ln-stop")
    assert ctx.member_for(el) is not None
    el.set_state(gstpu_torch.State.NULL)
    assert ctx.member_for(el) is None
    assert "ln-stop" not in DeviceContext._registry


@pytest.mark.parametrize("rate,channels,modes", [
    (48_000, 2, ("I", "S", "M", "LRA", "sample_peak", "true_peak")),
    (96_000, 1, ("I", "S", "M", "true_peak")),
    (192_000, 3, ("I", "S", "sample_peak")),
])
def test_ebur128_meter_matches_gstpu(rate, channels, modes):
    """The port's host meter is gstpu's: every query bit for bit after
    ragged feeds, over more than one LRA window."""
    rng = np.random.default_rng(rate + channels)
    meters = (EbuR128(channels, rate, frozenset(modes)),
              JaxEbuR128(channels, rate, frozenset(modes)))
    t = np.arange(4 * rate) / rate
    x = (0.3 * np.sin(2 * np.pi * 997.0 * t)[:, None]
         * (1.0 + 0.5 * np.sin(2 * np.pi * 0.7 * t))[:, None]
         + 0.01 * rng.standard_normal((t.size, channels)))
    off = 0
    for n in rng.integers(1, rate // 3, 40):
        for m in meters:
            m.add_frames(x[off:off + n])
        off += int(n)
        if off >= t.size:
            break
    a, b = meters
    for q in ("loudness_momentary", "loudness_shortterm", "loudness_global",
              "relative_threshold", "loudness_range"):
        assert getattr(a, q)() == getattr(b, q)(), q
    for c in range(channels):
        assert a.sample_peak(c) == b.sample_peak(c)
        assert a.true_peak(c) == b.true_peak(c)


def _level_messages(pkg, msg_type, launch):
    p = pkg.parse_launch(launch)
    p.set_state(pkg.State.PLAYING)
    p.run()
    msgs = [m.fields for m in p.bus.drain()
            if m.type is msg_type.ELEMENT and m.name == "ebur128-level"]
    bufs = p.get_by_name("sink").pull_all()
    p.set_state(pkg.State.NULL)
    return msgs, bufs


def test_level_messages_match_gstpu():
    """3 s of a 997 Hz sine at 0.5 through the passthrough meter: three
    messages, each field equal to gstpu's, the reference's values (see
    tests/test_ebur128level.py), and the data unmodified."""
    launch = ("audiotestsrc freq=997 volume=0.5 num-buffers=300 "
              "samplesperbuffer=480 "
              "! audio/x-raw, format=F64LE, rate=48000, channels=2 "
              "! ebur128level interval=1000000000 ! appsink name=sink")
    msgs, bufs = _level_messages(gstpu_torch, MessageType, launch)
    jmsgs, jbufs = _level_messages(gstpu, JaxMessageType, launch)
    assert len(msgs) == len(jmsgs) == 3
    for m, jm in zip(msgs, jmsgs):
        assert set(m) == set(jm)
        for k in m:
            if k != "name":
                assert m[k] == jm[k], k
    last = msgs[-1]
    assert abs(last["momentary-loudness"] - (-6.02)) < 0.3
    assert abs(last["global-loudness"] - (-6.02)) < 0.3
    assert last["loudness-range"] < 1.0
    assert msgs[0]["timestamp"] == 1_000_000_000
    assert len(bufs) == len(jbufs) == 300
    for a, b in zip(bufs, jbufs):
        np.testing.assert_array_equal(np.asarray(a.array),
                                      np.asarray(b.array))


def test_level_mode_subset_matches_gstpu():
    launch = ("audiotestsrc num-buffers=120 samplesperbuffer=480 "
              "! audio/x-raw, format=F32LE, rate=48000, channels=1 "
              "! ebur128level mode=momentary,sample-peak "
              "! appsink name=sink")
    msgs, _ = _level_messages(gstpu_torch, MessageType, launch)
    jmsgs, _ = _level_messages(gstpu, JaxMessageType, launch)
    assert msgs and len(msgs) == len(jmsgs)
    assert "momentary-loudness" in msgs[0]
    assert "global-loudness" not in msgs[0]
    assert "sample-peak" in msgs[0]
    for m, jm in zip(msgs, jmsgs):
        assert {k: v for k, v in m.items() if k != "name"} == \
            {k: v for k, v in jm.items() if k != "name"}
