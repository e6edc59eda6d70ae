"""The port's G.711 transcoders, `rsagingradio` and the AC-4/SMPTE 302M
parsers against gstpu's, on the CPU.

Twins of tests/test_native_g711.py and of the aging-radio and parser
cases of tests/test_rtp_video_aging.py: the same seeded inputs and launch
strings go through gstpu and through gstpu_torch, and the bytes, caps and
timestamps must be equal. These modules are host numpy, scipy and the
native library in both packages, so any difference is a fault of the
copy: nothing here has a tolerance. The PCMA payloader loopback's twin is
in test_torch_rtp.py.
"""

import zlib

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu import native as jnative
from gstpu.core.audio import AudioInfo as JAudioInfo
from gstpu.core.harness import Harness as JHarness
from gstpu_torch import native
from gstpu_torch.core.audio import AudioInfo
from gstpu_torch.core.harness import Harness
from torch_session import torch_test_limit  # noqa: F401

PACKAGES = {"gstpu": (gstpu, JAudioInfo, JHarness),
            "gstpu_torch": (gstpu_torch, AudioInfo, Harness)}


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU."""
    gstpu.init()
    gstpu_torch.init(device="cpu")


def _run(name: str, launch: str):
    """A launch string in one package: caps string, every buffer's bytes,
    pts and duration at `sink`, and the samples."""
    pkg, info_cls, _ = PACKAGES[name]
    p = pkg.parse_launch(launch)
    s = p.get_by_name("sink")
    p.set_state(pkg.State.PLAYING)
    p.run()
    bufs = s.pull_all()
    samples = None
    if s.caps[0].name == "audio/x-raw":
        info = info_cls.from_caps(s.caps)
        samples = np.concatenate([info.view(b) for b in bufs])
    out = (repr(s.caps), [(b.to_bytes(), b.pts, b.duration) for b in bufs],
           samples)
    p.set_state(pkg.State.NULL)
    return out


def _run_both(launch: str):
    got = {name: _run(name, launch) for name in PACKAGES}
    ref, port = got["gstpu"], got["gstpu_torch"]
    assert port[:2] == ref[:2]
    return port[2]


# ---------------------------------------------------------------------------
# the native library (tests/test_native_g711.py)
# ---------------------------------------------------------------------------

def test_native_available_and_crc():
    assert native.available()
    rng = np.random.default_rng(711)
    data = rng.integers(0, 256, 4099, np.uint8).tobytes()
    fox = b"The quick brown fox jumps over the lazy dog"
    assert native.crc32(fox) == zlib.crc32(fox)
    assert native.crc32c(b"123456789") == 0xE3069283  # RFC test vector
    for d in (fox, data, b""):
        for seed in (0, 0x1234ABCD):
            assert native.crc32(d, seed) == jnative.crc32(d, seed)
            assert native.crc32c(d, seed) == jnative.crc32c(d, seed)


@pytest.fixture
def no_native(monkeypatch):
    """The port's module as it is where the library cannot be built."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "load", lambda: None)


def test_crc_fallback_matches_the_library(no_native):
    data = np.random.default_rng(32).integers(0, 256, 1031,
                                              np.uint8).tobytes()
    assert [native.crc32(data, 7), native.crc32c(data, 7)] == \
        [jnative.crc32(data, 7), jnative.crc32c(data, 7)]


def test_native_fallback_bit_parity(no_native):
    """Every 16-bit sample: the port's numpy tables give the codes of
    gstpu's library, and every code decodes to the same sample."""
    pcm = np.arange(-32768, 32768, dtype=np.int16)
    codes = np.arange(256, dtype=np.uint8)
    fb = (native.alaw_encode(pcm), native.mulaw_encode(pcm),
          native.alaw_decode(codes), native.mulaw_decode(codes))
    ref = (jnative.alaw_encode(pcm), jnative.mulaw_encode(pcm),
           jnative.alaw_decode(codes), jnative.mulaw_decode(codes))
    for a, b in zip(fb, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_native_library_matches_gstpu():
    assert native.load() is not None
    pcm = np.arange(-32768, 32767, 13, dtype=np.int16)
    codes = np.random.default_rng(3).integers(0, 256, 4000, np.uint8)
    for ours, theirs, x in (
            (native.alaw_encode, jnative.alaw_encode, pcm),
            (native.mulaw_encode, jnative.mulaw_encode, pcm),
            (native.alaw_decode, jnative.alaw_decode, codes),
            (native.mulaw_decode, jnative.mulaw_decode, codes)):
        np.testing.assert_array_equal(ours(x), theirs(x))


def test_g711_quantization_bounds():
    pcm = np.linspace(-30000, 30000, 5000).astype(np.int16)
    for enc, dec, jenc, jdec in (
            (native.alaw_encode, native.alaw_decode, jnative.alaw_encode,
             jnative.alaw_decode),
            (native.mulaw_encode, native.mulaw_decode, jnative.mulaw_encode,
             jnative.mulaw_decode)):
        rec = dec(enc(pcm))
        np.testing.assert_array_equal(rec, jdec(jenc(pcm)))
        rec = rec.astype(np.int32)
        rel = np.abs(rec - pcm) / np.maximum(np.abs(pcm.astype(np.int32)),
                                             256)
        assert rel.max() < 0.05  # logarithmic companding ~3%


@pytest.mark.parametrize("law", ["alaw", "mulaw"])
def test_g711_elements(law):
    """tests/test_native_g711.py::test_mulaw_elements, and the A-law pair
    the RTP loopback runs: both packages give the same codes and
    samples."""
    base = ("audiotestsrc num-buffers=4 samplesperbuffer=80 freq=400 "
            "! audio/x-raw, format=S16LE, rate=8000, channels=1 ")
    _run_both(base + f"! {law}enc ! appsink name=sink")
    out = _run_both(base + f"! {law}enc ! {law}dec ! appsink name=sink")
    assert out.shape == (4 * 80, 1) and out.dtype == np.int16


def test_g711_any_rate_and_channels():
    """192 kHz stereo through both transcoders, as the flagship's output
    reaches them on the card."""
    out = _run_both(
        "audiotestsrc num-buffers=3 samplesperbuffer=1920 freq=1000 "
        "! audio/x-raw, format=S16LE, rate=192000, channels=2 "
        "! alawenc ! alawdec ! mulawenc ! mulawdec ! appsink name=sink")
    assert out.shape == (3 * 1920, 2)


# ---------------------------------------------------------------------------
# rsagingradio (tests/test_rtp_video_aging.py)
# ---------------------------------------------------------------------------

def test_agingradio_degrades_signal():
    out = _run_both(
        "audiotestsrc freq=440 num-buffers=20 samplesperbuffer=480 "
        "! audio/x-raw, format=F32LE, rate=48000, channels=1 "
        "! rsagingradio ! appsink name=sink")[:, 0]
    assert out.shape[0] == 20 * 480
    assert len(np.unique(np.round(out * 16))) < 40
    assert np.abs(out).max() > 0.1


@pytest.mark.parametrize("freq", [500, 12000])
def test_agingradio_lowpass(freq):
    _run_both(
        f"audiotestsrc freq={freq} num-buffers=20 "
        "samplesperbuffer=480 ! audio/x-raw, format=F64LE, "
        "rate=48000, channels=1 ! rsagingradio white-noise-ampl=0 "
        "clicks-prob=0 bits-to-quantize=32 cubic-curve-passes=0 "
        "! appsink name=sink")


def test_agingradio_lowpass_attenuates_high_freq():
    def band_power(freq):
        x = _run("gstpu_torch",
                 f"audiotestsrc freq={freq} num-buffers=20 "
                 "samplesperbuffer=480 ! audio/x-raw, format=F64LE, "
                 "rate=48000, channels=1 ! rsagingradio white-noise-ampl=0 "
                 "clicks-prob=0 bits-to-quantize=32 cubic-curve-passes=0 "
                 "! appsink name=sink")[2][4800:, 0]
        return float(np.sqrt(np.mean(x ** 2)))

    assert band_power(12000) < band_power(500) * 0.2


def test_agingradio_alias_and_clicks():
    """`agingradio` is the same element; clicks and stereo state."""
    _run_both("audiotestsrc freq=300 num-buffers=6 samplesperbuffer=1000 "
              "! audio/x-raw, format=F64LE, rate=44100, channels=2 "
              "! agingradio clicks-prob=0.01 seed=99 lowpass-freq=30000 "
              "! appsink name=sink")


def _aging_samples(name: str, x: np.ndarray, rate: int):
    """`appsrc ! rsagingradio ! appsink` fed host blocks of `x`."""
    pkg, info_cls, _ = PACKAGES[name]
    p = pkg.parse_launch(
        f'appsrc name=src caps="audio/x-raw, format=F64LE, rate={rate}, '
        f'channels=2, layout=interleaved" ! rsagingradio ! appsink '
        f'name=sink')
    p.set_state(pkg.State.PLAYING)
    src, sink = p.get_by_name("src"), p.get_by_name("sink")
    for i, off in enumerate(range(0, len(x), 4800)):
        src.push_buffer(pkg.Buffer(x[off:off + 4800].copy(),
                                   pts=i * 100_000_000))
    src.end_of_stream()
    p.run()
    info = info_cls.from_caps(sink.caps)
    out = np.concatenate([info.view(b) for b in sink.pull_all()])
    p.set_state(pkg.State.NULL)
    return out


def test_agingradio_takes_a_tensor_payload():
    """In place behind a device element: `rsaudioecho` hands the port's
    `rsagingradio` a tensor, the filter reads it through
    `AudioInfo.view` and writes a numpy array back. Its output equals
    both packages' filters fed the echo's samples as host arrays."""
    launch = ("audiotestsrc freq=440 num-buffers=8 samplesperbuffer=4800 "
              "! audio/x-raw, format=F64LE, rate=48000, channels=2 "
              "! rsaudioecho delay=20000000 intensity=0.4 feedback=0.3 "
              "! tee name=t ! queue ! rsagingradio ! appsink name=sink ! "
              "t. ! queue ! appsink name=echo")
    p = gstpu_torch.parse_launch(launch)
    seen = []
    p.get_by_name("t").static_pad("sink").add_probe(
        lambda pad, item: seen.append(type(item.data))
        if isinstance(item, gstpu_torch.Buffer) else None)
    p.set_state(gstpu_torch.State.PLAYING)
    p.run()
    info = AudioInfo.from_caps(p.get_by_name("sink").caps)
    got = np.concatenate([info.view(b)
                          for b in p.get_by_name("sink").pull_all()])
    echo = np.concatenate([info.view(b)
                           for b in p.get_by_name("echo").pull_all()])
    p.set_state(gstpu_torch.State.NULL)
    assert seen and all(t is torch.Tensor for t in seen)
    for name in PACKAGES:
        np.testing.assert_array_equal(_aging_samples(name, echo, 48000),
                                      got)


# ---------------------------------------------------------------------------
# ac4parse / s302mparse (tests/test_rtp_video_aging.py)
# ---------------------------------------------------------------------------

def _harness_run(name: str, factory: str, caps: str, pushes):
    """Push `pushes` through a harness of `factory` in one package: each
    push's flow return, the output buffers' bytes and timestamps, and the
    output caps."""
    _, _, harness = PACKAGES[name]
    h = harness(factory)
    h.set_caps(caps)
    rets = [h.push(b).name for b in pushes(PACKAGES[name][0])]
    outs = [(b.to_bytes(), b.pts, b.duration) for b in h.pull_all()]
    caps_out = repr(h.output_caps())
    h.teardown()
    return rets, outs, caps_out


def _twin(factory: str, caps: str, pushes):
    ref = _harness_run("gstpu", factory, caps, pushes)
    port = _harness_run("gstpu_torch", factory, caps, pushes)
    assert port == ref
    return port


def test_ac4parse_framing():
    f1 = b"\xacG" + b"\xac\x40" + (10).to_bytes(2, "big") + bytes(10)
    f2 = b"\xac\x41" + (6).to_bytes(2, "big") + bytes(6) + b"\x00\x00"
    _, outs, caps = _twin("ac4parse", "audio/x-ac4", lambda pkg: [
        pkg.Buffer(f1[:7]), pkg.Buffer(f1[7:] + f2)])
    assert [len(o[0]) for o in outs] == [14, 12]
    assert "framed" in caps


def test_ac4parse_seeded_stream():
    """Seeded frames of both sync words and the 24-bit size escape, with
    garbage between them, cut into random chunks."""
    rng = np.random.default_rng(4)
    stream = b""
    for i in range(40):
        stream += rng.integers(0, 256, int(rng.integers(0, 5)),
                               np.uint8).tobytes().replace(b"\xac", b"\x00")
        payload = rng.integers(0, 256, int(rng.integers(1, 300)),
                               np.uint8).tobytes()
        crc = bool(i % 3 == 0)
        sync = b"\xac\x41" if crc else b"\xac\x40"
        if i % 7 == 0:
            head = sync + b"\xff\xff" + len(payload).to_bytes(3, "big")
        else:
            head = sync + len(payload).to_bytes(2, "big")
        stream += head + payload + (b"\x12\x34" if crc else b"")
    cuts = np.sort(rng.integers(0, len(stream), 30))
    chunks = [stream[a:b] for a, b in zip([0, *cuts], [*cuts, len(stream)])]
    _, outs, _ = _twin("ac4parse", "audio/x-ac4",
                       lambda pkg: [pkg.Buffer(c) for c in chunks])
    assert len(outs) >= 39


def test_s302mparse_caps():
    header = (8 << 16) | (1 << 14) | (1 << 4)
    _, outs, caps = _twin("s302mparse", "audio/x-smpte-302m", lambda pkg: [
        pkg.Buffer(header.to_bytes(4, "big") + bytes(8), pts=0)])
    assert len(outs) == 1
    assert "channels=4" in caps and "depth=20" in caps


@pytest.mark.parametrize("bits_code", [0, 1, 2, 3])
def test_s302mparse_headers(bits_code):
    """Each channel code in turn, each bits code, a short packet: the
    same buffers, caps changes and errors in both packages."""
    def pushes(pkg):
        out = []
        for i, ch in enumerate((0, 1, 2, 3, 3, 0)):
            header = (16 << 16) | (ch << 14) | (bits_code << 4)
            out.append(pkg.Buffer(header.to_bytes(4, "big") + bytes(16),
                                  pts=i * 1000))
        out.append(pkg.Buffer(((99 << 16) | (bits_code << 4))
                              .to_bytes(4, "big") + bytes(3), pts=9))
        return out
    rets, outs, _ = _twin("s302mparse", "audio/x-smpte-302m", pushes)
    assert len(outs) == (6 if bits_code != 3 else 0)
