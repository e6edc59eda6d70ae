"""The port's `vp8enc`/`vp9enc`/`vp8dec`/`vp9dec` and `opusenc`/`opusdec`
against gstpu's, on the CPU.

Twins of tests/test_vpx_opus.py: the same launch strings and harness
pushes go through gstpu and through gstpu_torch, and every packet's and
frame's bytes, pts, duration and flags must be equal. Both packages drive
the same libavcodec engines (libvpx, libopus) through the codec shim
`native/gstpu_codec.cpp`, single-threaded, so the streams are
deterministic and nothing here has a tolerance. The tests skip where the
shim cannot be built (no libavcodec), as gstpu's do; the webrtcsink
cases wait for the port's webrtcsink (ROADMAP, Queue D item 6).
"""

import numpy as np
import pytest

import gstpu
import gstpu_torch
from gstpu.core.harness import Harness as JHarness
from gstpu_torch.core.buffer import BufferFlags
from gstpu_torch.core.harness import Harness
from torch_session import torch_test_limit  # noqa: F401

SECOND = 1_000_000_000
PACKAGES = {"gstpu": (gstpu, JHarness), "gstpu_torch": (gstpu_torch, Harness)}


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU; skipped
    without the shim."""
    from gstpu_torch.native_codec import load
    if load() is None:
        pytest.skip("native codec shim unavailable")
    gstpu.init()
    gstpu_torch.init(device="cpu")


def _key(b) -> tuple:
    return (b.to_bytes(), b.pts, b.duration, int(b.flags))


def _run(name: str, desc: str):
    pkg, _ = PACKAGES[name]
    p = pkg.parse_launch(desc + " ! appsink name=out")
    out = p.get_by_name("out")
    p.set_state(pkg.State.PLAYING)
    p.run()
    p.set_state(pkg.State.NULL)
    return repr(out.caps), [_key(b) for b in out.pull_all()]


def run_pipeline(desc: str):
    """The string in both packages: the port's buffers, equal to gstpu's
    in bytes, timestamps and flags."""
    ref, port = (_run(name, desc) for name in PACKAGES)
    assert port == ref
    return port[1]


# ---------------------------------------------------------------------------
# opus
# ---------------------------------------------------------------------------

def _sine(n, rate=48000, ch=2, f=440.0):
    t = np.arange(n) / rate
    return np.stack([np.sin(2 * np.pi * f * (i + 1) * t)
                     for i in range(ch)], axis=1).astype(np.float32) * 0.5


def test_opus_element_loopback_psnr():
    bufs = run_pipeline(
        'audiotestsrc num-buffers=50 samplesperbuffer=960 freq=440 ! '
        'capsfilter caps="audio/x-raw, format=F32LE, rate=48000, '
        'channels=2" ! opusenc bitrate=128000 ! opusdec')
    dec = np.concatenate([np.frombuffer(b[0], "<f4")
                          for b in bufs]).reshape(-1, 2)
    assert len(dec) >= int(50 * 960 * 0.9)
    seg = dec[8000:8000 + 4800, 0] * np.hanning(4800)
    peak_hz = np.argmax(np.abs(np.fft.rfft(seg))) * 48000 / 4800
    assert abs(peak_hz - 440) < 15, peak_hz


def test_opus_rtp_pay_depay_loopback():
    bufs = run_pipeline(
        'audiotestsrc num-buffers=30 samplesperbuffer=960 ! '
        'capsfilter caps="audio/x-raw, format=F32LE, rate=48000, '
        'channels=2" ! opusenc ! rtpopuspay2 ! rtpopusdepay2 ! opusdec')
    assert sum(len(b[0]) for b in bufs) // 8 >= int(30 * 960 * 0.9)


def test_opusenc_packet_timing():
    bufs = run_pipeline(
        'audiotestsrc num-buffers=10 samplesperbuffer=480 ! '
        'capsfilter caps="audio/x-raw, format=F32LE, rate=48000, '
        'channels=1" ! opusenc')
    assert len(bufs) >= 4
    assert {b[2] for b in bufs[:-1] if b[2]} == {20_000_000}


@pytest.mark.parametrize("props", ["audio-type=voice frame-size=10 dtx=true",
                                   "frame-size=60 complexity=3 "
                                   "inband-fec=true packet-loss-percentage=20",
                                   "frame-size=2 bitrate=24000"])
def test_opusenc_settings(props):
    run_pipeline('audiotestsrc num-buffers=12 samplesperbuffer=700 '
                 'wave=white-noise ! capsfilter caps="audio/x-raw, '
                 'format=S16LE, rate=24000, channels=2" ! '
                 f'opusenc {props}')


def _reconfigure(name: str):
    """tests/test_vpx_opus.py::test_opusenc_reconfigure_bitrate in one
    package: every packet, the drained ones too."""
    pkg, harness = PACKAGES[name]
    h = harness("opusenc")
    h.set_caps("audio/x-raw, format=F32LE, rate=48000, channels=2, "
               "layout=interleaved")
    sig = _sine(960)
    h.push(pkg.Buffer(sig.tobytes(), pts=0))
    enc = h.element
    drained = enc.reconfigure_bitrate(32000)
    assert enc.bitrate == 32000
    h.push(pkg.Buffer(sig.tobytes(), pts=20_000_000))
    out = [_key(b) for b in drained + h.pull_all()]
    h.teardown()
    return out


def test_opusenc_reconfigure_bitrate():
    ref, port = (_reconfigure(name) for name in PACKAGES)
    assert port == ref and port


def test_opus_8k_mono():
    bufs = run_pipeline(
        'audiotestsrc num-buffers=10 samplesperbuffer=160 ! '
        'audioconvert ! capsfilter caps="audio/x-raw, format=S16LE, '
        'rate=8000, channels=1" ! opusenc ! opusdec')
    assert sum(len(b[0]) for b in bufs) > 0


# ---------------------------------------------------------------------------
# vp8 / vp9
# ---------------------------------------------------------------------------

def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("codec", ["vp8", "vp9"])
def test_vpx_element_loopback_psnr(codec):
    raw = run_pipeline(
        'videotestsrc num-buffers=5 ! capsfilter caps="video/x-raw, '
        'format=I420, width=320, height=240"')
    dec = run_pipeline(
        'videotestsrc num-buffers=5 ! capsfilter caps="video/x-raw, '
        f'format=I420, width=320, height=240" ! {codec}enc deadline=1 '
        f'cpu-used=8 target-bitrate=2000000 ! {codec}dec')
    assert len(dec) == len(raw) == 5
    for r, d in zip(raw, dec):
        p = _psnr(np.frombuffer(r[0], np.uint8), np.frombuffer(d[0], np.uint8))
        assert p > 30, p


@pytest.mark.parametrize("codec", ["vp8", "vp9"])
def test_vpx_rtp_pay_depay_loopback(codec):
    dec = run_pipeline(
        'videotestsrc num-buffers=5 ! capsfilter caps="video/x-raw, '
        f'format=I420, width=320, height=240" ! {codec}enc deadline=1 '
        f'cpu-used=8 ! rtp{codec}pay2 ! rtp{codec}depay2 ! {codec}dec')
    assert len(dec) == 5
    assert len(dec[0][0]) == 320 * 240 * 3 // 2


@pytest.mark.parametrize("codec,props", [
    ("vp8", "end-usage=cbr target-bitrate=300000 error-resilient=true"),
    ("vp9", "end-usage=cq cq-level=40 min-quantizer=10 max-quantizer=50"),
    ("vp8", "target-bitrate=0 deadline=0 cpu-used=4")])
def test_vpx_encoder_settings(codec, props):
    """The property surface into both packages' engines: the same
    packets and keyframe flags."""
    run_pipeline('videotestsrc num-buffers=6 pattern=snow ! capsfilter '
                 'caps="video/x-raw, format=I420, width=96, height=64, '
                 f'framerate=25/1" ! {codec}enc keyframe-max-dist=3 {props}')


def test_vp8enc_keyframe_flags():
    bufs = run_pipeline(
        'videotestsrc num-buffers=8 ! capsfilter caps="video/x-raw, '
        'format=I420, width=64, height=64" ! vp8enc deadline=1 '
        'cpu-used=8 keyframe-max-dist=4')
    keys = [not (b[3] & int(BufferFlags.DELTA_UNIT)) for b in bufs]
    assert keys[0] is True and any(keys[1:])


def _vp8_reconfigure(name: str):
    pkg, harness = PACKAGES[name]
    from importlib import import_module
    make = import_module(f"{name}.core.registry").make
    h = harness(make("vp8enc", deadline=1, cpu_used=8))
    h.set_caps("video/x-raw, format=I420, width=64, height=64, "
               "framerate=30/1")
    frame = np.full(64 * 64 * 3 // 2, 128, np.uint8).tobytes()
    h.push(pkg.Buffer(frame, pts=0))
    enc = h.element
    drained = enc.reconfigure_bitrate(100_000)
    assert enc.target_bitrate == 100_000
    h.push(pkg.Buffer(frame, pts=SECOND // 30))
    h.push(pkg.Buffer(frame, pts=2 * SECOND // 30))
    out = [_key(b) for b in drained + h.pull_all()]
    h.teardown()
    return out


def test_vp8enc_reconfigure_bitrate():
    ref, port = (_vp8_reconfigure(name) for name in PACKAGES)
    assert port == ref and len(port) >= 2


def test_vpx_fed_by_the_graded_chain(tmp_path):
    """Both codecs behind the port's `hsvfilter ! colorlut`, whose
    frames reach `videoconvert` as tensors: the same packets, and the
    decoded frames equal."""
    rng = np.random.default_rng(8)
    cube = tmp_path / "g.cube"
    cube.write_text("LUT_3D_SIZE 3\n" + "\n".join(
        " ".join(f"{x:.6f}" for x in v) for v in rng.random((27, 3))) + "\n")
    for codec in ("vp8", "vp9"):
        run_pipeline(f"videotestsrc num-buffers=4 pattern=snow ! video/x-raw, "
                     f"format=RGBA, width=64, height=48, framerate=30/1 ! "
                     f"hsvfilter hue_shift=12 ! colorlut location={cube} ! "
                     f"videoconvert ! video/x-raw, format=I420 ! {codec}enc "
                     f"deadline=1 cpu-used=8 ! {codec}dec")
