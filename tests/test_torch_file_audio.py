"""The port's file and audio host edge against gstpu's, on the CPU: the
FLAC codec and `claxondec`, the Ogg pages and the Vorbis decoder with
`oggdemux ! lewtondec`, `audioconvert`/`audioresample`/`audiomixer`, and
`filesrc ! filesink`.

Twins of tests/test_flac.py, tests/test_vorbis.py, the three audio cases
of tests/test_convert_text.py and tests/test_pipeline.py's file round
trip: the same seeded inputs go through gstpu and through gstpu_torch,
and the bytes, samples and caps must be equal. These modules are host
numpy and the standard library in both packages, so any difference is a
fault of the copy: nothing here has a tolerance.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.codecs import flac as jflac
from gstpu.codecs import ogg as jogg
from gstpu.codecs import vorbis as jvorbis
from gstpu.core.audio import AudioInfo as JAudioInfo
from gstpu_torch.codecs import flac, ogg, vorbis
from gstpu_torch.core.audio import AudioInfo

HOUSE = ("/opt/venv/lib/python3.12/site-packages/pygame/examples/"
         "data/house_lo.ogg")
needs_house = pytest.mark.skipif(not os.path.exists(HOUSE),
                                 reason="pygame's example Ogg file is "
                                        "not installed")
PACKAGES = {"gstpu": (gstpu, JAudioInfo), "gstpu_torch": (gstpu_torch,
                                                          AudioInfo)}


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


def _run(name: str, launch: str, sink: str | None = "sink"):
    """Run a launch string in one package: (caps, buffers) of `sink`."""
    pkg, _ = PACKAGES[name]
    p = pkg.parse_launch(launch)
    p.set_state(pkg.State.PLAYING)
    p.run()
    out = None
    if sink is not None:
        s = p.get_by_name(sink)
        out = (s.caps, s.pull_all())
    p.set_state(pkg.State.NULL)
    return out


def _samples(name: str, caps, bufs) -> np.ndarray:
    info = PACKAGES[name][1].from_caps(caps)
    return np.concatenate([info.view(b) for b in bufs])


def _run_both(launch: str) -> dict:
    """The string in both packages: caps string, samples, pts and
    durations, per package."""
    got = {}
    for name in PACKAGES:
        caps, bufs = _run(name, launch)
        got[name] = (repr(caps), _samples(name, caps, bufs),
                     [(b.pts, b.duration) for b in bufs])
    return got


def _equal(got: dict) -> tuple:
    (caps, x, ts), (caps2, y, ts2) = got["gstpu"], got["gstpu_torch"]
    assert caps2 == caps
    assert y.dtype == x.dtype and y.shape == x.shape
    np.testing.assert_array_equal(y, x)
    assert ts2 == ts
    return caps2, y


# -- FLAC (tests/test_flac.py) ----------------------------------------------

def test_crc_vectors():
    for data in (b"123456789", bytes(range(256)) * 3, b""):
        assert flac.crc8(data) == jflac.crc8(data)
        assert flac.crc16(data) == jflac.crc16(data)
    assert flac.crc8(b"123456789") == 0xF4
    assert flac.crc16(b"123456789") == 0xFEE8


def test_streaminfo_roundtrip():
    si = flac.StreamInfo(4096, 4096, 48000, 2, 16, 123456)
    assert si.to_bytes() == jflac.StreamInfo(4096, 4096, 48000, 2, 16,
                                             123456).to_bytes()
    si2 = flac.StreamInfo.parse(si.to_bytes())
    assert si2 == flac.StreamInfo(4096, 4096, 48000, 2, 16, 123456)


def _decode_all(mod, stream: bytes, chunk: int | None = None) -> list:
    dec = mod.FlacStreamDecoder()
    frames = []
    step = chunk or len(stream)
    for i in range(0, len(stream), step):
        dec.push(stream[i:i + step])
        while (f := dec.poll()) is not None:
            frames.append(f)
    return frames


@pytest.mark.parametrize("channels", [1, 2])
def test_verbatim_roundtrip(channels):
    rng = np.random.default_rng(8)
    pcm = rng.integers(-2**15, 2**15, (10000, channels)).astype(np.int16)
    stream = flac.encode_verbatim(pcm, 44100, 16)
    assert stream == jflac.encode_verbatim(pcm, 44100, 16)
    got, want = _decode_all(flac, stream), _decode_all(jflac, stream)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g.sample_rate, g.bits_per_sample, g.frame_number) \
            == (w.sample_rate, w.bits_per_sample, w.frame_number) \
            == (44100, 16, g.frame_number)
        assert g.samples.dtype == w.samples.dtype
        np.testing.assert_array_equal(g.samples, w.samples)
    np.testing.assert_array_equal(
        np.concatenate([f.samples for f in got]), pcm.astype(np.int32))


def test_incremental_feed():
    rng = np.random.default_rng(9)
    pcm = rng.integers(-1000, 1000, (5000, 1)).astype(np.int16)
    stream = flac.encode_verbatim(pcm, 8000, 16)
    got = _decode_all(flac, stream, chunk=333)
    want = _decode_all(jflac, stream, chunk=333)
    assert [f.samples.shape for f in got] == [f.samples.shape for f in want]
    out = np.concatenate([f.samples for f in got])
    np.testing.assert_array_equal(
        out, np.concatenate([f.samples for f in want]))
    np.testing.assert_array_equal(out[:, 0], pcm[:, 0].astype(np.int32))


def test_claxondec_pipeline(tmp_path):
    t = np.arange(20000) / 44100
    pcm = (10000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16)
    f = tmp_path / "t.flac"
    f.write_bytes(flac.encode_verbatim(pcm[:, None], 44100, 16))
    caps, out = _equal(_run_both(
        f"filesrc location={f} blocksize=1000 ! audio/x-flac ! claxondec "
        f"! appsink name=sink"))
    assert "S16LE" in caps and "44100" in caps
    np.testing.assert_array_equal(out[:, 0], pcm)


def test_claxondec_stereo_s16_into_f64(tmp_path):
    """claxondec ! audioconvert to F64LE on a seeded stereo stream: the
    head of the file-to-file chain."""
    rng = np.random.default_rng(11)
    pcm = rng.integers(-2**15, 2**15, (9000, 2)).astype(np.int16)
    f = tmp_path / "s.flac"
    f.write_bytes(flac.encode_verbatim(pcm, 48000))
    caps, out = _equal(_run_both(
        f"filesrc location={f} ! claxondec ! audioconvert ! "
        f"audio/x-raw, format=F64LE ! appsink name=sink"))
    assert "F64LE" in caps and out.shape == (9000, 2)
    np.testing.assert_array_equal(out, pcm / 32768.0)


def test_corrupt_flac_errors():
    for mod in (flac, jflac):
        dec = mod.FlacStreamDecoder()
        with pytest.raises(ValueError):
            dec.push(b"NOTAFLAC" + b"\x00" * 100)
            dec.poll()


def test_claxondec_posts_error_on_corrupt_stream(tmp_path):
    f = tmp_path / "bad.flac"
    f.write_bytes(b"NOTAFLAC" + b"\x00" * 100)
    texts = {}
    for name, (pkg, _) in PACKAGES.items():
        p = pkg.parse_launch(f"filesrc location={f} ! claxondec name=d ! "
                             f"fakesink")
        p.set_state(pkg.State.PLAYING)
        with pytest.raises(RuntimeError, match="pipeline error"):
            p.run()
        texts[name] = []
        mtype = importlib.import_module(f"{name}.core.element").MessageType
        while (m := p.bus.pop_filtered(mtype.ERROR)) is not None:
            if m.src.name == "d":
                texts[name].append(m.text)
        p.set_state(pkg.State.NULL)
    assert texts["gstpu_torch"] == texts["gstpu"] \
        == ["claxondec: not a FLAC stream"]


# -- Ogg and Vorbis (tests/test_vorbis.py) ----------------------------------

@needs_house
def test_ogg_pages_and_packets():
    data = open(HOUSE, "rb").read()
    pages, jpages = list(ogg.parse_pages(data)), list(jogg.parse_pages(data))
    assert [vars(p) for p in pages] == [vars(p) for p in jpages]
    assert pages[0].bos and pages[-1].eos
    pkts = list(ogg.packets_of(data))
    assert pkts == list(jogg.packets_of(data))
    assert [p[:7] for p, _ in pkts[:3]] == [b"\x01vorbis", b"\x03vorbis",
                                            b"\x05vorbis"]
    assert len(pkts) > 100


@needs_house
def test_ogg_crc_detects_corruption():
    data = bytearray(open(HOUSE, "rb").read())
    data[100] ^= 0xFF
    for mod in (ogg, jogg):
        with pytest.raises(ValueError, match="crc"):
            list(mod.parse_pages(bytes(data)))


@needs_house
def test_vorbis_decode_matches_gstpu():
    data = open(HOUSE, "rb").read()
    pcm, rate = vorbis.decode_ogg_vorbis(data)
    want, jrate = jvorbis.decode_ogg_vorbis(data)
    assert rate == jrate == 11025
    assert pcm.dtype == want.dtype == np.float32
    assert pcm.shape == want.shape == (1, 78331)
    np.testing.assert_array_equal(pcm, want)


@needs_house
def test_lewtondec_pipeline():
    caps, out = _equal(_run_both(
        f"filesrc location={HOUSE} ! application/ogg ! oggdemux ! "
        f"lewtondec ! appsink name=sink"))
    assert "F32LE" in caps and "11025" in caps
    assert out.shape == (78331, 1)      # the exact granulepos length
    whole, _ = vorbis.decode_ogg_vorbis(open(HOUSE, "rb").read())
    np.testing.assert_array_equal(out[:, 0], whole[0])


# -- audioconvert / audioresample / audiomixer (tests/test_convert_text.py) -

def test_audioconvert_format_and_channels():
    caps, x = _equal(_run_both(
        "audiotestsrc num-buffers=5 ! audio/x-raw, format=F32LE, "
        "rate=48000, channels=2 ! audioconvert ! "
        "audio/x-raw, format=S16LE, rate=48000, channels=1 ! "
        "appsink name=sink"))
    assert "S16LE" in caps and x.shape[1] == 1
    assert 24000 < np.abs(x.astype(np.int32)).max() < 28000


@pytest.mark.parametrize("fmt", ["S16LE", "F32LE", "F64LE"])
def test_audioresample_preserves_frequency(fmt):
    caps, x = _equal(_run_both(
        f"audiotestsrc num-buffers=50 freq=1000 samplesperbuffer=480 "
        f"! audio/x-raw, format={fmt}, rate=48000, channels=1 "
        f"! audioresample ! audio/x-raw, rate=16000, format={fmt} ! "
        f"appsink name=sink"))
    assert "16000" in caps
    x = x[:, 0].astype(np.float64)
    assert abs(x.size - 50 * 480 / 3) < 50
    spec = np.abs(np.fft.rfft(x[200:] * np.hanning(x.size - 200)))
    freq = np.fft.rfftfreq(x.size - 200, 1 / 16000)
    assert abs(freq[np.argmax(spec)] - 1000) < 20


def test_audioresample_up_by_four():
    """48 kHz -> 192 kHz, the file chain's step: 4 outputs an input, less
    the filter's edge of 35 at the end of the stream."""
    caps, x = _equal(_run_both(
        "audiotestsrc num-buffers=10 samplesperbuffer=480 ! "
        "audio/x-raw, format=F64LE, rate=48000, channels=2 ! "
        "audioresample ! audio/x-raw, rate=192000 ! appsink name=sink"))
    assert "192000" in caps
    assert x.shape == (4 * 4800 - 35, 2)


def test_audiomixer_adds_signals():
    got = {}
    for name, (pkg, info_cls) in PACKAGES.items():
        p = pkg.parse_launch(
            "audiotestsrc wave=sine volume=0.2 num-buffers=10 "
            "samplesperbuffer=480 ! audio/x-raw, format=F64LE, "
            "rate=48000, channels=1 ! audiomixer name=mix ! "
            "appsink name=sink")
        mix = p.get_by_name("mix")
        src2 = pkg.make("audiotestsrc", wave="sine", volume=0.3,
                        num_buffers=10, samplesperbuffer=480)
        cf = pkg.make("capsfilter")
        cf.set_property("caps", pkg.Caps.from_string(
            "audio/x-raw, format=F64LE, rate=48000, channels=1"))
        p.add(src2, cf)
        src2.link(cf)
        cf.link(mix)
        sink = p.get_by_name("sink")
        p.set_state(pkg.State.PLAYING)
        p.run()
        bufs = sink.pull_all()
        got[name] = (repr(sink.caps), _samples(name, sink.caps, bufs),
                     [(b.pts, b.duration) for b in bufs])
        p.set_state(pkg.State.NULL)
    _, x = _equal(got)
    assert abs(float(np.abs(x).max()) - 0.5) < 0.01


# -- filesrc ! filesink (tests/test_pipeline.py) ----------------------------

@pytest.mark.parametrize("blocksize", [1000, 4096])
def test_filesrc_filesink_roundtrip(tmp_path, blocksize):
    data = bytes(range(256)) * 100
    src_file = tmp_path / "in.bin"
    src_file.write_bytes(data)
    for name in PACKAGES:
        dst = tmp_path / f"out_{name}.bin"
        _run(name, f"filesrc location={src_file} blocksize={blocksize} ! "
                   f"filesink location={dst}", sink=None)
        assert dst.read_bytes() == data


def test_filesink_writes_tensor_payloads(tmp_path):
    """A tensor payload reaches the file through Buffer.to_bytes()."""
    dst = tmp_path / "t.bin"
    x = torch.arange(64, dtype=torch.float64).reshape(32, 2)
    p = gstpu_torch.parse_launch(
        f'appsrc name=src caps="audio/x-raw, format=F64LE, rate=48000, '
        f'channels=2, layout=interleaved" ! filesink location={dst}')
    p.set_state(gstpu_torch.State.PLAYING)
    src = p.get_by_name("src")
    src.push_buffer(gstpu_torch.Buffer(x, pts=0))
    src.end_of_stream()
    p.run()
    p.set_state(gstpu_torch.State.NULL)
    assert dst.read_bytes() == x.numpy().tobytes()
