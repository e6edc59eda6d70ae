"""The file-to-file host edge of the port against gstpu's, on the CPU: a
FLAC file through gstpu_torch's host elements and its device chain into
an MP4 file, the same launch string in both packages.

- 0.25 s of 48 kHz S16 stereo FLAC through `claxondec ! audioconvert !
  audioresample` to 192 kHz F64 and `isomp4mux ! filesink`: host code
  only, so the two files are equal byte for byte.
- 3.5 s of 192 kHz S16 stereo FLAC (no resampler) through `claxondec !
  audioconvert ! rsaudioecho ! audioloudnorm ! ebur128level ! isomp4mux
  ! filesink`, the flagship chain (audioloudnorm's first frame is 3 s):
  every box but `mdat` byte for byte, and the F64 samples in `mdat`
  within 1e-12, the bound tests/test_torch_chain.py holds between the
  port's chain and gstpu's (gstpu's echo contracts to FMAs, the port's
  does not; measured 1.67e-16 on this file).
"""

import numpy as np
import pytest

import gstpu
import gstpu_torch
from gstpu_torch.codecs.flac import StreamInfo, crc8, encode_verbatim
from gstpu_torch.mux.boxes import parse_boxes
from torch_session import torch_test_limit  # noqa: F401

CHAIN_TOL = 1e-12
FLAGSHIP = ("rsaudioecho delay=250000000 intensity=0.4 feedback=0.3 ! "
            "audioloudnorm ! ebur128level")
# audioresample's 16-tap window: the last output it can make at the end
# of the stream lies 9 input samples before it, so an up-by-4 stream of
# n inputs gives 4 * (n - 9) + 1 outputs
RESAMPLER_EDGE = 35


@pytest.fixture(autouse=True)
def _both_on_cpu():
    """gstpu's registry and the port's, the port on the CPU."""
    gstpu.init()
    gstpu_torch.init(device="cpu")


def _crc16_table() -> list:
    table = []
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 \
                else (c << 1) & 0xFFFF
        table.append(c)
    return table


_CRC16 = _crc16_table()


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16[(crc >> 8) ^ b]
    return crc


def _utf8_number(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    n = 2
    while v >= 1 << (5 * n + 1):
        n += 1
    out = []
    for _ in range(n - 1):
        out.append(0x80 | (v & 0x3F))
        v >>= 6
    out.append(((0xFF00 >> n) & 0xFF) | v)
    return bytes(reversed(out))


def flac_s16(samples: np.ndarray, rate: int) -> bytes:
    """A verbatim 16-bit FLAC stream, as `encode_verbatim` writes it but
    with any number of frames (UTF-8 frame numbers) and the 192 kHz rate
    code (`encode_verbatim` writes a 16-bit rate in Hz: 0..127 frames,
    rates below 65,536). Verbatim 16-bit subframes are byte aligned, so
    the samples go in as big-endian bytes."""
    n, ch = samples.shape
    block = 4096
    info = StreamInfo(min(block, n), block, rate, ch, 16, n).to_bytes()
    out = bytearray(b"fLaC\x80") + len(info).to_bytes(3, "big") + info
    for k, off in enumerate(range(0, n, block)):
        x = samples[off:off + block]
        rate_code, rate_tail = ((0x7D, rate.to_bytes(2, "big"))
                                if rate < 65536 else (0x73, b""))
        hdr = (bytes([0xFF, 0xF8, rate_code, ((ch - 1) << 4) | 0x08])
               + _utf8_number(k) + (x.shape[0] - 1).to_bytes(2, "big")
               + rate_tail)
        body = hdr + bytes([crc8(hdr)]) + b"".join(
            b"\x02" + x[:, c].astype(">i2").tobytes() for c in range(ch))
        out += body + _crc16(body).to_bytes(2, "big")
    return bytes(out)


def _signal(seconds: float, rate: int, seed: int) -> np.ndarray:
    """Seeded S16 stereo: two tones whose level steps every second, plus
    noise, so the loudness normaliser moves its gain."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    level = 0.15 + 0.5 * (np.floor(t) % 2)
    x = np.stack([level * np.sin(2 * np.pi * 440 * t),
                  0.7 * level * np.sin(2 * np.pi * 660 * t + 0.3)], 1)
    x += 0.01 * rng.standard_normal(x.shape)
    return np.round(np.clip(x, -1, 1) * 32767).astype(np.int16)


def _file_to_file(tmp_path, src, middle: str) -> dict:
    """`filesrc ! claxondec ! audioconvert ! {middle} ! isomp4mux !
    filesink` in each package: the MP4 file's bytes."""
    files = {}
    for pkg in (gstpu, gstpu_torch):
        dst = tmp_path / f"{pkg.__name__}.mp4"
        p = pkg.parse_launch(
            f"filesrc location={src} ! claxondec ! audioconvert ! {middle}"
            f" ! isomp4mux ! filesink location={dst}")
        p.set_state(pkg.State.PLAYING)
        p.run(timeout=120)
        p.set_state(pkg.State.NULL)
        files[pkg.__name__] = dst.read_bytes()
    return files


def _boxes(data: bytes) -> dict:
    tree = parse_boxes(data)
    assert [b.fourcc for b in tree] == ["ftyp", "mdat", "moov"]
    return {b.fourcc: b for b in tree}


def _pcm_frames(moov, channels: int, width: int) -> int:
    """PCM frames the moov's sample table accounts for: its sample sizes
    summed over the frame's bytes."""
    stbl = moov.find("trak.mdia.minf.stbl")
    stsz = next(c for c in parse_boxes(stbl.data) if c.fourcc == "stsz")
    count = int.from_bytes(stsz.data[8:12], "big")
    sizes = np.frombuffer(stsz.data[12:12 + 4 * count], ">u4")
    assert sizes.sum() % (channels * width) == 0
    return int(sizes.sum()) // (channels * width)


def test_flac_helper_writes_what_encode_verbatim_writes():
    x = _signal(0.5, 48_000, 1)
    assert flac_s16(x, 48_000) == encode_verbatim(x, 48_000)


def test_resampled_file_matches_gstpu(tmp_path):
    x = _signal(0.25, 48_000, 2)
    src = tmp_path / "in.flac"
    src.write_bytes(encode_verbatim(x, 48_000))
    files = _file_to_file(tmp_path, src,
                          "audio/x-raw, format=F64LE ! audioresample ! "
                          "audio/x-raw, rate=192000")
    assert files["gstpu_torch"] == files["gstpu"]
    b = _boxes(files["gstpu_torch"])
    stsd = b["moov"].find("trak.mdia.minf.stbl")
    assert b"fpcm" in stsd.data and b"pcmC" in stsd.data
    n = _pcm_frames(b["moov"], 2, 8)
    assert n == 4 * x.shape[0] - RESAMPLER_EDGE
    assert len(b["mdat"].data) == n * 16


def test_flagship_file_matches_gstpu(tmp_path):
    x = _signal(3.5, 192_000, 3)
    src = tmp_path / "in.flac"
    src.write_bytes(flac_s16(x, 192_000))
    files = _file_to_file(tmp_path, src, FLAGSHIP)
    port, ref = _boxes(files["gstpu_torch"]), _boxes(files["gstpu"])
    for name in ("ftyp", "moov"):
        assert port[name].data == ref[name].data, name
    got = np.frombuffer(port["mdat"].data, "<f8").reshape(-1, 2)
    want = np.frombuffer(ref["mdat"].data, "<f8").reshape(-1, 2)
    assert got.shape == want.shape == x.shape
    assert _pcm_frames(port["moov"], 2, 8) == x.shape[0]
    err = float(np.abs(got - want).max())
    assert err <= CHAIN_TOL, err
    # the normaliser has moved the signal: the output is not the input
    assert np.isfinite(got).all()
    assert float(np.abs(got - x / 32768.0).max()) > 0.01
