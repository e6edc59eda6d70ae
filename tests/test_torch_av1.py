"""The port's AV1 device legs against gstpu's, on the CPU.

gstpu_torch/ops/av1_intra.py is held against gstpu/ops/av1_intra.py on
the same planes:
- the mode decision bit for bit (`mode_counts` of the analyzer, on
  structured, natural and noisy planes, and on edge-padded planes of a
  non-multiple-of-8 geometry);
- the reconstruction of the transform pass: the DCT sums in another
  order than XLA's dots, so a few coefficients quantise across a .5 and
  some bytes differ; they are counted and bounded here
  (`REC_DIFFER_MAX_SHARE`, `REC_MAX_ABS`);
- the bits proxy within a relative tolerance set from measurement
  (`BITS_RTOL_ANALYZER`, `BITS_RTOL_TRANSFORM`);
- the numpy rate controls equal to gstpu's on the same inputs.
Then twins of tests/test_av1_device_transform.py and
tests/test_av1_device_rc.py drive the port's `rav1enc`/`dav1ddec`, under
gstpu's own skip conditions (no libaom, no SVT-AV1).
"""

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.core.element import MessageType as JaxMessageType
from gstpu.ops import av1_intra as jax_av1
from gstpu_torch import State, parse_launch
from gstpu_torch.core.element import MessageType
from gstpu_torch.core.video import VideoInfo
from gstpu_torch.ops import av1_intra
from gstpu_torch.ops.av1_intra import (DeviceRateControl, QstepRateControl,
                                       make_intra_analyzer,
                                       make_intra_transform)

# Measured on these tests' planes (seeded): each step of the analyzer's
# curve within 5.6e-4 of the curve's finest step (a level that rounds the
# other way moves a step by a few bits, which on a coarse step of a small
# plane is ~0.5% of that step), the transform's bits within 1.7e-4
# relative; 1.5% of the reconstruction's bytes differ, by 1 (2 seen at
# 1080p, qstep 16). The limits leave room above those readings.
BITS_RTOL_ANALYZER = 2e-3
BITS_RTOL_TRANSFORM = 1e-3
REC_DIFFER_MAX_SHARE = 0.03
REC_MAX_ABS = 2


@pytest.fixture(autouse=True)
def _port_on_cpu():
    gstpu_torch.init(device="cpu")


def _content(W, H, n, seed=7):
    """Compressible moving frames: gradient + drifting box (gstpu's
    test's content, with ceil-sized chroma)."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    base = (50 + 140 * gx / W + 40 * gy / H
            + 5 * rng.standard_normal((H, W))).astype(np.uint8)
    cw, ch = -(-W // 2), -(-H // 2)
    frames = []
    for i in range(n):
        y = np.roll(base, 2 * i, axis=1).copy()
        x0 = (6 * i) % max(1, W - 32)
        y[H // 4:H // 2, x0:x0 + 32] = 220
        u = ((gx[:ch, :cw] // 4 + i) % 200 + 20).astype(np.uint8)
        v = np.full((ch, cw), 130, np.uint8)
        frames.append((y, u, v))
    return frames


def _planes(H, W):
    rng = np.random.default_rng(0)
    return {"columns": np.tile(np.arange(W) * 3 % 251, (H, 1))
            .astype(np.uint8),
            "rows": np.tile((np.arange(H) * 5 % 251)[:, None], (1, W))
            .astype(np.uint8),
            "flat": np.full((H, W), 100, np.uint8),
            "noisy": rng.integers(0, 255, (H, W), dtype=np.uint8),
            "natural": _content(W, H, 1)[0][0]}


@pytest.mark.parametrize("H,W", [(64, 64), (96, 128), (128, 192)])
def test_analyzer_matches_gstpu(H, W):
    """mode_counts bit for bit; the rate curve within its tolerance."""
    ours = make_intra_analyzer(H, W, "cpu")
    ref = jax_av1.make_intra_analyzer(H, W)
    for name, y in _planes(H, W).items():
        bits, mc = ours(y)
        bits_j, mc_j = (np.asarray(a) for a in ref(y))
        assert mc.dtype == torch.int32
        np.testing.assert_array_equal(mc.numpy(), mc_j, err_msg=name)
        np.testing.assert_allclose(bits.numpy(), bits_j, err_msg=name,
                                   rtol=0,
                                   atol=BITS_RTOL_ANALYZER * bits_j[0])


@pytest.mark.parametrize("W,H", [(192, 128), (100, 60)])
def test_transform_matches_gstpu(W, H):
    """The reconstruction's differing bytes counted and bounded, the bits
    proxy within its tolerance, at the quantizer steps the element uses
    (quantizer 60, 100 and 200) and at a power of two; the modes of the
    edge-padded planes bit for bit."""
    ours = make_intra_transform(H, W, "cpu")
    ref = jax_av1.make_intra_transform(H, W)
    frames = _content(W, H, 2)
    for quantizer in (60, 100, 200, None):
        q = 2.0 if quantizer is None else \
            0.125 * 2.0 ** (min(63, quantizer // 4) / 6.0)
        for y, u, v in frames:
            got = ours(y, u, v, np.float32(q))
            want = [np.asarray(a) for a in ref(y, u, v, np.float32(q))]
            n = differ = worst = 0
            for a, b in zip(got[:3], want[:3]):
                a = a.numpy()
                assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
                d = np.abs(a.astype(int) - b.astype(int))
                n, differ = n + d.size, differ + int((d != 0).sum())
                worst = max(worst, int(d.max()))
            assert differ <= REC_DIFFER_MAX_SHARE * n, (q, differ, n)
            assert worst <= REC_MAX_ABS, (q, worst)
            np.testing.assert_allclose(float(got[3]), float(want[3]),
                                       rtol=BITS_RTOL_TRANSFORM)
    for plane in frames[0]:
        h, w = plane.shape
        padded = np.pad(plane, ((0, -h % 8), (0, -w % 8)), mode="edge")
        mc = make_intra_analyzer(*padded.shape, "cpu")(padded)[1]
        mc_j = jax_av1.make_intra_analyzer(*padded.shape)(padded)[1]
        np.testing.assert_array_equal(mc.numpy(), np.asarray(mc_j))


def test_dct_is_the_same_on_every_batch_and_needs_no_matmul():
    """The fixed-order DCT: a block's coefficients do not depend on the
    other blocks, and they are within f32 rounding of the f64 DCT."""
    rng = np.random.default_rng(2)
    res = rng.integers(-255, 256, (5, 7, 8, 8)).astype(np.float32)
    D = torch.from_numpy(av1_intra._dct_matrix())
    x = torch.from_numpy(res)
    coef = av1_intra._dct_right(av1_intra._dct_left(D, x), D)
    one = av1_intra._dct_right(av1_intra._dct_left(D, x[2:3, 4:5]), D)
    assert torch.equal(coef[2:3, 4:5], one)
    Dd = av1_intra._dct_matrix().astype(np.float64)
    exact = np.einsum("ij,bcjk,lk->bcil", Dd, res.astype(np.float64), Dd)
    np.testing.assert_allclose(coef.numpy(), exact, rtol=0, atol=2e-3)
    back = av1_intra._dct_right(av1_intra._dct_left(D.t(), coef), D.t())
    np.testing.assert_allclose(back.numpy(), res, rtol=0, atol=2e-3)


def test_rate_controls_equal_gstpu():
    """DeviceRateControl and QstepRateControl are gstpu's numpy: the same
    picks, proxies, scales and steps on the same curves."""
    rng = np.random.default_rng(4)
    for target, fps in ((400_000, 30.0), (3_000_000, 29.97), (50_000, 5)):
        a, b = DeviceRateControl(target, fps), jax_av1.DeviceRateControl(
            target, fps)
        for _ in range(20):
            curve = np.sort(rng.uniform(10, 2e6, 16))[::-1] \
                .astype(np.float32)
            crf = a.pick(curve)
            assert crf == b.pick(curve)
            proxy = a.proxy_at(curve, crf)
            assert proxy == b.proxy_at(curve, crf)
            actual = proxy * rng.uniform(0.2, 5.0)
            a.observe(actual, proxy)
            b.observe(actual, proxy)
            assert a.scale == b.scale
        q, qj = QstepRateControl(target, fps), jax_av1.QstepRateControl(
            target, fps)
        for _ in range(20):
            bits = rng.uniform(0, 4 * q.target)
            assert q.observe(bits) == qj.observe(bits)
    np.testing.assert_array_equal(av1_intra.Q_GRID, jax_av1.Q_GRID)
    np.testing.assert_array_equal(av1_intra._dct_matrix(),
                                  jax_av1._dct_matrix())


def test_rate_curve_monotone_and_content_sensitive():
    rng = np.random.default_rng(0)
    H, W = 96, 128
    analyze = make_intra_analyzer(H, W, "cpu")
    flat = np.full((H, W), 100, np.uint8)
    noisy = rng.integers(0, 255, (H, W), dtype=np.uint8)
    b_flat = analyze(flat)[0].numpy()
    b_noisy = analyze(noisy)[0].numpy()
    assert np.all(np.diff(b_noisy) <= 1e-3)
    assert np.all(np.diff(b_flat) <= 1e-3)
    assert np.all(b_noisy > b_flat)
    assert b_flat[-1] < 1e-3 * b_noisy[-1]


def test_intra_mode_decision_follows_structure():
    H, W = 64, 64
    analyze = make_intra_analyzer(H, W, "cpu")
    cols = np.tile(np.arange(W, dtype=np.uint8) * 3 % 251, (H, 1))
    rows = cols.T.copy()
    mc_v = analyze(cols)[1].numpy()     # constant columns -> V_PRED
    mc_h = analyze(rows)[1].numpy()     # constant rows    -> H_PRED
    assert mc_v[1] > mc_v[0] + mc_v[2]
    assert mc_h[2] > mc_h[0] + mc_h[1]
    with pytest.raises(ValueError, match="not /8"):
        make_intra_analyzer(60, 100, "cpu")


# -- the elements ------------------------------------------------------

def _have(codec: str, opts: dict | None = None) -> bool:
    from gstpu_torch.native_codec import NativeEncoder
    try:
        e = NativeEncoder(codec, 64, 64, (30, 1), opts or (
            {"g": 1} if codec != "libsvtav1"
            else {"preset": 13, "g": 1, "svtav1-params": "lp=1"}))
        e.close()
        return True
    except RuntimeError:
        return False


needs_aom = pytest.mark.skipif(
    not _have("libaom-av1", {"crf": 0, "b": 0, "g": 1, "threads": 1,
                             "aom-params": "lossless=1"}),
    reason="no libaom lossless")
needs_svt = pytest.mark.skipif(not _have("libsvtav1"), reason="no SVT-AV1")


def _encode(frames, W, H, extra=""):
    vi = VideoInfo("I420", W, H)
    p = parse_launch(
        f'appsrc name=src caps="video/x-raw, format=I420, width={W}, '
        f'height={H}, framerate=30/1" ! '
        f'rav1enc device-transform=true {extra} ! appsink name=sink')
    src, sink = p.get_by_name("src"), p.get_by_name("sink")
    p.set_state(State.PLAYING)
    for i, (y, u, v) in enumerate(frames):
        src.push_buffer(vi.make_buffer(
            np.concatenate([y.ravel(), u.ravel(), v.ravel()]),
            pts=i * 33_333_333))
        while p.iterate():
            pass
    src.end_of_stream()
    p.run()
    pkts = [b.to_bytes() for b in sink.pull_all()]
    p.set_state(State.NULL)
    return pkts


def _decode(pkts):
    from gstpu_torch.native_codec import NativeDecoder
    dec = NativeDecoder("libdav1d")
    got = []
    for i, q in enumerate(pkts):
        got += dec.send(q, i)
    got += dec.finish()
    dec.close()
    return [np.frombuffer(f[0], np.uint8) for f in got]


@needs_aom
def test_bits_decode_to_exact_device_reconstruction():
    """libdav1d's decode of the port's stream equals, byte for byte, the
    port's transform pass; gstpu's reconstruction differs from it in a
    counted share of bytes."""
    W, H = 192, 128
    frames = _content(W, H, 6)
    pkts = _encode(frames, W, H, extra="quantizer=100")
    assert len(pkts) >= 6
    decoded = _decode(pkts)
    assert len(decoded) == 6
    ours = make_intra_transform(H, W, "cpu")
    ref = jax_av1.make_intra_transform(H, W)
    qstep = np.float32(0.125 * 2.0 ** (min(63, 100 // 4) / 6.0))
    for i, (y, u, v) in enumerate(frames):
        ry, ru, rv, _ = ours(y, u, v, qstep)
        want = np.concatenate([ry.numpy().ravel(), ru.numpy().ravel(),
                               rv.numpy().ravel()])
        assert np.array_equal(decoded[i], want), f"frame {i}"
        jy, ju, jv, _ = ref(y, u, v, qstep)
        gst = np.concatenate([np.asarray(a).ravel() for a in (jy, ju, jv)])
        assert (gst != want).sum() <= REC_DIFFER_MAX_SHARE * want.size


@needs_aom
def test_non_multiple_of_8_geometry():
    W, H = 100, 60
    frames = _content(W, H, 3)
    decoded = _decode(_encode(frames, W, H, extra="quantizer=60"))
    assert len(decoded) == 3
    assert decoded[0].size == W * H * 3 // 2


@needs_aom
def test_transform_is_lossy_but_faithful():
    W, H = 192, 128
    frames = _content(W, H, 3)
    decoded = _decode(_encode(frames, W, H, extra="quantizer=100"))
    y_src = frames[0][0].astype(np.float64)
    y_dec = decoded[0][:W * H].reshape(H, W).astype(np.float64)
    assert not np.array_equal(y_src, y_dec)
    mse = np.mean((y_src - y_dec) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    assert psnr > 34.0, psnr


@needs_aom
def test_qstep_rate_control_converges():
    W, H = 192, 128
    target = 600_000
    frames = _content(W, H, 48)
    pkts = _encode(frames, W, H, extra=f"bitrate={target}")
    assert len(pkts) == 48
    half = pkts[len(pkts) // 2:]
    bps = sum(len(d) for d in half) * 8 / (len(half) / 30.0)
    assert target * 0.70 < bps < target * 1.30, bps
    assert len(_decode(pkts)) == 48


def test_qstep_rc_model():
    rc = QstepRateControl(target_bps=300_000, fps=30.0)
    c = 1e6                      # plant: bits = c / qstep
    q = rc.qstep
    for _ in range(40):
        q = rc.observe(c / q)
    assert abs(c / q - 300_000 / 30.0) / (300_000 / 30.0) < 0.02
    rc2 = QstepRateControl(1e12, 30.0)  # absurd target -> qmin clamp
    for _ in range(20):
        rc2.observe(1.0)
    assert rc2.qstep == rc2.qmin


def _frame_y(base: np.ndarray, i: int) -> np.ndarray:
    H, W = base.shape
    y = np.roll(base, 3 * i, axis=1).copy()
    x0 = (8 * i) % (W - 40)
    y[40:80, x0:x0 + 40] = 210
    return y


def _run_rc(engine: str, bitrate: int, n_frames: int = 72,
            W: int = 320, H: int = 192, preset: int = 10,
            kf_interval: int = 1):
    vi = VideoInfo("I420", W, H)
    rng = np.random.default_rng(3)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    base = (60 + 120 * gx / W + 30 * gy / H
            + 6 * rng.standard_normal((H, W))).astype(np.uint8)
    p = parse_launch(
        f'appsrc name=src caps="video/x-raw, format=I420, width={W}, '
        f'height={H}, framerate=30/1" ! '
        f'rav1enc engine={engine} speed-preset={preset} rc-mode=device '
        f'rc-interval=4 bitrate={bitrate} '
        f'max-key-frame-interval={kf_interval} ! '
        f'appsink name=sink')
    src, sink = p.get_by_name("src"), p.get_by_name("sink")
    p.set_state(State.PLAYING)
    for i in range(n_frames):
        y = _frame_y(base, i)
        u = np.full((H // 2, W // 2), 120, np.uint8)
        v = np.full((H // 2, W // 2), 130, np.uint8)
        src.push_buffer(vi.make_buffer(
            np.concatenate([y.ravel(), u.ravel(), v.ravel()]),
            pts=i * 33_333_333))
        while p.iterate():
            pass
    src.end_of_stream()
    p.run()
    pkts = [b.to_bytes() for b in sink.pull_all()]
    p.set_state(State.NULL)
    assert len(pkts) == n_frames
    return pkts


@needs_svt
def test_device_rc_converges_to_target_and_stays_conformant():
    target = 400_000
    pkts = _run_rc("svt", target)
    half = pkts[len(pkts) // 2:]
    bps = sum(len(d) for d in half) * 8 / (len(half) / 30.0)
    assert target * 0.80 < bps < target * 1.20, bps
    assert len(_decode(pkts)) == len(pkts)


@needs_svt
def test_device_rc_converges_at_1080p():
    """1080p30 with a normal GOP, as gstpu's twin: within ±35% in the
    steady half."""
    target = 3_000_000
    pkts = _run_rc("svt", target, n_frames=60, W=1920, H=1080,
                   kf_interval=240)
    half = pkts[len(pkts) // 2:]
    bps = sum(len(d) for d in half) * 8 / (len(half) / 30.0)
    assert target * 0.65 < bps < target * 1.35, bps


@needs_svt
def test_device_rc_tracks_different_targets():
    lo = _run_rc("svt", 150_000, n_frames=48)
    hi = _run_rc("svt", 900_000, n_frames=48)

    def steady(pkts):
        return sum(map(len, pkts[len(pkts) // 2:]))

    assert steady(hi) > 3 * steady(lo), (steady(hi), steady(lo))


@pytest.mark.skipif(not _have("libaom-av1"), reason="no libaom")
def test_engine_aom_loopback():
    W, H = 192, 96
    vi = VideoInfo("I420", W, H)
    rng = np.random.default_rng(5)
    p = parse_launch(
        f'appsrc name=src caps="video/x-raw, format=I420, width={W}, '
        f'height={H}, framerate=30/1" ! rav1enc engine=aom '
        f'speed-preset=10 quantizer=120 max-key-frame-interval=1 ! '
        f'dav1ddec ! appsink name=sink')
    src, sink = p.get_by_name("src"), p.get_by_name("sink")
    p.set_state(State.PLAYING)
    for i in range(8):
        src.push_buffer(vi.make_buffer(
            rng.integers(0, 255, W * H * 3 // 2, dtype=np.uint8),
            pts=i * 33_333_333))
        while p.iterate():
            pass
    src.end_of_stream()
    p.run()
    assert len(sink.pull_all()) == 8
    p.set_state(State.NULL)


@pytest.mark.parametrize("pkg", ["gstpu_torch", "gstpu"])
def test_rc_mode_needs_bitrate(pkg):
    """Both packages refuse rc-mode=device without a bitrate."""
    mod, error = ((gstpu_torch, MessageType.ERROR) if pkg == "gstpu_torch"
                  else (gstpu, JaxMessageType.ERROR))
    if mod is gstpu:
        gstpu.init()
    p = mod.parse_launch(
        'appsrc name=src caps="video/x-raw, format=I420, width=64, '
        'height=64, framerate=30/1" ! rav1enc rc-mode=device ! '
        'appsink')
    src = p.get_by_name("src")
    p.set_state(mod.State.PLAYING)
    src.push_buffer(mod.Buffer(np.zeros(64 * 64 * 3 // 2, np.uint8)))
    while p.iterate():
        pass
    msg = p.bus.pop_filtered(error)
    assert msg is not None and "bitrate" in msg.text
    p.set_state(mod.State.NULL)
