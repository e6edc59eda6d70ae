"""gstpu_torch's videoscale against gstpu's on the same frames.

gstpu resizes with jax.image.resize in f32, rounds half to even and
clips to u8. The port builds the same arithmetic in torch ops: nearest
must equal gstpu's bit for bit; linear (an antialiased triangle when
downscaling) contracts the same per-axis weights in the same order, but
the matmuls sum in another order than XLA's CPU dots, so a byte at a .5
tie can round the other way. Linear is held within 1 LSB, and the share
of a case's differing bytes under LINEAR_SHARE = 2%. Measured over the
cases below: 108 of 131,392 bytes (0.082%); at most 0.33% of a case of
over 1,000 bytes (72x128 -> 64x64) and 2 of 132 bytes (1.5%) on the
smallest (7x5 -> 3x11, 4 channels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.elements.video.scale import _resize as jax_resize
from gstpu_torch.core.device import tf32_off
from gstpu_torch.elements.video.scale import _resize, nearest_indices
from torch_session import torch_test_limit  # noqa: F401

LINEAR_SHARE = 0.02

# (in H, W) -> (out H, W): odd sizes, up, down, one axis, mixed
SIZES = [((9, 13), (5, 7)), ((13, 9), (29, 31)), ((31, 17), (12, 40)),
         ((64, 48), (33, 47)), ((72, 128), (64, 64)), ((37, 80), (91, 80)),
         ((50, 80), (50, 41)), ((7, 5), (3, 11))]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    gstpu_torch.init(device="cpu")


def _differ(a: np.ndarray, b: np.ndarray) -> tuple[int, int]:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int((d != 0).sum()), int(d.max())


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("src,dst", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_matches_gstpu(src, dst, channels):
    rng = np.random.default_rng(src[0] * 100 + dst[1] + channels)
    img = rng.integers(0, 256, src + (channels,), dtype=np.uint8)
    for method in ("nearest", "linear"):
        want = np.asarray(jax_resize(jnp.asarray(img), *dst, method))
        got = _resize(torch.from_numpy(img), *dst, method).numpy()
        assert got.shape == want.shape == dst + (channels,)
        n, worst = _differ(got, want)
        if method == "nearest":
            assert n == 0
        else:
            assert worst <= 1 and n <= LINEAR_SHARE * want.size, (n, worst)


def test_nearest_index_is_xlas_folded_constant():
    """XLA folds (i + 0.5) * m / n into one product with f32(m * f32(1/n));
    for 50 -> 41 (and others) that picks other rows than the true
    division does, and gstpu's bytes follow the folded constant."""
    m, n = 50, 41
    i = np.arange(n, dtype=np.float32) + np.float32(0.5)
    true_div = np.floor(i * np.float32(m) / np.float32(n)).astype(np.int64)
    folded = nearest_indices(m, n).numpy()
    assert not np.array_equal(folded, true_div)
    col = np.arange(m, dtype=np.uint8)[:, None, None]
    want = np.asarray(jax_resize(jnp.asarray(col), n, 1, "nearest"))[:, 0, 0]
    assert np.array_equal(folded, want)


def _run(pkg, launch: str) -> list:
    p = pkg.parse_launch(launch)
    p.set_state(pkg.State.PLAYING)
    p.run()
    bufs = p.get_by_name("out").pull_all()
    p.set_state(pkg.State.NULL)
    return bufs


@pytest.mark.parametrize("fmt", ["RGBA", "I420"])
@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_launch_string_matches_gstpu(fmt, method):
    launch = (f"videotestsrc num-buffers=2 pattern=smpte ! video/x-raw, "
              f"format={fmt}, width=67, height=45, framerate=30/1 ! "
              f"videoscale method={method} ! video/x-raw, width=40, "
              f"height=53 ! appsink name=out")
    want = _run(gstpu, launch)
    got = _run(gstpu_torch, launch)
    assert len(got) == len(want) == 2
    assert [b.pts for b in got] == [b.pts for b in want]
    for a, b in zip(got, want):
        assert isinstance(a.data, torch.Tensor)
        x = a.data.numpy().reshape(-1)
        y = np.frombuffer(b.to_bytes(), np.uint8)
        assert x.size == y.size == (40 * 53 * 4 if fmt == "RGBA"
                                    else 40 * 53 + 2 * 20 * 27)
        n, worst = _differ(x, y)
        if method == "nearest":
            assert n == 0
        else:
            assert worst <= 1 and n <= LINEAR_SHARE * y.size


def _scale_bytes(fmt: str, method: str, raw) -> bytes:
    """One 23x17 frame through the port's videoscale to 15x30."""
    p = gstpu_torch.parse_launch(
        f'appsrc name=src caps="video/x-raw, format={fmt}, width=23, '
        f'height=17, framerate=30/1" ! videoscale method={method} ! '
        f'video/x-raw, width=15, height=30 ! appsink name=out')
    p.set_state(gstpu_torch.State.PLAYING)
    src = p.get_by_name("src")
    src.push_buffer(gstpu_torch.Buffer(raw, pts=0))
    src.end_of_stream()
    p.run()
    out = p.get_by_name("out").pull_all()
    p.set_state(gstpu_torch.State.NULL)
    assert len(out) == 1
    return out[0].to_bytes()


@pytest.mark.parametrize("fmt", ["RGBA64LE", "RGBA64BE"])
@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_16bit_formats_match_gstpu(fmt, method):
    """Values are read in the format's byte order (256 clips to 255, not
    to 1) and written back widened into it, from a host frame and from a
    tensor payload; against gstpu's `_resize` on the values its `view`
    reads. (gstpu's element itself cannot be the reference for RGBA64BE:
    its jitted `_resize` refuses a big-endian array.)"""
    dt = "<u2" if fmt == "RGBA64LE" else ">u2"
    vals = np.random.default_rng(len(fmt) + len(method)).integers(
        0, 320, (17, 23, 4)).astype(dt)
    vals[0, :4] = (255, 256, 257, 511)
    raw = vals.view(np.uint8).reshape(-1)
    m = "nearest" if method == "nearest" else "linear"
    want = np.asarray(jax_resize(jnp.asarray(vals.astype(np.uint16)), 30, 15,
                                 m)).astype(dt).reshape(-1)
    for payload in (raw, torch.from_numpy(raw.copy())):
        got = np.frombuffer(_scale_bytes(fmt, method, payload), dt)
        n, worst = _differ(got, want)
        if method == "nearest":
            assert n == 0
        else:
            assert worst <= 1 and n <= LINEAR_SHARE * want.size, (n, worst)


def test_tf32_scopes_are_counted():
    """Two scopes that close out of order (two threads) keep TF32 off
    until the last one closes, then restore what was there."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        a, b = tf32_off(), tf32_off()
        a.__enter__()
        b.__enter__()
        a.__exit__(None, None, None)
        assert [f.allow_tf32 for f in flags] == [False, False]
        b.__exit__(None, None, None)
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, before):
            f.allow_tf32 = v


def test_passthrough_at_equal_size():
    launch = ("videotestsrc num-buffers=1 pattern=snow ! video/x-raw, "
              "format=RGB, width=32, height=24 ! videoscale ! video/x-raw, "
              "width=32, height=24 ! appsink name=out")
    src = _run(gstpu_torch, launch.replace(" ! videoscale ! video/x-raw, "
                                           "width=32, height=24", ""))
    got = _run(gstpu_torch, launch)
    want = _run(gstpu, launch)
    assert isinstance(got[0].data, np.ndarray)     # the source's frame
    assert np.array_equal(got[0].data, src[0].data)
    assert got[0].to_bytes() == want[0].to_bytes()
