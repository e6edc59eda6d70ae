"""gstpu_torch.ops.hsv against the JAX reference gstpu.ops.hsv.

The plain version must equal JAX's hsv_filter_frame bit for bit: over
every 24-bit colour, and on small frames for every channel layout. On
a CPU tensor the wrapper runs the plain version; the CUDA kernel it
launches on the card is held against the plain version by
chip_smoke.py. The kernel takes jnp.mod by compare and subtract where
its argument is known to lie within 4 moduli, and hp mod 2 by a floor;
each form, written in torch here, must equal the plain version's fmod
form bit for bit over its argument's range.

hsvdetector's ops (`hsv_detect`, `hsv_detect_frame`) are torch ops on
the same planes and must equal JAX's bit for bit over every colour, for
key windows at both ends of the hue circle and the widest one, in every
alpha-capable output layout; the element runs the same launch strings
as gstpu's with equal frames.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.ops.hsv import hsv_detect as jax_hsv_detect
from gstpu.ops.hsv import hsv_detect_frame as jax_hsv_detect_frame
from gstpu.ops.hsv import hsv_filter_frame as jax_hsv_filter_frame
from gstpu_torch.elements.video.hsv import _LAYOUTS
from gstpu_torch.ops import fma_f32
from gstpu_torch.ops.hsv import (HSV_KERNEL, _floor_mod, hsv_detect,
                                 hsv_detect_frame, hsv_filter_frame,
                                 hsv_filter_frame_ref)

PARAMS = [(12.0, 1.1, 0.0, 0.9, 0.02),
          (-47.5, 0.8, 0.05, 1.3, -0.1),
          (200.0, 1.5, -0.2, 0.7, 0.1)]


def _jax(frame: np.ndarray, rgb_idx, params) -> np.ndarray:
    return np.asarray(jax_hsv_filter_frame(
        jnp.asarray(frame), tuple(rgb_idx),
        *[jnp.float32(p) for p in params]))


def test_plain_matches_jax_on_every_colour():
    """All 2^24 colours, alpha carrying a byte pattern, bitwise."""
    p = np.arange(1 << 24, dtype=np.uint32)
    cube = np.stack([p & 255, (p >> 8) & 255, p >> 16, (p * 7 + 3) & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 4)
    for chunk in np.split(cube, 8):
        want = _jax(chunk, (0, 1, 2), PARAMS[1])
        got = hsv_filter_frame_ref(torch.from_numpy(chunk), (0, 1, 2),
                                   *PARAMS[1]).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("fmt", sorted(_LAYOUTS))
def test_plain_matches_jax_per_layout(fmt, params):
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (37, 53, len(fmt)), dtype=np.uint8)
    rgb_idx, _ = _LAYOUTS[fmt]
    want = _jax(frame, rgb_idx, params)
    got = hsv_filter_frame_ref(torch.from_numpy(frame), rgb_idx, *params)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_matches_pallas_interpret():
    """The Pallas tile kernels in interpret mode, at the shape the JAX
    package's own test uses."""
    from gstpu.ops.hsv_pallas import hsv_filter_frame_pallas
    rng = np.random.default_rng(21)
    rgb = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    args = (40.0, 1.2, -0.1, 0.9, 0.05)
    want = np.asarray(hsv_filter_frame_pallas(rgb, *args, interpret=True))
    got = hsv_filter_frame_ref(torch.from_numpy(rgb), (0, 1, 2), *args)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(4)
    frame = torch.from_numpy(rng.integers(0, 256, (8, 16, 4),
                                          dtype=np.uint8))
    before = frame.clone()
    launches = HSV_KERNEL.launches
    got = hsv_filter_frame(frame, (2, 1, 0), *PARAMS[0])
    assert torch.equal(got, hsv_filter_frame_ref(frame, (2, 1, 0),
                                                 *PARAMS[0]))
    assert torch.equal(frame, before)        # out of place
    assert HSV_KERNEL.launches == launches   # no kernel on the CPU


def test_wrapper_refuses_other_devices_and_cpu_out():
    meta = torch.empty((4, 4, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        hsv_filter_frame(meta, (0, 1, 2), *PARAMS[0])
    cpu = torch.zeros((4, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        hsv_filter_frame(cpu, (0, 1, 2), *PARAMS[0], out=cpu)


def _wrap_once(x: torch.Tensor) -> torch.Tensor:
    """hsv_filter.cu's mod 360 of the hue, given in [0, 360]: one
    compare and subtract."""
    return torch.where(x >= 360.0, x - 360.0, x)


def _floor_mod_near(a: torch.Tensor) -> torch.Tensor:
    """hsv_filter.cu's fmod_near(a, 360) (|a| < 4 x 360, by compare and
    subtract, sign of a) and the sign fix after it."""
    x = a.abs()
    x = torch.where(x >= 720.0, x - 720.0, x)
    x = torch.where(x >= 360.0, x - 360.0, x)
    r = torch.copysign(x, a)
    return torch.where(r < 0.0, r + 360.0, r)


def _mod2_by_floor(hp: torch.Tensor) -> torch.Tensor:
    """hsv_filter.cu's mod 2 of hp >= -0: hp - 2 floor(hp / 2) as one
    FMA, the floor taken by an add of 2^23 rounded toward zero, which
    gives +0 for -0."""
    return fma_f32(torch.floor(hp * 0.5) + 0.0, -2.0, hp)


def _ulps_around(vals):
    out = []
    for v in np.asarray(vals, np.float32):
        out += [np.nextafter(v, np.float32(-np.inf)), v,
                np.nextafter(v, np.float32(np.inf))]
    return out


# each form of the kernel's jnp.mod, over the range its argument is
# proven to lie in: the hue after its "+ 360 if negative"; the shifted
# hue for |hue_shift| <= 360; hp = h / 60, h in [-0, 360]
@pytest.mark.parametrize("form,m,lo,hi", [
    (_wrap_once, 360.0, 0.0, 360.0),
    (_floor_mod_near, 360.0, -360.0, 720.0),
    (_mod2_by_floor, 2.0, 0.0, 6.0000005)])
def test_kernel_mod_forms_match_floor_mod(form, m, lo, hi):
    lo32, hi32 = np.float32(lo), np.float32(hi)
    edges = [v for v in _ulps_around([lo, hi, 0.0, m, 2 * m, 3 * m, -m])
             if lo32 <= v <= hi32] + [np.float32(-0.0)]
    rng = np.random.default_rng(int(m * 10 + hi))
    samples = rng.uniform(lo, hi, 10 ** 6).astype(np.float32)
    a = torch.from_numpy(np.concatenate([np.array(edges, np.float32),
                                         samples]))
    assert a.min() >= lo32 and a.max() <= hi32
    got, want = form(a), _floor_mod(a, m)
    # bit patterns, so -0.0 and +0.0 differ
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if lo < 0:  # fmodf(-360, 360) is -0.0
        assert set(got[a == -360.0].view(torch.int32).tolist()) == \
            {int(np.float32(-0.0).view(np.int32))}


@pytest.mark.parametrize("hue_shift", [-360.0, 360.0, 359.99997, 725.5])
def test_plain_matches_jax_at_the_mod_edges(hue_shift):
    """Shifts at and past the kernel's fmod_near range, on every grey
    (hue 0, so hue + shift = shift) and seeded colours."""
    rng = np.random.default_rng(17)
    frame = rng.integers(0, 256, (64, 1024, 4), dtype=np.uint8)
    frame[0, :256, :3] = np.arange(256, dtype=np.uint8)[:, None]
    params = (hue_shift, 1.1, 0.0, 0.9, 0.02)
    want = _jax(frame, (0, 1, 2), params)
    got = hsv_filter_frame_ref(torch.from_numpy(frame), (0, 1, 2), *params)
    np.testing.assert_array_equal(got.numpy(), want)


# (hue_ref, hue_var, sat_ref, sat_var, val_ref, val_var): the element's
# defaults, windows that wrap around 0 and 360, the widest hue window,
# and two inside the circle
DETECT_PARAMS = [(0.0, 10.0, 0.0, 0.15, 0.0, 0.3),
                 (359.9, 20.0, 0.5, 0.5, 0.5, 0.5),
                 (0.1, 180.0, 1.0, 0.3, 1.0, 0.3),
                 (120.0, 60.0, 0.0, 0.15, 0.0, 0.3),
                 (200.5, 33.3, 0.7, 0.2, 0.4, 0.35)]
# (input layout, output layout) pairs covering every output layout
DETECT_LAYOUTS = [("RGBA", "RGBA"), ("BGRx", "BGRA"), ("ARGB", "ARGB"),
                  ("xBGR", "ABGR"), ("BGRA", "ARGB")]


def _cube() -> np.ndarray:
    p = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([p & 255, (p >> 8) & 255, p >> 16, (p * 7 + 3) & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 4)


def _out_idx(fmt: str) -> tuple:
    (r, g, b), a = _LAYOUTS[fmt]
    return r, g, b, a


@pytest.mark.parametrize("params,layouts",
                         list(zip(DETECT_PARAMS, DETECT_LAYOUTS)))
def test_detect_matches_jax_on_every_colour(params, layouts):
    """All 2^24 colours through hsv_detect, and through hsv_detect_frame
    from one input layout into one output layout, bitwise."""
    cube = _cube()
    in_fmt, out_fmt = layouts
    rgb_idx, _ = _LAYOUTS[in_fmt]
    frame = cube[..., _perm(rgb_idx)]
    uni = [jnp.float32(p) for p in params]
    want = np.asarray(jax_hsv_detect(jnp.asarray(cube[..., :3]), *uni))
    got = hsv_detect(torch.from_numpy(cube[..., :3]), *params).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax_hsv_detect_frame(
        jnp.asarray(frame), rgb_idx, _out_idx(out_fmt), *uni))
    got = hsv_detect_frame(torch.from_numpy(frame), rgb_idx,
                           _out_idx(out_fmt), *params).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (got[..., _out_idx(out_fmt)[3]] == 255).sum() < 1 << 24


def _perm(rgb_idx) -> list:
    """Channel c of a layout frame holds cube channel k where rgb_idx[k]
    is c; the other channel holds the cube's fourth."""
    return [rgb_idx.index(c) if c in rgb_idx else 3 for c in range(4)]


def test_detect_lane_uniforms_match_per_frame():
    """A (B, H, W, C) batch whose uniforms differ across lanes ((B, 1)
    f64 tensors, as a DeviceContext passes them) equals each frame run
    alone with its own floats."""
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.integers(0, 256, (3, 24, 40, 4),
                                           dtype=np.uint8))
    lanes = [(0.0, 30.0, 0.5, 0.5, 0.5, 0.5), (350.0, 30.0, 0.5, 0.5, 0.5,
                                                0.5),
             (120.0, 90.0, 0.2, 0.4, 0.6, 0.3)]
    unis = [torch.tensor(col, dtype=torch.float64)[:, None]
            for col in zip(*lanes)]
    got = hsv_detect_frame(frames, (2, 1, 0), (0, 1, 2, 3), *unis)
    for i, params in enumerate(lanes):
        want = hsv_detect_frame(frames[i], (2, 1, 0), (0, 1, 2, 3), *params)
        assert torch.equal(got[i], want)


@pytest.mark.parametrize("in_fmt", ["RGB", "BGRx", "ARGB"])
def test_hsvdetector_launch_matches_gstpu(in_fmt):
    """The same launch string in both packages, on equal frames."""
    rng = np.random.default_rng(11)
    W, H = 24, 12
    frames = rng.integers(0, 256, (3, H, W, len(in_fmt)), dtype=np.uint8)
    (r, g, b), _ = _LAYOUTS[in_fmt]
    frames[0, :4, :, [r, g, b]] = np.array([255, 0, 0], np.uint8)[:, None,
                                                                   None]
    launch = (f'appsrc name=src caps="video/x-raw, format={in_fmt}, '
              f'width={W}, height={H}, framerate=30/1" ! hsvdetector '
              f'hue_ref=355 hue_var=25 saturation_ref=0.8 '
              f'saturation_var=0.4 value_ref=0.7 value_var=0.5 ! '
              f'appsink name=sink')
    outs = {}
    for pkg in (gstpu, gstpu_torch):
        if pkg is gstpu_torch:
            pkg.init(device="cpu")
        else:
            pkg.init()
        p = pkg.parse_launch(launch)
        src, sink = p.get_by_name("src"), p.get_by_name("sink")
        p.set_state(pkg.State.PLAYING)
        for f in frames:
            src.push_buffer(pkg.Buffer(f.reshape(-1).copy()))
        src.end_of_stream()
        p.run()
        bufs = sink.pull_all()
        outs[pkg] = (str(sink.caps), [np.asarray(b.array).reshape(-1)
                                      for b in bufs])
        p.set_state(pkg.State.NULL)
    (caps_j, frames_j), (caps_t, frames_t) = outs[gstpu], outs[gstpu_torch]
    assert caps_t == caps_j and len(frames_t) == len(frames_j) == 3
    for a, b in zip(frames_t, frames_j):
        np.testing.assert_array_equal(a, b)
    out_fmt = caps_t.split("format=")[1].split(",")[0].strip(" ()string")
    alpha = frames_t[0].reshape(H, W, 4)[..., _LAYOUTS[out_fmt][1]]
    assert (alpha[:4] == 255).all()              # the red rows match
