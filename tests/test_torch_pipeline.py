"""The port's pipelines against gstpu's on the same gst-launch strings.

Both packages register hsvfilter and colorlut under the same factory
names, each in its own registry, so one string builds one pipeline in
each. On the CPU the port runs its plain versions; the frames must be
bitwise equal to gstpu's.
"""

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.core.element import StateChangeReturn as JaxStateChangeReturn
from gstpu.core.video import VideoInfo as JaxVideoInfo
from gstpu.ops.lut import parse_cube
from gstpu_torch.core.element import StateChangeReturn
from gstpu_torch.core.video import VideoInfo
from gstpu_torch.ops.lut import lut_from_numpy
from torch_session import torch_test_limit  # noqa: F401

CUBE = "LUT_3D_SIZE 3\nDOMAIN_MIN 0.05 0.0 0.0\nDOMAIN_MAX 1.0 0.95 1.0\n" \
    + "\n".join(f"{(r * 0.37 + g * 0.2) % 1:.4f} {(g * 0.61 + b * 0.1) % 1:.4f}"
                f" {(b * 0.83 + r * 0.3) % 1:.4f}"
                for b in range(3) for g in range(3) for r in range(3)) + "\n"
HSV = "hue_shift=12 saturation_mul=1.1 value_mul=0.9 value_off=0.02"


@pytest.fixture(autouse=True)
def _port_on_cpu():
    gstpu_torch.init(device="cpu")


def _run(pkg, launch: str) -> list:
    p = pkg.parse_launch(launch)
    p.set_state(pkg.State.PLAYING)
    p.run()
    bufs = p.get_by_name("out").pull_all()
    p.set_state(pkg.State.NULL)
    return bufs


def _frames(bufs, info) -> list:
    return [info.view(b) for b in bufs]


def test_video_chain_matches_gstpu(tmp_path):
    lut = tmp_path / "grade.cube"
    lut.write_text(CUBE)
    launch = ("videotestsrc num-buffers=4 pattern=snow ! video/x-raw, "
              "format=RGBA, width=64, height=48, framerate=30/1 ! "
              f"hsvfilter {HSV} ! colorlut location={lut} ! "
              "appsink name=out")
    want = _run(gstpu, launch)
    got = _run(gstpu_torch, launch)
    assert len(got) == len(want) == 4
    assert all(isinstance(b.data, torch.Tensor) for b in got)
    assert [b.pts for b in got] == [b.pts for b in want]
    info = VideoInfo("RGBA", 64, 48)
    for a, b in zip(_frames(got, info), _frames(want, info)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["RGB", "BGR", "RGBx", "BGRx", "RGBA",
                                 "BGRA", "xRGB", "xBGR", "ARGB", "ABGR"])
def test_hsvfilter_layouts_match_gstpu(fmt):
    launch = (f"videotestsrc num-buffers=2 pattern=snow ! video/x-raw, "
              f"format={fmt}, width=40, height=24, framerate=30/1 ! "
              f"hsvfilter hue_shift=-75 saturation_mul=0.7 "
              f"saturation_off=0.1 ! appsink name=out")
    info = VideoInfo(fmt, 40, 24)
    for a, b in zip(_frames(_run(gstpu_torch, launch), info),
                    _frames(_run(gstpu, launch), info)):
        np.testing.assert_array_equal(a, b)


def _appsrc_pipelines(caps: str, chain: str):
    out = []
    for pkg in (gstpu, gstpu_torch):
        p = pkg.parse_launch(f'appsrc name=src caps="{caps}" ! {chain} ! '
                             f'appsink name=out')
        out.append((pkg, p))
    return out


def _push_all(pipes, bufs_per_pipe, between=None):
    for pkg, p in pipes:
        p.set_state(pkg.State.PLAYING)
    for i in range(len(bufs_per_pipe[0])):
        if between is not None:
            between(i)
        for (_, p), bufs in zip(pipes, bufs_per_pipe):
            p.get_by_name("src").push_buffer(bufs[i])
            while p.iterate():
                pass
    outs = [p.get_by_name("out").pull_all() for _, p in pipes]
    for pkg, p in pipes:
        p.set_state(pkg.State.NULL)
    return outs


def test_property_change_mid_stream_matches_gstpu():
    caps = "video/x-raw, format=BGRA, width=32, height=16, framerate=30/1"
    pipes = _appsrc_pipelines(caps, f"hsvfilter name=h {HSV}")
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (16, 32, 4), dtype=np.uint8)] * 4
    infos = (JaxVideoInfo("BGRA", 32, 16), VideoInfo("BGRA", 32, 16))

    def change(i):
        if i == 2:
            for _, p in pipes:
                p.get_by_name("h").set_property("hue_shift", 190.0)
                p.get_by_name("h").set_property("value_mul", 1.4)

    want, got = _push_all(
        pipes, [[info.make_buffer(f.copy(), pts=i)
                 for i, f in enumerate(frames)] for info in infos], change)
    assert len(got) == len(want) == 4
    for a, b in zip(_frames(got, infos[1]), _frames(want, infos[0])):
        np.testing.assert_array_equal(a, b)
    out = _frames(got, infos[1])
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_array_equal(out[2], out[3])
    assert not np.array_equal(out[1], out[2])


def test_colorlut_without_location_fails():
    el = gstpu_torch.make("colorlut")
    assert el.set_state(gstpu_torch.State.READY) is StateChangeReturn.FAILURE
    jel = gstpu.make("colorlut")
    assert jel.set_state(gstpu.State.READY) is JaxStateChangeReturn.FAILURE


@pytest.mark.parametrize("fmt,dt", [("RGBA64LE", "<u2"),
                                    ("RGBA64BE", ">u2")])
def test_colorlut_rgba64_matches_gstpu(fmt, dt):
    caps = f"video/x-raw, format={fmt}, width=24, height=10, framerate=30/1"
    pipes = _appsrc_pipelines(caps, "colorlut name=cl")
    src = parse_cube(CUBE)
    pipes[0][1].get_by_name("cl").set_lut(src)
    pipes[1][1].get_by_name("cl").set_lut(lut_from_numpy(
        src.table_3d, src.domain_scale, src.domain_offset, "cpu"))
    rng = np.random.default_rng(10)
    frames = [rng.integers(0, 65536, (10, 24, 4), dtype=np.uint16)
              .astype(dt) for _ in range(2)]
    infos = (JaxVideoInfo(fmt, 24, 10), VideoInfo(fmt, 24, 10))
    want, got = _push_all(pipes, [[info.make_buffer(f.copy(), pts=i)
                                   for i, f in enumerate(frames)]
                                  for info in infos])
    assert len(got) == len(want) == 2
    for a, b, f in zip(_frames(got, infos[1]), _frames(want, infos[0]),
                       frames):
        assert a.dtype == np.dtype(dt)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a[..., 3], f[..., 3])


def test_tensor_frames_stay_tensors():
    """Frames pushed as tensors are processed where they lie and the
    caller's tensor is left as it was."""
    caps = "video/x-raw, format=RGBA, width=16, height=8, framerate=30/1"
    p = gstpu_torch.parse_launch(
        f'appsrc name=src caps="{caps}" ! hsvfilter {HSV} ! '
        f'colorlut name=cl ! appsink name=out')
    p.get_by_name("cl").set_lut(parse_cube(CUBE))
    rng = np.random.default_rng(12)
    frame = torch.from_numpy(rng.integers(0, 256, (8, 16, 4),
                                          dtype=np.uint8))
    before = frame.clone()
    p.set_state(gstpu_torch.State.PLAYING)
    p.get_by_name("src").push_buffer(gstpu_torch.Buffer(frame, pts=0))
    while p.iterate():
        pass
    (out,) = p.get_by_name("out").pull_all()
    p.set_state(gstpu_torch.State.NULL)
    assert isinstance(out.data, torch.Tensor)
    assert tuple(out.data.shape) == (8, 16, 4)
    assert torch.equal(frame, before)
    assert out.size == frame.nbytes
