"""gstpu_torch's compositor/skiacompositor and videoconvert against
gstpu's.

`_blend` must equal gstpu's jitted blend bit for bit: XLA on the CPU
folds alpha/255 into one f32 scalar and contracts the blend's sum into
an FMA with the layer's product, or with the canvas's product where the
layer covers the whole canvas; the port does the same FMA (the plain
sum, without an FMA, differs from gstpu at .5 ties). Canvases here are
partly and wholly covered. A pad with its own
size goes
through videoscale's linear `_resize`, so there the canvas is held
within 1 LSB with its differing bytes counted. videoconvert is gstpu's
host numpy, copied, and must give the same bytes for every format.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.core.caps import parse_caps as jax_parse_caps
from gstpu.core.element import Pad as JaxPad
from gstpu.core.element import PadDirection as JaxPadDirection
from gstpu.core.element import PadPresence as JaxPadPresence
from gstpu.core.element import PadTemplate as JaxPadTemplate
from gstpu.core.event import CapsEvent as JaxCapsEvent
from gstpu.core.event import EosEvent as JaxEosEvent
from gstpu.core.event import Segment as JaxSegment
from gstpu.core.event import SegmentEvent as JaxSegmentEvent
from gstpu.core.event import StreamStartEvent as JaxStreamStartEvent
from gstpu.core.registry import make as jax_make
from gstpu.core.video import VideoInfo as JaxVideoInfo
from gstpu.elements.video import convert as jax_convert
from gstpu.elements.video.compositor import _blend as jax_blend
from gstpu_torch.core.caps import parse_caps
from gstpu_torch.core.element import Pad, PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.event import (CapsEvent, EosEvent, Segment,
                                    SegmentEvent, StreamStartEvent)
from gstpu_torch.core.registry import make
from gstpu_torch.core.video import VideoInfo
from gstpu_torch.elements.video import convert
from gstpu_torch.elements.video.compositor import _blend
from torch_session import torch_test_limit  # noqa: F401


@pytest.fixture(autouse=True)
def _port_on_cpu():
    gstpu_torch.init(device="cpu")


class _Pkg:
    """The names a compositor test needs, from either package."""

    def __init__(self, port: bool):
        if port:
            self.Pad, self.PadTemplate = Pad, PadTemplate
            self.SRC, self.SINK = PadDirection.SRC, PadDirection.SINK
            self.ALWAYS = PadPresence.ALWAYS
            self.Caps, self.parse_caps = gstpu_torch.Caps, parse_caps
            self.events = (StreamStartEvent, CapsEvent, SegmentEvent,
                           Segment, EosEvent)
            self.make, self.Buffer = make, gstpu_torch.Buffer
            self.State, self.OK = gstpu_torch.State, gstpu_torch.FlowReturn.OK
        else:
            self.Pad, self.PadTemplate = JaxPad, JaxPadTemplate
            self.SRC, self.SINK = JaxPadDirection.SRC, JaxPadDirection.SINK
            self.ALWAYS = JaxPadPresence.ALWAYS
            self.Caps, self.parse_caps = gstpu.Caps, jax_parse_caps
            self.events = (JaxStreamStartEvent, JaxCapsEvent,
                           JaxSegmentEvent, JaxSegment, JaxEosEvent)
            self.make, self.Buffer = jax_make, gstpu.Buffer
            self.State, self.OK = gstpu.State, gstpu.FlowReturn.OK


PORT, REF = _Pkg(True), _Pkg(False)


def _feed(pkg, pad, caps):
    start, caps_ev, seg_ev, seg, _ = pkg.events
    f = pkg.Pad("f", pkg.SRC, pkg.PadTemplate("src", pkg.SRC, pkg.ALWAYS,
                                              pkg.Caps.any()))
    f.link(pad)
    f.push_event(start("s"))
    f.push_event(caps_ev(pkg.parse_caps(caps)))
    f.push_event(seg_ev(seg()))
    return f


def _composite(pkg, layers, places, **props) -> list:
    """One compositor fed `layers` ((fmt, frame) each) with pad
    properties `places` (dicts); the output frames as numpy."""
    comp = pkg.make("compositor", **props)
    out = []
    cap = pkg.Pad("cap", pkg.SINK, pkg.PadTemplate("sink", pkg.SINK,
                                                   pkg.ALWAYS,
                                                   pkg.Caps.any()))
    cap.chain_function = lambda p, b: (out.append(b) or pkg.OK)
    cap.event_function = lambda p, e: True
    comp.static_pad("src").link(cap)
    comp.set_state(pkg.State.PLAYING)
    feeders = []
    for (fmt, w, h, frame), place in zip(layers, places):
        pad = comp.request_pad()
        for k, v in place.items():
            setattr(pad, k, v)
        feeders.append((_feed(pkg, pad, f"video/x-raw, format={fmt}, "
                                        f"width={w}, height={h}"), frame))
    for f, frame in feeders:
        f.push(pkg.Buffer(frame, pts=0))
    for f, _ in feeders:
        f.push_event(pkg.events[4]())
    comp.set_state(pkg.State.NULL)
    return [np.asarray(b.array).reshape(-1) for b in out]


def test_compositor_places_and_blends():
    """Twin of tests/test_viuer_compositor_llm.py::
    test_compositor_places_and_blends on the port."""
    red = np.zeros((8, 8, 3), np.uint8)
    red[..., 0] = 200
    blue = np.zeros((8, 8, 3), np.uint8)
    blue[..., 2] = 200
    layers = [("RGB", 8, 8, red), ("RGB", 8, 8, blue)]
    places = [{}, {"xpos": 4, "ypos": 4, "alpha": 0.5}]
    out = _composite(PORT, layers, places, width=32, height=16)
    assert out
    frame = out[0].reshape(16, 32, 3)
    # layer 0 at origin: red
    assert tuple(frame[0, 0]) == (200, 0, 0)
    # background (black) outside the layers
    assert tuple(frame[15, 31]) == (0, 0, 0)
    # overlap region (4..7, 4..7): blue at alpha 0.5 over red
    r, g, b = frame[5, 5]
    assert r == 100 and b == 100        # 200*(1-0.5), 200*0.5
    # non-overlap part of layer 1: blue at 0.5 over black
    assert tuple(frame[10, 10]) == (0, 0, 100)
    assert np.array_equal(out[0], _composite(REF, layers, places, width=32,
                                             height=16)[0])


def test_skiacompositor_alias():
    el = make("skiacompositor")
    assert type(el).__name__ == "SkiaCompositor"
    assert type(el).__module__.startswith("gstpu_torch.")


@pytest.mark.parametrize("seed", range(8))
def test_blend_matches_gstpu(seed):
    rng = np.random.default_rng(seed)
    H, W = rng.integers(8, 120, 2)
    h, w = rng.integers(1, H + 1), rng.integers(1, W + 1)
    if seed % 4 == 3:                 # the layer covers the canvas
        h, w = H, W
    y0, x0 = int(rng.integers(0, H - h + 1)), int(rng.integers(0, W - w + 1))
    canvas = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    layer = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    for alpha in (0.0, 1.0, 0.5, 0.75, float(rng.random())):
        want = np.asarray(jax_blend(jnp.asarray(canvas), jnp.asarray(layer),
                                    y0, x0, jnp.float32(alpha)))
        got = _blend(torch.from_numpy(canvas.copy()),
                     torch.from_numpy(layer), y0, x0, alpha).numpy()
        assert np.array_equal(got, want), alpha


def test_pad_with_its_own_size():
    """A pad's width/height resizes its layer (linear) before the blend:
    within 1 LSB of gstpu, under 2% of bytes differing (measured: none
    of 3,072)."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (24, 18, 4), dtype=np.uint8)
    layers = [("RGB", 30, 20, a), ("RGBA", 18, 24, b)]
    places = [{"width": 17, "height": 11},
              {"xpos": 9, "ypos": 5, "width": 40, "height": 37,
               "alpha": 0.6}]
    got = _composite(PORT, layers, places, width=32, height=32)
    want = _composite(REF, layers, places, width=32, height=32)
    assert len(got) == len(want) == 1
    d = np.abs(got[0].astype(int) - want[0].astype(int))
    assert d.max() <= 1 and (d != 0).sum() <= 0.02 * d.size


@pytest.mark.parametrize("background",
                         ["black", "white", "checker", "transparent"])
def test_backgrounds_match_gstpu(background):
    rng = np.random.default_rng(11)
    g = rng.integers(0, 256, (10, 12, 1), dtype=np.uint8)
    i420 = rng.integers(0, 256, 14 * 9 + 2 * 7 * 5, dtype=np.uint8)
    layers = [("GRAY8", 12, 10, g), ("I420", 9, 14, i420)]
    places = [{"xpos": 3, "ypos": 20, "alpha": 0.8},
              {"xpos": 30, "ypos": 2, "alpha": 0.4}]
    got = _composite(PORT, layers, places, width=35, height=33,
                     background=background)
    want = _composite(REF, layers, places, width=35, height=33,
                      background=background)
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0], want[0])


_FORMATS = ("RGBA", "BGRA", "ARGB", "ABGR", "RGBx", "BGRx", "xRGB", "xBGR",
            "RGB", "BGR", "GRAY8", "I420")


@pytest.mark.parametrize("fmt", _FORMATS)
def test_videoconvert_matches_gstpu(fmt):
    """`_to_rgb` and `_from_rgb` give gstpu's bytes for every format, on
    an odd-sized frame."""
    rng = np.random.default_rng(len(fmt))
    w, h = 13, 7
    size = JaxVideoInfo(fmt, w, h).size
    raw = rng.integers(0, 256, size, dtype=np.uint8)
    got = convert._to_rgb(VideoInfo(fmt, w, h), gstpu_torch.Buffer(raw))
    want = jax_convert._to_rgb(JaxVideoInfo(fmt, w, h), gstpu.Buffer(raw))
    assert got.shape == want.shape == (h, w, 3)
    assert np.array_equal(got, want)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    assert np.array_equal(convert._from_rgb(rgb, fmt),
                          jax_convert._from_rgb(rgb, fmt))


@pytest.mark.parametrize("fmt", _FORMATS)
def test_to_rgb_tensor_matches_gstpu(fmt):
    """The compositor's torch form of `_to_rgb` gives gstpu's bytes for
    every format, from a host frame and from a tensor payload."""
    rng = np.random.default_rng(100 + len(fmt))
    for w, h in ((13, 7), (255, 129)):
        size = JaxVideoInfo(fmt, w, h).size
        raw = rng.integers(0, 256, size, dtype=np.uint8)
        want = jax_convert._to_rgb(JaxVideoInfo(fmt, w, h), gstpu.Buffer(raw))
        for payload in (raw, torch.from_numpy(raw.copy())):
            got = convert.to_rgb_tensor(VideoInfo(fmt, w, h),
                                        gstpu_torch.Buffer(payload),
                                        torch.device("cpu"))
            assert got.shape == (h, w, 3) and got.dtype == torch.uint8
            assert np.array_equal(got.numpy(), want)


def test_tensor_layers_match_gstpu():
    """GRAY8, I420 and RGBA frames that arrive as tensors are converted
    where they lie; the canvas equals gstpu's on the same bytes."""
    rng = np.random.default_rng(12)
    g = rng.integers(0, 256, (10, 12, 1), dtype=np.uint8)
    i420 = rng.integers(0, 256, 14 * 9 + 2 * 7 * 5, dtype=np.uint8)
    rgba = rng.integers(0, 256, (6, 11, 4), dtype=np.uint8)
    layers = [("GRAY8", 12, 10, g), ("I420", 9, 14, i420),
              ("RGBA", 11, 6, rgba)]
    places = [{"xpos": 3, "ypos": 20, "alpha": 0.8},
              {"xpos": 30, "ypos": 2, "alpha": 0.4},
              {"xpos": 1, "ypos": 1, "alpha": 0.7}]
    want = _composite(REF, layers, places, width=35, height=33)
    got = _composite(PORT, [(f, w, h, torch.from_numpy(x))
                            for f, w, h, x in layers], places,
                     width=35, height=33)
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0], want[0])


def _run(pkg, launch: str) -> list:
    p = pkg.parse_launch(launch)
    p.set_state(pkg.State.PLAYING)
    p.run()
    bufs = p.get_by_name("sink").pull_all()
    p.set_state(pkg.State.NULL)
    return bufs


def test_videoconvert_rgba_to_i420_roundtrip():
    """Twin of tests/test_video_convert_image.py::
    test_videoconvert_rgba_to_i420_roundtrip, and gstpu's bytes."""
    launch = ("videotestsrc num-buffers=1 pattern=gradient ! "
              "video/x-raw, format=RGBA, width=64, height=48 ! "
              "videoconvert ! video/x-raw, format=I420 ! "
              "videoconvert ! video/x-raw, format=RGB ! appsink name=sink")
    got = _run(gstpu_torch, launch)
    vi = VideoInfo("RGB", 64, 48)
    rgb = vi.view(got[0])
    src = VideoInfo("RGBA", 64, 48).view(_run(
        gstpu_torch, "videotestsrc num-buffers=1 pattern=gradient ! "
        "video/x-raw, format=RGBA, width=64, height=48 ! "
        "appsink name=sink")[0])[..., :3]
    err = np.abs(rgb.astype(int) - src.astype(int))
    assert err.mean() < 6 and err.max() < 60
    assert got[0].to_bytes() == _run(gstpu, launch)[0].to_bytes()
