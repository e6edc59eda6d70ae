"""gstpu_torch's YOLOX and analytics elements against gstpu's.

The port's nn.Module forward is held against gstpu's `yolox_forward` on
the same parameters (gstpu's HWIO dict carried over by
`params_from_gstpu`), with BN statistics and biases randomised as
tests/test_yolox.py does: within that test's rtol 2e-3 / atol 2e-4, and
within MAX_ABS_DIFF absolute (measured: at most 4.8e-7 over the four
cases below, on outputs of magnitude ~1). A checkpoint crosses in both
directions: a .pth the port saves loads through gstpu's
`load_torch_checkpoint`, and a Megvii-format .pth (the independent
torch model of tests/test_yolox.py, with BatchNorm's counters) loads
strictly into the port. The detection decode, NMS, the palm decoder and
the combiner/splitter are gstpu's host code, copied: bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.core.registry import make as jax_make
from gstpu.elements.analytics import analytics as jax_analytics
from gstpu.ops import detection as jax_detection
from gstpu.ops import yolox as jax_yolox
from gstpu_torch.core import device as device_mod
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps, parse_caps
from gstpu_torch.core.element import (FlowReturn, Pad, PadDirection,
                                      PadPresence, PadTemplate, State)
from gstpu_torch.core.event import (CapsEvent, EosEvent, Segment,
                                    SegmentEvent, StreamStartEvent)
from gstpu_torch.core.harness import Harness
from gstpu_torch.core.registry import make
from gstpu_torch.core.video import VideoInfo
from gstpu_torch.elements.analytics.analytics import (
    AnalyticsBatchMeta, AnalyticsRelationMeta, TensorMeta,
    decode_palm_detections, palm_rotation_from_keypoints)
from gstpu_torch.ops import yolox
from gstpu_torch.ops.detection import nms, yolox_decode, yolox_grids

MAX_ABS_DIFF = 2e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    gstpu_torch.init(device="cpu")


def _randomised(params: dict, seed: int) -> dict:
    """BN statistics, BN affine and conv biases drawn as
    tests/test_yolox.py:343-352 draws them."""
    rng = np.random.default_rng(seed)
    out = dict(params)
    draws = {"running_mean": (-0.2, 0.2), "running_var": (0.5, 1.5),
             "bn.weight": (0.8, 1.2), "bias": (-0.1, 0.1)}
    for k, v in params.items():
        for end, (lo, hi) in draws.items():
            if k.endswith(end):
                out[k] = rng.uniform(lo, hi, v.shape).astype(np.float32)
                break
    return out


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    assert np.abs(got - want).max() <= MAX_ABS_DIFF


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
@pytest.mark.parametrize("size", ["nano", "tiny"])
def test_forward_matches_gstpu(size, hw):
    params = _randomised(jax_yolox.init_params(5, seed=2, size=size), 9)
    img = np.random.default_rng(11).random(hw + (3,), dtype=np.float32)
    want = np.asarray(jax_yolox.yolox_forward(params, jnp.asarray(img)))
    got = yolox.yolox_forward(params, torch.from_numpy(img))
    assert got.shape == (sum((hw[0] // s) * (hw[1] // s)
                             for s in (8, 16, 32)), 10)
    _close(got, want)
    model = yolox.build_model(params)
    assert torch.equal(yolox.forward(model, torch.from_numpy(img)), got)


@pytest.mark.parametrize("size", ["nano", "tiny", "s"])
def test_state_dict_names_are_gstpus(size):
    ref = jax_yolox.init_params(80, seed=0, size=size)
    state = yolox.YoloX(80, size).state_dict()
    assert sorted(state) == sorted(k for k in ref if k != "__meta__")
    carried = yolox.params_from_gstpu(ref)
    for k, t in state.items():
        assert carried[k].shape == t.shape, k
    assert all(k.endswith(("running_mean", "running_var"))
               for k, _ in yolox.YoloX(80, size).named_buffers())


def test_entry_points_run_on_the_default_device(monkeypatch):
    """`build_model` without a device and `yolox_forward` on a numpy image
    use the default device, never the CPU of their own accord ("meta"
    stands in for the card here: shapes without data)."""
    monkeypatch.setattr(device_mod, "_device", torch.device("meta"))
    params = yolox.init_params(num_classes=3, seed=1, size="nano")
    model = yolox.build_model(params)
    assert {p.device.type for p in model.state_dict().values()} == {"meta"}
    out = yolox.yolox_forward(params, np.zeros((64, 32, 3), np.float32))
    assert out.device.type == "meta"
    assert out.shape == (yolox_grids(32, 64)[0].shape[0], 8)


def test_checkpoint_is_checked_once_strictly(tmp_path):
    """`load_torch_checkpoint` only reads; `build_model`'s strict load
    refuses a name the model does not have."""
    params = yolox.init_params(num_classes=2, seed=3, size="nano")
    state = yolox.build_model(params).state_dict()
    state["head.extra.weight"] = torch.zeros(1)
    path = tmp_path / "bad.pth"
    torch.save({"model": state}, str(path))
    read = yolox.load_torch_checkpoint(str(path))
    assert "head.extra.weight" in read
    with pytest.raises(RuntimeError, match="head.extra.weight"):
        yolox.build_model(read, num_classes=2, size="nano")


def test_init_params_equal_gstpus():
    for size in ("nano", "s"):
        want = jax_yolox.init_params(3, seed=4, size=size)
        got = yolox.init_params(3, seed=4, size=size)
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[k], want[k]) and
                   got[k].dtype == want[k].dtype for k in got)


def test_depthwise_weight_layout():
    params = jax_yolox.init_params(2, seed=1, size="nano")
    name = "backbone.backbone.dark2.0.dconv.conv.weight"
    hwio = params[name]
    assert hwio.shape[2] == 1
    oihw = yolox.params_from_gstpu(params)[name]
    assert oihw.shape == (hwio.shape[3], 1, hwio.shape[0], hwio.shape[1])
    assert np.array_equal(oihw.numpy()[:, 0], hwio[..., 0, :]
                          .transpose(2, 0, 1))


@pytest.mark.parametrize("size", ["nano", "tiny"])
def test_port_checkpoint_loads_in_gstpu(tmp_path, size):
    params = _randomised(jax_yolox.init_params(5, seed=6, size=size), 3)
    model = yolox.build_model(params)
    path = tmp_path / f"yolox_{size}.pth"
    torch.save({"model": model.state_dict()}, str(path))
    back = jax_yolox.load_torch_checkpoint(str(path), 5, size)
    assert all(np.array_equal(back[k], params[k]) for k in params)
    img = np.random.default_rng(5).random((64, 64, 3), dtype=np.float32)
    want = np.asarray(jax_yolox.yolox_forward(back, jnp.asarray(img)))
    _close(yolox.forward(model, torch.from_numpy(img)), want)


def test_megvii_checkpoint_loads_strictly(tmp_path):
    """The independent official-architecture model of tests/test_yolox.py
    saves a Megvii-format .pth (with `num_batches_tracked`): the port
    loads it strictly and reproduces that model and gstpu."""
    from test_yolox import _torch_yolox
    torch.manual_seed(3)
    ref = _torch_yolox(5, "tiny").eval()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.8, 1.2)
                m.bias.uniform_(-0.1, 0.1)
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.uniform_(-0.1, 0.1)
    path = tmp_path / "yolox_tiny.pth"
    torch.save({"model": ref.state_dict()}, str(path))
    state = yolox.load_torch_checkpoint(str(path))
    assert not any(k.endswith("num_batches_tracked") for k in state)
    model = yolox.build_model(state, num_classes=5, size="tiny")
    img = np.random.default_rng(11).random((64, 64, 3), dtype=np.float32)
    got = yolox.forward(model, torch.from_numpy(img))
    with torch.no_grad():
        theirs = ref(torch.from_numpy(img.transpose(2, 0, 1)[None]))[0]
    _close(got, theirs)
    want = jax_yolox.yolox_forward(
        jax_yolox.load_torch_checkpoint(str(path), 5, "tiny"), img)
    _close(got, want)


def test_params_npz_roundtrip(tmp_path):
    """Twin of tests/test_yolox.py::test_params_npz_roundtrip; the .npz
    crosses between the packages bit for bit."""
    p = yolox.init_params(num_classes=2, seed=7)
    f = tmp_path / "w.npz"
    yolox.save_params(str(f), p)
    q = yolox.load_params(str(f))
    r = jax_yolox.load_params(str(f))
    assert sorted(p) == sorted(q) == sorted(r)
    assert all(np.array_equal(p[k], q[k]) and np.array_equal(p[k], r[k])
               for k in p)
    g = tmp_path / "gstpu.npz"
    jax_yolox.save_params(str(g), jax_yolox.init_params(2, seed=7))
    s = yolox.load_params(str(g))
    assert all(np.array_equal(p[k], s[k]) for k in p)
    img = torch.from_numpy(np.random.default_rng(0).random(
        (32, 32, 3), dtype=np.float32))
    a = yolox.yolox_forward(p, img)
    assert torch.equal(a, yolox.yolox_forward(q, img))
    assert torch.equal(a, yolox.yolox_forward(s, img))


def test_forward_shape_matches_grids():
    params = yolox.init_params(num_classes=3, seed=1)
    img = torch.zeros((64, 96, 3))
    out = yolox.yolox_forward(params, img).numpy()
    grids, _ = yolox_grids(96, 64)
    assert out.shape == (grids.shape[0], 5 + 3)
    # raw logits (yolox_decode applies grid/stride/sigmoid)
    assert np.isfinite(out).all()


def _run(pkg, launch: str) -> list:
    p = pkg.parse_launch(launch)
    out = p.get_by_name("out")
    p.set_state(pkg.State.PLAYING)
    p.run()
    bufs = out.pull_all()
    p.set_state(pkg.State.NULL)
    return bufs


@pytest.mark.parametrize("factory", ["yoloxinference", "burn-yoloxinference"])
def test_inference_pipeline_attaches_detections(factory):
    """Twin of tests/test_yolox.py::
    test_inference_pipeline_attaches_detections, against gstpu's run."""
    launch = ("videotestsrc num-buffers=2 pattern=gradient ! "
              "video/x-raw, format=RGB, width=64, height=64, "
              f"framerate=30/1 ! {factory} num_classes=2 ! "
              "yoloxtensordec num_classes=2 score_threshold=0.05 ! "
              "appsink name=out")
    bufs = _run(gstpu_torch, launch)
    ref = _run(gstpu, launch.replace(factory, "yoloxinference"))
    assert len(bufs) == len(ref) == 2
    for b, r in zip(bufs, ref):
        tm = b.get_meta(TensorMeta)
        assert tm is not None and tm.data.shape == (84, 7)
        assert isinstance(tm.data, np.ndarray)
        _close(tm.data, r.get_meta(jax_analytics.TensorMeta).data)
        rm = b.get_meta(AnalyticsRelationMeta)
        assert rm is not None
        for d in rm.detections:
            assert 0 <= d.score <= 1
            assert d.class_id in (0, 1)
        want = r.get_meta(jax_analytics.AnalyticsRelationMeta).detections
        assert [d.class_id for d in rm.detections] == \
            [d.class_id for d in want]


def test_inference_reads_a_checkpoint(tmp_path):
    """model-file takes the port's .pth and gstpu's .npz; both give the
    forward of the same parameters."""
    params = _randomised(jax_yolox.init_params(2, seed=1, size="nano"), 4)
    npz, pth = tmp_path / "w.npz", tmp_path / "w.pth"
    jax_yolox.save_params(str(npz), params)
    torch.save({"model": yolox.build_model(params).state_dict()}, str(pth))
    frame = np.random.default_rng(2).integers(0, 256, (64, 64, 3),
                                               dtype=np.uint8)
    x = torch.from_numpy(frame).to(torch.float32) / torch.tensor(255.0)
    want = yolox.yolox_forward(params, x).numpy()
    for path in (npz, pth):
        h = Harness(make("yoloxinference", model_file=str(path),
                         model_size="nano", num_classes=2))
        h.set_caps("video/x-raw, format=RGB, width=64, height=64, "
                   "framerate=30/1")
        h.push(VideoInfo("RGB", 64, 64).make_buffer(frame))
        assert np.array_equal(h.pull().get_meta(TensorMeta).data, want)
        h.teardown()


# -- detection decode and the analytics host elements ---------------------

def test_nms_suppresses_overlaps():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 10, 10], [50, 50, 5, 5]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7])
    keep = nms(boxes, scores, 0.5)
    assert keep == [0, 2]


def test_yolox_decode_finds_planted_box():
    W = H = 640
    grids, ss = yolox_grids(W, H)
    A = grids.shape[0]
    pred = np.full((A, 85), -10.0, np.float32)  # all scores ~0
    # plant one confident detection at stride-8 grid cell (10, 12)
    idx = int(np.nonzero((grids[:, 0] == 10) & (grids[:, 1] == 12)
                         & (ss == 8))[0][0])
    pred[idx, :2] = 0.5           # center offset
    pred[idx, 2:4] = np.log(4.0)  # 32x32 px box
    pred[idx, 4] = 10.0           # objectness
    pred[idx, 5 + 17] = 10.0      # class 17
    dets = yolox_decode(pred, W, H, score_threshold=0.5)
    assert len(dets) == 1
    d = dets[0]
    assert d.class_id == 17
    assert d.score > 0.99
    assert abs((d.x + d.w / 2) - 10.5 * 8) < 1e-3
    assert abs(d.w - 32.0) < 1e-3


@pytest.mark.parametrize("seed", range(3))
def test_decode_matches_gstpu(seed):
    rng = np.random.default_rng(seed)
    w, h = (96, 64) if seed else (64, 64)
    A = yolox_grids(w, h)[0].shape[0]
    pred = (rng.standard_normal((A, 5 + 7)) * 2).astype(np.float32)
    for thr in (0.2, 0.5):
        got = yolox_decode(pred, w, h, thr, 0.45)
        want = jax_detection.yolox_decode(pred, w, h, thr, 0.45)
        assert [dataclasses.astuple(d) for d in got] == \
            [dataclasses.astuple(d) for d in want]
    assert np.array_equal(np.stack(yolox_grids(w, h)[0]),
                          np.stack(jax_detection.yolox_grids(w, h)[0]))


def test_yoloxtensordec_element():
    W = H = 320
    grids, _ = yolox_grids(W, H)
    pred = np.full((grids.shape[0], 85), -10.0, np.float32)
    pred[0, 4] = 8.0
    pred[0, 5] = 8.0
    el = make("yoloxtensordec", image_width=W, image_height=H)
    h = Harness(el)
    h.set_caps("application/x-tensor, type=yolox")
    h.push(Buffer(pred.tobytes(), pts=0))
    out = h.pull()
    meta = out.get_meta(AnalyticsRelationMeta)
    assert meta is not None and len(meta.detections) == 1
    assert meta.detections[0].class_id == 0
    h.teardown()


def _feeder(name):
    return Pad(name, PadDirection.SRC,
               PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                           Caps.any()))


def test_combiner_splitter_roundtrip():
    """Twin of tests/test_analytics.py::test_combiner_splitter_roundtrip."""
    comb = make("analyticscombiner")
    split = make("analyticssplitter")
    comb.static_pad("src").link(split.static_pad("sink"))
    comb.set_state(State.PLAYING)
    split.set_state(State.PLAYING)
    outs = {}

    def on_pad(el, pad):
        sink = Pad(f"cap-{pad.name}", PadDirection.SINK,
                   PadTemplate("sink", PadDirection.SINK,
                               PadPresence.ALWAYS, Caps.any()))
        lst = outs.setdefault(pad.name, [])
        sink.chain_function = \
            lambda p, b, lst=lst: (lst.append(b), FlowReturn.OK)[1]
        sink.event_function = lambda p, ev: True
        pad.link(sink)

    split.connect("pad-added", on_pad)
    feeders = []
    for i in range(3):
        f = _feeder(f"f{i}")
        f.link(comb.request_pad())
        f.push_event(StreamStartEvent(f"s{i}"))
        f.push_event(CapsEvent(parse_caps(f"video/x-raw, format=RGB, "
                                          f"width={16 * (i + 1)}, "
                                          f"height=16, framerate=30/1")))
        f.push_event(SegmentEvent(Segment()))
        feeders.append(f)
    for n in range(4):
        for i, f in enumerate(feeders):
            f.push(Buffer(bytes([i, n]), pts=n * 10**8))
    for f in feeders:
        f.push_event(EosEvent())
    assert set(outs) == {"src_sink_0", "src_sink_1", "src_sink_2"}
    for i in range(3):
        bufs = outs[f"src_sink_{i}"]
        assert len(bufs) == 4
        assert [b.to_bytes()[1] for b in bufs] == [0, 1, 2, 3]
        assert bufs[0].to_bytes()[0] == i
    assert AnalyticsBatchMeta.__module__.startswith("gstpu_torch.")


def test_palm_rotation_reference_values():
    import math
    # imp.rs:806 hand alignment offset test
    assert abs(palm_rotation_from_keypoints((0, 0), (1, 0))
               - math.pi / 2) < 1e-6


def _palm_rows(rng, n):
    rows = rng.random((n, 8)).astype(np.float32)
    rows[:, 3] *= 0.3
    return rows


def test_palm_decode_matches_gstpu():
    rng = np.random.default_rng(4)
    for _ in range(5):
        rows = _palm_rows(rng, 12)
        for size in (None, (192, 108)):
            got = decode_palm_detections(rows, video_size=size, max_hands=3)
            want = jax_analytics.decode_palm_detections(
                rows, video_size=size, max_hands=3)
            assert [(dataclasses.astuple(d), d.rotation) for d in got] == \
                [(dataclasses.astuple(d), d.rotation) for d in want]


def test_handdetectiontensordec():
    """Twin of tests/test_yolox.py::test_handdetectiontensordec, and
    gstpu's element on the same buffer."""
    # two overlapping palms + one below threshold
    rows = np.array([
        [0.9, 0.5, 0.5, 0.1, 0.5, 0.55, 0.5, 0.45],
        [0.8, 0.51, 0.5, 0.1, 0.51, 0.55, 0.51, 0.45],   # overlaps
        [0.2, 0.2, 0.2, 0.1, 0.2, 0.25, 0.2, 0.15],      # low score
    ], np.float32)
    caps = "video/x-raw, format=RGB, width=192, height=192, framerate=30/1"
    vi = VideoInfo("RGB", 192, 192)
    h = Harness(make("handdetectiontensordec"))
    h.set_caps(caps)
    b = vi.make_buffer(np.zeros((192, 192, 3), np.uint8))
    b.add_meta(TensorMeta(rows, "palm-detection"))
    h.push(b)
    rm = h.pull().get_meta(AnalyticsRelationMeta)
    assert len(rm.detections) == 1            # NMS merged, low cut
    d = rm.detections[0]
    assert d.label == "hand" and abs(d.w - 2.9 * 0.1 * 192) < 1e-3
    assert hasattr(d, "rotation")
    h.teardown()
    from gstpu.core.harness import Harness as JaxHarness
    jh = JaxHarness(jax_make("handdetectiontensordec"))
    jh.set_caps(caps)
    jb = gstpu.Buffer(np.zeros(192 * 192 * 3, np.uint8))
    jb.add_meta(jax_analytics.TensorMeta(rows, "palm-detection"))
    jh.push(jb)
    want = jh.pull().get_meta(jax_analytics.AnalyticsRelationMeta)
    assert [dataclasses.astuple(x) for x in rm.detections] == \
        [dataclasses.astuple(x) for x in want.detections]
    jh.teardown()


def _onvif_round_trip(pkg):
    """tests/test_yolox.py::test_onvif_relationmeta_roundtrip in `pkg`
    (gstpu or gstpu_torch): detections -> ONVIF XML -> detections.
    Returns (the XML meta's bytes, the detections read back)."""
    import importlib
    harness = importlib.import_module(f"{pkg}.core.harness")
    registry = importlib.import_module(f"{pkg}.core.registry")
    video = importlib.import_module(f"{pkg}.core.video")
    analytics = importlib.import_module(
        f"{pkg}.elements.analytics.analytics")
    onvif = importlib.import_module(f"{pkg}.elements.net.onvif")
    detection = importlib.import_module(f"{pkg}.ops.detection")
    vi = video.VideoInfo("RGB", 100, 200)
    caps = ("video/x-raw, format=RGB, width=100, height=200, "
            "framerate=30/1")
    to_xml = harness.Harness(registry.make("relationmeta2onvifmeta"))
    to_xml.set_caps(caps)
    b = vi.make_buffer(np.zeros((200, 100, 3), np.uint8))
    b.add_meta(analytics.AnalyticsRelationMeta(
        [detection.Detection(x=25, y=50, w=50, h=100, score=1.0,
                             class_id=7),
         detection.Detection(x=3.5, y=0.25, w=96.5, h=199.75, score=0.4,
                             class_id=0)]))
    to_xml.push(b)
    om = to_xml.pull().get_meta(onvif.OnvifMetadataFrameMeta)
    to_xml.teardown()
    assert om is not None and b"BoundingBox" in om.data
    back = harness.Harness(registry.make("onvifmeta2relationmeta"))
    back.set_caps(caps)
    b2 = vi.make_buffer(np.zeros((200, 100, 3), np.uint8))
    b2.add_meta(om)
    back.push(b2)
    rm = back.pull().get_meta(analytics.AnalyticsRelationMeta)
    back.teardown()
    return om.data, rm.detections


def test_onvif_relationmeta_roundtrip():
    """Twin of tests/test_yolox.py::test_onvif_relationmeta_roundtrip:
    the port's converters give gstpu's XML byte for byte and gstpu's
    detections on the same metas."""
    gstpu.init()
    xml, dets = _onvif_round_trip("gstpu_torch")
    want_xml, want = _onvif_round_trip("gstpu")
    assert xml == want_xml
    assert [dataclasses.astuple(d) for d in dets] == \
        [dataclasses.astuple(d) for d in want]
    d = dets[0]
    assert (round(d.x), round(d.y), round(d.w), round(d.h),
            d.class_id) == (25, 50, 50, 100, 7)
