"""The port's `hrtfrender` and `sofalizer` and its block FFT convolution
(gstpu_torch.ops.fftconv) against gstpu's, on the CPU.

Twins of tests/test_hrtf.py (sphere round trip and barycentric blend,
the convolution goldens at 2e-5 and 1e-4, samples in == samples out,
latency, the UPC kernel against direct convolution and its partition
granularity bit for bit, partition validation, the filter switch on
rotation), plus: the sphere's bytes and `sample` bit for bit with
gstpu's, `ols_block`/`upc_block` within 1e-5 of gstpu's on the same
inputs, both elements within 1e-5 of gstpu's on the same launch strings
(directions and yaw changing mid-stream), and the error paths.
"""

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.elements.audio import hrtf as jax_hrtf
from gstpu.ops import fftconv as jax_fftconv
from gstpu_torch.core.caps import parse_caps
from gstpu_torch.core.element import MessageType
from gstpu_torch.core.harness import Harness
from gstpu_torch.core.registry import make
from gstpu_torch.elements.audio.hrtf import (HrirSphere, _sph_to_vec,
                                             load_sofa, write_sofa)
from gstpu_torch.ops.fftconv import (direct_conv_reference, ir_rfft,
                                     next_pow2, ols_block, upc_block,
                                     upc_init, upc_ir_rfft)

RATE = 44100
IR_LEN = 32
CAPS = "audio/x-raw, format=F32LE, rate={rate}, channels={ch}, " \
       "layout=interleaved"


@pytest.fixture(autouse=True)
def _port_on_cpu():
    gstpu.init()
    gstpu_torch.init(device="cpu")


def octahedron_sphere(rate=RATE, ir_len=IR_LEN):
    """6-vertex octahedron; each vertex gets a distinct delayed
    impulse as its IR so tests can identify which IR was used."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                      [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)
    faces = []
    for x in (0, 1):
        for y in (2, 3):
            for z in (4, 5):
                faces.append([x, y, z])
    indices = np.asarray(faces, np.uint32).reshape(-1)
    left = np.zeros((6, ir_len), np.float32)
    right = np.zeros((6, ir_len), np.float32)
    for v in range(6):
        left[v, v] = 1.0          # delta at delay v
        right[v, v + 6] = 0.5     # delta at delay v+6, half amplitude
    return verts, indices, left, right, rate


def dense_sphere(rng, ir_len=48):
    """bench_hrtf.py's sphere shape: 6 vertices, 8 faces, decaying
    noise IRs (shorter here)."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float64)
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    decay = np.exp(-np.arange(ir_len) / 10.0)
    left = (rng.standard_normal((6, ir_len)) * decay).astype(np.float32)
    right = (rng.standard_normal((6, ir_len)) * decay).astype(np.float32)
    return verts, faces, left, right, RATE


@pytest.fixture
def sphere_bytes():
    return HrirSphere.to_bytes(*octahedron_sphere())


def _directions(rng, n):
    d = rng.standard_normal((n, 3))
    return np.concatenate([d, [[0.0, 0.0, 1.0], [1.0, 0.0, 1.0],
                               [0.0, 0.0, 0.0], [1e-12, 0.0, 0.0]]])


@pytest.mark.parametrize("make_sphere", [
    lambda rng: octahedron_sphere(),
    dense_sphere,
    # a sphere with one face only: most directions miss it and take the
    # nearest-vertex fallback
    lambda rng: (np.eye(3, dtype=np.float32),
                 np.array([0, 1, 2], np.uint32),
                 *(rng.standard_normal((2, 3, 8)).astype(np.float32)),
                 48000),
], ids=["octahedron", "dense", "one-face"])
def test_sphere_bytes_and_sample_match_gstpu(make_sphere):
    rng = np.random.default_rng(2)
    args = make_sphere(rng)
    raw = HrirSphere.to_bytes(*args)
    assert raw == jax_hrtf.HrirSphere.to_bytes(*args)
    port, ref = HrirSphere.from_bytes(raw), \
        jax_hrtf.HrirSphere.from_bytes(raw)
    for a in ("vertices", "indices", "left", "right"):
        assert np.array_equal(getattr(port, a), getattr(ref, a))
    assert (port.rate, port.ir_len) == (ref.rate, ref.ir_len)
    for d in _directions(rng, 40):
        got, want = port.sample(d), ref.sample(d)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_sphere_roundtrip(sphere_bytes):
    s = HrirSphere.from_bytes(sphere_bytes)
    assert s.rate == RATE
    assert s.ir_len == IR_LEN
    assert s.vertices.shape == (6, 3)
    ir = s.sample(np.array([0.0, 0.0, 1.0]))
    assert ir[0, 4] == pytest.approx(1.0)
    assert ir[1, 10] == pytest.approx(0.5)
    with pytest.raises(ValueError, match="not an HRIR"):
        HrirSphere.from_bytes(b"RIFF" + sphere_bytes[4:])


def test_sphere_barycentric_blend(sphere_bytes):
    s = HrirSphere.from_bytes(sphere_bytes)
    ir = s.sample(np.array([1.0, 0.0, 1.0]))
    assert ir[0, 0] > 0 and ir[0, 4] > 0
    assert ir[0].sum() == pytest.approx(1.0, abs=1e-5)


def test_hrtfrender_convolution_golden(sphere_bytes):
    el = make("hrtfrender", hrir_raw=sphere_bytes,
              interpolation_steps=1, block_length=128)
    el.set_property("spatial_objects",
                    [{"x": 0.0, "y": 0.0, "z": 1.0, "distance-gain": 1.0}])
    h = Harness(el)
    h.set_caps(CAPS.format(rate=RATE, ch=1))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (512, 1)).astype(np.float32)
    for off in range(0, 512, 128):
        h.push(gstpu_torch.Buffer(x[off:off + 128],
                                  pts=off * 1_000_000_000 // RATE))
    out = np.concatenate([b.array.reshape(-1, 2) for b in h.pull_all()])
    assert out.shape == (512, 2)
    ir = HrirSphere.from_bytes(sphere_bytes).sample([0.0, 0.0, 1.0])
    np.testing.assert_allclose(out[:, 0], direct_conv_reference(
        x[:, 0], ir[0]), atol=2e-5)
    np.testing.assert_allclose(out[:, 1], direct_conv_reference(
        x[:, 0], ir[1]), atol=2e-5)
    h.teardown()


def test_hrtfrender_sample_accounting(sphere_bytes):
    el = make("hrtfrender", hrir_raw=sphere_bytes, block_length=512)
    el.set_property("spatial_objects",
                    [{"x": 1.0, "y": 0.0, "z": 0.0},
                     {"x": -1.0, "y": 0.0, "z": 0.0}])
    h = Harness(el)
    h.set_caps(CAPS.format(rate=RATE, ch=2))
    total = 0
    rng = np.random.default_rng(5)
    for n in (400, 512, 700, 100, 512, 333, 43):
        h.push(gstpu_torch.Buffer(
            rng.uniform(-1, 1, (n, 2)).astype(np.float32)))
        total += n
    h.push_eos()
    assert sum(b.array.reshape(-1, 2).shape[0]
               for b in h.pull_all()) == total
    h.teardown()


def test_hrtfrender_multichannel_sum(sphere_bytes):
    el = make("hrtfrender", hrir_raw=sphere_bytes,
              interpolation_steps=1, block_length=64)
    el.set_property("spatial_objects",
                    [{"x": 0.0, "y": 0.0, "z": 1.0},
                     {"x": 0.0, "y": 0.0, "z": 1.0}])
    h = Harness(el)
    h.set_caps(CAPS.format(rate=RATE, ch=2))
    x = np.zeros((64, 2), np.float32)
    x[0] = 1.0
    h.push(gstpu_torch.Buffer(x))
    out = h.pull().array.reshape(-1, 2)
    assert out[4, 0] == pytest.approx(2.0, abs=1e-5)
    h.teardown()


def test_hrtfrender_latency(sphere_bytes):
    el = make("hrtfrender", hrir_raw=sphere_bytes, block_length=512)
    el.set_property("spatial_objects", [{"z": 1.0}])
    h = Harness(el)
    h.set_caps(CAPS.format(rate=RATE, ch=1))
    q = h.query_latency()
    assert q.min_latency == 512 * 1_000_000_000 // RATE
    h.teardown()
    from gstpu.core.harness import Harness as JaxHarness
    from gstpu.core.registry import make as jax_make
    jel = jax_make("hrtfrender", hrir_raw=sphere_bytes, block_length=512)
    jel.set_property("spatial_objects", [{"z": 1.0}])
    jh = JaxHarness(jel)
    jh.set_caps(CAPS.format(rate=RATE, ch=1))
    jq = jh.query_latency()
    assert (q.min_latency, q.max_latency, q.live) == (
        jq.min_latency, jq.max_latency, jq.live)
    jh.teardown()


def _errors(el) -> list[str]:
    return [str(m.fields.get("error", m.fields))
            for m in el.bus.drain() if m.type is MessageType.ERROR]


def test_hrtfrender_error_paths(sphere_bytes):
    """No sphere, a block not divisible by the steps, and a channel
    count without as many spatial objects each stop the element with an
    error, as in gstpu."""
    el = make("hrtfrender")
    el.bus = gstpu_torch.Bus()
    assert el.start() is False
    assert "no HRIR sphere" in " ".join(_errors(el))
    caps = parse_caps(CAPS.format(rate=RATE, ch=2))
    for props, msg in (({"block_length": 100, "interpolation_steps": 8},
                        "divisible"),
                       ({}, "spatial-objects")):
        el = make("hrtfrender", hrir_raw=sphere_bytes, **props)
        el.set_property("spatial_objects", [{"z": 1.0}] * (
            2 if props else 1))
        el.bus = gstpu_torch.Bus()
        assert el.start()
        assert el.set_caps(caps, None) is False
        assert msg in " ".join(_errors(el))


# -- the convolution ops against gstpu's ------------------------------

@pytest.mark.parametrize("S,L", [(64, 512), (128, 32), (100, 1)])
def test_ols_block_matches_gstpu(S, L):
    rng = np.random.default_rng(S + L)
    C, NB = 3, 5
    ir = rng.standard_normal((C, 2, L)).astype(np.float32)
    x = rng.standard_normal((C, 1, S * NB)).astype(np.float32)
    nfft = next_pow2(S + L - 1)
    ir_f = torch.fft.rfft(torch.from_numpy(ir), n=nfft)
    assert np.abs(ir_f.numpy() - ir_rfft(ir, S)).max() < 1e-5
    jir_f = np.fft.rfft(ir, n=nfft).astype(np.complex64)
    hist = torch.zeros((C, 1, max(L - 1, 0)))
    jhist = np.zeros((C, 1, max(L - 1, 0)), np.float32)
    outs, jouts = [], []
    for b in range(NB):
        seg = x[..., b * S:(b + 1) * S]
        hist, y = ols_block(hist, torch.from_numpy(seg), ir_f, ir_len=L)
        jhist, jy = jax_fftconv.ols_block(jhist, seg, jir_f, ir_len=L)
        assert y.dtype == torch.float32 and jy.dtype == np.float32
        outs.append(y.numpy())
        jouts.append(np.asarray(jy))
    got, want = np.concatenate(outs, -1), np.concatenate(jouts, -1)
    assert np.abs(got - want).max() < 1e-5
    assert np.array_equal(hist.numpy(), np.asarray(jhist))
    gold = np.stack([[np.convolve(x[c, 0], ir[c, e])[:S * NB]
                      for e in range(2)] for c in range(C)])
    assert np.abs(got - gold).max() < 1e-4


def test_upc_kernel_matches_direct_conv():
    """upc_block renders the exact linear convolution, streamed at
    either block or partition granularity (reference sofa/imp.rs
    uniformly partitioned convolution, partition-length 64)."""
    rng = np.random.default_rng(7)
    C, L, P, S, NB = 3, 200, 64, 256, 4
    ir = rng.standard_normal((C, 2, L)).astype(np.float32)
    x = rng.standard_normal((C, 1, S * NB)).astype(np.float32)
    h_f = upc_ir_rfft(torch.from_numpy(ir), part_len=P)

    def run(blk):
        state = upc_init((C, 1), L, P, device="cpu")
        outs = []
        for b in range(S * NB // blk):
            state, y = upc_block(state, torch.from_numpy(
                x[..., b * blk:(b + 1) * blk]), h_f, part_len=P)
            outs.append(y.numpy())
        return np.concatenate(outs, -1)

    y_blk = run(S)
    gold = np.stack([[np.convolve(x[c, 0], ir[c, e])[:S * NB]
                      for e in range(2)] for c in range(C)])
    assert np.abs(y_blk - gold).max() < 1e-4
    # partition-granularity streaming, and the whole signal in one call,
    # are bit-identical: each P-sample output depends only on input up
    # to its own end
    assert np.array_equal(run(P), y_blk)
    assert np.array_equal(run(S * NB), y_blk)


def test_upc_block_matches_gstpu():
    rng = np.random.default_rng(8)
    C, L, P, S, NB = 6, 150, 64, 256, 3
    ir = rng.standard_normal((C, 2, L)) * 0.1
    x = rng.standard_normal((C, 1, S * NB)).astype(np.float32)
    h_f = upc_ir_rfft(torch.from_numpy(ir), part_len=P)
    jh_f = jax_fftconv.upc_ir_rfft(ir, part_len=P)
    assert h_f.dtype == torch.complex64 and h_f.shape == jh_f.shape
    assert np.abs(h_f.numpy() - np.asarray(jh_f)).max() < 1e-5
    st, jst = upc_init((C, 1), L, P, device="cpu"), \
        jax_fftconv.upc_init((C, 1), L, P)
    for b in range(NB):
        seg = x[..., b * S:(b + 1) * S]
        st, y = upc_block(st, torch.from_numpy(seg), h_f, part_len=P)
        jst, jy = jax_fftconv.upc_block(jst, seg, jh_f, part_len=P)
        assert np.abs(y.numpy() - np.asarray(jy)).max() < 1e-5
    for a, b in zip(st, jst):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-4


# -- sofalizer --------------------------------------------------------

@pytest.fixture
def sofa_file(tmp_path):
    positions = np.array([[0, 0, 1], [90, 0, 1], [180, 0, 1],
                          [270, 0, 1]], np.float64)
    irs = np.zeros((4, 2, 16))
    for m in range(4):
        irs[m, 0, m] = 1.0
        irs[m, 1, m + 4] = 0.5
    path = str(tmp_path / "test.sofa")
    write_sofa(path, positions, irs, RATE)
    return path


@pytest.fixture
def dense_sofa_file(tmp_path):
    """4 positions with dense random IRs spanning 3 partitions."""
    rng = np.random.default_rng(11)
    positions = np.array([[0, 0, 1], [90, 0, 1], [180, 0, 1],
                          [270, 0, 1]], np.float64)
    irs = rng.standard_normal((4, 2, 150)) * 0.1
    path = str(tmp_path / "dense.sofa")
    write_sofa(path, positions, irs, RATE)
    return path


def test_sofa_roundtrip_matches_gstpu(sofa_file):
    pos, irs, rate = load_sofa(sofa_file)
    assert pos.shape == (4, 3) and irs.shape == (4, 2, 16)
    assert rate == RATE
    jpos, jirs, jrate = jax_hrtf.load_sofa(sofa_file)
    assert np.array_equal(pos, jpos) and np.array_equal(irs, jirs)
    for az, el_ in ((30.0, 0.0), (-110.0, 15.0)):
        assert np.array_equal(_sph_to_vec(az, el_),
                              jax_hrtf._sph_to_vec(az, el_))


def test_sofalizer_stereo(sofa_file):
    el = make("sofalizer", sofa_location=sofa_file, block_length=64)
    h = Harness(el)
    h.set_caps(CAPS.format(rate=RATE, ch=2))
    x = np.zeros((64, 2), np.float32)
    x[0, 0] = 1.0
    h.push(gstpu_torch.Buffer(x))
    out = h.pull().array.reshape(-1, 2)
    assert out[0, 0] == pytest.approx(1.0, abs=1e-5)
    assert out[4, 1] == pytest.approx(0.5, abs=1e-5)
    h.teardown()


def test_sofalizer_upc_golden(dense_sofa_file):
    el = make("sofalizer", sofa_location=dense_sofa_file,
              block_length=256, partition_length=64)
    h = Harness(el)
    h.set_caps(CAPS.format(rate=RATE, ch=2))
    rng = np.random.default_rng(13)
    x = rng.standard_normal((512, 2)).astype(np.float32)
    h.push(gstpu_torch.Buffer(x))
    out = np.concatenate([h.pull().array.reshape(-1, 2)
                          for _ in range(2)])
    _, irs, _ = load_sofa(dense_sofa_file)
    sel = el._select_irs(2)
    gold = np.zeros((512, 2))
    for c in range(2):
        for e in range(2):
            gold[:, e] += np.convolve(x[:, c], irs[sel[c], e])[:512]
    assert np.abs(out - gold).max() < 1e-4
    h.teardown()


def test_sofalizer_partition_granularity(dense_sofa_file):
    """block-length 256 and 64 (== partition) give identical output."""
    outs = {}
    x = np.random.default_rng(17).standard_normal((512, 2)) \
        .astype(np.float32)
    for blk in (256, 64):
        el = make("sofalizer", sofa_location=dense_sofa_file,
                  block_length=blk, partition_length=64)
        h = Harness(el)
        h.set_caps(CAPS.format(rate=RATE, ch=2))
        h.push(gstpu_torch.Buffer(x))
        outs[blk] = np.concatenate(
            [h.pull().array.reshape(-1, 2) for _ in range(512 // blk)])
        h.teardown()
    assert np.array_equal(outs[256], outs[64])


def test_sofalizer_error_paths(sofa_file):
    """block % partition != 0 is rejected (reference imp.rs:779-783);
    no sofa-location stops the element at start."""
    el = make("sofalizer", sofa_location=sofa_file, block_length=100,
              partition_length=64)
    el.bus = gstpu_torch.Bus()
    assert el.start()
    assert el.set_caps(parse_caps(CAPS.format(rate=RATE, ch=2)),
                       None) is False
    assert "not multiple of Partition" in " ".join(_errors(el))
    el = make("sofalizer")
    el.bus = gstpu_torch.Bus()
    assert el.start() is False
    assert "no sofa-location" in " ".join(_errors(el))


def test_sofalizer_rotation_switches_filter(sofa_file):
    el = make("sofalizer", sofa_location=sofa_file, block_length=64)
    h = Harness(el)
    h.set_caps(CAPS.format(rate=RATE, ch=1))
    x = np.zeros((64, 1), np.float32)
    x[0] = 1.0
    h.push(gstpu_torch.Buffer(x))
    assert h.pull().array.reshape(-1, 2)[0, 0] == pytest.approx(
        1.0, abs=1e-5)
    el.set_property("rotation_yaw", -90.0)
    h.push(gstpu_torch.Buffer(x))
    h.push(gstpu_torch.Buffer(x))
    h.pull()              # crossfade block
    out3 = h.pull().array.reshape(-1, 2)
    assert out3[1, 0] == pytest.approx(1.0, abs=1e-4)
    h.teardown()


def test_sofalizer_latency(sofa_file):
    el = make("sofalizer", sofa_location=sofa_file, block_length=256)
    h = Harness(el)
    h.set_caps(CAPS.format(rate=RATE, ch=2))
    assert h.query_latency().min_latency == 256 * 1_000_000_000 // RATE
    h.teardown()


# -- both elements against gstpu's on the same launch strings ----------

def _launch_run(pkg, launch, blocks, changes):
    """Run `launch` in `pkg` (gstpu or gstpu_torch), pushing `blocks`
    (f32 (n, C) arrays) and applying changes[k] (property -> value on
    the element named `r`) before block k; the concatenated stereo
    output through the EOS drain."""
    p = pkg.parse_launch(launch)
    r = p.get_by_name("r")
    src = p.get_by_name("src")
    p.set_state(pkg.State.PLAYING)
    for k, blk in enumerate(blocks):
        for name, value in changes.get(k, {}).items():
            r.set_property(name, value)
        src.push_buffer(pkg.Buffer(blk, pts=None))
        while p.iterate():
            pass
    src.end_of_stream()
    p.run()
    out = np.concatenate([np.asarray(b.array).reshape(-1, 2)
                          for b in p.get_by_name("sink").pull_all()])
    p.set_state(pkg.State.NULL)
    return out


def _objects(dirs, gains):
    return [{"x": float(d[0]), "y": float(d[1]), "z": float(d[2]),
             "distance-gain": float(g)} for d, g in zip(dirs, gains)]


def test_hrtfrender_matches_gstpu_on_launch_string(tmp_path):
    """Static directions, then directions and gains that change
    mid-stream (the interpolated path: IRs re-sampled at each of the 8
    steps), then the EOS drain of a partial block."""
    rng = np.random.default_rng(21)
    C = 4
    path = tmp_path / "s.hrir"
    path.write_bytes(HrirSphere.to_bytes(*dense_sphere(rng)))
    d0 = rng.standard_normal((C, 3))
    d1 = rng.standard_normal((C, 3))
    g1 = rng.uniform(0.5, 1.5, C)
    launch = (f'appsrc name=src caps="{CAPS.format(rate=RATE, ch=C)}" ! '
              f'hrtfrender name=r hrir-location={path} block-length=128 '
              f'interpolation-steps=8 ! appsink name=sink')
    blocks = [rng.standard_normal((n, C)).astype(np.float32) * 0.3
              for n in (128, 200, 56, 128, 300)]
    changes = {0: {"spatial_objects": _objects(d0, np.ones(C))},
               2: {"spatial_objects": _objects(d1, g1)},
               3: {"spatial_objects": _objects(d0, g1[::-1])}}
    got = _launch_run(gstpu_torch, launch, blocks, changes)
    want = _launch_run(gstpu, launch, blocks, changes)
    assert got.shape == want.shape == (812, 2)
    assert np.abs(got - want).max() < 1e-5


def test_sofalizer_matches_gstpu_on_launch_string(dense_sofa_file):
    """A 6-channel layout, the listener's yaw turning mid-stream (the
    crossfade block), a gain, and the EOS drain of a partial block."""
    rng = np.random.default_rng(22)
    launch = (f'appsrc name=src caps="{CAPS.format(rate=RATE, ch=6)}" ! '
              f'sofalizer name=r sofa-location={dense_sofa_file} '
              f'block-length=128 partition-length=64 gain=0.7 ! '
              f'appsink name=sink')
    blocks = [rng.standard_normal((n, 6)).astype(np.float32) * 0.3
              for n in (128, 128, 256, 100)]
    changes = {1: {"rotation_yaw": 60.0}, 3: {"rotation_yaw": -45.0}}
    got = _launch_run(gstpu_torch, launch, blocks, changes)
    want = _launch_run(gstpu, launch, blocks, changes)
    assert got.shape == want.shape == (612, 2)
    assert np.abs(got - want).max() < 1e-5
