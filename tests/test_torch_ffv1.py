"""The port's FFV1 encoder against gstpu's, on the CPU.

Twins of tests/test_ffv1enc.py with the port's modules, on the same
seeded frames (89x51 odd sizes, 112x80), each against an independent
oracle:
  1. the port's spec model (gstpu_torch/codecs/ffv1.py) round-trips
     itself, decodes libavcodec's streams and is decoded by libavcodec,
     and its bitstreams equal gstpu's model byte for byte;
  2. the field pass (gstpu_torch/ops/ffv1_pred.py, the gather form)
     equals gstpu's ffv1_pred in both its forms (staircase, and gather
     for a non-staircase table) and the numpy `predict_plane` bit for
     bit, in every layout (plain, packed, I420, batched);
  3. the native coder built by the port is byte-identical to the model
     on the packed, plane and diff routes;
  4. the port's `ffv1enc` element emits gstpu's bitstreams for host
     frames, CPU tensors and DeviceRow rows, `ffv1enc ! ffv1dec` is
     lossless, and the spec-model fallback takes host frames on a
     CPU-configured port only.
They skip where gstpu's own tests skip (no libavcodec shim, no native
coder).
"""

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.codecs import ffv1 as jax_ffv1
from gstpu.ops import ffv1_pred as jax_pred
from gstpu_torch.codecs import ffv1
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.ops import ffv1_pred
from gstpu_torch.ops.ffv1_pred import Predictor, to_numpy

W, H = 89, 51          # odd sizes exercise the ceil-chroma borders


@pytest.fixture(autouse=True)
def _port_on_cpu():
    gstpu_torch.init(device="cpu")


def _frames(n, w=W, h=H, seed=5):
    rng = np.random.default_rng(seed)
    cw, ch = -(-w >> 1), -(-h >> 1)
    out = []
    for i in range(n):
        # gradient + noise: exercises both smooth contexts and the
        # residual-fold wraparound
        y = ((np.arange(h)[:, None] * 3 + np.arange(w)[None, :] * 2 + i)
             % 256).astype(np.uint8)
        y = (y.astype(np.int32)
             + rng.integers(-20, 21, y.shape)).clip(0, 255).astype(np.uint8)
        u = rng.integers(0, 256, (ch, cw), np.uint8)
        v = rng.integers(0, 256, (ch, cw), np.uint8)
        out.append([y, u, v])
    return out


def _have_av():
    from gstpu_torch.native_codec import available
    return available("ffv1", encoder=False)


def _have_native_coder():
    from gstpu_torch.native_ffv1 import available
    return available()


def _non_staircase(quant):
    """gstpu's test's non-monotone table 0: two adjacent distinct values
    swapped in the d8 order."""
    quant = [np.array(t, np.int64).copy() for t in quant]
    order = np.arange(-128, 128) & 0xFF
    quant[0][order[10]], quant[0][order[11]] = \
        int(quant[0][order[11]]) + 1, int(quant[0][order[10]])
    assert jax_pred.staircase(quant[0]) is None
    return quant


def test_model_roundtrip_gop():
    p = ffv1.Params(W, H)
    enc = ffv1.ModelEncoder(p, gop=3)
    dec = ffv1.ModelDecoder(W, H)
    for i, planes in enumerate(_frames(5)):
        bs, key = enc.encode(planes)
        assert key == (i % 3 == 0)
        got = dec.decode(bs)
        for a, b in zip(planes, got):
            assert np.array_equal(a, b)


def test_model_byte_identical_to_gstpu():
    """The port's spec model is gstpu's: the same tables and the same
    bitstreams, inter frames included."""
    p, pj = ffv1.Params(W, H), jax_ffv1.Params(W, H)
    for a, b in zip(p.quant, pj.quant):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert p.context_count == pj.context_count
    enc, encj = ffv1.ModelEncoder(p, gop=2), jax_ffv1.ModelEncoder(pj, gop=2)
    for planes in _frames(4):
        assert enc.encode(planes) == encj.encode(planes)
        for pl in planes:
            for a, b in zip(ffv1.predict_plane(pl, p.quant),
                            jax_ffv1.predict_plane(pl, pj.quant)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.skipif(not _have_av(), reason="libavcodec shim unavailable")
def test_model_encoder_conformance_vs_libavcodec():
    from gstpu_torch.native_codec import NativeDecoder
    p = ffv1.Params(W, H)
    enc = ffv1.ModelEncoder(p, gop=4)     # inter frames included
    dec = NativeDecoder("ffv1", width=W, height=H)
    cw, ch = p.chroma_size
    n_checked = 0
    for i, planes in enumerate(_frames(6)):
        bs, _ = enc.encode(planes)
        for data, w_, h_, fmt, _pts in dec.send(bs, pts=i):
            assert (w_, h_, fmt) == (W, H, 0)
            ysz, csz = w_ * h_, cw * ch
            assert np.array_equal(data[:ysz].reshape(h_, w_), planes[0])
            assert np.array_equal(data[ysz:ysz + csz].reshape(ch, cw),
                                  planes[1])
            assert np.array_equal(data[ysz + csz:].reshape(ch, cw),
                                  planes[2])
            n_checked += 1
    assert n_checked == 6
    dec.close()


@pytest.mark.skipif(not _have_av(), reason="libavcodec shim unavailable")
def test_model_decoder_decodes_libavcodec_streams():
    from gstpu_torch.native_codec import NativeEncoder, available
    if not available("ffv1"):
        pytest.skip("libavcodec ffv1 encoder unavailable")
    w, h = 64, 48
    enc = NativeEncoder("ffv1", w, h, opts={"coder": "ac"})
    dec = ffv1.ModelDecoder(w, h)
    frames = _frames(3, w, h, seed=9)
    pkts = []
    for i, planes in enumerate(frames):
        i420 = np.concatenate([pl.ravel() for pl in planes])
        pkts += [d for d, *_ in enc.send(i420, i)]
    pkts += [d for d, *_ in enc.finish()]
    enc.close()
    assert len(pkts) == len(frames)
    for planes, pkt in zip(frames, pkts):
        got = dec.decode(bytes(pkt))
        for a, b in zip(planes, got):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("tables", ["staircase", "gather"])
def test_fields_match_gstpu_and_spec_model(tables):
    """Every Predictor entry point bit for bit with gstpu's Predictor
    and with predict_plane, on random planes of odd and tiny sizes.
    gstpu takes its staircase form for the default tables and its
    gather form for the non-staircase one; the port's gather form
    equals both."""
    quant = ffv1.Params(W, H).quant
    if tables == "gather":
        quant = _non_staircase(quant)
    pred, jpred = Predictor(quant, "cpu"), jax_pred.Predictor(quant)
    assert (jpred.stair is None) == (tables == "gather")
    rng = np.random.default_rng(1)
    for shape in [(H, W), (1, 1), (2, 3), (26, 45), (1, 7), (7, 1)]:
        pl = rng.integers(0, 256, shape, np.uint8)
        c_np, d_np = ffv1.predict_plane(pl, quant)
        c, d = pred(pl)
        cj, dj = jpred(pl)
        assert c.dtype == cj.dtype == np.uint16 and d.dtype == np.int8
        for a, b in ((c, c_np), (d, d_np.astype(np.int8)), (c, cj),
                     (d, dj)):
            np.testing.assert_array_equal(a, b)
        got = [to_numpy(x, np.uint8 if i else np.int8)
               for i, x in enumerate(pred.dispatch_packed(pl))]
        want = [np.asarray(x) for x in jpred.dispatch_packed(pl)]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(to_numpy(pred.dispatch_diff(pl),
                                               np.int8),
                                      np.asarray(jpred.dispatch_diff(pl)))
    planes = _frames(1, W, H, seed=3)[0]
    flat = np.concatenate([q.ravel() for q in planes])
    want = np.concatenate([ffv1.predict_plane(q, quant)[1]
                           .astype(np.int8).ravel() for q in planes])
    for x in (flat, torch.from_numpy(flat)):
        np.testing.assert_array_equal(
            to_numpy(pred.dispatch_diff_i420(x, W, H), np.int8), want)
    np.testing.assert_array_equal(
        np.asarray(jpred.dispatch_diff_i420(flat, W, H)), want)
    stack = rng.integers(0, 256, (3, 17, 23), np.uint8)
    cb, db = pred.batched(stack)
    cbj, dbj = jpred.batched(stack)
    np.testing.assert_array_equal(cb, cbj)
    np.testing.assert_array_equal(db, dbj)
    for i in range(3):
        c1, d1 = ffv1.predict_plane(stack[i], quant)
        np.testing.assert_array_equal(c1, cb[i])
        np.testing.assert_array_equal(d1.astype(np.int8), db[i])


def test_stair_and_gather_forms_agree():
    """The port's gather form against gstpu's staircase lowering of the
    default tables over a batch, and the packed context bytes
    reassembled, on a natural-ish 1-row-per-step gradient."""
    quant = ffv1.Params(W, H).quant
    stair = tuple(jax_pred.staircase(t) for t in quant[:3])
    q = [torch.as_tensor(np.asarray(t, np.int32)) for t in quant[:3]]
    planes = np.stack([f[0] for f in _frames(3)])
    cg, dg = ffv1_pred.predict_fields_gather(torch.from_numpy(planes), *q)
    cs, ds = jax_pred.predict_fields_batched_stair(planes, stair)
    np.testing.assert_array_equal(to_numpy(cg, np.uint16), np.asarray(cs))
    np.testing.assert_array_equal(dg.numpy(), np.asarray(ds))
    lo, hip = ffv1_pred.pack_ctx_hi4(cg[0])
    jlo, jhip = jax_pred.pack_ctx_hi4(np.asarray(cs[0], np.uint16))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hip.numpy(), np.asarray(jhip))


@pytest.mark.skipif(not _have_native_coder(),
                    reason="native ffv1 coder unavailable")
def test_native_coder_byte_identical_to_model():
    from gstpu_torch.native_ffv1 import NativeFrameCoder
    p = ffv1.Params(W, H)
    model = ffv1.ModelEncoder(p, gop=2)
    nat = NativeFrameCoder(p)
    for planes in _frames(4):
        bs_model, key = model.encode(planes)
        fields = [ffv1.predict_plane(pl, p.quant) for pl in planes]
        bs_nat = nat.encode(key, [f[0] for f in fields],
                            [f[1] for f in fields])
        assert bs_nat == bs_model
    nat.close()


@pytest.mark.skipif(not _have_native_coder(),
                    reason="native ffv1 coder unavailable")
@pytest.mark.parametrize("route", ["packed", "plane", "diff"])
def test_device_routes_byte_identical(route):
    """The port's three device->host hops (2.25 B/px packed fields,
    1 B/px residuals with contexts re-derived from the source plane,
    residuals alone) give the full-field bitstream, border rules, odd
    widths and inter frames included."""
    from gstpu_torch.native_ffv1 import NativeFrameCoder
    sizes = [(W, H), (64, 48)] + ([(1, 7), (7, 1)] if route != "packed"
                                  else [])
    for w, h in sizes:
        p = ffv1.Params(w, h)
        pred = Predictor(p.quant, "cpu")
        a, b = NativeFrameCoder(p), NativeFrameCoder(p)
        for i, planes in enumerate(_frames(3, w, h, seed=7)):
            fields = [ffv1.predict_plane(pl, p.quant) for pl in planes]
            want = a.encode(i == 0, [c for c, _ in fields],
                            [d for _, d in fields])
            if route == "packed":
                got = b.encode_packed(i == 0, [
                    (to_numpy(d, np.int8), to_numpy(lo, np.uint8),
                     to_numpy(h4, np.uint8))
                    for d, lo, h4 in map(pred.dispatch_packed, planes)])
            else:
                diffs = [to_numpy(pred.dispatch_diff(pl), np.int8)
                         for pl in planes]
                got = (b.encode_from_plane(i == 0, planes, diffs)
                       if route == "plane"
                       else b.encode_from_diff(i == 0, diffs))
            assert got == want, (w, h, i)
        a.close()
        b.close()


def _encode(pkg, payloads, w, h, gop=1, hop="diff"):
    from_caps = pkg.Caps.from_string(
        f"video/x-raw, format=I420, width={w}, height={h}, "
        f"framerate=25/1")
    enc = pkg.make("ffv1enc", gop=gop, hop=hop)
    enc.set_caps(from_caps, pkg.Caps.new("video/x-ffv1"))
    assert enc._coder is not None
    out = []
    for i, f in enumerate(payloads):
        out += enc.transform(pkg.Buffer(f, pts=i))
    out += enc.drain()
    enc.stop()
    return [(b.to_bytes(), b.is_keyframe()) for b in out]


@pytest.mark.skipif(not _have_native_coder(),
                    reason="native ffv1 coder unavailable")
def test_ffv1enc_device_resident_input_byte_identical():
    """Host frames, CPU tensors (both the host route) and DeviceRow
    rows of a (B, n) bank (the zero-upload fe_encode_from_diff route)
    give the same bitstream, and it is gstpu's."""
    from gstpu_torch.runtime.device_batch import DeviceRow
    w, h = 112, 80
    frames = [np.concatenate([pl.ravel() for pl in planes])
              for planes in _frames(3, w, h, seed=17)]
    bank = torch.from_numpy(np.stack(frames))
    host = _encode(gstpu_torch, frames, w, h)
    assert _encode(gstpu_torch, [torch.from_numpy(f) for f in frames],
                   w, h) == host
    assert _encode(gstpu_torch, [DeviceRow(bank, i) for i in range(3)],
                   w, h) == host
    gstpu.init()
    assert _encode(gstpu, frames, w, h) == host


@pytest.mark.skipif(not _have_native_coder(),
                    reason="native ffv1 coder unavailable")
@pytest.mark.parametrize("gop,hop", [(1, "diff"), (3, "packed")])
def test_ffv1enc_matches_gstpu(gop, hop):
    """The element's bitstream, keyframe flags included, equals gstpu's
    ffv1enc on the same frames, for both hops and with inter frames."""
    gstpu.init()
    frames = [np.concatenate([pl.ravel() for pl in planes])
              for planes in _frames(4)]
    got = _encode(gstpu_torch, frames, W, H, gop=gop, hop=hop)
    assert got == _encode(gstpu, frames, W, H, gop=gop, hop=hop)
    assert [k for _, k in got] == [i % gop == 0 for i in range(4)]


@pytest.mark.skipif(not _have_native_coder(),
                    reason="native ffv1 coder unavailable")
def test_native_coder_failed_attempt_preserves_states():
    """An undersized-cap attempt must not advance the adaptive context
    states: the retry (and every later frame) must produce the same
    bitstream a clean run would."""
    import ctypes
    from gstpu_torch.native_ffv1 import NativeFrameCoder
    p = ffv1.Params(W, H)
    fields = [[ffv1.predict_plane(pl, p.quant) for pl in planes]
              for planes in _frames(3)]

    def run(coder, poison_frame=None):
        out = []
        for i, f in enumerate(fields):
            if i == poison_frame:
                ctx = np.concatenate(
                    [np.asarray(c, np.uint16).ravel() for c, _ in f])
                diff = np.concatenate(
                    [np.asarray(d, np.int8).ravel() for _, d in f])
                px = np.asarray([np.asarray(c).size for c, _ in f],
                                np.dtype(ctypes.c_long))
                buf = np.empty(8, np.uint8)
                n = coder._L.fe_encode(
                    coder._h, 0, len(f),
                    ctx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                    diff.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    px.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    8)
                assert n < -8
            out.append(coder.encode(i == 0, [c for c, _ in f],
                                    [d for _, d in f]))
        return out

    clean, poisoned = NativeFrameCoder(p), NativeFrameCoder(p)
    assert run(poisoned, poison_frame=1) == run(clean)
    clean.close()
    poisoned.close()


@pytest.mark.skipif(not _have_av(), reason="libavcodec shim unavailable")
def test_ffv1enc_ffv1dec_pipeline_lossless():
    from gstpu_torch import State, parse_launch
    from gstpu_torch.core.video import VideoInfo
    w, h = 112, 80
    vi = VideoInfo("I420", w, h)
    frames = _frames(4, w, h, seed=2)
    p = parse_launch(
        f'appsrc name=src caps="video/x-raw, format=I420, width={w}, '
        f'height={h}, framerate=30/1" ! ffv1enc gop=2 ! ffv1dec ! '
        f'appsink name=sink')
    src, sink = p.get_by_name("src"), p.get_by_name("sink")
    p.set_state(State.PLAYING)
    for i, planes in enumerate(frames):
        i420 = np.concatenate([pl.ravel() for pl in planes])
        src.push_buffer(vi.make_buffer(i420, pts=i * 33_333_333))
    src.end_of_stream()
    p.run()
    out = sink.pull_all()
    assert len(out) == len(frames)
    for planes, b in zip(frames, out):
        want = np.concatenate([pl.ravel() for pl in planes])
        assert np.array_equal(np.frombuffer(b.to_bytes(), np.uint8), want)
    p.set_state(State.NULL)


def test_model_fallback_without_native_coder(monkeypatch):
    """gstpu's host behaviour: where the native coder cannot load, the
    element encodes with the spec model, and the bitstream is the
    same."""
    import gstpu_torch.native_ffv1 as nf
    frames = [np.concatenate([pl.ravel() for pl in planes])
              for planes in _frames(2)]
    caps = gstpu_torch.Caps.from_string(
        f"video/x-raw, format=I420, width={W}, height={H}, "
        f"framerate=25/1")

    def run():
        enc = gstpu_torch.make("ffv1enc")
        enc.set_caps(caps, gstpu_torch.Caps.new("video/x-ffv1"))
        out = []
        for i, f in enumerate(frames):
            out += enc.transform(Buffer(f, pts=i))
        out += enc.drain()
        native = enc._coder is not None
        enc.stop()
        return native, [b.to_bytes() for b in out]

    monkeypatch.setattr(nf, "load", lambda: None)
    native, model = run()
    assert not native
    monkeypatch.undo()
    if _have_native_coder():
        assert run() == (True, model)


@pytest.mark.parametrize("how", ["device port", "cuda tensor", "device row"])
def test_model_fallback_refused_on_device(monkeypatch, how):
    """Without the native coder the element does not move device work to
    the host: a port set up for the card refuses at set_caps, and a
    CPU-configured port refuses device-resident frames (a meta tensor
    stands for one here)."""
    import gstpu_torch.native_ffv1 as nf
    from gstpu_torch.elements.video import av1
    from gstpu_torch.runtime.device_batch import DeviceRow
    monkeypatch.setattr(nf, "load", lambda: None)
    caps = gstpu_torch.Caps.from_string(
        f"video/x-raw, format=I420, width={W}, height={H}, "
        f"framerate=25/1")
    n = W * H + 2 * (-(-W // 2)) * (-(-H // 2))
    enc = gstpu_torch.make("ffv1enc")
    if how == "device port":
        monkeypatch.setattr(av1, "default_device",
                            lambda: torch.device("cuda"))
        assert not enc.set_caps(caps, gstpu_torch.Caps.new("video/x-ffv1"))
        assert enc._model is None and enc._coder is None
        return
    assert enc.set_caps(caps, gstpu_torch.Caps.new("video/x-ffv1"))
    assert enc._model is not None
    frame = torch.empty(n, dtype=torch.uint8, device="meta")
    if how == "device row":
        frame = DeviceRow(frame[None], 0)
    with pytest.raises(RuntimeError, match="device-resident"):
        enc.transform(Buffer(frame, pts=0))
    enc.stop()
