"""The port's `audiornnoise` element against its host engines and
gstpu's element, on the CPU.

Twins of tests/test_rnnoise_device.py (the DeviceContext path against
the host element within 1e-6, the f32 output quantum, for the spectral
gate and the GRU; VAD mute at threshold 1.0) and of the element tests of
tests/test_rnnoise.py (frame accounting through the EOS drain, VAD
gating, AudioLevelMeta, the pipeline, the GRU engines), plus: the host
element's samples and AudioLevelMeta bit for bit with gstpu's on the
same launch strings, a partial last block drained through the context,
lanes with different thresholds in one context, f32 precision, rows of a
bank made on the device against the step itself bit for bit, and the
context's error paths.
"""

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.elements.audio.rnnoise import AudioLevelMeta as JaxLevelMeta
from gstpu_torch.core.element import MessageType
from gstpu_torch.core.harness import Harness
from gstpu_torch.core.registry import make
from gstpu_torch.elements.audio.rnnoise import AudioLevelMeta
from gstpu_torch.ops.rnnoise import (FRAME_SIZE, make_device_denoiser,
                                     make_device_gru_denoiser)
from gstpu_torch.runtime.device_batch import DeviceContext, DeviceRow
from test_torch_rnnoise import gru_weights

RATE = 48000
CAPS = ("audio/x-raw, format=F32LE, rate=48000, channels={ch}, "
        "layout=interleaved")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    gstpu.init()
    gstpu_torch.init(device="cpu")


@pytest.fixture(scope="module")
def weights_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rn") / "w.npz")
    np.savez(path, **gru_weights(np.random.default_rng(11)))
    return path


def _run(sigs, extra="", name="rn", thresholds=None, tail=None):
    """One `appsrc ! audiornnoise <extra> ! appsink` pipeline per stream,
    fed the (blocks, n) rows of each stream (and an optional partial
    `tail` block), then EOS; each stream's output samples."""
    pkg = gstpu_torch
    DeviceContext.release(name)
    pipes = [pkg.parse_launch(
        f'appsrc name=src caps="{CAPS.format(ch=1)}" ! audiornnoise '
        f'name=r {extra} ! appsink name=sink') for _ in sigs]
    for i, p in enumerate(pipes):
        if thresholds is not None:
            p.get_by_name("r").set_property("voice-activity-threshold",
                                             thresholds[i])
        p.set_state(pkg.State.PLAYING)
    blocks = [list(s) + ([tail[i]] if tail is not None else [])
              for i, s in enumerate(sigs)]
    for k in range(len(blocks[0])):
        for s, p in enumerate(pipes):
            p.get_by_name("src").push_buffer(pkg.Buffer(
                blocks[s][k].astype(np.float32).reshape(-1, 1),
                pts=k * 100_000_000))
            while p.iterate():
                pass
    outs = []
    for p in pipes:
        p.get_by_name("src").end_of_stream()
        p.run()
        outs.append(np.concatenate([np.asarray(b.array).reshape(-1)
                                    for b in p.get_by_name("sink")
                                    .pull_all()]))
        p.set_state(pkg.State.NULL)
    DeviceContext.release(name)
    return outs


def _ctx(block=10 * FRAME_SIZE, name="rn"):
    return f"context={name} context-block={block} "


def test_context_spectral_matches_host_element():
    """3 streams x 4 blocks of 10 frames and a 700-sample tail drained
    at EOS through the context, against the host element."""
    rng = np.random.default_rng(3)
    sigs = [0.1 * rng.standard_normal((4, 10 * FRAME_SIZE))
            for _ in range(3)]
    tail = [0.1 * rng.standard_normal(700) for _ in range(3)]
    batched = _run(sigs, _ctx(), tail=tail)
    host = _run(sigs, tail=tail)
    for s in range(3):
        assert batched[s].size == host[s].size == 4 * 10 * FRAME_SIZE + 700
        d = np.abs(batched[s] - host[s]).max()
        assert d <= 1e-6, f"stream {s}: {d}"     # f32 output quantum


def test_context_gru_matches_host_element(weights_path):
    rng = np.random.default_rng(5)
    sigs = [0.1 * rng.standard_normal((3, 10 * FRAME_SIZE))
            for _ in range(3)]
    loc = f"model-location={weights_path} "
    batched = _run(sigs, loc + _ctx())
    host = _run(sigs, loc + "engine=host")
    for s in range(3):
        assert batched[s].size == host[s].size == 3 * 10 * FRAME_SIZE
        d = np.abs(batched[s] - host[s]).max()
        assert d <= 1e-6, f"stream {s}: {d}"


def test_context_gru_f32_tracks_host_element(weights_path):
    """precision=f32 stacks host rows in f32 and runs the chain in f32:
    held to gstpu's f32 gate, 8.0 on the +-32767 scale."""
    rng = np.random.default_rng(6)
    sigs = [0.1 * rng.standard_normal((2, 10 * FRAME_SIZE))
            for _ in range(2)]
    loc = f"model-location={weights_path} "
    batched = _run(sigs, loc + _ctx() + "precision=f32")
    host = _run(sigs, loc + "engine=host")
    for s in range(2):
        assert np.abs(batched[s] - host[s]).max() * 32767.0 < 8.0


@pytest.mark.parametrize("engine", ["spectral", "gru-f64", "gru-f32"])
def test_context_lanes_with_different_thresholds(engine, weights_path):
    """Thresholds 0.0 and 1.0 in one context reach the step as a (B, 1)
    f64 tensor: the first lane is the unmuted output, the second all
    zeros (the gate's VAD < 1)."""
    rng = np.random.default_rng(7)
    sigs = [0.1 * rng.standard_normal((1, 10 * FRAME_SIZE))] * 2
    extra = _ctx()
    if engine != "spectral":
        extra += f"model-location={weights_path} precision={engine[-3:]}"
    mixed = _run(sigs, extra, thresholds=[0.0, 1.0])
    alone = _run(sigs[:1], extra)
    assert np.array_equal(mixed[0], alone[0]) and np.abs(mixed[0]).max() > 0
    assert np.abs(mixed[1]).max() == 0.0


def test_context_vad_mute():
    """voice_activity_threshold=1.0 mutes everything (gate VAD < 1)."""
    rng = np.random.default_rng(4)
    sig = [0.1 * rng.standard_normal((3, 10 * FRAME_SIZE))]
    out = _run(sig, _ctx(name="rnv"), name="rnv", thresholds=[1.0])
    assert out[0].size == 3 * 10 * FRAME_SIZE
    assert np.abs(out[0]).max() == 0.0


@pytest.mark.parametrize("gru", [False, True])
def test_context_bank_rows_equal_the_step(gru, weights_path):
    """3 pipelines fed DeviceRow rows of a (3, 4800) f64 bank: every
    lane equals the denoiser's step at B=3 on the bank itself, bit for
    bit (chip_smoke.py phase 8b's check, on the CPU)."""
    rng = np.random.default_rng(8)
    block = 10 * FRAME_SIZE
    banks = [torch.from_numpy(0.1 * rng.standard_normal((3, block)))
             for _ in range(2)]
    if gru:
        step, init = make_device_gru_denoiser(
            dict(np.load(weights_path)), 10)
    else:
        step, init = make_device_denoiser(10)
    st = init(3, "cpu")
    want = []
    for bank in banks:
        st, out, _ = step(st, bank * 32767.0)
        want.append(out / 32767.0)
    DeviceContext.release("rnb")
    extra = f"model-location={weights_path} " if gru else ""
    pipes = [gstpu_torch.parse_launch(
        f'appsrc name=src caps="{CAPS.format(ch=1)}" ! audiornnoise '
        f'{extra}{_ctx(name="rnb")}! appsink name=sink') for _ in range(3)]
    for p in pipes:
        p.set_state(gstpu_torch.State.PLAYING)
    for k, bank in enumerate(banks):
        for i, p in enumerate(pipes):
            p.get_by_name("src").push_buffer(gstpu_torch.Buffer(
                DeviceRow(bank, i), pts=k * 100_000_000))
            while p.iterate():
                pass
    for i, p in enumerate(pipes):
        got = p.get_by_name("sink").samples
        assert len(got) == 2
        for k in range(2):
            assert isinstance(got[k].data, DeviceRow)
            assert torch.equal(got[k].data.tensor(), want[k][i])
        p.set_state(gstpu_torch.State.NULL)
    DeviceContext.release("rnb")


def test_context_error_paths(weights_path):
    """engine=host refuses the context; a context-block that is not a
    multiple of 480 x channels refuses the caps."""
    from gstpu_torch.core.caps import parse_caps
    for props, msg in (({"engine": "host", "context_block": 4800},
                        "engine=host"),
                       ({"context_block": 1000}, "multiple of 960")):
        DeviceContext.release("rne")
        el = make("audiornnoise", context="rne",
                  model_location=weights_path, **props)
        el.bus = gstpu_torch.Bus()
        assert el.start()
        assert el.set_caps(parse_caps(CAPS.format(ch=2)), None) is False
        errs = [str(m.fields) for m in el.bus.drain()
                if m.type is MessageType.ERROR]
        assert any(msg in e for e in errs), errs
        el.stop()
    DeviceContext.release("rne")


# -- the host element, bit for bit with gstpu's -------------------------

def test_host_element_and_level_meta_match_gstpu(weights_path):
    """The same launch strings in both packages: every sample, level
    and voice flag equal (spectral gate and host GRU, 2 channels, ragged
    buffers, the EOS drain of a partial frame)."""
    rng = np.random.default_rng(9)
    t = np.arange(9 * FRAME_SIZE + 333) / RATE
    x = np.stack([0.4 * np.sin(2 * np.pi * 180 * t),
                  0.2 * np.sin(2 * np.pi * 330 * t)], 1) \
        + 0.02 * rng.standard_normal((t.size, 2))
    x = x.astype(np.float32)
    for extra in ("", f"model-location={weights_path}",
                  "voice-activity-threshold=0.3"):
        outs = []
        for pkg in (gstpu, gstpu_torch):
            p = pkg.parse_launch(
                f'appsrc name=src caps="{CAPS.format(ch=2)}" ! '
                f'audiornnoise {extra} ! appsink name=sink')
            p.set_state(pkg.State.PLAYING)
            src = p.get_by_name("src")
            for a, b in ((0, 1000), (1000, 1480), (1480, x.shape[0])):
                src.push_buffer(pkg.Buffer(x[a:b]))
                while p.iterate():
                    pass
            src.end_of_stream()
            p.run()
            outs.append(p.get_by_name("sink").pull_all())
            p.set_state(pkg.State.NULL)
        ref, got = outs
        assert len(got) == len(ref) >= 3
        for b, r in zip(got, ref):
            assert np.array_equal(b.array, r.array)
            m, mr = b.get_meta(AudioLevelMeta), r.get_meta(JaxLevelMeta)
            assert (m.level, m.has_voice) == (mr.level, mr.has_voice)
        assert sum(b.array.shape[0] for b in got) == x.shape[0]


def test_element_blocking_and_accounting():
    h = Harness("audiornnoise")
    h.set_caps(CAPS.format(ch=2))
    rng = np.random.default_rng(3)
    total = 0
    for n in (100, 480, 1000, 333):
        h.push(gstpu_torch.Buffer(
            rng.uniform(-1, 1, (n, 2)).astype(np.float32)))
        total += n
    h.push_eos()
    assert sum(b.array.reshape(-1, 2).shape[0]
               for b in h.pull_all()) == total
    h.teardown()


def test_element_vad_gating_mutes_and_meta():
    el = make("audiornnoise")
    el.set_property("voice-activity-threshold", 1.0)
    h = Harness(el)
    h.set_caps(CAPS.format(ch=1))
    x = np.random.default_rng(4).uniform(-1, 1, (FRAME_SIZE, 1)) \
        .astype(np.float32)
    h.push(gstpu_torch.Buffer(x))
    out = h.pull()
    assert np.all(out.array == 0.0)
    meta = out.get_meta(AudioLevelMeta)
    assert meta is not None and meta.has_voice is False
    # silence: -20 log10(f32 eps), truncated
    assert meta.level == int(-20 * np.log10(np.finfo(np.float32).eps))
    h.teardown()


def test_element_latency():
    h = Harness("audiornnoise")
    h.set_caps(CAPS.format(ch=1))
    assert h.query_latency().min_latency == 10_000_000
    h.teardown()


def test_pipeline_rnnoise():
    p = gstpu_torch.parse_launch(
        "audiotestsrc wave=white-noise volume=0.05 num-buffers=20 "
        f"samplesperbuffer=480 ! audio/x-raw, format=F32LE, rate={RATE}, "
        "channels=1 ! audiornnoise ! appsink name=sink")
    sink = p.get_by_name("sink")
    p.set_state(gstpu_torch.State.PLAYING)
    p.run()
    assert sum(b.array.size for b in sink.pull_all()) == 20 * 480
    p.set_state(gstpu_torch.State.NULL)


def test_engine_device_matches_engine_host(weights_path):
    """engine=device (TorchGruModel in f32 on default_device(), here the
    CPU) against engine=host (numpy f64) within 1e-6; a GRU engine
    without weights is refused."""
    rng = np.random.default_rng(6)
    sig = [0.1 * rng.standard_normal((4, 2 * FRAME_SIZE))]
    loc = f"model-location={weights_path} "
    dev = _run(sig, loc + "engine=device")
    host = _run(sig, loc + "engine=host")
    assert dev[0].size == host[0].size == 8 * FRAME_SIZE
    assert np.abs(dev[0] - host[0]).max() <= 1e-6
    el = make("audiornnoise", engine="device")
    h = Harness(el)
    h.set_caps(CAPS.format(ch=1))
    assert any("needs model-location" in str(m.fields)
               for m in h.bus.drain() if m.type is MessageType.ERROR)
    h.teardown()
