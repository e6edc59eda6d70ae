"""The port's DeviceContext batched execution, on the CPU.

Twins of tests/test_device_batch.py: N parallel pipelines sharing a
context run as ONE (B, block) step per block round, and each stream's
output equals the same element run unbatched, bit for bit. The echo
streams are also held against gstpu's strict golden
(`echo_reference(fma=False)`), and the video streams against gstpu's
own batched pipelines on the same launch strings, bit for bit. The
context keeps host-int state entries as one int per fire and raises
where the chains of a fire disagree on one.
"""

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.core.video import VideoInfo as JaxVideoInfo
from gstpu.ops.echo import echo_reference
from gstpu.ops.lut import identity_lut as jax_identity_lut
from gstpu.runtime.device_batch import DeviceContext as JaxDeviceContext
from gstpu_torch import Buffer, State, parse_launch
from gstpu_torch.core.audio import AudioInfo
from gstpu_torch.core.video import VideoInfo
from gstpu_torch.ops.lut import identity_lut
from gstpu_torch.runtime.device_batch import (AuxView, DeviceContext,
                                              DeviceRow, restore_context,
                                              snapshot_context)
from gstpu_torch.utils import tracing
from torch_session import torch_test_limit  # noqa: F401

RATE = 48_000
BLOCK = 4_800            # flattened samples per batch row
INFO = AudioInfo("F64LE", RATE, 1)
ECHO = "delay=10000000 max-delay=10000000 intensity=0.4 feedback=0.3"
DELAY = 480              # 10 ms at 48 kHz mono


@pytest.fixture(autouse=True)
def _port_on_cpu():
    gstpu_torch.init(device="cpu")


def _flat(b):
    return INFO.view(b).reshape(-1)


def _mk_pipeline(ctx_name, block=BLOCK):
    return parse_launch(
        f'appsrc name=src caps="audio/x-raw, format=F64LE, '
        f'rate={RATE}, channels=1, layout=interleaved" ! '
        f'rsaudioecho name=echo {ECHO} context={ctx_name} '
        f'context-block={block} ! appsink name=sink')


def _reference_outputs(signals):
    """Per-stream unbatched echo path of the port."""
    outs = []
    for sig in signals:
        p = parse_launch(
            f'appsrc name=src caps="audio/x-raw, format=F64LE, '
            f'rate={RATE}, channels=1, layout=interleaved" ! '
            f'rsaudioecho {ECHO} ! appsink name=sink')
        src, sink = p.get_by_name("src"), p.get_by_name("sink")
        p.set_state(State.PLAYING)
        for blk in sig:
            src.push_buffer(Buffer(blk.reshape(-1, 1)))
        src.end_of_stream()
        p.run()
        outs.append(np.concatenate([_flat(b) for b in sink.pull_all()]))
        p.set_state(State.NULL)
    return outs


def test_64_streams_one_dispatch_bit_identical():
    n_streams, n_blocks = 64, 3
    rng = np.random.default_rng(0)
    signals = [[rng.uniform(-1, 1, BLOCK) for _ in range(n_blocks)]
               for _ in range(n_streams)]
    ref = _reference_outputs(signals)

    DeviceContext.release("ctx-test")
    pipes = [_mk_pipeline("ctx-test") for _ in range(n_streams)]
    for p in pipes:
        p.set_state(State.PLAYING)
    ctx = DeviceContext.acquire("ctx-test", BLOCK)
    # each full round of pushes completes the batch window: exactly one
    # batched step per block round (members join at caps negotiation,
    # i.e. on their first push)
    for k in range(n_blocks):
        for i, p in enumerate(pipes):
            p.get_by_name("src").push_buffer(
                Buffer(signals[i][k].reshape(-1, 1)))
            while p.iterate():
                pass
        assert len(ctx.members) == n_streams
        assert ctx.fire_count == k + 1, "one step per full block round"
    for p in pipes:
        p.get_by_name("src").end_of_stream()
        p.run()
    for i, p in enumerate(pipes):
        got = np.concatenate(
            [_flat(b) for b in p.get_by_name("sink").pull_all()])
        np.testing.assert_array_equal(got, ref[i])
        p.set_state(State.NULL)
    for i in (0, 63):
        np.testing.assert_array_equal(ref[i], echo_reference(
            np.concatenate(signals[i]), DELAY, DELAY, 0.4, 0.3, fma=False))
    DeviceContext.release("ctx-test")


def test_ragged_buffers_reblocked():
    """Arbitrary input buffer sizes are re-blocked to the batch block;
    the output stays bit-identical to the unbatched path."""
    rng = np.random.default_rng(1)
    total = BLOCK * 2 + 777
    sigs = [rng.uniform(-1, 1, total) for _ in range(3)]
    ref = _reference_outputs([[s] for s in sigs])

    DeviceContext.release("ctx-rag")
    pipes = [_mk_pipeline("ctx-rag") for _ in range(3)]
    for p in pipes:
        p.set_state(State.PLAYING)
    chunkings = [(1000, 3000, total - 4000),
                 (BLOCK, total - BLOCK),
                 (total,)]
    for i, p in enumerate(pipes):
        off = 0
        for c in chunkings[i]:
            p.get_by_name("src").push_buffer(
                Buffer(sigs[i][off:off + c].reshape(-1, 1)))
            off += c
        while p.iterate():
            pass
    for p in pipes:
        p.get_by_name("src").end_of_stream()
        p.run()
    for i, p in enumerate(pipes):
        got = np.concatenate(
            [_flat(b) for b in p.get_by_name("sink").pull_all()])
        np.testing.assert_array_equal(got, ref[i])
        p.set_state(State.NULL)
    DeviceContext.release("ctx-rag")


def test_eos_straggler_drains_masked():
    """A stream reaching EOS with a partial block drains through a
    padded B=1 step without disturbing the other member's state."""
    rng = np.random.default_rng(2)
    a = [rng.uniform(-1, 1, BLOCK) for _ in range(2)]
    b = [rng.uniform(-1, 1, BLOCK // 2)]          # straggler
    ref = _reference_outputs([a, b])

    DeviceContext.release("ctx-eos")
    p1, p2 = _mk_pipeline("ctx-eos"), _mk_pipeline("ctx-eos")
    for p in (p1, p2):
        p.set_state(State.PLAYING)
    p2.get_by_name("src").push_buffer(Buffer(b[0].reshape(-1, 1)))
    p2.get_by_name("src").end_of_stream()
    p2.run()
    got2 = np.concatenate(
        [_flat(x) for x in p2.get_by_name("sink").pull_all()])
    np.testing.assert_array_equal(got2, ref[1])

    for blk in a:
        p1.get_by_name("src").push_buffer(Buffer(blk.reshape(-1, 1)))
    p1.get_by_name("src").end_of_stream()
    p1.run()
    got1 = np.concatenate(
        [_flat(x) for x in p1.get_by_name("sink").pull_all()])
    np.testing.assert_array_equal(got1, ref[0])
    for p in (p1, p2):
        p.set_state(State.NULL)
    DeviceContext.release("ctx-eos")


def test_depth2_overlapped_distribution():
    """depth=2 hands each batch out only after the next is enqueued;
    outputs are identical, one batch later, and flushed at EOS."""
    rng = np.random.default_rng(3)
    sig = [rng.uniform(-1, 1, BLOCK) for _ in range(3)]
    ref = _reference_outputs([sig])

    DeviceContext.release("ctx-d2")
    DeviceContext.acquire("ctx-d2", BLOCK, depth=2)
    p = _mk_pipeline("ctx-d2")
    p.set_state(State.PLAYING)
    src, sink = p.get_by_name("src"), p.get_by_name("sink")
    got = []

    def pull():
        return [_flat(x) for x in sink.pull_all()]

    src.push_buffer(Buffer(sig[0].reshape(-1, 1)))
    while p.iterate():
        pass
    assert len(pull()) == 0               # batch 1 in flight
    src.push_buffer(Buffer(sig[1].reshape(-1, 1)))
    while p.iterate():
        pass
    second = pull()
    assert len(second) == 1               # batch 1 lands on submit 2
    got += second
    src.push_buffer(Buffer(sig[2].reshape(-1, 1)))
    src.end_of_stream()
    p.run()
    got += pull()
    np.testing.assert_array_equal(np.concatenate(got), ref[0])
    p.set_state(State.NULL)
    DeviceContext.release("ctx-d2")


def _video_run(pkg, launch, frames, setup=None, rows=None):
    """One `launch` pipeline per stream of `frames` (S, F, H, W, 4),
    pushed frame by frame (or as DeviceRow rows of per-frame banks when
    rows is given), setup(p) run on each before it plays; returns each
    stream's frames as numpy."""
    S, F, H, W, _ = frames.shape
    pipes = []
    for _ in range(S):
        p = pkg.parse_launch(launch)
        if setup is not None:
            setup(p)
        pipes.append(p)
        p.set_state(pkg.State.PLAYING)
    if rows is not None:
        for f in range(F):
            for s, p in enumerate(pipes):
                p.get_by_name("src").push_buffer(
                    pkg.Buffer(rows(f, s)))
                while p.iterate():
                    pass
        for p in pipes:
            p.get_by_name("src").end_of_stream()
            p.run()
    else:
        for s, p in enumerate(pipes):
            src = p.get_by_name("src")
            for f in range(F):
                src.push_buffer(pkg.Buffer(frames[s, f]))
            src.end_of_stream()
        for p in pipes:
            p.run()
    info = (VideoInfo if pkg is gstpu_torch else JaxVideoInfo)(
        "RGBA", W, H)
    outs = []
    for p in pipes:
        outs.append([np.array(info.view(b))
                     for b in p.get_by_name("sink").pull_all()])
        p.set_state(pkg.State.NULL)
    return outs


def _assert_frames_equal(got, want, n_frames):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) == n_frames
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_video_streams_batch_through_context():
    """N `appsrc ! hsvfilter ! appsink` streams sharing a context run
    as ONE batched frame step, bit-identical to the per-stream path and
    to gstpu's batched pipelines."""
    W, H, N_FRAMES, N_STREAMS = 64, 32, 3, 8
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (N_STREAMS, N_FRAMES, H, W, 4),
                          dtype=np.uint8)

    def launch(ctx):
        extra = f"context={ctx} " if ctx else ""
        return (f'appsrc name=src caps="video/x-raw, format=RGBA, '
                f'width={W}, height={H}, framerate=30/1" ! '
                f'hsvfilter hue_shift=42 saturation_mul=1.2 {extra}'
                f'! appsink name=sink')

    DeviceContext.release("video")
    batched = _video_run(gstpu_torch, launch("video"), frames)
    single = _video_run(gstpu_torch, launch(None), frames)
    JaxDeviceContext.release("video")
    jax_batched = _video_run(gstpu, launch("video"), frames)
    _assert_frames_equal(batched, single, N_FRAMES)
    _assert_frames_equal(batched, jax_batched, N_FRAMES)
    # alpha passed through untouched
    np.testing.assert_array_equal(batched[0][0][..., 3],
                                  frames[0, 0][..., 3])


def test_video_streams_lane_parameters_differ():
    """hsvfilter parameters that differ across the lanes of a fire run
    lane by lane, each with its own; a lane-uniform fire is one call."""
    W, H, N = 16, 8, 3
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (N, 2, H, W, 4), dtype=np.uint8)
    shifts = [10.0, 10.0, 200.0]
    launch = (f'appsrc name=src caps="video/x-raw, format=RGBA, '
              f'width={W}, height={H}, framerate=30/1" ! '
              f'hsvfilter name=h {{}}! appsink name=sink')
    pipes_set = iter(shifts)
    DeviceContext.release("vlane")
    batched = _video_run(
        gstpu_torch, launch.format("context=vlane "), frames,
        setup=lambda p: p.get_by_name("h").set_property(
            "hue_shift", next(pipes_set)))
    for s, shift in enumerate(shifts):
        single = _video_run(gstpu_torch, launch.format(
            f"hue_shift={shift} "), frames[s:s + 1])
        _assert_frames_equal(batched[s:s + 1], single, 2)


def test_hsvdetector_batches_streams():
    """N `hsvdetector context=` streams run as one batched step, equal to
    the unbatched element and to gstpu's batched pipelines; lanes whose
    key windows differ, each with its own."""
    W, H, N = 32, 16, 4
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (N, 2, H, W, 4), dtype=np.uint8)

    def launch(ctx, extra="hue_ref=120 hue_var=60 "):
        ctx = f"context={ctx} " if ctx else ""
        return (f'appsrc name=src caps="video/x-raw, format=RGBA, '
                f'width={W}, height={H}, framerate=30/1" ! '
                f'hsvdetector name=d {extra}saturation_ref=0.5 '
                f'saturation_var=0.5 value_ref=0.5 value_var=0.5 {ctx}! '
                f'appsink name=sink')

    DeviceContext.release("vdet")
    batched = _video_run(gstpu_torch, launch("vdet"), frames)
    single = _video_run(gstpu_torch, launch(None), frames)
    JaxDeviceContext.release("vdet")
    jax_batched = _video_run(gstpu, launch("vdet"), frames)
    _assert_frames_equal(batched, single, 2)
    _assert_frames_equal(batched, jax_batched, 2)
    assert 0 < (batched[0][0][..., 3] == 255).sum() < W * H

    refs = iter([0.0, 0.0, 240.0, 350.0])
    DeviceContext.release("vdet2")
    batched = _video_run(
        gstpu_torch, launch("vdet2", "hue_var=40 "), frames,
        setup=lambda p: p.get_by_name("d").set_property("hue_ref",
                                                        next(refs)))
    for s, ref in enumerate([0.0, 0.0, 240.0, 350.0]):
        single = _video_run(gstpu_torch, launch(
            None, f"hue_ref={ref} hue_var=40 "), frames[s:s + 1])
        _assert_frames_equal(batched[s:s + 1], single, 2)


def test_video_chain_batches_both_stages():
    """hsvfilter AND colorlut each batch N streams (two contexts, one
    per kernel): the chain's output equals the per-stream path and
    gstpu's batched chain."""
    W, H, N_STREAMS = 48, 24, 6
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (N_STREAMS, 2, H, W, 4),
                          dtype=np.uint8)

    def launch(batched):
        extra_h = "context=vh " if batched else ""
        extra_c = "context=vc " if batched else ""
        return (f'appsrc name=src caps="video/x-raw, format=RGBA, '
                f'width={W}, height={H}, framerate=30/1" ! '
                f'hsvfilter hue_shift=33 {extra_h}! '
                f'colorlut name=cl {extra_c}! appsink name=sink')

    def port_lut(p):
        p.get_by_name("cl").set_lut(identity_lut(size=5))

    def jax_lut(p):
        p.get_by_name("cl").set_lut(jax_identity_lut(size=5))

    b = _video_run(gstpu_torch, launch(True), frames, port_lut)
    u = _video_run(gstpu_torch, launch(False), frames, port_lut)
    j = _video_run(gstpu, launch(True), frames, jax_lut)
    _assert_frames_equal(b, u, 2)
    _assert_frames_equal(b, j, 2)


def test_context_checkpoint_resume_bit_exact(tmp_path):
    """Snapshot a live batched context mid-stream, wipe the states (a
    replacement process), restore, continue: the outputs equal the
    uninterrupted run bit for bit."""
    signals = [np.random.default_rng(s).uniform(-0.5, 0.5, (6, BLOCK))
               for s in range(4)]

    def run(interrupt):
        DeviceContext.release("ckpt-ctx")
        pipes = [_mk_pipeline("ckpt-ctx") for _ in range(4)]
        for p in pipes:
            p.set_state(State.PLAYING)

        def push_block(k):
            for i, p in enumerate(pipes):
                p.get_by_name("src").push_buffer(
                    Buffer(signals[i][k].reshape(-1, 1)))
            for p in pipes:
                p.iterate()

        for k in range(3):
            push_block(k)
        if interrupt:
            ctx = DeviceContext.acquire("ckpt-ctx", BLOCK)
            path = str(tmp_path / "ctx.ckpt.npz")
            snapshot_context(ctx, path)
            for m in ctx.members:
                if m.spec is not None:
                    m.state = m.spec["init_state"]()
            restore_context(ctx, path)
        for k in range(3, 6):
            push_block(k)
        outs = []
        for p in pipes:
            p.get_by_name("src").end_of_stream()
            p.run()
            outs.append(np.concatenate(
                [_flat(b) for b in p.get_by_name("sink").pull_all()]))
            p.set_state(State.NULL)
        DeviceContext.release("ckpt-ctx")
        return outs

    for x, y in zip(run(False), run(True)):
        np.testing.assert_array_equal(x, y)


def test_video_chain_single_context_fused():
    """hsvfilter ! colorlut sharing ONE context compose into a single
    step and stay frame-exact against the per-stream path; DeviceRow
    rows of a (B, n) bank go in without a copy (the bank itself is the
    batch)."""
    W, H, N = 32, 16, 3
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (N, 2, H, W, 4), dtype=np.uint8)

    def launch(ctx):
        extra = f"context={ctx} " if ctx else ""
        return (f'appsrc name=src caps="video/x-raw, format=RGBA, '
                f'width={W}, height={H}, framerate=30/1" ! '
                f'hsvfilter hue_shift=33 {extra}! '
                f'colorlut name=cl {extra}! appsink name=sink')

    def set_lut(p):
        p.get_by_name("cl").set_lut(identity_lut(size=5))

    banks = [torch.from_numpy(frames[:, f].reshape(N, -1).copy())
             for f in range(2)]
    seen = []

    def rows(f, s):
        if s == 0:
            ctx = DeviceContext.acquire("vf")
            seen.append(ctx.fire_count)
        return DeviceRow(banks[f], s)

    plain = _video_run(gstpu_torch, launch(None), frames, set_lut)
    DeviceContext.release("vf")
    fused = _video_run(gstpu_torch, launch("vf"), frames, set_lut)
    DeviceContext.release("vf")
    dev = _video_run(gstpu_torch, launch("vf"), frames, set_lut, rows=rows)
    _assert_frames_equal(fused, plain, 2)
    _assert_frames_equal(dev, plain, 2)
    assert seen == [0, 1]                 # one step a round
    # the banks are the caller's: batching never wrote into them
    np.testing.assert_array_equal(banks[0].numpy(),
                                  frames[:, 0].reshape(N, -1))


@pytest.mark.parametrize("rows", ["tensor", "bank"])
def test_stacked_bytes_count_copies_not_banks(rows):
    """Two pipelines in one context: a fire stacks tensor rows, and the
    program's counters say how many rows and bytes it copied (frames x
    frame bytes); rows 0..B-1 of one bank go in whole, and nothing is
    counted."""
    W, H, N, F = 32, 16, 2, 3
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (N, F, H, W, 4), dtype=np.uint8)
    launch = (f'appsrc name=src caps="video/x-raw, format=RGBA, '
              f'width={W}, height={H}, framerate=30/1" ! '
              f'hsvfilter hue_shift=33 context=vs ! '
              f'colorlut name=cl context=vs ! appsink name=sink')
    banks = [torch.from_numpy(frames[:, f].reshape(N, -1).copy())
             for f in range(F)]

    def row(f, s):
        if rows == "bank":
            return DeviceRow(banks[f], s)
        return torch.from_numpy(frames[s, f].copy())

    def set_lut(p):
        p.get_by_name("cl").set_lut(identity_lut(size=5))

    spans = tracing.ProgramSpans()
    spans.install()
    DeviceContext.release("vs")
    try:
        out = _video_run(gstpu_torch, launch, frames, set_lut, rows=row)
    finally:
        spans.uninstall()
        DeviceContext.release("vs")
    assert [len(o) for o in out] == [F] * N
    s = spans.snapshot()
    copied = rows == "tensor"
    assert s["counters"].get("context.stacked_rows", 0) == \
        (N * F if copied else 0)
    assert s["counters"].get("context.stacked_bytes", 0) == \
        (N * F * H * W * 4 if copied else 0)
    assert s["calls"]["context.fire"] == F
    assert s["calls"]["context.submit"] == N * F


def _echo_context(name, n):
    DeviceContext.release(name)
    pipes = [_mk_pipeline(name) for _ in range(n)]
    for p in pipes:
        p.set_state(State.PLAYING)
        p.get_by_name("src").push_buffer(Buffer(np.zeros((10, 1))))
        while p.iterate():
            pass
    return DeviceContext.acquire(name), pipes


def test_stack_states_keeps_host_ints_and_raises_on_disagreement():
    """A host int in the carried state (loudnorm_dev's nsub_in, nsub_out,
    gidx) is one int for the whole fire, handed back to each chain; the
    chains of one fire disagreeing on it is a fault, not a choice."""
    ctx, pipes = _echo_context("ctx-ints", 3)
    ctx._build_chains()
    for i, c in enumerate(ctx.chains):
        c.stages[0].owner.state = {"tail": torch.full((4,), float(i)),
                                   "gidx": 7}
    st = ctx._stack_states(ctx.chains, 0)
    assert st["gidx"] == 7 and isinstance(st["gidx"], int)
    assert st["tail"].shape == (3, 4)
    ctx._batched = (tuple(id(c) for c in ctx.chains), (st,))
    ctx._writeback()
    for i, c in enumerate(ctx.chains):
        back = c.stages[0].owner.state
        assert back["gidx"] == 7
        assert torch.equal(back["tail"], torch.full((4,), float(i)))
    ctx.chains[1].stages[0].owner.state["gidx"] = 8
    with pytest.raises(ValueError, match="host-int state differs"):
        ctx._stack_states(ctx.chains, 0)
    for p in pipes:
        p.set_state(State.NULL)
    DeviceContext.release("ctx-ints")


def test_port_and_gstpu_contexts_are_apart():
    """Each package keeps its own registry of contexts: one name in
    both is two contexts."""
    JaxDeviceContext.release("shared")
    DeviceContext.release("shared")
    a = DeviceContext.acquire("shared", BLOCK)
    b = JaxDeviceContext.acquire("shared", 2 * BLOCK)
    assert a is not b and a.block == BLOCK and b.block == 2 * BLOCK
    assert DeviceContext._registry is not JaxDeviceContext._registry
    DeviceContext.release("shared")
    JaxDeviceContext.release("shared")


def test_echo_lane_uniforms_differ():
    """Uniforms that differ across the lanes of a fire reach the step as
    one (B, 1) f64 tensor; each stream still equals its unbatched run
    and the strict golden."""
    rng = np.random.default_rng(4)
    sigs = [rng.uniform(-1, 1, 2 * BLOCK) for _ in range(3)]
    DeviceContext.release("ctx-uni")
    pipes = [_mk_pipeline("ctx-uni") for _ in range(3)]
    for p, inten in zip(pipes, (0.4, 0.9, 0.4)):
        p.get_by_name("echo").set_property("intensity", inten)
        p.set_state(State.PLAYING)
    for k in range(2):
        for i, p in enumerate(pipes):
            p.get_by_name("src").push_buffer(
                Buffer(sigs[i][k * BLOCK:(k + 1) * BLOCK, None]))
            while p.iterate():
                pass
    ctx = DeviceContext.acquire("ctx-uni")
    assert ctx.fire_count == 2
    unis = ctx._uni_cache[1][0]
    assert isinstance(unis[0], torch.Tensor) and unis[0].shape == (3, 1)
    assert unis[1] == 0.3                # feedback: lane-uniform
    for i, (p, inten) in enumerate(zip(pipes, (0.4, 0.9, 0.4))):
        got = np.concatenate(
            [_flat(b) for b in p.get_by_name("sink").pull_all()])
        np.testing.assert_array_equal(got, echo_reference(
            sigs[i], DELAY, DELAY, inten, 0.3, fma=False))
        p.set_state(State.NULL)
    DeviceContext.release("ctx-uni")


def test_batch_rows_on_two_devices_raise():
    """A fire assembles its batch where its rows lie; rows on two
    devices are a fault, not a copy."""
    rows = [torch.zeros(8), torch.zeros(8, device="meta")]
    with pytest.raises(ValueError, match="different devices"):
        DeviceContext._batch(rows, (), np.float64)
    # host rows go to the default device: here the CPU, with CPU rows
    x = DeviceContext._batch([np.ones(8), torch.zeros(8)], (), np.float64)
    assert x.shape == (2, 8) and x.device.type == "cpu"
    assert torch.equal(x[0], torch.ones(8, dtype=torch.float64))


def test_aux_view_reads_every_leaf_at_once():
    leaves = {"momentary": torch.tensor([-23.5, -24.0]),
              "speak": torch.tensor([[0.5, 0.25], [0.125, 1.0]])}
    aux = AuxView(leaves)
    assert set(aux.keys()) == {"momentary", "speak"}
    assert isinstance(aux["momentary"], np.ndarray)
    np.testing.assert_array_equal(aux["speak"], leaves["speak"].numpy())
    assert aux._host is not None          # all leaves on the host now
