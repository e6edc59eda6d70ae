"""The port's flagship chain and rsaudioecho element against gstpu's, on
the CPU.

`make_audiofx_exact_chain` (rsaudioecho -> audioloudnorm ->
ebur128level) runs in both packages on the same seeded streams: the
outputs within 1e-12 abs, the meters within 1e-9 rel, as gstpu's own
sharded-vs-unsharded test holds them (tests/test_parallel.py). A
stream's state crosses between the packages through numpy, and the
rsaudioecho gst-launch string runs in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.core.audio import AudioInfo as JaxAudioInfo
from gstpu.ops.echo import echo_reference
from gstpu.parallel import chains as jchains
from gstpu_torch.core.audio import AudioInfo
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.parallel import chains
from gstpu_torch.utils import tracing
from torch_session import torch_test_limit  # noqa: F401

B = 4
INTENSITY, FEEDBACK = 0.4, 0.3


@pytest.fixture(scope="module")
def both_chains():
    kw = dict(channels=1, echo_delay=2_400, max_delay=2_400)
    return jchains.make_audiofx_exact_chain(**kw), \
        chains.make_audiofx_exact_chain(**kw)


@pytest.fixture(scope="module")
def inputs(both_chains):
    _, (_, _, _, n_prime, n_step) = both_chains
    rng = np.random.default_rng(0)
    return (rng.uniform(-0.3, 0.3, (B, n_prime)),
            [rng.uniform(-0.3, 0.3, (B, n_step)) for _ in range(4)])


def _jax_args():
    return jnp.float64(INTENSITY), jnp.float64(FEEDBACK)


def _close(got, want, meters=None, jmeters=None):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    if meters is not None:
        for k in ("momentary", "shortterm"):
            np.testing.assert_allclose(meters[k].numpy(),
                                       np.asarray(jmeters[k]), rtol=1e-9,
                                       atol=0, err_msg=k)


@pytest.fixture(scope="module")
def jax_run(both_chains, inputs):
    """gstpu's chain: the prime, then each step, with the numpy state
    before each step."""
    (jprime, jstep, jinit, _, _), _ = both_chains
    x0, xs = inputs
    st, o0 = jprime(jinit(B), jnp.asarray(x0), *_jax_args())
    outs, meters, states = [o0], [], []
    for x in xs:
        states.append(jax_tree_to_numpy(st))
        st, o, m = jstep(st, jnp.asarray(x), *_jax_args())
        outs.append(o)
        meters.append(m)
    return outs, meters, states


def jax_tree_to_numpy(st):
    return dict(tail=np.asarray(st["tail"]),
                ln={k: np.asarray(v) for k, v in st["ln"].items()})


def test_exact_chain_matches_gstpu(both_chains, inputs, jax_run):
    _, (prime, step, init, _, _) = both_chains
    x0, xs = inputs
    outs, jmeters, _ = jax_run
    st, o0 = prime(init(B, device="cpu"), torch.from_numpy(x0), INTENSITY,
                   FEEDBACK)
    _close(o0, outs[0])
    for k in range(2):
        st, o, m = step(st, torch.from_numpy(xs[k]), INTENSITY, FEEDBACK)
        _close(o, outs[k + 1], m, jmeters[k])
        assert o.dtype == torch.float64 and o.shape == (B, xs[k].shape[1])


def test_exact_chain_lanes_are_independent(both_chains, inputs):
    _, (prime, step, init, _, _) = both_chains
    x0, xs = inputs
    st, oB = prime(init(B, device="cpu"), torch.from_numpy(x0), INTENSITY,
                   FEEDBACK)
    st1, o1 = prime(init(1, device="cpu"), torch.from_numpy(x0[2:3]),
                    INTENSITY, FEEDBACK)
    assert torch.equal(o1[0], oB[2])
    for x in xs[:2]:
        st, oB, mB = step(st, torch.from_numpy(x), INTENSITY, FEEDBACK)
        st1, o1, m1 = step(st1, torch.from_numpy(x[2:3]), INTENSITY,
                           FEEDBACK)
        assert torch.equal(o1[0], oB[2])
        assert torch.equal(m1["shortterm"][0], mB["shortterm"][2])


def test_stream_primed_in_gstpu_steps_on_in_the_port(both_chains, inputs,
                                                     jax_run):
    """gstpu's state after the prime and a step, carried through numpy
    into the port, continues as gstpu does; and the port's state
    carried back continues in gstpu."""
    (_, jstep, _, _, _), (_, step, _, _, _) = both_chains
    _, xs = inputs
    outs, jmeters, states = jax_run
    st = chains.state_from_numpy(states[1], device="cpu")
    assert isinstance(st["ln"]["gidx"], int)
    for k in (1, 2):
        st, o, m = step(st, torch.from_numpy(xs[k]), INTENSITY, FEEDBACK)
        _close(o, outs[k + 1], m, jmeters[k])
    back = chains.state_to_numpy(st)
    jst = dict(tail=jnp.asarray(back["tail"]),
               ln={k: jnp.asarray(v) for k, v in back["ln"].items()})
    jst, o, m = jstep(jst, jnp.asarray(xs[3]), *_jax_args())
    np.testing.assert_allclose(np.asarray(o), np.asarray(outs[4]), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(m["shortterm"]),
                               np.asarray(jmeters[3]["shortterm"]),
                               rtol=1e-9, atol=0)


def test_step_marks_each_stage_in_order(both_chains, inputs):
    """The step's spans on the program's tracer: `chain.step` holding
    one `chain.<stage>` span a stage, in STAGES order, each a device
    span; the limiter's waits inside `chain.limiter`, and its loop
    counted."""
    _, (prime, step, init, _, _) = both_chains
    x0, xs = inputs
    st, _ = prime(init(1, device="cpu"), torch.from_numpy(x0[:1]),
                  INTENSITY, FEEDBACK)
    spans = tracing.ProgramSpans(device=True)
    spans.install()
    spans.keep(True)
    try:
        step(st, torch.from_numpy(xs[0][:1]), INTENSITY, FEEDBACK)
    finally:
        spans.uninstall()
    kept = spans.intervals()
    by_id = {i: (name, parent) for _, _, name, i, parent, _, _ in kept}
    (root,) = [i for i, (name, _) in by_id.items() if name == "chain.step"]
    stages = sorted((a, name) for a, _, name, _, parent, _, _ in kept
                    if parent == root)
    assert tuple(n for _, n in stages) == tuple(
        f"chain.{k}" for k in chains.STAGES)
    assert tuple(n for _, _, n, _, _ in spans.device_intervals()) == \
        tuple(f"chain.{k}" for k in chains.STAGES)
    waits = [parent for _, _, name, _, parent, _, _ in kept
             if name == "limiter.wait"]
    assert waits and all(by_id[p][0] == "chain.limiter" for p in waits)
    iterations = spans.snapshot()["counters"]["limiter.iterations"]
    assert iterations > 0 and len(waits) == iterations + 1
    # one request, the step's number, on every span of the step
    assert len({r for *_, r, _ in kept}) == 1


def test_chain_state_numpy_round_trip(both_chains):
    _, (_, _, init, _, _) = both_chains
    st = init(2, device="cpu")
    back = chains.state_from_numpy(chains.state_to_numpy(st), device="cpu")
    assert torch.equal(back["tail"], st["tail"])
    assert back["ln"].keys() == st["ln"].keys()


# -- the rsaudioecho element --------------------------------------------

ECHO_LAUNCH = (
    "audiotestsrc num-buffers=20 samplesperbuffer=1024 wave=ticks "
    "! audio/x-raw, format=F64LE, rate=48000, channels=2 "
    "! rsaudioecho delay=100000000 max-delay=200000000 intensity=0.5 "
    "feedback=0.3 ! appsink name=sink")


def _run(pkg, launch):
    p = pkg.parse_launch(launch)
    sink = p.get_by_name("sink")
    p.set_state(pkg.State.PLAYING)
    p.run()
    bufs = sink.pull_all()
    caps = sink.caps
    p.set_state(pkg.State.NULL)
    return bufs, caps


def test_rsaudioecho_launch_matches_gstpu():
    gstpu_torch.init(device="cpu")
    got, caps = _run(gstpu_torch, ECHO_LAUNCH)
    want, jcaps = _run(gstpu, ECHO_LAUNCH)
    assert len(got) == len(want) == 20
    assert [b.pts for b in got] == [b.pts for b in want]
    assert all(isinstance(b.data, torch.Tensor) for b in got)
    info, jinfo = AudioInfo.from_caps(caps), JaxAudioInfo.from_caps(jcaps)
    out = np.concatenate([info.view(b) for b in got]).reshape(-1)
    ref = np.concatenate([jinfo.view(b) for b in want]).reshape(-1)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=0)
    src, _ = _run(gstpu_torch, ECHO_LAUNCH.replace(
        "! rsaudioecho delay=100000000 max-delay=200000000 intensity=0.5 "
        "feedback=0.3 ", ""))
    x = np.concatenate([info.view(b) for b in src]).reshape(-1)
    d = (100_000_000 * 48000 * 2) // 1_000_000_000
    size = (200_000_000 * 48000 * 2) // 1_000_000_000
    np.testing.assert_array_equal(
        out, echo_reference(x, d, size, 0.5, 0.3, fma=False))


def test_rsaudioecho_takes_tensor_buffers_f32():
    """Tensors pushed in are processed where they lie; F32 comes back
    F32, equal to the strict golden."""
    gstpu_torch.init(device="cpu")
    caps = "audio/x-raw, format=F32LE, rate=48000, channels=1"
    p = gstpu_torch.parse_launch(
        f'appsrc name=src caps="{caps}" ! rsaudioecho delay=10000000 '
        f'max-delay=20000000 intensity=0.6 ! appsink name=sink')
    p.set_state(gstpu_torch.State.PLAYING)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, size=(3000, 1)).astype(np.float32)
    for off in range(0, 3000, 1000):
        p.get_by_name("src").push_buffer(
            Buffer(torch.from_numpy(x[off:off + 1000]), pts=off))
        while p.iterate():
            pass
    bufs = p.get_by_name("sink").pull_all()
    p.set_state(gstpu_torch.State.NULL)
    out = torch.cat([b.data for b in bufs]).numpy().reshape(-1)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(
        out, echo_reference(x.reshape(-1), 480, 960, 0.6, 0.0, fma=False))


def test_rsaudioecho_context_is_refused_not_ignored():
    """`context` is honoured, not ignored: two rsaudioecho pipelines
    naming one context run as one batched step per block round, and
    each stream equals the strict golden."""
    from gstpu_torch.runtime.device_batch import DeviceContext
    gstpu_torch.init(device="cpu")
    DeviceContext.release("streams")
    caps = "audio/x-raw, format=F64LE, rate=48000, channels=1"
    pipes = [gstpu_torch.parse_launch(
        f'appsrc name=src caps="{caps}" ! rsaudioecho delay=10000000 '
        f'max-delay=20000000 intensity=0.6 feedback=0.2 context=streams '
        f'context-block=1000 ! appsink name=sink') for _ in range(2)]
    for p in pipes:
        p.set_state(gstpu_torch.State.PLAYING)
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, size=(2, 3000))
    ctx = DeviceContext.acquire("streams")
    for k in range(3):
        for i, p in enumerate(pipes):
            p.get_by_name("src").push_buffer(
                Buffer(x[i, k * 1000:(k + 1) * 1000, None]))
            while p.iterate():
                pass
        assert ctx.fire_count == k + 1
    for i, p in enumerate(pipes):
        bufs = p.get_by_name("sink").pull_all()
        p.set_state(gstpu_torch.State.NULL)
        out = np.concatenate([np.asarray(b.array).reshape(-1)
                              for b in bufs])
        np.testing.assert_array_equal(
            out, echo_reference(x[i], 480, 960, 0.6, 0.2, fma=False))
    DeviceContext.release("streams")


def test_audio_info_tensor():
    info = AudioInfo("F32LE", 48000, 2)
    host = np.arange(8, dtype=np.float32).reshape(4, 2)
    t = info.tensor(Buffer(host), "cpu")
    assert t.dtype == torch.float32 and tuple(t.shape) == (4, 2)
    assert np.array_equal(t.numpy(), host)
    raw = torch.from_numpy(host.reshape(-1).view(np.uint8).copy())
    same = info.tensor(Buffer(raw), "cpu")
    assert same.dtype == torch.float32 and torch.equal(same, t)
    with pytest.raises(ValueError, match="F64BE"):
        AudioInfo("F64BE", 48000, 2).tensor(Buffer(host), "cpu")
