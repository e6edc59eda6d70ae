"""The port's DeviceContext CHAIN path against its direct chain and
against gstpu, on the CPU.

Twins of tests/test_chain_context.py: 2 parse_launch pipelines of
`rsaudioecho ! audioloudnorm ! ebur128level` share one context, which
composes the three stages into one step per 100 ms block round
(channels=1, 30 + 4 frames, a small device gating history). Gates:
  * the context chain equals the port's `make_audiofx_exact_chain` at the
    same B bit for bit, every lane, and each lane equals a B=1 run bit
    for bit (batching and the element machinery add nothing);
  * within 1e-12 of gstpu's context chain in the streaming region;
  * within 1e-9 of gstpu's host `audioloudnorm` element, the EOS tail
    included;
  * depth=2, fusion on/off and a checkpoint resume change no bit.
gstpu's side is computed once per module: its f64 prime compiles slowly
on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import gstpu
import gstpu_torch
from gstpu.runtime.device_batch import DeviceContext as JaxDeviceContext
from gstpu_torch.parallel.chains import make_audiofx_exact_chain
from gstpu_torch.runtime.device_batch import (DeviceContext,
                                              restore_context,
                                              snapshot_context)
from torch_session import torch_test_limit  # noqa: F401

FRAME = 19_200
GATING = 64          # small device gating history, as gstpu's test
N_INNER = 4
N_STREAM = (30 + N_INNER) * FRAME     # the streaming region's samples
CAPS = ("audio/x-raw, format=F64LE, rate=192000, channels=1, "
        "layout=interleaved")
INTENSITY, FEEDBACK = 0.4, 0.3
DELAY = (250_000_000 * 192_000) // 1_000_000_000


def _launch(ctx: str, gating: int = GATING,
            mode: str = "momentary,short-term") -> str:
    return (f'appsrc name=src caps="{CAPS}" ! '
            f'rsaudioecho delay=250000000 max-delay=250000000 '
            f'intensity={INTENSITY} feedback={FEEDBACK} context={ctx} '
            f'context-block={FRAME} ! '
            f'audioloudnorm context={ctx} device-gating-blocks={gating} ! '
            f'ebur128level context={ctx} mode={mode} '
            f'interval=200000000 device-gating-blocks={gating} ! '
            f'appsink name=sink')


def _run_chain(pkg, sigs, ctx="tchain", gating=GATING, on_frame=None):
    """N pipelines of the chain in `pkg` sharing context `ctx`; returns
    each stream's output (EOS tail included) and its level messages.
    on_frame(k) runs after every stream has pushed frame k."""
    pipes = [pkg.parse_launch(_launch(ctx, gating)) for _ in sigs]
    for p in pipes:
        p.set_state(pkg.State.PLAYING)
    for k in range(sigs[0].shape[0]):
        for s, p in enumerate(pipes):
            p.get_by_name("src").push_buffer(
                pkg.Buffer(sigs[s][k], pts=k * 100_000_000))
            while p.iterate():
                pass
        if on_frame is not None:
            on_frame(k)
    for p in pipes:
        p.get_by_name("src").end_of_stream()
        p.run()
    outs, msgs = [], []
    for p in pipes:
        bufs = p.get_by_name("sink").pull_all()
        outs.append(np.concatenate([np.asarray(b.array).reshape(-1)
                                    for b in bufs]))
        msgs.append([m for m in p.bus.drain()
                     if getattr(m, "name", "") == "ebur128-level"])
        p.set_state(pkg.State.NULL)
    return outs, msgs


def _port_chain(sigs, ctx="tchain", depth=None, **kw):
    gstpu_torch.init(device="cpu")
    DeviceContext.release(ctx)
    if depth is not None:
        DeviceContext.acquire(ctx, FRAME, depth=depth)
    try:
        return _run_chain(gstpu_torch, sigs, ctx, **kw)
    finally:
        DeviceContext.release(ctx)


def _direct(sigs, batch_of=None):
    """The port's make_audiofx_exact_chain (4096-block gating history,
    the elements' default) over the same frames at B = len(sigs);
    returns (B, streaming samples)."""
    prime, step, init, _, _ = make_audiofx_exact_chain(
        channels=1, echo_delay=DELAY, max_delay=DELAY)
    st, out = prime(init(len(sigs), device="cpu"), torch.from_numpy(
        np.stack([s[:30].reshape(-1) for s in sigs])), INTENSITY, FEEDBACK)
    outs = [out]
    for k in range(30, sigs[0].shape[0]):
        st, out, _ = step(st, torch.from_numpy(
            np.stack([s[k].reshape(-1) for s in sigs])), INTENSITY,
            FEEDBACK)
        outs.append(out)
    return torch.cat(outs, dim=1).numpy()


@pytest.fixture(scope="module")
def chain_signals():
    rng = np.random.default_rng(7)
    return [0.2 * rng.standard_normal((30 + N_INNER, FRAME, 1))
            for _ in range(2)]


@pytest.fixture(scope="module")
def jax_chain(chain_signals):
    """gstpu's context chain on the same signals (outputs, messages)."""
    gstpu.init()
    JaxDeviceContext.release("tchain")
    try:
        return _run_chain(gstpu, chain_signals)
    finally:
        JaxDeviceContext.release("tchain")


@pytest.fixture(scope="module")
def jax_host(chain_signals):
    """gstpu's host elements `rsaudioecho ! audioloudnorm` on stream 0."""
    gstpu.init()
    sig = chain_signals[0]
    p = gstpu.parse_launch(
        f'appsrc name=src caps="{CAPS}" ! rsaudioecho delay=250000000 '
        f'max-delay=250000000 intensity={INTENSITY} feedback={FEEDBACK} '
        f'! audioloudnorm ! appsink name=sink')
    p.set_state(gstpu.State.PLAYING)
    for k in range(sig.shape[0]):
        p.get_by_name("src").push_buffer(
            gstpu.Buffer(sig[k], pts=k * 100_000_000))
        while p.iterate():
            pass
    p.get_by_name("src").end_of_stream()
    p.run()
    out = np.concatenate([np.asarray(b.array).reshape(-1)
                          for b in p.get_by_name("sink").pull_all()])
    p.set_state(gstpu.State.NULL)
    return out


@pytest.fixture(scope="module")
def port_chain(chain_signals):
    return _port_chain(chain_signals)


@pytest.fixture(scope="module")
def port_chain_4096(chain_signals):
    """The chain at the elements' default gating history, the one
    make_audiofx_exact_chain has."""
    return _port_chain(chain_signals, gating=4096)


def test_chain_context_matches_direct_same_batch_bitwise(
        chain_signals, port_chain_4096):
    """The element/context machinery adds ZERO numerical difference:
    the context chain at B=2 equals make_audiofx_exact_chain at B=2,
    bit for bit, every lane."""
    outs, msgs = port_chain_4096
    ref = _direct(chain_signals)
    for s in range(len(chain_signals)):
        assert outs[s].size > ref[s].size
        assert np.array_equal(outs[s][:ref[s].size], ref[s]), s
    assert msgs[0], "no ebur128-level messages posted"
    st = msgs[0][-1].fields["shortterm-loudness"]
    assert -70.0 < st < 0.0


def test_chain_context_lanes_match_b1_bitwise(chain_signals,
                                              port_chain_4096):
    """Each lane of the B=2 context equals the chain run alone at B=1,
    bit for bit: no sum in the port depends on the batch."""
    outs, _ = port_chain_4096
    for s, sig in enumerate(chain_signals):
        ref = _direct([sig])[0]
        assert np.array_equal(outs[s][:ref.size], ref), s


def test_chain_context_matches_gstpu_context(port_chain, jax_chain):
    """The same launch strings in both packages: the streaming region
    within 1e-12 (the port rounds where XLA contracts to FMA), the
    EOS tail as long, and the same level messages at the same
    timestamps within 1e-9."""
    (outs, msgs), (jouts, jmsgs) = port_chain, jax_chain
    for s in range(len(outs)):
        assert outs[s].shape == jouts[s].shape
        d = np.abs(outs[s][:N_STREAM] - jouts[s][:N_STREAM]).max()
        assert d <= 1e-12, f"stream {s}: {d}"
        assert len(msgs[s]) == len(jmsgs[s]) > 0
        for m, jm in zip(msgs[s], jmsgs[s]):
            assert m.fields["timestamp"] == jm.fields["timestamp"]
            for k in ("momentary-loudness", "shortterm-loudness"):
                assert abs(m.fields[k] - jm.fields[k]) <= 1e-9, k


def test_chain_context_vs_gstpu_host_element(port_chain, jax_host):
    """Stream 0 against gstpu's host numpy audioloudnorm (sample-exact
    against the literal reference), over the full length: the context
    drains the 3 s gain lookahead at EOS like the host element."""
    outs, _ = port_chain
    assert outs[0].size == jax_host.size, (outs[0].size, jax_host.size)
    d = np.abs(outs[0] - jax_host).max()
    assert d <= 1e-9, f"context chain vs host element: max diff {d}"


def test_chain_context_depth2_bit_identical(chain_signals, port_chain):
    """depth=2 (batch k handed out after batch k+1 is enqueued) changes
    no bit, and the level messages still arrive."""
    outs, msgs = _port_chain(chain_signals, depth=2)
    for a, b in zip(port_chain[0], outs):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert all(msgs)
    assert [m.fields for m in msgs[0]] == \
        [m.fields for m in port_chain[1][0]]


def _stage_probe(mode):
    """Build one chain, return (stage keys, members per stage)."""
    gstpu_torch.init(device="cpu")
    DeviceContext.release("tfuse")
    p = gstpu_torch.parse_launch(_launch("tfuse", mode=mode))
    p.set_state(gstpu_torch.State.PLAYING)
    # one frame negotiates caps -> members finalize (no fire yet: the
    # loudnorm stage needs the 3 s priming window)
    p.get_by_name("src").push_buffer(
        gstpu_torch.Buffer(np.zeros((FRAME, 1)), pts=0))
    while p.iterate():
        pass
    ctx = DeviceContext.acquire("tfuse")
    assert ctx._build_chains()
    assert ctx.fire_count == 0
    stages = ctx.chains[0].stages
    keys = [s.spec["key"][0] for s in stages]
    n_members = [len(s.members) for s in stages]
    p.set_state(gstpu_torch.State.NULL)
    DeviceContext.release("tfuse")
    return keys, n_members


def test_fusion_engages_for_momentary_shortterm():
    """loudnorm absorbs a momentary/short-term ebur128level into ONE
    stage: the gain machine's output measurement IS the meter."""
    keys, n_members = _stage_probe("momentary,short-term")
    assert keys == ["rsaudioecho", "audioloudnorm+ebur128level"]
    assert n_members == [1, 2]


def test_fusion_declines_global_mode():
    """global gating needs the standalone meter state: no fusion."""
    keys, n_members = _stage_probe("momentary,global")
    assert keys == ["rsaudioecho", "audioloudnorm", "ebur128level"]
    assert n_members == [1, 1, 1]


def test_fusion_identity_vs_unfused(chain_signals, port_chain, monkeypatch):
    """Fused == unfused: samples bit for bit, and the meter messages too
    (the fused meter reads loudnorm's output ring; the standalone stage
    runs its own K-weighting over the same output: the same ops)."""
    monkeypatch.setenv("GSTPU_NO_CHAIN_FUSION", "1")
    outs, msgs = _port_chain(chain_signals)
    for a, b in zip(port_chain[0], outs):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert len(msgs[0]) == len(port_chain[1][0]) > 0
    for mf, mp in zip(port_chain[1][0], msgs[0]):
        assert mf.fields["timestamp"] == mp.fields["timestamp"]
        for k in ("momentary-loudness", "shortterm-loudness"):
            assert mf.fields[k] == mp.fields[k], k


def test_fused_chain_checkpoint_resume_bit_exact(chain_signals, port_chain,
                                                 tmp_path):
    """Snapshot the live FUSED context mid-stream (the fused stage's
    state lives on the loudnorm member), wipe every member's state,
    restore, continue: the outputs equal the uninterrupted run bit for
    bit."""
    path = str(tmp_path / "fused.ckpt.npz")

    def interrupt(k):
        if k != 31:
            return
        ctx = DeviceContext.acquire("tchain")
        assert len(ctx.chains[0].stages) == 2        # fused
        snapshot_context(ctx, path)
        for m in ctx.members:
            if m.spec is not None:
                m.state = m.spec["init_state"]()
        restore_context(ctx, path)

    outs, _ = _port_chain(chain_signals, on_frame=interrupt)
    for x, y in zip(port_chain[0], outs):
        assert x.shape == y.shape and np.array_equal(x, y)
