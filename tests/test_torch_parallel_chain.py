"""The port's make_audiofx_chain (gstpu_torch.parallel.chains) against
gstpu's, on the CPU, on the same inputs and state.

The echo tail is bit for bit with the port's `echo_block` (and within an
f64 ulp of gstpu's, whose XLA contracts the echo to FMAs). The K-weighted
energy goes through an f32 rFFT whose rounding differs between torch and
XLA, so the output, the loudness and the gain are held to bounds set
above what this file measured (the worst over its cases):
  output       2.4e-7 absolute (2 f32 ulps at 1.0; measured 1.19e-7)
  loudness     1e-5 dB (measured 1.91e-6)
  smooth gain  1e-6 relative (measured 3.82e-7)
  FIR history  1.2e-7 absolute (measured 0)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gstpu_torch
from gstpu.parallel.chains import make_audiofx_chain as jax_make_chain
from gstpu_torch.core import device as device_mod
from gstpu_torch.ops.echo import echo_block
from gstpu_torch.parallel import chains
from gstpu_torch.parallel.chains import kweight_fir, make_audiofx_chain

OUT_TOL = 2.4e-7
LOUD_TOL_DB = 1e-5
GAIN_RTOL = 1e-6
HIST_TOL = 1.2e-7

# (rate, delay, tail, block, x dtype, (intensity, feedback, target)):
# test_parallel.py's convergence case, test_checkpoint.py's, and the
# flagship's rate and width with f64 blocks (fewer lanes)
CASES = {
    "converge": (48_000, 1_200, 1_200, 4_800, np.float32,
                 (0.0, 0.0, 10 ** (-24 / 20))),
    "checkpoint": (8_000, 400, 400, 2_000, np.float32, (0.4, 0.3, 0.1)),
    "flagship": (192_000, 48_000, 48_000, 19_200, np.float64,
                 (0.4, 0.3, 0.1)),
}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU, in one torch thread (test_torch_streams.py
    says why)."""
    gstpu_torch.init(device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _uniforms(u):
    """The uniforms as gstpu's tests pass them (jnp.float32) and as the
    same f32 values in Python floats for the port."""
    return (tuple(jnp.float32(v) for v in u),
            tuple(float(np.float32(v)) for v in u))


def _blocks(case, n, B=4, seed=0):
    rate, delay, tail, block, dtype, _ = CASES[case]
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, block)) * 0.1).astype(dtype)
            for _ in range(n)]


def _close(st, out, loud, jst, jout, jloud) -> None:
    assert out.numpy().dtype == np.asarray(jout).dtype
    assert np.abs(out.numpy() - np.asarray(jout)).max() <= OUT_TOL
    assert np.abs(loud.numpy() - np.asarray(jloud)).max() <= LOUD_TOL_DB
    np.testing.assert_allclose(st[0].numpy(), np.asarray(jst[0]),
                               rtol=1e-12, atol=1e-300)
    assert np.abs(st[1].numpy() - np.asarray(jst[1])).max() <= HIST_TOL
    np.testing.assert_allclose(st[2].numpy(), np.asarray(jst[2]),
                               rtol=GAIN_RTOL, atol=0)


def test_kweight_fir_is_gstpus():
    from gstpu.parallel.chains import kweight_fir as jax_kweight_fir
    for rate in (8_000, 48_000, 192_000):
        got = kweight_fir(rate)
        assert got.dtype == np.float32 and got.shape == (511,)
        np.testing.assert_array_equal(got, jax_kweight_fir(rate))


def test_audiofx_chain_converges_to_target():
    """Twin of tests/test_parallel.py::test_audiofx_chain_converges_to_
    target."""
    step, init_state = make_audiofx_chain(48000, 1200, 1200, block=4800)
    B = 4
    state = init_state(B)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        (rng.uniform(-1, 1, (B, 4800))
         * np.array([0.9, 0.3, 0.05, 0.6])[:, None]).astype(np.float32))
    target = float(np.float32(10 ** (-24 / 20)))
    for _ in range(30):
        state, out, loud = step(state, x, 0.0, 0.0, target)
    rms_db = 20 * np.log10(np.sqrt(np.mean(out.numpy() ** 2, axis=-1)))
    assert rms_db.max() - rms_db.min() < 5.0, rms_db
    assert np.all((-30.0 < rms_db) & (rms_db < -20.0)), rms_db
    loud = loud.numpy()
    assert loud[0] > loud[1] > loud[2]


@pytest.mark.parametrize("case", list(CASES))
def test_audiofx_chain_matches_gstpu(case):
    rate, delay, tail, block, dtype, u = CASES[case]
    ju, tu = _uniforms(u)
    jstep, jinit = jax_make_chain(rate, delay, tail, block=block)
    step, init_state = make_audiofx_chain(rate, delay, tail, block=block)
    B = 4 if case != "flagship" else 2
    jst, st = jinit(B), init_state(B)
    echo_tail = st[0].clone()
    for x in _blocks(case, 4, B):
        jst, jout, jloud = jstep(jst, jnp.asarray(x), *ju)
        st, out, loud = step(st, torch.from_numpy(x), *tu)
        echo_tail, _ = echo_block(echo_tail, torch.from_numpy(x), tu[0],
                                  tu[1], delay=delay)
        assert torch.equal(st[0], echo_tail)
        _close(st, out, loud, jst, jout, jloud)


def test_state_carried_from_gstpu():
    """gstpu's state after 3 blocks, taken through np.asarray and
    `state_from_numpy`, steps on in the port as gstpu steps on."""
    rate, delay, tail, block, _, u = CASES["checkpoint"]
    ju, tu = _uniforms(u)
    jstep, jinit = jax_make_chain(rate, delay, tail, block=block)
    step, _ = make_audiofx_chain(rate, delay, tail, block=block)
    blocks = _blocks("checkpoint", 6)
    jst = jinit(4)
    for x in blocks[:3]:
        jst, _, _ = jstep(jst, jnp.asarray(x), *ju)
    st = chains.state_from_numpy(tuple(np.asarray(a) for a in jst),
                                 device="cpu")
    assert [(a.dtype, tuple(a.shape)) for a in st] == [
        (torch.float64, (4, tail)), (torch.float32, (4, 510)),
        (torch.float32, (4,))]
    for x in blocks[3:]:
        jst, jout, jloud = jstep(jst, jnp.asarray(x), *ju)
        st, out, loud = step(st, torch.from_numpy(x), *tu)
        _close(st, out, loud, jst, jout, jloud)


def test_state_numpy_round_trip():
    step, init_state = make_audiofx_chain(8000, 400, 400, block=2000)
    st, _, _ = step(init_state(3), torch.from_numpy(_blocks(
        "checkpoint", 1, B=3)[0]), 0.4, 0.3, 0.1)
    host = chains.state_to_numpy(st)
    assert [a.dtype for a in host] == [np.float64, np.float32, np.float32]
    back = chains.state_from_numpy(host, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(st, back))


def test_lanes_are_independent():
    """Lane 0 of a 4-stream run equals the stream run alone, bit for bit
    (a tree sum per lane; the CPU's FFT gives every lane the same bits
    here; cuFFT need not across batch counts)."""
    step, init_state = make_audiofx_chain(8000, 400, 400, block=2000)
    s4, s1 = init_state(4), init_state(1)
    for x in _blocks("checkpoint", 4):
        x = torch.from_numpy(x)
        s4, o4, l4 = step(s4, x, 0.4, 0.3, 0.1)
        s1, o1, l1 = step(s1, x[:1], 0.4, 0.3, 0.1)
        assert torch.equal(o4[:1], o1) and torch.equal(l4[:1], l1)


def test_init_state_on_the_default_device(monkeypatch):
    """init_state takes default_device(), never the CPU of its own
    accord ("meta" stands in for the card here)."""
    monkeypatch.setattr(device_mod, "_device", torch.device("meta"))
    _, init_state = make_audiofx_chain(8000, 400, 400, block=2000)
    assert {a.device.type for a in init_state(2)} == {"meta"}
