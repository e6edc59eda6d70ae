"""The port's echo (gstpu_torch.ops.echo) against gstpu's, on the CPU.

Torch rounds the product and the sum of `in + k * e` separately, so
the port equals the strict per-sample golden
`echo_reference(..., fma=False)` bit for bit; gstpu's XLA kernel
contracts to an FMA and equals the `fma=True` golden, so the two
packages agree to an ulp: 1e-12 relative in f64, 1 ulp in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpu.ops.echo import echo_block as jax_echo_block
from gstpu.ops.echo import echo_reference
from gstpu.ops.echo import make_state as jax_make_state
from gstpu_torch.ops.echo import echo_block, make_state
from torch_session import torch_test_limit  # noqa: F401

UNIFORMS = [(0.5, 0.0), (0.4, 0.6), (1.0, 1.0)]
SHAPES = [(100, 100, 64), (50, 200, 64), (500, 500, 1000), (7, 16, 5)]


def _run_port(x, delay, max_delay, intensity, feedback, block):
    tail = make_state((), max_delay, device="cpu")
    outs = []
    for off in range(0, x.shape[0], block):
        tail, o = echo_block(tail, torch.from_numpy(x[off:off + block]),
                             intensity, feedback, delay=delay)
        outs.append(o.numpy())
    return np.concatenate(outs)


def _run_jax(x, delay, max_delay, intensity, feedback, block):
    tail = jax_make_state((), max_delay)
    outs = []
    for off in range(0, x.shape[0], block):
        tail, o = jax_echo_block(tail, jnp.asarray(x[off:off + block]),
                                 jnp.float64(intensity),
                                 jnp.float64(feedback), delay=delay)
        outs.append(np.asarray(o))
    return np.concatenate(outs)


@pytest.mark.parametrize("uniforms", UNIFORMS, ids=str)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("delay,max_delay,block", SHAPES)
def test_echo_matches_strict_golden_and_gstpu(delay, max_delay, block,
                                              dtype, uniforms):
    x = np.random.default_rng(42).uniform(-1, 1, size=2000).astype(dtype)
    got = _run_port(x, delay, max_delay, *uniforms, block)
    assert got.dtype == dtype
    np.testing.assert_array_equal(
        got, echo_reference(x, delay, max_delay, *uniforms, fma=False))
    want = _run_jax(x, delay, max_delay, *uniforms, block)
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        assert int(ulps.max()) <= 1


def test_echo_lanes_are_independent():
    """A batch of streams: each lane equals that stream run alone."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(5, 3000))
    tail = make_state((5,), 700, device="cpu")
    tail1 = make_state((1,), 700, device="cpu")
    for off in range(0, 3000, 1000):
        tail, o = echo_block(tail, torch.from_numpy(x[:, off:off + 1000]),
                             0.4, 0.3, delay=600)
        tail1, o1 = echo_block(tail1,
                               torch.from_numpy(x[2:3, off:off + 1000]),
                               0.4, 0.3, delay=600)
        assert torch.equal(o[2], o1[0])
    assert torch.equal(tail[2], tail1[0])


def test_echo_rejects_a_delay_past_the_tail():
    with pytest.raises(ValueError, match="delay"):
        echo_block(make_state((), 10, device="cpu"),
                   torch.zeros(4, dtype=torch.float64), 0.5, 0.0, delay=11)


def test_make_state_is_f64_zeros_on_the_device_asked():
    st = make_state((3,), 17, device="cpu")
    assert st.dtype == torch.float64 and st.device.type == "cpu"
    assert tuple(st.shape) == (3, 17) and not st.any()
