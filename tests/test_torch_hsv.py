"""gstpu_torch.ops.hsv against the JAX reference gstpu.ops.hsv.

The plain version must equal JAX's hsv_filter_frame bit for bit: over
every 24-bit colour, and on small frames for every channel layout. On
a CPU tensor the wrapper runs the plain version; the CUDA kernel it
launches on the card is held against the plain version by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpu.ops.hsv import hsv_filter_frame as jax_hsv_filter_frame
from gstpu_torch.elements.video.hsv import _LAYOUTS
from gstpu_torch.ops.hsv import (HSV_KERNEL, hsv_filter_frame,
                                 hsv_filter_frame_ref)

PARAMS = [(12.0, 1.1, 0.0, 0.9, 0.02),
          (-47.5, 0.8, 0.05, 1.3, -0.1),
          (200.0, 1.5, -0.2, 0.7, 0.1)]


def _jax(frame: np.ndarray, rgb_idx, params) -> np.ndarray:
    return np.asarray(jax_hsv_filter_frame(
        jnp.asarray(frame), tuple(rgb_idx),
        *[jnp.float32(p) for p in params]))


def test_plain_matches_jax_on_every_colour():
    """All 2^24 colours, alpha carrying a byte pattern, bitwise."""
    p = np.arange(1 << 24, dtype=np.uint32)
    cube = np.stack([p & 255, (p >> 8) & 255, p >> 16, (p * 7 + 3) & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 4)
    for chunk in np.split(cube, 8):
        want = _jax(chunk, (0, 1, 2), PARAMS[1])
        got = hsv_filter_frame_ref(torch.from_numpy(chunk), (0, 1, 2),
                                   *PARAMS[1]).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("fmt", sorted(_LAYOUTS))
def test_plain_matches_jax_per_layout(fmt, params):
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (37, 53, len(fmt)), dtype=np.uint8)
    rgb_idx, _ = _LAYOUTS[fmt]
    want = _jax(frame, rgb_idx, params)
    got = hsv_filter_frame_ref(torch.from_numpy(frame), rgb_idx, *params)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_matches_pallas_interpret():
    """The Pallas tile kernels in interpret mode, at the shape the JAX
    package's own test uses."""
    from gstpu.ops.hsv_pallas import hsv_filter_frame_pallas
    rng = np.random.default_rng(21)
    rgb = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    args = (40.0, 1.2, -0.1, 0.9, 0.05)
    want = np.asarray(hsv_filter_frame_pallas(rgb, *args, interpret=True))
    got = hsv_filter_frame_ref(torch.from_numpy(rgb), (0, 1, 2), *args)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(4)
    frame = torch.from_numpy(rng.integers(0, 256, (8, 16, 4),
                                          dtype=np.uint8))
    before = frame.clone()
    launches = HSV_KERNEL.launches
    got = hsv_filter_frame(frame, (2, 1, 0), *PARAMS[0])
    assert torch.equal(got, hsv_filter_frame_ref(frame, (2, 1, 0),
                                                 *PARAMS[0]))
    assert torch.equal(frame, before)        # out of place
    assert HSV_KERNEL.launches == launches   # no kernel on the CPU


def test_wrapper_refuses_other_devices_and_cpu_out():
    meta = torch.empty((4, 4, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        hsv_filter_frame(meta, (0, 1, 2), *PARAMS[0])
    cpu = torch.zeros((4, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        hsv_filter_frame(cpu, (0, 1, 2), *PARAMS[0], out=cpu)
