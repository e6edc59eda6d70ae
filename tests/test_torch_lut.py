"""gstpu_torch.ops.lut against the JAX reference gstpu.ops.lut.

The .cube parser and identity LUT give the same arrays; the plain 3D
and 1D LUTs equal JAX's apply_lut_3d / apply_lut_1d bit for bit (u8
over every 24-bit colour, u16 on random pixels) and the Pallas kernel
in interpret mode within 1 LSB. The CUDA kernel is held against the
plain version on the card by chip_smoke.py. The kernel reads the table
in its corner-packed form (pack_lut_3d): apply_lut_3d_packed_ref, the
kernel's addressing in tensor code, must equal the plain version bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpu.ops import lut as jlut
from gstpu_torch.ops import lut as tlut

CUBE_3D = """TITLE "seeded"
# comment
LUT_3D_SIZE 2
DOMAIN_MIN 0.1 0.0 0.05
DOMAIN_MAX 0.9 1.0 1.0
1 1 1
0 1 1
1 0 1
0 0 1
1 1 0
0 1 0
1 0 0
0 0 0
"""
CUBE_1D = """LUT_1D_SIZE 3
0 0.1 0.2
0.5 0.4 0.7
1 0.9 0.8
"""
DOMAIN = (np.array([0.9, 1.1, 1.05], np.float32),
          np.array([0.02, -0.03, 0.01], np.float32))


def _table(n=33, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.random((n, n, n, 3), dtype=np.float32) * 1.2
            - 0.1).astype(np.float32)


def _jax_3d(pix, table, max_val):
    return np.asarray(jlut.apply_lut_3d(
        jnp.asarray(pix), jnp.asarray(table), jnp.asarray(DOMAIN[0]),
        jnp.asarray(DOMAIN[1]), max_val=max_val))


@pytest.mark.parametrize("text", [CUBE_3D, CUBE_1D])
def test_parse_cube_matches(text):
    a, b = jlut.parse_cube(text), tlut.parse_cube(text)
    assert a.is_3d == b.is_3d and a.size == b.size
    for f in ("domain_scale", "domain_offset", "table_1d", "table_3d"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bad", ["", "LUT_3D_SIZE 2\n0 0 0\n",
                                 "LUT_1D_SIZE 2\nDOMAIN_MIN 1 1 1\n"
                                 "DOMAIN_MAX 0 0 0\n0 0 0\n1 1 1\n",
                                 "LUT_1D_SIZE 1\nx y z\n"])
def test_parse_cube_errors_match(bad):
    with pytest.raises(jlut.CubeParseError):
        jlut.parse_cube(bad)
    with pytest.raises(tlut.CubeParseError):
        tlut.parse_cube(bad)


@pytest.mark.parametrize("size,three_d", [(2, True), (17, True),
                                          (5, False)])
def test_identity_lut_matches(size, three_d):
    a, b = jlut.identity_lut(size, three_d), tlut.identity_lut(size, three_d)
    np.testing.assert_array_equal(
        a.table_3d if three_d else a.table_1d,
        b.table_3d if three_d else b.table_1d)
    np.testing.assert_array_equal(a.domain_scale, b.domain_scale)


def test_plain_3d_matches_jax_on_every_colour():
    table = _table()
    p = np.arange(1 << 24, dtype=np.uint32)
    cube = np.stack([p & 255, (p >> 8) & 255, p >> 16, (p * 7 + 3) & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 4)
    tt = torch.from_numpy(table)
    for chunk in np.split(cube, 8):
        got = tlut.apply_lut_3d_ref(torch.from_numpy(chunk), tt, *DOMAIN)
        np.testing.assert_array_equal(got.numpy(), _jax_3d(chunk, table, 255))


@pytest.mark.parametrize("n", [2, 17, 33])
def test_plain_3d_matches_jax_u16(n):
    rng = np.random.default_rng(n)
    pix = rng.integers(0, 65536, (64, 96, 4), dtype=np.uint16)
    table = _table(n, seed=n)
    got = tlut.apply_lut_3d_ref(torch.from_numpy(pix),
                                torch.from_numpy(table), *DOMAIN,
                                max_val=65535)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), _jax_3d(pix, table, 65535))


def test_plain_3d_within_one_lsb_of_pallas_interpret():
    from gstpu.ops.lut_pallas import apply_lut_3d_pallas
    table = _table(17)
    rng = np.random.default_rng(21)
    pix = rng.integers(0, 256, (16, 128, 4), dtype=np.uint8)
    want = np.asarray(apply_lut_3d_pallas(
        jnp.asarray(pix), jnp.asarray(table), jnp.asarray(DOMAIN[0]),
        jnp.asarray(DOMAIN[1]), interpret=True))
    got = tlut.apply_lut_3d_ref(torch.from_numpy(pix),
                                torch.from_numpy(table), *DOMAIN).numpy()
    err = np.abs(got[..., :3].astype(int) - want[..., :3].astype(int))
    assert err.max() <= 1
    np.testing.assert_array_equal(got[..., 3], want[..., 3])


@pytest.mark.parametrize("dtype,max_val", [(np.uint8, 255),
                                           (np.uint16, 65535)])
def test_plain_1d_matches_jax(dtype, max_val):
    rng = np.random.default_rng(9)
    pix = rng.integers(0, max_val + 1, (40, 70, 4), dtype=dtype)
    table = rng.random((3, 17), dtype=np.float32)
    want = np.asarray(jlut.apply_lut_1d(
        jnp.asarray(pix), jnp.asarray(table), jnp.asarray(DOMAIN[0]),
        jnp.asarray(DOMAIN[1]), max_val=max_val))
    got = tlut.apply_lut_1d(torch.from_numpy(pix), torch.from_numpy(table),
                            *DOMAIN, max_val=max_val)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lut_from_numpy_carries_a_jax_cube_lut():
    src = jlut.parse_cube(CUBE_3D)
    lut = tlut.lut_from_numpy(src.table_3d, src.domain_scale,
                              src.domain_offset, "cpu")
    assert lut.is_3d and lut.table.dtype == torch.float32
    np.testing.assert_array_equal(lut.table.numpy(), src.table_3d)
    np.testing.assert_array_equal(lut.domain_scale, src.domain_scale)
    one_d = jlut.parse_cube(CUBE_1D)
    lut = tlut.lut_from_numpy(one_d.table_1d, one_d.domain_scale,
                              one_d.domain_offset, "cpu")
    assert not lut.is_3d and tuple(lut.table.shape) == (3, 3)
    with pytest.raises(ValueError, match="LUT table"):
        tlut.lut_from_numpy(np.zeros((2, 3, 3, 3), np.float32),
                            *DOMAIN, "cpu")


def test_wrapper_runs_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(6)
    pix = torch.from_numpy(rng.integers(0, 256, (8, 16, 4), dtype=np.uint8))
    table = torch.from_numpy(_table(5))
    launches = tlut.LUT_KERNEL.launches
    got = tlut.apply_lut_3d(pix, table, *DOMAIN)
    assert torch.equal(got, tlut.apply_lut_3d_ref(pix, table, *DOMAIN))
    assert tlut.LUT_KERNEL.launches == launches
    with pytest.raises(ValueError, match="no kernel"):
        tlut.apply_lut_3d(pix.to("meta"), table, *DOMAIN)


def _cube_chunks():
    p = np.arange(1 << 24, dtype=np.uint32)
    cube = np.stack([p & 255, (p >> 8) & 255, p >> 16, (p * 7 + 3) & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 4)
    return np.split(cube, 8)


def test_packed_addressing_matches_plain_on_every_colour():
    """The kernel's gather from the packed table, n = 33, over all 2^24
    colours: equal to the plain version, which equals JAX (above)."""
    lut = tlut.lut_from_numpy(_table(), *DOMAIN, "cpu")
    for chunk in _cube_chunks():
        pix = torch.from_numpy(chunk)
        assert torch.equal(
            tlut.apply_lut_3d_packed_ref(pix, lut.packed, *DOMAIN),
            tlut.apply_lut_3d_ref(pix, lut.table, *DOMAIN))


@pytest.mark.parametrize("dtype,max_val,n", [(np.uint8, 255, 2),
                                             (np.uint8, 255, 17),
                                             (np.uint16, 65535, 2),
                                             (np.uint16, 65535, 17),
                                             (np.uint16, 65535, 33)])
def test_packed_addressing_matches_plain_and_jax(dtype, max_val, n):
    rng = np.random.default_rng(100 + n)
    pix = rng.integers(0, max_val + 1, (48, 80, 4), dtype=dtype)
    pix[0, :4] = [[0, 0, 0, 7], [max_val] * 4, [0, max_val, 0, 1],
                  [max_val, 0, max_val, 2]]
    table = _table(n, seed=n)
    lut = tlut.lut_from_numpy(table, *DOMAIN, "cpu")
    got = tlut.apply_lut_3d_packed_ref(torch.from_numpy(pix), lut.packed,
                                       *DOMAIN, max_val=max_val)
    want = tlut.apply_lut_3d_ref(torch.from_numpy(pix), lut.table, *DOMAIN,
                                 max_val=max_val)
    assert got.dtype == want.dtype and torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), _jax_3d(pix, table, max_val))


@pytest.mark.parametrize("n", [2, 17, 33])
def test_lut_from_numpy_packs_the_table(n):
    """(N, N, N, 24) f32, aligned; entry [z, y, x] holds channel c's
    corner (dx, dy, dz) at c * 8 + dz * 4 + dy * 2 + dx, each upper index
    clamped at N - 1."""
    table = _table(n, seed=n)
    lut = tlut.lut_from_numpy(table, *DOMAIN, "cpu")
    packed = lut.packed
    assert packed.shape == (n, n, n, 24) and packed.dtype == torch.float32
    assert packed.is_contiguous() and packed.data_ptr() % 32 == 0
    p = packed.numpy().reshape(n, n, n, 3, 8)
    up = np.minimum(np.arange(n) + 1, n - 1)
    for z, y, x in np.ndindex(n, n, n):
        if n > 2 and (x, y) != (z, z) and (x, y) != (n - 1, 0):
            continue  # a diagonal and an edge of the larger tables
        for d in range(8):
            dx, dy, dz = d & 1, (d >> 1) & 1, d >> 2
            np.testing.assert_array_equal(
                p[z, y, x, :, d],
                table[up[z] if dz else z, up[y] if dy else y,
                      up[x] if dx else x])
    np.testing.assert_array_equal(p[-1, -1, -1],
                                  np.repeat(table[-1, -1, -1, :, None], 8, 1))
    assert torch.equal(tlut.pack_lut_3d(lut.table), packed)


def test_device_lut_packs_once_per_device():
    lut = tlut.lut_from_numpy(_table(5), *DOMAIN, "cpu")
    assert lut.to("cpu") is lut
    moved = lut.to("meta")
    assert moved.table.device.type == moved.packed.device.type == "meta"
    assert tuple(moved.packed.shape) == (5, 5, 5, 24)
    one_d = tlut.lut_from_numpy(np.zeros((3, 4), np.float32), *DOMAIN, "cpu")
    assert one_d.packed is None and one_d.to("meta").packed is None
