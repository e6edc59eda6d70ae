"""The port's mesh code (gstpu_torch.parallel.streams) against gstpu's,
on the CPU: twins of tests/test_parallel.py and tests/test_seq_sharding.py
on the same meshes and inputs.

gstpu runs one controller over 8 virtual CPU devices; the port runs one
process per device. So the port's side runs once per file in a gloo
world of 8 spawned ranks (`_worker`), which builds the meshes (4, 2),
(2, 4) and (8, 1), runs every case on its shard and gathers the global
results to rank 0; the test functions hold them against the port's
unsharded ops, the per-sample goldens and gstpu's sharded steps, run
here in the pytest process. A rank never imports jax: the JAX side is
imported inside the test functions only.

Bounds: the echo paths are bit for bit with the port's unsharded
`echo_block` and with `echo_reference(..., fma=False)`, and within an ulp
of gstpu's (XLA contracts `x + k * e` to an FMA; `_within_an_ulp`). The
K-weighting is within gstpu's own 1e-8 of the unsharded run and within
KWEIGHT_VS_GSTPU of gstpu's sharded output. The exact chain over 8
stream ranks is bit for bit per lane with the unsharded step.
"""

from __future__ import annotations

import datetime
import multiprocessing.connection
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import gstpu_torch
from gstpu_torch.ops.echo import echo_block, make_state
from torch_session import torch_test_limit  # noqa: F401

WORLD = 8
# gstpu's meshes (tests/test_parallel.py, tests/test_seq_sharding.py),
# each built once in the world; the seq-sharded FIR echo runs on gstpu's
# (2, 4) and on (8, 1), the one-member ring
MESHES = [(4, 2), (2, 4), (8, 1)]
FIR_MESHES = [(2, 4), (8, 1)]
# the gloo collectives' timeout, and the whole world's (a world takes
# ~22 s inside the suite, ~80 s when two suites share the cores), which
# ends inside a test's limit (torch_session.TEST_LIMIT_S)
GLOO_TIMEOUT_S = 180
WORLD_TIMEOUT_S = 240
# the port's seq-sharded K-weighting against gstpu's on the same inputs,
# Queue C's bound for the block form (its high-pass stage amplifies
# rounding differences): measured at most 2.49e-12 on outputs of peak
# 7.6 and 1.31e-12 on the carried state (both packages' sharded runs sit
# 3.7e-10 from their unsharded ones)
KWEIGHT_VS_GSTPU = 2e-11


# ---------------------------------------------------------------------------
# inputs, made from seeds as gstpu's tests make them
# ---------------------------------------------------------------------------

def stream_echo_inputs():
    """tests/test_parallel.py::test_stream_sharded_echo_matches_golden."""
    B, N, D, S = 16, 256, 100, 100
    x = np.random.default_rng(3).uniform(-1, 1, (B, 4 * N))
    return x, N, D, S, 0.5, 0.25


def fir_echo_inputs(shape):
    """tests/test_parallel.py::test_seq_sharded_fir_matches_unsharded
    (mesh (2, 4), 4 streams); on mesh (8, 1) 8 streams, one a rank."""
    B, D, seg = 2 * shape[0], 64, 128
    x = np.random.default_rng(5).uniform(-1, 1, (B, 2 * 4 * seg))
    return x, D, seg, 0.7


def kweight_inputs():
    """tests/test_seq_sharding.py::test_seq_sharded_kweight_matches_
    unsharded: 3 blocks carried."""
    seg, B = 1920, 4
    rng = np.random.default_rng(0)
    return [rng.standard_normal((B, 4 * seg)) for _ in range(3)], seg


def front_inputs():
    """tests/test_seq_sharding.py::test_seq_sharded_chain_front_
    matches_unsharded."""
    seg, delay, B = 1920, 960, 4
    x = np.random.default_rng(1).uniform(-0.3, 0.3, (B, 4 * seg))
    return x, seg, delay, 0.4


def exact_chain_inputs(n_prime, n_step):
    """tests/test_parallel.py::test_exact_chain_sharded_equals_unsharded."""
    B = 8
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.3, 0.3, (B, n_prime))
    x1 = rng.uniform(-0.3, 0.3, (B, n_step))
    return x0, x1, 0.4, 0.3


def exact_chain():
    from gstpu_torch.parallel.chains import make_audiofx_exact_chain
    return make_audiofx_exact_chain(channels=1, echo_delay=2_400,
                                    max_delay=2_400)


# ---------------------------------------------------------------------------
# the spawned world
# ---------------------------------------------------------------------------

def _rank_main(worker, rank: int, n: int, store: str, out: str) -> None:
    """A spawned rank: run the worker, leaving its traceback beside the
    store if it raises."""
    try:
        worker(rank, n, store, out)
    except BaseException:
        import traceback
        Path(store).with_name(f"rank{rank}.err").write_text(
            traceback.format_exc())
        raise


def spawn_world(worker, n: int, tmp_path: Path, timeout_s: float) -> dict:
    """Run worker(rank, n, store_path, out_path) in n spawned ranks and
    return the arrays rank 0 saved to out_path. Fails the test, with the
    first rank's traceback, if a rank fails, and kills every rank that
    is left when one fails or the world outlives timeout_s."""
    import multiprocessing as mp
    store, out = tmp_path / "store", tmp_path / "out.npz"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(worker, r, n, str(store), str(out)))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs) \
                and not any(p.exitcode for p in procs):
            if time.monotonic() > deadline:
                pytest.fail(f"the {n}-rank world did not end within "
                            f"{timeout_s} s")
            mp.connection.wait([p.sentinel for p in procs], timeout=1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    errors = sorted(tmp_path.glob("rank*.err"))
    if errors or any(p.exitcode for p in procs):
        pytest.fail(f"ranks exited with {[p.exitcode for p in procs]}"
                    + (f"; {errors[0].name}:\n{errors[0].read_text()}"
                       if errors else ""))
    with np.load(out) as z:
        return dict(z)


def init_rank(rank: int, n: int, store_path: str) -> None:
    """Join the gloo world as `rank` on the port's CPU device."""
    import torch.distributed as dist
    assert "jax" not in sys.modules
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, n), rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    gstpu_torch.init(device="cpu")


class Gather:
    """Assembles global arrays on rank 0 from each rank's (index,
    local) parts; parts that several ranks hold must agree bitwise."""

    def __init__(self):
        import torch.distributed as dist
        self.dist = dist
        self.out: dict[str, np.ndarray] = {}

    def __call__(self, name: str, shape, index, local) -> None:
        dist = self.dist
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, (index, np.asarray(local)))
        if dist.get_rank() != 0:
            return
        full = np.full(shape, np.nan)
        seen = np.zeros(shape, bool)
        for idx, a in parts:
            if seen[idx].any():
                assert np.array_equal(full[idx], a), f"{name}: replicas"
            full[idx], seen[idx] = a, True
        assert seen.all(), name
        self.out[name] = full

    def save(self, path: str, **extra) -> None:
        if self.dist.get_rank() == 0:
            np.savez(path, **self.out, **extra)


def _worker(rank: int, n: int, store_path: str, out_path: str) -> None:
    import torch.distributed as dist

    from gstpu_torch.core import device as device_mod
    from gstpu_torch.parallel import streams
    init_rank(rank, n, store_path)
    try:
        gather = Gather()
        T = torch.from_numpy
        rows_of = streams.shard_rows
        meshes = {s: streams.make_mesh(*s) for s in MESHES}

        # stream-sharded echo, mesh (4, 2)
        mesh = meshes[(4, 2)]
        x, N, D, S, inten, fb = stream_echo_inputs()
        step, dims = streams.make_stream_sharded_echo(mesh, delay=D)
        rows = streams.shard_slice(x.shape[0], mesh, dims)
        tail = make_state((rows.stop - rows.start,), S, device="cpu")
        outs = []
        for off in range(0, x.shape[1], N):
            tail, o = step(tail, rows_of(T(x[:, off:off + N]), mesh, dims),
                           inten, fb)
            outs.append(o)
        gather("stream_echo", x.shape, rows, torch.cat(outs, dim=1))

        # seq-sharded FIR echo, meshes (2, 4) and (8, 1)
        for shape in FIR_MESHES:
            x, D, seg, inten = fir_echo_inputs(shape)
            mesh = meshes[shape]
            n_seq = shape[1]
            fir = streams.make_seq_sharded_fir_echo(mesh, delay=D,
                                                    seg_len=seg)
            rows = streams.shard_slice(x.shape[0], mesh, ("stream",))
            tail = torch.zeros((rows.stop - rows.start, D),
                               dtype=torch.float64)
            cols = streams.shard_slice(n_seq * seg, mesh, ("seq",))
            outs, where = [], []
            for off in range(0, x.shape[1], n_seq * seg):
                blk = rows_of(T(x[:, off:off + n_seq * seg]), mesh,
                              ("stream",))
                tail, o = fir(tail, rows_of(blk, mesh, ("seq",), dim=1),
                              inten)
                outs.append(o)
                where.append(np.arange(off + cols.start, off + cols.stop))
            gather(f"fir_echo_{shape}", x.shape,
                   (rows, np.concatenate(where)), torch.cat(outs, dim=1))
            gather(f"fir_carry_{shape}", (x.shape[0], D), rows, tail)

        # StreamBatch over mesh (8, 1)
        mesh = meshes[(8, 1)]
        step, dims = streams.make_stream_sharded_echo(mesh, delay=10)

        def chain(state, blocks):
            return step(state, blocks, 0.5, 0.0)

        sb = streams.StreamBatch(chain, make_state((1,), 10, device="cpu"))
        blocks = rows_of(torch.ones((8, 32), dtype=torch.float64), mesh,
                         dims)
        rows = streams.shard_slice(8, mesh, dims)
        gather("batch_out1", (8, 32), rows, sb.process(blocks))
        gather("batch_out2", (8, 32), rows, sb.process(blocks))

        # seq-sharded K-weighting, mesh (2, 4), 3 blocks carried
        mesh = meshes[(2, 4)]
        blocks, seg = kweight_inputs()
        kw = streams.make_seq_sharded_kweight(mesh, seg_len=seg)
        rows = streams.shard_slice(blocks[0].shape[0], mesh, ("stream",))
        cols = streams.shard_slice(4 * seg, mesh, ("seq",))
        z = torch.zeros((rows.stop - rows.start, 2, 2), dtype=torch.float64)
        for k, xb in enumerate(blocks):
            xl = rows_of(rows_of(T(xb), mesh, ("stream",)), mesh, ("seq",),
                         dim=1)
            z, y = kw(z, xl)
            gather(f"kweight_y{k}", xb.shape, (rows, cols), y)
        gather("kweight_z", (xb.shape[0], 2, 2), rows, z)

        # the chain front: FIR echo, then K-weighting, mesh (2, 4)
        x, seg, delay, inten = front_inputs()
        fir = streams.make_seq_sharded_fir_echo(mesh, delay=delay,
                                                seg_len=seg)
        kw = streams.make_seq_sharded_kweight(mesh, seg_len=seg)
        xl = rows_of(rows_of(T(x), mesh, ("stream",)), mesh, ("seq",),
                     dim=1)
        tail = torch.zeros((rows.stop - rows.start, delay),
                           dtype=torch.float64)
        _, mid = fir(tail, xl, inten)
        _, y = kw(torch.zeros((rows.stop - rows.start, 2, 2),
                              dtype=torch.float64), mid)
        gather("front_mid", x.shape, (rows, cols), mid)
        gather("front_y", x.shape, (rows, cols), y)

        # the exact chain over 8 stream ranks, mesh (8, 1)
        mesh = meshes[(8, 1)]
        prime, cstep, init, n_prime, n_step = exact_chain()
        x0, x1, inten, fb = exact_chain_inputs(n_prime, n_step)
        dims = ("stream", "seq")
        rows = streams.shard_slice(8, mesh, dims)
        st = init(rows.stop - rows.start, device="cpu")
        st, o0 = prime(st, rows_of(T(x0), mesh, dims), inten, fb)
        st, o1, m1 = cstep(st, rows_of(T(x1), mesh, dims), inten, fb)
        gather("exact_o0", (8, n_step), rows, o0)
        gather("exact_o1", (8, n_step), rows, o1)
        for k in ("momentary", "shortterm"):
            gather(f"exact_{k}", (8,), rows, m1[k])
        if rank == 0:
            # the unsharded reference, in a rank's one thread
            st = init(8, device="cpu")
            st, o0 = prime(st, T(x0), inten, fb)
            st, o1, m1 = cstep(st, T(x1), inten, fb)
            gather.out.update(
                unsharded_o0=o0.numpy(), unsharded_o1=o1.numpy(),
                **{f"unsharded_{k}": m1[k].numpy()
                   for k in ("momentary", "shortterm")})

        # make_mesh refuses a group of the wrong size, and a device type
        # whose backend is not the group's
        refused = []
        for call in (lambda: streams.make_mesh(4, 1),
                     lambda: streams.make_mesh(3, 3)):
            try:
                call()
            except ValueError as e:
                refused.append("ranks" in str(e))
        device_mod._device = torch.device("cuda")
        try:
            streams.make_mesh(8, 1)
        except ValueError as e:
            refused.append("nccl" in str(e))
        finally:
            device_mod._device = torch.device("cpu")
        gather.save(out_path, refused=np.array(refused))
        dist.barrier()
        assert "jax" not in sys.modules
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(_worker, WORLD, tmp_path_factory.mktemp("streams"),
                       WORLD_TIMEOUT_S)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU."""
    gstpu_torch.init(device="cpu")


def _within_an_ulp(got, want, x) -> bool:
    """|got - want| within one ulp of the larger of the input sample and
    the output: what rounding `x + k * e` once (an FMA) instead of twice
    can move (a relative bound fails where x and k * e cancel)."""
    got, want = np.asarray(got), np.asarray(want)
    return bool(np.all(np.abs(got - want) <= np.spacing(
        np.maximum(np.abs(x), np.abs(got)))))


def _jax_mesh(n_stream, n_seq):
    import jax
    from gstpu.parallel.streams import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(n_stream, n_seq)


# ---------------------------------------------------------------------------
# tests/test_parallel.py twins
# ---------------------------------------------------------------------------

def test_stream_sharded_echo_matches_golden(world):
    import jax
    import jax.numpy as jnp
    from gstpu.ops.echo import echo_reference
    from gstpu.ops.echo import make_state as jax_make_state
    from gstpu.parallel.streams import make_stream_sharded_echo
    x, N, D, S, inten, fb = stream_echo_inputs()
    got = world["stream_echo"]
    tail = make_state((x.shape[0],), S, device="cpu")
    outs = []
    for off in range(0, x.shape[1], N):
        tail, o = echo_block(tail, torch.from_numpy(x[:, off:off + N]),
                             inten, fb, delay=D)
        outs.append(o.numpy())
    np.testing.assert_array_equal(got, np.concatenate(outs, axis=1))
    for b in range(x.shape[0]):
        np.testing.assert_array_equal(
            got[b], echo_reference(x[b], D, S, inten, fb, fma=False))
    # gstpu's sharded step on the same mesh
    step, spec = make_stream_sharded_echo(_jax_mesh(4, 2), delay=D)
    jtail = jax.device_put(jax_make_state((x.shape[0],), S), spec)
    jouts = []
    for off in range(0, x.shape[1], N):
        jtail, o = step(jtail, jax.device_put(jnp.asarray(x[:, off:off + N]),
                                              spec),
                        jnp.float64(inten), jnp.float64(fb))
        jouts.append(np.asarray(o))
    assert _within_an_ulp(got, np.concatenate(jouts, axis=1), x)


@pytest.mark.parametrize("shape", FIR_MESHES, ids=str)
def test_seq_sharded_fir_matches_unsharded(world, shape):
    """(2, 4) is gstpu's mesh; (8, 1) holds the one-member ring, whose
    halo is the shard's own."""
    import jax.numpy as jnp
    from gstpu.ops.echo import echo_reference
    from gstpu.parallel.streams import make_seq_sharded_fir_echo
    x, D, seg, inten = fir_echo_inputs(shape)
    got = world[f"fir_echo_{shape}"]
    tail = make_state((x.shape[0],), D, device="cpu")
    outs = []
    N = 4 * seg
    for off in range(0, x.shape[1], N):
        tail, o = echo_block(tail, torch.from_numpy(x[:, off:off + N]),
                             inten, 0.0, delay=D)
        outs.append(o.numpy())
    np.testing.assert_array_equal(got, np.concatenate(outs, axis=1))
    np.testing.assert_array_equal(world[f"fir_carry_{shape}"],
                                  tail.numpy())
    for b in range(x.shape[0]):
        np.testing.assert_array_equal(
            got[b], echo_reference(x[b], D, D, inten, 0.0, fma=False))
    step = make_seq_sharded_fir_echo(_jax_mesh(*shape), delay=D,
                                     seg_len=seg)
    n_seq = shape[1]
    jtail = jnp.zeros((x.shape[0], D))
    jouts = []
    for off in range(0, x.shape[1], n_seq * seg):
        jtail, o = step(jtail, jnp.asarray(x[:, off:off + n_seq * seg]),
                        jnp.float64(inten))
        jouts.append(np.asarray(o))
    assert _within_an_ulp(got, np.concatenate(jouts, axis=1), x)


def test_stream_batch_wrapper(world):
    out, out2 = world["batch_out1"], world["batch_out2"]
    assert out.shape == (8, 32)
    assert not np.array_equal(out, out2)  # state carried
    # the unsharded batch, block for block
    from gstpu_torch.parallel.streams import StreamBatch
    sb = StreamBatch(lambda st, b: echo_block(st, b, 0.5, 0.0, delay=10),
                     make_state((8,), 10, device="cpu"))
    ones = torch.ones((8, 32), dtype=torch.float64)
    np.testing.assert_array_equal(out, sb.process(ones).numpy())
    np.testing.assert_array_equal(out2, sb.process(ones).numpy())


def test_exact_chain_sharded_equals_unsharded(world):
    """Every lane over 8 stream ranks bit for bit with the unsharded
    step, run on 8 streams in rank 0 (gstpu's twin holds 1e-12)."""
    for k in ("o0", "o1", "momentary", "shortterm"):
        assert world[f"exact_{k}"].shape[0] == 8
        np.testing.assert_array_equal(world[f"exact_{k}"],
                                      world[f"unsharded_{k}"])


def test_make_mesh_refuses(world):
    """A group of the wrong size (twice) and a cuda device on a gloo
    group, each with its reason."""
    assert world["refused"].tolist() == [True, True, True]


def test_make_mesh_needs_a_process_group():
    from gstpu_torch.parallel.streams import make_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1)


# ---------------------------------------------------------------------------
# tests/test_seq_sharding.py twins
# ---------------------------------------------------------------------------

def test_seq_sharded_kweight_matches_unsharded(world):
    import jax.numpy as jnp
    from gstpu.parallel.streams import make_seq_sharded_kweight
    from gstpu_torch.parallel.streams import kweight_unsharded
    blocks, seg = kweight_inputs()
    gold = kweight_unsharded()
    jkw = make_seq_sharded_kweight(_jax_mesh(2, 4), seg_len=seg)
    z = torch.zeros((4, 2, 2), dtype=torch.float64)
    jz = jnp.zeros((4, 2, 2))
    for k, xb in enumerate(blocks):
        z, y = gold(z, torch.from_numpy(xb))
        jz, jy = jkw(jz, jnp.asarray(xb))
        got = world[f"kweight_y{k}"]
        assert np.abs(got - y.numpy()).max() < 1e-8, k
        assert np.abs(got - np.asarray(jy)).max() < KWEIGHT_VS_GSTPU, k
    assert np.abs(world["kweight_z"] - z.numpy()).max() < 1e-8
    assert np.abs(world["kweight_z"] - np.asarray(jz)).max() \
        < KWEIGHT_VS_GSTPU


def test_seq_sharded_chain_front_matches_unsharded(world):
    """echo FIR -> K-weighting, both seq-sharded, against the unsharded
    ops (the FIR bit for bit) and against gstpu's sharded front."""
    import jax.numpy as jnp
    from gstpu.parallel.streams import (make_seq_sharded_fir_echo,
                                        make_seq_sharded_kweight)
    from gstpu_torch.parallel.streams import kweight_unsharded
    x, seg, delay, inten = front_inputs()
    tail = make_state((x.shape[0],), delay, device="cpu")
    _, mid = echo_block(tail, torch.from_numpy(x), inten, 0.0, delay=delay)
    np.testing.assert_array_equal(world["front_mid"], mid.numpy())
    _, y = kweight_unsharded()(torch.zeros((4, 2, 2), dtype=torch.float64),
                               mid)
    assert np.abs(world["front_y"] - y.numpy()).max() < 1e-8
    mesh = _jax_mesh(2, 4)
    fir = make_seq_sharded_fir_echo(mesh, delay=delay, seg_len=seg)
    kw = make_seq_sharded_kweight(mesh, seg_len=seg)
    _, jmid = fir(jnp.zeros((4, delay)), jnp.asarray(x), jnp.float64(inten))
    _, jy = kw(jnp.zeros((4, 2, 2)), jmid)
    assert _within_an_ulp(world["front_mid"], jmid, x)
    assert np.abs(world["front_y"] - np.asarray(jy)).max() \
        < KWEIGHT_VS_GSTPU
