"""Stream checkpoint/resume in the port (gstpu_torch.parallel.checkpoint)
on make_audiofx_chain: twins of tests/test_checkpoint.py, on the CPU.

The restore onto a mesh runs in a gloo world of 4 spawned ranks (one
process per device, as tests/test_torch_streams.py sets it up): each rank
restores the global checkpoint into its local state and steps on, and
every lane must equal the unsharded run's bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import gstpu_torch
from gstpu_torch.parallel.chains import make_audiofx_chain
from gstpu_torch.parallel.checkpoint import checkpoint, restore
from test_torch_streams import (WORLD_TIMEOUT_S, Gather, init_rank,
                                spawn_world)

PARAMS = tuple(float(np.float32(v)) for v in (0.4, 0.3, 0.1))
MESH_RANKS = 4
MESH_B = 8


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU, in one torch thread (test_torch_streams.py
    says why)."""
    gstpu_torch.init(device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blocks(n, B=4, block=2000, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((B, block)) * 0.1)
                             .astype(np.float32)) for _ in range(n)]


def _run(step, state, blocks, params=PARAMS):
    outs = []
    for x in blocks:
        state, out, _loud = step(state, x, *params)
        outs.append(out)
    return state, outs


def test_resume_bit_exact(tmp_path):
    rate, delay, tail, block = 8000, 400, 400, 2000
    B = 4
    step, mk = make_audiofx_chain(rate, delay, tail, block=block)
    blocks = _blocks(6, B, block)
    # uninterrupted reference
    _, ref_outs = _run(step, mk(B), blocks)
    # run 3 blocks, checkpoint, 'lose the chip', restore, continue
    step2, mk2 = make_audiofx_chain(rate, delay, tail, block=block)
    st, first = _run(step2, mk2(B), blocks[:3])
    checkpoint(str(tmp_path / "ck.npz"), st, step=3)
    step3, mk3 = make_audiofx_chain(rate, delay, tail, block=block)
    restored, n = restore(str(tmp_path / "ck.npz"), mk3(B))
    assert n == 3
    _, rest = _run(step3, restored, blocks[3:])
    for a, b in zip(ref_outs, first + rest):
        assert torch.equal(a, b)           # bit-exact resume


def test_restore_rejects_mismatch(tmp_path):
    step, mk = make_audiofx_chain(8000, 400, 400, block=2000)
    state, _, _ = step(mk(4), torch.zeros((4, 2000)), *PARAMS)
    checkpoint(str(tmp_path / "ck.npz"), state)
    _, mko = make_audiofx_chain(8000, 800, 800, block=2000)
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path / "ck.npz"), mko(4))


def _mesh_checkpoint(path: Path):
    """The global state after one block of 8 streams, with a 0-dim
    tensor and a host int beside it; and the next block's input."""
    step, mk = make_audiofx_chain(8000, 400, 400, block=2000)
    blocks = _blocks(2, MESH_B)
    state, _, _ = step(mk(MESH_B), blocks[0], *PARAMS)
    checkpoint(str(path), {"chain": state, "gain": torch.tensor(0.5),
                           "blocks": 1}, step=1)
    return step, state, blocks[1]


def _mesh_worker(rank: int, n: int, store_path: str, out_path: str) -> None:
    import torch.distributed as dist

    from gstpu_torch.parallel.streams import make_mesh, shard_slice
    init_rank(rank, n, store_path)
    try:
        gather = Gather()
        mesh = make_mesh(n, 1)
        step, mk = make_audiofx_chain(8000, 400, 400, block=2000)
        rows = shard_slice(MESH_B, mesh, ("stream",))
        like = {"chain": mk(rows.stop - rows.start),
                "gain": torch.tensor(0.0), "blocks": 0}
        restored, k = restore(str(Path(out_path).parent / "ck.npz"), like,
                              mesh=mesh)
        for i, leaf in enumerate(restored["chain"]):
            gather(f"leaf_{i}", (MESH_B,) + tuple(leaf.shape[1:]), rows,
                   leaf)
        x = _blocks(2, MESH_B)[1][rows]
        st, out, loud = step(restored["chain"], x, *PARAMS)
        gather("out", (MESH_B, 2000), rows, out)
        gather("loud", (MESH_B,), rows, loud)
        gather("gain_after", (MESH_B,), rows, st[2])
        gather.save(out_path, step=np.int64(k),
                    replicated=np.array([float(restored["gain"]),
                                         restored["blocks"],
                                         restored["gain"].ndim]))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_restore_onto_mesh(tmp_path):
    """Twin of tests/test_checkpoint.py::test_restore_onto_mesh: the
    global checkpoint restored onto a 4-rank stream mesh gives each rank
    its rows; 0-dim leaves and host ints are replicated; a step on every
    rank equals the unsharded step's rows bit for bit."""
    step, state, x = _mesh_checkpoint(tmp_path / "ck.npz")
    got = spawn_world(_mesh_worker, MESH_RANKS, tmp_path, WORLD_TIMEOUT_S)
    for i, leaf in enumerate(state):
        np.testing.assert_array_equal(got[f"leaf_{i}"], leaf.numpy())
    assert int(got["step"]) == 1
    assert got["replicated"].tolist() == [0.5, 1.0, 0.0]
    st, out, loud = step(state, x, *PARAMS)
    np.testing.assert_array_equal(got["out"], out.numpy())
    np.testing.assert_array_equal(got["loud"], loud.numpy())
    np.testing.assert_array_equal(got["gain_after"], st[2].numpy())


def test_restore_rejects_dtype_mismatch(tmp_path):
    """A checkpoint whose leaves differ in dtype must not restore
    silently (a cast would break bit-exactness)."""
    checkpoint(str(tmp_path / "ck.npz"), {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="dtype"):
        restore(str(tmp_path / "ck.npz"),
                {"a": torch.zeros(4, dtype=torch.float64)})
