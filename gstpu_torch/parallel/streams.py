"""Batched multi-stream device processing over a device mesh.

The port of gstpu/parallel/streams.py. Many independent media streams
are stacked into (B, N) blocks; the batch axis shards over devices
(data parallel over streams), and within one long stream the time axis
can shard as sequence blocks whose FIR/IIR state crosses shard
boundaries.

gstpu runs one controller over a jax `Mesh` (`jit` + `shard_map`). The
port runs one process per device: `torch.distributed` with a
`DeviceMesh` of dims ("stream", "seq"), each rank holding its local
shard. Where gstpu's `shard_map` body runs on every shard, the port's
step runs on this rank's shard, and gstpu's collectives become
torch.distributed ones on the mesh's "seq" group: `ppermute` a ring of
`batch_isend_irecv`, `all_gather` `all_gather_into_tensor`, the masked
`psum` of the carry a broadcast from the group's last rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gstpu_torch.core.device import default_device
from gstpu_torch.ops.biquad import (biquad_coeffs_highpass,
                                    biquad_coeffs_shelving,
                                    block_biquad_tables, make_block_biquad)
from gstpu_torch.ops.echo import echo_block

# the backend that carries each device type's collectives
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_stream: int, n_seq: int = 1):
    """2D device mesh: stream (data-parallel) x seq (sequence-parallel),
    over the default process group, on default_device()'s type.

    The group must hold exactly n_stream * n_seq ranks, and its backend
    must be the one for the device type (NCCL for cuda, gloo for cpu);
    otherwise this raises."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default "
                           "process group (torch.distributed."
                           "init_process_group)")
    n = n_stream * n_seq
    if dist.get_world_size() != n:
        raise ValueError(f"make_mesh({n_stream}, {n_seq}) needs {n} "
                         f"ranks, the group has {dist.get_world_size()}")
    dev = default_device().type
    backend = dist.get_backend()
    if BACKENDS.get(dev) != backend:
        raise ValueError(f"make_mesh: a {dev} device needs the "
                         f"{BACKENDS.get(dev)} backend, the group runs "
                         f"{backend}")
    return init_device_mesh(dev, (n_stream, n_seq),
                            mesh_dim_names=("stream", "seq"))


def shard_slice(n: int, mesh, dims) -> slice:
    """This rank's part of an axis of n entries sharded over the mesh
    dims `dims` (flattened in order, as a PartitionSpec entry
    ("stream", "seq") flattens them)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx, parts = 0, 1
    for d in dims:
        size = mesh.size(mesh.mesh_dim_names.index(d))
        idx, parts = idx * size + coord[d], parts * size
    if n % parts:
        raise ValueError(f"an axis of {n} does not split into {parts} "
                         f"shards over {dims}")
    k = n // parts
    return slice(idx * k, (idx + 1) * k)


def shard_rows(x: torch.Tensor, mesh, dims, dim: int = 0) -> torch.Tensor:
    """This rank's rows of the global tensor x along `dim`, sharded over
    the mesh dims `dims` (a view of x)."""
    s = shard_slice(x.shape[dim], mesh, dims)
    return x.narrow(dim, s.start, s.stop - s.start)


def _seq_group(mesh):
    """(group, this rank's index in it, the group's global ranks)."""
    group = mesh.get_group("seq")
    return (group, mesh.get_local_rank("seq"),
            dist.get_process_group_ranks(group))


# ---------------------------------------------------------------------------
# stream-sharded echo step (the flagship round-1 device pipeline)
# ---------------------------------------------------------------------------

def make_stream_sharded_echo(mesh, delay: int):
    """Echo step over (B, N) blocks with B sharded over the flattened
    ("stream", "seq") mesh dims: each rank runs echo_block on its rows
    (`shard_rows(x, mesh, dims)`). No collectives: streams are
    independent. Returns (step, dims)."""
    dims = ("stream", "seq")

    def step(tail, x, intensity, feedback):
        return echo_block(tail, x, intensity, feedback, delay=delay)

    return step, dims


# ---------------------------------------------------------------------------
# sequence-sharded FIR echo (feedback=0): halo exchange over the seq ring
# ---------------------------------------------------------------------------

def make_seq_sharded_fir_echo(mesh, delay: int, seg_len: int):
    """Echo without feedback is a sparse FIR: out = x + i*delay(x).
    A long block (B, n_seq*seg_len) is sharded over the "seq" dim (rows
    over "stream"); each shard needs the last `delay` input samples of
    its left neighbour, passed around the seq ring. Requires
    delay <= seg_len.

    step(tail (B_local, delay), x (B_local, seg_len), intensity) ->
        (carry (B_local, delay), out (B_local, seg_len))
    where tail, the stream carry (the end of the previous block), is
    the same on every rank of a seq group, and so is the new carry.
    """
    if not delay <= seg_len:
        raise ValueError(f"delay {delay} > seg_len {seg_len}")
    group, idx, ranks = _seq_group(mesh)
    n_seq = len(ranks)

    def step(tail, x, intensity):
        halo_src = torch.cat([tail, x], dim=-1)[..., -delay:].contiguous()
        # pass each shard's trailing samples to its right neighbour; a
        # one-member ring is its own neighbour
        if n_seq == 1:
            left_halo = halo_src
        else:
            left_halo = torch.empty_like(halo_src)
            ops = [dist.P2POp(dist.isend, halo_src,
                              ranks[(idx + 1) % n_seq], group),
                   dist.P2POp(dist.irecv, left_halo,
                              ranks[(idx - 1) % n_seq], group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        # shard 0 uses the stream carry; the others the neighbour halo
        prev = tail if idx == 0 else left_halo
        delayed = torch.cat([prev, x], dim=-1)[..., :seg_len]
        out = x + intensity * delayed
        # the new stream carry is the LAST shard's halo source
        carry = halo_src.clone()
        dist.broadcast(carry, src=ranks[-1], group=group)
        return carry, out

    return step


class StreamBatch:
    """Host-side handle for B device-resident stream states + a chain
    step. The scheduler's batching window fills (B, N) blocks, this
    flushes them to the device in one dispatch."""

    def __init__(self, step, state):
        self.step = step
        self.state = state

    def process(self, blocks):
        """blocks: (B, N) tensor -> (B, N) processed."""
        self.state, out = self.step(self.state, blocks)
        return out


# ---------------------------------------------------------------------------
# sequence-sharded K-weighting (IIR with cross-shard state handoff)
# ---------------------------------------------------------------------------

def make_seq_sharded_kweight(mesh, rate: int = 192_000,
                             seg_len: int = 19_200):
    """The BS.1770 K-weighting biquad cascade sequence-sharded over the
    "seq" mesh dim.

    An IIR's shard boundary state depends on ALL earlier samples, so
    each shard filters its segment from a ZERO state (y0, s0) and the
    true incoming state is rebuilt from an all-gather of every shard's
    zero-state end state: s_in(j) = M^seg s_in(j-1) + s0(j-1). The
    output is then corrected linearly: y += Tobs @ s_in with
    Tobs[n] = (A^n)[0, :] (state-space superposition, exact up to f64
    rounding). Both tables are built in f64 numpy here, as gstpu builds
    them. The 2x2 products are written out elementwise, so no matmul
    picks a batch-dependent order.

    step(z (B_local, 2, 2), x (B_local, seg_len)) -> (z, y) with z (both
    cascade stages' DF2T states) the same on every rank of a seq group.
    """
    group, idx, ranks = _seq_group(mesh)
    n_seq = len(ranks)
    coeffs = (biquad_coeffs_shelving(rate), biquad_coeffs_highpass(rate))
    bqs = [make_block_biquad(b, a, L=64) for b, a in coeffs]

    # per stage: M^seg (2x2) and the per-sample observation table
    tables = []
    for b, a in coeffs:
        M = block_biquad_tables(np.asarray(b), np.asarray(a), 64)[4]
        a1, a2 = float(a[1]), float(a[2])
        A = np.array([[-a1, 1.0], [-a2, 0.0]])
        P_ = np.empty((seg_len, 2, 2))
        P_[0] = np.eye(2)
        for i in range(1, seg_len):
            P_[i] = A @ P_[i - 1]
        Tobs = P_[:, 0, :].copy()              # (seg, 2)
        Mseg = np.linalg.matrix_power(M, seg_len // 64)
        tables.append((Tobs, [float(v) for v in Mseg.ravel()]))
    on_device: dict[torch.device, list] = {}

    def advance(s, m, u):
        """s @ M^seg.T + u, for (B, 2) s and u."""
        m00, m01, m10, m11 = m
        return torch.stack([m00 * s[:, 0] + m01 * s[:, 1] + u[:, 0],
                            m10 * s[:, 0] + m11 * s[:, 1] + u[:, 1]],
                           dim=-1)

    def _stage(stage_i, z, x_local):
        """One biquad stage on this shard's segment."""
        Tobs, m = tables[stage_i]
        dev = x_local.device
        if dev not in on_device:
            on_device[dev] = [torch.as_tensor(t, dtype=torch.float64,
                                              device=dev)
                              for t, _ in tables]
        T = on_device[dev][stage_i]
        B = x_local.shape[0]
        y0, s_end0 = bqs[stage_i](x_local, torch.zeros(
            (B, 2), dtype=x_local.dtype, device=dev))
        # gather every shard's zero-state end state: (n_seq, B, 2)
        allz = torch.empty((n_seq * B, 2), dtype=s_end0.dtype, device=dev)
        dist.all_gather_into_tensor(allz, s_end0.contiguous(), group=group)
        allz = allz.reshape(n_seq, B, 2)
        # rebuild the incoming state of every shard in order
        s_ins = [z]                              # shard 0's incoming
        for k in range(1, n_seq):
            s_ins.append(advance(s_ins[-1], m, allz[k - 1]))
        mine = s_ins[idx]
        y = y0 + (mine[:, 0:1] * T[:, 0] + mine[:, 1:2] * T[:, 1])
        z_next = advance(s_ins[-1], m, allz[n_seq - 1])
        return z_next, y

    def step(z, x_local):
        z1, y = _stage(0, z[:, 0], x_local)
        z2, y = _stage(1, z[:, 1], y)
        return torch.stack([z1, z2], dim=1), y

    return step


def kweight_unsharded(rate: int = 192_000):
    """Single-device golden for the seq-sharded K-weighting."""
    bq1 = make_block_biquad(*biquad_coeffs_shelving(rate), L=64)
    bq2 = make_block_biquad(*biquad_coeffs_highpass(rate), L=64)

    def step(z, x):
        y, z1 = bq1(x, z[:, 0])
        y, z2 = bq2(y, z[:, 1])
        return torch.stack([z1, z2], dim=1), y

    return step
