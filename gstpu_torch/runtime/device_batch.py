"""DeviceContext: the batched device execution path for elements.

The port of gstpu/runtime/device_batch.py. The reference multiplexes
hundreds of streams onto few OS threads via named threadshare contexts
(generic/threadshare/src/runtime/executor/context.rs:148-276
Context::acquire). Here elements that expose a device step JOIN a named
DeviceContext; the context is the batching window: it re-blocks each
member stream to the block size, and when every active member has a
block it runs ONE step over the stacked (B, block) batch and hands the
outputs back. N streams -> one batched step, not N per-buffer ones.

CHAIN FUSION: when members of one context are LINKED through pads (every
pipeline runs `rsaudioecho ! audioloudnorm ! ebur128level`, all three
naming the same context), the context discovers the chains from pad
topology and composes the stage functions into one step. Data enters at
each chain's head element and leaves from its tail element's src pad;
the intermediate pads carry only events. The composition is plain
Python: each stage is torch ops (or a hand-written kernel's wrapper) on
the batch.

Device-resident dataflow: a member may submit tensors, or DeviceRow
views of a shared (B, n) bank, instead of host samples; the batch is
then assembled where those rows lie, and outputs are distributed as
lazy DeviceRow buffers. Host rows are stacked and uploaded once to
`default_device()`. A fire whose rows lie on different devices raises.

Overlap: with depth=2 the context enqueues batch k and only then
distributes batch k-1's outputs (torch's CUDA ops are asynchronous, and
distribution does not synchronise), so host demux overlaps device
compute. depth=1 distributes immediately.

Usage (element side): implement `device_batch_spec()` returning
  dict(key=<hashable kernel identity: stage members must match>,
       step=f(states, x (B, N), *uniforms) -> (states, out)
            or -> (states, out, aux)   # aux: dict of (B, ...) meters
       init_state=f() -> per-stream state (no batch dim): a tree of
            dicts/tuples of tensors and host ints,
       uniforms=f() -> tuple of per-stream uniform scalars,
       # optional:
       prime=f(states, x (B, prime_blocks*N)) -> like step
            (audioloudnorm's 3 s first frame); output is ONE block
       prime_blocks=int,
       final=f(states, x (B, N), n_valid) -> (states, out, out_valid)
            (the EOS drain of a stage with lookahead),
       wide_ok=True,   # step takes any width (upstream of a prime)
       fuse_next=f(next_spec) -> fused spec | None,
       sample_shape=(H, W, C),   # video: the batch's native rank
       compute_dtype=np.dtype    # host rows are stacked in it
       )
and call DeviceContext.acquire(name).add_member(element) in start().

A uniform that is the same in every lane reaches the step as the
Python value; one that differs as a (B, 1) f64 tensor on the batch's
device. Host-int state entries (gstpu_torch.ops.loudnorm_dev.HOST_INTS)
are one int for the whole batch: chains fire in phase lockstep, so they
agree, and a fire where they do not raises. Per-stream outputs equal
the unbatched B=1 path on the same device bit for bit: the steps are
batched elementwise and state rows are independent.

Metas: a head that submits one block per buffer (the video filters,
one frame a block) passes the buffer's metas to `submit`; the chain's
outputs take them in order, as its unbatched path would.

ItemContext, at the end of the module, batches whole items of any size
(llamatexttransform's prompts) under the same names.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.device import default_device
from gstpu_torch.utils.log import debug_category
from gstpu_torch.utils.tracing import count, span

CAT = debug_category("devicebatch")

SECOND = 1_000_000_000

_NP_DTYPES: dict = {}


def _np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        d = _NP_DTYPES.get(dtype)
        if d is None:
            d = _NP_DTYPES[dtype] = torch.empty(0, dtype=dtype).numpy().dtype
        return d
    return np.dtype(dtype)


def _canon(device) -> torch.device:
    """A device with its index: torch.device("cuda") names the current
    CUDA device, as a tensor's .device does with the index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _numel(shape) -> int:
    n = 1
    for d in shape:         # math over ints: per stream per fire
        n *= d
    return n


class DeviceRow:
    """Lazy view of row `idx` of a device-resident (B, ...) batch.

    Used both for submission without copies (rows of a bank made on the
    device) and for lazy output distribution (slicing every row eagerly
    would issue B device ops per fire).

    The parent may be flat (B, n) or shaped (B, H, W, C): video specs
    carry batches in their native rank. `n`/`shape` always present the
    flat sample count so stream accounting stays rank-agnostic;
    `tensor()` returns the row in the parent's own rank."""

    __slots__ = ("parent", "idx", "n")

    def __init__(self, parent: torch.Tensor, idx: int, n: int | None = None):
        self.parent = parent
        self.idx = idx
        self.n = _numel(parent.shape[1:]) if n is None else int(n)

    @property
    def shape(self):
        return (self.n,)

    @property
    def dtype(self):
        return self.parent.dtype

    @property
    def device(self) -> torch.device:
        return self.parent.device

    @property
    def nbytes(self) -> int:
        return self.n * self.parent.element_size()

    def tensor(self) -> torch.Tensor:
        row = self.parent[self.idx]
        if row.dim() > 1:
            return row                  # native-rank video row
        return row[: self.n] if self.n != self.parent.shape[1] else row

    def __array__(self, dtype=None, copy=None):
        a = self.tensor().detach().cpu().numpy()
        return a.astype(dtype) if dtype is not None else a


class AuxView:
    """Per-fire meter values shared by every lane's element: each leaf
    is copied to the host without blocking when the fire is enqueued,
    and the first read waits once, on one event, for all of them (N
    elements reading must not issue N transfers, and a wait per leaf
    would stall the overlapped depth=2 pipeline)."""

    def __init__(self, leaves: dict):
        self._copies = {k: v.to("cpu", non_blocking=True)
                        for k, v in leaves.items()}
        self._event = None
        cuda = [v.device for v in leaves.values() if v.device.type == "cuda"]
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda[0]))
        self._host: dict | None = None

    def __getitem__(self, k):
        if self._host is None:
            if self._event is not None:
                self._event.synchronize()
            self._host = {n: v.numpy() for n, v in self._copies.items()}
        return self._host[k]

    def keys(self):
        return self._copies.keys()


def _is_device(x) -> bool:
    """A tensor (on any device) or a DeviceRow."""
    return isinstance(x, (torch.Tensor, DeviceRow))


def _downstream(element):
    """The element on the other side of `element`'s src pad, if any."""
    peer = getattr(getattr(element, "srcpad", None), "peer", None)
    return getattr(peer, "element", None)


def _tree_map(fn, *trees):
    """fn over the leaves of equally shaped trees of dicts, tuples and
    lists."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _stack_leaf(*leaves):
    """Stack one state entry over the chains of a fire: tensors along a
    new batch dim; a host int stays one int, which every chain must
    carry."""
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    if any(v != leaves[0] for v in leaves):
        raise ValueError(
            f"host-int state differs across the chains of one fire: "
            f"{sorted(set(leaves))} (chains fire in phase lockstep and "
            f"must carry one value)")
    return leaves[0]


def _lane(i: int):
    """Row i of each tensor entry; host ints as they are."""
    return lambda leaf: leaf[i] if isinstance(leaf, torch.Tensor) else leaf


@dataclass
class _Member:
    element: object
    spec: dict | None
    state: object            # per-stream state (no batch dim)
    pending: bytearray = field(default_factory=bytearray)
    dev_rows: list = field(default_factory=list)   # tensor submissions
    dev_avail: int = 0       # flattened samples queued in dev_rows
    metas: deque = field(default_factory=deque)  # per submitted buffer
    dtype: object = None     # numpy dtype of the submitted samples
    pts: int | None = None
    rate: int = 0            # flattened samples per second (for pts)
    active: bool = True
    primed: bool = False     # chain-head flag: priming fire done
    out_pts: int | None = None   # chain-head output pts cursor
    chain: object = None     # backref set by _build_chains
    ready: bool = False      # head flag: avail >= need (incremental
                             # mirror; authoritative scan in try_fire)


@dataclass
class _Stage:
    """One step stage of a composed chain. Usually 1:1 with a member; a
    spec that declares `fuse_next` can fold its downstream neighbour(s)
    into ONE stage (audioloudnorm absorbs a compatible ebur128level: the
    output measurement the gain machine already runs IS the meter). The
    fused spec keeps `owner`'s state layout, so checkpoints do not depend
    on fusion."""
    spec: dict
    owner: object            # _Member whose .state carries this stage
    members: list            # every _Member folded into this stage


@dataclass
class _Chain:
    members: list            # [_Member] head..tail
    stages: list = None      # [_Stage] set by _build_chains

    @property
    def head(self):
        return self.members[0]

    @property
    def tail(self):
        return self.members[-1]

    # chain-level state lives on the head member so that topology
    # rebuilds (late joiners) never lose it
    @property
    def primed(self):
        return self.head.primed

    @primed.setter
    def primed(self, v):
        self.head.primed = v

    @property
    def out_pts(self):
        return self.head.out_pts

    @out_pts.setter
    def out_pts(self, v):
        self.head.out_pts = v


class DeviceContext:
    """A named batching window shared by device elements."""

    _registry: dict[str, "DeviceContext"] = {}

    @classmethod
    def acquire(cls, name: str, block: int | None = None,
                depth: int = 1) -> "DeviceContext":
        ctx = cls._registry.get(name)
        if ctx is None:
            # block 0 = "sized from negotiated caps" (video elements
            # set it at finalize); None = default audio block
            ctx = cls._registry[name] = DeviceContext(
                name, 19_200 if block is None else block, depth)
        elif not isinstance(ctx, DeviceContext):
            raise ValueError(
                f"device-context {name!r} is held by an item context of "
                f"whole items, not sample streams")
        elif block and ctx.block != block:
            raise ValueError(
                f"device-context {name!r} exists with block "
                f"{ctx.block}, requested {block} (set the same "
                f"context-block on every member)")
        return ctx

    @classmethod
    def release(cls, name: str) -> None:
        cls._registry.pop(name, None)

    def __init__(self, name: str, block: int, depth: int):
        self.name = name
        self.block = block            # flattened samples per fire
        self.depth = depth            # 1 = immediate, 2 = overlapped
        self.members: list[_Member] = []
        self.chains: list[_Chain] | None = None
        self.key = None               # tuple of stage keys
        self.fire_count = 0
        self._has_unfinalized = False
        self._prime_n = 1
        # incremental readiness mirror: submit() bumps these instead of
        # rescanning every chain; try_fire's full scan stays the
        # authority and recounts them exactly
        self._n_ready = 0
        self._n_active = 0
        self._fused = None            # (step, prime, n_stages, final)
        self._pending_fire = None     # (out, aux, metas, device)
        # carried states stay BATCHED between fires (scattering them per
        # member after every fire would cost chains*leaves slices);
        # split back only on demand
        self._batched = None          # (chain_id_tuple, states tuple)
        self._uni_cache = None        # (values key, uniforms)

    # -- membership -----------------------------------------------------
    def add_member(self, element) -> _Member:
        """Join at READY (reference: Context::acquire happens in the
        element's state change, before data flows). The step spec needs
        negotiated caps, so it is finalized in finalize_member; a
        joined-but-unfinalized member holds the batch window open."""
        m = self.member_for(element)
        if m is None:
            m = _Member(element=element, spec=None, state=None)
            self.members.append(m)
            self.chains = None        # topology changed
        return m

    def finalize_member(self, element) -> _Member:
        m = self.add_member(element)
        m.spec = element.device_batch_spec()
        m.state = m.spec["init_state"]()
        self.chains = None
        return m

    def member_for(self, element) -> _Member | None:
        for m in self.members:
            if m.element is element:
                return m
        return None

    def remove_member(self, element) -> None:
        self._writeback()
        m = self.member_for(element)
        if m is not None:
            self.members.remove(m)
            self.chains = None
        if not self.members:
            DeviceContext._registry.pop(self.name, None)

    # -- chain discovery --------------------------------------------------
    def _build_chains(self) -> bool:
        """Group FINALIZED members into pad-linked chains. Unfinalized
        members hold the batch window open (try_fire waits) but do not
        block chain construction: an EOS drain of a finalized chain must
        proceed regardless. Returns False if nothing usable."""
        fin = [m for m in self.members if m.spec is not None]
        self._has_unfinalized = len(fin) != len(self.members)
        if not fin:
            return False
        by_el = {id(m.element): m for m in fin}
        downs = {id(m): by_el.get(id(_downstream(m.element))) for m in fin}
        tails = {id(d) for d in downs.values() if d is not None}
        heads = [m for m in fin if id(m) not in tails]
        chains = []
        seen = set()
        for h in heads:
            links, m = [], h
            while m is not None and id(m) not in seen:
                seen.add(id(m))
                links.append(m)
                m = downs[id(m)]
            chains.append(_Chain(members=links))
        if len(seen) != len(fin):
            raise ValueError(
                f"device-context {self.name!r}: members form a cycle")
        for c in chains:
            for m in c.members:
                m.chain = c
            c.stages = self._fuse_stages(c.members)
        key = tuple(tuple(s.spec["key"] for s in c.stages)
                    for c in chains)
        if len(set(key)) != 1:
            raise ValueError(
                f"device-context {self.name!r}: chains differ: "
                f"{sorted(set(key), key=repr)} (all chains of one context "
                f"must run the same step sequence)")
        self.key = key[0]
        self.chains = chains
        self._fused = self._compose([s.spec for s in chains[0].stages])
        self._prime_n = max((s.spec.get("prime_blocks", 1)
                             for s in chains[0].stages), default=1)
        return True

    @staticmethod
    def _fuse_stages(members: list) -> list:
        """Peephole pass over a chain's member specs: a spec with
        `fuse_next(next_spec) -> fused_spec | None` absorbs its
        downstream neighbour into one stage (repeatable: a fused spec may
        itself declare fuse_next). Disable with GSTPU_NO_CHAIN_FUSION=1
        (A/B identity tests)."""
        if os.environ.get("GSTPU_NO_CHAIN_FUSION"):
            return [_Stage(spec=m.spec, owner=m, members=[m])
                    for m in members]
        stages = []
        i = 0
        while i < len(members):
            m = members[i]
            spec = m.spec
            folded = [m]
            while i + 1 < len(members):
                fuse = spec.get("fuse_next")
                if fuse is None:
                    break
                fspec = fuse(members[i + 1].spec)
                if fspec is None:
                    break
                spec = fspec
                folded.append(members[i + 1])
                i += 1
            stages.append(_Stage(spec=spec, owner=m, members=folded))
            i += 1
        return stages

    @staticmethod
    def _compose(specs: list[dict]):
        """The stage functions of one chain shape, composed in order into
        step/prime (and, where a stage drains at EOS, final) functions
        over (B, n) batches."""
        prime_idx = [j for j, s in enumerate(specs)
                     if s.get("prime") is not None]
        if len(prime_idx) > 1:
            raise ValueError("at most one priming stage per chain")
        pj = prime_idx[0] if prime_idx else None
        final_idx = [j for j, s in enumerate(specs)
                     if s.get("final") is not None]
        fj = final_idx[0] if final_idx else None
        if pj is not None:
            for j in range(pj):
                if not specs[j].get("wide_ok"):
                    raise ValueError(
                        f"stage {specs[j]['key']!r} is upstream of a "
                        f"priming stage but not wide_ok")
        n_stages = len(specs)

        def run(states, x, unis, priming):
            aux = [None] * n_stages
            new_states = []
            for j, spec in enumerate(specs):
                fn = spec["prime"] if (priming and j == pj) \
                    else spec["step"]
                res = fn(states[j], x, *unis[j])
                if len(res) == 3:
                    st, x, aux[j] = res
                else:
                    st, x = res
                new_states.append(st)
            return tuple(new_states), x, aux

        def step(states, x, unis):
            return run(states, x, unis, False)

        def prime(states, x, unis):
            return run(states, x, unis, True)

        final = None
        if fj is not None:
            def final(states, x, n_valid: int, unis):
                new_states = []
                out_valid = None
                for j, spec in enumerate(specs):
                    if j == fj:
                        # the padding beyond n_valid must enter the
                        # draining stage as SILENCE (the host element
                        # receives exactly n samples)
                        mask = torch.arange(x.shape[1],
                                            device=x.device) < n_valid
                        x = x * mask[None, :].to(x.dtype)
                        st, x, out_valid = spec["final"](
                            states[j], x, n_valid)
                    else:
                        st, x = spec["step"](states[j], x, *unis[j])[:2]
                    new_states.append(st)
                return tuple(new_states), x, out_valid

        return step, prime if pj is not None else step, n_stages, final

    def _prime_blocks(self) -> int:
        return self._prime_n

    # -- dataflow ---------------------------------------------------------
    def submit(self, element, samples, pts, rate, metas=None) -> None:
        """Append one stream's flat samples (a host ndarray, a tensor, or
        a DeviceRow of a shared bank) at the chain's head element. The
        `metas` of a buffer that is exactly one block go to the output
        made from it."""
        with span("context.submit", pts):
            m = self.member_for(element)
            if metas is not None:
                m.metas.append([x.copy() for x in metas])
            if _is_device(samples):
                n = _numel(samples.shape)
                if m.pts is None and pts is not None:
                    m.pts = pts - m.dev_avail * SECOND // max(rate, 1)
                m.dtype = _np_dtype(samples.dtype)
                m.rate = rate
                m.dev_rows.append(samples)
                m.dev_avail += n
            else:
                if m.pts is None and pts is not None:
                    m.pts = pts - (len(m.pending)
                                   // samples.dtype.itemsize
                                   * SECOND // max(rate, 1))
                m.dtype = samples.dtype
                m.rate = rate
                m.pending.extend(samples.tobytes())
            # incremental gate: a fire needs EVERY active chain ready,
            # so only this member's own readiness can have changed here;
            # try_fire recounts exactly whenever it scans, so the mirror
            # can never wedge the context
            c = m.chain
            if (c is not None and self.chains is not None
                    and not self._has_unfinalized and m.active):
                now = self._avail(m) >= self._need(c)
                if now != m.ready:
                    m.ready = now
                    self._n_ready += 1 if now else -1
                if self._n_ready < self._n_active:
                    return
            self.try_fire()

    def _avail(self, m: _Member) -> int:
        if m.dev_rows:
            return m.dev_avail
        item = np.dtype(m.dtype).itemsize if m.dtype else 8
        return len(m.pending) // item

    def _need(self, c: _Chain) -> int:
        return self.block * (1 if c.primed else self._prime_blocks())

    def try_fire(self, force: bool = False) -> None:
        if self.chains is None and not self._build_chains():
            return
        if self._has_unfinalized and not force:
            return                    # membership still incomplete
        active = [c for c in self.chains if c.head.active]
        self._n_active = len(active)
        if not active:
            self._n_ready = 0
            return
        while True:
            ready = []
            for c in active:
                r = self._avail(c.head) >= self._need(c)
                c.head.ready = r
                if r:
                    ready.append(c)
            self._n_ready = len(ready)
            # chains must fire in phase lockstep: a mixed
            # primed/unprimed set fires the unprimed group first
            if ready:
                unprimed = [c for c in ready if not c.primed]
                ready = unprimed or ready
                want = ([c for c in active if not c.primed]
                        if unprimed else active)
            else:
                want = active
            if not ready or (not force and len(ready) != len(want)):
                break
            self._fire(ready)
            if force:
                break

    def _take_input(self, m: _Member, n: int):
        """Pop n flattened samples from a member; returns
        (host ndarray | tensor | DeviceRow, is_device)."""
        if m.dev_rows:
            if isinstance(m.dev_rows[0], DeviceRow) \
                    and m.dev_rows[0].n == n:
                row = m.dev_rows.pop(0)
                m.dev_avail -= n
                return row, True
            rows, have = [], 0
            while have < n and m.dev_rows:
                r = m.dev_rows.pop(0)
                rt = r.tensor() if isinstance(r, DeviceRow) else r
                if rt.dim() != 1:       # native-rank video row: the
                    rt = rt.reshape(-1)  # re-blocking path is flat
                rows.append(rt)
                have += int(rt.shape[0])
            m.dev_avail -= n
            cat = rows[0] if len(rows) == 1 else torch.cat(rows)
            if have > n:                      # push back the excess
                m.dev_rows.insert(0, cat[n:])
                cat = cat[:n]
            return cat, True
        item = np.dtype(m.dtype).itemsize
        row = np.frombuffer(bytes(m.pending[:n * item]), dtype=m.dtype)
        del m.pending[:n * item]
        return row, False

    def _stack_states(self, chains, stage_j):
        return _tree_map(_stack_leaf,
                         *[c.stages[stage_j].owner.state for c in chains])

    def _writeback(self) -> None:
        """Scatter the cached batched states back onto their members
        (before membership changes, flush, or checkpoint); each chain
        gets its row of every tensor entry and the host ints as they
        are."""
        if self._batched is None:
            return
        ids, states = self._batched
        self._batched = None
        by_id = {id(c): c for c in (self.chains or [])}
        chains = [by_id.get(i) for i in ids]
        for j in range(len(states)):
            for i, c in enumerate(chains):
                if c is not None:
                    c.stages[j].owner.state = _tree_map(_lane(i),
                                                        states[j])

    @staticmethod
    def _batch(rows: list, sshape: tuple, cdtype) -> torch.Tensor:
        """The (B, ...) input of a fire, on the device its rows lie on:
        every row of one bank as the bank itself, tensor rows stacked
        where they lie, host rows stacked and uploaded once to
        default_device(). Raises if the rows lie on different devices.
        A stack or upload adds its rows and bytes to the counters
        `context.stacked_rows` and `context.stacked_bytes`; a bank taken
        whole adds nothing."""
        devs = {_canon(default_device()) if isinstance(r, np.ndarray)
                else r.device for r in rows}
        if len(devs) != 1:
            raise ValueError(f"a fire's rows lie on different devices: "
                             f"{sorted(map(str, devs))}")
        dev = devs.pop()
        r0 = rows[0]
        bank = isinstance(r0, DeviceRow) \
            and all(isinstance(r, DeviceRow) and r.parent is r0.parent
                    for r in rows) \
            and r0.parent.shape[0] == len(rows) \
            and r0.n == _numel(r0.parent.shape[1:]) \
            and all(r.idx == i for i, r in enumerate(rows))
        if bank:
            x = r0.parent             # rows 0..B-1 of one bank: no copy
        elif all(isinstance(r, np.ndarray) for r in rows):
            host = np.stack([r.astype(cdtype, copy=False) for r in rows])
            if sshape:
                # reshape host-side: the upload lands in the native rank
                host = host.reshape((len(rows),) + sshape)
            x = torch.from_numpy(host).to(dev)
        else:
            def row(r):
                if isinstance(r, np.ndarray):
                    return torch.from_numpy(np.ascontiguousarray(
                        r.astype(cdtype, copy=False))).to(dev)
                t = r.tensor() if isinstance(r, DeviceRow) else r
                if sshape and t.dim() == 1:
                    return t.reshape(sshape)
                return t.reshape(-1) if not sshape and t.dim() > 1 else t
            x = torch.stack([row(r) for r in rows])
        if not bank:
            count("context.stacked_rows", len(rows))
            count("context.stacked_bytes", x.numel() * x.element_size())
        if sshape and x.dim() == 2:
            x = x.reshape((x.shape[0],) + sshape)
        return x

    def _fire(self, ready: list[_Chain]) -> None:
        with span("context.fire", self.fire_count + 1):
            priming = not ready[0].primed
            n = self.block * (self._prime_blocks() if priming else 1)
            step, prime, n_stages, _final = self._fused
            specs = [s.spec for s in ready[0].stages]

            rows, metas, dev_in = [], [], False
            for c in ready:
                h = c.head
                row, is_dev = self._take_input(h, n)
                dev_in = dev_in or is_dev
                pts = h.pts
                if pts is not None:
                    h.pts = pts + n * SECOND // max(h.rate, 1)
                if c.out_pts is None:
                    c.out_pts = pts
                rows.append(row)
                metas.append((c, pts))

            # video specs declare their native sample rank: the batch is
            # carried as (B, *sample_shape) end to end
            sshape = tuple(specs[0].get("sample_shape") or ())
            x = self._batch(rows, sshape,
                            specs[0].get("compute_dtype", np.float64))

            ids = tuple(id(c) for c in ready)
            if self._batched is not None and self._batched[0] == ids:
                states = self._batched[1]
            else:
                self._writeback()
                states = tuple(self._stack_states(ready, j)
                               for j in range(n_stages))
            uni_vals = tuple(tuple(c.stages[j].spec["uniforms"]()
                                   for c in ready)
                             for j in range(n_stages))
            key = (ids, uni_vals, x.device)
            if self._uni_cache is not None and self._uni_cache[0] == key:
                unis = self._uni_cache[1]
            else:
                def uniform(vals):
                    # lane-uniform values pass as the Python value (what
                    # the steps take, e.g. echo_block's floats)
                    if len(set(vals)) == 1:
                        return vals[0]
                    return torch.as_tensor(
                        np.asarray(vals, np.float64)[:, None],
                        device=x.device)
                unis = tuple(tuple(uniform(u) for u in zip(*uni_vals[j]))
                             for j in range(n_stages))
                self._uni_cache = (key, unis)
            fn = prime if priming else step
            states, out, aux = fn(states, x, unis)
            self._batched = (ids, states)
            aux = [AuxView(a) if isinstance(a, dict) else a for a in aux]
            for c in ready:
                c.primed = True
            # keep the incremental readiness mirror exact: the fired heads
            # just consumed a block (and may have flipped primed, which
            # changes their need)
            for c in ready:
                h = c.head
                now = h.active and self._avail(h) >= self._need(c)
                if now != h.ready:
                    h.ready = now
                    self._n_ready += 1 if now else -1
            self.fire_count += 1
            CAT.log("context %s: fired batch of %d chains x %d (%s, "
                    "total %d)", self.name, len(ready), n,
                    "prime" if priming else "step", self.fire_count)
            packet = (out, aux, metas, dev_in, self.fire_count)
            if self.depth <= 1:
                self._distribute(*packet)
            else:
                prev, self._pending_fire = self._pending_fire, packet
                if prev is not None:
                    self._distribute(*prev)

    def _distribute(self, out, aux, metas, device: bool,
                    fire: int | None = None) -> None:
        """Hand each lane its output (a DeviceRow of `out` for device
        input: no copy, no synchronisation; host rows for host input)
        and its meter values; `fire` is the number of the fire that made
        them."""
        with span("context.distribute", fire):
            out_n = _numel(out.shape[1:])
            host = None if device else out.cpu().numpy()
            for i, (c, _pts) in enumerate(metas):
                if not c.head.active:
                    continue
                # per-stage aux (metering) to the owning elements: every
                # member folded into the stage gets an offer (a fused
                # loudnorm+ebur stage's meters belong to the ebur element)
                for j, stg in enumerate(c.stages):
                    if aux[j] is None:
                        continue
                    for m in stg.members:
                        if hasattr(m.element, "consume_batch_aux"):
                            m.element.consume_batch_aux(aux[j], i,
                                                        c.out_pts, out_n)
                tail = c.tail
                dur = out_n * SECOND // max(c.head.rate, 1)
                pts = c.out_pts
                if pts is not None:
                    c.out_pts = pts + dur
                payload = DeviceRow(out, i) if device \
                    else host[i].astype(c.head.dtype, copy=False)
                buf = tail.element.make_batch_buffer(payload, pts, dur)
                if c.head.metas:
                    buf.metas = c.head.metas.popleft()
                tail.element.srcpad.push(buf)

    # -- EOS / flush ------------------------------------------------------
    def flush_pending(self) -> None:
        if self._pending_fire is not None:
            self._distribute(*self._pending_fire)
            self._pending_fire = None

    def flush_member(self, element) -> list[Buffer]:
        """Drain a chain at EOS (called with its HEAD element): flush any
        overlapped batch, then run the chain's padded tail at B=1 (other
        chains' states are untouched: state rows are independent). A
        trailing partial block is zero-padded and the output truncated
        to the real sample count."""
        m = self.member_for(element)
        if m is None:
            return []
        if self.chains is None and not self._build_chains():
            m.active = False
            return []
        chain = next((c for c in self.chains if c.head is m), None)
        if chain is None or m.spec is None:
            m.active = False
            self.try_fire()
            return []
        self.flush_pending()
        self._writeback()
        step, prime, n_stages, _final = self._fused
        hspec = chain.stages[0].spec
        cdtype = hspec.get("compute_dtype", np.float64)
        sshape = tuple(hspec.get("sample_shape") or ())
        dev = _canon(default_device())

        def _b1_states():
            return tuple(_tree_map(
                lambda v: v[None] if isinstance(v, torch.Tensor) else v,
                chain.stages[j].owner.state) for j in range(n_stages))

        def _b1_unis():
            return tuple(tuple(chain.stages[j].spec["uniforms"]())
                         for j in range(n_stages))

        def _store(states):
            for j in range(n_stages):
                chain.stages[j].owner.state = _tree_map(_lane(0),
                                                        states[j])

        def _row(n: int, width: int) -> torch.Tensor:
            """The member's next n samples as a (1, width) batch, zero
            padded, on the device they lie on (host rows: uploaded)."""
            row, is_dev = self._take_input(m, n)
            if is_dev:
                x = row.tensor() if isinstance(row, DeviceRow) else row
                if x.dim() == 1 and n < width:
                    x = torch.nn.functional.pad(x, (0, width - n))
            else:
                x = torch.from_numpy(np.pad(
                    row.astype(cdtype, copy=False), (0, width - n))).to(dev)
            return x[None]

        def _emit(host_row, emit):
            dur = emit * SECOND // max(m.rate, 1)
            pts = chain.out_pts
            if pts is not None:
                chain.out_pts = pts + dur
            buf = chain.tail.element.make_batch_buffer(
                host_row.astype(m.dtype, copy=False), pts, dur)
            if m.metas:
                buf.metas = m.metas.popleft()
            out_bufs.append(buf)

        out_bufs: list[Buffer] = []
        while self._avail(m) > 0:
            need = self._need(chain)
            avail = self._avail(m)
            if _final is not None and chain.primed and avail < need:
                break                # partial tail: the FINAL drain
            n = min(avail, need)
            x = _row(n, need)
            if sshape and x.dim() == 2:
                x = x.reshape((1,) + sshape)
            fn = prime if not chain.primed else step
            states, out, _aux = fn(_b1_states(), x, _b1_unis())
            chain.primed = True
            _store(states)
            out_row = out[0].reshape(-1).cpu().numpy()
            emit = min(out_row.size, n) \
                if out_row.size == need else out_row.size
            _emit(out_row[:emit], emit)
        if _final is not None and chain.primed:
            # the device FINAL drain (ops/loudnorm_dev.make_final_step):
            # consume the trailing partial block and emit the whole
            # gain-lookahead tail with host-element semantics
            n = self._avail(m)
            x = _row(n, self.block) if n > 0 else torch.from_numpy(
                np.zeros((1, self.block), cdtype)).to(dev)
            states, out, out_valid = _final(_b1_states(), x, n,
                                            _b1_unis())
            _store(states)
            emit = int(out_valid)       # flat samples
            _emit(out[0][:emit].cpu().numpy(), emit)
        m.active = False
        # remaining chains may all be ready now
        self.try_fire()
        if len(chain.members) > 1:
            # multi-element chain: outputs belong at the TAIL's src pad
            # (returning them would re-enter the chain's own
            # intermediate elements as input)
            for b in out_bufs:
                chain.tail.element.srcpad.push(b)
            return []
        return out_bufs


@dataclass
class _ItemMember:
    element: object
    items: deque = field(default_factory=deque)   # (item, pts, duration)
    active: bool = True


class ItemContext:
    """A named batch of whole items of any size, one from each member a
    fire (llamatexttransform's prompts).

    An element joins in start() with a key (members must match) and a
    step f(items: list) -> list, and leaves in stop(). `submit` queues
    one item with the pts and duration its output takes. When every
    active member has an item queued, the step runs once on the list of
    their first items and output i goes out through member i's
    `make_batch_buffer(out, pts, duration)` on its src pad. At EOS
    (`flush_member`) a member's queued items are served alone, in order,
    and the others then fire without it. Names are DeviceContext's: a
    name is held by one context of either kind, and
    `DeviceContext.release` clears both."""

    @classmethod
    def join(cls, name: str, element, key, step) -> "ItemContext":
        ctx = DeviceContext._registry.get(name)
        if ctx is None:
            ctx = DeviceContext._registry[name] = cls(name, key, step)
        elif not isinstance(ctx, ItemContext):
            raise ValueError(
                f"context {name!r} is a device-context of sample streams, "
                f"not of whole items")
        elif ctx.key != key:
            raise ValueError(
                f"context {name!r} runs {ctx.key!r}, its new member "
                f"{key!r} (every member of one context must run the same "
                f"step)")
        for m in ctx.members.values():
            if _downstream(m.element) is element \
                    or _downstream(element) is m.element:
                raise ValueError(
                    f"context {name!r}: {m.element.name} and "
                    f"{element.name} are linked through pads (a fire "
                    f"would wait on its own output)")
        ctx.members[element] = _ItemMember(element)
        return ctx

    def __init__(self, name: str, key, step):
        self.name = name
        self.key = key
        self.step = step
        self.members: dict[object, _ItemMember] = {}   # by element
        self.fire_count = 0

    def leave(self, element) -> None:
        self.members.pop(element, None)
        if not self.members:
            DeviceContext._registry.pop(self.name, None)

    def submit(self, element, item, pts, duration) -> None:
        with span("context.submit", pts):
            self.members[element].items.append((item, pts, duration))
            self._try_fire()

    def _try_fire(self) -> None:
        live = [m for m in self.members.values() if m.active]
        while live and all(m.items for m in live):
            self._fire(live)

    def _fire(self, members: list[_ItemMember]) -> None:
        with span("context.fire", self.fire_count + 1):
            taken = [m.items.popleft() for m in members]
            outs = self.step([item for item, _, _ in taken])
            self.fire_count += 1
        with span("context.distribute", self.fire_count):
            for m, (_, pts, dur), out in zip(members, taken, outs):
                el = m.element
                el.srcpad.push(el.make_batch_buffer(out, pts, dur))

    def flush_member(self, element) -> list[Buffer]:
        """EOS: the member's queued items alone, in order, as buffers for
        its element to push; then the other members may fire."""
        m = self.members[element]
        bufs = []
        while m.items:
            item, pts, dur = m.items.popleft()
            bufs.append(element.make_batch_buffer(self.step([item])[0],
                                                  pts, dur))
        m.active = False
        self._try_fire()
        return bufs


# ---------------------------------------------------------------------------
# checkpoint/resume: a replacement process restores member states and
# continues bit-exact; gstpu_torch/parallel/checkpoint.py does the IO
# ---------------------------------------------------------------------------

def snapshot_context(ctx: DeviceContext, path: str) -> None:
    """Checkpoint every finalized member's carried state plus its
    pending re-block bytes."""
    import base64
    import json

    from gstpu_torch.parallel.checkpoint import checkpoint
    ctx._writeback()
    states = [m.state for m in ctx.members if m.spec is not None]
    checkpoint(path, states, step=ctx.fire_count)
    # JSON + base64 sidecar (NOT pickle: a checkpoint from an untrusted
    # source must not execute code on restore)
    recs = [{"pending": base64.b64encode(bytes(m.pending)).decode(),
             "pts": m.pts, "rate": m.rate,
             "dtype": np.dtype(m.dtype).str if m.dtype else None}
            for m in ctx.members if m.spec is not None]
    with open(path + ".pending", "w") as f:
        json.dump(recs, f)


def restore_context(ctx: DeviceContext, path: str) -> None:
    """Restore member states into an equally-shaped context (same
    members in the same order, finalized)."""
    import base64
    import json

    from gstpu_torch.parallel.checkpoint import restore
    ctx._writeback()
    ctx._batched = None
    members = [m for m in ctx.members if m.spec is not None]
    like = [m.state for m in members]
    states, _step = restore(path, like)
    with open(path + ".pending") as f:
        pendings = json.load(f)
    if len(pendings) != len(members):
        raise ValueError("checkpoint member count mismatch")
    for m, st, rec in zip(members, states, pendings):
        m.state = st
        m.pending = bytearray(base64.b64decode(rec["pending"]))
        m.pts = rec["pts"]
        m.rate = rec["rate"]
        m.dtype = np.dtype(rec["dtype"]) if rec["dtype"] else None
