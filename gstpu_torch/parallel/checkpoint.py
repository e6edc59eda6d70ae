"""Stream-state checkpoint / resume for batched device chains.

The port of gstpu/parallel/checkpoint.py: a chain's state is a tree of
dicts, tuples and lists whose leaves are tensors and host ints.
checkpoint() writes it to an npz (no pickle: a checkpoint from an
untrusted source must not run code on restore) together with a string
of its structure; restore() checks the structure, each leaf's shape and
dtype against a state of the same layout, and puts every tensor on that
state's device; given a mesh (gstpu's `sharding=`), it gives this rank
its rows of the stream axis. Bit-exact: resuming mid-stream continues
with the same samples the uninterrupted run would produce.
"""

from __future__ import annotations

import numpy as np
import torch

from gstpu_torch.parallel.streams import shard_slice


def _flatten(tree, leaves: list) -> str:
    """Append tree's leaves to `leaves` in order; return its structure."""
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{_flatten(v, leaves)}"
                              for k, v in tree.items()) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ",".join(_flatten(v, leaves) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return "T"
    if isinstance(tree, int) and not isinstance(tree, bool):
        leaves.append(tree)
        return "i"
    raise TypeError(f"checkpoint: no leaf type for {type(tree).__name__}")


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def state_to_host(state) -> dict:
    """A state -> flat dict of numpy arrays + its structure string."""
    leaves: list = []
    treedef = _flatten(state, leaves)
    out = {f"leaf_{i}": (leaf.detach().cpu().numpy()
                         if isinstance(leaf, torch.Tensor)
                         else np.int64(leaf))
           for i, leaf in enumerate(leaves)}
    out["__treedef__"] = np.frombuffer(treedef.encode(), dtype=np.uint8)
    return out


def checkpoint(path: str, state, step: int = 0) -> None:
    host = state_to_host(state)
    host["__step__"] = np.int64(step)
    np.savez(path, **host)


def restore(path: str, like_state, *, mesh=None):
    """-> (state, step). `like_state` supplies the structure, and the
    device of each tensor leaf.

    With a `mesh` (gstpu_torch.parallel.streams.make_mesh) the
    checkpoint is the global state and `like_state` this rank's local
    one: each leaf of ndim >= 1 gets this rank's rows of the "stream"
    dim, 0-dim leaves and host ints are replicated."""
    leaves_like: list = []
    treedef = _flatten(like_state, leaves_like)
    with np.load(path) as z:
        saved = bytes(z["__treedef__"]).decode()
        if saved != treedef:
            raise ValueError(f"checkpoint structure mismatch: saved "
                             f"{saved} vs chain {treedef}")
        leaves = []
        for i, like in enumerate(leaves_like):
            arr = z[f"leaf_{i}"]
            if mesh is not None and arr.ndim >= 1:
                rows = shard_slice(arr.shape[0], mesh, ("stream",))
                arr = arr[rows].copy()
            if not isinstance(like, torch.Tensor):
                leaves.append(int(arr))
                continue
            want = torch.empty(0, dtype=like.dtype).numpy().dtype
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} "
                                 f"!= chain {tuple(like.shape)}")
            if arr.dtype != want:
                raise ValueError(
                    f"leaf {i}: checkpoint dtype {arr.dtype} != chain "
                    f"{want} (silent cast would break bit-exact resume)")
            leaves.append(torch.from_numpy(arr).to(like.device))
        step = int(z["__step__"])
    return _unflatten(like_state, iter(leaves)), step
