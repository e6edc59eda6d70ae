"""Biquad IIR filtering as a parallel associative scan, on tensors.

The port of gstpu's block biquad (gstpu/ops/biquad.py): the
direct-form-II-transposed recurrence s[n] = A s[n-1] + B x[n] (A a
constant 2x2) evaluated as a scan of affine maps, and the exact block
state-space form `make_block_biquad` that the EBU R 128 K-weighting of
the loudness chain runs on.

Every function runs on the device of the tensors it is given, in f64.
No reduction here has an order that depends on the batch shape or the
device: sums go through `_tree_sum_last` (a fixed halving order) and the
scan through `associative_scan` (JAX's odd/even recursion, the same
association order), so every batch lane is bitwise independent of the
others. The port rounds each multiply and each add (torch does not
contract `a * b + c` to an FMA, XLA does), so it agrees with the JAX
functions to an ulp, not bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def biquad_coeffs_shelving(rate: int):
    """BS.1770 stage-1 shelving filter (spec constants, as recomputed
    for arbitrary rates by libebur128/ffmpeg)."""
    f0 = 1681.974450955533
    G = 3.999843853973347
    Q = 0.7071752369554196
    K = np.tan(np.pi * f0 / rate)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b = np.array([(Vh + Vb * K / Q + K * K) / a0,
                  2.0 * (K * K - Vh) / a0,
                  (Vh - Vb * K / Q + K * K) / a0])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                  (1.0 - K / Q + K * K) / a0])
    return b, a


def biquad_coeffs_highpass(rate: int):
    """BS.1770 stage-2 high-pass (RLB weighting)."""
    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = np.tan(np.pi * f0 / rate)
    a0 = 1.0 + K / Q + K * K
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                  (1.0 - K / Q + K * K) / a0])
    b = np.array([1.0, -2.0, 1.0])
    return b, a


def _affine_combine(left, right):
    """Compose affine maps x -> M x + v (right applied after), the 2x2 M
    and the 2-vector v carried as separate component tensors."""
    m00a, m01a, m10a, m11a, v0a, v1a = left
    m00b, m01b, m10b, m11b, v0b, v1b = right
    return (m00b * m00a + m01b * m10a,
            m00b * m01a + m01b * m11a,
            m10b * m00a + m11b * m10a,
            m10b * m01a + m11b * m11a,
            m00b * v0a + m01b * v1a + v0b,
            m10b * v0a + m11b * v1a + v1b)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along the last dim (len(a) is len(b)
    or len(b) + 1)."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.empty(shape + (a.shape[-1] + b.shape[-1],), dtype=a.dtype,
                      device=a.device)
    out[..., 0::2] = a
    out[..., 1::2] = b
    return out


def associative_scan(fn, elems, dim: int = -1):
    """Inclusive scan of the tuple of tensors `elems` along `dim` with
    the associative `fn(left, right)`, by the odd/even recursion of
    jax.lax.associative_scan (jax/_src/lax/control_flow/loops.py): the
    same pairs are combined in the same order, so the result equals
    JAX's wherever `fn` rounds as XLA does. The components may differ
    in their other dims as long as they broadcast."""
    elems = [torch.movedim(e, dim, -1) for e in elems]

    def scan(elems):
        n = elems[0].shape[-1]
        if n < 2:
            return elems
        reduced = fn([e[..., 0:-1:2] for e in elems],
                     [e[..., 1::2] for e in elems])
        odd = scan(list(reduced))
        if n % 2 == 0:
            even = fn([e[..., :-1] for e in odd],
                      [e[..., 2::2] for e in elems])
        else:
            even = fn(odd, [e[..., 2::2] for e in elems])
        even = [torch.cat([e[..., :1], r], dim=-1)
                for e, r in zip(elems, even)]
        return [_interleave(e, o) for e, o in zip(even, odd)]

    return tuple(torch.movedim(e, -1, dim) for e in scan(elems))


def _tree_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim with a fixed binary-halving order (pow2
    zero-pad): elementwise adds only, so the result is bitwise the same
    for every batch shape and device, and equals gstpu's."""
    n = x.shape[-1]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def biquad_scan(x: torch.Tensor, b, a, state: torch.Tensor):
    """Apply one biquad along the last dim via associative scan.

    x: (..., N); b, a: 3 coefficients each, a[0] == 1; state: (..., 2)
    DF2T state. Returns (y, new_state), in x's dtype.
    """
    b = torch.as_tensor(np.asarray(b, np.float64), device=x.device) \
        .to(x.dtype)
    a = torch.as_tensor(np.asarray(a, np.float64), device=x.device) \
        .to(x.dtype)
    state = state.to(x.dtype)
    b0, b1, b2 = b[0], b[1], b[2]
    a1, a2 = a[1], a[2]
    # s[n] = A s[n-1] + Bc x[n];  y[n] = b0 x[n] + s1[n-1]
    # A = [[-a1, 1], [-a2, 0]];  Bc = [b1 - a1 b0, b2 - a2 b0]
    ones = (1,) * (x.dim() - 1) + (x.shape[-1],)
    m00 = (-a1).expand(ones)
    m01 = torch.ones(ones, dtype=x.dtype, device=x.device)
    m10 = (-a2).expand(ones)
    m11 = torch.zeros(ones, dtype=x.dtype, device=x.device)
    v0 = x * (b1 - a1 * b0)
    v1 = x * (b2 - a2 * b0)
    # fold the initial state into the first element: v0' = A s0 + v0
    s0, s1 = state[..., 0], state[..., 1]
    v0[..., 0] += -a1 * s0 + s1
    v1[..., 0] += -a2 * s0
    out = associative_scan(_affine_combine, (m00, m01, m10, m11, v0, v1))
    sz1, sz2 = out[4], out[5]        # s[n] components for all n
    z1_prev = torch.cat([state[..., 0:1], sz1[..., :-1]], dim=-1)
    y = b0 * x + z1_prev
    new_state = torch.stack([sz1[..., -1], sz2[..., -1]], dim=-1)
    return y, new_state


def biquad_apply(x: torch.Tensor, b, a, state: torch.Tensor,
                 chunk: int = 2048):
    """Long-block biquad: a loop over chunks, the parallel associative
    scan within each chunk, so the scan's working set is O(batch *
    chunk)."""
    N = x.shape[-1]
    if N <= chunk:
        return biquad_scan(x, b, a, state)
    K = N // chunk
    ys = []
    for k in range(K):
        yk, state = biquad_scan(x[..., k * chunk:(k + 1) * chunk], b, a,
                                state)
        ys.append(yk)
    if N - K * chunk:
        yk, state = biquad_scan(x[..., K * chunk:], b, a, state)
        ys.append(yk)
    return torch.cat(ys, dim=-1), state


def block_biquad_tables(b: np.ndarray, a: np.ndarray, L: int):
    """Host-side f64 tables for the block state-space biquad.

    The DF2T recurrence s[n] = A s[n-1] + Bc x[n], y[n] = b0 x[n] +
    z1[n-1] is unrolled over blocks of L samples:
      y_blk  = b0 x_blk + (h * x_blk)[in-block] + O @ s_in
      s_out  = M s_in + sum_j W[j] x_blk[j]
    with h[m] = (A^m Bc)[0] (within-block FIR), O[i] = A^i[0, :]
    (state observation), W[j] = A^{L-1-j} Bc, M = A^L. (gstpu also
    builds the FIR as a Toeplitz matrix T for its CPU matmul form; the
    port has no use for it.)
    """
    b0, b1, b2 = float(b[0]), float(b[1]), float(b[2])
    a1, a2 = float(a[1]), float(a[2])
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    Bc = np.array([b1 - a1 * b0, b2 - a2 * b0])
    P = np.empty((L + 1, 2, 2))
    P[0] = np.eye(2)
    for i in range(1, L + 1):
        P[i] = A @ P[i - 1]
    h = np.array([(P[m] @ Bc)[0] for m in range(L - 1)])
    O = P[:L, 0, :].copy()                     # (L, 2)
    W = np.stack([P[L - 1 - j] @ Bc for j in range(L)])  # (L, 2)
    M = P[L]
    return b0, h, O, W, M


def make_block_biquad(b: np.ndarray, a: np.ndarray, L: int = 64):
    """Returns apply(x, state) -> (y, state) for f64 x: (B, N) with
    N % L == 0 and state: (B, 2) DF2T, on x's device: the exact block
    state-space evaluation of the biquad.

    The within-block FIR is the shifted-add form on every device, not
    gstpu's CPU matmul `xb @ T`: a BLAS matmul picks its own reduction
    order, which may change with the batch shape and would break the
    bitwise independence of the lanes."""
    b0, h_, O_, W_, M_ = block_biquad_tables(np.asarray(b), np.asarray(a),
                                             L)
    h = [float(v) for v in h_]
    m00, m01, m10, m11 = (float(M_[0, 0]), float(M_[0, 1]),
                          float(M_[1, 0]), float(M_[1, 1]))
    tables: dict[torch.device, tuple] = {}

    def on(device: torch.device):
        t = tables.get(device)
        if t is None:
            f64 = dict(dtype=F64, device=device)
            t = tables[device] = (
                torch.as_tensor(W_[:, 0], **f64),
                torch.as_tensor(W_[:, 1], **f64),
                torch.as_tensor(O_[:, 0], **f64),
                torch.as_tensor(O_[:, 1], **f64))
        return t

    def apply(x: torch.Tensor, state: torch.Tensor):
        B, N = x.shape
        NB = N // L
        W0, W1, O0, O1 = on(x.device)
        xb = x.reshape(B, NB, L)
        # per-block input-driven state increment u = sum_j W[j] x[j]
        u0 = _tree_sum_last(xb * W0)           # (B, NB)
        u1 = _tree_sum_last(xb * W1)
        u0[:, 0] += m00 * state[:, 0] + m01 * state[:, 1]
        u1[:, 0] += m10 * state[:, 0] + m11 * state[:, 1]
        # block-state recurrence s_k = M s_{k-1} + u_k via assoc scan;
        # the matrix components are the same for every lane, so they
        # are carried with a batch dim of 1
        f64 = dict(dtype=F64, device=x.device)
        comps = (torch.full((1, NB), m00, **f64),
                 torch.full((1, NB), m01, **f64),
                 torch.full((1, NB), m10, **f64),
                 torch.full((1, NB), m11, **f64), u0, u1)
        out = associative_scan(_affine_combine, comps)
        se0, se1 = out[4], out[5]              # state at end of block
        s0 = torch.cat([state[:, :1], se0[:, :-1]], dim=1)
        s1 = torch.cat([state[:, 1:], se1[:, :-1]], dim=1)
        # within-block FIR: shifted adds
        y = b0 * xb
        for m in range(L - 1):
            y[:, :, m + 1:] += h[m] * xb[:, :, :L - 1 - m]
        y = y + s0[:, :, None] * O0 + s1[:, :, None] * O1
        new_state = torch.stack([se0[:, -1], se1[:, -1]], dim=-1)
        return y.reshape(B, N), new_state

    return apply


def biquad_reference(x: np.ndarray, b: np.ndarray, a: np.ndarray,
                     state: np.ndarray | None = None):
    """scipy.signal.lfilter golden (sequential, host)."""
    from scipy.signal import lfilter
    if state is None:
        state = np.zeros(x.shape[:-1] + (2,))
    y, zf = lfilter(b, a, x, axis=-1, zi=state)
    return y, zf
