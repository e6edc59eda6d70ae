"""Kimi Delta Attention's recurrence (the gated delta rule with a gate
per key channel), on every (row, head) of a batch of ragged runs.

Per token, with S the head's K x V state (f32) and q already scaled:

    S <- Diag(exp g) S;  u = v - S^T k;  S <- S + (beta k) u^T;  o = S^T q

`kda_recurrence` takes q, k, v, g (rows, L, H, 128) and beta (rows, L,
H) as f32 views, row r's run being its first lens[r] tokens, and the
state (rows, H, 128, 128) f32, which it updates in place; it returns o
(rows, L, H, 128) f32, 0 past each row's length. A CPU tensor takes the
plain form below, a loop of torch ops a token; a CUDA tensor one launch
of kernels/kda.cu, which computes the same steps in the same order
(tests/test_torch_kimi_linear.py transcribes it). `fresh` starts every row from a
zero state (prefill) instead of reading it (decode).
"""

from __future__ import annotations

import ctypes

import torch

from gstpu_torch.kernels import CudaKernel, stream_handle

HEAD_DIM = 128      # the kernel's key and value width
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KDA_KERNEL = CudaKernel("kda_recurrence", "kda.cu", {
    "kda_recurrence": [_P, _P, _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL,
                       _P, _LL, _LL, _P, _P, _I, _I, _I, ctypes.c_float,
                       _I, _P]})


def kda_recurrence(q, k, v, g, beta, state, lens, scale: float,
                   fresh: bool) -> torch.Tensor:
    """o (rows, L, H, K) f32; `state` updated in place (module
    docstring). `lens` (rows,) int32 on the tensors' device."""
    if q.device.type == "cuda":
        return _kda_kernel(q, k, v, g, beta, state, lens, scale, fresh)
    return kda_recurrence_plain(q, k, v, g, beta, state, lens, scale, fresh)


def kda_recurrence_plain(q, k, v, g, beta, state, lens, scale: float,
                         fresh: bool) -> torch.Tensor:
    rows, L, H, K = q.shape
    S = torch.zeros_like(state) if fresh else state.clone()
    o = torch.zeros(rows, L, H, v.shape[-1], dtype=torch.float32,
                    device=q.device)
    for t in range(L):
        live = (lens > t)[:, None, None]
        S_t = S * g[:, t].exp()[..., None]
        u = v[:, t] - (S_t * k[:, t, ..., None]).sum(-2)
        S_t = S_t + (beta[:, t, :, None] * k[:, t])[..., None] \
            * u[..., None, :]
        o_t = (S_t * (q[:, t] * scale)[..., None]).sum(-2)
        S = torch.where(live[..., None], S_t, S)
        o[:, t] = torch.where(live, o_t, 0.0)
    state.copy_(S)
    return o


def _kda_kernel(q, k, v, g, beta, state, lens, scale, fresh):
    rows, L, H, K = q.shape
    if K != HEAD_DIM or v.shape[-1] != HEAD_DIM:
        raise ValueError(f"kda_recurrence: heads of {K} and {v.shape[-1]}"
                         f" (the kernel takes {HEAD_DIM})")
    if q.stride() != k.stride() or q.stride() != v.stride():
        raise ValueError("kda_recurrence: q, k and v need one layout")
    for name, x in (("q", q), ("k", k), ("v", v), ("g", g)):
        if x.dtype != torch.float32 or x.stride(3) != 1 \
                or x.stride(2) != K:
            raise ValueError(f"kda_recurrence: {name} must be f32 with "
                             f"heads of {K} contiguous values")
    if beta.dtype != torch.float32 or beta.stride(2) != 1:
        raise ValueError("kda_recurrence: beta must be f32, heads "
                         "contiguous")
    if state.shape != (rows, H, K, K) or state.dtype != torch.float32 \
            or not state.is_contiguous():
        raise ValueError("kda_recurrence: state must be (rows, H, 128, "
                         "128) f32 contiguous")
    if lens.dtype != torch.int32 or lens.shape != (rows,):
        raise ValueError("kda_recurrence: lens must be (rows,) int32")
    o = torch.empty(rows, L, H, K, dtype=torch.float32, device=q.device)
    KDA_KERNEL.launch(
        "kda_recurrence", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), q.stride(1), g.data_ptr(), g.stride(0), g.stride(1),
        beta.data_ptr(), beta.stride(0), beta.stride(1), o.data_ptr(),
        o.stride(0), o.stride(1), state.data_ptr(), lens.data_ptr(), rows,
        L, H, float(scale), int(bool(fresh)), stream_handle(q.device))
    return o
