"""Block FFT convolution: overlap-save with carried history.

The port of gstpu/ops/fftconv.py, the convolution behind hrtfrender and
sofalizer (reference audio/hrtf — hrtf crate block FFT convolution,
sofar partitioned FIR): streaming blocks convolved with (possibly
per-block-changing) impulse responses as batched rFFT products, in
torch.fft on the device of the inputs, in the dtypes gstpu computes.
"""

from __future__ import annotations

import numpy as np
import torch


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def ols_block(history: torch.Tensor, x: torch.Tensor, ir_f: torch.Tensor,
              *, ir_len: int):
    """Overlap-save convolution of one block.

    history: (..., ir_len-1) carried input tail
    x: (..., S) new samples
    ir_f: (..., F) rfft of the zero-padded IR (F = nfft//2+1,
          nfft = next_pow2(S + ir_len - 1)); broadcastable against
          history/x batch dims (e.g. (C, 2, F) for per-channel stereo
          IRs against x (C, 1, S)).
    Returns (new_history (..., ir_len-1), y (..., S)).
    """
    S = x.shape[-1]
    nfft = 2 * (ir_f.shape[-1] - 1)
    full = torch.cat([history, x], dim=-1)         # (..., ir_len-1+S)
    fx = torch.fft.rfft(full, n=nfft, dim=-1)
    y = torch.fft.irfft(fx * ir_f, n=nfft, dim=-1)
    y = y[..., ir_len - 1: ir_len - 1 + S]
    new_hist = full[..., full.shape[-1] - (ir_len - 1):] if ir_len > 1 \
        else history
    return new_hist, y


def ir_rfft(ir: np.ndarray, seg_len: int) -> np.ndarray:
    """Precompute the rfft of IRs for segment length seg_len."""
    ir_len = ir.shape[-1]
    nfft = next_pow2(seg_len + ir_len - 1)
    return np.fft.rfft(ir, n=nfft, axis=-1)


# ---------------------------------------------------------------------------
# Uniformly-partitioned convolution (UPC / UPOLS)
# ---------------------------------------------------------------------------
#
# The reference sofalizer runs the sofar Renderer's uniformly
# partitioned convolution with partition-length 64 (reference
# audio/hrtf/src/sofa/imp.rs:37-44, 776-797): the FIR is split into
# K partitions of P taps; each input sub-frame's spectrum enters a
# frequency-domain delay line (FDL) and the output is
# sum_k FDL[j-k] * H[k] — so output depends on input with P-sample
# granularity instead of full-IR-length granularity. The whole element
# block's sub-frames are one batched rfft, the FDL window a gather, the
# partition sum one reduce, and the inverse one batched irfft.


def upc_ir_rfft(ir: torch.Tensor, *, part_len: int) -> torch.Tensor:
    """Partition a real IR at part_len taps and rfft each partition at
    FFT size 2*part_len, on the IR's device.

    ir: (..., L) real. Returns (..., K, part_len+1) complex64 with
    K = ceil(L / part_len); partition k holds taps [k*P, (k+1)*P).
    """
    L = ir.shape[-1]
    K = -(-L // part_len)
    irp = torch.nn.functional.pad(ir.to(torch.float32),
                                  (0, K * part_len - L))
    parts = irp.reshape(ir.shape[:-1] + (K, part_len))
    return torch.fft.rfft(parts, n=2 * part_len, dim=-1)


def upc_init(batch_shape: tuple, ir_len: int, part_len: int,
             device="cuda"):
    """Zero state for upc_block: (fdl (..., K-1, F) complex64,
    prev (..., P) float32), on `device`."""
    K = -(-ir_len // part_len)
    F = part_len + 1
    fdl = torch.zeros(batch_shape + (K - 1, F), dtype=torch.complex64,
                      device=device)
    prev = torch.zeros(batch_shape + (part_len,), dtype=torch.float32,
                       device=device)
    return fdl, prev


def upc_block(state, x: torch.Tensor, h_f: torch.Tensor, *, part_len: int):
    """Uniformly-partitioned overlap-save convolution of one block.

    state: (fdl, prev) from upc_init (batch dims = x's batch dims)
    x: (..., S) with S % part_len == 0
    h_f: (..., K, F) partitioned IR spectra from upc_ir_rfft;
         broadcastable against x's batch dims (e.g. (C, 2, K, F)
         against x (C, 1, S)).
    Returns ((new_fdl, new_prev), y (..., S)) — y identical to the
    full linear convolution, but each P-sample output sub-block
    depends only on input up to its own end (P-sample algorithmic
    granularity, the reference's latency semantics).
    """
    P = part_len
    K = h_f.shape[-2]
    fdl, prev = state
    S = x.shape[-1]
    n = S // P
    dev = x.device
    ext = torch.cat([prev, x.to(torch.float32)], dim=-1)
    # frame j = ext[j*P : j*P + 2P] = [sub-block j-1, sub-block j]
    idx = (torch.arange(n, device=dev)[:, None] * P
           + torch.arange(2 * P, device=dev)[None, :])
    frames = ext[..., idx]                      # (..., n, 2P)
    X = torch.fft.rfft(frames, dim=-1)          # (..., n, F)
    # FDL extended across the block: oldest first
    Xext = torch.cat([fdl, X], dim=-2)          # (..., K-1+n, F)
    # output sub-block j consumes spectra X_{j-K+1} .. X_j
    gidx = (K - 1 + torch.arange(n, device=dev)[:, None]
            - torch.arange(K, device=dev)[None, :])     # (n, K)
    Xwin = Xext[..., gidx, :]                   # (..., n, K, F)
    Y = torch.sum(Xwin * h_f[..., None, :, :], dim=-2)
    y = torch.fft.irfft(Y, n=2 * P, dim=-1)[..., P:]   # (..., n, P)
    y = y.reshape(y.shape[:-2] + (S,))
    new_fdl = Xext[..., Xext.shape[-2] - (K - 1):, :] if K > 1 else fdl
    new_prev = ext[..., ext.shape[-1] - P:]
    return (new_fdl, new_prev), y


def direct_conv_reference(x: np.ndarray, ir: np.ndarray) -> np.ndarray:
    """Host golden: straight convolution truncated to len(x)."""
    from scipy.signal import fftconvolve
    return fftconvolve(x, ir, mode="full")[..., :x.shape[-1]]
