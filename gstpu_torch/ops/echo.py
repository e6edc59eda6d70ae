"""Echo/reverb over flattened interleaved samples, on tensors.

The port of gstpu's echo kernel (gstpu/ops/echo.py). Reference
semantics (audio/audiofx/src/audioecho/imp.rs:69-86 + ring_buffer.rs):
for each interleaved sample i (frames*channels flattened, f64 math):

    e          = written[i - D]        # D = delay in flattened samples
    out[i]     = in[i] + intensity * e
    written[i] = in[i] + feedback * e

The carried state is `tail`, the last S written samples in
chronological order. A block of N inputs is processed in segments of
length <= D: within a segment every delayed read lands in known data
(the tail and earlier segments), so each segment is elementwise work.

Torch rounds the product and the sum separately on the CPU and on the
card alike, so the output equals gstpu's strict golden
`echo_reference(..., fma=False)` bit for bit; gstpu's XLA kernel
contracts to an FMA and equals the `fma=True` golden instead.
"""

from __future__ import annotations

import torch


def echo_block(tail: torch.Tensor, x: torch.Tensor, intensity: float,
               feedback: float, *, delay: int):
    """Process one block on the device of `tail` and `x`.

    Args:
      tail: (..., S) f64, the last S *written* samples, oldest first;
        S >= delay.
      x: (..., N) input block (flattened interleaved samples).
      intensity, feedback: the f64 uniforms, as Python floats.
      delay: D, the flattened-sample delay.
    Returns:
      (new_tail (..., S), out (..., N)) with out.dtype == x.dtype.
    """
    S = tail.shape[-1]
    N = x.shape[-1]
    D = delay
    if not S >= D >= 1:
        raise ValueError(f"echo_block needs tail length >= delay >= 1, "
                         f"got {S} and {D}")
    xf = x.to(torch.float64)
    hist = tail
    outs = []
    off = 0
    while off < N:
        n = min(D, N - off)
        seg = xf[..., off:off + n]
        e = hist[..., hist.shape[-1] - D: hist.shape[-1] - D + n]
        outs.append(seg + intensity * e)
        written = seg + feedback * e
        hist = torch.cat([hist, written], dim=-1)
        # keep history bounded: only the last max(S, D) samples matter
        if hist.shape[-1] > S + D:
            hist = hist[..., -(S + D):]
        off += n
    out = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
    new_tail = hist[..., -S:]
    return new_tail, out.to(x.dtype)


def make_state(shape_prefix: tuple[int, ...], max_delay_samples: int,
               device="cuda") -> torch.Tensor:
    """Fresh zeroed tail state (silence history) on `device`."""
    return torch.zeros(shape_prefix + (max_delay_samples,),
                       dtype=torch.float64, device=device)
