"""Fused device pipelines: whole element chains as one step function.

The port of gstpu's hand-fused flagship chain
(gstpu/parallel/chains.py::make_audiofx_exact_chain): rsaudioecho ->
audioloudnorm -> ebur128level at 192 kHz F64, batched over streams on
one device, the state a dict carried across blocks. The loudnorm stage
is gstpu_torch.ops.loudnorm_dev, the meter fused into its output
measurement (one shared K-weighting pass); echo is the exact f64
segment kernel of gstpu_torch.ops.echo.
"""

from __future__ import annotations

import numpy as np
import torch

from gstpu_torch.ops import loudnorm_dev
from gstpu_torch.ops.echo import echo_block, make_state
from gstpu_torch.ops.loudnorm_dev import (FRAME, GAIN_LOOKAHEAD,
                                          STEP_STAGES, LoudnormParams,
                                          init_state, make_steps)

# the stages of the chain's step, in order, as it names them to `mark`
STAGES = ("echo",) + STEP_STAGES


def make_audiofx_exact_chain(channels: int = 2, echo_delay: int = 48_000,
                             max_delay: int = 48_000):
    """The BASELINE audiofx chain rsaudioecho -> audioloudnorm ->
    ebur128level at 192 kHz F64, batched over streams.

    Returns (prime, step, init, n_prime, n_step):
      init(batch, device="cuda") -> state
      prime(state, x (B, 30*19200*C), intensity, feedback)
          -> (state, first out (B, 19200*C))
      step(state, x (B, 19200*C), intensity, feedback, mark=None)
          -> (state, out, meters{momentary, shortterm} (B,) LUFS)
    The steps run on the device of the state and x; intensity and
    feedback are Python floats. step calls mark(stage) after each of
    its STAGES where mark is given.
    echo_delay/max_delay are in flattened (interleaved) samples.
    """
    params = LoudnormParams(channels=channels)
    first_step, inner_step = make_steps(params, with_meter=True)
    C = channels

    def init(batch: int, device="cuda"):
        return dict(tail=make_state((batch,), max_delay, device=device),
                    ln=init_state(params, batch, device=device))

    def prime(state, x, intensity, feedback):
        tail, y = echo_block(state["tail"], x, intensity, feedback,
                             delay=echo_delay)
        ln, out, _meters = first_step(state["ln"], y)
        return dict(tail=tail, ln=ln), out

    def step(state, x, intensity, feedback, mark=None):
        tail, y = echo_block(state["tail"], x, intensity, feedback,
                             delay=echo_delay)
        if mark is not None:
            mark("echo")
        ln, out, meters = inner_step(state["ln"], y, mark=mark)
        return dict(tail=tail, ln=ln), out, meters

    n_prime = GAIN_LOOKAHEAD * C
    n_step = FRAME * C
    return prime, step, init, n_prime, n_step


def state_from_numpy(d: dict, device="cuda") -> dict:
    """The chain's state from numpy leaves (gstpu's chain state with
    each leaf taken through np.asarray), on `device`."""
    return dict(tail=torch.from_numpy(np.array(d["tail"], copy=True))
                .to(device),
                ln=loudnorm_dev.state_from_numpy(d["ln"], device))


def state_to_numpy(st: dict) -> dict:
    """The chain's state as numpy leaves with gstpu's dtypes."""
    return dict(tail=st["tail"].cpu().numpy(),
                ln=loudnorm_dev.state_to_numpy(st["ln"]))
