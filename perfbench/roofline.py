"""The least work each cell's semantics need, whatever implements them,
and the card's peaks: the yardstick of the `*_roofline_pct` metrics.

Peaks: NVIDIA's H100 SXM data sheet (dense rates): 3.35 TB/s of HBM,
34 TFLOP/s in float64 outside the tensor cores. A share is the least
time the card could take for the work (the larger of bytes over the
memory rate and operations over the f64 rate) over the device time the
run took for it, so no fusion or rewrite can lift it past 100%.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12

# float64 operations a flattened sample needs in the flagship step: the
# K-weighting of the input and of the output measurement (2 passes of 2
# biquads, 5 multiplies and 4 adds each: 36), their squares and sums
# (4), the echo (2 multiplies, 2 adds), the gain ramp and its product
# (3), the limiter's |x| and peak test (2) and the output clip (2)
AUDIO_OPS_PER_SAMPLE = 36 + 4 + 4 + 3 + 2 + 2


def grade_bytes(frame_bytes: int, table_bytes: int) -> int:
    """One frame through `hsvfilter ! colorlut`: the frame read once and
    written once, the colour table read once."""
    return 2 * frame_bytes + table_bytes


def audio_bytes(lanes: int, samples: int) -> int:
    """One flagship step over `lanes` lanes of `samples` flattened f64
    samples: the input read once and the output written once, the
    echo's delayed samples read and its new ones written once, the 3 s
    look-ahead's outgoing block read and incoming block written once.
    The look-ahead's shift and the limiter's staging copies are the
    implementation's choice and not counted."""
    return lanes * samples * 8 * (2 + 2 + 2)


def least_seconds(n_bytes: float, ops: float = 0.0) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S)


def share_pct(least_s: float, device_s: float) -> float | None:
    """100 * least / spent; None where nothing was spent."""
    if device_s <= 0.0:
        return None
    return 100.0 * least_s / device_s
