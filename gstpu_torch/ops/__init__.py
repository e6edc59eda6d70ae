"""Frame operations on tensors: each kernel's wrapper beside its plain
PyTorch version."""

import torch


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 `a * b + c` with one rounding, as a contracted FMA gives:
    the product of two f32 values is exact in f64, so only the sum
    rounds there before the one rounding to f32. b and c: f32 tensors
    or floats that are f32 values."""
    return (a.double() * b + c).float()
