"""Frame operations on tensors: each kernel's wrapper beside its plain
PyTorch version."""

import torch


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 `a * b + c` with one rounding, as a contracted FMA gives:
    the product of two f32 values is exact in f64, so only the sum
    rounds there before the one rounding to f32. b and c: f32 tensors
    or floats that are f32 values."""
    return (a.double() * b + c).float()


def empty_like_skewed(t: torch.Tensor) -> torch.Tensor:
    """An empty contiguous tensor shaped like `t` whose address equals
    t's modulo 16, so that a kernel can move both 16 bytes at a time
    after the same head of single pixels."""
    skew = t.data_ptr() % 16
    if skew == 0:
        return torch.empty_like(t, memory_format=torch.contiguous_format)
    e = t.element_size()
    flat = torch.empty(t.numel() + 16 // e, dtype=t.dtype, device=t.device)
    start = (skew - flat.data_ptr() % 16) % 16 // e
    return flat[start:start + t.numel()].view(t.shape)
