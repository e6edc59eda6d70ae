"""The device that elements upload host frames to.

`gstpu_torch.init(device)` sets it; the default is the first CUDA
device. Asking for CUDA where there is none raises: the port never
falls back to the CPU on its own. Tensors that arrive already on a
device are processed where they lie.
"""

from __future__ import annotations

import torch

_device: torch.device | None = None


def set_default_device(device=None) -> torch.device:
    global _device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gstpu_torch: CUDA device requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain versions")
    _device = dev
    return dev


def default_device() -> torch.device:
    return _device if _device is not None else set_default_device()
