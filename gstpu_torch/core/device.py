"""The device that elements upload host frames to.

`gstpu_torch.init(device)` sets it; the default is the first CUDA
device. Asking for CUDA where there is none raises: the port never
falls back to the CPU on its own. Tensors that arrive already on a
device are processed where they lie.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

_device: torch.device | None = None
_tf32_lock = threading.Lock()
_tf32_scopes = 0
_tf32_saved: tuple[bool, bool] = (False, False)


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


@contextmanager
def tf32_off():
    """cuBLAS matmuls and cuDNN convolutions in true f32 inside the
    scope. torch's TF32 flags are process-wide, so they are counted: the
    first scope to open saves and clears them, the last to close
    restores them, and scopes open on several threads at once never see
    TF32 back on before they end. Code outside every scope sees the
    flags cleared while any scope is open."""
    global _tf32_scopes, _tf32_saved
    with _tf32_lock:
        if _tf32_scopes == 0:
            _tf32_saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _tf32_scopes += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_scopes -= 1
            if _tf32_scopes == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _tf32_saved
