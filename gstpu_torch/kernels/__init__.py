"""The port's hand-written CUDA kernels, built on first use and bound
with ctypes.

Each `.cu` file here is one shared library with a plain C interface:
its entry points take raw device pointers, sizes, uniforms by value and
a CUDA stream, launch on that stream and return the launch's
`cudaError_t`. Nothing includes PyTorch's headers, so a build takes
seconds. Libraries go to `build/torch_ext/` beside the package, named
by a hash of their sources and flags, so an edited source is rebuilt.

The sources are compiled for Hopper (`sm_90a`) with `-fmad=false` and
without fast math: each kernel writes every fused multiply-add it needs
as `__fmaf_rn`, exactly where the XLA CPU compilation of the JAX
reference contracts one, and nothing else may be contracted if the
kernel is to stay bit-identical to its plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parents[1] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas=-v")
_HEADERS = ("common.cuh",)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


class CudaKernel:
    """One kernel source built into one shared library.

    `symbols` maps each exported C function to its ctypes argument
    types. `launches` counts successful launches through `launch`."""

    def __init__(self, name: str, source: str,
                 symbols: dict[str, list]):
        self.name = name
        self.source = SOURCE_DIR / source
        self.symbols = symbols
        self.launches = 0
        self.build_seconds: float | None = None
        self.compiler_output = ""
        self._lib: ctypes.CDLL | None = None
        self._pending: tuple | None = None  # (nvcc, temp path, start)
        self._lock = threading.Lock()

    @property
    def library_path(self) -> Path:
        h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for f in (self.source, *(SOURCE_DIR / n for n in _HEADERS)):
            h.update(f.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:12]}.so"

    def start_build(self) -> None:
        """Start nvcc in the background unless the library is built
        or being built."""
        if self._pending is not None or self.library_path.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._pending = (proc, tmp, time.monotonic())

    def _finish_build(self) -> None:
        if self._pending is None:
            return
        proc, tmp, t0 = self._pending
        self._pending = None
        self.compiler_output, _ = proc.communicate()
        self.build_seconds = time.monotonic() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {proc.returncode}):\n"
                               f"{self.compiler_output}")
        os.replace(tmp, self.library_path)

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        with self._lock:
            if self._lib is None:
                self.start_build()
                self._finish_build()
                lib = ctypes.CDLL(str(self.library_path))
                for sym, argtypes in self.symbols.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.gstpu_cuda_error_string.argtypes = [ctypes.c_int]
                lib.gstpu_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def launch(self, symbol: str, *args) -> None:
        """Call one entry point; raise if the launch was refused."""
        lib = self.load()
        err = getattr(lib, symbol)(*args)
        if err != 0:
            msg = lib.gstpu_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed: {msg} "
                               f"(cudaError {err})")
        self.launches += 1


def build_all(kernels) -> None:
    """Build every kernel's library at once: one nvcc per source, all
    started together, then load each."""
    for k in kernels:
        k.start_build()
    for k in kernels:
        k.load()


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on `device`."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
