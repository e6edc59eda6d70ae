"""Build the repository's native host libraries for the port.

The C++ sources stay in the top-level `native/` directory, where gstpu
builds them with `native/Makefile`. The port compiles them itself at
first use, with `g++` and the Makefile's CXXFLAGS, into
`build/torch_ext/` beside its CUDA kernels, so neither `make` nor a
prebuilt library in the checkout is needed. It leaves out the Makefile's
`-march=native` for the FFV1 coder: the flags stay portable, so a
library built on one host loads on another, and the bitstream does not
depend on them. A library is named by a hash of its source and flags,
and written under a temporary name and renamed, so that processes
building at once never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

from gstpu_torch.kernels import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-Wall", "-std=c++17")


def build_library(source: str, libs: tuple = ()) -> Path | None:
    """`native/<source>` built into a shared library; its path, or None
    when the compiler is missing or refuses the source (a library it
    links against is absent)."""
    src = NATIVE_DIR / source
    h = hashlib.sha1(" ".join((*CXXFLAGS, *libs)).encode())
    h.update(src.read_bytes())
    lib = BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, "-o", str(tmp), str(src), *libs]
    try:
        r = subprocess.run(cmd, capture_output=True)
    except OSError:                        # no compiler
        return None
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib
