"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper into a
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, from the sources in this package only, into ``build/``
beside them; a library is named by the hash of its source and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import time: importing the package needs neither
``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit."
    )


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built."""
    out = library_path(source)
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {source}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<source>``."""
    return ctypes.CDLL(str(build(source)))
