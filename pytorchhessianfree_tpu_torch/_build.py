"""Build and load the package's native libraries.

Each source under ``csrc/`` is compiled into a shared library with a plain
C interface, loaded with ``ctypes``: a ``.cu`` source (a CUDA kernel) by
``nvcc`` for Hopper, a ``.cpp`` source (host code: the batch loader) by
``g++``.  The build runs at first use, from the sources in this package
only, into ``build/`` beside them; a library is named by the hash of its
source and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  The compiler's output of a successful build is kept
beside the library (:func:`build_log`): for a kernel, ``-Xptxas -v``'s
registers, shared memory and spills.

Nothing here runs at import time: importing the package needs neither
``nvcc`` nor ``g++`` nor a card.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


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


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: building the batch loader needs it.")


def _compiler(source: str):
    """``(compiler, flags)`` for ``csrc/<source>``: nvcc for ``.cu``, g++
    for ``.cpp``."""
    suffix = Path(source).suffix
    if suffix == ".cu":
        return _nvcc, NVCC_FLAGS
    if suffix == ".cpp":
        return _gxx, GXX_FLAGS
    raise ValueError(f"no compiler for {source}: expected .cu or .cpp")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    flags = _compiler(source)[1]
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built."""
    out = library_path(source)
    if out.exists():
        return out
    find, flags = _compiler(source)
    compiler = find()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, str(CSRC / source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(compiler).name} failed ({proc.returncode}) on "
                f"{source}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        # the log first: a library that exists always has its log
        log = out.with_suffix(".log")
        with tempfile.NamedTemporaryFile(
            "w", dir=BUILD_DIR, suffix=".log", delete=False
        ) as f:
            f.write(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(f.name, log)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_log(source: str) -> str:
    """The command line and compiler output of ``csrc/<source>``'s build
    (building it first if needed)."""
    return build(source).with_suffix(".log").read_text()


def load(source: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<source>``."""
    return ctypes.CDLL(str(build(source)))
