"""The CG iterate update as one kernel: ``fused_cg_update``.

Every CG iteration updates the iterate and the residual and takes two dot
products (the JAX package's ``ops/cg.py:324-336``):

    x' = x + alpha p,   r' = r + alpha Ap,
    m  = 0.5 (r' - b) . x',   rr = r' . r'.

Eager PyTorch issues these as about eight launches and twelve passes over
n-vectors.  On a CUDA tensor :func:`fused_cg_update` runs them as one
hand-written kernel (``csrc/fused_cg_update.cu``, built by :mod:`.._build`)
that reads the five vectors once and writes two.  On a CPU tensor it runs
:func:`fused_cg_update_reference`, the plain PyTorch version.  On a CUDA
tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_SOURCE = "fused_cg_update.cu"
_lib = None


def fused_cg_update_reference(
    x: torch.Tensor,
    r: torch.Tensor,
    p: torch.Tensor,
    Ap: torch.Tensor,
    b: torch.Tensor,
    alpha: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(x', r', m, rr)`` as defined above."""
    x_new = x + alpha * p
    r_new = r + alpha * Ap
    m = 0.5 * torch.dot(r_new - b, x_new)
    rr = torch.dot(r_new, r_new)
    return x_new, r_new, m, rr


def _check(x, r, p, Ap, b, alpha):
    vecs = (x, r, p, Ap, b)
    devices = {t.device for t in (*vecs, alpha)}
    if len(devices) != 1:
        raise ValueError(
            f"fused_cg_update: all operands must share one device, got "
            f"{sorted(str(d) for d in devices)}."
        )
    dtypes = {t.dtype for t in (*vecs, alpha)}
    if len(dtypes) != 1 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(
            "fused_cg_update: operands must all be float32 or all float64, "
            f"got {sorted(str(d) for d in dtypes)}."
        )
    if x.ndim != 1 or any(t.shape != x.shape for t in vecs):
        raise ValueError(
            "fused_cg_update: x, r, p, Ap and b must be [n] vectors of one "
            f"length, got {[tuple(t.shape) for t in vecs]}."
        )
    if alpha.numel() != 1:
        raise ValueError(
            f"fused_cg_update: alpha must hold one value, got shape "
            f"{tuple(alpha.shape)}."
        )
    if not all(t.is_contiguous() for t in (*vecs, alpha)):
        raise ValueError("fused_cg_update: operands must be contiguous.")


def _library():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load(_SOURCE)
        ptrs = [ctypes.c_void_p] * 10
        for name in ("fused_cg_update_f32", "fused_cg_update_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [*ptrs, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.fused_cg_update_num_blocks.argtypes = []
        lib.fused_cg_update_num_blocks.restype = ctypes.c_int
        _lib = lib
    return _lib


def fused_cg_update(
    x: torch.Tensor,
    r: torch.Tensor,
    p: torch.Tensor,
    Ap: torch.Tensor,
    b: torch.Tensor,
    alpha: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pass CG iterate update; returns ``(x', r', m, rr)``.

    ``x`` .. ``b`` are contiguous ``[n]`` vectors and ``alpha`` a one-value
    tensor, all on one device in one of float32 and float64.  ``x'`` and
    ``r'`` are new tensors (the inputs are not written); ``m`` and ``rr`` are
    0-dim tensors on the same device.  Nothing syncs with the host.

    On CUDA tensors the kernel runs on the current stream and
    ``fused_cg_update.launches`` counts its launches; ``x'`` and ``r'`` equal
    the reference bit for bit, and ``m`` and ``rr`` differ from it only by
    summation order (and are bitwise reproducible run to run).
    """
    _check(x, r, p, Ap, b, alpha)
    if x.device.type == "cpu":
        return fused_cg_update_reference(x, r, p, Ap, b, alpha)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_cg_update: no implementation for device {x.device}."
        )
    lib = _library()
    x_new = torch.empty_like(x)
    r_new = torch.empty_like(r)
    partials = torch.empty(
        2 * lib.fused_cg_update_num_blocks(), dtype=x.dtype, device=x.device
    )
    out = torch.empty(2, dtype=x.dtype, device=x.device)
    fn = (
        lib.fused_cg_update_f32
        if x.dtype == torch.float32
        else lib.fused_cg_update_f64
    )
    err = fn(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), Ap.data_ptr(),
        b.data_ptr(), alpha.data_ptr(), x_new.data_ptr(), r_new.data_ptr(),
        partials.data_ptr(), out.data_ptr(), x.numel(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused_cg_update: kernel launch failed with CUDA error {err}."
        )
    fused_cg_update.launches += 1
    return x_new, r_new, out[0], out[1]


fused_cg_update.launches = 0
