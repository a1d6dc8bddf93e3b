"""The CG iterate update as one kernel: ``fused_cg_update``.

Every CG iteration updates the iterate and the residual and takes two dot
products (the JAX package's ``ops/cg.py:324-336``):

    x' = x + alpha p,   r' = r + alpha Ap,
    m  = 0.5 (r' - b) . x',   rr = r' . r'.

Eager PyTorch issues these as about eight launches and twelve passes over
n-vectors.  On a CUDA tensor :func:`fused_cg_update` runs them as one launch
of a hand-written kernel (``csrc/fused_cg_update.cu``, built by
:mod:`.._build`) that reads the five vectors once and writes two.  On a CPU
tensor it runs :func:`fused_cg_update_reference`, the plain PyTorch
version.  On a CUDA tensor it launches the kernel or raises; it never falls
back.

The launch geometry lives here, in :func:`launch_geometry`: the grid and
the split of ``[0, n)`` into a scalar head, 16-byte vectors and a scalar
tail.  The card's capacity behind it is read once per device and dtype.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional, Tuple

import torch

_SOURCE = "fused_cg_update.cu"
THREADS = 256  # threads per block (kThreads in the source)
UNROLL = 4  # vectors of each operand in flight per thread (kUnroll)
VEC_BYTES = 16  # one float4 / double2
MAX_BLOCKS_PER_SM = 32  # Hopper's limit of resident blocks per SM

# the entry point's arguments: 10 pointers, n, head, nvec, grid, device,
# stream, packed in one buffer per call
_ARGS = struct.Struct("16q")
_lib = None
_raw_stream = None  # device index -> the current cudaStream_t, as an int
_capturing = None  # () -> whether the current stream is capturing a graph
_configs = {}  # (device, itemsize) -> (sm_count, blocks_per_sm, offset)
_geometries = {}  # (device, itemsize, n, misalign) -> Geometry
_scratches = {}  # (device, stream) -> its ticket and partials


class Geometry(NamedTuple):
    """One launch: ``grid`` blocks; elements ``[0, head)`` one at a time,
    then ``nvec`` 16-byte vectors, then the rest one at a time."""

    grid: int
    head: int
    nvec: int


def launch_geometry(
    n: int,
    itemsize: int,
    sm_count: int,
    blocks_per_sm: int,
    misalign: Optional[int] = 0,
) -> Geometry:
    """The launch for ``n`` elements of ``itemsize`` bytes on a card of
    ``sm_count`` SMs holding ``blocks_per_sm`` of the kernel's blocks each.

    ``misalign`` is the operands' common address modulo 16 bytes (0 when
    aligned), or ``None`` when they share no 16-byte boundary; then every
    element goes one at a time.  The grid fills the card once at most (one
    wave of resident blocks).  Below that it gives each thread ``UNROLL``
    vectors (one round of loads), but at least one block per SM while
    there is a vector per thread for it (a small ``n`` then costs one round
    trip to memory), so that every block has work.
    """
    width = VEC_BYTES // itemsize
    if misalign is None:
        head, nvec = n, 0
    else:
        head = min(n, (VEC_BYTES - misalign) % VEC_BYTES // itemsize)
        nvec = (n - head) // width
    scalars = n - width * nvec
    blocks = max(-(-nvec // (THREADS * UNROLL)),
                 min(-(-nvec // THREADS), sm_count), -(-scalars // THREADS), 1)
    return Geometry(min(blocks, sm_count * blocks_per_sm), head, nvec)


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
    # one expression on the fast path (this runs once per CG iteration)
    device, dtype, shape = x.device, x.dtype, x.shape
    if (r.device != device or p.device != device or Ap.device != device
            or b.device != device or alpha.device != device
            or dtype not in (torch.float32, torch.float64)
            or r.dtype != dtype or p.dtype != dtype or Ap.dtype != dtype
            or b.dtype != dtype or alpha.dtype != dtype
            or len(shape) != 1 or r.shape != shape or p.shape != shape
            or Ap.shape != shape or b.shape != shape or alpha.numel() != 1
            or not (x.is_contiguous() and r.is_contiguous()
                    and p.is_contiguous() and Ap.is_contiguous()
                    and b.is_contiguous())):
        _raise_check_error(x, r, p, Ap, b, alpha)


def _raise_check_error(x, r, p, Ap, b, alpha):
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
    # a one-value alpha is contiguous whatever its strides
    raise ValueError("fused_cg_update: operands must be contiguous.")


def _library():
    """Build and load the kernel; resolve its functions and the stream
    lookups once."""
    global _lib, _raw_stream, _capturing
    if _lib is None:
        from .. import _build

        lib = _build.load(_SOURCE)
        lib.fused_cg_update.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.fused_cg_update.restype = ctypes.c_int
        lib.fused_cg_update_config.argtypes = [
            ctypes.c_int, ctypes.c_int, *[ctypes.POINTER(ctypes.c_int)] * 5
        ]
        lib.fused_cg_update_config.restype = ctypes.c_int
        # the C functions behind torch.cuda.current_stream(d).cuda_stream
        # and torch.cuda.is_current_stream_capturing, without their Python
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _capturing = torch._C._cuda_isCurrentStreamCapturing
        _lib = lib
    return _lib


def _config(device: int, itemsize: int):
    """``(sm_count, blocks_per_sm, partials_offset)`` of the kernel for
    ``itemsize`` on ``device``, read from the card once."""
    key = (device, itemsize)
    if key not in _configs:
        vals = [ctypes.c_int() for _ in range(5)]
        err = _library().fused_cg_update_config(
            itemsize, device, *map(ctypes.byref, vals))
        if err != 0:
            raise RuntimeError(
                f"fused_cg_update: reading the card failed with CUDA error "
                f"{err}."
            )
        threads, unroll, offset, sm_count, per_sm = (v.value for v in vals)
        if (threads, unroll) != (THREADS, UNROLL) or per_sm < 1:
            raise RuntimeError(
                f"fused_cg_update: the kernel runs {threads} threads x "
                f"{unroll} vectors and {per_sm} blocks per SM; this module "
                f"expects {THREADS} x {UNROLL} and at least 1."
            )
        _configs[key] = (sm_count, per_sm, offset)
    return _configs[key]


def _new_scratch(device: int, itemsize: int, stream: int) -> torch.Tensor:
    """The ticket (zero between launches) and the partials for launches on
    ``stream``: one buffer per stream, never shared across streams.  While a
    CUDA graph is captured, a fresh one per call, zeroed inside the graph;
    the caller holds it until the launch is queued (freed earlier, the
    call's own outputs could take its memory)."""
    sm_count, _, offset = _config(device, itemsize)
    # 2 partials of up to 8 bytes for each block the card can hold
    buf = torch.zeros(offset + 16 * sm_count * MAX_BLOCKS_PER_SM,
                      dtype=torch.uint8, device=f"cuda:{device}")
    if not _capturing():
        _scratches[(device, stream)] = buf
    return buf


def _offset_empty(x: torch.Tensor, misalign: int) -> torch.Tensor:
    """An empty vector like ``x`` at ``misalign`` bytes past a 16-byte
    boundary (the allocator's blocks start on one), so that its vectors
    line up with the inputs'."""
    k = misalign // x.element_size()
    return x.new_empty(x.shape[0] + k)[k:]


def _launch(x, r, p, Ap, b, alpha):
    lib = _lib or _library()
    device = x.get_device()
    n = x.shape[0]
    itemsize = x.element_size()
    xp, rp, pp, ap, bp = (x.data_ptr(), r.data_ptr(), p.data_ptr(),
                          Ap.data_ptr(), b.data_ptr())
    misalign = xp % VEC_BYTES
    if ((xp ^ rp) | (xp ^ pp) | (xp ^ ap) | (xp ^ bp)) % VEC_BYTES:
        misalign = None  # no common 16-byte boundary
    key = (device, itemsize, n, misalign)
    geo = _geometries.get(key)
    if geo is None:
        sm_count, per_sm, _ = _config(device, itemsize)
        geo = _geometries[key] = launch_geometry(n, itemsize, sm_count,
                                                 per_sm, misalign)
    stream = _raw_stream(device)
    scratch = None if _capturing() else _scratches.get((device, stream))
    if scratch is None:
        scratch = _new_scratch(device, itemsize, stream)
    if misalign:
        x_new, r_new = _offset_empty(x, misalign), _offset_empty(x, misalign)
    else:
        x_new, r_new = torch.empty_like(x), torch.empty_like(x)
    out = x.new_empty(2)
    err = lib.fused_cg_update(_ARGS.pack(
        xp, rp, pp, ap, bp, alpha.data_ptr(), x_new.data_ptr(),
        r_new.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, geo.head,
        geo.nvec, geo.grid, device, stream), itemsize)
    if err != 0:
        raise RuntimeError(
            f"fused_cg_update: kernel launch failed with CUDA error {err}."
        )
    fused_cg_update.launches += 1
    m, rr = out.unbind()
    return x_new, r_new, m, rr


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
    new 0-dim tensors on the same device.  Nothing syncs with the host.

    On CUDA tensors the kernel runs on the current stream, one launch per
    call, and ``fused_cg_update.launches`` counts the calls; ``x'`` and
    ``r'`` equal the reference bit for bit, and ``m`` and ``rr`` differ from
    it only by summation order (and are bitwise reproducible run to run for
    one ``n``, card and operand alignment).  The call can be captured in a
    CUDA graph.
    """
    _check(x, r, p, Ap, b, alpha)
    if x.is_cuda:
        return _launch(x, r, p, Ap, b, alpha)
    if x.device.type == "cpu":
        return fused_cg_update_reference(x, r, p, Ap, b, alpha)
    raise ValueError(
        f"fused_cg_update: no implementation for device {x.device}."
    )


fused_cg_update.launches = 0
