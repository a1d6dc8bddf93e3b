"""ctypes bindings for the native prefetching batch loader (port of
:mod:`pytorchhessianfree_tpu.runtime.loader`).

The C++ batcher (``csrc/batcher.cpp``, the port's copy of the JAX package's
``runtime/src/batcher.cpp``) assembles shuffled mini-batches on background
threads into a ring of buffers; Python's ``next()`` is one memcpy.  The
library is built by ``g++`` at first use into the package's ``build/``
directory (:mod:`.._build`, keyed by the hash of its source and flags, with
an atomic rename against concurrent builds) and bound with ``ctypes``: a
plain C ABI, no PyTorch headers.  A failed build raises; nothing falls back
to a Python loader.

It yields numpy arrays, as the JAX loader does; :class:`~.prefetch.
DevicePrefetcher` moves them to the card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np

_SOURCE = "batcher.cpp"
_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is None:
            from .. import _build

            lib = _build.load(_SOURCE)
            lib.hfb_create.restype = ctypes.c_void_p
            lib.hfb_create.argtypes = [
                ctypes.c_void_p,  # inputs
                ctypes.c_void_p,  # targets
                ctypes.c_int64,  # n
                ctypes.c_int64,  # in_row_bytes
                ctypes.c_int64,  # tgt_row_bytes
                ctypes.c_int64,  # batch
                ctypes.c_uint64,  # seed
                ctypes.c_int32,  # depth
                ctypes.c_int32,  # n_threads
                ctypes.c_int32,  # drop_last
            ]
            lib.hfb_next.restype = ctypes.c_int64
            lib.hfb_next.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.hfb_batches_per_epoch.restype = ctypes.c_int64
            lib.hfb_batches_per_epoch.argtypes = [ctypes.c_void_p]
            lib.hfb_stop.restype = None
            lib.hfb_stop.argtypes = [ctypes.c_void_p]
            lib.hfb_destroy.restype = None
            lib.hfb_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class PrefetchLoader:
    """Threaded, shuffled, prefetching mini-batch iterator.

    Rows are moved as opaque byte spans, so inputs and targets keep their
    native dtypes end to end -- integer labels pass through as integers with
    no float round-trip.

    Memory-mapped datasets are supported directly: pass ``np.memmap`` /
    ``np.load(..., mmap_mode="r")`` arrays (or use :meth:`from_npy`) and the
    C++ producer threads gather rows straight out of the OS page cache --
    datasets larger than host RAM stream from disk with no up-front copy
    (a contiguous memmap passes through ``ascontiguousarray`` unchanged).

    Args:
        inputs: [N, ...] array, any dtype and trailing shape.
        targets: [N, ...] array, any dtype (e.g. int32/int64 class labels).
        batch_size: rows per batch.
        seed: shuffle seed (deterministic epochs; the same batches as the
            JAX package's loader for the same seed).
        depth: ring-buffer depth (batches prefetched ahead).
        num_threads: producer threads (gathers run concurrently).
        drop_last: drop the ragged final batch; otherwise it is padded by
            repeating the last sample (keeps shapes static).
        labels_as_int: legacy knob from when targets were forced to float32;
            casts float targets to int32 after gather.  Native integer
            targets no longer need it.
    """

    def __init__(
        self,
        inputs: np.ndarray,
        targets: np.ndarray,
        batch_size: int,
        seed: int = 0,
        depth: int = 4,
        num_threads: int = 2,
        drop_last: bool = True,
        labels_as_int: bool = False,
    ):
        lib = _load()
        self._lib = lib
        # the native threads read these buffers: keep them referenced for
        # the handle's life
        self._inputs = np.ascontiguousarray(inputs)
        self._targets = np.ascontiguousarray(targets)
        n = self._inputs.shape[0]
        if self._targets.shape[0] != n:
            raise ValueError("inputs/targets row mismatch")
        self._in_shape = self._inputs.shape[1:]
        self._tgt_shape = self._targets.shape[1:]
        in_row_bytes = self._inputs.dtype.itemsize * (
            int(np.prod(self._in_shape)) if self._in_shape else 1
        )
        tgt_row_bytes = self._targets.dtype.itemsize * (
            int(np.prod(self._tgt_shape)) if self._tgt_shape else 1
        )
        self.batch_size = batch_size
        self.labels_as_int = labels_as_int

        self._h = lib.hfb_create(
            self._inputs.ctypes.data_as(ctypes.c_void_p),
            self._targets.ctypes.data_as(ctypes.c_void_p),
            n,
            in_row_bytes,
            tgt_row_bytes,
            batch_size,
            seed,
            depth,
            num_threads,
            1 if drop_last else 0,
        )
        if not self._h:
            raise ValueError("invalid PrefetchLoader configuration")
        self.batches_per_epoch = int(lib.hfb_batches_per_epoch(self._h))

    @classmethod
    def from_npy(
        cls,
        inputs_path: str,
        targets_path: str,
        batch_size: int,
        **kwargs,
    ) -> "PrefetchLoader":
        """Build a loader over memory-mapped ``.npy`` files.

        The arrays are opened with ``mmap_mode="r"``: nothing is read until
        a producer thread gathers a row, so arbitrarily large datasets cost
        only page-cache residency.
        """
        inputs = np.load(inputs_path, mmap_mode="r")
        targets = np.load(targets_path, mmap_mode="r")
        return cls(inputs, targets, batch_size, **kwargs)

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        # fresh buffers per call: the C side copies straight into them, and
        # the caller owns the result (single copy end to end)
        x = np.empty((self.batch_size,) + self._in_shape, self._inputs.dtype)
        y = np.empty((self.batch_size,) + self._tgt_shape, self._targets.dtype)
        seq = self._lib.hfb_next(
            self._h,
            x.ctypes.data_as(ctypes.c_void_p),
            y.ctypes.data_as(ctypes.c_void_p),
        )
        if seq < 0:
            raise RuntimeError("PrefetchLoader is shutting down")
        if self.labels_as_int and not np.issubdtype(y.dtype, np.integer):
            y = y.astype(np.int32)
        return x, y

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()

    def stop(self):
        """Signal shutdown WITHOUT freeing: any thread blocked in
        :meth:`next_batch` promptly gets the -1 sentinel (a
        ``RuntimeError``), and later calls fail the same way.  Safe to call
        from any thread while readers are in flight -- the native handle
        stays valid until :meth:`close`.  Owners with a reader thread should
        ``stop()``, join the reader, then ``close()``."""
        if getattr(self, "_h", None):
            self._lib.hfb_stop(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.hfb_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
