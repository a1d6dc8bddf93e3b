"""Device-transfer prefetching: overlap host->device copies with compute
(port of :mod:`pytorchhessianfree_tpu.runtime.prefetch`).

The native batcher (``csrc/batcher.cpp``) overlaps batch *assembly* with
device execution; this module overlaps the remaining host->device transfer
too.  A background thread pulls batches from any iterator (typically a
:class:`~.loader.PrefetchLoader`), copies each numpy leaf into a freshly
pinned host tensor, issues ``.to(device, non_blocking=True)`` on a CUDA
stream of its own, records an event, and parks the device tensors with the
event in a bounded queue.  While the step for batch *k* runs on the card,
batch *k+1*'s copy is already in flight: consuming a batch is a queue pop,
after which the consumer's current stream waits on the copy's event (on the
device, not the host) and each tensor is marked with ``record_stream`` so
the caching allocator does not hand its memory back before the consumer's
work on it has run.

Pinned buffers are allocated per batch, never reused by the worker: a
buffer rewritten while its ``non_blocking`` copy is in flight would corrupt
a batch without an error.

The reference's pipeline is torch ``DataLoader`` workers + a blocking
``.to(device)`` per batch inside the train loop
(reference examples/run_allcnnc_cifar100_deepobs.py:55-60).  On
``device="cpu"`` a leaf becomes a plain ``torch.from_numpy`` tensor.

With a ``sharding`` (:func:`~..parallel.mesh.batch_sharding`), a
data-parallel rank keeps only its own rows of each global batch, cut from
the host arrays before the pinned copy, so that each rank copies only its
share to its card.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..utils.flatten import tree_flatten, tree_map


def _is_shutdown_unblock(e: BaseException) -> bool:
    """True for exceptions that are the EXPECTED way a blocked source read
    gets unblocked by shutdown: the ``PrefetchLoader`` -1 sentinel
    (``RuntimeError("PrefetchLoader is shutting down")``,
    loader.py::next_batch), a closed generator, or an exhausted iterator.
    Anything else racing ``close()`` is a real source error."""
    if isinstance(e, (GeneratorExit, StopIteration)):
        return True
    return isinstance(e, RuntimeError) and "shutting down" in str(e)


def _host_tensor(leaf):
    """A numpy leaf as a tensor sharing its memory (copied first if the
    array is read-only, e.g. a memmap); tensors and other leaves pass."""
    if isinstance(leaf, np.ndarray):
        if not leaf.flags.writeable:
            leaf = leaf.copy()
        return torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf


class DevicePrefetcher:
    """Iterator adaptor: batches arrive already resident on the device.

    Args:
        source: iterator yielding trees (dicts, lists, tuples) of numpy
            arrays or host tensors (e.g. a ``PrefetchLoader``, or any
            generator of ``(inputs, targets)``).
        depth: number of batches transferred ahead (queue bound).  2 is
            enough to hide the transfer behind any step that outlasts it.
        device: ``"cuda"`` (the default without ``sharding``; raises if
            there is no CUDA device) or ``"cpu"`` (plain
            ``torch.from_numpy``, for tests and CPU runs); with
            ``sharding``, the rank's device by default.  Nothing falls back
            from the card to the CPU.
        n_batches: stop after this many batches (``None`` = run until the
            source is exhausted or :meth:`close` is called).  Useful for
            epoch-bounded loops over the endless ``PrefetchLoader`` stream.
        close_source: if True, :meth:`close` also calls ``source.close()``
            (ownership transfer) -- so e.g. a ``PrefetchLoader``'s native
            threads and mmap handles are released with the prefetcher
            instead of lingering until GC.
        sharding: a :class:`~..parallel.mesh.Sharding`
            (:func:`~..parallel.mesh.batch_sharding` or
            :func:`~..parallel.mesh.replicated`): each batch arrives as
            this rank's rows, on the rank's device.
    """

    _SENTINEL = object()

    def __init__(
        self,
        source: Iterator[Any],
        depth: int = 2,
        device: Any = None,
        n_batches: Optional[int] = None,
        close_source: bool = False,
        sharding: Optional[Any] = None,
    ):
        if depth < 1:
            raise ValueError(f"Invalid depth {depth}")
        self._take = None
        if sharding is not None:
            from ..parallel.distributed import rank_device
            from ..parallel.mesh import Sharding

            if not isinstance(sharding, Sharding):
                raise TypeError(
                    "DevicePrefetcher: sharding must be a parallel.mesh."
                    f"Sharding (batch_sharding / replicated), not {sharding!r}"
                )
            self._take = sharding.take
            if device is None:
                device = rank_device()
        self.device = torch.device("cuda" if device is None else device)
        self._stream = None
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DevicePrefetcher: device='cuda' but no CUDA device is "
                    "available; pass device='cpu' to stay on the CPU."
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(device=self.device)
        elif self.device.type != "cpu":
            raise ValueError(f"DevicePrefetcher: unsupported device {device}")
        self._source = source
        self._close_source = close_source
        self._n_batches = n_batches
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._err_tb = None  # traceback at capture time (re-raise anchor)
        self._done = False  # sentinel consumed -> StopIteration forever
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that aborts promptly on close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _transfer(self, batch):
        """``(device tree, copy event or None)`` for one host batch (this
        rank's rows of it with a sharding)."""
        if self._take is not None:
            batch = tree_map(self._take, batch)
        host = tree_map(_host_tensor, batch)
        if self._stream is None:
            return host, None

        def to_device(leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            # a fresh pinned buffer per leaf and batch: the copy below is
            # asynchronous, so a reused buffer could be overwritten while
            # in flight (the pinned allocator keeps a freed buffer until
            # the copy's stream has passed it)
            return leaf.pin_memory().to(self.device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            dev = tree_map(to_device, host)
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev, event

    def _worker(self):
        count = 0
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                if not self._put(self._transfer(batch)):
                    return
                count += 1
                if self._n_batches is not None and count >= self._n_batches:
                    break
        except BaseException as e:  # surfaced on the consumer side
            if self._stop.is_set() and _is_shutdown_unblock(e):
                # close() raced the read: a source unblocked by shutdown
                # (PrefetchLoader.stop() turning hfb_next into the -1
                # sentinel, or a generator closed under us) is a clean
                # stop, not a sticky stream error.  A GENUINE source error
                # (corrupt data, I/O failure) that merely coincides with
                # close() is still recorded so post-mortems see it via
                # ``.error`` -- silently reclassifying it as clean shutdown
                # would hide real failures.
                return
            self._err = e
            self._err_tb = e.__traceback__
        finally:
            self._put(self._SENTINEL)

    def _raise_err(self):
        """Re-raise the sticky source error.  The traceback is reset to the
        one captured in the worker on EVERY raise -- re-raising a shared
        exception instance otherwise appends the consumer's frames to its
        ``__traceback__`` on each poll, growing it without bound."""
        raise self._err.with_traceback(self._err_tb)

    def _deliver(self, item):
        """Order the consumer's stream after the batch's copy, and tie the
        device memory's lifetime to that stream."""
        dev, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for leaf in tree_flatten(dev)[0]:
                if isinstance(leaf, torch.Tensor):
                    leaf.record_stream(current)
        return dev

    def __iter__(self):
        return self

    def __next__(self):
        # Already-transferred batches are delivered BEFORE any source error
        # is surfaced (the error arrives in stream order, at the point the
        # source actually failed).  A source error is sticky: EVERY
        # subsequent __next__ re-raises it (and it stays readable via
        # :attr:`error`), so a failed stream can never be mistaken for a
        # cleanly exhausted one.
        if self._done:
            if self._err is not None:
                self._raise_err()
            raise StopIteration
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    # close() raced the worker: surface a stored source
                    # error NOW (never after a StopIteration was already
                    # raised -- the failure must not look like clean
                    # exhaustion even transiently).
                    self._done = True
                    if self._err is not None:
                        self._raise_err()
                    raise StopIteration
                continue
            if item is self._SENTINEL:
                self._done = True
                if self._err is not None:
                    self._raise_err()
                raise StopIteration
            return self._deliver(item)

    @property
    def error(self) -> Optional[BaseException]:
        """The source exception, if the background stream failed (also
        re-raised by every ``__next__`` after it surfaces).  Check after
        :meth:`close` to distinguish a failed stream from an exhausted one
        when the consumer stopped early."""
        return self._err

    def close(self):
        """Stop the background thread and release queued buffers (and the
        source too, with ``close_source=True``)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._close_source:
            # Unblock a worker parked inside the source's blocking read
            # BEFORE joining: PrefetchLoader.stop() (native hfb_stop) wakes
            # a thread blocked in hfb_next with the -1 sentinel while
            # keeping the handle valid, so the join below succeeds promptly
            # and the destroy afterwards frees nothing still in use.
            stop = getattr(self._source, "stop", None)
            if callable(stop):
                try:
                    stop()
                except Exception:
                    pass
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        if self._close_source:
            if self._thread.is_alive():
                # No stop() hook (or it didn't help) and the worker is
                # still inside the source.  Freeing native handles under a
                # blocked reader would be a use-after-free; leave the
                # source to its own __del__/GC path instead.
                warnings.warn(
                    "DevicePrefetcher.close(): worker thread did not stop "
                    "within 5s; skipping source.close() to avoid freeing "
                    "native handles still in use",
                    RuntimeWarning,
                    stacklevel=2,
                )
            else:
                close = getattr(self._source, "close", None)
                if close is not None:
                    close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
