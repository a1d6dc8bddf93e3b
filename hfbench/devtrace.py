"""The device's side of a traced window: ``torch.profiler`` with CUDA
activity only (host events of a whole step would take the profiler minutes
to process), reduced to kernel and copy intervals."""

from __future__ import annotations

import collections
import time
from typing import Dict, List, NamedTuple, Tuple


class DeviceOp(NamedTuple):
    name: str
    start: float  # seconds from the trace's start
    end: float


class Profile:
    """Profiles the block; afterwards ``ops`` holds every device operation
    with its interval on the host's ``perf_counter`` clock (the trace's
    wall-clock stamps shifted by the offset between the two clocks), and
    ``read_s`` the seconds it took to stop the profiler and read them.
    ``cuda=False`` (a rehearsal on the CPU) takes the CPU's operators as
    the device's."""

    def __init__(self, cuda=True):
        self.cuda = cuda

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[
            ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        start = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        offset = time.time() - time.perf_counter()
        kind = (torch.autograd.DeviceType.CUDA if self.cuda
                else torch.autograd.DeviceType.CPU)
        # the raw events: building the profiler's FunctionEvents for a
        # window of a million kernels would take minutes
        self.ops = sorted(
            (DeviceOp(e.name(), e.start_ns() / 1e9 - offset,
                      (e.start_ns() + e.duration_ns()) / 1e9 - offset)
             for e in self._prof.profiler.kineto_results.events()
             if e.device_type() == kind),
            key=lambda op: op.start)
        del self._prof
        self.read_s = time.perf_counter() - start
        return False


def busy_intervals(ops: List[DeviceOp]) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, in order."""
    out: List[Tuple[float, float]] = []
    for op in ops:
        if out and op.start <= out[-1][1]:
            if op.end > out[-1][1]:
                out[-1] = (out[-1][0], op.end)
        else:
            out.append((op.start, op.end))
    return out


def busy_seconds(ops: List[DeviceOp]) -> float:
    return sum(b - a for a, b in busy_intervals(ops))


def top_ops(ops: List[DeviceOp], k: int = 10) -> List[list]:
    """The ``k`` operation names that took most device time, with seconds."""
    total: Dict[str, float] = collections.defaultdict(float)
    for op in ops:
        total[op.name[:120]] += op.end - op.start
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def idle_by_span(ops: List[DeviceOp], window: Tuple[float, float],
                 spans, k: int = 10) -> List[list]:
    """The device's idle time in the window, summed by the innermost host
    span open at each gap's middle; the ``k`` largest sums."""
    gaps, last = [], window[0]
    for a, b in busy_intervals(ops):
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if window[1] > last:
        gaps.append((last, window[1]))
    total: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        label, depth = "outside any span", -1
        for s in spans:
            if s.start <= mid <= s.end and s.depth > depth:
                label, depth = s.name, s.depth
        total[label] += b - a
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

