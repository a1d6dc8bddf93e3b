"""Accumulation: the median milliseconds of one accumulated matvec
(``accumulate.py``'s one-shot ``ggnvp`` over each curvature chunk)."""

import statistics


def read(run):
    times = [s.end - s.start for s in run.spans if s.name == "acc_matvec"]
    if not times:
        return None
    return 1e3 * statistics.median(times)
