"""Curvature matvec: the median milliseconds of one call of the linearized
matvec closure that the build returns (one CG iteration's product, before
damping)."""

import statistics


def read(run):
    times = [s.end - s.start for s in run.spans if s.name == "matvec"]
    if not times:
        return None
    return 1e3 * statistics.median(times)
