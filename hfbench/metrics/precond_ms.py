"""Preconditioner: milliseconds per step of
``HessianFree.get_preconditioner`` (``ops/precond.py``'s per-sample
gradients on the curvature chunks) and its moving average."""


def read(run):
    times = [s.end - s.start for s in run.spans if s.name == "precond"]
    if not times:
        return None
    return 1e3 * sum(times) / run.steps
