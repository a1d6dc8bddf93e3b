"""Curvature build: milliseconds per step inside
``optimizer._build_matvec_and_grad`` (the loss, the gradient and the
``linearize`` trace of one batch, ``ops/curvature.py``)."""


def read(run):
    times = [s.end - s.start for s in run.spans if s.name == "build"]
    if not times:
        return None
    return 1e3 * sum(times) / run.steps
