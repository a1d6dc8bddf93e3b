"""Selection: milliseconds per step in ``ops/select.py``'s CG backtracking
and Armijo line search, their trial losses included."""


def read(run):
    times = [s.end - s.start for s in run.spans if s.name == "select"]
    if not times:
        return None
    return 1e3 * sum(times) / run.steps
