"""CG: iterations per step, from the optimizer's own count
(``HFStats.num_cg_iters``)."""


def read(run):
    if not run.records:
        return None
    return sum(r["num_cg_iters"] for r in run.records) / len(run.records)
