"""CG vector phase: the share of its memory bound that the hand-written
kernel K1 (``ops/cg_update.py`` over ``csrc/fused_cg_update.cu``) reaches
in the traced window.  The bound of one launch is its five vectors read
and two written once, ``7 n`` entries, over the card's memory rate; the
time is the profiler's mean device time per launch."""


def read(run):
    times = [op.end - op.start for op in run.ops
             if "fused_cg_update_kernel" in op.name]
    if not times:
        return None
    bound = 7 * run.itemsize * run.flat_dim / run.peaks["hbm_bytes_per_s"]
    return 100 * bound / (sum(times) / len(times))
