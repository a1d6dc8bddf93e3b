"""The whole step's share of the card's float32 peak in the traced window:
the FLOPs its steps need (``flops.py``, from shapes and the steps'
counters) over the window's time and the peak.  It bounds what any one
kernel's roofline share can claim."""


def read(run):
    if not run.steps:
        return None
    return 100 * run.flops / run.window_s / run.peaks["float32_flops_per_s"]
