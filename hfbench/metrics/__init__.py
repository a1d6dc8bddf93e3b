"""Per-layer metrics, one reader each: ``read(run)`` returns the metric's
value, or ``None`` where the run holds nothing to read.  ``run`` carries the
traced window: ``spans`` (:mod:`..spans`), ``ops`` (device operations,
:mod:`..devtrace`), ``busy_s``, ``window_s``, ``steps``, ``records`` (each
window step's counters from the optimizer's history), ``flat_dim`` and
``itemsize`` (the CG vectors'), ``flops`` (the window's, ``flops.py``) and
``peaks`` (``peaks.json``'s row for the card)."""
