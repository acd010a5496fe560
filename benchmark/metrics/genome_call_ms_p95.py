"""genome_call_ms_p95: the 95th percentile of the wall of every call in
the window, ms (closed loop, one caller)."""

import numpy as np


def read(run):
    return float(np.percentile([1e3 * (b - a) for a, b, _w in run.calls],
                               95))
