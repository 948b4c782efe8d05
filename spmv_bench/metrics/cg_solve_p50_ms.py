"""cg_solve_p50_ms: the median time of the window's solves (host clock),
beside cg_solve_ms's mean: steadier, since a few solves in a window take
two to three times the others (see PERF.md)."""

import numpy as np


def read(run):
    s = run.window.solve_s
    if s is None or not len(s):
        return None
    return float(np.median(s)) * 1e3
