"""host_us_per_call: the median host time from entering AutoSpMV.__call__
to its return, over the window's synchronous products (host clock)."""

import numpy as np


def read(run):
    c = run.window.call_s
    if c is None or not len(c):
        return None
    return float(np.median(c)) * 1e6
