"""spmv_sync_p95_us: the 95th percentile of the window's synchronous
products, each timed on the host clock from its call to the synchronize's
return (a tail of ~100 us samples: steadier as a shape than as a bound)."""

import numpy as np


def read(run):
    s = run.window.sync_s
    if s is None or len(s) < 200:
        return None
    return float(np.percentile(s, 95)) * 1e6
