"""Hand-made operands of the routed df kernels, shared by the CPU tests
(tests/test_torch_df_routed.py) and the card's (tests/test_torch_gpu.py):
C-df level 0 over K3's gather tiles, with the slots that tell its two kinds
of empty slot apart, and a one-tile level after it."""
import numpy as np
import torch

from spmv_openmp_cuda_tpu_torch.config import LANE

WINDOW = LANE * LANE


def level0_case(runs, n_real: int = 3, n_tiles: int = 5, n_x: int = 2 * WINDOW - 1000, seed: int = 0):
    """K3's operands (vals, vals_lo, pidx, widx: n_real gather tiles) and x
    (f64, n_x), and offsets (rows, 128) int32 into K3's n_tiles tiles of
    products for the slab rows runs cover: values with +0 and -0 among them
    (negative values where x is +0 or -0 give -0 products), columns past x's
    end (the last window is cut), offsets -1 and offsets into the pad tiles
    past n_real."""
    rng = np.random.default_rng(seed)
    rows = max(r0 + ng * w for r0, ng, w, _g0 in runs)
    vals = rng.standard_normal((n_real * LANE, LANE)).astype(np.float32)
    pick = rng.random(vals.shape)
    vals[pick < 0.2] = 0.0
    vals[pick < 0.05] = -0.0
    lo = (vals * np.float32(1e-8) * rng.standard_normal(vals.shape).astype(np.float32)).astype(np.float32)
    pidx = rng.integers(0, LANE, vals.shape).astype(np.int8)
    nwin = -(-n_x // WINDOW)
    widx = rng.integers(0, nwin, n_real).astype(np.int32)
    x = rng.standard_normal(n_x)
    px = rng.random(n_x)
    x[px < 0.15] = 0.0
    x[px < 0.05] = -0.0
    off = rng.permutation(n_tiles * WINDOW)[: rows * LANE].astype(np.int64)
    off[rng.random(off.shape) < 0.1] = -1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return {"vals": t(vals), "vals_lo": t(lo), "pidx": t(pidx), "widx": t(widx), "x": t(x),
            "off": t(off.astype(np.int32).reshape(rows, LANE)), "runs": tuple(runs),
            "n_tiles": n_tiles}


def closed_level_case(n_groups0: int, runs, seed: int = 1):
    """Offsets (rows <= 128, 128) int32 into n_groups0 * 128 (hi, lo) sums of
    the level before, -1 among them, and a 0/1 f32 mask, for a one-tile
    level of runs."""
    rng = np.random.default_rng(seed)
    rows = max(r0 + ng * w for r0, ng, w, _g0 in runs)
    assert rows <= LANE
    off = rng.integers(0, n_groups0 * LANE, (rows, LANE))
    off[rng.random(off.shape) < 0.1] = -1
    mask = (rng.random((rows, LANE)) < 0.8).astype(np.float32)
    return torch.from_numpy(off.astype(np.int32)), torch.from_numpy(mask)


#: level-0 runs (row0, n_groups, width, g0): one width, or several runs of
#: falling width over contiguous rows, groups of 128, 100 and 40 rows among
#: them
LEVEL0_RUNS = {
    "w3": ((0, 60, 3, 0),),
    "w16": ((0, 20, 16, 0),),
    "w128": ((0, 2, 128, 0),),
    "mixed": ((0, 1, 128, 0), (128, 1, 100, 1), (228, 1, 40, 2), (268, 4, 32, 3),
              (396, 20, 5, 7), (496, 50, 1, 27)),
}
#: one-tile level runs over level 0's sums: groups wider than 32 rows (split
#: into blocks of 32 by the kernel), then narrow ones
CLOSED_RUNS = ((0, 1, 70, 0), (70, 1, 40, 1), (110, 6, 3, 2))
