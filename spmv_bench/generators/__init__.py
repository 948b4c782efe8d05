"""Sparsity patterns of the benchmark's configurations.

Kept here, apart from the program, so that a change to the program cannot
change the matrices it is measured on. Each module exposes
`pattern(structure_seed, **params)`, which returns (shape, rows, cols,
vals): the pattern sorted by (row, col) without duplicates, and its values:
the fixed values of a stencil, None where they are N(0, 1) drawn from the
run's seed, or a function `vals(generator, dtype, device)` that draws them
from the run's seed in a distribution of the generator's own.
"""
from __future__ import annotations

import importlib

import numpy as np


def load(name: str):
    """The generator module `generators/<name>.py`."""
    return importlib.import_module(f"{__name__}.{name}")


def sort_pattern(shape, rows, cols, vals=None):
    """(rows, cols, vals) sorted by (row, col), duplicates summed: the
    port's `sort_coo` as of the benchmark's first version."""
    n = shape[1]
    keys = rows.astype(np.int64) * n + cols
    order = np.argsort(keys, kind="stable")
    rows, cols, keys = rows[order], cols[order], keys[order]
    vals = None if vals is None else vals[order]
    uniq, inv = np.unique(keys, return_inverse=True)
    if uniq.shape[0] != keys.shape[0]:
        if vals is not None:
            summed = np.zeros(uniq.shape[0], dtype=vals.dtype)
            np.add.at(summed, inv, vals)
            vals = summed
        rows = (uniq // n).astype(rows.dtype)
        cols = (uniq % n).astype(cols.dtype)
    return rows, cols, vals
