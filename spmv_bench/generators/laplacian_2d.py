"""The 5-point Laplacian of a grid x grid mesh (PETSc ksp tutorial ex2's
operator): 4 on the diagonal, -1 to each grid neighbour, grid^2 rows and
5 grid^2 - 4 grid nonzeros, symmetric positive definite. A frozen copy of
the port's `utils/synth.py::laplacian_2d`; the structure seed is unused.
"""
from __future__ import annotations

import numpy as np

from . import sort_pattern


def pattern(structure_seed: int, grid: int):
    del structure_seed  # the stencil has one pattern
    idx = np.arange(grid * grid).reshape(grid, grid)
    pairs = [(idx, idx, 4.0)]
    for a, b in ((idx[:, :-1], idx[:, 1:]), (idx[:-1, :], idx[1:, :])):
        pairs += [(a, b, -1.0), (b, a, -1.0)]
    r = np.concatenate([a.ravel() for a, _, _ in pairs])
    c = np.concatenate([b.ravel() for _, b, _ in pairs])
    v = np.concatenate([np.full(a.size, w) for a, _, w in pairs])
    shape = (grid * grid, grid * grid)
    r, c, v = sort_pattern(shape, r, c, v)
    return shape, r, c, v
