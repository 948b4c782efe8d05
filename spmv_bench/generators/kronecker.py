"""Graph500's Kronecker graph as a symmetric sparse matrix.

The generator of the Graph500 specification (its Octave listing,
`kronecker_generator`): 2^scale vertices, edgefactor x 2^scale edges, each
edge placed by `scale` recursive choices of a quadrant with the initiator
probabilities A, B, C (D = 1 - A - B - C), then the vertex labels permuted
at random. The graph is undirected: its matrix holds (i, j) and (j, i) for
every edge, self-loops and repeated edges dropped. Each undirected edge
carries one weight uniform in [0, 1), drawn from the run's seed, as
Graph500's SSSP kernel weights its edges; both of its entries hold it.
"""
from __future__ import annotations

import numpy as np
import torch


def edges(rng, scale: int, edgefactor: int, a: float, b: float, c: float):
    """The specification's edge list (start, end), 0-based, vertex labels
    permuted (the final shuffle of the list's order is left out: the
    matrix does not depend on it)."""
    n = 1 << scale
    m = edgefactor * n
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ij = np.zeros((2, m), dtype=np.int64)
    for ib in range(scale):
        ii = rng.random(m) > ab
        jj = rng.random(m) > np.where(ii, c_norm, a_norm)
        ij[0] += ii.astype(np.int64) << ib
        ij[1] += jj.astype(np.int64) << ib
    return rng.permutation(n)[ij]


def pattern(structure_seed: int, scale: int, edgefactor: int, a: float, b: float, c: float):
    rng = np.random.default_rng(structure_seed)
    n = 1 << scale
    i, j = edges(rng, scale, edgefactor, a, b, c)
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    keep = lo != hi
    upper = np.unique(lo[keep] * n + hi[keep])  # one key per undirected edge
    ur, uc = upper // n, upper % n
    keys = np.concatenate([upper, uc * n + ur])
    edge = np.concatenate([np.arange(upper.size), np.arange(upper.size)])
    order = np.argsort(keys)
    keys, edge = keys[order], edge[order]

    def values(gen: torch.Generator, dtype: torch.dtype, device) -> torch.Tensor:
        w = torch.rand(upper.size, generator=gen, device=device, dtype=dtype)
        return w[torch.from_numpy(edge).to(device)]

    return (n, n), keys // n, keys % n, values
