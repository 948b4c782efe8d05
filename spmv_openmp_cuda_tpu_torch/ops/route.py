"""Bipartite edge coloring by Euler splitting (host, numpy).

Counterpart of the coloring core of spmv_openmp_cuda_tpu/ops/route.py
(`_euler_split`, `color_bipartite_pow2`): the window engine's slot packing
(formats/window.py::_pack_coloring) colors the (out-lane x source-residue)
multigraph of each row block with it. The numpy implementation is the JAX
package's own fallback, verbatim, so both packages pick the same colors.
The Clos permutation plan of that module belongs to the routed engine and
is not here yet.
"""
from __future__ import annotations

import numpy as np


def _euler_split(left: np.ndarray, right: np.ndarray, cls: np.ndarray) -> np.ndarray:
    """One Euler-split level: within each color class (even-regular bipartite
    multigraph), 2-color edges so every (node, class) sees an exact half
    split. Returns the new bit (0/1) per edge. Vectorized: pair incident
    edge-slots per (class, node), walk the alternating pairing cycles by
    pointer jumping."""
    e = left.shape[0]
    # pair consecutive edges per (class, left-node): L involution
    # (single-key stable argsort beats lexsort)
    nl = int(left.max()) + 1 if e else 1
    order_l = np.argsort(cls * nl + left, kind="stable")
    lpair = np.empty(e, dtype=np.int64)
    a, b = order_l[0::2], order_l[1::2]
    lpair[a], lpair[b] = b, a
    # pair per (class, right-node): R involution
    nr = int(right.max()) + 1 if e else 1
    order_r = np.argsort(cls * nr + right, kind="stable")
    rpair = np.empty(e, dtype=np.int64)
    a, b = order_r[0::2], order_r[1::2]
    rpair[a], rpair[b] = b, a
    # orbits of m = lpair(rpair(.)) are exactly the same-color classes of the
    # alternating cycle; e and rpair(e) get opposite colors.
    m = lpair[rpair]
    # pointer-jumped orbit minimum
    f = m.copy()
    val = np.arange(e, dtype=np.int64)
    steps = max(1, int(np.ceil(np.log2(max(e, 2)))))
    for _ in range(steps):
        val = np.minimum(val, val[f])
        f = f[f]
    # color: my orbit-min vs my R-partner's orbit-min (the two orbits of the
    # cycle); deterministic tie-free since orbits are disjoint edge sets
    return (val < val[rpair]).astype(np.int8)


def color_bipartite_pow2(
    left: np.ndarray, right: np.ndarray, n_colors: int
) -> np.ndarray:
    """Proper n_colors-edge-coloring (n_colors a power of two) of a bipartite
    multigraph that is exactly n_colors-regular on every node that appears.

    Edges sharing a left node get distinct colors, likewise right nodes.
    """
    e = left.shape[0]
    assert n_colors & (n_colors - 1) == 0
    cls = np.zeros(e, dtype=np.int64)
    bits = int(np.log2(n_colors))
    for _ in range(bits):
        bit = _euler_split(left, right, cls)
        cls = cls * 2 + bit
    return cls
