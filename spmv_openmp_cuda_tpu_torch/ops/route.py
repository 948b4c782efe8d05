"""Static Clos permutation routing: planning on the host (numpy).

Counterpart of the planning half of spmv_openmp_cuda_tpu/ops/route.py: the
bipartite edge coloring by Euler splitting (`_euler_split`,
`color_bipartite_pow2`), `pick_t`, `PlannedPermutation`,
`_stages_from_routing`, `plan_permutation` and `plan_row_to_slot`. The
coloring runs the native C++ router (io/native.py) when its library is
available; the numpy code is the JAX package's own fallback, verbatim, so
on the numpy path both packages pick the same colors and the same stage
arrays (the native router picks them too). The window engine's slot packing
(formats/window.py::_pack_coloring) uses the coloring too.

A planned bijection of an (H = T*128, 128) slot array is the stage chain

  R1 (lane perm) . W1 (in-tile sublane perm) . SW (row-grid swap)
  . W2 . SW^-1 . W3 . R3 (lane perm)

R stages permute the lanes of each row; W stages permute, for each lane,
the rows inside one 128-row tile; SW maps row t*128+s to s*T+t. The stages
are applied by the gather kernel of ops/routed_cuda.py, through one index map per
application composed from the stages at its first use (cached on the
plan).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import LANE
from ..formats.matrix import target_device


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
    Uses the native C++ Euler-split router when its library is available
    (io/native.py), the vectorized numpy implementation otherwise.
    """
    from ..io.native import color_bipartite_native

    e = left.shape[0]
    assert n_colors & (n_colors - 1) == 0
    out = color_bipartite_native(left, right, n_colors)
    if out is not None:
        return out
    cls = np.zeros(e, dtype=np.int64)
    bits = int(np.log2(n_colors))
    for _ in range(bits):
        bit = _euler_split(left, right, cls)
        cls = cls * 2 + bit
    return cls


def pick_t(rows: int) -> int:
    """Smallest power-of-two tile count T <= 128 with T*128 >= rows."""
    t = 1
    while t * LANE < rows:
        t *= 2
    if t > LANE:
        raise ValueError(f"{rows} rows exceed the {LANE * LANE}-row domain")
    return t


@dataclasses.dataclass
class PlannedPermutation:
    """Stage index arrays (all (T*128, 128) int8 tensors, values < 128).

    r1 is None when the source lane assignment was folded into the producer
    (plan_row_to_slot): elements are emitted directly in their middle lane.
    wc is the single-tile composition w1.w2.w3 (SW stages are identity when
    t == 1), letting callers apply the whole permutation as r1 . wc . r3 in
    one kernel; None for t > 1. maps caches the composed index maps of
    ops/routed_cuda.py::plan_map (not a stage array: a new plan starts
    empty, dataclasses.replace included).
    """

    r1: Optional[torch.Tensor]
    w1: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    r3: torch.Tensor
    wc: Optional[torch.Tensor] = None
    t: int = LANE
    maps: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def h(self) -> int:
        return self.t * LANE


def _stages_from_routing(hs, hd, ld, m, t: int, with_r1, ls=None, *, device):
    """Common stage-array construction given the big coloring m."""
    h = t * LANE
    ts, ss = hs // LANE, hs % LANE
    td, sd = hd // LANE, hd % LANE
    # per-lane colorings over (src tile -> dst tile): exactly 128-regular
    # per (m, tile) node — all lanes colored in one call
    sigma = color_bipartite_pow2(m * t + ts, m * t + td, LANE)

    # stage index arrays, gather semantics out[i, j] = in[i, idx[i, j]]
    r1 = None
    if with_r1:
        r1 = np.empty((h, LANE), dtype=np.int8)
        r1[hs, m] = ls
    # W1: within tile ts, lane m: sublane ss -> sigma. Rows of the stage
    # array = tile*128 + lane m: out[m, sigma] = in[m, ss]
    w1 = np.empty((h, LANE), dtype=np.int8)
    w1[ts * LANE + m, sigma] = ss
    # SW: (ts, sigma) -> row sigma*T + ts; runs of T stay inside one
    # 128-row tile because T | 128
    mid = lambda sg, tt: sg * t + tt  # noqa: E731  row in the swapped grid
    w2 = np.empty((h, LANE), dtype=np.int8)
    w2[(mid(sigma, td) // LANE) * LANE + m, mid(sigma, td) % LANE] = (
        mid(sigma, ts) % LANE
    )
    # SW^-1: -> row td*128 + sigma
    w3 = np.empty((h, LANE), dtype=np.int8)
    w3[td * LANE + m, sd] = sigma
    # R3: out[hd, ld] = in[hd, m]
    r3 = np.empty((h, LANE), dtype=np.int8)
    r3[hd, ld] = m
    wc = None
    if t == 1:
        # SW stages are identity: compose the three sublane perms into one
        # (gathers chain right-to-left: out[m, j] = in[m, w1[m, w2[m, w3[m, j]]]])
        rows_ = np.arange(LANE)[:, None]
        wc = w1[rows_, w2[rows_, w3.astype(np.int64)].astype(np.int64)]

    def dev(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return PlannedPermutation(
        r1=dev(r1), w1=dev(w1), w2=dev(w2), w3=dev(w3), r3=dev(r3), wc=dev(wc), t=t
    )


def plan_permutation(
    dst_of: np.ndarray, t: Optional[int] = None, device="cuda"
) -> PlannedPermutation:
    """Plan the bijection slot -> dst_of[slot] on an (H=T*128, 128) domain,
    the stage arrays on `device` (the card unless the caller passes
    device="cpu").

    Slots are flat ids row*128 + lane; dst_of must be a permutation of
    arange(H*128). T (power of two <= 128) defaults to the smallest domain
    that fits.
    """
    device = target_device(device)
    n = dst_of.shape[0]
    if t is None:
        t = pick_t(n // LANE)
    h = t * LANE
    assert n == h * LANE, (n, h)
    src = np.arange(n, dtype=np.int64)
    hs, ls = src // LANE, src % LANE
    hd, ld = dst_of // LANE, dst_of % LANE
    # middle lane: big coloring over (src row -> dst row); exactly
    # 128-regular since dst_of is a bijection on full rows
    m = color_bipartite_pow2(hs, hd, LANE)
    return _stages_from_routing(hs, hd, ld, m, t, with_r1=True, ls=ls, device=device)


def plan_row_to_slot(
    src_row: np.ndarray, dst_of: np.ndarray, t: int, device="cuda"
) -> Tuple[PlannedPermutation, np.ndarray]:
    """Plan a routing where each element has a fixed source ROW but a free
    source lane (the producer can emit into any lane, e.g. the gather phase's
    slot packing). Returns (plan with r1 folded away, src_lane per element):
    the producer must place element i at (src_row[i], src_lane[i]).

    src_row must list each row of the (T*128)-row domain exactly 128 times;
    dst_of must be a bijection onto the domain's slots. The plan's arrays are
    on `device` (the card unless the caller passes device="cpu").
    """
    device = target_device(device)
    h = t * LANE
    assert src_row.shape[0] == h * LANE
    hd, ld = dst_of // LANE, dst_of % LANE
    m = color_bipartite_pow2(src_row, hd, LANE)
    plan = _stages_from_routing(src_row, hd, ld, m, t, with_r1=False, device=device)
    return plan, m
