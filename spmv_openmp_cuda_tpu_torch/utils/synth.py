"""Synthetic sparse matrix generators.

The reference benchmarks against a SuiteSparse corpus (doc/relazione.tex:
460-463) that cannot be fetched here (zero egress); these generators produce
matrices with the structural regimes that corpus spans — uniform random,
banded (structured-grid FEM), unstructured-FEM locality (scattered offsets
inside a bounded window), and power-law/graph (skewed row lengths, the
regime where ELL padding explodes and scheduling matters).

Honesty contract for the benchmark proxies (PRESETS): dims and nnz match the
real matrices EXACTLY (SuiteSparse published values), and the structure class
matches what the real matrix actually is. In particular thermal2 and
FEM_3D_thermal2 are unstructured FEM meshes — their nnz sit at thousands of
DISTINCT (col - row) offsets scattered inside a locality window, NOT on a few
dense diagonals — so `fem_like` proxies are NOT DIA-eligible and exercise the
general engines, exactly like the real matrices would. See doc/PROXIES.md for
the per-proxy structure audit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..formats.matrix import COOMatrix
from ..formats.convert import sort_coo


def _reflect(c: np.ndarray, n: int) -> np.ndarray:
    """Reflect out-of-range column indices back into [0, n) (mesh boundary
    rows simply have their distant neighbors folded inward)."""
    c = np.abs(c)
    return np.where(c >= n, 2 * (n - 1) - c, c)


def _draw_offsets(size: int, spread: int, rng) -> np.ndarray:
    """Log-uniform |offset| in [1, spread), random sign: most neighbors sit
    near the diagonal, with a realistic tail of distant ones (unstructured
    mesh numbering)."""
    mag = np.floor(np.exp(rng.random(size) * np.log(spread))).astype(np.int64)
    sign = rng.integers(0, 2, size=size) * 2 - 1
    return mag * sign


def _exact_pattern(
    m: int,
    n: int,
    rows: np.ndarray,
    cols: np.ndarray,
    target: int,
    rng,
    spread: Optional[int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Dedup (r, c) pairs, top up with fresh draws until >= target distinct
    entries, then trim random off-diagonal entries to hit target EXACTLY.

    Fixes the round-1 flaw where duplicate draws collapsed in sort_coo and
    proxies silently lost nnz vs the real matrix (e.g. caida 805k of 1.22M).
    spread bounds top-up offsets (locality preserved); None = uniform columns.
    """
    assert m * n < 2**62, "key space overflow"
    key = np.unique(rows.astype(np.int64) * n + cols.astype(np.int64))
    for round_ in range(24):
        if key.shape[0] >= target:
            break
        # escalate draws: concentrated offset distributions mostly re-hit
        # occupied slots when the free capacity is thin
        need = int((target - key.shape[0]) * (1.4 + round_)) + 16
        r = rng.integers(0, m, size=need)
        if spread is None:
            c = rng.integers(0, n, size=need)
        else:
            c = _reflect(r + _draw_offsets(need, spread, rng), n)
        key = np.unique(np.r_[key, r * n + c])
    if key.shape[0] < target:
        raise RuntimeError(f"could not reach {target} distinct entries")
    if key.shape[0] > target:
        off_diag = np.flatnonzero(key // n != key % n)
        drop = rng.choice(off_diag, size=key.shape[0] - target, replace=False)
        key = np.delete(key, drop)
    return key // n, key % n


def random_uniform(
    m: int, n: int, density: float, seed: int = 0, val_scale: float = 1.0,
    exact_nnz: Optional[int] = None,
) -> COOMatrix:
    """Uniform random sparsity (Erdos-Renyi style)."""
    rng = np.random.default_rng(seed)
    nnz_target = exact_nnz if exact_nnz is not None else int(m * n * density)
    rows = rng.integers(0, m, size=nnz_target)
    cols = rng.integers(0, n, size=nnz_target)
    if exact_nnz is not None:
        rows, cols = _exact_pattern(m, n, rows, cols, exact_nnz, rng, None)
    vals = rng.standard_normal(rows.shape[0]) * val_scale
    return sort_coo(COOMatrix((m, n), rows, cols, vals))


def banded(
    m: int, n: int, bandwidth: int, fill: float = 1.0, seed: int = 0,
    val_scale: float = 1.0, exact_nnz: Optional[int] = None,
) -> COOMatrix:
    """Banded matrix (structured-grid FEM/solid locality): nnz within
    +-bandwidth of the diagonal, each present with probability `fill`.
    exact_nnz trims/tops up (top-up within +-2*bandwidth) to the exact
    count."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 2 * bandwidth + 1)
    c = r + np.tile(np.arange(-bandwidth, bandwidth + 1), m)
    ok = (c >= 0) & (c < n)
    r, c = r[ok], c[ok]
    if fill < 1.0:
        keep = rng.random(r.shape[0]) < fill
        r, c = r[keep], c[keep]
    if exact_nnz is not None:
        r, c = _exact_pattern(m, n, r, c, exact_nnz, rng, 2 * bandwidth)
    vals = rng.standard_normal(r.shape[0]) * val_scale
    return sort_coo(COOMatrix((m, n), r, c, vals))


def fem_like(
    m: int, n: int, nnz: int, spread: int, lo: int, hi: int,
    row_std_frac: float = 0.15, seed: int = 0, val_scale: float = 1.0,
) -> COOMatrix:
    """Unstructured-FEM-mesh proxy: every row has its diagonal plus
    scattered neighbors at log-uniform offsets within +-spread.

    This is the structure class of the real thermal2 / FEM_3D_thermal2
    (SuiteSparse): near-constant row lengths in [lo, hi], nnz at thousands
    of distinct (col - row) offsets — DIA's dense-diagonal materialization
    is infeasible (offset count >> nnz/m), unlike round 1's idealized
    perfect bands. nnz is matched exactly.
    """
    rng = np.random.default_rng(seed)
    avg = nnz / m
    k = np.clip(
        np.rint(rng.normal(avg, avg * row_std_frac, size=m)), lo, hi
    ).astype(np.int64)
    draws = np.ceil(np.maximum(k - 1, 0) * 1.12).astype(np.int64) + 1
    rows_d = np.repeat(np.arange(m), draws)
    cols_d = _reflect(rows_d + _draw_offsets(rows_d.shape[0], spread, rng), n)
    diag = np.arange(min(m, n))
    rows_all = np.r_[diag, rows_d]
    cols_all = np.r_[diag, cols_d]
    r, c = _exact_pattern(m, n, rows_all, cols_all, nnz, rng, spread)
    vals = rng.standard_normal(r.shape[0]) * val_scale
    return sort_coo(COOMatrix((m, n), r, c, vals))


def power_law(
    m: int, n: int, avg_nnz_per_row: float, alpha: float = 1.5, seed: int = 0,
    max_row_nz: Optional[int] = None, val_scale: float = 1.0,
    exact_nnz: Optional[int] = None,
) -> COOMatrix:
    """Skewed row lengths ~ Zipf (caidaRouterLevel/webbase-style graphs).

    This is the regime where the reference's ELL size cap triggers and where
    dynamic scheduling / row binning pays off. exact_nnz tops up duplicate
    column draws so the distinct-entry count matches the real matrix.
    """
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=m).astype(np.float64)
    raw *= avg_nnz_per_row * m / raw.sum()
    lens = np.maximum(1, raw.astype(np.int64))
    cap = max_row_nz if max_row_nz is not None else n
    lens = np.minimum(lens, cap)
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, n, size=int(lens.sum()))
    if exact_nnz is not None:
        rows, cols = _exact_pattern(m, n, rows, cols, exact_nnz, rng, None)
    vals = rng.standard_normal(rows.shape[0]) * val_scale
    return sort_coo(COOMatrix((m, n), rows, cols, vals))


def diagonal(m: int, val: float = 1.0) -> COOMatrix:
    idx = np.arange(m)
    return COOMatrix((m, m), idx, idx, np.full(m, val))


PRESETS = {
    # name -> (generator, kwargs) proxies for the reference's headline
    # SuiteSparse matrices (BASELINE.md). Dims and nnz are the EXACT
    # published values; structure class matches the real matrix (see module
    # docstring + doc/PROXIES.md):
    # - delaunay_n12: planar triangulation adjacency, randomly numbered
    #   nodes -> uniform columns, 24528 nnz.
    # - raefsky1: structured-grid flow matrix -> dense band (DIA-eligible,
    #   like the real matrix's dense diagonal block structure).
    # - cavity10: driven-cavity FEM, banded with gaps.
    # - FEM_3D_thermal2 / thermal2: UNSTRUCTURED FEM meshes -> fem_like
    #   scattered-offset locality, NOT dense bands.
    # - caidaRouterLevel / webbase-1M: power-law graphs.
    "delaunay_n12_like": (
        random_uniform,
        dict(m=4096, n=4096, density=24528 / 4096**2, exact_nnz=24528),
    ),
    "raefsky1_like": (
        banded, dict(m=3242, n=3242, bandwidth=45, fill=1.0, exact_nnz=293409)
    ),
    "cavity10_like": (
        banded, dict(m=2597, n=2597, bandwidth=15, fill=0.97, exact_nnz=76367)
    ),
    "fem_3d_thermal2_like": (
        fem_like,
        dict(m=147900, n=147900, nnz=3489300, spread=1024, lo=13, hi=27),
    ),
    "thermal2_like": (
        fem_like,
        dict(m=1228045, n=1228045, nnz=8580313, spread=2048, lo=1, hi=11),
    ),
    "caida_like": (
        power_law,
        dict(
            m=192244, n=192244, avg_nnz_per_row=6.336, alpha=1.7,
            exact_nnz=1218132,
        ),
    ),
    # the reference's OpenMP-baseline matrices (BASELINE.md)
    "west2021_like": (
        random_uniform,
        dict(m=2021, n=2021, density=7310 / 2021**2, exact_nnz=7310),
    ),
    "webbase_like": (
        power_law,
        dict(
            m=1000005, n=1000005, avg_nnz_per_row=3.105, alpha=1.9,
            exact_nnz=3105536,
        ),
    ),
    # SG (reference scripts/templateCUDA.log:1-5): 144649^2, 2148786 nnz,
    # maxRowNZ 26. The log gives stats only (no SuiteSparse id resolvable
    # from them), so the proxy models what the stats pin down: near-uniform
    # row lengths capped at 26 (avg 14.9) with mesh-like scattered locality.
    "sg_like": (
        fem_like,
        dict(m=144649, n=144649, nnz=2148786, spread=2048, lo=6, hi=26),
    ),
    # structure-audit twin of sg_like (round 5): the template log pins only
    # dims/nnz/maxRowNZ, so the mesh-locality guess is unverifiable with
    # zero egress. This variant keeps the pinned stats but scatters columns
    # across the whole row (spread ~ n): NOT windowable, runs the routed
    # engine — its measured number is the LOWER bound of the SG claim under
    # the adversarial structure hypothesis (doc/PROXIES.md).
    "sg_rand_like": (
        fem_like,
        dict(m=144649, n=144649, nnz=2148786, spread=140000, lo=6, hi=26),
    ),
    # Cube_Coup_dt0 (BASELINE.md, ompNew.ods corpus): 2164760^2, 127.2M nnz,
    # 3D coupled structural mechanics -> dense near-diagonal band (~59/row).
    "cube_coup_like": (
        banded,
        dict(m=2164760, n=2164760, bandwidth=29, fill=1.0,
             exact_nnz=127206144),
    ),
}


def preset(name: str, seed: int = 0) -> COOMatrix:
    gen, kw = PRESETS[name]
    return gen(seed=seed, val_scale=1.0, **kw)
