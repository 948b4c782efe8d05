"""Clos-routed CSR engine: the host side (PL_CSR_ROUTED).

Counterpart of spmv_openmp_cuda_tpu/formats/routed.py up to its kernels: the
heavy-row split with its cost model, the gather-slot packing, the multi-level
reduction units, the output-assembly and products routings, and the chunked
wrapper, numpy as there, with torch tensors in place of jnp arrays. The
kernels that read the layout, and the dispatch of one product over them, are
in ops/routed_cuda.py.

Pipeline (all structure static, only x flows at run time):

1. *Gather*: every nnz gets a slot in a 128-row gather tile of its column
   window (16384 columns), at sublane = col % 128 and a lane chosen by the
   products router; the slot stores the value and the column's panel in the
   window (col // 128 % 128).
2. *Routing*: a planned Clos permutation (ops/route.py) moves every product
   from its gather slot to its reduction slot.
3. *Reduce*: rows are split into subrow units of <= WCAP nnz, units are
   sorted by length and grouped 128 to a column group of width = the group
   max, so every unit sum is a sum down one lane of a run of rows. Long rows
   reduce over more levels (subrow sums feed the next level's slab).
4. *Assembly*: a second Clos permutation routes every row's final unit sum,
   and every heavy row's sum, into natural row order.

Heavy rows (at least the cost model's threshold of nnz) leave the routed
pipeline. Where it fits 12 MB, they form a dense bf16 row block H, y_h = H @
x, whose sums enter the assembly domain at planned slots. Otherwise they go
into pooled residue tiles (`_build_heavy`): every heavy nnz of a column window
takes a slot at sublane col % 128 of a 128-lane tile, the rows of a pool
sorted along the lanes, so that each (tile, residue, row) is a run of lanes;
the tiles' products summed per run and per row are added into y at the heavy
rows, which the light pipeline leaves zero. An empty matrix raises
RoutedError.

A schema (merge_routed_schemas over the chunks' routed_schema_stats) forces
the pow2 width ladder of every reduction level, the gather rows, the window
count, the level count and the output domain, so that every chunk sharing it
has the same shapes and runs: the row chunks of the single-program
multi-device path (parallel/routed_spmd.py). It takes no heavy split.

The double-float (float64) engine (`prepare_routed_df`, RoutedDF) is two
float32 layouts of the same structure, one over the hi and one over the lo
words of the values (slot placement does not depend on the values), with
heavy rows, where they fit, in a dense (hi, lo) f32 block.

The cost model's constants are the JAX package's TPU fits, kept so that both
packages choose the same layout array for array. No SPMV_* environment
variable is read: the port takes the JAX defaults (dense heavy block on,
fit_domains on).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import LANE
from ..ops.route import PlannedPermutation, pick_t, plan_permutation, plan_row_to_slot
from .matrix import CSRMatrix, target_device
from .window import _next_pow2

#: panels (128 columns each) per x window, and columns per window
WINDOW_PANELS = LANE
WINDOW_ELEMS = LANE * WINDOW_PANELS

WCAP = LANE  # max unit width: one slab column group spans <= 128 rows

#: rows with at least this many nnz bypass the routed pipeline entirely; it
#: equals the nnz count that would force a third reduction level
HEAVY_THRESHOLD = WCAP * LANE

#: dense heavy block cap: (n_heavy, n_pad) bf16 must stream in under this
#: many bytes per product to beat the pooled tiles' extra passes
_DENSE_HEAVY_MAX_BYTES = 12 * 2**20

#: pooled heavy packing groups at most this many rows per pool, so that a
#: tile's distinct rows fit its 128 row slots
_HEAVY_POOL_ROWS = 96


class RoutedError(ValueError):
    """Matrix too large for the single-domain routed engine."""


@dataclasses.dataclass
class RoutedCSR:
    vals: torch.Tensor  # (rows_a, 128) f32 or bf16: gather slot values
    pidx: torch.Tensor  # (rows_a, 128) int8: panel-in-window per slot
    widx: torch.Tensor  # (rows_a//128,) int32: window per 128-row tile
    perm_products: PlannedPermutation  # r1 folded: vals sit in middle lanes
    lvl_perms: Tuple[PlannedPermutation, ...]  # prev sums -> level slab
    # 0/1 masks zeroing slab slots that are padding inside reduce runs —
    # the level perms backfill them with leftover (nonzero) sums
    lvl_masks: Tuple[torch.Tensor, ...] = ()
    perm_out: PlannedPermutation = None
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    n_windows: int = 1
    rows_a: int = 0
    # level-1 reduce runs: (row0, n_groups, width, out_group0)
    runs: Tuple[Tuple[int, int, int, int], ...] = ()
    # per extra level: its runs tuple
    lvl_runs: Tuple[Tuple[Tuple[int, int, int, int], ...], ...] = ()
    out_t: int = 1
    # pooled heavy tiles (_build_heavy), n_tiles of (128 residues, 128 lanes):
    hvals: Optional[torch.Tensor] = None  # (n_tiles*128, 128) vals dtype
    hpidx: Optional[torch.Tensor] = None  # (n_tiles*128, 128) int8 panel
    hwidx: Optional[torch.Tensor] = None  # (n_tiles,) int32 window per tile
    # (n_heavy, n_tiles*128) 0/1 numpy, on the host: row slot -> heavy row
    hreduce: Optional[np.ndarray] = None
    # (n_tiles*128, 128) int8: the run of row slot j in residue a of tile T
    # is lanes (hlo, hhi] of row T*128 + a; -1 = no term
    hlo: Optional[torch.Tensor] = None
    hhi: Optional[torch.Tensor] = None
    # dense heavy block: (n_heavy, n_pad) bf16, y_h = H @ x
    hdense: Optional[torch.Tensor] = None
    heavy_rows: Tuple[int, ...] = ()
    # static copy of widx, kept for <= 128-tile domains (the JAX package's
    # single-block gather kernels slice x windows at these offsets)
    widx_t: Tuple[int, ...] = ()
    # heavy sum k enters the assembly domain at (row n_sums_rows + k//128,
    # lane heavy_lanes[k]); perm_out delivers it to y[heavy_rows[k]]
    heavy_lanes: Tuple[int, ...] = ()


def pack_x_windows_flat(x: torch.Tensor, nwin: int) -> torch.Tensor:
    """x -> transposed window stack: rows [w*128, (w+1)*128) hold window w
    as (residue, panel), xw[w*128 + s, p] = x[w*16384 + p*128 + s] (zero
    past n). The JAX package's x layout, used by the plain versions
    of the kernels only."""
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, nwin * WINDOW_ELEMS - x.shape[0]))
    return xp.reshape(nwin, LANE, LANE).transpose(1, 2).reshape(nwin * LANE, LANE)


def n_windows_for(n_cols: int, max_col_window: int, window_elems: int) -> int:
    """Window count covering all n_cols columns (not just the populated
    ones — trailing all-zero columns must still pad cleanly)."""
    return max(max_col_window + 1, -(-max(n_cols, 1) // window_elems))


def _group_units(lens: np.ndarray, child_first: Optional[np.ndarray] = None):
    """Sort units desc by length, group 128 to a slab column-group.

    With child_first (bool per unit), units consumed by the next reduction
    level sort before final units so the next level's extraction permutation
    only spans their (few) leading groups.

    Returns (order, group_row_base, runs, n_rows): order[rank] = unit id;
    group g holds ranks [g*128, (g+1)*128) at rows
    [group_row_base[g], +width_g); runs are (row0, n_groups, width,
    out_group0) maximal equal-width stretches.
    """
    u = lens.shape[0]
    if child_first is None:
        order = np.argsort(-lens, kind="stable")
    else:
        order = np.lexsort((-lens, np.where(child_first, 0, 1)))
    n_groups = -(-u // LANE)
    # per-group width = max length in the group (with two-class ordering the
    # first element is no longer necessarily the maximum)
    lens_sorted = np.r_[lens[order], np.zeros(n_groups * LANE - u, np.int64)]
    widths = np.maximum(lens_sorted.reshape(n_groups, LANE).max(axis=1), 1)
    base = np.r_[0, np.cumsum(widths)]
    runs: List[Tuple[int, int, int, int]] = []
    g = 0
    while g < n_groups:
        g2 = g
        while g2 < n_groups and widths[g2] == widths[g]:
            g2 += 1
        runs.append((int(base[g]), g2 - g, int(widths[g]), g))
        g = g2
    return order, base, tuple(runs), int(base[-1])


def _ladder_counts(lens: np.ndarray) -> dict:
    """Pow2-quantized width ladder: {width: n_groups} with units of
    next_pow2(len) == width packed 128 to a group. The quantization wastes
    <= 2x slab rows but makes the (width, count) schema unifiable across
    chunks."""
    q = np.array([_next_pow2(max(int(v), 1)) for v in lens], dtype=np.int64)
    out = {}
    for w in sorted(set(q.tolist()), reverse=True):
        out[int(w)] = int(-(-int((q == w).sum()) // LANE))
    return out


def merge_ladders(ladders) -> dict:
    """Elementwise-max merge of {width: n_groups} ladders (schema union)."""
    out: dict = {}
    for lad in ladders:
        for w, c in lad.items():
            out[w] = max(out.get(w, 0), c)
    return dict(sorted(out.items(), reverse=True))


def _group_units_ladder(lens: np.ndarray, schema: dict):
    """Schema-forced grouping: every unit goes into the pow2 ladder class
    next_pow2(len), groups padded to exactly schema[w] per width, so the
    runs are the same for every chunk sharing the schema.

    Returns (rank, group_row_base, runs, n_rows): rank[u] = slot rank of
    unit u (group = rank // 128); pad ranks are unoccupied."""
    u = lens.shape[0]
    q = np.array([_next_pow2(max(int(v), 1)) for v in lens], dtype=np.int64)
    widths_all, counts_all = [], []
    for w, c in sorted(schema.items(), reverse=True):
        widths_all.append(w)
        counts_all.append(c)
    widths = np.repeat(np.array(widths_all, np.int64), np.array(counts_all, np.int64))
    base = np.r_[0, np.cumsum(widths)]
    runs: List[Tuple[int, int, int, int]] = []
    g = 0
    for w, c in zip(widths_all, counts_all):
        runs.append((int(base[g]), c, int(w), g))
        g += c
    # units of class w take the leading slots of w's groups, in
    # descending-length order
    rank = np.empty(u, dtype=np.int64)
    g0 = 0
    class_off = {}
    for w, c in zip(widths_all, counts_all):
        class_off[w] = g0 * LANE
        g0 += c
    order = np.argsort(-lens, kind="stable")
    qo = q[order]
    for w in widths_all:
        ids = order[qo == w]
        if ids.size > schema[w] * LANE:
            raise RoutedError(
                f"ladder overflow: {ids.size} units of width {w} > schema {schema[w]} groups"
            )
        rank[ids] = class_off[w] + np.arange(ids.size)
    return rank, base, tuple(runs), int(base[-1])


def _dense_heavy_ok(dtype, n_heavy: int, n_pad: int) -> bool:
    return dtype == torch.float32 and n_heavy * n_pad * 2 <= _DENSE_HEAVY_MAX_BYTES


def _build_heavy(rows_h, csr: CSRMatrix):
    """Pooled residue tiles for the heavy rows (the JAX package's
    _build_heavy, numpy verbatim).

    All heavy nnz of a window pool together: per residue a (the slot
    sublane, = col % 128), entries sort by row and take consecutive lanes k
    across however many 128-lane tiles the window's deepest residue needs.
    Each (row, window, residue) run is a contiguous k range, so per tile a
    row's partial sum is the sum of the lanes (hlo, hhi] of each residue
    (int8, -1 = no term) in the row's slot j. Returns hvals (f64), hpidx,
    hwidx, the (n_heavy, n_tiles*128) 0/1 slot -> row matrix, hlo, hhi.
    """
    n_h = len(rows_h)
    ri_all, cols_all, data_all = [], [], []
    for ri, r in enumerate(rows_h):
        i0, i1 = int(csr.indptr[r]), int(csr.indptr[r + 1])
        ri_all.append(np.full(i1 - i0, ri, dtype=np.int64))
        cols_all.append(csr.indices[i0:i1].astype(np.int64))
        data_all.append(csr.data[i0:i1])
    ri = np.concatenate(ri_all)
    cols = np.concatenate(cols_all)
    data = np.concatenate(data_all)
    w = cols // WINDOW_ELEMS
    a = cols % LANE
    p = (cols // LANE) % WINDOW_PANELS
    pool = ri // _HEAVY_POOL_ROWS  # cap rows per pool (row-slot lanes = 128)

    # ordinals k within each (pool, window, residue), entries sorted by row
    order = np.lexsort((ri, a, w, pool))
    sp, sw, sa, sri = pool[order], w[order], a[order], ri[order]
    key = (sp * (int(w.max(initial=0)) + 1) + sw) * LANE + sa
    starts = np.r_[0, np.flatnonzero(np.diff(key)) + 1]
    rid = np.zeros(key.shape[0], dtype=np.int64)
    rid[starts] = 1
    rid = np.cumsum(rid) - 1
    k = np.arange(key.shape[0]) - starts[rid]

    # tiles per (pool, window): deepest pooled residue
    pw_ids, pw_inv = np.unique(key // LANE, return_inverse=True)
    lanes_pw = np.zeros(pw_ids.shape[0], dtype=np.int64)
    np.maximum.at(lanes_pw, pw_inv, k + 1)
    tiles_pw = -(-lanes_pw // LANE)
    tile_base = np.r_[0, np.cumsum(tiles_pw)]
    n_tiles = int(tile_base[-1])
    tg = tile_base[pw_inv] + k // LANE  # global tile per entry

    hvals = np.zeros((n_tiles * LANE, LANE), dtype=np.float64)
    hpidx = np.zeros((n_tiles * LANE, LANE), dtype=np.int8)
    hvals[tg * LANE + sa, k % LANE] = data[order]
    hpidx[tg * LANE + sa, k % LANE] = p[order]
    hwidx = np.repeat(pw_ids % (int(w.max(initial=0)) + 1), tiles_pw).astype(
        np.int32
    )

    # per-(pool, window, residue, row) runs -> per-tile row-slot bounds
    key2 = key * n_h + sri
    starts2 = np.r_[0, np.flatnonzero(np.diff(key2)) + 1, key2.shape[0]]
    hlo = np.full((n_tiles * LANE, LANE), -1, dtype=np.int8)
    hhi = np.full((n_tiles * LANE, LANE), -1, dtype=np.int8)
    slot_of: dict = {}  # (tile, ri) -> row-slot lane j
    slots_used = np.zeros(n_tiles, dtype=np.int64)
    owner_ri: List[int] = []  # flat (tile*128 + j) -> ri
    owner_pos: List[int] = []
    for s0 in range(starts2.shape[0] - 1):
        lo_, hi_ = int(starts2[s0]), int(starts2[s0 + 1])
        if lo_ == hi_:
            continue
        a_ = int(sa[lo_])
        ri_ = int(sri[lo_])
        klo, khi = int(k[lo_]), int(k[hi_ - 1]) + 1
        base_t = int(tile_base[pw_inv[lo_]])
        for tl in range(klo // LANE, -(-khi // LANE)):
            t_ = base_t + tl
            j = slot_of.get((t_, ri_))
            if j is None:
                j = int(slots_used[t_])
                slots_used[t_] += 1
                slot_of[(t_, ri_)] = j
                owner_ri.append(ri_)
                owner_pos.append(t_ * LANE + j)
            l0 = max(klo - tl * LANE, 0)
            l1 = min(khi - tl * LANE, LANE)
            hlo[t_ * LANE + a_, j] = l0 - 1
            hhi[t_ * LANE + a_, j] = l1 - 1
    reduce_mat = np.zeros((n_h, n_tiles * LANE), dtype=np.float64)
    reduce_mat[np.asarray(owner_ri, dtype=np.int64),
               np.asarray(owner_pos, dtype=np.int64)] = 1.0
    return hvals, hpidx, hwidx, reduce_mat, hlo, hhi


def _pick_heavy_threshold(
    csr: CSRMatrix, lens_full: np.ndarray, dtype=torch.float32
) -> int:
    """Choose the heavy/light split minimizing the JAX package's cost model
    (slot counts of its TPU passes).

    The routed permutation costs ~4 passes over the whole power-of-two
    domain, so pushing skewed rows into the unrouted heavy path pays off
    exactly when it drops the domain a power of two. The heavy side is the
    cheaper of the dense bf16 row block (half-slot per element streamed) and
    the pooled residue tiles.
    """
    m, n = csr.shape
    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    w = cols // WINDOW_ELEMS
    a = cols % LANE
    nwin = max(int(w.max(initial=0)) + 1, 1)
    best_thr, best_cost = HEAVY_THRESHOLD, None
    for thr in (HEAVY_THRESHOLD, 8192, 4096, 2048, 1024, 512):
        heavy = lens_full >= thr
        if heavy.sum() == m:
            heavy[np.argmin(lens_full)] = False
        light = ~heavy[rows]
        # light gather rows: sum over windows of 128 * max_a ceil(cnt/128)
        cell = w[light] * LANE + a[light]
        cnt = np.bincount(cell, minlength=nwin * LANE).reshape(nwin, LANE)
        rows_a = int((128 * np.ceil(cnt / LANE).max(axis=1)).sum())
        # light reduce-slab rows (exact unit grouping)
        lens_l = np.where(heavy, 0, lens_full)
        n_sub = np.maximum(-(-lens_l // WCAP), 1)
        u1 = int(n_sub.sum())
        lens1 = np.full(u1, WCAP, dtype=np.int64)
        last = np.cumsum(n_sub) - 1
        lens1[last] = lens_l - (n_sub - 1) * WCAP
        srt = np.sort(lens1)[::-1]
        widths = np.maximum(srt[:: LANE], 1)
        rows_c = int(widths.sum())
        try:
            t1 = pick_t(max(rows_a, rows_c))
        except ValueError:
            continue
        # heavy side: cheaper of dense bf16 block and pooled residue tiles
        hcost = 0
        if heavy.any():
            hsel = heavy[rows]
            hord = np.cumsum(heavy) - 1  # heavy ordinal per row
            pool = hord[rows[hsel]] // _HEAVY_POOL_ROWS
            keyh = (pool * nwin + w[hsel]) * LANE + a[hsel]
            npools = int(pool.max(initial=0)) + 1
            cnth = np.bincount(
                keyh, minlength=npools * nwin * LANE
            ).reshape(npools * nwin, LANE)
            tiles_h = np.ceil(cnth.max(axis=1) / LANE).sum()
            hcost = int(2 * tiles_h * LANE * LANE)
            n_pad = -(-n // LANE) * LANE
            n_h = int(heavy.sum())
            if _dense_heavy_ok(dtype, n_h, n_pad):
                hcost = min(hcost, n_h * n_pad // 2)
        cost = hcost + rows_a * LANE + 4 * t1 * LANE * LANE
        if best_cost is None or cost < best_cost:
            best_thr, best_cost = thr, cost
    return best_thr


def routed_schema_stats(csr: CSRMatrix) -> dict:
    """The shape-determining stats of a chunk's routed structure under the
    pow2 width ladder (no heavy split, no routing): {'rows_a', 'nwin',
    'ladders': (one ladder per reduction level), 'm'}. Merge the chunks'
    with merge_routed_schemas."""
    m, n = csr.shape
    cols = csr.indices.astype(np.int64)
    lens = np.diff(csr.indptr.astype(np.int64))
    w = cols // WINDOW_ELEMS
    a = cols % LANE
    nwin = n_windows_for(n, int(w.max(initial=0)), WINDOW_ELEMS)
    cell = w * LANE + a
    cnt = np.bincount(cell, minlength=nwin * LANE).reshape(nwin, LANE)
    rows_a = int((LANE * np.ceil(cnt / LANE).max(axis=1)).sum())
    ladders = []
    n_sub = np.maximum(-(-lens // WCAP), 1)
    u = int(n_sub.sum())
    lens_k = np.full(u, WCAP, dtype=np.int64)
    lens_k[np.cumsum(n_sub) - 1] = lens - (n_sub - 1) * WCAP
    ladders.append(_ladder_counts(lens_k))
    counts = n_sub[n_sub > 1]
    while counts.size:
        nsub2 = np.maximum(-(-counts // WCAP), 1)
        u2 = int(nsub2.sum())
        lens2 = np.full(u2, WCAP, dtype=np.int64)
        lens2[np.cumsum(nsub2) - 1] = counts - (nsub2 - 1) * WCAP
        ladders.append(_ladder_counts(lens2))
        counts = nsub2[nsub2 > 1]
    return {"rows_a": rows_a, "nwin": nwin, "ladders": tuple(ladders), "m": m}


def merge_routed_schemas(stats) -> dict:
    """The shared schema of the chunks whose routed_schema_stats are given:
    per level the merged ladder ({1: 1} for a level no chunk has), the most
    gather rows and windows, the level count, and an output domain that
    holds every level's groups and the largest chunk's rows."""
    n_levels = max(len(s["ladders"]) for s in stats)
    ladders = []
    for k in range(n_levels):
        merged = merge_ladders([s["ladders"][k] for s in stats if len(s["ladders"]) > k])
        ladders.append(merged or {1: 1})
    total_groups = sum(sum(lad.values()) for lad in ladders)
    out_rows = max(total_groups, max(-(-s["m"] // LANE) for s in stats))
    return {
        "rows_a": max(s["rows_a"] for s in stats),
        "nwin": max(s["nwin"] for s in stats),
        "ladders": tuple(ladders),
        "n_levels": n_levels,
        "out_rows": out_rows,
    }


def prepare_routed(
    csr: CSRMatrix,
    dtype: torch.dtype = torch.float32,
    heavy_threshold: Optional[int] = None,
    vals_dtype=None,
    schema: Optional[dict] = None,
    device="cuda",
) -> RoutedCSR:
    """The JAX package's prepare_routed, numpy verbatim, with the arrays as
    tensors on `device` (the card unless the caller passes device="cpu";
    see _prepare_routed_placed). schema (from merge_routed_schemas) forces
    the ladder runs, the padded gather rows, the window count, the level
    count and the output domain, so that every chunk sharing it has the same
    shapes; it takes no heavy split."""
    device = target_device(device)
    return _prepare_routed_placed(
        csr, dtype, heavy_threshold, vals_dtype, schema, device=device
    )[0]


def _prepare_routed_placed(
    csr: CSRMatrix,
    dtype: torch.dtype = torch.float32,
    heavy_threshold: Optional[int] = None,
    vals_dtype=None,
    schema: Optional[dict] = None,
    *,
    device,
    probe: bool = False,
):
    """(RoutedCSR, row_a, lane_a): the prepare, and the gather slot (row_a,
    lane_a) of every light nnz, in CSR order. With probe, only the domain
    test: None, or the RoutedError of a domain too large (the heavy rows
    leave the domain whatever holds them, so no heavy layout is built).

    vals_dtype (default = dtype) is the storage type of the gather slot
    values and of the pooled heavy tiles; products, routing and sums stay
    f32. The dense heavy block is bf16 in every mode, as in the JAX package,
    so the f32 mode rounds the heavy rows' values to bf16 where they fit it.

    Raises RoutedError where the JAX package does (domain too large, empty
    matrix, a chunk beyond its schema) and NotImplementedError for a dtype
    other than float32.
    """
    if dtype != torch.float32:
        raise NotImplementedError(
            f"routed engine dtype {dtype}: each plane of the layout is float32 "
            "(float64 runs the double-float engine, prepare_routed_df)"
        )
    if vals_dtype is None:
        vals_dtype = dtype
    m, n = csr.shape
    if csr.nnz == 0 or m == 0:
        raise RoutedError("empty matrix")
    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    data = csr.data
    indptr = csr.indptr.astype(np.int64)
    lens_full = np.diff(indptr)

    # ---- heavy-row split --------------------------------------------------
    if schema is not None:
        heavy_threshold = 1 << 60
    if heavy_threshold is None:
        heavy_threshold = _pick_heavy_threshold(csr, lens_full, dtype)
    heavy_sel = lens_full >= heavy_threshold
    while heavy_sel.any() and lens_full[~heavy_sel].sum() == 0:
        # the routed pipeline needs at least one light nnz (a zero-row
        # gather domain): demote the smallest heavy row
        cand = np.flatnonzero(heavy_sel)
        heavy_sel[cand[np.argmin(lens_full[cand])]] = False
    rows_h = np.flatnonzero(heavy_sel)
    hdense = heavy = None
    if rows_h.size:
        n_pad = -(-n // LANE) * LANE
        if not probe and not _dense_heavy_ok(dtype, rows_h.size, n_pad):
            heavy = _build_heavy(rows_h, csr)
        elif not probe:
            hd = np.zeros((rows_h.size, n_pad), dtype=np.float32)
            row_map = np.full(m, -1, dtype=np.int64)
            row_map[rows_h] = np.arange(rows_h.size)
            hnz = heavy_sel[rows]
            hd[row_map[rows[hnz]], cols[hnz]] = data[hnz]
            hdense = hd
        keep = ~heavy_sel[rows]
        rows, cols, data = rows[keep], cols[keep], data[keep]
        lens_light = np.where(heavy_sel, 0, lens_full)
        indptr = np.r_[0, np.cumsum(lens_light)]
        csr = CSRMatrix(
            shape=(m, n),
            indptr=indptr,
            indices=cols,
            data=data,
        )
    nnz = cols.shape[0]

    # ---- gather-phase packing (rows fixed, lanes assigned by the router) --
    w = cols // WINDOW_ELEMS
    a = cols % LANE
    p = (cols // LANE) % WINDOW_PANELS
    nwin = n_windows_for(n, int(w.max(initial=0)), WINDOW_ELEMS)
    if schema is not None:
        nwin = max(nwin, schema["nwin"])
    # ordinal within (w, a)
    key = w * LANE + a
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    starts = np.r_[0, np.flatnonzero(np.diff(key_sorted)) + 1]
    run_id = np.zeros(nnz, dtype=np.int64)
    run_id[starts] = 1
    run_id = np.cumsum(run_id) - 1
    j_sorted = np.arange(nnz) - starts[run_id]
    j = np.empty(nnz, dtype=np.int64)
    j[order] = j_sorted
    depth = j // LANE
    tiles_per_win = np.zeros(nwin, dtype=np.int64)
    np.maximum.at(tiles_per_win, w, depth + 1)
    tile_base = np.r_[0, np.cumsum(tiles_per_win)]
    n_tiles = int(tile_base[-1])
    rows_a = n_tiles * LANE
    row_a = (tile_base[w] + depth) * LANE + a  # slot row per nnz; lane TBD
    pad_tiles = 0  # schema: trailing all-zero gather tiles (widx -> 0)
    if schema is not None:
        if rows_a > schema["rows_a"]:
            raise RoutedError(f"chunk gather rows {rows_a} exceed schema {schema['rows_a']}")
        pad_tiles = schema["rows_a"] // LANE - n_tiles
        n_tiles += pad_tiles
        rows_a = schema["rows_a"]

    # ---- reduction units (multi-level row splitting) ----------------------
    lens = np.diff(csr.indptr).astype(np.int64)
    ordinal = np.arange(nnz) - csr.indptr[rows].astype(np.int64)
    # level-1 units: subrows of <= WCAP nnz, in row-major order
    n_sub = np.maximum(-(-lens // WCAP), 1)
    sub_base = np.r_[0, np.cumsum(n_sub)]  # unit id = sub_base[r] + o//WCAP
    u1 = int(sub_base[-1])
    unit_of_nnz = sub_base[rows] + ordinal // WCAP
    k_of_nnz = ordinal % WCAP
    # exact per-unit lengths: full WCAP except each row's last subrow
    # (zero-length rows get a single length-0 unit)
    lens1 = np.full(u1, WCAP, dtype=np.int64)
    last = sub_base[1:] - 1
    lens1[last] = lens - (n_sub - 1) * WCAP

    # units consumed by level 2 (subunits of split rows) sort first
    is_child1 = np.repeat(n_sub > 1, n_sub)
    if schema is not None:
        rank1, base1, runs1, rows_c = _group_units_ladder(lens1, schema["ladders"][0])
    else:
        order1, base1, runs1, rows_c = _group_units(lens1, child_first=is_child1)
    if probe:
        # the test the products permutation makes below (pick_t)
        try:
            pick_t(max(rows_a, rows_c))
        except ValueError as e:
            raise RoutedError(str(e)) from e
        return None
    if schema is None:
        rank1 = np.empty(u1, dtype=np.int64)
        rank1[order1] = np.arange(u1)
    n_child = [int(is_child1.sum())]  # per level: #units feeding the next

    # ---- pass 1: unit/group structure for every reduction level -----------
    # (in-group lanes are NOT fixed here — the output-assembly router assigns
    # them so its own first lane-perm stage folds away entirely)
    levels = []  # per extra level: dict of structure arrays
    level_groups = [
        sum(schema["ladders"][0].values()) if schema is not None else -(-u1 // LANE)
    ]
    # map each original row to (level, unit id within that level)
    final_level = np.zeros(m, dtype=np.int64)
    final_unit = sub_base[:-1].copy()  # rows with one subrow: that unit
    parents = np.flatnonzero(n_sub > 1)
    child_counts = n_sub
    child_first = sub_base[:-1]
    level = 0
    while parents.size:
        level += 1
        plens_full = child_counts[parents]
        nsub2 = np.maximum(-(-plens_full // WCAP), 1)
        sb2 = np.r_[0, np.cumsum(nsub2)]
        u2 = int(sb2[-1])
        lens2 = np.full(u2, WCAP, dtype=np.int64)
        last2 = sb2[1:] - 1
        lens2[last2] = plens_full - (nsub2 - 1) * WCAP
        is_child2 = np.repeat(nsub2 > 1, nsub2)
        if schema is not None:
            if level >= len(schema["ladders"]):
                raise RoutedError(f"chunk needs level {level} beyond schema depth")
            rank2, base2, runs2, rows2 = _group_units_ladder(lens2, schema["ladders"][level])
        else:
            order2, base2, runs2, rows2 = _group_units(lens2, child_first=is_child2)
            rank2 = np.empty(u2, dtype=np.int64)
            rank2[order2] = np.arange(u2)
        n_child.append(int(is_child2.sum()))
        # one element per (unit, k<len): its source is a child unit at the
        # previous level
        el_unit = np.repeat(np.arange(u2), lens2)
        el_start = np.r_[0, np.cumsum(lens2)]
        el_k = np.arange(int(el_start[-1])) - el_start[el_unit]
        unit_parent = np.repeat(np.arange(parents.shape[0]), nsub2)
        src_unit = (
            child_first[parents][unit_parent[el_unit]]
            + (el_unit - sb2[unit_parent[el_unit]]) * WCAP
            + el_k
        )
        levels.append(
            dict(
                u=u2, rank=rank2, base=base2, runs=runs2, rows=rows2,
                el_unit=el_unit, el_k=el_k, src_unit=src_unit,
            )
        )
        level_groups.append(
            sum(schema["ladders"][level].values()) if schema is not None else -(-u2 // LANE)
        )
        done = nsub2 == 1
        final_level[parents[done]] = level
        final_unit[parents[done]] = sb2[:-1][done]
        still = np.flatnonzero(~done)
        parents_next = parents[still]
        child_counts_next = np.zeros(
            max(int(parents.max(initial=0)) + 1, m), dtype=np.int64
        )
        child_first_next = np.zeros_like(child_counts_next)
        child_counts_next[parents_next] = nsub2[still]
        child_first_next[parents_next] = sb2[:-1][still]
        child_counts = child_counts_next
        child_first = child_first_next
        parents = parents_next
        if level > 8:
            raise RoutedError("row splitting failed to converge")

    if schema is not None:
        # pad to the schema's level count with degenerate levels (one dummy
        # length-0 unit, no extraction elements, all-zero mask), so every
        # chunk runs the same levels
        empty = np.zeros(0, dtype=np.int64)
        while len(levels) < schema["n_levels"] - 1:
            lad = schema["ladders"][len(levels) + 1]
            rank_d, base_d, runs_d, rows_d = _group_units_ladder(np.zeros(1, dtype=np.int64), lad)
            levels.append(
                dict(
                    u=1, rank=rank_d, base=base_d, runs=runs_d, rows=rows_d,
                    el_unit=empty, el_k=empty, src_unit=empty,
                )
            )
            level_groups.append(sum(lad.values()))
            n_child.append(0)

    # ---- pass 2: output assembly routing assigns every in-group lane ------
    # elements = all units of all levels (every sums row has exactly 128
    # incl. pads); finals route to y rows, the rest to the pad region
    group_offs = np.r_[0, np.cumsum(level_groups)]
    total = int(group_offs[-1]) * LANE
    # dense heavy sums enter the assembly domain as extra source rows after
    # the level groups and route straight to their y rows
    n_hroute = rows_h.size if hdense is not None else 0
    h_extra_rows = -(-n_hroute // LANE) if n_hroute else 0
    out_rows = max(
        -(-total // LANE) + h_extra_rows, -(-m // LANE)
    )
    if schema is not None:
        if out_rows > schema["out_rows"]:
            raise RoutedError(f"chunk out rows {out_rows} exceed schema {schema['out_rows']}")
        out_rows = schema["out_rows"]
    t_out = pick_t(out_rows)
    h_out = t_out * LANE
    dom_o = h_out * LANE
    all_ranks = [rank1] + [lv["rank"] for lv in levels]
    src_rows_lvl = [
        group_offs[k] + r // LANE for k, r in enumerate(all_ranks)
    ]
    unit_src_row = np.concatenate(src_rows_lvl)
    unit_offs = np.r_[0, np.cumsum([r.shape[0] for r in all_ranks])]
    # dst: finals -> y row; everything else -> free slots
    dst_unit = np.full(unit_src_row.shape[0], -1, dtype=np.int64)
    fin_ids = unit_offs[final_level] + final_unit
    dst_unit[fin_ids] = np.arange(m)
    if n_hroute:
        # heavy rows' (empty, zero-sum) final units yield their y slot to
        # the routed heavy sums
        dst_unit[fin_ids[rows_h]] = -1
        heavy_src = int(group_offs[-1]) + np.arange(n_hroute) // LANE
        unit_src_row = np.r_[unit_src_row, heavy_src]
        dst_unit = np.r_[dst_unit, rows_h]
    # pad elements fill every domain row to exactly 128
    cnt_row_o = np.bincount(unit_src_row, minlength=h_out)
    pad_rows_o = np.repeat(np.arange(h_out), LANE - cnt_row_o)
    src_all_o = np.r_[unit_src_row, pad_rows_o]
    dst_all_o = np.full(src_all_o.shape[0], -1, dtype=np.int64)
    dst_all_o[: dst_unit.shape[0]] = dst_unit
    used_o = np.zeros(dom_o, dtype=bool)
    used_o[np.arange(m)] = True
    dst_all_o[dst_all_o < 0] = np.flatnonzero(~used_o)
    perm_out, m_out = plan_row_to_slot(src_all_o, dst_all_o, t_out, device=device)
    heavy_lanes = (
        tuple(
            int(v)
            for v in m_out[
                unit_src_row.shape[0] - n_hroute : unit_src_row.shape[0]
            ]
        )
        if n_hroute
        else ()
    )
    # in-group lane of every unit, per level
    lanes_lvl = [
        m_out[unit_offs[k] : unit_offs[k + 1]] for k in range(len(all_ranks))
    ]
    pos_lvl = [
        (r // LANE) * LANE + lanes_lvl[k] for k, r in enumerate(all_ranks)
    ]

    # ---- pass 3: lane-dependent structures --------------------------------
    slot_c = (
        (base1[rank1[unit_of_nnz] // LANE] + k_of_nnz) * LANE
        + lanes_lvl[0][unit_of_nnz]
    )

    # products permutation (source lanes assigned by its own router)
    dom_rows = max(rows_a, rows_c)
    try:
        t1 = pick_t(dom_rows)
    except ValueError as e:
        raise RoutedError(str(e)) from e
    h1 = t1 * LANE
    dom = h1 * LANE
    cnt_row = np.zeros(h1, dtype=np.int64)
    np.add.at(cnt_row, row_a, 1)
    pad_rows = np.repeat(np.arange(h1), LANE - cnt_row)
    src_row_all = np.r_[row_a, pad_rows]
    used_dst = np.zeros(dom, dtype=bool)
    used_dst[slot_c] = True
    dst_all = np.r_[slot_c, np.flatnonzero(~used_dst)]
    perm_products, m_all = plan_row_to_slot(src_row_all, dst_all, t1, device=device)
    lane_a = m_all[:nnz]  # the router's lane assignment for each nnz

    # level permutations: prev sums -> level slab
    lvl_gather: List = []
    lvl_runs: List[Tuple] = []
    for k, lv in enumerate(levels):
        gidx = np.full(lv["rows"] * LANE, -1, dtype=np.int64)
        dst_rows = lv["base"][lv["rank"][lv["el_unit"]] // LANE] + lv["el_k"]
        gidx[dst_rows * LANE + lanes_lvl[k + 1][lv["el_unit"]]] = pos_lvl[k][
            lv["src_unit"]
        ]
        # with child-first ordering the previous level's child sums occupy
        # only its leading groups — the extraction domain shrinks to those;
        # a schema orders no children first, so it spans all the groups
        prev_rows = (
            level_groups[k] if schema is not None else -(-max(n_child[k], 1) // LANE)
        )
        t_k = pick_t(max(prev_rows, lv["rows"]))
        dom_k = t_k * LANE * LANE
        dst_k = np.full(dom_k, -1, dtype=np.int64)
        real = gidx >= 0
        dst_k[gidx[real]] = np.flatnonzero(real)
        used_k = np.zeros(dom_k, dtype=bool)
        used_k[np.flatnonzero(real)] = True
        dst_k[dst_k < 0] = np.flatnonzero(~used_k)
        mask_k = np.zeros((t_k * LANE, LANE), dtype=np.float32)
        mask_k.reshape(-1)[np.flatnonzero(real)] = 1.0
        lvl_gather.append((plan_permutation(dst_k, t_k, device=device), mask_k))
        lvl_runs.append(lv["runs"])

    # ---- device arrays ----------------------------------------------------
    # pidx holds panel ids < 128, stored int8; pad tiles beyond rows_a are
    # never materialized — the gather kernel emits their zeros directly
    vals = np.zeros((rows_a, LANE), dtype=np.float64)
    pidx = np.zeros((rows_a, LANE), dtype=np.int8)
    vals[row_a, lane_a] = csr.data
    pidx[row_a, lane_a] = p
    widx = np.repeat(np.arange(nwin, dtype=np.int32), tiles_per_win)
    if pad_tiles:
        # schema pad tiles: all-zero vals -> zero products; window 0 read
        widx = np.r_[widx, np.zeros(pad_tiles, dtype=np.int32)]
    pooled = {}
    if heavy is not None:
        hvals, hpidx, hwidx, hreduce, hlo, hhi = heavy
        pooled = dict(
            hvals=torch.from_numpy(hvals).to(vals_dtype).to(device),
            hpidx=torch.from_numpy(hpidx).to(device),
            hwidx=torch.from_numpy(hwidx).to(device),
            hreduce=hreduce.astype(np.float32),
            hlo=torch.from_numpy(hlo).to(device),
            hhi=torch.from_numpy(hhi).to(device),
        )
    mat = RoutedCSR(
        vals=torch.from_numpy(vals).to(vals_dtype).to(device),
        pidx=torch.from_numpy(pidx).to(device),
        widx=torch.from_numpy(widx).to(device),
        **pooled,
        hdense=torch.from_numpy(hdense).to(torch.bfloat16).to(device)
        if hdense is not None
        else None,
        heavy_rows=tuple(int(r) for r in rows_h),
        heavy_lanes=heavy_lanes,
        perm_products=perm_products,
        lvl_perms=tuple(pk for pk, _mk in lvl_gather),
        lvl_masks=tuple(torch.from_numpy(mk).to(device) for _pk, mk in lvl_gather),
        perm_out=perm_out,
        shape=(m, n),
        nnz=nnz,
        n_windows=nwin,
        rows_a=rows_a,
        widx_t=tuple(int(v) for v in widx) if rows_a <= 128 * LANE and schema is None else (),
        runs=runs1,
        lvl_runs=tuple(lvl_runs),
        out_t=t_out,
    )
    return mat, row_a, lane_a


# ---------------------------------------------------------------------------
# Chunked wrapper: matrices beyond the single permutation domain
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoutedChunks:
    """Row-block decomposition into independent routed engines — the scale
    path for matrices whose nnz exceed one (128*128)-row routing domain."""

    chunks: Tuple[RoutedCSR, ...]
    bounds: Tuple[int, ...]  # row boundaries, len = n_chunks + 1
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0


def _sub_csr(csr: CSRMatrix, r0: int, r1: int) -> CSRMatrix:
    i0, i1 = int(csr.indptr[r0]), int(csr.indptr[r1])
    return CSRMatrix(
        shape=(r1 - r0, csr.shape[1]),
        indptr=(csr.indptr[r0 : r1 + 1] - i0).astype(np.int64),
        indices=csr.indices[i0:i1],
        data=csr.data[i0:i1],
    )


def _predict_domain_rows(csr: CSRMatrix, r0: int, r1: int) -> int:
    """Predicted permutation-domain rows max(rows_a, rows_c) for the light
    path of rows [r0, r1) (ignores the heavy split — exact for FEM-degree
    matrices, a safe overestimate otherwise)."""
    i0, i1 = int(csr.indptr[r0]), int(csr.indptr[r1])
    cols = csr.indices[i0:i1].astype(np.int64)
    if cols.size == 0:
        return 1
    w = cols // WINDOW_ELEMS
    a = cols % LANE
    cell = (w - w.min()) * LANE + a
    cnt = np.bincount(cell)
    # tiles per window = max over residues of ceil(cnt/128); rows = 128/tile
    nwin = int(w.max() - w.min()) + 1
    cnt2 = np.zeros(nwin * LANE, dtype=np.int64)
    cnt2[: cnt.shape[0]] = cnt
    rows_a = int(
        (128 * np.ceil(cnt2.reshape(nwin, LANE) / LANE).max(axis=1)).sum()
    )
    lens = np.diff(csr.indptr[r0 : r1 + 1]).astype(np.int64)
    n_sub = np.maximum(-(-lens // WCAP), 1)
    u1 = int(n_sub.sum())
    lens1 = np.full(u1, WCAP, dtype=np.int64)
    last = np.cumsum(n_sub) - 1
    lens1[last] = lens - (n_sub - 1) * WCAP
    srt = np.sort(lens1)[::-1]
    rows_c = int(np.maximum(srt[::LANE], 1).sum())
    return max(rows_a, rows_c, 1)


def _fit_chunk_bounds(csr: CSRMatrix, target_rows: int = 8064) -> List[int]:
    """Chunk boundaries chosen so each chunk's predicted permutation domain
    fills its power-of-two tile grid (pick_t rounds rows up to the next
    power of two <= 128 tiles; aim just under the boundary)."""
    m = csr.shape[0]
    bounds = [0]
    while bounds[-1] < m:
        r0 = bounds[-1]
        lo, hi = r0 + 1, m
        # exponential probe then bisection on the end row
        step = max((m - r0) // 8, 1)
        r = min(r0 + step, m)
        while r < m and _predict_domain_rows(csr, r0, r) < target_rows:
            lo = r
            r = min(r + step, m)
            step *= 2
        hi = r
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if _predict_domain_rows(csr, r0, mid) <= target_rows:
                lo = mid
            else:
                hi = mid - 1
        bounds.append(max(lo, r0 + 1))
    return bounds


def _initial_bounds(csr: CSRMatrix, chunk_nnz: int, fit_domains: bool) -> List[int]:
    if fit_domains:
        return _fit_chunk_bounds(csr)
    lens = np.diff(csr.indptr)
    bounds = [0]
    acc = 0
    for r in range(csr.shape[0]):
        ln = int(lens[r])
        if acc + min(ln, HEAVY_THRESHOLD) > chunk_nnz and r > bounds[-1]:
            bounds.append(r)
            acc = 0
        acc += min(ln, HEAVY_THRESHOLD)
    bounds.append(csr.shape[0])
    return bounds


def _split_rows(csr: CSRMatrix, bounds, prepare):
    """(prepare of each row block, final bounds): a block whose prepare
    raises RoutedError is halved, recursively."""
    out = []
    final_bounds = [0]
    stack = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)][::-1]
    while stack:
        r0, r1 = stack.pop()
        try:
            out.append(prepare(_sub_csr(csr, r0, r1)))
            final_bounds.append(r1)
        except RoutedError:
            if r1 - r0 <= 1:
                raise
            mid = (r0 + r1) // 2
            stack.append((mid, r1))
            stack.append((r0, mid))
    return out, tuple(final_bounds)


def prepare_routed_chunked(
    csr: CSRMatrix, dtype: torch.dtype = torch.float32, chunk_nnz: int = 700_000,
    vals_dtype=None, fit_domains: bool = True, device="cuda",
) -> RoutedChunks:
    """Split rows into blocks whose routing domains fill a t <= 64 tile grid
    (fit_domains, the default: boundaries by bisection on the predicted
    domain size) and prepare a routed engine per block (recursive halving if
    a block still exceeds its domain), on `device` (the card unless the
    caller passes device="cpu"). fit_domains=False takes the greedy
    <= chunk_nnz split."""
    device = target_device(device)
    chunks, bounds = _split_rows(
        csr, _initial_bounds(csr, chunk_nnz, fit_domains),
        lambda sub: prepare_routed(sub, dtype=dtype, vals_dtype=vals_dtype, device=device),
    )
    return RoutedChunks(chunks=tuple(chunks), bounds=bounds, shape=csr.shape, nnz=csr.nnz)


def routed_chunk_bounds(
    csr: CSRMatrix, chunk_nnz: int = 700_000, fit_domains: bool = True
) -> Tuple[int, ...]:
    """The row bounds of prepare_routed_chunked (float32), found by the
    domain test alone, without building the blocks' layouts."""
    return _split_rows(
        csr, _initial_bounds(csr, chunk_nnz, fit_domains),
        # the domain test places no tensor
        lambda sub: _prepare_routed_placed(sub, device="cpu", probe=True),
    )[1]


def prepare_routed_auto(
    csr: CSRMatrix, dtype: torch.dtype = torch.float32, vals_dtype=None, device="cuda"
):
    """RoutedCSR when one domain suffices, RoutedChunks otherwise, on
    `device` (the card unless the caller passes device="cpu")."""
    device = target_device(device)
    try:
        return prepare_routed(csr, dtype=dtype, vals_dtype=vals_dtype, device=device)
    except RoutedError:
        return prepare_routed_chunked(
            csr, dtype=dtype, vals_dtype=vals_dtype, device=device
        )


# ---------------------------------------------------------------------------
# Double-float (float64) routed engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoutedDF:
    """Routed operands in double-float: the hi words ride mat.vals, the lo
    words vals_lo (the same slot placement). Heavy rows, where the dense
    (hi, lo) f32 block fits _DF_HDENSE_MAX_BYTES, leave the routed pipeline
    (y_h by a compensated dense row dot); otherwise they reduce over the
    multi-level runs like any row."""

    mat: RoutedCSR
    vals_lo: torch.Tensor  # (rows_a, 128) f32
    hdense_hi: Optional[torch.Tensor] = None  # (n_heavy, n_pad) f32
    hdense_lo: Optional[torch.Tensor] = None
    heavy_rows_df: Tuple[int, ...] = ()

    @property
    def shape(self):
        return self.mat.shape

    @property
    def nnz(self):
        return self.mat.nnz


#: dense f64 heavy-block budget (bytes, as (hi, lo) f32 pairs); beyond it the
#: heavy rows reduce over the multi-level runs
_DF_HDENSE_MAX_BYTES = 256 * 2**20


def prepare_routed_df(csr: CSRMatrix, device="cuda") -> RoutedDF:
    """The JAX package's prepare_routed_df: the heavy rows into a dense
    (hi, lo) block when it fits the budget, then the routed layout of the
    light rows over the hi words, and the lo words at the same slots (the
    JAX package runs a second, structure-identical prepare for them). On
    `device`: the card unless the caller passes device="cpu"."""
    from ..ops.dfloat import split_f64

    device = target_device(device)
    m, n = csr.shape
    lens_full = np.diff(csr.indptr.astype(np.int64))
    thr = _pick_heavy_threshold(csr, lens_full, torch.float32)
    heavy_sel = lens_full >= thr
    n_pad = -(-n // LANE) * LANE
    hdense = (None, None)
    heavy_rows: Tuple[int, ...] = ()
    if heavy_sel.any() and (
        int(heavy_sel.sum()) * n_pad * 8 <= _DF_HDENSE_MAX_BYTES
        and lens_full[~heavy_sel].sum() > 0
    ):
        rows_h = np.flatnonzero(heavy_sel)
        rows_all = csr.row_ids().astype(np.int64)
        hd = np.zeros((rows_h.size, n_pad), dtype=np.float64)
        row_map = np.full(m, -1, dtype=np.int64)
        row_map[rows_h] = np.arange(rows_h.size)
        hnz = heavy_sel[rows_all]
        hd[row_map[rows_all[hnz]], csr.indices[hnz]] = csr.data[hnz]
        hdense = tuple(torch.from_numpy(a).to(device) for a in split_f64(hd))
        heavy_rows = tuple(int(r) for r in rows_h)
        keep = ~hnz
        csr = CSRMatrix(
            shape=(m, n),
            indptr=np.r_[0, np.cumsum(np.where(heavy_sel, 0, lens_full))],
            indices=csr.indices[keep],
            data=csr.data[keep],
        )
    hi, lo = split_f64(csr.data)
    mat, row_a, lane_a = _prepare_routed_placed(
        CSRMatrix(shape=csr.shape, indptr=csr.indptr, indices=csr.indices, data=hi),
        heavy_threshold=1 << 60,
        device=device,
    )
    vals_lo = np.zeros((mat.rows_a, LANE), dtype=np.float32)
    vals_lo[row_a, lane_a] = lo
    return RoutedDF(
        mat=mat, vals_lo=torch.from_numpy(vals_lo).to(device),
        hdense_hi=hdense[0], hdense_lo=hdense[1], heavy_rows_df=heavy_rows,
    )


def prepare_routed_df_auto(csr: CSRMatrix, device="cuda"):
    """RoutedDF for one domain, RoutedChunks of RoutedDF otherwise: the
    chunk bounds of the float32 chunked prepare, each chunk df-prepared (the
    JAX package's prepare_routed_df_auto), on `device` (the card unless the
    caller passes device="cpu")."""
    device = target_device(device)
    try:
        return prepare_routed_df(csr, device=device)
    except RoutedError:
        bounds = routed_chunk_bounds(csr)
        chunks = tuple(
            prepare_routed_df(_sub_csr(csr, r0, r1), device=device)
            for r0, r1 in zip(bounds[:-1], bounds[1:])
        )
        return RoutedChunks(chunks=chunks, bounds=bounds, shape=csr.shape, nnz=csr.nnz)
