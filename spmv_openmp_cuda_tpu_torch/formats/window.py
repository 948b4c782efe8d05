"""Windowed local-gather SpMV engine: the host side (PL_CSR_WINDOW).

Counterpart of spmv_openmp_cuda_tpu/formats/window.py, up to its kernels:
the geometry scan, the cap and group-size cost scans, the edge-coloring
slot packing and the slab fill, numpy as there, with torch tensors in place
of jnp arrays. The kernels that read the layout are in ops/window_cuda.py.

Layout (one TPU grid step per block of g*128 rows): a slot (block i, slot
row k, lane l) holds one nnz of output row lane l = row % 128 and column
residue c % 128 (`sidx`); within a slot row, all slots of one residue read
the same window row, given by the Q map `rsrc`; slot rows [0, k_c) hold only
entries whose row group gid satisfies gid % 8 == k % 8 (the mod-8 fold, with
gid // 8 stored), rows [k_c, k_pad) any gid (stored whole). Packing is a
proper edge coloring of the per-block (out-lane x source-residue) bipartite
multigraph, so the Q constraint holds with nothing left over.

The cost model, the cap, group-size and blocks-per-step ladders are the JAX
package's, fitted on a TPU v5e, and are kept unchanged so that the port
chooses the same layout array for array (the tests hold it so). Refitting
g, cap and bps for the H100 is later work.

The double-float (f64) mode (`df=True`) stores the slot values as an (hi,
lo) f32 pair, `vals` and `vals_lo`; the layout does not depend on the values,
so the hi plane equals the f32 mode's `vals`. The scan, the rank and the
slot fill run the native C++ passes (io/native.py) when the library is
available, as in the JAX package; the numpy paths below are its own
fallbacks, and what runs on a host without g++.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import LANE
from .matrix import CSRMatrix, target_device


class WindowError(ValueError):
    """Matrix not eligible (window too wide or padding too high)."""


@dataclasses.dataclass
class WindowCSR:
    """Prepared windowed-gather format (see module docstring)."""

    vals: torch.Tensor  # (nblocks*k_pad, 128) f32 or bf16: slot values
    sidx: torch.Tensor  # (nblocks*k_pad, 128) int8: c % 128 per slot
    gid: torch.Tensor  # (nblocks*k_pad, 128) int8: rows < k_c: gid // 8
    # (gid % 8 == slot row % 8 by construction); rows >= k_c: full gid
    rsrc: torch.Tensor  # (nblocks*n_ktiles*128, 128) int8: the Q map; per
    # slot-row tile, Q[residue, slot-row-in-tile] = window row that slots of
    # this row sourcing this residue read from
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    g: int = 8  # row groups per block (block = g*128 rows)
    k_pad: int = 8  # slot rows per block (padded)
    wr: int = 1  # window radius in 128-chunks
    nspecs: int = 2  # staged 8-row x blocks per TPU grid step
    nblocks: int = 1
    k_c: int = 0  # mod-8-constrained slot rows (0 = global packing)
    bps: int = 1  # blocks per TPU grid step
    # single-block layout: Q addresses x chunk-rows directly (no wr shift)
    xdirect: bool = False
    # bps > 1 with Q baked relative to the union window of the bps blocks
    shared_w: bool = False
    # double-float mode: the f32 lo words of the f64 slot values (vals then
    # holds the hi words); the engine takes x and returns y in f64
    vals_lo: Optional[torch.Tensor] = None

    @property
    def n_ktiles(self) -> int:
        return -(-self.k_pad // LANE)


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


#: packing row cap per block (TPU VMEM residency of the slot slabs)
_K_CAP = 16 * LANE

#: cap ladder for the mod-8 class coloring (k_c = 8*sum(caps)); None =
#: global packing. Tuples are multi-band peels: each band colors the
#: previous bands' leftover with its own pow2 Euler split.
_CAP_LADDER = (
    None, 8, 16, 32, 64, 128,
    (8, 4), (16, 8), (16, 8, 4), (32, 16), (32, 16, 8),
    (64, 32), (64, 32, 16), (128, 32),
)


def _base_fields(csr: CSRMatrix):
    """g-independent per-nnz fields, computed once for all the (g, cap)
    scans."""
    rows = csr.row_ids().astype(np.int64)
    rq = rows // LANE  # 128-row chunk of the output row
    lane = rows % LANE
    cols = csr.indices.astype(np.int64)
    q = cols // LANE  # 128-element chunk of the column
    jres = cols % LANE
    return rq, lane, q, jres


def _scan_g(csr: CSRMatrix, g: int, base, want_hist: bool):
    """Per-g prepare scan: (wr, nspecs, nblocks, dl8, dr8). One fused
    threaded pass through the native library when it is available
    (io/native.py), numpy passes otherwise. dl8/dr8 (the (nblocks, 8, 128)
    per-(block, gid%8) lane/residue degree histograms) are None when
    want_hist is False and the numpy path runs."""
    from ..io.native import window_scan_native

    m, n = csr.shape
    nblocks = -(-m // (g * LANE))
    rq, lane, q, jres = base
    res = window_scan_native(rq, lane, q, jres, g, nblocks)
    if res is not None:
        d_min, d_max, dl8, dr8 = res
    else:
        blk = rq // g
        d = q - blk * g  # chunk relative to block start
        d_min = int(d.min(initial=0))
        d_max = int(d.max(initial=0))
        if want_hist:
            cls = (rq % g) % 8
            key = (blk * 8 + cls) * LANE
            dl8 = np.bincount(
                key + lane, minlength=nblocks * 8 * LANE
            ).reshape(nblocks, 8, LANE)
            dr8 = np.bincount(
                key + jres, minlength=nblocks * 8 * LANE
            ).reshape(nblocks, 8, LANE)
        else:
            dl8 = dr8 = None
    wr = max(max(-d_min, 0), max(d_max - g + 1, 0), 1)
    s_w = g + 2 * wr
    # the TPU kernel stages the x window in 8-row blocks at index (i*g)//8 + j,
    # with the per-block remainder (i*g) % 8 folded into the Q data host-side
    nspecs = -(-(s_w + 7) // 8)
    if nspecs * 8 > LANE:
        raise WindowError(f"window span {s_w} chunk-rows exceeds the 128 cap")
    return wr, nspecs, nblocks, dl8, dr8


def _geometry(csr: CSRMatrix, g: int, base=None):
    """(wr, nspecs, nblocks): window reach for group size g."""
    if base is None:
        base = _base_fields(csr)
    return _scan_g(csr, g, base, want_hist=False)[:3]


def _rank_in_group(keys: np.ndarray, minlength: int) -> np.ndarray:
    """rank[i] = #entries before i (stable order) with the same key.

    Keys here are blk * (8*LANE) + local with a non-decreasing blk prefix
    (CSR row order): the native O(n) threaded pass applies when the library
    is available; the argsort is the fallback."""
    from ..io.native import rank_in_group_native

    nblocks = minlength // (8 * LANE)
    if keys.size and nblocks > 0:
        out = rank_in_group_native(keys, 8 * LANE, nblocks)
        if out is not None:
            return out
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    n = sk.size
    ranks = np.empty(n, np.int64)
    if n:
        newrun = np.r_[True, sk[1:] != sk[:-1]]
        run_start = np.maximum.accumulate(np.where(newrun, np.arange(n), 0))
        ranks[order] = np.arange(n) - run_start
    return ranks


def _entry_fields(csr: CSRMatrix, g: int, base=None):
    rq, lane, q, jres = base if base is not None else _base_fields(csr)
    blk = rq // g
    gid = rq % g
    return q, blk, lane, jres, gid


def _cap_bands(cap) -> tuple:
    """Normalize a cap spec to a tuple of pow2 band caps: tuples pass
    through (validated), ints decompose by binary expansion (12 -> (8, 4))
    so any total is expressible as stacked Euler-colorable bands."""
    if isinstance(cap, tuple):
        for c in cap:
            if c <= 0 or c & (c - 1):
                raise WindowError(f"band caps must be powers of two: {cap}")
        return cap
    if cap <= 0:
        raise WindowError(f"cap must be positive: {cap}")
    return tuple(1 << b for b in range(cap.bit_length() - 1, -1, -1)
                 if cap >> b & 1)


def _peel_once(blk, lane, jres, cls, nblocks, cap, remaining):
    """One two-pass rank peel over the still-unassigned entries: keep mask
    (within `remaining`) whose per-(block, class) lane AND residue degrees
    are <= cap."""
    idx = np.where(remaining)[0]
    key_l = ((blk * 8 + cls) * LANE + lane)[idx]
    rl = _rank_in_group(key_l, nblocks * 8 * LANE)
    k1 = rl < cap
    key_r = ((blk * 8 + cls) * LANE + jres)[idx[k1]]
    rr = _rank_in_group(key_r, nblocks * 8 * LANE)
    kept = idx[k1][rr < cap]
    keep = np.zeros(remaining.shape[0], bool)
    keep[kept] = True
    return keep


def _overflow_v(blk, lane, jres, nblocks, of):
    """Overflow color budget: pow2 of the class-blind per-block degrees."""
    if not of.any():
        return 0
    dl = np.bincount((blk * LANE + lane)[of], minlength=nblocks * LANE)
    dr = np.bincount((blk * LANE + jres)[of], minlength=nblocks * LANE)
    return _next_pow2(max(int(dl.max()), int(dr.max()), 8))


def _class_split(blk, lane, jres, gid, nblocks, cap):
    """Rank peel(s) for the mod-8 class region + overflow V. Band b peels
    the previous bands' leftover at cap[b] and occupies slot rows
    [8*sum(cap[:b]), 8*sum(cap[:b+1])). Returns (band keep masks, v)."""
    caps = _cap_bands(cap)
    cls = gid % 8
    remaining = np.ones(blk.shape[0], bool)
    bands = []
    for c in caps:
        keep = _peel_once(blk, lane, jres, cls, nblocks, c, remaining)
        bands.append(keep)
        remaining &= ~keep
    v = _overflow_v(blk, lane, jres, nblocks, remaining)
    return tuple(bands), v


#: the JAX package's cost-model constants (ps per element / per step),
#: fitted on a TPU v5e. They rank layouts only; no port time derives from
#: them.
_C_GATHER = 0.0
_C_TILE = 9.83  # per assembly element (n_ktiles*128*128 per block)
_C_PASS = 0.53
_C_FOLD = 0.88  # per constrained slot per ceil(g/8)-pass
_C_BLOCK = 331_000.0  # fixed per grid step
#: x pad/shift chain of a multi-block layout, which xdirect skips
_C_PADCHAIN = 430_000.0


def _cost_of(g: int, cap, k_c: int, v: int, nblocks: int, bps: int = 1) -> float:
    nh = -(-g // 8)
    k_pad = k_c + v
    n_ktiles = -(-k_pad // LANE)
    return (
        k_pad * LANE * nblocks * _C_GATHER
        + n_ktiles * LANE * LANE * nblocks * _C_TILE
        + k_c * LANE * nblocks * _C_FOLD * nh
        + v * LANE * nblocks * _C_PASS * g
        + (-(-nblocks // bps)) * _C_BLOCK
    )


def _cap_candidates(csr: CSRMatrix, g: int, base=None):
    """Feasible (cap, k_c, V) configs for group size g over the cap ladder,
    plus nblocks. V per cap is estimated from per-class degree excess
    (histograms only); prepare_window re-peels the chosen config exactly."""
    if base is None:
        base = _base_fields(csr)
    _wr, _nspecs, nblocks, dl8, dr8 = _scan_g(csr, g, base, want_hist=True)
    d_glob = _next_pow2(
        max(int(dl8.sum(axis=1).max(initial=1)),
            int(dr8.sum(axis=1).max(initial=1)), 16)
    )
    cands = []
    for cap in _CAP_LADDER:
        if cap is None:
            k_c, v = 0, d_glob
        else:
            total = sum(cap) if isinstance(cap, tuple) else cap
            ofl = np.maximum(dl8 - total, 0).sum(axis=1)
            ofr = np.maximum(dr8 - total, 0).sum(axis=1)
            d_of = max(int(ofl.max(initial=0)), int(ofr.max(initial=0)))
            v = _next_pow2(max(d_of, 8)) if d_of else 0
            k_c = 8 * total
        if k_c + v > _K_CAP:
            continue
        cands.append((cap, k_c, v))
    if not cands:
        raise WindowError("no feasible packing under the row cap")
    return cands, nblocks


def _pad_ok(nnz: int, k_pad: int, nblocks: int, max_pad: float) -> bool:
    """prepare_window's slot-padding feasibility cap, which the scans apply
    too."""
    return nblocks * k_pad * LANE <= max_pad * nnz


def _feasible_costed(cands, nblocks, bps_list, nnz, max_pad, g):
    """The one feasibility + cost rule every scan shares: yields
    (cap, k_c, v, bps, cost) for configs within the per-step row cap and
    the slot-padding cap (the checks prepare_window enforces)."""
    for b in bps_list:
        for cap, k_c, v in cands:
            if (k_c + v) * b > _K_CAP:
                continue
            if not _pad_ok(nnz, k_c + v, nblocks, max_pad):
                continue
            yield cap, k_c, v, b, _cost_of(g, cap, k_c, v, nblocks, b)


def _scan_caps(
    csr: CSRMatrix, g: int, bps: int = 1, max_pad: float = 4.5, base=None
):
    """Best (cap, k_c, V, cost) for group size g at a given blocks-per-step."""
    cands, nblocks = _cap_candidates(csr, g, base)
    best = None
    for cap, k_c, v, _b, cost in _feasible_costed(
        cands, nblocks, (bps,), csr.nnz, max_pad, g
    ):
        if best is None or cost < best[3]:
            best = (cap, k_c, v, cost)
    if best is None:
        raise WindowError("no feasible packing under the row/padding caps")
    return best


def _pack_coloring(blk, lane, jres, nblocks, d_target):
    """Proper edge coloring of the (out-lane x source-residue) bipartite
    multigraph: slot row = color. The graph is padded to exactly D-regular
    with dummy edges and colored by Euler splitting (ops/route.py); D must
    be a power of two."""
    from ..ops.route import color_bipartite_pow2

    assert d_target & (d_target - 1) == 0
    n = blk.shape[0]
    left = blk * LANE + lane
    right = blk * LANE + jres
    dl = np.bincount(left, minlength=nblocks * LANE)
    dr = np.bincount(right, minlength=nblocks * LANE)
    if max(dl.max(initial=0), dr.max(initial=0)) > d_target:
        raise WindowError("degree exceeds the color budget")
    # dummy edges: pair left/right deficiency slots blockwise
    pad_l = np.repeat(np.arange(nblocks * LANE), d_target - dl)
    pad_r = np.repeat(np.arange(nblocks * LANE), d_target - dr)
    colors = color_bipartite_pow2(
        np.r_[left, pad_l], np.r_[right, pad_r], d_target
    )
    return colors[:n].astype(np.int64)


def _slot_rows(blk, lane, jres, gid, nblocks, cap):
    """Slot row of every nnz by exact Euler edge coloring: per-class band
    peels + pow2 colorings, overflow colored class-blind (the JAX package's
    `_legacy_srow`, its live path). Returns (srow, k_c, v)."""
    srow = np.empty(gid.shape[0], np.int64)
    if cap is None:
        dl = np.bincount(blk * LANE + lane, minlength=nblocks * LANE)
        dr = np.bincount(blk * LANE + jres, minlength=nblocks * LANE)
        k_c = 0
        v = _next_pow2(
            max(int(dl.max(initial=1)), int(dr.max(initial=1)), 16)
        )
        keep = np.zeros(gid.shape[0], bool)
    else:
        caps = _cap_bands(cap)
        bands, v = _class_split(blk, lane, jres, gid, nblocks, caps)
        k_c = 8 * sum(caps)
        cls = gid % 8
        keep = np.zeros(gid.shape[0], bool)
        base_row = 0
        for cap_b, keep_b in zip(caps, bands):
            for r in range(8):
                sel = keep_b & (cls == r)
                if not sel.any():
                    continue
                colors = _pack_coloring(
                    blk[sel], lane[sel], jres[sel], nblocks, cap_b
                )
                srow[sel] = base_row + r + 8 * colors
            keep |= keep_b
            base_row += 8 * cap_b
    if v:
        of = ~keep
        colors = _pack_coloring(blk[of], lane[of], jres[of], nblocks, v)
        srow[of] = k_c + colors
    return srow, k_c, v


def prepare_window(
    csr: CSRMatrix, g: int = 8, dtype: torch.dtype = torch.float32,
    vals_dtype=None, max_pad: float = 4.5, cap="auto", bps: int = 1,
    xdirect: bool = False, base=None, shared_w: bool | None = None,
    device="cuda", df: bool = False,
) -> WindowCSR:
    """Slot slabs and Q map for group size g, array for array the JAX
    package's prepare_window, on `device` (the card unless the caller passes
    device="cpu"). df=True splits the slot values into the (hi, lo) f32 pair
    (dtype is ignored)."""
    device = target_device(device)
    if vals_dtype is None:
        vals_dtype = dtype
    m, n = csr.shape
    if csr.nnz == 0 or m == 0:
        raise WindowError("empty matrix")
    assert 2 <= g <= 64, "g must be in [2, 64] (output rows per block)"
    if bps > 1 and g % 8:
        raise WindowError("bps > 1 requires g % 8 == 0 (uniform staging)")
    if base is None:
        base = _base_fields(csr)
    wr, nspecs, nblocks = _geometry(csr, g, base)
    # union staging: auto-on when the union span fits the 128-row window
    ns_tot = (bps - 1) * (g // 8) + nspecs if bps > 1 else nspecs
    if shared_w is None:
        shared_w = bps > 1 and ns_tot * 8 <= LANE
    elif shared_w:
        if bps <= 1:
            shared_w = False
        elif ns_tot * 8 > LANE:
            raise WindowError(
                f"shared_w union span {ns_tot * 8} rows exceeds the 128 cap"
            )
    q, blk, lane, jres, gid = _entry_fields(csr, g, base)

    if cap == "auto":
        cap = _scan_caps(csr, g, bps=bps, max_pad=max_pad, base=base)[0]

    srow, k_c, v = _slot_rows(blk, lane, jres, gid, nblocks, cap)

    k_pad = k_c + v
    n_ktiles = -(-k_pad // LANE)
    if nblocks * k_pad * LANE > max_pad * csr.nnz:
        raise WindowError(
            f"padding {nblocks * k_pad * LANE / csr.nnz:.1f}x "
            f"exceeds {max_pad}x cap"
        )
    if k_pad > _K_CAP:
        raise WindowError(f"{k_pad} slot rows exceed the row cap")
    if k_pad * bps > _K_CAP:
        raise WindowError(
            f"bps={bps} x {k_pad} slot rows exceed the per-step row cap"
        )

    if xdirect:
        if nblocks != 1 or -(-n // LANE) > LANE:
            raise WindowError("xdirect needs a single block and x <= 128 "
                              "chunk-rows")
        bps = 1
        shared_w = False

    # slot slabs + Q map bake:
    # - vals/sidx at (blk*k_pad + srow, lane);
    # - gslab: constrained rows store gid // 8, overflow rows the full gid;
    # - rsrc: per slot-row tile, Q[residue, slot-row-in-tile] = window row
    #   (unset pairs read window row 0; their slots have vals == 0). The
    #   window row is dq plus the per-block staging remainder (the window
    #   starts at padded-x row blk*g, staged from 8-row block (blk*g)//8);
    #   xdirect addresses x chunk-rows directly (== q); shared_w is relative
    #   to the union window of the bps blocks of one step.
    vals = np.zeros((nblocks * k_pad, LANE), dtype=np.float64)
    sidx = np.zeros((nblocks * k_pad, LANE), dtype=np.int8)
    gslab = np.zeros((nblocks * k_pad, LANE), dtype=np.int8)
    rsrc = np.zeros((nblocks * n_ktiles * LANE, LANE), dtype=np.int8)
    from ..io.native import window_fill_native

    # the native fill does all of this in one threaded pass
    mode = 1 if xdirect else 2 if shared_w else 0
    if not window_fill_native(
        base[0], lane, q, jres, srow, csr.data, g, k_pad, k_c, n_ktiles,
        wr, bps, mode, vals, sidx, gslab, rsrc,
    ):
        dq = q - blk * g + wr  # window row in [0, nspecs*g)
        slot_row = blk * k_pad + srow
        vals[slot_row, lane] = csr.data
        sidx[slot_row, lane] = jres.astype(np.int8)
        gslab[slot_row, lane] = np.where(srow < k_c, gid // 8, gid).astype(np.int8)
        t_of = srow // LANE
        jj_in = srow % LANE
        if xdirect:
            dq_staged = q
        elif shared_w:
            dq_staged = dq + (blk % bps) * g
        else:
            dq_staged = dq + (blk * g) % 8
        rsrc[(blk * n_ktiles + t_of) * LANE + jres, jj_in] = dq_staged.astype(np.int8)

    nblocks_pad = -(-nblocks // bps) * bps
    if nblocks_pad > nblocks:
        # trailing all-zero blocks fill the last step; their outputs fall
        # past row m and are dropped
        def _ext(a, rows):
            return np.concatenate(
                [a, np.zeros(((nblocks_pad - nblocks) * rows, LANE), a.dtype)]
            )

        vals = _ext(vals, k_pad)
        sidx = _ext(sidx, k_pad)
        gslab = _ext(gslab, k_pad)
        rsrc = _ext(rsrc, n_ktiles * LANE)

    if df:
        from ..ops.dfloat import split_f64

        vhi, vlo = split_f64(vals)
        vals_t, vals_lo_t = torch.from_numpy(vhi).to(device), torch.from_numpy(vlo).to(device)
    else:
        vals_t, vals_lo_t = torch.from_numpy(vals).to(vals_dtype).to(device), None
    return WindowCSR(
        vals=vals_t,
        vals_lo=vals_lo_t,
        sidx=torch.from_numpy(sidx).to(device),
        gid=torch.from_numpy(gslab).to(device),
        rsrc=torch.from_numpy(rsrc).to(device),
        shape=(m, n),
        nnz=csr.nnz,
        g=g,
        k_pad=k_pad,
        wr=wr,
        nspecs=nspecs,
        nblocks=nblocks_pad,
        k_c=k_c,
        bps=bps,
        xdirect=xdirect,
        shared_w=shared_w,
    )


#: candidate group sizes for the auto scan
_G_LADDER = (4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48, 56, 64)

#: blocks-per-step candidates for the joint auto scan (requires g % 8 == 0)
_BPS_LADDER = (1, 2, 4, 8)

#: bps policy: "auto" scans (g, cap, bps) jointly; SPMV_WINDOW_BPS
#: overrides (an integer forces that bps), as in the JAX package
_BPS_POLICY_DEFAULT = "auto"


def _bps_policy() -> str:
    return os.environ.get("SPMV_WINDOW_BPS", "") or _BPS_POLICY_DEFAULT


def _bps_options(g: int, nblocks: int, policy: str):
    if policy != "auto":
        return (int(policy),) if int(policy) == 1 or g % 8 == 0 else (1,)
    if g % 8:
        return (1,)
    return tuple(b for b in _BPS_LADDER if b == 1 or b <= nblocks)


def _xdirect_eligible(csr: CSRMatrix, nblocks: int) -> bool:
    return nblocks == 1 and -(-csr.shape[1] // LANE) <= LANE


def window_cost(
    csr: CSRMatrix, g: int, bps: int | None = None, max_pad: float = 4.5,
    base=None,
) -> float:
    """Model cost (the JAX package's TPU-fitted units), minimized over the
    cap ladder (and the bps ladder when the policy is auto). Multi-block
    configs carry the x pad-chain charge xdirect configs skip; configs
    prepare_window would reject are skipped."""
    if bps is not None:
        return _scan_caps(csr, g, bps, max_pad, base)[3]
    cands, nblocks = _cap_candidates(csr, g, base)
    extra = 0.0 if _xdirect_eligible(csr, nblocks) else _C_PADCHAIN
    best = None
    for *_cfg, cost in _feasible_costed(
        cands, nblocks, _bps_options(g, nblocks, _bps_policy()),
        csr.nnz, max_pad, g,
    ):
        if best is None or cost + extra < best:
            best = cost + extra
    if best is None:
        raise WindowError("no feasible packing under the row/padding caps")
    return best


def window_cost_scan(csr: CSRMatrix, max_pad: float = 4.5) -> float:
    """Best model cost over the whole g ladder, sharing one per-nnz field
    pass (the format-selection entry point)."""
    base = _base_fields(csr)
    best = None
    for g in _G_LADDER:
        try:
            cost = window_cost(csr, g, max_pad=max_pad, base=base)
        except WindowError:
            continue
        if best is None or cost < best:
            best = cost
    if best is None:
        raise WindowError("no feasible window configuration")
    return best


#: exact-prepare depth of the auto scan (the histogram V estimate can
#: misrank the top candidates)
_AUTO_SHORTLIST = 5


def prepare_window_auto(
    csr: CSRMatrix, dtype: torch.dtype = torch.float32, vals_dtype=None,
    max_pad: float = 4.5, bps: int | None = None, xdirect: bool | None = None,
    device="cuda", df: bool = False,
) -> WindowCSR:
    """Pick group size g, packing cap and blocks-per-step by the cost model
    (the JAX package's prepare_window_auto), on `device` (the card unless
    the caller passes device="cpu"). bps=None follows the policy; an
    explicit bps pins it. df=True prepares the double-float mode."""
    device = target_device(device)
    policy = str(bps) if bps is not None else _bps_policy()
    base = _base_fields(csr)
    by_g = {}
    for g in _G_LADDER:
        try:
            cands, nblocks = _cap_candidates(csr, g, base)
        except WindowError:
            continue
        eligible = _xdirect_eligible(csr, nblocks)
        if xdirect is True and not eligible:
            continue  # pinned xdirect: only single-block configs qualify
        extra = (
            _C_PADCHAIN if (xdirect is False or not eligible) else 0.0
        )
        for cap, _k_c, _v, b, cost in _feasible_costed(
            cands, nblocks, _bps_options(g, nblocks, policy),
            csr.nnz, max_pad, g,
        ):
            if g not in by_g or cost + extra < by_g[g][1]:
                by_g[g] = (g, cost + extra, cap, b, eligible)
    if not by_g:
        raise WindowError("no feasible window configuration")
    # exact-prepare the best few distinct-g candidates and decide on their
    # exact geometry (the histogram V estimate is optimistic)
    short = sorted(by_g.values(), key=lambda t: t[1])[:_AUTO_SHORTLIST]
    best = (None, float("inf"))
    for g, est, cap, bps_pick, eligible in short:
        if est >= best[1]:
            continue  # the estimate is a lower bound: this one cannot win
        mat = _try_prepare_auto(
            csr, g, cap, bps_pick, dtype, vals_dtype, max_pad,
            eligible if xdirect is None else xdirect,
            base, bps_auto=policy == "auto", device=device, df=df,
        )
        if mat is None:
            continue
        exact = _cost_of(
            g, cap, mat.k_c, mat.k_pad - mat.k_c, mat.nblocks, mat.bps
        )
        if exact < best[1]:
            best = (mat, exact)
    if best[0] is None:
        raise WindowError("no feasible window configuration")
    return best[0]


def _try_prepare_auto(
    csr, g, cap, bps_pick, dtype, vals_dtype, max_pad, xdirect, base,
    bps_auto=True, *, device, df=False,
):
    # the exact peel can land just over the per-step row cap at the chosen
    # bps: halve bps until it fits, only when the auto policy chose bps (a
    # pinned bps must not silently degrade)
    b = 1 if xdirect else bps_pick
    while True:
        try:
            return prepare_window(
                csr, g=g, dtype=dtype, vals_dtype=vals_dtype,
                max_pad=max_pad, cap=cap, bps=b, xdirect=xdirect,
                base=base, device=device, df=df,
            )
        except WindowError:
            if not bps_auto:
                raise
            if b == 1:
                return None  # shortlist entry infeasible at exact peel
            b = max(b // 2, 1)
