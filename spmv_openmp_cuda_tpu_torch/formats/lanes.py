"""Lane-gather sparse format for small general matrices (PL_CSR_LANES).

Counterpart of the host half of spmv_openmp_cuda_tpu/formats/lanes.py; the
prepare is the JAX package's, array for array. x is viewed in windows of
128 panels x 128 residues = 16384 values. Each nnz (r, c, v) takes a slot
in a (128, 128) tile of its window: slot row a = c % 128 (its residue),
lane l = r % 128 (its output lane); nnz that collide on (window, residue,
lane) stack into further tiles of the window. The slot holds v, the panel
p = (c // 128) % 128 and the row group g = r // 128, so slot (s, l) of a
tile of window w stands for column w*16384 + p*128 + (s % 128) and row
g*128 + l. The JAX package's format exists because its TPU kernel can only
gather within one 128-lane row; the CUDA kernel (ops/lanes_cuda.py) gathers
x by that column directly. The engine serves G = ceil(m/128) <= 64 row
groups and at most 2^20 slots (small matrices: delaunay, west2021, cavity,
raefsky).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import LANE
from .matrix import CSRMatrix
from .routed import n_windows_for

WINDOW_PANELS = LANE  # panels per window
WINDOW_ELEMS = LANE * WINDOW_PANELS  # 16384 x values per window


class LanesError(ValueError):
    """Matrix not eligible for this engine (too many row groups / slots)."""


@dataclasses.dataclass
class LanesSmall:
    """Slot arrays of the lane-gather engine.

    vals/pidx/gid are (Ks, 128) slot slabs; slot rows [t*128, (t+1)*128)
    form tile t; window_tiles[w] = (tile_lo, tile_hi) is window w's
    half-open tile range, and tile_win[t] the window of tile t (the same
    map as a device array, for the kernel). Empty slots have vals 0 and
    pidx = gid = 0.
    """

    vals: torch.Tensor  # (Ks, 128) dtype
    pidx: torch.Tensor  # (Ks, 128) int32: panel within the window
    gid: torch.Tensor  # (Ks, 128) int32: output row group
    tile_win: torch.Tensor  # (Ks // 128,) int32: window of each tile
    window_tiles: Tuple[Tuple[int, int], ...]
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    n_groups: int = 0


def tile_windows(window_tiles: Tuple[Tuple[int, int], ...], n_tiles: int) -> np.ndarray:
    """window_tiles as a per-tile window id; tiles past the last window's
    range (the padding of an empty matrix) take window 0."""
    out = np.zeros(n_tiles, dtype=np.int32)
    for w, (t0, t1) in enumerate(window_tiles):
        out[t0:t1] = w
    return out


def prepare_lanes_small(
    csr: CSRMatrix,
    dtype: torch.dtype = torch.float32,
    max_groups: int = 64,
    max_slots: int = 1 << 20,  # total slots (slot rows * 128)
    device="cpu",
) -> LanesSmall:
    m, n = csr.shape
    g_count = -(-m // LANE)
    if g_count > max_groups:
        raise LanesError(f"{g_count} row groups > {max_groups}; use the large-G engine")
    rows = csr.row_ids().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    w = cols // WINDOW_ELEMS
    a = cols % LANE  # residue -> slot row within the tile
    p = (cols // LANE) % WINDOW_PANELS  # panel within the window
    l = rows % LANE  # output lane
    g = rows // LANE  # output group

    # stack depth: ordinal of each nnz within its (window, residue, lane) cell
    cell = (w * LANE + a) * LANE + l
    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    starts = np.r_[0, np.flatnonzero(np.diff(cell_sorted)) + 1]
    run_id = np.zeros(cell_sorted.shape[0], dtype=np.int64)
    run_id[starts] = 1
    run_id = np.cumsum(run_id) - 1
    depth_sorted = np.arange(cell_sorted.shape[0]) - starts[run_id]
    depth = np.empty_like(depth_sorted)
    depth[order] = depth_sorted

    nwin = n_windows_for(n, int(w.max(initial=0)) if cols.size else 0, WINDOW_ELEMS)
    tiles_per_win = np.zeros(nwin, dtype=np.int64)
    np.maximum.at(tiles_per_win, w, depth + 1)
    tile_base = np.r_[0, np.cumsum(tiles_per_win)]
    ks = int(tile_base[-1]) * LANE
    if ks * LANE > max_slots:
        raise LanesError(f"{ks * LANE} slots exceed cap {max_slots}")

    rows_pad = max(ks, LANE)
    vals = np.zeros((rows_pad, LANE), dtype=np.float64)
    pidx = np.zeros((rows_pad, LANE), dtype=np.int32)
    gid = np.zeros((rows_pad, LANE), dtype=np.int32)
    slot_row = (tile_base[w] + depth) * LANE + a
    vals[slot_row, l] = csr.data
    pidx[slot_row, l] = p
    gid[slot_row, l] = g
    window_tiles = tuple((int(tile_base[i]), int(tile_base[i + 1])) for i in range(nwin))
    return LanesSmall(
        vals=torch.as_tensor(vals, dtype=dtype, device=device),
        pidx=torch.as_tensor(pidx, device=device),
        gid=torch.as_tensor(gid, device=device),
        tile_win=torch.as_tensor(tile_windows(window_tiles, rows_pad // LANE), device=device),
        window_tiles=window_tiles,
        shape=(m, n),
        nnz=csr.nnz,
        n_groups=g_count,
    )
