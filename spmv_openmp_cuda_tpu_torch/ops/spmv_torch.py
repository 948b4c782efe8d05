"""Plain-torch SpMV modes: the reference's OpenMP strategy matrix.

Counterpart of spmv_openmp_cuda_tpu/ops/spmv_xla.py, whose eight functions
the JAX package runs as XLA ops; here they are torch ops on the device of
their inputs, at the dtype of the prepared arrays (native float64 on the card
under float64). They are glue around no hand-written kernel: CSR becomes a
gather of x plus a sorted segment sum, ELL a gather-multiply-reduce over the
padded (M, W) slabs, with the reference's schedules kept where they change
the order of the sums or the work:

- csr_rows_groups and ell_rows_groups loop over grid_rows row blocks
  (spmvRowsBlocksCSR / spmvRowsBlocksELL), each block reducing its own nnz
  range or slab rows;
- csr_tiles and ell_tiles materialize per (row, column-range) partials and
  reduce them at the end (spmvTilesCSR / spmvTilesELL), over fair splits;
- simd=False sums strictly left to right (SIMD_ROWS_REDUCTION=FALSE);
- row_lens masking of the ELL padding (the ROWLENS build).

Every sum is a segment or dense reduction, never an atomic scatter, so a
rerun on the card gives the same bits (the harness's det column).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..config import Config
from ..formats.matrix import (
    CSRMatrix,
    DeviceCSR,
    DeviceELL,
    ELLMatrix,
    device_csr,
    device_ell,
    fair_splits,
)
from ..partition.partitioners import cols_partitioning


def _row_reduce(prods: torch.Tensor, simd: bool) -> torch.Tensor:
    """Reduce (M, W) products along W.

    simd=True: one vectorized reduction (SIMD_ROWS_REDUCTION analog).
    simd=False: strict left-to-right accumulation over width chunks of 128
    when W is a multiple of 128, else of 1 (the scalar order the reference
    gets without `omp simd`).
    """
    if simd:
        return prods.sum(dim=1)
    w = prods.shape[1]
    chunk = 128 if w % 128 == 0 else 1
    acc = torch.zeros(prods.shape[0], dtype=prods.dtype, device=prods.device)
    for j in range(0, w, chunk):
        acc = acc + (prods[:, j : j + chunk].sum(dim=1) if chunk > 1 else prods[:, j])
    return acc


def _gather(x: torch.Tensor, cols: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x[cols] in dtype, for cols of any shape (int32 indices)."""
    return x.index_select(0, cols.reshape(-1)).reshape(cols.shape).to(dtype)


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------


def csr_rows(mat: DeviceCSR, x: torch.Tensor) -> torch.Tensor:
    """Row-parallel CSR SpMV (spmvRowsBasicCSR analog, SpMV_CSR_OMP.c:34-63):
    gather x at cols, multiply, sorted segment sum by row (the row lengths
    are the segments; the padded tail is left out)."""
    nnz = mat.nnz
    prods = mat.data[:nnz] * _gather(x, mat.cols[:nnz], mat.data.dtype)
    return torch.segment_reduce(prods, "sum", lengths=mat.row_lens, unsafe=True)


def csr_rows_groups(
    mat: DeviceCSR,
    x: torch.Tensor,
    starts: Sequence[int],
    rows_per_block: int,
    max_ext: int,
) -> torch.Tensor:
    """Fair row-block CSR SpMV (spmvRowsBlocksCSR analog,
    SpMV_CSR_OMP.c:65-99), a blocked schedule and not an alias of csr_rows:
    block b owns rows [b*rpb, (b+1)*rpb) and the nnz range [starts[b],
    starts[b+1]). Each block, in a loop, slices max_ext entries of the
    product stream at its offset, masks the overhang, and segment-sums them
    into its rpb rows plus an overflow segment that takes the overhang."""
    m = mat.shape[0]
    rpb = rows_per_block
    dev = x.device
    prods = mat.data * _gather(x, mat.cols, mat.data.dtype)
    prods_pad = torch.nn.functional.pad(prods, (0, max_ext))
    arange_ext = torch.arange(max_ext, device=dev)
    outs: List[torch.Tensor] = []
    for b in range(len(starts) - 1):
        s, ext = int(starts[b]), int(starts[b + 1]) - int(starts[b])
        p = torch.where(arange_ext < ext, prods_pad[s : s + max_ext], 0)
        r0, r1 = min(b * rpb, m), min((b + 1) * rpb, m)
        lens = torch.cat([
            mat.row_lens[r0:r1].long(),
            torch.zeros(rpb - (r1 - r0), dtype=torch.long, device=dev),
            torch.full((1,), max_ext - ext, dtype=torch.long, device=dev),
        ])
        outs.append(torch.segment_reduce(p, "sum", lengths=lens, unsafe=True)[:rpb])
    return torch.cat(outs)[:m]


def _bucketize_cols(cols: torch.Tensor, n: int, grid_cols: int) -> torch.Tensor:
    """Column index -> uniform column-range id (fair remainder split)."""
    splits = torch.as_tensor(fair_splits(n, grid_cols)[1:-1], dtype=cols.dtype, device=cols.device)
    return torch.searchsorted(splits, cols, right=True).to(torch.int32)


def csr_tiles(mat: DeviceCSR, x: torch.Tensor, grid_cols: int = 8) -> torch.Tensor:
    """2D-tiled CSR SpMV with partial sums (spmvTilesCSR analog,
    SpMV_CSR_OMP.c:101-162): each nnz lands in partial (row, column-range);
    the (M, grid_cols) partials, a sorted segment sum over row*grid_cols +
    bucket, are summed at the end."""
    m, n = mat.shape
    nnz = mat.nnz
    cols = mat.cols[:nnz]
    seg = mat.row_ids[:nnz] * grid_cols + _bucketize_cols(cols, n, grid_cols)
    bounds = torch.arange(m * grid_cols + 1, dtype=seg.dtype, device=seg.device)
    offsets = torch.searchsorted(seg, bounds)
    prods = mat.data[:nnz] * _gather(x, cols, mat.data.dtype)
    partials = torch.segment_reduce(prods, "sum", offsets=offsets, unsafe=True)
    return partials.reshape(m, grid_cols).sum(dim=1)


def csr_tiles_allocd(parts: Sequence[DeviceCSR], x: torch.Tensor) -> torch.Tensor:
    """2D-tiled CSR over separately allocated column partitions
    (spmvTilesAllocdCSR analog, SpMV_CSR_OMP.c:165-226): one csr_rows per
    partition (columns stay global), partials summed in partition order."""
    out = torch.zeros(parts[0].shape[0], dtype=parts[0].data.dtype, device=x.device)
    for p in parts:
        out = out + csr_rows(p, x)
    return out


# ---------------------------------------------------------------------------
# ELL
# ---------------------------------------------------------------------------


def _ell_prods(mat: DeviceELL, x: torch.Tensor, row_lens: bool) -> torch.Tensor:
    """data * x[cols] over the row-major slab, padding masked by row_lens."""
    prods = mat.data * _gather(x, mat.cols, mat.data.dtype)
    if row_lens:
        k = torch.arange(mat.data.shape[1], device=prods.device)
        prods = torch.where(k[None, :] < mat.row_lens[:, None], prods, 0)
    return prods


def ell_rows(
    mat: DeviceELL, x: torch.Tensor, row_lens: bool = True, simd: bool = True
) -> torch.Tensor:
    """Row-parallel ELL SpMV over the padded slab (spmvRowsBasicELL analog,
    SpMV_ELL_OMP.c:33-67); row_lens masks the padding (ROWLENS analog)."""
    return _row_reduce(_ell_prods(mat, x, row_lens), simd)[: mat.shape[0]]


def ell_rows_groups(
    mat: DeviceELL, x: torch.Tensor, grid_rows: int = 8, row_lens: bool = True
) -> torch.Tensor:
    """Fair row-block ELL SpMV (spmvRowsBlocksELL analog,
    SpMV_ELL_OMP.c:69-108), a blocked schedule and not an alias of ell_rows:
    the padded slab is cut into grid_rows row blocks, reduced block by block
    in a loop."""
    prods = _ell_prods(mat, x, row_lens)
    m_pad, w = prods.shape
    b = max(min(grid_rows, m_pad), 1)
    rpb = -(-m_pad // b)
    prods = torch.nn.functional.pad(prods, (0, 0, 0, b * rpb - m_pad))
    ys = [blk.sum(dim=1) for blk in prods.reshape(b, rpb, w)]
    return torch.cat(ys)[: mat.shape[0]]


def ell_tiles(
    mat: DeviceELL,
    x: torch.Tensor,
    grid_cols: int = 8,
    row_lens: bool = True,
    simd: bool = True,
) -> torch.Tensor:
    """2D-tiled ELL SpMV splitting the padded width (spmvTilesELL analog,
    SpMV_ELL_OMP.c:110-174): each fair width range gives one column of an
    (M, grid_cols) partial buffer, reduced at the end."""
    prods = _ell_prods(mat, x, row_lens)
    splits = fair_splits(prods.shape[1], grid_cols)
    partials = []
    for j in range(grid_cols):
        seg = prods[:, int(splits[j]) : int(splits[j + 1])]
        partials.append(
            _row_reduce(seg, simd) if seg.shape[1] else prods.new_zeros(prods.shape[0])
        )
    return torch.stack(partials, dim=1).sum(dim=1)[: mat.shape[0]]


def ell_rows_transposed(mat: DeviceELL, x: torch.Tensor, simd: bool = True) -> torch.Tensor:
    """ELL SpMV on the transposed (W, M) slab (cudaSpMVRowsELL analog,
    SpMV_CUDA.cu:79-96, over ellTranspose's layout): the reduction runs down
    W with unit-stride access along the rows. Needs mat.transposed."""
    if not mat.transposed:
        raise ValueError("ell_rows_transposed needs a transposed DeviceELL")
    prods = mat.data * _gather(x, mat.cols, mat.data.dtype)  # (W_pad, M_pad)
    if simd:
        return prods.sum(dim=0)[: mat.shape[0]]
    acc = torch.zeros(prods.shape[1], dtype=prods.dtype, device=prods.device)
    for row in prods:
        acc = acc + row
    return acc[: mat.shape[0]]


# ---------------------------------------------------------------------------
# prepares and registry hook (imported by ops.registry)
# ---------------------------------------------------------------------------


def _prep_csr(csr: CSRMatrix, ell: ELLMatrix, cfg: Config, device) -> DeviceCSR:
    return device_csr(csr, dtype=cfg.torch_dtype, device=device)


def _prep_ell(csr: CSRMatrix, ell: ELLMatrix, cfg: Config, device) -> DeviceELL:
    return device_ell(ell, dtype=cfg.torch_dtype, device=device)


def _prep_ell_t(csr: CSRMatrix, ell: ELLMatrix, cfg: Config, device) -> DeviceELL:
    return device_ell(ell, dtype=cfg.torch_dtype, transposed=True, device=device)


def _prep_csr_parts(csr: CSRMatrix, ell: ELLMatrix, cfg: Config, device):
    parts = cols_partitioning(csr, cfg.grid_cols)
    return tuple(device_csr(p, dtype=cfg.torch_dtype, device=device) for p in parts)


def _prep_csr_groups(csr: CSRMatrix, ell: ELLMatrix, cfg: Config, device):
    """(DeviceCSR, block nnz offsets, rows per block, largest block
    extent), the JAX package's plan; the offsets stay on the host, where
    the block loop reads them."""
    mat = _prep_csr(csr, ell, cfg, device)
    b = max(int(cfg.grid_rows), 1)
    rpb = max(-(-csr.shape[0] // b), 1)
    bounds = [min(i * rpb, csr.shape[0]) for i in range(b + 1)]
    starts = csr.indptr[np.asarray(bounds, dtype=np.int64)].astype(np.int64)
    max_ext = max(int(np.diff(starts).max()), 1)
    return (mat, tuple(int(s) for s in starts), rpb, max_ext)


def _register() -> None:
    from ..formats.binned import binned_spmv, prepare_binned_csr
    from .registry import KernelSpec, register

    def spec(name, fmt, prepare, run, doc):
        register(KernelSpec(name=name, fmt=fmt, impl="torch", prepare=prepare, run=run, doc=doc))

    def ell_run(row_lens: bool, simd: bool):
        return lambda mat, x: ell_rows(mat, x, row_lens=row_lens, simd=simd)

    spec("CSR_ROWS", "csr", _prep_csr, csr_rows,
         "row-parallel CSR: gather + sorted segment sum "
         "(spmvRowsBasicCSR analog, SpMV_CSR_OMP.c:34-63)")
    spec("CSR_ROWS_GROUPS", "csr", _prep_csr_groups,
         lambda ops, x: csr_rows_groups(ops[0], x, ops[1], ops[2], ops[3]),
         "fair row-block CSR, a real blocked schedule: grid_rows blocks each "
         "slice their nnz range and reduce locally in a loop "
         "(spmvRowsBlocksCSR analog, SpMV_CSR_OMP.c:65-99)")
    spec("CSR_TILES", "csr", lambda csr, ell, cfg, device: (_prep_csr(csr, ell, cfg, device), cfg.grid_cols),
         lambda ops, x: csr_tiles(ops[0], x, ops[1]),
         "2D tiles via column-range bucketing, partial sums + reduce "
         "(spmvTilesCSR analog, SpMV_CSR_OMP.c:101-162)")
    spec("CSR_TILES_ALLOCD", "csr", _prep_csr_parts, csr_tiles_allocd,
         "2D tiles over separately-allocated column-partition CSRs "
         "(spmvTilesAllocdCSR analog, SpMV_CSR_OMP.c:165-226)")
    spec("ELL_ROWS", "ell", _prep_ell, ell_run(True, True),
         "row-parallel ELL over the padded slabs "
         "(spmvRowsBasicELL analog, SpMV_ELL_OMP.c:33-67)")
    spec("ELL_ROWS_GROUPS", "ell",
         lambda csr, ell, cfg, device: (_prep_ell(csr, ell, cfg, device), max(int(cfg.grid_rows), 1)),
         lambda ops, x: ell_rows_groups(ops[0], x, grid_rows=ops[1]),
         "fair row-block ELL, a real blocked schedule: grid_rows slab blocks "
         "reduced block by block (spmvRowsBlocksELL analog, SpMV_ELL_OMP.c:69-108)")
    spec("ELL_TILES", "ell", lambda csr, ell, cfg, device: (_prep_ell(csr, ell, cfg, device), cfg.grid_cols),
         lambda ops, x: ell_tiles(ops[0], x, ops[1]),
         "2D ELL tiles splitting the padded width "
         "(spmvTilesELL analog, SpMV_ELL_OMP.c:110-174)")
    spec("ELL_ROWS_T", "ell", _prep_ell_t, lambda mat, x: ell_rows_transposed(mat, x),
         "transposed-slab ELL, the reduction down the width with unit-stride "
         "rows (cudaSpMVRowsELL + ellTranspose, SpMV_CUDA.cu:79-96)")
    # SIMD/scalar-order and row-lens variants (the reference's build
    # toggles, config.h:92-98), registered as modes of their own
    spec("ELL_ROWS_NOSIMD", "ell", _prep_ell, ell_run(True, False),
         "ELL rows with strict sequential-order width reduction "
         "(SIMD_ROWS_REDUCTION=FALSE analog)")
    spec("ELL_ROWS_NORL", "ell", _prep_ell, ell_run(False, True),
         "ELL rows without row-lens masking (NO_ROWLENS build analog)")
    spec("CSR_ROWS_BINNED", "csr",
         lambda csr, ell, cfg, device: prepare_binned_csr(csr, dtype=cfg.torch_dtype, device=device),
         binned_spmv,
         "row-binned width-class slabs: CSR memory economics with dense "
         "reduces; the dynamic-scheduling/row-binning analog "
         "(ompChunksDivide.h) as a storage transform")


_register()
