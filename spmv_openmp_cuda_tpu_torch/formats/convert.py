"""Format conversions: COO -> CSR / ELL (+ helpers).

Counterpart of spmv_openmp_cuda_tpu/formats/convert.py (reference COOtoCSR
parser.c:157-215 and COOtoELL parser.c:217-296), vectorized numpy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import ELL_MAX_ENTRIES
from .matrix import COOMatrix, CSRMatrix, ELLMatrix


class EllSizeError(ValueError):
    """Raised when an ELL materialization would exceed the entry cap
    (reference parser.c:223-232)."""


def check_sorted(coo: COOMatrix) -> None:
    """CONSISTENCY_CHECKS analog (parser.c:195-202): entries must be sorted
    by row then strictly by column within each row (no duplicates)."""
    order_keys = coo.rows.astype(np.int64) * (coo.shape[1] + 1) + coo.cols
    if coo.nnz and not np.all(np.diff(order_keys) > 0):
        raise ValueError("COO entries not sorted by (row, col) or contain duplicates")


def sort_coo(coo: COOMatrix) -> COOMatrix:
    """Sort entries by (row, col); sums duplicates like a sparse accumulator."""
    if coo.nnz == 0:
        return coo
    keys = coo.rows.astype(np.int64) * coo.shape[1] + coo.cols
    order = np.argsort(keys, kind="stable")
    rows, cols, vals = coo.rows[order], coo.cols[order], coo.vals[order]
    keys = keys[order]
    uniq, inv = np.unique(keys, return_inverse=True)
    if uniq.shape[0] != keys.shape[0]:
        svals = np.zeros(uniq.shape[0], dtype=vals.dtype)
        np.add.at(svals, inv, vals)
        rows = (uniq // coo.shape[1]).astype(coo.rows.dtype)
        cols = (uniq % coo.shape[1]).astype(coo.cols.dtype)
        vals = svals
    return COOMatrix(coo.shape, rows, cols, vals)


def coo_to_csr(coo: COOMatrix, consistency_checks: bool = True) -> CSRMatrix:
    """COO (sorted by row,col) -> CSR. Reference COOtoCSR analog."""
    if consistency_checks:
        check_sorted(coo)
    m = coo.shape[0]
    row_lens = coo.compute_row_lens()
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(row_lens, out=indptr[1:])
    if consistency_checks and indptr[m] != coo.nnz:
        raise ValueError("IRP tail != NZ (parser.c:187 analog)")
    return CSRMatrix(
        shape=coo.shape,
        indptr=indptr,
        indices=coo.cols.astype(np.int64),
        data=coo.vals.astype(np.float64),
        row_lens=row_lens.copy(),
    )


def coo_to_ell(
    coo: COOMatrix,
    consistency_checks: bool = True,
    max_entries: Optional[int] = ELL_MAX_ENTRIES,
) -> ELLMatrix:
    """COO (sorted) -> ELL padded slabs. Reference COOtoELL analog.

    The 2*M*max_row_nz cap accounts for JA+AS both being materialized
    (parser.c:223-232); pass max_entries=None to disable it.
    """
    if consistency_checks:
        check_sorted(coo)
    m = coo.shape[0]
    row_lens = coo.compute_row_lens()
    w = int(row_lens.max(initial=0))
    if max_entries is not None and 2 * m * w > max_entries:
        raise EllSizeError(
            f"ELL padded entries 2*{m}*{w} = {2 * m * w} exceed cap {max_entries}"
        )
    ja = np.zeros((m, max(w, 1)), dtype=np.int64)
    data = np.zeros((m, max(w, 1)), dtype=np.float64)
    if coo.nnz:
        indptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(row_lens, out=indptr[1:])
        slot = np.arange(coo.nnz, dtype=np.int64) - indptr[coo.rows]
        ja[coo.rows, slot] = coo.cols
        data[coo.rows, slot] = coo.vals
    return ELLMatrix(
        shape=coo.shape,
        ja=ja,
        data=data,
        max_row_nz=w,
        nnz=coo.nnz,
        row_lens=row_lens.copy(),
    )


def csr_to_coo(csr: CSRMatrix) -> COOMatrix:
    return COOMatrix(
        shape=csr.shape,
        rows=csr.row_ids().astype(np.int64),
        cols=csr.indices.copy(),
        vals=csr.data.copy(),
        row_lens=csr.compute_row_lens().copy(),
    )


def csr_to_dense(csr: CSRMatrix) -> np.ndarray:
    """CSRToDense analog (reference sparseUtils.c:203-222)."""
    return csr.to_dense()
