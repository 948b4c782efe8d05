"""Matrix partitioners — the data decompositions every kernel builds on.

The port's copy of spmv_openmp_cuda_tpu/partition/partitioners.py (host
numpy, no change). Capability analog of the reference's partitioning substrate
(reference: src/commons/sparseUtils.c):
- cols_offsets_partitioning  <- colsOffsetsPartitioningUnifRanges
  (sparseUtils.c:37-59): per-row offsets of each uniform column-range.
- cols_partitioning          <- colsPartitioningUnifRanges
  (sparseUtils.c:61-142): split into fully independent per-column-range CSRs.
- ell_transpose              <- ellTranspose (sparseUtils.c:145-185).
- row_binning: the static-grid analog of dynamic scheduling / chunk distribution
  (reference ompChunksDivide.h:29-91): reorder rows by length so a static
  grid gets balanced work.

Implementations are vectorized numpy over the sorted-key invariant, not
translations of the reference's per-entry scan loops.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..formats.matrix import CSRMatrix, ELLMatrix, fair_splits


def cols_offsets_partitioning(csr: CSRMatrix, grid_cols: int) -> np.ndarray:
    """(M, grid_cols+1) offsets: offsets[r, j] = index in indices/data where
    row r's j-th uniform column-range begins; offsets[r, grid_cols] = row end.

    Requires per-row column-sorted CSR (the reference's standing invariant).
    O((M*grid_cols) log nnz) via a batched searchsorted on the global
    (row, col) key, replacing the reference's O(NZ) serial scan.
    """
    m, n = csr.shape
    splits = fair_splits(n, grid_cols)  # (grid_cols+1,) column boundaries
    keys = csr.row_ids().astype(np.int64) * (n + 1) + csr.indices
    rows = np.arange(m, dtype=np.int64)[:, None] * (n + 1)
    return np.searchsorted(keys, rows + splits[None, :]).astype(np.int64)


def check_cols_offsets_partitioning(csr: CSRMatrix, offsets: np.ndarray) -> None:
    """Partition-coverage invariants (port of the reference's embedded unit
    test testColsOffsetsPartitioningUnifRanges, sparseUtils.c:242-272):
    contiguity, column-range membership, and total NNZ coverage."""
    m, n = csr.shape
    grid_cols = offsets.shape[1] - 1
    splits = fair_splits(n, grid_cols)
    total = 0
    for r in range(m):
        assert offsets[r, 0] == csr.indptr[r], f"row {r} start mismatch"
        assert offsets[r, -1] == csr.indptr[r + 1], f"row {r} end mismatch"
        for j in range(grid_cols):
            lo, hi = offsets[r, j], offsets[r, j + 1]
            assert lo <= hi, "offsets not monotone"
            seg = csr.indices[lo:hi]
            assert np.all(seg >= splits[j]) and np.all(seg < splits[j + 1]), (
                f"row {r} part {j}: column out of range"
            )
            total += hi - lo
    assert total == csr.nnz, "partitions do not cover all NNZ"


def partition_balance(offsets: np.ndarray, grid_rows: int) -> np.ndarray:
    """Per-tile NNZ counts for a gridRows x gridCols tiling (the balance
    report of the reference's embedded test)."""
    m = offsets.shape[0]
    grid_cols = offsets.shape[1] - 1
    row_splits = fair_splits(m, grid_rows)
    out = np.zeros((grid_rows, grid_cols), dtype=np.int64)
    for i in range(grid_rows):
        r0, r1 = row_splits[i], row_splits[i + 1]
        out[i] = (offsets[r0:r1, 1:] - offsets[r0:r1, :-1]).sum(axis=0)
    return out


def cols_partitioning(csr: CSRMatrix, grid_cols: int) -> List[CSRMatrix]:
    """Split into grid_cols fully independent CSR matrices, one per uniform
    column range (colsPartitioningUnifRanges analog). Column indices stay
    global, as in the reference (its kernels index the full dense vector)."""
    offsets = cols_offsets_partitioning(csr, grid_cols)
    parts: List[CSRMatrix] = []
    for j in range(grid_cols):
        lens = (offsets[:, j + 1] - offsets[:, j]).astype(np.int64)
        indptr = np.zeros(csr.shape[0] + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        nnz_j = int(indptr[-1])
        idx = np.empty(nnz_j, dtype=np.int64)
        # gather every row's [offsets[r,j], offsets[r,j+1]) segment
        seg_rows = np.repeat(np.arange(csr.shape[0]), lens)
        within = np.arange(nnz_j) - indptr[seg_rows]
        idx = offsets[seg_rows, j] + within
        parts.append(
            CSRMatrix(
                shape=csr.shape,
                indptr=indptr,
                indices=csr.indices[idx],
                data=csr.data[idx],
                row_lens=lens,
            )
        )
    return parts


def ell_transpose(ell: ELLMatrix) -> ELLMatrix:
    """Materialize the transposed ELL layout (W, M) slabs (ellTranspose
    analog, sparseUtils.c:145-185), marked slab_transposed so consumers
    (to_dense etc.) interpret the axes correctly. The device path does
    its own transposition — pass the untransposed host matrix to
    formats.matrix.device_ell(transposed=True) for upload."""
    assert not ell.slab_transposed, "already transposed"
    return dataclasses.replace(
        ell, ja=ell.ja.T.copy(), data=ell.data.T.copy(), slab_transposed=True
    )


def row_binning(row_lens: np.ndarray) -> np.ndarray:
    """Permutation ordering rows by descending length.

    The static-grid analog of the reference's dynamic scheduling + adaptive
    chunk sizing (ompChunksDivide.h chunksFair/chunksFairFolded): long rows
    land in the same blocks so per-block early termination pays off, and
    work per block is balanced. Apply to CSR/ELL rows; invert on the output.
    """
    return np.argsort(-np.asarray(row_lens), kind="stable")


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return inv


def spmat_diff(a: CSRMatrix, b: CSRMatrix) -> bool:
    """Structural+numeric equality of two CSR matrices (spmatDiff analog,
    sparseUtils.c:187-201)."""
    return (
        a.shape == b.shape
        and np.array_equal(a.indptr, b.indptr)
        and np.array_equal(a.indices, b.indices)
        and np.allclose(a.data, b.data)
    )
