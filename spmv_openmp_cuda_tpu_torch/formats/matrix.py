"""Host sparse-matrix data model (COO / CSR / ELL).

Counterpart of the host half of spmv_openmp_cuda_tpu/formats/matrix.py
(reference: src/include/sparseMatrix.h:25-42 `spmat`): plain numpy
dataclasses, identical to the JAX package's, so both packages read the same
matrices the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def fair_block_size(i: int, base: int, rem: int) -> int:
    """Remainder-balanced block size for worker i (UNIF_REMINDER_DISTRI
    analog, macros.h:33-34): the first `rem` workers get base+1 items."""
    return base + (1 if i < rem else 0)


def fair_block_start(i: int, base: int, rem: int) -> int:
    """Start index of worker i's fair block (macros.h:35-36 analog)."""
    return i * base + min(i, rem)


def fair_splits(n: int, parts: int) -> np.ndarray:
    """Boundaries of a remainder-balanced split of range(n) into `parts`.

    Returns an array of parts+1 offsets; block p = [out[p], out[p+1]).
    """
    base, rem = divmod(n, parts)
    out = np.empty(parts + 1, dtype=np.int64)
    for p in range(parts + 1):
        out[p] = p * base + min(p, rem)
    return out


@dataclasses.dataclass
class COOMatrix:
    """Coordinate-format sparse matrix, entries sorted by (row, col)
    (parser.h:24-35 analog)."""

    shape: Tuple[int, int]
    rows: np.ndarray  # (nnz,) int
    cols: np.ndarray  # (nnz,) int
    vals: np.ndarray  # (nnz,) float
    row_lens: Optional[np.ndarray] = None  # (M,) int

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    def compute_row_lens(self) -> np.ndarray:
        if self.row_lens is None:
            self.row_lens = np.bincount(
                self.rows, minlength=self.shape[0]
            ).astype(np.int64)
        return self.row_lens

    def to_dense(self) -> np.ndarray:
        d = np.zeros(self.shape, dtype=np.float64)
        np.add.at(d, (self.rows, self.cols), self.vals)
        return d


@dataclasses.dataclass
class CSRMatrix:
    """CSR host matrix: indptr (IRP analog), indices (JA), data (AS)."""

    shape: Tuple[int, int]
    indptr: np.ndarray  # (M+1,) int
    indices: np.ndarray  # (nnz,) int
    data: np.ndarray  # (nnz,) float
    row_lens: Optional[np.ndarray] = None

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def compute_row_lens(self) -> np.ndarray:
        if self.row_lens is None:
            self.row_lens = np.diff(self.indptr).astype(np.int64)
        return self.row_lens

    @property
    def max_row_nz(self) -> int:
        return int(self.compute_row_lens().max(initial=0))

    def row_ids(self) -> np.ndarray:
        """Expanded per-nnz row ids."""
        return np.repeat(
            np.arange(self.shape[0], dtype=np.int32), self.compute_row_lens()
        )

    def to_dense(self) -> np.ndarray:
        d = np.zeros(self.shape, dtype=np.float64)
        rl = self.compute_row_lens()
        d[np.repeat(np.arange(self.shape[0]), rl), self.indices] = self.data
        return d


@dataclasses.dataclass
class ELLMatrix:
    """ELLPACK host matrix: row-major padded (M, max_row_nz) slabs.

    Padding is value 0.0, column index 0 (parser.c:279-296, config.h:71).
    """

    shape: Tuple[int, int]
    ja: np.ndarray  # (M, W) int — or (W, M) when slab_transposed
    data: np.ndarray  # (M, W) float — or (W, M) when slab_transposed
    max_row_nz: int
    nnz: int
    row_lens: Optional[np.ndarray] = None
    slab_transposed: bool = False

    def to_dense(self) -> np.ndarray:
        if self.slab_transposed:
            return dataclasses.replace(
                self,
                ja=self.ja.T.copy(),
                data=self.data.T.copy(),
                slab_transposed=False,
            ).to_dense()
        d = np.zeros(self.shape, dtype=np.float64)
        m, w = self.ja.shape
        rl = self.row_lens
        if rl is None:
            # rows count as full width: padded slots are (ja=0, val=0)
            rl = np.full(m, w, dtype=np.int64)
        for r in range(m):
            for k in range(int(rl[r])):
                d[r, self.ja[r, k]] += self.data[r, k]
        return d
