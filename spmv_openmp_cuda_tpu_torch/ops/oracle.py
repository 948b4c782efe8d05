"""Correctness oracles.

Mirrors the reference's two-oracle scheme (SURVEY.md section 4):
- serial_csr_spmv: the serial CSR loop oracle (sgemvSerial analog,
  reference src/SpMV_CSR_OMP.c:229-250), here a numpy float64 computation.
- dense_gemv_oracle: densify + BLAS GEMV (the CBLAS dgemv oracle analog,
  reference test/SpMV_CBLAS.c:32-57 over CSRToDense sparseUtils.c:203-222);
  numpy's `@` dispatches to the system BLAS.
- "test the tests" (TESTTESTS mode, reference test/SpMV_test.cu:227-236):
  oracle_vs_oracle diffs the two.
"""
from __future__ import annotations

import numpy as np

from ..formats.matrix import CSRMatrix
from ..utils.compare import DiffReport, vectors_diff


def serial_csr_spmv(csr: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Serial CSR SpMV in float64 — the primary oracle.

    Vectorized per-row via reduceat (still a strict row-major accumulation
    order like the reference's serial loop, since reduceat sums each row
    segment left-to-right).
    """
    x = np.asarray(x, dtype=np.float64)
    prods = csr.data * x[csr.indices]
    m = csr.shape[0]
    out = np.zeros(m, dtype=np.float64)
    nonempty = np.flatnonzero(np.diff(csr.indptr) > 0)
    if nonempty.size:
        sums = np.add.reduceat(prods, csr.indptr[nonempty])
        out[nonempty] = sums
    return out


def dense_gemv_oracle(csr: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Densify and run BLAS GEMV (CBLAS oracle analog)."""
    return csr.to_dense() @ np.asarray(x, dtype=np.float64)


def oracle_vs_oracle(csr: CSRMatrix, x: np.ndarray) -> DiffReport:
    """TESTTESTS mode: validate the serial oracle against dense GEMV."""
    return vectors_diff(serial_csr_spmv(csr, x), dense_gemv_oracle(csr, x))
