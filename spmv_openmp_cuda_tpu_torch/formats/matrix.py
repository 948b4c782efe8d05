"""Sparse-matrix data model: host COO / CSR / ELL and their device forms.

Counterpart of spmv_openmp_cuda_tpu/formats/matrix.py (reference:
src/include/sparseMatrix.h:25-42 `spmat`). The host half is plain numpy
dataclasses, identical to the JAX package's, so both packages read the same
matrices the same way. The device half (DeviceCSR, DeviceELL, device_csr,
device_ell) holds tensors on an explicit device, padded as the JAX package
pads its arrays, so both packages' prepared arrays are equal element for
element.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import LANE, SUBLANE


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


# ---------------------------------------------------------------------------
# Device-side containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceCSR:
    """Device CSR: nnz-expanded arrays with aligned padding.

    `row_ids[k]` is the output row of nnz k; padded tail entries carry
    row_id == M, col 0, val 0. `indptr` is kept for the blocked schedules.
    """

    data: torch.Tensor  # (nnz_pad,) dtype
    cols: torch.Tensor  # (nnz_pad,) int32
    row_ids: torch.Tensor  # (nnz_pad,) int32
    indptr: torch.Tensor  # (M+1,) int32
    row_lens: torch.Tensor  # (M,) int32
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0


@dataclasses.dataclass
class DeviceELL:
    """Device ELL: (M_pad, W_pad) slabs, or (W_pad, M_pad) when transposed.

    The row-major slab pads W to a multiple of 128 and M to a multiple of 8;
    the transposed one W to a multiple of 8 and M to a multiple of 128. The
    JAX package pads so because XLA tiles TPU arrays (8, 128); the port keeps
    the padding so that both packages hold the same arrays (the row-major
    pad is a TPU artifact that costs bytes on a GPU: PERF.md).
    """

    data: torch.Tensor  # (M_pad, W_pad) dtype, or (W_pad, M_pad)
    cols: torch.Tensor  # same shape, int32
    row_lens: torch.Tensor  # (M_pad,) int32
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    max_row_nz: int = 0
    transposed: bool = False


def device_csr(
    csr: CSRMatrix,
    dtype: torch.dtype = torch.float32,
    nnz_align: int = LANE * SUBLANE,
    device="cpu",
) -> DeviceCSR:
    """Upload a host CSR to device form (spMatCpyCSR analog, reference
    cudaUtils.cu:20-55): expansion to per-nnz row ids plus alignment
    padding, as in the JAX package."""
    m, _ = csr.shape
    nnz = csr.nnz
    nnz_pad = max(_ceil_to(max(nnz, 1), nnz_align), nnz_align)
    data = np.zeros(nnz_pad, dtype=np.float64)
    cols = np.zeros(nnz_pad, dtype=np.int32)
    rids = np.full(nnz_pad, m, dtype=np.int32)
    data[:nnz] = csr.data
    cols[:nnz] = csr.indices
    rids[:nnz] = csr.row_ids()
    return DeviceCSR(
        data=torch.as_tensor(data, dtype=dtype, device=device),
        cols=torch.as_tensor(cols, device=device),
        row_ids=torch.as_tensor(rids, device=device),
        indptr=torch.as_tensor(csr.indptr.astype(np.int32), device=device),
        row_lens=torch.as_tensor(csr.compute_row_lens().astype(np.int32), device=device),
        shape=tuple(csr.shape),
        nnz=nnz,
    )


def device_ell(
    ell: ELLMatrix,
    dtype: torch.dtype = torch.float32,
    transposed: bool = False,
    lane_pad: bool = True,
    device="cpu",
) -> DeviceELL:
    """Upload a host ELL to a padded device slab (spMatCpyELL analog,
    reference cudaUtils.cu:56-98), with the JAX package's padding:
    row-major (M, W): W to a multiple of 128 (unless lane_pad=False), M to
    a multiple of 8; transposed (W, M): W to a multiple of 8, M to a
    multiple of 128. Takes the untransposed host ELL."""
    if ell.slab_transposed:
        raise ValueError("pass the untransposed host ELL; device_ell transposes itself")
    m, _ = ell.shape
    w = ell.max_row_nz
    if transposed:
        w_pad = max(_ceil_to(max(w, 1), SUBLANE), SUBLANE)
        m_pad = max(_ceil_to(max(m, 1), LANE), LANE)
    else:
        w_pad = max(_ceil_to(max(w, 1), LANE), LANE) if lane_pad else max(w, 1)
        m_pad = max(_ceil_to(max(m, 1), SUBLANE), SUBLANE)
    data = np.zeros((m_pad, w_pad), dtype=np.float64)
    cols = np.zeros((m_pad, w_pad), dtype=np.int32)
    rl = np.zeros(m_pad, dtype=np.int32)
    data[:m, :w] = ell.data[:, :w]
    cols[:m, :w] = ell.ja[:, :w]
    rl[:m] = ell.row_lens if ell.row_lens is not None else w
    if transposed:
        data, cols = data.T, cols.T
    return DeviceELL(
        data=torch.as_tensor(np.ascontiguousarray(data), dtype=dtype, device=device),
        cols=torch.as_tensor(np.ascontiguousarray(cols), device=device),
        row_lens=torch.as_tensor(rl, device=device),
        shape=tuple(ell.shape),
        nnz=ell.nnz,
        max_row_nz=w,
        transposed=transposed,
    )


def is_nnz(csr: CSRMatrix, i: int, j: int) -> bool:
    """Is (i, j) a stored nonzero? Binary search within the row's
    column-sorted segment (IS_NNZ / BISECT_ARRAY analog,
    sparseMatrix.h:54-80)."""
    lo, hi = int(csr.indptr[i]), int(csr.indptr[i + 1])
    k = int(np.searchsorted(csr.indices[lo:hi], j))
    return k < hi - lo and csr.indices[lo + k] == j
