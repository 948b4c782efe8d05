"""DIA (diagonal) device format — the zero-gather SpMV path.

Counterpart of spmv_openmp_cuda_tpu/formats/dia.py. A matrix whose nnz sit
on few diagonals is stored by diagonal: y[i] = sum_d data[d, i] * x[i + off_d].
No column indices and no gather, so the slab is the only large stream.

The slab keeps the JAX package's (D, S, 128) layout: flat row i = s * 128 + l,
so prepared operands are interchangeable between the packages. A shift by
`off` is a flat slice of the zero-padded x (see pad_x_dia).

Like the reference's ELL size cap (parser.c:223-232), conversion enforces a
padding budget: DiaFillError when the dense diagonals would exceed
`max_fill_ratio` x nnz.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import LANE
from .matrix import CSRMatrix, _ceil_to


class DiaFillError(ValueError):
    """Diagonal materialization would exceed the padding budget."""


@dataclasses.dataclass
class DeviceDIA:
    """data[d, s, l] = A[i, i + offsets[d]] for flat row i = s * 128 + l
    (0 where outside the matrix).

    `offsets` is the ascending diagonal set as a Python tuple (the plain
    torch paths slice with it) and `offsets_dev` the same values as an int32
    tensor on the slab's device (the CUDA kernel reads it, so one compiled
    kernel serves every matrix). `pad_sub` is the number of leading zero
    row groups in the padded-x layout: ceil(max |offset| / 128).
    """

    data: torch.Tensor  # (D, S, LANE)
    offsets: Tuple[int, ...]
    offsets_dev: torch.Tensor  # (D,) int32
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    pad_sub: int = 0

    @property
    def m_pad(self) -> int:
        return self.data.shape[1] * LANE


def _dia_host_slab(csr: CSRMatrix, max_fill_ratio: float):
    """Host-side diagonal materialization: (data64 (D, m_pad), offsets,
    pad_sub)."""
    m, n = csr.shape
    rows = csr.row_ids().astype(np.int64)
    offs = csr.indices - rows  # c - r per nnz
    uniq, inv = np.unique(offs, return_inverse=True)
    d = uniq.shape[0]
    m_pad = max(_ceil_to(max(m, 1), LANE), LANE)
    if d * m_pad > max_fill_ratio * max(csr.nnz, 1):
        raise DiaFillError(
            f"{d} diagonals x {m_pad} rows = {d * m_pad} slots > "
            f"{max_fill_ratio}x nnz ({csr.nnz})"
        )
    data = np.zeros((d, m_pad), dtype=np.float64)
    data[inv, rows] = csr.data
    pad_sub = max(1, -(-int(np.abs(uniq).max(initial=0)) // LANE))
    return data, uniq, pad_sub


def make_device_dia(
    data: torch.Tensor, offsets, shape, nnz: int, pad_sub: int
) -> DeviceDIA:
    """DeviceDIA over an (D, S, LANE) slab already on its device."""
    offs = tuple(int(o) for o in offsets)
    return DeviceDIA(
        data=data,
        offsets=offs,
        offsets_dev=torch.tensor(offs, dtype=torch.int32, device=data.device),
        shape=(int(shape[0]), int(shape[1])),
        nnz=int(nnz),
        pad_sub=int(pad_sub),
    )


def prepare_dia(
    csr: CSRMatrix,
    dtype: torch.dtype = torch.float32,
    max_fill_ratio: float = 3.0,
    device="cpu",
) -> DeviceDIA:
    m, n = csr.shape
    data, uniq, pad_sub = _dia_host_slab(csr, max_fill_ratio)
    d, m_pad = data.shape
    slab = torch.from_numpy(data.reshape(d, m_pad // LANE, LANE)).to(dtype)
    return make_device_dia(slab.to(device), uniq, (m, n), csr.nnz, pad_sub)


def split_offsets(
    csr: CSRMatrix,
    max_fill_ratio: float = 3.0,
    min_occ_frac: float = 0.12,
    max_resid_frac: float = 0.25,
) -> np.ndarray:
    """Dense/sparse offset split for the DIA+residual hybrid.

    Real banded matrices carry a fringe of scattered nnz beyond their dense
    diagonals (e.g. raefsky1: 91 full diagonals + a few hundred stragglers).
    Returns a keep mask per nnz: offsets occupied on >= min_occ_frac of rows
    go to DIA, the rest to the residual. Raises DiaFillError when the kept
    diagonals still exceed the fill budget or the residual fraction is too
    large to be worth the hybrid.
    """
    m, n = csr.shape
    rows = csr.row_ids().astype(np.int64)
    offs = csr.indices - rows
    uniq, inv, cnt = np.unique(offs, return_inverse=True, return_counts=True)
    keep_off = cnt >= max(min_occ_frac * m, 2)
    nnz_kept = int(cnt[keep_off].sum())
    nnz_resid = csr.nnz - nnz_kept
    m_pad = max(_ceil_to(max(m, 1), LANE), LANE)
    if not keep_off.any() or int(keep_off.sum()) * m_pad > max_fill_ratio * max(
        nnz_kept, 1
    ):
        raise DiaFillError("no dense-diagonal core under the fill budget")
    if nnz_resid > max_resid_frac * csr.nnz:
        raise DiaFillError(
            f"residual {nnz_resid}/{csr.nnz} nnz exceeds "
            f"{max_resid_frac:.0%} hybrid budget"
        )
    return keep_off[inv]


def pad_x_dia(x: torch.Tensor, mat: DeviceDIA) -> torch.Tensor:
    """Zero-pad x into the (S + 2*pad_sub, LANE) row-group layout, cast to
    the slab dtype.

    Padded layout: [pad_sub zero rows | x (length n) | zeros up to
    S + 2*pad_sub rows], so x[i + off] for any |off| <= pad_sub*LANE and
    i < S*LANE is in bounds. x entries beyond the row reach
    (S + pad_sub)*LANE are never read (wide matrices, n >> m) and are
    clipped.
    """
    s = mat.data.shape[1]
    limit = (s + mat.pad_sub) * LANE
    xc = x[:limit]
    flat = torch.zeros(
        (s + 2 * mat.pad_sub) * LANE, dtype=mat.data.dtype, device=x.device
    )
    base = mat.pad_sub * LANE
    flat[base : base + xc.shape[0]] = xc
    return flat.reshape(s + 2 * mat.pad_sub, LANE)


def diagonal_sum(
    mat: DeviceDIA, xflat: torch.Tensor, acc_dtype: torch.dtype
) -> torch.Tensor:
    """sum_d data[d] * x shifted by offsets[d], over all S*LANE slab rows,
    in ascending offset order (the order of the JAX package's kernels).

    `xflat` is a flat padded x whose origin (x[0]) sits at pad_sub*LANE.
    """
    d, s, _ = mat.data.shape
    rows = s * LANE
    slab = mat.data.reshape(d, rows)
    base = mat.pad_sub * LANE
    acc = torch.zeros(rows, dtype=acc_dtype, device=mat.data.device)
    for k, off in enumerate(mat.offsets):
        xs = xflat[base + off : base + off + rows].to(acc_dtype)
        acc = acc + slab[k].to(acc_dtype) * xs
    return acc


def dia_spmv_padded(mat: DeviceDIA, xp: torch.Tensor) -> torch.Tensor:
    """y = A @ x from pre-padded xp (see pad_x_dia), plain torch, summed in
    the slab dtype like the JAX package's XLA formulation."""
    acc = diagonal_sum(mat, xp.reshape(-1), mat.data.dtype)
    return acc[: mat.shape[0]]


def dia_spmv(mat: DeviceDIA, x: torch.Tensor) -> torch.Tensor:
    return dia_spmv_padded(mat, pad_x_dia(x, mat))
