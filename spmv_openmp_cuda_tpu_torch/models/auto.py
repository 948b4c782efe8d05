"""High-level SpMV model with automatic format selection.

Counterpart of spmv_openmp_cuda_tpu/models/auto.py, with every format the
JAX one accepts: diagonal-concentrated matrices go to DIA, a dense-diagonal
core with a scattered fringe to the DIA+residual hybrid, both on the CUDA DIA
kernels (ops/spmv_cuda.py), banded-locality matrices (unstructured FEM) to
the windowed local-gather engine on the CUDA window kernels
(ops/window_cuda.py), and every other matrix, and every DIA or window
refusal, to the Clos-routed engine on the CUDA routed kernels
(ops/routed_cuda.py), as in the JAX package. The explicit formats stay
available: lanes (the lane-gather engine, ops/lanes_cuda.py; a LanesError
falls back to routed), ell_t (transposed ELL slabs, ops/ell_cuda.py; an
EllSizeError falls back to binned) and binned (the width-class slabs,
formats/binned.py), which also takes a matrix that even the chunked routed
engine refuses. At float64 the same formats run the double-float engines
(ops/dfloat.py; the CUDA kernels of csrc/df_spmv.cu) with the same
fallbacks; lanes maps to binned, and ell_t and binned run native f64 torch
ops.

Usage:
    model = AutoSpMV.from_file("matrix.mtx", device="cuda")
    y = model(x)                                       # float32 tensor on the GPU
    model64 = AutoSpMV.from_file("matrix.mtx", cfg=Config(dtype="float64"))
    y64 = model64(x)                                   # float64 tensor on the GPU
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..formats.binned import binned_spmv, prepare_binned_csr
from ..formats.convert import EllSizeError, coo_to_csr, coo_to_ell, csr_to_coo
from ..formats.dia import DiaFillError, prepare_dia, split_offsets
from ..formats.lanes import LanesError, prepare_lanes_small
from ..formats.matrix import COOMatrix, CSRMatrix, device_ell, target_device
from ..formats.routed import RoutedError
from ..formats.window import WindowError, prepare_window_auto, window_cost_scan
from ..ops.ell_cuda import ell_t_cuda
from ..ops.lanes_cuda import lanes_cuda
from ..ops.routed_cuda import (
    prepare_routed_chain,
    prepare_routed_df_chain,
    routed_chain_spmv,
    routed_df_spmv,
)
from ..ops.spmv_cuda import (
    dia_resid_spmv_cuda,
    dia_resid_spmv_df_cuda,
    dia_spmv_cuda,
    dia_spmv_df_cuda,
    pad_dia_for_pallas,
    plan_dia,
    prepare_dia_df_pallas,
    prepare_dia_resid,
)
from ..ops.spmv_torch import ell_rows_transposed
from ..ops.window_cuda import window_spmv

FORMATS = ("dia", "dia_resid", "window", "lanes", "routed", "ell_t", "binned")


def select_format(csr: CSRMatrix, dia_fill_cap: float = 2.0) -> str:
    """Pick a storage engine from matrix structure (host-side, the JAX
    package's policy verbatim).

    Returns "dia_resid", "dia", "window" or "routed".
    """
    m, n = csr.shape
    nnz = max(csr.nnz, 1)
    # DIA needs distinct-offset count <= dia_fill_cap*nnz/m; for huge
    # matrices first reject cheaply from a sample (a sample undercounts
    # distinct offsets, so exceeding the cap on the sample is conclusive)
    max_offs = int(dia_fill_cap * nnz / max(m, 1))
    sampled_reject = False
    if csr.nnz > 4_000_000:
        idx = np.linspace(0, csr.nnz - 1, 200_000).astype(np.int64)
        rows_s = np.searchsorted(csr.indptr, idx, side="right") - 1
        sampled_reject = (
            np.unique(csr.indices[idx] - rows_s).shape[0] > max_offs
        )
    if not sampled_reject:
        offs, cnt = np.unique(
            csr.indices - csr.row_ids(), return_counts=True
        )
        dense = int((cnt >= max(0.12 * m, 2)).sum())
        # dense-diagonal core + scattered fringe (raefsky-class): the
        # hybrid wins whenever the split sheds >= 25% of the offsets
        if dense < 0.75 * offs.shape[0]:
            try:
                split_offsets(csr)
                return "dia_resid"
            except DiaFillError:
                pass
        if offs.shape[0] <= max_offs:
            return "dia"
    # banded locality without banded structure (unstructured FEM): the
    # window engine, when its model cost stays under the routed bar (~50
    # ps/nnz of routing plus a fixed ~10 us pipeline; the JAX package's
    # TPU-fitted units, kept so that both packages choose alike)
    try:
        best = window_cost_scan(csr)
    except WindowError:
        best = None
    if best is not None and best < 50.0 * nnz + 10e6:
        return "window"
    return "routed"


@dataclasses.dataclass
class AutoSpMV:
    """A prepared SpMV operator y = A @ x on one device."""

    format: str
    shape: tuple
    nnz: int
    _fn: Callable
    _operands: object
    dtype: str = "float32"
    device: torch.device = torch.device("cpu")

    @classmethod
    def from_csr(
        cls,
        csr: CSRMatrix,
        cfg: Optional[Config] = None,
        format: str = "auto",
        device="cuda",
    ) -> "AutoSpMV":
        cfg = cfg or Config()
        device = target_device(device)
        if cfg.dtype not in ("float32", "float64"):
            raise NotImplementedError(
                f"dtype {cfg.dtype}: the port runs float32 and float64"
            )
        f64 = cfg.dtype == "float64"
        fmt = select_format(csr) if format == "auto" else format
        if fmt not in FORMATS:
            raise ValueError(
                f"unknown format {format!r}; expected auto, dia, dia_resid, "
                "window, lanes, routed, ell_t or binned"
            )
        if f64 and fmt == "lanes":
            fmt = "binned"  # the lane-gather kernel is f32, as in the JAX package
        dia_run = dia_spmv_df_cuda if f64 else dia_spmv_cuda
        resid_run = dia_resid_spmv_df_cuda if f64 else dia_resid_spmv_cuda
        try:
            if fmt == "window":
                ops = prepare_window_auto(
                    csr, dtype=torch.float32 if f64 else cfg.torch_dtype, device=device, df=f64
                )
                run = window_spmv
            elif fmt == "dia_resid":
                ops = prepare_dia_resid(csr, dtype=cfg.torch_dtype, device=device, df=f64)

                def run(o, x):
                    return resid_run(o[0], x, o[1])

            elif fmt == "dia":
                if f64:
                    ops = prepare_dia_df_pallas(csr, device=device)
                else:
                    mat = prepare_dia(csr, dtype=cfg.torch_dtype, device=device)
                    plan = plan_dia(mat)
                    ops = (pad_dia_for_pallas(mat, plan), plan)

                def run(o, x):
                    return dia_run(o[0], x, o[1])

        except (DiaFillError, WindowError):
            fmt = "routed"  # the general fallback (df routed at float64), as in the JAX package
        if fmt == "lanes":
            try:
                ops = prepare_lanes_small(csr, dtype=cfg.torch_dtype, device=device)
                run = lanes_cuda
            except LanesError:
                fmt = "routed"
        if fmt == "routed":
            try:
                if f64:
                    ops = prepare_routed_df_chain(csr, device=device)
                else:
                    ops = prepare_routed_chain(csr, dtype=cfg.torch_dtype, device=device)
                run = routed_df_spmv if f64 else routed_chain_spmv
            except RoutedError:
                fmt = "binned"  # even the chunked routed engine refused it
        if fmt == "ell_t":
            try:
                ell = coo_to_ell(csr_to_coo(csr), max_entries=cfg.ell_max_entries)
                ops = device_ell(ell, dtype=cfg.torch_dtype, transposed=True, device=device)
                # the CUDA transposed-ELL kernel in f32; native f64 torch ops
                # at float64 (the JAX package runs ELL_ROWS_T's XLA op)
                run = ell_rows_transposed if f64 else ell_t_cuda
            except EllSizeError:
                fmt = "binned"
        if fmt == "binned":
            ops = prepare_binned_csr(csr, dtype=cfg.torch_dtype, device=device)
            run = binned_spmv
        x_dtype = torch.float64 if f64 else torch.float32

        def fn(x):
            return run(ops, torch.as_tensor(x, dtype=x_dtype, device=device))

        return cls(
            format=fmt,
            shape=csr.shape,
            nnz=csr.nnz,
            _fn=fn,
            _operands=ops,
            dtype=cfg.dtype,
            device=device,
        )

    @classmethod
    def from_coo(cls, coo: COOMatrix, **kw) -> "AutoSpMV":
        return cls.from_csr(coo_to_csr(coo), **kw)

    @classmethod
    def from_file(cls, path: str, **kw) -> "AutoSpMV":
        from ..io.mmio import read_coo

        return cls.from_coo(read_coo(path), **kw)

    def __call__(self, x) -> torch.Tensor:
        """y = A @ x for numpy or tensor x: a tensor of length m on the
        model's device, float32, or float64 for a float64 model."""
        return self._fn(x)
