"""High-level SpMV model with automatic format selection.

Counterpart of spmv_openmp_cuda_tpu/models/auto.py, for the engines the port
runs so far: diagonal-concentrated matrices go to DIA, a dense-diagonal core
with a scattered fringe to the DIA+residual hybrid, both on the CUDA DIA
kernels (ops/spmv_cuda.py). Every other engine of the JAX package (window,
routed, lanes, ell_t, binned) and float64 raise NotImplementedError: the
port never substitutes another engine for one it lacks.

Usage:
    model = AutoSpMV.from_file("matrix.mtx", device="cuda")
    y = model(x)                                       # float32 tensor on the GPU
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..formats.convert import coo_to_csr
from ..formats.dia import DiaFillError, prepare_dia, split_offsets
from ..formats.matrix import COOMatrix, CSRMatrix
from ..ops.spmv_cuda import (
    dia_spmv_cuda,
    pad_dia_for_pallas,
    plan_dia,
    prepare_dia_resid,
)

#: Engines of the JAX package that the port has not brought over yet, with
#: the ROADMAP.md queue-1 item that ports each.
UNPORTED_FORMATS = {
    "window": "queue 1 item 6 (window slice)",
    "routed": "queue 1 item 7 (routed slice)",
    "lanes": "queue 1 item 8 (remaining f32 modes)",
    "ell_t": "queue 1 item 8 (remaining f32 modes)",
    "binned": "queue 1 item 8 (remaining f32 modes)",
}


def _unported(fmt: str, why: str = "") -> NotImplementedError:
    return NotImplementedError(
        f"{why}the {fmt} engine is not ported to PyTorch/CUDA yet "
        f"(ROADMAP.md {UNPORTED_FORMATS[fmt]})"
    )


def select_format(csr: CSRMatrix, dia_fill_cap: float = 2.0) -> str:
    """Pick a storage engine from matrix structure (host-side, the JAX
    package's policy verbatim up to its DIA decisions).

    Returns "dia_resid" or "dia"; a matrix that is neither raises
    NotImplementedError, since the window/routed engines the JAX package
    would choose next are not ported.
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
    raise NotImplementedError(
        "matrix is not DIA-class: the JAX package would pick the window or "
        "routed engine, which are not ported to PyTorch/CUDA yet (ROADMAP.md "
        f"{UNPORTED_FORMATS['window']}, {UNPORTED_FORMATS['routed']})"
    )


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
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device cuda requested but torch.cuda.is_available() is False"
            )
        if cfg.dtype != "float32":
            raise NotImplementedError(
                f"dtype {cfg.dtype} is not ported yet: the port runs float32 "
                "(ROADMAP.md queue 1 item 9 ports the double-float engines)"
            )
        fmt = select_format(csr) if format == "auto" else format
        if fmt in UNPORTED_FORMATS:
            raise _unported(fmt)
        if fmt not in ("dia", "dia_resid"):
            raise ValueError(
                f"unknown format {format!r}; expected auto, dia, dia_resid, "
                "window, lanes, routed, ell_t or binned"
            )
        try:
            if fmt == "dia_resid":
                ops = prepare_dia_resid(csr, dtype=cfg.torch_dtype, device=device)

                def run(o, x):
                    return dia_spmv_cuda(o[0].mat, x, o[1], resid=o[0])

            else:
                mat = prepare_dia(csr, dtype=cfg.torch_dtype, device=device)
                plan = plan_dia(mat)
                ops = (pad_dia_for_pallas(mat, plan), plan)

                def run(o, x):
                    return dia_spmv_cuda(o[0], x, o[1])

        except DiaFillError as e:
            # the JAX package falls back to the routed engine here
            raise _unported("routed", f"{fmt} prepare refused the matrix ({e}); ") from e

        def fn(x):
            return run(ops, torch.as_tensor(x, dtype=torch.float32, device=device))

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
        """y = A @ x for numpy or tensor x: a float32 tensor of length m on
        the model's device."""
        return self._fn(x)
