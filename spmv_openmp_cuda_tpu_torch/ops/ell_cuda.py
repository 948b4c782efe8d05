"""CUDA kernel for the transposed-ELL mode (PL_ELL_ROWS_T).

Counterpart of spmv_openmp_cuda_tpu/ops/spmv_pallas.py::ell_t_slab_pallas
and its registry hook: the wrapper of the hand-written kernel in
csrc/ell_spmv.cu (ell_t_kernel, f32), its plain PyTorch version, the
conversion of the JAX package's prepared DeviceELL, and the mode.

The wrapper launches the kernel for CUDA tensors and raises on anything it
does not take; it runs the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..formats.matrix import DeviceELL
from . import cuda_lib
from .spmv_cuda import _require, _to_tensor
from .spmv_torch import ell_rows_transposed


def ell_t_reference(mat: DeviceELL, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A @ x over the transposed slab: the port's
    ELL_ROWS_T (x gathered at cols, multiplied, summed down W)."""
    return ell_rows_transposed(mat, x)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ell_t_launch.argtypes = [p, p, i, ll, ll, p, ll, p, p]
    lib.ell_t_launch.restype = i
    lib.ell_error_string.argtypes = [i]
    lib.ell_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return cuda_lib.load("ell_spmv", _bind)


def _check(mat: DeviceELL, x: torch.Tensor) -> None:
    if not mat.transposed:
        raise ValueError("ell_t_cuda needs a transposed DeviceELL")
    w_pad, m_pad = mat.data.shape
    if m_pad < mat.shape[0]:
        raise ValueError(f"slab has {m_pad} rows, the matrix {mat.shape[0]}")
    _require(mat.data, "mat.data", (torch.float32,), (w_pad, m_pad), x.device)
    _require(mat.cols, "mat.cols", (torch.int32,), (w_pad, m_pad), x.device)
    _require(x, "x", (torch.float32,), (mat.shape[1],), x.device)


def ell_t_cuda(mat: DeviceELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (f32, length m) over a transposed (W_pad, M_pad) ELL slab.

    CUDA tensors launch ell_t_kernel; CPU tensors take ell_t_reference.
    Anything else raises."""
    _check(mat, x)
    if x.device.type == "cpu":
        return ell_t_reference(mat, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    m = mat.shape[0]
    y = torch.empty(m, dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.ell_t_launch(
        mat.data.data_ptr(),
        mat.cols.data_ptr(),
        mat.data.shape[0],
        mat.data.shape[1],
        m,
        x.data_ptr(),
        x.shape[0],
        y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"ell_t_kernel launch failed: CUDA error {rc} ({lib.ell_error_string(rc).decode()})"
        )
    ell_t_cuda.launches += 1
    return y


ell_t_cuda.launches = 0


def ell_from_jax(
    data, cols, row_lens, shape, nnz: int, max_row_nz: int, transposed: bool, device="cpu"
) -> DeviceELL:
    """The port's DeviceELL from the JAX package's, given as numpy arrays and
    its static fields. Validates the column range the kernel reads with."""
    cols_np = np.asarray(cols)
    if cols_np.min(initial=0) < 0 or cols_np.max(initial=0) >= int(shape[1]):
        raise ValueError("cols out of range")
    return DeviceELL(
        data=_to_tensor(data, device),
        cols=_to_tensor(cols_np.astype(np.int32), device),
        row_lens=_to_tensor(np.asarray(row_lens).astype(np.int32), device),
        shape=tuple(int(d) for d in shape),
        nnz=int(nnz),
        max_row_nz=int(max_row_nz),
        transposed=bool(transposed),
    )


# ---------------------------------------------------------------------------
# registry hook (imported by ops.registry)
# ---------------------------------------------------------------------------


def _register() -> None:
    from ..formats.matrix import device_ell
    from .registry import KernelSpec, register

    register(
        KernelSpec(
            name="PL_ELL_ROWS_T",
            fmt="ell",
            impl="cuda",
            prepare=lambda csr, ell, cfg, device: device_ell(
                ell, dtype=cfg.torch_dtype, transposed=True, device=device
            ),
            run=ell_t_cuda,
            doc="CUDA transposed-slab ELL: one thread per row walks the "
            "width, coalesced slab reads, x gathered in the kernel",
        )
    )


_register()
