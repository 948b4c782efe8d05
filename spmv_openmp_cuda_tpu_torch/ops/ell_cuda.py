"""CUDA kernel for the transposed-ELL mode (PL_ELL_ROWS_T).

Counterpart of spmv_openmp_cuda_tpu/ops/spmv_pallas.py::ell_t_slab_pallas
and its registry hook: the wrapper of the hand-written kernel in
csrc/ell_spmv.cu (ell_t_kernel, f32), its plain PyTorch version, the
order of its adds (ell_t_in_order), its walk table (walk_table), the
conversion of the JAX package's prepared DeviceELL, and the mode.

The wrapper launches the kernel for CUDA tensors and raises on anything it
does not take; it runs the plain version only for tensors on the CPU. The
layout is checked and its walk table made at its first launch and kept on
the layout while its fields stay the same objects; x is checked at every
call.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..formats.matrix import DeviceELL, target_device
from . import cuda_lib
from .dfloat import fma_f32
from .spmv_cuda import _require, _to_tensor
from .spmv_torch import ell_rows_transposed

#: rows per entry of the walk table, a thread's (csrc/ell_spmv.cu kGroupRows)
GROUP_ROWS = 4


def ell_t_reference(mat: DeviceELL, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A @ x over the transposed slab: the port's
    ELL_ROWS_T (x gathered at cols, multiplied, summed down W)."""
    return ell_rows_transposed(mat, x)


def walk_table(row_lens: torch.Tensor, m: int, group: int = GROUP_ROWS) -> torch.Tensor:
    """How far the kernel's threads walk down the slab: for each `group`
    consecutive rows below m, the longest row's length. (ceil(m / group),)
    int32."""
    n_g = -(-m // group)
    rl = torch.zeros(n_g * group, dtype=torch.int32, device=row_lens.device)
    rl[:m] = row_lens[:m]
    return rl.reshape(n_g, group).amax(dim=1).to(torch.int32)


def ell_t_in_order(mat: DeviceELL, x: torch.Tensor, walk=None) -> torch.Tensor:
    """ell_t_reference's function with the kernel's arithmetic in its order:
    row r's terms data[w, r] * x[cols[w, r]] (x zero outside [0, n)) added w
    ascending from +0, each an FMA rounded once (dfloat.fma_f32), for w
    below walk[r // GROUP_ROWS], or below W_pad when walk is None (the
    full-width walk of every padding slot). The kernel's y is bit for bit
    this one with its walk table."""
    m, n = mat.shape
    w_pad = mat.data.shape[0]
    stop = torch.full((m,), w_pad, device=x.device) if walk is None else \
        walk.long().repeat_interleave(GROUP_ROWS)[:m]
    acc = torch.zeros(m, dtype=torch.float32, device=x.device)
    for w in range(w_pad):
        c = mat.cols[w, :m].long()
        ok = (c >= 0) & (c < n)
        xv = torch.where(ok, x[c.clamp(0, max(n - 1, 0))], torch.zeros((), device=x.device))
        acc = torch.where(w < stop, fma_f32(mat.data[w, :m], xv, acc), acc)
    return acc


def _bind(lib: ctypes.CDLL) -> None:
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.ell_t_launch.argtypes = [p, p, p, ll, ll, p, ll, p, p]
    lib.ell_t_launch.restype = ctypes.c_int
    lib.ell_error_string.argtypes = [ctypes.c_int]
    lib.ell_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return cuda_lib.load("ell_spmv", _bind)


def _check_layout(mat: DeviceELL, dev) -> None:
    """What the kernel reads with: the slab's shapes, dtypes, device and
    contiguity, row_lens within [0, W_pad], and (one device sync) value 0
    in every slot at or past its row's length, the slots it skips."""
    if not mat.transposed:
        raise ValueError("ell_t_cuda needs a transposed DeviceELL")
    if mat.data.dim() != 2:
        raise ValueError(f"slab of shape {tuple(mat.data.shape)}")
    w_pad, m_pad = mat.data.shape
    if m_pad < mat.shape[0]:
        raise ValueError(f"slab has {m_pad} rows, the matrix {mat.shape[0]}")
    _require(mat.data, "mat.data", (torch.float32,), (w_pad, m_pad), dev)
    _require(mat.cols, "mat.cols", (torch.int32,), (w_pad, m_pad), dev)
    _require(mat.row_lens, "mat.row_lens", (torch.int32,), (m_pad,), dev)
    if m_pad % 4 or mat.data.data_ptr() % 16 or mat.cols.data_ptr() % 16:
        raise ValueError("the slab's rows must be 16-byte aligned: the kernel reads four at once")
    past = torch.arange(w_pad, device=dev)[:, None] >= mat.row_lens[None, :]
    short, long_, filled = torch.stack([
        (mat.row_lens < 0).any(), (mat.row_lens > w_pad).any(), (mat.data.ne(0) & past).any(),
    ]).tolist()
    if short or long_:
        raise ValueError(f"row_lens outside [0, {w_pad}]")
    if filled:
        raise ValueError("a slab slot at or past its row's length holds a nonzero value")


def _plan(mat: DeviceELL, dev) -> torch.Tensor:
    """The layout's walk table on device dev, its tensors checked once and
    the table kept on mat while its fields are the same objects."""

    def make():
        _check_layout(mat, dev)
        return walk_table(mat.row_lens, mat.shape[0])

    return cuda_lib.kept_plan(mat, (mat.data, mat.cols, mat.row_lens),
                              (dev, mat.shape, mat.transposed), make)


def ell_t_cuda(mat: DeviceELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (f32, length m) over a transposed (W_pad, M_pad) ELL slab.

    CUDA tensors launch ell_t_kernel (one launch; the layout checked and its
    walk table made at its first launch, x at every call); CPU tensors take
    ell_t_reference. Anything else raises."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    walk = _plan(mat, dev)
    m, n = mat.shape
    _require(x, "x", (torch.float32,), (n,), dev)
    if dev.type == "cpu":
        return ell_t_reference(mat, x)
    y = torch.empty(m, dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.ell_t_launch(
        mat.data.data_ptr(), mat.cols.data_ptr(), walk.data_ptr(), mat.data.shape[1], m,
        x.data_ptr(), n, y.data_ptr(), cuda_lib.current_stream(dev),
    )
    if rc != 0:
        raise RuntimeError(
            f"ell_t_kernel launch failed: CUDA error {rc} ({lib.ell_error_string(rc).decode()})"
        )
    ell_t_cuda.launches += 1
    return y


ell_t_cuda.launches = 0


def ell_from_jax(
    data, cols, row_lens, shape, nnz: int, max_row_nz: int, transposed: bool, device="cuda"
) -> DeviceELL:
    """The port's DeviceELL from the JAX package's, given as numpy arrays and
    its static fields, on `device` (the card unless the caller passes
    device="cpu"). Validates the column range the kernel reads with."""
    device = target_device(device)
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
            doc="CUDA transposed-slab ELL: a thread per four rows, 16-byte "
            "slab loads, each thread walking to the longest of its rows (a "
            "table made once per layout), x gathered in the kernel",
        )
    )


_register()
