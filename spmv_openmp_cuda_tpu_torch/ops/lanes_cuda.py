"""CUDA kernel for the lane-gather engine (PL_CSR_LANES).

Counterpart of the kernel half of spmv_openmp_cuda_tpu/formats/lanes.py
(lanes_small_spmv) and of its registry hook: the wrapper of the
hand-written kernels in csrc/lanes_spmv.cu (lanes_kernel and its
fixed-order combine, f32), their plain PyTorch version, the conversion of
the JAX package's prepared LanesSmall, and the mode.

The wrapper launches the kernels for CUDA tensors and raises on anything it
does not take; it runs the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import LANE
from ..formats.lanes import LanesError, LanesSmall, tile_windows
from . import cuda_lib
from .routed_cuda import pack_x_windows_flat
from .spmv_cuda import _require, _to_tensor

#: row groups the kernel's shared-memory tile holds (G * 128 f32 <= 32 KB)
MAX_GROUPS = 64


def lanes_reference(mat: LanesSmall, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A @ x with the TPU kernel's arithmetic: per slot
    row s of a tile of window w, gather the transposed window row
    xw[w*128 + s%128] at pidx, multiply by vals, then G masked sums over
    the slot rows into (G, 128); y = that array's first m entries."""
    ks = mat.vals.shape[0]
    dev = x.device
    xw = pack_x_windows_flat(x, len(mat.window_tiles))
    wrow = mat.tile_win.long().repeat_interleave(LANE) * LANE + torch.arange(ks, device=dev) % LANE
    prod = mat.vals * torch.gather(xw[wrow], 1, mat.pidx.long())
    acc = torch.stack([torch.where(mat.gid == g, prod, 0).sum(dim=0) for g in range(mat.n_groups)])
    return acc.reshape(-1)[: mat.shape[0]]


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lanes_launch.argtypes = [p, p, p, p, ll, i, p, ll, ll, p, p, p]
    lib.lanes_launch.restype = i
    lib.lanes_rows_per_cta.argtypes = []
    lib.lanes_rows_per_cta.restype = i
    lib.lanes_error_string.argtypes = [i]
    lib.lanes_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return cuda_lib.load("lanes_spmv", _bind)


def _check(mat: LanesSmall, x: torch.Tensor) -> None:
    ks = mat.vals.shape[0]
    if ks % LANE or ks == 0:
        raise ValueError(f"{ks} slot rows: not whole tiles")
    if not 0 < mat.n_groups <= MAX_GROUPS or mat.n_groups * LANE < mat.shape[0]:
        raise ValueError(f"n_groups={mat.n_groups} for {mat.shape[0]} rows (at most {MAX_GROUPS})")
    dev = x.device
    _require(mat.vals, "mat.vals", (torch.float32,), (ks, LANE), dev)
    _require(mat.pidx, "mat.pidx", (torch.int32,), (ks, LANE), dev)
    _require(mat.gid, "mat.gid", (torch.int32,), (ks, LANE), dev)
    _require(mat.tile_win, "mat.tile_win", (torch.int32,), (ks // LANE,), dev)
    _require(x, "x", (torch.float32,), (mat.shape[1],), dev)


def lanes_cuda(mat: LanesSmall, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (f32, length m) over a lane-gather layout.

    CUDA tensors launch lanes_kernel and its combine; CPU tensors take
    lanes_reference. Anything else raises."""
    _check(mat, x)
    if x.device.type == "cpu":
        return lanes_reference(mat, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _lib()
    ks = mat.vals.shape[0]
    n_parts = -(-ks // lib.lanes_rows_per_cta())
    m = mat.shape[0]
    partials = torch.empty(n_parts * mat.n_groups * LANE, dtype=torch.float32, device=x.device)
    y = torch.empty(m, dtype=torch.float32, device=x.device)
    rc = lib.lanes_launch(
        mat.vals.data_ptr(),
        mat.pidx.data_ptr(),
        mat.gid.data_ptr(),
        mat.tile_win.data_ptr(),
        ks,
        mat.n_groups,
        x.data_ptr(),
        x.shape[0],
        m,
        partials.data_ptr(),
        y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"lanes_kernel launch failed: CUDA error {rc} ({lib.lanes_error_string(rc).decode()})"
        )
    lanes_cuda.launches += 1
    return y


lanes_cuda.launches = 0


def lanes_from_jax(
    vals, pidx, gid, window_tiles, shape, nnz: int, n_groups: int, device="cpu"
) -> LanesSmall:
    """The port's LanesSmall from the JAX package's, given as numpy arrays
    and its static fields. Validates the index ranges the kernel reads
    with."""
    pidx_np, gid_np = np.asarray(pidx), np.asarray(gid)
    ks = pidx_np.shape[0]
    if pidx_np.min(initial=0) < 0 or pidx_np.max(initial=0) >= LANE:
        raise ValueError("pidx out of range")
    if gid_np.min(initial=0) < 0 or gid_np.max(initial=0) >= int(n_groups):
        raise ValueError("gid out of range")
    window_tiles = tuple((int(a), int(b)) for a, b in window_tiles)
    if any(b < a for a, b in window_tiles) or window_tiles[-1][1] * LANE > ks:
        raise LanesError(f"window tile ranges {window_tiles} do not fit {ks} slot rows")
    mat = LanesSmall(
        vals=_to_tensor(vals, device),
        pidx=_to_tensor(pidx_np.astype(np.int32), device),
        gid=_to_tensor(gid_np.astype(np.int32), device),
        tile_win=torch.as_tensor(tile_windows(window_tiles, ks // LANE), device=device),
        window_tiles=window_tiles,
        shape=tuple(int(d) for d in shape),
        nnz=int(nnz),
        n_groups=int(n_groups),
    )
    _check(mat, torch.zeros(mat.shape[1], dtype=mat.vals.dtype, device=device))
    return mat


# ---------------------------------------------------------------------------
# registry hook (imported by ops.registry)
# ---------------------------------------------------------------------------


def _register() -> None:
    from ..formats.lanes import prepare_lanes_small
    from .registry import KernelSpec, register

    register(
        KernelSpec(
            name="PL_CSR_LANES",
            fmt="csr",
            impl="cuda",
            prepare=lambda csr, ell, cfg, device: prepare_lanes_small(
                csr, dtype=cfg.torch_dtype, device=device
            ),
            run=lanes_cuda,
            doc="CUDA lane-gather engine for small unstructured matrices "
            "(G <= 64 row groups): x gathered by column, per-CTA row-group "
            "sums in shared memory (thread = lane, no atomics), partials "
            "combined in a fixed order",
        )
    )


_register()
