"""CUDA kernel for the lane-gather engine (PL_CSR_LANES).

Counterpart of the kernel half of spmv_openmp_cuda_tpu/formats/lanes.py
(lanes_small_spmv) and of its registry hook: the wrapper of the
hand-written kernel in csrc/lanes_spmv.cu (lanes_kernel, f32, one launch
per product), its plain PyTorch version, its launch plan (launch_plan: the
thread-block cluster per band of 32 lanes, the slot rows per warp), the
conversion of the JAX package's prepared LanesSmall, and the mode.

The wrapper launches the kernel for CUDA tensors and raises on anything it
does not take; it runs the plain version only for tensors on the CPU. The
layout's tensors are checked and its plan made at its first launch and kept
on the layout while its fields stay the same objects; x is checked at every
call.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..config import LANE
from ..formats.lanes import LanesError, LanesSmall, tile_windows
from ..formats.matrix import target_device
from ..formats.routed import pack_x_windows_flat
from . import cuda_lib
from .spmv_cuda import _require, _to_tensor

#: row groups a warp's shared-memory tile holds (G * 32 f32 <= 8 KB)
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


#: csrc/lanes_spmv.cu: bands of 32 lanes, warps per CTA, slot rows per
#: batch (a warp's ranges are whole batches), the largest cluster
BANDS, WARPS, BATCH, MAX_CLUSTER = LANE // 32, 8, 16, 8


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How csrc/lanes_spmv.cu runs a layout: `cluster` CTAs per band of 32
    lanes (1, or a thread-block cluster of 2, 4 or 8), of WARPS warps
    each; warp wg = rank*WARPS + w takes the batches of BATCH slot rows
    [wg*step, (wg+1)*step); `smem` bytes of dynamic shared memory (smem_bytes)."""

    cluster: int
    step: int
    smem: int


def launch_plan(n_rows: int, n_groups: int) -> LaunchPlan:
    """The cluster doubles (up to 8) while its warps are fewer than the
    batches of slot rows; the batches are then split evenly over the band's
    warps."""
    batches = n_rows // BATCH
    cluster = 1
    while cluster < MAX_CLUSTER and batches > cluster * WARPS:
        cluster *= 2
    return LaunchPlan(cluster=cluster, step=-(-batches // (cluster * WARPS)),
                      smem=smem_bytes(n_groups, cluster))


def smem_bytes(n_groups: int, cluster: int) -> int:
    """csrc/lanes_spmv.cu's lanes_smem: a (G, 32) f32 tile per warp, and
    the inbox of the close (a slot per rank of the row groups the CTA
    writes)."""
    return (WARPS * n_groups + cluster * -(-n_groups // cluster)) * 32 * 4


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lanes_launch.argtypes = [p, p, p, p, i, i, p, ll, ll, p, i, i, i, p]
    lib.lanes_launch.restype = i
    lib.lanes_error_string.argtypes = [i]
    lib.lanes_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return cuda_lib.load("lanes_spmv", _bind)


def _check_layout(mat: LanesSmall, dev) -> None:
    ks = mat.vals.shape[0]
    if ks % LANE or ks == 0:
        raise ValueError(f"{ks} slot rows: not whole tiles")
    if not 0 < mat.n_groups <= MAX_GROUPS or mat.n_groups * LANE < mat.shape[0]:
        raise ValueError(f"n_groups={mat.n_groups} for {mat.shape[0]} rows (at most {MAX_GROUPS})")
    _require(mat.vals, "mat.vals", (torch.float32,), (ks, LANE), dev)
    _require(mat.pidx, "mat.pidx", (torch.int32,), (ks, LANE), dev)
    _require(mat.gid, "mat.gid", (torch.int32,), (ks, LANE), dev)
    _require(mat.tile_win, "mat.tile_win", (torch.int32,), (ks // LANE,), dev)


def _check(mat: LanesSmall, x: torch.Tensor) -> None:
    _check_layout(mat, x.device)
    _require(x, "x", (torch.float32,), (mat.shape[1],), x.device)


def _plan(mat: LanesSmall, dev) -> LaunchPlan:
    """The layout's launch plan on CUDA device dev, its tensors checked once
    and the plan kept on mat while its fields are the same objects."""

    def make():
        _check_layout(mat, dev)
        return launch_plan(mat.vals.shape[0], mat.n_groups)

    return cuda_lib.kept_plan(mat, (mat.vals, mat.pidx, mat.gid, mat.tile_win),
                              (dev, mat.shape, mat.n_groups), make)


def lanes_cuda(mat: LanesSmall, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (f32, length m) over a lane-gather layout.

    CUDA tensors launch lanes_kernel (one launch; the layout checked and its
    plan made at its first launch, x at every call); CPU tensors take
    lanes_reference. Anything else raises."""
    dev = x.device
    if dev.type == "cpu":
        _check(mat, x)
        return lanes_reference(mat, x)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    plan = _plan(mat, dev)
    m, n = mat.shape
    _require(x, "x", (torch.float32,), (n,), dev)
    y = torch.empty(m, dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.lanes_launch(
        mat.vals.data_ptr(), mat.pidx.data_ptr(), mat.gid.data_ptr(), mat.tile_win.data_ptr(),
        mat.vals.shape[0], mat.n_groups, x.data_ptr(), n, m, y.data_ptr(), plan.cluster,
        plan.step, plan.smem, cuda_lib.current_stream(dev),
    )
    if rc != 0:
        raise RuntimeError(
            f"lanes_kernel launch failed: CUDA error {rc} ({lib.lanes_error_string(rc).decode()})"
        )
    lanes_cuda.launches += 1
    return y


lanes_cuda.launches = 0


def lanes_from_jax(
    vals, pidx, gid, window_tiles, shape, nnz: int, n_groups: int, device="cuda"
) -> LanesSmall:
    """The port's LanesSmall from the JAX package's, given as numpy arrays
    and its static fields, on `device` (the card unless the caller passes
    device="cpu"). Validates the index ranges the kernel reads with."""
    device = target_device(device)
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
            "(G <= 64 row groups): x gathered by column, one launch, bands "
            "of 32 lanes over thread-block clusters, per-warp row-group sums "
            "in shared memory closed in a fixed order (no atomics)",
        )
    )


_register()
