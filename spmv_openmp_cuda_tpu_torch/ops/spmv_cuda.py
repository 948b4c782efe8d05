"""CUDA kernels for the SpMV hot path: the DIA family.

Counterpart of spmv_openmp_cuda_tpu/ops/spmv_pallas.py for the DIA modes.
It holds the block plan and the DIA+residual prepare (host numpy, array for
array the JAX package's), the wrapper of the hand-written CUDA kernels in
csrc/dia_spmv.cu, their plain PyTorch version, and the registry hook for the
five DIA modes.

The wrapper launches the kernels for CUDA tensors and raises on anything it
does not take; it runs the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import LANE, SUBLANE
from ..formats.dia import (
    DeviceDIA,
    DiaFillError,
    diagonal_sum,
    make_device_dia,
)
from ..formats.matrix import CSRMatrix, _ceil_to
from . import cuda_lib

_SLAB_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Block plan of the JAX package's DIA kernel (DiaPallasPlan there).

    The residual layout is laid out per block, so the port keeps the plan to
    read the same prepared arrays; the CUDA kernels do not tile by it.
    """

    bs: int  # row groups (of LANE rows) per block
    nblocks: int
    s_pad: int  # padded row-group count (= bs * nblocks)


def plan_dia(
    mat: DeviceDIA, vmem_budget: int = 2 << 20, max_bs: Optional[int] = None
) -> DiaPlan:
    """The JAX package's plan_dia, unchanged: the block height bs sized for
    a TPU VMEM budget, a multiple of 16, and > pad_sub so a 3-block x
    window covers every shift."""
    d, s, _ = mat.data.shape
    bs = max(vmem_budget // (d * LANE * 4), 2 * SUBLANE)
    bs = _ceil_to(bs, 2 * SUBLANE)
    bs = min(bs, _ceil_to(s, 2 * SUBLANE))
    bs = max(bs, _ceil_to(mat.pad_sub + 1, 2 * SUBLANE))
    if max_bs is not None:
        # residual mode: the 3-block window fits a 128-row tile (3*bs <= 128)
        if _ceil_to(mat.pad_sub + 1, 2 * SUBLANE) > max_bs:
            raise DiaFillError("band too wide for the residual window")
        bs = min(bs, max_bs)
    s_pad = _ceil_to(s, bs)
    return DiaPlan(bs=bs, nblocks=s_pad // bs, s_pad=s_pad)


def pad_dia_for_pallas(mat: DeviceDIA, plan: DiaPlan) -> DeviceDIA:
    """Zero-pad the slab's row-group axis up to the plan's block grid (the
    name mirrors the JAX package)."""
    d, s, _ = mat.data.shape
    if s == plan.s_pad:
        return mat
    data = torch.nn.functional.pad(mat.data, (0, 0, 0, plan.s_pad - s))
    return dataclasses.replace(mat, data=data)


@dataclasses.dataclass
class DiaResid:
    """DIA + windowed-residual hybrid (band + scattered fringe, e.g.
    raefsky1): the dense-offset core is a DeviceDIA, the fringe nnz are
    slots (block i, slot row k, lane l) in the JAX package's layout."""

    mat: DeviceDIA
    rvals: torch.Tensor  # (nblocks*k_pad, 128) f32 or bf16
    rsidx: torch.Tensor  # (nblocks*k_pad, 128) int8: column % 128
    rgid: torch.Tensor  # (nblocks*k_pad, 128) int8: row group within block
    rsrc: torch.Tensor  # (nblocks*n_ktiles*8, 128) int32: window row per slot row
    k_pad: int = 16
    nnz_resid: int = 0

    @property
    def n_ktiles(self) -> int:
        return -(-self.k_pad // LANE)


def prepare_dia_resid(
    csr: CSRMatrix,
    dtype: torch.dtype = torch.float32,
    dia_dtype: Optional[torch.dtype] = None,
    vals_dtype: Optional[torch.dtype] = None,
    device="cpu",
) -> Tuple[DiaResid, DiaPlan]:
    """(DiaResid, plan): dense-offset DIA core + windowed residual fringe,
    array for array the JAX package's prepare_dia_resid (f32/bf16 modes).

    dia_dtype/vals_dtype default to dtype; bfloat16 halves the slab bytes
    (accumulation stays f32)."""
    from ..formats.dia import prepare_dia, split_offsets

    dia_dtype = dia_dtype or dtype
    vals_dtype = vals_dtype or dtype
    m, n = csr.shape
    keep = split_offsets(csr)
    rows_all = csr.row_ids().astype(np.int64)
    kept = CSRMatrix(
        shape=(m, n),
        indptr=np.r_[
            0, np.cumsum(np.bincount(rows_all[keep], minlength=m))
        ].astype(np.int64),
        indices=csr.indices[keep],
        data=csr.data[keep],
    )
    mat = prepare_dia(kept, dtype=dia_dtype, device=device)
    plan = plan_dia(mat, max_bs=42)
    mat = pad_dia_for_pallas(mat, plan)
    bs, ps, nblocks = plan.bs, mat.pad_sub, plan.nblocks

    rows_r = rows_all[~keep]
    cols_r = csr.indices[~keep].astype(np.int64)
    data_r = csr.data[~keep]
    blk = rows_r // (bs * LANE)
    lane = rows_r % LANE
    gid_v = (rows_r // LANE) % bs
    dq = cols_r // LANE + ps - blk * bs
    if dq.size and (dq.min() < 0 or dq.max() >= 3 * bs):
        raise DiaFillError("residual column outside the 3-block x window")
    # depth within (block, window-row, lane)
    nqw = 3 * bs
    cell = (blk * nqw + dq) * LANE + lane
    order = np.argsort(cell, kind="stable")
    cs = cell[order]
    if cs.size:
        starts = np.r_[0, np.flatnonzero(np.diff(cs)) + 1]
        rid = np.zeros(cs.shape[0], dtype=np.int64)
        rid[starts] = 1
        rid = np.cumsum(rid) - 1
        depth = np.arange(cs.shape[0]) - starts[rid]
    else:  # fully dense band: empty residual, zero slots only
        depth = np.zeros(0, dtype=np.int64)
    depth_u = np.empty_like(depth)
    depth_u[order] = depth
    bq_id = blk * nqw + dq
    need = np.zeros(nblocks * nqw, dtype=np.int64)
    if bq_id.size:
        np.maximum.at(need, bq_id, depth_u + 1)
    base = np.zeros(nblocks * nqw, dtype=np.int64)
    csum = need.reshape(nblocks, nqw).cumsum(axis=1)
    base.reshape(nblocks, nqw)[:, 1:] = csum[:, :-1]
    k_max = int(csum[:, -1].max(initial=1))
    k_pad = max(_ceil_to(k_max, 2 * SUBLANE), 2 * SUBLANE)
    n_ktiles = -(-k_pad // LANE)
    slot_row = blk * k_pad + base[bq_id] + depth_u
    rvals = np.zeros((nblocks * k_pad, LANE), dtype=np.float64)
    rsidx = np.zeros((nblocks * k_pad, LANE), dtype=np.int8)
    rgid = np.zeros((nblocks * k_pad, LANE), dtype=np.int8)
    rvals[slot_row, lane] = data_r
    rsidx[slot_row, lane] = (cols_r % LANE).astype(np.int8)
    rgid[slot_row, lane] = gid_v.astype(np.int8)
    rsrc_rows = np.zeros(nblocks * k_pad, dtype=np.int32)
    rsrc_rows[slot_row] = dq.astype(np.int32)
    rsrc = np.zeros((nblocks * n_ktiles * 8, LANE), dtype=np.int32)
    for t in range(n_ktiles):
        seg = np.zeros((nblocks, LANE), dtype=np.int32)
        lo, hi = t * LANE, min((t + 1) * LANE, k_pad)
        seg[:, : hi - lo] = rsrc_rows.reshape(nblocks, k_pad)[:, lo:hi]
        rsrc.reshape(nblocks, n_ktiles, 8, LANE)[:, t, 0, :] = seg
    dr = DiaResid(
        mat=mat,
        rvals=torch.from_numpy(rvals).to(vals_dtype).to(device),
        rsidx=torch.from_numpy(rsidx).to(device),
        rgid=torch.from_numpy(rgid).to(device),
        rsrc=torch.from_numpy(rsrc).to(device),
        k_pad=k_pad,
        nnz_resid=int(rows_r.shape[0]),
    )
    return dr, plan


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernels (the CPU path and the chip's check)
# ---------------------------------------------------------------------------


def _x_window(x: torch.Tensor, mat: DeviceDIA, plan: DiaPlan) -> torch.Tensor:
    """Flat f32 x window of (nblocks + 2) * bs row groups: pad_sub zero row
    groups, then x rounded to the slab dtype, then zeros.

    Unlike the JAX kernel's window (pad_x_dia, which clips x at
    (S + pad_sub) * LANE), it holds x up to the window's end: the diagonals
    never read past the clip, but fringe slots of a wide matrix (n > m) can,
    and the JAX kernel then drops their products (ROADMAP.md queue 3)."""
    xk = torch.zeros((plan.nblocks + 2) * plan.bs * LANE, dtype=torch.float32, device=x.device)
    base = mat.pad_sub * LANE
    xs = x[: xk.shape[0] - base]
    xk[base : base + xs.shape[0]] = xs.to(mat.data.dtype).to(torch.float32)
    return xk


def dia_resid_reference(
    resid: DiaResid, x: torch.Tensor, plan: DiaPlan
) -> torch.Tensor:
    """Fringe sums over all s_pad*LANE rows (f32): slot (i, k, l) adds
    rvals * window[i*bs + rsrc_row(i, k), rsidx] into row
    (i*bs + rgid)*LANE + l."""
    nb, bs, kp = plan.nblocks, plan.bs, resid.k_pad
    xk = _x_window(x, resid.mat, plan)
    # window row of each slot row: row 0 of each 8-row group of rsrc
    q = resid.rsrc.reshape(nb, resid.n_ktiles, 8, LANE)[:, :, 0, :]
    q = q.reshape(nb, resid.n_ktiles * LANE)[:, :kp].long()
    blk = torch.arange(nb, device=x.device).reshape(nb, 1, 1)
    lane = torch.arange(LANE, device=x.device).reshape(1, 1, LANE)
    src = (blk * bs + q[:, :, None]) * LANE + resid.rsidx.reshape(nb, kp, LANE).long()
    prod = resid.rvals.reshape(nb, kp, LANE).to(torch.float32) * xk[src]
    dst = (blk * bs + resid.rgid.reshape(nb, kp, LANE).long()) * LANE + lane
    out = torch.zeros(plan.s_pad * LANE, dtype=torch.float32, device=x.device)
    return out.index_add_(0, dst.reshape(-1), prod.reshape(-1))


def dia_spmv_reference(
    mat: DeviceDIA,
    x: torch.Tensor,
    plan: DiaPlan,
    resid: Optional[DiaResid] = None,
) -> torch.Tensor:
    """Plain PyTorch y = A @ x with the semantics of the JAX package's
    dia_spmv_pallas: x rounded to the slab dtype, f32 accumulation over the
    diagonals in ascending offset order, then the fringe sums (which, unlike
    the JAX kernel, also see x past its clip; see _x_window)."""
    xk = _x_window(x, mat, plan)
    acc = diagonal_sum(mat, xk, torch.float32)
    if resid is not None:
        acc = acc + dia_resid_reference(resid, x, plan)
    return acc[: mat.shape[0]]


# ---------------------------------------------------------------------------
# CUDA kernel wrappers (csrc/dia_spmv.cu)
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dia_spmv_launch.argtypes = [i, p, p, i, ll, p, ll, p, p]
    lib.dia_spmv_launch.restype = i
    lib.dia_resid_launch.argtypes = [i, i, p, p, p, p, i, i, i, i, i, p, ll, p, p]
    lib.dia_resid_launch.restype = i
    lib.dia_error_string.argtypes = [i]
    lib.dia_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return cuda_lib.load("dia_spmv", _bind)


def _check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.dia_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _require(t: torch.Tensor, name: str, dtypes, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_dia(mat: DeviceDIA, x: torch.Tensor, plan: DiaPlan) -> None:
    d = len(mat.offsets)
    dev = x.device
    if plan.bs * plan.nblocks != plan.s_pad:
        raise ValueError(f"inconsistent plan {plan}")
    _require(mat.data, "mat.data", _SLAB_DTYPES, (d, plan.s_pad, LANE), dev)
    _require(mat.offsets_dev, "mat.offsets_dev", (torch.int32,), (d,), dev)
    _require(x, "x", (torch.float32,), (mat.shape[1],), dev)


def _check_resid(resid: DiaResid, plan: DiaPlan, dev) -> None:
    rows = (plan.nblocks * resid.k_pad, LANE)
    _require(resid.rvals, "resid.rvals", _SLAB_DTYPES, rows, dev)
    _require(resid.rsidx, "resid.rsidx", (torch.int8,), rows, dev)
    _require(resid.rgid, "resid.rgid", (torch.int8,), rows, dev)
    _require(
        resid.rsrc, "resid.rsrc", (torch.int32,),
        (plan.nblocks * resid.n_ktiles * 8, LANE), dev,
    )
    if plan.bs * LANE * 4 > 48 << 10:
        raise ValueError(f"block height bs={plan.bs} exceeds the fringe kernel's shared memory")


def dia_resid_cuda(
    resid: DiaResid, x: torch.Tensor, y: torch.Tensor, plan: DiaPlan
) -> torch.Tensor:
    """y += fringe sums (y holds all s_pad*LANE rows, f32), in place.

    CUDA tensors launch dia_resid_kernel; CPU tensors take
    dia_resid_reference."""
    _check_dia(resid.mat, x, plan)
    _check_resid(resid, plan, x.device)
    _require(y, "y", (torch.float32,), (plan.s_pad * LANE,), x.device)
    if x.device.type == "cpu":
        return y.add_(dia_resid_reference(resid, x, plan))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _lib()
    rc = lib.dia_resid_launch(
        int(resid.rvals.dtype == torch.bfloat16),
        int(resid.mat.data.dtype == torch.bfloat16),
        resid.rvals.data_ptr(),
        resid.rsidx.data_ptr(),
        resid.rgid.data_ptr(),
        resid.rsrc.data_ptr(),
        plan.nblocks,
        plan.bs,
        resid.k_pad,
        resid.n_ktiles,
        resid.mat.pad_sub,
        x.data_ptr(),
        x.shape[0],
        y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_launch(lib, rc, "dia_resid_kernel")
    dia_resid_cuda.launches += 1
    return y


dia_resid_cuda.launches = 0


def dia_spmv_cuda(
    mat: DeviceDIA,
    x: torch.Tensor,
    plan: DiaPlan,
    resid: Optional[DiaResid] = None,
) -> torch.Tensor:
    """y = A @ x (f32, length m) over a plan-padded DIA slab, plus the
    residual fringe when `resid` is given.

    CUDA tensors launch dia_rows_kernel (and dia_resid_kernel on the same
    stream); CPU tensors take dia_spmv_reference. Anything else raises."""
    _check_dia(mat, x, plan)
    if resid is not None and resid.mat is not mat:
        raise ValueError("resid.mat must be the DeviceDIA passed as mat")
    if x.device.type == "cpu":
        return dia_spmv_reference(mat, x, plan, resid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows = plan.s_pad * LANE
    y = torch.empty(rows, dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.dia_spmv_launch(
        int(mat.data.dtype == torch.bfloat16),
        mat.data.data_ptr(),
        mat.offsets_dev.data_ptr(),
        len(mat.offsets),
        rows,
        x.data_ptr(),
        x.shape[0],
        y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_launch(lib, rc, "dia_rows_kernel")
    dia_spmv_cuda.launches += 1
    if resid is not None:
        dia_resid_cuda(resid, x, y, plan)
    return y[: mat.shape[0]]


dia_spmv_cuda.launches = 0


# ---------------------------------------------------------------------------
# Prepared state from the JAX package
# ---------------------------------------------------------------------------


def _to_tensor(a, device) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16, bit for bit) -> tensor on device."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_operands(
    data,
    offsets,
    shape,
    nnz: int,
    pad_sub: int,
    bs: int,
    nblocks: int,
    s_pad: int,
    rvals=None,
    rsidx=None,
    rgid=None,
    rsrc=None,
    k_pad: Optional[int] = None,
    nnz_resid: Optional[int] = None,
    device="cpu",
) -> Tuple[DeviceDIA, DiaPlan, Optional[DiaResid]]:
    """The port's (DeviceDIA, plan, DiaResid or None) from the JAX package's
    prepared DIA operands, given as numpy arrays and their static fields
    (DeviceDIA data/offsets/shape/nnz/pad_sub, DiaPallasPlan bs/nblocks/
    s_pad, and for the hybrid DiaResid rvals/rsidx/rgid/rsrc/k_pad/
    nnz_resid). Validates what the kernels index with."""
    plan = DiaPlan(bs=int(bs), nblocks=int(nblocks), s_pad=int(s_pad))
    offsets = [int(o) for o in offsets]
    if offsets and max(abs(o) for o in offsets) > pad_sub * LANE:
        raise ValueError("an offset exceeds the pad_sub reach")
    mat = make_device_dia(_to_tensor(data, device), offsets, shape, nnz, pad_sub)
    if tuple(mat.data.shape) != (len(offsets), plan.s_pad, LANE):
        raise ValueError(f"data shape {tuple(mat.data.shape)} does not match the plan {plan}")
    if rvals is None:
        return mat, plan, None
    rsidx_np, rgid_np, rsrc_np = (np.asarray(a) for a in (rsidx, rgid, rsrc))
    if rsidx_np.min(initial=0) < 0 or rgid_np.min(initial=0) < 0 or rgid_np.max(initial=0) >= plan.bs:
        raise ValueError("rsidx/rgid out of range")
    if rsrc_np.min(initial=0) < 0 or rsrc_np.max(initial=0) >= 3 * plan.bs:
        raise ValueError("rsrc outside the 3-block window")
    resid = DiaResid(
        mat=mat,
        rvals=_to_tensor(rvals, device),
        rsidx=_to_tensor(rsidx_np, device),
        rgid=_to_tensor(rgid_np, device),
        rsrc=_to_tensor(rsrc_np, device),
        k_pad=int(k_pad),
        nnz_resid=int(nnz_resid),
    )
    _check_resid(resid, plan, mat.data.device)
    return mat, plan, resid


# ---------------------------------------------------------------------------
# registry hook (imported by ops.registry)
# ---------------------------------------------------------------------------


def _register() -> None:
    from ..formats.dia import dia_spmv, prepare_dia
    from .registry import KernelSpec, register

    register(
        KernelSpec(
            name="DIA_ROWS",
            fmt="csr",
            impl="torch",
            prepare=lambda csr, ell, cfg, device: prepare_dia(
                csr, dtype=cfg.torch_dtype, device=device
            ),
            run=dia_spmv,
            doc="diagonal storage in plain torch: y = sum_d diag_d * "
            "shift(x, d), summed in the slab dtype (raises DiaFillError "
            "beyond a 3x padding budget, the ELL-cap analog)",
        )
    )

    def _mk_prep_dia(force_dtype=None):
        def _prep(csr, ell, cfg, device):
            mat = prepare_dia(csr, dtype=force_dtype or cfg.torch_dtype, device=device)
            plan = plan_dia(mat)
            return (pad_dia_for_pallas(mat, plan), plan)

        return _prep

    def _run_dia(ops, x):
        return dia_spmv_cuda(ops[0], x, ops[1])

    def _mk_prep_resid(dt=None):
        def _prep(csr, ell, cfg, device):
            return prepare_dia_resid(
                csr, dtype=cfg.torch_dtype, dia_dtype=dt, vals_dtype=dt, device=device
            )

        return _prep

    def _run_resid(ops, x):
        dr, plan = ops
        return dia_spmv_cuda(dr.mat, x, plan, resid=dr)

    register(
        KernelSpec(
            name="PL_DIA_ROWS",
            fmt="csr",
            impl="cuda",
            prepare=_mk_prep_dia(),
            run=_run_dia,
            doc="CUDA diagonal kernel: one thread per row, coalesced slab "
            "and x reads, offsets from a device array",
        )
    )
    register(
        KernelSpec(
            name="PL_DIA_BF16",
            fmt="csr",
            impl="cuda",
            prepare=_mk_prep_dia(torch.bfloat16),
            run=_run_dia,
            doc="CUDA diagonal kernel over a bf16 slab (x rounded to bf16, "
            "f32 accumulate): half the slab bytes",
        )
    )
    register(
        KernelSpec(
            name="PL_DIA_RESID",
            fmt="csr",
            impl="cuda",
            prepare=_mk_prep_resid(),
            run=_run_resid,
            doc="DIA + residual hybrid: dense-offset diagonals in the CUDA "
            "diagonal kernel, the scattered fringe in a second kernel on "
            "the same stream (one thread per block and lane, no atomics)",
        )
    )
    register(
        KernelSpec(
            name="PL_DIA_RESID_BF16",
            fmt="csr",
            impl="cuda",
            prepare=_mk_prep_resid(torch.bfloat16),
            run=_run_resid,
            doc="DIA + residual hybrid with bf16 slabs (f32 accumulate)",
        )
    )


_register()
