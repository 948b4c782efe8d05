"""CUDA kernels for the SpMV hot path: the DIA family.

Counterpart of spmv_openmp_cuda_tpu/ops/spmv_pallas.py for the DIA modes.
It holds the block plan and the DIA+residual prepare (host numpy, array for
array the JAX package's, plus the fringe as per-row lists for the kernels),
the wrappers of the hand-written CUDA kernels in csrc/dia_spmv.cu (f32/bf16:
dia_rows_kernel, and dia_resid_kernel for the whole DIA+residual product)
and of the double-float ones in csrc/df_spmv.cu (float64: dia_df_kernel,
dia_resid_df_kernel), their plain PyTorch versions, and the registry hook
for the seven DIA modes.

The wrappers launch the kernels for CUDA tensors and raise on anything they
do not take; they run the plain version only for tensors on the CPU. Every
DIA product on the card is one launch that allocates y (m rows) and nothing
else: in float64 the kernel splits x and combines y itself. A layout is
checked and its launch plan (rows a thread, or threads a row) made at its
first launch, with no device sync in the DIA rows check, and kept on the
layout while its tensors stay the same objects; x is checked at every call.
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
    DeviceDIADF,
    DiaFillError,
    diagonal_sum,
    make_device_dia,
    make_device_dia_df,
    prepare_dia_df,
)
from ..formats.matrix import CSRMatrix, _ceil_to, target_device
from . import cuda_lib, dfloat

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


#: the df plans' per-plane slab budget: the (hi, lo) pair keeps two f32
#: planes of a diagonal block resident on the TPU, so half the f32 kernel's
#: 2 << 20 (kept so that the layouts match the JAX package's)
DF_DIA_VMEM_BUDGET = 1 << 20


def pad_dia_df_for_pallas(mat: DeviceDIADF, plan: DiaPlan) -> DeviceDIADF:
    """pad_dia_for_pallas for the (hi, lo) pair."""
    d, s, _ = mat.data.shape
    if s == plan.s_pad:
        return mat
    pad = (0, 0, 0, plan.s_pad - s)
    return dataclasses.replace(
        mat, data=torch.nn.functional.pad(mat.data, pad),
        data_lo=torch.nn.functional.pad(mat.data_lo, pad),
    )


def prepare_dia_df_pallas(
    csr: CSRMatrix, max_fill_ratio: float = 3.0, device="cuda"
) -> Tuple[DeviceDIADF, DiaPlan]:
    """(DeviceDIADF, plan) for PL_DIA_F64, the JAX package's
    prepare_dia_df_pallas (the halved per-plane budget), on `device` (the
    card unless the caller passes device="cpu")."""
    device = target_device(device)
    mat = prepare_dia_df(csr, max_fill_ratio=max_fill_ratio, device=device)
    plan = plan_dia(mat.as_dia(), vmem_budget=DF_DIA_VMEM_BUDGET)
    return pad_dia_df_for_pallas(mat, plan), plan


@dataclasses.dataclass
class DiaResid:
    """DIA + windowed-residual hybrid (band + scattered fringe, e.g.
    raefsky1): the dense-offset core is a DeviceDIA (a DeviceDIADF in the
    double-float mode, with rvals_lo set), the fringe nnz are slots (block
    i, slot row k, lane l) in the JAX package's layout, and the same nnz as
    per-row lists for the CUDA kernels."""

    mat: DeviceDIA
    rvals: torch.Tensor  # (nblocks*k_pad, 128) f32 or bf16 (df: hi words)
    rsidx: torch.Tensor  # (nblocks*k_pad, 128) int8: column % 128
    rgid: torch.Tensor  # (nblocks*k_pad, 128) int8: row group within block
    rsrc: torch.Tensor  # (nblocks*n_ktiles*8, 128) int32: window row per slot row
    k_pad: int = 16
    nnz_resid: int = 0
    rvals_lo: Optional[torch.Tensor] = None  # df mode: f32 lo words
    # the fringe as per-row lists (with_fringe_lists; what the kernels read):
    # row i's entries, in ascending slot row k, are row_ptr[i] ..
    # row_ptr[i + 1] - 1 of (fr_val, fr_col), and of fr_lo in df mode
    row_ptr: Optional[torch.Tensor] = None  # (m + 1,) int32
    fr_val: Optional[torch.Tensor] = None  # (nf,) f32 (df: hi words)
    fr_col: Optional[torch.Tensor] = None  # (nf,) int32: the column of x
    fr_lo: Optional[torch.Tensor] = None  # (nf,) f32: df lo words

    @property
    def n_ktiles(self) -> int:
        return -(-self.k_pad // LANE)


def with_fringe_lists(resid: DiaResid, plan: DiaPlan) -> DiaResid:
    """resid with its per-row fringe lists, built from its JAX-layout arrays
    (rvals/rvals_lo/rsidx/rgid/rsrc): slot (i, k, l) of value v adds v *
    x[(i*bs + q - pad_sub)*128 + rsidx] into row (i*bs + rgid)*128 + l,
    where q is slot row k's window row. Each row's entries keep ascending k
    (a stable sort by row of the (i, k, l)-ordered slots; a row's slots all
    lie in one block and lane), the order in which the TPU kernel and the
    CUDA kernels add them.

    Slots of value 0 (the layout's padding) are left out: with finite x
    their products are +-0, which leave a sum that starts at +0 bit for bit
    as it is. Slots of rows >= m are left out too (y has m rows)."""
    nb, bs, kp = plan.nblocks, plan.bs, resid.k_pad
    m = resid.mat.shape[0]
    cube = (nb, kp, LANE)
    vals = resid.rvals.float().cpu().numpy().reshape(cube)
    lo = None if resid.rvals_lo is None else resid.rvals_lo.cpu().numpy().reshape(cube)
    sidx = resid.rsidx.cpu().numpy().reshape(cube).astype(np.int64)
    gid = resid.rgid.cpu().numpy().reshape(cube).astype(np.int64)
    q = resid.rsrc.cpu().numpy().reshape(nb, resid.n_ktiles, 8, LANE)[:, :, 0, :]
    q = q.reshape(nb, -1)[:, :kp, None].astype(np.int64)
    blk = np.arange(nb, dtype=np.int64).reshape(nb, 1, 1)
    rows = (blk * bs + gid) * LANE + np.arange(LANE)
    cols = (blk * bs + q - resid.mat.pad_sub) * LANE + sidx
    keep = (vals != 0) if lo is None else (vals != 0) | (lo != 0)
    keep &= rows < m
    rows = rows[keep]
    order = np.argsort(rows, kind="stable")
    dev = resid.rvals.device
    ptr = np.r_[0, np.cumsum(np.bincount(rows, minlength=m))]
    return dataclasses.replace(
        resid,
        row_ptr=torch.from_numpy(ptr.astype(np.int32)).to(dev),
        fr_val=torch.from_numpy(vals[keep][order]).to(dev),
        fr_col=torch.from_numpy(cols[keep][order].astype(np.int32)).to(dev),
        fr_lo=None if lo is None else torch.from_numpy(lo[keep][order]).to(dev),
    )


def prepare_dia_resid(
    csr: CSRMatrix,
    dtype: torch.dtype = torch.float32,
    dia_dtype: Optional[torch.dtype] = None,
    vals_dtype: Optional[torch.dtype] = None,
    device="cuda",
    df: bool = False,
) -> Tuple[DiaResid, DiaPlan]:
    """(DiaResid, plan): dense-offset DIA core + windowed residual fringe,
    array for array the JAX package's prepare_dia_resid, on `device` (the
    card unless the caller passes device="cpu").

    dia_dtype/vals_dtype default to dtype; bfloat16 halves the slab bytes
    (accumulation stays f32). df=True builds the double-float hybrid: a
    DeviceDIADF core (the df plan budget) and (hi, lo) fringe values; dtype
    is then ignored."""
    from ..formats.dia import prepare_dia, split_offsets

    device = target_device(device)
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
    if df:
        mat = prepare_dia_df(kept, device=device)
        plan = plan_dia(mat.as_dia(), vmem_budget=DF_DIA_VMEM_BUDGET, max_bs=42)
        mat = pad_dia_df_for_pallas(mat, plan)
    else:
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
    if df:
        rhi, rlo = dfloat.split_f64(rvals)
        rvals_t, rvals_lo_t = torch.from_numpy(rhi).to(device), torch.from_numpy(rlo).to(device)
    else:
        rvals_t, rvals_lo_t = torch.from_numpy(rvals).to(vals_dtype).to(device), None
    dr = DiaResid(
        mat=mat,
        rvals=rvals_t,
        rsidx=torch.from_numpy(rsidx).to(device),
        rgid=torch.from_numpy(rgid).to(device),
        rsrc=torch.from_numpy(rsrc).to(device),
        k_pad=k_pad,
        nnz_resid=int(rows_r.shape[0]),
        rvals_lo=rvals_lo_t,
    )
    return with_fringe_lists(dr, plan), plan


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


def _x_gather(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x[cols], 0 where a column lies outside [0, n) (the kernels' bounds
    test)."""
    ok = (cols >= 0) & (cols < x.shape[0])
    return torch.where(ok, x[cols.clamp(0, max(x.shape[0] - 1, 0))], x.new_zeros(()))


def _list_rounds(resid: DiaResid):
    """(rows, entries) for each list position j: the rows whose list is
    longer than j and their j-th entries, so that adding round after round
    adds each row's entries in list order."""
    ptr = resid.row_ptr.long()
    start, lens = ptr[:-1], ptr[1:] - ptr[:-1]
    for j in range(int(lens.max()) if lens.numel() else 0):
        rows = torch.nonzero(lens > j).reshape(-1)
        yield rows, start[rows] + j


def resid_lists_reference(resid: DiaResid, x: torch.Tensor) -> torch.Tensor:
    """The fringe sums of rows 0..m-1 (f32) over the per-row lists, in the
    kernel's order: each row's products (x rounded to the slab dtype) added
    one by one in list order, from 0."""
    xr = x.to(resid.mat.data.dtype).to(torch.float32)
    prod = resid.fr_val * _x_gather(xr, resid.fr_col.long())
    out = torch.zeros(resid.row_ptr.shape[0] - 1, dtype=torch.float32, device=x.device)
    for rows, ent in _list_rounds(resid):
        out[rows] = out[rows] + prod[ent]
    return out


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
    lib.dia_spmv_launch.argtypes = [i, p, p, i, ll, ll, p, ll, p, i, p]
    lib.dia_spmv_launch.restype = i
    lib.dia_resid_launch.argtypes = [i, p, p, i, ll, ll, p, p, p, p, ll, p, i, p]
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


def _check_x(x: torch.Tensor, dtype: torch.dtype, n: int) -> None:
    """x at every launch: its dtype, length and contiguity (the launch's
    device is x's), in a few attribute reads on the common path."""
    if x.dtype is not dtype or x.shape != (n,) or not x.is_contiguous():
        _require(x, "x", (dtype,), (n,), x.device)


def _check_kind(mat, df: bool) -> None:
    if df and not isinstance(mat, DeviceDIADF):
        raise TypeError("the double-float DIA kernels take a DeviceDIADF")
    if not df and isinstance(mat, DeviceDIADF):
        raise TypeError("a DeviceDIADF runs through dia_spmv_df_cuda (float64)")


def _check_dia_layout(mat, plan: DiaPlan, dev) -> None:
    """The plan, the slab (both planes of a DeviceDIADF, f32) and the
    offsets, on dev."""
    df = isinstance(mat, DeviceDIADF)
    d = len(mat.offsets)
    if plan.bs * plan.nblocks != plan.s_pad:
        raise ValueError(f"inconsistent plan {plan}")
    for name, t in _planes(mat):
        _require(t, name, (torch.float32,) if df else _SLAB_DTYPES, (d, plan.s_pad, LANE), dev)
    _require(mat.offsets_dev, "mat.offsets_dev", (torch.int32,), (d,), dev)


def _planes(mat):
    planes = (("mat.data", mat.data),)
    if isinstance(mat, DeviceDIADF):
        planes += (("mat.data_lo", mat.data_lo),)
    return planes


def _check_dia(mat, x: torch.Tensor, plan: DiaPlan, df: bool = False) -> None:
    """A product's check on the CPU, at every call: the layout and x (f64
    in df)."""
    _check_kind(mat, df)
    _check_dia_layout(mat, plan, x.device)
    _require(x, "x", (torch.float64 if df else torch.float32,), (mat.shape[1],), x.device)


def _check_resid(resid: DiaResid, plan: DiaPlan, dev) -> None:
    """The fringe's JAX-layout arrays (what the plain versions read and the
    lists are built from); a df fringe (rvals_lo set) holds two f32 value
    planes."""
    rows = (plan.nblocks * resid.k_pad, LANE)
    df = resid.rvals_lo is not None
    _require(resid.rvals, "resid.rvals", (torch.float32,) if df else _SLAB_DTYPES, rows, dev)
    if df:
        _require(resid.rvals_lo, "resid.rvals_lo", (torch.float32,), rows, dev)
    _require(resid.rsidx, "resid.rsidx", (torch.int8,), rows, dev)
    _require(resid.rgid, "resid.rgid", (torch.int8,), rows, dev)
    _require(
        resid.rsrc, "resid.rsrc", (torch.int32,),
        (plan.nblocks * resid.n_ktiles * 8, LANE), dev,
    )


#: csrc/dia_spmv.cu and df_spmv.cu: threads per CTA of every DIA kernel,
#: the most threads a row's diagonals are split over in the DIA+residual
#: kernels, and the SMs of an H100 (the CTAs a launch should at least give)
RESID_THREADS, MAX_GROUPS, SMS = 256, 16, 132


def rows_a_thread(m: int) -> int:
    """Rows a thread of the DIA rows kernels (dia_rows_kernel,
    dia_df_kernel): 4, one vector load per diagonal and slab plane, while
    m / 4 threads in CTAs of 256 still give the card's SMs a CTA each, else
    1 (cavity10_like, 2597 rows: 1; the 1000 x 1000 grid's Laplacian, 10^6
    rows: 4, in 977 CTAs). Either way each row has one owner thread and the
    same order of adds."""
    return 4 if -(-m // (4 * RESID_THREADS)) >= SMS else 1


def launch_groups(m: int, n_diag: int) -> int:
    """Threads per row of the DIA+residual kernels: 1, doubled while the
    grid of m * groups / 256 CTAs has fewer CTAs than the card has SMs, up to
    16 and to the diagonal count (raefsky1_like: 16, 203 CTAs; a
    200,000-row slab: 1, one thread per row)."""
    groups = 1
    while groups < MAX_GROUPS and 2 * groups <= n_diag and -(-m * groups // RESID_THREADS) < SMS:
        groups *= 2
    return groups


def _check_resid_layout(resid: DiaResid, plan: DiaPlan, dev) -> None:
    """What the DIA+residual kernels read: the slab (both planes in df), the
    offsets and the per-row fringe lists. One device sync reads row_ptr's
    ends and order."""
    mat = resid.mat
    df = isinstance(mat, DeviceDIADF)
    m = mat.shape[0]
    _check_dia_layout(mat, plan, dev)
    if m < 1:
        raise ValueError("a matrix without rows")
    lists = (resid.row_ptr, resid.fr_val, resid.fr_col)
    if any(t is None for t in lists) or (resid.fr_lo is not None) != df:
        raise ValueError("the fringe lists are missing or of the other precision: "
                         "build them with with_fringe_lists")
    nf = resid.fr_col.shape[0]
    _require(resid.row_ptr, "resid.row_ptr", (torch.int32,), (m + 1,), dev)
    _require(resid.fr_col, "resid.fr_col", (torch.int32,), (nf,), dev)
    values = (("resid.fr_val", resid.fr_val), ("resid.fr_lo", resid.fr_lo))
    for name, t in values[: 2 if df else 1]:
        _require(t, name, (torch.float32,), (nf,), dev)
    ptr = resid.row_ptr
    first, last, falls = torch.stack([ptr[0], ptr[-1], (ptr[1:] < ptr[:-1]).sum().int()]).tolist()
    if (first, last, falls) != (0, nf, 0):
        raise ValueError(f"row_ptr runs {first} .. {last} over {nf} entries, {falls} decreasing")


def _resid_plan(resid: DiaResid, plan: DiaPlan, dev) -> int:
    """The layout's threads per row on CUDA device dev, its tensors checked
    once and the result kept on resid while they are the same objects."""
    mat = resid.mat

    def make():
        _check_resid_layout(resid, plan, dev)
        return launch_groups(mat.shape[0], len(mat.offsets))

    tensors = (mat.data, getattr(mat, "data_lo", None), mat.offsets_dev, resid.row_ptr,
               resid.fr_val, resid.fr_lo, resid.fr_col)
    return cuda_lib.kept_plan(resid, tensors, (dev, mat.shape, plan), make)


def _check_rows_layout(mat, plan: DiaPlan, dev) -> None:
    """What the DIA rows kernels read, checked at a layout's first launch:
    the layout, 1 .. s_pad*128 rows, and each slab plane 16-byte aligned (a
    thread's four rows of a diagonal are one vector load). No device sync:
    the solvers' first launch may come just before a CUDA graph capture."""
    _check_dia_layout(mat, plan, dev)
    m = mat.shape[0]
    if not 1 <= m <= plan.s_pad * LANE:
        raise ValueError(f"{m} rows over a slab of {plan.s_pad * LANE}")
    for name, t in _planes(mat):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _rows_plan(mat, plan: DiaPlan, dev) -> int:
    """Rows a thread of the DIA rows kernels for mat on CUDA device dev, its
    layout checked at the first launch and the result kept on mat while its
    tensors are the same objects."""

    def make():
        _check_rows_layout(mat, plan, dev)
        return rows_a_thread(mat.shape[0])

    tensors = (mat.data, getattr(mat, "data_lo", None), mat.offsets_dev)
    return cuda_lib.kept_plan(mat, tensors, (dev, mat.shape, len(mat.offsets), plan), make)


def dia_resid_spmv_cuda(resid: DiaResid, x: torch.Tensor, plan: DiaPlan) -> torch.Tensor:
    """y = A @ x (f32, length m) of a DIA+residual hybrid: the diagonals of
    resid.mat, then the fringe sums.

    CUDA tensors launch dia_resid_kernel (one launch, band and fringe
    together; the layout checked at its first launch); CPU tensors take
    dia_spmv_reference. Anything else raises."""
    dev = x.device
    mat = resid.mat
    if dev.type == "cpu":
        _check_dia(mat, x, plan)
        _check_resid(resid, plan, dev)
        return dia_spmv_reference(mat, x, plan, resid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if isinstance(mat, DeviceDIADF):
        raise TypeError("a DeviceDIADF runs through dia_resid_spmv_df_cuda (float64)")
    groups = _resid_plan(resid, plan, dev)
    m, n = mat.shape
    _check_x(x, torch.float32, n)
    y = torch.empty(m, dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.dia_resid_launch(
        int(mat.data.dtype == torch.bfloat16), mat.data.data_ptr(), mat.offsets_dev.data_ptr(),
        len(mat.offsets), plan.s_pad * LANE, m, resid.row_ptr.data_ptr(),
        resid.fr_val.data_ptr(), resid.fr_col.data_ptr(), x.data_ptr(), n, y.data_ptr(), groups,
        cuda_lib.current_stream(dev),
    )
    _check_launch(lib, rc, "dia_resid_kernel")
    dia_resid_spmv_cuda.launches += 1
    return y


dia_resid_spmv_cuda.launches = 0


def dia_spmv_cuda(mat: DeviceDIA, x: torch.Tensor, plan: DiaPlan) -> torch.Tensor:
    """y = A @ x (f32, length m) over a plan-padded DIA slab (a DIA+residual
    hybrid runs through dia_resid_spmv_cuda).

    CUDA tensors launch dia_rows_kernel (one launch that allocates y alone;
    the layout checked at its first launch, x at every call); CPU tensors
    take dia_spmv_reference. Anything else raises."""
    dev = x.device
    if dev.type == "cpu":
        _check_dia(mat, x, plan)
        return dia_spmv_reference(mat, x, plan)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_kind(mat, df=False)
    per_thread = _rows_plan(mat, plan, dev)
    m, n = mat.shape
    _check_x(x, torch.float32, n)
    y = torch.empty(m, dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.dia_spmv_launch(
        int(mat.data.dtype == torch.bfloat16), mat.data.data_ptr(), mat.offsets_dev.data_ptr(),
        len(mat.offsets), plan.s_pad * LANE, m, x.data_ptr(), n, y.data_ptr(), per_thread,
        cuda_lib.current_stream(dev),
    )
    _check_launch(lib, rc, "dia_rows_kernel")
    dia_spmv_cuda.launches += 1
    return y


dia_spmv_cuda.launches = 0


# ---------------------------------------------------------------------------
# Double-float (float64) DIA: plain versions and the csrc/df_spmv.cu wrappers
# ---------------------------------------------------------------------------


def _x_window_plane(xs: torch.Tensor, pad_sub: int, plan: DiaPlan) -> torch.Tensor:
    """One f32 plane of x in the flat window of (nblocks + 2) * bs row
    groups (see _x_window; held to the window's end, never rounded)."""
    xk = torch.zeros((plan.nblocks + 2) * plan.bs * LANE, dtype=torch.float32, device=xs.device)
    base = pad_sub * LANE
    part = xs[: xk.shape[0] - base]
    xk[base : base + part.shape[0]] = part
    return xk


def dia_resid_df_reference(
    resid: DiaResid, xh: torch.Tensor, xl: torch.Tensor, plan: DiaPlan
) -> dfloat.Pair:
    """Fringe sums over all s_pad*LANE rows as an (hi, lo) pair: slot (i, k,
    l) adds (rvals, rvals_lo) * x at window row i*bs + rsrc_row(i, k), lane
    rsidx, into row (i*bs + rgid)*LANE + l; each row's slots are summed by a
    compensated tree over k (the JAX kernel's masked trees)."""
    nb, bs, kp = plan.nblocks, plan.bs, resid.k_pad
    ps = resid.mat.pad_sub
    xkh, xkl = _x_window_plane(xh, ps, plan), _x_window_plane(xl, ps, plan)
    q = resid.rsrc.reshape(nb, resid.n_ktiles, 8, LANE)[:, :, 0, :]
    q = q.reshape(nb, resid.n_ktiles * LANE)[:, :kp].long()
    blk = torch.arange(nb, device=xh.device).reshape(nb, 1, 1)
    src = (blk * bs + q[:, :, None]) * LANE + resid.rsidx.reshape(nb, kp, LANE).long()
    vh, vl = resid.rvals.reshape(nb, kp, LANE), resid.rvals_lo.reshape(nb, kp, LANE)
    gh, gl = xkh[src], xkl[src]
    ph, pe = dfloat.two_prod(vh, gh)
    pl = pe + (vh * gl + vl * gh)
    gid = resid.rgid.reshape(nb, kp, LANE)
    out_h = torch.zeros(nb, bs, LANE, dtype=torch.float32, device=xh.device)
    out_l = torch.zeros_like(out_h)
    zero = torch.zeros((), dtype=torch.float32, device=xh.device)
    for gg in range(bs):
        sel = gid == gg
        out_h[:, gg], out_l[:, gg] = dfloat.df_tree_sum(
            torch.where(sel, ph, zero), torch.where(sel, pl, zero), dim=1
        )
    return out_h.reshape(-1), out_l.reshape(-1)


def resid_lists_df_reference(resid: DiaResid, xh: torch.Tensor, xl: torch.Tensor) -> dfloat.Pair:
    """The fringe sums of rows 0..m-1 as an (hi, lo) pair over the per-row
    lists, in the kernel's order: each row's df products TwoSum-added one
    by one in list order, from (0, 0)."""
    cols = resid.fr_col.long()
    gh, gl = _x_gather(xh, cols), _x_gather(xl, cols)
    vh, vl = resid.fr_val, resid.fr_lo
    ph, pe = dfloat.two_prod(vh, gh)
    pl = pe + (vh * gl + vl * gh)
    out_h = torch.zeros(resid.row_ptr.shape[0] - 1, dtype=torch.float32, device=xh.device)
    out_l = torch.zeros_like(out_h)
    for rows, ent in _list_rounds(resid):
        out_h[rows], out_l[rows] = dfloat.df_add(out_h[rows], out_l[rows], ph[ent], pl[ent])
    return out_h, out_l


def dia_spmv_df_pair_reference(
    mat: DeviceDIADF, xh: torch.Tensor, xl: torch.Tensor, plan: DiaPlan,
    resid: Optional[DiaResid] = None,
) -> dfloat.Pair:
    """(hi, lo) over all s_pad*LANE rows: df_mul_acc over the diagonals in
    ascending offset order, then the fringe sums df-added."""
    d, s, _ = mat.data.shape
    rows = s * LANE
    xkh = _x_window_plane(xh, mat.pad_sub, plan)
    xkl = _x_window_plane(xl, mat.pad_sub, plan)
    hi, lo = mat.data.reshape(d, rows), mat.data_lo.reshape(d, rows)
    base = mat.pad_sub * LANE
    acc_h = torch.zeros(rows, dtype=torch.float32, device=xh.device)
    acc_l = torch.zeros_like(acc_h)
    for k, off in enumerate(mat.offsets):
        sl = slice(base + off, base + off + rows)
        acc_h, acc_l = dfloat.df_mul_acc(acc_h, acc_l, hi[k], lo[k], xkh[sl], xkl[sl])
    if resid is not None:
        acc_h, acc_l = dfloat.df_add(acc_h, acc_l, *dia_resid_df_reference(resid, xh, xl, plan))
    return acc_h, acc_l


def dia_spmv_df_reference(
    mat: DeviceDIADF, x: torch.Tensor, plan: DiaPlan, resid: Optional[DiaResid] = None
) -> torch.Tensor:
    """Plain PyTorch y = A @ x (f64, length m) with the semantics of the JAX
    package's dia_spmv_pallas_df: x split into (hi, lo), the pair summed as
    dia_spmv_df_pair_reference, one f64 combine (x is read to the window's
    end, as in dia_spmv_reference)."""
    xh, xl = dfloat.split_f64_t(x)
    yh, yl = dia_spmv_df_pair_reference(mat, xh, xl, plan, resid)
    m = mat.shape[0]
    return dfloat.df_combine64(yh[:m], yl[:m])


def dia_resid_spmv_df_cuda(resid: DiaResid, x: torch.Tensor, plan: DiaPlan) -> torch.Tensor:
    """y = A @ x in double-float (f64 in and out, length m) of a df
    DIA+residual hybrid: the diagonals of resid.mat, then the fringe sums.

    CUDA tensors launch dia_resid_df_kernel (one launch: x split and y
    combined in the kernel; the layout checked at its first launch); CPU
    tensors take dia_spmv_df_reference. Anything else raises."""
    dev = x.device
    mat = resid.mat
    if dev.type == "cpu":
        _check_dia(mat, x, plan, df=True)
        _check_resid(resid, plan, dev)
        return dia_spmv_df_reference(mat, x, plan, resid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_kind(mat, df=True)
    groups = _resid_plan(resid, plan, dev)
    m, n = mat.shape
    _check_x(x, torch.float64, n)
    y = torch.empty(m, dtype=torch.float64, device=dev)
    rc = dfloat.df_lib().dia_resid_df_launch(
        mat.data.data_ptr(), mat.data_lo.data_ptr(), mat.offsets_dev.data_ptr(), len(mat.offsets),
        plan.s_pad * LANE, m, resid.row_ptr.data_ptr(), resid.fr_val.data_ptr(),
        resid.fr_lo.data_ptr(), resid.fr_col.data_ptr(), x.data_ptr(), n, y.data_ptr(), groups,
        cuda_lib.current_stream(dev),
    )
    dfloat.check_launch(rc, "dia_resid_df_kernel")
    dia_resid_spmv_df_cuda.launches += 1
    return y


dia_resid_spmv_df_cuda.launches = 0


def dia_spmv_df_cuda(mat: DeviceDIADF, x: torch.Tensor, plan: DiaPlan) -> torch.Tensor:
    """y = A @ x in double-float (f64 in and out, length m) over a
    plan-padded DeviceDIADF (a df DIA+residual hybrid runs through
    dia_resid_spmv_df_cuda).

    CUDA tensors launch dia_df_kernel (one launch that allocates y alone:
    x split and y combined in the kernel; the layout checked at its first
    launch, x at every call); CPU tensors take dia_spmv_df_reference.
    Anything else raises."""
    dev = x.device
    if dev.type == "cpu":
        _check_dia(mat, x, plan, df=True)
        return dia_spmv_df_reference(mat, x, plan)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_kind(mat, df=True)
    per_thread = _rows_plan(mat, plan, dev)
    m, n = mat.shape
    _check_x(x, torch.float64, n)
    y = torch.empty(m, dtype=torch.float64, device=dev)
    rc = dfloat.df_lib().dia_df_launch(
        mat.data.data_ptr(), mat.data_lo.data_ptr(), mat.offsets_dev.data_ptr(), len(mat.offsets),
        plan.s_pad * LANE, m, x.data_ptr(), n, y.data_ptr(), per_thread,
        cuda_lib.current_stream(dev),
    )
    dfloat.check_launch(rc, "dia_df_kernel")
    dia_spmv_df_cuda.launches += 1
    return y


dia_spmv_df_cuda.launches = 0


# ---------------------------------------------------------------------------
# Prepared state from the JAX package
# ---------------------------------------------------------------------------


def _to_tensor(a, device) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16, bit for bit) or a tensor (a file's
    bfloat16 leaf, formats/serialize.py) -> tensor on device."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().to(device)
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
    data_lo=None,
    rvals_lo=None,
    device="cuda",
) -> Tuple[DeviceDIA, DiaPlan, Optional[DiaResid]]:
    """The port's (DeviceDIA, plan, DiaResid or None) from the JAX package's
    prepared DIA operands, given as numpy arrays and their static fields
    (DeviceDIA data/offsets/shape/nnz/pad_sub, DiaPallasPlan bs/nblocks/
    s_pad, and for the hybrid DiaResid rvals/rsidx/rgid/rsrc/k_pad/
    nnz_resid). The double-float operands (DeviceDIADF's data_lo, DiaResid's
    rvals_lo) give a DeviceDIADF core. Validates what the kernels index
    with. On `device` (the card unless the caller passes device="cpu")."""
    device = target_device(device)
    plan = DiaPlan(bs=int(bs), nblocks=int(nblocks), s_pad=int(s_pad))
    offsets = [int(o) for o in offsets]
    if offsets and max(abs(o) for o in offsets) > pad_sub * LANE:
        raise ValueError("an offset exceeds the pad_sub reach")
    if data_lo is None:
        mat = make_device_dia(_to_tensor(data, device), offsets, shape, nnz, pad_sub)
    else:
        mat = make_device_dia_df(
            _to_tensor(data, device), _to_tensor(data_lo, device), offsets, shape, nnz, pad_sub
        )
        if mat.data_lo.shape != mat.data.shape:
            raise ValueError("data_lo must have the shape of data")
    if (rvals_lo is None) != (data_lo is None or rvals is None):
        raise ValueError("a double-float hybrid carries both data_lo and rvals_lo")
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
        rvals_lo=None if rvals_lo is None else _to_tensor(rvals_lo, device),
    )
    _check_resid(resid, plan, mat.data.device)
    return mat, plan, with_fringe_lists(resid, plan)


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
        return dia_resid_spmv_cuda(ops[0], x, ops[1])

    register(
        KernelSpec(
            name="PL_DIA_ROWS",
            fmt="csr",
            impl="cuda",
            prepare=_mk_prep_dia(),
            run=_run_dia,
            doc="CUDA diagonal kernel: four rows a thread (one on small "
            "matrices), 16-byte slab loads streamed past L1, x through the "
            "read-only path, offsets from a device array",
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
            doc="DIA + residual hybrid: dense-offset diagonals and the "
            "scattered fringe in one CUDA kernel (a row's diagonals split "
            "over up to 16 threads, the fringe as per-row lists; no atomics)",
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

    def _run_resid_df(ops, x):
        return dia_resid_spmv_df_cuda(ops[0], x, ops[1])

    register(
        KernelSpec(
            name="PL_DIA_RESID_F64",
            fmt="csr",
            impl="cuda",
            prepare=lambda csr, ell, cfg, device: prepare_dia_resid(csr, df=True, device=device),
            run=_run_resid_df,
            doc="double-precision DIA + residual hybrid: double-float diagonal "
            "core and df fringe lists (TwoProduct, TwoSum into owned rows) in "
            "one CUDA kernel, f64 x split and f64 y combined in it",
            f64=True,
        )
    )
    register(
        KernelSpec(
            name="PL_DIA_F64",
            fmt="csr",
            impl="cuda",
            prepare=lambda csr, ell, cfg, device: prepare_dia_df_pallas(csr, device=device),
            run=lambda ops, x: dia_spmv_df_cuda(ops[0], x, ops[1]),
            doc="double-precision DIA: slabs and x as (hi, lo) double-float "
            "pairs, an error-compensated CUDA diagonal kernel (Dekker "
            "TwoProduct + Knuth TwoSum), f64 x split and f64 y combined in "
            "the one launch",
            f64=True,
        )
    )


_register()
