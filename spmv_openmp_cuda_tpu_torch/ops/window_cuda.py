"""CUDA kernels for the windowed local-gather engine (PL_CSR_WINDOW).

Counterpart of the kernel half of spmv_openmp_cuda_tpu/formats/window.py
(window_kernel_call, _window_single_call, window_spmv) and of its registry
hooks in spmv_openmp_cuda_tpu/ops/spmv_pallas.py. It holds the wrappers of the
hand-written CUDA kernels in csrc/window_spmv.cu (f32/bf16 values) and of
the double-float one in csrc/df_spmv.cu (float64, window_df_kernel), their
plain PyTorch versions, their launch plan (launch_plan: CTAs per block,
slot rows per CTA, staged x rows, shared memory), the conversion of the JAX
package's prepared layout, and the registry hooks of PL_CSR_WINDOW,
PL_CSR_WINDOW_BF16 and PL_CSR_WINDOW_F64.

The wrapper launches the kernels for CUDA tensors and raises on anything it
does not take; it runs the plain version only for tensors on the CPU. A
product is one launch in every dtype. The layout's tensors are checked and
its plan computed at its first launch and kept on the layout while its
fields stay the same objects; x and y are checked at every call.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import LANE
from ..formats.matrix import target_device
from ..formats.window import WindowCSR
from . import cuda_lib, dfloat
from .spmv_cuda import _require, _to_tensor

_SLAB_DTYPES = (torch.float32, torch.bfloat16)


def _x_base(mat: WindowCSR, blk: torch.Tensor) -> torch.Tensor:
    """x chunk held by window row 0 of each block, as the TPU kernels stage
    x: 8*floor(i*g/8) - wr (standard), (i - i%bps)*g - wr (shared_w), 0
    (xdirect)."""
    if mat.xdirect:
        return torch.zeros_like(blk)
    if mat.shared_w:
        return (blk - blk % mat.bps) * mat.g - mat.wr
    return 8 * (blk * mat.g // 8) - mat.wr


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernels (the CPU path and the chip's check)
# ---------------------------------------------------------------------------


def window_spmv_reference(mat: WindowCSR, x: torch.Tensor, x_lo: int = 0) -> torch.Tensor:
    """Plain PyTorch y = A @ x (f32, length m) over a prepared window layout,
    with the semantics of the JAX package's window_spmv: slot (i, k, l) adds
    vals * x[(x_base(i) + Q)*128 + sidx] (x is 0 outside [x_lo, n) and is not
    rounded; vals are upcast to f32) into row (i*g + r)*128 + l, r = 8*gid +
    k%8 below k_c and gid above; sums over g_pad rows per block, then drops
    the rows past g and past m. x holds columns x_lo .. n - 1 (x_lo <= 0: a
    row shard's left halo, parallel/sharded.py; see _launch_f32)."""
    m = mat.shape[0]
    nb, kp, g = mat.nblocks, mat.k_pad, mat.g
    g_pad = -(-g // 8) * 8
    dev = x.device
    blk = torch.arange(nb, device=dev).reshape(nb, 1, 1)
    k = torch.arange(kp, device=dev).reshape(1, kp, 1)
    lane = torch.arange(LANE, device=dev).reshape(1, 1, LANE)
    (xv,) = _slot_x(mat, (x,), dev, x_lo)
    prod = mat.vals.reshape(nb, kp, LANE).to(torch.float32) * xv
    gd = mat.gid.reshape(nb, kp, LANE).long()
    r = torch.where(k < mat.k_c, 8 * gd + k % 8, gd)
    dst = (blk * g_pad + r) * LANE + lane
    out = torch.zeros(nb * g_pad * LANE, dtype=torch.float32, device=dev)
    out.index_add_(0, dst.reshape(-1), prod.reshape(-1))
    return out.reshape(nb, g_pad, LANE)[:, :g].reshape(-1)[:m]


def _slot_x(mat: WindowCSR, planes, dev, x_lo: int = 0):
    """The x value(s) each slot reads, (nb, k_pad, 128) per plane: x at
    (x_base(i) + Q)*128 + sidx, 0 outside [x_lo, n); element 0 of a plane
    is column x_lo."""
    n = mat.shape[1]
    nb, kp, nkt = mat.nblocks, mat.k_pad, mat.n_ktiles
    blk = torch.arange(nb, device=dev).reshape(nb, 1, 1)
    k = torch.arange(kp, device=dev).reshape(1, kp, 1)
    res = mat.sidx.reshape(nb, kp, LANE).long()
    qidx = ((blk * nkt + k // LANE) * LANE + res) * LANE + k % LANE
    q = mat.rsrc.reshape(-1)[qidx].long()
    col = (_x_base(mat, blk) + q) * LANE + res
    inside = (col >= x_lo) & (col < n)
    col = (col - x_lo).clamp(0, max(n - x_lo - 1, 0))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return [torch.where(inside, p[col], zero) for p in planes]


def window_spmv_df_pair_reference(
    mat: WindowCSR, xh: torch.Tensor, xl: torch.Tensor
) -> dfloat.Pair:
    """(hi, lo) of y (length m) over a double-float layout, with the JAX
    package's df window kernel's order: df products of the slots, then per
    block the mod-8 folded rows (row 8h + k%8 of slot rows k < k_c with gid
    h) as compensated trees over the 8-row chunks, and the overflow rows
    (k >= k_c, row gid) as trees over 8-row chunks and then the 8 rows,
    df-added to them."""
    m = mat.shape[0]
    nb, kp, g, kc = mat.nblocks, mat.k_pad, mat.g, mat.k_c
    g_pad = -(-g // 8) * 8
    dev = xh.device
    gh, gl = _slot_x(mat, (xh, xl), dev)
    vh = mat.vals.reshape(nb, kp, LANE)
    vl = mat.vals_lo.reshape(nb, kp, LANE)
    ph, pe = dfloat.two_prod(vh, gh)
    pl = pe + (vh * gl + vl * gh)
    gd = mat.gid.reshape(nb, kp, LANE).long()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out_h = torch.zeros(nb, g_pad, LANE, dtype=torch.float32, device=dev)
    out_l = torch.zeros_like(out_h)
    if kc:
        shape8 = (nb, kc // 8, 8, LANE)
        ch, cl, cg = ph[:, :kc].reshape(shape8), pl[:, :kc].reshape(shape8), gd[:, :kc].reshape(shape8)
        for h in range(g_pad // 8):
            sel = cg == h
            out_h[:, 8 * h : 8 * h + 8], out_l[:, 8 * h : 8 * h + 8] = dfloat.df_tree_sum(
                torch.where(sel, ch, zero), torch.where(sel, cl, zero), dim=1
            )
    if kp > kc:
        shape8 = (nb, (kp - kc) // 8, 8, LANE)
        vh8, vl8, vg = ph[:, kc:].reshape(shape8), pl[:, kc:].reshape(shape8), gd[:, kc:].reshape(shape8)
        for gg in range(g):
            sel = vg == gg
            t8 = dfloat.df_tree_sum(torch.where(sel, vh8, zero), torch.where(sel, vl8, zero), dim=1)
            rh, rl = dfloat.df_tree_sum(*t8, dim=1)
            out_h[:, gg], out_l[:, gg] = dfloat.df_add(out_h[:, gg], out_l[:, gg], rh, rl)
    return (out_h[:, :g].reshape(-1)[:m], out_l[:, :g].reshape(-1)[:m])


def window_spmv_df_reference(mat: WindowCSR, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A @ x (f64, length m) over a double-float layout:
    x split into (hi, lo), window_spmv_df_pair_reference, one f64 combine
    (the JAX package's window_spmv on a df layout)."""
    return dfloat.df_combine64(*window_spmv_df_pair_reference(mat, *dfloat.split_f64_t(x)))


# ---------------------------------------------------------------------------
# The kernels' launch plan
# ---------------------------------------------------------------------------


#: H100 SXM: streaming multiprocessors, the shared memory of one SM and
#: the most one CTA may use (bytes), and what the card reserves per CTA
SMS = 132
SM_SMEM = 233_472
CTA_SMEM_MAX = 232_448
CTA_SMEM_RESERVED = 1024
#: csrc/window_tile.cuh: threads per CTA (warp j takes the slot rows k % 8
#: == j), slot rows per staged Q chunk and its bytes per residue, the
#: largest (portable) cluster
THREADS = 256
Q_ROWS, Q_PITCH = 64, 68
MAX_CLUSTER = 8
#: value kind -> (bytes per staged x element, per tile accumulator, of one
#: thread's values per slot row, the cp.async ring depths the kernel takes
#: (deepest first), CTAs per SM its __launch_bounds__ leave registers for)
_KINDS = {"f32": (4, 4, 16, (8,), 2), "bf16": (4, 4, 8, (8,), 2), "df": (8, 8, 32, (4, 2, 1), 2)}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How csrc/window_spmv.cu (f32, bf16) and df_spmv.cu (df) run a layout:
    `cluster` CTAs per block (1, or a thread-block cluster of 2, 4 or 8) of
    THREADS threads, CTA rank summing the slot rows from rank_start(rank,
    step, ...) on (cost `step` each); `win_rows` x rows staged in shared
    memory; a cp.async ring of `depth` slot rows per thread; `smem` bytes of
    dynamic shared memory per CTA."""

    cluster: int
    step: int
    win_rows: int
    depth: int
    smem: int
    threads: int = THREADS


#: csrc/window_tile.cuh: what an overflow slot row costs a warp, in eighths
#: of a slot row (a warp adds one mod-8 row in eight, and a quarter of the
#: lanes of every overflow row)
OVERFLOW_COST = 4


def rank_start(rank: int, step: int, k_c: int, k_pad: int) -> int:
    """First slot row of CTA `rank` of a cluster (window_tile.cuh's
    rank_start): the block's slot rows split in ranges of equal cost to a
    warp, each starting at a multiple of 8."""
    u = rank * step
    k = u if u <= k_c else k_c + (u - k_c) // OVERFLOW_COST
    return min(-(-k // 8) * 8, k_pad)


def rank_ranges(plan: LaunchPlan, k_pad: int, k_c: int):
    """[(k0, k1)] of the plan's CTAs of one block."""
    starts = [rank_start(r, plan.step, k_c, k_pad) for r in range(plan.cluster)]
    return list(zip(starts, starts[1:] + [k_pad]))


def window_rows(mat: WindowCSR) -> int:
    """x rows (chunks of 128) of a block's window, as the TPU kernels stage
    them: 8*nspecs, 8*ns_tot for shared_w (the union window of bps blocks),
    the chunks of x for xdirect; at most 128 (formats/window.py caps the
    window there)."""
    if mat.xdirect:
        rows = -(-mat.shape[1] // LANE)
    elif mat.shared_w:
        rows = 8 * ((mat.bps - 1) * (mat.g // 8) + mat.nspecs)
    else:
        rows = 8 * mat.nspecs
    return max(1, min(rows, LANE))


def smem_bytes(g: int, win_rows: int, kind: str, depth: int) -> int:
    """Dynamic shared memory of one CTA (csrc/window_tile.cuh's
    window_smem_bytes): the x window, the (g_pad, 128) tile, the Q chunk,
    the ring and the mbarrier."""
    xb, ab, vb, _, _ = _KINDS[kind]
    g_pad = -(-g // 8) * 8
    return (win_rows * LANE * xb + g_pad * LANE * ab + LANE * Q_PITCH
            + depth * THREADS * (vb + 8) + 16)


def launch_plan(nblocks: int, k_pad: int, k_c: int, g: int, win_rows: int, kind: str,
                sms: int = SMS) -> LaunchPlan:
    """For each ring depth that fits a CTA: one CTA per block while the
    blocks fill the card, else each block's slot rows split over a cluster
    of 2, 4 or 8 CTAs, doubled while twice the CTAs would still all be
    resident at once and each keeps >= 16 slot rows. The depth whose grid
    takes the fewest waves of resident CTAs wins, the deeper one on a tie
    (thermal2_like's double-float product: a ring of 1 leaves room for two
    CTAs per SM, 2 waves where a ring of 4 takes 4). Raises ValueError if no
    ring fits the shared memory a CTA may use."""
    depths, per_sm_regs = _KINDS[kind][3], _KINDS[kind][4]
    cost = k_c + OVERFLOW_COST * (k_pad - k_c)
    best = None
    for depth in depths:
        smem = smem_bytes(g, win_rows, kind, depth)
        if smem > CTA_SMEM_MAX:
            continue
        resident = sms * min(per_sm_regs, SM_SMEM // (smem + CTA_SMEM_RESERVED))
        cluster = 1
        while (cluster < MAX_CLUSTER and nblocks * 2 * cluster <= resident
               and -(-k_pad // (2 * cluster)) >= 16):
            cluster *= 2
        waves = -(-nblocks * cluster // resident)
        if best is None or waves < best[0]:
            best = (waves, LaunchPlan(cluster=cluster, step=-(-cost // cluster),
                                      win_rows=win_rows, depth=depth, smem=smem))
    if best is None:
        raise ValueError(f"a window CTA needs {smem_bytes(g, win_rows, kind, depths[-1])} bytes "
                         f"of shared memory (> {CTA_SMEM_MAX})")
    return best[1]


# ---------------------------------------------------------------------------
# CUDA kernel wrappers (csrc/window_spmv.cu, csrc/df_spmv.cu)
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.window_launch.argtypes = [
        i, p, p, p, p, i, i, i, i, i, i, i, p, ll, ll, ll, p, i, i, i, i, i, p,
    ]
    lib.window_launch.restype = i
    lib.window_error_string.argtypes = [i]
    lib.window_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return cuda_lib.load("window_spmv", _bind)


def _check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.window_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _check_window(mat: WindowCSR, x: torch.Tensor, x_lo: int = 0) -> None:
    """What the kernels index with: geometry, then every tensor's device,
    dtype, shape and contiguity (a df layout: two f32 value planes and an
    f64 x; x holds columns x_lo .. n - 1)."""
    _check_layout(mat, x.device)
    _check_x_lo(x_lo)
    _require(x, "x", (torch.float64 if mat.vals_lo is not None else torch.float32,),
             (mat.shape[1] - x_lo,), x.device)


def _check_x_lo(x_lo: int) -> None:
    if x_lo > 0 or x_lo % LANE:
        raise ValueError(f"x_lo {x_lo} must be <= 0 and a multiple of {LANE}")


def _check_layout(mat: WindowCSR, dev) -> None:
    m, n = mat.shape
    g, kp = mat.g, mat.k_pad
    if not (2 <= g <= 64 and 0 <= mat.k_c <= kp and mat.k_c % 8 == 0 and kp > 0 and kp % 8 == 0):
        raise ValueError(f"bad window geometry g={g} k_c={mat.k_c} k_pad={kp}")
    if mat.nblocks < 1 or mat.nblocks * g * LANE < m:
        raise ValueError(f"{mat.nblocks} blocks of {g}x128 rows do not cover {m} rows")
    if mat.xdirect and (mat.nblocks != 1 or -(-n // LANE) > LANE):
        raise ValueError("an xdirect layout has one block and x of <= 128 chunk-rows")
    if mat.shared_w and (mat.bps < 2 or g % 8):
        raise ValueError("a shared_w layout needs bps > 1 and g % 8 == 0")
    rows = (mat.nblocks * kp, LANE)
    df = mat.vals_lo is not None
    _require(mat.vals, "mat.vals", (torch.float32,) if df else _SLAB_DTYPES, rows, dev)
    if df:
        _require(mat.vals_lo, "mat.vals_lo", (torch.float32,), rows, dev)
    _require(mat.sidx, "mat.sidx", (torch.int8,), rows, dev)
    _require(mat.gid, "mat.gid", (torch.int8,), rows, dev)
    _require(mat.rsrc, "mat.rsrc", (torch.int8,), (mat.nblocks * mat.n_ktiles * LANE, LANE), dev)
    for name, t in (("mat.vals", mat.vals), ("mat.vals_lo", mat.vals_lo), ("mat.rsrc", mat.rsrc),
                    ("mat.sidx", mat.sidx), ("mat.gid", mat.gid)):
        if dev.type == "cuda" and t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels read it in vectors)")


def _plan(mat: WindowCSR, dev, plan_blocks: Optional[int] = None) -> LaunchPlan:
    """The layout's launch plan on CUDA device dev, its tensors checked once
    and the plan kept on mat while its fields are the same objects.
    plan_blocks (default mat.nblocks) is the block count the plan is made
    for: a row shard of a layout takes the whole layout's, so that each
    block adds in the same order and the shards' y are the unsharded
    product's bit for bit (parallel/sharded.py)."""
    plan_blocks = mat.nblocks if plan_blocks is None else plan_blocks
    tensors = (mat.vals, mat.vals_lo, mat.sidx, mat.gid, mat.rsrc)
    geometry = (dev, mat.shape, mat.g, mat.k_pad, mat.k_c, mat.wr, mat.nspecs, mat.nblocks,
                mat.bps, mat.xdirect, mat.shared_w, plan_blocks)

    def make():
        _check_layout(mat, dev)
        kind = ("df" if mat.vals_lo is not None
                else "bf16" if mat.vals.dtype == torch.bfloat16 else "f32")
        win_rows = window_rows(mat)
        # the kernels read every Q from the staged x rows (one sync, here only)
        lo, hi = torch.aminmax(mat.rsrc)
        if int(lo) < 0 or int(hi) >= win_rows:
            raise ValueError(f"mat.rsrc holds window rows outside [0, {win_rows})")
        return launch_plan(plan_blocks, mat.k_pad, mat.k_c, mat.g, win_rows, kind,
                           torch.cuda.get_device_properties(dev).multi_processor_count)

    return cuda_lib.kept_plan(mat, tensors, geometry, make)


def _check_io(t: torch.Tensor, name: str, dtype, size: int, dev) -> None:
    _require(t, name, (dtype,), (size,), dev)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernels move it in 16-byte copies)")


def _launch_f32(mat: WindowCSR, x: torch.Tensor, y: torch.Tensor, xdirect: bool,
                x_lo: int = 0, plan_blocks: Optional[int] = None) -> None:
    """One launch into y. x holds columns x_lo .. n - 1: the kernel gets a
    pointer to column 0, inside x, and reads [x_lo, n), zero outside (x_lo =
    -wr*128 for a row shard and its left halo, 0 otherwise)."""
    if mat.vals_lo is not None:
        raise TypeError("a double-float layout runs through window_df_cuda")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {x.device}")
    if mat.xdirect != xdirect:
        raise ValueError(
            f"window_{'single' if mat.xdirect else 'blocks'}_cuda runs this layout "
            f"(xdirect={mat.xdirect})"
        )
    m, n = mat.shape
    dev = x.device
    plan = _plan(mat, dev, plan_blocks)
    _check_x_lo(x_lo)
    _check_io(x, "x", torch.float32, n - x_lo, dev)
    _check_io(y, "y", torch.float32, m, dev)
    lib = _lib()
    rc = lib.window_launch(
        int(mat.vals.dtype == torch.bfloat16), mat.vals.data_ptr(), mat.sidx.data_ptr(),
        mat.gid.data_ptr(), mat.rsrc.data_ptr(), mat.nblocks, mat.g, mat.k_pad, mat.k_c, mat.wr,
        mat.bps, _xmode(mat), x.data_ptr() - x_lo * x.element_size(), x_lo, n, m, y.data_ptr(),
        plan.cluster, plan.step, plan.win_rows, plan.depth, plan.smem,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_launch(lib, rc, f"window_{'single' if xdirect else 'blocks'}_kernel")


def _xmode(mat: WindowCSR) -> int:
    """The kernels' x form: 0 standard, 1 xdirect, 2 shared_w."""
    return 1 if mat.xdirect else 2 if mat.shared_w else 0


def window_blocks_cuda(mat: WindowCSR, x: torch.Tensor, y: torch.Tensor,
                       x_lo: int = 0, plan_blocks: Optional[int] = None) -> torch.Tensor:
    """y = A @ x over a multi-block (standard or shared_w) layout, into the
    f32 y of length m: one launch of window_blocks_kernel (a CTA, or a
    thread-block cluster, per block; launch_plan). Overwrites every element
    of y. x holds columns x_lo .. n - 1 (x_lo < 0: a row shard's halo'd x,
    parallel/sharded.py); plan_blocks: see _plan."""
    _launch_f32(mat, x, y, xdirect=False, x_lo=x_lo, plan_blocks=plan_blocks)
    window_blocks_cuda.launches += 1
    return y


window_blocks_cuda.launches = 0


def window_single_cuda(mat: WindowCSR, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the single-block xdirect layout, into the f32 y of
    length m: one launch of window_single_kernel (its slot rows split over a
    thread-block cluster; launch_plan). Overwrites every element of y."""
    _launch_f32(mat, x, y, xdirect=True)
    window_single_cuda.launches += 1
    return y


window_single_cuda.launches = 0


def window_df_cuda(mat: WindowCSR, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y (f64, length m) = A @ x (x f64) over a double-float layout of any x
    form: one launch of window_df_kernel, which splits x into (hi, lo) pairs
    and combines y as hi + lo itself. Overwrites every element of y."""
    if mat.vals_lo is None:
        raise TypeError("window_df_cuda runs a double-float layout (vals_lo set)")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {dev}")
    m, n = mat.shape
    plan = _plan(mat, dev)
    _check_io(x, "x", torch.float64, n, dev)
    _check_io(y, "y", torch.float64, m, dev)
    rc = dfloat.df_lib().window_df_launch(
        mat.vals.data_ptr(), mat.vals_lo.data_ptr(), mat.sidx.data_ptr(), mat.gid.data_ptr(),
        mat.rsrc.data_ptr(), mat.nblocks, mat.g, mat.k_pad, mat.k_c, mat.wr, mat.bps,
        _xmode(mat), x.data_ptr(), n, m, y.data_ptr(), plan.cluster, plan.step, plan.win_rows,
        plan.depth, plan.smem, torch.cuda.current_stream(dev).cuda_stream,
    )
    dfloat.check_launch(rc, "window_df_kernel")
    window_df_cuda.launches += 1
    return y


window_df_cuda.launches = 0


def window_spmv(mat: WindowCSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (length m) over a prepared window layout: f32, or f64 for
    a double-float layout (vals_lo set, x f64).

    CUDA tensors launch window_single_kernel (xdirect layouts) or
    window_blocks_kernel (the others), or window_df_kernel for a df layout:
    one launch each; CPU tensors take window_spmv_reference or
    window_spmv_df_reference. Anything else raises."""
    df = mat.vals_lo is not None
    if x.device.type == "cpu":
        _check_window(mat, x)
        return window_spmv_df_reference(mat, x) if df else window_spmv_reference(mat, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if df:
        return window_df_cuda(mat, x, torch.empty(mat.shape[0], dtype=torch.float64, device=x.device))
    y = torch.empty(mat.shape[0], dtype=torch.float32, device=x.device)
    launch = window_single_cuda if mat.xdirect else window_blocks_cuda
    return launch(mat, x, y)


# ---------------------------------------------------------------------------
# Prepared state from the JAX package
# ---------------------------------------------------------------------------


def window_from_jax(
    vals, sidx, gid, rsrc, shape, nnz: int, g: int, k_pad: int, wr: int,
    nspecs: int, nblocks: int, k_c: int, bps: int, xdirect: bool,
    shared_w: bool, vals_lo=None, device="cuda",
) -> WindowCSR:
    """The port's WindowCSR from the JAX package's prepared WindowCSR, given
    as numpy arrays (bf16 bit for bit) and its static fields, on `device`
    (the card unless the caller passes device="cpu"); vals_lo (the
    double-float mode's lo words) gives a df layout. Validates the index
    ranges the kernels read with."""
    device = target_device(device)
    sidx_np, gid_np, rsrc_np = (np.asarray(a) for a in (sidx, gid, rsrc))
    if sidx_np.min(initial=0) < 0 or rsrc_np.min(initial=0) < 0:
        raise ValueError("sidx/rsrc out of range")  # int8: max is < 128
    nh = -(-int(g) // 8)
    gs = gid_np.reshape(int(nblocks), int(k_pad), LANE)
    if gs.min(initial=0) < 0 or gs[:, : int(k_c)].max(initial=0) >= nh or \
            gs[:, int(k_c):].max(initial=0) >= g:
        raise ValueError("gid out of range")
    mat = WindowCSR(
        vals=_to_tensor(vals, device),
        sidx=_to_tensor(sidx_np, device),
        gid=_to_tensor(gid_np, device),
        rsrc=_to_tensor(rsrc_np, device),
        shape=tuple(int(d) for d in shape),
        nnz=int(nnz),
        g=int(g),
        k_pad=int(k_pad),
        wr=int(wr),
        nspecs=int(nspecs),
        nblocks=int(nblocks),
        k_c=int(k_c),
        bps=int(bps),
        xdirect=bool(xdirect),
        shared_w=bool(shared_w),
        vals_lo=None if vals_lo is None else _to_tensor(vals_lo, device),
    )
    x_dtype = torch.float32 if vals_lo is None else torch.float64
    _check_window(mat, torch.zeros(mat.shape[1], dtype=x_dtype, device=device))
    return mat


# ---------------------------------------------------------------------------
# registry hook (imported by ops.registry)
# ---------------------------------------------------------------------------


def _register() -> None:
    from ..formats.window import prepare_window_auto
    from .registry import KernelSpec, register

    register(
        KernelSpec(
            name="PL_CSR_WINDOW",
            fmt="csr",
            impl="cuda",
            prepare=lambda csr, ell, cfg, device: prepare_window_auto(
                csr, dtype=cfg.torch_dtype, device=device
            ),
            run=window_spmv,
            doc="windowed local-gather engine for banded-locality matrices "
            "(unstructured FEM): per row-block edge-colored slots, the x window "
            "and the Q map staged in shared memory, row sums in one "
            "shared-memory tile per block (mod-8 row classes per warp), a "
            "thread-block cluster per block where blocks are few",
        )
    )
    register(
        KernelSpec(
            name="PL_CSR_WINDOW_BF16",
            fmt="csr",
            impl="cuda",
            prepare=lambda csr, ell, cfg, device: prepare_window_auto(
                csr, dtype=torch.float32, vals_dtype=torch.bfloat16, device=device
            ),
            run=window_spmv,
            doc="windowed local-gather with bf16 value slabs (f32 x and "
            "accumulate): halves the dominant slot-value stream",
        )
    )
    register(
        KernelSpec(
            name="PL_CSR_WINDOW_F64",
            fmt="csr",
            impl="cuda",
            prepare=lambda csr, ell, cfg, device: prepare_window_auto(
                csr, df=True, device=device
            ),
            run=window_spmv,
            doc="double-precision windowed local-gather: slot values and x as "
            "(hi, lo) double-float pairs, TwoProduct gather products and "
            "TwoSum row sums in one CUDA launch that takes f64 x and writes "
            "f64 y (fixed-order sums, no atomics)",
            f64=True,
        )
    )


_register()
