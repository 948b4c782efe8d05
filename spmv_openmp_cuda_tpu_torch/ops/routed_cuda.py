"""CUDA kernels and dispatch of the Clos-routed engine (PL_CSR_ROUTED).

Counterpart of the kernel half of spmv_openmp_cuda_tpu/formats/routed.py
(`_gather_w1`, `_gather_products`, `_w3_r3_reduce`, `_perm_reduce_t1`,
`_reduce_runs_fused`, `_hdense_mv`, `_heavy_sums`, `_routed_small_spmv`, and
`routed_spmv` with its chunked and auto forms, all one `routed_spmv` here),
of the permutation application in spmv_openmp_cuda_tpu/ops/route.py
(`_whole_w_call`, `_tiled_call`, `apply_*`) and of the routed registry hooks
in spmv_openmp_cuda_tpu/ops/spmv_pallas.py. It holds the wrappers of the six
hand-written CUDA kernels in csrc/routed_spmv.cu, their plain PyTorch
versions, the conversion of the JAX package's prepared layout, and the modes
PL_CSR_ROUTED and PL_CSR_ROUTED_BF16; and the double-float engine of
PL_CSR_ROUTED_F64 (`routed_df_spmv`): the routed df kernels of
csrc/df_spmv.cu, K3 (`_gather_products_df`), C-df (the JAX package's
XLA-level TwoSum reduce, `_reduce_runs_df`, over each permuted slab), the
output gather of both planes into f64 y, and D-df (its dense heavy-row dot,
`_df_dense_rowdot`), enqueued as one program per product.

The permutation stages are static, so they are composed on the host, on
int64 element ids, into int32 index maps (`IndexMap`, `plan_map`): one
offset per element of a stage chain's result, -1 where it reads as zero.
One product is a chain of stages, built once per prepared matrix
(`build_chain`): gather+W1 (A) -> the run sums of the slab SW.W2.SW^-1,
W3, R3 would hold, read from A's products through one offset per slab slot
(C) -> [levels: C, each through its level's r1, W1, SW.W2.SW^-1, W3, R3
composed] -> zero the assembly tail -> dense heavy rows (D) -> the output
permutation (B: one gather into y) -> pooled heavy tiles (E, added into y
at the heavy rows). A small domain (the JAX package's `small_ok` test) is
one stage instead, the small kernel, which runs A, C and the output
permutation in one launch over per-row slot lists composed at build time
(`SmallStage`; its plain version, `small_reference`, equals the staged
chain's bit for bit). On a CUDA device the chain is encoded once as a
program that csrc/routed_spmv.cu enqueues in one call (its one entry point;
each single-kernel wrapper runs a one-op program through it, and it counts
the launches it made); on the CPU each stage runs its plain version. The
JAX package picks between TPU kernels by VMEM size (`_W3_FUSED_MAX_ROWS`,
`_FUSED_REDUCE_MAX_ROWS`, `_W3_FUSED_MASKED_MAX_ROWS`, the h1 > 8192
branch, `_WHOLE_MAX_T`). The port has no such limit: every other domain and
every level runs the same chain.

The wrappers launch the kernels for CUDA tensors and raise on anything they
do not take; the plain versions run only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import LANE
from ..formats.routed import (
    WINDOW_ELEMS,
    RoutedChunks,
    RoutedCSR,
    RoutedDF,
    pack_x_windows_flat,
    prepare_routed_auto,
    prepare_routed_df_auto,
)
from ..formats.matrix import target_device
from . import cuda_lib, dfloat
from .route import PlannedPermutation
from .spmv_cuda import _require, _to_tensor

_SLAB_DTYPES = (torch.float32, torch.bfloat16)
_IDX = (torch.int8,)
_F32 = (torch.float32,)
_I32 = (torch.int32,)

#: perm_reduce's modes: the stages between its source and the slab it sums
#: (R3 alone, W3 and R3, or r1, wc and R3 on a one-tile level)
MODE_DIRECT, MODE_W3, MODE_T1 = 0, 1, 2

#: heavy blocks above these sizes take a dense f32 matmul, as the JAX
#: package leaves them to an XLA dot (formats/routed.py:1027); kernel D's
#: close takes at most 64 rows (csrc/routed_spmv.cu kCloseRows)
_HDENSE_KERNEL_MAX_ROWS = 64
_HDENSE_KERNEL_MAX_BYTES = 6 * 2**20

#: the small kernel's domains: at most 4 tiles each way, and the JAX
#: package's 2 MB of f32 x windows (32 windows)
_SMALL_MAX_T = 4
_SMALL_MAX_WINDOWS = 2 * 2**20 // (WINDOW_ELEMS * 4)

#: D's columns per CTA (csrc/routed_spmv.cu kHChunk): one partial sum each
_HCHUNK = 4096

#: C's CTAs: consecutive groups packed into chunks of at most this many slab
#: rows (a wider group is a chunk of its own) and of at most _CHUNK_GROUPS
#: groups (csrc/routed_spmv.cu kChunkGroups)
_CHUNK_ROWS = 32
_CHUNK_GROUPS = 128


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels (the CPU path and the chip's check)
# ---------------------------------------------------------------------------


def _take_lanes(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """R stage: out[p, l] = a[p, idx[p, l]]."""
    return torch.gather(a, 1, idx.long())


def _w_tiles(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """W stage: out[T*128 + j, l] = a[T*128 + w[T*128 + l, j], l]."""
    nt = a.shape[0] // LANE
    wi = w.long().reshape(nt, LANE, LANE).transpose(1, 2)
    return torch.gather(a.reshape(nt, LANE, LANE), 1, wi).reshape(nt * LANE, LANE)


def _sw(a: torch.Tensor, t: int) -> torch.Tensor:
    """Row t*128 + s -> row s*T + t."""
    return a.reshape(t, LANE, LANE).transpose(0, 1).reshape(t * LANE, LANE)


def _sw_inv(a: torch.Tensor, t: int) -> torch.Tensor:
    """Row s*T + t -> row t*128 + s."""
    return a.reshape(LANE, t, LANE).transpose(0, 1).reshape(t * LANE, LANE)


def _rows(src: torch.Tensor, src_rows: int, n_rows: int) -> torch.Tensor:
    """The first n_rows rows of src, rows from src_rows on read as zero."""
    k = min(src_rows, n_rows, src.shape[0])
    out = torch.zeros(n_rows, LANE, dtype=torch.float32, device=src.device)
    out[:k] = src[:k]
    return out


def gather_reference(vals, pidx, widx, w1, n_tiles: int, x: torch.Tensor) -> torch.Tensor:
    """Plain kernel A: (n_tiles*128, 128) f32, tile i < n_real = products
    vals * x[widx[i]*16384 + pidx*128 + s] (s = row in tile), rows permuted
    by w1 when given; tiles from n_real on are zero."""
    n_real = vals.shape[0] // LANE
    nwin = max(-(-x.shape[0] // WINDOW_ELEMS), 1)
    xw = pack_x_windows_flat(x, nwin)
    s = torch.arange(LANE, device=x.device).repeat(n_real)
    wrow = widx.long().repeat_interleave(LANE) * LANE + s
    prod = vals.to(torch.float32) * torch.gather(xw[wrow], 1, pidx.long())
    if w1 is not None:
        prod = _w_tiles(prod, w1[: n_real * LANE])
    return torch.cat([prod, prod.new_zeros((n_tiles - n_real) * LANE, LANE)])


def _stage(a: torch.Tensor, r, w, ra, t: int, sw: bool) -> torch.Tensor:
    """One W stage over an (n_tiles*128, 128) array of any dtype: R (r) .
    SW . W (w) . SW^-1 . R (ra), each where given (the SW maps only when
    sw)."""
    h = a.shape[0]
    if r is not None:
        a = _take_lanes(a, r[:h])
    if sw:
        a = _sw(a, t)
    if w is not None:
        a = _w_tiles(a, w[:h])
    if sw:
        a = _sw_inv(a, t)
    if ra is not None:
        a = _take_lanes(a, ra[:h])
    return a


def w_stage_reference(src, src_rows: int, r, w, ra, t: int, sw: bool, n_tiles: int) -> torch.Tensor:
    """Plain W stage over n_tiles tiles: R (r) . SW . W (w) . SW^-1 . R
    (ra), the SW maps only when sw (then n_tiles == t); input rows from
    src_rows on read as zero. Returns the (n_tiles*128, 128) result."""
    return _stage(_rows(src, src_rows, n_tiles * LANE), r, w, ra, t, sw)


@dataclasses.dataclass(frozen=True, eq=False)
class WStep:
    """One W stage of a chain: R (r) . SW . W (w) . SW^-1 . R (ra), each
    where given."""

    w: Optional[torch.Tensor]
    r: Optional[torch.Tensor] = None
    ra: Optional[torch.Tensor] = None
    sw: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class Steps:
    """W stages applied in turn over an (h, 128) domain of t tiles, read
    from a source whose rows from src_rows on are zero."""

    steps: Tuple[WStep, ...]
    t: int
    h: int
    src_rows: int

    def apply(self, a: torch.Tensor) -> torch.Tensor:
        """The stages over a, (h, 128) of any dtype."""
        for st in self.steps:
            a = _stage(a, st.r, st.w, st.ra, self.t, st.sw)
        return a


def staged_reference(steps: Steps, src: torch.Tensor) -> torch.Tensor:
    """The plain staged chain that an index map composes: the W stages one
    after another over src ((rows, 128) f32), as w_stage_reference runs
    each. Returns (h, 128)."""
    return steps.apply(_rows(src, steps.src_rows, steps.h))


@dataclasses.dataclass(frozen=True, eq=False)
class IndexMap:
    """A chain of W stages composed: element i of the chain's result (h, 128)
    is element idx[i] of its source (f32 offsets, -1: reads as zero);
    span = 1 + the largest offset, what the source must hold. steps is None
    for the df output map composed over several domains (_output_map)."""

    steps: Optional[Steps]
    idx: torch.Tensor  # (h, 128) int32
    span: int


def _int32_offsets(ids: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """int64 offsets (-1: zero) as int32 and their span; raises where an
    offset does not fit in int32."""
    top = int(ids.max()) if ids.numel() else -1
    if top > torch.iinfo(torch.int32).max:
        raise ValueError(f"offset {top} does not fit in int32")
    return ids.to(torch.int32).contiguous(), top + 1


def index_map(steps: Steps, device) -> IndexMap:
    """steps composed on int64 element ids (exact at any size), as int32."""
    ids = torch.arange(steps.h * LANE, dtype=torch.int64, device=device).reshape(steps.h, LANE)
    ids[steps.src_rows:] = -1
    idx, span = _int32_offsets(steps.apply(ids))
    return IndexMap(steps, idx, span)


def plan_steps(plan: PlannedPermutation, form: str = "whole", skip_r3: bool = False,
               src_rows: Optional[int] = None) -> Steps:
    """The W stages of a planned permutation (route.py's apply_* forms):
    "whole" (r1 . w1 . SW.W2.SW^-1 . w3 . r3, or r1 . wc . r3 at t = 1),
    "to_mid" (r1 . w1 . SW.W2.SW^-1), "sw_w2_sw" and "from_w1"
    (SW.W2.SW^-1 . w3 . r3); skip_r3 leaves r3 out."""
    ra = None if skip_r3 else plan.r3
    w1, mid, w3 = WStep(plan.w1, r=plan.r1), WStep(plan.w2, sw=True), WStep(plan.w3, ra=ra)
    if form == "whole":
        steps = (WStep(plan.wc, r=plan.r1, ra=ra),) if plan.t == 1 and plan.wc is not None \
            else (w1, mid, w3)
    else:
        steps = {"to_mid": (w1, mid), "sw_w2_sw": (mid,), "from_w1": (mid, w3)}[form]
    return Steps(steps, plan.t, plan.h, plan.h if src_rows is None else src_rows)


def plan_map(plan: PlannedPermutation, form: str = "whole", skip_r3: bool = False,
             src_rows: Optional[int] = None) -> IndexMap:
    """plan_steps composed into one index map on the plan's device, once
    per form: cached on the plan."""
    key = (form, skip_r3, plan.h if src_rows is None else src_rows)
    if key not in plan.maps:
        plan.maps[key] = index_map(plan_steps(plan, form, skip_r3, src_rows), plan.w1.device)
    return plan.maps[key]


def permute_reference(src: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Plain kernel B: (n,) f32, out[i] = src.view(-1)[idx[i]], 0 where
    idx[i] < 0."""
    i = idx.reshape(-1)[:n].long()
    flat = src.reshape(-1)
    return torch.where(i >= 0, flat[i.clamp(min=0)], flat.new_zeros(()))


def _n_groups(runs) -> int:
    return runs[-1][3] + runs[-1][1]


def _reduce_runs(g: torch.Tensor, runs) -> torch.Tensor:
    out = g.new_empty(_n_groups(runs), LANE)
    for row0, ng, width, g0 in runs:
        out[g0 : g0 + ng] = g[row0 : row0 + ng * width].reshape(ng, width, LANE).sum(1)
    return out


def perm_reduce_reference(src, off: torch.Tensor, mask, runs) -> torch.Tensor:
    """Plain kernel C: per group of runs (row0, n_groups, width, g0), the
    width-row sums of g = mask * (the slab read from src through the
    offsets off, (rows, 128), -1 reading as zero). Returns (n_groups, 128)."""
    rows = off.shape[0]
    g = permute_reference(src, off, off.numel()).reshape(rows, LANE)
    if mask is not None:
        g = g * mask[:rows]
    return _reduce_runs(g, runs)


def hdense_reference(hdense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain kernel D: y_h[k] = sum_c f32(H[k, c]) * x[c] (x zero past n)."""
    xb = torch.nn.functional.pad(x.to(torch.float32), (0, hdense.shape[1] - x.shape[0]))
    return (hdense.to(torch.float32) * xb).sum(1)


def _warp_tree(v: torch.Tensor) -> torch.Tensor:
    """The shuffle tree of a warp over the last axis (32 lanes): lane 0's
    ((v0 + v16) + (v8 + v24)) + ..., rounded at each add. Drops the axis."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def hdense_in_order(hdense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """hdense_reference's function with every operation of kernel D in its
    order (f32, rounded at each step): per heavy row and chunk of _HCHUNK
    columns, thread t's products at columns chunk * _HCHUNK + (it * 256 + t)
    * 8 + u (it = 0, 1; u = 0..7; a group of 8 at or past n_pad skipped)
    fused into its sum from +0 (one FMA each, dfloat.fma_f32); the 32 sums
    of each warp by the shuffle tree, the 8 warp sums by the same tree (24
    lanes of +0); then a row's chunk sums dealt to 32 lanes in turn, each
    lane's sum from +0, and the shuffle tree. The kernel equals it bit for
    bit. Returns (n_heavy,) f32."""
    n_h, n_pad = hdense.shape
    n_cta = -(-n_pad // _HCHUNK)
    cols = n_cta * _HCHUNK
    dev = x.device
    h = torch.zeros(n_h, cols, dtype=torch.float32, device=dev)
    h[:, :n_pad] = hdense.to(torch.float32)
    xb = torch.zeros(cols, dtype=torch.float32, device=dev)
    n = min(x.shape[0], n_pad)
    xb[:n] = x[:n].to(torch.float32)
    h = h.reshape(n_h, n_cta, 2, 256, 8)
    xb = xb.reshape(n_cta, 2, 256, 8)
    inside = (torch.arange(cols, device=dev) < n_pad).reshape(n_cta, 2, 256, 8)
    acc = torch.zeros(n_h, n_cta, 256, dtype=torch.float32, device=dev)
    for it in range(2):
        for u in range(8):
            acc = torch.where(inside[:, it, :, u], dfloat.fma_f32(h[:, :, it, :, u],
                                                                   xb[:, it, :, u], acc), acc)
    warps = _warp_tree(acc.reshape(n_h, n_cta, 8, 32))
    part = _warp_tree(torch.cat([warps, torch.zeros(n_h, n_cta, 24, device=dev)], dim=-1))
    lanes = torch.zeros(n_h, 32, dtype=torch.float32, device=dev)
    for j in range(-(-n_cta // 32)):
        i = j * 32 + torch.arange(32, device=dev)
        lanes = torch.where(i < n_cta, lanes + part[:, i.clamp(max=n_cta - 1)], lanes)
    return _warp_tree(lanes).contiguous()


def heavy_sums_reference(hvals, hpidx, hwidx, hlo, hhi, slot_ptr, slot_idx,
                         x: torch.Tensor) -> torch.Tensor:
    """Plain kernel E, the JAX package's _heavy_sums formula in f32: per
    pooled tile, the products hvals * x[hwidx*16384 + hpidx*128 + a] (a =
    row in tile), their inclusive cumsum along the lanes, its differences at
    each row slot's (hlo, hhi] bounds (-1: no term) summed over the
    residues, then each heavy row's slot sums (slot_idx[slot_ptr[k] :
    slot_ptr[k + 1]]). Returns (n_heavy,) f32."""
    n_tiles = hvals.shape[0] // LANE
    nwin = max(-(-x.shape[0] // WINDOW_ELEMS), 1)
    xw = pack_x_windows_flat(x, nwin)
    s = torch.arange(LANE, device=x.device).repeat(n_tiles)
    wrow = hwidx.long().repeat_interleave(LANE) * LANE + s
    prod = hvals.to(torch.float32) * torch.gather(xw[wrow], 1, hpidx.long())
    c = torch.cumsum(prod, dim=1)
    lo, hi = hlo.long(), hhi.long()
    t_hi = torch.gather(c, 1, hi.clamp(min=0)) * (hi >= 0)
    t_lo = torch.gather(c, 1, lo.clamp(min=0)) * (lo >= 0)
    slots = (t_hi - t_lo).reshape(n_tiles, LANE, LANE).sum(1).reshape(-1)
    n_h = slot_ptr.shape[0] - 1
    owner = torch.repeat_interleave(torch.arange(n_h, device=x.device), torch.diff(slot_ptr.long()))
    out = torch.zeros(n_h, dtype=torch.float32, device=x.device)
    return out.index_add_(0, owner, slots[slot_idx.long()])


def heavy_sums_in_order(hvals, hpidx, hwidx, hlo, hhi, slot_ptr, slot_idx,
                        x: torch.Tensor) -> torch.Tensor:
    """heavy_sums_reference's function with every add of kernel E and its
    close, in their order (f32, rounded at each add): a tile row's products
    summed lane by lane from +0, restarting at each run's first lane (hlo +
    1) and read at its last (hhi); per slot and residue quarter, the runs
    over the quarter's 32 residues in order from +0; a slot's four quarters
    added in order; a heavy row's slots spread over 32 lanes in turn, each
    lane's sum from +0, then the shuffle tree of routed_row_sums_kernel.
    Where a run or a row is missing this adds +0, which leaves a sum from +0
    as it is. The kernel's y is bit for bit this one. Returns (n_heavy,)
    f32."""
    n_tiles = hvals.shape[0] // LANE
    nwin = max(-(-x.shape[0] // WINDOW_ELEMS), 1)
    xw = pack_x_windows_flat(x, nwin)
    s = torch.arange(LANE, device=x.device).repeat(n_tiles)
    wrow = hwidx.long().repeat_interleave(LANE) * LANE + s
    prod = hvals.to(torch.float32) * torch.gather(xw[wrow], 1, hpidx.long())
    lo, hi = hlo.long(), hhi.long()
    rows = prod.shape[0]
    has = hi >= 0
    r = torch.arange(rows, device=x.device)[:, None].expand_as(hi)[has]
    start = torch.zeros(rows, LANE, dtype=torch.bool, device=x.device)
    start[r, lo[has] + 1] = True
    runs = torch.empty_like(prod)
    acc = torch.zeros(rows, dtype=torch.float32, device=x.device)
    for lane in range(LANE):
        acc = torch.where(start[:, lane], torch.zeros_like(acc), acc) + prod[:, lane]
        runs[:, lane] = acc
    at = torch.where(has, torch.gather(runs, 1, hi.clamp(min=0)), torch.zeros_like(runs))
    at = at.reshape(n_tiles, HEAVY_QUARTERS, LANE // HEAVY_QUARTERS, LANE)
    red = torch.zeros(n_tiles, HEAVY_QUARTERS, LANE, dtype=torch.float32, device=x.device)
    for a in range(LANE // HEAVY_QUARTERS):
        red = red + at[:, :, a, :]
    slots = red[:, 0]
    for q in range(1, HEAVY_QUARTERS):
        slots = slots + red[:, q]
    slots = slots.reshape(-1)
    n_h = slot_ptr.shape[0] - 1
    ptr = slot_ptr.long()
    lens = ptr[1:] - ptr[:-1]
    width = max(int(lens.max()) if n_h else 0, 1)
    width = -(-width // 32) * 32
    k = torch.arange(width, device=x.device)
    at = (ptr[:-1, None] + k).clamp(max=max(slot_idx.shape[0] - 1, 0))
    vals = slots[slot_idx.long()[at]] if slot_idx.numel() else \
        torch.zeros(n_h, width, dtype=torch.float32, device=x.device)
    vals = torch.where(k < lens[:, None], vals, torch.zeros_like(vals)).reshape(n_h, -1, 32)
    lane_sums = torch.zeros(n_h, 32, dtype=torch.float32, device=x.device)
    for i in range(vals.shape[1]):
        lane_sums = lane_sums + vals[:, i]
    return _warp_tree(lane_sums).contiguous()


def small_reference(vals, pidx, widx, row_ptr, row_slots, x: torch.Tensor) -> torch.Tensor:
    """Plain small kernel: y[i] (f32, length m) = the products of the gather
    slots row_slots[row_ptr[i] : row_ptr[i + 1]] (A's arithmetic: vals * x
    at the slot's column, x zero past n) added one at a time in list order
    from +0, as C adds a group's slab rows."""
    m = row_ptr.shape[0] - 1
    y = torch.zeros(m, dtype=torch.float32, device=x.device)
    if row_slots.numel() == 0:
        return y
    s = row_slots.long()
    n = x.shape[0]
    col = (widx.long()[s // (LANE * LANE)] * WINDOW_ELEMS + pidx.reshape(-1).long()[s] * LANE
           + (s // LANE) % LANE)
    xv = torch.where(col < n, x[col.clamp(max=max(n - 1, 0))], torch.zeros((), device=x.device))
    prod = vals.reshape(-1)[s].to(torch.float32) * xv
    ptr = row_ptr.long()
    lens = ptr[1:] - ptr[:-1]
    for k in range(int(lens.max())):
        at = (ptr[:-1] + k).clamp(max=s.shape[0] - 1)
        y = torch.where(lens > k, y + prod[at], y)
    return y


# ---------------------------------------------------------------------------
# CUDA kernel wrappers (csrc/routed_spmv.cu)
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.routed_chain_launch.argtypes = [p, i, p, ll, p, p, p, p]
    lib.routed_chain_launch.restype = i
    lib.routed_error_string.argtypes = [i]
    lib.routed_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return cuda_lib.load("routed_spmv", _bind)


def _on_cuda(*ts) -> torch.device:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {dev}")
    if any(t is not None and t.device != dev for t in ts):
        raise ValueError("every operand must lie on one CUDA device")
    return dev


# Programs of csrc/routed_spmv.cu::routed_chain_launch, the one entry point
# of the kernels: a whole product (the chain, encoded once) and each single
# stage (the wrappers below) run through it, and it counts the launches it
# made. An op is its code and its operands as int64: ints, tensors by
# address, Bufs tagged in the top byte (1 scratch, 2 y) with a byte offset.
_OP_GATHER, _OP_PERMUTE, _OP_REDUCE, _OP_HDENSE, _OP_ZERO, _OP_HEAVY, _OP_SMALL = range(1, 8)
#: kernel E's residue quarters per pooled tile (csrc/routed_spmv.cu's kQuarters)
HEAVY_QUARTERS = 4
_TAGS = {"s": 1, "y": 2}


def _aligned(t, align: int):
    """t, checked to be align-byte aligned: the kernels read groups with
    8-byte loads; hdense, the gather tiles (vals, pidx, w1), the pooled
    heavy tiles (hvals, hpidx, hlo, hhi) and E's slot sums with 16-byte
    loads or copies; every other operand with scalar loads."""
    if isinstance(t, torch.Tensor) and t.data_ptr() % align:
        raise ValueError(f"an operand read with {align}-byte loads is not {align}-byte aligned")
    return t


def _operand(v) -> int:
    if v is None:
        return 0
    if isinstance(v, torch.Tensor):
        return v.data_ptr()
    if isinstance(v, Buf):
        return (_TAGS[v.kind] << 56) | (v.off * 4)
    return int(v)


def _op(code: int, *args) -> List[int]:
    return [code] + [_operand(a) for a in args]


def _gather_op(vals, pidx, widx, w1, n_tiles: int, out) -> List[int]:
    return _op(_OP_GATHER, vals.dtype == torch.bfloat16, _aligned(vals, 16), _aligned(pidx, 16),
               widx, _aligned(w1, 16), vals.shape[0] // LANE, n_tiles, out)


def _permute_op(src, imap: IndexMap, n: int, out) -> List[int]:
    return _op(_OP_PERMUTE, src, imap.idx, n, out)


def _reduce_op(src, imap: IndexMap, mask, groups, chunks, out) -> List[int]:
    return _op(_OP_REDUCE, src, imap.idx, mask, _aligned(groups, 8), _aligned(chunks, 16),
               chunks.shape[0], out)


def _hdense_op(hdense, target, out, part) -> List[int]:
    # part: D's scratch (a tensor or a Buf), its ticket first, then the sums
    if isinstance(part, Buf):
        sums, ticket = part.at(1), part
    else:
        sums, ticket = (None, None) if part is None else (part[1:], part)
    return _op(_OP_HDENSE, _aligned(hdense, 16), hdense.shape[0], hdense.shape[1], target, out,
               sums, ticket)


def _hdense_part_elems(hdense) -> int:
    """f32 elements of kernel D's scratch: its ticket (element 0, zero
    between launches: the kernel's last CTA sets it back to 0), then each
    heavy row's sums per chunk of _HCHUNK columns."""
    return 1 + hdense.shape[0] * -(-hdense.shape[1] // _HCHUNK)


def _heavy_op(hvals, hpidx, hwidx, hlo, hhi, slot_ptr, slot_idx, rows, part, out) -> List[int]:
    return _op(_OP_HEAVY, hvals.dtype == torch.bfloat16, _aligned(hvals, 16), _aligned(hpidx, 16),
               hwidx, _aligned(hlo, 16), _aligned(hhi, 16), hvals.shape[0] // LANE, slot_ptr,
               slot_idx, rows, rows.shape[0], _aligned(part, 16), out)


def heavy_part_elems(hvals) -> int:
    """f32 elements of kernel E's scratch: each pooled tile's 128 slot sums
    per residue quarter, slot by slot (csrc/routed_spmv.cu: an item per
    tile and quarter, the close adds a slot's quarters in order)."""
    return HEAVY_QUARTERS * hvals.shape[0]


def _small_op(stage: "SmallStage") -> List[int]:
    return _op(_OP_SMALL, stage.vals.dtype == torch.bfloat16, stage.vals, stage.pidx, stage.widx,
               stage.row_ptr, stage.row_slots, stage.out, stage.out_elems())


class Program:
    """A program of csrc/routed_spmv.cu::routed_chain_launch, made once: its
    int64 words and the host array the C side counts its launches into."""

    def __init__(self, words):
        self.words = np.ascontiguousarray(words, dtype=np.int64)
        self.counts = (ctypes.c_int * len(self._counter_fns()))()
        self._addr = (self.words.ctypes.data, ctypes.addressof(self.counts))

    @staticmethod
    def _counter_fns():
        return _COUNTER_FNS

    def run(self, x: Optional[torch.Tensor], y: int, scratch: int, dev: torch.device) -> None:
        """Enqueue the program on dev's current stream; the counters gain
        the launches the C side made (those enqueued before an error too);
        an error raises."""
        lib = _lib()
        rc = lib.routed_chain_launch(
            self._addr[0], self.words.shape[0], 0 if x is None else x.data_ptr(),
            0 if x is None else x.shape[0], y, scratch, self._addr[1],
            cuda_lib.current_stream(dev),
        )
        _drain(self.counts, self._counter_fns())
        if rc != 0:
            msg = lib.routed_error_string(rc).decode()
            raise RuntimeError(f"routed kernels: launch failed: CUDA error {rc} ({msg})")


def _drain(counts, fns) -> None:
    """Add the launches a program counted into its wrappers' counters."""
    for i, fn in enumerate(fns):
        if counts[i]:
            fn.launches += counts[i]
            counts[i] = 0


def _run_op(op: List[int], x: Optional[torch.Tensor], dev: torch.device) -> None:
    Program(op).run(x, 0, 0, dev)


def routed_gather_cuda(vals, pidx, widx, w1, n_tiles: int, x, out) -> torch.Tensor:
    """Kernel A into out (>= n_tiles*128*128 f32): the products of the
    vals.shape[0]//128 gather tiles, W1-permuted when w1 is given, then
    zero tiles."""
    dev = _on_cuda(x, vals, pidx, widx, w1, out)
    _check_gather(vals, pidx, widx, w1, n_tiles, x, out)
    _run_op(_gather_op(vals, pidx, widx, w1, n_tiles, out), x, dev)
    return out


routed_gather_cuda.launches = 0


def routed_permute_cuda(src, imap: IndexMap, n: int, out) -> torch.Tensor:
    """Kernel B into out: out[i] = src.view(-1)[imap.idx[i]] (0 where the
    offset is -1) for i < n."""
    dev = _on_cuda(src, imap.idx, out)
    _check_permute(src, imap, n, out)
    _run_op(_permute_op(src, imap, n, out), None, dev)
    return out


routed_permute_cuda.launches = 0


def routed_perm_reduce_cuda(src, imap: IndexMap, mask, groups, chunks, out) -> torch.Tensor:
    """Kernel C into out (n_groups, 128): the group sums of the slab read
    from src through imap.idx's rows, masked where mask is given; groups is
    the (n_groups, 2) int32 table of (first slab row, width), chunks its
    CTAs' (reduce_chunks)."""
    dev = _on_cuda(src, imap.idx, mask, groups, chunks, out)
    _check_perm_reduce(src, imap, mask, groups, chunks, out)
    _run_op(_reduce_op(src, imap, mask, groups, chunks, out), None, dev)
    return out


routed_perm_reduce_cuda.launches = 0


def routed_hdense_cuda(hdense, x, target, out, part=None) -> torch.Tensor:
    """Kernel D, one launch: out.view(-1)[target[k]] += H[k] . x (each row's
    chunk sums added once, in a fixed order, by the CTA that finishes last;
    part is the f32 scratch of _hdense_part_elems, its ticket zero; zeroed
    when allocated here)."""
    dev = _on_cuda(x, hdense, target, out, part)
    _check_hdense(hdense, x, target, out)
    if part is None:
        part = torch.zeros(_hdense_part_elems(hdense), dtype=torch.float32, device=dev)
    _check_out(part, "part", _hdense_part_elems(hdense), dev)
    _run_op(_hdense_op(hdense, target, out, part), x, dev)
    return out


routed_hdense_cuda.launches = 0


def routed_heavy_cuda(hvals, hpidx, hwidx, hlo, hhi, slot_ptr, slot_idx, rows, x, out,
                      part=None) -> torch.Tensor:
    """Kernel E: out[rows[k]] += heavy row k's sum over the pooled tiles
    (heavy_sums_reference's function, each run summed directly; part is the
    (heavy_part_elems(hvals),) f32 scratch of the slot sums per residue
    quarter, allocated when not given)."""
    dev = _on_cuda(x, hvals, hpidx, hwidx, hlo, hhi, slot_ptr, slot_idx, rows, out, part)
    _check_heavy(hvals, hpidx, hwidx, hlo, hhi, slot_ptr, slot_idx, rows, x, out)
    if part is None:
        part = torch.empty(heavy_part_elems(hvals), dtype=torch.float32, device=dev)
    _check_out(part, "part", heavy_part_elems(hvals), dev)
    _run_op(_heavy_op(hvals, hpidx, hwidx, hlo, hhi, slot_ptr, slot_idx, rows, part, out), x, dev)
    return out


routed_heavy_cuda.launches = 0


def routed_small_cuda(stage: "SmallStage", x, y) -> torch.Tensor:
    """The small kernel: a small domain's whole product (A, B, C and the
    output permutation, composed into per-row slot lists) in one launch,
    into the chain's y buffer at the stage's offset."""
    dev = _on_cuda(x, y, stage.row_ptr, stage.row_slots)
    _check_out(y, "y", stage.out.off + stage.out_elems(), dev)
    Program(_small_op(stage)).run(x, y.data_ptr(), 0, dev)
    return y


routed_small_cuda.launches = 0


#: launches of each kernel, as csrc/routed_spmv.cu counted them (in the
#: order of its counts array)
_COUNTERS = {
    "gather": routed_gather_cuda,
    "permute": routed_permute_cuda,
    "perm_reduce": routed_perm_reduce_cuda,
    "hdense": routed_hdense_cuda,
    "heavy": routed_heavy_cuda,
    "small": routed_small_cuda,
}
_COUNTER_FNS = tuple(_COUNTERS.values())


# ---------------------------------------------------------------------------
# Checks (what the kernels index with)
# ---------------------------------------------------------------------------


def _idx(t, name, rows, dev):
    if t is not None:
        _require(t, name, _IDX, (rows, LANE), dev)


def _check_out(out, name, n_elems, dev):
    if out is None:  # the plain versions allocate their own
        return
    if out.device != dev or out.dtype != torch.float32 or not out.is_contiguous() \
            or out.numel() < n_elems:
        raise ValueError(f"{name} must be a contiguous f32 tensor of >= {n_elems} elements on {dev}")


def _check_gather(vals, pidx, widx, w1, n_tiles, x, out):
    dev = x.device
    rows_a = vals.shape[0]
    n_real = rows_a // LANE
    if rows_a % LANE or not 1 <= n_real <= n_tiles <= LANE:
        raise ValueError(f"{rows_a} gather rows do not fit {n_tiles} tiles of 128 rows")
    _require(vals, "vals", _SLAB_DTYPES, (rows_a, LANE), dev)
    _require(pidx, "pidx", _IDX, (rows_a, LANE), dev)
    _require(widx, "widx", (torch.int32,), (n_real,), dev)
    _idx(w1, "w1", n_tiles * LANE, dev)
    _require(x, "x", _F32, (x.shape[0],), dev)
    _check_out(out, "out", n_tiles * LANE * LANE, dev)


def _check_src(src, span: int, dev) -> None:
    if src.device != dev or src.dtype != torch.float32 or not src.is_contiguous() \
            or src.numel() < span:
        raise ValueError(f"src must be a contiguous f32 tensor of >= {span} elements on {dev}")


def _check_permute(src, imap: IndexMap, n, out):
    dev = src.device
    _check_src(src, imap.span, dev)
    _require(imap.idx, "idx", _I32, tuple(imap.idx.shape), dev)
    if not 1 <= n <= imap.idx.numel():
        raise ValueError(f"{n} elements of a map of {imap.idx.numel()}")
    _check_out(out, "out", n, dev)


def _check_perm_reduce(src, imap: IndexMap, mask, groups, chunks, out):
    dev = src.device
    _check_src(src, imap.span, dev)
    rows = imap.idx.shape[0]
    _require(imap.idx, "off", _I32, (rows, LANE), dev)
    if mask is not None and (mask.device != dev or mask.dtype != torch.float32 or mask.dim() != 2
                             or mask.shape[0] < rows or mask.shape[1] != LANE
                             or not mask.is_contiguous()):
        raise ValueError(f"mask must be a contiguous (>= {rows}, 128) f32 tensor on {dev}")
    g = groups.shape[0]
    _require(groups, "groups", _I32, (g, 2), dev)
    _require(chunks, "chunks", _I32, (chunks.shape[0], 4), dev)
    _check_out(out, "out", g * LANE, dev)


def _check_hdense(hdense, x, target, out):
    dev = x.device
    n_h, n_pad = hdense.shape
    if n_pad % LANE or n_pad < x.shape[0] or n_h < 1:
        raise ValueError(f"heavy block {tuple(hdense.shape)} does not cover x of {x.shape[0]}")
    if n_h > _HDENSE_KERNEL_MAX_ROWS:
        raise ValueError(f"kernel D takes at most {_HDENSE_KERNEL_MAX_ROWS} heavy rows, not {n_h}")
    _require(hdense, "hdense", (torch.bfloat16,), (n_h, n_pad), dev)
    _require(target, "target", (torch.int32,), (n_h,), dev)
    _check_out(out, "out", -(-n_h // LANE) * LANE, dev)


def _check_heavy(hvals, hpidx, hwidx, hlo, hhi, slot_ptr, slot_idx, rows, x, out):
    dev = x.device
    rows_h = hvals.shape[0]
    n_tiles = rows_h // LANE
    if rows_h % LANE or n_tiles < 1:
        raise ValueError(f"{rows_h} heavy tile rows are not whole 128-row tiles")
    _require(hvals, "hvals", _SLAB_DTYPES, (rows_h, LANE), dev)
    for name, a in (("hpidx", hpidx), ("hlo", hlo), ("hhi", hhi)):
        _require(a, name, _IDX, (rows_h, LANE), dev)
    _require(hwidx, "hwidx", (torch.int32,), (n_tiles,), dev)
    n_h = rows.shape[0]
    _require(rows, "rows", (torch.int32,), (n_h,), dev)
    _require(slot_ptr, "slot_ptr", (torch.int32,), (n_h + 1,), dev)
    _require(slot_idx, "slot_idx", (torch.int32,), (slot_idx.shape[0],), dev)
    _require(x, "x", _F32, (x.shape[0],), dev)
    if out is not None and (out.device != dev or out.dtype != torch.float32 or out.dim() != 1
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous 1-d f32 tensor on {dev}")


# ---------------------------------------------------------------------------
# Single-kernel operations (the TPU kernels' counterparts, by device)
# ---------------------------------------------------------------------------


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def permute(src: torch.Tensor, imap: IndexMap, n: Optional[int] = None) -> torch.Tensor:
    """Kernel B's function, (n,) f32 (n: the whole map by default): src
    read through the index map; the plain version on the CPU."""
    n = imap.idx.numel() if n is None else n
    if _device_of(src) == "cpu":
        _check_permute(src, imap, n, None)
        return permute_reference(src, imap.idx, n)
    out = torch.empty(n, dtype=torch.float32, device=src.device)
    return routed_permute_cuda(src, imap, n, out)


def w_stage(x, w, r=None, ra=None, sw: bool = False, t: int = 1, n_tiles: Optional[int] = None,
            src_rows: Optional[int] = None) -> torch.Tensor:
    """One W stage over x (rows, 128) f32: the JAX package's
    _whole_w_call(x, w, r, r_after) and _tiled_call kernels, and with sw
    the SW . W2 . SW^-1 middle (apply_sw_w2_sw). The plain stage on the
    CPU; on the card kernel B through the stage's index map."""
    n_tiles = x.shape[0] // LANE if n_tiles is None else n_tiles
    src_rows = x.shape[0] if src_rows is None else src_rows
    h = n_tiles * LANE
    if not 1 <= n_tiles <= LANE or (sw and n_tiles != t) or t < 1 or LANE % t \
            or not 0 <= src_rows <= x.shape[0]:
        raise ValueError(f"bad W stage geometry n_tiles={n_tiles} t={t} sw={sw} src_rows={src_rows}")
    for name, a in (("r", r), ("w", w), ("ra", ra)):
        _idx(a, name, h, x.device)
    if _device_of(x) == "cpu":
        return w_stage_reference(x, src_rows, r, w, ra, t, sw, n_tiles)
    imap = index_map(Steps((WStep(w, r=r, ra=ra, sw=sw),), t, h, src_rows), x.device)
    return permute(x, imap).reshape(h, LANE)


def apply_w_stage(w, x) -> torch.Tensor:
    """One W stage over a row-aligned slice of a domain; w is the matching
    row slice of the stage array."""
    return w_stage(x, w)


def _apply(plan: PlannedPermutation, x, form: str, skip_r3: bool = False) -> torch.Tensor:
    """A form of the planned permutation over x (rows, 128) f32 (rows from
    x's end to plan.h read as zero): one gather through its cached map."""
    imap = plan_map(plan, form, skip_r3, min(x.shape[0], plan.h))
    return permute(x, imap).reshape(plan.h, LANE)


def apply_sw_w2_sw(plan: PlannedPermutation, x2) -> torch.Tensor:
    """SW . W2 . SW^-1 for callers that applied W1 themselves."""
    return _apply(plan, x2, "sw_w2_sw")


def apply_permutation_to_mid(plan: PlannedPermutation, x) -> torch.Tensor:
    """R1, W1, SW, W2, SW^-1: the returned x5 still needs W3 and R3."""
    return _apply(plan, x, "to_mid")


def apply_permutation_from_w1(plan: PlannedPermutation, x2, skip_r3: bool = False) -> torch.Tensor:
    """SW . W2 . SW^-1 . W3 [. R3] for callers that already applied W1."""
    return _apply(plan, x2, "from_w1", skip_r3)


def apply_permutation(plan: PlannedPermutation, x, skip_r3: bool = False) -> torch.Tensor:
    """y[dst_of[slot]] = x[slot] for the planned bijection; x is (H, 128).
    With skip_r3 the last lane permutation is left to the caller:
    true[h, l] == returned[h, r3[h, l]]."""
    return _apply(plan, x, "whole", skip_r3)


def routed_gather(mat: RoutedCSR, x: torch.Tensor, w1: bool = True) -> torch.Tensor:
    """Kernel A's function: with w1, the JAX package's _gather_w1 ((h1, 128)
    products, W1-permuted, pad tiles zero); without, its _gather_products
    ((rows_a, 128) products in panel order)."""
    n_real = mat.vals.shape[0] // LANE
    n_tiles = mat.perm_products.t if w1 else n_real
    w = mat.perm_products.w1 if w1 else None
    if _device_of(x) == "cpu":
        _check_gather(mat.vals, mat.pidx, mat.widx, w, n_tiles, x, None)
        return gather_reference(mat.vals, mat.pidx, mat.widx, w, n_tiles, x)
    out = torch.empty(n_tiles * LANE, LANE, dtype=torch.float32, device=x.device)
    return routed_gather_cuda(mat.vals, mat.pidx, mat.widx, w, n_tiles, x, out)


def reduce_chunks(runs, device) -> torch.Tensor:
    """(n_chunks, 4) int32 (row0, row1, g0, g1): kernel C's CTAs, each the
    consecutive output groups g0 .. g1 - 1 of runs (row0, n_groups, width,
    g0), whose slab rows tile [row0, row1) in order. A chunk takes groups
    while it stays within _CHUNK_ROWS rows and _CHUNK_GROUPS groups; a wider
    group is a chunk alone. The groups come wide first, so the chunks do
    too."""
    tab = groups_table(runs, "cpu").numpy().astype(np.int64)
    ends = tab[:, 0] + tab[:, 1]
    out, start = [], 0
    for g in range(1, tab.shape[0] + 1):
        if g == tab.shape[0] or tab[g, 0] != ends[g - 1] or ends[g] - tab[start, 0] > _CHUNK_ROWS \
                or g - start == _CHUNK_GROUPS:
            out.append((tab[start, 0], ends[g - 1], start, g))
            start = g
    return torch.tensor(out, dtype=torch.int32).to(device)


def groups_table(runs, device) -> torch.Tensor:
    """(n_groups, 2) int32 (first slab row, width) of every output group of
    runs (row0, n_groups, width, g0)."""
    tab = np.zeros((_n_groups(runs), 2), dtype=np.int32)
    for row0, ng, width, g0 in runs:
        tab[g0 : g0 + ng, 0] = row0 + np.arange(ng) * width
        tab[g0 : g0 + ng, 1] = width
    return torch.from_numpy(tab).to(device)


def reduce_map(r3, mode: int = MODE_W3, W=None, r1=None, src_rows: Optional[int] = None) -> IndexMap:
    """The offsets perm_reduce reads its (h, 128) slab through (h =
    r3.shape[0]): R3 alone (MODE_DIRECT), W3 then R3 (MODE_W3) or r1, wc
    and R3 on one tile (MODE_T1), composed; source rows from src_rows (h by
    default) on read as zero."""
    h = r3.shape[0]
    if mode not in (MODE_DIRECT, MODE_W3, MODE_T1) or h % LANE or not 0 < h <= LANE * LANE:
        raise ValueError(f"bad reduce mode {mode} or slab rows {h}")
    if (mode == MODE_T1 and (h != LANE or r1 is None)) or (mode != MODE_DIRECT and W is None):
        raise ValueError(f"reduce mode {mode} needs W (and r1 on a one-tile level)")
    for name, a in (("r3", r3), ("W", W), ("r1", r1)):
        _idx(a, name, h, r3.device)
    step = WStep(None if mode == MODE_DIRECT else W, r=r1 if mode == MODE_T1 else None, ra=r3)
    return index_map(Steps((step,), h // LANE, h, h if src_rows is None else src_rows), r3.device)


def perm_reduce(src, runs, r3, mode: int = MODE_W3, W=None, r1=None, mask=None,
                src_rows: Optional[int] = None) -> torch.Tensor:
    """Kernel C's function, (n_groups, 128) group sums: mode MODE_W3 is the
    JAX package's _w3_r3_reduce (W = w3), MODE_T1 its _perm_reduce_t1 and
    the fused level (W = wc, r1), MODE_DIRECT its _reduce_runs_fused. The
    mode's stages are composed into one offset per slab slot (reduce_map)."""
    src_rows = src.shape[0] if src_rows is None else src_rows
    if not 0 <= src_rows <= src.shape[0] or src.dim() != 2 or src.shape[1] != LANE:
        raise ValueError(f"src must be a (rows, 128) tensor with >= {src_rows} rows")
    imap = reduce_map(r3, mode, W, r1, src_rows)
    h = r3.shape[0]
    if any(row0 + ng * width > h for row0, ng, width, _g0 in runs):
        raise ValueError(f"runs {runs} do not fit a slab of {h} rows")
    groups, chunks = groups_table(runs, src.device), reduce_chunks(runs, src.device)
    if _device_of(src) == "cpu":
        _check_perm_reduce(src, imap, mask, groups, chunks, None)
        return perm_reduce_reference(src, imap.idx, mask, runs)
    out = torch.empty(groups.shape[0], LANE, dtype=torch.float32, device=src.device)
    return routed_perm_reduce_cuda(src, imap, mask, groups, chunks, out)


def _heavy_targets(mat: RoutedCSR) -> np.ndarray:
    n_h = mat.hdense.shape[0]
    return (np.arange(n_h) // LANE * LANE + np.asarray(mat.heavy_lanes, np.int64)).astype(np.int32)


def _hdense_in_kernel(hdense: torch.Tensor) -> bool:
    return hdense.shape[0] <= _HDENSE_KERNEL_MAX_ROWS and \
        hdense.numel() * 2 <= _HDENSE_KERNEL_MAX_BYTES


def hdense_mv(mat: RoutedCSR, x: torch.Tensor, placed: bool = False) -> torch.Tensor:
    """Kernel D's function, the JAX package's _hdense_mv: y_h = H @ x (f32,
    length n_heavy), or with placed the (rows, 128) assembly rows holding
    sum k at (k // 128, heavy_lanes[k]). Blocks of more than 64 rows or
    6 MB take a dense f32 matmul, as the JAX package takes an XLA dot."""
    n_h = mat.hdense.shape[0]
    rows = max(-(-n_h // LANE), 1)
    if placed:
        target = torch.from_numpy(_heavy_targets(mat)).to(x.device)
    else:
        target = torch.arange(n_h, dtype=torch.int32, device=x.device)
    out = torch.zeros(rows * LANE, dtype=torch.float32, device=x.device)
    if not _hdense_in_kernel(mat.hdense):
        out[target.long()] = _hdense_matmul(mat.hdense, x)
    elif _device_of(x) == "cpu":
        _check_hdense(mat.hdense, x, target, None)
        out[target.long()] += hdense_reference(mat.hdense, x)
    else:
        routed_hdense_cuda(mat.hdense, x, target, out)
    return out.reshape(rows, LANE) if placed else out[:n_h]


def _hdense_matmul(hdense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    xb = torch.nn.functional.pad(x.to(torch.float32), (0, hdense.shape[1] - x.shape[0]))
    return torch.matmul(hdense.to(torch.float32), xb)


# ---------------------------------------------------------------------------
# The chain: one product as a list of stages over a call's buffers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Buf:
    """A place in a call's buffers: kind "s" (scratch) or "y", at an f32
    element offset."""

    kind: str
    off: int = 0

    def at(self, elems: int) -> "Buf":
        return Buf(self.kind, self.off + elems)


@dataclasses.dataclass(frozen=True, eq=False)
class GatherStage:  # kernel A
    vals: torch.Tensor
    pidx: torch.Tensor
    widx: torch.Tensor
    w1: Optional[torch.Tensor]
    n_tiles: int
    out: Buf

    kernel = "gather"

    def out_elems(self) -> int:
        return self.n_tiles * LANE * LANE


@dataclasses.dataclass(frozen=True, eq=False)
class PermuteStage:  # kernel B: a whole permutation, one gather
    src: Buf
    imap: IndexMap
    n: int  # the first n elements of the map's result
    out: Buf

    kernel = "permute"

    def out_elems(self) -> int:
        return self.n


@dataclasses.dataclass(frozen=True, eq=False)
class ReduceStage:  # kernel C
    src: Buf
    imap: IndexMap  # its offsets: the slab rows the groups cover
    mask: Optional[torch.Tensor]
    groups: torch.Tensor
    chunks: torch.Tensor  # its CTAs (reduce_chunks)
    runs: tuple
    out: Buf

    kernel = "perm_reduce"

    def out_elems(self) -> int:
        return self.groups.shape[0] * LANE


@dataclasses.dataclass(frozen=True, eq=False)
class HDenseStage:  # kernel D, or a dense f32 matmul for large blocks
    hdense: torch.Tensor
    target: torch.Tensor
    out: Buf
    part: Optional[Buf] = None  # D's per-CTA sums (the kernel only)

    @property
    def kernel(self):
        return "hdense" if _hdense_in_kernel(self.hdense) else None

    def out_elems(self) -> int:
        return -(-self.hdense.shape[0] // LANE) * LANE


@dataclasses.dataclass(frozen=True, eq=False)
class HeavyStage:  # kernel E: the pooled heavy tiles, added into y
    hvals: torch.Tensor
    hpidx: torch.Tensor
    hwidx: torch.Tensor
    hlo: torch.Tensor
    hhi: torch.Tensor
    slot_ptr: torch.Tensor  # (n_heavy + 1,) int32: heavy row k's slots are
    slot_idx: torch.Tensor  # slot_idx[slot_ptr[k] : slot_ptr[k + 1]]
    rows: torch.Tensor  # (n_heavy,) int32 rows of the domain's y
    part: Buf  # the slot sums per residue quarter (heavy_part_elems)
    out: Buf  # the domain's y
    m: int

    kernel = "heavy"

    def out_elems(self) -> int:
        return self.m


@dataclasses.dataclass(frozen=True, eq=False)
class SmallStage:  # the small kernel: a small domain's A, B, C and output stages
    vals: torch.Tensor  # the gather tiles
    pidx: torch.Tensor
    widx: torch.Tensor
    # the chain's permutations and C's groups composed: row i of y is the
    # sum, in C's order, of the products of the gather slots
    # row_slots[row_ptr[i] : row_ptr[i + 1]]
    row_ptr: torch.Tensor  # (m + 1,) int32
    row_slots: torch.Tensor  # (row_ptr[m],) int32, at most h1*128
    out: Buf  # the domain's y

    kernel = "small"

    def out_elems(self) -> int:
        return self.row_ptr.shape[0] - 1


@dataclasses.dataclass(frozen=True, eq=False)
class ZeroStage:
    out: Buf
    n: int

    kernel = None

    def out_elems(self) -> int:
        return self.n


Stage = Union[GatherStage, PermuteStage, ReduceStage, HDenseStage, HeavyStage, SmallStage,
              ZeroStage]


def small_ok(mat: RoutedCSR) -> bool:
    """The JAX package's test for its one-kernel small domain
    (formats/routed.py::routed_spmv): t <= 4 tiles each way, an output plan
    with more than one tile or a composed wc and no r1, no levels, no heavy
    rows, one static window per gather tile and at most 2 MB of x
    windows."""
    pp, po = mat.perm_products, mat.perm_out
    return (
        len(mat.widx_t) == mat.vals.shape[0] // LANE
        and pp.t <= _SMALL_MAX_T
        and po.t <= _SMALL_MAX_T
        and (po.t > 1 or po.wc is not None)
        and po.r1 is None
        and not mat.lvl_perms
        and mat.hvals is None
        and mat.hdense is None
        and mat.n_windows <= _SMALL_MAX_WINDOWS
    )


def _small_lists(staged) -> Tuple[torch.Tensor, torch.Tensor]:
    """SmallStage's row_ptr and row_slots from the staged chain (gather,
    reduce, zero, output permutation). Gather-slot ids run through W1 give
    each element of A's output the slot whose product it holds (-1: a pad
    tile); C's offsets then give each reduce-slab slot its gather slot, and
    the output map each row of y the output element of C it receives (-1:
    the zeroed assembly tail). C's groups then give row i, at element
    group*128 + lane, its slab rows row0 .. row0 + width - 1 at that lane,
    in C's order; the pad slots are dropped (their zero product leaves a sum
    that starts at +0 as it is). Integer ids throughout."""
    gather, red, _zero, out = staged
    dev = gather.vals.device
    h1 = gather.n_tiles * LANE
    n_real = gather.vals.shape[0] // LANE
    ids = torch.arange(h1 * LANE, dtype=torch.int64, device=dev).reshape(h1, LANE)
    x2 = torch.cat([_w_tiles(ids[: n_real * LANE], gather.w1[: n_real * LANE]),
                    ids.new_full(((gather.n_tiles - n_real) * LANE, LANE), -1)]).reshape(-1)
    off = red.imap.idx.reshape(-1).long()
    slab = torch.where(off >= 0, x2[off.clamp(min=0)], off).cpu().numpy()
    m = out.n
    e = out.imap.idx.reshape(-1)[:m].long().cpu().numpy()
    e = np.where(e < red.groups.shape[0] * LANE, e, -1)
    groups = red.groups.long().cpu().numpy()
    gi = np.where(e >= 0, e // LANE, 0)
    width = np.where(e >= 0, groups[gi, 1], 0)
    rows = np.repeat(np.arange(m), width)
    k = np.arange(rows.shape[0]) - np.repeat(np.cumsum(width) - width, width)
    src = slab[(groups[gi, 0][rows] + k) * LANE + e[rows] % LANE]
    keep = src >= 0
    ptr = np.r_[0, np.cumsum(np.bincount(rows[keep], minlength=m))]
    return (torch.from_numpy(ptr.astype(np.int32)).to(dev),
            torch.from_numpy(src[keep].astype(np.int32)).to(dev))


def heavy_slot_map(hreduce: np.ndarray, device):
    """(slot_ptr, slot_idx) int32 tensors from the (n_heavy, n_tiles*128)
    0/1 slot -> row matrix: heavy row k's slots, in slot order, are
    slot_idx[slot_ptr[k] : slot_ptr[k + 1]]."""
    k, slot = np.nonzero(hreduce)
    ptr = np.r_[0, np.cumsum(np.bincount(k, minlength=hreduce.shape[0]))]
    return (torch.from_numpy(ptr.astype(np.int32)).to(device),
            torch.from_numpy(slot.astype(np.int32)).to(device))


def _reduce_stage(src: Buf, imap: IndexMap, mask, runs, out: Buf, dev) -> ReduceStage:
    """C over the slab rows its groups cover, read through imap."""
    rows = max(row0 + ng * width for row0, ng, width, _g0 in runs)
    imap = dataclasses.replace(imap, idx=imap.idx[:rows])
    return ReduceStage(src, imap, mask, groups_table(runs, dev), reduce_chunks(runs, dev), runs,
                       out)


def _domain_stages(mat: RoutedCSR, y: Buf, alloc, fuse_small: bool = True) -> List[Stage]:
    """The stages of one domain's product, y[0:m] written at y: one
    SmallStage for a small domain (unless fuse_small is False), else the
    staged chain. Each C reads its slab through the offsets of the W stages
    before it (the products domain's SW.W2.SW^-1, W3 and R3 over A's
    output; a level's whole plan over the sums of the level before), and
    the output permutation is one gather."""
    dev = mat.vals.device
    pp, po = mat.perm_products, mat.perm_out
    h1, m = pp.h, mat.shape[0]
    x2, dom = alloc(h1), alloc(po.h)
    # A writes zeros into its pad tiles: C reads their slots as -1
    n_real = mat.vals.shape[0] // LANE
    stages: List[Stage] = [
        GatherStage(mat.vals, mat.pidx, mat.widx, pp.w1, pp.t, x2),
        _reduce_stage(x2, plan_map(pp, "from_w1", src_rows=n_real * LANE), None, mat.runs, dom,
                      dev),
    ]
    level_groups = [_n_groups(mat.runs)] + [_n_groups(r) for r in mat.lvl_runs]
    offs = np.r_[0, np.cumsum(level_groups)]
    for k, (perm, mask, runs) in enumerate(zip(mat.lvl_perms, mat.lvl_masks, mat.lvl_runs)):
        # the JAX package's _perm_reduce_t1 (t = 1), and the levels it runs
        # as W stages and _w3_r3_reduce (t > 1): one launch each
        prev, prev_rows = dom.at(int(offs[k]) * LANE), min(level_groups[k], perm.h)
        stages.append(_reduce_stage(prev, plan_map(perm, src_rows=prev_rows), mask, runs,
                                    dom.at(int(offs[k + 1]) * LANE), dev))
    tail = int(offs[-1])
    n_zero = (po.h - tail) * LANE
    part = None
    if mat.hdense is not None and _hdense_in_kernel(mat.hdense):
        # D's scratch follows the assembly domain: the memset of its tail
        # zeroes D's ticket too
        part = alloc(-(-_hdense_part_elems(mat.hdense) // LANE))
        assert part.off == dom.off + po.h * LANE
        n_zero += 1
    stages.append(ZeroStage(dom.at(tail * LANE), n_zero))
    if mat.hdense is not None:
        target = torch.from_numpy(_heavy_targets(mat)).to(dev)
        stages.append(HDenseStage(mat.hdense, target, dom.at(tail * LANE), part))
    # output permutation; the JAX package applies its W1 to the leading
    # full tiles inside _w3_r3_reduce and to the tail on its own: applying
    # the whole plan once over the assembly domain gives the same y
    stages.append(PermuteStage(dom, plan_map(po), m, y))
    if mat.hvals is not None:
        # heavy rows carry no light nnz: the output permutation left them 0
        slot_ptr, slot_idx = heavy_slot_map(mat.hreduce, dev)
        rows = torch.tensor(mat.heavy_rows, dtype=torch.int32, device=dev)
        stages.append(HeavyStage(mat.hvals, mat.hpidx, mat.hwidx, mat.hlo, mat.hhi, slot_ptr,
                                 slot_idx, rows, alloc(heavy_part_elems(mat.hvals) // LANE), y,
                                 m))
    if fuse_small and small_ok(mat):
        g = stages[0]
        return [SmallStage(g.vals, g.pidx, g.widx, *_small_lists(stages), y)]
    return stages


@dataclasses.dataclass
class RoutedChain:
    """A prepared routed product: the stages over a call's buffers, the
    scratch they need, and (on a CUDA device) their encoded program."""

    mat: Union[RoutedCSR, RoutedChunks]
    stages: Tuple[Stage, ...]
    scratch_elems: int
    shape: Tuple[int, int]
    device: torch.device
    #: per product: the launches of each kernel the stages plan (the
    #: counters hold those the C side made)
    counts: Dict[str, int]
    #: the CUDA program: Programs, a large heavy block's matmul stage
    #: between them
    segments: Tuple = ()

    @property
    def nnz(self) -> int:
        return self.mat.nnz


def _check_domain(mat: RoutedCSR) -> None:
    """Geometry of a prepared domain: what the chain's kernels index with
    (index value ranges come from prepare, or are checked by
    routed_from_jax)."""
    dev = mat.vals.device
    m, n = mat.shape
    pp, po = mat.perm_products, mat.perm_out
    rows_a = mat.vals.shape[0]
    if not mat.runs or rows_a != mat.rows_a or rows_a % LANE or rows_a > pp.h:
        raise ValueError(f"gather rows {rows_a} do not fit the products domain of {pp.h} rows")
    if -(-max(n, 1) // WINDOW_ELEMS) != mat.n_windows:
        raise ValueError(f"{mat.n_windows} windows do not cover {n} columns")
    for name, plan in (("perm_products", pp), ("perm_out", po)):
        _check_plan(plan, name, dev)
        if plan.r1 is not None:
            raise ValueError(f"{name}: its router folds r1 into the lanes it assigns (r1 is None)")
    if po.h * LANE < m:
        raise ValueError(f"the output domain of {po.h} rows does not cover {m} rows")
    levels = [mat.runs, *mat.lvl_runs]
    slab_rows = [pp.h] + [p.h for p in mat.lvl_perms]
    if not len(mat.lvl_perms) == len(mat.lvl_masks) == len(mat.lvl_runs):
        raise ValueError("one perm, mask and runs tuple per level")
    for k, (runs, h) in enumerate(zip(levels, slab_rows)):
        g = 0
        for row0, ng, width, g0 in runs:
            if g0 != g or ng < 1 or not 1 <= width <= LANE or row0 < 0 or row0 + ng * width > h:
                raise ValueError(f"level {k} runs {runs} do not fit its slab of {h} rows")
            g += ng
        if k:
            plan = mat.lvl_perms[k - 1]
            _check_plan(plan, f"lvl_perms[{k - 1}]", dev)
            _require(mat.lvl_masks[k - 1], f"lvl_masks[{k - 1}]", _F32, (plan.h, LANE), dev)
    total = sum(_n_groups(r) for r in levels)
    n_h = 0 if mat.hdense is None else mat.hdense.shape[0]
    if mat.hvals is not None:
        _check_pooled(mat)
    if mat.hdense is not None:
        if len(mat.heavy_lanes) != n_h or len(mat.heavy_rows) != n_h:
            raise ValueError("a dense heavy block needs one placed lane per heavy row")
        if not all(0 <= v < LANE for v in mat.heavy_lanes):
            raise ValueError("heavy_lanes out of range")
        if mat.hdense.shape[1] != -(-n // LANE) * LANE:
            raise ValueError(f"heavy block {tuple(mat.hdense.shape)} for {n} columns")
        _require(mat.hdense, "hdense", (torch.bfloat16,), tuple(mat.hdense.shape), dev)
    if total + -(-n_h // LANE) > po.h:
        raise ValueError(f"{total} sums rows and the heavy rows exceed the output domain")
    _require(mat.vals, "vals", _SLAB_DTYPES, (rows_a, LANE), dev)
    _require(mat.pidx, "pidx", _IDX, (rows_a, LANE), dev)
    _require(mat.widx, "widx", (torch.int32,), (rows_a // LANE,), dev)
    # index values: int8 arrays in [0, 128), windows in [0, n_windows)
    idx = [mat.pidx] + [a for p in (pp, po, *mat.lvl_perms) for a in
                        (p.r1, p.w1, p.w2, p.w3, p.r3, p.wc) if a is not None]
    wins = [mat.widx]
    if mat.hvals is not None:
        idx.append(mat.hpidx)
        wins.append(mat.hwidx)
    if any(bool((a < 0).any()) for a in idx) or \
            any(bool((w < 0).any()) or bool((w >= mat.n_windows).any()) for w in wins):
        raise ValueError("an index array holds values out of range")


def _check_pooled(mat: RoutedCSR) -> None:
    """Geometry of the pooled heavy tiles, and the slot -> row matrix: 0/1,
    at most one row per slot, one matrix row per heavy row."""
    dev = mat.vals.device
    if mat.hdense is not None:
        raise ValueError("heavy rows in both a dense block and pooled tiles")
    rows_h = mat.hvals.shape[0]
    n_h = len(mat.heavy_rows)
    if any(a is None for a in (mat.hpidx, mat.hwidx, mat.hlo, mat.hhi, mat.hreduce)) \
            or rows_h % LANE or rows_h == 0 or n_h == 0:
        raise ValueError("pooled heavy tiles need hvals, hpidx, hwidx, hreduce, hlo and hhi")
    _require(mat.hvals, "hvals", _SLAB_DTYPES, (rows_h, LANE), dev)
    for name in ("hpidx", "hlo", "hhi"):
        _require(getattr(mat, name), name, _IDX, (rows_h, LANE), dev)
    _require(mat.hwidx, "hwidx", (torch.int32,), (rows_h // LANE,), dev)
    hr = np.asarray(mat.hreduce)
    if hr.shape != (n_h, rows_h) or not np.isin(hr, (0.0, 1.0)).all() or (hr.sum(0) > 1).any():
        raise ValueError(f"hreduce must be ({n_h}, {rows_h}) of 0/1, one row per slot at most")
    if not all(0 <= r < mat.shape[0] for r in mat.heavy_rows):
        raise ValueError("heavy_rows out of range")


def _check_plan(plan: PlannedPermutation, name: str, dev) -> None:
    if not (1 <= plan.t <= LANE and LANE % plan.t == 0):
        raise ValueError(f"{name}: bad tile count {plan.t}")
    for f in ("w1", "w2", "w3", "r3", "r1", "wc"):
        a = getattr(plan, f)
        if a is not None:
            _require(a, f"{name}.{f}", _IDX, (plan.h, LANE), dev)
    if plan.t == 1 and plan.wc is None:
        raise ValueError(f"{name}: a one-tile plan carries its composed wc")


def build_chain(mat: Union[RoutedCSR, RoutedChunks], fuse_small: bool = True) -> RoutedChain:
    """Check a prepared matrix once and lay out its product: every domain's
    stages, chunk after chunk into y at its row bound, over one scratch
    buffer that the chunks reuse in turn (the stages run in stream order).
    fuse_small=False plans small domains as the staged chain too (the
    small kernel's A/B)."""
    domains = mat.chunks if isinstance(mat, RoutedChunks) else (mat,)
    bounds = mat.bounds if isinstance(mat, RoutedChunks) else (0, mat.shape[0])
    if len(bounds) != len(domains) + 1 or bounds[0] != 0 or bounds[-1] != mat.shape[0]:
        raise ValueError(f"chunk bounds {bounds} do not cover {mat.shape[0]} rows")
    stages: List[Stage] = []
    scratch = 0
    for dmat, r0, r1 in zip(domains, bounds[:-1], bounds[1:]):
        if dmat.shape != (r1 - r0, mat.shape[1]):
            raise ValueError(f"chunk of shape {dmat.shape} between rows {r0} and {r1}")
        _check_domain(dmat)
        used = [0]

        def alloc(rows: int) -> Buf:
            buf = Buf("s", used[0])
            used[0] += rows * LANE
            return buf

        dstages = _domain_stages(dmat, Buf("y", r0), alloc, fuse_small)
        stages += dstages
        if not isinstance(dstages[0], SmallStage):  # the small kernel needs no scratch
            scratch = max(scratch, used[0])
    dev = domains[0].vals.device
    counts = {k: sum(s.kernel == k for s in stages) for k in _COUNTERS}
    chain = RoutedChain(
        mat=mat, stages=tuple(stages), scratch_elems=scratch, shape=tuple(mat.shape),
        device=dev, counts=counts,
    )
    if dev.type == "cuda":
        chain.segments = tuple(Program(s) if isinstance(s, np.ndarray) else s
                               for s in _encode(chain.stages))
    return chain


def _encode(stages: Sequence[Stage]) -> tuple:
    """The chain as programs: int64 arrays, with a large heavy block's
    matmul stage between two of them."""
    segments, prog = [], []
    for s in stages:
        if isinstance(s, HDenseStage) and s.kernel is None:
            if prog:
                segments.append(np.asarray(prog, dtype=np.int64))
                prog = []
            segments.append(s)
            continue
        if isinstance(s, GatherStage):
            prog += _gather_op(s.vals, s.pidx, s.widx, s.w1, s.n_tiles, s.out)
        elif isinstance(s, PermuteStage):
            prog += _permute_op(s.src, s.imap, s.n, s.out)
        elif isinstance(s, ReduceStage):
            prog += _reduce_op(s.src, s.imap, s.mask, s.groups, s.chunks, s.out)
        elif isinstance(s, HDenseStage):
            prog += _hdense_op(s.hdense, s.target, s.out, s.part)
        elif isinstance(s, HeavyStage):
            prog += _heavy_op(s.hvals, s.hpidx, s.hwidx, s.hlo, s.hhi, s.slot_ptr, s.slot_idx,
                              s.rows, s.part, s.out)
        elif isinstance(s, SmallStage):
            prog += _small_op(s)
        else:
            prog += _op(_OP_ZERO, s.out, s.n * 4)
    if prog:
        segments.append(np.asarray(prog, dtype=np.int64))
    return tuple(segments)


def _view(bufs: Dict[str, torch.Tensor], b: Buf, n: int) -> torch.Tensor:
    return bufs[b.kind][b.off : b.off + n]


def run_stage(stage: Stage, bufs: Dict[str, torch.Tensor], plain: bool) -> None:
    """Run one stage over the buffers {"s": scratch, "x": x, "y": y}: its
    kernel through its wrapper, or with plain=True its plain version (on
    any device)."""
    x = bufs["x"]
    n_out = stage.out_elems()
    out = _view(bufs, stage.out, n_out)
    if isinstance(stage, ZeroStage):
        out.zero_()
    elif isinstance(stage, SmallStage):
        if plain:
            out.copy_(small_reference(stage.vals, stage.pidx, stage.widx, stage.row_ptr,
                                      stage.row_slots, x))
        else:
            routed_small_cuda(stage, x, bufs["y"])
    elif isinstance(stage, HeavyStage):
        args = (stage.hvals, stage.hpidx, stage.hwidx, stage.hlo, stage.hhi, stage.slot_ptr,
                stage.slot_idx)
        if plain:
            out[stage.rows.long()] += heavy_sums_reference(*args, x)
        else:
            routed_heavy_cuda(*args, stage.rows, x, out,
                              _view(bufs, stage.part, heavy_part_elems(stage.hvals)))
    elif isinstance(stage, GatherStage):
        if plain:
            out.copy_(gather_reference(stage.vals, stage.pidx, stage.widx, stage.w1,
                                       stage.n_tiles, x).reshape(-1))
        else:
            routed_gather_cuda(stage.vals, stage.pidx, stage.widx, stage.w1, stage.n_tiles, x, out)
    elif isinstance(stage, PermuteStage):
        src = bufs[stage.src.kind][stage.src.off :]
        if plain:
            out.copy_(permute_reference(src, stage.imap.idx, stage.n))
        else:
            routed_permute_cuda(src, stage.imap, stage.n, out)
    elif isinstance(stage, ReduceStage):
        src = bufs[stage.src.kind][stage.src.off :]
        if plain:
            out.copy_(perm_reduce_reference(src, stage.imap.idx, stage.mask, stage.runs).reshape(-1))
        else:
            routed_perm_reduce_cuda(src, stage.imap, stage.mask, stage.groups, stage.chunks, out)
    elif stage.kernel is None:
        out[stage.target.long()] += _hdense_matmul(stage.hdense, x)
    elif plain:
        out[stage.target.long()] += hdense_reference(stage.hdense, x)
    else:
        routed_hdense_cuda(stage.hdense, x, stage.target, out,
                           _view(bufs, stage.part, _hdense_part_elems(stage.hdense)))


def _buffers(chain: RoutedChain, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    m, n = chain.shape
    _require(x, "x", _F32, (n,), chain.device)
    return {
        "x": x,
        "y": torch.empty(m, dtype=torch.float32, device=x.device),
        "s": torch.empty(chain.scratch_elems, dtype=torch.float32, device=x.device),
    }


def routed_spmv_reference(chain: RoutedChain, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A @ x (f32, length m) over a prepared chain, stage
    by stage with the kernels' plain versions, on any device. The scratch
    starts as NaN, so a stage that read what no stage wrote would show."""
    bufs = _buffers(chain, x)
    bufs["s"].fill_(float("nan"))
    for stage in chain.stages:
        run_stage(stage, bufs, plain=True)
    return bufs["y"]


def routed_chain_spmv(chain: RoutedChain, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (f32, length m) over a prepared chain. CUDA tensors launch
    the whole chain in one call of csrc/routed_spmv.cu (a large heavy
    block's matmul between two calls); CPU tensors take
    routed_spmv_reference. Anything else raises."""
    if _device_of(x) == "cpu":
        return routed_spmv_reference(chain, x)
    m, n = chain.shape
    _require(x, "x", _F32, (n,), chain.device)
    y = torch.empty(m, dtype=torch.float32, device=x.device)
    s = torch.empty(chain.scratch_elems, dtype=torch.float32, device=x.device) \
        if chain.scratch_elems else None
    for seg in chain.segments:
        if isinstance(seg, HDenseStage):
            run_stage(seg, {"x": x, "y": y, "s": s}, plain=False)
        else:
            seg.run(x, y.data_ptr(), 0 if s is None else s.data_ptr(), x.device)
    return y


def staged_stage(stage: Union[PermuteStage, ReduceStage], bufs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """What B or C computes, the W stages it composes applied one by one
    (staged_reference) to its source in the buffers, then for C the mask
    and the run sums: the chain as it ran before its stages were composed.
    Returns the stage's output elements."""
    steps = stage.imap.steps
    src = bufs[stage.src.kind][stage.src.off :]
    src = src[: src.numel() // LANE * LANE].reshape(-1, LANE)
    a = staged_reference(steps, src)
    if isinstance(stage, PermuteStage):
        return a.reshape(-1)[: stage.n]
    g = a[: stage.imap.idx.shape[0]]
    if stage.mask is not None:
        g = g * stage.mask[: g.shape[0]]
    return _reduce_runs(g, stage.runs).reshape(-1)


def compare_stages(chain: RoutedChain, x: torch.Tensor):
    """Each stage's kernel against its plain version on the same inputs: the
    chain runs with the plain versions, and before each stage a copy of the
    buffers runs the stage's kernel. Yields (stage, kernel output, plain
    output, staged output) for every stage that launches a kernel (CUDA
    tensors only); the staged output is staged_stage's for B and C, else
    None."""
    bufs = _buffers(chain, x)
    bufs["s"].fill_(float("nan"))
    for stage in chain.stages:
        staged = None
        if stage.kernel is not None:
            copy = {k: v.clone() for k, v in bufs.items()}
            run_stage(stage, copy, plain=False)
            if isinstance(stage, (PermuteStage, ReduceStage)):
                staged = staged_stage(stage, bufs)
        run_stage(stage, bufs, plain=True)
        if stage.kernel is not None:
            n = stage.out_elems()
            yield stage, _view(copy, stage.out, n), _view(bufs, stage.out, n), staged


def stored_csr(csr, chain: RoutedChain):
    """csr with its values as the prepared layout stores them: a dense
    heavy block's rows rounded to bf16 (as prepare rounds them, through
    f32); the light rows and the pooled heavy tiles' rows at the gather
    values' type (rounded to bf16 in the bf16 mode, exact in the f32 mode).
    The f64 oracle on this matrix is what a routed product should match;
    its gap to the exact matrix is a property of the layout."""
    from ..formats.matrix import CSRMatrix

    mats = chain.mat.chunks if isinstance(chain.mat, RoutedChunks) else (chain.mat,)
    bounds = chain.mat.bounds if isinstance(chain.mat, RoutedChunks) else (0, csr.shape[0])
    data = np.asarray(csr.data, dtype=np.float64).copy()
    lens = np.diff(csr.indptr)

    def bf16(rows, via):
        sel = np.repeat(rows, lens)
        data[sel] = torch.from_numpy(data[sel].astype(via)).to(torch.bfloat16).double().numpy()

    for mat, r0, r1 in zip(mats, bounds[:-1], bounds[1:]):
        dense = np.zeros(csr.shape[0], dtype=bool)
        if mat.hdense is not None:
            dense[np.asarray(mat.heavy_rows, dtype=np.int64) + r0] = True
        bf16(dense, np.float32)
        if mat.vals.dtype == torch.bfloat16:
            rest = np.zeros(csr.shape[0], dtype=bool)
            rest[r0:r1] = True
            bf16(rest & ~dense, np.float64)
    return CSRMatrix(shape=csr.shape, indptr=csr.indptr, indices=csr.indices, data=data)


def routed_spmv(mat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a prepared RoutedCSR or RoutedChunks (builds its chain;
    build the chain once with build_chain, or prepare_routed_chain, for
    repeated products) or over a chain."""
    if not isinstance(mat, RoutedChain):
        mat = build_chain(mat)
    return routed_chain_spmv(mat, x)


def prepare_routed_chain(csr, dtype=torch.float32, vals_dtype=None, device="cuda") -> RoutedChain:
    """prepare_routed_auto, then build_chain: the operands of the routed
    modes and of AutoSpMV, on the card unless the caller passes
    device="cpu"."""
    return build_chain(
        prepare_routed_auto(csr, dtype=dtype, vals_dtype=vals_dtype, device=device)
    )


# ---------------------------------------------------------------------------
# Prepared state from the JAX package
# ---------------------------------------------------------------------------


def _plan_from_jax(plan, device) -> PlannedPermutation:
    """plan: a dict (or object) of numpy stage arrays r1, w1, w2, w3, r3, wc
    and the int t."""
    get = plan.get if isinstance(plan, dict) else lambda k: getattr(plan, k)
    arrays = {f: None if get(f) is None else _to_tensor(get(f), device)
              for f in ("r1", "w1", "w2", "w3", "r3", "wc")}
    return PlannedPermutation(t=int(get("t")), **arrays)


def _pooled_from_jax(hvals, hpidx, hwidx, hreduce, hlo, hhi, device) -> dict:
    """The pooled heavy tiles' fields, with the bounds kernel E sums
    between checked: hlo and hhi in [-1, 128), every run (hlo, hhi] of a
    residue nonempty and disjoint from the others (_check_pooled checks the
    rest, as for a prepared layout)."""
    if hlo is None or hhi is None:
        raise ValueError(
            "pooled heavy tiles without hlo/hhi are the JAX package's legacy owner layout, "
            "on the do-not-port list (ROADMAP.md queue 1)"
        )
    hlo, hhi = np.asarray(hlo), np.asarray(hhi)
    if min(hlo.min(initial=0), hhi.min(initial=0)) < -1:
        raise ValueError("hlo/hhi out of range")  # int8: max is < 128
    lo, hi = hlo.astype(np.int64), hhi.astype(np.int64)
    used = hi >= 0
    if (lo[~used] != -1).any() or (lo[used] >= hi[used]).any():
        raise ValueError("hlo/hhi: a slot's run (hlo, hhi] must be nonempty, or both -1")
    # runs of one residue row are disjoint: no lane is covered twice
    cover = np.zeros((hi.shape[0], LANE + 1), dtype=np.int64)
    r = np.nonzero(used)[0]
    np.add.at(cover, (r, lo[used] + 1), 1)
    np.add.at(cover, (r, hi[used] + 1), -1)
    if (np.cumsum(cover, axis=1) > 1).any():
        raise ValueError("hlo/hhi: the runs of a residue overlap")
    return dict(
        hvals=_to_tensor(hvals, device), hpidx=_to_tensor(hpidx, device),
        hwidx=_to_tensor(np.asarray(hwidx).astype(np.int32), device),
        hreduce=np.asarray(hreduce, dtype=np.float32),
        hlo=_to_tensor(hlo, device), hhi=_to_tensor(hhi, device),
    )


def routed_from_jax(
    vals, pidx, widx, perm_products, lvl_perms, lvl_masks, perm_out, shape, nnz: int,
    n_windows: int, rows_a: int, runs, lvl_runs, out_t: int, hdense=None, heavy_rows=(),
    widx_t=(), heavy_lanes=(), hvals=None, hpidx=None, hwidx=None, hreduce=None, hlo=None,
    hhi=None, device="cuda",
) -> RoutedCSR:
    """The port's RoutedCSR from the JAX package's prepared RoutedCSR, given
    as numpy arrays (bf16 bit for bit) and its static fields, on `device`
    (the card unless the caller passes device="cpu"); each plan is a dict
    (or object) of numpy stage arrays and t. Validates the index ranges the
    kernels read with and the geometry (as build_chain does), the pooled
    heavy tiles (hvals, hpidx, hwidx, hreduce, hlo, hhi) included."""
    device = target_device(device)
    pooled = {} if hvals is None else _pooled_from_jax(hvals, hpidx, hwidx, hreduce, hlo, hhi,
                                                         device)
    masks = []
    for mk in lvl_masks:
        mk = np.asarray(mk, dtype=np.float32)
        if not np.isin(mk, (0.0, 1.0)).all():
            raise ValueError("level masks hold 0 or 1")
        masks.append(_to_tensor(mk, device))
    mat = RoutedCSR(
        vals=_to_tensor(vals, device),
        pidx=_to_tensor(pidx, device),
        widx=_to_tensor(np.asarray(widx).astype(np.int32), device),
        perm_products=_plan_from_jax(perm_products, device),
        lvl_perms=tuple(_plan_from_jax(p, device) for p in lvl_perms),
        lvl_masks=tuple(masks),
        perm_out=_plan_from_jax(perm_out, device),
        shape=tuple(int(d) for d in shape),
        nnz=int(nnz),
        n_windows=int(n_windows),
        rows_a=int(rows_a),
        runs=tuple(tuple(int(v) for v in r) for r in runs),
        lvl_runs=tuple(tuple(tuple(int(v) for v in r) for r in lr) for lr in lvl_runs),
        out_t=int(out_t),
        hdense=None if hdense is None else _to_tensor(hdense, device),
        heavy_rows=tuple(int(r) for r in heavy_rows),
        widx_t=tuple(int(v) for v in widx_t),
        heavy_lanes=tuple(int(v) for v in heavy_lanes),
        **pooled,
    )
    if mat.out_t != mat.perm_out.t:
        raise ValueError(f"out_t {mat.out_t} != perm_out.t {mat.perm_out.t}")
    _check_domain(mat)
    return mat


def routed_chunks_from_jax(chunks: Sequence[dict], bounds, shape, nnz: int,
                           device="cuda") -> RoutedChunks:
    """The chunked form: one routed_from_jax keyword set per chunk, on
    `device` (the card unless the caller passes device="cpu")."""
    device = target_device(device)
    out = RoutedChunks(
        chunks=tuple(routed_from_jax(**c, device=device) for c in chunks),
        bounds=tuple(int(b) for b in bounds), shape=tuple(int(d) for d in shape), nnz=int(nnz),
    )
    build_chain(out)  # checks the chunk bounds against the chunks
    return out


# ---------------------------------------------------------------------------
# Double-float (float64) engine
# ---------------------------------------------------------------------------
#
# A df product is a program of csrc/df_spmv.cu, built once per prepared
# matrix (build_df_chain) and enqueued by its routed_df_chain_launch in one
# host call: per domain C-df per level (level 0 forms K3's df products of
# the gather tiles where it sums them, from each slab slot's value pair and
# x column composed at build time, and closes a one-tile level after it in
# its last CTAs; a later level reads each slab slot through one composed
# offset); then one output gather of every domain into f64 y; then per
# domain D-df for the dense heavy rows (x split in it). The scratch (f32)
# holds each domain's level sums as (hi, lo) pairs side by side in a region
# of its own, then D-df's CTA sums; y is f64. Every step adds the
# plain versions' pairs in their order, so y is bit for bit the staged plain
# chain's (routed_df_staged_reference: the W stages one by one,
# reduce_runs_df, df_dense_rowdot).

#: D-df: threads per CTA at most, residues a thread owns, the columns of a
#: residue summed per static subtree (the plan's aim: x split once per CTA
#: for its rows), the most columns a residue has (2^_ROWDOT_LEVELS), rows
#: per CTA at most, CTAs per row tile at most (two closing steps of
#: _ROWDOT_STREAM), the pairs a closing thread streams and the CTAs a
#: launch aims at (csrc/df_spmv.cu kRowdotCta, kRowdotVec, kRowdotBlock,
#: kRowdotLevels, kRowdotTile, kMaxRowdotGroups, kRowdotStream)
_ROWDOT_CTA = 256
_ROWDOT_VEC = 4
_ROWDOT_BLOCK = 4
_ROWDOT_LEVELS = 15
_ROWDOT_TILE = 4
_ROWDOT_MAX_GROUPS = 256
_ROWDOT_STREAM = 16
_ROWDOT_CTAS = 256


def routed_df_gather_reference(vals, vals_lo, pidx, widx, n_tiles: int, xh, xl) -> dfloat.Pair:
    """Plain K3 (the JAX package's _gather_products_df, padded to n_tiles
    tiles): (n_tiles*128, 128) (hi, lo) products (vals, vals_lo) * x at
    widx[i]*16384 + pidx*128 + s, no W1; tiles from n_real on are zero."""
    n_real = vals.shape[0] // LANE
    nwin = max(-(-xh.shape[0] // WINDOW_ELEMS), 1)
    s = torch.arange(LANE, device=xh.device).repeat(n_real)
    wrow = widx.long().repeat_interleave(LANE) * LANE + s
    gh, gl = (torch.gather(pack_x_windows_flat(xs, nwin)[wrow], 1, pidx.long()) for xs in (xh, xl))
    ph, pe = dfloat.two_prod(vals, gh)
    pl = pe + (vals * gl + vals_lo * gh)
    pad = ph.new_zeros((n_tiles - n_real) * LANE, LANE)
    return torch.cat([ph, pad]), torch.cat([pl, pad])


@dataclasses.dataclass(frozen=True, eq=False)
class DFReduce:
    """The JAX package's _reduce_runs_df over one slab, vectorised: the
    `width` rows of every output group, zero-padded to a power of two and
    laid out by padded size, largest first (so each group starts at a
    multiple of its size), are summed by rounds of adjacent-pair TwoSums over
    the whole layout. A +0 pair adds nothing to a sum that is not an exact
    zero, so each group's sum is the JAX package's pairwise tree over its
    rows; an all-zero sum may differ from it in the sign of a zero word."""

    idx: torch.Tensor  # (layout rows,) int64: slab row, or h for a zero row
    active: Tuple[int, ...]  # per round: the leading rows that pair up
    inv: torch.Tensor  # (n_groups,) int64: layout row of output group g


def df_reduce_plan(runs, h: int, device) -> DFReduce:
    """The DFReduce of runs (row0, n_groups, width, g0) over an h-row slab."""
    rows0, widths = [], []
    for row0, ng, width, _g0 in runs:
        rows0 += [row0 + j * width for j in range(ng)]
        widths += [width] * ng
    sizes = np.array([1 << (int(w) - 1).bit_length() for w in widths], dtype=np.int64)
    order = np.argsort(-sizes, kind="stable")
    idx = []
    for g in order:
        rows = np.full(int(sizes[g]), h, dtype=np.int64)
        rows[: widths[g]] = rows0[g] + np.arange(widths[g])
        idx.append(rows)
    cur = sizes[order]
    active = []
    while cur.max(initial=1) > 1:
        active.append(int(cur[cur > 1].sum()))
        cur = np.maximum(cur // 2, 1)
    inv = np.empty(len(order), dtype=np.int64)
    inv[order] = np.arange(len(order))
    return DFReduce(
        idx=torch.from_numpy(np.concatenate(idx)).to(device), active=tuple(active),
        inv=torch.from_numpy(inv).to(device),
    )


def reduce_runs_df(sh, sl, plan: DFReduce, mask=None) -> dfloat.Pair:
    """(n_groups, 128) (hi, lo) group sums of the slab pair (sh, sl), masked
    first when mask is given."""
    if mask is not None:
        sh, sl = sh * mask, sl * mask
    zero = sh.new_zeros(1, LANE)
    h = torch.cat([sh, zero]).index_select(0, plan.idx)
    lo = torch.cat([sl, zero]).index_select(0, plan.idx)
    for a in plan.active:
        ph, pl = dfloat.df_add(h[0:a:2], lo[0:a:2], h[1:a:2], lo[1:a:2])
        h, lo = torch.cat([ph, h[a:]]), torch.cat([pl, lo[a:]])
    return h.index_select(0, plan.inv), lo.index_select(0, plan.inv)


def df_perm_reduce_reference(src_h, src_l, off, mask, runs, tree: Optional[DFReduce] = None) -> dfloat.Pair:
    """Plain C-df: the (n_groups, 128) (hi, lo) group sums of runs (row0,
    n_groups, width, g0) over the slab read from the planes (src_h, src_l)
    through the offsets off ((rows, 128), -1 reading +0), masked first where
    mask is given: reduce_runs_df (tree: its plan over the rows, made here
    when not given)."""
    rows = off.shape[0]
    sh, sl = (permute_reference(src, off, off.numel()).reshape(rows, LANE) for src in (src_h, src_l))
    tree = df_reduce_plan(runs, rows, off.device) if tree is None else tree
    return reduce_runs_df(sh, sl, tree, None if mask is None else mask[:rows])


def gather_reduce_operands(vals, vals_lo, pidx, widx, off) -> Tuple[torch.Tensor, torch.Tensor]:
    """C-df level 0's operands: K3's composed through the offsets off ((rows,
    128) into K3's products, -1: +0; an offset past the real gather tiles
    names a zero pad tile). Each slab slot's (hi, lo) value pair,
    (rows, 128, 2) f32, and its x column, (rows, 128) int32: K3's widx[tile]
    * 16384 + pidx * 128 + s of the product the offset names; a slot whose
    offset is -1 or names a pad tile gets the pair (+0, +0) and column -1,
    whose product is the +0 pair it read before (a slot of a real tile keeps
    its value and column, even a zero value or a column past x's end, whose
    product may carry a -0 word)."""
    o = off.reshape(-1).long()
    live = (o >= 0) & (o < vals.numel())  # past the real tiles: K3's zero pad tiles
    e = torch.where(live, o, torch.zeros_like(o))
    tile = e // WINDOW_ELEMS
    col = widx.long()[tile] * WINDOW_ELEMS + pidx.reshape(-1)[e].long() * LANE + (e // LANE) % LANE
    zero = vals.new_zeros(())
    pairs = torch.stack([torch.where(live, vals.reshape(-1)[e], zero),
                         torch.where(live, vals_lo.reshape(-1)[e], zero)], -1)
    cols, _span = _int32_offsets(torch.where(live, col, torch.full_like(col, -1)))
    return pairs.reshape(*off.shape, 2).contiguous(), cols.reshape(off.shape)


def gather_reduce_products(vals, cols, x: torch.Tensor) -> dfloat.Pair:
    """Plain C-df level 0's slab: each slot's (hi, lo) product of its value
    pair and x (f64, split as dfloat.split_f64_t splits it) at its column (x
    zero outside [0, len(x))), K3's arithmetic."""
    xh, xl = dfloat.split_f64_t(x)
    c = cols.long()
    ok = (c >= 0) & (c < x.shape[0])
    c = c.clamp(0, max(x.shape[0] - 1, 0))
    zero = xh.new_zeros(())
    gh, gl = torch.where(ok, xh[c], zero), torch.where(ok, xl[c], zero)
    vh, vl = vals[..., 0], vals[..., 1]
    ph, pe = dfloat.two_prod(vh, gh)
    return ph, pe + (vh * gl + vl * gh)


def df_gather_reduce_reference(vals, cols, x, runs, tree: Optional[DFReduce] = None) -> dfloat.Pair:
    """Plain C-df level 0: the (n_groups, 128) (hi, lo) group sums of runs
    over the products gather_reduce_products forms (reduce_runs_df; tree: its
    plan over the rows, made here when not given). Bit for bit K3's plain
    version followed by df_perm_reduce_reference through the offsets the
    operands were composed from."""
    ph, pl = gather_reduce_products(vals, cols, x)
    tree = df_reduce_plan(runs, cols.shape[0], cols.device) if tree is None else tree
    return reduce_runs_df(ph, pl, tree)


#: C-df: warps per CTA, rows of a block of a wider group and the CTA-sets of
#: a level closed by level 0's last CTAs at most (csrc/df_spmv.cu
#: kReduceWarps, kBlockRows, kMaxCloseSets)
_DF_REDUCE_WARPS = 4
_DF_BLOCK_ROWS = 32
_DF_CLOSE_SETS = 32


def df_reduce_tasks(chunks: torch.Tensor) -> torch.Tensor:
    """C-df's warp tasks (n_sets * 4, 4) int32 (chunk, band, block, blocks):
    per chunk and band of 32 lanes one task, or, for a chunk wider than 32
    rows (one group, reduce_chunks), one per aligned block of 32 rows, the
    group's blocks in consecutive warps of one CTA-set of _DF_REDUCE_WARPS
    (its block sums are added there); sets packed in order, idle warps
    (-1, 0, 0, 0)."""
    out, cur = [], []
    for c, (r0, r1, _g0, _g1) in enumerate(chunks.cpu().tolist()):
        nb = 1 if r1 - r0 <= _DF_BLOCK_ROWS else -(-(r1 - r0) // _DF_BLOCK_ROWS)
        for band in range(LANE // 32):
            group = [(c, band, j, nb) for j in range(nb)]
            if len(cur) + nb > _DF_REDUCE_WARPS:
                out += cur + [(-1, 0, 0, 0)] * (_DF_REDUCE_WARPS - len(cur))
                cur = []
            cur += group
    out += cur + [(-1, 0, 0, 0)] * (-len(cur) % _DF_REDUCE_WARPS)
    return torch.tensor(out, dtype=torch.int32).reshape(-1, 4).to(chunks.device)


def df_permute_reference(src_h, src_l, idx, n: int) -> torch.Tensor:
    """Plain output gather: (n,) f64, both planes read through idx (-1: +0)
    and combined as hi + lo (df_combine64)."""
    return dfloat.df_combine64(permute_reference(src_h, idx, n), permute_reference(src_l, idx, n))


def df_dense_rowdot(hh, hl, xh, xl) -> dfloat.Pair:
    """(n_h,) (hi, lo) row sums of a dense (hi, lo) block times an (hi, lo)
    vector (x zero past its length): TwoProduct and cross terms, columns
    padded to a power of two, then the halves added by TwoSum (the JAX
    package's _df_dense_rowdot)."""
    ph, pl, p2 = _rowdot_products(hh, hl, xh, xl)
    while p2 > 1:
        half = p2 // 2
        s, e = dfloat.two_sum(ph[:, :half], ph[:, half:p2])
        pl = pl[:, :half] + pl[:, half:p2] + e
        ph, p2 = s, half
    return ph[:, 0], pl[:, 0]


def _rowdot_products(hh, hl, xh, xl):
    """The (hi, lo) products of the block and x, the columns padded with +0
    pairs to p2, the power of two of the block's width; and p2."""
    n = hh.shape[1]
    xh = torch.nn.functional.pad(xh, (0, n - xh.shape[0]))
    xl = torch.nn.functional.pad(xl, (0, n - xl.shape[0]))
    ph, pe = dfloat.two_prod(hh, xh[None, :])
    pl = pe + (hh * xl[None, :] + hl * xh[None, :])
    p2 = 1 << (n - 1).bit_length()
    return (torch.nn.functional.pad(ph, (0, p2 - n)), torch.nn.functional.pad(pl, (0, p2 - n)), p2)


def _bit_reversed(k: int) -> torch.Tensor:
    bits = k.bit_length() - 1
    return torch.tensor([int(format(j, f"0{bits}b")[::-1], 2) if bits else 0 for j in range(k)])


def df_rowdot_reference(hh, hl, xh, xl, threads: int) -> dfloat.Pair:
    """Plain D-df in the kernel's decomposition over `threads` residues per
    row (a power of two, at most p2): residue p owns the padded columns p +
    threads*k; its columns are summed by adjacent-pair rounds over k in
    bit-reversed order (the order the kernel's stack of partial sums adds
    them), then the residues' sums by the halving tree over p. Bit for bit
    df_dense_rowdot for every such count."""
    ph, pl, p2 = _rowdot_products(hh, hl, xh, xl)
    if threads < 1 or threads & (threads - 1) or threads > p2:
        raise ValueError(f"{threads} threads per row for {p2} padded columns")
    rev = _bit_reversed(p2 // threads).to(hh.device)
    h = ph.reshape(ph.shape[0], -1, threads).index_select(1, rev)
    lo = pl.reshape(pl.shape[0], -1, threads).index_select(1, rev)
    while h.shape[1] > 1:
        h, lo = dfloat.df_add(h[:, 0::2], lo[:, 0::2], h[:, 1::2], lo[:, 1::2])
    h, lo = h[:, 0], lo[:, 0]
    while h.shape[1] > 1:
        half = h.shape[1] // 2
        h, lo = dfloat.df_add(h[:, :half], lo[:, :half], h[:, half:], lo[:, half:])
    return h[:, 0], lo[:, 0]


@dataclasses.dataclass(frozen=True)
class RowdotPlan:
    """D-df's launch over an n_pad-column block: `threads` residues per row
    (four a thread, `cta` threads a CTA, `groups` CTAs per tile of `tile`
    rows), each of 2^log_k columns."""

    threads: int
    cta: int
    log_k: int
    groups: int = 1
    tile: int = 1


def rowdot_plan(n_pad: int, n_h: int = 1) -> RowdotPlan:
    """The D-df launch of n_h heavy rows of a block n_pad columns wide (a
    multiple of 128): CTAs of 256 threads (fewer where the padded width p2
    is less than 1024 columns), as many per tile (up to 256) as leave each
    residue 4 columns (one static subtree: x split once per CTA for all its
    rows), tiles of up to 4 rows, as few as make about 256 CTAs in all;
    where tiles of one row still make fewer, more CTAs per tile (down to one
    column per residue). Each thread a quad of residues of p2 / threads
    columns each."""
    if n_pad < LANE or n_pad % LANE:
        raise ValueError(f"a heavy block of {n_pad} columns is not whole 128-column tiles")
    if n_h < 1:
        raise ValueError(f"{n_h} heavy rows")
    p2 = 1 << (n_pad - 1).bit_length()
    cta = min(_ROWDOT_CTA, p2 // _ROWDOT_VEC)

    def more(groups, block):  # room for twice the CTAs, each residue block columns
        return 2 * groups * cta * _ROWDOT_VEC * block <= p2 and 2 * groups <= _ROWDOT_MAX_GROUPS

    groups = 1
    while more(groups, _ROWDOT_BLOCK):
        groups *= 2
    tiles = max(-(-n_h // _ROWDOT_TILE), min(n_h, _ROWDOT_CTAS // groups))
    while tiles * groups < _ROWDOT_CTAS and more(groups, 1):
        groups *= 2
    threads = cta * _ROWDOT_VEC * groups
    log_k = (p2 // threads).bit_length() - 1
    if log_k > _ROWDOT_LEVELS:
        raise ValueError(f"a heavy block of {n_pad} columns exceeds D-df's {2**_ROWDOT_LEVELS} "
                         "columns per residue")
    return RowdotPlan(threads, cta, log_k, groups, -(-n_h // tiles))


def _rowdot_closers(plan: RowdotPlan) -> int:
    """S: the CTAs of a tile that close its first step (each the last of the
    up to 16 that share g % S), whose sums the last of them adds."""
    return plan.groups // min(plan.groups, _ROWDOT_STREAM)


def _rowdot_part_elems(plan: RowdotPlan, n_h: int) -> int:
    """D-df's scratch (f32): each (row, CTA)'s 128 (hi, lo) pairs, then each
    (row, first-step closer)'s."""
    return n_h * LANE * (plan.groups + _rowdot_closers(plan)) * 2


def _rowdot_ticket_words(plan: RowdotPlan, n_h: int) -> int:
    """D-df's tickets: S + 1 int32 words per row tile."""
    return -(-n_h // plan.tile) * (_rowdot_closers(plan) + 1)


def _rowdot_tickets(n_h: int, plan: RowdotPlan, device) -> torch.Tensor:
    """D-df's tickets as zeros, which the kernel sets back to zero (kept
    with the stage, not in the per-call scratch)."""
    return torch.zeros(_rowdot_ticket_words(plan, n_h), dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class DFGatherReduceStage:  # C-df level 0: K3's products formed where they are summed
    vals: torch.Tensor  # (rows, 128, 2) f32: each slab slot's (hi, lo) value
    cols: torch.Tensor  # (rows, 128) int32: its x column (-1: the slot reads nothing)
    imap: IndexMap  # the offsets into K3's products they were composed from (on the host)
    groups: torch.Tensor
    chunks: torch.Tensor  # reduce_chunks
    tasks: torch.Tensor  # its warps' tasks (df_reduce_tasks)
    runs: tuple
    tree: DFReduce  # the plain version's plan over the slab rows
    out: Buf  # (hi, lo) pairs
    tail: Optional["DFReduceStage"]  # the one-tile level after it, closed by its last CTAs
    ticket: torch.Tensor  # (2,) int32 zeros: the closing CTAs' counters

    kernel = "df_gather_reduce"

    def out_elems(self) -> int:
        return self.groups.shape[0] * LANE


@dataclasses.dataclass(frozen=True, eq=False)
class DFReduceStage:  # C-df of a later level
    src: Buf  # (hi, lo) pairs
    imap: IndexMap  # its offsets, in pairs: the slab rows the groups cover
    mask: Optional[torch.Tensor]
    groups: torch.Tensor
    chunks: torch.Tensor  # reduce_chunks
    tasks: torch.Tensor  # its warps' tasks (df_reduce_tasks)
    runs: tuple
    tree: DFReduce  # the plain version's plan over the slab rows
    out: Buf  # (hi, lo) pairs

    kernel = "df_reduce"

    def out_elems(self) -> int:
        return self.groups.shape[0] * LANE


@dataclasses.dataclass(frozen=True, eq=False)
class DFPermuteStage:  # the output gather: every domain's pairs into f64 y
    src: Buf  # (hi, lo) pairs: the scratch from its start
    imap: IndexMap  # every domain's output map composed (_output_map)
    n: int  # the first n elements of the map's result: y's rows
    out: Buf  # y at row 0

    kernel = "df_permute"

    def out_elems(self) -> int:
        return self.n


@dataclasses.dataclass(frozen=True, eq=False)
class DFRowdotStage:  # D-df: the dense heavy rows, written into y
    hh: torch.Tensor
    hl: torch.Tensor
    rows: torch.Tensor  # (n_heavy,) int32 rows of the domain's y
    plan: RowdotPlan
    n_x: int
    part: Buf  # the CTAs' sums (_rowdot_part_elems)
    tickets: torch.Tensor  # (_rowdot_tickets)
    out: Buf  # y at the domain's first row

    kernel = "df_rowdot"


DFStage = Union[DFGatherReduceStage, DFReduceStage, DFPermuteStage, DFRowdotStage]

# Programs of csrc/df_spmv.cu::routed_df_chain_launch, the one entry point of
# the routed df kernels; operands as for routed_chain_launch, a Buf's offset
# in bytes of its buffer's type (scratch f32, y f64)
_DF_OP_REDUCE, _DF_OP_GATHER_REDUCE, _DF_OP_PERMUTE, _DF_OP_ROWDOT = range(1, 5)


def _df_op(code: int, *args) -> List[int]:
    return [code] + [(_TAGS[a.kind] << 56) | (a.off * (8 if a.kind == "y" else 4))
                     if isinstance(a, Buf) else _operand(a) for a in args]


def _df_level(src, imap: IndexMap, mask, groups, chunks, tasks, out) -> list:
    return [_aligned(src, 8), imap.idx, mask, _aligned(groups, 8), _aligned(chunks, 16),
            _aligned(tasks, 16), tasks.shape[0], _aligned(out, 8)]


def _df_reduce_op(src, imap: IndexMap, mask, groups, chunks, tasks, out) -> List[int]:
    return _df_op(_DF_OP_REDUCE, *_df_level(src, imap, mask, groups, chunks, tasks, out))


def _df_gather_reduce_op(vals, cols, groups, chunks, tasks, out, tail, ticket) -> List[int]:
    """Level 0's operands, then the closed level's (src imap mask groups
    chunks tasks out, or None: none) and the ticket."""
    closed = _df_level(*tail) if tail is not None else [None] * 6 + [0, None]
    return _df_op(_DF_OP_GATHER_REDUCE, _aligned(vals, 8), cols, _aligned(groups, 8),
                  _aligned(chunks, 16), _aligned(tasks, 16), tasks.shape[0], _aligned(out, 8),
                  *closed, ticket if tail is not None else None)


def _df_permute_op(src, imap: IndexMap, n: int, y) -> List[int]:
    return _df_op(_DF_OP_PERMUTE, _aligned(src, 8), imap.idx, n, y)


def _df_rowdot_op(hh, hl, rows, plan: RowdotPlan, part, tickets, y) -> List[int]:
    return _df_op(_DF_OP_ROWDOT, _aligned(hh, 16), _aligned(hl, 16), rows, y, hh.shape[0],
                  hh.shape[1], plan.log_k, plan.cta, plan.groups, plan.tile, _aligned(part, 8),
                  tickets)


def _df_stage_op(s: DFStage) -> List[int]:
    if isinstance(s, DFGatherReduceStage):
        t = s.tail
        tail = None if t is None else (t.src, t.imap, t.mask, t.groups, t.chunks, t.tasks, t.out)
        return _df_gather_reduce_op(s.vals, s.cols, s.groups, s.chunks, s.tasks, s.out, tail,
                                    s.ticket)
    if isinstance(s, DFReduceStage):
        return _df_reduce_op(s.src, s.imap, s.mask, s.groups, s.chunks, s.tasks, s.out)
    if isinstance(s, DFPermuteStage):
        return _df_permute_op(s.src, s.imap, s.n, s.out)
    return _df_rowdot_op(s.hh, s.hl, s.rows, s.plan, s.part, s.tickets, s.out)


class DFProgram(Program):
    """A program of csrc/df_spmv.cu::routed_df_chain_launch, made once."""

    @staticmethod
    def _counter_fns():
        return _DF_COUNTER_FNS

    def run(self, x: Optional[torch.Tensor], y: int, scratch: int, dev: torch.device) -> None:
        """Enqueue the program on dev's current stream (x: f64); the
        counters gain the launches the C side made; an error raises."""
        rc = dfloat.df_lib().routed_df_chain_launch(
            self._addr[0], self.words.shape[0], 0 if x is None else x.data_ptr(),
            0 if x is None else x.shape[0], y, scratch, self._addr[1], cuda_lib.current_stream(dev),
        )
        _drain(self.counts, self._counter_fns())
        dfloat.check_launch(rc, "routed df kernels")


def _check_f64_out(y, n: int, dev) -> None:
    if y.device != dev or y.dtype != torch.float64 or y.dim() != 1 or not y.is_contiguous() \
            or y.numel() < n:
        raise ValueError(f"y must be a contiguous 1-d f64 tensor of >= {n} elements on {dev}")


def _check_rowdot(hh, hl, rows, plan: RowdotPlan, x, y) -> None:
    dev = x.device
    n_h, n_pad = hh.shape
    _require(hh, "hh", _F32, (n_h, n_pad), dev)
    _require(hl, "hl", _F32, (n_h, n_pad), dev)
    _require(rows, "rows", _I32, (n_h,), dev)
    _require(x, "x", (torch.float64,), (x.shape[0],), dev)
    if n_h < 1 or plan != rowdot_plan(n_pad, n_h):
        raise ValueError(f"D-df plan {plan} for a heavy block {tuple(hh.shape)}")
    _check_f64_out(y, 1, dev)


def _check_pairs(t, name: str, n: int, dev) -> None:
    """A contiguous f32 buffer of >= n (hi, lo) pairs side by side."""
    if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() or t.numel() < 2 * n:
        raise ValueError(f"{name} must be a contiguous f32 tensor of >= {n} (hi, lo) pairs on {dev}")


def _check_ticket(t, n: int, dev) -> None:
    if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous() or t.numel() < n:
        raise ValueError(f"the tickets must be a contiguous int32 tensor of >= {n} zeros on {dev}")


def _closable(imap: IndexMap, tasks: torch.Tensor) -> bool:
    """Whether level 0's last CTAs may close this level: one tile (at most
    128 slab rows) of at most _DF_CLOSE_SETS CTA-sets (its closers wait for
    the other CTAs at once, so they must be few beside the card's CTA
    slots)."""
    return imap.idx.shape[0] <= LANE and tasks.shape[0] <= _DF_CLOSE_SETS * _DF_REDUCE_WARPS


def _df_tasks(chunks, tasks, dev) -> torch.Tensor:
    tasks = df_reduce_tasks(chunks) if tasks is None else tasks
    _require(tasks, "tasks", _I32, (tasks.shape[0], 4), dev)
    if tasks.shape[0] % _DF_REDUCE_WARPS:
        raise ValueError(f"{tasks.shape[0]} C-df tasks are not whole CTA-sets")
    return tasks


def routed_df_reduce_cuda(src, imap: IndexMap, mask, groups, chunks, out,
                          tasks=None) -> torch.Tensor:
    """C-df of a later level (routed_df_reduce_kernel) into out (n_groups*128
    (hi, lo) pairs): the df group sums of the slab read from the pairs src
    through imap.idx's rows, masked where mask is given; groups and chunks as
    for kernel C (groups_table, reduce_chunks), tasks df_reduce_tasks(chunks)
    (made here, with a copy to the host, when not given)."""
    dev = _on_cuda(src, imap.idx, mask, groups, chunks, out, tasks)
    _check_pairs(src, "src", imap.span, dev)
    _check_perm_reduce(src, imap, mask, groups, chunks, None)
    _check_pairs(out, "out", groups.shape[0] * LANE, dev)
    tasks = _df_tasks(chunks, tasks, dev)
    DFProgram(_df_reduce_op(src, imap, mask, groups, chunks, tasks, out)).run(None, 0, 0, dev)
    return out


routed_df_reduce_cuda.launches = 0


def routed_df_gather_reduce_cuda(vals, cols, groups, chunks, x, out, tail=None, ticket=None,
                                 tasks=None) -> torch.Tensor:
    """C-df level 0 (routed_df_reduce_kernel forming K3's products) into out
    (n_groups*128 (hi, lo) pairs): the df group sums of the slab whose slots
    are the products of their value pairs vals ((rows, 128, 2) f32) and x
    (f64, split in the kernel) at their columns cols ((rows, 128) int32;
    gather_reduce_operands). tail = (src, imap, mask, groups, chunks, out[,
    tasks]): the one-tile level after it (its src is out, at most 128 slab
    rows and 32 CTA-sets: _closable), run by the launch's last
    CTAs; ticket is their (2,) int32 zeros, allocated when not
    given; tasks (and the tail's) as for routed_df_reduce_cuda."""
    if tail is not None:
        timap, tchunks, ttasks = tail[1], tail[4], (list(tail[6:]) or [None])[0]
        ttasks = df_reduce_tasks(tchunks) if ttasks is None else ttasks
        if not _closable(timap, ttasks):
            raise ValueError(f"a closed level of {timap.idx.shape[0]} slab rows and "
                             f"{ttasks.shape[0] // _DF_REDUCE_WARPS} CTA-sets: at most {LANE} and "
                             f"{_DF_CLOSE_SETS}")
        tail = (*tail[:6], ttasks)
    dev = _on_cuda(x, vals, cols, groups, chunks, out, tasks)
    rows = cols.shape[0]
    _require(cols, "cols", _I32, (rows, LANE), dev)
    _require(vals, "vals", _F32, (rows, LANE, 2), dev)
    _require(x, "x", (torch.float64,), (x.shape[0],), dev)
    g = groups.shape[0]
    _require(groups, "groups", _I32, (g, 2), dev)
    _require(chunks, "chunks", _I32, (chunks.shape[0], 4), dev)
    _check_pairs(out, "out", g * LANE, dev)
    tasks = _df_tasks(chunks, tasks, dev)
    if tail is not None:
        src, imap, mask, tgroups, tchunks, tout, *ttasks = tail
        _on_cuda(x, src, imap.idx, mask, tgroups, tchunks, tout, *ttasks)
        _check_pairs(src, "src", imap.span, dev)
        _check_perm_reduce(src, imap, mask, tgroups, tchunks, None)
        _check_pairs(tout, "the closed level's out", tgroups.shape[0] * LANE, dev)
        ttasks = _df_tasks(tchunks, ttasks[0], dev)
        tail = (src, imap, mask, tgroups, tchunks, ttasks, tout)
        ticket = torch.zeros(2, dtype=torch.int32, device=dev) if ticket is None else ticket
        _check_ticket(ticket, 2, dev)
    DFProgram(_df_gather_reduce_op(vals, cols, groups, chunks, tasks, out, tail,
                                   ticket)).run(x, 0, 0, dev)
    return out


routed_df_gather_reduce_cuda.launches = 0


def routed_df_permute_cuda(src, imap: IndexMap, n: int, y) -> torch.Tensor:
    """The output gather (routed_df_permute_kernel) into y (f64): y[i] =
    hi + lo in f64 of the pair src[idx[i]] (+0 where the offset is -1) for
    i < n."""
    dev = _on_cuda(src, imap.idx, y)
    _check_pairs(src, "src", imap.span, dev)
    _check_permute(src, imap, n, None)
    _check_f64_out(y, n, dev)
    DFProgram(_df_permute_op(src, imap, n, y)).run(None, 0, 0, dev)
    return y


routed_df_permute_cuda.launches = 0


def routed_df_rowdot_cuda(hh, hl, rows, plan: RowdotPlan, x, y, part=None,
                          tickets=None) -> torch.Tensor:
    """D-df (routed_df_rowdot_kernel), one launch: y[rows[k]] = the f64
    value of heavy row k's df dot with x (f64, split in the kernel, zero
    past its end), in df_dense_rowdot's order; plan = rowdot_plan(n_pad,
    n_h). rows must index y; part is the CTAs' f32 scratch
    (_rowdot_part_elems) and tickets the zero int32 words (_rowdot_tickets),
    each allocated when not given."""
    dev = _on_cuda(x, hh, hl, rows, y, part, tickets)
    _check_rowdot(hh, hl, rows, plan, x, y)
    n_h = hh.shape[0]
    n_part = _rowdot_part_elems(plan, n_h)
    part = torch.empty(n_part, dtype=torch.float32, device=dev) if part is None else part
    _check_out(part, "part", n_part, dev)
    tickets = _rowdot_tickets(n_h, plan, dev) if tickets is None else tickets
    _check_ticket(tickets, _rowdot_ticket_words(plan, n_h), dev)
    DFProgram(_df_rowdot_op(hh, hl, rows, plan, part, tickets, y)).run(x, 0, 0, dev)
    return y


routed_df_rowdot_cuda.launches = 0

#: launches of each routed df kernel, as csrc/df_spmv.cu counted them (in
#: the order of its counts array)
_DF_COUNTERS = {
    "df_reduce": routed_df_reduce_cuda,
    "df_gather_reduce": routed_df_gather_reduce_cuda,
    "df_permute": routed_df_permute_cuda,
    "df_rowdot": routed_df_rowdot_cuda,
}
_DF_COUNTER_FNS = tuple(_DF_COUNTERS.values())


@dataclasses.dataclass
class RoutedDFChain:
    """A prepared df routed product (a RoutedDF or RoutedChunks of them),
    checked once: its stages over a call's buffers, the scratch they need,
    and (on a CUDA device) their encoded program."""

    mat: Union[RoutedDF, RoutedChunks]
    domains: Tuple[RoutedDF, ...]
    stages: Tuple[DFStage, ...]
    scratch_elems: int
    bounds: Tuple[int, ...]
    shape: Tuple[int, int]
    device: torch.device
    #: per product: the launches of each kernel the stages plan
    counts: Dict[str, int]
    program: Optional[DFProgram] = None

    @property
    def nnz(self) -> int:
        return self.mat.nnz


def _check_df(mdf: RoutedDF) -> None:
    mat = mdf.mat
    dev = mat.vals.device
    if mat.hdense is not None or mat.hvals is not None:
        raise ValueError("a df layout keeps its heavy rows in hdense_hi/hdense_lo")
    _check_domain(mat)
    _require(mat.vals, "vals", _F32, tuple(mat.vals.shape), dev)
    _require(mdf.vals_lo, "vals_lo", _F32, tuple(mat.vals.shape), dev)
    n_h = len(mdf.heavy_rows_df)
    if (mdf.hdense_hi is None) != (n_h == 0) or (mdf.hdense_lo is None) != (n_h == 0):
        raise ValueError("a dense heavy pair needs one heavy row per block row")
    if n_h:
        shape = (n_h, -(-mat.shape[1] // LANE) * LANE)
        _require(mdf.hdense_hi, "hdense_hi", _F32, shape, dev)
        _require(mdf.hdense_lo, "hdense_lo", _F32, shape, dev)
        if not all(0 <= r < mat.shape[0] for r in mdf.heavy_rows_df):
            raise ValueError("heavy_rows_df out of range")


def _df_reduce_stage(src: Buf, imap: IndexMap, mask, runs, out: Buf, dev) -> DFReduceStage:
    """C-df over the slab rows its groups cover, read through imap."""
    rows = max(row0 + ng * width for row0, ng, width, _g0 in runs)
    imap = dataclasses.replace(imap, idx=imap.idx[:rows])
    chunks = reduce_chunks(runs, dev)
    return DFReduceStage(src, imap, mask, groups_table(runs, dev), chunks, df_reduce_tasks(chunks),
                         runs, df_reduce_plan(runs, rows, dev), out)


def _df_domain_stages(mdf: RoutedDF, dom: Buf) -> Tuple[List[DFStage], IndexMap, int]:
    """One domain's C-df stages, its (hi, lo) level sums in the scratch from
    dom on; its output map (offsets in pairs from dom); and the scratch its
    sums take. C-df level 0 reads K3's operands composed through the
    products plan's whole permutation (gather_reduce_operands: rows past the
    real gather tiles read nothing, the +0 the pad tiles held) and, where
    the level after it is one tile, closes that level in its last CTAs; each
    later C-df reads the sums of the level before through its plan's whole
    permutation composed (rows past them reading +0); the output map reads
    the level sums through the output plan (the assembly tail past them
    reading +0)."""
    mat = mdf.mat
    dev = mat.vals.device
    pp, po = mat.perm_products, mat.perm_out
    n_real = mat.vals.shape[0] // LANE
    level_groups = [_n_groups(mat.runs)] + [_n_groups(r) for r in mat.lvl_runs]
    offs = np.r_[0, np.cumsum(level_groups)]
    levels = [
        _df_reduce_stage(dom.at(2 * int(offs[k]) * LANE),
                         plan_map(perm, src_rows=min(level_groups[k], perm.h)), mask, runs,
                         dom.at(2 * int(offs[k + 1]) * LANE), dev)
        for k, (perm, mask, runs) in enumerate(zip(mat.lvl_perms, mat.lvl_masks, mat.lvl_runs))]
    first = _df_reduce_stage(None, plan_map(pp, src_rows=n_real * LANE), None, mat.runs, dom, dev)
    vals, cols = gather_reduce_operands(mat.vals, mdf.vals_lo, mat.pidx, mat.widx, first.imap.idx)
    one_tile = levels and mat.lvl_perms[0].t == 1 and _closable(levels[0].imap, levels[0].tasks)
    tail = levels.pop(0) if one_tile else None
    host = dataclasses.replace(first.imap, idx=first.imap.idx.cpu())  # no kernel reads them
    stages: List[DFStage] = [DFGatherReduceStage(
        vals, cols, host, first.groups, first.chunks, first.tasks, first.runs, first.tree,
        dom, tail, torch.zeros(2, dtype=torch.int32, device=dev))]
    stages += levels
    return stages, plan_map(po, src_rows=int(offs[-1])), 2 * po.h * LANE


def _output_map(parts: Sequence[Tuple[IndexMap, int, int, int]]) -> IndexMap:
    """The domains' output maps composed into one over y's rows: each part
    (its map, its region's offset in pairs, its rows r0 .. r1) shifted by
    the offset and placed at row r0; -1 stays -1 (reads +0). One domain
    keeps its map (its region is at 0); the rows past the last bound are
    -1 up to a whole row of 128."""
    if len(parts) == 1:
        return parts[0][0]
    ids = []
    for imap, shift, r0, r1 in parts:
        idx = imap.idx.reshape(-1)[: r1 - r0].long()
        ids.append(torch.where(idx >= 0, idx + shift, idx))
    flat = torch.cat(ids)
    flat = torch.cat([flat, flat.new_full((-flat.numel() % LANE,), -1)])
    idx, span = _int32_offsets(flat.reshape(-1, LANE))
    return IndexMap(None, idx, span)


def _df_rowdot_stage(mdf: RoutedDF, part: Buf, y: Buf) -> DFRowdotStage:
    """D-df for a domain's dense heavy rows, written into y at the domain's
    first row; its CTA sums in the scratch at part."""
    n_h = len(mdf.heavy_rows_df)
    dev = mdf.hdense_hi.device
    rows = torch.tensor(mdf.heavy_rows_df, dtype=torch.int32, device=dev)
    plan = rowdot_plan(mdf.hdense_hi.shape[1], n_h)
    return DFRowdotStage(mdf.hdense_hi, mdf.hdense_lo, rows, plan, mdf.mat.shape[1], part,
                         _rowdot_tickets(n_h, plan, dev), y)


def build_df_chain(mat: Union[RoutedDF, RoutedChunks]) -> RoutedDFChain:
    """Check a prepared df layout once and plan its product: every domain's
    C-df stages, each domain's sums in a region of the scratch of its own;
    one output gather of every domain into y through their output maps
    composed (_output_map); then every domain's D-df, which overwrites its
    dense heavy rows of y, its CTA sums in one region past the domains'
    that the domains reuse in turn. On a CUDA device, one program."""
    domains = mat.chunks if isinstance(mat, RoutedChunks) else (mat,)
    bounds = mat.bounds if isinstance(mat, RoutedChunks) else (0, mat.shape[0])
    if len(bounds) != len(domains) + 1 or bounds[0] != 0 or bounds[-1] != mat.shape[0]:
        raise ValueError(f"chunk bounds {bounds} do not cover {mat.shape[0]} rows")
    stages: List[DFStage] = []
    parts = []
    off = 0
    for mdf, r0, r1 in zip(domains, bounds[:-1], bounds[1:]):
        if not isinstance(mdf, RoutedDF) or mdf.shape != (r1 - r0, mat.shape[1]):
            raise ValueError(f"the chunk between rows {r0} and {r1} is no RoutedDF of that shape")
        _check_df(mdf)
        dstages, omap, used = _df_domain_stages(mdf, Buf("s", off))
        stages += dstages
        parts.append((omap, off // 2, r0, r1))
        off += used
    stages.append(DFPermuteStage(Buf("s", 0), _output_map(parts), mat.shape[0], Buf("y", 0)))
    rowdot = [_df_rowdot_stage(mdf, Buf("s", off), Buf("y", r0))
              for mdf, r0 in zip(domains, bounds) if mdf.heavy_rows_df]
    stages += rowdot
    dev = domains[0].mat.vals.device
    chain = RoutedDFChain(
        mat=mat, domains=tuple(domains), stages=tuple(stages),
        scratch_elems=off + max((_rowdot_part_elems(s.plan, s.hh.shape[0]) for s in rowdot),
                                default=0),
        bounds=tuple(bounds), shape=tuple(mat.shape), device=dev,
        counts={k: sum(s.kernel == k for s in stages) for k in _DF_COUNTERS},
    )
    if dev.type == "cuda":
        chain.program = DFProgram(np.concatenate([_df_stage_op(s) for s in stages]))
    return chain


def df_chain_launches(chain: RoutedDFChain) -> int:
    """The kernels one df product launches: one per stage."""
    return sum(chain.counts.values())


def _df_buffers(chain: RoutedDFChain, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    m, n = chain.shape
    _require(x, "x", (torch.float64,), (n,), chain.device)
    return {
        "x": x,
        "y": torch.empty(m, dtype=torch.float64, device=x.device),
        "s": torch.empty(chain.scratch_elems, dtype=torch.float32, device=x.device),
    }


def _pairs(bufs, b: Buf, n: Optional[int] = None) -> torch.Tensor:
    """n (hi, lo) pairs in the scratch from b on (all to its end when n is
    None), as an (n, 2) view."""
    s = bufs["s"]
    end = s.numel() // 2 * 2 if n is None else b.off + 2 * n
    return s[b.off : end].view(-1, 2)


def _plain_reduce(stage: DFReduceStage, bufs) -> None:
    src = _pairs(bufs, stage.src)
    out = _pairs(bufs, stage.out, stage.out_elems())
    for k, p in enumerate(df_perm_reduce_reference(
            src[:, 0], src[:, 1], stage.imap.idx, stage.mask, stage.runs, stage.tree)):
        out[:, k].copy_(p.reshape(-1))


def run_df_stage(stage: DFStage, bufs: Dict[str, torch.Tensor], plain: bool) -> None:
    """Run one df stage over the buffers {"x": f64 x, "y": f64 y, "s": f32
    scratch}: its kernel through its wrapper, or with plain=True its plain
    version (on any device)."""
    x, y = bufs["x"], bufs["y"]
    if isinstance(stage, DFGatherReduceStage):
        out = _pairs(bufs, stage.out, stage.out_elems())
        t = stage.tail
        if plain:
            for k, p in enumerate(df_gather_reduce_reference(stage.vals, stage.cols, x, stage.runs,
                                                             stage.tree)):
                out[:, k].copy_(p.reshape(-1))
            if t is not None:
                _plain_reduce(t, bufs)
        else:
            tail = None if t is None else (
                _pairs(bufs, t.src).view(-1), t.imap, t.mask, t.groups, t.chunks,
                _pairs(bufs, t.out, t.out_elems()).view(-1), t.tasks)
            routed_df_gather_reduce_cuda(stage.vals, stage.cols, stage.groups, stage.chunks, x,
                                         out.view(-1), tail, stage.ticket, stage.tasks)
    elif isinstance(stage, DFReduceStage):
        if plain:
            _plain_reduce(stage, bufs)
        else:
            out = _pairs(bufs, stage.out, stage.out_elems())
            routed_df_reduce_cuda(_pairs(bufs, stage.src).view(-1), stage.imap, stage.mask,
                                  stage.groups, stage.chunks, out.view(-1), stage.tasks)
    elif isinstance(stage, DFPermuteStage):
        src = _pairs(bufs, stage.src)
        out = y[stage.out.off : stage.out.off + stage.n]
        if plain:
            out.copy_(df_permute_reference(src[:, 0], src[:, 1], stage.imap.idx, stage.n))
        else:
            routed_df_permute_cuda(src.view(-1), stage.imap, stage.n, out)
    else:
        out = y[stage.out.off :]
        if plain:
            out[stage.rows.long()] = dfloat.df_combine64(*df_rowdot_reference(
                stage.hh, stage.hl, *dfloat.split_f64_t(x), stage.plan.threads))
        else:
            n_part = _rowdot_part_elems(stage.plan, stage.hh.shape[0])
            routed_df_rowdot_cuda(stage.hh, stage.hl, stage.rows, stage.plan, x, out,
                                  bufs["s"][stage.part.off : stage.part.off + n_part],
                                  stage.tickets)


def df_stage_output(stage: DFStage, bufs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """What a df stage wrote: the (hi, lo) pairs (C-df; level 0's, then
    the closed level's), y's rows (the output gather), y at the heavy rows
    (D-df)."""
    if isinstance(stage, DFGatherReduceStage):
        out = [_pairs(bufs, stage.out, stage.out_elems()).reshape(-1)]
        if stage.tail is not None:
            out.append(_pairs(bufs, stage.tail.out, stage.tail.out_elems()).reshape(-1))
        return torch.cat(out)
    if isinstance(stage, DFReduceStage):
        return _pairs(bufs, stage.out, stage.out_elems()).reshape(-1)
    if isinstance(stage, DFPermuteStage):
        return bufs["y"][stage.out.off : stage.out.off + stage.n]
    return bufs["y"][stage.out.off :][stage.rows.long()]


def routed_df_reference(chain: RoutedDFChain, x: torch.Tensor) -> torch.Tensor:
    """Plain y = A @ x in double-float (f64, length m) over a prepared df
    chain, stage by stage with the kernels' plain versions, on any device.
    Scratch and y start as NaN, so a stage that read what no stage wrote, or
    a row no stage wrote, would show."""
    bufs = _df_buffers(chain, x)
    bufs["s"].fill_(float("nan"))
    bufs["y"].fill_(float("nan"))
    for stage in chain.stages:
        run_df_stage(stage, bufs, plain=True)
    return bufs["y"]


def compare_df_stages(chain: RoutedDFChain, x: torch.Tensor):
    """Each df stage's kernel against its plain version on the same inputs:
    the chain runs with the plain versions, and before each stage two copies
    of the buffers run the stage's kernel. Yields (stage, kernel output,
    the kernel's rerun output, plain output) for every stage (CUDA tensors
    only)."""
    bufs = _df_buffers(chain, x)
    bufs["s"].fill_(float("nan"))
    bufs["y"].fill_(float("nan"))
    for stage in chain.stages:
        runs = []
        for _ in range(2):
            copy = {k: v.clone() for k, v in bufs.items()}
            run_df_stage(stage, copy, plain=False)
            runs.append(df_stage_output(stage, copy))
        run_df_stage(stage, bufs, plain=True)
        yield stage, runs[0], runs[1], df_stage_output(stage, bufs)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same bits (torch.equal, but -0 != +0
    and a NaN equals itself)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def _staged_df_domain(mdf: RoutedDF, xh, xl) -> torch.Tensor:
    """f64 y of one domain as the JAX package's _routed_df_32 and
    routed_spmv_df compute it, every stage its plain version over whole
    arrays: the products padded to the products domain, each planned
    permutation as its W stages one by one on each plane, reduce_runs_df,
    the output permutation, df_combine64, the heavy rows' df_dense_rowdot."""
    mat = mdf.mat
    dev = mat.vals.device
    pp = mat.perm_products
    ph, pl = routed_df_gather_reference(mat.vals, mdf.vals_lo, mat.pidx, mat.widx, pp.t, xh, xl)

    def staged(plan, a):
        return staged_reference(plan_steps(plan), a)

    sums = [reduce_runs_df(staged(pp, ph), staged(pp, pl), df_reduce_plan(mat.runs, pp.h, dev))]
    for perm, mask, runs in zip(mat.lvl_perms, mat.lvl_masks, mat.lvl_runs):
        prev = [_rows(s, s.shape[0], perm.h) for s in sums[-1]]
        sums.append(reduce_runs_df(*(staged(perm, a) for a in prev),
                                   df_reduce_plan(runs, perm.h, dev), mask=mask))
    po = mat.perm_out
    ys = []
    for k in range(2):
        flat = torch.cat([s[k] for s in sums])
        ys.append(staged(po, _rows(flat, flat.shape[0], po.h)).reshape(-1)[: mat.shape[0]])
    y = dfloat.df_combine64(*ys)
    if mdf.heavy_rows_df:
        idx = torch.tensor(mdf.heavy_rows_df, dtype=torch.long, device=dev)
        y[idx] = dfloat.df_combine64(*df_dense_rowdot(mdf.hdense_hi, mdf.hdense_lo, xh, xl))
    return y


def routed_df_staged_reference(chain: RoutedDFChain, x: torch.Tensor) -> torch.Tensor:
    """The df product as the staged chain computed it before its
    permutations were composed (each domain by _staged_df_domain, on any
    device): what routed_df_spmv gives, bit for bit."""
    _require(x, "x", (torch.float64,), (chain.shape[1],), chain.device)
    xh, xl = dfloat.split_f64_t(x)
    ys = [_staged_df_domain(mdf, xh, xl) for mdf in chain.domains]
    return ys[0] if len(ys) == 1 else torch.cat(ys)


def routed_df_spmv(chain: RoutedDFChain, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """y = A @ x in double-float (f64 in and out, length m) over a prepared
    df chain. CUDA tensors enqueue the chain's program (per domain C-df per
    level, level 0 forming K3's products; one output gather of every
    domain; per domain D-df) in one call of csrc/df_spmv.cu;
    with plain=True, or for CPU tensors, every stage runs its plain version
    (routed_df_reference). Anything else raises."""
    _device_of(x)
    _require(x, "x", (torch.float64,), (chain.shape[1],), chain.device)
    if plain or x.device.type == "cpu":
        return routed_df_reference(chain, x)
    y = torch.empty(chain.shape[0], dtype=torch.float64, device=x.device)
    s = torch.empty(chain.scratch_elems, dtype=torch.float32, device=x.device)
    chain.program.run(x, y.data_ptr(), s.data_ptr(), x.device)
    return y


def prepare_routed_df_chain(csr, device="cuda") -> RoutedDFChain:
    """prepare_routed_df_auto, then build_df_chain: the operands of
    PL_CSR_ROUTED_F64 and of AutoSpMV at float64, on the card unless the
    caller passes device="cpu"."""
    return build_df_chain(prepare_routed_df_auto(csr, device=device))


def routed_df_from_jax(mat: dict, vals_lo, hdense_hi=None, hdense_lo=None,
                       heavy_rows_df=(), device="cuda") -> RoutedDF:
    """The port's RoutedDF from the JAX package's: mat is the routed_from_jax
    keyword set of its RoutedCSR (the hi words), the rest its df fields as
    numpy arrays, on `device` (the card unless the caller passes
    device="cpu"). Validated as build_df_chain does."""
    device = target_device(device)
    def conv(a):
        return None if a is None else _to_tensor(a, device)

    mdf = RoutedDF(
        mat=routed_from_jax(**mat, device=device), vals_lo=conv(vals_lo),
        hdense_hi=conv(hdense_hi), hdense_lo=conv(hdense_lo),
        heavy_rows_df=tuple(int(r) for r in heavy_rows_df),
    )
    _check_df(mdf)
    return mdf


# ---------------------------------------------------------------------------
# registry hook (imported by ops.registry)
# ---------------------------------------------------------------------------


def _register() -> None:
    from .registry import KernelSpec, register

    register(
        KernelSpec(
            name="PL_CSR_ROUTED",
            fmt="csr",
            impl="cuda",
            prepare=lambda csr, ell, cfg, device: prepare_routed_chain(
                csr, dtype=cfg.torch_dtype, device=device
            ),
            run=routed_chain_spmv,
            doc="Clos-routed CSR: products gathered per window tile, a planned "
            "Clos permutation to width-binned reduction slabs, run sums per "
            "lane, a second permutation into row order; the fully general "
            "engine for power-law and scattered matrices",
        )
    )
    register(
        KernelSpec(
            name="PL_CSR_ROUTED_BF16",
            fmt="csr",
            impl="cuda",
            prepare=lambda csr, ell, cfg, device: prepare_routed_chain(
                csr, dtype=torch.float32, vals_dtype=torch.bfloat16, device=device
            ),
            run=routed_chain_spmv,
            doc="Clos-routed CSR with bf16 gather-slot values (f32 products, "
            "routing and sums): halves the gather's value stream",
        )
    )
    register(
        KernelSpec(
            name="PL_CSR_ROUTED_F64",
            fmt="csr",
            impl="cuda",
            prepare=lambda csr, ell, cfg, device: prepare_routed_df_chain(csr, device=device),
            run=routed_df_spmv,
            doc="double-precision Clos-routed CSR: (hi, lo) value and product "
            "slabs (a TwoProduct gather kernel), TwoSum reduce trees over each "
            "permuted slab, an f64 output gather; heavy rows in a dense (hi, lo) "
            "block with a compensated row dot",
            f64=True,
        )
    )


_register()
