#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the root of the repository: python3 chip_smoke.py

It builds the CUDA kernels from spmv_openmp_cuda_tpu_torch/csrc/ (one nvcc
per source, all at once), holds each kernel against its plain PyTorch
version at the main path's shapes, drives the main path (AutoSpMV.from_csr
-> model(x)) on three DIA-class, three window-class and three routed proxies
(webbase_like's heavy rows in pooled tiles, kernel E) at their published
size, first in float32 and then in float64 (the double-float kernels of
csrc/df_spmv.cu; webbase_like in float32 only), each pass with the launch
counters reset just before and read just after, every product rerun on the
same x and held bitwise equal, checks the results against the f64 oracle
(for the f32 routed engine, the oracle of the matrix as its layout stores
it: dense-block heavy rows in bf16; the df layouts keep every value as an
(hi, lo) pair, so float64 is held to the exact matrix), runs the CLI in both
dtypes, and times kernel, plain version and one PyTorch library call
(cuSPARSE through torch.sparse, f32 or f64, a yardstick the port never
calls) with CUDA events; the routed kernels alone are timed inside CUDA
graphs, so that the host's launch cost does not hide their device time.
The DIA+residual product (PL_DIA_RESID, _BF16 and _F64) is one launch of
dia_resid_kernel or dia_resid_df_kernel (band and fringe together, f64 in
and out): phase 2 holds it against its plain version on raefsky1_like, a
200,000-row banded check matrix and a 3000 x 6000 band whose fringe reads x
past the JAX window's clip, one launch and a bitwise rerun per product, and
phase 5 times the whole product per call and in a CUDA graph against
cuSPARSE on the whole matrix.
The DIA rows products (PL_DIA_ROWS, _BF16: dia_rows_kernel; PL_DIA_F64:
dia_df_kernel, f64 x split and f64 y combined in it) are one launch each,
a thread per four rows (one on small matrices), the layout checked at its
first launch: phase 2 holds dia_df_kernel torch.equal its plain version on
cube_coup_like and cavity10_like, phase 3 counts one launch per DIA
product, phase 5 times every DIA rows product per call and in a CUDA graph
(cavity10_like in f64 too), and phase 6 holds both kernels on CG's
Laplacian against their plain versions (one launch per product, a bitwise
rerun) and times them per call and graphed beside cuSPARSE; the kernels
line's entries carry these cells.
The window kernels (csrc/window_spmv.cu, df_spmv.cu's window_df_kernel)
run one launch per product in every dtype: a CTA per block on
thermal2_like, thread-block clusters on fem_3d_thermal2_like and
delaunay_n12_like; phase 2 holds each layout (the three x forms, g = 64, a
128-row x window) against its plain version, one launch and a bitwise rerun
per product, and phase 5 times them per call and in a CUDA graph.
The routed chain reads every permutation through index maps composed at
build time: kernel C sums each slab slot through one offset into its source
(A's products, or the sums of the level before), kernel B applies a domain's
whole output permutation as one gather; phase 2 holds B bit for bit, and C
within the f32 bound, against the W stages applied one by one
(`routed_cuda.staged_stage`) as well as against their plain versions, phase
3 holds the counted launches to the chains' planned ones (caida_like: A, C
twice, D, B: five launches and a memset per product), and
phase 5 times each C and the output gather alone in a CUDA graph on
caida_like and webbase_like. Kernel A stages each tile's x window in shared
memory (one bulk copy per CTA of two bands), kernel E takes a pooled tile
per residue quarter (persistent CTAs, the next quarter's operands copied
in while this one's sums are taken): phase 2 holds A bit for
bit against its plain version and E bit for bit against
heavy_sums_in_order (its adds in its order) on webbase_like and
pooled_200000, and phase 5 prints each one's graphed time and share of its
bound beside the time before the redesign (PARENT_US). Kernel D (the dense
heavy rows) is one launch whose last CTA closes the product: phase 2 holds
it bit for bit against hdense_in_order on caida_like, phase 5 prints it
alone in a CUDA graph with its share of its bound.
The routed df product (PL_CSR_ROUTED_F64) is one program of csrc/df_spmv.cu
per product, enqueued from one host call: per domain C-df per level (level
0 forming K3's products), one output gather of every domain's (hi, lo) sums
into f64 y, per domain D-df for the dense heavy rows (three launches on
caida_like); phase 2 holds each launch bit for bit against its plain
version, and a rerun against itself, on caida_like and sg_rand_like's three
chunks (their one gather included), and the whole product bit for bit
against its plain chain and the staged chain (the W stages one by one); phase 3
holds the counted launches to the planned ones, caida_like's to 3 and
sg_rand_like's to one gather; phase 5 times each launch alone in a CUDA
graph with its bound (the gather on sg_rand_like too, beside one f64
torch.take), and the product per call and graphed against cuSPARSE f64.
The small kernel (one launch per product of a routed domain of t <= 4
tiles, over per-row slot lists, no scratch) is held bit for bit against the
staged chain and timed beside it on delaunay_n12_like, west2021_like and a
9000-row matrix; PL_CSR_ROUTED_BF16's pooled tiles and
the CLI's AUTO run on a 200,000-row matrix whose heavy rows pool.

Phase 1 also builds the native host library (io/native.py, g++) that the
window and routed prepares use, and calls each public prepare, planner and
converter of the port with no device, on a small band: every tensor they
return must be on the card (the `defaults:` line); phase 6 (solver_phase, last) drives the
solvers with their own counters from zero: CG over AutoSpMV on the 5-point
Laplacian of a 1000 x 1000 grid in float32 (DIA) and float64 (df DIA), on
caida_like and delaunay_n12_like made SPD (routed, window), and power
iteration on caida_like made SPD, each eager, by default and graphed from
the first iteration, timed whole (default and graphed x torch.equal eager
x, the true residual in float64 on the host), then saves
and loads prepared files on the card (y torch.equal) and holds the native
layouts of delaunay_n12_like and caida_like equal to the numpy ones.
`--seed N` seeds phase 6's x* and v0.

Phase 7 (multi_device_phase, after phase 6) drives the multi-device paths
(spmv_openmp_cuda_tpu_torch/parallel/) on 4 shards, shard i on cuda:(i mod
the card count): on one card the shards share it, the counterpart of the
JAX package's virtual devices. With the counters from zero it runs
contract.dryrun_multichip(4), then each path at full size (the window halo
on thermal2_like, the SPMD and multi-device routed engines on caida_like,
the DIA halo in f32 and df on phase 6's Laplacian, row-sharded ELL, the 2 x 2
psum and the ring on sg_like) against the reference protocol, x ~ N(0, 1)
against the f64 oracle and a bitwise rerun, with the launches per product
(one window launch per shard; the chains' planned ones); the sharded window
y torch.equal the single-device kernel on the same layout, each SPMD shard's
y its chunk's chain run alone; then the times per product at 1, 2 and 4
shards (bench/scaling.py) beside the single-device product and cuSPARSE.

Phase 8 (cross_process_phase, after phase 7) runs the mesh across
processes: two ranks of a gloo group (parallel/launch.py::run_ranks, spawned,
a join timeout of its own), each holding two of the four shards on cuda:0,
the exchanges staged through the host. Each rank runs the seven shard_map
paths on the dryrun's matrices and, at full size, the window halo on
thermal2_like and the SPMD routed engine on caida_like (the parent writes
those matrices and x to a temporary directory); every joined y, in both
ranks, is torch.equal phase 7's one-process 4-shard y. Each rank counts the
launches of one full-size product from zero (window_blocks and the routed
kernels in both ranks), times the product with CUDA events (2 processes
sharing one card: not a scaling figure) and its own shards' kernels alone
against their plain versions. With two cards or more the same runs under
NCCL, rank r on cuda:r; with one, a line says it was not run. A failing or
hung rank ends the script with an error; nothing falls back.

The CSR/ELL mode matrix (csr_ell_slice) follows: ell_t_kernel (csrc/
ell_spmv.cu; a thread per four rows walks to the longest of them, from a
table made at the layout's first launch) on sg_like and thermal2_like, also held equal to the
full-width walk (ell_t_in_order), and lanes_kernel (csrc/
lanes_spmv.cu, one launch per product) on four small proxies, a four-window
matrix and a G = 64 matrix against their plain versions, each rerun bitwise
equal; then that slice's main path with
its own counters from zero: the harness over all 26 modes on
delaunay_n12_like and over the mode matrix on sg_like (SG's published
size), its log printed and read back by parse_log, every mode that prepares
ok:1, det:1 and within the relative bound on x ~ N(0, 1); the CLI's
explicit modes;
float64 binned against the exact oracle; then the two kernels' times (for
ell_t_kernel also its host time per call, cuSPARSE graphed, and two bounds:
the nonzero slots', and the whole slab's).

Any failure raises and exits non-zero; without a CUDA device it exits 1
before printing any result.

Tolerances: f32 kernels against their plain versions 1e-5 * max|y| + 1e-6
(f32 sums in another order); df kernels 1e-12 * max|y| (both (hi, lo) f32
pairs); f64 results against the exact oracle 1e-11 * max|y| (1e-10 for the
chunked routed path), which a contracted TwoProduct or TwoSum (~1e-7) fails;
in the harness, modes that store bf16 values 2^-7 * max(|A||x|) more.
The last line is one JSON object {"ok": true, "device": {...}}, the line
before it a JSON object with one entry per kernel.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

T0 = time.perf_counter()
DIA_MODES = ("PL_DIA_ROWS", "PL_DIA_BF16", "PL_DIA_RESID", "PL_DIA_RESID_BF16")
#: DIA proxy -> modes it is checked and timed on (the main path's shapes:
#: cube_coup_like runs PL_DIA_ROWS, raefsky1_like PL_DIA_RESID)
DIA_CHECKS = {
    "cube_coup_like": ("PL_DIA_ROWS", "PL_DIA_BF16"),
    "raefsky1_like": DIA_MODES,
    "cavity10_like": ("PL_DIA_ROWS",),
}
#: window proxy -> modes (the JAX bench runs thermal2/fem under
#: PL_CSR_WINDOW_BF16 and delaunay under PL_CSR_WINDOW; AutoSpMV runs
#: PL_CSR_WINDOW)
WINDOW_CHECKS = {
    "thermal2_like": ("PL_CSR_WINDOW", "PL_CSR_WINDOW_BF16"),
    "fem_3d_thermal2_like": ("PL_CSR_WINDOW", "PL_CSR_WINDOW_BF16"),
    "delaunay_n12_like": ("PL_CSR_WINDOW", "PL_CSR_WINDOW_BF16"),
}
#: AutoSpMV's engine for each proxy
EXPECTED_FORMAT = {
    "cube_coup_like": "dia", "raefsky1_like": "dia_resid", "cavity10_like": "dia",
    "thermal2_like": "window", "fem_3d_thermal2_like": "window",
    "delaunay_n12_like": "window", "caida_like": "routed", "sg_rand_like": "routed",
    "webbase_like": "routed",
}
#: routed proxies: caida_like is checked kernel by kernel and timed (the JAX
#: bench runs it under PL_CSR_ROUTED_BF16, AutoSpMV under PL_CSR_ROUTED);
#: sg_rand_like (three chunks) runs the main path only; webbase_like (one
#: domain, 193 heavy rows in pooled tiles) is prepared once, by AutoSpMV in
#: float32, and that chain serves its checks and times
ROUTED_CHECK = "caida_like"
POOLED_CHECK = "webbase_like"
#: float32 only: the float64 product of webbase_like is not run here
F32_ONLY = ("webbase_like",)
#: routed domains of t <= 4 tiles, run by the small kernel (one launch)
SMALL_CHECKS = ("delaunay_n12_like", "west2021_like", "random_uniform 9000")
ROUTED_MODES = ("PL_CSR_ROUTED", "PL_CSR_ROUTED_BF16")
DIA_SOURCE = "spmv_openmp_cuda_tpu_torch/csrc/dia_spmv.cu"
WINDOW_SOURCE = "spmv_openmp_cuda_tpu_torch/csrc/window_spmv.cu"
ROUTED_SOURCE = "spmv_openmp_cuda_tpu_torch/csrc/routed_spmv.cu"
DF_SOURCE = "spmv_openmp_cuda_tpu_torch/csrc/df_spmv.cu"
ELL_SOURCE = "spmv_openmp_cuda_tpu_torch/csrc/ell_spmv.cu"
LANES_SOURCE = "spmv_openmp_cuda_tpu_torch/csrc/lanes_spmv.cu"
#: the CSR/ELL mode matrix: the reference's OpenMP strategy matrix as torch
#: ops, the binned slabs, and the two CUDA kernels' modes
CSR_ELL_MODES = [
    "CSR_ROWS", "CSR_ROWS_GROUPS", "CSR_TILES", "CSR_TILES_ALLOCD", "ELL_ROWS",
    "ELL_ROWS_GROUPS", "ELL_TILES", "ELL_ROWS_T", "ELL_ROWS_NOSIMD", "ELL_ROWS_NORL",
    "CSR_ROWS_BINNED", "PL_ELL_ROWS_T", "PL_CSR_LANES",
]
#: harness matrix -> modes run, and the modes whose prepare must refuse it
#: (DiaFillError; LanesError past 64 row groups), as in the JAX harness.
#: sg_like (SG's published size) runs the mode matrix beside its AUTO engine
#: (PL_CSR_WINDOW) and two DIA modes that refuse it
HARNESS_RUNS = {
    "delaunay_n12_like": (None, ("DIA_ROWS", "PL_DIA_ROWS", "PL_DIA_BF16", "PL_DIA_RESID",
                                 "PL_DIA_RESID_BF16", "PL_DIA_RESID_F64", "PL_DIA_F64")),
    "sg_like": ((*CSR_ELL_MODES, "PL_CSR_WINDOW", "DIA_ROWS", "PL_DIA_ROWS"),
                ("PL_CSR_LANES", "DIA_ROWS", "PL_DIA_ROWS")),
}
#: lane-gather proxies (at most 64 row groups) and the transposed-ELL ones
LANES_CHECKS = ("delaunay_n12_like", "raefsky1_like", "cavity10_like", "west2021_like")
ELL_T_CHECKS = ("sg_like", "thermal2_like")
#: the DIA+residual check matrices beside raefsky1_like: a 200,000-row band
#: (61 diagonals, 38 TPU blocks, 201,015 fringe nnz: the band streams from
#: HBM) and a 3000 x 6000 band with two fringe entries past the JAX window's
#: clip of x
RESID_BIG = "banded_200000"
RESID_CLIP = "banded_3000x6000_past_clip"
RESID_MODES = ("PL_DIA_RESID", "PL_DIA_RESID_BF16", "PL_DIA_RESID_F64")


def wide_band_with_far_fringe():
    """A 3000 x 6000 band with two fringe entries (columns 4300, 5000) past
    the JAX window's clip of x at (S + pad_sub) * 128 = 4224."""
    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.utils import synth

    band = synth.banded(3000, 3000, 30, fill=1.0, seed=0)
    rows = np.r_[band.rows, [2998, 2999]]
    cols = np.r_[band.cols, [4300, 5000]]
    vals = np.r_[band.vals, [2.0, 1.0]]
    return P.sort_coo(P.COOMatrix((3000, 6000), rows, cols, vals))


def resid_cost(dr, n_x: int, df: bool):
    """(bytes, flops) of one DIA+residual product: the slab's rows < m (both
    planes in df) and the offsets, the per-row fringe lists, x and y, each
    once; 2 flops per slab slot and fringe entry (DF_FLOPS_PER_SLOT in df)."""
    mat = dr.mat
    d, m = len(mat.offsets), mat.shape[0]
    planes = 2 if df else 1
    lists = nbytes(dr.row_ptr, dr.fr_val, dr.fr_col, *((dr.fr_lo,) if df else ()))
    moved = planes * d * m * mat.data.element_size() + nbytes(mat.offsets_dev) + lists
    moved += (8 if df else 4) * (n_x + m)
    slots = d * m + dr.fr_col.numel()
    return moved, (DF_FLOPS_PER_SLOT if df else 2) * slots


#: float64 mode of each format (AutoSpMV and CLI AUTO at --dtype float64)
F64_MODES = {"dia": "PL_DIA_F64", "dia_resid": "PL_DIA_RESID_F64",
             "window": "PL_CSR_WINDOW_F64", "routed": "PL_CSR_ROUTED_F64"}
#: f32 operations per stored slot of a df kernel: TwoProduct with an FMA
#: error (3), the cross terms (4), a TwoSum (6) and the low words (2)
DF_FLOPS_PER_SLOT = 15
#: routed kernel -> (name in csrc/routed_spmv.cu, the TPU kernel it replaces)
ROUTED_KERNELS = {
    "gather": ("routed_gather_kernel", "spmv_openmp_cuda_tpu/formats/routed.py:959"),
    "permute": ("routed_permute_kernel", "spmv_openmp_cuda_tpu/ops/route.py:347"),
    "perm_reduce": ("routed_perm_reduce_kernel", "spmv_openmp_cuda_tpu/formats/routed.py:1239"),
    "hdense": ("routed_hdense_kernel", "spmv_openmp_cuda_tpu/formats/routed.py:1060"),
    "heavy": ("routed_heavy_kernel", "spmv_openmp_cuda_tpu/formats/routed.py:1134"),
    "small": ("routed_small_kernel", "spmv_openmp_cuda_tpu/formats/routed.py:1440"),
}
#: H100 SXM data sheet: HBM rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


#: graphed device time of A (caida_like), E + its close (webbase_like) and
#: D + its close (caida_like) before their redesign (A reading x by global
#: column, E one CTA per tile, D a CTA per heavy row and chunk, then a
#: second launch to close), this script's phase 5 on one H100 80GB HBM3 at
#: 700 W: the yardstick of the redesigned kernels' lines
PARENT_US = {"gather": 6.56, "heavy": 29.75, "hdense": 5.28}


def pooled_heavy_matrix(m: int, n: int, n_heavy: int, per_row: int, bg_nnz: int, seed: int):
    """n_heavy rows of per_row distinct columns, then bg_nnz scattered
    entries in the other rows: with n_heavy * n * 2 bytes over the dense
    block's 12 MB, the routed prepare pools the heavy rows."""
    import spmv_openmp_cuda_tpu_torch as P

    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.full(per_row, r) for r in range(n_heavy)]
                          + [rng.integers(n_heavy, m, bg_nnz)])
    cols = np.concatenate([rng.choice(n, per_row, replace=False) for _ in range(n_heavy)]
                          + [rng.integers(0, n, bg_nnz)])
    rows, cols = np.unique(np.stack([rows, cols]), axis=1)
    return P.COOMatrix((m, n), rows, cols, rng.standard_normal(rows.shape[0]))


#: the medium matrix with pooled heavy rows (PL_CSR_ROUTED_BF16, CLI AUTO)
MEDIUM = "pooled_200000"
MEDIUM_ARGS = dict(m=200_000, n=200_000, n_heavy=40, per_row=17_000, bg_nnz=400_000, seed=1)


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def bound(y_ref: torch.Tensor) -> float:
    """f32 sums of <= D + k_pad (~140) terms in another order:
    1e-5 * max|y_ref| + 1e-6."""
    return 1e-5 * y_ref.abs().max().item() + 1e-6


def df_bound(y_ref: torch.Tensor) -> float:
    """Two double-float results of the same pairs, summed in another order:
    1e-12 * max|y_ref|."""
    return 1e-12 * y_ref.abs().max().item()


def check_df(label: str, yk: torch.Tensor, yp: torch.Tensor, errs: dict, key: str) -> None:
    """A df kernel's f64 output against its plain version's."""
    torch.cuda.synchronize()
    err = (yk - yp).abs().max().item()
    ok = yk.dtype == torch.float64 and err <= df_bound(yp) and yk.abs().max().item() > 0
    errs[key] = max(errs.get(key, 0.0), err)
    log(f"phase 2: {label}: max|y_k - y_p| = {err:.3e} <= {df_bound(yp):.3e}, "
        f"max|y_k| = {yk.abs().max().item():.3e}: {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")


def normal_x(n: int, device, seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(n)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def normal_x64(n: int, device, seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(n)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def slab_bytes(ops) -> int:
    from spmv_openmp_cuda_tpu_torch.formats.window import WindowCSR
    from spmv_openmp_cuda_tpu_torch.ops.spmv_cuda import DiaResid

    if isinstance(ops, WindowCSR):
        return nbytes(ops.vals, ops.sidx, ops.gid, ops.rsrc)
    first = ops[0]
    if isinstance(first, DiaResid):
        return nbytes(first.mat.data, first.rvals, first.rsidx, first.rgid, first.rsrc)
    return dia_live(first)[0] - nbytes(first.offsets_dev)


def dia_live(mat):
    """(bytes, slots) a DIA rows kernel reads of a plan-padded slab: each
    plane's first m rows of every diagonal (the kernels stop at row m, so
    the plan's padding rows are never read) and the offsets."""
    d, m = len(mat.offsets), mat.shape[0]
    planes = 2 if getattr(mat, "data_lo", None) is not None else 1
    return planes * d * m * mat.data.element_size() + nbytes(mat.offsets_dev), d * m


def stage_cost(stage, n_x: int):
    """(bytes, flops) of one routed stage: each input read once, each output
    written once, at this run's shapes."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC

    out = 4 * stage.out_elems()
    if isinstance(stage, RC.GatherStage):
        n_real = stage.vals.shape[0] // 128
        w1 = n_real * 128 * 128 if stage.w1 is not None else 0
        return nbytes(stage.vals, stage.pidx, stage.widx) + w1 + 4 * n_x + out, stage.vals.numel()
    if isinstance(stage, RC.PermuteStage):
        # the map's first n offsets, the source elements they name, y
        idx = stage.imap.idx.reshape(-1)[:stage.n]
        return 4 * idx.numel() + 4 * int((idx >= 0).sum()) + out, 0
    if isinstance(stage, RC.ReduceStage):
        # the offsets (and mask) of the slab rows the groups cover, the
        # source elements they name, the groups table and the sums; an add
        # per slot
        off = stage.imap.idx
        mask = 4 * off.numel() if stage.mask is not None else 0
        return nbytes(off, stage.groups, stage.chunks) + mask + 4 * int((off >= 0).sum()) + out, \
            sum(ng * w for _r0, ng, w, _g0 in stage.runs) * 128
    if isinstance(stage, RC.HDenseStage):
        return nbytes(stage.hdense, stage.target) + 4 * n_x + 4 * stage.hdense.shape[0], \
            2 * stage.hdense.numel()
    if isinstance(stage, RC.HeavyStage):
        return heavy_cost(stage, n_x)
    if isinstance(stage, RC.SmallStage):
        # the gather tiles, the per-row slot lists, x and y; a multiply and
        # an add per listed slot
        ins = nbytes(stage.vals, stage.pidx, stage.widx, stage.row_ptr, stage.row_slots)
        return ins + 4 * n_x + out, 2 * stage.row_slots.numel()
    return out, 0


def df_stage_cost(stage, n_x: int):
    """(bytes, flops) of one routed df stage at this run's shapes: each input
    read once (x in f64, both words of each pair the offsets name), each
    output written once; 8 flops per TwoSum-add of the padded trees, 15 per
    product (DF_FLOPS_PER_SLOT). C-df level 0's inputs are its slots' value
    pairs and x columns, and the level its last CTAs close is counted in."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC

    def tree_adds(runs):
        return sum(ng * ((1 << (w - 1).bit_length()) - 1) for _r0, ng, w, _g0 in runs) * 128

    def reduce_cost(st):
        off = st.imap.idx
        mask = 4 * off.numel() if st.mask is not None else 0
        return (nbytes(off, st.groups, st.chunks, st.tasks) + mask + 8 * int((off >= 0).sum())
                + 8 * st.out_elems(), 8 * tree_adds(st.runs))

    if isinstance(stage, RC.DFGatherReduceStage):
        b = nbytes(stage.vals, stage.cols, stage.groups, stage.chunks, stage.tasks) + 8 * n_x \
            + 8 * stage.out_elems()
        f = DF_FLOPS_PER_SLOT * int((stage.cols >= 0).sum()) + 8 * tree_adds(stage.runs)
        if stage.tail is not None:
            tb, tf = reduce_cost(stage.tail)
            b, f = b + tb, f + tf
        return b, f
    if isinstance(stage, RC.DFReduceStage):
        return reduce_cost(stage)
    if isinstance(stage, RC.DFPermuteStage):
        idx = stage.imap.idx.reshape(-1)[:stage.n]
        return 4 * idx.numel() + 8 * int((idx >= 0).sum()) + 8 * stage.n, stage.n
    n_h, n_pad = stage.hh.shape
    p2 = stage.plan.threads << stage.plan.log_k
    return (nbytes(stage.hh, stage.hl, stage.rows) + 8 * n_x + 8 * n_h,
            DF_FLOPS_PER_SLOT * n_h * n_pad + 8 * n_h * (p2 - n_pad))


DF_KERNEL_LABELS = {
    "df_gather_reduce": "routed_df_reduce_kernel (C-df level 0: K3's products formed in it)",
    "df_reduce": "routed_df_reduce_kernel (C-df)",
    "df_permute": "routed_df_permute_kernel (output gather)",
    "df_rowdot": "routed_df_rowdot_kernel (D-df, x split and rows closed in it)",
}


def df_stage_labels(chain) -> dict:
    """Each df stage's name in the logs: C-df by level of its domain (level
    0 with the level its last CTAs close), D-df with its rows and plan."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC

    out, level = {}, 0
    for st in chain.stages:
        what = ""
        if isinstance(st, RC.DFGatherReduceStage):
            level = 1 + (st.tail is not None)
            what = " level 0" + (" and level 1, closed by its last CTAs" if st.tail is not None else "")
        elif isinstance(st, RC.DFReduceStage):
            what = f" level {level}"
            level += 1
        elif isinstance(st, RC.DFRowdotStage):
            what = f" ({st.hh.shape[0]} rows, {st.plan})"
        out[st] = DF_KERNEL_LABELS[st.kernel] + what
    return out


def parent_level0(mdf, stage, x64):
    """What a DFGatherReduceStage writes, by the parent's plain versions: K3
    (the products of the gather tiles) followed by plain C-df through the
    products plan's composed offsets (the stage keeps them on the host), and the closed level's plain C-df over
    those sums; (hi, lo) pairs side by side."""
    from spmv_openmp_cuda_tpu_torch.ops import dfloat as DF
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC

    mat = mdf.mat
    ph, pl = RC.routed_df_gather_reference(mat.vals, mdf.vals_lo, mat.pidx, mat.widx,
                                           mat.perm_products.t, *DF.split_f64_t(x64))
    sums = [RC.df_perm_reduce_reference(ph.reshape(-1), pl.reshape(-1),
                                        stage.imap.idx.to(ph.device), None, stage.runs,
                                        stage.tree)]
    t = stage.tail
    if t is not None:
        sums.append(RC.df_perm_reduce_reference(sums[0][0].reshape(-1), sums[0][1].reshape(-1),
                                                t.imap.idx, t.mask, t.runs, t.tree))
    return torch.cat([torch.stack([h.reshape(-1), lo.reshape(-1)], -1).reshape(-1) for h, lo in sums])


def routed_stage_label(chain, stage) -> str:
    """A routed stage's name in the timing lines: C by level of its domain,
    B as the output gather."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC

    if isinstance(stage, RC.ReduceStage):
        i = chain.stages.index(stage)
        first = max(j for j in range(i + 1) if isinstance(chain.stages[j], RC.GatherStage))
        return f"C level {sum(isinstance(s, RC.ReduceStage) for s in chain.stages[first:i])}"
    if isinstance(stage, RC.PermuteStage):
        return "B output"
    return type(stage).__name__


def heavy_cost(stage, n_x: int, cols=None):
    """(bytes, flops) of kernel E: the tiles (hvals, hpidx, hlo, hhi, hwidx),
    the slot map, x where the heavy rows read it (cols, their distinct
    columns, when given; else all of x) and each heavy row's sum written
    once; 2 flops per stored slot."""
    x_bytes = 4 * (n_x if cols is None else cols)
    return nbytes(stage.hvals, stage.hpidx, stage.hlo, stage.hhi, stage.hwidx, stage.slot_ptr,
                  stage.slot_idx, stage.rows) + x_bytes + 4 * stage.rows.numel(), \
        2 * stage.hvals.numel()


def df_gather_take_us(stage, bufs) -> float:
    """The library yardstick of the df output gather, in us in a CUDA graph
    (as the kernel is timed): one f64 torch.take through the stage's map
    (its -1 pointed at a zero appended to the source), the pairs combined
    into f64 beforehand (not timed): the movement alone."""
    from spmv_openmp_cuda_tpu_torch.ops import dfloat as DF
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC

    src = RC._pairs(bufs, stage.src)
    src = DF.df_combine64(src[:, 0], src[:, 1])
    srcz = torch.cat([src, src.new_zeros(1)])
    idx = stage.imap.idx.reshape(-1)[:stage.n].long()
    idx = torch.where(idx >= 0, idx, src.numel())
    return graph_ms(lambda: torch.take(srcz, idx)) * 1e3


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device ms per call of fn: reps calls captured in one CUDA graph, the
    graph replayed `replays` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * reps)


def least_ms(moved_bytes: int, flops: int):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and f32
    operations over the f32 rate."""
    t_b, t_f = moved_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def library_spmv(csr, device, dtype=torch.float32):
    """cuSPARSE y = A @ x through torch.sparse on the same matrix (int32
    indices, f32 or f64 values), the yardstick; the port never calls it."""
    crow = torch.as_tensor(csr.indptr.astype(np.int32), device=device)
    col = torch.as_tensor(csr.indices.astype(np.int32), device=device)
    val = torch.as_tensor(csr.data, dtype=dtype, device=device)
    a = torch.sparse_csr_tensor(crow, col, val, size=csr.shape)
    return lambda v: a @ v


def bf16_ratio_limit(csr, x: np.ndarray) -> float:
    """check_ratio limit of a mode that stores values (and, for PL_DIA_BF16,
    x) in bf16: each product is off by at most 2^-7 of |a||x| (two roundings
    to 8 significant bits), on top of the f32 bound 1e-5*max|o| + 1e-6."""
    from spmv_openmp_cuda_tpu_torch.formats.matrix import CSRMatrix
    from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv

    o = serial_csr_spmv(csr, x)
    a = serial_csr_spmv(CSRMatrix(csr.shape, csr.indptr, csr.indices, np.abs(csr.data)), np.abs(x))
    f32 = 1e-5 * np.abs(o).max() + 1e-6
    return (1.01 * 2.0 ** -7 * a.max() + f32) / f32


def csr_ell_slice(dev, smi: str, csrs: dict):
    """The CSR/ELL mode matrix: ell_t_kernel and lanes_kernel against their
    plain versions (phase 2), the slice's main path with its launch counters
    from zero (phase 3: the harness over all 26 modes on delaunay_n12_like
    and over the mode matrix on sg_like at SG's published size, then the
    CLI's explicit modes; float64 binned), and their times (phase 5).
    Returns the kernels' entries of the JSON line."""
    import contextlib
    import io

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch import cli
    from spmv_openmp_cuda_tpu_torch.bench.harness import format_log, run_all
    from spmv_openmp_cuda_tpu_torch.bench.parse_log import parse_lines
    from spmv_openmp_cuda_tpu_torch.cli import time_per_call
    from spmv_openmp_cuda_tpu_torch.formats.lanes import prepare_lanes_small
    from spmv_openmp_cuda_tpu_torch.formats.matrix import device_ell
    from spmv_openmp_cuda_tpu_torch.io.mmio import write_mtx
    from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
    from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV
    from spmv_openmp_cuda_tpu_torch.ops import ell_cuda as EC
    from spmv_openmp_cuda_tpu_torch.ops import lanes_cuda as LC
    from spmv_openmp_cuda_tpu_torch.ops import registry
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
    from spmv_openmp_cuda_tpu_torch.utils import synth

    mats = {name: csrs[name] for name in ("delaunay_n12_like", "raefsky1_like", "cavity10_like",
                                          "thermal2_like", "sg_like", "west2021_like")}
    ells = {name: P.coo_to_ell(P.csr_to_coo(mats[name]))
            for name in ("sg_like", "thermal2_like", "delaunay_n12_like")}

    # -- phase 2: the two kernels against their plain versions -------------
    errs = {"ell_t": 0.0, "lanes": 0.0}

    def check(kernel, label, fn, plain, x, order=None):
        yk, yk2 = fn(x), fn(x)
        torch.cuda.synchronize()
        yp = plain(x)
        err = (yk - yp).abs().max().item()
        same = torch.equal(yk, yk2)
        ok = err <= bound(yp) and yk.abs().max().item() > 0 and same
        walk = ""
        if order is not None:  # the adds in the kernel's order, over the full width
            full = torch.equal(yk, order(x))
            ok = ok and full
            walk = f", torch.equal to the full-width walk: {full}"
        errs[kernel] = max(errs[kernel], err)
        log(f"phase 2: {label}: {kernel}_kernel max|y_k - y_p| = {err:.3e} <= {bound(yp):.3e}, "
            f"rerun bitwise equal: {same}{walk}: {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: {kernel}_kernel disagrees with its plain version")

    ell_ops = {}
    for name in ELL_T_CHECKS:
        mat = ell_ops[name] = device_ell(ells[name], transposed=True, device=dev)
        before = EC.ell_t_cuda.launches
        check("ell_t", f"{name} PL_ELL_ROWS_T (W_pad {mat.data.shape[0]}, M_pad {mat.data.shape[1]})",
              lambda v, o=mat: EC.ell_t_cuda(o, v), lambda v, o=mat: EC.ell_t_reference(o, v),
              normal_x(mats[name].shape[1], dev, seed=1), lambda v, o=mat: EC.ell_t_in_order(o, v))
        if EC.ell_t_cuda.launches != before + 2:  # the product and its rerun: one launch each
            raise AssertionError(f"{name}: an ELL-T product is not one launch")
    lanes_ops = {}
    wide = P.coo_to_csr(synth.random_uniform(4096, 50000, density=3e-4, seed=1))
    g64 = P.coo_to_csr(synth.random_uniform(8192, 8192, density=5e-4, seed=2))
    for name, csr in [(n, mats[n]) for n in LANES_CHECKS] + [("random_uniform 4096x50000", wide),
                                                             ("random_uniform 8192 (G=64)", g64)]:
        mat = lanes_ops[name] = prepare_lanes_small(csr, device=dev)
        before = LC.lanes_cuda.launches
        check("lanes", f"{name} PL_CSR_LANES ({mat.vals.shape[0]} slot rows, {len(mat.window_tiles)} "
              f"windows, G={mat.n_groups}, plan {LC._plan(mat, mat.vals.device)})",
              lambda v, o=mat: LC.lanes_cuda(o, v), lambda v, o=mat: LC.lanes_reference(o, v),
              normal_x(csr.shape[1], dev, seed=1))
        if LC.lanes_cuda.launches != before + 2:  # the product and its rerun: one launch each
            raise AssertionError(f"{name}: a lanes product is not one launch")

    # -- phase 3: the slice's main path, counters from zero -----------------
    # (PL_CSR_ROUTED and _BF16 on delaunay_n12_like run the small kernel)
    EC.ell_t_cuda.launches = 0
    LC.lanes_cuda.launches = 0
    RC.routed_small_cuda.launches = 0
    cfg = P.Config()
    reports = {}
    for name, (modes, refused) in HARNESS_RUNS.items():
        csr = mats[name]
        modes = list(modes or registry.names())
        x = fill_rnd_vector(csr.shape[1], seed=0)
        xn = np.random.default_rng(3).standard_normal(csr.shape[1])
        t = time.perf_counter()
        rep = reports[name] = run_all(csr, ells.get(name) or P.coo_to_ell(P.csr_to_coo(csr)), x, cfg,
                                      kernels=modes, name=name, device="cuda", x_check=xn)
        text = format_log(rep, cfg)
        print(text)
        rows = parse_lines(text.splitlines())
        if [r["funcID"] for r in rows] != modes or rows[0]["backend"] != "cuda":
            raise AssertionError(f"{name}: parse_log does not read the harness log back")
        bf16_lim = bf16_ratio_limit(csr, xn)
        for r in rep.results:
            if (r.error is not None) != (r.kernel in refused):
                raise AssertionError(f"{name} {r.kernel}: error {r.error!r}, expected a refusal: "
                                     f"{r.kernel in refused}")
            if r.error is not None:
                continue
            lim = bf16_lim if r.kernel.endswith("BF16") else 1.0
            if not r.ok or not r.check_ratio <= lim:
                raise AssertionError(f"{name} {r.kernel}: ok {r.ok}, x~N(0,1) check {r.check_ratio:.3e} "
                                     f"of the bound (limit {lim:.1f})")
        det0 = [r.kernel for r in rep.results if r.error is None and not r.deterministic]
        log(f"phase 3: harness on {name}: {len(modes)} modes in {time.perf_counter() - t:.1f}s, "
            f"{sum(r.error is None for r in rep.results)} prepared, all ok:1, det:1 and within the "
            f"x~N(0,1) bound (bf16 storage: {bf16_lim:.1f}x it); refused as expected: "
            f"{[r.kernel for r in rep.results if r.error]}; parse_log read {len(rows)} rows")
        if det0:
            raise AssertionError(f"{name}: a rerun of {det0} is not bitwise equal (det:0)")
    # the CLI's explicit modes, in this process so that the counters see them
    cli_runs = (
        ("CSR_ROWS", [], "CSR_ROWS", None), ("ELL_ROWS", [], "ELL_ROWS", None),
        ("PL_ELL_ROWS_T", [], "PL_ELL_ROWS_T", None), ("PL_CSR_LANES", [], "PL_CSR_LANES", None),
        ("PL_CSR_WINDOW", ["--dtype", "float64"], "CSR_ROWS_BINNED",
         "#dtype: float64 unsupported by CUDA mode PL_CSR_WINDOW; remapping to CSR_ROWS_BINNED"),
    )
    with tempfile.TemporaryDirectory() as d:
        mtx = os.path.join(d, "delaunay_n12_like.mtx")
        write_mtx(mtx, synth.preset("delaunay_n12_like"))
        for arg, extra, mode, line in cli_runs:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([mtx, "RNDVECT", arg, "--check", "--no-dump", *extra])
            out = buf.getvalue()
            print(out.rstrip())
            if rc != 0 or "#check: OK" not in out or f"computeMode:{mode} " not in out or \
                    (line and line not in out):
                raise AssertionError(f"CLI {arg} {extra} on delaunay_n12_like failed (exit {rc})")
            log(f"phase 3: CLI {arg} {' '.join(extra)} --check OK ({mode})")
    torch.cuda.synchronize()
    launches = {"ell_t": EC.ell_t_cuda.launches, "lanes": LC.lanes_cuda.launches,
                "small": RC.routed_small_cuda.launches}
    log(f"phase 3: the CSR/ELL slice's main path launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the CSR/ELL slice never launched: {launches}")
    # float64: the binned engine, native f64 torch ops, against the exact oracle
    for name in ("sg_like", "thermal2_like"):
        csr = mats[name]
        t = time.perf_counter()
        model = AutoSpMV.from_csr(csr, cfg=P.Config(dtype="float64"), format="binned", device="cuda")
        prep_s = time.perf_counter() - t
        xn = np.random.default_rng(3).standard_normal(csr.shape[1])
        y = model(xn)
        if model.format != "binned" or y.dtype != torch.float64 or y.shape != (csr.shape[0],) or \
                not torch.isfinite(y).all():
            raise AssertionError(f"{name}: float64 binned output {model.format} {y.dtype} {y.shape}")
        o = serial_csr_spmv(csr, xn)
        rel = np.abs(y.cpu().numpy() - o).max() / np.abs(o).max()
        log(f"phase 3 (float64): {name} AutoSpMV(format='binned'), prepare+upload {prep_s:.1f}s: "
            f"{rel:.3e} * max|y| of the exact oracle <= 1e-11")
        if not rel <= 1e-11:
            raise AssertionError(f"{name}: wrong float64 binned output")

    # -- phase 5: times ----------------------------------------------------
    print(f"CSR/ELL slice times on {smi} (CUDA events, per call through the wrapper, after "
          "warm-up; graph = the same call in a CUDA graph, device time):")
    times = {}
    for kernel, name, mat, fn, plain, moved, flops in (
        # ELL-T's bound: the values and columns of the nonzero slots and its
        # walk table (the slab's whole bytes printed beside it)
        *(("ell_t", n, ell_ops[n], EC.ell_t_cuda, EC.ell_t_reference,
           8 * mats[n].nnz + nbytes(EC._plan(ell_ops[n], ell_ops[n].data.device)), 2 * mats[n].nnz)
          for n in ELL_T_CHECKS),
        *(("lanes", n, lanes_ops[n], LC.lanes_cuda, LC.lanes_reference,
           nbytes(lanes_ops[n].vals, lanes_ops[n].pidx, lanes_ops[n].gid, lanes_ops[n].tile_win),
           2 * lanes_ops[n].vals.numel()) for n in LANES_CHECKS),
    ):
        csr = mats[name]
        m, n = csr.shape
        x = normal_x(n, dev, seed=4)
        tk = time_per_call(lambda v: fn(mat, v), x)
        tg = graph_ms(lambda: fn(mat, x)) / 1e3
        tp = time_per_call(lambda v: plain(mat, v), x)
        lib_fn = library_spmv(csr, dev)
        tl = time_per_call(lib_fn, x)
        b_ms, by = least_ms(moved + 4 * (n + m), flops)
        times[(kernel, name)] = (tk, tp, tl, b_ms, by)
        print(f"  {name:20s} {kernel}_kernel {tk * 1e3:8.4f} ms per call ({tg * 1e3:.4f} ms in a graph, "
              f"host {max(tk - tg, 0) * 1e6:.1f} us) | plain {tp * 1e3:8.4f} ms | library (cuSPARSE "
              f"CSR f32) {tl * 1e3:8.4f} ms | bound {b_ms:.5f} ms ({by}, {(moved + 4 * (n + m)) / 1e6:.2f} "
              f"MB); graphed kernel at {100 * b_ms / (tg * 1e3):.1f} % of it")
        if kernel == "ell_t":
            # host time per call: unsynchronised calls on the host clock
            for _ in range(20):
                fn(mat, x)
            torch.cuda.synchronize()
            reps = 500
            t = time.perf_counter()
            for _ in range(reps):
                fn(mat, x)
            host = (time.perf_counter() - t) / reps
            torch.cuda.synchronize()
            tlg = graph_ms(lambda: lib_fn(x)) / 1e3
            walk = EC._plan(mat, mat.data.device)
            rows = torch.full_like(walk, EC.GROUP_ROWS)
            rows[-1] = m - EC.GROUP_ROWS * (walk.numel() - 1)
            walked = 8 * int((walk.long() * rows.long()).sum())
            slab = nbytes(mat.data, mat.cols) + 4 * (n + m)
            s_ms = least_ms(slab, 2 * mat.data.numel())[0]
            print(f"  {name:20s} ell_t_kernel: host {host * 1e6:.2f} us per call (time.perf_counter "
                  f"over {reps} unsynchronised calls) | cuSPARSE {tl * 1e3:.4f} ms per call, "
                  f"{tlg * 1e3:.4f} ms graphed: kernel {tk / tl:.3f}x per call, {tg / tlg:.3f}x "
                  f"graphed | walks {walked / 1e6:.2f} MB of slab | bound of the nonzero slots "
                  f"{b_ms:.5f} ms, graphed kernel at {100 * b_ms / (tg * 1e3):.1f} %; slab bound "
                  f"{s_ms:.5f} ms ({slab / 1e6:.2f} MB), at {100 * s_ms / (tg * 1e3):.1f} %")
        del lib_fn
    sg = mats["sg_like"]
    rm = device_ell(ells["sg_like"], device=dev)
    print(f"  sg_like ELL slabs: row-major {tuple(rm.data.shape)} {nbytes(rm.data, rm.cols) / 1e6:.1f} MB "
          f"against transposed {tuple(ell_ops['sg_like'].data.shape)} "
          f"{nbytes(ell_ops['sg_like'].data, ell_ops['sg_like'].cols) / 1e6:.1f} MB and "
          f"{12 * sg.nnz / 1e6:.1f} MB of CSR values and columns")
    del rm
    tl = times[("ell_t", "sg_like")][2]
    print(f"  sg_like modes, harness internal time per call (library cuSPARSE {tl * 1e3:.4f} ms):")
    for r in reports["sg_like"].results:
        if r.error is None:
            print(f"    {r.kernel:18s} [{r.impl}] {r.internal_time_avg * 1e3:8.4f} ms  "
                  f"{r.gflops:8.2f} GFLOP/s  {r.internal_time_avg / tl:6.2f}x cuSPARSE  det:{int(r.deterministic)}")
    out = []
    for kernel, name, source, replaces in (
        ("ell_t", "sg_like", ELL_SOURCE, "spmv_openmp_cuda_tpu/ops/spmv_pallas.py:78"),
        ("lanes", "delaunay_n12_like", LANES_SOURCE, "spmv_openmp_cuda_tpu/formats/lanes.py:170"),
    ):
        tk, tp, tl, b_ms, by = times[(kernel, name)]
        out.append({"name": f"{kernel}_kernel", "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[kernel], "max_abs_err": errs[kernel], "ms": tk * 1e3,
                    "plain_ms": tp * 1e3, "bound_ms": b_ms, "bound_by": by, "library_ms": tl * 1e3})
    return out, launches["small"]


#: phase 6 (solvers): CG on the 5-point 2D Laplacian of a LAPLACE_N x
#: LAPLACE_N grid (1,000,000 rows, 4,996,000 nnz) in float32 (DIA) and
#: float64 (df DIA), on caida_like made SPD (AUTO's pick) and on a window
#: layout of WINDOW_SOLVE made SPD; power iteration on caida_like made SPD.
#: The window solve was to take thermal2_like made SPD if its native
#: prepare took at most 30 s: it took 62.7 s (15,614,531 nnz; on the host
#: of one H100 80GB HBM3), so it takes delaunay_n12_like made SPD
LAPLACE_N = 1000
CG_TOL32, CG_TOL64, CG_MAXITER = 1e-5, 1e-10, 5000
WINDOW_SOLVE = "delaunay_n12_like"
POWER_ITERS = 100


def laplacian_2d(n: int):
    """The 5-point Laplacian of an n x n grid (utils/synth.py) as CSR."""
    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.utils import synth

    return P.coo_to_csr(synth.laplacian_2d(n))


def spd_of(csr):
    """A + A^T with the diagonal set to each row's absolute sum + 1:
    symmetric and strictly diagonally dominant, so SPD."""
    import spmv_openmp_cuda_tpu_torch as P

    m, n = csr.shape
    rows, cols = csr.row_ids().astype(np.int64), csr.indices.astype(np.int64)
    off = rows != cols
    key, inv = np.unique(np.concatenate([rows[off] * n + cols[off], cols[off] * n + rows[off]]),
                         return_inverse=True)
    v = np.bincount(inv, weights=np.concatenate([csr.data[off], csr.data[off]]), minlength=key.size)
    diag = np.bincount(key // n, weights=np.abs(v), minlength=m) + 1.0
    key = np.concatenate([key, np.arange(m, dtype=np.int64) * (n + 1)])
    v = np.concatenate([v, diag])
    order = np.argsort(key, kind="stable")
    key, v = key[order], v[order]
    return P.coo_to_csr(P.COOMatrix((m, n), key // n, key % n, v))


def _timed(fn):
    """(fn(), its wall seconds, the card synchronized at both ends)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


#: rounds of (eager, default, graph=True) whole solves, the order rotated
#: each round; times are the medians
SOLVE_ROUNDS = 3


def _rounds(solve):
    """solve(graph) for graph in (False, None, True), SOLVE_ROUNDS rounds:
    ({graph: the last result}, {graph: [seconds per round]})."""
    graphs = [False, None, True]
    out, secs = {}, {g: [] for g in graphs}
    for i in range(SOLVE_ROUNDS):
        for g in graphs[i:] + graphs[:i]:
            out[g], t = _timed(lambda: solve(g))
            secs[g].append(t)
    return out, secs


def _spread(ts) -> str:
    return f"{min(ts):.4f}-{max(ts):.4f}"


def solve_cg(label: str, model, ocsr, b_np: np.ndarray, tol: float, dev) -> dict:
    """One CG solve three ways, each timed whole (SOLVE_ROUNDS rounds, the
    medians): eager (graph=False), the default (graph=None: eager for the
    first GRAPH_AFTER iterations, graphed after) and graphed from the first
    iteration (graph=True, its capture included). Gates: every x torch.equal to eager x with the same
    iteration count, converged before CG_MAXITER, the true relative
    residual (float64 on the host, the matrix as stored) <= 10 * tol.
    Also the replays of one captured chunk alone per iteration (CUDA
    events) beside the product's graphed time."""
    from spmv_openmp_cuda_tpu_torch.models import solvers as S
    from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv

    dt = torch.float64 if model.dtype == "float64" else torch.float32
    b = torch.as_tensor(b_np, dtype=dt, device=dev)
    S.conjugate_gradient(model, b, tol=tol, maxiter=2, graph=False)  # first launches: plans
    sols, secs = _rounds(lambda g: S.conjugate_gradient(model, b, tol=tol, maxiter=CG_MAXITER,
                                                        graph=g))
    eager, res = sols[False], sols[None]
    t_eager, t_default, t_graph = (float(np.median(secs[g])) for g in (False, None, True))
    iters = int(eager.iters)
    same = all(torch.equal(r.x, eager.x) and int(r.iters) == iters for r in sols.values())
    # the replays alone: one chunk captured, replayed from the first state
    state, thr, _ = S.cg_initial(model, b, torch.zeros_like(b), tol)
    first = [v.clone() for v in state]
    graph, active = S.cg_graph(model, state, thr, CG_MAXITER, S.CHUNK)
    for dst, src in zip(state, first):
        dst.copy_(src)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    replays = 0
    start.record()
    while True:
        graph.replay()
        replays += 1
        if not bool(active):
            break
    stop.record()
    torch.cuda.synchronize()
    t_replay = start.elapsed_time(stop) / 1e3
    same = same and torch.equal(state[0], eager.x)
    p = torch.as_tensor(np.random.default_rng(9).standard_normal(b.numel()), dtype=dt, device=dev)
    mv_ms = graph_ms(lambda: model(p))
    lib = library_spmv(ocsr, dev, dt)
    lib_ms = graph_ms(lambda: lib(p))
    bh = b.double().cpu().numpy()
    true = np.linalg.norm(bh - serial_csr_spmv(ocsr, res.x.double().cpu().numpy())) / np.linalg.norm(bh)
    per = 1e3 / max(iters, 1)
    out = {"iters": iters, "relres": float(res.relres), "true": true,
           "eager_ms": t_eager * per, "default_ms": t_default * per, "graph_true_ms": t_graph * per,
           "graphed_ms": t_replay * per, "mv_ms": mv_ms, "replays": replays, "lib_ms": lib_ms,
           "eager_s": t_eager, "default_s": t_default, "graph_true_s": t_graph}
    log(f"phase 6: {label}: {iters} iterations, relres {out['relres']:.3e}, "
        f"true relative residual {true:.3e} (f64 on the host, the matrix as stored) <= "
        f"{10 * tol:.0e}; whole solve, median of {SOLVE_ROUNDS} (range): eager {t_eager:.4f} s "
        f"({_spread(secs[False])}), default {t_default:.4f} s ({_spread(secs[None])}; graphed "
        f"after {S.GRAPH_AFTER}, eager/default {t_eager / t_default:.3f}x), graph=True "
        f"{t_graph:.4f} s ({_spread(secs[True])}, its capture included); per iteration {out['eager_ms']:.4f} ms eager, {out['default_ms']:.4f} "
        f"default, {out['graph_true_ms']:.4f} graph=True, {out['graphed_ms']:.4f} replays alone "
        f"({replays} of {S.CHUNK} iterations), the product alone {mv_ms:.4f} ms graphed "
        f"(cuSPARSE {lib_ms:.4f}): the solver's own {out['graphed_ms'] - mv_ms:.4f} ms per "
        f"graphed iteration; default and graphed x torch.equal eager x: {same}")
    if not (same and iters < CG_MAXITER and true <= 10 * tol):
        raise AssertionError(f"{label}: CG failed its gates ({out})")
    return out


def laplacian_dia_products(dev, lap, models) -> dict:
    """The DIA rows kernels on the Laplacian, CG's product, before the
    solver path's counters are zeroed: each f32 (dia_rows_kernel) and f64
    (dia_df_kernel) product one launch, a rerun bitwise equal, against its
    plain version (f32 within the f32 bound, f64 torch.equal), then per call,
    graphed, plain, cuSPARSE per call and graphed, and the bound (the slab's
    first m rows, the offsets, x and y once). Returns {counter: cell} for
    the kernels line."""
    from spmv_openmp_cuda_tpu_torch.cli import time_per_call
    from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda as SC

    cells = {}
    for model in models:
        f64 = model.dtype == "float64"
        mat, plan = model._operands
        wrap = SC.dia_spmv_df_cuda if f64 else SC.dia_spmv_cuda
        plain = SC.dia_spmv_df_reference if f64 else SC.dia_spmv_reference
        x = (normal_x64 if f64 else normal_x)(lap.shape[1], dev, seed=4)

        def run(v, mat=mat, plan=plan, wrap=wrap):
            return wrap(mat, v, plan)

        before = wrap.launches
        yk, y2 = run(x), run(x)
        torch.cuda.synchronize()
        yp = plain(mat, x, plan)
        err = (yk - yp).abs().max().item()
        ok = (torch.equal(yk, yp) if f64 else err <= bound(yp)) and torch.equal(yk, y2)
        ok = ok and wrap.launches == before + 2 and yk.shape == (lap.shape[0],)
        kernel = "dia_df_kernel" if f64 else "dia_rows_kernel"
        log(f"phase 6: Laplacian {model.dtype} {kernel} ({SC._rows_plan(mat, plan, x.device)} row(s) a "
            f"thread): {wrap.launches - before} launches for two products, rerun bitwise equal "
            f"{torch.equal(yk, y2)}, max|y_k - y_p| = {err:.3e} "
            f"({'torch.equal' if f64 else f'<= {bound(yp):.3e}'}): {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"Laplacian {model.dtype}: {kernel} failed its checks")
        lib = library_spmv(lap, dev, x.dtype)
        live, slots = dia_live(mat)
        moved = live + x.element_size() * sum(lap.shape)
        b_ms, by = least_ms(moved, (DF_FLOPS_PER_SLOT if f64 else 2) * slots)
        cell = {"ms": time_per_call(run, x) * 1e3, "graph_ms": graph_ms(lambda: run(x)),
                "plain_ms": time_per_call(lambda v: plain(mat, v, plan), x) * 1e3,
                "bound_ms": b_ms, "bound_by": by, "library_ms": time_per_call(lib, x) * 1e3,
                "library_graph_ms": graph_ms(lambda: lib(x)), "max_abs_err": err}
        cells["dia_df" if f64 else "dia_spmv"] = cell
        print(f"  Laplacian {LAPLACE_N}x{LAPLACE_N} {model.dtype} {kernel}: {cell['ms']:.4f} ms per "
              f"call ({cell['graph_ms']:.4f} ms in a CUDA graph) | plain {cell['plain_ms']:.4f} ms | "
              f"library (cuSPARSE CSR {model.dtype}) {cell['library_ms']:.4f} ms "
              f"({cell['library_graph_ms']:.4f} graphed) | bound {b_ms:.4f} ms ({by}, "
              f"{moved / 1e6:.1f} MB); graphed kernel at {100 * b_ms / cell['graph_ms']:.1f} % of it")
        del lib
    return cells


def solver_phase(dev, csrs: dict, mats: dict, models: dict, models64: dict, seed: int) -> dict:
    """Phase 6: the DIA rows kernels on the Laplacian (laplacian_dia_products,
    returned), then the solvers' main path with its launch counters from
    zero (CG and power iteration over AutoSpMV, graphed and eager), then
    prepared files saved and loaded on the card, and the native library's
    layouts against the numpy ones."""
    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.formats import routed as RT
    from spmv_openmp_cuda_tpu_torch.formats import serialize as SER
    from spmv_openmp_cuda_tpu_torch.formats import window as W
    from spmv_openmp_cuda_tpu_torch.io import native as N
    from spmv_openmp_cuda_tpu_torch.models import solvers as S
    from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV
    from spmv_openmp_cuda_tpu_torch.ops import registry
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda as SC
    from spmv_openmp_cuda_tpu_torch.ops import window_cuda as WC
    from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv

    if not N.available():
        raise AssertionError(f"the native library is not in use on the card: {N.failure()}")
    log(f"phase 6: native library in use: {N.library_path()}")
    rng = np.random.default_rng(seed)
    # -- the systems and their models (prepares, not counted) -------------
    t = time.perf_counter()
    lap = laplacian_2d(LAPLACE_N)
    log(f"phase 6: Laplacian {LAPLACE_N}x{LAPLACE_N}: {lap.shape[0]} rows, {lap.nnz} nnz, "
        f"built in {time.perf_counter() - t:.1f}s")
    systems = []  # (label, model, matrix as stored, x*, tol)
    for dtype, tol in (("float32", CG_TOL32), ("float64", CG_TOL64)):
        t = time.perf_counter()
        model = AutoSpMV.from_csr(lap, cfg=P.Config(dtype=dtype), device=dev)
        log(f"phase 6: Laplacian {dtype}: AUTO -> {model.format}, prepare+upload "
            f"{time.perf_counter() - t:.1f}s")
        if model.format != "dia":
            raise AssertionError(f"Laplacian: AUTO picked {model.format}, expected dia")
        systems.append((f"CG {dtype} Laplacian (AUTO {model.format})", model, lap,
                        rng.standard_normal(lap.shape[0]), tol))
    lap_cells = laplacian_dia_products(dev, lap, [model for _, model, *_ in systems])
    t = time.perf_counter()
    caida = spd_of(csrs[ROUTED_CHECK])
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    cmodel = AutoSpMV.from_csr(caida, device=dev)
    ops = cmodel._operands
    domains = len(ops.mat.chunks) if isinstance(getattr(ops, "mat", None), RT.RoutedChunks) else 1
    log(f"phase 6: {ROUTED_CHECK} made SPD: {caida.nnz} nnz (built in {gen_s:.1f}s), AUTO -> "
        f"{cmodel.format}, prepare+upload {time.perf_counter() - t:.1f}s"
        + (f", {domains} routed domain(s), per product {ops.counts}" if cmodel.format == "routed" else ""))
    cstored = RC.stored_csr(caida, cmodel._operands) if cmodel.format == "routed" else caida
    systems.append((f"CG float32 {ROUTED_CHECK} SPD (AUTO {cmodel.format})", cmodel, cstored,
                    rng.standard_normal(caida.shape[0]), CG_TOL32))
    wname = WINDOW_SOLVE
    wspd = spd_of(csrs[wname])
    t = time.perf_counter()
    wmodel = AutoSpMV.from_csr(wspd, format="window", device=dev)
    log(f"phase 6: {wname} made SPD: {wspd.nnz} nnz, format window -> {wmodel.format}, prepare+upload "
        f"{time.perf_counter() - t:.1f}s (thermal2_like made SPD took 62.7 s to prepare natively, "
        "over the 30 s the window solve may take)")
    if wmodel.format != "window":
        raise AssertionError(f"{wname} made SPD: no window layout ({wmodel.format})")
    systems.append((f"CG float32 {wname} SPD (window)", wmodel, wspd,
                    rng.standard_normal(wspd.shape[0]), CG_TOL32))

    # -- the solver path, counters from zero --------------------------------
    counters = {
        "dia_spmv": SC.dia_spmv_cuda, "dia_df": SC.dia_spmv_df_cuda,
        "dia_resid": SC.dia_resid_spmv_cuda, "dia_resid_df": SC.dia_resid_spmv_df_cuda,
        "window_blocks": WC.window_blocks_cuda, "window_single": WC.window_single_cuda,
        "window_df": WC.window_df_cuda, **RC._COUNTERS,
        **{f"routed_{k}": fn for k, fn in RC._DF_COUNTERS.items()},
    }
    for fn in counters.values():
        fn.launches = 0
    results = {}
    for label, model, ocsr, xstar, tol in systems:
        b = serial_csr_spmv(ocsr, xstar)
        results[label] = solve_cg(label, model, ocsr, b, tol, dev)
    n = caida.shape[0]
    pows, psecs = _rounds(lambda g: S.power_iteration(cmodel, n, iters=POWER_ITERS, seed=seed,
                                                      graph=g))
    pe, pd, pg = (pows[g] for g in (False, None, True))
    t_pe, t_pd, t_pg = (float(np.median(psecs[g])) for g in (False, None, True))
    launches = {k: fn.launches for k, fn in counters.items()}
    v = S.start_vector(n, seed, torch.float32).double().numpy()
    v /= np.linalg.norm(v)
    for _ in range(POWER_ITERS):
        w = serial_csr_spmv(cstored, v)
        v = w / np.linalg.norm(w)
    lam_host = float(v @ serial_csr_spmv(cstored, v) / (v @ v))
    lam = float(pg.eigenvalue)
    same = all(torch.equal(r.eigenvector, pe.eigenvector) and torch.equal(r.eigenvalue, pe.eigenvalue)
               for r in (pd, pg))
    rel = abs(lam - lam_host) / abs(lam_host)
    log(f"phase 6: power iteration ({POWER_ITERS} iterations) on {ROUTED_CHECK} SPD: eigenvalue "
        f"{lam:.6f}, float64 host run from the same v0 {lam_host:.6f}, relative {rel:.3e} <= 1e-4; "
        f"whole run, median of {SOLVE_ROUNDS} (range): eager {t_pe:.4f} s ({_spread(psecs[False])}), "
        f"default {t_pd:.4f} s ({_spread(psecs[None])}; graphed after {S.GRAPH_AFTER}), "
        f"graph=True {t_pg:.4f} s ({_spread(psecs[True])}; {POWER_ITERS // S.CHUNK} replays of "
        f"{S.CHUNK}, capture included); default and graphed torch.equal eager: {same}")
    if not (same and rel <= 1e-4):
        raise AssertionError("power iteration failed its gates")
    # every kernel of the solver path launched (captured launches count
    # once: a replay runs no wrapper)
    want = {"dia_spmv", "dia_df", "window_single" if wmodel._operands.xdirect else "window_blocks"}
    if cmodel.format == "routed":
        want |= {k for k, v in cmodel._operands.counts.items() if v}
    log(f"phase 6: the solver path's launches {({k: v for k, v in launches.items() if v})}")
    if not all(launches[k] for k in want):
        raise AssertionError(f"a kernel of the solver path never launched: {launches}, wanted {want}")

    # -- prepared files: save on the card, load on the card ----------------
    sg = mats["sg_like"]
    files = [
        ("raefsky1_like", "PL_DIA_RESID", models["raefsky1_like"]._operands),
        ("delaunay_n12_like", "PL_CSR_WINDOW", models["delaunay_n12_like"]._operands),
        (ROUTED_CHECK, "PL_CSR_ROUTED", models[ROUTED_CHECK]._operands),
        (ROUTED_CHECK, "PL_CSR_ROUTED_F64", models64[ROUTED_CHECK]._operands),
        ("sg_like", "PL_ELL_ROWS_T", registry.get("PL_ELL_ROWS_T").prepare(
            sg, P.coo_to_ell(P.csr_to_coo(sg)), P.Config(), dev)),
        ("Laplacian", "PL_DIA_ROWS", systems[0][1]._operands),
        ("Laplacian", "PL_DIA_F64", systems[1][1]._operands),
    ]
    with tempfile.TemporaryDirectory() as d:
        for name, mode, ops in files:
            spec = registry.get(mode)
            path = os.path.join(d, f"{name}_{mode}.npz")
            t = time.perf_counter()
            try:
                SER.save_prepared(path, ops)
            except TypeError:
                log(f"phase 6: {name} {mode}: not serializable (TypeError), as in the JAX package: "
                    f"it writes no DIA+residual pair")
                continue
            save_s = time.perf_counter() - t
            t = time.perf_counter()
            loaded = SER.load_prepared(path, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            n_x = (ops[0] if isinstance(ops, tuple) else ops).shape[1]
            x = torch.as_tensor(np.random.default_rng(4).standard_normal(n_x),
                                dtype=torch.float64 if spec.f64 else torch.float32, device=dev)
            equal = torch.equal(spec.jitted(loaded)(x), spec.jitted(ops)(x))
            log(f"phase 6: {name} {mode}: saved in {save_s:.2f}s ({os.path.getsize(path) / 2**20:.2f} "
                f"MiB), loaded on cuda in {load_s:.2f}s; y torch.equal the prepared y: {equal}")
            if not equal:
                raise AssertionError(f"{name} {mode}: the loaded operands give another y")

    # -- the native library's layouts against the numpy path ---------------
    for name in ("delaunay_n12_like", ROUTED_CHECK):
        csr = csrs[name]
        preps = [("routed", lambda: RT.prepare_routed(csr, device=dev))]
        if name == "delaunay_n12_like":
            preps.append(("window", lambda: W.prepare_window_auto(csr, device=dev)))
        for fmt, prep in preps:
            t = time.perf_counter()
            nat = prep()
            t_nat = time.perf_counter() - t
            with mock.patch.object(N, "load_library", lambda: None):  # the numpy paths
                t = time.perf_counter()
                ref = prep()
                t_np = time.perf_counter() - t
            equal = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else np.array_equal(a, b)
                        for a, b in zip(SER._leaves(nat), SER._leaves(ref)))
            same_static = SER._aux_of(nat) == SER._aux_of(ref)
            log(f"phase 6: {name} {fmt} layout: native prepare {t_nat:.2f}s, numpy {t_np:.2f}s; "
                f"every array equal: {equal and same_static}")
            if not (equal and same_static):
                raise AssertionError(f"{name} {fmt}: the native layout differs from the numpy one")
    return lap_cells


#: phase 7 (multi-device): each path of spmv_openmp_cuda_tpu_torch/parallel/
#: on MD_SHARDS shards (shard i on cuda:(i mod the card count): on one card
#: the shards share it, the counterpart of the JAX package's virtual
#: devices), at full size: path -> (matrix, shard counts timed). The
#: Laplacian is phase 6's; csr_psum's check runs the 2 x 2 mesh
MD_SHARDS = 4
LAPLACE = f"laplacian_{LAPLACE_N}x{LAPLACE_N}"
MD_CELLS = {
    "window_halo": ("thermal2_like", (1, 2, 4)),
    "routed_spmd": (ROUTED_CHECK, (1, 2, 4)),
    "dia_halo": (LAPLACE, (1, 2, 4)),
    "routed_md": (ROUTED_CHECK, (1, 4)),
    "dia_halo_df": (LAPLACE, (1, 4)),
    "ell_rows": ("sg_like", (1, 4)),
    "csr_psum": ("sg_like", (1,)),
    "ell_ring": ("sg_like", (1, 4)),
}
#: the kernel-running paths' entries in the kernels line: the JAX call site
#: each replaces
MD_KERNELS = {
    "window_halo": ("window_blocks_kernel", WINDOW_SOURCE,
                    "spmv_openmp_cuda_tpu/parallel/sharded.py:695"),
    "routed_spmd": ("routed chain (A, C, B)", ROUTED_SOURCE,
                    "spmv_openmp_cuda_tpu/parallel/routed_spmd.py:125"),
    "routed_md": ("routed chain (A, C, D, B)", ROUTED_SOURCE,
                  "spmv_openmp_cuda_tpu/parallel/sharded.py:786"),
}


def multi_device_phase(dev, smi: str, csrs: dict, mats: dict, models: dict):
    """Phase 7: the contract's dryrun_multichip(MD_SHARDS) and every
    multi-device path at full size on MD_SHARDS shards, each held three
    ways (the reference protocol, x ~ N(0, 1) against the f64 oracle, a
    bitwise rerun), the window and SPMD routed paths to their single-device
    twins bit for bit, the launches per product counted, and the times per
    product at 1, 2 and 4 shards beside the single-device product. Returns
    the kernel-running paths' entries of the kernels line, and what phase 8
    holds its ranks to: the dryrun's y per path, and per full-size path its
    matrix, x ~ N(0, 1), output and cuSPARSE time."""
    import types

    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch import contract
    from spmv_openmp_cuda_tpu_torch.bench import scaling
    from spmv_openmp_cuda_tpu_torch.cli import time_per_call
    from spmv_openmp_cuda_tpu_torch.formats import routed as RT
    from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
    from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.ops import window_cuda as WC
    from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
    from spmv_openmp_cuda_tpu_torch.utils.compare import vectors_diff

    t_phase = time.perf_counter()
    devices = contract.mesh_devices(MD_SHARDS)
    virtual = len(set(devices)) < MD_SHARDS
    log(f"phase 7: {MD_SHARDS} shards on {sorted({str(d) for d in devices})}"
        f"{' (virtual: the shards share one card; times are not a scaling measurement)' if virtual else ''}")
    lap = laplacian_2d(LAPLACE_N)
    matrices = {**csrs, **mats, LAPLACE: lap}
    coos = {}
    single = {}  # (matrix, dtype) -> (the single-device product, what it is)
    for name in sorted({v[0] for v in MD_CELLS.values()}):
        if name == LAPLACE:
            for dtype in ("float32", "float64"):
                lap_model = AutoSpMV.from_csr(lap, cfg=P.Config(dtype=dtype), device=dev)
                single[name, dtype] = (lap_model, f"AutoSpMV -> {lap_model.format}, {dtype}")
        elif name in models:
            single[name, "float32"] = (models[name], f"AutoSpMV -> {models[name].format}")
        coos[name] = P.csr_to_coo(matrices[name])
    # -- the paths' operands and their times at 1, 2 and 4 shards ---------
    built, rows = {}, {}
    for path, (name, counts) in MD_CELLS.items():
        t = time.perf_counter()
        b = built[path] = {}
        rows[path] = scaling.measure(name, list(counts), path, device=dev, coo=coos[name],
                                     built=b)
        if path == "csr_psum":
            b[MD_SHARDS] = scaling.build(path, coos[name], matrices[name], devices,
                                         mesh_shape=(2, 2))
        if not all(ok for *_, ok in rows[path]):
            raise AssertionError(f"phase 7: {path}: the scaling harness's check failed")
        log(f"phase 7: {path} on {name}: prepared and timed at {counts} shards in "
            f"{time.perf_counter() - t:.1f}s")
    # -- the main path, each part with the counters from zero just before
    # it and read just after: the contract's dryrun, then one product set
    # per path (x_ref, x_n, a rerun) on MD_SHARDS shards --------------------
    def zero_counts():
        WC.window_blocks_cuda.launches = 0
        for fn in RC._COUNTERS.values():
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        got = {"window_blocks": WC.window_blocks_cuda.launches,
               **{k: fn.launches for k, fn in RC._COUNTERS.items()}}
        return {k: v for k, v in got.items() if v}

    zero_counts()
    t = time.perf_counter()
    refs = {"dryrun": contract.dryrun_multichip(MD_SHARDS)}
    dry = read_counts()
    log(f"phase 7: contract.dryrun_multichip({MD_SHARDS}) on the card: all eight paths OK in "
        f"{time.perf_counter() - t:.1f}s; its launches {dry}")
    if dev.type == "cuda" and not (dry.get("window_blocks") and dry.get("gather")):
        raise AssertionError("phase 7: a kernel of the contract's dryrun never launched")
    checks, per_product, own = {}, {}, {}
    for path, (name, _counts) in MD_CELLS.items():
        p = built[path][MD_SHARDS]
        csr = matrices[name]
        df = path == "dia_halo_df"
        if path in ("routed_spmd", "routed_md"):
            chains = p.op.chains
            stored = RC.stored_csr(csr, types.SimpleNamespace(mat=RT.RoutedChunks(
                chunks=tuple(c.mat for c in chains), bounds=p.op.bounds, shape=csr.shape,
                nnz=csr.nnz)))
        else:
            stored = csr
        x_ref = fill_rnd_vector(csr.shape[1], seed=2)
        x_n = np.random.default_rng(3).standard_normal(csr.shape[1])
        zero_counts()
        rep = vectors_diff(p.y(x_ref), serial_csr_spmv(stored, x_ref))
        xs = p.place(x_n)
        before = {k: fn.launches for k, fn in RC._COUNTERS.items()}
        before_w = WC.window_blocks_cuda.launches
        out = p.product(xs)
        torch.cuda.synchronize()
        launched = {k: fn.launches - before[k] for k, fn in RC._COUNTERS.items()}
        launched["window_blocks"] = WC.window_blocks_cuda.launches - before_w
        again = p.product(xs)
        own[path] = read_counts()  # three products: x_ref, x_n, the rerun
        same = (all(torch.equal(a, b) for a, b in zip(out, again)) if df
                else torch.equal(out, again))
        y = p.result(out)
        o = serial_csr_spmv(stored, x_n)
        err = np.abs(y - o).max()
        lim = 1e-10 * np.abs(o).max() if df else 1e-5 * np.abs(o).max() + 1e-6
        if not (np.isfinite(y).all() and y.shape == (csr.shape[0],)):
            raise AssertionError(f"phase 7: {path}: output {y.shape}, finite {np.isfinite(y).all()}")
        # launches per product: one window launch per shard; the routed
        # chains' planned launches, shard by shard
        if path == "window_halo":
            want = {"window_blocks": MD_SHARDS}
        elif path in ("routed_spmd", "routed_md"):
            want = {k: sum(c.counts[k] for c in p.op.chains) for k in RC._COUNTERS}
            if path == "routed_spmd" and any(c.counts != p.op.chains[0].counts for c in p.op.chains):
                raise AssertionError("phase 7: the SPMD chunks' chains differ")
        else:
            want = {}
        got = {k: v for k, v in launched.items() if v}
        if dev.type == "cuda" and got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"phase 7: {path}: launches per product {got}, planned {want}")
        if own[path] != {k: 3 * v for k, v in got.items()}:
            raise AssertionError(f"phase 7: {path}: launches {own[path]} in its three products")
        per_product[path] = got
        log(f"phase 7: {path} on {name} ({MD_SHARDS} shards): reference protocol "
            f"{'OK' if rep.ok else 'FAIL'} maxAbsDiff={rep.max_abs_diff:.3e}; x~N(0,1) vs f64 "
            f"oracle{' (as stored)' if stored is not csr else ''} {err:.3e} <= {lim:.3e}; rerun "
            f"bitwise equal {same}; launches per product {got or 'none (plain torch)'}")
        if not (rep.ok and err <= lim and same):
            raise AssertionError(f"phase 7: {path}: wrong output")
        checks[path] = (p, xs, out, x_n)
    log(f"phase 7: each path's launches in its three products {({k: v for k, v in own.items() if v})}")
    for path in MD_KERNELS:
        if dev.type == "cuda" and not own[path]:
            raise AssertionError(f"phase 7: {path}: its kernels never launched")
    # -- parity with the single-device twins --------------------------------
    p, xs, y_w, x_n = checks["window_halo"]
    lay = p.op.layout
    lay_dev = dataclasses.replace(lay, vals=lay.vals.to(dev), sidx=lay.sidx.to(dev),
                                  gid=lay.gid.to(dev), rsrc=lay.rsrc.to(dev))
    xt = torch.as_tensor(x_n, dtype=torch.float32, device=dev)
    whole = WC.window_spmv(lay_dev, xt)
    if not torch.equal(y_w, whole):
        raise AssertionError("phase 7: the sharded window y differs from the single-device kernel's")
    log(f"phase 7: window_halo y torch.equal the single-device window kernel on the same bps=1, "
        f"xdirect=False layout ({lay.nblocks} blocks, padded to {p.op.nd * p.op.nb_local}; "
        f"halo {p.op.wr} + {p.op.h_right} rows, halo_ok {p.op.halo_ok})")
    p, _xs, y_r, x_n = checks["routed_spmd"]
    xt = torch.as_tensor(x_n, dtype=torch.float32, device=dev)
    for b, chain in enumerate(p.op.chains):
        alone = RC.routed_chain_spmv(chain, xt)
        if not torch.equal(y_r[p.op.bounds[b]:p.op.bounds[b + 1]], alone):
            raise AssertionError(f"phase 7: SPMD shard {b} differs from its chain run alone")
    log(f"phase 7: routed_spmd: each of {len(p.op.chains)} shards' y torch.equal its chunk's "
        f"chain run alone (bounds {p.op.bounds}, t = {[m.perm_products.t for m in p.op.mats]}, "
        f"h_out {p.op.h_out}, {len(p.op.mats[0].lvl_perms)} level(s))")
    # -- times per product -------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    print(f"phase 7 times per product ({kind}; {smi}; {MD_SHARDS} shards "
          f"{'sharing one card' if virtual else 'one per card'}):")
    entries = []
    for path, (name, counts) in MD_CELLS.items():
        p, xs, out, x_n = checks[path]
        t4 = scaling.time_products(lambda p=p, xs=xs: p.product(xs), dev) \
            if path == "csr_psum" else dict((d, t) for d, _v, t, _e, _ok in rows[path])[MD_SHARDS]
        by_d = ", ".join(f"d={d} {t * 1e3:.4f} ms (eff {e:.2f})" for d, _v, t, e, _ok in rows[path])
        sd = ""
        dtype = "float64" if path == "dia_halo_df" else "float32"
        if (name, dtype) in single:
            model, what = single[name, dtype]
            xt = torch.as_tensor(x_n, dtype=getattr(torch, dtype), device=dev)
            sd = f"; single-device product ({what}) {time_per_call(model, xt) * 1e3:.4f} ms"
        lib = time_per_call(library_spmv(matrices[name], dev, getattr(torch, dtype)),
                            torch.as_tensor(x_n, dtype=getattr(torch, dtype), device=dev))
        print(f"  {path:12s} {name:22s} {MD_SHARDS} shards{' (2x2 mesh)' if path == 'csr_psum' else ''}: "
              f"{t4 * 1e3:.4f} ms per product [{by_d}]{sd}; cuSPARSE {dtype} {lib * 1e3:.4f} ms")
        refs[path] = (matrices[name], x_n, out, lib)
        if path not in MD_KERNELS:
            continue
        kname, source, replaces = MD_KERNELS[path]
        # the kernels alone, each shard's launch on its own input (its
        # halo'd x; its device's x): timed and held against their plain
        # versions, apart from the product's exchanges and copies
        if path == "window_halo":
            from spmv_openmp_cuda_tpu_torch.config import LANE
            from spmv_openmp_cuda_tpu_torch.parallel import mesh as M
            from spmv_openmp_cuda_tpu_torch.parallel import sharded as SH

            op = p.op
            slabs = SH.window_slabs(M.make_mesh((len(p.devices), 1), devices=p.devices), op, xs)

            def local(plain, op=op, slabs=slabs):
                return torch.cat([SH.window_shard_spmv(s, slab, -op.wr * LANE, plain,
                                                       op.plan_blocks).to(dev)
                                  for s, slab in zip(op.shards, slabs)])[: op.shape[0]]

            moved = sum(nbytes(s.vals, s.sidx, s.gid, s.rsrc) + nbytes(slab)
                        for s, slab in zip(op.shards, slabs)) + 4 * matrices[name].shape[0]
            b_ms, by = least_ms(moved, 2 * sum(s.vals.numel() for s in op.shards))
        else:
            chains = p.op.chains
            n = matrices[name].shape[1]
            xt = torch.as_tensor(x_n, dtype=torch.float32, device=dev)
            x_on = {c.device: xt.to(c.device) for c in chains}

            def local(plain, chains=chains, x_on=x_on):
                run = RC.routed_spmv_reference if plain else RC.routed_chain_spmv
                return torch.cat([run(c, x_on[c.device]).to(dev) for c in chains])

            costs = [stage_cost(st, n) for c in chains for st in c.stages]
            b_ms, by = least_ms(sum(c[0] for c in costs), sum(c[1] for c in costs))
        yk, yp = local(False), local(True)
        if path == "window_halo" and not torch.equal(yk, out):
            raise AssertionError("phase 7: window_halo: the kernels alone differ from the product")
        err = (yk - yp).abs().max().item()
        if not err <= bound(yp):
            raise AssertionError(f"phase 7: {path}: kernel vs plain {err:.3e} > {bound(yp):.3e}")
        k_ms = scaling.time_products(lambda f=local: f(False), dev)
        plain_ms = scaling.time_products(lambda f=local: f(True), dev, reps=3, per_rep=2)
        log(f"phase 7: {path}: the {MD_SHARDS} shards' kernels alone {k_ms * 1e3:.4f} ms per "
            f"product (the sharded product {t4 * 1e3:.4f} ms); vs plain version {err:.3e} <= "
            f"{bound(yp):.3e}; plain {plain_ms * 1e3:.4f} ms; bound {b_ms:.4f} ms ({by})")
        entries.append({
            "name": f"{kname} [{path}, {MD_SHARDS} shards]", "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(own[path].values()),
            "max_abs_err": err, "ms": k_ms * 1e3, "plain_ms": plain_ms * 1e3, "bound_ms": b_ms,
            "bound_by": by, "library_ms": lib * 1e3, "product_ms": t4 * 1e3})
    took = time.perf_counter() - t_phase
    log(f"phase 7: done in {took:.1f}s")
    return entries, refs


#: phase 8 (across processes): MP_WORLD ranks of a torch.distributed group,
#: each holding MP_SHARDS of the MD_SHARDS shards, run the seven shard_map
#: paths on the dryrun's matrices (MP_SMALL) and, at full size, the cells of
#: MP_FULL; every y torch.equal phase 7's one-process y. gloo: every rank's
#: shards on cuda:0, the exchanges through the host; NCCL only where there
#: are MP_WORLD cards (rank r on cuda:r): it refuses two ranks on one card
MP_WORLD = 2
MP_SHARDS = MD_SHARDS // MP_WORLD
MP_SMALL = ("ell_rows", "csr_psum", "ell_ring", "dia_halo", "window_halo", "routed_spmd",
            "dia_halo_df")
MP_FULL = {"window_halo": "thermal2_like", "routed_spmd": ROUTED_CHECK}
#: the phase's own join timeout: a failing or hung rank ends it
MP_TIMEOUT = 300
MP_LABEL = {"gloo": "2 processes sharing one card, gloo through the host: not a scaling figure",
            "nccl": "2 processes, one card each, NCCL"}


def cross_process_rank(rank: int, world: int, tmp: str, backend: str, rank_devices) -> None:
    """One rank of phase 8 (started by parallel/launch.py::run_ranks): its
    MP_SHARDS shards on rank_devices[rank]; the dryrun's products (each
    rank builds the dryrun's small matrices from their seeds), then each
    full-size cell from the parent's matrix and x in tmp: one product with
    the counters from zero just before it and read just after, a rerun,
    the time per product (CUDA events), and this rank's kernels alone (its
    shards on their own inputs) against their plain versions and timed.
    Writes its record to tmp."""
    from spmv_openmp_cuda_tpu_torch.bench import scaling
    from spmv_openmp_cuda_tpu_torch.config import LANE
    from spmv_openmp_cuda_tpu_torch.contract import dryrun_cases, dryrun_mesh_shape
    from spmv_openmp_cuda_tpu_torch.formats.matrix import CSRMatrix
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.ops import window_cuda as WC
    from spmv_openmp_cuda_tpu_torch.parallel import mesh as M
    from spmv_openmp_cuda_tpu_torch.parallel import sharded as SH

    t0 = time.perf_counter()
    dev = torch.device(rank_devices[rank])
    devices = [dev] * MP_SHARDS
    n = world * MP_SHARDS
    cuda = dev.type == "cuda"
    res = {"small": {}, "full": {}}
    cases = dryrun_cases()
    for path in MP_SMALL:
        coo, csr, x = cases[path]
        p = scaling.build(path, coo, csr, devices, mesh_shape=dryrun_mesh_shape(path, n))
        res["small"][path] = torch.from_numpy(p.y(x))
    log(f"phase 8 ({backend}) rank {rank}: the dryrun's {len(MP_SMALL)} shard_map paths in "
        f"{time.perf_counter() - t0:.1f}s")

    def zero_counts():
        WC.window_blocks_cuda.launches = 0
        for fn in RC._COUNTERS.values():
            fn.launches = 0

    def read_counts():
        if cuda:
            torch.cuda.synchronize(dev)
        got = {"window_blocks": WC.window_blocks_cuda.launches,
               **{k: fn.launches for k, fn in RC._COUNTERS.items()}}
        return {k: v for k, v in got.items() if v}

    for path, name in MP_FULL.items():
        z = np.load(os.path.join(tmp, f"{name}.npz"))
        csr = CSRMatrix(shape=tuple(int(v) for v in z["shape"]), indptr=z["indptr"],
                        indices=z["indices"], data=z["data"])
        x_n = z["x"]
        t = time.perf_counter()
        p = scaling.build(path, None, csr, devices)
        prep_s = time.perf_counter() - t
        xs = p.place(x_n)
        zero_counts()
        out = p.product(xs)
        launches = read_counts()
        again = p.product(xs)
        product_ms = scaling.time_products(lambda: p.product(xs), dev) * 1e3
        # the kernels alone: this rank's shards on their own inputs
        if path == "window_halo":
            op = p.op
            slabs = SH.window_slabs(M.make_mesh((n, 1), devices=devices), op, xs)
            own = [(s, slab) for s, slab in zip(op.shards, slabs) if s is not None]
            held = [s is not None for s in op.shards]
            planned = {"window_blocks": len(own)}

            def local(plain, own=own, op=op):
                return torch.cat([SH.window_shard_spmv(s, slab, -op.wr * LANE, plain, op.plan_blocks)
                                  for s, slab in own])

            moved = sum(nbytes(s.vals, s.sidx, s.gid, s.rsrc) + nbytes(slab) + 4 * s.shape[0]
                        for s, slab in own)
            flops = 2 * sum(s.vals.numel() for s, _ in own)
        else:
            chains = [c for c in p.op.chains if c is not None]
            held = [c is not None for c in p.op.chains]
            planned = {k: sum(c.counts[k] for c in chains) for k in RC._COUNTERS}
            xt = torch.as_tensor(x_n, dtype=torch.float32, device=dev)

            def local(plain, chains=chains, xt=xt):
                run = RC.routed_spmv_reference if plain else RC.routed_chain_spmv
                return torch.cat([run(c, xt) for c in chains])

            costs = [stage_cost(st, csr.shape[1]) for c in chains for st in c.stages]
            moved, flops = sum(c[0] for c in costs), sum(c[1] for c in costs)
        yk, yp = local(False), local(True)
        b_ms, by = least_ms(moved, flops)
        res["full"][path] = {
            "y": out.cpu(), "rerun_equal": torch.equal(out, again), "launches": launches,
            "planned": {k: v for k, v in planned.items() if v}, "held": held,
            "prepare_s": prep_s, "product_ms": product_ms,
            "max_abs_err": (yk - yp).abs().max().item(), "err_bound": bound(yp),
            "ms": scaling.time_products(lambda: local(False), dev) * 1e3,
            "plain_ms": scaling.time_products(lambda: local(True), dev, reps=3, per_rep=2) * 1e3,
            "bound_ms": b_ms, "bound_by": by}
        log(f"phase 8 ({backend}) rank {rank}: {path} on {name}: prepared in {prep_s:.1f}s, "
            f"{product_ms:.4f} ms per product, launches {launches}")
    res["seconds"] = time.perf_counter() - t0
    torch.save(res, os.path.join(tmp, f"{backend}_rank{rank}.pt"))


def cross_process_phase(dev, smi: str, refs: dict) -> list:
    """Phase 8: the cross-process paths, MP_WORLD ranks of a gloo group
    sharing the card (and of an NCCL group where there are MP_WORLD cards),
    each joined y torch.equal phase 7's one-process 4-shard y (refs, from
    multi_device_phase), the launches of the full-size products counted in
    every rank. Returns the kernels line's cross-process entries."""
    from spmv_openmp_cuda_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    runs = [("gloo", [str(torch.device(dev.type, 0) if dev.type == "cuda" else dev)] * MP_WORLD)]
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= MP_WORLD:
        runs.append(("nccl", [f"cuda:{r}" for r in range(MP_WORLD)]))
    else:
        print(f"phase 8: NCCL not run: {cards} card(s) here, and NCCL refuses two ranks on one "
              f"card (its run takes cuda:0 .. cuda:{MP_WORLD - 1}, one rank each)")
    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        for path, name in MP_FULL.items():
            csr, x_n, _out, _lib = refs[path]
            np.savez(os.path.join(tmp, f"{name}.npz"), shape=np.asarray(csr.shape),
                     indptr=csr.indptr, indices=csr.indices, data=csr.data, x=x_n)
        for backend, rank_devices in runs:
            t = time.perf_counter()
            run_ranks(cross_process_rank, MP_WORLD, backend, timeout=MP_TIMEOUT,
                      args=(tmp, backend, rank_devices))
            recs = [torch.load(os.path.join(tmp, f"{backend}_rank{r}.pt"))
                    for r in range(MP_WORLD)]
            log(f"phase 8 ({backend}): {MP_WORLD} ranks on {rank_devices} done in "
                f"{time.perf_counter() - t:.1f}s (ranks {[round(r['seconds'], 1) for r in recs]} s "
                "after start)")
            for path in MP_SMALL:
                want = torch.from_numpy(refs["dryrun"][path])
                if not all(torch.equal(r["small"][path], want) for r in recs):
                    raise AssertionError(f"phase 8 ({backend}): {path}: a rank's y differs from "
                                         "the one-process 4-shard y")
            log(f"phase 8 ({backend}): the dryrun's {len(MP_SMALL)} shard_map paths: every "
                "rank's joined y torch.equal the one-process 4-shard y (phase 7)")
            print(f"phase 8 ({backend}) times per product ({kind}; {smi}; {MP_LABEL[backend]}):")
            for path, name in MP_FULL.items():
                _csr, _x, want, lib = refs[path]
                kname, source, replaces = MD_KERNELS[path]
                for r, rec in enumerate(recs):
                    f = rec["full"][path]
                    own = [i // MP_SHARDS == r for i in range(MD_SHARDS)]
                    if not (torch.equal(f["y"], want.cpu()) and f["rerun_equal"] and f["held"] == own):
                        raise AssertionError(f"phase 8 ({backend}): {path}: rank {r}: y equal "
                                             f"{torch.equal(f['y'], want.cpu())}, rerun equal "
                                             f"{f['rerun_equal']}, held {f['held']}")
                    if dev.type == "cuda" and not (f["launches"] and f["launches"] == f["planned"]):
                        raise AssertionError(f"phase 8 ({backend}): {path}: rank {r}: launches "
                                             f"{f['launches']}, planned {f['planned']}")
                    if not f["max_abs_err"] <= f["err_bound"]:
                        raise AssertionError(f"phase 8 ({backend}): {path}: rank {r}: kernel vs "
                                             f"plain {f['max_abs_err']:.3e} > {f['err_bound']:.3e}")
                    print(f"  {path:12s} {name:14s} rank {r} (shards {[i for i, o in enumerate(own) if o]}):"
                          f" {f['product_ms']:.4f} ms per product, y torch.equal phase 7's; its "
                          f"launches in one product {f['launches'] or 'none (plain versions)'}; "
                          f"its kernels alone {f['ms']:.4f} ms (plain {f['plain_ms']:.4f} ms, bound "
                          f"{f['bound_ms']:.4f} ms by {f['bound_by']}); prepare {f['prepare_s']:.1f}s")
                    entries.append({
                        "name": f"{kname} [{path}, rank {r} of {MP_WORLD} processes, {backend}]",
                        "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(f["launches"].values()), "max_abs_err": f["max_abs_err"],
                        "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                        "bound_by": f["bound_by"], "library_ms": lib * 1e3,
                        "product_ms": f["product_ms"]})
    log(f"phase 8: done in {time.perf_counter() - t_phase:.1f}s")
    return entries


def _tensors_of(obj, seen=None):
    """Every tensor reachable from obj through dataclasses, sequences and
    dicts."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors_of(getattr(obj, f.name), seen)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors_of(v, seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors_of(v, seen)


def defaults_step() -> str:
    """Phase 1's defaults: each public prepare and planner of the port, then
    each converter of the JAX package's prepared arrays (fed host copies),
    called with no device on synth.banded(2048, 2048, 8); every tensor of
    every result must be on the card. Returns the summary line."""
    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.config import LANE
    from spmv_openmp_cuda_tpu_torch.formats import binned, dia, lanes, matrix, routed, window
    from spmv_openmp_cuda_tpu_torch.ops import ell_cuda, lanes_cuda, route, routed_cuda
    from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda, window_cuda
    from spmv_openmp_cuda_tpu_torch.utils import synth

    coo = synth.banded(2048, 2048, 8, fill=0.9, seed=0)
    csr, ell = P.coo_to_csr(coo), P.coo_to_ell(coo)
    rng = np.random.default_rng(0)

    def fields(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}

    def host(obj):
        """obj's tensors copied to numpy, as the JAX package hands them over."""
        return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in fields(obj).items()}

    cpu = {"device": "cpu"}
    e = matrix.device_ell(ell, transposed=True, **cpu)
    ln = lanes.prepare_lanes_small(csr, **cpu)
    ch = routed.prepare_routed_chunked(csr, chunk_nnz=12_000, fit_domains=False, **cpu)
    rdf = routed.prepare_routed_df(csr, **cpu)
    dr, dplan = spmv_cuda.prepare_dia_resid(csr, **cpu)
    w = host(window.prepare_window_auto(csr, **cpu))
    calls = {
        "prepare_binned_csr": lambda: binned.prepare_binned_csr(csr),
        "prepare_dia_df": lambda: dia.prepare_dia_df(csr),
        "device_csr": lambda: matrix.device_csr(csr),
        "device_ell": lambda: matrix.device_ell(ell, transposed=True),
        "prepare_routed": lambda: routed.prepare_routed(csr),
        "prepare_routed_chunked": lambda: routed.prepare_routed_chunked(csr),
        "prepare_window": lambda: window.prepare_window(csr, g=8),
        "prepare_window_auto": lambda: window.prepare_window_auto(csr),
        "prepare_dia_df_pallas": lambda: spmv_cuda.prepare_dia_df_pallas(csr),
        "prepare_dia_resid": lambda: spmv_cuda.prepare_dia_resid(csr),
        "plan_permutation": lambda: route.plan_permutation(rng.permutation(LANE * LANE), 1),
        "plan_row_to_slot": lambda: route.plan_row_to_slot(
            np.repeat(np.arange(2 * LANE), LANE), rng.permutation(2 * LANE * LANE), 2),
        "ell_from_jax": lambda: ell_cuda.ell_from_jax(
            e.data.numpy(), e.cols.numpy(), e.row_lens.numpy(), e.shape, e.nnz, e.max_row_nz,
            e.transposed),
        "lanes_from_jax": lambda: lanes_cuda.lanes_from_jax(
            ln.vals.numpy(), ln.pidx.numpy(), ln.gid.numpy(), ln.window_tiles, ln.shape, ln.nnz,
            ln.n_groups),
        "routed_from_jax": lambda: routed_cuda.routed_from_jax(**host(ch.chunks[0])),
        "routed_chunks_from_jax": lambda: routed_cuda.routed_chunks_from_jax(
            [host(c) for c in ch.chunks], ch.bounds, ch.shape, ch.nnz),
        "routed_df_from_jax": lambda: routed_cuda.routed_df_from_jax(
            host(rdf.mat), rdf.vals_lo.numpy(), rdf.hdense_hi, rdf.hdense_lo, rdf.heavy_rows_df),
        "from_jax_operands": lambda: spmv_cuda.from_jax_operands(
            dr.mat.data.numpy(), dr.mat.offsets, dr.mat.shape, dr.mat.nnz, dr.mat.pad_sub,
            dplan.bs, dplan.nblocks, dplan.s_pad),
        "window_from_jax": lambda: window_cuda.window_from_jax(
            *(w[k] for k in ("vals", "sidx", "gid", "rsrc", "shape", "nnz", "g", "k_pad", "wr",
                             "nspecs", "nblocks", "k_c", "bps", "xdirect", "shared_w",
                             "vals_lo"))),
    }
    places = set()
    for name, call in calls.items():
        found = list(_tensors_of(call()))
        where = {str(t.device) for t in found}
        if not found or any(t.device.type != "cuda" for t in found):
            raise AssertionError(f"defaults: {name} with no device put its tensors on {where}")
        places |= where
    return f"defaults: {len(calls)}/{len(calls)} on {', '.join(sorted(places))} (12 prepares and " \
        f"planners, 7 converters, each called with no device)"


def main() -> int:
    import argparse

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--seed", type=int, default=0, help="seed of the solver phase's x* and v0")
    seed = args.parse_args().seed
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.cli import time_per_call
    from spmv_openmp_cuda_tpu_torch.config import LANE
    from spmv_openmp_cuda_tpu_torch.formats import window as W
    from spmv_openmp_cuda_tpu_torch.io import native
    from spmv_openmp_cuda_tpu_torch.io.mmio import write_mtx
    from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
    from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV
    from spmv_openmp_cuda_tpu_torch.ops import cuda_lib, registry
    from spmv_openmp_cuda_tpu_torch.ops import dfloat as DF
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC
    from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda as SC
    from spmv_openmp_cuda_tpu_torch.ops import window_cuda as WC
    from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
    from spmv_openmp_cuda_tpu_torch.utils import synth
    from spmv_openmp_cuda_tpu_torch.utils.compare import vectors_diff

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"nvidia-smi: {smi}")

    # -- phase 1: build, one nvcc per source, all at once ------------------
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        native_lib = pool.submit(native.build)  # g++, beside the six nvcc
        built = list(pool.map(cuda_lib.build, ("dia_spmv", "window_spmv", "routed_spmv", "df_spmv",
                                                "ell_spmv", "lanes_spmv")))
        native_lib = native_lib.result()
    log(f"phase 1: built {', '.join(os.path.relpath(p) for p, _ in built)} "
        f"in {time.perf_counter() - t:.1f}s")
    if not native.available():
        raise AssertionError(f"the native library does not load: {native.failure()}")
    log(f"phase 1: native host library {os.path.relpath(native_lib)} (g++ from "
        f"{os.path.relpath(native.SOURCE)}), in use: the window and routed prepares run its passes")
    for _path, nvcc_log in built:
        for line in nvcc_log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    t = time.perf_counter()
    defaults = defaults_step()
    print(defaults)
    log(f"phase 1: defaults checked in {time.perf_counter() - t:.1f}s")

    # -- host set-up: the proxies at their published size ------------------
    # csrs: the main path's proxies; extra: the other matrices checked here
    csrs, extra = {}, {}
    gens = [(name, lambda name=name: synth.preset(name), csrs)
            for name in (*DIA_CHECKS, *WINDOW_CHECKS, ROUTED_CHECK, "sg_rand_like", POOLED_CHECK)]
    gens += [(name, lambda name=name: synth.preset(name), extra) for name in ("sg_like", "west2021_like")]
    gens += [(RESID_BIG, lambda: synth.banded(200_000, 200_000, 30, fill=1.0, exact_nnz=12_400_000,
                                              seed=0), extra),
             (RESID_CLIP, wide_band_with_far_fringe, extra)]
    gens += [(MEDIUM, lambda: pooled_heavy_matrix(**MEDIUM_ARGS), extra),
             ("random_uniform 9000", lambda: synth.random_uniform(9000, 9000, density=5e-4, seed=7), extra)]
    for name, gen, into in gens:
        t = time.perf_counter()
        into[name] = P.coo_to_csr(gen())
        m, n = into[name].shape
        log(f"set-up: {name} {m}x{n}, {into[name].nnz} nnz, max row {into[name].max_row_nz}, "
            f"generated in {time.perf_counter() - t:.1f}s")
    mats = {**csrs, **extra}

    # -- phase 2: each kernel against its plain version ---------------------
    errs = {"dia_spmv": 0.0, "dia_resid": 0.0, "dia_resid_df": 0.0, "window_blocks": 0.0,
            "window_single": 0.0}
    prepared = {}

    def check_resid(label, dr, plan, x):
        """One DIA+residual product through its wrapper: one launch, a rerun
        bitwise equal, against the plain version."""
        df = x.dtype == torch.float64
        wrap = SC.dia_resid_spmv_df_cuda if df else SC.dia_resid_spmv_cuda
        before = wrap.launches
        yk, y2 = wrap(dr, x, plan), wrap(dr, x, plan)
        torch.cuda.synchronize()
        if wrap.launches != before + 2 or not torch.equal(yk, y2):
            raise AssertionError(f"{label}: {wrap.launches - before} launches for two products, "
                                 f"rerun bitwise equal {torch.equal(yk, y2)}")
        kernel = "dia_resid_df" if df else "dia_resid"
        what = (f"{label} {kernel}_kernel ({SC._resid_plan(dr, plan, x.device)} threads per row, "
                f"{dr.nnz_resid} fringe nnz, one launch, rerun bitwise equal)")
        if df:
            check_df(what, yk, SC.dia_spmv_df_reference(dr.mat, x, plan, dr), errs, kernel)
            return
        yp = SC.dia_spmv_reference(dr.mat, x, plan, dr)
        err = (yk - yp).abs().max().item()
        ok = err <= bound(yp) and yk.abs().max().item() > 0
        errs[kernel] = max(errs[kernel], err)
        log(f"phase 2: {what}: max|y_k - y_p| = {err:.3e} <= {bound(yp):.3e}: "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: {kernel}_kernel disagrees with its plain version")

    for name, modes in DIA_CHECKS.items():
        csr = csrs[name]
        x = normal_x(csr.shape[1], dev, seed=1)
        for mode in modes:
            spec = registry.get(mode)
            t = time.perf_counter()
            ops = spec.prepare(csr, None, P.Config(), dev)
            prep_s = time.perf_counter() - t
            prepared[(name, mode)] = ops
            if mode.startswith("PL_DIA_RESID"):
                check_resid(f"{name} {mode}, prepare {prep_s:.1f}s:", *ops, x)
                continue
            yk = spec.jitted(ops)(x)
            torch.cuda.synchronize()
            yp = SC.dia_spmv_reference(ops[0], x, ops[1])
            err = (yk - yp).abs().max().item()
            ok = err <= bound(yp) and yk.abs().max().item() > 0
            errs["dia_spmv"] = max(errs["dia_spmv"], err)
            log(f"phase 2: {name} {mode}: max|y_k - y_p| = {err:.3e} <= {bound(yp):.3e}, "
                f"max|y_k| = {yk.abs().max().item():.3e}, prepare {prep_s:.1f}s: "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {mode}: kernel disagrees with its plain version")
    # the two check matrices in the three DIA+residual modes. The 200,000-row
    # band is prepared once, in df: its hi planes are what the f32 prepare
    # makes (every value rounded to f32, the same plan), bf16 their cast
    resid_ops = {}
    t = time.perf_counter()
    big64, big_plan = SC.prepare_dia_resid(mats[RESID_BIG], df=True, device=dev)
    big_prep_s = time.perf_counter() - t
    if SC.plan_dia(big64.mat.as_dia(), max_bs=42) != big_plan:
        raise AssertionError(f"{RESID_BIG}: the f32 plan differs from the df plan {big_plan}")
    for dt in (torch.float32, torch.bfloat16):
        mat = big64.mat.as_dia()
        mat = dataclasses.replace(mat, data=mat.data.to(dt))
        dr = dataclasses.replace(big64, mat=mat, rvals=big64.rvals.to(dt), rvals_lo=None)
        resid_ops[(RESID_BIG, "PL_DIA_RESID" if dt == torch.float32 else "PL_DIA_RESID_BF16")] = (
            SC.with_fringe_lists(dr, big_plan), big_plan)
    resid_ops[(RESID_BIG, "PL_DIA_RESID_F64")] = (big64, big_plan)
    log(f"phase 2: {RESID_BIG}: {len(big64.mat.offsets)} diagonals, bs={big_plan.bs}, "
        f"nblocks={big_plan.nblocks}, {big64.nnz_resid} fringe nnz (k_pad {big64.k_pad}), "
        f"df prepare {big_prep_s:.1f}s")
    for mode in RESID_MODES:
        resid_ops[(RESID_CLIP, mode)] = registry.get(mode).prepare(
            mats[RESID_CLIP], None, P.Config(dtype="float64" if mode.endswith("F64") else "float32"),
            dev)
    for (name, mode), (dr, plan) in resid_ops.items():
        n = mats[name].shape[1]
        x = normal_x64(n, dev, seed=1) if mode.endswith("F64") else normal_x(n, dev, seed=1)
        check_resid(f"{name} {mode}:", dr, plan, x)

    def window_launch(label, mat, x, counter):
        """One product through window_spmv: one launch of its kernel, a rerun
        bitwise equal; returns y and the launch plan."""
        before = counter.launches
        yk, y2 = WC.window_spmv(mat, x), WC.window_spmv(mat, x)
        torch.cuda.synchronize()
        if counter.launches != before + 2 or not torch.equal(yk, y2):
            raise AssertionError(f"{label}: {counter.launches - before} launches for two products, "
                                 f"rerun bitwise equal {torch.equal(yk, y2)}")
        return yk, WC._plan(mat, mat.vals.device)

    def check_window(label, mat, x):
        kernel = "window_single" if mat.xdirect else "window_blocks"
        yk, plan = window_launch(label, mat, x, getattr(WC, f"{kernel}_cuda"))
        yp = WC.window_spmv_reference(mat, x)
        err = (yk - yp).abs().max().item()
        ok = err <= bound(yp) and yk.abs().max().item() > 0
        errs[kernel] = max(errs[kernel], err)
        log(f"phase 2: {label}: {kernel}_kernel ({plan.cluster} CTA(s) per block, "
            f"{plan.win_rows} x rows, ring {plan.depth}, {plan.smem} B shared) max|y_k - y_p| = {err:.3e} "
            f"<= {bound(yp):.3e}, max|y_k| = {yk.abs().max().item():.3e}, one launch, rerun "
            f"bitwise equal: {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: {kernel}_kernel disagrees with its plain version")
        return plan

    def check_window_df(label, mat, x64):
        yk, plan = window_launch(label, mat, x64, WC.window_df_cuda)
        check_df(f"{label} window_df_kernel ({plan.cluster} CTA(s) per block, f64 x in, f64 y "
                 "out, one launch, rerun bitwise equal)", yk, WC.window_spmv_df_reference(mat, x64),
                 errs, "window_df")
        return plan

    # routed: each stage's kernel against its plain version, caida_like in
    # both modes (the bf16 operands are the f32 layout with vals cast, as
    # prepare_routed makes them), then a small domain (t <= 4)
    def check_routed(label, chain, x):
        for stage, yk, yp, ys in RC.compare_stages(chain, x):
            torch.cuda.synchronize()
            err = (yk - yp).abs().max().item()
            exact = stage.kernel in ("gather", "permute")
            ok = torch.equal(yk, yp) if exact else err <= bound(yp)
            staged = ""
            if ys is not None:
                # B and C against the W stages they compose, applied one
                # by one: B bit for bit, C within the bound of a sum
                err_s = (yk - ys).abs().max().item()
                ok_s = torch.equal(yk, ys) if exact else err_s <= bound(ys)
                ok = ok and ok_s
                staged = (f"; vs the staged W stages {err_s:.3e} "
                          f"{'(bit for bit)' if exact else f'<= {bound(ys):.3e}'}")
            errs[stage.kernel] = max(errs.get(stage.kernel, 0.0), err)
            log(f"phase 2: {label}: {ROUTED_KERNELS[stage.kernel][0]} {type(stage).__name__} "
                f"{yk.numel()} elements: max|k - p| = {err:.3e} "
                f"{'(bit for bit)' if exact else f'<= {bound(yp):.3e}'}{staged}: "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{label}: {stage.kernel} kernel disagrees with its plain "
                                     "version or the staged W stages")
        before = {k: fn.launches for k, fn in RC._COUNTERS.items()}
        yk = RC.routed_chain_spmv(chain, x)
        torch.cuda.synchronize()
        made = {k: fn.launches - before[k] for k, fn in RC._COUNTERS.items()}
        if made != chain.counts:  # counted in csrc/routed_spmv.cu at each launch
            raise AssertionError(f"{label}: the chain launched {made}, its stages plan {chain.counts}")
        yp = RC.routed_spmv_reference(chain, x)
        err = (yk - yp).abs().max().item()
        log(f"phase 2: {label}: whole routed_spmv vs routed_spmv_reference {err:.3e} <= "
            f"{bound(yp):.3e}, max|y| {yp.abs().max().item():.3e}, launches {made}")
        if not (err <= bound(yp) and yk.abs().max().item() > 0):
            raise AssertionError(f"{label}: routed chain disagrees with its plain version")

    def check_heavy_order(label, chain, x):
        # kernel E and its close against heavy_sums_in_order (their adds in
        # their order) bit for bit, on the plain chain's y before E
        bufs = RC._buffers(chain, x)
        for stage in chain.stages:
            if stage.kernel == "heavy":
                want = RC._view(bufs, stage.out, stage.out_elems()).clone()
                want[stage.rows.long()] += RC.heavy_sums_in_order(
                    stage.hvals, stage.hpidx, stage.hwidx, stage.hlo, stage.hhi, stage.slot_ptr,
                    stage.slot_idx, x)
                RC.run_stage(stage, bufs, plain=False)
                torch.cuda.synchronize()
                ok = torch.equal(RC._view(bufs, stage.out, stage.out_elems()), want)
                log(f"phase 2: {label}: routed_heavy_kernel vs heavy_sums_in_order "
                    f"{stage.hvals.shape[0] // LANE} tiles ({stage.hvals.dtype}): "
                    f"{'bit for bit' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{label}: kernel E does not add in its order")
            else:
                RC.run_stage(stage, bufs, plain=True)

    def check_hdense_order(label, chain, x):
        # kernel D (one launch, its last CTA closing the product) against
        # hdense_in_order (its operations in their order) bit for bit, on
        # the plain chain's buffers before D
        bufs = RC._buffers(chain, x)
        for stage in chain.stages:
            if isinstance(stage, RC.HDenseStage) and stage.kernel is not None:
                out = RC._view(bufs, stage.out, stage.out_elems())
                want = out.clone()
                want[stage.target.long()] += RC.hdense_in_order(stage.hdense, x)
                before = RC.routed_hdense_cuda.launches
                RC.run_stage(stage, bufs, plain=False)
                torch.cuda.synchronize()
                ok = torch.equal(out, want) and RC.routed_hdense_cuda.launches == before + 1
                log(f"phase 2: {label}: routed_hdense_kernel {tuple(stage.hdense.shape)} vs "
                    f"hdense_in_order: {'bit for bit, one launch' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{label}: kernel D does not add in its order")
            RC.run_stage(stage, bufs, plain=True)

    csr = csrs[ROUTED_CHECK]
    t = time.perf_counter()
    chain32 = registry.get("PL_CSR_ROUTED").prepare(csr, None, P.Config(), dev)
    prep_s = time.perf_counter() - t
    mat = chain32.mat
    log(f"phase 2: {ROUTED_CHECK} routed layout rows_a={mat.rows_a} t1={mat.perm_products.t} "
        f"out_t={mat.out_t} levels={[p.t for p in mat.lvl_perms]} groups={mat.runs[-1][3] + mat.runs[-1][1]} "
        f"heavy={tuple(mat.hdense.shape) if mat.hdense is not None else None}, planned launches "
        f"per product {chain32.counts}, prepare {prep_s:.1f}s")
    chain16 = RC.build_chain(dataclasses.replace(mat, vals=mat.vals.to(torch.bfloat16)))
    routed_chains = {"PL_CSR_ROUTED": chain32, "PL_CSR_ROUTED_BF16": chain16}
    x = normal_x(csr.shape[1], dev, seed=1)
    for mode, chain in routed_chains.items():
        check_routed(f"{ROUTED_CHECK} {mode}", chain, x)
        check_hdense_order(f"{ROUTED_CHECK} {mode}", chain, x)
    # the small kernel: one launch per product where the JAX package runs
    # _routed_small_spmv, against its plain version and, bit for bit, the
    # staged CUDA chain on the same operands
    small_chains = {}
    for name in SMALL_CHECKS:
        for mode in ("PL_CSR_ROUTED",) if name != "delaunay_n12_like" else ROUTED_MODES:
            chain = registry.get(mode).prepare(mats[name], None, P.Config(), dev)
            staged = RC.build_chain(chain.mat, fuse_small=False)
            mat = chain.mat
            if chain.counts != {**{k: 0 for k in RC._COUNTERS}, "small": 1}:
                raise AssertionError(f"{name} {mode}: not one small-kernel launch: {chain.counts}")
            small_chains[(name, mode)] = (chain, staged)
            x = normal_x(mats[name].shape[1], dev, seed=1)
            label = f"{name} {mode} (t={mat.perm_products.t}, out_t={mat.out_t})"
            check_routed(f"{label}, small kernel", chain, x)
            check_routed(f"{label}, staged chain ({sum(staged.counts.values())} launches)", staged, x)
            ys, yg = RC.routed_chain_spmv(chain, x), RC.routed_chain_spmv(staged, x)
            torch.cuda.synchronize()
            same = torch.equal(ys, yg)
            log(f"phase 2: {label}: small kernel vs staged CUDA chain: bit for bit {same} (the "
                f"same products added in the same order; {chain.stages[0].row_slots.numel()} "
                f"listed slots, no scratch: {chain.scratch_elems == 0})")
            if not same or chain.scratch_elems:
                raise AssertionError(f"{label}: the small kernel is not the staged chain bit for "
                                     "bit, or its chain holds scratch")
    # PL_CSR_ROUTED_BF16's pooled tiles (bf16 hvals) on the medium matrix
    t = time.perf_counter()
    mchain = registry.get("PL_CSR_ROUTED_BF16").prepare(mats[MEDIUM], None, P.Config(), dev)
    mm = mchain.mat
    log(f"phase 2: {MEDIUM} PL_CSR_ROUTED_BF16 layout t1={mm.perm_products.t} out_t={mm.out_t} "
        f"heavy rows {len(mm.heavy_rows)} in {mm.hvals.shape[0] // LANE} pooled tiles "
        f"(hvals {mm.hvals.dtype}), planned launches {mchain.counts}, prepare "
        f"{time.perf_counter() - t:.1f}s")
    if mm.hvals is None or mm.hvals.dtype != torch.bfloat16 or mchain.counts["heavy"] != 1:
        raise AssertionError(f"{MEDIUM}: no bf16 pooled heavy tiles")
    check_routed(f"{MEDIUM} PL_CSR_ROUTED_BF16", mchain, normal_x(mats[MEDIUM].shape[1], dev, seed=1))
    check_heavy_order(f"{MEDIUM} PL_CSR_ROUTED_BF16", mchain,
                      normal_x(mats[MEDIUM].shape[1], dev, seed=1))
    xn = np.random.default_rng(3).standard_normal(mats[MEDIUM].shape[1])
    y1 = RC.routed_chain_spmv(mchain, torch.as_tensor(xn, dtype=torch.float32, device=dev))
    y2 = RC.routed_chain_spmv(mchain, torch.as_tensor(xn, dtype=torch.float32, device=dev))
    o = serial_csr_spmv(RC.stored_csr(mats[MEDIUM], mchain), xn)
    err = np.abs(y1.double().cpu().numpy() - o).max()
    log(f"phase 2: {MEDIUM} PL_CSR_ROUTED_BF16 vs the f64 oracle (as stored, bf16): {err:.3e} <= "
        f"{1e-5 * np.abs(o).max() + 1e-6:.3e}; rerun bitwise equal {torch.equal(y1, y2)}")
    if not (err <= 1e-5 * np.abs(o).max() + 1e-6 and torch.equal(y1, y2)):
        raise AssertionError(f"{MEDIUM}: wrong PL_CSR_ROUTED_BF16 output")
    del mchain, mm, y1, y2

    def rerun_equal(label, model, x, y):
        """A second product on the same x gives the same bits."""
        y2 = model(x)
        if not torch.equal(y, y2):
            raise AssertionError(f"{label}: a rerun on the same x is not bitwise equal "
                                 f"(max diff {(y - y2).abs().max().item():.3e})")

    # -- phase 3: the main path, counters from zero ------------------------
    SC.dia_spmv_cuda.launches = 0
    SC.dia_resid_spmv_cuda.launches = 0
    WC.window_blocks_cuda.launches = 0
    WC.window_single_cuda.launches = 0
    for fn in RC._COUNTERS.values():
        fn.launches = 0
    outputs = {}
    models = {}
    for name, csr in csrs.items():
        t = time.perf_counter()
        model = models[name] = AutoSpMV.from_csr(csr, device="cuda")
        prep_s = time.perf_counter() - t
        x_ref = fill_rnd_vector(csr.shape[1], seed=2)
        x_n = np.random.default_rng(3).standard_normal(csr.shape[1])
        outputs[name] = (model.format, model(x_ref), model(x_n), x_ref, x_n, prep_s)
        rerun_equal(name, model, x_n, outputs[name][2])
    torch.cuda.synchronize()
    launches = {
        "dia_spmv": SC.dia_spmv_cuda.launches,
        "dia_resid": SC.dia_resid_spmv_cuda.launches,
        "window_blocks": WC.window_blocks_cuda.launches,
        "window_single": WC.window_single_cuda.launches,
        **{k: fn.launches for k, fn in RC._COUNTERS.items()},
    }
    log(f"phase 3: main path launches {launches}; every product's rerun bitwise equal")
    # the routed kernels' counted launches are the chains' planned ones:
    # three products per proxy (x_ref, x_n and the rerun)
    planned = {k: 0 for k in RC._COUNTERS}
    for name, model in models.items():
        if model.format != "routed":
            continue
        chain = model._operands
        for k, v in chain.counts.items():
            planned[k] += 3 * v
        # E adds its row sums' launch
        n_launch = sum(chain.counts.values()) + chain.counts["heavy"]
        n_memset = sum(isinstance(st, RC.ZeroStage) for st in chain.stages)
        log(f"phase 3: {name} per product: {n_launch} launches and {n_memset} memset(s), "
            f"{chain.counts['permute']} of B, {chain.counts['perm_reduce']} of C ({chain.counts})")
    counted = {k: launches[k] for k in RC._COUNTERS}
    if counted != planned:
        raise AssertionError(f"routed launches counted {counted}, planned {planned}")
    for name, (fmt, y_ref, y_n, x_ref, x_n, prep_s) in outputs.items():
        csr = csrs[name]
        if fmt != EXPECTED_FORMAT[name]:
            raise AssertionError(f"{name}: AutoSpMV picked {fmt}, expected {EXPECTED_FORMAT[name]}")
        for y in (y_ref, y_n):
            if y.shape != (csr.shape[0],) or y.dtype != torch.float32 or y.device.type != "cuda":
                raise AssertionError(f"{name}: output {y.shape} {y.dtype} {y.device}")
            if not torch.isfinite(y).all():
                raise AssertionError(f"{name}: non-finite output")
        # the routed layout stores heavy rows in bf16: its oracle is the
        # matrix as stored; the gap to the exact matrix is printed
        ocsr = RC.stored_csr(csr, models[name]._operands) if fmt == "routed" else csr
        rep = vectors_diff(y_ref.double().cpu().numpy(), serial_csr_spmv(ocsr, x_ref))
        o = serial_csr_spmv(ocsr, x_n)
        rel = np.abs(y_n.double().cpu().numpy() - o).max()
        lim = 1e-5 * np.abs(o).max() + 1e-6
        gap = ""
        if fmt == "routed":
            exact = np.abs(y_n.double().cpu().numpy() - serial_csr_spmv(csr, x_n)).max()
            gap = f"; gap to the exact matrix {exact:.3e} (dense-block heavy rows in bf16, not asserted)"
        log(f"phase 3: {name} -> {fmt}, prepare+upload {prep_s:.1f}s; reference protocol: "
            f"{'OK' if rep.ok else 'FAIL'} maxAbsDiff={rep.max_abs_diff:.3e}; "
            f"x~N(0,1) vs f64 oracle{' (as stored)' if fmt == 'routed' else ''}: "
            f"{rel:.3e} <= {lim:.3e}{gap}")
        if not rep.ok or not rel <= lim:
            raise AssertionError(f"{name}: wrong output")
    # the small kernel's main path is the harness cell on delaunay_n12_like
    # (csr_ell_slice): AutoSpMV takes no small routed domain here
    if not all(v for k, v in launches.items() if k != "small"):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    # one launch per hybrid product: three products (x_ref, x_n, the rerun)
    # per dia_resid proxy
    hybrid = 3 * sum(fmt == "dia_resid" for fmt, *_ in outputs.values())
    if launches["dia_resid"] != hybrid:
        raise AssertionError(f"{launches['dia_resid']} dia_resid_kernel launches for {hybrid} "
                             "DIA+residual products")
    # and one dia_rows_kernel launch per DIA product
    dia = 3 * sum(fmt == "dia" for fmt, *_ in outputs.values())
    if launches["dia_spmv"] != dia:
        raise AssertionError(f"{launches['dia_spmv']} dia_rows_kernel launches for {dia} DIA products")

    # -- phase 2, continued: webbase_like's chain (the main path's operands)
    # stage by stage against the plain versions, kernel E against
    # heavy_sums_reference among them
    wchain = models[POOLED_CHECK]._operands
    wm = wchain.mat
    log(f"phase 2: {POOLED_CHECK} routed layout rows_a={wm.rows_a} t1={wm.perm_products.t} "
        f"out_t={wm.out_t} levels={[p.t for p in wm.lvl_perms]} heavy rows {len(wm.heavy_rows)} "
        f"({int(np.diff(csrs[POOLED_CHECK].indptr)[list(wm.heavy_rows)].sum())} nnz) in "
        f"{wm.hvals.shape[0] // LANE} pooled tiles over {len(set(wm.hwidx.tolist()))} windows, "
        f"planned launches per product {wchain.counts}, prepare {outputs[POOLED_CHECK][5]:.1f}s")
    check_routed(f"{POOLED_CHECK} PL_CSR_ROUTED", wchain, normal_x(csrs[POOLED_CHECK].shape[1], dev, seed=1))
    check_heavy_order(f"{POOLED_CHECK} PL_CSR_ROUTED", wchain,
                      normal_x(csrs[POOLED_CHECK].shape[1], dev, seed=1))

    # -- phase 3, float64: the main path on the df kernels, counters from zero
    cfg64 = P.Config(dtype="float64")
    df_counters = {
        "dia_df": SC.dia_spmv_df_cuda, "dia_resid_df": SC.dia_resid_spmv_df_cuda,
        "window_df": WC.window_df_cuda,
        **{f"routed_{k}": fn for k, fn in RC._DF_COUNTERS.items()},
    }
    f32_counters = {
        "dia_spmv": SC.dia_spmv_cuda, "dia_resid": SC.dia_resid_spmv_cuda,
        "window_blocks": WC.window_blocks_cuda, "window_single": WC.window_single_cuda,
        **RC._COUNTERS,
    }
    for fn in (*df_counters.values(), *f32_counters.values()):
        fn.launches = 0
    outputs64 = {}
    models64 = {}
    for name, csr in csrs.items():
        if name in F32_ONLY:
            continue
        t = time.perf_counter()
        model = models64[name] = AutoSpMV.from_csr(csr, cfg=cfg64, device="cuda")
        prep_s = time.perf_counter() - t
        x_ref = fill_rnd_vector(csr.shape[1], seed=2)
        x_n = np.random.default_rng(3).standard_normal(csr.shape[1])
        outputs64[name] = (model.format, model(x_ref), model(x_n), x_ref, x_n, prep_s)
        rerun_equal(f"{name} (float64)", model, x_n, outputs64[name][2])
    torch.cuda.synchronize()
    launches64 = {k: fn.launches for k, fn in df_counters.items()}
    also = {k: fn.launches for k, fn in f32_counters.items() if fn.launches}
    log(f"phase 3 (float64): main path launches {launches64}; f32 kernels in it {also}; "
        f"every product's rerun bitwise equal; not run in float64: {list(F32_ONLY)}")
    if also:
        raise AssertionError(f"f32 kernels launched on the float64 main path: {also}")
    # the routed df kernels' counted launches are the chains' planned ones:
    # three products per proxy (x_ref, x_n and the rerun), one program each
    planned64 = {k: 0 for k in RC._DF_COUNTERS}
    for name, model in models64.items():
        if model.format != "routed":
            continue
        chain = model._operands
        for k, v in chain.counts.items():
            planned64[k] += 3 * v
        log(f"phase 3 (float64): {name} PL_CSR_ROUTED_F64 per product: "
            f"{RC.df_chain_launches(chain)} launches and no memset from one host call, "
            f"{len(chain.domains)} domain(s) (ops {chain.counts}; C-df level 0 forming K3's "
            "products and closing a one-tile level after it; D-df closing its rows)")
    counted64 = {k: launches64[f"routed_{k}"] for k in RC._DF_COUNTERS}
    if counted64 != planned64:
        raise AssertionError(f"routed df launches counted {counted64}, planned {planned64}")
    caida_launches = RC.df_chain_launches(models64[ROUTED_CHECK]._operands)
    if caida_launches != 3:
        raise AssertionError(f"{ROUTED_CHECK}: {caida_launches} launches per df product, not 3 "
                             "(C-df, the output gather, D-df)")
    # one output gather per product, whatever the number of domains:
    # sg_rand_like's three domains' C-df launches, one gather, their D-df
    sg = models64["sg_rand_like"]._operands
    sg_planned = sum(1 + len(d.mat.lvl_perms) - bool(s.tail is not None)
                     for d, s in zip(sg.domains, (t for t in sg.stages
                                                  if isinstance(t, RC.DFGatherReduceStage)))) \
        + 1 + sum(bool(d.heavy_rows_df) for d in sg.domains)
    log(f"phase 3 (float64): sg_rand_like: {len(sg.domains)} domains, {RC.df_chain_launches(sg)} "
        f"launches per df product, {sg.counts['df_permute']} output gather (planned: {sg_planned})")
    if sg.counts["df_permute"] != 1 or RC.df_chain_launches(sg) != sg_planned:
        raise AssertionError(f"sg_rand_like: {sg.counts} per df product, not one output gather "
                             f"among {sg_planned} launches")
    for name, (fmt, y_ref, y_n, x_ref, x_n, prep_s) in outputs64.items():
        csr = csrs[name]
        if fmt != EXPECTED_FORMAT[name]:
            raise AssertionError(f"{name}: AutoSpMV (float64) picked {fmt}, expected {EXPECTED_FORMAT[name]}")
        for y in (y_ref, y_n):
            if y.shape != (csr.shape[0],) or y.dtype != torch.float64 or y.device.type != "cuda":
                raise AssertionError(f"{name}: float64 output {y.shape} {y.dtype} {y.device}")
            if not torch.isfinite(y).all():
                raise AssertionError(f"{name}: non-finite float64 output")
        ops = models64[name]._operands
        chunked = isinstance(ops, RC.RoutedDFChain) and len(ops.domains) > 1
        rep = vectors_diff(y_ref.cpu().numpy(), serial_csr_spmv(csr, x_ref))
        o = serial_csr_spmv(csr, x_n)
        rel = np.abs(y_n.cpu().numpy() - o).max() / np.abs(o).max()
        lim = 1e-10 if chunked else 1e-11
        log(f"phase 3 (float64): {name} -> {fmt} ({F64_MODES[fmt]}{', chunked' if chunked else ''}), "
            f"prepare+upload {prep_s:.1f}s; reference protocol: {'OK' if rep.ok else 'FAIL'} "
            f"maxAbsDiff={rep.max_abs_diff:.3e}; x~N(0,1) vs the exact f64 oracle: "
            f"{rel:.3e} * max|y| <= {lim:.0e}")
        if not rep.ok or not rel <= lim:
            raise AssertionError(f"{name}: wrong float64 output")
    # routed_df_reduce_kernel counts under two wrappers: level 0 (forming K3's
    # products) and a later level
    kernels64 = dict(launches64)
    kernels64["routed_df_reduce"] += kernels64.pop("routed_df_gather_reduce")
    if not all(kernels64.values()):
        raise AssertionError(f"a df kernel of the main path never launched: {launches64}")
    hybrid64 = 3 * sum(fmt == "dia_resid" for fmt, *_ in outputs64.values())
    if launches64["dia_resid_df"] != hybrid64 or also.get("dia_resid"):
        raise AssertionError(f"{launches64['dia_resid_df']} dia_resid_df_kernel launches for "
                             f"{hybrid64} DIA+residual products (f32 kernels: {also})")
    dia64 = 3 * sum(fmt == "dia" for fmt, *_ in outputs64.values())
    if launches64["dia_df"] != dia64:
        raise AssertionError(f"{launches64['dia_df']} dia_df_kernel launches for {dia64} DIA products")

    # -- phase 2, continued: the window and df kernels against their plain
    # versions on the main paths' own operands (no second prepare)
    # K1: the double-float DIA kernels on the f64 main path's operands
    # (cavity10 and cube_coup run PL_DIA_F64, raefsky1 PL_DIA_RESID_F64)
    prepared_df = {}
    for name in ("cavity10_like", "raefsky1_like", "cube_coup_like"):
        csr = csrs[name]
        mode = F64_MODES[EXPECTED_FORMAT[name]]
        x64 = normal_x64(csr.shape[1], dev, seed=1)
        ops = prepared_df[name] = models64[name]._operands
        if mode == "PL_DIA_RESID_F64":
            check_resid(f"{name} {mode} (the main path's operands, bs={ops[1].bs}, "
                        f"{len(ops[0].mat.offsets)} diagonals):", *ops, x64)
            continue
        mat, plan = ops
        yk, yp = registry.get(mode).jitted(ops)(x64), SC.dia_spmv_df_reference(mat, x64, plan)
        check_df(f"{name} {mode} dia_df_kernel (bs={plan.bs}, nblocks={plan.nblocks}, "
                 f"{len(mat.offsets)} diagonals, {SC._rows_plan(mat, plan, x64.device)} row(s) a thread)",
                 yk, yp, errs, "dia_df")
        if not torch.equal(yk, yp):
            raise AssertionError(f"{name}: dia_df_kernel's y is not torch.equal its plain version's")

    for name, modes in WINDOW_CHECKS.items():
        csr = csrs[name]
        x = normal_x(csr.shape[1], dev, seed=1)
        # the f32 and f64 main paths' layouts (the same one: the layout does
        # not depend on the values, and the f32 values are the df hi plane)
        mat = models[name]._operands
        mat_df = prepared_df[name] = models64[name]._operands
        if not torch.equal(mat.vals, mat_df.vals) or not torch.equal(mat.rsrc, mat_df.rsrc):
            raise AssertionError(f"{name}: the f32 window layout is not the df layout's hi plane")
        log(f"phase 2: {name} window layout g={mat.g} k_pad={mat.k_pad} k_c={mat.k_c} "
            f"wr={mat.wr} bps={mat.bps} nblocks={mat.nblocks} xdirect={mat.xdirect} "
            f"shared_w={mat.shared_w}, {mat.nblocks * mat.k_pad * LANE} slots")
        for mode in modes:
            # prepare_window_auto uses vals_dtype only in its final cast, so
            # the bf16 operands are the f32 layout with vals cast
            ops = mat if mode == "PL_CSR_WINDOW" else dataclasses.replace(
                mat, vals=mat.vals.to(torch.bfloat16))
            prepared[(name, mode)] = ops
            plan = check_window(f"{name} {mode}", ops, x)
            # thermal2's 400 blocks fill the card a CTA each; fem's 29 and
            # delaunay's one block are split over thread-block clusters
            if (plan.cluster == 1) != (name == "thermal2_like"):
                raise AssertionError(f"{name}: launch plan {plan}")
        x64 = normal_x64(csr.shape[1], dev, seed=1)
        check_window_df(f"{name} PL_CSR_WINDOW_F64", mat_df, x64)
    # the third x form: a small layout forced to shared_w
    small = P.coo_to_csr(synth.fem_like(m=6000, n=6000, nnz=60000, spread=700, lo=4, hi=16, seed=7))
    for vals_dtype in (torch.float32, torch.bfloat16):
        mat = W.prepare_window(small, g=8, bps=4, shared_w=True, vals_dtype=vals_dtype, device=dev)
        assert mat.shared_w
        check_window(f"fem_like 6000 shared_w {vals_dtype}", mat, normal_x(6000, dev, seed=1))
    mat = W.prepare_window(small, g=8, bps=4, shared_w=True, df=True, device=dev)
    check_window_df("fem_like 6000 shared_w", mat, normal_x64(6000, dev, seed=1))
    # g = 64: a standard layout, and an xdirect one with a 128-row x window
    # (the largest shared memory a CTA takes: 205 KB in df)
    for label, gen, kw in (
        ("fem_like 20000 g=64", dict(m=20000, n=20000, nnz=120000, spread=1500, lo=4, hi=10, seed=6),
         dict(g=64)),
        ("fem_like 8192x16384 g=64 xdirect", dict(m=8192, n=16384, nnz=60000, spread=3000, lo=4,
                                                  hi=12, seed=6), dict(g=64, xdirect=True)),
    ):
        gcsr = P.coo_to_csr(synth.fem_like(**gen))
        for vals_dtype in (torch.float32, torch.bfloat16):
            mat = W.prepare_window(gcsr, vals_dtype=vals_dtype, device=dev, **kw)
            check_window(f"{label} {vals_dtype}", mat, normal_x(gcsr.shape[1], dev, seed=1))
        mat = W.prepare_window(gcsr, df=True, device=dev, **kw)
        check_window_df(label, mat, normal_x64(gcsr.shape[1], dev, seed=1))

    # the routed df program on the f64 main path's operands, caida_like and
    # sg_rand_like's three chunks: each stage's kernel against its plain
    # version, bit for bit, and a rerun bit for bit (C-df level 0 forms K3's
    # products exactly as the plain K3 does: the kernel's FMA error is the
    # plain Veltkamp error; it and its closed level are also held against
    # the parent's plain K3 followed by plain C-df; C-df and D-df add the
    # plain versions' pairs in their order; the output gather moves and
    # combines); then the whole product bit for bit against its plain chain
    # and the staged chain (the W stages one by one, as the chain ran
    # before its permutations were composed)
    for name in (ROUTED_CHECK, "sg_rand_like"):
        dchain = prepared_df[name] = models64[name]._operands
        dm = dchain.domains[0]
        log(f"phase 2: {name} df routed layout: {len(dchain.domains)} domain(s), first rows_a="
            f"{dm.mat.rows_a} t1={dm.mat.perm_products.t} levels={[p.t for p in dm.mat.lvl_perms]} "
            f"heavy rows {len(dm.heavy_rows_df)} in a (hi, lo) block; program {dchain.counts}")
        x64 = normal_x64(csrs[name].shape[1], dev, seed=1)
        labels = df_stage_labels(dchain)
        domains = iter(dchain.domains)
        for stage, yk, yk2, yp in RC.compare_df_stages(dchain, x64):
            torch.cuda.synchronize()
            key = f"routed_{stage.kernel}"
            err = (yk - yp).abs().max().item()
            errs[key] = max(errs.get(key, 0.0), err)
            exact, again = RC.bits_equal(yk, yp), RC.bits_equal(yk, yk2)
            parent = True
            if isinstance(stage, RC.DFGatherReduceStage):
                parent = RC.bits_equal(yk, parent_level0(next(domains), stage, x64))
            log(f"phase 2: {name}: {labels[stage]}, {yk.numel()} values: max|k - p| = {err:.3e}, "
                f"bit for bit {exact}, rerun bit for bit {again}"
                + (f", the parent's plain K3 then C-df bit for bit {parent}"
                   if isinstance(stage, RC.DFGatherReduceStage) else "")
                + f": {'OK' if exact and again and parent else 'FAIL'}")
            if not (exact and again and parent):
                raise AssertionError(f"{name}: {labels[stage]} disagrees with its plain version, or "
                                     "its rerun with itself")
        # the closed level again as a launch of its own (a later level's
        # mode of routed_df_reduce_kernel, which no f64 main-path layout
        # here has), on the plain chain's sums of level 0
        bufs = RC._df_buffers(dchain, x64)
        for stage in dchain.stages:
            RC.run_df_stage(stage, bufs, plain=True)
            if isinstance(stage, RC.DFGatherReduceStage) and stage.tail is not None:
                want = RC.df_stage_output(stage.tail, bufs).clone()
                RC.run_df_stage(stage.tail, bufs, plain=False)
                torch.cuda.synchronize()
                ok = RC.bits_equal(RC.df_stage_output(stage.tail, bufs), want)
                log(f"phase 2: {name}: {DF_KERNEL_LABELS['df_reduce']} on the closed level, a "
                    f"launch of its own: bit for bit its plain version {ok}: {'OK' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name}: C-df of a later level disagrees with its plain version")
        del bufs
        before = {k: fn.launches for k, fn in RC._DF_COUNTERS.items()}
        yk, yk2 = RC.routed_df_spmv(dchain, x64), RC.routed_df_spmv(dchain, x64)
        torch.cuda.synchronize()
        made = {k: fn.launches - before[k] for k, fn in RC._DF_COUNTERS.items()}
        yp = RC.routed_df_spmv(dchain, x64, plain=True)
        ys = RC.routed_df_staged_reference(dchain, x64)
        ok = [RC.bits_equal(yk, yp), RC.bits_equal(yk, ys), RC.bits_equal(yk, yk2),
              made == {k: 2 * v for k, v in dchain.counts.items()}]
        log(f"phase 2: {name} PL_CSR_ROUTED_F64 whole df product: bit for bit its plain chain "
            f"{ok[0]}, the staged chain {ok[1]}, its rerun {ok[2]}; two products launched {made}: "
            f"{'OK' if all(ok) else 'FAIL'}")
        if not all(ok):
            raise AssertionError(f"{name}: the df routed product is not its plain chain bit for bit")

    # -- phase 4: the CLI -------------------------------------------------
    cli_runs = (
        ("raefsky1_like", "AUTO", [], "PL_DIA_RESID", None),
        ("delaunay_n12_like", "AUTO", [], "PL_CSR_WINDOW", None),
        (ROUTED_CHECK, "AUTO", [], "PL_CSR_ROUTED", "#auto: format=routed -> PL_CSR_ROUTED"),
        (MEDIUM, "AUTO", [], "PL_CSR_ROUTED", "#auto: format=routed -> PL_CSR_ROUTED"),
        ("raefsky1_like", "AUTO", ["--dtype", "float64"], "PL_DIA_RESID_F64",
         "#auto: format=dia_resid -> PL_DIA_RESID_F64"),
        (ROUTED_CHECK, "AUTO", ["--dtype", "float64"], "PL_CSR_ROUTED_F64",
         "#auto: format=routed -> PL_CSR_ROUTED_F64"),
        ("raefsky1_like", "PL_DIA_ROWS", ["--dtype", "float64"], "PL_DIA_F64",
         "#dtype: float64 unsupported by CUDA mode PL_DIA_ROWS; remapping to PL_DIA_F64"),
    )
    mtx_dir = tempfile.TemporaryDirectory()
    for name, arg, extra, mode, line in cli_runs:
        mtx = os.path.join(mtx_dir.name, f"{name}.mtx")
        if not os.path.exists(mtx):
            write_mtx(mtx, pooled_heavy_matrix(**MEDIUM_ARGS) if name == MEDIUM else synth.preset(name))
        proc = subprocess.run(
            [sys.executable, "-m", "spmv_openmp_cuda_tpu_torch", mtx, "RNDVECT", arg,
             "--check", "--no-dump", *extra],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        print(proc.stdout.rstrip())
        if proc.returncode != 0 or "#check: OK" not in proc.stdout or \
                f"computeMode:{mode} " not in proc.stdout or (line and line not in proc.stdout):
            raise AssertionError(f"CLI run on {name} failed (exit {proc.returncode}): {proc.stderr}")
        log(f"phase 4: CLI {arg} {' '.join(extra)} --check OK on {name} ({mode})")
    mtx_dir.cleanup()

    # -- phase 5: times ----------------------------------------------------
    print(f"times on {smi} (CUDA events, x on the device, after warm-up; "
          "per call, back to back):")
    libs = {}
    times = {}
    dia_graphed = {}  # (name, mode) -> graphed ms of the DIA rows products
    for (name, mode), ops in prepared.items():
        if mode.startswith("PL_DIA_RESID"):
            continue  # the whole DIA+residual product, below
        csr = csrs[name]
        x = normal_x(csr.shape[1], dev, seed=4)
        spec = registry.get(mode)
        if mode.startswith("PL_CSR_WINDOW"):
            plain = lambda v, o=ops: WC.window_spmv_reference(o, v)
        else:
            plain = lambda v, o=ops: SC.dia_spmv_reference(o[0], v, o[1])
        tk = time_per_call(spec.jitted(ops), x)
        tp = time_per_call(plain, x)
        if name not in libs:
            lib_fn = library_spmv(csr, dev)
            libs[name] = time_per_call(lib_fn, x)
            del lib_fn
        times[(name, mode)] = (tk, tp)
        gb = slab_bytes(ops) / 1e9
        tg = graph_ms(lambda f=spec.jitted(ops): f(x))
        graphed = f" ({tg:.4f} ms in a CUDA graph)"
        if mode.startswith("PL_DIA"):
            graphed = f" ({tg:.4f} ms in a CUDA graph, {SC._rows_plan(ops[0], ops[1], x.device)} row(s) a thread)"
            dia_graphed[(name, mode)] = tg
        print(f"  {name:20s} {mode:18s} kernel {tk * 1e3:9.4f} ms{graphed} "
              f"{2 * csr.nnz / tk / 1e9:8.2f} GFLOP/s "
              f"{gb / tk:8.1f} slab GB/s | plain {tp * 1e3:9.4f} ms | library (cuSPARSE CSR f32) "
              f"{libs[name] * 1e3:9.4f} ms | slab {gb * 1e3:.1f} MB")
    # the whole DIA+residual product (f32 and bf16; f64 with the df kernels
    # below) on raefsky1_like (the main path's operands) and the
    # 200,000-row band: per call, graphed, plain, cuSPARSE on the whole
    # matrix in f32, and the bound
    resid_times = {}
    for name in ("raefsky1_like", RESID_BIG):
        csr = mats[name]
        lib_fn = library_spmv(csr, dev)
        x = normal_x(csr.shape[1], dev, seed=4)
        t_lib = time_per_call(lib_fn, x)
        del lib_fn
        for mode in RESID_MODES[:2]:
            dr, plan = prepared[(name, mode)] if name == "raefsky1_like" else resid_ops[(name, mode)]
            tk = time_per_call(lambda v, o=dr, p=plan: SC.dia_resid_spmv_cuda(o, v, p), x)
            tg = graph_ms(lambda o=dr, p=plan: SC.dia_resid_spmv_cuda(o, x, p))
            tp = time_per_call(lambda v, o=dr, p=plan: SC.dia_spmv_reference(o.mat, v, p, o), x)
            moved, flops = resid_cost(dr, csr.shape[1], df=False)
            b_ms, by = least_ms(moved, flops)
            resid_times[(name, mode)] = (tk, tp, t_lib, b_ms, by)
            print(f"  {name:20s} {mode:18s} dia_resid_kernel {tk * 1e3:9.4f} ms per call ({tg:.4f} ms "
                  f"in a CUDA graph, 1 launch, {SC._resid_plan(dr, plan, x.device)} threads per row) "
                  f"{2 * csr.nnz / tk / 1e9:8.2f} GFLOP/s | plain {tp * 1e3:9.4f} ms | library (cuSPARSE "
                  f"CSR f32, whole matrix) {t_lib * 1e3:9.4f} ms | bound {b_ms:.5f} ms ({by}, "
                  f"{moved / 1e6:.3f} MB); graphed kernel at {100 * b_ms / tg:.1f} % of it")
    # routed: per product (chain eager and graphed, plain chain, cuSPARSE),
    # then each kernel alone inside a CUDA graph, on caida_like's operands
    csr = csrs[ROUTED_CHECK]
    x = normal_x(csr.shape[1], dev, seed=4)
    libs[ROUTED_CHECK] = time_per_call(library_spmv(csr, dev), x)
    routed_times = {}
    for mode, chain in routed_chains.items():
        tk = time_per_call(lambda v, c=chain: RC.routed_chain_spmv(c, v), x)
        tg = graph_ms(lambda c=chain: RC.routed_chain_spmv(c, x), reps=10) / 1e3
        tp = time_per_call(lambda v, c=chain: RC.routed_spmv_reference(c, v), x)
        routed_times[mode] = (tk, tg, tp)
        print(f"  {ROUTED_CHECK:20s} {mode:18s} chain {tk * 1e3:9.4f} ms per call "
              f"({tg * 1e3:.4f} ms in a CUDA graph) {2 * csr.nnz / tk / 1e9:8.2f} GFLOP/s | plain "
              f"{tp * 1e3:9.4f} ms | library (cuSPARSE CSR f32) {libs[ROUTED_CHECK] * 1e3:9.4f} ms")
    bufs = RC._buffers(chain32, x)
    for stage in chain32.stages:  # valid inputs for every stage
        RC.run_stage(stage, bufs, plain=True)
    per_kernel = {k: [0.0, 0.0, 0, 0, 0.0] for k in ROUTED_KERNELS}  # ms, plain, bytes, flops, lib
    for i, stage in enumerate(chain32.stages):
        if stage.kernel is None:
            continue
        ms = graph_ms(lambda s=stage: RC.run_stage(s, bufs, plain=False))
        pms = time_per_call(lambda v, s=stage: RC.run_stage(s, bufs, plain=True), x) * 1e3
        b, f = stage_cost(stage, csr.shape[1])
        lib = None
        if isinstance(stage, RC.PermuteStage):
            # the library yardstick of the output gather: one torch.take
            # with the stage's map, its -1 pointed at a zero appended to the
            # source
            src = bufs[stage.src.kind][stage.src.off:]
            srcz = torch.cat([src, src.new_zeros(1)])
            idx = stage.imap.idx.reshape(-1)[:stage.n].long()
            idx = torch.where(idx >= 0, idx, src.numel())
            lib = time_per_call(lambda v, s=srcz, j=idx: torch.take(s, j), x) * 1e3
            per_kernel[stage.kernel][4] += lib
        acc = per_kernel[stage.kernel]
        acc[0] += ms
        acc[1] += pms
        acc[2] += b
        acc[3] += f
        print(f"  stage {i:2d} {ROUTED_KERNELS[stage.kernel][0]:26s} {routed_stage_label(chain32, stage):14s} "
              f"{ms * 1e3:8.2f} us in a graph | plain {pms:.4f} ms | {b / 1e6:7.3f} MB, bound "
              f"{least_ms(b, f)[0] * 1e3:6.2f} us"
              + (f" | torch.take {lib * 1e3:.2f} us" if lib is not None else ""))
    for kernel, what in (("gather", "A"), ("hdense", "D, one launch with its close")):
        k_ms, _, k_b, k_f, _ = per_kernel[kernel]
        k_bound = least_ms(k_b, k_f)[0]
        print(f"  {ROUTED_CHECK} {ROUTED_KERNELS[kernel][0]} ({what}) alone: {k_ms * 1e3:.2f} us in a "
              f"graph, {100 * k_bound / k_ms:.1f} % of its {k_bound * 1e3:.2f} us bound (before its "
              f"redesign: {PARENT_US[kernel]} us, {100 * k_bound * 1e3 / PARENT_US[kernel]:.1f} %)")
    chain_bytes = sum(stage_cost(s, csr.shape[1])[0] for s in chain32.stages)
    print(f"  {ROUTED_CHECK} chain of stages moves {chain_bytes / 1e6:.3f} MB per product: bound "
          f"{least_ms(chain_bytes, 0)[0]:.4f} ms")
    # the two TPU kernels the chain does not take (W1 off, W3 off), timed on
    # caida_like's operands, and the heavy rows' library yardstick
    mat = chain32.mat
    n_real = mat.vals.shape[0] // 128
    out = torch.empty(n_real * 128 * 128, device=dev)
    t8 = graph_ms(lambda: RC.routed_gather_cuda(mat.vals, mat.pidx, mat.widx, None, n_real, x, out))
    t8p = time_per_call(lambda v: RC.gather_reference(mat.vals, mat.pidx, mat.widx, None, n_real, v), x)
    b8 = least_ms(nbytes(mat.vals, mat.pidx, mat.widx) + 4 * csr.shape[1] + 4 * out.numel(),
                  mat.vals.numel())
    # W3 off: R3 alone over the products slab (A's output as the slab)
    st = next(s for s in chain32.stages if isinstance(s, RC.ReduceStage))
    src = bufs[st.src.kind][st.src.off:]
    imap14 = RC.reduce_map(mat.perm_products.r3, RC.MODE_DIRECT)
    imap14 = dataclasses.replace(imap14, idx=imap14.idx[:st.imap.idx.shape[0]])
    out14 = torch.empty(st.groups.shape[0] * 128, device=dev)
    t14 = graph_ms(lambda: RC.routed_perm_reduce_cuda(src, imap14, None, st.groups, st.chunks,
                                                      out14))
    t14p = time_per_call(lambda v: RC.perm_reduce_reference(src, imap14.idx, None, st.runs), x)
    b14 = least_ms(*stage_cost(dataclasses.replace(st, imap=imap14), csr.shape[1]))
    hd32 = mat.hdense.float()
    xpad = torch.nn.functional.pad(x, (0, hd32.shape[1] - x.shape[0]))
    t10l = graph_ms(lambda: torch.mv(hd32, xpad))
    print(f"  {ROUTED_CHECK} routed_gather_kernel, W1 off ({n_real} tiles, _gather_products): "
          f"{t8 * 1e3:.2f} us in a graph | plain {t8p * 1e3:.4f} ms | bound {b8[0] * 1e3:.2f} us")
    print(f"  {ROUTED_CHECK} routed_perm_reduce_kernel, W3 off ({st.groups.shape[0]} groups, "
          f"_reduce_runs_fused): {t14 * 1e3:.2f} us in a graph | plain {t14p * 1e3:.4f} ms | "
          f"bound {b14[0] * 1e3:.2f} us")
    print(f"  {ROUTED_CHECK} heavy rows, library: torch.mv on the {tuple(hd32.shape)} block in f32 "
          f"{t10l * 1e3:.2f} us in a graph")
    del hd32, xpad

    # webbase_like: the product (per call, graphed, plain chain, cuSPARSE),
    # then kernel E alone in a CUDA graph with its bound, and cuSPARSE on
    # the heavy rows alone as its yardstick
    wcsr = csrs[POOLED_CHECK]
    x = normal_x(wcsr.shape[1], dev, seed=4)
    t_wk = time_per_call(lambda v: RC.routed_chain_spmv(wchain, v), x)
    t_wg = graph_ms(lambda: RC.routed_chain_spmv(wchain, x), reps=10) / 1e3
    t_wp = time_per_call(lambda v: RC.routed_spmv_reference(wchain, v), x)
    t_wl = time_per_call(library_spmv(wcsr, dev), x)
    w_bytes = sum(stage_cost(st, wcsr.shape[1])[0] for st in wchain.stages)
    print(f"  {POOLED_CHECK:20s} PL_CSR_ROUTED      chain {t_wk * 1e3:9.4f} ms per call "
          f"({t_wg * 1e3:.4f} ms in a CUDA graph) {2 * wcsr.nnz / t_wk / 1e9:8.2f} GFLOP/s | plain "
          f"{t_wp * 1e3:9.4f} ms | library (cuSPARSE CSR f32) {t_wl * 1e3:9.4f} ms | chain moves "
          f"{w_bytes / 1e6:.3f} MB: bound {least_ms(w_bytes, 0)[0]:.4f} ms")
    bufs = RC._buffers(wchain, x)
    for stage in wchain.stages:  # valid inputs for every stage
        RC.run_stage(stage, bufs, plain=True)
    for i, stage in enumerate(wchain.stages):
        ms = graph_ms(lambda s=stage: RC.run_stage(s, bufs, plain=False)) if stage.kernel else 0.0
        b, f = stage_cost(stage, wcsr.shape[1])
        print(f"  {POOLED_CHECK} stage {i:2d} {routed_stage_label(wchain, stage):14s} "
              f"{ROUTED_KERNELS[stage.kernel][0] if stage.kernel else '(memset)':26s} {ms * 1e3:8.2f} us "
              f"in a graph | {b / 1e6:7.3f} MB, bound {least_ms(b, f)[0] * 1e3:6.2f} us")
    est = wchain.stages[-1]
    assert isinstance(est, RC.HeavyStage)
    e_args = (est.hvals, est.hpidx, est.hwidx, est.hlo, est.hhi, est.slot_ptr, est.slot_idx)
    e_ms = graph_ms(lambda: RC.run_stage(est, bufs, plain=False))
    e_plain = time_per_call(lambda v: RC.heavy_sums_reference(*e_args, v), x) * 1e3
    on_heavy = np.repeat(np.isin(np.arange(wcsr.shape[0]), wm.heavy_rows), np.diff(wcsr.indptr))
    h_cols = np.unique(wcsr.indices[on_heavy]).size
    e_bound = least_ms(*heavy_cost(est, wcsr.shape[1], cols=h_cols))
    hcsr = P.CSRMatrix(
        shape=wcsr.shape,
        indptr=np.r_[0, np.cumsum(np.where(np.isin(np.arange(wcsr.shape[0]), wm.heavy_rows),
                                           np.diff(wcsr.indptr), 0))].astype(np.int64),
        indices=wcsr.indices[on_heavy], data=wcsr.data[on_heavy],
    )
    e_lib = time_per_call(library_spmv(hcsr, dev), x) * 1e3
    print(f"  {POOLED_CHECK} routed_heavy_kernel alone ({est.hvals.shape[0] // LANE} tiles, "
          f"{len(wm.heavy_rows)} rows, {int(on_heavy.sum())} nnz, {h_cols} distinct columns): "
          f"{e_ms * 1e3:.2f} us in a graph | plain {e_plain:.4f} ms | bound {e_bound[0] * 1e3:.2f} us "
          f"({e_bound[1]}, {heavy_cost(est, wcsr.shape[1], cols=h_cols)[0] / 1e6:.2f} MB) | library "
          f"(cuSPARSE on the heavy rows alone) {e_lib * 1e3:.2f} us")
    print(f"  {POOLED_CHECK} routed_heavy_kernel (E) and its close: {e_ms * 1e3:.2f} us in a "
          f"graph, {100 * e_bound[0] / e_ms:.1f} % of its bound (before its redesign: {PARENT_US['heavy']} "
          f"us, {100 * e_bound[0] * 1e3 / PARENT_US['heavy']:.1f} %)")
    del bufs, hcsr

    # the small kernel against the staged chain it replaces (the same
    # operands), and cuSPARSE
    small_times = {}
    for (name, mode), (chain, staged) in small_chains.items():
        scsr = mats[name]
        xs = normal_x(scsr.shape[1], dev, seed=4)
        tk = time_per_call(lambda v, c=chain: RC.routed_chain_spmv(c, v), xs)
        tg = graph_ms(lambda c=chain: RC.routed_chain_spmv(c, xs)) / 1e3
        tsk = time_per_call(lambda v, c=staged: RC.routed_chain_spmv(c, v), xs)
        tsg = graph_ms(lambda c=staged: RC.routed_chain_spmv(c, xs)) / 1e3
        tp = time_per_call(lambda v, c=chain: RC.routed_spmv_reference(c, v), xs)
        tl = time_per_call(library_spmv(scsr, dev), xs)
        b_ms, by = least_ms(*stage_cost(chain.stages[0], scsr.shape[1]))
        small_times[(name, mode)] = (tk, tg, tp, tl, b_ms, by)
        print(f"  {name:20s} {mode:18s} small kernel {tk * 1e3:8.4f} ms per call ({tg * 1e3:.4f} ms "
              f"in a graph, 1 launch, host {max(tk - tg, 0) * 1e6:.1f} us) | staged chain {tsk * 1e3:8.4f} ms ({tsg * 1e3:.4f} ms graphed, "
              f"{sum(staged.counts.values())} launches + a memset) | plain {tp * 1e3:.4f} ms | library "
              f"(cuSPARSE CSR f32) {tl * 1e3:.4f} ms | bound {b_ms * 1e3:.2f} us ({by})")

    # -- float64: the df kernels at the main path's shapes ------------------
    print(f"float64 (double-float) times on {smi} (f64 x in, f64 y out, through the "
          "wrapper; cuSPARSE CSR in float64 as the library):")
    df_times = {}
    df_graphed = {}

    def df_time(key, label, fn, plain, x64, lib, moved, slots):
        """Per call through the wrapper (as the f32 rows), and the same call
        in a CUDA graph (device time: any split and combine kernels of the
        wrapper included, its host cost not; the window product is one
        launch)."""
        tk = time_per_call(fn, x64)
        tg = graph_ms(lambda: fn(x64))
        tp = time_per_call(plain, x64)
        tl = time_per_call(lib, x64) if lib is not None else None
        b_ms, by = least_ms(moved, DF_FLOPS_PER_SLOT * slots)
        df_times[key] = (tk * 1e3, tp * 1e3, b_ms, by, None if tl is None else tl * 1e3)
        df_graphed[key] = tg
        print(f"  {label}: kernel {tk * 1e3:9.4f} ms per call ({tg:.4f} ms in a CUDA graph) | plain "
              f"{tp * 1e3:9.4f} ms | library {'-' if tl is None else f'{tl * 1e3:9.4f} ms'} | bound "
              f"{b_ms:.4f} ms ({by}, {moved / 1e6:.1f} MB); graphed kernel at "
              f"{100 * b_ms / tg:.1f} % of it")

    for name in ("cube_coup_like", "cavity10_like"):
        cm, cn = csrs[name].shape
        dmat, dplan = prepared_df[name]
        df_time("dia_df" if name == "cube_coup_like" else f"dia_df {name}",
                f"{name} PL_DIA_F64 dia_df_kernel ({SC._rows_plan(dmat, dplan, dmat.data.device)} row(s) a thread)",
                lambda v, o=dmat, p=dplan: SC.dia_spmv_df_cuda(o, v, p),
                lambda v, o=dmat, p=dplan: SC.dia_spmv_df_reference(o, v, p), normal_x64(cn, dev, seed=4),
                library_spmv(csrs[name], dev, torch.float64),
                dia_live(dmat)[0] + 8 * (cn + cm), dia_live(dmat)[1])
    for name in ("raefsky1_like", RESID_BIG):
        rdr, rplan = prepared_df[name] if name == "raefsky1_like" else resid_ops[(name, "PL_DIA_RESID_F64")]
        n = mats[name].shape[1]
        moved, flops = resid_cost(rdr, n, df=True)
        df_time(f"dia_resid_df {name}", f"{name} PL_DIA_RESID_F64 dia_resid_df_kernel (whole product)",
                lambda v, o=rdr, p=rplan: SC.dia_resid_spmv_df_cuda(o, v, p),
                lambda v, o=rdr, p=rplan: SC.dia_spmv_df_reference(o.mat, v, p, o),
                normal_x64(n, dev, seed=5), library_spmv(mats[name], dev, torch.float64), moved,
                flops // DF_FLOPS_PER_SLOT)
    for name in ("thermal2_like", "delaunay_n12_like", "fem_3d_thermal2_like"):
        wm = prepared_df[name]
        wmm, wn = wm.shape
        x64 = normal_x64(wn, dev, seed=4)
        df_time(f"window_df {name}", f"{name} PL_CSR_WINDOW_F64 window_df_kernel"
                f"{' (xdirect)' if wm.xdirect else ''}",
                lambda v, o=wm: WC.window_spmv(o, v), lambda v, o=wm: WC.window_spmv_df_reference(o, v),
                x64, library_spmv(csrs[name], dev, torch.float64),
                slab_bytes(wm) + nbytes(wm.vals_lo) + 8 * (wn + wmm), wm.vals.numel())
    # the routed df program on caida_like: each launch alone in a CUDA graph
    # on valid inputs (the plain chain run first), summed per kernel, with
    # its bound and plain time; then the whole product per call and graphed
    # on caida_like and sg_rand_like, against cuSPARSE f64
    dchain = prepared_df[ROUTED_CHECK]
    x64 = normal_x64(csr.shape[1], dev, seed=4)
    bufs = RC._df_buffers(dchain, x64)
    for stage in dchain.stages:  # valid inputs for every stage
        RC.run_df_stage(stage, bufs, plain=True)
    df_kernel = {k: [0.0, 0.0, 0, 0] for k in RC._DF_COUNTERS}  # us graphed, plain ms, bytes, flops
    labels = df_stage_labels(dchain)
    permute_lib = {}
    for i, stage in enumerate(dchain.stages):
        ms = graph_ms(lambda s=stage: RC.run_df_stage(s, bufs, plain=False))
        pms = time_per_call(lambda v, s=stage: RC.run_df_stage(s, bufs, plain=True), x64) * 1e3
        b, f = df_stage_cost(stage, csr.shape[1])
        if isinstance(stage, RC.DFPermuteStage):
            permute_lib[ROUTED_CHECK] = df_gather_take_us(stage, bufs)
        acc = df_kernel[stage.kernel]
        acc[0] += ms * 1e3
        acc[1] += pms
        acc[2] += b
        acc[3] += f
        print(f"  {ROUTED_CHECK} df stage {i} {labels[stage]:60s} {ms * 1e3:8.2f} us in a graph | "
              f"plain {pms:.4f} ms | {b / 1e6:7.3f} MB, bound {least_ms(b, f)[0] * 1e3:6.2f} us "
              f"({least_ms(b, f)[1]})"
              + (f" | torch.take f64 {permute_lib[ROUTED_CHECK]:.2f} us"
                 if isinstance(stage, RC.DFPermuteStage) else ""))
    rd = next(s for s in dchain.stages if isinstance(s, RC.DFRowdotStage))
    hd64 = DF.df_combine64(rd.hh, rd.hl)
    xpad = torch.nn.functional.pad(x64, (0, hd64.shape[1] - x64.shape[0]))
    rowdot_lib = graph_ms(lambda: torch.mv(hd64, xpad)) * 1e3
    del hd64, xpad, bufs
    # the one output gather of sg_rand_like's three domains, alone in a graph
    sg = prepared_df["sg_rand_like"]
    xs = normal_x64(csrs["sg_rand_like"].shape[1], dev, seed=4)
    bufs = RC._df_buffers(sg, xs)
    for stage in sg.stages:
        RC.run_df_stage(stage, bufs, plain=True)
    (stage,) = [s for s in sg.stages if isinstance(s, RC.DFPermuteStage)]
    ms = graph_ms(lambda: RC.run_df_stage(stage, bufs, plain=False))
    pms = time_per_call(lambda v: RC.run_df_stage(stage, bufs, plain=True), xs) * 1e3
    permute_lib["sg_rand_like"] = df_gather_take_us(stage, bufs)
    b, f = df_stage_cost(stage, csrs["sg_rand_like"].shape[1])
    print(f"  sg_rand_like {DF_KERNEL_LABELS['df_permute']}, one launch for its {len(sg.domains)} "
          f"domains: {ms * 1e3:.2f} us in a graph | plain {pms:.4f} ms | torch.take f64 "
          f"{permute_lib['sg_rand_like']:.2f} us | {b / 1e6:.3f} MB, bound "
          f"{least_ms(b, f)[0] * 1e3:.2f} us ({least_ms(b, f)[1]})")
    del bufs
    # row 16b is every C-df launch: level 0's (with its closed level) and
    # the later levels'
    df_kernel["df_reduce_all"] = [a + b for a, b in zip(df_kernel["df_gather_reduce"],
                                                        df_kernel["df_reduce"])]
    for k, (us, pms, b, f) in df_kernel.items():
        if not us:
            continue  # no such launch on this matrix
        b_ms, by = least_ms(b, f)
        lib = {"df_rowdot": rowdot_lib * 1e-3,
               "df_permute": permute_lib[ROUTED_CHECK] * 1e-3}.get(k)
        df_times[f"routed_{k}"] = (us * 1e-3, pms, b_ms, by, lib)
        label = DF_KERNEL_LABELS.get(k, "routed_df_reduce_kernel (C-df, every level)")
        print(f"  {ROUTED_CHECK} {label}: {us:.2f} us per product in a graph | plain {pms:.4f} ms | "
              f"bound {b_ms * 1e3:.2f} us ({by}, {b / 1e6:.3f} MB); graphed at "
              f"{100 * b_ms * 1e3 / us:.1f} % of it"
              + (f" | library (torch.mv, f64 block) {rowdot_lib:.2f} us" if k == "df_rowdot" else "")
              + (f" | library (torch.take, f64) {lib * 1e3:.2f} us" if k == "df_permute" else ""))
    del df_kernel["df_reduce_all"]
    df_bytes = sum(v[2] for v in df_kernel.values())
    df_bound = least_ms(df_bytes, sum(v[3] for v in df_kernel.values()))
    for name in (ROUTED_CHECK, "sg_rand_like"):
        c = prepared_df[name]
        ncsr = csrs[name]
        xv = normal_x64(ncsr.shape[1], dev, seed=4)
        t_dp = time_per_call(lambda v, c=c: RC.routed_df_spmv(c, v), xv)
        t_dg = graph_ms(lambda c=c, xv=xv: RC.routed_df_spmv(c, xv), reps=10) / 1e3
        t_dpp = time_per_call(lambda v, c=c: RC.routed_df_spmv(c, v, plain=True), xv)
        t_dl = time_per_call(library_spmv(ncsr, dev, torch.float64), xv)
        bound_txt = ""
        if name == ROUTED_CHECK:
            bound_txt = (f" | stages move {df_bytes / 1e6:.3f} MB: bound {df_bound[0]:.4f} ms ({df_bound[1]}), "
                         f"graphed at {100 * df_bound[0] / (t_dg * 1e3):.1f} % of it")
        print(f"  {name} PL_CSR_ROUTED_F64 whole df product ({RC.df_chain_launches(c)} launches, one "
              f"host call): {t_dp * 1e3:.4f} ms per call ({t_dg * 1e3:.4f} ms in a CUDA graph, host "
              f"{max(t_dp - t_dg, 0) * 1e6:.1f} us) {2 * ncsr.nnz / t_dp / 1e9:.2f} GFLOP/s | plain "
              f"{t_dpp * 1e3:.4f} ms | library (cuSPARSE CSR f64) {t_dl * 1e3:.4f} ms, "
              f"{t_dp / t_dl:.2f}x per call, {t_dg / t_dl:.2f}x graphed{bound_txt}")
    print(f"torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log("phase 5: done")

    # bounds: each input read once and each output written once, 2 flops
    # per stored slot, at the shapes the main path runs
    cube = prepared[("cube_coup_like", "PL_DIA_ROWS")][0]
    cube_m, cube_n = csrs["cube_coup_like"].shape
    b_rows = least_ms(dia_live(cube)[0] + 4 * (cube_n + cube_m), 2 * dia_live(cube)[1])

    def window_bound(name, mode):
        mat = prepared[(name, mode)]
        m, n = mat.shape
        return least_ms(slab_bytes(mat) + 4 * (n + m), 2 * mat.vals.numel())

    for (name, mode) in prepared:
        if mode.startswith("PL_CSR_WINDOW"):
            b_ms, by = window_bound(name, mode)
            tk, tp = times[(name, mode)]
            print(f"  bound {name:20s} {mode:18s} {b_ms:.4f} ms ({by}); kernel at "
                  f"{100 * b_ms / (tk * 1e3):.1f} % of it")
    entry = {}
    for kernel, name in (("window_blocks", "thermal2_like"), ("window_single", "delaunay_n12_like")):
        tk, tp = times[(name, "PL_CSR_WINDOW")]
        entry[kernel] = (tk, tp, libs[name], *window_bound(name, "PL_CSR_WINDOW"))
    t_dk, t_dp = times[("cube_coup_like", "PL_DIA_ROWS")]
    kernels = [
        {"name": "dia_rows_kernel", "route": "cuda", "source": DIA_SOURCE,
         "replaces": "spmv_openmp_cuda_tpu/ops/spmv_pallas.py:426",
         "launches": launches["dia_spmv"], "max_abs_err": errs["dia_spmv"],
         "ms": t_dk * 1e3, "plain_ms": t_dp * 1e3, "bound_ms": b_rows[0],
         "bound_by": b_rows[1], "library_ms": libs["cube_coup_like"] * 1e3},
        {"name": "dia_resid_kernel", "route": "cuda", "source": DIA_SOURCE,
         "replaces": "spmv_openmp_cuda_tpu/ops/spmv_pallas.py:426",
         "launches": launches["dia_resid"], "max_abs_err": errs["dia_resid"],
         "ms": resid_times[("raefsky1_like", "PL_DIA_RESID")][0] * 1e3,
         "plain_ms": resid_times[("raefsky1_like", "PL_DIA_RESID")][1] * 1e3,
         "bound_ms": resid_times[("raefsky1_like", "PL_DIA_RESID")][3],
         "bound_by": resid_times[("raefsky1_like", "PL_DIA_RESID")][4],
         "library_ms": resid_times[("raefsky1_like", "PL_DIA_RESID")][2] * 1e3},
    ]
    for kernel, line in (("window_blocks", 1062), ("window_single", 1125)):
        tk, tp, tl, b_ms, by = entry[kernel]
        kernels.append(
            {"name": f"{kernel}_kernel", "route": "cuda", "source": WINDOW_SOURCE,
             "replaces": f"spmv_openmp_cuda_tpu/formats/window.py:{line}",
             "launches": launches[kernel], "max_abs_err": errs[kernel],
             "ms": tk * 1e3, "plain_ms": tp * 1e3, "bound_ms": b_ms, "bound_by": by,
             "library_ms": tl * 1e3})
    for kernel, (kname, replaces) in ROUTED_KERNELS.items():
        if kernel in ("heavy", "small"):
            continue  # timed on webbase_like and on delaunay_n12_like below
        ms, pms, b, f, lib = per_kernel[kernel]
        b_ms, by = least_ms(b, f)
        kernels.append(
            {"name": kname, "route": "cuda", "source": ROUTED_SOURCE, "replaces": replaces,
             "launches": launches[kernel], "max_abs_err": errs[kernel], "ms": ms, "plain_ms": pms,
             "bound_ms": b_ms, "bound_by": by, "library_ms": lib if kernel == "permute" else None})
    for key, kname, replaces in (
        ("dia_df", "dia_df_kernel", "spmv_openmp_cuda_tpu/ops/spmv_pallas.py:628"),
        ("dia_resid_df raefsky1_like", "dia_resid_df_kernel", "spmv_openmp_cuda_tpu/ops/spmv_pallas.py:628"),
        ("window_df thermal2_like", "window_df_kernel", "spmv_openmp_cuda_tpu/formats/window.py:1062"),
        # row 16: K3 (_gather_products_df), now C-df's level 0; row 16b:
        # every C-df launch
        ("routed_df_gather_reduce", "routed_df_reduce_kernel",
         "spmv_openmp_cuda_tpu/formats/routed.py:1882"),
        ("routed_df_reduce_all", "routed_df_reduce_kernel", "spmv_openmp_cuda_tpu/formats/routed.py:1890"),
        ("routed_df_permute", "routed_df_permute_kernel", "spmv_openmp_cuda_tpu/ops/route.py:347"),
        ("routed_df_rowdot", "routed_df_rowdot_kernel", "spmv_openmp_cuda_tpu/formats/routed.py:1962"),
    ):
        ms, pms, b_ms, by, lib = df_times[key]
        counter = key.split()[0]
        if counter == "routed_df_reduce_all":
            counted = launches64["routed_df_gather_reduce"] + launches64["routed_df_reduce"]
            err = max(errs["routed_df_gather_reduce"], errs.get("routed_df_reduce", 0.0))
        else:
            counted, err = launches64[counter], errs[counter]
        kernels.append(
            {"name": kname, "route": "cuda", "source": DF_SOURCE, "replaces": replaces,
             "launches": counted, "max_abs_err": err, "ms": ms,
             "plain_ms": pms, "bound_ms": b_ms, "bound_by": by, "library_ms": lib})
    kernels.append(
        {"name": ROUTED_KERNELS["heavy"][0], "route": "cuda", "source": ROUTED_SOURCE,
         "replaces": ROUTED_KERNELS["heavy"][1], "launches": launches["heavy"],
         "max_abs_err": errs["heavy"], "ms": e_ms, "plain_ms": e_plain, "bound_ms": e_bound[0],
         "bound_by": e_bound[1], "library_ms": e_lib})
    slice_kernels, small_launches = csr_ell_slice(dev, smi, mats)
    kernels.extend(slice_kernels)
    tk, tg, tp, tl, b_ms, by = small_times[("delaunay_n12_like", "PL_CSR_ROUTED")]
    kernels.append(
        {"name": ROUTED_KERNELS["small"][0], "route": "cuda", "source": ROUTED_SOURCE,
         "replaces": ROUTED_KERNELS["small"][1], "launches": small_launches,
         "max_abs_err": errs["small"], "ms": tg * 1e3, "plain_ms": tp * 1e3, "bound_ms": b_ms,
         "bound_by": by, "library_ms": tl * 1e3})
    if not small_launches:
        raise AssertionError("the small kernel never launched on its main path (the harness cell)")
    lap_cells = solver_phase(dev, csrs, mats, models, models64, seed)
    # the DIA rows kernels' other cells: CG's Laplacian, cavity10_like, and
    # cube_coup_like in bf16 (dia_rows_kernel) or per call and graphed
    dia_cells = {
        "dia_rows_kernel": {
            f"laplacian_{LAPLACE_N}x{LAPLACE_N} PL_DIA_ROWS": lap_cells["dia_spmv"],
            **{f"{name} {mode}": {"ms": times[(name, mode)][0] * 1e3, "graph_ms": dia_graphed[(name, mode)],
                                  "plain_ms": times[(name, mode)][1] * 1e3,
                                  "library_ms": libs[name] * 1e3}
               for name, mode in dia_graphed}},
        "dia_df_kernel": {
            f"laplacian_{LAPLACE_N}x{LAPLACE_N} PL_DIA_F64": lap_cells["dia_df"],
            **{f"{name} PL_DIA_F64": {
                "ms": df_times[key][0], "graph_ms": df_graphed[key], "plain_ms": df_times[key][1],
                "bound_ms": df_times[key][2], "library_ms": df_times[key][4]}
               for key, name in (("dia_df", "cube_coup_like"), ("dia_df cavity10_like", "cavity10_like"))}},
    }
    for entry in kernels:
        if entry["name"] in dia_cells:
            entry["cells"] = dia_cells[entry["name"]]
    md_entries, md_refs = multi_device_phase(dev, smi, csrs, mats, models)
    kernels.extend(md_entries)
    kernels.extend(cross_process_phase(dev, smi, md_refs))
    log("done")
    print(defaults)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
