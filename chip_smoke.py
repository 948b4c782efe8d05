#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the root of the repository: python3 chip_smoke.py

It builds the CUDA kernels from spmv_openmp_cuda_tpu_torch/csrc/ (one nvcc
per source, all at once), holds each kernel against its plain PyTorch
version at the main path's shapes, drives the main path (AutoSpMV.from_csr
-> model(x)) on three DIA-class, three window-class and two routed proxies
at their published size, first in float32 and then in float64 (the
double-float kernels of csrc/df_spmv.cu), each pass with the launch counters
reset just before and read just after, checks the results against the f64
oracle (for the f32 routed engine, the oracle of the matrix as its layout
stores it: heavy rows in bf16; the df layouts keep every value as an (hi,
lo) pair, so float64 is held to the exact matrix), runs the CLI in both
dtypes, and times kernel, plain version and one PyTorch library call
(cuSPARSE through torch.sparse, f32 or f64, a yardstick the port never
calls) with CUDA events; the routed kernels alone are timed inside CUDA
graphs, so that the host's launch cost does not hide their device time.

The CSR/ELL mode matrix (csr_ell_slice) follows: ell_t_kernel (csrc/
ell_spmv.cu) on sg_like and thermal2_like and lanes_kernel (csrc/
lanes_spmv.cu) on four small proxies and a four-window matrix against their
plain versions, each rerun bitwise equal; then that slice's main path with
its own counters from zero: the harness over all 26 modes on
delaunay_n12_like and over the mode matrix on sg_like (SG's published
size), its log printed and read back by parse_log, every mode that prepares
ok:1 and within the relative bound on x ~ N(0, 1); the CLI's explicit modes;
float64 binned against the exact oracle; then the two kernels' times.

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
}
#: routed proxies: caida_like is checked kernel by kernel and timed (the JAX
#: bench runs it under PL_CSR_ROUTED_BF16, AutoSpMV under PL_CSR_ROUTED);
#: sg_rand_like (three chunks) runs the main path only
ROUTED_CHECK = "caida_like"
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
#: float64 mode of each format (AutoSpMV and CLI AUTO at --dtype float64)
F64_MODES = {"dia": "PL_DIA_F64", "dia_resid": "PL_DIA_RESID_F64",
             "window": "PL_CSR_WINDOW_F64", "routed": "PL_CSR_ROUTED_F64"}
#: f32 operations per stored slot of a df kernel: TwoProduct with an FMA
#: error (3), the cross terms (4), a TwoSum (6) and the low words (2)
DF_FLOPS_PER_SLOT = 15
#: routed kernel -> (name in csrc/routed_spmv.cu, the TPU kernel it replaces)
ROUTED_KERNELS = {
    "gather": ("routed_gather_kernel", "spmv_openmp_cuda_tpu/formats/routed.py:959"),
    "w_stage": ("routed_w_stage_kernel", "spmv_openmp_cuda_tpu/ops/route.py:347"),
    "perm_reduce": ("routed_perm_reduce_kernel", "spmv_openmp_cuda_tpu/formats/routed.py:1239"),
    "hdense": ("routed_hdense_kernel", "spmv_openmp_cuda_tpu/formats/routed.py:1060"),
}
#: H100 SXM data sheet: HBM rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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
    return nbytes(first.data)


def stage_cost(stage, n_x: int):
    """(bytes, flops) of one routed stage: each input read once, each output
    written once, at this run's shapes."""
    from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as RC

    out = 4 * stage.out_elems()
    if isinstance(stage, RC.GatherStage):
        n_real = stage.vals.shape[0] // 128
        w1 = n_real * 128 * 128 if stage.w1 is not None else 0
        return nbytes(stage.vals, stage.pidx, stage.widx) + w1 + 4 * n_x + out, stage.vals.numel()
    if isinstance(stage, RC.WStage):
        h = stage.n_tiles * 128
        src = 4 * 128 * min(stage.src_rows, h)
        idx = sum(h * 128 for a in (stage.r, stage.w, stage.ra) if a is not None)
        return src + idx + out, 0
    if isinstance(stage, RC.ReduceStage):
        h = stage.r3.shape[0]
        src = 4 * 128 * min(stage.src_rows, h)
        idx = nbytes(*(a for a in (stage.W, stage.r1, stage.r3, stage.mask, stage.groups)
                       if a is not None))
        return src + idx + out, sum(ng * w for _r0, ng, w, _g0 in stage.runs) * 128
    if isinstance(stage, RC.HDenseStage):
        return nbytes(stage.hdense, stage.target) + 4 * n_x + 4 * stage.hdense.shape[0], \
            2 * stage.hdense.numel()
    return out, 0


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
    from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
    from spmv_openmp_cuda_tpu_torch.utils import synth

    mats = {name: csrs[name] for name in ("delaunay_n12_like", "raefsky1_like", "cavity10_like",
                                          "thermal2_like")}
    for name in ("sg_like", "west2021_like"):
        t = time.perf_counter()
        mats[name] = P.coo_to_csr(synth.preset(name))
        m, n = mats[name].shape
        log(f"set-up: {name} {m}x{n}, {mats[name].nnz} nnz, max row {mats[name].max_row_nz}, "
            f"generated in {time.perf_counter() - t:.1f}s")
    ells = {name: P.coo_to_ell(P.csr_to_coo(mats[name]))
            for name in ("sg_like", "thermal2_like", "delaunay_n12_like")}

    # -- phase 2: the two kernels against their plain versions -------------
    errs = {"ell_t": 0.0, "lanes": 0.0}

    def check(kernel, label, fn, plain, x):
        yk, yk2 = fn(x), fn(x)
        torch.cuda.synchronize()
        yp = plain(x)
        err = (yk - yp).abs().max().item()
        same = torch.equal(yk, yk2)
        ok = err <= bound(yp) and yk.abs().max().item() > 0 and same
        errs[kernel] = max(errs[kernel], err)
        log(f"phase 2: {label}: {kernel}_kernel max|y_k - y_p| = {err:.3e} <= {bound(yp):.3e}, "
            f"rerun bitwise equal: {same}: {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: {kernel}_kernel disagrees with its plain version")

    ell_ops = {}
    for name in ELL_T_CHECKS:
        mat = ell_ops[name] = device_ell(ells[name], transposed=True, device=dev)
        check("ell_t", f"{name} PL_ELL_ROWS_T (W_pad {mat.data.shape[0]}, M_pad {mat.data.shape[1]})",
              lambda v, o=mat: EC.ell_t_cuda(o, v), lambda v, o=mat: EC.ell_t_reference(o, v),
              normal_x(mats[name].shape[1], dev, seed=1))
    lanes_ops = {}
    wide = P.coo_to_csr(synth.random_uniform(4096, 50000, density=3e-4, seed=1))
    for name, csr in [(n, mats[n]) for n in LANES_CHECKS] + [("random_uniform 4096x50000", wide)]:
        mat = lanes_ops[name] = prepare_lanes_small(csr, device=dev)
        check("lanes", f"{name} PL_CSR_LANES ({mat.vals.shape[0]} slot rows, {len(mat.window_tiles)} "
              f"windows, G={mat.n_groups})", lambda v, o=mat: LC.lanes_cuda(o, v),
              lambda v, o=mat: LC.lanes_reference(o, v), normal_x(csr.shape[1], dev, seed=1))

    # -- phase 3: the slice's main path, counters from zero -----------------
    EC.ell_t_cuda.launches = 0
    LC.lanes_cuda.launches = 0
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
            f"{sum(r.error is None for r in rep.results)} prepared, all ok:1 and within the "
            f"x~N(0,1) bound (bf16 storage: {bf16_lim:.1f}x it); refused as expected: "
            f"{[r.kernel for r in rep.results if r.error]}; det:0 for {det0}; parse_log read "
            f"{len(rows)} rows")
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
    launches = {"ell_t": EC.ell_t_cuda.launches, "lanes": LC.lanes_cuda.launches}
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
        *(("ell_t", n, ell_ops[n], EC.ell_t_cuda, EC.ell_t_reference,
           nbytes(ell_ops[n].data, ell_ops[n].cols), 2 * ell_ops[n].data.numel()) for n in ELL_T_CHECKS),
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
        tl = time_per_call(library_spmv(csr, dev), x)
        b_ms, by = least_ms(moved + 4 * (n + m), flops)
        times[(kernel, name)] = (tk, tp, tl, b_ms, by)
        print(f"  {name:20s} {kernel}_kernel {tk * 1e3:8.4f} ms per call ({tg * 1e3:.4f} ms in a graph, "
              f"host {max(tk - tg, 0) * 1e6:.1f} us) | plain {tp * 1e3:8.4f} ms | library (cuSPARSE "
              f"CSR f32) {tl * 1e3:8.4f} ms | bound {b_ms:.5f} ms ({by}, {(moved + 4 * (n + m)) / 1e6:.2f} "
              f"MB); graphed kernel at {100 * b_ms / (tg * 1e3):.1f} % of it")
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
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.cli import time_per_call
    from spmv_openmp_cuda_tpu_torch.config import LANE
    from spmv_openmp_cuda_tpu_torch.formats import window as W
    from spmv_openmp_cuda_tpu_torch.formats.dia import split_offsets
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
        built = list(pool.map(cuda_lib.build, ("dia_spmv", "window_spmv", "routed_spmv", "df_spmv",
                                                "ell_spmv", "lanes_spmv")))
    log(f"phase 1: built {', '.join(os.path.relpath(p) for p, _ in built)} "
        f"in {time.perf_counter() - t:.1f}s")
    for _path, nvcc_log in built:
        for line in nvcc_log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # -- host set-up: the proxies at their published size ------------------
    csrs = {}
    for name in (*DIA_CHECKS, *WINDOW_CHECKS, ROUTED_CHECK, "sg_rand_like"):
        t = time.perf_counter()
        csrs[name] = P.coo_to_csr(synth.preset(name))
        m, n = csrs[name].shape
        log(f"set-up: {name} {m}x{n}, {csrs[name].nnz} nnz, generated in {time.perf_counter() - t:.1f}s")

    # -- phase 2: each kernel against its plain version ---------------------
    errs = {"dia_spmv": 0.0, "dia_resid": 0.0, "window_blocks": 0.0, "window_single": 0.0}
    prepared = {}
    for name, modes in DIA_CHECKS.items():
        csr = csrs[name]
        x = normal_x(csr.shape[1], dev, seed=1)
        for mode in modes:
            spec = registry.get(mode)
            t = time.perf_counter()
            ops = spec.prepare(csr, None, P.Config(), dev)
            prep_s = time.perf_counter() - t
            prepared[(name, mode)] = ops
            yk = spec.jitted(ops)(x)
            torch.cuda.synchronize()
            if mode.startswith("PL_DIA_RESID"):
                dr, plan = ops
                yp = SC.dia_spmv_reference(dr.mat, x, plan, dr)
            else:
                yp = SC.dia_spmv_reference(ops[0], x, ops[1])
            err = (yk - yp).abs().max().item()
            ok = err <= bound(yp) and yk.abs().max().item() > 0
            errs["dia_spmv"] = max(errs["dia_spmv"], err)
            log(f"phase 2: {name} {mode}: max|y_k - y_p| = {err:.3e} <= {bound(yp):.3e}, "
                f"max|y_k| = {yk.abs().max().item():.3e}, prepare {prep_s:.1f}s: "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {mode}: kernel disagrees with its plain version")
            if mode.startswith("PL_DIA_RESID"):
                dr, plan = ops
                y0 = torch.zeros(plan.s_pad * LANE, device=dev)
                SC.dia_resid_cuda(dr, x, y0, plan)
                yr = SC.dia_resid_reference(dr, x, plan)
                err = (y0 - yr).abs().max().item()
                errs["dia_resid"] = max(errs["dia_resid"], err)
                log(f"phase 2: {name} {mode} fringe kernel alone: {err:.3e} <= {bound(yr):.3e}, "
                    f"{dr.nnz_resid} fringe nnz")
                if not (err <= bound(yr) and y0.abs().max().item() > 0):
                    raise AssertionError(f"{name} {mode}: fringe kernel disagrees")

    def check_window(label, mat, x):
        kernel = "window_single" if mat.xdirect else "window_blocks"
        yk = WC.window_spmv(mat, x)
        torch.cuda.synchronize()
        yp = WC.window_spmv_reference(mat, x)
        err = (yk - yp).abs().max().item()
        ok = err <= bound(yp) and yk.abs().max().item() > 0
        errs[kernel] = max(errs[kernel], err)
        log(f"phase 2: {label}: {kernel}_kernel max|y_k - y_p| = {err:.3e} <= {bound(yp):.3e}, "
            f"max|y_k| = {yk.abs().max().item():.3e}: {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: {kernel}_kernel disagrees with its plain version")

    # routed: each stage's kernel against its plain version, caida_like in
    # both modes (the bf16 operands are the f32 layout with vals cast, as
    # prepare_routed makes them), then a small domain (t <= 4)
    def check_routed(label, chain, x):
        for stage, yk, yp in RC.compare_stages(chain, x):
            torch.cuda.synchronize()
            err = (yk - yp).abs().max().item()
            exact = stage.kernel in ("gather", "w_stage")
            ok = torch.equal(yk, yp) if exact else err <= bound(yp)
            errs[stage.kernel] = max(errs.get(stage.kernel, 0.0), err)
            log(f"phase 2: {label}: {ROUTED_KERNELS[stage.kernel][0]} {type(stage).__name__} "
                f"{yk.numel()} elements: max|k - p| = {err:.3e} "
                f"{'(bit for bit)' if exact else f'<= {bound(yp):.3e}'}: {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{label}: {stage.kernel} kernel disagrees with its plain version")
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
    small = P.coo_to_csr(synth.random_uniform(9000, 9000, density=5e-4, seed=7))
    schain = RC.prepare_routed_chain(small, device=dev)
    assert schain.mat.perm_products.t <= 4 and schain.mat.out_t <= 4, "not a small domain"
    check_routed(f"random_uniform 9000 (t={schain.mat.perm_products.t}, staged chain)", schain,
                 normal_x(9000, dev, seed=1))

    # -- phase 3: the main path, counters from zero ------------------------
    SC.dia_spmv_cuda.launches = 0
    SC.dia_resid_cuda.launches = 0
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
    torch.cuda.synchronize()
    launches = {
        "dia_spmv": SC.dia_spmv_cuda.launches,
        "dia_resid": SC.dia_resid_cuda.launches,
        "window_blocks": WC.window_blocks_cuda.launches,
        "window_single": WC.window_single_cuda.launches,
        **{k: fn.launches for k, fn in RC._COUNTERS.items()},
    }
    log(f"phase 3: main path launches {launches}")
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
            gap = f"; gap to the exact matrix {exact:.3e} (stored bf16 heavy rows, not asserted)"
        log(f"phase 3: {name} -> {fmt}, prepare+upload {prep_s:.1f}s; reference protocol: "
            f"{'OK' if rep.ok else 'FAIL'} maxAbsDiff={rep.max_abs_diff:.3e}; "
            f"x~N(0,1) vs f64 oracle{' (as stored)' if fmt == 'routed' else ''}: "
            f"{rel:.3e} <= {lim:.3e}{gap}")
        if not rep.ok or not rel <= lim:
            raise AssertionError(f"{name}: wrong output")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # -- phase 3, float64: the main path on the df kernels, counters from zero
    cfg64 = P.Config(dtype="float64")
    df_counters = {
        "dia_df": SC.dia_spmv_df_cuda, "dia_resid_df": SC.dia_resid_df_cuda,
        "window_df": WC.window_df_cuda, "routed_df_gather": RC.routed_df_gather_cuda,
    }
    f32_counters = {
        "dia_spmv": SC.dia_spmv_cuda, "dia_resid": SC.dia_resid_cuda,
        "window_blocks": WC.window_blocks_cuda, "window_single": WC.window_single_cuda,
        **RC._COUNTERS,
    }
    for fn in (*df_counters.values(), *f32_counters.values()):
        fn.launches = 0
    outputs64 = {}
    models64 = {}
    for name, csr in csrs.items():
        t = time.perf_counter()
        model = models64[name] = AutoSpMV.from_csr(csr, cfg=cfg64, device="cuda")
        prep_s = time.perf_counter() - t
        x_ref = fill_rnd_vector(csr.shape[1], seed=2)
        x_n = np.random.default_rng(3).standard_normal(csr.shape[1])
        outputs64[name] = (model.format, model(x_ref), model(x_n), x_ref, x_n, prep_s)
    torch.cuda.synchronize()
    launches64 = {k: fn.launches for k, fn in df_counters.items()}
    also = {k: fn.launches for k, fn in f32_counters.items() if fn.launches}
    log(f"phase 3 (float64): main path launches {launches64}; f32 kernels in it {also} "
        "(the W stages move each plane of the df routed products)")
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
    if not all(launches64.values()):
        raise AssertionError(f"a df kernel of the main path never launched: {launches64}")

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
            dr, plan = ops
            mat, yp = dr.mat, SC.dia_spmv_df_reference(dr.mat, x64, plan, dr)
        else:
            (mat, plan), dr = ops, None
            yp = SC.dia_spmv_df_reference(mat, x64, plan)
        check_df(f"{name} {mode} dia_df_kernel (bs={plan.bs}, nblocks={plan.nblocks}, "
                 f"{len(mat.offsets)} diagonals)",
                 registry.get(mode).jitted(ops)(x64), yp, errs, "dia_df")
        if dr is not None:
            xh, xl = DF.split_f64_t(x64)
            yh = torch.zeros(plan.s_pad * LANE, device=dev)
            yl = torch.zeros_like(yh)
            SC.dia_resid_df_cuda(dr, xh, xl, yh, yl, plan)
            check_df(f"{name} dia_resid_df_kernel alone ({dr.nnz_resid} fringe nnz)",
                     DF.df_combine64(yh, yl),
                     DF.df_combine64(*SC.dia_resid_df_reference(dr, xh, xl, plan)), errs, "dia_resid_df")

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
            check_window(f"{name} {mode}", ops, x)
        x64 = normal_x64(csr.shape[1], dev, seed=1)
        check_df(f"{name} PL_CSR_WINDOW_F64 window_df_kernel", WC.window_spmv(mat_df, x64),
                 WC.window_spmv_df_reference(mat_df, x64), errs, "window_df")
    # the third x form: a small layout forced to shared_w
    small = P.coo_to_csr(synth.fem_like(m=6000, n=6000, nnz=60000, spread=700, lo=4, hi=16, seed=7))
    for vals_dtype in (torch.float32, torch.bfloat16):
        mat = W.prepare_window(small, g=8, bps=4, shared_w=True, vals_dtype=vals_dtype, device=dev)
        assert mat.shared_w
        check_window(f"fem_like 6000 shared_w {vals_dtype}", mat, normal_x(6000, dev, seed=1))
    mat = W.prepare_window(small, g=8, bps=4, shared_w=True, df=True, device=dev)
    x64 = normal_x64(6000, dev, seed=1)
    check_df("fem_like 6000 shared_w window_df_kernel", WC.window_spmv(mat, x64),
             WC.window_spmv_df_reference(mat, x64), errs, "window_df")

    # K3 on caida_like: the df gather alone (products are exact in both:
    # the kernel's FMA error is the plain Veltkamp error), then the whole df
    # product against its plain chain
    csr = csrs[ROUTED_CHECK]
    dchain = prepared_df[ROUTED_CHECK] = models64[ROUTED_CHECK]._operands
    mdf = dchain.domains[0].mdf
    log(f"phase 2: {ROUTED_CHECK} df routed layout rows_a={mdf.mat.rows_a} "
        f"t1={mdf.mat.perm_products.t} levels={[p.t for p in mdf.mat.lvl_perms]} "
        f"heavy rows {len(mdf.heavy_rows_df)} in a (hi, lo) block")
    x64 = normal_x64(csr.shape[1], dev, seed=1)
    xh, xl = DF.split_f64_t(x64)
    gk, gp = RC.routed_df_gather(mdf, xh, xl), RC.routed_df_gather(mdf, xh, xl, plain=True)
    torch.cuda.synchronize()
    err = max((gk[0] - gp[0]).abs().max().item(), (gk[1] - gp[1]).abs().max().item())
    errs["routed_df_gather"] = err
    exact = torch.equal(gk[0], gp[0]) and torch.equal(gk[1], gp[1])
    log(f"phase 2: {ROUTED_CHECK}: routed_df_gather_kernel {gk[0].numel()} pairs: max|k - p| = "
        f"{err:.3e} (bit for bit): {'OK' if exact else 'FAIL'}")
    if not exact:
        raise AssertionError("routed_df_gather_kernel disagrees with its plain version")
    check_df(f"{ROUTED_CHECK} PL_CSR_ROUTED_F64 whole df product vs its plain chain",
             RC.routed_df_spmv(dchain, x64), RC.routed_df_spmv(dchain, x64, plain=True), errs,
             "routed_df")

    # -- phase 4: the CLI -------------------------------------------------
    cli_runs = (
        ("raefsky1_like", "AUTO", [], "PL_DIA_RESID", None),
        ("delaunay_n12_like", "AUTO", [], "PL_CSR_WINDOW", None),
        (ROUTED_CHECK, "AUTO", [], "PL_CSR_ROUTED", "#auto: format=routed -> PL_CSR_ROUTED"),
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
            write_mtx(mtx, synth.preset(name))
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
    for (name, mode), ops in prepared.items():
        csr = csrs[name]
        x = normal_x(csr.shape[1], dev, seed=4)
        spec = registry.get(mode)
        if mode.startswith("PL_CSR_WINDOW"):
            plain = lambda v, o=ops: WC.window_spmv_reference(o, v)
        elif mode.startswith("PL_DIA_RESID"):
            plain = lambda v, o=ops: SC.dia_spmv_reference(o[0].mat, v, o[1], o[0])
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
        print(f"  {name:20s} {mode:18s} kernel {tk * 1e3:9.4f} ms {2 * csr.nnz / tk / 1e9:8.2f} GFLOP/s "
              f"{gb / tk:8.1f} slab GB/s | plain {tp * 1e3:9.4f} ms | library (cuSPARSE CSR f32) "
              f"{libs[name] * 1e3:9.4f} ms | slab {gb * 1e3:.1f} MB")
    # the fringe kernel alone, and its library yardstick: cuSPARSE on the
    # fringe nnz only
    rcsr = csrs["raefsky1_like"]
    dr, plan = prepared[("raefsky1_like", "PL_DIA_RESID")]
    x = normal_x(rcsr.shape[1], dev, seed=5)
    y0 = torch.zeros(plan.s_pad * LANE, device=dev)
    t_rk = time_per_call(lambda v: SC.dia_resid_cuda(dr, v, y0, plan), x)
    t_rp = time_per_call(lambda v: SC.dia_resid_reference(dr, v, plan), x)
    fringe = ~split_offsets(rcsr)
    rows_f = rcsr.row_ids()[fringe]
    fcsr = P.CSRMatrix(
        shape=rcsr.shape,
        indptr=np.r_[0, np.cumsum(np.bincount(rows_f, minlength=rcsr.shape[0]))].astype(np.int64),
        indices=rcsr.indices[fringe], data=rcsr.data[fringe],
    )
    t_rl = time_per_call(library_spmv(fcsr, dev), x)
    print(f"  raefsky1_like fringe alone: kernel {t_rk * 1e3:.4f} ms | plain {t_rp * 1e3:.4f} ms "
          f"| library {t_rl * 1e3:.4f} ms ({dr.nnz_resid} fringe nnz in "
          f"{plan.nblocks}x{dr.k_pad}x{LANE} slots)")
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
        if isinstance(stage, RC.WStage):
            # the library yardstick of a W stage: one torch.take with the
            # stage's composed index (built from the plain version)
            h = stage.n_tiles * 128
            src = bufs[stage.src.kind][stage.src.off:].reshape(-1, 128)
            ids = torch.arange(src.shape[0] * 128, device=dev, dtype=torch.float32).reshape(-1, 128)
            idx = RC.w_stage_reference(ids, stage.src_rows, stage.r, stage.w, stage.ra, stage.t,
                                       stage.sw, stage.n_tiles).reshape(-1)[:stage.out_elems()].long()
            lib = time_per_call(lambda v, s=src, j=idx: torch.take(s, j), x) * 1e3
            per_kernel[stage.kernel][4] += lib
        acc = per_kernel[stage.kernel]
        acc[0] += ms
        acc[1] += pms
        acc[2] += b
        acc[3] += f
        print(f"  stage {i:2d} {ROUTED_KERNELS[stage.kernel][0]:26s} {type(stage).__name__:12s} "
              f"{ms * 1e3:8.2f} us in a graph | plain {pms:.4f} ms | {b / 1e6:7.3f} MB, bound "
              f"{least_ms(b, f)[0] * 1e3:6.2f} us"
              + (f" | torch.take {lib * 1e3:.2f} us" if lib is not None else ""))
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
    st = next(s for s in chain32.stages if isinstance(s, RC.ReduceStage) and s.mode == RC.MODE_W3)
    src = bufs[st.src.kind][st.src.off:].reshape(-1, 128)
    out14 = torch.empty(st.groups.shape[0] * 128, device=dev)
    t14 = graph_ms(lambda: RC.routed_perm_reduce_cuda(src, st.src_rows, RC.MODE_DIRECT, None, None,
                                                      st.r3, st.mask, st.groups, out14))
    t14p = time_per_call(lambda v: RC.perm_reduce_reference(src, st.src_rows, RC.MODE_DIRECT, None,
                                                             None, st.r3, st.mask, st.runs), x)
    h14 = st.r3.shape[0]
    b14 = least_ms(4 * 128 * min(st.src_rows, h14) + nbytes(st.r3, st.groups) + 4 * out14.numel(),
                   sum(ng * w for _r0, ng, w, _g0 in st.runs) * 128)
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

    # -- float64: the df kernels at the main path's shapes ------------------
    print(f"float64 (double-float) times on {smi} (f64 x in, f64 y out, through the "
          "wrapper; cuSPARSE CSR in float64 as the library):")
    df_times = {}

    def df_time(key, label, fn, plain, x64, lib, moved, slots):
        """Per call through the wrapper (as the f32 rows), and the same call
        in a CUDA graph (device time: the wrapper's split and combine
        kernels included, its host cost not)."""
        tk = time_per_call(fn, x64)
        tg = graph_ms(lambda: fn(x64))
        tp = time_per_call(plain, x64)
        tl = time_per_call(lib, x64) if lib is not None else None
        b_ms, by = least_ms(moved, DF_FLOPS_PER_SLOT * slots)
        df_times[key] = (tk * 1e3, tp * 1e3, b_ms, by, None if tl is None else tl * 1e3)
        print(f"  {label}: kernel {tk * 1e3:9.4f} ms per call ({tg:.4f} ms in a CUDA graph) | plain "
              f"{tp * 1e3:9.4f} ms | library {'-' if tl is None else f'{tl * 1e3:9.4f} ms'} | bound "
              f"{b_ms:.4f} ms ({by}, {moved / 1e6:.1f} MB); graphed kernel at "
              f"{100 * b_ms / tg:.1f} % of it")

    cm, cn = csrs["cube_coup_like"].shape
    cube_df, cube_plan = prepared_df["cube_coup_like"]
    x64 = normal_x64(cn, dev, seed=4)
    df_time("dia_df", "cube_coup_like PL_DIA_F64 dia_df_kernel",
            lambda v: SC.dia_spmv_df_cuda(cube_df, v, cube_plan),
            lambda v: SC.dia_spmv_df_reference(cube_df, v, cube_plan), x64,
            library_spmv(csrs["cube_coup_like"], dev, torch.float64),
            nbytes(cube_df.data, cube_df.data_lo, cube_df.offsets_dev) + 8 * (cn + cm),
            cube_df.data.numel())
    rdr, rplan = prepared_df["raefsky1_like"]
    x64 = normal_x64(rcsr.shape[1], dev, seed=5)
    rxh, rxl = DF.split_f64_t(x64)
    yh0 = torch.zeros(rplan.s_pad * LANE, device=dev)
    yl0 = torch.zeros_like(yh0)
    df_time("dia_resid_df", "raefsky1_like fringe alone dia_resid_df_kernel",
            lambda v: SC.dia_resid_df_cuda(rdr, rxh, rxl, yh0, yl0, rplan),
            lambda v: SC.dia_resid_df_reference(rdr, rxh, rxl, rplan), x64,
            library_spmv(fcsr, dev, torch.float64),
            nbytes(rdr.rvals, rdr.rvals_lo, rdr.rsidx, rdr.rgid, rdr.rsrc) + 8 * rcsr.shape[1]
            + 2 * 8 * yh0.numel(), rdr.rvals.numel())
    for name in ("thermal2_like", "delaunay_n12_like", "fem_3d_thermal2_like"):
        wm = prepared_df[name]
        wmm, wn = wm.shape
        x64 = normal_x64(wn, dev, seed=4)
        df_time(f"window_df {name}", f"{name} PL_CSR_WINDOW_F64 window_df_kernel"
                f"{' (xdirect)' if wm.xdirect else ''}",
                lambda v, o=wm: WC.window_spmv(o, v), lambda v, o=wm: WC.window_spmv_df_reference(o, v),
                x64, library_spmv(csrs[name], dev, torch.float64),
                slab_bytes(wm) + nbytes(wm.vals_lo) + 8 * (wn + wmm), wm.vals.numel())
    # K3 alone in a CUDA graph, then the whole df product, on caida_like
    x64 = normal_x64(csr.shape[1], dev, seed=4)
    xh, xl = DF.split_f64_t(x64)
    dm = mdf.mat
    t_k3 = dm.perm_products.t
    oh = torch.empty(t_k3 * 128 * 128, device=dev)
    ol = torch.empty_like(oh)
    k3_ms = graph_ms(lambda: RC.routed_df_gather_cuda(dm.vals, mdf.vals_lo, dm.pidx, dm.widx, t_k3,
                                                      xh, xl, oh, ol))
    k3_plain = time_per_call(lambda v: RC.routed_df_gather(mdf, xh, xl, plain=True), x64) * 1e3
    k3_bound = least_ms(nbytes(dm.vals, mdf.vals_lo, dm.pidx, dm.widx, oh, ol) + 8 * csr.shape[1],
                        DF_FLOPS_PER_SLOT * dm.vals.numel())
    df_times["routed_df_gather"] = (k3_ms, k3_plain, *k3_bound, None)
    print(f"  {ROUTED_CHECK} routed_df_gather_kernel alone: {k3_ms * 1e3:.2f} us in a graph | plain "
          f"{k3_plain:.4f} ms | bound {k3_bound[0] * 1e3:.2f} us ({k3_bound[1]})")
    t_dp = time_per_call(lambda v: RC.routed_df_spmv(dchain, v), x64)
    t_dg = graph_ms(lambda: RC.routed_df_spmv(dchain, x64), reps=5, replays=5) / 1e3
    t_dpp = time_per_call(lambda v: RC.routed_df_spmv(dchain, v, plain=True), x64)
    t_dl = time_per_call(library_spmv(csr, dev, torch.float64), x64)
    print(f"  {ROUTED_CHECK} PL_CSR_ROUTED_F64 whole df product: {t_dp * 1e3:.4f} ms per call "
          f"({t_dg * 1e3:.4f} ms in a CUDA graph) {2 * csr.nnz / t_dp / 1e9:.2f} GFLOP/s | plain "
          f"{t_dpp * 1e3:.4f} ms | library (cuSPARSE CSR f64) {t_dl * 1e3:.4f} ms")
    print(f"torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log("phase 5: done")

    # bounds: each input read once and each output written once, 2 flops
    # per stored slot, at the shapes the main path runs
    cube = prepared[("cube_coup_like", "PL_DIA_ROWS")][0]
    cube_m, cube_n = csrs["cube_coup_like"].shape
    b_rows = least_ms(nbytes(cube.data, cube.offsets_dev) + 4 * (cube_n + cube_m), 2 * cube.data.numel())
    b_resid = least_ms(
        nbytes(dr.rvals, dr.rsidx, dr.rgid, dr.rsrc) + 4 * rcsr.shape[1] + 2 * y0.numel() * 4,
        2 * dr.rvals.numel(),
    )

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
         "replaces": "spmv_openmp_cuda_tpu/ops/spmv_pallas.py:365",
         "launches": launches["dia_resid"], "max_abs_err": errs["dia_resid"],
         "ms": t_rk * 1e3, "plain_ms": t_rp * 1e3, "bound_ms": b_resid[0],
         "bound_by": b_resid[1], "library_ms": t_rl * 1e3},
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
        ms, pms, b, f, lib = per_kernel[kernel]
        b_ms, by = least_ms(b, f)
        kernels.append(
            {"name": kname, "route": "cuda", "source": ROUTED_SOURCE, "replaces": replaces,
             "launches": launches[kernel], "max_abs_err": errs[kernel], "ms": ms, "plain_ms": pms,
             "bound_ms": b_ms, "bound_by": by, "library_ms": lib if kernel == "w_stage" else None})
    for key, kname, replaces in (
        ("dia_df", "dia_df_kernel", "spmv_openmp_cuda_tpu/ops/spmv_pallas.py:628"),
        ("dia_resid_df", "dia_resid_df_kernel", "spmv_openmp_cuda_tpu/ops/spmv_pallas.py:546"),
        ("window_df thermal2_like", "window_df_kernel", "spmv_openmp_cuda_tpu/formats/window.py:1062"),
        ("routed_df_gather", "routed_df_gather_kernel", "spmv_openmp_cuda_tpu/formats/routed.py:1882"),
    ):
        ms, pms, b_ms, by, lib = df_times[key]
        counter = key.split()[0]
        kernels.append(
            {"name": kname, "route": "cuda", "source": DF_SOURCE, "replaces": replaces,
             "launches": launches64[counter], "max_abs_err": errs[counter], "ms": ms,
             "plain_ms": pms, "bound_ms": b_ms, "bound_by": by, "library_ms": lib})
    kernels.extend(csr_ell_slice(dev, smi, csrs))
    log("done")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
