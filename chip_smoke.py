#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the root of the repository: python3 chip_smoke.py

It builds the CUDA kernels from spmv_openmp_cuda_tpu_torch/csrc/ (one nvcc
per source, all at once), holds each kernel against its plain PyTorch
version at the main path's shapes, drives the main path (AutoSpMV.from_csr
-> model(x)) on three DIA-class, three window-class and two routed proxies
at their published size with the launch counters reset just before, checks
the results against the f64 oracle (for the routed engine, the oracle of the
matrix as its layout stores it: heavy rows in bf16), runs the CLI, and times
kernel, plain version and one PyTorch library call (cuSPARSE through
torch.sparse, a yardstick the port never calls) with CUDA events; the routed
kernels alone are timed inside CUDA graphs, so that the host's launch cost
does not hide their device time. Any failure raises and exits non-zero;
without a CUDA device it exits 1 before printing any result.
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


def normal_x(n: int, device, seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(n)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


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


def library_spmv(csr, device):
    """cuSPARSE y = A @ x through torch.sparse on the same matrix (int32
    indices), the yardstick; the port never calls it."""
    crow = torch.as_tensor(csr.indptr.astype(np.int32), device=device)
    col = torch.as_tensor(csr.indices.astype(np.int32), device=device)
    val = torch.as_tensor(csr.data, dtype=torch.float32, device=device)
    a = torch.sparse_csr_tensor(crow, col, val, size=csr.shape)
    return lambda v: a @ v


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
        built = list(pool.map(cuda_lib.build, ("dia_spmv", "window_spmv", "routed_spmv")))
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

    for name, modes in WINDOW_CHECKS.items():
        csr = csrs[name]
        x = normal_x(csr.shape[1], dev, seed=1)
        t = time.perf_counter()
        mat = registry.get("PL_CSR_WINDOW").prepare(csr, None, P.Config(), dev)
        prep_s = time.perf_counter() - t
        log(f"phase 2: {name} window layout g={mat.g} k_pad={mat.k_pad} k_c={mat.k_c} "
            f"wr={mat.wr} bps={mat.bps} nblocks={mat.nblocks} xdirect={mat.xdirect} "
            f"shared_w={mat.shared_w}, {mat.nblocks * mat.k_pad * LANE} slots, prepare {prep_s:.1f}s")
        for mode in modes:
            # prepare_window_auto uses vals_dtype only in its final cast, so
            # the bf16 operands are the f32 layout with vals cast
            ops = mat if mode == "PL_CSR_WINDOW" else dataclasses.replace(
                mat, vals=mat.vals.to(torch.bfloat16))
            prepared[(name, mode)] = ops
            check_window(f"{name} {mode}", ops, x)
    # the third x form: a small layout forced to shared_w
    small = P.coo_to_csr(synth.fem_like(m=6000, n=6000, nnz=60000, spread=700, lo=4, hi=16, seed=7))
    for vals_dtype in (torch.float32, torch.bfloat16):
        mat = W.prepare_window(small, g=8, bps=4, shared_w=True, vals_dtype=vals_dtype, device=dev)
        assert mat.shared_w
        check_window(f"fem_like 6000 shared_w {vals_dtype}", mat, normal_x(6000, dev, seed=1))

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

    # -- phase 4: the CLI -------------------------------------------------
    for name, mode in (("raefsky1_like", "PL_DIA_RESID"), ("delaunay_n12_like", "PL_CSR_WINDOW"),
                       (ROUTED_CHECK, "PL_CSR_ROUTED")):
        with tempfile.TemporaryDirectory() as tmp:
            mtx = os.path.join(tmp, f"{name}.mtx")
            write_mtx(mtx, synth.preset(name))
            proc = subprocess.run(
                [sys.executable, "-m", "spmv_openmp_cuda_tpu_torch", mtx, "RNDVECT", "AUTO",
                 "--check", "--no-dump"],
                capture_output=True, text=True, timeout=600,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            )
        print(proc.stdout.rstrip())
        if proc.returncode != 0 or "#check: OK" not in proc.stdout or \
                f"computeMode:{mode} " not in proc.stdout or \
                (mode == "PL_CSR_ROUTED" and "#auto: format=routed -> PL_CSR_ROUTED" not in proc.stdout):
            raise AssertionError(f"CLI run on {name} failed (exit {proc.returncode}): {proc.stderr}")
        log(f"phase 4: CLI AUTO --check OK on {name} ({mode})")

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
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
