#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the root of the repository: python3 chip_smoke.py

It builds the DIA kernels from spmv_openmp_cuda_tpu_torch/csrc/, holds each
kernel against its plain PyTorch version at the main path's shapes, drives
the main path (AutoSpMV.from_csr -> model(x)) on three DIA-class proxies
with the launch counters reset just before, checks the results against the
f64 oracle, runs the CLI once, and times kernel and plain version with CUDA
events. Any failure raises and exits non-zero; without a CUDA device it
exits 1 before printing any result. The last line is one JSON object
{"ok": true, "device": {...}}, the line before it a JSON object with one
entry per kernel.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T0 = time.perf_counter()
MODES = ("PL_DIA_ROWS", "PL_DIA_BF16", "PL_DIA_RESID", "PL_DIA_RESID_BF16")
#: mode -> proxies it is checked and timed on (the main path's shapes:
#: cube_coup_like runs PL_DIA_ROWS, raefsky1_like PL_DIA_RESID)
CHECKS = {
    "cube_coup_like": ("PL_DIA_ROWS", "PL_DIA_BF16"),
    "raefsky1_like": MODES,
    "cavity10_like": ("PL_DIA_ROWS",),
}
#: AutoSpMV's engine for each proxy
EXPECTED_FORMAT = {"cube_coup_like": "dia", "raefsky1_like": "dia_resid", "cavity10_like": "dia"}
SOURCE = "spmv_openmp_cuda_tpu_torch/csrc/dia_spmv.cu"


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def bound(y_ref: torch.Tensor) -> float:
    """f32 sums of <= D + k_pad (~140) terms in another order:
    1e-5 * max|y_ref| + 1e-6."""
    return 1e-5 * y_ref.abs().max().item() + 1e-6


def normal_x(n: int, device, seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(n)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def slab_bytes(ops) -> int:
    from spmv_openmp_cuda_tpu_torch.ops.spmv_cuda import DiaResid

    first = ops[0]
    if isinstance(first, DiaResid):
        ts = [first.mat.data, first.rvals, first.rsidx, first.rgid, first.rsrc]
    else:
        ts = [first.data]
    return sum(t.numel() * t.element_size() for t in ts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import spmv_openmp_cuda_tpu_torch as P
    from spmv_openmp_cuda_tpu_torch.cli import time_per_call
    from spmv_openmp_cuda_tpu_torch.config import LANE
    from spmv_openmp_cuda_tpu_torch.io.mmio import write_mtx
    from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
    from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV
    from spmv_openmp_cuda_tpu_torch.ops import cuda_lib, registry
    from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda as SC
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

    # -- phase 1: build --------------------------------------------------
    t = time.perf_counter()
    path, nvcc_log = cuda_lib.build("dia_spmv")
    log(f"phase 1: built {os.path.relpath(path)} in {time.perf_counter() - t:.1f}s")
    for line in nvcc_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # -- host set-up: the proxies at their published size ------------------
    csrs = {}
    for name in CHECKS:
        t = time.perf_counter()
        csrs[name] = P.coo_to_csr(synth.preset(name))
        m, n = csrs[name].shape
        log(f"set-up: {name} {m}x{n}, {csrs[name].nnz} nnz, generated in {time.perf_counter() - t:.1f}s")

    # -- phase 2: each kernel against its plain version ---------------------
    errs = {"dia_spmv": 0.0, "dia_resid": 0.0}
    prepared = {}
    for name, modes in CHECKS.items():
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

    # -- phase 3: the main path, counters from zero ------------------------
    SC.dia_spmv_cuda.launches = 0
    SC.dia_resid_cuda.launches = 0
    outputs = {}
    for name, csr in csrs.items():
        t = time.perf_counter()
        model = AutoSpMV.from_csr(csr, device="cuda")
        prep_s = time.perf_counter() - t
        x_ref = fill_rnd_vector(csr.shape[1], seed=2)
        x_n = np.random.default_rng(3).standard_normal(csr.shape[1])
        outputs[name] = (model.format, model(x_ref), model(x_n), x_ref, x_n, prep_s)
    torch.cuda.synchronize()
    launches = {"dia_spmv": SC.dia_spmv_cuda.launches, "dia_resid": SC.dia_resid_cuda.launches}
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
        rep = vectors_diff(y_ref.double().cpu().numpy(), serial_csr_spmv(csr, x_ref))
        o = serial_csr_spmv(csr, x_n)
        rel = np.abs(y_n.double().cpu().numpy() - o).max()
        lim = 1e-5 * np.abs(o).max() + 1e-6
        log(f"phase 3: {name} -> {fmt}, prepare+upload {prep_s:.1f}s; reference protocol: "
            f"{'OK' if rep.ok else 'FAIL'} maxAbsDiff={rep.max_abs_diff:.3e}; "
            f"x~N(0,1) vs f64 oracle: {rel:.3e} <= {lim:.3e}")
        if not rep.ok or not rel <= lim:
            raise AssertionError(f"{name}: wrong output")
    if launches["dia_spmv"] == 0 or launches["dia_resid"] == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # -- phase 4: the CLI -------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        mtx = os.path.join(tmp, "raefsky1_like.mtx")
        write_mtx(mtx, synth.preset("raefsky1_like"))
        proc = subprocess.run(
            [sys.executable, "-m", "spmv_openmp_cuda_tpu_torch", mtx, "RNDVECT", "AUTO",
             "--check", "--no-dump"],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    print(proc.stdout.rstrip())
    if proc.returncode != 0 or "#check: OK" not in proc.stdout or \
            "computeMode:PL_DIA_RESID " not in proc.stdout:
        raise AssertionError(f"CLI run failed (exit {proc.returncode}): {proc.stderr}")
    log("phase 4: CLI AUTO --check OK")

    # -- phase 5: times ----------------------------------------------------
    print(f"times on {smi} (CUDA events, x on the device, after warm-up; "
          "per call, back to back):")
    times = {}
    for (name, mode), ops in prepared.items():
        csr = csrs[name]
        x = normal_x(csr.shape[1], dev, seed=4)
        spec = registry.get(mode)
        if mode.startswith("PL_DIA_RESID"):
            plain = lambda v, o=ops: SC.dia_spmv_reference(o[0].mat, v, o[1], o[0])
        else:
            plain = lambda v, o=ops: SC.dia_spmv_reference(o[0], v, o[1])
        tk = time_per_call(spec.jitted(ops), x)
        tp = time_per_call(plain, x)
        times[(name, mode)] = (tk, tp)
        gb = slab_bytes(ops) / 1e9
        print(f"  {name:15s} {mode:18s} kernel {tk * 1e3:9.4f} ms {2 * csr.nnz / tk / 1e9:8.2f} GFLOP/s "
              f"{gb / tk:8.1f} slab GB/s | plain {tp * 1e3:9.4f} ms {2 * csr.nnz / tp / 1e9:8.2f} GFLOP/s "
              f"| slab {gb * 1e3:.1f} MB")
    dr, plan = prepared[("raefsky1_like", "PL_DIA_RESID")]
    x = normal_x(csrs["raefsky1_like"].shape[1], dev, seed=5)
    y0 = torch.zeros(plan.s_pad * LANE, device=dev)
    t_rk = time_per_call(lambda v: SC.dia_resid_cuda(dr, v, y0, plan), x)
    t_rp = time_per_call(lambda v: SC.dia_resid_reference(dr, v, plan), x)
    print(f"  raefsky1_like fringe alone: kernel {t_rk * 1e3:.4f} ms | plain {t_rp * 1e3:.4f} ms "
          f"({dr.nnz_resid} fringe nnz in {plan.nblocks}x{dr.k_pad}x{LANE} slots)")
    print(f"torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log("phase 5: done")

    t_dk, t_dp = times[("cube_coup_like", "PL_DIA_ROWS")]
    kernels = [
        {"name": "dia_rows_kernel", "route": "cuda", "source": SOURCE,
         "replaces": "spmv_openmp_cuda_tpu/ops/spmv_pallas.py:426",
         "launches": launches["dia_spmv"], "max_abs_err": errs["dia_spmv"],
         "ms": t_dk * 1e3, "plain_ms": t_dp * 1e3},
        {"name": "dia_resid_kernel", "route": "cuda", "source": SOURCE,
         "replaces": "spmv_openmp_cuda_tpu/ops/spmv_pallas.py:365",
         "launches": launches["dia_resid"], "max_abs_err": errs["dia_resid"],
         "ms": t_rk * 1e3, "plain_ms": t_rp * 1e3},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
