"""CLI driver.

Counterpart of spmv_openmp_cuda_tpu/cli.py (reference: src/main.cu:66-283):
  usage: python -m spmv_openmp_cuda_tpu_torch <matrix.mtx[.gz|.xz|.bz2|.zip]>
         <vectorFile | RNDVECT> [AUTO|COMPUTE_MODE] [--check] [--no-dump]
         [--list-modes] [--device cuda|cpu] [--dtype float32|float64]
parses the matrix, loads or generates the dense vector, runs the selected
mode, dumps the output vector (raw + text) under TMPDIR, and prints the same
`#auto:`, `#matrix:`, `#check:` and `computeMode:... elapsed:...
elapsedInternal:... GFLOPS:...` lines as the JAX package, so one log reducer
reads both.

The device defaults to cuda; without a CUDA device that default is an error,
never a silent run on the CPU (`--device cpu` runs the kernels' plain
PyTorch versions). `--dtype float64` (or SPMV_DTYPE=float64) runs the
double-float modes (`*_F64`): AUTO maps every engine to its df mode, and an
explicit f32 CUDA mode is remapped as in the JAX package (PL_DIA_ROWS and
PL_DIA_BF16 to PL_DIA_F64) or refused where the JAX package's substitute is
not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Callable, List, Optional

import torch

from .config import Config
from .formats.convert import coo_to_csr
from .formats.dia import DiaFillError
from .formats.window import WindowError
from .io.mmio import read_coo
from .io.vectors import (
    fill_rnd_vector,
    read_vector,
    write_vector_raw,
    write_vector_str,
)
from .ops import registry

#: AUTO's engine -> compute mode (float32, float64), as in the JAX
#: package's CLI.
_AUTO_MODES = {
    "dia": ("PL_DIA_ROWS", "PL_DIA_F64"),
    "dia_resid": ("PL_DIA_RESID", "PL_DIA_RESID_F64"),
    "window": ("PL_CSR_WINDOW", "PL_CSR_WINDOW_F64"),
    "routed": ("PL_CSR_ROUTED", "PL_CSR_ROUTED_F64"),
}

#: float64 under an explicit f32 CUDA mode: the JAX package's CLI remaps
#: these to PL_DIA_F64 and every other one of the port's f32 CUDA modes to
#: CSR_ROWS_BINNED, which the port lacks
_F64_REMAP = {"PL_DIA_ROWS": "PL_DIA_F64", "PL_DIA_BF16": "PL_DIA_F64"}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spmv_openmp_cuda_tpu_torch",
        description="PyTorch/CUDA SpMV (y = A @ x) on MatrixMarket matrices",
    )
    p.add_argument("matrix", nargs="?", help=".mtx file, optionally gz/xz/bz2/zip compressed")
    p.add_argument(
        "vector",
        nargs="?",
        help="dense-vector file (text or raw float64) or the literal RNDVECT",
    )
    p.add_argument(
        "compute_mode",
        nargs="?",
        default="AUTO",
        help=f"AUTO (structure-driven selection, the default) or one of: "
        f"{', '.join(registry.names())}",
    )
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where to run: cuda launches the CUDA kernels; cpu runs their "
        "plain PyTorch versions",
    )
    p.add_argument("--list-modes", action="store_true", help="list kernels and exit")
    p.add_argument("--no-dump", action="store_true", help="skip output vector dumps")
    p.add_argument("--check", action="store_true", help="verify against serial oracle")
    p.add_argument("--dtype", choices=["float32", "float64"], default=None,
                   help="compute dtype (default: SPMV_DTYPE, else float32); "
                   "float64 runs the double-float modes")
    # flags of the JAX package's CLI that are not ported yet: accepted so
    # that they fail with a clear message instead of a usage error
    p.add_argument("--env", action="store_true", help="not ported yet")
    p.add_argument("--profile", metavar="DIR", default=None, help="not ported yet")
    p.add_argument("--testtests", action="store_true", help="not ported yet")
    p.add_argument("--save-prepared", metavar="PATH", help="not ported yet")
    p.add_argument("--load-prepared", metavar="PATH", help="not ported yet")
    return p


def time_per_call(f: Callable, x: torch.Tensor, min_seconds: float = 0.2) -> float:
    """Seconds per call of f(x) over a back-to-back run after warm-up: CUDA
    events on a GPU, the host clock on the CPU."""
    cuda = x.device.type == "cuda"

    def run(reps: int) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                f(x)
            stop.record()
            torch.cuda.synchronize(x.device)
            return start.elapsed_time(stop) / 1e3
        t0 = time.perf_counter()
        for _ in range(reps):
            f(x)
        return time.perf_counter() - t0

    run(3)  # warm-up
    probe = max(run(10) / 10, 1e-7)
    reps = int(min(max(min_seconds / probe, 10), 10_000))
    return run(reps) / reps


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    if args.list_modes:
        for s in registry.all_kernels():
            print(f"{s.name:24s} [{s.impl}/{s.fmt}] {s.doc}")
        return 0
    unported = [
        flag
        for flag, used in (
            ("--env", args.env),
            ("--profile", args.profile),
            ("--testtests", args.testtests),
            ("--save-prepared", args.save_prepared),
            ("--load-prepared", args.load_prepared),
        )
        if used
    ]
    if unported:
        print(
            f"ERROR: {', '.join(unported)}: not ported yet to the "
            "PyTorch/CUDA package (use spmv_openmp_cuda_tpu)",
            file=sys.stderr,
        )
        return 1
    if not args.matrix or not args.vector:
        build_argparser().error("the following arguments are required: matrix, vector")

    cfg = Config.from_env()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if cfg.dtype not in ("float32", "float64"):
        print(f"ERROR: dtype {cfg.dtype}: the port runs float32 and float64", file=sys.stderr)
        return 1
    f64 = cfg.dtype == "float64"
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(
            "ERROR: --device cuda (the default) but no CUDA device is "
            "available; pass --device cpu to run the plain PyTorch versions",
            file=sys.stderr,
        )
        return 1

    mode = args.compute_mode
    is_auto = mode.upper() == "AUTO"
    if not is_auto:
        # fail fast on a typo'd mode BEFORE paying the matrix parse
        try:
            registry.get(mode)
        except KeyError as e:
            print(f"ERROR: {e.args[0]}", file=sys.stderr)
            return 1

    t0 = time.perf_counter()
    coo = read_coo(args.matrix)
    csr = coo_to_csr(coo)
    if is_auto:
        from .models.auto import select_format

        fmt = select_format(csr)
        mode = _AUTO_MODES[fmt][f64]
        print(f"#auto: format={fmt} -> {mode}")
    spec = registry.get(mode)  # every ported mode takes CSR (no ELL yet)
    if f64 and spec.impl == "cuda" and not spec.f64:
        if mode not in _F64_REMAP:
            print(
                f"ERROR: float64 under {mode}: the JAX package runs CSR_ROWS_BINNED there, "
                "which is not ported to PyTorch/CUDA yet (ROADMAP.md queue 1 item 8)",
                file=sys.stderr,
            )
            return 1
        print(f"#dtype: float64 unsupported by CUDA mode {mode}; remapping to {_F64_REMAP[mode]}")
        mode = _F64_REMAP[mode]
        spec = registry.get(mode)
    parse_time = time.perf_counter() - t0
    m, n = csr.shape
    print(f"#matrix: {os.path.basename(args.matrix)} {m} {n} {csr.nnz} {csr.max_row_nz} (parse {parse_time:.3f}s)")

    if args.vector == "RNDVECT":
        x = fill_rnd_vector(n, seed=cfg.seed or None)
        if not args.no_dump:
            write_vector_raw(os.path.join(cfg.tmpdir, "rndVectorDumpRaw"), x)
            write_vector_str(os.path.join(cfg.tmpdir, "rndVectorDump"), x)
    else:
        x = read_vector(args.vector)
        if x.shape[0] != n:
            print(
                f"ERROR: vector size {x.shape[0]} != matrix cols {n}", file=sys.stderr
            )
            return 1

    t0 = time.perf_counter()
    try:
        operands = spec.prepare(csr, None, cfg, device)
    except (DiaFillError, WindowError) as e:
        if not is_auto:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
        # the structural guess tripped the exact prepare-time cap: fall
        # through to the general engine, as the JAX package's AUTO does
        mode = _AUTO_MODES["routed"][f64]
        print(f"#auto: {spec.name} infeasible ({e}); falling back to {mode}")
        spec = registry.get(mode)
        operands = spec.prepare(csr, None, cfg, device)
    f = spec.jitted(operands)
    # the df modes take x in f64 whatever the configured dtype
    xd = torch.as_tensor(x, dtype=torch.float64 if spec.f64 else cfg.torch_dtype, device=device)
    y = f(xd)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0  # prepare + upload + first call
    elapsed_internal = time_per_call(f, xd)
    y_host = y.double().cpu().numpy()[:m]

    if args.check:
        from .ops.oracle import serial_csr_spmv
        from .utils.compare import vectors_diff

        rep = vectors_diff(y_host, serial_csr_spmv(csr, x))
        status = "OK" if rep.ok else "FAIL"
        print(f"#check: {status} maxAbsDiff={rep.max_abs_diff:.3e}")
        if not rep.ok:
            return 2

    if not args.no_dump:
        write_vector_raw(os.path.join(cfg.tmpdir, "outVectorDumpRaw"), y_host)
        write_vector_str(os.path.join(cfg.tmpdir, "outVectorDump"), y_host)

    print(
        f"computeMode:{spec.name} elapsed:{elapsed:.9f} "
        f"elapsedInternal:{elapsed_internal:.9f} "
        f"GFLOPS:{2.0 * csr.nnz / elapsed_internal / 1e9:.4f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
