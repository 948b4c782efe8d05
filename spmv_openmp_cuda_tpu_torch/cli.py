"""CLI driver.

Counterpart of spmv_openmp_cuda_tpu/cli.py (reference: src/main.cu:66-283):
  usage: python -m spmv_openmp_cuda_tpu_torch <matrix.mtx[.gz|.xz|.bz2|.zip]>
         <vectorFile | RNDVECT> [COMPUTE_MODE|AUTO] [--check] [--no-dump]
         [--list-modes] [--device cuda|cpu] [--dtype float32|float64]
         [--env] [--profile DIR] [--testtests]
parses the matrix into the mode's format (CSR, or ELL for the ELL modes,
with the ELL_MAX_ENTRIES cap), loads or generates the dense vector, runs the
selected mode (CSR_ROWS by default, as in the JAX package), dumps the output
vector (raw + text) under TMPDIR, and prints the same `#auto:`, `#matrix:`,
`#check:` and `computeMode:... elapsed:... elapsedInternal:... GFLOPS:...`
lines as the JAX package, so one log reducer reads both.

The device defaults to cuda; without a CUDA device that default is an error,
never a silent run on the CPU (`--device cpu` runs the kernels' plain
PyTorch versions). `--dtype float64` (or SPMV_DTYPE=float64) runs the
double-precision modes: AUTO maps every engine to its double-float mode
(`*_F64`), and an explicit f32 CUDA mode is remapped as in the JAX package:
PL_DIA_ROWS and PL_DIA_BF16 to PL_DIA_F64, PL_ELL_ROWS_T to ELL_ROWS_T, every
other one to CSR_ROWS_BINNED (native f64 torch ops). `--env` prints the
runtime, `--profile DIR` writes a torch.profiler trace of the timed calls,
`--testtests` diffs the serial oracle against the dense one and exits.
`--save-prepared`/`--load-prepared` are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import List, Optional

import torch

from .config import Config
from .formats.convert import EllSizeError, coo_to_csr, coo_to_ell
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
from .utils.profiling import profiler_trace, time_per_call

#: AUTO's engine -> compute mode (float32, float64), as in the JAX
#: package's CLI.
_AUTO_MODES = {
    "dia": ("PL_DIA_ROWS", "PL_DIA_F64"),
    "dia_resid": ("PL_DIA_RESID", "PL_DIA_RESID_F64"),
    "window": ("PL_CSR_WINDOW", "PL_CSR_WINDOW_F64"),
    "routed": ("PL_CSR_ROUTED", "PL_CSR_ROUTED_F64"),
}

#: float64 under an explicit f32 CUDA mode, as the JAX package's CLI remaps
#: its Pallas modes: these to their double-precision twins, every other one
#: to CSR_ROWS_BINNED (native f64 torch ops)
_F64_REMAP = {
    "PL_DIA_ROWS": "PL_DIA_F64",
    "PL_DIA_BF16": "PL_DIA_F64",
    "PL_ELL_ROWS_T": "ELL_ROWS_T",
}
_F64_FALLBACK = "CSR_ROWS_BINNED"


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
        default="CSR_ROWS",
        help=f"AUTO (structure-driven selection) or one of (default CSR_ROWS): "
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
    p.add_argument("--env", action="store_true",
                   help="print the runtime (torch, CUDA devices, env overrides) and exit")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the timed calls to DIR/trace.json")
    p.add_argument("--testtests", action="store_true",
                   help="TESTTESTS mode (reference SpMV_test.cu:227-236): diff the serial "
                   "oracle against the dense-GEMV oracle on this matrix and exit")
    # flags of the JAX package's CLI that are not ported yet: accepted so
    # that they fail with a clear message instead of a usage error
    p.add_argument("--save-prepared", metavar="PATH", help="not ported yet")
    p.add_argument("--load-prepared", metavar="PATH", help="not ported yet")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    if args.list_modes:
        for s in registry.all_kernels():
            print(f"{s.name:24s} [{s.impl}/{s.fmt}] {s.doc}")
        return 0
    if args.env:
        from .utils.envinfo import format_info

        print(format_info())
        return 0
    unported = [
        flag
        for flag, used in (
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
    spec = registry.get(mode)
    if f64 and spec.impl == "cuda" and not spec.f64:
        # the CUDA kernels of these modes are f32: remap to a double-precision
        # mode, as the JAX package's CLI does (AUTO maps f64 the same way)
        mode = _F64_REMAP.get(mode, _F64_FALLBACK)
        print(f"#dtype: float64 unsupported by CUDA mode {spec.name}; remapping to {mode}")
        spec = registry.get(mode)
    ell = None
    if spec.fmt == "ell":
        try:
            ell = coo_to_ell(coo, max_entries=cfg.ell_max_entries)
        except EllSizeError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
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

    if args.testtests:
        # TESTTESTS: validate the serial oracle against the dense-GEMV
        # oracle and exit (reference SpMV_test.cu:227-236)
        from .ops.oracle import oracle_vs_oracle

        rep = oracle_vs_oracle(csr, x)
        print(f"#testtests: {'OK' if rep.ok else 'FAIL'} maxAbsDiff={rep.max_abs_diff:.3e}")
        return 0 if rep.ok else 2

    t0 = time.perf_counter()
    try:
        operands = spec.prepare(csr, ell, cfg, device)
    except (DiaFillError, WindowError) as e:
        if not is_auto:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
        # the structural guess tripped the exact prepare-time cap: fall
        # through to the general engine, as the JAX package's AUTO does
        # (CSR_ROWS_BINNED at float64)
        mode = _F64_FALLBACK if f64 else _AUTO_MODES["routed"][0]
        print(f"#auto: {spec.name} infeasible ({e}); falling back to {mode}")
        spec = registry.get(mode)
        operands = spec.prepare(csr, ell, cfg, device)
    f = spec.jitted(operands)
    # the df modes take x in f64 whatever the configured dtype
    xd = torch.as_tensor(x, dtype=torch.float64 if spec.f64 else cfg.torch_dtype, device=device)
    y = f(xd)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0  # prepare + upload + first call
    with profiler_trace(args.profile):
        elapsed_internal = time_per_call(f, xd)
    if args.profile:
        print(f"#profile: torch.profiler trace written to {os.path.join(args.profile, 'trace.json')}")
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
