"""CLI driver.

Counterpart of spmv_openmp_cuda_tpu/cli.py (reference: src/main.cu:66-283):
  usage: python -m spmv_openmp_cuda_tpu_torch <matrix.mtx[.gz|.xz|.bz2|.zip]>
         <vectorFile | RNDVECT> [COMPUTE_MODE|AUTO] [--check] [--no-dump]
         [--list-modes] [--device cuda|cpu] [--dtype float32|float64]
         [--env] [--profile DIR] [--testtests] [--save-prepared PATH]
         [--load-prepared PATH]
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
`--save-prepared PATH` writes the prepared format after the prepare, and
`--load-prepared PATH` takes one in its place (formats/serialize.py: the
JAX package's .npz layout, so either package's files load), as in the JAX
package's CLI.
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
    p.add_argument(
        "--save-prepared",
        metavar="PATH",
        help="serialize the prepared device format to PATH (.npz) after the "
        "prepare (checkpoint: skips re-preparation next time)",
    )
    p.add_argument(
        "--load-prepared",
        metavar="PATH",
        help="load a previously saved prepared format instead of preparing "
        "(the matrix file is still read for shape/oracle checks)",
    )
    return p


def _adapt_loaded(operands, spec):
    """Validate/adapt a loaded prepared format for the selected mode, as the
    JAX package's CLI does.

    Returns (operands, error). A DeviceDIA[DF] saved without its plan loads
    under the PL_DIA_* modes by deriving the plan, and a (DeviceDIA, plan)
    pair unwraps for DIA_ROWS; any other kind/mode mismatch is a friendly
    error instead of a failure inside the product.
    """
    from .formats.binned import BinnedCSR
    from .formats.dia import DeviceDIA, DeviceDIADF
    from .formats.lanes import LanesSmall
    from .formats.matrix import DeviceCSR, DeviceELL
    from .formats.window import WindowCSR
    from .ops.routed_cuda import RoutedChain, RoutedDFChain
    from .ops.spmv_cuda import (
        DF_DIA_VMEM_BUDGET, pad_dia_df_for_pallas, pad_dia_for_pallas, plan_dia,
    )

    pair = isinstance(operands, tuple) and len(operands) == 2
    is_dia_pair = pair and isinstance(operands[0], DeviceDIA)
    is_diadf_pair = pair and isinstance(operands[0], DeviceDIADF)
    if spec.name in ("PL_DIA_ROWS", "PL_DIA_BF16"):
        if is_dia_pair:
            return operands, None
        if isinstance(operands, DeviceDIA):
            plan = plan_dia(operands)
            return (pad_dia_for_pallas(operands, plan), plan), None
    if spec.name == "PL_DIA_F64":
        if is_diadf_pair:
            return operands, None
        if isinstance(operands, DeviceDIADF):
            plan = plan_dia(operands.as_dia(), vmem_budget=DF_DIA_VMEM_BUDGET)
            return (pad_dia_df_for_pallas(operands, plan), plan), None
    if spec.name == "PL_CSR_WINDOW_F64":
        if isinstance(operands, WindowCSR) and operands.vals_lo is not None:
            return operands, None
        return None, (
            "mode PL_CSR_WINDOW_F64 needs a double-float WindowCSR "
            "checkpoint (vals_lo present)"
        )
    expected = {
        "DIA_ROWS": DeviceDIA,
        "CSR_ROWS": DeviceCSR,
        "CSR_ROWS_BINNED": BinnedCSR,
        "PL_CSR_ROUTED": RoutedChain,
        "PL_CSR_ROUTED_BF16": RoutedChain,
        "PL_CSR_ROUTED_F64": RoutedDFChain,
        "PL_CSR_WINDOW": WindowCSR,
        "PL_CSR_WINDOW_BF16": WindowCSR,
        "PL_CSR_LANES": LanesSmall,
        "ELL_ROWS": DeviceELL,
        "ELL_ROWS_NOSIMD": DeviceELL,
        "ELL_ROWS_NORL": DeviceELL,
        "ELL_ROWS_T": DeviceELL,
        "PL_ELL_ROWS_T": DeviceELL,
    }.get(spec.name)
    if expected is None:
        return None, f"mode {spec.name} cannot run from a serialized prepared format"
    if spec.name == "DIA_ROWS" and is_dia_pair:
        return operands[0], None
    if not isinstance(operands, expected):
        kind = type(operands[0] if pair else operands).__name__
        return None, f"loaded prepared format {kind} does not match mode {spec.name}"
    if isinstance(operands, WindowCSR) and operands.vals_lo is not None:
        return None, (
            f"loaded double-float WindowCSR needs mode PL_CSR_WINDOW_F64, not {spec.name}"
        )
    if isinstance(operands, DeviceELL):
        want_t = spec.name in ("ELL_ROWS_T", "PL_ELL_ROWS_T")
        if operands.transposed != want_t:
            return None, (
                f"loaded DeviceELL transposed={operands.transposed} does not match "
                f"mode {spec.name}"
            )
    return operands, None


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
    if args.load_prepared:
        from .formats.serialize import load_prepared

        operands, err = _adapt_loaded(load_prepared(args.load_prepared, device=device), spec)
        if err:
            print(f"ERROR: {err}", file=sys.stderr)
            return 1
    else:
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
    if args.save_prepared:
        from .formats.serialize import save_prepared

        try:
            save_prepared(args.save_prepared, operands)
            print(f"#prepared saved: {args.save_prepared}")
        except TypeError:
            print(f"#prepared not serializable for mode {spec.name}", file=sys.stderr)
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
