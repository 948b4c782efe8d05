"""One run of one benchmark cell on the card.

    python3 -m spmv_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the matrix and vectors from the seed, the program's prepare, a
warm-up of every shape the traffic uses), a window of `--seconds` of the
cell's traffic, with --trace 1 a bounded profiled span after it, then the
check of the window's answers against the float64 reference once the
program's state is freed. Environment lines and the numbers compared (each
beside its limit, last) go to standard error; the result is the last line
of standard output, one JSON object. Without enough CUDA cards, or with the
JAX package loaded, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the run's set-up is timed from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional, Tuple  # noqa: E402

import torch  # noqa: E402

from . import drive, envlines, inputs, spec, trace  # noqa: E402
from .reference import LOWER, ControlSystem  # noqa: E402

#: top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "spmv_openmp_cuda_tpu")


class Program:
    """The system under test: AutoSpMV.from_csr over the configuration's
    matrix, and the port's CG over it."""

    def __init__(self, config: dict, matrix: inputs.Matrix, device):
        from spmv_openmp_cuda_tpu_torch.config import Config
        from spmv_openmp_cuda_tpu_torch.formats.matrix import CSRMatrix
        from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV

        csr = CSRMatrix(
            shape=matrix.shape,
            indptr=matrix.indptr.copy(),
            indices=matrix.cols.copy(),
            data=matrix.data.copy(),
        )
        model = AutoSpMV.from_csr(csr, cfg=Config(dtype=config["dtype"]), format=config["format"], device=device)
        self.product = model
        self.format = model.format

    def solve(self, b, rtol: float, maxiter: int):
        from spmv_openmp_cuda_tpu_torch.models import solvers

        res = solvers.conjugate_gradient(self.product, b, tol=rtol, maxiter=maxiter)
        return res.x, res.iters, res.relres


def control(config: dict, matrix: inputs.Matrix, device) -> ControlSystem:
    """The reference in the program's place, one precision below."""
    return ControlSystem(
        matrix.shape, matrix.indptr, matrix.cols, matrix.data,
        LOWER[config["dtype"]], inputs.DTYPES[config["dtype"]], device,
    )


SYSTEMS = {"program": Program, "control": control}


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    cell: str
    config: dict
    traffic: dict
    shape: tuple
    nnz: int
    setup_s: float
    prepare_s: float
    window: drive.Window
    trace: Optional[trace.Trace]


def run_cell(
    cell: spec.Cell,
    seed: int,
    seconds: float,
    traced: bool,
    device,
    t0: float,
    system: str = "program",
    base: Path = spec.BASE,
    log=lambda line: print(line, file=sys.stderr, flush=True),
) -> Tuple[dict, List[str]]:
    """Set-up, window, optional profiled span and check of one cell.
    Returns (the result object, the lines of the numbers compared)."""
    device = torch.device(device)
    stages = [("start", time.perf_counter() - t0)]
    t = time.perf_counter()
    matrix = inputs.make_matrix(cell.config, seed, device)
    stages.append(("inputs", time.perf_counter() - t))
    t = time.perf_counter()
    sut = SYSTEMS[system](cell.config, matrix, device)
    drive.sync(device)
    prepare_s = time.perf_counter() - t
    stages.append(("prepare", prepare_s))
    t = time.perf_counter()
    traffic = drive.make_traffic(sut, matrix, cell.config, cell.traffic, seed, device)
    stages.append(("traffic inputs", time.perf_counter() - t))
    t = time.perf_counter()
    traffic.warm()
    stages.append(("warm-up", time.perf_counter() - t))
    setup_s = time.perf_counter() - t0
    log(f"system: {system}, format {sut.format}, shape {matrix.shape}, nnz {matrix.nnz}")
    log("set-up: " + ", ".join(f"{k} {v} s" for k, v in stages) + f"; setup_s {setup_s}")
    window = traffic.window(seconds)
    log(f"window: {window.attempted} operations in {window.seconds} s, {window.failed} failed")
    if window.iters is not None:
        log(f"solves: iterations {window.iters.tolist()}; seconds {window.solve_s.tolist()}")
    span = traffic.profile() if traced else None
    if device.type == "cuda":
        log(envlines.smi_line())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # the answers to the host, then the program's state freed before the reference
    window.answers = [(j, inputs.host(a)) for j, a in window.answers]
    traffic.system = sut = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = traffic.check(matrix, window.answers)
    limits = cell.config["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = bool(window.answers) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()
    )
    run = Run(
        cell=cell.name, config=cell.config, traffic=cell.traffic, shape=matrix.shape, nnz=matrix.nnz,
        setup_s=setup_s, prepare_s=prepare_s, window=window, trace=span,
    )
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = spec.reader(m["name"], base)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed, "metrics": metrics, "device": dev}
    if span is not None:
        dev["busy_s"] = span.busy_s
        dev["window_s"] = span.window_s
        result["breakdown"] = {
            "device_ops": [[name, s] for name, s in span.device_ops],
            "idle_gaps": [[name, s] for name, s in span.idle_gaps],
        }
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    lines.append(f"correct: {correct} ({len(window.answers)} answers compared)")
    return result, lines


def forbidden_modules() -> List[str]:
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {cell.chips} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    for line in envlines.lines():
        print(line, file=sys.stderr, flush=True)
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    found = forbidden_modules()
    if found:
        print(f"error: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
