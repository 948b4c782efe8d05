"""Corpus sweep: the whole harness over every matrix of a directory (or the
synthetic presets) across grid configurations.

Counterpart of spmv_openmp_cuda_tpu/bench/sweep.py (reference:
test/testAll.sh:13-38: every *.mtx under a data dir x the GRID_ROWS x
GRID_COLS configs, logs teed, failing matrices collected and the sweep
going on), on the card unless the caller asks for `--device cpu`.

  python -m spmv_openmp_cuda_tpu_torch.bench.sweep [corpus...] [--grids 8x8]
      [--full-grids] [--kernels CSR_ROWS,...] [--log FILE] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import sys
import traceback
from typing import List, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..formats.convert import EllSizeError, coo_to_csr, coo_to_ell
from ..io.mmio import read_coo
from ..io.vectors import fill_rnd_vector
from ..utils import synth
from .harness import format_log, run_all

#: The reference's OMP sweep grid list (testAll.sh:21-36).
DEFAULT_GRIDS: List[Tuple[int, int]] = [
    (8, 5), (5, 8), (10, 4), (4, 10), (14, 3), (13, 3),
]


def load_matrix(path_or_preset: str):
    """Either a .mtx[.gz|...] path or a synthetic preset name."""
    if os.path.exists(path_or_preset):
        return os.path.basename(path_or_preset), read_coo(path_or_preset)
    return path_or_preset, synth.preset(path_or_preset)


def sweep(
    matrices: Sequence[str],
    grids: Sequence[Tuple[int, int]] = ((8, 8),),
    cfg_base: Optional[Config] = None,
    kernels: Optional[Sequence[str]] = None,
    log_stream=None,
    device="cuda",
) -> Tuple[List[str], List[str]]:
    """Returns (the logs, the failing matrices' names)."""
    log_stream = log_stream or sys.stdout
    failures: List[str] = []
    logs: List[str] = []
    for spec in matrices:
        name = os.path.basename(spec) if os.path.exists(spec) else spec
        try:
            name, coo = load_matrix(spec)
            csr = coo_to_csr(coo)
            base = cfg_base or Config()
            try:
                ell = coo_to_ell(coo, max_entries=base.ell_max_entries)
            except EllSizeError as e:
                print(f"#ell-skipped: {name}: {e}", file=log_stream)
                ell = None
            x = fill_rnd_vector(coo.shape[1], seed=0)
            for gr, gc in grids:
                cfg = dataclasses.replace(base, grid_rows=gr, grid_cols=gc)
                report = run_all(csr, ell, x, cfg, kernels=kernels, name=name, device=device)
                text = format_log(report, cfg)
                logs.append(text)
                print(text, file=log_stream, flush=True)
                if not report.all_ok and name not in failures:
                    failures.append(name)
        except Exception:
            # the sweep records the failure and goes on (testAll.sh:17,25)
            if name not in failures:
                failures.append(name)
            traceback.print_exc(file=sys.stderr)
    return logs, failures


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="SpMV corpus sweep")
    p.add_argument(
        "corpus", nargs="*", default=[],
        help=".mtx files/dirs or preset names; default = synthetic presets",
    )
    p.add_argument("--grids", default="8x8", help="comma list, e.g. 8x5,5x8,10x4")
    p.add_argument("--full-grids", action="store_true", help="use the reference's 6-grid list")
    p.add_argument("--kernels", default=None, help="comma list of compute modes")
    p.add_argument("--log", default=None, help="tee log file")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda launches the CUDA kernels; cpu runs their plain versions")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda (the default) but no CUDA device is available; "
              "pass --device cpu to run the plain PyTorch versions", file=sys.stderr)
        return 1

    matrices: List[str] = []
    for c in args.corpus:
        if os.path.isdir(c):
            matrices.extend(sorted(glob.glob(os.path.join(c, "*.mtx*"))))
        else:
            matrices.append(c)
    if not matrices:
        matrices = list(synth.PRESETS)

    grids = DEFAULT_GRIDS if args.full_grids else [
        tuple(int(v) for v in g.split("x")) for g in args.grids.split(",")
    ]
    kernels = args.kernels.split(",") if args.kernels else None
    stream = open(args.log, "w") if args.log else sys.stdout
    try:
        _, failures = sweep(matrices, grids, cfg_base=Config.from_env(), kernels=kernels,
                            log_stream=stream, device=args.device)
    finally:
        if stream is not sys.stdout:
            stream.close()
    if failures:
        print(f"FAILURES: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
