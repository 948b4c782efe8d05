"""`correct` comes out false for the control and for a broken timed path.

Each run here skips the harness's look for a card and drives the rest of a
run on the CPU at a small size: the set-up, the window through the
program's own entry (AutoSpMV.__call__, the port's CG), and the check
against the float64 reference with the cell's own limits.
"""
from __future__ import annotations

import time

import pytest
import torch

from spmv_bench import run
from spmv_bench.tests.conftest import file_cell, small_cell

#: the cells of BENCHMARK.json, and the synchronous mix (whose cells wait,
#: PERF.md) on the Laplacian
CELLS = ["poisson-f64.stream", "poisson-f64.sync", "poisson-f64.cg"]


def _cell(name):
    return file_cell("poisson2d-1000-f64", "sync") if name == "poisson-f64.sync" else name


def _run(name, system="program", seed=2**31 + 17):
    result, _ = run.run_cell(small_cell(_cell(name)), seed, 0.3, False, "cpu", time.perf_counter(), system=system,
                             log=lambda _: None)
    return result


@pytest.mark.parametrize("name", CELLS)
def test_the_program_comes_out_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**35])
def test_the_control_comes_out_not_correct(name, seed):
    """The reference in the program's place one precision below the
    configuration's (bfloat16 inputs for float32, float32 for float64)."""
    result = _run(name, "control", seed)
    assert not result["correct"], result["checks"]


def _fault_product(kind):
    from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV

    original = AutoSpMV.__call__
    first = {}

    def call(self, x):
        y = original(self, x)
        if kind == "stale":  # the state left unchanged: every call hands back the first y
            return first.setdefault("y", y)
        y = y.clone()
        if kind == "half":  # half of the rows left out
            y[y.shape[0] // 2 :] = 0
        elif kind == "altered":  # one answer altered where it is produced
            y[y.shape[0] // 3] += 1.0
        return y

    return AutoSpMV, call


def _fault_solve(kind):
    from spmv_openmp_cuda_tpu_torch.models import solvers

    original = solvers.conjugate_gradient

    def cg(matvec, b, *a, **k):
        res = original(matvec, b, *a, **k)
        if kind == "stale":  # the state left unchanged: x0 handed back
            return res._replace(x=torch.zeros_like(res.x), iters=torch.zeros_like(res.iters))
        if kind == "rounded":  # x kept, or handed back, one precision below
            return res._replace(x=res.x.to(torch.float32).to(res.x.dtype))
        x = res.x.clone()
        x[x.shape[0] // 3] += 1e-3 * float(x.abs().max())
        return res._replace(x=x)

    return solvers, cg


@pytest.mark.parametrize("name,kind", [
    *((c, k) for c in CELLS[:2] for k in ("stale", "half", "altered")),
    *(("poisson-f64.cg", k) for k in ("stale", "altered", "rounded")),
])
def test_a_broken_timed_path_comes_out_not_correct(monkeypatch, name, kind):
    if name.endswith(".cg"):
        module, fn = _fault_solve(kind)
        monkeypatch.setattr(module, "conjugate_gradient", fn)
    else:
        cls, fn = _fault_product(kind)
        monkeypatch.setattr(cls, "__call__", fn)
    result = _run(name)
    assert not result["correct"], result["checks"]
