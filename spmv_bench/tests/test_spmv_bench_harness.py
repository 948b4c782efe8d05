"""Isolation and discovery of the benchmark harness."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from spmv_bench import drive, roofline, run, spec, trace
from spmv_bench.tests.conftest import file_cell, small_cell

REPO = spec.BASE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "spmv_openmp_cuda_tpu"}


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
        cwd=REPO, capture_output=True, text=True, check=True,
    )
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """spmv_bench.run, every module and metric reader it loads, and the
    port's modules the run drives: no top-level name jax, jaxlib, flax or
    spmv_openmp_cuda_tpu (compared whole; the port's name only begins with
    the JAX package's)."""
    mods = _modules_after(
        "import spmv_bench.run, spmv_bench.control\n"
        "from spmv_bench import spec\n"
        "s = spec.load_spec()\n"
        "[spec.reader(m['name']) for k in ('end_to_end', 'per_layer') for m in s[k]]\n"
        "import spmv_openmp_cuda_tpu_torch.models.auto, spmv_openmp_cuda_tpu_torch.models.solvers\n"
        "import spmv_openmp_cuda_tpu_torch.config, spmv_openmp_cuda_tpu_torch.formats.matrix\n"
    )
    assert "spmv_openmp_cuda_tpu_torch" in {m.partition(".")[0] for m in mods}
    assert not {m.partition(".")[0] for m in mods} & FORBIDDEN


def test_a_run_checks_its_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "spmv_openmp_cuda_tpu_torchlike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "spmv_openmp_cuda_tpu.ops", sys)
    assert run.forbidden_modules() == ["spmv_openmp_cuda_tpu"]


def test_the_reference_takes_nothing_of_the_program():
    mods = _modules_after("import spmv_bench.reference, spmv_bench.generators, spmv_bench.roofline")
    assert not {m.partition(".")[0] for m in mods} & (FORBIDDEN | {"spmv_openmp_cuda_tpu_torch"})
    for path in (spec.BASE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and not n.level}
        assert not {n.partition(".")[0] for n in names} & (FORBIDDEN | {"spmv_openmp_cuda_tpu_torch"}), path


def test_every_cell_resolves_its_files():
    s = spec.load_spec()
    assert s["paths"] == ["spmv_bench"]
    for w in s["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["op"] in ("product", "solve")
        assert set(cell.config["limits"]) >= {"y_err"} | ({"x_relres"} if cell.traffic["op"] == "solve" else set())
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer), w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
    for c in s["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("spmv_bench/")


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    """A later change adds a traffic mix, a cell and a metric by adding
    files and entries only."""
    base = tmp_path / "spmv_bench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(spec.BASE / d, base / d)
    (base / "traffic" / "stream_wide.json").write_text(json.dumps(
        {"op": "product", "sync_each": False, "x_pool": 32, "samples": 8, "warm_products": 10, "trace_products": 20}))
    (base / "metrics" / "products_per_s.py").write_text(
        "def read(run):\n    return run.window.attempted / run.window.seconds\n")
    s = spec.load_spec()
    s["workloads"].append({"name": "poisson-f64.stream_wide", "config": "poisson2d-1000-f64",
                           "traffic": "stream_wide", "chips": 1, "why": "a wider pool of x"})
    s["per_layer"].append({"name": "products_per_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                           "layer": "wrapper", "moves": "spmv_gflops", "workloads": ["poisson-f64.stream_wide"]})
    s["end_to_end"][0]["workloads"].append("poisson-f64.stream_wide")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    cell = spec.find_cell("poisson-f64.stream_wide", tmp_path / "BENCHMARK.json", base)
    assert cell.traffic["x_pool"] == 32 and cell.config["dtype"] == "float64"
    assert [m["name"] for m in cell.per_layer if m["name"] == "products_per_s"]
    read = spec.reader("products_per_s", base)
    window = drive.Window(seconds=2.0, attempted=10, failed=0, answers=[])
    assert read(run.Run("c", {}, {}, (1, 1), 1, 0.0, 0.0, window, None)) == 5.0


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "spmv_bench.run", "--workload", "poisson-f64.stream", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_the_waiting_cells_readers_read_a_small_run():
    """The readers of the synchronous mix and of the roofline share, which
    no cell of BENCHMARK.json reports yet (PERF.md), on a small run."""
    result, _ = run.run_cell(small_cell(file_cell("poisson2d-1000-f64", "sync")), 5, 0.3, False, "cpu",
                             time.perf_counter(), log=lambda _: None)
    assert result["correct"]
    window = drive.Window(seconds=2.0, attempted=400, failed=0, answers=[],
                          call_s=np.full(400, 20e-6), sync_s=np.linspace(40e-6, 60e-6, 400))
    traffic = {"op": "product", "sync_each": True}
    span = trace.Trace(window_s=0.1, busy_s=0.004, ops=200, kernels=400, device_s=0.005, device_ops=[], idle_gaps=[])
    r = run.Run("c", {"dtype": "float32"}, traffic, (131072, 131072), 3728216, 0.0, 0.0, window, span)
    assert spec.reader("spmv_sync_us")(r) == pytest.approx(5000.0)
    assert spec.reader("host_us_per_call")(r) == pytest.approx(20.0)
    assert spec.reader("spmv_sync_p95_us")(r) == pytest.approx(59.0, rel=1e-3)
    assert spec.reader("device_idle_pct.sync")(r) == pytest.approx(100.0 * (1 - 20e-6 * 400 / 2.0))
    least = roofline.least_time_s(131072, 131072, 3728216, "float32")
    assert spec.reader("spmv_roofline")(r) == pytest.approx(100.0 * least / 25e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in spec.load_spec()["workloads"]])
def test_a_small_cell_runs_on_the_card(card, name):
    result, _ = run.run_cell(small_cell(name), 2**31 + 9, 0.5, True, card, time.perf_counter(), log=lambda _: None)
    assert result["correct"] and result["attempted"] > 0
    assert result["device"]["busy_s"] > 0 and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    assert all(np.isfinite(v["value"]) for v in result["metrics"].values())
