"""The port's harness, log reducer, sweep and CLI against the JAX package's,
on the CPU (the kernels' plain versions).

run_all of both packages on one small matrix, over a list of modes with one
repetition (the JAX harness's chain timing runs for seconds per mode on the
CPU), must give the same modes, the same ok and the same errors, and logs
that the port's parse_log reduces to the same columns. Then parse_log's
round trip over the port's own log, the sweep, and the CLI's modes, remaps
and flags.
"""
import csv
import io
import json
import os

import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.bench import harness as jh
from spmv_openmp_cuda_tpu.utils import synth as jsynth
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch import cli
from spmv_openmp_cuda_tpu_torch.bench import harness as th
from spmv_openmp_cuda_tpu_torch.bench import parse_log as tpl
from spmv_openmp_cuda_tpu_torch.bench import sweep as tsw
from spmv_openmp_cuda_tpu_torch.config import Config
from spmv_openmp_cuda_tpu_torch.io.mmio import write_mtx
from spmv_openmp_cuda_tpu_torch.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu_torch.models import auto as tauto
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.utils import envinfo, profiling, synth
from spmv_openmp_cuda_tpu_torch.utils.compare import vectors_diff

MODES = ["CSR_ROWS", "CSR_TILES", "ELL_ROWS_T", "CSR_ROWS_BINNED", "PL_ELL_ROWS_T",
         "PL_CSR_LANES", "DIA_ROWS", "PL_DIA_ROWS"]


def _mats(tgen, jgen):
    tcoo, jcoo = tgen(), jgen()
    return (tcoo, T.coo_to_csr(tcoo), T.coo_to_ell(tcoo)), (jcoo, J.coo_to_csr(jcoo), J.coo_to_ell(jcoo))


@pytest.fixture(scope="module")
def reports():
    (_, tcsr, tell), (_, jcsr, jell) = _mats(
        lambda: synth.power_law(300, 300, 4.0, seed=11), lambda: jsynth.power_law(300, 300, 4.0, seed=11))
    x = fill_rnd_vector(300, seed=0)
    tcfg, jcfg = Config(avg_times_iteration=1), J.Config(avg_times_iteration=1)
    t = th.run_all(tcsr, tell, x, tcfg, kernels=MODES, name="pl300", device="cpu",
                   x_check=np.random.default_rng(1).standard_normal(300))
    j = jh.run_all(jcsr, jell, x, jcfg, kernels=MODES, name="pl300")
    return t, j, th.format_log(t, tcfg), jh.format_log(j, jcfg)


def test_run_all_matches_jax(reports):
    t, j, _, _ = reports
    assert [r.kernel for r in t.results] == [r.kernel for r in j.results] == MODES
    for rt, rj in zip(t.results, j.results):
        assert rt.ok == rj.ok, rt.kernel
        assert (rt.error is None) == (rj.error is None), (rt.kernel, rt.error, rj.error)
        if rt.error is None:
            assert rt.deterministic and rt.reps == 1 and rt.internal_time_avg > 0
            assert rt.check_ratio is not None and rt.check_ratio <= 1.0, rt.kernel
            assert rt.max_abs_diff <= 1e-5
        else:
            assert rt.error.split(":")[0].split()[:3] == rj.error.split(":")[0].split()[:3]
    errs = {r.kernel for r in t.results if r.error is not None}
    assert errs == {"DIA_ROWS", "PL_DIA_ROWS"}  # DiaFillError on a power-law matrix
    assert t.all_ok and j.all_ok


def test_logs_reduce_to_the_same_columns(reports):
    _, _, tlog, jlog = reports
    rt, rj = tpl.parse_lines(tlog.splitlines()), tpl.parse_lines(jlog.splitlines())
    assert [r["funcID"] for r in rt] == [r["funcID"] for r in rj] == MODES
    for a, b in zip(rt, rj):
        assert set(a) == set(b)
        for k in ("source", "matRows", "matCols", "NNZ", "maxRowNNZ", "grid", "dtype",
                  "schedule", "sampleSize", "ok"):
            assert a[k] == b[k], k
        assert (a["error"] == "") == (b["error"] == "")
        assert a["det"] == b["det"]
    assert rt[0]["backend"] == "cpu" and rt[0]["devices"] == "1"
    assert [r["impl"] for r in rt][:2] == ["torch", "torch"]
    assert {r["impl"] for r in rt if r["funcID"].startswith("PL_")} == {"cuda"}


def test_parse_log_round_trip(reports, tmp_path):
    t, _, tlog, _ = reports
    rows = tpl.parse_lines(tlog.splitlines())
    for r, res in zip(rows, t.results):
        assert r["funcID"] == res.kernel and r["ok"] == str(int(res.ok))
        if res.error is None:
            assert float(r["internalTimeAvg"]) == pytest.approx(res.internal_time_avg, rel=1e-8)
            assert r["det"] == "1"
        else:
            assert r["error"] and r["ok"] == "0"
    out = io.StringIO()
    tpl.write_csv(rows, out)
    back = list(csv.DictReader(io.StringIO(out.getvalue())))
    assert [dict(b) for b in back] == [{k: r.get(k, "") for k in tpl.FIELDS} for r in rows]
    piv = tpl.pivot_by_matrix(rows)
    assert len(piv) == 1 and "time_PL_CSR_LANES" in piv[0]
    log = tmp_path / "run.log"
    log.write_text(tlog + "\n")
    csv_out = tmp_path / "run.csv"
    assert tpl.main([str(log), "-o", str(csv_out), "--pivot"]) == 0
    assert "gflops_CSR_ROWS" in csv_out.read_text()


def test_check_ratio_sees_what_the_reference_protocol_misses():
    csr = T.coo_to_csr(synth.banded(500, 500, 5, fill=0.9, seed=1))
    x = fill_rnd_vector(500, seed=0)  # |x| < 3e-5: |y| stays under 7e-4
    o = serial_csr_spmv(csr, x)
    assert vectors_diff(np.zeros(500), o).ok
    xn = np.random.default_rng(0).standard_normal(500)
    on = serial_csr_spmv(csr, xn)
    assert th.check_ratio(np.zeros(500), on) > 1e4
    assert th.check_ratio(on, on) == 0.0


def test_harness_runs_f64_and_refuses_a_missing_card():
    (_, tcsr, tell), _ = _mats(lambda: synth.banded(400, 400, 4, fill=1.0, seed=2),
                               lambda: jsynth.banded(400, 400, 4, fill=1.0, seed=2))
    x = fill_rnd_vector(400, seed=0)
    cfg = Config(avg_times_iteration=1, dtype="float64")
    rep = th.run_all(tcsr, tell, x, cfg, kernels=["PL_DIA_F64", "CSR_ROWS", "ELL_ROWS"],
                     device="cpu", x_check=np.random.default_rng(3).standard_normal(400))
    assert rep.all_ok and all(r.error is None for r in rep.results)
    assert all(r.check_ratio < 1e-3 for r in rep.results)  # f64 arithmetic
    assert "dtype=float64" in th.format_log(rep, cfg)
    no_ell = th.run_all(tcsr, None, x, cfg, kernels=["CSR_ROWS", "ELL_ROWS"], device="cpu")
    assert [r.kernel for r in no_ell.results] == ["CSR_ROWS"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            th.run_all(tcsr, tell, x, cfg, kernels=["CSR_ROWS"])


def test_sweep_on_the_cpu(tmp_path, capsys):
    d = tmp_path / "corpus"
    d.mkdir()
    write_mtx(str(d / "band.mtx"), synth.banded(200, 200, 3, fill=0.9, seed=4))
    log = io.StringIO()
    logs, failures = tsw.sweep(
        [str(d / "band.mtx"), "west2021_like"], grids=[(4, 2), (2, 4)],
        cfg_base=Config(avg_times_iteration=1), kernels=["CSR_ROWS_GROUPS", "ELL_TILES", "PL_CSR_LANES"],
        log_stream=log, device="cpu")
    assert failures == [] and len(logs) == 4
    rows = tpl.parse_lines(log.getvalue().splitlines())
    assert len(rows) == 12 and {r["grid"] for r in rows} == {"4x2", "2x4"}
    assert all(r["ok"] == "1" for r in rows)
    assert {r["source"] for r in rows} == {"band.mtx", "west2021_like"}
    out = tmp_path / "sweep.log"
    assert tsw.main([str(d), "--kernels", "CSR_ROWS", "--device", "cpu", "--log", str(out)]) == 0
    assert "#matrix: band.mtx 200 200" in out.read_text()
    # a bad matrix is collected and the sweep goes on
    assert tsw.main(["no_such_preset", "--kernels", "CSR_ROWS", "--device", "cpu"]) == 1
    assert "FAILURES" in capsys.readouterr().err
    assert tsw.DEFAULT_GRIDS == [(8, 5), (5, 8), (10, 4), (4, 10), (14, 3), (13, 3)]
    if not torch.cuda.is_available():
        assert tsw.main(["west2021_like"]) == 1
        assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def delaunay_mtx(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mtx") / "delaunay_n12_like.mtx")
    write_mtx(path, synth.preset("delaunay_n12_like"))
    return path


def _run(args, capsys):
    rc = cli.main([*args, "--device", "cpu", "--check", "--no-dump"])
    return rc, capsys.readouterr()


def _mode_line(out):
    return [ln for ln in out.splitlines() if ln.startswith("computeMode:")][-1]


@pytest.mark.parametrize("mode", [None, "ELL_ROWS", "ELL_ROWS_NOSIMD", "CSR_TILES_ALLOCD",
                                  "PL_ELL_ROWS_T", "PL_CSR_LANES", "CSR_ROWS_BINNED"])
def test_cli_modes(delaunay_mtx, mode, capsys):
    rc, cap = _run([delaunay_mtx, "RNDVECT", *([mode] if mode else [])], capsys)
    assert rc == 0, cap.err
    assert "#check: OK" in cap.out
    # the default mode is CSR_ROWS, as in the JAX package's CLI
    assert _mode_line(cap.out).startswith(f"computeMode:{mode or 'CSR_ROWS'} elapsed:")


@pytest.mark.parametrize("mode,want", [
    ("PL_CSR_WINDOW", "CSR_ROWS_BINNED"), ("PL_CSR_LANES", "CSR_ROWS_BINNED"),
    ("PL_CSR_ROUTED_BF16", "CSR_ROWS_BINNED"), ("PL_ELL_ROWS_T", "ELL_ROWS_T"),
    ("PL_DIA_BF16", "PL_DIA_F64"), ("ELL_ROWS", "ELL_ROWS"),
])
def test_cli_float64_remaps_as_jax(mode, want, capsys, tmp_path):
    path = str(tmp_path / "band.mtx")
    write_mtx(path, synth.banded(600, 600, 6, fill=1.0, seed=3))
    rc, cap = _run([path, "RNDVECT", mode, "--dtype", "float64"], capsys)
    assert rc == 0, cap.err
    if want != mode:
        assert f"#dtype: float64 unsupported by CUDA mode {mode}; remapping to {want}" in cap.out
    assert _mode_line(cap.out).startswith(f"computeMode:{want} elapsed:")


def test_cli_auto_fallback_at_float64(delaunay_mtx, capsys, monkeypatch):
    # the structural guess says dia, the exact prepare refuses: float64
    # falls back to CSR_ROWS_BINNED, float32 to PL_CSR_ROUTED (JAX cli.py:327-329)
    monkeypatch.setattr(tauto, "select_format", lambda csr: "dia")
    rc, cap = _run([delaunay_mtx, "RNDVECT", "AUTO", "--dtype", "float64"], capsys)
    assert rc == 0, cap.err
    assert "#auto: format=dia -> PL_DIA_F64" in cap.out
    assert "infeasible" in cap.out and "falling back to CSR_ROWS_BINNED" in cap.out
    assert _mode_line(cap.out).startswith("computeMode:CSR_ROWS_BINNED ")
    rc, cap = _run([delaunay_mtx, "RNDVECT", "AUTO"], capsys)
    assert rc == 0 and "falling back to PL_CSR_ROUTED" in cap.out


def test_cli_ell_cap_exits_1(delaunay_mtx, capsys, monkeypatch):
    monkeypatch.setattr(cli.Config, "from_env", classmethod(lambda cls: cls(ell_max_entries=1000)))
    rc, cap = _run([delaunay_mtx, "RNDVECT", "ELL_ROWS"], capsys)
    assert rc == 1 and "exceed cap 1000" in cap.err
    rc, cap = _run([delaunay_mtx, "RNDVECT", "CSR_ROWS"], capsys)  # CSR modes need no ELL
    assert rc == 0


def test_cli_flags(delaunay_mtx, capsys, tmp_path):
    rc, cap = _run([delaunay_mtx, "RNDVECT", "--testtests"], capsys)
    assert rc == 0 and "#testtests: OK maxAbsDiff=" in cap.out and "computeMode" not in cap.out
    prof = tmp_path / "prof"
    rc, cap = _run([delaunay_mtx, "RNDVECT", "PL_CSR_LANES", "--profile", str(prof)], capsys)
    assert rc == 0 and "#profile: torch.profiler trace written" in cap.out
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    assert cli.main(["--env"]) == 0
    out = capsys.readouterr().out
    assert "torch_version:" in out and "device_count:" in out
    for extra in (["--save-prepared", str(tmp_path / "p.npz")], ["--load-prepared", str(tmp_path / "p.npz")]):
        assert cli.main([delaunay_mtx, "RNDVECT", "--device", "cpu", *extra]) == 1
        assert "not ported yet" in capsys.readouterr().err


def test_envinfo_and_profiling():
    info = envinfo.runtime_info()
    assert info["torch_version"] == torch.__version__
    assert info["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    os.environ["GRID_ROWS"] = "3"
    try:
        assert envinfo.env_overrides()["GRID_ROWS"] == "3"
    finally:
        del os.environ["GRID_ROWS"]
    t = profiling.Timings()
    with profiling.wall_timer(t):
        sum(range(1000))
    assert t.wall > 0 and t.internal == 0.0
    with profiling.profiler_trace(None):
        pass
