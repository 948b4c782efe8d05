"""Host layer of the PyTorch port against the JAX package: synthetic
proxies, MatrixMarket I/O, conversions, random vectors, the oracle and the
tolerance check must be identical, since every later comparison rests on
them."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import spmv_openmp_cuda_tpu as J
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu import config as jconfig
from spmv_openmp_cuda_tpu.io import mmio as jmmio
from spmv_openmp_cuda_tpu.io import vectors as jvectors
from spmv_openmp_cuda_tpu.ops import oracle as joracle
from spmv_openmp_cuda_tpu.utils import compare as jcompare
from spmv_openmp_cuda_tpu.utils import synth as jsynth
from spmv_openmp_cuda_tpu_torch import config as tconfig
from spmv_openmp_cuda_tpu_torch.io import mmio as tmmio
from spmv_openmp_cuda_tpu_torch.io import vectors as tvectors
from spmv_openmp_cuda_tpu_torch.ops import oracle as toracle
from spmv_openmp_cuda_tpu_torch.utils import compare as tcompare
from spmv_openmp_cuda_tpu_torch.utils import synth as tsynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _coo_equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.vals, b.vals)
    assert a.vals.dtype == b.vals.dtype


def test_constants_match():
    for name in ("DOUBLE_DIFF_THRESH", "MAXRND", "ELL_MAX_ENTRIES", "LANE",
                 "SUBLANE", "AVG_TIMES_ITERATION", "RNDVECTORSIZE"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    jf = [f.name for f in dataclasses.fields(jconfig.Config)]
    tf = [f.name for f in dataclasses.fields(tconfig.Config)]
    assert jf == tf


@pytest.mark.parametrize(
    "name", ["raefsky1_like", "cavity10_like", "delaunay_n12_like", "west2021_like"]
)
def test_synth_preset_identical(name):
    _coo_equal(tsynth.preset(name, seed=3), jsynth.preset(name, seed=3))


@pytest.mark.parametrize(
    "gen,kw",
    [
        ("banded", dict(m=700, n=650, bandwidth=9, fill=0.8, exact_nnz=9000)),
        ("random_uniform", dict(m=300, n=500, density=0.01)),
        ("power_law", dict(m=400, n=400, avg_nnz_per_row=4.0, exact_nnz=1500)),
        ("fem_like", dict(m=500, n=500, nnz=6000, spread=64, lo=5, hi=20)),
    ],
)
def test_synth_generators_identical(gen, kw):
    _coo_equal(getattr(tsynth, gen)(seed=5, **kw), getattr(jsynth, gen)(seed=5, **kw))


@pytest.mark.parametrize(
    "field,symmetry,suffix",
    [
        ("real", "general", ".mtx"),
        ("real", "symmetric", ".mtx.gz"),
        ("pattern", "general", ".mtx.bz2"),
        ("integer", "general", ".mtx.xz"),
    ],
)
def test_mtx_round_trip_identical(tmp_path, field, symmetry, suffix):
    coo = tsynth.banded(120, 120, 4, fill=0.7, seed=9)
    if symmetry == "symmetric":
        d = coo.to_dense()
        d = np.tril(d) + np.tril(d, -1).T
        r, c = np.nonzero(d)
        coo = T.COOMatrix((120, 120), r.astype(np.int64), c.astype(np.int64), d[r, c])
    if field == "integer":
        coo = T.COOMatrix(coo.shape, coo.rows, coo.cols, np.round(coo.vals * 10))
    pt, pj = str(tmp_path / f"t{suffix}"), str(tmp_path / f"j{suffix}")
    tmmio.write_mtx(pt, coo, field=field, symmetry=symmetry)
    jmmio.write_mtx(pj, coo, field=field, symmetry=symmetry)
    if suffix == ".mtx":  # compressed headers carry a timestamp
        with open(pt, "rb") as ft, open(pj, "rb") as fj:
            assert ft.read() == fj.read()
    for path in (pt, pj):
        _coo_equal(tmmio.read_coo(path), jmmio.read_coo(path))
    tc, jc = tmmio.mm_to_csr(pt), jmmio.mm_to_csr(pt)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))


def test_conversions_identical():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 60, 500)
    cols = rng.integers(0, 70, 500)
    vals = rng.standard_normal(500)
    tcoo = T.sort_coo(T.COOMatrix((60, 70), rows, cols, vals))
    jcoo = J.sort_coo(J.COOMatrix((60, 70), rows, cols, vals))
    _coo_equal(tcoo, jcoo)
    tcsr, jcsr = T.coo_to_csr(tcoo), J.coo_to_csr(jcoo)
    for f in ("indptr", "indices", "data", "row_lens"):
        np.testing.assert_array_equal(getattr(tcsr, f), getattr(jcsr, f))
    tell, jell = T.coo_to_ell(tcoo), J.coo_to_ell(jcoo)
    np.testing.assert_array_equal(tell.ja, jell.ja)
    np.testing.assert_array_equal(tell.data, jell.data)
    _coo_equal(T.csr_to_coo(tcsr), J.csr_to_coo(jcsr))
    np.testing.assert_array_equal(T.csr_to_dense(tcsr), J.csr_to_dense(jcsr))
    with pytest.raises(T.EllSizeError):
        T.coo_to_ell(tcoo, max_entries=10)


def test_vectors_oracle_compare_identical(tmp_path):
    for seed in (0, 7):
        np.testing.assert_array_equal(
            tvectors.fill_rnd_vector(1000, seed=seed),
            jvectors.fill_rnd_vector(1000, seed=seed),
        )
    csr = T.coo_to_csr(tsynth.preset("cavity10_like"))
    jcsr = J.coo_to_csr(jsynth.preset("cavity10_like"))
    x = tvectors.fill_rnd_vector(csr.shape[1], seed=2)
    yt, yj = toracle.serial_csr_spmv(csr, x), joracle.serial_csr_spmv(jcsr, x)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(
        toracle.dense_gemv_oracle(csr, x), joracle.dense_gemv_oracle(jcsr, x)
    )
    for other in (yt, yt + 1e-3, np.zeros_like(yt), yt[:-1]):
        rt, rj = tcompare.vectors_diff(other, yj), jcompare.vectors_diff(other, yj)
        assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    times = [1.0, 2.5, 3.0]
    assert tcompare.stats_avg_var(times) == jcompare.stats_avg_var(times)
    path = str(tmp_path / "v.txt")
    tvectors.write_vector_str(path, x)
    np.testing.assert_array_equal(tvectors.read_vector(path), jvectors.read_vector(path))


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import spmv_openmp_cuda_tpu_torch, spmv_openmp_cuda_tpu_torch.models.auto, "
        "spmv_openmp_cuda_tpu_torch.cli, spmv_openmp_cuda_tpu_torch.ops.spmv_cuda, "
        "spmv_openmp_cuda_tpu_torch.ops.window_cuda, spmv_openmp_cuda_tpu_torch.ops.route, "
        "spmv_openmp_cuda_tpu_torch.formats.window, spmv_openmp_cuda_tpu_torch.formats.routed, "
        "spmv_openmp_cuda_tpu_torch.ops.routed_cuda, spmv_openmp_cuda_tpu_torch.ops.spmv_torch, "
        "spmv_openmp_cuda_tpu_torch.ops.ell_cuda, spmv_openmp_cuda_tpu_torch.ops.lanes_cuda, "
        "spmv_openmp_cuda_tpu_torch.formats.binned, spmv_openmp_cuda_tpu_torch.formats.lanes, "
        "spmv_openmp_cuda_tpu_torch.partition.partitioners, "
        "spmv_openmp_cuda_tpu_torch.bench.harness, spmv_openmp_cuda_tpu_torch.bench.sweep, "
        "spmv_openmp_cuda_tpu_torch.bench.parse_log, spmv_openmp_cuda_tpu_torch.utils.envinfo, "
        "spmv_openmp_cuda_tpu_torch.utils.profiling\n"
        "spmv_openmp_cuda_tpu_torch.AutoSpMV\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'spmv_openmp_cuda_tpu' or m.startswith('spmv_openmp_cuda_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax_import():
    """No module of the port and nothing in chip_smoke.py imports jax or the
    JAX package, not even lazily inside a function."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|spmv_openmp_cuda_tpu)(\.|\s|$)", re.MULTILINE
    )
    pkg = os.path.join(REPO, "spmv_openmp_cuda_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, f)
        for root, _dirs, names in os.walk(pkg)
        for f in names
        if f.endswith(".py")
    ]
    assert len(files) > 10
    offenders = [f for f in files if pattern.search(open(f, encoding="utf-8").read())]
    assert not offenders, offenders
