"""The port's binding of the native host library (io/native.py): built from
native/spmv_native.cpp into the package's _build/ (never native/), every
function array for array against the port's numpy path, the JAX package's
error table, the fallbacks, and AutoSpMV on natively prepared layouts
against the oracle of the matrix as stored.
"""
import os

import numpy as np
import pytest
import torch

from spmv_openmp_cuda_tpu.io import native as jnative
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch.formats import routed as tr
from spmv_openmp_cuda_tpu_torch.formats import window as tw
from spmv_openmp_cuda_tpu_torch.formats.convert import EllSizeError, sort_coo
from spmv_openmp_cuda_tpu_torch.formats.matrix import COOMatrix
from spmv_openmp_cuda_tpu_torch.io import native as N
from spmv_openmp_cuda_tpu_torch.io.mmio import read_coo, write_mtx
from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV
from spmv_openmp_cuda_tpu_torch.ops import route as troute
from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.utils import synth
from torch_numpy_path import numpy_path

FEM = dict(m=4000, n=4000, nnz=40000, spread=500, lo=4, hi=16, seed=9)


@pytest.fixture
def lib():
    if not N.available():
        pytest.fail(f"the native library did not build: {N.failure()}")
    return N.load_library()


def _numpy(monkeypatch, fn, *a, **k):
    """fn on the numpy path, then the library back."""
    with numpy_path():
        return fn(*a, **k)


def test_builds_into_the_package_build_dir(lib):
    path = N.library_path()
    assert path.exists() and path.parent == N.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "spmv_openmp_cuda_tpu_torch"
    assert lib.spmv_native_abi_version() == N.ABI_VERSION == 4
    assert not os.path.exists(os.path.join(os.path.dirname(N.SOURCE), "libspmv_native.so"))
    assert N._ERRORS == jnative._ERRORS


@pytest.mark.parametrize("kw", [dict(), dict(symmetry="symmetric"), dict(field="pattern")])
def test_parse_matches_mmio(lib, tmp_path, kw):
    if kw.get("symmetry"):
        coo, _ = _sym(60, seed=0)
    else:
        coo = synth.power_law(300, 280, 5.0, seed=3)
    p = str(tmp_path / "m.mtx")
    write_mtx(p, coo, **kw)
    a, b = read_coo(p), N.read_coo_native(p)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.vals, b.vals)
    np.testing.assert_array_equal(a.compute_row_lens(), b.row_lens)


def _sym(m, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros((m, m))
    for i, j in rng.integers(0, m, size=(90, 2)):
        d[i, j] = d[j, i] = rng.standard_normal()
    r, c = np.nonzero(d)
    return sort_coo(COOMatrix((m, m), r, c, d[r, c])), d


def test_converters_match(lib):
    coo = synth.banded(100, 100, 6, fill=0.8, seed=5)
    csr_py, csr_nat = T.coo_to_csr(coo), N.coo_to_csr_native(coo)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(csr_py, f), getattr(csr_nat, f))
    ell_py, ell_nat = T.coo_to_ell(coo), N.coo_to_ell_native(coo)
    assert ell_py.max_row_nz == ell_nat.max_row_nz
    np.testing.assert_array_equal(ell_py.ja, ell_nat.ja)
    np.testing.assert_array_equal(ell_py.data, ell_nat.data)
    with pytest.raises(EllSizeError):
        N.coo_to_ell_native(coo, max_entries=1)


@pytest.mark.parametrize("body,msg", [
    (b"not a matrix\n1 1 1\n", "invalid MatrixMarket banner"),
    (b"%%MatrixMarket matrix coordinate real general\n2 2 5\n1 1 1.0\n", "entry count mismatch"),
    (b"%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n", "out of bounds"),
    (b"%%MatrixMarket matrix coordinate real symmetric\n2 3 1\n1 3 1.0\n", None),
])
def test_malformed_input_errors(lib, body, msg):
    with pytest.raises(ValueError, match="native parse failed") as e:
        N.parse_mtx_bytes(body)
    assert msg is None or msg in str(e.value)
    # a CRLF banner parses
    coo = N.parse_mtx_bytes(b"%%MatrixMarket matrix coordinate real general\r\n2 2 1\r\n1 2 1.5\r\n")
    assert coo.shape == (2, 2) and coo.nnz == 1


def test_scan_rank_fill_match_numpy(lib, monkeypatch):
    csr = T.coo_to_csr(synth.fem_like(**FEM))
    base = tw._base_fields(csr)
    rq, lane, q, jres = base
    for g in (4, 12, 16, 64):
        nblocks = -(-csr.shape[0] // (g * 128))
        d_min, d_max, hl, hr = N.window_scan_native(rq, lane, q, jres, g, nblocks)
        _wr, _ns, _nb, dl8, dr8 = _numpy(monkeypatch, tw._scan_g, csr, g, base, True)
        d = q - (rq // g) * g
        assert (d_min, d_max) == (int(d.min()), int(d.max()))
        np.testing.assert_array_equal(hl, dl8)
        np.testing.assert_array_equal(hr, dr8)
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 23, 50000)) * 1024 + rng.integers(0, 1024, 50000)
    np.testing.assert_array_equal(tw._rank_in_group(keys, 23 * 1024),
                                  _numpy(monkeypatch, tw._rank_in_group, keys, 23 * 1024))
    for kw in (dict(g=8, bps=1), dict(g=8, bps=4), dict(g=16, cap=None),
               dict(g=8, xdirect=True, cap=None)):
        if kw.get("xdirect"):
            small = T.coo_to_csr(synth.fem_like(m=1000, n=1000, nnz=8000, spread=200, lo=4, hi=10,
                                                seed=1))
            m_nat, m_py = (tw.prepare_window(small, device="cpu", **kw),
                           _numpy(monkeypatch, tw.prepare_window, small, device="cpu", **kw))
        else:
            m_nat, m_py = (tw.prepare_window(csr, device="cpu", **kw),
                           _numpy(monkeypatch, tw.prepare_window, csr, device="cpu", **kw))
        for f in ("vals", "sidx", "gid", "rsrc"):
            assert torch.equal(getattr(m_nat, f), getattr(m_py, f)), (kw, f)


def test_coloring_matches_numpy(lib, monkeypatch):
    """The native router colors every graph here as the numpy Euler split
    does (the same orbit-minimum rule); where it did not, the coloring
    would still have to be proper, which is checked too."""
    rng = np.random.default_rng(0)
    for t, deg in ((1, 128), (4, 128), (64, 16)):
        left = np.repeat(np.arange(128 * t), deg)
        right = rng.permutation(np.repeat(np.arange(128 * t), deg))
        nat = N.color_bipartite_native(left, right, deg)
        py = _numpy(monkeypatch, troute.color_bipartite_pow2, left, right, deg)
        np.testing.assert_array_equal(nat, py)
        for side in (left, right):
            assert np.unique(side * deg + nat).size == side.size  # distinct colors per node
    assert N.color_bipartite_native(np.arange(3), np.arange(3), 2) is None  # odd: refused


@pytest.mark.parametrize("case", ["delaunay", "power_law"])
def test_native_layouts_and_auto_spmv(lib, monkeypatch, case):
    """Natively prepared routed and window layouts equal the numpy ones, and
    AutoSpMV on them matches the oracle of the matrix as stored."""
    coo = (synth.preset("delaunay_n12_like") if case == "delaunay"
           else synth.power_law(3000, 3000, 5.0, seed=5))
    csr = T.coo_to_csr(coo)
    nat = tr.prepare_routed(csr, device="cpu")
    py = _numpy(monkeypatch, tr.prepare_routed, csr, device="cpu")
    for f in ("vals", "pidx", "widx"):
        assert torch.equal(getattr(nat, f), getattr(py, f)), f
    for a, b in ((nat.perm_products, py.perm_products), (nat.perm_out, py.perm_out)):
        for f in ("w1", "w2", "w3", "r3"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    x = np.random.default_rng(2).standard_normal(csr.shape[1])
    for fmt in ("routed", "window") if case == "delaunay" else ("routed",):
        model = AutoSpMV.from_csr(csr, format=fmt, device="cpu")
        assert model.format == fmt
        ocsr = trc.stored_csr(csr, model._operands) if fmt == "routed" else csr
        o = serial_csr_spmv(ocsr, x)
        assert np.abs(model(x).double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6


def test_native_schemad_prepare_equals_numpy(lib, monkeypatch):
    """The schema'd routed prepare (the SPMD chunks, parallel/routed_spmd.py)
    through the native router: every chunk's layout the numpy path's."""
    from spmv_openmp_cuda_tpu_torch.parallel.routed_spmd import _fair_nnz_bounds

    csr = T.coo_to_csr(synth.power_law(6000, 6000, avg_nnz_per_row=7.0, alpha=1.5, seed=11))
    b = _fair_nnz_bounds(csr, 4)
    chunks = [tr._sub_csr(csr, b[i], b[i + 1]) for i in range(4)]
    schema = tr.merge_routed_schemas([tr.routed_schema_stats(c) for c in chunks])
    for c in chunks:
        nat = tr.prepare_routed(c, schema=schema, device="cpu")
        py = _numpy(monkeypatch, tr.prepare_routed, c, schema=schema, device="cpu")
        for f in ("vals", "pidx", "widx"):
            assert torch.equal(getattr(nat, f), getattr(py, f)), f
        for a, p in zip((nat.perm_products, nat.perm_out, *nat.lvl_perms),
                        (py.perm_products, py.perm_out, *py.lvl_perms)):
            for f in ("r1", "w1", "w2", "w3", "r3", "wc"):
                assert (getattr(a, f) is None) == (getattr(p, f) is None), f
                if getattr(a, f) is not None:
                    assert torch.equal(getattr(a, f), getattr(p, f)), f
        assert nat.runs == py.runs and nat.lvl_runs == py.lvl_runs


def test_fallbacks(monkeypatch, tmp_path):
    """No library loaded and a failed build both leave every function to
    its numpy caller (None / False); the JAX package's library stays
    unbuilt."""
    a = np.arange(4)
    with numpy_path():
        assert not N.available()
        assert N.color_bipartite_native(a, a, 2) is None
        assert N.rank_in_group_native(a, 1, 4) is None
        assert N.window_scan_native(a, a, a, a, 4, 1) is None
        assert N.window_fill_native(a, a, a, a, a, a, 4, 8, 0, 1, 1, 1, 0, None, None, None,
                                    None) is False
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_failure", None)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(N, "compilers", lambda: ["/bin/false"])
    assert not N.available() and "no C++ compiler built" in N.failure()
    assert N.color_bipartite_native(a, a, 2) is None
    assert not jnative.available()
