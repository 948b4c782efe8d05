"""The CSR/ELL mode matrix of the PyTorch port against the JAX package, on
the CPU: the device prepares (device_csr, device_ell in both layouts,
prepare_binned_csr, prepare_lanes_small) and the partitioners array for
array, then the 13 modes the port adds (the reference's OpenMP strategy
matrix as torch ops, CSR_ROWS_BINNED, and the plain versions of the
PL_ELL_ROWS_T and PL_CSR_LANES CUDA kernels) through both registries, and
AutoSpMV's lanes, ell_t and binned formats. The JAX Pallas modes run in
interpret mode, as tests/test_pallas.py runs them.

Tolerances, on x ~ N(0, 1):
- float32: max |y_t - y_j| <= 1e-5 * max|y_j| + 1e-6 (f32 sums in another
  order);
- float64 (the plain-torch modes, native f64 in both packages): 1e-12 *
  max|y_j|, the same f64 arithmetic in another order. The JAX package's f64
  needs jax_enable_x64, scoped to each call with jax.enable_x64(True).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.formats import binned as jbin
from spmv_openmp_cuda_tpu.formats import lanes as jlanes
from spmv_openmp_cuda_tpu.formats import matrix as jmatrix
from spmv_openmp_cuda_tpu.models import auto as jauto
from spmv_openmp_cuda_tpu.ops import registry as jreg
from spmv_openmp_cuda_tpu.partition import partitioners as jpart
from spmv_openmp_cuda_tpu.utils import synth as jsynth
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch.config import Config
from spmv_openmp_cuda_tpu_torch.formats import binned as tbin
from spmv_openmp_cuda_tpu_torch.formats import lanes as tlanes
from spmv_openmp_cuda_tpu_torch.formats import matrix as tmatrix
from spmv_openmp_cuda_tpu_torch.models import auto as tauto
from spmv_openmp_cuda_tpu_torch.ops import ell_cuda as tec
from spmv_openmp_cuda_tpu_torch.ops import lanes_cuda as tlc
from spmv_openmp_cuda_tpu_torch.ops import registry as treg
from spmv_openmp_cuda_tpu_torch.ops import spmv_torch as tst
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.partition import partitioners as tpart
from spmv_openmp_cuda_tpu_torch.utils import synth

NEW_MODES = [
    "CSR_ROWS", "CSR_ROWS_GROUPS", "CSR_TILES", "CSR_TILES_ALLOCD", "ELL_ROWS",
    "ELL_ROWS_GROUPS", "ELL_TILES", "ELL_ROWS_T", "ELL_ROWS_NOSIMD", "ELL_ROWS_NORL",
    "CSR_ROWS_BINNED", "PL_ELL_ROWS_T", "PL_CSR_LANES",
]
F64_MODES = NEW_MODES[:11]


def _ragged():
    """Power-law rows, row 5 empty and 100 trailing empty columns."""
    coo = synth.power_law(600, 600, 5.0, seed=3)
    keep = coo.rows != 5
    return (600, 700), coo.rows[keep], coo.cols[keep], coo.vals[keep]


def _wide():
    """More than one x window (n > 16384, n not a multiple of it)."""
    coo = synth.random_uniform(300, 40000, density=2e-3, seed=5)
    return coo.shape, coo.rows, coo.cols, coo.vals


def _banded():
    coo = synth.banded(500, 500, 5, fill=0.9, seed=1)
    return coo.shape, coo.rows, coo.cols, coo.vals


MATRICES = {"ragged": _ragged, "wide": _wide, "banded": _banded}


def _both(name):
    """(port COO, CSR, ELL), (JAX COO, CSR, ELL) of the same matrix."""
    shape, r, c, v = MATRICES[name]()
    out = []
    for pkg in (T, J):
        coo = pkg.COOMatrix(shape, r.astype(np.int64), c.astype(np.int64), v.astype(np.float64))
        out.append((coo, pkg.coo_to_csr(coo), pkg.coo_to_ell(coo)))
    return out


def _x(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n)


def _close(y_t, y_j, rel=1e-5, absolute=1e-6):
    y_t = y_t.double().numpy() if isinstance(y_t, torch.Tensor) else np.asarray(y_t, np.float64)
    y_j = np.asarray(y_j, np.float64)
    assert y_t.shape == y_j.shape
    err = np.abs(y_t - y_j).max(initial=0.0)
    assert err <= rel * np.abs(y_j).max(initial=0.0) + absolute, err


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_holds_the_jax_modes():
    assert sorted(treg.names()) == sorted(jreg.names())
    assert len(treg.names()) == 26
    for name in jreg.names():
        t, j = treg.get(name), jreg.get(name)
        assert (t.fmt, t.f64) == (j.fmt, j.f64), name
        assert t.impl == ("torch" if j.impl == "xla" else "cuda"), name


# ---------------------------------------------------------------------------
# prepares, array for array
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MATRICES))
def test_device_csr_array_equal(name):
    (_, tcsr, _), (_, jcsr, _) = _both(name)
    t, j = tmatrix.device_csr(tcsr), jmatrix.device_csr(jcsr)
    for f in ("data", "cols", "row_ids", "indptr", "row_lens"):
        _eq(getattr(t, f), getattr(j, f))
    assert t.cols.dtype == t.row_ids.dtype == torch.int32
    assert (t.shape, t.nnz) == (tuple(j.shape), j.nnz)
    t64 = tmatrix.device_csr(tcsr, dtype=torch.float64)
    np.testing.assert_array_equal(t64.data.numpy()[: tcsr.nnz], tcsr.data)


@pytest.mark.parametrize("name", ["ragged", "banded"])
@pytest.mark.parametrize("layout", [dict(transposed=False), dict(transposed=True),
                                    dict(transposed=False, lane_pad=False)])
def test_device_ell_array_equal(name, layout):
    (_, _, tell), (_, _, jell) = _both(name)
    t, j = tmatrix.device_ell(tell, **layout), jmatrix.device_ell(jell, **layout)
    for f in ("data", "cols", "row_lens"):
        _eq(getattr(t, f), getattr(j, f))
    assert (t.shape, t.nnz, t.max_row_nz, t.transposed) == \
        (tuple(j.shape), j.nnz, j.max_row_nz, j.transposed)
    with pytest.raises(ValueError):
        tmatrix.device_ell(tpart.ell_transpose(tell))


def test_is_nnz_agrees():
    (_, tcsr, _), (_, jcsr, _) = _both("ragged")
    rng = np.random.default_rng(0)
    for i, jcol in zip(rng.integers(0, 600, 300), rng.integers(0, 700, 300)):
        assert tmatrix.is_nnz(tcsr, i, jcol) == jmatrix.is_nnz(jcsr, i, jcol)
    r = int(np.argmax(np.diff(tcsr.indptr)))
    assert tmatrix.is_nnz(tcsr, r, int(tcsr.indices[tcsr.indptr[r]]))


@pytest.mark.parametrize("name", list(MATRICES))
def test_prepare_binned_array_equal(name):
    (_, tcsr, _), (_, jcsr, _) = _both(name)
    t, j = tbin.prepare_binned_csr(tcsr), jbin.prepare_binned_csr(jcsr)
    for f in ("slab_data", "slab_cols", "out_pos"):
        _eq(getattr(t, f), getattr(j, f))
    for f in ("class_offsets", "class_widths", "class_layouts", "nnz"):
        assert getattr(t, f) == getattr(j, f), f
    assert set(t.class_layouts) <= {"t", "r"}
    assert tbin.width_classes(26) == jbin.width_classes(26) == [8, 16, 32]


@pytest.mark.parametrize("name", list(MATRICES))
def test_prepare_lanes_array_equal(name):
    (_, tcsr, _), (_, jcsr, _) = _both(name)
    t, j = tlanes.prepare_lanes_small(tcsr), jlanes.prepare_lanes_small(jcsr)
    for f in ("vals", "pidx", "gid"):
        _eq(getattr(t, f), getattr(j, f))
    assert t.pidx.dtype == t.gid.dtype == torch.int32
    assert (t.window_tiles, t.shape, t.nnz, t.n_groups) == \
        (j.window_tiles, tuple(j.shape), j.nnz, j.n_groups)
    want = np.concatenate([np.full(b - a, w) for w, (a, b) in enumerate(j.window_tiles)])
    _eq(t.tile_win[: len(want)], want)
    if name == "wide":
        assert len(t.window_tiles) == 3


def test_lanes_refusals_agree():
    (_, tcsr, _), (_, jcsr, _) = _both("wide")
    for kw in (dict(max_groups=2), dict(max_slots=128 * 128)):
        with pytest.raises(tlanes.LanesError):
            tlanes.prepare_lanes_small(tcsr, **kw)
        with pytest.raises(jlanes.LanesError):
            jlanes.prepare_lanes_small(jcsr, **kw)


@pytest.mark.parametrize("grid_cols", [1, 3, 8])
def test_partitioners_agree(grid_cols):
    (_, tcsr, tell), (_, jcsr, jell) = _both("ragged")
    offs = tpart.cols_offsets_partitioning(tcsr, grid_cols)
    np.testing.assert_array_equal(offs, jpart.cols_offsets_partitioning(jcsr, grid_cols))
    tpart.check_cols_offsets_partitioning(tcsr, offs)
    np.testing.assert_array_equal(tpart.partition_balance(offs, 4), jpart.partition_balance(offs, 4))
    for tp, jp in zip(tpart.cols_partitioning(tcsr, grid_cols), jpart.cols_partitioning(jcsr, grid_cols)):
        for f in ("indptr", "indices", "data", "row_lens"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
        assert tpart.spmat_diff(tp, tp) and tp.shape == jp.shape
    tt, jt = tpart.ell_transpose(tell), jpart.ell_transpose(jell)
    np.testing.assert_array_equal(tt.ja, jt.ja)
    np.testing.assert_array_equal(tt.data, jt.data)
    assert tt.slab_transposed and np.array_equal(tt.to_dense(), tell.to_dense())
    perm = tpart.row_binning(tcsr.compute_row_lens())
    np.testing.assert_array_equal(perm, jpart.row_binning(jcsr.compute_row_lens()))
    np.testing.assert_array_equal(tpart.invert_permutation(perm), jpart.invert_permutation(perm))
    assert not tpart.spmat_diff(tcsr, dataclasses.replace(tcsr, data=tcsr.data + 1.0))


def test_csr_groups_plan_agrees():
    (_, tcsr, tell), (_, jcsr, jell) = _both("ragged")
    cfg = Config(grid_rows=7)
    t = treg.get("CSR_ROWS_GROUPS").prepare(tcsr, tell, cfg, "cpu")
    j = jreg.get("CSR_ROWS_GROUPS").prepare(jcsr, jell, J.Config(grid_rows=7))
    assert list(t[1]) == np.asarray(j[1]).tolist() and t[2:] == tuple(j[2:])


# ---------------------------------------------------------------------------
# the 13 modes through both registries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("mode", NEW_MODES)
def test_mode_matches_jax_f32(mode, name):
    (_, tcsr, tell), (_, jcsr, jell) = _both(name)
    x = _x(tcsr.shape[1])
    ts, js = treg.get(mode), jreg.get(mode)
    y_t = ts.jitted(ts.prepare(tcsr, tell, Config(grid_rows=3, grid_cols=5), "cpu"))(
        torch.as_tensor(x, dtype=torch.float32))
    y_j = js.jitted(js.prepare(jcsr, jell, J.Config(grid_rows=3, grid_cols=5)))(
        jnp.asarray(x, jnp.float32))
    assert y_t.dtype == torch.float32 and y_t.shape == (tcsr.shape[0],)
    _close(y_t, np.asarray(y_j)[: tcsr.shape[0]])
    _close(y_t, serial_csr_spmv(tcsr, x))


@pytest.mark.parametrize("mode", F64_MODES)
def test_mode_matches_jax_f64(mode):
    (_, tcsr, tell), (_, jcsr, jell) = _both("ragged")
    x = _x(tcsr.shape[1], seed=2)
    ts, js = treg.get(mode), jreg.get(mode)
    y_t = ts.jitted(ts.prepare(tcsr, tell, Config(dtype="float64"), "cpu"))(
        torch.as_tensor(x, dtype=torch.float64))
    with jax.enable_x64(True):
        y_j = np.asarray(js.jitted(js.prepare(jcsr, jell, J.Config(dtype="float64")))(
            jnp.asarray(x, jnp.float64)))
    assert y_t.dtype == torch.float64 and y_j.dtype == np.float64
    _close(y_t, y_j[: tcsr.shape[0]], rel=1e-12, absolute=0.0)
    _close(y_t, serial_csr_spmv(tcsr, x), rel=1e-12, absolute=0.0)


def test_nosimd_sums_left_to_right():
    """simd=False adds chunk after chunk (128 wide for W % 128 == 0, else
    one by one), in f32, the reference's scalar order."""
    rng = np.random.default_rng(0)
    for w in (7, 256):
        p = (rng.standard_normal((5, w)) * 10.0 ** rng.integers(-3, 4, (5, w))).astype(np.float32)
        chunk = 128 if w % 128 == 0 else 1
        want = np.zeros(5, np.float32)
        for j in range(0, w, chunk):
            want = want + p[:, j : j + chunk].sum(axis=1, dtype=np.float32)
        got = tst._row_reduce(torch.as_tensor(p), simd=False).numpy()
        if chunk == 1:
            np.testing.assert_array_equal(got, want)
        else:  # in-chunk sums may take another tree order
            assert np.all(np.abs(got - want) <= 1e-6 * np.abs(p).sum(axis=1))
    t = tmatrix.device_ell(_both("ragged")[0][2], transposed=True)
    x = torch.as_tensor(_x(700), dtype=torch.float32)
    _close(tst.ell_rows_transposed(t, x, simd=False), tst.ell_rows_transposed(t, x))


def test_row_lens_mask_matters():
    """ELL_ROWS masks slots past each row's length; ELL_ROWS_NORL does not:
    non-zero filler shows the difference (both agree on zero filler)."""
    (_, tcsr, tell), _ = _both("ragged")
    mat = tmatrix.device_ell(tell)
    filled = dataclasses.replace(mat, data=torch.where(mat.data == 0, 1.0, mat.data))
    x = torch.as_tensor(_x(700), dtype=torch.float32)
    _close(tst.ell_rows(filled, x), serial_csr_spmv(tcsr, x.double().numpy()))
    assert not torch.allclose(tst.ell_rows(filled, x, row_lens=False), tst.ell_rows(filled, x))


# ---------------------------------------------------------------------------
# the plain versions of the two CUDA kernels on converted JAX operands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MATRICES))
def test_lanes_from_jax(name):
    _, (_, jcsr, _) = _both(name)
    j = jlanes.prepare_lanes_small(jcsr)
    x = _x(jcsr.shape[1])
    y_j = np.asarray(jlanes.lanes_small_spmv(j, jnp.asarray(x, jnp.float32)))
    t = tlc.lanes_from_jax(np.asarray(j.vals), np.asarray(j.pidx), np.asarray(j.gid),
                           j.window_tiles, j.shape, j.nnz, j.n_groups)
    y_t = tlc.lanes_cuda(t, torch.as_tensor(x, dtype=torch.float32))
    _close(y_t, y_j)
    bad = np.asarray(j.gid).copy()
    bad[0, 0] = j.n_groups
    with pytest.raises(ValueError):
        tlc.lanes_from_jax(np.asarray(j.vals), np.asarray(j.pidx), bad, j.window_tiles,
                           j.shape, j.nnz, j.n_groups)


@pytest.mark.parametrize("name", ["ragged", "banded"])
def test_ell_from_jax(name):
    _, (_, jcsr, jell) = _both(name)
    j = jmatrix.device_ell(jell, transposed=True)
    x = _x(jcsr.shape[1])
    from spmv_openmp_cuda_tpu.ops.spmv_pallas import ell_t_slab_pallas

    y_j = np.asarray(ell_t_slab_pallas(j, jnp.asarray(x, jnp.float32)))
    t = tec.ell_from_jax(np.asarray(j.data), np.asarray(j.cols), np.asarray(j.row_lens),
                         j.shape, j.nnz, j.max_row_nz, j.transposed)
    _close(tec.ell_t_cuda(t, torch.as_tensor(x, dtype=torch.float32)), y_j)
    with pytest.raises(ValueError):
        tec.ell_from_jax(np.asarray(j.data), np.asarray(j.cols) + jcsr.shape[1],
                         np.asarray(j.row_lens), j.shape, j.nnz, j.max_row_nz, True)


def test_kernel_wrappers_check_on_the_cpu():
    (_, tcsr, tell), _ = _both("ragged")
    x = torch.as_tensor(_x(700), dtype=torch.float32)
    ell = tmatrix.device_ell(tell, transposed=True)
    with pytest.raises(ValueError):
        tec.ell_t_cuda(tmatrix.device_ell(tell), x)  # row-major slab
    with pytest.raises(TypeError):
        tec.ell_t_cuda(ell, x.double())
    with pytest.raises(ValueError):
        tec.ell_t_cuda(ell, x[:-1])
    with pytest.raises(ValueError):
        tec.ell_t_cuda(ell, x.to("meta"))
    lanes = tlanes.prepare_lanes_small(tcsr)
    with pytest.raises(TypeError):
        tlc.lanes_cuda(dataclasses.replace(lanes, gid=lanes.gid.to(torch.int8)), x)
    with pytest.raises(ValueError):
        tlc.lanes_cuda(dataclasses.replace(lanes, n_groups=65), x)
    with pytest.raises(ValueError):
        tlc.lanes_cuda(lanes, x.to("meta"))
    assert tec.ell_t_cuda.launches == tlc.lanes_cuda.launches == 0  # CPU: no launch


# ---------------------------------------------------------------------------
# AutoSpMV's explicit formats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["lanes", "ell_t", "binned"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_auto_spmv_explicit_formats(fmt, dtype):
    (_, tcsr, _), (_, jcsr, _) = _both("ragged")
    x = _x(tcsr.shape[1], seed=4)
    t = tauto.AutoSpMV.from_csr(tcsr, cfg=Config(dtype=dtype), format=fmt, device="cpu")
    want = "binned" if (fmt == "lanes" and dtype == "float64") else fmt
    assert t.format == want
    y_t = t(x)
    assert y_t.dtype == (torch.float64 if dtype == "float64" else torch.float32)
    if dtype == "float32":
        j = jauto.AutoSpMV.from_csr(jcsr, format=fmt)
        assert j.format == t.format
        _close(y_t, np.asarray(j(jnp.asarray(x, jnp.float32))))
        _close(y_t, serial_csr_spmv(tcsr, x))
    else:
        with jax.enable_x64(True):
            j = jauto.AutoSpMV.from_csr(jcsr, cfg=J.Config(dtype="float64"), format=fmt)
            y_j = np.asarray(j(jnp.asarray(x, jnp.float64)))
        assert j.format == t.format
        _close(y_t, y_j, rel=1e-12, absolute=0.0)
        _close(y_t, serial_csr_spmv(tcsr, x), rel=1e-12, absolute=0.0)


def test_auto_spmv_fallbacks_agree():
    # lanes refuses G > 64 row groups: the routed engine takes over
    big = T.coo_to_csr(synth.random_uniform(9000, 9000, density=3e-4, seed=2))
    jbig = J.coo_to_csr(jsynth.random_uniform(9000, 9000, density=3e-4, seed=2))
    t = tauto.AutoSpMV.from_csr(big, format="lanes", device="cpu")
    assert t.format == "routed" == jauto.AutoSpMV.from_csr(jbig, format="lanes").format
    x = _x(9000)
    o = serial_csr_spmv(big, x)
    _close(t(x), o)
    # ell_t over the ELL entry cap: binned
    (_, tcsr, _), (_, jcsr, _) = _both("ragged")
    t = tauto.AutoSpMV.from_csr(tcsr, cfg=Config(ell_max_entries=100), format="ell_t", device="cpu")
    j = jauto.AutoSpMV.from_csr(jcsr, cfg=J.Config(ell_max_entries=100), format="ell_t")
    assert t.format == j.format == "binned"
    with pytest.raises(ValueError, match="unknown format"):
        tauto.AutoSpMV.from_csr(tcsr, format="ell", device="cpu")
